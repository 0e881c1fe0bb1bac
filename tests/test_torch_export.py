"""The port's ``tools/export_model.py`` against the JAX package on the CPU, at
the tiny configuration of tests/test_tools.py: the ``torch.export`` forward
artifact (symbolic batch, symbolic video time) and the beam-decode artifact
against the JAX live forward and beam, in process and in a fresh
interpreter. Weights go to both packages through the bridge; fp32 logits
within 1e-4, beam tokens exact. The beam artifact is two ``while_loop``
nodes, the prefix's and the search's, as the JAX artifact is two scans (one
for a one-token prefix), so it is exported at two lengths and its size does
not grow; the loops' device form is held against the eager search's int
form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode.beam import BeamLoop, beam_search
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR as TASR
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TAVWNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_asr_params, random_avnet_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.tools import export_model as em
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JAVWNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from torch_threads import THREADS, capped_torch_threads  # noqa: F401  (autouse)

VOCAB = 64
MODELARGS = (32, 4, 2, 3000, 128, 0.0)
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=1500, max_target_positions=32)
BEAM_TINY = dict(TINY, max_source_positions=64)
ATOL = 1e-4  # fp32 logits and beam scores
ULPS = 4 * 2.0 ** -23  # the device form against the int form: 4 fp32 ulps
PREFIX, MAX_LEN, EOS, BEAM = [1, 2], 12, 13, 3  # EOS: a token the decoder emits mid-beam
# The beam artifact's second length (twice the steps, the same graph) and an EOS with which
# its hypotheses run past MAX_LEN: one banks mid-way, two are force-banked at the last step.
LONG_LEN, LONG_EOS = 24, 40


def _gates(trunk_tree) -> None:
    """Non-zero fusion gates, so that the fusion attention reaches the logits."""
    for layer in trunk_tree["fusion"]["layers"]:
        layer["attn_gate"] = np.float32(0.5)
        layer["ff_gate"] = np.float32(-0.3)


def _batch(seed: int, b: int, t_video: int, mel=(3000, 80), hw=64, lens=None):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((b, *mel)).astype(np.float32)
    video = rng.standard_normal((b, t_video, 3, hw, hw)).astype(np.float32)
    lens = np.full((b,), t_video, np.int32) if lens is None else np.asarray(lens, np.int32)
    t_audio = mel[0] if mel[1] == 80 else mel[1]
    arrays = (audio, np.ones((b, t_audio), bool), video, np.ones((b, t_video), bool), lens)
    return tuple(jnp.asarray(x) for x in arrays), tuple(torch.from_numpy(x) for x in arrays)


@pytest.fixture(scope="module")
def forward_setup():
    tnet = TNet("audiovisual", None, 96, MODELARGS, VOCAB, device="cpu",
                whisper_config=TConfig(**TINY))
    tree = random_avnet_params(tnet, 3)
    _gates(tree)
    load_jax_params(tnet, tree)
    jnet = JNet("audiovisual", None, 96, MODELARGS, VOCAB, backend="xla")
    cfg = JConfig(**TINY)
    jnet.whisper_config = cfg
    jnet.whisper_encoder = JEncoder(cfg, jnet.precision, "xla")
    params = jax.tree.map(jnp.asarray, tree)
    jforward = jax.jit(jnet.forward)
    return tnet, lambda jbatch: np.array(jforward(params, jbatch))


@pytest.fixture(scope="module")
def beam_nets():
    """The torch net, its batch and ``jax_beam(max_len, eos_id, prefix)``:
    the jitted JAX beam's (sequences, scores) on the same weights and
    batch."""
    tnet = TAVWNet(modelargs=MODELARGS, vocab_size=VOCAB, device="cpu",
                   whisper_config=TConfig(**BEAM_TINY))
    tree = random_jax_params(tnet, 5)
    _gates(tree["trunk"])
    # Position embeddings larger than the token embeddings keep the random
    # decoder from copying its input token: it emits varied tokens and EOS.
    rng = np.random.default_rng(11)
    dec = tree["decoder"]
    dec["pos_embed"] = 4.0 * rng.standard_normal(dec["pos_embed"].shape).astype(np.float32)
    dec["embed_tokens"]["embedding"] *= np.float32(0.5)
    load_jax_params(tnet, tree)
    jnet = JAVWNet(modelargs=MODELARGS, vocab_size=VOCAB, whisper_name="whisper-tiny",
                   backend="xla")
    cfg = JConfig(**BEAM_TINY)
    jnet.whisper_config = cfg
    jnet.trunk.whisper_config = cfg
    jnet.trunk.whisper_encoder = JEncoder(cfg, jnet.trunk.precision, "xla")
    jnet.decoder = JDecoder(cfg, jnet.precision, "xla")
    jbatch, tbatch = _batch(21, 2, 6, mel=(80, 128), hw=32, lens=[6, 4])
    params = jax.tree.map(jnp.asarray, tree)

    def jax_beam(max_len: int, eos_id: int = EOS, prefix=tuple(PREFIX)):
        def beam(p, x):
            res = jnet.beam(p, x, list(prefix), beam_size=BEAM, max_len=max_len, eos_id=eos_id)
            return res.sequences, res.scores

        seqs, scores = jax.jit(beam)(params, jbatch)
        return np.array(seqs), np.array(scores)

    return tnet, tbatch, jax_beam


@pytest.fixture(scope="module")
def beam_setup(beam_nets):
    tnet, tbatch, jax_beam = beam_nets
    return tnet, tbatch, jax_beam(MAX_LEN)


@pytest.fixture(scope="module")
def artifacts(forward_setup, beam_setup, tmp_path_factory):
    """The forward artifact exported at B=2 and the beam artifact."""
    tnet, _ = forward_setup
    bnet, bbatch, _ = beam_setup
    out = tmp_path_factory.mktemp("export")
    paths = {"forward": str(out / "model.pt2"), "beam": str(out / "beam.pt2")}
    sizes = {"forward": len(em.export_forward(tnet, _batch(1, 2, 8)[1], paths["forward"])),
             "beam": len(em.export_beam(bnet, bbatch, PREFIX, paths["beam"], beam_size=BEAM,
                                        max_len=MAX_LEN, eos_id=EOS))}
    return paths, sizes


def test_forward_artifact_matches_jax_at_an_unseen_batch_size(forward_setup, artifacts):
    """Exported from a B=2 example with a symbolic batch axis; at B=3 it
    matches the JAX live forward. The export leaves the net's attention
    backends as they were."""
    tnet, jax_forward = forward_setup
    paths, sizes = artifacts
    assert sizes["forward"] > 1000
    assert {m.backend for m in tnet.modules() if hasattr(m, "backend")} == {"flash"}
    jbatch, tbatch = _batch(2, 3, 8)
    ref = jax_forward(jbatch)
    assert ref.shape == (3, 8, VOCAB)
    assert em.verify_export(paths["forward"], tbatch, reference_out=torch.from_numpy(ref),
                            atol=ATOL)
    # the check holds the artifact to the reference: one logit off fails it
    off = ref.copy()
    off[0, 0, 0] += 1e-2
    assert not em.verify_export(paths["forward"], tbatch, reference_out=torch.from_numpy(off),
                                atol=ATOL)


def test_forward_artifact_holds_no_span_or_profiler_op(artifacts):
    """The trunk's spans (``utils/profiling.py::span``) are nothing while
    ``torch.export`` traces: the artifact holds aten ops alone."""
    exported = torch.export.load(artifacts[0]["forward"])
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


@pytest.fixture(scope="module")
def time_program(forward_setup, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export_time") / "m.pt2")
    em.export_forward(forward_setup[0], _batch(1, 2, 8)[1], path, symbolic_batch=True,
                      symbolic_time=True)
    return torch.export.load(path).module()


@pytest.mark.parametrize("b, t_video", [(3, 12), (1, 7)])
def test_symbolic_time_artifact_matches_jax(forward_setup, time_program, b, t_video):
    """Batch and video time both symbolic (``Dim("tv", max=1500)``): one
    artifact serves unseen batch sizes (B=1 included) and unseen, odd video
    lengths."""
    _, jax_forward = forward_setup
    jbatch, tbatch = _batch(4, b, t_video)
    with torch.no_grad():
        got = time_program(tbatch).numpy()
    ref = jax_forward(jbatch)
    assert got.shape == ref.shape == (b, t_video, VOCAB)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_symbolic_time_needs_symbolic_batch(forward_setup, tmp_path):
    tnet, _ = forward_setup
    with pytest.raises(ValueError, match="symbolic_batch"):
        em.export_forward(tnet, _batch(1, 2, 8)[1], str(tmp_path / "m.pt2"),
                          symbolic_batch=False, symbolic_time=True)


def test_beam_artifact_tokens_equal_the_jax_beam(beam_setup, artifacts):
    """The serving artifact (AV encode + beam search as two while_loops)
    gives the JAX beam's token ids exactly, and its scores within 1e-4. It
    holds the decoder prepared once (fused QKV), not the unprepared one."""
    _, tbatch, (seqs, scores) = beam_setup
    paths, sizes = artifacts
    assert sizes["beam"] > 1000
    exported = torch.export.load(paths["beam"])
    names = set(exported.state_dict)
    assert "decoder.layers.0.self_attn.qkv.kernel" in names
    assert not any(n.startswith("net.") for n in names)
    with torch.no_grad():
        got_seqs, got_scores = exported.module()(tbatch)
    assert (seqs == EOS).any() and len(np.unique(seqs)) > 3  # the search banks and varies
    np.testing.assert_array_equal(got_seqs.numpy(), seqs)
    np.testing.assert_allclose(got_scores.numpy(), scores, atol=ATOL, rtol=0)


def test_both_artifacts_verify_in_a_fresh_process(forward_setup, beam_setup, artifacts,
                                                  monkeypatch):
    """Each artifact loads, runs and matches the JAX outputs in a fresh
    interpreter that never traced it (the forward at an unseen B=3). The
    child runs its torch ops on this module's threads (``torch_threads.py``),
    through its environment."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))
    _, jax_forward = forward_setup
    _, bbatch, (seqs, scores) = beam_setup
    paths, _ = artifacts
    jbatch, tbatch = _batch(2, 3, 8)
    assert em.verify_export_fresh_process(
        paths["forward"], tbatch, reference_out=torch.from_numpy(jax_forward(jbatch)),
        atol=ATOL)
    # token ids below 64 pass np.allclose's atol 1e-4 + rtol 1e-5 only when equal
    assert em.verify_export_fresh_process(
        paths["beam"], bbatch,
        reference_out=(torch.from_numpy(seqs), torch.from_numpy(scores)), atol=ATOL)


def _loop_nodes(exported) -> list:
    return [n for n in exported.graph.nodes
            if n.op == "call_function" and n.target is torch.ops.higher_order.while_loop]


def test_beam_artifact_is_one_loop_at_any_length(beam_nets, artifacts, tmp_path):
    """At twice the steps the artifact is the same graph: the search is one
    ``while_loop`` at any length and the prefix one more, so two loop nodes
    at both lengths (as the JAX artifact holds two scans), its size within
    5 % of the shorter one's, and its tokens still the JAX beam's (scores
    within 1e-4), with hypotheses that run to the longer length."""
    tnet, tbatch, jax_beam = beam_nets
    paths, sizes = artifacts
    path = str(tmp_path / "beam_long.pt2")
    size = len(em.export_beam(tnet, tbatch, PREFIX, path, beam_size=BEAM, max_len=LONG_LEN,
                              eos_id=LONG_EOS))
    assert abs(size - sizes["beam"]) <= 0.05 * sizes["beam"], (size, sizes["beam"])
    assert len(_loop_nodes(torch.export.load(paths["beam"]))) == 2
    exported = torch.export.load(path)
    assert len(_loop_nodes(exported)) == 2
    seqs, scores = jax_beam(LONG_LEN, LONG_EOS)
    with torch.no_grad():
        got_seqs, got_scores = exported.module()(tbatch)
    assert got_seqs.shape == (2, BEAM, LONG_LEN)
    lengths = (seqs != LONG_EOS).sum(-1)
    assert lengths.max() == LONG_LEN and lengths.min() < MAX_LEN  # force-banked and banked
    np.testing.assert_array_equal(got_seqs.numpy(), seqs)
    np.testing.assert_allclose(got_scores.numpy(), scores, atol=ATOL, rtol=0)


def test_beam_step_device_form_equals_int_form(beam_nets):
    """``BeamLoop.step`` with a 0-d tensor index (the exported body) against
    the int index of the eager search, step for step from the eager
    search's states: tokens, pool, the early-stop flags and the self caches
    bit for bit, and no carried tensor written. The scores agree within a
    few fp32 ulps, not bit for bit: the device form's softmax sums over the
    whole window (masked keys weigh exactly 0), the int form's over ``0 ..
    i``, and the CPU's vectorised sum groups the two differently."""
    tnet, tbatch, _ = beam_nets
    decoder = tnet.decoder.prepare_decode_params()
    decoder.vocab_table = None  # the fp32 table is the embedding: a loop refuses aliases
    with torch.no_grad():
        features, valid = tnet.trunk.fused_features(tbatch)
        enc = tnet.bridge(features)
    kw = dict(beam_size=BEAM, max_len=LONG_LEN, eos_id=LONG_EOS, encoder_valid=valid)
    ints = BeamLoop(decoder, enc, PREFIX, **kw)
    with torch.no_grad():  # its prefix loop, as the export traces it
        device = BeamLoop(decoder, enc, PREFIX, device_steps=True, **kw)
    state = ints.state
    for a, b in zip(state, device.state):  # after the prefix, a while_loop in the device form
        assert torch.equal(a, b)
    names = ("run_tokens", "run_scores", "pool_tokens", "pool_scores", "heur_ok",
             "self_k", "self_v")
    for i in range(len(PREFIX) - 1, LONG_LEN - 1):
        before = [x.clone() for x in state]
        got = device.step(state, torch.tensor(i))
        for x, y in zip(state, before):
            assert torch.equal(x, y)  # the device form writes nothing it carries
        want = ints.step(state, i)
        for name, x, y in zip(names, got, want):
            if name.endswith("scores"):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=ULPS, atol=0,
                                           err_msg=f"{name} at step {i}")
            else:
                assert torch.equal(x, y), f"{name} at step {i}"
        state = want
    res = beam_search(decoder, enc, PREFIX, encoder_valid=valid, beam_size=BEAM,
                      max_len=LONG_LEN, eos_id=LONG_EOS)
    assert torch.equal(state[2], res.sequences) and torch.equal(state[3], res.scores)
    with pytest.raises(ValueError, match="device steps"):
        BeamLoop(decoder, enc, PREFIX, cache_quant="int8", device_steps=True, **kw)
    with pytest.raises(TypeError, match="int"):
        ints.step(state, torch.tensor(1))
    with pytest.raises(TypeError, match="device steps"):  # its prefix is already forced
        ints.prefix_step(state[5:], torch.tensor(0))
    cache = decoder.init_cache(enc, max_len=LONG_LEN, beam_groups=BEAM)
    with pytest.raises(ValueError, match="positions"):  # the out-of-place write needs them
        decoder.decode_step(torch.zeros((2 * BEAM, 1), dtype=torch.long), cache, 0,
                            in_place=False)


def test_beam_artifact_of_a_one_token_prefix_is_one_loop(beam_nets, tmp_path):
    """A one-token prefix has nothing to teacher-force, and the JAX beam
    runs no prefix scan then: the artifact holds one ``while_loop`` node,
    the search's, and its tokens equal the JAX beam's with that prefix
    (scores within 1e-4)."""
    tnet, tbatch, jax_beam = beam_nets
    path = str(tmp_path / "beam_one_token.pt2")
    em.export_beam(tnet, tbatch, PREFIX[:1], path, beam_size=BEAM, max_len=MAX_LEN,
                   eos_id=EOS)
    exported = torch.export.load(path)
    assert len(_loop_nodes(exported)) == 1
    seqs, scores = jax_beam(MAX_LEN, EOS, PREFIX[:1])
    with torch.no_grad():
        got_seqs, got_scores = exported.module()(tbatch)
    assert (seqs[..., 0] == PREFIX[0]).all() and len(np.unique(seqs[..., 1:])) > 3
    np.testing.assert_array_equal(got_seqs.numpy(), seqs)
    np.testing.assert_allclose(got_scores.numpy(), scores, atol=ATOL, rtol=0)


def test_device_prefix_loop_equals_the_int_prefix():
    """The device form's prefix ``while_loop`` (what ``BeamLoop``'s
    constructor runs there, the artifact's first loop, run eagerly) against
    the int form's Python prefix and against the JAX beam's prefix
    ``lax.scan`` on the same weights: four prefix tokens (three iterations)
    through a 2-layer fp32 decoder, so that the second layer's K/V come
    through the attention over the masked window. Against the int form the
    self caches agree within 4 fp32 ulps (``ULPS``, the scores' tolerance of
    ``test_beam_step_device_form_equals_int_form``) of each cache's largest
    entry: the device form's softmax sums the whole window, the int form's
    ``0 .. i``, and a small entry carries the absolute rounding of the
    layer before it. Against JAX they agree within ``ATOL``, the file's fp32
    tolerance. The slots past the prefix stay empty."""
    cfg = dict(BEAM_TINY, decoder_layers=2)
    asr = TASR(config=TConfig(**cfg), device="cpu")
    tree = random_asr_params(asr, 7)
    rng = np.random.default_rng(3)
    tree["decoder"]["pos_embed"] = 4.0 * rng.standard_normal(
        tree["decoder"]["pos_embed"].shape).astype(np.float32)
    load_jax_params(asr, tree)
    decoder = asr.decoder.prepare_decode_params()
    decoder.vocab_table = None  # the fp32 table is the embedding: a loop refuses aliases
    enc = rng.standard_normal((2, 20, cfg["d_model"])).astype(np.float32)
    valid = np.arange(20)[None] < np.array([[20], [13]])
    prefix = [1, 5, 9, 2]
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS, encoder_valid=torch.from_numpy(valid))
    with torch.no_grad():
        want = BeamLoop(decoder, torch.from_numpy(enc), prefix, **kw).state[5:]
        got = BeamLoop(decoder, torch.from_numpy(enc), prefix, device_steps=True,
                       **kw).state[5:]

    jdec = JDecoder(JConfig(**cfg))
    jp = jdec.prepare_decode_params(jax.tree.map(jnp.asarray, tree["decoder"]))

    @jax.jit
    def jax_prefix(jp, enc, valid):
        def step(cache, i):
            cur = jnp.broadcast_to(jnp.asarray(prefix, jnp.int32)[i], (2 * BEAM, 1))
            return jdec.decode_step(jp, cur, cache, i, encoder_valid=valid)[1], None

        cache = jdec.init_cache(jp, enc, max_len=MAX_LEN, beam_groups=BEAM)
        cache, _ = jax.lax.scan(step, cache, jnp.arange(len(prefix) - 1))
        return [jnp.stack([c["self"][n] for c in cache]) for n in ("k", "v")]

    from_jax = jax_prefix(jp, jnp.asarray(enc), jnp.asarray(valid))
    for name, x, y, j in zip(("self_k", "self_v"), got, want, from_jax):
        assert x.shape == y.shape == j.shape == (cfg["decoder_layers"], 2 * BEAM, MAX_LEN,
                                                 cfg["n_heads"], cfg["d_model"] // cfg["n_heads"])
        assert torch.count_nonzero(x[:, :, len(prefix) - 1:]) == 0, name
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=ULPS * y.abs().max().item(), err_msg=name)
        np.testing.assert_allclose(x.numpy(), np.asarray(j), rtol=0, atol=ATOL, err_msg=name)
