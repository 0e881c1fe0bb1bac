"""The port's ``tools/export_model.py`` against the JAX package on the CPU, at
the tiny configuration of tests/test_tools.py: the ``torch.export`` forward
artifact (symbolic batch, symbolic video time) and the beam-decode artifact
against the JAX live forward and beam, in process and in a fresh
interpreter. Weights go to both packages through the bridge; fp32 logits
within 1e-4, beam tokens exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TAVWNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_avnet_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.tools import export_model as em
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JAVWNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder

VOCAB = 64
MODELARGS = (32, 4, 2, 3000, 128, 0.0)
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=1500, max_target_positions=32)
BEAM_TINY = dict(TINY, max_source_positions=64)
ATOL = 1e-4  # fp32 logits and beam scores
PREFIX, MAX_LEN, EOS, BEAM = [1, 2], 12, 13, 3  # EOS: a token the decoder emits mid-beam


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
def beam_setup():
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
    def beam(p, x):
        res = jnet.beam(p, x, PREFIX, beam_size=BEAM, max_len=MAX_LEN, eos_id=EOS)
        return res.sequences, res.scores

    seqs, scores = jax.jit(beam)(jax.tree.map(jnp.asarray, tree), jbatch)
    return tnet, tbatch, (np.array(seqs), np.array(scores))


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
    """The serving artifact (AV encode + beam search unrolled to max_len)
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


def test_both_artifacts_verify_in_a_fresh_process(forward_setup, beam_setup, artifacts):
    """Each artifact loads, runs and matches the JAX outputs in a fresh
    interpreter that never traced it (the forward at an unseen B=3)."""
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
