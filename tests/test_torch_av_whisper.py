"""The port's AVWhisperNet against the JAX package on the CPU at the tiny
configuration of tests/test_av_whisper.py: encode features, CTC logits, one
decode step, and greedy and beam tokens, token for token (JAX on its XLA
attention backend). Both models get the same weights through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder

VOCAB = 64
EOS = 20  # a token the random decoder below emits mid-sequence
PREFIX = [1, 2]
MODELARGS = (32, 4, 2, 3000, 128, 0.0)
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=64, max_target_positions=32)
MODULE_ATOL = 1e-5  # fp32 encode features
SLICE_ATOL = 1e-4   # fp32 logits and beam scores after the whole slice


def _jax_net():
    net = JNet(modelargs=MODELARGS, vocab_size=VOCAB, whisper_name="whisper-tiny", backend="xla")
    cfg = JConfig(**TINY)
    net.whisper_config = cfg
    net.trunk.whisper_config = cfg
    net.trunk.whisper_encoder = JEncoder(cfg, net.trunk.precision, "xla")
    net.decoder = JDecoder(cfg, net.precision, "xla")
    return net


@pytest.fixture(scope="module")
def pair():
    jnet = _jax_net()
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jnet.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for i, layer in enumerate(tree["trunk"]["fusion"]["layers"]):
        layer["attn_gate"] = np.float32(0.5)
        layer["ff_gate"] = np.float32(-0.3)
    # Position embeddings larger than the token embeddings keep the random
    # decoder from copying its input token: it emits varied tokens and EOS,
    # so banking is exercised.
    dec = tree["decoder"]
    dec["pos_embed"] = 4.0 * rng.standard_normal(dec["pos_embed"].shape).astype(np.float32)
    dec["embed_tokens"]["embedding"] *= np.float32(0.5)
    params = jax.tree.map(jnp.asarray, tree)
    tnet = TNet(modelargs=MODELARGS, vocab_size=VOCAB, device="cpu",
                whisper_config=TConfig(**TINY))
    load_jax_params(tnet, tree)

    b, tv = 3, 6
    audio = rng.standard_normal((b, 80, 128)).astype(np.float32)
    video = rng.standard_normal((b, tv, 3, 32, 32)).astype(np.float32)
    lens = np.array([6, 4, 1], np.int32)
    jbatch = (jnp.asarray(audio), jnp.ones((b, 128), bool), jnp.asarray(video),
              jnp.ones((b, tv), bool), jnp.asarray(lens))
    tbatch = (torch.from_numpy(audio), torch.ones((b, 128), dtype=torch.bool),
              torch.from_numpy(video), torch.ones((b, tv), dtype=torch.bool),
              torch.from_numpy(lens))
    return jnet, params, jbatch, tnet, tree, tbatch


def test_encode_matches_jax(pair):
    jnet, params, jbatch, tnet, _, tbatch = pair
    fj, vj = jnet.encode(params, jbatch)
    ft, vt = tnet.encode(tbatch)
    assert tuple(ft.shape) == (3, 6, TINY["d_model"])
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=MODULE_ATOL, rtol=0)


def test_ctc_logits_match_jax(pair):
    jnet, params, jbatch, tnet, _, tbatch = pair
    np.testing.assert_allclose(tnet.ctc_logits(tbatch).numpy(),
                               np.asarray(jnet.ctc_logits(params, jbatch)),
                               atol=SLICE_ATOL, rtol=0)


def test_decode_steps_match_jax(pair):
    """Four steps of the cached decoder, beam-grouped (B*2 rows over a
    B-major cross cache), against the JAX decode_step."""
    jnet, params, jbatch, tnet, _, tbatch = pair
    fj, vj = jnet.encode(params, jbatch)
    ft, vt = tnet.encode(tbatch)
    jp = jnet._decode_params(params)
    jcache = jnet.decoder.init_cache(jp, fj, max_len=8, beam_groups=2)
    tdec = tnet.decoder.prepare_decode_params()
    tcache = tdec.init_cache(ft, max_len=8, beam_groups=2)
    toks = np.random.default_rng(1).integers(0, VOCAB, (4, 6, 1))
    for i in range(4):
        lj, jcache = jnet.decoder.decode_step(jp, jnp.asarray(toks[i], jnp.int32), jcache,
                                              jnp.int32(i), encoder_valid=vj)
        lt, tcache = tdec.decode_step(torch.from_numpy(toks[i]), tcache, i, encoder_valid=vt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SLICE_ATOL, rtol=0)


def test_greedy_tokens_match_jax(pair):
    jnet, params, jbatch, tnet, _, tbatch = pair
    gj = np.asarray(jnet.greedy(params, jbatch, PREFIX, max_len=12, eos_id=EOS))
    gt = tnet.greedy(tbatch, PREFIX, max_len=12, eos_id=EOS).numpy()
    np.testing.assert_array_equal(gt, gj)
    assert len(np.unique(gt[:, len(PREFIX):])) > 2  # the decode is not degenerate


@pytest.mark.parametrize("length_penalty,early_stopping", [(1.0, False), (0.0, False),
                                                           (1.0, True)])
def test_beam_tokens_match_jax(pair, length_penalty, early_stopping):
    from mocov2_whisper_flamingo_torch.decode.beam import beam_search as tbeam
    from mocov2_whisper_flamingo_tpu.decode.beam import beam_search as jbeam

    jnet, params, jbatch, tnet, _, tbatch = pair
    fj, vj = jnet.encode(params, jbatch)
    ft, vt = tnet.encode(tbatch)
    rj = jbeam(jnet.decoder, jnet._decode_params(params), fj, PREFIX, beam_size=3,
               max_len=12, eos_id=EOS, length_penalty=length_penalty, encoder_valid=vj,
               early_stopping=early_stopping)
    rt = tbeam(tnet.decoder.prepare_decode_params(), ft, PREFIX, beam_size=3, max_len=12,
               eos_id=EOS, length_penalty=length_penalty, encoder_valid=vt,
               early_stopping=early_stopping)
    np.testing.assert_array_equal(rt.sequences.numpy(), np.asarray(rj.sequences))
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=SLICE_ATOL, rtol=0)


def test_beam_entry_point_banks_eos_and_matches_jax(pair):
    jnet, params, jbatch, tnet, _, tbatch = pair
    rj = jnet.beam(params, jbatch, PREFIX, beam_size=3, max_len=12, eos_id=EOS)
    rt = tnet.beam(tbatch, PREFIX, beam_size=3, max_len=12, eos_id=EOS,
                   read_windows=(4, 12), cache_layout="bhjtd")  # accepted no-ops
    np.testing.assert_array_equal(rt.sequences.numpy(), np.asarray(rj.sequences))
    assert bool((rt.sequences[:, :, len(PREFIX):-1] == EOS).any())  # a hypothesis banked early


def test_beam_width_one_is_greedy(pair):
    *_, tnet, _, tbatch = pair
    greedy = tnet.greedy(tbatch, PREFIX, max_len=12, eos_id=EOS)
    res = tnet.beam(tbatch, PREFIX, beam_size=1, max_len=12, eos_id=EOS)
    np.testing.assert_array_equal(res.sequences[:, 0].numpy(), greedy.numpy())


INT8 = [dict(cache_quant="int8-cross"), dict(weight_quant="int8", cache_quant="int8")]
INT8_IDS = ["c8x", "w8-c8"]


@pytest.mark.parametrize("kwargs", INT8, ids=INT8_IDS)
def test_int8_beam_matches_jax(pair, kwargs):
    jnet, params, jbatch, tnet, _, tbatch = pair
    rj = jnet.beam(params, jbatch, PREFIX, beam_size=3, max_len=12, eos_id=EOS, **kwargs)
    rt = tnet.beam(tbatch, PREFIX, beam_size=3, max_len=12, eos_id=EOS, **kwargs)
    np.testing.assert_array_equal(rt.sequences.numpy(), np.asarray(rj.sequences))
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=SLICE_ATOL, rtol=0)


@pytest.mark.parametrize("kwargs", INT8, ids=INT8_IDS)
def test_int8_greedy_matches_jax(pair, kwargs):
    """The JAX ``AVWhisperNet.greedy`` takes no ``cache_quant``: its
    ``greedy_decode`` on the same features is the reference."""
    from mocov2_whisper_flamingo_tpu.decode.greedy import greedy_decode as jgreedy

    jnet, params, jbatch, tnet, _, tbatch = pair
    fj, vj = jnet.encode(params, jbatch)
    want = jgreedy(jnet.decoder, jnet._decode_params(params, kwargs.get("weight_quant")), fj,
                   PREFIX, 12, EOS, encoder_valid=vj, cache_quant=kwargs.get("cache_quant"))
    got = tnet.greedy(tbatch, PREFIX, max_len=12, eos_id=EOS, **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length_penalty", [0.0, 0.6, 1.0, 1.3, 2.0])
def test_length_denominators_are_the_per_step_powers(length_penalty):
    """The table made before the loop holds, bit for bit, what each step
    used to compute from a host scalar."""
    from mocov2_whisper_flamingo_torch.decode.beam import _length_denominators

    table = _length_denominators(160, length_penalty, "cpu")
    lp = torch.tensor(float(length_penalty), dtype=torch.float32)
    for gen_len, denom in enumerate(table):
        assert denom.ndim == 0 and denom.dtype == torch.float32
        assert torch.equal(denom, torch.tensor(float(gen_len)) ** lp)


def test_beam_loop_makes_no_tensor_from_a_host_scalar(pair, monkeypatch):
    """``torch.tensor`` calls do not grow with the number of steps: on the
    card each one is a pageable host-to-device copy."""
    *_, tnet, _, tbatch = pair
    calls = []
    real = torch.tensor

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", counting)
    counts = []
    for max_len in (6, 12):
        calls.clear()
        tnet.beam(tbatch, PREFIX, beam_size=3, max_len=max_len, eos_id=EOS,
                  length_penalty=0.6)
        counts.append(len(calls))
    assert counts[0] == counts[1]


def test_random_params_have_the_jax_tree_layout(pair):
    jnet, params, *_ = pair
    tnet = pair[3]
    ours = random_jax_params(tnet, seed=0)
    assert jax.tree.structure(ours) == jax.tree.structure(pair[4])
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == np.float32
