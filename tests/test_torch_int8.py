"""The port's int8 weights and KV caches against the JAX package's on the CPU,
on the same weights through the bridge and the same inputs (numpy, seeded):
the quantizers (bit for bit), the quantized linear and lookup, the prepared
int8 decoder's leaves, the decode step under every weight x cache mode, the
teacher-forced forward, and beam, greedy and sampled tokens at fp32
(tolerance 0 on tokens).

Tolerances: fp32 linears ``FP32_RTOL`` relative (same products, other
summation order); bf16 linears ``BF16_ATOL`` (the bf16 tolerance of
tests/test_torch_layers.py); step logits ``STEP_RTOL`` times the largest
|logit|; beam scores and logprobs ``SCORE_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode import sampling as TS
from mocov2_whisper_flamingo_torch.decode.beam import beam_search as tbeam
from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode as tgreedy
from mocov2_whisper_flamingo_torch.models import layers as TL
from mocov2_whisper_flamingo_torch.models.convert import from_jax_params, load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_torch.models.whisper import quantize_kv
from mocov2_whisper_flamingo_tpu.decode import sampling as JS
from mocov2_whisper_flamingo_tpu.decode.beam import beam_search as jbeam
from mocov2_whisper_flamingo_tpu.decode.greedy import greedy_decode as jgreedy
from mocov2_whisper_flamingo_tpu.models import layers as JL
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import _quantize_kv

from longform_helpers import JaxDraws, lively
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
EOS = 20  # a token the decoder below emits mid-sequence, so beams bank
PREFIX = [1, 2]
MAX_LEN = 12
FP32_RTOL = 1e-6
BF16_ATOL = 3e-2
STEP_RTOL = 1e-4
SCORE_ATOL = 1e-4
# (weight_quant, cache_quant): every int8 mode of the decode paths
MODES = [(None, "int8"), (None, "int8-cross"), ("int8", None), ("int8", "int8"),
         ("int8", "int8-cross")]
MODE_IDS = ["w-c8", "w-c8x", "w8-c", "w8-c8", "w8-c8x"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _tie_matrix(rng, rows, cols):
    """Random values plus, in its first columns, exact .5 quotients (max 127
    so that the scale is 1) and an all-zero column (the scale floor)."""
    w = rng.standard_normal((rows, cols)).astype(np.float32)
    w[:, 0] = 0.0
    w[:4, 1] = [127.0, 2.5, -3.5, 0.5]
    w[4:, 1] = rng.integers(-126, 127, rows - 4) + 0.5
    w[:4, 2] = [-127.0, 1.5, -0.5, 126.5]
    return w


@pytest.mark.parametrize("which", ["linear", "embedding", "kv"])
def test_quantizers_are_bit_equal_to_jax(which):
    rng = np.random.default_rng(0)
    w = _tie_matrix(rng, 16, 12)
    if which == "linear":
        q, s = TL.quantize_int8(torch.from_numpy(w), 0)
        ref = JL.quantize_linear({"kernel": jnp.asarray(w)})
        qr, sr = ref["kernel_q"], ref["scale"]
        assert float(s[0]) == np.float32(1e-12) and int(q[1, 1]) == 2 and int(q[2, 1]) == -4
    elif which == "embedding":
        w = np.ascontiguousarray(w.T)  # the ties and the zero run along rows
        q, s = TL.quantize_int8(torch.from_numpy(w), 1)
        ref = JL.quantize_embedding({"embedding": jnp.asarray(w)})
        qr, sr = ref["embedding_q"], ref["scale"]
        assert float(s[0]) == np.float32(1e-12)
    else:
        x = np.ascontiguousarray(w.T).reshape(3, 4, 16)  # [T, H, Dh]; row 0 all zero
        q, s = quantize_kv(torch.from_numpy(x))
        qr, sr = _quantize_kv(jnp.asarray(x))
        assert float(s[0, 0]) == np.float32(1e-8)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_quant_linear_matches_jax(bias, precision):
    rng = np.random.default_rng(1)
    p = {"kernel": rng.standard_normal((24, 40)).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    tprec, jprec = (TL.FP32, JL.FP32) if precision == "fp32" else (TL.BF16, JL.BF16)
    lin = TL.QuantLinear.from_linear(load_jax_params(TL.Linear(24, 40, bias, tprec), p))
    ref = JL.linear(JL.quantize_linear(jax.tree.map(jnp.asarray, p)), jnp.asarray(x), jprec)
    y = lin(torch.from_numpy(x))
    assert y.dtype == tprec.compute_dtype and lin.kernel_q.dtype == torch.int8
    if precision == "fp32":
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=FP32_RTOL,
                                   atol=FP32_RTOL * float(np.abs(ref).max()))
    else:
        np.testing.assert_allclose(y.float().numpy(), _np(ref), atol=BF16_ATOL, rtol=0)


def test_quant_embedding_lookup_matches_jax():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 4))
    emb = TL.QuantEmbedding.from_embedding(load_jax_params(TL.Embedding(50, 16),
                                                           {"embedding": table}))
    ref = JL.embed(JL.quantize_embedding({"embedding": jnp.asarray(table)}), jnp.asarray(ids))
    out = emb(torch.from_numpy(ids))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- the decoder -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jdec = JDecoder(JConfig(**CFG))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jdec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lively(tree, rng)
    for layer in tree["layers"]:
        layer["cross_attn"]["q"]["kernel"] *= np.float32(8.0)
        layer["cross_attn"]["v"]["kernel"] *= np.float32(16.0)
    params = jax.tree.map(jnp.asarray, tree)
    tdec = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"), tree)
    enc = rng.standard_normal((2, 16, 48)).astype(np.float32)
    prepared = {wq: (jdec.prepare_decode_params(params, wq), tdec.prepare_decode_params(wq))
                for wq in (None, "int8")}
    return jdec, params, tdec, enc, prepared


def _leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_prepared_int8_decoder_has_the_jax_leaves(setup, precision):
    """Which leaves are int8, which stay fp32 (the quantization scales and
    the LayerNorm scales) and which are cast, against the JAX package's
    ``prepare_decode_params("int8")``; and the prepared values bit for bit,
    also after installing the JAX tree through the bridge."""
    _, params, tdec, _, _ = setup
    tprec, jprec = (TL.FP32, JL.FP32) if precision == "fp32" else (TL.BF16, JL.BF16)
    jdec = JDecoder(JConfig(**CFG), jprec)
    ref = jdec.prepare_decode_params(params, "int8")
    port = load_jax_params(TDecoder(TConfig(**CFG), tprec, device="cpu"),
                           jax.tree.map(np.asarray, params)).prepare_decode_params("int8")
    want = {k: v for k, v in _leaves(ref).items()}
    ours = dict(port.named_parameters())
    assert set(ours) == set(want)
    int8 = {k for k, v in want.items() if v.dtype == jnp.int8}
    assert {k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1] for k in int8
            if "layers" in k} == {"qkv.kernel_q", "out.kernel_q", "q.kernel_q",
                                  "fc1.kernel_q", "fc2.kernel_q"}
    assert "embed_tokens.embedding_q" in int8
    for name, value in want.items():
        dtype = {"int8": torch.int8, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}[str(value.dtype)]
        assert ours[name].dtype == dtype, name
        np.testing.assert_array_equal(ours[name].float().numpy(), _np(value).astype(np.float32),
                                      err_msg=name)
    assert ours["layers.0.mlp_ln.scale"].dtype == torch.float32
    assert ours["layers.0.mlp_ln.bias"].dtype == tprec.compute_dtype
    assert port.vocab_table is None
    # the bridge: the JAX int8 tree loads bit for bit into the quantized module
    sd = from_jax_params(jax.tree.map(np.asarray, ref))
    assert sd["embed_tokens.embedding_q"].dtype == np.int8
    bridged = load_jax_params(TDecoder(TConfig(**CFG), tprec, device="cpu")
                              .prepare_decode_params("int8"), jax.tree.map(np.asarray, ref))
    for name, p in bridged.named_parameters():
        assert torch.equal(p, ours[name]), name
    with pytest.raises(ValueError, match="int8"):
        from_jax_params({"kernel_q": np.zeros((2, 2), np.float32), "scale": np.ones(2)})


def test_unknown_quant_strings_raise(setup):
    *_, tdec, enc, prepared = setup
    with pytest.raises(ValueError, match="weight_quant"):
        tdec.prepare_decode_params("int4")
    with pytest.raises(ValueError, match="cache quant"):
        prepared[None][1].init_cache(torch.from_numpy(enc), quant="int4")


@pytest.mark.parametrize("wq,cq,fold", [(None, "int8", False), (None, "int8", True),
                                        (None, "int8-cross", False), ("int8", None, False),
                                        ("int8", "int8", False), ("int8", "int8", True),
                                        ("int8", "int8-cross", False)])
def test_decode_steps_match_jax(setup, wq, cq, fold):
    """Five steps over two beam groups. ``fold``: the JAX step with an
    (identity) ancestry tensor, its folded-scale read of the int8 self
    cache, against the port's ``fold_scales=True``."""
    jdec, _, _, enc, prepared = setup
    jp, tdec = prepared[wq]
    rows, max_len = 4, 8
    jcache = jdec.init_cache(jp, jnp.asarray(enc), max_len=max_len, beam_groups=2, quant=cq)
    tcache = tdec.init_cache(torch.from_numpy(enc), max_len=max_len, beam_groups=2, quant=cq)
    anc = jnp.broadcast_to(jnp.eye(2)[None, :, :, None], (2, 2, 2, max_len)) if fold else None
    if cq == "int8":
        assert tcache["self_k"].dtype == torch.int8 and "self_v_scale" in tcache
    toks = np.random.default_rng(3).integers(0, CFG["vocab_size"], (5, rows, 1))
    for i in range(5):
        lj, jcache = jdec.decode_step(jp, jnp.asarray(toks[i], jnp.int32), jcache,
                                      jnp.int32(i), ancestry=anc)
        lt, tcache = tdec.decode_step(torch.from_numpy(toks[i]), tcache, i, fold_scales=fold)
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj, atol=STEP_RTOL * np.abs(lj).max(), rtol=0)
    # The cached K/V come from fp32 projections summed in another order: an
    # int8 value may sit one step away at a rounding boundary.
    pairs = [("cross_k", "cross", "k")] if cq else []
    pairs += [("self_v", "self", "v")] if cq == "int8" else []
    for name, part, leaf in pairs:
        ours, ref = tcache[name][1].numpy(), np.asarray(jcache[1][part][leaf])
        assert ours.dtype == np.int8 and np.abs(ours.astype(int) - ref).max() <= 1
        np.testing.assert_allclose(tcache[name + "_scale"][1].numpy(),
                                   np.asarray(jcache[1][part][leaf + "_scale"]), rtol=1e-5)


@pytest.mark.parametrize("cross_weights", [False, True])
def test_forward_on_the_int8_decoder_matches_jax_apply(setup, cross_weights):
    """Teacher forcing on the quantized decoder runs the quantized fused
    ``qkv``, as JAX ``apply`` on a quantized tree does."""
    jdec, _, _, enc, prepared = setup
    jp, tdec = prepared["int8"]
    toks = np.random.default_rng(4).integers(0, CFG["vocab_size"], (2, 7))
    valid = np.ones((2, 16), bool)
    valid[1, 11:] = False
    ref = jdec.apply(jp, jnp.asarray(toks), jnp.asarray(enc), jnp.asarray(valid),
                     return_cross_weights=cross_weights)
    out = tdec(torch.from_numpy(toks), torch.from_numpy(enc), torch.from_numpy(valid),
               return_cross_weights=cross_weights)
    if cross_weights:
        (out, w), (ref, wr) = out, ref
        np.testing.assert_allclose(w.numpy(), np.asarray(wr), atol=1e-5, rtol=0)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=STEP_RTOL * np.abs(ref).max(), rtol=0)
    unquantized = jdec.apply(jdec.prepare_decode_params(setup[1]), jnp.asarray(toks),
                             jnp.asarray(enc), jnp.asarray(valid))
    assert np.abs(np.asarray(unquantized) - ref).max() > 1e-4  # the int8 weights were used


# -- tokens ----------------------------------------------------------------------------


@pytest.mark.parametrize("wq,cq", MODES, ids=MODE_IDS)
def test_beam_tokens_match_jax(setup, wq, cq):
    jdec, _, _, enc, prepared = setup
    jp, tdec = prepared[wq]
    rj = jbeam(jdec, jp, jnp.asarray(enc), PREFIX, beam_size=3, max_len=MAX_LEN, eos_id=EOS,
               cache_quant=cq)
    rt = tbeam(tdec, torch.from_numpy(enc), PREFIX, beam_size=3, max_len=MAX_LEN, eos_id=EOS,
               cache_quant=cq)
    np.testing.assert_array_equal(rt.sequences.numpy(), np.asarray(rj.sequences))
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=SCORE_ATOL,
                               rtol=0)
    assert bool((rt.sequences[:, :, len(PREFIX):-1] == EOS).any())  # hypotheses banked


@pytest.mark.parametrize("wq,cq", MODES, ids=MODE_IDS)
def test_greedy_tokens_match_jax(setup, wq, cq):
    jdec, _, _, enc, prepared = setup
    jp, tdec = prepared[wq]
    want = jax.jit(lambda p, e: jgreedy(jdec, p, e, PREFIX, MAX_LEN, EOS, cache_quant=cq))(
        jp, jnp.asarray(enc))
    got = tgreedy(tdec, torch.from_numpy(enc), PREFIX, MAX_LEN, EOS, cache_quant=cq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy()[:, len(PREFIX):])) > 2


@pytest.mark.parametrize("wq,cq", [("int8", "int8"), ("int8", "int8-cross"), (None, "int8")],
                         ids=["w8-c8", "w8-c8x", "w-c8"])
def test_sample_decode_matches_jax_with_jax_draws(setup, wq, cq):
    """``num_samples`` rows ride ``init_cache(beam_groups=n)`` over an int8
    cache."""
    jdec, _, _, enc, prepared = setup
    jp, tdec = prepared[wq]
    key = jax.random.PRNGKey(5)
    kw = dict(temperature=0.7, num_samples=3, max_len=MAX_LEN, eos_id=EOS, cache_quant=cq)
    want = JS.sample_decode(jdec, jp, jnp.asarray(enc), PREFIX, key=key, **kw)
    got = TS.sample_decode(tdec, torch.from_numpy(enc), PREFIX, draws=JaxDraws(key), **kw)
    seqs = got.sequences.numpy()
    np.testing.assert_array_equal(seqs, np.asarray(want.sequences))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(want.sum_logprob),
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(want.avg_logprob),
                               atol=SCORE_ATOL, rtol=0)
    assert len({tuple(row) for row in seqs.reshape(-1, MAX_LEN)}) > 1


def test_int8_caches_halve_the_cache_bytes(setup):
    *_, enc, prepared = setup
    tdec = prepared[None][1]
    e = torch.from_numpy(enc)

    def nbytes(cache, prefix):
        return sum(v.numel() * v.element_size() for k, v in cache.items() if k.startswith(prefix))

    full = tdec.init_cache(e, max_len=16, beam_groups=4)
    q8 = tdec.init_cache(e, max_len=16, beam_groups=4, quant="int8")
    cross = tdec.init_cache(e, max_len=16, beam_groups=4, quant="int8-cross")
    dh = CFG["d_model"] // CFG["n_heads"]
    for name in ("self", "cross"):  # fp32 here: a quarter, plus a 4-byte scale per Dh values
        assert nbytes(q8, name) * 4 == nbytes(full, name) * (1 + 4 / dh)
    assert nbytes(cross, "self") == nbytes(full, "self")
    assert nbytes(cross, "cross") == nbytes(q8, "cross")
