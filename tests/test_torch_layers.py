"""The port's modules against their JAX counterparts on the CPU, on the same
weights (JAX init -> numpy -> the port's weight bridge) and the same inputs
(numpy, seeded): layers, video preprocessing, the MoCo frontend, the Whisper
encoder and the gated fusion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models import layers as TL
from mocov2_whisper_flamingo_torch.models.convert import from_jax_params, load_jax_params
from mocov2_whisper_flamingo_torch.models.fusion import GatedCrossModalFusion as TFusion
from mocov2_whisper_flamingo_torch.models.visual_frontend import MoCoVisualFrontend as TFrontend
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperEncoder as TEncoder
from mocov2_whisper_flamingo_torch.ops import video as tvideo
from mocov2_whisper_flamingo_tpu.models import layers as JL
from mocov2_whisper_flamingo_tpu.models.fusion import GatedCrossModalFusion as JFusion
from mocov2_whisper_flamingo_tpu.models.visual_frontend import MoCoVisualFrontend as JFrontend
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from mocov2_whisper_flamingo_tpu.ops import video as jvideo

ATOL = 1e-5  # fp32 modules: same math, different summation order

TINY = dict(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=1, n_heads=4,
            d_ff=128, vocab_size=64, max_source_positions=64, max_target_positions=32)


def _np_tree(params):
    return jax.tree.map(lambda x: np.array(x, np.float32), params)


def _close(ours: torch.Tensor, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# -- layers -----------------------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False])
def test_linear(rng, bias):
    p = _np_tree(JL.linear_init(jax.random.PRNGKey(0), 24, 40, bias=bias))
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    lin = load_jax_params(TL.Linear(24, 40, bias), p)
    _close(lin(torch.from_numpy(x)), JL.linear(p, jnp.asarray(x)))


def test_linear_bf16_policy(rng):
    p = _np_tree(JL.linear_init(jax.random.PRNGKey(0), 24, 40))
    x = rng.standard_normal((3, 24)).astype(np.float32)
    lin = load_jax_params(TL.Linear(24, 40, precision=TL.BF16), p)
    y = lin(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16
    _close(y, JL.linear(p, jnp.asarray(x), JL.BF16).astype(jnp.float32), atol=3e-2)


def test_layer_norm_fp32_island(rng):
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    x = (rng.standard_normal((4, 48)) * 3 + 1).astype(np.float32)
    ln = load_jax_params(TL.LayerNorm(48), p)
    _close(ln(torch.from_numpy(x)), JL.layer_norm(p, jnp.asarray(x)))
    yb = ln(torch.from_numpy(x).bfloat16())
    assert yb.dtype == torch.bfloat16


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d(rng, stride):
    p = _np_tree(JL.conv1d_init(jax.random.PRNGKey(1), 80, 32, 3))
    x = rng.standard_normal((2, 30, 80)).astype(np.float32)
    conv = load_jax_params(TL.Conv1d(80, 32, 3, stride, 1), p)
    _close(conv(torch.from_numpy(x)),
           JL.conv1d(p, jnp.asarray(x), stride=stride, padding=1))


def test_gelu_embed_and_position_tables(rng):
    x = rng.standard_normal((5, 7)).astype(np.float32) * 3
    _close(TL.gelu(torch.from_numpy(x)), JL.gelu(jnp.asarray(x)))
    p = _np_tree(JL.embedding_init(jax.random.PRNGKey(2), 50, 16))
    ids = rng.integers(0, 50, (3, 4))
    emb = load_jax_params(TL.Embedding(50, 16), p)
    _close(emb(torch.from_numpy(ids)), JL.embed(p, jnp.asarray(ids)), atol=0)
    np.testing.assert_array_equal(TL.sinusoid_position_encoding(30, 64),
                                  JL.sinusoid_position_encoding(30, 64))
    np.testing.assert_array_equal(TL.interleaved_position_encoding(30, 64),
                                  JL.interleaved_position_encoding(30, 64))


@pytest.mark.parametrize("bias", [True, False])
def test_int8_leaves_load_bit_for_bit(rng, bias):
    """A quantized JAX linear through the bridge: int8 ``kernel_q`` and fp32
    ``scale`` land unchanged in a ``QuantLinear``, whose output is the JAX
    one."""
    p = JL.quantize_linear(JL.linear_init(jax.random.PRNGKey(0), 24, 40, bias=bias))
    tree = jax.tree.map(np.asarray, p)
    sd = from_jax_params(tree)
    assert sd["kernel_q"].dtype == np.int8 and sd["scale"].dtype == np.float32
    lin = load_jax_params(TL.QuantLinear(24, 40, bias), tree)
    np.testing.assert_array_equal(lin.kernel_q.numpy(), tree["kernel_q"])
    np.testing.assert_array_equal(lin.scale.numpy(), tree["scale"])
    x = rng.standard_normal((3, 24)).astype(np.float32)
    _close(lin(torch.from_numpy(x)), JL.linear(p, jnp.asarray(x)))


# -- video ------------------------------------------------------------------------


@pytest.mark.parametrize("size,crop", [(64, None), (100, None), (64, 80)])
def test_eval_video_pipeline(rng, size, crop):
    """88x88 uint8 frames: downsampling must antialias like jax.image.resize."""
    frames = rng.integers(0, 256, (2, 3, 3, 88, 88)).astype(np.uint8)
    ours = tvideo.eval_video_pipeline(torch.from_numpy(frames), resize=size, crop=crop)
    ref = jvideo.eval_video_pipeline(jnp.asarray(frames), resize=size, crop=crop)
    assert tuple(ours.shape) == ref.shape
    _close(ours, ref, atol=1e-4)


def test_resize_matches_jax_on_grey_levels(rng):
    frames = rng.integers(0, 256, (4, 3, 88, 88)).astype(np.float32)
    _close(tvideo.resize_bilinear(torch.from_numpy(frames), 64),
           jvideo.resize_bilinear(jnp.asarray(frames), 64), atol=1e-3)


# -- visual frontend ------------------------------------------------------------------


def _randomize_bn(tree, rng):
    """Non-trivial frozen BN statistics, so the fold is exercised."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            tree["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            tree["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            tree["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            tree["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        else:
            for val in tree.values():
                _randomize_bn(val, rng)
    elif isinstance(tree, list):
        for val in tree:
            _randomize_bn(val, rng)


@pytest.fixture(scope="module")
def frontend_pair():
    rng = np.random.default_rng(3)
    tree = _np_tree(JFrontend().init(jax.random.PRNGKey(3)))
    _randomize_bn(tree, rng)
    video = rng.standard_normal((2, 5, 3, 32, 32)).astype(np.float32)
    x_len = np.array([5, 3], np.int32)
    ref = np.asarray(JFrontend().apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(video),
                                       jnp.asarray(x_len)))
    port = load_jax_params(TFrontend(), tree)
    with torch.no_grad():
        ours = port(torch.from_numpy(video), torch.from_numpy(x_len))
    return ours, ref


def test_visual_frontend_matches_jax(frontend_pair):
    ours, ref = frontend_pair
    assert tuple(ours.shape) == (2, 5, 2048)
    scale = np.abs(ref).max()
    _close(ours, ref, atol=ATOL * max(scale, 1.0))


def test_visual_frontend_zeroes_padded_frames(frontend_pair):
    ours, _ = frontend_pair
    assert bool((ours[1, 3:] == 0).all()) and bool((ours[1, :3] != 0).any())


# -- Whisper encoder ------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_pair():
    rng = np.random.default_rng(4)
    jenc = JEncoder(JConfig(**TINY), backend="xla")
    tree = _np_tree(jenc.init(jax.random.PRNGKey(4)))
    mel = rng.standard_normal((2, 80, 64)).astype(np.float32)
    ref = np.asarray(jenc.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(mel)))
    port = load_jax_params(TEncoder(TConfig(**TINY)), tree)
    with torch.no_grad():
        ours = port(torch.from_numpy(mel))
    return ours, ref


def test_whisper_encoder_matches_jax(encoder_pair):
    ours, ref = encoder_pair
    assert tuple(ours.shape) == (2, 32, TINY["d_model"])
    _close(ours, ref)


# -- gated fusion --------------------------------------------------------------------


def test_gated_fusion_matches_jax_with_nonzero_gates(rng):
    d, heads, layers = 32, 4, 2
    tree = _np_tree(JFusion(d, heads, layers, dropout=0.0).init(jax.random.PRNGKey(5)))
    for i, layer in enumerate(tree["layers"]):
        layer["attn_gate"] = np.float32(0.5 + 0.2 * i)
        layer["ff_gate"] = np.float32(-0.4)
    audio = rng.standard_normal((3, 10, d)).astype(np.float32)
    video = rng.standard_normal((3, 10, d)).astype(np.float32)
    valid = np.arange(10)[None, :] < np.array([10, 7, 1])[:, None]
    ref = JFusion(d, heads, layers, dropout=0.0).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(audio), jnp.asarray(video),
        jnp.asarray(valid))
    port = load_jax_params(TFusion(d, heads, layers, dropout=0.0), tree)
    with torch.no_grad():
        ours = port(torch.from_numpy(audio), torch.from_numpy(video), torch.from_numpy(valid))
    _close(ours, ref)
    # The gates matter: with them at 0 the output changes.
    for layer in port.layers:
        layer.attn_gate.data.zero_()
    with torch.no_grad():
        gated_off = port(torch.from_numpy(audio), torch.from_numpy(video),
                         torch.from_numpy(valid))
    assert (gated_off - ours).abs().max().item() > 1e-3


# -- dropout -------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    y = TL.dropout(x, rate, gen, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.015  # 16384 draws: 3 sigma < 0.012
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), atol=1e-6, rtol=1e-6)
    assert y.dtype == x.dtype
    # inverted dropout keeps the expectation
    assert abs(y.mean().item() - x.mean().item()) < 0.05


def test_dropout_is_the_identity_when_deterministic_at_rate_0_or_without_a_generator(rng):
    x = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    start = gen.get_state()
    assert TL.dropout(x, 0.5, gen, deterministic=True) is x
    assert TL.dropout(x, 0.0, gen, deterministic=False) is x
    assert TL.dropout(x, 0.5, None, deterministic=False) is x
    assert torch.equal(gen.get_state(), start)  # nothing was drawn
    ref = JL.dropout(jnp.asarray(x.numpy()), 0.5, None, deterministic=False)
    np.testing.assert_array_equal(np.asarray(ref), x.numpy())


def test_dropout_draws_follow_the_generator_state(rng):
    x = torch.ones((16, 16))
    gen = torch.Generator().manual_seed(7)
    first = TL.dropout(x, 0.5, gen, deterministic=False)
    second = TL.dropout(x, 0.5, gen, deterministic=False)
    again = TL.dropout(x, 0.5, torch.Generator().manual_seed(7), deterministic=False)
    assert torch.equal(first, again) and not torch.equal(first, second)
    bf16 = TL.dropout(x.bfloat16(), 0.5, torch.Generator().manual_seed(7), deterministic=False)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16.float(), first)


def test_gated_fusion_train_mode_without_draws_matches_jax_and_returns_gates(rng):
    """``train=True`` with no generator (or at rate 0) is the eval function;
    ``return_gates`` gives tanh of each gate under the JAX names."""
    d, heads, layers = 32, 4, 2
    tree = _np_tree(JFusion(d, heads, layers, dropout=0.1).init(jax.random.PRNGKey(5)))
    for i, layer in enumerate(tree["layers"]):
        layer["attn_gate"] = np.float32(0.5 + 0.2 * i)
        layer["ff_gate"] = np.float32(-0.4)
    audio = rng.standard_normal((3, 10, d)).astype(np.float32)
    video = rng.standard_normal((3, 10, d)).astype(np.float32)
    valid = np.arange(10)[None, :] < np.array([10, 7, 1])[:, None]
    ref, ref_gates = JFusion(d, heads, layers, dropout=0.1).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(audio), jnp.asarray(video),
        jnp.asarray(valid), train=True, rng=None, return_gates=True)
    port = load_jax_params(TFusion(d, heads, layers, dropout=0.1), tree)
    args = (torch.from_numpy(audio), torch.from_numpy(video), torch.from_numpy(valid))
    with torch.no_grad():
        ours, gates = port(*args, train=True, generator=None, return_gates=True)
        eval_out = port(*args)
        dropped = port(*args, train=True, generator=torch.Generator().manual_seed(0))
    _close(ours, ref)
    assert torch.equal(ours, eval_out) and not torch.equal(dropped, eval_out)
    assert sorted(gates) == sorted(ref_gates) == ["attn_gate_0", "attn_gate_1", "ff_gate_0",
                                                  "ff_gate_1"]
    for name in gates:
        assert float(gates[name]) == pytest.approx(float(ref_gates[name]), abs=1e-6)
