"""The port's flash attention (K1) against the JAX Pallas kernel and the XLA
attention, on the CPU.

On CPU tensors the port's wrapper runs its plain version; the Pallas kernel
runs in interpret mode with 8x8 blocks, as tests/test_flash_attention.py
runs it. The CUDA kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops.attention import multi_head_attention
from mocov2_whisper_flamingo_tpu.ops.attention import _xla_attention
from mocov2_whisper_flamingo_tpu.ops.flash_attention import _flash_attention_fwd_impl

ATOL = 1e-5  # fp32: same algorithm, different summation order
BF16_ATOL = 2e-2  # bf16 output rounding (ulp 2^-8 at 1) and p rounding points


def _qkv(rng, b=2, tq=24, tk=40, h=2, d=16):
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for t in (tq, tk, tk))


def _pallas(q, k, v, valid, causal):
    b, tk = k.shape[0], k.shape[1]
    bias = (np.zeros((b, tk), np.float32) if valid is None
            else np.where(valid, 0.0, -1e30).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        out = _flash_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(bias), q.shape[-1] ** -0.5, causal, 8, 8)
    return np.asarray(out, np.float32)


def _port(q, k, v, valid, causal, dtype=torch.float32):
    t = lambda x: torch.from_numpy(x).to(dtype)
    mask = None if valid is None else torch.from_numpy(valid)
    return fa.flash_attention(t(q), t(k), t(v), kv_valid=mask, causal=causal)


CASES = {
    "unmasked": dict(shape=(2, 24, 40, 2, 16), lens=None, causal=False),
    "unmasked_square": dict(shape=(1, 16, 16, 4, 32), lens=None, causal=False),
    "key_padding": dict(shape=(2, 24, 40, 2, 16), lens=(25, 10), causal=False),
    "causal": dict(shape=(2, 16, 16, 2, 16), lens=None, causal=True),
    "unaligned": dict(shape=(2, 13, 27, 2, 16), lens=None, causal=False),
    "causal_unaligned": dict(shape=(2, 13, 27, 2, 16), lens=None, causal=True),
    "causal_masked": dict(shape=(2, 13, 27, 2, 16), lens=(27, 20), causal=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_and_xla(rng, case):
    spec = CASES[case]
    b, tq, tk, h, d = spec["shape"]
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    valid = None
    if spec["lens"] is not None:
        valid = np.arange(tk)[None, :] < np.asarray(spec["lens"])[:, None]
    ours = _port(q, k, v, valid, spec["causal"])
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (b, tq, h, d)
    np.testing.assert_allclose(ours.numpy(), _pallas(q, k, v, valid, spec["causal"]),
                               atol=ATOL, rtol=0)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if valid is None else jnp.asarray(valid),
                         d ** -0.5, spec["causal"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_bf16_inputs(rng):
    q, k, v = _qkv(rng, b=1, tq=16, tk=16)
    ours = _port(q, k, v, None, False, torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    rnd = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        pallas = _flash_attention_fwd_impl(
            *(jnp.asarray(rnd(x), jnp.bfloat16) for x in (q, k, v)),
            jnp.zeros((1, 16), jnp.float32), 16 ** -0.5, False, 8, 8)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(pallas, np.float32),
                               atol=BF16_ATOL, rtol=0)


def test_fully_masked_row_returns_zero_like_pallas(rng):
    """Pinned: a query row with no valid key gives 0 (the Pallas kernel),
    not mean(V) (the XLA path)."""
    q, k, v = _qkv(rng, b=2, tq=8, tk=12)
    valid = np.ones((2, 12), bool)
    valid[1] = False
    ours = _port(q, k, v, valid, False).numpy()
    pallas = _pallas(q, k, v, valid, False)
    assert np.all(ours[1] == 0.0) and np.all(pallas[1] == 0.0)
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=0)
    xla = np.asarray(_xla_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    jnp.asarray(valid), 16 ** -0.5, False))
    np.testing.assert_allclose(xla[1], np.broadcast_to(v[1].mean(0), xla[1].shape), atol=1e-5)


@pytest.mark.parametrize("causal,lens", [(False, None), (True, None), (False, (40, 9)),
                                         (True, (40, 0))])
def test_plain_attention_is_the_xla_twin(rng, causal, lens):
    """``backend="plain"`` reproduces ``_xla_attention``, masked rows
    (mean of V) included; ``backend="flash"`` on CPU is the plain K1."""
    q, k, v = _qkv(rng, b=2, tq=24, tk=40)
    valid = None if lens is None else np.arange(40)[None, :] < np.asarray(lens)[:, None]
    t = lambda x: torch.from_numpy(x)
    mask = None if valid is None else t(valid)
    ours = multi_head_attention(t(q), t(k), t(v), kv_valid=mask, causal=causal)
    ref = _xla_attention(*(jnp.asarray(x) for x in (q, k, v)),
                         None if valid is None else jnp.asarray(valid), 16 ** -0.5, causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    flash = multi_head_attention(t(q), t(k), t(v), kv_valid=mask, causal=causal,
                                 backend="flash")
    np.testing.assert_allclose(flash.numpy(), _pallas(q, k, v, valid, causal), atol=ATOL, rtol=0)


def test_cpu_calls_do_not_count_launches(rng):
    fa.reset_launches()
    q, k, v = _qkv(rng)
    _port(q, k, v, None, False)
    assert fa.launches == 0


@pytest.mark.parametrize("bad,err", [
    (dict(d=48), ValueError),       # head dim without a kernel instantiation
    (dict(dtype=torch.float16), TypeError),
    (dict(kshape=(2, 40, 3, 16)), ValueError),
    (dict(noncontig=True), ValueError),
    (dict(dtype=torch.bfloat16, misaligned=True), ValueError),  # 16-byte row loads
])
def test_kernel_wrapper_rejects_unsupported_inputs(bad, err):
    d = bad.get("d", 32)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros((2, 24, 2, d), dtype=dtype)
    k = torch.zeros(bad.get("kshape", (2, 40, 2, d)), dtype=dtype)
    v = torch.zeros_like(k)
    if bad.get("noncontig"):
        q = torch.zeros((2, 24, d, 2), dtype=dtype).transpose(2, 3)
    if bad.get("misaligned"):
        q = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    with pytest.raises(err):
        fa._check(q, k, v)


@pytest.mark.parametrize("dtype,d,expected", [
    (torch.bfloat16, 64, "wgmma_tma"),   # every Whisper size and the fusion
    (torch.bfloat16, 128, "wgmma_tma"),
    (torch.bfloat16, 32, "mma_sync"),
    (torch.float32, 32, "fma_f32"),
    (torch.float32, 64, "fma_f32"),
    (torch.float32, 128, "fma_f32"),
])
def test_route_by_dtype_and_head_dim(dtype, d, expected):
    assert fa.route(dtype, d) == expected
    assert expected in fa.ROUTES


@pytest.mark.parametrize("dtype,d,err", [(torch.bfloat16, 48, ValueError),
                                         (torch.float16, 64, TypeError)])
def test_route_rejects_what_no_kernel_takes(dtype, d, err):
    with pytest.raises(err):
        fa.route(dtype, d)


def test_every_head_dim_has_a_route_for_both_dtypes():
    routes = {fa.route(dt, d) for dt in (torch.float32, torch.bfloat16) for d in fa.HEAD_DIMS}
    assert routes == set(fa.ROUTES)


@pytest.mark.parametrize("head_dim,tq,bh,expected", [
    (64, 1500, 48, 3),    # encoder: 384 blocks in 3 waves of 192 rows beat 576 in 5 of 128
    (64, 400, 32, 2),     # fusion: both grids fit one wave; 128-row blocks walk fewer rows
    (64, 100, 6, 2),
    (64, 1, 1, 2),
    (64, 384, 132, 3),    # a tie (384 rows per SM either way) goes to the larger block
    (128, 1500, 48, 2),   # three groups do not fit the registers at Dh 128
])
def test_consumer_groups_for_serving_and_edge_shapes(head_dim, tq, bh, expected):
    assert fa.consumer_groups(head_dim, tq, bh, 132) == expected


def test_consumer_groups_never_walks_more_rows_than_the_other_choice():
    def rows_per_sm(n, tq, bh, sms):
        return -(-(-(-tq // (64 * n)) * bh) // sms) * 64 * n

    for tq in (1, 27, 127, 128, 129, 400, 448, 1500, 3000):
        for bh in (1, 6, 32, 48, 96, 200):
            for sms in (114, 132):
                n = fa.consumer_groups(64, tq, bh, sms)
                assert rows_per_sm(n, tq, bh, sms) <= rows_per_sm(5 - n, tq, bh, sms)


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
def test_check_rejects_a_scale_that_is_not_positive(scale):
    """The Hopper kernel takes each row's max before it scales the scores."""
    q = k = v = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="scale > 0"):
        fa._check(q, k, v, scale)


@pytest.mark.parametrize("noncontig", [False, True])
def test_mask_bytes_are_the_bool_mask(noncontig):
    valid = torch.from_numpy(np.random.default_rng(0).random((6, 3)) > 0.4)
    if noncontig:
        valid = valid.t()  # [3, 6], not contiguous
    b, tk = valid.shape
    packed = fa._mask_bytes(valid, b, tk, torch.device("cpu"))
    assert packed.dtype == torch.uint8 and packed.is_contiguous()
    assert packed.tolist() == valid.to(torch.uint8).tolist()
    if not noncontig:  # a contiguous mask on the device is read in place
        assert packed.data_ptr() == valid.data_ptr()


@pytest.mark.parametrize("mask,err", [
    (torch.ones((2, 40)), ValueError),                   # not bool
    (torch.ones((2, 39), dtype=torch.bool), ValueError),  # not [B, Tk]
    (torch.ones((40,), dtype=torch.bool), ValueError),
])
def test_mask_bytes_reject_bad_masks(mask, err):
    with pytest.raises(err):
        fa._mask_bytes(mask, 2, 40, torch.device("cpu"))


def test_mask_bytes_keep_the_bias_semantics(rng):
    """The kernels read the mask as bytes where they read an fp32 bias
    (0 valid / -1e30 masked) before: the same keys drop out, and a row with
    no valid key still gives 0."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, b=3, tq=9, tk=21))
    valid = torch.from_numpy(np.arange(21)[None, :] < np.array([21, 5, 0])[:, None])
    packed = fa._mask_bytes(valid, 3, 21, torch.device("cpu"))
    ours = fa.plain_flash_attention(q, k, v, kv_valid=packed.bool())
    bias = torch.where(valid, 0.0, fa.NEG_INF)  # the retired [B, Tk] fp32 bias
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5 + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1) * (bias > fa.NEG_INF).any(-1)[:, None, None, None]
    ref = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    torch.testing.assert_close(ours, ref, atol=ATOL, rtol=0)
    assert bool((ours[2] == 0).all())


def test_check_takes_strided_projection_chunks():
    """q/k/v as chunks of one [B, T, 3*H*Dh] projection: the strides a TMA
    tensor map reads in place (16-byte aligned, multiples of 8 elements)."""
    for dt in (torch.float32, torch.bfloat16):
        proj = torch.zeros((2, 30, 3 * 4 * 64), dtype=dt)
        q, k, v = (x.view(2, 30, 4, 64) for x in proj.chunk(3, dim=-1))
        assert q.stride() == (30 * 768, 768, 64, 1)
        fa._check(q, k, v)


@pytest.mark.parametrize("dtype,ok", [(torch.float32, True), (torch.bfloat16, False)])
def test_check_row_stride_rule_applies_to_bf16_only(dtype, ok):
    """A row stride that is no multiple of 8 elements cannot be a TMA stride
    (multiple of 16 bytes); the scalar fp32 kernel reads any stride."""
    buf = torch.zeros((2, 24, 2 * 32 + 4), dtype=dtype)
    q = buf[..., : 2 * 32].unflatten(-1, (2, 32))
    k = v = torch.zeros((2, 40, 2, 32), dtype=dtype)
    assert q.stride(1) == 68
    if ok:
        fa._check(q, k, v)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            fa._check(q, k, v)


# -- attention-probability dropout (plain path) ----------------------------------------


def _dropout_probe(rate, seed=3, b=2, tq=24, tk=40, h=2, d=16):
    """Attention with v = identity columns reads the dropped probabilities back:
    out[b, q, h, :] = probs[b, h, q, :d] when v[b, k, h, :] = e_k for k < d."""
    rng = np.random.default_rng(1)
    q, k, _ = (torch.from_numpy(x) for x in _qkv(rng, b, tq, tk, h, d))
    v = torch.zeros((b, tk, h, d))
    v[:, :d] = torch.eye(d)[None, :, None, :]
    gen = torch.Generator().manual_seed(seed)
    dropped = multi_head_attention(q, k, v, dropout_rate=rate, generator=gen)
    clean = multi_head_attention(q, k, v)
    return dropped, clean, gen


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_dropout_keep_rate_and_scaling(rate):
    dropped, clean, _ = _dropout_probe(rate, b=4, tq=64)
    kept = dropped != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.02  # 8192 draws: 3 sigma < 0.02
    torch.testing.assert_close(dropped[kept], clean[kept] / (1 - rate), atol=1e-6, rtol=1e-6)


def test_attention_dropout_draws_follow_the_generator_state():
    a, _, gen = _dropout_probe(0.3, seed=3)
    b, _, _ = _dropout_probe(0.3, seed=3)
    c, _, _ = _dropout_probe(0.3, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    state = gen.get_state()
    assert not torch.equal(state, torch.Generator().manual_seed(3).get_state())  # it advanced


@pytest.mark.parametrize("backend", ["plain", "flash"])
def test_attention_dropout_needs_a_generator_and_a_rate(rng, backend):
    """Without a generator (eval) or at rate 0 the call is deterministic, and
    ``backend="flash"`` with active dropout takes the plain path (K1 never
    materialises the probabilities), as the JAX package's does."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    clean = multi_head_attention(q, k, v, backend=backend)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(multi_head_attention(q, k, v, backend=backend, dropout_rate=0.1), clean)
    assert torch.equal(multi_head_attention(q, k, v, backend=backend, dropout_rate=0.0,
                                            generator=gen), clean)
    dropped = multi_head_attention(q, k, v, backend=backend, dropout_rate=0.5, generator=gen)
    gen2 = torch.Generator().manual_seed(0)
    plain = multi_head_attention(q, k, v, backend="plain", dropout_rate=0.5, generator=gen2)
    assert torch.equal(dropped, plain) and not torch.equal(dropped, clean)


def test_unknown_backend_is_refused(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    with pytest.raises(ValueError, match="unknown attention backend"):
        multi_head_attention(q, k, v, backend="xla")


# -- K1 under autograd -------------------------------------------------------------------

GRAD_ATOL = 2e-5  # fp32: the same recompute, other summation orders
# bf16: dq/dk/dv are rounded to bf16 (ulp 2^-8 at 1, gradients here reach ~4) and
# the recompute's P is rounded to bf16 before P.V in both packages.
GRAD_BF16_ATOL = 6e-2

GRAD_CASES = {
    "unmasked": dict(shape=(2, 24, 40, 2, 16), lens=None, causal=False),
    "key_padding": dict(shape=(2, 24, 40, 2, 16), lens=(25, 10), causal=False),
    "causal": dict(shape=(2, 16, 16, 2, 16), lens=None, causal=True),
    "causal_masked": dict(shape=(2, 13, 27, 2, 16), lens=(27, 20), causal=True),
    "fully_masked_row": dict(shape=(2, 8, 12, 2, 16), lens=(12, 0), causal=False),
}


def _jax_grads(q, k, v, valid, causal, cot, dtype=jnp.float32):
    import jax
    from mocov2_whisper_flamingo_tpu.ops.flash_attention import flash_attention as jflash

    def loss(q_, k_, v_):
        out = jflash(q_, k_, v_, kv_valid=None if valid is None else jnp.asarray(valid),
                     causal=causal, block_q=8, block_k=8)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


def _port_grads(q, k, v, valid, causal, cot, dtype=torch.float32, permuted=False):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    mask = None if valid is None else torch.from_numpy(valid)
    out = fa.flash_attention(*leaves, kv_valid=mask, causal=causal)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    if permuted:  # the cotangent reaches the Function as a non-contiguous view
        loss = (out.permute(0, 2, 1, 3).float() * torch.from_numpy(cot).permute(0, 2, 1, 3)).sum()
    else:
        loss = (out.float() * torch.from_numpy(cot)).sum()
    loss.backward()
    return out, [x.grad.float().numpy() for x in leaves]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_match_jax_custom_vjp(rng, case):
    spec = GRAD_CASES[case]
    b, tq, tk, h, d = spec["shape"]
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    cot = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    valid = None
    if spec["lens"] is not None:
        valid = np.arange(tk)[None, :] < np.asarray(spec["lens"])[:, None]
    out, ours = _port_grads(q, k, v, valid, spec["causal"], cot)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  _port(q, k, v, valid, spec["causal"]).numpy())
    for g, ref in zip(ours, _jax_grads(q, k, v, valid, spec["causal"], cot)):
        np.testing.assert_allclose(g, ref, atol=GRAD_ATOL, rtol=0)


def test_fully_masked_row_has_zero_output_but_nonzero_dv(rng):
    """Pinned mismatch, as in the JAX package: the forward returns 0 for a row
    with no valid key, the recompute's softmax gives that row uniform weights,
    so its dV is the mean cotangent, not 0."""
    q, k, v = _qkv(rng, 2, 8, 12, 2, 16)
    valid = np.arange(12)[None, :] < np.array([12, 0])[:, None]
    cot = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    out, (dq, dk, dv) = _port_grads(q, k, v, valid, False, cot)
    assert bool((out[1] == 0).all())
    np.testing.assert_allclose(dv[1], np.broadcast_to(cot[1].sum(0) / 12, dv[1].shape),
                               atol=GRAD_ATOL, rtol=0)
    jdq, jdk, jdv = _jax_grads(q, k, v, valid, False, cot)
    assert np.abs(jdv[1]).max() > 1e-2
    np.testing.assert_allclose(dv, jdv, atol=GRAD_ATOL, rtol=0)


def test_gradients_bf16(rng):
    q, k, v = _qkv(rng, 2, 16, 24, 2, 16)
    rnd = lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    q, k, v = rnd(q), rnd(k), rnd(v)
    cot = rnd(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    valid = np.arange(24)[None, :] < np.array([24, 9])[:, None]
    out, ours = _port_grads(q, k, v, valid, False, cot, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    for g, ref in zip(ours, _jax_grads(q, k, v, valid, False, cot, jnp.bfloat16)):
        np.testing.assert_allclose(g, ref, atol=GRAD_BF16_ATOL, rtol=0)


def test_gradients_with_a_noncontiguous_cotangent(rng):
    q, k, v = _qkv(rng, 2, 24, 40, 2, 16)
    cot = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    _, direct = _port_grads(q, k, v, None, False, cot)
    _, permuted = _port_grads(q, k, v, None, False, cot, permuted=True)
    for a, b in zip(direct, permuted):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_only_the_inputs_that_need_it_get_a_gradient(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    v.requires_grad_()
    fa.flash_attention(q, k, v).sum().backward()
    assert q.grad is None and k.grad is None and v.grad is not None


def test_no_autograd_node_without_a_gradient_to_take(rng):
    """The serving path pays for no autograd bookkeeping."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    assert fa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
