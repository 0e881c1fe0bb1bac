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


def test_attention_dropout_is_not_ported(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    with pytest.raises(NotImplementedError):
        multi_head_attention(q, k, v, dropout_rate=0.1)
