"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
Skipped on hosts without a CUDA card.
"""

import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import flash_attention as fa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,lens,causal", [
    ((2, 130, 70, 3, 64), (70, 1), False),
    ((2, 13, 27, 2, 32), None, True),
    ((1, 100, 130, 2, 128), (0,), True),
])
def test_cuda_kernel_matches_plain(shape, lens, causal, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen).to("cuda", dtype) for t in (tq, tk, tk))
    mask = None if lens is None else (
        torch.arange(tk)[None, :] < torch.tensor(lens)[:, None]).cuda()
    before = fa.launches
    out = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


def _cuda_qkv(shape, dtype, strided=False, seed=0):
    b, tq, tk, h, d = shape
    gen = torch.Generator().manual_seed(seed)
    if strided:  # chunks of one [B, T, 3*H*Dh] projection, as the encoder passes them
        proj = torch.randn((b, tq, 3 * h * d), generator=gen).to("cuda", dtype)
        return tuple(x.view(b, tq, h, d) for x in proj.chunk(3, dim=-1))
    return tuple(torch.randn((b, t, h, d), generator=gen).to("cuda", dtype) for t in (tq, tk, tk))


def _cuda_mask(lens, tk):
    return None if lens is None else (torch.arange(tk)[None, :] < torch.tensor(lens)[:, None]).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,lens,causal,strided", [
    ("encoder", (4, 1500, 1500, 12, 64), None, False, False),
    ("fusion", (4, 400, 400, 8, 64), (400, 317, 64, 1), False, False),
    ("encoder_strided", (2, 1500, 1500, 12, 64), None, False, True),
    ("single_tile", (2, 100, 100, 3, 64), None, False, False),
    ("tail_27", (2, 27, 27, 2, 64), (27, 3), False, False),
    ("tail_130", (2, 130, 130, 4, 64), None, False, False),
    ("tail_130_strided", (2, 130, 130, 4, 64), None, False, True),
    ("causal_13x27", (2, 13, 27, 2, 64), None, True, False),
    ("causal_130x400", (2, 130, 400, 2, 64), (400, 300), True, False),
    ("causal_400x130", (2, 400, 130, 2, 64), None, True, False),
    ("dh32", (2, 130, 400, 2, 32), (400, 7), False, False),
    ("dh128", (2, 400, 130, 2, 128), (130, 1), False, False),
    ("dh128_causal", (2, 130, 400, 2, 128), None, True, False),
])
def test_bf16_kernel_matches_plain_at_serving_and_edge_shapes(name, shape, lens, causal, strided):
    """bf16 K1 on its route (Hopper kernel at Dh 64/128, mma.sync at Dh 32)
    against the plain version: serving shapes, key and query tails that are
    no multiple of the 128-key tile, a single tile, strided views, causal
    with Tq != Tk, every head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    q, k, v = _cuda_qkv(shape, torch.bfloat16, strided)
    mask = _cuda_mask(lens, tk)
    before = fa.launches
    out = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and out.is_contiguous()
    ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("consumers", [2, 3])
@pytest.mark.parametrize("shape,lens,causal,strided", [
    ((2, 400, 400, 8, 64), (400, 0), False, False),
    ((2, 130, 130, 4, 64), None, False, True),
    ((2, 130, 400, 2, 64), (400, 300), True, False),
    ((2, 400, 130, 2, 64), None, True, False),
    ((1, 27, 27, 2, 64), (27,), False, False),
])
def test_bf16_hopper_kernel_matches_plain_with_each_block_size(consumers, shape, lens, causal,
                                                                strided):
    """Dh 64 takes 2 or 3 consumer warpgroups per block by shape; both are
    held against the plain version, masks and causal offsets included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    q, k, v = _cuda_qkv(shape, torch.bfloat16, strided)
    mask = _cuda_mask(lens, tk)
    out = fa._launch(q, k, v, fa._mask_bytes(mask, b, tk, q.device), d ** -0.5, causal,
                     consumers=consumers)
    torch.cuda.synchronize()
    ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    for i, n in enumerate(lens or ()):
        if n == 0:
            assert bool((out[i] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_row_without_valid_key_is_exact_zero(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _cuda_qkv((3, 200, 300, 2, d), torch.bfloat16)
    out = fa.flash_attention(q, k, v, kv_valid=_cuda_mask((300, 0, 129), 300))
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    assert bool(out[0].abs().sum() > 0) and bool(out[2].abs().sum() > 0)


@pytest.mark.cuda
def test_causal_rows_before_the_first_key_are_zero():
    """Tq > Tk with causal offset Tk - Tq < 0: the first Tq - Tk rows see no
    key and return 0, on the Hopper kernel as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _cuda_qkv((2, 300, 100, 2, 64), torch.bfloat16)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert bool((out[:, :200] == 0).all())
    ref = fa.plain_flash_attention(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,lens,causal", [
    ((4, 400, 400, 8, 64), (400, 317, 64, 1), False),
    ((2, 130, 400, 2, 64), (400, 300), True),
    ((2, 70, 90, 3, 32), None, False),
])
def test_autograd_wrapper_on_the_card(shape, lens, causal, dtype, tol):
    """Through the autograd wrapper the forward is the kernel's, bit for
    bit, one launch; dq, dk, dv (recompute in torch ops, from a
    non-contiguous cotangent) agree with autograd through the plain version
    within ``tol`` of the largest reference gradient (or of 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    q, k, v = _cuda_qkv(shape, dtype)
    mask = _cuda_mask(lens, tk)
    cot = torch.randn((b, h, tq, d), generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
    direct = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.launches
    out = fa.flash_attention(*leaves, kv_valid=mask, causal=causal)
    assert fa.launches == before + 1 and torch.equal(out, direct)
    grads = torch.autograd.grad(out.transpose(1, 2), leaves, cot)
    assert fa.launches == before + 1  # the backward launches no kernel of the port
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = fa.plain_flash_attention(*ref_leaves, kv_valid=mask, causal=causal)
    for g, r in zip(grads, torch.autograd.grad(ref, ref_leaves, cot.transpose(1, 2))):
        assert g.dtype == dtype
        scale = max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_cuda_call_without_a_gradient_builds_no_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _cuda_qkv((2, 130, 130, 4, 64), torch.bfloat16)
    assert fa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None
