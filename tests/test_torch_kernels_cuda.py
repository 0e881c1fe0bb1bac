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
