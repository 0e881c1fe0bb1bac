"""Flash attention forward (port of the Pallas kernel K1).

``flash_attention`` replaces ``ops/flash_attention.py::flash_attention`` of
the JAX package, whose Pallas kernel ``_attention_kernel`` is the one TPU
kernel on the serving path: every Whisper-encoder self-attention and every
gated-fusion cross-attention goes through it. On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/flash_attention.cu``; on CPU
tensors it runs ``plain_flash_attention``, the same function in plain
PyTorch. There is no fallback from one to the other.

``route`` picks the CUDA kernel by dtype and head dim: bf16 at Dh 64 and 128
(every Whisper size and the fusion) takes the Hopper kernel (TMA ring,
warp-specialised ``wgmma``), bf16 at Dh 32 the ``mma.sync`` kernel, fp32 the
scalar kernel. The Hopper kernel's block holds 2 or 3 consumer warpgroups
of 64 query rows; ``consumer_groups`` picks the count per shape. The key
mask goes to the kernel as the ``[B, Tk]`` bool tensor's own bytes.

Masked-row behaviour is pinned to the Pallas kernel: a query row with no
valid key returns **0**. (The JAX XLA path returns mean(V) there instead;
no such row occurs on the serving path, where every example has at least one
valid video frame.)

Under autograd the call goes through ``_FlashAttention``, the counterpart of
the JAX ``custom_vjp``: the forward is the kernel, the backward recomputes
the attention in plain torch ops (``_reference_attention``) from the saved
q, k, v and mask and differentiates that. The recompute's softmax gives a
row with no valid key uniform weights, so that row's dV (and dq, dk through
the additive bias) is not zero although its forward output is: the JAX
package has the same mismatch, and the port keeps it. A call whose q, k and
v need no gradient launches the kernel directly.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
ROUTES = {"fma_f32": 0, "mma_sync": 1, "wgmma_tma": 2}  # as csrc/flash_attention.cu numbers them

launches = 0  # kernel launches since the last reset_launches()
# The same launches by kernel instantiation, named as the CUDA source's
# templates are: "wgmma_tma<Dh, consumer warpgroups, mask, causal>".
launches_by_kernel: collections.Counter = collections.Counter()


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_kernel.clear()


def uncounted(fn):
    """Run ``fn()`` with the launches it makes left out of the counts.
    Returns ``(fn's result, its launches, its launches by kernel)``: a CUDA
    graph's capture records its launches here and ``credit`` adds them at
    each replay (``decode/programs.py``), so that the counts stay the kernels
    sent to the card."""
    global launches
    n0, by0 = launches, collections.Counter(launches_by_kernel)
    try:
        out = fn()
        n, by = launches - n0, launches_by_kernel - by0
    finally:
        launches = n0
        launches_by_kernel.clear()
        launches_by_kernel.update(by0)
    return out, n, by


def credit(n: int, by_kernel: collections.Counter) -> None:
    """Count ``n`` launches, ``by_kernel`` of each instantiation, that a
    replayed CUDA graph sent to the card."""
    global launches
    launches += n
    launches_by_kernel.update(by_kernel)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that a call with this dtype and head dim launches."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not supported; expected one of {HEAD_DIMS}")
    if dtype == torch.float32:
        return "fma_f32"
    if dtype == torch.bfloat16:
        return "mma_sync" if head_dim == 32 else "wgmma_tma"
    raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")


def consumer_groups(head_dim: int, tq: int, bh: int, sms: int) -> int:
    """Consumer warpgroups (64 query rows each) per block of the Hopper
    kernel for ``tq`` queries and ``bh`` = B*H heads on ``sms`` SMs: the
    count whose grid, one block per SM, leaves each SM the fewest query rows
    to walk, the last, partial wave of blocks counted as a full one. A tie
    goes to the larger block, which reads K and V from L2 fewer times. Three
    groups do not fit the registers at Dh 128."""
    def rows_per_sm(n: int) -> int:
        blocks = -(-tq // (64 * n)) * bh
        return -(-blocks // sms) * 64 * n

    return min((3, 2) if head_dim == 64 else (2,), key=rows_per_sm)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _mask_bytes(kv_valid: torch.Tensor | None, b: int, tk: int,
                device) -> torch.Tensor | None:
    """The key mask as the kernel reads it: ``[B, Tk]`` contiguous bytes on
    ``device``, 1 for a valid key. No copy when the mask is already there."""
    if kv_valid is None:
        return None
    if kv_valid.dtype != torch.bool or tuple(kv_valid.shape) != (b, tk):
        raise ValueError(f"kv_valid must be bool [{b}, {tk}], got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)}")
    return kv_valid.to(device).contiguous().view(torch.uint8)


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: torch.Tensor | None = None,
                          scale: float | None = None,
                          causal: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores and softmax,
    ``-1e30`` masking, causal offset ``tk - tq``, probabilities rounded to
    the input dtype before the P.V product, zeros for a row with no valid
    key, output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    ok = torch.ones((b, 1, tq, tk), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        ok = ok & kv_valid.to(q.device)[:, None, None, :]
    if causal:
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        ok = ok & (col <= row + (tk - tq))
    probs = torch.softmax(logits.masked_fill(~ok, NEG_INF), dim=-1)
    probs = probs.masked_fill(~ok.any(dim=-1, keepdim=True), 0.0)
    probs = probs.to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float = 1.0) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, T, H, Dh] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; expected one of {HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    # TMA tensor maps (and the 16-byte row loads of the Dh 32 kernel) take 16-byte
    # aligned base addresses and byte strides that are multiples of 16.
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]) for x in (q, k, v)):
        raise ValueError("bf16 flash_attention copies 16-byte rows (TMA): q/k/v need "
                         "16-byte aligned storage and strides that are multiples of 8")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid limit 65535")
    if not scale > 0:  # the Hopper kernel takes each row's max before it scales
        raise ValueError(f"flash_attention's kernels take scale > 0, got {scale}")


def _launch(q, k, v, mask, scale: float, causal: bool,
            consumers: int | None = None) -> torch.Tensor:
    """Launch the route's kernel; ``consumers`` overrides the Hopper
    kernel's ``consumer_groups`` choice (for timing each block size)."""
    from mocov2_whisper_flamingo_torch.ops import kernels

    global launches
    lib = kernels.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if tk == 0:
        return out.zero_()
    kernel = route(q.dtype, d)
    if kernel != "wgmma_tma":
        consumers = 0
    elif consumers is None:
        consumers = consumer_groups(d, tq, b * h, _sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            ROUTES[kernel], consumers, b, h, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), stream)
    if rc != 0:
        why = {-1: "no kernel for this dtype, head dim and block",
               -2: "a TMA tensor map cannot describe q/k/v",
               -3: "the CUDA driver has no cuTensorMapEncodeTiled"}.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"flash_attention kernel launch failed: {why}")
    launches += 1
    launches_by_kernel[f"{kernel}<{d}, {consumers}, {str(mask is not None).lower()}, "
                       f"{str(bool(causal)).lower()}>"] += 1
    return out


def _forward(q, k, v, kv_valid, scale: float, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, kv_valid, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    _check(q, k, v, scale)
    return _launch(q, k, v, _mask_bytes(kv_valid, q.shape[0], k.shape[1], q.device),
                   scale, causal)


def _reference_attention(q, k, v, kv_valid, scale: float, causal: bool) -> torch.Tensor:
    """The function the backward differentiates (twin of the JAX package's
    ``_reference_attention``): fp32 scores, the key mask as an additive
    ``-1e30`` bias, causal offset ``tk - tq``, fp32 softmax, probabilities
    cast to v's dtype before P.V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_valid is not None:
        bias = torch.where(kv_valid.to(q.device), 0.0, NEG_INF).to(torch.float32)
        logits = logits + bias[:, None, None, :]
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(~(col <= row + (tk - tq)), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, recompute backward; saves q, k, v and the mask only."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, scale, causal):
        ctx.save_for_backward(q, k, v, kv_valid)
        ctx.scale, ctx.causal = scale, causal
        return _forward(q, k, v, kv_valid, scale, causal)

    @staticmethod
    def backward(ctx, grad_out):
        *qkv, kv_valid = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(need)
                   for x, need in zip(qkv, ctx.needs_input_grad[:3])]
            out = _reference_attention(*qkv, kv_valid, ctx.scale, ctx.causal)
            wanted = [x for x in qkv if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)))
        return (*(next(grads) if x.requires_grad else None for x in qkv), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: torch.Tensor | None = None,
                    scale: float | None = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention over ``[B, Tq, H, Dh]`` queries and ``[B, Tk, H, Dh]``
    keys/values; ``kv_valid`` is an optional ``[B, Tk]`` bool (True = valid).
    Runs the CUDA kernel on CUDA tensors and the plain version on CPU
    tensors; a row with no valid key returns 0. Differentiable in q, k and v
    (recompute backward)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_valid, float(scale), causal)
    return _forward(q, k, v, kv_valid, scale, causal)
