"""Flash attention forward (port of the Pallas kernel K1).

``flash_attention`` replaces ``ops/flash_attention.py::flash_attention`` of
the JAX package, whose Pallas kernel ``_attention_kernel`` is the one TPU
kernel on the serving path: every Whisper-encoder self-attention and every
gated-fusion cross-attention goes through it. On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/flash_attention.cu``; on CPU
tensors it runs ``plain_flash_attention``, the same function in plain
PyTorch. There is no fallback from one to the other.

Masked-row behaviour is pinned to the Pallas kernel: a query row with no
valid key returns **0**. (The JAX XLA path returns mean(V) there instead;
no such row occurs on the serving path, where every example has at least one
valid video frame.)

Eval only: the recompute backward of the JAX ``custom_vjp`` belongs to the
training port.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _bias(kv_valid: torch.Tensor | None, b: int, tk: int,
          device) -> torch.Tensor | None:
    if kv_valid is None:
        return None
    if kv_valid.dtype != torch.bool or tuple(kv_valid.shape) != (b, tk):
        raise ValueError(f"kv_valid must be bool [{b}, {tk}], got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)}")
    return torch.where(kv_valid.to(device), 0.0, NEG_INF).to(torch.float32).contiguous()


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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, T, H, Dh] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; expected one of {HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]) for x in (q, k, v)):
        raise ValueError("bf16 flash_attention loads 16-byte rows: q/k/v need 16-byte "
                         "aligned storage and strides that are multiples of 8")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid limit 65535")


def _launch(q, k, v, bias, scale: float, causal: bool) -> torch.Tensor:
    from mocov2_whisper_flamingo_torch.ops import kernels

    global launches
    lib = kernels.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (CUDA error {rc})")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: torch.Tensor | None = None,
                    scale: float | None = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention over ``[B, Tq, H, Dh]`` queries and ``[B, Tk, H, Dh]``
    keys/values; ``kv_valid`` is an optional ``[B, Tk]`` bool (True = valid).
    Runs the CUDA kernel on CUDA tensors and the plain version on CPU
    tensors; a row with no valid key returns 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, kv_valid, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    _check(q, k, v)
    return _launch(q, k, v, _bias(kv_valid, q.shape[0], k.shape[1], q.device),
                   scale, causal)
