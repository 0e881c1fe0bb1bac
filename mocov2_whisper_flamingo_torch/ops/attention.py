"""Multi-head attention (counterpart of ``ops/attention.py``).

Layout ``[B, T, H, Dh]`` for q/k/v; masks are bool with True = valid.
``backend="plain"`` is the twin of the JAX ``_xla_attention``: einsum
scores in fp32, ``-1e30`` masking, causal offset ``tk - tq``, fp32 softmax.
``backend="flash"`` goes through the hand-written kernel in
:mod:`ops.flash_attention` (its plain version on CPU tensors).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: torch.Tensor | None, scale: float,
                    causal: bool) -> torch.Tensor:
    """Einsum attention. A query row with no valid key returns mean(V), as
    the JAX XLA path does (softmax over a row of equal ``-1e30``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, :], NEG_INF)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(~(col <= row + (tk - tq)), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: torch.Tensor | None = None,
                         scale: float | None = None, causal: bool = False,
                         backend: str = "plain",
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, T, H, Dh]`` tensors (eval
    only: attention-probability dropout belongs to the training port)."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not ported yet (eval only)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if backend == "flash":
        from mocov2_whisper_flamingo_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, kv_valid=kv_valid, scale=scale, causal=causal)
    if backend != "plain":
        raise ValueError(f"unknown attention backend {backend!r}; expected 'plain' or 'flash'")
    return plain_attention(q, k, v, kv_valid, scale, causal)
