"""Multi-head attention (counterpart of ``ops/attention.py``).

Layout ``[B, T, H, Dh]`` for q/k/v; masks are bool with True = valid.
``backend="plain"`` is the twin of the JAX ``_xla_attention``: einsum
scores in fp32, ``-1e30`` masking, causal offset ``tk - tq``, fp32 softmax.
``backend="flash"`` goes through the hand-written kernel in
:mod:`ops.flash_attention` (its plain version on CPU tensors), which is
differentiable through its recompute backward.
"""

from __future__ import annotations

import torch

from mocov2_whisper_flamingo_torch.models import layers as L

NEG_INF = -1e30


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: torch.Tensor | None, scale: float,
                    causal: bool, dropout_rate: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Einsum attention. A query row with no valid key returns mean(V), as
    the JAX XLA path does (softmax over a row of equal ``-1e30``). With a
    rate > 0 and a generator, the post-softmax probabilities get inverted
    dropout (``nn.MultiheadAttention``'s train-mode semantics)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, :], NEG_INF)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(~(col <= row + (tk - tq)), NEG_INF)
    probs = L.dropout(torch.softmax(logits, dim=-1), dropout_rate, generator,
                      deterministic=False)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: torch.Tensor | None = None,
                         scale: float | None = None, causal: bool = False,
                         backend: str = "plain", dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, T, H, Dh]`` tensors.

    ``dropout_rate`` / ``generator``: attention-probability dropout (train
    only; pass no generator for eval). The flash kernel never materialises
    the probabilities, so a call with active dropout takes the plain path
    whatever ``backend`` says, as the JAX package's does."""
    if backend not in ("plain", "flash"):
        raise ValueError(f"unknown attention backend {backend!r}; expected 'plain' or 'flash'")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    active_dropout = dropout_rate > 0.0 and generator is not None
    if backend == "flash" and not active_dropout:
        from mocov2_whisper_flamingo_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, kv_valid=kv_valid, scale=scale, causal=causal)
    return plain_attention(q, k, v, kv_valid, scale, causal, dropout_rate, generator)
