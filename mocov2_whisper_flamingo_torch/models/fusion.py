"""Flamingo-style tanh-gated cross-modal fusion, eval path (counterpart of
``models/fusion.py``). Per block::

    x = x + CrossAttn(LN(x), xa, xa, video_valid) * tanh(attn_gate)
    x = x + FF(LN(x)) * tanh(ff_gate)

Queries come from the audio stream, keys and values from the video stream;
the cross-attention runs the hand-written flash-attention kernel under the
``video_valid`` key mask (True = valid).
"""

from __future__ import annotations

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.ops.attention import multi_head_attention


class GatedAttention(nn.Module):
    def __init__(self, d_model: int, precision: L.Precision, device=None):
        super().__init__()
        self.q = L.Linear(d_model, d_model, True, precision, device)
        self.k = L.Linear(d_model, d_model, True, precision, device)
        self.v = L.Linear(d_model, d_model, True, precision, device)
        self.out = L.Linear(d_model, d_model, True, precision, device)


class GatedBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, precision: L.Precision, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.attn = GatedAttention(d_model, precision, device)
        self.attn_ln = L.LayerNorm(d_model, device=device)
        self.ff_ln = L.LayerNorm(d_model, device=device)
        self.ff1 = L.Linear(d_model, 4 * d_model, True, precision, device)
        self.ff2 = L.Linear(4 * d_model, d_model, True, precision, device)
        self.attn_gate = L.zeros_param((), device)
        self.ff_gate = L.zeros_param((), device)

    def forward(self, x: torch.Tensor, xa: torch.Tensor,
                video_valid: torch.Tensor | None) -> torch.Tensor:
        b, tq, d = x.shape
        tk, h = xa.shape[1], self.n_heads
        q = self.attn.q(self.attn_ln(x)).reshape(b, tq, h, d // h)
        k = self.attn.k(xa).reshape(b, tk, h, d // h)
        v = self.attn.v(xa).reshape(b, tk, h, d // h)
        attn = multi_head_attention(q, k, v, kv_valid=video_valid, backend="flash")
        attn = self.attn.out(attn.reshape(b, tq, d))
        x = x + attn * torch.tanh(self.attn_gate).to(attn.dtype)
        ff = self.ff2(L.gelu(self.ff1(self.ff_ln(x))))
        return x + ff * torch.tanh(self.ff_gate).to(ff.dtype)


class GatedCrossModalFusion(nn.Module):
    """``forward(audio, video, video_valid) -> fused [B, T, D]``."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int, dropout: float = 0.1,
                 precision: L.Precision = L.FP32, device=None):
        super().__init__()
        del dropout  # the training-time rate; the eval path applies none
        self.precision = precision
        self.audio_proj = L.Linear(d_model, d_model, True, precision, device)
        self.video_proj = L.Linear(d_model, d_model, True, precision, device)
        self.layers = nn.ModuleList(GatedBlock(d_model, n_heads, precision, device)
                                    for _ in range(n_layers))
        self.ln_post = L.LayerNorm(d_model, device=device)

    def forward(self, audio: torch.Tensor, video: torch.Tensor,
                video_valid: torch.Tensor | None = None) -> torch.Tensor:
        prec = self.precision
        x = self.audio_proj(prec.cast(audio))
        xa = self.video_proj(prec.cast(video))
        for layer in self.layers:
            x = layer(x, xa, video_valid)
        return self.ln_post(x)
