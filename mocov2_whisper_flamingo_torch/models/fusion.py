"""Flamingo-style tanh-gated cross-modal fusion (counterpart of
``models/fusion.py``). Per block::

    x = x + CrossAttn(LN(x), xa, xa, video_valid) * tanh(attn_gate)
    x = x + FF(LN(x)) * tanh(ff_gate)

Queries come from the audio stream, keys and values from the video stream;
the cross-attention runs the hand-written flash-attention kernel under the
``video_valid`` key mask (True = valid).

Train mode: attention-probability dropout is active only with ``train``, a
generator and a rate > 0; the flash kernel never materialises the
probabilities, so such a block takes the plain attention path. Otherwise the
block runs the flash kernel, whose backward recomputes the attention.
Dropout follows ``ff2``. With ``remat`` each block runs under
``torch.utils.checkpoint`` and its recompute replays the block's dropout
draws from the generator state the block started with (under CUDA graph
capture: the first run's kept draws).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    def __init__(self, d_model: int, n_heads: int, dropout: float, precision: L.Precision,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.dropout_rate = dropout
        self.attn = GatedAttention(d_model, precision, device)
        self.attn_ln = L.LayerNorm(d_model, device=device)
        self.ff_ln = L.LayerNorm(d_model, device=device)
        self.ff1 = L.Linear(d_model, 4 * d_model, True, precision, device)
        self.ff2 = L.Linear(4 * d_model, d_model, True, precision, device)
        self.attn_gate = L.zeros_param((), device)
        self.ff_gate = L.zeros_param((), device)
        self.backend = "flash"

    def tensor_parallel_units(self) -> list:
        """The cross-attention's q/k/v column-parallel and ``out``
        row-parallel, ``ff1`` / ``ff2`` likewise (``parallel/mesh.py``)."""
        a = self.attn
        return [(self.n_heads, [(a.q, "column"), (a.k, "column"), (a.v, "column"),
                                (a.out, "row")]),
                (None, [(self.ff1, "column"), (self.ff2, "row")])]

    def forward(self, x: torch.Tensor, xa: torch.Tensor, video_valid: torch.Tensor | None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the train-mode dropout draws (attention first,
        then feed-forward); None runs the block without dropout."""
        b, tq, d = x.shape
        tk, dh = xa.shape[1], d // self.n_heads
        # [B, T, heads, Dh]: all heads, or under tensor parallelism this rank's
        q = self.attn.q(self.attn_ln(x)).reshape(b, tq, -1, dh)
        k = self.attn.k(xa).reshape(b, tk, -1, dh)
        v = self.attn.v(xa).reshape(b, tk, -1, dh)
        attn = multi_head_attention(q, k, v, kv_valid=video_valid, backend=self.backend,
                                    dropout_rate=self.dropout_rate, generator=generator)
        attn = self.attn.out(attn.reshape(b, tq, -1))
        x = x + attn * torch.tanh(self.attn_gate).to(attn.dtype)
        ff = self.ff2(L.gelu(self.ff1(self.ff_ln(x))))
        ff = L.dropout(ff, self.dropout_rate, generator, deterministic=False)
        return x + ff * torch.tanh(self.ff_gate).to(ff.dtype)


def _checkpointed(block: GatedBlock, x, xa, video_valid, generator):
    """``block`` under activation checkpointing. The recompute rewinds the
    generator to where the block's first run found it, so it replays the same
    dropout draws, and then puts the generator back where the recompute
    found it, so later draws do not repeat earlier ones.

    Under CUDA graph capture (the train program, ``training/programs.py``)
    the generator's state lives on the host and cannot be rewound inside a
    graph: the first run keeps its draws (``L.KeptDraws``) and the
    recompute, captured in another graph, reads them back. The numbers are
    those of the rewind, and the generator ends where the rewind leaves it."""
    if generator is None:
        return checkpoint(block, x, xa, video_valid, use_reentrant=False,
                          preserve_rng_state=False)
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        kept = L.KeptDraws(generator)

        def run_kept(x, xa, video_valid):
            if kept.draws:
                kept.replay()
            return block(x, xa, video_valid, kept)

        return checkpoint(run_kept, x, xa, video_valid, use_reentrant=False,
                          preserve_rng_state=False)
    start = generator.get_state()
    first_run = True

    def run(x, xa, video_valid):
        nonlocal first_run
        if first_run:
            first_run = False
            return block(x, xa, video_valid, generator)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, xa, video_valid, generator)
        finally:
            generator.set_state(resume)

    return checkpoint(run, x, xa, video_valid, use_reentrant=False, preserve_rng_state=False)


class GatedCrossModalFusion(nn.Module):
    """``forward(audio, video, video_valid) -> fused [B, T, D]``."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int, dropout: float = 0.1,
                 precision: L.Precision = L.FP32, device=None, remat: bool = False):
        super().__init__()
        self.precision = precision
        self.remat = remat
        self.audio_proj = L.Linear(d_model, d_model, True, precision, device)
        self.video_proj = L.Linear(d_model, d_model, True, precision, device)
        self.layers = nn.ModuleList(GatedBlock(d_model, n_heads, dropout, precision, device)
                                    for _ in range(n_layers))
        self.ln_post = L.LayerNorm(d_model, device=device)

    def forward(self, audio: torch.Tensor, video: torch.Tensor,
                video_valid: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None, return_gates: bool = False):
        """``train`` with a ``generator`` (on the inputs' device) turns the
        dropout on; ``return_gates`` also returns ``tanh`` of every gate as
        ``{"attn_gate_i", "ff_gate_i"}``."""
        prec = self.precision
        x = self.audio_proj(prec.cast(audio))
        xa = self.video_proj(prec.cast(video))
        if not train:
            generator = None
        gates = {}
        for i, layer in enumerate(self.layers):
            if self.remat and torch.is_grad_enabled():
                x = _checkpointed(layer, x, xa, video_valid, generator)
            else:
                x = layer(x, xa, video_valid, generator)
            if return_gates:
                gates[f"attn_gate_{i}"] = torch.tanh(layer.attn_gate)
                gates[f"ff_gate_{i}"] = torch.tanh(layer.ff_gate)
        out = self.ln_post(x)
        return (out, gates) if return_gates else out
