"""Audio feature ops (counterpart of ``ops/mel.py``). Only
``global_layer_norm`` is ported so far; the log-mel front end
(``whisper_log_mel``, ``reference_mel``) belongs to the audio slice."""

from __future__ import annotations

import torch


def global_layer_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """LayerNorm over the *entire* tensor (no affine), the reference's final
    audio-pipeline step ``F.layer_norm(x, x.shape)``: the padded
    ``[3000, 80]`` mel is normalised as one population."""
    mean = x.mean()
    var = (x - mean).square().mean()
    return (x - mean) * torch.rsqrt(var + eps)
