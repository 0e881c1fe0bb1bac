"""Eval-path video preprocessing (counterpart of ``ops/video.py``).

Layout ``[..., T, C, H, W]``, float or uint8. ``jax.image.resize`` with
``method="bilinear"`` antialiases when it downsamples, so the resize here
uses ``antialias=True``: without it, 88 -> 64 differs from JAX by tens of
grey levels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop of ``[..., H, W]`` to ``[..., size, size]``."""
    h, w = frames.shape[-2], frames.shape[-1]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return frames[..., top:top + size, left:left + size]


def resize_bilinear(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of ``[..., C, H, W]`` to ``[..., C, size, size]`` in
    fp32 (half-pixel centres, antialiased when shrinking)."""
    lead, (c, h, w) = frames.shape[:-3], frames.shape[-3:]
    x = frames.reshape(-1, c, h, w).float()
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.reshape(*lead, c, size, size)


def normalize(frames: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """``(x / 255 - mean) / std`` over the channel axis of ``[..., C, H, W]``."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=frames.device)[:, None, None]
    std_t = torch.tensor(std, dtype=torch.float32, device=frames.device)[:, None, None]
    return (frames.float() / 255.0 - mean_t) / std_t


def eval_video_pipeline(frames: torch.Tensor, resize: int | None = None,
                        crop: int | None = None) -> torch.Tensor:
    """Deterministic eval path: (optional crop ->) (optional resize ->)
    /255 + ImageNet normalize."""
    x = frames
    if crop:
        x = center_crop(x, crop)
    if resize:
        x = resize_bilinear(x, resize)
    return normalize(x)
