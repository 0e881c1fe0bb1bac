"""Batched video preprocessing on the device (counterpart of
``ops/video.py``): the deterministic eval path and the stochastic train path.

Layout ``[..., T, C, H, W]``, float or uint8. ``jax.image.resize`` with
``method="bilinear"`` antialiases when it downsamples, so the resize here
uses ``antialias=True``: without it, 88 -> 64 differs from JAX by tens of
grey levels.

The train path's random choices are drawn by small functions of an explicit
``torch.Generator`` (``draw_*``), and applied by deterministic functions that
take the draws (``color_jitter_with_factors``).
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _channel_constants(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)[:, None, None]


def _per_channel(values, device) -> torch.Tensor:
    """``values`` as fp32 ``[C, 1, 1]`` on ``device``, copied from the host
    once per device and kept: a serving engine's dispatch thread then never
    waits at a copy for the work queued before it, and a CUDA graph of the
    pipeline (``AVWhisperNet.encode``) reads the kept tensor, as a capture
    copies nothing from the host."""
    return _channel_constants(tuple(float(v) for v in values), torch.device(device))


def normalize(frames: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """``(x / 255 - mean) / std`` over the channel axis of ``[..., C, H, W]``."""
    mean_t, std_t = _per_channel(mean, frames.device), _per_channel(std, frames.device)
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


def rgb_to_grayscale(frames: torch.Tensor, keep_channels: bool = True) -> torch.Tensor:
    """ITU-R 601 luma over the channel axis of ``[..., C, H, W]``."""
    r, g, b = frames[..., 0, :, :], frames[..., 1, :, :], frames[..., 2, :, :]
    gray = (0.299 * r + 0.587 * g + 0.114 * b)[..., None, :, :]
    return gray.repeat_interleave(3, dim=-3) if keep_channels else gray


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``[..., 3, H, W]`` in [0, 1] -> HSV (torchvision's algorithm)."""
    r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / torch.clamp(maxc, min=1e-12), 0.0)
    dc = torch.where(deltac == 0, 1.0, deltac)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac == 0, 0.0, h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-3)


def _hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(choices):
        out = choices[0]
        for k in range(1, 6):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-3)


def color_jitter_with_factors(x: torch.Tensor, f_brightness: torch.Tensor,
                              f_contrast: torch.Tensor, f_saturation: torch.Tensor,
                              hue_shift: torch.Tensor) -> torch.Tensor:
    """ColorJitter on ``[B, T, C, H, W]`` in [0, 1] with per-sample factors
    ``[B]``, applied brightness -> contrast -> saturation -> hue (each
    clamped). The per-op math is torchvision's; the op order is fixed, where
    the host transform samples a permutation per clip."""
    bvec = lambda f: f[:, None, None, None, None]
    luma = lambda y: 0.299 * y[:, :, 0] + 0.587 * y[:, :, 1] + 0.114 * y[:, :, 2]
    x = torch.clamp(x * bvec(f_brightness), 0.0, 1.0)

    mean = luma(x).mean(dim=(-2, -1), keepdim=True)[:, :, None]
    x = torch.clamp(bvec(f_contrast) * x + (1.0 - bvec(f_contrast)) * mean, 0.0, 1.0)

    gray = luma(x)[:, :, None]
    x = torch.clamp(bvec(f_saturation) * x + (1.0 - bvec(f_saturation)) * gray, 0.0, 1.0)

    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0, :, :] + hue_shift[:, None, None, None], 1.0)
    hsv = torch.cat([h[..., None, :, :], hsv[..., 1:, :, :]], dim=-3)
    return torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)


def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def draw_color_jitter(b: int, generator: torch.Generator, brightness: float = 0.4,
                      contrast: float = 0.4, saturation: float = 0.4,
                      hue: float = 0.1) -> tuple[torch.Tensor, ...]:
    """Per-sample factors ``[B]``: brightness, contrast and saturation
    uniform in ``[max(0, 1 - a), 1 + a)``, hue shift uniform in ``[-hue, hue)``."""
    return (_uniform(generator, (b,), max(0.0, 1 - brightness), 1 + brightness),
            _uniform(generator, (b,), max(0.0, 1 - contrast), 1 + contrast),
            _uniform(generator, (b,), max(0.0, 1 - saturation), 1 + saturation),
            _uniform(generator, (b,), -hue, hue))


def color_jitter(x: torch.Tensor, generator: torch.Generator, brightness: float = 0.4,
                 contrast: float = 0.4, saturation: float = 0.4,
                 hue: float = 0.1) -> torch.Tensor:
    """Random per-sample ColorJitter on ``[B, T, C, H, W]`` in [0, 1]."""
    return color_jitter_with_factors(
        x, *draw_color_jitter(x.shape[0], generator, brightness, contrast, saturation, hue))


def train_video_pipeline(frames: torch.Tensor, generator: torch.Generator,
                         resize: int | None = 64, crop: int | None = None,
                         flip_prob: float = 0.5, jitter: tuple | None = (0.4, 0.4, 0.4, 0.1),
                         grayscale_prob: float = 0.2, time_mask_window: int = 10,
                         time_mask_stride: int = 25,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched stochastic train path on ``[B, T, C, H, W]`` raw (0-255)
    frames, in the reference op order: (ROI crop ->) resize -> /255 -> random
    hflip -> ColorJitter -> random grayscale -> adaptive time mask -> ImageNet
    normalize.

    ``resize=None`` skips the resize (frames already at target size).
    ``lengths`` ``[B]``: per-sample real frame counts for pre-padded clips;
    time masks stay within the real region and pad frames are zeroed again
    after normalization."""
    from mocov2_whisper_flamingo_torch.ops.augment import adaptive_time_mask

    b = frames.shape[0]
    x = frames
    if crop:
        x = center_crop(x, crop)
    if resize is not None and (x.shape[-2] != resize or x.shape[-1] != resize):
        x = resize_bilinear(x, resize)
    x = x.float() / 255.0

    do_flip = torch.rand((b,), generator=generator, device=generator.device) < flip_prob
    x = torch.where(do_flip[:, None, None, None, None], x.flip(-1), x)
    if jitter is not None:
        x = color_jitter(x, generator, *jitter)
    do_gray = torch.rand((b,), generator=generator, device=generator.device) < grayscale_prob
    x = torch.where(do_gray[:, None, None, None, None], rgb_to_grayscale(x), x)

    x = adaptive_time_mask(x, generator, window=time_mask_window, stride=time_mask_stride,
                           lengths=lengths)
    x = (x - _per_channel(IMAGENET_MEAN, x.device)) / _per_channel(IMAGENET_STD, x.device)
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths.to(x.device).reshape(b)[:, None])
        x = x * valid[:, :, None, None, None]
    return x
