"""Host-side audio/video transforms (numpy, explicit RNG; counterpart of
``datamodule/transforms.py``, the same functions and the same draws, so a
loader fed the same generator state makes the same arrays bit for bit).

Behavioral parity with the reference pipelines (reference:
datamodule/transforms.py):

- ``AudioTransform``: waveform -> torchaudio-style mel (HTK scale, power 2)
  -> [T, F] -> SpecAugment (train: 2x48-bin freq masks + 2x len//8 time
  masks) -> pad/trim to 3000 -> babble AddNoise **in the mel domain** at a
  random SNR from {-5,0,5,10,15,20,inf} (quirk Q1 — the reference mixes noise
  after the MelSpectrogram, transforms.py:123-131; waveform-domain mixing is
  available behind ``noise_domain="waveform"``) -> layer-norm over the whole
  padded tensor (quirk Q5, transforms.py:131,141).
- ``VideoTransform``: train: bilinear resize to 64x64 -> /255 -> random
  horizontal flip -> ColorJitter(0.4,0.4,0.4,0.1) -> random grayscale(0.2)
  -> AdaptiveTimeMask(10,25) -> ImageNet normalize; val/test: /255 +
  normalize only (the reference skips the resize for val,
  transforms.py:93-95 — replicated).

These run on the host as part of per-sample IO; the batched on-device
path lives in ``ops.mel`` / ``ops.augment``.
All randomness takes an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

import logging

import numpy as np

from mocov2_whisper_flamingo_torch.datamodule.native import read_wav_mono
from mocov2_whisper_flamingo_torch.ops.mel import hann_window, mel_filter_bank

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
SNR_LEVELS = (-5, 0, 5, 10, 15, 20, 999999)


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------


def np_reference_mel(wave: np.ndarray, n_fft: int = 400, hop: int = 160,
                     n_mels: int = 80) -> np.ndarray:
    """torchaudio-MelSpectrogram-parity mel in pure numpy (HTK scale, no
    norm, power 2, centered reflect pad). Returns [n_mels, T]."""
    pad = n_fft // 2
    x = np.pad(wave.astype(np.float32), pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * hann_window(n_fft)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [T, n_fft//2+1]
    fb = mel_filter_bank(n_fft // 2 + 1, n_mels, mel_scale="htk", norm=None)
    return (power @ fb).T.astype(np.float32)  # [n_mels, T]


def spec_augment(mel_tf: np.ndarray, rng: np.random.Generator,
                 freq_mask_param: int = 48, n_freq_masks: int = 2,
                 time_mask_ratio: int = 8, n_time_masks: int = 2) -> np.ndarray:
    """SpecAugment on a [T, F] mel, reference semantics
    (transforms.py:144-179): each freq mask zeroes exactly ``freq_mask_param``
    bins starting at a random offset (skipped when F <= param); each time
    mask zeroes exactly len//ratio frames."""
    out = mel_tf.copy()
    t, f = out.shape
    max_freq_start = f - freq_mask_param
    for _ in range(n_freq_masks):
        if max_freq_start <= 0:
            continue
        start = int(rng.integers(0, max_freq_start))
        out[:, start:start + freq_mask_param] = 0
    time_mask_param = t // time_mask_ratio
    max_time_start = t - time_mask_param
    for _ in range(n_time_masks):
        if max_time_start <= 0:
            continue
        start = int(rng.integers(0, max_time_start))
        out[start:start + time_mask_param, :] = 0
    return out


def add_noise_snr(signal_ct: np.ndarray, noise_t: np.ndarray, snr_db: float) -> np.ndarray:
    """torchaudio ``add_noise`` semantics: per-row (last-dim) energies set the
    noise scale so the mixed SNR equals ``snr_db``. signal [C, T], noise [T]."""
    energy_signal = np.sum(signal_ct.astype(np.float64) ** 2, axis=-1)  # [C]
    energy_noise = np.sum(noise_t.astype(np.float64) ** 2)
    original_snr_db = 10 * (np.log10(np.maximum(energy_signal, 1e-30))
                            - np.log10(max(energy_noise, 1e-30)))
    scale = 10 ** ((original_snr_db - snr_db) / 20.0)  # [C]
    return (signal_ct + scale[:, None] * noise_t[None, :]).astype(np.float32)


def global_layer_norm_np(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    mean = x.mean()
    var = x.var()
    return ((x - mean) / np.sqrt(var + eps)).astype(np.float32)


class AddNoise:
    """Babble-noise mixing at a random SNR level. The noise bed is a 16 kHz
    wav (reference: transforms.py:47-59, asserted 16 kHz); when the file is
    missing (it is a large blob absent from the reference checkout too) the
    transform is a no-op and logs once."""

    def __init__(self, noise_file: str | None, snr_target: float | None = None,
                 sample_rate: int = 16000):
        self.snr_levels = [snr_target] if snr_target else list(SNR_LEVELS)
        self.noise: np.ndarray | None = None
        if noise_file:
            try:
                noise, sr = read_wav_mono(noise_file)
                assert sr == sample_rate, f"noise wav must be {sample_rate} Hz, got {sr}"
                self.noise = noise
            except FileNotFoundError:
                logger.warning("noise file %s missing; AddNoise is a no-op", noise_file)

    def __call__(self, mel_tf: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.noise is None:
            return mel_tf
        t = mel_tf.shape[0]
        start = int(rng.integers(0, max(len(self.noise) - t, 1)))
        segment = self.noise[start:start + t]
        if len(segment) < t:
            segment = np.pad(segment, (0, t - len(segment)))
        snr = float(rng.choice(self.snr_levels))
        # mel arrives [T, F]; mix per mel-bin rows like the reference's
        # speech.t() (transforms.py:53-59)
        return add_noise_snr(mel_tf.T, segment, snr).T


class AudioTransform:
    """waveform [T] -> normalized mel [3000, 80].

    ``on_device=True`` (train subset only): return the RAW unpadded mel
    [T_real, F] — no SpecAugment, no noise, no layer-norm. The dataset then
    pads + derives the real-length mask, and the whole stochastic chain
    runs batched on the card inside the train step
    (``ops.augment.make_batch_augment``) — the fix for hosts whose
    per-sample numpy pipeline cannot feed the device step.

    ``on_device_mel=True`` (with ``on_device``, train subset only): skip the
    host STFT entirely and return the RAW 1-D float32 waveform; the dataset
    packs it (pad + reflect tail, ``av_dataset.pack_waveform``) and the mel
    is computed on the card inside the train step
    (``ops.mel.reference_mel``). The host STFT is the single largest
    per-sample loader cost."""

    def __init__(self, subset: str, snr_target: float | None = None,
                 noise_file: str | None = None, target_length: int = 3000,
                 noise_domain: str = "mel", on_device: bool = False,
                 on_device_mel: bool = False):
        self.subset = subset
        self.target_length = target_length
        self.noise_domain = noise_domain
        self.on_device = on_device and subset == "train"
        self.emits_waveform = self.on_device and on_device_mel
        if subset == "train":
            self.noise = AddNoise(noise_file) if not self.on_device else None
        else:
            self.noise = AddNoise(noise_file, snr_target) if snr_target is not None else None

    @property
    def draws(self) -> bool:
        """Whether a call draws from its generator."""
        return ((self.subset == "train" and not self.on_device)
                or (self.noise is not None and self.noise.noise is not None))

    def __call__(self, wave: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if wave.ndim == 2:  # multi-channel -> mono
            wave = wave.mean(axis=0)
        if (self.noise_domain == "waveform" and self.noise is not None
                and self.noise.noise is not None):
            wave = add_noise_snr(wave[None], _noise_segment(self.noise, len(wave), rng),
                                 float(rng.choice(self.noise.snr_levels)))[0]
        if self.emits_waveform:
            return np.ascontiguousarray(wave, dtype=np.float32)
        mel = np_reference_mel(wave).T  # [T, F]
        if self.on_device:
            return mel[: self.target_length]
        if self.subset == "train":
            mel = spec_augment(mel, rng)
        # pad/trim time to target_length (reference: transforms.py:99-110
        # operates [F, T]; equivalent here on [T, F])
        t = mel.shape[0]
        if t < self.target_length:
            mel = np.pad(mel, ((0, self.target_length - t), (0, 0)))
        else:
            mel = mel[: self.target_length]
        if self.noise_domain == "mel" and self.noise is not None:
            mel = self.noise(mel, rng)
        return global_layer_norm_np(mel)


def _noise_segment(noise: AddNoise, t: int, rng: np.random.Generator) -> np.ndarray:
    start = int(rng.integers(0, max(len(noise.noise) - t, 1)))
    seg = noise.noise[start:start + t]
    if len(seg) < t:
        seg = np.pad(seg, (0, t - len(seg)))
    return seg


# ---------------------------------------------------------------------------
# Video
# ---------------------------------------------------------------------------


def bilinear_resize(frames: np.ndarray, size: int) -> np.ndarray:
    """[T, C, H, W] -> [T, C, size, size], align_corners=False (torch
    ``interpolate(mode="bilinear")`` semantics)."""
    t, c, h, w = frames.shape
    if h == size and w == size:
        return frames.astype(np.float32, copy=False)

    def grid(n_in, n_out):
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        src = np.clip(src, 0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, yf = grid(h, size)
    xlo, xhi, xf = grid(w, size)
    x = frames.astype(np.float32)
    top = x[:, :, ylo][:, :, :, xlo] * (1 - xf) + x[:, :, ylo][:, :, :, xhi] * xf
    bot = x[:, :, yhi][:, :, :, xlo] * (1 - xf) + x[:, :, yhi][:, :, :, xhi] * xf
    return top * (1 - yf[:, None]) + bot * yf[:, None]


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """[..., 3, H, W] in [0,1] -> HSV same shape (torch algorithm)."""
    r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dc = np.where(deltac == 0, 1.0, deltac)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(deltac == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-3)


def _hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    h, s, v = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    out = np.empty_like(img)
    choices_r = [v, q, p, p, t, v]
    choices_g = [t, v, v, q, p, p]
    choices_b = [p, p, t, v, v, q]
    out[..., 0, :, :] = np.choose(i, choices_r)
    out[..., 1, :, :] = np.choose(i, choices_g)
    out[..., 2, :, :] = np.choose(i, choices_b)
    return out


def color_jitter(frames: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.1) -> np.ndarray:
    """torchvision ColorJitter semantics on [T, C, H, W] in [0,1]: the four
    adjustments are applied in a random order with factors drawn once per
    clip; each result is clamped to [0,1]."""
    x = frames
    ops = rng.permutation(4)
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
            x = np.clip(x * f, 0, 1)
        elif op == 1 and contrast > 0:
            f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
            gray = (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])
            mean = gray.mean(axis=(-2, -1), keepdims=True)[:, None]
            x = np.clip(f * x + (1 - f) * mean, 0, 1)
        elif op == 2 and saturation > 0:
            f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
            gray = (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]
            x = np.clip(f * x + (1 - f) * gray, 0, 1)
        elif op == 3 and hue > 0:
            shift = rng.uniform(-hue, hue)
            hsv = _rgb_to_hsv(x)
            hsv[..., 0, :, :] = (hsv[..., 0, :, :] + shift) % 1.0
            x = np.clip(_hsv_to_rgb(hsv), 0, 1)
    return x.astype(np.float32)


def adaptive_time_mask(frames: np.ndarray, rng: np.random.Generator,
                       window: int = 10, stride: int = 25) -> np.ndarray:
    """Zero random temporal spans (reference: transforms.py:27-45): the
    number of masks scales with clip length (~length/stride), each up to
    ``window`` frames."""
    out = frames.copy()
    length = out.shape[0]
    n_mask = int((length + stride - 0.1) // stride)
    for _ in range(n_mask):
        t = int(rng.integers(0, window))
        if length - t <= 0 or t == 0:
            continue
        t_start = int(rng.integers(0, length - t))
        out[t_start:t_start + t] = 0
    return out


class VideoTransform:
    """[T, C, H, W] uint8/float frames -> normalized float32 [T, C, H', W'].

    ``on_device=True`` (train subset only): resize ONLY, returning raw
    0-255 **uint8** frames — flip/ColorJitter/grayscale/time-mask/normalize
    run batched on the card inside the train step
    (``ops.video.train_video_pipeline``, which casts to f32 there). The
    resize stays on the host so variable source resolutions still collate
    into one static batch shape. uint8 quarters the host->device transfer
    (31 MB -> 7.9 MB per B=4 batch of 400 frames) and skips the host f32
    copy; when the source clip is already at the target size the frames
    pass through untouched. Rounding the resized values to uint8 perturbs
    the augmentation input by at most 0.5/255 — invisible downstream of the
    stochastic jitter chain."""

    def __init__(self, subset: str, resize: int = 64, on_device: bool = False):
        self.subset = subset
        self.resize = resize
        self.on_device = on_device and subset == "train"

    @property
    def draws(self) -> bool:
        """Whether a call draws from its generator."""
        return self.subset == "train" and not self.on_device

    def __call__(self, frames: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        if frames.ndim != 4:
            raise ValueError(f"expected 4D (T,C,H,W), got {frames.shape}")
        if frames.shape[1] != 3:
            raise ValueError(f"expected 3 channels, got {frames.shape[1]}")
        rng = rng or np.random.default_rng()
        if self.on_device:
            if frames.shape[-2:] == (self.resize, self.resize):
                if frames.dtype == np.uint8:
                    return np.ascontiguousarray(frames)
                return np.ascontiguousarray(
                    np.clip(np.rint(frames), 0, 255).astype(np.uint8))
            x = bilinear_resize(frames.astype(np.float32), self.resize)
            return np.ascontiguousarray(
                np.clip(np.rint(x), 0, 255).astype(np.uint8))
        x = frames.astype(np.float32)
        if self.subset == "train":
            x = bilinear_resize(x, self.resize)
            x = x / 255.0
            if rng.random() < 0.5:
                x = x[..., ::-1]  # horizontal flip
            x = color_jitter(x, rng)
            if rng.random() < 0.2:
                gray = (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]
                x = np.repeat(gray, 3, axis=1)
            x = adaptive_time_mask(x, rng)
        else:
            # reference val/test path divides + normalizes WITHOUT resizing
            # (transforms.py:93-95) — replicated.
            x = x / 255.0
        x = (x - IMAGENET_MEAN[:, None, None]) / IMAGENET_STD[:, None, None]
        return np.ascontiguousarray(x, dtype=np.float32)
