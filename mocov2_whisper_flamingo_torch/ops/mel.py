"""STFT -> 80-bin log-mel spectrogram (counterpart of ``ops/mel.py``).

Two parity targets, both used by the reference:

- ``whisper_log_mel``: the Whisper feature pipeline (hann 400, hop 160,
  slaney-scale, slaney-norm mel filters, log10 with dynamic-range
  compression and ``(x + 4) / 4`` scaling), as HF ``WhisperFeatureExtractor``
  computes it;
- ``reference_mel``: the torchaudio ``MelSpectrogram`` that the reference's
  training pipeline feeds the model (HTK mel scale, no filter norm, power 2,
  no log).

The window, the real-DFT basis and the filter banks are made with numpy and
kept per device. The spectrum is either two matmuls against the real-DFT
basis (``method="matmul"``) or ``torch.fft.rfft``; the DFT and filter-bank
products are plain fp32 ``torch.matmul``, which the JAX package also computes
outside any hand-written kernel, at its highest matmul precision. On a CUDA
tensor they need true fp32 products: with TF32 matmuls switched on the
functions raise instead of returning features rounded to 10 mantissa bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
N_FRAMES = 3000  # 30 s of audio at 16 kHz / hop 160


def hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window. ``periodic=True`` matches ``torch.hann_window`` and the
    ``np.hanning(n + 1)[:-1]`` of the Whisper feature extractor."""
    m = n if periodic else n - 1
    i = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / m)
    return w.astype(dtype)


def _hz_to_mel(freq, mel_scale: str):
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)
    # slaney: linear below 1 kHz, log above
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels, mel_scale: str):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=16)
def mel_filter_bank(
    n_freqs: int = N_FFT // 2 + 1,
    n_mels: int = N_MELS,
    sample_rate: int = SAMPLE_RATE,
    f_min: float = 0.0,
    f_max: float | None = None,
    mel_scale: str = "slaney",
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filter bank ``[n_freqs, n_mels]`` (read-only).

    ``mel_scale="slaney", norm="slaney"`` is the Whisper filter bank;
    ``mel_scale="htk", norm=None`` is torchaudio's default, which the
    reference's training pipeline uses."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_min = _hz_to_mel(f_min, mel_scale)
    mel_max = _hz_to_mel(f_max, mel_scale)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, mel_scale)

    # Triangular filters between successive centre frequencies.
    fdiff = np.diff(hz_pts)  # [n_mels + 1]
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[None, :]
    fb = fb.astype(np.float32)
    fb.setflags(write=False)
    return fb


@functools.lru_cache(maxsize=8)
def _rdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: cos and sin matrices ``[n_fft, n_fft // 2 + 1]``."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _on_device(kind: str, device: torch.device, *args) -> tuple[torch.Tensor, ...]:
    """The numpy constants of ``kind`` as fp32 tensors on ``device``, copied
    there once: ``("stft", n_fft)`` gives (window, cos, sin), ``("mel",
    n_mels, mel_scale, norm)`` the filter bank."""
    if kind == "stft":
        arrays = (hann_window(args[0]), *_rdft_matrices(args[0]))
    else:
        n_mels, mel_scale, norm = args
        arrays = (mel_filter_bank(n_mels=n_mels, mel_scale=mel_scale, norm=norm),)
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


def _require_fp32_matmul(x: torch.Tensor) -> None:
    """The DFT and filter-bank products are parity-grade fp32. On the card a
    process-wide switch can turn fp32 matmuls into TF32 ones: refuse to
    compute features under it."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the log-mel front end needs fp32 matmuls on the card, but TF32 is on: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Overlapping frames of ``[..., T]`` -> ``[..., n_frames, n_fft]``, a
    view that copies no sample."""
    return x.unfold(-1, n_fft, hop)


def power_spectrogram(
    x: torch.Tensor,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
    center: bool = True,
    method: str = "fft",
) -> torch.Tensor:
    """``|STFT|^2`` of ``x`` (``[T]`` or ``[B, T]``) -> ``[..., n_frames,
    n_fft // 2 + 1]``. ``center=True`` reflect-pads ``n_fft // 2`` on both
    sides (the torch and Whisper convention). ``method="matmul"`` takes the
    spectrum as two products against the real-DFT basis, ``"fft"`` uses
    ``torch.fft.rfft``."""
    if method not in ("matmul", "fft"):
        raise ValueError(f"unknown method {method!r}; expected 'matmul' or 'fft'")
    x = x.float()
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]  # reflect padding wants a batch dimension
        x = F.pad(x.reshape(1, -1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, -1)
    win, cos_m, sin_m = _on_device("stft", x.device, n_fft)
    frames = _frame_signal(x, n_fft, hop) * win
    if method == "matmul":
        _require_fp32_matmul(frames)
        re = torch.matmul(frames, cos_m)
        im = torch.matmul(frames, sin_m)
        return re * re + im * im
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs() ** 2


def _mel_project(power: torch.Tensor, n_mels: int, mel_scale: str,
                 norm: str | None) -> torch.Tensor:
    _require_fp32_matmul(power)
    (fb,) = _on_device("mel", power.device, n_mels, mel_scale, norm)
    return torch.matmul(power, fb)  # [..., T, n_mels]


def whisper_log_mel(
    audio: torch.Tensor,
    n_mels: int = N_MELS,
    pad_to: int | None = None,
    method: str = "matmul",
) -> torch.Tensor:
    """Whisper log-mel features, as HF ``WhisperFeatureExtractor`` makes them.

    ``audio``: ``[T]`` or ``[B, T]`` 16 kHz waveform. Returns ``[...,
    n_mels, n_frames]`` with ``n_frames = len(audio) // hop`` (the last STFT
    frame is dropped, as in Whisper). With ``pad_to`` the waveform is first
    zero-padded or cut to that many samples (Whisper uses 480000 = 30 s)."""
    if pad_to is not None:
        t = audio.shape[-1]
        audio = F.pad(audio, (0, pad_to - t)) if t < pad_to else audio[..., :pad_to]
    power = power_spectrogram(audio, method=method)[..., :-1, :]  # drop the last frame
    mel = _mel_project(power, n_mels, "slaney", "slaney")
    log_spec = torch.log10(mel.clamp(min=1e-10))
    # Dynamic-range compression: floor at (max - 8) of the whole example.
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(-1, -2)  # [..., n_mels, T]


def reference_mel(audio: torch.Tensor, n_mels: int = N_MELS,
                  method: str = "matmul") -> torch.Tensor:
    """torchaudio-parity mel power spectrogram (HTK scale, no norm, no log),
    as the reference's audio pipeline produces it. Returns ``[..., n_mels,
    n_frames]`` with ``n_frames = 1 + len(audio) // hop`` (centred STFT, all
    frames kept)."""
    power = power_spectrogram(audio, method=method)
    return _mel_project(power, n_mels, "htk", None).transpose(-1, -2)


def log_mel_spectrogram(audio: torch.Tensor, **kwargs) -> torch.Tensor:
    """Alias of :func:`whisper_log_mel` (the canonical Whisper feature)."""
    return whisper_log_mel(audio, **kwargs)


def pad_or_trim_mel(mel: torch.Tensor, target_length: int = N_FRAMES) -> torch.Tensor:
    """Pad (zeros) or trim the time axis of ``[..., n_mels, T]`` to
    ``target_length``."""
    t = mel.shape[-1]
    if t < target_length:
        return F.pad(mel, (0, target_length - t))
    return mel[..., :target_length]


def global_layer_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """LayerNorm over the *entire* tensor (no affine), the reference's final
    audio-pipeline step ``F.layer_norm(x, x.shape)``: the padded
    ``[3000, 80]`` mel is normalised as one population."""
    mean = x.mean()
    var = (x - mean).square().mean()
    return (x - mean) * torch.rsqrt(var + eps)
