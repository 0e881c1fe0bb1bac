"""Batched train augmentation on the device (counterpart of
``ops/augment.py``): SpecAugment (2 x 48-bin frequency masks, 2 x len//8 time
masks), babble-noise SNR mixing in the mel domain, global layer-norm, and the
adaptive time mask for video.

Every random choice comes from an explicit ``torch.Generator`` on the
tensors' device. Each augmentation is split into a small function that draws
(``draw_*``) and a deterministic function that takes the draws
(``span_keep_mask``, ``add_noise_snr``, ``mix_noise_segments``), so the
deterministic parts can be held against the JAX package although the two
libraries' random streams differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mocov2_whisper_flamingo_torch.ops.mel import N_FRAMES, global_layer_norm, reference_mel

SNR_LEVELS = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 999999.0)


def span_keep_mask(length: int, starts: torch.Tensor, widths: torch.Tensor | int
                   ) -> torch.Tensor:
    """Bool ``[..., length]``, False inside any of the spans ``[start, start
    + width)``; ``starts`` is ``[..., n]``, ``widths`` an int or a tensor
    that broadcasts against it. A span of width 0 masks nothing."""
    pos = torch.arange(length, device=starts.device)
    ends = starts + widths
    hit = (pos >= starts[..., None]) & (pos < ends[..., None])
    return ~hit.any(dim=-2)


def _rand(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def _randint(generator: torch.Generator, shape, high: int) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=generator, device=generator.device)


def draw_spec_augment(batch_shape: tuple, t: int, f: int, generator: torch.Generator,
                      freq_mask_param: int = 48, n_freq_masks: int = 2,
                      time_mask_ratio: int = 8, n_time_masks: int = 2,
                      lengths: torch.Tensor | None = None) -> dict:
    """Mask spans for a ``[*batch_shape, t, f]`` mel: ``freq_starts`` and
    ``time_starts`` ``[*batch_shape, n]`` (None where the axis is too short
    for its mask) with ``freq_width`` and ``time_width``. With ``lengths``
    the time masks lie in each sample's real region: width ``length //
    ratio``, start in ``[0, length - width)``."""
    draws = {"freq_starts": None, "freq_width": freq_mask_param,
             "time_starts": None, "time_width": t // time_mask_ratio}
    if f - freq_mask_param > 0 and freq_mask_param > 0:
        draws["freq_starts"] = _randint(generator, (*batch_shape, n_freq_masks),
                                        f - freq_mask_param)
    if lengths is None:
        width = t // time_mask_ratio
        if t - width > 0 and width > 0:
            draws["time_starts"] = _randint(generator, (*batch_shape, n_time_masks), t - width)
    else:
        lengths = lengths.to(generator.device).reshape(*batch_shape)
        width = (lengths // time_mask_ratio)[..., None]
        span = torch.clamp(lengths[..., None] - width, min=0)
        u = _rand(generator, (*batch_shape, n_time_masks))
        draws["time_starts"] = torch.floor(u * span).to(torch.int64)
        draws["time_width"] = width
    return draws


def apply_spec_augment(mel_tf: torch.Tensor, draws: dict) -> torch.Tensor:
    """Zero the drawn frequency and time spans of ``[..., T, F]``."""
    t, f = mel_tf.shape[-2:]
    if draws["time_starts"] is not None:
        mel_tf = mel_tf * span_keep_mask(t, draws["time_starts"],
                                         draws["time_width"])[..., :, None]
    if draws["freq_starts"] is not None:
        mel_tf = mel_tf * span_keep_mask(f, draws["freq_starts"],
                                         draws["freq_width"])[..., None, :]
    return mel_tf


def spec_augment(mel_tf: torch.Tensor, generator: torch.Generator, freq_mask_param: int = 48,
                 n_freq_masks: int = 2, time_mask_ratio: int = 8, n_time_masks: int = 2,
                 lengths: torch.Tensor | None = None) -> torch.Tensor:
    """SpecAugment on ``[..., T, F]`` (batched over the leading axes).
    ``lengths`` (shape = batch dims): per-sample real frame counts for mel
    that was padded before augmentation, so padding never absorbs a mask."""
    *batch, t, f = mel_tf.shape
    return apply_spec_augment(mel_tf, draw_spec_augment(
        tuple(batch), t, f, generator, freq_mask_param, n_freq_masks, time_mask_ratio,
        n_time_masks, lengths))


def add_noise_snr(signal: torch.Tensor, noise: torch.Tensor,
                  snr_db: torch.Tensor | float) -> torch.Tensor:
    """torchaudio ``add_noise`` semantics over the last axis: scale the noise
    so that each row's SNR equals ``snr_db``. signal ``[..., C, T]``, noise
    ``[..., T]``, ``snr_db`` a number or a tensor that broadcasts against
    ``[..., C]``."""
    energy_signal = signal.float().square().sum(dim=-1)
    energy_noise = torch.clamp(noise.float().square().sum(dim=-1), min=1e-30)
    original_snr_db = 10.0 * (torch.log10(torch.clamp(energy_signal, min=1e-30))
                              - torch.log10(energy_noise)[..., None])
    scale = torch.pow(10.0, (original_snr_db - snr_db) / 20.0)
    return (signal + scale[..., None] * noise[..., None, :]).to(signal.dtype)


def draw_babble_noise(batch_shape: tuple, t: int, bed_length: int, generator: torch.Generator,
                      n_levels: int = len(SNR_LEVELS)) -> tuple[torch.Tensor, torch.Tensor]:
    """A segment start in ``[0, max(bed_length - t, 1))`` and an SNR level
    index in ``[0, n_levels)`` per sample."""
    return (_randint(generator, batch_shape, max(bed_length - t, 1)),
            _randint(generator, batch_shape, n_levels))


def mix_noise_segments(mel_tf: torch.Tensor, noise_bed: torch.Tensor, starts: torch.Tensor,
                       snr_db: torch.Tensor) -> torch.Tensor:
    """Mix ``noise_bed[start : start + T]`` into each ``[T, F]`` mel at its
    SNR, per mel-bin row (the reference mixes the waveform-domain babble
    into the mel)."""
    t = mel_tf.shape[-2]
    if noise_bed.shape[-1] < t:
        raise ValueError(f"noise bed of {noise_bed.shape[-1]} samples is shorter than the "
                         f"{t} mel frames it is mixed into")
    seg = noise_bed[starts[..., None] + torch.arange(t, device=starts.device)]  # [..., T]
    mixed = add_noise_snr(mel_tf.transpose(-1, -2), seg, snr_db[..., None])
    return mixed.transpose(-1, -2)


def add_babble_noise(mel_tf: torch.Tensor, noise_bed: torch.Tensor,
                     generator: torch.Generator, snr_levels=SNR_LEVELS) -> torch.Tensor:
    """Mel-domain babble mixing on ``[..., T, F]``: a random segment of the
    noise bed at a random SNR level per sample."""
    *batch, t, _ = mel_tf.shape
    starts, level = draw_babble_noise(tuple(batch), t, noise_bed.shape[-1], generator,
                                      len(snr_levels))
    snr = torch.tensor(snr_levels, dtype=torch.float32, device=mel_tf.device)[level]
    return mix_noise_segments(mel_tf, noise_bed, starts, snr)


def draw_time_mask(t: int, generator: torch.Generator, window: int = 10, stride: int = 25,
                   lengths: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(starts, widths)`` of about ``t / stride`` spans of a width in
    ``[0, window)``: ``[n]`` for the whole batch, or ``[B, n]`` with
    ``lengths`` ``[B]``, where a sample of real length ``len`` gets
    ``ceil((len - 0.1) / stride)`` spans inside ``[0, len)`` and the others
    have width 0."""
    n_mask = int((t + stride - 0.1) // stride)
    if lengths is None:
        widths = _randint(generator, (n_mask,), window)
        span = torch.clamp(t - widths, min=1)
        starts = torch.floor(_rand(generator, (n_mask,)) * span).to(torch.int64)
        return starts, widths
    lengths = lengths.to(generator.device).reshape(-1)
    b = lengths.shape[0]
    widths = _randint(generator, (b, n_mask), window)
    allowed = (torch.arange(n_mask, device=lengths.device)[None, :]
               < torch.ceil((lengths[:, None] - 0.1) / stride).to(torch.int64))
    widths = torch.where(allowed & (widths < lengths[:, None]), widths, 0)
    span = torch.clamp(lengths[:, None] - widths, min=1)
    starts = torch.floor(_rand(generator, (b, n_mask)) * span).to(torch.int64)
    return starts, widths


def adaptive_time_mask(frames: torch.Tensor, generator: torch.Generator, window: int = 10,
                       stride: int = 25, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Zero random temporal spans of ``[..., T, C, H, W]``. ``lengths``
    ``[B]`` (with ``[B, T, C, H, W]`` frames): per-sample masks scaled to the
    real length of clips that were padded before augmentation."""
    t = frames.shape[-4] if frames.ndim >= 4 else frames.shape[0]
    if int((t + stride - 0.1) // stride) == 0 or t <= 1:
        return frames
    if lengths is not None and frames.ndim != 5:
        raise ValueError("lengths requires batched [B, T, C, H, W] frames")
    keep = span_keep_mask(t, *draw_time_mask(t, generator, window, stride, lengths))
    if lengths is not None:
        return frames * keep[:, :, None, None, None]
    shape = [1] * frames.ndim
    shape[frames.ndim - 4 if frames.ndim >= 4 else 0] = t
    return frames * keep.reshape(shape)


def train_audio_pipeline(mel: torch.Tensor, generator: torch.Generator,
                         noise_bed: torch.Tensor | None = None, target_length: int = 3000,
                         lengths: torch.Tensor | None = None,
                         spec_augment_kwargs: dict | None = None,
                         snr_levels=SNR_LEVELS) -> torch.Tensor:
    """Train pipeline on a batched mel ``[..., F, T]``: SpecAugment ->
    pad/trim to ``target_length`` -> (optional) babble mix -> global
    layer-norm per sample. Returns ``[..., target_length, F]``.

    ``lengths``: per-sample real frame counts when ``mel`` arrives padded,
    so time masks stay inside the real region."""
    x = mel.transpose(-1, -2)  # [..., T, F]
    x = spec_augment(x, generator, lengths=lengths, **(spec_augment_kwargs or {}))
    t = x.shape[-2]
    x = F.pad(x, (0, 0, 0, target_length - t)) if t < target_length else x[..., :target_length, :]
    if noise_bed is not None:
        x = add_babble_noise(x, noise_bed, generator, snr_levels=snr_levels)
    if x.ndim == 2:
        return global_layer_norm(x)
    return torch.vmap(global_layer_norm)(x.reshape(-1, *x.shape[-2:])).reshape(x.shape)


def packed_waveform_mel(audio: torch.Tensor, audio_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Mel ``[B, F, T]`` of a packed waveform batch ``[B, S]``
    (``augmentation.on_device_mel``), ``T`` the mask's length (3000 without
    one). The reflect tail in each row's padding makes its real frames those
    of the host STFT; frames past each row's real count (the mask's) are
    zeroed."""
    t_len = audio_mask.shape[-1] if audio_mask is not None else N_FRAMES
    mel_ft = reference_mel(audio)[..., :t_len]
    if audio_mask is None:
        return mel_ft
    lengths = audio_mask.to(torch.int64).sum(dim=-1)
    valid = torch.arange(t_len, device=audio.device)[None, :] < lengths[:, None]
    return mel_ft * valid[:, None, :]


def make_batch_augment(config, device: torch.device | str):
    """Build the on-device train augmentation ``augment(batch, generator) ->
    batch`` from the config's augmentation section (``augmentation.on_device:
    true`` mode): the host loader only decodes, computes the raw mel and
    resizes the video; SpecAugment, babble SNR mixing, global layer-norm,
    flip / ColorJitter / grayscale / time mask / ImageNet normalize run
    batched on ``device`` inside the train step.

    Expected batch layout: ``audio`` ``[B, 3000, 80]`` raw mel (no augment,
    no layer-norm), ``audio_mask`` ``[B, 3000]`` True = valid, ``video``
    ``[B, T, C, H, W]`` uint8 raw 0-255 (resized only), ``video_lengths``
    ``[B]``. With ``augmentation.on_device_mel`` ``audio`` is the ``[B,
    480200]`` packed raw waveform (``datamodule/av_dataset.py::
    pack_waveform``) and the mel is computed here by ``ops.mel.reference_mel``
    (fp32 matmuls: on the card TF32 must be off, or it raises); frames past
    each row's real count are zeroed before the augmentation.

    Distribution deviations from the host path: ColorJitter applies its ops
    in a fixed order (the host samples a permutation per clip), and video pad
    frames are zeroed again after normalization (the host pads after it; the
    visual frontend zero-fills past ``video_lengths`` either way).
    """
    from mocov2_whisper_flamingo_torch.datamodule.native import read_wav_mono
    from mocov2_whisper_flamingo_torch.ops.video import train_video_pipeline

    a_cfg = config["augmentation"]["audio"]["train"]
    v_cfg = config["augmentation"]["video"]["train"]
    spec_kwargs = dict(
        freq_mask_param=a_cfg.get("freq_mask_param", 48),
        n_freq_masks=a_cfg.get("n_freq_masks", 2),
        time_mask_ratio=a_cfg.get("time_mask_ratio", 8),
        n_time_masks=a_cfg.get("n_time_masks", 2),
    )
    snr_levels = tuple(float(x) for x in a_cfg.get("snr_levels", SNR_LEVELS))
    noise_bed = None
    noise_file = a_cfg.get("noise_file")
    if noise_file:
        try:
            bed, rate = read_wav_mono(noise_file)
        except FileNotFoundError:
            bed = None  # a missing noise file means no noise, as in the host transform
        if bed is not None:
            if rate != 16_000:
                raise ValueError(f"noise wav must be 16 kHz, got {rate}")
            noise_bed = torch.from_numpy(bed).to(device)
    jitter_cfg = v_cfg.get("color_jitter") or {}
    jitter = (jitter_cfg.get("brightness", 0.4), jitter_cfg.get("contrast", 0.4),
              jitter_cfg.get("saturation", 0.4), jitter_cfg.get("hue", 0.1))

    def augment(batch: dict, generator: torch.Generator) -> dict:
        out = dict(batch)
        if batch.get("audio") is not None:
            audio = batch["audio"]
            lengths = None
            if batch.get("audio_mask") is not None:
                lengths = batch["audio_mask"].to(torch.int64).sum(dim=-1)
            if audio.ndim == 2:
                mel_ft = packed_waveform_mel(audio, batch.get("audio_mask"))
                t_len = mel_ft.shape[-1]
            else:
                mel_ft = audio.transpose(-1, -2)  # [B, T, F] -> [B, F, T]
                t_len = audio.shape[-2]
            out["audio"] = train_audio_pipeline(
                mel_ft, generator, noise_bed=noise_bed, target_length=t_len, lengths=lengths,
                spec_augment_kwargs=spec_kwargs, snr_levels=snr_levels)
        if batch.get("video") is not None:
            out["video"] = train_video_pipeline(
                batch["video"], generator, resize=None,
                flip_prob=v_cfg.get("random_flip_prob", 0.5), jitter=jitter,
                grayscale_prob=v_cfg.get("grayscale_prob", 0.2),
                time_mask_window=v_cfg.get("time_mask_window", 10),
                time_mask_stride=v_cfg.get("time_mask_stride", 25),
                lengths=batch.get("video_lengths"))
        return out

    return augment
