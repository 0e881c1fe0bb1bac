"""AVDataset + per-sample IO (host side; counterpart of
``datamodule/av_dataset.py``).

Capability parity with the reference dataset layer (reference:
datamodule/av_dataset.py):

- same on-disk layout walk: ``{root}/{split}/{split}_video_seg12s/<folder>/
  <clip>`` paired with ``{split}_text_seg12s/<folder>/<clip>.txt``
  (reference: av_dataset.py:110-138);
- per-sample pipeline: tokenize (max_length 448) -> video decode + transform
  + pad/crop to max_frames + mask -> audio load/resample to 16 kHz +
  transform to [3000, 80] + mask + downsampled length (len/7.5 capped 400)
  (reference: av_dataset.py:157-238);
- any per-sample failure returns a zero-filled sample with correct shapes
  (the reference's crash-avoidance fault tolerance, av_dataset.py:236-238).

Video decode: ``.mp4`` is decoded IN-PROCESS via OpenCV where cv2 imports
— the host-side replacement for torchvision's libavcodec path
(reference: av_dataset.py:58-62, SURVEY.md §2.3) — with an ``ffmpeg``-CLI
fallback for containers cv2's build cannot open. Pre-decoded ``.npy``/
``.npz`` clips ([T, H, W, C] or [T, C, H, W] uint8) remain the zero-decode
fast path. Audio goes through the native C++ wav reader/resampler.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import subprocess
from typing import Any

import numpy as np

from mocov2_whisper_flamingo_torch.datamodule import native
from mocov2_whisper_flamingo_torch.ops.mel import hann_window, mel_filter_bank

logger = logging.getLogger(__name__)
_NO_TURN = contextlib.nullcontext()

VIDEO_EXTENSIONS = (".npy", ".npz", ".mp4")


# ---------------------------------------------------------------------------
# Video readers
# ---------------------------------------------------------------------------


def _read_npy_video(path: str) -> np.ndarray:
    arr = np.load(path) if path.endswith(".npy") else np.load(path)["frames"]
    if arr.ndim != 4:
        raise ValueError(f"video array must be 4D, got {arr.shape}")
    if arr.shape[-1] in (1, 3):  # THWC -> TCHW
        arr = arr.transpose(0, 3, 1, 2)
    return arr


def _ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def _read_mp4_video_cv2(path: str) -> np.ndarray:
    """In-process mp4 decode via OpenCV (libavcodec under the hood)."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("cv2 not available")
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise RuntimeError(f"cv2 could not open {path}")
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1])  # BGR -> RGB
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"cv2 decoded zero frames from {path}")
    return np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))


def _read_mp4_video(path: str, fps: int | None = None) -> np.ndarray:
    """Decode via the ffmpeg CLI into raw rgb24 (requires the binary)."""
    if not _ffmpeg_available():
        raise RuntimeError("ffmpeg binary not available for mp4 decode")
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True)
    w, h = (int(v) for v in probe.stdout.strip().split(","))
    cmd = ["ffmpeg", "-v", "error", "-i", path]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    frames = np.frombuffer(raw, dtype=np.uint8).reshape(-1, h, w, 3)
    return frames.transpose(0, 3, 1, 2)


def read_video(path: str) -> np.ndarray:
    """[T, C, H, W] uint8 frames."""
    if path.endswith((".npy", ".npz")):
        return _read_npy_video(path)
    if path.endswith(".mp4"):
        try:
            return _read_mp4_video_cv2(path)
        except RuntimeError as e:
            logger.debug("cv2 decode unavailable for %s (%s); trying ffmpeg CLI",
                         path, e)
        return _read_mp4_video(path)
    raise ValueError(f"unsupported video format: {path}")


def probe_video_frames(path: str, default: int = 0) -> int:
    """Frame count without a full decode (the bucketing sampler probes every
    clip at startup, reference: data_module.py:28-32)."""
    try:
        if path.endswith(".npy"):
            # a memory map reads the header only (the JAX package's private
            # numpy.lib.format._read_array_header is gone from newer numpy)
            return int(np.load(path, mmap_mode="r").shape[0])
        if path.endswith(".npz"):
            return int(_read_npy_video(path).shape[0])
        if path.endswith(".mp4") and _cv2() is not None:
            cv2 = _cv2()
            cap = cv2.VideoCapture(path)
            try:
                if cap.isOpened():
                    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                    if n > 0:
                        return n
            finally:
                cap.release()
        if path.endswith(".mp4") and _ffmpeg_available():
            out = subprocess.run(
                ["ffprobe", "-v", "error", "-select_streams", "v:0",
                 "-count_packets", "-show_entries", "stream=nb_read_packets",
                 "-of", "csv=p=0", path],
                capture_output=True, text=True, check=True)
            return int(out.stdout.strip())
    except Exception as e:
        logger.warning("frame probe failed for %s: %s", path, e)
    return default


# ---------------------------------------------------------------------------
# Whisper-parity mel in numpy (for process_audio_whisper)
# ---------------------------------------------------------------------------


def np_whisper_log_mel(wave: np.ndarray, pad_to: int = 480_000,
                       n_fft: int = 400, hop: int = 160, n_mels: int = 80) -> np.ndarray:
    """HF WhisperFeatureExtractor-parity log-mel, [80, 3000]."""
    x = wave.astype(np.float32)
    x = np.pad(x, (0, max(pad_to - len(x), 0)))[:pad_to]
    pad = n_fft // 2
    x = np.pad(x, pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * hann_window(n_fft)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    power = power[:-1]  # whisper drops the final frame
    fb = mel_filter_bank(n_fft // 2 + 1, n_mels, mel_scale="slaney", norm="slaney")
    mel = power @ fb
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).T.astype(np.float32)


# 30 s of 16 kHz audio plus one n_fft//2 continuation slot: the extra 200
# samples guarantee the reflect tail always fits, so EVERY in-mask mel
# frame of the packed buffer is bit-matched to the host STFT (without them,
# clips within 200 samples of 30 s would lose the tail to the buffer end).
PACKED_WAVE_LEN = 480_000 + 200


def pack_waveform(wave: np.ndarray, n_samples: int = PACKED_WAVE_LEN,
                  hop: int = 160, n_fft: int = 400, max_frames: int = 3000
                  ) -> tuple[np.ndarray, int]:
    """Pack a raw waveform for on-device mel (``augmentation.on_device_mel``):
    trim/zero-pad to ``n_samples`` (30 s + an ``n_fft//2`` continuation
    slot) and write the ``n_fft//2``-sample REFLECT tail of the real signal
    into the padding.

    With the tail in place, every centered-STFT frame of the padded buffer
    whose index is < the real frame count sees exactly the samples the
    host's unpadded reflect-padded STFT (``np_reference_mel``) would see —
    so ``ops.mel.reference_mel`` on the device reproduces the host mel
    bit-near over the entire real region, for any input length (frames past
    it are masked to zero by the batched augment). Returns
    ``(buffer [n_samples] f32, real mel frames)``.
    """
    wave = np.asarray(wave, dtype=np.float32)
    length = min(len(wave), n_samples)
    # Frame count the reference pipeline would produce from the 30 s trim.
    t_real = min(1 + min(length, n_samples - n_fft // 2) // hop, max_frames)
    buf = np.zeros(n_samples, np.float32)
    buf[:length] = wave[:length]
    if length < n_samples and length >= 2:
        tail = min(n_fft // 2, n_samples - length, length - 1)
        # np.pad(..., mode="reflect") end continuation: x[L-2], x[L-3], ...
        buf[length:length + tail] = wave[:length][::-1][1:1 + tail]
    return buf, t_real


# ---------------------------------------------------------------------------
# DataProcessor
# ---------------------------------------------------------------------------


class DataProcessor:
    """Per-sample IO (reference: av_dataset.py:12-84) without the
    heavyweight quirk of loading a full WhisperModel per dataset instance
    (av_dataset.py:17-24 — the model was never used)."""

    SAMPLE_RATE = 16_000
    # Reference declares both 30 (av_dataset.py:28-29), making its
    # load_video frame-rate resample a no-op (quirk Q5) — kept configurable.
    N_FRAMES = 30
    FRAME_RATE = 30

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer

    def process_audio_whisper(self, waveform: np.ndarray) -> np.ndarray:
        """Peak-normalize then Whisper log-mel [80, 3000]
        (reference: av_dataset.py:33-55)."""
        waveform = np.asarray(waveform, dtype=np.float32)
        peak = np.abs(waveform).max()
        if peak > 0:
            waveform = waveform / peak
        return np_whisper_log_mel(waveform)

    def load_video(self, path: str, max_frames: int = 300) -> np.ndarray:
        vid = read_video(path)  # [T, C, H, W]
        target = int(vid.shape[0] * self.FRAME_RATE / self.N_FRAMES)
        if target != vid.shape[0] and target > 0:
            idx = np.linspace(0, vid.shape[0] - 1, target).astype(np.int64)
            vid = vid[idx]
        return vid[:max_frames]

    def load_audio(self, video_path: str) -> np.ndarray:
        """Sibling .wav next to the clip (reference: av_dataset.py:75-84),
        resampled to 16 kHz through the native resampler."""
        audio_path = os.path.splitext(video_path)[0] + ".wav"
        wave_data, sr = native.read_wav_mono(audio_path)
        if sr != self.SAMPLE_RATE:
            wave_data = native.resample(wave_data, sr, self.SAMPLE_RATE)
        return wave_data


# ---------------------------------------------------------------------------
# AVDataset
# ---------------------------------------------------------------------------


class AVDataset:
    def __init__(
        self,
        root_dir: str,
        split: str,
        modality: str,
        audio_transform,
        video_transform,
        rate_ratio: int = 640,
        max_frames: int = 300,
        tokenizer=None,
        frame_size: int = 96,
        seed: int = 0,
    ):
        self.root_dir = root_dir
        self.split = split
        self.modality = modality
        self.rate_ratio = rate_ratio
        self.max_frames = max_frames
        self.frame_size = frame_size
        self.processor = DataProcessor(tokenizer)
        self.tokenizer = tokenizer
        self.audio_transform = audio_transform
        self.video_transform = video_transform
        self._rng = np.random.default_rng(seed)
        self._target_lengths: dict[int, int] = {}

        self.video_dir = os.path.join(root_dir, split, f"{split}_video_seg12s")
        self.text_dir = os.path.join(root_dir, split, f"{split}_text_seg12s")
        self.samples = self._build_dataset()

    def _build_dataset(self) -> list[dict]:
        samples: list[dict] = []
        if not (os.path.isdir(self.text_dir) and os.path.isdir(self.video_dir)):
            return samples
        for folder in sorted(os.listdir(self.text_dir)):
            tdir = os.path.join(self.text_dir, folder)
            vdir = os.path.join(self.video_dir, folder)
            if not (os.path.isdir(tdir) and os.path.isdir(vdir)):
                continue
            videos = {os.path.splitext(f)[0]: f for f in os.listdir(vdir)
                      if f.endswith(VIDEO_EXTENSIONS)}
            for tf in sorted(os.listdir(tdir)):
                if not tf.endswith(".txt"):
                    continue
                base = tf[:-4]
                if base in videos:
                    with open(os.path.join(tdir, tf), encoding="utf-8") as f:
                        text = f.read().strip()
                    samples.append({
                        "video_path": os.path.join(vdir, videos[base]),
                        "text": text,
                    })
        return samples

    def target_length(self, idx: int) -> int:
        """The length of sample ``idx``'s token ids, as ``fetch`` encodes
        them (kept after the first call)."""
        if idx not in self._target_lengths:
            text = self.samples[idx]["text"]
            self._target_lengths[idx] = (
                len(self.tokenizer.encode(text, max_length=448, truncation=True))
                if self.tokenizer else 1)
        return self._target_lengths[idx]

    def probe_num_frames(self, idx: int) -> int:
        return min(probe_video_frames(self.samples[idx]["video_path"],
                                      default=self.max_frames), self.max_frames)

    def _get_empty_sample(self) -> dict:
        """Zero sample with correct shapes — per-sample fault tolerance
        (reference: av_dataset.py:140-155). Keys and shapes/dtypes follow
        the active modality and the transforms' emission mode so a failed
        sample still collates into the same static batch layout (uint8 raw
        frames in on-device mode, packed waveform in on-device-mel mode;
        only the keys real samples carry, or collate's key probe breaks)."""
        out = {
            "target_ids": np.zeros(1, np.int64),
            "target_text": "",
            "target_lengths": np.int32(1),
        }
        if self.modality in ("video", "audiovisual"):
            video_on_device = bool(getattr(self.video_transform, "on_device",
                                           False))
            # train-path frames are resized to the transform's target size
            # (the val path keeps the source resolution, reference quirk) —
            # the empty sample must match or one failed sample breaks the
            # collate.
            if (video_on_device
                    or getattr(self.video_transform, "subset", None) == "train"):
                v_size = getattr(self.video_transform, "resize", self.frame_size)
            else:
                v_size = self.frame_size
            out["video"] = np.zeros(
                (self.max_frames, 3, v_size, v_size),
                np.uint8 if video_on_device else np.float32)
            out["video_mask"] = np.zeros(self.max_frames, bool)
            out["video_lengths"] = np.int32(0)
        if self.modality in ("audio", "audiovisual"):
            if getattr(self.audio_transform, "emits_waveform", False):
                out["audio"] = np.zeros(PACKED_WAVE_LEN, np.float32)
            else:
                out["audio"] = np.zeros((3000, 80), np.float32)
            out["audio_mask"] = np.zeros(3000, bool)
            out["audio_lengths"] = np.int32(0)
        return out

    @property
    def draws(self) -> bool:
        """Whether a sample draws from the dataset's shared generator (the
        host train transforms, noise mixing)."""
        video = self.modality in ("video", "audiovisual") and self.video_transform.draws
        audio = self.modality in ("audio", "audiovisual") and self.audio_transform.draws
        return bool(video or audio)

    def __getitem__(self, idx: int) -> dict:
        return self.fetch(idx)

    def fetch(self, idx: int, turn=None) -> dict:
        """Sample ``idx``. ``turn``: a context manager (``DrawOrder``'s
        ``Turn``) entered before the sample's first draw from the shared
        generator and left after its last, so that samples fetched by several
        threads take their draws in the order they were submitted; the
        video decode before it runs in parallel. A failed sample still takes
        and leaves its turn."""
        turn = turn if turn is not None else _NO_TURN
        try:
            sample = self.samples[idx]
            text = sample["text"]
            ids = np.asarray(
                self.tokenizer.encode(text, max_length=448, truncation=True)
                if self.tokenizer else [0], dtype=np.int64)

            out: dict[str, Any] = {
                "target_ids": ids,
                "target_text": text,
                "target_lengths": np.int32(len(ids)),
            }
            video = None
            if self.modality in ("video", "audiovisual"):
                video = self.processor.load_video(sample["video_path"], self.max_frames)
            with turn:
                return self._transform(sample, out, video)
        except Exception as e:
            logger.error("error processing sample %d: %s", idx, e)
            if not getattr(turn, "taken", True):
                with turn:
                    pass
            return self._get_empty_sample()

    def _transform(self, sample: dict, out: dict, video: np.ndarray | None) -> dict:
        """The transforms and the audio read: every draw of a sample."""
        if video is not None:
            video = self.video_transform(video, rng=self._rng)
            t = video.shape[0]
            if t < self.max_frames:
                pad = np.zeros((self.max_frames - t, *video.shape[1:]), video.dtype)
                video = np.concatenate([video, pad], axis=0)
            mask = np.zeros(self.max_frames, bool)
            mask[: min(t, self.max_frames)] = True
            out["video"] = video[: self.max_frames]
            out["video_mask"] = mask
            out["video_lengths"] = np.int32(min(t, self.max_frames))

        if self.modality in ("audio", "audiovisual"):
            wave_data = self.processor.load_audio(sample["video_path"])
            feat = self.audio_transform(wave_data, rng=self._rng)
            if feat.ndim == 1:
                # on-device-mel mode: ship the packed raw waveform; the
                # train step computes the mel on the card
                # (ops.augment.make_batch_augment waveform branch).
                buf, t_real = pack_waveform(feat)
                mask = np.zeros(3000, bool)
                mask[:t_real] = True
                out["audio"] = buf
                out["audio_mask"] = mask
                out["audio_lengths"] = np.int32(min(int(t_real / 7.5), 400))
                return out
            mel = feat  # [T, 80]
            audio_length = mel.shape[0]
            target_len = 3000
            if audio_length > target_len:
                mel = mel[:target_len]
            elif audio_length < target_len:
                mel = np.pad(mel, ((0, target_len - audio_length), (0, 0)))
            mask = np.zeros(target_len, bool)
            mask[: min(audio_length, target_len)] = True
            # Whisper's conv stem halves 3000 -> 1500; the fused stream is
            # capped at 400 frames; the reference expresses this as
            # len/7.5 capped 400 (av_dataset.py:226-232).
            out["audio"] = mel
            out["audio_mask"] = mask
            out["audio_lengths"] = np.int32(min(int(audio_length / 7.5), 400))

        return out

    def __len__(self) -> int:
        return len(self.samples)
