"""ctypes bindings for the port's native IO library (``native/avsr_io.cpp``,
counterpart of the JAX package's ``datamodule/native.py``).

The library reads WAV files and downmixes them to mono, resamples with a
polyphase Kaiser-windowed sinc, packs batches with fairseq ``batch_by_size``
semantics and runs the monotonic DTW of word alignment. It is built with
``g++`` on first use into ``build/torch_native/`` at the root of the checkout,
named by a hash of the source and the flags, through a temporary file and
``os.replace`` (test workers that race to build each write their own file).

There is no fallback: when ``g++`` is missing or the build fails, the first
call raises. The JAX package's bindings fall back to numpy instead, and their
FFT resample computes another function than the windowed sinc. The numpy
functions below (``plain_*``) are the plain versions of each export, kept to
test the library against: the ``wave``-module reader, the Python packer
loop, a numpy loop of the same windowed-sinc filter and the numpy DTW.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import wave
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "avsr_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "avsr_wav_info": ([ctypes.c_char_p, _c_int_p, _c_int_p, _c_long_p], ctypes.c_int),
    "avsr_wav_read_mono_f32": ([ctypes.c_char_p, _c_float_p, ctypes.c_long], ctypes.c_long),
    "avsr_resample_f32": ([_c_float_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, _c_float_p,
                           ctypes.c_long], ctypes.c_long),
    "avsr_batch_by_size": ([_c_int64_p, _c_int64_p, ctypes.c_long, ctypes.c_long, _c_int64_p,
                            _c_int64_p], ctypes.c_long),
    "avsr_dtw": ([_c_double_p, ctypes.c_long, ctypes.c_long, _c_int64_p, _c_int64_p],
                 ctypes.c_long),
}


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native IO library (WAV reader, resampler, batch "
                           "packer) cannot be built, and the data pipeline has no fallback")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libavsr_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path and
    raises with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_gxx(), *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native IO library build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


# -- WAV ---------------------------------------------------------------------------------


def wav_info(path: str) -> tuple[int, int, int]:
    """``(sample_rate, channels, frames)`` of a WAV file."""
    sr, ch, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    rc = load_library().avsr_wav_info(os.fsencode(path), ctypes.byref(sr), ctypes.byref(ch),
                                      ctypes.byref(fr))
    if rc == -1:
        raise FileNotFoundError(f"cannot open {path}")
    if rc != 0:
        raise ValueError(f"{path} is not a RIFF/WAVE file with fmt and data chunks")
    return sr.value, ch.value, fr.value


def read_wav_mono(path: str) -> tuple[np.ndarray, int]:
    """Mono float32 waveform in [-1, 1] (the channels averaged) and its
    sample rate. PCM of 8, 16, 24 or 32 bits, or 32-bit IEEE float."""
    sr, _, frames = wav_info(path)
    out = np.empty(frames, dtype=np.float32)
    got = load_library().avsr_wav_read_mono_f32(os.fsencode(path), _ptr(out, ctypes.c_float),
                                                frames)
    if got < 0:
        raise ValueError(f"cannot read the samples of {path} (error {got})")
    return out[:got], sr


def plain_read_wav_mono(path: str) -> tuple[np.ndarray, int]:
    """The plain version of ``read_wav_mono`` through the ``wave`` module
    (PCM of 8, 16 or 32 bits), with the library's float64 downmix."""
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
        width, channels, rate = w.getsampwidth(), w.getnchannels(), w.getframerate()
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    return (data.reshape(-1, channels).sum(axis=1) * (1.0 / channels)).astype(np.float32), rate


# -- Resample ------------------------------------------------------------------------------


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase Kaiser-windowed-sinc resample of ``x`` from ``sr_in`` to
    ``sr_out`` (float32)."""
    if sr_in == sr_out:
        return x.astype(np.float32, copy=False)
    xin = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(int(math.ceil(len(x) * sr_out / sr_in)) + 8, dtype=np.float32)
    got = load_library().avsr_resample_f32(_ptr(xin, ctypes.c_float), len(xin), sr_in, sr_out,
                                           _ptr(out, ctypes.c_float), len(out))
    if got < 0:
        raise ValueError(f"cannot resample from {sr_in} Hz to {sr_out} Hz")
    return out[:got]


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    total, term = np.ones_like(x), np.ones_like(x)
    for k in range(1, 64):
        term = term * (x / (2.0 * k)) * (x / (2.0 * k))
        total = total + term
        if np.all(term < 1e-16 * total):
            break
    return total


def plain_resample(x: np.ndarray, sr_in: int, sr_out: int, zeros: int = 24,
                   beta: float = 14.769656459379492) -> np.ndarray:
    """The plain version of ``resample``: the same filter bank (cutoff 0.99
    of the lower Nyquist, ``zeros`` input samples each side, Kaiser window of
    ``beta``), applied in float64 with numpy."""
    if sr_in == sr_out:
        return x.astype(np.float32, copy=False)
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    cutoff = 0.99 * 0.5 * (1.0 if sr_in < sr_out else sr_out / sr_in)
    t = (np.arange(2 * zeros + 1)[None, :] - zeros) - np.arange(up)[:, None] / up
    arg = 2.0 * cutoff * t
    sinc = np.where(arg == 0.0, 1.0, np.sin(np.pi * arg) / np.where(arg == 0.0, 1.0, np.pi * arg))
    w_arg = t / zeros
    inside = (w_arg > -1.0) & (w_arg < 1.0)
    window = np.where(inside, _bessel_i0(beta * np.sqrt(np.where(inside, 1.0 - w_arg ** 2, 0.0)))
                      / _bessel_i0(np.array(beta)), 0.0)
    filt = 2.0 * cutoff * sinc * window  # [up, taps]
    n_in = len(x)
    num = np.arange((n_in * up + down - 1) // down) * down
    idx = (num // up)[:, None] + np.arange(2 * zeros + 1)[None, :] - zeros
    valid = (idx >= 0) & (idx < n_in)
    samples = np.where(valid, np.asarray(x, np.float64)[np.clip(idx, 0, max(n_in - 1, 0))], 0.0)
    return (filt[num % up] * samples).sum(axis=1).astype(np.float32)


# -- Batch packing (fairseq batch_by_size semantics) ---------------------------------------


def batch_by_size(indices: np.ndarray, sizes: np.ndarray, max_tokens: int) -> list[np.ndarray]:
    """Greedy packing of the ordered ``indices``: consecutive indices form a
    batch while ``len(batch) * max(size) <= max_tokens``; an index alone is
    always a batch."""
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    n = len(indices)
    if n == 0:
        return []
    flat = np.empty(n, dtype=np.int64)
    offsets = np.empty(n + 1, dtype=np.int64)
    n_batches = load_library().avsr_batch_by_size(
        _ptr(indices, ctypes.c_int64), _ptr(sizes, ctypes.c_int64), n, int(max_tokens),
        _ptr(flat, ctypes.c_int64), _ptr(offsets, ctypes.c_int64))
    if n_batches < 0:
        raise ValueError(f"batch_by_size refused max_tokens={max_tokens}")
    return [flat[offsets[i]:offsets[i + 1]] for i in range(n_batches)]


def plain_batch_by_size(indices: np.ndarray, sizes: np.ndarray,
                        max_tokens: int) -> list[np.ndarray]:
    """The plain version of ``batch_by_size``: the same greedy loop in Python."""
    indices = np.asarray(indices, dtype=np.int64)
    if len(indices) == 0:
        return []
    batches: list[np.ndarray] = []
    start, batch_max = 0, 0
    for i, idx in enumerate(indices):
        sz = int(sizes[idx])
        new_max = max(batch_max, sz)
        if i > start and (i - start + 1) * new_max > max_tokens:
            batches.append(indices[start:i])
            start, batch_max = i, sz
        else:
            batch_max = new_max
    batches.append(indices[start:])
    return batches


# -- Monotonic DTW ---------------------------------------------------------------------------


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over an ``[n, m]`` cost matrix: moves (i-1, j-1), (i-1,
    j), (i, j-1), ties to the diagonal; the path from (0, 0) to (n-1, m-1) as
    ``(text indices, time indices)``."""
    c = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = c.shape
    out_text = np.empty(n + m, dtype=np.int64)
    out_time = np.empty(n + m, dtype=np.int64)
    length = load_library().avsr_dtw(_ptr(c, ctypes.c_double), n, m,
                                     _ptr(out_text, ctypes.c_int64),
                                     _ptr(out_time, ctypes.c_int64))
    if length < 0:
        raise ValueError(f"dtw needs a non-empty cost matrix, got {c.shape}")
    return out_text[:length], out_time[:length]


def plain_dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of ``dtw``: the same dynamic programme in Python."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            best, t = acc[i - 1, j - 1], 0
            if acc[i - 1, j] < best:
                best, t = acc[i - 1, j], 1
            if acc[i, j - 1] < best:
                best, t = acc[i, j - 1], 2
            acc[i, j] = cost[i - 1, j - 1] + best
            trace[i, j] = t
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if i > 0 and j > 0 and t == 0:
            i, j = i - 1, j - 1
        elif i > 0 and (j == 0 or t == 1):
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1], np.int64), np.array(time_idx[::-1], np.int64)
