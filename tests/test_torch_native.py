"""The port's native IO library (``mocov2_whisper_flamingo_torch/native/
avsr_io.cpp`` through ``datamodule/native.py``) against the JAX package's
build of the same source with the same flags (bit-equal outputs) and against
its plain numpy versions; a failed build raises, with no fallback."""

import wave

import numpy as np
import pytest

from mocov2_whisper_flamingo_torch.datamodule import native as T
from mocov2_whisper_flamingo_tpu.datamodule import native as J
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

RESAMPLE_ATOL = 1e-5  # float64 sums of 49 taps in another order, rounded to float32


def _write_wav(path, data: np.ndarray, sr: int, width: int) -> None:
    """``data`` [frames, channels] in [-1, 1] as PCM of ``width`` bytes."""
    if width == 1:
        pcm = np.clip(np.round(data * 127 + 128), 0, 255).astype(np.uint8)
    elif width == 2:
        pcm = np.clip(data * 32767, -32768, 32767).astype("<i2")
    else:
        pcm = np.clip(data * 2147483647, -2147483648, 2147483647).astype("<i4")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def test_the_port_builds_its_own_copy_of_the_library():
    assert T.load_library() is not None
    assert T.library_path().parent == T.BUILD_DIR and T.library_path().exists()
    assert T.SOURCE.name == "avsr_io.cpp" and "mocov2_whisper_flamingo_torch" in str(T.SOURCE)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_mono_matches_jax_and_the_wave_reader(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    data = rng.uniform(-0.9, 0.9, (1234, channels))
    path = str(tmp_path / "clip.wav")
    _write_wav(path, data, 22050, width)
    ours, sr = T.read_wav_mono(path)
    ref, ref_sr = J.read_wav_mono(path)
    plain, plain_sr = T.plain_read_wav_mono(path)
    assert sr == ref_sr == plain_sr == 22050 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, plain)
    assert T.wav_info(path) == J.wav_info(path) == (22050, channels, 1234)


def test_missing_and_broken_wav_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        T.read_wav_mono(str(tmp_path / "missing.wav"))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a riff file at all")
    with pytest.raises(ValueError, match="RIFF"):
        T.read_wav_mono(str(bad))


@pytest.mark.parametrize("sr_in", [8000, 44100, 48000])
def test_resample_matches_jax_bit_for_bit_and_its_plain_version(sr_in):
    rng = np.random.default_rng(sr_in)
    x = (rng.standard_normal(sr_in // 2) * 0.3).astype(np.float32)
    ours = T.resample(x, sr_in, 16000)
    assert len(ours) == -(-len(x) * 16000 // sr_in)
    np.testing.assert_array_equal(ours, J.resample(x, sr_in, 16000))
    np.testing.assert_allclose(ours, T.plain_resample(x, sr_in, 16000), atol=RESAMPLE_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(T.resample(x, 16000, 16000), x)


@pytest.mark.parametrize("seed", range(4))
def test_batch_by_size_matches_jax_and_the_python_loop(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    sizes = rng.integers(1, 400, n)
    order = rng.permutation(n)
    budget = int(rng.integers(1, 1600))
    ours = T.batch_by_size(order, sizes, budget)
    for ref in (J.batch_by_size(order, sizes, budget), T.plain_batch_by_size(order, sizes, budget)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(ours), order)
    assert T.batch_by_size(np.array([], np.int64), sizes, budget) == []


def test_dtw_matches_jax_and_the_numpy_programme():
    cost = np.random.default_rng(7).random((17, 29))
    ours = T.dtw(cost)
    for ref in (J.dtw(cost), T.plain_dtw(cost)):
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
    assert (ours[0][0], ours[1][0], ours[0][-1], ours[1][-1]) == (0, 0, 16, 28)


@pytest.fixture()
def fresh_build(tmp_path, monkeypatch):
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(T, "_lib", None)


def test_a_failed_build_raises_and_does_not_fall_back(fresh_build, tmp_path, monkeypatch):
    class Failed:
        returncode, stdout, stderr = 1, "", "avsr_io.cpp:1: error: expected declaration"

    calls = []
    monkeypatch.setattr(T.subprocess, "run", lambda cmd, **kw: calls.append(cmd) or Failed())
    with pytest.raises(RuntimeError, match="expected declaration"):
        T.read_wav_mono(str(tmp_path / "any.wav"))
    assert calls and calls[0][1:5] == ["-O3", "-fPIC", "-shared", "-std=c++17"]
    assert T._lib is None and not list((tmp_path / "torch_native").iterdir())
    with pytest.raises(RuntimeError):
        T.batch_by_size(np.arange(3), np.ones(3, np.int64), 10)


def test_a_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(T.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        T.resample(np.zeros(10, np.float32), 8000, 16000)
