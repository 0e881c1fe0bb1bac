"""The port's log-mel front end (``ops/mel.py``) against the JAX package's on
the CPU, on the same waveforms made from a seed with numpy.

Tolerances (fp32 on both sides; the JAX side runs its matmuls at
``Precision.HIGHEST``): the window and the filter banks come from the same
numpy code and are equal; the power spectrum sums 400 products per bin in
another order, so it is held to a relative 1e-4 of each example's largest
bin; the log-mel is ``log10`` of such sums divided by 4, held to 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import mel as tmel
from mocov2_whisper_flamingo_tpu.ops import mel as jmel

POWER_RTOL = 1e-4
LOG_MEL_ATOL = 2e-4


def _wave(shape, seed=0, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n,periodic", [(400, True), (400, False), (7, True)])
def test_hann_window(n, periodic):
    np.testing.assert_array_equal(tmel.hann_window(n, periodic), jmel.hann_window(n, periodic))


@pytest.mark.parametrize("kwargs", [dict(mel_scale="slaney", norm="slaney"),
                                    dict(mel_scale="htk", norm=None),
                                    dict(n_mels=40, mel_scale="htk", norm=None, f_min=20.0,
                                         f_max=7600.0)])
def test_mel_filter_bank(kwargs):
    ours = tmel.mel_filter_bank(**kwargs)
    np.testing.assert_array_equal(ours, jmel.mel_filter_bank(**kwargs))
    assert ours.dtype == np.float32 and not ours.flags.writeable


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("shape", [(4000,), (2, 3217)])
def test_power_spectrogram(method, shape):
    wav = _wave(shape)
    ours = tmel.power_spectrogram(torch.from_numpy(wav), method=method).numpy()
    ref = np.asarray(jmel.power_spectrogram(jnp.asarray(wav), method=method))
    assert ours.shape == ref.shape == shape[:-1] + (1 + shape[-1] // 160, 201)
    peak = ref.reshape(*shape[:-1], -1).max(axis=-1)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=POWER_RTOL * float(peak.max()))
    assert np.abs(ours - ref).max() <= POWER_RTOL * float(peak.min())


def test_power_spectrogram_uncentered_and_bad_method():
    wav = _wave((1600,))
    ours = tmel.power_spectrogram(torch.from_numpy(wav), center=False, method="matmul").numpy()
    ref = np.asarray(jmel.power_spectrogram(jnp.asarray(wav), center=False, method="matmul"))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=POWER_RTOL * float(ref.max()))
    with pytest.raises(ValueError, match="unknown method"):
        tmel.power_spectrogram(torch.from_numpy(wav), method="dct")


@pytest.mark.parametrize("name,wav,pad_to", [
    ("one_dim", _wave((4800,), 1), None),
    ("batched", _wave((3, 4800), 2), None),
    ("padded", _wave((2, 3000), 3), 8000),
    ("trimmed", _wave((2, 9000), 4), 8000),
    ("odd_length", _wave((5003,), 5), None),
    ("silence", np.zeros((2, 3200), np.float32), None),
    ("loud_and_quiet_rows", np.stack([_wave((4000,), 6, 1.0), _wave((4000,), 7, 1e-4)]), None),
])
def test_whisper_log_mel(name, wav, pad_to):
    ours = tmel.whisper_log_mel(torch.from_numpy(wav), pad_to=pad_to).numpy()
    ref = np.asarray(jmel.whisper_log_mel(jnp.asarray(wav), pad_to=pad_to))
    n = pad_to or wav.shape[-1]
    assert ours.shape == ref.shape == wav.shape[:-1] + (80, n // 160)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LOG_MEL_ATOL)


def test_whisper_log_mel_fft_method_and_alias():
    wav = _wave((2, 4800), 8)
    ours = tmel.log_mel_spectrogram(torch.from_numpy(wav), method="fft").numpy()
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), method="fft"))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LOG_MEL_ATOL)


@pytest.mark.parametrize("shape", [(4000,), (2, 3217)])
def test_reference_mel(shape):
    wav = _wave(shape, 9)
    ours = tmel.reference_mel(torch.from_numpy(wav)).numpy()
    ref = np.asarray(jmel.reference_mel(jnp.asarray(wav)))
    assert ours.shape == ref.shape == shape[:-1] + (80, 1 + shape[-1] // 160)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=POWER_RTOL * float(ref.max()))


@pytest.mark.parametrize("t,target", [(20, 30), (40, 30), (30, 30)])
def test_pad_or_trim_mel(t, target):
    mel = _wave((2, 80, t), 10)
    ours = tmel.pad_or_trim_mel(torch.from_numpy(mel), target).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jmel.pad_or_trim_mel(jnp.asarray(mel), target)))


def test_tf32_is_refused_only_on_the_card(monkeypatch):
    """The fp32 check looks at CUDA tensors only; on the CPU a caller's TF32
    switch changes nothing and is not an error."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    out = tmel.whisper_log_mel(torch.from_numpy(_wave((1600,))))
    assert out.shape == (80, 10)

    class OnCard:  # stands in for a CUDA tensor
        is_cuda = True

    with pytest.raises(RuntimeError, match="TF32"):
        tmel._require_fp32_matmul(OnCard())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    tmel._require_fp32_matmul(OnCard())
