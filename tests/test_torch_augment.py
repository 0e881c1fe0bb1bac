"""The port's on-device augmentation on the CPU: the deterministic parts
against the JAX package on the same numpy inputs (and on draws made by the
JAX functions' own key splits), the drawing parts against their stated
ranges."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import augment as TA
from mocov2_whisper_flamingo_torch.ops import mel as TM
from mocov2_whisper_flamingo_torch.ops import video as TV
from mocov2_whisper_flamingo_tpu.ops import augment as JA
from mocov2_whisper_flamingo_tpu.ops import mel as JM
from mocov2_whisper_flamingo_tpu.ops import video as JV

ATOL = 1e-5  # fp32 elementwise chains


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# -- deterministic parts against JAX ---------------------------------------------------


def test_global_layer_norm_matches_jax(rng):
    x = (rng.standard_normal((50, 80)) * 3 + 2).astype(np.float32)
    _close(TM.global_layer_norm(torch.from_numpy(x)), JM.global_layer_norm(jnp.asarray(x)))


@pytest.mark.parametrize("snr", [-5.0, 10.0, 999999.0])
def test_add_noise_snr_matches_jax(rng, snr):
    signal = rng.standard_normal((3, 8, 40)).astype(np.float32)
    signal[1, 2] = 0.0  # a silent row: the energy floor
    noise = rng.standard_normal((3, 40)).astype(np.float32)
    ours = TA.add_noise_snr(torch.from_numpy(signal), torch.from_numpy(noise), snr)
    _close(ours, JA.add_noise_snr(jnp.asarray(signal), jnp.asarray(noise), snr))
    if snr < 100:  # the mix has the SNR asked for
        added = ours.numpy() - signal
        got = 10 * np.log10((signal[0] ** 2).sum(-1) / (added[0] ** 2).sum(-1))
        np.testing.assert_allclose(got, snr, atol=1e-3)


@pytest.mark.parametrize("keep_channels", [True, False])
def test_grayscale_matches_jax(rng, keep_channels):
    x = rng.random((2, 3, 3, 8, 8)).astype(np.float32)
    _close(TV.rgb_to_grayscale(torch.from_numpy(x), keep_channels),
           JV.rgb_to_grayscale(jnp.asarray(x), keep_channels))


def test_hsv_round_trip_and_jax_parity(rng):
    x = rng.random((2, 3, 3, 8, 8)).astype(np.float32)
    x[0, 0, :, 0, 0] = 0.5   # a grey pixel: delta 0
    x[0, 0, :, 0, 1] = 0.0   # black: max 0
    hsv = TV._rgb_to_hsv(torch.from_numpy(x))
    _close(hsv, JV._rgb_to_hsv(jnp.asarray(x)))
    back = TV._hsv_to_rgb(hsv)
    _close(back, JV._hsv_to_rgb(jnp.asarray(hsv.numpy())))
    _close(back, x)


def test_color_jitter_with_factors_matches_jax(rng):
    x = rng.random((3, 4, 3, 8, 8)).astype(np.float32)
    factors = [np.array(v, np.float32) for v in ([0.7, 1.0, 1.4], [1.3, 0.6, 1.0],
                                                 [0.6, 1.4, 1.0], [-0.1, 0.07, 0.0])]
    ours = TV.color_jitter_with_factors(torch.from_numpy(x),
                                        *(torch.from_numpy(f) for f in factors))
    _close(ours, JV.color_jitter_with_factors(jnp.asarray(x), *(jnp.asarray(f) for f in factors)))
    assert float(ours.min()) >= 0.0 and float(ours.max()) <= 1.0


@pytest.mark.parametrize("with_lengths", [False, True])
def test_spec_augment_on_the_jax_draws(with_lengths):
    """The JAX function's own draws (its key splits, made again here) through
    the port's deterministic part give the JAX function's output."""
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((3, 64, 80)).astype(np.float32)
    lengths = np.array([64, 40, 9], np.int32) if with_lengths else None
    key = jax.random.PRNGKey(4)
    ref = JA.spec_augment(jnp.asarray(mel), key,
                          lengths=None if lengths is None else jnp.asarray(lengths))
    kf, kt = jax.random.split(key)
    draws = {"freq_starts": torch.from_numpy(np.array(jax.random.randint(kf, (3, 2), 0, 80 - 48))),
             "freq_width": 48}
    if with_lengths:
        width = (lengths // 8)[:, None]
        u = np.asarray(jax.random.uniform(kt, (3, 2)))
        span = np.maximum(lengths[:, None] - width, 0)
        draws["time_starts"] = torch.from_numpy(np.floor(u * span).astype(np.int64))
        draws["time_width"] = torch.from_numpy(width.astype(np.int64))
    else:
        draws["time_starts"] = torch.from_numpy(np.array(jax.random.randint(kt, (3, 2), 0, 64 - 8)))
        draws["time_width"] = 8
    _close(TA.apply_spec_augment(torch.from_numpy(mel), draws), ref, atol=0)


def test_mix_noise_segments_matches_jax_add_babble_noise():
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((3, 30, 8)).astype(np.float32)
    bed = rng.standard_normal((200,)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = JA.add_babble_noise(jnp.asarray(mel), jnp.asarray(bed), key)
    k_start, k_snr = jax.random.split(key)
    starts = np.array(jax.random.randint(k_start, (3,), 0, 200 - 30))
    level = np.array(jax.random.randint(k_snr, (3,), 0, len(JA.SNR_LEVELS)))
    snr = torch.tensor(TA.SNR_LEVELS)[torch.from_numpy(level)]
    ours = TA.mix_noise_segments(torch.from_numpy(mel), torch.from_numpy(bed),
                                 torch.from_numpy(starts), snr)
    _close(ours, ref)
    with pytest.raises(ValueError, match="shorter"):
        TA.mix_noise_segments(torch.from_numpy(mel), torch.from_numpy(bed[:10]),
                              torch.from_numpy(starts), snr)


# -- drawing parts against their ranges -------------------------------------------------


def test_spec_augment_draw_ranges():
    draws = TA.draw_spec_augment((500,), 400, 80, _gen())
    assert draws["freq_width"] == 48 and draws["time_width"] == 50
    fs, ts = draws["freq_starts"], draws["time_starts"]
    assert fs.shape == ts.shape == (500, 2)
    assert int(fs.min()) >= 0 and int(fs.max()) < 80 - 48 and len(fs.unique()) > 20
    assert int(ts.min()) >= 0 and int(ts.max()) < 400 - 50
    # an axis too short for its mask gets none
    short = TA.draw_spec_augment((4,), 6, 40, _gen())
    assert short["freq_starts"] is None and short["time_starts"] is None
    x = torch.ones((4, 6, 40))
    assert torch.equal(TA.apply_spec_augment(x, short), x)


def test_spec_augment_masks_stay_inside_the_real_length():
    lengths = torch.tensor([400, 200, 37, 5])
    x = torch.ones((4, 400, 80))
    for seed in range(20):
        out = TA.spec_augment(x, _gen(seed), lengths=lengths)
        time_rows = out[:, :, :].amax(dim=2) == 0  # [B, T]: a wholly masked frame
        for b, n in enumerate(lengths.tolist()):
            assert not bool(time_rows[b, n:].any())  # padding absorbs no mask
            width = n // 8
            assert int(time_rows[b].sum()) <= 2 * width
            if width:
                assert int(time_rows[b].sum()) >= width
        freq_cols = out.amax(dim=1) == 0  # [B, F]
        assert bool(((freq_cols.sum(dim=1) >= 48) & (freq_cols.sum(dim=1) <= 96)).all())


def test_span_keep_mask():
    keep = TA.span_keep_mask(10, torch.tensor([[1, 6], [0, 0]]), torch.tensor([[2, 0], [3, 1]]))
    assert keep.tolist() == [[True, False, False] + [True] * 7, [False] * 3 + [True] * 7]
    assert TA.span_keep_mask(5, torch.tensor([3]), 4).tolist() == [True, True, True, False, False]


def test_time_mask_draw_ranges():
    starts, widths = TA.draw_time_mask(400, _gen(), window=10, stride=25)
    assert starts.shape == widths.shape == (16,)  # (400 + 24.9) // 25
    assert int(widths.min()) >= 0 and int(widths.max()) < 10
    assert bool((starts >= 0).all()) and bool((starts + widths <= 400).all())
    lengths = torch.tensor([400, 100, 26, 3])
    for seed in range(10):
        starts, widths = TA.draw_time_mask(400, _gen(seed), 10, 25, lengths)
        assert starts.shape == (4, 16)
        counts = (widths > 0).sum(dim=1)
        assert counts.tolist() <= [16, 4, 2, 1]  # ceil((len - 0.1) / 25) spans at most
        assert bool((counts <= torch.tensor([16, 4, 2, 1])).all())
        assert bool((starts + widths <= lengths[:, None]).all())
        assert bool((widths < lengths[:, None]).all())


def test_adaptive_time_mask_zeroes_whole_frames():
    frames = torch.ones((2, 100, 3, 4, 4))
    out = TA.adaptive_time_mask(frames, _gen(3))
    per_frame = out.flatten(2)
    assert bool(((per_frame == 0).all(dim=2) | (per_frame == 1).all(dim=2)).all())
    assert torch.equal(out[0], out[1])  # without lengths the batch shares one mask
    assert 0 < int((per_frame[0, :, 0] == 0).sum()) <= 4 * 9
    out = TA.adaptive_time_mask(frames, _gen(3), lengths=torch.tensor([100, 30]))
    assert bool((out[1, 30:] == 1).all())
    assert torch.equal(TA.adaptive_time_mask(frames[:, :1], _gen()), frames[:, :1])
    with pytest.raises(ValueError, match="lengths requires"):
        TA.adaptive_time_mask(frames[0], _gen(), lengths=torch.tensor([100]))


def test_color_jitter_and_babble_draw_ranges():
    fb, fc, fs, hue = TV.draw_color_jitter(2000, _gen(), 0.4, 0.4, 1.5, 0.1)
    for f, lo, hi in ((fb, 0.6, 1.4), (fc, 0.6, 1.4), (fs, 0.0, 2.5), (hue, -0.1, 0.1)):
        assert f.shape == (2000,) and float(f.min()) >= lo and float(f.max()) < hi
        assert float(f.max() - f.min()) > 0.9 * (hi - lo)
    starts, level = TA.draw_babble_noise((1000,), 300, 16000, _gen())
    assert int(starts.min()) >= 0 and int(starts.max()) < 16000 - 300
    assert sorted(level.unique().tolist()) == list(range(len(TA.SNR_LEVELS)))
    starts, _ = TA.draw_babble_noise((10,), 300, 300, _gen())
    assert bool((starts == 0).all())


def test_train_video_pipeline_shapes_draws_and_padding(rng):
    raw = torch.from_numpy(rng.integers(0, 255, (4, 30, 3, 16, 16), dtype=np.uint8))
    lengths = torch.tensor([30, 30, 12, 1])
    a = TV.train_video_pipeline(raw, _gen(1), resize=None, lengths=lengths)
    b = TV.train_video_pipeline(raw, _gen(1), resize=None, lengths=lengths)
    c = TV.train_video_pipeline(raw, _gen(2), resize=None, lengths=lengths)
    assert a.shape == raw.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a[2, 12:] == 0).all()) and bool((a[3, 1:] == 0).all())
    # every random stage off (a window of 1 draws widths of 0): the eval pipeline
    plain = TV.train_video_pipeline(raw, _gen(), resize=None, flip_prob=0.0, jitter=None,
                                    grayscale_prob=0.0, time_mask_window=1)
    torch.testing.assert_close(plain, TV.eval_video_pipeline(raw), atol=1e-6, rtol=0)
    flipped = TV.train_video_pipeline(raw, _gen(), resize=None, flip_prob=1.0, jitter=None,
                                      grayscale_prob=0.0, time_mask_window=1)
    torch.testing.assert_close(flipped, TV.eval_video_pipeline(raw).flip(-1), atol=1e-6, rtol=0)
    assert TV.train_video_pipeline(raw, _gen(), resize=8).shape[-2:] == (8, 8)


def test_train_audio_pipeline_pads_trims_and_normalises(rng):
    mel = torch.from_numpy(rng.standard_normal((3, 80, 50)).astype(np.float32))
    bed = torch.from_numpy(rng.standard_normal((500,)).astype(np.float32))
    for target in (64, 40):
        out = TA.train_audio_pipeline(mel, _gen(), noise_bed=bed, target_length=target,
                                      lengths=torch.tensor([50, 30, 8]))
        assert out.shape == (3, target, 80)
        flat = out.reshape(3, -1)
        torch.testing.assert_close(flat.mean(dim=1), torch.zeros(3), atol=1e-5, rtol=0)
        torch.testing.assert_close(flat.var(dim=1, unbiased=False), torch.ones(3), atol=1e-4,
                                   rtol=0)
    single = TA.train_audio_pipeline(mel[0], _gen(), target_length=64)
    assert single.shape == (64, 80)


def test_noise_bed_reader_and_config(tmp_path):
    from mocov2_whisper_flamingo_torch.config import get_config

    path = str(tmp_path / "babble.wav")
    pcm = (np.random.default_rng(0).standard_normal((4000, 2)) * 8000).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    data, rate = TA.read_wav_mono(path)
    assert rate == 16000 and data.dtype == np.float32
    np.testing.assert_allclose(data, pcm.astype(np.float32).mean(axis=1) / 32768.0, atol=1e-7)

    cfg = get_config({"augmentation.audio.train.noise_file": path})
    augment = TA.make_batch_augment(cfg, "cpu")
    batch = {"audio": torch.randn((2, 3000, 80)), "audio_mask": torch.ones((2, 3000)).bool(),
             "video": None}
    out = augment(batch, _gen())
    assert out["audio"].shape == (2, 3000, 80) and out["video"] is None
    quiet = TA.make_batch_augment(
        get_config({"augmentation.audio.train.noise_file": str(tmp_path / "missing.wav")}), "cpu")
    assert quiet(batch, _gen())["audio"].shape == (2, 3000, 80)  # a missing file: no noise
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm[:, 0].tobytes())
    with pytest.raises(ValueError, match="16 kHz"):
        TA.make_batch_augment(cfg, "cpu")
