"""The port's data module against the JAX package's on a tiny dataset that the
test writes in the reference layout (``{split}/{split}_video_seg12s/<folder>/
<clip>`` with ``{split}_text_seg12s/<folder>/<clip>.txt``): every batch of the
train, validation and test loaders over two epochs, bit for bit, in the host,
``on_device`` and ``on_device_mel`` modes; the on-device mel of a packed
waveform batch; and ``Trainer.fit`` fed by each package's data module.

The JAX ``DataModule`` sizes its batch pieces by ``jax.local_device_count()``
(8 virtual CPU devices here); the port's runs one card per process, so the
JAX side is taken on one device. With worker threads, the JAX loader's host
train transforms draw from the shared generator in whatever order the threads
reach it, so its batches change from run to run; the port takes the draws in
submission order. Every port setting is therefore held against the JAX
loader's synchronous batches, which are reproducible."""

import contextlib
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.config import get_config as t_get_config
from mocov2_whisper_flamingo_torch.datamodule import av_dataset as t_av
from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule as TDataModule
from mocov2_whisper_flamingo_torch.datamodule.data_module import DrawOrder
from mocov2_whisper_flamingo_torch.datamodule.transforms import np_reference_mel as t_np_mel
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.ops import augment as TA
from mocov2_whisper_flamingo_torch.training.trainer import Trainer as TTrainer
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer as TByteTokenizer
from mocov2_whisper_flamingo_tpu.config import get_config as j_get_config
from mocov2_whisper_flamingo_tpu.datamodule import av_dataset as j_av
from mocov2_whisper_flamingo_tpu.datamodule.data_module import DataModule as JDataModule
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from mocov2_whisper_flamingo_tpu.ops import mel as JM
from mocov2_whisper_flamingo_tpu.training.trainer import Trainer as JTrainer
from mocov2_whisper_flamingo_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

MAX_FRAMES = 16
MODES = {"host": {}, "on_device": {"augmentation.on_device": True},
         "on_device_mel": {"augmentation.on_device": True, "augmentation.on_device_mel": True}}
# Train losses and trainable parameters after two fp32 updates (the train-step
# tolerances of tests/test_torch_training.py).
LOSS_ATOL, PARAM_ATOL = 1e-4, 2e-5
VOCAB = 262  # ByteTokenizer
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=1500, max_target_positions=32)


def _write_wav(path, x: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(x * 32767, -32768, 32767).astype("<i2").tobytes())


def _write_mp4(path, frames: np.ndarray) -> bool:
    """``frames`` [T, H, W, 3] RGB through cv2's ``mp4v`` encoder; False when
    the cv2 build has none."""
    try:
        import cv2
    except ImportError:
        return False
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (frames.shape[2], frames.shape[1]))
    if not writer.isOpened():
        return False
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return os.path.getsize(path) > 0


def _write_dataset(root, odd_clips: bool) -> str:
    """Train: .npy and .npz clips of 8-16 frames at 96x96 with WAVs at 16 and
    48 kHz (five, of which pieces of 2 and 1 are cut; four without
    ``odd_clips``, all in pieces of 2), and with ``odd_clips`` an mp4 where
    cv2 can write one and a broken clip; val and test: two clips each."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 5 if odd_clips else 4), ("val", 2), ("test", 2)):
        vdir = root / split / f"{split}_video_seg12s" / "spk1"
        tdir = root / split / f"{split}_text_seg12s" / "spk1"
        vdir.mkdir(parents=True)
        tdir.mkdir(parents=True)
        for i in range(n):
            frames = rng.integers(0, 256, (8 + (3 * i) % 9, 96, 96, 3), dtype=np.uint8)
            if i == 1:
                np.savez(vdir / f"c{i}.npz", frames=frames)
            else:
                np.save(vdir / f"c{i}.npy", frames)
            sr = 48000 if i % 2 else 16000
            _write_wav(vdir / f"c{i}.wav", rng.standard_normal(int(sr * (2.0 + 0.3 * i))) * 0.2,
                       sr)
            (tdir / f"c{i}.txt").write_text(f"xin chao {i}")
        if split == "train" and odd_clips:
            (vdir / "broken.npy").write_bytes(b"not an array")
            _write_wav(vdir / "broken.wav", np.zeros(16000), 16000)
            (tdir / "broken.txt").write_text("hong")
            yy, xx = np.mgrid[0:96, 0:96]
            smooth = np.stack([np.stack([(yy * 2 + t * 5) % 256, (xx * 2) % 256,
                                         np.full((96, 96), 128)], -1) for t in range(10)])
            if _write_mp4(vdir / "movie.mp4", smooth.astype(np.uint8)):
                _write_wav(vdir / "movie.wav", rng.standard_normal(40000) * 0.2, 16000)
                (tdir / "movie.txt").write_text("phim")
    return str(root)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("avsr_torch_data"), odd_clips=True)


@pytest.fixture(scope="module")
def clean_root(tmp_path_factory):
    """No broken clip: its empty sample fuses under an all-False video mask,
    where the JAX XLA attention returns mean(V) and the port's 0 (the Pallas
    kernel's answer, ROADMAP.md's decisions)."""
    return _write_dataset(tmp_path_factory.mktemp("avsr_torch_clean"), odd_clips=False)


def _overrides(root, mode, workers=0, prefetch=0, **extra):
    return {"data.root_dir": root, "data.batch_size": 2, "data.val_batch_size": 2,
            "data.test_batch_size": 2, "data.max_frames": MAX_FRAMES,
            "data.max_frames_val": MAX_FRAMES, "data.num_workers": workers,
            "data.prefetch_batches": prefetch, **MODES[mode], **extra}


@contextlib.contextmanager
def _one_jax_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "local_device_count", lambda: 1)
        yield


def _epochs(dm) -> list:
    """Every batch of the train, validation and test loaders over two epochs."""
    loaders = [dm.train_dataloader(), dm.val_dataloader(), dm.test_dataloader()]
    out = []
    for epoch in range(2):
        for loader in loaders:
            loader.set_epoch(epoch)
            out.append(list(loader))
    return out


@pytest.fixture(scope="module")
def jax_batches(dataset_root):
    cache = {}

    def get(mode):
        if mode not in cache:
            with _one_jax_device():
                dm = JDataModule(j_get_config(_overrides(dataset_root, mode)))
                dm.setup()
                cache[mode] = _epochs(dm)
        return cache[mode]

    return get


def _assert_same(ours: list, ref: list) -> None:
    assert [len(x) for x in ours] == [len(x) for x in ref]
    for loader_ours, loader_ref in zip(ours, ref):
        for a, b in zip(loader_ours, loader_ref):
            assert set(a) == set(b)
            for key in a:
                if isinstance(b[key], np.ndarray):
                    assert a[key].dtype == b[key].dtype, key
                    assert np.array_equal(a[key], b[key]), key
                else:
                    assert a[key] == b[key], key


@pytest.mark.parametrize("workers,prefetch", [(0, 0), (0, 2), (2, 0), (2, 2)])
@pytest.mark.parametrize("mode", list(MODES))
def test_batches_equal_the_jax_data_module(dataset_root, jax_batches, mode, workers, prefetch):
    dm = TDataModule(t_get_config(_overrides(dataset_root, mode, workers, prefetch)))
    dm.setup()
    ours = _epochs(dm)
    _assert_same(ours, jax_batches(mode))
    train = [b for b in ours[0]]
    n_clips = len(dm.train_dataset)
    assert sum(len(b["target_text"]) for b in train) >= n_clips  # quantised pieces pad
    empty = [b for b in train if not b["video_mask"].any(axis=1).all()]
    assert empty, "the broken clip's empty sample is in a batch"
    audio_shape = (480_200,) if mode == "on_device_mel" else (3000, 80)
    assert all(b["audio"].shape[1:] == audio_shape for b in train)
    assert all(b["video"].dtype == (np.uint8 if mode != "host" else np.float32) for b in train)


def test_the_mp4_clip_is_decoded_in_process(dataset_root):
    path = os.path.join(dataset_root, "train", "train_video_seg12s", "spk1", "movie.mp4")
    if not os.path.exists(path):
        pytest.skip("cv2 build has no mp4 encoder")
    frames = t_av.read_video(path)
    assert frames.shape == (10, 3, 96, 96) and t_av.probe_video_frames(path) == 10
    np.testing.assert_array_equal(frames, j_av.read_video(path))


def test_npy_frame_probe_needs_no_private_numpy_header_reader(tmp_path, monkeypatch):
    """Newer numpy keeps only the public names in ``numpy.lib.format``; the
    JAX package's probe calls its private ``_read_array_header`` and then
    falls back to ``max_frames`` for every clip."""
    import types

    path = str(tmp_path / "clip.npy")
    np.save(path, np.zeros((37, 8, 8, 3), np.uint8))
    public = {k: v for k, v in vars(np.lib.format).items() if not k.startswith("_")}
    monkeypatch.setattr(np.lib, "format", types.SimpleNamespace(**public))
    assert t_av.probe_video_frames(path, default=-1) == 37
    assert j_av.probe_video_frames(path, default=-1) == -1
    (tmp_path / "bad.npy").write_bytes(b"junk")
    assert t_av.probe_video_frames(str(tmp_path / "bad.npy"), default=-1) == -1


def test_host_train_draws_follow_submission_order_under_threads(dataset_root):
    """Two worker threads and a turnstile: the same batches as one thread,
    run after run."""
    runs = []
    for workers in (0, 3, 3):
        dm = TDataModule(t_get_config(_overrides(dataset_root, "host", workers)))
        dm.setup()
        runs.append([b["video"] for b in dm.train_dataloader()])
    for run in runs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(runs[0], run))


def test_draw_turns_serialise_threads_in_ticket_order():
    """More threads than cores, started in reverse, a short switch interval:
    a read-modify-write that yields inside each turn loses no update, and
    the turns come in ticket order."""
    import sys
    import threading
    import time

    order, seen, count = DrawOrder(), [], [0]
    turns = [order.ticket() for _ in range(32)]

    def work(turn):
        with turn:
            n = count[0]
            time.sleep(0)
            count[0] = n + 1
            seen.append(turn.number)

    threads = [threading.Thread(target=work, args=(t,)) for t in reversed(turns)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert count[0] == 32 and seen == list(range(32)) and all(t.taken for t in turns)


# -- on-device mel ------------------------------------------------------------------------


def _packed(seed=4):
    rng = np.random.default_rng(seed)
    waves = [(rng.standard_normal(n) * 0.2).astype(np.float32) for n in (40_000, 64_000)]
    packed = [t_av.pack_waveform(w) for w in waves]
    for w, (buf, t_real) in zip(waves, packed):
        ref_buf, ref_t = j_av.pack_waveform(w)
        assert t_real == ref_t and np.array_equal(buf, ref_buf)
    mask = np.zeros((2, 3000), bool)
    for i, (_, t_real) in enumerate(packed):
        mask[i, :t_real] = True
    return waves, np.stack([b for b, _ in packed]), mask


def test_waveform_mode_augment_matches_mel_mode():
    """Same generator: the waveform branch (mel in the step) and the mel
    branch (the host's raw mel) give the same augmented features (the
    tolerance of the JAX package's own test of this)."""
    waves, packed, mask = _packed()
    mels = np.zeros((2, 3000, 80), np.float32)
    for i, w in enumerate(waves):
        m = t_np_mel(w).T[:3000]
        mels[i, : m.shape[0]] = m
    wf = TA.make_batch_augment(t_get_config(MODES["on_device_mel"]), "cpu")
    mel = TA.make_batch_augment(t_get_config(MODES["on_device"]), "cpu")
    out_wf = wf({"audio": torch.from_numpy(packed), "audio_mask": torch.from_numpy(mask),
                 "video": None}, torch.Generator().manual_seed(7))["audio"]
    out_mel = mel({"audio": torch.from_numpy(mels), "audio_mask": torch.from_numpy(mask),
                   "video": None}, torch.Generator().manual_seed(7))["audio"]
    assert out_wf.shape == (2, 3000, 80) and bool(torch.isfinite(out_wf).all())
    np.testing.assert_allclose(out_wf.numpy(), out_mel.numpy(), rtol=1e-3, atol=1e-3)


def test_waveform_mode_mel_matches_the_jax_reference_mel():
    """The mel before augmentation, fp32, against the JAX ``reference_mel``
    path of ``make_batch_augment`` on the same packed batch: within 1e-5 of
    the largest value."""
    _, packed, mask = _packed()
    ours = TA.packed_waveform_mel(torch.from_numpy(packed), torch.from_numpy(mask)).numpy()
    ref = np.asarray(JM.reference_mel(jnp.asarray(packed)))[..., :3000]
    ref = ref * (np.arange(3000)[None, :] < mask.sum(axis=1)[:, None])[:, None, :]
    assert ours.shape == ref.shape == (2, 80, 3000)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    assert not ours[0, :, mask[0].sum():].any()


def test_batches_are_dealt_by_data_index_at_model_2(clean_root, monkeypatch):
    """4 processes at ``mesh.model: 2``: the two ranks of one model group
    (ranks 0 and 1, data index 0; ranks 2 and 3, data index 1) receive the
    same batches, and the two data indices disjoint ones that together hold
    every clip. Dealing by global rank over the world would hand each rank
    of a model group its own rows."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    seen = {}
    for rank in range(4):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
        dm = TDataModule(t_get_config(_overrides(clean_root, "host", **{"mesh.model": 2})))
        dm.setup()
        seen[rank] = list(dm.train_dataloader())
    texts = {r: [t for b in batches for t in b["target_text"]] for r, batches in seen.items()}
    for a, b in ((0, 1), (2, 3)):
        assert texts[a] == texts[b] and len(seen[a]) == len(seen[b]) >= 1
        for x, y in zip(seen[a], seen[b]):
            for key in ("audio", "video", "target_ids"):
                np.testing.assert_array_equal(x[key], y[key])
    assert not set(texts[0]) & set(texts[2])
    assert sorted(texts[0] + texts[2]) == [f"xin chao {i}" for i in range(4)]


# -- Trainer.fit from the data module ---------------------------------------------------------


class _RecordingWriter:
    def __init__(self, path):
        self.path, self.scalars = path, []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


def _fit_overrides(root, tmp_path, name, **extra):
    return _overrides(root, "host", **{
        "training.epochs": 1, "training.accumulate_grad_batches": 1,
        "training.max_lr": 1e-3, "model.dropout": 0.0, "precision.compute_dtype": "float32",
        "precision.rematerialize": False, "mesh.data": 1, "mesh.model": 1,
        "output.checkpoint_dir": str(tmp_path / name / "ckpt"),
        "output.log_dir": str(tmp_path / name / "logs"), "output.log_every_n_steps": 1,
        "output.save_predictions": False, **extra})


def _modelargs():
    return (32, 4, 2, 3000, 128, 0.0)


def _tree():
    probe = TNet("audiovisual", None, 96, _modelargs(), VOCAB, device="cpu",
                 whisper_config=TConfig(**TINY))
    tree = random_avnet_params(probe, 0)
    for layer in tree["fusion"]["layers"]:
        layer["attn_gate"] = np.float32(0.5)
        layer["ff_gate"] = np.float32(0.5)
    return tree


def _torch_fit(root, tmp_path, name, tree, **extra):
    config = t_get_config(_fit_overrides(root, tmp_path, name, **extra))
    net = load_jax_params(TNet("audiovisual", None, 96, _modelargs(), VOCAB, device="cpu",
                               whisper_config=TConfig(**TINY)), tree)
    trainer = TTrainer(config, net, TByteTokenizer(), device="cpu")
    trainer.writer = _RecordingWriter(trainer.writer.path)
    dm = TDataModule(config)
    dm.setup()
    trainer.fit(dm, max_steps=2)
    return trainer


@pytest.fixture(scope="module")
def jax_fit(clean_root, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("jax_fit")
    config = j_get_config(_fit_overrides(clean_root, tmp_path, "jax"))
    net = JNet("audiovisual", None, 96, _modelargs(), VOCAB, whisper_name="whisper-tiny",
               backend="xla")
    cfg = JConfig(**TINY)
    net.whisper_config = cfg
    net.whisper_encoder = JEncoder(cfg, net.precision, "xla")
    tree = _tree()
    with _one_jax_device():
        trainer = JTrainer(config, net, JByteTokenizer())
        trainer.writer = _RecordingWriter(trainer.writer.path)
        dm = JDataModule(config)
        dm.setup()
        params = trainer.fit(dm, jax.tree.map(jnp.asarray, tree), max_steps=2)
    return tree, trainer, jax.tree.map(np.asarray, params)


def _scalars(trainer, prefix):
    return {(tag, step): v for tag, v, step in trainer.writer.scalars if tag.startswith(prefix)}


def test_fit_from_the_data_module_matches_jax(clean_root, tmp_path, jax_fit):
    tree, jtrainer, jparams = jax_fit
    trainer = _torch_fit(clean_root, tmp_path, "torch", tree)
    assert trainer.global_step == jtrainer.global_step == 2
    ours, ref = _scalars(trainer, "train/"), _scalars(jtrainer, "train/")
    assert set(ours) == set(ref) and len(ours) >= 6
    for key, value in ref.items():
        assert ours[key] == pytest.approx(value, abs=LOSS_ATOL), key
    val_ours, val_ref = _scalars(trainer, "val/loss"), _scalars(jtrainer, "val/loss")
    assert val_ours.keys() == val_ref.keys()
    for key, value in val_ref.items():
        assert val_ours[key] == pytest.approx(value, abs=LOSS_ATOL)
    moved = 0.0
    for name, param in trainer.net.trainable_parameters():
        node = jparams
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        np.testing.assert_allclose(param.detach().numpy(), node, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
        start = tree
        for part in name.split("."):
            start = start[int(part)] if isinstance(start, list) else start[part]
        moved = max(moved, float(np.abs(param.detach().numpy() - start).max()))
    assert moved > 1e-4


def test_prefetch_placed_batches_train_like_synchronous_ones(dataset_root, tmp_path):
    tree = _tree()
    placed = _torch_fit(dataset_root, tmp_path, "placed", tree, **{"data.prefetch_batches": 2,
                                                                    "data.num_workers": 2})
    sync = _torch_fit(dataset_root, tmp_path, "sync", tree, **{"data.prefetch_batches": 0})
    for (name, a), (_, b) in zip(placed.net.named_parameters(), sync.net.named_parameters()):
        assert torch.equal(a, b), name


def test_train_entry_point_trains_on_a_dataset(dataset_root, tmp_path, monkeypatch):
    from mocov2_whisper_flamingo_torch import train

    monkeypatch.chdir(tmp_path)
    sets = [f"{k}={v}" for k, v in _overrides(dataset_root, "host").items()]
    sets += ["model.d_model=32", "model.n_heads=1", "model.fc_hidden_size=64",
             "whisper.model_name=whisper-tiny", "precision.compute_dtype=float32",
             "training.epochs=1"]
    argv = [a for s in sets for a in ("--set", s)] + ["--device", "cpu", "--max-steps", "1"]
    assert train.main(argv) == 0
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["last.json", "step_1.pt"]
    run_dir = tmp_path / "logs" / "avsr_logs" / "version_0"
    text = (run_dir / "predictions.txt").read_text()
    assert text.count("Target: xin chao") == 2
