"""DataModule: datasets + samplers + loader + collate (counterpart of
``datamodule/data_module.py``).

API parity with the reference LightningDataModule (reference:
datamodule/data_module.py:154-274): ``DataModule(config)`` with
``setup(stage)`` / ``train_dataloader()`` / ``val_dataloader()`` /
``test_dataloader()``, batches keyed exactly like the reference collate
(data_module.py:142-152). Differences by design:

- loaders are plain Python iterables backed by a thread-pool prefetcher
  (no torch DataLoader; ``num_workers`` maps to prefetch threads);
- with ``torch.distributed`` initialised, ``ShardedSampler`` deals the
  batches over the mesh's data indices (``mesh.model`` ranks share one)
  instead of torch's DistributedSampler;
- the tokenizer is the extended Whisper tokenizer when a local directory is
  configured (``data.updated_tokenizer_dir``, reference:
  data_module.py:171-174), else a self-contained byte tokenizer.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from mocov2_whisper_flamingo_torch.datamodule.av_dataset import AVDataset
from mocov2_whisper_flamingo_torch.datamodule.samplers import (
    ByFrameCountSampler, QuantizedBatchSampler, RandomSamplerWrapper,
    ShardedSampler, StepBatch)
from mocov2_whisper_flamingo_torch.datamodule.transforms import AudioTransform, VideoTransform
from mocov2_whisper_flamingo_torch.utils.tokenizer import load_tokenizer

logger = logging.getLogger(__name__)


def _data_shard(n_model: int = 1) -> tuple[int, int]:
    """``(data axis size, data index)`` of this process in a mesh with a
    model axis of ``n_model`` over the processes of ``torch.distributed``
    (rank = data index * n_model + model index, ``parallel/mesh.py``);
    ``(1, 0)`` without a process group. The ranks of one model group share
    a data index, so they receive the same batches."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        n_model = int(n_model or 1)
        return dist.get_world_size() // n_model, dist.get_rank() // n_model
    return 1, 0


def collate_fn(batch: list[dict], target_len_buckets=None, target_len: int = 0) -> dict:
    """Pad target_ids to the batch max **with 0** — conscious replication of
    the reference quirk Q3 (data_module.py:134-137 pads with 0 while CE
    ignores only -100); stack all modality tensors; keep raw texts.

    ``target_len``: a length to pad to at least (several ranks: the longest
    target of the step over every rank, ``ShardedSampler``'s ``StepBatch``).
    ``target_len_buckets``: optional ascending lengths; the batch max is
    rounded UP to the smallest bucket that fits, so the step sees a handful
    of target shapes instead of one per batch (the JAX package's batches,
    whose compiled step specialises per shape)."""
    max_target_len = max(target_len, *(item["target_ids"].shape[0] for item in batch))
    if target_len_buckets:
        for bucket in sorted(target_len_buckets):
            if bucket >= max_target_len:
                max_target_len = bucket
                break
        else:
            raise ValueError(
                f"target length {max_target_len} exceeds largest bucket "
                f"{max(target_len_buckets)}")
    padded = []
    for item in batch:
        ids = item["target_ids"]
        if ids.shape[0] < max_target_len:
            ids = np.concatenate(
                [ids, np.zeros(max_target_len - ids.shape[0], dtype=ids.dtype)])
        padded.append(ids)

    def _stack(key):
        if batch[0].get(key) is None:
            return None
        return np.stack([item[key] for item in batch])

    return {
        "video": _stack("video"),
        "video_mask": _stack("video_mask"),
        "audio": _stack("audio"),
        "audio_mask": _stack("audio_mask"),
        "target_ids": np.stack(padded),
        "target_text": [item["target_text"] for item in batch],
        "target_lengths": _stack("target_lengths"),
        "audio_lengths": _stack("audio_lengths"),
        "video_lengths": _stack("video_lengths"),
    }


class DrawOrder:
    """Turns to draw from a shared generator, in the order the samples were
    submitted: ``ticket()`` is called in submission order on one thread;
    the sample's ``Turn`` is entered before its first draw and left after
    its last."""

    def __init__(self):
        self._cond = threading.Condition()
        self._issued = 0
        self._serving = 0

    def ticket(self) -> "Turn":
        turn = Turn(self, self._issued)
        self._issued += 1
        return turn


class Turn:
    def __init__(self, order: DrawOrder, number: int):
        self.order, self.number, self.taken = order, number, False

    def __enter__(self) -> "Turn":
        with self.order._cond:
            self.order._cond.wait_for(lambda: self.order._serving == self.number)
        self.taken = True
        return self

    def __exit__(self, *exc) -> bool:
        with self.order._cond:
            self.order._serving += 1
            self.order._cond.notify_all()
        return False


class DataLoader:
    """Batch-sampler-driven loader with thread-pool sample fetch and
    inter-batch prefetch.

    With ``num_workers`` above 0 the samples of a batch are fetched by a
    thread pool. Where the dataset's samples draw from its shared generator
    (``AVDataset.draws``: the host train transforms), each takes its draws in
    its turn (``DrawOrder``), so the batches do not depend on the worker
    count or on thread timing: they equal the synchronous loader's. The JAX
    package's loader lets the threads draw as they come.

    ``prefetch_batches`` (default 2): a background producer thread prepares
    batch N+1..N+prefetch (fetch + collate + optional ``device_put``) while
    the caller consumes batch N — host IO/augmentation overlaps device
    compute, the role the reference's torch DataLoader worker processes +
    pin_memory play (reference: datamodule/data_module.py:243-252). Threads
    (not processes) suffice here: the hot per-sample work (numpy mel,
    resample via the native C++ lib, npy reads) releases the GIL. Order is
    identical to the synchronous path; 0 disables prefetch.

    ``device_put``: optional callable applied to each collated batch ON THE
    PRODUCER THREAD — the trainer hooks its placement here
    (``Trainer._put_batch``: pinned host copies, then an asynchronous copy on
    the trainer's copy stream) so the host-to-device transfer of batch N+1
    also overlaps step N.
    """

    def __init__(self, dataset, batch_sampler, collate=collate_fn,
                 num_workers: int = 0, prefetch_batches: int = 2,
                 device_put=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.device_put = device_put

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def _collate(self, indices, samples) -> dict:
        if isinstance(indices, StepBatch):  # the target length of its step on every rank
            return self.collate(samples, target_len=indices.target_len)
        return self.collate(samples)

    def _batches(self) -> Iterator[dict]:
        """Synchronous fetch+collate (+device_put) stream."""
        if self.num_workers > 0:
            order = DrawOrder() if getattr(self.dataset, "draws", False) else None
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for indices in self.batch_sampler:
                    if order is None:
                        samples = list(pool.map(self.dataset.__getitem__, indices))
                    else:
                        turns = [order.ticket() for _ in indices]
                        samples = list(pool.map(self.dataset.fetch, indices, turns))
                    batch = self._collate(indices, samples)
                    yield self.device_put(batch) if self.device_put else batch
        else:
            for indices in self.batch_sampler:
                batch = self._collate(indices, [self.dataset[i] for i in indices])
                yield self.device_put(batch) if self.device_put else batch

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch_batches <= 0:
            yield from self._batches()
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for batch in self._batches():
                    if not _put(("item", batch)):
                        return
            except BaseException as exc:  # re-raised on the consumer side
                _put(("error", exc))
            else:
                _put(("done", None))

        thread = threading.Thread(target=produce, daemon=True,
                                  name="dataloader-prefetch")
        thread.start()
        try:
            while True:
                kind, value = q.get()
                if kind == "done":
                    break
                if kind == "error":
                    raise value
                yield value
        finally:  # consumer broke early or raised: unblock + stop producer
            stop.set()
            thread.join(timeout=5.0)


class DataModule:
    def __init__(self, config):
        self.config = config
        data = config["data"]
        self.root_dir = data["root_dir"]
        self.batch_size = data["batch_size"]
        self.val_batch_size = data["val_batch_size"]
        self.test_batch_size = data["test_batch_size"]
        self.num_workers = data["num_workers"]
        self.prefetch_batches = data.get("prefetch_batches", 2)
        self.max_frames = data["max_frames"]
        self.max_frames_val = data["max_frames_val"]
        self.rate_ratio = data["rate_ratio"]
        self.modality = data["modality"]
        self.seed = config["training"].get("seed", 0) if "training" in config else 0
        self.quantize_batch_sizes = data.get("quantize_batch_sizes", True)
        buckets = data.get("target_len_buckets", (64, 128, 256, 448))
        self.target_len_buckets = tuple(buckets) if buckets else None

        noise_file = config["augmentation"]["audio"]["train"].get("noise_file")
        self._noise_file = noise_file
        self.tokenizer = load_tokenizer(
            data.get("updated_tokenizer_dir"),
            language=config["whisper"].get("language", "vietnamese"),
            task=config["whisper"].get("task", "transcribe"))
        logger.info("DataModule tokenizer: %s (vocab %d)",
                    type(self.tokenizer).__name__, len(self.tokenizer))

        self.train_dataset = self.val_dataset = self.test_dataset = None

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)

    def _make_dataset(self, split: str, subset: str, max_frames: int) -> AVDataset:
        video_cfg = self.config["augmentation"]["video"].get(
            "train" if subset == "train" else "val", {})
        resize = video_cfg.get("resize", 64)
        # on-device augmentation mode: the train loader emits raw mel +
        # raw resized frames; the stochastic chain runs on the card inside
        # the train step (trainer wires ops.augment.make_batch_augment).
        on_device = bool(self.config["augmentation"].get("on_device", False))
        on_device_mel = bool(self.config["augmentation"].get("on_device_mel", False))
        if on_device_mel and not on_device:
            raise ValueError(
                "augmentation.on_device_mel requires augmentation.on_device "
                "(the waveform is consumed by the on-device augment step; "
                "without it the host mel would silently run instead)")
        return AVDataset(
            root_dir=self.root_dir,
            split=split,
            modality=self.modality,
            audio_transform=AudioTransform(subset, noise_file=self._noise_file,
                                           on_device=on_device,
                                           on_device_mel=on_device_mel),
            video_transform=VideoTransform(subset, resize=resize,
                                           on_device=on_device),
            rate_ratio=self.rate_ratio,
            max_frames=max_frames,
            tokenizer=self.tokenizer,
            seed=self.seed,
        )

    def setup(self, stage: str | None = None) -> None:
        if stage in ("fit", None):
            self.train_dataset = self._make_dataset("train", "train", self.max_frames)
            logger.info("train dataset: %d samples", len(self.train_dataset))
            self.val_dataset = self._make_dataset("val", "val", self.max_frames_val)
            logger.info("val dataset: %d samples", len(self.val_dataset))
        if stage in ("test", None):
            self.test_dataset = self._make_dataset("test", "test", self.max_frames_val)
            logger.info("test dataset: %d samples", len(self.test_dataset))

    def _collate(self, batch, target_len: int = 0):
        return collate_fn(batch, target_len_buckets=self.target_len_buckets,
                          target_len=target_len)

    def _get_sampler(self, dataset, batch_size: int, shuffle: bool = True,
                     max_frames: int | None = None):
        # Per-split frame cap: val/test datasets are built with
        # max_frames_val, so their token budget and size clamp must use it
        # too (clamping 600-frame val clips to the train cap would pack
        # double the intended memory budget into a batch).
        max_frames = max_frames or self.max_frames
        base = ByFrameCountSampler(
            dataset,
            max_frames_per_gpu=max_frames * batch_size,
            shuffle=shuffle,
            seed=self.seed,
            max_frames=max_frames,
        )
        world, rank = _data_shard(self.config.get("mesh", {}).get("model", 1))
        multi_rank = world > 1
        if self.quantize_batch_sizes:
            # One card per process, so any piece size places (min_size 1).
            # Single-process EVAL must not wrap-pad short remainders:
            # duplicate rows inflate sample counts / WER weighting. Train
            # keeps padding (duplicates are the reference DistributedSampler's
            # own trade). Several ranks always pad: every rank must hold the
            # same batch size at each step.
            base = QuantizedBatchSampler(base, batch_size, min_size=1,
                                         pad_remainder=multi_rank or shuffle)
        if multi_rank:
            return ShardedSampler(base, world, rank, shuffle=shuffle, seed=self.seed,
                                  target_length=dataset.target_length)
        return RandomSamplerWrapper(base, seed=self.seed) if shuffle else base

    def train_dataloader(self) -> DataLoader:
        if self.train_dataset is None:
            self.setup("fit")
        return DataLoader(self.train_dataset,
                          self._get_sampler(self.train_dataset, self.batch_size, True),
                          collate=self._collate, num_workers=self.num_workers,
                          prefetch_batches=self.prefetch_batches)

    def val_dataloader(self) -> DataLoader:
        if self.val_dataset is None:
            self.setup("fit")
        return DataLoader(self.val_dataset,
                          self._get_sampler(self.val_dataset, self.val_batch_size, False,
                                            max_frames=self.max_frames_val),
                          collate=self._collate, num_workers=self.num_workers,
                          prefetch_batches=self.prefetch_batches)

    def test_dataloader(self) -> DataLoader:
        if self.test_dataset is None:
            self.setup("test")
        return DataLoader(self.test_dataset,
                          self._get_sampler(self.test_dataset, self.test_batch_size, False,
                                            max_frames=self.max_frames_val),
                          collate=self._collate, num_workers=self.num_workers,
                          prefetch_batches=self.prefetch_batches)
