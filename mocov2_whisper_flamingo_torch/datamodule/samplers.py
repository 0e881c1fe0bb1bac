"""Length-bucketed batch sampling + per-rank sharding (counterpart of
``datamodule/samplers.py``).

Capability parity with the reference samplers (reference:
datamodule/data_module.py:18-120, duplicated in datamodule/samplers.py):

- ``ByFrameCountSampler``: probes the real frame count of every clip once
  (capped at max_frames), orders indices by (shuffled permutation, size)
  descending via lexsort, and packs batches under a token budget of
  ``max_frames * batch_size`` with fairseq ``batch_by_size`` semantics —
  here served by the native C++ packer.
- ``ShardedSampler``: in place of the Catalyst-style
  ``DistributedSamplerWrapper`` (reference: data_module.py:84-106), shards
  the batch list across the ranks of ``torch.distributed`` (pad-to-even by
  wrapping, seeded shuffle, ``set_epoch``), with the same batch size on
  every rank at every step and, given the targets' lengths, the same
  padded target length (``StepBatch``).
- ``RandomSamplerWrapper``: shuffles the batch order for the single-host
  case (reference: data_module.py:108-120).
"""

from __future__ import annotations

import numpy as np

from mocov2_whisper_flamingo_torch.datamodule.native import batch_by_size


class ByFrameCountSampler:
    def __init__(self, dataset, max_frames_per_gpu: int, shuffle: bool = True,
                 seed: int = 0, max_frames: int = 300):
        self.dataset = dataset
        self.max_frames_per_gpu = max_frames_per_gpu
        self.max_frames = max_frames
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        # One startup probe per clip (the reference does a serial FFmpeg
        # probe per item, data_module.py:28-32; npy headers make this cheap).
        self.sizes = np.array(
            [min(dataset.probe_num_frames(i), max_frames) for i in range(len(dataset))],
            dtype=np.int64)
        self._batches_cache: tuple[int, list] | None = None

    def _get_indices(self) -> np.ndarray:
        """Lexsort by (permutation, size), reversed — groups similar lengths
        while the shuffled primary key varies batch composition per epoch
        (reference: data_module.py:40-51)."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(len(self.dataset))
        else:
            order = np.arange(len(self.dataset))
        return np.lexsort((order, self.sizes))[::-1]

    def _make_batches(self) -> list[np.ndarray]:
        """Per-epoch batch list, cached on the current epoch: ``set_epoch``
        reshuffles the packing, so both ``__len__`` and ``__iter__`` must
        see the SAME epoch's batches (round-2 finding: a length computed
        once at epoch 0 can disagree with later epochs' batch counts, and
        the trainer derives schedule lengths from it)."""
        if self._batches_cache is not None and self._batches_cache[0] == self.epoch:
            return self._batches_cache[1]
        if len(self.dataset) == 0:
            batches: list[np.ndarray] = []
        else:
            batches = batch_by_size(
                self._get_indices(), self.sizes, self.max_frames_per_gpu)
        self._batches_cache = (self.epoch, batches)
        return batches

    def __len__(self) -> int:
        return len(self._make_batches())

    def __iter__(self):
        return iter(self._make_batches())

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch


class QuantizedBatchSampler:
    """Split each packed batch into pieces whose sizes come from a small
    allowed set (descending powers of two by default).

    The token-budget packer emits a *different* batch size for nearly every
    batch; quantizing to ``{batch_size, batch_size/2, ..., 1}`` bounds the
    step's shapes to ~log2(batch_size) variants (the cuDNN and cuBLAS
    algorithm choices and the allocator's blocks are per shape), drops no
    samples, and keeps every piece within the original token budget (a
    subset of a packed batch packs). The pieces are the JAX package's.

    ``min_size`` (default 1): smallest allowed piece — pieces are then
    always multiples of it (1 with one card per process). A remainder
    smaller than ``min_size`` is padded UP to it by wrapping indices from
    the same packed batch (duplicate samples — the same trade the
    reference's DistributedSampler makes when it pads ranks, reference:
    data_module.py:84-106).

    ``pad_remainder=False`` passes the short remainder through unpadded
    instead. Required for single-process EVAL: duplicated rows would
    inflate sample counts and WER weighting."""

    def __init__(self, sampler, max_batch_size: int, min_size: int = 1,
                 pad_remainder: bool = True):
        self.sampler = sampler
        self.pad_remainder = bool(pad_remainder)
        self.min_size = max(int(min_size), 1)
        self.allowed = []
        size = self.min_size
        while size <= max(max_batch_size, self.min_size):
            self.allowed.append(size)
            size *= 2
        self.allowed.reverse()  # largest first

    def _split(self, batch) -> list:
        pieces, start, n = [], 0, len(batch)
        while start < n:
            for size in self.allowed:
                if size <= n - start:
                    pieces.append(batch[start : start + size])
                    start += size
                    break
            else:  # remainder < min_size
                piece = np.asarray(batch[start:])
                if self.pad_remainder:  # wrap-pad from the batch front
                    pad = np.resize(np.asarray(batch),
                                    self.min_size - len(piece))
                    piece = np.concatenate([piece, pad])
                pieces.append(piece)
                start = n
        return pieces

    def __iter__(self):
        for batch in self.sampler:
            yield from self._split(batch)

    def __len__(self) -> int:
        return sum(len(self._split(b)) for b in self.sampler)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)


class StepBatch(list):
    """A rank's batch of dataset indices, with ``target_len``: the longest
    target of its step's batches on every rank, which the collate pads to
    (``DataLoader`` passes it on)."""

    def __init__(self, indices, target_len: int):
        super().__init__(indices)
        self.target_len = target_len


class ShardedSampler:
    """Shard a batch sampler's output across ranks with **per-step size
    agreement**: at every iteration position, all ranks hold a batch of the
    SAME size (ranks whose steps disagree in shape would desynchronise their
    gradient all-reduce). So batches are grouped by size, each size group is padded to a multiple of
    ``num_replicas`` by wrapping (the reference DistributedSampler's pad
    trade, reference: data_module.py:84-106) and dealt round-robin; the
    optional shuffle permutes iteration POSITIONS with the shared
    (seed + epoch) generator, which every rank computes identically, so
    alignment survives the shuffle.

    Requires the wrapped sampler to be deterministic and identically seeded
    on every rank (true for ByFrameCountSampler/QuantizedBatchSampler:
    same dataset walk, same seed + epoch).

    ``target_length(idx)``: the length of a sample's target. Where given,
    each batch comes out as a ``StepBatch`` that carries the longest target
    of its step over every rank's batch, so every rank pads its targets to
    one length, as the JAX step pads its one global batch: the trainer's
    compiled step captures its graphs by batch shape, and ranks whose
    shapes differed would capture at different steps and wait on each
    other's collectives."""

    def __init__(self, sampler, num_replicas: int, rank: int, shuffle: bool = True,
                 seed: int = 0, target_length=None):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.sampler = sampler
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.target_length = target_length
        self.epoch = 0

    def _sharded(self) -> list:
        batches = list(self.sampler)
        if not batches:
            return []
        by_size: dict[int, list] = {}
        for b in batches:
            by_size.setdefault(len(b), []).append(b)
        mine = []
        for size in sorted(by_size, reverse=True):
            group = by_size[size]
            remainder = len(group) % self.num_replicas
            if remainder:
                # Pad by TILING the group so every rank gets a full column
                # even when the pad exceeds the group length (a 1-batch
                # group on 4 replicas needs 3 pad entries — a plain slice
                # would under-pad and desync the ranks' batch counts).
                pad = self.num_replicas - remainder
                reps = -(-pad // len(group))
                group = group + (group * reps)[:pad]
            for start in range(0, len(group), self.num_replicas):
                step = group[start:start + self.num_replicas]
                if self.target_length is None:
                    mine.append(step[self.rank])
                else:
                    longest = max(self.target_length(int(i)) for b in step for i in b)
                    mine.append(StepBatch(step[self.rank], longest))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            perm = rng.permutation(len(mine))  # identical on every rank
            mine = [mine[i] for i in perm]
        return mine

    def __len__(self) -> int:
        counts: dict[int, int] = {}
        for b in self.sampler:
            counts[len(b)] = counts.get(len(b), 0) + 1
        r = self.num_replicas
        return sum((n + r - 1) // r for n in counts.values())

    def __iter__(self):
        return iter(self._sharded())

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)


class RandomSamplerWrapper:
    """Shuffle the order of a batch sampler's batches (one process)."""

    def __init__(self, sampler, seed: int = 0):
        self.sampler = sampler
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self):
        batches = list(self.sampler)
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter([batches[i] for i in rng.permutation(len(batches))])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
