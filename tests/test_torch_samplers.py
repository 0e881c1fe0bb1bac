"""Every rank pads its batch's targets to one length at every step
(``datamodule/samplers.py::ShardedSampler`` with the dataset's
``target_length``, ``StepBatch``), the length the JAX package's collate gives
the step's one global batch. The trainer's compiled step on a mesh of NCCL
groups needs it: ranks whose batches differed in shape would capture their
graphs at different steps and wait on each other's collectives.
Single-process: the sampler deals every rank's batches, so each rank's
loader can be run here in turn."""

import numpy as np
import pytest

from mocov2_whisper_flamingo_torch.config import get_config
from mocov2_whisper_flamingo_torch.datamodule import data_module as dm_mod
from mocov2_whisper_flamingo_torch.datamodule.av_dataset import AVDataset
from mocov2_whisper_flamingo_torch.datamodule.samplers import ShardedSampler, StepBatch
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer
from mocov2_whisper_flamingo_tpu.datamodule import data_module as jax_dm
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)


class _Dataset:
    """Clips of ``frames`` lip frames whose targets are ``lengths`` tokens long."""

    def __init__(self, lengths, frames=None):
        self.lengths = list(lengths)
        self.frames = list(frames or [8] * len(self.lengths))

    def __len__(self):
        return len(self.lengths)

    def probe_num_frames(self, idx):
        return self.frames[idx]

    def target_length(self, idx):
        return self.lengths[idx]

    def __getitem__(self, idx):
        n = self.lengths[idx]
        return {"target_ids": np.arange(1, n + 1, dtype=np.int64), "target_text": str(idx),
                "target_lengths": np.int32(n)}


def _module(tmp_path, **data) -> dm_mod.DataModule:
    return dm_mod.DataModule(get_config({"data.root_dir": str(tmp_path), "data.batch_size": 2,
                                         "data.prefetch_batches": 0,
                                         **{f"data.{k}": v for k, v in data.items()}}))


def _rank_loader(module, dataset, monkeypatch, rank, world=2, shuffle=False):
    monkeypatch.setattr(dm_mod, "_data_shard", lambda n_model=1: (world, rank))
    sampler = module._get_sampler(dataset, 2, shuffle=shuffle, max_frames=8)
    return dm_mod.DataLoader(dataset, sampler, collate=module._collate, prefetch_batches=0)


@pytest.mark.parametrize("buckets,lengths", [
    ((64, 128), [3, 70, 64, 10]),  # the ranks' batches of a step straddle 64/128
    ((64, 128), [3, 70, 64, 10, 1, 2, 40, 5, 7, 128]),
    (None, [3, 7, 5, 5, 9, 1]),  # without buckets: the step's longest target
])
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_pad_each_step_to_the_global_batchs_target_length(
        tmp_path, monkeypatch, buckets, lengths, world):
    module = _module(tmp_path, target_len_buckets=buckets)
    dataset = _Dataset(lengths)
    per_rank = [list(_rank_loader(module, dataset, monkeypatch, rank, world))
                for rank in range(world)]
    assert len({len(batches) for batches in per_rank}) == 1
    for step in zip(*per_rank):
        assert len({b["target_ids"].shape for b in step}) == 1  # one shape on every rank
        items = [dataset[int(t)] for b in step for t in b["target_text"]]
        whole = jax_dm.collate_fn(items, target_len_buckets=buckets)["target_ids"]
        # the rows of every rank are the rows of the JAX collate's one global batch
        np.testing.assert_array_equal(np.concatenate([b["target_ids"] for b in step]), whole)


@pytest.mark.parametrize("shuffle", [False, True])
def test_the_step_length_leaves_the_dealt_indices_as_they_were(shuffle):
    dataset = _Dataset([3, 60, 64, 10, 1, 2, 40, 5, 7], frames=[8, 8, 8, 8, 6, 6, 6, 6, 4])

    def sampler(rank, target_length):
        base = dm_mod.QuantizedBatchSampler(
            dm_mod.ByFrameCountSampler(dataset, max_frames_per_gpu=16, shuffle=shuffle,
                                       max_frames=8), 2, min_size=1, pad_remainder=True)
        return ShardedSampler(base, 2, rank, shuffle=shuffle, target_length=target_length)

    steps = [list(sampler(rank, dataset.target_length)) for rank in range(2)]
    for rank in range(2):
        assert [list(b) for b in steps[rank]] == [list(b) for b in sampler(rank, None)]
    for a, b in zip(*steps):
        assert isinstance(a, StepBatch) and a.target_len == b.target_len == max(
            dataset.lengths[i] for i in [*a, *b])


def test_one_rank_collates_as_before(tmp_path, monkeypatch):
    module = _module(tmp_path, target_len_buckets=(64, 128))
    dataset = _Dataset([3, 70, 64, 10])
    monkeypatch.setattr(dm_mod, "_data_shard", lambda n_model=1: (1, 0))
    sampler = module._get_sampler(dataset, 2, shuffle=False, max_frames=8)
    assert not isinstance(sampler, ShardedSampler)
    assert not any(isinstance(b, StepBatch) for b in sampler)
    loader = dm_mod.DataLoader(dataset, sampler, collate=module._collate, prefetch_batches=0)
    assert sorted(b["target_ids"].shape[1] for b in loader) == [64, 128]


def test_collate_pads_to_the_step_length_then_the_bucket():
    items = [{"target_ids": np.ones(n, np.int64), "target_text": ""} for n in (3, 5)]
    assert dm_mod.collate_fn(items)["target_ids"].shape == (2, 5)
    assert dm_mod.collate_fn(items, target_len=9)["target_ids"].shape == (2, 9)
    assert dm_mod.collate_fn(items, (64, 128), target_len=65)["target_ids"].shape == (2, 128)
    assert dm_mod.collate_fn(items, (64, 128), target_len=2)["target_ids"].shape == (2, 64)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        dm_mod.collate_fn(items, (64, 128), target_len=129)


def test_dataset_target_length_is_the_encoded_length(tmp_path):
    tok = ByteTokenizer()
    dataset = AVDataset(str(tmp_path), "train", "audiovisual", None, None, tokenizer=tok)
    dataset.samples = [{"text": "xin chao", "video_path": ""}, {"text": "x" * 600,
                                                                "video_path": ""}]
    assert dataset.target_length(0) == len(tok.encode("xin chao", max_length=448))
    assert dataset.target_length(1) == 448  # truncated as ``fetch`` truncates
    untokenized = AVDataset(str(tmp_path), "train", "audiovisual", None, None)
    untokenized.samples = dataset.samples
    assert untokenized.target_length(1) == 1  # ``fetch``'s one id without a tokenizer
