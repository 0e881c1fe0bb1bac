"""One rank of a multi-process run of the port's trainer over gloo on the CPU.

    python tests/torch_multicard_worker.py SPEC RANK

``SPEC`` is a pickle written by the test that starts the ranks:
``{"init": "file://...", "world": N, "workdir": ..., "states": {vocab:
state_dict arrays}, "batches": {key: [global batch, ...]}, "cases": [...]}``.
Each case builds the tiny ``AVNet`` from ``states[case["vocab"]]``, runs
``Trainer.fit`` on the case's mesh with a data module that hands each data
index its rows of the global batches (``parallel.shard_batch``), and writes
``{workdir}/{case}.rank{R}.pkl``: the whole (gathered) parameters, the
scalars rank 0 logged, the optimizer's count, and ``test`` metrics when
asked. Imports torch and the port only. Exits non-zero on any failure, so
that the test fails instead of waiting for this rank.
"""

import os
import pickle
import sys
import traceback

import torch

from mocov2_whisper_flamingo_torch.config import get_config
from mocov2_whisper_flamingo_torch.models.av_net import AVNet
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig
from mocov2_whisper_flamingo_torch.parallel import (
    gather_state_dict, initialize_distributed, shard_batch)
from mocov2_whisper_flamingo_torch.training.trainer import Trainer
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer

TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            max_source_positions=64, max_target_positions=32)
MODELARGS = (32, 4, 2, 3000, 128, 0.0)


class Recorder:
    def __init__(self, path):
        self.path, self.scalars = path, []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


class ShardedDataModule:
    """Global batches; each data index iterates over its rows of them."""

    def __init__(self, batches, mesh):
        self.batches = [shard_batch(mesh, b) for b in batches]

    def train_dataloader(self):
        class Loader(list):
            def set_epoch(self, epoch):
                pass

        return Loader(dict(b) for b in self.batches)

    def val_dataloader(self):
        return [dict(self.batches[0])]

    test_dataloader = val_dataloader


def run_case(spec, case, rank):
    workdir = os.path.join(spec["workdir"], case["name"])
    config = get_config({
        "training.epochs": case.get("epochs", 1), "training.accumulate_grad_batches": 2,
        "training.max_lr": 1e-3, "model.dropout": 0.0, "precision.compute_dtype": "float32",
        "precision.rematerialize": False, "output.log_every_n_steps": 1,
        "output.checkpoint_dir": os.path.join(workdir, "ckpt"),
        "output.log_dir": os.path.join(workdir, "logs"), "mesh.data": case["mesh"][0],
        "mesh.model": case["mesh"][1], **case.get("overrides", {})})
    vocab = case["vocab"]
    net = AVNet("audiovisual", None, 96, MODELARGS, vocab, device="cpu",
                whisper_config=WhisperConfig(vocab_size=vocab, **TINY))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in spec["states"][vocab].items()})
    trainer = Trainer(config, net, ByteTokenizer(), device="cpu")
    if trainer.is_chief:
        trainer.writer = Recorder(trainer.writer.path)
    dm = ShardedDataModule(spec["batches"][case["batches"]], trainer.mesh)
    resume = case.get("resume")
    if resume:
        resume = os.path.join(spec["workdir"], resume)
    trainer.fit(dm, max_steps=case["max_steps"], resume=resume)
    out = {"params": {k: v.numpy() for k, v in gather_state_dict(net, trainer.mesh).items()},
           "scalars": getattr(trainer.writer, "scalars", None),
           "count": trainer.optimizer.count, "step": trainer.global_step,
           "mesh": (trainer.mesh.data_index, trainer.mesh.model_index)}
    if case.get("test"):
        out["test"] = trainer.test(dm)
    with open(os.path.join(spec["workdir"], f"{case['name']}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def main(spec_path, rank):
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    initialize_distributed(spec["init"], spec["world"], rank, backend="gloo", timeout_s=60)
    for case in spec["cases"]:
        run_case(spec, case, rank)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # at once: a rank left waiting on this one times out
