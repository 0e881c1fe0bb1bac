#!/usr/bin/env python
"""Training entry point of the port (counterpart of the root ``train.py``):
config -> tokenizer -> data module -> AVNet -> Trainer (top-k checkpoints,
early stopping, LR logging) -> fit -> test, one process per CUDA card.

Usage:
  python -m mocov2_whisper_flamingo_torch.train --set data.root_dir=/data/avsr
  python -m mocov2_whisper_flamingo_torch.train --set data.root_dir=/data/avsr \
      --set augmentation.on_device=true --set augmentation.on_device_mel=true
  python -m mocov2_whisper_flamingo_torch.train --smoke          # 2-step synthetic run
  python -m mocov2_whisper_flamingo_torch.train --smoke --device cpu
  python -m mocov2_whisper_flamingo_torch.train --smoke --profile logs/profile
  # 4 cards, data 2 x model 2 (NCCL), or 2 CPU processes over gloo:
  torchrun --nproc_per_node 4 -m mocov2_whisper_flamingo_torch.train \
      --set data.root_dir=/data/avsr --set mesh.data=2 --set mesh.model=2
  torchrun --nproc_per_node 2 -m mocov2_whisper_flamingo_torch.train --smoke \
      --device cpu --set mesh.data=2

Under torchrun each process joins the process group
(``parallel.initialize_distributed``) before the net is built and takes the
card ``cuda:{LOCAL_RANK}``; ``config["mesh"]`` lays the processes out.

The dataset lies under ``data.root_dir`` as
``{split}/{split}_video_seg12s/<folder>/<clip>.{npy,npz,mp4}`` with a sibling
``<clip>.wav`` and the text in ``{split}/{split}_text_seg12s/<folder>/<clip>.txt``
for the splits train, val and test. ``data.moco_file`` names a MoCo v2
checkpoint for the lip frontend (skipped with a warning when missing); the
Whisper encoder starts from random weights, as in the JAX package's
``train.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.config import add_config_flags, config_from_args
from mocov2_whisper_flamingo_torch.utils.logging_utils import setup_logging

logger = logging.getLogger("train")


def build_net(config, vocab_size: int, device: str | torch.device | None = "cuda",
              moco_file: str | None = None):
    """The AVNet the config describes, on ``device``, with random weights
    drawn from ``training.seed`` (the JAX ``init`` distributions); then, as
    the JAX ``AVNet.init`` does, the layers of the MoCo v2 checkpoint
    ``moco_file`` over the frontend's when the file exists."""
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_net import AVNet
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params

    model = config["model"]
    model_args = (model["d_model"], model["n_heads"], model["n_layers"], model["pe_max_len"],
                  model["fc_hidden_size"], model["dropout"])
    precision = L.BF16 if config["precision"]["compute_dtype"] == "bfloat16" else L.FP32
    net = AVNet(
        modal=config["data"]["modality"],
        MoCofile=None,  # loaded below, over the random weights
        reqInpLen=model["required_input_length"],
        modelargs=model_args,
        vocab_size=vocab_size,
        enable_logging=config["output"]["enable_logging"],
        whisper_name=config["whisper"]["model_name"],
        precision=precision,
        device=device,
        remat=bool(config["precision"].get("rematerialize", False)),
    )
    tree = random_avnet_params(net, int(config["training"].get("seed", 0)))
    load_jax_params(net, tree)
    if moco_file:
        net.load_moco(moco_file)
    return net


def rank_device(device: str) -> str:
    """The device of this process: under torchrun (``LOCAL_RANK`` set) a
    CUDA device is the card ``cuda:{LOCAL_RANK}``. Raises when
    ``LOCAL_RANK`` names a card the host does not have: processes never
    share a card silently."""
    local = os.environ.get("LOCAL_RANK")
    if local is None or torch.device(device).type != "cuda":
        return device
    cards = torch.cuda.device_count()
    if int(local) >= cards:
        raise ValueError(f"LOCAL_RANK={local} but this host has {cards} CUDA card(s): "
                         "start one process per card")
    return f"cuda:{int(local)}"


class _SmokeDataModule:
    """Synthetic in-memory data for --smoke (no dataset needed)."""

    def __init__(self, tokenizer, n_batches=2, b=2, t_video=8):
        rng = np.random.default_rng(0)
        self.batches = []
        for _ in range(n_batches):
            texts = [f"smoke test {j}" for j in range(b)]
            enc = [tokenizer.encode(t, max_length=16) for t in texts]
            ids = np.zeros((b, max(len(e) for e in enc)), np.int64)
            lens = np.zeros((b,), np.int32)
            for j, e in enumerate(enc):
                ids[j, : len(e)] = e
                lens[j] = len(e)
            self.batches.append({
                "audio": rng.standard_normal((b, 3000, 80)).astype(np.float32),
                "audio_mask": np.ones((b, 3000), bool),
                "audio_lengths": np.full((b,), 64, np.int32),
                "video": rng.standard_normal((b, t_video, 3, 64, 64)).astype(np.float32),
                "video_mask": np.ones((b, t_video), bool),
                "video_lengths": np.full((b,), t_video, np.int32),
                "target_ids": ids,
                "target_lengths": lens,
                "target_text": texts,
            })

    class _L(list):
        def set_epoch(self, e):
            pass

    def train_dataloader(self):
        return self._L(self.batches)

    def val_dataloader(self):
        return self._L(self.batches[:1])

    def test_dataloader(self):
        return self._L(self.batches[:1])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_flags(parser)
    parser.add_argument("--smoke", action="store_true",
                        help="2-step synthetic run (sanity check)")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint path to resume from ('last' for the last one)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="trace the fit with torch.profiler into DIR (one trace per rank)")
    args = parser.parse_args(argv)

    config = config_from_args(args)
    setup_logging()

    from mocov2_whisper_flamingo_torch.parallel import initialize_distributed

    device = rank_device(args.device)
    if torch.device(device).index is not None:  # torchrun: this process's card
        torch.cuda.set_device(torch.device(device))
    initialize_distributed(backend=None if torch.device(device).type == "cuda" else "gloo")

    from mocov2_whisper_flamingo_torch.training.trainer import Trainer
    from mocov2_whisper_flamingo_torch.utils.tokenizer import load_tokenizer

    if args.smoke:
        config.set_dotted("training.epochs", 1)
        config.set_dotted("training.accumulate_grad_batches", 1)
        config.set_dotted("output.log_every_n_steps", 1)
        # shrink the model so the smoke run is quick
        config.set_dotted("whisper.model_name", "whisper-tiny")
        config.set_dotted("model.d_model", 64)
        # 2 heads of 32: the flash-attention kernels take head dims 32, 64 and 128
        config.set_dotted("model.n_heads", 2)
        config.set_dotted("model.fc_hidden_size", 128)
        tokenizer = load_tokenizer(None)
        datamodule = _SmokeDataModule(tokenizer)
        vocab_size = len(tokenizer)
    else:
        from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule

        datamodule = DataModule(config)
        datamodule.setup()
        if not len(datamodule.train_dataset):
            print(f"train: the data module found no training clip under "
                  f"{datamodule.train_dataset.video_dir} with its text in "
                  f"{datamodule.train_dataset.text_dir}; set data.root_dir", file=sys.stderr)
            return 2
        tokenizer = datamodule.tokenizer
        vocab_size = datamodule.vocab_size

    logger.info("vocab size = %d", vocab_size)
    net = build_net(config, vocab_size, device, moco_file=config["data"]["moco_file"])
    trainer = Trainer(config, net, tokenizer, device=device)

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from mocov2_whisper_flamingo_torch.utils.profiling import trace

        profile_ctx = trace(args.profile)

    logger.info("starting training...")
    with profile_ctx:
        trainer.fit(datamodule, max_steps=args.max_steps or (2 if args.smoke else None),
                    resume=args.resume)

    logger.info("starting testing...")
    metrics = trainer.test(datamodule)
    logger.info("test metrics: %s", metrics)
    logger.info("training and testing completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
