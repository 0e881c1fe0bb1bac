#!/usr/bin/env python
"""Training entry point of the port (counterpart of the root ``train.py``):
config -> tokenizer -> data module -> AVNet -> Trainer (top-k checkpoints,
early stopping, LR logging) -> fit -> test, on one CUDA card.

Usage:
  python -m mocov2_whisper_flamingo_torch.train --smoke          # 2-step synthetic run
  python -m mocov2_whisper_flamingo_torch.train --smoke --set model.d_model=256
  python -m mocov2_whisper_flamingo_torch.train --smoke --device cpu

Without ``--smoke`` the run needs the data module, which is not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.config import add_config_flags, config_from_args
from mocov2_whisper_flamingo_torch.utils.logging_utils import setup_logging

logger = logging.getLogger("train")


def build_net(config, vocab_size: int, device: str | torch.device | None = "cuda"):
    """The AVNet the config describes, on ``device``, with random weights
    drawn from ``training.seed`` (the JAX ``init`` distributions)."""
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_net import AVNet
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params

    model = config["model"]
    model_args = (model["d_model"], model["n_heads"], model["n_layers"], model["pe_max_len"],
                  model["fc_hidden_size"], model["dropout"])
    precision = L.BF16 if config["precision"]["compute_dtype"] == "bfloat16" else L.FP32
    net = AVNet(
        modal=config["data"]["modality"],
        MoCofile=None,  # checkpoint loaders are not ported yet: random weights
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
    return load_jax_params(net, tree)


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
    args = parser.parse_args(argv)

    config = config_from_args(args)
    setup_logging()
    if not args.smoke:
        print("train: only --smoke runs so far: the data module (datamodule/*) and the "
              "checkpoint loaders are not ported yet", file=sys.stderr)
        return 2

    from mocov2_whisper_flamingo_torch.training.trainer import Trainer
    from mocov2_whisper_flamingo_torch.utils.tokenizer import load_tokenizer

    config.set_dotted("training.epochs", 1)
    config.set_dotted("training.accumulate_grad_batches", 1)
    config.set_dotted("output.log_every_n_steps", 1)
    config.set_dotted("mesh.model", 1)
    # shrink the model so the smoke run is quick
    config.set_dotted("whisper.model_name", "whisper-tiny")
    config.set_dotted("model.d_model", 64)
    # 2 heads of 32: the flash-attention kernels take head dims 32, 64 and 128
    config.set_dotted("model.n_heads", 2)
    config.set_dotted("model.fc_hidden_size", 128)
    tokenizer = load_tokenizer(None)
    datamodule = _SmokeDataModule(tokenizer)
    vocab_size = len(tokenizer)

    logger.info("vocab size = %d", vocab_size)
    net = build_net(config, vocab_size, args.device)
    trainer = Trainer(config, net, tokenizer, device=args.device)

    logger.info("starting training...")
    trainer.fit(datamodule, max_steps=args.max_steps or 2, resume=args.resume)

    logger.info("starting testing...")
    metrics = trainer.test(datamodule)
    logger.info("test metrics: %s", metrics)
    logger.info("training and testing completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
