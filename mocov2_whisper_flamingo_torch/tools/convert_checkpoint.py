#!/usr/bin/env python
"""Convert pretrained torch checkpoints into the port's own state dicts.

    # HF Whisper (a local directory with pytorch_model.bin, or a .bin/.pt file)
    python -m mocov2_whisper_flamingo_torch.tools.convert_checkpoint \\
        --kind whisper --size whisper-small --input /path/to/model.bin \\
        --output converted/whisper_small.pt

    # MoCo v2 ResNet-50
    python -m mocov2_whisper_flamingo_torch.tools.convert_checkpoint \\
        --kind moco --input moco_v2_800ep_pretrain.pth.tar --output converted/moco.pt

Counterpart of the JAX package's ``tools/convert_checkpoint.py``, with its
flags. The JAX tool writes orbax; this one writes a file with
``torch.save`` (orbax would need JAX, which the port never imports):

- ``whisper``: the ``encoder.*`` / ``decoder.*`` state dict of
  ``models.asr.WhisperASR`` at ``--size``, which ``tools/serve.py``,
  ``tools/transcribe.py`` and ``WhisperASR.load_state_dict`` take whole;
- ``moco``: ``{"state_dict": ..., "conversion_report": ...}``, the
  ``MoCoVisualFrontend`` weights of the checkpoint's ResNet-50 blocks
  (``body.*``, each BatchNorm folded into its conv) and the report of
  blocks loaded and skipped. The stem is not in a MoCo checkpoint, and a
  skipped block is not in the state dict: load it with ``strict=False``,
  as ``AVNet.load_moco`` installs the same weights.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import torch

logger = logging.getLogger("convert_checkpoint")


def load_torch_state_dict(path: str):
    """The checkpoint at ``path`` (a directory is searched for
    ``pytorch_model.bin``, ``model.pt``, ``model.bin``); its ``state_dict``
    when it has one. Read with ``weights_only=True``: tensors and containers
    only."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.pt", "model.bin"):
            candidate = os.path.join(path, name)
            if os.path.exists(candidate):
                path = candidate
                break
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise SystemExit(
            f"{path} cannot be read with torch.load(weights_only=True): it holds objects other "
            "than tensors and containers; save its state dict alone") from e
    if isinstance(state, dict) and "state_dict" in state:
        return state["state_dict"]
    return state


def convert_whisper(state_dict, size: str) -> dict[str, torch.Tensor]:
    """An HF Whisper state dict -> the state dict of the port's
    ``WhisperASR(size)``."""
    from mocov2_whisper_flamingo_torch.models.convert import (
        from_jax_params, whisper_decoder_from_torch, whisper_encoder_from_torch)
    from mocov2_whisper_flamingo_torch.models.whisper import config_for

    cfg = config_for(size)
    tree = {"encoder": whisper_encoder_from_torch(state_dict, cfg.encoder_layers),
            "decoder": whisper_decoder_from_torch(state_dict, cfg.decoder_layers)}
    return {name: torch.from_numpy(value) for name, value in from_jax_params(tree).items()}


def convert_moco(checkpoint) -> dict:
    """A MoCo v2 checkpoint -> ``{"state_dict": frontend weights, BN
    folded, "conversion_report": {"blocks_loaded", "skipped"}}``."""
    from mocov2_whisper_flamingo_torch.models.convert import resnet50_from_moco

    weights, report = resnet50_from_moco(checkpoint)
    logger.info("MoCo conversion: %s blocks loaded, %d skipped",
                report["blocks_loaded"], len(report["skipped"]))
    return {"state_dict": {f"body.{name}": torch.from_numpy(value)
                           for name, value in weights.items()},
            "conversion_report": report}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kind", choices=["whisper", "moco"], required=True)
    parser.add_argument("--input", required=True, help="torch checkpoint path/dir")
    parser.add_argument("--output", required=True, help="output file (torch.save)")
    parser.add_argument("--size", default="whisper-small",
                        help="whisper size name (whisper kind only)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    state = load_torch_state_dict(args.input)
    out = convert_whisper(state, args.size) if args.kind == "whisper" else convert_moco(state)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.save(out, args.output)
    logger.info("wrote %s", args.output)
    print(f"CONVERTED {args.kind} -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
