#!/usr/bin/env python
"""Batched evaluation: dataset -> decode -> WER report (+ predictions dump).

Counterpart of the JAX package's ``tools/evaluate.py``, with its flags plus
``--device`` (the CUDA card unless ``cpu`` is asked for) and ``--seed``:

- ``--mode ctc-greedy``: per-frame argmax over ``AVNet``'s linear head
  (the reference's decode; 15 attention-kernel calls a batch: 12 encoder
  layers and 3 fusion blocks at full width);
- ``--mode beam``: KV-cached beam search through the Whisper decoder
  (``AVWhisperNet.beam``), ``--beam-size`` beams, with the suppress lists
  and forced ids of ``--generation-config`` (and ``--timestamps``) through
  ``LogitRules``.

``--checkpoint`` is a file written by ``torch.save``: a trainer checkpoint
(``{"params", "opt_state", "step"}``) or a bare ``state_dict`` of the net.
Without it the weights are random, made from ``--seed``.

Runs data-parallel over the processes of ``torch.distributed`` (started by
torchrun; one process per card): each data index decodes its own rows (the
data module deals the batches), and rank 0 reports one WER over the rows of
every data index, in global-batch order. It prints the JAX tool's JSON line::

    python -m mocov2_whisper_flamingo_torch.tools.evaluate \\
        --set data.root_dir=/data/avsr --mode beam --checkpoint ckpt/step_100.pt
    torchrun --nproc_per_node 2 -m mocov2_whisper_flamingo_torch.tools.evaluate \\
        --set data.root_dir=/data/avsr --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

logger = logging.getLogger("evaluate")

_INPUT_KEYS = ("audio", "audio_mask", "video", "video_mask", "video_lengths")


def _loader(datamodule, split: str):
    return datamodule.test_dataloader() if split == "test" else datamodule.val_dataloader()


def _decode(loader, predict, tokenizer, device) -> list[tuple[list[str], list[str]]]:
    """``(references, hypotheses)`` of every batch of this rank."""
    out = []
    for batch in loader:
        texts = list(batch.get("target_text", []))
        inputs = tuple(torch.as_tensor(np.asarray(batch[k])).to(device) for k in _INPUT_KEYS)
        with torch.no_grad():
            preds = predict(inputs)
        out.append((texts, tokenizer.batch_decode(preds.cpu().numpy(),
                                                  skip_special_tokens=True)))
    return out


def _report(per_batch, mesh) -> dict:
    """One report over the rows of every data index: each batch's rows in
    data-index order, as the global batches are laid out."""
    from mocov2_whisper_flamingo_torch.utils.wer import wer as corpus_wer

    if mesh is not None and mesh.data_group is not None:
        everyone = [None] * mesh.shape["data"]
        torch.distributed.all_gather_object(everyone, per_batch, group=mesh.data_group)
        per_batch = [([t for r in everyone for t in r[i][0]], [h for r in everyone for h in r[i][1]])
                     for i in range(len(per_batch))]
    refs = [t for texts, _ in per_batch for t in texts]
    hyps = [h for _, decoded in per_batch for h in decoded]
    return {"wer": corpus_wer(refs, hyps), "n": len(refs), "refs": refs, "hyps": hyps}


def _device(net) -> torch.device:
    return next(net.parameters()).device


def evaluate_ctc_greedy(net, datamodule, tokenizer, split: str = "test", mesh=None) -> dict:
    """Greedy per-frame argmax over ``net`` (an ``AVNet``) on the split's
    loader; ``mesh``: the data-parallel mesh whose rows to gather."""
    per_batch = _decode(_loader(datamodule, split), lambda x: net(x).argmax(dim=-1),
                        tokenizer, _device(net))
    return _report(per_batch, mesh)


def evaluate_beam(net, datamodule, tokenizer, beam_size: int = 5, max_len: int = 224,
                  split: str = "test", logit_rules=None, mesh=None) -> dict:
    """The best beam of ``net.beam`` (an ``AVWhisperNet``) per row."""
    prefix, eos = tokenizer.prefix_token_ids, tokenizer.eos_token_id
    predict = lambda x: net.beam(x, prefix, beam_size=beam_size, max_len=max_len, eos_id=eos,
                                 logit_rules=logit_rules).sequences[:, 0]
    return _report(_decode(_loader(datamodule, split), predict, tokenizer, _device(net)), mesh)


def restore_params(net, checkpoint_path: str) -> None:
    """Install the weights of a ``torch.save``'d checkpoint into ``net``: a
    trainer checkpoint's ``params`` (whole, however many cards wrote it) or
    a bare ``state_dict``."""
    if os.path.isdir(checkpoint_path):
        raise SystemExit(
            f"--checkpoint {checkpoint_path!r} is a directory (an orbax checkpoint of the JAX "
            "package?): this command reads a torch.save'd state_dict; convert the source torch "
            "checkpoint with tools/convert_checkpoint (python -m "
            "mocov2_whisper_flamingo_torch.tools.convert_checkpoint); orbax stays out of the "
            "port, which imports no JAX (ROADMAP.md Queue 1 item 14)")
    state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    net.load_state_dict(state.get("params", state), strict=True)


def write_predictions(report: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for pred, ref in zip(report["hyps"], report["refs"]):
            f.write(f"Pred: {pred}\nTarget: {ref}\n")


def build_beam_net(config, vocab_size: int, device, seed: int = 0):
    """The ``AVWhisperNet`` the config describes, random weights from ``seed``."""
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_jax_params

    model = config["model"]
    net = AVWhisperNet(
        modelargs=(model["d_model"], model["n_heads"], model["n_layers"], model["pe_max_len"],
                   model["fc_hidden_size"], model["dropout"]),
        vocab_size=vocab_size, whisper_name=config["whisper"]["model_name"],
        precision=L.BF16 if config["precision"]["compute_dtype"] == "bfloat16" else L.FP32,
        device=device)
    return load_jax_params(net, random_jax_params(net, seed))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    from mocov2_whisper_flamingo_torch.config import add_config_flags, config_from_args

    add_config_flags(parser)
    parser.add_argument("--mode", choices=["ctc-greedy", "beam"], default="ctc-greedy")
    parser.add_argument("--split", choices=["val", "test"], default="test")
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--predictions-out", default=None)
    parser.add_argument(
        "--generation-config", default=None,
        help="path to an HF generation_config.json: applies its suppress_tokens / "
             "begin_suppress_tokens / forced ids during beam decode")
    parser.add_argument("--timestamps", action="store_true",
                        help="enable the Whisper timestamp grammar (requires "
                             "--generation-config)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights when no --checkpoint is given")
    args = parser.parse_args(argv)
    config = config_from_args(args)
    config.set_dotted("mesh.model", 1)  # evaluation is data-parallel only
    logging.basicConfig(level=logging.INFO)

    from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule
    from mocov2_whisper_flamingo_torch.parallel import initialize_distributed, make_mesh
    from mocov2_whisper_flamingo_torch.train import build_net, rank_device

    device = rank_device(args.device)
    if torch.device(device).index is not None:  # torchrun: this process's card
        torch.cuda.set_device(torch.device(device))
    initialize_distributed(backend=None if torch.device(device).type == "cuda" else "gloo")
    mesh = make_mesh()

    datamodule = DataModule(config)
    datamodule.setup()
    tokenizer = datamodule.tokenizer
    if args.mode == "ctc-greedy":
        config.set_dotted("training.seed", args.seed)
        net = build_net(config, datamodule.vocab_size, device)
    else:
        net = build_beam_net(config, datamodule.vocab_size, device, args.seed)
    if args.checkpoint:
        restore_params(net, args.checkpoint)
    net.eval()

    if args.mode == "ctc-greedy":
        report = evaluate_ctc_greedy(net, datamodule, tokenizer, args.split, mesh)
    else:
        rules = None
        if args.generation_config:
            from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules

            with open(args.generation_config, encoding="utf-8") as f:
                rules = LogitRules.for_whisper(json.load(f), vocab_size=datamodule.vocab_size,
                                               timestamps=args.timestamps)
        report = evaluate_beam(net, datamodule, tokenizer, args.beam_size, split=args.split,
                               logit_rules=rules, mesh=mesh)

    if mesh.rank == 0:
        if args.predictions_out:
            write_predictions(report, args.predictions_out)
        print(json.dumps({"mode": args.mode, "split": args.split,
                          "wer": report["wer"], "n": report["n"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
