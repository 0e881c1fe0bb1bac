"""Serve transcription over HTTP with dynamic batching.

    python -m mocov2_whisper_flamingo_torch.tools.serve \\
        --model whisper-small --checkpoint asr.pt --tokenizer TW_tokenizer \\
        --host 0.0.0.0 --port 8000 --buckets 1,2,4,8,16 --max-wait-ms 5

Counterpart of the JAX package's ``tools/serve.py``, with its flags plus
``--device`` (the CUDA card unless ``cpu`` is asked for), ``--precision`` and
``--seed``. Requests are micro-batched into a fixed ladder of batch sizes and
run through the beam decode (``serving/engine.py``); every bucket is warmed
at start-up so that live traffic never waits for a kernel build.

``--checkpoint`` is a file written by ``torch.save``: the ``state_dict`` of
the port's ``WhisperASR``, or an HF Whisper ``state_dict``. ``--random-init``
serves random weights made from ``--seed`` (smoke runs).

    curl -s localhost:8000/v1/transcribe \\
        -d '{"audio": [0.0, 0.01, ...]}'     # 16 kHz float samples
    curl -s localhost:8000/metrics
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PRECISIONS = ("fp32", "bf16")


def load_checkpoint(model, path: str) -> None:
    """Install the weights in ``path`` into ``model`` (a ``WhisperASR``)."""
    import torch

    if os.path.isdir(path):
        raise SystemExit(
            f"--checkpoint {path!r} is a directory (an orbax checkpoint of the JAX package?): "
            "this command reads a torch.save'd state_dict; converting an orbax checkpoint is "
            "the job of tools/convert_checkpoint, which is not ported yet (ROADMAP.md Queue 1 "
            "item 14)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    if any(key.endswith(".kernel") for key in state):  # the port's own names
        model.load_state_dict(state, strict=True)
    else:
        model.load_whisper_torch(state)


def build_model(args):
    """The ``WhisperASR`` that ``--model``, ``--precision`` and ``--device``
    name, with the weights of ``--checkpoint`` or random ones from
    ``--seed``."""
    from mocov2_whisper_flamingo_torch.device import resolve_device
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_asr_params

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    model = WhisperASR(args.model, precision=L.BF16 if args.precision == "bf16" else L.FP32,
                       device=device)
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint)
    else:
        load_jax_params(model, random_asr_params(model, args.seed))
    return model.eval()


def build_engine(args):
    import numpy as np

    from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules
    from mocov2_whisper_flamingo_torch.serving import canonical_wav, make_audio_engine
    from mocov2_whisper_flamingo_torch.utils.tokenizer import load_tokenizer

    model = build_model(args)
    device = model.device
    tokenizer = load_tokenizer(args.tokenizer, language=args.language, task=args.task)

    logit_rules = None
    if args.generation_config:
        with open(args.generation_config, encoding="utf-8") as f:
            logit_rules = LogitRules.for_whisper(json.load(f), model.config.vocab_size)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = make_audio_engine(
        model, list(tokenizer.prefix_token_ids), tokenizer=tokenizer,
        beam_size=args.beam_size, max_len=args.max_len,
        eos_id=int(tokenizer.eos_token_id), logit_rules=logit_rules,
        buckets=buckets, max_wait_s=args.max_wait_ms / 1e3)
    if not args.no_warmup:
        print(f"[serve] warming {len(buckets)} buckets {buckets} on {device} ...",
              file=sys.stderr)
        try:
            engine.warmup((canonical_wav(np.zeros(16_000, np.float32)),))
        except BaseException:
            engine.close()
            raise
        print("[serve] warm", file=sys.stderr)
    return engine


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="whisper-base")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--random-init", action="store_true",
                        help="random weights from --seed (smoke runs; no checkpoint)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--language", default="vietnamese")
    parser.add_argument("--task", default="transcribe",
                        choices=("transcribe", "translate"))
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--max-len", type=int, default=224)
    parser.add_argument("--generation-config", default=None)
    parser.add_argument("--buckets", default="1,2,4,8,16",
                        help="batch bucket ladder (each is warmed at start-up)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="micro-batch deadline: how long a request may "
                             "wait for requests that can share its batch")
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument("--precision", default="fp32", choices=PRECISIONS)
    args = parser.parse_args(argv)
    if not args.checkpoint and not args.random_init:
        parser.error("need --checkpoint (or --random-init for smoke runs)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from mocov2_whisper_flamingo_torch.serving import TranscriptionServer

    engine = build_engine(args)
    try:
        with TranscriptionServer(engine, host=args.host, port=args.port) as srv:
            host, port = srv.address
            print(f"[serve] listening on http://{host}:{port}", file=sys.stderr, flush=True)
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                print("[serve] shutting down", file=sys.stderr)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
