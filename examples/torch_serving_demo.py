#!/usr/bin/env python
"""Online-serving demo of the PyTorch port: both engines over one model.

Builds a tiny AVWhisperNet with random weights and serves it two ways:

1. **Whole-utterance engine** (``serving.make_av_engine``): dynamic
   micro-batching over a ladder of batch sizes, the throughput engine.
2. **Continuous-batching engine** (``serving.make_continuous_av_engine``):
   the decode runs as a sequence of fixed segments over a pool of rows;
   a request is admitted into free rows at a segment boundary, so one that
   arrives mid-decode waits about one segment, not a whole bucket decode.

With random weights the tokens are noise, but the request lifecycle (submit
-> admission -> decode -> retire, with per-request queue / decode / total
latency) is the real one. Runs on the CUDA card, or on the CPU with
``--cpu``; tiny shapes, so the CPU finishes in well under a minute.

    python examples/torch_serving_demo.py [--cpu]

The twin of ``examples/serving_demo.py`` (the JAX package's demo). The
fusion and the Whisper stand-in use heads of 32: the flash-attention kernel
takes head dims 32, 64 and 128.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_tiny_net(device):
    from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_jax_params
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig

    vocab = 64
    tiny = WhisperConfig(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=1,
                         n_heads=2, d_ff=128, vocab_size=vocab, max_source_positions=1500,
                         max_target_positions=64)
    net = AVWhisperNet(modelargs=(64, 2, 2, 3000, 128, 0.0), vocab_size=vocab,
                       device=device, whisper_config=tiny)
    return load_jax_params(net, random_jax_params(net, 0))


def payload(rng, t_video: int = 8, hw: int = 64):
    return (
        np.asarray(rng.standard_normal((3000, 80)), np.float32),
        np.ones(3000, bool),
        rng.integers(0, 255, (t_video, 3, hw, hw)).astype(np.uint8),
        np.ones(t_video, bool),
        np.int32(t_video),
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args()

    from mocov2_whisper_flamingo_torch.device import resolve_device
    from mocov2_whisper_flamingo_torch.serving import make_av_engine, make_continuous_av_engine

    device = resolve_device("cpu" if args.cpu else "cuda")
    net = build_tiny_net(device)
    rng = np.random.default_rng(0)
    prefix, eos, max_len = [1, 2], 3, 32

    # -- 1. whole-utterance engine: batched throughput -------------------
    print(f"[1] whole-utterance engine (dynamic micro-batching) on {device}")
    eng = make_av_engine(net, prefix, beam_size=3, max_len=max_len, eos_id=eos,
                         buckets=(1, 4), video_resize=32)
    try:
        eng.warmup(payload(rng))
        futs = [eng.submit(*payload(rng)) for _ in range(4)]
        for i, f in enumerate(futs):
            r = f.result(timeout=600)
            print(f"    req{i}: bucket={r.bucket} queue={r.queue_ms:.0f}ms "
                  f"total={r.total_ms:.0f}ms tokens={[int(t) for t in r.tokens[:8]]}...")
    finally:
        eng.close()

    # -- 2. continuous engine: segment-bounded admission ------------------
    print("[2] continuous-batching engine (segment loop over a row pool)")
    ceng = make_continuous_av_engine(net, prefix, beam_size=3, max_len=max_len, eos_id=eos,
                                     capacity=4, seg_steps=8, video_resize=32)
    try:
        ceng.warmup(payload(rng), encode_buckets=(1, 2, 4))
        # Two requests now; a third arrives while they are mid-decode and is
        # admitted at the next segment boundary, not after a whole decode.
        futs = [ceng.submit(*payload(rng)) for _ in range(2)]
        time.sleep(0.05)
        late = ceng.submit(*payload(rng))
        for i, f in enumerate(futs):
            r = f.result(timeout=600)
            print(f"    req{i}: queue={r.queue_ms:.0f}ms "
                  f"decode={r.decode_ms:.0f}ms total={r.total_ms:.0f}ms")
        r = late.result(timeout=600)
        print(f"    late: queue={r.queue_ms:.0f}ms (admitted mid-decode) "
              f"total={r.total_ms:.0f}ms tokens={[int(t) for t in r.tokens[:8]]}...")
        print(f"    engine stats: {ceng.stats()}")
    finally:
        ceng.close()
    print("done.")


if __name__ == "__main__":
    main()
