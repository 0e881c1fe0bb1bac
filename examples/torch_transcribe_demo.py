#!/usr/bin/env python
"""Long-form transcription demo of the PyTorch port: the whole user journey
on one file.

Writes a synthetic WAV, builds a whisper-tiny ``WhisperASR`` with random
weights, and runs the openai-``transcribe``-shaped pipeline end to end: the
quality window loop with temperature fallback, language detection, word
times from the cross-attention DTW (native C++ path), and the txt / srt /
vtt / json writers. With converted HF weights
(``tools/convert_checkpoint.py --kind whisper``, then
``WhisperASR.load_state_dict``) the same script gives real transcripts;
offline it shows the plumbing. Runs on the CUDA card, or on the CPU with
``--cpu``.

    python examples/torch_transcribe_demo.py [--outdir /tmp/transcribe_demo] [--cpu]

The twin of ``examples/transcribe_demo.py`` (the JAX package's demo).
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--outdir", default="/tmp/transcribe_demo")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args()

    from mocov2_whisper_flamingo_torch.device import resolve_device
    from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_asr_params
    from mocov2_whisper_flamingo_torch.tools.transcribe import default_group_fn
    from mocov2_whisper_flamingo_torch.utils.tokenizer import load_tokenizer
    from mocov2_whisper_flamingo_torch.utils.writers import get_writer

    device = resolve_device("cpu" if args.cpu else "cuda")
    os.makedirs(args.outdir, exist_ok=True)

    # 1. synthesize audio (a chirp with pauses) and write a real wav
    sr = 16_000
    t = np.arange(int(args.seconds * sr)) / sr
    wav_f = (0.3 * np.sin(2 * np.pi * (220 + 60 * t) * t)
             * (np.sin(2 * np.pi * 0.5 * t) > -0.3)).astype(np.float32)
    wav_path = os.path.join(args.outdir, "demo.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((wav_f * 32767).astype("<i2").tobytes())
    print(f"[1] wrote {wav_path} ({args.seconds:.1f}s)")

    # 2. model + tokenizer (random weights offline)
    tokenizer = load_tokenizer(None)
    model = WhisperASR("whisper-tiny", device=device)
    load_jax_params(model, random_asr_params(model, 0))
    print(f"[2] whisper-tiny on {device} "
          f"({sum(p.numel() for p in model.parameters()):,} params)")

    # 3. transcribe: quality loop + language detection + word times
    prefix = list(tokenizer.prefix_token_ids)
    out = model.transcribe(
        wav_f, prefix, tokenizer=tokenizer, beam_size=2, best_of=2, max_len=16,
        eos_id=tokenizer.eos_token_id, chunk_seconds=2.0, temperatures=(0.0, 0.5),
        logprob_threshold=None, compression_ratio_threshold=2.4,
        detect_language_ids=[2],  # ByteTokenizer <|vi|>
        word_times=True, group_fn=default_group_fn(tokenizer))
    print(f"[3] transcribed: {len(out['tokens'])} tokens, "
          f"{len(out['segments'])} segments, "
          f"{len(out['words'] or [])} words, language token {out['language']}")

    # 4. write every transcript format
    for fmt in ("txt", "srt", "vtt", "json"):
        path = os.path.join(args.outdir, f"demo.{fmt}")
        with open(path, "w", encoding="utf-8") as fh:
            get_writer(fmt)(out, fh)
        print(f"[4] wrote {path}")
    print("done")


if __name__ == "__main__":
    main()
