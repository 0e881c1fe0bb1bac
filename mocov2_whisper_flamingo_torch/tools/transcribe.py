"""Transcribe audio files from the command line (openai ``whisper`` CLI).

    python -m mocov2_whisper_flamingo_torch.tools.transcribe audio.wav \\
        --model whisper-small --checkpoint asr.pt --tokenizer TW_tokenizer \\
        --output-format srt --output-dir out/

Counterpart of the JAX package's ``tools/transcribe.py``, with its flags plus
``--device`` (the CUDA card unless ``cpu`` is asked for), ``--precision`` and
``--seed``. Audio: ``.wav`` (the port's native reader, resampled to 16 kHz
with its windowed sinc) or ``.npy`` (a float waveform at 16 kHz). Weights:
``--checkpoint`` is a file written by ``torch.save`` (the ``state_dict`` of
the port's ``WhisperASR``, or an HF Whisper ``state_dict``); ``--random-init``
takes random weights made from ``--seed`` (smoke runs). Decoding runs the
quality window loop (temperature fallback and gates; sampled rungs draw from
``--seed``) unless ``--streaming`` asks for the persistent-cache decode;
``--word-timestamps`` adds DTW word times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mocov2_whisper_flamingo_torch.tools.serve import PRECISIONS, build_model


def load_audio(path: str, sample_rate: int = 16_000):
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path).astype(np.float32).reshape(-1)
    from mocov2_whisper_flamingo_torch.datamodule import native

    wav, sr = native.read_wav_mono(path)
    if sr != sample_rate:
        wav = native.resample(wav, sr, sample_rate)
    return wav.astype("float32")


def default_group_fn(tokenizer):
    """openai's word grouping (``split_tokens_on_spaces``): a unicode-safe
    subword split (one multi-byte character split across byte tokens stays
    one piece), then a new word at a leading space or a punctuation piece.
    Words keep their leading space; the writers strip it."""
    from mocov2_whisper_flamingo_torch.decode.timestamps import split_tokens_on_spaces

    def group(token_ids):
        return [(word, len(toks)) for word, toks in split_tokens_on_spaces(tokenizer, token_ids)]

    return group


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("audio", nargs="+", help=".wav or .npy file(s)")
    parser.add_argument("--model", default="whisper-base")
    parser.add_argument("--checkpoint", default=None,
                        help="torch.save'd state_dict of WhisperASR or of an HF Whisper")
    parser.add_argument("--random-init", action="store_true",
                        help="random weights from --seed (smoke runs; no checkpoint)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and of the sampled rungs' draws")
    parser.add_argument("--tokenizer", default=None,
                        help="tokenizer dir (utils.load_tokenizer); default byte-fallback "
                             "tokenizer")
    parser.add_argument("--language", default="vietnamese")
    parser.add_argument("--task", default="transcribe", choices=("transcribe", "translate"))
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--streaming", action="store_true",
                        help="persistent-cache streaming decode instead of the quality window "
                             "loop")
    parser.add_argument("--temperature", type=float, nargs="+",
                        default=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0))
    parser.add_argument("--word-timestamps", action="store_true")
    parser.add_argument("--initial-prompt", default=None,
                        help="conditioning text for the first window (openai --initial_prompt)")
    parser.add_argument("--highlight-words", action="store_true",
                        help="srt/vtt: one cue per word with the active word underlined (needs "
                             "--word-timestamps)")
    parser.add_argument("--max-words-per-line", type=int, default=None,
                        help="srt/vtt: at most N words per cue (needs --word-timestamps)")
    parser.add_argument("--generation-config", default=None,
                        help="path to an HF generation_config.json: applies its suppress/"
                             "begin-suppress/forced token rules during decoding")
    parser.add_argument("--timestamps", action="store_true",
                        help="enable the Whisper timestamp grammar (requires "
                             "--generation-config): segments split at predicted timestamp "
                             "pairs and windows seek to the last timestamp (openai loop)")
    parser.add_argument("--output-format", default="txt",
                        choices=("txt", "srt", "vtt", "tsv", "json", "all"))
    parser.add_argument("--output-dir", default=".")
    parser.add_argument("--max-len", type=int, default=448)
    parser.add_argument("--chunk-seconds", type=float, default=30.0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument("--precision", default="fp32", choices=PRECISIONS)
    args = parser.parse_args(argv)
    if not args.checkpoint and not args.random_init:
        parser.error("need --checkpoint (or --random-init for smoke runs)")
    if args.timestamps and not args.generation_config:
        parser.error("--timestamps requires --generation-config")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules
    from mocov2_whisper_flamingo_torch.utils.tokenizer import load_tokenizer
    from mocov2_whisper_flamingo_torch.utils.writers import WRITER_FORMATS, get_writer

    model = build_model(args)  # raises without a card unless --device cpu
    tokenizer = load_tokenizer(args.tokenizer, language=args.language, task=args.task)

    prefix = list(tokenizer.prefix_token_ids)
    eos = int(tokenizer.eos_token_id)
    logit_rules = None
    if args.generation_config:
        with open(args.generation_config, encoding="utf-8") as f:
            logit_rules = LogitRules.for_whisper(json.load(f), model.config.vocab_size,
                                                 timestamps=args.timestamps)
    formats = WRITER_FORMATS if args.output_format == "all" else (args.output_format,)
    os.makedirs(args.output_dir, exist_ok=True)

    for path in args.audio:
        wav = load_audio(path)
        result = model.transcribe(
            wav, prefix, tokenizer=tokenizer, beam_size=args.beam_size, max_len=args.max_len,
            eos_id=eos, chunk_seconds=args.chunk_seconds,
            temperatures=None if args.streaming else tuple(args.temperature),
            logit_rules=logit_rules, initial_prompt=args.initial_prompt,
            word_times=args.word_timestamps,
            group_fn=default_group_fn(tokenizer) if args.word_timestamps else None,
            seed=args.seed)
        base = os.path.join(args.output_dir, os.path.splitext(os.path.basename(path))[0])
        for fmt in formats:
            out_path = f"{base}.{fmt}"
            kw = {}
            if fmt in ("srt", "vtt"):
                if args.highlight_words:
                    kw["highlight_words"] = True
                if args.max_words_per_line:
                    kw["max_words_per_line"] = args.max_words_per_line
            with open(out_path, "w", encoding="utf-8") as fh:
                get_writer(fmt)(result, fh, **kw)
            print(f"wrote {out_path}", file=sys.stderr)
        print(result["text"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
