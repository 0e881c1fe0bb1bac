"""Transcript writers: txt / srt / vtt / tsv / json (counterpart of
``utils/writers.py``; openai ``whisper/utils.py`` ``get_writer``).

They take the result dict that ``WhisperASR.transcribe`` returns::

    {"text": str, "segments": [{"start", "end", "text", ...}],
     "words": [WordTiming] | None}

Host-side string formatting only. ``highlight_words`` in srt/vtt uses the
DTW word times (``decode/timestamps.py``) to emit one cue per word with the
active word underlined (openai ``--highlight_words``); the output equals the
JAX package's byte for byte.
"""

from __future__ import annotations

import json
from typing import Callable, TextIO


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    """``HH:MM:SS.mmm`` (vtt) / ``HH:MM:SS,mmm`` (srt); hours omitted when
    zero unless forced (openai utils.format_timestamp semantics)."""
    if seconds < 0:
        raise ValueError("non-negative timestamp expected")
    milliseconds = round(seconds * 1000.0)
    hours = milliseconds // 3_600_000
    milliseconds -= hours * 3_600_000
    minutes = milliseconds // 60_000
    milliseconds -= minutes * 60_000
    secs = milliseconds // 1_000
    milliseconds -= secs * 1_000
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return (f"{hours_marker}{minutes:02d}:{secs:02d}"
            f"{decimal_marker}{milliseconds:03d}")


def _segments(result: dict) -> list[dict]:
    segs = result.get("segments")
    if segs:
        return segs
    # Degenerate fallback: one segment spanning the words (or zero-length).
    words = result.get("words") or []
    end = max((w.end for w in words), default=0.0)
    return [{"start": 0.0, "end": end, "text": result.get("text", "") or ""}]


def _words_by_segment(result: dict) -> list[list]:
    """Partition the flat word list per segment, sequentially by token
    count — words and segments both partition the same committed token
    stream, so the counts line up exactly (a word that would straddle a
    boundary stays with the segment it starts in). Without segments, one
    group holds everything."""
    words = result.get("words") or []
    segs = result.get("segments") or []
    if not segs:
        return [list(words)]
    groups, wi = [], 0
    for seg in segs:
        budget = len(seg.get("tokens") or ())
        taken, used = [], 0
        while wi < len(words) and used < budget:
            taken.append(words[wi])
            used += len(words[wi].tokens)
            wi += 1
        groups.append(taken)
    if wi < len(words) and groups:  # token-less segments: keep every word
        groups[-1].extend(words[wi:])
    return groups


def _word_cues(result: dict) -> list[tuple[float, float, str]]:
    """(start, end, text-with-active-word-underlined) per word; the cue
    text is the enclosing SEGMENT's words only (openai --highlight_words
    renders per segment, not the whole transcript)."""
    cues = []
    for group in _words_by_segment(result):
        for i, w in enumerate(group):
            text = " ".join(
                f"<u>{x.word.strip()}</u>" if j == i else x.word.strip()
                for j, x in enumerate(group))
            cues.append((w.start, w.end, text))
    return cues


def _line_cues(result: dict, max_words_per_line: int) \
        -> list[tuple[float, float, str]]:
    """One cue per run of <= max_words_per_line words within a segment
    (openai --max_words_per_line groups per segment — a cue must not span
    the silence between segments): cue times span the run's first/last
    word."""
    cues = []
    for group in _words_by_segment(result):
        for i in range(0, len(group), max_words_per_line):
            run = group[i:i + max_words_per_line]
            cues.append((run[0].start, run[-1].end,
                         " ".join(w.word.strip() for w in run)))
    return cues


def _subtitle_cues(result: dict, highlight_words: bool,
                   max_words_per_line: int | None) \
        -> list[tuple[float, float, str]]:
    if highlight_words and result.get("words"):
        return _word_cues(result)
    if max_words_per_line and result.get("words"):
        return _line_cues(result, max_words_per_line)
    return [(s["start"], s["end"], (s.get("text") or "").strip())
            for s in _segments(result)]


def write_txt(result: dict, file: TextIO) -> None:
    for seg in _segments(result):
        print((seg.get("text") or "").strip(), file=file, flush=True)


def write_vtt(result: dict, file: TextIO,
              highlight_words: bool = False,
              max_words_per_line: int | None = None) -> None:
    print("WEBVTT\n", file=file)
    for start, end, text in _subtitle_cues(result, highlight_words,
                                           max_words_per_line):
        print(f"{format_timestamp(start)} --> {format_timestamp(end)}",
              file=file)
        # literal '-->' in transcript text would corrupt the cue structure
        # (openai writers make the same replacement)
        print(f"{text.replace('-->', '->')}\n", file=file, flush=True)


def write_srt(result: dict, file: TextIO,
              highlight_words: bool = False,
              max_words_per_line: int | None = None) -> None:
    cues = _subtitle_cues(result, highlight_words, max_words_per_line)
    for i, (start, end, text) in enumerate(cues, start=1):
        print(
            f"{i}\n"
            f"{format_timestamp(start, True, ',')} --> "
            f"{format_timestamp(end, True, ',')}\n"
            f"{text.replace('-->', '->')}\n",
            file=file, flush=True)


def write_tsv(result: dict, file: TextIO) -> None:
    """start/end in integer milliseconds + tab + text (openai WriteTSV)."""
    print("start", "end", "text", sep="\t", file=file)
    for seg in _segments(result):
        print(round(1000 * seg["start"]), round(1000 * seg["end"]),
              (seg.get("text") or "").strip().replace("\t", " "),
              sep="\t", file=file, flush=True)


def write_json(result: dict, file: TextIO) -> None:
    out = {"text": result.get("text"),
           "segments": _segments(result)}
    if result.get("words"):
        out["words"] = [
            {"word": w.word, "start": w.start, "end": w.end,
             "tokens": list(w.tokens)} for w in result["words"]]
    json.dump(out, file, ensure_ascii=False)


_WRITERS: dict[str, Callable] = {
    "txt": write_txt,
    "vtt": write_vtt,
    "srt": write_srt,
    "tsv": write_tsv,
    "json": write_json,
}


def get_writer(output_format: str) -> Callable[[dict, TextIO], None]:
    """Writer callable for one of txt/vtt/srt/tsv/json (openai
    ``get_writer``; ``all`` is handled by callers iterating WRITER_FORMATS)."""
    try:
        return _WRITERS[output_format]
    except KeyError:
        raise ValueError(
            f"unknown output format {output_format!r}; "
            f"known: {sorted(_WRITERS)}") from None


WRITER_FORMATS = tuple(sorted(_WRITERS))
