"""Word-level timestamps by cross-attention DTW alignment (counterpart of
``decode/timestamps.py``; openai ``whisper/timing.py`` ``find_alignment``).

1. One teacher-forced decoder forward over the final token sequence that
   also returns every layer's cross-attention probabilities
   (``WhisperDecoder.forward(..., return_cross_weights=True)``, under
   ``no_grad``; its causal self-attention runs the flash-attention kernel).
   The token axis is padded to a bucket (``pad_tokens_to``), which bounds
   how many causal shapes the kernel sees; the pad rows are cropped before
   any statistic, so the times do not depend on the bucket.
2. Alignment heads: a model-specific ``(layer, head)`` list, else every head
   of the top half of the layers (openai's fallback).
3. Per head: crop to the frames that carry audio, z-normalise over the token
   axis, median-filter along time (width 7), average the heads.
4. Monotonic DTW over ``-matrix`` on the host, in the port's native library
   (``datamodule/native.py::dtw``): the matrix is at most 448 x 1500 and the
   dynamic programme is sequential. There is no fallback: a library that
   does not build raises.
5. Token times are 0.02 s per encoder frame at the path's jumps; words group
   tokens with a tokenizer-aware split and take their first token's start
   and their last token's end.

Steps 2-5 are the JAX package's numpy code, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.datamodule import native

# Whisper's encoder emits one frame per 20 ms (2x conv stride over 10 ms
# hops); openai TOKENS_PER_SECOND = 50.
SECONDS_PER_FRAME = 0.02

# openai transcribe defaults (whisper/transcribe.py cli):
# punctuation marks merged into the following / preceding word.
PREPEND_PUNCTUATIONS = "\"'\u201c\u00bf([{-"
APPEND_PUNCTUATIONS = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"

# string.punctuation + the CJK/quote marks openai's word splitter treats
# as word-starting punctuation (tokenizer.py split_tokens_on_spaces uses
# `subword.strip() in string.punctuation`; the wider set keeps the merge
# sets above consistent).
_PUNCT_CHARS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~") \
    | set(PREPEND_PUNCTUATIONS) | set(APPEND_PUNCTUATIONS)


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float
    tokens: list[int]


def _decode(tokenizer, ids: list[int]) -> str:
    """Decode with U+FFFD replacement on invalid/partial UTF-8 when the
    tokenizer supports it (ByteTokenizer ``errors=``; HF byte-level decode
    already replaces)."""
    try:
        return tokenizer.decode(ids, errors="replace")
    except TypeError:
        return tokenizer.decode(ids)


def split_tokens_on_unicode(tokenizer, tokens) -> list[tuple[str, list[int]]]:
    """Group tokens into minimal decodable units (openai
    whisper/tokenizer.py ``split_tokens_on_unicode``).

    Byte-level BPE can split one multi-byte UTF-8 character (every accented
    Vietnamese letter) across tokens; decoding a lone piece then yields
    U+FFFD. Accumulate tokens until the decoded text carries no replacement
    character — unless the full decode genuinely contains U+FFFD at that
    offset (openai's ``decoded_full[...] == replacement_char`` check)."""
    tokens = [int(t) for t in tokens]
    decoded_full = _decode(tokenizer, tokens)
    replacement = "\ufffd"
    out: list[tuple[str, list[int]]] = []
    current: list[int] = []
    offset = 0
    for tok in tokens:
        current.append(tok)
        decoded = _decode(tokenizer, current)
        if (replacement not in decoded
                or (offset + decoded.index(replacement) < len(decoded_full)
                    and decoded_full[offset + decoded.index(replacement)]
                    == replacement)):
            out.append((decoded, current))
            current = []
            offset += len(decoded)
    if current:  # undecodable tail (truncated sequence): keep the tokens
        out.append((_decode(tokenizer, current), current))
    return out


def split_tokens_on_spaces(tokenizer, tokens) -> list[tuple[str, list[int]]]:
    """Unicode-safe word split for space-delimited scripts (openai
    whisper/tokenizer.py ``split_tokens_on_spaces``): a new word starts at
    a leading space or a punctuation-only piece; everything else glues onto
    the previous word. Words KEEP their leading space (openai convention —
    display writers strip; merge_punctuations keys on it)."""
    words: list[tuple[str, list[int]]] = []
    for subword, sub_tokens in split_tokens_on_unicode(tokenizer, tokens):
        stripped = subword.strip()
        punctuation = bool(stripped) and all(
            c in _PUNCT_CHARS for c in stripped)
        if subword.startswith(" ") or punctuation or not words:
            words.append((subword, list(sub_tokens)))
        else:
            prev_w, prev_t = words[-1]
            words[-1] = (prev_w + subword, prev_t + list(sub_tokens))
    return words


def merge_punctuations(
    words: list[WordTiming],
    prepended: str = PREPEND_PUNCTUATIONS,
    appended: str = APPEND_PUNCTUATIONS,
) -> list[WordTiming]:
    """openai whisper/timing.py ``merge_punctuations``: a lone
    space-prefixed opening mark merges into the FOLLOWING word (which keeps
    its own start/end); a closing mark merges into the PRECEDING word
    (ditto). Emptied entries are dropped. Returns a new list; inputs are
    not mutated."""
    merged = [dataclasses.replace(w, tokens=list(w.tokens)) for w in words]
    # prepended: scan backwards, folding opening marks forward
    i, j = len(merged) - 2, len(merged) - 1
    while i >= 0:
        prev, foll = merged[i], merged[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            foll.word = prev.word + foll.word
            foll.tokens = prev.tokens + foll.tokens
            prev.word, prev.tokens = "", []
        else:
            j = i
        i -= 1
    # appended: scan forwards, folding closing marks backward
    i, j = 0, 1
    while j < len(merged):
        prev, foll = merged[i], merged[j]
        if not prev.word.endswith(" ") and foll.word in appended:
            prev.word = prev.word + foll.word
            prev.tokens = prev.tokens + foll.tokens
            foll.word, foll.tokens = "", []
        else:
            i = j
        j += 1
    return [w for w in merged if w.word]


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis with edge padding (openai
    timing.py ``median_filter`` semantics; width must be odd)."""
    if width <= 1:
        return x
    if width % 2 == 0:
        raise ValueError("median_filter width must be odd")
    half = width // 2
    padded = np.concatenate(
        [x[..., :1].repeat(half, axis=-1), x,
         x[..., -1:].repeat(half, axis=-1)], axis=-1)
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over an ``[N, M]`` cost matrix: the aligned ``(text
    indices, time indices)`` path in forward order (openai ``dtw_cpu``:
    moves (i-1, j), (i, j-1), (i-1, j-1); the backtrace prefers the
    diagonal; the path runs from (0, 0) to (N-1, M-1)). Runs the native DP
    (``native/avsr_io.cpp`` ``avsr_dtw``); ``native.plain_dtw`` is its
    plain version."""
    return native.dtw(cost)


def default_alignment_heads(n_layers: int, n_heads: int) -> list[tuple[int, int]]:
    """openai fallback when no model-specific head list is known: every
    head of the top half of the decoder layers (timing.py
    ``find_alignment``'s default via ``model.alignment_heads``)."""
    return [(l, h) for l in range(n_layers // 2, n_layers)
            for h in range(n_heads)]


def alignment_matrix(
    cross_weights: np.ndarray,
    alignment_heads: list[tuple[int, int]] | None = None,
    medfilt_width: int = 7,
    example: int = 0,
    n_frames: int | None = None,
) -> np.ndarray:
    """[L, B, H, Ttok, Tenc] cross-attention stack -> [Ttok, Tenc']
    alignment matrix, openai timing.py ``find_alignment`` order: pick
    heads, CROP to the ``n_frames`` that carry real audio (before any
    statistics — padded frames must not contaminate them), z-normalize
    each head over the TOKEN axis (``std_mean(dim=-2)``: per-frame-column
    statistics, population std), median-filter along time, average heads."""
    w = np.asarray(cross_weights, dtype=np.float64)
    n_layers, _, n_heads = w.shape[:3]
    heads = alignment_heads or default_alignment_heads(n_layers, n_heads)
    sel = np.stack([w[l, example, h] for l, h in heads])  # [A, Ttok, Tenc]
    if n_frames is not None:
        sel = sel[:, :, :n_frames]
    std = sel.std(axis=-2, keepdims=True)
    sel = (sel - sel.mean(axis=-2, keepdims=True)) / np.maximum(std, 1e-10)
    sel = median_filter(sel, medfilt_width)
    return sel.mean(axis=0)


def token_timestamps(
    decoder,
    tokens,
    encoder_out: torch.Tensor,
    n_frames: int | None = None,
    alignment_heads: list[tuple[int, int]] | None = None,
    medfilt_width: int = 7,
    encoder_valid: torch.Tensor | None = None,
    n_prefix: int = 0,
    n_drop_last: int = 0,
    pad_tokens_to: int | None = None,
    pad_id: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-token (start, end) times in seconds for one example.

    ``decoder``: a ``WhisperDecoder`` (prepared or not); ``tokens``: the whole
    decoded sequence (prefix + text + EOS) as a flat int list;
    ``encoder_out``: ``[1, Tenc, D]`` on the decoder's device. The forward
    runs at ``pad_tokens_to`` rows (``pad_id`` appended) when that is longer;
    the pad rows are cropped before the statistics, and causal attention
    leaves the real rows unchanged. ``n_frames`` keeps the leading frames
    that carry audio (cropped before the statistics, openai's order). The
    DTW runs over ``tokens[n_prefix : len - n_drop_last]`` only: the forced
    prefix and the EOS row must not take audio frames on the path. Returns
    (starts, ends), each of length ``len(tokens) - n_prefix -
    n_drop_last``."""
    tokens = [int(t) for t in tokens]
    n_real = len(tokens)
    if pad_tokens_to is not None and pad_tokens_to > n_real:
        tokens = tokens + [pad_id] * (pad_tokens_to - n_real)
    toks = torch.tensor(tokens, dtype=torch.long, device=encoder_out.device)[None, :]
    with torch.no_grad():
        _, w = decoder(toks, encoder_out, encoder_valid=encoder_valid,
                       return_cross_weights=True)
    w = w[:, :, :, :n_real, :].cpu().numpy()  # crop the pad rows before the statistics
    matrix = alignment_matrix(w, alignment_heads, medfilt_width, n_frames=n_frames)
    end = matrix.shape[0] - n_drop_last
    matrix = matrix[n_prefix:end]
    text_idx, time_idx = dtw(-matrix)
    n_tok = matrix.shape[0]
    # jump j: the first time index at which the path reaches token j
    jumps = np.zeros(n_tok, dtype=np.int64)
    seen = np.zeros(n_tok, dtype=bool)
    for ti, fi in zip(text_idx, time_idx):
        if not seen[ti]:
            jumps[ti] = fi
            seen[ti] = True
    starts = jumps * SECONDS_PER_FRAME
    ends = np.empty_like(starts, dtype=np.float64)
    ends[:-1] = starts[1:]
    last_frame = time_idx[-1] + 1 if len(time_idx) else jumps[-1] + 1
    ends[-1] = last_frame * SECONDS_PER_FRAME
    return starts.astype(np.float64), ends


def word_timestamps(
    decoder,
    tokens,
    encoder_out: torch.Tensor,
    group_fn,
    n_prefix: int = 0,
    n_text: int | None = None,
    n_frames: int | None = None,
    alignment_heads: list[tuple[int, int]] | None = None,
    medfilt_width: int = 7,
    encoder_valid: torch.Tensor | None = None,
    prepend_punctuations: str | None = PREPEND_PUNCTUATIONS,
    append_punctuations: str | None = APPEND_PUNCTUATIONS,
    pad_tokens_to: int | None = None,
    pad_id: int = 0,
) -> list[WordTiming]:
    """Word times: align every token, then group the text tokens
    (``tokens[n_prefix : n_prefix + n_text]``; ``n_text=None`` takes the
    whole tail) into words.

    ``group_fn(text_token_ids) -> list[(word, token_count)]`` is the
    tokenizer-aware split (``split_tokens_on_spaces``); a word starts at its
    first token's start and ends at its last token's end. Lone punctuation
    words are then folded into their neighbours (``merge_punctuations``;
    ``None`` for both sets keeps them apart)."""
    tokens = [int(t) for t in tokens]
    text = tokens[n_prefix:] if n_text is None else tokens[n_prefix:n_prefix + n_text]
    if not text:
        return []
    n_drop_last = len(tokens) - n_prefix - len(text)
    starts, ends = token_timestamps(
        decoder, tokens, encoder_out, n_frames=n_frames, alignment_heads=alignment_heads,
        medfilt_width=medfilt_width, encoder_valid=encoder_valid, n_prefix=n_prefix,
        n_drop_last=n_drop_last, pad_tokens_to=pad_tokens_to, pad_id=pad_id)
    out: list[WordTiming] = []
    pos = 0  # index into the text range (and into starts / ends)
    for word, count in group_fn(text):
        if count <= 0:
            continue
        out.append(WordTiming(word=word, start=float(starts[pos]),
                              end=float(ends[min(pos + count - 1, len(text) - 1)]),
                              tokens=text[pos:pos + count]))
        pos += count
    if prepend_punctuations is not None or append_punctuations is not None:
        out = merge_punctuations(out, prepend_punctuations or "", append_punctuations or "")
    return out
