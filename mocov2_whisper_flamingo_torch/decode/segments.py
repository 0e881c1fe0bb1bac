"""Timestamp-token segmentation of a decoded window (counterpart of
``decode/segments.py``).

With the timestamp grammar active (``decode/logit_rules.py``) the model
emits ``<|t.tt|>`` tokens that split a 30 s window into timed segments at
pairs of consecutive timestamps and say how far the speech went, so the next
window seeks to the last timestamp instead of advancing a whole window
(openai ``whisper/transcribe.py``). ``transcribe_long_form``'s quality mode
uses this when its logit rules enable timestamps.

Pure token-list code, with no device work.
"""

from __future__ import annotations

# One timestamp token step is 20 ms (openai time_precision: 30 s over 1500
# encoder frames, ``decode/timestamps.py::SECONDS_PER_FRAME``).
TIME_PRECISION = 0.02


def segments_from_window(
    tokens: list[int],
    timestamp_begin: int,
    time_offset: float,
    segment_duration: float,
    time_precision: float = TIME_PRECISION,
) -> tuple[list[dict], float]:
    """Split one window's generated tokens at timestamp pairs.

    ``tokens``: the window's generated ids (prefix/EOS stripped),
    timestamps included. Returns ``(segments, seek_advance_seconds)``:
    segments are ``{"start", "end", "tokens"}`` with absolute times
    (``time_offset`` added) and timestamp tokens KEPT in ``tokens``
    (callers' detokenizers skip them as specials — openai keeps them the
    same way); ``seek_advance_seconds`` is how far the window consumed
    audio (openai: the full window when it ends in a lone timestamp or has
    no timestamp pairs; the last pair's time otherwise).
    """
    is_ts = [t >= timestamp_begin for t in tokens]
    single_timestamp_ending = (
        len(tokens) >= 2 and not is_ts[-2] and is_ts[-1])

    # positions i where tokens[i-1] and tokens[i] are both timestamps
    consecutive = [i + 1 for i in range(len(tokens) - 1)
                   if is_ts[i] and is_ts[i + 1]]

    segments: list[dict] = []
    if consecutive:
        slices = list(consecutive)
        if single_timestamp_ending:
            slices.append(len(tokens))
        last_slice = 0
        for current_slice in slices:
            sliced = tokens[last_slice:current_slice]
            start_pos = sliced[0] - timestamp_begin
            end_pos = sliced[-1] - timestamp_begin
            segments.append({
                "start": time_offset + start_pos * time_precision,
                "end": time_offset + end_pos * time_precision,
                "tokens": sliced,
            })
            last_slice = current_slice
        if single_timestamp_ending:
            # no speech after the last timestamp: consume the whole window
            advance = segment_duration
        else:
            # the unfinished tail segment is DROPPED (it will be re-decoded
            # by the next window); seek to the last finished timestamp
            last_ts_pos = tokens[last_slice - 1] - timestamp_begin
            advance = last_ts_pos * time_precision
    else:
        duration = segment_duration
        ts = [t for t, b in zip(tokens, is_ts) if b]
        if ts and ts[-1] != timestamp_begin:
            # no pairs, but a final timestamp caps the speech duration
            duration = (ts[-1] - timestamp_begin) * time_precision
        segments.append({
            "start": time_offset,
            "end": time_offset + duration,
            "tokens": list(tokens),
        })
        advance = segment_duration
    return segments, advance


def strip_timestamps(tokens: list[int], timestamp_begin: int,
                     eot: int | None = None) -> list[int]:
    """Text tokens only — what openai feeds back as the conditioning prompt
    (``all_tokens`` keeps ``token < tokenizer.eot``). Pass the model's
    ``eot`` so special ids in ``[eot, timestamp_begin)`` (language/task/
    notimestamps tokens an incomplete suppress list let through) cannot
    leak into the prompt stream; without it only the timestamp block is
    stripped."""
    bound = timestamp_begin if eot is None else min(eot, timestamp_begin)
    return [t for t in tokens if t < bound]
