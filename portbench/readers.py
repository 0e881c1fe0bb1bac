"""What the metric readers share: each ``metrics/<name>.py`` is a line or two
over these. Every reader takes the run's record and returns a number, or
None where the run has nothing for it to read.
"""

from __future__ import annotations

import re

from portbench import arithmetic as A

K1_TEMPLATE = re.compile(r"attention_fwd_\w+<(\d+), (\d+), (true|false), (true|false)>")


def window_requests(record: dict) -> list:
    t0, t1 = record["window"]
    return [r for r in record["requests"] if t0 <= r.due <= t1]


def completed_in_window(record: dict) -> list:
    t0, t1 = record["window"]
    return [r for r in record["requests"] if r.ok and r.done is not None and t0 <= r.done <= t1]


def latency_p95_ms(record: dict) -> float | None:
    """95th percentile of due-to-answer over every request due in the
    window; a request that failed or never answered counts above every
    answered one."""
    reqs = window_requests(record)
    if not reqs:
        return None
    served = [(r.done - r.due) * 1e3 for r in reqs if r.ok]
    worst = max(served, default=0.0)
    missed = [worst + 1.0] * (len(reqs) - len(served))
    return A.percentile(served + missed, 95)


def engine_ms(record: dict, field: str, q: float) -> float | None:
    """A percentile of the engine's own stamp ``field`` over the answered
    requests due in the window."""
    values = [getattr(r, field) for r in window_requests(record) if r.ok]
    return A.percentile(values, q) if values else None


def trace(record: dict) -> dict | None:
    return record.get("trace")


def idle_pct(record: dict) -> float | None:
    t = trace(record)
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def k1_roofline_pct(record: dict, kinds: dict) -> float | None:
    """K1's bound over its kernel time in the traced stretch: each launch's
    least time at its shape (the batch from its grid, ``B * H`` blocks in y;
    the rest from ``kinds`` by its mask flag)."""
    t = trace(record)
    if not t:
        return None
    bound_ms, time_ms = 0.0, 0.0
    for name, _, dur_us, grid in t["kernels"]:
        m = K1_TEMPLATE.search(name)
        if not m:
            continue
        if not grid:
            return None
        k = kinds[m.group(3)]
        b = grid[1] // k["h"]
        bound_ms += A.attention_bound_ms(b, k["tq"], k["tk"], k["h"], k["d"], 2,
                                         m.group(3) == "true", m.group(4) == "true")[0]
        time_ms += dur_us * 1e-3
    return 100.0 * bound_ms / time_ms if time_ms > 0 else None


def kernel_ms(record: dict, prefixes: tuple) -> float:
    t = trace(record)
    return sum(dur for name, _, dur, _ in t["kernels"]
               if any(p in name for p in prefixes)) * 1e-3 if t else 0.0


def k1_kinds(record: dict) -> dict:
    """K1's calls in the traced work, by mask flag: the Whisper encoder's
    self-attention (no mask) and the fusion's cross-attention (the frame
    mask); the batch of each launch comes from its grid."""
    cfg, p = record["config"], record["params"]
    w, m = cfg["whisper"], cfg["model"]
    t_audio = cfg["mel_frames"] // 2
    t = min(p["frames"], t_audio)
    return {"false": {"tq": t_audio, "tk": t_audio, "h": w["n_heads"],
                      "d": w["d_model"] // w["n_heads"]},
            "true": {"tq": t, "tk": t, "h": m["n_heads"], "d": m["d_model"] // m["n_heads"]}}


def mfu_pct(flops: float, seconds: float) -> float | None:
    return 100.0 * flops / (seconds * A.PEAK_BF16_FLOPS) if seconds > 0 and flops > 0 else None
