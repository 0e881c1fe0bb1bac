"""The train step's phases on the device trace's own clock, read from the
program's span markers: one-thread kernels named ``span_open_<span>`` and
``span_close_<span>`` that the step launches while its graph is captured, so
that every replay leaves them in the traced stretch's ``kernels``.

A step runs from its ``train_step`` open marker's start to its close
marker's end; only steps with both markers in the stretch count. A phase's
time in a step runs from its open marker's start to its close marker's end
(the two markers included). ``train_step``'s self time is the step's time
less its phases', and the gap after a step runs from its close marker's end
to the next step's open marker's start (the batch's copies, the graph's
launch, the host). Every reading is device milliseconds per counted step
(the gap: per gap between two counted steps), or None where the trace holds
no counted step: a program without markers reads None, not 0.
"""

from __future__ import annotations

from portbench.arithmetic import union_length
from portbench.trace import group_of

STEP = "train_step"
PHASES = ("frozen_audio", "frozen_video", "trainable_forward", "losses", "backward", "optimizer")
OPEN, CLOSE = "span_open_", "span_close_"


def steps(record: dict) -> list[dict]:
    """The counted steps of the traced stretch, in order: each
    ``{"start", "end"}`` (trace us) and ``"phases"``: span name -> its
    ``(start, end)`` intervals in the step."""
    t = record.get("trace")
    if not t:
        return []
    marks = sorted((float(start), float(start) + float(dur), name)
                   for name, start, dur, *_ in t["kernels"] if name.startswith((OPEN, CLOSE)))
    out, step, opened = [], None, {}
    for start, end, name in marks:
        if name == OPEN + STEP:
            step, opened = {"start": start, "end": None, "phases": {}}, {}
        elif step is None:
            continue  # the stretch began inside this step
        elif name == CLOSE + STEP:
            step["end"] = end
            out.append(step)
            step = None
        elif name.startswith(OPEN):
            opened[name[len(OPEN):]] = start
        elif name[len(CLOSE):] in opened:
            span = name[len(CLOSE):]
            step["phases"].setdefault(span, []).append((opened.pop(span), end))
    return out  # a step still open when the stretch ended is left out


def phase_ms(record: dict, phase: str) -> float | None:
    """``phase``'s device ms per counted step; None where no counted step
    holds it."""
    done = steps(record)
    if not any(phase in s["phases"] for s in done):
        return None
    return sum(b - a for s in done for a, b in s["phases"].get(phase, ())) * 1e-3 / len(done)


def step_gap_ms(record: dict) -> float | None:
    """The device ms from one counted step's end to the next one's start,
    per such gap; None with fewer than two counted steps."""
    done = steps(record)
    if len(done) < 2:
        return None
    return sum(b["start"] - a["end"] for a, b in zip(done, done[1:])) * 1e-3 / (len(done) - 1)


def split(record: dict) -> dict | None:
    """For ``PERF.md``, no metric: per counted step, each phase's ms, its
    kernels' ms by group (``trace.GROUPS``) and the share of its time in
    which a kernel ran (the union of their intervals); the step's ms,
    ``train_step``'s self ms, the gap, the markers' own kernel ms, and the
    counted steps."""
    done = steps(record)
    if not done:
        return None
    n = len(done)
    kernels = [(float(start), float(start) + float(dur), name)
               for name, start, dur, *_ in record["trace"]["kernels"]]
    phases = {}
    for phase in PHASES:
        spans = [iv for s in done for iv in s["phases"].get(phase, ())]
        if not spans:
            continue
        inside = [(a, b, name) for a, b, name in kernels
                  if any(lo <= a and b <= hi for lo, hi in spans)]
        groups: dict[str, float] = {}
        for a, b, name in inside:
            groups[group_of(name)] = groups.get(group_of(name), 0.0) + (b - a) * 1e-3 / n
        total = sum(b - a for a, b in spans)
        phases[phase] = {
            "ms": total * 1e-3 / n,
            "groups": dict(sorted(groups.items(), key=lambda g: -g[1])),
            "busy_pct": 100.0 * union_length([(a, b) for a, b, _ in inside]) / total
            if total > 0 else None}
    step = sum(s["end"] - s["start"] for s in done) * 1e-3 / n
    in_steps = [(a, b, name) for a, b, name in kernels
                if any(s["start"] <= a and b <= s["end"] for s in done)]
    return {"steps": n, "step_ms": step, "phases": phases,
            "self_ms": step - sum(p["ms"] for p in phases.values()),
            "gap_ms": step_gap_ms(record),
            "markers_ms": sum(b - a for a, b, name in in_steps
                              if name.startswith((OPEN, CLOSE))) * 1e-3 / n}
