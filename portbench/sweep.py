"""The knee sweep of an open-loop serving cell, outside any cell's run:

    python3 -m portbench.sweep --workload <an open-loop serving cell> \\
        --rates 8,10,12,13,14 [--window 30] [--seed 1] [--out chiprun_out/sweep.jsonl]

One engine is built and warmed as the cell builds it; then each rate runs
the cell's open loop for ``--window`` seconds and drains. Each rate's line
holds the offered rate, the completed rate (answers in the window after its
first ``SETTLE_S`` seconds, over those seconds), the 95th percentile from
due to answer, and the slope of the backlog (requests out, sampled every
half second over the window's second half; growth per second). The knee is
the highest rate whose completed rate is within 2 % of the offered and whose
backlog does not grow (a slope under 2 % of the rate); the cell's rate is
0.8 of it, written into its workload file by hand.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from pathlib import Path

import torch

from portbench import arithmetic as A
from portbench import harness, inputs
from portbench.serving import Session

SETTLE_S = 5.0


def _slope(points) -> float:
    if len(points) < 2:
        return 0.0
    n = len(points)
    mt = sum(t for t, _ in points) / n
    mb = sum(b for _, b in points) / n
    var = sum((t - mt) ** 2 for t, _ in points)
    return sum((t - mt) * (b - mb) for t, b in points) / var if var else 0.0


def one_rate(session: Session, rate: float, window: float) -> dict:
    p = session.ctx.params
    gaps = inputs.arrival_gaps(round(rate * window), window, p["arrival_seed"])
    first = len(session.requests)
    samples, stop = [], threading.Event()
    t0 = time.monotonic()

    def sample():
        while not stop.wait(0.5):
            reqs = session.requests[first:]
            samples.append((time.monotonic() - t0, sum(1 for r in reqs if r.done is None)))

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    arrivals = session.open_loop(gaps, t0)
    t1 = t0 + window
    time.sleep(max(t1 - time.monotonic(), 0.0))
    arrivals["thread"].join()
    stop.set()
    sampler.join()
    session.drain(t1)
    late = arrivals["late_s"]
    reqs = session.requests[first:]
    done = [r for r in reqs if r.ok and t0 + SETTLE_S <= r.done <= t1]
    served = [(r.done - r.due) * 1e3 for r in reqs if r.ok]
    missed = len(reqs) - len(served)
    lat = served + [max(served, default=0.0) + 1.0] * missed
    return {"rate": rate, "offered_per_s": len(gaps) / window,
            "completed_per_s": len(done) / (window - SETTLE_S),
            "p95_ms": A.percentile(lat, 95) if lat else None,
            "p50_ms": A.percentile(lat, 50) if lat else None,
            "backlog_slope_per_s": _slope([s for s in samples if s[0] >= window / 2]),
            "backlog_max": max((b for _, b in samples), default=0),
            "missed": missed, "requests": len(reqs), "generator_late_ms": late * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--window", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/sweep.jsonl")
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.PACKAGE.parent / "BENCHMARK.json")
    cell = harness.resolve(bench, args.workload)
    ctx = harness.Context(cell, args.seed, args.window, False, torch.device("cuda", 0),
                          time.perf_counter(), Path(os.environ.get("TMPDIR", "/tmp")) / "portbench")
    session = Session(ctx)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        row = one_rate(session, rate, args.window)
        row["cell"] = args.workload
        row["device"] = torch.cuda.get_device_name(0)
        sustained = (row["completed_per_s"] >= 0.98 * row["offered_per_s"]
                     and row["backlog_slope_per_s"] < 0.02 * rate and not row["missed"])
        row["sustained"] = sustained
        if sustained:
            knee = rate if knee is None else max(knee, rate)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    print(json.dumps({"knee_per_s": knee, "rate_at_0.8": None if knee is None else 0.8 * knee}))
    session.finish(0.0, 0.0, 0.0, lambda r: False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
