"""Open-loop serving: independent callers send clips to the continuous
engine on a fixed schedule, whether or not earlier ones have finished.

The schedule holds ``round(rate_per_s * seconds)`` arrivals of a Poisson
process conditioned on that count, drawn from the traffic's own seed, the
same in every run (``inputs.arrival_gaps``); the run's seed draws the
weights and the clips. A request is timed from when it was
due, so a stall delays every request behind it. After the window closes
the run waits up to ``drain_s`` for the answers still out; a request that
never answers is a miss. A traced run then traces the same traffic again
(``Session.traced_stretch``).
"""

from __future__ import annotations

import time

from portbench import inputs
from portbench.serving import Session, check  # noqa: F401  (this cell's check)


def run(ctx) -> dict:
    p = ctx.params
    session = Session(ctx)
    gaps = inputs.arrival_gaps(round(p["rate_per_s"] * ctx.seconds), ctx.seconds,
                               p["arrival_seed"])
    setup_s = time.perf_counter() - ctx.started
    t0 = time.monotonic()
    arrivals = session.open_loop(gaps, t0)
    t1 = t0 + ctx.seconds
    time.sleep(max(t1 - time.monotonic(), 0.0))
    arrivals["thread"].join()
    session.drain(t1)

    def traffic(start):
        span = p["trace_after"] + p["trace_s"]
        again = session.open_loop(inputs.arrival_gaps(round(p["rate_per_s"] * span), span,
                                                      p["arrival_seed"] + 1), start)
        return again["thread"].join

    record = session.finish(t0, t1, setup_s, lambda r: t0 <= r.due <= t1, traffic)
    record["notes"] = {"_generator_late_ms": arrivals["late_s"] * 1e3}
    return record
