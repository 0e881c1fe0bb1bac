"""Closed-loop serving: ``clients`` callers each send their next clip as
soon as their last one is answered, so the engine never waits for work and
its queue cannot grow. Their first clips come over ``stagger_s``
(``Session.closed_loop``).

The clients start ``ramp_s`` before the window, so that the window sees the
loop in its steady state; the window counts the answers that arrive in it.
When it closes the clients stop, and the run waits up to ``drain_s`` for
the answers still out. A traced run then traces the same traffic again
(``Session.traced_stretch``).
"""

from __future__ import annotations

import time

from portbench.serving import Session, check  # noqa: F401  (this cell's check)


def run(ctx) -> dict:
    p = ctx.params
    session = Session(ctx)
    setup_s = time.perf_counter() - ctx.started
    stop = session.closed_loop(p["clients"], p["stagger_s"])
    t0 = time.monotonic() + p["ramp_s"]
    t1 = t0 + ctx.seconds
    time.sleep(max(t1 - time.monotonic(), 0.0))
    stop()
    session.drain(t1)
    return session.finish(t0, t1, setup_s, lambda r: True,
                          lambda start: session.closed_loop(p["clients"], p["stagger_s"]))
