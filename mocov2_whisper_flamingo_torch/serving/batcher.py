"""Dynamic micro-batching policy for online serving (the port's own copy of
``serving/batcher.py``): pure and deterministic.

- **Batch-size buckets.** The batcher quantises batch sizes to a small fixed
  ladder (powers of two by default) and the engine pads the tail, so the
  decode only ever sees ``len(buckets)`` batch shapes: each is warmed once
  (kernel build, cuDNN plans, allocator pools) and never again.
- **Batch = throughput.** Filling a wider bucket amortises weight and cache
  traffic, so the policy waits up to ``max_wait_s`` for requests that can
  share a batch before it dispatches a partial bucket.
- **No data-dependent shapes.** Per-row payloads are made canonical (30 s of
  audio, a fixed number of frames) before they reach the batcher, so the only
  variable is the row count that this module quantises.

The policy is plain host Python and pure (``plan`` is a function of the
pending requests' ages and the time), so it is tested without threads or
clocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def quantize_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket if n overflows the ladder)."""
    if n <= 0:
        raise ValueError(f"need a positive row count, got {n}")
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)


@dataclass(frozen=True)
class Plan:
    """One dispatch decision: take ``count`` requests, pad to ``bucket``."""

    count: int
    bucket: int


@dataclass(frozen=True)
class MicroBatcher:
    """Deadline-or-full micro-batching policy.

    A dispatch fires when either (a) a full largest bucket is waiting, or
    (b) the oldest pending request has waited ``max_wait_s``. Otherwise the
    caller sleeps until the oldest request's deadline and plans again.
    ``max_wait_s=0`` dispatches at once (lowest latency, smallest batches).
    """

    buckets: tuple = DEFAULT_BUCKETS
    max_wait_s: float = 0.005

    def __post_init__(self):
        if not self.buckets or min(self.buckets) < 1:
            raise ValueError(f"bad bucket ladder {self.buckets!r}")

    @property
    def max_bucket(self) -> int:
        return max(self.buckets)

    def plan(self, enqueue_times: Sequence[float], now: float) -> Plan | None:
        """Decide on a dispatch given the pending queue (FIFO enqueue
        timestamps, oldest first). Returns a ``Plan`` or ``None`` (keep
        waiting; the next deadline is ``enqueue_times[0] + max_wait_s``)."""
        n = len(enqueue_times)
        if n == 0:
            return None
        if n >= self.max_bucket:
            return Plan(self.max_bucket, self.max_bucket)
        if now - enqueue_times[0] >= self.max_wait_s:
            return Plan(n, quantize_bucket(n, self.buckets))
        return None

    def next_deadline(self, enqueue_times: Sequence[float]) -> float | None:
        """Absolute time at which the oldest pending request forces a
        dispatch (None when the queue is empty)."""
        if not enqueue_times:
            return None
        return enqueue_times[0] + self.max_wait_s
