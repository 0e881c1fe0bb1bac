"""Tracing and profiling helpers (counterpart of ``utils/profiling.py``).

``torch.profiler`` traces, one per rank, viewable in TensorBoard's profiler
plugin or in Perfetto / ``chrome://tracing``; named regions that show on the
trace's host timeline and, on a card, as NVTX ranges; a step timer; and the
card's memory counters under the JAX package's key names.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block (host ops, and the card's kernels when CUDA
    is available) into ``log_dir``::

        with profiling.trace("logs/profile"):
            trainer.fit(datamodule)

    Each rank writes ``rank{R}.pt.trace.json``, a Chrome trace that
    TensorBoard's profiler plugin and Perfetto open."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"rank{_rank()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region on the trace's timeline (``record_function``), and an
    NVTX range where CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timing with an exponential moving average, for
    throughput logs. Times the host's clock: synchronise the card inside the
    block where the step's kernels must count."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: float | None = None
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt

    @property
    def seconds(self) -> float:
        return self.ema or 0.0


def device_memory_report() -> dict:
    """Per-card memory counters from ``torch.cuda.memory_stats`` under the
    JAX package's keys: ``bytes_in_use`` (allocated now), ``peak_bytes_in_use``
    and ``bytes_limit`` (the card's total memory). Empty without CUDA."""
    report = {}
    if not torch.cuda.is_available():
        return report
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        report[f"cuda:{index}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(index).total_memory),
        }
    return report
