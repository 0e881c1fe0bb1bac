"""The traced stretch of a run: ``torch.profiler`` with CPU and CUDA
activities around a callable, read back from its Chrome trace.

``Stretch(tmp)``'s ``start()``, ``stop()`` and, once the run's work is
over, ``read()`` give the host seconds of the stretch (``window_s``,
between two synchronisations), the seconds in which any kernel, copy or
fill ran on the device (``busy_s``, the union of their intervals), every
kernel as ``(name, start_us, duration_us, grid)``, and the breakdown the
result line carries: device time by kernel group, and the longest idle
stretches of the device named by the host operation that overlapped them
most.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from portbench.arithmetic import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation", "cuda_runtime", "cuda_driver")
# Kernel groups by name, first match wins (a cuDNN convolution's name holds "gemm" too).
GROUPS = (
    ("K1 attention_fwd", ("attention_fwd",)),
    ("ctc", ("ctc_alpha", "ctc_grad")),
    ("NCCL", ("nccl",)),
    ("cuDNN conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "cublas")),
    ("copy", ("memcpy", "memset", "copy", "cat", "index", "gather", "scatter", "fill")),
    ("reduce", ("reduce", "softmax", "norm", "topk", "sort")),
    ("elementwise", ("elementwise", "vectorized")),
)


MARK_FROM, MARK_TO = "portbench.from", "portbench.to"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


class Stretch:
    """A profiled stretch that starts and stops where the caller says."""

    def __init__(self, tmp: Path):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.tmp = tmp
        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=activities)
        self._t0 = None

    def _sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()
        self.marks: dict[str, float] = {}

    def mark(self, label: str) -> None:
        """Mark ``MARK_FROM`` or ``MARK_TO`` in the trace (a zero-length
        annotation) and on the host's clock: ``read`` keeps what lies
        between the two."""
        import torch

        with torch.profiler.record_function(label):
            self.marks[label] = time.perf_counter()

    def stop(self) -> None:
        """End the stretch, after a synchronisation. Reading it (``read``)
        waits until the work it watched is over: the export and its parse
        take seconds of the host."""
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def read(self) -> dict:
        """The stopped stretch, read; see the module doc."""
        self.tmp.mkdir(parents=True, exist_ok=True)
        path = self.tmp / "trace.json"
        self._prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        if set(self.marks) == {MARK_FROM, MARK_TO}:
            at = {e["name"]: float(e["ts"]) for e in events
                  if e.get("ph") == "X" and e.get("name") in self.marks}
            return read_events(events, self.marks[MARK_TO] - self.marks[MARK_FROM],
                               (at[MARK_FROM], at[MARK_TO]))
        return read_events(events, self.window_s)


def read_events(events: list, window_s: float, span: tuple | None = None) -> dict:
    """``span``: only the device work in this ``(from, to)`` (trace us),
    each interval cut to it."""
    lo, hi = span if span else (float("-inf"), float("inf"))
    device, kernels = [], []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(start, lo), min(end, hi)
            if b > a:
                device.append(dict(e, ts=a, dur=b - a))
            if e["cat"] == "kernel" and lo <= start and end <= hi:  # whole launches only
                kernels.append((e["name"], start, float(e["dur"]), e.get("args", {}).get("grid")))
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    by_group: dict[str, float] = {}
    for e in device:
        g = group_of(e["name"])
        by_group[g] = by_group.get(g, 0.0) + float(e["dur"]) * 1e-6
    idle = sorted(gaps(intervals), key=lambda g: g[0] - g[1])[:10]
    return {"window_s": window_s, "busy_s": union_length(intervals) * 1e-6,
            "kernels": kernels,
            "breakdown": {
                "device_ops": sorted(([g, s] for g, s in by_group.items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": [[_host_during(host, a, b), (b - a) * 1e-6] for a, b in idle]}}


def _host_during(host: list, start: float, end: float) -> str:
    """The host operation that overlapped ``[start, end]`` (us) most; of
    equal overlaps the shortest (the innermost)."""
    best, best_key = "host idle", (0.0, 0.0)
    for e in host:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        overlap = min(b, end) - max(a, start)
        if overlap > 0 and (overlap, -(b - a)) > best_key:
            best, best_key = e["name"], (overlap, -(b - a))
    return best[:120]
