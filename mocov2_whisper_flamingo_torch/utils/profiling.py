"""Tracing helpers (counterpart of ``utils/profiling.py``).

``trace``: ``torch.profiler`` traces, one per rank, viewable in TensorBoard's
profiler plugin or in Perfetto / ``chrome://tracing``. ``span``: the
program's one way to name a stretch of its work on that trace, as a host
range and, where the work runs on a card, as a pair of marker kernels on
the device's own clock (``csrc/spans.cu``), which a replayed CUDA graph
keeps.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
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
def span(name: str, device: torch.device | None = None) -> Iterator[None]:
    """A named stretch of the program's work:

    - on the host, a ``record_function`` range (a ``user_annotation`` event
      of the trace) and, where CUDA is available, an NVTX range;
    - with a CUDA ``device``, the marker kernels ``span_open_<name>`` at
      entry and ``span_close_<name>`` at a normal exit, one thread each, on
      the device's current stream (``csrc/spans.cu`` has a pair for each
      span it names; another name raises). Launched while a CUDA graph is
      captured they become nodes of the graph, so every replay puts the
      span on the device trace. Nothing here synchronises, reads the card
      back or allocates.

    Without a device, or on another device, it is the host range alone.
    While ``torch.compile`` or ``torch.export`` traces (``torch.compiler.
    is_compiling()``) it is nothing at all, so a traced program holds no
    marker and no profiler op."""
    if torch.compiler.is_compiling():
        yield
        return
    marked = device is not None and torch.device(device).type == "cuda"
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            if marked:
                _launch_marker(name, False, device)
            yield
            if marked:
                _launch_marker(name, True, device)
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _launch_marker(name: str, close: bool, device) -> None:
    """Queue ``span``'s open or close marker of ``name`` on ``device``'s
    current stream."""
    from mocov2_whisper_flamingo_torch.ops import kernels

    fn = kernels.load("spans").span_mark
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(name.encode(), int(close), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        why = "csrc/spans.cu has no markers of that name" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"span {name!r}: its marker failed to launch: {why}")
