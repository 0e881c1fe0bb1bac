"""The harness: finds a cell's configuration, traffic, driver and metric
readers by name, runs the cell once and prints its result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the model's sizes, source and cuts;
- ``portbench/workloads/<cell>.json``: the driver that runs the cell, its
  traffic parameters and the limits of its correctness numbers;
- ``portbench/drivers/<driver>.py``: ``run(ctx) -> record`` (set-up,
  warm-up, the measured window, the traced stretch; the program freed
  before it returns) and ``check(ctx, record) -> numbers`` (the plain
  reference against what the window produced);
- ``portbench/metrics/<metric>.py``: ``read(record) -> value | None``; a
  metric split by the cells it is read in, ``<metric>.<part>`` (one part a
  moved end-to-end metric), shares the reader ``<metric>.py``.

A new cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mocov2_whisper_flamingo_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, from the
    kernel's record of it (``/proc/self/stat``); now where that is
    unreadable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        age = uptime - int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """``<root>/<kind>/<name>.py`` as a module, or where there is none
    ``<root>/<kind>/<name up to its first dot>.py``."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        path = root / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    module_name = f"portbench_{kind}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict      # the cell's entry in BENCHMARK.json
    config: dict     # configs/<config>.json
    workload: dict   # workloads/<cell>.json
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return load_module(self.root, "drivers", self.workload["driver"])


def resolve(bench: dict, name: str, root: Path = PACKAGE) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    entry = entries[name]
    return Cell(name, entry, load_json(root / "configs" / f"{entry['config']}.json"),
                load_json(root / "workloads" / f"{name}.json"), root)


def metric_entries(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics this cell reports: with ``traced`` the per-layer ones,
    else the end-to-end ones (those without a ``workloads`` key, or that
    name the cell)."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def read_metrics(root: Path, entries: list[dict], record: dict) -> dict:
    """Each metric's reader over the run's record; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        value = load_module(root, "metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and the
    process's start (``time.perf_counter`` clock)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float
    tmp: Path

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.workload["params"]


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``correct`` and the checks as printed: each number beside its limit
    (names starting with ``_`` are notes, not compared)."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
              if not k.startswith("_")}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = PACKAGE, device=None, started: float | None = None
             ) -> tuple[dict, dict]:
    """Run one cell once; returns the result (``RESULT_KEYS``, maybe
    ``breakdown``, then ``checks``) and notes for the log. ``device``
    None: the CUDA card(s) the cell asks for, or ``RuntimeError``."""
    import torch

    started = process_start() if started is None else started
    cell = resolve(bench, name, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"{name} needs {cell.chips} CUDA card(s); found {found}")
        device = torch.device("cuda", 0)
    tmp = Path(os.environ.get("TMPDIR", "/tmp")) / "portbench"
    ctx = Context(cell, seed, seconds, trace, torch.device(device), started, tmp)
    driver = cell.driver()
    record = driver.run(ctx)
    numbers = driver.check(ctx, record)
    correct, checks = judge(numbers, cell.workload["limits"], record["failed"])
    record["config"] = cell.config
    record["params"] = cell.workload["params"]
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(record["peak_mem_bytes"])}
    if trace:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    result = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
              "metrics": read_metrics(root, metric_entries(bench, name, trace), record),
              "device": dev}
    if trace:
        result["breakdown"] = record["trace"]["breakdown"]
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    notes = {k: v for k, v in numbers.items() if k.startswith("_")}
    notes.update(record.get("notes", {}))
    return result, notes
