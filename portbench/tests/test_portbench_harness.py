"""The harness finds cells, configurations, drivers and metric readers by
name, takes new ones as files alone, and prints the contract's result line;
BENCHMARK.json keeps to the contract's shape."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(tiny.REPO / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = harness.resolve(BENCH, cell)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.driver(), "run") and hasattr(c.driver(), "check")
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_module(harness.PACKAGE, "metrics", metric).read)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    names = list(cells) + list(configs) + [m["name"] for m in BENCH["end_to_end"]
                                           + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (tiny.REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert harness.load_json(tiny.REPO / c["file"])["reduced"] == c["reduced"]
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    reported = {}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        reported[m["name"]] = set(m.get("workloads", cells))
    assert set(reported["setup_s"]) == set(cells)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in reported, m
        assert set(m["workloads"]) <= reported[m["moves"]], m
    for cell in cells:
        e2e = [m for m in BENCH["end_to_end"] if cell in reported[m["name"]]]
        assert len(e2e) >= 2 and harness.metric_entries(BENCH, cell, True)


def test_new_cell_and_metric_are_files_alone(tmp_path):
    """A cell (configuration, traffic) and a per-layer metric added as new
    files and entries, with no other file changed, are found and read."""
    bench, root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*.py")}
    (root / "workloads" / "tiny.train-b3.json").write_bytes(
        (root / "workloads" / "tiny.train.json").read_bytes())
    (root / "metrics" / "steps_in_window.py").write_text(
        '"""Steps run in the window."""\n\n\ndef read(record):\n    return record.get("steps")\n')
    bench["workloads"].append({"name": "tiny.train-b3", "config": "tiny", "traffic": "tiny-b3",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.train-b3"]})
    cell = harness.resolve(bench, "tiny.train-b3", root)
    assert cell.entry["traffic"] == "tiny-b3" and cell.config["name"] == "tiny"
    assert cell.workload["driver"] == "train"
    entries = harness.metric_entries(bench, "tiny.train-b3", False)
    assert "steps_in_window" in [m["name"] for m in entries]
    record = {"steps": 7, "kind": "train", "clips": 14, "window_s": 2.0, "setup_s": 1.0,
              "peak_mem_bytes": 0}
    got = harness.read_metrics(root, entries, record)
    assert got["steps_in_window"] == {"value": 7.0, "unit": "steps"}
    assert {p: p.read_bytes() for p in before} == before


def test_result_line_keys_and_checks_last(tmp_path):
    bench, root = tiny.make_root(tmp_path)
    result, _ = tiny.run(bench, root, "tiny.train", seed=2**31 + 12345, seconds=0.5)
    keys = list(result)
    assert keys[:5] == list(harness.RESULT_KEYS) and keys[-1] == "checks"
    assert set(keys) <= set(harness.RESULT_KEYS) | {"breakdown", "checks"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "delta_gap", "grad_diff",
                                     "gate_grad_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert result["correct"] is True and result["failed"] == 0
    assert "train_clips_per_s" in result["metrics"] and "setup_s" in result["metrics"]
    json.dumps(result)


def test_traced_run_carries_breakdown(tmp_path):
    bench, root = tiny.make_root(tmp_path)
    result, _ = tiny.run(bench, root, "tiny.train", seconds=0.5, trace=True)
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_missing_files_are_refused(tmp_path):
    bench, root = tiny.make_root(tmp_path)
    shutil.rmtree(root / "drivers")
    with pytest.raises(FileNotFoundError):
        harness.resolve(bench, "tiny.train", root).driver()
    with pytest.raises(KeyError):
        harness.resolve(bench, "no-such-cell", root)
