"""Tiny cells for the CPU tests: the benchmark's files copied to a temporary
root with configurations and traffic small enough for a test run (one
encoder and one decoder layer of width 64, a handful of 88x88 frames, the
full 30 s mel), and the benchmark's entries for them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench import harness

REPO = harness.PACKAGE.parent

TINY_WHISPER = {"n_mels": 80, "d_model": 64, "encoder_layers": 1, "decoder_layers": 1,
                "n_heads": 2, "d_ff": 128, "vocab_size": 51865,
                "max_source_positions": 1500, "max_target_positions": 448}
TINY_MODEL = {"d_model": 64, "n_heads": 2, "n_layers": 2, "pe_max_len": 3000,
              "fc_hidden_size": 128, "dropout": 0.0}

TINY_TRAIN = {"batch": 2, "accumulate": 1, "pool": 3, "frames": 8, "raw_size": 88, "resize": 64,
              "audio_lengths": 8, "target_len_min": 2, "target_len_max": 6, "target_pad": 6,
              "first_steps": 3, "total_steps": 100, "trace_after": 1, "trace_steps": 1}
TINY_SERVE = {"capacity": 2, "beam": 2, "seg_steps": 4, "max_tokens": 12, "resize": 64,
              "buckets": [1, 2], "frames": 8, "raw_size": 88, "clips": 4, "drain_s": 120,
              "sample": 2, "trace_after": 0.2, "trace_s": 0.5}

CELLS = {
    "tiny.train": ("train", "tiny-train", dict(TINY_TRAIN)),
    "tiny.serve-open": ("serve_open", "tiny-open",
                        dict(TINY_SERVE, rate_per_s=2.0, arrival_seed=7)),
    "tiny.serve-closed": ("serve_closed", "tiny-closed",
                          dict(TINY_SERVE, clients=2, stagger_s=0.2, ramp_s=0.0)),
}


# The served tokens' limit at width 64, from readings on the CPU at 40
# tokens a request and 4 requests sampled: the program 0 (4 seeds; 0 on 12
# at the cells' 12 tokens), the control 0.0036-0.026 (4 seeds).
TINY_TOKEN_GAP = 0.002


def make_root(tmp: Path) -> tuple[dict, Path]:
    """A copy of ``portbench/`` under ``tmp`` with the tiny configuration and
    cells added, and a BENCHMARK.json-like dict that names them. A tiny cell
    takes the limits and metrics of the real cell of its driver; the served
    cells, which have none, take ``TINY_TOKEN_GAP`` and the metrics every
    cell reports."""
    root = tmp / "portbench"
    shutil.copytree(harness.PACKAGE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(REPO / "BENCHMARK.json")
    real = {harness.load_json(root / "workloads" / f"{w['name']}.json")["driver"]: w["name"]
            for w in bench["workloads"]}
    cfg = harness.load_json(root / "configs" / "avsr-whisper-small.json")
    cfg.update(name="tiny", whisper=TINY_WHISPER, model=TINY_MODEL, vocab_size=51865)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench = copy.deepcopy(bench)
    for name, (driver, traffic, params) in CELLS.items():
        limits = ({"token_gap": TINY_TOKEN_GAP} if driver not in real else
                  harness.load_json(root / "workloads" / f"{real[driver]}.json")["limits"])
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"driver": driver, "params": params, "limits": limits}))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "a CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real.get(driver) in m.get("workloads", ()):
                m["workloads"] = [*m["workloads"], name]
    return bench, root


def run(bench: dict, root: Path, name: str, seed: int = 5, seconds: float = 1.0,
        trace: bool = False) -> tuple[dict, dict]:
    """One tiny run on the CPU."""
    return harness.run_cell(bench, name, seed, seconds, trace, root=root, device="cpu")
