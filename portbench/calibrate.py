"""The readings that a cell's correctness limits are set from, outside any
cell's run:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--controls 3] [--seconds 5] [--out chiprun_out/calibrate.jsonl]

For every seed it runs the cell as the benchmark does (a short window at
the cell's own load) and reads the numbers compared against the plain
reference: the lower readings. For the first ``--controls`` seeds it also
reads the control, the reference computed with float8 operands (the next
precision below the bfloat16 the configuration states) in the program's
place, and for a training cell the planted fault of half the batch left out
(the reference over the first half of each batch's rows in the program's
place); each is judged as a run is, at the cell's limits. A served model's
control is read at the tokens it puts first after each served prefix. One
JSON line per seed goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from portbench import harness, serving, weights
from portbench.reference import compare
from portbench.reference import model as M
from portbench.reference import spec

FP8 = M.Precision("fp8")


def readings(ctx, driver, record, control: bool) -> dict:
    """The program's numbers and, with ``control``, the control's and (a
    training cell) the planted fault's, each as the harness judges a run:
    ``numbers``, ``correct`` at the cell's limits and the numbers' notes."""
    limits = ctx.cell.workload["limits"]

    def judged(numbers: dict) -> dict:
        correct, _ = harness.judge(numbers, limits, 0)
        return {"correct": correct, **numbers}

    out = {}
    if record["kind"] == "train":
        ref = driver.reference(ctx)
        out["program"] = judged(compare.train_numbers(record["program"], ref))
        if control:
            out["control"] = judged(compare.train_numbers(driver.reference(ctx, FP8), ref))
            half = slice(0, ctx.params["batch"] // 2)
            out["half_batch"] = judged(compare.train_numbers(driver.reference(ctx, rows=half),
                                                             ref))
    else:
        k, first = 2 * ctx.params["beam"], len(ctx.config["prefix_ids"]) - 1
        W = weights.as_dict(spec.model_parameters(ctx.config), ctx.seed, ctx.device)
        ref = serving.reference_logits(ctx, record, W=W)

        def served(pairs) -> dict:  # the number, and (notes) how far down and how varied
            pairs = list(pairs)
            return {"token_gap": max(compare.token_gap(lg, t, first, k) for t, lg in pairs),
                    "_worst_rank": max(compare.worst_rank(lg, t, first) for t, lg in pairs),
                    "_distinct_tokens": len({int(x) for t, _ in pairs for x in t[first + 1:]})}

        out["program"] = judged(served(ref))
        if control:
            ctl = serving.reference_logits(ctx, record, FP8, W=W)
            out["control"] = judged(served((compare.control_tokens(c, t, first), lg)
                                           for (t, lg), (_, c) in zip(ref, ctl)))
        out["served_tokens"] = sum(len(t) for t, _ in ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default="chiprun_out/calibrate.jsonl")
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.PACKAGE.parent / "BENCHMARK.json")
    cell = harness.resolve(bench, args.workload)
    driver = cell.driver()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(os.environ.get("TMPDIR", "/tmp")) / "portbench"
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.Context(cell, seed, args.seconds, False, torch.device("cuda", 0),
                              time.perf_counter(), tmp)
        record = driver.run(ctx)
        line = {"cell": args.workload, "seed": seed, "failed": record["failed"],
                "attempted": record["attempted"], **readings(ctx, driver, record,
                                                              i < args.controls),
                "seconds": time.perf_counter() - t}
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        del record
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
