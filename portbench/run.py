"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then
``checks``: each number compared beside its limit, which are also the last
lines of standard error). Without as many CUDA cards as the cell asks for,
or with JAX or the JAX package loaded when the window has closed, it prints
no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent  # the checkout
STACKS_AFTER_S = 330  # a run must end within 360 s
# Build and kernel caches stay inside the checkout, at fixed paths, so that
# only a cell's first run there builds and compiles.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def main(argv=None) -> int:
    started = harness.process_start()
    # A run past its time names where each thread stood (standard error).
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"  # transformers, where the program reaches it, loads no JAX
    os.environ["USE_TF"] = "0"
    bench = harness.load_json(ROOT / "BENCHMARK.json")

    import torch

    chips = harness.resolve(bench, args.workload).chips
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); found {cards}",
              file=sys.stderr)
        return 2
    result, notes = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                     bool(args.trace), started=started)
    faulthandler.cancel_dump_traceback_later()
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value in notes.items():
        print(f"portbench: note {name.lstrip('_')} = {value}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"portbench: check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
