#!/usr/bin/env python3
"""Time the beam program's ``torch.export`` on the card at several lengths.

    python3 export_beam_times.py MAX_LEN [MAX_LEN ...]

For each ``max_len``: ``tools/export_model.py::export_beam`` of the net that
``chip_smoke.py`` phase 17 exports (whisper-small + ResNet-50, bf16, random
weights from seed 0) at B=1, beam 5, with the seconds of the export, the
artifact's bytes, the seconds of the reload (``torch.export.load`` and
``.module()``), the ``while_loop`` nodes in its graph, its FX nodes (the top
graph and every loop's condition and body, what the save's copy and the
reload scale with), the grad-mode nodes that reached the export's set-grad
pass (null where this torch names the pass otherwise) and the seconds of
one run. Prints one JSON line per length, then the card's name and power
limit. It times the package beside it: to time another tree, copy the
script into that tree's checkout and run it there.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import torch

import chip_smoke
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.tools import export_model


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def counted_set_grad(counts: list):
    """Append to ``counts`` the grad-mode nodes of each graph that the
    export's set-grad pass splits at, inside the block."""
    try:
        from torch._export.passes import replace_set_grad_with_hop_pass as p
        split = p._sequential_split_and_maybe_inline_subgraphs
    except (ImportError, AttributeError):
        yield
        return

    def counting(gm, *args, **kwargs):
        counts.append(sum(1 for n in gm.graph.nodes if p._is_set_grad_enabled_node(n)))
        return split(gm, *args, **kwargs)

    p._sequential_split_and_maybe_inline_subgraphs = counting
    try:
        yield
    finally:
        p._sequential_split_and_maybe_inline_subgraphs = split


def fx_nodes(exported) -> dict:
    """Nodes of each graph of the artifact: the top graph and every loop's
    condition and body."""
    return {name or "top": len(gm.graph.nodes)
            for name, gm in exported.graph_module.named_modules()
            if isinstance(gm, torch.fx.GraphModule)}


def time_length(dnet, max_len: int, workdir: str) -> dict:
    batch = export_model._example_batch(1, device="cuda")
    batch = (batch[0].transpose(1, 2).contiguous(),) + batch[1:]  # mel as [B, 80, T]
    path = os.path.join(workdir, f"beam_{max_len}.pt2")
    set_grad = []
    with counted_set_grad(set_grad):
        _, export_s = timed(lambda: export_model.export_beam(
            dnet, batch, chip_smoke.PREFIX, path, beam_size=chip_smoke.BEAM, max_len=max_len,
            eos_id=chip_smoke.EOS))
    size = os.path.getsize(path)
    exported, reload_s = timed(lambda: torch.export.load(path))
    loops = sum(1 for n in exported.graph.nodes
                if n.op == "call_function" and n.target is torch.ops.higher_order.while_loop)
    nodes = fx_nodes(exported)
    program, module_s = timed(exported.module)
    with torch.no_grad():
        (seqs, scores), run_s = timed(lambda: program(batch))
    os.remove(path)
    return {"max_len": max_len, "export_s": export_s, "bytes": size,
            "reload_s": reload_s + module_s, "while_loop_nodes": loops,
            "fx_nodes": sum(nodes.values()), "fx_nodes_by_graph": nodes,
            "set_grad_nodes": sum(set_grad) if set_grad else None, "run_s": run_s,
            "finite": bool(torch.isfinite(scores).all()), "shape": list(seqs.shape)}


def main() -> int:
    lengths = [int(a) for a in sys.argv[1:]]
    if not lengths or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dnet = chip_smoke.build(0, L.BF16, "cuda")
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "export_beam_times")
    os.makedirs(workdir, exist_ok=True)
    try:
        for max_len in lengths:
            print(json.dumps(time_length(dnet, max_len, workdir)), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
