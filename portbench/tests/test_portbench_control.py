"""The control at a size a test run can hold: the plain reference computed
with float8 operands (the precision below the bfloat16 the configurations
state), put in the program's place. A served model's control, read at the
tokens it puts first after each served prefix, is judged not correct where
the sound program is judged correct. In training the planted fault of half
the batch is judged not correct, and the control reads its gradients'
difference several times the program's. (``python3 -m portbench.calibrate``
reads the same at the cells' own sizes on the chip; PERF.md keeps those
readings.)"""

from __future__ import annotations

import time

import torch

from portbench import calibrate, harness
from portbench.tests import tiny


def _readings(tmp_path, cell: str) -> tuple[dict, dict]:
    bench, root = tiny.make_root(tmp_path)
    c = harness.resolve(bench, cell, root)
    if "beam" in c.workload["params"]:  # enough served positions for the precision to show
        c.workload["params"].update(max_tokens=40, seg_steps=8, sample=4)
    driver = c.driver()
    ctx = harness.Context(c, 2**31 + 99, 1.0, False, torch.device("cpu"), time.perf_counter(),
                          tmp_path / "t")
    return calibrate.readings(ctx, driver, driver.run(ctx), control=True), c.workload["limits"]


def test_the_control_fails_where_the_program_passes(tmp_path):
    got, limits = _readings(tmp_path, "tiny.serve-closed")
    assert got["program"]["correct"] is True, got["program"]
    assert got["control"]["correct"] is False, (got["control"], limits)


def test_train_control_and_fault_readings(tmp_path):
    """At the training cell's limits the planted fault of half the batch is
    judged not correct and the program correct; the float8 control reads
    its gradients' difference several times the program's. (At the cell's
    own size the control is not judged incorrect on every seed: PERF.md.)"""
    got, limits = _readings(tmp_path, "tiny.train")
    assert got["program"]["correct"] is True, got["program"]
    assert got["half_batch"]["correct"] is False, got["half_batch"]
    assert got["control"]["grad_diff"] > 3 * got["program"]["grad_diff"], got
