"""Multi-process training of the port (``Trainer.fit`` on a ``("data",
"model")`` mesh over gloo on the CPU) against the JAX ``Trainer`` on the same
mesh shape, at the tiny configuration of tests/test_torch_training.py: fp32,
dropout 0, accumulation 2, two updates.

The ranks are subprocesses (tests/torch_multicard_worker.py) that import
torch and the port only; they meet through a ``file://`` store under the
module's temporary directory, with a 60 s collective timeout, and each has a
wall limit of ``RANK_LIMIT_S``: a hung collective fails its test. A module
starts its ranks once, with its fixture; they take the module's cases in
turn while the JAX references compile here, on the first D * M of the 8
virtual CPU devices (each JAX ``Trainer`` compiles its step for ~15 s, so the
cases are spread over three files: this one, data parallelism with
validation and test, and the non-finite guard; tests/test_torch_parallel.py,
the 2 x 2 mesh and unequal token counts; tests/test_torch_tensor_parallel.py,
model=2, its checkpoints, and the int8 frozen encoder).

Tolerances: ``PARAM_ATOL`` and ``LOSS_ATOL`` of tests/test_torch_training.py.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mocov2_whisper_flamingo_torch.models.convert import from_jax_params
from mocov2_whisper_flamingo_tpu.config import get_config as j_get_config
from mocov2_whisper_flamingo_tpu.training.trainer import Trainer as JTrainer
from mocov2_whisper_flamingo_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer

from test_torch_training import (
    LOSS_ATOL, PARAM_ATOL, VOCAB, TNet, _batches, _jax_net, _named, _tree)
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_multicard_worker.py")
RANK_LIMIT_S = 120
B = 4  # rows of a global batch: 2 per data index at data=2


def global_batches() -> dict:
    main = _batches(4, b=B)
    uneven = _batches(4, b=B, seed=12)
    for batch in uneven:  # data index 0 holds long targets, data index 1 short ones
        lens = np.array([5, 5, 1, 2], np.int32)
        batch["target_lengths"] = lens
        batch["target_ids"] = np.where(np.arange(5)[None, :] < lens[:, None],
                                       batch["target_ids"] + (batch["target_ids"] == 0), 0)
    nan = _batches(1, b=B, seed=13)
    nan[0]["audio"][3] = np.nan  # one row of data index 1
    out = {"main": main, "half": main[:2], "uneven": uneven, "nan": nan}
    for batches in out.values():
        for batch in batches:
            batch["target_text"] = [f"xin chao {i}" for i in range(B)]
    return out


CASES_2 = [
    {"name": "dp", "mesh": (2, 1), "batches": "main", "max_steps": 4, "test": True},
    {"name": "nan", "mesh": (2, 1), "batches": "nan", "max_steps": 1,
     "overrides": {"training.accumulate_grad_batches": 1}},
]
for case in CASES_2:
    case["vocab"] = VOCAB


class Ranks:
    """The processes of one run; ``result(case, rank)`` waits for all of
    them (up to their wall limit) and reads what the rank wrote."""

    def __init__(self, workdir: Path, world: int, cases: list, tree: dict, batches: dict):
        self.workdir, self.world = workdir, world
        spec = {"init": f"file://{workdir}/store", "world": world, "workdir": str(workdir),
                "states": {VOCAB: from_jax_params(tree)}, "batches": batches, "cases": cases}
        with open(workdir / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        self.deadline = time.monotonic() + RANK_LIMIT_S
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(workdir / "spec.pkl"), str(rank)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
        self.outputs = None

    def wait(self) -> None:
        if self.outputs is not None:
            return
        self.outputs = []
        for proc in self.procs:
            try:
                out, _ = proc.communicate(timeout=max(self.deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                self.kill()
                out, _ = proc.communicate()
                out += f"\n[rank ran past its {RANK_LIMIT_S} s limit]"
            self.outputs.append(out)
        failed = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode != 0]
        if failed:
            self.kill()
            raise AssertionError(f"ranks {failed} failed:\n" + "\n".join(
                f"--- rank {r} ---\n{self.outputs[r][-3000:]}" for r, _ in failed))

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()

    def result(self, case: str, rank: int = 0) -> dict:
        self.wait()
        with open(self.workdir / f"{case}.rank{rank}.pkl", "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, batches = _tree(), global_batches()
    two = Ranks(tmp_path_factory.mktemp("two_ranks"), 2, CASES_2, tree, batches)
    yield {"tree": tree, "batches": batches, "two": two}
    two.kill()


class _Writer:
    def __init__(self, path):
        self.path, self.scalars = path, []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


class _GlobalDataModule:
    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self):
        class Loader(list):
            def set_epoch(self, epoch):
                pass

        return Loader(dict(b) for b in self.batches)

    def val_dataloader(self):
        return [dict(self.batches[0])]

    test_dataloader = val_dataloader


def jax_fit(tmp_path, runs, case, validate: bool = False) -> dict:
    """The JAX ``Trainer`` on the case's mesh shape and global batches. Its
    orbax checkpoints are not written (they are not compared, and cost
    seconds each); without ``validate`` its validation is not run either
    (an eval step to compile) and only the train scalars compare."""
    d, m = case["mesh"]
    config = j_get_config({
        "training.epochs": case.get("epochs", 1), "training.accumulate_grad_batches": 2,
        "training.max_lr": 1e-3, "model.dropout": 0.0, "precision.compute_dtype": "float32",
        "precision.rematerialize": False, "output.log_every_n_steps": 1,
        "output.checkpoint_dir": str(tmp_path / "ckpt"), "output.log_dir": str(tmp_path / "logs"),
        "mesh.data": d, "mesh.model": m, **case.get("overrides", {})})
    trainer = JTrainer(config, _jax_net(0.0), JByteTokenizer())
    trainer.writer = _Writer(trainer.writer.path)
    trainer.ckpt.save = lambda state, step, metric=None: None
    if not validate:
        trainer.validate = lambda datamodule, params: {"loss": 0.0}
    dm = _GlobalDataModule(runs["batches"][case["batches"]])
    params = trainer.fit(dm, jax.tree.map(jnp.asarray, runs["tree"]), max_steps=case["max_steps"])
    out = {"params": _named(params), "scalars": trainer.writer.scalars}
    if case.get("test"):
        out["test"] = trainer.test(dm, params)
    return out


def _scalars(scalars, prefix):
    return {(tag, step): v for tag, v, step in scalars if tag.startswith(prefix)}


def assert_matches_jax(ours: dict, ref: dict, tree: dict, prefixes=("train/",)):
    for prefix in prefixes:
        mine, theirs = _scalars(ours["scalars"], prefix), _scalars(ref["scalars"], prefix)
        assert mine.keys() == theirs.keys() and len(mine) >= 3, prefix
        for key, value in theirs.items():
            assert mine[key] == pytest.approx(value, abs=LOSS_ATOL), key
    start = from_jax_params(tree)
    moved = 0.0
    for name, value in ours["params"].items():
        if TNet.trainable_filter(name):
            np.testing.assert_allclose(value, ref["params"][name], atol=PARAM_ATOL, rtol=0,
                                       err_msg=name)
            moved = max(moved, float(np.abs(value - start[name]).max()))
    assert moved > 1e-4  # the comparison is not between two nets that stood still


def case_named(cases, name):
    return next(c for c in cases if c["name"] == name)


def same_on_every_rank(ranks, case, world):
    first = ranks.result(case, 0)
    for rank in range(1, world):
        other = ranks.result(case, rank)
        for name, value in first["params"].items():
            np.testing.assert_array_equal(other["params"][name], value, err_msg=f"{rank} {name}")
    return first


def test_data_parallel_fit_validate_and_test_match_jax(runs, tmp_path):
    """data=2: each data index trains on its rows; the losses, the updated
    parameters, the validation loss and WER and the test WER are the JAX
    trainer's on the 2-device mesh."""
    ref = jax_fit(tmp_path, runs, case_named(CASES_2, "dp"), validate=True)
    ours = same_on_every_rank(runs["two"], "dp", 2)
    assert ours["count"] == 2 and ours["step"] == 4
    assert_matches_jax(ours, ref, runs["tree"], prefixes=("train/", "val/"))
    assert _scalars(ours["scalars"], "val/wer") == pytest.approx(
        _scalars(ref["scalars"], "val/wer"), abs=1e-9)
    assert ours["test"]["wer"] == pytest.approx(ref["test"]["wer"], abs=1e-9)
    assert runs["two"].result("dp", 1)["scalars"] is None  # rank 1 writes no scalars


def test_a_nan_row_on_one_rank_skips_the_step_on_every_rank(runs):
    start = from_jax_params(runs["tree"])
    for rank in range(2):
        out = runs["two"].result("nan", rank)
        assert out["count"] == 0 and out["step"] == 1
        assert out["params"].keys() == start.keys()
        for name, value in out["params"].items():
            np.testing.assert_array_equal(value, start[name], err_msg=name)
    scalars = runs["two"].result("nan", 0)["scalars"]
    assert ("train/skipped_steps", 1.0, 1) in scalars
    assert np.isnan(_scalars(scalars, "train/loss")[("train/loss", 1)])
