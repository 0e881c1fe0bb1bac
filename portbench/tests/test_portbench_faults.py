"""Whole runs of the tiny cells on the CPU, past the harness's look for a
card: a sound run is correct, and each fault the cell can have, planted in
the program underneath the timed path, makes ``correct`` come out false.

- training: a step that leaves its state unchanged; half the batch left
  out, the mean taken over the rest;
- serving: a token altered where the engine produces its answer; half the
  answers never coming.
(One chip: no cell has an exchange between chips to leave out.)
"""

from __future__ import annotations

import json
from concurrent.futures import Future

import pytest

from portbench.tests import tiny


@pytest.fixture
def cells(tmp_path):
    bench, root = tiny.make_root(tmp_path)
    for name in ("tiny.serve-open", "tiny.serve-closed"):
        path = root / "workloads" / f"{name}.json"
        w = json.loads(path.read_text())
        w["params"]["drain_s"] = 20  # a request left out never answers: keep the wait short
        path.write_text(json.dumps(w))
    return bench, root


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve-open", "tiny.serve-closed"])
def test_sound_run_is_correct(cells, cell):
    result, _ = tiny.run(*cells, cell, seed=2**31 + 7, seconds=1.0)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_train_state_left_unchanged(cells, monkeypatch):
    from mocov2_whisper_flamingo_torch.training.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, grads, ok=None: None)
    result, _ = tiny.run(*cells, "tiny.train")
    assert result["correct"] is False
    assert result["checks"]["delta_gap"]["value"] > result["checks"]["delta_gap"]["limit"]


def test_train_half_batch_left_out(cells, monkeypatch):
    from mocov2_whisper_flamingo_torch.training.task import AVSRTask

    step = AVSRTask.train_step

    def half(self, optimizer, batch, generator=None, skip_nonfinite=True):
        rows = batch["target_ids"].shape[0] // 2
        return step(self, optimizer, {k: v[:rows] for k, v in batch.items()}, generator,
                    skip_nonfinite)

    monkeypatch.setattr(AVSRTask, "train_step", half)
    result, _ = tiny.run(*cells, "tiny.train")
    assert result["correct"] is False


@pytest.mark.parametrize("cell", ["tiny.serve-open", "tiny.serve-closed"])
def test_serve_token_altered(cells, cell, monkeypatch):
    from mocov2_whisper_flamingo_torch.serving import continuous

    make = continuous._postprocess

    def altered(prefix, eos_id, tokenizer):
        post = make(prefix, eos_id, tokenizer)

        def run(row):
            toks, text = post(row)
            toks = toks.copy()
            toks[len(prefix) + 1] = (int(toks[len(prefix) + 1]) + 12345) % 51865
            return toks, text

        return run

    monkeypatch.setattr(continuous, "_postprocess", altered)
    result, _ = tiny.run(*cells, cell)
    assert result["correct"] is False
    assert result["checks"]["token_gap"]["value"] > result["checks"]["token_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.serve-open", "tiny.serve-closed"])
def test_serve_half_the_answers_never_come(cells, cell, monkeypatch):
    from mocov2_whisper_flamingo_torch.serving.continuous import ContinuousEngine

    submit = ContinuousEngine.submit
    calls = {"n": 0}

    def drop_every_other(self, *payload):
        calls["n"] += 1
        return Future() if calls["n"] % 2 == 0 else submit(self, *payload)

    monkeypatch.setattr(ContinuousEngine, "submit", drop_every_other)
    result, _ = tiny.run(*cells, cell)
    assert result["correct"] is False and result["failed"] > 0
