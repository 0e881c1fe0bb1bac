"""Tensor parallelism in the port's trainer, model=2 over two gloo processes
on the CPU, against the JAX ``Trainer`` on the same mesh shape: the split
encoder, fusion and vocabulary head; checkpoints that hold whole tensors
(loaded by one process, resumed at model=2 and by one process); and the int8
frozen encoder, whose ``kernel_q`` and scales split with their float kernel's
rule. Helpers and tolerances of tests/test_torch_multicard.py."""

import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.config import get_config
from mocov2_whisper_flamingo_torch.training.trainer import Trainer
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer

from test_torch_multicard import (
    Ranks, _GlobalDataModule, _Writer, assert_matches_jax, case_named, global_batches, jax_fit,
    same_on_every_rank)
from test_torch_training import PARAM_ATOL, VOCAB, _torch_net, _tree
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

CASES = [
    {"name": "tp", "mesh": (1, 2), "batches": "half", "epochs": 2, "max_steps": 4},
    {"name": "tp_resume", "mesh": (1, 2), "batches": "half", "epochs": 2, "max_steps": 4,
     "resume": "tp/ckpt/step_2.pt"},
    # accumulation 1: the JAX step's MultiSteps cannot carry int8 leaves
    {"name": "int8", "mesh": (1, 2), "batches": "main", "max_steps": 2,
     "overrides": {"training.frozen_weight_quant": "int8", "training.accumulate_grad_batches": 1}},
]
for _case in CASES:
    _case["vocab"] = VOCAB


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, batches = _tree(), global_batches()
    two = Ranks(tmp_path_factory.mktemp("two_ranks"), 2, CASES, tree, batches)
    yield {"tree": tree, "batches": batches, "two": two}
    two.kill()


def test_tensor_parallel_fit_matches_jax(runs, tmp_path):
    """model=2, vocabulary 48: the encoder's and the fusion's heads, their
    feed-forward layers and the CTC head are split over the two ranks."""
    ref = jax_fit(tmp_path, runs, case_named(CASES, "tp"))
    ours = same_on_every_rank(runs["two"], "tp", 2)
    assert ours["count"] == 2 and [runs["two"].result("tp", r)["mesh"] for r in range(2)] == [
        (0, 0), (0, 1)]
    assert_matches_jax(ours, ref, runs["tree"])


def test_tensor_parallel_checkpoint_loads_on_one_process_and_resumes(runs, tmp_path):
    """The model=2 run's checkpoints hold whole tensors: one process loads
    them and gets the run's parameters; the model=2 resume from step 2
    reproduces the run exactly, and one process resuming from the same
    checkpoint reproduces it within the tolerance."""
    tp = runs["two"].result("tp")
    ckpt = runs["two"].workdir / "tp" / "ckpt"
    restored = torch.load(ckpt / "step_4.pt", weights_only=True)
    net = _torch_net(0.0, _tree(seed=3))
    net.load_state_dict(restored["params"])
    for name, value in net.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), tp["params"][name], err_msg=name)
    shapes = [tuple(p.shape) for _, p in net.trainable_parameters()]
    moments = restored["opt_state"]["adamw"]["state"]
    assert sorted(tuple(s["exp_avg"].shape) for s in moments.values()) == sorted(shapes)

    resumed = runs["two"].result("tp_resume")
    assert resumed["step"] == 4 and resumed["count"] == 2
    for name, value in tp["params"].items():
        np.testing.assert_array_equal(resumed["params"][name], value, err_msg=name)

    config = get_config({
        "training.epochs": 2, "training.accumulate_grad_batches": 2, "training.max_lr": 1e-3,
        "model.dropout": 0.0, "precision.compute_dtype": "float32",
        "precision.rematerialize": False, "output.checkpoint_dir": str(tmp_path / "ckpt"),
        "output.log_dir": str(tmp_path / "logs")})
    one = Trainer(config, _torch_net(0.0, _tree(seed=4)), ByteTokenizer(), device="cpu")
    one.writer = _Writer(one.writer.path)
    one.fit(_GlobalDataModule(runs["batches"]["half"]), max_steps=4,
            resume=str(ckpt / "step_2.pt"))
    for name, param in one.net.trainable_parameters():
        np.testing.assert_allclose(param.detach().numpy(), tp["params"][name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_int8_frozen_encoder_under_tensor_parallelism_matches_jax(runs, tmp_path):
    """``frozen_weight_quant: int8`` at model=2: the port splits ``kernel_q``
    and its scales with the float kernel's rule (the JAX rules leave them
    whole); a row shard's scales are the whole kernel's, so the gathered
    int8 leaves equal the JAX tree's bit for bit."""
    ref = jax_fit(tmp_path, runs, case_named(CASES, "int8"))
    ours = same_on_every_rank(runs["two"], "int8", 2)
    assert ours["count"] == 2
    assert_matches_jax(ours, ref, runs["tree"])
    quantized = [n for n in ours["params"] if n.endswith("kernel_q")]
    assert len(quantized) == 6
    for name in quantized + [n[: -len("kernel_q")] + "scale" for n in quantized]:
        np.testing.assert_array_equal(ours["params"][name], np.asarray(ref["params"][name]),
                                      err_msg=name)

