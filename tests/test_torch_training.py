"""The port's training path against the JAX package on the CPU, at a tiny
configuration: schedule, AVNet in train mode (logits and parameter
gradients), optimizer steps through the task, and the trainer's own rules
(non-finite guard, checkpoints, resume, top-k, early stopping, scalars)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.config import get_config as t_get_config
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_avnet_params, trainable_to_jax_tree)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.training import optim as TO
from mocov2_whisper_flamingo_torch.training.task import AVSRTask as TTask
from mocov2_whisper_flamingo_torch.training.trainer import (
    CheckpointManager, EarlyStopping, Trainer)
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from mocov2_whisper_flamingo_tpu.training import optim as JO
from mocov2_whisper_flamingo_tpu.training.task import AVSRTask as JTask

VOCAB = 48
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=64, max_target_positions=32)
LOGITS_ATOL = 1e-4  # fp32 logits after the whole trunk (as the serving slice's SLICE_ATOL)
LOSS_ATOL = 1e-4    # losses of size ~10
GRAD_ATOL = 2e-5    # parameter gradients: fp32, other summation orders
# Parameters after 3 AdamW updates at lr <= 1e-3: an update is lr * g / (|g| + 1e-6), so
# where |g| is near eps a gradient difference of 1e-8 moves the update by ~1e-2 * lr.
PARAM_ATOL = 2e-5


def _modelargs(dropout):
    return (32, 4, 2, 3000, 128, dropout)


def _jax_net(dropout):
    net = JNet("audiovisual", None, 96, _modelargs(dropout), VOCAB, whisper_name="whisper-tiny",
               backend="xla")
    cfg = JConfig(**TINY)
    net.whisper_config = cfg
    net.whisper_encoder = JEncoder(cfg, net.precision, "xla")
    return net


def _torch_net(dropout, tree=None, remat=False):
    net = TNet("audiovisual", None, 96, _modelargs(dropout), VOCAB, device="cpu",
               whisper_config=TConfig(**TINY), remat=remat)
    return load_jax_params(net, tree if tree is not None else _tree())


def _tree(seed=0):
    """Random weights in the JAX layout, fusion gates at 0.5 so that every
    trainable leaf has a gradient."""
    probe = TNet("audiovisual", None, 96, _modelargs(0.0), VOCAB, device="cpu",
                 whisper_config=TConfig(**TINY))
    tree = random_avnet_params(probe, seed)
    for layer in tree["fusion"]["layers"]:
        layer["attn_gate"] = np.float32(0.5)
        layer["ff_gate"] = np.float32(0.5)
    return tree


def _batches(n=3, b=2, tv=6, l_target=5, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(2, l_target + 1, (b,)).astype(np.int32)
        ids = rng.integers(1, VOCAB, (b, l_target)).astype(np.int32)
        ids = np.where(np.arange(l_target)[None, :] < lens[:, None], ids, 0)
        out.append({
            "audio": rng.standard_normal((b, 80, 128)).astype(np.float32),
            "audio_mask": np.ones((b, 128), bool),
            "audio_lengths": np.full((b,), 64, np.int32),
            "video": rng.standard_normal((b, tv, 3, 32, 32)).astype(np.float32),
            "video_mask": np.ones((b, tv), bool),
            "video_lengths": np.array([tv, max(tv - 2, 1)] * b, np.int32)[:b],
            "target_ids": ids,
            "target_lengths": lens,
        })
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _named(jtree) -> dict:
    """JAX tree -> {dotted name: array}, named as the port names its parameters."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    return {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _trainable(named: dict) -> dict:
    return {k: v for k, v in named.items() if TNet.trainable_filter(k)}


# -- schedule ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,pct", [(10, 0.1), (37, 0.1), (40, 0.3), (3, 0.5), (1, 0.1)])
def test_one_cycle_lr_matches_jax_at_every_step(total, pct):
    ours = TO.one_cycle_lr(1e-3, total, pct_start=pct)
    ref = JO.one_cycle_lr(1e-3, total, pct_start=pct)
    for count in range(total + 3):  # and past the end, where both stay at the floor
        assert ours(count) == pytest.approx(float(ref(count)), rel=2e-6, abs=1e-12)
    assert ours(0) == pytest.approx(1e-3 / 25)


def test_no_decay_mask_matches_jax():
    net = _torch_net(0.0)
    jmask = _named(JO.no_decay_mask(jax.tree.map(jnp.asarray, trainable_to_jax_tree(net))))
    ours = {n: TO.no_decay_mask(n, p) for n, p in net.trainable_parameters()}
    assert ours == {k: bool(v) for k, v in jmask.items()}
    assert ours["fusion.layers.0.ff1.kernel"] and not ours["fusion.layers.0.attn_gate"]


# -- AVNet in train mode ---------------------------------------------------------------------


def test_trainable_tree_is_the_trainable_part_of_the_jax_tree():
    tree = _tree()
    net = _torch_net(0.0, tree)
    ours = _named(trainable_to_jax_tree(net))
    ref = _trainable(_named(tree))
    assert sorted(ours) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name])
    assert all(p.requires_grad for _, p in net.trainable_parameters())
    frozen = [p for n, p in net.named_parameters() if not TNet.trainable_filter(n)]
    assert frozen and not any(p.requires_grad for p in frozen)


@pytest.mark.parametrize("mode", ["dropout_0_with_generator", "dropout_0.1_without_generator"])
def test_train_forward_and_parameter_gradients_match_jax(mode):
    """``forward(train=True)`` with nothing to drop (rate 0, or no generator):
    logits, losses and every trainable parameter's gradient against ``jax.grad``
    of the JAX ``loss_fn``; the frozen trees get no gradient."""
    rate = 0.0 if mode.startswith("dropout_0_") else 0.1
    tree = _tree()
    batch = _batches(1)[0]
    jnet = _jax_net(rate)
    jtask = JTask(jnet, label_smoothing=0.1)
    params = jax.tree.map(jnp.asarray, tree)
    rng = jax.random.PRNGKey(0) if rate == 0.0 else None
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtask.loss_fn(p, b, rng, True), has_aux=True))(params, _j(batch))

    net = _torch_net(rate, tree)
    task = TTask(net, label_smoothing=0.1)
    gen = torch.Generator().manual_seed(0) if rate == 0.0 else None
    tb = _t(batch)
    inputs = (tb["audio"], tb["audio_mask"], tb["video"], tb["video_mask"], tb["video_lengths"])
    logits, gates = net(inputs, train=True, generator=gen, return_gates=True)
    jlogits, jgates = jax.jit(lambda p, b: jnet.forward(p, b, train=True, rng=rng,
                                                        return_gates=True))(
        params, tuple(jnp.asarray(batch[k]) for k in (
            "audio", "audio_mask", "video", "video_mask", "video_lengths")))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=LOGITS_ATOL,
                               rtol=0)
    assert sorted(gates) == sorted(jgates)
    for name in gates:
        assert float(gates[name].detach()) == pytest.approx(float(jgates[name]), abs=1e-6)

    loss, losses = task.loss_fn(tb, gen, train=True)
    for name in ("ctc_loss", "ce_loss", "loss"):
        assert float(losses[name].detach()) == pytest.approx(float(jlosses[name]), abs=LOSS_ATOL)
    loss.backward()
    ref = _trainable(_named(jgrads))
    for name, param in net.named_parameters():
        if TNet.trainable_filter(name):
            assert np.abs(ref[name]).max() > 0, name  # gates at 0.5: every leaf is reached
            np.testing.assert_allclose(param.grad.numpy(), ref[name], atol=GRAD_ATOL, rtol=0,
                                       err_msg=name)
        else:
            assert param.grad is None, name


def test_forward_features_and_feature_mse_match_jax():
    tree = _tree()
    batch = _batches(1)[0]
    jtask = JTask(_jax_net(0.0), loss_mode="feature_mse")
    params = jax.tree.map(jnp.asarray, tree)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtask.loss_fn(p, b, None, True), has_aux=True))(params, _j(batch))
    net = _torch_net(0.0, tree)
    loss, losses = TTask(net, loss_mode="feature_mse").loss_fn(_t(batch), None, train=True)
    assert sorted(losses) == ["cosine_sim", "loss"]
    for name in losses:
        assert float(losses[name].detach()) == pytest.approx(float(jlosses[name]), abs=1e-5)
    loss.backward()
    ref = _trainable(_named(jgrads))
    for name, param in net.trainable_parameters():
        if name.startswith("decoder."):  # the head is not on this objective's path
            assert param.grad is None and not np.any(ref[name])
        else:
            np.testing.assert_allclose(param.grad.numpy(), ref[name], atol=GRAD_ATOL, rtol=0,
                                       err_msg=name)


def test_eval_step_matches_jax_and_pad_to_ignore_changes_only_the_ce():
    tree = _tree()
    batch = _batches(1)[0]
    params = jax.tree.map(jnp.asarray, tree)
    net = _torch_net(0.0, tree)
    for pad in (False, True):
        jlosses, jpreds = jax.jit(JTask(_jax_net(0.0), pad_to_ignore=pad).make_eval_step())(
            params, _j(batch))
        losses, preds = TTask(net, pad_to_ignore=pad).eval_step(_t(batch))
        np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
        for name in ("ctc_loss", "ce_loss", "loss"):
            assert float(losses[name]) == pytest.approx(float(jlosses[name]), abs=LOSS_ATOL)
        if pad:
            assert float(losses["ctc_loss"]) == pytest.approx(ctc_before, abs=1e-6)
            assert abs(float(losses["ce_loss"]) - ce_before) > 1e-3
        ctc_before, ce_before = float(losses["ctc_loss"]), float(losses["ce_loss"])
    assert TTask.decode_predictions(preds, ByteTokenizer()) == ByteTokenizer().batch_decode(
        preds.numpy())


@pytest.mark.parametrize("remat", [False, True])
def test_fusion_dropout_draws_and_remat_replay(remat):
    """Dropout 0.5 in train mode: the draws follow the generator; under
    ``remat`` the recompute replays them (same gradients as without), and the
    generator ends where a run without remat leaves it."""
    tree = _tree()
    batch = _t(_batches(1)[0])

    def run(remat_, seed):
        net = _torch_net(0.5, tree, remat=remat_)
        gen = torch.Generator().manual_seed(seed)
        loss, _ = TTask(net).loss_fn(batch, gen, train=True)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in net.trainable_parameters()}
        return float(loss), grads, gen.get_state()

    loss_a, grads_a, state_a = run(remat, 5)
    loss_b, grads_b, state_b = run(False, 5)
    loss_c, _, _ = run(remat, 6)
    assert loss_a == pytest.approx(loss_b, abs=1e-6) and abs(loss_a - loss_c) > 1e-4
    assert torch.equal(state_a, state_b)
    for name in grads_a:
        torch.testing.assert_close(grads_a[name], grads_b[name], atol=1e-6, rtol=0, msg=name)
    # eval mode ignores the generator
    net = _torch_net(0.5, tree)
    inputs = tuple(batch[k] for k in ("audio", "audio_mask", "video", "video_mask",
                                      "video_lengths"))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        assert torch.equal(net(inputs, train=False, generator=gen), net(inputs))
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(5).get_state())


# -- optimizer steps -----------------------------------------------------------------------

TRAINING = {"max_lr": 1e-3, "warmup_ratio": 0.1, "weight_decay": 0.01,
            "gradient_clip_val": 1.0}


@pytest.mark.parametrize("accum,no_decay", [(1, False), (1, True), (2, False), (2, True)])
def test_three_optimizer_updates_match_jax(accum, no_decay):
    """3 updates (3 * accum micro-batches), fp32: per-step losses and the
    trainable parameters against ``make_train_step`` with the JAX
    ``make_optimizer``; frozen parameters do not move."""
    updates = 3
    cfg = dict(TRAINING, accumulate_grad_batches=accum)
    tree = _tree()
    batches = _batches(updates * accum)

    jnet = _jax_net(0.0)
    params = jax.tree.map(jnp.asarray, tree)
    jopt, _ = JO.make_optimizer(cfg, 10, JO.trainable_mask_for(jnet, params),
                                decay_mask=JO.no_decay_mask if no_decay else None)
    jstep = jax.jit(JTask(jnet).make_train_step(jopt))
    opt_state = jopt.init(params)

    net = _torch_net(0.0, tree)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    task = TTask(net)
    opt, schedule = TO.make_optimizer(cfg, 10, net.trainable_parameters(),
                                      decay_mask=TO.no_decay_mask if no_decay else None)
    gen = torch.Generator().manual_seed(0)
    for i, batch in enumerate(batches):
        params, opt_state, jlosses = jstep(params, opt_state, _j(batch), jax.random.PRNGKey(i))
        losses = task.train_step(opt, _t(batch), gen)
        assert float(losses["skipped"]) == 0.0 == float(jlosses["skipped"])
        for name in ("ctc_loss", "ce_loss", "loss"):
            assert float(losses[name]) == pytest.approx(float(jlosses[name]), abs=LOSS_ATOL), i
    assert opt.count == updates and opt.mini_step == 0

    ref = _named(params)
    moved = 0.0
    for name, param in net.named_parameters():
        if TNet.trainable_filter(name):
            np.testing.assert_allclose(param.detach().numpy(), ref[name], atol=PARAM_ATOL,
                                       rtol=0, err_msg=name)
            moved = max(moved, (param.detach() - before[name]).abs().max().item())
        else:
            assert torch.equal(param, before[name]), name
    assert moved > 1e-4  # the comparison is not between two nets that stood still
    ours_tree = _named(trainable_to_jax_tree(net))
    for name, value in ours_tree.items():
        np.testing.assert_allclose(value, ref[name], atol=PARAM_ATOL, rtol=0)


def test_clip_divides_by_the_norm_itself():
    p = torch.nn.Parameter(torch.zeros(4))
    opt = TO.Optimizer([("w.kernel", p)], dict(TRAINING, weight_decay=0.0), 10)
    seen = []
    opt._adamw = lambda g, apply: seen.append(g.clone())  # the clipped gradient AdamW takes
    opt.step([torch.tensor([3.0, 4.0, 0.0, 0.0])])   # norm 5 -> scaled to norm 1
    opt.step([torch.tensor([0.3, 0.4, 0.0, 0.0])])   # norm 0.5 -> untouched
    opt.step([torch.zeros(4)])                       # norm 0 -> untouched, no NaN
    torch.testing.assert_close(seen[0], torch.tensor([0.6, 0.8, 0.0, 0.0]), atol=1e-7, rtol=0)
    torch.testing.assert_close(seen[1], torch.tensor([0.3, 0.4, 0.0, 0.0]), atol=0, rtol=0)
    assert torch.equal(seen[2], torch.zeros(4))


@pytest.mark.parametrize("accum", [1, 2])
def test_nonfinite_guard_changes_nothing(accum):
    net = _torch_net(0.0)
    task = TTask(net)
    opt, _ = TO.make_optimizer(dict(TRAINING, accumulate_grad_batches=accum), 10,
                               net.trainable_parameters())
    good, other = (_t(b) for b in _batches(2))
    gen = torch.Generator().manual_seed(0)
    task.train_step(opt, good, gen)  # one good micro-batch: state to protect
    snapshot = copy.deepcopy(opt.state_dict())
    params = {n: p.detach().clone() for n, p in net.named_parameters()}

    bad = dict(other, audio=torch.full_like(other["audio"], float("nan")))
    losses = task.train_step(opt, bad, gen)
    assert float(losses["skipped"]) == 1.0 and not np.isfinite(float(losses["loss"]))
    for name, param in net.named_parameters():
        assert torch.equal(param, params[name]), name
    after = opt.state_dict()
    assert (after["count"], after["mini_step"]) == (snapshot["count"], snapshot["mini_step"])
    assert after["count"] + after["mini_step"] == 1
    if accum == 2:
        for a, b in zip(after["mean"], snapshot["mean"]):
            assert torch.equal(a, b)
    for key, state in snapshot["adamw"]["state"].items():
        for field, value in state.items():
            assert torch.equal(after["adamw"]["state"][key][field], value)

    # without the guard the step is applied and poisons the parameters
    losses = task.train_step(opt, bad, gen, skip_nonfinite=False)
    assert "skipped" not in losses
    if accum == 1:
        assert not all(bool(torch.isfinite(p).all()) for _, p in net.trainable_parameters())


# -- trainer ---------------------------------------------------------------------------------


class _Writer:
    """Stands in for the TensorBoard writer: records the scalars."""

    def __init__(self, path):
        self.path, self.scalars = path, []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


class _DataModule:
    def __init__(self, n_batches=2, crash_in_epoch=None):
        self.batches = _batches(n_batches)
        for batch in self.batches:
            batch["target_text"] = ["xin chao"] * len(batch["target_ids"])
        self.crash_in_epoch = crash_in_epoch
        self.epoch = 0

    def train_dataloader(self):
        dm = self

        class Loader(list):
            def set_epoch(self, epoch):
                dm.epoch = epoch

            def __iter__(self):
                if dm.crash_in_epoch is not None and dm.epoch >= dm.crash_in_epoch:
                    raise KeyboardInterrupt("the run is cut here")
                return super().__iter__()

        return Loader(self.batches)

    def val_dataloader(self):
        return self.batches[:1]

    def test_dataloader(self):
        return self.batches[:1]


def _config(tmp_path, **overrides):
    cfg = {"training.epochs": 2, "training.accumulate_grad_batches": 1,
           "output.checkpoint_dir": str(tmp_path / "ckpt"),
           "output.log_dir": str(tmp_path / "logs"), "output.log_every_n_steps": 1,
           "precision.compute_dtype": "float32"}
    cfg.update(overrides)
    return t_get_config(cfg)


def _trainer(tmp_path, net=None, **overrides):
    trainer = Trainer(_config(tmp_path, **overrides), net or _torch_net(0.0), ByteTokenizer(),
                      device="cpu")
    trainer.writer = _Writer(trainer.writer.path)
    return trainer


def test_fit_writes_the_reference_scalars_and_a_checkpoint(tmp_path):
    trainer = _trainer(tmp_path)
    frozen = {n: p.detach().clone() for n, p in trainer.net.named_parameters()
              if not TNet.trainable_filter(n)}
    trainer.step_timestamps = []
    net = trainer.fit(_DataModule())
    assert net is trainer.net and trainer.global_step == 4 and len(trainer.step_timestamps) == 4
    tags = {tag for tag, _, _ in trainer.writer.scalars}
    assert tags == {"train/ctc_loss", "train/ce_loss", "train/loss", "lr",
                    "train_attn_gate_0", "train_ff_gate_0",
                    "val/ctc_loss", "val/ce_loss", "val/loss", "val/wer"}
    assert all(np.isfinite(v) for _, v, _ in trainer.writer.scalars)
    lrs = [(step, v) for tag, v, step in trainer.writer.scalars if tag == "lr"]
    for step, value in lrs:
        assert value == pytest.approx(trainer.schedule(step))  # accumulation 1
    for name, param in trainer.net.named_parameters():
        if name in frozen:
            assert torch.equal(param, frozen[name]), name
    run_dir = os.path.dirname(trainer.writer.path)
    hparams = json.load(open(os.path.join(run_dir, "hparams.json")))
    assert hparams["training_max_lr"] == 1e-3 and hparams["model_d_model"] == 512
    assert "training_max_lr: 0.001" in open(os.path.join(run_dir, "hparams.yaml")).read()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["last.json", "step_2.pt", "step_4.pt"]

    metrics = trainer.test(_DataModule())
    assert 0.0 <= metrics["wer"] and ("test/wer", metrics["wer"], 4) in trainer.writer.scalars
    text = open(os.path.join(run_dir, "predictions.txt")).read()
    assert text.count("Pred: ") == 2 and text.count("Target: xin chao") == 2


def test_lr_scalar_is_read_at_the_update_count(tmp_path):
    trainer = _trainer(tmp_path, **{"training.accumulate_grad_batches": 2})
    trainer.fit(_DataModule())
    assert trainer.optimizer.count == 2  # 4 micro-batches
    for tag, value, step in trainer.writer.scalars:
        if tag == "lr":
            assert value == pytest.approx(trainer.schedule(step // 2))


def test_checkpoint_round_trip(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.fit(_DataModule(), max_steps=2)
    restored = trainer.ckpt.restore()
    assert restored["step"] == 2 and sorted(restored) == ["opt_state", "params", "step"]
    for name, value in trainer.net.state_dict().items():
        assert torch.equal(restored["params"][name], value), name
    assert restored["opt_state"]["count"] == 2
    fresh = _torch_net(0.0, _tree(seed=3))
    fresh.load_state_dict(restored["params"])
    batch = _t(_batches(1)[0])
    inputs = tuple(batch[k] for k in ("audio", "audio_mask", "video", "video_mask",
                                      "video_lengths"))
    with torch.no_grad():
        assert torch.equal(fresh(inputs), trainer.net(inputs))


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    whole = _trainer(tmp_path / "whole")
    whole.fit(_DataModule())  # 2 epochs of 2 steps

    cut = _trainer(tmp_path / "cut")
    with pytest.raises(KeyboardInterrupt):
        cut.fit(_DataModule(crash_in_epoch=1))
    assert cut.global_step == 2

    resumed = _trainer(tmp_path / "cut", net=_torch_net(0.0, _tree(seed=9)))
    resumed.fit(_DataModule(), max_steps=4, resume="last")
    assert resumed.global_step == 4 and resumed.optimizer.count == 4
    for (name, a), (_, b) in zip(whole.net.named_parameters(), resumed.net.named_parameters()):
        assert torch.equal(a, b), name


def test_checkpoint_topk_evicts_last_when_the_pointer_moves(tmp_path):
    """A worsening metric with top-k full: the newest checkpoint is the worst
    and is still the ``last`` pointer, so its deletion waits for the next save."""
    mgr = CheckpointManager(str(tmp_path), save_top_k=2)
    files = lambda: sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
    for step, metric in ((1, 1.0), (2, 2.0), (3, 3.0)):
        mgr.save({"params": {"w": torch.full((2,), float(step))}, "opt_state": {}, "step": step},
                 step, metric)
    assert files() == ["step_1.pt", "step_2.pt", "step_3.pt"]  # 3 evicted, deletion deferred
    assert mgr.restore()["step"] == 3
    mgr.save({"params": {}, "opt_state": {}, "step": 4}, 4, 4.0)
    assert files() == ["step_1.pt", "step_2.pt", "step_4.pt"]
    mgr.save({"params": {}, "opt_state": {}, "step": 5}, 5, 0.5)  # a better one evicts step 2
    assert files() == ["step_1.pt", "step_5.pt"]
    assert json.load(open(tmp_path / "last.json"))["step"] == 5
    assert float(mgr.restore(str(tmp_path / "step_1.pt"))["params"]["w"][0]) == 1.0


def test_early_stopping_patience_semantics():
    es = EarlyStopping(patience=2)
    assert [es.update(v) for v in (1.0, 0.9, 0.95, 0.91)] == [False, False, False, True]
    es = EarlyStopping(patience=2)
    assert [es.update(v) for v in (1.0, 1.1, 0.5, 0.6, 0.7)] == [False, False, False, False, True]
    es = EarlyStopping(patience=1, mode="max")
    assert [es.update(v) for v in (0.1, 0.2, 0.2)] == [False, False, True]


def test_early_stopping_ends_fit(tmp_path):
    trainer = _trainer(tmp_path, **{"training.epochs": 5, "training.max_lr": 0.0,
                                    "training.weight_decay": 0.0,
                                    "training.early_stopping_patience": 2})
    trainer.fit(_DataModule())  # nothing learns at lr 0: validation never improves
    assert trainer.global_step == 6  # epochs 0 (best), 1 and 2, then stop


def test_feature_mse_mode_trains_through_the_trainer(tmp_path):
    trainer = _trainer(tmp_path, **{"training.loss_mode": "feature_mse", "training.epochs": 1})
    head = trainer.net.decoder.kernel.detach().clone()
    trainer.fit(_DataModule())
    tags = {tag for tag, _, _ in trainer.writer.scalars}
    assert {"train/loss", "val/loss", "val/cosine_sim", "val/wer"} <= tags
    assert "train/ctc_loss" not in tags
    # the head is off this objective's path: only weight decay moves it
    ratio = (trainer.net.decoder.kernel.detach() / head).flatten()
    assert ratio.max().item() < 1.0 and ratio.min().item() > 0.999


@pytest.mark.parametrize("case", ["mesh_larger_than_the_world", "local_rank_beyond_the_cards"])
def test_later_slice_settings_raise(tmp_path, monkeypatch, case):
    """The multi-card settings that cannot run raise ``ValueError``: a mesh
    larger than the processes of the run (as the JAX ``make_mesh`` raises),
    and a torchrun ``LOCAL_RANK`` that names a card the host does not have
    (processes never share a card silently)."""
    if case == "mesh_larger_than_the_world":
        with pytest.raises(ValueError, match="does not cover the 1 processes"):
            _trainer(tmp_path, **{"mesh.data": 4})
    else:
        from mocov2_whisper_flamingo_torch import train

        monkeypatch.setenv("LOCAL_RANK", "2")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(ValueError, match="LOCAL_RANK=2 but this host has 2 CUDA"):
            train.rank_device("cuda")
        assert train.rank_device("cpu") == "cpu"


def test_frozen_param_dtype_bf16_casts_only_the_frozen_trees(tmp_path):
    trainer = _trainer(tmp_path, **{"training.frozen_param_dtype": "bf16",
                                    "training.epochs": 1})
    trainer.fit(_DataModule(), max_steps=1)
    for name, param in trainer.net.named_parameters():
        want = torch.float32 if TNet.trainable_filter(name) else torch.bfloat16
        assert param.dtype == want, name
    assert np.isfinite([v for tag, v, _ in trainer.writer.scalars if tag == "val/loss"]).all()


def test_on_device_augmentation_runs_in_the_train_step_only(tmp_path):
    trainer = _trainer(tmp_path, **{"augmentation.on_device": True, "training.epochs": 1})
    assert trainer.task.augment_fn is not None
    batch = _t(_batches(1)[0])
    batch["video"] = torch.randint(0, 255, batch["video"].shape).to(torch.uint8)
    batch["audio"] = batch["audio"].transpose(1, 2).contiguous()  # raw mel [B, T, F]
    gen = torch.Generator().manual_seed(0)
    out = trainer.task.augment_fn(batch, gen)
    assert out["audio"].shape == batch["audio"].shape and out["video"].dtype == torch.float32
    per_clip = out["audio"].reshape(2, -1)
    torch.testing.assert_close(per_clip.mean(dim=1), torch.zeros(2), atol=1e-4, rtol=0)
    torch.testing.assert_close(per_clip.var(dim=1, unbiased=False), torch.ones(2), atol=1e-3,
                               rtol=0)
    # a packed waveform batch (augmentation.on_device_mel): the mel is made in the step
    wave = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 480200)) * 0.1).float()
    packed = trainer.task.augment_fn(dict(batch, audio=wave,
                                          audio_mask=torch.ones((2, 3000), dtype=torch.bool)), gen)
    assert packed["audio"].shape == (2, 3000, 80) and bool(torch.isfinite(packed["audio"]).all())


def test_smoke_entry_point_on_the_cpu(tmp_path, monkeypatch):
    from mocov2_whisper_flamingo_torch import train

    monkeypatch.chdir(tmp_path)
    assert train.main(["--smoke", "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["last.json", "step_2.pt"]
    run_dir = tmp_path / "logs" / "avsr_logs" / "version_0"
    assert {"hparams.json", "hparams.yaml", "predictions.txt"} <= set(os.listdir(run_dir))
    assert train.main(["--smoke", "--device", "cpu", "--resume", "last", "--max-steps", "3"]) == 0
    assert json.load(open(tmp_path / "checkpoints" / "last.json"))["step"] == 3


def test_entry_point_without_smoke_says_what_is_missing(capsys, tmp_path):
    from mocov2_whisper_flamingo_torch import train

    assert train.main(["--device", "cpu", "--set", f"data.root_dir={tmp_path}"]) == 2
    err = capsys.readouterr().err
    assert "data module" in err and "train_video_seg12s" in err
