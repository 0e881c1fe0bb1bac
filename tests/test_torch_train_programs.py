"""The train program (``training/programs.py``) and the device-state
optimizer on the CPU, at a tiny size: the optimizer against optax's
``MultiSteps`` + AdamW + the JAX step's non-finite guard, the schedule read
from a device count against the host's and optax's, the program's eager
step against ``AVSRTask.train_step`` bit for bit, the capture's sequence,
the losses' CTC through its wrapper with the batch's own lengths, and the
program's key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.config import get_config as t_get_config
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.ops import losses as TL
from mocov2_whisper_flamingo_torch.training import optim as TO
from mocov2_whisper_flamingo_torch.training.programs import TrainProgram, step_kind
from mocov2_whisper_flamingo_torch.training.task import AVSRTask as TTask
from mocov2_whisper_flamingo_torch.training.trainer import Trainer
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer
from mocov2_whisper_flamingo_tpu.training import optim as JO
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

VOCAB = 48
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=64, max_target_positions=32)
TRAINING = {"max_lr": 1e-3, "warmup_ratio": 0.3, "weight_decay": 0.01,
            "gradient_clip_val": 1.0}
STATE_ATOL = 1e-6  # fp32 moments and parameters after a few updates at lr <= 1e-3


# -- the optimizer against optax -------------------------------------------------------


def _named_tree(rng):
    """Parameters named as the port names them and the same as a JAX tree."""
    values = {"proj.kernel": rng.standard_normal((6, 5)).astype(np.float32),
              "proj.bias": rng.standard_normal((5,)).astype(np.float32),
              "block.attn_gate": np.float32(0.5),
              "head.kernel": rng.standard_normal((5, 3)).astype(np.float32)}
    tree = {}
    for name, value in values.items():
        outer, inner = name.split(".")
        tree.setdefault(outer, {})[inner] = jnp.asarray(value)
    return values, tree


def _leaf(tree, name):
    outer, inner = name.split(".")
    return np.asarray(tree[outer][inner])


def _find(state, attr):
    """The first object in an optax state that has ``attr``."""
    if hasattr(state, attr):
        return state
    if isinstance(state, (tuple, list)):
        for part in state:
            found = _find(part, attr)
            if found is not None:
                return found
    return None


def _port_state(opt) -> dict:
    """Every tensor of the port's state, the parameters included, copied."""
    out = {f"param.{i}": p.detach().clone() for i, p in enumerate(opt.params)}
    out.update({f"state.{i}": t.clone() for i, t in enumerate(opt.state_tensors())})
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_device_state_optimizer_matches_optax_and_the_guard(accum):
    """Micro-batches through ``Optimizer.step(grads, ok)`` and through the
    JAX step's ``MultiSteps`` + AdamW + ``where(ok, ...)``: parameters,
    moments, counts and the running mean agree after each; a poisoned
    micro-batch in the middle of an accumulation changes no state, here bit
    for bit."""
    rng = np.random.default_rng(0)
    values, params = _named_tree(rng)
    cfg = dict(TRAINING, accumulate_grad_batches=accum)
    jopt, _ = JO.make_optimizer(cfg, 6, decay_mask=JO.no_decay_mask(params))

    @jax.jit
    def jstep(params, state, grads, ok):
        updates, new_state = jopt.update(grads, state, params)
        updates = jax.tree.map(lambda u: jnp.where(ok, u, 0.0), updates)
        new_state = jax.tree.map(lambda n, o: jnp.where(ok, n, o) if hasattr(n, "shape") else n,
                                 new_state, state)
        return jax.tree.map(lambda p, u: p + u, params, updates), new_state

    jstate = jopt.init(params)
    named = [(n, torch.nn.Parameter(torch.from_numpy(np.array(v)))) for n, v in values.items()]
    opt = TO.Optimizer(named, cfg, 6, decay_mask=TO.no_decay_mask)
    # the poisoned micro-batch is the second: with accum 2 it falls between
    # the two halves of an update
    poisoned = {1}
    for i in range(3 * accum + 1):
        ok = i not in poisoned
        grads = {n: (rng.standard_normal(v.shape) if ok else np.full(np.shape(v), np.nan))
                 .astype(np.float32) for n, v in values.items()}
        before = _port_state(opt)
        jgrads = {o: {k: jnp.asarray(grads[f"{o}.{k}"]) for k in params[o]} for o in params}
        jparams, jnew = jstep(params, jstate, jgrads, jnp.asarray(ok))
        opt.step([torch.from_numpy(grads[n]) for n, _ in named], torch.tensor(ok))
        if not ok:
            after = _port_state(opt)
            assert all(torch.equal(after[k], before[k]) for k in before), i
            for a, b in zip(jax.tree.leaves(jnew), jax.tree.leaves(jstate)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        params, jstate = jparams, jnew
        adam = _find(jstate, "mu")
        for slot, (m, v) in enumerate(zip(opt._slots(opt.exp_avg), opt._slots(opt.exp_avg_sq))):
            name = named[opt.order[slot]][0]
            np.testing.assert_allclose(m.numpy(), _leaf(adam.mu, name), atol=STATE_ATOL, rtol=0)
            np.testing.assert_allclose(v.numpy(), _leaf(adam.nu, name), atol=STATE_ATOL, rtol=0)
        for name, p in named:
            np.testing.assert_allclose(p.detach().numpy(), _leaf(params, name),
                                       atol=STATE_ATOL, rtol=0, err_msg=f"{name} at {i}")
        assert opt.count == int(adam.count)
        if accum > 1:
            multi = _find(jstate, "mini_step")
            assert opt.mini_step == int(multi.mini_step)
            by_param = dict(zip(opt.order, opt._slots(opt._mean)))
            for k, (name, _) in enumerate(named):
                np.testing.assert_allclose(by_param[k].numpy(), _leaf(multi.acc_grads, name),
                                           atol=STATE_ATOL, rtol=0)
    assert opt.count == 3 and opt.mini_step == 0


def test_state_dict_keeps_the_adamw_layout_and_round_trips():
    """``state_dict`` in ``torch.optim.AdamW``'s layout; a state written by
    ``torch.optim.AdamW`` (as checkpoints before the device state held it)
    loads, and a loaded optimizer continues as the saved one does."""
    rng = np.random.default_rng(1)
    values, _ = _named_tree(rng)
    cfg = dict(TRAINING, accumulate_grad_batches=2)

    def make():
        named = [(n, torch.nn.Parameter(torch.from_numpy(np.array(v))))
                 for n, v in values.items()]
        return TO.Optimizer(named, cfg, 6, decay_mask=TO.no_decay_mask)

    grads = [[torch.from_numpy(rng.standard_normal(np.shape(v)).astype(np.float32))
              for v in values.values()] for _ in range(4)]
    a = make()
    for g in grads[:3]:
        a.step(g)
    state = a.state_dict()
    assert (state["count"], state["mini_step"]) == (1, 1) and len(state["mean"]) == 4
    assert sorted(state["adamw"]["state"]) == [0, 1, 2, 3]
    assert [g["params"] for g in state["adamw"]["param_groups"]] == [[0, 1], [2, 3]]
    assert all(s["exp_avg"].shape == a.params[a.order[i]].shape
               for i, s in state["adamw"]["state"].items())
    b = make()
    for p, q in zip(b.params, a.params):
        p.data.copy_(q.data)
    b.load_state_dict(state)
    a.step(grads[3])
    b.step(grads[3])
    assert all(torch.equal(x, y) for x, y in zip(a.state_tensors(), b.state_tensors()))
    assert all(torch.equal(p, q) for p, q in zip(a.params, b.params))

    # the layout torch.optim.AdamW writes loads into the flat buffers
    legacy = torch.optim.AdamW([torch.nn.Parameter(p.detach().clone()) for p in a.params])
    legacy_state = {i: {"step": torch.tensor(2.0), "exp_avg": torch.full_like(p, i + 1.0),
                        "exp_avg_sq": torch.full_like(p, 0.5)}
                    for i, p in enumerate(a.params[i] for i in a.order)}
    c = make()
    c.load_state_dict({"adamw": {"state": legacy_state,
                                 "param_groups": legacy.state_dict()["param_groups"]},
                       "count": 2, "mini_step": 0, "mean": None})
    assert c.count == 2 and c.mini_step == 0 and not c._mean.any()
    for slot, m in enumerate(c._slots(c.exp_avg)):
        assert torch.equal(m, torch.full_like(m, slot + 1.0))


@pytest.mark.parametrize("total,pct", [(10, 0.1), (37, 0.1), (40, 0.3), (3, 0.5), (1, 0.1)])
def test_device_schedule_equals_the_host_schedule_and_optax(total, pct):
    host = TO.one_cycle_lr(1e-3, total, pct_start=pct)
    device = TO.one_cycle_lr_tensor(1e-3, total, pct_start=pct)
    ref = JO.one_cycle_lr(1e-3, total, pct_start=pct)
    for count in range(total + 3):
        got = device(torch.tensor(count))
        assert got.dtype == torch.float64 and float(got) == host(count), count
        assert float(got) == pytest.approx(float(ref(count)), rel=2e-6, abs=1e-12)


# -- the program's eager parts against the eager step --------------------------------------


def _torch_net(dropout, tree, remat=False):
    net = TNet("audiovisual", None, 96, (32, 4, 2, 3000, 128, dropout), VOCAB, device="cpu",
               whisper_config=TConfig(**TINY), remat=remat)
    return load_jax_params(net, tree)


def _tree(seed=0):
    probe = TNet("audiovisual", None, 96, (32, 4, 2, 3000, 128, 0.0), VOCAB, device="cpu",
                 whisper_config=TConfig(**TINY))
    tree = random_avnet_params(probe, seed)
    for layer in tree["fusion"]["layers"]:
        layer["attn_gate"] = layer["ff_gate"] = np.float32(0.5)
    return tree


@pytest.fixture(scope="module")
def tree():
    """One random weight tree for the module's nets (building it takes seconds)."""
    return _tree()


def _batches(n, b=2, tv=6, l_target=5, seed=11):
    """Batches as the loader hands them over: numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(2, l_target + 1, (b,)).astype(np.int32)
        ids = rng.integers(1, VOCAB, (b, l_target)).astype(np.int32)
        out.append({
            "audio": rng.standard_normal((b, 80, 128)).astype(np.float32),
            "audio_mask": np.ones((b, 128), bool),
            "audio_lengths": np.full((b,), 64, np.int32),
            "video": rng.standard_normal((b, tv, 3, 32, 32)).astype(np.float32),
            "video_mask": np.ones((b, tv), bool),
            "video_lengths": np.array([tv, tv - 2][:b], np.int32),
            "target_ids": np.where(np.arange(l_target)[None, :] < lens[:, None], ids, 0),
            "target_lengths": lens})
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dropout,remat,accum", [(0.3, False, 1), (0.3, True, 2)])
def test_program_eager_parts_equal_the_eager_step_bit_for_bit(dropout, remat, accum, tree):
    """Three micro-batches (at ``accum`` 2 the second poisoned, between the
    halves of an update): ``TrainProgram.train_step`` on the CPU (the
    program's plain version) against ``AVSRTask.train_step`` on a twin net:
    losses, parameters, every optimizer state tensor and the generator, bit
    for bit."""
    cfg = dict(TRAINING, accumulate_grad_batches=accum)
    batches = _batches(3)
    if accum > 1:
        batches[1]["audio"] = np.full_like(batches[1]["audio"], np.nan)
    runs = []
    for use_program in (True, False):
        net = _torch_net(dropout, tree, remat)
        task = TTask(net)
        opt, _ = TO.make_optimizer(cfg, 6, net.trainable_parameters())
        gen = torch.Generator().manual_seed(7)
        program = TrainProgram(task, opt, gen, {"dropout": dropout})
        history = []
        for batch in batches:
            if use_program:
                losses = program.train_step(_t(batch))
            else:
                losses = task.train_step(opt, _t(batch), gen)
            history.append(losses)
        runs.append((history, [p.detach() for p in net.parameters()], opt, gen.get_state()))
    (h_prog, p_prog, o_prog, g_prog), (h_eager, p_eager, o_eager, g_eager) = runs
    for a, b in zip(h_prog, h_eager):
        assert sorted(a) == sorted(b) == ["ce_loss", "ctc_loss", "loss", "skipped"]
        assert all(torch.equal(a[k], b[k]) or (a[k].isnan() and b[k].isnan()) for k in a)
    assert [float(h["skipped"]) for h in h_prog] == [0.0, float(accum > 1), 0.0]
    assert all(torch.equal(a, b) for a, b in zip(p_prog, p_eager))
    assert all(torch.equal(a, b) for a, b in zip(o_prog.state_tensors(), o_eager.state_tensors()))
    assert o_prog.count == (3 if accum == 1 else 1) and o_prog.mini_step == 0
    assert torch.equal(g_prog, g_eager)
    assert not torch.equal(g_prog, torch.Generator().manual_seed(7).get_state())


def test_compute_losses_take_the_ctc_wrapper_with_the_batch_s_own_lengths(monkeypatch):
    """``compute_losses`` hands the CTC wrapper the batch's lengths as they
    lie (the audio lengths clamped to the frames), the labels and the
    log-softmaxed logits, and its losses are the wrapper's NLL reduced as
    the JAX task reduces it; ``F.ctc_loss`` (the library yardstick) agrees
    with the recursion."""
    rng = np.random.default_rng(3)
    batch = _batches(1, b=3)[0]
    batch["target_lengths"][2] = 0
    logits = torch.from_numpy(rng.standard_normal((3, 40, VOCAB)).astype(np.float32))
    calls = []
    wrapped = TL.ctc_nll

    def recording(log_probs, labels, input_lengths, label_lengths, blank_id=0):
        calls.append((labels, input_lengths, label_lengths))
        return wrapped(log_probs, labels, input_lengths, label_lengths, blank_id)

    monkeypatch.setattr(TL, "ctc_nll", recording)
    got = TTask(None).compute_losses(logits, _t(batch))
    (labels, in_len, lab_len), = calls
    assert torch.equal(labels, torch.from_numpy(batch["target_ids"]))
    assert torch.equal(in_len, torch.full((3,), 40, dtype=torch.int32))
    assert torch.equal(lab_len, torch.from_numpy(batch["target_lengths"]))
    lp = torch.log_softmax(logits, dim=-1)
    nll = TL.ctc_forward_log_probs(lp, labels, in_len, lab_len)
    assert torch.equal(got["ctc_loss"], (nll / torch.clamp(lab_len, min=1)).sum() / 3)
    native = TL.ctc_native_nll(lp, labels, in_len, lab_len, zero_infinity=True)
    torch.testing.assert_close(native, nll, atol=1e-3, rtol=1e-5)


# -- the key and the trainer's choice ---------------------------------------------------------


def test_program_key_follows_settings_shapes_and_parameter_addresses(tree):
    net = _torch_net(0.0, tree)
    opt, _ = TO.make_optimizer(dict(TRAINING), 6, net.trainable_parameters())
    task = TTask(net)
    program = TrainProgram(task, opt, None, {"dropout": 0.0, "rematerialize": False})
    one, other, wider = (_t(b) for b in (_batches(1)[0], _batches(1, seed=5)[0],
                                         _batches(1, b=3)[0]))
    key = program.key(one)
    assert program.key(other) == key  # new values, same shapes
    assert program.key(wider) != key
    assert program.key(dict(one, audio=one["audio"].double())) != key
    assert TrainProgram(task, opt, None, {"dropout": 0.0, "rematerialize": True}).key(one) != key
    param = net.fusion.layers[0].ff1.kernel
    param.data = param.data.clone()
    assert program.key(one)[:-1] == key[:-1] and program.key(one)[-1] != key[-1]
    key = program.key(one)
    opt.load_state_dict(opt.state_dict())  # in place: the addresses stay
    assert program.key(one) == key


def test_one_process_trainer_runs_the_program(tmp_path, tree):
    config = t_get_config({"output.checkpoint_dir": str(tmp_path / "ckpt"),
                           "output.log_dir": str(tmp_path / "logs"),
                           "precision.compute_dtype": "float32", "model.dropout": 0.0})
    trainer = Trainer(config, _torch_net(0.0, tree), ByteTokenizer(), device="cpu")
    assert trainer.step_kind == "program"
    trainer.setup(4)
    assert isinstance(trainer.program, TrainProgram)
    assert dict(trainer.program.settings)["loss_mode"] == "ctc_ce"
    batch = _batches(1)[0]
    placed = trainer._ready(trainer._put_batch(batch))
    assert sorted(placed) == sorted([*batch, "target_text"])
    assert np.array_equal(placed["target_lengths"].numpy(), batch["target_lengths"])
    losses = trainer.program.train_step({k: v for k, v in placed.items() if k != "target_text"})
    assert sorted(losses) == ["ce_loss", "ctc_loss", "loss", "skipped"]
    assert (trainer.optimizer.count, trainer.optimizer.mini_step) != (0, 0)  # a step was taken


@pytest.mark.parametrize("device,backends,kind", [
    ("cpu", [], "program"),  # one process: the program object, eager on the CPU
    ("cuda", [], "program"),
    ("cuda", ["nccl"], "program"),
    ("cuda", ["nccl", "nccl"], "program"),  # a (data, model) mesh of NCCL groups
    ("cuda", ["cpu:gloo,cuda:nccl", "cpu:gloo,cuda:nccl"], "program"),
    ("cuda", ["gloo", "gloo"], "eager"),  # two ranks sharing one card: gloo cannot be captured
    ("cuda", ["nccl", "gloo"], "eager"),
    ("cuda", ["cpu:gloo,cuda:gloo"], "eager"),
    ("cpu", ["gloo"], "eager"),
    ("cpu", ["cpu:gloo,cuda:nccl"], "eager"),
])
def test_step_kind_follows_the_device_and_the_groups_backends(device, backends, kind):
    assert step_kind(torch.device(device), backends) == kind


def test_trainer_decides_its_step_from_the_mesh_groups(monkeypatch, tmp_path, tree):
    """``Trainer`` reads its mesh's groups' backends when it is made: a
    gloo group on the CPU steps eagerly (no program), as a gloo mesh on the
    card does, and no group runs the program."""
    from mocov2_whisper_flamingo_torch.parallel import mesh as mesh_mod
    from mocov2_whisper_flamingo_torch.training import trainer as trainer_mod

    group = object()
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda g: "gloo" if g is group else None)
    assert mesh_mod.Mesh({"data": 1, "model": 1}).backends() == []
    assert mesh_mod.Mesh({"data": 2, "model": 2}, data_group=group,
                         model_group=group).backends() == ["gloo", "gloo"]

    def one_group_mesh(data, model):
        return mesh_mod.Mesh({"data": 1, "model": 1}, data_group=group)

    monkeypatch.setattr(trainer_mod, "make_mesh", one_group_mesh)
    config = t_get_config({"output.checkpoint_dir": str(tmp_path / "ckpt"),
                           "output.log_dir": str(tmp_path / "logs"),
                           "precision.compute_dtype": "float32", "model.dropout": 0.0})
    trainer = Trainer(config, _torch_net(0.0, tree), ByteTokenizer(), device="cpu")
    assert trainer.step_kind == "eager"
    trainer.setup(4)
    assert trainer.program is None


@pytest.mark.parametrize("remat", [False, True])
def test_capture_sequence_a_step_undone_then_taken_again(remat, tree):
    """What a capture does before it records, on the CPU: the step's eager
    run, its update undone (``restore=``: the parameters through ``.data``
    and every state tensor) and the generator put back, then the step again.
    The optimizer writes the parameters without bumping their version
    counters, and the second step leaves what one step leaves."""
    batch = _batches(1)[0]
    states = []
    for twice in (True, False):
        net = _torch_net(0.3, tree, remat)
        opt, _ = TO.make_optimizer(dict(TRAINING), 6, net.trainable_parameters())
        gen = torch.Generator().manual_seed(1)
        program = TrainProgram(TTask(net), opt, gen, {})
        if twice:
            restore = (*(p.data for p in opt.params), *opt.state_tensors())
            saved, start = [t.clone() for t in restore], gen.get_state()
            versions = [p._version for p in opt.params]
            program._step(_t(batch))
            assert [p._version for p in opt.params] == versions
            for t, s in zip(restore, saved):
                t.copy_(s)
            gen.set_state(start)
        losses = program._step(_t(batch))
        states.append([losses["loss"], *(p.detach().clone() for p in net.parameters()),
                       *opt.state_tensors(), gen.get_state()])
    assert all(torch.equal(a, b) for a, b in zip(*states))
