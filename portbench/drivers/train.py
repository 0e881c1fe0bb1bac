"""Training cells: ``Trainer.setup`` and then the train program's step
(``TrainProgram.train_step``, the call ``Trainer.fit`` makes each step) over
a pool of distinct batches made on the card from the seed.

Set-up builds the trunk at the configuration's sizes (bfloat16 compute, the
weights from the seed), the trainer (its log and checkpoint directories
under ``TMPDIR``; nothing is saved) and the pool; it then drives the
program through the first steps (the first captures the step's graph),
keeping the first update's gradient and the parameters after the last of
them for the check. The window runs further steps, at most two in flight,
and ends in a ``synchronize``: ``clips`` counts every clip of every step
run in it. A traced run profiles ``trace_steps`` steps inside the window.
"""

from __future__ import annotations

import gc
import shutil
import time

import torch

from portbench import inputs, weights
from portbench.reference import compare
from portbench.reference import model as M
from portbench.reference import spec
from portbench.reference import train as R
from portbench.trace import Stretch

PREFIX = "trunk."
BETA1 = 0.9  # AdamW's first-moment decay in the reference recipe


def _training(cfg: dict, p: dict) -> dict:
    t = cfg["training"]
    return {"max_lr": t["max_lr"], "warmup_ratio": t["warmup_ratio"],
            "weight_decay": t["weight_decay"], "gradient_clip_val": t["gradient_clip_val"],
            "label_smoothing": t["label_smoothing"], "total_steps": p["total_steps"]}


def make_batches(ctx, device, for_program: bool = True) -> list[dict]:
    """The pool of batches: as the program takes them (frames through the
    program's video pipeline), or with ``for_program`` False as the
    reference takes them (``raw_video``, the uint8 frames)."""
    cfg, p = ctx.config, ctx.params
    if for_program:
        from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline
    b, n = p["batch"], p["pool"]
    gen = inputs.generator(ctx.seed, device)
    lengths = inputs.target_lengths(b * n, p["target_len_min"], p["target_len_max"], gen)
    out = []
    for i in range(n):
        mel, raw = inputs.clips(gen, b, cfg["mel_frames"], cfg["whisper"]["n_mels"],
                                p["frames"], p["raw_size"], device)
        lens = lengths[i * b:(i + 1) * b]
        common = {
            "audio": mel,
            "audio_mask": torch.ones((b, cfg["mel_frames"]), dtype=torch.bool, device=device),
            "audio_lengths": torch.full((b,), p["audio_lengths"], dtype=torch.int32,
                                        device=device),
            "video_mask": torch.ones((b, p["frames"]), dtype=torch.bool, device=device),
            "video_lengths": torch.full((b,), p["frames"], dtype=torch.int32, device=device),
            "target_ids": inputs.targets(gen, lens, p["target_pad"], cfg["vocab_size"], device),
            "target_lengths": lens.to(device=device, dtype=torch.int32),
        }
        out.append(dict(common, video=eval_video_pipeline(raw, resize=p["resize"]))
                   if for_program else dict(common, raw_video=raw))
    return out


def build(ctx):
    """The trainer, set up, with its net filled from the seed."""
    from mocov2_whisper_flamingo_torch.config import get_config
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_net import AVNet
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig
    from mocov2_whisper_flamingo_torch.training.trainer import Trainer

    cfg, p = ctx.config, ctx.params
    m = cfg["model"]
    net = AVNet("audiovisual", None, 96,
                (m["d_model"], m["n_heads"], m["n_layers"], m["pe_max_len"],
                 m["fc_hidden_size"], m["dropout"]),
                cfg["vocab_size"], precision=L.BF16, device=ctx.device,
                whisper_config=WhisperConfig(**cfg["whisper"]))
    weights.fill_module(net, spec.trunk_parameters(cfg), ctx.seed, prefix=PREFIX)
    t = cfg["training"]
    config = get_config({
        "model.dropout": m["dropout"], "precision.rematerialize": False,
        "training.accumulate_grad_batches": p["accumulate"], "training.seed": ctx.seed % (1 << 31),
        "training.max_lr": t["max_lr"], "training.warmup_ratio": t["warmup_ratio"],
        "training.weight_decay": t["weight_decay"],
        "training.gradient_clip_val": t["gradient_clip_val"],
        "training.label_smoothing": t["label_smoothing"],
        "output.checkpoint_dir": str(ctx.tmp / "checkpoints"),
        "output.log_dir": str(ctx.tmp / "logs")})
    trainer = Trainer(config, net, None, device=ctx.device)
    trainer.setup(p["total_steps"])
    return trainer


def _trainable(net) -> dict:
    return {PREFIX + n: p for n, p in net.trainable_parameters()}


def _first_grad(trainer) -> dict:
    """The first update's gradient as the optimizer took it (after the
    clip), from AdamW's first moment after one step: ``m = (1 - b1) g``
    (zero where no update was applied)."""
    opt = trainer.optimizer
    state = opt.state_dict()["adamw"]["state"]
    names = {id(p): n for n, p in _trainable(trainer.net).items()}
    out = {}
    for slot, i in enumerate(opt.order):
        param = opt.params[i]
        m = state[slot]["exp_avg"] if slot in state else torch.zeros_like(param)
        out[names[id(param)]] = m.float() / (1 - BETA1)
    return out


def run(ctx) -> dict:
    p = ctx.params
    dev = ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shutil.rmtree(ctx.tmp, ignore_errors=True)
    trainer = build(ctx)
    program = trainer.program
    batches = make_batches(ctx, dev)
    start = {n: t.detach().clone() for n, t in _trainable(trainer.net).items()}
    losses, first_grad = [], None
    for i in range(p["first_steps"]):
        out = program.train_step(batches[i])
        losses.append(float(out["loss"]))
        if float(out["skipped"]):
            raise RuntimeError(f"the program skipped step {i + 1} (non-finite loss)")
        if i == 0:
            first_grad = _first_grad(trainer)
    change = {n: t.detach() - start[n] for n, t in _trainable(trainer.net).items()}
    del start

    step_i = p["first_steps"]
    in_flight: list = []

    def step():
        nonlocal step_i
        program.train_step(batches[step_i % len(batches)])
        step_i += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            in_flight.append(ev)
            if len(in_flight) > 2:
                in_flight.pop(0).synchronize()

    stretch = None
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.started
    steps = 0
    while True:
        if ctx.trace and stretch is None and steps >= p["trace_after"]:
            stretch = Stretch(ctx.tmp)
            stretch.start()
            for _ in range(p["trace_steps"]):
                step()
            stretch.stop()
            steps += p["trace_steps"]
        step()
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    clips = steps * p["batch"]
    traced = None
    if stretch is not None:
        traced = dict(stretch.read(), steps=p["trace_steps"])
    program_out = {"losses": losses, "first_grad": first_grad, "change": change}
    del trainer, program, batches, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(ctx.tmp, ignore_errors=True)
    return {"setup_s": setup_s, "window_s": window_s, "steps": steps, "clips": clips,
            "attempted": steps, "failed": 0, "peak_mem_bytes": peak, "trace": traced,
            "program": program_out, "kind": "train"}


def reference(ctx, precision: M.Precision = M.FP32, rows: slice | None = None) -> dict:
    """The plain reference's first steps on the same weights and batches."""
    cfg, p = ctx.config, ctx.params
    if ctx.device.type == "cuda":
        M.exact_float32()
    W = weights.as_dict(spec.trunk_parameters(cfg), ctx.seed, ctx.device)
    batches = make_batches(ctx, ctx.device, for_program=False)[:p["first_steps"]]
    out = R.run_steps(precision, W, cfg, batches, _training(cfg, p), p["resize"], rows=rows)
    out["losses"] = [s["loss"] for s in out["losses"]]
    return out


def check(ctx, record) -> dict:
    ref = reference(ctx)
    numbers = compare.train_numbers(record["program"], ref)
    record.pop("program")
    return numbers
