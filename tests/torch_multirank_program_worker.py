"""One rank of the multi-rank train program check, started by ``torchrun``.

    torchrun --standalone --nproc_per_node N tests/torch_multirank_program_worker.py \\
        --data D --model M --out DIR [--cpu]

Each rank takes the card of its ``LOCAL_RANK`` and joins an NCCL group, and
the ranks make a ``(D, M)`` mesh. At full width (whisper-small, MoCo
ResNet-50, the fusion with gates at 0.5; global batches of 4 rows, 400
frames and 64 target tokens with repeated labels), made from a seed:

- fp32: a trainer whose steps are the train program (its graphs capture the
  step's NCCL collectives) and an eager twin, loaded with the same weights,
  take the same 4 micro-batches (accumulation 2: 2 updates). Their losses at
  every step, and their parameters, optimizer state and generators after,
  must be equal bit for bit; then a micro-batch with a NaN in the last
  data index's rows, which every rank must skip, both steps alike, with
  nothing changed; and one eval step of the eval program and the eager
  eval step. Twice: at dropout 0 without rematerialisation, and at the
  package's defaults, dropout 0.1 with the fusion rematerialised (the ranks
  of a model group draw the same masks in every replay, and the recompute
  replays the forward's draws).
- One replayed step under ``torch.cuda.set_sync_debug_mode("warn")``: no
  synchronising call is allowed. The collectives the step makes (Python
  calls during its capture) and the NCCL kernels the profiler sees in one
  replay are reported, and so are K1's launch shapes in a capture and its
  launches per replay.
- bf16 (accumulation 1, dropout 0): ms per step of the program and of the
  eager twin, in turns (program, eager, eager, program, ...), each step
  synchronised; their losses at every step, and their state after, must be
  equal bit for bit.

Every rank writes ``DIR/rank{R}.json``; a failed check exits non-zero.
``--cpu``: gloo on the CPU at a tiny width, where both trainers step
eagerly (gloo cannot be captured): the script's own plumbing only.
"""

import argparse
import collections
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from mocov2_whisper_flamingo_torch import train as train_entry
from mocov2_whisper_flamingo_torch.config import get_config
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.av_net import AVNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig
from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline
from mocov2_whisper_flamingo_torch.parallel import initialize_distributed, shard_batch
from mocov2_whisper_flamingo_torch.training.trainer import Trainer
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer

SEED = 0
B, FRAMES, TARGET_TOKENS, AUDIO_FRAMES = 4, 400, 64, 400  # the training path's shapes
MODELARGS, VOCAB, GATE = (512, 8, 6, 3000, 2048, 0.0), 51865, 0.5
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            max_source_positions=64, max_target_positions=32)
TINY_MODELARGS, TINY_VOCAB = (32, 4, 2, 3000, 128, 0.0), 48
FP32_MICRO_BATCHES, BF16_WARMUP, BF16_TURNS = 4, 2, 6


class _Quiet:
    """The trainer's scalar writer: keeps nothing."""

    path = None

    def add_scalar(self, tag, value, step):
        pass

    def flush(self):
        pass


def repeated_labels(ids: np.ndarray) -> np.ndarray:
    """Every fourth label next to itself and again two places on."""
    ids = ids.copy()
    ids[:, 1::4] = ids[:, 0::4][:, :ids[:, 1::4].shape[1]]
    ids[:, 3::4] = ids[:, 0::4][:, :ids[:, 3::4].shape[1]]
    return ids


def global_batches(rng, n: int, cpu: bool) -> list[dict]:
    """``n`` global batches on the CPU, alike on every rank."""
    out = []
    for _ in range(n):
        if cpu:  # tests/test_torch_training.py's tiny shapes
            audio = torch.from_numpy(rng.standard_normal((B, 80, 128)).astype(np.float32))
            video = torch.from_numpy(rng.standard_normal((B, 6, 3, 32, 32)).astype(np.float32))
            t_audio, frames, targets, audio_len = 128, 6, 5, 64
        else:
            audio = torch.from_numpy(rng.standard_normal((B, 3000, 80)).astype(np.float32))
            raw = torch.from_numpy(rng.integers(0, 255, (B, FRAMES, 3, 88, 88), dtype=np.uint8))
            video = eval_video_pipeline(raw, resize=64)
            t_audio, frames, targets, audio_len = 3000, FRAMES, TARGET_TOKENS, AUDIO_FRAMES
        vocab = TINY_VOCAB if cpu else VOCAB
        ids = repeated_labels(rng.integers(1, vocab, (B, targets)))
        out.append({
            "audio": audio, "audio_mask": torch.ones((B, t_audio), dtype=torch.bool),
            "audio_lengths": torch.full((B,), audio_len, dtype=torch.int32),
            "video": video, "video_mask": torch.ones((B, frames), dtype=torch.bool),
            "video_lengths": torch.full((B,), frames, dtype=torch.int32),
            "target_ids": torch.from_numpy(ids),
            "target_lengths": torch.full((B,), targets, dtype=torch.int32)})
    return out


def make_net(cpu: bool, fp32: bool, tree: dict | None, dropout: float, remat: bool):
    """The net at its full (or, ``cpu``, tiny) width with the weights of
    ``tree`` (drawn from the seed when None); returns (net, tree)."""
    precision = L.FP32 if fp32 else L.BF16
    if cpu:
        net = AVNet("audiovisual", None, 96, TINY_MODELARGS[:5] + (dropout,), TINY_VOCAB,
                    device="cpu", precision=precision, remat=remat,
                    whisper_config=WhisperConfig(vocab_size=TINY_VOCAB, **TINY))
    else:
        net = AVNet("audiovisual", None, 96, MODELARGS[:5] + (dropout,), VOCAB,
                    whisper_name="whisper-small", precision=precision, device="cuda",
                    remat=remat)
    if tree is None:
        tree = random_avnet_params(net, SEED)
        for layer in tree["fusion"]["layers"]:
            layer["attn_gate"] = layer["ff_gate"] = np.float32(GATE)
    return load_jax_params(net, tree), tree


def make_trainer(args, fp32: bool, tree: dict | None, eager: bool, workdir: str,
                 dropout: float = 0.0, remat: bool = False):
    """A trainer on the run's mesh, set up for its steps; ``eager``: the
    eager twin (``step_kind`` set before ``setup``)."""
    config = get_config({
        "training.epochs": 1, "training.accumulate_grad_batches": 2 if fp32 else 1,
        "training.seed": SEED, "model.dropout": dropout,
        "precision.compute_dtype": "float32" if fp32 else "bfloat16",
        "precision.rematerialize": remat, "output.save_predictions": False,
        "mesh.data": args.data, "mesh.model": args.model,
        "output.checkpoint_dir": os.path.join(workdir, "checkpoints"),
        "output.log_dir": os.path.join(workdir, "logs")})
    net, tree = make_net(args.cpu, fp32, tree, dropout, remat)
    trainer = Trainer(config, net, ByteTokenizer(), device="cpu" if args.cpu else "cuda")
    trainer.writer = _Quiet()
    if eager:
        trainer.step_kind = "eager"
    trainer.setup(FP32_MICRO_BATCHES)
    return trainer, tree


def step_fn(trainer):
    """The trainer's train step: its program's, or the eager task's."""
    if trainer.program is not None:
        return trainer.program.train_step
    return lambda batch: trainer.task.train_step(trainer.optimizer, batch, trainer.generator)


def eval_fn(trainer):
    return trainer.program.eval_step if trainer.program is not None else trainer.task.eval_step


def placed(trainer, batch: dict) -> dict:
    """This rank's rows of a global batch, on the trainer's device."""
    out = trainer._ready(trainer._put_batch(shard_batch(trainer.mesh, batch)))
    out.pop("target_text", None)
    return out


def same_state(a, b) -> dict:
    """Parameters, optimizer state and generators of two trainers."""
    pairs = list(zip(a.net.parameters(), b.net.parameters())) + list(
        zip(a.optimizer.state_tensors(), b.optimizer.state_tensors()))
    return {"equal": all(torch.equal(x, y) for x, y in pairs)
            and torch.equal(a.generator.get_state(), b.generator.get_state()),
            "max_abs_diff": max((x.double() - y.double()).abs().max().item() for x, y in pairs)}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def sync_calls(fn) -> list:
    """The synchronising calls ``fn()`` makes, each with its innermost frames."""
    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            found.append([f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()[:-1]][-4:])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return found


def nccl_kernels(fn) -> int:
    """The NCCL kernels ``torch.profiler`` records on the card over ``fn()``
    (the window padded with spin kernels: a trace may lose its first records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(1_000_000)
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and "nccl" in ev.name.lower())


def check_fp32(args, batches: list[dict], calls: collections.Counter, workdir: str,
               dropout: float = 0.0, remat: bool = False) -> dict:
    """The program and its eager twin over the fp32 micro-batches, then
    one eval step each, held bit for bit; then one replayed step's
    synchronising calls, collectives and NCCL kernels."""
    prog, tree = make_trainer(args, True, None, False, os.path.join(workdir, "fp32"),
                              dropout, remat)
    twin, _ = make_trainer(args, True, tree, True, os.path.join(workdir, "fp32_eager"),
                           dropout, remat)
    out = {"dropout": dropout, "rematerialize": remat, "step_kind": prog.step_kind,
           "twin_step_kind": twin.step_kind, "losses_equal": []}
    shapes = collections.Counter()
    launch = fa._launch

    def counted(q, k, v, *a, **kw):
        shapes[str([q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]])] += 1
        return launch(q, k, v, *a, **kw)

    for i, batch in enumerate(batches):
        fa._launch = counted if i == 0 else launch
        calls.clear()
        got = step_fn(prog)(placed(prog, batch))
        if i == 0:
            # the first step makes the capture's eager run, then the capture
            out["collectives_per_capture"] = {k: v / 2 for k, v in calls.items()}
            out["k1_shapes_per_capture"] = {k: v / 2 for k, v in shapes.items()}
        fa._launch = launch
        want = step_fn(twin)(placed(twin, batch))
        out["losses_equal"].append(all(torch.equal(got[k], want[k]) for k in want))
    out["state_after"] = same_state(prog, twin)
    out["count"] = [prog.optimizer.count, twin.optimizer.count]
    # a NaN in the last row (the last data index's): the global loss is NaN on every rank, so
    # every rank skips the micro-batch, the program inside its graph
    poisoned = dict(batches[0], audio=batches[0]["audio"].clone())
    poisoned["audio"][-1] = float("nan")
    got, want = (step_fn(t)(placed(t, poisoned)) for t in (prog, twin))
    out["nan_skipped"] = [float(got["skipped"]), float(want["skipped"])]
    out["nan_losses_equal"] = all(same_bits(got[k], want[k]) for k in want)
    out["nan_state_unchanged"] = same_state(prog, twin)["equal"] and [
        prog.optimizer.count, prog.optimizer.mini_step] == [2, 0]
    (got, got_preds), (want, want_preds) = (eval_fn(t)(placed(t, batches[0])) for t in (prog, twin))
    out["eval_equal"] = (all(torch.equal(got[k], want[k]) for k in want)
                         and torch.equal(got_preds, want_preds))
    if not args.cpu and prog.program is not None:
        batch = placed(prog, batches[0])
        prog.program.train_step(batch)
        out["syncs_per_replayed_step"] = sync_calls(lambda: prog.program.train_step(batch))
        calls.clear()
        before = fa.launches
        out["nccl_kernels_per_replay"] = nccl_kernels(lambda: prog.program.train_step(batch))
        out["collective_calls_per_replay"] = sum(calls.values())
        out["k1_launches_per_replay"] = fa.launches - before
    return out


def time_bf16(args, batches: list[dict], workdir: str) -> dict:
    """ms per step of the bf16 program and its eager twin, in turns; and
    whether their losses at every step, and their state after, are equal
    (compared outside the timed steps)."""
    prog, tree = make_trainer(args, False, None, False, os.path.join(workdir, "bf16"))
    twin, _ = make_trainer(args, False, tree, True, os.path.join(workdir, "bf16_eager"))
    legs = {"program": (step_fn(prog), placed(prog, batches[0])),
            "eager": (step_fn(twin), placed(twin, batches[0]))}
    losses_equal = []
    for _ in range(BF16_WARMUP):
        got, want = (step(batch) for step, batch in legs.values())
        losses_equal.append(all(torch.equal(got[k], want[k]) for k in want))
    ms = {name: [] for name in legs}
    sync = torch.cuda.synchronize if not args.cpu else (lambda: None)
    for i in range(BF16_TURNS):
        losses = {}
        for name in (("program", "eager") if i % 2 == 0 else ("eager", "program")):
            step, batch = legs[name]
            sync()
            t0 = time.perf_counter()
            losses[name] = step(batch)
            sync()
            ms[name].append((time.perf_counter() - t0) * 1e3)
        got, want = losses["program"], losses["eager"]
        losses_equal.append(all(torch.equal(got[k], want[k]) for k in want))
    out = {name: {"median": float(np.median(v)), "min": min(v), "each": v}
           for name, v in ms.items()}
    out.update(losses_equal=losses_equal, state_after=same_state(prog, twin))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=int, required=True)
    parser.add_argument("--model", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    if args.cpu:
        torch.set_num_threads(1)
        initialize_distributed(backend="gloo", timeout_s=120)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(torch.device(train_entry.rank_device("cuda")))
        initialize_distributed(backend="nccl", timeout_s=300)
    rank = dist.get_rank()
    calls = collections.Counter()

    def counted(fn):
        def wrapper(*a, **kw):
            calls[fn.__name__] += 1
            return fn(*a, **kw)
        return wrapper

    dist.all_reduce, dist.all_gather = counted(dist.all_reduce), counted(dist.all_gather)
    rng = np.random.default_rng(SEED + 18)
    batches = global_batches(rng, FP32_MICRO_BATCHES, args.cpu)
    out = {"rank": rank, "mesh": [args.data, args.model], "device": str(
        torch.cuda.current_device() if not args.cpu else "cpu")}
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        out["fp32"] = check_fp32(args, batches, calls, workdir)
        out["fp32_s"] = time.perf_counter() - t0
        if not args.cpu:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["fp32_dropout"] = check_fp32(args, batches, calls, workdir, dropout=0.1, remat=True)
        out["fp32_dropout_s"] = time.perf_counter() - t0
        if not args.cpu:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["bf16_ms_per_step"] = time_bf16(args, batches, workdir)
        out["bf16_s"] = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    bad = False
    for fp32 in (out["fp32"], out["fp32_dropout"]):
        bad = bad or (not all(fp32["losses_equal"]) or not fp32["state_after"]["equal"]
                      or not fp32["eval_equal"] or fp32["count"] != [2, 2]
                      or fp32["nan_skipped"] != [1.0, 1.0] or not fp32["nan_losses_equal"]
                      or not fp32["nan_state_unchanged"]
                      or fp32.get("syncs_per_replayed_step")
                      or (not args.cpu and fp32["step_kind"] != "program"))
    bf16 = out["bf16_ms_per_step"]
    bad = bad or not all(bf16["losses_equal"]) or not bf16["state_after"]["equal"]
    dist.destroy_process_group()
    if bad:
        print(json.dumps(out), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # at once: a rank left waiting on this one times out
    sys.exit(code)
