"""Training loop (counterpart of ``training/trainer.py``), one process per
card.

- bf16 compute with fp32 parameters (the net's precision policy);
- AdamW + OneCycle per-update schedule, clip 1.0, accumulation
  (``training/optim.py``);
- scalar streams with the reference's names: ``train/{ctc_loss,ce_loss,loss}``,
  ``val/{ctc_loss,ce_loss,loss,wer}``, ``test/wer``, ``lr``, and per-layer
  fusion gate values ``train_attn_gate_i`` / ``train_ff_gate_i``;
- checkpoints: top-k on the validation loss plus a ``last`` pointer, written
  with ``torch.save``; resume through ``fit(resume=...)``;
- early stopping on the validation loss with the reference's patience;
- a hyperparameter snapshot (``hparams.json`` / ``hparams.yaml``).

``config["mesh"]`` lays the processes of ``torch.distributed`` out as a
``("data", "model")`` mesh (``parallel/mesh.py``): the trainer splits the net
over the model group (Megatron tensor parallelism; the attention kernel runs
on each rank's heads), each data index trains on its own rows with the
global batch's loss, and gradients are summed over the data group
(``training/optim.py``). What the JAX trainer computes on the same global
batch, this computes: the same losses, updates, checkpoints and WER.

- Scalars, ``hparams.*``, predictions and checkpoints are written by global
  rank 0 alone.
- A checkpoint holds the whole ``state_dict`` (and optimizer state),
  gathered over the model group, so a tensor-parallel run's checkpoint
  loads on one card; restoring splits it again.
- ``validate`` / ``test`` report one loss and one corpus WER over the rows of
  every data index.
- The train-mode draws come from a generator seeded by the data index: the
  ranks of one model group draw the same dropout masks on their (whole)
  activations, or they would drift apart.

**The step it runs.** The train and eval steps are the compiled programs
of ``training/programs.py::TrainProgram`` (``program``): on the card one
graph per batch shape that replays the whole step (forward, losses with the
CTC kernel, backward, guard and update, the optimizer's state on the card,
and on a mesh every collective of the step) and reads nothing back; on the
CPU the eager step. That holds on one process and on a mesh of any
``(data, model)`` shape whose groups are NCCL on the card: the graphs
capture the NCCL collectives, as the JAX step is one program on any mesh. A
mesh whose groups are gloo (on the CPU, or two ranks sharing one card) runs
the eager ``AVSRTask.train_step`` / ``eval_step``, since gloo's collectives
cannot be captured. ``step_kind`` names the step (``"program"`` or
``"eager"``); it is decided from the groups' backends when the trainer is
made (``training/programs.py::step_kind``), and ``setup`` logs it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.device import resolve_device
from mocov2_whisper_flamingo_torch.parallel.mesh import (
    gather_state_dict, load_whole_state_dict, make_mesh, shard_module, sharded_dims)
from mocov2_whisper_flamingo_torch.training.optim import make_optimizer, no_decay_mask
from mocov2_whisper_flamingo_torch.training.programs import TrainProgram, step_kind
from mocov2_whisper_flamingo_torch.training.task import AVSRTask
from mocov2_whisper_flamingo_torch.utils.tb_writer import SummaryWriter
from mocov2_whisper_flamingo_torch.utils.wer import wer as corpus_wer

logger = logging.getLogger(__name__)


class _PlacedBatch(dict):
    """A batch placed by ``Trainer._put_batch``; ``ready``: the event after
    its host-to-device copies (None off the card)."""

    ready: torch.cuda.Event | None = None


class _NullWriter:
    """The scalar writer of a rank other than 0: writes nothing."""

    path = None

    def add_scalar(self, tag, value, step):
        pass

    def flush(self):
        pass


class EarlyStopping:
    """min-mode monitor with patience."""

    def __init__(self, patience: int = 10, mode: str = "min"):
        self.patience = patience
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = float("inf")
        self.count = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop: at the patience-th
        consecutive validation that did not improve."""
        if self.sign * value < self.best:
            self.best = self.sign * value
            self.count = 0
            return False
        self.count += 1
        return self.count >= self.patience


class CheckpointManager:
    """Top-k (on a monitored metric) + last checkpointing. A checkpoint is
    one ``step_N.pt`` file holding ``{"params", "opt_state", "step"}``."""

    def __init__(self, directory: str, save_top_k: int = 3, mode: str = "min"):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.save_top_k = save_top_k
        self.sign = 1.0 if mode == "min" else -1.0
        self.kept: list[tuple[float, str]] = []
        # An evicted checkpoint that was still the "last" pointer when it was
        # evicted: its deletion waits until "last" moves on.
        self._deferred_delete: str | None = None

    def _last(self) -> dict:
        with open(os.path.join(self.dir, "last.json")) as f:
            return json.load(f)

    def save(self, state: dict, step: int, metric: float | None = None) -> str:
        path = os.path.join(self.dir, f"step_{step}.pt")
        torch.save(state, path)
        with open(os.path.join(self.dir, "last.json"), "w") as f:
            json.dump({"path": path, "step": step}, f)
        if (self._deferred_delete and self._deferred_delete != path
                and not any(p == self._deferred_delete for _, p in self.kept)):
            if os.path.exists(self._deferred_delete):
                os.remove(self._deferred_delete)
            self._deferred_delete = None
        if metric is not None:
            self.kept.append((self.sign * metric, path))
            self.kept.sort(key=lambda kv: kv[0])
            while len(self.kept) > self.save_top_k:
                _, worst = self.kept.pop()
                if worst == self._last()["path"]:
                    self._deferred_delete = worst
                elif os.path.exists(worst):
                    os.remove(worst)
        return path

    def restore(self, path: str | None = None, map_location=None) -> dict:
        """The state saved at ``path`` (default: the last one)."""
        if path is None:
            path = self._last()["path"]
        return torch.load(path, map_location=map_location, weights_only=True)


class Trainer:
    """Compact trainer: ``fit(datamodule)`` then ``test(datamodule)``.

    The datamodule provides ``train_dataloader()/val_dataloader()/
    test_dataloader()`` yielding dict batches (numpy arrays or tensors) with
    the reference collate keys; under data parallelism, this data index's
    rows. ``net`` must already live on ``device``, which is the CUDA card
    unless the caller asks for the CPU; it holds the whole weights, and the
    trainer keeps this rank's shard of them (``parallel.mesh.shard_module``).
    A mesh that does not fit the processes of the run raises ``ValueError``.
    """

    def __init__(self, config, net, tokenizer, device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        if any(p.device.type != self.device.type for p in net.parameters()):
            raise ValueError(f"the net does not live on the trainer's device {self.device}")
        mesh_cfg = config.get("mesh", {})
        self.mesh = make_mesh(mesh_cfg.get("data", -1), mesh_cfg.get("model", 1))
        self.is_chief = self.mesh.rank == 0  # the mesh covers the world: its rank is global
        shard_module(net, self.mesh)
        self.config = config
        self.net = net
        self.tokenizer = tokenizer
        augment_fn = None
        if config.get("augmentation", {}).get("on_device"):
            from mocov2_whisper_flamingo_torch.ops.augment import make_batch_augment

            augment_fn = make_batch_augment(config, device=self.device)
            logger.info("on-device train augmentation enabled "
                        "(host loader emits raw mel / raw resized frames)")
        self.task = AVSRTask(
            net,
            label_smoothing=config["training"]["label_smoothing"],
            pad_to_ignore=bool(config["training"].get("pad_to_ignore", False)),
            loss_mode=config["training"].get("loss_mode", "ctc_ce"),
            augment_fn=augment_fn,
            data_group=self.mesh.data_group,
        )
        self.log_every = config["output"].get("log_every_n_steps", 100)
        self.log_gates = bool(config["output"].get("log_gates", True))

        out_cfg = config["output"]
        if self.is_chief:
            os.makedirs(out_cfg["log_dir"], exist_ok=True)
            run_dir = self._next_version_dir(os.path.join(out_cfg["log_dir"], "avsr_logs"))
            self.writer = SummaryWriter(run_dir)
            self._dump_hparams(run_dir)
        else:
            self.writer = _NullWriter()
        self.ckpt = CheckpointManager(
            out_cfg["checkpoint_dir"], out_cfg.get("save_top_k", 3),
            out_cfg.get("monitor_mode", "min"))
        self.early_stopping = EarlyStopping(
            patience=config["training"].get("early_stopping_patience", 10),
            mode=out_cfg.get("monitor_mode", "min"))

        self.optimizer = None
        self.schedule = None
        self.generator = None
        self.program = None  # the TrainProgram (setup) where step_kind is "program"
        self.step_kind = step_kind(self.device, self.mesh.backends())
        self.global_step = 0
        # Optional per-step wall-clock trace (set to [] before fit to
        # enable): one timestamp after each step, taken on the host. A step
        # reads nothing back, so the gaps are whole steps only where the
        # caller synchronises (the scalars logged every step do).
        self.step_timestamps: list[float] | None = None
        # Optional (set to [] before fit): seconds each train step waited on
        # the loader for its batch.
        self.data_wait_s: list[float] | None = None
        self._stream: torch.cuda.Stream | None = None
        self._stream_lock = threading.Lock()

    @staticmethod
    def _next_version_dir(base: str) -> str:
        os.makedirs(base, exist_ok=True)
        existing = [int(d.split("_")[1]) for d in os.listdir(base)
                    if d.startswith("version_") and d.split("_")[1].isdigit()]
        version = max(existing, default=-1) + 1
        path = os.path.join(base, f"version_{version}")
        os.makedirs(path, exist_ok=True)
        return path

    def _dump_hparams(self, run_dir: str) -> None:
        flat = {}
        for section, params in self.config.items():
            if isinstance(params, dict):
                for k, v in params.items():
                    if isinstance(v, (int, float, str, bool, type(None))):
                        flat[f"{section}_{k}"] = v
            elif isinstance(params, (int, float, str, bool)):
                flat[section] = params
        with open(os.path.join(run_dir, "hparams.json"), "w") as f:
            json.dump(flat, f, indent=2, default=str)
        # Lightning-style hparams.yaml twin: flat scalars only, so the
        # hand-rolled emitter needs no yaml dependency.
        with open(os.path.join(run_dir, "hparams.yaml"), "w") as f:
            for key in sorted(flat):
                value = flat[key]
                if value is None:
                    value = "null"
                elif isinstance(value, bool):
                    value = "true" if value else "false"
                elif isinstance(value, str):
                    value = json.dumps(value)
                f.write(f"{key}: {value}\n")

    # -- setup --------------------------------------------------------------------

    def setup(self, total_steps: int) -> None:
        """Build the optimizer over the trainable parameters and the
        generator of the train-mode draws."""
        training = self.config["training"]
        # int8 first, from the fp32 weights; checkpoints then hold the
        # quantized encoder, so keep both knobs constant across a run.
        quant = training.get("frozen_weight_quant")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown training.frozen_weight_quant {quant!r}; "
                             "expected None or 'int8'")
        if quant == "int8":
            self.net.quantize_frozen_params()
        if training.get("frozen_param_dtype") == "bf16":
            self.net.cast_frozen_params(torch.bfloat16)
        accum = int(training.get("accumulate_grad_batches", 1) or 1)
        self.optimizer, self.schedule = make_optimizer(
            training, max(total_steps // accum, 1), self.net.trainable_parameters(),
            decay_mask=no_decay_mask if training.get("no_decay_groups") else None,
            mesh=self.mesh, split_dims=sharded_dims(self.net))
        self.generator = torch.Generator(device=self.device)
        # One stream of draws per data index (the same on every rank of a
        # model group); data index 0 draws what one process draws.
        self.generator.manual_seed(int(training.get("seed", 0)) + (self.mesh.data_index << 32))
        if self.step_kind == "program":
            self.program = TrainProgram(self.task, self.optimizer, self.generator,
                                        self._program_settings())
        logger.info("train step: %s on %s, mesh %s", self.step_kind, self.device, self.mesh.shape)

    def _program_settings(self) -> dict:
        """The train settings that change the train program's kernels (part
        of its graphs' keys)."""
        training, cfg = self.config["training"], self.config
        return {"dropout": cfg.get("model", {}).get("dropout"),
                "rematerialize": bool(cfg.get("precision", {}).get("rematerialize")),
                "on_device_augment": self.task.augment_fn is not None,
                "accumulate_grad_batches": self.optimizer.accum,
                "frozen_weight_quant": training.get("frozen_weight_quant"),
                "frozen_param_dtype": training.get("frozen_param_dtype"),
                "loss_mode": self.task.loss_mode}

    def _put_batch(self, batch: dict) -> "_PlacedBatch":
        """Host batch -> tensors on the trainer's device (``target_text``
        stays a list). Safe to call from the loader's prefetch thread.

        On the card each host array is pinned and copied with
        ``non_blocking=True`` on the trainer's own copy stream, so batch N+1's
        copy overlaps step N; the batch carries an event recorded after its
        copies, which ``_ready`` makes the consuming stream wait on. The
        caching host allocator records each pinned block's copy, so a block
        is not handed out again while its copy is in flight."""
        placed = _PlacedBatch(target_text=batch.get("target_text", []))
        placed.update({k: None for k, v in batch.items() if v is None})
        arrays = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in batch.items() if k != "target_text" and v is not None}
        if self.device.type != "cuda":
            placed.update({k: v.to(self.device) for k, v in arrays.items()})
            return placed
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream()):
            for key, value in arrays.items():
                if value.device.type == "cpu":
                    value = value.pin_memory()
                placed[key] = value.to(self.device, non_blocking=True)
            placed.ready = torch.cuda.Event()
            placed.ready.record()
        return placed

    def _copy_stream(self) -> torch.cuda.Stream:
        with self._stream_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            return self._stream

    def _ready(self, placed: "_PlacedBatch") -> dict:
        """Order the current stream after ``placed``'s copies, and mark its
        tensors as used there (their blocks were allocated on the copy
        stream). Returns the batch as a plain dict."""
        if placed.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(placed.ready)
            for value in placed.values():
                if isinstance(value, torch.Tensor):
                    value.record_stream(stream)
        return dict(placed)

    def _state(self) -> dict:
        """The whole resumable state, gathered over the model group (a
        collective of the group)."""
        return {"params": gather_state_dict(self.net, self.mesh),
                "opt_state": self.optimizer.whole_state_dict(), "step": self.global_step}

    def _save_checkpoint(self, metric: float) -> None:
        """Rank 0 writes the whole state; the other ranks of its model group
        take part in gathering it."""
        if self.mesh.data_index == 0:
            state = self._state()
            if self.is_chief:
                self.ckpt.save(state, self.global_step, metric=metric)

    # -- loops ---------------------------------------------------------------------

    def fit(self, datamodule, max_epochs: int | None = None, max_steps: int | None = None,
            resume: str | None = None):
        """Train ``self.net`` in place and return it. ``resume``: a
        checkpoint path, or ``"last"``."""
        train_loader = datamodule.train_dataloader()
        # Placement moves onto the loader's prefetch thread: batch N+1's
        # fetch, collate and host-to-device copy overlap step N.
        pre_placed = False
        if getattr(train_loader, "device_put", "absent") is None:
            train_loader.device_put = self._put_batch
            pre_placed = True
        epochs = max_epochs or self.config["training"]["epochs"]
        steps_per_epoch = getattr(train_loader, "__len__", lambda: 100)()
        total = max_steps or epochs * max(steps_per_epoch, 1)

        self.setup(total)
        if resume:
            restored = self.ckpt.restore(None if resume == "last" else resume,
                                         map_location=self.device)
            load_whole_state_dict(self.net, restored["params"], self.mesh)
            self.optimizer.load_whole_state_dict(restored["opt_state"], self.mesh.model_index,
                                                 self.mesh.shape["model"])
            self.global_step = int(restored["step"])
            logger.info("resumed at step %d", self.global_step)

        losses = None
        for epoch in range(epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            t_epoch = time.time()
            batches = iter(train_loader)
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                if self.data_wait_s is not None:
                    self.data_wait_s.append(time.perf_counter() - t_wait)
                placed = self._ready(batch if pre_placed else self._put_batch(batch))
                placed.pop("target_text", None)
                if self.program is not None:
                    losses = self.program.train_step(placed)
                else:
                    losses = self.task.train_step(self.optimizer, placed, self.generator)
                self.global_step += 1
                if self.step_timestamps is not None:
                    self.step_timestamps.append(time.perf_counter())
                if max_steps and self.global_step >= max_steps:
                    break
                if self.global_step % self.log_every == 0:
                    self._log_train(losses)
            if hasattr(batches, "close"):
                batches.close()  # stops a prefetch thread the loop left early
            logger.info("epoch %d done in %.1fs (step %d)",
                        epoch, time.time() - t_epoch, self.global_step)
            if losses is not None:
                self._log_train(losses)

            val_metrics = self.validate(datamodule)
            for name, value in val_metrics.items():
                self.writer.add_scalar(f"val/{name}", value, self.global_step)
            self.writer.flush()

            # Full resumable state: params + optimizer state + step.
            self._save_checkpoint(val_metrics["loss"])
            if self.early_stopping.update(val_metrics["loss"]):
                logger.info("early stopping at epoch %d", epoch)
                break
            if max_steps and self.global_step >= max_steps:
                break
        return self.net

    def _log_train(self, losses: dict) -> None:
        for name in ("ctc_loss", "ce_loss", "loss"):
            if name in losses:
                self.writer.add_scalar(f"train/{name}", float(losses[name]), self.global_step)
        if "skipped" in losses and float(losses["skipped"]):
            self.writer.add_scalar("train/skipped_steps", 1.0, self.global_step)
            logger.warning("step %d skipped (non-finite loss)", self.global_step)
        accum = int(self.config["training"].get("accumulate_grad_batches", 1) or 1)
        self.writer.add_scalar(
            "lr", float(self.schedule(self.global_step // accum)), self.global_step)
        if self.log_gates:
            for i, layer in enumerate(self.net.fusion.layers):
                self.writer.add_scalar(
                    f"train_attn_gate_{i}", float(torch.tanh(layer.attn_gate.detach())), self.global_step)
                self.writer.add_scalar(
                    f"train_ff_gate_{i}", float(torch.tanh(layer.ff_gate.detach())), self.global_step)
        self.writer.flush()

    def _evaluate(self, loader) -> tuple[dict, list[str], list[str]]:
        """Per-sample weighted loss totals, references and hypotheses of the
        global batches: each batch's loss is the global batch's
        (``AVSRTask.eval_step``) and weighs by its global row count; the
        texts of every data index are gathered in global-batch order."""
        losses_by_batch: list[dict] = []
        rows: list[tuple[int, list[str], list[str]]] = []
        step = self.program.eval_step if self.program is not None else self.task.eval_step
        for batch in loader:
            placed = self._ready(self._put_batch(batch))
            texts = placed.pop("target_text", [])
            losses, preds = step(placed)
            losses_by_batch.append({k: float(v) for k, v in losses.items()})
            rows.append((len(texts) or int(placed["target_ids"].shape[0]), list(texts),
                         self.task.decode_predictions(preds, self.tokenizer)))
        if self.mesh.data_group is not None:
            everyone = [None] * self.mesh.shape["data"]
            torch.distributed.all_gather_object(everyone, rows, group=self.mesh.data_group)
            rows = [(sum(r[i][0] for r in everyone), [t for r in everyone for t in r[i][1]],
                     [h for r in everyone for h in r[i][2]]) for i in range(len(rows))]
        totals: dict[str, float] = {}
        refs: list[str] = []
        hyps: list[str] = []
        n = 0
        for losses, (bs, texts, decoded) in zip(losses_by_batch, rows):
            # Per-sample weighting: batches vary in size, so a 1-row batch
            # must not carry the weight of a 16-row one.
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + v * bs
            hyps.extend(decoded)
            refs.extend(texts)
            n += bs
        return {k: v / max(n, 1) for k, v in totals.items()}, refs, hyps

    def validate(self, datamodule) -> dict:
        metrics, refs, hyps = self._evaluate(datamodule.val_dataloader())
        metrics["wer"] = corpus_wer(refs, hyps) if refs else 1.0
        return metrics

    def test(self, datamodule) -> dict:
        _, refs, hyps = self._evaluate(datamodule.test_dataloader())
        metrics = {"wer": corpus_wer(refs, hyps) if refs else 1.0}
        self.writer.add_scalar("test/wer", metrics["wer"], self.global_step)
        self.writer.flush()
        if self.is_chief and self.config["output"].get("save_predictions") and refs:
            # Pred:/Target: dump, one pair per sample.
            path = os.path.join(os.path.dirname(self.writer.path), "predictions.txt")
            with open(path, "w", encoding="utf-8") as f:
                for pred, ref in zip(hyps, refs):
                    f.write(f"Pred: {pred}\nTarget: {ref}\n")
            logger.info("wrote %d predictions to %s", len(refs), path)
        return metrics
