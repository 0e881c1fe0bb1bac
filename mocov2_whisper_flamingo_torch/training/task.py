"""The AVSR task (counterpart of ``training/task.py``): joint CTC +
label-smoothed CE loss, the train and eval steps, greedy decode.

- ``loss = ctc + ce``: CTC over the log-softmaxed logits with the
  downsampled audio lengths, CE over logits and targets trimmed to their
  common length;
- greedy per-frame argmax decode + tokenizer ``batch_decode`` with special
  tokens skipped.

The reference pads targets with 0 (not -100) while CE ignores only -100, and
CTC blank = 0 collides with a real token id. ``pad_to_ignore=True`` (default
False for parity) remaps the positions past each target's length to -100
before the CE.

A batch is a dict of tensors on the model's device with the reference
collate keys: ``audio``, ``audio_mask``, ``audio_lengths``, ``video``,
``video_mask``, ``video_lengths``, ``target_ids``, ``target_lengths``.

With a ``data_group`` (data parallelism) the batch is this rank's rows of
the global batch, and the losses are those of the global batch, as the JAX
step computes them on the sharded global array: each rank divides its CE
token sum by the global count of valid tokens and its CTC row sum (of
``nll / target_len``) by the global row count, so the rank losses, and their
gradients, sum to the global batch's over the data group. A mean of per-rank
means would differ wherever ranks hold different numbers of valid tokens.
The reported losses, and the non-finite guard's decision, are the global
ones, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.ops.losses import ctc_loss, label_smoothed_cross_entropy
from mocov2_whisper_flamingo_torch.parallel.tensor_parallel import all_reduce_sum
from mocov2_whisper_flamingo_torch.utils.profiling import span


def _inputs(batch: dict) -> tuple:
    return (batch["audio"], batch["audio_mask"], batch["video"], batch["video_mask"],
            batch["video_lengths"])


@dataclasses.dataclass
class AVSRTask:
    """``loss_mode``:

    - ``"ctc_ce"`` (default): joint CTC + label-smoothed CE.
    - ``"feature_mse"``: the feature-alignment objective, MSE between the
      model's fused feature output and the (detached) audio stream, both
      ``[B, T', D]``, with a cosine-similarity metric on time-pooled features.
    """

    net: Any
    label_smoothing: float = 0.1
    ctc_blank: int = 0
    pad_to_ignore: bool = False
    loss_mode: str = "ctc_ce"
    # Optional on-device augmentation ``(batch, generator) -> batch``, applied
    # in the train step only (``ops.augment.make_batch_augment``).
    augment_fn: Callable | None = None
    # The mesh's data group (None: the batch is the whole global batch).
    data_group: Any = None

    # -- losses -----------------------------------------------------------------

    def _global_counts(self, device, *counts) -> list[torch.Tensor]:
        """Counts (ints, or tensors on ``device``) summed over the data group,
        each at least 1. An int is filled on the device: copying it there
        would wait for the step's kernels."""
        total = all_reduce_sum(torch.stack([
            c.float() if torch.is_tensor(c) else torch.full((), float(c), device=device)
            for c in counts]), self.data_group)
        return list(torch.clamp(total, min=1))

    def global_losses(self, losses: dict) -> dict:
        """Detached per-rank shares -> the global batch's losses."""
        names = sorted(losses)
        total = all_reduce_sum(torch.stack([losses[k].detach().float() for k in names]),
                               self.data_group)
        return dict(zip(names, total))

    @property
    def loss_names(self) -> tuple:
        """The names of the losses that the steps return (``skipped`` aside)."""
        if self.loss_mode == "feature_mse":
            return ("cosine_sim", "loss")
        return ("ce_loss", "ctc_loss", "loss")

    def compute_losses(self, logits: torch.Tensor, batch: dict) -> dict:
        """logits ``[B, T', V]``; batch carries target_ids ``[B, L]``,
        target_lengths ``[B]``, audio_lengths ``[B]`` on the logits' device
        (the CTC reads them there: nothing is read back)."""
        targets = batch["target_ids"]
        target_lengths = batch["target_lengths"].reshape(-1)
        input_lengths = torch.clamp(batch["audio_lengths"].reshape(-1), max=logits.shape[1])

        t_min = min(logits.shape[1], targets.shape[1])
        ce_targets = targets[:, :t_min]
        if self.pad_to_ignore:
            pos = torch.arange(t_min, device=targets.device)[None, :]
            ce_targets = torch.where(pos < target_lengths[:, None], ce_targets, -100)
        nll = ctc_loss(logits, targets, input_lengths, target_lengths, blank_id=self.ctc_blank,
                       reduction="none")
        rows, tokens = self._global_counts(nll.device, nll.shape[0], (ce_targets != -100).sum())
        per_row = nll / torch.clamp(target_lengths.to(nll.device), min=1).to(nll.dtype)
        ctc = per_row.sum() / rows
        ce = label_smoothed_cross_entropy(logits[:, :t_min], ce_targets,
                                          label_smoothing=self.label_smoothing,
                                          reduction="sum") / tokens
        return {"ctc_loss": ctc, "ce_loss": ce, "loss": ctc + ce}

    def feature_losses(self, features: torch.Tensor, audio_feat: torch.Tensor) -> dict:
        """The feature-alignment losses of the fused features and the audio
        stream, both ``[B, T', D]``."""
        features = features.float()
        audio_feat = audio_feat.detach().float()
        sq = (features - audio_feat).square()
        fm, am = features.mean(dim=1), audio_feat.mean(dim=1)
        cos = (fm * am).sum(dim=-1) / torch.clamp(
            torch.linalg.vector_norm(fm, dim=-1) * torch.linalg.vector_norm(am, dim=-1),
            min=1e-8)
        elements, rows = self._global_counts(sq.device, sq.numel(), cos.shape[0])
        return {"loss": sq.sum() / elements, "cosine_sim": cos.sum() / rows}

    def forward_outputs(self, batch: dict, generator: torch.Generator | None = None,
                        train: bool = True) -> tuple:
        """The net's outputs that the losses read: ``(logits,)``, or
        ``(features, audio)`` in ``feature_mse`` mode."""
        if self.loss_mode == "feature_mse":
            return tuple(self.net.forward_features(_inputs(batch), train=train,
                                                   generator=generator))
        return (self.net(_inputs(batch), train=train, generator=generator),)

    def losses_of(self, outputs: tuple, batch: dict) -> dict:
        """The losses of ``forward_outputs``' outputs (rank-local shares),
        in the span ``losses``."""
        with span("losses", outputs[0].device):
            if self.loss_mode == "feature_mse":
                return self.feature_losses(*outputs)
            return self.compute_losses(outputs[0], batch)

    def loss_fn(self, batch: dict, generator: torch.Generator | None = None,
                train: bool = True) -> tuple[torch.Tensor, dict]:
        if train and self.augment_fn is not None and generator is not None:
            batch = self.augment_fn(batch, generator)
        losses = self.losses_of(self.forward_outputs(batch, generator, train), batch)
        return losses["loss"], losses

    # -- steps -------------------------------------------------------------------

    def train_step(self, optimizer, batch: dict, generator: torch.Generator | None = None,
                   skip_nonfinite: bool = True) -> dict:
        """One micro-batch, eagerly: forward in train mode, backward over the
        optimizer's parameters, and the optimizer's step. Returns the
        detached losses. This is the plain version of the train program
        (``training/programs.py::TrainProgram``), which ``Trainer.fit`` runs
        on one process and on a mesh of NCCL groups; a mesh of gloo groups
        runs this.

        ``skip_nonfinite``: a step whose loss is NaN or Inf applies nothing:
        no parameter, optimizer state, accumulation counter or accumulated
        gradient changes, and ``losses["skipped"]`` is 1. The decision is a
        device tensor that the optimizer applies with ``torch.where``, as the
        JAX step does, so nothing is read back.

        Spans (``utils/profiling.py::span``): ``train_step`` around it all,
        and inside it, after the forward's own, ``backward`` (the gradients
        and the zeros of unused ones) and ``optimizer`` (the global losses,
        the guard and ``Optimizer.step``)."""
        device = optimizer.params[0].device
        with span("train_step", device):
            loss, losses = self.loss_fn(batch, generator, train=True)
            with span("backward", device):
                grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, optimizer.params)]
            with span("optimizer", device):
                losses = self.global_losses(losses)
                ok = None
                if skip_nonfinite:
                    ok = torch.isfinite(losses["loss"])
                    losses["skipped"] = (~ok).float()
                with torch.no_grad():
                    optimizer.step(grads, ok)
        return losses

    @torch.no_grad()
    def eval_step(self, batch: dict) -> tuple[dict, torch.Tensor]:
        """``(losses, predictions [B, T'])`` in eval mode."""
        outputs = self.forward_outputs(batch, train=False)
        losses = self.global_losses(self.losses_of(outputs, batch))
        if self.loss_mode == "feature_mse":
            # No decode in feature-pretraining mode; dummy predictions keep
            # the trainer's eval loop uniform.
            preds = torch.zeros((batch["target_ids"].shape[0], 1), dtype=torch.long,
                                device=batch["target_ids"].device)
            return losses, preds
        return losses, outputs[0].argmax(dim=-1)

    # -- decode ---------------------------------------------------------------

    @staticmethod
    def decode_predictions(pred_ids, tokenizer) -> list[str]:
        """Greedy argmax ids -> text."""
        if isinstance(pred_ids, torch.Tensor):
            pred_ids = pred_ids.cpu().numpy()
        return tokenizer.batch_decode(np.asarray(pred_ids), skip_special_tokens=True)
