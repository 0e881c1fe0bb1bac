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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from mocov2_whisper_flamingo_torch.ops.losses import ctc_loss, label_smoothed_cross_entropy


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

    # -- losses -----------------------------------------------------------------

    def compute_losses(self, logits: torch.Tensor, batch: dict) -> dict:
        """logits ``[B, T', V]``; batch carries target_ids ``[B, L]``,
        target_lengths ``[B]``, audio_lengths ``[B]``."""
        targets = batch["target_ids"]
        target_lengths = batch["target_lengths"].reshape(-1)
        input_lengths = torch.clamp(batch["audio_lengths"].reshape(-1), max=logits.shape[1])

        ctc = ctc_loss(logits, targets, input_lengths, target_lengths, blank_id=self.ctc_blank)

        t_min = min(logits.shape[1], targets.shape[1])
        ce_targets = targets[:, :t_min]
        if self.pad_to_ignore:
            pos = torch.arange(t_min, device=targets.device)[None, :]
            ce_targets = torch.where(pos < target_lengths[:, None], ce_targets, -100)
        ce = label_smoothed_cross_entropy(logits[:, :t_min], ce_targets,
                                          label_smoothing=self.label_smoothing)
        return {"ctc_loss": ctc, "ce_loss": ce, "loss": ctc + ce}

    def feature_mse_losses(self, batch: dict, generator: torch.Generator | None = None,
                           train: bool = True) -> dict:
        features, audio_feat = self.net.forward_features(_inputs(batch), train=train,
                                                         generator=generator)
        features = features.float()
        audio_feat = audio_feat.detach().float()
        mse = (features - audio_feat).square().mean()
        fm, am = features.mean(dim=1), audio_feat.mean(dim=1)
        cos = (fm * am).sum(dim=-1) / torch.clamp(
            torch.linalg.vector_norm(fm, dim=-1) * torch.linalg.vector_norm(am, dim=-1),
            min=1e-8)
        return {"loss": mse, "cosine_sim": cos.mean()}

    def loss_fn(self, batch: dict, generator: torch.Generator | None = None,
                train: bool = True) -> tuple[torch.Tensor, dict]:
        if train and self.augment_fn is not None and generator is not None:
            batch = self.augment_fn(batch, generator)
        if self.loss_mode == "feature_mse":
            losses = self.feature_mse_losses(batch, generator, train)
            return losses["loss"], losses
        logits = self.net(_inputs(batch), train=train, generator=generator)
        losses = self.compute_losses(logits, batch)
        return losses["loss"], losses

    # -- steps -------------------------------------------------------------------

    def train_step(self, optimizer, batch: dict, generator: torch.Generator | None = None,
                   skip_nonfinite: bool = True) -> dict:
        """One micro-batch: forward in train mode, backward over the
        optimizer's parameters, and the optimizer's step. Returns the
        detached losses.

        ``skip_nonfinite``: a step whose loss is NaN or Inf applies nothing:
        no parameter, optimizer state, accumulation counter or accumulated
        gradient changes, and ``losses["skipped"]`` is 1. The decision reads
        one bool back from the device, so it costs one synchronisation per
        step, after the backward is enqueued and before the optimizer's
        kernels."""
        loss, losses = self.loss_fn(batch, generator, train=True)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, optimizer.params)]
        losses = {k: v.detach() for k, v in losses.items()}
        ok = True
        if skip_nonfinite:
            ok = bool(torch.isfinite(loss.detach()))
            losses["skipped"] = torch.tensor(0.0 if ok else 1.0, device=loss.device)
        if ok:
            with torch.no_grad():
                optimizer.step(grads)
        return losses

    @torch.no_grad()
    def eval_step(self, batch: dict) -> tuple[dict, torch.Tensor]:
        """``(losses, predictions [B, T'])`` in eval mode."""
        if self.loss_mode == "feature_mse":
            losses = self.feature_mse_losses(batch, train=False)
            # No decode in feature-pretraining mode; dummy predictions keep
            # the trainer's eval loop uniform.
            preds = torch.zeros((batch["target_ids"].shape[0], 1), dtype=torch.long,
                                device=batch["target_ids"].device)
            return losses, preds
        logits = self.net(_inputs(batch), train=False)
        return self.compute_losses(logits, batch), logits.argmax(dim=-1)

    # -- decode ---------------------------------------------------------------

    @staticmethod
    def decode_predictions(pred_ids, tokenizer) -> list[str]:
        """Greedy argmax ids -> text."""
        if isinstance(pred_ids, torch.Tensor):
            pred_ids = pred_ids.cpu().numpy()
        return tokenizer.batch_decode(np.asarray(pred_ids), skip_special_tokens=True)
