"""Plain PyTorch reference of the training step: the joint CTC and
label-smoothed cross-entropy loss, the backward of the trainable trunk, the
clip of the global gradient norm, and AdamW on the OneCycle schedule, each
written from its published definition:

- CTC (blank 0) over the log-softmax of the frame-wise logits, each clip's
  negative log-likelihood divided by its target length, then the mean over
  clips; ``torch.nn.functional.ctc_loss`` computes the likelihood;
- cross-entropy with label smoothing 0.1, ``(1 - e) * nll + e * mean_k(-logp_k)``,
  over the first ``min(frames, target length)`` frames against the padded
  targets (the pad id 0 counts, as the reference trainer has it), summed and
  divided by the number of those tokens;
- the global norm of all trainable gradients clipped to 1.0 (scaled by
  ``1 / norm`` where it is larger);
- ``torch.optim.AdamW`` (betas 0.9, 0.98; eps 1e-6; weight decay 0.01 on
  every trainable parameter) at the learning rate of
  ``torch.optim.lr_scheduler.OneCycleLR`` (linear anneal) for the update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import model as M
from portbench.reference.spec import is_trainable


def losses(P: M.Precision, W: dict, cfg: dict, frozen: tuple, batch: dict,
           label_smoothing: float = 0.1) -> dict:
    """``frozen``: (Whisper encoder output, frontend features) of the batch."""
    out = M.trunk(P, W, cfg, frozen[0], frozen[1], batch["video_lengths"].long())
    logits = M.ctc_logits(P, W, out["features"])
    logp = torch.log_softmax(logits, dim=-1)
    targets = batch["target_ids"].long()
    target_len = batch["target_lengths"].long()
    in_len = batch["audio_lengths"].long().clamp(max=logits.shape[1])
    nll = F.ctc_loss(logp.transpose(0, 1), targets, in_len, target_len, blank=0,
                     reduction="none", zero_infinity=True)
    ctc = (nll / target_len.clamp(min=1)).mean()
    t = min(logits.shape[1], targets.shape[1])
    lp = logp[:, :t]
    nll_ce = -lp.gather(-1, targets[:, :t, None])[..., 0]
    ce = ((1 - label_smoothing) * nll_ce + label_smoothing * (-lp.mean(dim=-1))).sum()
    ce = ce / nll_ce.numel()
    return {"ctc_loss": ctc, "ce_loss": ce, "loss": ctc + ce}


def frozen_features(P: M.Precision, W: dict, cfg: dict, batch: dict, raw_size: int) -> tuple:
    """The frozen encoders over a batch whose video is raw uint8 frames."""
    wout = M.whisper_encoder(P, W, cfg["whisper"], batch["audio"])
    video = M.video_pipeline(batch["raw_video"], raw_size)
    return wout, M.frontend(P, W, video, batch["video_lengths"].long())


def run_steps(P: M.Precision, W: dict, cfg: dict, batches: list, training: dict,
              raw_size: int, rows: slice | None = None) -> dict:
    """Train the trainable parameters of ``W`` (fp32 copies) over
    ``batches`` in order, one update each. Returns each step's losses, the
    first update's clipped gradient and every parameter's change, by name.
    ``rows``: only these rows of every batch (a planted fault: part of the
    batch left out, the mean taken over the rest)."""
    names = [n for n in W if is_trainable(n)]
    params = {n: W[n].detach().clone().requires_grad_(True) for n in names}
    start = {n: W[n].detach().clone() for n in names}
    optim = torch.optim.AdamW(list(params.values()), lr=training["max_lr"], betas=(0.9, 0.98),
                              eps=1e-6, weight_decay=training["weight_decay"], foreach=False)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        optim, max_lr=training["max_lr"], total_steps=training["total_steps"],
        pct_start=training["warmup_ratio"], anneal_strategy="linear", div_factor=25.0,
        final_div_factor=1e4, cycle_momentum=False)
    clip = training["gradient_clip_val"]
    step_losses, first_grad = [], None
    for batch in batches:
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        frozen = frozen_features(P, W, cfg, batch, raw_size)
        Wt = dict(W, **params)
        out = losses(P, Wt, cfg, frozen, batch, training["label_smoothing"])
        with P.rounding():  # the backward in the control's precision too
            grads = torch.autograd.grad(out["loss"], list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params.values())]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.grad = g * scale
        if first_grad is None:
            first_grad = {n: p.grad.detach().clone() for n, p in params.items()}
        optim.step()
        sched.step()
        optim.zero_grad(set_to_none=True)
        step_losses.append({k: float(v.detach()) for k, v in out.items()})
    change = {n: (params[n].detach() - start[n]) for n in names}
    return {"losses": step_losses, "first_grad": first_grad, "change": change}
