"""Optimizer and LR schedule (counterpart of ``training/optim.py``).

The reference recipe: AdamW with betas (0.9, 0.98), eps 1e-6, weight decay
0.01, global-norm gradient clipping at 1.0, gradient accumulation x4, and a
OneCycle schedule with linear anneal (pct_start = warmup_ratio, div_factor
25, final_div_factor 1e4). Only the trainable parameters are given to the
optimizer, so the frozen Whisper encoder and MoCo frontend get no update and
no optimizer state.

``Optimizer`` does what the JAX package's optax chain does around AdamW:
accumulation keeps the running **mean** of the micro-batch gradients and
applies one update every ``accum`` micro-batches (``optax.MultiSteps``); the
clip divides by the norm itself (``torch.nn.utils.clip_grad_norm_`` divides
by ``norm + 1e-6``, so it is written out here); the schedule is read at the
count of updates made so far.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

NO_DECAY_NAMES = {"bias", "scale", "attn_gate", "ff_gate"}


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.1,
                 div_factor: float = 25.0,
                 final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``OneCycleLR(anneal_strategy='linear')`` as a function of the update
    count: a linear ramp ``max_lr / div_factor -> max_lr`` over
    ``round(total * pct) - 1`` updates, then a linear decay to
    ``initial / final_div_factor`` at the last update."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    warmup_steps = max(int(round(total_steps * pct_start)) - 1, 1)
    decay_steps = max(total_steps - 1 - warmup_steps, 1)

    def linear(start: float, end: float, steps: int, count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (start - end) * frac + end

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return linear(initial_lr, max_lr, warmup_steps, count)
        return linear(max_lr, min_lr, decay_steps, count - warmup_steps)

    return schedule


def no_decay_mask(name: str, param: torch.Tensor) -> bool:
    """True for a parameter that should receive weight decay. Biases,
    LayerNorm scales and biases and the scalar fusion gates are exempt."""
    if set(name.split(".")) & NO_DECAY_NAMES:
        return False
    return param.ndim >= 2


class Optimizer:
    """Clip -> AdamW on a OneCycle schedule, behind micro-batch accumulation."""

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]],
                 training_config: Any, total_steps: int,
                 decay_mask: Callable[[str, torch.Tensor], bool] | None = None):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.schedule = one_cycle_lr(max_lr=training_config["max_lr"], total_steps=total_steps,
                                     pct_start=training_config.get("warmup_ratio", 0.1))
        self.clip = training_config.get("gradient_clip_val", 1.0)
        self.accum = int(training_config.get("accumulate_grad_batches", 1) or 1)
        decay = training_config.get("weight_decay", 0.01)
        decayed = [p for n, p in named if decay_mask is None or decay_mask(n, p)]
        exempt = [p for n, p in named if decay_mask is not None and not decay_mask(n, p)]
        groups = [{"params": decayed, "weight_decay": decay}]
        if exempt:
            groups.append({"params": exempt, "weight_decay": 0.0})
        self.adamw = torch.optim.AdamW(groups, lr=self.schedule(0), betas=(0.9, 0.98),
                                       eps=1e-6, weight_decay=decay)
        self.count = 0      # updates applied
        self.mini_step = 0  # micro-batches in the running mean
        self._mean = None   # running mean of the micro-batch gradients

    def step(self, grads: list[torch.Tensor]) -> None:
        """Take one micro-batch's gradients (in the order of the parameters
        given); apply an update when ``accum`` of them have come in."""
        if self.accum > 1:
            if self._mean is None:
                self._mean = [torch.zeros_like(p) for p in self.params]
            # mean += (g - mean) / (n + 1)
            delta = torch._foreach_sub(grads, self._mean)
            torch._foreach_add_(self._mean, delta, alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return
            grads, self._mean, self.mini_step = self._mean, None, 0
        if self.clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step,
                "mean": None if self._mean is None else [m.clone() for m in self._mean]}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self._mean = (None if state["mean"] is None
                      else [m.to(p.device) for m, p in zip(state["mean"], self.params)])


def make_optimizer(training_config: Any, total_steps: int,
                   named_params: Iterable[tuple[str, torch.nn.Parameter]],
                   decay_mask: Callable[[str, torch.Tensor], bool] | None = None
                   ) -> tuple[Optimizer, Callable[[int], float]]:
    """The optimizer over ``named_params`` (the trainable ones only) and its
    schedule. ``total_steps`` counts updates, not micro-batches.
    ``decay_mask`` (see ``no_decay_mask``) restricts weight decay to
    matmul-shaped weights."""
    opt = Optimizer(named_params, training_config, total_steps, decay_mask)
    return opt, opt.schedule
