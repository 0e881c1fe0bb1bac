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

All of its state lives on the parameters' device at fixed addresses, as
the JAX optimizer state does, so that a CUDA graph can hold the whole step
(``training/programs.py``): the update count, the micro-batch counter, the
running mean and AdamW's moments (flat fp32 buffers in AdamW's slot order:
the decayed parameters, then the exempt ones). The schedule is evaluated on
the device from the count (``one_cycle_lr_tensor``; ``one_cycle_lr`` gives
its numbers on the host, for logging), and whether a micro-batch updates is
decided there too: ``step(grads, ok)`` with a 0-d bool ``ok`` applies the
JAX non-finite guard's ``where``, so a micro-batch with ``ok`` False leaves
every parameter and every state tensor bit for bit as it was.
``state_dict`` keeps the layout of ``torch.optim.AdamW`` (``{"adamw":
{"state", "param_groups"}, "count", "mini_step", "mean"}``), so checkpoints
written before still load.

On a mesh (``parallel/mesh.py``) the step also does what the JAX step gets
from GSPMD: each micro-batch's gradients are summed over the data group in
one all-reduce of a flat buffer (the task scales each rank's loss by the
global batch's counts, so the sum is the global batch's gradient), and the
clip's global norm sums the squares of split parameters over the model
group while counting each whole (replicated) parameter once.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

from mocov2_whisper_flamingo_torch.parallel.tensor_parallel import all_gather_cat, all_reduce_sum

NO_DECAY_NAMES = {"bias", "scale", "attn_gate", "ff_gate"}


def one_cycle_lr_tensor(max_lr: float, total_steps: int, pct_start: float = 0.1,
                        div_factor: float = 25.0,
                        final_div_factor: float = 1e4) -> Callable[[torch.Tensor], torch.Tensor]:
    """``OneCycleLR(anneal_strategy='linear')`` as a function of the update
    count, a 0-d integer tensor (on the device, for a step that reads nothing
    back): a linear ramp ``max_lr / div_factor -> max_lr`` over ``round(total
    * pct) - 1`` updates, then a linear decay to ``initial /
    final_div_factor`` at the last update. float64, one IEEE operation at a
    time, so the card's numbers are the host's."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    warmup_steps = max(int(round(total_steps * pct_start)) - 1, 1)
    decay_steps = max(total_steps - 1 - warmup_steps, 1)

    def linear(start: float, end: float, steps: int, count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - torch.clamp(count, 0, steps) / steps
        return frac * (start - end) + end

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.float64)
        return torch.where(count < warmup_steps,
                           linear(initial_lr, max_lr, warmup_steps, count),
                           linear(max_lr, min_lr, decay_steps, count - warmup_steps))

    return schedule


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.1,
                 div_factor: float = 25.0,
                 final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``one_cycle_lr_tensor`` as a function of an int count on the host
    (for logging)."""
    schedule = one_cycle_lr_tensor(max_lr, total_steps, pct_start, div_factor, final_div_factor)
    return lambda count: float(schedule(torch.tensor(count)))


def no_decay_mask(name: str, param: torch.Tensor) -> bool:
    """True for a parameter that should receive weight decay. Biases,
    LayerNorm scales and biases and the scalar fusion gates are exempt."""
    if set(name.split(".")) & NO_DECAY_NAMES:
        return False
    return param.ndim >= 2


BETAS = (0.9, 0.98)
EPS = 1e-6


class Optimizer:
    """Clip -> AdamW on a OneCycle schedule, behind micro-batch accumulation,
    its state on the parameters' device (see the module doc)."""

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]],
                 training_config: Any, total_steps: int,
                 decay_mask: Callable[[str, torch.Tensor], bool] | None = None,
                 mesh=None, split_dims: dict[str, int] | None = None):
        """``mesh``: the data and model groups to reduce over (None: one
        process); ``split_dims``: ``{name: dimension}`` of the parameters
        split over the model group (``parallel.mesh.sharded_dims``)."""
        named = list(named_params)
        self.params = [p for _, p in named]
        self.data_group = getattr(mesh, "data_group", None)
        self.model_group = getattr(mesh, "model_group", None)
        split_dims = split_dims or {}
        self.split_dims = [split_dims.get(n) for n, _ in named]
        schedule_args = dict(max_lr=training_config["max_lr"], total_steps=total_steps,
                             pct_start=training_config.get("warmup_ratio", 0.1))
        self.schedule = one_cycle_lr(**schedule_args)  # host, for logging
        self.lr_at = one_cycle_lr_tensor(**schedule_args)
        self.clip = training_config.get("gradient_clip_val", 1.0)
        self.accum = int(training_config.get("accumulate_grad_batches", 1) or 1)
        self.weight_decay = training_config.get("weight_decay", 0.01)
        decayed = [i for i, (n, p) in enumerate(named) if decay_mask is None or decay_mask(n, p)]
        exempt = [i for i, (n, p) in enumerate(named) if decay_mask is not None
                  and not decay_mask(n, p)]
        self.groups = [decayed] + ([exempt] if exempt else [])
        self.order = decayed + exempt  # AdamW's slot -> parameter index
        self.sizes = [self.params[i].numel() for i in self.order]
        self.n_decayed = sum(self.params[i].numel() for i in decayed)
        dev = self.params[0].device
        n = sum(self.sizes)
        self.exp_avg = torch.zeros(n, dtype=torch.float32, device=dev)
        self.exp_avg_sq = torch.zeros(n, dtype=torch.float32, device=dev)
        # updates applied; micro-batches in the running mean
        self._count = torch.zeros((), dtype=torch.int64, device=dev)
        self._mini_step = torch.zeros((), dtype=torch.int64, device=dev)
        # running mean of the micro-batch gradients (zero between updates)
        self._mean = torch.zeros(n, dtype=torch.float32, device=dev) if self.accum > 1 else None

    @property
    def count(self) -> int:
        """Updates applied (read from the device)."""
        return int(self._count)

    @property
    def mini_step(self) -> int:
        """Micro-batches in the running mean (read from the device)."""
        return int(self._mini_step)

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor of the optimizer's state; each keeps its address."""
        return [t for t in (self.exp_avg, self.exp_avg_sq, self._count, self._mini_step,
                            self._mean) if t is not None]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], ok: torch.Tensor | None = None) -> None:
        """Take one micro-batch's gradients (in the order of the parameters
        given); apply an update when ``accum`` of them have come in. ``ok``:
        a 0-d bool on the device; where it is False nothing changes."""
        g = torch.cat([grads[i].reshape(-1).float() for i in self.order])
        if self.data_group is not None:
            g = all_reduce_sum(g, self.data_group)
        apply = ok
        if self.accum > 1:
            n = self._mini_step + 1
            mean = self._mean + (g - self._mean) / n  # optax.MultiSteps' running mean
            last = n == self.accum
            apply = last if ok is None else ok & last
            new_mean, new_n = torch.where(last, 0.0, mean), torch.where(last, 0, n)
            if ok is not None:
                new_mean = torch.where(ok, new_mean, self._mean)
                new_n = torch.where(ok, new_n, self._mini_step)
            self._mean.copy_(new_mean)
            self._mini_step.copy_(new_n)
            g = mean
        if self.clip is not None:
            norm = self._global_norm(g.split(self.sizes))
            g = g * torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        self._adamw(g, apply)

    def _adamw(self, g: torch.Tensor, apply: torch.Tensor | None) -> None:
        """AdamW on the flat gradient ``g`` (slot order) at the schedule's
        rate for the current count; where ``apply`` is False, nothing
        changes."""
        b1, b2 = BETAS
        lr = self.lr_at(self._count)
        step = (self._count + 1).to(torch.float64)
        step_size = lr / (1.0 - torch.pow(b1, step))
        bc2_sqrt = torch.sqrt(1.0 - torch.pow(b2, step))
        m = torch.lerp(self.exp_avg, g, 1.0 - b1)
        v = torch.addcmul(self.exp_avg_sq * b2, g, g, value=1.0 - b2)
        # ``.data``: written in place without a bump of the parameters'
        # version counters, so that an autograd graph which saved them (the
        # train program's forward graph) stays valid across steps
        params = [self.params[i].data for i in self.order]
        p = torch.cat([x.reshape(-1).float() for x in params])
        new_p = p.clone()
        new_p[:self.n_decayed] *= 1.0 - lr * self.weight_decay
        new_p -= m / (v.sqrt() / bc2_sqrt + EPS) * step_size
        if apply is not None:
            new_p = torch.where(apply, new_p, p)
            m = torch.where(apply, m, self.exp_avg)
            v = torch.where(apply, v, self.exp_avg_sq)
        self.exp_avg.copy_(m)
        self.exp_avg_sq.copy_(v)
        torch._foreach_copy_(params, [x.view_as(t) for x, t in
                                      zip(new_p.split(self.sizes), params)])
        self._count += 1 if apply is None else apply.long()

    def _global_norm(self, grads) -> torch.Tensor:
        """The global norm of ``grads`` in slot order."""
        norms = torch._foreach_norm(list(grads))
        dims = [self.split_dims[i] for i in self.order]
        whole = [n for n, d in zip(norms, dims) if d is None]
        split = [n for n, d in zip(norms, dims) if d is not None]
        norm = torch.linalg.vector_norm(torch.stack(whole)) if whole else norms[0] * 0
        if not split:
            return norm
        return torch.sqrt(norm.square()
                          + all_reduce_sum(torch.stack(split).square().sum(), self.model_group))

    def _map_split(self, state: dict, fn) -> dict:
        """``state`` with ``fn(tensor, dim)`` applied to every moment and
        running mean of a split parameter."""
        state = dict(state, adamw=dict(state["adamw"]))
        dims = [self.split_dims[i] for i in self.order]
        state["adamw"]["state"] = {
            i: {k: fn(v, dims[i]) if dims[i] is not None and v.ndim else v
                for k, v in moments.items()}
            for i, moments in state["adamw"]["state"].items()}
        if state["mean"] is not None:
            state["mean"] = [m if d is None else fn(m, d)
                             for m, d in zip(state["mean"], self.split_dims)]
        return state

    def whole_state_dict(self) -> dict:
        """``state_dict`` with the moments and running means of split
        parameters gathered whole over the model group (a collective)."""
        state = self.state_dict()
        if self.model_group is None:
            return state
        return self._map_split(state, lambda v, d: all_gather_cat(v, self.model_group, d))

    def load_whole_state_dict(self, state: dict, model_index: int, n_model: int) -> None:
        """Load a whole state (``whole_state_dict``, or one process's):
        each split parameter's moments and means take this rank's slice."""
        if n_model > 1:
            state = self._map_split(
                state, lambda v, d: v.chunk(n_model, d)[model_index].contiguous())
        self.load_state_dict(state)

    def _slots(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """A flat buffer's parts, each shaped as its slot's parameter."""
        return [x.view_as(self.params[i]) for x, i in zip(flat.split(self.sizes), self.order)]

    def state_dict(self) -> dict:
        """The state in ``torch.optim.AdamW``'s layout (moments only once an
        update was applied), with the counts as ints and the running mean,
        None between updates, in the order of the parameters."""
        count, mini_step = self.count, self.mini_step
        state = {}
        if count:
            state = {slot: {"step": torch.tensor(float(count)), "exp_avg": m.clone(),
                            "exp_avg_sq": v.clone()}
                     for slot, (m, v) in enumerate(zip(self._slots(self.exp_avg),
                                                       self._slots(self.exp_avg_sq)))}
        groups, first = [], 0
        for n, group in enumerate(self.groups):
            groups.append({"lr": self.schedule(count), "betas": BETAS, "eps": EPS,
                           "weight_decay": self.weight_decay if n == 0 else 0.0,
                           "params": list(range(first, first + len(group)))})
            first += len(group)
        mean = None
        if mini_step:
            by_param = dict(zip(self.order, self._slots(self._mean)))
            mean = [by_param[i].clone() for i in range(len(self.params))]
        return {"adamw": {"state": state, "param_groups": groups}, "count": count,
                "mini_step": mini_step, "mean": mean}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load a ``state_dict`` (of this class, or of the optimizer that
        kept ``torch.optim.AdamW``) into the state tensors in place."""
        moments = state["adamw"]["state"]
        for slot, (m, v) in enumerate(zip(self._slots(self.exp_avg),
                                          self._slots(self.exp_avg_sq))):
            if slot in moments:
                m.copy_(moments[slot]["exp_avg"])
                v.copy_(moments[slot]["exp_avg_sq"])
            else:
                m.zero_()
                v.zero_()
        self._count.fill_(int(state["count"]))
        self._mini_step.fill_(int(state["mini_step"]))
        if self._mean is not None:
            self._mean.zero_()
            if state["mean"] is not None:
                by_param = dict(zip(self.order, self._slots(self._mean)))
                for i, value in enumerate(state["mean"]):
                    by_param[i].copy_(value)


def make_optimizer(training_config: Any, total_steps: int,
                   named_params: Iterable[tuple[str, torch.nn.Parameter]],
                   decay_mask: Callable[[str, torch.Tensor], bool] | None = None,
                   mesh=None, split_dims: dict[str, int] | None = None
                   ) -> tuple[Optimizer, Callable[[int], float]]:
    """The optimizer over ``named_params`` (the trainable ones only) and its
    schedule. ``total_steps`` counts updates, not micro-batches.
    ``decay_mask`` (see ``no_decay_mask``) restricts weight decay to
    matmul-shaped weights; ``mesh`` / ``split_dims`` as for ``Optimizer``."""
    opt = Optimizer(named_params, training_config, total_steps, decay_mask, mesh, split_dims)
    return opt, opt.schedule
