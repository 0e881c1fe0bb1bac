"""Megatron tensor parallelism as autograd functions (the port's form of
what GSPMD derives from the JAX package's sharding rules).

A column-parallel linear holds a slice of the output features, a row-parallel
one the matching slice of the input features. Between them:

- ``copy_to_model_group``: the identity forward, an all-reduce of the
  gradient backward. It stands before a column-parallel linear, whose input
  every rank of the model group holds whole: each rank's shard adds its part
  of the input's gradient.
- ``reduce_from_model_group``: an all-reduce forward, the identity backward.
  It follows a row-parallel linear's partial products, before the bias,
  which is added once to the sum.
- ``gather_from_model_group``: the output shards of a column-parallel head
  concatenated along the last dimension (the list form of ``all_gather``);
  backward keeps this rank's slice of the gradient.

Each is the identity when ``group`` is None (a model axis of 1). Only
``all_reduce``, ``broadcast`` and the list form of ``all_gather`` are used,
which gloo also runs on CUDA tensors. None reads the card back, so on NCCL
groups the train program's graphs capture them with the rest of the step
(``training/programs.py``); the list form's buffers are then allocated from
the graph's pool.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place; ``x`` itself when ``group`` is None."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ``group``'s tensors concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModelGroup.apply(x, group)


def gather_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherFromModelGroup.apply(x, group)
