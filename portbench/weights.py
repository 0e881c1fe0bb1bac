"""Random weights from the seed, made on the device in a few large draws.

``generate`` walks a parameter list (``reference/spec.py``) in order, draws
one uniform buffer per chunk of about 64M values with a generator on the
device, and hands each parameter's slice, scaled for its kind, to ``sink``.
The same seed, list and device give the same values, so the program's
parameters and the plain reference's copy are filled from one definition
without either keeping the other's.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 26


def _scaled(u: torch.Tensor, shape: tuple, kind: str) -> torch.Tensor:
    x = u * 2.0 - 1.0  # uniform in [-1, 1)
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind == "linear":
        return x / math.sqrt(shape[0])
    if kind in ("bias", "ln_bias"):
        return x * 0.1
    if kind == "ln_scale":
        return 1.0 + x * 0.1
    if kind == "conv_relu":  # He-uniform: a ReLU keeps the scale
        return x * math.sqrt(6.0 / fan_in)
    if kind == "conv_residual":  # a bottleneck's last conv, so the residual stream stays O(1)
        return x * 0.25 * math.sqrt(6.0 / fan_in)
    if kind == "conv1d":
        return x * math.sqrt(3.0 / fan_in)
    if kind == "pos":
        return x * 0.5
    if kind == "embed":  # std 0.02: the layers, not the input token, lead the tied projection
        return x * (0.02 * math.sqrt(3.0))
    if kind == "gate":  # tanh(gate) near 0.46: the fusion reaches the output
        return 0.5 + x * 0.1
    raise ValueError(f"unknown parameter kind {kind!r}")


@torch.no_grad()
def generate(spec, seed: int, device, sink) -> None:
    """Call ``sink(name, fp32 tensor on device)`` for every ``(name, shape,
    kind)`` of ``spec``, in order, with values drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pending, count = [], 0

    def flush():
        buf = torch.rand(count, generator=gen, device=device, dtype=torch.float32)
        offset = 0
        for name, shape, kind in pending:
            n = math.prod(shape)
            sink(name, _scaled(buf[offset:offset + n].view(shape), shape, kind))
            offset += n

    for name, shape, kind in spec:
        pending.append((name, tuple(shape), kind))
        count += math.prod(shape)
        if count >= CHUNK:
            flush()
            pending, count = [], 0
    if pending:
        flush()


def as_dict(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """``generate`` into a dict, name -> tensor."""
    out = {}

    def sink(name, value):
        out[name] = value.clone()

    generate(spec, seed, device, sink)
    return out


def fill_module(module: torch.nn.Module, spec, seed: int, prefix: str = "") -> None:
    """Fill ``module``'s parameters from the seed: each name of ``spec``,
    less ``prefix``, must be one of them, and every parameter must be named."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    filled = set()

    def sink(name, value):
        key = name[len(prefix):] if prefix and name.startswith(prefix) else name
        if key not in params:
            raise KeyError(f"the program has no parameter {key!r}")
        if tuple(params[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: the program holds {tuple(params[key].shape)}, "
                             f"the benchmark makes {tuple(value.shape)}")
        params[key].data.copy_(value)
        filled.add(key)

    generate(spec, seed, device, sink)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"the benchmark makes no value for {missing[:5]} "
                       f"({len(missing)} parameters)")
