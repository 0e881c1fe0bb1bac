"""Layer library of the port (counterpart of ``models/layers.py``).

Parameters are held in fp32 and cast to the policy's compute dtype at use;
LayerNorm stays an fp32 island. Linear weights keep the JAX ``[d_in, d_out]``
storage and are applied as ``x @ W``. ``QuantLinear`` and ``QuantEmbedding``
hold weight-only int8 (``kernel_q`` / ``embedding_q``) with fp32 scales under
the JAX leaf names. Parameters are created zero-filled:
the values come from the weight bridge (``models/convert.py``). They are
created with ``requires_grad=False``; a model that trains turns it on for
its trainable parameters (``AVNet``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mocov2_whisper_flamingo_torch.parallel import tensor_parallel as TP


@dataclasses.dataclass(frozen=True)
class Precision:
    compute_dtype: torch.dtype = torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


FP32 = Precision()
BF16 = Precision(compute_dtype=torch.bfloat16)


def zeros_param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


class _TensorParallel:
    """A linear's place in a tensor-parallel unit, set by
    ``parallel.mesh.shard_module``: ``tp_mode`` "column" (this rank holds a
    slice of the output features), "row" (a slice of the input features:
    the partial products are summed over ``tp_group`` before the bias) or
    "gather" (a column slice whose outputs are gathered whole); None for a
    whole linear."""

    tp_mode: str | None = None
    tp_group = None

    def _tp_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mode in ("column", "gather"):
            return TP.copy_to_model_group(x, self.tp_group)
        return x

    def _tp_output(self, y: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        if self.tp_mode == "row":
            y = TP.reduce_from_model_group(y, self.tp_group)
        if bias is not None:
            y = y + bias
        if self.tp_mode == "gather":
            y = TP.gather_from_model_group(y, self.tp_group)
        return y


class Linear(_TensorParallel, nn.Module):
    """``y = cast(x) @ cast(kernel) + cast(bias)``, kernel ``[d_in, d_out]``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 precision: Precision = FP32, device=None):
        super().__init__()
        self.precision = precision
        self.kernel = zeros_param((d_in, d_out), device)
        self.bias = zeros_param((d_out,), device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        prec = self.precision
        y = torch.matmul(prec.cast(self._tp_input(x)), prec.cast(self.kernel))
        return self._tp_output(y, None if self.bias is None else prec.cast(self.bias))


def quantize_int8(w: torch.Tensor, dim: int, floor: float = 1e-12, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice along ``dim``: ``scale =
    max|w| / 127`` over ``dim`` (floored at ``floor``), ``q = round(w /
    scale)`` (half to even), in fp32. Returns ``(q int8, scale fp32)`` with
    ``dim`` reduced in the scale. A linear kernel ``[d_in, d_out]`` takes
    ``dim=0`` (one scale per output channel), an embedding table ``[vocab,
    D]`` ``dim=1`` (one per row, which serves the lookup and the tied
    projection ``x @ table.T`` alike). ``group``: ``w`` is this rank's slice
    along ``dim`` and the maximum is taken over the group's slices."""
    w = w.float()
    amax = w.abs().amax(dim=dim, keepdim=True)
    if group is not None:
        amax = TP.all_gather_cat(amax, group, dim).amax(dim=dim, keepdim=True)
    scale = (amax / 127.0).clamp_min(floor)
    return torch.round(w / scale).to(torch.int8), scale.squeeze(dim)


def int8_param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.int8, device=device),
                        requires_grad=False)


class QuantLinear(_TensorParallel, nn.Module):
    """Weight-only int8 linear (w8a16): ``kernel_q`` int8 ``[d_in, d_out]``,
    ``scale`` ``[d_out]`` and ``bias``. ``y = cast((cast(x) @ kernel_q) *
    scale + bias)`` with the product and the affine in fp32 (the JAX
    package's ``preferred_element_type=float32``). The operands are fp32:
    compute-dtype and int8 values are exact there, so this is the fp32
    accumulation of the compute-dtype product."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 precision: Precision = FP32, device=None):
        super().__init__()
        self.precision = precision
        self.kernel_q = int8_param((d_in, d_out), device)
        self.scale = zeros_param((d_out,), device)
        self.bias = zeros_param((d_out,), device) if bias else None

    @classmethod
    def from_linear(cls, lin: Linear) -> "QuantLinear":
        d_in, d_out = lin.kernel.shape
        out = cls(d_in, d_out, lin.bias is not None, lin.precision, lin.kernel.device)
        out.tp_mode, out.tp_group = lin.tp_mode, lin.tp_group
        # A row shard holds a slice of the input features: its scales are
        # the whole kernel's.
        q, scale = quantize_int8(lin.kernel.detach(), 0,
                                 group=lin.tp_group if lin.tp_mode == "row" else None)
        with torch.no_grad():
            out.kernel_q.copy_(q)
            out.scale.copy_(scale)
            if lin.bias is not None:
                out.bias.data = lin.bias.detach().clone()
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        prec = self.precision
        y = torch.matmul(prec.cast(self._tp_input(x)).float(),
                         self.kernel_q.float()) * self.scale.float()
        return prec.cast(self._tp_output(y, None if self.bias is None else self.bias.float()))


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = zeros_param((dim,), device)
        self.bias = zeros_param((dim,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


class Conv1d(nn.Module):
    """Conv over ``[B, T, C_in] -> [B, T', C_out]``; weight in torch's
    ``[C_out, C_in, K]`` layout (the bridge transposes JAX's ``WIO``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, precision: Precision = FP32, device=None):
        super().__init__()
        self.precision = precision
        self.stride = stride
        self.padding = padding
        self.weight = zeros_param((c_out, c_in, kernel), device)
        self.bias = zeros_param((c_out,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        prec = self.precision
        y = F.conv1d(prec.cast(x).transpose(1, 2), prec.cast(self.weight),
                     prec.cast(self.bias), stride=self.stride,
                     padding=self.padding)
        return y.transpose(1, 2)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.embedding = zeros_param((vocab, dim), device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class QuantEmbedding(nn.Module):
    """int8 table ``embedding_q [vocab, D]`` with per-row ``scale``: a
    looked-up row is ``row * scale[row]`` in fp32."""

    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.embedding_q = int8_param((vocab, dim), device)
        self.scale = zeros_param((vocab,), device)

    @classmethod
    def from_embedding(cls, emb: Embedding) -> "QuantEmbedding":
        vocab, dim = emb.embedding.shape
        out = cls(vocab, dim, emb.embedding.device)
        q, scale = quantize_int8(emb.embedding.detach(), 1)
        with torch.no_grad():
            out.embedding_q.copy_(q)
            out.scale.copy_(scale)
        return out

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding_q[ids].float() * self.scale[ids].float()[..., None]


class KeptDraws:
    """A draw source that keeps its uniform draws: a checkpointed block's
    first run under CUDA graph capture draws from ``generator`` and keeps
    each draw; its recompute (``replay()`` first) takes them back in order.
    A capture cannot rewind a generator (``get_state`` / ``set_state`` read
    and write the host), and the kept tensors hold the same numbers that a
    rewound generator would draw again (``models/fusion.py``)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: list[torch.Tensor] = []
        self._next: int | None = None  # None: drawing; else the next kept draw

    def replay(self) -> None:
        self._next = 0

    def uniform(self, shape, device) -> torch.Tensor:
        if self._next is None:
            self.draws.append(torch.rand(shape, generator=self.generator, device=device))
            return self.draws[-1]
        draw = self.draws[self._next]
        self._next += 1
        return draw


def uniform(shape, generator: "torch.Generator | KeptDraws", device) -> torch.Tensor:
    """Uniform ``[0, 1)`` draws of ``shape`` from a generator or a ``KeptDraws``."""
    if isinstance(generator, KeptDraws):
        return generator.uniform(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, rate: float, generator: "torch.Generator | KeptDraws | None",
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout with an explicit generator (which must live on x's
    device) or ``KeptDraws``: ``x / (1 - rate)`` where kept, 0 elsewhere. The
    identity when ``deterministic``, at rate 0 or without a generator."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = uniform(x.shape, generator, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x, approximate="none")


def sinusoid_position_encoding(length: int, dim: int, base: float = 10000.0) -> np.ndarray:
    """Whisper-style sinusoids: ``[sin | cos]`` over the feature dim."""
    half = dim // 2
    log_timescale = math.log(base) / (half - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(half))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def interleaved_position_encoding(length: int, dim: int, base: float = 10000.0) -> np.ndarray:
    """Transformer PE with sin/cos interleaved over even/odd features."""
    pe = np.zeros((length, dim), dtype=np.float32)
    position = np.arange(length, dtype=np.float64)[:, None]
    denom = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(base) / dim))
    pe[:, 0::2] = np.sin(position * denom)
    pe[:, 1::2] = np.cos(position * denom)
    return pe
