"""The frozen ResNet-50's 1x1 convolutions with their epilogue (port-only).

``bottleneck_gemm(x, weight, bias, stride, residual, relu)`` is a bottleneck
block's 1x1 convolution ``act(conv1x1(x, weight, stride) + bias (+ residual))``
over channels-last tensors: ``conv1`` (ReLU), ``conv3`` (the identity or the
downsample's output as the residual, ReLU) and the downsample (stride 1 or 2,
no activation). It launches the hand-written Hopper GEMM in
``csrc/bottleneck_gemm.cu``, which adds the fp32 bias and the residual to the
fp32 accumulators, applies the ReLU and rounds once to bf16; the kernel takes
bf16 channels-last activations and raises on anything else, CPU tensors
included. ``plain_bottleneck_gemm`` is the same function as the convolution,
the bias, the add and the ReLU that the frontend ran before the kernel, op
for op. There is no fallback from one to the other.

The kernel replaces no Pallas kernel: the JAX package leaves these
convolutions to XLA. It has no backward (the frontend is frozen), so the
wrapper raises on an input that requires grad.

``takes_kernel(x)`` says whether a tensor can take the kernel: a bf16 CUDA
tensor outside ``torch.export`` and ``torch.compile``. An fp32 one (the FP32
policy, held exact against the JAX package and against the eager step) and
every CPU tensor take the plain version, which on the card is cuDNN's
convolution as before. The frontend's blocks make the choice
(``models/visual_frontend.py::Bottleneck``); a block whose ``plain_gemm`` is
set takes the plain version on any tensor, as an exported artifact holds it
(``tools/export_model.py::as_traced``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

TILE_NS = (256, 128, 64)  # the kernel's output tile widths, widest first
# csrc/bottleneck_gemm.cu::bottleneck_gemm: a, w, bias, res, out; images, height,
# width, c_in, c_out, stride, relu, tile_n, blocks; the stream.
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

launches = 0  # kernel launches since the last reset_launches()
# The same launches by kernel instantiation, "bottleneck_gemm<tile width>".
launches_by_kernel: collections.Counter = collections.Counter()


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_kernel.clear()


def uncounted(fn):
    """Run ``fn()`` with the launches it makes left out of the counts;
    returns ``(fn's result, its launches, its launches by kernel)``, as
    ``flash_attention.uncounted`` does for K1 (a graph's capture keeps them
    and ``credit`` adds them at each replay)."""
    global launches
    n0, by0 = launches, collections.Counter(launches_by_kernel)
    try:
        out = fn()
        n, by = launches - n0, launches_by_kernel - by0
    finally:
        launches = n0
        launches_by_kernel.clear()
        launches_by_kernel.update(by0)
    return out, n, by


def credit(n: int, by_kernel: collections.Counter) -> None:
    """Count ``n`` launches that a replayed CUDA graph sent to the card."""
    global launches
    launches += n
    launches_by_kernel.update(by_kernel)


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether 1x1 convolutions over ``x`` can go to the kernel: a bf16 CUDA
    tensor, outside ``torch.export`` and ``torch.compile``."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and not torch.compiler.is_exporting() and not torch.compiler.is_compiling())


def tile_n(c_out: int) -> int:
    """The kernel's output tile width for ``c_out`` channels: the widest of
    ``TILE_NS`` that divides it."""
    return next(n for n in TILE_NS if c_out % n == 0)


def plain_bottleneck_gemm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          stride: int = 1, residual: torch.Tensor | None = None,
                          relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the frontend computed it
    before the kernel: ``F.conv2d`` with the weight and bias cast to ``x``'s
    dtype (the bias rounded there too), then the residual added, then the
    ReLU, each rounding to ``x``'s dtype."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, w, bias.to(x.dtype), stride=stride)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
           residual: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take."""
    if x.ndim != 4:
        raise ValueError(f"bottleneck_gemm takes x [N, C_in, H, W], got {tuple(x.shape)}")
    n, c_in, h, w = x.shape
    c_out = weight.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bottleneck_gemm's kernel takes bfloat16 x, got {x.dtype}")
    if tuple(weight.shape) != (c_out, c_in, 1, 1):
        raise ValueError(f"bottleneck_gemm takes a 1x1 weight [C_out, {c_in}, 1, 1], got "
                         f"{tuple(weight.shape)}")
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"bottleneck_gemm takes bias [{c_out}], got {tuple(bias.shape)}")
    if not (weight.is_floating_point() and bias.is_floating_point()):
        raise TypeError(f"bottleneck_gemm takes a floating weight and bias, got "
                        f"{weight.dtype}, {bias.dtype}")
    if c_in % 64 or c_out % 64:
        raise ValueError(f"bottleneck_gemm's kernel takes channels in multiples of 64, got "
                         f"{c_in} -> {c_out}")
    if stride not in (1, 2):
        raise ValueError(f"bottleneck_gemm's kernel takes stride 1 or 2, got {stride}")
    wo = (w - 1) // stride + 1
    if stride == 2 and wo > 128:
        raise ValueError(f"bottleneck_gemm's kernel takes at most 128 output columns at "
                         f"stride 2, got {wo}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bottleneck_gemm's kernel takes channels-last contiguous x")
    tensors = [("weight", weight), ("bias", bias)]
    if residual is not None:
        want = (n, c_out, (h - 1) // stride + 1, wo)
        if tuple(residual.shape) != want:
            raise ValueError(f"bottleneck_gemm takes residual {list(want)}, got "
                             f"{tuple(residual.shape)}")
        if residual.dtype != x.dtype:
            raise TypeError(f"bottleneck_gemm takes a residual of x's dtype {x.dtype}, got "
                            f"{residual.dtype}")
        if not residual.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("bottleneck_gemm's kernel takes a channels-last contiguous "
                             "residual")
        tensors.append(("residual", residual))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"bottleneck_gemm's {name} lies on {t.device}, x on {x.device}")
    # The kernel's TMA tensor maps take 16-byte aligned rows (a caching allocator's
    # storage is; a view may start elsewhere).
    for name, t in (("x", x), *tensors[2:]):
        if t.storage_offset() % 8:
            raise ValueError(f"bottleneck_gemm's kernel takes a 16-byte aligned {name}")


def _kernel_fn():
    from mocov2_whisper_flamingo_torch.ops import kernels

    fn = kernels.load("bottleneck_gemm").bottleneck_gemm
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(x, weight, bias, residual, stride: int, relu: bool, tile: int) -> torch.Tensor:
    """The output, allocated, and the kernel launched on the current stream
    for it; raises if the launch is refused. ``weight`` is ``[C_out, C_in]``
    in x's dtype, ``bias`` fp32, both contiguous."""
    n, c_in, h, w = x.shape
    c_out = weight.shape[0]
    out = torch.empty((n, c_out, (h - 1) // stride + 1, (w - 1) // stride + 1), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    rc = _kernel_fn()(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        n, h, w, c_in, c_out, stride, int(relu), tile, _sm_count(x.device.index),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        why = {-1: "arguments the kernel does not take",
               -2: "a TMA tensor map cannot describe a tensor",
               -3: "the CUDA driver has no cuTensorMapEncodeTiled"}.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"bottleneck_gemm kernel launch failed: {why}")
    return out


def bottleneck_gemm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    stride: int = 1, residual: torch.Tensor | None = None,
                    relu: bool = False) -> torch.Tensor:
    """``act(conv1x1(x, weight, stride) + bias (+ residual))`` over
    channels-last ``x [N, C_in, H, W]``, ``weight [C_out, C_in, 1, 1]``,
    ``bias [C_out]`` and ``residual [N, C_out, H_out, W_out]``; returns a
    channels-last ``[N, C_out, H_out, W_out]`` in ``x``'s dtype, from the
    kernel; raises on what it does not take (``plain_bottleneck_gemm`` is
    the same function on any tensor)."""
    global launches
    if any(t is not None and t.requires_grad for t in (x, weight, bias, residual)):
        raise ValueError("bottleneck_gemm has no backward: the frontend is frozen, and no "
                         "input may require grad")
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_gemm's kernel runs on CUDA tensors, not {x.device}")
    _check(x, weight, bias, stride, residual)
    n, c_in, h, w = x.shape
    c_out = weight.shape[0]
    if n * h * w == 0:
        return torch.empty((n, c_out, (h - 1) // stride + 1, (w - 1) // stride + 1),
                           dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    tile = tile_n(c_out)
    out = _launch(x, weight.to(x.dtype).reshape(c_out, c_in).contiguous(),
                  bias.to(torch.float32).contiguous(), residual, stride, relu, tile)
    launches += 1
    launches_by_kernel[f"bottleneck_gemm<{tile}>"] += 1
    return out
