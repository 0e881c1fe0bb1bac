"""Training losses (counterpart of ``ops/losses.py``): CTC and
label-smoothed cross-entropy, with the JAX package's semantics.

- ``ctc_loss`` ~ ``nn.CTCLoss(blank=0, reduction='mean', zero_infinity=True)``
  over log-softmaxed logits: each example's NLL is divided by
  ``max(label_length, 1)`` before the batch mean.
- ``label_smoothed_cross_entropy`` ~ ``nn.CrossEntropyLoss(ignore_index=-100,
  label_smoothing=0.1)``.

``ctc_nll`` is the per-example NLL. On CUDA tensors it launches the kernel
pair in ``csrc/ctc.cu`` under ``_CTCKernel``, a ``torch.autograd.Function``:
the forward recursion keeps its alphas and the backward computes the betas
and the gradient by the log-probabilities, summing a repeated label's terms
in a fixed order (two runs give the same bits) and giving an infeasible
example a gradient of exactly 0. Lengths and labels are int tensors on the
card and nothing is read back, so the CTC runs inside the train step's CUDA
graph, as the JAX CTC runs inside its jitted step. On CPU tensors it runs
``ctc_forward_log_probs``, the kernel's plain version: the JAX package's
log-semiring recursion in torch ops (``-1e30`` for a dead path, ``_log_add``
guarding its log so that a dead branch has gradient 0, alpha frozen past each
example's input length), differentiated by autograd. There is no fallback
from one to the other. The kernel ports no Pallas kernel: it replaces the
JAX package's ``lax.scan`` and the reverse scan that autodiff makes of it.

``ctc_native_nll`` computes the same NLL with ``torch.nn.functional.ctc_loss``.
No path of the port calls it: it is the library yardstick that
``chip_smoke.py`` times beside the kernel and that the CPU tests compare.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

NEG_INF = -1e30
INFEASIBLE = 5e29  # an NLL at or above it: no alignment fits the input
MAX_LABELS = 511  # the kernels' lattice, S = 2L + 1 <= 1023 positions, one thread each
MAX_CLASSES = 229_376  # the backward's bitmap of the classes a row emits, in shared memory

launches = 0  # kernel launches since the last reset_launches()
launches_by_kernel: collections.Counter = collections.Counter()  # "ctc_forward", "ctc_backward"


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_kernel.clear()


def uncounted(fn):
    """Run ``fn()`` with the CTC launches it makes left out of the counts;
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
    """Count ``n`` CTC launches that a replayed CUDA graph sent to the card."""
    global launches
    launches += n
    launches_by_kernel.update(by_kernel)


def _log_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    dead = mx <= NEG_INF
    mx_safe = torch.where(dead, 0.0, mx)
    s = torch.exp(a - mx_safe) + torch.exp(b - mx_safe)
    # Guard the log so the dead branch contributes zero gradient instead of
    # inf * 0 = NaN under autograd.
    s = torch.where(dead, 1.0, s)
    return torch.where(dead, NEG_INF, mx_safe + torch.log(s))


def _shift_right(x: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """``x`` moved ``n`` places along the last axis, ``fill`` coming in."""
    return F.pad(x, (n, 0), value=fill)[..., : x.shape[-1]]


def ctc_forward_log_probs(log_probs: torch.Tensor, labels: torch.Tensor,
                          input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                          blank_id: int = 0) -> torch.Tensor:
    """Per-example negative log likelihood of the CTC alignment lattice.

    log_probs ``[B, T, V]`` log-softmax outputs; labels ``[B, L]`` (padding
    value arbitrary, masked by length); input_lengths, label_lengths ``[B]``.
    Returns ``[B]`` NLL, un-normalised, like ``reduction='none'``."""
    b, t, _ = log_probs.shape
    l = labels.shape[1]
    s = 2 * l + 1
    dev = log_probs.device
    labels = labels.to(dev).long()
    input_lengths = input_lengths.to(dev)
    label_lengths = label_lengths.to(dev).long()

    # Extended label sequence: blank, y1, blank, y2, ..., blank.
    pos = torch.arange(s, device=dev)
    is_label = pos % 2 == 1
    label_idx = torch.clamp((pos - 1) // 2, 0, max(l - 1, 0))
    if l == 0:
        ext = torch.full((b, s), blank_id, dtype=torch.long, device=dev)
    else:
        ext = torch.where(is_label[None, :], labels[:, label_idx], blank_id)
    # Skip transition s-2 -> s: ext[s] is a label differing from ext[s-2].
    allow_skip = is_label[None, :] & (ext != _shift_right(ext, 2, blank_id))
    valid_pos = pos[None, :] < (2 * label_lengths[:, None] + 1)

    # Emission scores of each lattice position: [B, T, S].
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, s))

    dead = torch.full((b, 1), NEG_INF, dtype=log_probs.dtype, device=dev)
    first = [emit[:, 0, 0:1]]
    if s > 1:
        first += [torch.where(label_lengths[:, None] > 0, emit[:, 0, 1:2], dead),
                  dead.expand(b, s - 2)]
    alpha = torch.cat(first, dim=1)

    for ti in range(1, t):
        shift2 = torch.where(allow_skip, _shift_right(alpha, 2, NEG_INF), NEG_INF)
        new = _log_add(_log_add(alpha, _shift_right(alpha, 1, NEG_INF)), shift2) + emit[:, ti]
        new = torch.where(valid_pos, new, NEG_INF)
        # Freeze alpha past each example's input length.
        alpha = torch.where((ti < input_lengths)[:, None], new, alpha)

    # Final states: positions 2L and 2L - 1 of the extended sequence.
    end = 2 * label_lengths
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end_m1 = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    a_end_m1 = torch.where(label_lengths > 0, a_end_m1, NEG_INF)
    return -_log_add(a_end, a_end_m1)


def _check(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
           label_lengths: torch.Tensor, blank_id: int) -> None:
    """Raise on what the kernels do not take."""
    if log_probs.ndim != 3:
        raise ValueError(f"ctc takes log_probs [B, T, V], got {tuple(log_probs.shape)}")
    b, t, v = log_probs.shape
    if log_probs.dtype != torch.float32:
        raise TypeError(f"ctc's kernels take float32 log_probs, got {log_probs.dtype}")
    if labels.ndim != 2 or labels.shape[0] != b:
        raise ValueError(f"ctc takes labels [{b}, L], got {tuple(labels.shape)}")
    for name, x in (("input_lengths", input_lengths), ("label_lengths", label_lengths)):
        if tuple(x.shape) != (b,):
            raise ValueError(f"ctc takes {name} [{b}], got {tuple(x.shape)}")
    for name, x in (("labels", labels), ("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
            raise TypeError(f"ctc takes integer {name}, got {x.dtype}")
        if x.device != log_probs.device:
            raise ValueError(f"ctc's {name} lie on {x.device}, log_probs on "
                             f"{log_probs.device}: the kernels read them on the card")
    if not log_probs.is_contiguous():
        raise ValueError("ctc's kernels take contiguous log_probs")
    if b == 0 or t == 0:
        raise ValueError(f"ctc takes at least one example and one frame, got B={b}, T={t}")
    if labels.shape[1] > MAX_LABELS:
        raise ValueError(f"ctc's kernels take at most {MAX_LABELS} labels, got "
                         f"{labels.shape[1]}")
    if v > MAX_CLASSES:
        raise ValueError(f"ctc's kernels take at most {MAX_CLASSES} classes, got {v}")
    if not 0 <= blank_id < v:
        raise ValueError(f"blank id {blank_id} outside the {v} classes")


def _kernel_fn(name: str, n_pointers: int):
    from mocov2_whisper_flamingo_torch.ops import kernels

    fn = getattr(kernels.load("ctc"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launched(name: str, rc: int) -> None:
    global launches
    if rc != 0:
        why = "a shape the kernel does not take" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"ctc kernel {name} failed to launch: {why}")
    launches += 1
    launches_by_kernel[name] += 1


class _CTCKernel(torch.autograd.Function):
    """The kernel pair: ``ctc_alpha`` forward (the NLL, and the alphas it
    keeps), ``ctc_grad`` backward (the whole dense gradient by the
    log-probabilities). Takes checked, contiguous int64 labels and lengths."""

    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank_id):
        b, t, v = log_probs.shape
        l = labels.shape[1]
        alphas = torch.empty((b, t, 2 * l + 1), dtype=torch.float32, device=log_probs.device)
        nll = torch.empty((b,), dtype=torch.float32, device=log_probs.device)
        stream = torch.cuda.current_stream(log_probs.device).cuda_stream
        rc = _kernel_fn("ctc_forward", 6)(
            log_probs.data_ptr(), labels.data_ptr(), input_lengths.data_ptr(),
            label_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(), b, t, v, l, blank_id,
            stream)
        _launched("ctc_forward", rc)
        ctx.save_for_backward(log_probs, labels, input_lengths, label_lengths, alphas, nll)
        ctx.blank_id = blank_id
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        log_probs, labels, input_lengths, label_lengths, alphas, nll = ctx.saved_tensors
        b, t, v = log_probs.shape
        grad_nll = grad_nll.to(torch.float32).contiguous()
        grad = torch.empty_like(log_probs)
        stream = torch.cuda.current_stream(log_probs.device).cuda_stream
        rc = _kernel_fn("ctc_backward", 8)(
            log_probs.data_ptr(), labels.data_ptr(), input_lengths.data_ptr(),
            label_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(), grad_nll.data_ptr(),
            grad.data_ptr(), b, t, v, labels.shape[1], ctx.blank_id, stream)
        _launched("ctc_backward", rc)
        return grad, None, None, None, None


def ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
            label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Per-example NLL ``[B]`` of the CTC lattice (``reduction='none'``),
    differentiable in ``log_probs`` ``[B, T, V]``: the kernel pair on CUDA
    tensors (everything on one card; nothing is read back), the recursion
    ``ctc_forward_log_probs`` on CPU tensors. An infeasible example gives
    about ``1e30`` and, on the card, a gradient of exactly 0."""
    if log_probs.device.type == "cpu":
        return ctc_forward_log_probs(log_probs, labels, input_lengths, label_lengths, blank_id)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc runs on CUDA or CPU tensors, not {log_probs.device}")
    _check(log_probs, labels, input_lengths, label_lengths, blank_id)
    return _CTCKernel.apply(log_probs, labels.long().contiguous(),
                            input_lengths.long().contiguous(),
                            label_lengths.long().contiguous(), int(blank_id))


def ctc_native_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                   input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                   blank_id: int = 0, zero_infinity: bool = False) -> torch.Tensor:
    """The same ``[B]`` NLL from ``torch.nn.functional.ctc_loss``, the
    library yardstick (no path of the port calls it). An infeasible example
    gives ``inf`` here where the recursion gives about ``1e30``. Its gradient
    is NaN unless ``zero_infinity`` zeroes it inside the call: masking the
    NLL afterwards multiplies that NaN by 0. ``F.ctc_loss`` sizes its grids
    from host integers, so lengths on the card are read back; its CUDA
    backward adds a repeated label's terms with atomics, in no fixed order."""
    dev = log_probs.device
    return F.ctc_loss(log_probs.transpose(0, 1), labels.to(dev).long(),
                      input_lengths.long(), label_lengths.long(),
                      blank=blank_id, reduction="none", zero_infinity=zero_infinity)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0, zero_infinity: bool = True,
             reduction: str = "mean") -> torch.Tensor:
    """CTC loss over raw (pre-softmax) logits ``[B, T, V]``. With
    ``reduction="mean"`` each example's NLL is divided by its target length
    (at least 1), then averaged over the batch. ``zero_infinity`` zeroes
    the loss (and gradient) of an example whose input is too short for its
    target."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = ctc_nll(log_probs, labels, input_lengths, label_lengths, blank_id)
    if zero_infinity:
        bad = ~torch.isfinite(nll) | (nll >= INFEASIBLE)
        nll = torch.where(bad, 0.0, nll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    denom = torch.clamp(label_lengths.to(nll.device), min=1).to(nll.dtype)
    return (nll / denom).mean()


def label_smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 label_smoothing: float = 0.1, ignore_index: int = -100,
                                 reduction: str = "mean") -> torch.Tensor:
    """Label-smoothed CE over ``[..., V]`` logits and integer targets
    ``[...]``: ``(1 - eps) * nll(target) + eps * mean_k(-logp_k)``, tokens
    equal to ``ignore_index`` left out of the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = targets.to(logits.device).long()
    mask = targets != ignore_index
    safe_targets = torch.where(mask, targets, 0)
    nll = -torch.gather(logp, -1, safe_targets[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    loss = torch.where(mask, loss, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(mask.sum(), min=1)
