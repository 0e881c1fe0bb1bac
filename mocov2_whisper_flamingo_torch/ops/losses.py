"""Training losses (counterpart of ``ops/losses.py``): CTC and
label-smoothed cross-entropy, with the JAX package's semantics.

- ``ctc_loss`` ~ ``nn.CTCLoss(blank=0, reduction='mean', zero_infinity=True)``
  over log-softmaxed logits: each example's NLL is divided by
  ``max(label_length, 1)`` before the batch mean.
- ``label_smoothed_cross_entropy`` ~ ``nn.CrossEntropyLoss(ignore_index=-100,
  label_smoothing=0.1)``.

``ctc_forward_log_probs`` is the JAX package's log-semiring forward
recursion in torch ops: ``-1e30`` stands for a dead path, ``_log_add`` guards
its log so a dead branch has gradient 0, and alpha is frozen past each
example's input length. It is a loop of T - 1 steps of about ten small ops,
forward and again backward, so on a CUDA card it is bound by kernel
launches. ``ctc_native_nll`` computes the same per-example NLL with
``torch.nn.functional.ctc_loss`` (one kernel each way); ``ctc_loss`` takes it
for CUDA tensors and the recursion for CPU tensors. On the card the lengths
may be given on the host, which spares ``F.ctc_loss`` their read-back. The JAX package computes
CTC outside any Pallas kernel, so neither is a kernel port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


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


def ctc_native_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                   input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                   blank_id: int = 0, zero_infinity: bool = False) -> torch.Tensor:
    """The same ``[B]`` NLL from ``torch.nn.functional.ctc_loss``. An
    infeasible example gives ``inf`` here where the recursion gives about
    ``1e30``. Its gradient is NaN unless ``zero_infinity`` zeroes it inside
    the call: masking the NLL afterwards multiplies that NaN by 0.

    The lengths stay where they are given: ``F.ctc_loss`` sizes its grids
    from host integers, so lengths on the card are read back (a wait for
    every kernel queued before), and lengths on the host are not."""
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
    if log_probs.is_cuda:
        nll = ctc_native_nll(log_probs, labels, input_lengths, label_lengths, blank_id,
                             zero_infinity)
    else:
        nll = ctc_forward_log_probs(log_probs, labels, input_lengths, label_lengths, blank_id)
    if zero_infinity:
        bad = ~torch.isfinite(nll) | (nll >= -NEG_INF * 0.5)
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
