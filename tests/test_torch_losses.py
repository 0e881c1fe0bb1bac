"""The port's training losses against the JAX package on the CPU: values and
input gradients from the same numpy inputs; the CTC wrapper's checks and its
plain path; the CTC kernels' algorithm (``csrc/ctc.cu``, mirrored in numpy)
against the JAX recursion and its gradient; and the library CTC call (the
yardstick ``chip_smoke.py`` times) against the port's own recursion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import losses as TL
from mocov2_whisper_flamingo_tpu.ops import losses as JL
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

ATOL = 2e-5  # fp32 log-sum-exp chains of up to 20 steps, other summation orders
GRAD_ATOL = 2e-6  # gradients are probabilities / B / L: small numbers

# (label rows, label lengths, input lengths): T = 12 frames, V = 7
CTC_CASES = {
    "plain": ([[1, 2, 3, 0], [4, 5, 0, 0]], [3, 2], [12, 12]),
    "repeated_labels": ([[2, 2, 2, 3], [1, 1, 0, 0]], [4, 2], [12, 9]),
    "zero_length_target": ([[1, 2, 0, 0], [0, 0, 0, 0]], [2, 0], [12, 12]),
    "short_inputs": ([[1, 2, 3, 4], [5, 6, 0, 0]], [4, 2], [7, 3]),
    "input_shorter_than_target": ([[1, 2, 3, 4], [1, 1, 1, 0]], [4, 3], [3, 4]),
    "blank_collides_with_padding": ([[3, 0, 0, 0], [6, 6, 6, 6]], [1, 4], [12, 12]),
}


def _ctc_inputs(rng, case):
    labels, label_lengths, input_lengths = CTC_CASES[case]
    logits = rng.standard_normal((2, 12, 7)).astype(np.float32) * 2.0
    return (logits, np.asarray(labels, np.int32), np.asarray(input_lengths, np.int32),
            np.asarray(label_lengths, np.int32))


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_loss_matches_jax(rng, case, reduction):
    logits, labels, in_len, lab_len = _ctc_inputs(rng, case)
    ref = JL.ctc_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(in_len),
                      jnp.asarray(lab_len), reduction=reduction)
    ours = TL.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(in_len), torch.from_numpy(lab_len), reduction=reduction)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if case == "input_shorter_than_target":
        assert float(TL.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(in_len), torch.from_numpy(lab_len),
                                 reduction="none")[0]) == 0.0  # zero_infinity


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_gradient_matches_jax(rng, case):
    logits, labels, in_len, lab_len = _ctc_inputs(rng, case)
    ref = jax.grad(lambda x: JL.ctc_loss(x, jnp.asarray(labels), jnp.asarray(in_len),
                                         jnp.asarray(lab_len)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    TL.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(in_len),
                torch.from_numpy(lab_len)).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=0)


def test_ctc_without_zero_infinity_keeps_the_dead_value(rng):
    logits, labels, in_len, lab_len = _ctc_inputs(rng, "input_shorter_than_target")
    args = (labels, in_len, lab_len)
    ref = JL.ctc_loss(jnp.asarray(logits), *(jnp.asarray(a) for a in args),
                      zero_infinity=False, reduction="none")
    ours = TL.ctc_loss(torch.from_numpy(logits), *(torch.from_numpy(a) for a in args),
                       zero_infinity=False, reduction="none")
    assert float(ours[0]) >= 5e29 and float(ref[0]) >= 5e29
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_library_ctc_matches_the_recursion(rng, case):
    """``ctc_native_nll`` (the card's path) against ``ctc_forward_log_probs``:
    per-example NLL and, through ``zero_infinity``, the gradient."""
    logits, labels, in_len, lab_len = _ctc_inputs(rng, case)
    tensors = [torch.from_numpy(a) for a in (labels, in_len, lab_len)]
    grads, values = [], []
    for nll_fn in (TL.ctc_forward_log_probs,
                   lambda *a: TL.ctc_native_nll(*a, zero_infinity=True)):
        x = torch.from_numpy(logits).requires_grad_()
        nll = nll_fn(torch.log_softmax(x, dim=-1), *tensors)
        nll = torch.where(nll >= 5e29, 0.0, nll)
        nll.sum().backward()
        values.append(nll.detach().numpy())
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(values[1], values[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(grads[1], grads[0], atol=2e-5, rtol=0)


CE_CASES = {
    "plain": (0.1, None),
    "no_smoothing": (0.0, None),
    "ignored_positions": (0.1, [(0, 3), (0, 4), (1, 0)]),
    "all_ignored": (0.1, "all"),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_label_smoothed_ce_matches_jax(rng, case, reduction):
    smoothing, ignored = CE_CASES[case]
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3.0
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    if ignored == "all":
        targets[:] = -100
    elif ignored:
        for pos in ignored:
            targets[pos] = -100
    ref_fn = lambda x: JL.label_smoothed_cross_entropy(x, jnp.asarray(targets), smoothing,
                                                       reduction=reduction)
    ours_in = torch.from_numpy(logits).requires_grad_()
    ours = TL.label_smoothed_cross_entropy(ours_in, torch.from_numpy(targets), smoothing,
                                           reduction=reduction)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref_fn(jnp.asarray(logits))),
                               atol=ATOL, rtol=0)
    ours.sum().backward()
    ref_grad = jax.grad(lambda x: jnp.sum(ref_fn(x)))(jnp.asarray(logits))
    np.testing.assert_allclose(ours_in.grad.numpy(), np.asarray(ref_grad), atol=GRAD_ATOL, rtol=0)


def test_ce_agrees_with_torch_cross_entropy(rng):
    logits = torch.from_numpy(rng.standard_normal((3, 6, 9)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 9, (3, 6)))
    targets[0, 2:] = -100
    ref = torch.nn.functional.cross_entropy(logits.reshape(-1, 9), targets.reshape(-1),
                                            ignore_index=-100, label_smoothing=0.1)
    torch.testing.assert_close(TL.label_smoothed_cross_entropy(logits, targets), ref,
                               atol=1e-5, rtol=0)


def test_log_add_dead_branch_has_zero_gradient():
    a = torch.tensor([TL.NEG_INF, TL.NEG_INF, 0.5], requires_grad=True)
    b = torch.tensor([TL.NEG_INF, -1.0, TL.NEG_INF], requires_grad=True)
    out = TL._log_add(a, b)
    assert out.tolist() == pytest.approx([TL.NEG_INF, -1.0, 0.5])
    out.sum().backward()
    assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()
    assert a.grad.tolist() == pytest.approx([0.0, 0.0, 1.0])
    assert b.grad.tolist() == pytest.approx([0.0, 1.0, 0.0])


# -- the CTC wrapper -------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_nll_plain_path_matches_jax_and_its_gradient(rng, case):
    """``ctc_nll`` on CPU tensors (the recursion, differentiated by autograd)
    against the JAX recursion and ``jax.grad`` of it, by the log-probabilities."""
    logits, labels, in_len, lab_len = _ctc_inputs(rng, case)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    jfn = lambda x: JL.ctc_forward_log_probs(x, jnp.asarray(labels), jnp.asarray(in_len),
                                             jnp.asarray(lab_len))
    x = torch.from_numpy(lp).requires_grad_()
    before = TL.launches
    nll = TL.ctc_nll(x, *(torch.from_numpy(a) for a in (labels, in_len, lab_len)))
    nll.sum().backward()
    assert TL.launches == before  # the plain path launches nothing
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jfn(jnp.asarray(lp))),
                               rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(jax.grad(lambda v: jfn(v).sum())(jnp.asarray(lp))),
                               atol=KERNEL_GRAD_ATOL, rtol=0)


def _check_args(**changes):
    args = {"log_probs": torch.zeros((2, 5, 7)), "labels": torch.ones((2, 3), dtype=torch.long),
            "input_lengths": torch.full((2,), 5), "label_lengths": torch.full((2,), 3),
            "blank_id": 0}
    args.update(changes)
    return args


CHECK_CASES = {
    "log_probs_not_3d": (ValueError, {"log_probs": torch.zeros((2, 5))}),
    "log_probs_float64": (TypeError, {"log_probs": torch.zeros((2, 5, 7), dtype=torch.float64)}),
    "log_probs_bf16": (TypeError, {"log_probs": torch.zeros((2, 5, 7), dtype=torch.bfloat16)}),
    "labels_other_batch": (ValueError, {"labels": torch.ones((3, 3), dtype=torch.long)}),
    "labels_float": (TypeError, {"labels": torch.ones((2, 3))}),
    "input_lengths_shape": (ValueError, {"input_lengths": torch.full((2, 1), 5)}),
    "label_lengths_bool": (TypeError, {"label_lengths": torch.ones((2,), dtype=torch.bool)}),
    "not_contiguous": (ValueError, {"log_probs": torch.zeros((2, 7, 5)).transpose(1, 2)}),
    "no_frames": (ValueError, {"log_probs": torch.zeros((2, 0, 7))}),
    "too_many_labels": (ValueError, {"labels": torch.ones((2, TL.MAX_LABELS + 1),
                                                          dtype=torch.long)}),
    "too_many_classes": (ValueError, {"log_probs": torch.zeros((2, 1, TL.MAX_CLASSES + 1))}),
    "blank_outside": (ValueError, {"blank_id": 7}),
    "lengths_elsewhere": (ValueError, {"input_lengths": torch.full((2,), 5, device="meta")}),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_ctc_wrapper_refuses_what_the_kernels_do_not_take(case):
    error, change = CHECK_CASES[case]
    TL._check(**_check_args())  # the reference arguments pass
    with pytest.raises(error):
        TL._check(**_check_args(**change))


def test_ctc_nll_refuses_a_device_other_than_cuda_or_cpu():
    args = _check_args(log_probs=torch.zeros((2, 5, 7), device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TL.ctc_nll(**args)


def test_ctc_launch_counts_leave_out_uncounted_work_and_take_credit():
    """``uncounted`` and ``credit`` as a graph's capture and replays use them:
    launches inside ``uncounted`` are returned and not kept; ``credit``
    adds them back."""
    TL.reset_launches()

    def launch():
        TL._launched("ctc_forward", 0)
        TL._launched("ctc_backward", 0)
        return "out"

    launch()
    out, n, by = TL.uncounted(launch)
    assert (out, n, dict(by)) == ("out", 2, {"ctc_forward": 1, "ctc_backward": 1})
    assert TL.launches == 2 and dict(TL.launches_by_kernel) == {"ctc_forward": 1,
                                                                "ctc_backward": 1}
    TL.credit(n, by)
    assert TL.launches == 4 and TL.launches_by_kernel["ctc_backward"] == 2
    with pytest.raises(RuntimeError, match="does not take"):
        TL._launched("ctc_forward", -1)
    assert TL.launches == 4
    TL.reset_launches()
    assert TL.launches == 0 and not TL.launches_by_kernel


# -- the kernels' algorithm ------------------------------------------------------------

KERNEL_GRAD_ATOL = 1e-5  # occupancies (up to 1) from fp32 sums over 12 frames


def _log_add_np(a, b):
    mx = np.maximum(a, b)
    with np.errstate(over="ignore"):
        out = mx + np.log(np.exp(a - mx) + np.exp(b - mx))
    return np.where(mx <= TL.NEG_INF, np.float32(TL.NEG_INF), out).astype(np.float32)


def _kernel_mirror(lp, labels, in_len, lab_len, blank=0):
    """``csrc/ctc.cu`` in numpy, position by position as its threads run:
    ``ctc_alpha``'s recursion (lengths clamped, frame 0 always taken, alpha
    frozen past the input) and ``ctc_grad``'s betas and occupancies summed
    by class, zero for an infeasible row. Returns the NLL and d NLL.sum() /
    d log_probs."""
    neg = np.float32(TL.NEG_INF)
    b_, t_, _ = lp.shape
    l_ = labels.shape[1]
    s_ = 2 * l_ + 1
    nll = np.zeros((b_,), np.float32)
    grad = np.zeros_like(lp)
    pos = np.arange(s_)
    for b in range(b_):
        n = int(np.clip(lab_len[b], 0, l_))
        frames = int(np.clip(in_len[b], 1, t_))
        valid = pos < 2 * n + 1
        cls = np.full((s_,), blank)
        cls[1::2] = labels[b]
        prev = np.concatenate([[blank, blank, blank], cls[1:-2]])[:s_]
        skip = valid & (pos % 2 == 1) & (cls != prev)
        alpha = np.full((t_, s_), neg, np.float32)
        a = np.full((s_,), neg, np.float32)
        a[0] = lp[b, 0, cls[0]]
        if n > 0:
            a[1] = lp[b, 0, cls[1]]
        alpha[0] = a
        for t in range(1, frames):
            shift1 = np.concatenate([[neg], a[:-1]])
            shift2 = np.where(skip, np.concatenate([[neg, neg], a[:-2]]), neg)
            new = _log_add_np(_log_add_np(a, shift1), shift2) + lp[b, t, cls]
            a = np.where(valid, new, neg).astype(np.float32)
            alpha[t] = a
        end = 2 * n
        nll[b] = -_log_add_np(a[end], a[end - 1] if n > 0 else neg)
        if nll[b] >= TL.INFEASIBLE:
            continue
        beta = np.where(valid & ((pos == end) | ((n > 0) & (pos == end - 1))), 0.0, neg)
        beta = beta.astype(np.float32)
        skip_to = np.concatenate([skip, [False, False]])
        for t in range(frames - 1, -1, -1):
            occ = np.where(valid, np.exp(alpha[t] + beta + nll[b]), 0.0)
            np.add.at(grad[b, t], cls[valid], -occ[valid])
            x = np.concatenate([np.where(valid, beta + lp[b, t, cls], neg), [neg, neg]])
            beta = np.where(valid, _log_add_np(_log_add_np(x[:s_], x[1:s_ + 1]),
                                               np.where(skip_to[2:], x[2:], neg)), neg)
            beta = beta.astype(np.float32)
    return nll, grad


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_kernel_algorithm_matches_the_jax_recursion_and_its_gradient(rng, case):
    """The kernels' algorithm, mirrored in numpy, against the JAX CTC: the
    NLL, and d NLL / d log_probs against ``jax.grad`` of the recursion (the
    reverse scan the kernel replaces). Repeated labels, the blank colliding
    with a label, short inputs and an infeasible row (gradient exactly 0, as
    the JAX recursion's dead guard gives) are among the cases."""
    logits, labels, in_len, lab_len = _ctc_inputs(rng, case)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    jfn = lambda x: JL.ctc_forward_log_probs(x, jnp.asarray(labels), jnp.asarray(in_len),
                                             jnp.asarray(lab_len))
    nll, grad = _kernel_mirror(lp, labels, in_len, lab_len)
    np.testing.assert_allclose(nll, np.asarray(jfn(jnp.asarray(lp))), rtol=1e-6, atol=ATOL)
    want = np.asarray(jax.grad(lambda v: jfn(v).sum())(jnp.asarray(lp)))
    np.testing.assert_allclose(grad, want, atol=KERNEL_GRAD_ATOL, rtol=0)
    for b in np.nonzero(nll >= TL.INFEASIBLE)[0]:
        assert not grad[b].any() and not want[b].any()
