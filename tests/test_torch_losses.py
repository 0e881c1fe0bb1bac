"""The port's training losses against the JAX package on the CPU: values and
input gradients from the same numpy inputs, and the library CTC call (which
the port takes for CUDA tensors) against the port's own recursion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import losses as TL
from mocov2_whisper_flamingo_tpu.ops import losses as JL

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
