"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each a worst case over what a run produced.

Training (the first updates of the timed train step):

- ``loss_gap``: ``|program - reference| / |reference|`` of the first step's
  loss, the forward at the seed's weights. The later steps' losses swing
  with AdamW's first updates, which move every element by about the
  learning rate whatever its gradient, so a gradient within round-off of
  zero moves either way (their gap is kept as a note, ``_loss_gap_steps``);
- ``grad_gap``: over the trainable leaves of more than one element, the
  largest gap between the norm of the program's first gradient (as the
  optimizer took it, after the clip) and the reference's, over the larger
  of the reference leaf's norm and the median leaf's;
- ``delta_gap``: the same of each leaf's change over the first steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (an attention key's bias under softmax): Adam moves those
  by round-off alone (listed as a note, ``_excluded``);
- ``grad_diff``: the median leaf's norm of the difference of the two first
  gradients, over the same norm: a gap of norms is second order in random
  round-off, which mostly turns a leaf's gradient rather than lengthening
  it, so the gaps above read a lower precision only a few times higher than
  the program; the difference reads it at first order;
- ``gate_grad_gap``: ``grad_gap`` over the one-element leaves (the fusion's
  tanh gates), the median taken over them. A gate's gradient is one sum of
  millions of bfloat16 products that mostly cancel, so its round-off swings
  from seed to seed far more than a wide leaf's; held in ``grad_gap`` it
  would set that number's limit for every leaf. Their change is not
  compared (a note, ``_gate_delta_gap``): a gate whose gradient is near
  nought moves by about the learning rate at each AdamW step, on the sign
  of its round-off.

Serving (beam search): a served hypothesis's token at each position was
one of the ``2K`` best continuations of its own prefix (the first stage of
each beam step keeps the ``2K`` best tokens of every beam, and the
hypothesis's prefix is that beam). ``token_gap`` is the largest amount by
which a served token's reference logit lies below the reference's
``2K``-th best logit at its position, teacher-forced over the served
tokens; 0 where every served token is among the reference's ``2K`` best.
The control, a lower precision in the program's place, is read by the same
function over the tokens that it puts first at each position of the same
prompts and served prefixes (``control_tokens``).
"""

from __future__ import annotations

import statistics

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def _norms(tensors: dict) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _leaf_gaps(program: dict, reference: dict, names, diff: bool = False) -> dict[str, float]:
    """Each leaf's gap of norms (``diff``: the norm of the difference) over
    the larger of its reference norm and the median leaf's."""
    p = _norms({n: program[n] - reference[n] if diff else program[n] for n in names})
    r = _norms({n: reference[n] for n in names})
    median = statistics.median(r.values()) if r else 0.0
    return {n: (p[n] if diff else abs(p[n] - r[n])) / max(r[n], median, 1e-30) for n in names}


def _worst(gaps: dict) -> tuple[float, str | None]:
    worst = max(gaps, key=gaps.get, default=None)
    return (gaps[worst], worst) if worst is not None else (0.0, None)


def train_numbers(program: dict, reference: dict) -> dict:
    """``program`` / ``reference``: ``losses`` (a float a step),
    ``first_grad`` and ``change`` (name -> tensor, the same names)."""
    steps = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    names = sorted(reference["first_grad"])
    wide = [n for n in names if reference["first_grad"][n].numel() > 1]
    gates = [n for n in names if n not in wide]
    g = _norms(reference["first_grad"])
    median = statistics.median(g.values())
    kept = [n for n in names if g[n] >= EXCLUDE_BELOW * median]
    pg, rg = program["first_grad"], reference["first_grad"]
    grad = _worst(_leaf_gaps(pg, rg, wide))
    delta = _worst(_leaf_gaps(program["change"], reference["change"],
                              [n for n in kept if n in wide]))
    gate_grad = _worst(_leaf_gaps(pg, rg, gates))
    gate_delta = _worst(_leaf_gaps(program["change"], reference["change"],
                                   [n for n in kept if n in gates]))
    return {"loss_gap": steps[0], "grad_gap": grad[0], "delta_gap": delta[0],
            "grad_diff": statistics.median(_leaf_gaps(pg, rg, wide, diff=True).values()),
            "gate_grad_gap": gate_grad[0],
            "_grad_leaf": grad[1], "_delta_leaf": delta[1], "_gate_grad_leaf": gate_grad[1],
            "_gate_delta_gap": gate_delta[0], "_gate_delta_leaf": gate_delta[1],
            "_loss_gap_steps": steps, "_excluded": [n for n in names if n not in kept]}


def token_gap(logits: torch.Tensor, tokens: torch.Tensor, first: int, k: int) -> float:
    """``logits [L, V]`` teacher-forced over ``tokens [L + 1]`` (position i
    scores token i + 1); positions from ``first`` on."""
    lg = logits[first:].float()
    served = lg.gather(1, tokens[first + 1:, None].long())[:, 0]
    kth = lg.topk(k, dim=-1).values[:, -1]
    return float(torch.clamp(kth - served, min=0).max()) if lg.shape[0] else 0.0


def worst_rank(logits: torch.Tensor, tokens: torch.Tensor, first: int) -> int:
    """The worst rank (1 = best) of a served token among its position's
    reference logits, positions from ``first`` on."""
    lg = logits[first:].float()
    if not lg.shape[0]:
        return 0
    served = lg.gather(1, tokens[first + 1:, None].long())
    return int((lg > served).sum(-1).max()) + 1


def control_tokens(control: torch.Tensor, tokens: torch.Tensor, first: int) -> torch.Tensor:
    """``tokens [L + 1]`` with each position from ``first`` on replaced by
    the token that ``control [L, V]`` (logits teacher-forced over
    ``tokens``) puts first there: what the control would serve after each
    served prefix, for ``token_gap`` to read."""
    out = tokens.clone()
    out[first + 1:] = control[first:].float().argmax(-1).to(out.dtype)
    return out
