"""Word error rate (the reference uses jiwer at train.py:195,213; jiwer is
not in this environment, so WER is computed with a standard Levenshtein DP
over words — identical definition: (S + D + I) / N_ref)."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[m])


def wer(references: str | Iterable[str], hypotheses: str | Iterable[str]) -> float:
    """Corpus-level WER: total edits / total reference words (jiwer
    semantics for list inputs)."""
    if isinstance(references, str):
        references = [references]
    if isinstance(hypotheses, str):
        hypotheses = [hypotheses]
    refs = [r.split() for r in references]
    hyps = [h.split() for h in hypotheses]
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references vs {len(hyps)} hypotheses")
    edits = sum(_edit_distance(r, h) for r, h in zip(refs, hyps))
    total = sum(len(r) for r in refs)
    if total == 0:
        return 0.0 if edits == 0 else 1.0
    return edits / total
