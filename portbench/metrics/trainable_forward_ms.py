"""The trainable forward: projections, fusion (K1), head and the logits' cast
(``AVNet.forward``, span ``trainable_forward``): device ms per traced
step, from its open to its close marker (``portbench/spans.py``)."""

from portbench.spans import phase_ms


def read(record):
    return phase_ms(record, "trainable_forward")
