"""The trainable part's backward and the zeros of unused gradients
(``AVSRTask.train_step``, span ``backward``): device ms per traced
step, from its open to its close marker (``portbench/spans.py``)."""

from portbench.spans import phase_ms


def read(record):
    return phase_ms(record, "backward")
