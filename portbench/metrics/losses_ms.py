"""The losses: log-softmax, the CTC pair, the CE and the counts (``AVSRTask.losses_of``,
span ``losses``): device ms per traced
step, from its open to its close marker (``portbench/spans.py``)."""

from portbench.spans import phase_ms


def read(record):
    return phase_ms(record, "losses")
