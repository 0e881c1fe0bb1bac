"""The update: the global losses, the guard, the clip and AdamW (``AVSRTask.train_step``,
span ``optimizer``): device ms per traced
step, from its open to its close marker (``portbench/spans.py``)."""

from portbench.spans import phase_ms


def read(record):
    return phase_ms(record, "optimizer")
