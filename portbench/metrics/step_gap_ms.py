"""Between two train steps: device ms from one step's ``train_step`` close
marker to the next one's open marker (the batch's copies, the graph's
launch, the host; ``portbench/spans.py``)."""

from portbench.spans import step_gap_ms


def read(record):
    return step_gap_ms(record)
