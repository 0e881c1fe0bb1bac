"""Share of the traced stretch in which no kernel, copy or fill ran on the
device (the union of their intervals in the trace)."""

from portbench.readers import idle_pct


def read(record):
    return idle_pct(record)
