"""K1's share of its roofline: the least time of each launch at its shape
(``arithmetic.attention_bound_ms``), summed, over K1's kernel time in the
traced stretch."""

from portbench.readers import k1_kinds, k1_roofline_pct


def read(record):
    return k1_roofline_pct(record, k1_kinds(record))
