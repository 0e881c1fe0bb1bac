"""Median of the engine's ``decode_ms`` (admission to retirement: the
segment loop and its decode steps) over the answered requests due in the
window."""

from portbench.readers import engine_ms


def read(record):
    return engine_ms(record, "decode_ms", 50) if record["kind"] == "serve" else None
