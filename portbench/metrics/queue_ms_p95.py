"""95th percentile of the engine's ``queue_ms`` (submission to admission)
over the answered requests due in the window."""

from portbench.readers import engine_ms


def read(record):
    return engine_ms(record, "queue_ms", 95) if record["kind"] == "serve" else None
