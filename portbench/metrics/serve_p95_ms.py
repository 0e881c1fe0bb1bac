"""95th percentile of the time from when a request was due to its answer,
over every request due inside the window; a miss counts above every
answer."""

from portbench.readers import latency_p95_ms


def read(record):
    return latency_p95_ms(record) if record["kind"] == "serve" else None
