"""Seconds of audio served per second: 30 s for each request answered
inside the window, over the window's seconds."""

from portbench.readers import completed_in_window


def read(record):
    if record["kind"] != "serve":
        return None
    return len(completed_in_window(record)) * record["audio_s"] / record["window_s"]
