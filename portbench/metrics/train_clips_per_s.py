"""Clips trained per second: every clip of every step run in the window,
over the window's seconds (host clock between two synchronisations)."""


def read(record):
    return record["clips"] / record["window_s"] if record["kind"] == "train" else None
