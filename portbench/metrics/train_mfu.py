"""The train step's model operations (frozen forward, trainable forward and
backward; ``arithmetic.train_step_flops``) over the traced steps, as a
share of the bf16 peak over the traced stretch's seconds."""

from portbench import arithmetic as A
from portbench.readers import mfu_pct, trace


def read(record):
    t = trace(record)
    if record["kind"] != "train" or not t:
        return None
    cfg, p = record["config"], record["params"]
    flops = A.train_step_flops(cfg, p["batch"], p["frames"], p["resize"]) * t["steps"]
    return mfu_pct(flops, t["window_s"])
