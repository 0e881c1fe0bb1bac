"""The served requests' model operations (each answered one in the traced
stretch counts its encode and every beam row's decode steps over its token
budget; ``arithmetic.request_flops``), as a share of the bf16 peak over
the stretch's seconds."""

from portbench import arithmetic as A
from portbench.readers import mfu_pct, trace


def read(record):
    t = trace(record)
    if record["kind"] != "serve" or not t or not t.get("requests_done"):
        return None
    cfg, p = record["config"], record["params"]
    per_request = A.request_flops(cfg, p["frames"], p["resize"], p["beam"], p["max_tokens"])
    return mfu_pct(t["requests_done"] * per_request, t["window_s"])
