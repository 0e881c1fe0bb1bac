"""The CTC kernel pair's share of its roofline: the dense ``[B, T, V]`` fp32
gradient written once (``arithmetic.ctc_bound_ms``) for each traced step,
over the ``ctc_alpha`` and ``ctc_grad`` kernel time."""

from portbench import arithmetic as A
from portbench.readers import kernel_ms, trace


def read(record):
    t = trace(record)
    spent = kernel_ms(record, ("ctc_alpha", "ctc_grad"))
    if record["kind"] != "train" or not t or spent <= 0:
        return None
    cfg, p = record["config"], record["params"]
    frames = min(p["frames"], cfg["mel_frames"] // 2)
    return 100.0 * A.ctc_bound_ms(p["batch"], frames, cfg["vocab_size"]) * t["steps"] / spent
