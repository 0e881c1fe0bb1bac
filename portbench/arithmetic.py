"""The benchmark's yardstick arithmetic: the chip's peaks, the operations of
the model's steps counted from their shapes, the rooflines of the port's
hand-written kernels, percentiles, spreads and the union of intervals.

Nothing here reads the program: every count is worked out from the sizes in
a configuration file, so a change to the program cannot move it.
"""

from __future__ import annotations

import math
import statistics

# NVIDIA H100 SXM data sheet, dense rates (the card's power limit is printed
# beside every run, since a card set below 700 W reaches less).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# ResNet-50 body (torchvision's stage spec): (blocks, mid channels, stride),
# bottleneck expansion 4; the MoCo stem sees 5 neighbouring frames.
RESNET50_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
EXPANSION = 4
STEM_DEPTH = 5
FRONTEND_OUT = 2048


# -- attention (K1) ----------------------------------------------------------------

def attention_flops(b, tq, tk, h, d, causal: bool = False) -> int:
    """4*B*H*Dh operations for every (query, key) pair the function needs:
    all Tq*Tk of them, or under the causal mask (offset Tk - Tq) the pairs
    with key <= query + Tk - Tq.

    Copied from ``chip_smoke.py::attention_flops``."""
    pairs = tq * tk
    if causal:
        pairs = sum(min(max(row + tk - tq + 1, 0), tk) for row in range(tq))
    return 4 * b * h * pairs * d


def attention_bound_ms(b, tq, tk, h, d, elt_bytes: int, masked: bool,
                       causal: bool = False) -> tuple[float, str]:
    """Least time for one K1 call: q, k, v read once and o written once
    (plus the [B, Tk] mask bytes), against the operations of
    ``attention_flops`` at the bf16 peak. Returns (ms, 'bytes' |
    'operations').

    Copied from ``chip_smoke.py::attention_bound_ms`` (there keyed by a torch
    dtype; here by its element size, bf16 on every path the cells drive)."""
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * elt_bytes + (b * tk if masked else 0)
    flops = attention_flops(b, tq, tk, h, d, causal)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# -- CTC ---------------------------------------------------------------------------

def ctc_bound_ms(b: int, t: int, v: int) -> float:
    """Least time for the CTC kernel pair (forward and backward): the dense
    ``[B, T, V]`` fp32 gradient by the log-probabilities written once at the
    HBM rate. The forward reads only the label columns, which this leaves
    out. 332 MB and 0.0992 ms at ``[4, 400, 51865]``.

    The same bound as the CTC pair's in ``PERF.md`` (Findings)."""
    return b * t * v * 4 / HBM_BYTES_PER_S * 1e3


# -- operations of the model ------------------------------------------------------------

def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def resnet_frontend_flops(frames: int, size: int) -> int:
    """The MoCo frontend's convolutions over ``frames`` frames of
    ``size`` x ``size``: the 5-frame stem (3x3, stride 2, padding 3), the
    3x3/2 max-pool, the ResNet-50 body; 2 operations a multiply-add."""
    hw = _conv_out(size, 3, 2, 3)
    flops = 2 * frames * hw * hw * 64 * STEM_DEPTH * 3 * 9
    hw = _conv_out(hw, 3, 2, 1)
    c_in = 64
    for blocks, mid, stride in RESNET50_STAGES:
        for i in range(blocks):
            s = stride if i == 0 else 1
            out_hw = _conv_out(hw, 3, s, 1)
            c_out = mid * EXPANSION
            flops += 2 * frames * hw * hw * c_in * mid                 # 1x1
            flops += 2 * frames * out_hw * out_hw * mid * mid * 9      # 3x3, stride s
            flops += 2 * frames * out_hw * out_hw * mid * c_out        # 1x1
            if s != 1 or c_in != c_out:
                flops += 2 * frames * out_hw * out_hw * c_in * c_out   # downsample
            c_in, hw = c_out, out_hw
    return flops


def whisper_encoder_flops(w: dict, clips: int, mel_frames: int = 3000) -> int:
    """Convolutions and layers of the Whisper encoder over ``clips`` clips."""
    d, h = w["d_model"], w["n_heads"]
    t = mel_frames // 2
    flops = 2 * clips * mel_frames * w["n_mels"] * 3 * d + 2 * clips * t * d * 3 * d
    per_layer = 2 * clips * t * (4 * d * d + 2 * d * w["d_ff"])
    per_layer += attention_flops(clips, t, t, h, d // h)
    return flops + w["encoder_layers"] * per_layer


def trunk_trainable_flops(cfg: dict, clips: int, frames: int, with_head: bool) -> int:
    """The trainable trunk's forward: the two stream projections, the gated
    fusion (each block a cross-attention and a 4x feed-forward), and with
    ``with_head`` the frame-wise vocabulary head."""
    m, w = cfg["model"], cfg["whisper"]
    d, heads = m["d_model"], m["n_heads"]
    t_audio = cfg["mel_frames"] // 2
    t = min(frames, t_audio)
    tok = clips * t
    # the audio stream is projected over all its frames, then cut to the video's
    flops = 2 * clips * t_audio * w["d_model"] * d + 2 * tok * (FRONTEND_OUT * d + 2 * d * d)
    blocks = max(m["n_layers"] // 2, 1)
    flops += blocks * (2 * tok * (4 * d * d + 8 * d * d) + attention_flops(clips, t, t, heads,
                                                                          d // heads))
    if with_head:
        flops += 2 * tok * d * cfg["vocab_size"]
    return flops


def train_step_flops(cfg: dict, clips: int, frames: int, size: int) -> int:
    """Model operations of one train step: the frozen Whisper encoder and
    MoCo frontend forward, and the trainable part's forward and backward,
    counted as three forwards."""
    frozen = whisper_encoder_flops(cfg["whisper"], clips, cfg["mel_frames"])
    frozen += resnet_frontend_flops(clips * frames, size)
    return frozen + 3 * trunk_trainable_flops(cfg, clips, frames, with_head=True)


def encode_flops(cfg: dict, frames: int, size: int) -> int:
    """One clip's admission encode: the frozen encoders, the trunk without
    its head, the bridge to the decoder's width, and every decoder layer's
    cross-attention keys and values."""
    w = cfg["whisper"]
    t = min(frames, cfg["mel_frames"] // 2)
    flops = whisper_encoder_flops(w, 1, cfg["mel_frames"]) + resnet_frontend_flops(frames, size)
    flops += trunk_trainable_flops(cfg, 1, frames, with_head=False)
    flops += 2 * t * cfg["model"]["d_model"] * w["d_model"]
    return flops + w["decoder_layers"] * 2 * (2 * t * w["d_model"] * w["d_model"])


def decode_step_flops(cfg: dict, position: int, enc_len: int) -> int:
    """One beam row's decode step at ``position``: every layer's projections,
    self-attention over the ``position + 1`` cached keys, cross-attention
    over ``enc_len`` keys and feed-forward, then the tied vocabulary
    projection."""
    w = cfg["whisper"]
    d, h = w["d_model"], w["n_heads"]
    per_layer = 2 * (6 * d * d + 2 * d * w["d_ff"])
    per_layer += attention_flops(1, 1, position + 1, h, d // h)
    per_layer += attention_flops(1, 1, enc_len, h, d // h)
    return w["decoder_layers"] * per_layer + 2 * d * cfg["vocab_size"]


def request_flops(cfg: dict, frames: int, size: int, beam: int, max_len: int) -> int:
    """Model operations of one served request: its encode, then each of its
    ``beam`` rows through every position of the token budget."""
    enc_len = min(frames, cfg["mel_frames"] // 2)
    decode = sum(decode_step_flops(cfg, p, enc_len) for p in range(max_len))
    return encode_flops(cfg, frames, size) + beam * decode


# -- statistics --------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` % of
    the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def quartile_spread(values) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(intervals) -> list[tuple[float, float]]:
    """The uncovered stretches between the merged ``(start, end)`` intervals."""
    out, cur_end = [], None
    for start, end in sorted(intervals):
        if cur_end is not None and start > cur_end:
            out.append((cur_end, start))
        cur_end = end if cur_end is None else max(cur_end, end)
    return out
