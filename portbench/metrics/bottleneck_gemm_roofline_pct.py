"""The frozen ResNet-50's 1x1 GEMM kernel (``bottleneck_gemm``) against the
least time of the work it does, whatever does it: the traced steps' frames
through each bottleneck block's two 1x1 units, over the kernel's time.

A block's units are ``conv1`` (its input read, its output written) and the
output path (``conv3``'s input read, the block's input read at the block's
stride for the downsample or the identity, the block's output written; no
downsample output in between). Each unit takes the larger of its bytes at the
HBM rate and its operations at the bf16 peak. At the train cell (6,400 frames
of 64 x 64 a step) that is 26.1 GB and 3.35 TFLOP, 8.2 ms a step. A program
without the kernel reads None."""

from portbench import arithmetic as A
from portbench.readers import kernel_ms, trace


def bound_ms(frames: int, size: int) -> float:
    """The least time of the 1x1 units over ``frames`` frames of ``size`` x
    ``size`` (bf16: 2 bytes an element)."""
    hw = A._conv_out(A._conv_out(size, 3, 2, 3), 3, 2, 1)  # the stem, the max-pool
    total, c_in = 0.0, 64
    for blocks, mid, stride in A.RESNET50_STAGES:
        for i in range(blocks):
            s = stride if i == 0 else 1
            out_hw = A._conv_out(hw, 3, s, 1)
            c_out = mid * A.EXPANSION
            m_in, m_out = frames * hw * hw, frames * out_hw * out_hw
            units = [(2 * m_in * (c_in + mid), 2 * m_in * c_in * mid)]
            flops = 2 * m_out * mid * c_out
            if s != 1 or c_in != c_out:
                flops += 2 * m_out * c_in * c_out
            units.append((2 * m_out * (mid + c_in + c_out), flops))
            total += sum(max(b / A.HBM_BYTES_PER_S, f / A.PEAK_BF16_FLOPS) for b, f in units)
            c_in, hw = c_out, out_hw
    return total * 1e3


def read(record):
    t = trace(record)
    spent = kernel_ms(record, ("bottleneck_gemm",))
    if record["kind"] != "train" or not t or spent <= 0:
        return None
    p = record["params"]
    return 100.0 * bound_ms(p["batch"] * p["frames"], p["resize"]) * t["steps"] / spent
