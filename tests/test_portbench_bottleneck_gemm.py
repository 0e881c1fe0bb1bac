"""The benchmark's reading of the ResNet's 1x1 GEMM kernel
(``portbench/metrics/bottleneck_gemm_roofline_pct.py``): its bound at the
train cell's shapes against hand arithmetic, its share over synthetic traced
kernels, None where the program has no such kernel, the kernel's names filed
under GEMM by ``portbench/trace.py``, and its entry in ``BENCHMARK.json``."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.trace import group_of

ROOT = Path(__file__).resolve().parent.parent
GEMM_CU = ROOT / "mocov2_whisper_flamingo_torch" / "csrc" / "bottleneck_gemm.cu"
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELL = "avsr-small.train-b16"
METRIC = "bottleneck_gemm_roofline_pct"
PARAMS = {"batch": 16, "frames": 400, "resize": 64}  # the cell's clips, frames, frame side
# The kernel's three instantiations as the profiler names them.
NAMES = [f"void (anonymous namespace)::bottleneck_gemm_kernel<{n}>(CUtensorMap_st, "
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
         "(anonymous namespace)::Tiles, int, int)" for n in (64, 128, 256)]


def _metric():
    return harness.load_module(harness.PACKAGE, "metrics", METRIC)


def _record(kernels, steps=2, kind="train"):
    return {"kind": kind, "params": dict(PARAMS),
            "trace": {"kernels": kernels, "steps": steps, "window_s": 1.0, "busy_s": 0.9}}


def test_bound_at_the_cell_s_shapes_is_its_hand_arithmetic():
    """6,400 frames of 64 x 64: the stem (stride 2, padding 3) leaves 34,
    the max-pool 17; the stages run at 17, 9, 5 and 3. Per block, (input
    rows, output rows, C_in, mid, C_out, downsample): conv1 moves
    2 (C_in + mid) bytes an input row for 2 C_in mid operations; the output
    path 2 (mid + C_in + C_out) bytes an output row (the block's input read
    at the stride) for 2 mid C_out operations, and 2 C_in C_out more with a
    downsample. Each unit takes the larger of bytes / 3.35e12 and
    operations / 989e12."""
    f = 6400
    blocks = ([(f * 289, f * 289, 64, 64, 256, True)] + 2 * [(f * 289, f * 289, 256, 64, 256, False)]
              + [(f * 289, f * 81, 256, 128, 512, True)] + 3 * [(f * 81, f * 81, 512, 128, 512, False)]
              + [(f * 81, f * 25, 512, 256, 1024, True)] + 5 * [(f * 25, f * 25, 1024, 256, 1024, False)]
              + [(f * 25, f * 9, 1024, 512, 2048, True)] + 2 * [(f * 9, f * 9, 2048, 512, 2048, False)])
    assert len(blocks) == 16
    seconds = 0.0
    for m_in, m_out, c_in, mid, c_out, down in blocks:
        units = [(2 * m_in * (c_in + mid), 2 * m_in * c_in * mid),
                 (2 * m_out * (mid + c_in + c_out),
                  2 * m_out * mid * c_out + (2 * m_out * c_in * c_out if down else 0))]
        seconds += sum(max(b / 3.35e12, ops / 989e12) for b, ops in units)
    got = _metric().bound_ms(16 * 400, 64)
    assert got == pytest.approx(seconds * 1e3, rel=1e-12)
    assert 8.1 < got < 8.3  # ms a step


def test_share_is_the_bound_of_the_traced_steps_over_the_kernel_s_time():
    """Two traced steps of 36 launches, 0.456 ms each (16.42 ms a step):
    the bound of two steps over 32.8 ms, whichever tile width ran."""
    per_step = 36 * 0.456  # ms
    kernels = [(NAMES[i % 3], 10.0 * i, 456.0, [132, 1, 1]) for i in range(72)]
    kernels += [("sm90_xmma_fprop_implicit_gemm", 1e6, 5000.0, [8, 2, 1]),
                ("vectorized_elementwise_kernel", 2e6, 3000.0, [4, 1, 1])]
    metric = _metric()
    got = metric.read(_record(kernels))
    assert got == pytest.approx(100.0 * metric.bound_ms(6400, 64) / per_step, rel=1e-9)
    assert 49.0 < got < 51.0


@pytest.mark.parametrize("case", ["no_kernel", "no_trace", "empty_trace", "serving"])
def test_reads_none_where_the_program_has_no_such_kernel(case):
    """The parent's program (every 1x1 convolution through cuDNN), an
    untraced run, a traced run without kernels and a serving record read
    None, and nothing raises."""
    others = [("sm90_xmma_fprop_implicit_gemm", 0.0, 5000.0, [8, 2, 1]),
              ("nvjet_tst_128x256", 6000.0, 700.0, [8, 2, 1])]
    record = {"no_kernel": _record(others), "empty_trace": _record([]),
              "serving": _record([(NAMES[2], 0.0, 456.0, [132, 1, 1])], kind="serve"),
              "no_trace": {"kind": "train", "params": dict(PARAMS)}}[case]
    assert _metric().read(record) is None


@pytest.mark.parametrize("name", NAMES)
def test_trace_files_the_kernel_under_gemm(name):
    assert group_of(name) == "GEMM"


def test_every_kernel_of_the_source_is_named_for_the_gemm_group():
    """Each ``__global__`` of ``csrc/bottleneck_gemm.cu`` starts with
    ``bottleneck_gemm`` and holds no key of an earlier group (K1, CTC, NCCL,
    cuDNN conv), so the breakdown and the K1 and CTC readers never count it."""
    src = GEMM_CU.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names
    for name in names:
        assert name.startswith("bottleneck_gemm")
        assert not any(k in name.lower() for k in ("attention_fwd", "ctc_", "nccl", "fprop",
                                                   "dgrad", "wgrad", "conv", "cudnn"))
        assert group_of(name) == "GEMM"


def test_benchmark_entry_is_the_frozen_video_layer_s_share_of_the_train_cell():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == METRIC)
    video = next(m for m in BENCH["per_layer"] if m["name"] == "frozen_video_ms")
    assert BENCH["per_layer"][-1] is entry
    assert entry == {"name": METRIC, "unit": "%", "better": "higher", "source": "device_trace",
                     "layer": video["layer"], "moves": "train_clips_per_s", "workloads": [CELL]}
