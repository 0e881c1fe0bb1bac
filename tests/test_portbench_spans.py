"""The benchmark's reading of the train step's span markers
(``portbench/spans.py`` and its seven readers under ``portbench/metrics/``)
over synthetic traced stretches: two whole steps between a step cut at each
edge of the stretch, which is left out; the phases, ``train_step``'s self
time and the gaps summing to the stretch; a trace without markers reading
None; and every marker of ``csrc/spans.cu`` falling outside the benchmark's
kernel groups and the K1 and CTC readers."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from portbench import harness, readers, spans
from portbench.trace import group_of

ROOT = Path(__file__).resolve().parent.parent
SPANS_CU = ROOT / "mocov2_whisper_flamingo_torch" / "csrc" / "spans.cu"
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELL = "avsr-small.train-b16"
READERS = {f"{phase}_ms": phase for phase in spans.PHASES}
METRICS = (*READERS, "step_gap_ms")

MARK_US = 2.0  # a marker's own device time
# Each phase's kernels in a whole step: (group's kernel name, device us), run back to back.
WORK = {
    "frozen_audio": [("ampere_bf16_gemm_128x64", 300.0), ("vectorized_elementwise_kernel", 40.0)],
    "frozen_video": [("sm90_xmma_fprop_implicit_gemm", 500.0), ("elementwise_kernel", 80.0)],
    "trainable_forward": [("attention_fwd_wgmma<64, 2, true, false>", 20.0)],
    "losses": [("softmax_warp_forward", 30.0), ("ctc_alpha", 10.0)],
    "backward": [("ctc_grad", 15.0), ("nvjet_tst_128x256", 120.0)],
    "optimizer": [("multi_tensor_apply_kernel", 25.0)],
}
IDLE_US = 1.0  # device idle after each kernel inside a phase
SELF_US = 5.0  # work of train_step outside its phases (e.g. augmentation), before the first
GAP_US = 60.0  # from a step's close marker's end to the next step's open marker


def _step(t0: float) -> tuple[list, float, dict]:
    """One whole step's kernels from ``t0`` (us): ``(kernels, end, each
    phase's us from its open marker's start to its close marker's end)``."""
    out, t = [("span_open_train_step", t0, MARK_US, [1, 1, 1])], t0 + MARK_US
    out.append(("vectorized_elementwise_kernel", t, SELF_US, [4, 1, 1]))
    t += SELF_US
    phase_us = {}
    for phase, work in WORK.items():
        start = t
        out.append((f"span_open_{phase}", t, MARK_US, [1, 1, 1]))
        t += MARK_US
        for name, dur in work:
            out.append((name, t, dur, [8, 2, 1]))
            t += dur + IDLE_US
        out.append((f"span_close_{phase}", t, MARK_US, [1, 1, 1]))
        t += MARK_US
        phase_us[phase] = t - start
    out.append(("span_close_train_step", t, MARK_US, [1, 1, 1]))
    return out, t + MARK_US, phase_us


def _stretch() -> tuple[dict, dict]:
    """A traced stretch: the tail of a step (from its ``losses`` on), two
    whole steps, the head of a step (up to its ``frozen_video``). Returns
    the record and what the whole steps should read."""
    whole = []
    first, _, _ = _step(0.0)
    cut = [k for k in first if k[1] >= next(k[1] for k in first if k[0] == "span_open_losses")]
    t = cut[-1][1] + cut[-1][2] + GAP_US
    for _ in range(2):
        kernels, end, phase_us = _step(t)
        whole.append((t, end))
        t = end + GAP_US
        cut += kernels
    head, _, _ = _step(t)
    stop = next(k[1] for k in head if k[0] == "span_close_frozen_video")
    kernels = cut + [k for k in head if k[1] <= stop]
    kernels = sorted(kernels, key=lambda k: -k[1])  # a trace's events come in no set order
    expect = {"steps": whole, "phase_us": phase_us}
    return {"kind": "train", "trace": {"kernels": kernels, "window_s": t * 1e-6, "steps": 4,
                                       "busy_s": 0.0}}, expect


def _reader(metric: str):
    return harness.load_module(harness.PACKAGE, "metrics", metric).read


def test_only_whole_steps_count():
    record, expect = _stretch()
    done = spans.steps(record)
    assert [(s["start"], s["end"]) for s in done] == expect["steps"]
    assert all(sorted(s["phases"]) == sorted(spans.PHASES) for s in done)
    assert all(len(ivs) == 1 for s in done for ivs in s["phases"].values())


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_reads_its_phase_per_whole_step(metric):
    record, expect = _stretch()
    want = (GAP_US if metric == "step_gap_ms" else expect["phase_us"][READERS[metric]]) * 1e-3
    assert _reader(metric)(record) == pytest.approx(want, rel=1e-12)


def test_phases_self_time_and_gaps_sum_to_the_stretch_of_whole_steps():
    record, expect = _stretch()
    split = spans.split(record)
    n = split["steps"]
    assert n == 2
    phases = sum(p["ms"] for p in split["phases"].values())
    assert split["self_ms"] == pytest.approx((2 * MARK_US + SELF_US) * 1e-3, rel=1e-9)
    assert phases + split["self_ms"] == pytest.approx(split["step_ms"], rel=1e-12)
    (first, _), (_, last) = expect["steps"]
    assert n * split["step_ms"] + (n - 1) * split["gap_ms"] == pytest.approx(
        (last - first) * 1e-3, rel=1e-12)
    assert split["markers_ms"] == pytest.approx(14 * MARK_US * 1e-3, rel=1e-12)


def test_split_names_each_phase_s_kernel_groups_and_busy_share():
    record, _ = _stretch()
    phases = spans.split(record)["phases"]
    assert list(phases) == list(spans.PHASES)
    video = phases["frozen_video"]
    assert video["groups"] == pytest.approx({"cuDNN conv": 0.5, "elementwise": 0.08,
                                             "other": 2 * MARK_US * 1e-3})
    busy = 2 * MARK_US + 500.0 + 80.0
    assert video["busy_pct"] == pytest.approx(100.0 * busy / (busy + 2 * IDLE_US))
    assert set(phases["losses"]["groups"]) == {"reduce", "ctc", "other"}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("trace", ["unmarked", "none", "cut_only"])
def test_a_trace_without_whole_marked_steps_reads_none(metric, trace):
    record, _ = _stretch()
    kernels = record["trace"]["kernels"]
    if trace == "unmarked":  # a program without markers
        record["trace"]["kernels"] = [k for k in kernels if not k[0].startswith("span_")]
    elif trace == "none":  # an untraced run
        record["trace"] = None
    else:  # one step's open marker only: no step is whole
        record["trace"]["kernels"] = [k for k in kernels if k[0] != "span_close_train_step"]
    assert _reader(metric)(record) is None


def test_one_whole_step_has_phases_but_no_gap():
    kernels, _, phase_us = _step(10.0)
    record = {"trace": {"kernels": kernels}}
    assert _reader("losses_ms")(record) == pytest.approx(phase_us["losses"] * 1e-3)
    assert _reader("step_gap_ms")(record) is None


def _markers() -> list[str]:
    """The marker kernels' names as ``csrc/spans.cu`` defines them."""
    text = SPANS_CU.read_text()
    block = text[text.index("#define SPAN_MARKERS(X)"):text.index("#define DEFINE_MARKERS")]
    names = re.findall(r"X\((\w+)\)", block)
    return [f"{edge}{name}" for name in names for edge in (spans.OPEN, spans.CLOSE)]


def test_the_program_s_markers_are_the_spans_the_benchmark_reads():
    assert _markers()[::2] == [spans.OPEN + s for s in (spans.STEP, *spans.PHASES)]
    assert "extern \"C\" __global__ void span_open_##name" in SPANS_CU.read_text()


@pytest.mark.parametrize("name", _markers())
def test_each_marker_is_in_no_kernel_group_and_no_k1_or_ctc_reading(name):
    assert group_of(name) == "other"
    assert not readers.K1_TEMPLATE.search(name)
    record = {"trace": {"kernels": [(name, 0.0, MARK_US, [1, 1, 1])]}}
    assert readers.kernel_ms(record, ("attention_fwd",)) == 0.0
    assert readers.kernel_ms(record, ("ctc_alpha", "ctc_grad")) == 0.0
    assert readers.k1_roofline_pct(record, {}) is None


@pytest.mark.parametrize("metric", METRICS)
def test_each_metric_is_a_device_trace_ms_of_the_train_cell(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    assert (entry["unit"], entry["better"], entry["source"]) == ("ms", "lower", "device_trace")
    assert entry["moves"] == "train_clips_per_s" and entry["workloads"] == [CELL]
    assert metric in [m["name"] for m in harness.metric_entries(BENCH, CELL, traced=True)]
    assert not [m for m in harness.metric_entries(BENCH, CELL, traced=False)
                if m["name"] == metric]
