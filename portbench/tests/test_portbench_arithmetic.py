"""The yardstick's arithmetic against hand counts and independent counts:
the K1 and CTC bounds as PERF.md recorded them, the operation counters
against ``torch.utils.flop_counter`` over the plain reference, percentiles,
spreads, intervals, and the window arithmetic of the metric readers (a
stall inside the window moves the rate and the tail)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arithmetic as A
from portbench import readers
from portbench.reference import model as M
from portbench.reference import spec
from portbench.serving import Request
from portbench.tests import tiny
from portbench.weights import as_dict


def test_k1_bound_at_the_encoder_shape():
    ms, kind = A.attention_bound_ms(4, 1500, 1500, 12, 64, 2, masked=False)
    assert kind == "operations"
    assert abs(ms - 0.0280) < 5e-5  # PERF.md section 6: 0.0280 ms at [4,1500,1500,12,64]
    assert A.attention_flops(4, 1500, 1500, 12, 64) == 4 * 4 * 12 * 1500 * 1500 * 64
    # causal: pairs with key <= query + Tk - Tq
    assert A.attention_flops(1, 3, 3, 1, 1, causal=True) == 4 * (1 + 2 + 3)
    assert A.attention_flops(1, 2, 4, 1, 1, causal=True) == 4 * (3 + 4)
    ms_masked, _ = A.attention_bound_ms(1, 1, 4096, 1, 64, 2, masked=True)
    assert abs(ms_masked - ((2 * 64 + 2 * 4096 * 64) * 2 + 4096) / 3.35e12 * 1e3) < 1e-12


def test_ctc_bound_at_the_recorded_shape():
    assert 4 * 400 * 51865 * 4 == 331_936_000  # the 332 MB dense fp32 gradient
    assert abs(A.ctc_bound_ms(4, 400, 51865) - 0.0992) < 2e-4  # PERF.md section 6


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_encoder_and_frontend_counts_match_an_independent_count():
    cfg = {"whisper": tiny.TINY_WHISPER, "model": tiny.TINY_MODEL, "vocab_size": 51865,
           "mel_frames": 3000}
    W = as_dict(spec.trunk_parameters(cfg), 3, "cpu")
    mel = torch.zeros(1, 3000, 80)
    assert _counted(lambda: M.whisper_encoder(M.FP32, W, tiny.TINY_WHISPER, mel)) == \
        A.whisper_encoder_flops(tiny.TINY_WHISPER, 1)
    # by hand: conv1 + conv2 + one layer's projections + its attention
    assert A.whisper_encoder_flops(tiny.TINY_WHISPER, 1) == \
        92_160_000 + 36_864_000 + 98_304_000 + 576_000_000
    video = torch.zeros(1, 2, 3, 64, 64)
    assert _counted(lambda: M.frontend(M.FP32, W, video, torch.tensor([2]))) == \
        A.resnet_frontend_flops(2, 64)


def test_decode_step_count_by_hand():
    cfg = {"whisper": tiny.TINY_WHISPER, "vocab_size": 51865}
    per_layer = 2 * (6 * 64 * 64 + 2 * 64 * 128) + 4 * 2 * 1 * 32 + 4 * 2 * 8 * 32
    assert A.decode_step_flops(cfg, 0, 8) == per_layer + 2 * 64 * 51865


def test_percentiles_spreads_and_intervals():
    assert A.percentile(range(1, 101), 95) == 95
    assert A.percentile([7.0], 95) == 7.0
    assert A.percentile([1, 2, 3, 4], 50) == 2
    assert abs(A.quartile_spread([10, 10, 10, 10, 10, 10]) - 0.0) < 1e-12
    assert A.quartile_spread([9, 10, 10, 10, 10, 11]) > 0
    assert A.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert A.gaps([(0, 2), (1, 3), (5, 6)]) == [(3, 5)]


def _serve_record(stall_at: float | None = None, stall_s: float = 0.0) -> dict:
    """Requests due every 0.1 s over a 10 s window, each answered 0.5 s
    after it was due, or, with a stall, none answered from ``stall_at`` until
    the stall ends (then each at its own time or at the stall's end)."""
    reqs = []
    for i in range(100):
        due = 0.1 * (i + 1)
        done = due + 0.5
        if stall_at is not None and stall_at <= done < stall_at + stall_s:
            done = stall_at + stall_s
        reqs.append(Request(clip=0, due=due, done=done, ok=True, queue_ms=1.0, decode_ms=400.0))
    return {"kind": "serve", "window": (0.0, 10.0), "window_s": 10.0, "requests": reqs,
            "audio_s": 30.0}


def test_a_stall_moves_the_rate_and_the_tail():
    rec = _serve_record
    steady, stalled = rec(), rec(stall_at=4.0, stall_s=2.0)
    assert abs(readers.latency_p95_ms(steady) - 500.0) < 1e-6
    assert readers.latency_p95_ms(stalled) > 1500.0
    rate = lambda r: len(readers.completed_in_window(r)) * r["audio_s"] / r["window_s"]
    stalled_late = rec(stall_at=8.0, stall_s=4.0)  # answers pushed past the window's end
    assert rate(stalled_late) < rate(steady)
    # a miss counts above every answer
    missed = rec()
    for r in missed["requests"][-6:]:
        r.ok, r.done = False, None
    assert readers.latency_p95_ms(missed) > 500.0


def test_train_rate_counts_all_the_window():
    from portbench import harness

    read = harness.load_module(harness.PACKAGE, "metrics", "train_clips_per_s").read
    steady = {"kind": "train", "clips": 160, "window_s": 10.0}
    stalled = {"kind": "train", "clips": 160, "window_s": 12.0}  # a 2 s stall in the window
    assert read(steady) == 16.0 and read(stalled) < read(steady)
