#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels from ``mocov2_whisper_flamingo_torch/csrc``,
holds each against its plain PyTorch version on the card (K1 at every shape a
path launches) and times it at the main path's shapes (device time per call
from ``torch.profiler``, beside the wall time per call), checks the port end to end against its own CPU run, then
times the serving path: full audio-visual beam-5 decoding (whisper-small +
MoCo ResNet-50 + gated fusion, BF16, B=4, 30 s mel, 400 uint8 88x88 lip
frames, 160 tokens) with random weights made from ``--seed``, whose encode
(K1 inside) and decode are replayed CUDA graphs (``decode/programs.py``),
each held bit for bit against its eager function in turns with it (bf16
here, fp32 beside the card-vs-CPU check), with the captures' seconds and
their memory pools.

Then the training path: the kernel's gradients through its autograd wrapper
against autograd through the plain version; three fp32 optimizer steps on
the card against the same steps on the CPU, and on the card through the
train program against the eager steps bit for bit; and ``Trainer.fit`` at
full width (BF16, B=4, 400 frames, 64 target tokens with repeats) through
the train program (``training/programs.py``: one CUDA graph per batch shape
that replays the whole step, the CTC kernel pair of ``csrc/ctc.cu`` inside)
with the config's dropout, with dropout 0, with activation checkpointing and
with on-device augmentation, each timed per step, beside an eager fit; one
replayed step timed and traced, its synchronising calls (there must be
none), and program and eager steps in turns held bit for bit; then the CTC
kernels at the train shape against the recursion in torch ops, two runs bit
for bit, an infeasible row's gradient exactly 0, and their time beside
their bound and ``F.ctc_loss``'s. The main path's net, dropped with the
collector off, frees its weights and graph pools.

Then the request server: the AV engine (``make_av_engine``, buckets 1 and 4,
each bucket's decode captured at warm-up) answers nine requests at full
width and its rows are held against the eager loop of the same padded
buckets, and an fp32 engine on the card against one on the CPU; the audio
server (``WhisperASR`` behind ``TranscriptionServer`` on a loopback port,
logit rules on) answers sequential and concurrent HTTP requests; and the
teacher-forced ``AVWhisperNet.decoder_logits`` runs the kernel's causal and
cross-attention instantiations and is held against the cached decode step.

Then the streaming decode (``StreamingDecoder`` over the AV encode, beam 5,
448-token windows, 40 tokens per 30 s chunk, each chunk a replayed CUDA
graph of its key): 10 chunks (5 min) and 20 chunks (a window rollover), the
graph and the eager chunk in turns bit for bit, with fp32 card-vs-CPU,
deferred-vs-eager and graph-vs-eager token checks at small depth; and the
continuous engine (``make_continuous_av_engine``, 16 requests x 5 beams,
32-step segments, 160 tokens, each segment a replayed CUDA graph over state
tensors that keep their addresses): 64 closed-loop requests, then 8 in
flight and one more 0.4 s later, reserved memory after warm-up and traffic,
the segment's graph and the eager segment in turns bit for bit at full
width, with an fp32 scripted schedule through ``init_state`` / admit /
segment held card against CPU, against solo beam searches and graph
against eager.

Then data-fed training: a dataset written to disk (16 train, 4 validation
and 4 test clips of 12 s 48 kHz audio and 280-400 uint8 96x96 frames, and a
MoCo v2 checkpoint of random weights) goes through ``DataModule`` (4 worker
threads, 2 batches prefetched and placed on the card by the prefetch thread),
``train.build_net`` and ``Trainer`` at full width, with host augmentation
(4 steps: it waits on its loader), with ``augmentation.on_device`` and with
``on_device_mel`` (8 steps each), each through the train program; then
``train.main`` itself for 2 steps.

Then long-form quality transcription (phase 14): ``WhisperASR.transcribe``
over 90 s of audio in three 30 s windows with the temperature ladder, the
no-speech probe and DTW word times, timed rung by rung and in turns with the
streaming mode, each mode twice (the second call replays only: no capture,
no preparation); the replayed rungs and probe against their eager functions
bit for bit; the timestamp-conditioned seek loop over a 30 s clip; one
window in fp32 on the card against the CPU with one noise for both; and the
``transcribe`` command line writing all five formats.

Then int8 (phase 15): the direct AV decode of phase 4 (at 32 tokens) in turns
with int8 decode weights, int8 caches, an int8 cross cache and both, each
timed and measured for memory (the bf16 and w8 steps traced), its logits held against the bf16 step and its fp32
tokens held card against CPU at small depth; an int8 audio engine against a
direct decode of its bucket; ``transcribe(weight_quant="int8")`` with word
times; and ``Trainer.fit`` with the frozen encoder in int8 beside bf16 storage.

Then multi-rank training (phase 16): ``Trainer.fit`` at full width on a
``("data", "model")`` mesh of two gloo processes sharing the card, at data=2
and at model=2, each held in fp32 against one process on the same global
batch, with K1 launched on each rank's heads (gloo cannot be captured: these
ranks run the eager step, and say so); ``initialize_distributed`` under
torchrun's variables with one process (NCCL) and size-1 data and model
groups set on its mesh, whose step runs through the train program with its
NCCL collectives captured in the graph: bit for bit against its own eager
step and against no process group, with no synchronising call and no
host-side collective call in a replayed step; and bf16 ms per step of each
leg beside one process (two ranks share one card: not a scaling number).

Then the model and data tools (phase 17): ``tools/verify_model.py``'s
stability, memory and shape checks at full width with K1's launches counted
by shape and its logits held against the plain backend's;
``tools/export_model.py``'s ``torch.export`` forward (exported at B=2, run
at B=3 against the live net on the plain backend and with K1, in process
and in a fresh child on the card) and its beam program (B=1, beam 5,
max_len 64, the CLI's default, the decoder cut to 2 layers for the time
budget; the prefix and the search a ``while_loop``
each, as the JAX artifact is two scans; tokens against the same program run
eagerly, and beside it the net's beam), each export, reload and run timed;
``convert_checkpoint``, ``smoke_test`` and ``max_frame_count`` on phase
13's dataset and MoCo checkpoint.

Each phase's end is logged with the seconds since the start and the card's
allocated and reserved memory that the phase left, which is then released
(``phase_end_s``, ``phase_end_mem_gib``). Every phase raises on failure.
The last two lines of stdout are the ``kernels`` JSON line and ``{"ok":
true, "device": {...}}``. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import dataclasses
import gc
import io
import http.client
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mocov2_whisper_flamingo_torch import train as train_entry
from mocov2_whisper_flamingo_torch.config import get_config
from mocov2_whisper_flamingo_torch.datamodule import native
from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule
from mocov2_whisper_flamingo_torch.decode import sampling, timestamps
from mocov2_whisper_flamingo_torch.decode.beam import beam_search
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules
from mocov2_whisper_flamingo_torch.decode.programs import DecodePrograms
from mocov2_whisper_flamingo_torch.decode.sampling import GumbelDraws
from mocov2_whisper_flamingo_torch.decode.streaming import StreamingDecoder
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
from mocov2_whisper_flamingo_torch.models.av_net import AVNet
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_asr_params, random_avnet_params, random_jax_params,
    resnet50_from_moco)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder, config_for
from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops import kernels
from mocov2_whisper_flamingo_torch.ops import losses
from mocov2_whisper_flamingo_torch.ops.augment import packed_waveform_mel
from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline, resize_bilinear
from mocov2_whisper_flamingo_torch.parallel import (
    gather_state_dict, initialize_distributed, shard_batch)
from mocov2_whisper_flamingo_torch.parallel.mesh import sharded_dims
from mocov2_whisper_flamingo_torch.parallel.tensor_parallel import (
    all_gather_cat, all_reduce_sum)
from mocov2_whisper_flamingo_torch.serving import (
    TranscriptionServer, canonical_wav, make_audio_engine, make_av_engine,
    make_continuous_av_engine, pad_rows, trim_at_eos)
from mocov2_whisper_flamingo_torch.serving import continuous
from mocov2_whisper_flamingo_torch.training.optim import make_optimizer
from mocov2_whisper_flamingo_torch.training.programs import TrainProgram, step_kind
from mocov2_whisper_flamingo_torch.training.task import AVSRTask
from mocov2_whisper_flamingo_torch.tools import (
    convert_checkpoint, export_model, max_frame_count, smoke_test, verify_model)
from mocov2_whisper_flamingo_torch.tools import transcribe as transcribe_cli
from mocov2_whisper_flamingo_torch.training.trainer import Trainer
from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer
from mocov2_whisper_flamingo_torch.utils.writers import WRITER_FORMATS

# The serving path's headline configuration.
B, T_VIDEO, BEAM, MAX_TOKENS, SECONDS_PER_CLIP = 4, 400, 5, 160, 30.0
PREFIX = [50258, 50278, 50359, 50363]  # sot, vi, transcribe, notimestamps
EOS = 50257
MODELARGS = (512, 8, 6, 3000, 2048, 0.1)
VOCAB = 51865
GATE = 0.5  # non-zero fusion gates, so the fusion attention reaches the output

# H100 SXM data-sheet peaks (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version, same inputs on the card. fp32: both accumulate in
# fp32 in different orders. bf16: the output is rounded to bf16 (ulp 2^-8 at
# 1) and p is rounded before P.V at different points (unnormalised in the
# kernel, normalised in the plain version).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# fp32 encoder features, card vs CPU: cuDNN and cuBLAS sum in other orders
# than the CPU through 12 encoder layers, ResNet-50 and fusion.
FEATURE_ATOL = 2e-3
# dq/dk/dv through the autograd wrapper against autograd through the plain
# version, as a share of the largest reference gradient (or of 1). fp32: two
# fp32 recomputes in other summation orders. bf16: each gradient is rounded to
# bf16 (2^-8 relative), and the recompute multiplies bf16 P by bf16 V where
# the plain version multiplies them in fp32.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# fp32 train steps, card vs CPU: losses of size ~20 and parameters that three
# AdamW updates move by up to ~2e-3.
TRAIN_LOSS_ATOL = 2e-3
TRAIN_PARAM_ATOL = 5e-5
# The training path's headline configuration.
TRAIN_STEPS, TRAIN_WARMUP, TARGET_TOKENS, AUDIO_FRAMES = 8, 2, 64, 400
CTC_PER_STEP = collections.Counter(ctc_forward=1, ctc_backward=1)  # a ctc_ce train step
# The request server: the AV engine's bucket ladder and traffic, the audio
# server's budget and ladder, the teacher-forced target length.
AV_BUCKETS, AV_REQUESTS = (1, 4), 9
ASR_BUCKETS, ASR_MAX_TOKENS, ASR_SEQUENTIAL, ASR_CONCURRENT = (1, 2, 4), 64, 3, 6
ASR_PREFIX = [50258, 50278, 50359]  # sot, vi, transcribe: timestamps on
NO_TIMESTAMPS, TIMESTAMP_BEGIN = 50363, 50364
FORCED_TOKENS = 160
# Teacher-forced fp32 logits against the cached decode step's, as a share of
# the largest logit: the same fp32 products summed by other kernels (one
# [T, Tk] attention against T single-query ones).
FORCED_LOGIT_RTOL = 1e-4
WAIT_S = 300  # every future, join and HTTP call of the serving phases
# The streaming decode (bench.py's streaming leg): window, tokens per chunk,
# the 5-minute and the long-form legs; <|startofprev|> for the rollover check.
STREAM_MAX_LEN, STREAM_TOKENS, STREAM_CHUNKS, LONGFORM_CHUNKS = 448, 40, 10, 20
SOT_PREV = 50361
# Long-form quality transcription (phase 14): the audio, the temperature
# ladder and budgets, <|nospeech|>, the word-time alignment's token buckets
# (powers of two from 32, capped at the decoder's 448 positions), and the
# fp32 card-vs-CPU tolerance of an average logprob (fp32 sums of ~30
# log-softmax values, computed by other kernels on each side). A window's
# rungs decode 64 tokens, not Whisper's 224, for the script's time budget.
LONG_SECONDS, LONG_TEMPERATURES, LONG_MAX_LEN, SEEK_MAX_LEN = 90.0, (0.0, 0.4, 0.8), 64, 64
NO_SPEECH_ID, ALIGN_BUCKETS = 50362, (32, 64, 128, 256, 448)
FP32_TEMPERATURES, FP32_MAX_LEN, FP32_LOGPROB_ATOL = (0.0, 0.6), 32, 1e-4
# A synthetic generation_config.json (the card machine has no transformers):
# the fields LogitRules.for_whisper reads.
GENERATION_CONFIG = {"suppress_tokens": [1, 2, 7, 8, 9, 10, 14, 25, 50258],
                     "begin_suppress_tokens": [220, 50257], "no_timestamps_token_id": 50363,
                     "eos_token_id": 50257, "forced_decoder_ids": None}
# The continuous engine (bench.py's continuous leg): rows, segment length,
# closed-loop requests, requests in flight for the mid-decode admission probe,
# and the admission encode's buckets.
CONT_CAPACITY, CONT_SEG_STEPS, CONT_REQUESTS, CONT_INFLIGHT = 16, 32, 64, 8
CONT_BUCKETS = (1, 2, 4, 8, 16)
# int8 (phase 15): (weight_quant, cache_quant) of each mode, the bf16 baseline
# first; the fp32 small-depth check's tokens; the logit bound of the JAX
# package's own int8 test (tests/test_decode.py), times the step's spread
INT8_MODES = {"bf16": (None, None), "w8": ("int8", None), "c8": (None, "int8"),
              "c8x": (None, "int8-cross"), "w8_c8": ("int8", "int8")}
INT8_FP32_MAX_LEN, INT8_LOGIT_SPREAD, INT8_LOGIT_STEPS, INT8_WINDOW = 32, 0.05, 8, 16
# the modes whose eager decode step is traced over a window (the others' replayed
# decodes are timed only: the script's time budget)
INT8_TRACED = ("bf16", "w8")
INT8_MAX_TOKENS = 32  # the timed decodes' length (phase 4: 160), for the time budget
INT8_ASR_MAX_LEN = 32
# Multi-rank training (phase 16): the legs' (data, model) meshes, two gloo
# processes each on the one card; a rank's wall limit; fp32 micro-batches (2
# updates at accumulation 2); the bf16 timed steps and their warm-up.
MULTI_LEGS = {"data2": (2, 1), "model2": (1, 2)}
MULTI_RANK_LIMIT_S, MULTI_FP32_STEPS, MULTI_STEPS, MULTI_WARMUP = 180, 4, 6, 2
NOT_SCALING = "two ranks share one card; not a scaling number"
# fp32, a leg against one process. The gradient at the starting weights, as a
# share of its largest value: the legs sum the same fp32 products in other
# orders (cuBLAS and cuDNN pick other kernels for a batch of 2 than of 4; row
# shards add partial products), and CTC and the Adam moments amplify nothing
# yet. The parameters after the two updates: an Adam update moves an element
# by about the learning rate whatever the size of its gradient, so an element
# whose gradient is within rounding of 0 may move either way; half the peak
# learning rate (1e-3) bounds that, and a wrong reduce or loss normalisation
# moves most elements by the full rate. The losses: phase 6's bound.
MULTI_GRAD_RTOL, MULTI_PARAM_ATOL = 1e-3, 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Wall time per call over ``iters`` back-to-back calls, between CUDA
    events: the host's time per call wherever that exceeds the device's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


K1_RECORD = re.compile(r"attention_fwd_(?:wgmma|mma|f32)\w*(<[^>]*>)?")  # K1's three kernels
PAD_KERNELS, PAD_CYCLES = 32, 1_000_000  # ``torch.cuda._sleep`` launches: 32 x ~0.6 ms


def traced(fn, tries: int = 5, cpu: bool = True):
    """``(profiler, device records, wall seconds, traces taken)`` of one run
    of ``fn`` under ``torch.profiler``, synchronised; the device records are
    the kernels and copies that ``fn`` issued. The profiler now and then
    loses the first few records of a window (on the card: 4 or 5 of them,
    the same in trace after trace; 9 of a window of ~4300 records late in a
    whole run), or hands back a window with no device events at all. So
    the window opens and closes with ``PAD_KERNELS`` spin kernels each,
    whose records are dropped from what this returns; and as
    the K1 wrapper counts its own launches, a trace that holds no device
    time, or other than that many K1 records, is made again, up to
    ``tries`` times, and then this raises. ``cpu=False`` traces the device
    alone (no host op records: a window of many launches is read several
    times faster)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def pad():
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        before = fa.launches
        activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
        with torch_profile(activities=activities) as prof:
            pad()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            pad()
        counted = fa.launches - before
        device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        records = [ev for ev in device if "spin_kernel" not in ev.name]
        k1_records = sum(1 for ev in records if K1_RECORD.search(ev.name))
        if k1_records == counted and any(ev.device_time > 0 for ev in records):
            return prof, records, wall_s, attempt
        log(f"traced: trace {attempt} holds {len(device) - len(records)} of "
            f"{2 * PAD_KERNELS} pad records and {len(records)} others, {k1_records} of them "
            f"K1's; the wrapper launched K1 {counted} times; tracing again")
    raise AssertionError(f"no trace in {tries} held device time and all {counted} K1 launches")


def device_ms(fn, iters: int = 20) -> tuple[float, float]:
    """Device time per call of ``fn`` and kernels per call: the summed
    duration of the kernels that ``iters`` calls launched, as
    ``torch.profiler`` records them on the card, over ``iters``. Host time
    between the kernels does not count."""
    fn()
    _, records, _, _ = traced(lambda: [fn() for _ in range(iters)])
    return sum(ev.device_time for ev in records) / iters / 1e3, len(records) / iters


def attention_flops(b, tq, tk, h, d, causal: bool = False) -> int:
    """4*B*H*Dh operations for every (query, key) pair the function needs:
    all Tq*Tk of them, or under the causal mask (offset Tk - Tq) the pairs
    with key <= query + Tk - Tq."""
    pairs = tq * tk
    if causal:
        pairs = sum(min(max(row + tk - tq + 1, 0), tk) for row in range(tq))
    return 4 * b * h * pairs * d


def attention_bound_ms(b, tq, tk, h, d, dtype, masked: bool,
                       causal: bool = False) -> tuple[float, str]:
    """Least time for the call: q, k, v read once and o written once (plus
    the [B, Tk] mask bytes), against the operations of ``attention_flops``
    at the dtype's peak. Returns (ms, 'bytes' | 'operations')."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * elt + (b * tk if masked else 0)
    flops = attention_flops(b, tq, tk, h, d, causal)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def qkv(gen, b, tq, tk, h, d, dtype, dev, strided=False):
    """q [b, tq, h, d], k/v [b, tk, h, d]; ``strided``: chunks of one
    [b, t, 3*h*d] projection (tq == tk), read in place as the encoder's are."""
    if strided:
        proj = torch.randn((b, tq, 3 * h * d), generator=gen).to(dev, dtype)
        return tuple(x.view(b, tq, h, d) for x in proj.chunk(3, dim=-1))
    mk = lambda t: torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
    return mk(tq), mk(tk), mk(tk)


def valid_mask(lens, tk, dev):
    return torch.arange(tk, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]


def path_attention_cases() -> list[tuple]:
    """K1's calls on the paths this script drives, as ``(name, (b, tq, tk,
    h, d), valid key counts or None, causal)``: the audio encoder at every
    batch size that the main path, the two servers' bucket ladders and the
    continuous engine's admission buckets reach (and at the widest bucket the
    serving tool offers, 16), the AV fusion at the main path's, the AV
    engine's and the continuous engine's (the streaming decode encodes at
    B=1), and the teacher-forced decoder's causal and cross attentions.
    Derived from the ladders, so a bucket that is driven is a shape that is
    held against the plain version."""
    fusion_lens = (T_VIDEO, 317, 64, 1)
    cases = []
    for b in sorted({B, 16, *AV_BUCKETS, *ASR_BUCKETS, *CONT_BUCKETS}):
        cases.append(("encoder" if b == B else f"encoder_b{b}", (b, 1500, 1500, 12, 64),
                      None, False))
    for b in sorted({B, *AV_BUCKETS, *CONT_BUCKETS}):
        lens = tuple(fusion_lens[(i + 1) % len(fusion_lens)] for i in range(b))
        cases.append(("fusion" if b == B else f"fusion_b{b}", (b, T_VIDEO, T_VIDEO, 8, 64),
                      lens, False))
    cases += [("forced_causal", (B, FORCED_TOKENS, FORCED_TOKENS, 12, 64), None, True),
              ("forced_cross_audio", (B, FORCED_TOKENS, 1500, 12, 64), None, False),
              ("forced_cross_av", (B, FORCED_TOKENS, T_VIDEO, 12, 64), fusion_lens, False)]
    cases += [(f"align_causal_{t}", (1, t, t, 12, 64), None, True) for t in ALIGN_BUCKETS]
    # tensor parallelism at model=2 (phase 16): a rank's 6 encoder heads (B=4,
    # and B=2 a data index on a 2 x 2 mesh) and its 4 fusion heads
    cases += [("encoder_tp2", (B, 1500, 1500, 6, 64), None, False),
              ("encoder_tp2_dp2", (B // 2, 1500, 1500, 6, 64), None, False),
              ("fusion_tp2", (B, T_VIDEO, T_VIDEO, 4, 64), fusion_lens, False)]
    # the model tools (phase 17): the encoder at the export check's B=3, and the
    # fusion at verify_model's and the export's (B, frames), every frame valid
    cases.append(("encoder_b3", (3, 1500, 1500, 12, 64), None, False))
    cases += [(f"fusion_tools_b{b}_t{t}", (b, t, t, 8, 64), (t,) * b, False)
              for b, t in TOOLS_FUSION]
    return cases


# -- phase 2 -------------------------------------------------------------------


def check_kernel(gen) -> dict:
    dev = torch.device("cuda")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [
            *((name, shape, dtype, lens, causal)
              for name, shape, lens, causal in path_attention_cases()),
            ("encoder_strided_qkv", (4, 1500, 1500, 12, 64), dtype, None, False),
            ("single_tile", (2, 100, 100, 3, 64), dtype, None, False),
            ("tail_130", (2, 130, 130, 4, 64), dtype, (130, 129), False),
            ("causal_13x27", (2, 13, 27, 2, 64), dtype, None, True),
            ("causal_130x400", (2, 130, 400, 2, 64), dtype, (400, 300), True),
            ("causal_448", (2, 448, 448, 12, 64), dtype, None, True),
            ("masked_row", (4, 400, 400, 8, 64), dtype, (400, 317, 64, 0), False),
            ("dh32", (2, 70, 90, 3, 32), dtype, (90, 5), False),
            ("dh128_causal", (2, 100, 130, 2, 128), dtype, None, True),
            ("dh128_masked", (2, 300, 257, 2, 128), dtype, (257, 0), False),
        ]
    errs = {}
    for name, (b, tq, tk, h, d), dtype, lens, causal in cases:
        q, k, v = qkv(gen, b, tq, tk, h, d, dtype, dev, strided="strided" in name)
        mask = None if lens is None else valid_mask(lens, tk, dev)
        outs = {"": fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)}
        if fa.route(dtype, d) == "wgmma_tma" and d == 64:  # each block size, not only the chosen one
            mask_bytes = fa._mask_bytes(mask, b, tk, dev)
            for n in (2, 3):
                outs[f" consumers={n}"] = fa._launch(q, k, v, mask_bytes, d ** -0.5, causal,
                                                     consumers=n)
        torch.cuda.synchronize()
        ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
        empty = [i for i, n in enumerate(lens or ()) if n == 0]
        for variant, out in outs.items():
            tag = f"{name}/{str(dtype).split('.')[-1]}{variant}"
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError(f"{tag}: got {out.dtype} {tuple(out.shape)}")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"K1 {tag}: max_abs_err {err:.3e} (atol {TOL[dtype]:g})")
            if not err <= TOL[dtype]:
                raise AssertionError(f"K1 {tag} disagrees with its plain version: {err}")
            if empty and bool(out[empty].any()):
                raise AssertionError(f"K1 {tag}: a row with no valid key did not return exact "
                                     "zeros")
            errs[tag] = err

    rows = {}
    for name, (b, tq, tk, h, d), lens, causal in path_attention_cases():
        if name not in ("encoder", "fusion"):
            continue  # held against the plain version above; timed in the PRs that added them
        q, k, v = qkv(gen, b, tq, tk, h, d, torch.bfloat16, dev)
        mask = None if lens is None else valid_mask(lens, tk, dev)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        kernel = lambda: fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask,
                                                         is_causal=causal)
        dev_ms, per_call = device_ms(kernel)
        if per_call != 1:
            raise AssertionError(f"K1 {name}: {per_call} device kernels per call, expected 1")
        library_dev_ms, library_kernels = device_ms(library)
        bound_ms, bound_by = attention_bound_ms(b, tq, tk, h, d, torch.bfloat16,
                                                mask is not None, causal)
        tflops = attention_flops(b, tq, tk, h, d, causal) / (dev_ms * 1e-3) / 1e12
        consumers = fa.consumer_groups(d, tq, b * h, torch.cuda.get_device_properties(dev)
                                       .multi_processor_count)
        mask_bytes = fa._mask_bytes(mask, b, tk, dev)
        row = rows[name] = {
            "shape": [b, tq, tk, h, d], "causal": causal, "dtype": "bfloat16",
            "kernel": fa.route(torch.bfloat16, d), "consumers": consumers,
            "device_ms": dev_ms, "tflops": tflops, "bound_share": bound_ms / dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_device_ms": library_dev_ms,
            "library_kernels_per_call": library_kernels, "max_abs_err": errs[f"{name}/bfloat16"],
            "ms": cuda_ms(kernel, 50), "library_ms": cuda_ms(library, 50),
            "plain_ms": cuda_ms(lambda: fa.plain_flash_attention(q, k, v, kv_valid=mask,
                                                                 causal=causal), 10),
            # the Hopper kernel with each block size it can take, beside the one chosen
            "device_ms_by_consumers": {n: device_ms(lambda: fa._launch(
                q, k, v, mask_bytes, d ** -0.5, causal, consumers=n))[0] for n in (2, 3)}}
        log(f"K1 {name} [{b},{tq},{tk},{h},{d}]{' causal' if causal else ''} bf16 "
            f"({row['kernel']}, {consumers} consumer warpgroups): device_ms {dev_ms:.4f} "
            f"({tflops:.1f} TFLOP/s, {100 * bound_ms / dev_ms:.1f} % of the bound "
            f"{bound_ms * 1e3:.2f} us by {bound_by}) wall_ms/call {row['ms']:.4f}; device_ms "
            f"by consumer warpgroups {row['device_ms_by_consumers']}; library device_ms "
            f"{library_dev_ms:.4f} wall_ms/call {row['library_ms']:.4f}; plain_ms "
            f"{row['plain_ms']:.4f}")
    return rows


def ptxas_report(log_path) -> list[str]:
    """Registers, spills and warnings that ptxas printed for each
    instantiation of the Hopper kernel and for the CTC kernels (``-Xptxas
    -v`` in the build log)."""
    lines, current = [], None
    for line in open(log_path).read().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            args = re.search(r"attention_fwd_wgmmaILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", name)
            ctc = re.search(r"(ctc_alpha|ctc_grad)", name)
            current = (f"attention_fwd_wgmma<Dh={args[1]}, consumers={args[2]}, "
                       f"mask={args[3]}, causal={args[4]}>" if args else ctc and ctc[1])
        elif current and ("spill" in line or "Used" in line):
            lines.append(f"{current}: {line.strip()}")
        elif "warning" in line.lower() or "C75" in line:
            lines.append(line.strip())
    return lines


# -- phases 3 and 4 -----------------------------------------------------------------


def build(seed: int, precision, device, decoder_layers: int | None = None) -> AVWhisperNet:
    """The serving path's net, whisper-small width and depth unless
    ``decoder_layers`` cuts the decoder's depth; random weights from ``seed``."""
    config = config_for("whisper-small")
    if decoder_layers is not None:
        config = dataclasses.replace(config, decoder_layers=decoder_layers)
    net = AVWhisperNet(modelargs=MODELARGS, vocab_size=VOCAB, whisper_config=config,
                       precision=precision, device=device)
    tree = random_jax_params(net, seed)
    for layer in tree["trunk"]["fusion"]["layers"]:
        layer["attn_gate"] = np.float32(GATE)
        layer["ff_gate"] = np.float32(GATE)
    return load_jax_params(net, tree).eval()


def make_batch(rng, b: int, frames: int, dev):
    """(mel [B, 3000, 80], audio mask, normalised 64x64 video, video mask,
    lengths) from raw uint8 88x88 frames, preprocessed on ``dev``."""
    mel = torch.from_numpy(rng.standard_normal((b, 3000, 80)).astype(np.float32)).to(dev)
    raw = torch.from_numpy(rng.integers(0, 255, (b, frames, 3, 88, 88), dtype=np.uint8)).to(dev)
    return mel, raw


def preprocess(mel, raw):
    b, t = raw.shape[:2]
    dev = raw.device
    video = eval_video_pipeline(raw, resize=64)
    return (mel, torch.ones((b, 3000), dtype=torch.bool, device=dev), video,
            torch.ones((b, t), dtype=torch.bool, device=dev),
            torch.full((b,), t, dtype=torch.long, device=dev))


def check_end_to_end(seed: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    mel, raw = make_batch(rng, 1, 32, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        net = build(seed, L.FP32, dev)
        batch = preprocess(mel.to(dev), raw.to(dev))
        feats, valid = net.encode(batch)
        fa.reset_launches()
        res = net.beam(batch, PREFIX, beam_size=BEAM, max_len=48, eos_id=EOS)
        if dev == "cuda":
            torch.cuda.synchronize()
            if fa.launches != 15:
                raise AssertionError(f"fp32 card run launched K1 {fa.launches} times, "
                                     "expected 15 (12 encoder + 3 fusion)")
            # The card's decode is a replayed graph: against the eager loop.
            eager = beam_search(net.decoder.prepare_decode_params(), feats, PREFIX,
                                beam_size=BEAM, max_len=48, eos_id=EOS, encoder_valid=valid)
            graph_equal = bool(torch.equal(res.sequences, eager.sequences)
                               and torch.equal(res.scores, eager.scores))
            # The encode graph against the eager encode at the main path's B=4.
            mel4, raw4 = make_batch(rng, B, T_VIDEO, dev)
            encode_equal = encode_graph_equal(net, preprocess(mel4, raw4))
            del mel4, raw4
        results[dev] = (feats.cpu(), res.sequences.cpu(), res.scores.cpu())
        del net
    f_gpu, s_gpu, sc_gpu = results["cuda"]
    f_cpu, s_cpu, sc_cpu = results["cpu"]
    if not torch.isfinite(f_gpu).all():
        raise AssertionError("non-finite fp32 features on the card")
    err = (f_gpu - f_cpu).abs().max().item()
    same = bool(torch.equal(s_gpu, s_cpu))
    log(f"e2e fp32 whisper-small B=1 32 frames: feature max_abs_err {err:.3e} "
        f"(atol {FEATURE_ATOL:g}); beam tokens identical: {same}; score diff "
        f"{(sc_gpu - sc_cpu).abs().max().item():.3e}; card graph vs card eager loop, tokens "
        f"and scores bit-equal: {graph_equal}; B=4 encode graph vs eager encode bit-equal: "
        f"{encode_equal}")
    if not err <= FEATURE_ATOL:
        raise AssertionError(f"fp32 encoder features card vs CPU differ by {err}")
    if not same:
        raise AssertionError(f"fp32 beam tokens differ card vs CPU:\n{s_gpu}\n{s_cpu}")
    if not graph_equal:
        raise AssertionError("fp32 beam on the card: the decode program differs from the "
                             "eager loop")
    if not encode_equal:
        raise AssertionError("fp32 B=4 encode on the card: the graph differs from the eager "
                             "encode")
    return {"fp32_graph_vs_eager_bit_equal": graph_equal, "fp32_card_vs_cpu_tokens_equal": same,
            "fp32_encode_graph_vs_eager_bit_equal_b4": encode_equal}


def eager_encode(net, batch):
    """``AVWhisperNet.encode``'s eager function (the encode program's plain
    version) on the card."""
    with torch.no_grad():
        return net.encode_program.fn(*batch)


def encode_graph_equal(net, batch) -> bool:
    """The replayed encode (captured here if its key is new) against the
    eager encode, features and validity bit for bit, with K1 credited 15
    launches by the replay."""
    want = eager_encode(net, batch)
    net.encode(batch)  # the capture, if the key is new
    fa.reset_launches()
    got = net.encode(batch)
    torch.cuda.synchronize()
    if fa.launches != 15:
        raise AssertionError(f"an encode replay counted {fa.launches} K1 launches, expected 15")
    return all(torch.equal(a, b) for a, b in zip(got, want))


def run_main_path(seed: int) -> dict:
    dev = torch.device("cuda")
    net = build(seed, L.BF16, dev)
    rng = np.random.default_rng(seed + 1)
    batches = [make_batch(rng, B, T_VIDEO, dev) for _ in range(3)]

    def encode(mb):
        return net.encode(preprocess(*mb))

    def decode(mb):
        return net.beam(preprocess(*mb), PREFIX, beam_size=BEAM, max_len=MAX_TOKENS,
                        eos_id=EOS)

    t0 = time.perf_counter()
    decode(batches[0])  # warm-up: cuDNN plans, allocator, the decode program's capture
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0

    fa.reset_launches()
    res = decode(batches[0])
    torch.cuda.synchronize()
    launches = fa.launches
    log(f"main path: K1 launches per encoded batch {launches}")
    if launches != 15:
        raise AssertionError(f"K1 launched {launches} times on the main path, expected 15")
    seq, scores = res.sequences, res.scores
    if tuple(seq.shape) != (B, BEAM, MAX_TOKENS) or not torch.isfinite(scores).all():
        raise AssertionError(f"bad beam output: {tuple(seq.shape)}, scores {scores}")
    if not bool((seq[:, :, :len(PREFIX)] == torch.tensor(PREFIX, device=dev)).all()):
        raise AssertionError("beam hypotheses lost the forced prefix")

    torch.cuda.reset_peak_memory_stats()
    enc_s, tot_s = [], []
    for mb in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(mb)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        decode(mb)
        torch.cuda.synchronize()
        tot_s.append(time.perf_counter() - t0)
    n_steps = MAX_TOKENS - len(PREFIX)
    enc, tot = float(np.mean(enc_s)), float(np.mean(tot_s))
    out = {
        "encode_ms": enc * 1e3,
        "total_ms": tot * 1e3,
        "decode_ms_per_step": (tot - enc) * 1e3 / n_steps,
        "rtf": B * SECONDS_PER_CLIP / tot,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "encode_ms_each": [x * 1e3 for x in enc_s],
        "total_ms_each": [x * 1e3 for x in tot_s],
        "k1_launches_per_batch": launches,
    }
    log("main path bf16 B=4 beam 5 160 tokens: " + json.dumps(out))
    out["encode_program"] = encode_leg(net, batches)
    out["program"] = program_leg(net, batches, first_call_s)
    out["profile"] = {"encode": profile(lambda: encode(batches[0])),
                      "eager_encode": profile(lambda: eager_encode(net, preprocess(*batches[0]))),
                      **out["program"].pop("profile")}
    # The net dropped with the collector off: its weights and its programs'
    # graph pools go with its last reference, with no cycle left to collect.
    weight_bytes = sum(t.numel() * t.element_size() for t in (*net.parameters(), *net.buffers()))
    del res, seq, scores
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        del net, encode, decode
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
    finally:
        gc.enable()
    out["dropped_net"] = {"freed_gib": freed / 2**30, "weights_gib": weight_bytes / 2**30,
                          "allocated_before_gib": before / 2**30}
    log("main path net dropped, the collector off: " + json.dumps(out["dropped_net"]))
    if not freed >= weight_bytes:
        raise AssertionError(f"a dropped net kept its memory until the collector runs: "
                             f"{out['dropped_net']}")
    return out


def encode_leg(net, batches) -> dict:
    """Phase 4's AV encode as the eager function and as the replayed graph
    (``AVWhisperNet.encode_program``, captured by the main path's warm-up)
    in turns on the same batches: wall ms of each, features and validity bit
    for bit, K1's launches credited per replay, the capture's seconds and
    the pool's bytes."""
    program = net.encode_program
    ms = {"eager": [], "replay": []}
    equal = []
    for i, mb in enumerate(batches):
        batch = preprocess(*mb)
        legs = (("eager", lambda: eager_encode(net, batch)), ("replay", lambda: net.encode(batch)))
        got = {}
        for name, fn in (legs if i % 2 == 0 else legs[::-1]):
            got[name], wall_s = timed_call(fn)
            ms[name].append(wall_s * 1e3)
        equal.append(all(torch.equal(a, b) for a, b in zip(got["eager"], got["replay"])))
    if not all(equal) or not encode_graph_equal(net, batch):
        raise AssertionError(f"bf16 B=4 encode graph against the eager encode, bit-equal: {equal}")
    (capture,) = program.captures
    out = {"eager_ms": ms["eager"], "replay_ms": ms["replay"], "bit_equal": equal,
           "k1_launches_per_replay": 15, "capture_s": capture["capture_s"],
           "instantiate_s": capture["instantiate_s"], "pool_bytes": pool_bytes(program),
           "replays": program.replays}
    log("encode program bf16 B=4, eager encode and replay in turns: " + json.dumps(out))
    return out


def pool_bytes(programs) -> int:
    """Bytes the caching allocator holds in the CUDA graph memory pool of a
    ``GraphPool`` (decode or encode programs, a segment or chunk graph)."""
    if programs.pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(programs.pool))


def program_leg(net, batches, first_call_s: float) -> dict:
    """Phase 4's decode through the eager loop and through the decode
    program (``AVWhisperNet.decode_programs``, captured by the main path's
    warm-up) in turns on the same features of the first batch (one eager
    decode: the script's time budget): wall ms per decode and per step,
    tokens and scores bit for bit. Then the capture's
    seconds, the pool's bytes, one replay profiled (device busy share; a
    replayed kernel carries no PyTorch op name, so the op table comes from a
    16-step eager profile), and the prepared decoder's refresh (timed) against
    the per-call preparation it replaced."""
    programs = net.decode_programs
    prepared = net.decoder.prepare_decode_params()
    kw = dict(beam_size=BEAM, max_len=MAX_TOKENS, eos_id=EOS)
    n_steps = MAX_TOKENS - len(PREFIX)
    eager_s, program_s, equal = [], [], []
    for mb in batches[:1]:
        feats, valid = net.encode(preprocess(*mb))
        want, wall_s = timed_call(lambda: beam_search(prepared, feats, PREFIX,
                                                      encoder_valid=valid, **kw))
        eager_s.append(wall_s)
        got, wall_s = timed_call(lambda: programs.beam(feats, valid, PREFIX, **kw))
        program_s.append(wall_s)
        equal.append(bool(torch.equal(got.sequences, want.sequences)
                          and torch.equal(got.scores, want.scores)))
    if not all(equal):
        raise AssertionError(f"bf16 decode program against the eager loop, bit-equal: {equal}")
    (capture,) = programs.captures
    t0 = time.perf_counter()
    net.decoder.prepare_decode_params()
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    refresh = lambda: net.decoder.refresh_decode_params(programs.prepared_decoder())
    out = {
        "eager_ms_per_decode": [x * 1e3 for x in eager_s],
        "program_ms_per_decode": [x * 1e3 for x in program_s],
        "eager_ms_per_step": [x * 1e3 / n_steps for x in eager_s],
        "program_ms_per_step": [x * 1e3 / n_steps for x in program_s],
        "tokens_and_scores_bit_equal": equal,
        "first_call_s": first_call_s, "capture_s": capture["capture_s"],
        "instantiate_s": capture["instantiate_s"], "pool_bytes": pool_bytes(programs),
        "refresh_ms": cuda_ms(refresh, 10), "refresh_device_ms": device_ms(refresh, 10)[0],
        "prepare_per_call_ms_before": prepare_ms,
    }
    log("decode program bf16 B=4 beam 5 160 tokens, eager loop and program in turns: "
        + json.dumps(out))
    out["profile"] = {
        "decode_replay": profile(lambda: programs.beam(feats, valid, PREFIX, **kw), cpu=False),
        "eager_decode_16_steps": profile(lambda: beam_search(
            prepared, feats, PREFIX, beam_size=BEAM, max_len=len(PREFIX) + 16, eos_id=EOS,
            encoder_valid=valid))}
    out["replay_device_busy_share"] = out["profile"]["decode_replay"]["device_busy_share"]
    return out


def profile(fn, top: int = 6, cpu: bool = True) -> dict:
    """Device busy share and the kernels that take the most device time over
    one call of ``fn``, from ``torch.profiler`` (a trace that holds all of
    the call's K1 launches; see ``traced``). The profiler's own host
    overhead lengthens the wall time, so the busy share is a lower bound.
    ``cpu=False`` traces the device alone (no op table)."""
    from torch.autograd import DeviceType

    prof, records, wall_s, attempt = traced(fn, cpu=cpu)
    kernels_us: dict[str, float] = {}
    k1: dict[str, int] = {}  # K1 launches by kernel instantiation
    for ev in records:
        name = ev.name[:100]  # template-heavy names; kernels sharing a prefix add up
        kernels_us[name] = kernels_us.get(name, 0.0) + ev.device_time
        found = K1_RECORD.search(ev.name)
        if found:
            k1[found[0]] = k1.get(found[0], 0) + 1
    launches = len(records)
    wall_us = wall_s * 1e6
    busy = sum(kernels_us.values())
    ranked = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:top]
    # Device time by the PyTorch op that launched it.
    ops = sorted(((ev.key, ev.self_device_time_total) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CPU and ev.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "device_ops": launches,
           "k1_launches_by_kernel": k1, "traces": attempt,
           "top_kernels_ms": {name: us / 1e3 for name, us in ranked},
           "top_torch_ops_ms": {name: us / 1e3 for name, us in ops}}
    log("profile: " + json.dumps(out))
    return out


# -- phase 5: K1 under autograd ------------------------------------------------------


def check_kernel_gradient(gen) -> dict:
    """The autograd wrapper on the card: its forward is the kernel's, bit
    for bit, and dq, dk, dv agree with autograd through the plain version.
    Returns the fusion call's forward and forward+backward device times."""
    dev = torch.device("cuda")
    cases = [("fusion", (4, 400, 400, 8, 64), (400, 317, 64, 1), False),
             ("causal_130x400", (2, 130, 400, 2, 64), (400, 300), True)]
    for name, (b, tq, tk, h, d), lens, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            q, k, v = qkv(gen, b, tq, tk, h, d, dtype, dev)
            mask = valid_mask(lens, tk, dev)
            cot = torch.randn((b, tq, h, d), generator=gen).to(dev, dtype)
            direct = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = fa.launches
            out = fa.flash_attention(*leaves, kv_valid=mask, causal=causal)
            if fa.launches != before + 1:
                raise AssertionError(f"K1 grad {tag}: the wrapper's forward launched "
                                     f"{fa.launches - before} kernels, expected 1")
            if not torch.equal(out, direct):
                raise AssertionError(f"K1 grad {tag}: forward through the autograd wrapper "
                                     "differs from the kernel's forward")
            # the cotangent arrives as a non-contiguous view
            grads = torch.autograd.grad(out.transpose(1, 2), leaves, cot.transpose(1, 2))
            ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            ref_out = fa.plain_flash_attention(*ref_leaves, kv_valid=mask, causal=causal)
            ref_grads = torch.autograd.grad(ref_out, ref_leaves, cot)
            for which, g, ref in zip("qkv", grads, ref_grads):
                if g.dtype != dtype or g.shape != ref.shape:
                    raise AssertionError(f"K1 grad {tag} d{which}: {g.dtype} {tuple(g.shape)}")
                scale = max(1.0, ref.float().abs().max().item())
                err = (g.float() - ref.float()).abs().max().item()
                log(f"K1 grad {tag} d{which}: max_abs_err {err:.3e} (atol "
                    f"{GRAD_TOL[dtype] * scale:.3g} = {GRAD_TOL[dtype]:g} x {scale:.3g})")
                if not err <= GRAD_TOL[dtype] * scale:
                    raise AssertionError(f"K1 grad {tag} d{which} disagrees with autograd "
                                         f"through the plain version: {err}")

    b, t, h, d = 4, 400, 8, 64
    q, k, v = (x.requires_grad_() for x in qkv(gen, b, t, t, h, d, torch.bfloat16, dev))
    mask = valid_mask((400, 317, 64, 1), t, dev)
    cot = torch.randn((b, t, h, d), generator=gen).to(dev, torch.bfloat16)

    def through(fn):
        return lambda: torch.autograd.grad(fn(q, k, v, kv_valid=mask), (q, k, v), cot)

    fwd_ms, _ = device_ms(lambda: fa.flash_attention(q.detach(), k.detach(), v.detach(),
                                                     kv_valid=mask))
    both_ms, n_kernels = device_ms(through(fa.flash_attention))
    plain_both_ms, _ = device_ms(through(fa.plain_flash_attention))
    out = {"shape": [b, t, h, d], "dtype": "bfloat16", "forward_device_ms": fwd_ms,
           "forward_backward_device_ms": both_ms,
           "backward_device_ms": both_ms - fwd_ms,
           "backward_share": (both_ms - fwd_ms) / both_ms,
           "device_kernels_per_forward_backward": n_kernels,
           "plain_forward_backward_device_ms": plain_both_ms}
    log("K1 fusion forward+backward bf16: " + json.dumps(out))
    return out


# -- phase 6: fp32 train steps, card against CPU --------------------------------------


def synthetic_train_batch(rng, b: int, frames: int, dev, augmentable: bool = False) -> dict:
    """One training batch with the reference collate keys on ``dev``: 30 s
    mel, ``frames`` lip frames made from raw uint8 88x88 as ``preprocess``
    makes them, ``TARGET_TOKENS`` random target ids with repeats, as
    transcripts have them (every fourth id next to itself and again two
    places on). ``augmentable``: the layout the on-device augmentation takes
    (raw mel, uint8 64x64 frames)."""
    mel, raw = make_batch(rng, b, frames, dev)
    if augmentable:
        video = resize_bilinear(raw, 64).round().clamp(0, 255).to(torch.uint8)
    else:
        video = eval_video_pipeline(raw, resize=64)
    ids = torch.from_numpy(repeated_labels(rng.integers(1, VOCAB, (b, TARGET_TOKENS)))).to(dev)
    return {
        "audio": mel, "audio_mask": torch.ones((b, 3000), dtype=torch.bool, device=dev),
        "audio_lengths": torch.full((b,), AUDIO_FRAMES, dtype=torch.int32, device=dev),
        "video": video, "video_mask": torch.ones((b, frames), dtype=torch.bool, device=dev),
        "video_lengths": torch.full((b,), frames, dtype=torch.int32, device=dev),
        "target_ids": ids,
        "target_lengths": torch.full((b,), TARGET_TOKENS, dtype=torch.int32, device=dev),
    }


def repeated_labels(ids: np.ndarray) -> np.ndarray:
    """``ids`` ``[B, L]`` with every fourth label repeated next to itself and
    again two places on."""
    ids = ids.copy()
    ids[:, 1::4] = ids[:, 0::4][:, :ids[:, 1::4].shape[1]]
    ids[:, 3::4] = ids[:, 0::4][:, :ids[:, 3::4].shape[1]]
    return ids


def same_train_state(a, b) -> dict:
    """Parameters (of the nets), optimizer state tensors and generators of
    two ``(net, optimizer, generator)``: ``equal`` bit for bit, else the
    largest difference of each kind."""
    (net_a, opt_a, gen_a), (net_b, opt_b, gen_b) = a, b
    pairs = {"params": list(zip(net_a.parameters(), net_b.parameters())),
             "optimizer": list(zip(opt_a.state_tensors(), opt_b.state_tensors()))}
    out = {"equal": torch.equal(gen_a.get_state(), gen_b.get_state())}
    for kind, tensors in pairs.items():
        diff = max((x.double() - y.double()).abs().max().item() for x, y in tensors)
        out[f"{kind}_max_abs_diff"] = diff
        out["equal"] = out["equal"] and all(torch.equal(x, y) for x, y in tensors)
    return out


def check_train_steps(seed: int) -> dict:
    """Three fp32 optimizer steps through ``AVSRTask`` on the card and on the
    CPU from the same weights (whisper-small width and depth, B=2, 32
    frames, dropout 0, gates at 0.5 so that every trainable parameter has a
    gradient): losses and trainable parameters agree, frozen parameters do
    not move, and K1 launches 15 times a step and the CTC kernels once each
    way on the card. On the card a twin net takes the same steps through
    the train program (``TrainProgram``: a capture, then replays), held
    against the eager steps bit for bit: losses, parameters, optimizer
    state, generator."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modelargs = MODELARGS[:5] + (0.0,)
    training = {"max_lr": 1e-3, "warmup_ratio": 0.1, "weight_decay": 0.01,
                "gradient_clip_val": 1.0, "accumulate_grad_batches": 1}
    rng = np.random.default_rng(seed + 2)
    cpu_batches = [synthetic_train_batch(rng, 2, 32, "cpu") for _ in range(3)]
    tree = None
    results = {}
    for dev in ("cuda", "cpu"):
        net = AVNet("audiovisual", None, 96, modelargs, VOCAB, whisper_name="whisper-small",
                    precision=L.FP32, device=dev)
        if tree is None:
            tree = random_avnet_params(net, seed)
            for layer in tree["fusion"]["layers"]:
                layer["attn_gate"] = layer["ff_gate"] = np.float32(GATE)
        load_jax_params(net, tree)
        frozen = {n: p.detach().clone() for n, p in net.named_parameters()
                  if not AVNet.trainable_filter(n)}
        task = AVSRTask(net)
        opt, _ = make_optimizer(training, 10, net.trainable_parameters())
        gen = torch.Generator(device=dev).manual_seed(seed)
        if dev == "cuda":
            twin = AVNet("audiovisual", None, 96, modelargs, VOCAB,
                         whisper_name="whisper-small", precision=L.FP32, device=dev)
            load_jax_params(twin, tree)
            twin_opt, _ = make_optimizer(training, 10, twin.trainable_parameters())
            twin_gen = torch.Generator(device=dev).manual_seed(seed)
            program = TrainProgram(AVSRTask(twin), twin_opt, twin_gen, {})
        step_losses = []
        for batch in cpu_batches:
            placed = {k: v.to(dev) for k, v in batch.items()}
            fa.reset_launches()
            losses.reset_launches()
            out = task.train_step(opt, placed, gen)
            if dev == "cuda" and (fa.launches != 15 or losses.launches_by_kernel != CTC_PER_STEP):
                raise AssertionError(f"fp32 train step launched K1 {fa.launches} times, "
                                     "expected 15 (12 encoder + 3 fusion), and the CTC "
                                     f"{dict(losses.launches_by_kernel)}")
            if float(out["skipped"]):
                raise AssertionError(f"fp32 train step on {dev} had a non-finite loss")
            if dev == "cuda":
                fa.reset_launches()
                losses.reset_launches()
                got = program.train_step(placed)
                if fa.launches != 15 or losses.launches_by_kernel != CTC_PER_STEP \
                        or not all(torch.equal(got[k], out[k]) for k in out):
                    raise AssertionError(f"fp32 train program step: K1 {fa.launches} launches, "
                                         f"CTC {dict(losses.launches_by_kernel)}, losses {got} "
                                         f"against the eager step's {out}")
            step_losses.append({k: float(v) for k, v in out.items()})
        if dev == "cuda":
            program_check = same_train_state((net, opt, gen), (twin, twin_opt, twin_gen))
            program_check.update(captures=len(program.captures), replays=program.replays)
            log(f"train fp32 program against the eager step on the card, 3 steps: "
                f"{json.dumps(program_check)}")
            if not program_check["equal"] or program.replays != 3:
                raise AssertionError(f"fp32 train program against the eager step: "
                                     f"{program_check}")
            del twin, twin_opt, program
        for name, param in net.named_parameters():
            if name in frozen and not torch.equal(param, frozen[name]):
                raise AssertionError(f"frozen parameter {name} changed on {dev}")
        results[dev] = (step_losses, {n: p.detach().cpu() for n, p in net.trainable_parameters()},
                        {n: (p.detach().cpu() - torch.from_numpy(np.asarray(
                            _leaf(tree, n)))).abs().max().item()
                         for n, p in net.trainable_parameters()})
        del net, opt, task, frozen
    (l_gpu, p_gpu, moved), (l_cpu, p_cpu, _) = results["cuda"], results["cpu"]
    loss_err = max(abs(a[k] - b[k]) for a, b in zip(l_gpu, l_cpu)
                   for k in ("ctc_loss", "ce_loss", "loss"))
    param_err = max((p_gpu[n] - p_cpu[n]).abs().max().item() for n in p_gpu)
    still = [n for n, d in moved.items() if d == 0.0]
    log(f"train fp32 whisper-small B=2 32 frames, 3 steps: losses card "
        f"{[round(x['loss'], 5) for x in l_gpu]} cpu {[round(x['loss'], 5) for x in l_cpu]}; "
        f"max loss diff {loss_err:.3e} (atol {TRAIN_LOSS_ATOL:g}); max trainable parameter diff "
        f"{param_err:.3e} (atol {TRAIN_PARAM_ATOL:g}); largest move {max(moved.values()):.3e}; "
        f"frozen parameters bit-identical; K1 launches per step 15, CTC 1 + 1")
    if still:
        raise AssertionError(f"trainable parameters that did not move in 3 steps: {still}")
    if not loss_err <= TRAIN_LOSS_ATOL:
        raise AssertionError(f"fp32 train losses card vs CPU differ by {loss_err}")
    if not param_err <= TRAIN_PARAM_ATOL:
        raise AssertionError(f"fp32 trainable parameters card vs CPU differ by {param_err}")
    return {"losses_card": [x["loss"] for x in l_gpu], "losses_cpu": [x["loss"] for x in l_cpu],
            "max_loss_diff": loss_err, "max_param_diff": param_err,
            "largest_param_move": max(moved.values()), "k1_launches_per_step": 15,
            "ctc_launches_per_step": dict(CTC_PER_STEP),
            "program_vs_eager_on_the_card": program_check}


def _leaf(tree, dotted: str):
    node = tree
    for key in dotted.split("."):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


# -- phase 7: the timed train path ------------------------------------------------------


class _RecordingWriter:
    """Stands in for the trainer's TensorBoard writer: keeps the scalars."""

    def __init__(self, path: str):
        self.path, self.scalars = path, []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


class _SyntheticDataModule:
    """The same batch ``steps`` times; the train loader notes the K1 and CTC
    launch counts each time the trainer comes back for a batch."""

    def __init__(self, batch: dict, steps: int):
        self.batch, self.steps, self.launch_marks = dict(batch), steps, []

    def train_dataloader(self):
        dm = self

        class Loader:
            def __len__(self):
                return dm.steps

            def __iter__(self):
                for _ in range(dm.steps):
                    dm.launch_marks.append((fa.launches, losses.launches))
                    yield dict(dm.batch)
                dm.launch_marks.append((fa.launches, losses.launches))

        return Loader()

    def val_dataloader(self):
        return [dict(self.batch, target_text=["synthetic"] * len(self.batch["target_ids"]))]

    test_dataloader = val_dataloader


def make_trainer(name: str, seed: int, workdir: str, overrides: dict) -> tuple[Trainer, dict]:
    """A ``Trainer`` at full width with phase 7's settings (gates at 0.5),
    scalars kept in memory; and its config."""
    config = get_config({
        "training.epochs": 1, "training.accumulate_grad_batches": 1, "training.seed": seed,
        "output.log_every_n_steps": 1, "precision.rematerialize": False,
        "output.checkpoint_dir": os.path.join(workdir, name, "checkpoints"),
        "output.log_dir": os.path.join(workdir, name, "logs"), **overrides})
    net = train_entry.build_net(config, VOCAB, "cuda")
    with torch.no_grad():
        for layer in net.fusion.layers:
            layer.attn_gate.fill_(GATE)
            layer.ff_gate.fill_(GATE)
    trainer = Trainer(config, net, ByteTokenizer())
    trainer.writer = _RecordingWriter(trainer.writer.path)
    return trainer, config


def fit_timed(name: str, seed: int, batch: dict, workdir: str, overrides: dict,
              expected_launches: int, eager: bool = False) -> tuple[dict, Trainer]:
    """``Trainer.fit`` for ``TRAIN_STEPS`` steps on one repeated batch at
    full width; ms per step over the steps after the warm-up. The fit runs
    the train program (its graphs captured in the first step and replayed in
    every step, the eval graph in validation), or with ``eager`` the eager
    step (``step_kind`` set so before the fit: the comparison)."""
    trainer, config = make_trainer(name, seed, workdir, overrides)
    if eager:
        trainer.step_kind = "eager"
    trainer.step_timestamps = []
    dm = _SyntheticDataModule(batch, TRAIN_STEPS)
    gc.collect()  # earlier phases' cyclic garbage (a net and its programs) out of the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(dm, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, ctc_launches = fa.launches, dict(losses.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2**30

    per_step = sorted({(b[0] - a[0], b[1] - a[1])
                       for a, b in zip(dm.launch_marks, dm.launch_marks[1:])})
    if per_step != [(expected_launches, sum(CTC_PER_STEP.values()))]:
        raise AssertionError(f"train path {name}: (K1, CTC) launches per step {per_step}, "
                             f"expected {expected_launches} and {dict(CTC_PER_STEP)}")
    step_loss = {step: v for tag, v, step in trainer.writer.scalars if tag == "train/loss"}
    step_losses = [step_loss[i] for i in range(1, TRAIN_STEPS + 1)]
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"train path {name}: non-finite loss in {step_losses}")
    if any(tag == "train/skipped_steps" for tag, _, _ in trainer.writer.scalars):
        raise AssertionError(f"train path {name}: a step was skipped")
    val = {tag: v for tag, v, _ in trainer.writer.scalars if tag.startswith("val/")}
    if not np.isfinite(val["val/loss"]):
        raise AssertionError(f"train path {name}: validation loss {val}")
    if not os.path.exists(os.path.join(config["output"]["checkpoint_dir"],
                                       f"step_{TRAIN_STEPS}.pt")):
        raise AssertionError(f"train path {name}: no checkpoint was written")
    ts = trainer.step_timestamps
    ms = (ts[-1] - ts[TRAIN_WARMUP - 1]) * 1e3 / (TRAIN_STEPS - TRAIN_WARMUP)
    b = len(batch["target_ids"])
    out = {"step": trainer.step_kind, "train_ms_per_step": ms,
           "train_clips_per_sec": b / (ms * 1e-3),
           "step_ms_each": [(y - x) * 1e3 for x, y in zip(ts, ts[1:])],
           "first_step_s": ts[0] - t0, "peak_mem_gib": peak, "losses": step_losses, "val": val,
           "k1_launches_per_step": expected_launches, "k1_launches_in_fit": launches,
           "ctc_launches_per_step": dict(CTC_PER_STEP), "ctc_launches_in_fit": ctc_launches,
           "fit_s": fit_s}
    if not eager:
        out["program"] = program_record(trainer.program, TRAIN_STEPS)
    log(f"train path {name} bf16 B={b}: " + json.dumps(out))
    return out, trainer


def program_record(program, steps: int) -> dict:
    """A fit's train program: one graph captured per batch shape and
    replayed at every step, validation through the eval graph (raises
    otherwise); the captures' seconds and the pools' bytes."""
    if (program is None or program.replays != steps
            or len(program.captures) != len(program.steps)
            or not program.eval_program.replays):
        raise AssertionError(
            f"the fit did not replay the train program at every step: "
            f"{None if program is None else (program.replays, program.captures)}")
    return {"captures": len(program.captures), "replays": program.replays,
            "keys": len(program.steps),
            "capture_s": [c["capture_s"] for c in program.captures],
            "instantiate_s": [c["instantiate_s"] for c in program.captures],
            "launches_per_replay": [{"k1": c["k1_launches"], "ctc": c["ctc_launches"]}
                                    for c in program.captures],
            "pool_bytes": pool_bytes(program), "eval_pool_bytes": pool_bytes(program.eval_program),
            "eval_captures": len(program.eval_program.captures),
            "eval_replays": program.eval_program.replays}


def step_breakdown(trainer: Trainer, batch: dict, iters: int = 3) -> dict:
    """One replayed train step, the single graph: ``step_ms`` between CUDA
    events around the whole step (the batch's copies into the graph's
    inputs, then the replay; the device timeline, idle gaps included) and
    ``host_ms`` on the host's clock, mean of ``iters`` steps; ``profile``:
    one whole replayed step under ``torch.profiler`` (device busy share; a
    replayed kernel carries no PyTorch op name), with K1's 15 launches and
    the CTC kernels' two credited to it."""
    program = trainer.program
    out = {"step_ms": 0.0, "host_ms": 0.0}
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        program.train_step(batch)
        out["host_ms"] += (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        torch.cuda.synchronize()
        out["step_ms"] += start.elapsed_time(end) / iters
    fa.reset_launches()
    losses.reset_launches()
    out["profile"] = profile(lambda: program.train_step(batch), top=8, cpu=False)
    out["ctc_launches"] = dict(losses.launches_by_kernel)
    if sum(out["profile"]["k1_launches_by_kernel"].values()) != 15 \
            or losses.launches_by_kernel != CTC_PER_STEP:
        raise AssertionError(f"profiled replayed train step ran K1 "
                             f"{out['profile']['k1_launches_by_kernel']}, expected 15, and "
                             f"the CTC {out['ctc_launches']}")
    log("replayed train step, one graph: " + json.dumps(out))
    return out


def sync_report(trainer: Trainer, batch: dict) -> dict:
    """One replayed train step under ``torch.cuda.set_sync_debug_mode("warn")``:
    every synchronising call it makes, with the innermost frames of the
    repository's code and of ``torch`` that made it. Raises on any: the step
    reads nothing back, as the JAX step reads nothing back but its guard's
    decision, which here stays on the card too."""
    import traceback
    import warnings

    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return  # the mode's own notice that it is a prototype
        stack = traceback.extract_stack()[:-1]
        found.append([f"{os.path.basename(f.filename)}:{f.lineno} {f.name}" for f in stack
                      if "mocov2_whisper_flamingo_torch" in f.filename
                      or "/torch/" in f.filename][-4:])

    trainer.program.train_step(batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.program.train_step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {"syncs": len(found), "calls": found}
    log("synchronising calls in one replayed train step: " + json.dumps(out))
    if found:
        raise AssertionError(f"a replayed train step synchronised: {out}")
    return out


def program_turns(trainer: Trainer, batch: dict, seed: int, workdir: str,
                  steps: int = 3) -> dict:
    """``trainer`` (phase 7's dropout-0 fit: its graphs captured) and an
    eager twin loaded with its state take ``steps`` more steps on the batch,
    in turns (program, eager, eager, program, ...), each followed by the
    scalars logged as the fits log them and a synchronisation: ms per step
    of each, the losses of every step and the parameters, optimizer state
    and generator after the last held bit for bit (raises otherwise)."""
    twin, _ = make_trainer("dropout_0_twin", seed, workdir, {"model.dropout": 0.0})
    twin.step_kind = "eager"
    twin.setup(TRAIN_STEPS)
    twin.net.load_state_dict(trainer.net.state_dict())
    twin.optimizer.load_state_dict(trainer.optimizer.state_dict())
    twin.generator.set_state(trainer.generator.get_state())
    twin.global_step = trainer.global_step
    legs = {"program": (trainer, lambda: trainer.program.train_step(batch)),
            "eager": (twin, lambda: twin.task.train_step(twin.optimizer, batch, twin.generator))}
    ms = {name: [] for name in legs}
    losses = {name: [] for name in legs}
    for i in range(steps):
        for name in (("program", "eager") if i % 2 == 0 else ("eager", "program")):
            owner, step = legs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = step()
            owner.global_step += 1
            owner._log_train(got)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            losses[name].append(got)
    equal_losses = [all(torch.equal(a[k], b[k]) for k in a)
                    for a, b in zip(losses["program"], losses["eager"])]
    state = same_train_state((trainer.net, trainer.optimizer, trainer.generator),
                             (twin.net, twin.optimizer, twin.generator))
    out = {"program_ms_per_step": ms["program"], "eager_ms_per_step": ms["eager"],
           "losses_bit_equal": equal_losses, "state_after": state,
           "count": trainer.optimizer.count, "mini_step": trainer.optimizer.mini_step,
           "losses": [float(x["loss"]) for x in losses["program"]]}
    log("train step, program and eager in turns (bf16 B=4, dropout 0, scalars logged each "
        "step): " + json.dumps(out))
    if not all(equal_losses) or not state["equal"] \
            or twin.optimizer.count != trainer.optimizer.count:
        raise AssertionError(f"bf16 train program against the eager step: {out}")
    return out


CTC_LABEL_LENGTHS = (TARGET_TOKENS, TARGET_TOKENS - 9, 17, 0)
CTC_SHORT_INPUT = 40  # frames: row 1's 55 labels (and their adjacent repeats) do not fit


def ctc_bound(in_len, lab_len) -> dict:
    """The least time the CTC pair could take on the card at these lengths:
    the bytes it must move at 3.35 TB/s (the emissions each row's lattice
    reads, the labels and lengths, the NLL and its gradient, and the dense
    gradient by the log-probabilities, written once) against its operations
    (~30 a lattice position a frame, both ways) at the fp32 rate. The chain
    of ``T - 1`` dependent steps, which neither counts, is given beside."""
    frames = torch.clamp(in_len.long(), 1, T_VIDEO)
    positions = 2 * lab_len.long() + 1
    emissions = int((frames * positions).sum())
    nbytes = (4 * emissions + 8 * B * TARGET_TOKENS + 2 * 8 * B + 2 * 4 * B
              + 4 * B * T_VIDEO * VOCAB)
    ops = 30 * 2 * emissions
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[torch.float32] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops, "chain_steps": T_VIDEO - 1}


def time_ctc(seed: int) -> dict:
    """The CTC kernel pair (``losses.ctc_nll`` on the card) at the train
    path's shape ``[B, T_VIDEO, VOCAB]``, 64 labels with repeats, label
    lengths ``CTC_LABEL_LENGTHS``: against autograd through the recursion in
    torch ops (``ctc_forward_log_probs``) on the same logits, the NLL masked
    as ``zero_infinity`` masks it (NLL within 2e-2, the logits' gradient
    within 1e-2); two kernel runs bit for bit; a row made infeasible (its
    input cut to ``CTC_SHORT_INPUT`` frames) with a gradient of exactly 0;
    and the pair's time on fixed log-probabilities (forward and backward)
    beside its bound, the recursion's (plain) and ``F.ctc_loss``'s
    (library, the yardstick no path calls)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((B, T_VIDEO, VOCAB), generator=gen).to(dev)
    labels = torch.from_numpy(repeated_labels(np.random.default_rng(seed).integers(
        1, VOCAB, (B, TARGET_TOKENS)))).to(dev)
    in_len = torch.full((B,), AUDIO_FRAMES, dtype=torch.int32, device=dev)
    lab_len = torch.tensor(CTC_LABEL_LENGTHS, dtype=torch.int32, device=dev)

    def grads(nll_fn, inputs=in_len):
        x = logits.clone().requires_grad_()
        nll = nll_fn(torch.log_softmax(x, dim=-1), labels, inputs, lab_len)
        kept = torch.where(nll >= losses.INFEASIBLE, 0.0, nll)
        (grad,) = torch.autograd.grad(kept.sum(), x)
        return nll.detach(), grad

    losses.reset_launches()
    nll, grad = grads(losses.ctc_nll)
    again = grads(losses.ctc_nll)
    short = in_len.clone()
    short[1] = CTC_SHORT_INPUT
    short_nll, short_grad = grads(losses.ctc_nll, short)
    torch.cuda.synchronize()
    launched = dict(losses.launches_by_kernel)
    plain_nll, plain_grad = grads(losses.ctc_forward_log_probs)
    out = {"shape": [B, T_VIDEO, VOCAB], "labels": TARGET_TOKENS,
           "label_lengths": list(CTC_LABEL_LENGTHS), "nll": nll.tolist(),
           "max_nll_diff": (nll - plain_nll).abs().max().item(),
           "max_grad_diff": (grad - plain_grad).abs().max().item(),
           "bit_equal_runs": torch.equal(nll, again[0]) and torch.equal(grad, again[1]),
           "infeasible_row": {"input_frames": CTC_SHORT_INPUT, "nll": short_nll[1].item(),
                              "gradient_all_zero": not short_grad[1].any().item(),
                              "others_unchanged": torch.equal(short_nll[[0, 2, 3]],
                                                              nll[[0, 2, 3]]),
                              "finite": bool(torch.isfinite(short_grad).all())},
           "launches": launched}

    lp = torch.log_softmax(logits, dim=-1)
    ones = torch.ones((B,), device=dev)

    def pair(nll_fn):
        def run():
            x = lp.detach().requires_grad_()
            torch.autograd.grad(nll_fn(x, labels, in_len, lab_len), x, ones)
        return run

    def forward():
        with torch.no_grad():
            losses.ctc_nll(lp, labels, in_len, lab_len)

    library = pair(lambda *a: losses.ctc_native_nll(*a, zero_infinity=True))
    out.update(ms=cuda_ms(pair(losses.ctc_nll), 20), device_ms=device_ms(pair(losses.ctc_nll))[0],
               forward_device_ms=device_ms(forward)[0],
               plain_ms=cuda_ms(pair(losses.ctc_forward_log_probs), 1),
               library_ms=cuda_ms(library, 20), library_device_ms=device_ms(library)[0],
               **ctc_bound(in_len, lab_len))
    log("CTC kernels on the card: " + json.dumps(out))
    # Random logits over 51 865 classes: NLL ~4000, so alpha and beta are of
    # that size in fp32 (ulp 2.4e-4 to 4.9e-4) and an occupancy exp(alpha +
    # beta - ll) of size 1 carries their rounding, ~1e-3, into the gradient.
    infeasible = out["infeasible_row"]
    if (launched != {"ctc_forward": 3, "ctc_backward": 3} or not out["max_nll_diff"] <= 2e-2
            or not out["max_grad_diff"] <= 1e-2 or not out["bit_equal_runs"]
            or not infeasible["nll"] >= losses.INFEASIBLE
            or not infeasible["gradient_all_zero"] or not infeasible["others_unchanged"]
            or not infeasible["finite"]):
        raise AssertionError(f"the CTC kernels against the recursion: {out}")
    return out


def run_train_path(seed: int) -> dict:
    dev = torch.device("cuda")
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    rng = np.random.default_rng(seed + 3)
    batch = synthetic_train_batch(rng, B, T_VIDEO, dev)
    raw_batch = synthetic_train_batch(rng, B, T_VIDEO, dev, augmentable=True)
    out = {"shape": {"batch": B, "mel": [B, 3000, 80], "video": list(batch["video"].shape),
                     "target_tokens": TARGET_TOKENS, "audio_lengths": AUDIO_FRAMES,
                     "steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "precision": "bf16",
                     "accumulate_grad_batches": 1}}
    try:
        out["dropout_0.1"], trainer = fit_timed("dropout_0.1", seed, batch, workdir, {}, 12)
        del trainer  # each fit's peak memory is its own
        out["dropout_0"], trainer = fit_timed("dropout_0", seed, batch, workdir,
                                              {"model.dropout": 0.0}, 15)
        first, last = out["dropout_0"]["losses"][0], out["dropout_0"]["losses"][5]
        if not last < first:
            raise AssertionError(f"dropout 0 on a repeated batch: loss {last} at step 6 is not "
                                 f"below {first} at step 1")
        out["step_parts"] = step_breakdown(trainer, batch)
        out["sync_report"] = sync_report(trainer, batch)
        fa.reset_launches()
        losses.reset_launches()
        trainer.program.eval_step(batch)
        torch.cuda.synchronize()
        out["eval_step_launches"] = {"k1": fa.launches, "ctc": dict(losses.launches_by_kernel)}
        if out["eval_step_launches"] != {"k1": 15, "ctc": {"ctc_forward": 1}}:
            raise AssertionError(f"a replayed eval step launched {out['eval_step_launches']}")
        out["turns"] = program_turns(trainer, batch, seed, workdir)
        fa.reset_launches()
        out["eager_profile"] = profile(lambda: trainer.task.train_step(
            trainer.optimizer, batch, trainer.generator), top=10)
        if sum(out["eager_profile"]["k1_launches_by_kernel"].values()) != 15:
            raise AssertionError(f"profiled eager train step ran K1 "
                                 f"{out['eager_profile']['k1_launches_by_kernel']}, expected 15")
        del trainer
        for name, overrides, launches, eager in (
                ("dropout_0_eager", {"model.dropout": 0.0}, 15, True),
                ("dropout_0_remat", {"model.dropout": 0.0, "precision.rematerialize": True},
                 18, False),
                ("dropout_0.1_augment", {"augmentation.on_device": True}, 12, False)):
            out[name], trainer = fit_timed(name, seed, raw_batch if "augment" in name else batch,
                                           workdir, overrides, launches, eager=eager)
            del trainer
        out["program_vs_eager_fit"] = {
            key: (out["dropout_0"][key], out["dropout_0_eager"][key])
            for key in ("train_ms_per_step", "peak_mem_gib", "first_step_s")}
        out["augment_ms_per_step"] = (out["dropout_0.1_augment"]["train_ms_per_step"]
                                      - out["dropout_0.1"]["train_ms_per_step"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["ctc"] = time_ctc(seed)
    return out

# -- phase 8: the AV engine ------------------------------------------------------------------


def av_payload(rng) -> tuple:
    """One request in the AV engine's convention, on the host: 30 s of
    log-mel, 400 raw uint8 88x88 lip frames, masks, the frame count."""
    return (rng.standard_normal((3000, 80)).astype(np.float32), np.ones(3000, bool),
            rng.integers(0, 255, (T_VIDEO, 3, 88, 88), dtype=np.uint8),
            np.ones(T_VIDEO, bool), np.int32(T_VIDEO))


def direct_av_rows(net, payloads, bucket: int, max_len: int,
                   decoder=None) -> list[np.ndarray]:
    """The engine's decode of one padded bucket, made by hand: the same
    collate and encode (the video pipeline inside, the engine's encode
    graph) on the caller's stream, then the eager ``beam_search`` over
    ``decoder`` (prepared from ``net``'s), or without one ``net``'s decode
    program, as the engine decodes."""
    dev = next(net.parameters()).device
    batch = tuple(torch.as_tensor(x).to(dev) for x in pad_rows(payloads, bucket))
    feats, valid = net.encode(batch, video_resize=64)
    kw = dict(beam_size=BEAM, max_len=max_len, eos_id=EOS)
    if decoder is None:
        res = net.decode_programs.beam(feats, valid, PREFIX, **kw)
    else:
        res = beam_search(decoder, feats, PREFIX, encoder_valid=valid, **kw)
    rows = res.sequences[:, 0].cpu().numpy()
    return [trim_at_eos(row, EOS, len(PREFIX)) for row in rows[:len(payloads)]]


def captures_by_rows(programs, since: int = 0) -> dict:
    """Capture and instantiation seconds of a ``DecodePrograms``' graphs
    captured after its first ``since``, by rows (the bucket)."""
    return {str(c["shape"][0]): {"capture_s": c["capture_s"], "instantiate_s": c["instantiate_s"]}
            for c in programs.captures[since:]}


def percentiles(values) -> dict:
    return {"p50": float(np.median(values)), "max": float(np.max(values))}


def launches_by_mask(counter) -> dict:
    """K1 launches by (key mask, causal) over every block size, from the
    wrapper's per-instantiation counts."""
    out: dict[str, int] = {}
    for name, n in counter.items():
        mask, causal = re.search(r"(true|false), (true|false)>$", name).groups()
        key = ("masked" if mask == "true" else "unmasked") + ("_causal" if causal == "true"
                                                              else "")
        out[key] = out.get(key, 0) + n
    return out


def small_av_net(seed: int, device) -> AVWhisperNet:
    """whisper-small width with 2 + 2 Whisper layers in fp32, fusion gates at
    GATE: the depth of the fp32 card-vs-CPU checks."""
    cfg = dataclasses.replace(config_for("whisper-small"), encoder_layers=2, decoder_layers=2)
    net = AVWhisperNet(modelargs=MODELARGS, vocab_size=VOCAB, precision=L.FP32, device=device,
                       whisper_config=cfg)
    tree = random_jax_params(net, seed)
    for layer in tree["trunk"]["fusion"]["layers"]:
        layer["attn_gate"] = layer["ff_gate"] = np.float32(GATE)
    return load_jax_params(net, tree).eval()


def run_av_engine(seed: int) -> dict:
    """``make_av_engine`` at full width on the card: warm-up (each bucket's
    decode program captured), nine requests submitted at once, every row
    against the eager loop of its padded bucket; then three requests in fp32
    through a shallow engine on the card (graphs) and one on the CPU (the
    eager loop)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 4)
    payloads = [av_payload(rng) for _ in range(AV_REQUESTS)]
    net = build(seed, L.BF16, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' pools, so that "reserved" is this phase's
    torch.cuda.reset_peak_memory_stats()
    out = {"buckets": list(AV_BUCKETS), "requests": AV_REQUESTS, "max_len": MAX_TOKENS,
           "reserved_gib_before_warmup": torch.cuda.memory_reserved() / 2**30}
    with make_av_engine(net, PREFIX, beam_size=BEAM, max_len=MAX_TOKENS, eos_id=EOS,
                        buckets=AV_BUCKETS, max_wait_s=0.05) as eng:
        t0 = time.perf_counter()
        eng.warmup(payloads[0])
        out["warmup_s"] = time.perf_counter() - t0
        out["reserved_gib_after_warmup"] = torch.cuda.memory_reserved() / 2**30
        out["capture_by_bucket"] = captures_by_rows(net.decode_programs)
        out["graph_pool_bytes"] = pool_bytes(net.decode_programs)
        out["encode_capture_by_bucket"] = captures_by_rows(net.encode_program)
        out["encode_pool_bytes"] = pool_bytes(net.encode_program)
        eng.batch_log.clear()
        fa.reset_launches()
        t0 = time.perf_counter()
        futures = [eng.submit(*p) for p in payloads]
        results = [f.result(timeout=WAIT_S) for f in futures]
        wall_s = time.perf_counter() - t0
        launches, by_kernel = fa.launches, dict(fa.launches_by_kernel)
        stats, batches = eng.stats(), list(eng.batch_log)
    out["reserved_gib_after_traffic"] = torch.cuda.memory_reserved() / 2**30
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30

    expected_batches = [4, 4, 1]
    if [b["bucket"] for b in batches] != expected_batches or stats["batches"] != 3:
        raise AssertionError(f"AV engine batched {[b['bucket'] for b in batches]}, expected "
                             f"{expected_batches}; stats {stats}")
    if stats["requests"] != AV_REQUESTS or sum(stats["bucket_counts"].values()) != 3:
        raise AssertionError(f"AV engine stats do not add up: {stats}")
    buckets = [str(b) for b in sorted(AV_BUCKETS)]
    if stats["compiled_buckets"] != sorted(AV_BUCKETS) \
            or sorted(out["capture_by_bucket"], key=int) != buckets \
            or sorted(out["encode_capture_by_bucket"], key=int) != buckets \
            or len(net.decode_programs.captures) != len(AV_BUCKETS) \
            or len(net.encode_program.captures) != len(AV_BUCKETS):
        raise AssertionError(f"warm-up marked {stats['compiled_buckets']} and captured "
                             f"{net.decode_programs.captures} and {net.encode_program.captures};"
                             " traffic must only replay")
    by_mask = launches_by_mask(by_kernel)
    if launches != 45 or by_mask != {"unmasked": 36, "masked": 9}:
        raise AssertionError(f"AV engine launched K1 {launches} times over 3 batches "
                             f"({by_kernel}), expected 3 x (12 encoder + 3 fusion)")
    # Each row against the eager loop of the same padded bucket (timed, as
    # this run's yardstick for the engine's decode_ms).
    start = 0
    direct_ms: dict[str, list] = {}
    decoder = net.decoder.prepare_decode_params()
    for count in expected_batches:
        group = payloads[start:start + count]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = direct_av_rows(net, group, count, MAX_TOKENS, decoder)
        direct_ms.setdefault(str(count), []).append((time.perf_counter() - t0) * 1e3)
        for i, want in enumerate(direct):
            got = results[start + i]
            if got.bucket != count or not np.array_equal(got.tokens, want):
                raise AssertionError(f"AV engine request {start + i} (bucket {got.bucket}) "
                                     f"differs from the eager loop of its bucket:\n"
                                     f"{got.tokens}\n{want}")
        start += count
    hidden = [max(0.0, min(nxt["t_dispatch"], cur["t_ready"]) - nxt["t_collate"]) * 1e3
              for cur, nxt in zip(batches, batches[1:])]
    out.update({
        "wall_s": wall_s, "audio_seconds_per_second": AV_REQUESTS * SECONDS_PER_CLIP / wall_s,
        "queue_ms": percentiles([r.queue_ms for r in results]),
        "decode_ms": percentiles([r.decode_ms for r in results]),
        "total_ms": percentiles([r.total_ms for r in results]),
        "decode_ms_by_bucket": {str(b["bucket"]): [] for b in batches},
        "eager_decode_ms_by_bucket": direct_ms,
        "collate_ms_per_batch": [(b["t_dispatch"] - b["t_collate"]) * 1e3 for b in batches],
        "h2d_host_ms_per_batch": [(b["t_copied"] - b["t_dispatch"]) * 1e3 for b in batches],
        "h2d_device_ms_per_batch": [b["h2d_device_ms"] for b in batches],
        "launch_ms_per_batch": [(b["t_launched"] - b["t_copied"]) * 1e3 for b in batches],
        "device_tail_ms_per_batch": [(b["t_ready"] - b["t_launched"]) * 1e3 for b in batches],
        "collate_ms_hidden_under_previous_batch": hidden,
        "k1_launches_per_batch": launches // 3, "k1_launches_by_kernel": by_kernel,
        "bucket_counts": stats["bucket_counts"], "rows_equal_eager_loop": True})
    for b in batches:
        out["decode_ms_by_bucket"][str(b["bucket"])].append((b["t_ready"] - b["t_dispatch"]) * 1e3)
    log("AV engine bf16 buckets (1, 4), 9 requests: " + json.dumps(out))
    del net

    # fp32, shallow, three requests: the card's engine against the CPU's.
    rows = {}
    for device in ("cuda", "cpu"):
        net = small_av_net(seed, device)
        fa.reset_launches()
        with make_av_engine(net, PREFIX, beam_size=BEAM, max_len=24, eos_id=EOS, buckets=(4,),
                            max_wait_s=0.2) as eng:
            futures = [eng.submit(*p) for p in payloads[:3]]
            rows[device] = [f.result(timeout=WAIT_S) for f in futures]
        if device == "cuda" and fa.launches != 5:
            raise AssertionError(f"the shallow fp32 engine launched K1 {fa.launches} times, "
                                 "expected 5 (2 encoder + 3 fusion)")
        del net
    same = all(a.bucket == b.bucket == 4 and np.array_equal(a.tokens, b.tokens)
               for a, b in zip(rows["cuda"], rows["cpu"]))
    log(f"AV engine fp32 (2 + 2 Whisper layers, bucket 4, 24 tokens), 3 requests: tokens "
        f"identical card vs CPU: {same}")
    if not same:
        raise AssertionError("fp32 AV engine tokens differ card vs CPU:\n"
                             f"{[r.tokens for r in rows['cuda']]}\n"
                             f"{[r.tokens for r in rows['cpu']]}")
    out["fp32_card_vs_cpu_tokens_identical"] = True
    return out


# -- phase 9: the audio server over HTTP ----------------------------------------------------


def http_json(address, method: str, path: str, body: dict | None = None) -> tuple[int, dict]:
    conn = http.client.HTTPConnection(*address, timeout=WAIT_S)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def run_audio_server(seed: int) -> dict:
    """``WhisperASR`` behind ``make_audio_engine`` and ``TranscriptionServer``
    on a loopback port of this machine: health, three sequential requests
    against the eager loop at B=1 under the same logit rules (the engine
    replays each bucket's decode program, captured at warm-up), six
    concurrent ones, the metrics."""
    rng = np.random.default_rng(seed + 5)
    asr = WhisperASR("whisper-small", precision=L.BF16, device="cuda")
    load_jax_params(asr, random_asr_params(asr, seed)).eval()
    rules = LogitRules(vocab_size=VOCAB, suppress=(1, 2, 7, 8, 9, 10, 14, 25, 50257 + 1),
                       begin_suppress=(220, EOS), timestamp_begin=TIMESTAMP_BEGIN,
                       no_timestamps_id=NO_TIMESTAMPS, eos_id=EOS)
    n_req = ASR_SEQUENTIAL + ASR_CONCURRENT
    wavs = [(0.1 * rng.standard_normal(16_000 * (2 + i))).astype(np.float32)
            for i in range(n_req)]
    decoder = asr.decoder.prepare_decode_params()  # the eager reference's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' pools, so that "reserved" is this phase's
    out = {"buckets": list(ASR_BUCKETS), "max_len": ASR_MAX_TOKENS,
           "reserved_gib_before_warmup": torch.cuda.memory_reserved() / 2**30}
    with make_audio_engine(asr, ASR_PREFIX, beam_size=BEAM, max_len=ASR_MAX_TOKENS, eos_id=EOS,
                           logit_rules=rules, buckets=ASR_BUCKETS, max_wait_s=0.05) as eng:
        t0 = time.perf_counter()
        eng.warmup((canonical_wav(wavs[0]),))
        out["warmup_s"] = time.perf_counter() - t0
        out["reserved_gib_after_warmup"] = torch.cuda.memory_reserved() / 2**30
        out["capture_by_bucket"] = captures_by_rows(asr.decode_programs)
        out["graph_pool_bytes"] = pool_bytes(asr.decode_programs)
        out["encode_capture_by_bucket"] = captures_by_rows(asr.encode_program)
        out["encode_pool_bytes"] = pool_bytes(asr.encode_program)
        buckets = [str(b) for b in sorted(ASR_BUCKETS)]
        if sorted(out["capture_by_bucket"], key=int) != buckets \
                or sorted(out["encode_capture_by_bucket"], key=int) != buckets:
            raise AssertionError(f"audio warm-up captured {asr.decode_programs.captures} and "
                                 f"the encode {asr.encode_program.captures}")
        with TranscriptionServer(eng, host="127.0.0.1", port=0) as srv:
            address = srv.address
            status, body = http_json(address, "GET", "/healthz")
            if (status, body) != (200, {"ok": True}):
                raise AssertionError(f"/healthz answered {status} {body}")
            sequential, launches_per_batch = [], set()
            for i in range(ASR_SEQUENTIAL):
                payload = ({"audio": wavs[i].tolist()} if i % 2 == 0 else
                           {"audio_b64": base64.b64encode(wavs[i].tobytes()).decode()})
                fa.reset_launches()
                t0 = time.perf_counter()
                status, body = http_json(address, "POST", "/v1/transcribe", payload)
                http_ms = (time.perf_counter() - t0) * 1e3
                if status != 200 or body["bucket"] != 1:
                    raise AssertionError(f"request {i}: {status} {body}")
                by_mask = launches_by_mask(fa.launches_by_kernel)
                if fa.launches != 12 or by_mask != {"unmasked": 12}:
                    raise AssertionError(f"an audio batch launched K1 {fa.launches} times "
                                         f"({dict(fa.launches_by_kernel)}), expected 12")
                launches_per_batch.add(fa.launches)
                enc = asr.encode(asr.features(canonical_wav(wavs[i])[None]))
                want = beam_search(decoder, enc, ASR_PREFIX, beam_size=BEAM,
                                   max_len=ASR_MAX_TOKENS, eos_id=EOS, logit_rules=rules)
                want = trim_at_eos(want.sequences[0, 0].cpu().numpy(), EOS, len(ASR_PREFIX))
                if body["tokens"] != [int(t) for t in want]:
                    raise AssertionError(f"request {i} over HTTP differs from the eager loop "
                                         f"at B=1:\n{body['tokens']}\n{want.tolist()}")
                first = body["tokens"][len(ASR_PREFIX)]
                if not TIMESTAMP_BEGIN <= first <= TIMESTAMP_BEGIN + 1:
                    raise AssertionError(f"request {i}: the first generated token {first} "
                                         "breaks the timestamp grammar")
                if set(body["tokens"][len(ASR_PREFIX):]) & set(rules.suppress):
                    raise AssertionError(f"request {i} emitted a suppressed token")
                sequential.append({"http_ms": http_ms, **{k: body[k] for k in
                                                           ("queue_ms", "decode_ms", "total_ms")}})
            answers: dict[int, tuple] = {}

            def client(i):
                answers[i] = http_json(address, "POST", "/v1/transcribe",
                                       {"audio_b64": base64.b64encode(wavs[i].tobytes()).decode()})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(ASR_SEQUENTIAL, n_req)]
            fa.reset_launches()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            concurrent_s = time.perf_counter() - t0
            if any(t.is_alive() for t in threads) or len(answers) != ASR_CONCURRENT:
                raise AssertionError("a concurrent HTTP request did not come back")
            bad = {i: a for i, a in answers.items() if a[0] != 200}
            if bad:
                raise AssertionError(f"concurrent requests failed: {bad}")
            concurrent_launches = fa.launches
            concurrent_by_mask = launches_by_mask(fa.launches_by_kernel)
            status, metrics = http_json(address, "GET", "/metrics")
            if status != 200 or metrics["requests"] != n_req:
                raise AssertionError(f"/metrics counts {metrics}, expected {n_req} requests")
            concurrent_batches = metrics["batches"] - ASR_SEQUENTIAL
            if concurrent_batches < 1 or concurrent_launches != 12 * concurrent_batches \
                    or concurrent_by_mask != {"unmasked": concurrent_launches}:
                raise AssertionError(f"{concurrent_batches} concurrent audio batches launched K1 "
                                     f"{concurrent_launches} times ({concurrent_by_mask}), "
                                     "expected 12 a batch")
            launches_per_batch.add(concurrent_launches // concurrent_batches)
            status, err = http_json(address, "POST", "/v1/transcribe", {"nope": 1})
            if status != 400:
                raise AssertionError(f"a bad body answered {status} {err}")
        if len(asr.decode_programs.captures) != len(ASR_BUCKETS):
            raise AssertionError(f"traffic captured again: {asr.decode_programs.captures}")
    out["reserved_gib_after_traffic"] = torch.cuda.memory_reserved() / 2**30
    concurrent_audio_s = sum(len(wavs[i]) for i in range(ASR_SEQUENTIAL, n_req)) / 16_000
    out.update({"sequential": sequential, "concurrent_wall_s": concurrent_s,
                "concurrent_audio_seconds_per_second": concurrent_audio_s / concurrent_s,
                "concurrent_total_ms": percentiles([a[1]["total_ms"] for a in answers.values()]),
                "concurrent_buckets": sorted(a[1]["bucket"] for a in answers.values()),
                "bucket_counts": metrics["bucket_counts"], "latency_ms": metrics["latency_ms"],
                "concurrent_batches": concurrent_batches,
                "concurrent_k1_launches": concurrent_launches})
    # One measured value over the sequential and the concurrent batches, at
    # every bucket they used.
    (out["k1_launches_per_batch"],) = launches_per_batch
    log("audio server bf16 beam 5, 64 tokens, logit rules, over HTTP: " + json.dumps(out))
    return out


# -- phase 10: teacher forcing -----------------------------------------------------------------


def run_teacher_forcing(seed: int) -> dict:
    """``AVWhisperNet.decoder_logits`` at B=4 with 160 target tokens: K1's
    launches by instantiation and the time per call in bf16; in fp32 the
    logits at every position against the cached ``decode_step``'s."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 6)
    mel, raw = make_batch(rng, B, T_VIDEO, dev)
    target = torch.from_numpy(rng.integers(0, VOCAB, (B, FORCED_TOKENS))).to(dev)
    net = build(seed, L.BF16, dev)
    batch = preprocess(mel, raw)
    net.decoder_logits(batch, target)  # warm-up
    fa.reset_launches()
    logits = net.decoder_logits(batch, target)
    torch.cuda.synchronize()
    launches, by_kernel = fa.launches, dict(fa.launches_by_kernel)
    by_mask = launches_by_mask(by_kernel)
    if launches != 39 or by_mask != {"unmasked": 12, "masked": 15, "unmasked_causal": 12}:
        raise AssertionError(f"decoder_logits launched K1 {launches} times ({by_kernel}), "
                             "expected 12 encoder + 3 fusion + 12 causal + 12 cross")
    if tuple(logits.shape) != (B, FORCED_TOKENS, VOCAB) or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"bad teacher-forced logits: {logits.dtype} {tuple(logits.shape)}")
    features, valid = net.encode(batch)
    forward = lambda: net.decoder(target, features, encoder_valid=valid)
    decoder_ms = cuda_ms(forward, 5)
    decoder_device_ms, decoder_kernels = device_ms(forward, iters=5)
    total_ms = cuda_ms(lambda: net.decoder_logits(batch, target), 5)
    out = {"shape": [B, FORCED_TOKENS], "k1_launches": launches, "k1_launches_by_kernel": by_kernel,
           "decoder_logits_ms": total_ms, "decoder_forward_ms": decoder_ms,
           "decoder_forward_device_ms": decoder_device_ms,
           "decoder_forward_kernels": decoder_kernels}
    del net, logits, features

    net = build(seed, L.FP32, dev)
    features, valid = net.encode(batch)
    decoder = net.decoder.prepare_decode_params()
    full = decoder(target, features, encoder_valid=valid)
    cache = decoder.init_cache(features, max_len=FORCED_TOKENS)
    err = 0.0
    for i in range(FORCED_TOKENS):
        step, cache = decoder.decode_step(target[:, i:i + 1], cache, i, valid)
        err = max(err, (step - full[:, i]).abs().max().item())
    scale = full.abs().max().item()
    out.update({"fp32_max_abs_err_vs_decode_step": err, "fp32_largest_logit": scale,
                "fp32_atol": FORCED_LOGIT_RTOL * scale})
    log("teacher forcing B=4, 160 tokens: " + json.dumps(out))
    if not err <= FORCED_LOGIT_RTOL * scale:
        raise AssertionError(f"fp32 teacher-forced logits differ from decode_step's by {err} "
                             f"(atol {FORCED_LOGIT_RTOL * scale:.3g})")
    return out


# -- phases 11 and 12: shared --------------------------------------------------------------


def small_features(seed: int, cpu_batches) -> dict:
    """The fp32 small-depth model and its encoded ``(features, valid)`` of
    each host batch, on the card and on the CPU."""
    out = {}
    for device in ("cuda", "cpu"):
        net = small_av_net(seed, device)
        feats = [net.encode(preprocess(mel.to(device), raw.to(device)))
                 for mel, raw in cpu_batches]
        out[device] = (net.decoder.prepare_decode_params(), feats)
        del net
    return out


# -- phase 11: the streaming decode ----------------------------------------------------------


class EagerChunks(StreamingDecoder):
    """The streaming decoder with its plain chunk on the card, for the
    in-turns comparison with the replayed graph."""

    def _run_chunk(self, encoder_out, encoder_valid, i0, n_prime, begin_index):
        return self._chunk(encoder_out, encoder_valid, torch.tensor(i0, device=self.device),
                           n_prime, begin_index)


def same_stream_state(a: StreamingDecoder, b: StreamingDecoder) -> bool:
    """Two streaming decoders' buffers, position and transcript bit for bit."""
    return a.tokens == b.tokens and all(
        (x == y) if isinstance(x, int) else torch.equal(x, y) for x, y in zip(a._state, b._state))


def graph_summary(graphs, since: int = 0) -> dict:
    """Capture records of a ``GraphPool`` after its first ``since``, its
    replays and its pool's bytes."""
    return {"captures": graphs.captures[since:], "replays": graphs.replays,
            "pool_bytes": pool_bytes(graphs)}


def chunk_turns(stream: StreamingDecoder, feats: list) -> dict:
    """The replayed chunk (``stream``, captured) and the eager chunk on the
    card in turns over the same chunks, from the same fresh window: decode
    ms of each per chunk, and both decoders' state bit for bit after each;
    then one more replayed chunk under the profiler."""
    stream.reset()
    plain = EagerChunks(stream.decoder, PREFIX, max_len=STREAM_MAX_LEN, eos_id=EOS,
                        max_tokens_per_chunk=STREAM_TOKENS, beam_size=BEAM)
    captures = len(stream.graphs.captures)
    ms = {"graph": [], "eager": []}
    equal = []
    for i, (f, v) in enumerate(feats):
        order = (("graph", stream), ("eager", plain))
        for name, sd in (order if i % 2 == 0 else order[::-1]):
            _, wall_s = timed_call(lambda: sd.process_chunk(f, encoder_valid=v, collect=False))
            ms[name].append(wall_s * 1e3)
        equal.append(same_stream_state(stream, plain))
    if not all(equal) or len(stream.graphs.captures) != captures:
        raise AssertionError(f"bf16 streaming chunk graph against the eager chunk, bit-equal: "
                             f"{equal}; captures {stream.graphs.captures[captures:]}")
    out = {"chunks": len(feats), "graph_ms_per_chunk": ms["graph"],
           "eager_ms_per_chunk": ms["eager"],
           "graph_ms_per_step": [x / STREAM_TOKENS for x in ms["graph"]],
           "eager_ms_per_step": [x / STREAM_TOKENS for x in ms["eager"]],
           "state_bit_equal": equal}
    log("streaming chunk graph and eager chunk in turns, bf16 beam 5: " + json.dumps(out))
    f, v = feats[-1]
    out["profile_replay"] = profile(
        lambda: stream.process_chunk(f, encoder_valid=v, collect=False), cpu=False)
    return out


def run_streaming(seed: int) -> dict:
    """``StreamingDecoder`` over the full-width AV encode at B=1, bf16, beam
    5, 448-token windows, 40 tokens per 30 s chunk, ``collect=False`` and
    one final ``collected_tokens``: 10 chunks (5 min), then after ``reset``
    20 chunks (a window rollover). Every chunk replays the graph of its key,
    captured at the warm-up; then the graph and the eager chunk in turns on
    the same chunks, bit for bit. Then in fp32 at small depth, with windows
    that roll over within 4 chunks: tokens on the card equal the CPU's,
    deferred collection equals eager collection, and the graph equals the
    eager chunk on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    net = build(seed, L.BF16, dev)
    decoder = net.decoder.prepare_decode_params()
    chunks = [make_batch(rng, 1, T_VIDEO, dev) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' pools, so that "reserved" is this phase's
    stream = StreamingDecoder(decoder, PREFIX, max_len=STREAM_MAX_LEN, eos_id=EOS,
                              max_tokens_per_chunk=STREAM_TOKENS, beam_size=BEAM)

    def one_chunk(i, collect=False):
        feats, valid = net.encode(preprocess(*chunks[i % len(chunks)]))
        return stream.process_chunk(feats, encoder_valid=valid, collect=collect)

    # Warm-up: the window's priming chunk, then a steady one; each captures
    # its key's graph.
    t0 = time.perf_counter()
    one_chunk(0, collect=True)
    one_chunk(1, collect=True)
    torch.cuda.synchronize()
    warmup = {"warmup_s": time.perf_counter() - t0,
              "reserved_gib_after_warmup": torch.cuda.memory_reserved() / 2**30,
              **graph_summary(stream.graphs)}
    if len(stream.graphs.captures) != 2 or stream.graphs.replays != 2:
        raise AssertionError(f"the warm-up captured {stream.graphs.captures} and replayed "
                             f"{stream.graphs.replays}; expected 2 keys and 2 replays")
    # Encode and decode of a chunk apart, and K1's launches in one chunk.
    encode_ms, decode_ms, launches = [], [], []
    for i in range(2, 5):
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        feats, valid = net.encode(preprocess(*chunks[i % len(chunks)]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream.process_chunk(feats, encoder_valid=valid, collect=False)
        torch.cuda.synchronize()
        encode_ms.append((t1 - t0) * 1e3)
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        launches.append((fa.launches, launches_by_mask(fa.launches_by_kernel)))
    if any(n != 15 or by != {"unmasked": 12, "masked": 3} for n, by in launches):
        raise AssertionError(f"a streamed chunk launched K1 {launches}, expected 12 encoder + "
                             "3 fusion")

    legs = {}
    for name, n_chunks in (("5min", STREAM_CHUNKS), ("longform", LONGFORM_CHUNKS)):
        stream.reset()
        replays = stream.graphs.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_chunks):
            one_chunk(i)
        rollovers = len(stream._stash)  # closed windows not yet read back
        tokens = stream.collected_tokens()
        wall_s = time.perf_counter() - t0
        if tokens[:len(PREFIX)] != PREFIX or not all(0 <= t < VOCAB for t in tokens):
            raise AssertionError(f"streaming {name}: bad transcript {tokens[:16]}...")
        if stream.graphs.replays - replays != n_chunks:
            raise AssertionError(f"streaming {name}: {stream.graphs.replays - replays} replays "
                                 f"for {n_chunks} chunks")
        legs[name] = {"chunks": n_chunks, "wall_s": wall_s, "tokens": len(tokens) - len(PREFIX),
                      "rollovers": rollovers,
                      "audio_s_per_s": n_chunks * SECONDS_PER_CLIP / wall_s}
    if legs["longform"]["rollovers"] < 1:
        raise AssertionError(f"the long-form leg rolled no window over: {legs['longform']}")
    if len(stream.graphs.captures) != 2 or len(net.encode_program.captures) != 1:
        raise AssertionError(f"traffic captured again: {stream.graphs.captures}, encode "
                             f"{net.encode_program.captures}")
    out = {"beam": BEAM, "max_len": STREAM_MAX_LEN, "tokens_per_chunk": STREAM_TOKENS,
           "streaming_audio_s_per_s": legs["5min"]["audio_s_per_s"],
           "longform_audio_s_per_s": legs["longform"]["audio_s_per_s"], "legs": legs,
           "encode_ms_per_chunk": encode_ms, "decode_ms_per_chunk": decode_ms,
           "decode_ms_per_step": [x / STREAM_TOKENS for x in decode_ms],
           "k1_launches_per_chunk": launches[0][0], "graphs": warmup,
           "encode_graphs": graph_summary(net.encode_program),
           "reserved_gib_after_traffic": torch.cuda.memory_reserved() / 2**30,
           "replays": stream.graphs.replays}
    log(f"streaming bf16 beam {BEAM}, {STREAM_TOKENS} tokens a chunk: " + json.dumps(out))
    out["turns"] = chunk_turns(stream, [net.encode(preprocess(*chunks[i % len(chunks)]))
                                        for i in range(5)])
    del net, decoder, stream, chunks

    # fp32, 2 + 2 Whisper layers, 32 frames, 8 tokens a chunk in 24-token
    # windows conditioned on 4 tokens of context: a rollover within 4 chunks.
    cpu_batches = [make_batch(rng, 1, 32, "cpu") for _ in range(4)]
    kw = dict(max_len=24, eos_id=EOS, max_tokens_per_chunk=8, beam_size=BEAM, context_tokens=4,
              sot_prev_id=SOT_PREV)
    runs = {"collect": (True, StreamingDecoder), "deferred": (False, StreamingDecoder),
            "eager_chunk": (True, EagerChunks)}
    got = {}
    for device, (decoder, feats) in small_features(seed, cpu_batches).items():
        for name, (collect, cls) in runs.items():
            if device == "cpu" and name != "collect":
                continue
            sd = cls(decoder, PREFIX, **kw)
            for f, v in feats:
                sd.process_chunk(f, encoder_valid=v, collect=collect)
            got[(device, name)] = (sd.collected_tokens(), list(sd._window_prefix))
    (card, prefix), (cpu, _), (deferred, _), (eager, _) = (
        got[("cuda", "collect")], got[("cpu", "collect")], got[("cuda", "deferred")],
        got[("cuda", "eager_chunk")])
    log(f"streaming fp32 (2 + 2 Whisper layers, 4 chunks of 8 tokens in 24-token windows): "
        f"{len(card) - len(PREFIX)} tokens; card == CPU: {card == cpu}; deferred == eager on "
        f"the card: {deferred == card}; graph == eager chunk on the card: {eager == card}; "
        f"last window prefix {prefix}")
    if prefix[0] != SOT_PREV:
        raise AssertionError(f"no window rolled over in the fp32 check: {prefix}")
    if card != cpu or deferred != card or eager != card:
        raise AssertionError(f"fp32 streaming tokens differ:\ncard {card}\ncpu {cpu}\n"
                             f"deferred {deferred}\neager chunk {eager}")
    out["fp32_card_vs_cpu_tokens_identical"] = out["deferred_equals_eager"] = True
    out["fp32_graph_equals_eager_chunk"] = True
    return out


# -- phase 12: the continuous engine -------------------------------------------------------


# fp32 scripted schedule: admissions by tick as (row, utterance); rows 0 and
# 1 come in together, row 2 one segment later, then each row is reused.
CONT_SCHEDULE = {0: [(0, 0), (1, 1)], 1: [(2, 2)], 3: [(0, 3)], 4: [(1, 4), (2, 5)]}


def same_state(a: dict, b: dict) -> bool:
    """Two continuous states bit for bit (the spare caches are scratch)."""
    return a["tick"] == b["tick"] and all(
        torch.equal(v, b[k]) for k, v in a.items()
        if isinstance(v, torch.Tensor) and "spare" not in k)


def check_continuous_fp32(seed: int) -> dict:
    """The state machine (``init_state`` / admit / segment) in fp32 at small
    depth through ``CONT_SCHEDULE`` (3 rows, beam 5, 8-step segments, 24
    tokens) on the card and on the CPU: the same pool tokens, each card row
    equal to the card's solo ``beam_search`` of the same features, and on
    the card the segment's graph equal to the eager segment after every
    segment."""
    rng = np.random.default_rng(seed + 9)
    cpu_batches = [make_batch(rng, 1, 32, "cpu") for _ in range(6)]
    seg, n_seg = 8, 3
    kw = dict(beam_size=BEAM, seg_steps=seg, n_segments=n_seg, n_prefix=len(PREFIX), eos_id=EOS)
    pools, graph_equal = {}, []
    for device, (decoder, feats) in small_features(seed, cpu_batches).items():
        # the program's state (a graph on the card), and on the card the
        # eager segment's beside it
        machines = [(continuous.SegmentProgram(decoder, **kw),
                     continuous.init_state(decoder, capacity=3, beam_size=BEAM, seg_steps=seg,
                                           n_segments=n_seg, enc_len=32, eos_id=EOS))]
        if device == "cuda":
            machines.append((continuous.make_segment_fn(decoder, **kw),
                             continuous.init_state(decoder, capacity=3, beam_size=BEAM,
                                                   seg_steps=seg, n_segments=n_seg, enc_len=32,
                                                   eos_id=EOS)))
        admit = continuous.make_admit_fn(decoder, PREFIX, EOS, BEAM, seg * n_seg)
        live, rows = {}, {}
        for tick in range(7):
            entries = CONT_SCHEDULE.get(tick, [])
            for segment, state in machines:
                if entries:
                    admit(state, torch.cat([feats[u][0] for _, u in entries]),
                          torch.cat([feats[u][1] for _, u in entries]), [r for r, _ in entries])
                segment(state)
            state = machines[0][1]
            if device == "cuda":
                graph_equal.append(same_state(state, machines[1][1]))
            live.update({r: (u, tick) for r, u in entries})
            for r, (u, t0) in list(live.items()):
                if tick + 1 - t0 == n_seg:
                    rows[u] = state["pool_tokens"][r].to("cpu", copy=True)
                    del live[r]
        pools[device] = rows
        if device == "cuda":
            if machines[0][0].replays != 7 or len(machines[0][0].captures) != 1:
                raise AssertionError(f"fp32 segment program: {machines[0][0].replays} replays, "
                                     f"captures {machines[0][0].captures}")
            solos = {u: beam_search(decoder, f, PREFIX, beam_size=BEAM, max_len=seg * n_seg,
                                    eos_id=EOS, encoder_valid=v).sequences[0].cpu()
                     for u, (f, v) in enumerate(feats)}
    same_cpu = all(torch.equal(pools["cuda"][u], pools["cpu"][u]) for u in range(6))
    same_solo = all(torch.equal(pools["cuda"][u], solos[u]) for u in range(6))
    log(f"continuous fp32 scripted schedule (2 + 2 Whisper layers, 3 rows, 6 requests, slots "
        f"reused): pools card == CPU: {same_cpu}; card rows == solo beam_search: {same_solo}; "
        f"segment graph == eager segment on the card: {graph_equal}")
    if not same_cpu or not same_solo or not all(graph_equal):
        raise AssertionError("fp32 continuous pools differ: card vs CPU "
                             f"{same_cpu}, card vs solo {same_solo}, graph vs eager "
                             f"{graph_equal}")
    return {"fp32_card_vs_cpu_tokens_identical": True, "fp32_rows_equal_solo_beam_search": True,
            "fp32_graph_equals_eager_segment": True}


def segment_turns(net, payloads, encode) -> dict:
    """The segment's graph and the eager segment in turns at full width (16
    requests x 5 beams, 32-step segments, 160 tokens, bf16) on two states
    with the same 16 admissions: ms a step of each, the states bit for bit
    and at their addresses after every segment, the capture's seconds and
    the pool's bytes; then one more replayed segment under the profiler."""
    decoder = net.decoder.prepare_decode_params()
    n_seg = MAX_TOKENS // CONT_SEG_STEPS
    kw = dict(beam_size=BEAM, seg_steps=CONT_SEG_STEPS, n_segments=n_seg,
              n_prefix=len(PREFIX), eos_id=EOS)
    feats, valid = encode([payloads[i % len(payloads)] for i in range(CONT_CAPACITY)])
    admit = continuous.make_admit_fn(decoder, PREFIX, EOS, BEAM, MAX_TOKENS)
    states = []
    for _ in range(2):
        state = continuous.init_state(decoder, capacity=CONT_CAPACITY, beam_size=BEAM,
                                      seg_steps=CONT_SEG_STEPS, n_segments=n_seg,
                                      enc_len=feats.shape[1], eos_id=EOS)
        states.append(admit(state, feats, valid, list(range(CONT_CAPACITY))))
    program = continuous.SegmentProgram(decoder, **kw)
    eager = continuous.make_segment_fn(decoder, **kw)
    _, capture_call_s = timed_call(lambda: program.capture(states[0]))
    homes = {k: v.data_ptr() for k, v in states[0].items() if isinstance(v, torch.Tensor)}
    ms = {"graph": [], "eager": []}
    equal, in_place = [], []
    for i in range(3):
        order = (("graph", program, states[0]), ("eager", eager, states[1]))
        for name, segment, state in (order if i % 2 == 0 else order[::-1]):
            _, wall_s = timed_call(lambda: segment(state))
            ms[name].append(wall_s * 1e3)
        equal.append(same_state(*states))
        in_place.append(all(states[0][k].data_ptr() == p for k, p in homes.items()))
    if not all(equal) or not all(in_place) or program.replays != 3 \
            or len(program.captures) != 1:
        raise AssertionError(f"bf16 segment graph against the eager segment: bit-equal {equal}, "
                             f"in place {in_place}, replays {program.replays}, captures "
                             f"{program.captures}")
    out = {"segments": 3, "graph_ms_per_segment": ms["graph"],
           "eager_ms_per_segment": ms["eager"],
           "graph_ms_per_step": [x / CONT_SEG_STEPS for x in ms["graph"]],
           "eager_ms_per_step": [x / CONT_SEG_STEPS for x in ms["eager"]],
           "state_bit_equal": equal, "state_in_place": in_place,
           "capture_call_s": capture_call_s, **graph_summary(program)}
    log("continuous segment graph and eager segment in turns, bf16 16 x beam 5: "
        + json.dumps(out))
    out["profile_replay"] = profile(lambda: program(states[0]), cpu=False)
    return out


def run_continuous(seed: int) -> dict:
    """``make_continuous_av_engine`` at full width on the card (16 requests x
    5 beams, 32-step segments, 160 tokens, bf16): warm-up (the segment's
    capture), 64 closed-loop requests, then 8 in flight and one submitted
    0.4 s later; every future must resolve, every segment is a replay and
    the state tensors keep their addresses. Then the graph and the eager
    segment in turns at full width, and the fp32 scripted check."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 8)
    payloads = [av_payload(rng) for _ in range(4)]
    net = build(seed, L.BF16, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' pools, so that "reserved" is this phase's
    torch.cuda.reset_peak_memory_stats()
    out = {"capacity": CONT_CAPACITY, "beam": BEAM, "seg_steps": CONT_SEG_STEPS,
           "max_len": MAX_TOKENS, "requests": CONT_REQUESTS,
           "reserved_gib_before_warmup": torch.cuda.memory_reserved() / 2**30}
    encodes, segment_ms = [], []
    with make_continuous_av_engine(net, PREFIX, beam_size=BEAM, max_len=MAX_TOKENS, eos_id=EOS,
                                   capacity=CONT_CAPACITY, seg_steps=CONT_SEG_STEPS) as eng:
        encode, program = eng.encode, eng.segment_program
        homes = {k: v.data_ptr() for k, v in eng.state.items() if isinstance(v, torch.Tensor)}

        def counted_encode(batch):
            before = fa.launches
            res = encode(batch)
            encodes.append((len(batch), fa.launches - before))
            return res

        def timed_segment(state):
            t0 = time.perf_counter()
            res = program(state)
            torch.cuda.current_stream().synchronize()  # the engine's stream
            segment_ms.append((time.perf_counter() - t0) * 1e3)
            return res

        eng.encode = counted_encode
        out["enc_len"] = eng.state["enc_valid"].shape[1]
        t0 = time.perf_counter()
        eng.warmup(payloads[0], encode_buckets=CONT_BUCKETS)
        out["warmup_s"] = time.perf_counter() - t0
        out["reserved_gib_after_warmup"] = torch.cuda.memory_reserved() / 2**30
        out["segment_graph"] = graph_summary(program)
        out["encode_capture_by_bucket"] = captures_by_rows(net.encode_program)
        out["encode_pool_bytes"] = pool_bytes(net.encode_program)
        if len(program.captures) != 1 or program.replays != eng.stats()["segments_run"]:
            raise AssertionError(f"warm-up captured {program.captures}, replayed "
                                 f"{program.replays} of {eng.stats()['segments_run']} segments")
        if sorted(out["encode_capture_by_bucket"], key=int) != [str(b) for b in CONT_BUCKETS] \
                or len(net.encode_program.captures) != len(CONT_BUCKETS):
            raise AssertionError(f"warm-up captured the encode {net.encode_program.captures}, "
                                 f"expected one graph a bucket {CONT_BUCKETS}")
        by_bucket = {n: k for n, k in encodes[:len(CONT_BUCKETS)]}
        if sorted(by_bucket) != list(CONT_BUCKETS) or set(by_bucket.values()) != {15}:
            raise AssertionError(f"admission encodes launched K1 {encodes}, expected 15 at each "
                                 f"bucket {CONT_BUCKETS}")
        eng.segment_program = timed_segment  # the loop's segment, timed
        encodes.clear()
        segments_before = eng.stats()["segments_run"]
        replays_before = program.replays
        fa.reset_launches()
        t0 = time.perf_counter()
        futures = [eng.submit(*payloads[i % len(payloads)]) for i in range(CONT_REQUESTS)]
        results = [f.result(timeout=WAIT_S) for f in futures]
        wall_s = time.perf_counter() - t0
        traffic_launches, traffic_encodes = fa.launches, list(encodes)
        traffic_segments = eng.stats()["segments_run"] - segments_before
        traffic_replays = program.replays - replays_before
        traffic_segment_ms = list(segment_ms)
        # Mid-decode admission: rows are mid-flight and rows are free; the
        # probe is admitted at the next segment boundary.
        in_flight = [eng.submit(*payloads[i % len(payloads)]) for i in range(CONT_INFLIGHT)]
        time.sleep(0.4)
        probe = eng.submit(*payloads[0]).result(timeout=WAIT_S)
        results_in_flight = [f.result(timeout=WAIT_S) for f in in_flight]
        stats = eng.stats()
        moved = [k for k, p in homes.items() if eng.state[k].data_ptr() != p]
        out["segment_graph_after_traffic"] = graph_summary(program)
    out["reserved_gib_after_traffic"] = torch.cuda.memory_reserved() / 2**30
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if moved or len(program.captures) != 1 or traffic_replays != traffic_segments:
        raise AssertionError(f"continuous engine: state tensors moved {moved}, captures "
                             f"{program.captures}, {traffic_replays} replays for "
                             f"{traffic_segments} segments")
    bad = [r for r in results + results_in_flight + [probe]
           if r.bucket != CONT_CAPACITY or list(r.tokens[:len(PREFIX)]) != PREFIX]
    if bad or stats["live_rows"] or stats["pending"]:
        raise AssertionError(f"continuous engine: bad results {bad[:2]}, stats {stats}")
    if sorted({k for _, k in encodes}) != [15] or traffic_launches != 15 * len(traffic_encodes):
        raise AssertionError(f"the traffic launched K1 {traffic_launches} times over admission "
                             f"encodes {traffic_encodes}, expected 15 each")
    # Each row against a B=1 net.beam of its payload (its decode program):
    # reported, not held (bf16 rows are reproducible per batch shape, not
    # across shapes).
    direct = [direct_av_rows(net, [p], 1, MAX_TOKENS)[0] for p in payloads]
    if len(net.encode_program.captures) != len(CONT_BUCKETS):
        raise AssertionError(f"traffic captured the encode again: {net.encode_program.captures}")
    out["encode_graphs_after_traffic"] = graph_summary(net.encode_program)
    served = results + results_in_flight + [probe]
    which = list(range(CONT_REQUESTS)) + list(range(CONT_INFLIGHT)) + [0]
    equal = sum(np.array_equal(r.tokens, direct[i % len(payloads)]) for r, i in zip(served, which))
    seg_mean = float(np.mean(traffic_segment_ms))
    out.update({
        "wall_s": wall_s, "audio_seconds_per_second": CONT_REQUESTS * SECONDS_PER_CLIP / wall_s,
        "queue_ms": {"p50": float(np.percentile([r.queue_ms for r in results], 50)),
                     "p99": float(np.percentile([r.queue_ms for r in results], 99))},
        "total_ms": {"p50": float(np.percentile([r.total_ms for r in results], 50)),
                     "p99": float(np.percentile([r.total_ms for r in results], 99))},
        "middecode_admission_ms": probe.queue_ms, "middecode_total_ms": probe.total_ms,
        "segment_ms_mean": seg_mean, "segment_ms_max": float(np.max(traffic_segment_ms)),
        "step_ms_mean": seg_mean / CONT_SEG_STEPS, "segments_run": traffic_segments,
        "admission_encodes": [n for n, _ in traffic_encodes],
        "k1_launches_in_traffic": traffic_launches,
        "k1_launches_per_admission_by_bucket": {str(b): by_bucket[b] for b in CONT_BUCKETS},
        "tokens_generated": [len(r.tokens) - len(PREFIX) for r in results[:4]],
        "share_equal_to_b1_beam": equal / len(served), "segment_replays": traffic_replays,
        "state_in_place": True})
    log(f"continuous engine bf16 {CONT_CAPACITY} x beam {BEAM}, {CONT_SEG_STEPS}-step segments: "
        + json.dumps(out))
    out["turns"] = segment_turns(net, payloads, encode)
    del net
    out.update(check_continuous_fp32(seed))
    return out


# -- phase 13: data-fed training -------------------------------------------------------------

# The dataset phase 13 writes: clips per split, seconds of 48 kHz audio per
# clip (resampled by the native library), the range of lip frames per clip.
DATA_CLIPS = {"train": 16, "val": 4, "test": 4}
DATA_SECONDS, DATA_RATE, DATA_FRAMES = 12.0, 48_000, (280, 400)
# steps of each mode's fit: the host mode waits ~3.7 s a step on its loader, so
# it runs one epoch (4 batches), the others two
DATA_STEPS = {"host": 4, "on_device": 8, "on_device_mel": 8}
DATA_MODES = {"host": {},
              "on_device": {"augmentation.on_device": True},
              "on_device_mel": {"augmentation.on_device": True,
                                "augmentation.on_device_mel": True}}
# The waveform-mode mel, card against CPU, as a share of the largest value:
# fp32 DFT and filter-bank products summed in other orders.
MEL_RTOL = 1e-5


def write_moco_checkpoint(path: str, seed: int) -> None:
    """A MoCo v2 checkpoint of random weights in its own layout: the query
    encoder's stem, layer1-4 (BN statistics not at their init) and MLP head."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))

    def conv_bn(conv, bn, c_out, c_in, k):
        sd[f"{conv}.weight"] = t((c_out, c_in, k, k), (2.0 / (c_in * k * k)) ** 0.5)
        sd[f"{bn}.weight"], sd[f"{bn}.bias"] = t((c_out,), 0.1, 1.0), t((c_out,), 0.1)
        sd[f"{bn}.running_mean"] = t((c_out,), 0.1)
        sd[f"{bn}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c_out).astype(np.float32))

    q = "module.encoder_q"
    conv_bn(f"{q}.conv1", f"{q}.bn1", 64, 3, 7)
    c_in = 64
    for stage, (blocks, mid, _) in enumerate(((3, 64, 1), (4, 128, 2), (6, 256, 2),
                                              (3, 512, 2)), start=1):
        for i in range(blocks):
            p = f"{q}.layer{stage}.{i}"
            conv_bn(f"{p}.conv1", f"{p}.bn1", mid, c_in, 1)
            conv_bn(f"{p}.conv2", f"{p}.bn2", mid, mid, 3)
            conv_bn(f"{p}.conv3", f"{p}.bn3", mid * 4, mid, 1)
            if i == 0:
                conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", mid * 4, c_in, 1)
            c_in = mid * 4
    sd[f"{q}.fc.0.weight"] = t((2048, 2048), 0.01)
    sd[f"{q}.fc.2.weight"] = t((128, 2048), 0.01)
    torch.save({"epoch": 800, "arch": "resnet50", "state_dict": sd}, path)


def write_dataset(root: str, seed: int) -> dict:
    """``DATA_CLIPS`` clips per split in the reference layout: uint8 frames
    ``[T, 96, 96, 3]`` as ``.npy``, a 12 s 48 kHz 16-bit WAV beside each, a
    short text; and a MoCo checkpoint. Returns the paths and the seconds it
    took."""
    import wave

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    shutil.rmtree(root, ignore_errors=True)
    frames_written = 0
    for split, n in DATA_CLIPS.items():
        vdir = os.path.join(root, split, f"{split}_video_seg12s", "spk1")
        tdir = os.path.join(root, split, f"{split}_text_seg12s", "spk1")
        os.makedirs(vdir)
        os.makedirs(tdir)
        for i in range(n):
            t = int(rng.integers(DATA_FRAMES[0], DATA_FRAMES[1] + 1))
            np.save(os.path.join(vdir, f"clip{i:03d}.npy"),
                    rng.integers(0, 256, (t, 96, 96, 3), dtype=np.uint8))
            frames_written += t
            x = rng.standard_normal(int(DATA_SECONDS * DATA_RATE)) * 0.2
            with wave.open(os.path.join(vdir, f"clip{i:03d}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(DATA_RATE)
                w.writeframes(np.clip(x * 32767, -32768, 32767).astype("<i2").tobytes())
            with open(os.path.join(tdir, f"clip{i:03d}.txt"), "w", encoding="utf-8") as f:
                f.write(f"xin chao {split} {i}")
    moco = os.path.join(root, "moco_v2_random.pth.tar")
    write_moco_checkpoint(moco, seed)
    return {"root": root, "moco": moco, "frames": frames_written,
            "write_s": time.perf_counter() - t0}


def data_config(data: dict, workdir: str, name: str, seed: int, overrides: dict):
    """Full width (whisper-small, ResNet-50, ``MODELARGS``, BF16, B=4, 400
    frames) with phase 7's training settings: dropout 0.1, no activation
    checkpointing, no accumulation."""
    return get_config({
        "data.root_dir": data["root"], "data.moco_file": data["moco"], "data.batch_size": B,
        "data.num_workers": 4, "data.prefetch_batches": 2, "training.epochs": 2,
        "training.accumulate_grad_batches": 1, "training.seed": seed,
        "output.log_every_n_steps": 1, "precision.rematerialize": False,
        "output.checkpoint_dir": os.path.join(workdir, name, "checkpoints"),
        "output.log_dir": os.path.join(workdir, name, "logs"), **overrides})


def fit_on_data(name: str, data: dict, workdir: str, seed: int, overrides: dict,
                expected_launches: int, steps: int) -> tuple[dict, Trainer, DataModule]:
    """``DataModule`` -> ``train.build_net`` -> ``Trainer.fit`` for ``steps``
    steps -> ``Trainer.test``, as ``train.main`` wires them;
    ms per step and the loader wait over the steps after the warm-up that
    do not start an epoch."""
    config = data_config(data, workdir, name, seed, overrides)
    t0 = time.perf_counter()
    dm = DataModule(config)
    dm.setup()
    train_loader = dm.train_dataloader()  # probes every clip's frame count
    probe_s = time.perf_counter() - t0
    steps_per_epoch = len(train_loader)
    net = train_entry.build_net(config, dm.vocab_size, "cuda", moco_file=data["moco"])
    trainer = Trainer(config, net, dm.tokenizer)
    trainer.writer = _RecordingWriter(trainer.writer.path)
    trainer.step_timestamps, trainer.data_wait_s = [], []
    per_step = []
    setup = trainer.setup

    def counted_setup(total):  # the program exists once the fit has set up
        setup(total)
        step = trainer.program.train_step

        def counted_step(*args, **kwargs):
            before = fa.launches
            out = step(*args, **kwargs)
            per_step.append(fa.launches - before)
            return out

        trainer.program.train_step = counted_step

    trainer.setup = counted_setup
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(dm, max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = trainer.test(dm)
    launches = fa.launches

    if len(per_step) != steps or set(per_step) != {expected_launches}:
        raise AssertionError(f"data path {name}: K1 launches per train step {per_step}, "
                             f"expected {expected_launches} each")
    step_loss = {st: v for tag, v, st in trainer.writer.scalars if tag == "train/loss"}
    losses = [step_loss[i] for i in range(1, steps + 1)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"data path {name}: non-finite loss in {losses}")
    if any(tag == "train/skipped_steps" for tag, _, _ in trainer.writer.scalars):
        raise AssertionError(f"data path {name}: a step was skipped")
    if not os.path.exists(os.path.join(config["output"]["checkpoint_dir"],
                                       f"step_{steps}.pt")):
        raise AssertionError(f"data path {name}: no checkpoint was written")
    predictions = os.path.join(os.path.dirname(trainer.writer.path), "predictions.txt")
    if (not any(tag == "test/wer" for tag, _, _ in trainer.writer.scalars)
            or not os.path.exists(predictions) or not np.isfinite(metrics["wer"])):
        raise AssertionError(f"data path {name}: the test WER was not written ({metrics})")
    ts, waits = trainer.step_timestamps, trainer.data_wait_s
    # step i (0-based) ends at ts[i]; time steps past the warm-up that do not
    # open an epoch (the gap before those holds validation and a checkpoint)
    timed = [i for i in range(TRAIN_WARMUP, steps) if i % steps_per_epoch]
    ms = float(np.mean([(ts[i] - ts[i - 1]) * 1e3 for i in timed]))
    out = {"train_ms_per_step": ms, "train_clips_per_sec": B / (ms * 1e-3),
           "data_wait_ms": float(np.mean([waits[i] * 1e3 for i in timed])),
           "data_wait_ms_each": [w * 1e3 for w in waits],
           "step_ms_each": [(y - x) * 1e3 for x, y in zip(ts, ts[1:])],
           "timed_steps": [i + 1 for i in timed], "steps_per_epoch": steps_per_epoch,
           "peak_mem_gib": peak, "losses": losses, "test_wer": metrics["wer"],
           "k1_launches_per_step": expected_launches, "k1_launches_in_fit_and_test": launches,
           "fit_s": fit_s, "probe_s": probe_s,
           "program": program_record(trainer.program, steps)}
    log(f"data path {name} bf16 B={B}: " + json.dumps(out))
    return out, trainer, dm


def check_moco_fold(net, moco: str) -> dict:
    """The frontend's folded weights on the card against a CPU fold of the
    same checkpoint."""
    weights, report = resnet50_from_moco(torch.load(moco, map_location="cpu", weights_only=True))
    body = net.visual_frontend.body.state_dict()
    differ = [k for k, v in weights.items() if not torch.equal(body[k].cpu(), torch.from_numpy(v))]
    if differ or report["blocks_loaded"] != 16 or report["skipped"]:
        raise AssertionError(f"MoCo weights on the card differ from the CPU fold: {differ[:4]}, "
                             f"report {report}")
    return {"blocks_loaded": report["blocks_loaded"], "tensors_equal": len(weights)}


def check_prefetch_placement(trainer: Trainer, config) -> dict:
    """The train loader's batches placed on the card by the prefetch thread
    (4 workers, 2 batches ahead) against the same batches collated without
    threads and placed by the main thread: bit-equal."""
    sync_config = config.copy()
    sync_config.set_dotted("data.num_workers", 0)
    sync_config.set_dotted("data.prefetch_batches", 0)
    dm_threads, dm_sync = DataModule(config), DataModule(sync_config)
    threaded, sync = dm_threads.train_dataloader(), dm_sync.train_dataloader()
    threaded.device_put = trainer._put_batch
    compared = 0
    for a, b in zip(threaded, sync):
        a, b = trainer._ready(a), trainer._ready(trainer._put_batch(b))
        for key, value in b.items():
            if isinstance(value, torch.Tensor) and not (value.device == a[key].device
                                                        and torch.equal(value, a[key])):
                raise AssertionError(f"prefetch-placed batch {compared}: {key} differs")
        compared += 1
    if compared != len(sync):
        raise AssertionError(f"prefetch placement compared {compared} of {len(sync)} batches")
    return {"batches_bit_equal": compared}


def check_waveform_mel(dm) -> dict:
    """The waveform-mode mel of one packed train batch, card against CPU, TF32
    off; and its wall time on the card."""
    batch = next(iter(dm.train_dataloader()))
    audio, mask = torch.from_numpy(batch["audio"]), torch.from_numpy(batch["audio_mask"])
    ref = packed_waveform_mel(audio, mask)
    card_audio, card_mask = audio.cuda(), mask.cuda()
    ours = packed_waveform_mel(card_audio, card_mask)
    err = (ours.cpu() - ref).abs().max().item()
    scale = ref.abs().max().item()
    ms = cuda_ms(lambda: packed_waveform_mel(card_audio, card_mask), 10)
    out = {"shape": list(audio.shape), "max_abs_err": err, "max_value": scale,
           "rel_err": err / scale, "rtol": MEL_RTOL, "ms_on_card": ms}
    log("waveform-mode mel card vs CPU: " + json.dumps(out))
    if not err <= MEL_RTOL * scale:
        raise AssertionError(f"waveform-mode mel card vs CPU differs by {err} (max {scale})")
    return out


def loader_breakdown(data: dict, seed: int) -> dict:
    """Where the host's time per clip goes (each stage timed alone on one
    train clip of the dataset, best of 3), and the on-device-mel train
    loader's time per epoch with 1 and with 4 worker threads."""
    from mocov2_whisper_flamingo_torch.datamodule import av_dataset, transforms

    clip = os.path.join(data["root"], "train", "train_video_seg12s", "spk1", "clip000.npy")
    proc = av_dataset.DataProcessor()
    frames = proc.load_video(clip, 400)
    wave = proc.load_audio(clip)
    rng = np.random.default_rng(seed)
    stages = {
        "read_npy": lambda: proc.load_video(clip, 400),
        "read_wav_and_resample": lambda: proc.load_audio(clip),
        "video_resize_uint8": lambda: transforms.VideoTransform("train", on_device=True)(frames),
        "video_host_train": lambda: transforms.VideoTransform("train")(frames, rng),
        "video_host_eval": lambda: transforms.VideoTransform("val")(frames),
        "audio_host_train": lambda: transforms.AudioTransform("train")(wave, rng),
        "mel_host": lambda: transforms.np_reference_mel(wave),
        "pack_waveform": lambda: av_dataset.pack_waveform(wave),
    }
    out = {}
    for name, fn in stages.items():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        out[f"{name}_ms"] = best * 1e3
    for workers in (1, 4):
        config = data_config(data, os.path.join(data["root"], "unused"), "unused", seed, {
            **DATA_MODES["on_device_mel"], "data.num_workers": workers,
            "data.prefetch_batches": 0})
        dm = DataModule(config)
        dm.setup("fit")
        loader = dm.train_dataloader()
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        out[f"on_device_mel_epoch_s_{workers}_workers"] = time.perf_counter() - t0
        out["batches_per_epoch"] = n
    log("loader host time per clip: " + json.dumps(out))
    return out


def run_data_path(seed: int, expected_launches: int) -> dict:
    """Phase 13: a dataset on disk through the data module at full width, in
    the three augmentation modes; then ``train.main`` itself for 2 steps."""
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, "build", "chip_smoke_data_train")
    t0 = time.perf_counter()
    native.load_library()  # g++ builds the native IO library; a missing compiler raises
    out = {"native_build_s": time.perf_counter() - t0}
    try:
        import cv2
        log(f"cv2 {cv2.__version__} imports; phase 13's dataset is .npy only")
    except ImportError as e:
        log(f"cv2 cannot be imported ({e}); phase 13's dataset is .npy only")
    data = write_dataset(os.path.join(root, "build", "chip_smoke_data"), seed + 13)
    out["dataset"] = {k: data[k] for k in ("frames", "write_s")}
    out["dataset"].update(clips=DATA_CLIPS, seconds_per_clip=DATA_SECONDS,
                          sample_rate=DATA_RATE, frames_range=list(DATA_FRAMES))
    log(f"phase 13 dataset: {json.dumps(out['dataset'])}")
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        out["loader_breakdown"] = loader_breakdown(data, seed)
        for name, overrides in DATA_MODES.items():
            out[name], trainer, dm = fit_on_data(name, data, workdir, seed, overrides,
                                                 expected_launches, DATA_STEPS[name])
            if name == "host":
                out["moco_fold"] = check_moco_fold(trainer.net, data["moco"])
            if name == "on_device_mel":
                out["prefetch_placement"] = check_prefetch_placement(trainer, dm.config)
                out["waveform_mel"] = check_waveform_mel(dm)
            del trainer, dm
            shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)  # ~1 GB a checkpoint
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        argv = [a for s in (f"data.root_dir={data['root']}", f"data.moco_file={data['moco']}",
                            "data.num_workers=4",
                            f"output.checkpoint_dir={os.path.join(workdir, 'main', 'ckpt')}",
                            f"output.log_dir={os.path.join(workdir, 'main', 'logs')}")
                for a in ("--set", s)] + ["--max-steps", "2"]
        rc = train_entry.main(argv)
        if rc != 0:
            raise AssertionError(f"train.main {argv} returned {rc}")
        out["train_main"] = {"argv": argv, "rc": rc, "s": time.perf_counter() - t0}
        log(f"train.main on the dataset, 2 steps: rc 0 in {out['train_main']['s']:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(data["root"], ignore_errors=True)
    return out


# -- phase 14: long-form quality transcription -------------------------------------------


class RungTimer:
    """Wall ms of each rung of ``decode_with_fallback`` (the beam program at
    t = 0, the sampler program above it), of each no-speech probe program
    and of each word-time alignment (forward, statistics and DTW), each
    between two synchronisations, and whether a program call captured its
    graph. Installed over the ``DecodePrograms`` methods that
    ``decode_with_fallback`` calls (outside any capture: a program call
    captures inside itself) and the name that ``decode/timestamps.py``
    calls; removed on exit."""

    PATCHES = {"beam": (DecodePrograms, "beam"), "sample": (DecodePrograms, "sample"),
               "no_speech": (DecodePrograms, "no_speech"),
               "alignment": (timestamps, "token_timestamps")}

    def __enter__(self):
        self.records = {kind: [] for kind in self.PATCHES}
        self._saved = {kind: getattr(mod, name) for kind, (mod, name) in self.PATCHES.items()}
        for kind, (mod, name) in self.PATCHES.items():
            setattr(mod, name, self._timed(kind, self._saved[kind]))
        return self

    def __exit__(self, *exc):
        for kind, (mod, name) in self.PATCHES.items():
            setattr(mod, name, self._saved[kind])

    def _timed(self, kind, fn):
        def timed(*args, **kw):
            programs = args[0] if kind != "alignment" else None
            captures = len(programs.captures) if programs is not None else 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec = {"ms": (time.perf_counter() - t0) * 1e3}
            if programs is not None:
                rec["captured"] = len(programs.captures) > captures
            if kind in ("beam", "sample"):
                rec["steps"] = kw["max_len"] - 1  # decode steps, the prefix's included
            elif kind == "no_speech":
                rec["steps"] = kw.get("sot_index", 0) + 1
            else:
                rec.update(tokens=len(args[1]), bucket=kw["pad_tokens_to"],
                           n_text=len(args[1]) - kw["n_prefix"] - kw["n_drop_last"])
            self.records[kind].append(rec)
            return out
        return timed

    def summary(self) -> dict:
        """Per kind: calls, captures, ms mean and max, and ms a step over
        every call and over the calls that only replayed."""
        out = {}
        for kind, recs in self.records.items():
            if recs:
                ms = [r["ms"] for r in recs]
                out[kind] = {"calls": len(recs), "ms_mean": float(np.mean(ms)),
                             "ms_max": float(np.max(ms))}
                if "captured" in recs[0]:
                    out[kind]["captured"] = sum(r["captured"] for r in recs)
                if "steps" in recs[0]:
                    out[kind]["ms_per_step"] = sum(ms) / sum(r["steps"] for r in recs)
                    replayed = [r for r in recs if not r.get("captured")]
                    if replayed and "captured" in recs[0]:
                        out[kind]["replay_ms_per_step"] = (sum(r["ms"] for r in replayed)
                                                           / sum(r["steps"] for r in replayed))
        return out


@contextlib.contextmanager
def counted_prepares():
    """Count ``WhisperDecoder.prepare_decode_params`` calls inside the block
    (yields the counter)."""
    counts = collections.Counter()
    prepare = WhisperDecoder.prepare_decode_params

    def counting(self, *args, **kwargs):
        counts["prepare"] += 1
        return prepare(self, *args, **kwargs)

    WhisperDecoder.prepare_decode_params = counting
    try:
        yield counts
    finally:
        WhisperDecoder.prepare_decode_params = prepare


def asr_captures(asr) -> int:
    """CUDA graphs captured so far by a ``WhisperASR``: its encode, its
    decode programs and its kept streaming decoders."""
    return (len(asr.encode_program.captures) + len(asr.decode_programs.captures)
            + sum(len(sd.graphs.captures) for sd in asr.stream_decoders.values()))


def rung_programs_equal(asr, feats, max_len: int, temperature: float, seed: int) -> dict:
    """The beam rung, a sampled rung (``temperature``, one noise for both)
    and the no-speech probe of ``asr.decode_programs`` against the eager
    functions over its prepared decoder, in turns, on one window's
    features: bit for bit, and wall ms of each side."""
    programs = asr.decode_programs
    decoder = programs.refreshed_decoder()
    draws = GumbelDraws(seed).fold(0).fold(int(temperature * 1000))
    beam_kw = dict(beam_size=BEAM, max_len=max_len, eos_id=EOS, renorm_after_rules=True)
    sample_kw = dict(temperature=temperature, num_samples=BEAM, max_len=max_len, eos_id=EOS)
    legs = {
        "beam": (lambda: programs.beam(feats, None, PREFIX, **beam_kw),
                 lambda: beam_search(decoder, feats, PREFIX, **beam_kw),
                 ("sequences", "scores")),
        "sample": (lambda: programs.sample(feats, None, PREFIX, draws=draws, **sample_kw),
                   lambda: sampling.sample_decode(decoder, feats, PREFIX, draws=draws,
                                                  **sample_kw),
                   ("sequences", "sum_logprob", "avg_logprob")),
        "no_speech": (lambda: programs.no_speech(feats, None, PREFIX, NO_SPEECH_ID),
                      lambda: sampling.no_speech_probability(decoder, feats, PREFIX,
                                                             NO_SPEECH_ID), None)}
    out = {}
    for i, (kind, (program, eager, fields)) in enumerate(legs.items()):
        program()  # the capture, where this key is new
        got = {}
        ms = {}
        for name, fn in ((("program", program), ("eager", eager)) if i % 2 == 0
                         else (("eager", eager), ("program", program))):
            got[name], wall_s = timed_call(fn)
            ms[f"{name}_ms"] = wall_s * 1e3
        if fields is None:
            equal = bool(torch.equal(got["program"], got["eager"]))
        else:
            equal = all(torch.equal(getattr(got["program"], f), getattr(got["eager"], f))
                        for f in fields)
        steps = 1 if kind == "no_speech" else max_len - 1
        out[kind] = {"bit_equal": equal, "steps": steps, **ms,
                     **{f"{k[:-3]}_ms_per_step": v / steps for k, v in ms.items()}}
    if not all(leg["bit_equal"] for leg in out.values()):
        raise AssertionError(f"rung programs against the eager functions: {out}")
    return out


def longform_audio(rng, seconds: float, rate: int = 16_000) -> np.ndarray:
    """A tone whose pitch changes every 10 s, and noise."""
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * (200 + 300 * (t // 10 % 4)) * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def token_words(ids) -> list[tuple[str, int]]:
    """A word per token, named by its id: the grouping of word times for a
    model whose ids no tokenizer of this script decodes."""
    return [(f" {int(t)}", 1) for t in ids]


def timed_call(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_segments(name: str, segments: list, words, duration: float) -> None:
    for seg in segments:
        if not 0.0 <= seg["start"] <= seg["end"] or seg["seek"] > duration \
                or not all(0 <= t < VOCAB for t in seg["tokens"]):
            raise AssertionError(f"{name}: bad segment {seg}")
    seeks = [seg["seek"] for seg in segments]
    if seeks != sorted(seeks):
        raise AssertionError(f"{name}: seek origins out of order: {seeks}")
    for w in words or ():
        origin = max(o for o in seeks if o <= w.start + 1e-9)
        if not (origin <= w.start <= w.end <= origin + SECONDS_PER_CLIP + 1e-9
                and np.isfinite([w.start, w.end]).all()):
            raise AssertionError(f"{name}: word {w} outside its window at {origin}")


def run_longform(seed: int) -> dict:
    """Phase 14: ``WhisperASR.transcribe`` at whisper-small width, bf16,
    random weights from ``seed``, the byte tokenizer.

    1. Fixed stride: 90 s (three windows), the temperature ladder (beam 5
       at t = 0, best-of-5 samples above), the no-speech probe, word times;
       streaming mode on the same audio; each mode called twice, the second
       call capturing no graph and preparing no decoder. Then the replayed
       rungs and probe against their eager functions, bit for bit.
    2. Timestamp seek: a 30 s clip under the timestamp grammar, gates off.
    3. fp32, one window, card against CPU with one noise made on the CPU;
       the rungs and the probe on the card against their eager functions.
    4. The ``transcribe`` command line, all five formats."""
    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(seed + 14)
    tok = ByteTokenizer()
    group_fn = transcribe_cli.default_group_fn(tok)
    asr = WhisperASR("whisper-small", precision=L.BF16, device="cuda")
    tree = random_asr_params(asr, seed)
    load_jax_params(asr, tree).eval()
    audio = longform_audio(rng, LONG_SECONDS)
    n_windows = int(LONG_SECONDS // SECONDS_PER_CLIP)
    out = {"seconds": LONG_SECONDS, "temperatures": list(LONG_TEMPERATURES),
           "max_len": LONG_MAX_LEN, "beam": BEAM, "best_of": BEAM}

    # 1. quality mode, in turns with streaming mode. No tokenizer: the
    # compression gate reads the token ids (the byte tokenizer would decode
    # whisper ids to empty text), so a random model's repetition loops fail
    # it, as real Whisper's do, and every window climbs the ladder.
    quality_kw = dict(beam_size=BEAM, best_of=BEAM, max_len=LONG_MAX_LEN,
                      eos_id=EOS, temperatures=LONG_TEMPERATURES, no_speech_threshold=0.6,
                      no_speech_id=NO_SPEECH_ID, sot_id=PREFIX[0], sot_prev_id=SOT_PREV,
                      word_times=True, group_fn=token_words, seed=seed)
    stream_kw = dict(beam_size=BEAM, max_len=STREAM_MAX_LEN, eos_id=EOS,
                     max_tokens_per_chunk=LONG_MAX_LEN - len(PREFIX), temperatures=None,
                     sot_prev_id=SOT_PREV)
    quality = lambda: asr.transcribe(audio, PREFIX, **quality_kw)  # noqa: E731
    stream = lambda: asr.transcribe(audio, PREFIX, **stream_kw)  # noqa: E731
    calls = {}  # (mode, call) -> wall s, graphs captured, decoders prepared
    with counted_prepares() as prepares:
        results = {}
        for name, fn in (("streaming_1", stream), ("quality_1", quality),
                         ("streaming_2", stream), ("quality_2", quality)):
            captures, prepared = asr_captures(asr), prepares["prepare"]
            with RungTimer() as timer:
                fa.reset_launches()
                results[name], wall_s = timed_call(fn)
            calls[name] = {"wall_s": wall_s, "captures": asr_captures(asr) - captures,
                           "prepares": prepares["prepare"] - prepared,
                           "k1_launches": fa.launches,
                           "k1_launches_by_kernel": dict(fa.launches_by_kernel),
                           "rungs": timer.summary()}
            if name == "quality_1":
                rungs = timer
    log("long-form calls, captures and preparations: " + json.dumps(
        {k: {f: v[f] for f in ("wall_s", "captures", "prepares", "k1_launches")}
         for k, v in calls.items()}))
    for mode in ("streaming", "quality"):
        first, second = calls[f"{mode}_1"], calls[f"{mode}_2"]
        if second["captures"] or second["prepares"] or not first["captures"] \
                or results[f"{mode}_2"]["tokens"] != results[f"{mode}_1"]["tokens"] \
                or second["k1_launches_by_kernel"] != first["k1_launches_by_kernel"]:
            raise AssertionError(f"a second {mode}-mode call captured {second['captures']} "
                                 f"graphs and prepared {second['prepares']} decoders, or gave "
                                 f"other tokens or K1 launches than the first: {first} {second}")
    # one streaming decoder kept across both calls, its chunk graphs captured once
    (sd,) = asr.stream_decoders.values()
    stream_graphs = graph_summary(sd.graphs)
    if len(sd.graphs.captures) != 2 or sd.graphs.replays != 2 * n_windows \
            or not results["streaming_1"]["tokens"]:
        raise AssertionError(f"streaming mode: graphs {stream_graphs}, tokens "
                             f"{results['streaming_1']['tokens'][:8]}")
    result, launches = results["quality_1"], calls["quality_1"]["k1_launches"]
    by_kernel = calls["quality_1"]["k1_launches_by_kernel"]
    segments = result["segments"]
    check_segments("quality mode", segments, result["words"], LONG_SECONDS)
    windows = len(rungs.records["no_speech"])  # one probe per decoded window
    aligned = len(rungs.records["alignment"])
    if windows != n_windows or [s["seek"] for s in segments] != \
            [i * SECONDS_PER_CLIP for i in range(len(segments))]:
        raise AssertionError(f"quality mode decoded {windows} windows, segments at "
                             f"{[s['seek'] for s in segments]}; expected {n_windows} windows")
    if not rungs.records["sample"] or not aligned or not result["words"]:
        raise AssertionError(f"quality mode ran {len(rungs.records['sample'])} sampled rungs "
                             f"and {aligned} alignments; phase 14 must run both")
    by_mask = launches_by_mask(by_kernel)
    if by_mask != {"unmasked": 12 * (windows + aligned), "unmasked_causal": 12 * aligned}:
        raise AssertionError(f"quality mode launched K1 {by_mask} ({by_kernel}) for {windows} "
                             f"windows and {aligned} alignments, expected 12 per window "
                             "encode and 12 encoder + 12 causal per alignment")
    quality_s = [calls[f"quality_{i}"]["wall_s"] for i in (1, 2)]
    streams = [calls[f"streaming_{i}"]["wall_s"] for i in (1, 2)]
    feats = asr.encode(asr.features(audio[: 16_000 * 30], pad_to=16_000 * 30))
    out.update({
        "windows": windows, "segments": len(segments), "words": len(result["words"]),
        "rungs_per_window": [LONG_TEMPERATURES.index(s["temperature"]) + 1 for s in segments],
        "gates_passed": [s["gates_passed"] for s in segments],
        "avg_logprob": [s["avg_logprob"] for s in segments],
        "no_speech_prob": [s["no_speech_prob"] for s in segments],
        "rungs": rungs.summary(), "rungs_second_call": calls["quality_2"]["rungs"],
        "alignments": rungs.records["alignment"],
        "quality_wall_s": quality_s,
        "quality_audio_s_per_s": [LONG_SECONDS / x for x in quality_s],
        "streaming_wall_s": streams,
        "streaming_audio_s_per_s": [LONG_SECONDS / x for x in streams],
        "captures_by_call": {k: v["captures"] for k, v in calls.items()},
        "prepares_by_call": {k: v["prepares"] for k, v in calls.items()},
        "decode_captures": [{f: c[f] for f in ("loop", "capture_s", "instantiate_s")}
                            for c in asr.decode_programs.captures],
        "encode_graphs": graph_summary(asr.encode_program),
        "decode_pool_bytes": pool_bytes(asr.decode_programs),
        "streaming_capture_s": sum(c["capture_s"] + c["instantiate_s"]
                                   for c in sd.graphs.captures),
        "streaming_graphs": stream_graphs,
        "rung_programs_vs_eager_bf16": rung_programs_equal(asr, feats, LONG_MAX_LEN,
                                                           LONG_TEMPERATURES[1], seed),
        "k1_launches": launches, "k1_launches_by_kernel": by_kernel,
        "k1_launches_per_quality_window": 12})
    del feats

    # The alignment forward alone, at the largest bucket the run used.
    bucket = max(r["bucket"] for r in rungs.records["alignment"])
    n_text = max(r["n_text"] for r in rungs.records["alignment"])
    decoder = asr.decoder.prepare_decode_params()
    enc = asr.encode(asr.features(audio[: 16_000 * 30], pad_to=16_000 * 30))
    toks = torch.from_numpy(rng.integers(0, VOCAB, (1, bucket))).cuda()

    def forward():
        with torch.no_grad():
            return decoder(toks, enc, return_cross_weights=True)

    forward()
    fa.reset_launches()
    logits, weights = forward()
    torch.cuda.synchronize()
    align_by_mask = launches_by_mask(fa.launches_by_kernel)
    if fa.launches != 12 or align_by_mask != {"unmasked_causal": 12} \
            or tuple(weights.shape) != (12, 1, 12, bucket, 1500) \
            or not torch.isfinite(weights).all() or not torch.isfinite(logits).all():
        raise AssertionError(f"the alignment forward launched K1 {dict(fa.launches_by_kernel)} "
                             f"and returned weights {tuple(weights.shape)}")
    align_ms = cuda_ms(forward, 5)
    align_device_ms, align_kernels = device_ms(forward, iters=3)
    # the host side of one alignment: the cross weights to the host, then the
    # numpy statistics (heads, z-norm, median filter) over the run's rows
    t0 = time.perf_counter()
    host_weights = weights[:, :, :, : n_text + len(PREFIX) + 1].cpu().numpy()
    t1 = time.perf_counter()
    timestamps.alignment_matrix(host_weights, n_frames=1500)
    to_host_ms, statistics_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    cost = -rng.standard_normal((n_text, 1500))
    native.dtw(cost)
    t0 = time.perf_counter()
    for _ in range(5):
        path = native.dtw(cost)
    dtw_ms = (time.perf_counter() - t0) / 5 * 1e3
    plain = native.plain_dtw(cost)
    if not (np.array_equal(path[0], plain[0]) and np.array_equal(path[1], plain[1])):
        raise AssertionError(f"the native DTW at {cost.shape} differs from its plain version")
    out["alignment_forward"] = {"bucket": bucket, "k1_launches": 12, "wall_ms": align_ms,
                                "device_ms": align_device_ms, "kernels": align_kernels,
                                "weights_to_host_ms": to_host_ms,
                                "statistics_ms": statistics_ms}
    out["dtw"] = {"shape": list(cost.shape), "ms": dtw_ms, "equals_plain": True}
    del decoder, enc, logits, weights, host_weights
    log(f"long-form quality bf16 ({n_windows} windows of 30 s): " + json.dumps(out))

    # 2. timestamp-conditioned seek over a 30 s clip
    clip = audio[: 16_000 * 30]
    rules = LogitRules.for_whisper(GENERATION_CONFIG, VOCAB, timestamps=True)
    with RungTimer() as seek_rungs:
        fa.reset_launches()
        seek, seek_s = timed_call(lambda: asr.transcribe(
            clip, ASR_PREFIX, tokenizer=tok, beam_size=BEAM, max_len=SEEK_MAX_LEN, eos_id=EOS,
            temperatures=(0.0,), logprob_threshold=None, compression_ratio_threshold=None,
            logit_rules=rules, seed=seed))
    seek_windows = len(seek_rungs.records["beam"])
    check_segments("timestamp seek", seek["segments"], None, SECONDS_PER_CLIP)
    origins = sorted({s["seek"] for s in seek["segments"]})
    if not 1 <= seek_windows <= 20 or fa.launches != 12 * seek_windows \
            or any(t >= TIMESTAMP_BEGIN for t in seek["tokens"]):
        raise AssertionError(f"timestamp seek: {seek_windows} windows, K1 {fa.launches}, "
                             f"tokens {seek['tokens'][:16]}...")
    out["timestamp_seek"] = {
        "windows": seek_windows, "segments": len(seek["segments"]), "origins": origins,
        "spans": [[s["start"], s["end"]] for s in seek["segments"]], "wall_s": seek_s,
        "max_len": SEEK_MAX_LEN, "rungs": seek_rungs.summary()}
    log("timestamp seek bf16 (30 s clip): " + json.dumps(out["timestamp_seek"]))
    del asr
    torch.cuda.empty_cache()

    # 3. fp32, one window, card against CPU, one noise for both
    got = {}
    for device in ("cuda", "cpu"):
        model = load_jax_params(WhisperASR("whisper-small", precision=L.FP32, device=device),
                                tree).eval()
        r, wall = timed_call(lambda: model.transcribe(
            clip, PREFIX, tokenizer=tok, beam_size=BEAM, best_of=BEAM, max_len=FP32_MAX_LEN,
            eos_id=EOS, temperatures=FP32_TEMPERATURES,
            logprob_threshold=10.0,  # never met: the sampled rung is the one compared
            draws=GumbelDraws(seed, generate_on="cpu")))
        got[device] = (r, wall)
        if device == "cuda":
            fp32_rungs = rung_programs_equal(
                model, model.encode(model.features(clip, pad_to=16_000 * 30)), FP32_MAX_LEN,
                FP32_TEMPERATURES[-1], seed)
        del model
    (card, card_s), (cpu, cpu_s) = got["cuda"], got["cpu"]
    (cs,), (hs,) = card["segments"], cpu["segments"]
    err = abs(cs["avg_logprob"] - hs["avg_logprob"])
    fp32 = {"tokens": len(card["tokens"]), "temperature": cs["temperature"],
            "gates_passed": cs["gates_passed"], "avg_logprob_abs_err": err,
            "atol": FP32_LOGPROB_ATOL, "card_s": card_s, "cpu_s": cpu_s,
            "rung_programs_vs_eager": fp32_rungs}
    log("long-form fp32 one window, card vs CPU: " + json.dumps(fp32))
    if card["tokens"] != cpu["tokens"] or cs["temperature"] != hs["temperature"] \
            or cs["temperature"] != FP32_TEMPERATURES[-1] \
            or cs["gates_passed"] != hs["gates_passed"] or not err <= FP32_LOGPROB_ATOL:
        raise AssertionError(f"fp32 long-form card vs CPU differ:\n{card['tokens']}\n"
                             f"{cpu['tokens']}\n{cs}\n{hs}")
    out["fp32_card_vs_cpu"] = fp32

    # 4. the command line on a 12 s 44.1 kHz WAV, against transcribe() on the same weights
    workdir = os.path.join(root, "build", "chip_smoke_transcribe")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        wav_path = os.path.join(workdir, "clip.wav")
        with wave.open(wav_path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(44_100)
            w.writeframes((longform_audio(rng, 12.0, 44_100) * 32767).astype("<i2").tobytes())
        argv = [wav_path, "--random-init", "--model", "whisper-small", "--precision", "bf16",
                "--seed", str(seed), "--output-format", "all", "--output-dir", workdir,
                "--max-len", str(SEEK_MAX_LEN), "--temperature", "0.0", "0.4",
                "--word-timestamps"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = transcribe_cli.main(argv)
        cli_s = time.perf_counter() - t0
        asr = load_jax_params(WhisperASR("whisper-small", precision=L.BF16, device="cuda"),
                              tree).eval()
        want = asr.transcribe(transcribe_cli.load_audio(wav_path), tok.prefix_token_ids,
                              tokenizer=tok, max_len=SEEK_MAX_LEN, eos_id=tok.eos_token_id,
                              temperatures=(0.0, 0.4), word_times=True, group_fn=group_fn,
                              seed=seed)
        sizes = {fmt: os.path.getsize(os.path.join(workdir, f"clip.{fmt}"))
                 for fmt in WRITER_FORMATS}
        with open(os.path.join(workdir, "clip.json"), encoding="utf-8") as f:
            doc = json.load(f)
        with open(os.path.join(workdir, "clip.txt"), encoding="utf-8") as f:
            txt = f.read()
        if rc != 0 or doc["text"] != want["text"] or not all(sizes.values()) \
                or txt != "".join((s["text"] or "").strip() + "\n" for s in want["segments"]):
            raise AssertionError(f"the transcribe command (rc {rc}, files {sizes}) differs from "
                                 "transcribe() on the same weights")
        out["cli"] = {"argv": argv[1:], "rc": rc, "s": cli_s, "bytes": sizes,
                      "segments": len(doc["segments"]), "words": len(doc.get("words") or ())}
        log("transcribe command: " + json.dumps(out["cli"]))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# -- phase 15: int8 weights and caches ------------------------------------------------------


def module_bytes(module) -> int:
    """Bytes of a module's parameters, and of a prepared decoder's fp32 vocab
    table where it keeps one."""
    n = sum(p.numel() * p.element_size() for p in module.parameters())
    table = getattr(module, "vocab_table", None)
    return n + (table.numel() * table.element_size() if table is not None else 0)


def cache_bytes(cache: dict) -> dict:
    """Bytes of a decode cache's self and cross parts, scales included."""
    out = {"self": 0, "cross": 0}
    for name, t in cache.items():
        out[name.split("_")[0]] += t.numel() * t.element_size()
    return out


def linear_forms(dev) -> dict:
    """Wall ms of one int8 linear forward as the port computes it
    (``layers.QuantLinear``: fp32 operands, TF32 off) against the bf16 linear
    and against the other form, a bf16 product with an fp32 result
    (``torch.mm(out_dtype=)``, where this torch has it), at whisper-small's
    fc1 with the decode step's rows and the frozen encoder's."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, rows in (("decode_fc1", B * BEAM), ("encoder_fc1", B * 1500)):
        lin = L.Linear(768, 3072, True, L.BF16, dev)
        with torch.no_grad():
            lin.kernel.copy_(torch.randn(768, 3072, generator=gen) * 0.03)
        q = L.QuantLinear.from_linear(lin)
        x = torch.randn(rows, 768, generator=gen).to(dev, torch.bfloat16)

        def bf16_product():
            y = torch.mm(x, q.kernel_q.to(torch.bfloat16), out_dtype=torch.float32)
            return (y * q.scale + q.bias).to(torch.bfloat16)

        row = {"rows": rows, "bf16_linear_ms": cuda_ms(lambda: lin(x), 50),
               "int8_fp32_operands_ms": cuda_ms(lambda: q(x), 50)}
        try:
            err = (bf16_product().float() - q(x).float()).abs().max().item()
            row.update(int8_bf16_product_ms=cuda_ms(bf16_product, 50), bf16_product_vs_port=err)
        except (TypeError, RuntimeError) as e:
            row.update(int8_bf16_product_ms=None, bf16_product_error=str(e)[:120])
        out[name] = row
    log("int8 linear forms: " + json.dumps(out))
    return out


def check_int8_fp32(seed: int) -> dict:
    """fp32 beam tokens of every int8 mode, card against CPU, at
    whisper-small width with 2 + 2 Whisper layers."""
    rng = np.random.default_rng(seed)
    mel, raw = make_batch(rng, 1, 32, "cpu")
    tokens = {}
    for dev in ("cuda", "cpu"):
        net = small_av_net(seed, dev)
        feats, valid = net.encode(preprocess(mel.to(dev), raw.to(dev)))
        for name, (wq, cq) in INT8_MODES.items():
            if name != "bf16":
                res = beam_search(net.decoder.prepare_decode_params(wq), feats, PREFIX,
                                  beam_size=BEAM, max_len=INT8_FP32_MAX_LEN, eos_id=EOS,
                                  encoder_valid=valid, cache_quant=cq)
                tokens[dev, name] = res.sequences.cpu()
        del net
    out = {name: bool(torch.equal(tokens["cuda", name], tokens["cpu", name]))
           for name in INT8_MODES if name != "bf16"}
    log(f"int8 fp32 beam tokens card == CPU ({INT8_FP32_MAX_LEN} tokens, 2 + 2 layers): "
        + json.dumps(out))
    if not all(out.values()):
        raise AssertionError(f"fp32 int8 beam tokens differ card vs CPU: {out}")
    return out


def check_int8_logits(net, feats, valid, rng) -> dict:
    """Teacher-forced bf16 steps of each int8 mode against the bf16 step on
    the same tokens: the largest |difference| over the step's spread
    (largest minus smallest logit), which must stay below
    ``INT8_LOGIT_SPREAD``, the JAX package's own bound."""
    dev = feats.device
    toks = torch.from_numpy(rng.integers(0, VOCAB, (INT8_LOGIT_STEPS, B, 1))).to(dev)

    def steps(dec, cq):
        cache = dec.init_cache(feats, max_len=INT8_LOGIT_STEPS, quant=cq)
        return [dec.decode_step(toks[i], cache, i, valid)[0] for i in range(INT8_LOGIT_STEPS)]

    base = net.decoder.prepare_decode_params()
    ref = steps(base, None)
    out = {}
    for name, (wq, cq) in INT8_MODES.items():
        if name == "bf16":
            continue
        got = steps(base if wq is None else net.decoder.prepare_decode_params(wq), cq)
        out[name] = max(((g - r).abs().max() / (r.max() - r.min())).item()
                        for g, r in zip(got, ref))
    log(f"int8 bf16 step logits, max |diff| / spread over {INT8_LOGIT_STEPS} steps "
        f"(bound {INT8_LOGIT_SPREAD}): " + json.dumps(out))
    if not all(v < INT8_LOGIT_SPREAD for v in out.values()):
        raise AssertionError(f"int8 logits leave the JAX package's bound: {out}")
    return out


def time_int8_decodes(net, batch, feats, valid) -> dict:
    """The direct decode of phase 4 in each mode, in turns: for the modes of
    ``INT8_TRACED``, device ms and
    kernels per step over a window of ``INT8_WINDOW`` loop steps (two
    device-only traced searches, with and without the window, so that the
    cache and the prefix steps cancel), then a first ``AVWhisperNet.beam``
    call, which captures the mode's decode program (its seconds), and a
    timed one (encode and 156 replayed steps) with its K1 launches and peak
    memory; the prepared decoder's and the cache's bytes. The decodes run
    ``INT8_MAX_TOKENS`` tokens, not phase 4's 160: each mode's first call
    captures after an eager run, and the five of them are the phase's
    largest cost."""
    enc_ms = cuda_ms(lambda: net.encode(batch), 3)
    out = {"encode_ms": enc_ms}
    for name, (wq, cq) in INT8_MODES.items():
        t0 = time.perf_counter()
        dec = net.decoder.prepare_decode_params(wq)
        torch.cuda.synchronize()
        prepare_ms = (time.perf_counter() - t0) * 1e3
        windows, records, t_trace = [], [], time.perf_counter()
        for loop_steps in (0, INT8_WINDOW) if name in INT8_TRACED else ():
            _, records, _, _ = traced(lambda: beam_search(
                dec, feats, PREFIX, beam_size=BEAM, max_len=len(PREFIX) + loop_steps,
                eos_id=EOS, encoder_valid=valid, cache_quant=cq), cpu=False)
            windows.append((sum(ev.device_time for ev in records) / 1e3, len(records)))
        by_kernel: dict[str, float] = {}
        for ev in records:  # the longer window's kernels, the prefix's included
            by_kernel[ev.name[:60]] = by_kernel.get(ev.name[:60], 0.0) + ev.device_time / 1e3
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
        per_step = ([(windows[1][i] - windows[0][i]) / INT8_WINDOW for i in (0, 1)] if windows
                    else [None, None])
        cache = cache_bytes(dec.init_cache(feats, max_len=INT8_MAX_TOKENS, beam_groups=BEAM,
                                           quant=cq))
        decoder_bytes = module_bytes(dec)
        trace_s = time.perf_counter() - t_trace
        del dec
        decode = lambda: net.beam(batch, PREFIX, beam_size=BEAM, max_len=INT8_MAX_TOKENS,
                                  eos_id=EOS, weight_quant=wq, cache_quant=cq)
        _, first_s = timed_call(decode)
        capture = net.decode_programs.captures[-1]
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        res, wall_s = timed_call(decode)
        launches = fa.launches
        seq = res.sequences
        if launches != 15:
            raise AssertionError(f"int8 mode {name}: K1 launched {launches} times, expected 15")
        if tuple(seq.shape) != (B, BEAM, INT8_MAX_TOKENS) or not torch.isfinite(res.scores).all() \
                or not bool((seq[:, :, :len(PREFIX)] == torch.tensor(PREFIX, device=seq.device))
                            .all()):
            raise AssertionError(f"int8 mode {name}: bad beam output {tuple(seq.shape)}")
        n_steps = INT8_MAX_TOKENS - len(PREFIX)
        row = {"weight_quant": wq, "cache_quant": cq, "wall_ms": wall_s * 1e3,
               "rtf": B * SECONDS_PER_CLIP / wall_s,
               "decode_ms_per_step": (wall_s * 1e3 - enc_ms) / n_steps,
               "prepare_ms": prepare_ms, "first_call_s": first_s,
               "capture_s": capture["capture_s"], "instantiate_s": capture["instantiate_s"],
               "device_ms_per_step": per_step[0], "device_ops_per_step": per_step[1],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "decoder_bytes": decoder_bytes, "cache_bytes": cache,
               "k1_launches_per_batch": launches, "trace_s": trace_s,
               "window_top_kernels_ms": top}
        log(f"int8 mode {name}: " + json.dumps(row))
        out[name] = row
    return out


def check_int8_audio(seed: int) -> dict:
    """An int8 audio engine's rows against a direct int8 decode of the same
    padded bucket; then ``transcribe(weight_quant="int8", word_times=True)``
    over one 30 s window, whose alignment forward must run its 12 causal K1
    launches on the int8 decoder."""
    rng = np.random.default_rng(seed + 15)
    asr = WhisperASR("whisper-small", precision=L.BF16, device="cuda")
    load_jax_params(asr, random_asr_params(asr, seed)).eval()
    wavs = [canonical_wav((0.1 * rng.standard_normal(16_000 * (3 + i))).astype(np.float32))
            for i in range(3)]
    kw = dict(beam_size=BEAM, max_len=INT8_ASR_MAX_LEN, eos_id=EOS, weight_quant="int8")
    with make_audio_engine(asr, ASR_PREFIX, buckets=(4,), max_wait_s=1.0, **kw) as eng:
        results = [f.result(timeout=WAIT_S) for f in [eng.submit(w) for w in wavs]]
    (padded,) = pad_rows([(w,) for w in wavs], 4)
    direct = asr.transcribe_tokens(torch.from_numpy(padded).cuda(), ASR_PREFIX,
                                   **kw).cpu().numpy()
    if [r.bucket for r in results] != [4, 4, 4]:
        raise AssertionError(f"int8 audio engine buckets {[r.bucket for r in results]}")
    for i, r in enumerate(results):
        want = trim_at_eos(direct[i], EOS, len(ASR_PREFIX))
        if r.tokens.tolist() != want.tolist():
            raise AssertionError(f"int8 audio engine row {i} differs from the direct decode:\n"
                                 f"{r.tokens.tolist()}\n{want.tolist()}")
    out = {"engine_rows_equal_direct": True, "engine_decode_ms": [r.decode_ms for r in results]}

    audio = longform_audio(rng, SECONDS_PER_CLIP)
    fa.reset_launches()
    result, wall_s = timed_call(lambda: asr.transcribe(
        audio, PREFIX, temperatures=(0.0,), word_times=True, group_fn=token_words,
        **kw))
    by_mask = launches_by_mask(fa.launches_by_kernel)
    check_segments("int8 transcribe", result["segments"], result["words"], SECONDS_PER_CLIP)
    if by_mask != {"unmasked": 24, "unmasked_causal": 12} or not result["words"]:
        raise AssertionError(f"int8 transcribe launched K1 {dict(fa.launches_by_kernel)} with "
                             f"{len(result['words'] or [])} words; expected 12 + 12 encoder "
                             "and 12 causal alignment launches")
    out["transcribe"] = {"wall_ms": wall_s * 1e3, "words": len(result["words"]),
                         "k1_launches_by_mask": by_mask}
    log("int8 audio: " + json.dumps(out))
    return out


def run_int8_train(seed: int) -> dict:
    """``Trainer.fit`` at phase 7's shape and dropout, the frozen encoder
    stored in bf16 and in int8; the frozen encoder's bytes of each."""
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_int8")
    shutil.rmtree(workdir, ignore_errors=True)
    batch = synthetic_train_batch(np.random.default_rng(seed + 3), B, T_VIDEO,
                                  torch.device("cuda"))
    out = {}
    try:
        for name, overrides in (("bf16_storage", {"training.frozen_param_dtype": "bf16"}),
                                ("int8", {"training.frozen_weight_quant": "int8"})):
            out[name], trainer = fit_timed(f"frozen_{name}", seed, batch, workdir, overrides, 12)
            enc = trainer.net.whisper_encoder
            out[name]["frozen_encoder_bytes"] = module_bytes(enc)
            out[name]["frozen_encoder_params"] = sum(p.numel() for p in enc.parameters())
            del trainer, enc
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["fp32_frozen_encoder_bytes"] = out["bf16_storage"]["frozen_encoder_bytes"] * 2
    return out


def run_int8(seed: int, phase7_ms: float) -> dict:
    """Phase 15: int8 weights and caches at full width, BF16, phase 4's
    shape (see ``INT8_MODES``)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    part_s = {}

    def part(name, fn):
        t = time.perf_counter()
        result = fn()
        part_s[name] = time.perf_counter() - t
        return result

    out = {"linear_forms": part("linear_forms", lambda: linear_forms(dev)),
           "fp32_card_vs_cpu": part("fp32_card_vs_cpu", lambda: check_int8_fp32(seed))}
    net = part("build", lambda: build(seed, L.BF16, dev))
    mb = make_batch(np.random.default_rng(seed + 1), B, T_VIDEO, dev)
    batch = preprocess(*mb)
    feats, valid = net.encode(batch)
    out["logits_vs_bf16"] = part("logits", lambda: check_int8_logits(
        net, feats, valid, np.random.default_rng(seed)))
    out["decode"] = part("decode", lambda: time_int8_decodes(net, batch, feats, valid))
    del net, feats, valid, batch, mb
    torch.cuda.empty_cache()
    out["audio"] = part("audio", lambda: check_int8_audio(seed))
    out["train"] = part("train", lambda: run_int8_train(seed))
    out["train"]["phase7_bf16_ms_per_step"] = phase7_ms
    out["k1_launches_per_batch"] = {name: row["k1_launches_per_batch"]
                                    for name, row in out["decode"].items()
                                    if isinstance(row, dict)}
    out["phase_s"], out["part_s"] = time.perf_counter() - t0, part_s
    log("int8 path: " + json.dumps({k: out[k] for k in ("k1_launches_per_batch", "phase_s",
                                                        "part_s")}))
    return out


# -- phase 16: multi-rank training on one card ---------------------------------------------


def multicard_batches(seed: int) -> list[dict]:
    """Two global batches (B=4, 400 frames, 64 target tokens) on the CPU,
    made from the seed alike in every process; a fit takes them in turn."""
    rng = np.random.default_rng(seed + 16)
    return [synthetic_train_batch(rng, B, T_VIDEO, "cpu") for _ in range(2)]


class _MeshDataModule:
    """Global batches; each data index takes its rows of them."""

    def __init__(self, batches: list[dict], mesh, steps: int):
        self.batches, self.steps = [shard_batch(mesh, b) for b in batches], steps

    def train_dataloader(self):
        dm = self

        class Loader:
            def __len__(self):
                return dm.steps

            def __iter__(self):
                for i in range(dm.steps):
                    yield dict(dm.batches[i % len(dm.batches)])

        return Loader()

    def val_dataloader(self):
        batch = self.batches[0]
        return [dict(batch, target_text=["synthetic"] * len(batch["target_ids"]))]

    test_dataloader = val_dataloader


def multicard_fit(seed: int, batches: list[dict], tree, mesh: tuple, precision: str,
                  steps: int, workdir: str, overrides: dict | None = None, probe=None,
                  eager: bool = False):
    """``Trainer.fit`` at full width (whisper-small, MoCo ResNet-50, the
    fusion at phase 7's settings with dropout 0, gates at 0.5) on the mesh
    ``(data, model)`` of this process's run. ``tree``: the weights (None:
    drawn from ``seed``); ``probe(trainer)`` runs before the fit, and its
    result is kept as ``trainer.probe``; ``eager``: the eager step (set
    after the probe: the comparison). The fit must run the step its groups
    decide: the program on NCCL or without a group, eager on gloo. Returns
    (trainer, tree)."""
    fp32 = precision == "float32"
    config = get_config({
        "training.epochs": 1, "training.accumulate_grad_batches": 2 if fp32 else 1,
        "training.seed": seed, "model.dropout": 0.0, "precision.compute_dtype": precision,
        "precision.rematerialize": False, "output.log_every_n_steps": 1,
        "output.save_predictions": False, "mesh.data": mesh[0], "mesh.model": mesh[1],
        "output.checkpoint_dir": os.path.join(workdir, "checkpoints"),
        "output.log_dir": os.path.join(workdir, "logs"), **(overrides or {})})
    net = AVNet("audiovisual", None, 96, MODELARGS[:5] + (0.0,), VOCAB,
                whisper_name="whisper-small", precision=L.FP32 if fp32 else L.BF16,
                device="cuda")
    if tree is None:
        tree = random_avnet_params(net, seed)
        for layer in tree["fusion"]["layers"]:
            layer["attn_gate"] = layer["ff_gate"] = np.float32(GATE)
    load_jax_params(net, tree)
    trainer = Trainer(config, net, ByteTokenizer())
    if trainer.is_chief:
        trainer.writer = _RecordingWriter(trainer.writer.path)
    trainer.step_timestamps = []
    trainer.probe = probe(trainer) if probe else None
    expected = "eager" if eager else step_kind(trainer.device, trainer.mesh.backends())
    if eager:
        trainer.step_kind = "eager"
    trainer.fit(_MeshDataModule(batches, trainer.mesh, steps), max_steps=steps)
    torch.cuda.synchronize()
    if (trainer.step_kind, trainer.program is None) != (expected, expected == "eager"):
        raise AssertionError(f"a fit on groups {trainer.mesh.backends()} ran the "
                             f"{trainer.step_kind} step, expected the {expected} step")
    return trainer, tree


def _trainable(trainer) -> dict:
    """The whole trainable parameters on the CPU (gathered over the model group)."""
    whole = gather_state_dict(trainer.net, trainer.mesh)
    return {n: whole[n].detach().float().cpu() for n, _ in trainer.net.trainable_parameters()}


def global_gradient(trainer, batch: dict) -> dict:
    """The trainable parameters' gradient of the global batch's loss at the
    trainer's parameters (fp32, no dropout), whole on the CPU: this rank's
    rows, summed over the data group, gathered over the model group. Taken
    at the starting weights, it holds the reduce and the loss normalisation
    against one process where two Adam updates would blur them: an update
    moves an element by about the learning rate whatever its gradient, so
    a gradient within rounding of 0 may move either way."""
    placed = trainer._ready(trainer._put_batch(shard_batch(trainer.mesh, batch)))
    placed.pop("target_text", None)
    loss, _ = trainer.task.loss_fn(placed, None, train=True)
    named = trainer.net.trainable_parameters()
    grads = torch.autograd.grad(loss, [p for _, p in named])
    dims = sharded_dims(trainer.net)
    out = {}
    for (name, _), grad in zip(named, grads):
        grad = all_reduce_sum(grad.contiguous(), trainer.mesh.data_group)
        if name in dims:
            grad = all_gather_cat(grad, trainer.mesh.model_group, dims[name])
        out[name] = grad.float().cpu()
    return out


def _compare(ours: dict, ref: dict, atol: float) -> dict:
    """Largest absolute difference and its tensor; the largest difference
    relative to its tensor's largest reference value, with that tensor and
    value; the share of elements that differ by more than ``atol``."""
    diffs = {n: (ours[n] - ref[n]).abs() for n in ref}
    worst = max(diffs, key=lambda n: diffs[n].max().item())
    scale = {n: ref[n].abs().max().item() for n in ref}
    rel = max(diffs, key=lambda n: diffs[n].max().item() / max(scale[n], 1e-30))
    beyond = sum(int((d > atol).sum()) for d in diffs.values())
    top = max(scale.values())
    return {"max_abs": diffs[worst].max().item(), "max_abs_in": worst,
            "max_abs_tensor_scale": scale[worst], "largest_value": top,
            "max_abs_over_largest_value": diffs[worst].max().item() / top,
            "max_rel": diffs[rel].max().item() / max(scale[rel], 1e-30), "max_rel_in": rel,
            "max_rel_tensor_scale": scale[rel],
            "share_beyond": beyond / sum(d.numel() for d in diffs.values()), "atol": atol}


def _ms_per_step(trainer) -> float:
    ts = trainer.step_timestamps
    return (ts[-1] - ts[MULTI_WARMUP - 1]) * 1e3 / (len(ts) - MULTI_WARMUP)


def count_k1_shapes(counter: collections.Counter):
    """From now on count K1's launches by ``[B, Tq, Tk, H, Dh]`` into
    ``counter``; returns the launch function it wraps."""
    launch = fa._launch

    def counted(q, k, v, *args, **kwargs):
        counter[str([q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]])] += 1
        return launch(q, k, v, *args, **kwargs)

    fa._launch = counted
    return launch


@contextlib.contextmanager
def k1_shapes(counter: collections.Counter):
    """``count_k1_shapes`` inside the block only."""
    launch = count_k1_shapes(counter)
    try:
        yield counter
    finally:
        fa._launch = launch


def multicard_rank(spec_path: str, rank: int) -> int:
    """One rank of a phase-16 leg (``--multicard-rank SPEC RANK``): the fp32
    fit, whose whole trainable parameters rank 0 saves, then the bf16 timed
    fit. K1's launches are counted by shape, and the host's time inside the
    collectives is summed over the timed steps."""
    spec = json.load(open(spec_path))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"file://{spec['store']}", spec["world"], rank, backend="gloo",
                           timeout_s=MULTI_RANK_LIMIT_S)
    shapes = collections.Counter()
    count_k1_shapes(shapes)
    calls = []

    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                calls.append((t0, time.perf_counter() - t0))
        return wrapper

    dist.all_reduce, dist.all_gather = timed(dist.all_reduce), timed(dist.all_gather)
    batches = multicard_batches(spec["seed"])
    mesh = tuple(spec["mesh"])
    out = {"rank": rank}
    fa.reset_launches()
    def probe(trainer):  # the gradient at the start; its launches are not the fit's
        grad = global_gradient(trainer, batches[0])
        fa.reset_launches()
        shapes.clear()
        return grad

    trainer, tree = multicard_fit(spec["seed"], batches, None, mesh, "float32",
                                  MULTI_FP32_STEPS, os.path.join(spec["workdir"], "fp32"),
                                  probe=probe)
    out["step_kind"] = trainer.step_kind
    out["fp32"] = {"mesh_index": [trainer.mesh.data_index, trainer.mesh.model_index],
                   "k1_launches": fa.launches,
                   "k1_by_kernel": dict(fa.launches_by_kernel), "k1_by_shape": dict(shapes),
                   "scalars": getattr(trainer.writer, "scalars", None)}
    params, grad = _trainable(trainer), trainer.probe
    if rank == 0:
        torch.save({"params": params, "grad": grad},
                   os.path.join(spec["workdir"], "fp32_params.pt"))
    del trainer, params, grad
    torch.cuda.empty_cache()
    fa.reset_launches()
    shapes.clear()
    trainer, _ = multicard_fit(spec["seed"], batches, tree, mesh, "bfloat16", MULTI_STEPS,
                               os.path.join(spec["workdir"], "bf16"))
    ts = trainer.step_timestamps
    comm = sum(dt for t0, dt in calls if ts[MULTI_WARMUP - 1] <= t0 < ts[-1])
    out["bf16"] = {"ms_per_step": _ms_per_step(trainer),
                   "collective_ms_per_step": comm * 1e3 / (len(ts) - MULTI_WARMUP),
                   "k1_by_kernel": dict(fa.launches_by_kernel), "k1_by_shape": dict(shapes),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    with open(os.path.join(spec["workdir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def size_one_groups(trainer) -> None:
    """The NCCL world-1 child's arrangement: a data and a model group of its
    one rank (``dist.new_group([0])`` each) set on the trainer's mesh and its
    task before the fit, so that the step makes the data group's collectives
    (the flat gradient reduce, the global counts and losses) on NCCL; the
    step kind is decided again from the groups."""
    mesh = trainer.mesh
    mesh.data_group, mesh.model_group = dist.new_group([0]), dist.new_group([0])
    trainer.task.data_group = mesh.data_group
    trainer.step_kind = step_kind(trainer.device, mesh.backends())


def nccl_world_one(spec_path: str) -> int:
    """``--nccl-world-one SPEC``: under torchrun's variables with one
    process, ``initialize_distributed()`` joins an NCCL group, and the mesh
    takes size-1 data and model groups (``size_one_groups``). One fp32 step
    of the joint CTC + CE loss through the train program, its collectives
    captured in the graph (the CTC kernels sum in a fixed order, so this
    compares bits), is saved for the parent and held against the eager step
    on the same groups; then one replayed step's synchronising calls (none
    allowed), the host's collective calls (none: the graph makes them) and
    the NCCL device operations that the profiler sees."""
    spec = json.load(open(spec_path))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = train_entry.rank_device("cuda")
    torch.cuda.set_device(torch.device(device))
    initialize_distributed()
    calls = collections.Counter()

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls[fn.__name__] += 1
            return fn(*args, **kwargs)
        return wrapper

    dist.all_reduce, dist.all_gather = counted(dist.all_reduce), counted(dist.all_gather)
    batches = multicard_batches(spec["seed"])
    workdir = spec["workdir"]
    trainer, tree = multicard_fit(spec["seed"], batches, None, (-1, 1), "float32", 1,
                                  os.path.join(workdir, "nccl"), NCCL_OVERRIDES,
                                  probe=size_one_groups)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "device": device,
           "groups": trainer.mesh.backends(), "step_kind": trainer.step_kind,
           "collective_calls_in_fit": sum(calls.values()),
           "expected_collective_calls_in_fit": 2 * (NCCL_TRAIN_COLLECTIVES
                                                    + NCCL_EVAL_COLLECTIVES),
           "captures": len(trainer.program.captures),
           "eval_captures": len(trainer.program.eval_program.captures)}
    params = _trainable(trainer)
    torch.save(params, os.path.join(workdir, "nccl_params.pt"))
    twin, _ = multicard_fit(spec["seed"], batches, tree, (-1, 1), "float32", 1,
                            os.path.join(workdir, "nccl_eager"), NCCL_OVERRIDES,
                            probe=size_one_groups, eager=True)
    eager = _trainable(twin)
    out["eager_step_kind"] = twin.step_kind
    out["differ_from_eager"] = [n for n in params if not torch.equal(params[n], eager[n])]
    out["losses_equal_eager"] = (_train_scalars(trainer.writer.scalars)
                                 == _train_scalars(twin.writer.scalars))
    del twin, eager
    placed = trainer._ready(trainer._put_batch(shard_batch(trainer.mesh, batches[0])))
    placed.pop("target_text", None)
    out["syncs_per_replayed_step"] = sync_report(trainer, placed)["syncs"]
    calls.clear()
    _, records, _, _ = traced(lambda: trainer.program.train_step(placed), cpu=False)
    out["collective_calls_per_replay"] = sum(calls.values())
    out["collectives_per_train_step"] = NCCL_TRAIN_COLLECTIVES
    out["nccl_device_ops_per_replay"] = sum(1 for ev in records if "nccl" in ev.name.lower())
    out["nccl_note"] = ("NCCL enqueues no kernel for an in-place sum over one rank, so the "
                        "captured collectives of a world of one may show no device operation")
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


NCCL_OVERRIDES = {"training.accumulate_grad_batches": 1}
# The collectives one train step makes on the data group (the flat gradient reduce, the
# global counts, the global losses; the clip norm reduces over the model group only where
# a parameter is split), and one eval step (the counts, the losses).
NCCL_TRAIN_COLLECTIVES, NCCL_EVAL_COLLECTIVES = 3, 2


def _spawn(args: list[str], workdir: str, name: str, env: dict | None = None):
    log_path = os.path.join(workdir, f"{name}.log")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="4", **(env or {}))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], cwd=root,
                            env=env, stdout=open(log_path, "w"), stderr=subprocess.STDOUT), log_path


def _wait(procs: list, limit_s: float, what: str) -> None:
    """Wait for every process; any that exits non-zero or runs past
    ``limit_s`` stops them all and fails the phase."""
    deadline = time.monotonic() + limit_s
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [(p, path) for p, path in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        bad = [(i, p.poll(), path) for i, (p, path) in enumerate(procs) if p.poll() != 0]
        if bad:
            tails = "\n".join(f"--- {what} process {i} (exit {rc}) ---\n"
                              + open(path).read()[-4000:] for i, rc, path in bad)
            raise AssertionError(f"{what}: a process failed or ran past {limit_s} s\n{tails}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_multicard(seed: int) -> dict:
    """Phase 16: multi-rank training at full width, two gloo processes
    sharing the card. Against one process on the same global batch, in
    fp32: each leg's gradient at the starting weights, its parameters after
    two updates and its losses, within the ``MULTI_*`` tolerances; the
    data=2 gradient equals the mean of the two halves' gradients in one
    process bit for bit; each rank launches K1 at its shard shapes, and runs
    the eager step (gloo). The NCCL world-1 step, size-1 groups on its mesh,
    runs through the train program with its collectives captured: it equals
    its eager step and the step without a process group bit for bit, and a
    replayed step synchronises nothing. bf16 ms per step of the legs and of
    one process, in turns."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # fp32 products as the child processes take them (no TF32 in cuBLAS or cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_multicard")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    out = {"shape": {"global_batch": B, "frames": T_VIDEO, "target_tokens": TARGET_TOKENS,
                     "fp32_micro_batches": MULTI_FP32_STEPS, "accumulate_grad_batches": 2,
                     "bf16_steps": MULTI_STEPS, "warmup_steps": MULTI_WARMUP},
           "note": NOT_SCALING}
    try:
        spec = os.path.join(workdir, "spec.json")
        with open(spec, "w") as f:
            json.dump({"seed": seed, "workdir": workdir}, f)
        nccl = _spawn(["--nccl-world-one", spec], workdir, "nccl", {
            "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(_free_port())})
        batches = multicard_batches(seed)
        two_halves = {}

        def ref_probe(trainer):
            """The gradient at the start, and the data=2 leg's arithmetic in
            this process: the mean of the gradients of the batch's two halves
            (each half's loss is its rows' share of the global loss, whose
            token and row counts split evenly here)."""
            grad = global_gradient(trainer, batches[0])
            halves = [global_gradient(trainer, {k: v[i:i + B // 2] for k, v in batches[0].items()})
                      for i in (0, B // 2)]
            two_halves.update({n: (halves[0][n] + halves[1][n]) / 2 for n in grad})
            fa.reset_launches()
            return grad

        fa.reset_launches()
        ref, tree = multicard_fit(seed, batches, None, (1, 1), "float32", MULTI_FP32_STEPS,
                                  os.path.join(workdir, "single_fp32"),
                                  probe=ref_probe)
        ref_launches = fa.launches
        ref_params, ref_grad = _trainable(ref), ref.probe
        if ref_launches != 15 * (MULTI_FP32_STEPS + 1):
            raise AssertionError(f"one-process fp32 fit launched K1 {ref_launches} times, "
                                 f"expected {15 * (MULTI_FP32_STEPS + 1)}")
        ref_losses = _train_scalars(ref.writer.scalars)
        del ref
        plain, _ = multicard_fit(seed, batches, tree, (1, 1), "float32", 1,
                                 os.path.join(workdir, "single_nccl_ref"), NCCL_OVERRIDES)
        plain_params = _trainable(plain)
        del plain
        torch.cuda.empty_cache()
        _wait([nccl], MULTI_RANK_LIMIT_S, "NCCL world-1 step")
        nccl_info = json.load(open(os.path.join(workdir, "nccl.json")))
        nccl_params = torch.load(os.path.join(workdir, "nccl_params.pt"), weights_only=True)
        differ = [n for n in plain_params if not torch.equal(plain_params[n], nccl_params[n])]
        if (nccl_info["backend"] != "nccl" or nccl_info["groups"] != ["nccl", "nccl"]
                or nccl_info["step_kind"] != "program" or differ
                or nccl_info["differ_from_eager"] or not nccl_info["losses_equal_eager"]
                or nccl_info["syncs_per_replayed_step"] != 0
                or nccl_info["collective_calls_per_replay"] != 0
                or nccl_info["collective_calls_in_fit"]
                != nccl_info["expected_collective_calls_in_fit"]):
            raise AssertionError(f"NCCL world-1 step: {nccl_info}; parameters that differ "
                                 f"from no process group: {differ[:5]}")
        out["nccl_world_one"] = dict(nccl_info, bit_equal_no_group=True,
                                     bit_equal_eager=True, params=len(plain_params))
        log(f"multicard NCCL world 1: {json.dumps(out['nccl_world_one'])}")

        timed = {}
        single, _ = multicard_fit(seed, batches, tree, (1, 1), "bfloat16", MULTI_STEPS,
                                  os.path.join(workdir, "single_bf16_1"))
        timed["single_ms_per_step"] = [_ms_per_step(single)]
        del single
        torch.cuda.empty_cache()
        expected = {"data2": {str([B // 2, 1500, 1500, 12, 64]): 12,
                              str([B // 2, T_VIDEO, T_VIDEO, 8, 64]): 3},
                    "model2": {str([B, 1500, 1500, 6, 64]): 12,
                               str([B, T_VIDEO, T_VIDEO, 4, 64]): 3}}
        for leg, mesh in MULTI_LEGS.items():
            legdir = os.path.join(workdir, leg)
            os.makedirs(legdir)
            leg_spec = os.path.join(legdir, "spec.json")
            with open(leg_spec, "w") as f:
                json.dump({"seed": seed, "workdir": legdir, "world": 2, "mesh": mesh,
                           "store": os.path.join(legdir, "store")}, f)
            t0 = time.perf_counter()
            _wait([_spawn(["--multicard-rank", leg_spec, str(r)], legdir, f"rank{r}")
                   for r in range(2)], MULTI_RANK_LIMIT_S, f"leg {leg}")
            ranks = [json.load(open(os.path.join(legdir, f"rank{r}.json"))) for r in range(2)]
            saved = torch.load(os.path.join(legdir, "fp32_params.pt"), weights_only=True)
            params = _compare(saved["params"], ref_params, TRAIN_PARAM_ATOL)
            grads = _compare(saved["grad"], ref_grad, 0.0)
            if leg == "data2":
                grads["vs_two_halves_in_one_process"] = _compare(
                    saved["grad"], two_halves, 0.0)
            losses = _train_scalars(ranks[0]["fp32"]["scalars"])
            loss_err = max(abs(losses[k] - v) for k, v in ref_losses.items())
            passes = MULTI_FP32_STEPS + 1  # the train micro-batches and the validation batch
            want = {shape: n * passes for shape, n in expected[leg].items()}
            for r in ranks:
                if r["fp32"]["k1_by_shape"] != want:
                    raise AssertionError(f"leg {leg} rank {r['rank']}: K1 launches by shape "
                                         f"{r['fp32']['k1_by_shape']}, expected {want}")
            kinds = [r["step_kind"] for r in ranks]
            if kinds != ["eager", "eager"]:
                raise AssertionError(f"leg {leg}: the gloo ranks ran the {kinds} steps")
            out[leg] = {
                "mesh": {"data": mesh[0], "model": mesh[1]},
                "step_kind_per_rank": kinds,
                "step_kind_why": "gloo groups: their collectives cannot be captured",
                "fp32_params_vs_one_process": params, "fp32_grad_vs_one_process": grads,
                "fp32_max_loss_diff": loss_err,
                "fp32_k1_by_shape_per_rank": [r["fp32"]["k1_by_shape"] for r in ranks],
                "fp32_k1_by_kernel_per_rank": [r["fp32"]["k1_by_kernel"] for r in ranks],
                "bf16_k1_by_kernel_per_rank": [r["bf16"]["k1_by_kernel"] for r in ranks],
                "bf16_ms_per_step_per_rank": [r["bf16"]["ms_per_step"] for r in ranks],
                "bf16_collective_ms_per_step_per_rank":
                    [r["bf16"]["collective_ms_per_step"] for r in ranks],
                "bf16_peak_mem_gib_per_rank": [r["bf16"]["peak_mem_gib"] for r in ranks],
                "leg_s": time.perf_counter() - t0}
            log(f"multicard leg {leg} ({NOT_SCALING}): " + json.dumps(out[leg]))
            if (not grads["max_abs_over_largest_value"] <= MULTI_GRAD_RTOL
                    or not params["max_abs"] <= MULTI_PARAM_ATOL
                    or not loss_err <= TRAIN_LOSS_ATOL
                    or grads.get("vs_two_halves_in_one_process", {}).get("max_abs", 0.0) != 0.0):
                raise AssertionError(
                    f"leg {leg}: fp32 against one process: gradient "
                    f"{grads['max_abs_over_largest_value']:.3e} of its largest value (rtol "
                    f"{MULTI_GRAD_RTOL:g}), parameters {params['max_abs']:.3e} (atol "
                    f"{MULTI_PARAM_ATOL:g}), losses {loss_err:.3e} (atol {TRAIN_LOSS_ATOL:g}), "
                    f"data=2 against its two halves in one process "
                    f"{grads.get('vs_two_halves_in_one_process')}")
        single, _ = multicard_fit(seed, batches, tree, (1, 1), "bfloat16", MULTI_STEPS,
                                  os.path.join(workdir, "single_bf16_2"))
        timed["single_ms_per_step"].append(_ms_per_step(single))
        del single
        out["single"] = timed
        out["single_fp32_k1_launches"] = ref_launches
        log(f"multicard one process bf16 ms per step, before and after the legs "
            f"({NOT_SCALING}): {timed['single_ms_per_step']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multicard phase: {out['phase_s']:.1f} s")
    return out


# -- phase 17: the model and data tools ----------------------------------------------------

# verify_model's batches (the JAX CLI's: B=2, 3000 mel, 16 frames of 64x64) and their K1
# launches: 12 encoder + 3 fusion a forward, 3 more in the backward's recompute of the
# checkpointed fusion (the config's ``precision.rematerialize``).
TOOLS_FORWARD_LAUNCHES, TOOLS_GRAD_LAUNCHES = 15, 18
# (B, frames) of the fusion's K1 calls in phase 17: verify_model's batches
# (16 frames at B=2; its shape sweep) and the export check's B=3 at 16 frames.
TOOLS_FUSION = ((2, 16), (1, 8), (2, 12), (4, 10), (3, 16))
VERIFY_K1_RTOL = 2e-2  # K1 against plain logits, bf16: TOL[bf16] of the logits' largest value
EXPORT_PLAIN_ATOL = 1e-3  # the artifact against the live net on the plain backend
EXPORT_K1_ATOL = 0.1  # the artifact against the live net with K1: the JAX CLI's bf16 atol
# The beam program's max_len, the CLI's default: 4 forced tokens and 60 searched steps. The
# prefix and the search are a while_loop each in the artifact (the JAX artifact's two
# scans), so its export and size do not grow with it.
TOOLS_BEAM_LEN = 64
TOOLS_BEAM_LOOPS = 2
# The beam export's decoder depth: the loop bodies are traced once each, and their
# trace grows with the layers (whisper-small's 12 took 48-74 s to export); width,
# vocab, the encode and the loops' structure stay whisper-small's.
TOOLS_BEAM_DECODER_LAYERS = 2


def launched(fn, expected: int, what: str):
    """Run ``fn`` with the K1 counts at 0 and hold the count to ``expected``."""
    fa.reset_launches()
    out, s = timed_call(fn)
    if fa.launches != expected:
        raise AssertionError(f"{what} launched K1 {fa.launches} times, expected {expected}")
    return out, s


def run_verify_model(net, seed: int) -> dict:
    """``tools/verify_model.py``'s three checks at full width on the card,
    each with its K1 launches counted; then the K1 logits against the plain
    backend's on one AV batch."""
    shapes = collections.Counter()
    with k1_shapes(shapes):
        stability, stab_s = launched(lambda: verify_model.test_model_stability(net),
                                     3 * TOOLS_FORWARD_LAUNCHES, "verify_model stability")
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated()  # what earlier phases left behind
        memory, mem_s = launched(lambda: verify_model.test_memory_usage(net),
                                 TOOLS_GRAD_LAUNCHES, "verify_model forward+backward")
        in_shapes, shapes_s = launched(lambda: verify_model.test_input_shapes(net),
                                       3 * TOOLS_FORWARD_LAUNCHES, "verify_model shapes")
    if not all(r["finite"] for r in stability.values()):
        raise AssertionError(f"verify_model: non-finite logits {stability}")
    if not memory["grads_finite"] or not 0 < memory["bytes_in_use"] <= memory["peak_bytes_in_use"]:
        raise AssertionError(f"verify_model memory report {memory}")
    want = {(b, ta, tv): (b, tv, VOCAB) for b, ta, tv in ((1, 500, 8), (2, 1000, 12), (4, 750, 10))}
    if in_shapes != want:
        raise AssertionError(f"verify_model shapes {in_shapes}, expected {want}")
    batch = verify_model._make_batch(np.random.default_rng(seed), 2, 2400, 16, device="cuda")
    with torch.no_grad():
        k1 = net(batch)
        with export_model.plain_attention(net):
            plain = net(batch)
    err, scale = (k1 - plain).abs().max().item(), plain.abs().max().item()
    out = {"stability": {m: {"shape": list(r["shape"]), "logit_range": list(r["logit_range"])}
                         for m, r in stability.items()},
           "memory": memory, "peak_gib": memory["peak_bytes_in_use"] / 2**30,
           "in_use_gib": memory["bytes_in_use"] / 2**30,
           "allocated_before_gib": allocated_before / 2**30,
           "step_in_use_gib": (memory["bytes_in_use"] - allocated_before) / 2**30,
           "k1_launches": {"stability": 3 * TOOLS_FORWARD_LAUNCHES,
                           "forward_backward": TOOLS_GRAD_LAUNCHES,
                           "shapes": 3 * TOOLS_FORWARD_LAUNCHES},
           "k1_by_shape": dict(shapes), "s": {"stability": stab_s, "memory": mem_s,
                                              "shapes": shapes_s},
           "k1_vs_plain_logits": {"max_abs_err": err, "logit_absmax": scale,
                                  "atol": VERIFY_K1_RTOL * scale}}
    log("verify_model: " + json.dumps(out))
    if not err <= VERIFY_K1_RTOL * scale:
        raise AssertionError(f"K1 logits differ from the plain backend's by {err} "
                             f"(largest logit {scale})")
    return out


def run_export(net, workdir: str) -> dict:
    """``tools/export_model.py``'s forward on the card: exported at B=2 and
    run at B=3, against the live net on the plain backend and with K1, in
    process and in a fresh child, and at B=1 against the plain backend.
    Export and reload timed."""
    out = {}
    fwd_path = os.path.join(workdir, "forward.pt2")
    _, out["forward_export_s"] = timed_call(lambda: export_model.export_forward(
        net, export_model._example_batch(2, device="cuda"), fwd_path))
    out["forward_bytes"] = os.path.getsize(fwd_path)
    b3 = export_model._example_batch(3, device="cuda")
    with torch.no_grad():
        with export_model.plain_attention(net):
            plain = net(b3)
        k1, _ = launched(lambda: net(b3), TOOLS_FORWARD_LAUNCHES, "the live B=3 forward")
    b1 = export_model._example_batch(1, device="cuda")  # below the example's B=2
    with torch.no_grad(), export_model.plain_attention(net):
        plain1 = net(b1)
    program, out["forward_reload_s"] = timed_call(lambda: torch.export.load(fwd_path).module())
    with torch.no_grad():
        got, out["forward_run_s"] = launched(lambda: program(b3), 0, "the forward artifact")
        out["forward_b1_vs_plain_max_abs_err"] = (program(b1) - plain1).abs().max().item()
    del program
    out["forward_vs_plain_max_abs_err"] = (got - plain).abs().max().item()
    out["forward_vs_k1_max_abs_err"] = (got - k1).abs().max().item()
    fresh, out["fresh_process_s"] = timed_call(lambda: export_model.verify_export_fresh_process(
        fwd_path, b3, reference_out=plain, atol=EXPORT_PLAIN_ATOL))
    log(f"export forward B=2 -> B=3: plain err {out['forward_vs_plain_max_abs_err']:.3e} "
        f"(atol {EXPORT_PLAIN_ATOL:g}), K1 err {out['forward_vs_k1_max_abs_err']:.3e} "
        f"(atol {EXPORT_K1_ATOL:g}), fresh process {fresh}")
    if not (out["forward_vs_plain_max_abs_err"] <= EXPORT_PLAIN_ATOL
            and out["forward_b1_vs_plain_max_abs_err"] <= EXPORT_PLAIN_ATOL
            and out["forward_vs_k1_max_abs_err"] <= EXPORT_K1_ATOL and fresh):
        raise AssertionError(f"the forward artifact fails its checks: {out}")
    os.remove(fwd_path)
    return out


def run_export_beam(dnet, workdir: str) -> dict:
    """``export_model.export_beam`` at the CLI's ``max_len`` on the card:
    the artifact's prefix and search are a ``while_loop`` each; its tokens
    against the same program run eagerly, and beside them the net's beam.
    Export, reload and run timed; the decoder at ``TOOLS_BEAM_DECODER_LAYERS``
    layers."""
    out = {"beam_decoder_layers": TOOLS_BEAM_DECODER_LAYERS}
    beam_path = os.path.join(workdir, "beam.pt2")
    bb = export_model._example_batch(1, device="cuda")
    bb = (bb[0].transpose(1, 2).contiguous(),) + bb[1:]  # mel as [B, 80, T]
    # The artifact is held against the same program run eagerly (the CLI's check); beside
    # it, the net's beam, which reads the keys 0 .. i where the loop reads the whole window
    # under the position mask, so bf16 may round the two apart.
    program = export_model.BeamProgram(dnet, PREFIX, BEAM, TOOLS_BEAM_LEN, EOS, 1.0)
    with export_model.plain_attention(dnet), torch.no_grad():
        (eager_seqs, eager_scores), out["beam_eager_s"] = launched(
            lambda: program(bb), 0, "the eager beam program")
        live = dnet.beam(bb, PREFIX, beam_size=BEAM, max_len=TOOLS_BEAM_LEN, eos_id=EOS)
    del program
    _, out["beam_export_s"] = timed_call(lambda: export_model.export_beam(
        dnet, bb, PREFIX, beam_path, beam_size=BEAM, max_len=TOOLS_BEAM_LEN, eos_id=EOS))
    out["beam_max_len"] = TOOLS_BEAM_LEN
    out["beam_bytes"] = os.path.getsize(beam_path)
    exported, out["beam_reload_s"] = timed_call(lambda: torch.export.load(beam_path))
    out["beam_loop_nodes"] = sum(
        1 for n in exported.graph.nodes
        if n.op == "call_function" and n.target is torch.ops.higher_order.while_loop)
    program = exported.module()
    with torch.no_grad():
        (seqs, scores), out["beam_run_s"] = launched(lambda: program(bb), 0,
                                                     "the beam artifact")
    del program, exported
    out["beam_tokens_equal"] = bool(torch.equal(seqs, eager_seqs))
    out["beam_score_max_abs_err"] = (scores - eager_scores).abs().max().item()
    out["beam_generated_lengths"] = (seqs[0, :, len(PREFIX):] != EOS).sum(-1).tolist()
    out["net_beam_tokens_equal"] = bool(torch.equal(seqs, live.sequences))
    out["net_beam_score_max_abs_err"] = (scores - live.scores).abs().max().item()
    log("export: " + json.dumps(out))
    if out["beam_loop_nodes"] != TOOLS_BEAM_LOOPS:
        raise AssertionError(f"the beam artifact holds {out['beam_loop_nodes']} while_loops, "
                             f"expected {TOOLS_BEAM_LOOPS}")
    if not out["beam_tokens_equal"]:
        raise AssertionError(f"beam artifact tokens {seqs} differ from the eager program's "
                             f"{eager_seqs}")
    return out


def run_data_tools(net, seed: int) -> dict:
    """``convert_checkpoint --kind moco``, ``smoke_test`` and
    ``max_frame_count`` on phase 13's dataset and MoCo checkpoint (written
    again from phase 13's seed)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_data")
    data = write_dataset(root, seed + 13)
    out = {}
    try:
        converted_path = os.path.join(root, "moco_converted.pt")
        rc, out["convert_s"] = timed_call(lambda: convert_checkpoint.main(
            ["--kind", "moco", "--input", data["moco"], "--output", converted_path]))
        converted = torch.load(converted_path, weights_only=True)
        net.load_moco(data["moco"])
        installed = net.visual_frontend.state_dict()
        diff = [k for k, v in converted["state_dict"].items()
                if not torch.equal(installed[k].cpu(), v)]
        out["convert"] = {"rc": rc, "tensors": len(converted["state_dict"]),
                          "report": converted["conversion_report"], "differ": diff}
        if rc != 0 or diff or converted["conversion_report"]["blocks_loaded"] != 16:
            raise AssertionError(f"convert_checkpoint --kind moco: {out['convert']}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc, out["smoke_test_s"] = timed_call(lambda: smoke_test.main(
                ["--set", f"data.root_dir={root}", "--num-batches", "2"]))
        lines = text.getvalue().splitlines()
        log("smoke_test: " + " | ".join(lines))
        n_batches = int(lines[0].removeprefix("train batches: ")) if lines else 0
        if rc != 0 or not n_batches or len(lines) != 1 + min(2, n_batches) or not all(
                "'video'" in ln for ln in lines[1:]):
            raise AssertionError(f"smoke_test printed {lines}")
        out["smoke_test"] = lines
        scan, out["max_frame_count_s"] = timed_call(lambda: max_frame_count.scan(root, workers=4))
        if scan != max_frame_count.scan(root, workers=1) or scan["n_videos"] != sum(
                DATA_CLIPS.values()) or not DATA_FRAMES[0] <= scan["max_frames"] <= DATA_FRAMES[1]:
            raise AssertionError(f"max_frame_count: {scan}")
        out["max_frame_count"] = scan
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("data tools: " + json.dumps({k: v for k, v in out.items() if k != "smoke_test"}))
    return out


def run_tools(seed: int) -> dict:
    """Phase 17: the model and data tools at full width (whisper-small +
    ResNet-50, BF16, the config's defaults through ``train.build_net``)."""
    t_phase = time.perf_counter()
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_tools")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        net = train_entry.build_net(get_config({"training.seed": seed}), VOCAB, device="cuda")
        with torch.no_grad():
            for layer in net.fusion.layers:
                layer.attn_gate.fill_(GATE)
                layer.ff_gate.fill_(GATE)
        out = {"verify_model": run_verify_model(net, seed)}
        out["export"] = run_export(net, workdir)
        out["export"].update(run_export_beam(
            build(seed, L.BF16, "cuda", decoder_layers=TOOLS_BEAM_DECODER_LAYERS), workdir))
        out["data_tools"] = run_data_tools(net, seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tools phase: {out['phase_s']:.1f} s")
    return out


def memory_gib() -> dict:
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated() / 2**30,
            "reserved": torch.cuda.memory_reserved() / 2**30}


def release_memory() -> None:
    """Free what a finished phase still holds on the card: what dynamo's
    caches keep of the programs it traced (phase 17's exports and eager
    beam program, weights included), its nets, graphs and pools caught in
    reference cycles (they wait for the collector), the cuBLAS workspace
    that each stream it ran a product on keeps (32 MiB each, for the life of
    the process unless cleared; no graph of a finished phase replays again)
    and the allocator's cached blocks."""
    torch._dynamo.reset()
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def _train_scalars(scalars) -> dict:
    return {f"{tag}@{step}": v for tag, v, step in scalars if tag.startswith("train/")}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # phase 16's child processes
    parser.add_argument("--multicard-rank", nargs=2, metavar=("SPEC", "RANK"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--nccl-world-one", metavar="SPEC", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1
    if args.multicard_rank:
        return multicard_rank(args.multicard_rank[0], int(args.multicard_rank[1]))
    if args.nccl_world_one:
        return nccl_world_one(args.nccl_world_one)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        for line in ptxas_report(lib.with_suffix(".log")):
            log(f"ptxas: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_end_s = {}  # seconds since the start of the run at the end of each phase
    phase_end_mem_gib = {}  # the card's memory each phase leaves, and after its release

    def done(name: str) -> None:
        phase_end_s[name] = time.perf_counter() - t0
        left = memory_gib()
        release_memory()
        phase_end_mem_gib[name] = dict(left, released=memory_gib())
        log(f"{name} done at {phase_end_s[name]:.1f} s; it left {left['allocated']:.3f} GiB "
            f"allocated, {left['reserved']:.3f} GiB reserved; released to "
            f"{phase_end_mem_gib[name]['released']['allocated']:.3f} GiB allocated")

    gen = torch.Generator().manual_seed(args.seed)
    rows = check_kernel(gen)
    routes = {f"{dt}/{d}": fa.route(dtype, d) for dt, dtype in
              (("bfloat16", torch.bfloat16), ("float32", torch.float32)) for d in fa.HEAD_DIMS}
    done("phase 2 (kernel)")
    e2e_fp32 = check_end_to_end(args.seed)
    main_path = run_main_path(args.seed)
    main_path["fp32_check"] = e2e_fp32
    done("phases 3-4 (main path)")
    k1_grad = check_kernel_gradient(gen)
    train_check = check_train_steps(args.seed)
    train_path = run_train_path(args.seed)
    train_path["fp32_card_vs_cpu"] = train_check
    done("phases 5-7 (training)")
    serve_path = {"av_engine": run_av_engine(args.seed),
                  "audio_server": run_audio_server(args.seed),
                  "teacher_forcing": run_teacher_forcing(args.seed)}
    done("phases 8-10 (serving)")
    serve_path.update(streaming=run_streaming(args.seed), continuous=run_continuous(args.seed))
    done("phases 11-12 (streaming, continuous)")
    data_path = run_data_path(args.seed, train_path["dropout_0.1"]["k1_launches_per_step"])
    done("phase 13 (data)")
    longform_path = run_longform(args.seed)
    done("phase 14 (long-form)")
    int8_path = run_int8(args.seed, train_path["dropout_0.1"]["train_ms_per_step"])
    done("phase 15 (int8)")
    multicard_path = run_multicard(args.seed)
    done("phase 16 (multicard)")
    tools_path = run_tools(args.seed)
    done("phase 17 (tools)")

    # Launches of each serving shape's kernel in one encoded batch, read from
    # the profiled encode by kernel instantiation.
    by_kernel = main_path["profile"]["encode"]["k1_launches_by_kernel"]
    if sum(by_kernel.values()) != 15:
        raise AssertionError(f"profiled encode ran K1 {by_kernel}, expected 15 launches")
    for name in ("encoder", "fusion"):
        row = rows[name]
        row["launches_per_batch"] = by_kernel.get(
            f"attention_fwd_wgmma<{row['shape'][4]}, {row['consumers']}, "
            f"{'true' if name == 'fusion' else 'false'}, false>", 0)
    enc = rows["encoder"]
    k1 = {"name": "flash_attention", "route": "cuda",
          "source": "mocov2_whisper_flamingo_torch/csrc/flash_attention.cu",
          "replaces": "mocov2_whisper_flamingo_tpu/ops/flash_attention.py:57",
          "launches": main_path["k1_launches_per_batch"], "launched": True,
          "launched_in_encode_graph": {k: main_path["encode_program"][k] for k in (
              "k1_launches_per_replay", "replay_ms", "eager_ms", "pool_bytes")},
          **{key: enc[key] for key in ("max_abs_err", "ms", "device_ms", "tflops",
                                       "bound_share", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "library_device_ms")},
          "route_by_head_dim": routes, **rows,
          "launches_per_audio_batch": serve_path["audio_server"]["k1_launches_per_batch"],
          "launches_per_av_batch": serve_path["av_engine"]["k1_launches_per_batch"],
          "launches_per_decoder_logits": serve_path["teacher_forcing"]["k1_launches"],
          "launches_per_stream_chunk": serve_path["streaming"]["k1_launches_per_chunk"],
          "launches_per_admission": serve_path["continuous"]["k1_launches_per_admission_by_bucket"],
          "launches_per_train_step": {name: train_path[name]["k1_launches_per_step"]
                                      for name in ("dropout_0.1", "dropout_0",
                                                   "dropout_0_remat")},
          "launches_per_data_train_step": {
              name: data_path[name]["k1_launches_per_step"] for name in DATA_MODES},
          "launches_per_quality_window": longform_path["k1_launches_per_quality_window"],
          "launches_per_alignment_forward": longform_path["alignment_forward"]["k1_launches"],
          "launches_per_int8_batch": int8_path["k1_launches_per_batch"],
          "launches_per_int8_alignment_forward":
              int8_path["audio"]["transcribe"]["k1_launches_by_mask"]["unmasked_causal"],
          "launches_per_int8_train_step": int8_path["train"]["int8"]["k1_launches_per_step"],
          "launches_per_multicard_fp32_fit_by_shape": {
              leg: multicard_path[leg]["fp32_k1_by_shape_per_rank"] for leg in MULTI_LEGS},
          "launches_per_verify_model_run": tools_path["verify_model"]["k1_launches"],
          "launches_per_verify_model_run_by_shape": tools_path["verify_model"]["k1_by_shape"],
          "backward": "recompute, torch ops", "fusion_forward_backward": k1_grad}
    ctc = train_path["ctc"]
    ctc_kernel = {
        "name": "ctc", "route": "cuda", "source": "mocov2_whisper_flamingo_torch/csrc/ctc.cu",
        "replaces": "mocov2_whisper_flamingo_tpu/ops/losses.py:79",
        "replaces_what": "no Pallas kernel: the JAX CTC's lax.scan (:79-91) and the reverse "
                         "scan autodiff makes of it, inside the jitted train step",
        "launches": sum(train_path["dropout_0"]["ctc_launches_in_fit"].values()),
        "launches_in_fit": train_path["dropout_0"]["ctc_launches_in_fit"],
        "launches_per_train_step": dict(CTC_PER_STEP),
        "launches_per_eval_step": train_path["eval_step_launches"]["ctc"],
        "max_abs_err": ctc["max_nll_diff"], "max_abs_grad_err": ctc["max_grad_diff"],
        **{key: ctc[key] for key in ("ms", "device_ms", "forward_device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "chain_steps", "library_ms",
                                     "library_device_ms", "bit_equal_runs", "infeasible_row")},
        "backward": "kernel (ctc_grad)"}
    print(json.dumps({"kernels": [k1, ctc_kernel], "main_path": main_path,
                      "train_path": train_path,
                      "serve_path": serve_path, "longform_path": longform_path,
                      "data_path": data_path, "int8_path": int8_path,
                      "multicard_path": multicard_path, "tools_path": tools_path,
                      "phase_end_s": phase_end_s, "phase_end_mem_gib": phase_end_mem_gib,
                      "card": smi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
