#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels from ``mocov2_whisper_flamingo_torch/csrc``,
holds each against its plain PyTorch version on the card and times it at the
serving shapes (device time per call from ``torch.profiler``, beside the wall
time per call), checks the port end to end against its own CPU run, then
times the serving path: full audio-visual beam-5 decoding (whisper-small +
MoCo ResNet-50 + gated fusion, BF16, B=4, 30 s mel, 400 uint8 88x88 lip
frames, 160 tokens) with random weights made from ``--seed``. Every phase
raises on failure. The last two lines of stdout are the ``kernels`` JSON line
and ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_jax_params
from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops import kernels
from mocov2_whisper_flamingo_torch.ops.video import eval_video_pipeline

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


def traced(fn, tries: int = 3):
    """``(profiler, wall seconds)`` of one run of ``fn`` under
    ``torch.profiler``, synchronised. Now and then the profiler hands back
    a window with no device events at all; such a run is made again, up to
    ``tries`` times, and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        if any(ev.device_type == DeviceType.CUDA and ev.device_time > 0
               for ev in prof.events()):
            return prof, wall_s
    raise AssertionError(f"torch.profiler recorded no device time in {tries} runs")


def device_ms(fn, iters: int = 20) -> tuple[float, float]:
    """Device time per call of ``fn`` and kernels per call: the summed
    duration of the kernels that ``iters`` calls launched, as
    ``torch.profiler`` records them on the card, over ``iters``. Host time
    between the kernels does not count."""
    from torch.autograd import DeviceType

    fn()
    prof, _ = traced(lambda: [fn() for _ in range(iters)])
    kernels_us = [ev.device_time for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    return sum(kernels_us) / iters / 1e3, len(kernels_us) / iters


def attention_flops(b, tq, tk, h, d) -> int:
    return 4 * b * h * tq * tk * d


def attention_bound_ms(b, tq, tk, h, d, dtype, masked: bool) -> tuple[float, str]:
    """Least time for the call: q, k, v read once and o written once (plus
    the [B, Tk] mask bytes), against 4*B*H*Tq*Tk*Dh operations at the
    dtype's peak. Returns (ms, 'bytes' | 'operations')."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * elt + (b * tk if masked else 0)
    flops = attention_flops(b, tq, tk, h, d)
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


# -- phase 2 -------------------------------------------------------------------


def check_kernel(gen) -> dict:
    dev = torch.device("cuda")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [
            ("encoder", (4, 1500, 1500, 12, 64), dtype, None, False),
            ("fusion", (4, 400, 400, 8, 64), dtype, (400, 317, 64, 1), False),
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
    for name, (b, t, h, d), lens in (("encoder", (4, 1500, 12, 64), None),
                                     ("fusion", (4, 400, 8, 64), (400, 317, 64, 1))):
        q, k, v = qkv(gen, b, t, t, h, d, torch.bfloat16, dev)
        mask = None if lens is None else valid_mask(lens, t, dev)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        kernel = lambda: fa.flash_attention(q, k, v, kv_valid=mask)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)
        wall_ms = cuda_ms(kernel, 50)
        dev_ms, per_call = device_ms(kernel)
        if per_call != 1:
            raise AssertionError(f"K1 {name}: {per_call} device kernels per call, expected 1")
        # The Hopper kernel with each block size it can take, beside the one chosen.
        mask_bytes = fa._mask_bytes(mask, b, t, dev)
        by_consumers = {n: device_ms(lambda: fa._launch(q, k, v, mask_bytes, d ** -0.5, False,
                                                        consumers=n))[0] for n in (2, 3)}
        plain_ms = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, kv_valid=mask), 10)
        library_ms = cuda_ms(library, 50)
        library_dev_ms, library_kernels = device_ms(library)
        bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, torch.bfloat16, mask is not None)
        tflops = attention_flops(b, t, t, h, d) / (dev_ms * 1e-3) / 1e12
        consumers = fa.consumer_groups(d, t, b * h, torch.cuda.get_device_properties(dev)
                                       .multi_processor_count)
        rows[name] = {"shape": [b, t, h, d], "dtype": "bfloat16",
                      "kernel": fa.route(torch.bfloat16, d), "consumers": consumers,
                      "device_ms_by_consumers": by_consumers, "ms": wall_ms,
                      "device_ms": dev_ms, "tflops": tflops,
                      "bound_share": bound_ms / dev_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                      "library_device_ms": library_dev_ms,
                      "library_kernels_per_call": library_kernels,
                      "max_abs_err": errs[f"{name}/bfloat16"]}
        log(f"K1 {name} [{b},{t},{h},{d}] bf16 ({rows[name]['kernel']}, {consumers} consumer "
            f"warpgroups): device_ms {dev_ms:.4f} ({tflops:.1f} TFLOP/s, "
            f"{100 * bound_ms / dev_ms:.1f} % of the bound {bound_ms * 1e3:.2f} us by "
            f"{bound_by}) wall_ms/call {wall_ms:.4f}; device_ms by consumer warpgroups "
            f"{by_consumers}; library device_ms {library_dev_ms:.4f} wall_ms/call "
            f"{library_ms:.4f}; plain_ms {plain_ms:.4f}")
    return rows


def ptxas_report(log_path) -> list[str]:
    """Registers, spills and warnings that ptxas printed for each
    instantiation of the Hopper kernel (``-Xptxas -v`` in the build log)."""
    lines, current = [], None
    for line in open(log_path).read().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            args = re.search(r"attention_fwd_wgmmaILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", name)
            current = (f"attention_fwd_wgmma<Dh={args[1]}, consumers={args[2]}, "
                       f"mask={args[3]}, causal={args[4]}>" if args else None)
        elif current and ("spill" in line or "Used" in line):
            lines.append(f"{current}: {line.strip()}")
        elif "warning" in line.lower() or "C75" in line:
            lines.append(line.strip())
    return lines


# -- phases 3 and 4 -----------------------------------------------------------------


def build(seed: int, precision, device) -> AVWhisperNet:
    net = AVWhisperNet(modelargs=MODELARGS, vocab_size=VOCAB, whisper_name="whisper-small",
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


def check_end_to_end(seed: int) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    mel, raw = make_batch(rng, 1, 32, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        net = build(seed, L.FP32, dev)
        batch = preprocess(mel.to(dev), raw.to(dev))
        feats, _ = net.encode(batch)
        fa.reset_launches()
        res = net.beam(batch, PREFIX, beam_size=BEAM, max_len=48, eos_id=EOS)
        if dev == "cuda":
            torch.cuda.synchronize()
            if fa.launches != 15:
                raise AssertionError(f"fp32 card run launched K1 {fa.launches} times, "
                                     "expected 15 (12 encoder + 3 fusion)")
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
        f"{(sc_gpu - sc_cpu).abs().max().item():.3e}")
    if not err <= FEATURE_ATOL:
        raise AssertionError(f"fp32 encoder features card vs CPU differ by {err}")
    if not same:
        raise AssertionError(f"fp32 beam tokens differ card vs CPU:\n{s_gpu}\n{s_cpu}")


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

    decode(batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

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
    out["profile"] = {"encode": profile(lambda: encode(batches[0])),
                      "decode_16_steps": profile(lambda: net.beam(
                          preprocess(*batches[0]), PREFIX, beam_size=BEAM, max_len=20,
                          eos_id=EOS))}
    return out


def profile(fn, top: int = 6) -> dict:
    """Device busy share and the kernels that take the most device time over
    one call of ``fn``, from ``torch.profiler``. The profiler's own host
    overhead lengthens the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType

    prof, wall_s = traced(fn)
    wall_us = wall_s * 1e6
    kernels_us: dict[str, float] = {}
    k1: dict[str, int] = {}  # K1 launches by kernel instantiation
    launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:100]  # template-heavy names; kernels sharing a prefix add up
            kernels_us[name] = kernels_us.get(name, 0.0) + ev.device_time
            launches += 1
            found = re.search(r"attention_fwd\w*(<[^>]*>)?", ev.name)
            if found:
                k1[found[0]] = k1.get(found[0], 0) + 1
    busy = sum(kernels_us.values())
    ranked = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:top]
    # Device time by the PyTorch op that launched it.
    ops = sorted(((ev.key, ev.self_device_time_total) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CPU and ev.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "device_ops": launches,
           "k1_launches_by_kernel": k1,
           "top_kernels_ms": {name: us / 1e3 for name, us in ranked},
           "top_torch_ops_ms": {name: us / 1e3 for name, us in ops}}
    log("profile: " + json.dumps(out))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(libs["flash_attention"].with_suffix(".log")):
        log(f"ptxas: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator().manual_seed(args.seed)
    rows = check_kernel(gen)
    routes = {f"{dt}/{d}": fa.route(dtype, d) for dt, dtype in
              (("bfloat16", torch.bfloat16), ("float32", torch.float32)) for d in fa.HEAD_DIMS}
    check_end_to_end(args.seed)
    main_path = run_main_path(args.seed)

    # Launches of each serving shape's kernel in one encoded batch, read from
    # the profiled encode by kernel instantiation.
    by_kernel = main_path["profile"]["encode"]["k1_launches_by_kernel"]
    if sum(by_kernel.values()) != 15:
        raise AssertionError(f"profiled encode ran K1 {by_kernel}, expected 15 launches")
    for name, row in rows.items():
        row["launches_per_batch"] = by_kernel.get(
            f"attention_fwd_wgmma<{row['shape'][3]}, {row['consumers']}, "
            f"{'true' if name == 'fusion' else 'false'}, false>", 0)
    enc = rows["encoder"]
    k1 = {"name": "flash_attention", "route": "cuda",
          "source": "mocov2_whisper_flamingo_torch/csrc/flash_attention.cu",
          "replaces": "mocov2_whisper_flamingo_tpu/ops/flash_attention.py:57",
          "launches": main_path["k1_launches_per_batch"], "launched": True,
          **{key: enc[key] for key in ("max_abs_err", "ms", "device_ms", "tflops",
                                       "bound_share", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "library_device_ms")},
          "route_by_head_dim": routes, "encoder": enc, "fusion": rows["fusion"]}
    print(json.dumps({"kernels": [k1], "main_path": main_path, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
