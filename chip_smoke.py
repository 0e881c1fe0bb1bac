#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels from ``mocov2_whisper_flamingo_torch/csrc``,
holds each against its plain PyTorch version on the card, checks the port
end to end against its own CPU run, then times the serving path: full
audio-visual beam-5 decoding (whisper-small + MoCo ResNet-50 + gated fusion,
BF16, B=4, 30 s mel, 400 uint8 88x88 lip frames, 160 tokens) with random
weights made from ``--seed``. Every phase raises on failure. The last two
lines of stdout are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
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
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, tq, tk, h, d, dtype, masked: bool) -> tuple[float, str]:
    """Least time for the call: q, k, v read once and o written once (plus
    the fp32 key bias), against 4*B*H*Tq*Tk*Dh operations at the dtype's
    peak. Returns (ms, 'bytes' | 'operations')."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * elt + (4 * b * tk if masked else 0)
    flops = 4 * b * h * tq * tk * d
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def qkv(gen, b, tq, tk, h, d, dtype, dev):
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
            ("causal_13x27", (2, 13, 27, 2, 64), dtype, None, True),
            ("causal_448", (2, 448, 448, 12, 64), dtype, None, True),
            ("masked_row", (4, 400, 400, 8, 64), dtype, (400, 317, 64, 0), False),
            ("dh32", (2, 70, 90, 3, 32), dtype, (90, 5), False),
            ("dh128_causal", (2, 100, 130, 2, 128), dtype, None, True),
        ]
    errs = {}
    for name, (b, tq, tk, h, d), dtype, lens, causal in cases:
        q, k, v = qkv(gen, b, tq, tk, h, d, dtype, dev)
        mask = None if lens is None else valid_mask(lens, tk, dev)
        out = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
        torch.cuda.synchronize()
        ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
        if out.dtype != dtype or out.shape != q.shape:
            raise AssertionError(f"{name}: got {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs().max().item()
        tag = f"{name}/{str(dtype).split('.')[-1]}"
        log(f"K1 {tag}: max_abs_err {err:.3e} (atol {TOL[dtype]:g})")
        if not err <= TOL[dtype]:
            raise AssertionError(f"K1 {tag} disagrees with its plain version: {err}")
        if name == "masked_row" and bool(out[3].any()):
            raise AssertionError("K1: a row with no valid key did not return exact zeros")
        errs[tag] = err

    rows = {}
    for name, (b, t, h, d), lens in (("encoder", (4, 1500, 12, 64), None),
                                     ("fusion", (4, 400, 8, 64), (400, 317, 64, 1))):
        q, k, v = qkv(gen, b, t, t, h, d, torch.bfloat16, dev)
        mask = None if lens is None else valid_mask(lens, t, dev)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_valid=mask), 50)
        plain_ms = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, kv_valid=mask), 10)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask), 50)
        bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, torch.bfloat16, mask is not None)
        rows[name] = {"shape": [b, t, h, d], "dtype": "bfloat16", "ms": kernel_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms, "max_abs_err": errs[f"{name}/bfloat16"]}
        log(f"K1 {name} [{b},{t},{h},{d}] bf16: kernel_ms {kernel_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
    return rows


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
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us: dict[str, float] = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:100]  # template-heavy names; kernels sharing a prefix add up
            kernels_us[name] = kernels_us.get(name, 0.0) + ev.device_time
            launches += 1
    busy = sum(kernels_us.values())
    ranked = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:top]
    # Device time by the PyTorch op that launched it.
    ops = sorted(((ev.key, ev.self_device_time_total) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CPU and ev.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "device_ops": launches,
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
    kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator().manual_seed(args.seed)
    rows = check_kernel(gen)
    check_end_to_end(args.seed)
    main_path = run_main_path(args.seed)

    enc = rows["encoder"]
    k1 = {"name": "flash_attention", "route": "cuda",
          "source": "mocov2_whisper_flamingo_torch/csrc/flash_attention.cu",
          "replaces": "mocov2_whisper_flamingo_tpu/ops/flash_attention.py:57",
          "launches": main_path["k1_launches_per_batch"], "launched": True,
          **{key: enc[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "shape", "dtype")},
          "fusion": rows["fusion"]}
    print(json.dumps({"kernels": [k1], "main_path": main_path, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
