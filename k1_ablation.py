#!/usr/bin/env python3
"""What holds K1's Hopper kernel back: device time of source-patched variants.

    python3 k1_ablation.py [variant ...]

Each variant is ``csrc/flash_attention.cu`` with a few text patches (below),
built with the port's nvcc flags into ``build/k1_ablation/`` (all variants in
parallel) and timed at the two serving shapes with the device time per call
from ``torch.profiler`` (``chip_smoke.device_ms``), in turns (base first,
then each variant, then the same in reverse order), on one card. Variants
marked ``diagnostic`` compute a different function on purpose (they remove
work to show what it costs); their max |delta| against the plain version is
printed and not checked. Prints one JSON line with the card's name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops import kernels

# exp2 on the FMA pipe: round to the nearest integer j through the float's
# mantissa, 2^f for f in [-0.5, 0.5] by a cubic, j added to the exponent bits.
_EX2_FMA = """
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = fmaf(f, 0.0555041086648216f, 0.2402265069591007f);
  p = fmaf(p, f, 0.6931471805599453f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// One tile of the online softmax"""

_EXP_LINE = "s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -mu[e >> 1]));"

_NO_RELOAD = [(f"mbar_expect_tx({x}_full(s), L::KV_BYTES);",
                f"mbar_expect_tx({x}_full(s), i < STAGES ? L::KV_BYTES : 0);") for x in "kv"] + [
    (f"for (int a = 0; a < L::ATOMS; ++a)\n            tma_load(s{x}",
     f"for (int a = 0; a < (i < STAGES ? L::ATOMS : 0); ++a)\n            tma_load(s{x}")
    for x in "kv"]

VARIANTS = {
    "base": ([], False),
    # Consumer warpgroups issue their products whenever they are ready.
    "no_pingpong": ([("named_sync(1 + cw, TURN_THREADS);", ""),
                     ("named_arrive(next_turn, TURN_THREADS);", ";"),
                     ("if (cw == NWG - 1) named_arrive(1, TURN_THREADS);", "")], False),
    # The scores scaled before the row max (one FMUL and one FADD per score where the
    # kernel has one FFMA before each exp2).
    "scale_before_max": ([
        ("  if (edge) {", "#pragma unroll\n  for (int i = 0; i < 64; ++i) s[i] *= scale_log2;\n"
                          "  if (edge) {"),
        ("const float m_new = fmaxf(m[r], mx[r] * scale_log2);",
         "const float m_new = fmaxf(m[r], mx[r]);"),
        (_EXP_LINE, "s[4 * j + e] = ex2(s[4 * j + e] - mu[e >> 1]);")], False),
    # One serial max chain and one sum chain per row in the softmax.
    "one_chain": ([("constexpr int CHAINS = 2;", "constexpr int CHAINS = 1;")], False),
    # Four partial chains per row.
    "four_chains": ([("constexpr int CHAINS = 2;", "constexpr int CHAINS = 4;")], False),
    # A third K/V ring slot.
    "stages3": ([("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")], False),
    # A quarter of the exponentials on the FMA pipe instead of the SFU.
    "exp_quarter_on_fma": ([("\n// One tile of the online softmax", _EX2_FMA),
                            (_EXP_LINE, "{ const float x = fmaf(s[4 * j + e], scale_log2, "
                                        "-mu[e >> 1]); s[4 * j + e] = j % 4 == 3 ? "
                                        "ex2_fma(x) : ex2(x); }")], False),
    # Diagnostic: each ring slot is loaded once and then reused, so K and V are read
    # from L2 for the first two tiles only.
    "no_reload": (_NO_RELOAD, True),
    # Diagnostic: no exp2 at all (p = the scaled score).
    "no_exp": ([(_EXP_LINE, "s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, -mu[e >> 1]);")],
               True),
    # Diagnostic: no softmax at all (p = the raw score): the products and loads alone.
    "no_softmax": ([("  if (HAS_MASK) {  // the tile's key mask: 0 for a valid key",
                     "  return;\n  if (HAS_MASK) {  // the tile's key mask: 0 for a valid key")],
                   True),
}

# Diagnostic: no reloads and no softmax: the products alone.
VARIANTS["no_reload_no_softmax"] = (VARIANTS["no_reload"][0] + VARIANTS["no_softmax"][0], True)

SHAPES = {"encoder": ((4, 1500, 12, 64), None), "fusion": ((4, 400, 8, 64), (400, 317, 64, 1))}


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    out_dir = kernels.BUILD_DIR.parent / "k1_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"{name}: patch target not found: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        for line in cs.ptxas_report(lib.with_suffix(".log")):
            if "consumers=3, mask=0, causal=0" in line or "consumers=2, mask=1, causal=0" in line:
                print(name, line, flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names.insert(0, "base")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build(names)
    gen = torch.Generator().manual_seed(0)
    result = {"card": smi, "shapes": {}}
    for shape_name, ((b, t, h, d), lens) in SHAPES.items():
        q, k, v = cs.qkv(gen, b, t, t, h, d, torch.bfloat16, "cuda")
        mask = None if lens is None else cs.valid_mask(lens, t, "cuda")
        ref = fa.plain_flash_attention(q, k, v, kv_valid=mask)
        times = {n: [] for n in names}
        errs = {}
        for name in names + names[::-1]:
            kernels._libs["flash_attention"] = libs[name]
            out = fa.flash_attention(q, k, v, kv_valid=mask)
            torch.cuda.synchronize()
            errs[name] = (out.float() - ref.float()).abs().max().item()
            times[name].append(cs.device_ms(lambda: fa.flash_attention(q, k, v, kv_valid=mask))[0])
        flops = cs.attention_flops(b, t, t, h, d)
        rows = {n: {"device_ms": times[n], "tflops": [flops / ms / 1e9 for ms in times[n]],
                    "max_abs_err": errs[n], "diagnostic": VARIANTS[n][1]} for n in names}
        for n, row in rows.items():
            if not row["diagnostic"] and not row["max_abs_err"] <= cs.TOL[torch.bfloat16]:
                raise AssertionError(f"{shape_name} {n}: max_abs_err {row['max_abs_err']}")
            print(f"{shape_name} {n}: device_ms {[round(x, 5) for x in row['device_ms']]} "
                  f"TFLOP/s {[round(x, 1) for x in row['tflops']]} "
                  f"max_abs_err {row['max_abs_err']:.3e}" + (" (diagnostic)" if row["diagnostic"]
                                                             else ""), flush=True)
        result["shapes"][shape_name] = rows
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
