// Streaming-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mocov2_whisper_flamingo_tpu/ops/flash_attention.py
// `_attention_kernel` (launched by `_flash_attention_fwd_impl`, pallas_call at :182).
// Same function, not the same blocking:
//   * q [B, Tq, H, Dh], k/v [B, Tk, H, Dh] read in place through their strides
//     (last dim contiguous) -- no head-folding copy;
//   * optional fp32 key bias [B, Tk] (0 valid / -1e30 masked), optional causal mask
//     `col <= row + (Tk - Tq)` with the offset from the unpadded lengths;
//   * fp32 running max / sum / accumulator; p is rounded to the input dtype before
//     the P.V product, as the TPU kernel does (`p.astype(v.dtype)`);
//   * a query row with no valid key returns 0 (TPU kernel :97-100, :111-114);
//   * output in q's dtype, contiguous [B, Tq, H, Dh].
//
// Both kernels below run one thread block per (b*h, 64-query tile). The TPU kernel
// carried its softmax state across a sequential K grid axis; here a loop inside the
// block walks K/V tiles staged in shared memory, with an online-softmax rescale per
// tile, and no state passes between blocks.
//
// bf16 (the serving path): `attention_fwd_mma`, 4 warps of 16 query rows each. Q stays
// in registers as mma A fragments; per 64-key tile, S = Q.K^T and O += P.V run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate), fragments loaded
// with ldmatrix from rows padded by 16 bytes (conflict-free). The softmax runs on the
// S accumulators in registers, and P is repacked from the accumulator layout straight
// into A fragments of the P.V product, so S and P never touch shared memory.
// fp32: `attention_fwd_f32`, scalar FMA, four threads per query row (interleaved
// quarters of the head dim), 32-key tiles. It serves fp32 reference runs.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), q, k, v read and o written
// once, 4*B*H*Tq*Tk*Dh operations:
//   encoder [4,1500,12,64] bf16: 36.9 MB -> 11.0 us; 27.6 GFLOP -> 27.9 us; bound 28 us
//   fusion  [4, 400, 8,64] bf16:  6.6 MB ->  2.0 us;  1.3 GFLOP ->  1.3 us; bound  2 us
// mma.sync reaches a fraction of the wgmma peak, and K/V loads are not overlapped with
// compute yet (no cp.async/TMA pipeline): both are the next steps towards the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// ----------------------------------------------------------------------------
// bf16: tensor cores via mma.sync
// ----------------------------------------------------------------------------

constexpr int MMA_BQ = 64;       // query rows per block (16 per warp)
constexpr int MMA_BK = 64;       // keys per shared-memory tile
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of a [rows, D] bf16 matrix with row stride `rs` into shared
// memory (row stride LD); rows past `nrows` are zero-filled so that masked keys
// multiply zeros, never stale data.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs, int r0,
                                          int nrows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ out, int H, int Tq, int Tk,
                  long long qsb, long long qst, long long qsh,
                  long long ksb, long long kst, long long ksh,
                  long long vsb, long long vst, long long vsh, float scale, int causal) {
  constexpr int LD = D + 8;   // +16 bytes per row: ldmatrix rows hit distinct banks
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NT = MMA_BK / 8;  // score n-tiles per key tile
  constexpr int OT = D / 8;       // output n-tiles
  __shared__ __align__(16) bf16 sk[MMA_BK * LD];
  __shared__ __align__(16) bf16 sv[MMA_BK * LD];
  __shared__ float sbias[MMA_BK];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * MMA_BQ;
  const int offset = Tk - Tq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  // Q tile -> shared (through the K buffer) -> A fragments in registers.
  load_tile<D, LD>(sk, q + b * qsb + h * qsh, qst, q0, Tq);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], &sk[(warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8]);

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the running sum

  int k_end = Tk;
  if (causal) {
    const int last_row = min(q0 + MMA_BQ - 1, Tq - 1);
    k_end = max(0, min(Tk, last_row + offset + 1));
  }
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  for (int k0 = 0; k0 < k_end; k0 += MMA_BK) {
    __syncthreads();  // the previous tile (or the Q staging) has been consumed
    load_tile<D, LD>(sk, kb, kst, k0, Tk);
    load_tile<D, LD>(sv, vb, vst, k0, Tk);
    if (threadIdx.x < MMA_BK) {
      const int key = k0 + threadIdx.x;
      sbias[threadIdx.x] = key < Tk ? (bias ? bias[(long long)b * Tk + key] : 0.f) : NEG_INF;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, &sk[(np * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8]);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Mask, scale into the log2 domain, row max over the quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = sbias[col] > NEG_INF && (!causal || k0 + col <= row + offset);
        s[nt][e] = ok ? (s[nt][e] * scale + sbias[col]) * LOG2E : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // keep exp2 arguments finite
      const float corr = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // P = exp2(S - m), summed in fp32, rounded to bf16 as A fragments of P.V.
    uint32_t pf[MMA_BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V.
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, &sv[(kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dp * 16 +
                              (lane / 16) * 8]);
        mma_bf16(o[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + r * 8;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);  // l == 0: no valid key, output 0
    bf16* op = out + (((long long)b * Tq + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// ----------------------------------------------------------------------------
// fp32: scalar FMA
// ----------------------------------------------------------------------------

constexpr int F32_BQ = 64;
constexpr int F32_BK = 32;
constexpr int TPR = 4;                     // threads per query row
constexpr int F32_THREADS = F32_BQ * TPR;  // 256

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, int H, int Tq, int Tk,
                  long long qsb, long long qst, long long qsh,
                  long long ksb, long long kst, long long ksh,
                  long long vsb, long long vst, long long vsh, float scale, int causal) {
  constexpr int DPT = D / TPR;
  __shared__ float ks[F32_BK][D];
  __shared__ float vs[F32_BK][D];
  __shared__ float bs[F32_BK];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int row = blockIdx.x * F32_BQ + tid / TPR;
  const int offset = Tk - Tq;

  // Rows past Tq load a real row and run with the block; their results are dropped.
  const float* qp = q + b * qsb + (long long)min(row, Tq - 1) * qst + h * qsh;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qp[i * TPR + sub];
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  int k_end = Tk;
  if (causal) {
    const int last_row = min(blockIdx.x * F32_BQ + F32_BQ - 1, Tq - 1);
    k_end = max(0, min(Tk, last_row + offset + 1));
  }
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  for (int k0 = 0; k0 < k_end; k0 += F32_BK) {
    __syncthreads();
    for (int idx = tid; idx < F32_BK * D; idx += F32_THREADS) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      ks[j][d] = key < Tk ? kb[key * kst + d] : 0.f;
      vs[j][d] = key < Tk ? vb[key * vst + d] : 0.f;
    }
    if (tid < F32_BK) {
      const int key = k0 + tid;
      bs[tid] = key < Tk ? (bias ? bias[(long long)b * Tk + key] : 0.f) : NEG_INF;
    }
    __syncthreads();

    float s[F32_BK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], ks[j][i * TPR + sub], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const bool ok = bs[j] > NEG_INF && (!causal || k0 + j <= row + offset);
      s[j] = ok ? part * scale + bs[j] : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new == -INFINITY) continue;  // no valid key for this row yet
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][i * TPR + sub], acc[i]);
    }
    m = m_new;
  }

  if (row < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = out + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * TPR + sub] = acc[i] * inv;
  }
}

// ----------------------------------------------------------------------------

template <int D>
void launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
            void* out, int B, int H, int Tq, int Tk, const long long* st, float scale,
            int causal, cudaStream_t stream) {
  if (dtype == 1) {
    dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, B * H);
    attention_fwd_mma<D><<<grid, MMA_THREADS, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        bias, static_cast<bf16*>(out), H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], scale, causal);
  } else {
    dim3 grid((Tq + F32_BQ - 1) / F32_BQ, B * H);
    attention_fwd_f32<D><<<grid, F32_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), H, Tq, Tk, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q/k/v 16-byte aligned, strides multiples of 8).
// Strides in elements: q b/t/h, k b/t/h, v b/t/h. Returns cudaGetLastError() after the
// launch, or -1 for an unsupported dtype or head dim.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int dtype, int B, int H,
                                   int Tq, int Tk, int D, long long qsb, long long qst,
                                   long long qsh, long long ksb, long long kst,
                                   long long ksh, long long vsb, long long vst,
                                   long long vsh, float scale, int causal, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32>(dtype, q, k, v, bias_f, out, B, H, Tq, Tk, st, scale, causal, s); break;
    case 64: launch<64>(dtype, q, k, v, bias_f, out, B, H, Tq, Tk, st, scale, causal, s); break;
    case 128: launch<128>(dtype, q, k, v, bias_f, out, B, H, Tq, Tk, st, scale, causal, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
