// Streaming-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mocov2_whisper_flamingo_tpu/ops/flash_attention.py
// `_attention_kernel` (:57, launched by `_flash_attention_fwd_impl`, pallas_call at :182).
// Same function, not the same blocking:
//   * q [B, Tq, H, Dh], k/v [B, Tk, H, Dh] read in place through their strides
//     (last dim contiguous) -- no head-folding copy;
//   * optional [B, Tk] bool key mask (1 = valid), read by the kernel as bytes; optional
//     causal mask `col <= row + (Tk - Tq)` with the offset from the unpadded lengths;
//   * fp32 running max / sum / accumulator; p is rounded to the input dtype before
//     the P.V product, as the TPU kernel does (`p.astype(v.dtype)`);
//   * a query row with no valid key returns 0 (TPU kernel :97-100, :111-114);
//   * output in q's dtype, contiguous [B, Tq, H, Dh].
// The TPU kernel carried its softmax state across a sequential K grid axis; here a loop
// inside each block walks the K/V tiles with an online-softmax rescale per tile, and no
// state passes between blocks. Three kernels, chosen by the wrapper per dtype and head
// dim (`ops/flash_attention.py::route`):
//
// bf16, Dh 64 and 128 (the serving path): `attention_fwd_wgmma`, in the shape of
// FlashAttention-3. One block per (b*h, 64*NWG query rows): warpgroup 0 is the producer,
// warpgroups 1..NWG are consumers of 64 query rows each. NWG is 2 or 3 at Dh 64 (3 does
// not fit its registers at Dh 128); the wrapper picks it per shape
// (`ops/flash_attention.py::consumer_groups`): the count whose grid leaves each SM the
// fewest query rows to walk, counting the last, partial wave of blocks as a full one.
//   * Loads: one producer thread issues TMA copies through 4-D tensor maps over the
//     strided [B, T, H, Dh] tensors (dims Dh, H, T, B; 128-byte swizzle; rows past T come
//     back as zeros). Q is loaded once; K and V tiles of 128 keys go through a ring of
//     STAGES slots in shared memory with full/empty mbarriers, so loads run ahead of the
//     matrix products instead of between them.
//   * S = Q.K^T: wgmma m64n128k16, both operands in shared memory (K-major).
//   * Softmax on the S accumulators in registers, log2 domain, ex2.approx. P is converted
//     to bf16 in registers and is the register A operand of O += P.V (wgmma m64n{Dh}k16,
//     V MN-major through the descriptor's transpose bit): S and P never touch shared memory.
//   * Overlap: inside a warpgroup, the S product of tile j+1 and the P.V product of tile j
//     are in flight while tile j+1's softmax runs (O is rescaled one tile late); across
//     warpgroups, named barriers hand the tensor cores round-robin from one warpgroup to
//     the next, so one warpgroup's softmax runs under another's products.
//   * Registers: setmaxnreg moves them from the producer (24) to the consumers.
//   * Masks are template parameters: the unmasked call runs no per-element test except on
//     the last, partial key tile; with a key mask the producer warp turns the tile's mask
//     bytes into a 0 / -inf row in shared memory; causal blocks stop at the diagonal and
//     test elements only on tiles that cross it.
// bf16, Dh 32: `attention_fwd_mma`, 4 warps of 16 query rows, mma.sync m16n8k16 with
// ldmatrix fragments, synchronous 64-key tiles. (wgmma needs k16 steps over a 64-column
// swizzle atom; at Dh 32 the kernel would be half empty.)
// fp32: `attention_fwd_f32`, scalar FMA, four threads per query row, 32-key tiles. It
// serves the fp32 reference runs.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), q, k, v read and o written
// once, 4*B*H*Tq*Tk*Dh operations:
//   encoder [4,1500,12,64] bf16: 36.9 MB -> 11.0 us; 27.6 GFLOP -> 27.9 us; bound 28 us
//   fusion  [4, 400, 8,64] bf16:  6.6 MB ->  2.0 us;  1.3 GFLOP ->  1.3 us; bound  2 us
// A second bound at Dh 64 is the exponent unit: one exp2 per score, B*H*Tq*Tk = 1.08e8 for
// the encoder call, at 16 per clock per SM (132 SMs, 1.98 GHz) ~26 us -- as long as the
// products. The two only reach the larger of them, not their sum, when softmax runs
// while the tensor cores work: that overlap is what the warp specialisation is for.
// A third, at Dh 64: every block reads all of K and V from L2, 2*Dh*2 bytes per key
// for 4*BQ*Dh operations, so the tensor cores' rate needs BQ operations per L2 byte
// (7.7 TB/s at BQ 128, 5.2 TB/s at BQ 192). BQ 192 also cuts the encoder's grid from
// 576 blocks (4.4 waves on 132 SMs, run in 5) to 384 (2.9 waves, run in 3).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Routes, as ops/flash_attention.py::ROUTES numbers them.
constexpr int ROUTE_FMA_F32 = 0;
constexpr int ROUTE_MMA_SYNC = 1;
constexpr int ROUTE_WGMMA_TMA = 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------------------------------
// bf16, Dh 64 / 128: TMA ring + warp-specialised wgmma
// ----------------------------------------------------------------------------

namespace hopper {

constexpr int BK = 128;      // keys per K/V tile
constexpr int STAGES = 2;    // K/V ring slots (a third measured no faster)
constexpr int ATOM = 128;    // bytes in one row of a 64-column swizzle atom
constexpr int CHAINS = 2;    // independent partial max / sum chains per row in the softmax
constexpr int PRODUCER_REGS = 24;

template <int D, int NWG>
struct Layout {
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;  // 24 * 128 + this * 128 * NWG <= 64K
  static constexpr int ATOMS = D / 64;                         // swizzle atoms per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // Offsets from a 1024-byte aligned base (the 128-byte swizzle repeats every 1024 bytes,
  // and TMA and wgmma both apply it to address bits).
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int MASK = V + STAGES * KV_BYTES;  // per slot: 0 / -inf for each key
  static constexpr int BAR = MASK + STAGES * BK * 4;
  static constexpr int NBAR = 1 + 4 * STAGES;  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr int BYTES = BAR + NBAR * 8 + 1024;  // + slack for aligning the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The spin loop stays inside the asm: a C++ loop on a per-thread flag would look
// divergent to ptxas, which then serialises every wgmma after it (C7518).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One consumer warp is done with a ring slot: one arrival per warp, by lane 0 through a
// predicate inside the asm (no branch while a wgmma is in flight).
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred first;\n"
      "setp.eq.u32 first, %1, 0;\n"
      "@first mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// Box {64, 1, rows, 1} at (d, h, t, b) of a [B, T, H, Dh] tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading and stride
// byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of wgmma accumulators across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A[64x16] (shared, K-major) * B[16x128] (shared, K-major); d is m64n128 fp32.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A[64x16] (registers) * B[16x64] (shared, MN-major); d is m64n64 fp32.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A[64x16] (registers) * B[16x128] (shared, MN-major); d is m64n128 fp32.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S[64 x 128] = Q[64 x D] . K_tile[128 x D]^T; both K-major in swizzle atoms of 64 columns.
template <int D, int BQ>
__device__ __forceinline__ void gemm_qk(float (&s)[64], uint32_t q, uint32_t k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t dq = q + (kk / 4) * (BQ * ATOM) + (kk % 4) * 32;
    const uint32_t dk = k + (kk / 4) * (BK * ATOM) + (kk % 4) * 32;
    wgmma_ss_n128(s, gmma_desc(dq, 16, 8 * ATOM), gmma_desc(dk, 16, 8 * ATOM), kk > 0);
  }
  wgmma_commit();
}

// O[64 x D] += P[64 x 128] (bf16 registers) . V_tile[128 x D] (MN-major).
template <int D>
__device__ __forceinline__ void gemm_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4],
                                        uint32_t v) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = gmma_desc(v + kk * 16 * ATOM, BK * ATOM, 8 * ATOM);
    if constexpr (D == 64) {
      wgmma_rs_n64(o, p[kk], dv);
    } else {
      wgmma_rs_n128(o, p[kk], dv);
    }
  }
  wgmma_commit();
}

// One tile of the online softmax on the S accumulators (m64n128 layout: s[4j + e] is
// row `row0 + 8 * (e >> 1)`, column `8j + col0 + (e & 1)` of the tile). The running max
// m is kept in the log2 domain; the tile's max is taken on the raw scores (scale > 0) and
// the scale rides in the one FFMA before each exp2, so a score costs a max, an FFMA, an
// exp2 and an add. Updates m and this thread's part of the running sum l, leaves
// p = exp2(s * scale_log2 - m) in s, and returns the factor that rescales O in corr.
template <bool HAS_MASK, bool CAUSAL>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], const float* tile_mask,
                                               bool edge, int k0, int Tk, int row0, int col0,
                                               int offset, float scale_log2) {
  if (HAS_MASK) {  // the tile's key mask: 0 for a valid key, -inf for a masked one
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(tile_mask + 8 * j + col0);
      s[4 * j + 0] += bias.x;
      s[4 * j + 1] += bias.y;
      s[4 * j + 2] += bias.x;
      s[4 * j + 3] += bias.y;
    }
  }
  if (edge) {  // the partial last key tile (unmasked call) or a tile crossing the diagonal
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + col0 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if ((!HAS_MASK && col >= Tk) || (CAUSAL && col > row + offset)) s[4 * j + e] = -INFINITY;
      }
    }
  }
  // Row max and sum over the thread's 32 scores of each row in CHAINS chains, not one:
  // a single chain of 32 dependent instructions waits on its own latency.
  float part[2][CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) part[0][c] = part[1][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    part[0][j % CHAINS] = fmaxf(part[0][j % CHAINS], fmaxf(s[4 * j + 0], s[4 * j + 1]));
    part[1][j % CHAINS] = fmaxf(part[1][j % CHAINS], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx[2], mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = part[r][0];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) mx[r] = fmaxf(mx[r], part[r][c]);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // keep exp2 arguments finite
    corr[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) part[0][c] = part[1][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -mu[e >> 1]));
      part[e >> 1][j % CHAINS] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) l[r] += part[r][c];
  }
}

// O takes the rescale of the running max (rows row0 and row0 + 8).
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// P (fp32, S accumulator layout) -> bf16 A fragments of P.V, one per 16 keys: the
// accumulator pairs of two neighbouring 8-column groups are the A registers of a k16 step.
__device__ __forceinline__ void to_a_frags(const float (&s)[64], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, int NWG, bool HAS_MASK, bool CAUSAL>
__global__ void __launch_bounds__(Layout<D, NWG>::THREADS, 1)
attention_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ out, int H, int Tq, int Tk, float scale_log2) {
  using L = Layout<D, NWG>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* smask = reinterpret_cast<float*>(smem_raw + (base - raw) + L::MASK);
  const uint32_t sq = base + L::Q, sk = base + L::K, sv = base + L::V, bar = base + L::BAR;
  const uint32_t q_full = bar;
  auto k_full = [bar](int s) { return bar + 8u * (1 + s); };
  auto v_full = [bar](int s) { return bar + 8u * (1 + STAGES + s); };
  auto k_empty = [bar](int s) { return bar + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [bar](int s) { return bar + 8u * (1 + 3 * STAGES + s); };

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int offset = Tk - Tq;
  const int k_end = CAUSAL ? max(0, min(Tk, min(q0 + BQ, Tq) + offset)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NWG);  // one arrival per consumer warp
      mbar_init(v_empty(s), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so that the compiler sees it uniform.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    // ---- producer warpgroup: warp 0 issues every load; the other three retire ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0 && n_tiles > 0) {
        mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int a = 0; a < L::ATOMS; ++a)
          tma_load(sq + a * BQ * ATOM, &tm_q, q_full, 64 * a, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;  // the first pass finds empty slots
        const int k0 = i * BK;
        mbar_wait(k_empty(s), parity);
        if (HAS_MASK) {  // the tile's key mask, as 0 / -inf, travels with its K slot
          for (int j = lane; j < BK; j += 32) {
            const int key = k0 + j;
            smask[s * BK + j] = key < Tk && mask[(long long)b * Tk + key] ? 0.f : -INFINITY;
          }
          __syncwarp();
        }
        if (lane == 0) {
          mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
          for (int a = 0; a < L::ATOMS; ++a)
            tma_load(sk + s * L::KV_BYTES + a * BK * ATOM, &tm_k, k_full(s), 64 * a, h, k0, b);
        }
        mbar_wait(v_empty(s), parity);
        if (lane == 0) {
          mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
          for (int a = 0; a < L::ATOMS; ++a)
            tma_load(sv + s * L::KV_BYTES + a * BK * ATOM, &tm_v, v_full(s), 64 * a, h, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int first_row = q0 + 64 * cw;
    const int row0 = first_row + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);  // its first column in every 8-column group
    // Tensor-core turns pass round-robin: consumer cw waits on barrier 1 + cw, then
    // hands over to the next one.
    const int next_turn = 1 + (cw + 1) % NWG;
    constexpr int TURN_THREADS = 256;  // 128 waiting + 128 arriving

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
    float l[2] = {0.f, 0.f};              // this thread's part of the running sum
    float corr[2] = {1.f, 1.f};

    // The first tile is peeled off the loop so that no branch joins around a wgmma in
    // flight: a join would copy accumulator registers, and ptxas then serialises the
    // products (C7514/C7517).
    if (n_tiles > 0) {
      if (cw == NWG - 1) named_arrive(1, TURN_THREADS);  // the first turn is consumer 0's
      uint32_t p[BK / 16][4];
      float s[64];
      const uint32_t q_rows = sq + 64 * cw * ATOM;
      mbar_wait(q_full, 0);
      mbar_wait(k_full(0), 0);
      named_sync(1 + cw, TURN_THREADS);
      gemm_qk<D, BQ>(s, q_rows, sk);
      if (cw != NWG - 1 || n_tiles > 1) named_arrive(next_turn, TURN_THREADS);
      wgmma_wait<0>();
      fence_regs(s);
      if (!HAS_MASK) release(k_empty(0), lane);
      online_softmax<HAS_MASK, CAUSAL>(s, m, l, corr, smask,
                                       (!HAS_MASK && BK > Tk) || (CAUSAL && BK - 1 > first_row + offset),
                                       0, Tk, row0, col0, offset, scale_log2);
      if (HAS_MASK) release(k_empty(0), lane);
      to_a_frags(s, p);
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % STAGES, ps = (i - 1) % STAGES;
        const int k0 = i * BK;
        mbar_wait(k_full(st), (i / STAGES) & 1);
        named_sync(1 + cw, TURN_THREADS);
        gemm_qk<D, BQ>(s, q_rows, sk + st * L::KV_BYTES);
        // P.V of the previous tile, after O takes that tile's rescale; it runs on
        // while this tile's softmax does.
        rescale<D>(o, corr);
        mbar_wait(v_full(ps), ((i - 1) / STAGES) & 1);
        gemm_pv<D>(o, p, sv + ps * L::KV_BYTES);
        if (cw != NWG - 1 || i + 1 < n_tiles) named_arrive(next_turn, TURN_THREADS);
        wgmma_wait<1>();
        fence_regs(s);
        if (!HAS_MASK) release(k_empty(st), lane);
        online_softmax<HAS_MASK, CAUSAL>(
            s, m, l, corr, smask + st * BK,
            (!HAS_MASK && k0 + BK > Tk) || (CAUSAL && k0 + BK - 1 > first_row + offset), k0, Tk,
            row0, col0, offset, scale_log2);
        if (HAS_MASK) release(k_empty(st), lane);
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty(ps), lane);
        to_a_frags(s, p);
      }
      // P.V of the last tile.
      const int ls = (n_tiles - 1) % STAGES;
      rescale<D>(o, corr);
      mbar_wait(v_full(ls), ((n_tiles - 1) / STAGES) & 1);
      gemm_pv<D>(o, p, sv + ls * L::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= Tq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);  // l == 0: no valid key, output 0
      bf16* op = out + (((long long)b * Tq + row) * H + h) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched once through the runtime, so
// the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [B, T, H, Dh] bf16 tensor through its element strides, as TMA dims (Dh, H, T, B),
// copied in boxes of 64 x 1 x rows x 1 with the 128-byte swizzle.
bool encode_bthd(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                 long long sb, long long st, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG, bool HAS_MASK, bool CAUSAL>
int launch_wgmma_t(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                   const uint8_t* mask, bf16* out, int B, int H, int Tq, int Tk, float scale,
                   cudaStream_t stream) {
  using L = Layout<D, NWG>;
  const auto kernel = attention_fwd_wgmma<D, NWG, HAS_MASK, CAUSAL>;
  static bool configured[64] = {};  // per device: the dynamic shared memory limit is raised once
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= 64 || !configured[dev]) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (rc != cudaSuccess) return rc;
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid((Tq + L::BQ - 1) / L::BQ, B * H);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(mq, mk, mv, mask, out, H, Tq, Tk, scale * LOG2E);
  return 0;
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                 int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
                 cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  CUtensorMap mq, mk, mv;
  if (!encode_bthd(fn, &mq, q, B, Tq, H, D, st[0], st[1], st[2], 64 * NWG) ||
      !encode_bthd(fn, &mk, k, B, Tk, H, D, st[3], st[4], st[5], BK) ||
      !encode_bthd(fn, &mv, v, B, Tk, H, D, st[6], st[7], st[8], BK))
    return -2;
  bf16* o = static_cast<bf16*>(out);
  if (mask != nullptr) {
    return causal ? launch_wgmma_t<D, NWG, true, true>(mq, mk, mv, mask, o, B, H, Tq, Tk, scale, stream)
                  : launch_wgmma_t<D, NWG, true, false>(mq, mk, mv, mask, o, B, H, Tq, Tk, scale, stream);
  }
  return causal ? launch_wgmma_t<D, NWG, false, true>(mq, mk, mv, mask, o, B, H, Tq, Tk, scale, stream)
                : launch_wgmma_t<D, NWG, false, false>(mq, mk, mv, mask, o, B, H, Tq, Tk, scale, stream);
}

}  // namespace hopper

// ----------------------------------------------------------------------------
// bf16, Dh 32: tensor cores via mma.sync
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

// 0 for a valid key, NEG_INF for a masked key or one past Tk.
__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int key, int Tk) {
  return key < Tk && (mask == nullptr || mask[(long long)b * Tk + key]) ? 0.f : NEG_INF;
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
                  const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
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
    if (threadIdx.x < MMA_BK) sbias[threadIdx.x] = key_bias(mask, b, k0 + threadIdx.x, Tk);
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
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
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
    if (tid < F32_BK) bs[tid] = key_bias(mask, b, k0 + tid, Tk);
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
void launch_f32(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
                cudaStream_t stream) {
  dim3 grid((Tq + F32_BQ - 1) / F32_BQ, B * H);
  attention_fwd_f32<D><<<grid, F32_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
}

void launch_mma32(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                  int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
                  cudaStream_t stream) {
  dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, B * H);
  attention_fwd_mma<32><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
}

}  // namespace

// route: 0 = fp32 scalar FMA (Dh 32/64/128), 1 = bf16 mma.sync (Dh 32), 2 = bf16 TMA +
// wgmma (Dh 64/128) with `consumers` warpgroups of 64 query rows per block (2 or 3 at
// Dh 64, 2 at Dh 128; the other routes ignore it). q/k/v 16-byte aligned with strides
// that are multiples of 8 elements for the bf16 routes. mask: [B, Tk] bytes (nonzero =
// valid key) or null. Strides in elements: q b/t/h, k b/t/h, v b/t/h. scale > 0.
// Returns cudaGetLastError() after the launch, -1 for an unsupported route, head dim or
// consumer count, -2 if a TMA tensor map cannot describe q/k/v, -3 if the driver has no
// cuTensorMapEncodeTiled.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int route, int consumers,
                                   int B, int H, int Tq, int Tk, int D, long long qsb,
                                   long long qst, long long qsh, long long ksb, long long kst,
                                   long long ksh, long long vsb, long long vst,
                                   long long vsh, float scale, int causal, void* stream) {
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (route == ROUTE_FMA_F32 && D == 32) {
    launch_f32<32>(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else if (route == ROUTE_FMA_F32 && D == 64) {
    launch_f32<64>(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else if (route == ROUTE_FMA_F32 && D == 128) {
    launch_f32<128>(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else if (route == ROUTE_MMA_SYNC && D == 32) {
    launch_mma32(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else if (route == ROUTE_WGMMA_TMA && D == 64 && consumers == 2) {
    rc = hopper::launch_wgmma<64, 2>(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else if (route == ROUTE_WGMMA_TMA && D == 64 && consumers == 3) {
    rc = hopper::launch_wgmma<64, 3>(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else if (route == ROUTE_WGMMA_TMA && D == 128 && consumers == 2) {
    rc = hopper::launch_wgmma<128, 2>(q, k, v, m, out, B, H, Tq, Tk, st, scale, causal, s);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
