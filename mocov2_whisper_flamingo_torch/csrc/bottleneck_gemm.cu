// The frozen MoCo ResNet-50's 1x1 convolutions as one GEMM each, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to XLA, which fuses
// each one's folded bias, residual add and ReLU into the convolution. The port ran them
// through cuDNN, which adds the bias, the residual and the ReLU in passes of their own,
// each reading and writing the whole NHWC activation; this kernel does the 36 1x1
// convolutions of the bottleneck blocks (conv1, conv3 with the identity, the downsample)
// with that epilogue on the fp32 accumulators, rounded once to bf16.
//
// Function: out[m, n] = act(sum_k a[m, k] * w[n, k] + bias[n] (+ res[m, n])), where
//   * a is the NHWC bf16 input as rows [M_in, C_in]; at stride 2 row m of the output reads
//     input pixel (2 oh, 2 ow) of its image, through the tensor map's strides (no copy);
//   * w is the folded weight [C_out, C_in] bf16, bias fp32 [C_out];
//   * res (optional) is [M, C_out] bf16, the block's identity; act is ReLU or nothing;
//   * out is [M, C_out] bf16, M = images * H_out * W_out.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes. At the train cell's 6,400
// frames of 64 x 64 the 36 calls do 3.35 TFLOP and move at least 26 GB a step (each input
// read once, each output written once): 8 ms of HBM against 3.4 ms of tensor cores, with
// 28 to 680 operations a byte against the card's 295. So the design keeps the bytes in
// flight and moves each byte once:
//   * one persistent block per SM walks output tiles of 128 rows x BN columns (BN 64, 128
//     or 256, the widest that divides C_out), N-tiles of one row panel next to each other,
//     so that a panel of a read from HBM by one block is read from L2 by its neighbours;
//   * one producer thread keeps TMA loads of a (128 x 64) and w (BN x 64) in a ring of
//     stages (3 to 8, as shared memory allows), running ahead across tiles; two consumer
//     warpgroups of 64 rows each run wgmma m64nBNk16 on the stages as they arrive;
//   * the epilogue adds the bias (and the residual) to the accumulators, applies the ReLU,
//     rounds to bf16 and writes the tile into shared memory in the 128-byte swizzle (no
//     bank conflicts), from where a second producer thread stores it with TMA. That thread
//     also loads the next tile's residual into the same buffer with TMA as soon as the
//     store has read it, so neither the residual nor the store holds up the tensor cores.
//   * TMA fills rows past M with zeros and clips the store at M: every M is valid. A
//     stride-2 tile is whole lines of output pixels (a 4-D map over the input's images,
//     rows and columns at stride 2, and a 3-D map over the output's images), so a tile
//     never crosses an image at a ragged row.
// No split over K and no atomics: a call gives the same bits every time.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // output rows per tile, 64 per consumer warpgroup
constexpr int BK = 64;        // input channels per stage: one 128-byte swizzle atom
constexpr int ATOM = 128;     // bytes in one row of a 64-column swizzle atom
constexpr int THREADS = 384;  // one producer warpgroup, two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 * 128 + 232 * 256 <= 64K

template <int BN>
struct Layout {
  static constexpr int STAGES = BN == 256 ? 3 : BN == 128 ? 6 : 8;
  static constexpr int A_BYTES = BM * ATOM;
  static constexpr int STAGE_BYTES = A_BYTES + BN * ATOM;
  // Offsets from a 1024-byte aligned base (the 128-byte swizzle repeats every 1024 bytes,
  // and TMA and wgmma both apply it to address bits).
  static constexpr int OUT = STAGES * STAGE_BYTES;  // the epilogue's tile: BN / 64 atoms
  static constexpr int BAR = OUT + BM * BN * 2;
  static constexpr int NBAR = 2 * STAGES + 2;  // full[], empty[], out_ready, out_done
  static constexpr int BYTES = BAR + NBAR * 8 + 1024;  // + slack for aligning the base
};

// Where the tiles lie. Output tile t is row tile t / n_tiles, column tile t % n_tiles.
// Row tile r of `lines` per group q = r / lines reads a at (k, l * a1, l * a2, q * nb)
// and writes out (and reads res) at (n, l * o1, q * nb), l = r % lines. Stride 1: one
// group of `lines` tiles of 128 rows. Stride 2: groups of nb images, each cut into
// `lines` tiles of hb output rows of wo pixels.
struct Tiles {
  int n_tiles, tiles, lines, a1, a2, nb, o1;
  int k_blocks;  // C_in / 64
  int rows;      // rows a tile's boxes hold (a: rows x 64 each stage)
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// One consumer warp is done with a buffer: one arrival per warp, by lane 0 through a
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The stores issued so far have read their shared memory (the buffer may be written).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The stores issued so far are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Writes of this thread to shared memory become visible to the TMA unit's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
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

// d (+)= A[64x16] (shared, K-major) * B[16x64] (shared, K-major); d is m64n64 fp32.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A[64x16] (shared, K-major) * B[16x128] (shared, K-major); d is m64n128 fp32.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
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

// d (+)= A[64x16] (shared, K-major) * B[16x256] (shared, K-major); d is m64n256 fp32.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db, accumulate);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, da, db, accumulate);
  } else {
    wgmma_n256(d, da, db, accumulate);
  }
}

// acc (+)= a_stage[64 rows x 64] . b_stage[BN x 64]^T, both K-major in one swizzle atom.
template <int BN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t a, uint32_t b,
                                          int accumulate) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_bn<BN>(acc, gmma_desc(a + kk * 32, 16, 8 * ATOM), gmma_desc(b + kk * 32, 16, 8 * ATOM),
                 accumulate | kk);
  wgmma_commit();
}

__device__ __forceinline__ void tile_coords(const Tiles& g, int tile, int& m_a1, int& m_a2,
                                            int& m_a3, int& m_o1, int& m_o2, int& n0,
                                            int bn) {
  const int r = tile / g.n_tiles;
  const int q = r / g.lines, l = r % g.lines;
  m_a1 = l * g.a1;
  m_a2 = l * g.a2;
  m_a3 = q * g.nb;
  m_o1 = l * g.o1;
  m_o2 = q * g.nb;
  n0 = (tile % g.n_tiles) * bn;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
bottleneck_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_res,
                       const __grid_constant__ CUtensorMap tm_out,
                       const float* __restrict__ bias, const Tiles g, int has_res, int relu) {
  using L = Layout<BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_s = base + L::OUT, bar = base + L::BAR;
  auto stage_a = [base](int s) { return base + s * L::STAGE_BYTES; };
  auto stage_w = [base](int s) { return base + s * L::STAGE_BYTES + L::A_BYTES; };
  auto full = [bar](int s) { return bar + 8u * s; };
  auto empty = [bar](int s) { return bar + 8u * (STAGES + s); };
  const uint32_t out_ready = bar + 8u * (2 * STAGES);  // the buffer may be written (residual in)
  const uint32_t out_done = out_ready + 8u;           // the buffer holds a finished tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(out_ready, 1);
    mbar_init(out_done, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so that the compiler sees it uniform.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (lane != 0 || warp > 1) return;
    int a1, a2, a3, o1, o2, n0;
    if (warp == 0) {
      // ---- warp 0: the a and w stages, running ahead across tiles ----
      const uint32_t bytes = (g.rows + BN) * ATOM;
      int it = 0;
      for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
        tile_coords(g, tile, a1, a2, a3, o1, o2, n0, BN);
        for (int kb = 0; kb < g.k_blocks; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // the first pass finds empty slots
          mbar_expect_tx(full(s), bytes);
          tma_load_4d(stage_a(s), &tm_a, full(s), kb * BK, a1, a2, a3);
          tma_load_2d(stage_w(s), &tm_w, full(s), kb * BK, n0);
        }
      }
    } else {
      // ---- warp 1: the epilogue's residual in and finished tile out ----
      int t = 0;
      for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++t) {
        tile_coords(g, tile, a1, a2, a3, o1, o2, n0, BN);
        if (has_res) {
          mbar_expect_tx(out_ready, g.rows * ATOM * (BN / 64));
          for (int a = 0; a < BN / 64; ++a)
            tma_load_3d(out_s + a * BM * ATOM, &tm_res, out_ready, n0 + 64 * a, o1, o2);
        } else {
          mbar_arrive(out_ready);
        }
        mbar_wait(out_done, t & 1);
        for (int a = 0; a < BN / 64; ++a)
          tma_store_3d(&tm_out, out_s + a * BM * ATOM, n0 + 64 * a, o1, o2);
        bulk_commit();
        bulk_wait_read();
      }
      bulk_wait();
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 * cw .. 64 * cw + 63 of each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;
  const int row0 = 64 * cw + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);                  // its first column in every 8 columns
  const int swz = lane / 4;                         // (row0 + 8 h) % 8
  float acc[BN / 2];
  int it = 0, t = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++t) {
    // The first stage is peeled off the loop so that no branch joins around a wgmma in
    // flight (ptxas would copy accumulators and serialise the products).
    int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    mma_stage<BN>(acc, stage_a(s) + 64 * cw * ATOM, stage_w(s), 0);
    int prev = s;
    ++it;
    for (int kb = 1; kb < g.k_blocks; ++kb, ++it) {
      s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      mma_stage<BN>(acc, stage_a(s) + 64 * cw * ATOM, stage_w(s), 1);
      wgmma_wait<1>();  // the previous stage's products are done: its slot may be refilled
      release(empty(prev), lane);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty(prev), lane);

    // Epilogue: bias (and residual) on the fp32 accumulators, ReLU, one rounding to bf16,
    // into the swizzled tile that warp 1 stores. acc[4 j + 2 h + e] is row row0 + 8 h,
    // column 8 j + col0 + e of the tile.
    const float* tile_bias = bias + (tile % g.n_tiles) * BN;
    mbar_wait(out_ready, t & 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(tile_bias + 8 * j + col0));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t addr = out_s + (j / 8) * (BM * ATOM) + (row0 + 8 * h) * ATOM +
                              (((j % 8) ^ swz) << 4) + col0 * 2;
        float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        if (has_res) {
          const float2 r = unpack_bf16(lds32(addr));
          v0 += r.x;
          v1 += r.y;
        }
        if (relu) {
          v0 = v0 < 0.f ? 0.f : v0;  // NaN stays NaN, as in torch.relu
          v1 = v1 < 0.f ? 0.f : v1;
        }
        sts32(addr, pack_bf16(v0, v1));
      }
    }
    fence_async_shared();
    release(out_done, lane);
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

// A bf16 map of `rank` dims (innermost first; strides in elements, of dims 1..rank-1),
// boxes with 64 columns and the 128-byte swizzle; rows past a dim's end read as zeros
// and are not written.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank, const long long* dims,
            const long long* strides, const int* box) {
  cuuint64_t d[4], s[3];
  cuuint32_t b[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    if (i > 0) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, s, b, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mr,
           const CUtensorMap& mo, const float* bias, const Tiles& g, int has_res, int relu,
           int blocks, cudaStream_t stream) {
  using L = Layout<BN>;
  const auto kernel = bottleneck_gemm_kernel<BN>;
  static bool configured[64] = {};  // per device: the dynamic shared memory limit is raised once
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= 64 || !configured[dev]) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (rc != cudaSuccess) return rc;
    if (dev < 64) configured[dev] = true;
  }
  kernel<<<blocks, THREADS, L::BYTES, stream>>>(ma, mw, mr, mo, bias, g, has_res, relu);
  return 0;
}

}  // namespace

// The 1x1 convolution of `images` NHWC bf16 images [H, W, C_in] (a) at `stride` (1 or 2,
// no padding) by w [C_out, C_in] bf16, plus bias [C_out] fp32 and, where res is not null,
// res [images, H_out, W_out, C_out] bf16, then ReLU where `relu`; out [images, H_out,
// W_out, C_out] bf16, H_out = (H - 1) / stride + 1. C_in and C_out multiples of 64;
// a, w, res and out 16-byte aligned, bias 8-byte aligned; at stride 2, W_out <= 128.
// `tile_n` is the output tile's width (64, 128 or 256, dividing C_out); at most `blocks`
// persistent blocks (one per SM). Returns cudaGetLastError() after the launch, -1 for
// arguments the kernel does not take, -2 if a TMA tensor map cannot describe a tensor,
// -3 if the driver has no cuTensorMapEncodeTiled.
extern "C" int bottleneck_gemm(const void* a, const void* w, const void* bias, const void* res,
                               void* out, int images, int height, int width, int c_in,
                               int c_out, int stride, int relu, int tile_n, int blocks,
                               void* stream) {
  const auto misaligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes != 0;
  };
  if (images < 1 || height < 1 || width < 1 || c_in < 64 || c_in % 64 || c_out < 64 ||
      c_out % 64 || (stride != 1 && stride != 2) || blocks < 1 ||
      (tile_n != 64 && tile_n != 128 && tile_n != 256) || c_out % tile_n ||
      misaligned(a, 16) || misaligned(w, 16) || misaligned(out, 16) ||
      (res != nullptr && misaligned(res, 16)) || misaligned(bias, 8))
    return -1;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  const long long ho = (height - 1) / stride + 1, wo = (width - 1) / stride + 1;
  const long long pixels = ho * wo, m = images * pixels;
  Tiles g{};
  g.n_tiles = c_out / tile_n;
  g.k_blocks = c_in / BK;
  CUtensorMap ma, mw, mr, mo;
  long long groups = 1;  // of images: one at stride 1, where a tile is any 128 rows
  long long a_dims[4], a_strides[3], o_dims[3], o_strides[2];
  int a_box[4], o_box[3];
  if (stride == 1) {  // rows of the whole batch, 128 a tile
    const long long lines = (m + BM - 1) / BM;
    if (lines > 0x7fffffffLL / BM) return -1;
    g.lines = static_cast<int>(lines);
    g.a1 = g.o1 = BM;
    g.a2 = 0;
    g.nb = 1;
    g.rows = BM;
    const long long ad[4] = {c_in, m, 1, 1}, as[3] = {c_in, m * c_in, m * c_in};
    const int ab[4] = {BK, BM, 1, 1};
    const long long od[3] = {c_out, m, 1}, os[2] = {c_out, m * c_out};
    const int ob[3] = {64, BM, 1};
    for (int i = 0; i < 4; ++i) a_dims[i] = ad[i], a_box[i] = ab[i];
    for (int i = 0; i < 3; ++i) a_strides[i] = as[i], o_dims[i] = od[i], o_box[i] = ob[i];
    for (int i = 0; i < 2; ++i) o_strides[i] = os[i];
  } else {  // whole output lines: nb images a tile, or hb lines of one image
    if (wo > BM) return -1;
    long long hb, nb;
    if (pixels <= BM) {
      hb = ho;
      nb = BM / pixels;
      g.lines = 1;
    } else {
      nb = 1;
      hb = BM / wo;
      g.lines = static_cast<int>((ho + hb - 1) / hb);
    }
    groups = (images + nb - 1) / nb;
    g.a1 = 0;
    g.a2 = static_cast<int>(hb);
    g.nb = static_cast<int>(nb);
    g.o1 = static_cast<int>(hb * wo);
    g.rows = static_cast<int>(hb * wo * nb);
    const long long ad[4] = {c_in, wo, ho, images};
    const long long as[3] = {2LL * c_in, 2LL * width * c_in, (long long)height * width * c_in};
    const int ab[4] = {BK, static_cast<int>(wo), static_cast<int>(hb), static_cast<int>(nb)};
    const long long od[3] = {c_out, pixels, images}, os[2] = {c_out, pixels * c_out};
    const int ob[3] = {64, static_cast<int>(hb * wo), static_cast<int>(nb)};
    for (int i = 0; i < 4; ++i) a_dims[i] = ad[i], a_box[i] = ab[i];
    for (int i = 0; i < 3; ++i) a_strides[i] = as[i], o_dims[i] = od[i], o_box[i] = ob[i];
    for (int i = 0; i < 2; ++i) o_strides[i] = os[i];
  }
  const long long tiles = groups * g.lines * g.n_tiles;
  if (tiles > 0x7fffffffLL) return -1;
  g.tiles = static_cast<int>(tiles);
  const long long w_dims[2] = {c_in, c_out}, w_strides[1] = {c_in};
  const int w_box[2] = {BK, tile_n};
  if (!encode(fn, &ma, a, 4, a_dims, a_strides, a_box) ||
      !encode(fn, &mw, w, 2, w_dims, w_strides, w_box) ||
      !encode(fn, &mo, out, 3, o_dims, o_strides, o_box) ||
      (res != nullptr && !encode(fn, &mr, res, 3, o_dims, o_strides, o_box)))
    return -2;
  if (res == nullptr) mr = mo;  // never read
  const float* b = static_cast<const float*>(bias);
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int has_res = res != nullptr;
  int rc = tile_n == 256   ? launch<256>(ma, mw, mr, mo, b, g, has_res, relu, grid, s)
           : tile_n == 128 ? launch<128>(ma, mw, mr, mo, b, g, has_res, relu, grid, s)
                           : launch<64>(ma, mw, mr, mo, b, g, has_res, relu, grid, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
