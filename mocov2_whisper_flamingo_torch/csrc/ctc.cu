// CTC loss for Hopper (sm_90a): the forward (alpha) recursion and its gradient.
//
// Ports no Pallas kernel. It replaces the JAX package's CTC scan,
// mocov2_whisper_flamingo_tpu/ops/losses.py::ctc_forward_log_probs (`step` under
// `lax.scan`, :79-91), and the reverse scan that autodiff makes of it. On the TPU both run
// inside the train step's one jitted program with the lengths on the device; here they are
// two kernels that read the lengths and labels from int64 tensors on the card, read
// nothing back, and so run inside the train step's CUDA graph (training/programs.py).
//
// `ctc_alpha` (forward): one block per example, one thread per lattice position s of the
// extended sequence (blank, y1, blank, y2, ..., blank; S = 2L + 1 <= 1023). The block
// loops over the frames, one barrier a step, and each step is the JAX `step` to the letter:
// -1e30 for a dead path, the guarded log-add of `_log_add` (:25), the skip from s - 2 when
// the label differs from the one two places back, positions at or past 2 * label_len + 1
// dead, alpha frozen once the frame reaches the example's input length, and the NLL from
// the two final states. It keeps every frame's alphas, [B, T, S] fp32, for the backward.
//
// `ctc_grad` (backward): blocks 0..B-1 run the beta recursion of their example backwards
// over its frames and, at each frame, the occupancy exp(alpha + beta - log p) of each
// position; d NLL / d log_probs[t, k] is minus the sum of the occupancies of the positions
// that emit class k. The sum of a class that several positions emit (every blank, a
// repeated label) is taken in a fixed order, a warp-shuffle tree and the warps in turn for
// the blank and the chain of positions in increasing order for a label, with no
// floating-point atomics: two runs give the same bits. An example whose NLL is >= 5e29
// (no path fits its input) gets a gradient of exactly 0. Blocks B.. each own one [b, t]
// row of the dense gradient and write 0 to every class that the row's example never emits,
// so each element is written once, by one block, with no ordering between blocks.
//
// Bounds on the H100 SXM (3.35 TB/s) at the train step's shape [4, 400, 51865], L = 64:
// the backward writes the dense gradient, 4 * 400 * 51865 * 4 B = 332 MB -> 0.099 ms; the
// forward reads 4 * 400 * 129 emissions and writes as many alphas (1.7 MB, ~0.5 us). Both
// are a serial chain of T - 1 = 399 dependent steps, each a gathered load, a few log-adds
// and a block barrier (two in the backward), which no amount of memory rate shortens:
// that chain, not the bytes, sets the forward's time. The loads of the next frame are
// issued before the current one is computed, so a step waits on a barrier and the
// arithmetic, not on device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;    // a dead path, as in the JAX recursion
constexpr float INFEASIBLE = 5e29f;  // an NLL at or above it: no path fits the input
constexpr int MAX_S = 1023;          // lattice positions: one thread each, L <= 511
// The fill blocks' class bitmap, V <= 229376: with ctc_grad's 17.5 KB of static shared
// memory it stays under the 48 KB a block gets without opting in.
constexpr int MAX_CLASS_WORDS = 7168;

__device__ __forceinline__ float log_add(float a, float b) {
  const float mx = fmaxf(a, b);
  if (mx <= NEG_INF) return NEG_INF;  // both dead: dead, as the guarded JAX log-add
  return mx + logf(expf(a - mx) + expf(b - mx));
}

// The row's valid labels (0..L) and the frames its recursion takes (1..T): the JAX step
// runs frame 0 whatever the input length, then every frame t < input_length.
__device__ __forceinline__ int valid_labels(const long long* lab_len, int b, int L) {
  return static_cast<int>(min(max(lab_len[b], 0LL), static_cast<long long>(L)));
}

__device__ __forceinline__ int frames_taken(const long long* in_len, int b, int T) {
  return static_cast<int>(min(max(in_len[b], 1LL), static_cast<long long>(T)));
}

// The class that lattice position s emits: the blank at even s, else its label, clamped
// into [0, V) so that a label out of range cannot address memory outside the row.
__device__ __forceinline__ int position_class(const long long* labels_b, int s, int blank,
                                              int V) {
  if (!(s & 1)) return blank;
  return static_cast<int>(min(max(labels_b[s >> 1], 0LL), static_cast<long long>(V - 1)));
}

// The skip transition into position s (from s - 2): s is a label and differs from the
// class two places back (the blank that pads the front, for s = 1).
__device__ __forceinline__ bool skips_into(const long long* labels_b, int s, int cls, int blank,
                                           int V) {
  return (s & 1) && cls != (s >= 3 ? position_class(labels_b, s - 2, blank, V) : blank);
}

__global__ void __launch_bounds__(1024)
ctc_alpha(const float* __restrict__ lp, const long long* __restrict__ labels,
          const long long* __restrict__ in_len, const long long* __restrict__ lab_len,
          float* __restrict__ alphas, float* __restrict__ nll, int T, int V, int L,
          int blank) {
  __shared__ float buf[2][MAX_S + 2];  // alpha of position s at [2 + s]; [0], [1] dead
  const int b = blockIdx.x, s = threadIdx.x, S = 2 * L + 1;
  const int n_labels = valid_labels(lab_len, b, L), frames = frames_taken(in_len, b, T);
  const bool valid = s < 2 * n_labels + 1;
  const long long* labels_b = labels + static_cast<size_t>(b) * L;
  const int cls = valid ? position_class(labels_b, s, blank, V) : blank;
  const bool skip = valid && skips_into(labels_b, s, cls, blank, V);
  const float* lp_b = lp + static_cast<size_t>(b) * T * V;
  float* alpha_b = alphas + static_cast<size_t>(b) * T * S;

  float a = NEG_INF;  // frame 0: the blank, and the first label if there is one
  if (s == 0 || (s == 1 && n_labels > 0)) a = lp_b[cls];
  if (s < 2) buf[0][s] = buf[1][s] = NEG_INF;
  if (s < S) {
    buf[0][2 + s] = a;
    alpha_b[s] = a;
  }
  float e_next = (valid && frames > 1) ? lp_b[static_cast<size_t>(V) + cls] : NEG_INF;
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < frames; ++t) {
    const float e = e_next;
    if (valid && t + 1 < frames) e_next = lp_b[static_cast<size_t>(t + 1) * V + cls];
    const float* in = buf[cur];
    if (valid) a = log_add(log_add(in[2 + s], in[1 + s]), skip ? in[s] : NEG_INF) + e;
    if (s < S) {
      buf[cur ^ 1][2 + s] = a;
      alpha_b[static_cast<size_t>(t) * S + s] = a;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (s < S) {
    for (int t = frames; t < T; ++t) alpha_b[static_cast<size_t>(t) * S + s] = a;  // frozen
  }
  if (s == 0) {
    const float* fin = buf[cur];
    const int end = 2 * n_labels;
    nll[b] = -log_add(fin[2 + end], n_labels > 0 ? fin[1 + end] : NEG_INF);
  }
}

// A fill block: zeros at every class of row [b, t] that example b never emits (the blank
// and its valid labels are the recursion block's to write).
__device__ void zero_unemitted(uint32_t* emitted, const long long* __restrict__ labels,
                               const long long* __restrict__ lab_len, float* __restrict__ grad,
                               int row, int T, int V, int L, int blank) {
  const int b = row / T, words = (V + 31) >> 5;
  for (int i = threadIdx.x; i < words; i += blockDim.x) emitted[i] = 0u;
  __syncthreads();
  const int n_labels = valid_labels(lab_len, b, L);
  const long long* labels_b = labels + static_cast<size_t>(b) * L;
  for (int i = threadIdx.x; i <= n_labels; i += blockDim.x) {
    const int c = i == n_labels ? blank : position_class(labels_b, 2 * i + 1, blank, V);
    atomicOr(&emitted[c >> 5], 1u << (c & 31));  // an integer OR: the same bits in any order
  }
  __syncthreads();
  float* out = grad + static_cast<size_t>(row) * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    if (!((emitted[v >> 5] >> (v & 31)) & 1u)) out[v] = 0.f;
  }
}

__global__ void __launch_bounds__(1024)
ctc_grad(const float* __restrict__ lp, const long long* __restrict__ labels,
         const long long* __restrict__ in_len, const long long* __restrict__ lab_len,
         const float* __restrict__ alphas, const float* __restrict__ nll,
         const float* __restrict__ grad_nll, float* __restrict__ grad, int B, int T, int V,
         int L, int blank) {
  extern __shared__ uint32_t emitted[];  // fill blocks: one bit per class
  if (blockIdx.x >= B) {
    zero_unemitted(emitted, labels, lab_len, grad, blockIdx.x - B, T, V, L, blank);
    return;
  }
  __shared__ float occ[MAX_S + 1];        // occupancy of each position at the frame
  __shared__ float x[MAX_S + 3];          // beta + emission at the frame; dead past S
  __shared__ int pos_class[MAX_S + 1];    // class of each valid position, -1 past them
  __shared__ int chain_next[MAX_S + 1];   // next position of the same label class, or -1
  __shared__ unsigned char skip_to[MAX_S + 3];  // the skip transition into each position
  __shared__ float warp_blank[32];        // each warp's sum of the blank's occupancies

  const int b = blockIdx.x, s = threadIdx.x, S = 2 * L + 1;
  const int n_labels = valid_labels(lab_len, b, L), frames = frames_taken(in_len, b, T);
  const int n_valid = 2 * n_labels + 1;
  const bool valid = s < n_valid;
  const long long* labels_b = labels + static_cast<size_t>(b) * L;
  const int cls = valid ? position_class(labels_b, s, blank, V) : -1;
  const float* lp_b = lp + static_cast<size_t>(b) * T * V;
  const float* alpha_b = alphas + static_cast<size_t>(b) * T * S;
  float* grad_b = grad + static_cast<size_t>(b) * T * V;
  const float g = grad_nll[b], nll_b = nll[b];
  const bool infeasible = nll_b >= INFEASIBLE;

  if (s < S) {
    pos_class[s] = cls;
    skip_to[s] = valid && skips_into(labels_b, s, cls, blank, V);
  }
  if (s == 0) {
    x[S] = x[S + 1] = NEG_INF;
    skip_to[S] = skip_to[S + 1] = 0;
  }
  __syncthreads();
  // A label class is written by its first position, which sums the chain of its others.
  bool first = valid && (s & 1) && cls != blank;
  if (first) {
    for (int j = 1; j < s; j += 2) {
      if (pos_class[j] == cls) {
        first = false;
        break;
      }
    }
  }
  if (s < S) {
    int next = -1;
    if (valid && (s & 1) && cls != blank) {
      for (int j = s + 2; j < n_valid; j += 2) {
        if (pos_class[j] == cls) {
          next = j;
          break;
        }
      }
    }
    chain_next[s] = next;
  }
  for (int t = frames; t < T; ++t) {  // frames past the input: no gradient
    if (first) grad_b[static_cast<size_t>(t) * V + cls] = 0.f;
    if (s == 0) grad_b[static_cast<size_t>(t) * V + blank] = 0.f;
  }

  // beta at the last frame taken: the two final states
  float beta = (valid && (s == 2 * n_labels || (n_labels > 0 && s == 2 * n_labels - 1)))
                   ? 0.f : NEG_INF;
  const int warp = s >> 5, lane = s & 31, n_warps = (blockDim.x + 31) >> 5;
  int t = frames - 1;
  float a_next = valid ? alpha_b[static_cast<size_t>(t) * S + s] : NEG_INF;
  float e_next = valid ? lp_b[static_cast<size_t>(t) * V + cls] : NEG_INF;
  for (; t >= 0; --t) {
    const float a = a_next, e = e_next;
    if (valid && t > 0) {
      a_next = alpha_b[static_cast<size_t>(t - 1) * S + s];
      e_next = lp_b[static_cast<size_t>(t - 1) * V + cls];
    }
    const float o = (valid && !infeasible) ? expf(a + beta + nll_b) : 0.f;
    if (s < S) {
      occ[s] = o;
      x[s] = valid ? beta + e : NEG_INF;
    }
    float blank_part = (valid && cls == blank) ? o : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      blank_part += __shfl_down_sync(0xffffffffu, blank_part, off);
    if (lane == 0) warp_blank[warp] = blank_part;
    __syncthreads();
    float* row = grad_b + static_cast<size_t>(t) * V;
    if (s == 0) {
      float sum = 0.f;
      for (int w = 0; w < n_warps; ++w) sum += warp_blank[w];
      row[blank] = infeasible ? 0.f : -g * sum;
    }
    if (first) {
      float sum = occ[s];
      for (int j = chain_next[s]; j >= 0; j = chain_next[j]) sum += occ[j];
      row[cls] = infeasible ? 0.f : -g * sum;
    }
    // beta one frame back: from s itself, s + 1, and s + 2 where it skips over s + 1
    if (valid) beta = log_add(log_add(x[s], x[s + 1]), skip_to[s + 2] ? x[s + 2] : NEG_INF);
    __syncthreads();
  }
}

int block_threads(int S, int at_least) {
  const int n = (S + 31) / 32 * 32;
  return n < at_least ? at_least : n;
}

}  // namespace

// log_probs [B, T, V] fp32 contiguous; labels [B, L] int64; input_lengths, label_lengths
// [B] int64; alphas [B, T, S] fp32 and nll [B] fp32 written. Returns 0, -1 for a shape the
// kernel does not take, or the CUDA error of the launch.
extern "C" int ctc_forward(const void* log_probs, const void* labels, const void* input_lengths,
                           const void* label_lengths, void* alphas, void* nll, int B, int T,
                           int V, int L, int blank, void* stream) {
  const int S = 2 * L + 1;
  if (B < 1 || T < 1 || L < 0 || S > MAX_S || blank < 0 || blank >= V) return -1;
  ctc_alpha<<<B, block_threads(S, 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const long long*>(labels),
      static_cast<const long long*>(input_lengths), static_cast<const long long*>(label_lengths),
      static_cast<float*>(alphas), static_cast<float*>(nll), T, V, L, blank);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and outputs, grad_nll [B] fp32 (d loss / d nll); grad [B, T, V]
// fp32 written whole: d loss / d log_probs.
extern "C" int ctc_backward(const void* log_probs, const void* labels, const void* input_lengths,
                            const void* label_lengths, const void* alphas, const void* nll,
                            const void* grad_nll, void* grad, int B, int T, int V, int L,
                            int blank, void* stream) {
  const int S = 2 * L + 1;
  const long long blocks = static_cast<long long>(B) + static_cast<long long>(B) * T;
  const int words = (V + 31) / 32;
  if (B < 1 || T < 1 || L < 0 || S > MAX_S || blank < 0 || blank >= V ||
      words > MAX_CLASS_WORDS || blocks > 0x7fffffffLL)
    return -1;
  ctc_grad<<<static_cast<unsigned>(blocks), block_threads(S, 256), words * sizeof(uint32_t),
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const long long*>(labels),
      static_cast<const long long*>(input_lengths), static_cast<const long long*>(label_lengths),
      static_cast<const float*>(alphas), static_cast<const float*>(nll),
      static_cast<const float*>(grad_nll), static_cast<float*>(grad), B, T, V, L, blank);
  return static_cast<int>(cudaGetLastError());
}
