// K2: non-dominated front peeling, one thread block per state.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// nds.py::nd_ranks (a lax.while_loop over (M, M) count contractions; the
// repo has no Pallas kernel for it). In eager PyTorch that loop costs a host
// round trip per front; here the whole peel runs inside the block.
//
// Semantics (must equal nd_ranks_plain bit for bit): i dominates j iff
// all(f_i <= f_j) and any(f_i < f_j) — IEEE comparisons, so a NaN row
// neither dominates nor is dominated. Fronts 0, 1, 2, ... are peeled until
// at least n_stop candidates are ranked; if a peel finds no front among the
// remaining candidates, all of them take the current rank (the safety
// branch of nds.py). Unpeeled candidates keep 2^31 - 1.
//
// Design: the domination relation lives in shared memory as a bitset,
// row j holding the ceil(M/32) words whose bit i says "i dominates j"
// (5.7 KB at M = 203). A peel is then, per remaining candidate, an AND of
// its row with the remaining-set bitset. The work is O(M^2) comparisons per
// state and a few words per candidate per front: the kernel is bound by
// latency (the sequential fronts), not by bytes or operations.

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kUnranked = 0x7fffffff;

__global__ void __launch_bounds__(kThreads)
nd_peel_kernel(const float* __restrict__ f, int32_t* __restrict__ ranks,
               int m, int n_stop) {
  extern __shared__ uint32_t smem[];
  const int words = (m + 31) >> 5;
  float* fs = reinterpret_cast<float*>(smem);  // (m, 3)
  uint32_t* dom_by = smem + 3 * m;             // (m, words)
  uint32_t* remaining = dom_by + m * words;    // (words,)
  uint32_t* front = remaining + words;         // (words,)

  const float* fg = f + static_cast<size_t>(blockIdx.x) * m * 3;
  int32_t* rg = ranks + static_cast<size_t>(blockIdx.x) * m;

  for (int k = threadIdx.x; k < 3 * m; k += blockDim.x) fs[k] = fg[k];
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int live = min(32, m - 32 * w);
    remaining[w] = live == 32 ? 0xffffffffu : ((1u << live) - 1u);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float a0 = fs[3 * j], a1 = fs[3 * j + 1], a2 = fs[3 * j + 2];
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      const int base = 32 * w;
      const int live = min(32, m - base);
      for (int b = 0; b < live; ++b) {
        const float* fi = fs + 3 * (base + b);
        const bool le = (fi[0] <= a0) & (fi[1] <= a1) & (fi[2] <= a2);
        const bool lt = (fi[0] < a0) | (fi[1] < a1) | (fi[2] < a2);
        bits |= static_cast<uint32_t>(le & lt) << b;
      }
      dom_by[j * words + w] = bits;
    }
    rg[j] = kUnranked;
  }
  __syncthreads();

  // ranked / left are uniform across the block: every thread counts the
  // same front bitset
  int ranked = 0;
  int left = m;
  for (int r = 0; ranked < n_stop && left > 0; ++r) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) front[w] = 0u;
    __syncthreads();
    int found = 0;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      if ((remaining[j >> 5] >> (j & 31)) & 1u) {
        bool free = true;
        for (int w = 0; w < words && free; ++w)
          free = (dom_by[j * words + w] & remaining[w]) == 0u;
        if (free) {
          atomicOr(&front[j >> 5], 1u << (j & 31));
          found = 1;
        }
      }
    }
    if (!__syncthreads_or(found)) {
      // safety branch: nothing peeled, every remaining candidate takes r
      for (int w = threadIdx.x; w < words; w += blockDim.x) front[w] = remaining[w];
      __syncthreads();
    }
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      if ((front[j >> 5] >> (j & 31)) & 1u) rg[j] = r;
    int count = 0;
    for (int w = 0; w < words; ++w) count += __popc(front[w]);
    __syncthreads();
    for (int w = threadIdx.x; w < words; w += blockDim.x) remaining[w] &= ~front[w];
    __syncthreads();
    ranked += count;
    left -= count;
  }
}

}  // namespace

cudaError_t launch_nd_peel(const float* f, int32_t* ranks, int n_states,
                           int m, int n_stop, cudaStream_t stream) {
  if (n_states == 0 || m == 0) return cudaSuccess;
  if (m < 0 || m > kNdPeelMaxCandidates || n_states < 0) return cudaErrorInvalidValue;
  const int words = (m + 31) / 32;
  const size_t smem = sizeof(uint32_t) * (3 * m + m * words + 2 * words);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nd_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nd_peel_kernel<<<n_states, kThreads, smem, stream>>>(f, ranks, m, n_stop);
  return cudaGetLastError();
}
