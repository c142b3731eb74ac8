// K6: the early-exit gate (K6a, gate_stats) and the active-set repack (K6b,
// take_carry) of MoEvA2's success-gated early exit.
//
// Replaces two jnp device stages of moeva2_ijcai22_replication_tpu/attacks/
// moeva/engine.py (the repo has no Pallas kernel for either):
// - K6a: Moeva2._success_mask (engine.py:825), the jitted gate program
//   attacks/objective.py:55 engine_quality_stats over population ∪ archive;
// - K6b: Moeva2._take_carry (engine.py:874), one fused gather of every carry
//   leaf over the states axis, and Moeva2._final_columns (engine.py:933),
//   the solved rows' population then archive columns.
//
// K6a semantics (must equal the plain version, attacks.objective.
// engine_quality_stats on the concatenated objectives, bit for bit): per
// state, over its P + A candidates f = [f1, f2, g], the flags C = g <= 0,
// M = f1 < thr, D = f2 <= eps (IEEE comparisons: a NaN compares false) and
// their conjunctions C∧M, C∧D, M∧D, C∧M∧D, each "any" written as float 0 or
// 1; then min(g) and min(f2 where C∧M else +inf), both propagating NaN as
// torch.amin does. Output (S, 9) in that column order.
//
// K6b semantics (must equal index_select of each leaf): for output row b
// and segment k, dst_k[b * dst_stride_k + dst_offset_k + e] =
// src_k[idx[b] * row_elems_k + e] for e < row_elems_k, copied as 32-bit
// words (NaN payloads and signed zeros pass unchanged). A take_carry launch
// has one segment per carry leaf (pop_x, pop_f, arch_x, arch_f, ideal,
// worst, extreme) into new buffers; a final-columns launch has four that
// write pop then archive columns side by side into two outputs. An index
// outside [0, n_src) writes nothing: the wrapper refuses it before launch.
//
// Bound: bytes on both. K6a reads 12 bytes a candidate and writes 36 a
// state, a few comparisons each; K6b reads and writes each gathered word
// once. Both run once a gate (every few generations), beside six kernels a
// generation that each take far longer.
//
// Design, simple first:
// - K6a: one warp per state, eight states per block. A lane strides over
//   the state's candidates (population then archive) keeping a 7-bit flag
//   word and two running minima; a warp OR (__reduce_or_sync) and a
//   butterfly of NaN-propagating minima (nan_min, kernels.h) finish it,
//   lane 0 writes the 9 columns.
// - K6b: one block per (output row, segment); the block's threads copy the
//   row's words with consecutive threads on consecutive addresses. Rows of
//   P * L words are not 16-byte aligned in general (L = 47), so the copy
//   stays 4 bytes a thread.

#include "kernels.h"

namespace {

constexpr int kGateWarps = 8;
constexpr int kTakeThreads = 256;

__global__ void __launch_bounds__(kGateWarps * 32)
gate_stats_kernel(const float* __restrict__ pop_f, const float* __restrict__ arch_f,
                  float* __restrict__ out, int n_states, int p, int a, float thr,
                  float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kGateWarps + warp;
  if (s >= n_states) return;
  const float* pf = pop_f + static_cast<int64_t>(s) * p * 3;
  const float* af = arch_f + static_cast<int64_t>(s) * a * 3;
  unsigned flags = 0;
  float best_cv = INFINITY;
  float best_dist = INFINITY;
  for (int j = lane; j < p + a; j += 32) {
    const float* f = j < p ? pf + j * 3 : af + (j - p) * 3;
    const float f1 = f[0], f2 = f[1], g = f[2];
    const bool c = g <= 0.0f;
    const bool m = f1 < thr;
    const bool d = f2 <= eps;
    flags |= (c ? 1u : 0u) | (m ? 2u : 0u) | (d ? 4u : 0u) | (c && m ? 8u : 0u) |
             (c && d ? 16u : 0u) | (m && d ? 32u : 0u) | (c && m && d ? 64u : 0u);
    best_cv = nan_min(best_cv, g);
    best_dist = nan_min(best_dist, c && m ? f2 : INFINITY);
  }
  flags = __reduce_or_sync(0xffffffffu, flags);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    best_cv = nan_min(best_cv, __shfl_xor_sync(0xffffffffu, best_cv, off));
    best_dist = nan_min(best_dist, __shfl_xor_sync(0xffffffffu, best_dist, off));
  }
  if (lane == 0) {
    float* o = out + static_cast<int64_t>(s) * 9;
#pragma unroll
    for (int k = 0; k < 7; ++k) o[k] = (flags >> k) & 1u ? 1.0f : 0.0f;
    o[7] = best_cv;
    o[8] = best_dist;
  }
}

__global__ void __launch_bounds__(kTakeThreads)
take_kernel(const __grid_constant__ TakeArgs args) {
  const int b = blockIdx.x;
  const TakeSegment& seg = args.seg[blockIdx.y];
  const int64_t src_row = args.idx[b];
  if (src_row < 0 || src_row >= args.n_src) return;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(seg.src) + src_row * seg.row_elems;
  uint32_t* dst = reinterpret_cast<uint32_t*>(seg.dst) + b * seg.dst_stride + seg.dst_offset;
  for (int64_t e = threadIdx.x; e < seg.row_elems; e += kTakeThreads) dst[e] = src[e];
}

}  // namespace

cudaError_t launch_gate_stats(const float* pop_f, const float* arch_f, float* out,
                              int n_states, int p, int a, float thr, float eps,
                              cudaStream_t stream) {
  if (n_states == 0) return cudaSuccess;
  if (n_states < 0 || p < 1 || a < 0 || (a > 0 && arch_f == nullptr)) return cudaErrorInvalidValue;
  const int blocks = (n_states + kGateWarps - 1) / kGateWarps;
  gate_stats_kernel<<<blocks, kGateWarps * 32, 0, stream>>>(pop_f, arch_f, out, n_states, p, a,
                                                            thr, eps);
  return cudaGetLastError();
}

cudaError_t launch_take(const TakeArgs& args, cudaStream_t stream) {
  if (args.n_idx == 0 || args.n_seg == 0) return cudaSuccess;
  if (args.n_idx < 0 || args.n_seg < 0 || args.n_seg > kTakeMaxSegments) return cudaErrorInvalidValue;
  take_kernel<<<dim3(args.n_idx, args.n_seg), kTakeThreads, 0, stream>>>(args);
  return cudaGetLastError();
}
