// K3: niche association, one thread block per state, one thread per
// candidate.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// survival.py::associate_batch (and its blocked form _associate_blocked).
// The repo's one Pallas kernel computed this stage; it was removed in
// 608a48b after it crashed the TPU worker at 537-544 states.
//
// Semantics (those of associate_plain): denom = nadir - ideal with 0
// replaced by 1e-12; n = (f - ideal) / denom; d_r = dirs_r / |dirs_r|;
// niche = first argmax over r of (n . d_r)^2 (strict > keeps the first
// index on ties); dist = sqrt(max(|n|^2 - best, 0)), NaN passing through.
// argmax counts NaN as the largest value: the first NaN projection wins and
// nothing replaces it. Such rows are real: an inf objective (a ratio
// constraint whose denominator a mutation set to 0) under a finite nadir
// gives inf * 0 = NaN on the axis directions and inf elsewhere.
//
// Every product and sum is written with __fmul_rn / __fadd_rn in the order
// n0*d0 + n1*d1 + n2*d2, so nvcc cannot contract them into FMAs and the
// rounding is that of the plain formula evaluated left to right.
//
// Design: the R normalised directions of the state sit in shared memory
// (12 bytes each) and every thread scans them for its candidate. The work is
// 6 flops per (candidate, direction) pair on 28 input bytes per candidate:
// bound by operations in principle, by launch latency at the main path's
// shapes.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__global__ void __launch_bounds__(kThreads)
associate_kernel(const float* __restrict__ f, const float* __restrict__ dirs,
                 const float* __restrict__ ideal,
                 const float* __restrict__ nadir, int64_t* __restrict__ niche,
                 float* __restrict__ dist, int m, int r) {
  extern __shared__ float ds[];  // (r, 3) unit directions
  const size_t s = blockIdx.x;
  const float* dg = dirs + s * r * 3;
  for (int q = threadIdx.x; q < r; q += blockDim.x) {
    const float a = dg[3 * q], b = dg[3 * q + 1], c = dg[3 * q + 2];
    const float nrm = sqrtf(dot3(a, b, c, a, b, c));
    ds[3 * q] = __fdiv_rn(a, nrm);
    ds[3 * q + 1] = __fdiv_rn(b, nrm);
    ds[3 * q + 2] = __fdiv_rn(c, nrm);
  }
  float id[3], den[3];
  for (int k = 0; k < 3; ++k) {
    id[k] = ideal[s * 3 + k];
    const float dk = __fsub_rn(nadir[s * 3 + k], id[k]);
    den[k] = dk == 0.0f ? 1e-12f : dk;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float* fj = f + (s * m + j) * 3;
    const float n0 = __fdiv_rn(__fsub_rn(fj[0], id[0]), den[0]);
    const float n1 = __fdiv_rn(__fsub_rn(fj[1], id[1]), den[1]);
    const float n2 = __fdiv_rn(__fsub_rn(fj[2], id[2]), den[2]);
    float best = -INFINITY;
    int best_q = 0;
    for (int q = 0; q < r; ++q) {
      const float p = dot3(n0, n1, n2, ds[3 * q], ds[3 * q + 1], ds[3 * q + 2]);
      const float p2 = __fmul_rn(p, p);
      // p2 > NaN is false, so a NaN best is never replaced
      if (p2 > best || (isnan(p2) && !isnan(best))) {
        best = p2;
        best_q = q;
      }
    }
    const float d2 = __fsub_rn(dot3(n0, n1, n2, n0, n1, n2), best);
    niche[s * m + j] = best_q;
    dist[s * m + j] = sqrtf(d2 < 0.0f ? 0.0f : d2);
  }
}

}  // namespace

cudaError_t launch_associate(const float* f, const float* dirs,
                             const float* ideal, const float* nadir,
                             int64_t* niche, float* dist, int n_states, int m,
                             int r, cudaStream_t stream) {
  if (n_states == 0 || m == 0) return cudaSuccess;
  if (n_states < 0 || m < 0 || r <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * r;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        associate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  associate_kernel<<<n_states, kThreads, smem, stream>>>(
      f, dirs, ideal, nadir, niche, dist, m, r);
  return cudaGetLastError();
}
