// K3: niche association. Each thread takes kCand candidates of one state
// and scans the state's directions for all of them; a block holds one or
// more states.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// survival.py::associate_batch (and its blocked form _associate_blocked).
// The repo's one Pallas kernel computed this stage; it was removed in
// 608a48b after it crashed the TPU worker at 537-544 states.
//
// Semantics (those of associate_plain): denom = nadir - ideal with 0
// replaced by 1e-12; n = (f - ideal) / denom; d_r = dirs_r / |dirs_r|;
// niche = first argmax over r of (n . d_r)^2; dist = sqrt(max(|n|^2 - best,
// 0)), NaN passing through. argmax counts NaN as the largest value: the
// first NaN projection wins and nothing replaces it. Such rows are real: an
// inf objective (a ratio constraint whose denominator a mutation set to 0)
// under a finite nadir gives inf * 0 = NaN on the axis directions and inf
// elsewhere.
//
// Every product and sum is written with __fmul_rn / __fadd_rn in the order
// n0*d0 + n1*d1 + n2*d2, so nvcc cannot contract them into FMAs and the
// rounding is that of the plain formula evaluated left to right.
//
// Bound: 6 float32 operations per (candidate, direction) pair on 28 input
// bytes per candidate, so operations; with the argmax the card issues about
// 9 instructions per pair, and issue binds the direction loop. Design:
// - No branch in the direction loop. A group of kUnroll directions is
//   reduced by a tree of max.NaN; best = max.NaN(best, group max), and the
//   group's first index is kept where that changes best's bits. That is the
//   first-index, NaN-largest argmax over groups exactly: p2 is +0 or more,
//   or NaN, and best starts at -inf; a tie leaves the bits as they are;
//   max.NaN returns the canonical NaN, so a later NaN changes nothing.
//   After the loop the winning group is scanned again, last to first, for
//   the first direction that gives best: the same operations give the same
//   bits. So one compare and select serve kUnroll pairs. The R % kUnroll
//   last directions are taken one at a time.
// - The state's unit directions are staged once per block in shared memory,
//   padded to 16 bytes: one 128-bit load per direction serves the thread's
//   kCand candidates. R is a run-time argument.
// - Lanes match M: a state takes ceil(M / kCand) threads (at most 512,
//   which then loop), and the launcher packs as many states into a block as
//   keeps the busiest SM's warps fewest (a launch waits for its busiest SM).
// PERF.md has the designs tried (tools/probe_associate.py) and their times.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kCand = 2;        // candidates per thread
constexpr int kMaxStates = 8;   // states per block, at most
constexpr int kUnroll = 4;      // directions per group
constexpr int kMaxThreads = 512;  // threads per block, at most
constexpr size_t kDefaultSharedBytes = 48 * 1024;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__device__ __forceinline__ float proj2(const float (&n)[3], float4 d) {
  const float p = dot3(n[0], n[1], n[2], d.x, d.y, d.z);
  return __fmul_rn(p, p);
}

// best = max.NaN(best, v); idx = q where that changed best's bits
__device__ __forceinline__ void take(float v, int q, float& best, int& idx) {
  const float nb = nan_max(best, v);
  idx = __float_as_uint(nb) != __float_as_uint(best) ? q : idx;
  best = nb;
}

// Directions [q, q + kUnroll) against the thread's candidates: their max
// squared projection is taken with the group's first index q.
__device__ __forceinline__ void group(const float (&n)[kCand][3], const float4* d,
                                     float (&best)[kCand], int (&idx)[kCand],
                                     int q) {
  float4 dq[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) dq[u] = d[q + u];
#pragma unroll
  for (int c = 0; c < kCand; ++c) {
    float p2[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p2[u] = proj2(n[c], dq[u]);
#pragma unroll
    for (int w = 1; w < kUnroll; w *= 2) {
#pragma unroll
      for (int u = 0; u + w < kUnroll; u += 2 * w) p2[u] = nan_max(p2[u], p2[u + w]);
    }
    take(p2[0], q, best[c], idx[c]);
  }
}

// Block b holds states [b * k, b * k + k) (fewer in the last block); each
// takes ts threads.
__global__ void __launch_bounds__(kMaxThreads)
associate_kernel(const float* __restrict__ pop, const float* __restrict__ off, const float* __restrict__ dirs,
                 const float* __restrict__ ideal,
                 const float* __restrict__ nadir, int64_t* __restrict__ niche,
                 float* __restrict__ dist, int n_states, int m, int p, int r, int k,
                 int ts) {
  extern __shared__ float4 ds[];  // (k, r) unit directions
  const int s0 = blockIdx.x * k;
  const int ks = min(k, n_states - s0);
  const float* dg = dirs + static_cast<size_t>(s0) * r * 3;
  for (int i = threadIdx.x; i < ks * r; i += blockDim.x) {
    const float a = dg[3 * i], b = dg[3 * i + 1], c = dg[3 * i + 2];
    const float nrm = sqrtf(dot3(a, b, c, a, b, c));
    ds[i] = make_float4(__fdiv_rn(a, nrm), __fdiv_rn(b, nrm), __fdiv_rn(c, nrm), 0.0f);
  }
  __syncthreads();

  const int ls = threadIdx.x / ts;
  if (ls >= ks) return;
  const size_t s = s0 + ls;
  float id[3], den[3];
  for (int c = 0; c < 3; ++c) {
    id[c] = ideal[s * 3 + c];
    const float dc = __fsub_rn(nadir[s * 3 + c], id[c]);
    den[c] = dc == 0.0f ? 1e-12f : dc;
  }
  const float4* dl = ds + ls * r;
  const int groups = (m + kCand - 1) / kCand;
  // candidate c of group g is g + c * groups: neighbouring threads read and
  // write neighbouring candidates
  for (int g = threadIdx.x - ls * ts; g < groups; g += ts) {
    float n[kCand][3], best[kCand];
    int idx[kCand];
#pragma unroll
    for (int c = 0; c < kCand; ++c) {
      const int j = min(g + c * groups, m - 1);  // past M: a real row, not stored
      const float* fj = merged_row(pop, off, s, j, m, p);
#pragma unroll
      for (int e = 0; e < 3; ++e) n[c][e] = __fdiv_rn(__fsub_rn(fj[e], id[e]), den[e]);
      best[c] = -INFINITY;
      idx[c] = 0;
    }
    const int grouped = r - r % kUnroll;
    for (int q = 0; q < grouped; q += kUnroll) group(n, dl, best, idx, q);
    for (int q = grouped; q < r; ++q) {
#pragma unroll
      for (int c = 0; c < kCand; ++c) take(proj2(n[c], dl[q]), q, best[c], idx[c]);
    }
#pragma unroll
    for (int c = 0; c < kCand; ++c) {
      const int j = g + c * groups;
      if (idx[c] < grouped) {
        // the first direction of the winning group that gives best: the
        // same operations give the same bits, and any NaN matches a NaN
        const int q0 = idx[c];
        for (int u = kUnroll - 1; u >= 0; --u) {
          const float v = proj2(n[c], dl[q0 + u]);
          const bool hit = (__float_as_uint(v) == __float_as_uint(best[c])) | (isnan(v) & isnan(best[c]));
          idx[c] = hit ? q0 + u : idx[c];
        }
      }
      if (j < m) {
        const float d2 = __fsub_rn(dot3(n[c][0], n[c][1], n[c][2], n[c][0], n[c][1], n[c][2]), best[c]);
        niche[s * m + j] = idx[c];
        dist[s * m + j] = sqrtf(d2 < 0.0f ? 0.0f : d2);
      }
    }
  }
}

}  // namespace

cudaError_t launch_associate(const float* pop, const float* off, const float* dirs,
                             const float* ideal, const float* nadir,
                             int64_t* niche, float* dist, int n_states, int m, int p,
                             int r, cudaStream_t stream) {
  if (n_states < 0 || m < 0 || p < 0 || p > m || r <= 0 || r > kAssociateMaxDirections)
    return cudaErrorInvalidValue;
  if (n_states == 0 || m == 0) return cudaSuccess;
  static LaunchCache cache;
  int sms = 0;
  cudaError_t err = cache.sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int groups = (m + kCand - 1) / kCand;
  const int ts = groups < kMaxThreads ? groups : kMaxThreads;
  // the states per block whose busiest SM runs the fewest warps: blocks
  // spread evenly, so the busiest SM runs ceil(blocks / SMs) of them
  int k = 1;
  long best_cost = -1;
  for (int kk = 1; kk <= kMaxStates && kk * ts <= kMaxThreads && kk <= n_states; ++kk) {
    if (kk > 1 && sizeof(float4) * kk * r > kDefaultSharedBytes) break;
    const long blocks = (n_states + kk - 1) / kk;
    const long cost = (blocks + sms - 1) / sms * ((kk * ts + 31) / 32);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      k = kk;
    }
  }
  const int threads = (k * ts + 31) / 32 * 32;
  const size_t smem = sizeof(float4) * k * r;
  err = cache.prepare(reinterpret_cast<const void*>(associate_kernel), threads, smem, nullptr);
  if (err != cudaSuccess) return err;
  associate_kernel<<<(n_states + k - 1) / k, threads, smem, stream>>>(
      pop, off, dirs, ideal, nadir, niche, dist, n_states, m, p, r, k, ts);
  return cudaGetLastError();
}
