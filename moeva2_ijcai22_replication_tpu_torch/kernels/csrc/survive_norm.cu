// K4a: survival normalisation, one thread block per state.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// survival.py::_survive_pre after its peel: the ideal and worst updates,
// _update_extreme_points, _nadir_point (with _solve3) and _unit_ref_dirs.
// The repo has no Pallas kernel for it.
//
// Semantics: those of attacks/moeva/survival.py::survive_norm_plain.
// - ideal / worst: the running points against the column min / max of f and
//   of the aspiration points; min and max propagate NaN, as torch.minimum,
//   amin and amax do (CUDA's fminf / fmaxf alone would drop it);
// - extreme point i: the candidate of [previous extremes, front-0 rows (other
//   rows 1e16), aspiration points] with the least ASF max_k(shift_k * w_ik),
//   shift = row - ideal snapped to 0 below 1e-3, w = 1 on the axis and 1e6
//   off it; like torch.argmin, the first NaN wins, else the first minimum;
// - nadir: Cramer's rule in the plain version's order, the fallbacks of
//   _nadir_point;
// - directions: the aspiration points scaled by ideal and nadir, projected
//   on the simplex and clipped to the octant, then the 3 axes.
// Sums of 3 run left to right and every operation is one rounded float32
// operation (__fadd_rn / __fmul_rn / __fdiv_rn: no FMA contraction).
// Constants are the float32 roundings of the plain version's doubles.
//
// Design: the threads split the M + A + 3 candidate rows between them and
// reduce the column min/max and the three argmins through shared memory;
// one thread then solves the 3x3 system, and the threads write the R
// directions. The work is a few dozen operations per candidate row on 16
// bytes read per row: bound by bytes in principle, by launch latency at the
// main path's shapes.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// true when (v, i) comes before (bv, bi) for torch.argmin: NaN first, then
// the smaller value, ties to the smaller index; bi < 0 is "none yet"
__device__ __forceinline__ bool argmin_before(float v, int i, float bv,
                                              int bi) {
  if (bi < 0) return true;
  if (isnan(bv)) return isnan(v) && i < bi;
  if (isnan(v)) return true;
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ float sub_mul(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

__global__ void __launch_bounds__(kThreads)
survive_norm_kernel(const float* __restrict__ f,
                    const int32_t* __restrict__ ranks,
                    const float* __restrict__ asp,
                    const float* __restrict__ ideal_in,
                    const float* __restrict__ worst_in,
                    const float* __restrict__ extreme_in,
                    float* __restrict__ ideal_out,
                    float* __restrict__ worst_out,
                    float* __restrict__ extreme_out,
                    float* __restrict__ nadir_out, float* __restrict__ dirs,
                    int m, int a) {
  // per-thread partials: column min, max, front max of f; aspiration min,
  // max; the three argmins
  __shared__ float red[kThreads][15];
  __shared__ int red_i[kThreads][3];
  __shared__ float ideal[3], worst[3], nadir[3];
  __shared__ int best[3];
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* fs = f + s * m * 3;
  const int32_t* rs = ranks + s * m;
  const float big = static_cast<float>(1e16);

  float mn[3], mx[3], wf[3], amn[3], amx[3];
  for (int k = 0; k < 3; ++k) {
    mn[k] = INFINITY;
    mx[k] = -INFINITY;
    wf[k] = -INFINITY;
    amn[k] = INFINITY;
    amx[k] = -INFINITY;
  }
  for (int j = tid; j < m; j += nt) {
    const bool front = rs[j] == 0;
    for (int k = 0; k < 3; ++k) {
      const float v = fs[3 * j + k];
      mn[k] = nan_min(mn[k], v);
      mx[k] = nan_max(mx[k], v);
      if (front) wf[k] = nan_max(wf[k], v);
    }
  }
  for (int q = tid; q < a; q += nt) {
    for (int k = 0; k < 3; ++k) {
      amn[k] = nan_min(amn[k], asp[3 * q + k]);
      amx[k] = nan_max(amx[k], asp[3 * q + k]);
    }
  }
  for (int k = 0; k < 3; ++k) {
    red[tid][k] = mn[k];
    red[tid][3 + k] = mx[k];
    red[tid][6 + k] = wf[k];
    red[tid][9 + k] = amn[k];
    red[tid][12 + k] = amx[k];
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 1; t < nt; ++t) {
      for (int k = 0; k < 3; ++k) {
        red[0][k] = nan_min(red[0][k], red[t][k]);
        red[0][3 + k] = nan_max(red[0][3 + k], red[t][3 + k]);
        red[0][6 + k] = nan_max(red[0][6 + k], red[t][6 + k]);
        red[0][9 + k] = nan_min(red[0][9 + k], red[t][9 + k]);
        red[0][12 + k] = nan_max(red[0][12 + k], red[t][12 + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      ideal[k] = nan_min(ideal_in[s * 3 + k], nan_min(red[0][k], red[0][9 + k]));
      worst[k] = nan_max(worst_in[s * 3 + k], nan_max(red[0][3 + k], red[0][12 + k]));
    }
  }
  __syncthreads();
  // worst of the population and of the front, kept for the nadir fallbacks
  float wop[3], wof[3];
  for (int k = 0; k < 3; ++k) {
    wop[k] = red[0][3 + k];
    wof[k] = red[0][6 + k];
  }
  __syncthreads();

  // extreme points: argmin over the candidate rows of each axis's ASF
  const float snap = static_cast<float>(1e-3);
  const float off_axis = static_cast<float>(1e6);
  float bv[3];
  int bi[3] = {-1, -1, -1};
  const int n_cand = 3 + m + a;
  for (int c = tid; c < n_cand; c += nt) {
    float row[3];
    for (int k = 0; k < 3; ++k) {
      if (c < 3)
        row[k] = extreme_in[(s * 3 + c) * 3 + k];
      else if (c < 3 + m)
        row[k] = rs[c - 3] == 0 ? fs[3 * (c - 3) + k] : big;
      else
        row[k] = asp[3 * (c - 3 - m) + k];
      const float sh = __fsub_rn(row[k], ideal[k]);
      row[k] = sh < snap ? 0.0f : sh;
    }
    for (int i = 0; i < 3; ++i) {
      float asf = 0.0f;
      for (int k = 0; k < 3; ++k) {
        const float v = __fmul_rn(row[k], k == i ? 1.0f : off_axis);
        asf = k == 0 ? v : nan_max(asf, v);
      }
      if (argmin_before(asf, c, bv[i], bi[i])) {
        bv[i] = asf;
        bi[i] = c;
      }
    }
  }
  for (int i = 0; i < 3; ++i) {
    red[tid][i] = bv[i];
    red_i[tid][i] = bi[i];
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      float v = red[0][i];
      int vi = red_i[0][i];
      for (int t = 1; t < nt; ++t)
        if (red_i[t][i] >= 0 && argmin_before(red[t][i], red_i[t][i], v, vi)) {
          v = red[t][i];
          vi = red_i[t][i];
        }
      best[i] = vi;
    }

    // the extreme rows, the hyperplane and the nadir (_nadir_point)
    float ext[3][3], e[3][3];
    for (int i = 0; i < 3; ++i) {
      const int c = best[i];
      for (int k = 0; k < 3; ++k) {
        if (c < 3)
          ext[i][k] = extreme_in[(s * 3 + c) * 3 + k];
        else if (c < 3 + m)
          ext[i][k] = rs[c - 3] == 0 ? fs[3 * (c - 3) + k] : big;
        else
          ext[i][k] = asp[3 * (c - 3 - m) + k];
        extreme_out[(s * 3 + i) * 3 + k] = ext[i][k];
        e[i][k] = __fsub_rn(ext[i][k], ideal[k]);
      }
    }
    const float det = __fadd_rn(
        __fsub_rn(__fmul_rn(e[0][0], sub_mul(e[1][1], e[2][2], e[1][2], e[2][1])),
                  __fmul_rn(e[0][1], sub_mul(e[1][0], e[2][2], e[1][2], e[2][0]))),
        __fmul_rn(e[0][2], sub_mul(e[1][0], e[2][1], e[1][1], e[2][0])));
    const float adj[3][3] = {
        {sub_mul(e[1][1], e[2][2], e[1][2], e[2][1]),
         sub_mul(e[0][2], e[2][1], e[0][1], e[2][2]),
         sub_mul(e[0][1], e[1][2], e[0][2], e[1][1])},
        {sub_mul(e[1][2], e[2][0], e[1][0], e[2][2]),
         sub_mul(e[0][0], e[2][2], e[0][2], e[2][0]),
         sub_mul(e[0][2], e[1][0], e[0][0], e[1][2])},
        {sub_mul(e[1][0], e[2][1], e[1][1], e[2][0]),
         sub_mul(e[0][1], e[2][0], e[0][0], e[2][1]),
         sub_mul(e[0][0], e[1][1], e[0][1], e[1][0])},
    };
    float plane[3], nad[3];
    bool ok = true;
    const float res_tol = static_cast<float>(1e-8 + 1e-5);
    const float tiny = static_cast<float>(1e-6);
    for (int i = 0; i < 3; ++i)
      plane[i] = __fdiv_rn(sum3(adj[i][0], adj[i][1], adj[i][2]), det);
    for (int i = 0; i < 3; ++i) {
      const float icpt = __fdiv_rn(1.0f, plane[i]);
      nad[i] = nan_min(__fadd_rn(ideal[i], icpt), worst[i]);
      const float res = sum3(__fmul_rn(e[i][0], plane[0]), __fmul_rn(e[i][1], plane[1]),
                             __fmul_rn(e[i][2], plane[2]));
      ok = ok && isfinite(plane[i]) && fabsf(__fsub_rn(res, 1.0f)) <= res_tol &&
           icpt > tiny && isfinite(nad[i]);
    }
    for (int k = 0; k < 3; ++k) {
      float v = ok ? nad[k] : wof[k];
      if (__fsub_rn(v, ideal[k]) <= tiny) v = wop[k];
      nadir[k] = v;
      nadir_out[s * 3 + k] = v;
      ideal_out[s * 3 + k] = ideal[k];
      worst_out[s * 3 + k] = worst[k];
    }
  }
  __syncthreads();

  // directions (_unit_ref_dirs): the aspiration points, then the axes
  float den[3];
  for (int k = 0; k < 3; ++k) {
    const float dk = __fsub_rn(nadir[k], ideal[k]);
    den[k] = dk == 0.0f ? static_cast<float>(1e-12) : dk;
  }
  float* ds = dirs + s * (a + 3) * 3;
  for (int q = tid; q < a + 3; q += nt) {
    float out[3];
    if (q < a) {
      float unit[3], proj[3], clip[3];
      for (int k = 0; k < 3; ++k)
        unit[k] = __fdiv_rn(__fsub_rn(asp[3 * q + k], ideal[k]), den[k]);
      const float tot = sum3(unit[0], unit[1], unit[2]);
      const float t = tot == 0.0f ? 1.0f : tot;
      bool needs_clip = false;
      for (int k = 0; k < 3; ++k) {
        proj[k] = __fdiv_rn(unit[k], t);
        needs_clip = needs_clip || proj[k] <= 0.0f;
        clip[k] = isnan(proj[k]) ? proj[k] : fmaxf(proj[k], 0.0f);
      }
      const float csum = sum3(clip[0], clip[1], clip[2]);
      const float cs = csum == 0.0f ? 1.0f : csum;
      for (int k = 0; k < 3; ++k)
        out[k] = needs_clip ? __fdiv_rn(clip[k], cs) : proj[k];
    } else {
      for (int k = 0; k < 3; ++k) out[k] = k == q - a ? 1.0f : 0.0f;
    }
    for (int k = 0; k < 3; ++k) ds[3 * q + k] = out[k];
  }
}

}  // namespace

cudaError_t launch_survive_norm(const float* f, const int32_t* ranks,
                                const float* asp, const float* ideal_in,
                                const float* worst_in, const float* extreme_in,
                                float* ideal, float* worst, float* extreme,
                                float* nadir, float* dirs, int n_states, int m,
                                int a, cudaStream_t stream) {
  if (n_states == 0) return cudaSuccess;
  if (n_states < 0 || m <= 0 || a < 0) return cudaErrorInvalidValue;
  survive_norm_kernel<<<n_states, kThreads, 0, stream>>>(
      f, ranks, asp, ideal_in, worst_in, extreme_in, ideal, worst, extreme,
      nadir, dirs, m, a);
  return cudaGetLastError();
}
