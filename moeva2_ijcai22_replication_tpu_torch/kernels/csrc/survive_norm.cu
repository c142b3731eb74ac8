// K4a: survival normalisation, one warp per state, four states per block.
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
// Bound: 16 bytes read per candidate row and a few dozen operations on it,
// so bytes in principle; at the main path's shapes (M = 203, 1000 states)
// the launch and each state's chain of dependent steps set the time.
//
// Design: a state's chain is short when no step of it waits on device
// memory, on another thread or on a branch.
// - One warp per state, four states per block. Each lane first issues
//   asynchronous copies (cp.async) of its share of the state's f, ranks,
//   previous extremes, ideal and worst into shared memory, and the block
//   copies the aspiration points once: every load of the kernel is in
//   flight at once, and no later step reads device memory.
// - Every reduction is a butterfly of __shfl_xor_sync: the column min / max
//   (NaN first) and the three argmins under argmin_before's total order
//   give the same result in any order, so the butterfly is bit for bit.
//   Every lane ends with the result, so no lane waits for another.
// - Every lane then solves the 3x3 system itself, on the same values in the
//   same order: no barrier, no broadcast; lane 0 writes the state's points.
// - The aspiration points' column min / max is the same for every state:
//   the block takes it once, beside its copies, before its warps part.
// - The lanes write the state's R direction rows.
// - min / max with NaN are single instructions and the argmin test has no
//   branch: written as `isnan(a) ? a : ...`, each compiled to a divergent
//   branch, and the kernel took 1.7 times as long on the H100 (PERF.md).
// One block of four warps per state, each thread taking a quarter of a
// warp's rows and joining the warps through shared memory, took 1.2 times
// as long as this layout (PERF.md).

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kWarp = 32;
constexpr int kStates = 4;  // states (warps) per block
constexpr int kThreads = kWarp * kStates;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v = nan_min(v, __shfl_xor_sync(kFullMask, v, d));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v = nan_max(v, __shfl_xor_sync(kFullMask, v, d));
  return v;
}

// true when (v, i) comes before (bv, bi) for torch.argmin: NaN first, then
// the smaller value, ties to the smaller index; bi < 0 is "none yet".
// Written without branches (bitwise | and &).
__device__ __forceinline__ bool argmin_before(float v, int i, float bv,
                                              int bi) {
  const bool v_nan = isnan(v), bv_nan = isnan(bv);
  return (bi < 0) | (v_nan & (!bv_nan | (i < bi))) |
         (!bv_nan & ((v < bv) | ((v == bv) & (i < bi))));
}

// The index of the warp's first (v, i) under argmin_before; i < 0 is none.
__device__ __forceinline__ int warp_argmin(float v, int i) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, d);
    const int oi = __shfl_xor_sync(kFullMask, i, d);
    const bool take = (oi >= 0) & argmin_before(ov, oi, v, i);
    v = take ? ov : v;
    i = take ? oi : i;
  }
  return i;
}

__device__ __forceinline__ float sub_mul(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

// Copies 4 bytes from device memory to shared memory without holding a
// register; done for this thread after copy_async_wait().
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of one block: the aspiration points, then per warp its
// state's candidate rows [3 previous extremes, M rows of f], the previous
// ideal and worst, and the ranks.
__host__ __device__ constexpr int norm_warp_floats(int m) { return 3 * (3 + m) + 6 + m; }

__global__ void __launch_bounds__(kThreads)
survive_norm_kernel(const float* __restrict__ pop, const float* __restrict__ off,
                    const int32_t* __restrict__ ranks,
                    const float* __restrict__ asp,
                    const float* __restrict__ ideal_in,
                    const float* __restrict__ worst_in,
                    const float* __restrict__ extreme_in,
                    float* __restrict__ ideal_out,
                    float* __restrict__ worst_out,
                    float* __restrict__ extreme_out,
                    float* __restrict__ nadir_out, float* __restrict__ dirs,
                    int n_states, int m, int p, int a) {
  extern __shared__ float staged[];
  __shared__ float asp_part[kStates][6];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const size_t s = static_cast<size_t>(blockIdx.x) * kStates + warp;
  const bool active = s < static_cast<size_t>(n_states);
  float* asp_s = staged;                                       // (a, 3)
  float* rows = staged + 3 * a + warp * norm_warp_floats(m);   // (3 + m, 3)
  float* points = rows + 3 * (3 + m);                          // ideal, worst
  int32_t* rk = reinterpret_cast<int32_t*>(points + 6);        // (m,)

  // the state's inputs, every copy in flight at once
  if (active) {
    // the merged rows [pop, off] of the state (merged_row)
    const float* ps = pop + s * p * 3;
    const float* os = off + s * (m - p) * 3;
    for (int i = lane; i < 3 * m; i += kWarp) copy_async(rows + 9 + i, i < 3 * p ? ps + i : os + (i - 3 * p));
    for (int j = lane; j < m; j += kWarp) copy_async(rk + j, ranks + s * m + j);
    if (lane < 9) copy_async(rows + lane, extreme_in + s * 9 + lane);
    if (lane < 3) copy_async(points + lane, ideal_in + s * 3 + lane);
    if (lane < 3) copy_async(points + 3 + lane, worst_in + s * 3 + lane);
  }
  // the aspiration points, staged and reduced once per block
  float amn[3], amx[3];
  for (int k = 0; k < 3; ++k) {
    amn[k] = INFINITY;
    amx[k] = -INFINITY;
  }
  for (int q = threadIdx.x; q < a; q += kThreads) {
    for (int k = 0; k < 3; ++k) {
      const float v = asp[3 * q + k];
      asp_s[3 * q + k] = v;
      amn[k] = nan_min(amn[k], v);
      amx[k] = nan_max(amx[k], v);
    }
  }
  for (int k = 0; k < 3; ++k) {
    amn[k] = warp_min(amn[k]);
    amx[k] = warp_max(amx[k]);
  }
  if (lane == 0) {
    for (int k = 0; k < 3; ++k) {
      asp_part[warp][k] = amn[k];
      asp_part[warp][3 + k] = amx[k];
    }
  }
  copy_async_wait();
  __syncthreads();
  for (int w = 0; w < kStates; ++w) {
    for (int k = 0; k < 3; ++k) {
      amn[k] = w == 0 ? asp_part[0][k] : nan_min(amn[k], asp_part[w][k]);
      amx[k] = w == 0 ? asp_part[0][3 + k] : nan_max(amx[k], asp_part[w][3 + k]);
    }
  }
  if (!active) return;
  const float big = static_cast<float>(1e16);

  // column min and max of f, max of the front; rows off the front become
  // 1e16 in place
  float mn[3], mx[3], wf[3];
  for (int k = 0; k < 3; ++k) {
    mn[k] = INFINITY;
    mx[k] = -INFINITY;
    wf[k] = -INFINITY;
  }
  for (int j = lane; j < m; j += kWarp) {
    const bool front = rk[j] == 0;
    float* row = rows + 9 + 3 * j;
    for (int k = 0; k < 3; ++k) {
      const float v = row[k];
      mn[k] = nan_min(mn[k], v);
      mx[k] = nan_max(mx[k], v);
      wf[k] = front ? nan_max(wf[k], v) : wf[k];
      row[k] = front ? v : big;
    }
  }
  float ideal[3], worst[3];
  for (int k = 0; k < 3; ++k) {
    mn[k] = warp_min(mn[k]);
    mx[k] = warp_max(mx[k]);  // worst of the population (nadir fallback)
    wf[k] = warp_max(wf[k]);  // worst of the front (nadir fallback)
    ideal[k] = nan_min(points[k], nan_min(mn[k], amn[k]));
    worst[k] = nan_max(points[3 + k], nan_max(mx[k], amx[k]));
  }
  __syncwarp();

  // candidate c of [previous extremes, rows, aspiration points]
  auto cand = [&](int c) { return c < 3 + m ? rows + 3 * c : asp_s + 3 * (c - 3 - m); };

  // extreme points: argmin over the candidates of each axis's ASF
  const float snap = static_cast<float>(1e-3);
  const float off_axis = static_cast<float>(1e6);
  float bv[3] = {0.0f, 0.0f, 0.0f};
  int bi[3] = {-1, -1, -1};
  const int n_cand = 3 + m + a;
  for (int c = lane; c < n_cand; c += kWarp) {
    float row[3];
    for (int k = 0; k < 3; ++k) {
      const float sh = __fsub_rn(cand(c)[k], ideal[k]);
      row[k] = sh < snap ? 0.0f : sh;
    }
    for (int i = 0; i < 3; ++i) {
      float asf = 0.0f;
      for (int k = 0; k < 3; ++k) {
        const float v = __fmul_rn(row[k], k == i ? 1.0f : off_axis);
        asf = k == 0 ? v : nan_max(asf, v);
      }
      const bool take = argmin_before(asf, c, bv[i], bi[i]);
      bv[i] = take ? asf : bv[i];
      bi[i] = take ? c : bi[i];
    }
  }

  // the extreme rows, the hyperplane and the nadir (_nadir_point), on
  // every lane
  float ext[3][3], e[3][3];
  for (int i = 0; i < 3; ++i) {
    const float* c = cand(warp_argmin(bv[i], bi[i]));
    for (int k = 0; k < 3; ++k) {
      ext[i][k] = c[k];
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
  float plane[3], nad[3], nadir[3];
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
    float v = ok ? nad[k] : wf[k];
    if (__fsub_rn(v, ideal[k]) <= tiny) v = mx[k];
    nadir[k] = v;
  }
  if (lane == 0) {
    for (int k = 0; k < 3; ++k) {
      for (int i = 0; i < 3; ++i) extreme_out[(s * 3 + i) * 3 + k] = ext[i][k];
      nadir_out[s * 3 + k] = nadir[k];
      ideal_out[s * 3 + k] = ideal[k];
      worst_out[s * 3 + k] = worst[k];
    }
  }

  // directions (_unit_ref_dirs): the aspiration points, then the axes
  float den[3];
  for (int k = 0; k < 3; ++k) {
    const float dk = __fsub_rn(nadir[k], ideal[k]);
    den[k] = dk == 0.0f ? static_cast<float>(1e-12) : dk;
  }
  float* ds = dirs + s * (a + 3) * 3;
  for (int q = lane; q < a + 3; q += kWarp) {
    float out[3];
    if (q < a) {
      float unit[3], proj[3], clip[3];
      for (int k = 0; k < 3; ++k)
        unit[k] = __fdiv_rn(__fsub_rn(asp_s[3 * q + k], ideal[k]), den[k]);
      const float tot = sum3(unit[0], unit[1], unit[2]);
      const float t = tot == 0.0f ? 1.0f : tot;
      bool needs_clip = false;
      for (int k = 0; k < 3; ++k) {
        proj[k] = __fdiv_rn(unit[k], t);
        needs_clip = needs_clip || proj[k] <= 0.0f;
        clip[k] = nan_max(proj[k], 0.0f);
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

cudaError_t launch_survive_norm(const float* pop, const float* off, const int32_t* ranks,
                                const float* asp, const float* ideal_in,
                                const float* worst_in, const float* extreme_in,
                                float* ideal, float* worst, float* extreme,
                                float* nadir, float* dirs, int n_states, int m, int p,
                                int a, cudaStream_t stream) {
  if (n_states == 0) return cudaSuccess;
  if (n_states < 0 || m <= 0 || m > kSurviveMaxCandidates || p < 0 || p > m || a < 0 ||
      a + 3 > kSurviveMaxCandidates)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * a + kStates * norm_warp_floats(m));
  static LaunchCache cache;
  const cudaError_t err = cache.prepare(
      reinterpret_cast<const void*>(survive_norm_kernel), kThreads, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (n_states + kStates - 1) / kStates;
  survive_norm_kernel<<<grid, kThreads, smem, stream>>>(
      pop, off, ranks, asp, ideal_in, worst_in, extreme_in, ideal, worst, extreme,
      nadir, dirs, n_states, m, p, a);
  return cudaGetLastError();
}
