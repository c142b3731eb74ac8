// K4b: the niching fill, the survivor extraction and the archive update,
// one thread block per state.
//
// Replaces the jnp device stages moeva2_ijcai22_replication_tpu/attacks/
// moeva/survival.py::_survive_post and _niching_fill, and the tail of
// engine.py gen_step: the stable survivors-first extraction and
// _archive_select. The repo has no Pallas kernel for them.
//
// Semantics: those of survival.py::survive_fill_plain and engine.py::
// extract_archive_plain / archive_select_plain, on integers and comparisons
// only (no rounding):
// - fill: cum_le from a histogram of the ranks (a rank is in [0, M) or
//   UNRANKED, as nd_peel gives it); fronts whose cumulative count fits
//   n_survive survive whole; the 18-step integer bisection of the water
//   level over the niches of the splitting front; the cutoff cohort by
//   counting strictly greater gum_cut (equal priorities get equal places);
//   the closest member of each niche by torch.argmin (first NaN, else first
//   minimum, index 0 when every value is inf); the rest by counting
//   strictly smaller pick keys within the niche;
// - extraction: the survivors, then the others, each in index order, of
//   [population, offspring] (read through two pointers); the first P rows
//   are the next population;
// - archive: the candidates [a rows, b rows] ranked by archive_score, with a
//   candidate's place the number of candidates before it in a stable
//   ascending sort with NaN last (-0.0 == 0.0); the first n_arch places.
// The archive alone (no fill) serves the archive seeding of the initial
// population.
//
// Design: the state's ranks, niches, distances and priorities sit in shared
// memory; the quadratic counts (niche ranks, cutoff places, archive places)
// run one thread per row over the shared arrays. The work is O(M^2 + R*M +
// C^2) comparisons per state on ~20 bytes per candidate: bound by
// operations in principle, by launch latency and the serial bisection at the
// main path's shapes.

#include <climits>
#include <cmath>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kFill = 1;
constexpr int kExtract = 2;
constexpr int kArchive = 4;

struct Scalars {
  int split_rank;
  int n_full;
  int acc;
};

__device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ float archive_score(const float* fc) {
  const float g = fc[2];
  return g > 0.0f ? __fadd_rn(2.0f, __fdiv_rn(g, __fadd_rn(1.0f, g)))
                  : __fadd_rn(fc[0], __fmul_rn(static_cast<float>(1e-3), fc[1]));
}

__global__ void __launch_bounds__(kThreads)
survive_fill_kernel(SurviveFillArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m = args.m;
  const int r = args.r;
  __shared__ Scalars sc;

  // shared layout: M-sized arrays, R-sized arrays, then the archive's
  size_t at = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = smem + at;
    at += align16(bytes);
    return p;
  };
  int* rk = reinterpret_cast<int*>(take(sizeof(int) * m));
  int* ni = reinterpret_cast<int*>(take(sizeof(int) * m));
  float* ds = reinterpret_cast<float*>(take(sizeof(float) * m));
  float* key = reinterpret_cast<float*>(take(sizeof(float) * m));
  int* dest = reinterpret_cast<int*>(take(sizeof(int) * m));
  int* hist = reinterpret_cast<int*>(take(sizeof(int) * (m + 1)));
  unsigned char* full = take(m);
  unsigned char* avail = take(m);
  unsigned char* closest = take(m);
  unsigned char* msk = take(m);
  int* c0 = reinterpret_cast<int*>(take(sizeof(int) * r));
  int* cap = reinterpret_cast<int*>(take(sizeof(int) * r));
  int* quota = reinterpret_cast<int*>(take(sizeof(int) * r));
  float* pri = reinterpret_cast<float*>(take(sizeof(float) * r));
  unsigned char* elig = take(r);
  const int n_cand = args.n_a + args.n_b;
  float* score = reinterpret_cast<float*>(take(sizeof(float) * n_cand));
  int* elite = reinterpret_cast<int*>(take(sizeof(int) * args.n_arch));

  if (args.flags & kFill) {
    const int n_survive = args.n_survive;
    for (int j = tid; j < m; j += nt) {
      rk[j] = args.ranks[s * m + j];
      ni[j] = static_cast<int>(args.niche[s * m + j]);
      ds[j] = args.dist[s * m + j];
      closest[j] = 0;
    }
    for (int b = tid; b <= m; b += nt) hist[b] = 0;
    for (int q = tid; q < r; q += nt) {
      c0[q] = 0;
      cap[q] = 0;
    }
    if (tid == 0) {
      sc.split_rank = INT_MAX;
      sc.n_full = 0;
    }
    __syncthreads();
    // cum_le[j] = #{i: rank_i <= rank_j}; UNRANKED counts every row
    for (int j = tid; j < m; j += nt)
      atomicAdd(&hist[rk[j] >= 0 && rk[j] < m ? rk[j] : m], 1);
    __syncthreads();
    if (tid == 0)
      for (int b = 1; b <= m; ++b) hist[b] += hist[b - 1];
    __syncthreads();
    for (int j = tid; j < m; j += nt) {
      const bool f = hist[rk[j] >= 0 && rk[j] < m ? rk[j] : m] <= n_survive;
      full[j] = f;
      if (f) {
        atomicAdd(&sc.n_full, 1);
        atomicAdd(&c0[ni[j]], 1);
      } else {
        atomicMin(&sc.split_rank, rk[j]);
      }
    }
    __syncthreads();
    const int split_rank = sc.split_rank;
    const int n_remaining = n_survive - sc.n_full > 0 ? n_survive - sc.n_full : 0;
    for (int j = tid; j < m; j += nt) {
      avail[j] = rk[j] == split_rank;
      if (avail[j]) atomicAdd(&cap[ni[j]], 1);
    }

    // the largest integer water level whose fill fits n_remaining
    int lo = 0;
    int hi = m + n_survive + 1;
    for (int it = 0; it < 18; ++it) {
      const int mid = (lo + hi + 1) / 2;
      __syncthreads();
      if (tid == 0) sc.acc = 0;
      __syncthreads();
      int part = 0;
      for (int q = tid; q < r; q += nt) {
        const int v = mid - c0[q] > 0 ? mid - c0[q] : 0;
        part += v < cap[q] ? v : cap[q];
      }
      atomicAdd(&sc.acc, part);
      __syncthreads();
      const bool ok = sc.acc <= n_remaining;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid - 1;
    }
    const int level = lo;
    __syncthreads();
    if (tid == 0) sc.acc = 0;
    __syncthreads();
    int part = 0;
    for (int q = tid; q < r; q += nt) {
      const int v = level - c0[q] > 0 ? level - c0[q] : 0;
      quota[q] = v < cap[q] ? v : cap[q];
      part += quota[q];
    }
    atomicAdd(&sc.acc, part);
    __syncthreads();
    // the cutoff cohort: niches at the level with spare members take the
    // remaining units by gum_cut priority
    const int rem = n_remaining - sc.acc;
    for (int q = tid; q < r; q += nt) {
      elig[q] = quota[q] < cap[q] && c0[q] + quota[q] == level;
      pri[q] = elig[q] ? args.gum_cut[s * r + q] : -INFINITY;
    }
    __syncthreads();
    for (int q = tid; q < r; q += nt) {
      if (!elig[q]) continue;
      int place = 0;
      for (int q2 = 0; q2 < r; ++q2) place += pri[q2] > pri[q];
      if (place < rem) quota[q] += 1;
    }
    // the closest available member of each niche that starts empty goes
    // first
    for (int q = tid; q < r; q += nt) {
      if (!(c0[q] == 0 && cap[q] > 0)) continue;
      int bi = 0;
      float bv = ni[0] == q && avail[0] ? ds[0] : INFINITY;
      for (int j = 1; j < m && !isnan(bv); ++j) {
        const float v = ni[j] == q && avail[j] ? ds[j] : INFINITY;
        if (isnan(v) || v < bv) {
          bv = v;
          bi = j;
        }
      }
      closest[bi] = 1;
    }
    __syncthreads();
    for (int j = tid; j < m; j += nt)
      key[j] = closest[j] && avail[j] ? -INFINITY : args.gum_mem[s * m + j];
    __syncthreads();
    for (int j = tid; j < m; j += nt) {
      bool taken = false;
      if (avail[j]) {
        int place = 0;
        for (int i = 0; i < m; ++i)
          place += ni[i] == ni[j] && avail[i] && key[i] < key[j];
        taken = place < quota[ni[j]];
      }
      msk[j] = full[j] || taken;
      args.mask[s * m + j] = msk[j];
    }
    __syncthreads();
  }

  if (args.flags & kExtract) {
    // survivors first, then the others, each in index order
    if (tid == 0) {
      int n_true = 0;
      for (int j = 0; j < m; ++j)
        if (msk[j]) dest[j] = n_true++;
      int n_false = 0;
      for (int j = 0; j < m; ++j)
        if (!msk[j]) dest[j] = n_true + n_false++;
    }
    __syncthreads();
    const int p = args.p;
    const int n_off = m - p;
    const int l = args.l;
    for (int e = tid; e < m * l; e += nt) {
      const int j = e / l;
      const int k = e % l;
      if (dest[j] >= p) continue;
      const float v = j < p ? args.pop_x[(s * p + j) * l + k]
                            : args.off_x[(s * n_off + j - p) * l + k];
      args.new_x[(s * p + dest[j]) * l + k] = v;
    }
    for (int e = tid; e < m * 3; e += nt) {
      const int j = e / 3;
      const int k = e % 3;
      if (dest[j] >= p) continue;
      const float v = j < p ? args.pop_f[(s * p + j) * 3 + k]
                            : args.off_f[(s * n_off + j - p) * 3 + k];
      args.new_f[(s * p + dest[j]) * 3 + k] = v;
    }
  }

  if (args.flags & kArchive) {
    const int n_a = args.n_a;
    const int n_b = args.n_b;
    const int l = args.l;
    for (int c = tid; c < n_cand; c += nt)
      score[c] = archive_score(c < n_a ? args.a_f + (s * n_a + c) * 3
                                       : args.b_f + (s * n_b + c - n_a) * 3);
    __syncthreads();
    for (int c = tid; c < n_cand; c += nt) {
      const float v = score[c];
      const bool v_nan = isnan(v);
      int place = 0;
      for (int c2 = 0; c2 < n_cand; ++c2) {
        const float w = score[c2];
        const bool w_nan = isnan(w);
        place += (w < v) || (v_nan && !w_nan) ||
                 ((w == v || (v_nan && w_nan)) && c2 < c);
      }
      if (place < args.n_arch) elite[place] = c;
    }
    __syncthreads();
    const int n_arch = args.n_arch;
    for (int e = tid; e < n_arch * l; e += nt) {
      const int q = e / l;
      const int k = e % l;
      const int c = elite[q];
      args.arch_x[(s * n_arch + q) * l + k] =
          c < n_a ? args.a_x[(s * n_a + c) * l + k]
                  : args.b_x[(s * n_b + c - n_a) * l + k];
    }
    for (int e = tid; e < n_arch * 3; e += nt) {
      const int q = e / 3;
      const int k = e % 3;
      const int c = elite[q];
      args.arch_f[(s * n_arch + q) * 3 + k] =
          c < n_a ? args.a_f[(s * n_a + c) * 3 + k]
                  : args.b_f[(s * n_b + c - n_a) * 3 + k];
    }
  }
}

size_t shared_bytes(int m, int r, int n_cand, int n_arch) {
  auto a16 = [](size_t b) { return (b + 15) & ~static_cast<size_t>(15); };
  return 5 * a16(sizeof(int) * m) + a16(sizeof(int) * (m + 1)) + 4 * a16(m) +
         4 * a16(sizeof(int) * r) + a16(r) + a16(sizeof(float) * n_cand) +
         a16(sizeof(int) * n_arch);
}

}  // namespace

cudaError_t launch_survive_fill(const SurviveFillArgs& args,
                                cudaStream_t stream) {
  if (args.n_states == 0) return cudaSuccess;
  const bool fill = args.flags & kFill;
  const int m = fill ? args.m : 0;
  const int r = fill ? args.r : 0;
  const bool archive = args.flags & kArchive;
  if (args.n_states < 0 || m > kSurviveMaxCandidates || r > kSurviveMaxCandidates ||
      (fill && (m <= 0 || r <= 0)) || ((args.flags & kExtract) && !fill) ||
      (archive && (args.n_arch < 0 || args.n_arch > args.n_a + args.n_b ||
                   args.n_a + args.n_b > 2 * kSurviveMaxCandidates)))
    return cudaErrorInvalidValue;
  SurviveFillArgs a = args;
  a.m = m;
  a.r = r;
  if (!archive) a.n_a = a.n_b = a.n_arch = 0;
  const size_t smem = shared_bytes(m, r, a.n_a + a.n_b, a.n_arch);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        survive_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  survive_fill_kernel<<<a.n_states, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}
