// K4b: the niching fill, the survivor extraction and the archive update,
// one group of 128 threads per state, one or four groups per block.
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
// Bound: ~20 bytes per candidate and the survivors' genes; the work is a
// chain of small dependent steps per state, so what sets the time is the
// length of that chain, not bytes or operations.
//
// Design: 1000 states fill the card in one wave, so every step of a
// state's chain is parallel over its group:
// - the rank histogram's prefix, the niches' member offsets and the
//   extraction's destinations are group scans (warp shuffles, one slot per
//   warp);
// - the full-front count and the splitting rank are warp reductions;
// - one warp runs the 18-step bisection alone (__reduce_add_sync over the
//   niches), with no group barrier inside;
// - the available rows are counting-sorted by niche (offsets from the scan,
//   places by atomics: the order within a niche does not matter, since every
//   later use is a count or an argmin with an index tie-break), so each
//   empty niche's closest member and each row's place in its niche scan only
//   that niche's members;
// - the cutoff compares only the eligible niches with each other;
// - the archive keeps the counting rank over its C <= 2048 candidates.
// A group synchronises with its own named barrier, so groups of one block
// run independently; four states per block, where they fit, beat one on the
// H100 (PERF.md).

#include <climits>
#include <cmath>

#include "kernels.h"

namespace {

constexpr int kGroup = 128;  // threads per state
constexpr int kFill = 1;
constexpr int kExtract = 2;
constexpr int kArchive = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// row flags
constexpr unsigned char kIsFull = 1;
constexpr unsigned char kIsAvail = 2;
constexpr unsigned char kIsClosest = 4;
constexpr unsigned char kSurvives = 8;

struct Scalars {
  int split_rank;
  int n_full;
  int quota_sum;
  int n_elig;
  int level;
};

// Byte offsets of one group's arrays in shared memory.
struct FillLayout {
  int bytes;
  int rk, ni, ds, key, hist, memb, scan, order, flag;  // per row
  int c0, cap, quota, start, placed, elig, elig_pri;   // per niche
  int score, elite;                                    // archive
  int warp_sums, scalars;
};

__device__ __forceinline__ float archive_score(const float* fc) {
  const float g = fc[2];
  return g > 0.0f ? __fadd_rn(2.0f, __fdiv_rn(g, __fadd_rn(1.0f, g)))
                  : __fadd_rn(fc[0], __fmul_rn(static_cast<float>(1e-3), fc[1]));
}

struct Group {
  int id;    // the group's index in its block
  int tid;   // the thread's index in the group
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id + 1), "r"(kGroup) : "memory");
  }
  __device__ __forceinline__ int lane() const { return tid & 31; }
  __device__ __forceinline__ int warp() const { return tid >> 5; }
};

// Inclusive prefix sums of data[0, count) in place: each thread sums a
// contiguous chunk, a warp scan and the warps' totals give each chunk its
// start. Ends with a barrier.
__device__ void group_scan(const Group& g, int* data, int count, int* warp_sums) {
  const int per = (count + kGroup - 1) / kGroup;
  const int b = g.tid * per;
  const int e = b + per < count ? b + per : count;
  int sum = 0;
  for (int i = b; i < e; ++i) sum += data[i];
  int x = sum;
#pragma unroll
  for (int dlt = 1; dlt < 32; dlt <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, dlt);
    if (g.lane() >= dlt) x += y;
  }
  if (g.lane() == 31) warp_sums[g.warp()] = x;
  g.sync();
  int run = x - sum;
  for (int w = 0; w < g.warp(); ++w) run += warp_sums[w];
  for (int i = b; i < e; ++i) {
    run += data[i];
    data[i] = run;
  }
  g.sync();
}

// Sum over the group; every thread gets it. Ends with a barrier; ``slot``
// must be 0 before the call and is not reset.
__device__ __forceinline__ int group_sum(const Group& g, int part, int* slot) {
  part = __reduce_add_sync(kFullMask, part);
  if (g.lane() == 0) atomicAdd(slot, part);
  g.sync();
  return *slot;
}

template <int SPB>
__global__ void __launch_bounds__(kGroup * SPB)
survive_fill_kernel(SurviveFillArgs args, FillLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Group g{static_cast<int>(threadIdx.x) / kGroup, static_cast<int>(threadIdx.x) % kGroup};
  const long long s = static_cast<long long>(blockIdx.x) * SPB + g.id;
  if (s >= args.n_states) return;  // a group never waits on another
  unsigned char* base = smem + static_cast<size_t>(g.id) * lay.bytes;
  int* rk = reinterpret_cast<int*>(base + lay.rk);
  int* ni = reinterpret_cast<int*>(base + lay.ni);
  float* ds = reinterpret_cast<float*>(base + lay.ds);
  float* key = reinterpret_cast<float*>(base + lay.key);
  int* hist = reinterpret_cast<int*>(base + lay.hist);
  int* memb = reinterpret_cast<int*>(base + lay.memb);
  int* scan = reinterpret_cast<int*>(base + lay.scan);
  int* order = reinterpret_cast<int*>(base + lay.order);
  unsigned char* flag = base + lay.flag;
  int* c0 = reinterpret_cast<int*>(base + lay.c0);
  int* cap = reinterpret_cast<int*>(base + lay.cap);
  int* quota = reinterpret_cast<int*>(base + lay.quota);
  int* start = reinterpret_cast<int*>(base + lay.start);
  int* placed = reinterpret_cast<int*>(base + lay.placed);
  int* elig = reinterpret_cast<int*>(base + lay.elig);
  float* elig_pri = reinterpret_cast<float*>(base + lay.elig_pri);
  float* score = reinterpret_cast<float*>(base + lay.score);
  int* elite = reinterpret_cast<int*>(base + lay.elite);
  int* warp_sums = reinterpret_cast<int*>(base + lay.warp_sums);
  Scalars* sc = reinterpret_cast<Scalars*>(base + lay.scalars);
  const int t = g.tid;
  const int m = args.m;
  const int r = args.r;

  if (args.flags & kFill) {
    const int n_survive = args.n_survive;
    auto bin = [&](int rank) { return rank >= 0 && rank < m ? rank : m; };
    for (int j = t; j < m; j += kGroup) {
      rk[j] = args.ranks[s * m + j];
      ni[j] = static_cast<int>(args.niche[s * m + j]);
      ds[j] = args.dist[s * m + j];
      flag[j] = 0;
    }
    for (int b = t; b <= m; b += kGroup) hist[b] = 0;
    for (int q = t; q < r; q += kGroup) {
      c0[q] = 0;
      cap[q] = 0;
      placed[q] = 0;
    }
    if (t == 0) *sc = Scalars{INT_MAX, 0, 0, 0, 0};
    g.sync();
    // cum_le[j] = #{i: rank_i <= rank_j}; UNRANKED counts every row
    for (int j = t; j < m; j += kGroup) atomicAdd(&hist[bin(rk[j])], 1);
    g.sync();
    group_scan(g, hist, m + 1, warp_sums);

    // whole fronts; the splitting rank is the least rank left out
    int n_full = 0;
    int split = INT_MAX;
    for (int j = t; j < m; j += kGroup) {
      if (hist[bin(rk[j])] <= n_survive) {
        flag[j] = kIsFull;
        ++n_full;
        atomicAdd(&c0[ni[j]], 1);
      } else {
        split = rk[j] < split ? rk[j] : split;
      }
    }
    n_full = __reduce_add_sync(kFullMask, n_full);
    split = __reduce_min_sync(kFullMask, split);
    if (g.lane() == 0) {
      atomicAdd(&sc->n_full, n_full);
      atomicMin(&sc->split_rank, split);
    }
    g.sync();
    const int split_rank = sc->split_rank;
    const int n_remaining = n_survive - sc->n_full > 0 ? n_survive - sc->n_full : 0;
    for (int j = t; j < m; j += kGroup) {
      if (rk[j] == split_rank) {
        flag[j] |= kIsAvail;
        atomicAdd(&cap[ni[j]], 1);
      }
    }
    g.sync();
    for (int q = t; q < r; q += kGroup) start[q] = cap[q];
    g.sync();
    group_scan(g, start, r, warp_sums);  // start[q] = end of niche q's members
    for (int j = t; j < m; j += kGroup) {
      if (flag[j] & kIsAvail) {
        const int q = ni[j];
        memb[start[q] - cap[q] + atomicAdd(&placed[q], 1)] = j;
      }
    }
    // the largest integer water level whose fill fits n_remaining, by one
    // warp
    if (g.warp() == 0) {
      int lo = 0;
      int hi = m + n_survive + 1;
      for (int it = 0; it < 18; ++it) {
        const int mid = (lo + hi + 1) / 2;
        int part = 0;
        for (int q = g.lane(); q < r; q += 32) {
          const int v = mid - c0[q] > 0 ? mid - c0[q] : 0;
          part += v < cap[q] ? v : cap[q];
        }
        const bool ok = __reduce_add_sync(kFullMask, part) <= n_remaining;
        lo = ok ? mid : lo;
        hi = ok ? hi : mid - 1;
      }
      if (g.lane() == 0) sc->level = lo;
    }
    g.sync();
    const int level = sc->level;
    int part = 0;
    for (int q = t; q < r; q += kGroup) {
      const int v = level - c0[q] > 0 ? level - c0[q] : 0;
      const int qv = v < cap[q] ? v : cap[q];
      quota[q] = qv;
      part += qv;
      // niches at the level with spare members draw the remaining units
      if (qv < cap[q] && c0[q] + qv == level) {
        const int e = atomicAdd(&sc->n_elig, 1);
        elig[e] = q;
        elig_pri[e] = args.gum_cut[s * r + q];
      }
    }
    // the cutoff cohort by gum_cut priority (a non-eligible niche's -inf is
    // never greater, so only the eligible ones are compared)
    const int rem = n_remaining - group_sum(g, part, &sc->quota_sum);
    const int n_elig = sc->n_elig;
    if (rem > 0) {
      for (int e = t; e < n_elig; e += kGroup) {
        const float p = elig_pri[e];
        int place = 0;
        for (int e2 = 0; e2 < n_elig; ++e2) place += elig_pri[e2] > p;
        if (place < rem) quota[elig[e]] += 1;
      }
    }
    // the closest available member of each niche that starts empty goes
    // first: argmin over its members, NaN first, then the least value, the
    // least index on ties; row 0 when every value is inf
    for (int q = t; q < r; q += kGroup) {
      if (!(c0[q] == 0 && cap[q] > 0)) continue;
      int bi = -1;
      float bv = 0.0f;
      for (int u = start[q] - cap[q]; u < start[q]; ++u) {
        const int j = memb[u];
        const float v = ds[j];
        const bool better =
            bi < 0 || (isnan(v) ? !isnan(bv) || j < bi
                                : !isnan(bv) && (v < bv || (v == bv && j < bi)));
        if (better) {
          bi = j;
          bv = v;
        }
      }
      if (bv == INFINITY) bi = 0;
      flag[bi] |= kIsClosest;  // several niches may pick row 0
    }
    g.sync();
    for (int j = t; j < m; j += kGroup) {
      if (flag[j] & kIsAvail)
        key[j] = flag[j] & kIsClosest ? -INFINITY : args.gum_mem[s * m + j];
    }
    g.sync();
    // a member's place in its niche: the members with a smaller key
    for (int j = t; j < m; j += kGroup) {
      bool taken = false;
      if (flag[j] & kIsAvail) {
        const int q = ni[j];
        const float kj = key[j];
        int place = 0;
        for (int u = start[q] - cap[q]; u < start[q]; ++u) place += key[memb[u]] < kj;
        taken = place < quota[q];
      }
      const bool survives = (flag[j] & kIsFull) || taken;
      args.mask[s * m + j] = survives;
      scan[j] = survives;
      if (survives) flag[j] |= kSurvives;
    }
    g.sync();
  }

  if (args.flags & kExtract) {
    // survivors first, then the others, each in index order
    group_scan(g, scan, m, warp_sums);
    const int p = args.p;
    const int n_true = scan[m - 1];
    for (int j = t; j < m; j += kGroup) {
      const int before = scan[j];  // survivors in [0, j]
      const int dest = flag[j] & kSurvives ? before - 1 : n_true + j - before;
      if (dest < p) order[dest] = j;
    }
    g.sync();
    const int n_off = m - p;
    const int l = args.l;
    for (int e = t; e < p * l; e += kGroup) {
      const int q = e / l;
      const int k = e % l;
      const int j = order[q];
      args.new_x[(s * p + q) * l + k] = j < p ? args.pop_x[(s * p + j) * l + k]
                                              : args.off_x[(s * n_off + j - p) * l + k];
    }
    for (int e = t; e < p * 3; e += kGroup) {
      const int q = e / 3;
      const int k = e % 3;
      const int j = order[q];
      args.new_f[(s * p + q) * 3 + k] = j < p ? args.pop_f[(s * p + j) * 3 + k]
                                              : args.off_f[(s * n_off + j - p) * 3 + k];
    }
  }

  if (args.flags & kArchive) {
    const int n_a = args.n_a;
    const int n_b = args.n_b;
    const int n_cand = n_a + n_b;
    const int n_arch = args.n_arch;
    const int l = args.l;
    for (int c = t; c < n_cand; c += kGroup)
      score[c] = archive_score(c < n_a ? args.a_f + (s * n_a + c) * 3
                                       : args.b_f + (s * n_b + c - n_a) * 3);
    g.sync();
    for (int c = t; c < n_cand; c += kGroup) {
      const float v = score[c];
      const bool v_nan = isnan(v);
      int place = 0;
      for (int c2 = 0; c2 < n_cand; ++c2) {
        const float w = score[c2];
        const bool w_nan = isnan(w);
        place += (w < v) || (v_nan && !w_nan) ||
                 ((w == v || (v_nan && w_nan)) && c2 < c);
      }
      if (place < n_arch) elite[place] = c;
    }
    g.sync();
    for (int e = t; e < n_arch * l; e += kGroup) {
      const int q = e / l;
      const int k = e % l;
      const int c = elite[q];
      args.arch_x[(s * n_arch + q) * l + k] =
          c < n_a ? args.a_x[(s * n_a + c) * l + k]
                  : args.b_x[(s * n_b + c - n_a) * l + k];
    }
    for (int e = t; e < n_arch * 3; e += kGroup) {
      const int q = e / 3;
      const int k = e % 3;
      const int c = elite[q];
      args.arch_f[(s * n_arch + q) * 3 + k] =
          c < n_a ? args.a_f[(s * n_a + c) * 3 + k]
                  : args.b_f[(s * n_b + c - n_a) * 3 + k];
    }
  }
}

FillLayout fill_layout(int m, int r, int p, int n_cand, int n_arch) {
  FillLayout lay{};
  int at = 0;
  auto take = [&](size_t bytes) {
    const int off = at;
    at += static_cast<int>((bytes + 15) & ~static_cast<size_t>(15));
    return off;
  };
  lay.rk = take(sizeof(int) * m);
  lay.ni = take(sizeof(int) * m);
  lay.ds = take(sizeof(float) * m);
  lay.key = take(sizeof(float) * m);
  lay.hist = take(sizeof(int) * (m + 1));
  lay.memb = take(sizeof(int) * m);
  lay.scan = take(sizeof(int) * m);
  lay.order = take(sizeof(int) * p);
  lay.flag = take(m);
  lay.c0 = take(sizeof(int) * r);
  lay.cap = take(sizeof(int) * r);
  lay.quota = take(sizeof(int) * r);
  lay.start = take(sizeof(int) * r);
  lay.placed = take(sizeof(int) * r);
  lay.elig = take(sizeof(int) * r);
  lay.elig_pri = take(sizeof(float) * r);
  lay.score = take(sizeof(float) * n_cand);
  lay.elite = take(sizeof(int) * n_arch);
  lay.warp_sums = take(sizeof(int) * 32);
  lay.scalars = take(sizeof(Scalars));
  lay.bytes = at;
  return lay;
}

template <int SPB>
cudaError_t launch_groups(const SurviveFillArgs& a, const FillLayout& lay,
                          cudaStream_t stream) {
  auto kernel = survive_fill_kernel<SPB>;
  const size_t smem = static_cast<size_t>(lay.bytes) * SPB;
  static LaunchCache cache;
  const cudaError_t err =
      cache.prepare(reinterpret_cast<const void*>(kernel), kGroup * SPB, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (a.n_states + SPB - 1) / SPB;
  kernel<<<grid, kGroup * SPB, smem, stream>>>(a, lay);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_survive_fill(const SurviveFillArgs& args, cudaStream_t stream) {
  if (args.n_states == 0) return cudaSuccess;
  const bool fill = args.flags & kFill;
  const bool extract = args.flags & kExtract;
  const int m = fill ? args.m : 0;
  const int r = fill ? args.r : 0;
  const bool archive = args.flags & kArchive;
  if (args.n_states < 0 || m > kSurviveMaxCandidates || r > kSurviveMaxCandidates ||
      (fill && (m <= 0 || r <= 0)) || (extract && (!fill || args.p < 0 || args.p >= m)) ||
      (archive && (args.n_arch < 0 || args.n_arch > args.n_a + args.n_b ||
                   args.n_a + args.n_b > 2 * kSurviveMaxCandidates)))
    return cudaErrorInvalidValue;
  SurviveFillArgs a = args;
  a.m = m;
  a.r = r;
  if (!extract) a.p = 0;
  if (!archive) a.n_a = a.n_b = a.n_arch = 0;
  const FillLayout lay = fill_layout(m, r, a.p, a.n_a + a.n_b, a.n_arch);
  if (static_cast<size_t>(lay.bytes) > kMaxSharedBytes) return cudaErrorInvalidValue;
  // four states per block; one where four states' arrays do not fit a block
  if (static_cast<size_t>(lay.bytes) * 4 <= kMaxSharedBytes)
    return launch_groups<4>(a, lay, stream);
  return launch_groups<1>(a, lay, stream);
}
