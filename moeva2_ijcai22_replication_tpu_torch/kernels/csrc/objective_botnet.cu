// K8: MoEvA2's objectives on the botnet domain (756 features, 360 gathered
// constraint terms), one block of eight warps per tile of 32 (state,
// candidate) rows; an instantiation of its own (kXorTerms) takes the
// augmented botnet domain (756 + P features, the 360 terms and P XOR
// consistency terms; 927 features and 531 terms at P = 171).
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// engine.py::Moeva2._evaluate on the botnet domain, with what it calls:
// core/codec.py::genetic_to_ml and minmax_normalize, the ML scaler,
// models/mlp.py::MLP and softmax, core/norms.py::lp_distance and
// domains/botnet.py::BotnetConstraints._raw (tables from _build_tables)
// thresholded by core/constraints.py::ConstraintSet.evaluate. The repo has no
// Pallas kernel for it.
//
// Semantics: those of attacks/moeva/engine.py::evaluate_plain with
// domains/botnet.py::BotnetConstraints, one rounded float32 operation at a
// time in their order (__fadd_rn / __fmul_rn / __fdiv_rn, so nvcc cannot
// contract them into FMAs), as K1 (objective_lcld.cu) does for LCLD:
// - decode: feature d takes gene feat_gene[d] (feat_onehot[d] < 0), the
//   one-hot bit rintf(gene) == feat_onehot[d], or the initial state's value
//   (feat_gene[d] < 0);
// - f2: the left-to-right sum of squared min-max differences, a correctly
//   rounded sqrtf, over float32(sqrt(D)); L-inf: the NaN-propagating max of
//   the absolute differences;
// - the scaler, then the relu stack: each unit starts from its bias and adds
//   w[k] * a[k] for k = 0, 1, ... in turn; a NaN passes relu;
// - softmax: exp(l - max) in float64 rounded once over the left-to-right
//   sum; a 1-column head gives [1 - p, p] with p = 1 / (1 + exp(-l));
// - g: the terms in BotnetConstraints._raw's order, read through the gather
//   lists (launch arguments, so the real feat_idx.pickle runs through the
//   same kernel): per direction |Σ flows - Σ bytes| (each sum left to
//   right), the bytes/pkts ratios (p != 0 ? b / p : 0) - 1500, then the
//   three orderings lower - upper; on the augmented domain
//   (domains/botnet.py::BotnetAugmentedConstraints) then the P pair terms
//   |x[d - P + p] - xor(x[i] >= t_i, x[j] >= t_j)| in itertools.combinations
//   order (a NaN compares false; the thresholds rounded once to float32);
//   each kept where > tol and 0 elsewhere (a NaN term counts 0), summed left
//   to right.
//
// Bound: the relu stack, 756-64-64-32-2, is 54,592 multiply-adds per row on
// ~3 KB of genes: bound by fp32 operations. Tensor cores are not used:
// mma/wgmma sum inside the instruction in an order that no CPU code
// reproduces. Without FMA a multiply-add is two instructions, so the
// kernel's ceiling is half the fp32 peak.
//
// Design. The first version of this kernel spent 68% of a block's cycles
// on one thread per row: the tile's decode (lanes over rows, so each warp
// load touched 32 rows), then the 756 steps of the min-max distance and the
// terms, each a chain of global loads, in front of a barrier that the other
// warps waited at (its K8_STAMPS breakdown, PERF.md). Here every warp does
// the same mix of work, so the four SM sub-partitions share it evenly
// (splits into warp roles were slower, PERF.md):
// 0. the gather lists go to shared memory as 16-bit features; the decode: a
//    warp takes 4 rows, its lanes consecutive features, so the genes are
//    read coalesced, 8 features deep; the unscaled features go to shared
//    memory, [k][row] with the row XOR-swizzled by k, so that lanes over
//    features and lanes over rows both hit 32 banks;
// 1. the violations, in rounds of the ring's size (it is free until the
//    first layer starts): each warp computes its share of the round's
//    terms for all rows, a row per lane, kept where > tol, into the ring;
//    then warp 0 adds them to its rows' sums in order;
// 2. the first layer, chunk by chunk through a double buffer, one barrier
//    per chunk. A thread sums 4 rows x 2 outputs in registers, k in order,
//    one float4 load of its rows' a[k] and one float2 load of its outputs'
//    w[k][o] per 8 multiply-adds. Meanwhile every thread stages two
//    (feature, row) entries of the next chunk: its scaled input and the
//    square (L-inf: the absolute value) of its min-max difference with its
//    IEEE division, the loads issued before the chunk's sums and finished
//    after them; the chunk's weights are cp.async copies from a transposed
//    copy (in, out), one contiguous run. One warp in turn adds the staged
//    chunk's squares to its rows' distance chains, k in order, the running
//    value in shared memory between chunks;
// 3. the other layers from the tile's buffer (dead by then), each layer's
//    weights copied there first to [k][o] with an odd row stride (the
//    copy's stores and the sums' loads hit distinct banks); relu on the
//    write-back; warp 0 takes the softmax and writes the objectives.
// A block takes 112.5 KB of shared memory at 756 features, so two run on an
// SM; 16 warps an SM keep the fp32 pipes and the shared-memory pipe busy
// where fatter register tiles with fewer warps did not (PERF.md).
//
// The augmented domain (kXorTerms): the same code over d = 756 + P
// features, the pair tables ((P, 2) 16-bit features and float32
// thresholds) staged in shared memory beside the gather lists, and the
// pair terms computed after the 360 in the same rounds, a (term, row) per
// lane. At 927 features the tile alone is 118.7 KB and a block about
// 139 KB, so one block (8 warps) runs on an SM: half the base's
// occupancy, kept as it is until a redesign (PERF.md). At kXorTerms =
// false the pair count is the constant 0 and the base's code is unchanged.
//
// The history (kHistory, either domain): MoEvA's save_history="full"
// records each evaluation's objectives and kept terms
// (attacks/moeva/engine.py::Moeva2._evaluate_hist of the JAX package, the
// plain version's evaluate_hist_plain). Each round of terms is in the ring
// before warp 0 sums it; after the round's barrier the warps copy it to the
// (S * N, 3 + n_terms) record, a row per warp and consecutive terms per
// lane, so the stores are coalesced; warp 0 adds each row's objectives at
// columns 0-2 where it writes out. No shared memory is added. The record's
// bytes (363 floats a row on botnet) are the extra bound; at kHistory =
// false the copy is compiled out.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kTile = 32;                   // rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = kTile / 4;       // a thread sums 4 rows
constexpr int kChunk = 16;                  // first-layer inputs per staged chunk
constexpr int kStageEntries = kChunk * kTile;
constexpr int kDecodeBatch = 8;             // features per lane with their loads in flight

// a thread's two staged entries of a chunk, loaded before the current
// chunk's sums and finished after them
struct Staged {
  float v[2], scale[2], offset[2], lo[2], hi[2], mm[2];
};

__device__ __forceinline__ float relu_if(bool hidden, float x) {
  return hidden && !(x > 0.0f) && !isnan(x) ? 0.0f : x;
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// floats of the tile's features, which later hold the two activation
// buffers and one deeper layer's weights
__host__ __device__ __forceinline__ size_t botnet_xf_floats(int d) {
  const size_t xf = static_cast<size_t>(d) * kTile;
  const size_t later = 2 * static_cast<size_t>(kBotnetMaxWidth) * kTile + kBotnetMaxWidth * (kBotnetMaxWidth + 1);
  return xf > later ? xf : later;
}

// the entries of the gather lists
__host__ __device__ __forceinline__ int botnet_entries(const int (&counts)[kBotnetSegments]) {
  int n = 0;
  for (int k = 0; k < kBotnetSegments; ++k) n += counts[k];
  return n;
}

// feature k of row r in the tile's [k][row] buffer, the row XOR-swizzled
__device__ __forceinline__ int at(int k, int r) { return k * kTile + (r ^ (k & (kTile - 1))); }

// tools/probe_objective_botnet.py's breakdown (built with K8_STAMPS): per
// warp of block 0 and phase, the clock64() cycles its lane 0 sees, summed
// over the chunks in registers and written once at the end: the decode, the
// staging of the next chunk (the loads' issue, then the rest after the
// sums), the distance turns, the terms, the sums, the barrier, the deeper
// layers, the softmax, and the whole block. A phase that follows a barrier
// also holds the barrier's wait: the warp blocks at its first instruction
// after BAR.SYNC.DEFER_BLOCKING
constexpr int kPhases = 10;
#ifdef K8_STAMPS
__device__ unsigned long long k8_cycles[kWarps][kPhases];
#endif

struct Stamps {
#ifdef K8_STAMPS
  long long start, last, cycles[kPhases];
#endif
  __device__ __forceinline__ void begin() {
#ifdef K8_STAMPS
    start = last = clock64();
    for (int i = 0; i < kPhases; ++i) cycles[i] = 0;
#endif
  }
  // adds the cycles since the previous stamp to phase i
  __device__ __forceinline__ void operator()(int i) {
#ifdef K8_STAMPS
    const long long now = clock64();
    cycles[i] += now - last;
    last = now;
#endif
  }
  __device__ __forceinline__ void flush(bool on, int warp) {
#ifdef K8_STAMPS
    cycles[kPhases - 1] = clock64() - start;
    if (on)
      for (int i = 0; i < kPhases; ++i) k8_cycles[warp][i] += cycles[i];
#endif
  }
};

// acc[i][j] += a[k][row 4rg + i] * w[k][o0 + j] over k < n, in k order; `a`
// points at a [k][kTile] buffer's row group, `w` at w[0][o0] in shared
// memory with rows of `w_stride` floats: one float2 load per k (`kPair`,
// w_stride and o0 even) or two loads, the second where `two`.
template <bool kPair>
__device__ __forceinline__ void dense_steps(float (&acc)[4][2], const float* __restrict__ a,
                                            const float* __restrict__ w, int w_stride, int n,
                                            bool two) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kTile);
    float w0, w1;
    if constexpr (kPair) {
      const float2 wv = *reinterpret_cast<const float2*>(w + k * w_stride);
      w0 = wv.x;
      w1 = wv.y;
    } else {
      w0 = w[k * w_stride];
      w1 = two ? w[k * w_stride + 1] : 0.0f;
    }
    acc[0][0] = __fadd_rn(acc[0][0], __fmul_rn(av.x, w0));
    acc[1][0] = __fadd_rn(acc[1][0], __fmul_rn(av.y, w0));
    acc[2][0] = __fadd_rn(acc[2][0], __fmul_rn(av.z, w0));
    acc[3][0] = __fadd_rn(acc[3][0], __fmul_rn(av.w, w0));
    acc[0][1] = __fadd_rn(acc[0][1], __fmul_rn(av.x, w1));
    acc[1][1] = __fadd_rn(acc[1][1], __fmul_rn(av.y, w1));
    acc[2][1] = __fadd_rn(acc[2][1], __fmul_rn(av.z, w1));
    acc[3][1] = __fadd_rn(acc[3][1], __fmul_rn(av.w, w1));
  }
}

// Writes outputs o0 (and o0 + 1 where `two`) of 4 rows to h[o][row].
__device__ __forceinline__ void write_back(float* h, const float (&acc)[4][2], int o0, int r,
                                           bool two, bool hidden) {
  for (int j = 0; j < (two ? 2 : 1); ++j) {
    float4 v;
    v.x = relu_if(hidden, acc[0][j]);
    v.y = relu_if(hidden, acc[1][j]);
    v.z = relu_if(hidden, acc[2][j]);
    v.w = relu_if(hidden, acc[3][j]);
    *reinterpret_cast<float4*>(h + (o0 + j) * kTile + r) = v;
  }
}

// Term t (unthresholded) of row r in BotnetConstraints._raw's order, read
// from the tile's features `xf` through the gather lists `idx` (staged in
// shared memory): per direction |Σ flows - Σ bytes|, each sum left to
// right; the ratios (p != 0 ? b / p : 0) - 1500; the three orderings
// lower - upper.
__device__ __forceinline__ float term_value(const BotnetObjectiveArgs& a, const float* xf, const int16_t* idx, int r,
                                            int t) {
  const int* c = a.counts;
  auto x = [&](int e) { return xf[at(idx[e], r)]; };
  auto sum = [&](int e, int n) {
    float s = x(e);
#pragma unroll 4
    for (int i = 1; i < n; ++i) s = __fadd_rn(s, x(e + i));
    return s;
  };
  if (t < 2) {
    const int e = t == 0 ? 0 : c[0] + c[1];
    return fabsf(__fsub_rn(sum(e, c[2 * t]), sum(e + c[2 * t], c[2 * t + 1])));
  }
  const int n_ratio = c[4];
  int e = c[0] + c[1] + c[2] + c[3];
  if (t < 2 + n_ratio) {
    const float b = x(e + t - 2);
    const float p = x(e + n_ratio + t - 2);
    return __fsub_rn(p != 0.0f ? __fdiv_rn(b, p) : 0.0f, 1500.0f);
  }
  int first = 2 + n_ratio;
  e += 2 * n_ratio;
  for (int o = 0; o < 3; ++o) {
    const int n = c[6 + 2 * o];
    if (t < first + n) return __fsub_rn(x(e + t - first), x(e + n + t - first));
    first += n;
    e += 2 * n;
  }
  return 0.0f;
}

// Pair term p (unthresholded) of row r of the augmented domain, read from
// the tile's features `xf` through the pair tables `pidx` and `pthr`
// (staged in shared memory): |x[d - P + p] - xor(x[i] >= t_i, x[j] >= t_j)|,
// a NaN comparing false.
__device__ __forceinline__ float pair_term(const float* xf, const int16_t* pidx, const float* pthr, int d,
                                           int n_pairs, int r, int p) {
  const bool a = xf[at(pidx[2 * p], r)] >= pthr[2 * p];
  const bool b = xf[at(pidx[2 * p + 1], r)] >= pthr[2 * p + 1];
  return fabsf(__fsub_rn(xf[at(d - n_pairs + p, r)], a != b ? 1.0f : 0.0f));
}

template <bool kXorTerms, bool kHistory>
__global__ void __launch_bounds__(kThreads, 2)
objective_botnet_kernel(const BotnetObjectiveArgs args) {
  extern __shared__ __align__(16) float smem[];
  const int d = args.d;
  const int h1 = args.widths[1];
  const int n_pairs = kXorTerms ? args.n_pairs : 0;
  float* xf = smem;                                   // (d, kTile) unscaled features, swizzled
  float* ring = xf + botnet_xf_floats(d);             // 2 stages: inputs, squares, weights
  float* dist_run = ring + 2 * kChunk * (2 * kTile + h1);  // (kTile,) the distance chains
  float* g_run = dist_run + kTile;                          // (kTile,) the violation chains
  float* pthr = g_run + kTile;                              // (n_pairs, 2) the pairs' thresholds
  int16_t* sidx = reinterpret_cast<int16_t*>(pthr + 2 * n_pairs);  // the gather lists' features
  // (n_pairs, 2) the pairs' features, after the gather lists
  int16_t* pidx = kXorTerms ? sidx + botnet_entries(args.counts) : nullptr;
  float* ha = xf;                                     // after the first layer, two
  float* hb = xf + kBotnetMaxWidth * kTile;           // (kBotnetMaxWidth, kTile) buffers
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * kTile;
  const int rows = args.n_rows - row0 < kTile ? args.n_rows - row0 : kTile;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  const bool scaled = args.scale != nullptr;
  Stamps stamp;
  stamp.begin();

  auto chunk_size = [&](int c) { return d - c * kChunk < kChunk ? d - c * kChunk : kChunk; };
  auto stage = [&](int c) { return ring + (c & 1) * kChunk * (2 * kTile + h1); };
  // chunk c's first-layer weights, as 16-byte copies into its stage
  auto stage_weights = [&](int c) {
    const float* src = args.first_t + static_cast<size_t>(c) * kChunk * h1;
    float* dst = stage(c) + 2 * kStageEntries;
    for (int e = tid; e < chunk_size(c) * h1 / 4; e += kThreads) copy16_async(dst + 4 * e, src + 4 * e);
    copy_commit();
  };
  // chunk c's scaled inputs and the squares (L-inf: absolute values) of its
  // min-max differences, entries (k % 16 = warp, warp + 8; row = lane):
  // stage_load issues their loads, stage_store finishes them after the
  // current chunk's sums have covered the loads' latency
  const size_t so = static_cast<size_t>((lane < rows ? row0 + lane : row0) / args.n) * d;
  const float* lo = args.xl + so;
  const float* hi = args.xu + so;
  const float* mm = args.x_init_mm + so;
  auto stage_load = [&](int c, Staged& e) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = warp + j * kWarps;
      if (kk < chunk_size(c)) {
        const int k = c * kChunk + kk;
        e.v[j] = xf[at(k, lane)];
        e.scale[j] = scaled ? __ldg(args.scale + k) : 1.0f;
        e.offset[j] = scaled ? __ldg(args.offset + k) : 0.0f;
        e.lo[j] = __ldg(lo + k);
        e.hi[j] = __ldg(hi + k);
        e.mm[j] = __ldg(mm + k);
      }
    }
  };
  auto stage_store = [&](int c, const Staged& e) {
    float* xs = stage(c);
    float* sq = xs + kStageEntries;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = warp + j * kWarps;
      if (kk < chunk_size(c)) {
        const float v = e.v[j];
        xs[kk * kTile + lane] = scaled ? __fadd_rn(__fmul_rn(v, e.scale[j]), e.offset[j]) : v;
        const float rng = __fsub_rn(e.hi[j], e.lo[j]);
        const float diff = __fsub_rn(__fdiv_rn(__fsub_rn(v, e.lo[j]), rng == 0.0f ? 1.0f : rng), e.mm[j]);
        sq[kk * kTile + lane] = args.norm_inf ? fabsf(diff) : __fmul_rn(diff, diff);
      }
    }
  };
  for (int e = tid; e < botnet_entries(args.counts); e += kThreads) sidx[e] = static_cast<int16_t>(__ldg(args.cons + e));
  if constexpr (kXorTerms) {
    for (int e = tid; e < 2 * n_pairs; e += kThreads) {
      pidx[e] = static_cast<int16_t>(__ldg(args.pair_idx + e));
      pthr[e] = __ldg(args.pair_thr + e);
    }
  }

  // 0. decode: warp w takes rows w, w + 8, ...; its lanes consecutive
  // features, kDecodeBatch of them per lane with their loads in flight
  for (int k0 = lane; k0 < d; k0 += 32 * kDecodeBatch) {
    int gene[kDecodeBatch], slot[kDecodeBatch];
    float gv[kDecodeBatch][kTile / kWarps];
#pragma unroll
    for (int u = 0; u < kDecodeBatch; ++u) {
      const int k = k0 + 32 * u;
      gene[u] = k < d ? __ldg(args.feat_gene + k) : 0;
      slot[u] = k < d ? __ldg(args.feat_onehot + k) : -1;
    }
#pragma unroll
    for (int u = 0; u < kDecodeBatch; ++u)
#pragma unroll
      for (int i = 0; i < kTile / kWarps; ++i) {
        const int r = warp + i * kWarps;
        gv[u][i] = k0 + 32 * u < d && r < rows
                       ? __ldg(args.x_gen + static_cast<size_t>(row0 + r) * args.l + (gene[u] < 0 ? 0 : gene[u]))
                       : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < kDecodeBatch; ++u) {
      const int k = k0 + 32 * u;
      if (k < d) {
#pragma unroll
        for (int i = 0; i < kTile / kWarps; ++i) {
          const int r = warp + i * kWarps;
          float v = 0.0f;
          if (r < rows)
            v = gene[u] < 0 ? __ldg(args.x_init + static_cast<size_t>((row0 + r) / args.n) * d + k)
                : slot[u] < 0 ? gv[u][i]
                              : (rintf(gv[u][i]) == static_cast<float>(slot[u]) ? 1.0f : 0.0f);
          xf[at(k, r)] = v;
        }
      }
    }
  }
  __syncthreads();
  stamp(0);

  // 1. the violations: in rounds of the ring's size (free until the first
  // layer starts), each warp computes its share of the terms of all rows
  // (a row per lane), kept where > tol, into the ring; then warp 0 adds
  // them in order to its rows' sums. The pair terms follow the 360
  {
    const int n_base = 2 + args.counts[4] + args.counts[6] + args.counts[8] + args.counts[10];
    const int n_terms = n_base + n_pairs;
    const int per_round = 2 * kChunk * (2 * kTile + h1) / kTile;
    float* kept = ring;
    [[maybe_unused]] const int rec_cols = 3 + n_terms;
    for (int t0 = 0; t0 < n_terms; t0 += per_round) {
      const int t1 = n_terms - t0 < per_round ? n_terms : t0 + per_round;
      for (int t = t0 + warp; t < t1; t += kWarps) {
        float v;
        if constexpr (kXorTerms)
          v = t < n_base ? term_value(args, xf, sidx, lane, t)
                         : pair_term(xf, pidx, pthr, d, n_pairs, lane, t - n_base);
        else
          v = term_value(args, xf, sidx, lane, t);
        kept[(t - t0) * kTile + lane] = v > args.tol ? v : 0.0f;
      }
      __syncthreads();
      if constexpr (kHistory) {
        // the round's kept terms to the rows' records, coalesced: a warp
        // takes a row, its lanes consecutive terms (the ring's reads of one
        // row all hit one bank)
        for (int r = warp; r < rows; r += kWarps) {
          float* rec = args.record + static_cast<size_t>(row0 + r) * rec_cols + 3;
          for (int t = t0 + lane; t < t1; t += 32) rec[t] = kept[(t - t0) * kTile + r];
        }
      }
      if (warp == 0) {
        float g = t0 == 0 ? kept[lane] : g_run[lane];
        for (int t = t0 == 0 ? 1 : t0; t < t1; ++t) g = __fadd_rn(g, kept[(t - t0) * kTile + lane]);
        g_run[lane] = g;
      }
      __syncthreads();
    }
  }
  stamp(4);
  stage_weights(0);
  {
    Staged e;
    stage_load(0, e);
    stage_store(0, e);
  }
  copy_wait_all();
  __syncthreads();
  stamp(1);

  // 2. the first layer, chunk by chunk; this thread's rows rg .. rg + 3 and
  // outputs o0, o0 + 1
  const int rg = (tid % kRowGroups) * 4;
  const int o0 = (tid / kRowGroups) * 2;
  float acc[4][2];
  const float* bias = args.params + static_cast<size_t>(h1) * d;
  for (int j = 0; j < 2; ++j) {
    const float b = o0 < h1 ? __ldg(bias + o0 + j) : 0.0f;
    for (int i = 0; i < 4; ++i) acc[i][j] = b;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const float* xs = stage(c);
    Staged next;
    if (c + 1 < n_chunks) {
      stage_weights(c + 1);
      stage_load(c + 1, next);
    }
    stamp(1);
    if (warp == c % kWarps) {
      // chunk c's squares onto the distance chains, k in order
      const float* sq = xs + kStageEntries;
      float dist = c == 0 ? sq[lane] : dist_run[lane];
      for (int kk = c == 0 ? 1 : 0; kk < chunk_size(c); ++kk) {
        const float v = sq[kk * kTile + lane];
        dist = args.norm_inf ? nan_max(dist, v) : __fadd_rn(dist, v);
      }
      dist_run[lane] = dist;
      stamp(3);
    }
    if (o0 < h1)
      dense_steps<true>(acc, xs + rg, xs + 2 * kStageEntries + o0, h1, chunk_size(c), true);
    stamp(5);
    if (c + 1 < n_chunks) stage_store(c + 1, next);
    stamp(2);
    copy_wait_all();
    __syncthreads();
    stamp(6);
  }
  // the features are dead (the last chunk was staged before the barrier
  // above): their buffer takes the activations and, a layer at a time, the
  // deeper layers' weights

  // 3. the other layers, ha -> hb -> ha ...; each layer's weights copied
  // from the params (out, in) to wt[k][o] with an odd row stride, so that
  // the copy's stores (consecutive k) and the sums' loads hit distinct banks
  if (o0 < h1) write_back(ha, acc, o0, rg, true, true);
  float* a = ha;
  float* h = hb;
  float* wt = xf + 2 * kBotnetMaxWidth * kTile;
  const float* wp = bias + h1;
  for (int layer = 1; layer < args.n_layers; ++layer) {
    const int in_w = args.widths[layer];
    const int out_w = args.widths[layer + 1];
    const int ws = out_w | 1;
    const float* lb = wp + out_w * in_w;
    for (int e = tid; e < out_w * in_w; e += kThreads) wt[(e % in_w) * ws + e / in_w] = __ldg(wp + e);
    __syncthreads();
    if (o0 < out_w) {
      const bool two = o0 + 1 < out_w;
      for (int j = 0; j < 2; ++j) {
        const float b = j == 0 || two ? __ldg(lb + o0 + j) : 0.0f;
        for (int i = 0; i < 4; ++i) acc[i][j] = b;
      }
      dense_steps<false>(acc, a + rg, wt + o0, ws, in_w, two);
      write_back(h, acc, o0, rg, two, layer + 1 < args.n_layers);
    }
    __syncthreads();
    wp = lb + out_w;
    float* t = a;
    a = h;
    h = t;
  }
  stamp(7);

  // class probabilities and the objectives, a row per lane of warp 0; the
  // logits are in a
  if (warp == 0 && lane < rows) {
    const int row = row0 + lane;
    float p0, p1;
    if (args.widths[args.n_layers] == 1) {
      const float e = __double2float_rn(exp(-static_cast<double>(a[lane])));
      p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
      p0 = __fsub_rn(1.0f, p1);
    } else {
      const float l0 = a[lane];
      const float l1 = a[kTile + lane];
      const float mx = nan_max(l0, l1);
      const float e0 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l0, mx))));
      const float e1 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l1, mx))));
      const float sum = __fadd_rn(e0, e1);
      p0 = __fdiv_rn(e0, sum);
      p1 = __fdiv_rn(e1, sum);
    }
    const float dist = dist_run[lane];
    const float f[3] = {args.min_class[row / args.n] == 0 ? p0 : p1,
                        __fdiv_rn(args.norm_inf ? dist : __fsqrt_rn(dist), args.f2_scale), g_run[lane]};
    float* out = args.out + 3 * static_cast<size_t>(row);
    out[0] = f[0];
    out[1] = f[1];
    out[2] = f[2];
    if constexpr (kHistory) {
      const int n_terms = 2 + args.counts[4] + args.counts[6] + args.counts[8] + args.counts[10] + n_pairs;
      float* rec = args.record + static_cast<size_t>(row) * (3 + n_terms);
      rec[0] = f[0];
      rec[1] = f[1];
      rec[2] = f[2];
    }
  }
  stamp(8);
  stamp.flush(blockIdx.x == 0 && lane == 0, warp);
}

// shared bytes of one block: the tile's features (later the two activation
// buffers), the double buffer of inputs, squares and first-layer weights,
// the rows' running distance and violation sums, and the gather lists and
// pair tables
size_t botnet_smem(int d, int h1, int n_entries, int n_pairs) {
  return sizeof(float) * (botnet_xf_floats(d) + 2 * static_cast<size_t>(kChunk) * (2 * kTile + h1) + 2 * kTile +
                          2 * static_cast<size_t>(n_pairs)) +
         sizeof(int16_t) * (static_cast<size_t>(n_entries) + 2 * static_cast<size_t>(n_pairs));
}

template <bool kXorTerms, bool kHistory>
cudaError_t launch_tiles(const BotnetObjectiveArgs& args, size_t smem, cudaStream_t stream) {
  static LaunchCache cache;
  const cudaError_t err = cache.prepare(
      reinterpret_cast<const void*>(objective_botnet_kernel<kXorTerms, kHistory>), kThreads, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (args.n_rows + kTile - 1) / kTile;
  objective_botnet_kernel<kXorTerms, kHistory><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

int objective_botnet_max_features(int h1, int n_entries, int n_pairs) {
  // the largest d whose buffers fit one block, as the launcher sizes them
  int d = 0;
  while (botnet_smem(d + 1, h1, n_entries, n_pairs) <= kMaxSharedBytes) ++d;
  return d;
}

cudaError_t launch_objective_botnet(BotnetObjectiveArgs args, cudaStream_t stream) {
  if (args.n_rows == 0) return cudaSuccess;
  if (args.n_rows < 0 || args.n <= 0 || args.l <= 0 || args.d <= 0 || args.n_layers < 2 ||
      args.n_layers > kObjectiveMaxLayers || args.widths[0] != args.d)
    return cudaErrorInvalidValue;
  for (int k = 1; k <= args.n_layers; ++k)
    if (args.widths[k] < 1 || args.widths[k] > kBotnetMaxWidth) return cudaErrorInvalidValue;
  if (args.widths[1] % 4 != 0 || args.widths[args.n_layers] > 2) return cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k)
    if (args.counts[k] < 1) return cudaErrorInvalidValue;
  for (int k = 4; k < kBotnetSegments; k += 2)
    if (args.counts[k] < 0 || args.counts[k + 1] != args.counts[k]) return cudaErrorInvalidValue;
  // the augmented domain: its P pairs' features are a row's last P, after
  // botnet's 756 (16-bit feature indices in shared memory)
  if (args.n_pairs < 0 || args.n_pairs > kBotnetMaxPairs ||
      (args.n_pairs > 0 && (args.d != kBotnetFeatures + args.n_pairs || args.pair_idx == nullptr ||
                            args.pair_thr == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = botnet_smem(args.d, args.widths[1], botnet_entries(args.counts), args.n_pairs);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (args.record != nullptr)
    return args.n_pairs > 0 ? launch_tiles<true, true>(args, smem, stream) : launch_tiles<false, true>(args, smem, stream);
  return args.n_pairs > 0 ? launch_tiles<true, false>(args, smem, stream)
                          : launch_tiles<false, false>(args, smem, stream);
}

#ifdef K8_STAMPS
extern "C" const char* k8_phase_names() {
  return "decode;stage issue;stage finish;distance turn;terms;first layer sum;barrier;deeper layers;softmax;block";
}

// the warps whose stamps k8_take_cycles returns, each kPhases values
extern "C" int k8_stamped_warps() { return kWarps; }

// copies K8's per-warp, per-phase cycles to `out` and zeroes them
extern "C" int k8_take_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k8_cycles, sizeof(k8_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[kWarps][kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k8_cycles, zero, sizeof(zero)));
}
#endif
