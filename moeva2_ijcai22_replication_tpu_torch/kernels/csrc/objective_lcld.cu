// K1: MoEvA2's objectives on the LCLD domain, a persistent grid of blocks
// that each stage the relu stack once and walk over tiles of rows.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// engine.py::Moeva2._evaluate, with what it calls: core/codec.py::
// genetic_to_ml and minmax_normalize, the ML scaler, models/mlp.py::MLP and
// softmax, core/norms.py::lp_distance and domains/lcld.py::
// lcld_constraint_terms thresholded by ConstraintSet.evaluate. The repo has
// no Pallas kernel for it.
//
// Semantics: those of attacks/moeva/engine.py::evaluate_plain, one rounded
// float32 operation at a time in its order (__fadd_rn / __fmul_rn /
// __fdiv_rn, so nvcc cannot contract them into FMAs):
// - decode: feature d takes gene feat_gene[d] (feat_onehot[d] < 0), the
//   one-hot bit rintf(gene) == feat_onehot[d], or the initial state's value
//   (feat_gene[d] < 0);
// - the relu stack: each unit starts from its bias and adds w[k] * a[k] for
//   k = 0, 1, ... in turn; a NaN passes relu;
// - softmax: exp(l - max) in float64 rounded once, over the left-to-right
//   sum; a 1-column head gives [1 - p, p] with p = 1 / (1 + exp(-l));
// - f2: the left-to-right sum of squared min-max differences, a correctly
//   rounded sqrtf, over float32(sqrt(D)); L-inf: the NaN-propagating max of
//   the absolute differences;
// - g: the 10 LCLD terms (pow in float64 rounded once; remainder as
//   PyTorch's fmod-based one), then on the augmented domain
//   (domains/lcld.py::LcldAugmentedConstraints, D = 47 + P) the P pair
//   terms |x[47 + p] - xor(x[i] >= t_i, x[j] >= t_j)| (a NaN compares
//   false; the thresholds rounded once to float32), each kept where > tol
//   and 0 elsewhere (a NaN term counts 0), summed left to right.
// Constants that the plain version writes as Python floats are the float32
// roundings of the same doubles.
//
// Bound: the relu stack is ~5,600 multiply-adds per row (47-64-32-16-2;
// ~6,240 at 57 inputs) on ~110 bytes of genes and 12 of objectives: bound by
// fp32 operations. Tensor
// cores are not used: mma/wgmma sum inside the instruction in an order that
// no CPU code reproduces, and the fixed order is what makes the card equal
// the plain version. Without FMA a multiply-add is two instructions, so the
// kernel's ceiling is half the fp32 peak.
//
// Design: the (state, candidate) rows are flattened into S * N rows and cut
// into tiles of TR = 128 rows. A persistent grid (occupancy x SMs, asked
// once per device and shared memory size) of 2 * TR threads per block
// stages the stack once per block, transposed to [k][o]
// with each layer's outputs padded to a multiple of 8 by zero weights, and
// walks over the tiles; it reads the params in order and writes them
// transposed. Per tile:
// 0. the tile's genes (one contiguous run) and the rows of the states it
//    spans (up to 4) are copied to shared memory, each copy on consecutive
//    addresses (read in place by the threads that use them, they are
//    scattered loads, the largest cost of a tile outside the MLP on the
//    H100);
// 1. decode: every thread handles one row and every other feature, without
//    branches, and writes the unscaled features and the scaled ones (the
//    MLP's input), [k][row], to shared memory;
// 2. the first TR threads sum their row's min-max distance, the other TR
//    its constraint terms, each in the plain version's order;
// 3. each layer is a SIMT tile product: a thread owns 4 rows x OM outputs in
//    registers (OM = 8, 4, 2 or 1 by the layer's width) and runs k in order,
//    one float4 load of its rows' a[k] and OM/4 float4 loads of its
//    outputs' w[k][o] (a warp broadcast) per step; relu on the write-back to
//    the other activation buffer;
// 4. the first TR threads take the softmax of their row.
// No per-thread array is indexed at run time. A stack too large for shared
// memory beside the buffers reads its weights from global memory instead,
// at TR = 64. The augmented domain is its own instantiation (kPairs): the
// feature count is then a run-time value and the pair tables ((P, 2) feature
// indices and float32 thresholds) are staged beside the per-feature tables;
// at kPairs = false the feature count is the constant 47 and the pair stage
// is compiled out, so the base domain's code is what it was.
//
// The history (kHistory, either domain): MoEvA's save_history="full"
// records each evaluation's objectives and kept terms
// (attacks/moeva/engine.py::Moeva2._evaluate_hist of the JAX package, the
// plain version's evaluate_hist_plain). The thread that sums a row's terms
// stores each kept term to the row's (3 + 10 + P)-float record as it adds
// it, and the threads that write out's f1, f2 and sum store them at columns
// 0-2, so column 2 is out's sum bit for bit. The record's bytes (13 floats
// a row on LCLD) are the only extra work; at kHistory = false the stores
// are compiled out and the base's code is what it was.

#include <climits>
#include <cmath>

#include "kernels.h"

namespace {

// states whose rows a tile stages in shared memory (a tile of 128 rows of
// N >= 64 candidates spans at most 3); a tile that spans more reads them
// from global memory
constexpr int kTileStates = 4;

struct MlpShape {
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
};

struct ObjectiveArgs {
  const float* x_gen;      // (S * N, L)
  const float* x_init;     // (S, D)
  const float* xl;         // (S, D)
  const float* xu;         // (S, D)
  const float* x_init_mm;  // (S, D)
  const int64_t* min_class;
  const int32_t* feat_gene;
  const int32_t* feat_onehot;
  const float* params;  // each layer's weight (out, in), then its bias
  const float* scale;   // (D,) or null
  const float* offset;  // (D,) or null
  float f2_scale;
  int norm_inf;
  float tol;
  float* out;     // (S * N, 3)
  float* record;  // (S * N, 3 + 10 + n_pairs) under kHistory, else null
  int n_rows;
  int n;
  int l;
  int buf_rows;   // rows of each activation buffer: the widest padded layer
  int w_floats;   // floats of the staged stack (0: read from params)
  int d;          // features: 47, or 47 + n_pairs on the augmented domain
  const int32_t* pair_idx;  // (n_pairs, 2) base features of each pair
  const float* pair_thr;    // (n_pairs, 2) their thresholds
  int n_pairs;
};

__host__ __device__ constexpr int pad8(int w) { return (w + 7) & ~7; }

// outputs per thread for a layer of out_w units: at most 8 output groups
// of a tile's row groups, so that 2 * TR threads cover widths up to 64 in
// one pass
__host__ __device__ constexpr int outputs_per_thread(int out_w) {
  return out_w > 32 ? 8 : out_w > 16 ? 4 : out_w > 8 ? 2 : 1;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float relu_if(bool hidden, float x) {
  return hidden && !(x > 0.0f) && !isnan(x) ? 0.0f : x;
}

// OM consecutive weights w[k][o0 .. o0 + OM) of a staged layer, aligned to
// OM floats
template <int OM>
__device__ __forceinline__ void load_weights(const float* p, float (&w)[OM]) {
  if constexpr (OM == 8) {
    const float4 u = reinterpret_cast<const float4*>(p)[0];
    const float4 v = reinterpret_cast<const float4*>(p)[1];
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    w[4] = v.x; w[5] = v.y; w[6] = v.z; w[7] = v.w;
  } else if constexpr (OM == 4) {
    const float4 u = reinterpret_cast<const float4*>(p)[0];
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (OM == 2) {
    const float2 u = reinterpret_cast<const float2*>(p)[0];
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = p[0];
  }
}

// One layer on a tile: h[o][row] = relu(bias[o] + sum_k a[k][row] * w[o][k])
// for o < out_w, the sum in k order. Staged weights are w[k][o] with rows of
// pad8(out_w) floats and the bias padded likewise; global ones are the
// params' w[o][k] and bias.
template <int TR, int OM, bool kStaged>
__device__ __forceinline__ void dense_layer(const float* __restrict__ a,
                                            float* __restrict__ h,
                                            const float* __restrict__ w,
                                            const float* __restrict__ bias,
                                            int in_w, int out_w, bool hidden) {
  constexpr int kThreads = 2 * TR;
  constexpr int kRowGroups = TR / 4;
  const int op = pad8(out_w);
  const int n_items = kRowGroups * ((out_w + OM - 1) / OM);
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    const int r = (item % kRowGroups) * 4;
    const int o0 = (item / kRowGroups) * OM;
    float acc[4][OM];
#pragma unroll
    for (int j = 0; j < OM; ++j) {
      float b;
      if constexpr (kStaged) {
        b = bias[o0 + j];
      } else {
        b = o0 + j < out_w ? __ldg(bias + o0 + j) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = b;
    }
#pragma unroll 2
    for (int k = 0; k < in_w; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * TR + r);
      float wv[OM];
      if constexpr (kStaged) {
        load_weights<OM>(w + k * op + o0, wv);
      } else {
#pragma unroll
        for (int j = 0; j < OM; ++j)
          wv[j] = o0 + j < out_w ? __ldg(w + (o0 + j) * in_w + k) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < OM; ++j) {
        acc[0][j] = __fadd_rn(acc[0][j], __fmul_rn(av.x, wv[j]));
        acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(av.y, wv[j]));
        acc[2][j] = __fadd_rn(acc[2][j], __fmul_rn(av.z, wv[j]));
        acc[3][j] = __fadd_rn(acc[3][j], __fmul_rn(av.w, wv[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < OM; ++j) {
      float4 v;
      v.x = relu_if(hidden, acc[0][j]);
      v.y = relu_if(hidden, acc[1][j]);
      v.z = relu_if(hidden, acc[2][j]);
      v.w = relu_if(hidden, acc[3][j]);
      *reinterpret_cast<float4*>(h + (o0 + j) * TR + r) = v;
    }
  }
}

// The summed LCLD violations of one row; x(k) is feature k of the row,
// unscaled, read from column xf of a [k][TR] buffer. kHistory: each kept
// term i is also stored to rec[i] (the row's record past its objectives),
// the value that joins the sum.
template <int TR, bool kHistory>
__device__ __forceinline__ float lcld_violation(const float* xf, float thr, float* rec) {
  auto x = [&](int k) { return xf[k * TR]; };
  auto keep = [&](int i, float t) {
    const float v = t > thr ? t : 0.0f;
    if constexpr (kHistory) rec[i] = v;
    return v;
  };
  const float r = __fdiv_rn(x(2), 1200.0f);
  const float growth = __double2float_rn(
      pow(static_cast<double>(__fadd_rn(1.0f, r)), static_cast<double>(x(1))));
  const float inst = __fdiv_rn(__fmul_rn(__fmul_rn(x(0), r), growth),
                               __fsub_rn(growth, 1.0f));
  const float x11 = x(11);
  const float x16 = x(16);
  const float x22 = x(22);
  float ratio = x11 != 0.0f ? __fdiv_rn(x16, x11) : -1.0f;
  if (!isfinite(ratio)) ratio = -1.0f;
  float g = keep(0, __fsub_rn(fabsf(__fsub_rn(x(3), inst)), static_cast<float>(0.099999)));
  g = __fadd_rn(g, keep(1, __fsub_rn(x(10), x(14))));
  g = __fadd_rn(g, keep(2, __fsub_rn(x16, x11)));
  g = __fadd_rn(g, keep(3, fabsf(__fmul_rn(__fsub_rn(36.0f, x(1)), __fsub_rn(60.0f, x(1))))));
  g = __fadd_rn(g, keep(4, fabsf(__fsub_rn(x(20), __fdiv_rn(x(0), x(6))))));
  g = __fadd_rn(g, keep(5, fabsf(__fsub_rn(x(21), __fdiv_rn(x(10), x(14))))));
  g = __fadd_rn(g, keep(6, fabsf(__fsub_rn(x22, __fsub_rn(lcld_months(x(7)), lcld_months(x(9)))))));
  g = __fadd_rn(g, keep(7, fabsf(__fsub_rn(x(23), __fdiv_rn(x11, x22)))));
  g = __fadd_rn(g, keep(8, fabsf(__fsub_rn(x(24), __fdiv_rn(x16, x22)))));
  return __fadd_rn(g, keep(9, fabsf(__fsub_rn(x(25), ratio))));
}

// g with the consistency terms of the augmented domain's P pairs added in
// order, |x[d - P + p] - xor(x[i] >= t_i, x[j] >= t_j)| each (the
// augmented features are a row's last P columns); kHistory: each kept term
// p also stored to rec[kLcldTerms + p]
template <int TR, bool kHistory>
__device__ __forceinline__ float add_pair_terms(float g, const float* xf, float thr, const int* idx,
                                                const float* t, int n_pairs, int d, float* rec) {
  for (int p = 0; p < n_pairs; ++p) {
    const bool a = xf[idx[2 * p] * TR] >= t[2 * p];
    const bool b = xf[idx[2 * p + 1] * TR] >= t[2 * p + 1];
    const float v = fabsf(__fsub_rn(xf[(d - n_pairs + p) * TR], a != b ? 1.0f : 0.0f));
    const float kept = v > thr ? v : 0.0f;
    if constexpr (kHistory) rec[kLcldTerms + p] = kept;
    g = __fadd_rn(g, kept);
  }
  return g;
}

template <int TR, bool kStaged, bool kPairs, bool kHistory>
__global__ void __launch_bounds__(2 * TR)
objective_lcld_kernel(ObjectiveArgs args, MlpShape shape) {
  constexpr int kThreads = 2 * TR;
  const int d = kPairs ? args.d : kLcldFeatures;
  const int n_pairs = kPairs ? args.n_pairs : 0;
  // kHistory: a row's record, its objectives then its kept terms
  [[maybe_unused]] const int rec_cols = 3 + kLcldTerms + n_pairs;
  extern __shared__ __align__(16) unsigned char smem[];
  float* act0 = reinterpret_cast<float*>(smem);       // (buf_rows, TR)
  float* act1 = act0 + args.buf_rows * TR;            // (buf_rows, TR)
  float* genes = act1 + args.buf_rows * TR;           // (TR, l) the tile's
  float* st = genes + TR * args.l;                    // (4, kTileStates, d)
  float* wt = st + 4 * kTileStates * d;               // the staged stack
  float* sc = wt + args.w_floats;                     // (d,) scaler scale
  float* of = sc + d;                                 // (d,) scaler offset
  int* fg = reinterpret_cast<int*>(of + d);           // (d,) feat_gene
  int* fk = fg + d;                                   // (d,) feat_onehot
  int* pidx = fk + d;                                 // (n_pairs, 2) pair features
  float* pthr = reinterpret_cast<float*>(pidx + 2 * n_pairs);  // (n_pairs, 2) thresholds
  const int tid = threadIdx.x;
  const bool scaled = args.scale != nullptr;

  for (int k = tid; k < d; k += kThreads) {
    sc[k] = scaled ? args.scale[k] : 1.0f;
    of[k] = scaled ? args.offset[k] : 0.0f;
    fg[k] = args.feat_gene[k];
    fk[k] = args.feat_onehot[k];
  }
  if constexpr (kPairs) {
    for (int e = tid; e < 2 * n_pairs; e += kThreads) {
      pidx[e] = args.pair_idx[e];
      pthr[e] = args.pair_thr[e];
    }
  }
  if constexpr (kStaged) {
    // each layer: w[k][o] (in_w rows of pad8(out_w)), then the bias
    int at = 0;
    const float* p = args.params;
    for (int layer = 0; layer < shape.n_layers; ++layer) {
      const int in_w = shape.widths[layer];
      const int out_w = shape.widths[layer + 1];
      const int op = pad8(out_w);
      // read the params in order, write them transposed; zero the padding
      for (int e = tid; e < out_w * in_w; e += kThreads)
        wt[at + (e % in_w) * op + e / in_w] = p[e];
      for (int e = tid; e < in_w * (op - out_w); e += kThreads)
        wt[at + (e / (op - out_w)) * op + out_w + e % (op - out_w)] = 0.0f;
      at += in_w * op;
      p += out_w * in_w;
      for (int o = tid; o < op; o += kThreads) wt[at + o] = o < out_w ? p[o] : 0.0f;
      at += op;
      p += out_w;
    }
  }
  __syncthreads();

  const int rr = tid % TR;  // this thread's row of the tile
  const int half = tid / TR;
  const int n_tiles = (args.n_rows + TR - 1) / TR;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const int rows = args.n_rows - row0 < TR ? args.n_rows - row0 : TR;
    const int row = row0 + rr;
    const bool valid = rr < rows;
    const int s = valid ? row / args.n : 0;

    // 0. stage the tile's genes and, where they fit, its states' rows:
    // initial state, lower bound, min-max denominator, normalised initial
    // state (each copy reads consecutive addresses)
    const int s0 = row0 / args.n;
    const int n_st = (row0 + rows - 1) / args.n - s0 + 1;
    const bool staged_st = n_st <= kTileStates;
    const float* src = args.x_gen + static_cast<size_t>(row0) * args.l;
    for (int e = tid; e < rows * args.l; e += kThreads) genes[e] = src[e];
    if (staged_st) {
      for (int e = tid; e < n_st * d; e += kThreads) {
        const size_t at = static_cast<size_t>(s0) * d + e;
        const float lo = args.xl[at];
        const float rng = __fsub_rn(args.xu[at], lo);
        st[e] = args.x_init[at];
        st[kTileStates * d + e] = lo;
        st[2 * kTileStates * d + e] = rng == 0.0f ? 1.0f : rng;
        st[3 * kTileStates * d + e] = args.x_init_mm[at];
      }
    }
    __syncthreads();
    // this row's state rows: staged (with the min-max denominator) or in
    // global memory (with the upper bound; the denominator per use)
    const size_t so = static_cast<size_t>(s) * d;
    const float* x0 = staged_st ? st + (s - s0) * d : args.x_init + so;
    const float* lo = staged_st ? x0 + kTileStates * d : args.xl + so;
    const float* den_or_hi = staged_st ? lo + kTileStates * d : args.xu + so;
    const float* mm0 = staged_st ? den_or_hi + kTileStates * d : args.x_init_mm + so;
    auto denominator = [&](int k) {
      if (staged_st) return den_or_hi[k];
      const float rng = __fsub_rn(den_or_hi[k], lo[k]);
      return rng == 0.0f ? 1.0f : rng;
    };

    // 1. decode into act1 (unscaled) and the scaler into act0; each half of
    // the threads takes every other feature of its row
    if (valid) {
      const float* gj = genes + rr * args.l;
#pragma unroll 4
      for (int i = 0; i < (d + 1) / 2; ++i) {
        const int k = 2 * i + half;
        if (k >= d) break;
        const int gene = fg[k];
        const int slot = fk[k];
        const float gv = gj[gene < 0 ? 0 : gene];
        const float v = gene < 0 ? x0[k]
                        : slot < 0 ? gv
                                   : (rintf(gv) == static_cast<float>(slot) ? 1.0f : 0.0f);
        act1[k * TR + rr] = v;
        act0[k * TR + rr] = scaled ? __fadd_rn(__fmul_rn(v, sc[k]), of[k]) : v;
      }
    } else {
      for (int k = half; k < d; k += 2) act0[k * TR + rr] = 0.0f;
    }
    __syncthreads();

    // 2. the distance over the min-max differences (first TR threads) and
    // the constraint terms (the others), each in the plain version's order
    if (valid) {
      if (half == 0) {
        float dist = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float diff = __fsub_rn(
              __fdiv_rn(__fsub_rn(act1[k * TR + rr], lo[k]), denominator(k)), mm0[k]);
          if (args.norm_inf) {
            dist = k == 0 ? fabsf(diff) : nan_max(dist, fabsf(diff));
          } else {
            const float sq = __fmul_rn(diff, diff);
            dist = k == 0 ? sq : __fadd_rn(dist, sq);
          }
        }
        if (!args.norm_inf) dist = __fsqrt_rn(dist);
        const float f2 = __fdiv_rn(dist, args.f2_scale);
        args.out[3 * static_cast<size_t>(row) + 1] = f2;
        if constexpr (kHistory) args.record[static_cast<size_t>(rec_cols) * row + 1] = f2;
      } else {
        float* rec = kHistory ? args.record + static_cast<size_t>(rec_cols) * row : nullptr;
        float g = lcld_violation<TR, kHistory>(act1 + rr, args.tol, kHistory ? rec + 3 : nullptr);
        if constexpr (kPairs)
          g = add_pair_terms<TR, kHistory>(g, act1 + rr, args.tol, pidx, pthr, n_pairs, d, kHistory ? rec + 3 : nullptr);
        args.out[3 * static_cast<size_t>(row) + 2] = g;
        if constexpr (kHistory) rec[2] = g;
      }
    }
    __syncthreads();

    // 3. the relu stack, act0 -> act1 -> act0 ...
    float* a = act0;
    float* h = act1;
    const float* wp = kStaged ? wt : args.params;
    for (int layer = 0; layer < shape.n_layers; ++layer) {
      const int in_w = shape.widths[layer];
      const int out_w = shape.widths[layer + 1];
      const float* bias = wp + (kStaged ? in_w * pad8(out_w) : in_w * out_w);
      const bool hidden = layer + 1 < shape.n_layers;
      switch (outputs_per_thread(out_w)) {
        case 8: dense_layer<TR, 8, kStaged>(a, h, wp, bias, in_w, out_w, hidden); break;
        case 4: dense_layer<TR, 4, kStaged>(a, h, wp, bias, in_w, out_w, hidden); break;
        case 2: dense_layer<TR, 2, kStaged>(a, h, wp, bias, in_w, out_w, hidden); break;
        default: dense_layer<TR, 1, kStaged>(a, h, wp, bias, in_w, out_w, hidden); break;
      }
      __syncthreads();
      wp = bias + (kStaged ? pad8(out_w) : out_w);
      float* t = a;
      a = h;
      h = t;
    }

    // 4. class probabilities; the logits are in a
    if (valid && tid < TR) {
      float p0, p1;
      if (shape.widths[shape.n_layers] == 1) {
        const float e = __double2float_rn(exp(-static_cast<double>(a[rr])));
        p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
        p0 = __fsub_rn(1.0f, p1);
      } else {
        const float l0 = a[rr];
        const float l1 = a[TR + rr];
        const float mx = nan_max(l0, l1);
        const float e0 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l0, mx))));
        const float e1 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l1, mx))));
        const float sum = __fadd_rn(e0, e1);
        p0 = __fdiv_rn(e0, sum);
        p1 = __fdiv_rn(e1, sum);
      }
      const float f1 = args.min_class[s] == 0 ? p0 : p1;
      args.out[3 * static_cast<size_t>(row)] = f1;
      if constexpr (kHistory) args.record[static_cast<size_t>(rec_cols) * row] = f1;
    }
    __syncthreads();
  }
}

template <int TR, bool kStaged, bool kPairs, bool kHistory>
cudaError_t launch_tiles(const ObjectiveArgs& args, const MlpShape& shape,
                         size_t smem, cudaStream_t stream) {
  auto kernel = objective_lcld_kernel<TR, kStaged, kPairs, kHistory>;
  constexpr int kThreads = 2 * TR;
  static LaunchCache cache;
  int resident = 0;
  const cudaError_t err =
      cache.prepare(reinterpret_cast<const void*>(kernel), kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  const int n_tiles = (args.n_rows + TR - 1) / TR;
  const int grid = n_tiles < resident ? n_tiles : resident;
  kernel<<<grid, kThreads, smem, stream>>>(args, shape);
  return cudaGetLastError();
}

// shared bytes of one block: two activation buffers, the tile's genes and
// state rows, the staged stack (w_floats), the per-feature tables of d
// features and the pair tables
size_t objective_smem(int tile_rows, int buf_rows, int l, int w_floats, int d, int n_pairs) {
  return sizeof(float) * (static_cast<size_t>(2 * buf_rows + l) * tile_rows + 4 * kTileStates * d + w_floats +
                          2 * d + 2 * n_pairs) +
         sizeof(int) * (2 * d + 2 * n_pairs);
}

template <bool kPairs, bool kHistory>
cudaError_t launch_objective(ObjectiveArgs& args, const MlpShape& shape, int stack_floats,
                             cudaStream_t stream) {
  // stage the stack where it fits beside the buffers of 128-row tiles; a
  // stack read from global memory takes 64-row tiles (at 128 rows ptxas
  // spills registers around the out-of-line float64 pow)
  const size_t smem = objective_smem(128, args.buf_rows, args.l, stack_floats, args.d, args.n_pairs);
  if (smem <= kMaxSharedBytes) {
    args.w_floats = stack_floats;
    return launch_tiles<128, true, kPairs, kHistory>(args, shape, smem, stream);
  }
  const size_t smem_global = objective_smem(64, args.buf_rows, args.l, 0, args.d, args.n_pairs);
  if (smem_global > kMaxSharedBytes) return cudaErrorInvalidValue;
  return launch_tiles<64, false, kPairs, kHistory>(args, shape, smem_global, stream);
}

}  // namespace

cudaError_t launch_objective_lcld(
    const float* x_gen, const float* x_init, const float* xl, const float* xu,
    const float* x_init_mm, const int64_t* min_class, const int32_t* feat_gene,
    const int32_t* feat_onehot, const float* params, const int* widths,
    int n_layers, const float* scale, const float* offset, float f2_scale,
    int norm_inf, float tol, float* out, float* record, int n_states, int n, int l, int d,
    const int32_t* pair_idx, const float* pair_thr, int n_pairs,
    cudaStream_t stream) {
  if (n_states == 0 || n == 0) return cudaSuccess;
  if (n_states < 0 || n < 0 || l <= 0 || n_pairs < 0 || n_pairs > kLcldMaxPairs ||
      d != kLcldFeatures + n_pairs || (n_pairs > 0 && (pair_idx == nullptr || pair_thr == nullptr)) ||
      n_layers < 1 || n_layers > kObjectiveMaxLayers || widths[0] != d)
    return cudaErrorInvalidValue;
  MlpShape shape;
  shape.n_layers = n_layers;
  int n_params = 0;
  int buf_rows = 0;
  int stack_floats = 0;
  for (int k = 0; k <= n_layers; ++k) {
    if (widths[k] < 1 || widths[k] > kObjectiveMaxWidth) return cudaErrorInvalidValue;
    shape.widths[k] = widths[k];
    buf_rows = buf_rows > pad8(widths[k]) ? buf_rows : pad8(widths[k]);
    if (k > 0) {
      n_params += widths[k] * (widths[k - 1] + 1);
      stack_floats += pad8(widths[k]) * (widths[k - 1] + 1);
    }
  }
  if (widths[n_layers] > 2 || n_params > kObjectiveMaxParams)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(n_states) * n > INT_MAX) return cudaErrorInvalidValue;
  ObjectiveArgs args{x_gen, x_init, xl, xu, x_init_mm, min_class, feat_gene,
                     feat_onehot, params, scale, offset, f2_scale, norm_inf, tol,
                     out, record, n_states * n, n, l, buf_rows, 0, d, pair_idx, pair_thr, n_pairs};
  if (record != nullptr)
    return n_pairs > 0 ? launch_objective<true, true>(args, shape, stack_floats, stream)
                       : launch_objective<false, true>(args, shape, stack_floats, stream);
  return n_pairs > 0 ? launch_objective<true, false>(args, shape, stack_floats, stream)
                     : launch_objective<false, false>(args, shape, stack_floats, stream);
}
