// K7: constrained PGD on the LCLD domain, every iteration of one run in one
// launch.
//
// Replaces the jnp device program of moeva2_ijcai22_replication_tpu/attacks/
// pgd/engine.py::ConstrainedPGD._one_run (its lax.fori_loop), and of
// attacks/pgd/autopgd.py::AutoPGD._one_run (kAuto), with what each
// iteration runs: _grad_and_terms (jax.grad of the weighted cross-entropy
// minus the smooth LCLD violations, through models/mlp.py::MLP and
// domains/lcld.py::lcld_constraint_terms), NaN zeroing, the mutable mask,
// core/norms.py::condition_grad, the step, the clip, project_ball and the
// optional LcldConstraints.repair. The repo has no Pallas kernel for it.
//
// Semantics: those of attacks/pgd/engine.py::pgd_run_plain, one rounded
// float32 operation at a time in its order (__fadd_rn / __fmul_rn /
// __fdiv_rn, so nvcc cannot contract them into FMAs):
// - the iteration's loss weights, step size and constraint come from the
//   schedule tables (attacks/pgd/engine.py::make_schedule);
// - forward: models/mlp.py::mlp_forward_plain (K1's order: each unit from
//   its bias, adding w[o][k] * a[k] for k = 0, 1, ...; relu keeps NaN);
// - the cross-entropy and its backward: grad_and_terms_plain (exp and log
//   in float64 rounded once; ct_l = ct_ls + (sum(-ct_ls) / sum(e)) * e);
// - the MLP's input backward: mlp_input_grad_plain (a hidden unit passes
//   its cotangent where its output is > 0; each input unit sums
//   w[o][k] * ct[o] for o = 0, 1, ...);
// - the constraints' backward: domains/lcld.py::lcld_smooth_vjp, jax.grad's
//   conventions (abs: the cotangent where v >= 0, its negation elsewhere;
//   clip: the cotangent times 0.5 at +inf / 0 at NaN, then times 1 above
//   0 / 0.5 at 0 / 0 below; every product taken, so NaN lands where
//   jax.grad puts it), the installment's pow and its two derivatives in
//   float64 rounded once, the contributions summed term by term from 0;
// - L2 sums left to right and correctly rounded square roots; min and max
//   NaN-propagating (torch.clamp, torch.minimum); the L-inf sign 0 at 0;
// - repair as LcldConstraints.repair: term snapped to {36, 60}, the
//   installment recomputed, each one-hot group set to its first largest
//   slot (a NaN counts as the largest), on the augmented domain each pair's
//   feature re-derived from the repaired base, then back to scaled space
//   for the mutable features (an immutable one keeps its unrepaired x, and
//   its unscaled value is taken from x again);
// - the augmented domain (domains/lcld.py::LcldAugmentedConstraints, D =
//   47 + P, the pairs' features last): after the ten terms the P pair terms
//   |x[47 + p] - xor(x[i] >= t_i, x[j] >= t_j)| (a NaN compares false; the
//   thresholds rounded once to float32), clipped as the others; each
//   pair's cotangent abs_vjp(v, clip_vjp(pre, ct)) goes to its augmented
//   feature alone, added to 0 (none flows through the comparisons);
// - the class at x_adv as engine.py::predict_plain (mlp_proba_plain's
//   softmax, the first largest probability);
// - AutoPGD (kAuto) as attacks/pgd/autopgd.py::autopgd_run_plain: the
//   tracking loss tw_class * CE + tw_cons * (-cons) with cons the
//   constraint tctr (or the sum), at x_start before the first iteration and
//   at x_new after each; the step with the row's eta instead of the
//   schedule's; z clipped, projected and clipped, then the momentum x +
//   alpha (z - x) + (1 - alpha)(x - x_prev) added left to right (alpha 1 at
//   iteration 0: 0 * (x - x_prev) keeps a NaN), clipped, projected and
//   clipped, then repair; the best point where the tracking loss rose above
//   the best (a NaN never does), the rises counted in float32; at a
//   checkpoint (is_ckpt[i + 1]) eta halved and x restarted from the best
//   point (x_prev is still the x the iteration started from) where the
//   rises since the last one are below ckpt_thr[i + 1], or eta and the best
//   loss are both what they were at the last one, and eta and the best loss
//   recorded; the result is the best point, the class there and each row's
//   eta.
//
// Bound: per row and iteration the stack's forward and its input backward
// are 2 x 5,600 multiply-adds for 47-64-32-16-2 (2 x 6,240 at 57 inputs),
// plus ~300 operations (and ~10 per pair) for
// the terms, their backward and the step: about 23k fp32 operations on 190
// bytes of the row read once and written once. Bound by operations.
// AutoPGD adds per iteration a forward of the stack and the terms (5,600
// multiply-adds and ~150 operations) and ~20 per feature for the momentum
// and the second projection. Tensor
// cores are not used (their sums have an order no CPU code reproduces), and
// without FMA a multiply-add is two instructions, so the ceiling is half
// the fp32 peak. An iteration's longest dependent chain (the stack's sums,
// the cross-entropy, the two L2 sums, the repair) is shorter than the issue
// time of its operations at ~30 rows per SM: K7 is bound by the
// instructions it issues, by the serial chains it cannot hide, and (as
// measured) by fetching an iteration's code.
//
// Design: a block runs ceil(N / SMs) rows, at most kPgdMaxRows, so that one
// block runs on each SM; kMlpWarps warps run the stack and one more the
// terms. Per iteration:
// - the stack, forward and backward, layer by layer: each thread sums a
//   register tile of kTile rows x kTile units (inputs in the backward),
//   reading the activations 4 at a time along the summed axis in the
//   forward and the cotangents 4 at a time in the backward, every sum still
//   in its one order; the stack's warps meet at a named barrier between
//   layers;
// - meanwhile the terms warp runs the ten terms and their backward from
//   the unscaled rows (they need nothing of the stack), one row per lane;
// - the head's logits and the cross-entropy, one row per thread;
// - the gradient, the step, the projection and repair's round trip are
//   elementwise over the block's rows; the L2 sums are squared by all
//   threads and added left to right by one thread per row; repair runs
//   each row's installment and each of its one-hot groups as tasks side by
//   side;
// - after the last iteration the same forward gives the class at x_adv.
// What the stamps and ablations of tools/probe_pgd_lcld.py showed shaped
// the rest: an iteration runs every phase's code once, and code the
// instruction caches do not hold costs more than the arithmetic, so the
// kernel keeps one tile shape (larger tiles were slower too), leaves its
// loops rolled past their float4 step and calls float64 pow and log rather
// than inlining them; a zero numerator skips the division's slow path,
// which many elementwise divisions would take. Shared memory holds the
// stack (each weight row at a stride of an odd number of float4s, so lanes
// reading consecutive rows 16 bytes at a time hit distinct banks), the
// scaler, the mask, the one-hot table and each row's buffers (also at an
// odd float4 stride, so one row per lane is conflict-free). The augmented
// domain is its own instantiation (kPairs), with the feature count and the
// row stride as run-time values, the pair tables staged after the one-hot
// table, its pair terms run by the terms warp after the ten and its
// repair's re-derivation as one more pass of (row, pair) tasks; at kPairs =
// false the pair stage is compiled out and the feature count is the
// constant 47. AutoPGD is its own instantiation too (kAuto): a launch runs
// 2T + 2 passes of the same code, an even one the tracking loss (the terms
// warp's terms and the stack's forward and cross-entropy, nothing
// backward) followed by the best point and the checkpoint, one thread per
// row, and the copies to x_best and back to x; an odd one an iteration's
// gradient and step; the last the class at x_best. x_prev and x_best are
// two more row buffers in shared memory, the per-row state (the best and
// the previous tracking loss, eta, the rises and the checkpoint's eta and
// best loss) scalars beside them; at kAuto = false all of it is compiled
// out.

#include "pgd_common.cuh"

namespace {

constexpr int kD = kLcldFeatures;
constexpr int kTerms = 10;
constexpr int kMlpWarps = 16;
constexpr int kMlpThreads = kMlpWarps * 32;
constexpr int kThreads = kMlpThreads + 32;  // the stack's warps, then the terms warp
constexpr int kTermsTid = kMlpThreads;      // the terms warp's lane 0
// a thread's register tile: kTile rows x kTile units (forward) or inputs
// (backward), one shape for every layer, so that each sum has one copy in
// an iteration's code (which the instruction caches must hold); 2 x 2
// measured fastest, larger and smaller tiles slower
constexpr int kTile = 2;

// floats of a buffer of `w` entries padded to an odd number of float4s
__host__ __device__ constexpr int odd_stride(int w) {
  const int q = (w + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}
constexpr int kRS = odd_stride(kD);  // a row of features: 52

struct PgdLayout {
  int w_off[kObjectiveMaxLayers];    // each layer's weight (out_w rows of w_st floats)
  int b_off[kObjectiveMaxLayers];    // and its bias
  int w_st[kObjectiveMaxLayers];
  int act_off[kObjectiveMaxLayers];  // each hidden layer's outputs, rows of act_st floats
  int act_st[kObjectiveMaxLayers];
  int w_floats;                       // the staged stack
  int ohe_ints;                       // the one-hot table, padded to 4
  int ct_off;                         // the cotangents, after the activations
  int ct_st;                          // a row of cotangents (the widest layer output)
  int rows;                           // rows per block
  int rows_pad;                       // padded to whole tiles
  int row_floats;                     // the block's row buffers
  int rs;                             // a row of features (kRS on the base domain)
  int pair_ints;                      // the pair tables, 4 words per pair
};

// float64 pow and log, one copy of each in the kernel's code (an
// iteration's code must stay small enough for the instruction caches)
__device__ __noinline__ double pow_f64(double b, double e) { return pow(b, e); }
__device__ __noinline__ double log_f64(double x) { return log(x); }

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// the stack's warps meet
__device__ __forceinline__ void mlp_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kMlpThreads) : "memory");
}

// One layer's forward over the block's rows_pad rows in tiles of RT rows x
// UT units (units ug, ug + n_ug, ...): out = bias + sum_k w[o][k] * in[k],
// k = 0, 1, ... in order; store(row, unit, sum) for each unit that exists
template <int RT, int UT, class Store>
__device__ __forceinline__ void forward_tiles(const float* w, int st, const float* bias, int in_w, int out_w,
                                              const float* in, int in_st, int rows_pad, int t0, int nt,
                                              Store store) {
  const int n_ug = (out_w + UT - 1) / UT;
  const int n_tiles = (rows_pad / RT) * n_ug;
  for (int tile = t0; tile < n_tiles; tile += nt) {
    const int rg = tile / n_ug;
    const int ug = tile - rg * n_ug;
    const float* wr[UT];
    float acc[RT][UT];
#pragma unroll
    for (int j = 0; j < UT; ++j) {
      const int o = min(ug + j * n_ug, out_w - 1);
      wr[j] = w + o * st;
      const float b = bias[o];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][j] = b;
    }
    const float* ar = in + rg * RT * in_st;
    int k = 0;
#pragma unroll 1
    for (; k + 4 <= in_w; k += 4) {
      float4 av[RT], wv[UT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = ld4(ar + i * in_st + k);
#pragma unroll
      for (int j = 0; j < UT; ++j) wv[j] = ld4(wr[j] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < UT; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(comp(av[i], q), comp(wv[j], q)));
    }
#pragma unroll 1
    for (; k < in_w; ++k) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < UT; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(ar[i * in_st + k], wr[j][k]));
    }
#pragma unroll
    for (int j = 0; j < UT; ++j) {
      const int o = ug + j * n_ug;
      if (o < out_w) {
#pragma unroll
        for (int i = 0; i < RT; ++i) store(rg * RT + i, o, acc[i][j]);
      }
    }
  }
}

// One layer's input backward over rows_pad rows in tiles of RT rows x KT
// inputs (kg, kg + n_kg, ...): the sum over o = 0, 1, ... of
// w[o][k] * cur[o], from its first product; store(row, input, sum) for each
// input that exists
template <int RT, int KT, class Store>
__device__ __forceinline__ void backward_tiles(const float* w, int st, int in_w, int out_w, const float* cur,
                                               int cur_st, int rows_pad, int t0, int nt, Store store) {
  const int n_kg = (in_w + KT - 1) / KT;
  const int n_tiles = (rows_pad / RT) * n_kg;
  for (int tile = t0; tile < n_tiles; tile += nt) {
    const int rg = tile / n_kg;
    const int kg = tile - rg * n_kg;
    int kc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) kc[j] = min(kg + j * n_kg, in_w - 1);
    const float* cr = cur + rg * RT * cur_st;
    float acc[RT][KT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[i][j] = __fmul_rn(cr[i * cur_st], w[kc[j]]);
    int o = 1;
#pragma unroll 1
    for (; o < out_w && (o & 3); ++o) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(cr[i * cur_st + o], w[o * st + kc[j]]));
    }
#pragma unroll 1
    for (; o + 4 <= out_w; o += 4) {
      float4 cv[RT];
      float wv[4][KT];
#pragma unroll
      for (int i = 0; i < RT; ++i) cv[i] = ld4(cr + i * cur_st + o);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < KT; ++j) wv[q][j] = w[(o + q) * st + kc[j]];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < KT; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(comp(cv[i], q), wv[q][j]));
    }
#pragma unroll 1
    for (; o < out_w; ++o) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(cr[i * cur_st + o], w[o * st + kc[j]]));
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int k = kg + j * n_kg;
      if (k < in_w) {
#pragma unroll
        for (int i = 0; i < RT; ++i) store(rg * RT + i, k, acc[i][j]);
      }
    }
  }
}

// The stack's hidden layers on the block's rows, from the rows X; each
// layer's outputs (relu) into its activation buffer, the stack's warps
// meeting after each. Returns the head's input and its stride.
__device__ __forceinline__ const float* hidden_forward(const PgdArgs& a, const PgdLayout& lay, const float* ws,
                                                       const float* X, int rs, float* act, int tid, int& in_st) {
  const float* in = X;
  in_st = rs;
  for (int l = 0; l + 1 < a.n_layers; ++l) {
    float* out = act + lay.act_off[l];
    const int out_st = lay.act_st[l];
    forward_tiles<kTile, kTile>(ws + lay.w_off[l], lay.w_st[l], ws + lay.b_off[l], a.widths[l], a.widths[l + 1], in,
                                in_st, lay.rows_pad, tid, kMlpThreads,
                                [&](int r, int o, float v) { out[r * out_st + o] = relu_keep_nan(v); });
    mlp_sync();
    in = out;
    in_st = out_st;
  }
  return in;
}

// The head's logits (1 or 2) of one row `in` of in_w activations
__device__ __forceinline__ void head_logits(const PgdArgs& a, const PgdLayout& lay, const float* ws, const float* in,
                                            float* lg) {
  const int l = a.n_layers - 1;
  const int in_w = a.widths[l];
  const int st = lay.w_st[l];
  const float* w0 = ws + lay.w_off[l];
  const float* w1 = a.widths[l + 1] == 2 ? w0 + st : w0;
  const float* bias = ws + lay.b_off[l];
  float s0 = bias[0];
  float s1 = bias[a.widths[l + 1] == 2 ? 1 : 0];
  int k = 0;
  for (; k + 4 <= in_w; k += 4) {
    const float4 av = ld4(in + k), v0 = ld4(w0 + k), v1 = ld4(w1 + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s0 = __fadd_rn(s0, __fmul_rn(comp(av, q), comp(v0, q)));
      s1 = __fadd_rn(s1, __fmul_rn(comp(av, q), comp(v1, q)));
    }
  }
  for (; k < in_w; ++k) {
    s0 = __fadd_rn(s0, __fmul_rn(in[k], w0[k]));
    s1 = __fadd_rn(s1, __fmul_rn(in[k], w1[k]));
  }
  lg[0] = s0;
  lg[1] = s1;
}

// sum_last of a row's d squares (kD on the base domain), left to right,
// read 4 at a time
template <bool kPairs>
__device__ __forceinline__ float row_sum(const float* sq, int d) {
  float4 v = ld4(sq);
  if constexpr (kPairs) {
    float s = __fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w);
    int q = 4;
    for (; q + 4 <= d; q += 4) {
      v = ld4(sq + q);
      s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z), v.w);
    }
    for (; q < d; ++q) s = __fadd_rn(s, sq[q]);
    return s;
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w);
#pragma unroll
  for (int q = 1; q < kD / 4; ++q) {
    v = ld4(sq + 4 * q);
    s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z), v.w);
  }
  v = ld4(sq + 4 * (kD / 4));
  static_assert(kD % 4 == 3, "the row's last float4 holds three features");
  return __fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z);
}

// the augmented domain's pair p of the unscaled row u: the xor of its two
// base features' comparisons with their thresholds (a NaN compares false)
__device__ __forceinline__ float pair_xor(const float* u, const int* idx, const float* thr, int p) {
  return (u[idx[2 * p]] >= thr[2 * p]) != (u[idx[2 * p + 1]] >= thr[2 * p + 1]) ? 1.0f : 0.0f;
}

// The smooth violations g of the unscaled row u and the cotangent of u into
// ct (zeroed by the caller), lcld_smooth_vjp's operations in its order;
// ct_cons is -w_cons for the optimised terms
__device__ __forceinline__ void lcld_terms_vjp(const float* u, float* ct, float tol, int ctr, float ct_cons, float* g) {
  auto x = [&](int k) { return u[k]; };
  auto add = [&](int k, float c) { ct[k] = __fadd_rn(ct[k], c); };
  // forward
  const float r = __fdiv_rn(x(2), 1200.0f);
  const float base = __fadd_rn(1.0f, r);
  const double b64 = base;
  const double t64 = x(1);
  const double g64 = pow_f64(b64, t64);
  const float growth = __double2float_rn(g64);
  const float d_base = __double2float_rn(t64 * pow_f64(b64, t64 - 1.0));
  const float d_t = __double2float_rn(log_f64(b64 == 0.0 ? 1.0 : b64) * g64);
  const float p1 = __fmul_rn(x(0), r);
  const float p2 = __fmul_rn(p1, growth);
  const float dn = __fsub_rn(growth, 1.0f);
  const float v1 = __fsub_rn(x(3), __fdiv_rn(p2, dn));
  const float a4 = __fsub_rn(36.0f, x(1));
  const float b4 = __fsub_rn(60.0f, x(1));
  const float v4 = __fmul_rn(a4, b4);
  const float v5 = __fsub_rn(x(20), __fdiv_rn(x(0), x(6)));
  const float v6 = __fsub_rn(x(21), __fdiv_rn(x(10), x(14)));
  const float v7 = __fsub_rn(x(22), __fsub_rn(lcld_months(x(7)), lcld_months(x(9))));
  const float v8 = __fsub_rn(x(23), __fdiv_rn(x(11), x(22)));
  const float v9 = __fsub_rn(x(24), __fdiv_rn(x(16), x(22)));
  const bool ok = x(11) != 0.0f;
  const float den10 = ok ? x(11) : 1.0f;
  const float q10 = ok ? __fdiv_rn(x(16), den10) : -1.0f;
  const bool fin10 = isfinite(q10);
  const float v10 = __fsub_rn(x(25), fin10 ? q10 : -1.0f);
  float pre[kTerms] = {
      __fsub_rn(__fsub_rn(fabsf(v1), static_cast<float>(0.099999)), tol),
      __fsub_rn(__fsub_rn(x(10), x(14)), tol),
      __fsub_rn(__fsub_rn(x(16), x(11)), tol),
      __fsub_rn(fabsf(v4), tol),
      __fsub_rn(fabsf(v5), tol),
      __fsub_rn(fabsf(v6), tol),
      __fsub_rn(fabsf(v7), tol),
      __fsub_rn(fabsf(v8), tol),
      __fsub_rn(fabsf(v9), tol),
      __fsub_rn(fabsf(v10), tol),
  };
  float c[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    g[k] = clip_smooth(pre[k]);
    c[k] = clip_vjp(pre[k], ctr < 0 || ctr == k ? ct_cons : 0.0f);
  }
  float c_num, c_den;
  // g1: |x3 - installment(x0, x1, x2)|
  float cv = abs_vjp(v1, c[0]);
  add(3, cv);
  float c_p2, c_dn;
  div_vjp(-cv, p2, dn, c_p2, c_dn);
  const float c_growth = __fadd_rn(__fmul_rn(c_p2, p1), c_dn);
  const float c_p1 = __fmul_rn(c_p2, growth);
  add(0, __fmul_rn(c_p1, r));
  add(2, __fdiv_rn(__fadd_rn(__fmul_rn(c_p1, x(0)), __fmul_rn(c_growth, d_base)), 1200.0f));
  add(1, __fmul_rn(c_growth, d_t));
  // g2, g3: differences
  add(10, c[1]);
  add(14, -c[1]);
  add(16, c[2]);
  add(11, -c[2]);
  // g4: |(36 - x1)(60 - x1)|
  cv = abs_vjp(v4, c[3]);
  add(1, -__fmul_rn(cv, b4));
  add(1, -__fmul_rn(cv, a4));
  // g5, g6: ratio equalities
  cv = abs_vjp(v5, c[4]);
  add(20, cv);
  div_vjp(-cv, x(0), x(6), c_num, c_den);
  add(0, c_num);
  add(6, c_den);
  cv = abs_vjp(v6, c[5]);
  add(21, cv);
  div_vjp(-cv, x(10), x(14), c_num, c_den);
  add(10, c_num);
  add(14, c_den);
  // g7: month count, derivative 1
  cv = abs_vjp(v7, c[6]);
  add(22, cv);
  add(7, -cv);
  add(9, -(-cv));
  // g8, g9: ratios over x22
  cv = abs_vjp(v8, c[7]);
  add(23, cv);
  div_vjp(-cv, x(11), x(22), c_num, c_den);
  add(11, c_num);
  add(22, c_den);
  cv = abs_vjp(v9, c[8]);
  add(24, cv);
  div_vjp(-cv, x(16), x(22), c_num, c_den);
  add(16, c_num);
  add(22, c_den);
  // g10: x16 / x11 with the -1 sentinel; a where passes 0 to the branch it
  // did not take
  cv = abs_vjp(v10, c[9]);
  add(25, cv);
  div_vjp(ok ? (fin10 ? -cv : 0.0f) : 0.0f, x(16), den10, c_num, c_den);
  add(16, c_num);
  add(11, ok ? c_den : 0.0f);
}

// LcldConstraints.repair's first part on the unscaled row u: term snapped
// to {36, 60}, the installment recomputed
__device__ __forceinline__ void repair_installment(float* u) {
  const float term = u[1] < 48.0f ? 36.0f : 60.0f;
  u[1] = term;
  const float r = __fdiv_rn(u[2], 1200.0f);
  const float growth = __double2float_rn(
      pow_f64(static_cast<double>(__fadd_rn(1.0f, r)), static_cast<double>(term)));
  u[3] = __fdiv_rn(__fmul_rn(__fmul_rn(u[0], r), growth), __fsub_rn(growth, 1.0f));
}

// its second: one one-hot group (`slots` features, -1 after them) set to
// its first largest slot, a NaN counting as the largest; the slots are read
// kChunk at a time, so that their loads are in flight together
__device__ __forceinline__ void repair_group(const int* slot, int slots, float* u) {
  constexpr int kChunk = 8;
  int best = 0;
  float bv = u[slot[0]];
  for (int j0 = 1; j0 < slots; j0 += kChunk) {
    int f[kChunk];
    float v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) f[q] = j0 + q < slots ? slot[j0 + q] : -1;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) v[q] = f[q] >= 0 ? u[f[q]] : 0.0f;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (f[q] >= 0 && (v[q] > bv || (isnan(v[q]) && !isnan(bv)))) {
        best = j0 + q;
        bv = v[q];
      }
    }
  }
  for (int j0 = 0; j0 < slots; j0 += kChunk) {
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int f = j0 + q < slots ? slot[j0 + q] : -1;
      if (f >= 0) u[f] = j0 + q == best ? 1.0f : 0.0f;
    }
  }
}

#ifdef K7_STAMPS
// tools/probe_pgd_lcld.py's breakdown: per phase, the clock64() cycles of
// block 0's thread 0 (a stack warp) and of the terms warp's lane 0, summed
// over the iterations. A warp that waits at a barrier may read the
// clock before it blocks (BAR.SYNC.DEFER_BLOCKING): its wait then lands in
// its next phase
constexpr int kPhases = 11;
constexpr int kStampedWarps = 2;
__device__ unsigned long long k7_cycles[kStampedWarps][kPhases];
#endif

struct Stamps {
#ifdef K7_STAMPS
  long long last = 0;
  unsigned long long cycles[kPhases] = {};
  __device__ __forceinline__ void begin() { last = clock64(); }
  __device__ __forceinline__ void operator()(int i) {
    const long long now = clock64();
    cycles[i] += now - last;
    last = now;
  }
  __device__ __forceinline__ void flush(int tid) {
    const int slot = tid == 0 ? 0 : (tid == kTermsTid ? 1 : -1);
    if (blockIdx.x == 0 && slot >= 0)
      for (int i = 0; i < kPhases; ++i) k7_cycles[slot][i] = cycles[i];
  }
#else
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void operator()(int) {}
  __device__ __forceinline__ void flush(int) {}
#endif
};

// kPairs: the augmented domain, D = 47 + P features (a run-time value, with
// the row stride) and 10 + P terms; else D = kD and the pair stage is
// compiled out
// row r's L2 projection factor min(1, eps / (||CU's row|| + 1e-12)), CU
// holding the squares of its perturbation
template <bool kPairs>
__device__ __forceinline__ float projection_factor(const float* cu, int d, float eps) {
  return nan_min(1.0f, __fdiv_rn(eps, __fadd_rn(__fsqrt_rn(row_sum<kPairs>(cu, d)), 1e-12f)));
}

// kAuto: AutoPGD, whose launch runs 2T + 2 passes (see the design note);
// else PGD
template <bool kPairs, bool kAuto>
__global__ void __launch_bounds__(kThreads) pgd_lcld_kernel(const PgdArgs a, const PgdLayout lay) {
  extern __shared__ __align__(16) float smem[];
  const int D = kPairs ? a.d : kD;
  const int RS = kPairs ? lay.rs : kRS;
  const int P = kPairs ? a.n_pairs : 0;
  const int NT = kTerms + P;
  float* ws = smem;                             // the staged stack
  float* sc = ws + lay.w_floats;                // (RS) scale
  float* mn = sc + RS;                          // (RS) min_
  int* mut = reinterpret_cast<int*>(mn + RS);   // (RS) mutable
  int* ohe = mut + RS;                          // (groups, slots)
  int* pidx = ohe + lay.ohe_ints;               // (P, 2) the pairs' base features
  float* pthr = reinterpret_cast<float*>(pidx + 2 * P);  // (P, 2) their thresholds
  float* rows = reinterpret_cast<float*>(ohe + lay.ohe_ints + (kPairs ? lay.pair_ints : 0));
  const int rp = lay.rows_pad;
  float* X = rows;             // (rp, RS) the iterates
  float* XI = X + rp * RS;     // x_init
  float* U = XI + rp * RS;     // unscaled rows; the perturbation; repair's buffer
  float* CU = U + rp * RS;     // the terms' cotangent of U; then the squares of the L2 sums
  float* G = CU + rp * RS;     // the masked gradient
  float* SQR = G + rp * RS;    // squares of the raw gradient's finite entries
  float* XP = SQR + rp * RS;                // kAuto: x_prev
  float* XB = XP + (kAuto ? rp * RS : 0);   // x_best
  float* ACT = XB + (kAuto ? rp * RS : 0);  // hidden activations (act_off)
  float* CTA = ACT + lay.ct_off;      // cotangents, ping (rp, ct_st)
  float* CTB = CTA + rp * lay.ct_st;  // and pong
  float* LC = CTB + rp * lay.ct_st;  // (rp) each row's class loss
  float* CONS = LC + rp;             // (rp) its constraint loss
  float* NRM = CONS + rp;            // (rp) its gradient's L2 norm + 1e-7
  float* FAC = NRM + rp;             // (rp) its projection factor
  float* GV = FAC + rp;              // (rp, NT + 1) its violations
  // kAuto, (rp) each: the best tracking loss, the previous iteration's, the
  // best at the last checkpoint, the step, the step at the last checkpoint,
  // the rises since the last checkpoint, and what the pass's copies do
  // (1: x_best takes x, 2: x restarts from x_best)
  float* FBEST = GV + rp * (NT + 1);
  float* FPREV = FBEST + rp;
  float* FBCK = FPREV + rp;
  float* ETA = FBCK + rp;
  float* ETACK = ETA + rp;
  float* IMPR = ETACK + rp;
  int* MOVE = reinterpret_cast<int*>(IMPR + rp);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * lay.rows;
  const int nr = min(lay.rows, a.n - row0);  // rows of this block; the others repeat its last

  {
    const float* p = a.params;
    for (int l = 0; l < a.n_layers; ++l) {
      const int in_w = a.widths[l];
      const int out_w = a.widths[l + 1];
      float* w = ws + lay.w_off[l];
      const int st = lay.w_st[l];
      for (int e = tid; e < out_w * in_w; e += kThreads) w[(e / in_w) * st + e % in_w] = p[e];
      p += out_w * in_w;
      for (int o = tid; o < out_w; o += kThreads) ws[lay.b_off[l] + o] = p[o];
      p += out_w;
    }
    for (int k = tid; k < RS; k += kThreads) {
      sc[k] = k < D ? a.scale[k] : 1.0f;
      mn[k] = k < D ? a.min_[k] : 0.0f;
      mut[k] = k < D ? static_cast<int>(a.mutable_[k]) : 0;
    }
    for (int e = tid; e < a.n_groups * a.group_slots; e += kThreads) ohe[e] = a.ohe[e];
    if constexpr (kPairs) {
      for (int e = tid; e < 2 * P; e += kThreads) {
        pidx[e] = a.pair_idx[e];
        pthr[e] = a.pair_thr[e];
      }
    }
  }
  // repair runs its installment and its one-hot groups side by side where
  // they touch distinct features (LCLD's schema: the groups hold features
  // 26-46); else one row at a time, in LcldConstraints.repair's order
  int* seen = reinterpret_cast<int*>(G);
  for (int k = tid; k < D; k += kThreads) seen[k] = 0;
  __syncthreads();
  bool disjoint = true;
  for (int e = tid; e < a.n_groups * a.group_slots; e += kThreads) {
    const int f = a.ohe[e];
    if (f >= 0) disjoint = disjoint && f >= 4 && f < D && atomicAdd(seen + f, 1) == 0;
  }
  const bool parallel_repair = __syncthreads_and(disjoint);
  for (int e = tid; e < rp * D; e += kThreads) {
    const int r = e / D;
    const int k = e - r * D;
    const size_t at = static_cast<size_t>(row0 + min(r, nr - 1)) * D + k;
    const float x = a.x_start[at];
    X[r * RS + k] = x;
    if constexpr (kAuto) {
      XP[r * RS + k] = x;
      XB[r * RS + k] = x;
    }
    XI[r * RS + k] = a.x_init[at];
    U[r * RS + k] = unscale(x, mn[k], sc[k]);
  }
  // the head's thread of row tid holds its label
  const int yv = tid < rp ? static_cast<int>(a.y[row0 + min(tid, nr - 1)]) : 0;
  const int classes = a.widths[a.n_layers];
  const bool linf = a.flags & 1;
  const bool repair = a.flags & 2;
  const bool targeted = a.flags & 4;
  const bool hist_norm = a.hist != nullptr && (a.flags & 8);
  const bool hist_full = a.hist != nullptr && (a.flags & 16);
  const int g_col = (a.flags & 8) ? 4 : 3;
  __syncthreads();

  Stamps stamp;
  stamp.begin();
  // the iterations, then (last) the class at x_adv. kAuto: pass it = 0 is
  // the tracking loss at x_start, 2i + 1 iteration i's gradient and step,
  // 2i + 2 (track) its tracking loss at x_new, the best point and the
  // checkpoint, and 2T + 1 the class at x_best
  for (int it = 0;; ++it) {
    const int i = kAuto ? (it - 1) >> 1 : it;
    const bool last = it == (kAuto ? 2 * a.t + 1 : a.t);
    const bool track = kAuto && !last && !(it & 1);
    const float wc = last || track ? 0.0f : a.w_class[i];
    const float wk = last || track ? 0.0f : a.w_cons[i];
    const float stp = last || kAuto ? 0.0f : a.step[i];
    const int ctr = last ? 0 : (track ? a.tctr : a.ctr[i]);
    const float alpha = kAuto && i > 0 ? a.alpha : 1.0f;
    float* cur = CTA;
    if (tid >= kTermsTid && last) {
      break;
    } else if (tid >= kTermsTid) {
      // the terms warp: row r's ten terms and their backward, then on the
      // augmented domain its pairs' terms, each pair's cotangent to its
      // augmented column from 0 (no base term reaches those columns)
      const int r = tid - kTermsTid;
      if (r < rp) {
        float ct[kD + 1] = {};
        float g[kTerms];
        lcld_terms_vjp(U + r * RS, ct, a.tol, ctr, -wk, g);
        if (!track) {
#pragma unroll
          for (int q = 0; q < (kD + 1) / 4; ++q)
            *reinterpret_cast<float4*>(CU + r * RS + 4 * q) = make_float4(ct[4 * q], ct[4 * q + 1], ct[4 * q + 2],
                                                                          ct[4 * q + 3]);
        }
        float cons = g[0];
#pragma unroll
        for (int k = 1; k < kTerms; ++k) cons = __fadd_rn(cons, g[k]);
        // the optimised term, picked without indexing g at run time (which
        // would put g in local memory)
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          if (k == ctr) cons = g[k];
        if (!track) {
#pragma unroll
          for (int k = 0; k < kTerms; ++k) GV[r * (NT + 1) + k] = g[k];
        }
        if constexpr (kPairs) {
          // cons goes on as the running sum, or picks the optimised pair
          const float* u = U + r * RS;
          for (int p = 0; p < P; ++p) {
            const int col = D - P + p;
            const float v = __fsub_rn(u[col], pair_xor(u, pidx, pthr, p));
            const float pre = __fsub_rn(fabsf(v), a.tol);
            const float gp = clip_smooth(pre);
            if (!track) {
              CU[r * RS + col] = __fadd_rn(0.0f, abs_vjp(v, clip_vjp(pre, ctr < 0 || ctr == kTerms + p ? -wk : 0.0f)));
              GV[r * (NT + 1) + kTerms + p] = gp;
            }
            cons = ctr < 0 ? __fadd_rn(cons, gp) : (ctr == kTerms + p ? gp : cons);
          }
        }
        CONS[r] = cons;
      }
      stamp(0);
    } else {
      int in_st;
      const float* in = hidden_forward(a, lay, ws, X, RS, ACT, tid, in_st);
      stamp(0);
      // the head and the cross-entropy, one row per thread; after the last
      // iteration, the class at x_adv: mlp_proba_plain's probabilities, the
      // first largest
      if (tid < rp) {
        float lg[2], ct[2];
        head_logits(a, lay, ws, in + tid * in_st, lg);
        if (last) {
          if (tid < nr) a.pred[row0 + tid] = predicted_class(classes, lg);
        } else {
          LC[tid] = cross_entropy(classes, targeted, lg, yv, wc, ct);
          if (!track) {
            CTA[tid * lay.ct_st] = ct[0];
            if (classes == 2) CTA[tid * lay.ct_st + 1] = ct[1];
          }
        }
      }
      if (last) break;
      if (!track) {
        mlp_sync();
        stamp(1);
        // the hidden layers' backward, from the head's down to layer 1's
        for (int l = a.n_layers - 1; l >= 1; --l) {
          float* nxt = cur == CTA ? CTB : CTA;
          const float* h = ACT + lay.act_off[l - 1];
          const int h_st = lay.act_st[l - 1];
          const int ct_st = lay.ct_st;
          backward_tiles<kTile, kTile>(ws + lay.w_off[l], lay.w_st[l], a.widths[l], a.widths[l + 1], cur, ct_st, rp,
                                       tid, kMlpThreads, [&](int r, int k, float v) {
                                         nxt[r * ct_st + k] = h[r * h_st + k] > 0.0f ? v : 0.0f;
                                       });
          mlp_sync();
          cur = nxt;
        }
        stamp(2);
      }
    }
    __syncthreads();  // the terms' cotangents are in CU
    stamp(3);
    if constexpr (kAuto) {
      if (track) {
        // the tracking loss at x (x_start, then x_new), one thread per row:
        // the first pass sets the state; later ones the rises, the best
        // point and, at a checkpoint, the halving
        if (tid < rp) {
          const float f = __fadd_rn(__fmul_rn(a.tw_class, LC[tid]), __fmul_rn(a.tw_cons, -CONS[tid]));
          int move = it == 2 * a.t ? 2 : 0;  // after the last iteration x takes x_best for the class
          if (it == 0) {
            FBEST[tid] = f;
            FPREV[tid] = f;
            FBCK[tid] = f;
            ETA[tid] = a.eta0;
            ETACK[tid] = a.eta0;
            IMPR[tid] = 0.0f;
          } else {
            const int c = it >> 1;  // i + 1 of the iteration just run
            const float impr = __fadd_rn(IMPR[tid], f > FPREV[tid] ? 1.0f : 0.0f);
            const bool better = f > FBEST[tid];
            const float fb = better ? f : FBEST[tid];
            const float eta = ETA[tid];
            const bool ck = a.is_ckpt[c];
            const bool halve = ck && (impr < a.ckpt_thr[c] || (ETACK[tid] == eta && FBCK[tid] == fb));
            const float eta_next = halve ? __fmul_rn(eta, 0.5f) : eta;
            FBEST[tid] = fb;
            FPREV[tid] = f;
            ETA[tid] = eta_next;
            IMPR[tid] = ck ? 0.0f : impr;
            if (ck) {
              ETACK[tid] = eta_next;
              FBCK[tid] = fb;
            }
            move |= (better ? 1 : 0) | (halve ? 2 : 0);
          }
          MOVE[tid] = move;
        }
        __syncthreads();
        for (int e = tid; e < rp * D; e += kThreads) {
          const int r = e / D;
          const int k = e - r * D;
          const int at = r * RS + k;
          const int move = MOVE[r];
          if (move & 1) XB[at] = X[at];
          if (move & 2) {
            const float xb = XB[at];
            X[at] = xb;
            U[at] = unscale(xb, mn[k], sc[k]);
          }
        }
        __syncthreads();
        continue;
      }
    }
    // the input backward, into G
    if (tid < kMlpThreads)
      backward_tiles<kTile, kTile>(ws + lay.w_off[0], lay.w_st[0], D, a.widths[1], cur, lay.ct_st, rp, tid,
                                   kMlpThreads, [&](int r, int k, float v) { G[r * RS + k] = v; });
    __syncthreads();
    // the gradient with the terms' cotangent: NaN zeroed, masked; under
    // L-inf the step, the projection and the clip too
    for (int e = tid; e < rp * D; e += kThreads) {
      const int r = e / D;
      const int k = e - r * D;
      const int at = r * RS + k;
      const float gv = __fadd_rn(G[at], div_rn(CU[at], sc[k]));
      if (hist_norm) {
        const float f = isfinite(gv) ? gv : 0.0f;
        SQR[at] = __fmul_rn(f, f);
      }
      const float gm = isnan(gv) || !mut[k] ? 0.0f : gv;
      if (linf) {
        const float d = gm > 0.0f ? 1.0f : (gm < 0.0f ? -1.0f : (gm == 0.0f ? 0.0f : gm));
        if constexpr (kAuto) {
          // z, then the momentum, each clipped, projected and clipped; x_prev takes x
          const float x = X[at];
          const float xi = XI[at];
          float z = clamp_nan(__fadd_rn(x, __fmul_rn(ETA[r], d)), a.lo, a.hi);
          z = clamp_nan(__fadd_rn(xi, clamp_nan(__fsub_rn(z, xi), -a.eps, a.eps)), a.lo, a.hi);
          float xn = clamp_nan(momentum(x, z, XP[at], alpha), a.lo, a.hi);
          xn = clamp_nan(__fadd_rn(xi, clamp_nan(__fsub_rn(xn, xi), -a.eps, a.eps)), a.lo, a.hi);
          XP[at] = x;
          X[at] = xn;
          U[at] = unscale(xn, mn[k], sc[k]);
        } else {
          const float x = clamp_nan(__fadd_rn(X[at], __fmul_rn(stp, d)), a.lo, a.hi);
          const float du = __fsub_rn(x, XI[at]);
          const float xn = clamp_nan(__fadd_rn(XI[at], clamp_nan(du, -a.eps, a.eps)), a.lo, a.hi);
          X[at] = xn;
          U[at] = unscale(xn, mn[k], sc[k]);
        }
      } else {
        G[at] = gm;
        CU[at] = __fmul_rn(gm, gm);
      }
    }
    __syncthreads();
    stamp(4);
    // the history and the gradient's L2 norm, one row per thread
    if (a.hist != nullptr || !linf) {
      if (tid < rp) {
        const int r = tid;
        if (a.hist != nullptr && r < nr) {
          float* h = a.hist + (static_cast<size_t>(i) * a.n + row0 + r) * a.hist_cols;
          const float lc = LC[r];
          const float cons = CONS[r];
          h[0] = __fadd_rn(__fmul_rn(wc, lc), __fmul_rn(wk, -cons));
          h[1] = lc;
          h[2] = cons;
          if (hist_full)
            for (int k = 0; k < NT; ++k) h[g_col + k] = GV[r * (NT + 1) + k];
        }
        if (!linf) NRM[r] = __fadd_rn(__fsqrt_rn(row_sum<kPairs>(CU + r * RS, D)), 1e-7f);
      } else if (hist_norm && tid >= 32 && tid < 32 + nr) {
        const int r = tid - 32;
        a.hist[(static_cast<size_t>(i) * a.n + row0 + r) * a.hist_cols + 3] = __fsqrt_rn(row_sum<kPairs>(SQR + r * RS, D));
      }
      __syncthreads();
    }
    stamp(5);
    if (!linf) {
      // the step and the clip; the perturbation into U, its squares into CU
      for (int e = tid; e < rp * D; e += kThreads) {
        const int r = e / D;
        const int at = e + r * (RS - D);
        const float x = clamp_nan(__fadd_rn(X[at], __fmul_rn(kAuto ? ETA[r] : stp, div_rn(G[at], NRM[r]))), a.lo, a.hi);
        const float du = __fsub_rn(x, XI[at]);
        U[at] = du;
        CU[at] = __fmul_rn(du, du);
      }
      __syncthreads();
      stamp(6);
      if (tid < rp) FAC[tid] = projection_factor<kPairs>(CU + tid * RS, D, a.eps);
      __syncthreads();
      stamp(7);
      if constexpr (kAuto) {
        // z projected and clipped, then the momentum clipped: its
        // perturbation into U, its squares into CU; x_prev takes x
        for (int e = tid; e < rp * D; e += kThreads) {
          const int r = e / D;
          const int at = e + r * (RS - D);
          const float x = X[at];
          const float xi = XI[at];
          const float z = clamp_nan(__fadd_rn(xi, __fmul_rn(U[at], FAC[r])), a.lo, a.hi);
          const float du = __fsub_rn(clamp_nan(momentum(x, z, XP[at], alpha), a.lo, a.hi), xi);
          XP[at] = x;
          U[at] = du;
          CU[at] = __fmul_rn(du, du);
        }
        __syncthreads();
        if (tid < rp) FAC[tid] = projection_factor<kPairs>(CU + tid * RS, D, a.eps);
        __syncthreads();
      }
      // the projection and the clip
      for (int e = tid; e < rp * D; e += kThreads) {
        const int r = e / D;
        const int k = e - r * D;
        const int at = r * RS + k;
        const float x = clamp_nan(__fadd_rn(XI[at], __fmul_rn(U[at], FAC[r])), a.lo, a.hi);
        X[at] = x;
        U[at] = unscale(x, mn[k], sc[k]);
      }
      __syncthreads();
      stamp(8);
    }
    if (repair) {
      if (parallel_repair) {
        // each row's installment, then each of its groups, side by side
        for (int task = tid; task < rp * (1 + a.n_groups); task += kThreads) {
          const int part = task / rp;
          float* u = U + (task - part * rp) * RS;
          if (part == 0)
            repair_installment(u);
          else
            repair_group(ohe + (part - 1) * a.group_slots, a.group_slots, u);
        }
      } else if (tid < rp) {
        float* u = U + tid * RS;
        repair_installment(u);
        for (int gi = 0; gi < a.n_groups; ++gi) repair_group(ohe + gi * a.group_slots, a.group_slots, u);
      }
      __syncthreads();
      if constexpr (kPairs) {
        // each pair's augmented feature re-derived from the repaired base,
        // its immutable features included: pgd_run_plain's repair re-derives
        // them from the whole repaired row before it keeps x where immutable
        for (int task = tid; task < rp * P; task += kThreads) {
          const int r = task / P;
          const int p = task - r * P;
          float* u = U + r * RS;
          u[D - P + p] = pair_xor(u, pidx, pthr, p);
        }
        __syncthreads();
      }
      stamp(9);
      // back to scaled space where mutable; an immutable feature keeps its
      // unrepaired x, and u is unscaled from x again on every feature, as
      // pgd_run_plain's next iteration takes it
      for (int e = tid; e < rp * D; e += kThreads) {
        const int r = e / D;
        const int k = e - r * D;
        const int at = r * RS + k;
        if (mut[k]) {
          const float x = __fadd_rn(__fmul_rn(U[at], sc[k]), mn[k]);
          X[at] = x;
          U[at] = unscale(x, mn[k], sc[k]);
        } else {
          U[at] = unscale(X[at], mn[k], sc[k]);
        }
      }
      __syncthreads();
      stamp(10);
    }
  }
  stamp.flush(tid);

  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D;
    a.x_adv[static_cast<size_t>(row0) * D + e] = X[r * RS + (e - r * D)];
  }
  if constexpr (kAuto) {
    if (tid < nr) a.eta[row0 + tid] = ETA[tid];
  }
}

size_t pgd_smem_bytes(const PgdLayout& lay) {
  return sizeof(float) * (static_cast<size_t>(lay.w_floats) + 3 * lay.rs + lay.ohe_ints + lay.pair_ints +
                          lay.row_floats);
}

}  // namespace

cudaError_t launch_pgd_lcld(const PgdArgs& args, cudaStream_t stream) {
  if (args.n == 0) return cudaSuccess;
  if (args.n < 0 || args.t < 0 || args.n_layers < 1 || args.n_layers > kObjectiveMaxLayers ||
      args.n_pairs < 0 || args.n_pairs > kLcldMaxPairs || args.d != kD + args.n_pairs ||
      (args.n_pairs > 0 && (args.pair_idx == nullptr || args.pair_thr == nullptr)) ||
      args.widths[0] != args.d || args.widths[args.n_layers] < 1 || args.widths[args.n_layers] > 2 ||
      args.n_groups < 0 || args.group_slots < 1 || args.n_groups * args.group_slots > kPgdMaxOheSlots)
    return cudaErrorInvalidValue;
  const bool autopgd = args.flags & 32;
  if (autopgd && (args.is_ckpt == nullptr || args.ckpt_thr == nullptr || args.eta == nullptr))
    return cudaErrorInvalidValue;
  PgdLayout lay{};
  lay.rs = odd_stride(args.d);
  lay.pair_ints = 4 * args.n_pairs;
  int act_floats = 0, widest = 1;
  for (int l = 0; l < args.n_layers; ++l) {
    const int in_w = args.widths[l];
    const int out_w = args.widths[l + 1];
    if (out_w < 1 || out_w > kObjectiveMaxWidth) return cudaErrorInvalidValue;
    lay.w_st[l] = odd_stride(in_w);
    lay.w_off[l] = lay.w_floats;
    lay.w_floats += out_w * lay.w_st[l];
    lay.b_off[l] = lay.w_floats;
    lay.w_floats += (out_w + 3) & ~3;
    if (l + 1 < args.n_layers) {
      lay.act_st[l] = odd_stride(out_w);
      act_floats += lay.act_st[l];
    }
    widest = widest > out_w ? widest : out_w;
  }
  lay.ct_st = odd_stride(widest);
  lay.ohe_ints = (args.n_groups * args.group_slots + 3) & ~3;
  static LaunchCache cache;
  int sms = 0;
  cudaError_t err = cache.sm_count(&sms);
  if (err != cudaSuccess) return err;
  // one block on each SM
  int rows = (args.n + sms - 1) / sms;
  rows = rows < 1 ? 1 : (rows > kPgdMaxRows ? kPgdMaxRows : rows);
  for (;; --rows) {
    lay.rows = rows;
    lay.rows_pad = (rows + kTile - 1) / kTile * kTile;
    // six feature buffers, the activations, two of cotangents, 4 + the
    // terms + 1 scalars per row; AutoPGD's two buffers and 7 scalars
    lay.row_floats = lay.rows_pad * (6 * lay.rs + act_floats + 2 * lay.ct_st + 4 + kTerms + args.n_pairs + 1 +
                                     (autopgd ? 2 * lay.rs + 7 : 0));
    if (pgd_smem_bytes(lay) <= kMaxSharedBytes) break;
    if (rows == 1) return cudaErrorInvalidValue;
  }
  int off = 0;
  for (int l = 0; l + 1 < args.n_layers; ++l) {
    lay.act_off[l] = off;
    off += lay.rows_pad * lay.act_st[l];
  }
  lay.ct_off = off;
  const size_t smem = pgd_smem_bytes(lay);
  const int grid = (args.n + rows - 1) / rows;
  if (autopgd && args.n_pairs > 0) {
    static LaunchCache aug_auto_cache;
    err = aug_auto_cache.prepare(reinterpret_cast<const void*>(pgd_lcld_kernel<true, true>), kThreads, smem, nullptr);
    if (err != cudaSuccess) return err;
    pgd_lcld_kernel<true, true><<<grid, kThreads, smem, stream>>>(args, lay);
  } else if (autopgd) {
    static LaunchCache auto_cache;
    err = auto_cache.prepare(reinterpret_cast<const void*>(pgd_lcld_kernel<false, true>), kThreads, smem, nullptr);
    if (err != cudaSuccess) return err;
    pgd_lcld_kernel<false, true><<<grid, kThreads, smem, stream>>>(args, lay);
  } else if (args.n_pairs > 0) {
    static LaunchCache aug_cache;
    err = aug_cache.prepare(reinterpret_cast<const void*>(pgd_lcld_kernel<true, false>), kThreads, smem, nullptr);
    if (err != cudaSuccess) return err;
    pgd_lcld_kernel<true, false><<<grid, kThreads, smem, stream>>>(args, lay);
  } else {
    err = cache.prepare(reinterpret_cast<const void*>(pgd_lcld_kernel<false, false>), kThreads, smem, nullptr);
    if (err != cudaSuccess) return err;
    pgd_lcld_kernel<false, false><<<grid, kThreads, smem, stream>>>(args, lay);
  }
  return cudaGetLastError();
}

#ifdef K7_STAMPS
extern "C" const char* k7_phase_names() {
  return "terms, or the hidden layers' forward;head and cross-entropy;hidden layers' backward;wait for the terms;"
         "input backward and gradient;history and gradient norm;step;projection factor;projection;repair;"
         "repair's round trip";
}

// the warps whose stamps k7_take_cycles returns: thread 0's, then the terms
// warp's lane 0
extern "C" int k7_stamped_warps() { return kStampedWarps; }

// copies K7's per-phase cycles to `out` (kStampedWarps x kPhases values)
// and zeroes them
extern "C" int k7_take_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k7_cycles, sizeof(k7_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[kStampedWarps][kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k7_cycles, zero, sizeof(zero)));
}
#endif
