// K7: constrained PGD on the LCLD domain, every iteration of one run in one
// launch.
//
// Replaces the jnp device program of moeva2_ijcai22_replication_tpu/attacks/
// pgd/engine.py::ConstrainedPGD._one_run (its lax.fori_loop) with what each
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
//   slot (a NaN counts as the largest), then back to scaled space for the
//   mutable features;
// - the class at x_adv as engine.py::predict_plain (mlp_proba_plain's
//   softmax, the first largest probability).
//
// Bound: per row and iteration the stack's forward and its input backward
// are 2 x 5,600 multiply-adds for 47-64-32-16-2, plus ~300 operations for
// the terms, their backward and the step: about 23k fp32 operations on 190
// bytes of the row read once and written once. Bound by operations. Tensor
// cores are not used (their sums have an order no CPU code reproduces), and
// without FMA a multiply-add is two instructions.
//
// Design (a simple one first): one warp per row, kPgdRowsPerBlock rows per
// block; rows are independent, so each warp runs its row's whole T-iteration
// loop with no block barrier after staging. The block stages the stack once
// in shared memory, each layer's weight (out, in) with rows padded to an odd
// stride, so that lanes owning outputs (forward) and lanes owning inputs
// (backward) both read distinct banks; the scaler, the mutable mask and the
// one-hot table beside it. Each warp keeps its row, activations, cotangents
// and gradient in its own shared-memory slice. Lanes own output units in the
// forward and input units in the backward (up to 4 per lane); lane 0 runs
// the scalar chains that have one order: the cross-entropy, the ten terms
// and their backward, the left-to-right sums and the repair.

#include "pgd_common.cuh"

namespace {

constexpr int kD = kLcldFeatures;
constexpr int kDP = 48;  // a row's features, padded
constexpr int kTerms = 10;
constexpr int kUnitsPerLane = (kObjectiveMaxWidth + 31) / 32;

struct PgdLayout {
  int w_off[kObjectiveMaxLayers];  // each layer's staged weight; its bias follows
  int w_floats;                    // the staged stack
  int ohe_ints;                    // the one-hot table, padded to 4
  int act_floats;                  // a warp's activations: the widths of layers 1..L
  int max_width;                   // the widest layer (and the input)
  int warp_floats;                 // a warp's slice
};

// the relu stack on the warp's row `in` (47 floats); activations of layers
// 1..L, logits last, into `act`
__device__ __forceinline__ void mlp_forward(const PgdArgs& a, const PgdLayout& lay, const float* ws, const float* in,
                            float* act, int lane) {
  float* out = act;
  for (int l = 0; l < a.n_layers; ++l) {
    const int in_w = a.widths[l];
    const int out_w = a.widths[l + 1];
    const int st = padded_stride(in_w);
    const float* w = ws + lay.w_off[l];
    const float* bias = w + out_w * st;
    float acc[kUnitsPerLane];
#pragma unroll
    for (int j = 0; j < kUnitsPerLane; ++j) {
      const int o = lane + 32 * j;
      acc[j] = o < out_w ? bias[o] : 0.0f;
    }
    for (int k = 0; k < in_w; ++k) {
      const float ak = in[k];
#pragma unroll
      for (int j = 0; j < kUnitsPerLane; ++j) {
        const int o = lane + 32 * j;
        if (o < out_w) acc[j] = __fadd_rn(acc[j], __fmul_rn(ak, w[o * st + k]));
      }
    }
    const bool hidden = l + 1 < a.n_layers;
#pragma unroll
    for (int j = 0; j < kUnitsPerLane; ++j) {
      const int o = lane + 32 * j;
      if (o < out_w) out[o] = hidden ? relu_keep_nan(acc[j]) : acc[j];
    }
    __syncwarp();
    in = out;
    out += out_w;
  }
}

// the cotangent of the input row (47 floats, into `ct_x`) from that of the
// logits (in `ct_a`); `ct_b` is scratch of the widest layer
__device__ __forceinline__ void mlp_backward(const PgdArgs& a, const PgdLayout& lay, const float* ws, const float* act,
                             float* ct_a, float* ct_b, float* ct_x, int lane) {
  // the output of layer l (the input of layer l + 1) starts at h
  const float* h = act + lay.act_floats - a.widths[a.n_layers];
  float* cur = ct_a;
  float* nxt = ct_b;
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const int in_w = a.widths[l];
    const int out_w = a.widths[l + 1];
    const int st = padded_stride(in_w);
    const float* w = ws + lay.w_off[l];
    float* dst = l == 0 ? ct_x : nxt;
    // the input of layer l is the output of layer l - 1 (hidden): its
    // cotangent passes where that output is > 0
    h = l > 0 ? h - in_w : nullptr;
#pragma unroll
    for (int j = 0; j < kUnitsPerLane; ++j) {
      const int k = lane + 32 * j;
      if (k < in_w) {
        float acc = __fmul_rn(cur[0], w[k]);
        for (int o = 1; o < out_w; ++o) acc = __fadd_rn(acc, __fmul_rn(cur[o], w[o * st + k]));
        dst[k] = h == nullptr || h[k] > 0.0f ? acc : 0.0f;
      }
    }
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// Lane 0: the smooth violations g of the unscaled row u and the cotangent
// of u into ct (zeroed by the caller), lcld_smooth_vjp's operations in its
// order; ct_g[k] is -w_cons for the optimised terms and 0 for the others
__device__ __forceinline__ void lcld_terms_vjp(const float* u, float* ct, float tol, int ctr, float ct_cons, float* g) {
  auto x = [&](int k) { return u[k]; };
  auto add = [&](int k, float c) { ct[k] = __fadd_rn(ct[k], c); };
  // forward
  const float r = __fdiv_rn(x(2), 1200.0f);
  const float base = __fadd_rn(1.0f, r);
  const double b64 = base;
  const double t64 = x(1);
  const double g64 = pow(b64, t64);
  const float growth = __double2float_rn(g64);
  const float d_base = __double2float_rn(t64 * pow(b64, t64 - 1.0));
  const float d_t = __double2float_rn(log(b64 == 0.0 ? 1.0 : b64) * g64);
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

// Lane 0: LcldConstraints.repair of the unscaled row u, in place
__device__ __forceinline__ void lcld_repair(const PgdArgs& a, const int* ohe, float* u) {
  const float term = u[1] < 48.0f ? 36.0f : 60.0f;
  u[1] = term;
  const float r = __fdiv_rn(u[2], 1200.0f);
  const float growth = __double2float_rn(
      pow(static_cast<double>(__fadd_rn(1.0f, r)), static_cast<double>(term)));
  u[3] = __fdiv_rn(__fmul_rn(__fmul_rn(u[0], r), growth), __fsub_rn(growth, 1.0f));
  for (int gi = 0; gi < a.n_groups; ++gi) {
    const int* slot = ohe + gi * a.group_slots;
    int best = 0;
    float bv = u[slot[0]];
    for (int j = 1; j < a.group_slots; ++j) {
      if (slot[j] < 0) continue;
      const float v = u[slot[j]];
      if (v > bv || (isnan(v) && !isnan(bv))) {
        best = j;
        bv = v;
      }
    }
    for (int j = 0; j < a.group_slots; ++j)
      if (slot[j] >= 0) u[slot[j]] = j == best ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kPgdRowsPerBlock * 32)
pgd_lcld_kernel(const PgdArgs a, const PgdLayout lay) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                    // the staged stack
  float* sc = ws + lay.w_floats;                       // (48) scale
  float* mn = sc + kDP;                                // (48) min_
  int* mut = reinterpret_cast<int*>(mn + kDP);         // (48) mutable
  int* ohe = mut + kDP;                                // (groups, slots)
  float* rows = reinterpret_cast<float*>(ohe + lay.ohe_ints);
  const int tid = threadIdx.x;

  {
    const float* p = a.params;
    for (int l = 0; l < a.n_layers; ++l) {
      const int in_w = a.widths[l];
      const int out_w = a.widths[l + 1];
      const int st = padded_stride(in_w);
      float* w = ws + lay.w_off[l];
      for (int e = tid; e < out_w * in_w; e += blockDim.x) w[(e / in_w) * st + e % in_w] = p[e];
      p += out_w * in_w;
      for (int o = tid; o < out_w; o += blockDim.x) w[out_w * st + o] = p[o];
      p += out_w;
    }
    for (int k = tid; k < kDP; k += blockDim.x) {
      sc[k] = k < kD ? a.scale[k] : 1.0f;
      mn[k] = k < kD ? a.min_[k] : 0.0f;
      mut[k] = k < kD ? static_cast<int>(a.mutable_[k]) : 0;
    }
    for (int e = tid; e < a.n_groups * a.group_slots; e += blockDim.x) ohe[e] = a.ohe[e];
  }
  __syncthreads();

  const int lane = tid & 31;
  const int row = blockIdx.x * kPgdRowsPerBlock + (tid >> 5);
  if (row >= a.n) return;  // no block barrier below
  float* X = rows + (tid >> 5) * lay.warp_floats;  // the iterate
  float* XI = X + kDP;                             // x_init
  float* U = XI + kDP;                             // unscaled row; repair's buffer
  float* CU = U + kDP;                             // constraints' cotangent of U
  float* GR = CU + kDP;                            // the gradient
  float* ACT = GR + kDP;                           // activations of layers 1..L
  float* CTA = ACT + lay.act_floats;               // cotangents, ping
  float* CTB = CTA + lay.max_width;                // and pong
  float* AUX = CTB + lay.max_width;                // lane 0's broadcast scalars
  const float* logits = ACT + lay.act_floats - a.widths[a.n_layers];
  const size_t r0 = static_cast<size_t>(row) * kD;
  for (int k = lane; k < kD; k += 32) {
    X[k] = a.x_start[r0 + k];
    XI[k] = a.x_init[r0 + k];
  }
  const int yv = static_cast<int>(a.y[row]);
  const bool linf = a.flags & 1;
  const bool repair = a.flags & 2;
  __syncwarp();

  for (int it = 0; it < a.t; ++it) {
    const float wc = a.w_class[it];
    const float wk = a.w_cons[it];
    const float stp = a.step[it];
    const int ctr = a.ctr[it];
    for (int k = lane; k < kD; k += 32) {
      U[k] = __fdiv_rn(__fsub_rn(X[k], mn[k]), sc[k]);
      CU[k] = 0.0f;
    }
    mlp_forward(a, lay, ws, X, ACT, lane);
    if (lane == 0) {
      float g[kTerms];
      const float lc = cross_entropy(a.widths[a.n_layers], a.flags & 4, logits, yv, wc, CTA);
      lcld_terms_vjp(U, CU, a.tol, ctr, -wk, g);
      float cons = g[0];
#pragma unroll
      for (int k = 1; k < kTerms; ++k) cons = __fadd_rn(cons, g[k]);
      // the optimised term, picked without indexing g at run time (which
      // would put g in local memory)
#pragma unroll
      for (int k = 0; k < kTerms; ++k)
        if (k == ctr) cons = g[k];
      if (a.hist != nullptr) {
        float* h = a.hist + (static_cast<size_t>(it) * a.n + row) * a.hist_cols;
        h[0] = __fadd_rn(__fmul_rn(wc, lc), __fmul_rn(wk, -cons));
        h[1] = lc;
        h[2] = cons;
        if (a.flags & 16) {
          const int at = (a.flags & 8) ? 4 : 3;
#pragma unroll
          for (int k = 0; k < kTerms; ++k) h[at + k] = g[k];
        }
      }
    }
    __syncwarp();
    mlp_backward(a, lay, ws, ACT, CTA, CTB, GR, lane);
    for (int k = lane; k < kD; k += 32) GR[k] = __fadd_rn(GR[k], __fdiv_rn(CU[k], sc[k]));
    __syncwarp();
    if (lane == 0 && a.hist != nullptr && (a.flags & 8)) {
      float s = 0.0f;
      for (int k = 0; k < kD; ++k) {
        const float f = isfinite(GR[k]) ? GR[k] : 0.0f;
        s = k == 0 ? __fmul_rn(f, f) : __fadd_rn(s, __fmul_rn(f, f));
      }
      a.hist[(static_cast<size_t>(it) * a.n + row) * a.hist_cols + 3] = __fsqrt_rn(s);
    }
    __syncwarp();  // lane 0 has read the raw gradient
    for (int k = lane; k < kD; k += 32) {
      const float gv = GR[k];
      GR[k] = isnan(gv) || !mut[k] ? 0.0f : gv;
    }
    __syncwarp();
    if (!linf) {
      if (lane == 0) {
        float s = __fmul_rn(GR[0], GR[0]);
        for (int k = 1; k < kD; ++k) s = __fadd_rn(s, __fmul_rn(GR[k], GR[k]));
        AUX[0] = __fadd_rn(__fsqrt_rn(s), 1e-7f);
      }
      __syncwarp();
    }
    // the step and the clip; the perturbation into U
    for (int k = lane; k < kD; k += 32) {
      const float gv = GR[k];
      const float d = linf ? (gv > 0.0f ? 1.0f : (gv < 0.0f ? -1.0f : (gv == 0.0f ? 0.0f : gv)))
                           : __fdiv_rn(gv, AUX[0]);
      const float x = clamp_nan(__fadd_rn(X[k], __fmul_rn(stp, d)), a.lo, a.hi);
      U[k] = __fsub_rn(x, XI[k]);
    }
    __syncwarp();
    // the projection and the clip
    if (!linf) {
      if (lane == 0) {
        float s = __fmul_rn(U[0], U[0]);
        for (int k = 1; k < kD; ++k) s = __fadd_rn(s, __fmul_rn(U[k], U[k]));
        AUX[1] = nan_min(1.0f, __fdiv_rn(a.eps, __fadd_rn(__fsqrt_rn(s), 1e-12f)));
      }
      __syncwarp();
    }
    for (int k = lane; k < kD; k += 32) {
      const float d = linf ? clamp_nan(U[k], -a.eps, a.eps) : __fmul_rn(U[k], AUX[1]);
      X[k] = clamp_nan(__fadd_rn(XI[k], d), a.lo, a.hi);
    }
    __syncwarp();
    if (repair) {
      for (int k = lane; k < kD; k += 32) U[k] = __fdiv_rn(__fsub_rn(X[k], mn[k]), sc[k]);
      __syncwarp();
      if (lane == 0) lcld_repair(a, ohe, U);
      __syncwarp();
      for (int k = lane; k < kD; k += 32)
        if (mut[k]) X[k] = __fadd_rn(__fmul_rn(U[k], sc[k]), mn[k]);
      __syncwarp();
    }
  }

  // the class at x_adv: mlp_proba_plain's probabilities, the first largest
  mlp_forward(a, lay, ws, X, ACT, lane);
  if (lane == 0) a.pred[row] = predicted_class(a.widths[a.n_layers], logits);
  for (int k = lane; k < kD; k += 32) a.x_adv[r0 + k] = X[k];
}

}  // namespace

cudaError_t launch_pgd_lcld(const PgdArgs& args, cudaStream_t stream) {
  if (args.n == 0) return cudaSuccess;
  if (args.n < 0 || args.t < 0 || args.n_layers < 1 || args.n_layers > kObjectiveMaxLayers ||
      args.widths[0] != kD || args.widths[args.n_layers] < 1 || args.widths[args.n_layers] > 2 ||
      args.n_groups < 0 || args.group_slots < 1 || args.n_groups * args.group_slots > kPgdMaxOheSlots)
    return cudaErrorInvalidValue;
  PgdLayout lay{};
  lay.max_width = kDP;
  for (int l = 0; l < args.n_layers; ++l) {
    const int in_w = args.widths[l];
    const int out_w = args.widths[l + 1];
    if (out_w < 1 || out_w > kObjectiveMaxWidth) return cudaErrorInvalidValue;
    lay.w_off[l] = lay.w_floats;
    lay.w_floats += out_w * ((in_w | 1) + 1);
    lay.act_floats += out_w;
    lay.max_width = lay.max_width > out_w ? lay.max_width : out_w;
  }
  lay.ohe_ints = (args.n_groups * args.group_slots + 3) & ~3;
  lay.warp_floats = (5 * kDP + lay.act_floats + 2 * lay.max_width + 4 + 3) & ~3;
  const size_t smem = sizeof(float) * (static_cast<size_t>(lay.w_floats) + 3 * kDP + lay.ohe_ints +
                                       static_cast<size_t>(kPgdRowsPerBlock) * lay.warp_floats);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  static LaunchCache cache;
  const cudaError_t err =
      cache.prepare(reinterpret_cast<const void*>(pgd_lcld_kernel), kPgdRowsPerBlock * 32, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (args.n + kPgdRowsPerBlock - 1) / kPgdRowsPerBlock;
  pgd_lcld_kernel<<<grid, kPgdRowsPerBlock * 32, smem, stream>>>(args, lay);
  return cudaGetLastError();
}
