// K10: constrained PGD and AutoPGD on a domain compiled from a constraint
// spec, every iteration of one run in one launch, the constraint terms, their
// backward and the repair run from programs that the host lowers from the
// spec (domains/ir/program.py: lower_spec_vjp, lower_spec_repair).
//
// Replaces the jnp device program of moeva2_ijcai22_replication_tpu/attacks/
// pgd/engine.py::ConstrainedPGD._one_run (:241, its lax.fori_loop), and of
// attacks/pgd/autopgd.py::AutoPGD._one_run (:45, kAuto), on a spec domain:
// _grad_and_terms (:179, jax.grad of the weighted cross-entropy minus the
// smooth violations, through models/mlp.py::MLP and domains/ir/
// jnp_backend.py::raw_terms :32 under core/constraints.py evaluate_smooth),
// NaN zeroing, the mutable mask, core/norms.py::condition_grad, the step,
// the clip, project_ball and, with repair, _repair (:197) over domains/ir/
// repair_backend.py::compile_repair (:94). The repo has no Pallas kernel for
// it.
//
// Semantics: those of attacks/pgd/engine.py::pgd_run_plain (and kAuto:
// attacks/pgd/autopgd.py::autopgd_run_plain) with a domains/ir/
// torch_backend.py::SpecConstraintSet, one rounded float32 operation at a
// time in their order (__fadd_rn / __fmul_rn / __fdiv_rn, so nvcc cannot
// contract them into FMAs):
// - the relu stack forward: each unit from its bias, adding a[k] * w[o][k]
//   for k = 0, 1, ...; relu keeps NaN; the cross-entropy and its backward as
//   K7 (pgd_common.cuh); the input backward: a hidden unit passes its
//   cotangent where its output is > 0, each input sums ct[o] * w[o][k] for
//   o = 0, 1, ... from the first product;
// - the constraints: the reverse program (run_program_vjp_plain's
//   semantics): per term its forward in the evaluator's
//   operations (pow in float64 rounded once, months as K1's lcld_months, the
//   guarded divisions keeping their sentinel), its HEAD (pre = raw - tol,
//   the smooth violation clip(pre, 0, inf) and clip_vjp(pre, ct_g)) and its
//   backward with jax.grad's conventions (core/vjp.py), each leaf's
//   contribution added at once to its feature's cotangent from 0, term by
//   term; the sum of the violations (or the optimised one); the
//   constraints' cotangent divided by the scale and added last;
// - L2 sums left to right and correctly rounded square roots; min and max
//   NaN-propagating; the L-inf sign 0 at 0; the class at x_adv as
//   engine.py::predict_plain;
// - repair: the repair program (run_repair_plain's semantics: each
//   membership snap's midpoint chain, then the assignments, each written to
//   its feature and read by what follows), then each one-hot group set to
//   its first largest slot (a NaN counts as the largest), then back to
//   scaled space where mutable (an immutable feature keeps its unrepaired x);
// - AutoPGD (kAuto) as K7's: the tracking loss, momentum, best point and
//   checkpoint halving (pgd_lcld.cu's header gives the order).
//
// Bound: per row and iteration the stack's forward and its input backward
// are 2 x 2 operations a weight; the reverse program one operation an
// instruction (a float64 pow or log counted at the fp64 rate), the repair
// program likewise, and ~25 per feature for the gradient, the step, the
// clips and the projection (chip_smoke.py counts them: spec_pgd_work). The
// rows' bytes are negligible: bound by operations.
//
// Design (a simple kernel, not yet a fast one): a block runs ceil(N / SMs)
// rows, at most kPgdSpecMaxRows and as many as its buffers fit in shared
// memory (at botnet_spec's 756 features, 10 rows a block, 8 for AutoPGD),
// so that one block runs on each SM; every phase is spread over the block's
// kPgdSpecThreads threads, with a barrier between phases. The stack's sums
// are one thread a (row, unit) or (row, input), the weights read from
// global memory (the first layer from its transposed copy, so that a
// warp's threads read consecutive units). The terms run side by side with
// the first layer, one thread a (row, term): a term's instructions are a
// contiguous range of the reverse program (term_start), read from global
// memory, its slots a thread's local array. Each leaf's contribution is
// stored apart (ACC's index k), and a second phase sums each feature's
// contributions from 0 in program order, one thread a (row, feature), through
// the host's CSR table (acc_ptr, acc_idx): the sequential order without
// atomics. The gradient, the step, the projection and repair's round trip
// are elementwise over the block's rows; the L2 sums, the cross-entropy, the
// violations' sum and the repair program run one thread a row. AutoPGD is
// its own instantiation (kAuto): a launch runs 2T + 2 passes of the same
// code, as K7's does.

#include "pgd_common.cuh"

namespace {

// op codes and operand kinds of domains/ir/program.py
enum SpecOp : int {
  kMov = 0, kAdd, kSub, kMul, kDiv, kPow, kNeg, kAbs, kMonths, kSafeDiv, kFiniteDiv, kTerm,
  kHead, kAcc, kAccN, kAbsVjp, kDivDen, kPowDb, kPowDe, kSelNz, kSelFin, kDen1, kLt, kSel, kStore,
};
enum SpecKind : int { kFeat = 0, kSlot = 1, kImm = 2 };

constexpr int kThreads = kPgdSpecThreads;

// a row's stride in shared memory: odd, so that one row per lane is
// conflict-free
__host__ __device__ constexpr int odd_stride(int w) { return w | 1; }

struct SpecLayout {
  int w_off[kObjectiveMaxLayers];    // each layer's weight in params
  int b_off[kObjectiveMaxLayers];    // and its bias
  int act_off[kObjectiveMaxLayers];  // each layer's outputs in a row of act_floats
  int act_floats;                    // a row's activations (every layer, the head's last)
  int ct_st;                         // a row of cotangents (the widest layer)
  int gt_st;                         // a row's terms
  int ce_st;                         // a row's contributions
  int rows;                          // rows per block
  int rs;                            // a row of features
};

// float64 pow and log, one copy of each in the kernel's code
__device__ __noinline__ double pow_f64(double b, double e) { return pow(b, e); }
__device__ __noinline__ double log_f64(double x) { return log(x); }

__device__ __forceinline__ float operand(int kind, int v, const float* u, const float* slots) {
  return kind == kFeat ? u[v] : (kind == kSlot ? slots[v] : __int_as_float(v));
}

// Instructions [begin, end) of a program over the row u (its features, which
// STORE writes): ACC/ACCN store their contribution k into contrib[k], a HEAD
// its term's smooth violation into *g and its cotangent from ct_cons (for
// the optimised terms: ctr < 0, or the term ctr) into its slot
__device__ void run_program(const int32_t* code, int begin, int end, float* u, float* contrib, float* g, float tol,
                            int ctr, float ct_cons) {
  float slots[kSpecVjpMaxSlots];
  const int4* prog = reinterpret_cast<const int4*>(code);
  for (int i = begin; i < end; ++i) {
    const int4 ins = __ldg(prog + i);
    const int op = ins.x & 0xFF;
    const float a = operand((ins.x >> 8) & 0xF, ins.z, u, slots);
    if (op == kAcc || op == kAccN) {
      contrib[ins.w] = op == kAcc ? a : -a;
      continue;
    }
    if (op == kStore) {
      u[ins.y] = a;
      continue;
    }
    if (op == kHead) {
      const int t = ins.w;
      const float pre = __fsub_rn(a, tol);
      *g = clip_smooth(pre);
      slots[ins.y] = clip_vjp(pre, ctr < 0 || ctr == t ? ct_cons : 0.0f);
      continue;
    }
    const float b = operand((ins.x >> 12) & 0xF, ins.w, u, slots);
    const float cur = slots[ins.y];
    float v;
    switch (op) {
      case kMov: v = a; break;
      case kAdd: v = __fadd_rn(a, b); break;
      case kSub: v = __fsub_rn(a, b); break;
      case kMul: v = __fmul_rn(a, b); break;
      case kDiv: v = __fdiv_rn(a, b); break;
      case kPow: v = __double2float_rn(pow_f64(static_cast<double>(a), static_cast<double>(b))); break;
      case kNeg: v = -a; break;
      case kAbs: v = fabsf(a); break;
      case kMonths: v = lcld_months(a); break;
      case kSafeDiv: v = b != 0.0f ? __fdiv_rn(a, b) : cur; break;
      case kFiniteDiv: {
        const float q = b != 0.0f ? __fdiv_rn(a, b) : cur;
        v = isfinite(q) ? q : cur;
        break;
      }
      case kAbsVjp: v = abs_vjp(a, b); break;
      case kDivDen: v = -__fmul_rn(__fmul_rn(a, __fdiv_rn(1.0f, __fmul_rn(b, b))), cur); break;
      case kPowDb: {
        const double bd = a, td = b;
        v = __fmul_rn(cur, __double2float_rn(td * pow_f64(bd, td - 1.0)));
        break;
      }
      case kPowDe: {
        const double bd = a, td = b;
        v = __fmul_rn(cur, __double2float_rn(log_f64(bd == 0.0 ? 1.0 : bd) * pow_f64(bd, td)));
        break;
      }
      case kSelNz: v = a != 0.0f ? cur : 0.0f; break;
      case kSelFin: v = b != 0.0f && isfinite(__fdiv_rn(a, b)) ? cur : 0.0f; break;
      case kDen1: v = a != 0.0f ? a : 1.0f; break;
      case kLt: v = a < b ? 1.0f : 0.0f; break;
      case kSel: v = a != 0.0f ? cur : b; break;
      default: v = cur;
    }
    slots[ins.y] = v;
  }
}

// one one-hot group (`slots` features, -1 after them) set to its first
// largest slot, a NaN counting as the largest
__device__ void harden_group(const int* slot, int slots, float* u) {
  int best = 0;
  float bv = u[slot[0]];
  for (int j = 1; j < slots; ++j) {
    const int f = slot[j];
    if (f >= 0) {
      const float v = u[f];
      if (v > bv || (isnan(v) && !isnan(bv))) {
        best = j;
        bv = v;
      }
    }
  }
  for (int j = 0; j < slots; ++j)
    if (slot[j] >= 0) u[slot[j]] = j == best ? 1.0f : 0.0f;
}

// sum_last of a row's d squares, left to right
__device__ __forceinline__ float row_sum(const float* sq, int d) {
  float s = sq[0];
  for (int k = 1; k < d; ++k) s = __fadd_rn(s, sq[k]);
  return s;
}

// min(1, eps / (||the row's perturbation|| + 1e-12)), sq holding its squares
__device__ __forceinline__ float projection_factor(const float* sq, int d, float eps) {
  return nan_min(1.0f, __fdiv_rn(eps, __fadd_rn(__fsqrt_rn(row_sum(sq, d)), 1e-12f)));
}

// one (row, unit) sum of layer l: from its bias, adding in[k] * w[o][k] for
// k = 0, 1, ...; relu (keeping NaN) on a hidden layer
__device__ __forceinline__ void unit_forward(const PgdSpecArgs& a, const SpecLayout& lay, const float* X, float* ACT,
                                             int l, int r, int o) {
  const int in_w = a.widths[l];
  const int out_w = a.widths[l + 1];
  float acc = __ldg(a.params + lay.b_off[l] + o);
  if (l == 0) {
    const float* in = X + r * lay.rs;
    for (int k = 0; k < in_w; ++k) acc = __fadd_rn(acc, __fmul_rn(in[k], __ldg(a.first_t + k * out_w + o)));
  } else {
    const float* in = ACT + r * lay.act_floats + lay.act_off[l - 1];
    const float* w = a.params + lay.w_off[l] + o * in_w;
    for (int k = 0; k < in_w; ++k) acc = __fadd_rn(acc, __fmul_rn(in[k], __ldg(w + k)));
  }
  ACT[r * lay.act_floats + lay.act_off[l] + o] = l + 1 < a.n_layers ? relu_keep_nan(acc) : acc;
}

__host__ __device__ inline size_t spec_smem_floats(const SpecLayout& lay, int rows, bool autopgd) {
  return 3 * static_cast<size_t>(lay.rs) +
         static_cast<size_t>(rows) * ((autopgd ? 8 : 6) * lay.rs + lay.act_floats + 2 * lay.ct_st + lay.gt_st +
                                      lay.ce_st + 4 + (autopgd ? 7 : 0));
}

template <bool kAuto>
__global__ void __launch_bounds__(kThreads) pgd_spec_kernel(const PgdSpecArgs a, const SpecLayout lay) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.d;
  const int RS = lay.rs;
  const int R = lay.rows;
  const int NT = a.n_terms;
  float* sc = smem;                            // (RS) scale
  float* mn = sc + RS;                         // (RS) min_
  int* mut = reinterpret_cast<int*>(mn + RS);  // (RS) mutable
  float* X = reinterpret_cast<float*>(mut + RS);  // (R, RS) the iterates
  float* XI = X + R * RS;      // x_init
  float* U = XI + R * RS;      // unscaled rows; the perturbation
  float* CU = U + R * RS;      // the terms' cotangent of U; then the squares of the L2 sums
  float* G = CU + R * RS;      // the masked gradient
  float* SQR = G + R * RS;     // squares of the raw gradient's finite entries
  float* XP = SQR + R * RS;                // kAuto: x_prev
  float* XB = XP + (kAuto ? R * RS : 0);   // x_best
  float* ACT = XB + (kAuto ? R * RS : 0);  // (R, act_floats) every layer's outputs
  float* CTA = ACT + R * lay.act_floats;   // cotangents, ping (R, ct_st)
  float* CTB = CTA + R * lay.ct_st;        // and pong
  float* GT = CTB + R * lay.ct_st;         // (R, gt_st) each row's smooth violations
  float* CE = GT + R * lay.gt_st;          // (R, ce_st) each row's contributions to the cotangents
  float* LC = CE + R * lay.ce_st;          // (R) each row's class loss
  float* CONS = LC + R;                    // (R) its constraint loss
  float* NRM = CONS + R;                   // (R) its gradient's L2 norm + 1e-7
  float* FAC = NRM + R;                    // (R) its projection factor
  // kAuto, (R) each: the best tracking loss, the previous iteration's, the
  // best at the last checkpoint, the step, the step at the last checkpoint,
  // the rises since the last checkpoint, and what the pass's copies do
  float* FBEST = FAC + R;
  float* FPREV = FBEST + R;
  float* FBCK = FPREV + R;
  float* ETA = FBCK + R;
  float* ETACK = ETA + R;
  float* IMPR = ETACK + R;
  int* MOVE = reinterpret_cast<int*>(IMPR + R);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, a.n - row0);

  for (int k = tid; k < RS; k += kThreads) {
    sc[k] = k < D ? a.scale[k] : 1.0f;
    mn[k] = k < D ? a.min_[k] : 0.0f;
    mut[k] = k < D ? static_cast<int>(a.mutable_[k]) : 0;
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D;
    const int k = e - r * D;
    const size_t at = static_cast<size_t>(row0 + r) * D + k;
    const float x = a.x_start[at];
    X[r * RS + k] = x;
    if constexpr (kAuto) {
      XP[r * RS + k] = x;
      XB[r * RS + k] = x;
    }
    XI[r * RS + k] = a.x_init[at];
    U[r * RS + k] = unscale(x, mn[k], sc[k]);
  }
  const int classes = a.widths[a.n_layers];
  const int head = lay.act_off[a.n_layers - 1];
  const int w1 = a.widths[1];
  const bool linf = a.flags & 1;
  const bool repair = a.flags & 2;
  const bool targeted = a.flags & 4;
  const bool hist_norm = a.hist != nullptr && (a.flags & 8);
  const bool hist_full = a.hist != nullptr && (a.flags & 16);
  const int g_col = (a.flags & 8) ? 4 : 3;
  // the input backward reads the cotangent buffer the hidden layers' end in
  float* const top = (a.n_layers - 1) % 2 ? CTB : CTA;
  __syncthreads();

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
    // the first layer's (row, unit) sums and, side by side, each (row,
    // term) of the reverse program
    {
      const int n_units = nr * w1;
      const int n_tasks = n_units + (last ? 0 : nr * NT);
      for (int e = tid; e < n_tasks; e += kThreads) {
        if (e < n_units) {
          const int r = e / w1;
          unit_forward(a, lay, X, ACT, 0, r, e - r * w1);
        } else {
          const int r = (e - n_units) / NT;
          const int t = e - n_units - r * NT;
          run_program(a.vjp, __ldg(a.term_start + t), __ldg(a.term_start + t + 1), U + r * RS, CE + r * lay.ce_st,
                      GT + r * lay.gt_st + t, a.tol, ctr, -wk);
        }
      }
      __syncthreads();
    }
    // the deeper layers
    for (int l = 1; l < a.n_layers; ++l) {
      const int out_w = a.widths[l + 1];
      for (int e = tid; e < nr * out_w; e += kThreads) {
        const int r = e / out_w;
        unit_forward(a, lay, X, ACT, l, r, e - r * out_w);
      }
      __syncthreads();
    }
    if (last) {
      // the class at x_adv: mlp_proba_plain's probabilities, the first largest
      if (tid < nr) a.pred[row0 + tid] = predicted_class(classes, ACT + tid * lay.act_floats + head);
      break;
    }
    // per row the cross-entropy and the constraint loss (the violations'
    // sum left to right, or the optimised one); per (row, feature) the
    // terms' cotangent, its contributions summed from 0 in program order;
    // the history's violations
    {
      const int n_feat = track ? 0 : nr * D;
      const int n_hist = hist_full && !track ? nr * NT : 0;
      for (int e = tid; e < nr + n_feat + n_hist; e += kThreads) {
        if (e < nr) {
          const int r = e;
          float ct[2];
          LC[r] = cross_entropy(classes, targeted, ACT + r * lay.act_floats + head, static_cast<int>(a.y[row0 + r]),
                                wc, ct);
          CTA[r * lay.ct_st] = ct[0];
          if (classes == 2) CTA[r * lay.ct_st + 1] = ct[1];
          const float* g = GT + r * lay.gt_st;
          float cons = g[0];
          for (int t = 1; t < NT; ++t) cons = __fadd_rn(cons, g[t]);
          CONS[r] = ctr < 0 ? cons : g[ctr];
        } else if (e < nr + n_feat) {
          const int r = (e - nr) / D;
          const int k = e - nr - r * D;
          const float* c = CE + r * lay.ce_st;
          float s = 0.0f;
          for (int j = __ldg(a.acc_ptr + k); j < __ldg(a.acc_ptr + k + 1); ++j) s = __fadd_rn(s, c[__ldg(a.acc_idx + j)]);
          CU[r * RS + k] = s;
        } else {
          const int r = (e - nr - n_feat) / NT;
          const int t = e - nr - n_feat - r * NT;
          a.hist[(static_cast<size_t>(i) * a.n + row0 + r) * a.hist_cols + g_col + t] = GT[r * lay.gt_st + t];
        }
      }
      __syncthreads();
    }
    if constexpr (kAuto) {
      if (track) {
        // the tracking loss at x (x_start, then x_new), one thread per row:
        // the first pass sets the state; later ones the rises, the best
        // point and, at a checkpoint, the halving
        if (tid < nr) {
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
        for (int e = tid; e < nr * D; e += kThreads) {
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
    // the hidden layers' backward, from the head's down to layer 1's: a
    // (row, input) sum of ct[o] * w[o][k] from the first product, passed
    // where the input (a hidden unit's output) is > 0
    {
      float* cur = CTA;
      for (int l = a.n_layers - 1; l >= 1; --l) {
        float* nxt = cur == CTA ? CTB : CTA;
        const int in_w = a.widths[l];
        const int out_w = a.widths[l + 1];
        for (int e = tid; e < nr * in_w; e += kThreads) {
          const int r = e / in_w;
          const int k = e - r * in_w;
          const float* c = cur + r * lay.ct_st;
          const float* w = a.params + lay.w_off[l] + k;
          float s = __fmul_rn(c[0], __ldg(w));
          for (int o = 1; o < out_w; ++o) s = __fadd_rn(s, __fmul_rn(c[o], __ldg(w + o * in_w)));
          nxt[r * lay.ct_st + k] = ACT[r * lay.act_floats + lay.act_off[l - 1] + k] > 0.0f ? s : 0.0f;
        }
        __syncthreads();
        cur = nxt;
      }
    }
    // the input backward and the gradient with the terms' cotangent: NaN
    // zeroed, masked; under L-inf the step, the projection and the clip too
    for (int e = tid; e < nr * D; e += kThreads) {
      const int r = e / D;
      const int k = e - r * D;
      const int at = r * RS + k;
      const float* c = top + r * lay.ct_st;
      const float* w = a.params + lay.w_off[0] + k;
      float s = __fmul_rn(c[0], __ldg(w));
      for (int o = 1; o < w1; ++o) s = __fadd_rn(s, __fmul_rn(c[o], __ldg(w + o * D)));
      const float gv = __fadd_rn(s, div_rn(CU[at], sc[k]));
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
    // the history and the gradient's L2 norm, one thread per row and sum
    if (a.hist != nullptr || !linf) {
      for (int e = tid; e < 2 * nr; e += kThreads) {
        const int r = e >> 1;
        if (e & 1) {
          if (!linf) NRM[r] = __fadd_rn(__fsqrt_rn(row_sum(CU + r * RS, D)), 1e-7f);
        } else if (a.hist != nullptr) {
          float* h = a.hist + (static_cast<size_t>(i) * a.n + row0 + r) * a.hist_cols;
          const float lc = LC[r];
          const float cons = CONS[r];
          h[0] = __fadd_rn(__fmul_rn(wc, lc), __fmul_rn(wk, -cons));
          h[1] = lc;
          h[2] = cons;
          if (hist_norm) h[3] = __fsqrt_rn(row_sum(SQR + r * RS, D));
        }
      }
      __syncthreads();
    }
    if (!linf) {
      // the step and the clip; the perturbation into U, its squares into CU
      for (int e = tid; e < nr * D; e += kThreads) {
        const int r = e / D;
        const int at = r * RS + (e - r * D);
        const float x = clamp_nan(__fadd_rn(X[at], __fmul_rn(kAuto ? ETA[r] : stp, div_rn(G[at], NRM[r]))), a.lo, a.hi);
        const float du = __fsub_rn(x, XI[at]);
        U[at] = du;
        CU[at] = __fmul_rn(du, du);
      }
      __syncthreads();
      if (tid < nr) FAC[tid] = projection_factor(CU + tid * RS, D, a.eps);
      __syncthreads();
      if constexpr (kAuto) {
        // z projected and clipped, then the momentum clipped: its
        // perturbation into U, its squares into CU; x_prev takes x
        for (int e = tid; e < nr * D; e += kThreads) {
          const int r = e / D;
          const int at = r * RS + (e - r * D);
          const float x = X[at];
          const float xi = XI[at];
          const float z = clamp_nan(__fadd_rn(xi, __fmul_rn(U[at], FAC[r])), a.lo, a.hi);
          const float du = __fsub_rn(clamp_nan(momentum(x, z, XP[at], alpha), a.lo, a.hi), xi);
          XP[at] = x;
          U[at] = du;
          CU[at] = __fmul_rn(du, du);
        }
        __syncthreads();
        if (tid < nr) FAC[tid] = projection_factor(CU + tid * RS, D, a.eps);
        __syncthreads();
      }
      // the projection and the clip
      for (int e = tid; e < nr * D; e += kThreads) {
        const int r = e / D;
        const int k = e - r * D;
        const int at = r * RS + k;
        const float x = clamp_nan(__fadd_rn(XI[at], __fmul_rn(U[at], FAC[r])), a.lo, a.hi);
        X[at] = x;
        U[at] = unscale(x, mn[k], sc[k]);
      }
      __syncthreads();
    }
    if (repair) {
      // the repair program and the one-hot groups, one thread per row
      if (tid < nr) {
        float* u = U + tid * RS;
        run_program(a.repair, 0, a.n_repair, u, nullptr, nullptr, 0.0f, -1, 0.0f);
        for (int gi = 0; gi < a.n_groups; ++gi) harden_group(a.ohe + gi * a.group_slots, a.group_slots, u);
      }
      __syncthreads();
      // back to scaled space where mutable; an immutable feature keeps its
      // unrepaired x, and u is unscaled from x again on every feature, as
      // pgd_run_plain's next iteration takes it
      for (int e = tid; e < nr * D; e += kThreads) {
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
    }
  }

  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D;
    a.x_adv[static_cast<size_t>(row0) * D + e] = X[r * RS + (e - r * D)];
  }
  if constexpr (kAuto) {
    if (tid < nr) a.eta[row0 + tid] = ETA[tid];
  }
}

// the layout of a stack of n_layers layers of the given widths over d
// features and a reverse program of n_terms terms and n_acc contributions;
// false when a width is out of range
bool spec_layout(const int* widths, int n_layers, int d, int n_terms, int n_acc, SpecLayout& lay) {
  int off = 0, act = 0, widest = 1;
  for (int l = 0; l < n_layers; ++l) {
    const int in_w = widths[l];
    const int out_w = widths[l + 1];
    if (in_w < 1 || out_w < 1 || (l > 0 && in_w > kSpecMaxWidth)) return false;
    lay.w_off[l] = off;
    off += out_w * in_w;
    lay.b_off[l] = off;
    off += out_w;
    lay.act_off[l] = act;
    act += out_w;
    widest = widest > out_w ? widest : out_w;
  }
  lay.act_floats = odd_stride(act);
  lay.ct_st = odd_stride(widest);
  lay.gt_st = odd_stride(n_terms);
  lay.ce_st = odd_stride(n_acc);
  lay.rs = odd_stride(d);
  return true;
}

// the most rows per block whose buffers fit shared memory, at most `cap`
int fitting_rows(const SpecLayout& lay, bool autopgd, int cap) {
  for (int rows = cap; rows >= 1; --rows)
    if (sizeof(float) * spec_smem_floats(lay, rows, autopgd) <= kMaxSharedBytes) return rows;
  return 0;
}

}  // namespace

int pgd_spec_block_rows(int d, const int* widths, int n_layers, int n_terms, int n_acc, int autopgd) {
  SpecLayout lay{};
  if (n_layers < 1 || n_layers > kObjectiveMaxLayers || !spec_layout(widths, n_layers, d, n_terms, n_acc, lay))
    return 0;
  return fitting_rows(lay, autopgd != 0, kPgdSpecMaxRows);
}

cudaError_t launch_pgd_spec(const PgdSpecArgs& args, cudaStream_t stream) {
  if (args.n == 0) return cudaSuccess;
  const bool autopgd = args.flags & 32;
  if (args.n < 0 || args.t < 0 || args.d < 1 || args.d > kSpecMaxFeatures || args.n_layers < 1 ||
      args.n_layers > kObjectiveMaxLayers || args.widths[0] != args.d || args.widths[args.n_layers] < 1 ||
      args.widths[args.n_layers] > 2 || args.n_groups < 0 || args.group_slots < 1 || args.n_vjp < 1 ||
      args.n_vjp > kSpecVjpMaxInstructions || args.n_repair < 0 || args.n_repair > kSpecVjpMaxInstructions ||
      args.n_terms < 1 || args.n_terms > kSpecMaxTerms || args.n_acc < 1 || args.n_acc > args.n_vjp ||
      args.vjp == nullptr || args.term_start == nullptr || args.acc_ptr == nullptr || args.acc_idx == nullptr ||
      (args.n_repair > 0 && args.repair == nullptr) || args.first_t == nullptr ||
      (autopgd && (args.is_ckpt == nullptr || args.ckpt_thr == nullptr || args.eta == nullptr)))
    return cudaErrorInvalidValue;
  SpecLayout lay{};
  if (!spec_layout(args.widths, args.n_layers, args.d, args.n_terms, args.n_acc, lay)) return cudaErrorInvalidValue;
  static LaunchCache cache;
  int sms = 0;
  cudaError_t err = cache.sm_count(&sms);
  if (err != cudaSuccess) return err;
  // one block on each SM, as many rows as fit
  int rows = (args.n + sms - 1) / sms;
  rows = rows < 1 ? 1 : (rows > kPgdSpecMaxRows ? kPgdSpecMaxRows : rows);
  rows = fitting_rows(lay, autopgd, rows);
  if (rows == 0) return cudaErrorInvalidValue;
  lay.rows = rows;
  const size_t smem = sizeof(float) * spec_smem_floats(lay, rows, autopgd);
  const int grid = (args.n + rows - 1) / rows;
  if (autopgd) {
    static LaunchCache auto_cache;
    err = auto_cache.prepare(reinterpret_cast<const void*>(pgd_spec_kernel<true>), kThreads, smem, nullptr);
    if (err != cudaSuccess) return err;
    pgd_spec_kernel<true><<<grid, kThreads, smem, stream>>>(args, lay);
  } else {
    err = cache.prepare(reinterpret_cast<const void*>(pgd_spec_kernel<false>), kThreads, smem, nullptr);
    if (err != cudaSuccess) return err;
    pgd_spec_kernel<false><<<grid, kThreads, smem, stream>>>(args, lay);
  }
  return cudaGetLastError();
}
