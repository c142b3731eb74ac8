// K7b: constrained PGD on the CTU-13 botnet domain (756 features, 360
// terms), every iteration of one run in one launch.
//
// Replaces the jnp device program of moeva2_ijcai22_replication_tpu/attacks/
// pgd/engine.py::ConstrainedPGD._one_run (:241, its lax.fori_loop) on the
// botnet domain, with what each iteration runs: _grad_and_terms (:179,
// jax.grad of the weighted cross-entropy minus the smooth violations,
// through models/mlp.py::MLP and domains/botnet.py::BotnetConstraints._raw
// :111 under core/constraints.py:80 evaluate_smooth), NaN zeroing, the
// mutable mask, core/norms.py::condition_grad, the step, the clip,
// project_ball and, with repair, _repair's round trip through the scaler
// (:197; botnet's repair is the identity, but the round trip does not give
// x back in float32). The repo has no Pallas kernel for it.
//
// Semantics: those of attacks/pgd/engine.py::pgd_run_plain with
// domains/botnet.py::BotnetConstraints.smooth_vjp, one rounded float32
// operation at a time in its order (pgd_common.cuh):
// - forward: models/mlp.py::mlp_forward_plain (each unit from its bias,
//   adding w[o][k] * a[k] for k = 0, 1, ...; relu keeps NaN); the
//   cross-entropy and its backward as K7;
// - the terms as _raw (each flow sum left to right, the ratio a true
//   division, torch.clamp's NaN kept), their backward as smooth_vjp with
//   jax.grad's conventions (core/vjp.py): first the cotangent of each of the
//   gather lists' 896 entries, then each feature's sum of its entries from
//   0, term by term (g1 first), through the inverse table: one thread per
//   feature, no atomics;
// - the MLP's input backward: mlp_input_grad_plain (a hidden unit passes its
//   cotangent where its output is > 0; each input unit sums w[o][k] * ct[o]
//   for o = 0, 1, ...), the constraints' cotangent divided by the scale and
//   added last;
// - L2 sums left to right and correctly rounded square roots; min and max
//   NaN-propagating; the L-inf sign 0 at 0; the class at x_adv as
//   engine.py::predict_plain.
//
// Bound: per row and iteration, 4 operations per weight of the stack (a
// multiply and an add, forward and input backward: 4 x 54,592 for
// 756-64-64-32-2), about 25 per feature (unscaling, the cotangents' sum,
// masking, conditioning, the step, the clips, the projection, repair's
// round trip) and a few per gathered entry and term: about 2.4e5 fp32
// operations, 9.3e10 for rq1.botnet's 387 rows x 1000 iterations, 1.4 ms at
// 67 TFLOP/s; the rows' bytes are negligible. Bound by operations. The
// fixed left-to-right orders make serial chains in every iteration,
// whatever the parallelism: each first-layer unit (756 multiply-adds), the
// two L2 sums over 756 features, the deeper layers and the cross-entropy,
// some 2,700 dependent operations (chip_smoke.py's pgd_botnet_floor_ms
// counts them): a latency floor four times the bound. Tensor cores are not
// used: their sums have an order no CPU code reproduces.
//
// Design (a simple one first): a block of 256 threads takes `rows` rows, 1
// to 4, as few as spread N over the SMs in one wave (3 at 387 rows), so
// that each weight read serves every row of the block. The first layer
// (189 KB) stays in global memory, resident in L2: the forward reads its
// transposed copy (threads owning output units read consecutive words), the
// input backward params' (out, in) layout (threads owning input features
// read consecutive words). The small layers (padded to an odd stride), the
// scaler, the mutable mask and the gather and inverse tables are staged in
// shared memory; each row keeps its iterate, x_init, unscaled row,
// gradient, entry cotangents, terms, activations and squares there (~24
// KB). The independent chains are spread over the threads, with block
// barriers between the phases: the first layer's units of every row
// together with the rows' 360 terms (the flow sums, the longest terms, on
// threads the first layer leaves free); the deeper layers' units; one
// thread per row for the cross-entropy; the 756 features' input backward,
// cotangent sums, gradient and the squares the L2 sums add; one thread per
// row for each L2 sum, reading 4 squares at a time (the history's grad norm
// on another warp); the 756 features' step and projection. Weight loads
// are issued well ahead of the sums that use them: the first layer's reads
// from L2, twice per iteration for every block, take most of its time
// (PERF.md), and keeping that layer on chip is the redesign's work.

#include "pgd_common.cuh"

namespace {

constexpr int kD = kBotnetFeatures;
constexpr int kThreads = kPgdBotnetThreads;
constexpr int kMaxRows = kPgdBotnetMaxRows;
constexpr float kMtu = 1500.0f;
static_assert(kThreads / 32 >= 2 * kMaxRows, "a warp per row for each of the two L2 sums");
static_assert(kMaxRows * kBotnetMaxWidth <= kThreads, "a thread per unit of every row");
static_assert(kD % 4 == 0, "rows stay 16-byte aligned");

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

struct Layout {
  int w_off[kObjectiveMaxLayers];    // staged layers 1..L-1: weight (out, padded in), then bias
  int act_off[kObjectiveMaxLayers];  // each layer's output in a row's activations
  int seg[kBotnetSegments + 1];      // each segment's first entry in the gather lists
  int ord_start[3];                  // each ordering's first term
  int n_entries, n_terms;
  int staged_floats;                 // the first layer's bias, then the staged layers
  int act_floats;                    // a row's activations: the widths of layers 1..L
  int row_floats;                    // a row's slice
};

// a row's slice of shared memory
struct Row {
  float* x;    // the iterate (scaled)
  float* xi;   // x_init
  float* u;    // the unscaled iterate; the perturbation between step and projection
  float* gr;   // the raw gradient
  float* ent;  // the cotangent of each entry of the gather lists
  float* g;    // the smooth violations
  float* act;  // the activations of layers 1..L, logits last
  float* cta;  // cotangents, ping
  float* ctb;  // and pong
  float* sq;   // the squares an L2 sum adds: of the masked gradient, then of the perturbation
  float* sqh;  // the squares of the raw gradient's finite entries (the history's grad norm)
  float* aux;  // [gradient norm + 1e-7, projection factor]
};

__device__ __forceinline__ Row row_at(float* rows, const Layout& lay, int r) {
  Row s;
  s.x = rows + r * lay.row_floats;
  s.xi = s.x + kD;
  s.u = s.xi + kD;
  s.gr = s.u + kD;
  s.ent = s.gr + kD;
  s.g = s.ent + pad4(lay.n_entries);
  s.act = s.g + pad4(lay.n_terms);
  s.cta = s.act + pad4(lay.act_floats);
  s.ctb = s.cta + kBotnetMaxWidth;
  s.sq = s.ctb + kBotnetMaxWidth;
  s.sqh = s.sq + kD;
  s.aux = s.sqh + kD;
  return s;
}

__device__ __forceinline__ float unscale(float x, float mn, float sc) { return __fdiv_rn(__fsub_rn(x, mn), sc); }

// unit o of the first layer on the row x: its bias, then x[k] * w[o][k] for
// k = 0, 1, ... from the transposed copy wt (D, w1). The weights come from
// L2: 32 loads are issued ahead of their adds, so that the chain waits for
// one load's latency per 32 features rather than per feature; the row is
// read 4 features at a time.
__device__ __forceinline__ float first_unit(const float* __restrict__ wt, int w1, float bias, const float* x, int o) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float acc = bias;
#pragma unroll 8
  for (int k4 = 0; k4 < kD / 4; ++k4) {
    const float4 v = x4[k4];
    const float* w = wt + 4 * k4 * w1 + o;
    acc = __fadd_rn(acc, __fmul_rn(v.x, __ldg(w)));
    acc = __fadd_rn(acc, __fmul_rn(v.y, __ldg(w + w1)));
    acc = __fadd_rn(acc, __fmul_rn(v.z, __ldg(w + 2 * w1)));
    acc = __fadd_rn(acc, __fmul_rn(v.w, __ldg(w + 3 * w1)));
  }
  return acc;
}

// sum_last of the row's D squares in sq, left to right, read 4 at a time
__device__ __forceinline__ float row_sum(const float* sq) {
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  float4 v = q4[0];
  float sum = __fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w);
#pragma unroll 8
  for (int k4 = 1; k4 < kD / 4; ++k4) {
    v = q4[k4];
    sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, v.x), v.y), v.z), v.w);
  }
  return sum;
}

#ifdef K7B_STAMPS
// tools/probe_pgd_botnet.py's breakdown: per phase, the clock64() cycles
// from the previous barrier to the barrier that ends it, seen by block 0's
// thread 0 and summed over the iterations
constexpr int kPhases = 9;
__device__ unsigned long long k7b_cycles[kPhases];
#endif

// the barrier that ends phase i
__device__ __forceinline__ void phase_end(int i, long long& last) {
  __syncthreads();
#ifdef K7B_STAMPS
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long now = clock64();
    k7b_cycles[i] += now - last;
    last = now;
  }
#endif
}

// Term t of the unscaled row u: its smooth violation, returned, and the
// cotangents of its entries of the gather lists into ent, from the term's
// cotangent ct (smooth_vjp's operations)
__device__ __forceinline__ float term_vjp(const Layout& lay, const int* idx, const float* u, int t, float ct, float tol,
                                          float* ent) {
  float pre;
  if (t < 2) {  // |sum(flows) - sum(bytes)| of direction t
    const int f0 = t == 0 ? lay.seg[0] : lay.seg[2];
    const int b0 = t == 0 ? lay.seg[1] : lay.seg[3];
    const int b1 = t == 0 ? lay.seg[2] : lay.seg[4];
    float sf = u[idx[f0]];
    for (int e = f0 + 1; e < b0; ++e) sf = __fadd_rn(sf, u[idx[e]]);
    float sb = u[idx[b0]];
    for (int e = b0 + 1; e < b1; ++e) sb = __fadd_rn(sb, u[idx[e]]);
    const float v = __fsub_rn(sf, sb);
    pre = __fsub_rn(fabsf(v), tol);
    const float cv = abs_vjp(v, clip_vjp(pre, ct));
    for (int e = f0; e < b0; ++e) ent[e] = cv;
    for (int e = b0; e < b1; ++e) ent[e] = -cv;
  } else if (t < lay.ord_start[0]) {  // where(p != 0, b / where(p != 0, p, 1), 0) - 1500
    const int eb = lay.seg[4] + t - 2;
    const int ep = lay.seg[5] + t - 2;
    const float b = u[idx[eb]];
    const float p = u[idx[ep]];
    const bool nz = p != 0.0f;
    const float den = nz ? p : 1.0f;
    pre = __fsub_rn(__fsub_rn(nz ? __fdiv_rn(b, den) : 0.0f, kMtu), tol);
    float c_b, c_den;
    div_vjp(nz ? clip_vjp(pre, ct) : 0.0f, b, den, c_b, c_den);
    ent[eb] = c_b;
    ent[ep] = nz ? c_den : 0.0f;
  } else {  // lower - upper of an ordering
    int lo = lay.seg[6] + t - lay.ord_start[0];
    int up = lay.seg[7] + t - lay.ord_start[0];
#pragma unroll
    for (int m = 1; m < 3; ++m) {
      if (t >= lay.ord_start[m]) {
        lo = lay.seg[6 + 2 * m] + t - lay.ord_start[m];
        up = lay.seg[7 + 2 * m] + t - lay.ord_start[m];
      }
    }
    pre = __fsub_rn(__fsub_rn(u[idx[lo]], u[idx[up]]), tol);
    const float c = clip_vjp(pre, ct);
    ent[lo] = c;
    ent[up] = -c;
  }
  return clip_smooth(pre);
}

// Layers 1..L-1 of every row from the first layer's activations, a thread
// per (row, unit), a barrier after each layer
__device__ __forceinline__ void hidden_forward(const PgdBotnetArgs& a, const Layout& lay, const float* ws,
                                               float* rows, int nr, int tid, long long& last) {
  for (int l = 1; l < a.n_layers; ++l) {
    const int in_w = a.widths[l];
    const int out_w = a.widths[l + 1];
    const int st = padded_stride(in_w);
    const float* w = ws + lay.w_off[l];
    const float* bias = w + out_w * st;
    const bool hidden = l + 1 < a.n_layers;
    for (int task = tid; task < nr * out_w; task += kThreads) {
      const int r = task / out_w;
      const int o = task - r * out_w;
      const Row s = row_at(rows, lay, r);
      const float* in = s.act + lay.act_off[l - 1];
      float acc = bias[o];
      for (int k = 0; k < in_w; ++k) acc = __fadd_rn(acc, __fmul_rn(in[k], w[o * st + k]));
      s.act[lay.act_off[l] + o] = hidden ? relu_keep_nan(acc) : acc;
    }
    phase_end(1, last);
  }
}

// The cotangent of the first layer's output of every row, from that of the
// logits in cta, through layers L-1..1 (a thread per (row, unit), a barrier
// after each layer); returns whether it ends in ctb
__device__ __forceinline__ bool hidden_backward(const PgdBotnetArgs& a, const Layout& lay, const float* ws,
                                                float* rows, int nr, int tid, long long& last) {
  bool in_b = false;
  for (int l = a.n_layers - 1; l >= 1; --l) {
    const int in_w = a.widths[l];
    const int out_w = a.widths[l + 1];
    const int st = padded_stride(in_w);
    const float* w = ws + lay.w_off[l];
    for (int task = tid; task < nr * in_w; task += kThreads) {
      const int r = task / in_w;
      const int k = task - r * in_w;
      const Row s = row_at(rows, lay, r);
      const float* cur = in_b ? s.ctb : s.cta;
      float* dst = in_b ? s.cta : s.ctb;
      // the input of layer l is the output of layer l - 1 (hidden): its
      // cotangent passes where that output is > 0
      const float* h = s.act + lay.act_off[l - 1];
      float acc = __fmul_rn(cur[0], w[k]);
      for (int o = 1; o < out_w; ++o) acc = __fadd_rn(acc, __fmul_rn(cur[o], w[o * st + k]));
      dst[k] = h[k] > 0.0f ? acc : 0.0f;
    }
    phase_end(3, last);
    in_b = !in_b;
  }
  return in_b;
}

__global__ void __launch_bounds__(kThreads) pgd_botnet_kernel(const PgdBotnetArgs a, const Layout lay) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                            // the first layer's bias, then the staged layers
  float* sc = ws + lay.staged_floats;          // (D) scale
  float* mn = sc + kD;                         // (D) min_
  int* mut = reinterpret_cast<int*>(mn + kD);  // (D) mutable
  int* idx = mut + kD;                         // the gather lists
  int* inv = idx + pad4(lay.n_entries);        // (D, degree) the inverse table
  float* rows = reinterpret_cast<float*>(inv + kD * a.degree);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int w1 = a.widths[1];
  const int classes = a.widths[a.n_layers];

  for (int o = tid; o < w1; o += kThreads) ws[o] = a.params[w1 * kD + o];
  {
    const float* p = a.params + w1 * kD + w1;
    for (int l = 1; l < a.n_layers; ++l) {
      const int in_w = a.widths[l];
      const int out_w = a.widths[l + 1];
      const int st = padded_stride(in_w);
      float* w = ws + lay.w_off[l];
      for (int e = tid; e < out_w * in_w; e += kThreads) w[(e / in_w) * st + e % in_w] = p[e];
      p += out_w * in_w;
      for (int o = tid; o < out_w; o += kThreads) w[out_w * st + o] = p[o];
      p += out_w;
    }
  }
  for (int e = tid; e < lay.n_entries; e += kThreads) idx[e] = a.cons[e];
  for (int e = tid; e < kD * a.degree; e += kThreads) inv[e] = a.inverse[e];
  const int row0 = blockIdx.x * a.rows;
  const int nr = min(a.rows, a.n - row0);
  for (int k = tid; k < kD; k += kThreads) {
    const float s = a.scale[k];
    const float m = a.min_[k];
    sc[k] = s;
    mn[k] = m;
    mut[k] = static_cast<int>(a.mutable_[k]);
    for (int r = 0; r < nr; ++r) {
      const Row w = row_at(rows, lay, r);
      const size_t at = static_cast<size_t>(row0 + r) * kD + k;
      w.x[k] = a.x_start[at];
      w.xi[k] = a.x_init[at];
      w.u[k] = unscale(w.x[k], m, s);
    }
  }
  __syncthreads();

  const bool linf = a.flags & 1;
  const bool repair = a.flags & 2;
  const bool targeted = a.flags & 4;
  const bool hist_norm = a.hist != nullptr && (a.flags & 8);
  const bool hist_full = a.hist != nullptr && (a.flags & 16);
  const int g_col = (a.flags & 8) ? 4 : 3;
  const int n_first = nr * w1;
  const int n_other = lay.n_terms - 2;  // ratios and orderings
  const int n_tasks = n_first + nr * lay.n_terms;
  long long last = 0;
#ifdef K7B_STAMPS
  last = clock64();
#endif
  for (int it = 0; it < a.t; ++it) {
    const float wc = a.w_class[it];
    const float wk = a.w_cons[it];
    const float stp = a.step[it];
    const int ctr = a.ctr[it];
    // the first layer's units of every row; the terms of every row and the
    // cotangents of their entries, the flow sums first
    for (int task = tid; task < n_tasks; task += kThreads) {
      if (task < n_first) {
        const int r = task / w1;
        const int o = task - r * w1;
        const Row s = row_at(rows, lay, r);
        s.act[o] = relu_keep_nan(first_unit(a.first_t, w1, ws[o], s.x, o));
      } else {
        int q = task - n_first;
        int r, t;
        if (q < 2 * nr) {
          r = q >> 1;
          t = q & 1;
        } else {
          q -= 2 * nr;
          r = q / n_other;
          t = 2 + (q - r * n_other);
        }
        const Row s = row_at(rows, lay, r);
        const float g = term_vjp(lay, idx, s.u, t, ctr < 0 || ctr == t ? -wk : 0.0f, a.tol, s.ent);
        s.g[t] = g;
        if (hist_full) a.hist[(static_cast<size_t>(it) * a.n + row0 + r) * a.hist_cols + g_col + t] = g;
      }
    }
    phase_end(0, last);
    hidden_forward(a, lay, ws, rows, nr, tid, last);
    // a thread per row: the cross-entropy and the cotangent of the logits;
    // the history's loss columns
    if (lane == 0 && warp < nr) {
      const Row s = row_at(rows, lay, warp);
      const float lc = cross_entropy(classes, targeted, s.act + lay.act_off[a.n_layers - 1],
                                     static_cast<int>(a.y[row0 + warp]), wc, s.cta);
      if (a.hist != nullptr) {
        float cons = s.g[0];
        if (ctr < 0) {
          for (int t = 1; t < lay.n_terms; ++t) cons = __fadd_rn(cons, s.g[t]);
        } else {
          cons = s.g[ctr];
        }
        float* h = a.hist + (static_cast<size_t>(it) * a.n + row0 + warp) * a.hist_cols;
        h[0] = __fadd_rn(__fmul_rn(wc, lc), __fmul_rn(wk, -cons));
        h[1] = lc;
        h[2] = cons;
      }
    }
    phase_end(2, last);
    const bool ct1_in_b = hidden_backward(a, lay, ws, rows, nr, tid, last);
    // a thread per feature: the input backward of every row (each weight
    // read once for all of them), its sum of the constraints' cotangents,
    // the gradient and the squares its L2 sums add
    {
      const float* ct1[kMaxRows];
      Row rs[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        rs[r] = row_at(rows, lay, r < nr ? r : 0);
        ct1[r] = ct1_in_b ? rs[r].ctb : rs[r].cta;
      }
      for (int k = tid; k < kD; k += kThreads) {
        // the feature's w1 weights, all loads issued before the sums
        float w[kBotnetMaxWidth];
#pragma unroll
        for (int o = 0; o < kBotnetMaxWidth; ++o) w[o] = o < w1 ? __ldg(a.params + o * kD + k) : 0.0f;
        float acc[kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < nr) acc[r] = __fmul_rn(ct1[r][0], w[0]);
#pragma unroll
        for (int o = 1; o < kBotnetMaxWidth; ++o) {
          if (o < w1) {
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r)
              if (r < nr) acc[r] = __fadd_rn(acc[r], __fmul_rn(ct1[r][o], w[o]));
          }
        }
        const int* in = inv + k * a.degree;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            float cu = 0.0f;
            for (int j = 0; j < a.degree && in[j] >= 0; ++j) cu = __fadd_rn(cu, rs[r].ent[in[j]]);
            const float gv = __fadd_rn(acc[r], __fdiv_rn(cu, sc[k]));
            const float gm = isnan(gv) || !mut[k] ? 0.0f : gv;
            const float f = isfinite(gv) ? gv : 0.0f;
            rs[r].gr[k] = gv;
            rs[r].sq[k] = __fmul_rn(gm, gm);
            rs[r].sqh[k] = __fmul_rn(f, f);
          }
        }
      }
    }
    phase_end(4, last);
    // a thread per row: the L2 norm of the masked gradient; on another warp
    // the history's L2 norm of the raw gradient's finite entries
    if (lane == 0 && warp < nr && !linf) {
      const Row s = row_at(rows, lay, warp);
      s.aux[0] = __fadd_rn(__fsqrt_rn(row_sum(s.sq)), 1e-7f);
    }
    if (lane == 0 && warp >= kMaxRows && warp - kMaxRows < nr && hist_norm) {
      const int r = warp - kMaxRows;
      a.hist[(static_cast<size_t>(it) * a.n + row0 + r) * a.hist_cols + 3] = __fsqrt_rn(row_sum(row_at(rows, lay, r).sqh));
    }
    phase_end(5, last);
    // the masked, conditioned step and the clip; the perturbation into u
    for (int k = tid; k < kD; k += kThreads) {
      for (int r = 0; r < nr; ++r) {
        const Row s = row_at(rows, lay, r);
        const float gv = s.gr[k];
        const float gm = isnan(gv) || !mut[k] ? 0.0f : gv;
        const float d = linf ? (gm > 0.0f ? 1.0f : (gm < 0.0f ? -1.0f : 0.0f)) : __fdiv_rn(gm, s.aux[0]);
        const float x = clamp_nan(__fadd_rn(s.x[k], __fmul_rn(stp, d)), a.lo, a.hi);
        const float u = __fsub_rn(x, s.xi[k]);
        s.u[k] = u;
        s.sq[k] = __fmul_rn(u, u);
      }
    }
    phase_end(6, last);
    // the projection factor, a thread per row
    if (!linf) {
      if (lane == 0 && warp < nr) {
        const Row s = row_at(rows, lay, warp);
        s.aux[1] = nan_min(1.0f, __fdiv_rn(a.eps, __fadd_rn(__fsqrt_rn(row_sum(s.sq)), 1e-12f)));
      }
      phase_end(7, last);
    }
    // the projection, the clip, repair's round trip through the scaler; the
    // next unscaled row
    for (int k = tid; k < kD; k += kThreads) {
      for (int r = 0; r < nr; ++r) {
        const Row s = row_at(rows, lay, r);
        const float d = linf ? clamp_nan(s.u[k], -a.eps, a.eps) : __fmul_rn(s.u[k], s.aux[1]);
        float x = clamp_nan(__fadd_rn(s.xi[k], d), a.lo, a.hi);
        if (repair && mut[k]) x = __fadd_rn(__fmul_rn(unscale(x, mn[k], sc[k]), sc[k]), mn[k]);
        s.x[k] = x;
        s.u[k] = unscale(x, mn[k], sc[k]);
      }
    }
    phase_end(8, last);
  }

  // the class at x_adv
  for (int task = tid; task < n_first; task += kThreads) {
    const int r = task / w1;
    const int o = task - r * w1;
    const Row s = row_at(rows, lay, r);
    s.act[o] = relu_keep_nan(first_unit(a.first_t, w1, ws[o], s.x, o));
  }
  __syncthreads();
  hidden_forward(a, lay, ws, rows, nr, tid, last);
  if (lane == 0 && warp < nr)
    a.pred[row0 + warp] = predicted_class(classes, row_at(rows, lay, warp).act + lay.act_off[a.n_layers - 1]);
  for (int k = tid; k < kD; k += kThreads)
    for (int r = 0; r < nr; ++r) a.x_adv[static_cast<size_t>(row0 + r) * kD + k] = row_at(rows, lay, r).x[k];
}

}  // namespace

cudaError_t launch_pgd_botnet(PgdBotnetArgs args, cudaStream_t stream) {
  if (args.n == 0) return cudaSuccess;
  const int n_layers = args.n_layers;
  if (args.n < 0 || args.t < 0 || n_layers < 2 || n_layers > kObjectiveMaxLayers || args.widths[0] != kD ||
      args.widths[n_layers] < 1 || args.widths[n_layers] > 2 || args.degree < 1 ||
      args.degree > kPgdBotnetMaxDegree)
    return cudaErrorInvalidValue;
  const int* c = args.counts;
  for (int s = 0; s < kBotnetSegments; ++s)
    if (c[s] < 0 || (s < 4 && c[s] < 1) || (s >= 4 && s % 2 == 0 && c[s] != c[s + 1])) return cudaErrorInvalidValue;
  Layout lay{};
  for (int s = 0; s < kBotnetSegments; ++s) lay.seg[s + 1] = lay.seg[s] + c[s];
  lay.n_entries = lay.seg[kBotnetSegments];
  lay.ord_start[0] = 2 + c[4];
  lay.ord_start[1] = lay.ord_start[0] + c[6];
  lay.ord_start[2] = lay.ord_start[1] + c[8];
  lay.n_terms = lay.ord_start[2] + c[10];
  const int cols = 3 + ((args.flags & 8) ? 1 : 0) + ((args.flags & 16) ? lay.n_terms : 0);
  if (args.hist != nullptr && args.hist_cols != cols) return cudaErrorInvalidValue;
  lay.staged_floats = pad4(args.widths[1]);
  for (int l = 0; l < n_layers; ++l) {
    const int in_w = args.widths[l];
    const int out_w = args.widths[l + 1];
    if (out_w < 1 || (l + 1 < n_layers && out_w > kBotnetMaxWidth)) return cudaErrorInvalidValue;
    lay.act_off[l] = lay.act_floats;
    lay.act_floats += out_w;
    if (l == 0) continue;
    lay.w_off[l] = lay.staged_floats;
    lay.staged_floats += out_w * ((in_w | 1) + 1);
  }
  lay.staged_floats = pad4(lay.staged_floats);
  lay.row_floats = 6 * kD + pad4(lay.n_entries) + pad4(lay.n_terms) + pad4(lay.act_floats) + 2 * kBotnetMaxWidth + 4;
  static LaunchCache cache;
  int sms = 0;
  cudaError_t err = cache.sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int rows = (args.n + sms - 1) / sms;
  args.rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const size_t smem = sizeof(float) * (static_cast<size_t>(lay.staged_floats) + 3 * kD + pad4(lay.n_entries) +
                                       static_cast<size_t>(kD) * args.degree +
                                       static_cast<size_t>(args.rows) * lay.row_floats);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  err = cache.prepare(reinterpret_cast<const void*>(pgd_botnet_kernel), kThreads, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (args.n + args.rows - 1) / args.rows;
  pgd_botnet_kernel<<<grid, kThreads, smem, stream>>>(args, lay);
  return cudaGetLastError();
}

#ifdef K7B_STAMPS
extern "C" const char* k7b_phase_names() {
  return "terms and first layer;hidden forward;cross-entropy;hidden backward;input backward and gradient;"
         "gradient norm;step;projection factor;projection and repair";
}

// the warps whose stamps k7b_take_cycles returns: thread 0's alone
extern "C" int k7b_stamped_warps() { return 1; }

// copies K7b's per-phase cycles to `out` (kPhases values) and zeroes them
extern "C" int k7b_take_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k7b_cycles, sizeof(k7b_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k7b_cycles, zero, sizeof(zero)));
}
#endif
