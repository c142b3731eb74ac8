// K7b: constrained PGD on the CTU-13 botnet domain (756 features, 360
// terms) and on its augmented variant (756 + 171 XOR pair features, 360 +
// 171 terms), every iteration of one run in one launch.
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
// x back in float32); and (kAuto) that of attacks/pgd/autopgd.py::
// AutoPGD._one_run (:45) on the same domain. On the augmented domain
// (pgd_botnet_aug_kernel) the same programs run over domains/botnet.py::
// BotnetAugmentedConstraints (:130-150: _raw :144 adds domains/
// augmentation.py::consistency_terms :84), without repair, which that set
// leaves undefined (:148). The repo has no Pallas kernel for any of them.
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
//   engine.py::predict_plain;
// - AutoPGD (kAuto) as attacks/pgd/autopgd.py::autopgd_run_plain: the
//   tracking loss tw_class * CE + tw_cons * (-cons), cons the term tctr (or
//   the sum from the first), at x_start before the first iteration and at
//   x_new after each; the step with the row's eta instead of the
//   schedule's; z clipped, projected and clipped, then the momentum x +
//   alpha (z - x) + (1 - alpha)(x - x_prev) added left to right (alpha 1 at
//   iteration 0: 0 * (x - x_prev) keeps a NaN), clipped, projected and
//   clipped, then repair's round trip; the best point where the tracking
//   loss rose above the best (a NaN never does), the rises counted in
//   float32; at a checkpoint (is_ckpt[i + 1]) eta halved and x restarted
//   from the best point (x_prev stays the x the iteration started from)
//   where the rises since the last one are below ckpt_thr[i + 1], or eta and
//   the best loss are both what they were at the last one; the result is the
//   best point, the class there and each row's eta.
//
// Bound: per row and iteration, 4 operations per weight of the stack (a
// multiply and an add, forward and input backward: 4 x 54,592 for
// 756-64-64-32-2), about 25 per feature (unscaling, the cotangents' sum,
// masking, conditioning, the step, the clips, the projection, repair's
// round trip) and a few per gathered entry and term: about 2.4e5 fp32
// operations, 9.3e10 for rq1.botnet's 387 rows x 1000 iterations, 1.4 ms at
// 67 TFLOP/s; the rows' bytes are negligible. Bound by operations. The
// fixed left-to-right orders make serial chains in every iteration,
// whatever the parallelism: each first-layer unit (756 adds), the two L2
// sums over 756 features, the deeper layers and the cross-entropy, some
// 2,700 dependent operations (chip_smoke.py's pgd_botnet_floor_ms counts
// them): a latency floor four times the bound. AutoPGD adds the tracking
// forward (2 operations per weight), the terms' forward and cons' sum and
// about 18 operations per feature: a bound of 2.1 ms, and to the floor the
// tracking forward's chains and the second projection's L2 sum
// (chip_smoke.py's autopgd_botnet_bound and autopgd_botnet_floor_ms).
// Tensor cores are not used: their sums have an order no CPU code
// reproduces.
//
// Design: the first layer (756 x 64 floats, 189 KB) is read twice an
// iteration, forward and backward, and does not fit one SM beside the rows
// (the first version read it from L2, 61% of its time), so a cluster of two
// CTAs on neighbouring SMs holds it, split by features: CTA r stages, once,
// columns [378 r, 378 r + 378) of every unit, unit by unit at a stride of
// 380 floats (a multiple of 4 whose quarter is odd): the forward's threads,
// a unit each, read 4 consecutive features of their unit with one
// conflict-free 16-byte load, and the backward's threads, a feature each,
// read consecutive words. The cluster runs `rows` rows (at most kMaxRows,
// as few as spread N over the resident clusters in one wave: 6 at 387 rows
// on 66 clusters); each CTA keeps a row's iterate and squares for its own
// features, and rank 0 the unscaled row u of all 756 (the terms gather any
// feature). A feature's owner thread keeps its scale, min, mask,
// inverse-table row, x_init and gradient in registers. Each chain keeps its
// order across the pair: a unit's sum runs over rank 0's features and is
// carried on by rank 1 from rank 0's partial sum, and an L2 sum likewise; a
// feature's backward sum is local. An iteration, rank 0 | rank 1, "->" a
// hand-off to the peer:
//   the first layer's half from the biases -> | ;
//   the 360 terms of every row, the cotangents of rank 1's entries -> |
//     the first layer's second half, the deeper layers, the cross-entropy
//     and the backward to the first layer's output ->;
//   both: the input backward, the cotangent sums, the gradient and the
//     squares of the own features;
//   the first half of each row's two L2 sums (gradient, history) -> | the
//     second half, the norm ->;
//   both: the step and the squares of the perturbation;
//   the projection factor's sum, its halves as above;
//   both: the projection, the clip and repair's round trip | u ->.
// A hand-off writes into the peer's shared memory with st.async, each word
// counted on the peer's mbarrier (Pair, below): a cluster barrier or a
// cluster-scope fence would cost ~1000 cycles each (PERF.md). Each
// forward thread runs a unit for a tile of 3 rows, so a weight load serves
// 3 rows, and the deeper layers likewise; the rows' L2 sums run one lane
// each on warp 0 (the history's on lanes 8 and up); the history's sum of
// the terms, on rank 0's spare threads beside the input backward; a zero
// numerator skips the division's slow path (div_rn). Loops stay rolled
// past their chunk of loads: code the instruction caches do not hold costs
// more than its arithmetic (PERF.md).
//
// AutoPGD is its own instantiation (kAuto), as K7's: a launch runs 2T + 2
// passes of the same code, each hand-off's phase counted per kind (Phases).
// An even pass is the tracking loss at x, a forward: rank 0 the first
// layer's half and the terms (their backward unused, nothing handed off),
// then each row's cons; rank 1 the rest of the stack and the
// cross-entropy. Each CTA hands its value of a row to the other (kTrack),
// and both take the same decisions from the same per-row state, which each
// keeps: the best and the previous loss, eta, the rises and the last
// checkpoint's eta and best loss. Then each copies x to x_best, or x_best
// back to x, on its own features; a restarted row's u is unscaled again
// from x, rank 1's half handed to rank 0 (kU) and taken before the next
// terms. An odd pass is an iteration: PGD's with the row's eta, and under
// L2 z's projection factor, the momentum (x_prev takes x) and a second
// factor for it, each factor's halves handed off as PGD's one; under L-inf
// the momentum and its clips in the projection's phase. The last pass is
// the class at x_best. x_prev and x_best are two more row buffers at the
// CTA's features (2 x 380 floats a row) and the state 8 floats, so 6 rows
// still fit one cluster. At kAuto = false all of it is compiled out.
//
// The augmented domain is its own pair of instantiations, for 927 features
// (pgd_botnet_aug_kernel; Dims gives every size from the feature count):
// rank 0 takes features [0, 464), rank 1 [464, 927), a thread each (480 a
// CTA), at a stride of 468 floats. Rank 1's last slot holds x = -0 and
// weights of +0, and its squares are -0: their products and squares add -0,
// which changes no sum (+0 + -0 = +0, -0 + -0 = -0), so each chain keeps
// the plain version's 927 operations. The pair terms follow the 360 in the
// sum, the single and alternate constraints' choice and the history; a
// pair's term reads u at its two base features and its column on rank 0,
// and its cotangent (added, in the plain version, to the +0 that the base
// entries leave at the column) goes straight to rank 1, which owns every
// pair column, into rank 1's copy of u there (rank 1 reads nothing else of
// it), counted on the entries' barrier (kEnt). The thresholds and pairs are
// read from global memory: staged, they would cost a row of the 5 that fit
// (4 under kAuto), so 387 rows take two waves. Repair is refused: the set
// has none.

#include <algorithm>

#include <cooperative_groups.h>

#include "pgd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = kPgdBotnetMaxRows;
constexpr int kTile = 3;  // rows per thread in the first layer's forward
constexpr int kMaxDegree = kPgdBotnetMaxDegree;
constexpr float kMtu = 1500.0f;
static_assert(kMaxRows <= 8, "warp 0's lanes 0-7 and 8-15 run the rows' two L2 sums");

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The geometry of the instantiation for rows of D features (botnet's 756,
// or 756 + P on the augmented domain)
template <int D>
struct Dims {
  static constexpr int kD = D;
  static constexpr int kH = (D + 1) / 2;                 // rank 0's features
  static constexpr int kH1 = D - kH;                     // rank 1's, one fewer where D is odd
  static constexpr int kHP = (((kH + 3) / 4) | 1) * 4;   // their stride in the staged layer and the rows
  static constexpr int kThreads = (kH + 31) / 32 * 32;   // a thread per feature of the CTA's share
  static constexpr int kP = D - kBotnetFeatures;         // the XOR pairs, their columns the last
  static_assert(kH <= kHP && kHP % 4 == 0 && (kHP / 4) % 2 == 1, "conflict-free 16-byte loads of a unit's features");
  static_assert(kH1 == kH || kH1 + 1 == kH, "rank 1's share is rank 0's or one fewer");
  static_assert(kMaxRows * kBotnetMaxWidth <= kThreads, "a thread per unit of every row");
  static_assert(kMaxRows * 64 <= kThreads, "each row's flow sums on threads of their own");
  static_assert(kP >= 0 && (kP == 0 || kH <= kBotnetFeatures), "every pair column is rank 1's");
};

struct Layout {
  int w_off[kObjectiveMaxLayers];     // staged layers 1..L-1: weight (out, odd stride), then bias
  int act_off[kObjectiveMaxLayers];   // each layer's output in a row's activations
  int seg[kBotnetSegments + 1];       // each segment's first entry in the gather lists
  int ord_start[3];                   // each ordering's first term
  int n_entries, n_terms;
  int n_base;                         // the base domain's terms (360), the pairs' after them
  int ws_floats;                      // the first layer's bias, then layers 1..L-1
  int act_floats;                     // a row's activations: the widths of layers 1..L
  int row_floats;                     // a row's slice
};

// a row's slice of shared memory, the same on both CTAs
struct Row {
  float* x;    // (kHP) the iterate (scaled) at the CTA's features
  float* sq;   // (kHP) the squares an L2 sum adds: of the masked gradient, then of the perturbation
  float* sqh;  // (kHP) the squares of the raw gradient's finite entries (the history's grad norm)
  float* u;    // (kD, padded to 4) rank 0: the unscaled iterate at every feature; rank 1: the pairs'
               // cotangents at their columns, from rank 0's terms (nothing else reads it there)
  float* ent;  // the cotangent of each entry of the gather lists
  float* g;    // the smooth violations
  float* act;  // the activations of layers 1..L, logits last; rank 1: rank 0's partial sums first
  float* cta;  // cotangents, ping
  float* ctb;  // and pong
  float* aux;  // [gradient norm + 1e-7, projection factor, the partial L2 sums (gradient, history), class
               //  loss, the partial projection sum, -, the word an L-inf hand-off carries]
  float* xp;   // kAuto: (kHP) x_prev at the CTA's features
  float* xb;   // kAuto: (kHP) x_best
  float* au;   // kAuto: the row's state (AutoState)
};

// AutoPGD's state of a row, kept alike by both CTAs: the best tracking
// loss, the previous one, the best at the last checkpoint, the step, the
// step at the last checkpoint, the rises since the last checkpoint, what
// the pass's copies do (1: x_best takes x, 2: x restarts from x_best; as
// int bits), and the peer's value of the tracking loss (rank 0: the class
// loss, rank 1: cons)
enum AutoState { kFBest, kFPrev, kFBck, kEta, kEtaCk, kImpr, kMove, kPeer, kAutoState };

template <int kD>
__device__ __forceinline__ Row row_at(float* rows, const Layout& lay, int r) {
  constexpr int kHP = Dims<kD>::kHP;
  Row s;
  s.x = rows + r * lay.row_floats;
  s.sq = s.x + kHP;
  s.sqh = s.sq + kHP;
  s.u = s.sqh + kHP;
  s.ent = s.u + pad4(kD);  // the buffers after u stay 16-byte aligned
  s.g = s.ent + pad4(lay.n_entries);
  s.act = s.g + pad4(lay.n_terms);
  s.cta = s.act + pad4(lay.act_floats);
  s.ctb = s.cta + kBotnetMaxWidth;
  s.aux = s.ctb + kBotnetMaxWidth;
  s.xp = s.aux + 8;
  s.xb = s.xp + kHP;
  s.au = s.xb + kHP;
  return s;
}

// a row's floats besides its variable parts, and AutoPGD's besides those
template <int kD>
constexpr int row_tail() { return 3 * Dims<kD>::kHP + pad4(kD) + 2 * kBotnetMaxWidth + 8; }
template <int kD>
constexpr int auto_row_floats() { return 2 * Dims<kD>::kHP + kAutoState; }
static_assert(row_tail<kBotnetFeatures>() % 4 == 0 && row_tail<kBotnetFeatures + kPgdBotnetAugPairs>() % 4 == 0 &&
                  auto_row_floats<kBotnetFeatures>() % 4 == 0 &&
                  auto_row_floats<kBotnetFeatures + kPgdBotnetAugPairs>() % 4 == 0,
              "a row's slice keeps the next row 16-byte aligned");

// acc + (x0 * w0 + ...) of 4 features, left to right
__device__ __forceinline__ float add4(float acc, float4 x, float4 w) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, __fmul_rn(x.x, w.x)), __fmul_rn(x.y, w.y)), __fmul_rn(x.z, w.z)),
                   __fmul_rn(x.w, w.w));
}

// The CTA's share of the first layer's sums of unit o for the kTile rows
// of tile t: each from acc, adding x[k] * w[o][k] over the CTA's kH
// features in order (rows past nr repeat the last row), 16 features at a
// time, each chunk's loads issued together before its adds. Where rank 1
// holds one feature fewer, its last slot holds x = -0 and w = +0, whose
// product -0 adds nothing to any sum (+0 and -0 included).
template <int kD>
__device__ __forceinline__ void first_half(const float* wf, float* rows, const Layout& lay, int nr, int t, int o,
                                           float (&acc)[kTile]) {
  constexpr int kH = Dims<kD>::kH;
  constexpr int kHP = Dims<kD>::kHP;
  const float4* x4[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j)
    x4[j] = reinterpret_cast<const float4*>(row_at<kD>(rows, lay, min(t * kTile + j, nr - 1)).x);
  const float4* w4 = reinterpret_cast<const float4*>(wf + o * kHP);
  constexpr int kFull = kH / 16 * 4;  // the float4s of the full chunks
#pragma unroll 1
  for (int k4 = 0; k4 < kFull; k4 += 4) {
    float4 w[4], v[kTile][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = w4[k4 + i];
#pragma unroll
      for (int j = 0; j < kTile; ++j) v[j][i] = x4[j][k4 + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = add4(acc[j], v[j][i], w[i]);
  }
  // the rest, kH % 16 features: whole float4s, then the first of one more
  constexpr int kRest = kH - kFull * 4;
  constexpr int kR4 = kRest / 4;
  constexpr int kR1 = kRest % 4;
  constexpr int kLoads = kR4 + (kR1 > 0 ? 1 : 0);
  static_assert(kFull * 4 + 4 * kLoads <= kHP, "the rest's loads stay in the unit's stride");
  if constexpr (kLoads > 0) {
    float4 w[kLoads], v[kTile][kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      w[i] = w4[kFull + i];
#pragma unroll
      for (int j = 0; j < kTile; ++j) v[j][i] = x4[j][kFull + i];
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float s = acc[j];
#pragma unroll
      for (int i = 0; i < kR4; ++i) s = add4(s, v[j][i], w[i]);
      if constexpr (kR1 >= 1) s = __fadd_rn(s, __fmul_rn(v[j][kR4].x, w[kR4].x));
      if constexpr (kR1 >= 2) s = __fadd_rn(s, __fmul_rn(v[j][kR4].y, w[kR4].y));
      if constexpr (kR1 >= 3) s = __fadd_rn(s, __fmul_rn(v[j][kR4].z, w[kR4].z));
      acc[j] = s;
    }
  }
}

// sum_last's chain over the CTA's kH squares in q, from `sum` (-0 on rank
// 0: it adds the first square exactly), 32 squares at a time, each chunk's
// loads issued before the previous chunk's adds. Where rank 1 holds one
// feature fewer, its last square is -0, which adds nothing.
template <int kD>
__device__ __forceinline__ float half_sum(const float* q, float sum) {
  constexpr int kH = Dims<kD>::kH;
  constexpr int kHP = Dims<kD>::kHP;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  constexpr int kFull = kH / 32 * 8;  // the float4s of the full chunks
  constexpr int kRest = kH - kFull * 4;
  // the last chunk's loads read up to 32 floats past the full chunks: past
  // the kHP squares into the row's next buffer (sq's sqh, sqh's u), unused
  static_assert(kFull * 4 + 32 <= 2 * kHP, "the last loads stay in the row");
  float4 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = q4[i];
#pragma unroll 1
  for (int k4 = 8; k4 <= kFull; k4 += 8) {  // the last loads hold the rest (and 6 floats past it, unused)
    float4 n[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) n[i] = q4[k4 + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, v[i].x), v[i].y), v[i].z), v[i].w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = n[i];
  }
  // the rest, in v: whole float4s, then the first of one more
#pragma unroll
  for (int i = 0; i < kRest / 4; ++i)
    sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, v[i].x), v[i].y), v[i].z), v[i].w);
  if constexpr (kRest % 4 >= 1) sum = __fadd_rn(sum, v[kRest / 4].x);
  if constexpr (kRest % 4 >= 2) sum = __fadd_rn(sum, v[kRest / 4].y);
  if constexpr (kRest % 4 >= 3) sum = __fadd_rn(sum, v[kRest / 4].z);
  return sum;
}

// acc + a[0] * b[0] + a[sa] * b[sb] + ... (n products, left to right): a
// unit's sum in the deeper layers, 8 products at a time, each chunk's loads
// issued together before its adds
__device__ __forceinline__ float dot_chain(float acc, const float* a, int sa, const float* b, int sb, int n) {
  int k = 0;
#pragma unroll 1
  for (; k + 8 <= n; k += 8) {
    float pa[8], pb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j] = a[(k + j) * sa];
      pb[j] = b[(k + j) * sb];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, __fmul_rn(pa[j], pb[j]));
  }
  for (; k < n; ++k) acc = __fadd_rn(acc, __fmul_rn(a[k * sa], b[k * sb]));
  return acc;
}

#ifdef K7B_STAMPS
// tools/probe_pgd_botnet.py's breakdown: per phase, the clock64() cycles
// from the previous stamp, seen by thread 0 of each CTA of cluster 0 (rank
// 0's row, then rank 1's) and summed over the iterations; a wait for the
// peer's hand-off is a phase of its own.
// Summed in shared memory (a stamp in global memory would hold thread 0
// back by its latency at every phase) and added to k7b_cycles at the end.
constexpr int kPhases = 19;
__device__ unsigned long long k7b_cycles[2 * kPhases];
__shared__ unsigned long long k7b_block_cycles[kPhases];
#endif

__device__ __forceinline__ void stamp(int i, long long& last) {
#ifdef K7B_STAMPS
  if (threadIdx.x == 0) {
    const long long now = clock64();
    k7b_block_cycles[i] += now - last;
    last = now;
  }
#endif
}

// the block barrier that ends phase i
__device__ __forceinline__ void block_end(int i, long long& last) {
  __syncthreads();
  stamp(i, last);
}

// The hand-offs between the CTAs of the pair. The sender writes each word
// into the receiver's copy of a buffer with st.async, which counts its
// bytes on the receiver's mbarrier of that kind of hand-off; the receiver
// expects the bytes and its threads wait for the barrier's phase. A phase
// completes once its bytes have landed, so no fence is needed: a cluster
// barrier costs ~1250 cycles on the H100, and a cluster-scope fence, which
// waits for all of the SM's outstanding writes, about as much (PERF.md).
// One barrier per kind, each used once per iteration, so that a phase
// never holds the bytes of the next. AutoPGD uses some kinds twice an
// iteration (the partial sums, u, the projection factor's halves) and
// kTrack once: each use's bytes are sent only after the peer has seen the
// previous use's phase complete (it then sends what the sender waits on),
// so that holds there too.
enum Kind { kPartials, kCotangent, kEnt, kHalves, kNorm, kFactorHalf, kFactor, kU, kTrack, kKinds };
constexpr int kBarFloats = 16;      // the barriers' room at the start of shared memory, keeping what follows aligned
constexpr int kAutoBarFloats = 20;  // and AutoPGD's, with kTrack's
static_assert(2 * kTrack <= kBarFloats && kBarFloats % 4 == 0, "8 bytes a barrier");
static_assert(2 * kKinds <= kAutoBarFloats && kAutoBarFloats % 4 == 0, "8 bytes a barrier");

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool bar_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}
__device__ __forceinline__ void put_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

struct Pair {
  unsigned base;       // this CTA's shared memory: the barriers, one per kind, first
  unsigned peer_base;  // the peer's, in the cluster's shared window

  // v into the peer's copy of *p, counted on the peer's barrier of kind k
  __device__ __forceinline__ void put(const float* p, float v, int k) const {
    put_async(peer_base + (shared_addr(p) - base), v, peer_base + 8 * k);
  }

  // phase `phase` of this CTA's barrier of kind k, which brings `bytes`:
  // thread 0 expects them, every thread waits (a sender that never sends
  // traps the launch after some seconds rather than hang the card)
  __device__ __forceinline__ void take(int k, unsigned bytes, int phase) const {
    if (threadIdx.x == 0) bar_expect(base + 8 * k, bytes);
    for (long long spin = 0; !bar_done(base + 8 * k, phase & 1); ++spin)
      if (spin > (1ll << 26)) __trap();
  }
};

// AutoPGD's phase of each kind of hand-off a CTA takes, a bit each: every
// thread of the CTA takes the same hand-offs in the same order
struct Phases {
  unsigned bits = 0;
  // the phase of kind k's next hand-off
  __device__ __forceinline__ int next(int k) {
    const int p = (bits >> k) & 1;
    bits ^= 1u << k;
    return p;
  }
};

// Term t of a row whose gathered values are in ent (ent[e] = u[idx[e]]): its
// smooth violation, returned, and the cotangents of its entries of the
// gather lists into ent over their values, from the term's cotangent ct
// (smooth_vjp's operations). Each entry is one term's.
__device__ __forceinline__ float term_vjp(const Layout& lay, float* ent, int t, float ct, float tol) {
  float pre;
  if (t < 2) {  // |sum(flows) - sum(bytes)| of direction t
    const int f0 = t == 0 ? lay.seg[0] : lay.seg[2];
    const int b0 = t == 0 ? lay.seg[1] : lay.seg[3];
    const int b1 = t == 0 ? lay.seg[2] : lay.seg[4];
    float sf = ent[f0];
#pragma unroll 8
    for (int e = f0 + 1; e < b0; ++e) sf = __fadd_rn(sf, ent[e]);
    float sb = ent[b0];
#pragma unroll 8
    for (int e = b0 + 1; e < b1; ++e) sb = __fadd_rn(sb, ent[e]);
    const float v = __fsub_rn(sf, sb);
    pre = __fsub_rn(fabsf(v), tol);
    const float cv = abs_vjp(v, clip_vjp(pre, ct));
    for (int e = f0; e < b0; ++e) ent[e] = cv;
    for (int e = b0; e < b1; ++e) ent[e] = -cv;
  } else if (t < lay.ord_start[0]) {  // where(p != 0, b / where(p != 0, p, 1), 0) - 1500
    const int eb = lay.seg[4] + t - 2;
    const int ep = lay.seg[5] + t - 2;
    const float b = ent[eb];
    const float p = ent[ep];
    const bool nz = p != 0.0f;
    const float den = nz ? p : 1.0f;
    pre = __fsub_rn(__fsub_rn(nz ? div_rn(b, den) : 0.0f, kMtu), tol);
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
    pre = __fsub_rn(__fsub_rn(ent[lo], ent[up]), tol);
    const float c = clip_vjp(pre, ct);
    ent[lo] = c;
    ent[up] = -c;
  }
  return clip_smooth(pre);
}

// Pair p's term of a row (the augmented domain): v = u[756 + p] - xor(u[i]
// >= thr_0, u[j] >= thr_1) (a NaN compares false), its smooth violation
// clip(|v| - tol, 0) returned; where `send`, its cotangent abs_vjp(v,
// clip_vjp(pre, ct)) is handed to rank 1, which owns every pair column,
// into its copy of u at the column. No cotangent flows through the
// comparisons.
__device__ __forceinline__ float pair_term(const PgdBotnetArgs& a, const Row& s, const Pair& pair, int p, float ct,
                                           bool send) {
  const int i0 = __ldg(a.pair_idx + 2 * p);
  const int i1 = __ldg(a.pair_idx + 2 * p + 1);
  const bool b0 = s.u[i0] >= __ldg(a.pair_thr + 2 * p);
  const bool b1 = s.u[i1] >= __ldg(a.pair_thr + 2 * p + 1);
  float* col = s.u + kBotnetFeatures + p;
  const float v = __fsub_rn(*col, b0 != b1 ? 1.0f : 0.0f);
  const float pre = __fsub_rn(fabsf(v), a.tol);
  if (send) pair.put(col, abs_vjp(v, clip_vjp(pre, ct)), kEnt);
  return clip_smooth(pre);
}

// Rank 0: the terms of every row and the cotangents of their entries: first
// every entry's gathered value, then the terms, row by row, term t of row r
// on thread t + 64 r (mod the threads), so that each row's flow sums, the
// longest terms, fall on threads of their own and a warp's terms are alike
// (with `hist` their history columns from col); a pair's term hands its
// cotangent to rank 1 itself; last, where `send`, the cotangents of the
// entries whose feature is rank 1's, handed to rank 1
template <int kD>
__device__ __forceinline__ void all_terms(const PgdBotnetArgs& a, const Layout& lay, const int* idx, float* rows,
                                          const Pair& pair, int nr, int row0, int it, float ctr_w, int ctr,
                                          float* hist, int col, bool send) {
  constexpr int kThreads = Dims<kD>::kThreads;
  for (int r = 0; r < nr; ++r) {
    const Row s = row_at<kD>(rows, lay, r);
    for (int e = threadIdx.x; e < lay.n_entries; e += kThreads) s.ent[e] = s.u[idx[e]];
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    const Row s = row_at<kD>(rows, lay, r);
    int t = static_cast<int>(threadIdx.x) - 64 * r;
    for (t += t < 0 ? kThreads : 0; t < lay.n_terms; t += kThreads) {
      const float ct = ctr < 0 || ctr == t ? ctr_w : 0.0f;
      float g;
      if (Dims<kD>::kP > 0 && t >= lay.n_base) {
        g = pair_term(a, s, pair, t - lay.n_base, ct, send);
      } else {
        g = term_vjp(lay, s.ent, t, ct, a.tol);
      }
      s.g[t] = g;
      if (hist != nullptr) hist[(static_cast<size_t>(it) * a.n + row0 + r) * a.hist_cols + col + t] = g;
    }
  }
  __syncthreads();
  if (!send) return;
  for (int r = 0; r < nr; ++r) {
    const Row s = row_at<kD>(rows, lay, r);
    for (int e = threadIdx.x; e < lay.n_entries; e += kThreads)
      if (idx[e] >= Dims<kD>::kH) pair.put(&s.ent[e], s.ent[e], kEnt);
  }
}

// Rank 0: the first half of the first layer's sums of every row, from the
// biases, into rank 1's activations; a thread per (tile of kTile rows, unit)
template <int kD>
__device__ __forceinline__ void first_half_to_peer(const float* wf, const float* ws, float* rows, const Pair& pair,
                                                   const Layout& lay, int nr, int w1) {
  const int tid = threadIdx.x;
  if (tid < w1 * ((nr + kTile - 1) / kTile)) {
    const int t = tid / w1;
    const int o = tid - t * w1;
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = ws[o];
    first_half<kD>(wf, rows, lay, nr, t, o, acc);
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      if (t * kTile + j < nr) pair.put(&row_at<kD>(rows, lay, t * kTile + j).act[o], acc[j], kPartials);
  }
}

// Rank 1: the first layer's second half from rank 0's partial sums and its
// relu, then layers 1..L-1 of every row, a thread per (row, unit), a block
// barrier after each layer
template <int kD>
__device__ __forceinline__ void forward_rest(const PgdBotnetArgs& a, const Layout& lay, const float* wf,
                                             const float* ws, float* rows, int nr, long long& last) {
  constexpr int kThreads = Dims<kD>::kThreads;
  const int tid = threadIdx.x;
  const int w1 = a.widths[1];
  if (tid < w1 * ((nr + kTile - 1) / kTile)) {
    const int t = tid / w1;
    const int o = tid - t * w1;
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = row_at<kD>(rows, lay, min(t * kTile + j, nr - 1)).act[o];
    first_half<kD>(wf, rows, lay, nr, t, o, acc);
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      if (t * kTile + j < nr) row_at<kD>(rows, lay, t * kTile + j).act[o] = relu_keep_nan(acc[j]);
  }
  block_end(2, last);
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
      const Row s = row_at<kD>(rows, lay, r);
      const float acc = dot_chain(bias[o], s.act + lay.act_off[l - 1], 1, w + o * st, 1, in_w);
      s.act[lay.act_off[l] + o] = hidden ? relu_keep_nan(acc) : acc;
    }
    block_end(3, last);
  }
}

// Rank 1: the cotangent of the first layer's output of every row, from that
// of the logits in cta, through layers L-1..1 (a thread per (row, unit), a
// block barrier after each layer); the last layer's is handed to the peer
// too
template <int kD>
__device__ __forceinline__ void hidden_backward(const PgdBotnetArgs& a, const Layout& lay, const float* ws,
                                                float* rows, const Pair& pair, int nr, long long& last) {
  constexpr int kThreads = Dims<kD>::kThreads;
  bool in_b = false;
  for (int l = a.n_layers - 1; l >= 1; --l) {
    const int in_w = a.widths[l];
    const int out_w = a.widths[l + 1];
    const int st = padded_stride(in_w);
    const float* w = ws + lay.w_off[l];
    for (int task = threadIdx.x; task < nr * in_w; task += kThreads) {
      const int r = task / in_w;
      const int k = task - r * in_w;
      const Row s = row_at<kD>(rows, lay, r);
      const float* cur = in_b ? s.ctb : s.cta;
      // the input of layer l is the output of layer l - 1 (hidden): its
      // cotangent passes where that output is > 0
      const float* h = s.act + lay.act_off[l - 1];
      // from -0, which adds the first product exactly
      const float acc = dot_chain(-0.0f, cur, 1, w + k, st, out_w);
      const float v = h[k] > 0.0f ? acc : 0.0f;
      float* dst = (in_b ? s.cta : s.ctb) + k;
      *dst = v;
      if (l == 1) pair.put(dst, v, kCotangent);
    }
    block_end(5, last);
    in_b = !in_b;
  }
}

// The L2 projection factor min(1, eps / (||p|| + 1e-12)) of every row from
// the squares of its perturbation in sq, into aux[1] on both CTAs, lane r of
// warp 0: rank 0's half (phase `ph_half` of rank 1's barrier), then rank 1's,
// which hands the factor back (phase `ph_factor` of rank 0's)
template <int kD>
__device__ __forceinline__ void projection_factor(const PgdBotnetArgs& a, const Layout& lay, float* rows,
                                                  const Pair& pair, int rank, int nr, int ph_half, int ph_factor,
                                                  long long& last) {
  const int tid = threadIdx.x;
  const bool run = tid < nr;
  if (rank == 0) {
    if (run) {
      const Row s = row_at<kD>(rows, lay, tid);
      pair.put(&s.aux[5], half_sum<kD>(s.sq, -0.0f), kFactorHalf);
    }
    stamp(13, last);
    pair.take(kFactor, 4u * nr, ph_factor);
    stamp(16, last);
  } else {
    pair.take(kFactorHalf, 4u * nr, ph_half);
    stamp(14, last);
    if (run) {
      const Row s = row_at<kD>(rows, lay, tid);
      const float f = nan_min(1.0f, __fdiv_rn(a.eps, __fadd_rn(__fsqrt_rn(half_sum<kD>(s.sq, s.aux[5])), 1e-12f)));
      s.aux[1] = f;
      pair.put(&s.aux[1], f, kFactor);
    }
    block_end(15, last);
  }
}

// AutoPGD's decisions for row r after the tracking loss f of pass `it`
// (attacks/pgd/autopgd.py::autopgd_run_plain's, K7's order): at pass 0 the
// state; else the rises, the best point and, at a checkpoint, the halving;
// s.au[kMove] what the copies do
__device__ __forceinline__ void track_row(const PgdBotnetArgs& a, const Row& s, float f, int it) {
  int move = it == 2 * a.t ? 2 : 0;  // after the last iteration x takes x_best for the class
  if (it == 0) {
    s.au[kFBest] = f;
    s.au[kFPrev] = f;
    s.au[kFBck] = f;
    s.au[kEta] = a.eta0;
    s.au[kEtaCk] = a.eta0;
    s.au[kImpr] = 0.0f;
  } else {
    const int c = it >> 1;  // i + 1 of the iteration just run
    const float impr = __fadd_rn(s.au[kImpr], f > s.au[kFPrev] ? 1.0f : 0.0f);
    const bool better = f > s.au[kFBest];
    const float fb = better ? f : s.au[kFBest];
    const float eta = s.au[kEta];
    const bool ck = a.is_ckpt[c];
    const bool halve = ck && (impr < a.ckpt_thr[c] || (s.au[kEtaCk] == eta && s.au[kFBck] == fb));
    const float eta_next = halve ? __fmul_rn(eta, 0.5f) : eta;
    s.au[kFBest] = fb;
    s.au[kFPrev] = f;
    s.au[kEta] = eta_next;
    s.au[kImpr] = ck ? 0.0f : impr;
    if (ck) {
      s.au[kEtaCk] = eta_next;
      s.au[kFBck] = fb;
    }
    move |= (better ? 1 : 0) | (halve ? 2 : 0);
  }
  s.au[kMove] = __int_as_float(move);
}

// kAuto: AutoPGD, whose launch runs 2T + 2 passes (see the design note);
// else PGD; rows of kD features
template <bool kAuto, int kD>
__device__ __forceinline__ void pgd_botnet_run(const PgdBotnetArgs& a, const Layout& lay) {
  using G = Dims<kD>;
  constexpr int kH = G::kH;
  constexpr int kHP = G::kHP;
  constexpr int kThreads = G::kThreads;
  extern __shared__ __align__(16) float smem[];
  constexpr int kBars = kAuto ? kAutoBarFloats : kBarFloats;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int w1 = a.widths[1];
  float* wf = smem + kBars;                                     // after the barriers: (w1, kHP) the first layer at
                                                                // the CTA's features
  float* ws = wf + w1 * kHP;                                    // its bias, then layers 1..L-1
  int* idx = reinterpret_cast<int*>(ws + lay.ws_floats);        // the gather lists
  float* rows = reinterpret_cast<float*>(idx + pad4(lay.n_entries));
  const int tid = threadIdx.x;
  const int k0 = rank * kH;                    // the CTA's first feature
  const int n_own = rank == 0 ? kH : G::kH1;   // and its features
  const int classes = a.widths[a.n_layers];
  const int row0 = (blockIdx.x >> 1) * a.rows;
  const int nr = min(a.rows, a.n - row0);

  // the first layer at the CTA's features; a slot past them (rank 1 where
  // kD is odd) holds +0
  for (int e = tid; e < w1 * kH; e += kThreads) {
    const int k = e / w1;
    const int o = e - k * w1;
    wf[o * kHP + k] = k < n_own ? a.first_t[(k0 + k) * w1 + o] : 0.0f;
  }
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
  for (int e = tid; e < nr * kD; e += kThreads) {
    const int r = e / kD;
    const int k = e - r * kD;
    const Row s = row_at<kD>(rows, lay, r);
    const float x = a.x_start[static_cast<size_t>(row0 + r) * kD + k];
    s.u[k] = unscale(x, a.min_[k], a.scale[k]);
    if (k >= k0 && k < k0 + kH) {
      s.x[k - k0] = x;
      if constexpr (kAuto) {
        s.xp[k - k0] = x;
        s.xb[k - k0] = x;
      }
    }
  }
  // the slot past rank 1's features: x = -0 (its product with the +0
  // weight is -0) and squares of -0, which no thread writes again
  if (n_own < kH && tid < nr) {
    const Row s = row_at<kD>(rows, lay, tid);
    s.x[kH - 1] = -0.0f;
    s.sq[kH - 1] = -0.0f;
    s.sqh[kH - 1] = -0.0f;
  }
  // the feature a thread owns in the per-feature phases, its constants in
  // registers
  const bool owner = tid < n_own;
  const int gk = k0 + (owner ? tid : 0);
  const float sc = a.scale[gk];
  const float mn = a.min_[gk];
  const bool mut = a.mutable_[gk];
  // a pair's column (the augmented domain): its cotangent comes from rank
  // 0's pair term, into u at the column
  const bool pair_col = G::kP > 0 && owner && gk >= kBotnetFeatures;
  int inv[kMaxDegree];
#pragma unroll
  for (int j = 0; j < kMaxDegree; ++j) inv[j] = j < a.degree ? a.inverse[gk * a.degree + j] : -1;
  float xi[kMaxRows], gr[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) xi[r] = a.x_init[static_cast<size_t>(row0 + min(r, nr - 1)) * kD + gk];

  const bool linf = a.flags & 1;
  const bool repair = a.flags & 2;
  const bool targeted = a.flags & 4;
  const bool hist_norm = a.hist != nullptr && (a.flags & 8);
  const bool hist_full = a.hist != nullptr && (a.flags & 16);
  const int g_col = (a.flags & 8) ? 4 : 3;
  const bool ct1_in_b = (a.n_layers - 1) & 1;  // where hidden_backward leaves the first layer's cotangent
  const Pair pair{shared_addr(smem), peer_addr(shared_addr(smem), rank ^ 1)};
  if (tid == 0) {
    for (int k = 0; k < (kAuto ? kKinds : kTrack); ++k) bar_init(pair.base + 8 * k);
    bar_init_fence();
  }
  long long last = 0;
#ifdef K7B_STAMPS
  if (tid < kPhases) k7b_block_cycles[tid] = 0;
#endif
  cl.sync();  // staged, the barriers set, and the peer is running
  // what each hand-off brings: the first layer's partial sums; its
  // cotangent (with the class losses for the history); rank 1's entries of
  // the gather lists and the pairs' cotangents; the halves of the L2 sums
  // (and a word, under L-inf too); rank 1's share of u
  int peer_entries = 0;
  for (int e = 0; e < lay.n_entries; ++e) peer_entries += idx[e] >= kH;
  const unsigned partial_bytes = 4u * nr * w1;
  const unsigned cotangent_bytes = 4u * nr * (w1 + (a.hist != nullptr ? 1 : 0));
  const unsigned ent_bytes = 4u * nr * (peer_entries + G::kP);
  const unsigned halves_bytes = 4u * (1 + (linf ? 0 : nr) + (hist_norm ? nr : 0));
  const unsigned u_bytes = 4u * nr * G::kH1;
  // kAuto: each kind's phase, and the bytes of rank 1's u that rank 0 takes
  // before its next terms (of x_new, or of the rows restarted from x_best)
  Phases ph;
  unsigned u_due = 0;
#ifdef K7B_STAMPS
  last = clock64();
#endif
  // kAuto: pass it = 0 is the tracking loss at x_start, 2i + 1 iteration i's
  // gradient and step, 2i + 2 (track) its tracking loss at x_new, the best
  // point and the checkpoint; the class at x_best follows
  const int passes = kAuto ? 2 * a.t + 1 : a.t;
  for (int it = 0; it < passes; ++it) {
    const int i = kAuto ? (it - 1) >> 1 : it;  // the iteration
    const bool track = kAuto && !(it & 1);
    const float wc = track ? 0.0f : a.w_class[i];
    const float wk = track ? 0.0f : a.w_cons[i];
    const float stp = kAuto ? 0.0f : a.step[i];
    const int ctr = track ? a.tctr : a.ctr[i];
    float own = 0.0f;  // track: row tid's cons on rank 0, its class loss on rank 1
    if (rank == 0) {
      first_half_to_peer<kD>(wf, ws, rows, pair, lay, nr, w1);
      stamp(0, last);
      if constexpr (kAuto) {
        if (u_due > 0) pair.take(kU, u_due, ph.next(kU));  // rank 1's u
      } else {
        if (it > 0) pair.take(kU, u_bytes, it - 1);  // rank 1's u
      }
      stamp(1, last);
      all_terms<kD>(a, lay, idx, rows, pair, nr, row0, i, -wk, ctr, hist_full && !track ? a.hist : nullptr, g_col,
                !track);
      block_end(2, last);
      if (track) {
        // the tracking loss's constraint: the term tctr, or the sum from the first
        if (tid < nr) {
          const Row s = row_at<kD>(rows, lay, tid);
          own = s.g[ctr < 0 ? 0 : ctr];
          if (ctr < 0)
            for (int t = 1; t < lay.n_terms; ++t) own = __fadd_rn(own, s.g[t]);
          pair.put(&s.au[kPeer], own, kTrack);
        }
      } else {
        pair.take(kCotangent, cotangent_bytes, kAuto ? ph.next(kCotangent) : it);
      }
      stamp(6, last);
    } else {
      pair.take(kPartials, partial_bytes, kAuto ? ph.next(kPartials) : it);
      stamp(1, last);
      forward_rest<kD>(a, lay, wf, ws, rows, nr, last);
      // a thread per row: the cross-entropy and the cotangent of the logits
      if (tid < nr) {
        const Row s = row_at<kD>(rows, lay, tid);
        const float lc = cross_entropy(classes, targeted, s.act + lay.act_off[a.n_layers - 1],
                                       static_cast<int>(a.y[row0 + tid]), wc, s.cta);
        if (track) {
          own = lc;
          pair.put(&s.au[kPeer], lc, kTrack);
        } else if (a.hist != nullptr) {
          a.hist[(static_cast<size_t>(i) * a.n + row0 + tid) * a.hist_cols + 1] = lc;
          pair.put(&s.aux[4], lc, kCotangent);
        }
      }
      block_end(4, last);
      if (!track) {
        hidden_backward<kD>(a, lay, ws, rows, pair, nr, last);
        pair.take(kEnt, ent_bytes, kAuto ? ph.next(kEnt) : it);  // its features' entries, from rank 0's terms
      }
      stamp(18, last);
    }
    if constexpr (kAuto) {
      if (track) {
        // the tracking loss, the decisions alike on both CTAs, then the
        // copies on the CTA's features; a restarted row's u from its x again
        // (not after the last iteration: nothing reads it)
        pair.take(kTrack, 4u * nr, ph.next(kTrack));
        if (tid < nr) {
          const Row s = row_at<kD>(rows, lay, tid);
          const float lc = rank == 0 ? s.au[kPeer] : own;
          const float cons = rank == 0 ? own : s.au[kPeer];
          track_row(a, s, __fadd_rn(__fmul_rn(a.tw_class, lc), __fmul_rn(a.tw_cons, -cons)), it);
        }
        __syncthreads();
        const bool send_u = it < 2 * a.t;
        unsigned restarted = 0;
        for (int r = 0; r < nr; ++r) restarted += (__float_as_int(row_at<kD>(rows, lay, r).au[kMove]) >> 1) & 1;
        if (owner) {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < nr) {
              const Row s = row_at<kD>(rows, lay, r);
              const int move = __float_as_int(s.au[kMove]);
              if (move & 1) s.xb[tid] = s.x[tid];
              if (move & 2) {
                const float x = s.xb[tid];
                s.x[tid] = x;
                if (send_u) {
                  const float u = unscale(x, mn, sc);
                  if (rank == 0) {
                    s.u[gk] = u;
                  } else {
                    pair.put(&s.u[gk], u, kU);
                  }
                }
              }
            }
          }
        }
        u_due = send_u ? 4u * G::kH1 * restarted : 0u;
        block_end(17, last);
        continue;
      }
    }
    // a thread per feature: the input backward of every row (each weight
    // read once for all of them), its sum of the constraints' cotangents,
    // the gradient and the squares its L2 sums add
    if (owner) {
      const float* ct[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const Row s = row_at<kD>(rows, lay, min(r, nr - 1));
        ct[r] = ct1_in_b ? s.ctb : s.cta;
      }
      const float* w = wf + tid;  // w[o * kHP] = the weight of unit o at this feature
      float acc[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] = -0.0f;  // adds the first product exactly
      // units 4 at a time, each group's loads issued before the previous
      // group's adds (the last loads, past w1, are unused)
      const int n4 = w1 >> 2;
      if (n4 > 0) {
        float wv[4];
        float4 c[kMaxRows];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = w[i * kHP];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) c[r] = *reinterpret_cast<const float4*>(ct[r]);
        for (int g = 1; g <= n4; ++g) {
          float wn[4];
          float4 cn[kMaxRows];
#pragma unroll
          for (int i = 0; i < 4; ++i) wn[i] = w[(4 * g + i) * kHP];
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) cn[r] = *reinterpret_cast<const float4*>(ct[r] + 4 * g);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r)
            acc[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc[r], __fmul_rn(c[r].x, wv[0])), __fmul_rn(c[r].y, wv[1])),
                                         __fmul_rn(c[r].z, wv[2])),
                               __fmul_rn(c[r].w, wv[3]));
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = wn[i];
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) c[r] = cn[r];
        }
      }
      for (int o = 4 * n4; o < w1; ++o) {
        const float wv = w[o * kHP];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(ct[r][o], wv));
      }
      float cu[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) cu[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxDegree; ++j) {
        if (inv[j] < 0) break;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) cu[r] = __fadd_rn(cu[r], row_at<kD>(rows, lay, min(r, nr - 1)).ent[inv[j]]);
      }
      if (pair_col) {  // the pair's cotangent, added to the +0 of no entries
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) cu[r] = __fadd_rn(cu[r], row_at<kD>(rows, lay, min(r, nr - 1)).u[gk]);
      }
#pragma unroll
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const Row s = row_at<kD>(rows, lay, r);
          const float gv = __fadd_rn(acc[r], div_rn(cu[r], sc));
          const float gm = isnan(gv) || !mut ? 0.0f : gv;
          const float f = isfinite(gv) ? gv : 0.0f;
          gr[r] = gv;
          s.sq[tid] = __fmul_rn(gm, gm);
          s.sqh[tid] = __fmul_rn(f, f);
        }
      }
    } else if (rank == 0 && a.hist != nullptr) {
      // the spare threads: the history's loss columns, whose sum of the
      // terms is a chain of its own
      for (int r = tid - kH; r < nr; r += kThreads - kH) {
        const Row s = row_at<kD>(rows, lay, r);
        float cons = s.g[0];
        if (ctr < 0) {
          for (int t = 1; t < lay.n_terms; ++t) cons = __fadd_rn(cons, s.g[t]);
        } else {
          cons = s.g[ctr];
        }
        float* h = a.hist + (static_cast<size_t>(i) * a.n + row0 + r) * a.hist_cols;
        h[0] = __fadd_rn(__fmul_rn(wc, s.aux[4]), __fmul_rn(wk, -cons));
        h[2] = cons;
      }
    }
    block_end(7, last);
    // the L2 norm of the masked gradient (lane r of warp 0) and the
    // history's of the raw gradient's finite entries (lane 8 + r): rank 0's
    // half, then rank 1's, which hands the norm back. The hand-off is made
    // under L-inf too, with one word more: rank 1 writes rank 0's u only
    // once rank 0's terms are done.
    {
      const int r = tid & 7;
      const bool h = tid >= 8;
      const bool run = tid < 16 && r < nr && (h ? hist_norm : !linf);
      if (rank == 0) {
        if (run) {
          const Row s = row_at<kD>(rows, lay, r);
          pair.put(&s.aux[h ? 3 : 2], half_sum<kD>(h ? s.sqh : s.sq, -0.0f), kHalves);
        }
        if (tid == 0) pair.put(&row_at<kD>(rows, lay, 0).aux[7], 0.0f, kHalves);
        stamp(8, last);
        if (!linf) pair.take(kNorm, 4u * nr, kAuto ? ph.next(kNorm) : it);
        stamp(11, last);
      } else {
        pair.take(kHalves, halves_bytes, kAuto ? ph.next(kHalves) : it);
        stamp(9, last);
        if (run) {
          const Row s = row_at<kD>(rows, lay, r);
          const float sum = half_sum<kD>(h ? s.sqh : s.sq, s.aux[h ? 3 : 2]);
          if (h) {
            a.hist[(static_cast<size_t>(i) * a.n + row0 + r) * a.hist_cols + 3] = __fsqrt_rn(sum);
          } else {
            const float nrm = __fadd_rn(__fsqrt_rn(sum), 1e-7f);
            s.aux[0] = nrm;
            pair.put(&s.aux[0], nrm, kNorm);
          }
        }
        block_end(10, last);
      }
    }
    // the masked, conditioned step (kAuto: by the row's eta) and the clip;
    // the perturbation into gr
    if (owner) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const Row s = row_at<kD>(rows, lay, r);
          const float gv = gr[r];
          const float gm = isnan(gv) || !mut ? 0.0f : gv;
          const float d = linf ? (gm > 0.0f ? 1.0f : (gm < 0.0f ? -1.0f : 0.0f)) : div_rn(gm, s.aux[0]);
          const float x = clamp_nan(__fadd_rn(s.x[tid], __fmul_rn(kAuto ? s.au[kEta] : stp, d)), a.lo, a.hi);
          const float p = __fsub_rn(x, xi[r]);
          gr[r] = p;
          if (!linf) s.sq[tid] = __fmul_rn(p, p);
        }
      }
    }
    block_end(12, last);
    const float alpha = i > 0 ? a.alpha : 1.0f;  // kAuto: the momentum
    if (!linf) {
      projection_factor<kD>(a, lay, rows, pair, rank, nr, kAuto ? ph.next(kFactorHalf) : it,
                        kAuto ? ph.next(kFactor) : it, last);
      if constexpr (kAuto) {
        // z projected and clipped, then the momentum clipped: its
        // perturbation into gr, its squares into sq, and its factor; x_prev
        // takes x
        if (owner) {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < nr) {
              const Row s = row_at<kD>(rows, lay, r);
              const float x = s.x[tid];
              const float z = clamp_nan(__fadd_rn(xi[r], __fmul_rn(gr[r], s.aux[1])), a.lo, a.hi);
              const float p = __fsub_rn(clamp_nan(momentum(x, z, s.xp[tid], alpha), a.lo, a.hi), xi[r]);
              s.xp[tid] = x;
              gr[r] = p;
              s.sq[tid] = __fmul_rn(p, p);
            }
          }
        }
        block_end(12, last);
        projection_factor<kD>(a, lay, rows, pair, rank, nr, ph.next(kFactorHalf), ph.next(kFactor), last);
      }
    }
    // the projection, the clip, repair's round trip through the scaler; the
    // next unscaled row, on both CTAs
    if (owner) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const Row s = row_at<kD>(rows, lay, r);
          const float d = linf ? clamp_nan(gr[r], -a.eps, a.eps) : __fmul_rn(gr[r], s.aux[1]);
          float x = clamp_nan(__fadd_rn(xi[r], d), a.lo, a.hi);
          if constexpr (kAuto) {
            if (linf) {
              // x is z: the momentum, clipped, projected and clipped; x_prev takes x
              const float xo = s.x[tid];
              const float xn = clamp_nan(momentum(xo, x, s.xp[tid], alpha), a.lo, a.hi);
              x = clamp_nan(__fadd_rn(xi[r], clamp_nan(__fsub_rn(xn, xi[r]), -a.eps, a.eps)), a.lo, a.hi);
              s.xp[tid] = xo;
            }
          }
          // botnet's repair is the identity: it rewrites no immutable
          // feature, only the mutable ones take the round trip, and u is
          // unscaled from x on every feature, so x and u cannot part
          if (repair && mut) x = __fadd_rn(__fmul_rn(unscale(x, mn, sc), sc), mn);
          s.x[tid] = x;
          const float u = unscale(x, mn, sc);
          if (rank == 0) {
            s.u[gk] = u;
          } else {
            pair.put(&s.u[gk], u, kU);
          }
        }
      }
    }
    block_end(17, last);
    if constexpr (kAuto) u_due = u_bytes;  // the tracking pass's terms read x_new's u
  }

  // the class at x_adv (kAuto: at x_best, which x took after the last
  // tracking loss)
  if (rank == 0) {
    first_half_to_peer<kD>(wf, ws, rows, pair, lay, nr, w1);
  } else {
    pair.take(kPartials, partial_bytes, kAuto ? ph.next(kPartials) : a.t);
    forward_rest<kD>(a, lay, wf, ws, rows, nr, last);
    if (tid < nr)
      a.pred[row0 + tid] = predicted_class(classes, row_at<kD>(rows, lay, tid).act + lay.act_off[a.n_layers - 1]);
  }
  if (owner)
    for (int r = 0; r < nr; ++r) a.x_adv[static_cast<size_t>(row0 + r) * kD + gk] = row_at<kD>(rows, lay, r).x[tid];
  if constexpr (kAuto) {
    // every hand-off has been taken: no write to the peer is in flight
    if (rank == 0 && tid < nr) a.eta[row0 + tid] = row_at<kD>(rows, lay, tid).au[kEta];
  } else {
    if (rank == 0 && a.t > 0) pair.take(kU, u_bytes, a.t - 1);  // rank 1's last writes have landed
  }
  cl.sync();  // and neither CTA exits while the other may still write its shared memory
#ifdef K7B_STAMPS
  if (blockIdx.x < 2 && tid < kPhases) k7b_cycles[blockIdx.x * kPhases + tid] += k7b_block_cycles[tid];
#endif
}

// K7b on botnet's 756 features; kAuto: AutoPGD
template <bool kAuto>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(Dims<kBotnetFeatures>::kThreads, 1)
    pgd_botnet_kernel(const PgdBotnetArgs a, const Layout lay) {
  pgd_botnet_run<kAuto, kBotnetFeatures>(a, lay);
}

// K7b on the augmented domain's 756 + kPgdBotnetAugPairs features
template <bool kAuto>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(Dims<kBotnetFeatures + kPgdBotnetAugPairs>::kThreads, 1)
    pgd_botnet_aug_kernel(const PgdBotnetArgs a, const Layout lay) {
  pgd_botnet_run<kAuto, kBotnetFeatures + kPgdBotnetAugPairs>(a, lay);
}

// the instantiation for rows of kD features
template <bool kAuto, int kD>
const void* kernel_of() {
  if constexpr (kD == kBotnetFeatures) {
    return reinterpret_cast<const void*>(pgd_botnet_kernel<kAuto>);
  } else {
    static_assert(kD == kBotnetFeatures + kPgdBotnetAugPairs, "K7b's two widths");
    return reinterpret_cast<const void*>(pgd_botnet_aug_kernel<kAuto>);
  }
}

// The clusters of an instantiation resident at once on the current device
// with one CTA per SM (more than half an SM's shared memory), asked once per
// device
template <bool kAuto, int kD>
cudaError_t resident_clusters(LaunchCache& cache, int* clusters) {
  constexpr size_t kOnePerSm = kMaxSharedBytes / 2 + 16;
  static std::mutex mu;
  static int known[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (known[device] == 0) {
    err = cache.prepare(kernel_of<kAuto, kD>(), Dims<kD>::kThreads, kOnePerSm, nullptr);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(Dims<kD>::kThreads);
    cfg.dynamicSmemBytes = kOnePerSm;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel_of<kAuto, kD>(), &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    known[device] = n;
  }
  *clusters = known[device];
  return cudaSuccess;
}

// A launch of K7b: its layout, dynamic shared memory per CTA, grid (CTAs)
// and the clusters resident at once
struct Plan {
  Layout lay;
  size_t smem;
  int grid, clusters;
};

// Checks `args` (n > 0), sets its rows per cluster and plans the launch of
// the instantiation kAuto for rows of kD features
template <bool kAuto, int kD>
cudaError_t plan_launch(PgdBotnetArgs& args, Plan& p) {
  static LaunchCache cache;
  constexpr int kP = Dims<kD>::kP;
  const int n_layers = args.n_layers;
  if (args.n < 0 || args.t < 0 || n_layers < 2 || n_layers > kObjectiveMaxLayers || args.widths[0] != kD ||
      args.widths[n_layers] < 1 || args.widths[n_layers] > 2 || args.degree < 1 ||
      args.degree > kPgdBotnetMaxDegree || args.n_pairs != kP)
    return cudaErrorInvalidValue;
  // the augmented domain: its pairs' tables, and no repair (undefined there)
  if (kP > 0 && (args.pair_idx == nullptr || args.pair_thr == nullptr || (args.flags & 2)))
    return cudaErrorInvalidValue;
  const int* c = args.counts;
  for (int s = 0; s < kBotnetSegments; ++s)
    if (c[s] < 0 || (s < 4 && c[s] < 1) || (s >= 4 && s % 2 == 0 && c[s] != c[s + 1])) return cudaErrorInvalidValue;
  Layout& lay = p.lay;
  lay = Layout{};
  for (int s = 0; s < kBotnetSegments; ++s) lay.seg[s + 1] = lay.seg[s] + c[s];
  lay.n_entries = lay.seg[kBotnetSegments];
  lay.ord_start[0] = 2 + c[4];
  lay.ord_start[1] = lay.ord_start[0] + c[6];
  lay.ord_start[2] = lay.ord_start[1] + c[8];
  lay.n_base = lay.ord_start[2] + c[10];
  lay.n_terms = lay.n_base + kP;
  const int cols = 3 + ((args.flags & 8) ? 1 : 0) + ((args.flags & 16) ? lay.n_terms : 0);
  if (args.hist != nullptr && args.hist_cols != cols) return cudaErrorInvalidValue;
  const int w1 = args.widths[1];
  // layers 1..L-1 staged at odd strides after the first layer's bias
  int ws_floats = pad4(w1);
  for (int l = 0; l < n_layers; ++l) {
    const int in_w = args.widths[l];
    const int out_w = args.widths[l + 1];
    if (out_w < 1 || (l + 1 < n_layers && out_w > kBotnetMaxWidth)) return cudaErrorInvalidValue;
    lay.act_off[l] = lay.act_floats;
    lay.act_floats += out_w;
    if (l == 0) continue;
    lay.w_off[l] = ws_floats;
    ws_floats += out_w * ((in_w | 1) + 1);
  }
  lay.ws_floats = pad4(ws_floats);
  lay.row_floats = row_tail<kD>() + pad4(lay.n_entries) + pad4(lay.n_terms) + pad4(lay.act_floats) +
                   (kAuto ? auto_row_floats<kD>() : 0);
  int clusters = 0;
  cudaError_t err = resident_clusters<kAuto, kD>(cache, &clusters);
  if (err != cudaSuccess) return err;
  // rows per cluster: as few as spread N over the resident clusters, at
  // most kMaxRows and as many as fit (at least one for every stack K7b
  // takes beside botnet's gather lists)
  constexpr int kBars = kAuto ? kAutoBarFloats : kBarFloats;
  constexpr int kHP = Dims<kD>::kHP;
  const long fixed = kBars + static_cast<long>(w1) * kHP + lay.ws_floats + pad4(lay.n_entries);
  const long fit = (static_cast<long>(kMaxSharedBytes / sizeof(float)) - fixed) / lay.row_floats;
  args.rows = static_cast<int>(std::min<long>(std::min(kMaxRows, (args.n + clusters - 1) / clusters), fit));
  if (args.rows < 1) return cudaErrorInvalidValue;
  p.smem = sizeof(float) * (kBars + static_cast<size_t>(w1) * kHP + lay.ws_floats + pad4(lay.n_entries) +
                            static_cast<size_t>(args.rows) * lay.row_floats);
  p.clusters = clusters;
  p.grid = 2 * ((args.n + args.rows - 1) / args.rows);
  return cache.prepare(kernel_of<kAuto, kD>(), Dims<kD>::kThreads, p.smem, nullptr);
}

template <bool kAuto, int kD>
cudaError_t launch(PgdBotnetArgs args, cudaStream_t stream) {
  Plan p;
  const cudaError_t err = plan_launch<kAuto, kD>(args, p);
  if (err != cudaSuccess) return err;
  if (kAuto && (args.tctr < -1 || args.tctr >= p.lay.n_terms)) return cudaErrorInvalidValue;
  if constexpr (kD == kBotnetFeatures) {
    pgd_botnet_kernel<kAuto><<<p.grid, Dims<kD>::kThreads, p.smem, stream>>>(args, p.lay);
  } else {
    pgd_botnet_aug_kernel<kAuto><<<p.grid, Dims<kD>::kThreads, p.smem, stream>>>(args, p.lay);
  }
  return cudaGetLastError();
}

// the plan of the instantiation that takes `args` (PGD or AutoPGD, 756 or
// 756 + kPgdBotnetAugPairs features), and its threads per CTA
cudaError_t plan_any(PgdBotnetArgs& args, bool autopgd, Plan& p, int* threads) {
  constexpr int kAug = kBotnetFeatures + kPgdBotnetAugPairs;
  const bool aug = args.n_pairs > 0;
  *threads = aug ? Dims<kAug>::kThreads : Dims<kBotnetFeatures>::kThreads;
  if (aug) return autopgd ? plan_launch<true, kAug>(args, p) : plan_launch<false, kAug>(args, p);
  return autopgd ? plan_launch<true, kBotnetFeatures>(args, p) : plan_launch<false, kBotnetFeatures>(args, p);
}

}  // namespace

cudaError_t launch_pgd_botnet(PgdBotnetArgs args, cudaStream_t stream) {
  if (args.n == 0) return cudaSuccess;
  constexpr int kAug = kBotnetFeatures + kPgdBotnetAugPairs;
  const bool aug = args.n_pairs > 0;
  if (args.flags & 32) {
    if (args.is_ckpt == nullptr || args.ckpt_thr == nullptr || args.eta == nullptr) return cudaErrorInvalidValue;
    return aug ? launch<true, kAug>(args, stream) : launch<true, kBotnetFeatures>(args, stream);
  }
  return aug ? launch<false, kAug>(args, stream) : launch<false, kBotnetFeatures>(args, stream);
}

// K7b's launch at n rows of the stack `widths` (n_layers + 1 widths), the
// gather lists `counts` and n_pairs XOR pairs (0 on the base domain), as the
// launcher plans it on the current device for PGD, or AutoPGD where
// `autopgd`: out = [rows per cluster, CTAs per cluster, CTAs, threads per
// CTA, dynamic shared memory bytes per CTA, clusters resident at once]
extern "C" int moeva_pgd_botnet_shape(const int* widths, int n_layers, const int* counts, int n_pairs, int n,
                                      int autopgd, int* out) {
  PgdBotnetArgs args{};
  args.n = n;
  args.degree = 1;
  args.n_layers = n_layers;
  args.n_pairs = n_pairs;
  // the plan checks that the tables are given, not what they hold
  static const int32_t kNoPairIdx[2] = {0, 0};
  static const float kNoPairThr[2] = {0.0f, 0.0f};
  args.pair_idx = kNoPairIdx;
  args.pair_thr = kNoPairThr;
  for (int l = 0; l <= n_layers && l <= kObjectiveMaxLayers; ++l) args.widths[l] = widths[l];
  for (int s = 0; s < kBotnetSegments; ++s) args.counts[s] = counts[s];
  Plan p;
  int threads = 0;
  const cudaError_t err = n <= 0 ? cudaErrorInvalidValue : plan_any(args, autopgd != 0, p, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shape[6] = {args.rows, 2, p.grid, threads, static_cast<int>(p.smem), p.clusters};
  for (int i = 0; i < 6; ++i) out[i] = shape[i];
  return 0;
}

#ifdef K7B_STAMPS
extern "C" const char* k7b_phase_names() {
  return "first-layer half (rank 0);wait: u (rank 0) | partial sums (rank 1);"
         "terms (rank 0) | first-layer half (rank 1);hidden forward (rank 1);cross-entropy (rank 1);"
         "hidden backward (rank 1);wait: first layer's cotangent (rank 0);input backward and gradient;"
         "L2 sums' first half (rank 0);wait: partials (rank 1);L2 sums' second half (rank 1);"
         "wait: norm (rank 0);step;projection factor's first half (rank 0);wait: partial (rank 1);"
         "projection factor's second half (rank 1);wait: factor (rank 0);projection and repair;"
         "wait: the entries' cotangents (rank 1)";
}

// the threads whose stamps k7b_take_cycles returns: thread 0 of rank 0 and
// of rank 1 of cluster 0, in that order
extern "C" int k7b_stamped_warps() { return 2; }

// copies K7b's per-phase cycles to `out` (2 x kPhases values) and zeroes them
extern "C" int k7b_take_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k7b_cycles, sizeof(k7b_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[2 * kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k7b_cycles, zero, sizeof(zero)));
}
#endif
