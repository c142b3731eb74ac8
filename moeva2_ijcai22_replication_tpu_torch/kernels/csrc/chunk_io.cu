// K13: a MoEvA chunk's prepare and initial population (K13a, prepare_kernel)
// and its final decode (K13b, decode_kernel).
//
// Replaces jnp device stages of moeva2_ijcai22_replication_tpu (the repo
// has no Pallas kernel for them):
// - K13a: the head of the `init` program, attacks/moeva/engine.py:503-521:
//   core/codec.py:215 genetic_bounds, :237 minmax_normalize, then
//   attacks/moeva/initialisation.py tile_init or :54 lp_ratio_init (its
//   ball from K0's draws), and the normalisation memory's start
//   (survival.NormState.init);
// - K13b: the concatenation of population and archive and core/codec.py:160
//   genetic_to_ml of the chunk's result (engine.py:1508; JAX decodes there
//   on its host's CPU device, engine.py:1500-1512, after fetching the
//   genetic populations; the port decodes on the card and fetches the
//   decoded rows with them).
//
// Semantics (must equal attacks/moeva/chunk_io.py's chunk_prepare_plain and
// chunk_decode_plain bit for bit): every value is one rounded float32
// operation of the plain version's, in its order. x_mm = (x - xl) /
// (xu - xl, 1 where that is 0). Gene j < n1 takes feature gene_feat[j]'s
// bounds and value (rounded half to even where int_gene[j]); a categorical
// gene has bounds [0, group size - 1] and the first largest member of its
// group (a NaN counts as largest, as torch.argmax). The last n_pert rows of
// the population are moved: base = (x0 - xl_gen) / (range > 0 ? range : 1),
// delta = ball * eps under L-inf, (ball / sqrt_rn(left-to-right sum of the
// row's ball_cols squares)) * eps under L2, clamp(base + delta, 0, 1) *
// range + xl_gen, integer genes rounded; the others are x0.
//
// Bound: bytes. K13a reads 3 (S, D) arrays and writes the bounds, x_mm and
// the (S, P, L) population; K13b copies the columns and writes (S, P + A,
// D). A few operations an element on both, once per chunk (K13a once more
// per repack of the early exit, without the population).
//
// Design, simple first: one block per state. K13a's threads first write
// the state's features and genes, keeping x0 and the gene bounds in shared
// memory, then (L2) one thread per moved row sums its ball squares left to
// right, then the threads write the population with consecutive threads on
// consecutive genes. K13b's threads copy the state's columns and decode
// each (column, feature) from the source column in global memory (L2 hits:
// a state's columns are a few KB).

#include "kernels.h"

namespace {

constexpr int kChunkThreads = 256;

__device__ __forceinline__ float clamp01(float v) {
  // torch.clamp(v, 0, 1): NaN stays NaN
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__global__ void __launch_bounds__(kChunkThreads) prepare_kernel(const __grid_constant__ ChunkPrepareArgs a) {
  extern __shared__ float smem[];
  float* x0 = smem;
  float* lo = smem + a.l;
  float* hi = smem + 2 * a.l;
  float* nrm = smem + 3 * a.l;
  const int s = blockIdx.x;
  const float* x = a.x + static_cast<int64_t>(s) * a.d;
  const float* xl = a.xl + static_cast<int64_t>(s) * a.d;
  const float* xu = a.xu + static_cast<int64_t>(s) * a.d;
  for (int j = threadIdx.x; j < a.d; j += kChunkThreads) {
    const float rng = __fsub_rn(xu[j], xl[j]);
    a.x_mm[static_cast<int64_t>(s) * a.d + j] = __fdiv_rn(__fsub_rn(x[j], xl[j]), rng == 0.0f ? 1.0f : rng);
  }
  for (int j = threadIdx.x; j < a.l; j += kChunkThreads) {
    float v, gl, gh;
    if (j < a.n1) {
      const int f = a.gene_feat[j];
      gl = xl[f];
      gh = xu[f];
      v = x[f];
    } else {
      const int32_t* members = a.group_idx + static_cast<int64_t>(a.gene_feat[j]) * a.k;
      int best_k = 0, size = 0;
      float best = -INFINITY;
      for (int kk = 0; kk < a.k; ++kk) {
        const int m = members[kk];
        size += m >= 0;
        const float val = m >= 0 ? x[m] : -INFINITY;
        // the first largest; the first NaN once one is seen
        if (kk == 0 || (best == best && (val != val || val > best))) {
          best = val;
          best_k = kk;
        }
      }
      gl = 0.0f;
      gh = static_cast<float>(size - 1);
      v = static_cast<float>(best_k);
    }
    if (a.int_gene[j]) v = rintf(v);
    a.xl_gen[static_cast<int64_t>(s) * a.l + j] = gl;
    a.xu_gen[static_cast<int64_t>(s) * a.l + j] = gh;
    x0[j] = v;
    lo[j] = gl;
    hi[j] = gh;
  }
  if (a.ideal != nullptr) {
    if (threadIdx.x < 3) {
      a.ideal[s * 3 + threadIdx.x] = INFINITY;
      a.worst[s * 3 + threadIdx.x] = -INFINITY;
    }
    if (threadIdx.x < 9) a.extreme[s * 9 + threadIdx.x] = 1e16f;
  }
  if (a.pop == nullptr) return;
  const int kept = a.p - a.n_pert;
  const float* ball = a.ball + static_cast<int64_t>(s) * a.n_pert * a.ball_cols;
  if (!a.norm_inf) {
    for (int r = threadIdx.x; r < a.n_pert; r += kChunkThreads) {
      const float* row = ball + static_cast<int64_t>(r) * a.ball_cols;
      float acc = __fmul_rn(row[0], row[0]);
      for (int c = 1; c < a.ball_cols; ++c) acc = __fadd_rn(acc, __fmul_rn(row[c], row[c]));
      nrm[r] = __double2float_rn(sqrt(static_cast<double>(acc)));
    }
  }
  __syncthreads();
  float* pop = a.pop + static_cast<int64_t>(s) * a.p * a.l;
  const int64_t n = static_cast<int64_t>(a.p) * a.l;
  for (int64_t e = threadIdx.x; e < n; e += kChunkThreads) {
    const int p = static_cast<int>(e / a.l), j = static_cast<int>(e % a.l);
    float v = x0[j];
    if (p >= kept) {
      const int r = p - kept;
      const float rng = __fsub_rn(hi[j], lo[j]);
      const float base = __fdiv_rn(__fsub_rn(v, lo[j]), rng > 0.0f ? rng : 1.0f);
      const float b = ball[static_cast<int64_t>(r) * a.ball_cols + j];
      const float delta = __fmul_rn(a.norm_inf ? b : __fdiv_rn(b, nrm[r]), a.eps);
      v = __fadd_rn(__fmul_rn(clamp01(__fadd_rn(base, delta)), rng), lo[j]);
      if (a.int_gene[j]) v = rintf(v);
    }
    pop[e] = v;
  }
}

__global__ void __launch_bounds__(kChunkThreads) decode_kernel(const __grid_constant__ ChunkDecodeArgs a) {
  const int s = blockIdx.x;
  const int cols = a.p + a.a;
  const float* px = a.pop_x + static_cast<int64_t>(s) * a.p * a.l;
  const float* ax = a.arch_x + static_cast<int64_t>(s) * a.a * a.l;
  float* gx = a.x_gen + static_cast<int64_t>(s) * cols * a.l;
  const int64_t n_pop = static_cast<int64_t>(a.p) * a.l;
  for (int64_t e = threadIdx.x; e < static_cast<int64_t>(cols) * a.l; e += kChunkThreads)
    gx[e] = e < n_pop ? px[e] : ax[e - n_pop];
  const float* pf = a.pop_f + static_cast<int64_t>(s) * a.p * 3;
  const float* af = a.arch_f + static_cast<int64_t>(s) * a.a * 3;
  float* f = a.f + static_cast<int64_t>(s) * cols * 3;
  for (int e = threadIdx.x; e < cols * 3; e += kChunkThreads) f[e] = e < a.p * 3 ? pf[e] : af[e - a.p * 3];
  const float* xi = a.x_init + static_cast<int64_t>(s) * a.d;
  float* out = a.x_ml + static_cast<int64_t>(s) * cols * a.d;
  for (int64_t e = threadIdx.x; e < static_cast<int64_t>(cols) * a.d; e += kChunkThreads) {
    const int c = static_cast<int>(e / a.d), j = static_cast<int>(e % a.d);
    const int g = a.feat_gene[j];
    float v;
    if (g < 0) {
      v = xi[j];
    } else {
      v = c < a.p ? px[static_cast<int64_t>(c) * a.l + g] : ax[static_cast<int64_t>(c - a.p) * a.l + g];
      const int slot = a.feat_onehot[j];
      if (slot >= 0) v = rintf(v) == static_cast<float>(slot) ? 1.0f : 0.0f;
    }
    out[e] = v;
  }
}

}  // namespace

cudaError_t launch_chunk_prepare(const ChunkPrepareArgs& a, cudaStream_t stream) {
  if (a.n_states == 0) return cudaSuccess;
  if (a.n_states < 0 || a.d < 1 || a.l < 1 || a.n1 < 0 || a.n1 > a.l || a.n_groups != a.l - a.n1 ||
      (a.n_groups > 0 && a.k < 1) || a.p < 0 || a.n_pert < 0 || a.n_pert > a.p ||
      (a.pop != nullptr && a.n_pert > 0 && (a.ball == nullptr || a.ball_cols < (a.norm_inf ? a.l : a.l + 1))) ||
      (a.ideal != nullptr && (a.worst == nullptr || a.extreme == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = (3 * static_cast<size_t>(a.l) + static_cast<size_t>(a.n_pert)) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  prepare_kernel<<<a.n_states, kChunkThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_chunk_decode(const ChunkDecodeArgs& a, cudaStream_t stream) {
  if (a.n_states == 0) return cudaSuccess;
  if (a.n_states < 0 || a.p < 1 || a.a < 0 || a.l < 1 || a.d < 1 || (a.a > 0 && a.arch_x == nullptr))
    return cudaErrorInvalidValue;
  decode_kernel<<<a.n_states, kChunkThreads, 0, stream>>>(a);
  return cudaGetLastError();
}
