// K5: genetic operators, one thread block per state, one thread per
// (offspring, gene).
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// operators.py::make_offspring (vmapped over states in engine.py gen_step):
// uniform parent pairs, mixed-variable two-point crossover with one cut pair
// and one coin per type sub-vector, and polynomial mutation. The repo has no
// Pallas kernel for it.
//
// Semantics: those of the plain attacks/moeva/operators.py::make_offspring,
// every draw an input (OffspringDraws). Child o < n_mat is the first child of
// mating o, child o >= n_mat the second child of mating o - n_mat. Integer
// genes mutate on bounds widened by float32(0.5 - 1e-16) = 0.5 and are
// rounded half to even (rintf, as torch.round). Both pows are taken in
// float64 and rounded once to float32, as the plain version does; every
// other operation is one float32 operation written with __fadd_rn /
// __fmul_rn / __fdiv_rn in the plain version's order, so nvcc cannot contract
// them into FMAs. min/max propagate NaN as torch.minimum/maximum do.
//
// Design: an output gene needs two parent genes, its mating's cut pair and
// coin for its type, two uniforms and its bounds; nothing is shared between
// threads that is worth staging, so each thread reads what it needs from
// device memory. Per gene that is ~40 flops and two float64 pows on ~24 bytes
// read and 4 written: bound by bytes (the two (S, N, L) uniform fields) in
// principle.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// operators.two_cuts: the sorted swap segment [lo, hi) of a sub-vector of
// n genes from two non-negative raw draws.
__device__ __forceinline__ void two_cuts(int64_t a_raw, int64_t b_raw,
                                         int64_t n, int64_t& lo,
                                         int64_t& hi) {
  const int64_t m = n - 1 > 1 ? n - 1 : 1;
  if (m == 1) {
    lo = n == 2 ? 1 : 0;
    hi = n == 2 ? n : 0;
    return;
  }
  const int64_t a = a_raw % m;
  int64_t b = b_raw % (m - 1 > 1 ? m - 1 : 1);
  if (b >= a) b += 1;
  lo = (a < b ? a : b) + 1;
  hi = (a < b ? b : a) + 1;
}

struct TypeSizes {
  int64_t n[3];
};

__global__ void __launch_bounds__(kThreads)
offspring_kernel(const float* __restrict__ pop, const float* __restrict__ xl,
                 const float* __restrict__ xu,
                 const int64_t* __restrict__ pairs,
                 const int64_t* __restrict__ cut_a,
                 const int64_t* __restrict__ cut_b,
                 const float* __restrict__ coins,
                 const float* __restrict__ mut_select,
                 const float* __restrict__ mut_u,
                 const int64_t* __restrict__ type_id,
                 const int64_t* __restrict__ rank_in_type,
                 const double* __restrict__ mut_prob,
                 const bool* __restrict__ int_mask, TypeSizes sizes,
                 float* __restrict__ out, int n_states, int p, int l,
                 int n_off, int n_mat, float prob, double eta_p1,
                 double mut_pow) {
  const size_t s = blockIdx.x;
  const float half = static_cast<float>(0.5 - 1e-16);
  for (int e = threadIdx.x; e < n_off * l; e += blockDim.x) {
    const int o = e / l;
    const int g = e % l;
    const bool second = o >= n_mat;
    const int i = second ? o - n_mat : o;

    // crossover: the child takes the other parent's gene inside its type's
    // swap segment when the type's coin says cross
    const int64_t t = type_id[g];
    const size_t di = (static_cast<size_t>(t) * n_states + s) * n_mat + i;
    int64_t lo, hi;
    two_cuts(cut_a[di], cut_b[di], sizes.n[t], lo, hi);
    const int64_t rk = rank_in_type[g];
    const bool swap = rk >= lo && rk < hi && coins[di] < prob;
    const int64_t* pr = pairs + (s * n_mat + i) * 2;
    const float x1 = pop[(s * p + pr[0]) * l + g];
    const float x2 = pop[(s * p + pr[1]) * l + g];
    const float x = swap != second ? x2 : x1;

    // polynomial mutation
    const float lo_b = xl[s * l + g];
    const float hi_b = xu[s * l + g];
    const bool is_int = int_mask[g];
    const float ext = is_int ? half : 0.0f;
    const float exl = __fsub_rn(lo_b, ext);
    const float exu = __fadd_rn(hi_b, ext);
    const float rng = __fsub_rn(exu, exl);
    const bool ok = rng > 0.0f;
    const float safe = ok ? rng : 1.0f;
    const size_t ui = (s * n_off + o) * l + g;
    const float u = mut_u[ui];
    const bool lower = u <= 0.5f;
    const float d = lower ? __fdiv_rn(__fsub_rn(x, exl), safe)
                          : __fdiv_rn(__fsub_rn(exu, x), safe);
    float xy = __fsub_rn(1.0f, d);
    xy = isnan(xy) ? xy : fminf(fmaxf(xy, 0.0f), 1.0f);
    const float pw =
        __double2float_rn(pow(static_cast<double>(xy), eta_p1));
    float val;
    if (lower) {
      const float two_u = __fmul_rn(2.0f, u);
      val = __fadd_rn(two_u, __fmul_rn(__fsub_rn(1.0f, two_u), pw));
    } else {
      val = __fadd_rn(__fmul_rn(2.0f, __fsub_rn(1.0f, u)),
                      __fmul_rn(__fmul_rn(2.0f, __fsub_rn(u, 0.5f)), pw));
    }
    val = isnan(val) ? val : fmaxf(val, 0.0f);
    const float q =
        __double2float_rn(pow(static_cast<double>(val), mut_pow));
    const float deltaq = lower ? __fsub_rn(q, 1.0f) : __fsub_rn(1.0f, q);
    const bool mutate =
        mut_select[ui] < static_cast<float>(mut_prob[g]) && ok;
    float y = mutate ? __fadd_rn(x, __fmul_rn(deltaq, safe)) : x;
    if (is_int) y = rintf(y);
    out[ui] = nan_min(nan_max(y, lo_b), hi_b);
  }
}

}  // namespace

cudaError_t launch_offspring(const float* pop, const float* xl,
                             const float* xu, const int64_t* pairs,
                             const int64_t* cut_a, const int64_t* cut_b,
                             const float* coins, const float* mut_select,
                             const float* mut_u, const int64_t* type_id,
                             const int64_t* rank_in_type,
                             const double* mut_prob, const bool* int_mask,
                             const int64_t* type_sizes, float* out,
                             int n_states, int p, int l, int n_off, int n_mat,
                             float prob, double eta_p1, double mut_pow,
                             cudaStream_t stream) {
  if (n_states == 0 || n_off == 0 || l == 0) return cudaSuccess;
  if (n_states < 0 || n_off < 0 || l < 0 || p <= 0 || n_mat <= 0 ||
      n_off > 2 * n_mat)
    return cudaErrorInvalidValue;
  TypeSizes sizes;
  for (int k = 0; k < 3; ++k) sizes.n[k] = type_sizes[k];
  offspring_kernel<<<n_states, kThreads, 0, stream>>>(
      pop, xl, xu, pairs, cut_a, cut_b, coins, mut_select, mut_u, type_id,
      rank_in_type, mut_prob, int_mask, sizes, out, n_states, p, l, n_off,
      n_mat, prob, eta_p1, mut_pow);
  return cudaGetLastError();
}
