// K1: MoEvA2's objectives on the LCLD domain, one thread block per state,
// one thread per candidate row.
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
//   PyTorch's fmod-based one), each kept where > tol and 0 elsewhere (a NaN
//   term counts 0), summed left to right.
// Constants that the plain version writes as Python floats are the float32
// roundings of the same doubles.
//
// Design: the whole relu stack (5,600 floats for 47-64-32-16-2) and the
// state's per-feature rows sit in shared memory; each thread runs its row
// through decode, MLP, distance and constraints with its activations in
// local memory. Weight reads are warp-wide broadcasts. The MLP dominates the
// work (~5,600 multiply-adds per row) on ~110 bytes of genes and 12 of
// objectives per row: bound by operations (fp32, no tensor cores: the fixed
// summation order is what makes the result equal the plain version).

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;

struct MlpShape {
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// torch.floor(a / 100) * 12 + torch.remainder(a, 100)
__device__ __forceinline__ float months(float a) {
  float rem = fmodf(a, 100.0f);
  if (rem != 0.0f && rem < 0.0f) rem = __fadd_rn(rem, 100.0f);
  return __fadd_rn(__fmul_rn(floorf(__fdiv_rn(a, 100.0f)), 12.0f), rem);
}

__global__ void __launch_bounds__(kThreads)
objective_lcld_kernel(const float* __restrict__ x_gen,
                      const float* __restrict__ x_init,
                      const float* __restrict__ xl,
                      const float* __restrict__ xu,
                      const float* __restrict__ x_init_mm,
                      const int64_t* __restrict__ min_class,
                      const int32_t* __restrict__ feat_gene,
                      const int32_t* __restrict__ feat_onehot,
                      const float* __restrict__ params, int n_params,
                      MlpShape shape, const float* __restrict__ scale,
                      const float* __restrict__ offset, float f2_scale,
                      int norm_inf, float tol, float* __restrict__ out, int n,
                      int l, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w = reinterpret_cast<float*>(smem);  // (n_params,)
  float* x0 = w + n_params;                    // (d,) initial state
  float* lo = x0 + d;                          // (d,) lower bounds
  float* den = lo + d;                         // (d,) min-max denominators
  float* mm0 = den + d;                        // (d,) normalised initial state
  float* sc = mm0 + d;                         // (d,) scaler scale
  float* of = sc + d;                          // (d,) scaler offset
  int* fg = reinterpret_cast<int*>(of + d);    // (d,) feat_gene
  int* fk = fg + d;                            // (d,) feat_onehot

  const size_t s = blockIdx.x;
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) w[k] = params[k];
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    x0[k] = x_init[s * d + k];
    lo[k] = xl[s * d + k];
    const float rng = __fsub_rn(xu[s * d + k], lo[k]);
    den[k] = rng == 0.0f ? 1.0f : rng;
    mm0[k] = x_init_mm[s * d + k];
    sc[k] = scale != nullptr ? scale[k] : 1.0f;
    of[k] = offset != nullptr ? offset[k] : 0.0f;
    fg[k] = feat_gene[k];
    fk[k] = feat_onehot[k];
  }
  __syncthreads();
  const bool scaled = scale != nullptr;
  const int cls = static_cast<int>(min_class[s]);
  const float thr = tol;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* gj = x_gen + (s * n + j) * l;
    float xf[kObjectiveMaxWidth];
    float buf0[kObjectiveMaxWidth], buf1[kObjectiveMaxWidth];
    float* a = buf0;
    float* h = buf1;

    // decode, distance, scaler
    float dist = 0.0f;
    for (int k = 0; k < d; ++k) {
      float v;
      if (fg[k] < 0) {
        v = x0[k];
      } else {
        const float gv = gj[fg[k]];
        v = fk[k] < 0 ? gv
                      : (rintf(gv) == static_cast<float>(fk[k]) ? 1.0f : 0.0f);
      }
      xf[k] = v;
      const float diff = __fsub_rn(__fdiv_rn(__fsub_rn(v, lo[k]), den[k]), mm0[k]);
      if (norm_inf) {
        dist = k == 0 ? fabsf(diff) : nan_max(dist, fabsf(diff));
      } else {
        const float sq = __fmul_rn(diff, diff);
        dist = k == 0 ? sq : __fadd_rn(dist, sq);
      }
      a[k] = scaled ? __fadd_rn(__fmul_rn(v, sc[k]), of[k]) : v;
    }
    if (!norm_inf) dist = __fsqrt_rn(dist);
    const float f2 = __fdiv_rn(dist, f2_scale);

    // relu stack
    const float* wp = w;
    int in_w = shape.widths[0];
    for (int layer = 0; layer < shape.n_layers; ++layer) {
      const int out_w = shape.widths[layer + 1];
      const float* bias = wp + out_w * in_w;
      const bool hidden = layer + 1 < shape.n_layers;
      for (int o = 0; o < out_w; ++o) {
        const float* row = wp + o * in_w;
        float acc = bias[o];
        for (int k = 0; k < in_w; ++k)
          acc = __fadd_rn(acc, __fmul_rn(a[k], row[k]));
        h[o] = hidden && !(acc > 0.0f) && !isnan(acc) ? 0.0f : acc;
      }
      float* t = a;
      a = h;
      h = t;
      wp = bias + out_w;
      in_w = out_w;
    }

    // class probabilities
    float p0, p1;
    if (in_w == 1) {
      const float e = __double2float_rn(exp(-static_cast<double>(a[0])));
      p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
      p0 = __fsub_rn(1.0f, p1);
    } else {
      const float mx = nan_max(a[0], a[1]);
      const float e0 = __double2float_rn(exp(static_cast<double>(__fsub_rn(a[0], mx))));
      const float e1 = __double2float_rn(exp(static_cast<double>(__fsub_rn(a[1], mx))));
      const float sum = __fadd_rn(e0, e1);
      p0 = __fdiv_rn(e0, sum);
      p1 = __fdiv_rn(e1, sum);
    }
    const float f1 = cls == 0 ? p0 : p1;

    // LCLD constraint terms (domains/lcld.py), thresholded and summed
    const float r = __fdiv_rn(xf[2], 1200.0f);
    const float growth = __double2float_rn(
        pow(static_cast<double>(__fadd_rn(1.0f, r)), static_cast<double>(xf[1])));
    const float inst = __fdiv_rn(__fmul_rn(__fmul_rn(xf[0], r), growth),
                                 __fsub_rn(growth, 1.0f));
    const bool denom_ok = xf[11] != 0.0f;
    float ratio = denom_ok ? __fdiv_rn(xf[16], xf[11]) : -1.0f;
    if (!isfinite(ratio)) ratio = -1.0f;
    const float terms[10] = {
        __fsub_rn(fabsf(__fsub_rn(xf[3], inst)), static_cast<float>(0.099999)),
        __fsub_rn(xf[10], xf[14]),
        __fsub_rn(xf[16], xf[11]),
        fabsf(__fmul_rn(__fsub_rn(36.0f, xf[1]), __fsub_rn(60.0f, xf[1]))),
        fabsf(__fsub_rn(xf[20], __fdiv_rn(xf[0], xf[6]))),
        fabsf(__fsub_rn(xf[21], __fdiv_rn(xf[10], xf[14]))),
        fabsf(__fsub_rn(xf[22], __fsub_rn(months(xf[7]), months(xf[9])))),
        fabsf(__fsub_rn(xf[23], __fdiv_rn(xf[11], xf[22]))),
        fabsf(__fsub_rn(xf[24], __fdiv_rn(xf[16], xf[22]))),
        fabsf(__fsub_rn(xf[25], ratio)),
    };
    float g = terms[0] > thr ? terms[0] : 0.0f;
    for (int k = 1; k < 10; ++k)
      g = __fadd_rn(g, terms[k] > thr ? terms[k] : 0.0f);

    float* oj = out + (s * n + j) * 3;
    oj[0] = f1;
    oj[1] = f2;
    oj[2] = g;
  }
}

}  // namespace

cudaError_t launch_objective_lcld(
    const float* x_gen, const float* x_init, const float* xl, const float* xu,
    const float* x_init_mm, const int64_t* min_class, const int32_t* feat_gene,
    const int32_t* feat_onehot, const float* params, const int* widths,
    int n_layers, const float* scale, const float* offset, float f2_scale,
    int norm_inf, float tol, float* out, int n_states, int n, int l, int d,
    cudaStream_t stream) {
  if (n_states == 0 || n == 0) return cudaSuccess;
  if (n_states < 0 || n < 0 || l <= 0 || d != kLcldFeatures ||
      n_layers < 1 || n_layers > kObjectiveMaxLayers || widths[0] != d)
    return cudaErrorInvalidValue;
  MlpShape shape;
  shape.n_layers = n_layers;
  int n_params = 0;
  for (int k = 0; k <= n_layers; ++k) {
    if (widths[k] < 1 || widths[k] > kObjectiveMaxWidth) return cudaErrorInvalidValue;
    shape.widths[k] = widths[k];
    if (k > 0) n_params += widths[k] * (widths[k - 1] + 1);
  }
  if (widths[n_layers] > 2 || n_params > kObjectiveMaxParams)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (n_params + 8 * d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        objective_lcld_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  objective_lcld_kernel<<<n_states, kThreads, smem, stream>>>(
      x_gen, x_init, xl, xu, x_init_mm, min_class, feat_gene, feat_onehot,
      params, n_params, shape, scale, offset, f2_scale, norm_inf, tol, out, n,
      l, d);
  return cudaGetLastError();
}
