// K16: the surrogate's forward outside the attacks, two instantiations:
// float32 rows to int64 labels (the PGD runner's labels) and float64 rows to
// class-1 probabilities (the defense and RQ4 pipelines' proba1).
//
// Replaces the jnp device stages moeva2_ijcai22_replication_tpu/experiments/
// pgd.py's label line (Surrogate.predict_proba then argmax, op by op) and
// experiments/defense.py::proba1 (the repo has no Pallas kernel for them),
// which the port ran as an eager MLP forward, softmax and argmax.
//
// Semantics (must equal the plain versions bit for bit):
// - labels: attacks/pgd/engine.py::predict_plain, i.e. models/mlp.py::
//   mlp_forward_plain's float32 order (each unit starts from its bias and
//   adds a[k] * weight[o, k] for k = 0, 1, ..., one rounded operation at a
//   time; relu keeps a NaN), then mlp_proba_plain's softmax (exp in float64
//   rounded once over the left-to-right sum; a 1-unit head as [1 - p, p])
//   and the first largest probability (a NaN counts as the largest), which
//   pgd_common.cuh's predicted_class computes for K7 and K7b too;
// - proba1: models/mlp.py::proba1_plain, the same order in float64, then
//   e1 / (e0 + e1) with e = exp(l - max) (1 / (1 + exp(-l)) for a 1-unit
//   head).
//
// Bound: bytes for the rows (D values a row read once), operations for the
// stack's multiply-adds (2 * params a row); the weights are read from L2 by
// every warp.
//
// Design: one warp a row, eight rows a block; lane l computes units l, l +
// 32, ... of each layer, each unit's sum over its inputs in order; the
// row's input is read from device memory (every lane the same address), the
// hidden activations lie in two per-warp shared buffers of kForwardMaxWidth
// values, __syncwarp between layers. Lane 0 takes the logits.

#include "kernels.h"
#include "pgd_common.cuh"

namespace {

constexpr int kForwardWarps = 8;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T relu_nan(T x) {
  return !(x > T(0)) && !isnan(x) ? T(0) : x;
}

// The class-1 probability of a row's float64 logits.
__device__ __forceinline__ double proba1_of(int classes, const double* lg) {
  if (classes == 1) return __ddiv_rn(1.0, __dadd_rn(1.0, exp(-lg[0])));
  const double mx = isnan(lg[0]) ? lg[0] : isnan(lg[1]) ? lg[1] : fmax(lg[0], lg[1]);
  const double e0 = exp(__dsub_rn(lg[0], mx));
  const double e1 = exp(__dsub_rn(lg[1], mx));
  return __ddiv_rn(e1, __dadd_rn(e0, e1));
}

template <typename T, bool kLabels>
__global__ void __launch_bounds__(32 * kForwardWarps)
forward_kernel(const T* __restrict__ x, const T* __restrict__ params, ForwardShape s, int n,
               int64_t* __restrict__ labels, T* __restrict__ proba1) {
  __shared__ T act[kForwardWarps][2][kForwardMaxWidth];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kForwardWarps + warp;
  if (row >= n) return;  // the whole warp: no block barrier follows
  const T* a = x + row * s.widths[0];
  int64_t off = 0;
  for (int l = 0; l < s.n_layers; ++l) {
    const int in = s.widths[l], out = s.widths[l + 1];
    const T* __restrict__ w = params + off;
    const T* __restrict__ b = w + static_cast<int64_t>(in) * out;
    off += static_cast<int64_t>(in) * out + out;
    T* z = act[warp][l & 1];
    const bool hidden = l < s.n_layers - 1;
    for (int o = lane; o < out; o += 32) {
      const T* wo = w + static_cast<int64_t>(o) * in;
      T acc = b[o];
      for (int k = 0; k < in; ++k) acc = add_rn(acc, mul_rn(a[k], wo[k]));
      z[o] = hidden ? relu_nan(acc) : acc;
    }
    __syncwarp();
    a = z;
  }
  if (lane != 0) return;
  const int classes = s.widths[s.n_layers];
  if constexpr (kLabels) {
    labels[row] = predicted_class(classes, reinterpret_cast<const float*>(a));
  } else {
    proba1[row] = proba1_of(classes, reinterpret_cast<const double*>(a));
  }
}

bool shape_ok(const ForwardShape& s) {
  if (s.n_layers < 1 || s.n_layers > kForwardMaxLayers || s.widths[0] < 1) return false;
  for (int l = 1; l <= s.n_layers; ++l)
    if (s.widths[l] < 1 || s.widths[l] > kForwardMaxWidth) return false;
  const int classes = s.widths[s.n_layers];
  return classes == 1 || classes == 2;
}

template <typename T, bool kLabels>
cudaError_t launch(const T* x, const T* params, const ForwardShape& s, int n, int64_t* labels, T* proba1,
                   cudaStream_t stream) {
  if (n < 0 || !shape_ok(s)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  forward_kernel<T, kLabels><<<(n + kForwardWarps - 1) / kForwardWarps, 32 * kForwardWarps, 0, stream>>>(
      x, params, s, n, labels, proba1);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_forward_labels(const float* x, const float* params, const ForwardShape& shape, int n,
                                  int64_t* labels, cudaStream_t stream) {
  return launch<float, true>(x, params, shape, n, labels, nullptr, stream);
}

cudaError_t launch_forward_proba1(const double* x, const double* params, const ForwardShape& shape, int n,
                                  double* proba1, cudaStream_t stream) {
  return launch<double, false>(x, params, shape, n, nullptr, proba1, stream);
}
