// Device helpers the training kernels K11 (train_step.cu) and K12
// (input_grad.cu) share: a tile of kTrainTileRows rows through a relu stack
// and back, every activation and cotangent of the tile in shared memory,
// one rounded float32 operation at a time (__fadd_rn / __fmul_rn, so nvcc
// cannot contract them into FMAs), in the order of the plain versions
// (models/train.py::train_step_plain, input_grad_plain; models/mlp.py).
#pragma once

#include "pgd_common.cuh"

// Offsets (in floats) of a tile's buffers in dynamic shared memory: layer
// l's activations act[l] (rows x widths[l], act[0] the input rows, act[L]
// the logits), the cotangents ct[l] of layer l's outputs (l >= 1), and two
// floats a row (a loss term and a sample weight).
struct TileLayout {
  int act[kTrainMaxLayers + 1];
  int ct[kTrainMaxLayers + 1];
  int term;
  int total;
};

__host__ __device__ inline TileLayout tile_layout(const TrainShape& s) {
  TileLayout t{};
  int off = 0;
  for (int l = 0; l <= s.n_layers; ++l) {
    t.act[l] = off;
    off += kTrainTileRows * s.widths[l];
  }
  t.ct[0] = 0;
  for (int l = 1; l <= s.n_layers; ++l) {
    t.ct[l] = off;
    off += kTrainTileRows * s.widths[l];
  }
  t.term = off;
  off += 2 * kTrainTileRows;
  t.total = off;
  return t;
}

// The tile's `rows` input rows from x (row-major, d features) into act[0].
__device__ __forceinline__ void tile_load(const float* __restrict__ x, int64_t row0, int rows, int d, float* act0) {
  const float* src = x + row0 * d;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) act0[i] = src[i];
}

// Forward: unit o of layer l starts from its bias and adds
// a[k] * weight[o, k] for k = 0, 1, ...; hidden units go through relu (a
// NaN stays), the last layer's are the logits.
__device__ __forceinline__ void tile_forward(const TrainShape& s, const float* __restrict__ params, float* sm,
                                             const TileLayout& t, int rows) {
  for (int l = 1; l <= s.n_layers; ++l) {
    const int in = s.widths[l - 1], out = s.widths[l];
    const float* __restrict__ wl = params + s.w_off[l - 1];
    const float* __restrict__ bl = params + s.b_off[l - 1];
    const float* a = sm + t.act[l - 1];
    float* z = sm + t.act[l];
    const bool hidden = l < s.n_layers;
    for (int i = threadIdx.x; i < rows * out; i += blockDim.x) {
      const int r = i / out, o = i - r * out;
      const float* ar = a + r * in;
      const float* wo = wl + static_cast<int64_t>(o) * in;
      float acc = __ldg(bl + o);
      for (int k = 0; k < in; ++k) acc = __fadd_rn(acc, __fmul_rn(ar[k], __ldg(wo + k)));
      z[i] = hidden ? relu_keep_nan(acc) : acc;
    }
    __syncthreads();
  }
}

// The cotangent of layer l's inputs from that of its outputs ct_out:
// input unit k sums ct_out[o] * weight[o, k] for o = 0, 1, ...; where the
// inputs are a hidden layer's outputs (mask), a unit passes its cotangent
// where its output a_in is above 0 and 0 elsewhere (jax.nn.relu's select).
__device__ __forceinline__ void tile_backprop(const float* __restrict__ wl, int in, int out, const float* ct_out,
                                              const float* a_in, bool mask, int rows, float* ct_in) {
  for (int i = threadIdx.x; i < rows * in; i += blockDim.x) {
    const int r = i / in, k = i - r * in;
    const float* c = ct_out + r * out;
    float acc = __fmul_rn(c[0], __ldg(wl + k));
    for (int o = 1; o < out; ++o) acc = __fadd_rn(acc, __fmul_rn(c[o], __ldg(wl + static_cast<int64_t>(o) * in + k)));
    ct_in[i] = mask && !(a_in[i] > 0.0f) ? 0.0f : acc;
  }
}

// The (max-shifted) softmax of a 2-class row of logits: e_j = exp(l_j -
// max) in float64 rounded once, and their sum.
__device__ __forceinline__ void softmax2(const float* lg, float& mx, float& e0, float& e1, float& tot) {
  mx = nan_max(lg[0], lg[1]);
  e0 = exp_rn(__fsub_rn(lg[0], mx));
  e1 = exp_rn(__fsub_rn(lg[1], mx));
  tot = __fadd_rn(e0, e1);
}
