// K11: one training step of a surrogate MLP, and its loss-only
// instantiation, the validation loss.
//
// Replaces the jnp device programs of moeva2_ijcai22_replication_tpu/
// models/train.py (the repo has no Pallas kernel for either): the jitted
// step (:92, jax.jit(make_train_step) at :40 over ce_loss at :23: MLP
// forward, softmax cross-entropy at integer labels, times the class weight,
// the sample-weighted mean sum(w l) / max(sum(w), 1e-12), its gradient to
// every weight and optax.adam(lr) applied), and the validation loss (:93,
// the unweighted mean of cw[y] * l).
//
// Semantics (must equal models/train.py::train_step_plain and
// train_loss_plain bit for bit). Per row r with label y (clamped into
// [0, 1], as JAX's gather clamps), class weight cw[y] and sample weight w:
// the forward of mlp_tile.cuh; mx = max(l0, l1), e_j = exp(l_j - mx) (in
// float64, rounded once), tot = e0 + e1, the loss (mx + log(tot)) - l_y
// (log in float64, rounded once); the term (loss * cw[y]) * w, and the
// cotangent of the logits (cw[y] * w) * (e_j / tot - [j == y]). Backward:
// a tile's gradient of weight (o, k) sums ct[r][o] * a[r][k] over its rows
// r = 0, 1, ... (a bias: ct[r][o]), the first row's product first; the
// cotangent goes down through tile_backprop. Launch 2, per parameter: the
// tiles' partials summed t = 0, 1, ..., divided by W = max(sum of the
// tiles' weight sums, 1e-12); then optax.scale_by_adam as written
// (mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu; mu_hat = mu / bc1,
// nu_hat = nu / bc2; u = mu_hat / (sqrt(nu_hat) + eps)) and
// p = p + (-lr) u. The loss: the tiles' term sums, left to right, over W.
// The loss-only instantiation writes each tile's sum of loss * cw[y] (w =
// 1) and stops there; the host sums the tiles left to right and divides by
// the row count. No atomics anywhere: every sum has one fixed order.
//
// Bound: at the shapes the defense pipelines train (LCLD batch 512, D 47
// or 57, 64-32-16-2; botnet batch 256, D 756 or 927, 64-64-32-2) a step
// moves its batch once (at most 0.95 MB) and reads and writes 3 x 4 bytes
// per parameter (at most 0.79 MB), and does about 6 operations per weight
// and row (forward, cotangent, gradient): ~13 to 100 MFLOP, so the bound is
// operations, at 0.2 to 1.5 us on the card; the step is launch- and
// latency-bound at these sizes.
//
// Design, simple first: launch 1 runs one block of kTrainThreads threads a
// tile of kTrainTileRows rows (32 tiles at LCLD's batch, 16 at botnet's);
// the tile's rows, every layer's activations and cotangents sit in shared
// memory (80 KB at D = 927), the weights are read through the read-only
// cache; each phase spreads its (row, unit) or (parameter) work over the
// block's threads, one thread a sum, the sum's order fixed. The partial
// gradients go to device memory (n_tiles x n_params floats) and launch 2
// reduces them, one thread a parameter.

#include "mlp_tile.cuh"

namespace {

constexpr int kAdamThreads = 256;

// The tile's loss terms, and the logits' cotangents (kLossOnly: terms only)
template <bool kLossOnly>
__device__ __forceinline__ void tile_loss(const int64_t* __restrict__ y, const float* __restrict__ w,
                                          const float* __restrict__ cw, int64_t row0, int rows, float* sm,
                                          const TileLayout& t, int n_layers) {
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* lg = sm + t.act[n_layers] + r * 2;
  const int64_t yraw = y[row0 + r];
  const int yv = yraw < 0 ? 0 : (yraw > 1 ? 1 : static_cast<int>(yraw));
  float mx, e0, e1, tot;
  softmax2(lg, mx, e0, e1, tot);
  const float lse = __double2float_rn(log(static_cast<double>(tot)));
  const float loss = __fsub_rn(__fadd_rn(mx, lse), lg[yv]);
  const float cwy = __ldg(cw + yv);
  const float wv = kLossOnly ? 1.0f : __ldg(w + row0 + r);
  sm[t.term + r] = __fmul_rn(__fmul_rn(loss, cwy), wv);
  if (kLossOnly) return;
  sm[t.term + kTrainTileRows + r] = wv;
  const float c = __fmul_rn(cwy, wv);
  float* ct = sm + t.ct[n_layers] + r * 2;
  ct[0] = __fmul_rn(c, __fsub_rn(__fdiv_rn(e0, tot), yv == 0 ? 1.0f : 0.0f));
  ct[1] = __fmul_rn(c, __fsub_rn(__fdiv_rn(e1, tot), yv == 1 ? 1.0f : 0.0f));
}

template <bool kLossOnly>
__global__ void __launch_bounds__(kTrainThreads)
train_grad_kernel(const float* __restrict__ x, const int64_t* __restrict__ y, const float* __restrict__ w,
                  const float* __restrict__ cw, const float* __restrict__ params, const __grid_constant__ TrainShape s,
                  int n, float* __restrict__ part_grad, float* __restrict__ part_loss) {
  extern __shared__ float sm[];
  const TileLayout t = tile_layout(s);
  const int tile = blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kTrainTileRows;
  const int rows = min(kTrainTileRows, static_cast<int>(n - row0));
  const int L = s.n_layers;
  tile_load(x, row0, rows, s.widths[0], sm + t.act[0]);
  __syncthreads();
  tile_forward(s, params, sm, t, rows);
  tile_loss<kLossOnly>(y, w, cw, row0, rows, sm, t, L);
  __syncthreads();
  if (threadIdx.x == 0) {
    float lsum = sm[t.term];
    for (int r = 1; r < rows; ++r) lsum = __fadd_rn(lsum, sm[t.term + r]);
    if (kLossOnly) {
      part_loss[tile] = lsum;
    } else {
      float wsum = sm[t.term + kTrainTileRows];
      for (int r = 1; r < rows; ++r) wsum = __fadd_rn(wsum, sm[t.term + kTrainTileRows + r]);
      part_loss[2 * tile] = lsum;
      part_loss[2 * tile + 1] = wsum;
    }
  }
  if (kLossOnly) return;
  float* grad = part_grad + static_cast<int64_t>(tile) * s.n_params;
  for (int l = L; l >= 1; --l) {
    const int in = s.widths[l - 1], out = s.widths[l];
    const float* ct = sm + t.ct[l];
    const float* a = sm + t.act[l - 1];
    // this layer's partial gradients: weights (o, k) row-major, then biases
    float* gw = grad + s.w_off[l - 1];
    float* gb = grad + s.b_off[l - 1];
    for (int p = threadIdx.x; p < out * in + out; p += blockDim.x) {
      if (p < out * in) {
        const int o = p / in, k = p - o * in;
        float g = __fmul_rn(ct[o], a[k]);
        for (int r = 1; r < rows; ++r) g = __fadd_rn(g, __fmul_rn(ct[r * out + o], a[r * in + k]));
        gw[p] = g;
      } else {
        const int o = p - out * in;
        float g = ct[o];
        for (int r = 1; r < rows; ++r) g = __fadd_rn(g, ct[r * out + o]);
        gb[o] = g;
      }
    }
    if (l > 1) tile_backprop(params + s.w_off[l - 1], in, out, ct, a, true, rows, sm + t.ct[l - 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kAdamThreads)
adam_kernel(const float* __restrict__ part_grad, const float* __restrict__ part_loss, int n_tiles,
            int64_t n_params, const AdamScalars a, float* __restrict__ params, float* __restrict__ mu,
            float* __restrict__ nu, float* __restrict__ loss) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kAdamThreads + threadIdx.x;
  float wsum = part_loss[1];
  for (int t = 1; t < n_tiles; ++t) wsum = __fadd_rn(wsum, part_loss[2 * t + 1]);
  const float den = nan_max(wsum, 1e-12f);
  if (p == 0) {
    float lsum = part_loss[0];
    for (int t = 1; t < n_tiles; ++t) lsum = __fadd_rn(lsum, part_loss[2 * t]);
    loss[0] = __fdiv_rn(lsum, den);
  }
  if (p >= n_params) return;
  float g = part_grad[p];
  for (int t = 1; t < n_tiles; ++t) g = __fadd_rn(g, part_grad[static_cast<int64_t>(t) * n_params + p]);
  g = __fdiv_rn(g, den);
  const float m = __fadd_rn(__fmul_rn(a.c1, g), __fmul_rn(a.b1, mu[p]));
  const float v = __fadd_rn(__fmul_rn(a.c2, __fmul_rn(g, g)), __fmul_rn(a.b2, nu[p]));
  const float m_hat = __fdiv_rn(m, a.bc1);
  const float v_hat = __fdiv_rn(v, a.bc2);
  const float u = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), a.eps));
  params[p] = __fadd_rn(params[p], __fmul_rn(a.neg_lr, u));
  mu[p] = m;
  nu[p] = v;
}

LaunchCache& grad_cache() {
  static LaunchCache cache;
  return cache;
}

LaunchCache& loss_cache() {
  static LaunchCache cache;
  return cache;
}

}  // namespace

bool train_shape(const int* widths, int n_layers, TrainShape* shape) {
  if (n_layers < 1 || n_layers > kTrainMaxLayers || widths[n_layers] != 2) return false;
  TrainShape s{};
  s.n_layers = n_layers;
  int64_t off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1) return false;
    s.widths[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    s.w_off[l] = off;
    off += static_cast<int64_t>(widths[l]) * widths[l + 1];
    s.b_off[l] = off;
    off += widths[l + 1];
  }
  s.n_params = off;
  *shape = s;
  return true;
}

size_t train_tile_smem_bytes(const TrainShape& shape) {
  int64_t floats = 2 * kTrainTileRows;
  for (int l = 0; l <= shape.n_layers; ++l) floats += static_cast<int64_t>(kTrainTileRows) * shape.widths[l] * (l ? 2 : 1);
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  return bytes > kMaxSharedBytes ? 0 : bytes;
}

cudaError_t launch_train_step(const float* x, const int64_t* y, const float* w, const float* cw,
                              float* params, float* mu, float* nu, const TrainShape& shape, int n,
                              const AdamScalars& adam, float* part_grad, float* part_loss,
                              float* loss, cudaStream_t stream) {
  const size_t smem = train_tile_smem_bytes(shape);
  if (n < 1 || smem == 0) return cudaErrorInvalidValue;
  const int n_tiles = (n + kTrainTileRows - 1) / kTrainTileRows;
  cudaError_t err = grad_cache().prepare(reinterpret_cast<const void*>(&train_grad_kernel<false>), kTrainThreads,
                                         smem, nullptr);
  if (err != cudaSuccess) return err;
  train_grad_kernel<false><<<n_tiles, kTrainThreads, smem, stream>>>(x, y, w, cw, params, shape, n, part_grad,
                                                                     part_loss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (shape.n_params + kAdamThreads - 1) / kAdamThreads;
  adam_kernel<<<static_cast<unsigned>(blocks), kAdamThreads, 0, stream>>>(part_grad, part_loss, n_tiles,
                                                                         shape.n_params, adam, params, mu, nu, loss);
  return cudaGetLastError();
}

cudaError_t launch_train_loss(const float* x, const int64_t* y, const float* cw,
                              const float* params, const TrainShape& shape, int n,
                              float* part_loss, cudaStream_t stream) {
  const size_t smem = train_tile_smem_bytes(shape);
  if (n < 1 || smem == 0) return cudaErrorInvalidValue;
  const int n_tiles = (n + kTrainTileRows - 1) / kTrainTileRows;
  cudaError_t err = loss_cache().prepare(reinterpret_cast<const void*>(&train_grad_kernel<true>), kTrainThreads,
                                         smem, nullptr);
  if (err != cudaSuccess) return err;
  train_grad_kernel<true><<<n_tiles, kTrainThreads, smem, stream>>>(x, y, nullptr, cw, params, shape, n, nullptr,
                                                                    part_loss);
  return cudaGetLastError();
}
