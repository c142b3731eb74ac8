// K12: the attribution gradient of the defense pipeline's feature
// importance.
//
// Replaces the jnp device program of moeva2_ijcai22_replication_tpu/
// experiments/defense.py:175 (the repo has no Pallas kernel for it):
// jit(vmap(grad(p0))) over the class-balanced subsample, p0 the softmax's
// class-0 probability of one scaled row.
//
// Semantics (must equal models/train.py::input_grad_plain bit for bit):
// per row, the forward of mlp_tile.cuh; mx, e_j and tot as K11's softmax
// (exp in float64, rounded once); p_j = e_j / tot; the cotangent of the
// logits p0 * ([j == 0] - p_j); then tile_backprop down to the input (each
// input unit's sum over o = 0, 1, ..., relu masks on the hidden layers).
// The mean of |g (x - mean)| and the argsort stay host numpy, as in JAX.
//
// Bound: at the pipelines' shapes (LCLD 10,000 x 47, botnet 600 x 756)
// K12 reads its rows once and writes as many floats (3.8 MB and 3.6 MB)
// and does 4 operations per weight and row (forward and backward): 0.22 and
// 0.13 GFLOP, so the bound is operations on both (~3.3 and ~2.0 us).
//
// Design, simple first: K11's tile (kTrainTileRows rows on kTrainThreads
// threads, activations and cotangents in shared memory, weights through the
// read-only cache); the input's cotangent goes straight to device memory.

#include "mlp_tile.cuh"

namespace {

__global__ void __launch_bounds__(kTrainThreads)
input_grad_kernel(const float* __restrict__ x, const float* __restrict__ params, const __grid_constant__ TrainShape s,
                  int n, float* __restrict__ out) {
  extern __shared__ float sm[];
  const TileLayout t = tile_layout(s);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTrainTileRows;
  const int rows = min(kTrainTileRows, static_cast<int>(n - row0));
  const int L = s.n_layers;
  const int d = s.widths[0];
  tile_load(x, row0, rows, d, sm + t.act[0]);
  __syncthreads();
  tile_forward(s, params, sm, t, rows);
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx, e0, e1, tot;
    softmax2(sm + t.act[L] + r * 2, mx, e0, e1, tot);
    const float p0 = __fdiv_rn(e0, tot);
    const float p1 = __fdiv_rn(e1, tot);
    float* ct = sm + t.ct[L] + r * 2;
    ct[0] = __fmul_rn(p0, __fsub_rn(1.0f, p0));
    ct[1] = __fmul_rn(p0, __fsub_rn(0.0f, p1));
  }
  __syncthreads();
  for (int l = L; l >= 1; --l) {
    const int in = s.widths[l - 1], out_w = s.widths[l];
    float* dst = l > 1 ? sm + t.ct[l - 1] : out + row0 * d;
    tile_backprop(params + s.w_off[l - 1], in, out_w, sm + t.ct[l], sm + t.act[l - 1], l > 1, rows, dst);
    __syncthreads();
  }
}

LaunchCache& input_grad_cache() {
  static LaunchCache cache;
  return cache;
}

}  // namespace

cudaError_t launch_input_grad(const float* x, const float* params, const TrainShape& shape, int n,
                              float* out, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = train_tile_smem_bytes(shape);
  if (n < 0 || smem == 0) return cudaErrorInvalidValue;
  const int n_tiles = (n + kTrainTileRows - 1) / kTrainTileRows;
  cudaError_t err = input_grad_cache().prepare(reinterpret_cast<const void*>(&input_grad_kernel), kTrainThreads,
                                               smem, nullptr);
  if (err != cudaSuccess) return err;
  input_grad_kernel<<<n_tiles, kTrainThreads, smem, stream>>>(x, params, shape, n, out);
  return cudaGetLastError();
}
