// K14: the reference directions' energy descent, every step in one launch.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/
// moeva/refdirs.py::energy_ref_dirs's `run` (a jitted lax.scan of n_iter
// optax Adam steps on the Riesz s-energy of softmax(theta); the repo has no
// Pallas kernel for it), which the port ran on the host in float64 eager
// autograd before every engine's first launch.
//
// Semantics (must equal attacks/moeva/refdirs.py::energy_descent_plain bit
// for bit): per step, z = softmax(theta) (e = exp(theta - max), divided by
// their left-to-right sum); point i's energy gradient -2s * sum_j w_ij (z_i
// - z_j) with w_ij = pow(d2_ij, -s/2 - 1), 0 for j = i, d2_ij summed over
// the dimensions from 0 and the sum over j from 0; the softmax backward z *
// (g - <z, g>); optax's Adam with the step's learning rate and bias
// corrections read from `sched` (computed on the host). Every operation is
// one rounded float64 operation (__dadd_rn / __dmul_rn, so nvcc cannot
// contract them into FMAs); exp and pow are the CUDA math library's, which
// PyTorch's own kernels call too.
//
// Bound: operations. n^2 float64 pow a step (each some tens of fp64
// instructions) over n_iter steps, on one SM: the descent is a chain of
// n_iter dependent steps over a few hundred points, too little to spread
// over the card. Bytes are a few kilobytes.
//
// Design: one CTA runs every step, one thread a point; theta and Adam's
// moments stay in the thread's registers (one instantiation per dimension
// count, so every per-dimension array is indexed by constants), z in
// shared memory for the sum over j. Two barriers a step: after z is written and after it is read.
// Fixed sum orders, no atomics and no shuffle trees, so the result is the
// twin's.

#include "kernels.h"

namespace {

template <int D>
__global__ void __launch_bounds__(kRefdirsMaxPoints)
refdirs_kernel(const double* __restrict__ theta0, const double* __restrict__ sched,
               double* __restrict__ out, int n, int n_iter, double expo, double coef,
               double c1, double b1, double c2, double b2, double eps) {
  constexpr int n_dim = D;
  extern __shared__ double zs[];  // (n, D)
  const int i = threadIdx.x;
  const bool active = i < n;
  double th[D], mu[D], nu[D], zi[D];
#pragma unroll
  for (int k = 0; k < n_dim; ++k) {
    th[k] = active ? theta0[i * n_dim + k] : 0.0;
    mu[k] = 0.0;
    nu[k] = 0.0;
  }

  // z_i = softmax(th) into zi and row i of zs
  auto softmax = [&]() {
    double mx = th[0];
#pragma unroll
    for (int k = 1; k < n_dim; ++k) mx = fmax(mx, th[k]);
    double tot = 0.0;
#pragma unroll
    for (int k = 0; k < n_dim; ++k) {
      zi[k] = exp(__dsub_rn(th[k], mx));
      tot = k == 0 ? zi[0] : __dadd_rn(tot, zi[k]);
    }
#pragma unroll
    for (int k = 0; k < n_dim; ++k) zi[k] = __ddiv_rn(zi[k], tot);
  };

  for (int step = 0; step < n_iter; ++step) {
    if (active) {
      softmax();
#pragma unroll
      for (int k = 0; k < n_dim; ++k) zs[i * n_dim + k] = zi[k];
    }
    __syncthreads();
    if (active) {
      double acc[D], diff[D];
      for (int j = 0; j < n; ++j) {
        const double* zj = zs + j * n_dim;
        double d2 = 0.0;
#pragma unroll
        for (int k = 0; k < n_dim; ++k) {
          diff[k] = __dsub_rn(zi[k], zj[k]);
          const double sq = __dmul_rn(diff[k], diff[k]);
          d2 = k == 0 ? sq : __dadd_rn(d2, sq);
        }
        const double w = j == i ? 0.0 : pow(d2, expo);
#pragma unroll
        for (int k = 0; k < n_dim; ++k) {
          const double t = __dmul_rn(w, diff[k]);
          acc[k] = j == 0 ? t : __dadd_rn(acc[k], t);
        }
      }
      double g[D], dot = 0.0;
#pragma unroll
      for (int k = 0; k < n_dim; ++k) {
        g[k] = __dmul_rn(coef, acc[k]);
        const double t = __dmul_rn(zi[k], g[k]);
        dot = k == 0 ? t : __dadd_rn(dot, t);
      }
      const double lr = sched[3 * step], bc1 = sched[3 * step + 1], bc2 = sched[3 * step + 2];
#pragma unroll
      for (int k = 0; k < n_dim; ++k) {
        const double gt = __dmul_rn(zi[k], __dsub_rn(g[k], dot));
        mu[k] = __dadd_rn(__dmul_rn(c1, gt), __dmul_rn(b1, mu[k]));
        nu[k] = __dadd_rn(__dmul_rn(c2, __dmul_rn(gt, gt)), __dmul_rn(b2, nu[k]));
        const double mu_hat = __ddiv_rn(mu[k], bc1);
        const double nu_hat = __ddiv_rn(nu[k], bc2);
        const double u = __ddiv_rn(mu_hat, __dadd_rn(__dsqrt_rn(nu_hat), eps));
        th[k] = __dsub_rn(th[k], __dmul_rn(lr, u));
      }
    }
    __syncthreads();
  }
  if (active) {
    softmax();
#pragma unroll
    for (int k = 0; k < n_dim; ++k) out[i * n_dim + k] = zi[k];
  }
}

// Launches refdirs_kernel<D> for the smallest D >= n_dim that equals it.
template <int D>
cudaError_t launch_dims(const double* theta0, const double* sched, double* out, int n, int n_dim, int n_iter,
                        double s, const RefdirsAdam& adam, cudaStream_t stream) {
  if constexpr (D < kRefdirsMaxDim) {
    if (n_dim > D) return launch_dims<D + 1>(theta0, sched, out, n, n_dim, n_iter, s, adam, stream);
  }
  const size_t smem = sizeof(double) * n * D;
  static LaunchCache cache;
  const cudaError_t err = cache.prepare(reinterpret_cast<const void*>(refdirs_kernel<D>), kRefdirsMaxPoints,
                                        smem, nullptr);
  if (err != cudaSuccess) return err;
  const int threads = (n + 31) / 32 * 32;
  refdirs_kernel<D><<<1, threads, smem, stream>>>(theta0, sched, out, n, n_iter, -s / 2.0 - 1.0, -2.0 * s,
                                                  adam.c1, adam.b1, adam.c2, adam.b2, adam.eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_refdirs(const double* theta0, const double* sched, double* out, int n, int n_dim, int n_iter,
                           double s, const RefdirsAdam& adam, cudaStream_t stream) {
  if (n < 2 || n > kRefdirsMaxPoints || n_dim < 1 || n_dim > kRefdirsMaxDim || n_iter < 0)
    return cudaErrorInvalidValue;
  return launch_dims<1>(theta0, sched, out, n, n_dim, n_iter, s, adam, stream);
}
