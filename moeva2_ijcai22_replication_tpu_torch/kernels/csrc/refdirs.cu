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
// instructions) over n_iter steps. Latency floor: the steps are a chain,
// and each step's longest path is the softmax, a weight's d2 and pow, the
// n dependent additions of a point's ordered sum over j, Adam's divisions
// and square root, and the barriers (chip_smoke.py's refdirs_floor_ms).
//
// Design: a cluster of up to 16 CTAs (8 where the card cannot hold 16 at
// once) of 1024 threads; CTA c owns `rows` consecutive points, keeps their
// theta and Adam moments in shared memory (a thread a point) and holds z of
// every point, double-buffered by the step's parity. A step:
//   - the weights w_ij of the CTA's points i against every j, over all
//     1024 threads (d2 and pow a pair), into a tile (j, i) in shared
//     memory: `tile` values of j at a time, so 1024 points fit;
//   - the n * D ordered sums, a thread each (point, dimension), each adding
//     w_ij * (z_i[k] - z_j[k]) for j = 0, 1, ... from the tile (consecutive
//     threads read consecutive points' weights, z_j is a broadcast);
//   - a thread a point: the gradient, the softmax backward, Adam (the
//     step's schedule read into shared memory beside the weights), the new
//     softmax, written into every CTA's other z buffer through distributed
//     shared memory, a point's z padded to 4 values for 3 dimensions so
//     that it is two 16-byte stores a CTA;
//   - one cluster barrier (release / acquire), about 1570 cycles at 16 CTAs
//     (PERF.md).
// Both orders of a pair compute their own pow: d2_ij and d2_ji are the
// same bits (fl(a - b) = -fl(b - a)), so one pow a pair would do, but at
// this spread a step's pows are one to a few per thread, and handing a
// pair's weight to its other owner needs a second cluster barrier a step.
// Fixed sum orders, no atomics and no shuffle trees, so the result is the
// twin's.

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>

#include "kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
// the weight tile's budget in shared memory
constexpr size_t kTileBytes = 96 * 1024;

// A launch: the cluster's CTAs (the grid), each CTA's points, the points j
// of a weight tile, and the dynamic shared memory of a CTA.
struct Plan {
  int cluster, rows, tile;
  size_t smem;
};

// A point's z in the z buffers: D values, padded to 4 for 3 dimensions so
// that a point is one or two 16-byte stores
template <int D>
__host__ __device__ constexpr int z_stride() {
  return D == 3 ? 4 : D;
}

// z = softmax(th) over D values: e = exp(th - max), each divided by the
// left-to-right sum of e
template <int D>
__device__ __forceinline__ void softmax(const double* th, double* z) {
  double mx = th[0];
#pragma unroll
  for (int k = 1; k < D; ++k) mx = fmax(mx, th[k]);
  double tot = 0.0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    z[k] = exp(__dsub_rn(th[k], mx));
    tot = k == 0 ? z[0] : __dadd_rn(tot, z[k]);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) z[k] = __ddiv_rn(z[k], tot);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
refdirs_kernel(const double* __restrict__ theta0, const double* __restrict__ sched,
               double* __restrict__ out, int n, int n_iter, int rows, int tile, double expo, double coef,
               double c1, double b1, double c2, double b2, double eps) {
  extern __shared__ __align__(16) double sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int size = static_cast<int>(cl.num_blocks());
  const int row0 = static_cast<int>(cl.block_rank()) * rows;
  const int own = max(0, min(rows, n - row0));  // this CTA's points
  constexpr int kZ = z_stride<D>();
  double* zb = sm;                               // (2, n, kZ): z by the step's parity
  double* wt = zb + 2 * n * kZ;                  // (tile, rows): w_ij at [j - j0][i - row0]
  double* th = wt + tile * rows;                 // (rows, D) theta, then Adam's moments
  double* mu = th + rows * D;
  double* nu = mu + rows * D;
  double* acc_s = nu + rows * D;                 // (rows, D) the step's sums
  double* sched_s = acc_s + rows * D;            // (3,) the step's schedule
  const int tid = threadIdx.x;

  // the softmax of own point r, into every CTA's z buffer b, or into `out`
  // after the last step
  auto publish = [&](int r, int b, bool last) {
    double z[kZ] = {};
    softmax<D>(th + r * D, z);
    const int i = row0 + r;
    if (last) {
#pragma unroll
      for (int k = 0; k < D; ++k) out[i * D + k] = z[k];
      return;
    }
    for (int q = 0; q < size; ++q) {
      double* peer = cl.map_shared_rank(zb + b * n * kZ, q) + i * kZ;
      if constexpr (kZ == 1) {
        *peer = z[0];
      } else {
#pragma unroll
        for (int k = 0; k < kZ; k += 2) *reinterpret_cast<double2*>(peer + k) = make_double2(z[k], z[k + 1]);
      }
    }
  };

  if (tid < own) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      th[tid * D + k] = theta0[(row0 + tid) * D + k];
      mu[tid * D + k] = 0.0;
      nu[tid * D + k] = 0.0;
    }
  }
  cl.sync();  // every CTA runs before any writes into its shared memory
  if (tid < own) publish(tid, 0, n_iter == 0);
  cl.sync();

  // thread (k, r) runs the ordered sum of point row0 + r, dimension k
  const bool chain = tid < own * D;
  const int cr = chain ? tid % own : 0;
  const int ck = chain ? tid / own : 0;
  for (int step = 0; step < n_iter; ++step) {
    // the step's schedule, read beside the weights (the last threads'
    // loads: the first ones have the most weights)
    if (tid >= kThreads - 3) sched_s[tid - (kThreads - 3)] = sched[3 * step + tid - (kThreads - 3)];
    const double* z = zb + (step & 1) * n * kZ;
    const double zik = chain ? z[(row0 + cr) * kZ + ck] : 0.0;
    double acc = 0.0;
    for (int j0 = 0; j0 < n; j0 += tile) {
      const int tn = min(tile, n - j0);
      for (int q = tid; q < tn * own; q += kThreads) {
        const int jj = q / own;
        const int r = q - jj * own;
        const int i = row0 + r, j = j0 + jj;
        double d2 = 0.0;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const double diff = __dsub_rn(z[i * kZ + k], z[j * kZ + k]);
          const double sq = __dmul_rn(diff, diff);
          d2 = k == 0 ? sq : __dadd_rn(d2, sq);
        }
        wt[jj * rows + r] = i == j ? 0.0 : pow(d2, expo);
      }
      __syncthreads();
      if (chain) {
        for (int jj = 0; jj < tn; ++jj) {
          const double t = __dmul_rn(wt[jj * rows + cr], __dsub_rn(zik, z[(j0 + jj) * kZ + ck]));
          acc = j0 + jj == 0 ? t : __dadd_rn(acc, t);
        }
        if (j0 + tn == n) acc_s[cr * D + ck] = acc;
      }
      __syncthreads();
    }
    if (tid < own) {
      const double* zi = z + (row0 + tid) * kZ;
      double* a = acc_s + tid * D;
      double g[D], dot = 0.0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        g[k] = __dmul_rn(coef, a[k]);
        const double t = __dmul_rn(zi[k], g[k]);
        dot = k == 0 ? t : __dadd_rn(dot, t);
      }
      const double lr = sched_s[0], bc1 = sched_s[1], bc2 = sched_s[2];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const int e = tid * D + k;
        const double gt = __dmul_rn(zi[k], __dsub_rn(g[k], dot));
        mu[e] = __dadd_rn(__dmul_rn(c1, gt), __dmul_rn(b1, mu[e]));
        nu[e] = __dadd_rn(__dmul_rn(c2, __dmul_rn(gt, gt)), __dmul_rn(b2, nu[e]));
        const double mu_hat = __ddiv_rn(mu[e], bc1);
        const double nu_hat = __ddiv_rn(nu[e], bc2);
        const double u = __ddiv_rn(mu_hat, __dadd_rn(__dsqrt_rn(nu_hat), eps));
        th[e] = __dsub_rn(th[e], __dmul_rn(lr, u));
      }
      publish(tid, (step + 1) & 1, step == n_iter - 1);
    }
    cl.sync();
  }
}

template <int D>
const void* kernel_of() {
  return reinterpret_cast<const void*>(refdirs_kernel<D>);
}

// The largest cluster of refdirs_kernel<D> the current device holds at
// once: 16 CTAs where it can, else the portable 8; asked once per device.
template <int D>
cudaError_t max_cluster(LaunchCache& cache, int* out) {
  static std::mutex mu;
  static int known[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (known[device] == 0) {
    constexpr size_t kProbeSmem = kMaxSharedBytes;
    err = cache.prepare(kernel_of<D>(), kThreads, kProbeSmem, nullptr);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel_of<D>(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kMaxCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kProbeSmem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel_of<D>(), &cfg);
    if (err != cudaSuccess) return err;
    known[device] = clusters > 0 ? kMaxCluster : kPortableCluster;
  }
  *out = known[device];
  return cudaSuccess;
}

// Plans refdirs_kernel<D> for n points: rows = ceil(n / the largest
// cluster), the smallest power-of-two cluster that covers n (a CTA past the
// points holds none), the tile as many j as kTileBytes holds.
template <int D>
cudaError_t plan(LaunchCache& cache, int n, Plan* p) {
  int cmax = 0;
  const cudaError_t err = max_cluster<D>(cache, &cmax);
  if (err != cudaSuccess) return err;
  p->rows = (n + cmax - 1) / cmax;
  p->cluster = cmax;
  while (p->cluster > 1 && (p->cluster / 2) * p->rows >= n) p->cluster /= 2;
  p->tile = static_cast<int>(std::min<size_t>(n, kTileBytes / (sizeof(double) * p->rows)));
  p->smem = sizeof(double) * (2 * static_cast<size_t>(n) * z_stride<D>() + static_cast<size_t>(p->tile) * p->rows +
                              4 * static_cast<size_t>(p->rows) * D + 3);
  return cudaSuccess;
}

template <int D>
LaunchCache& cache_of() {
  static LaunchCache cache;
  return cache;
}

// Launches refdirs_kernel<D> for the smallest D >= n_dim that equals it.
template <int D>
cudaError_t launch_dims(const double* theta0, const double* sched, double* out, int n, int n_dim, int n_iter,
                        double s, const RefdirsAdam& adam, cudaStream_t stream) {
  if constexpr (D < kRefdirsMaxDim) {
    if (n_dim > D) return launch_dims<D + 1>(theta0, sched, out, n, n_dim, n_iter, s, adam, stream);
  }
  LaunchCache& cache = cache_of<D>();
  Plan p;
  cudaError_t err = plan<D>(cache, n, &p);
  if (err != cudaSuccess) return err;
  err = cache.prepare(kernel_of<D>(), kThreads, p.smem, nullptr);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, refdirs_kernel<D>, theta0, sched, out, n, n_iter, p.rows, p.tile,
                           -s / 2.0 - 1.0, -2.0 * s, adam.c1, adam.b1, adam.c2, adam.b2, adam.eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t shape_dims(int n, int n_dim, int* out) {
  if constexpr (D < kRefdirsMaxDim) {
    if (n_dim > D) return shape_dims<D + 1>(n, n_dim, out);
  }
  Plan p;
  const cudaError_t err = plan<D>(cache_of<D>(), n, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.cluster;
  out[1] = p.rows;
  out[2] = p.tile;
  out[3] = kThreads;
  out[4] = static_cast<int>(p.smem);
  return cudaSuccess;
}

bool args_ok(int n, int n_dim) {
  return n >= 2 && n <= kRefdirsMaxPoints && n_dim >= 1 && n_dim <= kRefdirsMaxDim;
}

}  // namespace

cudaError_t launch_refdirs(const double* theta0, const double* sched, double* out, int n, int n_dim, int n_iter,
                           double s, const RefdirsAdam& adam, cudaStream_t stream) {
  if (!args_ok(n, n_dim) || n_iter < 0) return cudaErrorInvalidValue;
  return launch_dims<1>(theta0, sched, out, n, n_dim, n_iter, s, adam, stream);
}

cudaError_t refdirs_shape(int n, int n_dim, int* out) {
  if (!args_ok(n, n_dim)) return cudaErrorInvalidValue;
  return shape_dims<1>(n, n_dim, out);
}
