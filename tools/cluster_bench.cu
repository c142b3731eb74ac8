// Run on one H100 from the root of a checkout:
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -o cluster_bench tools/cluster_bench.cu && ./cluster_bench
// What a 2-CTA cluster costs on the card: resident clusters at K7b's
// planned shared memory, the cycles of a cluster barrier, of one with 9 KB
// of remote stores before it, and of a dependent chain over remote words.
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void k_sync(long long* out, int n) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
__global__ void k_block(long long* out, int n) {
  extern __shared__ float sm[];
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
__global__ void k_split(long long* out, int n) {
  extern __shared__ float sm[];
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
__global__ void k_store(long long* out, int n, int per_thread) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  float* peer = cl.map_shared_rank(sm, cl.block_rank() ^ 1);
  cl.sync();
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < per_thread; ++j) peer[j * blockDim.x + threadIdx.x] = float(i + j);
    cl.sync();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
__global__ void k_chain(long long* out, int n, float* sink) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  for (int k = threadIdx.x; k < 4096; k += blockDim.x) sm[k] = 1e-3f * k;
  cl.sync();
  const float* peer = cl.map_shared_rank(sm, cl.block_rank() ^ 1);
  float acc = 0.f;
  long long t0 = clock64();
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < 378; ++k) acc = __fadd_rn(acc, peer[k]);
  }
  long long t1 = clock64();
  float acc2 = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < 378; ++k) acc2 = __fadd_rn(acc2, sm[k]);
  }
  long long t2 = clock64();
  if (threadIdx.x == 0) { out[2 * blockIdx.x] = t1 - t0; out[2 * blockIdx.x + 1] = t2 - t1; sink[blockIdx.x] = acc + acc2; }
  cl.sync();
}

template <typename K, typename... A>
cudaError_t launch(K kern, int grid, int threads, size_t smem, int cluster, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

int main() {
  const int threads = 384;
  const size_t smems[] = {98304, 200000, 220928, 226000, 232448};
  for (size_t smem : smems) {
    cudaFuncSetAttribute(k_sync, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(132);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = 2; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    cfg.attrs = at; cfg.numAttrs = 1;
    int nc = -1;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&nc, (void*)k_sync, &cfg);
    printf("occupancy: smem %zu threads %d cluster 2: %d clusters (%s)\n", smem, threads, nc, cudaGetErrorString(e));
  }
  const size_t smem = 220928;
  for (auto f : {(void*)k_sync, (void*)k_block, (void*)k_split, (void*)k_store, (void*)k_chain})
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  long long* d; float* sink; cudaMalloc(&d, 1024 * 8); cudaMalloc(&sink, 1024 * 4);
  long long h[264];
  const int n = 10000, grid = 130;
  auto report = [&](const char* what, cudaError_t e, int reps, int per) {
    cudaError_t s = cudaDeviceSynchronize();
    cudaMemcpy(h, d, sizeof(long long) * grid * per, cudaMemcpyDeviceToHost);
    double mx = 0, mean = 0;
    for (int i = 0; i < grid; ++i) { mean += h[i * per]; if (h[i * per] > mx) mx = h[i * per]; }
    printf("%s: launch %s, run %s: cycles per step mean %.1f max %.1f", what, cudaGetErrorString(e), cudaGetErrorString(s), mean / grid / reps, mx / reps);
    if (per == 2) { double m2 = 0; for (int i = 0; i < grid; ++i) m2 += h[2 * i + 1]; printf("; local chain %.1f", m2 / grid / reps); }
    printf("\n");
  };
  for (int rep = 0; rep < 2; ++rep) {
    report("__syncthreads (cluster launch)", launch(k_block, grid, threads, smem, 2, d, n), n, 1);
    report("cluster.sync()", launch(k_sync, grid, threads, smem, 2, d, n), n, 1);
    report("barrier.cluster arrive.release + wait.acquire", launch(k_split, grid, threads, smem, 2, d, n), n, 1);
    for (int pt : {1, 6, 12}) {
      char what[96]; snprintf(what, sizeof what, "%d B of remote stores per CTA + cluster.sync()", pt * threads * 4);
      report(what, launch(k_store, grid, threads, smem, 2, d, 2000, pt), 2000, 1);
    }
    report("chain of 378 dependent adds over remote words", launch(k_chain, grid, threads, smem, 2, d, 100, sink), 100, 2);
  }
  return 0;
}
