// Run on one H100 from the root of a checkout:
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -o handoff_bench tools/handoff_bench.cu && ./handoff_bench
// Ping-pong between the two CTAs of a cluster: cycles per hand-off for
// several ways to publish writes into the peer's shared memory.
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned smem_u32(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }

struct Flag {  // mode 0: fence + relaxed store / acquire poll; mode 1: release store / relaxed poll + fence
  unsigned* mine; unsigned* peers; unsigned sent = 0, seen = 0; int mode;
  __device__ void signal() {
    __syncthreads(); ++sent;
    if (threadIdx.x == 0) {
      if (mode == 0) {
        asm volatile("fence.acq_rel.cluster;" ::: "memory");
        asm volatile("st.relaxed.cluster.u32 [%0], %1;" ::"l"(peers), "r"(sent) : "memory");
      } else {
        asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(peers), "r"(sent) : "memory");
      }
    }
  }
  __device__ void wait() {
    ++seen;
    if (threadIdx.x == 0) {
      unsigned v;
      if (mode == 0) {
        long long k = 0; do { asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(mine) : "memory"); if (++k > (1ll << 24)) __trap(); } while (v < seen);
      } else {
        long long k = 0; do { asm volatile("ld.relaxed.cluster.u32 %0, [%1];" : "=r"(v) : "l"(mine) : "memory"); if (++k > (1ll << 24)) __trap(); } while (v < seen);
        asm volatile("fence.acq_rel.cluster;" ::: "memory");
      }
    }
    __syncthreads();
  }
};

struct Mbar {  // two mbarriers of one arrival each, used in turn; mode 2: acquire.cluster wait, 3: default wait
  unsigned long long* bars; unsigned peer_rank; unsigned sent = 0, seen = 0; int mode;
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bars + i)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __device__ void signal() {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(bars + (sent & 1))), "r"(peer_rank));
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
    }
    ++sent;
  }
  __device__ void wait() {
    const unsigned addr = smem_u32(bars + (seen & 1));
    const unsigned parity = (seen >> 1) & 1;
    unsigned done = 0;
    for (long long k = 0; !done; ++k) {
      if (k > (1ll << 24)) __trap();
      if (mode == 2)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
      else
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
    ++seen;
  }
};

template <class H>
__device__ void pingpong(H& h, float* sm, float* peer, int n, int per_thread, long long* out) {
  const int rank = cg::this_cluster().block_rank();
  cg::this_cluster().sync();
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (rank == 0) {
      for (int j = 0; j < per_thread; ++j) peer[64 + j * blockDim.x + threadIdx.x] = float(i + j);
      h.signal(); h.wait();
    } else {
      h.wait();
      for (int j = 0; j < per_thread; ++j) peer[64 + j * blockDim.x + threadIdx.x] = float(i + j);
      h.signal();
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
  cg::this_cluster().sync();
}

__global__ void k_flag(long long* out, int n, int per_thread, int mode) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  unsigned* flag = reinterpret_cast<unsigned*>(sm);
  if (threadIdx.x == 0) *flag = 0;
  Flag h{flag, cl.map_shared_rank(flag, cl.block_rank() ^ 1)};
  h.mode = mode;
  pingpong(h, sm, cl.map_shared_rank(sm, cl.block_rank() ^ 1), n, per_thread, out);
}

__global__ void k_mbar(long long* out, int n, int per_thread, int mode) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  Mbar h{reinterpret_cast<unsigned long long*>(sm), cl.block_rank() ^ 1};
  h.mode = mode;
  h.init();
  pingpong(h, sm, cl.map_shared_rank(sm, cl.block_rank() ^ 1), n, per_thread, out);
}

// a poll that finds the flag set: the cost of the wait alone, and of the fence alone
__global__ void k_costs(long long* out, int n) {
  extern __shared__ float sm[];
  unsigned* flag = reinterpret_cast<unsigned*>(sm);
  if (threadIdx.x == 0) *flag = 1;
  __syncthreads();
  long long t0 = clock64();
  unsigned v = 0, acc = 0;
  for (int i = 0; i < n; ++i) { asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory"); acc += v; }
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  long long t2 = clock64();
  for (int i = 0; i < n; ++i) { asm volatile("ld.relaxed.cluster.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory"); acc += v; }
  long long t3 = clock64();
  if (threadIdx.x == 0) { out[3 * blockIdx.x] = t1 - t0; out[3 * blockIdx.x + 1] = t2 - t1; out[3 * blockIdx.x + 2] = t3 - t2 + (acc == 12345); }
}

template <typename K, typename... A>
cudaError_t launch(K kern, int grid, int threads, size_t smem, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid); cfg.blockDim = dim3(threads); cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 2; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  cfg.attrs = at; cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

int main() {
  const int threads = 384, grid = 130, n = 4000;
  const size_t smem = 220000;
  for (auto f : {(void*)k_flag, (void*)k_mbar, (void*)k_costs})
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  long long* d; cudaMalloc(&d, 4096 * 8);
  long long h[512];
  auto report = [&](const char* what, cudaError_t e, double div) {
    cudaError_t s = cudaDeviceSynchronize();
    cudaMemcpy(h, d, sizeof(long long) * grid, cudaMemcpyDeviceToHost);
    double mean = 0; for (int i = 0; i < grid; ++i) mean += h[i];
    printf("%s: launch %s, run %s: %.1f cycles per hand-off\n", what, cudaGetErrorString(e), cudaGetErrorString(s), mean / grid / div);
  };
  const char* names[4] = {"flag: fence + relaxed store, acquire poll", "flag: release store, relaxed poll + fence",
                          "mbarrier: remote arrive.release.cluster, try_wait.acquire.cluster", "mbarrier: remote arrive.release.cluster, try_wait (cta)"};
  for (int rep = 0; rep < 2; ++rep)
    for (int pt : {0, 6}) {
      for (int mode = 0; mode < 2; ++mode) {
        char w[160]; snprintf(w, sizeof w, "%s, %d B of stores", names[mode], pt * threads * 4);
        report(w, launch(k_flag, grid, threads, smem, d, n, pt, mode), 2.0 * n);
      }
      for (int mode = 2; mode < 4; ++mode) {
        char w[160]; snprintf(w, sizeof w, "%s, %d B of stores", names[mode], pt * threads * 4);
        report(w, launch(k_mbar, grid, threads, smem, d, n, pt, mode), 2.0 * n);
      }
    }
  cudaError_t e = launch(k_costs, grid, threads, smem, d, 1000);
  cudaError_t s = cudaDeviceSynchronize();
  cudaMemcpy(h, d, sizeof(long long) * 3 * grid, cudaMemcpyDeviceToHost);
  double a = 0, b = 0, c = 0; for (int i = 0; i < grid; ++i) { a += h[3 * i]; b += h[3 * i + 1]; c += h[3 * i + 2]; }
  printf("costs (%s, %s): ld.acquire.cluster %.1f, fence.acq_rel.cluster %.1f, ld.relaxed.cluster %.1f cycles each\n",
         cudaGetErrorString(e), cudaGetErrorString(s), a / grid / 1000, b / grid / 1000, c / grid / 1000);
  return 0;
}
