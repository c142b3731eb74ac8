// Launchers of the port's hand-written Hopper kernels (one per .cu file).
// Each enqueues its kernel on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Largest candidate count per state nd_peel takes: the domination bitset of
// M rows of ceil(M/32) words must fit one block's shared memory.
constexpr int kNdPeelMaxCandidates = 1024;

cudaError_t launch_nd_peel(const float* f, int32_t* ranks, int n_states,
                           int m, int n_stop, cudaStream_t stream);

cudaError_t launch_associate(const float* f, const float* dirs,
                             const float* ideal, const float* nadir,
                             int64_t* niche, float* dist, int n_states, int m,
                             int r, cudaStream_t stream);
