// Plain C interface of the port's kernels, loaded from Python with ctypes.
//
// Pointers are device addresses (torch.Tensor.data_ptr()), the stream is
// torch.cuda.current_stream().cuda_stream. Each function returns a
// cudaError_t as int: 0 on a successful launch; moeva_error_string names any
// other value. The Python wrappers check device, dtype, shape and
// contiguity before calling.

#include <cuda_runtime.h>

#include "csrc/kernels.h"

extern "C" {

int moeva_nd_peel_f32(const void* f, void* ranks, int n_states, int m,
                      int n_stop, void* stream) {
  return static_cast<int>(launch_nd_peel(
      static_cast<const float*>(f), static_cast<int32_t*>(ranks), n_states, m,
      n_stop, static_cast<cudaStream_t>(stream)));
}

int moeva_associate_f32(const void* f, const void* dirs, const void* ideal,
                        const void* nadir, void* niche, void* dist,
                        int n_states, int m, int r, void* stream) {
  return static_cast<int>(launch_associate(
      static_cast<const float*>(f), static_cast<const float*>(dirs),
      static_cast<const float*>(ideal), static_cast<const float*>(nadir),
      static_cast<int64_t*>(niche), static_cast<float*>(dist), n_states, m, r,
      static_cast<cudaStream_t>(stream)));
}

int moeva_nd_peel_max_candidates() { return kNdPeelMaxCandidates; }

const char* moeva_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
