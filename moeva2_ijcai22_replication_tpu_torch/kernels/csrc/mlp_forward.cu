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
// stack's multiply-adds (2 * params a row). Latency: a row's longest path
// is its units' sums, one add per input of each layer (159 at LCLD's
// 47-64-32-16-2), far below a launch.
//
// Design: a CTA of kThreads threads takes a tile of kTileRows rows. It
// stages the weights in shared memory transposed, k-major ([k][o] at an odd
// stride), with cp.async: where the whole stack fits kResidentBytes beside
// the tile (LCLD's, in both types), every layer at once before the first;
// else layer by layer, `kc` inputs k at a time (botnet's first layer in
// chunks), the first layer's chunks with the tile's input columns, into two
// buffers: the next chunk is copied while this one is summed (in turns on
// the H100 the labels took 0.0098 ms against 0.0113 single-buffered at
// LCLD's stack, 0.0451 against 0.0500 at botnet's; PERF.md). The
// tile's inputs and activations lie k-major too ([k][row]), in two buffers
// between layers. A thread takes a unit o for a group of kGroupRows rows:
// per k it reads w[k][o] (the warp's lanes read consecutive units, no bank
// conflict) and the group's kGroupRows inputs in one vector load (a
// broadcast), and carries each row's sum over k in order; between chunks
// the partial sums wait in the layer's output buffer, so each sum keeps
// the plain order. Thread r < rows then takes row r's head.

#include <algorithm>

#include "kernels.h"
#include "pgd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;
constexpr int kGroupRows = 4;

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

// A group's kGroupRows values of one k, loaded and stored as vectors
// (float4; two double2), kept in registers.
__device__ __forceinline__ void load_group(const float* p, float (&v)[kGroupRows]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load_group(const double* p, double (&v)[kGroupRows]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
}

__device__ __forceinline__ void store_group(float* p, const float (&v)[kGroupRows]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_group(double* p, const double (&v)[kGroupRows]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An odd stride for a layer's weights at [k][o] (`out` of them a k), so
// that the transposing copies fall in other banks.
__host__ __device__ inline int odd(int w) { return w | 1; }

// A launch's shared-memory layout, in elements: per layer the inputs k of
// a weight chunk, the offset of its weights in the weight region where the
// stack is resident, and of its parameters in the flat buffer; a weight
// buffer and an input-tile buffer (kc[0] inputs; two of each where the
// chunks are double-buffered), the activations (the widest layer's
// outputs, two buffers), all k-major.
struct Tiling {
  int kc[kForwardMaxLayers];
  int w_off[kForwardMaxLayers];
  int64_t p_off[kForwardMaxLayers];
  int w_elems, x_elems, act_elems, resident;
};

template <typename T>
Tiling tiling(const ForwardShape& s) {
  constexpr size_t kResidentBytes = 96 * 1024;
  constexpr size_t kChunkBytes = sizeof(T) == 4 ? 16 * 1024 : 32 * 1024;
  Tiling t{};
  int widest = 1, all = 0;
  int64_t params = 0;
  for (int l = 0; l < s.n_layers; ++l) {
    t.w_off[l] = all;
    t.p_off[l] = params;
    all += s.widths[l] * odd(s.widths[l + 1]);
    params += static_cast<int64_t>(s.widths[l]) * s.widths[l + 1] + s.widths[l + 1];
    widest = std::max(widest, s.widths[l + 1]);
  }
  t.act_elems = kTileRows * widest;
  const size_t resident = sizeof(T) * (static_cast<size_t>(all) + kTileRows * (s.widths[0] + 2 * widest));
  t.resident = resident <= kResidentBytes;
  for (int l = 0; l < s.n_layers; ++l) {
    const int in = s.widths[l], ldw = odd(s.widths[l + 1]);
    t.kc[l] = t.resident ? in
                         : static_cast<int>(std::max<size_t>(1, std::min<size_t>(in, kChunkBytes / (sizeof(T) * ldw))));
    if (!t.resident) {
      t.w_off[l] = 0;
      t.w_elems = std::max(t.w_elems, t.kc[l] * ldw);
    }
  }
  if (t.resident) t.w_elems = all;
  t.w_elems = (t.w_elems + kGroupRows - 1) / kGroupRows * kGroupRows;  // the vectors after it aligned
  t.x_elems = kTileRows * t.kc[0];
  return t;
}

// Weight and input-tile buffers: one where the stack is resident, else two
template <typename T>
size_t smem_bytes(const Tiling& t) {
  const size_t bufs = t.resident ? 1 : 2;
  return sizeof(T) * (bufs * (static_cast<size_t>(t.w_elems) + t.x_elems) + 2 * t.act_elems);
}

// Layer l's weights for inputs [k0, k0 + kn) into dst at [k - k0][o]
template <typename T>
__device__ __forceinline__ void stage_weights(T* dst, const T* __restrict__ w, int in, int out, int k0, int kn) {
  const int ldw = odd(out);
  for (int e = threadIdx.x; e < out * kn; e += kThreads) {
    const int o = e / kn, kk = e - o * kn;
    copy_async(dst + kk * ldw + o, w + static_cast<int64_t>(o) * in + k0 + kk);
  }
}

// The tile's inputs [k0, k0 + kn) into dst at [k - k0][r], 0 past the rows
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ x, int in, int64_t row0, int rows, int k0,
                                           int kn) {
  for (int e = threadIdx.x; e < kTileRows * kn; e += kThreads) {
    const int kk = e / kTileRows, r = e - kk * kTileRows;
    if (r < rows) {
      copy_async(dst + e, x + (row0 + r) * in + k0 + kk);
    } else {
      dst[e] = T(0);
    }
  }
}

template <typename T, bool kLabels>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const T* __restrict__ x, const T* __restrict__ params, ForwardShape s, Tiling tl, int n,
               int64_t* __restrict__ labels, T* __restrict__ proba1) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int bufs = tl.resident ? 1 : 2;
  T* wt = reinterpret_cast<T*>(smem_raw);  // (bufs, w_elems): the weights (resident: every layer's), k-major
  T* xin = wt + bufs * tl.w_elems;         // (bufs, kc[0], kTileRows): the tile's inputs of the chunk
  T* act0 = xin + bufs * tl.x_elems;       // (2, widest, kTileRows): the layers' outputs
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int rows = n - row0 < kTileRows ? static_cast<int>(n - row0) : kTileRows;
  // the staging: every layer at once, or the first chunk into buffer 0
  for (int l = 0; l < (tl.resident ? s.n_layers : 1); ++l) {
    const int in = s.widths[l];
    stage_weights(wt + tl.w_off[l], params + tl.p_off[l], in, s.widths[l + 1], 0, tl.kc[l]);
    if (l == 0) stage_rows(xin, x, in, row0, rows, 0, tl.kc[0]);
  }
  const T* a = xin;
  int buf = 0;
  for (int l = 0; l < s.n_layers; ++l) {
    const int in = s.widths[l], out = s.widths[l + 1], ldw = odd(out), kc = tl.kc[l];
    const T* __restrict__ b = params + tl.p_off[l] + static_cast<int64_t>(in) * out;
    T* z = act0 + (l & 1) * tl.act_elems;
    const bool hidden = l < s.n_layers - 1;
    const int items = kTileRows / kGroupRows * out;
    for (int k0 = 0; k0 < in; k0 += kc) {
      const int kn = min(kc, in - k0);
      copy_wait_all();
      __syncthreads();  // this chunk staged, the previous one's (and layer's) compute done
      if (!tl.resident) {  // the next chunk, of this layer or the next, into the other buffer
        const int nl = k0 + kc < in ? l : l + 1, nk = nl == l ? k0 + kc : 0;
        if (nl < s.n_layers) {
          const int nin = s.widths[nl];
          stage_weights(wt + (buf ^ 1) * tl.w_elems, params + tl.p_off[nl], nin, s.widths[nl + 1], nk,
                        min(tl.kc[nl], nin - nk));
          if (nl == 0) stage_rows(xin + (buf ^ 1) * tl.x_elems, x, nin, row0, rows, nk, min(tl.kc[0], nin - nk));
        }
      }
      const T* wl = tl.resident ? wt + tl.w_off[l] : wt + buf * tl.w_elems;
      const T* ak = l == 0 ? xin + buf * tl.x_elems : a + k0 * kTileRows;
      const bool last = k0 + kn == in;
      for (int item = tid; item < items; item += kThreads) {
        const int g = item / out, o = item - g * out;
        T* zg = z + o * kTileRows + g * kGroupRows;
        T acc[kGroupRows];
        if (k0 == 0) {
          const T bias = __ldg(b + o);
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) acc[r] = bias;
        } else {
          load_group(zg, acc);
        }
        const T* ag = ak + g * kGroupRows;
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const T wv = wl[kk * ldw + o];
          T av[kGroupRows];
          load_group(ag + kk * kTileRows, av);
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) acc[r] = add_rn(acc[r], mul_rn(av[r], wv));
        }
        if (last && hidden) {
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) acc[r] = relu_nan(acc[r]);
        }
        store_group(zg, acc);
      }
      if (!tl.resident) buf ^= 1;
    }
    a = z;
  }
  __syncthreads();
  if (tid >= rows) return;
  const int classes = s.widths[s.n_layers];
  const T lg[2] = {a[tid], classes > 1 ? a[kTileRows + tid] : T(0)};
  if constexpr (kLabels) {
    labels[row0 + tid] = predicted_class(classes, lg);
  } else {
    proba1[row0 + tid] = proba1_of(classes, lg);
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
  static LaunchCache cache;
  const Tiling tl = tiling<T>(s);
  const size_t smem = smem_bytes<T>(tl);
  const cudaError_t err =
      cache.prepare(reinterpret_cast<const void*>(forward_kernel<T, kLabels>), kThreads, smem, nullptr);
  if (err != cudaSuccess) return err;
  forward_kernel<T, kLabels><<<(n + kTileRows - 1) / kTileRows, kThreads, smem, stream>>>(x, params, s, tl, n,
                                                                                         labels, proba1);
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
