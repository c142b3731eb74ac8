// K8: MoEvA2's objectives on the botnet domain (756 features, 360 gathered
// constraint terms), one block per tile of 32 (state, candidate) rows.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// engine.py::Moeva2._evaluate on the botnet domain, with what it calls:
// core/codec.py::genetic_to_ml and minmax_normalize, the ML scaler,
// models/mlp.py::MLP and softmax, core/norms.py::lp_distance and
// domains/botnet.py::BotnetConstraints._raw (tables from _build_tables)
// thresholded by core/constraints.py::ConstraintSet.evaluate. The repo has no
// Pallas kernel for it.
//
// Semantics: those of attacks/moeva/engine.py::evaluate_plain with
// domains/botnet.py::BotnetConstraints, one rounded float32 operation at a
// time in their order (__fadd_rn / __fmul_rn / __fdiv_rn, so nvcc cannot
// contract them into FMAs), as K1 (objective_lcld.cu) does for LCLD:
// - decode: feature d takes gene feat_gene[d] (feat_onehot[d] < 0), the
//   one-hot bit rintf(gene) == feat_onehot[d], or the initial state's value
//   (feat_gene[d] < 0);
// - f2: the left-to-right sum of squared min-max differences, a correctly
//   rounded sqrtf, over float32(sqrt(D)); L-inf: the NaN-propagating max of
//   the absolute differences;
// - the scaler, then the relu stack: each unit starts from its bias and adds
//   w[k] * a[k] for k = 0, 1, ... in turn; a NaN passes relu;
// - softmax: exp(l - max) in float64 rounded once over the left-to-right
//   sum; a 1-column head gives [1 - p, p] with p = 1 / (1 + exp(-l));
// - g: the terms in BotnetConstraints._raw's order, read through the gather
//   lists (launch arguments, so the real feat_idx.pickle runs through the
//   same kernel): per direction |Σ flows - Σ bytes| (each sum left to
//   right), the bytes/pkts ratios (p != 0 ? b / p : 0) - 1500, then the
//   three orderings lower - upper; each kept where > tol and 0 elsewhere (a
//   NaN term counts 0), summed left to right.
//
// Bound: the relu stack, 756-64-64-32-2, is 54,592 multiply-adds per row on
// ~3 KB of genes: bound by fp32 operations. Tensor cores are not used:
// mma/wgmma sum inside the instruction in an order that no CPU code
// reproduces. Without FMA a multiply-add is two instructions, so the
// kernel's ceiling is half the fp32 peak.
//
// Design (a first, simple kernel; its speed is for a later redesign). The
// rows are flattened into S * N and cut into tiles of 32, one tile per block
// of 256 threads. At 756 features a tile's rows fill 97 KB, so the first
// layer's 194 KB of weights cannot sit beside them: they stream through a
// double buffer in shared memory in chunks of 16 inputs (cp.async, the next
// chunk's copy in flight while the current one is summed), from a transposed
// copy (in, out) so that a chunk is one contiguous run. A block takes
// ~107 KB, so two run on an SM: one's barriers and serial stages overlap
// the other's sums.
// 0. decode: thread t takes row t % 32 and every eighth feature from t / 32
//    and writes the unscaled features, [k][row], to shared memory;
// 1. warp 0 sums its rows' min-max distance, warp 1 their constraint terms,
//    one thread per row, each in the plain version's order;
// 2. the first layer, chunk by chunk: the chunk's scaled inputs are staged
//    beside its weights; a thread owns 4 rows x 2 outputs in registers and
//    runs k in order, one float4 load of its rows' a[k] and one float2 load
//    of its outputs' w[k][o] per step;
// 3. the other layers the same way, in the features' buffer (dead by then),
//    their weights read through the cache from the params (out, in); relu on
//    the write-back;
// 4. warp 0 takes the softmax of its rows.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kTile = 32;                   // rows per block
constexpr int kThreads = 256;
constexpr int kRowGroups = kTile / 4;       // a thread owns 4 rows
constexpr int kChunk = 16;                  // first-layer inputs per staged chunk

__device__ __forceinline__ float relu_if(bool hidden, float x) {
  return hidden && !(x > 0.0f) && !isnan(x) ? 0.0f : x;
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The min-max distance of one row over its d features; x(k) reads feature k
// from column `xcol` of a [k][kTile] buffer, lo/hi/mm are its state's rows.
__device__ __forceinline__ float row_distance(const float* xcol, const float* lo,
                                              const float* hi, const float* mm,
                                              int d, bool norm_inf) {
  float dist = 0.0f;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    const float l = __ldg(lo + k);
    const float rng = __fsub_rn(__ldg(hi + k), l);
    const float diff = __fsub_rn(
        __fdiv_rn(__fsub_rn(xcol[k * kTile], l), rng == 0.0f ? 1.0f : rng), __ldg(mm + k));
    if (norm_inf) {
      dist = k == 0 ? fabsf(diff) : nan_max(dist, fabsf(diff));
    } else {
      const float sq = __fmul_rn(diff, diff);
      dist = k == 0 ? sq : __fadd_rn(dist, sq);
    }
  }
  return norm_inf ? dist : __fsqrt_rn(dist);
}

// The summed botnet violations of one row, the terms in _raw's order through
// the gather lists `idx`: per direction nf flows then nb bytes, nr ratio
// bytes then nr pkts, and per ordering no lower then no upper features.
__device__ __forceinline__ float row_violation(const float* xcol, const int32_t* idx,
                                               const int (&nf)[2], const int (&nb)[2], int nr,
                                               const int (&no)[3], float tol) {
  auto x = [&](int i) { return xcol[__ldg(idx + i) * kTile]; };
  auto keep = [&](float t) { return t > tol ? t : 0.0f; };
  auto sum = [&](int at, int n) {
    float s = x(at);
#pragma unroll 8
    for (int i = 1; i < n; ++i) s = __fadd_rn(s, x(at + i));
    return s;
  };
  int at = 0;
  float g = 0.0f;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const float t = keep(fabsf(__fsub_rn(sum(at, nf[side]), sum(at + nf[side], nb[side]))));
    g = side == 0 ? t : __fadd_rn(g, t);
    at += nf[side] + nb[side];
  }
#pragma unroll 4
  for (int i = 0; i < nr; ++i) {
    const float b = x(at + i);
    const float p = x(at + nr + i);
    g = __fadd_rn(g, keep(__fsub_rn(p != 0.0f ? __fdiv_rn(b, p) : 0.0f, 1500.0f)));
  }
  at += 2 * nr;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
#pragma unroll 8
    for (int i = 0; i < no[o]; ++i) g = __fadd_rn(g, keep(__fsub_rn(x(at + i), x(at + no[o] + i))));
    at += 2 * no[o];
  }
  return g;
}

// acc[i][j] += a[k][row 4rg + i] * w[k][o0 + j] over k < n, in k order; `a`
// points at a [k][kTile] buffer's row group, `w` at w[0][o0] with rows of
// `w_stride` floats (staged) or at the params' w[o0][0] (global, rows of
// `w_stride` = in_w floats, `two` = whether o0 + 1 exists).
template <bool kStaged>
__device__ __forceinline__ void dense_steps(float (&acc)[4][2], const float* __restrict__ a,
                                            const float* __restrict__ w, int w_stride, int n,
                                            bool two) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kTile);
    float w0, w1;
    if constexpr (kStaged) {
      const float2 wv = *reinterpret_cast<const float2*>(w + k * w_stride);
      w0 = wv.x;
      w1 = wv.y;
    } else {
      w0 = __ldg(w + k);
      w1 = two ? __ldg(w + w_stride + k) : 0.0f;
    }
    acc[0][0] = __fadd_rn(acc[0][0], __fmul_rn(av.x, w0));
    acc[1][0] = __fadd_rn(acc[1][0], __fmul_rn(av.y, w0));
    acc[2][0] = __fadd_rn(acc[2][0], __fmul_rn(av.z, w0));
    acc[3][0] = __fadd_rn(acc[3][0], __fmul_rn(av.w, w0));
    acc[0][1] = __fadd_rn(acc[0][1], __fmul_rn(av.x, w1));
    acc[1][1] = __fadd_rn(acc[1][1], __fmul_rn(av.y, w1));
    acc[2][1] = __fadd_rn(acc[2][1], __fmul_rn(av.z, w1));
    acc[3][1] = __fadd_rn(acc[3][1], __fmul_rn(av.w, w1));
  }
}

// Writes outputs o0 (and o0 + 1 where `two`) of 4 rows to h[o][row].
__device__ __forceinline__ void write_back(float* h, const float (&acc)[4][2], int o0, int r,
                                           bool two, bool hidden) {
  for (int j = 0; j < (two ? 2 : 1); ++j) {
    float4 v;
    v.x = relu_if(hidden, acc[0][j]);
    v.y = relu_if(hidden, acc[1][j]);
    v.z = relu_if(hidden, acc[2][j]);
    v.w = relu_if(hidden, acc[3][j]);
    *reinterpret_cast<float4*>(h + (o0 + j) * kTile + r) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
objective_botnet_kernel(const BotnetObjectiveArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = args.d;
  const int h1 = args.widths[1];
  float* xf = reinterpret_cast<float*>(smem);       // (d, kTile) unscaled features
  float* xs = xf + args.xf_floats;                  // (2, kChunk, kTile) the stack's input
  float* wbuf = xs + 2 * kChunk * kTile;            // (2, kChunk, h1) first-layer weights
  float* ha = xf;                                   // after the first layer, two
  float* hb = xf + kBotnetMaxWidth * kTile;         // (kBotnetMaxWidth, kTile) buffers
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int rows = args.n_rows - row0 < kTile ? args.n_rows - row0 : kTile;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  const bool scaled = args.scale != nullptr;

  // the first layer's weights of chunk c into their buffer, as 16-byte
  // copies; the chunk's scaled inputs into theirs
  const float* first_t = args.first_t;
  const float* scale = args.scale;
  const float* offset = args.offset;
  auto chunk_size = [&](int c) { return d - c * kChunk < kChunk ? d - c * kChunk : kChunk; };
  auto stage_weights = [&](int c) {
    const float* src = first_t + static_cast<size_t>(c) * kChunk * h1;
    float* dst = wbuf + (c & 1) * kChunk * h1;
    for (int e = tid; e < chunk_size(c) * h1 / 4; e += kThreads) copy16_async(dst + 4 * e, src + 4 * e);
    copy_commit();
  };
  auto stage_inputs = [&](int c) {
    float* dst = xs + (c & 1) * kChunk * kTile;
    for (int e = tid; e < chunk_size(c) * kTile; e += kThreads) {
      const int k = c * kChunk + e / kTile;
      const float v = xf[c * kChunk * kTile + e];
      dst[e] = scaled ? __fadd_rn(__fmul_rn(v, __ldg(scale + k)), __ldg(offset + k)) : v;
    }
  };
  stage_weights(0);

  // 0. decode this thread's row, every eighth feature
  const int r = tid % kTile;
  const int row = row0 + r;
  const bool valid = r < rows;
  const int s = valid ? row / args.n : 0;
  const size_t so = static_cast<size_t>(s) * d;
  {
    const float* gj = args.x_gen + static_cast<size_t>(valid ? row : 0) * args.l;
#pragma unroll 4
    for (int k = tid / kTile; k < d; k += kThreads / kTile) {
      float v = 0.0f;
      if (valid) {
        const int gene = __ldg(args.feat_gene + k);
        const int slot = __ldg(args.feat_onehot + k);
        const float gv = __ldg(gj + (gene < 0 ? 0 : gene));
        v = gene < 0 ? __ldg(args.x_init + so + k)
            : slot < 0 ? gv
                       : (rintf(gv) == static_cast<float>(slot) ? 1.0f : 0.0f);
      }
      xf[k * kTile + r] = v;
    }
  }
  __syncthreads();

  // 1. the distance (warp 0) and the constraint terms (warp 1), a row each;
  // the others stage the first chunk's inputs
  if (valid && tid < kTile) {
    const float dist = row_distance(xf + r, args.xl + so, args.xu + so, args.x_init_mm + so, d,
                                    args.norm_inf);
    args.out[3 * static_cast<size_t>(row) + 1] = __fdiv_rn(dist, args.f2_scale);
  } else if (valid && tid < 2 * kTile) {
    const int nf[2] = {args.counts[0], args.counts[2]};
    const int nb[2] = {args.counts[1], args.counts[3]};
    const int no[3] = {args.counts[6], args.counts[8], args.counts[10]};
    args.out[3 * static_cast<size_t>(row) + 2] =
        row_violation(xf + r, args.cons, nf, nb, args.counts[4], no, args.tol);
  }
  stage_inputs(0);

  // 2. the first layer, chunk by chunk; this thread's rows 4 rg .. 4 rg + 3
  // and outputs o0, o0 + 1
  const int rg = (tid % kRowGroups) * 4;
  const int o0 = (tid / kRowGroups) * 2;
  float acc[4][2];
  const float* bias = args.params + static_cast<size_t>(h1) * d;
  for (int j = 0; j < 2; ++j) {
    const float b = o0 < h1 ? __ldg(bias + o0 + j) : 0.0f;
    for (int i = 0; i < 4; ++i) acc[i][j] = b;
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_weights(c + 1);
      stage_inputs(c + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (o0 < h1)
      dense_steps<true>(acc, xs + (c & 1) * kChunk * kTile + rg, wbuf + (c & 1) * kChunk * h1 + o0, h1,
                        chunk_size(c), true);
    __syncthreads();
  }
  // the features are dead (warps 0 and 1 passed the barriers above): their
  // buffer takes the activations
  if (o0 < h1) write_back(ha, acc, o0, rg, true, true);
  __syncthreads();

  // 3. the other layers, ha -> hb -> ha ...
  float* a = ha;
  float* h = hb;
  const float* wp = bias + h1;
  for (int layer = 1; layer < args.n_layers; ++layer) {
    const int in_w = args.widths[layer];
    const int out_w = args.widths[layer + 1];
    const float* lb = wp + out_w * in_w;
    if (o0 < out_w) {
      const bool two = o0 + 1 < out_w;
      for (int j = 0; j < 2; ++j) {
        const float b = j == 0 || two ? __ldg(lb + o0 + j) : 0.0f;
        for (int i = 0; i < 4; ++i) acc[i][j] = b;
      }
      dense_steps<false>(acc, a + rg, wp + o0 * in_w, in_w, in_w, two);
      write_back(h, acc, o0, rg, two, layer + 1 < args.n_layers);
    }
    __syncthreads();
    wp = lb + out_w;
    float* t = a;
    a = h;
    h = t;
  }

  // 4. class probabilities; the logits are in a
  if (valid && tid < kTile) {
    float p0, p1;
    if (args.widths[args.n_layers] == 1) {
      const float e = __double2float_rn(exp(-static_cast<double>(a[r])));
      p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
      p0 = __fsub_rn(1.0f, p1);
    } else {
      const float l0 = a[r];
      const float l1 = a[kTile + r];
      const float mx = nan_max(l0, l1);
      const float e0 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l0, mx))));
      const float e1 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l1, mx))));
      const float sum = __fadd_rn(e0, e1);
      p0 = __fdiv_rn(e0, sum);
      p1 = __fdiv_rn(e1, sum);
    }
    args.out[3 * static_cast<size_t>(row)] = args.min_class[s] == 0 ? p0 : p1;
  }
}

// shared floats of one block: the tile's features (later the two
// activation buffers), and the first layer's double buffers of inputs and
// weights
size_t botnet_xf_floats(int d) {
  const size_t xf = static_cast<size_t>(d) * kTile;
  const size_t act = 2 * static_cast<size_t>(kBotnetMaxWidth) * kTile;
  return xf > act ? xf : act;
}

size_t botnet_smem(int d, int h1) {
  return sizeof(float) * (botnet_xf_floats(d) + 2 * static_cast<size_t>(kChunk) * (kTile + h1));
}

}  // namespace

int objective_botnet_max_features() {
  // the largest d whose buffers fit one block at the widest first layer
  int d = 0;
  while (botnet_smem(d + 1, kBotnetMaxWidth) <= kMaxSharedBytes) ++d;
  return d;
}

cudaError_t launch_objective_botnet(BotnetObjectiveArgs args, cudaStream_t stream) {
  if (args.n_rows == 0) return cudaSuccess;
  if (args.n_rows < 0 || args.n <= 0 || args.l <= 0 || args.d <= 0 || args.n_layers < 2 ||
      args.n_layers > kObjectiveMaxLayers || args.widths[0] != args.d)
    return cudaErrorInvalidValue;
  for (int k = 1; k <= args.n_layers; ++k)
    if (args.widths[k] < 1 || args.widths[k] > kBotnetMaxWidth) return cudaErrorInvalidValue;
  if (args.widths[1] % 4 != 0 || args.widths[args.n_layers] > 2) return cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k)
    if (args.counts[k] < 1) return cudaErrorInvalidValue;
  for (int k = 4; k < kBotnetSegments; k += 2)
    if (args.counts[k] < 0 || args.counts[k + 1] != args.counts[k]) return cudaErrorInvalidValue;
  const size_t smem = botnet_smem(args.d, args.widths[1]);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  args.xf_floats = static_cast<int>(botnet_xf_floats(args.d));
  static LaunchCache cache;
  const cudaError_t err = cache.prepare(reinterpret_cast<const void*>(objective_botnet_kernel),
                                        kThreads, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (args.n_rows + kTile - 1) / kTile;
  objective_botnet_kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}
