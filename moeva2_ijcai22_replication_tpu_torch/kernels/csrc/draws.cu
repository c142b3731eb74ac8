// K0: every random draw of the attacks, Philox4x32-10 counter-based.
//
// Replaces the draws the JAX package makes inside its device programs
// (moeva2_ijcai22_replication_tpu has no Pallas kernel for them; they are
// jax.random calls in the jitted init and generation programs):
// - attacks/moeva/operators.py:105 select_parent_pairs, :116 _two_cuts, the
//   crossover coins at :151-158 and the mutation uniforms at :195-222;
// - attacks/moeva/survival.py:391 _niche_gumbels;
// - attacks/moeva/initialisation.py:30 ball_sample's normals or uniforms;
// - attacks/pgd/engine.py:275 _random_start (pgd_start_kernel, which also
//   writes the start).
//
// Semantics (must equal core/philox.py's draw_plain, and pgd_start_plain in
// attacks/pgd/engine.py, bit for bit on the card): a call of n_fields
// fields takes `total` Philox blocks from `base`; block b is
// philox4x32_10(counter (b mod 2^32, b >> 32, 0, 0), key (key0, key1)).
// Field f's element i lies in block base + first_f + i / per at slot
// i % per, with per 4 for integers, cuts and float32 uniforms (and their
// symmetric and gumbel forms) and 2 for normals. The words map to values as
// core/philox.py states: (w >> 8) * 2^-24; 2u - 1; __umulhi(w, n); w >> 2;
// -log(-log(max(u, FLT_MIN))) in double rounded once; Box-Muller in double
// from the 53-bit uniforms of (w0, w1) and (w2, w3), r cos t and r sin t,
// each rounded once. The card runs float32 only: the engine's float64 runs
// on the CPU, where draw_plain gives its 53-bit uniforms.
//
// pgd_start_kernel: x_start = clamp(x_init + (mutable ? pert : 0), lo, hi)
// per element, pert = eps * (2u - 1) under L-inf, and under L2
// (d / (sqrt_rn(left-to-right sum of d * d) + 1e-12)) * (eps * u^(1/D)),
// d the row's normals and u its one uniform, the pow in double rounded once
// (a sqrt where 1/D is 0.5, as PyTorch's pow takes it).
//
// Bound: the bytes written (draws_kernel reads nothing; pgd_start_kernel
// reads x_init once) against about 100 integer operations a block (ten
// rounds of two 32-bit multiplies, their high halves, two XORs and the key
// bumps), plus two double logs a gumbel and a log, a sqrt, a sin and a cos
// a normal pair. Design, simple first: one thread per block of the call
// (grid-stride), which finds its field by a scan of at most kDrawMaxFields
// entries, computes its four words in registers and writes its elements
// with one vector store (16 bytes of floats or 32 of int64; 8 for a normal
// pair), so a warp's store covers whole sectors: every field starts 16-byte
// aligned, and a field's partial last block is written element by element.
// No state on the device, no atomics, no shared memory. A generation's
// seven fields are one launch into one buffer that the wrapper views.
// pgd_start_kernel runs one block per row: each thread computes the words
// of its elements (a block's words are computed once for each element
// they feed, up to four times: cheap beside the row's reduction), and under
// L2 thread 0 sums the row's squares left to right from shared memory, as
// the plain version's sum_last does.

#include <cfloat>

#include "kernels.h"

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr double kTwoPi = 6.283185307179586;  // 2 pi rounded to double, core/philox.py's TWO_PI
constexpr int kDrawThreads = 256;
constexpr int kStartThreads = 128;

__device__ __forceinline__ uint4 philox4x32_10(uint64_t n, uint32_t k0, uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(n), c1 = static_cast<uint32_t>(n >> 32), c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int slot) {
  return slot == 0 ? w.x : slot == 1 ? w.y : slot == 2 ? w.z : w.w;
}

__device__ __forceinline__ float uniform32(uint32_t w) {
  return __fmul_rn(static_cast<float>(w >> 8), 5.9604644775390625e-08f);  // 2^-24, exact
}

__device__ __forceinline__ double uniform53(uint32_t a, uint32_t b) {
  const uint64_t m = (static_cast<uint64_t>(a >> 5) << 26) + (b >> 6);
  return __dmul_rn(static_cast<double>(m), 1.1102230246251565e-16);  // 2^-53, exact
}

__device__ __forceinline__ float gumbel32(uint32_t w) {
  const double u = fmax(static_cast<double>(uniform32(w)), static_cast<double>(FLT_MIN));
  return __double2float_rn(-log(-log(u)));
}

// The two normals of a block; sin and cos kept apart as PyTorch computes
// them (one sincos could round otherwise).
__device__ __noinline__ double cos_of(double t) { return cos(t); }
__device__ __noinline__ double sin_of(double t) { return sin(t); }

__device__ __forceinline__ float normal32(const uint4& w, int slot) {
  const double u1 = uniform53(w.x, w.y), u2 = uniform53(w.z, w.w);
  const double r = sqrt(__dmul_rn(-2.0, log(__dsub_rn(1.0, u1))));
  const double t = __dmul_rn(u2, kTwoPi);
  return __double2float_rn(__dmul_rn(r, slot ? sin_of(t) : cos_of(t)));
}

__device__ __forceinline__ float symmetric32(uint32_t w) {
  return __fsub_rn(__fmul_rn(2.0f, uniform32(w)), 1.0f);
}

__device__ __forceinline__ int per_block(int kind) { return kind == kDrawNormal ? 2 : 4; }

__global__ void __launch_bounds__(kDrawThreads) draws_kernel(const __grid_constant__ DrawArgs args) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kDrawThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kDrawThreads + threadIdx.x; t < args.total; t += stride) {
    int f = 0;
    while (f + 1 < args.n_fields && t >= args.field[f + 1].first) ++f;
    const DrawField& fd = args.field[f];
    const uint4 w = philox4x32_10(args.base + static_cast<uint64_t>(t), args.key0, args.key1);
    const int per = per_block(fd.kind);
    const int64_t i0 = (t - fd.first) * per;
    if (i0 + per <= fd.numel) {
      // a whole block: one vector store, 16-byte aligned
      float* fo = static_cast<float*>(fd.out) + i0;
      long long* io = static_cast<long long*>(fd.out) + i0;
      switch (fd.kind) {
        case kDrawUniform:
          *reinterpret_cast<float4*>(fo) = make_float4(uniform32(w.x), uniform32(w.y), uniform32(w.z), uniform32(w.w));
          break;
        case kDrawSymmetric:
          *reinterpret_cast<float4*>(fo) =
              make_float4(symmetric32(w.x), symmetric32(w.y), symmetric32(w.z), symmetric32(w.w));
          break;
        case kDrawInteger:
          reinterpret_cast<longlong2*>(io)[0] = make_longlong2(__umulhi(w.x, fd.n), __umulhi(w.y, fd.n));
          reinterpret_cast<longlong2*>(io)[1] = make_longlong2(__umulhi(w.z, fd.n), __umulhi(w.w, fd.n));
          break;
        case kDrawCut:
          reinterpret_cast<longlong2*>(io)[0] = make_longlong2(w.x >> 2, w.y >> 2);
          reinterpret_cast<longlong2*>(io)[1] = make_longlong2(w.z >> 2, w.w >> 2);
          break;
        case kDrawGumbel:
          *reinterpret_cast<float4*>(fo) = make_float4(gumbel32(w.x), gumbel32(w.y), gumbel32(w.z), gumbel32(w.w));
          break;
        default: *reinterpret_cast<float2*>(fo) = make_float2(normal32(w, 0), normal32(w, 1)); break;
      }
      continue;
    }
    for (int slot = 0; slot < per; ++slot) {
      const int64_t i = i0 + slot;
      if (i >= fd.numel) break;
      const uint32_t x = word(w, slot);
      switch (fd.kind) {
        case kDrawUniform: static_cast<float*>(fd.out)[i] = uniform32(x); break;
        case kDrawSymmetric: static_cast<float*>(fd.out)[i] = symmetric32(x); break;
        case kDrawInteger: static_cast<int64_t*>(fd.out)[i] = __umulhi(x, fd.n); break;
        case kDrawCut: static_cast<int64_t*>(fd.out)[i] = x >> 2; break;
        case kDrawGumbel: static_cast<float*>(fd.out)[i] = gumbel32(x); break;
        default: static_cast<float*>(fd.out)[i] = normal32(w, slot); break;
      }
    }
  }
}

// The value of element e of field fd of the call: its block's words, then
// the field's map.
__device__ __forceinline__ float field_value(const DrawArgs& a, const DrawField& fd, int64_t e) {
  const int per = per_block(fd.kind);
  const uint4 w = philox4x32_10(a.base + static_cast<uint64_t>(fd.first + e / per), a.key0, a.key1);
  const int slot = static_cast<int>(e % per);
  switch (fd.kind) {
    case kDrawUniform: return uniform32(word(w, slot));
    case kDrawSymmetric: return symmetric32(word(w, slot));
    default: return normal32(w, slot);
  }
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  // torch.clamp: NaN stays NaN
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kStartThreads) pgd_start_kernel(const __grid_constant__ PgdStartArgs args) {
  extern __shared__ float dir[];
  __shared__ float den, radius;
  const int n = blockIdx.x;
  const int d = args.d;
  const float* x = args.x_init + static_cast<int64_t>(n) * d;
  float* out = args.x_start + static_cast<int64_t>(n) * d;
  const int64_t row0 = static_cast<int64_t>(n) * d;
  if (args.norm_inf) {
    for (int c = threadIdx.x; c < d; c += kStartThreads) {
      const float pert = __fmul_rn(args.eps, field_value(args.draws, args.draws.field[0], row0 + c));
      out[c] = clamp_nan(__fadd_rn(x[c], args.mutable_mask[c] ? pert : 0.0f), args.lo, args.hi);
    }
    return;
  }
  for (int c = threadIdx.x; c < d; c += kStartThreads) dir[c] = field_value(args.draws, args.draws.field[0], row0 + c);
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = __fmul_rn(dir[0], dir[0]);
    for (int c = 1; c < d; ++c) acc = __fadd_rn(acc, __fmul_rn(dir[c], dir[c]));
    den = __fadd_rn(__double2float_rn(sqrt(static_cast<double>(acc))), 1e-12f);
    const double u = static_cast<double>(field_value(args.draws, args.draws.field[1], n));
    const double p = args.exponent == 0.5 ? sqrt(u) : pow(u, args.exponent);
    radius = __fmul_rn(args.eps, __double2float_rn(p));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kStartThreads) {
    const float pert = __fmul_rn(__fdiv_rn(dir[c], den), radius);
    out[c] = clamp_nan(__fadd_rn(x[c], args.mutable_mask[c] ? pert : 0.0f), args.lo, args.hi);
  }
}

}  // namespace

cudaError_t launch_draws(const DrawArgs& args, cudaStream_t stream) {
  if (args.total == 0) return cudaSuccess;
  if (args.total < 0 || args.n_fields < 1 || args.n_fields > kDrawMaxFields) return cudaErrorInvalidValue;
  for (int f = 0; f < args.n_fields; ++f)
    if (reinterpret_cast<uintptr_t>(args.field[f].out) % 16 != 0) return cudaErrorInvalidValue;
  const int64_t want = (args.total + kDrawThreads - 1) / kDrawThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  draws_kernel<<<blocks, kDrawThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

cudaError_t launch_pgd_start(const PgdStartArgs& args, cudaStream_t stream) {
  if (args.n == 0) return cudaSuccess;
  if (args.n < 0 || args.d < 1 || args.draws.n_fields != (args.norm_inf ? 1 : 2)) return cudaErrorInvalidValue;
  const size_t smem = args.norm_inf ? 0 : static_cast<size_t>(args.d) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  pgd_start_kernel<<<args.n, kStartThreads, smem, stream>>>(args);
  return cudaGetLastError();
}
