// K9: MoEvA2's objectives on any domain compiled from a constraint spec
// (domains/ir/), its constraint terms computed by running a program that the
// host lowers from the spec (domains/ir/program.py::lower_spec).
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// engine.py::Moeva2._evaluate on a spec domain, with what it calls:
// core/codec.py::genetic_to_ml and minmax_normalize, the ML scaler,
// models/mlp.py::MLP and softmax, core/norms.py::lp_distance and
// domains/ir/jnp_backend.py::raw_terms (through compile_spec) thresholded by
// core/constraints.py::ConstraintSet.evaluate. The repo has no Pallas kernel
// for it.
//
// Semantics: those of attacks/moeva/engine.py::evaluate_plain with a
// domains/ir/torch_backend.py::SpecConstraintSet, one rounded float32
// operation at a time in its order (__fadd_rn / __fmul_rn / __fdiv_rn, so
// nvcc cannot contract them into FMAs); the decode, f2, the relu stack and
// the softmax are K1's and K8's (objective_lcld.cu, objective_botnet.cu):
// - decode: feature d takes gene feat_gene[d] (feat_onehot[d] < 0), the
//   one-hot bit rintf(gene) == feat_onehot[d], or the initial state's value
//   (feat_gene[d] < 0); then the scaler v * scale + offset;
// - f2: the left-to-right sum of squared min-max differences, a correctly
//   rounded sqrtf, over float32(sqrt(D)); L-inf: the NaN-propagating max of
//   the absolute differences;
// - the relu stack: each unit starts from its bias and adds w[k] * a[k] for
//   k = 0, 1, ... in turn, the weights read from global memory; a NaN passes
//   relu;
// - softmax: exp(l - max) in float64 rounded once over the left-to-right
//   sum; a 1-column head gives [1 - p, p] with p = 1 / (1 + exp(-l));
// - g: the program's terms in order (program.py's ops: pow in float64
//   rounded once, months as K1's lcld_months, guarded divisions keeping
//   their sentinel where the denominator is 0 and, for finite_div, where the
//   quotient is not finite), each kept where > tol and 0 elsewhere (a NaN
//   term counts 0), summed left to right.
// So on the same inputs K9 on lcld_spec equals K1 on lcld, and K9 on
// botnet_spec equals K8 on botnet, bit for bit.
//
// Design (a simple kernel, not yet a fast one): one thread computes one row
// (state, candidate); a block takes a tile of TR rows (128, 64 or 32: the
// largest whose buffers fit one block's shared memory). The block stages
// the program in shared memory, 16 bytes an instruction, so that every
// thread reads the same instruction at once (a broadcast). Each row's
// decoded features, its scratch slots and its activations live in shared
// memory as [k][row], so that a column read by a warp hits 32 distinct
// banks; a thread touches its own row only, so the block needs one barrier,
// after the program's staging. The features are unscaled for f2 and the
// terms, then scaled in place for the first layer, and then take the
// activations of every other layer (at botnet's 756 features that is what
// lets a block hold 64 rows). In the relu stack a thread keeps up to 64
// sums in registers over one read of a[k], and the block stages each
// layer's weights in shared memory, 16 inputs at a time (two barriers per
// stage), so that a step's weights are float4 broadcasts: with the features
// filling shared memory the L1 cache holds little of the weights, and one
// or two warps an SM cannot hide the latency of reading them from L2.
//
// The history (kHistory): MoEvA's save_history="full" records each
// evaluation's objectives and kept terms (the JAX engine's
// _evaluate_hist, the plain version's evaluate_hist_plain): the thread that
// sums a row's terms stores each kept term to the row's (3 + T)-float record
// as it adds it, and f1, f2 and the sum at columns 0-2, so column 2 is out's
// sum bit for bit. At kHistory = false the stores are compiled out.

#include <cmath>

#include "kernels.h"

namespace {

// op codes and operand kinds of domains/ir/program.py
enum SpecOp : int {
  kMov = 0, kAdd, kSub, kMul, kDiv, kPow, kNeg, kAbs, kMonths, kSafeDiv, kFiniteDiv, kTerm,
};
enum SpecKind : int { kFeat = 0, kSlot = 1, kImm = 2 };

__device__ __forceinline__ float relu_if(bool hidden, float x) {
  return hidden && !(x > 0.0f) && !isnan(x) ? 0.0f : x;
}

// a layer's weights are staged kStageK inputs at a time, for at most
// kStageW outputs
constexpr int kStageK = 16;
constexpr int kStageW = 64;

// the block's shared buffers, in order: the program, the features (max(d,
// w_max), TR; after the first layer the second activation buffer), the
// slots (n_slots, TR), an activation buffer (w_max, TR) and the weight stage
__host__ __device__ __forceinline__ size_t spec_smem(int tile_rows, int n_instr, int d, int n_slots, int w_max) {
  const size_t xf = d > w_max ? d : w_max;
  return sizeof(int4) * static_cast<size_t>(n_instr) +
         sizeof(float) * (static_cast<size_t>(tile_rows) * (xf + n_slots + static_cast<size_t>(w_max)) +
                          kStageK * kStageW);
}

// One layer over the tile, every thread its row r: h[o] = relu(bias[o] +
// sum_k a[k] * w[o][k]) for o < out_w, each sum in k order. A thread keeps OM
// sums in registers; the block stages the weights of kStageK inputs and OM
// outputs at a time in `stage` (kk, o), so that a thread reads them as
// float4 broadcasts. kTransposed: w is (in, out) (the first layer's copy),
// else the params' (out, in). Every thread of the block must call it.
template <int OM, int TR>
__device__ __forceinline__ void dense(const float* a, float* h, const float* __restrict__ w, bool transposed,
                                      const float* __restrict__ bias, int in_w, int out_w, bool hidden, int r,
                                      float* stage) {
  for (int o0 = 0; o0 < out_w; o0 += OM) {
    const int no = out_w - o0 < OM ? out_w - o0 : OM;
    float acc[OM];
#pragma unroll
    for (int j = 0; j < OM; ++j) acc[j] = j < no ? __ldg(bias + o0 + j) : 0.0f;
    for (int k0 = 0; k0 < in_w; k0 += kStageK) {
      const int nk = in_w - k0 < kStageK ? in_w - k0 : kStageK;
      __syncthreads();  // the block is done with the previous stage
      for (int e = threadIdx.x; e < nk * OM; e += TR) {
        const int kk = e / OM;
        const int j = e % OM;
        stage[e] = j >= no ? 0.0f
                   : transposed ? __ldg(w + static_cast<size_t>(k0 + kk) * out_w + o0 + j)
                                : __ldg(w + static_cast<size_t>(o0 + j) * in_w + k0 + kk);
      }
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        const float av = a[(k0 + kk) * TR + r];
        const float4* ws = reinterpret_cast<const float4*>(stage + kk * OM);
#pragma unroll
        for (int q = 0; q < OM / 4; ++q) {
          const float4 wv = ws[q];
          acc[4 * q] = __fadd_rn(acc[4 * q], __fmul_rn(av, wv.x));
          acc[4 * q + 1] = __fadd_rn(acc[4 * q + 1], __fmul_rn(av, wv.y));
          acc[4 * q + 2] = __fadd_rn(acc[4 * q + 2], __fmul_rn(av, wv.z));
          acc[4 * q + 3] = __fadd_rn(acc[4 * q + 3], __fmul_rn(av, wv.w));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < OM; ++j)
      if (j < no) h[(o0 + j) * TR + r] = relu_if(hidden, acc[j]);
  }
}

template <int TR, bool kHistory>
__global__ void __launch_bounds__(TR) objective_spec_kernel(const SpecObjectiveArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* prog = reinterpret_cast<int4*>(smem);
  float* xf = reinterpret_cast<float*>(prog + args.n_instr);  // (max(d, w_max), TR)
  float* slots = xf + static_cast<size_t>(args.d > args.w_max ? args.d : args.w_max) * TR;  // (n_slots, TR)
  float* act = slots + static_cast<size_t>(args.n_slots) * TR;  // (w_max, TR)
  float* stage = act + static_cast<size_t>(args.w_max) * TR;     // (kStageK, kStageW)
  const int r = threadIdx.x;
  const int d = args.d;

  for (int e = r; e < args.n_instr; e += TR) prog[e] = reinterpret_cast<const int4*>(args.code)[e];
  __syncthreads();

  // a row past the last computes nothing but takes part in the layers'
  // barriers
  const int row = blockIdx.x * TR + r;
  const bool valid = row < args.n_rows;
  const int s = valid ? row / args.n : 0;
  float* rec = kHistory && valid ? args.record + static_cast<size_t>(3 + args.n_terms) * row : nullptr;
  float f2 = 0.0f;
  float g = 0.0f;
  if (valid) {
    // decode, unscaled
    const float* genes = args.x_gen + static_cast<size_t>(row) * args.l;
    const float* x0 = args.x_init + static_cast<size_t>(s) * d;
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      const int gene = __ldg(args.feat_gene + k);
      const int slot = __ldg(args.feat_onehot + k);
      float v;
      if (gene < 0) {
        v = __ldg(x0 + k);
      } else {
        const float gv = __ldg(genes + gene);
        v = slot < 0 ? gv : (rintf(gv) == static_cast<float>(slot) ? 1.0f : 0.0f);
      }
      xf[k * TR + r] = v;
    }

    // f2 over the min-max differences
    const float* lo = args.xl + static_cast<size_t>(s) * d;
    const float* hi = args.xu + static_cast<size_t>(s) * d;
    const float* mm = args.x_init_mm + static_cast<size_t>(s) * d;
    float dist = 0.0f;
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      const float l = __ldg(lo + k);
      const float rng = __fsub_rn(__ldg(hi + k), l);
      const float diff = __fsub_rn(__fdiv_rn(__fsub_rn(xf[k * TR + r], l), rng == 0.0f ? 1.0f : rng), __ldg(mm + k));
      if (args.norm_inf) {
        dist = k == 0 ? fabsf(diff) : nan_max(dist, fabsf(diff));
      } else {
        const float sq = __fmul_rn(diff, diff);
        dist = k == 0 ? sq : __fadd_rn(dist, sq);
      }
    }
    f2 = __fdiv_rn(args.norm_inf ? dist : __fsqrt_rn(dist), args.f2_scale);

    // the constraint program
    auto operand = [&](int kind, int v) -> float {
      if (kind == kFeat) return xf[v * TR + r];
      if (kind == kSlot) return slots[v * TR + r];
      return __int_as_float(v);
    };
    for (int i = 0; i < args.n_instr; ++i) {
      const int4 ins = prog[i];
      const int op = ins.x & 0xFF;
      const float a = operand((ins.x >> 8) & 0xF, ins.z);
      if (op == kTerm) {
        const float kept = a > args.tol ? a : 0.0f;
        g = ins.y == 0 ? kept : __fadd_rn(g, kept);
        if constexpr (kHistory) rec[3 + ins.y] = kept;
        continue;
      }
      const float b = operand((ins.x >> 12) & 0xF, ins.w);
      float* dst = slots + ins.y * TR + r;
      float v;
      switch (op) {
        case kMov: v = a; break;
        case kAdd: v = __fadd_rn(a, b); break;
        case kSub: v = __fsub_rn(a, b); break;
        case kMul: v = __fmul_rn(a, b); break;
        case kDiv: v = __fdiv_rn(a, b); break;
        case kPow: v = __double2float_rn(pow(static_cast<double>(a), static_cast<double>(b))); break;
        case kNeg: v = -a; break;
        case kAbs: v = fabsf(a); break;
        case kMonths: v = lcld_months(a); break;
        case kSafeDiv: v = b != 0.0f ? __fdiv_rn(a, b) : *dst; break;
        default: {  // kFiniteDiv
          const float q = b != 0.0f ? __fdiv_rn(a, b) : *dst;
          v = isfinite(q) ? q : *dst;
        }
      }
      *dst = v;
    }

    // the scaler, in place: the first layer's input
    if (args.scale != nullptr) {
#pragma unroll 4
      for (int k = 0; k < d; ++k)
        xf[k * TR + r] = __fadd_rn(__fmul_rn(xf[k * TR + r], __ldg(args.scale + k)), __ldg(args.offset + k));
    }
  }

  // the relu stack, xf -> act -> xf -> act ...; the first layer's weights
  // from its transposed copy, the others' from the params
  const float* a = xf;
  float* h = act;
  const float* wp = args.params;
  for (int layer = 0; layer < args.n_layers; ++layer) {
    const int in_w = args.widths[layer];
    const int out_w = args.widths[layer + 1];
    const float* bias = wp + static_cast<size_t>(out_w) * in_w;
    const bool hidden = layer + 1 < args.n_layers;
    const bool first = layer == 0;
    const float* w = first ? args.first_t : wp;
    if (out_w > 32)
      dense<64, TR>(a, h, w, first, bias, in_w, out_w, hidden, r, stage);
    else if (out_w > 16)
      dense<32, TR>(a, h, w, first, bias, in_w, out_w, hidden, r, stage);
    else if (out_w > 4)
      dense<16, TR>(a, h, w, first, bias, in_w, out_w, hidden, r, stage);
    else
      dense<4, TR>(a, h, w, first, bias, in_w, out_w, hidden, r, stage);
    wp = bias + out_w;
    a = h;
    h = h == act ? xf : act;
  }
  if (!valid) return;

  // class probabilities and the objectives; the logits are in a
  float p0, p1;
  if (args.widths[args.n_layers] == 1) {
    const float e = __double2float_rn(exp(-static_cast<double>(a[r])));
    p1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
    p0 = __fsub_rn(1.0f, p1);
  } else {
    const float l0 = a[r];
    const float l1 = a[TR + r];
    const float mx = nan_max(l0, l1);
    const float e0 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l0, mx))));
    const float e1 = __double2float_rn(exp(static_cast<double>(__fsub_rn(l1, mx))));
    const float sum = __fadd_rn(e0, e1);
    p0 = __fdiv_rn(e0, sum);
    p1 = __fdiv_rn(e1, sum);
  }
  const float f1 = args.min_class[s] == 0 ? p0 : p1;
  float* out = args.out + 3 * static_cast<size_t>(row);
  out[0] = f1;
  out[1] = f2;
  out[2] = g;
  if constexpr (kHistory) {
    rec[0] = f1;
    rec[1] = f2;
    rec[2] = g;
  }
}

template <int TR, bool kHistory>
cudaError_t launch_tiles(const SpecObjectiveArgs& args, size_t smem, cudaStream_t stream) {
  static LaunchCache cache;
  const cudaError_t err =
      cache.prepare(reinterpret_cast<const void*>(objective_spec_kernel<TR, kHistory>), TR, smem, nullptr);
  if (err != cudaSuccess) return err;
  const int grid = (args.n_rows + TR - 1) / TR;
  objective_spec_kernel<TR, kHistory><<<grid, TR, smem, stream>>>(args);
  return cudaGetLastError();
}

template <bool kHistory>
cudaError_t launch_history(const SpecObjectiveArgs& args, cudaStream_t stream) {
  // the largest tile whose buffers fit one block
  for (int tr : {128, 64, 32}) {
    const size_t smem = spec_smem(tr, args.n_instr, args.d, args.n_slots, args.w_max);
    if (smem > kMaxSharedBytes) continue;
    if (tr == 128) return launch_tiles<128, kHistory>(args, smem, stream);
    if (tr == 64) return launch_tiles<64, kHistory>(args, smem, stream);
    return launch_tiles<32, kHistory>(args, smem, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

int objective_spec_tile_rows(int n_instr, int d, int n_slots, int w_max) {
  for (int tr : {128, 64, 32})
    if (spec_smem(tr, n_instr, d, n_slots, w_max) <= kMaxSharedBytes) return tr;
  return 0;
}

cudaError_t launch_objective_spec(SpecObjectiveArgs args, cudaStream_t stream) {
  if (args.n_rows == 0) return cudaSuccess;
  if (args.n_rows < 0 || args.n <= 0 || args.l <= 0 || args.d < 1 || args.d > kSpecMaxFeatures ||
      args.n_instr < 1 || args.n_instr > kSpecMaxInstructions || args.n_slots < 1 ||
      args.n_slots > kSpecMaxSlots || args.n_terms < 1 || args.n_terms > kSpecMaxTerms || args.n_layers < 1 ||
      args.n_layers > kObjectiveMaxLayers || args.widths[0] != args.d || args.code == nullptr ||
      args.first_t == nullptr)
    return cudaErrorInvalidValue;
  int w_max = 1;
  for (int k = 1; k <= args.n_layers; ++k) {
    if (args.widths[k] < 1 || args.widths[k] > kSpecMaxWidth) return cudaErrorInvalidValue;
    w_max = args.widths[k] > w_max ? args.widths[k] : w_max;
  }
  if (args.widths[args.n_layers] > 2) return cudaErrorInvalidValue;
  args.w_max = w_max;
  return args.record != nullptr ? launch_history<true>(args, stream) : launch_history<false>(args, stream);
}
