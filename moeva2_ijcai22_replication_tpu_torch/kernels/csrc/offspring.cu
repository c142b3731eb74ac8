// K5: genetic operators, one thread block per state.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// operators.py::make_offspring (vmapped over states in engine.py gen_step):
// uniform parent pairs, mixed-variable two-point crossover with one cut pair
// and one coin per type sub-vector, and polynomial mutation. The repo has no
// Pallas kernel for it.
//
// Semantics: those of the plain attacks/moeva/operators.py::make_offspring,
// every draw an input (OffspringDraws). Child o < n_mat is the first child of
// mating o, child o >= n_mat the second child of mating o - n_mat. Integer
// genes mutate on bounds widened by float32(0.5 - 1e-16) = 0.5 and are
// rounded half to even (rintf, as torch.round). Both pows are taken in
// float64 and rounded once to float32, as the plain version does; every
// other operation is one float32 operation written with __fadd_rn /
// __fmul_rn / __fdiv_rn in the plain version's order, so nvcc cannot contract
// them into FMAs. min/max propagate NaN as torch.minimum/maximum do.
//
// Bound: bytes, the two (S, N, L) uniform fields and the output, in
// principle. Per element the crossover and the clip are a dozen operations;
// only a gene that mutates (probability 1/n_type, 7% of LCLD's) needs the
// two float64 pows, which cost more than everything else together.
//
// Design: nothing an element needs is computed twice or waited for twice,
// and the pows run on full warps.
// - Stage once per state, in shared memory: each (type, mating)'s swap
//   segment, the coin folded in (300 int64 modulos at N = 100 instead of one
//   pair per element), the parent pairs, and per gene its bounds, widened
//   bounds, range, mutation probability rounded to float32, rank in its type
//   and flags.
// - The state's elements go in chunks of 1024. A chunk's mut_select is
//   copied asynchronously (cp.async) into shared memory, the next chunk's
//   while the current one mutates.
// - Pass 1, every element of the chunk, coalesced and without branches but
//   the queue append: the crossover, with the parent genes of two rounds
//   loaded before the first is used, and a gene that does not mutate is
//   written at once (rounded, clipped). A mutating element goes to its
//   warp's segment of a queue in shared memory (a warp ballot and __popc, no
//   atomic: a warp owns its segment) with its crossed value, and its mut_u
//   is copied asynchronously into the queue entry: mut_u is read only where
//   a gene mutates, and pass 2 waits on no device memory.
// - Pass 2 runs the polynomial mutation on the queue only, densely, with the
//   pows in the plain version's order.
// - 128 threads per block and ~19 KB of shared memory at LCLD's shapes: 8
//   blocks per SM, so 1000 states run in one wave.
// Every element's arithmetic is unchanged; only which thread does it moves,
// so the output is bit for bit. The chunks bound the queue whatever N and L.

#include <cmath>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                   // rounds of pass 1 per chunk
constexpr int kBatch = 2;                    // rounds whose parent genes load together
constexpr int kChunk = kRounds * kThreads;   // elements per chunk
constexpr int kSegment = kRounds * 32;       // a warp's queue segment: never overflows
constexpr unsigned kFullMask = 0xffffffffu;

// gene flags: bits 0-1 the type id
constexpr int kIsInt = 4;
constexpr int kHasRange = 8;

// operators.two_cuts: the sorted swap segment [lo, hi) of a sub-vector of
// n genes from two non-negative raw draws.
__device__ __forceinline__ void two_cuts(int64_t a_raw, int64_t b_raw,
                                         int64_t n, int64_t& lo,
                                         int64_t& hi) {
  const int64_t m = n - 1 > 1 ? n - 1 : 1;
  if (m == 1) {
    lo = n == 2 ? 1 : 0;
    hi = n == 2 ? n : 0;
    return;
  }
  const int64_t a = a_raw % m;
  int64_t b = b_raw % (m - 1 > 1 ? m - 1 : 1);
  if (b >= a) b += 1;
  lo = (a < b ? a : b) + 1;
  hi = (a < b ? b : a) + 1;
}

struct TypeSizes {
  int64_t n[3];
};

// One gene of the state being bred (two 16-byte loads).
struct __align__(16) Gene {
  float lo, hi;    // the bounds (the clip)
  float exl, exu;  // the bounds mutation works on, widened for integer genes
  float safe;      // exu - exl where positive, else 1
  float prob;      // mutation probability, rounded to float32
  int rank;        // position in its type's sub-vector
  int flags;
};

// One mating: each type's swap segment [lo, hi) (empty where its coin says
// no crossover), and the parents.
struct __align__(16) Mating {
  int2 seg[3];
  int2 parents;
};

// Copies 4 bytes from device memory to shared memory without holding a
// register; done for this thread after copy_async_wait().
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float clip(float y, const Gene& g) {
  return nan_min(nan_max(g.flags & kIsInt ? rintf(y) : y, g.lo), g.hi);
}

__global__ void __launch_bounds__(kThreads, 8)
offspring_kernel(const float* __restrict__ pop, const float* __restrict__ xl,
                 const float* __restrict__ xu,
                 const int64_t* __restrict__ pairs,
                 const int64_t* __restrict__ cut_a,
                 const int64_t* __restrict__ cut_b,
                 const float* __restrict__ coins,
                 const float* __restrict__ mut_select,
                 const float* __restrict__ mut_u,
                 const int64_t* __restrict__ type_id,
                 const int64_t* __restrict__ rank_in_type,
                 const double* __restrict__ mut_prob,
                 const bool* __restrict__ int_mask, TypeSizes sizes,
                 float* __restrict__ out, int n_states, int p, int l,
                 int n_off, int n_mat, float prob, double eta_p1,
                 double mut_pow) {
  extern __shared__ __align__(16) unsigned char staged[];
  Gene* genes = reinterpret_cast<Gene*>(staged);                // (l,)
  Mating* matings = reinterpret_cast<Mating*>(genes + l);       // (n_mat,)
  float* select = reinterpret_cast<float*>(matings + n_mat);    // (kChunk,)
  // the queue: element, crossed value, mut_u; one segment per warp
  __shared__ int queue_elem[kChunk];
  __shared__ float queue_x[kChunk];
  __shared__ float queue_u[kChunk];
  __shared__ int queued[kWarps];
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int total = n_off * l;  // the state's elements, e = o * l + g
  const float* pop_s = pop + s * p * l;
  const float* sel_s = mut_select + s * total;
  const float* u_s = mut_u + s * total;
  float* out_s = out + s * total;

  // the first chunk's mut_select in flight while the tables are computed
  for (int i = tid; i < min(kChunk, total); i += kThreads) copy_async(select + i, sel_s + i);
  const float half = static_cast<float>(0.5 - 1e-16);
  for (int k = tid; k < max(l, 3 * n_mat); k += kThreads) {
    if (k < l) {
      Gene gene;
      gene.lo = xl[s * l + k];
      gene.hi = xu[s * l + k];
      const bool is_int = int_mask[k];
      const float ext = is_int ? half : 0.0f;
      gene.exl = __fsub_rn(gene.lo, ext);
      gene.exu = __fadd_rn(gene.hi, ext);
      const float rng = __fsub_rn(gene.exu, gene.exl);
      gene.safe = rng > 0.0f ? rng : 1.0f;
      gene.prob = static_cast<float>(mut_prob[k]);
      gene.rank = static_cast<int>(rank_in_type[k]);
      gene.flags = static_cast<int>(type_id[k]) | (is_int ? kIsInt : 0) |
                   (rng > 0.0f ? kHasRange : 0);
      genes[k] = gene;
    }
    if (k < 3 * n_mat) {
      const int t = k / n_mat;
      const int i = k - t * n_mat;
      const size_t di = (static_cast<size_t>(t) * n_states + s) * n_mat + i;
      const int64_t n = t == 0 ? sizes.n[0] : (t == 1 ? sizes.n[1] : sizes.n[2]);
      int64_t lo, hi;
      two_cuts(cut_a[di], cut_b[di], n, lo, hi);
      const bool cross = coins[di] < prob;
      matings[i].seg[t] = cross ? make_int2(static_cast<int>(lo), static_cast<int>(hi))
                                : make_int2(0, 0);
      if (t == 0)
        matings[i].parents = make_int2(static_cast<int>(pairs[(s * n_mat + i) * 2]),
                                       static_cast<int>(pairs[(s * n_mat + i) * 2 + 1]));
    }
  }
  copy_async_wait();
  __syncthreads();

  // this thread's element (o, g); each round moves it kThreads further
  const int step_o = kThreads / l;
  const int step_g = kThreads % l;
  int o = tid / l;
  int g = tid % l;
  for (int start = 0; start < total; start += kChunk) {
    const int end = min(start + kChunk, total);

    // pass 1: crossover; genes that do not mutate are written, the others
    // queued with their crossed value and their mut_u
    int n_seg = 0;  // this warp's queue entries
    int* seg_elem = queue_elem + warp * kSegment;
    float* seg_x = queue_x + warp * kSegment;
    float* seg_u = queue_u + warp * kSegment;
    for (int r0 = 0; r0 < kRounds && start + r0 * kThreads < end; r0 += kBatch) {
      float x[kBatch];
      int gb[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool valid = start + (r0 + b) * kThreads + tid < end;
        const Gene& gene = genes[g];
        const bool second = o >= n_mat;
        const Mating& mt = matings[valid ? (second ? o - n_mat : o) : 0];
        const int2 seg = mt.seg[gene.flags & 3];
        const bool swap = gene.rank >= seg.x && gene.rank < seg.y;
        x[b] = pop_s[(swap != second ? mt.parents.y : mt.parents.x) * l + g];
        gb[b] = g;
        o += step_o;
        g += step_g;
        if (g >= l) {
          g -= l;
          ++o;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = start + (r0 + b) * kThreads + tid;
        const Gene gene = genes[gb[b]];
        const bool mutate =
            e < end && (gene.flags & kHasRange) && select[e - start] < gene.prob;
        if (e < end && !mutate) out_s[e] = clip(x[b], gene);
        const unsigned ballot = __ballot_sync(kFullMask, mutate);
        if (mutate) {
          const int slot = n_seg + __popc(ballot & lanes_below);
          seg_elem[slot] = e;
          seg_x[slot] = x[b];
          copy_async(seg_u + slot, u_s + e);
        }
        n_seg += __popc(ballot);
      }
    }
    if (lane == 0) queued[warp] = n_seg;
    copy_async_wait();
    __syncthreads();
    int n_queued = 0;
    for (int w = 0; w < kWarps; ++w) n_queued += queued[w];
    // the next chunk's mut_select, while this one mutates
    for (int i = end + tid; i < min(end + kChunk, total); i += kThreads)
      copy_async(select + (i - end), sel_s + i);

    // pass 2: polynomial mutation of the queued elements
    for (int k = tid; k < n_queued; k += kThreads) {
      int w = 0, i = k;  // the k-th entry: entry i of warp w's segment
      while (i >= queued[w]) i -= queued[w++];
      const int slot = w * kSegment + i;
      const int e = queue_elem[slot];
      const float x = queue_x[slot];
      const float u = queue_u[slot];
      const Gene gene = genes[e % l];
      const bool lower = u <= 0.5f;
      const float d = lower ? __fdiv_rn(__fsub_rn(x, gene.exl), gene.safe)
                            : __fdiv_rn(__fsub_rn(gene.exu, x), gene.safe);
      const float xy = nan_min(nan_max(__fsub_rn(1.0f, d), 0.0f), 1.0f);
      const float pw = __double2float_rn(pow(static_cast<double>(xy), eta_p1));
      float val;
      if (lower) {
        const float two_u = __fmul_rn(2.0f, u);
        val = __fadd_rn(two_u, __fmul_rn(__fsub_rn(1.0f, two_u), pw));
      } else {
        val = __fadd_rn(__fmul_rn(2.0f, __fsub_rn(1.0f, u)),
                        __fmul_rn(__fmul_rn(2.0f, __fsub_rn(u, 0.5f)), pw));
      }
      val = nan_max(val, 0.0f);
      const float q = __double2float_rn(pow(static_cast<double>(val), mut_pow));
      const float deltaq = lower ? __fsub_rn(q, 1.0f) : __fsub_rn(1.0f, q);
      out_s[e] = clip(__fadd_rn(x, __fmul_rn(deltaq, gene.safe)), gene);
    }
    copy_async_wait();
    __syncthreads();
  }
}

}  // namespace

cudaError_t launch_offspring(const float* pop, const float* xl,
                             const float* xu, const int64_t* pairs,
                             const int64_t* cut_a, const int64_t* cut_b,
                             const float* coins, const float* mut_select,
                             const float* mut_u, const int64_t* type_id,
                             const int64_t* rank_in_type,
                             const double* mut_prob, const bool* int_mask,
                             const int64_t* type_sizes, float* out,
                             int n_states, int p, int l, int n_off, int n_mat,
                             float prob, double eta_p1, double mut_pow,
                             cudaStream_t stream) {
  if (n_states == 0 || n_off == 0 || l == 0) return cudaSuccess;
  if (n_states < 0 || n_off < 0 || l < 0 || p <= 0 || n_mat <= 0 ||
      n_off > 2 * n_mat)
    return cudaErrorInvalidValue;
  // the tables and one chunk of mut_select must fit beside the queue
  const size_t smem = sizeof(Gene) * l + sizeof(Mating) * n_mat + sizeof(float) * kChunk;
  if (smem > kMaxSharedBytes - 3 * sizeof(float) * kChunk - kWarps * sizeof(int))
    return cudaErrorInvalidValue;
  TypeSizes sizes;
  for (int k = 0; k < 3; ++k) sizes.n[k] = type_sizes[k];
  static LaunchCache cache;
  const cudaError_t err = cache.prepare(
      reinterpret_cast<const void*>(offspring_kernel), kThreads, smem, nullptr);
  if (err != cudaSuccess) return err;
  offspring_kernel<<<n_states, kThreads, smem, stream>>>(
      pop, xl, xu, pairs, cut_a, cut_b, coins, mut_select, mut_u, type_id,
      rank_in_type, mut_prob, int_mask, sizes, out, n_states, p, l, n_off,
      n_mat, prob, eta_p1, mut_pow);
  return cudaGetLastError();
}
