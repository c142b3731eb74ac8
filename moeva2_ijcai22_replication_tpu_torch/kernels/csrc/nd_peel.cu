// K2: non-dominated front peeling, one thread block per state.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/moeva/
// nds.py::nd_ranks (a lax.while_loop over (M, M) count contractions; the
// repo has no Pallas kernel for it). In eager PyTorch that loop costs a host
// round trip per front; here the whole peel runs inside the block.
//
// Semantics (must equal nd_ranks_plain bit for bit): i dominates j iff
// all(f_i <= f_j) and any(f_i < f_j) — IEEE comparisons, so a NaN row
// neither dominates nor is dominated. Fronts 0, 1, 2, ... are peeled until
// at least n_stop candidates are ranked; if a peel finds no front among the
// remaining candidates, all of them take the current rank (the safety
// branch of nds.py). Unpeeled candidates keep 2^31 - 1.
//
// Bound: instruction issue, the half-rate logic pipe and the shared-memory
// pipe of the relation's build, about 16 instructions per 32 x 2 ordered
// pairs (6 fp32 subtractions, logic, shifts, three broadcast loads); then
// the peel, a few words per candidate per front with a block barrier each.
// The operations bound (6 per pair at the fp32 peak) is far below; bytes
// are 16 per candidate.
//
// Design:
// - One warp per 32-candidate word, one instantiation per word count W =
//   ceil(M/32), so every shared-memory offset is a constant: the block has
//   32W threads and lane l of warp w owns candidate i = 32w + l, its
//   objectives in registers and later its rank. Lanes past M hold NaN.
// - Comparisons are fp32 subtractions, which run at full rate: for a and b
//   without NaN, with -0 turned into +0 on loading and no flush to zero,
//   the sign of a - b is set iff a < b; equal infinities give a NaN whose
//   sign bit the card leaves clear, as for equal values. So the OR of the
//   three differences g - mine has a clear sign bit iff all(mine <= g), and
//   i dominates j iff all(f_i <= f_j) and not all(f_j <= f_i): for rows
//   without NaN, not all(f_j <= f_i) is any(f_i < f_j). A row with a NaN
//   neither dominates nor is dominated: its relation bits are left as they
//   come, and the peel masks them.
// - The relation is a bitset in shared memory: row i holds the words whose
//   bit j says "j dominates i". One comparison of a pair gives both
//   directions, so each unordered pair of words (a, b) is compared once, by
//   warp a: over the 32 j of word b, lane i shifts "j dominates i" into row
//   i's word b and "i dominates j" into a second word, which a 32 x 32 bit
//   transpose of five shuffles turns into row j's word a. Warp w takes its
//   diagonal word and the words w + 1, ..., w + W/2 (mod W), so the warps
//   share the W(W + 1)/2 pairs evenly. For an even W, warp a alone takes
//   the pair (a, a + W/2); up to 8 words, where the kernel must fit 32
//   registers, both warps compare it and write the same words instead: a
//   warp-dependent exit makes the compiler add a divergent path around the
//   shuffles, which takes 43 registers. The objectives lie
//   in shared memory as three arrays (a broadcast load each), and the row
//   stride is an odd number of words, so a warp's 32 rows at one word hit
//   32 banks.
// - The peel needs one barrier per front: each lane tests its row against
//   the remaining rows without NaN, a ballot gives its warp's front word,
//   lane 0 publishes the next remaining word into the other half of a
//   double buffer, and __syncthreads_count ends the front with its size.
//   Ranks stay in registers and are stored once, coalesced.

#include "kernels.h"

namespace {

constexpr int32_t kUnranked = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxWords = (kNdPeelMaxCandidates + 31) / 32;
// word counts held to 32 registers (see min_blocks)
constexpr int kCappedWords = 8;

// OR of the bits of a - b over the three objectives: its sign bit is clear
// iff all(b <= a), for rows without NaN or -0 (see the design note).
__device__ __forceinline__ uint32_t below_or_equal(float ax, float ay, float az, float bx,
                                                   float by, float bz) {
  return __float_as_uint(__fsub_rn(ax, bx)) | __float_as_uint(__fsub_rn(ay, by)) |
         __float_as_uint(__fsub_rn(az, bz));
}

// Lane l holds row l of a 32 x 32 bit matrix; returns column l (bit t of
// the result is bit l of lane t's row), by five exchanges of s x s blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const uint32_t mask = 0xffffffffu / ((1u << s) + 1u);  // bits t with t & s == 0
    const uint32_t y = __shfl_xor_sync(kAll, x, s);
    x = (lane & s) ? (x & ~mask) | ((y >> s) & mask) : (x & mask) | ((y << s) & ~mask);
  }
  return x;
}

// Row stride of the relation in words: odd, so 32 consecutive rows read at
// one word fall in 32 banks.
__host__ __device__ constexpr int row_stride(int words) { return words | 1; }

constexpr size_t smem_bytes(int words) {
  return sizeof(float) * 3 * 32 * words + sizeof(uint32_t) * (32 * words * row_stride(words) + 2 * 32);
}

// Blocks an SM must hold: up to 8 words (M <= 256), a full SM's 2048
// threads, so that 1000 states of 7 words run in one wave (at most 32
// registers); above, one.
__host__ __device__ constexpr int min_blocks(int words) {
  return words == 1 ? 32 : words <= kCappedWords ? 64 / words : 1;
}

// W = ceil(M / 32) words: every shared-memory offset is known at compile time.
template <int W>
__global__ void __launch_bounds__(32 * W, min_blocks(W))
nd_peel_kernel(const float* __restrict__ pop, const float* __restrict__ off, int32_t* __restrict__ ranks,
               int m, int p, int n_stop) {
  constexpr int kStride = row_stride(W);
  extern __shared__ float smem[];
  float* fx = smem;                                                 // (3, 32W)
  float* fy = fx + 32 * W;
  float* fz = fy + 32 * W;
  uint32_t* dom_by = reinterpret_cast<uint32_t*>(fz + 32 * W);      // (32W, kStride)
  uint32_t* rem = dom_by + 32 * W * kStride;                        // (2, 32)

  const int i = threadIdx.x;
  const int w = i >> 5, lane = i & 31;
  const float nan = __int_as_float(0x7fffffff);
  float mx = nan, my = nan, mz = nan;
  if (i < m) {
    const float* fi = merged_row(pop, off, blockIdx.x, i, m, p);
    // x + 0 turns -0 into +0 and leaves every other value as it is
    mx = __fadd_rn(fi[0], 0.0f);
    my = __fadd_rn(fi[1], 0.0f);
    mz = __fadd_rn(fi[2], 0.0f);
  }
  fx[i] = mx;
  fy[i] = my;
  fz[i] = mz;
  // a row with a NaN (and a lane past M) neither dominates nor is dominated
  const bool valid = !(isnan(mx) || isnan(my) || isnan(mz));
  const uint32_t valid_word = __ballot_sync(kAll, valid);
  bool alive = i < m;
  uint32_t rem_word = __ballot_sync(kAll, alive);
  if (lane == 0) rem[w] = rem_word & valid_word;
  __syncthreads();

  // the relation: warp w's share of the word pairs. For j = 32b + t the
  // bits shift in from the bottom and land on bit t after the 32 steps:
  // "j dominates i" into row i's word b, "i dominates j" into a word that
  // the transpose turns into row j's word w.
  uint32_t* row = dom_by + i * kStride;
#pragma unroll 1
  for (int k = 0; k <= W / 2; ++k) {
    if (W > kCappedWords && k > 0 && 2 * k == W && w >= W / 2) break;
    const int b = w + k < W ? w + k : w + k - W;
    const int jb = 32 * b;
    uint32_t by_j = 0;
    if (k == 0) {
#pragma unroll 8
      for (int t = 31; t >= 0; --t) {
        const float gx = fx[jb + t], gy = fy[jb + t], gz = fz[jb + t];
        // sign of up set: not mine <= g; sign of down clear: g <= mine
        const uint32_t up = below_or_equal(gx, gy, gz, mx, my, mz);
        const uint32_t down = below_or_equal(mx, my, mz, gx, gy, gz);
        by_j = __funnelshift_l(up & ~down, by_j, 1);
      }
    } else {
      uint32_t by_i = 0;
#pragma unroll 8
      for (int t = 31; t >= 0; --t) {
        const float gx = fx[jb + t], gy = fy[jb + t], gz = fz[jb + t];
        const uint32_t up = below_or_equal(gx, gy, gz, mx, my, mz);
        const uint32_t down = below_or_equal(mx, my, mz, gx, gy, gz);
        by_j = __funnelshift_l(up & ~down, by_j, 1);
        by_i = __funnelshift_l(down & ~up, by_i, 1);
      }
      dom_by[(jb + lane) * kStride + w] = transpose32(by_i, lane);
    }
    row[b] = by_j;
  }
  __syncthreads();

  // the peel over the remaining rows without NaN (rem); ranked and left
  // are uniform across the block
  int32_t rank = kUnranked;
  int ranked = 0, left = m;
  for (int r = 0; ranked < n_stop && left > 0; ++r) {
    const uint32_t* cur = rem + 32 * (r & 1);
    uint32_t hit = 0;
#pragma unroll
    for (int b = 0; b < W; ++b) hit |= row[b] & cur[b];
    const bool in_front = alive && (hit == 0u || !valid);
    rem_word &= ~__ballot_sync(kAll, in_front);
    if (lane == 0) rem[32 * ((r + 1) & 1) + w] = rem_word & valid_word;
    const int n = __syncthreads_count(in_front);
    if (n == 0) {  // safety branch: every remaining candidate takes r
      if (alive) rank = r;
      break;
    }
    if (in_front) {
      rank = r;
      alive = false;
    }
    ranked += n;
    left -= n;
  }
  if (i < m) ranks[static_cast<size_t>(blockIdx.x) * m + i] = rank;
}

// Launches nd_peel_kernel<words>; each instantiation keeps its own cache.
template <int W>
cudaError_t launch_words(int words, const float* pop, const float* off, int32_t* ranks, int n_states,
                         int m, int p, int n_stop, cudaStream_t stream) {
  if constexpr (W < kMaxWords) {
    if (words > W) return launch_words<W + 1>(words, pop, off, ranks, n_states, m, p, n_stop, stream);
  }
  static LaunchCache cache;
  const cudaError_t err = cache.prepare(reinterpret_cast<const void*>(nd_peel_kernel<W>),
                                        32 * W, smem_bytes(W), nullptr);
  if (err != cudaSuccess) return err;
  nd_peel_kernel<W><<<n_states, 32 * W, smem_bytes(W), stream>>>(pop, off, ranks, m, p, n_stop);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_nd_peel(const float* pop, const float* off, int32_t* ranks, int n_states,
                           int m, int p, int n_stop, cudaStream_t stream) {
  if (n_states == 0 || m == 0) return cudaSuccess;
  if (m < 0 || m > kNdPeelMaxCandidates || n_states < 0 || p < 0 || p > m) return cudaErrorInvalidValue;
  return launch_words<1>((m + 31) / 32, pop, off, ranks, n_states, m, p, n_stop, stream);
}
