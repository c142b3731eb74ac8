// Launchers of the port's hand-written Hopper kernels (one per .cu file).
// Each enqueues its kernel on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#if defined(__CUDACC__)
// min and max that give NaN when an input is NaN, as torch.minimum, amin,
// argmax and clamp do (fminf / fmaxf would drop it): one instruction each,
// no branch. A NaN result is the canonical NaN, whatever the input's
// payload.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// LCLD's month count of a YYYYMM date: torch.floor(a / 100) * 12 +
// torch.remainder(a, 100), the remainder fmod-based as PyTorch's
__device__ __forceinline__ float lcld_months(float a) {
  float rem = fmodf(a, 100.0f);
  if (rem != 0.0f && rem < 0.0f) rem = __fadd_rn(rem, 100.0f);
  return __fadd_rn(__fmul_rn(floorf(__fdiv_rn(a, 100.0f)), 12.0f), rem);
}

// Row j (3 floats) of state s of a generation's merged objectives
// [population (S, P, 3), offspring (S, M - P, 3)], read through the two
// pointers in place of a concatenated copy (off is not read when M = P).
__device__ __forceinline__ const float* merged_row(const float* pop, const float* off, size_t s, int j, int m,
                                                   int p) {
  return j < p ? pop + (s * p + j) * 3 : off + (s * (m - p) + (j - p)) * 3;
}
#endif

// Shared memory one block can use on Hopper (227 KB).
constexpr size_t kMaxSharedBytes = 232448;

// Largest candidate count per state nd_peel takes: the domination bitset of
// M rows of ceil(M/32) words must fit one block's shared memory.
constexpr int kNdPeelMaxCandidates = 1024;

// objective_lcld: LCLD's feature count, its constraint terms, the most XOR
// pairs of its augmented domain (C(10, 2): k = 10 important features; a
// row then holds 47 + P features, the pairs' last), and the relu stacks it
// takes (at most as many weights as fit one block's shared memory beside 8
// rows of D floats; the kernel stages them where they fit beside its row
// tiles).
constexpr int kLcldFeatures = 47;
constexpr int kLcldTerms = 10;
constexpr int kLcldMaxPairs = 45;
constexpr int kObjectiveMaxWidth = 128;
constexpr int kObjectiveMaxLayers = 8;
constexpr int kObjectiveMaxParams = (232448 / 4) - 8 * kLcldFeatures;

// associate: most directions per state (R), one state's unit directions
// padded to 16 bytes in one block's shared memory.
constexpr int kAssociateMaxDirections = kMaxSharedBytes / 16;

// survive_fill: largest candidate and direction counts per state (M, R);
// the archive ranks at most twice that many candidates.
constexpr int kSurviveMaxCandidates = 1024;

// survive_fill's arguments; flags: 1 = fill (ranks ... mask), 2 = extract
// (pop/off -> new_x/new_f, needs the fill), 4 = archive (a/b -> arch).
struct SurviveFillArgs {
  const int32_t* ranks;   // (S, M)
  const int64_t* niche;   // (S, M)
  const float* dist;      // (S, M)
  const float* gum_cut;   // (S, R)
  const float* gum_mem;   // (S, M)
  bool* mask;             // (S, M) out
  int n_survive;
  const float* pop_x;     // (S, P, L)
  const float* off_x;     // (S, M - P, L)
  const float* pop_f;     // (S, P, 3)
  const float* off_f;     // (S, M - P, 3)
  float* new_x;           // (S, P, L) out
  float* new_f;           // (S, P, 3) out
  int p;
  const float* a_x;       // (S, n_a, L)
  const float* a_f;       // (S, n_a, 3)
  const float* b_x;       // (S, n_b, L)
  const float* b_f;       // (S, n_b, 3)
  float* arch_x;          // (S, n_arch, L) out
  float* arch_f;          // (S, n_arch, 3) out
  int n_a, n_b, n_arch;
  int n_states, m, r, l, flags;
};

// One kernel's launch attributes per device, set and asked once per size of
// dynamic shared memory rather than at every launch: a launch is on the
// host's critical path. A launcher keeps one as a function-local static.
class LaunchCache {
 public:
  // Allows `kernel` `smem` bytes of dynamic shared memory on the current
  // device and, where `resident` is not null, sets it to the blocks of
  // `threads` threads that the whole device holds at once.
  cudaError_t prepare(const void* kernel, int threads, size_t smem, int* resident) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    Entry& e = entries_[device];
    if (smem > e.allowed) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      e.allowed = smem;
    }
    if (resident == nullptr) return cudaSuccess;
    if (e.resident == 0 || e.resident_smem != smem) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (err != cudaSuccess) return err;
      e.resident = (per_sm > 0 ? per_sm : 1) * sms;
      e.resident_smem = smem;
    }
    *resident = e.resident;
    return cudaSuccess;
  }

  // The current device's number of SMs.
  cudaError_t sm_count(int* sms) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    Entry& e = entries_[device];
    if (e.sms == 0) {
      err = cudaDeviceGetAttribute(&e.sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
    }
    *sms = e.sms;
    return cudaSuccess;
  }

 private:
  static constexpr int kDevices = 64;
  struct Entry {
    size_t allowed = 0;        // dynamic shared memory allowed so far
    size_t resident_smem = 0;  // the size `resident` was asked for
    int resident = 0;
    int sms = 0;
  };
  std::mutex mu_;
  Entry entries_[kDevices];
};

// K2, K4a and K3 read the merged objectives (S, M, 3) as [pop (S, P, 3),
// off (S, M - P, 3)] (merged_row); P = M takes pop alone (off may be null).
cudaError_t launch_nd_peel(const float* pop, const float* off, int32_t* ranks, int n_states,
                           int m, int p, int n_stop, cudaStream_t stream);

cudaError_t launch_associate(const float* pop, const float* off, const float* dirs,
                             const float* ideal, const float* nadir,
                             int64_t* niche, float* dist, int n_states, int m, int p,
                             int r, cudaStream_t stream);

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
                             cudaStream_t stream);

// record: null, or the (S * N, 3 + 10 + n_pairs) history record that the
// kHistory instantiations write beside out: each row's objectives, then its
// kept constraint terms in the sum's order.
cudaError_t launch_objective_lcld(
    const float* x_gen, const float* x_init, const float* xl, const float* xu,
    const float* x_init_mm, const int64_t* min_class, const int32_t* feat_gene,
    const int32_t* feat_onehot, const float* params, const int* widths,
    int n_layers, const float* scale, const float* offset, float f2_scale,
    int norm_inf, float tol, float* out, float* record, int n_states, int n, int l, int d,
    const int32_t* pair_idx, const float* pair_thr, int n_pairs,
    cudaStream_t stream);

cudaError_t launch_survive_norm(const float* pop, const float* off, const int32_t* ranks,
                                const float* asp, const float* ideal_in,
                                const float* worst_in, const float* extreme_in,
                                float* ideal, float* worst, float* extreme,
                                float* nadir, float* dirs, int n_states, int m, int p,
                                int a, cudaStream_t stream);

cudaError_t launch_survive_fill(const SurviveFillArgs& args, cudaStream_t stream);

// pgd_lcld: the most rows a block runs (one lane each in its per-row
// chains), and the one-hot slots (groups x slots per group) it stages.
constexpr int kPgdMaxRows = 32;
constexpr int kPgdMaxOheSlots = 1024;

// pgd_lcld's arguments, for D = 47 + n_pairs features (n_pairs = 0: the
// base domain; else the augmented one, its pairs' features last). flags: 1 =
// L-inf (else L2), 2 = repair, 4 = targeted, 8 = the grad-norm history
// column, 16 = the violations' columns, 32 = AutoPGD (x_adv is then the
// best point, and the fields after n_pairs are read).
struct PgdArgs {
  const float* x_init;    // (N, D)
  const float* x_start;   // (N, D)
  const int64_t* y;       // (N,) labels
  const bool* mutable_;   // (D,)
  const float* params;    // each layer's weight (out, in), then its bias
  const float* scale;     // (D,) x_scaled = x * scale + min_
  const float* min_;      // (D,)
  const int32_t* ohe;     // (n_groups, group_slots) feature per slot, -1 = padding
  const float* w_class;   // (T,) schedule
  const float* w_cons;    // (T,)
  const float* step;      // (T,)
  const int32_t* ctr;     // (T,) constraint optimised, -1 = their sum
  float* x_adv;           // (N, D) out
  int64_t* pred;          // (N,) out: class at x_adv
  float* hist;            // (T, N, hist_cols) out, or null
  int n, t, n_groups, group_slots, hist_cols, flags;
  float eps, lo, hi, tol;
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
  int d;                     // features
  const int32_t* pair_idx;   // (n_pairs, 2) base features of each pair
  const float* pair_thr;     // (n_pairs, 2) their thresholds
  int n_pairs;
  // AutoPGD: iteration i ends at a checkpoint where is_ckpt[i + 1], and
  // halves a row's step there where its tracking loss rose fewer than
  // ckpt_thr[i + 1] times since the last one (or neither the step nor the
  // best loss moved); the tracking loss tw_class * CE - tw_cons * cons, its
  // constraint tctr (-1 = their sum); every row's first step eta0; the
  // momentum alpha (1 at iteration 0)
  const bool* is_ckpt;      // (T + 1,)
  const float* ckpt_thr;    // (T + 1,)
  float tw_class, tw_cons, eta0, alpha;
  int tctr;
  float* eta;               // (N,) out: each row's step after the last iteration
};

cudaError_t launch_pgd_lcld(const PgdArgs& args, cudaStream_t stream);

// objective_botnet: the widest layer it takes (a hidden layer's outputs fill
// one activation buffer of the tile), the segments of its gather lists, and
// the most XOR pairs of the augmented botnet domain (C(20, 2): k = 20
// important features; the reference's defense takes k = 19, 171 pairs; a
// row then holds 756 + P features, the pairs' last).
constexpr int kBotnetMaxWidth = 64;
constexpr int kBotnetSegments = 12;
constexpr int kBotnetMaxPairs = 190;

// objective_botnet's arguments. The gather lists `cons` hold, in order, the
// segments of `counts`: flows and bytes of direction s, of direction d (the
// two flow equalities), the ratio's bytes and pkts, then the lower and the
// upper features of each of the three orderings.
struct BotnetObjectiveArgs {
  const float* x_gen;       // (S * N, L)
  const float* x_init;      // (S, D)
  const float* xl;          // (S, D)
  const float* xu;          // (S, D)
  const float* x_init_mm;   // (S, D)
  const int64_t* min_class; // (S,)
  const int32_t* feat_gene;   // (D,)
  const int32_t* feat_onehot; // (D,)
  const float* params;      // each layer's weight (out, in), then its bias
  const float* first_t;     // (D, widths[1]) the first layer's weight transposed
  const float* scale;       // (D,) or null
  const float* offset;      // (D,) or null
  const int32_t* cons;      // the gather lists
  int counts[kBotnetSegments];
  float f2_scale;
  int norm_inf;
  float tol;
  float* out;               // (S * N, 3)
  // null, or the (S * N, 3 + n_terms) history record that the kHistory
  // instantiations write beside out: each row's objectives, then its kept
  // terms in the sum's order (n_terms = 360 + n_pairs on the real tables)
  float* record;
  int n_rows, n, l, d;
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
  // the augmented domain (n_pairs > 0, d = 756 + n_pairs): the pairs' base
  // features and their thresholds; null and 0 on the base domain
  const int32_t* pair_idx;  // (n_pairs, 2)
  const float* pair_thr;    // (n_pairs, 2)
  int n_pairs;
};

cudaError_t launch_objective_botnet(BotnetObjectiveArgs args, cudaStream_t stream);

// The most features objective_botnet takes with a first layer of h1 units,
// n_entries entries in the gather lists and n_pairs XOR pairs: a tile's
// features, the first layer's double buffers, the gather lists and the pair
// tables fit one block's shared memory.
int objective_botnet_max_features(int h1, int n_entries, int n_pairs);

// pgd_botnet: botnet's feature count, the XOR pairs of the augmented
// domain's instantiation (C(19, 2): the reference's k = 19 important
// features; rows of 756 + 171 = 927 features, another pair count is
// refused), the most rows a cluster takes (as many as fit beside the
// staged layer), and the most entries per feature of the inverse table.
// Each CTA of its cluster of two runs a thread per feature of its share
// (pgd_botnet.cu's Dims: 384 threads at 756 features, 480 at 927).
constexpr int kBotnetFeatures = 756;
constexpr int kPgdBotnetAugPairs = 171;
constexpr int kPgdBotnetMaxRows = 6;
constexpr int kPgdBotnetMaxDegree = 16;

// pgd_botnet's arguments: pgd_lcld's (the same flags, 32 = AutoPGD with
// the same tables and scalars) for (N, D) rows, D = 756 or 756 +
// kPgdBotnetAugPairs, with the first layer's transposed copy, the 360 base
// terms' gather lists (objective_botnet's layout) and their inverse, and on
// the augmented domain the pairs' tables (objective_botnet's).
struct PgdBotnetArgs {
  const float* x_init;    // (N, D)
  const float* x_start;   // (N, D)
  const int64_t* y;       // (N,) labels
  const bool* mutable_;   // (D,)
  const float* params;    // each layer's weight (out, in), then its bias
  const float* first_t;   // (D, widths[1]) the first layer's weight transposed
  const float* scale;     // (D,) x_scaled = x * scale + min_
  const float* min_;      // (D,)
  const int32_t* cons;    // the gather lists, segments of `counts`
  int counts[kBotnetSegments];
  const int32_t* inverse; // (D, degree) entries of each feature in term order, -1 after them
  int degree;
  const float* w_class;   // (T,) schedule
  const float* w_cons;    // (T,)
  const float* step;      // (T,)
  const int32_t* ctr;     // (T,) term optimised, -1 = their sum
  float* x_adv;           // (N, D) out
  int64_t* pred;          // (N,) out: class at x_adv
  float* hist;            // (T, N, hist_cols) out, or null
  int n, t, hist_cols, flags;
  float eps, lo, hi, tol;
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
  int rows;               // rows per cluster, set by the launcher
  // AutoPGD (flags & 32): pgd_lcld's fields of the same names
  const bool* is_ckpt;    // (T + 1,)
  const float* ckpt_thr;  // (T + 1,)
  float tw_class, tw_cons, eta0, alpha;
  int tctr;               // the tracking loss's term, -1 = their sum
  float* eta;             // (N,) out: each row's step after the last iteration
  // the augmented domain (n_pairs = kPgdBotnetAugPairs, D = 756 + n_pairs,
  // no repair): the pairs' base features and float32 thresholds, their terms
  // after the 360 base ones; null and 0 on the base domain
  const int32_t* pair_idx;  // (n_pairs, 2)
  const float* pair_thr;    // (n_pairs, 2)
  int n_pairs;
};

cudaError_t launch_pgd_botnet(PgdBotnetArgs args, cudaStream_t stream);

// gate_repack (K6a): per-state gate statistics (S, 9) of the objectives of
// population (S, p, 3) and archive (S, a, 3; null when a = 0).
cudaError_t launch_gate_stats(const float* pop_f, const float* arch_f, float* out,
                              int n_states, int p, int a, float thr, float eps,
                              cudaStream_t stream);

// gate_repack (K6b): a gather over the states axis of up to
// kTakeMaxSegments row-major leaves at n_idx int64 indices in [0, n_src).
constexpr int kTakeMaxSegments = 8;

struct TakeSegment {
  const float* src;    // (n_src, row_elems)
  float* dst;          // row b's words at b * dst_stride + dst_offset
  int64_t row_elems;
  int64_t dst_stride;
  int64_t dst_offset;
};

struct TakeArgs {
  TakeSegment seg[kTakeMaxSegments];
  int n_seg;
  const int64_t* idx;  // (n_idx,)
  int n_idx;
  int64_t n_src;
};

cudaError_t launch_take(const TakeArgs& args, cudaStream_t stream);

// objective_spec (K9): the limits of the constraint programs it runs
// (domains/ir/program.py lowers a spec to them and refuses one past a
// limit) and the widest layer it takes. At the largest tile that fits (32
// rows) a program of kSpecMaxInstructions instructions, kSpecMaxFeatures
// features, kSpecMaxSlots slots, an activation buffer of kSpecMaxWidth
// units and the weight stage take 188,416 bytes of one block's shared
// memory.
constexpr int kSpecMaxInstructions = 2048;
constexpr int kSpecMaxSlots = 32;
constexpr int kSpecMaxTerms = 1024;
constexpr int kSpecMaxFeatures = 1024;
constexpr int kSpecMaxWidth = 128;

// objective_spec's arguments: K1's, with the spec's program `code`
// (n_instr instructions of four int32 words: op and operand kinds, dst, a,
// b; 16-byte aligned) in place of the hard-coded terms.
struct SpecObjectiveArgs {
  const float* x_gen;         // (S * N, L)
  const float* x_init;        // (S, D)
  const float* xl;            // (S, D)
  const float* xu;            // (S, D)
  const float* x_init_mm;     // (S, D)
  const int64_t* min_class;   // (S,)
  const int32_t* feat_gene;   // (D,)
  const int32_t* feat_onehot; // (D,)
  const float* params;        // each layer's weight (out, in), then its bias
  const float* first_t;       // (D, widths[1]) the first layer's weight transposed
  const float* scale;         // (D,) or null
  const float* offset;        // (D,) or null
  const int32_t* code;        // (n_instr, 4)
  int n_instr, n_slots, n_terms;
  float f2_scale;
  int norm_inf;
  float tol;
  float* out;                 // (S * N, 3)
  // null, or the (S * N, 3 + n_terms) history record that the kHistory
  // instantiation writes beside out: each row's objectives, then its kept
  // terms in the sum's order
  float* record;
  int n_rows, n, l, d;
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
  int w_max;                  // the widest layer, set by the launcher
};

cudaError_t launch_objective_spec(SpecObjectiveArgs args, cudaStream_t stream);

// The rows of objective_spec's tile for a program of n_instr instructions
// and n_slots slots over d features with layers of at most w_max units (0:
// none fits one block's shared memory).
int objective_spec_tile_rows(int n_instr, int d, int n_slots, int w_max);

// pgd_spec (K10): constrained PGD and AutoPGD on a domain compiled from a
// spec, its terms, their backward and its repair run from the programs that
// domains/ir/program.py lowers (lower_spec_vjp, lower_spec_repair), which
// refuses a spec past a limit: at most kSpecVjpMaxInstructions instructions
// a program (read from global memory) and kSpecVjpMaxSlots slots (a
// thread's local array); the features and terms of K9's limits. The block
// runs at most kPgdSpecMaxRows rows on kPgdSpecThreads threads; hidden
// layers of at most kSpecMaxWidth units.
constexpr int kSpecVjpMaxInstructions = 16384;
constexpr int kSpecVjpMaxSlots = 64;
constexpr int kPgdSpecMaxRows = 32;
constexpr int kPgdSpecThreads = 256;

// pgd_spec's arguments: pgd_lcld's flags and AutoPGD fields (flags & 32),
// the stack's first layer transposed, and the two programs (n_vjp and
// n_repair instructions of four int32 words, 16-byte aligned; the reverse
// program's n_terms HEADs and n_acc contributions, where each term starts
// and, per feature, which contributions it sums).
struct PgdSpecArgs {
  const float* x_init;    // (N, D)
  const float* x_start;   // (N, D)
  const int64_t* y;       // (N,) labels
  const bool* mutable_;   // (D,)
  const float* params;    // each layer's weight (out, in), then its bias
  const float* first_t;   // (D, widths[1]) the first layer's weight transposed
  const float* scale;     // (D,) x_scaled = x * scale + min_
  const float* min_;      // (D,)
  const int32_t* ohe;     // (n_groups, group_slots) feature per slot, -1 = padding
  const float* w_class;   // (T,) schedule
  const float* w_cons;    // (T,)
  const float* step;      // (T,)
  const int32_t* ctr;     // (T,) constraint optimised, -1 = their sum
  const int32_t* vjp;     // (n_vjp, 4) the reverse program
  const int32_t* repair;  // (n_repair, 4) the repair program
  const int32_t* term_start;  // (n_terms + 1,) each term's first instruction, then n_vjp
  const int32_t* acc_ptr;     // (D + 1,) each feature's contributions in acc_idx
  const int32_t* acc_idx;     // (n_acc,) their indices, in program order
  float* x_adv;           // (N, D) out
  int64_t* pred;          // (N,) out: class at x_adv
  float* hist;            // (T, N, hist_cols) out, or null
  int n, t, d, n_groups, group_slots, hist_cols, flags;
  int n_vjp, n_repair, n_terms, n_acc;
  float eps, lo, hi, tol;
  int n_layers;
  int widths[kObjectiveMaxLayers + 1];
  const bool* is_ckpt;      // (T + 1,)
  const float* ckpt_thr;    // (T + 1,)
  float tw_class, tw_cons, eta0, alpha;
  int tctr;
  float* eta;               // (N,) out
};

cudaError_t launch_pgd_spec(const PgdSpecArgs& args, cudaStream_t stream);

// The most rows of d features one pgd_spec block's shared memory holds for
// the stack of n_layers layers of the given widths and a reverse program of
// n_terms terms and n_acc contributions (0: not one row, or a width out of
// range).
int pgd_spec_block_rows(int d, const int* widths, int n_layers, int n_terms, int n_acc, int autopgd);

// train_step (K11) and input_grad (K12): a relu stack of n_layers dense
// layers (widths[0] inputs, widths[n_layers] = 2 classes), its parameters
// one flat float32 buffer, layer by layer the weight (out, in) row-major
// then the bias (out,). A block runs kTrainTileRows rows on kTrainThreads
// threads, every activation and cotangent of its rows in shared memory.
constexpr int kTrainTileRows = 16;
constexpr int kTrainThreads = 256;
constexpr int kTrainMaxLayers = 8;

struct TrainShape {
  int n_layers;
  int widths[kTrainMaxLayers + 1];
  int64_t w_off[kTrainMaxLayers];  // layer l's weight in the flat buffer
  int64_t b_off[kTrainMaxLayers];  // and its bias
  int64_t n_params;
};

// The shape of the stack of the given widths (false: a layer count or a
// width out of range, or not 2 classes).
bool train_shape(const int* widths, int n_layers, TrainShape* shape);

// Bytes of dynamic shared memory a train_step or input_grad block takes for
// the stack (0: more than one block's shared memory).
size_t train_tile_smem_bytes(const TrainShape& shape);

// Optax's Adam as K11 applies it: the float32 constants (1 - b1, b1,
// 1 - b2, b2, eps, -lr) and the bias corrections 1 - b**count, computed in
// float64 on the host and rounded once.
struct AdamScalars {
  float c1, b1, c2, b2, bc1, bc2, eps, neg_lr;
};

// K11 step: launch 1 writes each tile's partial gradients (n_tiles,
// n_params) into part_grad and its partial sums of w * cw[y] * loss and w
// into part_loss (n_tiles, 2); launch 2 sums them, divides by max(sum w,
// 1e-12), updates params, mu and nu in place and writes the step's loss.
cudaError_t launch_train_step(const float* x, const int64_t* y, const float* w, const float* cw,
                              float* params, float* mu, float* nu, const TrainShape& shape, int n,
                              const AdamScalars& adam, float* part_grad, float* part_loss,
                              float* loss, cudaStream_t stream);

// K11's loss-only instantiation: each tile's partial sum of cw[y] * loss
// into part_loss (n_tiles,).
cudaError_t launch_train_loss(const float* x, const int64_t* y, const float* cw,
                              const float* params, const TrainShape& shape, int n,
                              float* part_loss, cudaStream_t stream);

// K12: per row the gradient of the softmax's class-0 probability with
// respect to the row, into out (n, widths[0]).
cudaError_t launch_input_grad(const float* x, const float* params, const TrainShape& shape, int n,
                              float* out, cudaStream_t stream);

// draws (K0): the fields of one call of the Philox4x32-10 stream
// (core/philox.py). A field's element i lies in block base + first + i / per
// at slot i % per (per 2 for normals, else 4); `out` is float for the
// uniform, symmetric, gumbel and normal kinds and int64 for integers and
// cuts. Kinds as core/philox.py numbers them.
constexpr int kDrawMaxFields = 8;
enum DrawKind : int32_t {
  kDrawUniform = 0,
  kDrawSymmetric = 1,
  kDrawInteger = 2,
  kDrawCut = 3,
  kDrawGumbel = 4,
  kDrawNormal = 5,
};

struct DrawField {
  void* out;
  int64_t numel;
  int64_t first;   // the field's first block, relative to the call's base
  int32_t kind;
  uint32_t n;      // an integer field's exclusive bound
};

struct DrawArgs {
  DrawField field[kDrawMaxFields];
  int32_t n_fields;
  uint32_t key0, key1;
  uint64_t base;   // the call's first block
  int64_t total;   // the call's blocks
};

cudaError_t launch_draws(const DrawArgs& args, cudaStream_t stream);

// draws (K0) for PGD's random start: the fields of `draws` (a direction
// (n, d), symmetric under L-inf or normal under L2, then under L2 a
// uniform radius (n, 1)) are consumed, not written; x_start (n, d) =
// clamp(x_init + where(mutable, pert, 0), lo, hi).
struct PgdStartArgs {
  DrawArgs draws;
  const float* x_init;          // (n, d)
  const bool* mutable_mask;     // (d,)
  float* x_start;               // (n, d)
  float lo, hi, eps;
  double exponent;              // 1 / d
  int32_t norm_inf;
  int32_t n, d;
};

cudaError_t launch_pgd_start(const PgdStartArgs& args, cudaStream_t stream);

// chunk_io (K13a): a chunk's bounds, normalised initial states, initial
// population and normalisation memory from its states x and feature
// bounds xl, xu (S, d). Gene j < n1 is feature gene_feat[j]; gene j >= n1
// is one-hot group gene_feat[j], whose members are group_idx[g * k ..] (-1
// pads last). pop, ideal (and worst, extreme) and ball may be null.
struct ChunkPrepareArgs {
  const float* x;
  const float* xl;
  const float* xu;
  const int32_t* gene_feat;    // (l,)
  const int32_t* group_idx;    // (n_groups, k)
  const bool* int_gene;        // (l,)
  const float* ball;           // (S, n_pert, ball_cols): lp_ratio's draws
  float* xl_gen;               // (S, l)
  float* xu_gen;               // (S, l)
  float* x_mm;                 // (S, d)
  float* pop;                  // (S, p, l)
  float* ideal;                // (S, 3): +inf
  float* worst;                // (S, 3): -inf
  float* extreme;              // (S, 3, 3): 1e16
  int32_t n_states, d, l, n1, n_groups, k;
  int32_t p, n_pert, ball_cols, norm_inf;
  float eps;
};

cudaError_t launch_chunk_prepare(const ChunkPrepareArgs& args, cudaStream_t stream);

// chunk_io (K13b): a chunk's returned columns, population then archive,
// and their decode to ML space: feature j is x_init's where feat_gene[j] <
// 0, gene feat_gene[j] where feat_onehot[j] < 0, else 1 where that
// categorical gene rounds to feat_onehot[j] and 0 elsewhere.
struct ChunkDecodeArgs {
  const float* pop_x;          // (S, p, l)
  const float* arch_x;         // (S, a, l)
  const float* pop_f;          // (S, p, 3)
  const float* arch_f;         // (S, a, 3)
  const float* x_init;         // (S, d)
  const int32_t* feat_gene;    // (d,)
  const int32_t* feat_onehot;  // (d,)
  float* x_gen;                // (S, p + a, l)
  float* f;                    // (S, p + a, 3)
  float* x_ml;                 // (S, p + a, d)
  int32_t n_states, p, a, l, d;
};

cudaError_t launch_chunk_decode(const ChunkDecodeArgs& args, cudaStream_t stream);

// refdirs (K14): the reference directions' energy descent, one cluster of
// CTAs, a thread a point (at most kRefdirsMaxPoints points of at most
// kRefdirsMaxDim dimensions). theta0 and out are (n, n_dim) float64, sched
// (n_iter, 3) float64: each step's learning rate and bias corrections
// 1 - b1**t, 1 - b2**t; s is the energy's exponent.
constexpr int kRefdirsMaxPoints = 1024;
constexpr int kRefdirsMaxDim = 4;

// optax Adam's constants as the twin writes them: 1 - b1, b1, 1 - b2, b2,
// eps.
struct RefdirsAdam {
  double c1, b1, c2, b2, eps;
};

cudaError_t launch_refdirs(const double* theta0, const double* sched, double* out, int n, int n_dim, int n_iter,
                           double s, const RefdirsAdam& adam, cudaStream_t stream);

// refdirs' launch for n points of n_dim dimensions on the current device:
// out[0..4] = the cluster's CTAs (the grid), points a CTA, points j a
// weight tile, threads a CTA, dynamic shared memory a CTA in bytes.
cudaError_t refdirs_shape(int n, int n_dim, int* out);

// restart (K15): PGD's arbitration after one start's run. best_x may alias
// prev_x and best_hist prev_hist; prev_success and prev_hist are null
// before the first start; hist, prev_hist and best_hist are null without a
// history.
struct RestartArgs {
  const float* x_adv;          // (n, d)
  const int64_t* pred;         // (n,)
  const int64_t* y;            // (n,)
  const float* hist;           // (t, n, c)
  const float* prev_x;         // (n, d)
  float* best_x;               // (n, d) out
  const float* prev_hist;      // (t, n, c)
  float* best_hist;            // (t, n, c) out
  const bool* prev_success;    // (n,)
  bool* success;               // (n,) out
  int32_t n, d, t, c, targeted;
};

cudaError_t launch_restart(const RestartArgs& args, cudaStream_t stream);

// mlp_forward (K16): a relu stack of n_layers dense layers (widths[0]
// inputs, hidden widths and the 1 or 2 classes at most kForwardMaxWidth),
// its parameters one flat buffer, layer by layer the weight (out, in)
// row-major then the bias (out,).
constexpr int kForwardMaxLayers = 8;
constexpr int kForwardMaxWidth = 256;

struct ForwardShape {
  int32_t n_layers;
  int32_t widths[kForwardMaxLayers + 1];
};

// float32 rows (n, widths[0]) -> int64 labels (n,).
cudaError_t launch_forward_labels(const float* x, const float* params, const ForwardShape& shape, int n,
                                  int64_t* labels, cudaStream_t stream);

// float64 rows (n, widths[0]) -> the class-1 probabilities (n,).
cudaError_t launch_forward_proba1(const double* x, const double* params, const ForwardShape& shape, int n,
                                  double* proba1, cudaStream_t stream);
