// Plain C interface of the port's kernels, loaded from Python with ctypes.
//
// Pointers are device addresses (torch.Tensor.data_ptr()), the stream is
// torch.cuda.current_stream().cuda_stream. Each function returns a
// cudaError_t as int: 0 on a successful launch; moeva_error_string names any
// other value. The Python wrappers check device, dtype, shape and
// contiguity before calling.

#include <climits>

#include <cuda_runtime.h>

#include "csrc/kernels.h"

extern "C" {

// K2, K4a and K3 take the merged objectives as pop (S, P, 3) and off (S, M
// - P, 3); off may be null when P = M.
int moeva_nd_peel_f32(const void* pop, const void* off, void* ranks, int n_states, int m, int p,
                      int n_stop, void* stream) {
  return static_cast<int>(launch_nd_peel(
      static_cast<const float*>(pop), static_cast<const float*>(off), static_cast<int32_t*>(ranks), n_states,
      m, p, n_stop, static_cast<cudaStream_t>(stream)));
}

int moeva_associate_f32(const void* pop, const void* off, const void* dirs, const void* ideal,
                        const void* nadir, void* niche, void* dist,
                        int n_states, int m, int p, int r, void* stream) {
  return static_cast<int>(launch_associate(
      static_cast<const float*>(pop), static_cast<const float*>(off), static_cast<const float*>(dirs),
      static_cast<const float*>(ideal), static_cast<const float*>(nadir),
      static_cast<int64_t*>(niche), static_cast<float*>(dist), n_states, m, p, r,
      static_cast<cudaStream_t>(stream)));
}

int moeva_offspring_f32(const void* pop, const void* xl, const void* xu,
                        const void* pairs, const void* cut_a, const void* cut_b,
                        const void* coins, const void* mut_select,
                        const void* mut_u, const void* type_id,
                        const void* rank_in_type, const void* mut_prob,
                        const void* int_mask, long long n_real, long long n_int,
                        long long n_softmax, void* out, int n_states, int p,
                        int l, int n_off, int n_mat, float prob, double eta_p1,
                        double mut_pow, void* stream) {
  const int64_t sizes[3] = {n_real, n_int, n_softmax};
  return static_cast<int>(launch_offspring(
      static_cast<const float*>(pop), static_cast<const float*>(xl),
      static_cast<const float*>(xu), static_cast<const int64_t*>(pairs),
      static_cast<const int64_t*>(cut_a), static_cast<const int64_t*>(cut_b),
      static_cast<const float*>(coins), static_cast<const float*>(mut_select),
      static_cast<const float*>(mut_u), static_cast<const int64_t*>(type_id),
      static_cast<const int64_t*>(rank_in_type),
      static_cast<const double*>(mut_prob), static_cast<const bool*>(int_mask),
      sizes, static_cast<float*>(out), n_states, p, l, n_off, n_mat, prob,
      eta_p1, mut_pow, static_cast<cudaStream_t>(stream)));
}

int moeva_objective_lcld_f32(const void* x_gen, const void* x_init,
                             const void* xl, const void* xu,
                             const void* x_init_mm, const void* min_class,
                             const void* feat_gene, const void* feat_onehot,
                             const void* params, const int* widths,
                             int n_layers, const void* scale,
                             const void* offset, float f2_scale, int norm_inf,
                             float tol, void* out, void* record, int n_states,
                             int n, int l, int d, const void* pair_idx,
                             const void* pair_thr, int n_pairs, void* stream) {
  return static_cast<int>(launch_objective_lcld(
      static_cast<const float*>(x_gen), static_cast<const float*>(x_init),
      static_cast<const float*>(xl), static_cast<const float*>(xu),
      static_cast<const float*>(x_init_mm),
      static_cast<const int64_t*>(min_class),
      static_cast<const int32_t*>(feat_gene),
      static_cast<const int32_t*>(feat_onehot),
      static_cast<const float*>(params), widths, n_layers,
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      f2_scale, norm_inf, tol, static_cast<float*>(out),
      static_cast<float*>(record), n_states, n, l, d,
      static_cast<const int32_t*>(pair_idx),
      static_cast<const float*>(pair_thr), n_pairs,
      static_cast<cudaStream_t>(stream)));
}

int moeva_survive_norm_f32(const void* pop, const void* off, const void* ranks, const void* asp,
                           const void* ideal_in, const void* worst_in,
                           const void* extreme_in, void* ideal, void* worst,
                           void* extreme, void* nadir, void* dirs,
                           int n_states, int m, int p, int a, void* stream) {
  return static_cast<int>(launch_survive_norm(
      static_cast<const float*>(pop), static_cast<const float*>(off), static_cast<const int32_t*>(ranks),
      static_cast<const float*>(asp), static_cast<const float*>(ideal_in),
      static_cast<const float*>(worst_in),
      static_cast<const float*>(extreme_in), static_cast<float*>(ideal),
      static_cast<float*>(worst), static_cast<float*>(extreme),
      static_cast<float*>(nadir), static_cast<float*>(dirs), n_states, m, p, a,
      static_cast<cudaStream_t>(stream)));
}

int moeva_survive_fill_f32(const void* ranks, const void* niche,
                           const void* dist, const void* gum_cut,
                           const void* gum_mem, void* mask, int n_survive,
                           const void* pop_x, const void* off_x,
                           const void* pop_f, const void* off_f, void* new_x,
                           void* new_f, int p, const void* a_x,
                           const void* a_f, const void* b_x, const void* b_f,
                           void* arch_x, void* arch_f, int n_a, int n_b,
                           int n_arch, int n_states, int m, int r, int l,
                           int flags, void* stream) {
  SurviveFillArgs args;
  args.ranks = static_cast<const int32_t*>(ranks);
  args.niche = static_cast<const int64_t*>(niche);
  args.dist = static_cast<const float*>(dist);
  args.gum_cut = static_cast<const float*>(gum_cut);
  args.gum_mem = static_cast<const float*>(gum_mem);
  args.mask = static_cast<bool*>(mask);
  args.n_survive = n_survive;
  args.pop_x = static_cast<const float*>(pop_x);
  args.off_x = static_cast<const float*>(off_x);
  args.pop_f = static_cast<const float*>(pop_f);
  args.off_f = static_cast<const float*>(off_f);
  args.new_x = static_cast<float*>(new_x);
  args.new_f = static_cast<float*>(new_f);
  args.p = p;
  args.a_x = static_cast<const float*>(a_x);
  args.a_f = static_cast<const float*>(a_f);
  args.b_x = static_cast<const float*>(b_x);
  args.b_f = static_cast<const float*>(b_f);
  args.arch_x = static_cast<float*>(arch_x);
  args.arch_f = static_cast<float*>(arch_f);
  args.n_a = n_a;
  args.n_b = n_b;
  args.n_arch = n_arch;
  args.n_states = n_states;
  args.m = m;
  args.r = r;
  args.l = l;
  args.flags = flags;
  return static_cast<int>(
      launch_survive_fill(args, static_cast<cudaStream_t>(stream)));
}

int moeva_pgd_lcld_f32(const void* x_init, const void* x_start, const void* y,
                       const void* mutable_, const void* params,
                       const int* widths, int n_layers, const void* scale,
                       const void* min_, const void* ohe, int n_groups,
                       int group_slots, const void* w_class, const void* w_cons,
                       const void* step, const void* ctr, void* x_adv,
                       void* pred, void* hist, int hist_cols, int n, int t,
                       float eps, float lo, float hi, float tol, int flags,
                       int d, const void* pair_idx, const void* pair_thr,
                       int n_pairs, const void* is_ckpt, const void* ckpt_thr,
                       float tw_class, float tw_cons, int tctr, float eta0,
                       float alpha, void* eta, void* stream) {
  if (n_layers < 1 || n_layers > kObjectiveMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  PgdArgs args{};
  args.x_init = static_cast<const float*>(x_init);
  args.x_start = static_cast<const float*>(x_start);
  args.y = static_cast<const int64_t*>(y);
  args.mutable_ = static_cast<const bool*>(mutable_);
  args.params = static_cast<const float*>(params);
  args.scale = static_cast<const float*>(scale);
  args.min_ = static_cast<const float*>(min_);
  args.ohe = static_cast<const int32_t*>(ohe);
  args.w_class = static_cast<const float*>(w_class);
  args.w_cons = static_cast<const float*>(w_cons);
  args.step = static_cast<const float*>(step);
  args.ctr = static_cast<const int32_t*>(ctr);
  args.x_adv = static_cast<float*>(x_adv);
  args.pred = static_cast<int64_t*>(pred);
  args.hist = static_cast<float*>(hist);
  args.n = n;
  args.t = t;
  args.n_groups = n_groups;
  args.group_slots = group_slots;
  args.hist_cols = hist_cols;
  args.flags = flags;
  args.eps = eps;
  args.lo = lo;
  args.hi = hi;
  args.tol = tol;
  args.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) args.widths[l] = widths[l];
  args.d = d;
  args.pair_idx = static_cast<const int32_t*>(pair_idx);
  args.pair_thr = static_cast<const float*>(pair_thr);
  args.n_pairs = n_pairs;
  args.is_ckpt = static_cast<const bool*>(is_ckpt);
  args.ckpt_thr = static_cast<const float*>(ckpt_thr);
  args.tw_class = tw_class;
  args.tw_cons = tw_cons;
  args.tctr = tctr;
  args.eta0 = eta0;
  args.alpha = alpha;
  args.eta = static_cast<float*>(eta);
  return static_cast<int>(
      launch_pgd_lcld(args, static_cast<cudaStream_t>(stream)));
}

int moeva_objective_botnet_f32(const void* x_gen, const void* x_init,
                               const void* xl, const void* xu,
                               const void* x_init_mm, const void* min_class,
                               const void* feat_gene, const void* feat_onehot,
                               const void* params, const void* first_t,
                               const void* scale, const void* offset,
                               const void* cons, const int* counts,
                               const int* widths, int n_layers, float f2_scale,
                               int norm_inf, float tol, void* out, void* record,
                               int n_states, int n, int l, int d, const void* pair_idx,
                               const void* pair_thr, int n_pairs, void* stream) {
  if (n_layers < 1 || n_layers > kObjectiveMaxLayers ||
      static_cast<long long>(n_states) * n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  BotnetObjectiveArgs args{};
  args.x_gen = static_cast<const float*>(x_gen);
  args.x_init = static_cast<const float*>(x_init);
  args.xl = static_cast<const float*>(xl);
  args.xu = static_cast<const float*>(xu);
  args.x_init_mm = static_cast<const float*>(x_init_mm);
  args.min_class = static_cast<const int64_t*>(min_class);
  args.feat_gene = static_cast<const int32_t*>(feat_gene);
  args.feat_onehot = static_cast<const int32_t*>(feat_onehot);
  args.params = static_cast<const float*>(params);
  args.first_t = static_cast<const float*>(first_t);
  args.scale = static_cast<const float*>(scale);
  args.offset = static_cast<const float*>(offset);
  args.cons = static_cast<const int32_t*>(cons);
  for (int k = 0; k < kBotnetSegments; ++k) args.counts[k] = counts[k];
  args.f2_scale = f2_scale;
  args.norm_inf = norm_inf;
  args.tol = tol;
  args.out = static_cast<float*>(out);
  args.record = static_cast<float*>(record);
  args.n_rows = n_states * n;
  args.n = n;
  args.l = l;
  args.d = d;
  args.n_layers = n_layers;
  for (int k = 0; k <= n_layers; ++k) args.widths[k] = widths[k];
  args.pair_idx = static_cast<const int32_t*>(pair_idx);
  args.pair_thr = static_cast<const float*>(pair_thr);
  args.n_pairs = n_pairs;
  return static_cast<int>(
      launch_objective_botnet(args, static_cast<cudaStream_t>(stream)));
}

int moeva_objective_botnet_max_features(int h1, int n_entries, int n_pairs) {
  return objective_botnet_max_features(h1, n_entries, n_pairs);
}

int moeva_objective_spec_f32(const void* x_gen, const void* x_init,
                             const void* xl, const void* xu,
                             const void* x_init_mm, const void* min_class,
                             const void* feat_gene, const void* feat_onehot,
                             const void* params, const void* first_t,
                             const void* scale, const void* offset,
                             const void* code, int n_instr,
                             int n_slots, int n_terms, const int* widths,
                             int n_layers, float f2_scale, int norm_inf,
                             float tol, void* out, void* record, int n_states,
                             int n, int l, int d, void* stream) {
  if (n_layers < 1 || n_layers > kObjectiveMaxLayers ||
      static_cast<long long>(n_states) * n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  SpecObjectiveArgs args{};
  args.x_gen = static_cast<const float*>(x_gen);
  args.x_init = static_cast<const float*>(x_init);
  args.xl = static_cast<const float*>(xl);
  args.xu = static_cast<const float*>(xu);
  args.x_init_mm = static_cast<const float*>(x_init_mm);
  args.min_class = static_cast<const int64_t*>(min_class);
  args.feat_gene = static_cast<const int32_t*>(feat_gene);
  args.feat_onehot = static_cast<const int32_t*>(feat_onehot);
  args.params = static_cast<const float*>(params);
  args.first_t = static_cast<const float*>(first_t);
  args.scale = static_cast<const float*>(scale);
  args.offset = static_cast<const float*>(offset);
  args.code = static_cast<const int32_t*>(code);
  args.n_instr = n_instr;
  args.n_slots = n_slots;
  args.n_terms = n_terms;
  args.f2_scale = f2_scale;
  args.norm_inf = norm_inf;
  args.tol = tol;
  args.out = static_cast<float*>(out);
  args.record = static_cast<float*>(record);
  args.n_rows = n_states * n;
  args.n = n;
  args.l = l;
  args.d = d;
  args.n_layers = n_layers;
  for (int k = 0; k <= n_layers; ++k) args.widths[k] = widths[k];
  return static_cast<int>(
      launch_objective_spec(args, static_cast<cudaStream_t>(stream)));
}

int moeva_objective_spec_tile_rows(int n_instr, int d, int n_slots, int w_max) {
  return objective_spec_tile_rows(n_instr, d, n_slots, w_max);
}

int moeva_pgd_botnet_f32(const void* x_init, const void* x_start, const void* y,
                         const void* mutable_, const void* params,
                         const void* first_t, const int* widths, int n_layers,
                         const void* scale, const void* min_, const void* cons,
                         const int* counts, const void* inverse, int degree,
                         const void* w_class, const void* w_cons,
                         const void* step, const void* ctr, void* x_adv,
                         void* pred, void* hist, int hist_cols, int n, int t,
                         float eps, float lo, float hi, float tol, int flags,
                         const void* is_ckpt, const void* ckpt_thr,
                         float tw_class, float tw_cons, int tctr, float eta0,
                         float alpha, void* eta, const void* pair_idx,
                         const void* pair_thr, int n_pairs, void* stream) {
  if (n_layers < 1 || n_layers > kObjectiveMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  PgdBotnetArgs args{};
  args.x_init = static_cast<const float*>(x_init);
  args.x_start = static_cast<const float*>(x_start);
  args.y = static_cast<const int64_t*>(y);
  args.mutable_ = static_cast<const bool*>(mutable_);
  args.params = static_cast<const float*>(params);
  args.first_t = static_cast<const float*>(first_t);
  args.scale = static_cast<const float*>(scale);
  args.min_ = static_cast<const float*>(min_);
  args.cons = static_cast<const int32_t*>(cons);
  for (int k = 0; k < kBotnetSegments; ++k) args.counts[k] = counts[k];
  args.inverse = static_cast<const int32_t*>(inverse);
  args.degree = degree;
  args.w_class = static_cast<const float*>(w_class);
  args.w_cons = static_cast<const float*>(w_cons);
  args.step = static_cast<const float*>(step);
  args.ctr = static_cast<const int32_t*>(ctr);
  args.x_adv = static_cast<float*>(x_adv);
  args.pred = static_cast<int64_t*>(pred);
  args.hist = static_cast<float*>(hist);
  args.hist_cols = hist_cols;
  args.n = n;
  args.t = t;
  args.flags = flags;
  args.eps = eps;
  args.lo = lo;
  args.hi = hi;
  args.tol = tol;
  args.n_layers = n_layers;
  for (int k = 0; k <= n_layers; ++k) args.widths[k] = widths[k];
  args.is_ckpt = static_cast<const bool*>(is_ckpt);
  args.ckpt_thr = static_cast<const float*>(ckpt_thr);
  args.tw_class = tw_class;
  args.tw_cons = tw_cons;
  args.tctr = tctr;
  args.eta0 = eta0;
  args.alpha = alpha;
  args.eta = static_cast<float*>(eta);
  args.pair_idx = static_cast<const int32_t*>(pair_idx);
  args.pair_thr = static_cast<const float*>(pair_thr);
  args.n_pairs = n_pairs;
  return static_cast<int>(
      launch_pgd_botnet(args, static_cast<cudaStream_t>(stream)));
}


int moeva_gate_stats_f32(const void* pop_f, const void* arch_f, void* out,
                         int n_states, int p, int a, float thr, float eps,
                         void* stream) {
  return static_cast<int>(launch_gate_stats(
      static_cast<const float*>(pop_f), static_cast<const float*>(arch_f),
      static_cast<float*>(out), n_states, p, a, thr, eps,
      static_cast<cudaStream_t>(stream)));
}

// `src`, `dst`, `row_elems`, `dst_stride` and `dst_offset` are host arrays
// of n_seg entries, one per gathered leaf.
int moeva_take_f32(const void* const* src, void* const* dst,
                   const long long* row_elems, const long long* dst_stride,
                   const long long* dst_offset, int n_seg, const void* idx,
                   int n_idx, long long n_src, void* stream) {
  if (n_seg < 0 || n_seg > kTakeMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  TakeArgs args = {};
  for (int k = 0; k < n_seg; ++k) {
    args.seg[k].src = static_cast<const float*>(src[k]);
    args.seg[k].dst = static_cast<float*>(dst[k]);
    args.seg[k].row_elems = row_elems[k];
    args.seg[k].dst_stride = dst_stride[k];
    args.seg[k].dst_offset = dst_offset[k];
  }
  args.n_seg = n_seg;
  args.idx = static_cast<const int64_t*>(idx);
  args.n_idx = n_idx;
  args.n_src = n_src;
  return static_cast<int>(launch_take(args, static_cast<cudaStream_t>(stream)));
}

int moeva_take_max_segments() { return kTakeMaxSegments; }

int moeva_nd_peel_max_candidates() { return kNdPeelMaxCandidates; }

int moeva_associate_max_directions() { return kAssociateMaxDirections; }

int moeva_survive_max_candidates() { return kSurviveMaxCandidates; }

int moeva_objective_max_params() { return kObjectiveMaxParams; }

int moeva_objective_max_width() { return kObjectiveMaxWidth; }

int moeva_objective_max_layers() { return kObjectiveMaxLayers; }

int moeva_lcld_max_pairs() { return kLcldMaxPairs; }

int moeva_pgd_max_ohe_slots() { return kPgdMaxOheSlots; }

int moeva_pgd_botnet_max_degree() { return kPgdBotnetMaxDegree; }

int moeva_pgd_botnet_aug_pairs() { return kPgdBotnetAugPairs; }

int moeva_botnet_max_pairs() { return kBotnetMaxPairs; }

int moeva_pgd_spec_f32(const void* x_init, const void* x_start, const void* y,
                       const void* mutable_, const void* params,
                       const void* first_t, const int* widths, int n_layers,
                       const void* scale, const void* min_, const void* ohe,
                       int n_groups, int group_slots, const void* w_class,
                       const void* w_cons, const void* step, const void* ctr,
                       const void* vjp, int n_vjp, int n_terms,
                       const void* term_start, const void* acc_ptr,
                       const void* acc_idx, int n_acc,
                       const void* repair, int n_repair, void* x_adv,
                       void* pred, void* hist, int hist_cols, int n, int t,
                       float eps, float lo, float hi, float tol, int flags,
                       int d, const void* is_ckpt, const void* ckpt_thr,
                       float tw_class, float tw_cons, int tctr, float eta0,
                       float alpha, void* eta, void* stream) {
  if (n_layers < 1 || n_layers > kObjectiveMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  PgdSpecArgs args{};
  args.x_init = static_cast<const float*>(x_init);
  args.x_start = static_cast<const float*>(x_start);
  args.y = static_cast<const int64_t*>(y);
  args.mutable_ = static_cast<const bool*>(mutable_);
  args.params = static_cast<const float*>(params);
  args.first_t = static_cast<const float*>(first_t);
  args.scale = static_cast<const float*>(scale);
  args.min_ = static_cast<const float*>(min_);
  args.ohe = static_cast<const int32_t*>(ohe);
  args.w_class = static_cast<const float*>(w_class);
  args.w_cons = static_cast<const float*>(w_cons);
  args.step = static_cast<const float*>(step);
  args.ctr = static_cast<const int32_t*>(ctr);
  args.vjp = static_cast<const int32_t*>(vjp);
  args.repair = static_cast<const int32_t*>(repair);
  args.term_start = static_cast<const int32_t*>(term_start);
  args.acc_ptr = static_cast<const int32_t*>(acc_ptr);
  args.acc_idx = static_cast<const int32_t*>(acc_idx);
  args.n_acc = n_acc;
  args.x_adv = static_cast<float*>(x_adv);
  args.pred = static_cast<int64_t*>(pred);
  args.hist = static_cast<float*>(hist);
  args.n = n;
  args.t = t;
  args.d = d;
  args.n_groups = n_groups;
  args.group_slots = group_slots;
  args.hist_cols = hist_cols;
  args.flags = flags;
  args.n_vjp = n_vjp;
  args.n_repair = n_repair;
  args.n_terms = n_terms;
  args.eps = eps;
  args.lo = lo;
  args.hi = hi;
  args.tol = tol;
  args.n_layers = n_layers;
  for (int k = 0; k <= n_layers; ++k) args.widths[k] = widths[k];
  args.is_ckpt = static_cast<const bool*>(is_ckpt);
  args.ckpt_thr = static_cast<const float*>(ckpt_thr);
  args.tw_class = tw_class;
  args.tw_cons = tw_cons;
  args.tctr = tctr;
  args.eta0 = eta0;
  args.alpha = alpha;
  args.eta = static_cast<float*>(eta);
  return static_cast<int>(
      launch_pgd_spec(args, static_cast<cudaStream_t>(stream)));
}

int moeva_pgd_spec_block_rows(int d, const int* widths, int n_layers,
                              int n_terms, int n_acc, int autopgd) {
  return pgd_spec_block_rows(d, widths, n_layers, n_terms, n_acc, autopgd);
}

int moeva_spec_vjp_max_instructions() { return kSpecVjpMaxInstructions; }

int moeva_spec_vjp_max_slots() { return kSpecVjpMaxSlots; }

int moeva_spec_max_instructions() { return kSpecMaxInstructions; }

int moeva_spec_max_slots() { return kSpecMaxSlots; }

int moeva_spec_max_terms() { return kSpecMaxTerms; }

int moeva_spec_max_features() { return kSpecMaxFeatures; }

int moeva_spec_max_width() { return kSpecMaxWidth; }

// K11 and K12: `widths` is a host array of n_layers + 1 ints; the adam
// scalars are float32 (c1 = 1 - b1, b1, c2 = 1 - b2, b2, bc1, bc2, eps,
// -lr), each rounded once from float64 on the host.
int moeva_train_step_f32(const void* x, const void* y, const void* w, const void* cw,
                         void* params, void* mu, void* nu, const int* widths, int n_layers,
                         int n, float c1, float b1, float c2, float b2, float bc1, float bc2,
                         float eps, float neg_lr, void* part_grad, void* part_loss, void* loss,
                         void* stream) {
  TrainShape shape;
  if (!train_shape(widths, n_layers, &shape)) return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars adam{c1, b1, c2, b2, bc1, bc2, eps, neg_lr};
  return static_cast<int>(launch_train_step(
      static_cast<const float*>(x), static_cast<const int64_t*>(y), static_cast<const float*>(w),
      static_cast<const float*>(cw), static_cast<float*>(params), static_cast<float*>(mu),
      static_cast<float*>(nu), shape, n, adam, static_cast<float*>(part_grad),
      static_cast<float*>(part_loss), static_cast<float*>(loss), static_cast<cudaStream_t>(stream)));
}

int moeva_train_loss_f32(const void* x, const void* y, const void* cw, const void* params,
                         const int* widths, int n_layers, int n, void* part_loss, void* stream) {
  TrainShape shape;
  if (!train_shape(widths, n_layers, &shape)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_train_loss(
      static_cast<const float*>(x), static_cast<const int64_t*>(y), static_cast<const float*>(cw),
      static_cast<const float*>(params), shape, n, static_cast<float*>(part_loss),
      static_cast<cudaStream_t>(stream)));
}

int moeva_input_grad_f32(const void* x, const void* params, const int* widths, int n_layers, int n,
                         void* out, void* stream) {
  TrainShape shape;
  if (!train_shape(widths, n_layers, &shape)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_input_grad(static_cast<const float*>(x), static_cast<const float*>(params),
                                            shape, n, static_cast<float*>(out),
                                            static_cast<cudaStream_t>(stream)));
}

// Bytes of shared memory a K11 or K12 block takes for the stack (0: the
// stack is refused, or more than one block holds).
long long moeva_train_smem_bytes(const int* widths, int n_layers) {
  TrainShape shape;
  if (!train_shape(widths, n_layers, &shape)) return 0;
  return static_cast<long long>(train_tile_smem_bytes(shape));
}

int moeva_train_tile_rows() { return kTrainTileRows; }

int moeva_train_max_layers() { return kTrainMaxLayers; }

// K0: `out`, `numel`, `first`, `kind` and `n` are host arrays of n_fields
// entries, one per field of the call (core/philox.py's layout).
static bool draw_args(void* const* out, const long long* numel, const long long* first, const int* kind,
                      const unsigned* n, int n_fields, unsigned long long key, unsigned long long base,
                      long long total, DrawArgs* args) {
  if (n_fields < 1 || n_fields > kDrawMaxFields) return false;
  *args = DrawArgs{};
  for (int f = 0; f < n_fields; ++f) {
    args->field[f].out = out != nullptr ? out[f] : nullptr;
    args->field[f].numel = numel[f];
    args->field[f].first = first[f];
    args->field[f].kind = kind[f];
    args->field[f].n = n[f];
  }
  args->n_fields = n_fields;
  args->key0 = static_cast<uint32_t>(key);
  args->key1 = static_cast<uint32_t>(key >> 32);
  args->base = base;
  args->total = total;
  return true;
}

int moeva_draws_f32(void* const* out, const long long* numel, const long long* first, const int* kind,
                    const unsigned* n, int n_fields, unsigned long long key, unsigned long long base,
                    long long total, void* stream) {
  DrawArgs args;
  if (!draw_args(out, numel, first, kind, n, n_fields, key, base, total, &args))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_draws(args, static_cast<cudaStream_t>(stream)));
}

int moeva_pgd_start_f32(const long long* numel, const long long* first, const int* kind, const unsigned* n,
                        int n_fields, unsigned long long key, unsigned long long base, long long total,
                        const void* x_init, const void* mutable_mask, void* x_start, float lo, float hi,
                        float eps, double exponent, int norm_inf, int rows, int d, void* stream) {
  PgdStartArgs args = {};
  if (!draw_args(nullptr, numel, first, kind, n, n_fields, key, base, total, &args.draws))
    return static_cast<int>(cudaErrorInvalidValue);
  args.x_init = static_cast<const float*>(x_init);
  args.mutable_mask = static_cast<const bool*>(mutable_mask);
  args.x_start = static_cast<float*>(x_start);
  args.lo = lo;
  args.hi = hi;
  args.eps = eps;
  args.exponent = exponent;
  args.norm_inf = norm_inf;
  args.n = rows;
  args.d = d;
  return static_cast<int>(launch_pgd_start(args, static_cast<cudaStream_t>(stream)));
}

int moeva_draws_max_fields() { return kDrawMaxFields; }

// K13a: pop (with ball), ideal, worst and extreme may be null.
int moeva_chunk_prepare_f32(const void* x, const void* xl, const void* xu, const void* gene_feat,
                            const void* group_idx, const void* int_gene, const void* ball, void* xl_gen,
                            void* xu_gen, void* x_mm, void* pop, void* ideal, void* worst, void* extreme,
                            int n_states, int d, int l, int n1, int n_groups, int k, int p, int n_pert,
                            int ball_cols, int norm_inf, float eps, void* stream) {
  ChunkPrepareArgs a = {};
  a.x = static_cast<const float*>(x);
  a.xl = static_cast<const float*>(xl);
  a.xu = static_cast<const float*>(xu);
  a.gene_feat = static_cast<const int32_t*>(gene_feat);
  a.group_idx = static_cast<const int32_t*>(group_idx);
  a.int_gene = static_cast<const bool*>(int_gene);
  a.ball = static_cast<const float*>(ball);
  a.xl_gen = static_cast<float*>(xl_gen);
  a.xu_gen = static_cast<float*>(xu_gen);
  a.x_mm = static_cast<float*>(x_mm);
  a.pop = static_cast<float*>(pop);
  a.ideal = static_cast<float*>(ideal);
  a.worst = static_cast<float*>(worst);
  a.extreme = static_cast<float*>(extreme);
  a.n_states = n_states;
  a.d = d;
  a.l = l;
  a.n1 = n1;
  a.n_groups = n_groups;
  a.k = k;
  a.p = p;
  a.n_pert = n_pert;
  a.ball_cols = ball_cols;
  a.norm_inf = norm_inf;
  a.eps = eps;
  return static_cast<int>(launch_chunk_prepare(a, static_cast<cudaStream_t>(stream)));
}

// K13b.
int moeva_chunk_decode_f32(const void* pop_x, const void* arch_x, const void* pop_f, const void* arch_f,
                           const void* x_init, const void* feat_gene, const void* feat_onehot, void* x_gen,
                           void* f, void* x_ml, int n_states, int p, int a, int l, int d, void* stream) {
  ChunkDecodeArgs args = {};
  args.pop_x = static_cast<const float*>(pop_x);
  args.arch_x = static_cast<const float*>(arch_x);
  args.pop_f = static_cast<const float*>(pop_f);
  args.arch_f = static_cast<const float*>(arch_f);
  args.x_init = static_cast<const float*>(x_init);
  args.feat_gene = static_cast<const int32_t*>(feat_gene);
  args.feat_onehot = static_cast<const int32_t*>(feat_onehot);
  args.x_gen = static_cast<float*>(x_gen);
  args.f = static_cast<float*>(f);
  args.x_ml = static_cast<float*>(x_ml);
  args.n_states = n_states;
  args.p = p;
  args.a = a;
  args.l = l;
  args.d = d;
  return static_cast<int>(launch_chunk_decode(args, static_cast<cudaStream_t>(stream)));
}

// K14.
int moeva_refdirs_f64(const void* theta0, const void* sched, void* out, int n, int n_dim, int n_iter, double s,
                      double c1, double b1, double c2, double b2, double eps, void* stream) {
  const RefdirsAdam adam{c1, b1, c2, b2, eps};
  return static_cast<int>(launch_refdirs(static_cast<const double*>(theta0), static_cast<const double*>(sched),
                                         static_cast<double*>(out), n, n_dim, n_iter, s, adam,
                                         static_cast<cudaStream_t>(stream)));
}

int moeva_refdirs_shape(int n, int n_dim, int* out) { return static_cast<int>(refdirs_shape(n, n_dim, out)); }

int moeva_refdirs_max_points() { return kRefdirsMaxPoints; }

int moeva_refdirs_max_dim() { return kRefdirsMaxDim; }

// K15: hist, prev_hist and best_hist null without a history; prev_success
// and prev_hist null before the first start.
int moeva_restart_f32(const void* x_adv, const void* pred, const void* y, const void* hist, const void* prev_x,
                      void* best_x, const void* prev_hist, void* best_hist, const void* prev_success,
                      void* success, int n, int d, int t, int c, int targeted, void* stream) {
  RestartArgs a = {};
  a.x_adv = static_cast<const float*>(x_adv);
  a.pred = static_cast<const int64_t*>(pred);
  a.y = static_cast<const int64_t*>(y);
  a.hist = static_cast<const float*>(hist);
  a.prev_x = static_cast<const float*>(prev_x);
  a.best_x = static_cast<float*>(best_x);
  a.prev_hist = static_cast<const float*>(prev_hist);
  a.best_hist = static_cast<float*>(best_hist);
  a.prev_success = static_cast<const bool*>(prev_success);
  a.success = static_cast<bool*>(success);
  a.n = n;
  a.d = d;
  a.t = t;
  a.c = c;
  a.targeted = targeted;
  return static_cast<int>(launch_restart(a, static_cast<cudaStream_t>(stream)));
}

// K16: `widths` holds n_layers + 1 entries.
static bool forward_shape(const int* widths, int n_layers, ForwardShape* shape) {
  if (n_layers < 1 || n_layers > kForwardMaxLayers) return false;
  *shape = ForwardShape{};
  shape->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) shape->widths[l] = widths[l];
  return true;
}

int moeva_forward_labels_f32(const void* x, const void* params, const int* widths, int n_layers, int n,
                             void* labels, void* stream) {
  ForwardShape shape;
  if (!forward_shape(widths, n_layers, &shape)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_forward_labels(static_cast<const float*>(x), static_cast<const float*>(params),
                                                shape, n, static_cast<int64_t*>(labels),
                                                static_cast<cudaStream_t>(stream)));
}

int moeva_forward_proba1_f64(const void* x, const void* params, const int* widths, int n_layers, int n,
                             void* proba1, void* stream) {
  ForwardShape shape;
  if (!forward_shape(widths, n_layers, &shape)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_forward_proba1(static_cast<const double*>(x),
                                                static_cast<const double*>(params), shape, n,
                                                static_cast<double*>(proba1), static_cast<cudaStream_t>(stream)));
}

int moeva_forward_max_width() { return kForwardMaxWidth; }

int moeva_forward_max_layers() { return kForwardMaxLayers; }

const char* moeva_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
