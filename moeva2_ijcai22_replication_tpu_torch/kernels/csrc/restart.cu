// K15: PGD's restart arbitration, one launch after each start's run.
//
// Replaces the jnp device stage moeva2_ijcai22_replication_tpu/attacks/pgd/
// engine.py::ConstrainedPGD._build's `restart` body (inside the jitted
// attack's fori_loop; the repo has no Pallas kernel for it), which the port
// ran as eager torch.where, | and torch.stack after every start.
//
// Semantics (must equal attacks/pgd/engine.py::restart_plain bit for bit;
// selections only): success = pred != y (pred == y when targeted), take =
// success & !prev_success; best_x = take ? x_adv : prev_x; where there is a
// history, best_hist = (no prev_hist, or take | !(prev_success | success))
// ? hist : prev_hist; success_out = prev_success | success. Before the first
// start prev_success and prev_hist are null (no row has succeeded, and the
// first run's history is copied).
//
// Bound: bytes. Each input read once and each output written once; no
// arithmetic.
//
// Design: one thread an element of [best_x, best_hist, success_out], a
// grid-stride loop; each thread recomputes its row's success from pred and
// y. best_x may alias prev_x and best_hist prev_hist (the update is in
// place from the second start on): each element is read and written by the
// same thread. success_out is row r of the (R, N) curve and prev_success
// row r - 1, so no thread reads what another writes.

#include "kernels.h"

namespace {

constexpr int kRestartThreads = 256;

__global__ void __launch_bounds__(kRestartThreads) restart_kernel(RestartArgs a) {
  const int64_t n_x = static_cast<int64_t>(a.n) * a.d;
  const int64_t n_h = a.best_hist != nullptr ? static_cast<int64_t>(a.t) * a.n * a.c : 0;
  const int64_t total = n_x + n_h + a.n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t row;
    if (idx < n_x) {
      row = idx / a.d;
    } else if (idx < n_x + n_h) {
      row = ((idx - n_x) / a.c) % a.n;
    } else {
      row = idx - n_x - n_h;
    }
    const bool hit = a.targeted ? a.pred[row] == a.y[row] : a.pred[row] != a.y[row];
    const bool prev = a.prev_success != nullptr && a.prev_success[row];
    const bool take = hit && !prev;
    if (idx < n_x) {
      a.best_x[idx] = take ? a.x_adv[idx] : a.prev_x[idx];
    } else if (idx < n_x + n_h) {
      const int64_t h = idx - n_x;
      const bool upd = a.prev_hist == nullptr || take || !(prev || hit);
      a.best_hist[h] = upd ? a.hist[h] : a.prev_hist[h];
    } else {
      a.success[row] = prev || hit;
    }
  }
}

}  // namespace

cudaError_t launch_restart(const RestartArgs& args, cudaStream_t stream) {
  if (args.n < 0 || args.d < 0 || (args.best_hist != nullptr && (args.t < 0 || args.c < 0)))
    return cudaErrorInvalidValue;
  if (args.n == 0) return cudaSuccess;
  static LaunchCache cache;
  int sms = 0;
  const cudaError_t err = cache.sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t n_h = args.best_hist != nullptr ? static_cast<int64_t>(args.t) * args.n * args.c : 0;
  const int64_t total = static_cast<int64_t>(args.n) * args.d + n_h + args.n;
  const int64_t want = (total + kRestartThreads - 1) / kRestartThreads;
  const int blocks = static_cast<int>(want < 8L * sms ? want : 8L * sms);
  restart_kernel<<<blocks, kRestartThreads, 0, stream>>>(args);
  return cudaGetLastError();
}
