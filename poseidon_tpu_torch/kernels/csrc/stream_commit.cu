// K7 stream_commit: the per-window commit of the stream lane, in place.
//
// Replaces: poseidon_tpu/ops/resident.py:658-690, the tail of
// `_stream_chain`'s scan step (on the TPU, part of one `lax.scan` body).
// After a window's express step (K5 patch, pricing, K4 arrival rows, the
// eps=1 repair, the compaction), one launch:
//   live2 = live & conv & domain_ok & (n_changes <= change_cap)
// and, when live2 holds,
//   - the auto-retire of the window's report mask: valid = valid_n & ~report,
//     u = report ? 0 : u_n, w = report ? INF : w_n, asg = report ? Mp : asg_f,
//     lvl = report ? 0 : lvl_f, and s_n[clip(asg_f)] -= 1 per reported row
//     (global atomics), then after every decrement s = max(s_n, 0);
//   - floor = floor_f;
// else the carry keeps its values and the arrival rows that K4 wrote into
// c in place are put back from `c_saved` (the rows as they were before K4),
// which is what the reference's `where(live2, c_new, c_old)` selects.
// The window's log row (int64, 2 * cap + 6 entries: rows_out, asg_out,
// n_changes, live2, conv, domain_ok, primal, one spare) is written masked as the
// reference masks its scan outputs (rows -> Tp, asg -> -1, primal -> 0),
// and `live` is written back with live2. No value comes to the host: the
// next window reads `live` on the device, and the flush fetches all
// windows' log rows at once.
//
// Bound: bytes, far below one launch's fixed cost. At the flagship
// (Tp 10240, Mp 1024, kmax 16, cap 256) it reads about 10 Tp-vectors and
// 3 Mp-vectors (~0.42 MB) and writes 6 Tp-vectors (~0.2 MB) when live, or
// restores 16 rows of c (64 KiB) when dead: ~0.2 us at 3.35 TB/s.
//
// Under a row-block mesh (parallel/) c is one shard's rows [row0, row0 +
// c_rows): the commit restores the arrival rows it owns, and
// stream_restore_launch restores another shard's rows after the commit,
// reading the verdict back from `live` (one block, the same row copy).
//
// Design: the simple one, as K5. One block of 1024 threads striding over
// the Tp, Mp and row axes. Every thread computes live2 from the flags
// before a __syncthreads(), so the write-back of `live` by thread 0 at the
// end cannot race a reader. The seat decrements are global atomics into
// s_n (the window's own copy of s), ordered before the clamp by a
// __syncthreads(); the clamp's loads bypass L1 (__ldcg).
#include "common.cuh"

namespace {

constexpr int COMMIT_THREADS = 1024;

__global__ void __launch_bounds__(COMMIT_THREADS) stream_commit_kernel(
    int* live, const unsigned char* __restrict__ conv,
    const unsigned char* __restrict__ domain_ok, const int* __restrict__ n_changes,
    int change_cap, const int* __restrict__ rows_out, const int* __restrict__ asg_out,
    const long long* __restrict__ primal, int cap,
    const unsigned char* __restrict__ report, const int* __restrict__ asg_f,
    const int* __restrict__ lvl_f, const int* __restrict__ floor_f,
    const int* __restrict__ u_n, const int* __restrict__ w_n,
    const unsigned char* __restrict__ valid_n, int* s_n,
    const int* __restrict__ add_row, const int* __restrict__ c_saved, int kmax,
    int* __restrict__ u, int* __restrict__ w, unsigned char* __restrict__ valid,
    int* __restrict__ asg, int* __restrict__ lvl, int* __restrict__ s,
    int* __restrict__ floor_, int* __restrict__ c, long long* __restrict__ log_row,
    int Tp, int Mp, int row0, int c_rows) {
  const int nchg = *n_changes;
  const bool live2 = (*live != 0) && (*conv != 0) && (*domain_ok != 0) && (nchg <= change_cap);
  __syncthreads();
  if (live2) {
    for (int t = threadIdx.x; t < Tp; t += blockDim.x) {
      const bool rep = report[t] != 0;
      const int a = asg_f[t];
      if (rep) atomicSub(&s_n[min(max(a, 0), Mp - 1)], 1);
      valid[t] = (valid_n[t] != 0 && !rep) ? 1 : 0;
      u[t] = rep ? 0 : u_n[t];
      w[t] = rep ? pt::INF : w_n[t];
      asg[t] = rep ? Mp : a;
      lvl[t] = rep ? 0 : lvl_f[t];
    }
    for (int m = threadIdx.x; m < Mp; m += blockDim.x) floor_[m] = floor_f[m];
    __syncthreads();
    for (int m = threadIdx.x; m < Mp; m += blockDim.x) s[m] = max(__ldcg(&s_n[m]), 0);
  } else {
    for (int k = 0; k < kmax; ++k) {
      const int r = add_row[k] - row0;
      if (add_row[k] < 0 || add_row[k] >= Tp || r < 0 || r >= c_rows) continue;
      const int* src = c_saved + static_cast<size_t>(k) * Mp;
      int* dst = c + static_cast<size_t>(r) * Mp;
      for (int m = threadIdx.x; m < Mp; m += blockDim.x) dst[m] = src[m];
    }
  }
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    log_row[i] = live2 ? rows_out[i] : Tp;
    log_row[cap + i] = live2 ? asg_out[i] : -1;
  }
  if (threadIdx.x == 0) {
    log_row[2 * cap] = nchg;
    log_row[2 * cap + 1] = live2 ? 1 : 0;
    log_row[2 * cap + 2] = *conv != 0 ? 1 : 0;
    log_row[2 * cap + 3] = *domain_ok != 0 ? 1 : 0;
    log_row[2 * cap + 4] = live2 ? *primal : 0;
    *live = live2 ? 1 : 0;
  }
}

// A dead window's undo in another shard: the commit has already written
// its verdict to `live`.
__global__ void __launch_bounds__(COMMIT_THREADS) stream_restore_kernel(
    const int* __restrict__ live, const int* __restrict__ add_row,
    const int* __restrict__ c_saved, int kmax, int* __restrict__ c, int Tp, int Mp,
    int row0, int c_rows) {
  if (*live != 0) return;
  for (int k = 0; k < kmax; ++k) {
    const int r = add_row[k] - row0;
    if (add_row[k] < 0 || add_row[k] >= Tp || r < 0 || r >= c_rows) continue;
    const int* src = c_saved + static_cast<size_t>(k) * Mp;
    int* dst = c + static_cast<size_t>(r) * Mp;
    for (int m = threadIdx.x; m < Mp; m += blockDim.x) dst[m] = src[m];
  }
}

}  // namespace

extern "C" int stream_commit_launch(
    int* live, const unsigned char* conv, const unsigned char* domain_ok, const int* n_changes,
    const int* rows_out, const int* asg_out, const long long* primal,
    const unsigned char* report, const int* asg_f, const int* lvl_f, const int* floor_f,
    const int* u_n, const int* w_n, const unsigned char* valid_n, int* s_n, const int* add_row,
    const int* c_saved, int* u, int* w, unsigned char* valid, int* asg, int* lvl, int* s,
    int* floor_, int* c, long long* log_row, int change_cap, int cap, int kmax, int Tp, int Mp,
    int row0, int c_rows, void* stream) {
  stream_commit_kernel<<<1, COMMIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      live, conv, domain_ok, n_changes, change_cap, rows_out, asg_out, primal, cap, report, asg_f,
      lvl_f, floor_f, u_n, w_n, valid_n, s_n, add_row, c_saved, kmax, u, w, valid, asg, lvl, s,
      floor_, c, log_row, Tp, Mp, row0, c_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stream_restore_launch(const int* live, const int* add_row, const int* c_saved,
                                     int* c, int kmax, int Tp, int Mp, int row0, int c_rows,
                                     void* stream) {
  stream_restore_kernel<<<1, COMMIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      live, add_row, c_saved, kmax, c, Tp, Mp, row0, c_rows);
  return static_cast<int>(cudaGetLastError());
}
