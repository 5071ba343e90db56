// K7 stream_commit: the tail of an express window, across one cluster.
//
// Replaces: poseidon_tpu/ops/resident.py:526-545, the tail of
// `_express_step` (the report mask, the change count, the ordered
// compaction, the objective), and in the stream lane also l.658-690, the
// commit of `_stream_chain`'s scan step (on the TPU, all of it part of one
// `lax.scan` body). After a window's repair, one launch computes
//   report[t] = valid_n[t] & 0 <= asg_f[t] < Mp & asg_f[t] != asg0[t]
//   n_changes = sum(report)
//   rows_out  = the first cap reported rows, ascending, padded with Tp
//   asg_out   = asg_f[rows_out], -1 past the reported rows
//   primal    = sum over valid_n of (asg_f on a machine ? c[t, asg_f[t]] :
//               asg_f == Mp ? u_n[t] : INF), in int64
//   win_ok    = conv & domain_ok & n_changes <= change_cap
// and writes `report` [Tp] and the window's log row (int64, 2 * cap + 6
// entries: rows_out, asg_out, n_changes, live2, conv, domain_ok, primal,
// n_active = sum(valid_n)). Without the commit (the synced express lane)
// the row is the batch's one fetch, live2 = win_ok and nothing is masked.
// With it (the stream lane), live2 = live & win_ok latches, and:
//   - when live2 holds, the auto-retire of the report: valid = valid_n &
//     ~report, u = report ? 0 : u_n, w = report ? INF : w_n, asg = report ?
//     Mp : asg_f, lvl = report ? 0 : lvl_f, floor = floor_f, and
//     s_n[clip(asg_f)] -= 1 per reported row, then s = max(s_n, 0);
//   - else the carry keeps its values and the arrival rows that K4 wrote
//     into c are put back from c_saved (the reference's
//     `where(live2, c_new, c_old)`);
//   - the log row is masked as the reference masks its scan outputs (rows
//     -> Tp, asg -> -1, primal -> 0) and `live` is written back with live2.
// No value comes to the host: the next window reads `live` on the device.
//
// The hazard that shapes the design: live2 needs n_changes, a sum over the
// whole [Tp], and the carry may not be written before every block has
// counted. So the launch is one thread-block cluster of CLUSTER blocks, each
// owning a contiguous tile of [Tp] (and of [Mp]):
//   1. each block writes its report bits, counts them and sums its objective
//      partial into its own shared memory (no remote atomics: remote 64-bit
//      atomics into distributed shared memory were seen to lose updates);
//   2. cluster barrier;
//   3. each block reads every block's count from distributed shared memory
//      and takes its exclusive prefix: its reported rows go to the log row at
//      that offset, in order, by a block-wide scan a chunk, and the entries
//      past cap are dropped; rank 0 sums the objective partials;
//   4. every block now knows live2: a live window writes its tile of the
//      carry and its seat decrements (global atomics into s_n), a dead one
//      its share of the saved rows;
//   5. a second cluster barrier (it also keeps every block's shared memory
//      alive until the remote reads are done), then the clamp s = max(s_n, 0)
//      with loads from L2 (__ldcg), and rank 0 writes the log row's scalars
//      and, last, `live`. Every block read `live` before the barrier.
//
// Bound: bytes. At the flagship (Tp 10240, Mp 1024, cap 256), a live commit
// reads valid_n, asg0, asg_f, u_n, w_n, lvl_f (~0.2 MB), one cost entry per
// active row and floor_f/s_n, and writes report, the five carry vectors, s,
// floor and the log (~0.2 MB): ~0.43 MB, ~0.13 us at 3.35 TB/s. The launch's
// fixed cost and the two cluster barriers set its time.
//
// Under a row-block mesh (parallel/) `cost` is the per-row cost gathered
// from the shards (col_step 0) and `c` is the first shard's rows [0,
// c_rows): the commit restores the arrival rows it owns, and
// stream_restore_launch restores another shard's rows after the commit,
// reading the verdict back from `live`.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// The launch's pointers and sizes, laid out as the ctypes Structure
// `_Args` of kernels/stream_commit.py: every field 8 bytes. The commit's
// pointers (live .. floor_) are null without the commit.
struct TailArgs {
  const unsigned char* valid_n;  // [Tp], after the head
  const int* asg0;               // [Tp], the repair's start
  const int* asg_f;              // [Tp], the repair's end
  const int* u_n;                // [Tp], after the head
  const int* cost;               // table [Tp, Mp] (col_step 1) or [Tp] (col_step 0)
  const unsigned char* conv;
  const unsigned char* domain_ok;
  unsigned char* report;  // [Tp]
  long long* log_row;     // [2 cap + 6]
  int* live;              // [1]
  const int* lvl_f;       // [Tp]
  const int* floor_f;     // [Mp]
  const int* w_n;         // [Tp], after the head
  int* s_n;               // [Mp], consumed: the decrements land in it
  const int* add_row;     // [kmax]
  const int* c_saved;     // [kmax, Mp]
  int* c;                 // [c_rows, Mp]
  int* u;                 // the carry: [Tp] ...
  int* w;
  unsigned char* valid;
  int* asg;
  int* lvl;
  int* s;  // ... and [Mp]
  int* floor_;
  long long col_step, change_cap, cap, kmax, Tp, Mp, c_rows;
};

namespace {

constexpr int CLUSTER = 8;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == 32, "the chunk scan takes one warp count a lane");

__device__ __forceinline__ bool reported(const TailArgs& a, int t, int Mp) {
  const int f = a.asg_f[t];
  return a.valid_n[t] != 0 && f >= 0 && f < Mp && f != a.asg0[t];
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// [lo, hi) of an axis of n split into CLUSTER contiguous tiles
__device__ __forceinline__ void tile_of(int rank, int n, int& lo, int& hi) {
  const int per = (n + CLUSTER - 1) / CLUSTER;
  lo = min(rank * per, n);
  hi = min(lo + per, n);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    stream_commit_kernel(const TailArgs a) {
  __shared__ int count;         // this block's reported rows
  __shared__ long long part[2];  // this block's objective and active rows
  __shared__ int warp_n[WARPS];
  __shared__ long long warp_p[WARPS], warp_v[WARPS];
  __shared__ int before, total, chunk;

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int Tp = static_cast<int>(a.Tp), Mp = static_cast<int>(a.Mp);
  const int cap = static_cast<int>(a.cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int t0, t1, m0, m1;
  tile_of(rank, Tp, t0, t1);
  tile_of(rank, Mp, m0, m1);
  const bool commit = a.live != nullptr;
  const bool was_live = commit && *a.live != 0;

  // ---- 1. report bits, the block's count and objective partial ----
  long long n = 0, prim = 0, act = 0;
  for (int t = t0 + threadIdx.x; t < t1; t += THREADS) {
    const bool rep = reported(a, t, Mp);
    a.report[t] = rep ? 1 : 0;
    n += rep;
    if (a.valid_n[t] != 0) {
      const int f = a.asg_f[t];
      int v = pt::INF;
      if (f >= 0 && f < Mp)
        v = a.cost[static_cast<long long>(t) * (a.col_step != 0 ? Mp : 1) + f * a.col_step];
      else if (f == Mp)
        v = a.u_n[t];
      prim += v;
      ++act;
    }
  }
  n = warp_sum(n);
  prim = warp_sum(prim);
  act = warp_sum(act);
  if (lane == 0) {
    warp_n[warp] = static_cast<int>(n);
    warp_p[warp] = prim;
    warp_v[warp] = act;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cn = 0;
    long long cp = 0, cv = 0;
    for (int i = 0; i < WARPS; ++i) {
      cn += warp_n[i];
      cp += warp_p[i];
      cv += warp_v[i];
    }
    count = cn;
    part[0] = cp;
    part[1] = cv;
  }
  cg::this_cluster().sync();

  // ---- 3. the prefix, the ordered compaction, the verdict ----
  long long primal = 0, active = 0;
  if (threadIdx.x == 0) {
    int b = 0, s = 0;
    for (int r = 0; r < CLUSTER; ++r) {
      const int cr = *cg::this_cluster().map_shared_rank(&count, r);
      b += r < rank ? cr : 0;
      s += cr;
      if (rank == 0) {
        const long long* pr = cg::this_cluster().map_shared_rank(part, r);
        primal += pr[0];
        active += pr[1];
      }
    }
    before = b;
    total = s;
  }
  __syncthreads();
  const int nchg = total;
  const bool win_ok = *a.conv != 0 && *a.domain_ok != 0 && nchg <= a.change_cap;
  const bool live2 = commit ? was_live && win_ok : win_ok;
  const bool masked = commit && !live2;
  int base = before;
  for (int c0 = t0; c0 < t1 && base < cap; c0 += THREADS) {
    const int t = c0 + threadIdx.x;
    const bool rep = t < t1 && reported(a, t, Mp);
    const unsigned bal = __ballot_sync(0xffffffffu, rep);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_n[lane];  // WARPS == 32: one entry a lane
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      warp_n[lane] = incl - v;
      if (lane == 31) chunk = incl;
    }
    __syncthreads();
    if (rep) {
      const int pos = base + warp_n[warp] + __popc(bal & ((1u << lane) - 1u));
      if (pos < cap) {
        a.log_row[pos] = masked ? Tp : t;
        a.log_row[cap + pos] = masked ? -1 : a.asg_f[t];
      }
    }
    base += chunk;
    __syncthreads();  // warp_n and chunk are reused
  }
  for (int i = min(nchg, cap) + rank * THREADS + threadIdx.x; i < cap; i += CLUSTER * THREADS) {
    a.log_row[i] = Tp;
    a.log_row[cap + i] = -1;
  }

  // ---- 4. the commit: the carry and the decrements, or the undo ----
  if (commit && live2) {
    for (int t = t0 + threadIdx.x; t < t1; t += THREADS) {
      const bool rep = a.report[t] != 0;  // this block wrote it in phase 1
      const int f = a.asg_f[t];
      if (rep) atomicSub(&a.s_n[min(max(f, 0), Mp - 1)], 1);
      a.valid[t] = (a.valid_n[t] != 0 && !rep) ? 1 : 0;
      a.u[t] = rep ? 0 : a.u_n[t];
      a.w[t] = rep ? pt::INF : a.w_n[t];
      a.asg[t] = rep ? Mp : f;
      a.lvl[t] = rep ? 0 : a.lvl_f[t];
    }
    for (int m = m0 + threadIdx.x; m < m1; m += THREADS) a.floor_[m] = a.floor_f[m];
  } else if (commit) {
    const long long n_el = a.kmax * Mp;
    for (long long i = rank * THREADS + threadIdx.x; i < n_el; i += CLUSTER * THREADS) {
      const int k = static_cast<int>(i / Mp), m = static_cast<int>(i % Mp);
      const int r = a.add_row[k];
      if (r >= 0 && r < Tp && r < a.c_rows)
        a.c[static_cast<long long>(r) * Mp + m] = a.c_saved[i];
    }
  }
  cg::this_cluster().sync();

  // ---- 5. the clamp, the scalars, the latch ----
  if (commit && live2)
    for (int m = m0 + threadIdx.x; m < m1; m += THREADS) a.s[m] = max(__ldcg(&a.s_n[m]), 0);
  if (rank == 0 && threadIdx.x == 0) {
    long long* sc = a.log_row + 2 * cap;
    sc[0] = nchg;
    sc[1] = live2 ? 1 : 0;
    sc[2] = *a.conv != 0 ? 1 : 0;
    sc[3] = *a.domain_ok != 0 ? 1 : 0;
    sc[4] = masked ? 0 : primal;
    sc[5] = active;
    if (commit) *a.live = live2 ? 1 : 0;
  }
}

// A dead window's undo in another shard: the commit has already written
// its verdict to `live`.
__global__ void __launch_bounds__(THREADS) stream_restore_kernel(
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

extern "C" int stream_commit_launch(const TailArgs* a, void* stream) {
  stream_commit_kernel<<<CLUSTER, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stream_restore_launch(const int* live, const int* add_row, const int* c_saved,
                                     int* c, int kmax, int Tp, int Mp, int row0, int c_rows,
                                     void* stream) {
  stream_restore_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      live, add_row, c_saved, kmax, c, Tp, Mp, row0, c_rows);
  return static_cast<int>(cudaGetLastError());
}
