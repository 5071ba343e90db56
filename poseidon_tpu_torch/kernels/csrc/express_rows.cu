// K4 express_rows: the head of an express window. One launch builds the
// arrival rows of the dense cost table and writes every arrival scatter.
//
// Replaces: poseidon_tpu/ops/resident.py:486-507, the row build and the six
// `.at[addi].set(..., mode="drop")` scatters of `_express_step` (XLA fused
// them on the TPU). For each arrival lane k with a row r = add_row[k] in
// [0, Tp), and each column m:
//   v = min(w_s[k] + dgen[m], INF)
//   for each preference j: min with pc_s[k, j] where add_pm[k, j] == m,
//                          min with min(pc_s[k, j] + ra_s[m], INF) where
//                          add_pr[k, j] == rack_of[m] (both >= 0)
//   c[r, m] = s[m] > 0 ? v : INF
// and u[r] = u_s[k], w[r] = w_s[k], valid[r] = 1 in place, while
//   asg0[t] = t is an arrival row ? -1 : asg[t],  lvl0[t] = ... ? 0 : lvl[t]
// are written out of place over the whole [Tp]: in the synced lane `asg` may
// be the warm state itself, which a degraded batch must leave as it was.
// With `c_saved`, row r's old contents go to c_saved[k] first (the stream
// lane's undo of a dead window); the lanes without a row leave theirs alone.
// Lanes of -1 (or a row past Tp) write nothing. The two sums wrap as XLA's
// int32 does (pt::wrap_add); the INF clamps follow the add.
//
// Assumption: the arrival rows are distinct (the host coalesces duplicate
// arrivals before it encodes a window), so no two blocks write one row.
//
// Under a row-block mesh (parallel/) `c` holds rows [row0, row0 + c_rows) of
// the table: a launch writes the rows (and saved rows) it owns, and only the
// first shard's launch gets the [Tp] vectors (null pointers elsewhere).
//
// Bound: bytes, far below one launch's fixed cost. At the flagship (kmax =
// 16 lanes, Tp = 10240, Mp = 1024, pk = 3) it reads 4 column vectors (16
// KiB), asg and lvl (80 KiB) and the old rows when it saves them (64 KiB),
// and writes 16 rows (64 KiB), asg0 and lvl0 (80 KiB) and the saved rows
// (64 KiB): ~0.37 MB, about 0.11 us at 3.35 TB/s. A launch costs microseconds.
//
// Design: one launch, two kinds of block. Blocks [0, kmax) take one lane
// each: its preferences (pk triples) go to shared memory once, then the
// block's threads stride over the columns, neighbouring threads on
// neighbouring columns, so the column reads and the row write are
// coalesced; each element of a saved row is read by the thread that then
// overwrites it. Blocks past kmax take VEC_TILE entries of [Tp] each: they
// copy asg and lvl into asg0 and lvl0, meet at a __syncthreads(), then set
// the arrival rows that fall in their tile, so each entry has one writer
// at a time.
#include "common.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr int VEC_TILE = 2048;

}  // namespace

// The launch's pointers and sizes, laid out as the ctypes Structure
// `_Args` of kernels/express_rows.py: every field 8 bytes.
struct RowsArgs {
  const int* w_s;        // [kmax]
  const int* u_s;        // [kmax]
  const int* pc_s;       // [kmax, pk]
  const int* add_row;    // [kmax]
  const int* add_pm;     // [kmax, pk]
  const int* add_pr;     // [kmax, pk]
  const int* dgen;       // [Mp]
  const int* ra_s;       // [Mp]
  const int* rack_of;    // [Mp]
  const int* s;          // [Mp]
  int* c;                // [c_rows, Mp], rows row0.. of the table
  int* c_saved;          // [kmax, Mp] or null
  int* u;                // [Tp] or null (then w .. lvl0 are null too)
  int* w;
  unsigned char* valid;
  const int* asg;
  const int* lvl;
  int* asg0;
  int* lvl0;
  long long kmax, pk, Tp, Mp, row0, c_rows;
};

namespace {

__device__ void arrival_row(const RowsArgs& a, int k, int* prefs) {
  const int r = a.add_row[k];
  const int pk = static_cast<int>(a.pk);
  const int Mp = static_cast<int>(a.Mp);
  if (a.u != nullptr && r >= 0 && r < a.Tp && threadIdx.x == 0) {
    a.u[r] = a.u_s[k];
    a.w[r] = a.w_s[k];
    a.valid[r] = 1;
  }
  const long long local = static_cast<long long>(r) - a.row0;
  if (r < 0 || r >= a.Tp || local < 0 || local >= a.c_rows) return;  // uniform
  for (int j = threadIdx.x; j < pk; j += blockDim.x) {
    prefs[j] = a.add_pm[k * pk + j];
    prefs[pk + j] = a.add_pr[k * pk + j];
    prefs[2 * pk + j] = a.pc_s[k * pk + j];
  }
  __syncthreads();
  const int w = a.w_s[k];
  int* out = a.c + local * Mp;
  int* saved = a.c_saved != nullptr ? a.c_saved + static_cast<size_t>(k) * Mp : nullptr;
  for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
    int v = min(pt::wrap_add(w, a.dgen[m]), pt::INF);
    const int rk = a.rack_of[m];
    const int ra = a.ra_s[m];
    for (int j = 0; j < pk; ++j) {
      const int pm = prefs[j];
      const int pr = prefs[pk + j];
      const int pc = prefs[2 * pk + j];
      if (pm >= 0 && pm == m) v = min(v, pc);
      if (pr >= 0 && pr == rk) v = min(v, min(pt::wrap_add(pc, ra), pt::INF));
    }
    if (saved != nullptr) saved[m] = out[m];
    out[m] = a.s[m] > 0 ? v : pt::INF;
  }
}

__device__ void vector_tile(const RowsArgs& a, int tile) {
  const int t0 = tile * VEC_TILE;
  const int t1 = static_cast<int>(min(static_cast<long long>(t0 + VEC_TILE), a.Tp));
  for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    a.asg0[t] = a.asg[t];
    a.lvl0[t] = a.lvl[t];
  }
  __syncthreads();  // the copies land before the arrival rows overwrite them
  for (int k = threadIdx.x; k < a.kmax; k += blockDim.x) {
    const int r = a.add_row[k];
    if (r >= t0 && r < t1) {
      a.asg0[r] = -1;
      a.lvl0[r] = 0;
    }
  }
}

__global__ void __launch_bounds__(ROW_THREADS) express_rows_kernel(const RowsArgs a) {
  extern __shared__ int prefs[];  // [3][pk]: machine, rack, cost
  if (blockIdx.x < a.kmax)
    arrival_row(a, blockIdx.x, prefs);
  else
    vector_tile(a, blockIdx.x - static_cast<int>(a.kmax));
}

}  // namespace

extern "C" int express_rows_launch(const RowsArgs* a, void* stream) {
  const long long tiles = a->u != nullptr ? (a->Tp + VEC_TILE - 1) / VEC_TILE : 0;
  const long long blocks = a->kmax + tiles;
  if (blocks > 0)
    express_rows_kernel<<<static_cast<unsigned>(blocks), ROW_THREADS,
                          3 * a->pk * static_cast<int>(sizeof(int)),
                          static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
