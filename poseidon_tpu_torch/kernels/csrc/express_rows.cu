// K4 express_rows: build the express lane's arrival rows of the dense
// cost table and write them into c in place.
//
// Replaces: poseidon_tpu/ops/resident.py:486-502, the row build and the
// `c.at[addi].set(row, mode="drop")` scatter of `_express_step` (XLA
// fused them on the TPU). For each arrival lane k with a row r =
// add_row[k] in [0, Tp), and each column m:
//   v = min(w_s[k] + dgen[m], INF)
//   for each preference j: min with pc_s[k, j] where add_pm[k, j] == m,
//                          min with min(pc_s[k, j] + ra_s[m], INF) where
//                          add_pr[k, j] == rack_of[m] (both >= 0)
//   c[r, m] = s[m] > 0 ? v : INF
// Lanes of -1 (or a row past Tp) write nothing. The two sums wrap as
// XLA's int32 does (pt::wrap_add); the INF clamps follow the add.
//
// Bound: bytes, and far below one launch's fixed cost. At the flagship
// (kmax = 16 lanes, Mp = 1024, pk = 3) it reads 4 column vectors (16 KiB)
// and writes 16 rows (64 KiB): about 80 KiB, 0.02 us at 3.35 TB/s. A
// launch costs microseconds, so the kernel is launch-bound.
//
// Design: the simple one. One block per lane; the lane's preferences
// (pk triples) go to shared memory once, then the block's threads stride
// over the columns, neighbouring threads on neighbouring columns, so the
// column reads and the row write are coalesced. Writing in place is safe:
// the express context's table has no other reader, and a degraded batch
// drops the context.
#include "common.cuh"

namespace {

constexpr int ROW_THREADS = 256;

__global__ void __launch_bounds__(ROW_THREADS) express_rows_kernel(
    const int* __restrict__ w_s, const int* __restrict__ pc_s, const int* __restrict__ add_row,
    const int* __restrict__ add_pm, const int* __restrict__ add_pr, const int* __restrict__ dgen,
    const int* __restrict__ ra_s, const int* __restrict__ rack_of, const int* __restrict__ s,
    int* __restrict__ c, int pk, int Tp, int Mp) {
  extern __shared__ int prefs[];  // [3][pk]: machine, rack, cost
  const int k = blockIdx.x;
  const int r = add_row[k];
  if (r < 0 || r >= Tp) return;  // uniform across the block
  for (int j = threadIdx.x; j < pk; j += blockDim.x) {
    prefs[j] = add_pm[k * pk + j];
    prefs[pk + j] = add_pr[k * pk + j];
    prefs[2 * pk + j] = pc_s[k * pk + j];
  }
  __syncthreads();
  const int w = w_s[k];
  int* out = c + static_cast<size_t>(r) * Mp;
  for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
    int v = min(pt::wrap_add(w, dgen[m]), pt::INF);
    const int rk = rack_of[m];
    const int ra = ra_s[m];
    for (int j = 0; j < pk; ++j) {
      const int pm = prefs[j];
      const int pr = prefs[pk + j];
      const int pc = prefs[2 * pk + j];
      if (pm >= 0 && pm == m) v = min(v, pc);
      if (pr >= 0 && pr == rk) v = min(v, min(pt::wrap_add(pc, ra), pt::INF));
    }
    out[m] = s[m] > 0 ? v : pt::INF;
  }
}

}  // namespace

extern "C" int express_rows_launch(const int* w_s, const int* pc_s, const int* add_row,
                                   const int* add_pm, const int* add_pr, const int* dgen,
                                   const int* ra_s, const int* rack_of, const int* s, int* c,
                                   int kmax, int pk, int Tp, int Mp, void* stream) {
  if (kmax > 0 && Mp > 0)
    express_rows_kernel<<<kmax, ROW_THREADS, 3 * pk * static_cast<int>(sizeof(int)),
                          static_cast<cudaStream_t>(stream)>>>(
        w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s, rack_of, s, c, pk, Tp, Mp);
  return static_cast<int>(cudaGetLastError());
}
