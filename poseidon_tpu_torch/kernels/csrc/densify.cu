// K1 densify: the dense [Tp, Mp] int32 cost table of the auction.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:311 `_densify` (the XLA
// fusion that built c on the TPU). For each cell,
//   c[t, m] = min(w[t] + d[m], INF,
//                 pc[t, k]          where pm[t, k] == m,
//                 pc[t, k] + ra[m]  where pr[t, k] == rack_of[m])
// over the n_prefs preference columns, and INF where slots[m] == 0. A
// preference index of -1 never hits.
//
// Bound: bytes. The pass writes Tp*Mp*4 B (41,943,040 B at the flagship
// Tp = 10240, Mp = 1024) and reads ~0.3 MB of channel vectors; it does a
// few integer operations per byte written, far below the card's
// compute roof. At 3.35 TB/s the write alone takes 12.5 us.
//
// Design: each thread owns 4 adjacent columns of ROWS = 8 rows and
// stores each row's 4 values as one 16-byte int4, so a warp writes 512
// contiguous bytes per row. The per-column vectors (d, ra, rack_of,
// slots) are loaded once per thread into registers and reused across
// the 8 rows, so the machine side is read Tp/8 times from L2 instead of
// Tp times. The rows are unrolled: the loads of all 8 rows' task values
// and preference triples (broadcast loads: every thread of a row reads
// the same address) are in flight together instead of one row's
// latency after another's. No shared memory, no synchronisation.
#include "common.cuh"

namespace {

constexpr int COLS = 4;
constexpr int ROWS = 8;

__global__ void __launch_bounds__(pt::THREADS) densify_kernel(
    const int* __restrict__ w, const int* __restrict__ d, const int* __restrict__ ra,
    const int* __restrict__ rack_of, const int* __restrict__ slots, const int* __restrict__ pc,
    const int* __restrict__ pm, const int* __restrict__ pr, int* __restrict__ c, int Tp, int Mp,
    int n_prefs, int p_stride) {
  const int m0 = (blockIdx.y * pt::THREADS + threadIdx.x) * COLS;
  if (m0 >= Mp) return;
  const int4 dv = *reinterpret_cast<const int4*>(d + m0);
  const int4 rav = *reinterpret_cast<const int4*>(ra + m0);
  const int4 rkv = *reinterpret_cast<const int4*>(rack_of + m0);
  const int4 slv = *reinterpret_cast<const int4*>(slots + m0);
  const int dm[COLS] = {dv.x, dv.y, dv.z, dv.w};
  const int ram[COLS] = {rav.x, rav.y, rav.z, rav.w};
  const int rk[COLS] = {rkv.x, rkv.y, rkv.z, rkv.w};
  const int sl[COLS] = {slv.x, slv.y, slv.z, slv.w};

  const int t0 = blockIdx.x * ROWS;
  int out[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int wt = t0 + r < Tp ? w[t0 + r] : 0;
#pragma unroll
    for (int j = 0; j < COLS; ++j) out[r][j] = min(pt::wrap_add(wt, dm[j]), pt::INF);
  }
  for (int k = 0; k < n_prefs; ++k) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      // a row past Tp reads "no preference" (-1) and is never stored
      const bool live = t0 + r < Tp;
      const size_t o = static_cast<size_t>(live ? t0 + r : 0) * p_stride + k;
      const int pmk = live ? pm[o] : -1;
      const int prk = live ? pr[o] : -1;
      const int pck = pc[o];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (pmk >= 0 && pmk == m0 + j) out[r][j] = min(out[r][j], pck);
        if (prk >= 0 && prk == rk[j])
          out[r][j] = min(out[r][j], min(pt::wrap_add(pck, ram[j]), pt::INF));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (sl[j] <= 0) out[r][j] = pt::INF;
    if (t0 + r < Tp)
      *reinterpret_cast<int4*>(c + static_cast<size_t>(t0 + r) * Mp + m0) =
          make_int4(out[r][0], out[r][1], out[r][2], out[r][3]);
  }
}

}  // namespace

extern "C" int densify_launch(const int* w, const int* d, const int* ra, const int* rack_of,
                              const int* slots, const int* pc, const int* pm, const int* pr, int* c,
                              int Tp, int Mp, int n_prefs, int p_stride, void* stream) {
  const dim3 grid((Tp + ROWS - 1) / ROWS, (Mp + pt::THREADS * COLS - 1) / (pt::THREADS * COLS));
  densify_kernel<<<grid, pt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w, d, ra, rack_of, slots, pc, pm, pr, c, Tp, Mp, n_prefs, p_stride);
  return static_cast<int>(cudaGetLastError());
}
