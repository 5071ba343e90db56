// K5 express_patch: retire table rows and apply seat deltas for one
// chunk of the express lane's patch backlog, in place.
//
// Replaces: poseidon_tpu/ops/resident.py:320 `_express_patch` (one XLA
// scatter program per chunk on the TPU). For each entry i of the chunk:
//   rows[i] in [0, Tp):  valid = 0, u = 0, w = INF, asg = Mp, lvl = 0
//   cols[i] in [0, Mp):  s[cols[i]] += deltas[i]
// and only after every add of the chunk, s = max(s, 0) over all of s.
// Entries of -1 (or past the axis) are dropped, as the reference's
// `mode="drop"` scatters drop them. Duplicate columns sum. The clamp sits
// between chunks in the reference, so the wrapper launches once per
// chunk, in order: a -2 in one chunk and a +1 in the next give another s
// than one add of the whole backlog followed by one clamp.
//
// Bound: bytes, and far below one launch's fixed cost. A full 1024-entry
// chunk at the flagship reads 12 KiB of entries and s (4 KiB), and
// writes at most 1024 x 17 B of rows and s: about 30 KiB, 0.01 us at
// 3.35 TB/s. The kernel is launch-bound.
//
// Design: the simple one. One block; its threads stride over the chunk's
// entries, write the retired rows (duplicate rows write the same values)
// and add the deltas with global atomics, so duplicate columns sum in any
// order to the same total. __syncthreads() then orders every add before
// the clamp, which the same threads apply striding over Mp; the clamp's
// loads bypass L1 (__ldcg), where the atomics did not go.
#include "common.cuh"

namespace {

constexpr int PATCH_THREADS = 1024;

__global__ void __launch_bounds__(PATCH_THREADS) express_patch_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols, const int* __restrict__ deltas,
    int n, int* __restrict__ u, int* __restrict__ w, unsigned char* __restrict__ valid,
    int* __restrict__ asg, int* __restrict__ lvl, int* s, int Tp, int Mp) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = rows[i];
    if (r >= 0 && r < Tp) {
      valid[r] = 0;
      u[r] = 0;
      w[r] = pt::INF;
      asg[r] = Mp;
      lvl[r] = 0;
    }
    const int col = cols[i];
    if (col >= 0 && col < Mp) atomicAdd(&s[col], deltas[i]);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
    if (__ldcg(&s[m]) < 0) s[m] = 0;
  }
}

}  // namespace

extern "C" int express_patch_launch(const int* rows, const int* cols, const int* deltas, int* u,
                                    int* w, unsigned char* valid, int* asg, int* lvl, int* s,
                                    int n, int Tp, int Mp, void* stream) {
  express_patch_kernel<<<1, PATCH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, cols, deltas, n, u, w, valid, asg, lvl, s, Tp, Mp);
  return static_cast<int>(cudaGetLastError());
}
