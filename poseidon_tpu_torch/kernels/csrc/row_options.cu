// K2 row_options: per row of v = min(c + p, INF), the least value b1v,
// its first-index argmin m1, and v2 = the least value with column m1
// masked to INF.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:445 `_task_options` (the
// row reductions XLA fused on the TPU). The same masked row-min serves
// the theta clearing's stage two (:531), the violator check (:785),
// deflate (:821), the certificate (:968) and, with p = 0, the
// runner-up of poseidon_tpu/ops/resident.py:280 `_decision_stats`.
//
// Bound: bytes. One launch reads the Tp*Mp*4 B table once (40 MiB at the
// flagship, 12.5 us at 3.35 TB/s) and writes 3*Tp*4 B; a handful of
// integer operations per element is far below the compute roof.
//
// Design: one warp per row, eight rows per 256-thread block. Each lane
// loads its part of the row in 16-byte int4 chunks (a warp reads 512
// contiguous bytes per chunk step), issuing a batch of 8 chunks of c and
// of p before it uses any (a 1024-column row is one batch: all of its
// loads are in flight together), folds them into a running (value,
// index, runner-up) triple, and the warp merges the triples with five shuffle
// steps: no shared memory, no block barrier. Ties in value keep the
// lower index, as jnp.argmin does, so the result equals the reference
// exactly; the runner-up is carried through every merge, so there is no
// second pass over the row.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pt::THREADS) row_options_kernel(
    const int* __restrict__ c, const int* __restrict__ p, int Tp, int Mp, int* __restrict__ b1v,
    int* __restrict__ m1, int* __restrict__ v2) {
  const int row = blockIdx.x * pt::WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= Tp) return;  // whole warps only: no barrier follows
  const int* cr = c + static_cast<size_t>(row) * Mp;
  pt::Top2 acc = pt::top2_empty();
  for (int base = lane * 4; base < Mp; base += pt::LANES * 4 * pt::BATCH) {
    int4 cv[pt::BATCH], pv[pt::BATCH];
#pragma unroll
    for (int u = 0; u < pt::BATCH; ++u) {
      const int m = base + u * pt::LANES * 4;
      if (m < Mp) {
        cv[u] = *reinterpret_cast<const int4*>(cr + m);
        pv[u] = *reinterpret_cast<const int4*>(p + m);
      }
    }
#pragma unroll
    for (int u = 0; u < pt::BATCH; ++u) {
      const int m = base + u * pt::LANES * 4;
      if (m < Mp) {
        pt::top2_push(acc, min(pt::wrap_add(cv[u].x, pv[u].x), pt::INF), m);
        pt::top2_push(acc, min(pt::wrap_add(cv[u].y, pv[u].y), pt::INF), m + 1);
        pt::top2_push(acc, min(pt::wrap_add(cv[u].z, pv[u].z), pt::INF), m + 2);
        pt::top2_push(acc, min(pt::wrap_add(cv[u].w, pv[u].w), pt::INF), m + 3);
      }
    }
  }
  acc = pt::warp_top2(acc);
  if (lane == 0) {
    b1v[row] = acc.v;
    m1[row] = acc.k;
    v2[row] = acc.v2;
  }
}

}  // namespace

extern "C" int row_options_launch(const int* c, const int* p, int* b1v, int* m1, int* v2, int Tp,
                                  int Mp, void* stream) {
  if (Tp > 0)
    row_options_kernel<<<(Tp + pt::WARPS - 1) / pt::WARPS, pt::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(c, p, Tp, Mp, b1v, m1, v2);
  return static_cast<int>(cudaGetLastError());
}
