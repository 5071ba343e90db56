// K3 bid_pass: one Jacobi bidding round's dense pass over the bid window.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:710-746, the bid pass of
// `auction_round` inside `_solve`. For each window slot b with task
// t = btask[b]:
//   vb[m]   = min(c[t, m] + p[m], INF)
//   b1v     = min_m vb[m]
//   rot     = (uint32(t) * 40503) mod Mp          (uint32 arithmetic)
//   m1      = the m with vb[m] == b1v of least tie_rank = (m - rot) mod Mp
//             (a floor modulo, so the rank is in [0, Mp))
//   v2      = min_m vb[m] with column m1 masked to INF
//   c1      = c[t, m1]
//   take_uns = bvalid[b] && u[t] <= b1v
//   beta    = min(int64(min(v2, u[t])) + eps - c1, INF - 1)  (int64, then int32)
// Invalid window slots (bvalid = 0) are computed like any other row; the
// caller's scatter drops them.
//
// Bound: bytes. The window gathers B rows of the table: B*Mp*4 B (10 MiB
// at the flagship B = 2560, Mp = 1024, 3.1 us at 3.35 TB/s), plus p once
// and a few words per row. Arithmetic per element is a handful of
// integer operations.
//
// Design: one warp per window slot, eight slots per 256-thread block,
// each warp reading its task's row in place (no materialised [B, Mp]
// gather) with batched 16-byte int4 loads and merging with shuffles
// only, as in row_options. The rotated tie-break is folded into the reduction key: the
// lexicographic least (value, tie_rank) is exactly "least value, then
// least rank among the tied columns", and tie_rank is a bijection of the
// columns, so the winning column is recovered as (rank + rot) mod Mp.
// The runner-up rides the same reduction as in row_options. Lane 0
// does the O(1) epilogue (c1, take_uns, the int64 bid).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pt::THREADS) bid_pass_kernel(
    const int* __restrict__ c, const int* __restrict__ p, const int* __restrict__ u,
    const int* __restrict__ btask, const uint8_t* __restrict__ bvalid, int B, int Mp, int eps,
    int* __restrict__ m1_out, int* __restrict__ b1v_out, int* __restrict__ v2_out,
    uint8_t* __restrict__ take_uns_out, int* __restrict__ beta_out) {
  const int b = blockIdx.x * pt::WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // whole warps only: no barrier follows
  const int t = btask[b];
  const int rot = static_cast<int>((static_cast<unsigned>(t) * 40503u) % static_cast<unsigned>(Mp));
  const int* cr = c + static_cast<size_t>(t) * Mp;
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
        const int cs[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
        const int ps[4] = {pv[u].x, pv[u].y, pv[u].z, pv[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int rank = m + j - rot;
          if (rank < 0) rank += Mp;
          pt::top2_push(acc, min(pt::wrap_add(cs[j], ps[j]), pt::INF), rank);
        }
      }
    }
  }
  acc = pt::warp_top2(acc);
  if (lane == 0) {
    int m1 = acc.k + rot;
    if (m1 >= Mp) m1 -= Mp;
    const int b1v = acc.v;
    const int v2 = acc.v2;
    const int ub = u[t];
    const int c1 = cr[m1];
    const long long beta =
        min(static_cast<long long>(min(v2, ub)) + eps - c1, static_cast<long long>(pt::INF - 1));
    m1_out[b] = m1;
    b1v_out[b] = b1v;
    v2_out[b] = v2;
    take_uns_out[b] = (bvalid[b] != 0 && ub <= b1v) ? 1 : 0;
    beta_out[b] = static_cast<int>(beta);
  }
}

}  // namespace

extern "C" int bid_pass_launch(const int* c, const int* p, const int* u, const int* btask,
                               const uint8_t* bvalid, int B, int Mp, int eps, int* m1, int* b1v,
                               int* v2, uint8_t* take_uns, int* beta, void* stream) {
  if (B > 0)
    bid_pass_kernel<<<(B + pt::WARPS - 1) / pt::WARPS, pt::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(c, p, u, btask, bvalid, B, Mp, eps, m1,
                                                           b1v, v2, take_uns, beta);
  return static_cast<int>(cudaGetLastError());
}
