// K10 bf_relax: one Bellman-Ford relaxation round over the residual CSR.
//
// Two entry points, one per reference loop:
//
// `out` replaces poseidon_tpu/ops/cost_scaling.py:193-200, `bf_round` of
// the global price update: over node v's residual out-arcs,
//   best[v] = min of d[head] + ln[arc]  (arcs with residual capacity and
//             d[head] < INF_K; int64),  d' = min(d, best),
//   changed |= d' < d.
// The torch side writes ln = INF_K on arcs without residual capacity, so
// `ln < INF_K` is the capacity test. (A residual arc whose length reaches
// INF_K gives a via >= INF_K, which cannot lower d <= INF_K: skipping it
// changes nothing.)
//
// `in` replaces poseidon_tpu/ops/ssp.py:104-116, SSP's `round_`: over node
// v's residual in-arcs m,
//   cand[m]  = dist[tail(m)] + rc[m]  (capacity left and dist < INF; int32)
//   best[v]  = min cand,  improved = best < dist[v],
//   pred[v]  = lowest m with cand == best, written only when improved,
//   dist'    = min(dist, best),  changed |= improved.
// v's in-arcs are the mirrors (a +- F) of its out-arcs, so the one CSR
// serves: position p of v's segment gives m = mirror(arc[p]) with tail
// head[p]. The torch side passes mrc[p] = rc[m] where m has capacity left,
// INF where not (the solver's cost guard keeps |rc| < INF). The mirrors'
// ids do not ascend inside a segment, so the warp takes the lexicographic
// least (cand, m): the lowest arc id among the candidates equal to best.
//
// Both read d/dist from one buffer and write the other (the host swaps
// them between rounds): a head's distance is read by other warps in the
// same launch. pred is written in place (only its owner reads or writes
// it). Each launch zeroes `changed` first.
//
// Bound: bytes. A round reads the whole CSR and the node vector: `out`
// reads seg, head and ln (16 bytes an arc) and d at each head (8), and
// reads and writes d (16 bytes a node): at the flagship (NN 12,290, 2F
// 145,410) ~3.7 MB, 1.1 us at 3.35 TB/s. `in` reads seg, arc, head, mrc
// (12 bytes an arc) and dist at each head (4), reads and writes dist and
// writes pred (12 bytes a node): ~2.5 MB, 0.75 us.
//
// Design: right and simple first, as K9: one warp a node, 32 arcs a step,
// a warp min (int64 for `out`, lexicographic int32 pair for `in`), lane 0
// writes. The aggregator nodes' ~10,000-arc segments set the critical
// path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long INF_K = 1ll << 50;  // cost_scaling.py:172
constexpr int INF = 1 << 30;            // ssp.py:37

__global__ void __launch_bounds__(THREADS) bf_out_kernel(const int* __restrict__ seg,
                                                         const int* __restrict__ head,
                                                         const long long* __restrict__ ln,
                                                         const long long* __restrict__ d_in,
                                                         long long* __restrict__ d_out,
                                                         int* __restrict__ changed, int NN) {
  const int lane = threadIdx.x & 31;
  const int v = static_cast<int>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (v >= NN) return;
  long long best = INF_K;
  for (int p = seg[v] + lane; p < seg[v + 1]; p += 32) {
    const long long l = ln[p];
    if (l < INF_K) {
      const long long dh = d_in[head[p]];
      if (dh < INF_K) best = min(best, dh + l);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(FULL, best, off));
  if (lane == 0) {
    const long long d = d_in[v];
    const long long nd = min(d, best);
    d_out[v] = nd;
    if (nd < d) *changed = 1;
  }
}

__global__ void __launch_bounds__(THREADS) bf_in_kernel(
    const int* __restrict__ seg, const int* __restrict__ arc, const int* __restrict__ head,
    const int* __restrict__ mrc, const int* __restrict__ dist_in, int* __restrict__ dist_out,
    int* __restrict__ pred, int* __restrict__ changed, int NN, int F) {
  const int lane = threadIdx.x & 31;
  const int v = static_cast<int>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (v >= NN) return;
  int best = INF;
  int bm = 2 * F;  // NO_PRED
  for (int p = seg[v] + lane; p < seg[v + 1]; p += 32) {
    const int r = mrc[p];
    if (r >= INF) continue;
    const int du = dist_in[head[p]];
    if (du >= INF) continue;
    const int c = du + r;
    const int a = arc[p];
    const int m = a < F ? a + F : a - F;
    if (c < best || (c == best && m < bm)) {
      best = c;
      bm = m;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(FULL, best, off);
    const int om = __shfl_xor_sync(FULL, bm, off);
    if (ob < best || (ob == best && om < bm)) {
      best = ob;
      bm = om;
    }
  }
  if (lane == 0) {
    const int d = dist_in[v];
    if (best < d) {
      dist_out[v] = best;
      pred[v] = bm;
      *changed = 1;
    } else {
      dist_out[v] = d;
    }
  }
}

}  // namespace

extern "C" int bf_relax_out_launch(const int* seg, const int* head, const long long* ln,
                                   const long long* d_in, long long* d_out, int* changed, int NN,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  bf_out_kernel<<<(NN + WARPS - 1) / WARPS, THREADS, 0, s>>>(seg, head, ln, d_in, d_out, changed,
                                                             NN);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bf_relax_in_launch(const int* seg, const int* arc, const int* head, const int* mrc,
                                  const int* dist_in, int* dist_out, int* pred, int* changed,
                                  int NN, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  bf_in_kernel<<<(NN + WARPS - 1) / WARPS, THREADS, 0, s>>>(seg, arc, head, mrc, dist_in, dist_out,
                                                            pred, changed, NN, F);
  return static_cast<int>(cudaGetLastError());
}
