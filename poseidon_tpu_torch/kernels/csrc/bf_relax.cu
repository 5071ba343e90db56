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
// ids do not ascend inside a segment, so the kernel takes the least
// (cand, m), packed into one int64 as cand * 2^32 + m (m < 2^31): the
// lowest arc id among the candidates equal to best, carried by a plain
// 64-bit min across lanes, chunks and blocks.
//
// `out` also takes a batch (the reference's `_solve` under `jax.vmap`,
// ops/cost_scaling.py's solve_cost_scaling_batch): B elements share the
// CSR and its plan, each with its own ln row, d rows and `changed` word,
// stored element after element; element b is the grid's y index b. A
// masked element (mask[b] == 0; no mask: every element runs) loads no
// arc, so its blocks copy d_in to d_out, and its `changed` word stays 0.
// A single round is the batch of one with no mask. A batch's byte bound
// is the shared CSR (seg, head) once and each element's ln and d.
//
// Both read d/dist from one buffer and write the other: a head's distance
// is read by other blocks in the same launch. `out`'s caller swaps them
// between rounds and zeroes `changed` before each (the launch's memset);
// `in` takes the pair with SSP's parity word on the device (ssp_loop.cuh):
// it reads the first buffer and writes the second when the word is even,
// the other way when it is odd, so a captured round follows the rounds the
// device ran. pred is written in place (only its owner reads or writes it).
//
// `in` also ends its round (ssp_loop.cuh, step 2 of K14 for SSP): the last
// block to finish reads `changed`, advances the parity word and the round
// count, decides the round loop (changed && it < NN), tallies the round,
// writes the go word, sets the WHILE node's handle inside SSP's graph, and
// zeroes `changed` and its ticket for the next round. A round is then one
// kernel node: no memset, no add, no K14 node. The launch always has at
// least one cluster, so some block runs the tail whatever the plan.
//
// Bound: bytes. A round reads the whole CSR and the node vector: `out`
// reads seg, head and ln (16 bytes an arc) and d at each head (8), and
// reads and writes d (16 bytes a node): at the flagship (NN 12,290, 2F
// 145,410) ~3.7 MB, 1.1 us at 3.35 TB/s. `in` reads seg, arc, head, mrc
// (12 bytes an arc) and dist at each head (4), reads and writes dist and
// writes pred (12 bytes a node): ~2.5 MB, 0.75 us.
//
// Design (csr_plan.cuh): a segmented min split by positions. A light
// block takes a run of whole light nodes: a node's lanes are reduced by
// shuffles, one shared-memory atomicMin a run, and one thread a node
// writes it. A heavy node's segment is dealt over one cluster's blocks:
// each block reduces its chunks, its thread 0 stores the block's min into
// the block's own slot of rank 0's shared memory (distributed shared
// memory, one writer a slot, no remote atomics), and rank 0 takes the min
// of the slots and writes the node after a cluster barrier. A min does
// not depend on the order, so the result is the same bit for bit under
// any split.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_plan.cuh"
#include "ssp_loop.cuh"

namespace {

using namespace csr;

constexpr long long INF_K = 1ll << 50;  // cost_scaling.py:172
constexpr int INF = 1 << 30;            // ssp.py:37
constexpr long long LO32 = 1ll << 32;

// `out`: a position's via d[head] + ln; the node keeps min(d, best).
struct Out {
  const int* __restrict__ head;
  const long long* __restrict__ ln;
  const long long* __restrict__ d_in;
  long long* __restrict__ d_out;
  bool live;  // a masked element loads no arc
  __device__ __forceinline__ long long sent() const { return INF_K; }
  __device__ __forceinline__ long long node(int v) const { return d_in[v]; }
  __device__ __forceinline__ void load(int p, bool ok, int& h, int&, long long& x) const {
    ok = ok && live;
    h = ok ? head[p] : 0;
    x = ok ? ln[p] : INF_K;
  }
  __device__ __forceinline__ long long key(int h, int, long long l) const {
    if (l >= INF_K) return INF_K;
    const long long dh = d_in[h];
    return dh < INF_K ? dh + l : INF_K;
  }
  __device__ __forceinline__ void finish(int v, long long d, long long best, int* changed) const {
    const long long nd = min(d, best);
    d_out[v] = nd;
    if (nd < d) *changed = 1;
  }
};

// `in`: a position's (cand, m) packed; the node takes it when cand < dist.
struct In {
  const int* __restrict__ arc;
  const int* __restrict__ head;
  const int* __restrict__ mrc;
  const int* __restrict__ dist_in;
  int* __restrict__ dist_out;
  int* __restrict__ pred;
  int F;
  __device__ __forceinline__ long long sent() const { return INF * LO32 + 2 * F; }
  __device__ __forceinline__ long long node(int v) const { return dist_in[v]; }
  __device__ __forceinline__ void load(int p, bool ok, int& h, int& a, long long& x) const {
    h = ok ? head[p] : 0;
    a = ok ? arc[p] : 0;
    x = ok ? mrc[p] : INF;
  }
  __device__ __forceinline__ long long key(int h, int a, long long r) const {
    if (r >= INF) return sent();
    const int du = dist_in[h];
    if (du >= INF) return sent();
    const int m = a < F ? a + F : a - F;
    return static_cast<long long>(du + static_cast<int>(r)) * LO32 + m;
  }
  __device__ __forceinline__ void finish(int v, long long d, long long best, int* changed) const {
    const long long cand = best >> 32;  // floor: the low word is m >= 0
    if (cand < d) {
      dist_out[v] = static_cast<int>(cand);
      pred[v] = static_cast<int>(best & 0xffffffffll);
      *changed = 1;
    } else {
      dist_out[v] = static_cast<int>(d);
    }
  }
};

// The round's body for one block of the plan: the min of P::key over
// each node's positions, then P::finish per node.
template <class P>
__device__ __forceinline__ void relax(const P& pol, const int4* __restrict__ plan, int n_heavy,
                                      int n_light, const int* __restrict__ tail, int* changed) {
  __shared__ long long s_best[MAX_NODES];  // a light block's nodes
  __shared__ long long w_best[WARPS];
  __shared__ long long s_part[CLUSTER];     // rank 0: each block's min
  const Work w = decode(plan, n_heavy, n_light);
  if (w.idle) return;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31, warp = tid >> 5;
  const long long SENT = pol.sent();
  int h[ITEMS], a[ITEMS], lt[ITEMS];
  long long x[ITEMS], key[ITEMS];
  auto load = [&](int base) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int p = base + k * THREADS + tid;
      const bool ok = p < w.end;
      pol.load(p, ok, h[k], a[k], x[k]);
      lt[k] = w.heavy ? 0 : (ok ? tail[p] - w.lo : MAX_NODES);
    }
  };
  auto gather = [&]() {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) key[k] = pol.key(h[k], a[k], x[k]);
  };

  if (!w.heavy) {
    // ---- a light block: nodes [lo, hi), one pass of at most CHUNK ----
    const int n = w.hi - w.lo;
    const long long mine = tid < n ? pol.node(w.lo + tid) : 0;
    load(w.first);
    if (tid < n) s_best[tid] = SENT;
    __syncthreads();
    gather();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (!__any_sync(FULL, key[k] < SENT)) continue;
      const Run r = run_of(lt[k]);
      const long long m = run_total(key[k], r, lane, Min());
      if (lane == r.last && m < SENT) atomicMin(&s_best[lt[k]], m);
    }
    __syncthreads();
    if (tid < n) pol.finish(w.lo + tid, mine, s_best[tid], changed);
    return;
  }

  // ---- a heavy node v, its segment dealt over the cluster ----
  const int v = w.lo;
  const long long mine = pol.node(v);
  cluster_arrive();  // this block has started: the others may write its slots
  long long best = SENT;
  for (int base = w.first; base < w.end; base += w.stride) {
    load(base);
    gather();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) best = min(best, key[k]);
  }
  best = warp_all(best, Min());
  if (lane == 0) w_best[warp] = best;
  __syncthreads();
  cluster_wait();
  if (tid == 0) {  // this block's min into its slot of rank 0
    long long b = SENT;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) b = min(b, w_best[i]);
    *at_rank(&s_part[w.rank], 0) = b;
  }
  cluster_sync();  // rank 0 holds every block's min
  if (w.rank == 0 && tid == 0) {
    long long b = SENT;
#pragma unroll
    for (int i = 0; i < CLUSTER; ++i) b = min(b, s_part[i]);
    pol.finish(v, mine, b, changed);
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    bf_out_kernel(const int4* __restrict__ plan, int n_heavy, int n_light,
                  const int* __restrict__ tail, const int* __restrict__ head,
                  const long long* __restrict__ ln, const long long* __restrict__ d_in,
                  long long* __restrict__ d_out, int* __restrict__ changed,
                  const int* __restrict__ mask, int NN, int R) {
  // element b's rows
  const int b = static_cast<int>(blockIdx.y);
  const size_t nb = static_cast<size_t>(b) * NN;
  const bool live = mask == nullptr || mask[b] != 0;
  relax(Out{head, ln + static_cast<size_t>(b) * R, d_in + nb, d_out + nb, live}, plan, n_heavy,
        n_light, tail, changed + b);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    bf_in_kernel(const int4* __restrict__ plan, int n_heavy, int n_light,
                 const int* __restrict__ tail, const int* __restrict__ arc,
                 const int* __restrict__ head, const int* __restrict__ mrc, int* dist_a,
                 int* dist_b, int* __restrict__ pred, int F, const ssp::Loop loop) {
  // the buffer pair read and written in turn: dist_a -> dist_b, or the
  // other way when the device's parity word is odd (read here, before the
  // block's ticket: the tail advances the word only after every ticket)
  const bool flip = (loop.words[ssp::D] & 1) != 0;
  relax(In{arc, head, mrc, flip ? dist_b : dist_a, flip ? dist_a : dist_b, pred, F}, plan, n_heavy,
        n_light, tail, loop.words + ssp::CHANGED);
  if (ssp::last_block(loop) && threadIdx.x == 0) ssp::round_tail(loop);
}

}  // namespace

// One `out` round of B elements (ln [B, R], d [B, NN], changed [B], mask
// [B] or null).
extern "C" int bf_relax_out_launch(const int* plan, const int* tail, const int* head,
                                   const long long* ln, const long long* d_in, long long* d_out,
                                   int* changed, const int* mask, int n_heavy, int n_light,
                                   int NN, int R, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, static_cast<size_t>(B) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = grid_blocks(n_heavy, n_light);
  if (blocks == 0 || B == 0) return 0;
  bf_out_kernel<<<dim3(blocks, B), THREADS, 0, s>>>(reinterpret_cast<const int4*>(plan), n_heavy,
                                                    n_light, tail, head, ln, d_in, d_out, changed,
                                                    mask, NN, R);
  return static_cast<int>(cudaGetLastError());
}

// One SSP relaxation round and its end; `loop` (kernels/ssp_loop.py's
// `_Loop`) is copied into the launch. `changed` must be 0 at the launch:
// the solve's words start at 0 and every round's tail leaves it 0.
extern "C" int bf_relax_in_launch(const int* plan, const int* tail, const int* arc, const int* head,
                                  const int* mrc, int* dist_a, int* dist_b, int* pred, int n_heavy,
                                  int n_light, int F, const ssp::Loop* loop, void* stream) {
  const int blocks = grid_blocks(n_heavy, n_light);
  bf_in_kernel<<<blocks > 0 ? blocks : CLUSTER, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(plan), n_heavy, n_light, tail, arc, head, mrc, dist_a, dist_b,
      pred, F, *loop);
  return static_cast<int>(cudaGetLastError());
}
