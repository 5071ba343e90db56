// K9 cs_sweep: one discharge sweep of cost-scaling push-relabel.
//
// Replaces: poseidon_tpu/ops/cost_scaling.py:120-170, `_solve`'s `sweep`
// (on the TPU, one body of a `lax.scan` inside the refine `while_loop`).
// Over the 2F residual arcs of the S/T-augmented circulation (residual arc
// a < F is forward arc a, a >= F the mirror of arc a - F), with the
// pre-sweep flow, excess and price:
//   rc[a]    = cost[a] + price[tail] - price[head]          (int64)
//   adm[a]   = res[a] > 0 && rc[a] < 0 && excess[tail] > 0
//   total[v] = sum of res over v's admissible arcs          (int64)
//   choice[v]= lowest admissible arc id of v
//   prop[a]  = min(res, excess[v] * res / max(total[v], 1)) (floor; all >= 0)
//   push[a]  = prop[a] (+ min(res - prop, excess[v] - sum prop) on choice)
//   flow[a] += push (forward) / flow[a - F] -= push (mirror)
//   excess'  = excess + in-pushes - out-pushes
//   price'   = excess > 0 && no admissible arc ? price - eps : price.
//
// Layout: the residual arcs sorted by tail (a stable sort, built once per
// solve by ops/cost_scaling.py): node v's out-arcs are positions
// [seg[v], seg[v+1]), and `arc`, `head`, `cost` hold each position's arc
// id, head node and scaled cost; `tail` (the plan's) its tail. Inside a
// segment the arc ids ascend.
//
// Bound: bytes, and data-dependent. A sweep must read every node's excess
// and price and write its price and excess (24 bytes a node), and read
// each ACTIVE node's segment: per arc its id, head, cost, capacity or
// flow and the head's price (32 bytes), plus a flow write per push. At
// the flagship (NN 12,290, 2F 145,410) a sweep that touches every arc
// moves ~5.0 MB (1.5 us at 3.35 TB/s); most sweeps touch a few segments,
// and the bound is then the ~0.3 MB of node vectors (~0.1 us): one
// launch's fixed cost is far above it. chip_smoke.py computes the bound
// of the sweep it times from that sweep's active segments.
//
// Design (csr_plan.cuh): the work is split by positions. A light block
// takes a run of whole light nodes; a heavy node's segment is dealt over
// the blocks of one thread-block cluster. A node's sweep has two
// dependent passes, both over registers a thread loaded once:
//   pass 1: total (int64 sum) and choice (min) over the whole segment;
//   pass 2: prop = min(res, exc * res / total) with the node's full
//           total; every admissible arc but the choice pushes its share;
//   last:   the choice arc pushes its share plus the remainder
//           min(res - prop, exc - sum prop), after the node's sum of
//           shares, and the node's out-pushes leave its excess.
// A light block keeps each node's sums in shared memory (a node's lanes
// are reduced by shuffles, then one shared atomic a run). A heavy
// cluster's blocks each reduce their chunks, store their pass-1 partials
// into their own slot of every block's shared memory (distributed shared
// memory: one writer a slot, no remote atomics) and meet at a cluster
// barrier; every block then sums the slots to the node's total and
// choice. Their pass-2 sums go to their slots of rank 0, whose block
// finishes the node after a second barrier. (A segment longer than one
// cluster's CLUSTER * CHUNK positions takes several chunks a block, and
// pass 2 reloads them.) Integer sums are exact in any order, so the
// result is the same bit for bit under any split.
//
// eps is read on the device, through its address (the general lane's
// graph, ops/cost_scaling.py, changes it between sweeps): one load a
// thread, the same value in every thread of the launch.
//
// A batch (the reference's `_solve` under `jax.vmap` over cost vectors,
// ops/cost_scaling.py's solve_cost_scaling_batch): B elements share the
// CSR and its plan, and each has its own cost row, flow, excess, price
// and eps, stored element after element. Element b is the grid's y index
// b: every block of a cluster has the same b. Its mask word (mask[b];
// no mask: every element runs) is read on the device: a masked element
// runs as if no node were active, so its blocks write price_out =
// price_in, push nothing and leave its flow, and the launch's copy
// carries its excess into excess_out. A single solve is the batch of one
// with no mask. A batch's byte bound is its running elements' node
// vectors and active segments added up, the shared CSR read once.
//
// Every read is of the pre-sweep state, as the reference's:
//   - price: read from price_in, written to price_out (double buffer);
//   - excess: the launch copies excess_in to excess_out first, then
//     the pushes land in excess_out by integer atomics (they commute);
//     a node reads its own excess from excess_in. The copy stays: one
//     launch cannot order a node's initial excess before another block's
//     push into it;
//   - flow is updated in place. That is safe: a flow slot is read by the
//     tails of its forward and its mirror arc, whose reduced costs are
//     negatives of each other, so at most one of the two is admissible
//     and only that tail writes the slot. The other tail's rc >= 0 makes
//     its arc inadmissible whatever residual capacity it reads (so pass
//     2's reload of a multi-chunk segment finds the same admissible set).
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_plan.cuh"

namespace {

using namespace csr;

__device__ __forceinline__ int residual(const int* __restrict__ fcap, const int* flow, int a,
                                        int F) {
  return a < F ? fcap[a] - flow[a] : flow[a - F];
}

// Push `x` units on residual arc `a` into node `h`.
__device__ __forceinline__ void push(int* flow, int* excess_out, int a, int h, int x, int F) {
  if (a < F) {
    flow[a] += x;
  } else {
    flow[a - F] -= x;
  }
  atomicAdd(&excess_out[h], x);
}

// One chunk's positions as a thread holds them: position
// base + k * THREADS + threadIdx.x for k < ITEMS (a < 0: past the end).
struct Items {
  int a[ITEMS], h[ITEMS], lt[ITEMS], res[ITEMS];
  long long c[ITEMS];
  unsigned adm;  // bit k: position k is admissible
};

__device__ __forceinline__ void load_items(Items& it, int base, const Work& w,
                                           const int* __restrict__ tail,
                                           const int* __restrict__ arc,
                                           const int* __restrict__ head,
                                           const long long* __restrict__ cost) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = base + k * THREADS + static_cast<int>(threadIdx.x);
    const bool ok = p < w.end;
    it.a[k] = ok ? arc[p] : -1;
    it.h[k] = ok ? head[p] : 0;
    it.c[k] = ok ? cost[p] : 0;
    // a light block's local node index; past the end sorts last
    it.lt[k] = w.heavy ? 0 : (ok ? tail[p] - w.lo : MAX_NODES);
  }
}

// The gathers at each position's residual slot and head, and admissibility.
__device__ __forceinline__ void gather(Items& it, const Work& w, int exc_v, long long price_v,
                                       const int* s_exc, const long long* s_price,
                                       const int* __restrict__ fcap, const int* flow,
                                       const long long* __restrict__ price_in, int F) {
  it.adm = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool ok = it.a[k] >= 0;
    const int exc = w.heavy ? exc_v : (ok ? s_exc[it.lt[k]] : 0);
    const long long pt = w.heavy ? price_v : (ok ? s_price[it.lt[k]] : 0);
    const bool act = ok && exc > 0;
    const int res = act ? residual(fcap, flow, it.a[k], F) : 0;
    const long long ph = act ? price_in[it.h[k]] : 0;
    it.res[k] = res;
    if (act && res > 0 && it.c[k] + pt - ph < 0) it.adm |= 1u << k;
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    cs_sweep_kernel(const int4* __restrict__ plan, int n_heavy, int n_light,
                    const int* __restrict__ tail, const int* __restrict__ arc,
                    const int* __restrict__ head, const long long* __restrict__ cost,
                    const int* __restrict__ fcap, int* flow, const int* __restrict__ excess_in,
                    const long long* __restrict__ price_in, const long long* __restrict__ eps_at,
                    int* excess_out, long long* __restrict__ price_out,
                    const int* __restrict__ mask, int NN, int F) {
  // per node of a light block (slot 0 of s_c*: a heavy node's choice record, in rank 0)
  __shared__ long long s_total[MAX_NODES], s_sum[MAX_NODES], s_out[MAX_NODES];
  __shared__ long long s_price[MAX_NODES];
  __shared__ int s_choice[MAX_NODES], s_exc[MAX_NODES];
  __shared__ int s_cres[MAX_NODES], s_cprop[MAX_NODES], s_chead[MAX_NODES];
  __shared__ long long w_sum[WARPS], w_out[WARPS];
  __shared__ int w_choice[WARPS];
  // a heavy cluster's per-block partials, slot r written by rank r
  __shared__ long long p_total[CLUSTER], p_sum[CLUSTER], p_out[CLUSTER];
  __shared__ int p_choice[CLUSTER];

  const Work w = decode(plan, n_heavy, n_light);
  if (w.idle) return;
  // element b's rows; a masked element has no active node
  const int b = static_cast<int>(blockIdx.y);
  const size_t nb = static_cast<size_t>(b) * NN, fb = static_cast<size_t>(b) * F;
  cost += 2 * fb;
  flow += fb;
  excess_in += nb;
  price_in += nb;
  excess_out += nb;
  price_out += nb;
  const bool live = mask == nullptr || mask[b] != 0;
  // eps from the device (a captured sweep takes each run's eps)
  const long long eps = eps_at[b];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31, warp = tid >> 5;
  const int SENT = 2 * F;
  const bool multi = w.first + w.stride < w.end;

  Items it;
  if (!w.heavy) {
    // ---- a light block: nodes [lo, hi), one pass of at most CHUNK ----
    const int n = w.hi - w.lo;
    const int my_exc = tid < n && live ? excess_in[w.lo + tid] : 0;
    const long long my_price = tid < n ? price_in[w.lo + tid] : 0;
    load_items(it, w.first, w, tail, arc, head, cost);
    if (tid < n) {
      s_exc[tid] = my_exc;
      s_price[tid] = my_price;
      s_total[tid] = 0;
      s_choice[tid] = SENT;
      s_sum[tid] = 0;
      s_out[tid] = 0;
    }
    if (!__syncthreads_or(tid < n && my_exc > 0)) {  // no active node
      if (tid < n) price_out[w.lo + tid] = my_price;
      return;
    }
    gather(it, w, 0, 0, s_exc, s_price, fcap, flow, price_in, F);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool adm = (it.adm >> k) & 1u;
      if (!__any_sync(FULL, adm)) continue;
      const Run r = run_of(it.lt[k]);
      const long long tot =
          run_total(adm ? static_cast<long long>(it.res[k]) : 0ll, r, lane, Add());
      const int ch = run_total(adm ? it.a[k] : SENT, r, lane, Min());
      if (lane == r.last && ch != SENT) {
        atomic_add64(&s_total[it.lt[k]], tot);
        atomicMin(&s_choice[it.lt[k]], ch);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool adm = (it.adm >> k) & 1u;
      if (!__any_sync(FULL, adm)) continue;
      const int lt = it.lt[k];
      long long prop = 0, pushed = 0;
      if (adm) {
        const int res = it.res[k];
        prop = min(static_cast<long long>(res),
                   static_cast<long long>(s_exc[lt]) * res / s_total[lt]);
        if (it.a[k] == s_choice[lt]) {
          s_cres[lt] = res;
          s_cprop[lt] = static_cast<int>(prop);
          s_chead[lt] = it.h[k];
        } else if (prop > 0) {
          push(flow, excess_out, it.a[k], it.h[k], static_cast<int>(prop), F);
          pushed = prop;
        }
      }
      const Run r = run_of(lt);
      const long long sum = run_total(prop, r, lane, Add());
      const long long out = run_total(pushed, r, lane, Add());
      if (lane == r.last && lt < MAX_NODES) {
        atomic_add64(&s_sum[lt], sum);
        atomic_add64(&s_out[lt], out);
      }
    }
    __syncthreads();
    if (tid < n) {
      const int v = w.lo + tid;
      const int choice = s_choice[tid];
      if (my_exc <= 0 || choice == SENT) {
        price_out[v] = my_exc > 0 ? my_price - eps : my_price;
        return;
      }
      price_out[v] = my_price;
      const int c_res = s_cres[tid], c_prop = s_cprop[tid];
      const long long extra =
          min(static_cast<long long>(c_res - c_prop), static_cast<long long>(my_exc) - s_sum[tid]);
      const int x = static_cast<int>(c_prop + extra);
      if (x != 0) push(flow, excess_out, choice, s_chead[tid], x, F);
      atomicAdd(&excess_out[v], -static_cast<int>(s_out[tid] + x));
    }
    return;
  }

  // ---- a heavy node v, its segment dealt over the cluster ----
  const int v = w.lo;
  const int exc_v = live ? excess_in[v] : 0;
  const long long price_v = price_in[v];
  load_items(it, w.first, w, tail, arc, head, cost);
  if (exc_v <= 0) {  // the whole cluster reads the same excess
    if (w.rank == 0 && tid == 0) price_out[v] = price_v;
    return;
  }
  cluster_arrive();  // this block has started: the others may write its slots

  long long total = 0;
  int choice = SENT;
  for (int base = w.first; base < w.end; base += w.stride) {
    if (base != w.first) load_items(it, base, w, tail, arc, head, cost);
    gather(it, w, exc_v, price_v, nullptr, nullptr, fcap, flow, price_in, F);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if ((it.adm >> k) & 1u) {
        total += it.res[k];
        choice = min(choice, it.a[k]);
      }
    }
  }
  total = warp_all(total, Add());
  choice = warp_all(choice, Min());
  if (lane == 0) {
    w_sum[warp] = total;
    w_choice[warp] = choice;
  }
  __syncthreads();
  cluster_wait();
  if (tid < CLUSTER) {  // thread q: this block's partial into rank q's slot
    long long bt = 0;
    int bc = SENT;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      bt += w_sum[i];
      bc = min(bc, w_choice[i]);
    }
    *at_rank(&p_total[w.rank], tid) = bt;
    *at_rank(&p_choice[w.rank], tid) = bc;
  }
  cluster_sync();  // every block holds every block's pass-1 partial
  total = 0;
  choice = SENT;
#pragma unroll
  for (int i = 0; i < CLUSTER; ++i) {
    total += p_total[i];
    choice = min(choice, p_choice[i]);
  }
  if (choice == SENT) {  // active with no admissible arc: relabel by eps
    if (w.rank == 0 && tid == 0) price_out[v] = price_v - eps;
    return;
  }

  long long sum = 0, out = 0;
  for (int base = w.first; base < w.end; base += w.stride) {
    if (multi) {
      load_items(it, base, w, tail, arc, head, cost);
      gather(it, w, exc_v, price_v, nullptr, nullptr, fcap, flow, price_in, F);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (!((it.adm >> k) & 1u)) continue;
      const int res = it.res[k];
      const long long prop =
          min(static_cast<long long>(res), static_cast<long long>(exc_v) * res / total);
      sum += prop;
      if (it.a[k] == choice) {  // one holder in the cluster: rank 0's record
        *at_rank(&s_cres[0], 0) = res;
        *at_rank(&s_cprop[0], 0) = static_cast<int>(prop);
        *at_rank(&s_chead[0], 0) = it.h[k];
      } else if (prop > 0) {
        push(flow, excess_out, it.a[k], it.h[k], static_cast<int>(prop), F);
        out += prop;
      }
    }
  }
  sum = warp_all(sum, Add());
  out = warp_all(out, Add());
  if (lane == 0) {
    w_sum[warp] = sum;
    w_out[warp] = out;
  }
  __syncthreads();
  if (tid == 0) {  // this block's pass-2 partial into its slot of rank 0
    long long bs = 0, bo = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      bs += w_sum[i];
      bo += w_out[i];
    }
    *at_rank(&p_sum[w.rank], 0) = bs;
    *at_rank(&p_out[w.rank], 0) = bo;
  }
  cluster_sync();  // rank 0 holds the pass-2 partials and the choice record
  if (w.rank == 0 && tid == 0) {
    sum = out = 0;
#pragma unroll
    for (int i = 0; i < CLUSTER; ++i) {
      sum += p_sum[i];
      out += p_out[i];
    }
    price_out[v] = price_v;
    const int c_res = s_cres[0], c_prop = s_cprop[0];
    const long long extra =
        min(static_cast<long long>(c_res - c_prop), static_cast<long long>(exc_v) - sum);
    const int x = static_cast<int>(c_prop + extra);
    if (x != 0) push(flow, excess_out, choice, s_chead[0], x, F);
    atomicAdd(&excess_out[v], -static_cast<int>(out + x));
  }
}

}  // namespace

// One sweep of B elements (cost [B, 2F], flow [B, F], excess/price
// [B, NN], eps [B], mask [B] or null).
extern "C" int cs_sweep_launch(const int* plan, const int* tail, const int* arc, const int* head,
                               const long long* cost, const int* fcap, int* flow,
                               const int* excess_in, const long long* price_in, int* excess_out,
                               long long* price_out, const long long* eps_at, const int* mask,
                               int n_heavy, int n_light, int NN, int F, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(excess_out, excess_in,
                                  static_cast<size_t>(B) * NN * sizeof(int),
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = grid_blocks(n_heavy, n_light);
  if (blocks == 0 || B == 0) return 0;
  cs_sweep_kernel<<<dim3(blocks, B), THREADS, 0, s>>>(
      reinterpret_cast<const int4*>(plan), n_heavy, n_light, tail, arc, head, cost, fcap, flow,
      excess_in, price_in, eps_at, excess_out, price_out, mask, NN, F);
  return static_cast<int>(cudaGetLastError());
}
