// K11 ssp_augment: one path step of successive shortest paths, everything
// between two relaxation loops, in one library call.
//
// Replaces: poseidon_tpu/ops/ssp.py:73 `_solve`'s `body` outside its
// relaxation `while_loop`: the walk and the flow update (l.130-157),
// the potential update (l.156), and the next `bellman_ford`'s set-up,
// its reduced costs and capacity mask (l.101-102) and dist0/pred0
// (l.119-120). After the path's relaxation rounds (K10 `in`):
//   v = T; until v == S or NN steps: a = pred[v]; bneck = min(bneck,
//   res[a]); v = tail(a)   (a = NO_PRED = 2F has tail T and residual 0)
//   delta = (dist[T] < INF && v == S) ? min(bneck, wanted - routed) : 0
//   flow[a] += delta (forward arc), flow[a - F] -= delta (mirror), once per
//   arc of the path;  routed += delta;
//   pot' = pot + (dist < INF ? dist : 0);
//   mrc[p] = capacity of m > 0 ? -cost[p] + pot'[head[p]] - pot'[tail[p]]
//            : INF, for the mirror m of arc[p] (K10 `in`'s input, as
//            ops/ssp.py's `mirror_costs_plain`);
//   dist0 = INF but dist0[S] = 0;  pred0 = NO_PRED.
// The first path's step (`first`) is the prologue: no walk, pot' = pot.
// routed and delta land in state[0], state[1] (int32[2]) for the host's
// one read a path. Integer sums wrap as PyTorch's and XLA's int32 do.
//
// The same walk shortcuts as before: an unreachable T routes nothing
// whatever the walk visits, so it is not walked; a walk that meets
// NO_PRED takes residual 0 into bneck (delta 0) and would return to T and
// repeat itself to the step cap, so it stops there. A walk that reaches S
// visits distinct nodes (a deterministic walk that met a node twice would
// cycle and never reach S), so its arcs are distinct and no arc lies on it
// with its mirror: every flow slot it names is named once, and the lanes
// can update them at once without atomics.
//
// Bound: latency. The walk is a chain of dependent loads, two a step
// (pred[v], then the arc's tail); the wide pass reads the CSR's four
// [2F] columns and gathers pot, dist and flow, ~3.7 MB at the flagship
// (1.1 us at 3.35 TB/s), about a launch's fixed cost.
//
// Design: two launches on the caller's stream from one C entry point,
// whose arguments are a host struct of device pointers checked once per
// solve (kernels/ssp_augment.py) and one integer. The buffer indices d
// and p are the low bits of two parity words on the device (SSP's graph,
// ops/ssp.py: the number of relaxation rounds before a step is the
// device's), each kernel picking its buffers from the pairs.
// - `ssp_walk_kernel`, one block: thread 0 walks T -> S once, keeping
//   the first `record` arc ids in shared memory and the bottleneck; the
//   block's threads then add +-delta to the recorded arcs together. A
//   path longer than the record is walked a second time by thread 0 from
//   the node where the record ended, to apply delta to the rest.
// - `ssp_wide_kernel`, one thread per CSR position and node: the new
//   potentials are formed where they are gathered (pot[x] + dist[x]), so
//   no thread waits on another's potential; it writes pot' into the other
//   buffer of the pot pair, and dist0 into the other buffer of the dist
//   pair, never into the `dist` it reads; pred is reset in place (only
//   the walk, which ran before it, reads pred). Its last block to finish
//   ends the step (ssp_loop.cuh, step 2 of K14 for SSP): it advances both
//   parity words and the path count, restarts the round count, decides
//   the path loop (routed < wanted && delta > 0 && paths < max_paths),
//   tallies it, writes the go words and, inside SSP's graph, sets the path
//   loop's handle and arms the round loop's for the next path. The
//   prologue's step only advances the parities and arms the round loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssp_loop.cuh"

namespace {

constexpr int INF = 1 << 30;  // ssp.py:37
constexpr int WALK_THREADS = 128;
constexpr int WIDE_THREADS = 256;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(WALK_THREADS)
    ssp_walk_kernel(const int* __restrict__ pred, const int* dist0, const int* dist1,
                    const int* __restrict__ par, const int* __restrict__ fsrc,
                    const int* __restrict__ fdst, const int* __restrict__ fcap,
                    int* __restrict__ flow, int* __restrict__ state, int wanted, int S, int T,
                    int NN, int F, int record) {
  extern __shared__ int rec[];
  __shared__ int s_delta, s_h, s_rest;
  if (threadIdx.x == 0) {
    const int NO_PRED = 2 * F;
    const int* dist = (par[0] & 1) ? dist1 : dist0;
    const bool reachable = dist[T] < INF;
    int v = T;
    int bneck = INF;
    int h = 0;      // arcs recorded
    int rest = -1;  // the node where the record ended, if it did
    if (reachable) {
      for (int steps = 0; v != S && steps < NN; ++steps) {
        const int a = pred[v];
        if (a == NO_PRED) {
          bneck = 0;
          v = T;
          break;
        }
        if (h < record) {
          rec[h++] = a;
        } else if (rest < 0) {
          rest = v;
        }
        bneck = min(bneck, a < F ? fcap[a] - flow[a] : flow[a - F]);
        v = a < F ? fsrc[a] : fdst[a - F];
      }
    }
    const int routed = state[0];
    const int delta = (reachable && v == S) ? min(bneck, wanted - routed) : 0;
    state[0] = routed + delta;
    state[1] = delta;
    s_delta = delta;
    s_h = h;
    s_rest = rest;
  }
  __syncthreads();
  const int delta = s_delta;
  if (delta == 0) return;
  const int h = s_h;
  for (int i = threadIdx.x; i < h; i += WALK_THREADS) {
    const int a = rec[i];
    if (a < F) {
      flow[a] += delta;
    } else {
      flow[a - F] -= delta;
    }
  }
  if (threadIdx.x == WALK_THREADS - 1 && s_rest >= 0) {
    // the arcs past the record: their slots differ from the recorded ones
    for (int u = s_rest; u != S;) {
      const int a = pred[u];
      if (a < F) {
        flow[a] += delta;
        u = fsrc[a];
      } else {
        flow[a - F] -= delta;
        u = fdst[a - F];
      }
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
    ssp_wide_kernel(const int* __restrict__ arc, const int* __restrict__ head,
                    const int* __restrict__ tail, const int* __restrict__ cost,
                    const int* __restrict__ fcap, const int* __restrict__ flow, int* dist0,
                    int* dist1, int* pot0, int* pot1, int* __restrict__ pred,
                    int* __restrict__ mrc, const int* state, int S, int NN, int F, int R,
                    int first, const ssp::Loop loop) {
  // the step's buffer indices: the low bits of the parity words (read
  // before the block's ticket; the tail advances them after every ticket)
  const int dp = loop.words[ssp::D] & 1, pp = loop.words[ssp::P] & 1;
  const int* __restrict__ dist = dp ? dist1 : dist0;
  int* __restrict__ dist_next = dp ? dist0 : dist1;
  const int* __restrict__ pot = pp ? pot1 : pot0;
  int* __restrict__ pot_next = pp ? pot0 : pot1;
  const int i = blockIdx.x * WIDE_THREADS + threadIdx.x;
  if (i < R) {
    const int a = arc[i];
    const int hd = head[i];
    const int tl = tail[i];
    int ph = pot[hd];
    int pt = pot[tl];
    if (!first) {
      const int dh = dist[hd];
      const int dt = dist[tl];
      ph = wrap_add(ph, dh < INF ? dh : 0);
      pt = wrap_add(pt, dt < INF ? dt : 0);
    }
    const bool fwd = a < F;
    const int slot = fwd ? a : a - F;
    const int f = flow[slot];
    const int cap = fwd ? f : fcap[slot] - f;
    mrc[i] = cap > 0 ? wrap_sub(wrap_sub(ph, cost[i]), pt) : INF;
  }
  if (i < NN) {
    const int d = first ? 0 : dist[i];
    pot_next[i] = wrap_add(pot[i], d < INF ? d : 0);
    dist_next[i] = i == S ? 0 : INF;
    pred[i] = 2 * F;
  }
  if (ssp::last_block(loop) && threadIdx.x == 0) ssp::step_tail(loop, state, first != 0);
}

}  // namespace

// The solve's device pointers and sizes, laid out as the ctypes
// Structure `_Args` of kernels/ssp_augment.py: every field 8 bytes.
struct SspArgs {
  const int* arc;
  const int* head;
  const int* tail;
  const int* cost;
  const int* fcap;
  const int* fsrc;
  const int* fdst;
  int* flow;
  int* pred;
  int* mrc;
  int* state;
  int* dist[2];
  int* pot[2];
  ssp::Loop loop;  // the solve's loop words (d and p: its parities)
  long long wanted, S, T, NN, F, R, record;
};

// One path step: dist[d] holds the path's distances (unread when
// `first`), pot[p] its potentials; the next relaxation reads dist[d ^ 1]
// and the next step pot[p ^ 1]. d and p are the low bits of the loop's
// parity words, read on the device; the step's last block advances them.
extern "C" int ssp_step_launch(const SspArgs* a, int first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = static_cast<int>(a->S), NN = static_cast<int>(a->NN);
  const int F = static_cast<int>(a->F), R = static_cast<int>(a->R);
  if (!first) {
    const int record = static_cast<int>(a->record);
    ssp_walk_kernel<<<1, WALK_THREADS, record * sizeof(int), st>>>(
        a->pred, a->dist[0], a->dist[1], a->loop.words, a->fsrc, a->fdst, a->fcap, a->flow, a->state,
        static_cast<int>(a->wanted), S, static_cast<int>(a->T), NN, F, record);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n = R > NN ? R : NN;
  ssp_wide_kernel<<<(n + WIDE_THREADS - 1) / WIDE_THREADS, WIDE_THREADS, 0, st>>>(
      a->arc, a->head, a->tail, a->cost, a->fcap, a->flow, a->dist[0], a->dist[1], a->pot[0],
      a->pot[1], a->pred, a->mrc, a->state, S, NN, F, R, first, a->loop);
  return static_cast<int>(cudaGetLastError());
}
