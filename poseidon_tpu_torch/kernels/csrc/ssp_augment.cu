// K11 ssp_augment: the path walk and augment of successive shortest paths.
//
// Replaces: poseidon_tpu/ops/ssp.py:130-157, the walk and the flow update
// of `_solve`'s `body` (a `while_loop` that marks the path's arcs in a
// [2F + 1] mask, then one masked update of every flow slot):
//   v = T; until v == S or NN steps: a = pred[v]; bneck = min(bneck,
//   res[a]); v = tail(a)   (a = NO_PRED = 2F has tail T and residual 0)
//   delta = (dist[T] < INF && v == S) ? min(bneck, wanted - routed) : 0
//   flow[a] += delta (forward arc), flow[a - F] -= delta (mirror), once per
//   arc of the path;  routed += delta.
// The launch leaves routed and delta in state[0], state[1] (int32[2]) for
// the host's one read a path.
//
// Two shortcuts give the same result as the full walk: an unreachable T
// routes nothing whatever the walk visits, so it is not walked; and a walk
// that meets NO_PRED takes residual 0 into bneck (delta 0) and returns to
// T, where it repeats itself to the step cap, so it stops there. A walk
// that reaches S visits each arc once (an arc visited twice would put the
// deterministic walk in a cycle that never reaches S), so the second walk,
// which applies delta, touches each path arc once, as the mask does.
//
// Bound: latency, not bytes. A path of h arcs reads 4 ints an arc twice
// and writes one flow int an arc: under 100 bytes at the flagship's 4-arc
// paths (T <- machine <- cluster aggregator <- task <- S, ~0.03 ns at
// 3.35 TB/s), far below one launch. Its time is the chain of h dependent
// loads, twice.
//
// Design: one block of one warp; lane 0 walks (the path is a chain).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 30;  // ssp.py:37

__global__ void ssp_augment_kernel(const int* __restrict__ pred, const int* __restrict__ dist,
                                   const int* __restrict__ fsrc, const int* __restrict__ fdst,
                                   const int* __restrict__ fcap, int* __restrict__ flow,
                                   int* __restrict__ state, int wanted, int S, int T, int NN,
                                   int F) {
  if (threadIdx.x != 0) return;
  const int NO_PRED = 2 * F;
  const bool reachable = dist[T] < INF;
  int v = T;
  int bneck = INF;
  if (reachable) {
    for (int steps = 0; v != S && steps < NN; ++steps) {
      const int a = pred[v];
      if (a == NO_PRED) {
        bneck = 0;
        v = T;
        break;
      }
      bneck = min(bneck, a < F ? fcap[a] - flow[a] : flow[a - F]);
      v = a < F ? fsrc[a] : fdst[a - F];
    }
  }
  const int routed = state[0];
  const int delta = (reachable && v == S) ? min(bneck, wanted - routed) : 0;
  if (delta != 0) {
    for (int u = T; u != S;) {
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
  state[0] = routed + delta;
  state[1] = delta;
}

}  // namespace

extern "C" int ssp_augment_launch(const int* pred, const int* dist, const int* fsrc,
                                  const int* fdst, const int* fcap, int* flow, int* state,
                                  int wanted, int S, int T, int NN, int F, void* stream) {
  ssp_augment_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      pred, dist, fsrc, fdst, fcap, flow, state, wanted, S, T, NN, F);
  return static_cast<int>(cudaGetLastError());
}
