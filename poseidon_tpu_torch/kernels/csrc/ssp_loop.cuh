// SSP's loop control, folded into the kernels that compute its conditions
// (sm_90a): K10 `in` (bf_relax.cu) ends a relaxation round, K11
// (ssp_augment.cu) a path step. kernels/ssp_loop.py lays out the same
// words and restates each tail in PyTorch.
//
// Replaces: the K14 `loop_ctl` LOOP steps of SSP's graph (ops/ssp.py, the
// conditions of poseidon_tpu/ops/ssp.py:165 and :120), the memset of
// `changed` before each round and the host-side `add_`s of the parity and
// count words between the bodies.
//
// The last block of a launch to finish (a device-scope ticket taken after
// every block's writes) runs the tail: it reads what the launch computed
// (a round's `changed`; a step's routed and delta), advances the parity
// and count words, which every block read at its start and no block can
// still read once all tickets are in, evaluates the loop's condition,
// tallies it into the solve's graph tally (kernels/loop_graph.py slots),
// writes it to a go word (the host loop's one read) and, inside a graph,
// sets the conditional handle. The handles are made after the bodies are
// captured, so they reach the kernels through a device word written once
// after the graph is built: handles[0] counts them, 0 in an eager launch
// (no graph: nothing is set).
#pragma once

#include <cuda_runtime.h>

namespace ssp {

// words: the dist and pot parities, the path count, the rounds of the
// current path, a round's `changed` flag, the go words of the round loop
// and the path loop, the launch ticket
enum Word { D = 0, P = 1, PATHS = 2, IT = 3, CHANGED = 4, GO_BF = 5, GO_PATH = 6, TICKET = 7 };
enum Limit { WANTED = 0, MAX_PATHS = 1, NN = 2 };
enum Slot { T_ROUND = 3, T_PATH = 2 };   // the solve's tally slots (ops/ssp.py)
enum Handle { H_COUNT = 0, H_BF = 1, H_PATH = 2 };

struct Loop {
  int* words;
  const int* limits;
  int* tally;
  const unsigned long long* handles;
};

__device__ __forceinline__ void set(const Loop& L, int which, int v) {
  if (L.handles[H_COUNT] > 0) cudaGraphSetConditional(L.handles[which], static_cast<unsigned>(v));
}

// Whether this block is the launch's last to finish. Every thread calls it
// after its last write of the launch's results; the fences publish them
// before the block's ticket, and the last block's reads come after.
__device__ __forceinline__ bool last_block(const Loop& L) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = static_cast<int>(gridDim.x * gridDim.y * gridDim.z);
    last = atomicAdd(&L.words[TICKET], 1) == n - 1;
    __threadfence();
  }
  __syncthreads();
  return last != 0;
}

// A relaxation round's end (one thread): it = it + 1, the dist parity
// advances; go = changed && it < NN (the reference's `changed & it < NN`).
__device__ __forceinline__ void round_tail(const Loop& L) {
  int* w = L.words;
  const int changed = atomicExch(&w[CHANGED], 0);
  const int it = w[IT] + 1;
  w[IT] = it;
  w[D] += 1;
  const int go = (changed != 0 && it < L.limits[NN]) ? 1 : 0;
  L.tally[T_ROUND] += go;
  w[GO_BF] = go;
  w[TICKET] = 0;
  set(L, H_BF, go);
}

// A path step's end (one thread): both parities advance; after a path
// (not the prologue) the path count too and the round count restarts, and
// go = routed < wanted && delta > 0 && paths < max_paths decides the next
// path. The round loop is armed for the next path's first round
// (it < NN); the arming counts as that round's entry.
__device__ __forceinline__ void step_tail(const Loop& L, const int* state, bool first) {
  int* w = L.words;
  w[D] += 1;
  w[P] += 1;
  int go = 1;
  if (!first) {
    const int paths = w[PATHS] + 1;
    w[PATHS] = paths;
    w[IT] = 0;
    go = (state[0] < L.limits[WANTED] && 0 < state[1] && paths < L.limits[MAX_PATHS]) ? 1 : 0;
    L.tally[T_PATH] += go;
    w[GO_PATH] = go;
    set(L, H_PATH, go);
  }
  const int arm = (go != 0 && w[IT] < L.limits[NN]) ? 1 : 0;
  L.tally[T_ROUND] += arm;
  w[GO_BF] = arm;
  w[TICKET] = 0;
  set(L, H_BF, arm);
}

}  // namespace ssp
