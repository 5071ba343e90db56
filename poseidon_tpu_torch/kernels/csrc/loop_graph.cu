// K14 loop_ctl, and the pieces the port's device loops are built from as
// CUDA graphs.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:946-951, the `cond` and the
// `lax.while_loop` of `_solve`, with the `lax.cond`s of its `body`
// (:839-938: run_round :845, phase_shift :856, refight :885, tighten
// :895) as the branch choice; and the conditions of the general lane's
// nested `lax.while_loop`s: poseidon_tpu/ops/cost_scaling.py:283 (the
// phases), :258 (the refine bursts), :212 (the global update's
// Bellman-Ford), and poseidon_tpu/ops/ssp.py:165 (the paths) and :120 (its
// Bellman-Ford). The reference runs each loop as one device program; so does
// the port on the card: the host launches one graph a solve and reads nothing
// until the solve's result fetch.
//
// This file holds no loop's topology. kernels/loop_graph.py describes each
// loop (which captured bodies, K14 steps and conditional nodes, in which
// order and nesting) and builds it from the entry points below: a graph, a
// conditional handle, a child-graph node (a body the port captured from its
// own PyTorch code and kernels), a K14 node, an IF or WHILE node with its
// body graph, the copy of the tally to pinned host memory, instantiation.
// Nodes of one graph run in the order they were added (each depends on the
// one before).
//
// K14 is one thread. It reads its arguments from one struct (`LoopCtl`, laid
// out as kernels/loop_graph.py's `_Ctl`). Its modes:
//   ENTER, NEXT: h0 = !done && rounds < max_rounds (the auction's cond);
//                ENTER also counts the launch in tally[4]
//   BRANCH:      a = any_waiting; codes = (a, !a, 0, 0); h0, h1 = a, !a
//                (the IF handles of the round and the phase shift)
//   PHASE:       a = any violator now; codes[2..3] = (a, !a); h0, h1 = a, !a
//                (the IF handles of the refight and the tighten)
//   LOOP:        go = every term i holds, term i being
//                (lhs[i] ? *lhs[i] : 0) < (rhs[i] ? *rhs[i] : 1) (a term
//                with neither pointer is left out); tally[go_slot] += go,
//                tally[run_slot] += 1 (a slot < 0: none); h0 (and h1, when
//                there are two handles) = go. A general loop's condition,
//                e.g. `changed & it < NN` is the terms (0 < changed) and
//                (it < NN), `!done` is (done < 1).
// The tally counts, over the graph's life, how often each branch or loop
// body ran (the host turns it into the launch counts of the kernels in the
// bodies). `n_handles` is 0 in the eager launch that holds K14 against its
// plain twin (no graph, no handles).
//
// Bound: one launch latency. K14 reads and writes a few words; the graph's
// node launches, not bytes or operations, are its cost. What the design
// removes is the host: the reference's loop costs one device program, and
// so does the port's.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int LG_TERMS = 3;

// K14's arguments (outside the anonymous namespace: the C entry points
// take it, and must keep external linkage).
struct LoopCtl {
  const int* lhs[LG_TERMS];
  const int* rhs[LG_TERMS];
  const uint8_t* flag;
  const int* rounds;
  const int* max_rounds;
  const uint8_t* done;
  int* codes;
  int* tally;
  cudaGraphConditionalHandle h0;
  cudaGraphConditionalHandle h1;
  int mode;
  int go_slot;
  int run_slot;
  int n_handles;
};

namespace {

enum Mode { CTL_ENTER = 0, CTL_BRANCH = 1, CTL_PHASE = 2, CTL_NEXT = 3, CTL_LOOP = 4 };
__device__ __forceinline__ void set(const LoopCtl& c, int v0, int v1) {
  if (c.n_handles > 0) cudaGraphSetConditional(c.h0, v0);
  if (c.n_handles > 1) cudaGraphSetConditional(c.h1, v1);
}

__global__ void loop_ctl_kernel(const LoopCtl c) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  if (c.mode == CTL_LOOP) {
    int go = 1;
#pragma unroll
    for (int i = 0; i < LG_TERMS; ++i) {
      if (c.lhs[i] == nullptr && c.rhs[i] == nullptr) continue;
      const int a = c.lhs[i] ? *c.lhs[i] : 0;
      const int b = c.rhs[i] ? *c.rhs[i] : 1;
      go &= a < b ? 1 : 0;
    }
    if (c.go_slot >= 0) c.tally[c.go_slot] += go;
    if (c.run_slot >= 0) c.tally[c.run_slot] += 1;
    set(c, go, go);
  } else if (c.mode == CTL_BRANCH || c.mode == CTL_PHASE) {
    const int a = c.flag[0] != 0 ? 1 : 0;
    const int lo = c.mode == CTL_BRANCH ? 0 : 2;
    if (c.mode == CTL_BRANCH) c.codes[2] = c.codes[3] = 0;
    c.codes[lo] = a;
    c.codes[lo + 1] = 1 - a;
    c.tally[lo] += a;
    c.tally[lo + 1] += 1 - a;
    set(c, a, 1 - a);
  } else {
    const int go = (c.done[0] == 0 && c.rounds[0] < c.max_rounds[0]) ? 1 : 0;
    if (c.mode == CTL_ENTER) c.tally[4] += 1;
    set(c, go, go);
  }
}

// A node's dependency: the node before it in its graph, if any.
struct Dep {
  cudaGraphNode_t node;
  explicit Dep(void* d) : node(static_cast<cudaGraphNode_t>(d)) {}
  const cudaGraphNode_t* ptr() const { return node ? &node : nullptr; }
  size_t n() const { return node ? 1 : 0; }
};

}  // namespace

extern "C" int lg_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return static_cast<int>(e);
}

// A conditional handle of `graph` (the graph that will hold its node), set
// by a K14 node before the node runs.
extern "C" int lg_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  const cudaError_t e = cudaGraphConditionalHandleCreate(&h, static_cast<cudaGraph_t>(graph), 0, 0);
  *handle = h;
  return static_cast<int>(e);
}

// A child-graph node of `child` after `dep` (none: the graph's first node).
// The child is cloned into the graph, so the caller keeps owning it.
extern "C" int lg_child(void* graph, void* dep, void* child, void** node) {
  const Dep d(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e = cudaGraphAddChildGraphNode(&n, static_cast<cudaGraph_t>(graph),
                                                   d.ptr(), d.n(),
                                                   static_cast<cudaGraph_t>(child));
  *node = n;
  return static_cast<int>(e);
}

// A K14 node with the arguments `*ctl` (copied into the node).
extern "C" int lg_ctl(void* graph, void* dep, const LoopCtl* ctl, void** node) {
  LoopCtl c = *ctl;
  void* args[] = {&c};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_ctl_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(32);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  const Dep d(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e =
      cudaGraphAddKernelNode(&n, static_cast<cudaGraph_t>(graph), d.ptr(), d.n(), &p);
  *node = n;
  return static_cast<int>(e);
}

// An IF (`is_while` 0) or WHILE (1) node on `handle` after `dep`; its body
// graph comes back in `body`.
extern "C" int lg_cond(void* graph, void* dep, unsigned long long handle, int is_while, void** node,
                       void** body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  const Dep d(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e =
      cudaGraphAddNode(&n, static_cast<cudaGraph_t>(graph), d.ptr(), d.n(), &p);
  *node = n;
  *body = e == cudaSuccess ? p.conditional.phGraph_out[0] : nullptr;
  return static_cast<int>(e);
}

// A copy of `bytes` from device memory to pinned host memory after `dep`.
extern "C" int lg_copy(void* graph, void* dep, void* host, const void* device, long long bytes,
                       void** node) {
  const Dep d(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e = cudaGraphAddMemcpyNode1D(&n, static_cast<cudaGraph_t>(graph), d.ptr(),
                                                 d.n(), host, device,
                                                 static_cast<size_t>(bytes),
                                                 cudaMemcpyDeviceToHost);
  *node = n;
  return static_cast<int>(e);
}

extern "C" int lg_instantiate(void* graph, void** exec) {
  cudaGraphExec_t x = nullptr;
  const cudaError_t e = cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph), 0);
  *exec = x;
  return static_cast<int>(e);
}

extern "C" int lg_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int lg_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return static_cast<int>(e);
}

// One eager K14 launch (the caller sets n_handles 0): the check of K14
// against its plain twin.
extern "C" int loop_ctl_launch(const LoopCtl* ctl, void* stream) {
  loop_ctl_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(*ctl);
  return static_cast<int>(cudaGetLastError());
}
