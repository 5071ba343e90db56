// K14 loop_ctl and the auction loop as one CUDA graph a solve.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:946-951, the `cond` and the
// `lax.while_loop` of `_solve`, with the `lax.cond`s of its `body`
// (:839-938: run_round :845, phase_shift :856, refight :885, tighten
// :895) as the branch choice. The reference runs the loop as one device
// program; so does this graph: the host launches it once a solve and reads
// nothing until the solve's result fetch.
//
// The graph (built here from the branch bodies the port captured from its
// own PyTorch code and kernels, each a cudaGraph_t):
//
//   ENTER (K14)  ->  WHILE w  ->  tally copy to pinned host memory
//   WHILE body:  head -> BRANCH (K14) -> IF round -> IF phase -> NEXT (K14)
//   IF round:    round
//   IF phase:    pre -> PHASE (K14) -> IF refight -> IF tighten
//   IF refight:  refight            IF tighten: tighten
//
// K14 is one thread. Its modes:
//   ENTER, NEXT: w = !done && rounds < max_rounds (the reference's cond);
//                ENTER also counts the launch in tally[4]
//   BRANCH:      a = any_waiting; codes = (a, !a, 0, 0); the IF handles of
//                the round and the phase shift take a and !a
//   PHASE:       a = any violator now; codes[2..3] = (a, !a); the IF
//                handles of the refight and the tighten take a and !a
// tally[0..3] counts, over the graph's life, how often each branch ran
// (the host turns it into the launch counts of the kernels in the bodies).
// `set_handles` is 0 in the eager launch that holds K14 against its plain
// twin (no graph, no handles).
//
// Bound: one launch latency. K14 reads and writes a few words; the graph's
// node launches, not bytes or operations, are its cost. What the design
// removes is the host: the reference's round costs one device program, and
// so does this solve.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { CTL_ENTER = 0, CTL_BRANCH = 1, CTL_PHASE = 2, CTL_NEXT = 3 };

__global__ void loop_ctl_kernel(int mode, const uint8_t* __restrict__ flag,
                                const int* __restrict__ rounds,
                                const int* __restrict__ max_rounds,
                                const uint8_t* __restrict__ done, int* __restrict__ codes,
                                int* __restrict__ tally, cudaGraphConditionalHandle h0,
                                cudaGraphConditionalHandle h1, int set_handles) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  if (mode == CTL_BRANCH || mode == CTL_PHASE) {
    const int a = flag[0] != 0 ? 1 : 0;
    const int lo = mode == CTL_BRANCH ? 0 : 2;
    if (mode == CTL_BRANCH) codes[2] = codes[3] = 0;
    codes[lo] = a;
    codes[lo + 1] = 1 - a;
    tally[lo] += a;
    tally[lo + 1] += 1 - a;
    if (set_handles) {
      cudaGraphSetConditional(h0, a);
      cudaGraphSetConditional(h1, 1 - a);
    }
  } else {
    const int go = (done[0] == 0 && rounds[0] < max_rounds[0]) ? 1 : 0;
    if (mode == CTL_ENTER) tally[4] += 1;
    if (set_handles) cudaGraphSetConditional(h0, go);
  }
}

struct Ctl {
  int mode;
  const uint8_t* flag;
  const int* rounds;
  const int* max_rounds;
  const uint8_t* done;
  int* codes;
  int* tally;
  cudaGraphConditionalHandle h0;
  cudaGraphConditionalHandle h1;
  int set_handles;
};

cudaError_t add_ctl(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep, Ctl& a) {
  void* args[] = {&a.mode,  &a.flag,  &a.rounds, &a.max_rounds, &a.done,
                  &a.codes, &a.tally, &a.h0,     &a.h1,         &a.set_handles};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_ctl_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(32);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

// A conditional node of `type` on handle `h` after `dep`; its body graph
// comes back in `body`.
cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep,
                     cudaGraphConditionalHandle h, cudaGraphConditionalNodeType type,
                     cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  const cudaError_t e = cudaGraphAddNode(node, g, dep, dep ? 1 : 0, &p);
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

cudaError_t add_child(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep,
                      cudaGraph_t child) {
  return cudaGraphAddChildGraphNode(node, g, dep, dep ? 1 : 0, child);
}

}  // namespace

#define LG_CHECK(x)                          \
  do {                                       \
    const cudaError_t e_ = (x);              \
    if (e_ != cudaSuccess) {                 \
      if (outer) cudaGraphDestroy(outer);    \
      return static_cast<int>(e_);           \
    }                                        \
  } while (0)

// Build and instantiate the loop's graph. `bodies` holds the five captured
// graphs: head, round, pre, refight, tighten (cloned into the graph, so the
// caller keeps owning them). `any_waiting` is written by head, `any_now` by
// pre; `rounds`, `max_rounds` and `done` are the loop state; `codes`
// int32[4] and `tally` int32[8] are K14's; `tally_host` (pinned, int32[8])
// receives the tally at the end of every launch.
extern "C" int loop_graph_build(void* const* bodies, const uint8_t* any_waiting,
                                const uint8_t* any_now, const int* rounds,
                                const int* max_rounds, const uint8_t* done, int* codes,
                                int* tally, int* tally_host, void** graph_out,
                                void** exec_out) {
  cudaGraph_t outer = nullptr;
  LG_CHECK(cudaGraphCreate(&outer, 0));
  cudaGraph_t head = static_cast<cudaGraph_t>(bodies[0]);
  cudaGraph_t round = static_cast<cudaGraph_t>(bodies[1]);
  cudaGraph_t pre = static_cast<cudaGraph_t>(bodies[2]);
  cudaGraph_t refight = static_cast<cudaGraph_t>(bodies[3]);
  cudaGraph_t tighten = static_cast<cudaGraph_t>(bodies[4]);

  cudaGraphConditionalHandle hw;
  LG_CHECK(cudaGraphConditionalHandleCreate(&hw, outer, 0, 0));
  Ctl c = {CTL_ENTER, nullptr, rounds, max_rounds, done, codes, tally, hw, hw, 1};
  cudaGraphNode_t enter, wnode, copy;
  LG_CHECK(add_ctl(&enter, outer, nullptr, c));
  cudaGraph_t wbody;
  LG_CHECK(add_cond(&wnode, outer, &enter, hw, cudaGraphCondTypeWhile, &wbody));
  LG_CHECK(cudaGraphAddMemcpyNode1D(&copy, outer, &wnode, 1, tally_host, tally, 8 * sizeof(int),
                                    cudaMemcpyDeviceToHost));

  // the loop body
  cudaGraphConditionalHandle hr, hp;
  LG_CHECK(cudaGraphConditionalHandleCreate(&hr, wbody, 0, 0));
  LG_CHECK(cudaGraphConditionalHandleCreate(&hp, wbody, 0, 0));
  cudaGraphNode_t n_head, n_branch, n_round, n_phase, n_next;
  LG_CHECK(add_child(&n_head, wbody, nullptr, head));
  Ctl b = {CTL_BRANCH, any_waiting, rounds, max_rounds, done, codes, tally, hr, hp, 1};
  LG_CHECK(add_ctl(&n_branch, wbody, &n_head, b));
  cudaGraph_t rbody, pbody;
  LG_CHECK(add_cond(&n_round, wbody, &n_branch, hr, cudaGraphCondTypeIf, &rbody));
  LG_CHECK(add_cond(&n_phase, wbody, &n_round, hp, cudaGraphCondTypeIf, &pbody));
  Ctl nx = {CTL_NEXT, nullptr, rounds, max_rounds, done, codes, tally, hw, hw, 1};
  LG_CHECK(add_ctl(&n_next, wbody, &n_phase, nx));

  cudaGraphNode_t n_round_body;
  LG_CHECK(add_child(&n_round_body, rbody, nullptr, round));

  // the phase shift
  cudaGraphConditionalHandle hf, ht;
  LG_CHECK(cudaGraphConditionalHandleCreate(&hf, pbody, 0, 0));
  LG_CHECK(cudaGraphConditionalHandleCreate(&ht, pbody, 0, 0));
  cudaGraphNode_t n_pre, n_ctl2, n_refight, n_tighten;
  LG_CHECK(add_child(&n_pre, pbody, nullptr, pre));
  Ctl ph = {CTL_PHASE, any_now, rounds, max_rounds, done, codes, tally, hf, ht, 1};
  LG_CHECK(add_ctl(&n_ctl2, pbody, &n_pre, ph));
  cudaGraph_t fbody, tbody;
  LG_CHECK(add_cond(&n_refight, pbody, &n_ctl2, hf, cudaGraphCondTypeIf, &fbody));
  LG_CHECK(add_cond(&n_tighten, pbody, &n_refight, ht, cudaGraphCondTypeIf, &tbody));
  cudaGraphNode_t n_f, n_t;
  LG_CHECK(add_child(&n_f, fbody, nullptr, refight));
  LG_CHECK(add_child(&n_t, tbody, nullptr, tighten));

  cudaGraphExec_t exec = nullptr;
  LG_CHECK(cudaGraphInstantiate(&exec, outer, 0));
  *graph_out = outer;
  *exec_out = exec;
  return 0;
}

#undef LG_CHECK

extern "C" int loop_graph_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int loop_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return static_cast<int>(e);
}

// One eager K14 launch without handles: the check of K14 against its
// plain twin.
extern "C" int loop_ctl_launch(int mode, const uint8_t* flag, const int* rounds,
                               const int* max_rounds, const uint8_t* done, int* codes,
                               int* tally, void* stream) {
  loop_ctl_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, flag, rounds, max_rounds, done, codes, tally, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}
