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
// id, head node and scaled cost. Inside a segment the arc ids ascend.
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
// Design: right and simple first. One warp a node (8 warps a block, no
// grid-stride loop: NN warps in all). An inactive node writes its price
// and stops. An active node's warp walks its segment twice, 32 arcs a
// step: first total (int64 warp sum), choice (warp min) and has_adm; then
// the proportional pushes. The choice arc's push (its share plus the
// remainder) is applied by lane 0 after the warp's sum of shares. The
// aggregator nodes (degree ~10,000 at the flagship) loop ~313 steps a
// pass: they set the sweep's critical path.
//
// Every read is of the pre-sweep state, as the reference's:
//   - price: read from price_in, written to price_out (double buffer);
//   - excess: the launch copies excess_in to excess_out first, then
//     the pushes land in excess_out by integer atomics (they commute);
//     a node reads its own excess from excess_in;
//   - flow is updated in place. That is safe: a flow slot is read by the
//     tails of its forward and its mirror arc, whose reduced costs are
//     negatives of each other, so at most one of the two is admissible
//     and only that tail writes the slot. The other tail's rc >= 0 makes
//     its arc inadmissible whatever residual capacity it reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ long long warp_sum64(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ int warp_min32(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

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

__global__ void __launch_bounds__(THREADS) cs_sweep_kernel(
    const int* __restrict__ seg, const int* __restrict__ arc, const int* __restrict__ head,
    const long long* __restrict__ cost, const int* __restrict__ fcap, int* flow,
    const int* __restrict__ excess_in, const long long* __restrict__ price_in, long long eps,
    int* excess_out, long long* __restrict__ price_out, int NN, int F) {
  const int lane = threadIdx.x & 31;
  const int v = static_cast<int>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (v >= NN) return;  // the whole warp leaves together
  const int exc = excess_in[v];
  const long long pv = price_in[v];
  if (exc <= 0) {
    if (lane == 0) price_out[v] = pv;
    return;
  }
  const int b = seg[v], e = seg[v + 1];
  const int SENT = 2 * F;
  long long total = 0;
  int choice = SENT;
  for (int p = b + lane; p < e; p += 32) {
    const int a = arc[p];
    const int res = residual(fcap, flow, a, F);
    const long long rc = cost[p] + pv - price_in[head[p]];
    if (res > 0 && rc < 0) {
      total += res;
      choice = min(choice, a);
    }
  }
  total = warp_sum64(total);
  choice = warp_min32(choice);
  if (choice == SENT) {  // active with no admissible arc: relabel by eps
    if (lane == 0) price_out[v] = pv - eps;
    return;
  }
  if (lane == 0) price_out[v] = pv;
  const long long exc64 = exc;
  long long sum_prop = 0, out = 0;
  int c_res = 0, c_prop = 0, c_head = 0;
  bool have_c = false;
  for (int p = b + lane; p < e; p += 32) {
    const int a = arc[p];
    const int res = residual(fcap, flow, a, F);
    const int h = head[p];
    const long long rc = cost[p] + pv - price_in[h];
    if (!(res > 0 && rc < 0)) continue;
    const long long prop = min(static_cast<long long>(res), exc64 * res / total);
    sum_prop += prop;
    if (a == choice) {
      have_c = true;
      c_res = res;
      c_prop = static_cast<int>(prop);
      c_head = h;
    } else if (prop > 0) {
      push(flow, excess_out, a, h, static_cast<int>(prop), F);
      out += prop;
    }
  }
  sum_prop = warp_sum64(sum_prop);
  out = warp_sum64(out);
  const int owner = __ffs(__ballot_sync(FULL, have_c)) - 1;
  c_res = __shfl_sync(FULL, c_res, owner);
  c_prop = __shfl_sync(FULL, c_prop, owner);
  c_head = __shfl_sync(FULL, c_head, owner);
  if (lane == 0) {
    const long long extra = min(static_cast<long long>(c_res - c_prop), exc64 - sum_prop);
    const int x = static_cast<int>(c_prop + extra);
    if (x != 0) push(flow, excess_out, choice, c_head, x, F);
    out += x;
    atomicAdd(&excess_out[v], -static_cast<int>(out));
  }
}

}  // namespace

extern "C" int cs_sweep_launch(const int* seg, const int* arc, const int* head,
                               const long long* cost, const int* fcap, int* flow,
                               const int* excess_in, const long long* price_in, int* excess_out,
                               long long* price_out, long long eps, int NN, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(excess_out, excess_in, static_cast<size_t>(NN) * sizeof(int),
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (NN + WARPS - 1) / WARPS;
  cs_sweep_kernel<<<blocks, THREADS, 0, s>>>(seg, arc, head, cost, fcap, flow, excess_in, price_in,
                                             eps, excess_out, price_out, NN, F);
  return static_cast<int>(cudaGetLastError());
}
