// K5 express_patch: the express lane's patch backlog, out of place, in
// one launch: retire table rows and apply seat deltas, chunk after chunk,
// from the source vectors into the destination vectors.
//
// Replaces: poseidon_tpu/ops/resident.py:320 `_express_patch` (one XLA
// scatter program per chunk on the TPU, each a pure function of its
// inputs), applied to every chunk of a backlog int32[n_chunks, 3, W]
// (rows, cols, deltas), in order. For each entry i of chunk k:
//   rows[k, i] in [0, Tp):  valid = 0, u = 0, w = INF, asg = Mp, lvl = 0
//   cols[k, i] in [0, Mp):  s[cols[k, i]] += deltas[k, i]
// and only after every add of the chunk, s = max(s, 0) over all of s.
// Entries of -1 (or past the axis) are dropped, as the reference's
// `mode="drop"` scatters drop them. Duplicate columns sum. The clamp sits
// between chunks: a -2 in one chunk and a +1 in the next give another s
// than one add of the whole backlog followed by one clamp. The other
// vectors take the source's values where no row retires. A destination
// may be its own source (patched in place): its copy is skipped.
//
// Bound: bytes, and far below one launch's fixed cost. At the flagship
// (Tp 10,240, Mp 1,024) with one 1,024-entry chunk, out of place: the
// five [Tp] vectors read and written (2 x 174 KiB), s read and written
// (8 KiB), the chunk's 12 KiB: ~0.11 us at 3.35 TB/s. The kernel is
// launch-bound.
//
// Design: one launch of ceil(Tp / TILE) tile blocks and one seat block;
// every output has one owning block, so no block waits on another. A
// tile block copies its TILE rows of the five [Tp] vectors from source to
// destination (one row a thread), meets a block barrier, then walks every
// entry of every chunk and writes the retires whose row falls in its
// tile (each thread's first entry read before the copy); a retire
// writes constants, so their order across chunks does not matter. The
// seat block stages s in shared memory (when the wrapper gives it the
// Mp * 4 bytes: Mp <= 12,288, within the 48 KiB that need no opt-in;
// else it works on the destination in global memory, its loads past L1
// with __ldcg, where the atomics do not go), then for each chunk in order
// adds the deltas with atomics, barrier, clamps, barrier; then writes s
// out.
#include "common.cuh"

namespace {

constexpr int PATCH_THREADS = 1024;
constexpr int TILE = 1024;  // rows of the [Tp] vectors a tile block owns

struct Vectors {
  int* u;
  int* w;
  unsigned char* valid;
  int* asg;
  int* lvl;
};

__global__ void __launch_bounds__(PATCH_THREADS, 1) express_patch_kernel(
    const int* __restrict__ backlog, int n_chunks, int W, Vectors src, Vectors dst,
    const int* s_src, int* s_dst, int Tp, int Mp, int stage) {
  extern __shared__ int s_stage[];
  const int tid = threadIdx.x;
  // a thread's first entry of the first chunk is read before the copy,
  // so the two trips to memory overlap
  const bool first = n_chunks > 0 && tid < W;
  if (blockIdx.x == gridDim.x - 1) {
    // the seat block
    const int col0 = first ? backlog[W + tid] : -1;
    const int delta0 = first ? backlog[2 * W + tid] : 0;
    int* s = stage ? s_stage : s_dst;
    if (stage || s_dst != s_src) {
      for (int m = tid; m < Mp; m += PATCH_THREADS) s[m] = s_src[m];
    }
    __syncthreads();
    for (int k = 0; k < n_chunks; ++k) {
      const int* cols = backlog + (3LL * k + 1) * W;
      const int* deltas = cols + W;
      for (int i = tid; i < W; i += PATCH_THREADS) {
        const bool pre = k == 0 && i == tid;
        const int col = pre ? col0 : cols[i];
        if (col >= 0 && col < Mp) atomicAdd(&s[col], pre ? delta0 : deltas[i]);
      }
      __syncthreads();
      for (int m = tid; m < Mp; m += PATCH_THREADS) {
        const int v = stage ? s[m] : __ldcg(&s[m]);
        if (v < 0) s[m] = 0;
      }
      __syncthreads();
    }
    if (stage) {
      for (int m = tid; m < Mp; m += PATCH_THREADS) s_dst[m] = s[m];
    }
    return;
  }
  // a tile block: rows [t0, t1)
  const int r0 = first ? backlog[tid] : -1;
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(t0 + TILE, Tp);
  for (int t = t0 + tid; t < t1; t += PATCH_THREADS) {
    if (dst.u != src.u) dst.u[t] = src.u[t];
    if (dst.w != src.w) dst.w[t] = src.w[t];
    if (dst.valid != src.valid) dst.valid[t] = src.valid[t];
    if (dst.asg != src.asg) dst.asg[t] = src.asg[t];
    if (dst.lvl != src.lvl) dst.lvl[t] = src.lvl[t];
  }
  __syncthreads();
  for (int k = 0; k < n_chunks; ++k) {
    const int* rows = backlog + 3LL * k * W;
    for (int i = tid; i < W; i += PATCH_THREADS) {
      const int r = k == 0 && i == tid ? r0 : rows[i];
      if (r >= t0 && r < t1) {
        dst.valid[r] = 0;
        dst.u[r] = 0;
        dst.w[r] = pt::INF;
        dst.asg[r] = Mp;
        dst.lvl[r] = 0;
      }
    }
  }
}

}  // namespace

extern "C" int express_patch_launch(const int* backlog, const int* u_src, const int* w_src,
                                    const unsigned char* valid_src, const int* s_src,
                                    const int* asg_src, const int* lvl_src, int* u_dst,
                                    int* w_dst, unsigned char* valid_dst, int* s_dst,
                                    int* asg_dst, int* lvl_dst, int n_chunks, int W, int Tp,
                                    int Mp, int smem, void* stream) {
  // the kernel only reads through src; a const_cast keeps one struct type
  const Vectors src{const_cast<int*>(u_src), const_cast<int*>(w_src),
                    const_cast<unsigned char*>(valid_src), const_cast<int*>(asg_src),
                    const_cast<int*>(lvl_src)};
  const Vectors dst{u_dst, w_dst, valid_dst, asg_dst, lvl_dst};
  const int tiles = (Tp + TILE - 1) / TILE;
  express_patch_kernel<<<tiles + 1, PATCH_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      backlog, n_chunks, W, src, dst, s_src, s_dst, Tp, Mp, smem > 0);
  return static_cast<int>(cudaGetLastError());
}
