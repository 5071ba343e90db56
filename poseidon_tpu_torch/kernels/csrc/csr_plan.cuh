// The residual-CSR launch plan of K9 cs_sweep and K10 bf_relax (sm_90a).
//
// The residual arcs are stably sorted by tail (ops/cost_scaling.py's
// residual_csr): node v's out-arcs are positions [seg[v], seg[v+1]). The
// degrees are skewed: at the flagship S and T hold 12,289 arcs each and
// the aggregators 11,002 and 4,086, while ~12,000 nodes hold about 6. A
// warp a node would make the longest segment's walk the launch's critical
// path. The plan splits the work by arcs instead. It is made once per CSR
// on the host (kernels/csr_plan.py, the same constants) as int4 items
// (node_lo, node_hi, pos_lo, pos_hi):
//
//   - items [0, n_heavy): one HEAVY node each (degree > CHUNK). Its
//     segment is dealt in CHUNK-position chunks over the CLUSTER blocks of
//     one thread-block cluster: block rank r takes chunks r, r + CLUSTER,
//     ... The blocks combine their partial results through distributed
//     shared memory; one block writes the node.
//   - items [n_heavy, n_heavy + n_light): LIGHT blocks, each a run of at
//     most MAX_NODES consecutive light nodes holding at most CHUNK
//     positions in all (one pass). Its threads take positions, not nodes;
//     a warp's 32 lanes hold 32 consecutive positions, so the lanes of one
//     node are a run, reduced by shuffles, and the run's last lane adds it
//     into the node's shared-memory slot.
//
// Grid: CLUSTER * (n_heavy + ceil(n_light / CLUSTER)) blocks in clusters
// of CLUSTER; heavy item c is cluster c, light item j is block
// CLUSTER * n_heavy + j, and the padding blocks of the last cluster
// return at once. Only heavy clusters meet at cluster barriers, and all
// their threads do.
//
// Every thread issues the loads of its ITEMS positions before the
// gathers that depend on them, so the chain of dependent loads is the
// plan item, the position's fields (arc, head, cost / length, tail), and
// the gathers at the head and the residual slot: three memory latencies,
// whatever the degree.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace csr {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                   // positions a thread per chunk
constexpr int CHUNK = THREADS * ITEMS;     // 2048 positions a block pass
constexpr int CLUSTER = 8;                 // blocks of a heavy node (portable)
constexpr int MAX_NODES = THREADS;         // nodes of a light block
constexpr unsigned FULL = 0xffffffffu;

struct Work {
  int lo, hi;       // nodes [lo, hi) (heavy: hi == lo + 1)
  int first, end;   // this block's first position; the item's end
  int stride;       // positions from one of this block's chunks to the next
  int rank;         // the block's rank in its cluster
  bool heavy;
  bool idle;        // a padding block of the last cluster
};

// This block's share of the plan.
__device__ __forceinline__ Work decode(const int4* __restrict__ plan, int n_heavy,
                                       int n_light) {
  Work w;
  const int c = static_cast<int>(blockIdx.x) / CLUSTER;
  w.rank = static_cast<int>(cg::this_cluster().block_rank());
  w.heavy = c < n_heavy;
  const int j = w.heavy ? c : n_heavy + (c - n_heavy) * CLUSTER + w.rank;
  w.idle = !w.heavy && j >= n_heavy + n_light;
  if (w.idle) return w;
  const int4 it = plan[j];
  w.lo = it.x;
  w.hi = it.y;
  w.first = w.heavy ? it.z + w.rank * CHUNK : it.z;
  w.end = it.w;
  w.stride = w.heavy ? CLUSTER * CHUNK : CHUNK;
  return w;
}

// The lanes of a warp whose (sorted) keys equal this lane's: first and
// last lane of the run.
struct Run {
  int first, last;
};

__device__ __forceinline__ Run run_of(int key) {
  const unsigned m = __match_any_sync(FULL, key);
  return Run{__ffs(m) - 1, 31 - __clz(m)};
}

// Inclusive scan inside runs: the run's last lane ends with the op over
// the whole run (keys ascend with the lane, so a run is contiguous).
template <typename T, typename Op>
__device__ __forceinline__ T run_total(T x, const Run& r, int lane, Op op) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(FULL, x, d);
    if (lane - d >= r.first) x = op(x, y);
  }
  return x;
}

template <typename T, typename Op>
__device__ __forceinline__ T warp_all(T x, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = op(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

struct Add {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// Cluster barrier halves (release on arrive, acquire on wait): shared
// memory written before a block's arrive is seen by every block of the
// cluster after its wait. Split, so an arrive can be issued early and its
// wait hidden behind the loads.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// `p` in the shared memory of the cluster's block `rank`.
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, static_cast<unsigned>(rank));
}

__device__ __forceinline__ void atomic_add64(long long* p, long long x) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(x));
}

// The launch's grid (0: nothing to do).
inline int grid_blocks(int n_heavy, int n_light) {
  return CLUSTER * (n_heavy + (n_light + CLUSTER - 1) / CLUSTER);
}

}  // namespace csr
