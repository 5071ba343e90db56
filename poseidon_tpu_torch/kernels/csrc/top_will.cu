// K12 top_will: the clearing level of the deflate step. For every machine
// column m of the table c[rows, Mp], the (k_m)-th largest of
//   will[t, m] = clamp(alt[t, m] - c[t, m], -INF, INF)   (-INF where !valid[t])
//   alt[t, m]  = m == m1[t] ? alt2[t] : alt1[t]
//   k_m        = clamp(s[m] - 1, 0, smax - 1) + 1
// i.e. `jax.lax.top_k(will.T, smax)[0]` gathered at clamp(s - 1, 0,
// smax - 1). Only the value is read, so ties need no order.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:826-833 (`deflate`: the will
// table, `jax.lax.top_k(will.T, smax)` and the gather; XLA ran the top-k
// as a library sort outside any fused kernel on the TPU).
//
// Bound: bytes. The table is read once (rows * Mp * 4 bytes: 40 MiB, 12.5
// us at 3.35 TB/s at the flagship's 10,240 x 1,024); the row vectors
// (13 bytes a row) and the [Mp] output are noise. The will table and its
// transpose are never written: each value lives in a register between its
// load and its fold.
//
// Design. Two methods, chosen by the host's plan (kernels/top_will.py
// `plan`) from smax:
//
// * list (smax <= LIST_MAX): one pass over the table, one launch. Each
//   thread keeps the K largest values it has seen in registers (K = smax
//   rounded up to a power of two, a template argument), sorted
//   descending. A block of LIST_WARPS warps covers LIST_COLS = 32
//   adjacent columns (a lane a column, so a warp's load of a row is 128
//   contiguous bytes) of one slab of rows, its warps taking the slab's
//   rows in turns, a warp LIST_UNROLL consecutive rows of a turn
//   (for K <= 16 32 warps and 16 rows: 64 KB of loads in flight an SM,
//   one block an SM; lane u loads row u's scalars, coalesced, and
//   shuffles hand them round). The lists are short (the card's threads
//   share the table: ~80 rows a list at the
//   flagship), so a list takes in about half of its values; one at a
//   time (an unrolled shift) a warp paid a whole insertion a row and the
//   pass was bound by instructions (41.3 us as called at the flagship on
//   an H100 before this design, 30.9 of it a pass at one column a thread
//   and 10.4 a second launch that merged the slabs' lists from device
//   memory). So for K >= 8 a turn's values go in by batches of K: sorted
//   by a bitonic network, then merged into the list by `merge_top`
//   (a[i] = max(a[i], b[K - 1 - i]) keeps the K largest of two
//   descending lists as a bitonic sequence, which log2(K) half-cleaners
//   sort): branch-free, and skipped where no lane of the warp has a value
//   above its list's last. A thread-block cluster of `slabs` blocks (at
//   most 8) covers all the rows of one column group; the plan takes the
//   most slabs (up to 4) whose clusters the card holds all at once
//   (`top_will_list_clusters`), so a launch is one wave. The lists meet
//   by `merge_top` too: a tree over the block's warps through shared
//   memory, then the cluster's first block reads the other blocks' lists
//   through distributed shared memory, one warp a block, and a tree over
//   those; its warp 0 writes the k_m-th entry of every column. No list
//   goes through device memory. Under a row-block mesh each shard's
//   launch writes its K-entry lists instead (lists[K, Mp]), and one more
//   launch (`merge`) folds the shards' lists of each column: the k-th
//   largest of the union is among each shard's own k largest. In the
//   stamps build (-DPHASE_STAMPS, common.cuh `Stamps`) the launch takes
//   a `stamps` buffer too, and thread 0 of block (0, 0) writes clock64()
//   at the fold's, the block tree's, the cluster read's and the write's
//   end.
//
// * radix (larger smax, up to the rows): selection by three digits of
//   the value (11, 11 and 10 bits), most significant first, on the
//   order-preserving unsigned key will ^ 0x80000000. Pass q (q = 0..2)
//   launches `hist`: a block of 1,024 threads covers HIST_COLS = 16
//   columns of a slab of rows (a half-warp a row: 64-byte segments, 64
//   rows at once), and counts digit q of every value whose digits above
//   q equal the column's prefix so far, in a shared-memory histogram of
//   2,048 bins x 16 columns (128 KiB, one block an SM; the plan's grid is
//   one wave), laid out digit-major so a half-warp's lanes hit distinct
//   banks. It adds the nonzero bins into hist[part, m, digit] with global
//   atomics. Then `pick` (a warp a column, bins / 32 bins a lane and a
//   suffix scan over the lanes) finds the digit where the count from the
//   top reaches the rank still wanted, takes the counts above it off the
//   rank, zeroes the bins for the next pass, and after the last digit
//   writes the value. Under a mesh each shard counts into its own part
//   and `pick` sums the parts. The table is read three times (a byte a
//   pass read it four times: 1,056 us a call at config 8 on an H100).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LIST_COLS = 32;
constexpr int LIST_CLUSTER_MAX = 8;   // a portable cluster
// the stamps build's slots (kernels/top_will.py LIST_STAMPS): start,
// folded, block tree, cluster read, written
constexpr int LIST_STAMPS = 8;
// warps of a list block (one block an SM) and rows a lane loads at once:
// a list of K registers and its loads in at most 64 registers a thread
template <int K>
__host__ __device__ constexpr int list_warps() {
  return K <= 16 ? 32 : 16;
}
template <int K>
__host__ __device__ constexpr int list_unroll() {
  return K <= 16 ? 16 : 32;
}
constexpr int MERGE_COLS = 32;
// warps of a merge block: its warps' lists fill 32 KiB of shared memory
template <int K>
__host__ __device__ constexpr int merge_warps() {
  return K <= 16 ? 16 : 8;
}
constexpr int HIST_COLS = 16;                 // a half-warp a row: 64-byte segments
constexpr int HIST_THREADS = 1024;            // one block an SM (its histogram: 128 KiB)
constexpr int HIST_ROWS = HIST_THREADS / HIST_COLS;  // rows of a block at once
constexpr int HIST_UNROLL = 8;
constexpr int BINS = 2048;                    // the widest digit's bins
constexpr int RADIX_PASSES = 3;               // digits of 11, 11 and 10 bits
constexpr int HIST_SMEM = BINS * HIST_COLS * 4;
// the digit of radix pass q: its width and the bits below it
__host__ __device__ constexpr int digit_bits(int pass) { return pass == RADIX_PASSES - 1 ? 10 : 11; }
__host__ __device__ constexpr int digit_shift(int pass) {
  return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}
static_assert(digit_bits(0) + digit_bits(1) + digit_bits(2) == 32, "the key's 32 bits");
static_assert(digit_shift(0) == digit_bits(1) + digit_shift(1) && digit_shift(1) == digit_bits(2),
              "digits laid end to end");
constexpr int PICK_THREADS = 256;
constexpr int LIST_EMPTY = -2147483647 - 1;  // below every will (>= -INF)

__device__ __forceinline__ int will_of(int c, int a1, int a2, int mm, unsigned char valid,
                                       int m) {
  const int alt = m == mm ? a2 : a1;
  // alt - c wraps as PyTorch's and XLA's int32 subtraction does
  const int d = static_cast<int>(static_cast<unsigned>(alt) - static_cast<unsigned>(c));
  const int w = min(max(d, -pt::INF), pt::INF);
  return valid ? w : -pt::INF;
}

// Insert w into a[0..K) (descending): a[i] becomes the i-th largest of the
// old list and w. Only values are kept, so equal values need no order.
template <int K>
__device__ __forceinline__ void list_push(int (&a)[K], int w) {
  if (w <= a[K - 1]) return;
#pragma unroll
  for (int i = K - 1; i > 0; --i) a[i] = w > a[i - 1] ? a[i - 1] : max(a[i], w);
  a[0] = max(a[0], w);
}

// a[0..K) becomes the K largest of a and b, descending (both descending
// on entry): the larger of a[i] and b[K - 1 - i] is the K largest of the
// two as one bitonic sequence, which log2(K) half-cleaners sort. Only
// values are kept, so equal values need no order.
template <int K>
__device__ __forceinline__ void merge_top(int (&a)[K], const int (&b)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = max(a[i], b[K - 1 - i]);
#pragma unroll
  for (int stride = K >> 1; stride > 0; stride >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if ((i & stride) == 0) {
        const int hi = max(a[i], a[i + stride]);
        a[i + stride] = min(a[i], a[i + stride]);
        a[i] = hi;
      }
    }
  }
}

// v[0..N) sorted descending by a bitonic network (N a power of two; every
// index is known at compile time, so v stays in registers).
template <int N>
__device__ __forceinline__ void sort_desc(int (&v)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const int hi = max(v[i], v[j]);
          const int lo = min(v[i], v[j]);
          const bool down = (i & size) == 0;
          v[i] = down ? hi : lo;
          v[j] = down ? lo : hi;
        }
      }
    }
  }
}

__device__ __forceinline__ int rank_of(const int* __restrict__ s, int smax, int m) {
  return min(max(s[m] - 1, 0), smax - 1);
}

// The lists of warps [0, lists) of the block meet in warp 0: halves of
// the warps hand theirs to the other half through `keep` (K * 32 ints a
// slot, lists / 2 slots) until one is left. Every thread of the block
// calls it.
template <int K>
__device__ __forceinline__ void tree_merge(int (&a)[K], int* keep, int lists) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int span = 1;
  while (span < lists) span <<= 1;
  for (int half = span >> 1; half >= 1; half >>= 1) {
    if (warp >= half && warp < lists) {
#pragma unroll
      for (int i = 0; i < K; ++i) keep[((warp - half) * K + i) * 32 + lane] = a[i];
    }
    __syncthreads();
    if (warp + half < lists) {
      int v[K];
#pragma unroll
      for (int i = 0; i < K; ++i) v[i] = keep[(warp * K + i) * 32 + lane];
      merge_top<K>(a, v);
    }
    __syncthreads();
    lists = half;
  }
}

// One launch of the list method over a shard: grid (column groups,
// slabs), a cluster of the `slabs` blocks of one column group. Writes
// out[m] (the k_m-th largest), or with `lists` the K-entry list of every
// column (lists[i * Mp + m]) for the mesh's merge.
template <int K>
__global__ void __launch_bounds__(list_warps<K>() * 32, 1) top_will_list_kernel(
    const int* __restrict__ c, const int* __restrict__ alt1, const int* __restrict__ alt2,
    const int* __restrict__ m1, const unsigned char* __restrict__ valid, int rows, int Mp,
    int rows_per_slab, const int* __restrict__ s, int smax, int* __restrict__ out,
    int* __restrict__ lists, pt::Stamps stamps) {
  constexpr int LIST_WARPS = list_warps<K>();
  constexpr int LIST_UNROLL = list_unroll<K>();
  constexpr int TURN = LIST_UNROLL * LIST_WARPS;  // rows of the block's turn
  __shared__ int keep[(LIST_WARPS / 2) * K * 32];
  __shared__ int pub[K * 32];
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * LIST_COLS + lane;
  const bool stamper = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  stamps(0, stamper);
  const int r0 = blockIdx.y * rows_per_slab;
  const int r1 = min(rows, r0 + rows_per_slab);
  int a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = LIST_EMPTY;
  // the slab in turns of TURN rows, warp w taking LIST_UNROLL consecutive
  // rows of a turn (their loads of c in flight at once); lane u loads row
  // u's scalars (coalesced) and the shuffles hand them round
  const bool col = m < Mp;
  const int turns = (r1 - r0) / TURN;
  for (int t = 0; t < turns; ++t) {
    const int base = r0 + t * TURN + warp * LIST_UNROLL;
    int w[LIST_UNROLL];
#pragma unroll
    for (int u = 0; u < LIST_UNROLL; ++u)
      w[u] = col ? __ldcs(c + static_cast<size_t>(base + u) * Mp + m) : 0;
    int s1 = 0;
    int s2 = 0;
    int sm = 0;
    int sv = 0;
    if (lane < LIST_UNROLL) {
      s1 = __ldg(alt1 + base + lane);
      s2 = __ldg(alt2 + base + lane);
      sm = __ldg(m1 + base + lane);
      sv = __ldg(valid + base + lane);
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < LIST_UNROLL; ++u) {
      const int a1 = __shfl_sync(0xffffffffu, s1, u);
      const int a2 = __shfl_sync(0xffffffffu, s2, u);
      const int mm = __shfl_sync(0xffffffffu, sm, u);
      const int v = __shfl_sync(0xffffffffu, sv, u);
      w[u] = col ? will_of(w[u], a1, a2, mm, static_cast<unsigned char>(v), m) : LIST_EMPTY;
      any |= w[u] > a[K - 1];
    }
    if (K >= 8) {
      // a turn's values in batches of K: sorted, then merged into the
      // list (branch-free; a lane's list takes in about half of its
      // values, so one by one a warp would pay a whole insertion a row)
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int b0 = 0; b0 < LIST_UNROLL; b0 += K) {
          int v[K];
#pragma unroll
          for (int i = 0; i < K; ++i) v[i] = w[b0 + i];
          sort_desc<K>(v);
          merge_top<K>(a, v);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < LIST_UNROLL; ++u) list_push<K>(a, w[u]);
    }
  }
  if (col) {
    for (int r = r0 + turns * TURN + warp; r < r1; r += LIST_WARPS)
      list_push<K>(a, will_of(__ldcs(c + static_cast<size_t>(r) * Mp + m), __ldg(alt1 + r),
                              __ldg(alt2 + r), __ldg(m1 + r), __ldg(valid + r), m));
  }
  if (pt::Stamps::on) {
    __syncthreads();
    stamps(1, stamper);
  }
  tree_merge<K>(a, keep, LIST_WARPS);
  stamps(2, stamper);
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) pub[i * 32 + lane] = a[i];
  }
  cl.sync();  // every block's list is in place
  const int blocks = static_cast<int>(cl.num_blocks());
  const bool root = cl.block_rank() == 0;
  if (root && warp >= 1 && warp < blocks) {
    const int* there = cl.map_shared_rank(pub, warp);
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = there[i * 32 + lane];
  }
  cl.sync();  // the first block has read every list: the others may leave
  stamps(3, stamper);
  if (!root) return;
  tree_merge<K>(a, keep, blocks);
  if (warp == 0 && m < Mp) {
    if (lists != nullptr) {
#pragma unroll
      for (int i = 0; i < K; ++i) lists[static_cast<size_t>(i) * Mp + m] = a[i];
    } else {
      const int k = rank_of(s, smax, m);
      int v = a[0];
#pragma unroll
      for (int i = 1; i < K; ++i) v = i == k ? a[i] : v;
      out[m] = v;
    }
  }
  if (pt::Stamps::on) {
    __syncthreads();
    stamps(4, stamper);
  }
}

// A block covers MERGE_COLS columns (a lane each, so a warp's loads of a
// list entry are 128 contiguous bytes); its W warps take every W-th list,
// load all K entries of one before folding any (K independent loads in
// flight), and keep their own K largest; warp 0 then folds the other
// warps' lists from shared memory.
template <int K>
__global__ void __launch_bounds__(merge_warps<K>() * 32) top_will_merge_kernel(
    const int* __restrict__ part, int lists, int Mp, const int* __restrict__ s, int smax,
    int* __restrict__ out) {
  constexpr int W = merge_warps<K>();
  __shared__ int keep[W][K][MERGE_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * MERGE_COLS + lane;
  int a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = LIST_EMPTY;
  if (m < Mp) {
    for (int l = warp; l < lists; l += W) {
      const int* p = part + static_cast<size_t>(l) * K * Mp + m;
      int v[K];
#pragma unroll
      for (int i = 0; i < K; ++i) v[i] = p[static_cast<size_t>(i) * Mp];
      merge_top<K>(a, v);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) keep[warp][i][lane] = a[i];
  __syncthreads();
  if (warp != 0 || m >= Mp) return;
  for (int w = 1; w < W; ++w) {
    int v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = keep[w][i][lane];
    merge_top<K>(a, v);
  }
  const int k = rank_of(s, smax, m);
  int v = a[0];
#pragma unroll
  for (int i = 1; i < K; ++i) v = i == k ? a[i] : v;
  out[m] = v;
}

__global__ void __launch_bounds__(HIST_THREADS, 1) top_will_hist_kernel(
    const int* __restrict__ c, const int* __restrict__ alt1, const int* __restrict__ alt2,
    const int* __restrict__ m1, const unsigned char* __restrict__ valid, int rows, int Mp,
    int rows_per_slab, int pass, const int* __restrict__ state, int* __restrict__ hist) {
  extern __shared__ int h[];  // BINS x HIST_COLS, digit-major
  const int bins = 1 << digit_bits(pass);
  for (int i = threadIdx.x; i < bins * HIST_COLS; i += HIST_THREADS) h[i] = 0;
  __syncthreads();
  const int col = threadIdx.x % HIST_COLS;
  const int m = blockIdx.x * HIST_COLS + col;
  const int r0 = blockIdx.y * rows_per_slab;
  const int r1 = min(rows, r0 + rows_per_slab);
  const int shift = digit_shift(pass);
  const unsigned dmask = static_cast<unsigned>(bins - 1);
  if (m < Mp) {
    const unsigned high = pass ? ~0u << (shift + digit_bits(pass)) : 0u;
    const unsigned want = pass ? static_cast<unsigned>(state[m]) & high : 0u;
    int r = r0 + static_cast<int>(threadIdx.x) / HIST_COLS;
    for (; r + (HIST_UNROLL - 1) * HIST_ROWS < r1; r += HIST_UNROLL * HIST_ROWS) {
      int cv[HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u)
        cv[u] = __ldcs(c + static_cast<size_t>(r + u * HIST_ROWS) * Mp + m);
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u) {
        const int t = r + u * HIST_ROWS;
        const unsigned key = static_cast<unsigned>(will_of(
            cv[u], __ldg(alt1 + t), __ldg(alt2 + t), __ldg(m1 + t), __ldg(valid + t), m)) ^
                             0x80000000u;
        if ((key & high) == want) atomicAdd(&h[((key >> shift) & dmask) * HIST_COLS + col], 1);
      }
    }
    for (; r < r1; r += HIST_ROWS) {
      const unsigned key = static_cast<unsigned>(will_of(
          __ldcs(c + static_cast<size_t>(r) * Mp + m), __ldg(alt1 + r), __ldg(alt2 + r),
          __ldg(m1 + r), __ldg(valid + r), m)) ^
                           0x80000000u;
      if ((key & high) == want) atomicAdd(&h[((key >> shift) & dmask) * HIST_COLS + col], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins * HIST_COLS; i += HIST_THREADS) {
    const int v = h[i];
    const int mc = blockIdx.x * HIST_COLS + (i % HIST_COLS);
    if (v != 0 && mc < Mp) atomicAdd(&hist[static_cast<size_t>(mc) * BINS + i / HIST_COLS], v);
  }
}

// A warp a column: lane l owns the digit's bins [l * per, (l + 1) * per)
// (per = bins / 32; a column's bins lie together, hist[part, m, bin], so
// a lane reads and zeroes its own with 16-byte accesses), sums them over
// the parts, and a suffix scan over the lanes finds the lane whose bins
// hold the rank still wanted; that lane walks its bins from the top.
__global__ void __launch_bounds__(PICK_THREADS) top_will_pick_kernel(
    int* __restrict__ hist, int parts, int Mp, int pass, const int* __restrict__ s, int smax,
    int* __restrict__ state, int* __restrict__ out) {
  constexpr int MAX_PER_LANE = BINS / 32;
  const int per = (1 << digit_bits(pass)) / 32;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (PICK_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= Mp) return;  // the whole warp: m is the warp's
  const unsigned prefix = pass ? static_cast<unsigned>(state[m]) : 0u;
  const int k = pass ? state[Mp + m] : rank_of(s, smax, m) + 1;
  int cnt[MAX_PER_LANE];
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) cnt[j] = 0;
  for (int q = 0; q < parts; ++q) {
    int4* bins = reinterpret_cast<int4*>(hist + (static_cast<size_t>(q) * Mp + m) * BINS +
                                         lane * per);
#pragma unroll
    for (int j = 0; j < MAX_PER_LANE / 4; ++j) {
      if (4 * j < per) {
        const int4 v = bins[j];
        bins[j] = make_int4(0, 0, 0, 0);
        cnt[4 * j] += v.x;
        cnt[4 * j + 1] += v.y;
        cnt[4 * j + 2] += v.z;
        cnt[4 * j + 3] += v.w;
      }
    }
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) mine += cnt[j];
  int incl = mine;  // the counts in this lane's bins and every higher lane's
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += y;
  }
  const int above = incl - mine;
  const unsigned who = __ballot_sync(0xffffffffu, above < k && k <= incl);
  const int src = who ? __ffs(who) - 1 : 0;
  int digit = 0;
  int rest = k;
  if (lane == src && who) {
    int acc = above;
    bool found = false;
#pragma unroll
    for (int j = MAX_PER_LANE - 1; j >= 0; --j) {
      if (!found && j < per && acc + cnt[j] >= k) {
        digit = lane * per + j;
        rest = k - acc;
        found = true;
      }
      acc += found ? 0 : cnt[j];
    }
  }
  digit = __shfl_sync(0xffffffffu, digit, src);
  rest = __shfl_sync(0xffffffffu, rest, src);
  if (lane == 0) {
    const unsigned p = prefix | static_cast<unsigned>(digit) << digit_shift(pass);
    state[m] = static_cast<int>(p);
    state[Mp + m] = rest;
    if (pass == RADIX_PASSES - 1) out[m] = static_cast<int>(p ^ 0x80000000u);
  }
}

template <int K>
cudaLaunchConfig_t list_config(int Mp, int slabs, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Mp + LIST_COLS - 1) / LIST_COLS, slabs);
  cfg.blockDim = dim3(list_warps<K>() * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slabs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int K>
cudaError_t launch_list(const int* c, const int* alt1, const int* alt2, const int* m1,
                        const unsigned char* valid, int rows, int Mp, int slabs,
                        int rows_per_slab, const int* s, int smax, int* out, int* lists,
                        pt::Stamps stamps, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = list_config<K>(Mp, slabs, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, top_will_list_kernel<K>, c, alt1, alt2, m1, valid,
                                           rows, Mp, rows_per_slab, s, smax, out, lists, stamps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of one list launch the card holds at once.
template <int K>
cudaError_t list_clusters(int Mp, int slabs, int* clusters) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = list_config<K>(Mp, slabs, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, top_will_list_kernel<K>, &cfg);
}

template <int K>
cudaError_t launch_merge(const int* part, int lists, int Mp, const int* s, int smax, int* out,
                         cudaStream_t stream) {
  top_will_merge_kernel<K><<<(Mp + MERGE_COLS - 1) / MERGE_COLS, merge_warps<K>() * 32, 0,
                             stream>>>(part, lists, Mp, s, smax, out);
  return cudaGetLastError();
}

}  // namespace

// The list method over one shard, one launch: out[m] for every column,
// or (`lists` not null) the K largest of every column into lists[K, Mp]
// for the mesh's merge. `slabs` (1 to LIST_CLUSTER_MAX) blocks of
// `rows_per_slab` rows a column group, one cluster; K is 1, 2, 4, 8, 16
// or 32. The stamps build takes `stamps` too (LIST_STAMPS int64) for the
// phase stamps.
extern "C" int top_will_list_launch(const int* c, const int* alt1, const int* alt2, const int* m1,
                                    const unsigned char* valid, int rows, int Mp, int K,
                                    int slabs, int rows_per_slab, const int* s, int smax,
                                    int* out, int* lists,
#ifdef PHASE_STAMPS
                                    long long* stamp_buf,
#endif
                                    void* stream) {
#ifdef PHASE_STAMPS
  const pt::Stamps stamps{stamp_buf};
#else
  const pt::Stamps stamps{};
#endif
  if (slabs < 1 || slabs > LIST_CLUSTER_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto launch) {
    return static_cast<int>(launch(c, alt1, alt2, m1, valid, rows, Mp, slabs, rows_per_slab, s,
                                   smax, out, lists, stamps, st));
  };
  switch (K) {
    case 1: return go(launch_list<1>);
    case 2: return go(launch_list<2>);
    case 4: return go(launch_list<4>);
    case 8: return go(launch_list<8>);
    case 16: return go(launch_list<16>);
    case 32: return go(launch_list<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of a list launch over Mp columns in `slabs` slabs that the
// card holds at once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int top_will_list_clusters(int Mp, int K, int slabs, int* clusters) {
  switch (K) {
    case 1: return static_cast<int>(list_clusters<1>(Mp, slabs, clusters));
    case 2: return static_cast<int>(list_clusters<2>(Mp, slabs, clusters));
    case 4: return static_cast<int>(list_clusters<4>(Mp, slabs, clusters));
    case 8: return static_cast<int>(list_clusters<8>(Mp, slabs, clusters));
    case 16: return static_cast<int>(list_clusters<16>(Mp, slabs, clusters));
    case 32: return static_cast<int>(list_clusters<32>(Mp, slabs, clusters));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mesh's merge of the list method: out[m] = the k_m-th largest of
// the shards' `lists` lists part[l, :K, m].
extern "C" int top_will_merge_launch(const int* part, int lists, int Mp, int K, const int* s,
                                     int smax, int* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return static_cast<int>(launch_merge<1>(part, lists, Mp, s, smax, out, st));
    case 2: return static_cast<int>(launch_merge<2>(part, lists, Mp, s, smax, out, st));
    case 4: return static_cast<int>(launch_merge<4>(part, lists, Mp, s, smax, out, st));
    case 8: return static_cast<int>(launch_merge<8>(part, lists, Mp, s, smax, out, st));
    case 16: return static_cast<int>(launch_merge<16>(part, lists, Mp, s, smax, out, st));
    case 32: return static_cast<int>(launch_merge<32>(part, lists, Mp, s, smax, out, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The radix method's count of digit `pass` over one shard into
// hist[Mp, BINS] (zero before the pass: `pick` leaves it so).
extern "C" int top_will_hist_launch(const int* c, const int* alt1, const int* alt2, const int* m1,
                                    const unsigned char* valid, int rows, int Mp, int slabs,
                                    int rows_per_slab, int pass, const int* state, int* hist,
                                    void* stream) {
  if (pass < 0 || pass >= RADIX_PASSES) return static_cast<int>(cudaErrorInvalidValue);
  // the histogram's 128 KiB, above the default cap (on the current device)
  const cudaError_t lifted = cudaFuncSetAttribute(
      top_will_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HIST_SMEM);
  if (lifted != cudaSuccess) return static_cast<int>(lifted);
  const dim3 grid((Mp + HIST_COLS - 1) / HIST_COLS, slabs);
  top_will_hist_kernel<<<grid, HIST_THREADS, HIST_SMEM, static_cast<cudaStream_t>(stream)>>>(
      c, alt1, alt2, m1, valid, rows, Mp, rows_per_slab, pass, state, hist);
  return static_cast<int>(cudaGetLastError());
}

// The radix method's choice of digit `pass` from the parts' counts
// hist[parts, Mp, BINS]; state[2, Mp] carries (prefix, rank) between
// passes, and the last pass writes out[Mp].
extern "C" int top_will_pick_launch(int* hist, int parts, int Mp, int pass, const int* s,
                                    int smax, int* state, int* out, void* stream) {
  constexpr int cols = PICK_THREADS / 32;
  top_will_pick_kernel<<<(Mp + cols - 1) / cols, PICK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(hist, parts, Mp, pass, s, smax,
                                                              state, out);
  return static_cast<int>(cudaGetLastError());
}
