// K13 seat_sort: the seat-layout sorts of the auction loop. A
// lexicographic sort of 1-4 int32 keys over n positions, the first key
// most significant, returning the sorted keys (`jax.lax.sort(keys,
// num_keys=len(keys))`); and the bid window's compaction: the positions
// of the waiting tasks in ascending order, then the fill value n, cut at B
// (`jax.lax.sort(where(waiting, pos, n))[:B]`).
//
// Replaces: poseidon_tpu/ops/dense_auction.py:629 (`to_sorted`, 3 keys),
// :770-772 (`auction_round`, 4 keys), :872 (`release`, 3 keys) and :710
// (the compaction, 1 key). XLA ran them as library sorts on the TPU.
//
// Bound: bytes, and far below any launch: n * 4 bytes a key in and out
// (320 KiB for the 4-key sort at the flagship's n = 10,240: 0.1 us at
// 3.35 TB/s). What costs is the sort's dependent passes, so the design
// keeps them in shared memory, in one launch, where the keys fit.
//
// Design. The wrapper (kernels/seat_sort.py) gives every key a domain
// [lo, lo + 2^bits): the segment in [0, Mp + 3), the negated level the
// whole int32 range, is_bid one bit, the task id [0, n). A key's field is
// (key - lo) in its bits, and the fields, first key highest, make one
// packed key of W bits: one 64-bit word, or two where W > 64 (never cut).
// The last key of every call is a task id, a permutation, so packed keys
// are distinct and the sorted keys are the same whatever the order of
// equal keys; the passes are stable all the same.
//
// The sort is a least-significant-digit radix sort of the packed keys, 8
// bits a pass (ceil(W / 8) passes: 8 at the flagship's 58 bits). A pass
// ranks every key stably among the keys of its digit: each warp walks its
// own run of keys 32 at a time, a lane's rank among the lanes that share
// its digit is the popcount of the lower ones, and a per-warp, per-digit
// counter in shared memory carries the run; an exclusive scan over
// (digit, warp) turns the counts into offsets. The lanes that share a
// digit come from eight ballots, one a digit bit (a fixed cost, where
// `__match_any_sync` iterates over the distinct digits of a round). A
// pass whose keys all share one digit is skipped.
//
// * cluster: where each block's share of the packed keys fits twice in
//   its shared memory (n <= 106,912 for one word, 53,456 for two; the
//   flagship's 10,240 does), one launch of an 8-block thread-block
//   cluster: block r holds keys [r * chunk, (r + 1) * chunk), counts them,
//   reads the other blocks' digit totals through distributed shared
//   memory, and scatters each key into the block that owns its new
//   position; two cluster barriers a pass. The ranking is bound by the
//   SM's instruction issue, so eight SMs beat one block at the flagship's
//   10,240 keys (`chip_smoke.py` [kernels] prints the one-block launch
//   beside the cluster's).
// * tiles: above that (config 8's 524,288 tasks), the packed keys live in
//   a device buffer pair, and each pass is three launches over tiles of
//   4,096 keys: a digit count a tile, one block's exclusive scan over
//   (digit, tile), and the stable scatter of each tile at its offsets.
//
// The compaction is a prefix count of the waiting flags (8 flags a
// thread, a block-wide scan a chunk of 8,192), written where the count is
// below B, then the fill n from the total to B: one block where n <=
// 65,536, else a count launch over the blocks and the write launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int RADIX = 256;
constexpr int MAX_KEYS = 4;
constexpr int MAX_PASSES = 16;
constexpr int CLUSTER_MAX = 8;  // blocks of the shared-memory sort (portable cluster size)
constexpr int BLOCK_THREADS = 512;
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int TILE_THREADS = 256;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_ROUNDS = 16;
constexpr int TILE = TILE_THREADS * TILE_ROUNDS;
constexpr int SCAN_THREADS = 1024;
constexpr int PACK_THREADS = 256;
constexpr int COMPACT_THREADS = 1024;
constexpr int COMPACT_ITEMS = 8;
constexpr int COMPACT_CHUNK = COMPACT_THREADS * COMPACT_ITEMS;
// ints of a cluster block's shared memory before its key buffers: the
// per-warp counters, the block's digit totals (read by the other blocks)
// and the digits' bases, the scan's warp sums, the skipped-pass flags
// (kernels/seat_sort.py BLOCK_FIXED_BYTES names the same size)
constexpr int BLOCK_FIXED_INTS = BLOCK_WARPS * RADIX + 2 * RADIX + 32 + MAX_PASSES;
static_assert(BLOCK_THREADS >= RADIX, "a thread a digit");

struct Fields {
  int nkeys;
  int lo[MAX_KEYS];
  int bits[MAX_KEYS];
  int pos[MAX_KEYS];  // the field's lowest bit in the packed key
  int passes;
};

struct Keys {
  const int* in[MAX_KEYS];
  int* out[MAX_KEYS];
};

struct Packed {
  u64 lo;
  u64 hi;  // bits 64..127; zero for one-word keys
};

__device__ __forceinline__ unsigned field_mask(int bits) {
  return bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
}

template <int WORDS>
__device__ __forceinline__ Packed pack(const Keys& k, const Fields& f, int e) {
  Packed p{0ull, 0ull};
#pragma unroll
  for (int i = 0; i < MAX_KEYS; ++i) {
    if (i >= f.nkeys) break;
    const u64 v = (static_cast<unsigned>(k.in[i][e]) - static_cast<unsigned>(f.lo[i])) &
                  field_mask(f.bits[i]);
    const int pos = f.pos[i];
    if (pos < 64) {
      p.lo |= v << pos;
      if (WORDS == 2 && pos > 32) p.hi |= v >> (64 - pos);
    } else {
      p.hi |= v << (pos - 64);
    }
  }
  return p;
}

template <int WORDS>
__device__ __forceinline__ int field(const Packed& p, const Fields& f, int i) {
  const int pos = f.pos[i];
  u64 v;
  if (pos < 64) {
    v = p.lo >> pos;
    if (WORDS == 2 && pos > 32) v |= p.hi << (64 - pos);
  } else {
    v = p.hi >> (pos - 64);
  }
  return static_cast<int>((static_cast<unsigned>(v) & field_mask(f.bits[i])) +
                          static_cast<unsigned>(f.lo[i]));
}

template <int WORDS>
__device__ __forceinline__ int digit(const Packed& p, int pass) {
  const int pos = 8 * pass;
  const u64 w = (WORDS == 1 || pos < 64) ? p.lo >> (pos & 63) : p.hi >> (pos - 64);
  return static_cast<int>(w & 0xff);
}

// A pair of key buffers (side 0 and 1) of n packed keys each, in shared or
// device memory: word j of side s at base[(s * WORDS + j) * n].
template <int WORDS>
struct Buf {
  u64* base;
  int n;
  __device__ __forceinline__ Packed load(int side, int e) const {
    Packed p;
    p.lo = base[static_cast<size_t>(side * WORDS) * n + e];
    p.hi = WORDS == 2 ? base[static_cast<size_t>(side * WORDS + 1) * n + e] : 0ull;
    return p;
  }
  __device__ __forceinline__ void store(int side, int e, const Packed& p) const {
    base[static_cast<size_t>(side * WORDS) * n + e] = p.lo;
    if (WORDS == 2) base[static_cast<size_t>(side * WORDS + 1) * n + e] = p.hi;
  }
};

// Exclusive scan of one int a thread over a block of NT threads; `total`
// gets the sum. Every thread of the block must call it.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums, int& total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NW ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NW) sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? sums[warp - 1] : 0;
  total = sums[NW - 1];
  __syncthreads();  // the sums are free for the next call
  return before + x - v;
}

// The lanes of `act` whose digit equals this lane's: one ballot a digit
// bit (a fixed cost, where __match_any_sync iterates over the distinct
// values). Every lane of `act` must call it.
__device__ __forceinline__ unsigned match_digit(unsigned act, int d) {
  unsigned peers = act;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned on = __ballot_sync(act, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? on : ~on;
  }
  return peers;
}

// Keys [first, first + here) of side `side`, dealt to warps in runs of
// rounds * 32 (warp w's round r holds keys w * rounds * 32 + r * 32 + lane):
// count each warp's keys by the digit of `pass` into cnt[warp][digit].
template <int WORDS>
__device__ __forceinline__ void count_digits(const Buf<WORDS>& b, int side, int first, int here,
                                             int rounds, int pass, int* cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < rounds; ++r) {
    const int i = (warp * rounds + r) * 32 + lane;
    const bool in = i < here;
    const unsigned act = __ballot_sync(0xffffffffu, in);
    if (in) {
      const int d = digit<WORDS>(b.load(side, first + i), pass);
      const unsigned peers = match_digit(act, d);
      if (lane == __ffs(peers) - 1) cnt[warp * RADIX + d] += __popc(peers);
    }
    __syncwarp();
  }
}

// The same walk; cnt[warp][digit] holds each warp's first offset of each
// digit. Every key goes to its offset plus its rank among the keys of its
// digit that its warp met before it, through `put(rank, key)`.
template <int WORDS, class Put>
__device__ __forceinline__ void scatter_digits(const Buf<WORDS>& b, int side, int first, int here,
                                               int rounds, int pass, volatile int* cnt, Put put) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < rounds; ++r) {
    const int i = (warp * rounds + r) * 32 + lane;
    const bool in = i < here;
    const unsigned act = __ballot_sync(0xffffffffu, in);
    if (in) {
      const Packed p = b.load(side, first + i);
      const int d = digit<WORDS>(p, pass);
      const unsigned peers = match_digit(act, d);
      volatile int* slot = cnt + warp * RADIX + d;
      const int base = *slot;
      const int rank = base + __popc(peers & ((1u << lane) - 1u));
      __syncwarp(act);
      if (lane == __ffs(peers) - 1) *slot = base + __popc(peers);
      put(rank, p);
    }
    __syncwarp();
  }
}

// The shared-memory sort over a cluster of `cl` blocks (1 to CLUSTER_MAX;
// a cluster of one is a single block). Block r holds keys [r * chunk, (r +
// 1) * chunk) in its shared memory, chunk = ceil(n / cl). A pass: each
// block counts its keys by digit, a cluster barrier, each block reads every
// block's digit totals through distributed shared memory and takes its
// offsets (the keys of lower digits, then of its digit in lower blocks),
// scatters each key into the block that owns its new position, a cluster
// barrier.
template <int WORDS>
__global__ void __launch_bounds__(BLOCK_THREADS, 1) seat_sort_cluster_kernel(Keys k, int n,
                                                                             Fields f) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int blocks = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  int* cnt = reinterpret_cast<int*>(smem);
  int* tot = cnt + BLOCK_WARPS * RADIX;
  int* base = tot + RADIX;
  int* sums = base + RADIX;
  int* skipped = sums + 32;
  const int chunk = (n + blocks - 1) / blocks;
  const int first = me * chunk;
  const int here = max(0, min(chunk, n - first));
  u64* keys = reinterpret_cast<u64*>(cnt + BLOCK_FIXED_INTS);
  const Buf<WORDS> b{keys, chunk};
  const int tid = threadIdx.x;
  if (tid < MAX_PASSES) skipped[tid] = 0;
  for (int e = tid; e < here; e += BLOCK_THREADS) b.store(0, e, pack<WORDS>(k, f, first + e));
  __syncthreads();
  const int rounds = (here + BLOCK_THREADS - 1) / BLOCK_THREADS;
  int side = 0;
  for (int pass = 0; pass < f.passes; ++pass) {
    for (int i = tid; i < BLOCK_WARPS * RADIX; i += BLOCK_THREADS) cnt[i] = 0;
    __syncthreads();
    count_digits<WORDS>(b, side, 0, here, rounds, pass, cnt);
    __syncthreads();
    if (tid < RADIX) {
      int t = 0;
      for (int w = 0; w < BLOCK_WARPS; ++w) t += cnt[w * RADIX + tid];
      tot[tid] = t;
    }
    cl.sync();  // every block's totals are in place
    int all = 0;
    int lower = 0;
    if (tid < RADIX) {
#pragma unroll
      for (int r = 0; r < CLUSTER_MAX; ++r) {  // unrolled: the remote loads overlap
        const int t = r < blocks ? *cl.map_shared_rank(tot + tid, r) : 0;
        all += t;
        lower += r < me ? t : 0;
      }
      if (all == n) skipped[pass] = 1;  // the same in every block
    }
    int total;
    const int excl = block_exclusive_scan<BLOCK_THREADS>(all, sums, total);
    if (skipped[pass]) {  // every key has one digit: the pass keeps the order
      cl.sync();          // no block reads this block's totals any more
      continue;
    }
    if (tid < RADIX) {
      int run = excl + lower;
      for (int w = 0; w < BLOCK_WARPS; ++w) {
        const int c = cnt[w * RADIX + tid];
        cnt[w * RADIX + tid] = run;
        run += c;
      }
    }
    __syncthreads();
    scatter_digits<WORDS>(b, side, 0, here, rounds, pass, cnt, [&](int rank, const Packed& p) {
      const int owner = rank / chunk;
      const Buf<WORDS> dst{cl.map_shared_rank(keys, owner), chunk};
      dst.store(side ^ 1, rank - owner * chunk, p);
    });
    cl.sync();  // every key has landed; every totals read is done
    side ^= 1;
  }
  for (int e = tid; e < here; e += BLOCK_THREADS) {
    const Packed p = b.load(side, e);
#pragma unroll
    for (int i = 0; i < MAX_KEYS; ++i)
      if (i < f.nkeys) k.out[i][first + e] = field<WORDS>(p, f, i);
  }
}

template <int WORDS>
__global__ void __launch_bounds__(PACK_THREADS) seat_pack_kernel(Keys k, int n, Fields f,
                                                                 u64* buf) {
  const Buf<WORDS> b{buf, n};
  for (int e = blockIdx.x * PACK_THREADS + threadIdx.x; e < n; e += gridDim.x * PACK_THREADS)
    b.store(0, e, pack<WORDS>(k, f, e));
}

template <int WORDS>
__global__ void __launch_bounds__(PACK_THREADS) seat_unpack_kernel(Keys k, int n, Fields f,
                                                                   u64* buf, int side) {
  const Buf<WORDS> b{buf, n};
  for (int e = blockIdx.x * PACK_THREADS + threadIdx.x; e < n; e += gridDim.x * PACK_THREADS) {
    const Packed p = b.load(side, e);
#pragma unroll
    for (int i = 0; i < MAX_KEYS; ++i)
      if (i < f.nkeys) k.out[i][e] = field<WORDS>(p, f, i);
  }
}

template <int WORDS>
__global__ void __launch_bounds__(TILE_THREADS) seat_hist_kernel(u64* buf, int n, int side,
                                                                 int pass, int tiles,
                                                                 int* __restrict__ tile_hist) {
  __shared__ int h[RADIX];
  static_assert(TILE_THREADS == RADIX, "one thread a digit");
  h[threadIdx.x] = 0;
  __syncthreads();
  const Buf<WORDS> b{buf, n};
  const int first = blockIdx.x * TILE;
  const int here = min(TILE, n - first);
  for (int i = threadIdx.x; i < here; i += TILE_THREADS)
    atomicAdd(&h[digit<WORDS>(b.load(side, first + i), pass)], 1);
  __syncthreads();
  tile_hist[threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

// In-place exclusive scan of a[len] (len = RADIX * tiles, digit-major:
// a tile's offset of a digit follows every lower digit and every earlier
// tile's keys of the same digit). One block walks the array in chunks of
// SCAN_THREADS * 8 counts, each thread two 16-byte vectors of eight
// consecutive counts, a block-wide scan a chunk, the running total carried
// to the next; len is a multiple of 8 (RADIX is).
__global__ void __launch_bounds__(SCAN_THREADS) seat_scan_kernel(int* __restrict__ a, int len) {
  __shared__ int sums[32];
  constexpr int ITEMS = 8;
  int carry = 0;
  for (int chunk = 0; chunk < len; chunk += SCAN_THREADS * ITEMS) {
    const int e = chunk + threadIdx.x * ITEMS;
    int4 lo = make_int4(0, 0, 0, 0);
    int4 hi = lo;
    if (e < len) {
      lo = *reinterpret_cast<const int4*>(a + e);
      hi = *reinterpret_cast<const int4*>(a + e + 4);
    }
    const int v[ITEMS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int local = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) local += v[j];
    int total;
    int run = carry + block_exclusive_scan<SCAN_THREADS>(local, sums, total);
    int out[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      out[j] = run;
      run += v[j];
    }
    if (e < len) {
      *reinterpret_cast<int4*>(a + e) = make_int4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<int4*>(a + e + 4) = make_int4(out[4], out[5], out[6], out[7]);
    }
    carry += total;
  }
}

template <int WORDS>
__global__ void __launch_bounds__(TILE_THREADS) seat_scatter_kernel(
    u64* buf, int n, int side, int pass, int tiles, const int* __restrict__ tile_off) {
  __shared__ int cnt[TILE_WARPS * RADIX];
  for (int i = threadIdx.x; i < TILE_WARPS * RADIX; i += TILE_THREADS) cnt[i] = 0;
  __syncthreads();
  const Buf<WORDS> b{buf, n};
  const int first = blockIdx.x * TILE;
  const int here = min(TILE, n - first);
  count_digits<WORDS>(b, side, first, here, TILE_ROUNDS, pass, cnt);
  __syncthreads();
  {
    const int d = threadIdx.x;
    int run = tile_off[d * tiles + blockIdx.x];
    for (int w = 0; w < TILE_WARPS; ++w) {
      const int c = cnt[w * RADIX + d];
      cnt[w * RADIX + d] = run;
      run += c;
    }
  }
  __syncthreads();
  scatter_digits<WORDS>(b, side, first, here, TILE_ROUNDS, pass, cnt,
                        [&](int rank, const Packed& p) { b.store(side ^ 1, rank, p); });
}

template <int WORDS>
cudaError_t sort_keys(const Keys& k, int n, const Fields& f, int cluster, int smem, int tiles,
                      u64* buf, int* tile_hist, cudaStream_t st) {
  if (cluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(BLOCK_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, seat_sort_cluster_kernel<WORDS>, k, n, f);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  const int pack_grid = min((n + PACK_THREADS - 1) / PACK_THREADS, 1024);
  seat_pack_kernel<WORDS><<<pack_grid, PACK_THREADS, 0, st>>>(k, n, f, buf);
  cudaError_t e = cudaGetLastError();
  int side = 0;
  for (int pass = 0; pass < f.passes && e == cudaSuccess; ++pass) {
    seat_hist_kernel<WORDS><<<tiles, TILE_THREADS, 0, st>>>(buf, n, side, pass, tiles, tile_hist);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    seat_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(tile_hist, RADIX * tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    seat_scatter_kernel<WORDS><<<tiles, TILE_THREADS, 0, st>>>(buf, n, side, pass, tiles,
                                                               tile_hist);
    e = cudaGetLastError();
    side ^= 1;
  }
  if (e != cudaSuccess) return e;
  seat_unpack_kernel<WORDS><<<pack_grid, PACK_THREADS, 0, st>>>(k, n, f, buf, side);
  return cudaGetLastError();
}

// Eight waiting flags from e on (none at or past `last`): their count, and
// flag j in bit j of `bits`.
__device__ __forceinline__ int flags8(const unsigned char* __restrict__ waiting, int e, int last,
                                      unsigned& bits) {
  bits = 0;
  int n = 0;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    const bool on = e + j < last && waiting[e + j] != 0;
    bits |= static_cast<unsigned>(on) << j;
    n += on;
  }
  return n;
}

__global__ void __launch_bounds__(COMPACT_THREADS) seat_count_kernel(
    const unsigned char* __restrict__ waiting, int n, int per_block, int* __restrict__ counts) {
  __shared__ int sums[32];
  const int first = blockIdx.x * per_block;
  const int last = min(n, first + per_block);
  int local = 0;
  for (int e = first + threadIdx.x * COMPACT_ITEMS; e < last; e += COMPACT_CHUNK) {
    unsigned bits;
    local += flags8(waiting, e, last, bits);
  }
  int total;
  block_exclusive_scan<COMPACT_THREADS>(local, sums, total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(COMPACT_THREADS) seat_compact_kernel(
    const unsigned char* __restrict__ waiting, int n, int B, int per_block,
    const int* __restrict__ counts, int blocks, int* __restrict__ out) {
  __shared__ int sums[32];
  __shared__ int block_base;
  const int tid = threadIdx.x;
  int base = 0;
  int total = 0;
  if (blocks > 1) {  // blocks <= COMPACT_THREADS (the plan's cap)
    int all;
    const int mine = tid < blocks ? counts[tid] : 0;
    const int excl = block_exclusive_scan<COMPACT_THREADS>(mine, sums, all);
    if (tid == static_cast<int>(blockIdx.x)) block_base = excl;
    __syncthreads();
    base = block_base;
    total = all;
  }
  const int first = blockIdx.x * per_block;
  const int last = min(n, first + per_block);
  for (int chunk = first; chunk < last; chunk += COMPACT_CHUNK) {
    const int e = chunk + tid * COMPACT_ITEMS;
    unsigned bits;
    const int here = flags8(waiting, e, last, bits);
    int chunk_total;
    int at = base + block_exclusive_scan<COMPACT_THREADS>(here, sums, chunk_total);
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      if ((bits >> j) & 1u) {
        if (at < B) out[at] = e + j;
        ++at;
      }
    }
    base += chunk_total;
  }
  if (blocks == 1) total = base;
  if (blockIdx.x == 0)
    for (int i = total + tid; i < B; i += COMPACT_THREADS) out[i] = n;
}

}  // namespace

// Lift the one-block sort's dynamic shared-memory cap to the card's
// per-block maximum and report that maximum (the plan sizes the block
// method by it). Called once per device.
extern "C" int seat_sort_setup(int* optin) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(seat_sort_cluster_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(seat_sort_cluster_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  return static_cast<int>(e);
}

// Sort n positions by nkeys int32 keys (k0 most significant), key i in
// [lo_i, lo_i + 2^bits_i), into o0..o3. `words` (1 or 2) 64-bit words a
// packed key; `block` the one-block method with `smem` bytes, else
// `tiles` tiles over buf (2 * words * n 64-bit words) and tile_hist
// (RADIX * tiles ints).
extern "C" int seat_sort_launch(const int* k0, const int* k1, const int* k2, const int* k3,
                                int* o0, int* o1, int* o2, int* o3, int n, int nkeys, int lo0,
                                int lo1, int lo2, int lo3, int b0, int b1, int b2, int b3,
                                int words, int cluster, int smem, int tiles, void* buf,
                                int* tile_hist, void* stream) {
  if (nkeys < 1 || nkeys > MAX_KEYS || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Keys k{{k0, k1, k2, k3}, {o0, o1, o2, o3}};
  Fields f{};
  f.nkeys = nkeys;
  const int lo[MAX_KEYS] = {lo0, lo1, lo2, lo3};
  const int bits[MAX_KEYS] = {b0, b1, b2, b3};
  int width = 0;
  for (int i = nkeys - 1; i >= 0; --i) {
    if (bits[i] < 0 || bits[i] > 32) return static_cast<int>(cudaErrorInvalidValue);
    f.lo[i] = lo[i];
    f.bits[i] = bits[i];
    f.pos[i] = width;
    width += bits[i];
  }
  if (width > 64 * words || words < 1 || words > 2) return static_cast<int>(cudaErrorInvalidValue);
  f.passes = (width + 7) / 8;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* b = static_cast<u64*>(buf);
  if (cluster < 0 || cluster > CLUSTER_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(words == 1
                              ? sort_keys<1>(k, n, f, cluster, smem, tiles, b, tile_hist, st)
                              : sort_keys<2>(k, n, f, cluster, smem, tiles, b, tile_hist, st));
}

// The bid window's compaction of waiting[n] into out[B]: `blocks` blocks
// of `per_block` flags (one block: no count pass; counts[blocks] ints).
extern "C" int seat_compact_launch(const unsigned char* waiting, int n, int B, int blocks,
                                   int per_block, int* counts, int* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || blocks > COMPACT_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 1) {
    seat_count_kernel<<<blocks, COMPACT_THREADS, 0, st>>>(waiting, n, per_block, counts);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  seat_compact_kernel<<<blocks, COMPACT_THREADS, 0, st>>>(waiting, n, B, per_block, counts, blocks,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}
