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
// 3.35 TB/s; 8 MiB, 2.5 us, for config 8's stable argsort of 524,288
// keys; 16 MiB, 5.0 us, for its 4-key sort). What costs is the sort's
// dependent steps, each a barrier or a launch, so the design keeps them
// in shared memory and few: one launch up to the split's limit, one a
// digit pass past it.
//
// Design. The wrapper (kernels/seat_sort.py) gives every key a domain
// [lo, lo + 2^bits): the segment in [0, Mp + 3), the negated level the
// whole int32 range, is_bid one bit, the task id [0, n). A key's field is
// (key - lo) in its bits, and the fields, first key highest, make one
// packed key of W bits: one 64-bit word, or two where W > 64 (never cut).
// The last key of every call is a task id, a permutation, so packed keys
// are distinct and the sorted keys are the same whatever the order of
// equal keys; every method below sorts any keys all the same (equal keys
// are interchangeable, and the output holds only keys).
//
// Two methods, by the host's plan (kernels/seat_sort.py `sort_plan`):
//
// * split (n <= SPLIT_MAX_N and a block's share fits its shared memory;
//   the flagship's 10,240 do): one launch of an 8-block cluster of 1,024
//   threads a block, most significant digit first; block r owns positions
//   [r * chunk, (r + 1) * chunk). The packed keys form one bucket. A level
//   splits every bucket of more than SMALL keys by its top digit: the
//   highest d bits that vary inside the bucket (an AND and an OR over its
//   keys find them), d = min(varying bits, DIGIT_MAX, log2(size) - 1), so
//   a level's bins number at most n / 2; the first bucket's digit is the
//   top d bits of the packed width. Each block counts its own keys of
//   each bin (shared-memory atomics, the lanes of a warp that share a bin
//   folded into one by `__match_any_sync`), a cluster barrier, each block
//   reads every block's counts through distributed shared memory (8 bytes
//   a load) and scans them into its own cursor of each bin, and scatters
//   its keys into the blocks that own their places, folding the AND and
//   OR of each bin the next level splits (`__reduce_and_sync` and
//   `__reduce_or_sync` over the lanes of a bin); a cluster barrier. No
//   stability is needed: the bits below the digit decide the order inside
//   a bin. Each non-empty bin starts a bucket (a bit in a head bitmap that
//   every block derives alike); a bin of more than SMALL keys is split at
//   the next level, unless its keys are all equal. At the flagship the
//   first digit is the segment: the machines' buckets hold a few holders
//   and bidders, WAIT, UNS and DUMP thousands of keys at level 0 whose
//   only varying bits are the task id's, split once more by those. A
//   level is two cluster barriers whatever its buckets, and levels end
//   once every bucket holds at most SMALL keys: each level after the
//   first takes at least one varying bit off every bucket it splits, so
//   any keys (all n in one bucket, 128-bit keys) end. Last, every key
//   finds its bucket's ends in the bitmap and takes its rank in the bucket
//   by counting the keys of the bucket below it (equal keys by position;
//   a neighbour block's keys where the bucket crosses into it, read only
//   after a cluster barrier: where no level ran, or the last level moved
//   only some keys and their owners copied them back, the rank step takes
//   one of its own), and is unpacked to its place in the outputs. One block alone (an earlier
//   form of the split on a cluster of one) took about twice the cluster's
//   time at the flagship: every step is issue-bound on one SM.
// * onesweep: above that (config 8's 524,288 tasks, the flagship's
//   residual CSR of 145,410 arcs), a least-significant-digit radix sort
//   of 8-bit digits (ceil(W / 8) passes) over the packed keys in a device
//   buffer pair (sides 0 and 1, each word a row of `stride` keys), one
//   launch a digit pass, each pass one chained scan with decoupled
//   look-back (Adinets and Merrill's Onesweep). In order on the stream:
//   - a cudaMemsetAsync zeroes the workspace's head: every pass's
//     histogram, the count of finished up-front blocks, the live mask and
//     each pass's tile counter (the workspace is the caller's scratch,
//     zeroed on every call, so a replayed graph starts clean);
//   - the up-front launch packs the int32 keys into side 0 and, in the
//     same read, counts every pass's digits into its block's shared
//     histograms (one add a warp where its 32 keys share the digit, as
//     in a cold layout, else one a key), added to device memory; it
//     zeroes the passes' look-back words, and its last block to finish
//     marks the live passes: those whose digit does not hold all n keys
//     in one bin (a level field of 0 for every key makes 3 of config 8's
//     8 passes dead; with none live, pass 0 runs);
//   - a launch a pass. A dead pass returns from every block at once. In
//     a live one the side it reads is the parity of the live passes
//     before it (side 0 the packed keys), each block takes its tile of
//     TILE keys from the pass's atomic counter (so it waits only on tiles
//     that blocks already running took), loads it into shared memory by
//     16-byte vectors (every thread's loads in flight at once; the keys
//     sit in L2, and the rank that follows needs every thread anyway),
//     and ranks each key among the tile's keys of its digit, stably: warp
//     w takes keys [w * R * 32, (w + 1) * R * 32) in R rounds of 32, a
//     key's rank is the warp's count of its digit so far (eight ballots
//     find the lanes that share it) plus the warps before it. The
//     block publishes its tile's count of each digit ("aggregate"),
//     writes its keys back into shared memory in digit order, then
//     looks back over the earlier tiles' words, eight at a time, adding
//     aggregates until it meets an inclusive prefix, and publishes its
//     own ("prefix"); release stores and relaxed loads closed by a fence
//     (an acquire) order the words, which carry their count, flag and
//     pass. Each digit's place is the pass's
//     global offset (an exclusive scan of the up-front histogram, made
//     by every block in shared memory) plus that prefix, so the block
//     stores each digit's run of the tile to consecutive places. The last
//     live pass stores the int32 fields instead (the unpack fused).
//   The host enqueues a memset, the up-front launch and one launch a
//   pass, and reads nothing. TILE is SWEEP_THREADS (512) x R keys, R 4
//   or 8 by the plan (kernels/seat_sort.py `sort_plan`): 4,096 keys where
//   that still gives the pass SWEEP_MIN_TILES (64) tiles, else 2,048 (on
//   an H100 at 700 W, 4,096 was fastest at config 8's 524,288 keys and
//   2,048 at the CSR's 145,410; 1,024 slower at both).
//
// The stamps build (-DPHASE_STAMPS, common.cuh `Stamps`) adds a `stamps`
// buffer to `seat_sort_launch`: thread 0 of block 0 of the split writes
// clock64() at its phase ends (the STAMP_* slots), its breakdown by phase
// on one SM.
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
constexpr int MAX_PASSES = 16;      // 8-bit digits of a 128-bit key
// the onesweep method (kernels/seat_sort.py names the same sizes)
constexpr int SWEEP_THREADS = 512;  // a pass's block; its tile is SWEEP_THREADS x rounds keys
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
// a pass block's ints after its tile: the warps' digit counts, the
// digits' offsets and tile starts, the warp sums and the scalars
constexpr int SWEEP_FIXED_INTS = 4656;
constexpr int STRIDE_KEYS = 32;     // a buffer row's keys, a multiple of 32 (16-byte vectors)
constexpr int HIST_THREADS = 512;   // the up-front block
constexpr int HIST_ITEMS = 8;       // keys a thread of the up-front block, loads in flight together
constexpr int WORK_HEAD = 32;       // ints after the histograms: done count, live mask, tile counters
constexpr int LOOK = 8;             // look-back words a thread loads at once
// a look-back word: the count in bits 0-25, the pass in bits 26-29, the
// flag in bits 30-31 (0 not yet written, 1 aggregate, 2 inclusive prefix)
constexpr int STATUS_COUNT_BITS = 26;
constexpr unsigned FLAG_AGGREGATE = 1u;
constexpr unsigned FLAG_PREFIX = 2u;
static_assert(SWEEP_FIXED_INTS == SWEEP_WARPS * RADIX + 2 * RADIX + 48, "the pass block's ints");
static_assert(WORK_HEAD >= 2 + MAX_PASSES, "done, live and a counter a pass");
static_assert(MAX_PASSES <= 16, "the pass in four bits of a look-back word");
constexpr int COMPACT_THREADS = 1024;
constexpr int COMPACT_ITEMS = 8;
constexpr int COMPACT_CHUNK = COMPACT_THREADS * COMPACT_ITEMS;
// the split method (kernels/seat_sort.py names the same sizes)
constexpr int SPLIT_THREADS = 1024;
constexpr int SPLIT_CLUSTER = 8;    // blocks of the split's cluster (portable)
constexpr int SPLIT_MAX_N = 32768;  // keys of a split: a bin's count in 16 bits
constexpr int SMALL = 32;           // a bucket the last step ranks as it is
constexpr int DIGIT_MAX = 11;       // bits of a level's digit
constexpr int SPLIT_FIXED_INTS = 48;  // the scan's warp sums and the level's scalars
// the methods of seat_sort_launch
constexpr int METHOD_ONESWEEP = 0;
constexpr int METHOD_SPLIT = 1;
// the stamps build's slots (kernels/seat_sort.py names the same): clock64()
// at the ends of the split's phases, thread 0 of block 0
constexpr int STAMPS = 32;
constexpr int STAMP_START = 0;
constexpr int STAMP_PACKED = 1;
constexpr int STAMP_LEVEL = 2;       // the end of level l at 2 + l (l < STAMP_LEVEL_MAX)
constexpr int STAMP_LEVEL_MAX = 8;
// the steps of level 0 at STAMP_STEP0 + i and of level 1 at STAMP_STEP1 +
// i: 0 the digits, 1 counted (after its barrier), 2 the counts read, 3
// scanned, 4 the cursors and heads, 5 scattered (after its barrier)
constexpr int STAMP_STEP0 = 18;
constexpr int STAMP_STEP1 = 10;
constexpr int STAMP_LEVELS = 24;     // the number of levels
constexpr int STAMP_LISTED = 25;     // keys split at level l at 25 + l (l < STAMP_LISTED_MAX)
constexpr int STAMP_LISTED_MAX = 6;
constexpr int STAMP_END = 31;
static_assert(STAMP_END < STAMPS, "a stamp a slot");
static_assert(SPLIT_FIXED_INTS == 32 + 16, "the warp sums and the scalars");
static_assert(SPLIT_CLUSTER <= 8, "a portable cluster");

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
    } else if (WORDS == 2) {
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

// ---- the split method -------------------------------------------------

// A split block's shared memory for n keys over a cluster of `blocks`
// blocks, chunk = ceil(n / blocks) keys a block (kernels/seat_sort.py
// `split_smem` sums the same sizes): the block's key buffer pair, its
// partial AND and OR of each listed bucket, then ints: its count, its
// cursor and the next level's slot of each bin, the head bitmap, the
// level's buckets
// (start, size, keys before it, this block's keys before it, its bins'
// base, the digit's shift and width) and the next level's (start,
// size), the warp sums and the level's scalars. The bitmap and the lists
// are the same in every block: each block derives them from the same
// cluster-wide counts.
struct SplitSmem {
  u64* keys;      // 2 * WORDS * chunk: side s, word j of local key e at (s * WORDS + j) * chunk + e
  u64* part;      // 2 * WORDS * lmax: bucket j's AND at (2 j) * WORDS, OR at (2 j + 1) * WORDS
  int* hist;      // (n + 1) / 2, 8-byte aligned (read as int2 by the other blocks)
  int* cur;       // (n + 1) / 2
  int* nslot;     // (n + 1) / 2: the next level's bucket a bin starts, or -1
  unsigned* head; // n / 32 + 2
  int* lstart;
  int* lsize;
  int* lpre;
  int* lmine;
  int* lbase;
  int* lshift;
  int* ldig;
  int* nstart;
  int* nsize;
  int* sums;      // 32
  int* misc;      // 16: [0] buckets this level, [2..4] its keys, this block's, its bins
};

__host__ __device__ __forceinline__ int split_lmax(int n) { return n / (SMALL + 1) + 1; }

template <int WORDS>
__device__ __forceinline__ SplitSmem split_smem(unsigned char* base, int n, int chunk) {
  const int lmax = split_lmax(n);
  const int hb = (n + 1) / 2;
  SplitSmem m;
  u64* p = reinterpret_cast<u64*>(base);
  m.keys = p;
  p += 2 * WORDS * chunk;
  m.part = p;
  p += 2 * WORDS * lmax;
  int* q = reinterpret_cast<int*>(p);
  m.hist = q;
  q += hb;
  m.cur = q;
  q += hb;
  m.nslot = q;
  q += hb;
  m.head = reinterpret_cast<unsigned*>(q);
  q += n / 32 + 2;
  int** lists[9] = {&m.lstart, &m.lsize, &m.lpre, &m.lmine, &m.lbase,
                    &m.lshift, &m.ldig, &m.nstart, &m.nsize};
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    *lists[i] = q;
    q += lmax;
  }
  m.sums = q;
  m.misc = q + 32;
  return m;
}

// 32 bits of the packed key from bit s up.
template <int WORDS>
__device__ __forceinline__ unsigned bits_at(const Packed& p, int s) {
  if (WORDS == 1 || s < 64) {
    const unsigned lo = static_cast<unsigned>(p.lo >> (s & 63));
    if (WORDS == 1 || s <= 32) return lo;
    return lo | static_cast<unsigned>(p.hi << (64 - s));
  }
  return static_cast<unsigned>(p.hi >> (s - 64));
}

template <int WORDS>
__device__ __forceinline__ bool key_less(const Packed& a, const Packed& b) {
  if (WORDS == 2 && a.hi != b.hi) return a.hi < b.hi;
  return a.lo < b.lo;
}

template <int WORDS>
__device__ __forceinline__ bool key_equal(const Packed& a, const Packed& b) {
  return a.lo == b.lo && (WORDS == 1 || a.hi == b.hi);
}

// The largest i with pre[i] <= x (pre non-decreasing, pre[0] = 0 <= x):
// the bucket whose run of keys holds flat key x.
__device__ __forceinline__ int find_run(const int* pre, int count, int x) {
  int lo = 0;
  int hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= x) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Inclusive sum of x over the lanes up to this one (every lane calls it).
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The digit's bin of a key of bucket j.
template <int WORDS>
__device__ __forceinline__ int bin_of(const SplitSmem& m, int j, const Packed& p) {
  return m.lbase[j] +
         static_cast<int>(bits_at<WORDS>(p, m.lshift[j]) & ((1u << m.ldig[j]) - 1u));
}

// The cluster sorts all n keys in its blocks' shared memory, most
// significant digit first (the header note's split method); block r owns
// positions [r * chunk, (r + 1) * chunk). Levels split the buckets of
// more than SMALL keys by their top varying bits: each block counts its
// own keys of each bin, reads every block's counts (distributed shared
// memory, 8 bytes a load), and scatters its keys into the blocks that
// own their new positions. The last step ranks each key inside its
// bucket (reading a neighbour block's keys where the bucket crosses into
// it) and writes it out.
template <int WORDS>
__global__ void __launch_bounds__(SPLIT_THREADS, 1) seat_sort_split_kernel(Keys k, int n,
                                                                           Fields f,
                                                                           pt::Stamps stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int blocks = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  const int chunk = (n + blocks - 1) / blocks;
  const int lo = min(n, me * chunk);
  const int hi = min(n, lo + chunk);
  const SplitSmem m = split_smem<WORDS>(smem, n, chunk);
  const Buf<WORDS> b{m.keys, chunk};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool stamper = me == 0 && tid == 0;
  const auto key_at = [&](int side, int q) -> Packed {  // any block's key at position q
    const int owner = q / chunk;
    if (owner == me) return b.load(side, q - lo);
    const Buf<WORDS> there{cl.map_shared_rank(m.keys, owner), chunk};
    return there.load(side, q - owner * chunk);
  };
  stamps(STAMP_START, stamper);
  const int hwords = n / 32 + 2;
  for (int i = tid; i < hwords; i += SPLIT_THREADS) m.head[i] = i == 0 ? 1u : 0u;
  for (int i = tid; i < (n + 1) / 2; i += SPLIT_THREADS) m.hist[i] = 0;
  if (tid == 0) {
    m.misc[0] = n > SMALL ? 1 : 0;
    m.lstart[0] = 0;
    m.lsize[0] = n;
  }
  // pack this block's keys, four a thread a batch with all their loads in
  // flight
  constexpr int BATCH = 4;
  for (int first = lo; first < hi; first += BATCH * SPLIT_THREADS) {
    Packed p[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = first + i * SPLIT_THREADS + tid;
      if (e < hi) p[i] = pack<WORDS>(k, f, e);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = first + i * SPLIT_THREADS + tid;
      if (e < hi) b.store(0, e - lo, p[i]);
    }
  }
  __syncthreads();  // this block's keys and the first bucket are in place
  stamps(STAMP_PACKED, stamper);
  int side = 0;
  int level = 0;
  // whether every block's keys at `side` are where the rank step reads
  // them, ordered by a cluster barrier (the same in every block)
  bool settled = false;
  for (;; ++level) {
    const int count = m.misc[0];
    if (count == 0) break;
    const auto step = [&](int i) {  // the phase stamps of levels 0 and 1
      if (level < 2) stamps((level ? STAMP_STEP1 : STAMP_STEP0) + i, stamper);
    };
    // the buckets' keys laid end to end (flat index x), over the cluster
    // and over this block's own positions
    // (a list of at most 32 buckets, as at the flagship, is scanned by
    // warp 0 alone: one barrier where a block scan takes three)
    const bool few = count <= 32;
    const int size = tid < count ? m.lsize[tid] : 0;
    int here = 0;
    if (tid < count) {
      const int s0 = m.lstart[tid];
      here = max(0, min(s0 + size, hi) - max(s0, lo));
    }
    int listed;
    int owned;
    int pre;
    int pre_mine;
    if (few) {
      pre = warp_inclusive_scan(size);
      pre_mine = warp_inclusive_scan(here);
      listed = __shfl_sync(0xffffffffu, pre, 31);
      owned = __shfl_sync(0xffffffffu, pre_mine, 31);
      pre -= size;
      pre_mine -= here;
    } else {
      pre = block_exclusive_scan<SPLIT_THREADS>(size, m.sums, listed);
      pre_mine = block_exclusive_scan<SPLIT_THREADS>(here, m.sums, owned);
    }
    if (tid < count) {
      m.lpre[tid] = pre;
      m.lmine[tid] = pre_mine;
    }
    if (few && tid == 0) {
      m.misc[2] = listed;
      m.misc[3] = owned;
    }
    __syncthreads();
    if (few) {
      listed = m.misc[2];
      owned = m.misc[3];
    }
    // position of this block's flat key x: bucket j, global position e
    const auto own = [&](int x, int& j) {
      j = find_run(m.lmine, count, x);
      return max(m.lstart[j], lo) + x - m.lmine[j];
    };
    // each bucket's digit: its top d varying bits, from the blocks' parts
    // of its AND and OR (d = 0 where its keys are all equal: one bin, not
    // split again); the first bucket's, the top bits of the packed width
    int bins = 0;
    if (tid < count) {
      int width = f.pos[0] + f.bits[0];
      if (level > 0) {
        u64 va[WORDS];
        u64 vo[WORDS];
#pragma unroll
        for (int w = 0; w < WORDS; ++w) {
          va[w] = ~0ull;
          vo[w] = 0ull;
        }
#pragma unroll
        for (int r = 0; r < SPLIT_CLUSTER; ++r) {  // unrolled: the remote loads overlap
          if (r < blocks) {
            const u64* there = cl.map_shared_rank(m.part, r);
#pragma unroll
            for (int w = 0; w < WORDS; ++w) {
              va[w] &= there[2 * tid * WORDS + w];
              vo[w] |= there[(2 * tid + 1) * WORDS + w];
            }
          }
        }
        const u64 vlo = va[0] ^ vo[0];
        if (WORDS == 2) {
          const u64 vhi = va[WORDS - 1] ^ vo[WORDS - 1];
          width = vhi ? 128 - __clzll(vhi) : (vlo ? 64 - __clzll(vlo) : 0);
        } else {
          width = vlo ? 64 - __clzll(vlo) : 0;
        }
      }
      const int d = width ? min(min(width, DIGIT_MAX), 30 - __clz(m.lsize[tid])) : 0;
      m.lshift[tid] = width - d;
      m.ldig[tid] = d;
      bins = 1 << d;
    }
    int used;
    int bin0;
    if (few) {
      bin0 = warp_inclusive_scan(bins);
      used = __shfl_sync(0xffffffffu, bin0, 31);
      bin0 -= bins;
      if (tid == 0) m.misc[4] = used;
    } else {
      bin0 = block_exclusive_scan<SPLIT_THREADS>(bins, m.sums, used);
    }
    if (tid < count) m.lbase[tid] = bin0;
    __syncthreads();  // the bins (zero since the last level) are laid out
    if (few) used = m.misc[4];
    step(0);
    // count this block's keys of each bin
    for (int x0 = warp * 32; x0 < owned; x0 += SPLIT_THREADS) {
      const int x = x0 + lane;
      const unsigned act = __ballot_sync(0xffffffffu, x < owned);
      if (x < owned) {
        int j;
        const Packed p = b.load(side, own(x, j) - lo);
        const int bin = bin_of<WORDS>(m, j, p);
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&m.hist[bin], __popc(peers));
      }
    }
    cl.sync();  // every block's counts are in place
    step(1);
    // each bin's keys in all blocks and in the blocks before this one, 2
    // bins a thread (one 8-byte load a block): this block's cursor of the
    // bin; a non-empty bin starts a bucket (the same bitmap in every
    // block), and one of more than SMALL keys, not all equal, is split at
    // the next level: its slot by a scan in bin order (the same lists in
    // every block), kept beside the bin for the scatter, which folds the
    // bucket's AND and OR. The scan runs on total | next-level flag << 16
    // (n <= SPLIT_MAX_N: the keys' sum fits its low 16 bits).
    int carry = 0;
    for (int c0 = 0; c0 < used; c0 += SPLIT_THREADS * 2) {
      const int i0 = c0 + tid * 2;
      int tot[2] = {0, 0};
      int before[2] = {0, 0};
      if (i0 < used) {
#pragma unroll
        for (int r = 0; r < SPLIT_CLUSTER; ++r) {
          if (r < blocks) {
            const int2 v = *reinterpret_cast<const int2*>(cl.map_shared_rank(m.hist, r) + i0);
            tot[0] += v.x;
            tot[1] += v.y;
            before[0] += r < me ? v.x : 0;
            before[1] += r < me ? v.y : 0;
          }
        }
      }
      if (c0 == 0) step(2);
      int flag[2];
      int local = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (i0 + q >= used) tot[q] = 0;
        flag[q] = 0;
        if (tot[q] > SMALL) flag[q] = m.ldig[find_run(m.lbase, count, i0 + q)] > 0;
        local += tot[q] | flag[q] << 16;
      }
      int total;
      int run = carry + block_exclusive_scan<SPLIT_THREADS>(local, m.sums, total);
      if (c0 == 0) step(3);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = i0 + q;
        if (i < used) {
          const int at = run & 0xffff;
          m.cur[i] = at + before[q];
          m.nslot[i] = -1;
          if (tot[q] > 0) {
            const int j = find_run(m.lbase, count, i);
            const int pos = m.lstart[j] + at - m.lpre[j];
            atomicOr(&m.head[pos >> 5], 1u << (pos & 31));
            if (flag[q]) {
              const int slot = run >> 16;
              m.nstart[slot] = pos;
              m.nsize[slot] = tot[q];
              m.nslot[i] = slot;
#pragma unroll
              for (int w = 0; w < WORDS; ++w) {
                m.part[2 * slot * WORDS + w] = ~0ull;
                m.part[(2 * slot + 1) * WORDS + w] = 0ull;
              }
            }
          }
        }
        run += tot[q] | flag[q] << 16;
      }
      carry += total;
    }
    __syncthreads();
    step(4);
    // scatter this block's keys into the blocks that own their bins' places
    for (int x0 = warp * 32; x0 < owned; x0 += SPLIT_THREADS) {
      const int x = x0 + lane;
      const unsigned act = __ballot_sync(0xffffffffu, x < owned);
      if (x < owned) {
        int j;
        const Packed p = b.load(side, own(x, j) - lo);
        const int bin = bin_of<WORDS>(m, j, p);
        const unsigned peers = __match_any_sync(act, bin);
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&m.cur[bin], __popc(peers));
        at = __shfl_sync(act, at, leader);
        const int pos = m.lstart[j] - m.lpre[j] + at + __popc(peers & ((1u << lane) - 1u));
        const int owner = pos / chunk;
        const Buf<WORDS> there{owner == me ? m.keys : cl.map_shared_rank(m.keys, owner), chunk};
        there.store(side ^ 1, pos - owner * chunk, p);
        const int slot = m.nslot[bin];  // the same for every lane of `peers`
        if (slot >= 0) {  // fold the next level's bucket's AND and OR
          const u64 word[2] = {p.lo, p.hi};
#pragma unroll
          for (int w = 0; w < WORDS; ++w) {
            const unsigned l = static_cast<unsigned>(word[w]);
            const unsigned h = static_cast<unsigned>(word[w] >> 32);
            const u64 va = static_cast<u64>(__reduce_and_sync(peers, h)) << 32 |
                           __reduce_and_sync(peers, l);
            const u64 vo = static_cast<u64>(__reduce_or_sync(peers, h)) << 32 |
                           __reduce_or_sync(peers, l);
            if (lane == leader) {
              atomicAnd(&m.part[2 * slot * WORDS + w], va);
              atomicOr(&m.part[(2 * slot + 1) * WORDS + w], vo);
            }
          }
        }
      }
    }
    cl.sync();  // every key has landed; every read of the counts and parts is done
    step(5);
    if (listed == n) {
      side ^= 1;  // every key moved: the other side holds them all
      settled = true;
    } else {
      // the moved keys back to `side`, each by its owner, after the
      // level's last cluster barrier
      for (int x = tid; x < owned; x += SPLIT_THREADS) {
        int j;
        const int e = own(x, j) - lo;
        b.store(side, e, b.load(side ^ 1, e));
      }
      settled = false;
    }
    for (int i = tid; i < used; i += SPLIT_THREADS) m.hist[i] = 0;  // for the next level
    const int next = carry >> 16;
    __syncthreads();
    if (tid < next) {
      m.lstart[tid] = m.nstart[tid];
      m.lsize[tid] = m.nsize[tid];
    }
    if (tid == 0) m.misc[0] = next;
    stamps(STAMP_LEVEL + level, stamper && level < STAMP_LEVEL_MAX);
    stamps.put(STAMP_LISTED + level, listed, stamper && level < STAMP_LISTED_MAX);
    __syncthreads();
  }
  stamps.put(STAMP_LEVELS, level, stamper);
  // The rank below reads other blocks' keys. A last level that moved
  // every key has ordered them by its cluster barrier. Otherwise no
  // barrier has yet ordered each block's last writes of its keys before
  // the other blocks' reads: with no level (n <= SMALL) the packing, and
  // a block could even read a neighbour that had not started; after a
  // level that moved some keys, the copy back to `side`. Without this
  // barrier a block could rank against a neighbour's stale keys: a wrong
  // rank, and out-of-range ids in the outputs.
  if (!settled) cl.sync();
  // rank every key of this block inside its bucket (at most SMALL keys,
  // or all equal)
  for (int e = lo + tid; e < hi; e += SPLIT_THREADS) {
    const Packed p = b.load(side, e - lo);
    const int w0 = e >> 5;
    const unsigned upto = 0xffffffffu >> (31 - (e & 31));  // bits <= e's
    const unsigned below = m.head[w0] & upto;
    const unsigned above = m.head[w0] & ~upto;
    int s = -1;
    if (below) s = (w0 << 5) + 31 - __clz(below);
    else if (w0 > 0 && m.head[w0 - 1]) s = ((w0 - 1) << 5) + 31 - __clz(m.head[w0 - 1]);
    int t = -1;
    if (above) t = (w0 << 5) + __ffs(above) - 1;
    else if (((w0 + 1) << 5) >= n) t = n;
    else if (m.head[w0 + 1]) t = ((w0 + 1) << 5) + __ffs(m.head[w0 + 1]) - 1;
    else if (((w0 + 2) << 5) >= n) t = n;
    int rank = e;
    if (s >= 0 && t >= 0 && t - s <= SMALL) {
      rank = s;
      for (int q = s; q < t; ++q) {
        const Packed o = q >= lo && q < hi ? b.load(side, q - lo) : key_at(side, q);
        rank += key_less<WORDS>(o, p) || (q < e && key_equal<WORDS>(o, p));
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_KEYS; ++i)
      if (i < f.nkeys) k.out[i][rank] = field<WORDS>(p, f, i);
  }
  cl.sync();  // no block leaves while another may read its keys
  stamps(STAMP_END, stamper);
}

// ---- the onesweep method ---------------------------------------------

// A look-back word: tile t's count of one digit in pass `pass`.
__device__ __forceinline__ unsigned status_word(unsigned flag, int pass, int count) {
  return flag << 30 | static_cast<unsigned>(pass) << STATUS_COUNT_BITS |
         static_cast<unsigned>(count);
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The keys of digit d in the tiles before `tile`: the earlier tiles'
// words, LOOK at a time (relaxed loads, in flight together: an acquire
// load would hold the next until it completed), nearest first, summed up
// to an inclusive prefix; a word not yet written in this pass (flag 0, or
// another pass's) is loaded again. Tiles before 0 read as a prefix of 0.
// A fence after the last window makes the loads that found the prefix
// acquire it (each word carries its own count, so nothing else is read
// through it).
__device__ __forceinline__ int look_back(const unsigned* status, int tile, int d, int pass) {
  constexpr unsigned COUNT_MASK = (1u << STATUS_COUNT_BITS) - 1u;
  const unsigned start = status_word(FLAG_PREFIX, pass, 0);
  int sum = 0;
  int t = tile - 1;
  for (;;) {
    unsigned w[LOOK];
#pragma unroll
    for (int j = 0; j < LOOK; ++j)
      w[j] = t - j >= 0 ? load_relaxed(status + static_cast<size_t>(t - j) * RADIX + d) : start;
    int used = 0;  // words taken, nearest first: aggregates so far
#pragma unroll
    for (int j = 0; j < LOOK; ++j) {
      const unsigned v = w[j];
      const bool ready = (v >> 30) != 0u &&
                         ((v >> STATUS_COUNT_BITS) & 15u) == static_cast<unsigned>(pass);
      if (used == j && ready) {
        sum += static_cast<int>(v & COUNT_MASK);
        if ((v >> 30) == FLAG_PREFIX) {
          __threadfence();
          return sum;
        }
        used = j + 1;
      }
    }
    t -= used;
  }
}

// The workspace (ints): every pass's histogram [passes][RADIX], WORK_HEAD
// ints ([0] the up-front blocks finished, [1] the live mask, [2 + p] pass
// p's tile counter), then the look-back words [tiles][RADIX] (one set for
// all passes: a word carries its pass). The memset zeroes everything
// before the look-back words; the up-front launch zeroes those.
struct Work {
  int* hist;
  int* head;
  unsigned* status;
};

__device__ __forceinline__ Work work_at(int* base, int passes) {
  Work w;
  w.hist = base;
  w.head = base + passes * RADIX;
  w.status = reinterpret_cast<unsigned*>(w.head + WORK_HEAD);
  return w;
}

// The up-front launch: every key packed into side 0, every pass's digits
// counted, the look-back words zeroed; the last block to finish marks the
// live passes.
template <int WORDS>
__global__ void __launch_bounds__(HIST_THREADS) seat_sweep_hist_kernel(Keys k, int n, Fields f,
                                                                      u64* buf, int stride,
                                                                      int* ws, int tiles) {
  __shared__ int h[MAX_PASSES * RADIX];
  __shared__ int last;
  const int passes = f.passes;
  const Work w = work_at(ws, passes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < passes * RADIX; i += HIST_THREADS) h[i] = 0;
  const size_t words = static_cast<size_t>(tiles) * RADIX;
  for (size_t i = static_cast<size_t>(blockIdx.x) * HIST_THREADS + tid; i < words;
       i += static_cast<size_t>(gridDim.x) * HIST_THREADS)
    w.status[i] = 0u;
  __syncthreads();
  const Buf<WORDS> b{buf, stride};
  constexpr int SPAN = HIST_THREADS * HIST_ITEMS;
  for (int first = blockIdx.x * SPAN; first < n; first += gridDim.x * SPAN) {
    Packed p[HIST_ITEMS];
#pragma unroll
    for (int r = 0; r < HIST_ITEMS; ++r) {
      const int e = first + r * HIST_THREADS + tid;
      if (e < n) p[r] = pack<WORDS>(k, f, e);
    }
#pragma unroll
    for (int r = 0; r < HIST_ITEMS; ++r) {
      const int e = first + r * HIST_THREADS + tid;
      const unsigned act = __ballot_sync(0xffffffffu, e < n);
      if (e < n) {
        b.store(0, e, p[r]);
        const int leader = __ffs(act) - 1;
        for (int q = 0; q < passes; ++q) {
          const int d = digit<WORDS>(p[r], q);
          // a warp whose keys share the digit adds once
          if (__all_sync(act, d == __shfl_sync(act, d, leader))) {
            if (lane == leader) atomicAdd(&h[q * RADIX + d], __popc(act));
          } else {
            atomicAdd(&h[q * RADIX + d], 1);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < passes * RADIX; i += HIST_THREADS)
    if (h[i]) atomicAdd(&w.hist[i], h[i]);
  __threadfence();  // this thread's adds before the block's count below
  __syncthreads();
  if (tid == 0) last = atomicAdd(&w.head[0], 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block's adds are seen by the reads below
  // a thread a digit: its bin of every pass, the loads in flight together;
  // one bin holding all n keys makes the pass move nothing
  static_assert(HIST_THREADS >= RADIX, "a thread a digit");
  const volatile int* hist = w.hist;
  unsigned full = 0u;
  if (tid < RADIX) {
    int c[MAX_PASSES];
#pragma unroll
    for (int q = 0; q < MAX_PASSES; ++q) c[q] = q < passes ? hist[q * RADIX + tid] : 0;
#pragma unroll
    for (int q = 0; q < MAX_PASSES; ++q) full |= static_cast<unsigned>(c[q] == n) << q;
  }
  // the passes with a full bin, over the block (h is free again)
  if (tid == 0) h[0] = 0;
  __syncthreads();
  if (full) atomicOr(reinterpret_cast<unsigned*>(h), full);
  __syncthreads();
  const unsigned live = ~static_cast<unsigned>(h[0]) & ((1u << passes) - 1u);
  if (tid == 0) w.head[1] = static_cast<int>(live ? live : 1u);
}

// One digit pass. A block's shared memory: its tile's keys (word j of
// local key i at j * TILE + i), then ints: each warp's count of each digit
// (then the warp's offset inside the digit), each digit's global offset
// (then its base), each digit's start in the tile, the warp sums, the
// scalars (SWEEP_FIXED_INTS in all).
template <int WORDS, int ROUNDS>
__global__ void __launch_bounds__(SWEEP_THREADS) seat_sweep_pass_kernel(Keys k, int n, Fields f,
                                                                       u64* buf, int stride,
                                                                       int* ws, int pass) {
  constexpr int TILE = SWEEP_THREADS * ROUNDS;
  static_assert(ROUNDS % 2 == 0, "a tile of whole 16-byte vectors");
  static_assert(SWEEP_THREADS >= RADIX, "a thread a digit");
  extern __shared__ __align__(16) unsigned char smem[];
  u64* tk = reinterpret_cast<u64*>(smem);
  int* cnt = reinterpret_cast<int*>(tk + WORDS * TILE);
  int* base = cnt + SWEEP_WARPS * RADIX;
  int* lstart = base + RADIX;
  int* sums = lstart + RADIX;
  int* misc = sums + 32;
  const Work w = work_at(ws, f.passes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the tile number, the live mask and the histogram loaded together (a
  // dead pass's tile numbers are never read)
  if (tid == 0) misc[0] = atomicAdd(&w.head[2 + pass], 1);
  const int h = tid < RADIX ? w.hist[pass * RADIX + tid] : 0;
  const unsigned live = static_cast<unsigned>(w.head[1]);
  if (!((live >> pass) & 1u)) return;  // one digit for every key: nothing moves
  const int src = __popc(live & ((1u << pass) - 1u)) & 1;
  const bool last = (live >> (pass + 1)) == 0u;
  for (int i = tid; i < SWEEP_WARPS * RADIX; i += SWEEP_THREADS) cnt[i] = 0;
  // the pass's global digit offsets (the scan's barriers also publish the
  // tile number and the zeroed counts)
  int all;
  const int g = block_exclusive_scan<SWEEP_THREADS>(h, sums, all);
  if (tid < RADIX) base[tid] = g;
  const int tile = misc[0];
  const int first = tile * TILE;
  const int here = min(TILE, n - first);
  // the tile into shared memory by 16-byte vectors (rows of `stride`
  // keys, a multiple of 32, so a pair's key past n is still in the row)
  {
    const int pairs = (here + 1) >> 1;
    ulonglong2 v[WORDS][ROUNDS / 2];
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const ulonglong2* from = reinterpret_cast<const ulonglong2*>(
          buf + static_cast<size_t>(src * WORDS + j) * stride + first);
#pragma unroll
      for (int r = 0; r < ROUNDS / 2; ++r) {
        const int q = r * SWEEP_THREADS + tid;
        if (q < pairs) v[j][r] = from[q];
      }
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      ulonglong2* to = reinterpret_cast<ulonglong2*>(tk + j * TILE);
#pragma unroll
      for (int r = 0; r < ROUNDS / 2; ++r) {
        const int q = r * SWEEP_THREADS + tid;
        if (q < pairs) to[q] = v[j][r];
      }
    }
  }
  __syncthreads();
  // rank every key among the tile's keys of its digit, stably: warp w
  // takes keys [w * ROUNDS * 32, (w + 1) * ROUNDS * 32), 32 a round; first
  // its rank among the warp's keys of the digit
  Packed key[ROUNDS];
  int rank[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = (warp * ROUNDS + r) * 32 + lane;
    const bool in = i < here;
    const unsigned act = __ballot_sync(0xffffffffu, in);
    rank[r] = 0;
    if (in) {
      key[r].lo = tk[i];
      key[r].hi = WORDS == 2 ? tk[TILE + i] : 0ull;
      const int d = digit<WORDS>(key[r], pass);
      const unsigned peers = match_digit(act, d);
      volatile int* slot = cnt + warp * RADIX + d;
      const int before = *slot;
      rank[r] = before + __popc(peers & ((1u << lane) - 1u));
      __syncwarp(act);
      if (lane == __ffs(peers) - 1) *slot = before + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // each digit: the warps' offsets inside it, the tile's count, published
  // (tile 0's count is its inclusive prefix), its start in the tile
  int count = 0;
  if (tid < RADIX) {
    for (int v = 0; v < SWEEP_WARPS; ++v) {
      const int c = cnt[v * RADIX + tid];
      cnt[v * RADIX + tid] = count;
      count += c;
    }
    store_release(w.status + static_cast<size_t>(tile) * RADIX + tid,
                  status_word(tile ? FLAG_AGGREGATE : FLAG_PREFIX, pass, count));
  }
  const int ls = block_exclusive_scan<SWEEP_THREADS>(count, sums, all);
  if (tid < RADIX) lstart[tid] = ls;
  __syncthreads();
  // the keys back into shared memory in digit order (every read of the
  // tile there ended at the barrier after the rank)
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = (warp * ROUNDS + r) * 32 + lane;
    if (i < here) {
      const int d = digit<WORDS>(key[r], pass);
      const int at = lstart[d] + cnt[warp * RADIX + d] + rank[r];
      tk[at] = key[r].lo;
      if (WORDS == 2) tk[TILE + at] = key[r].hi;
    }
  }
  // each digit's keys in the earlier tiles; this tile's prefix published
  if (tid < RADIX) {
    int before = 0;
    if (tile > 0) {
      before = look_back(w.status, tile, tid, pass);
      store_release(w.status + static_cast<size_t>(tile) * RADIX + tid,
                    status_word(FLAG_PREFIX, pass, before + count));
    }
    base[tid] += before - lstart[tid];  // the digit's key at tile place j goes to base + j
  }
  __syncthreads();
  // the tile out in digit order, each digit's run to consecutive places;
  // the last live pass writes the int32 fields
  const Buf<WORDS> b{buf, stride};
  for (int j = tid; j < here; j += SWEEP_THREADS) {
    Packed p;
    p.lo = tk[j];
    p.hi = WORDS == 2 ? tk[TILE + j] : 0ull;
    const int at = base[digit<WORDS>(p, pass)] + j;
    if (last) {
#pragma unroll
      for (int i = 0; i < MAX_KEYS; ++i)
        if (i < f.nkeys) k.out[i][at] = field<WORDS>(p, f, i);
    } else {
      b.store(src ^ 1, at, p);
    }
  }
}

// A pass block's dynamic shared memory (kernels/seat_sort.py
// `sweep_smem` sums the same sizes).
__host__ __device__ constexpr int sweep_smem(int words, int rounds) {
  return 8 * words * SWEEP_THREADS * rounds + 4 * SWEEP_FIXED_INTS;
}

template <int WORDS, int ROUNDS>
cudaError_t sweep_passes(const Keys& k, int n, const Fields& f, int tiles, u64* buf, int stride,
                         int* ws, cudaStream_t st) {
  for (int pass = 0; pass < f.passes; ++pass) {
    seat_sweep_pass_kernel<WORDS, ROUNDS>
        <<<tiles, SWEEP_THREADS, sweep_smem(WORDS, ROUNDS), st>>>(k, n, f, buf, stride, ws, pass);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int WORDS>
cudaError_t sort_keys(const Keys& k, int n, const Fields& f, int method, int cluster, int smem,
                      int tiles, int rounds, int stride, int hist_blocks, u64* buf, int* ws,
                      pt::Stamps stamps, cudaStream_t st) {
  if (method == METHOD_SPLIT) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(SPLIT_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, seat_sort_split_kernel<WORDS>, k, n, f, stamps);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  // in stream order: the head zeroed, the up-front launch, the passes
  cudaError_t e = cudaMemsetAsync(
      ws, 0, sizeof(int) * static_cast<size_t>(f.passes * RADIX + WORK_HEAD), st);
  if (e != cudaSuccess) return e;
  seat_sweep_hist_kernel<WORDS>
      <<<hist_blocks, HIST_THREADS, 0, st>>>(k, n, f, buf, stride, ws, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (rounds) {
    case 4: return sweep_passes<WORDS, 4>(k, n, f, tiles, buf, stride, ws, st);
    default: return sweep_passes<WORDS, 8>(k, n, f, tiles, buf, stride, ws, st);
  }
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

template <class Kernel>
cudaError_t lift_smem(cudaError_t e, Kernel kernel, int bytes) {
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 bytes);
}

// Lift the split kernel's dynamic shared-memory cap to the card's
// per-block maximum and report that maximum (the plan sizes the split by
// it), and each onesweep pass kernel's to its tile's size. Called once
// per device.
extern "C" int seat_sort_setup(int* optin) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  e = lift_smem(e, seat_sort_split_kernel<1>, *optin);
  e = lift_smem(e, seat_sort_split_kernel<2>, *optin);
  e = lift_smem(e, seat_sweep_pass_kernel<1, 4>, sweep_smem(1, 4));
  e = lift_smem(e, seat_sweep_pass_kernel<1, 8>, sweep_smem(1, 8));
  e = lift_smem(e, seat_sweep_pass_kernel<2, 4>, sweep_smem(2, 4));
  e = lift_smem(e, seat_sweep_pass_kernel<2, 8>, sweep_smem(2, 8));
  return static_cast<int>(e);
}

// Sort n positions by nkeys int32 keys (k0 most significant), key i in
// [lo_i, lo_i + 2^bits_i), into o0..o3. `words` (1 or 2) 64-bit words a
// packed key; `method` METHOD_SPLIT (`cluster` blocks of `smem` bytes)
// or METHOD_ONESWEEP: `tiles` tiles of SWEEP_THREADS * `rounds` keys
// (rounds 4 or 8),
// `hist_blocks` up-front blocks, buf 2 * words rows of `stride` 64-bit
// words, ws the workspace (passes * RADIX + WORK_HEAD + tiles * RADIX
// ints; kernels/seat_sort.py `sweep_work`). The stamps build takes
// `stamps` too (STAMPS int64) for the split's phase stamps.
extern "C" int seat_sort_launch(const int* k0, const int* k1, const int* k2, const int* k3,
                                int* o0, int* o1, int* o2, int* o3, int n, int nkeys, int lo0,
                                int lo1, int lo2, int lo3, int b0, int b1, int b2, int b3,
                                int words, int method, int cluster, int smem, int tiles,
                                int rounds, int stride, int hist_blocks, void* buf, int* ws,
#ifdef PHASE_STAMPS
                                long long* stamp_buf,
#endif
                                void* stream) {
#ifdef PHASE_STAMPS
  const pt::Stamps stamps{stamp_buf};
#else
  const pt::Stamps stamps{};
#endif
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
  f.passes = width > 0 ? (width + 7) / 8 : 1;  // the last live pass writes the outputs
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* b = static_cast<u64*>(buf);
  if (method == METHOD_SPLIT) {
    if (cluster < 1 || cluster > SPLIT_CLUSTER || n > SPLIT_MAX_N)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (method == METHOD_ONESWEEP) {
    const long long tile = static_cast<long long>(SWEEP_THREADS) * rounds;
    if ((rounds != 4 && rounds != 8) || tiles != (n + tile - 1) / tile ||
        stride < n || stride % STRIDE_KEYS != 0 || hist_blocks < 1 ||
        n >= (1 << STATUS_COUNT_BITS) || b == nullptr || ws == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      words == 1 ? sort_keys<1>(k, n, f, method, cluster, smem, tiles, rounds, stride,
                                hist_blocks, b, ws, stamps, st)
                 : sort_keys<2>(k, n, f, method, cluster, smem, tiles, rounds, stride,
                                hist_blocks, b, ws, stamps, st));
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
