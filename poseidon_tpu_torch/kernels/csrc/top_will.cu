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
// * list (smax <= LIST_MAX): one pass over the table. A block of
//   LIST_THREADS threads covers LIST_THREADS adjacent columns of one slab
//   of rows, a thread one column, so a warp's loads of a row are 128
//   contiguous bytes. Each thread keeps the K largest values of its
//   column's slab in registers (K = smax rounded up to a power of two, a
//   template argument), sorted descending: a value that does not beat the
//   list's last entry costs one compare, the others an unrolled
//   branch-free shift (few registers, so an SM keeps many warps loading).
//   The slab's list goes to part[slab, :, m]. A second launch (`merge`)
//   folds the slabs' lists of a column: a block's warps (16, or 8 for K
//   32) share a group of 32 columns and take turns at the lists, each
//   loading a whole list and merging it into its own by taking the larger
//   of a[i] and b[K - 1 - i] (the K largest of both, a bitonic sequence)
//   and log2(K) half-cleaners; warp 0 merges the warps' lists from shared
//   memory and writes the k_m-th entry. Under a row-block mesh each shard
//   writes its slabs' lists into its own part of `part`, and one merge
//   reads all of them: the k-th largest of the union is among each shard's
//   own k largest.
//
// * radix (larger smax, up to the rows): selection by the value's four
//   bytes, most significant first, on the order-preserving unsigned key
//   will ^ 0x80000000. Pass q (q = 0..3) launches `hist`: a block covers
//   HIST_COLS columns (a lane each) of a slab of rows, its eight warps
//   taking every eighth row, and counts the byte q of every value whose
//   bytes above q equal the column's prefix so far, in a shared-memory
//   histogram laid out digit-major, so a warp's 32 lanes hit 32 banks. It
//   adds the nonzero bins into hist[part, byte, m] with global atomics.
//   Then `pick` (a warp a column, eight bins a lane and a suffix scan over
//   the lanes) finds the byte where the count from the top reaches the
//   rank still wanted, takes the counts above it off the rank, zeroes the
//   bins for the next pass, and after the fourth byte writes the value. Under a mesh each shard counts into
//   its own part and `pick` sums the parts. This reads the table four
//   times, so it is the first step-2 candidate where smax is large (config
//   8's aggregated classes).
#include "common.cuh"

namespace {

constexpr int LIST_THREADS = 128;
constexpr int LIST_UNROLL = 8;
constexpr int MERGE_COLS = 32;
// warps of a merge block: its warps' lists fill 32 KiB of shared memory
template <int K>
__host__ __device__ constexpr int merge_warps() {
  return K <= 16 ? 16 : 8;
}
constexpr int HIST_COLS = 32;
constexpr int HIST_THREADS = 256;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_UNROLL = 4;
constexpr int BINS = 256;
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

template <int K>
__global__ void __launch_bounds__(LIST_THREADS) top_will_list_kernel(
    const int* __restrict__ c, const int* __restrict__ alt1, const int* __restrict__ alt2,
    const int* __restrict__ m1, const unsigned char* __restrict__ valid, int rows, int Mp,
    int rows_per_slab, int* __restrict__ part) {
  const int m = blockIdx.x * LIST_THREADS + threadIdx.x;
  if (m >= Mp) return;
  const int r0 = blockIdx.y * rows_per_slab;
  const int r1 = min(rows, r0 + rows_per_slab);
  int a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = LIST_EMPTY;
  int r = r0;
  for (; r + LIST_UNROLL <= r1; r += LIST_UNROLL) {
    int cv[LIST_UNROLL];
#pragma unroll
    for (int u = 0; u < LIST_UNROLL; ++u) cv[u] = c[static_cast<size_t>(r + u) * Mp + m];
#pragma unroll
    for (int u = 0; u < LIST_UNROLL; ++u)
      list_push<K>(a, will_of(cv[u], __ldg(alt1 + r + u), __ldg(alt2 + r + u),
                              __ldg(m1 + r + u), __ldg(valid + r + u), m));
  }
  for (; r < r1; ++r)
    list_push<K>(a, will_of(c[static_cast<size_t>(r) * Mp + m], __ldg(alt1 + r),
                            __ldg(alt2 + r), __ldg(m1 + r), __ldg(valid + r), m));
  int* out = part + static_cast<size_t>(blockIdx.y) * K * Mp + m;
#pragma unroll
  for (int i = 0; i < K; ++i) out[static_cast<size_t>(i) * Mp] = a[i];
}

__device__ __forceinline__ int rank_of(const int* __restrict__ s, int smax, int m) {
  return min(max(s[m] - 1, 0), smax - 1);
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

__global__ void __launch_bounds__(HIST_THREADS) top_will_hist_kernel(
    const int* __restrict__ c, const int* __restrict__ alt1, const int* __restrict__ alt2,
    const int* __restrict__ m1, const unsigned char* __restrict__ valid, int rows, int Mp,
    int rows_per_slab, int pass, const int* __restrict__ state, int* __restrict__ hist) {
  __shared__ int h[BINS * HIST_COLS];
  for (int i = threadIdx.x; i < BINS * HIST_COLS; i += HIST_THREADS) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * HIST_COLS + lane;
  const int r0 = blockIdx.y * rows_per_slab;
  const int r1 = min(rows, r0 + rows_per_slab);
  const int shift = 24 - 8 * pass;
  if (m < Mp) {
    const unsigned high = pass ? ~0u << (32 - 8 * pass) : 0u;
    const unsigned want = pass ? static_cast<unsigned>(state[m]) & high : 0u;
    int r = r0 + warp;
    for (; r + (HIST_UNROLL - 1) * HIST_WARPS < r1; r += HIST_UNROLL * HIST_WARPS) {
      int cv[HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u)
        cv[u] = c[static_cast<size_t>(r + u * HIST_WARPS) * Mp + m];
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u) {
        const int t = r + u * HIST_WARPS;
        const unsigned key = static_cast<unsigned>(will_of(
            cv[u], __ldg(alt1 + t), __ldg(alt2 + t), __ldg(m1 + t), __ldg(valid + t), m)) ^
                             0x80000000u;
        if ((key & high) == want) atomicAdd(&h[((key >> shift) & 0xff) * HIST_COLS + lane], 1);
      }
    }
    for (; r < r1; r += HIST_WARPS) {
      const unsigned key = static_cast<unsigned>(will_of(
          c[static_cast<size_t>(r) * Mp + m], __ldg(alt1 + r), __ldg(alt2 + r), __ldg(m1 + r),
          __ldg(valid + r), m)) ^
                           0x80000000u;
      if ((key & high) == want) atomicAdd(&h[((key >> shift) & 0xff) * HIST_COLS + lane], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BINS * HIST_COLS; i += HIST_THREADS) {
    const int v = h[i];
    const int col = blockIdx.x * HIST_COLS + (i % HIST_COLS);
    if (v != 0 && col < Mp) atomicAdd(&hist[static_cast<size_t>(i / HIST_COLS) * Mp + col], v);
  }
}

// A warp a column: lane l owns the bins [8 l, 8 l + 8), sums them over the
// parts (zeroing them for the next pass), and a suffix scan over the lanes
// finds the lane whose bins hold the rank still wanted; that lane walks
// its eight bins from the top.
__global__ void __launch_bounds__(PICK_THREADS) top_will_pick_kernel(
    int* __restrict__ hist, int parts, int Mp, int pass, const int* __restrict__ s, int smax,
    int* __restrict__ state, int* __restrict__ out) {
  constexpr int PER_LANE = BINS / 32;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (PICK_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= Mp) return;  // the whole warp: m is the warp's
  const unsigned prefix = pass ? static_cast<unsigned>(state[m]) : 0u;
  const int k = pass ? state[Mp + m] : rank_of(s, smax, m) + 1;
  int cnt[PER_LANE];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int b = lane * PER_LANE + j;
    int n = 0;
    for (int q = 0; q < parts; ++q) {
      int* bin = hist + (static_cast<size_t>(q) * BINS + b) * Mp + m;
      n += *bin;
      *bin = 0;
    }
    cnt[j] = n;
    mine += n;
  }
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
#pragma unroll
    for (int j = PER_LANE - 1; j >= 0; --j) {
      if (acc + cnt[j] >= k) {
        digit = lane * PER_LANE + j;
        rest = k - acc;
        break;
      }
      acc += cnt[j];
    }
  }
  digit = __shfl_sync(0xffffffffu, digit, src);
  rest = __shfl_sync(0xffffffffu, rest, src);
  if (lane == 0) {
    const unsigned p = prefix | static_cast<unsigned>(digit) << (24 - 8 * pass);
    state[m] = static_cast<int>(p);
    state[Mp + m] = rest;
    if (pass == 3) out[m] = static_cast<int>(p ^ 0x80000000u);
  }
}

template <int K>
cudaError_t launch_list(const int* c, const int* alt1, const int* alt2, const int* m1,
                        const unsigned char* valid, int rows, int Mp, int slabs,
                        int rows_per_slab, int* part, cudaStream_t stream) {
  const dim3 grid((Mp + LIST_THREADS - 1) / LIST_THREADS, slabs);
  top_will_list_kernel<K><<<grid, LIST_THREADS, 0, stream>>>(c, alt1, alt2, m1, valid, rows, Mp,
                                                              rows_per_slab, part);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_merge(const int* part, int lists, int Mp, const int* s, int smax, int* out,
                         cudaStream_t stream) {
  top_will_merge_kernel<K><<<(Mp + MERGE_COLS - 1) / MERGE_COLS, merge_warps<K>() * 32, 0,
                             stream>>>(part, lists, Mp, s, smax, out);
  return cudaGetLastError();
}

}  // namespace

// The list method's slab pass over one shard: part[slab, :K, Mp] for
// `slabs` slabs of `rows_per_slab` rows. K is 1, 2, 4, 8, 16 or 32.
extern "C" int top_will_list_launch(const int* c, const int* alt1, const int* alt2, const int* m1,
                                    const unsigned char* valid, int rows, int Mp, int K,
                                    int slabs, int rows_per_slab, int* part, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto launch) {
    return static_cast<int>(launch(c, alt1, alt2, m1, valid, rows, Mp, slabs, rows_per_slab, part,
                                   st));
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

// The list method's merge: out[m] = the k_m-th largest of the `lists`
// lists part[l, :K, m].
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

// The radix method's count of byte `pass` over one shard into
// hist[BINS, Mp] (zero before the pass: `pick` leaves it so).
extern "C" int top_will_hist_launch(const int* c, const int* alt1, const int* alt2, const int* m1,
                                    const unsigned char* valid, int rows, int Mp, int slabs,
                                    int rows_per_slab, int pass, const int* state, int* hist,
                                    void* stream) {
  const dim3 grid((Mp + HIST_COLS - 1) / HIST_COLS, slabs);
  top_will_hist_kernel<<<grid, HIST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      c, alt1, alt2, m1, valid, rows, Mp, rows_per_slab, pass, state, hist);
  return static_cast<int>(cudaGetLastError());
}

// The radix method's choice of byte `pass` from the parts' counts
// hist[parts, BINS, Mp]; state[2, Mp] carries (prefix, rank) between
// passes, and the fourth pass writes out[Mp].
extern "C" int top_will_pick_launch(int* hist, int parts, int Mp, int pass, const int* s,
                                    int smax, int* state, int* out, void* stream) {
  constexpr int cols = PICK_THREADS / 32;
  top_will_pick_kernel<<<(Mp + cols - 1) / cols, PICK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(hist, parts, Mp, pass, s, smax,
                                                              state, out);
  return static_cast<int>(cudaGetLastError());
}
