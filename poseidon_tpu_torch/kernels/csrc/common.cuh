// Shared device helpers for the dense-auction kernels (sm_90a).
//
// Integer conventions follow ops/dense_auction.py: INF = 2^29 is the
// saturation cap, every int32 sum has at most two INF-saturated terms,
// and a sum that could leave that domain wraps exactly as PyTorch's and
// XLA's int32 arithmetic does (two's complement), never as undefined
// signed overflow: wrap_add adds in uint32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr int INF = 1 << 29;
constexpr int THREADS = 256;           // one block = 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 32;
constexpr int KEY_SENTINEL = 0x7fffffff;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Running best-and-runner-up of one row: (v, k) is the lexicographic
// least (value, key) seen; v2 is the least value of every OTHER entry,
// starting at INF (the reference masks the winner's column to INF before
// its second min, so v2 never exceeds INF). The key breaks value ties:
// the column index for a first-index argmin, a rotated rank for the bid
// pass's tie-break.
struct Top2 {
  int v;
  int k;
  int v2;
};

__device__ __forceinline__ Top2 top2_empty() { return Top2{KEY_SENTINEL, KEY_SENTINEL, INF}; }

// Push (v, k). Whichever of the pair and the running best loses, its
// value is the larger of the two values, so v2 takes max(v, a.v) either
// way. `ordered_keys` says that k is larger than every key pushed before
// into this accumulator (a lane walking a row's columns in order), so a
// tie in value never wins and the key compare drops out.
template <bool ordered_keys>
__device__ __forceinline__ void top2_push(Top2& a, int v, int k) {
  a.v2 = min(a.v2, max(v, a.v));
  const bool wins = ordered_keys ? v < a.v : (v < a.v || (v == a.v && k < a.k));
  if (wins) {
    a.v = v;
    a.k = k;
  }
}

__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  const bool b_wins = b.v < a.v || (b.v == a.v && b.k < a.k);
  Top2 w = b_wins ? b : a;
  const Top2 l = b_wins ? a : b;
  w.v2 = min(min(w.v2, l.v2), l.v);
  return w;
}

// Warp-wide reduction; the result is valid in lane 0.
__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.v = __shfl_down_sync(0xffffffffu, t.v, off);
    o.k = __shfl_down_sync(0xffffffffu, t.k, off);
    o.v2 = __shfl_down_sync(0xffffffffu, t.v2, off);
    t = top2_merge(t, o);
  }
  return t;
}

// ---------------------------------------------------------------------
// Row streams: a persistent block of WARPS warps, each walking its own
// rows through a ring of `stages` shared-memory stages filled by Hopper's
// 1-D bulk copy (the TMA engine, no tensor map: a row chunk is one
// contiguous, 16-byte aligned run of bytes). Each stage has one mbarrier
// that the copy completes by byte count; the warp's lane 0 is the only
// producer and the warp itself the only consumer, so releasing a stage
// needs no second barrier: the warp re-arms a stage only after a
// __syncwarp that follows every lane's reads of it.
//
// Dynamic shared memory of one block, in this order (every part a
// multiple of 16 bytes; kernels/row_stream.py computes the same sizes):
//   bars   WARPS * stages          uint64 mbarriers
//   meta   WARPS * meta_ints       ints (per-warp row metadata, K3 only)
//   p      Mp ints when p is resident, else nothing
//   ring   WARPS * stages * stage_ints ints, stage_ints = chunk (p
//          resident) or 2 * chunk (the stage carries p's chunk too)
struct StreamSmem {
  uint64_t* bars;
  int* meta;
  int* p;
  int* ring;
};

__device__ __forceinline__ StreamSmem stream_smem(unsigned char* base, int stages, int meta_ints,
                                                  int Mp, bool p_resident) {
  StreamSmem s;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.meta = reinterpret_cast<int*>(s.bars + WARPS * stages);
  s.p = s.meta + WARPS * meta_ints;
  s.ring = s.p + (p_resident ? Mp : 0);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's one arrival of a phase, announcing the bytes to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// An arrival that announces no bytes: completes a phase with no copy.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Block until the phase of parity `parity` of `bar` has completed. A
// phase that has not completed after ~2^31 SM cycles (about a second)
// can only be a fault of the pipeline: trap, so that the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 31)) {
      __trap();
    }
  }
}

// Lane 0 of each warp initialises the warp's own stage barriers; the
// warp's lane 0 is also the only thread that arms them, so no block
// barrier is needed before the warp issues its first tiles.
__device__ __forceinline__ void init_stage_bars(const StreamSmem& s, int stages) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&s.bars[warp * stages + i], 1);
    fence_barrier_init();
  }
  __syncwarp();
}

// When p is resident, the block copies it into shared memory with
// 16-byte loads. Called after the warps have issued their first tiles,
// so p's load latency overlaps the tiles' copies; it ends in the block's
// only __syncthreads, which also makes every warp's barrier
// initialisation visible to all of its lanes before any waits.
__device__ __forceinline__ void stage_p(const StreamSmem& s, const int* __restrict__ p, int Mp,
                                        bool p_resident) {
  if (p_resident) {
    for (int m = threadIdx.x * 4; m < Mp; m += THREADS * 4)
      *reinterpret_cast<int4*>(s.p + m) = *reinterpret_cast<const int4*>(p + m);
  }
  __syncthreads();
}

// Rows of this block and of this warp. Rows are dealt to blocks first
// (row r to block r mod grid), so blocks differ by at most one row, then
// to the block's warps in turn: the warp's k-th row is
// blockIdx.x + gridDim.x * (warp + WARPS * k).
__device__ __forceinline__ int warp_rows(int rows) {
  const int warp = threadIdx.x >> 5;
  const int grid = static_cast<int>(gridDim.x);
  const int nb = (rows - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  return nb > warp ? (nb - warp + WARPS - 1) / WARPS : 0;
}

__device__ __forceinline__ int warp_row(int k) {
  return static_cast<int>(blockIdx.x) +
         static_cast<int>(gridDim.x) * (static_cast<int>(threadIdx.x >> 5) + WARPS * k);
}

// A warp's tile i is column chunk j of the warp's row k (i = k * ntile
// + j); the ring holds `stages` tiles, and tile i + stages is issued into
// tile i's stage once the warp has folded tile i. This issues chunk j of
// table row `row` into the warp's stage `s`; every lane of the warp
// calls it, and lane 0 arms the stage's barrier and issues the copy.
__device__ __forceinline__ void issue_tile(const StreamSmem& sm, const int* __restrict__ c,
                                           const int* __restrict__ p, int row, int j, int s,
                                           int Mp, int chunk, int stages, bool p_resident) {
  const int warp = threadIdx.x >> 5;
  const int col = j * chunk;
  const int n = min(chunk, Mp - col);
  uint64_t* bar = &sm.bars[warp * stages + s];
  int* dst = sm.ring + static_cast<size_t>(warp * stages + s) * (p_resident ? chunk : 2 * chunk);
  if ((threadIdx.x & 31) == 0) {
    mbar_expect_tx(bar, n * 4 * (p_resident ? 1 : 2));
    bulk_load(dst, c + static_cast<size_t>(row) * Mp + col, n * 4, bar);
    if (!p_resident) bulk_load(dst + chunk, p + col, n * 4, bar);
  }
}

// Lift `kernel`'s dynamic shared-memory cap to the device's per-block
// opt-in maximum, then count the blocks of THREADS threads and `smem`
// dynamic bytes that fit on one SM.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int smem, int* blocks) {
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  return e;
}

// Fold one landed tile into a lane's accumulator: columns [col, col + n)
// of the row, with cs the tile's c and ps p at the same columns (both in
// shared memory). Each lane reads 16-byte vectors, neighbouring lanes
// neighbouring vectors (512 contiguous bytes per warp step: no bank
// conflict). `key(m)` is the tie-break key of column m.
template <bool ordered_keys, class Key>
__device__ __forceinline__ void fold_tile(Top2& acc, const int* cs, const int* ps, int col, int n,
                                          Key key) {
#pragma unroll 4
  for (int x = (threadIdx.x & 31) * 4; x < n; x += LANES * 4) {
    const int4 cv = *reinterpret_cast<const int4*>(cs + x);
    const int4 pv = *reinterpret_cast<const int4*>(ps + x);
    const int m = col + x;
    top2_push<ordered_keys>(acc, min(wrap_add(cv.x, pv.x), INF), key(m));
    top2_push<ordered_keys>(acc, min(wrap_add(cv.y, pv.y), INF), key(m + 1));
    top2_push<ordered_keys>(acc, min(wrap_add(cv.z, pv.z), INF), key(m + 2));
    top2_push<ordered_keys>(acc, min(wrap_add(cv.w, pv.w), INF), key(m + 3));
  }
}

// Phase stamps, a kernel's time by phase on one SM. Only the stamps build
// of a source (kernels/loader.py builds it apart, with -DPHASE_STAMPS)
// takes a buffer and writes clock64() into it; in every other build a
// Stamps is empty and each stamp compiles to nothing.
struct Stamps {
#ifdef PHASE_STAMPS
  static constexpr bool on = true;
  long long* at;
  __device__ __forceinline__ void operator()(int slot, bool me) const {
    if (me) at[slot] = clock64();
  }
  __device__ __forceinline__ void put(int slot, long long v, bool me) const {
    if (me) at[slot] = v;
  }
#else
  static constexpr bool on = false;
  __device__ __forceinline__ void operator()(int, bool) const {}
  __device__ __forceinline__ void put(int, long long, bool) const {}
#endif
};

}  // namespace pt
