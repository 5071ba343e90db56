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
// 16-byte chunks a lane loads before it folds any of them (a 1024-column
// row is 8 chunks per lane: all of a row's loads are in flight at once)
constexpr int BATCH = 8;
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

__device__ __forceinline__ void top2_push(Top2& a, int v, int k) {
  if (v < a.v || (v == a.v && k < a.k)) {
    a.v2 = min(a.v2, a.v);
    a.v = v;
    a.k = k;
  } else {
    a.v2 = min(a.v2, v);
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

}  // namespace pt
