// K8 gap_rows: the table pass of the sharded exactness certificate.
//
// Replaces: poseidon_tpu/parallel/sharded.py:183-214 (`_gap_kernel`, the
// per-shard body that `sharded_certificate_gap` runs under `shard_map`),
// and the certificate at the end of `_solve` whenever a row-block mesh is
// set. For one shard's rows of the dense table c[rows, Mp], with
//   lam_inf[m] = s[m] > 0 ? lam[m] : INF,
// each row t computes
//   b1       = min(min_m min(c[t,m] + lam_inf[m], INF), u[t])
//   c_asg    = c[t, clamp(asg[t], 0, Mp - 1)]
//   per_task = on_machine ? c_asg : (asg[t] == Mp ? u[t] : INF)
// (on_machine = 0 <= asg[t] < Mp), both zeroed where !task_valid[t], and
// the kernel adds  sum(per_task)  and  sum(b1)  into out[0] and out[1]
// (int64, zeroed by the caller). c <= INF and lam <= INF, so the int32
// sum c + lam_inf stays below 2^31; the adds go through wrap_add anyway,
// so any input wraps as PyTorch's int32 does, and the min with INF comes
// before the row min, in the reference's order.
//
// Bound: bytes. The table is read once (rows * Mp * 4 bytes); the vectors
// (u, task_valid, asg: 9 bytes a row; s, lam: 8 bytes a column) are noise.
// At config 8 (524,288 x 128) that is 256 MiB, ~80 us at 3.35 TB/s.
//
// Design: the simple one. A grid-stride loop of warps over the rows; each
// lane sweeps its row with 16-byte vectors (Mp is a multiple of 4) and
// reads s and lam through the read-only cache. A warp's min goes through
// shuffles; lane 0 adds the row's two terms to its running int64 sums.
// The block reduces its warps' sums in shared memory and thread 0 makes
// one 64-bit atomic add per sum, so the atomics number two per block, not
// two per row. A narrow Mp (128) leaves each lane one vector per row; the
// grid-stride loop keeps every warp busy across rows instead.
#include "common.cuh"

namespace {

constexpr int GAP_THREADS = 256;
constexpr int GAP_WARPS = GAP_THREADS / 32;

__device__ __forceinline__ int lam_inf_at(const int* __restrict__ s,
                                          const int* __restrict__ lam, int m) {
  return __ldg(&s[m]) > 0 ? __ldg(&lam[m]) : pt::INF;
}

__device__ __forceinline__ int capped(int c, int l) {
  return min(pt::wrap_add(c, l), pt::INF);
}

__global__ void __launch_bounds__(GAP_THREADS) gap_rows_kernel(
    const int* __restrict__ c, const int* __restrict__ u,
    const unsigned char* __restrict__ task_valid, const int* __restrict__ s,
    const int* __restrict__ lam, const int* __restrict__ asg, int rows, int Mp,
    unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warps_total = static_cast<long long>(gridDim.x) * GAP_WARPS;
  long long primal = 0;
  long long b1_sum = 0;
  const int vecs = Mp >> 2;
  for (long long t = static_cast<long long>(blockIdx.x) * GAP_WARPS + warp; t < rows;
       t += warps_total) {
    const int* row = c + t * static_cast<long long>(Mp);
    const int4* row4 = reinterpret_cast<const int4*>(row);
    int best = pt::INF;
    for (int j = lane; j < vecs; j += 32) {
      const int4 v = __ldcs(&row4[j]);
      const int m = j << 2;
      best = min(best, capped(v.x, lam_inf_at(s, lam, m)));
      best = min(best, capped(v.y, lam_inf_at(s, lam, m + 1)));
      best = min(best, capped(v.z, lam_inf_at(s, lam, m + 2)));
      best = min(best, capped(v.w, lam_inf_at(s, lam, m + 3)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      best = min(best, __shfl_down_sync(0xffffffffu, best, off));
    }
    if (lane == 0 && task_valid[t] != 0) {
      const int ut = u[t];
      const int a = asg[t];
      int per;
      if (a >= 0 && a < Mp) {
        per = row[a];
      } else {
        per = a == Mp ? ut : pt::INF;
      }
      primal += per;
      b1_sum += min(best, ut);
    }
  }
  __shared__ long long sp[GAP_WARPS];
  __shared__ long long sb[GAP_WARPS];
  if (lane == 0) {
    sp[warp] = primal;
    sb[warp] = b1_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long p = 0;
    long long b = 0;
    for (int w = 0; w < GAP_WARPS; ++w) {
      p += sp[w];
      b += sb[w];
    }
    atomicAdd(&out[0], static_cast<unsigned long long>(p));
    atomicAdd(&out[1], static_cast<unsigned long long>(b));
  }
}

}  // namespace

extern "C" int gap_rows_launch(const int* c, const int* u, const unsigned char* task_valid,
                               const int* s, const int* lam, const int* asg, int rows, int Mp,
                               int grid, void* out, void* stream) {
  if (rows > 0) {
    gap_rows_kernel<<<grid, GAP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        c, u, task_valid, s, lam, asg, rows, Mp, static_cast<unsigned long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
