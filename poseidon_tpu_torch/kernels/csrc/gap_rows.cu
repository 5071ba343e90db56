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
// At config 8 (524,288 x 256) that is 512 MiB, ~160 us at 3.35 TB/s; at
// the flagship (10,240 x 1,024) 40 MiB, ~12.5 us.
//
// Design: one wave of warps, each over an equal run of whole rows. The
// host's plan (kernels/gap_rows.py `plan`) deals `rows_per_warp` rows to
// every warp, so that all warps of the grid fit on the card at once
// (occupancy x SMs) and none takes a second turn: at 10,240 rows the old
// grid-stride loop gave 1,792 of 8,448 warps a second row, a tail wave
// at ~21 % occupancy. A block first stages lam_inf in shared memory as
// int4 (Mp <= STAGE_MAX; 4 KiB at Mp 1,024), so a lane reads the four
// prices beside each 16-byte vector of c with one conflict-free vector
// load, where the old loop made eight dependent scalar loads of s and lam
// (two of L1's wavefronts a column, more than c's own). Above STAGE_MAX
// the lanes read s and lam as int4 through the read-only cache. A lane
// issues UNROLL 16-byte loads before it folds any of them: of one row, or
// of R rows at once where a row has too few vectors to fill them (R = 2
// at config 8's Mp 256, 4 at Mp <= 128; a template argument the plan
// picks), so a narrow table keeps as many bytes in flight as a wide one.
// (UNROLL 8, a whole row at Mp 1,024, took 70 registers, 3 blocks an SM,
// and was slower on the H100 at both the flagship and config 8.)
// Every lane loads the row's asg, u and task_valid (one broadcast each)
// with its vectors; the lane whose vector holds c[t, asg[t]] keeps it,
// and a shuffle hands it to lane 0, so no load waits on another. A
// warp's min goes through shuffles; lane 0 adds the row's two terms to
// its int64 sums; the block reduces its warps' sums in shared memory and
// thread 0 makes one 64-bit atomic add per sum.
#include "common.cuh"

namespace {

constexpr int GAP_THREADS = pt::THREADS;
constexpr int GAP_WARPS = GAP_THREADS / 32;
constexpr int UNROLL = 4;
// columns staged in shared memory (32 KiB: with the block's static sums
// still under the 48 KiB that need no opt-in); the plan in
// kernels/gap_rows.py names the same number
constexpr int STAGE_MAX = 8192;

__device__ __forceinline__ int capped(int c, int l) {
  return min(pt::wrap_add(c, l), pt::INF);
}

__device__ __forceinline__ int4 lam_inf4(const int4 s, const int4 l) {
  return make_int4(s.x > 0 ? l.x : pt::INF, s.y > 0 ? l.y : pt::INF,
                   s.z > 0 ? l.z : pt::INF, s.w > 0 ? l.w : pt::INF);
}

__device__ __forceinline__ int pick(const int4 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

template <int R>
__global__ void __launch_bounds__(GAP_THREADS) gap_rows_kernel(
    const int* __restrict__ c, const int* __restrict__ u,
    const unsigned char* __restrict__ task_valid, const int* __restrict__ s,
    const int* __restrict__ lam, const int* __restrict__ asg, int rows, int Mp,
    int rows_per_warp, int stage, unsigned long long* __restrict__ out) {
  constexpr int PER_ROW = UNROLL / R;  // a lane's loads of one row at once
  extern __shared__ int4 lam_s[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vecs = Mp >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(s);
  const int4* lam4 = reinterpret_cast<const int4*>(lam);
  if (stage) {
    for (int j = threadIdx.x; j < vecs; j += GAP_THREADS) {
      lam_s[j] = lam_inf4(__ldg(&s4[j]), __ldg(&lam4[j]));
    }
    __syncthreads();
  }
  long long primal = 0;
  long long b1_sum = 0;
  const long long first =
      (static_cast<long long>(blockIdx.x) * GAP_WARPS + warp) * rows_per_warp;
  const long long last = min(first + rows_per_warp, static_cast<long long>(rows));
  for (long long t0 = first; t0 < last; t0 += R) {
    int a[R], ut[R], best[R], mine[R];
    bool valid[R];
    const int4* row4[R];
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const long long t = min(t0 + g, last - 1);  // a short group repeats its last row
      a[g] = asg[t];
      ut[g] = u[t];
      valid[g] = t0 + g < last && task_valid[t] != 0;
      row4[g] = reinterpret_cast<const int4*>(c + t * static_cast<long long>(Mp));
      best[g] = pt::INF;
      mine[g] = 0;
    }
    for (int j0 = lane; j0 < vecs; j0 += 32 * PER_ROW) {
      int4 v[UNROLL];
#pragma unroll
      for (int g = 0; g < R; ++g) {
#pragma unroll
        for (int q = 0; q < PER_ROW; ++q) {
          const int j = j0 + 32 * q;
          if (j < vecs) v[g * PER_ROW + q] = __ldcs(&row4[g][j]);
        }
      }
#pragma unroll
      for (int q = 0; q < PER_ROW; ++q) {
        const int j = j0 + 32 * q;
        if (j < vecs) {
          const int4 l = stage ? lam_s[j] : lam_inf4(__ldg(&s4[j]), __ldg(&lam4[j]));
#pragma unroll
          for (int g = 0; g < R; ++g) {
            const int4 x = v[g * PER_ROW + q];
            int b = best[g];
            b = min(b, capped(x.x, l.x));
            b = min(b, capped(x.y, l.y));
            b = min(b, capped(x.z, l.z));
            b = min(b, capped(x.w, l.w));
            best[g] = b;
            if (j == a[g] >> 2) mine[g] = pick(x, a[g] & 3);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < R; ++g) {
      int b = best[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        b = min(b, __shfl_down_sync(0xffffffffu, b, off));
      }
      // a in [0, Mp) lies in vector a >> 2, which lane (a >> 2) % 32 read
      const int c_asg = __shfl_sync(0xffffffffu, mine[g], (a[g] >> 2) & 31);
      if (lane == 0 && valid[g]) {
        int per;
        if (a[g] >= 0 && a[g] < Mp) {
          per = c_asg;
        } else {
          per = a[g] == Mp ? ut[g] : pt::INF;
        }
        primal += per;
        b1_sum += min(b, ut[g]);
      }
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

template <int R>
cudaError_t launch(const int* c, const int* u, const unsigned char* task_valid, const int* s,
                   const int* lam, const int* asg, int rows, int Mp, int grid,
                   int rows_per_warp, int smem, void* out, cudaStream_t stream) {
  gap_rows_kernel<R><<<grid, GAP_THREADS, smem, stream>>>(
      c, u, task_valid, s, lam, asg, rows, Mp, rows_per_warp, smem > 0,
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

template <int R>
cudaError_t occupancy(int smem, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gap_rows_kernel<R>, GAP_THREADS,
                                                       smem);
}

}  // namespace

// rows_at_once: R of the kernel (1, 2 or 4), the plan's pick
extern "C" int gap_rows_launch(const int* c, const int* u, const unsigned char* task_valid,
                               const int* s, const int* lam, const int* asg, int rows, int Mp,
                               int grid, int rows_per_warp, int rows_at_once, int smem,
                               void* out, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (rows_at_once == 1) {
    e = launch<1>(c, u, task_valid, s, lam, asg, rows, Mp, grid, rows_per_warp, smem, out, st);
  } else if (rows_at_once == 2) {
    e = launch<2>(c, u, task_valid, s, lam, asg, rows, Mp, grid, rows_per_warp, smem, out, st);
  } else if (rows_at_once == 4) {
    e = launch<4>(c, u, task_valid, s, lam, asg, rows, Mp, grid, rows_per_warp, smem, out, st);
  }
  return static_cast<int>(e);
}

// the staged prices stay within the 48 KiB a block may use without an
// opt-in, so unlike pt::occupancy this lifts no shared-memory cap (which
// the static sums would push past the opt-in limit)
extern "C" int gap_rows_occupancy(int rows_at_once, int smem, int* blocks) {
  switch (rows_at_once) {
    case 1: return static_cast<int>(occupancy<1>(smem, blocks));
    case 2: return static_cast<int>(occupancy<2>(smem, blocks));
    case 4: return static_cast<int>(occupancy<4>(smem, blocks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
