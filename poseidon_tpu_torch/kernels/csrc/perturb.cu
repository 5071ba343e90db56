// K6 perturb: the what-if batch's B jittered variants of one dense
// instance, with the reference's random bits.
//
// Replaces: poseidon_tpu/ops/batch.py:100 `_perturb_kernel` (one vmapped
// XLA program on the TPU, int64 under `enable_x64`). For variant b >= 1,
// with keys kb = threefry(key(seed), (0, b)) and k_i = threefry(kb, (0, i))
// (jax's fold_in and its partitionable split):
//   w_b = J(k_0, w0), d_b = J(k_1, dgen0), u_b = J(k_3, u0),
//   c_b[t, m] = s[m] > 0 ? min(min(w_b[t] + d_b[m], INF), J(k_2, pp)[t, m]) : INF,
//   pp[t, m]  = c0 < min(w0[t] + dgen0[m], INF) ? c0 : INF,
// where J(k, x)[n] = x[n] < INF ? clip(floor(floor(x / scale) * f / 100) * scale,
// 0, INF - 1) : INF and f = randint(k, [100 - pct, 101 + pct)) at the flat
// index n, drawn as jax draws an int64 (`randint` under x64): two subkeys
// threefry(k, (0, 0)) and threefry(k, (0, 1)) each hash the counter
// (n >> 32, n & 0xffffffff) into 64 bits, and the offset is
// (hi mod span * (2^64 mod span) + lo mod span) mod span. Variant 0 is the
// unperturbed input. cmax[b] = max(2 * max finite c_b, 1).
//
// Bound: at BASELINE config 5 (B 64, Tp 4096, Mp 1024) the kernel writes
// 1 GiB of c and reads 16 MiB: 0.33 ms at 3.35 TB/s. The hash is ~80 int32
// operations a threefry evaluation, two per hashed entry; an entry whose
// pp is INF comes out INF whatever its bits (its bits depend only on the
// key and n), so only the preference entries are hashed, and the write is
// the bound.
//
// Design: two kernels on one stream. `perturb_vectors` (grid: index
// blocks x B) jitters w, dgen and u and writes the variant's table subkeys
// to a scratch. `perturb_table` gives each block one tile of the table,
// `tile_rows` rows x `4 * cgw` columns (the plan of kernels/perturb.py:
// powers of two, a row of the tile one warp's 512 contiguous bytes at
// Mp >= 128), and loops over the variants inside: it reads its c0, w0,
// dgen0 and s once and finds what no variant changes: in each thread's 4
// 16-byte groups (one column group, 4 rows) the preference entries (c0 <
// min(w0 + dgen0, INF) on a seated column, s > 0), which go with their c0
// into a list per warp in shared memory. It writes variant 0 (c0 itself)
// first. For the other variants it stages, a chunk of variants at a time,
// each variant's w over the tile's rows, dg over its columns (INF on
// unseated columns) and table subkeys in shared memory, so a variant
// costs each entry an add and a min, and a 16-byte streaming store
// (`__stcs`: the table is written once and read by the next launch, so
// it should not displace c0's and the vectors' lines in L2; each warp's
// store already covers whole 128-byte lines, so a staging tile for bulk
// copies would only add a shared-memory round trip and a barrier a
// variant). Only preference entries are hashed (~1 % of the entries at
// config 5, a few a warp): the warp hashes its list for a batch of
// variants at once, 32 (variant, entry) pairs a pass over all its lanes,
// into shared memory, and each lane takes its own entries' values from
// there; so the hash passes a warp pays are its entries x variants / 32,
// not one pass a variant for its busiest lane. The per-entry arrays are
// indexed only by unrolled constants, so they stay in registers. A
// variant's finite max is reduced by warp shuffles and shared atomics
// over the block, then folded into cmax[b] with one atomicMax a block
// and variant (cmax starts at 1). The randint residues are combined in
// 64 bits (a span past 65,535 overflows 32); the floor divisions by
// scale are 32-bit, by 100 a constant.
#include "common.cuh"

namespace {

constexpr int VEC_THREADS = 256;
constexpr int TABLE_THREADS = 256;  // kernels/perturb.py TABLE_THREADS
constexpr int TABLE_WARPS = TABLE_THREADS / 32;
constexpr int GROUPS = 4;           // 16-byte groups a thread holds, one column group
constexpr int ENTRIES = 4 * GROUPS;
constexpr int WARP_ENTRIES = 32 * ENTRIES;  // a warp's entries of a tile: its most preference entries

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define PT_TF_ROUND(r) \
  x0 += x1;            \
  x1 = __funnelshift_l(x1, x1, r); \
  x1 ^= x0;
#define PT_TF_GROUP_A PT_TF_ROUND(13) PT_TF_ROUND(15) PT_TF_ROUND(26) PT_TF_ROUND(6)
#define PT_TF_GROUP_B PT_TF_ROUND(17) PT_TF_ROUND(29) PT_TF_ROUND(16) PT_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  PT_TF_GROUP_A
  x0 += k1;
  x1 += k2 + 1u;
  PT_TF_GROUP_B
  x0 += k2;
  x1 += k0 + 2u;
  PT_TF_GROUP_A
  x0 += k0;
  x1 += k1 + 3u;
  PT_TF_GROUP_B
  x0 += k1;
  x1 += k2 + 4u;
  PT_TF_GROUP_A
  x0 += k2;
  x1 += k0 + 5u;
#undef PT_TF_GROUP_B
#undef PT_TF_GROUP_A
#undef PT_TF_ROUND
}

struct Key {
  uint32_t a, b;
};

// threefry(k, (0, i)): fold_in(k, i) and entry i of split(k, n)
__device__ __forceinline__ Key derive(Key k, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry(k.a, k.b, x0, x1);
  return Key{x0, x1};
}

// The two subkeys of one randint draw, and the per-span constants.
struct Draw {
  Key hi, lo;
};

__device__ __forceinline__ Draw draw_keys(Key k) { return Draw{derive(k, 0u), derive(k, 1u)}; }

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ long long floordiv100(long long a) {
  long long q = a / 100;
  if ((a % 100 != 0) && (a < 0)) --q;
  return q;
}

// randint's span and its residues: 2^32 and 2^64 modulo span
struct Span {
  uint32_t span, m32, mul;
};

__device__ __forceinline__ Span make_span(int pct) {
  const uint32_t span = static_cast<uint32_t>(2 * pct + 1);
  const uint64_t m32 = (1ull << 32) % span;
  return Span{span, static_cast<uint32_t>(m32), static_cast<uint32_t>((m32 * m32) % span)};
}

// ((x0 << 32) | x1) mod span from the hashed halves
__device__ __forceinline__ uint32_t bits_mod(Key k, uint64_t n, const Span& sp) {
  uint32_t x0 = static_cast<uint32_t>(n >> 32), x1 = static_cast<uint32_t>(n);
  threefry(k.a, k.b, x0, x1);
  return static_cast<uint32_t>(
      (static_cast<uint64_t>(x0 % sp.span) * sp.m32 + x1 % sp.span) % sp.span);
}

// J(k, x) at flat index n
__device__ __forceinline__ int jitter(const Draw& d, int x, uint64_t n, int scale, int pct,
                                      const Span& sp) {
  if (x >= pt::INF) return pt::INF;
  const uint32_t hi = bits_mod(d.hi, n, sp);
  const uint32_t lo = bits_mod(d.lo, n, sp);
  const uint32_t off =
      static_cast<uint32_t>((static_cast<uint64_t>(hi) * sp.mul + lo) % sp.span);
  const long long f = static_cast<long long>(100 - pct) + off;
  long long y = floordiv100(static_cast<long long>(floordiv(x, scale)) * f) * scale;
  y = y < 0 ? 0 : y;
  y = y > pt::INF - 1 ? pt::INF - 1 : y;
  return static_cast<int>(y);
}

__device__ __forceinline__ Key variant_key(int seed, int b) {
  return derive(Key{0u, static_cast<uint32_t>(seed)}, static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(VEC_THREADS) perturb_vectors(
    const int* __restrict__ u0, const int* __restrict__ w0, const int* __restrict__ dgen0,
    int* __restrict__ u, int* __restrict__ w, int* __restrict__ dg, int* __restrict__ cmax,
    uint32_t* __restrict__ table_keys, int Tp, int Mp, int scale, int seed, int pct) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * VEC_THREADS + threadIdx.x;
  if (b == 0) {
    if (i < Tp) {
      w[i] = w0[i];
      u[i] = u0[i];
    }
    if (i < Mp) dg[i] = dgen0[i];
    if (i == 0) cmax[0] = 1;
    return;
  }
  const Key kb = variant_key(seed, b);
  const Span sp = make_span(pct);
  if (i < Tp) {
    w[static_cast<size_t>(b) * Tp + i] =
        jitter(draw_keys(derive(kb, 0u)), w0[i], i, scale, pct, sp);
    u[static_cast<size_t>(b) * Tp + i] =
        jitter(draw_keys(derive(kb, 3u)), u0[i], i, scale, pct, sp);
  }
  if (i < Mp) {
    dg[static_cast<size_t>(b) * Mp + i] =
        jitter(draw_keys(derive(kb, 1u)), dgen0[i], i, scale, pct, sp);
  }
  if (i == 0) {
    cmax[b] = 1;
    const Draw d = draw_keys(derive(kb, 2u));
    uint32_t* k = table_keys + 4 * static_cast<size_t>(b);
    k[0] = d.hi.a;
    k[1] = d.hi.b;
    k[2] = d.lo.a;
    k[3] = d.lo.b;
  }
}

// Dynamic shared memory of a block (kernels/perturb.py `table_plan`
// sizes it): first each warp's preference list, WARP_ENTRIES slots each
// of c0 (int), the jittered values of a batch of variants (int) and the
// slot's lane and entry (uint16: lane << 4 | entry); then, for a chunk of
// `chunk` variants, w over the tile's rows (chunk x tile_rows ints), dg
// over its columns, INF on unseated columns (chunk x tile_cols), the
// table subkeys (chunk x 4) and the running finite max (chunk).
__global__ void __launch_bounds__(TABLE_THREADS, 3) perturb_table(
    const int4* __restrict__ c0, const int* __restrict__ w0, const int4* __restrict__ dgen0,
    const int4* __restrict__ s, const int* __restrict__ w, const int* __restrict__ dg,
    const uint32_t* __restrict__ table_keys, int4* __restrict__ c, int* cmax, int B, int Tp,
    int Mp, int scale, int pct, int cgw, int tile_rows, int col_tiles, int chunk) {
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* base = reinterpret_cast<int*>(smem4);
  int* h_pp = base + warp * WARP_ENTRIES;
  int* h_res = base + (TABLE_WARPS + warp) * WARP_ENTRIES;
  uint16_t* h_id =
      reinterpret_cast<uint16_t*>(base + 2 * TABLE_WARPS * WARP_ENTRIES) + warp * WARP_ENTRIES;
  const int tile_cols = 4 * cgw;
  int* s_w = base + 2 * TABLE_WARPS * WARP_ENTRIES + TABLE_WARPS * WARP_ENTRIES / 2;
  int* s_dg = s_w + chunk * tile_rows;
  uint32_t* s_key = reinterpret_cast<uint32_t*>(s_dg + chunk * tile_cols);
  int* s_max = reinterpret_cast<int*>(s_key + 4 * chunk);

  const int Mg = Mp / 4;
  const size_t G = static_cast<size_t>(Tp) * Mg;
  const int cgw_shift = __ffs(cgw) - 1;             // cgw, tile_rows: powers of two
  const int rows_shift = __ffs(tile_rows) - 1;
  const int cols_shift = cgw_shift + 2;
  const int rpp = TABLE_THREADS >> cgw_shift;       // rows of one pass of the block
  const int row0 = (static_cast<int>(blockIdx.x) / col_tiles) * tile_rows;
  const int g0 = (static_cast<int>(blockIdx.x) % col_tiles) * cgw;
  const int lane_row = threadIdx.x >> cgw_shift;
  const int cg = g0 + (threadIdx.x & (cgw - 1));    // this thread's column group
  const bool col_ok = cg < Mg;

  // what no variant changes: which entries are preference entries and
  // their c0; variant 0 (c0 itself) is written as it is read
  int seated = 0;                                   // bit j: column 4 cg + j has s > 0
  int4 d04 = make_int4(0, 0, 0, 0);
  if (col_ok) {
    const int4 s4 = s[cg];
    seated = (s4.x > 0) | (s4.y > 0) << 1 | (s4.z > 0) << 2 | (s4.w > 0) << 3;
    d04 = dgen0[cg];
  }
  const int* d0p = &d04.x;
  int pp[ENTRIES];
  unsigned prefs = 0;                               // bit e: entry e is a preference entry
  int vmax = 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const int row = row0 + lane_row + k * rpp;
    int4 v4 = make_int4(pt::INF, pt::INF, pt::INF, pt::INF);
    if (col_ok && row < Tp) {
      const size_t g = static_cast<size_t>(row) * Mg + cg;
      v4 = c0[g];
      __stcs(c + g, v4);
      const long long w0r = w0[row];
      const int* vp = &v4.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long g0l = w0r + d0p[j];
        const int generic = g0l < pt::INF ? static_cast<int>(g0l) : pt::INF;
        if ((seated >> j & 1) && vp[j] < generic) prefs |= 1u << (4 * k + j);
        if (vp[j] < pt::INF) vmax = max(vmax, vp[j]);
      }
    }
    pp[4 * k] = v4.x;
    pp[4 * k + 1] = v4.y;
    pp[4 * k + 2] = v4.z;
    pp[4 * k + 3] = v4.w;
  }
  // the warp's preference list: lane l's entries at [off, off + cnt)
  const int cnt = __popc(prefs);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int off = incl - cnt;
  const int pw = __shfl_sync(0xffffffffu, incl, 31);
  {
    int r = off;
#pragma unroll
    for (int i = 0; i < ENTRIES; ++i) {
      if (prefs >> i & 1) {
        h_pp[r] = pp[i];
        h_id[r] = static_cast<uint16_t>(lane << 4 | i);
        ++r;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vmax = max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  if (threadIdx.x == 0) s_max[0] = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_max[0], vmax);
  __syncthreads();
  if (threadIdx.x == 0 && 2 * s_max[0] > 1) atomicMax(&cmax[0], 2 * s_max[0]);

  size_t out[GROUPS];                               // this thread's groups in one variant
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const int row = row0 + lane_row + k * rpp;
    out[k] = col_ok && row < Tp ? static_cast<size_t>(row) * Mg + cg : ~size_t(0);
  }
  const Span sp = make_span(pct);
  const int* s_seat = reinterpret_cast<const int*>(s);
  for (int b0 = 1; b0 < B; b0 += chunk) {
    const int n = min(chunk, B - b0);
    __syncthreads();  // the last chunk's reads of the stage are done
    for (int i = threadIdx.x; i < n * tile_rows; i += TABLE_THREADS) {
      const int row = row0 + (i & (tile_rows - 1));
      s_w[i] = row < Tp ? w[static_cast<size_t>(b0 + (i >> rows_shift)) * Tp + row] : pt::INF;
    }
    for (int i = threadIdx.x; i < n * tile_cols; i += TABLE_THREADS) {
      const int col = 4 * g0 + (i & (tile_cols - 1));
      s_dg[i] = col < Mp && s_seat[col] > 0
                    ? dg[static_cast<size_t>(b0 + (i >> cols_shift)) * Mp + col]
                    : pt::INF;
    }
    for (int i = threadIdx.x; i < 4 * n; i += TABLE_THREADS) s_key[i] = table_keys[4 * b0 + i];
    for (int i = threadIdx.x; i < n; i += TABLE_THREADS) s_max[i] = 0;
    __syncthreads();
    int hb_base = 0, hb_end = 0;  // the variants whose hashes h_res holds
    for (int bi = 0; bi < n; ++bi) {
      if (pw > 0 && bi == hb_end) {
        // the hashes of a batch of variants, 32 preference entries a
        // pass over the whole warp
        const int nsub = min(n - bi, max(1, WARP_ENTRIES / pw));
        const int items = nsub * pw;
        __syncwarp();  // the last batch's values are read
        for (int j = lane; j < items; j += 32) {
          const int vi = j / pw;
          const int p = j - vi * pw;
          const int id = h_id[p];
          const int e = id & 15;
          const int t = warp << 5 | id >> 4;
          const int row = row0 + (t >> cgw_shift) + (e >> 2) * rpp;
          const int col = 4 * (g0 + (t & (cgw - 1))) + (e & 3);
          const uint32_t* kp = s_key + 4 * (bi + vi);
          Draw d;
          d.hi = Key{kp[0], kp[1]};
          d.lo = Key{kp[2], kp[3]};
          h_res[j] = jitter(d, h_pp[p], static_cast<uint64_t>(row) * Mp + col, scale, pct, sp);
        }
        __syncwarp();
        hb_base = bi;
        hb_end = bi + nsub;
      }
      const int4 db4 = *reinterpret_cast<const int4*>(s_dg + bi * tile_cols + 4 * (cg - g0));
      const int* dbp = &db4.x;
      int v[ENTRIES];
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        const int wb = s_w[bi * tile_rows + lane_row + k * rpp];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * k + j] = min(wb + dbp[j], pt::INF);
      }
      if (cnt) {
        const int* rp = h_res + (bi - hb_base) * pw + off;
        unsigned pending = prefs;
        for (int r = 0; pending; ++r) {
          const int e = __ffs(pending) - 1;
          pending &= pending - 1;
          const int x = rp[r];
#pragma unroll
          for (int i = 0; i < ENTRIES; ++i) v[i] = i == e ? min(v[i], x) : v[i];
        }
      }
      int bmax = 0;
      int4* cb = c + static_cast<size_t>(b0 + bi) * G;
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        if (out[k] != ~size_t(0))
          __stcs(cb + out[k], make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v[4 * k + j] < pt::INF) bmax = max(bmax, v[4 * k + j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bmax = max(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      if (lane == 0 && bmax > 0) atomicMax(&s_max[bi], bmax);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += TABLE_THREADS)
      if (2 * s_max[i] > 1) atomicMax(&cmax[b0 + i], 2 * s_max[i]);
  }
}

}  // namespace

extern "C" int perturb_launch(const int* c0, const int* u0, const int* w0, const int* dgen0,
                              const int* s, int* c, int* u, int* w, int* dg, int* cmax,
                              uint32_t* table_keys, int B, int Tp, int Mp, int scale, int seed,
                              int pct, int cgw, int tile_rows, int col_tiles, int chunk,
                              int smem, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_vec = Tp > Mp ? Tp : Mp;
  dim3 vgrid((n_vec + VEC_THREADS - 1) / VEC_THREADS, B);
  perturb_vectors<<<vgrid, VEC_THREADS, 0, st>>>(u0, w0, dgen0, u, w, dg, cmax, table_keys, Tp,
                                                  Mp, scale, seed, pct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(perturb_table, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  perturb_table<<<grid, TABLE_THREADS, smem, st>>>(
      reinterpret_cast<const int4*>(c0), w0, reinterpret_cast<const int4*>(dgen0),
      reinterpret_cast<const int4*>(s), w, dg, table_keys, reinterpret_cast<int4*>(c), cmax, B,
      Tp, Mp, scale, pct, cgw, tile_rows, col_tiles, chunk);
  return static_cast<int>(cudaGetLastError());
}
