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
// to a scratch; `perturb_table` (grid: group blocks x B) gives each thread
// 4 groups of 4 entries of one row of one variant (16-byte loads and
// stores, Mp a multiple of 4). Every variant re-reads c0, w0, dgen0 and
// s, which sit in L2 after the first (16 MiB at config 5), so device
// memory sees c0 about once and the table writes. The hashes are sparse
// (~1 % of the entries at config 5) and scattered over the warps' lanes:
// a thread first writes every entry's generic route into registers and
// marks its preference entries, then the warp hashes them in passes, each
// lane taking one marked entry a pass, so a warp pays its busiest lane's
// count of hashes instead of one per entry slot any lane needs. Each block
// reduces its finite max (warp shuffles, then shared memory) and folds
// 2 * max into cmax[b] with one atomicMax (cmax starts at 1). The int64
// divisions are by the constant 100 and by one scale per call.
#include "common.cuh"

namespace {

constexpr int VEC_THREADS = 256;
constexpr int TABLE_THREADS = 256;
constexpr int PER_THREAD = 4;  // 16-byte groups of one variant a thread writes

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

__device__ __forceinline__ uint64_t bits_mod(Key k, uint64_t n, uint32_t span, uint64_t m32) {
  uint32_t x0 = static_cast<uint32_t>(n >> 32), x1 = static_cast<uint32_t>(n);
  threefry(k.a, k.b, x0, x1);
  // ((x0 << 32) | x1) mod span, from 32-bit halves
  return ((x0 % span) * m32 + (x1 % span)) % span;
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// randint's span and its residues: 2^32 and 2^64 modulo span
struct Span {
  uint32_t span;
  uint64_t m32, mul;
};

__device__ __forceinline__ Span make_span(int pct) {
  const uint32_t span = static_cast<uint32_t>(2 * pct + 1);
  const uint64_t m32 = (1ull << 32) % span;
  return Span{span, m32, (m32 * m32) % span};
}

// J(k, x) at flat index n
__device__ __forceinline__ int jitter(const Draw& d, int x, uint64_t n, int scale, int pct,
                                      const Span& sp) {
  if (x >= pt::INF) return pt::INF;
  const uint64_t hi = bits_mod(d.hi, n, sp.span, sp.m32);
  const uint64_t lo = bits_mod(d.lo, n, sp.span, sp.m32);
  const long long f =
      static_cast<long long>(100 - pct) + static_cast<long long>((hi * sp.mul + lo) % sp.span);
  const long long un = floordiv(x, scale);
  long long y = floordiv(un * f, 100) * scale;
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

__global__ void __launch_bounds__(TABLE_THREADS) perturb_table(
    const int4* __restrict__ c0, const int* __restrict__ w0, const int4* __restrict__ dgen0,
    const int4* __restrict__ s, const int* __restrict__ w, const int4* __restrict__ dg,
    const uint32_t* __restrict__ table_keys, int4* __restrict__ c, int* cmax, int Tp, int Mp,
    int scale, int pct) {
  __shared__ int warp_max[TABLE_THREADS / 32];
  // one variant per grid row; groups of 4 consecutive entries of one
  // row (Mp is a multiple of 4; Tp * Mp / 4 < 2^32, the wrapper checks)
  const int b = blockIdx.y;
  const unsigned G = static_cast<unsigned>(static_cast<uint64_t>(Tp) * Mp / 4);
  const unsigned Mg = static_cast<unsigned>(Mp / 4);
  const unsigned base = blockIdx.x * TABLE_THREADS * PER_THREAD;
  int4* cb = c + static_cast<size_t>(b) * G;
  const int* wb = w + static_cast<size_t>(b) * Tp;
  const int4* db = dg + static_cast<size_t>(b) * Mg;
  int v[4 * PER_THREAD];    // the thread's entries, as written
  int pref[4 * PER_THREAD];  // preference parts still to jitter
  unsigned pending = 0;      // bit e: entry e has a preference part
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const unsigned g = base + k * TABLE_THREADS + threadIdx.x;
    int4 v4 = g < G ? c0[g] : make_int4(pt::INF, pt::INF, pt::INF, pt::INF);
    int* vp = &v4.x;
    if (b != 0 && g < G) {
      const unsigned row = g / Mg;
      const unsigned colg = g - row * Mg;
      const long long w0r = w0[row], wbr = wb[row];
      const int4 d0 = dgen0[colg], d4 = db[colg], s4 = s[colg];
      const int* d0p = &d0.x;
      const int* dp = &d4.x;
      const int* sp4 = &s4.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int x = pt::INF;
        if (sp4[j] > 0) {
          const long long g0 = w0r + d0p[j];
          const int generic = g0 < pt::INF ? static_cast<int>(g0) : pt::INF;
          if (vp[j] < generic) {
            pref[4 * k + j] = vp[j];
            pending |= 1u << (4 * k + j);
          }
          const long long gb = wbr + dp[j];
          x = gb < pt::INF ? static_cast<int>(gb) : pt::INF;
        }
        vp[j] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * k + j] = vp[j];
  }
  // the hashes: every lane with a pending preference part takes one per
  // pass, so a warp runs as many passes as its busiest lane has parts,
  // not one per entry slot that any lane needs
  if (__any_sync(0xffffffffu, pending)) {
    Draw d;
    d.hi = Key{table_keys[4 * b], table_keys[4 * b + 1]};
    d.lo = Key{table_keys[4 * b + 2], table_keys[4 * b + 3]};
    const Span sp = make_span(pct);
    while (__any_sync(0xffffffffu, pending)) {
      if (pending) {
        const int e = __ffs(pending) - 1;
        pending &= pending - 1;
        const unsigned g = base + (e >> 2) * TABLE_THREADS + threadIdx.x;
        const int x = jitter(d, pref[e], 4ull * g + (e & 3), scale, pct, sp);
        v[e] = min(v[e], x);
      }
    }
  }
  int vmax = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const unsigned g = base + k * TABLE_THREADS + threadIdx.x;
    if (g < G) cb[g] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (v[4 * k + j] < pt::INF) vmax = max(vmax, v[4 * k + j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vmax = max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = vmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
#pragma unroll
    for (int i = 0; i < TABLE_THREADS / 32; ++i) m = max(m, warp_max[i]);
    if (2 * m > 1) atomicMax(&cmax[b], 2 * m);
  }
}

}  // namespace

extern "C" int perturb_launch(const int* c0, const int* u0, const int* w0, const int* dgen0,
                              const int* s, int* c, int* u, int* w, int* dg, int* cmax,
                              uint32_t* table_keys, int B, int Tp, int Mp, int scale, int seed,
                              int pct, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_vec = Tp > Mp ? Tp : Mp;
  dim3 vgrid((n_vec + VEC_THREADS - 1) / VEC_THREADS, B);
  perturb_vectors<<<vgrid, VEC_THREADS, 0, st>>>(u0, w0, dgen0, u, w, dg, cmax, table_keys, Tp,
                                                  Mp, scale, seed, pct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t G = static_cast<uint64_t>(Tp) * Mp / 4;
  const uint64_t per_block = static_cast<uint64_t>(TABLE_THREADS) * PER_THREAD;
  dim3 tgrid(static_cast<unsigned>((G + per_block - 1) / per_block), B);
  perturb_table<<<tgrid, TABLE_THREADS, 0, st>>>(
      reinterpret_cast<const int4*>(c0), w0, reinterpret_cast<const int4*>(dgen0),
      reinterpret_cast<const int4*>(s), w, reinterpret_cast<const int4*>(dg), table_keys,
      reinterpret_cast<int4*>(c), cmax, Tp, Mp, scale, pct);
  return static_cast<int>(cudaGetLastError());
}
