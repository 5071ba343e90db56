// K1 densify: the dense [Tp, Mp] int32 cost table of the auction.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:311 `_densify` (the XLA
// fusion that built c on the TPU). For each cell,
//   c[t, m] = min(w[t] + d[m], INF,
//                 pc[t, k]          where pm[t, k] == m,
//                 pc[t, k] + ra[m]  where pr[t, k] == rack_of[m])
// over the n_prefs live preference columns (of Pw), and INF where
// slots[m] <= 0. A preference index of -1 never hits.
//
// Bound: bytes. The pass writes Tp*Mp*4 B (41,943,040 B at the flagship
// Tp = 10240, Mp = 1024) and reads ~0.3 MB of channel vectors; it does a
// few integer operations per byte written, far below the card's
// compute roof. At 3.35 TB/s the write alone takes 12.5 us.
//
// Design: a persistent tile writer. The wrapper sizes the grid to the
// card (blocks per SM from an occupancy query x SM count, cached per
// device and shape, kernels/tile_stream.py) and each block walks work
// items of one row tile x one column chunk with a grid stride, so the
// card pays one block prologue, not one per wave. A thread owns 4
// adjacent columns of the chunk and stores each row's 4 values as one
// 16-byte vector (a warp: 512 contiguous bytes); when Mp is narrower
// than 1024 columns the chunk is the least power of two that holds it
// and the block's threads cover several rows at once, so every thread
// stores. The column vectors (d, ra, rack_of, slots) are loaded into
// registers once per block and chunk, the first chunk's while the
// stages are set up. Each tile's task-side inputs (w and its pc/pm/pr
// rows, contiguous runs of the row-major arrays) come into a ring of
// 2-4 shared-memory stages by 1-D bulk copies on one mbarrier per
// stage, issued by thread 0 `stages` items ahead, so the next tiles'
// inputs are in flight while a tile is stored; every thread of a row
// reads the same shared word (a broadcast). A tile that ends past Tp is
// read from global memory instead, so no copy reads past a tensor. The
// fold does little per cell: w + d capped at INF, then a max with INF
// where slots <= 0 (precomputed per column); a preference touches one
// column (pm) or the columns of one rack (pr), so a thread tests each
// preference once per row and branches past a miss (at Mp >= 1024 a
// pass is one row, so the branch is warp-uniform). n_prefs 0..4 are
// template instantiations (the preference loop unrolls); larger values
// run the same kernel with a runtime loop. Stores are plain st.global,
// write-back: c is read next by K2 or the auction and fits in the 50 MB
// L2. (Writing each tile through shared memory and one bulk store per
// row measured slower; PERF.md.)
#include <climits>

#include "common.cuh"

namespace {

constexpr int ROWS_PER_THREAD = 4;  // rows of a tile per thread (tile_stream.py)
constexpr int NP_UNROLLED = 4;      // n_prefs 0..NP_UNROLLED are instantiated

// A tile's task-side inputs: row r of the tile is w[r], preference k of
// it pc/pm/pr[r * Pw + k]; in a shared-memory stage or in global memory.
struct TileIn {
  const int* w;
  const int* pc;
  const int* pm;
  const int* pr;
};

template <int NP>
__global__ void __launch_bounds__(pt::THREADS, 4) densify_kernel(
    const int* __restrict__ w, const int* __restrict__ d, const int* __restrict__ ra,
    const int* __restrict__ rack_of, const int* __restrict__ slots, const int* __restrict__ pc,
    const int* __restrict__ pm, const int* __restrict__ pr, int* __restrict__ c, int Tp, int Mp,
    int n_prefs, int Pw, int cols, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = NP >= 0 ? NP : n_prefs;
  const bool p_staged = np > 0;
  const int tpr = cols >> 2;                 // threads per row (a power of two)
  const int rpp = pt::THREADS / tpr;         // rows per pass
  const int R = ROWS_PER_THREAD * rpp;       // rows per tile (a multiple of 4)
  const int trow = threadIdx.x / tpr;
  const int tcol = threadIdx.x - trow * tpr;
  const int n_rt = (Tp + R - 1) / R;
  const int n_items = n_rt * ((Mp + cols - 1) / cols);
  const int G = static_cast<int>(gridDim.x);
  const int b = static_cast<int>(blockIdx.x);
  const int mine = n_items > b ? (n_items - b + G - 1) / G : 0;

  // the column vectors of chunk ch, for this thread's 4 columns; every
  // value is <= INF, so max(v, lo[j]) is INF where slots <= 0, else v
  int chunk = -1, m0 = 0, dm[4], ram[4], rk[4], lo[4];
  bool live = false;
  auto load_columns = [&](int ch) {
    chunk = ch;
    m0 = ch * cols + tcol * 4;
    live = m0 < Mp;
    if (!live) return;
    const int4 dv = *reinterpret_cast<const int4*>(d + m0);
    const int4 rav = *reinterpret_cast<const int4*>(ra + m0);
    const int4 rkv = *reinterpret_cast<const int4*>(rack_of + m0);
    const int4 slv = *reinterpret_cast<const int4*>(slots + m0);
    dm[0] = dv.x, dm[1] = dv.y, dm[2] = dv.z, dm[3] = dv.w;
    ram[0] = rav.x, ram[1] = rav.y, ram[2] = rav.z, ram[3] = rav.w;
    rk[0] = rkv.x, rk[1] = rkv.y, rk[2] = rkv.z, rk[3] = rkv.w;
    const int sl[4] = {slv.x, slv.y, slv.z, slv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) lo[j] = sl[j] > 0 ? INT_MIN : pt::INF;
  };
  if (mine > 0) load_columns(b / n_rt);

  // shared memory (tile_stream.smem_bytes): bars (padded to 16 B) | stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* ring = reinterpret_cast<int*>(smem + ((stages * 8 + 15) & ~15));
  const int stage_ints = R * (p_staged ? 1 + 3 * Pw : 1);

  // thread 0 fills the stage of the block's k-th item (a full tile: its
  // inputs by bulk copy; a tile past Tp: an arrival without bytes)
  auto issue = [&](int k) {
    const int s = k % stages;
    const int t0 = ((b + k * G) % n_rt) * R;
    uint64_t* bar = &bars[s];
    if (t0 + R > Tp) {
      pt::mbar_arrive(bar);
      return;
    }
    int* st = ring + s * stage_ints;
    const int wb = R * 4, pb = R * Pw * 4;
    pt::mbar_expect_tx(bar, p_staged ? wb + 3 * pb : wb);
    pt::bulk_load(st, w + t0, wb, bar);
    if (p_staged) {
      const size_t o = static_cast<size_t>(t0) * Pw;
      pt::bulk_load(st + R, pc + o, pb, bar);
      pt::bulk_load(st + R + R * Pw, pm + o, pb, bar);
      pt::bulk_load(st + R + 2 * R * Pw, pr + o, pb, bar);
    }
  };
  if (threadIdx.x == 0 && stages > 0) {
    for (int s = 0; s < stages; ++s) pt::mbar_init(&bars[s], 1);
    pt::fence_barrier_init();
    for (int k = 0; k < min(stages, mine); ++k) issue(k);
  }
  __syncthreads();  // the barriers' initialisation is visible to every thread

  for (int k = 0; k < mine; ++k) {
    const int it = b + k * G;
    const int ch = it / n_rt;
    const int t0 = (it - ch * n_rt) * R;
    const int rows = min(R, Tp - t0);
    if (ch != chunk) load_columns(ch);
    TileIn in;
    if (stages > 0) pt::mbar_wait(&bars[k % stages], (k / stages) & 1);
    if (stages > 0 && rows == R) {
      const int* st = ring + (k % stages) * stage_ints;
      in = TileIn{st, st + R, st + R + R * Pw, st + R + 2 * R * Pw};
    } else {
      const size_t o = static_cast<size_t>(t0) * Pw;
      in = TileIn{w + t0, pc + o, pm + o, pr + o};
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < ROWS_PER_THREAD; ++q) {
        const int r = trow + q * rpp;
        if (r >= rows) break;
        const int wt = in.w[r];
        int o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = min(pt::wrap_add(wt, dm[j]), pt::INF);
#pragma unroll
        for (int kk = 0; kk < (NP >= 0 ? NP : np); ++kk) {
          const int pmk = in.pm[r * Pw + kk];
          const int prk = in.pr[r * Pw + kk];
          const unsigned dj = static_cast<unsigned>(pmk) - static_cast<unsigned>(m0);
          if (dj < 4u) {  // pm in [m0, m0 + 4): -1 never hits
            const int pck = in.pc[r * Pw + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (dj == static_cast<unsigned>(j)) o[j] = min(o[j], pck);
          }
          if (prk >= 0) {
            const int pck = in.pc[r * Pw + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (prk == rk[j]) o[j] = min(o[j], min(pt::wrap_add(pck, ram[j]), pt::INF));
          }
        }
        *reinterpret_cast<int4*>(c + static_cast<size_t>(t0 + r) * Mp + m0) = make_int4(
            max(o[0], lo[0]), max(o[1], lo[1]), max(o[2], lo[2]), max(o[3], lo[3]));
      }
    }
    __syncthreads();  // every thread is done with stage k % stages
    if (threadIdx.x == 0 && stages > 0 && k + stages < mine) issue(k + stages);
  }
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, const int*,
                          const int*, const int*, int*, int, int, int, int, int, int);

KernelFn pick(int n_prefs) {
  static_assert(NP_UNROLLED == 4, "the switch lists 0..NP_UNROLLED");
  switch (n_prefs) {
    case 0: return densify_kernel<0>;
    case 1: return densify_kernel<1>;
    case 2: return densify_kernel<2>;
    case 3: return densify_kernel<3>;
    case 4: return densify_kernel<4>;
    default: return densify_kernel<-1>;
  }
}

}  // namespace

// Blocks of the n_prefs instantiation that fit on one SM with `smem`
// bytes of dynamic shared memory; first lifts its dynamic shared-memory
// cap to the card's per-block maximum. Called once per device and
// shape, never per launch.
extern "C" int densify_occupancy(int n_prefs, int smem, int* blocks) {
  return static_cast<int>(pt::occupancy(pick(n_prefs), smem, blocks));
}

extern "C" int densify_launch(const int* w, const int* d, const int* ra, const int* rack_of,
                              const int* slots, const int* pc, const int* pm, const int* pr, int* c,
                              int Tp, int Mp, int n_prefs, int Pw, int cols, int stages, int grid,
                              int smem, void* stream) {
  const KernelFn kernel = pick(n_prefs);
  if (Tp > 0)
    kernel<<<grid, pt::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        w, d, ra, rack_of, slots, pc, pm, pr, c, Tp, Mp, n_prefs, Pw, cols, stages);
  return static_cast<int>(cudaGetLastError());
}
