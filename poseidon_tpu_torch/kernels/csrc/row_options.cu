// K2 row_options: per row of v = min(c + p, INF), the least value b1v,
// its first-index argmin m1, and v2 = the least value with column m1
// masked to INF.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:445 `_task_options` (the
// row reductions XLA fused on the TPU). The same masked row-min serves
// the theta clearing's stage two (:531), the violator check (:785),
// deflate (:821), the certificate (:968) and, with p = 0, the
// runner-up of poseidon_tpu/ops/resident.py:280 `_decision_stats`.
//
// Bound: bytes. One launch reads the Tp*Mp*4 B table once (40 MiB at the
// flagship Tp = 10240, Mp = 1024: 12.5 us at 3.35 TB/s) and writes
// 3*Tp*4 B; a handful of integer operations per element is far below the
// compute roof.
//
// Design: a persistent row stream (common.cuh). The wrapper sizes the
// grid to the card (blocks that fit per SM x SM count, from an occupancy
// query made once per device and shape) and deals rows to blocks, then
// to warps; each warp walks its rows in column chunks ("tiles") of at
// most 1024 columns through a ring of `stages` shared-memory stages (at
// Mp >= 1024 two 4 KiB stages: 70 KB a block, three blocks, 24 warps an
// SM, which measured faster than deeper rings with fewer warps). Its
// lane 0 keeps `stages` tiles in flight with 1-D bulk copies (TMA, one
// instruction per tile, completion counted on an mbarrier per stage)
// while the warp folds the tile that has landed, so the next rows' bytes
// are on their way during every fold and across row boundaries. Bulk
// copies, not 16-byte cp.async: a tile is one contiguous run, one thread
// issues it, and no lane spends registers or instructions on addresses
// (a cp.async version of the same ring measured no faster).
// p is the same for every row, so the block copies it into shared memory
// once, after its warps have issued their first tiles (so p's load and
// the tiles' copies overlap, and no warp waits on p before it issues);
// past the shared-memory budget (kernels/row_stream.py) each stage
// carries p's chunk beside c's instead (read from L2, where p stays).
// Each lane folds (value, index, runner-up) over its 16-byte vectors; a
// lane visits its columns in increasing order, so a tie never replaces
// its best and the first index wins; the warp merges lexicographically
// with five shuffle steps. The runner-up rides every merge, so there is
// no second pass over the row.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pt::THREADS, 4) row_options_kernel(
    const int* __restrict__ c, const int* __restrict__ p, int Tp, int Mp, int stages, int chunk,
    int p_resident, int* __restrict__ b1v, int* __restrict__ m1, int* __restrict__ v2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool pres = p_resident != 0;
  const pt::StreamSmem sm = pt::stream_smem(smem, stages, 0, Mp, pres);
  pt::init_stage_bars(sm, stages);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stage_ints = pres ? chunk : 2 * chunk;
  const int ntile = (Mp + chunk - 1) / chunk;
  const int total = pt::warp_rows(Tp) * ntile;
  const int* ring = sm.ring + warp * stages * stage_ints;
  uint64_t* bars = sm.bars + warp * stages;

  // producer cursor: row pk, chunk pj of the next tile to issue
  int pk = 0, pj = 0;
  const int ahead = min(stages, total);
  for (int s = 0; s < ahead; ++s) {
    pt::issue_tile(sm, c, p, pt::warp_row(pk), pj, s, Mp, chunk, stages, pres);
    if (++pj == ntile) pj = 0, ++pk;
  }
  pt::stage_p(sm, p, Mp, pres);

  pt::Top2 acc = pt::top2_empty();
  int j = 0, k = 0, s = 0, phase = 0;
  for (int i = 0; i < total; ++i) {
    pt::mbar_wait(&bars[s], phase);
    const int col = j * chunk;
    const int* cs = ring + s * stage_ints;
    pt::fold_tile<true>(acc, cs, pres ? sm.p + col : cs + chunk, col, min(chunk, Mp - col),
                        [](int m) { return m; });
    if (j == ntile - 1) {
      acc = pt::warp_top2(acc);
      if (lane == 0) {
        const int row = pt::warp_row(k);
        b1v[row] = acc.v;
        m1[row] = acc.k;
        v2[row] = acc.v2;
      }
      acc = pt::top2_empty();
    }
    __syncwarp();  // every lane is done with stage s
    if (i + stages < total) {
      pt::issue_tile(sm, c, p, pt::warp_row(pk), pj, s, Mp, chunk, stages, pres);
      if (++pj == ntile) pj = 0, ++pk;
    }
    if (++j == ntile) j = 0, ++k;
    if (++s == stages) s = 0, phase ^= 1;
  }
}

}  // namespace

// Blocks of row_options_kernel that fit on one SM with `smem` bytes of
// dynamic shared memory. First lifts the kernel's dynamic shared-memory
// cap from the default 48 KB to the card's per-block maximum, so that
// every plan's launch is allowed whatever order plans were made in.
// Called once per device and shape, never per launch.
extern "C" int row_options_occupancy(int smem, int* blocks) {
  return static_cast<int>(pt::occupancy(row_options_kernel, smem, blocks));
}

extern "C" int row_options_launch(const int* c, const int* p, int* b1v, int* m1, int* v2, int Tp,
                                  int Mp, int grid, int stages, int chunk, int p_resident, int smem,
                                  void* stream) {
  if (Tp > 0)
    row_options_kernel<<<grid, pt::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        c, p, Tp, Mp, stages, chunk, p_resident, b1v, m1, v2);
  return static_cast<int>(cudaGetLastError());
}
