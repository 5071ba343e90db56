// K3 bid_pass: one Jacobi bidding round's dense pass over the bid window.
//
// Replaces: poseidon_tpu/ops/dense_auction.py:710-746, the bid pass of
// `auction_round` inside `_solve`. For each window slot b with task
// t = btask[b]:
//   vb[m]   = min(c[t, m] + p[m], INF)
//   b1v     = min_m vb[m]
//   rot     = (uint32(t + task0) * 40503) mod Mp  (uint32 arithmetic)
//   m1      = the m with vb[m] == b1v of least tie_rank = (m - rot) mod Mp
//             (a floor modulo, so the rank is in [0, Mp))
//   v2      = min_m vb[m] with column m1 masked to INF
//   c1      = c[t, m1]
//   take_uns = bvalid[b] && u[t] <= b1v
//   beta    = min(int64(min(v2, u[t])) + eps - c1, INF - 1)  (int64, then int32)
// eps is read from device memory (an int32 the caller keeps on the card),
// so a launch captured into the auction loop's graph takes each round's eps.
// Invalid window slots (bvalid = 0) are computed like any other row; the
// caller's scatter drops them. task0 is the first task of the table's
// rows: 0 for the whole table, the shard's first row under a row-block
// mesh (btask is then relative to it, and the tie-break still ranks by
// the absolute task id).
//
// Bound: bytes. The window gathers B rows of the table: B*Mp*4 B (10 MiB
// at the flagship B = 2560, Mp = 1024: 3.1 us at 3.35 TB/s), plus p once
// and a few words per slot. Arithmetic per element is a handful of
// integer operations.
//
// Design: the persistent row stream of row_options (common.cuh: a grid
// sized to the card, window slots dealt to blocks and then warps, each
// warp's tiles in flight through a ring of shared-memory stages filled by
// 1-D bulk copies on mbarriers, p staged once per block). The row of a
// slot is a gather through btask, so its address needs a load before the
// copy can be issued: each warp loads the btask and bvalid of 32 of its
// slots at once into a shared-memory ring of two such batches, ahead of
// the copies that need them, and u[t] right after issuing those copies,
// so the dependent loads cost one latency per 32 rows instead of one per
// row, and only btask's is in front of the copies. p is staged after the
// first copies are issued, as in row_options. At the flagship (B = 2560
// over 396 blocks of 8 warps) a warp has at most one slot, so K3 is one
// latency chain per warp (btask, the row's copy, the fold), and its time
// is mostly that chain and the launch, not bytes; the grid deals slots
// to blocks first, so SMs differ by at most one row.
// The rotated tie-break is folded into the reduction key: the
// lexicographic least (value, tie_rank) is exactly "least value, then
// least rank among the tied columns", and tie_rank is a bijection of the
// columns, so the winning column is recovered as (rank + rot) mod Mp.
// The runner-up rides the same reduction as in row_options. Lane 0 does
// the O(1) epilogue; c1 comes from the stage still holding the row's last
// tile when m1 lies in it (always, when a row is one tile), else from
// the table.
#include "common.cuh"

namespace {

constexpr int BATCH = 32;        // slots whose metadata a warp loads at once
constexpr int META = 2 * BATCH;  // a warp's metadata ring: two batches

__global__ void __launch_bounds__(pt::THREADS, 4) bid_pass_kernel(
    const int* __restrict__ c, const int* __restrict__ p, const int* __restrict__ u,
    const int* __restrict__ btask, const uint8_t* __restrict__ bvalid,
    const int* __restrict__ eps_ptr, int B, int Mp, int task0, int stages, int chunk, int p_resident, int* __restrict__ m1_out,
    int* __restrict__ b1v_out,
    int* __restrict__ v2_out, uint8_t* __restrict__ take_uns_out, int* __restrict__ beta_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool pres = p_resident != 0;
  const pt::StreamSmem sm = pt::stream_smem(smem, stages, 3 * META, Mp, pres);
  pt::init_stage_bars(sm, stages);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stage_ints = pres ? chunk : 2 * chunk;
  const int ntile = (Mp + chunk - 1) / chunk;
  const int nrows = pt::warp_rows(B);
  const int total = nrows * ntile;
  const int* ring = sm.ring + warp * stages * stage_ints;
  uint64_t* bars = sm.bars + warp * stages;
  int* mt = sm.meta + warp * 3 * META;  // task of the warp's k-th slot, at k % META
  int* mu = mt + META;                  // u[task]
  int* mok = mu + META;                 // bvalid[slot]

  // Slot metadata of the warp's rows k0..k0+31, one row per lane: the
  // task and bvalid (which the tiles' copies need first), then u[task]
  // (which only the epilogue needs, so it is loaded after the copies
  // are issued and its latency overlaps theirs).
  auto load_tasks = [&](int k0) {
    const int k = k0 + lane;
    if (k < nrows) {
      const int slot = pt::warp_row(k);
      mt[k % META] = btask[slot];
      mok[k % META] = bvalid[slot];
    }
    __syncwarp();
  };
  auto load_u = [&](int k0) {
    const int k = k0 + lane;
    if (k < nrows) mu[k % META] = u[mt[k % META]];
    __syncwarp();
  };

  // Producer: issue the next tile (row pk, chunk pj) into stage s. The
  // first tile of every 32nd row first loads the tasks of the next 32
  // rows (warp-wide, so every lane calls this); their u follows once the
  // tile is issued. The consumer is at most `stages` <= 8 rows behind,
  // inside the other half of the ring.
  int pk = 0, pj = 0;
  auto produce = [&](int s) {
    const bool batch = pj == 0 && pk % BATCH == 0;
    const int k0 = pk;
    if (batch) load_tasks(k0);
    pt::issue_tile(sm, c, p, mt[pk % META], pj, s, Mp, chunk, stages, pres);
    if (++pj == ntile) pj = 0, ++pk;
    return batch ? k0 : -1;
  };
  // the first tiles, then the first batch's u and p loaded side by side
  // (u's load is issued before p's and stored after them)
  const int ahead = min(stages, total);
  for (int s = 0; s < ahead; ++s) produce(s);
  const int u0 = lane < nrows ? u[mt[lane]] : 0;
  pt::stage_p(sm, p, Mp, pres);
  if (lane < nrows) mu[lane] = u0;
  __syncwarp();

  pt::Top2 acc = pt::top2_empty();
  int j = 0, k = 0, s = 0, phase = 0;
  int t = 0, rot = 0;
  for (int i = 0; i < total; ++i) {
    if (j == 0) {
      t = mt[k % META];
      rot = static_cast<int>((static_cast<unsigned>(t + task0) * 40503u) %
                             static_cast<unsigned>(Mp));
    }
    pt::mbar_wait(&bars[s], phase);
    const int col = j * chunk;
    const int n = min(chunk, Mp - col);
    const int* cs = ring + s * stage_ints;
    pt::fold_tile<false>(acc, cs, pres ? sm.p + col : cs + chunk, col, n, [rot, Mp](int m) {
      const int rank = m - rot;
      return rank < 0 ? rank + Mp : rank;
    });
    if (j == ntile - 1) {
      acc = pt::warp_top2(acc);
      if (lane == 0) {
        int m1 = acc.k + rot;
        if (m1 >= Mp) m1 -= Mp;
        const int c1 = (m1 >= col && m1 < col + n) ? cs[m1 - col]
                                                   : c[static_cast<size_t>(t) * Mp + m1];
        const int ub = mu[k % META];
        const int eps = *eps_ptr;
        const long long beta = min(static_cast<long long>(min(acc.v2, ub)) + eps - c1,
                                   static_cast<long long>(pt::INF - 1));
        const int slot = pt::warp_row(k);
        m1_out[slot] = m1;
        b1v_out[slot] = acc.v;
        v2_out[slot] = acc.v2;
        take_uns_out[slot] = (mok[k % META] != 0 && ub <= acc.v) ? 1 : 0;
        beta_out[slot] = static_cast<int>(beta);
      }
      acc = pt::top2_empty();
    }
    __syncwarp();  // every lane is done with stage s
    if (i + stages < total) {
      const int b = produce(s);
      if (b >= 0) load_u(b);
    }
    if (++j == ntile) j = 0, ++k;
    if (++s == stages) s = 0, phase ^= 1;
  }
}

}  // namespace

// Blocks of bid_pass_kernel that fit on one SM with `smem` bytes of
// dynamic shared memory, after lifting the kernel's dynamic shared-memory
// cap to the card's per-block maximum. Called once per device and shape,
// never per launch.
extern "C" int bid_pass_occupancy(int smem, int* blocks) {
  return static_cast<int>(pt::occupancy(bid_pass_kernel, smem, blocks));
}

extern "C" int bid_pass_launch(const int* c, const int* p, const int* u, const int* btask,
                               const uint8_t* bvalid, const int* eps, int B, int Mp, int task0,
                               int grid,
                               int stages, int chunk, int p_resident, int smem, int* m1, int* b1v,
                               int* v2, uint8_t* take_uns, int* beta, void* stream) {
  if (B > 0)
    bid_pass_kernel<<<grid, pt::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        c, p, u, btask, bvalid, eps, B, Mp, task0, stages, chunk, p_resident, m1, b1v, v2,
        take_uns, beta);
  return static_cast<int>(cudaGetLastError());
}
