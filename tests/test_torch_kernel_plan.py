"""The row-stream kernels' launch plans and wrapper contract, on the CPU.

K2 ``row_options`` and K3 ``bid_pass`` run on the card only, but their
launch plan (grid, ring depth, tile width, dynamic shared memory) is
Python arithmetic in ``poseidon_tpu_torch/kernels/row_stream.py``, held
here for every shape the port can pass: every Mp on the ``pad_bucket``
ladder up to the dense-table budget, and row counts (Tp, or the bid
window B) from 1 to the flagship's. The kernels themselves are held
against their plain twins, bit for bit, by ``chip_smoke.py`` on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.graph.network import pad_bucket
from poseidon_tpu_torch.kernels import KERNELS, bid_pass, densify, reset_launch_counts
from poseidon_tpu_torch.kernels import row_options, row_stream, tile_stream
from poseidon_tpu_torch.ops.dense_auction import DENSE_TABLE_BUDGET_BYTES

CSRC = pathlib.Path(row_stream.__file__).resolve().parent / "csrc"
SM_COUNT = 132                       # H100 SXM
FLAGSHIP_ROWS = (1, 2, 5, 7, 8, 9, 31, 100, 131, 132, 133, 263, 264, 265,
                 396, 1000, 2112, 2560, 10240)


def _ladder(max_mp: int):
    """Every Mp that ``pad_bucket`` can give, up to ``max_mp``."""
    mp, out = 16, []
    while mp <= max_mp:
        out.append(mp)
        mp = pad_bucket(mp + 1)
    return out


def _dealt_rows(rows: int, grid: int) -> list[int]:
    """The rows the kernels' warps visit (csrc/common.cuh warp_rows and
    warp_row), restated: block b's k-th row of warp w is
    b + grid * (w + WARPS * k)."""
    W = row_stream.WARPS
    seen = []
    for b in range(grid):
        nb = (rows - b + grid - 1) // grid
        for w in range(W):
            for k in range((nb - w + W - 1) // W if nb > w else 0):
                seen.append(b + grid * (w + W * k))
    return seen


@pytest.mark.parametrize("rows", FLAGSHIP_ROWS)
def test_plan_fits_the_card_at_every_ladder_shape(rows):
    """For this row count and every Mp on the ladder that the table
    budget admits (a table has at least max(16, rows) rows): shared
    memory within the 227 KB a block may use, 16-byte stages and tiles,
    a ring of 2-8 stages, p resident where the layout counts it, and a
    grid of at least one block that deals every row to exactly one warp."""
    max_mp = DENSE_TABLE_BUDGET_BYTES // (4 * max(16, rows))
    ladder = _ladder(max_mp)
    assert ladder[0] == 16 and ladder[-1] <= max_mp
    for meta_ints in (0, bid_pass.META_INTS):
        for Mp in ladder:
            lay = row_stream.layout(Mp, meta_ints)
            assert lay.smem <= row_stream.SMEM_MAX == 232_448
            assert row_stream.STAGES_MIN <= lay.stages <= row_stream.STAGES_MAX
            assert lay.chunk % 4 == 0 and 4 <= lay.chunk <= row_stream.TILE_COLUMNS_MAX
            assert lay.stage_bytes % 16 == 0
            ntile = -(-Mp // lay.chunk)
            last = Mp - (ntile - 1) * lay.chunk
            assert 0 < last <= lay.chunk and (last * 4) % 16 == 0
            W, S = row_stream.WARPS, lay.stages
            assert lay.smem == (W * S * 8 + W * meta_ints * 4
                                + (Mp * 4 if lay.p_resident else 0)
                                + W * S * lay.stage_bytes)
            if Mp <= 16384:
                assert lay.p_resident
    for blocks_per_sm in (1, 2, 3, 4):
        grid = row_stream.grid(rows, SM_COUNT, blocks_per_sm)
        assert 1 <= grid <= min(rows, SM_COUNT * blocks_per_sm)
        seen = _dealt_rows(rows, grid)
        assert sorted(seen) == list(range(rows))
        per_block = np.bincount(np.array(seen) % grid, minlength=grid)
        assert per_block.max() - per_block.min() <= 1


def test_plan_rejects_a_ragged_row():
    for Mp in (0, 2, 18, 1030):
        with pytest.raises(ValueError):
            row_stream.layout(Mp)


def test_plan_cache_queries_the_device_once_per_shape():
    calls = {"sm": 0, "occ": []}

    def sm():
        calls["sm"] += 1
        return SM_COUNT

    def occ(smem):
        calls["occ"].append(smem)
        return 2

    cache = row_stream.PlanCache(meta_ints=bid_pass.META_INTS)
    a = cache.get("dev0", 2560, 1024, sm, occ)
    for _ in range(5):
        assert cache.get("dev0", 2560, 1024, sm, occ) is a
    assert calls["sm"] == 1 and calls["occ"] == [a.layout.smem]
    assert a.grid == 2 * SM_COUNT
    b = cache.get("dev0", 10240, 1028, sm, occ)
    c = cache.get("dev1", 2560, 1024, sm, occ)
    assert b is not a and c is not a and len(cache) == 3
    assert calls["sm"] == 3
    assert cache["dev0", 2560, 1024] is a
    with pytest.raises(RuntimeError):
        row_stream.plan(10, 1024, 0, SM_COUNT, lambda smem: 0)


def test_kernel_constants_agree_with_the_plan():
    """The plan's block shape and K3's metadata ring are the ones the
    CUDA sources use."""
    common = (CSRC / "common.cuh").read_text()
    k3 = (CSRC / "bid_pass.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", common)[1])
    assert threads == 32 * row_stream.WARPS
    batch = int(re.search(r"constexpr int BATCH = (\d+);", k3)[1])
    assert re.search(r"constexpr int META = 2 \* BATCH;", k3)
    assert "stream_smem(smem, stages, 3 * META, Mp, pres)" in k3
    assert bid_pass.META_INTS == 3 * 2 * batch
    # stages <= 8 keeps the consumer inside the other half of the ring
    assert row_stream.STAGES_MAX < batch


def _k3_args(rng, Tp=40, Mp=64, B=24):
    c = torch.from_numpy(rng.integers(0, 500, (Tp, Mp)).astype(np.int32))
    p = torch.from_numpy(rng.integers(0, 50, Mp).astype(np.int32))
    u = torch.from_numpy(rng.integers(0, 600, Tp).astype(np.int32))
    btask = torch.from_numpy(rng.integers(0, Tp, B).astype(np.int32))
    bvalid = torch.from_numpy(rng.random(B) < 0.7)
    return c, p, u, btask, bvalid


def test_wrappers_take_the_twin_for_cpu_tensors():
    rng = np.random.default_rng(3)
    c, p, u, btask, bvalid = _k3_args(rng)
    reset_launch_counts()
    got = row_options.row_options(c, p)
    want = row_options.row_options_plain(c, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = bid_pass.bid_pass(c, p, u, btask, bvalid, 3)
    want = bid_pass.bid_pass_plain(c, p, u, btask, bvalid, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(k.launches == 0 for k in KERNELS)
    assert len(row_options.PLANS) == 0 and len(bid_pass.PLANS) == 0


def test_wrappers_raise_on_mixed_devices():
    rng = np.random.default_rng(4)
    c, p, u, btask, bvalid = _k3_args(rng)
    with pytest.raises(ValueError):
        row_options.row_options(c, p.to("meta"))
    with pytest.raises(ValueError):
        bid_pass.bid_pass(c, p, u.to("meta"), btask, bvalid, 1)
    with pytest.raises(ValueError):
        bid_pass.bid_pass(c.to("meta"), p.to("meta"), u.to("meta"),
                          btask.to("meta"), bvalid.to("meta"), 1)


# ---------------------------------------------------------------------------
# K1 densify: the tile writer's plan (kernels/tile_stream.py)
# ---------------------------------------------------------------------------

PW_NPREFS = [(Pw, n) for Pw in range(0, 6) for n in sorted({0, min(1, Pw), Pw})]


def _tile_cells(p: tile_stream.TilePlan, Tp: int, Mp: int) -> np.ndarray:
    """How many times the kernel (csrc/densify.cu) stores each cell of
    a Tp x Mp table under plan ``p``, restated: block b walks items
    b, b + grid, ...; item it is row tile it % n_rt of column chunk
    it // n_rt; thread (trow, tcol) stores columns c0 + 4 tcol .. + 3 of
    rows trow + q * rows_per_pass, q < ROWS_PER_THREAD, of the tile."""
    R, cols, rpp = p.tile_rows, p.cols, p.rows_per_pass
    n_rt = -(-Tp // R)
    n_items = n_rt * -(-Mp // cols)
    assert n_items == tile_stream.items(Tp, Mp, cols)
    count = np.zeros((Tp, Mp), np.int32)
    trow, tcol = np.divmod(np.arange(tile_stream.THREADS), cols // 4)
    q = np.arange(tile_stream.ROWS_PER_THREAD)
    for b in range(p.grid):
        for it in range(b, n_items, p.grid):
            ch, tile = divmod(it, n_rt)
            t0, c0 = tile * R, ch * cols
            rows = min(R, Tp - t0)
            r = (trow[:, None] + q[None, :] * rpp).ravel()
            m0 = np.repeat(c0 + 4 * tcol, len(q))
            ok = (r < rows) & (m0 < Mp)
            for j in range(4):
                np.add.at(count, (t0 + r[ok], m0[ok] + j), 1)
    return count


@pytest.mark.parametrize("rows", FLAGSHIP_ROWS)
def test_densify_plan_fits_the_card_at_every_ladder_shape(rows):
    """For this Tp and every Mp on the ladder that the table budget
    admits, Pw 0-5 and n_prefs 0, 1 and Pw: chunks of 4-1024 columns
    (a power of two x 4) that cut Mp exactly, shared memory within
    227 KB and equal to the kernel's layout, every bulk copy 16-byte
    aligned in offset and size (or the tile read directly, which only
    a tile ending past Tp is), and a grid of 1 to items blocks."""
    max_mp = DENSE_TABLE_BUDGET_BYTES // (4 * max(16, rows))
    seen_cols = set()
    for Mp in _ladder(max_mp):
        cols = tile_stream.chunk_columns(Mp)
        assert cols % 4 == 0 and 4 <= cols <= tile_stream.CHUNK_COLUMNS_MAX
        assert (cols // 4) & (cols // 4 - 1) == 0          # a power of two
        n_ch = -(-Mp // cols)
        assert (n_ch - 1) * cols < Mp <= n_ch * cols
        assert cols >= Mp or cols == tile_stream.CHUNK_COLUMNS_MAX
        seen_cols.add(cols)
    for cols in sorted(seen_cols):
        Mp = cols                       # the layout depends on Mp via cols
        for Pw, n in PW_NPREFS:
            c2, stages, p_staged, smem = tile_stream.layout(Mp, Pw, n)
            assert c2 == cols and p_staged == (n > 0)
            assert 0 < smem <= row_stream.SMEM_MAX == 232_448
            assert smem == tile_stream.smem_bytes(cols, stages, Pw, p_staged)
            assert tile_stream.STAGES_MIN <= stages <= tile_stream.STAGES_MAX
            for blocks_per_sm in (1, 3, 4):
                p = tile_stream.plan(rows, Mp, Pw, n, SM_COUNT,
                                     lambda smem: blocks_per_sm)
                assert p.tile_rows % 4 == 0
                assert p.tile_rows * (cols // 4) == (
                    tile_stream.ROWS_PER_THREAD * tile_stream.THREADS)
                n_items = tile_stream.items(rows, Mp, cols)
                assert 1 <= p.grid <= min(n_items, SM_COUNT * blocks_per_sm)
            n_rt = -(-rows // p.tile_rows)
            for tile in range(n_rt):
                copies = tile_stream.bulk_copies(p, rows, Pw, tile)
                full = (tile + 1) * p.tile_rows <= rows
                assert (copies is not None) == full
                if copies is None:
                    continue
                assert len(copies) == (4 if n > 0 else 1)
                for off, nbytes in copies:
                    assert off % 16 == 0 and nbytes % 16 == 0 and nbytes > 0
                if n > 0:   # the copy stays inside pc/pm/pr
                    assert copies[1][0] + copies[1][1] <= rows * Pw * 4
                assert copies[0][0] + copies[0][1] <= rows * 4


@pytest.mark.parametrize("Tp", [1, 3, 5, 8, 9, 100, 517, 1003, 2000, 10240])
def test_densify_plan_stores_every_cell_once(Tp):
    """The kernel's dealing, restated, stores every (row, column) exactly
    once: at narrow and wide Mp, at a ragged chunk (1028 = 1024 + 4), with
    grids of one block, a few blocks and the flagship's wave."""
    for Mp in (16, 64, 100, 1024, 1028, 2048):
        if Tp * Mp > 10240 * 1024:
            continue
        for sms, bps in ((1, 1), (3, 2), (SM_COUNT, 4)):
            p = tile_stream.plan(Tp, Mp, 3, 3, sms, lambda smem: bps)
            if sms == SM_COUNT and Tp * Mp > 2048 * 1028:
                continue
            count = _tile_cells(p, Tp, Mp)
            assert (count == 1).all(), (Tp, Mp, sms, bps)
    # the flagship itself, at its real plan
    if Tp == 10240:
        p = tile_stream.plan(Tp, 1024, 3, 3, SM_COUNT, lambda smem: 4)
        assert (p.cols, p.tile_rows, p.grid) == (1024, 4, 528)
        assert (_tile_cells(p, Tp, 1024) == 1).all()


def test_densify_plan_reads_directly_only_where_it_must():
    """Stages hold the tile's inputs unless 2 stages do not fit (a very
    wide Pw at narrow Mp); then every tile is read from global memory."""
    cols, stages, _, smem = tile_stream.layout(16, 48, 48)
    assert stages == 0 and smem <= row_stream.SMEM_MAX
    p = tile_stream.plan(3000, 16, 48, 48, SM_COUNT, lambda smem: 1)
    assert all(tile_stream.bulk_copies(p, 3000, 48, t) is None for t in range(6))
    assert tile_stream.layout(1024, 3, 3)[1] == tile_stream.STAGES_MAX
    with pytest.raises(ValueError):
        tile_stream.layout(1024, 3, 4)
    with pytest.raises(ValueError):
        tile_stream.layout(18, 3, 3)
    with pytest.raises(RuntimeError):
        tile_stream.plan(10, 1024, 3, 3, SM_COUNT, lambda smem: 0)


def test_densify_plan_cache_queries_the_device_once_per_shape():
    calls = {"sm": 0, "occ": []}

    def sm():
        calls["sm"] += 1
        return SM_COUNT

    def occ(smem):
        calls["occ"].append(smem)
        return 4

    cache = row_stream.PlanCache(make=tile_stream.plan)
    a = cache.get("dev0", 10240, 1024, sm, occ, 3, 3)
    for _ in range(5):
        assert cache.get("dev0", 10240, 1024, sm, occ, 3, 3) is a
    assert calls["sm"] == 1 and calls["occ"] == [a.smem]
    assert a.grid == 4 * SM_COUNT
    b = cache.get("dev0", 10240, 1024, sm, occ, 3, 1)
    c = cache.get("dev0", 10240, 1024, sm, occ, 5, 3)
    assert b is not a and c is not a and len(cache) == 3
    assert cache["dev0", 10240, 1024, 3, 3] is a


def test_densify_constants_agree_with_the_plan():
    """The tile shape, the unrolled n_prefs and the shared-memory layout
    are the ones csrc/densify.cu uses."""
    k1 = (CSRC / "densify.cu").read_text()
    rpt = int(re.search(r"constexpr int ROWS_PER_THREAD = (\d+);", k1)[1])
    assert rpt == tile_stream.ROWS_PER_THREAD
    npu = int(re.search(r"constexpr int NP_UNROLLED = (\d+);", k1)[1])
    assert npu == tile_stream.NP_UNROLLED
    cases = [int(x) for x in re.findall(
        r"case (\d+): return densify_kernel<\1>;", k1)]
    assert cases == list(range(npu + 1))
    assert "default: return densify_kernel<-1>;" in k1
    # bars padded to 16 bytes, then the stages (w | pc | pm | pr)
    assert "smem + ((stages * 8 + 15) & ~15)" in k1
    assert "R * (p_staged ? 1 + 3 * Pw : 1)" in k1
    assert "in = TileIn{st, st + R, st + R + R * Pw, st + R + 2 * R * Pw};" in k1
    assert "const int R = ROWS_PER_THREAD * rpp;" in k1
    assert tile_stream.THREADS == 32 * row_stream.WARPS


def _k1_args(rng, Tp=40, Mp=64, Pw=3):
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return (t(rng.integers(0, 500, Tp)), t(rng.integers(0, 500, Mp)),
            t(rng.integers(0, 500, Mp)), t(rng.integers(-1, 4, Mp)),
            t(rng.integers(0, 3, Mp)), t(rng.integers(0, 500, (Tp, Pw))),
            t(rng.integers(-1, Mp, (Tp, Pw))), t(rng.integers(-1, 4, (Tp, Pw))))


def test_densify_wrapper_takes_the_twin_for_cpu_tensors():
    rng = np.random.default_rng(5)
    a = _k1_args(rng)
    reset_launch_counts()
    for n in (0, 1, 3):
        assert torch.equal(densify.densify(*a, n_prefs=n),
                           densify.densify_plain(*a, n_prefs=n))
    assert all(k.launches == 0 for k in KERNELS)
    assert len(densify.PLANS) == 0


def test_densify_wrapper_raises_on_bad_arguments():
    rng = np.random.default_rng(6)
    a = _k1_args(rng)
    with pytest.raises(ValueError):                  # mixed devices
        densify.densify(*a[:4], a[4].to("meta"), *a[5:], n_prefs=3)
    for n in (-1, 4):                                # n_prefs outside [0, Pw]
        with pytest.raises(ValueError):
            densify.densify(*a, n_prefs=n)
    b = _k1_args(rng, Mp=18)                         # Mp not a multiple of 4
    with pytest.raises(ValueError):
        densify.densify(*b, n_prefs=3)
