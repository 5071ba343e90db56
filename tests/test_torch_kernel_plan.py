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
from poseidon_tpu_torch.kernels import KERNELS, bid_pass, reset_launch_counts
from poseidon_tpu_torch.kernels import row_options, row_stream
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
