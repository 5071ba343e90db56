"""The launch plan of K9 ``cs_sweep`` and K10 ``bf_relax``, on the CPU.

The kernels run on the card only, but the plan that deals a residual
CSR's positions to their blocks (``poseidon_tpu_torch/kernels/
csr_plan.py``) is host arithmetic, held here: every position dealt to
exactly one block, every node to exactly one item, the heavy/light
partition and the chunk offsets, degree 0, segments at the threshold
minus one, at it and past it, segments past one cluster's reach, a graph
whose nodes are all heavy, and the flagship's plan. The dealing is
restated from ``csrc/csr_plan.cuh``; the kernels themselves are held
against their plain twins, bit for bit, by ``chip_smoke.py`` on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.kernels import csr_plan as cp

CUH = pathlib.Path(cp.__file__).resolve().parent / "csrc" / "csr_plan.cuh"
CHUNK, CLUSTER, MAX_NODES = cp.CHUNK, cp.CLUSTER, cp.MAX_NODES


def seg_of(deg) -> np.ndarray:
    seg = np.zeros(len(deg) + 1, np.int64)
    seg[1:] = np.cumsum(deg)
    return seg


def dealt(items: np.ndarray, n_heavy: int) -> list[tuple[int, int, int]]:
    """(block, first, end) of every chunk a block visits, restated from
    csr_plan.cuh's ``decode``: heavy item c is cluster c, whose rank r
    takes the chunks starting at pos_lo + r * CHUNK, every CLUSTER *
    CHUNK positions; light item j is block CLUSTER * n_heavy + j, one
    pass over [pos_lo, pos_hi)."""
    out = []
    for j, (lo, hi, b, e) in enumerate(items.tolist()):
        if j < n_heavy:
            for r in range(CLUSTER):
                for s in range(b + r * CHUNK, e, CLUSTER * CHUNK):
                    out.append((CLUSTER * j + r, s, min(s + CHUNK, e)))
        else:
            out.append((CLUSTER * n_heavy + (j - n_heavy), b, e))
    return out


def check_plan(deg) -> tuple[np.ndarray, int]:
    """Every invariant the kernels rely on; returns the items."""
    deg = np.asarray(deg, np.int64)
    seg = seg_of(deg)
    NN, R = len(deg), int(seg[-1])
    items, n_heavy = cp.plan_items(seg)
    assert items.dtype == np.int32 and items.shape[1] == 4
    lo, hi, b, e = items.T.astype(np.int64)
    # heavy first, exactly the nodes past the threshold, one node each,
    # their whole segment
    assert n_heavy == int((deg > CHUNK).sum())
    assert (lo[:n_heavy] == np.flatnonzero(deg > CHUNK)).all()
    assert (hi[:n_heavy] == lo[:n_heavy] + 1).all()
    # light: whole light nodes, at most MAX_NODES and CHUNK positions
    L = slice(n_heavy, None)
    assert (hi[L] > lo[L]).all() and (hi[L] - lo[L] <= MAX_NODES).all()
    assert (e[L] - b[L] <= CHUNK).all()
    for x, y in zip(lo[L], hi[L]):
        assert (deg[x:y] <= CHUNK).all()
    # every item's positions are its nodes' segments
    assert (b == seg[lo]).all() and (e == seg[hi]).all()
    # every node in exactly one item
    nodes = np.concatenate([np.arange(x, y) for x, y in zip(lo, hi)]
                           + [np.zeros(0, np.int64)])
    assert np.array_equal(np.sort(nodes), np.arange(NN))
    # every position dealt to exactly one block, in chunks of <= CHUNK
    # (a light run of degree-0 nodes has none), each block inside the
    # grid
    chunks = dealt(items, n_heavy)
    pos = np.concatenate([np.arange(s, t) for _, s, t in chunks]
                         + [np.zeros(0, np.int64)])
    assert np.array_equal(np.sort(pos), np.arange(R))
    assert all(0 <= t - s <= CHUNK for _, s, t in chunks)
    grid = CLUSTER * (n_heavy + -(-(len(items) - n_heavy) // CLUSTER))
    assert all(blk < grid for blk, _, _ in chunks)
    # greedy: a light run stops only at a heavy node, the end, MAX_NODES
    # nodes, or a node that would take it past CHUNK positions
    for x, y in zip(lo[L], hi[L]):
        assert (y == NN or deg[y] > CHUNK or y - x == MAX_NODES
                or seg[y + 1] - seg[x] > CHUNK)
    return items, n_heavy


DEGREES = {
    "one_node_degree_0": [0],
    "all_degree_0": [0] * 1000,
    "degree_0_around": [0, 0, 5, 0, 1, 0, 0],
    "degrees_1_31_32_33": [1, 31, 32, 33] * 40,
    "below_threshold": [3, CHUNK - 1, 4],
    "at_threshold": [3, CHUNK, 4],
    "past_threshold": [3, CHUNK + 1, 4],
    "cluster_reach_minus_1": [2, CLUSTER * CHUNK - 1, 2],
    "cluster_reach": [2, CLUSTER * CHUNK, 2],
    "cluster_reach_plus_1": [2, CLUSTER * CHUNK + 1, 2],
    "three_cluster_reaches": [7, 3 * CLUSTER * CHUNK + 5],
    "s_t_like": [12289, 12289] + [6] * 3000,
    "all_heavy": [CHUNK + 1, 3000, 5000, CLUSTER * CHUNK + 2],
    "heavy_neighbours": [CHUNK + 1] * 3 + [1] * 10 + [CHUNK + 1],
    "light_runs_fill_chunk": [CHUNK // 4 + 1] * 9,
}


@pytest.mark.parametrize("name", sorted(DEGREES))
def test_plan_deals_every_position_once(name):
    check_plan(DEGREES[name])


def test_plan_heavy_light_partition_and_offsets():
    """Degree CHUNK is light and a block alone (its neighbours would take
    the run past CHUNK positions); CHUNK + 1 is heavy. A heavy
    segment of CLUSTER * CHUNK + 1 positions gives rank 0 a second chunk
    of one position; CLUSTER * CHUNK gives each rank exactly one."""
    items, nh = check_plan([3, CHUNK, 4])
    assert nh == 0 and items.tolist() == [
        [0, 1, 0, 3], [1, 2, 3, CHUNK + 3], [2, 3, CHUNK + 3, CHUNK + 7]]
    items, nh = check_plan([2, CLUSTER * CHUNK + 1, 2])
    assert nh == 1 and items[0].tolist() == [1, 2, 2, CLUSTER * CHUNK + 3]
    assert items[1:].tolist() == [[0, 1, 0, 2], [2, 3, CLUSTER * CHUNK + 3,
                                                 CLUSTER * CHUNK + 5]]
    rank0 = [(s, t) for blk, s, t in dealt(items, nh) if blk == 0]
    assert rank0 == [(2, 2 + CHUNK),
                     (2 + CLUSTER * CHUNK, 3 + CLUSTER * CHUNK)]
    items, nh = check_plan([CLUSTER * CHUNK])
    per_rank = [t - s for _, s, t in dealt(items, nh)]
    assert per_rank == [CHUNK] * CLUSTER


def test_plan_light_runs():
    """Runs stop at MAX_NODES nodes and at CHUNK positions."""
    items, nh = check_plan([0] * 1000)
    assert nh == 0
    assert (items[:, 1] - items[:, 0]).tolist() == [256, 256, 256, 232]
    items, nh = check_plan([CHUNK // 4 + 1] * 9)
    assert (items[:, 1] - items[:, 0]).tolist() == [3, 3, 3]


def test_plan_all_heavy():
    items, nh = check_plan(DEGREES["all_heavy"])
    assert nh == 4 and len(items) == 4
    assert cp.CsrPlan(items=torch.as_tensor(items), tail=torch.zeros(0),
                      n_heavy=nh, n_light=0, NN=4).blocks == 4 * CLUSTER


def test_plan_random_skewed_degrees():
    rng = np.random.default_rng(11)
    for _ in range(5):
        deg = rng.integers(0, 8, 5000)
        deg[rng.choice(5000, 6, replace=False)] = rng.integers(
            CHUNK - 2, 3 * CLUSTER * CHUNK, 6)
        check_plan(deg)


def test_make_plan_uploads_items_and_tails():
    deg = [2, 0, CHUNK + 3, 1]
    seg = seg_of(deg)
    plan = cp.make_plan(seg, "cpu")
    items, nh = cp.plan_items(seg)
    assert plan.items.dtype == plan.tail.dtype == torch.int32
    assert np.array_equal(plan.items.numpy(), items)
    assert (plan.n_heavy, plan.n_light, plan.NN) == (1, 2, 4)
    assert plan.tail.tolist() == [0, 0] + [2] * (CHUNK + 3) + [3]
    assert plan.blocks == 2 * CLUSTER
    with pytest.raises(ValueError, match="made for 4 nodes"):
        cp.plan_args(plan, 5, int(seg[-1]))
    with pytest.raises(ValueError, match="positions"):
        cp.plan_args(plan, 4, int(seg[-1]) + 1)
    assert cp.plan_args(plan, 4, int(seg[-1])) == (
        plan.items.data_ptr(), plan.tail.data_ptr())


def test_plan_constants_match_the_cuda_header():
    """csr_plan.cuh's constants are the plan's own."""
    text = CUH.read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (THREADS|ITEMS|CLUSTER) = (\d+);", text)}
    assert got == {"THREADS": cp.THREADS, "ITEMS": cp.ITEMS,
                   "CLUSTER": cp.CLUSTER}
    assert "CHUNK = THREADS * ITEMS" in text
    assert "MAX_NODES = THREADS" in text
    assert cp.CHUNK == cp.THREADS * cp.ITEMS and cp.MAX_NODES == cp.THREADS


@pytest.mark.parametrize("lane", ["cost_scaling", "ssp"])
def test_flagship_plan(lane):
    """BASELINE config 2's residual CSR (12,290 nodes): four heavy
    segments (S and T, the cluster aggregator, the unscheduled
    aggregator) at degrees 12,289 (12,288 without the forcing arc),
    11,002 and 4,086, and 61 light blocks: 96 blocks in all."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops import cost_scaling, ssp
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    net, _ = FlowGraphBuilder().build(config2_quincy_flagship(seed=0))
    tables = (cost_scaling._augmented_tables(net) if lane == "cost_scaling"
              else ssp._residual_tables(net))
    NN = net.num_node_slots + 2
    deg = np.bincount(np.concatenate(tables[:2]), minlength=NN)
    items, nh = check_plan(deg)
    st = 12289 if lane == "cost_scaling" else 12288
    assert sorted(deg[items[:nh, 0]].tolist()) == [4086, 11002, st, st]
    assert len(items) - nh == 61
    assert CLUSTER * (nh + -(-(len(items) - nh) // CLUSTER)) == 96
