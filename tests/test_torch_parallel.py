"""Differential tests: the port's row-block mesh vs the reference's
sharded solve (``parallel/``).

The reference runs on the conftest's 8 forced host devices; the port
lays its table out over ``[torch.device("cpu")] * w``. On the same
priced instances (``tests/helpers``):

- ``solve_dense_sharded`` at widths 1, 2, 4 and 8 equals the port's
  ``solve_dense`` and the reference's ``solve_dense_sharded`` on its
  8-device mesh: assignment, levels, floors, gap, rounds and phases,
  tolerance 0; a warm re-solve too;
- ``sharded_certificate_gap`` (per-shard holder partials, K8's twin per
  shard) equals the reference's ``shard_map`` gap on solved states and
  on hand-made states that reach every ``asg`` class;
- K8's twin on its edge shapes, its launch plan (every row dealt to
  exactly one warp of one wave), K3's twin at a shard offset,
  ``collective_account`` (non-empty, nothing of [T, M] size) and
  ``make_mesh``'s refusals.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu.ops.dense_auction as ref_da
import poseidon_tpu.parallel as ref_par
import poseidon_tpu_torch.ops.dense_auction as port_da
import poseidon_tpu_torch.parallel as port_par
from poseidon_tpu.graph.builder import FlowGraphBuilder
from poseidon_tpu.ops.transport import extract_instance
from poseidon_tpu.synth import make_synthetic_cluster
from poseidon_tpu_torch.kernels.bid_pass import bid_pass_plain
from poseidon_tpu_torch.kernels import gap_rows as k8
from poseidon_tpu_torch.kernels.gap_rows import gap_rows, gap_rows_plain
from poseidon_tpu_torch.ops.transport import TransportInstance
from tests.helpers import price, random_cluster

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

INF = 2**29
CPU = torch.device("cpu")
WIDTHS = (1, 2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU loops run thousands of tiny ops; one intra-op
    thread keeps them from waiting on a pool the other test workers
    share (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 devices"
    return ref_par.make_mesh(8)


def cpu_mesh(w):
    return port_par.make_mesh(devices=[CPU] * w)


def port_instance(inst) -> TransportInstance:
    return TransportInstance(**{
        f.name: getattr(inst, f.name)
        for f in dataclasses.fields(TransportInstance)
    })


def _instance(seed, n_machines=12, n_tasks=128, model="quincy"):
    rng = np.random.default_rng(seed)
    cluster = random_cluster(rng, n_machines, n_tasks)
    net, meta = FlowGraphBuilder().build(cluster)
    net = price(net, meta, model, cluster)
    return extract_instance(net, meta)


def _scale_instance():
    cluster = make_synthetic_cluster(128, 2048, seed=11,
                                     max_tasks_per_machine=20,
                                     prefs_per_task=2)
    net, meta = FlowGraphBuilder().build(cluster)
    net = price(net, meta, "quincy", cluster)
    return extract_instance(net, meta)


def state_record(st) -> tuple:
    return (st.asg.tolist(), st.lvl.tolist(), st.floor.tolist(),
            int(st.gap), bool(st.converged), int(st.rounds),
            int(st.phases))


def ref_record(st) -> tuple:
    asg, lvl, floor, gap, conv, rounds, phases = jax.device_get(
        (st.asg, st.lvl, st.floor, st.gap, st.converged, st.rounds,
         st.phases))
    return (np.asarray(asg).tolist(), np.asarray(lvl).tolist(),
            np.asarray(floor).tolist(), int(gap), bool(conv), int(rounds),
            int(phases))


class TestShardedSolve:
    # seeds 1, 4 and 7 settle in 7-15 auction rounds; seed 6 is a price
    # war of ~800 rounds (refights and tightens)
    @pytest.mark.parametrize("seed", [1, 4, 6, 7])
    def test_widths_equal_plain_and_reference(self, seed, mesh8):
        inst = _instance(seed)
        dev = port_da.build_dense_instance(port_instance(inst), CPU)
        plain = state_record(port_da.solve_dense(dev))
        for w in (WIDTHS if plain[5] < 100 else (2,)):
            sharded = port_par.shard_instance(dev, cpu_mesh(w))
            assert isinstance(sharded.c, port_da.RowBlocks)
            got = port_par.solve_dense_sharded(sharded)
            assert state_record(got) == plain, w
        ref = ref_par.solve_dense_sharded(
            ref_par.shard_instance(ref_da.build_dense_instance(inst), mesh8))
        assert ref_record(ref) == plain

    def test_2k_tasks_widths_equal_reference(self, mesh8):
        inst = _scale_instance()
        dev = port_da.build_dense_instance(port_instance(inst), CPU)
        ref = ref_record(ref_par.solve_dense_sharded(
            ref_par.shard_instance(ref_da.build_dense_instance(inst),
                                   mesh8)))
        assert ref[4]  # converged
        for w in (2, 8):
            got = port_par.solve_dense_sharded(
                port_par.shard_instance(dev, cpu_mesh(w)))
            assert state_record(got) == ref, w

    def test_warm_resolve_equal(self):
        inst = _instance(3)
        dev = port_da.build_dense_instance(port_instance(inst), CPU)
        first = port_da.solve_dense(dev)
        plain = state_record(port_da.solve_dense(dev, warm=first))
        sdev = port_par.shard_instance(dev, cpu_mesh(4))
        warm = port_par.solve_dense_sharded(
            sdev, warm=port_par.solve_dense_sharded(sdev))
        assert state_record(warm) == plain


def _crafted(seed, Tp=64, Mp=16, w_valid=0.8):
    """A hand-made table and state that reach every asg class: a
    machine, the unscheduled route Mp, unassigned -1 and out of range."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 5000, (Tp, Mp)).astype(np.int32)
    c[rng.random((Tp, Mp)) < 0.1] = INF
    u = rng.integers(0, 6000, Tp).astype(np.int32)
    s = rng.integers(0, 4, Mp).astype(np.int32)
    valid = rng.random(Tp) < w_valid
    asg = rng.integers(-1, Mp + 1, Tp).astype(np.int32)
    asg[::7] = Mp + 5
    asg[::11] = -3
    lvl = rng.integers(0, 3000, Tp).astype(np.int32)
    floor = np.zeros(Mp, np.int32)
    return c, u, s, valid, asg, lvl, floor


class TestCertificate:
    @pytest.mark.parametrize("seed", [1, 4])
    def test_gap_of_solved_states_equal(self, seed, mesh8):
        inst = _instance(seed)
        dev = port_da.build_dense_instance(port_instance(inst), CPU)
        rdev = ref_par.shard_instance(ref_da.build_dense_instance(inst),
                                      mesh8)
        rst = ref_par.solve_dense_sharded(rdev)
        want = ref_par.sharded_certificate_gap(rdev, rst, mesh8)
        for w in WIDTHS:
            sdev = port_par.shard_instance(dev, cpu_mesh(w))
            st = port_par.solve_dense_sharded(sdev)
            assert port_par.sharded_certificate_gap(
                sdev, st, cpu_mesh(w)) == want == int(st.gap), w

    @pytest.mark.parametrize("seed", [3, 4, 5])
    def test_gap_of_crafted_states_equal(self, seed, mesh8):
        c, u, s, valid, asg, lvl, floor = _crafted(seed)
        Tp = c.shape[0]
        rdev = ref_da.DenseInstance(
            c=jnp.asarray(c), u=jnp.asarray(u), w=jnp.asarray(u),
            dgen=jnp.zeros(c.shape[1], jnp.int32), s=jnp.asarray(s),
            task_valid=jnp.asarray(valid), scale=Tp + 1,
            cmax=jnp.int32(5000), smax=4,
        )
        rst = ref_da.DenseState(
            asg=jnp.asarray(asg), lvl=jnp.asarray(lvl),
            floor=jnp.asarray(floor), gap=jnp.int32(0),
            converged=jnp.asarray(True), rounds=jnp.int32(0),
            phases=jnp.int32(0),
        )
        want = ref_par.sharded_certificate_gap(
            ref_par.shard_instance(rdev, mesh8), rst, mesh8)
        pdev = port_da.DenseInstance(
            c=torch.from_numpy(c), u=torch.from_numpy(u),
            w=torch.from_numpy(u), dgen=torch.zeros(c.shape[1],
                                                    dtype=torch.int32),
            s=torch.from_numpy(s), task_valid=torch.from_numpy(valid),
            scale=Tp + 1, cmax=torch.tensor(5000, dtype=torch.int32),
            smax=4,
        )
        pst = port_da.DenseState(
            asg=torch.from_numpy(asg), lvl=torch.from_numpy(lvl),
            floor=torch.from_numpy(floor), gap=torch.tensor(0),
            converged=torch.tensor(True), rounds=0, phases=0,
        )
        for w in WIDTHS:
            assert port_par.sharded_certificate_gap(
                pdev, pst, cpu_mesh(w)) == want, w


def _gap_numpy(c, u, valid, s, lam, asg):
    """The reference lines in numpy int64 (an independent restatement)."""
    Mp = c.shape[1]
    lam_inf = np.where(s > 0, lam, INF).astype(np.int64)
    b1 = np.minimum(np.minimum(c.astype(np.int64) + lam_inf, INF).min(1),
                    u)
    on = (asg >= 0) & (asg < Mp)
    c_asg = c[np.arange(len(asg)), np.clip(asg, 0, Mp - 1)]
    per = np.where(on, c_asg, np.where(asg == Mp, u, INF))
    return (int(np.where(valid, per, 0).astype(np.int64).sum()),
            int(np.where(valid, b1, 0).astype(np.int64).sum()))


@pytest.mark.parametrize("rows,Mp,case", [
    (1, 16, "mixed"), (31, 128, "mixed"), (257, 1040, "mixed"),
    (64, 1024, "all_invalid"), (64, 128, "lam_inf"), (33, 16, "full_inf"),
])
def test_gap_rows_twin_edges(rows, Mp, case):
    rng = np.random.default_rng(rows * 7 + Mp)
    c = rng.integers(0, 2**20, (rows, Mp)).astype(np.int32)
    c[rng.random((rows, Mp)) < 0.05] = INF
    u = rng.integers(0, 2**21, rows).astype(np.int32)
    valid = rng.random(rows) < 0.9
    s = rng.integers(0, 3, Mp).astype(np.int32)
    lam = rng.integers(0, 2**20, Mp).astype(np.int32)
    asg = rng.integers(-2, Mp + 3, rows).astype(np.int32)
    if case == "all_invalid":
        valid[:] = False
    if case == "lam_inf":
        lam[:] = INF
    if case == "full_inf":
        c[:] = INF
        lam[:] = INF
    got = gap_rows(*(torch.from_numpy(x) for x in (c, u, valid, s, lam,
                                                   asg)))
    assert got.dtype == torch.int64
    assert tuple(got.tolist()) == _gap_numpy(c, u, valid, s, lam, asg)
    assert torch.equal(got, gap_rows_plain(
        *(torch.from_numpy(x) for x in (c, u, valid, s, lam, asg))))


H100_SMS = 132


@pytest.mark.parametrize("blocks", [1, 8])
@pytest.mark.parametrize("Mp", [16, 128, 256, 1024, 1040, 8196])
@pytest.mark.parametrize("rows", [1, 31, 10240, 32769, 524288])
def test_gap_rows_plan_covers_every_row_once(rows, Mp, blocks):
    """K8's plan deals every row to exactly one warp, all warps in one
    wave (at most SMs x blocks an SM), every warp but the last holding
    ``rows_per_warp`` rows; prices staged up to ``STAGE_MAX`` columns."""
    seen = []
    p = k8.plan(rows, Mp, H100_SMS, lambda R, smem: blocks)
    assert p.smem == (Mp * 4 if Mp <= k8.STAGE_MAX else 0)
    # a lane keeps 4 vectors in flight, of up to 4 rows at once
    assert p.rows_at_once == (4 if Mp <= 128 else 2 if Mp <= 256 else 1)
    assert p.rows_per_warp % p.rows_at_once == 0
    assert 1 <= p.grid <= H100_SMS * blocks
    dealt = [k8.warp_rows(p, rows, w) for w in range(p.grid * k8.WARPS)]
    for r in dealt:
        seen.extend(r)
    assert len(seen) == rows and sorted(seen) == list(range(rows))
    sizes = [len(r) for r in dealt]
    busy = [n for n in sizes if n]
    assert all(n == p.rows_per_warp for n in busy[:-1])
    assert 0 < busy[-1] <= p.rows_per_warp
    # the idle warps are the last block's tail: no block is idle
    assert sizes[len(busy):] == [0] * (len(sizes) - len(busy))
    assert len(sizes) - len(busy) < k8.WARPS


def test_gap_rows_plan_matches_its_source():
    """The plan's warps a block and staging limit are the kernel's."""
    import pathlib
    import re

    cu = (pathlib.Path(k8.__file__).resolve().parent / "csrc"
          / "gap_rows.cu").read_text()
    assert int(re.search(r"STAGE_MAX = (\d+);", cu).group(1)) == k8.STAGE_MAX
    assert "GAP_THREADS = pt::THREADS" in cu and k8.WARPS == 256 // 32
    assert "UNROLL = 4;" in cu
    with pytest.raises(ValueError):
        k8.plan(10, 1022, H100_SMS, lambda R, smem: 8)
    with pytest.raises(RuntimeError):
        k8.plan(10, 1024, H100_SMS, lambda R, smem: 0)


@pytest.mark.parametrize("r0,r1", [(0, 32), (32, 64), (16, 48)])
def test_bid_pass_twin_at_a_shard_offset(r0, r1):
    """K3's twin over a shard's rows (btask relative, task0 = r0) equals
    the whole table's pass: the tie-break ranks by the absolute task."""
    rng = np.random.default_rng(r0 + r1)
    Tp, Mp = 64, 16
    c = torch.from_numpy(rng.integers(0, 4, (Tp, Mp)).astype(np.int32))
    p = torch.from_numpy(rng.integers(0, 3, Mp).astype(np.int32))
    u = torch.from_numpy(rng.integers(0, 8, Tp).astype(np.int32))
    btask = torch.arange(r0, r1, dtype=torch.int32)
    bvalid = torch.ones(r1 - r0, dtype=torch.bool)
    whole = bid_pass_plain(c, p, u, btask, bvalid, 3)
    part = bid_pass_plain(c[r0:r1], p, u[r0:r1], btask - r0, bvalid, 3,
                          task0=r0)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)


class TestMeshAndAccount:
    def test_collective_account_nonempty_and_no_table_traffic(self):
        inst = _instance(12, n_machines=32, n_tasks=512)
        dev = port_da.build_dense_instance(port_instance(inst), CPU)
        Tp, Mp = dev.c.shape
        acct = port_par.collective_account(
            port_par.shard_instance(dev, cpu_mesh(8)))
        assert set(acct) == {"all-reduce", "all-gather", "all-to-all",
                             "collective-permute", "reduce-scatter"}
        assert sum(a["count"] for a in acct.values()) > 0, acct
        B = min(Tp, max(1024, Tp // 4))
        for a in acct.values():
            assert a["max_bytes"] <= 4 * max(Tp, Mp, B) < 4 * Tp * Mp
        one = port_par.collective_account(
            port_par.shard_instance(dev, cpu_mesh(1)))
        assert all(a["count"] == 0 for a in one.values())

    def test_make_mesh_refuses_non_power_of_two(self):
        with pytest.raises(ValueError, match="power of two"):
            port_par.make_mesh(devices=[CPU] * 3)
        with pytest.raises(ValueError, match="requested 2"):
            port_par.make_mesh(2, devices=[CPU] * 4)

    def test_make_mesh_refuses_more_cards_than_the_host_has(
            self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            port_par.make_mesh(2)
        mesh = port_par.make_mesh(1)
        assert mesh.devices == (torch.device("cuda", 0),)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="devices="):
            port_par.make_mesh(1)

    def test_rows_and_shardings(self):
        mesh = cpu_mesh(4)
        assert mesh.rows(10240) == ((0, 2560), (2560, 5120),
                                    (5120, 7680), (7680, 10240))
        with pytest.raises(ValueError, match="does not divide"):
            cpu_mesh(8).rows(4)
        from poseidon_tpu_torch.ops.resident import DenseTopology

        dt = DenseTopology(*([None] * 11), n_tasks=0)
        inputs, place = port_par.resident_round_shardings(mesh, dt)
        assert inputs == "first"
        assert {f for f, v in place.items() if v == "rows"} \
            == set(port_par.RESIDENT_TASK_FIELDS) \
            == set(ref_par.sharded.RESIDENT_TASK_FIELDS)
