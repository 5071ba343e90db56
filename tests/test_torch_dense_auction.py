"""Differential tests: the PyTorch dense auction vs the JAX reference.

The same transport instances (numpy) go through the reference's
``poseidon_tpu/ops/dense_auction.py`` and the port's
``poseidon_tpu_torch/ops/dense_auction.py`` on the CPU, where the
port's kernel wrappers run their plain twins. Every output is an
integer, so every comparison is exact equality (tolerance 0): the cost
table, the per-row options, the analytic clearing, and whole solves —
asg, lvl, floor, gap, converged, rounds, phases and the per-phase
histogram.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import poseidon_tpu.ops.dense_auction as ref
import poseidon_tpu_torch.ops.dense_auction as port
from poseidon_tpu.cluster import ClusterState, Machine, Task
from poseidon_tpu.compat import enable_x64
from poseidon_tpu.graph.builder import FlowGraphBuilder
from poseidon_tpu.ops.transport import extract_instance
from poseidon_tpu_torch.kernels.bid_pass import bid_pass_plain
from poseidon_tpu_torch.ops.transport import TransportInstance

from tests.helpers import price, random_cluster

CPU = torch.device("cpu")

# one compiled reference program per shape instead of op-by-op eager
# dispatch (module level: one wrapper for the process lifetime)
_ref_theta_clearing = jax.jit(ref._theta_clearing)


def _priced_instance(cluster, model):
    net, meta = FlowGraphBuilder().build(cluster)
    return extract_instance(price(net, meta, model, cluster), meta)


def _graft_small():
    import __graft_entry__

    return __graft_entry__._small_instance()


def _tied_market():
    machines = [
        Machine(name=f"m{i}", rack="r0", cpu_capacity=8, cpu_allocatable=8,
                memory_capacity_kb=1 << 20, memory_allocatable_kb=1 << 20,
                max_tasks=1)
        for i in range(10)
    ]
    tasks = [
        Task(uid=f"t{j}", job="j0", cpu_request=1.0,
             memory_request_kb=1 << 10, data_prefs={f"m{j % 10}": 5})
        for j in range(14)
    ]
    return _priced_instance(ClusterState(machines, tasks), "trivial")


def _oversubscribed():
    return _priced_instance(
        random_cluster(np.random.default_rng(3), 3, 120), "quincy"
    )


def _empty():
    cluster = random_cluster(np.random.default_rng(4), 5, 3)
    cluster.tasks.clear()
    return _priced_instance(cluster, "trivial")


def _more_slots_than_tasks():
    machines = [
        Machine(name="big", rack="r0", cpu_capacity=64, cpu_allocatable=64,
                memory_capacity_kb=1 << 24, memory_allocatable_kb=1 << 24,
                max_tasks=110)
    ]
    tasks = [
        Task(uid=f"t{j}", job="j0", cpu_request=0.5,
             memory_request_kb=1 << 10)
        for j in range(4)
    ]
    return _priced_instance(ClusterState(machines, tasks), "trivial")


def _flagship_shaped():
    """config 2's shape cut to 64 machines x 600 pods (racks of 8)."""
    from poseidon_tpu.synth import make_synthetic_cluster

    return _priced_instance(
        make_synthetic_cluster(64, 600, seed=1, running_fraction=0.2,
                               machines_per_rack=8),
        "quincy",
    )


INSTANCES = {
    "graft_small": _graft_small,
    "tied_market": _tied_market,
    "oversubscribed": _oversubscribed,
    "empty": _empty,
    "more_slots_than_tasks": _more_slots_than_tasks,
    "flagship_shaped": _flagship_shaped,
}


@pytest.fixture(scope="module")
def instances():
    return {}


def _get(instances, name):
    if name not in instances:
        inst = INSTANCES[name]()
        instances[name] = (inst, ref.build_dense_instance(inst),
                           port.build_dense_instance(_port_inst(inst), CPU))
    return instances[name]


def _port_inst(inst) -> TransportInstance:
    return TransportInstance(**{
        f.name: getattr(inst, f.name)
        for f in dataclasses.fields(TransportInstance)
    })


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_solve_equal(out_ref, out_port):
    names = ("asg", "lvl", "floor", "gap", "converged", "rounds", "phases",
             "hist")
    for name, a, b in zip(names, out_ref, out_port):
        assert np.array_equal(np.asarray(a), _np(b)), name


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_densify_and_instance_equal(instances, name):
    _, dref, dport = _get(instances, name)
    assert np.array_equal(np.asarray(dref.c), dport.c.numpy())
    for f in ("u", "w", "dgen", "s", "task_valid"):
        assert np.array_equal(np.asarray(getattr(dref, f)),
                              getattr(dport, f).numpy()), f
    assert int(dref.scale) == dport.scale
    assert int(dref.cmax) == int(dport.cmax)
    assert dref.smax == dport.smax


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("name", ["graft_small", "tied_market",
                                  "flagship_shaped"])
def test_task_options_equal(instances, name, with_values):
    _, dref, dport = _get(instances, name)
    Mp = dport.c.shape[1]
    rng = np.random.default_rng(len(name))
    p = rng.integers(0, 2**20, Mp).astype(np.int32)
    p[rng.random(Mp) < 0.2] = ref.INF           # unavailable machines
    p[:4] = p[4]                                 # ties across columns
    got_ref = ref._task_options(dref, p, with_values=with_values)
    got_port = port._task_options(dport, torch.from_numpy(p),
                                  with_values=with_values)
    for a, b in zip(got_ref, got_port):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["graft_small", "tied_market",
                                  "flagship_shaped"])
def test_decision_stats_equal(instances, name):
    """The port's runner-up from K2 at p = 0 equals the reference's
    masked row-min, for assignments on each row's argmin (m1 == asg),
    on other (often tied) columns, unscheduled and unassigned."""
    import poseidon_tpu.ops.resident as ref_res
    import poseidon_tpu_torch.ops.resident as port_res

    _, dref, dport = _get(instances, name)
    Tp, Mp = dport.c.shape
    rng = np.random.default_rng(len(name) + 7)
    asg = rng.integers(-1, Mp + 1, Tp).astype(np.int32)
    asg[::3] = np.argmin(np.asarray(dref.c), axis=1)[::3]
    got_ref = ref_res._decision_stats(dref, asg)
    got_port = port_res._decision_stats(dport, torch.from_numpy(asg))
    for a, b in zip(got_ref, got_port):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_theta_clearing_equal(instances, name):
    _, dref, dport = _get(instances, name)
    with enable_x64(True):
        got_ref = _ref_theta_clearing(dref)
    got_port = port._theta_clearing(dport)
    for a, b in zip(got_ref, got_port):
        assert np.array_equal(np.asarray(a), b.numpy())


def _clearing_market(kind: str, seed: int):
    """A dense market built directly, at the clearing's edges: ``ties``
    (d_eff drawn from 3 values, u - w from 4, so both sorts meet long
    runs of equal keys), ``invalid`` (a third of the tasks invalid: y =
    -INF), ``no_slots`` (half the machines with s == 0: d_eff = INF) and
    ``all`` (the three at once). Returns (reference, port) instances."""
    INF = port.INF
    rng = np.random.default_rng(seed)
    Tp, Mp = 64, 16
    c = rng.integers(0, 400, (Tp, Mp)).astype(np.int32)
    c[rng.random((Tp, Mp)) < 0.6] = INF
    u = rng.integers(100, 900, Tp).astype(np.int32)
    w = rng.integers(0, 300, Tp).astype(np.int32)
    dgen = rng.integers(0, 200, Mp).astype(np.int32)
    s = rng.integers(1, 4, Mp).astype(np.int32)
    valid = np.ones(Tp, bool)
    if kind in ("ties", "all"):
        dgen = rng.choice([5, 17, 40], Mp).astype(np.int32)
        w = rng.integers(0, 50, Tp).astype(np.int32)
        u = (w + rng.choice([10, 60, 61, 300], Tp)).astype(np.int32)
    if kind in ("invalid", "all"):
        valid[rng.random(Tp) < 0.33] = False
        valid[-1] = False
    if kind in ("no_slots", "all"):
        s[rng.random(Mp) < 0.5] = 0
        s[0] = 0
    c[:, s == 0] = INF
    u[~valid], w[~valid], c[~valid] = 0, INF, INF
    smax = max(int(s.max()), 1)
    cmax = int(c[c < INF].max(initial=0))
    dref = ref.DenseInstance(
        c=jax.numpy.asarray(c), u=jax.numpy.asarray(u),
        w=jax.numpy.asarray(w), dgen=jax.numpy.asarray(dgen),
        s=jax.numpy.asarray(s), task_valid=jax.numpy.asarray(valid),
        scale=jax.numpy.int32(Tp + 1), cmax=jax.numpy.int32(cmax),
        smax=smax)
    dport = port.DenseInstance(
        c=torch.from_numpy(c), u=torch.from_numpy(u),
        w=torch.from_numpy(w), dgen=torch.from_numpy(dgen),
        s=torch.from_numpy(s), task_valid=torch.from_numpy(valid),
        scale=Tp + 1, cmax=torch.tensor(cmax, dtype=torch.int32),
        smax=smax)
    return dref, dport


@pytest.mark.parametrize("kind", ["ties", "invalid", "no_slots", "all"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_theta_clearing_edges_equal(kind, seed):
    """The clearing's K13 sorts (twins on the CPU, each key checked
    against its span) give the reference's seats and prices with ties in
    d_eff and in y, with -INF tasks and with machines of no slot."""
    dref, dport = _clearing_market(kind, seed)
    with enable_x64(True):
        got_ref = _ref_theta_clearing(dref)
    got_port = port._theta_clearing(dport)
    for a, b in zip(got_ref, got_port):
        assert np.array_equal(np.asarray(a), b.numpy())


def _cold(dev, mod, alpha=1024, max_rounds=20_000, analytic_init=True,
          collect_hist=True):
    asg0, lvl0, floor0, eps0 = mod.cold_start(dev, alpha)
    with enable_x64(True):
        return mod._solve(dev, asg0, lvl0, floor0, eps0, alpha, max_rounds,
                          dev.smax, analytic_init=analytic_init,
                          collect_hist=collect_hist)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_cold_solve_equal(instances, name):
    _, dref, dport = _get(instances, name)
    out_ref = _cold(dref, ref)
    out_port = _cold(dport, port)
    _assert_solve_equal(out_ref, out_port)
    if name != "empty":
        assert bool(out_port[4]), "the flagship-shaped families certify"


@pytest.mark.parametrize("name", ["graft_small", "oversubscribed",
                                  "flagship_shaped"])
def test_warm_solve_equal(instances, name):
    """Warm re-solve from the cold state over a capacity-shrunk copy
    (holders beyond the new capacity must be released and repaired)."""
    inst, dref, dport = _get(instances, name)
    out_ref = _cold(dref, ref, collect_hist=False)
    out_port = _cold(dport, port, collect_hist=False)
    shrunk = dataclasses.replace(
        inst, slots=np.maximum(inst.slots - 1, 0).astype(np.int32)
    )
    d2_ref = ref.build_dense_instance(shrunk)
    d2_port = port.build_dense_instance(_port_inst(shrunk), CPU)
    with enable_x64(True):
        w_ref = ref._solve(d2_ref, out_ref[0], out_ref[1], out_ref[2],
                           np.int32(1), 1024, 20_000, d2_ref.smax,
                           analytic_init=False, collect_hist=True)
    w_port = port._solve(d2_port, out_port[0], out_port[1], out_port[2], 1,
                         1024, 20_000, d2_port.smax, analytic_init=False,
                         collect_hist=True)
    _assert_solve_equal(w_ref, w_port)


def test_eps_ladder_equal(instances):
    """eps0 > 1 without the analytic init: the phase ladder runs (eps
    shrinks by alpha per tighten) and every phase's counts match."""
    _, dref, dport = _get(instances, "flagship_shaped")
    alpha = 8
    out_ref = _cold(dref, ref, alpha=alpha, analytic_init=False)
    out_port = _cold(dport, port, alpha=alpha, analytic_init=False)
    assert int(port.cold_start(dport, alpha)[3]) > 1
    _assert_solve_equal(out_ref, out_port)
    assert out_port[6] >= 2, "the ladder takes more than one phase"


def test_fuse_exhaustion_equal(instances):
    """A fuse shorter than the solve needs stops both at the same state,
    uncertified."""
    _, dref, dport = _get(instances, "oversubscribed")
    full = _cold(dport, port, collect_hist=False)
    short = max(int(full[5]) // 2, 1)
    out_ref = _cold(dref, ref, max_rounds=short)
    out_port = _cold(dport, port, max_rounds=short)
    _assert_solve_equal(out_ref, out_port)
    assert out_port[5] == short
    assert not bool(out_port[4])


def test_solve_dense_reports_loop_syncs(instances):
    """The host loop's flag reads are counted: at least one per round."""
    from poseidon_tpu_torch.guards import SyncCounter

    _, _, dport = _get(instances, "graft_small")
    syncs = SyncCounter()
    state = port.solve_dense(dport, syncs=syncs)
    assert bool(state.converged)
    assert syncs.count >= state.rounds


def _bid_pass_numpy(c, p, u, btask, bvalid, eps):
    """dense_auction.py:710-746 restated in numpy (int64 throughout)."""
    INF = int(ref.INF)
    Mp = c.shape[1]
    cb = c[btask].astype(np.int64)
    vb = np.minimum(cb + p[None, :], INF)
    b1v = vb.min(axis=1)
    midx = np.arange(Mp)[None, :]
    rot = ((btask.astype(np.uint64) * 40503) % 2**32 % Mp)[:, None]
    tie_rank = (midx - rot.astype(np.int64)) % Mp
    m1 = np.argmin(np.where(vb == b1v[:, None], tie_rank, Mp + 1), axis=1)
    v2 = np.where(midx == m1[:, None], INF, vb).min(axis=1)
    ub = u[btask].astype(np.int64)
    take_uns = bvalid & (ub <= b1v)
    c1 = cb[np.arange(len(btask)), m1]
    beta = np.minimum(np.minimum(v2, ub) + eps - c1, INF - 1)
    return m1, b1v, v2, take_uns, beta


@pytest.mark.parametrize("seed", range(4))
def test_bid_pass_twin_equals_numpy_restatement(seed):
    rng = np.random.default_rng(seed)
    Tp, Mp, B = 64, 48, 40
    INF = int(ref.INF)
    # few distinct values: every row has ties, some at INF
    c = rng.choice([3, 5, 5, 9, INF], size=(Tp, Mp)).astype(np.int32)
    p = rng.choice([0, 0, 2, 4, INF], size=Mp).astype(np.int32)
    u = rng.integers(0, 12, Tp).astype(np.int32)
    btask = rng.integers(0, Tp, B).astype(np.int32)
    bvalid = rng.random(B) < 0.7                  # invalid window slots
    eps = int(rng.integers(1, 5))
    want = _bid_pass_numpy(c, p, u, btask, bvalid, eps)
    got = bid_pass_plain(*(torch.from_numpy(x) for x in (c, p, u, btask,
                                                         bvalid)),
                         torch.tensor(eps, dtype=torch.int32))
    for name, a, b in zip(("m1", "b1v", "v2", "take_uns", "beta"), want,
                          got):
        assert np.array_equal(a, b.numpy()), name
