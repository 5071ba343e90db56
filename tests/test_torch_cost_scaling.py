"""Differential tests: the PyTorch cost-scaling solver vs the JAX reference.

The same networks (numpy) go through ``poseidon_tpu/ops/cost_scaling.py``
and ``poseidon_tpu_torch/ops/cost_scaling.py`` on the CPU, where the
port's kernel wrappers (K9 ``cs_sweep``, K10 ``bf_relax``) run their plain
twins. Every output is an integer, so every comparison is exact
(tolerance 0): flows, routed, wanted, sweeps, phases, converged and the
cost. The twins are also held against the reference's own sweep and
Bellman-Ford lines, restated here with ``jax.numpy``, at edge inputs: a
node of degree 0, a segment of 1,500 arcs, negative reduced costs at
eps > 1, all-INF distances.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ops as jops

import poseidon_tpu.ops.cost_scaling as ref
import poseidon_tpu_torch.ops.cost_scaling as port
from poseidon_tpu.compat import enable_x64
from poseidon_tpu.graph.network import FlowNetwork
from poseidon_tpu.oracle import solve_oracle
from poseidon_tpu_torch.graph.network import FlowNetwork as PortNet
from poseidon_tpu_torch.kernels.bf_relax import INF_K, bf_relax_out
from poseidon_tpu_torch.kernels.cs_sweep import cs_sweep

from tests.helpers import price
from tests.test_oracle import check_flow, random_instance


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU loops run thousands of tiny ops; one intra-op
    thread keeps them from waiting on a pool the other test workers
    share (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(net: FlowNetwork) -> PortNet:
    """The same padded network as the port's host arrays."""
    return PortNet(
        src=np.asarray(net.src), dst=np.asarray(net.dst),
        cap=np.asarray(net.cap), cost=np.asarray(net.cost),
        supply=np.asarray(net.supply), n_nodes=int(net.n_nodes),
        n_arcs=int(net.n_arcs),
    )


def assert_same(net: FlowNetwork, **kw):
    """Solve ``net`` with both packages; every field equal. Returns the
    port's result."""
    r = ref.solve_cost_scaling(net, **kw)
    p = port.solve_cost_scaling(to_port(net), device="cpu", **kw)
    np.testing.assert_array_equal(p.flows, np.asarray(r.flows))
    assert (p.routed, p.wanted, p.sweeps, p.phases, p.converged) == (
        int(r.routed), int(r.wanted), int(r.sweeps), int(r.phases),
        bool(r.converged))
    assert p.feasible == bool(r.feasible)
    assert port.solution_cost(to_port(net), p) == ref.solution_cost(net, r)
    assert p.fetches == 1
    return p


BASICS = {
    "single_arc": ([0], [1], [5], [3], [5, -5]),
    "cheap_path_preferred": ([0, 0], [1, 1], [1, 5], [1, 10], [3, -3]),
    "infeasible_reported": ([0], [1], [2], [1], [5, -5]),
    "zero_supply": ([0], [1], [5], [3], [0, 0]),
    "negative_cost": ([0, 0], [1, 1], [2, 2], [-4, 7], [3, -3]),
}


@pytest.mark.parametrize("name", sorted(BASICS))
def test_basics(name):
    p = assert_same(FlowNetwork.from_arrays(*BASICS[name]))
    assert p.converged


@functools.lru_cache(maxsize=None)
def _random_nets(seed: int, n: int, **kw):
    rng = np.random.default_rng(seed)
    return [random_instance(rng, **kw) for _ in range(n)]


@pytest.mark.parametrize("trial", range(20))
def test_random_vs_reference_and_oracle(trial):
    """The reference's 20 seeded trials (tests/test_cost_scaling.py)."""
    net = _random_nets(777, 20)[trial]
    p = assert_same(net)
    assert p.converged and p.feasible
    assert port.solution_cost(to_port(net), p) == solve_oracle(
        net, "cost_scaling").cost
    check_flow(net, p.flows[: int(net.n_arcs)].astype(np.int64))


def test_larger_vs_reference():
    rng = np.random.default_rng(31)
    net = random_instance(rng, n_nodes=50, n_arcs=300, max_supply=15)
    p = assert_same(net)
    assert port.solution_cost(to_port(net), p) == solve_oracle(
        net, "cost_scaling").cost


def test_builder_graph_vs_reference():
    from poseidon_tpu.cluster import Machine, Task, make_cluster
    from poseidon_tpu.graph.builder import ArcKind, FlowGraphBuilder

    rng = np.random.default_rng(8)
    cluster = make_cluster(
        [Machine(name=f"m{i}", rack=f"r{i % 3}", max_tasks=4)
         for i in range(6)],
        [Task(uid=f"p{i}", job=f"j{i % 3}",
              data_prefs={f"m{rng.integers(6)}": 10})
         for i in range(20)],
    )
    net, meta = FlowGraphBuilder().build(cluster)
    h = net.to_host()
    cost = rng.integers(0, 100, size=meta.n_arcs)
    cost[meta.arc_kind == ArcKind.TASK_TO_UNSCHED] = 1000
    net = FlowNetwork.from_arrays(h["src"], h["dst"], h["cap"], cost,
                                  h["supply"])
    p = assert_same(net)
    assert port.solution_cost(to_port(net), p) == solve_oracle(
        net, "ssp").cost


def test_synthetic_cluster_64x600_counts():
    """make_synthetic_cluster(64, 600, seed=0) under quincy: the
    reference's 896 sweeps and 11 phases, reproduced exactly."""
    from poseidon_tpu.graph.builder import FlowGraphBuilder
    from poseidon_tpu.synth import make_synthetic_cluster

    cluster = make_synthetic_cluster(64, 600, seed=0)
    net, meta = FlowGraphBuilder().build(cluster)
    net = price(net, meta, "quincy", cluster)
    p = assert_same(net)
    assert (p.sweeps, p.phases, p.converged, p.feasible) == (
        896, 11, True, True)
    # one read a refine burst, one a Bellman-Ford burst
    assert 0 < p.loop_syncs < p.sweeps


def test_wrapping_capacity_rejected():
    huge = 2**30 - 1
    net = FlowNetwork.from_arrays([0, 0], [1, 1], [huge, huge], [1, 2],
                                  [0, 0])
    with pytest.raises(ValueError, match="wrap"):
        ref.solve_cost_scaling(net)
    with pytest.raises(ValueError, match="wrap"):
        port.solve_cost_scaling(to_port(net), device="cpu")


def _fuzz_nets():
    """tests/test_advice_fixes.py's unreachable-node price fuzz: two
    weakly connected halves, nodes often without a residual path to any
    deficit."""
    rng = np.random.default_rng(4242)
    nets = []
    for _ in range(10):
        n = int(rng.integers(6, 14))
        m = int(rng.integers(n, 3 * n))
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        cap = rng.integers(1, 8, len(src))
        cost = rng.integers(0, 60, len(src))
        supply = np.zeros(n, np.int64)
        a, b = rng.choice(n, 2, replace=False)
        supply[a], supply[b] = 3, -3
        nets.append(FlowNetwork.from_arrays(src, dst, cap, cost, supply))
    return nets


@pytest.mark.parametrize("i", range(10))
def test_unreachable_node_price_fuzz(i):
    p = assert_same(_fuzz_nets()[i])
    assert p.converged


def test_max_sweeps_fuse():
    """A blown fuse reports converged=False with the same counts."""
    rng = np.random.default_rng(31)
    net = random_instance(rng, n_nodes=50, n_arcs=300, max_supply=15)
    p = assert_same(net, max_sweeps=32)
    assert not p.converged


# ---- the twins against the reference's own lines ---------------------

def edge_graph(seed: int, NN: int, F: int, hub: int):
    """Random residual tables: node NN - 1 has no arc (degree 0), node 1
    is the tail of ``hub`` forward arcs, costs of both signs, random
    flows within capacity, excesses and prices."""
    rng = np.random.default_rng(seed)
    fsrc = rng.integers(0, NN - 1, F).astype(np.int32)
    fdst = rng.integers(0, NN - 1, F).astype(np.int32)
    fsrc[:hub] = 1
    fcap = rng.integers(0, 10, F).astype(np.int32)
    fcost = rng.integers(-400, 400, F).astype(np.int64)
    flow = np.minimum((rng.random(F) * (fcap + 1)).astype(np.int32), fcap)
    excess = rng.integers(-6, 9, NN).astype(np.int32)
    price_ = rng.integers(-900, 900, NN).astype(np.int64)
    return fsrc, fdst, fcap, fcost, flow, excess, price_


def ref_sweep(fsrc, fdst, fcap, fcost, flow, excess, price_, eps):
    """cost_scaling.py:120-170 (``sweep``), on arc-ordered tables."""
    F, NN = len(fsrc), len(excess)
    with enable_x64(True):
        rsrc = jnp.concatenate([fsrc, fdst])
        rdst = jnp.concatenate([fdst, fsrc])
        rcost = jnp.concatenate([fcost, -fcost])
        arc_ids = jnp.arange(2 * F, dtype=jnp.int32)
        SENT = jnp.int32(2 * F)
        flow, excess, price_ = (jnp.asarray(flow), jnp.asarray(excess),
                                jnp.asarray(price_))
        res = jnp.concatenate([jnp.asarray(fcap) - flow, flow])
        rc = rcost + price_[rsrc] - price_[rdst]
        active = excess > 0
        adm = (res > 0) & (rc < 0) & active[rsrc]
        adm_amt = jnp.where(adm, res, 0).astype(jnp.int64)
        total = jops.segment_sum(adm_amt, rsrc, num_segments=NN)
        exc64 = excess.astype(jnp.int64)
        prop = jnp.minimum(
            adm_amt, (exc64[rsrc] * adm_amt) // jnp.maximum(total[rsrc], 1))
        sum_prop = jops.segment_sum(prop, rsrc, num_segments=NN)
        choice = jops.segment_min(jnp.where(adm, arc_ids, SENT), rsrc,
                                  num_segments=NN)
        is_chosen = adm & (arc_ids == choice[rsrc])
        leftover = (exc64 - sum_prop)[rsrc]
        extra = jnp.where(is_chosen, jnp.minimum(adm_amt - prop, leftover), 0)
        push32 = (prop + extra).astype(jnp.int32)
        flow = flow + push32[:F] - push32[F:]
        out = jops.segment_sum(push32, rsrc, num_segments=NN)
        inn = jops.segment_sum(push32, rdst, num_segments=NN)
        excess = excess + inn - out
        has_adm = jops.segment_max(adm.astype(jnp.int32), rsrc,
                                   num_segments=NN) > 0
        price_ = jnp.where(active & ~has_adm, price_ - eps, price_)
        return np.asarray(flow), np.asarray(excess), np.asarray(price_)


def ref_bf_round(fsrc, fdst, fcap, fcost, flow, price_, eps, d):
    """cost_scaling.py:188-200: the arc lengths and one ``bf_round``."""
    NN = len(d)
    with enable_x64(True):
        rsrc = jnp.concatenate([fsrc, fdst])
        rdst = jnp.concatenate([fdst, fsrc])
        rcost = jnp.concatenate([fcost, -fcost])
        res = jnp.concatenate([jnp.asarray(fcap) - flow, jnp.asarray(flow)])
        p = jnp.asarray(price_)
        rc = rcost + p[rsrc] - p[rdst]
        INF = jnp.int64(2**50)
        ln = jnp.where(res > 0, jnp.maximum(0, rc // eps + 1), INF)
        d = jnp.asarray(d)
        via = jnp.where((res > 0) & (d[rdst] < INF), d[rdst] + ln, INF)
        best = jops.segment_min(via, rsrc, num_segments=NN)
        new = jnp.minimum(d, best)
        return np.asarray(new), bool(jnp.any(new < d))


EDGE_GRAPHS = {
    "small": (1, 40, 300, 0),
    "hub_1500": (2, 300, 4000, 1500),
    "two_nodes": (3, 2, 1, 0),
    "hub_1100_sparse": (4, 1100, 3000, 1100),
}


def _csr(fsrc, fdst, fcap, fcost, NN):
    return port.residual_csr(fsrc, fdst, fcap,
                             np.concatenate([fcost, -fcost]), NN, "cpu")


@pytest.mark.parametrize("eps", [1, 3, 64])
@pytest.mark.parametrize("graph", sorted(EDGE_GRAPHS))
def test_cs_sweep_twin_matches_reference_sweep(graph, eps):
    fsrc, fdst, fcap, fcost, flow, excess, price_ = edge_graph(
        *EDGE_GRAPHS[graph])
    NN = len(excess)
    g = _csr(fsrc, fdst, fcap, fcost, NN)
    seg = g.seg.numpy()
    if graph == "hub_1500":
        assert seg[2] - seg[1] > 1024
    assert seg[NN] - seg[NN - 1] == 0       # the degree-0 node
    t_flow = torch.from_numpy(flow.copy())
    e_out = torch.empty(NN, dtype=torch.int32)
    p_out = torch.empty(NN, dtype=torch.int64)
    cs_sweep(g.seg, g.arc, g.head, g.cost, g.fcap, t_flow,
             torch.from_numpy(excess), torch.from_numpy(price_), eps,
             e_out, p_out)
    want = ref_sweep(fsrc, fdst, fcap, fcost, flow, excess, price_, eps)
    np.testing.assert_array_equal(t_flow.numpy(), want[0])
    np.testing.assert_array_equal(e_out.numpy(), want[1])
    np.testing.assert_array_equal(p_out.numpy(), want[2])


@pytest.mark.parametrize("d_kind", ["deficits", "all_inf", "zeros"])
@pytest.mark.parametrize("eps", [1, 3, 64])
@pytest.mark.parametrize("graph", sorted(EDGE_GRAPHS))
def test_bf_relax_out_twin_matches_reference_round(graph, eps, d_kind):
    fsrc, fdst, fcap, fcost, flow, excess, price_ = edge_graph(
        *EDGE_GRAPHS[graph])
    NN = len(excess)
    d = {"deficits": np.where(excess < 0, 0, INF_K),
         "all_inf": np.full(NN, INF_K),
         "zeros": np.zeros(NN)}[d_kind].astype(np.int64)
    g = _csr(fsrc, fdst, fcap, fcost, NN)
    ln = port.arc_lengths(g, torch.from_numpy(flow),
                          torch.from_numpy(price_), eps)
    d_out = torch.empty(NN, dtype=torch.int64)
    changed = torch.full((1,), 7, dtype=torch.int32)
    bf_relax_out(g.seg, g.head, ln, torch.from_numpy(d), d_out, changed)
    new, ch = ref_bf_round(fsrc, fdst, fcap, fcost, flow, price_, eps, d)
    np.testing.assert_array_equal(d_out.numpy(), new)
    assert int(changed[0]) == int(ch)


def test_csr_segments_hold_ascending_arc_ids():
    """The stable sort by tail leaves each segment in arc-id order, so a
    node's first admissible position is its lowest admissible arc."""
    fsrc, fdst, fcap, fcost, *_ = edge_graph(*EDGE_GRAPHS["hub_1500"])
    g = _csr(fsrc, fdst, fcap, fcost, 300)
    seg, arc = g.seg.numpy(), g.arc.numpy()
    rsrc = np.concatenate([fsrc, fdst])
    for v in range(300):
        ids = arc[seg[v]:seg[v + 1]]
        assert (np.diff(ids) > 0).all()
        assert (rsrc[ids] == v).all()
