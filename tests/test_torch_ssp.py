"""Differential tests: the PyTorch SSP solver vs the JAX reference.

The same networks (numpy) go through ``poseidon_tpu/ops/ssp.py`` and
``poseidon_tpu_torch/ops/ssp.py`` on the CPU, where the port's kernel
wrappers (K10 ``bf_relax`` ``in``, K11 ``ssp_augment``) run their plain
twins. Every comparison is exact (tolerance 0): flows, routed, wanted,
the path count and the cost. The twins are also held against the
reference's relaxation round and path walk, restated here with
``jax.numpy``, at edge inputs: a node of degree 0, a segment of 1,500
arcs, all-INF distances, and walks over a mirror arc, into the sentinel,
from an unreachable T and round a cycle to the step cap.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ops as jops

import poseidon_tpu.ops.ssp as ref
import poseidon_tpu_torch.ops.ssp as port
from poseidon_tpu.graph.network import FlowNetwork
from poseidon_tpu.oracle import solve_oracle
from poseidon_tpu_torch.kernels.bf_relax import INF, bf_relax_in
from poseidon_tpu_torch.kernels.ssp_augment import ssp_augment
from poseidon_tpu_torch.ops.cost_scaling import residual_csr

from tests.helpers import price
from tests.test_oracle import check_flow, random_instance
from tests.test_torch_cost_scaling import edge_graph, to_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU loops run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(net: FlowNetwork, **kw):
    """Solve ``net`` with both packages; every field equal."""
    r = ref.solve_ssp(net, **kw)
    p = port.solve_ssp(to_port(net), device="cpu", **kw)
    np.testing.assert_array_equal(p.flows, np.asarray(r.flows))
    assert (p.routed, p.wanted, p.iterations) == (
        int(r.routed), int(r.wanted), int(r.iterations))
    assert p.feasible == bool(r.feasible)
    assert port.solution_cost(to_port(net), p) == ref.solution_cost(net, r)
    assert p.fetches == 1
    return p


BASICS = {
    "single_arc": ([0], [1], [5], [3], [5, -5]),
    "cheap_path_preferred": ([0, 0], [1, 1], [1, 5], [1, 10], [3, -3]),
    "infeasible_detected": ([0], [1], [2], [1], [5, -5]),
    "zero_supply": ([0], [1], [5], [3], [0, 0]),
    "negative_arc_cost": ([0, 0], [1, 1], [2, 2], [-4, 7], [3, -3]),
}


@pytest.mark.parametrize("name", sorted(BASICS))
def test_basics(name):
    assert_same(FlowNetwork.from_arrays(*BASICS[name]))


@pytest.mark.parametrize("cost", [2**29, 2**30 // 50])
def test_cost_bound_rejected(cost):
    net = FlowNetwork.from_arrays([0], [1], [1], [cost], [1, -1])
    with pytest.raises(ValueError, match="too large"):
        ref.solve_ssp(net)
    with pytest.raises(ValueError, match="too large"):
        port.solve_ssp(to_port(net), device="cpu")


@functools.lru_cache(maxsize=None)
def _random_nets(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [random_instance(rng) for _ in range(n)]


@pytest.mark.parametrize("trial", range(20))
def test_random_vs_reference_and_oracle(trial):
    """The reference's 20 seeded trials (tests/test_ssp.py)."""
    net = _random_nets(1234, 20)[trial]
    p = assert_same(net)
    assert p.feasible
    assert port.solution_cost(to_port(net), p) == solve_oracle(
        net, "ssp").cost
    check_flow(net, p.flows[: int(net.n_arcs)].astype(np.int64))


def test_larger_vs_reference():
    rng = np.random.default_rng(99)
    net = random_instance(rng, n_nodes=50, n_arcs=300, max_supply=15)
    p = assert_same(net)
    assert port.solution_cost(to_port(net), p) == solve_oracle(
        net, "cost_scaling").cost


def test_builder_graph_vs_reference():
    from poseidon_tpu.cluster import Machine, Task, make_cluster
    from poseidon_tpu.graph.builder import ArcKind, FlowGraphBuilder

    rng = np.random.default_rng(5)
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


@pytest.mark.parametrize("i", range(2))
def test_shape_bucket_pair(i):
    """tests/test_ssp.py's two instances of one padding bucket."""
    rng = np.random.default_rng(3)
    nets = [random_instance(rng), random_instance(rng)]
    assert nets[0].num_arc_slots == nets[1].num_arc_slots
    assert_same(nets[i])


def test_max_paths_bound():
    rng = np.random.default_rng(99)
    net = random_instance(rng, n_nodes=50, n_arcs=300, max_supply=15)
    p = assert_same(net, max_paths=3)
    assert p.iterations == 3


def test_synthetic_cluster_64x600():
    """make_synthetic_cluster(64, 600, seed=0) under quincy: one path a
    pod, as the reference; one read a relaxation round and a path."""
    from poseidon_tpu.graph.builder import FlowGraphBuilder
    from poseidon_tpu.synth import make_synthetic_cluster

    cluster = make_synthetic_cluster(64, 600, seed=0)
    net, meta = FlowGraphBuilder().build(cluster)
    net = price(net, meta, "quincy", cluster)
    p = assert_same(net)
    assert p.iterations == 600 and p.feasible
    assert p.loop_syncs > 2 * p.iterations


# ---- the twins against the reference's own lines ---------------------

def ref_round(fsrc, fdst, fcap, fcost, flow, pot, dist, pred):
    """ssp.py:101-116: the reduced costs and one relaxation ``round_``."""
    F, NN = len(fsrc), len(dist)
    rsrc = jnp.concatenate([fsrc, fdst])
    rdst = jnp.concatenate([fdst, fsrc])
    rcost = jnp.concatenate([fcost, -fcost])
    arc_ids = jnp.arange(2 * F, dtype=jnp.int32)
    NO_PRED = jnp.int32(2 * F)
    pot, dist, pred = jnp.asarray(pot), jnp.asarray(dist), jnp.asarray(pred)
    rc = rcost + pot[rsrc] - pot[rdst]
    cap_ok = jnp.concatenate([jnp.asarray(fcap) - flow, jnp.asarray(flow)]) > 0
    ds = dist[rsrc]
    cand = jnp.where(cap_ok & (ds < INF), ds + rc, INF)
    best = jops.segment_min(cand, rdst, num_segments=NN)
    improved = best < dist
    is_best = improved[rdst] & (cand < INF) & (cand == best[rdst])
    pred_new = jops.segment_min(jnp.where(is_best, arc_ids, NO_PRED), rdst,
                                num_segments=NN)
    pred = jnp.where(improved, pred_new, pred)
    return (np.asarray(jnp.minimum(dist, best)), np.asarray(pred),
            bool(jnp.any(improved)))


def ref_walk(fsrc, fdst, fcap, flow, pred, dist, routed, wanted, S, T):
    """ssp.py:130-157: the walk T -> S and the masked flow update."""
    F, NN = len(fsrc), len(dist)
    rsrc_ext = np.concatenate([fsrc, fdst, [T]])
    res_ext = np.concatenate([np.asarray(fcap) - flow, flow, [0]])
    v, bneck, steps = T, INF, 0
    mask = np.zeros(2 * F + 1, bool)
    while v != S and steps < NN:
        a = pred[v]
        mask[a] = True
        bneck = min(bneck, int(res_ext[a]))
        v = int(rsrc_ext[a])
        steps += 1
    delta = min(bneck, wanted - routed)
    delta = delta if dist[T] < INF and v == S else 0
    flow = flow + delta * (mask[:F].astype(np.int32)
                           - mask[F:2 * F].astype(np.int32))
    return flow, routed + delta, delta


EDGE_GRAPHS = {
    "small": (1, 40, 300, 0),
    "hub_1500": (2, 300, 4000, 1500),
    "two_nodes": (3, 2, 1, 0),
}


@pytest.mark.parametrize("d_kind", ["source", "all_inf", "mixed"])
@pytest.mark.parametrize("graph", sorted(EDGE_GRAPHS))
def test_bf_relax_in_twin_matches_reference_round(graph, d_kind):
    fsrc, fdst, fcap, fcost, flow, excess, price_ = edge_graph(
        *EDGE_GRAPHS[graph])
    fcost = fcost.astype(np.int32)
    NN, F = len(excess), len(fsrc)
    pot = (price_ % 50).astype(np.int32)
    dist = np.full(NN, INF, np.int32)
    if d_kind == "source":
        dist[0] = 0
    elif d_kind == "mixed":
        dist = np.where(excess > 0, excess * 3, INF).astype(np.int32)
    pred = np.random.default_rng(9).integers(0, 2 * F + 1, NN).astype(np.int32)
    g = residual_csr(fsrc, fdst, fcap, np.concatenate([fcost, -fcost]), NN,
                     "cpu")
    mrc = port.mirror_costs(g, torch.from_numpy(pot), torch.from_numpy(flow))
    d_out = torch.empty(NN, dtype=torch.int32)
    t_pred = torch.from_numpy(pred.copy())
    changed = torch.full((1,), 7, dtype=torch.int32)
    bf_relax_in(g.seg, g.arc, g.head, mrc, torch.from_numpy(dist), d_out,
                t_pred, changed)
    want = ref_round(fsrc, fdst, fcap, fcost, flow, pot, dist, pred)
    np.testing.assert_array_equal(d_out.numpy(), want[0])
    np.testing.assert_array_equal(t_pred.numpy(), want[1])
    assert int(changed[0]) == int(want[2])


def walk_cases():
    """A chain S -> 0 -> 1 -> ... -> 5 -> T of forward arcs 0..6, and arc
    7 from 3 to 2 carrying flow (its mirror reaches 3 from 2)."""
    S, T = 6, 7
    fsrc = np.array([S, 0, 1, 2, 3, 4, 5, 3], np.int32)
    fdst = np.array([0, 1, 2, 3, 4, 5, T, 2], np.int32)
    F = len(fsrc)
    fcap = np.array([4, 9, 8, 7, 6, 5, 10, 3], np.int32)
    flow = np.array([1, 0, 2, 0, 0, 1, 0, 2], np.int32)
    pred = np.array([0, 1, 2, 3, 4, 5, 2 * F, 6], np.int32)
    dist = np.array([1, 2, 3, 4, 5, 6, 0, 7], np.int32)
    mirror, sentinel, cycle = pred.copy(), pred.copy(), pred.copy()
    mirror[3] = 7 + F
    sentinel[4] = 2 * F
    cycle[2], cycle[3] = 3, 7 + F
    unreachable = dist.copy()
    unreachable[T] = INF
    base = (fsrc, fdst, fcap, flow)
    return {
        "path": (*base, pred, dist, 0, 10, S, T),
        "mirror": (*base, mirror, dist, 0, 10, S, T),
        "sentinel": (*base, sentinel, dist, 0, 10, S, T),
        "unreachable": (*base, pred, unreachable, 0, 10, S, T),
        "cycle": (*base, cycle, dist, 0, 10, S, T),
        "capped": (*base, pred, dist, 9, 10, S, T),
        "done": (*base, pred, dist, 10, 10, S, T),
    }


@pytest.mark.parametrize("name", sorted(walk_cases()))
def test_ssp_augment_twin_matches_reference_walk(name):
    fsrc, fdst, fcap, flow, pred, dist, routed, wanted, S, T = \
        walk_cases()[name]
    t_flow = torch.from_numpy(flow.copy())
    state = torch.tensor([routed, 0], dtype=torch.int32)
    ssp_augment(torch.from_numpy(pred), torch.from_numpy(dist),
                torch.from_numpy(fsrc), torch.from_numpy(fdst),
                torch.from_numpy(fcap), t_flow, state, wanted, S, T)
    w_flow, w_routed, w_delta = ref_walk(fsrc, fdst, fcap, flow, pred, dist,
                                         routed, wanted, S, T)
    np.testing.assert_array_equal(t_flow.numpy(), w_flow)
    assert state.tolist() == [w_routed, w_delta]
    if name in ("sentinel", "unreachable", "cycle", "done"):
        assert w_delta == 0
    else:
        assert w_delta > 0
