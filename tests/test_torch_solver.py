"""Differential tests: the PyTorch front door vs the JAX reference.

``solve_scheduling`` of both packages on the same priced networks (the
port on the CPU, where every kernel wrapper runs its plain twin): the
dense path cold and warm, the small-instance oracle route, the general
lane for a hand-written DIMACS graph, the topology cache's cap refill,
``assignment_from_outcome`` against flow peeling, the error chain with
the oracle fallback off, and ``solve_transport_dense`` itself. Every
compared output is an integer or a string: equality is exact.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import poseidon_tpu.solver as ref
import poseidon_tpu_torch.solver as port
from poseidon_tpu.cluster import ClusterState
from poseidon_tpu.graph.builder import ArcKind, FlowGraphBuilder
from poseidon_tpu.graph.dimacs import read_dimacs as ref_read_dimacs
from poseidon_tpu.graph.network import FlowNetwork
from poseidon_tpu.ops.dense_auction import solve_transport_dense as ref_std
from poseidon_tpu.ops.transport import extract_instance
from poseidon_tpu_torch.graph.builder import FlowGraphBuilder as PortBuilder
from poseidon_tpu_torch.graph.decompose import extract_placements
from poseidon_tpu_torch.graph.dimacs import read_dimacs
from poseidon_tpu_torch.guards import GuardError
from poseidon_tpu_torch.ops.dense_auction import solve_transport_dense

from tests.helpers import price, random_cluster
from tests.test_torch_cost_scaling import to_port
from tests.test_torch_dense_auction import _port_inst
from tests.test_torch_graph import build_reference_oracle, to_port_cluster


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    """The reference's side of these tests can solve on its C++ oracle,
    which it builds in place on first use: have the binary whole first
    (``tests/test_torch_graph.py``'s ``build_reference_oracle``)."""
    build_reference_oracle()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU loops run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def priced_pair(seed: int, n_machines: int, n_tasks: int,
                model: str = "quincy"):
    """One random cluster priced by the reference, and the same network
    with the port's own builder metadata."""
    cluster = random_cluster(np.random.default_rng(seed), n_machines,
                             n_tasks)
    net, meta = FlowGraphBuilder().build(cluster)
    net = price(net, meta, model, cluster)
    _, pmeta = PortBuilder().build(to_port_cluster(cluster))
    return net, meta, to_port(net), pmeta


def assert_same_outcome(r, p):
    assert p.backend == r.backend
    assert p.cost == r.cost and p.exact == r.exact
    np.testing.assert_array_equal(p.flows, np.asarray(r.flows))
    if r.assignment is None:
        assert p.assignment is None
    else:
        np.testing.assert_array_equal(p.assignment, r.assignment)


def test_dense_path_cold_then_warm():
    net, meta, pnet, pmeta = priced_pair(21, 15, 70)
    r = ref.solve_scheduling(net, meta, small_to_oracle=False)
    p = port.solve_scheduling(pnet, pmeta, small_to_oracle=False,
                              device="cpu")
    assert p.backend == "dense_auction"
    assert_same_outcome(r, p)
    r2 = ref.solve_scheduling(net, meta, warm=r.state)
    p2 = port.solve_scheduling(pnet, pmeta, warm=p.state, device="cpu")
    assert_same_outcome(r2, p2)
    assert p2.cost == p.cost


def test_small_instance_routes_to_oracle():
    net, meta, pnet, pmeta = priced_pair(22, 10, 60, "trivial")
    r = ref.solve_scheduling(net, meta)
    p = port.solve_scheduling(pnet, pmeta, device="cpu")
    assert p.backend == "oracle:small-instance"
    assert_same_outcome(r, p)


DIMACS = ("p min 4 3\nn 1 2\nn 4 -2\n"
          "a 1 2 0 2 3\na 2 3 0 2 1\na 3 4 0 2 2\n")


def test_dimacs_graph_solves_on_the_general_lane():
    """A hand-written DIMACS graph (outside the builder taxonomy) solves
    on the general lane, cost-scaling, in both packages."""
    net = ref_read_dimacs(DIMACS)
    pnet = read_dimacs(DIMACS)
    for f in ("src", "dst", "cap", "cost", "supply"):
        np.testing.assert_array_equal(getattr(pnet, f),
                                      np.asarray(getattr(net, f)))
    assert (pnet.n_nodes, pnet.n_arcs) == (int(net.n_nodes), int(net.n_arcs))
    _, meta = FlowGraphBuilder().build(ClusterState(machines=[], tasks=[]))
    _, pmeta = PortBuilder().build(to_port_cluster(
        ClusterState(machines=[], tasks=[])))
    r = ref.solve_scheduling(net, meta)
    p = port.solve_scheduling(pnet, pmeta, device="cpu")
    assert p.backend == "cost_scaling" and p.cost == 12
    assert_same_outcome(r, p)


@pytest.mark.parametrize("text", ["p min 2 1\nn 0 5\na 1 2 0 5 1\n",
                                  "p min 2 1\nn 3 5\na 1 2 0 5 1\n"])
def test_dimacs_node_id_out_of_range(text):
    with pytest.raises(ValueError, match="out of range"):
        read_dimacs(text)


def test_general_lane_guard_error_chain():
    """With the oracle fallback off, the general lane's guard surfaces a
    RuntimeError chained from its ValueError, in both packages."""
    huge = 2**31 - 1
    net = FlowNetwork.from_arrays([0, 1], [1, 2], [huge, huge], [1, 1],
                                  [huge, 0, -huge])
    cluster = random_cluster(np.random.default_rng(5), 4, 8)
    _, meta = FlowGraphBuilder().build(cluster)
    _, pmeta = PortBuilder().build(to_port_cluster(cluster))
    with pytest.raises(RuntimeError) as r:
        ref.solve_scheduling(net, meta, oracle_fallback=False)
    with pytest.raises(RuntimeError) as p:
        port.solve_scheduling(to_port(net), pmeta, oracle_fallback=False,
                              device="cpu")
    assert isinstance(r.value.__cause__, ValueError)
    assert isinstance(p.value.__cause__, GuardError)
    assert "wrap" in str(p.value.__cause__)
    # with the fallback on, both degrade to the oracle on the guard
    r = ref.solve_scheduling(net, meta, small_to_oracle=False)
    p = port.solve_scheduling(to_port(net), pmeta, small_to_oracle=False,
                              device="cpu")
    assert p.backend == "oracle:general-guard"
    assert_same_outcome(r, p)


@pytest.mark.parametrize("lane", ["general", "dense"])
def test_launch_argument_error_is_not_degraded(lane, monkeypatch):
    """A kernel wrapper's own argument check (here: arguments that span
    devices) raises a plain ValueError at launch. It reaches the caller
    even with the oracle fallback on; only a host guard degrades."""
    from poseidon_tpu_torch.kernels import cs_sweep, densify

    def refuse(*tensors):
        raise ValueError("kernel arguments span devices ['cpu', 'cuda:0']")

    if lane == "general":
        monkeypatch.setattr(cs_sweep, "on_card", refuse)
        pnet = read_dimacs(DIMACS)
        _, pmeta = PortBuilder().build(to_port_cluster(
            ClusterState(machines=[], tasks=[])))
    else:
        monkeypatch.setattr(densify, "on_card", refuse)
        _, _, pnet, pmeta = priced_pair(21, 15, 70)
    with pytest.raises(ValueError, match="span devices") as e:
        port.solve_scheduling(pnet, pmeta, small_to_oracle=False,
                              device="cpu")
    assert not isinstance(e.value, GuardError)


def _machine_arcs(meta, m: int):
    kinds = (ArcKind.MACHINE_TO_SINK, ArcKind.CLUSTER_TO_MACHINE,
             ArcKind.RACK_TO_MACHINE)
    return np.flatnonzero(np.isin(meta.arc_kind, [int(k) for k in kinds])
                          & (meta.arc_machine == m))


@pytest.mark.parametrize("consistent", [True, False])
def test_topology_cache_cap_refill(consistent):
    """A second solve over the same meta with changed machine capacities:
    the cached topology refills its slots when the parallel caps agree
    (dense path), and is dropped for a full extraction when they do not
    (which raises, so the graph goes to the general lane)."""
    net, meta, pnet, pmeta = priced_pair(23, 12, 80)
    r1 = ref.solve_scheduling(net, meta, small_to_oracle=False)
    p1 = port.solve_scheduling(pnet, pmeta, small_to_oracle=False,
                               device="cpu")
    assert_same_outcome(r1, p1)
    cap = np.asarray(net.cap).copy()
    m = int(np.argmax(np.bincount(p1.assignment[p1.assignment >= 0],
                                  minlength=12)))
    arcs = _machine_arcs(meta, m)
    if not consistent:
        arcs = arcs[meta.arc_kind[arcs] == int(ArcKind.MACHINE_TO_SINK)]
    cap[arcs] = np.maximum(cap[arcs] - 1, 0)
    net2 = FlowNetwork.from_arrays(
        np.asarray(net.src)[: meta.n_arcs], np.asarray(net.dst)[: meta.n_arcs],
        cap[: meta.n_arcs], np.asarray(net.cost)[: meta.n_arcs],
        np.asarray(net.supply)[: meta.n_nodes])
    r2 = ref.solve_scheduling(net2, meta, small_to_oracle=False)
    p2 = port.solve_scheduling(to_port(net2), pmeta, small_to_oracle=False,
                               device="cpu")
    assert p2.backend == ("dense_auction" if consistent else "cost_scaling")
    assert_same_outcome(r2, p2)


def test_assignment_from_outcome_matches_flow_peeling():
    net, meta, pnet, pmeta = priced_pair(31, 14, 90)
    out = port.solve_scheduling(pnet, pmeta, small_to_oracle=False,
                                device="cpu")
    assert out.assignment is not None
    direct = {uid: (pmeta.machine_names[m] if m >= 0 else None)
              for uid, m in zip(pmeta.task_uids, out.assignment)}
    peeled = extract_placements(out.flows, pmeta, pnet.src, pnet.dst)
    # tasks routed through aggregators lose identity in the flow, so the
    # peeling may pair them differently: the unscheduled sets and the
    # per-machine occupancy must agree
    assert {u for u, m in direct.items() if m is None} == {
        u for u, m in peeled.items() if m is None}
    assert Counter(m for m in direct.values() if m) == Counter(
        m for m in peeled.values() if m)
    # a flow-only outcome decomposes as the reference's does
    small_net, small_meta, small_pnet, small_pmeta = priced_pair(22, 10, 60)
    r = ref.solve_scheduling(small_net, small_meta)
    p = port.solve_scheduling(small_pnet, small_pmeta, device="cpu")
    assert p.assignment is None
    np.testing.assert_array_equal(
        port.assignment_from_outcome(p, small_pmeta, small_pnet),
        ref.assignment_from_outcome(r, small_meta, small_net))
    np.testing.assert_array_equal(
        port.assignment_from_outcome(out, pmeta, pnet), out.assignment)


@pytest.mark.parametrize("n_tasks", [0, 70])
def test_solve_transport_dense_matches_reference(n_tasks):
    cluster = random_cluster(np.random.default_rng(24), 15, max(n_tasks, 3))
    if n_tasks == 0:
        cluster.tasks.clear()
    net, meta = FlowGraphBuilder().build(cluster)
    inst = extract_instance(price(net, meta, "quincy", cluster), meta)
    r, r_state = ref_std(inst)
    p, p_state = solve_transport_dense(_port_inst(inst), device="cpu")
    for f in ("assignment", "channel"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f))
    assert (p.cost, p.rounds, p.phases, p.converged) == (
        r.cost, r.rounds, r.phases, r.converged)
    assert (p_state is None) == (r_state is None)
