"""Differential tests: the port's machine-class aggregation vs the
reference's (``graph/aggregate.py``), and the aggregated optimum.

The instances are those of ``tests/test_aggregate.py``: random clusters
built and priced by the reference (``tests/helpers``), their topology
and host costs fed to both packages' plan builders, ``aggregate_topology``,
``prune_topology_prefs`` and ``expand_assignment``. Every output array
must be equal (tolerance 0). Then the port solves the aggregated
instance with its own dense auction (``device="cpu"``), expands the
class assignment back to machines, and the expansion must price to the
C++ oracle's all-pairs optimum exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import poseidon_tpu.graph.aggregate as ref_agg
import poseidon_tpu.ops.transport as ref_tr
import poseidon_tpu_torch.graph.aggregate as port_agg
import poseidon_tpu_torch.ops.transport as port_tr
from poseidon_tpu.graph.builder import FlowGraphBuilder
from poseidon_tpu_torch.ops.dense_auction import (
    build_dense_instance,
    solve_dense,
)
from poseidon_tpu_torch.oracle import solve_oracle
from tests.helpers import price, random_cluster
from tests.test_torch_cost_scaling import to_port

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU loops run thousands of tiny ops; one intra-op
    thread keeps them from waiting on a pool the other test workers
    share (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _priced(rng, n_machines, n_tasks, model="quincy", preemption=False,
            **price_kw):
    cluster = random_cluster(rng, n_machines, n_tasks)
    net, meta = FlowGraphBuilder(preemption=preemption).build(cluster)
    net = price(net, meta, model, cluster, **price_kw)
    host = net.to_host()
    topo = ref_tr.extract_topology(meta, host["src"], host["dst"],
                                   host["cap"])
    return net, meta, topo, host["cost"]


def port_topo(topo) -> port_tr.TransportTopology:
    return port_tr.TransportTopology(**{
        f.name: getattr(topo, f.name)
        for f in dataclasses.fields(port_tr.TransportTopology)
    })


def assert_same(a, b):
    """Dataclasses field by field (arrays exactly, scalars equal)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def port_agg_optimum(topo, plan, cost, meta):
    """The port's aggregated solve, expanded: (expanded assignment, its
    all-pairs price)."""
    agg = port_agg.aggregate_topology(port_topo(topo), plan)
    inst = port_tr.instance_from_topology(agg, cost)
    st = solve_dense(build_dense_instance(inst, "cpu"))
    assert bool(st.converged)
    asg = st.asg.numpy()[: inst.n_tasks]
    cols = np.where((asg >= 0) & (asg < plan.n_cols), asg, -1)
    expanded = port_agg.expand_assignment(
        plan, topo.slots, meta.task_current, cols.astype(np.int32)
    )
    full = port_tr.instance_from_topology(port_topo(topo), cost)
    return expanded, port_tr.assignment_cost(full, expanded)


class TestPlans:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_plan_from_costs_equal(self, seed):
        rng = np.random.default_rng(seed)
        _net, _meta, topo, cost = _priced(rng, 12, 60)
        assert_same(port_agg.plan_from_costs(port_topo(topo), cost),
                    ref_agg.plan_from_costs(topo, cost))

    @pytest.mark.parametrize("banded", [False, True])
    def test_plan_from_signatures_equal(self, banded):
        rng = np.random.default_rng(4)
        _net, _meta, topo, _cost = _priced(rng, 10, 50)
        kw = {}
        if banded:
            load = np.round(
                np.random.default_rng(1).uniform(0, 1, 10) * 4
            ).astype(np.float32) / 4.0
            kw = dict(machine_load=load,
                      machine_mem_free=np.full(10, 0.5, np.float32),
                      machine_used_slots=np.arange(10) % 3)
        assert_same(port_agg.plan_from_signatures(port_topo(topo), **kw),
                    ref_agg.plan_from_signatures(topo, **kw))

    def test_pinned_machines_are_singletons(self):
        rng = np.random.default_rng(0)
        _net, _meta, topo, cost = _priced(rng, 10, 60)
        plan = port_agg.plan_from_costs(port_topo(topo), cost)
        for m in np.unique(topo.pref_machine[topo.pref_machine >= 0]):
            members = np.flatnonzero(
                plan.col_of_machine == plan.col_of_machine[m])
            assert members.tolist() == [m]
        assert plan.col_slots.sum() == topo.slots.sum()

    @pytest.mark.parametrize("seed", [2, 3])
    def test_aggregate_topology_equal(self, seed):
        rng = np.random.default_rng(seed)
        _net, _meta, topo, cost = _priced(rng, 16, 40)
        rplan = ref_agg.plan_from_costs(topo, cost)
        pplan = port_agg.plan_from_costs(port_topo(topo), cost)
        assert_same(port_agg.aggregate_topology(port_topo(topo), pplan),
                    ref_agg.aggregate_topology(topo, rplan))


class TestPruning:
    @pytest.mark.parametrize("k", [1, 2])
    @pytest.mark.parametrize("preemption", [False, True])
    def test_pruned_topology_equal(self, k, preemption):
        rng = np.random.default_rng(8)
        _net, meta, topo, _cost = _priced(rng, 8, 40,
                                          preemption=preemption)
        got = port_agg.prune_topology_prefs(
            port_topo(topo), meta.arc_weight, meta.arc_discount, k)
        want = ref_agg.prune_topology_prefs(
            topo, meta.arc_weight, meta.arc_discount, k)
        assert_same(got, want)

    def test_identity_when_k_covers_prefs(self):
        rng = np.random.default_rng(7)
        _net, meta, topo, _cost = _priced(rng, 10, 40)
        pt = port_topo(topo)
        assert port_agg.prune_topology_prefs(
            pt, meta.arc_weight, meta.arc_discount, topo.max_prefs) is pt


class TestExpansion:
    def test_reference_cases_equal(self):
        col = np.array([0, 0, 1], np.int32)
        args = dict(col_of_machine=col,
                    rep_machine=np.array([0, 2], np.int32),
                    col_slots=np.array([3, 2], np.int32),
                    n_machines=3, n_pinned=0)
        slots = np.array([2, 1, 2], np.int64)
        current = np.array([1, -1, 0, 2], np.int32)
        assignment = np.array([0, 0, 0, 1], np.int32)
        got = port_agg.expand_assignment(port_agg.AggregatePlan(**args),
                                         slots, current, assignment)
        want = ref_agg.expand_assignment(ref_agg.AggregatePlan(**args),
                                         slots, current, assignment)
        assert np.array_equal(got, want)
        assert got[0] == 1 and got[2] == 0 and got[3] == 2

    def test_overfull_column_raises(self):
        plan = port_agg.AggregatePlan(
            col_of_machine=np.array([0], np.int32),
            rep_machine=np.array([0], np.int32),
            col_slots=np.array([1], np.int32), n_machines=1, n_pinned=0,
        )
        with pytest.raises(ValueError, match="overfills"):
            port_agg.expand_assignment(
                plan, np.array([1], np.int64),
                np.array([-1, -1], np.int32), np.array([0, 0], np.int32))

    @pytest.mark.parametrize("seed", [5, 6])
    def test_random_expansion_equal(self, seed):
        rng = np.random.default_rng(seed)
        _net, meta, topo, cost = _priced(rng, 12, 60, preemption=True)
        plan = ref_agg.plan_from_costs(topo, cost)
        # a feasible random column assignment: fill columns in turn
        left = plan.col_slots.astype(np.int64).copy()
        asg = np.full(topo.n_tasks, -1, np.int32)
        for t in range(topo.n_tasks):
            c = int(rng.integers(plan.n_cols))
            if left[c] > 0 and rng.random() < 0.8:
                asg[t] = c
                left[c] -= 1
        pplan = port_agg.AggregatePlan(**dataclasses.asdict(plan))
        got = port_agg.expand_assignment(pplan, topo.slots,
                                         meta.task_current, asg)
        want = ref_agg.expand_assignment(plan, topo.slots,
                                         meta.task_current, asg)
        assert np.array_equal(got, want)


class TestExactness:
    """The aggregated optimum, solved by the port, equals the oracle's
    all-pairs optimum."""

    @pytest.mark.parametrize("model", ["trivial", "quincy", "octopus",
                                       "coco", "random"])
    def test_cost_plan_exact_across_models(self, model):
        rng = np.random.default_rng(3)
        for trial in range(2):
            net, meta, topo, cost = _priced(rng, 10, 50, model=model)
            oracle = solve_oracle(to_port(net), algorithm="cost_scaling")
            plan = port_agg.plan_from_costs(port_topo(topo), cost)
            expanded, got = port_agg_optimum(topo, plan, cost, meta)
            used = np.bincount(expanded[expanded >= 0],
                               minlength=topo.n_machines)
            assert (used <= topo.slots).all()
            assert got == oracle.cost, (model, trial)

    def test_signature_plan_exact_for_signature_models(self):
        rng = np.random.default_rng(4)
        for trial in range(2):
            load = np.round(
                np.random.default_rng(trial).uniform(0, 1, 10) * 4
            ).astype(np.float32) / 4.0
            net, meta, topo, cost = _priced(rng, 10, 50, model="octopus",
                                            machine_load=load)
            oracle = solve_oracle(to_port(net), algorithm="cost_scaling")
            plan = port_agg.plan_from_signatures(port_topo(topo),
                                                 machine_load=load)
            _expanded, got = port_agg_optimum(topo, plan, cost, meta)
            assert got == oracle.cost, trial


class TestTransportHelpers:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_assignment_cost_equal(self, seed):
        rng = np.random.default_rng(seed)
        _net, meta, topo, cost = _priced(rng, 10, 50)
        rinst = ref_tr.instance_from_topology(topo, cost)
        pinst = port_tr.instance_from_topology(port_topo(topo), cost)
        asg = np.where(meta.task_current >= 0, meta.task_current, -1)
        assert (port_tr.assignment_cost(pinst, asg)
                == ref_tr.assignment_cost(rinst, asg))
        assert port_tr.assignment_cost(pinst, np.full(len(asg), -1)) \
            == int(np.asarray(pinst.u).sum())

    def test_extract_instance_equal(self):
        import poseidon_tpu.synth as ref_synth
        import poseidon_tpu_torch.graph.builder as port_builder
        import poseidon_tpu_torch.models.costs as port_costs
        import poseidon_tpu_torch.synth as port_synth

        kw = dict(seed=3, prefs_per_task=2)
        rc = ref_synth.make_synthetic_cluster(12, 80, **kw)
        pc = port_synth.make_synthetic_cluster(12, 80, **kw)
        rnet, rmeta = FlowGraphBuilder().build(rc)
        rnet = price(rnet, rmeta, "quincy", rc)
        pnet, pmeta = port_builder.FlowGraphBuilder().build(pc)
        pending = pc.pending()
        inputs = port_costs.build_cost_inputs(
            pnet, pmeta, device=torch.device("cpu"),
            task_cpu_milli=np.array(
                [int(t.cpu_request * 1000) for t in pending]),
            task_mem_kb=np.array([t.memory_request_kb for t in pending]),
        )
        pnet = pnet.with_costs(port_costs.get_cost_model("quincy")(inputs))
        assert_same(port_tr.extract_instance(pnet, pmeta),
                    ref_tr.extract_instance(rnet, rmeta))
        bad = dataclasses.replace(pmeta, n_arcs=pmeta.n_arcs + 1)
        with pytest.raises(port_tr.NotSchedulingShaped):
            port_tr.extract_instance(pnet, bad)
