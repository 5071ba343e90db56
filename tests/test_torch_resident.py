"""Differential tests: the port's resident round vs the JAX reference.

The same clusters go through ``poseidon_tpu.ops.resident.ResidentSolver``
and ``poseidon_tpu_torch.ops.resident.ResidentSolver(device="cpu")``:
one cold round, then churned warm rounds (pods retired and added), for
quincy and trivial. Every outcome field and the extracted deltas must be
equal (exact), each certified round must fetch its result once, the
reference's carried warm state must reproduce the reference's next
round in the port, and the degrade paths must reach the port's oracle
with the reference's backend strings.
"""

import dataclasses

import numpy as np
import pytest
import torch

import poseidon_tpu.graph.deltas as ref_deltas
import poseidon_tpu.models.costs as ref_costs
import poseidon_tpu_torch.graph.deltas as port_deltas
import poseidon_tpu_torch.models.costs as port_costs
from poseidon_tpu.cluster import ClusterState, Task
from poseidon_tpu.graph.builder import ArcKind
from poseidon_tpu.graph.builder import FlowGraphBuilder as RefBuilder
from poseidon_tpu.ops.resident import ResidentSolver as RefSolver
from poseidon_tpu.synth import make_synthetic_cluster
from poseidon_tpu_torch.graph.builder import FlowGraphBuilder as PortBuilder
from poseidon_tpu_torch.ops.resident import ResidentSolver as PortSolver

from tests.helpers import random_cluster
from tests.test_torch_graph import delta_rows, to_port_cluster

FIELDS_ARRAY = ("assignment", "channel", "task_cost", "task_margin")
FIELDS_SCALAR = ("cost", "backend", "converged", "rounds", "phases")


def _kwargs(cluster):
    pending = cluster.pending()
    return dict(
        task_cpu_milli=np.array([int(t.cpu_request * 1000) for t in pending]),
        task_mem_kb=np.array([t.memory_request_kb for t in pending]),
    )


def _round(solver, builder, cluster, model):
    arrays, meta = builder().build_arrays(cluster)
    out = solver.run_round(arrays, meta, cost_model=model,
                           cost_input_kwargs=_kwargs(cluster))
    return out, meta


def _assert_outcomes_equal(ro, po, rmeta, pmeta):
    for f in FIELDS_SCALAR:
        assert getattr(ro, f) == getattr(po, f), f
    for f in FIELDS_ARRAY:
        a, b = getattr(ro, f), getattr(po, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f
    rd = ref_deltas.extract_deltas(rmeta, ro.assignment,
                                   task_cost=ro.task_cost,
                                   task_margin=ro.task_margin)
    pd = port_deltas.extract_deltas(pmeta, po.assignment,
                                    task_cost=po.task_cost,
                                    task_margin=po.task_margin)
    assert delta_rows(rd) == delta_rows(pd)


def churn(cluster, round_no, fraction=0.05):
    """Retire ``fraction`` of the pods at random and add as many new
    ones, shaped like the synth's (rack-affine preferences when the
    cluster's pods carry preferences), seeded by the round number."""
    rng = np.random.default_rng(1000 + round_no)
    tasks = list(cluster.tasks)
    k = max(int(len(tasks) * fraction), 1)
    drop = set(rng.choice(len(tasks), size=k, replace=False).tolist())
    kept = [t for i, t in enumerate(tasks) if i not in drop]
    with_prefs = any(t.data_prefs for t in tasks)
    racks = sorted({m.rack for m in cluster.machines})
    for j in range(k):
        prefs = {}
        if with_prefs:
            home = racks[int(rng.integers(len(racks)))]
            in_home = [m.name for m in cluster.machines if m.rack == home]
            for n in rng.choice(in_home, size=min(2, len(in_home)),
                                replace=False):
                prefs[str(n)] = int(rng.integers(20, 200))
        kept.append(Task(
            uid=f"pod-r{round_no}-{j:05d}", job=f"job-r{round_no}-{j // 8}",
            cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
            memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
            data_prefs=prefs, wait_rounds=int(rng.integers(0, 4)),
        ))
    return ClusterState(machines=cluster.machines, tasks=kept)


# per model, a 64-machine x 600-pod cluster the dense path certifies
# cold and warm: quincy over the flagship's shape with running pods;
# trivial over an oversubscribed cluster without preference arcs
SEQUENCE_CLUSTERS = {
    "quincy": dict(running_fraction=0.2),
    "trivial": dict(prefs_per_task=0, max_tasks_per_machine=8),
}


def _sequence(model="quincy"):
    clusters = [make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8,
                                       **SEQUENCE_CLUSTERS[model])]
    for r in (1, 2, 3):
        clusters.append(churn(clusters[-1], r))
    return clusters


@pytest.mark.parametrize("model", ["quincy", "trivial"])
def test_cold_and_warm_rounds_equal(model):
    ref = RefSolver(small_to_oracle=False)
    port = PortSolver(device="cpu", small_to_oracle=False)
    for r, cluster in enumerate(_sequence(model)):
        ro, rmeta = _round(ref, RefBuilder, cluster, model)
        po, pmeta = _round(port, PortBuilder, to_port_cluster(cluster),
                           model)
        _assert_outcomes_equal(ro, po, rmeta, pmeta)
        assert po.backend == "dense_auction" and po.converged, r
        assert port.last_round_fetches == ref.last_round_fetches == 1, r
        assert port.last_round_loop_syncs >= po.rounds
        assert (port.warm is not None) == (ref.warm is not None)
        for a, b in zip(ref.warm_seed_host, port.warm_seed_host):
            assert np.array_equal(a, b)
        assert port.pad_floors == ref.pad_floors


def test_warm_state_carries_across():
    """The reference's floors and warm seed, restored into a fresh port
    solver, give the reference's next (warm) round."""
    clusters = _sequence()[:2]
    ref = RefSolver(small_to_oracle=False)
    _round(ref, RefBuilder, clusters[0], "quincy")
    port = PortSolver(device="cpu", small_to_oracle=False)
    port.restore_for_replay(ref.pad_floors, ref.warm_seed_host)
    assert port.warm is not None
    ro, rmeta = _round(ref, RefBuilder, clusters[1], "quincy")
    po, pmeta = _round(port, PortBuilder, to_port_cluster(clusters[1]),
                       "quincy")
    _assert_outcomes_equal(ro, po, rmeta, pmeta)
    assert po.backend == "dense_auction"
    # a warm start re-settles in one phase and few rounds
    cold = PortSolver(device="cpu", small_to_oracle=False)
    pc, _ = _round(cold, PortBuilder, to_port_cluster(clusters[1]), "quincy")
    assert pc.cost == po.cost and pc.rounds != po.rounds


def _hot_ref(inputs):
    import jax.numpy as jnp

    uns = ((inputs.kind == int(ArcKind.TASK_TO_UNSCHED))
           | (inputs.kind == int(ArcKind.UNSCHED_TO_SINK)))
    return ref_costs._finish(
        inputs, jnp.where(uns, ref_costs.COST_CAP, 0).astype(jnp.int32)
    )


def _hot_port(inputs):
    uns = ((inputs.kind == int(ArcKind.TASK_TO_UNSCHED))
           | (inputs.kind == int(ArcKind.UNSCHED_TO_SINK)))
    return port_costs._finish(
        inputs, torch.where(uns, port_costs.COST_CAP, 0).to(torch.int32)
    )


def test_cost_domain_overflow_degrades_to_oracle():
    """Placement free, unsched maximally expensive: u = 2*COST_CAP blows
    the auction's domain at T ~ 3.4k; both solvers fall back to their
    C++ oracle with the same backend string and the same optimum."""
    ref_costs.COST_MODELS["_test_hot"] = _hot_ref
    port_costs.COST_MODELS["_test_hot"] = _hot_port
    try:
        cluster = make_synthetic_cluster(16, 3500, seed=3, prefs_per_task=0,
                                         max_tasks_per_machine=256)
        ro, rmeta = _round(RefSolver(small_to_oracle=False), RefBuilder,
                           cluster, "_test_hot")
        port = PortSolver(device="cpu", small_to_oracle=False)
        po, pmeta = _round(port, PortBuilder, to_port_cluster(cluster),
                           "_test_hot")
    finally:
        ref_costs.COST_MODELS.pop("_test_hot", None)
        port_costs.COST_MODELS.pop("_test_hot", None)
    assert po.backend == ro.backend == "oracle:cost-domain"
    _assert_outcomes_equal(ro, po, rmeta, pmeta)
    # the round's result fetch, then the arc table for the oracle
    assert port.last_round_fetches == 2
    assert port.warm is None


def test_uncertified_round_degrades_to_oracle():
    """Trivial pricing with preference arcs ties so much that the
    auction does not certify within a short fuse; both stop at the fuse
    and fall back the same way."""
    cluster = make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8,
                                     prefs_per_task=1)
    ro, rmeta = _round(RefSolver(small_to_oracle=False, max_rounds=300),
                       RefBuilder, cluster, "trivial")
    po, pmeta = _round(PortSolver(device="cpu", small_to_oracle=False,
                                  max_rounds=300),
                       PortBuilder, to_port_cluster(cluster), "trivial")
    assert po.backend == ro.backend == "oracle:uncertified"
    _assert_outcomes_equal(ro, po, rmeta, pmeta)


def test_memory_envelope_degrades_to_oracle(monkeypatch):
    """A dense table over the budget degrades before any device work,
    and the grow-only floors reset, in both packages alike."""
    import poseidon_tpu.ops.dense_auction as ref_da
    import poseidon_tpu_torch.ops.dense_auction as port_da

    monkeypatch.setattr(ref_da, "DENSE_TABLE_BUDGET_BYTES", 1 << 10)
    monkeypatch.setattr(port_da, "DENSE_TABLE_BUDGET_BYTES", 1 << 10)
    cluster = _sequence()[0]
    ref = RefSolver(small_to_oracle=False)
    port = PortSolver(device="cpu", small_to_oracle=False)
    ro, rmeta = _round(ref, RefBuilder, cluster, "quincy")
    po, pmeta = _round(port, PortBuilder, to_port_cluster(cluster), "quincy")
    assert po.backend == ro.backend == "oracle:memory-envelope"
    _assert_outcomes_equal(ro, po, rmeta, pmeta)
    assert port.pad_floors == ref.pad_floors
    assert port.last_round_fetches == 1


@pytest.mark.parametrize("seed", range(3))
def test_small_instance_routes_to_oracle(seed):
    cluster = random_cluster(np.random.default_rng(seed), 6, 40)
    ro, rmeta = _round(RefSolver(), RefBuilder, cluster, "quincy")
    po, pmeta = _round(PortSolver(device="cpu"), PortBuilder,
                       to_port_cluster(cluster), "quincy")
    assert po.backend == "oracle:small-instance"
    _assert_outcomes_equal(ro, po, rmeta, pmeta)


def test_non_taxonomy_graph_degrades_to_oracle():
    cluster = random_cluster(np.random.default_rng(53), 5, 20)
    outs = []
    for solver, builder, c in (
        (RefSolver(), RefBuilder, cluster),
        (PortSolver(device="cpu"), PortBuilder, to_port_cluster(cluster)),
    ):
        arrays, meta = builder().build_arrays(c)
        arcs = np.where(meta.arc_kind == int(ArcKind.MACHINE_TO_SINK))[0]
        bad = meta.arc_machine.copy()
        bad[arcs[0]] = -1  # unlabeled: trips NotSchedulingShaped
        meta = dataclasses.replace(meta, arc_machine=bad)
        outs.append(solver.run_round(arrays, meta, cost_model="trivial"))
    ro, po = outs
    assert po.backend == ro.backend == "oracle:not-scheduling-shaped"
    assert po.topology is None and po.cost == ro.cost
    assert np.array_equal(po.assignment, ro.assignment)
    assert np.array_equal(po.channel, ro.channel)


def test_unported_options_raise():
    """The scale lane's options are ported now: each constructs, and a
    mesh width on the CPU lays the mesh out over the CPU."""
    solver = PortSolver(device="cpu", mesh_width=2)
    assert solver.mesh_width == 2
    assert solver._mesh.devices == (torch.device("cpu"),) * 2
    assert PortSolver(device="cpu", aggregate_classes=True).aggregate_classes
    assert PortSolver(device="cpu", topk_prefs=2).topk_prefs == 2
    with pytest.raises(ValueError, match="power of two"):
        PortSolver(device="cpu", mesh_width=3)
