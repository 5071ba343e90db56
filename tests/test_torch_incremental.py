"""Differential tests: the port's incremental graph builder.

The churn sequences of ``tests/test_incremental.py`` (place-only) and
``tests/test_rebalance.py`` (rebalancing mode) drive a bridge of each
package. At every checkpoint the bridge's ``IncrementalFlowGraphBuilder``
must build arrays and metadata bit-identical to a fresh
``FlowGraphBuilder`` over the same live cluster, with
``topology_from_columns`` equal to ``extract_topology`` over the
assembled arrays — in each package — and the port's incremental arrays,
metadata, topology and build modes must equal the reference's (exact,
dtypes included).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.graph.builder as ref_builder
import poseidon_tpu.ops.transport as ref_transport
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.graph.builder as port_builder
import poseidon_tpu_torch.ops.transport as port_transport

REF = types.SimpleNamespace(bridge=ref_bridge, cluster=ref_cluster,
                            builder=ref_builder, transport=ref_transport,
                            kw={})
PORT = types.SimpleNamespace(bridge=port_bridge, cluster=port_cluster,
                             builder=port_builder, transport=port_transport,
                             kw={"device": "cpu"})
HYST = 20


def _plain(x):
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    return x


def _fields(obj) -> dict:
    return {f.name: _plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def graph_record(pkg, bridge, preemption=False) -> dict:
    """The bridge's incremental build over its live cluster, checked
    against a fresh build in the same package."""
    cluster = bridge.cluster_state()
    inc = bridge._graph
    arrays, meta = inc.build_arrays(cluster)
    fresh = pkg.builder.FlowGraphBuilder(
        preemption=preemption, migration_hysteresis=HYST,
    )
    fresh_arrays, fresh_meta = fresh.build_arrays(cluster)
    rec_arrays = {k: _plain(arrays[k]) for k in ("src", "dst", "cap",
                                                 "supply")}
    assert rec_arrays == {k: _plain(fresh_arrays[k])
                          for k in ("src", "dst", "cap", "supply")}
    rec_meta = _fields(meta)
    assert rec_meta == _fields(fresh_meta)
    t_ext = pkg.transport.extract_topology(
        meta, arrays["src"], arrays["dst"], arrays["cap"]
    )
    t_cols = pkg.transport.topology_from_columns(inc.columns)
    rec_topo = _fields(t_cols)
    for f in dataclasses.fields(t_ext):
        a, b = getattr(t_ext, f.name), getattr(t_cols, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    return dict(mode=inc.last_build_mode, arrays=rec_arrays, meta=rec_meta,
                topology=rec_topo)


# ---- place-only churn (tests/test_incremental.py) ---------------------


def _bridge(pkg, n_machines=6, slots=3, **kw):
    bridge = pkg.bridge.SchedulerBridge(cost_model="quincy", **kw, **pkg.kw)
    bridge.observe_nodes([
        pkg.cluster.Machine(
            name=f"m{i}", rack=f"r{i % 2}", cpu_capacity=8,
            cpu_allocatable=8, memory_capacity_kb=1 << 22,
            memory_allocatable_kb=1 << 22, max_tasks=slots,
        )
        for i in range(n_machines)
    ])
    return bridge


def _pods(pkg, start, n, job_size=3, prefs=True):
    return [
        pkg.cluster.Task(
            uid=f"pod-{i}", job=f"job-{i // job_size}",
            cpu_request=0.25 + (i % 4) / 10,
            memory_request_kb=1 << (12 + i % 3),
            data_prefs=(
                {f"m{i % 6}": 50 + i, f"r{i % 2}": 20} if prefs else {}
            ),
        )
        for i in range(start, start + n)
    ]


def add_remove_confirm_age(pkg):
    TaskPhase = pkg.cluster.TaskPhase
    bridge = _bridge(pkg)
    out = []
    bridge.observe_pods(_pods(pkg, 0, 12))
    out.append(graph_record(pkg, bridge))
    r1 = bridge.run_scheduler()
    for uid, m in r1.bindings.items():
        bridge.confirm_binding(uid, m)
    out.append(graph_record(pkg, bridge))
    placed = sorted(r1.bindings)
    bridge.observe_pods([
        dataclasses.replace(t, phase=TaskPhase.SUCCEEDED)
        if t.uid in placed[:2] else t
        for t in bridge.tasks.values()
    ] + _pods(pkg, 12, 7))
    out.append(graph_record(pkg, bridge))
    r2 = bridge.run_scheduler()
    for uid, m in r2.bindings.items():
        bridge.confirm_binding(uid, m)
    out.append(graph_record(pkg, bridge))
    return out


def job_disappearance_and_reorder(pkg):
    TaskPhase = pkg.cluster.TaskPhase
    bridge = _bridge(pkg)
    out = []
    bridge.observe_pods(_pods(pkg, 0, 10, job_size=2))
    out.append(graph_record(pkg, bridge))
    for gone in (("pod-0", "pod-2"), ("pod-4", "pod-5")):
        bridge.observe_pods([
            dataclasses.replace(t, phase=TaskPhase.SUCCEEDED)
            if t.uid in gone else t
            for t in bridge.tasks.values()
        ])
        out.append(graph_record(pkg, bridge))
    return out


def restart_and_node_churn(pkg):
    TaskPhase = pkg.cluster.TaskPhase
    Task, Machine = pkg.cluster.Task, pkg.cluster.Machine
    bridge = _bridge(pkg)
    out = []
    running = [
        Task(uid="old0", cpu_request=0.5, phase=TaskPhase.RUNNING,
             machine="m0"),
        Task(uid="old1", cpu_request=0.5, phase=TaskPhase.RUNNING,
             machine="m1"),
    ]
    bridge.observe_pods(running + _pods(pkg, 0, 6))
    out.append(graph_record(pkg, bridge))
    bridge.observe_nodes([
        bridge.machines[f"m{i}"] for i in range(6) if i != 1
    ])
    out.append(graph_record(pkg, bridge))
    bridge.observe_nodes(
        list(bridge.machines.values())
        + [Machine(name="m9", rack="r1", max_tasks=3)]
    )
    out.append(graph_record(pkg, bridge))
    bridge.run_scheduler()
    out.append(graph_record(pkg, bridge))
    return out


def fuzz_churn(pkg):
    """Randomized add/finish/confirm sequences (seeded)."""
    TaskPhase, Task = pkg.cluster.TaskPhase, pkg.cluster.Task
    rng = np.random.default_rng(11)
    bridge = _bridge(pkg, n_machines=8, slots=2)
    out = []
    counter = 0
    for _step in range(12):
        n_new = int(rng.integers(0, 6))
        new = [
            Task(
                uid=f"f{counter + i}",
                job=f"fj{(counter + i) // max(1, int(rng.integers(1, 4)))}",
                cpu_request=float(rng.choice([0.1, 0.5])),
                memory_request_kb=1 << 12,
                data_prefs=(
                    {f"m{int(rng.integers(0, 8))}": 40}
                    if rng.random() < 0.5 else {}
                ),
            )
            for i in range(n_new)
        ]
        counter += n_new
        uids = list(bridge.tasks)
        done = set(
            rng.choice(uids, size=min(len(uids), int(rng.integers(0, 3))),
                       replace=False).tolist()
        ) if uids else set()
        bridge.observe_pods([
            dataclasses.replace(t, phase=TaskPhase.SUCCEEDED)
            if t.uid in done else t
            for t in bridge.tasks.values()
        ] + new)
        out.append(graph_record(pkg, bridge))
        result = bridge.run_scheduler()
        for uid, m in result.bindings.items():
            if rng.random() < 0.9:
                bridge.confirm_binding(uid, m)
        out.append(graph_record(pkg, bridge))
    return out


# ---- rebalancing churn (tests/test_rebalance.py) ----------------------


def _rebal_bridge(pkg, **kw):
    kw.setdefault("max_migrations_per_round", 0)
    return pkg.bridge.SchedulerBridge(
        cost_model="quincy", enable_preemption=True,
        migration_hysteresis=HYST, **kw, **pkg.kw,
    )


def _rebal_machines(pkg, n, slots=4):
    return [
        pkg.cluster.Machine(
            name=f"m{i}", rack=f"r{i % 2}", cpu_capacity=8,
            cpu_allocatable=8, memory_capacity_kb=1 << 22,
            memory_allocatable_kb=1 << 22, max_tasks=slots)
        for i in range(n)
    ]


def _drifted_running(pkg, n):
    return [
        pkg.cluster.Task(
            uid=f"q{i}", job="jr", phase=pkg.cluster.TaskPhase.RUNNING,
            machine=f"m{i % 2}", cpu_request=0.25,
            data_prefs={f"m{2 + i % 2}": 200})
        for i in range(n)
    ]


def rebalance_lifecycle(pkg):
    TaskPhase, Task = pkg.cluster.TaskPhase, pkg.cluster.Task
    bridge = _rebal_bridge(pkg)
    out = []
    bridge.observe_nodes(_rebal_machines(pkg, 4, slots=3))
    pend = [Task(uid=f"p{i}", job=f"j{i // 2}", cpu_request=0.25,
                 data_prefs={f"m{i % 4}": 80}) for i in range(6)]
    bridge.observe_pods(pend + _drifted_running(pkg, 4))
    out.append(graph_record(pkg, bridge, True))
    r1 = bridge.run_scheduler()
    out.append(dict(bindings=r1.bindings, migrations=r1.migrations,
                    preemptions=r1.preemptions))
    for uid, m in r1.bindings.items():
        bridge.confirm_binding(uid, m)
    out.append(graph_record(pkg, bridge, True))
    for uid, (_frm, to) in r1.migrations.items():
        bridge.confirm_migration(uid, to)
    out.append(graph_record(pkg, bridge, True))
    snapshot = []
    moved = updated = retired = None
    for t in bridge.tasks.values():
        if t.phase == TaskPhase.RUNNING and retired is None:
            retired = t.uid
            snapshot.append(dataclasses.replace(t, phase=TaskPhase.SUCCEEDED))
        elif t.phase == TaskPhase.RUNNING and moved is None:
            moved = t.uid
            snapshot.append(dataclasses.replace(t, machine="m3"))
        elif t.phase == TaskPhase.RUNNING and updated is None:
            updated = t.uid
            snapshot.append(dataclasses.replace(t, cpu_request=0.5))
        else:
            snapshot.append(t)
    bridge.observe_pods(snapshot)
    out.append(graph_record(pkg, bridge, True))
    running = [u for u, t in bridge.tasks.items()
               if t.phase == TaskPhase.RUNNING]
    bridge.confirm_preemption(running[0])
    out.append(graph_record(pkg, bridge, True))
    return out


def rebalance_fuzz(pkg):
    """Randomized rebalancing churn: arrivals, placements, migrations,
    preemptions, finishes, observed moves and reshapes (seeded)."""
    TaskPhase, Task = pkg.cluster.TaskPhase, pkg.cluster.Task
    rng = np.random.default_rng(1234)
    bridge = _rebal_bridge(pkg, max_migrations_per_round=3)
    bridge.observe_nodes(_rebal_machines(pkg, 5, slots=4))
    next_uid = [0]
    out = []

    def arrivals(n):
        got = []
        for _ in range(n):
            i = next_uid[0]
            next_uid[0] += 1
            got.append(Task(
                uid=f"p{i:03d}", job=f"j{i % 4}",
                cpu_request=0.1 + (i % 3) / 10,
                data_prefs=(
                    {f"m{i % 5}": int(rng.integers(50, 250))}
                    if rng.random() < 0.7 else {}
                ),
            ))
        return got

    bridge.observe_pods(arrivals(8))
    for _step in range(12):
        r = bridge.run_scheduler()
        out.append(dict(bindings=r.bindings, migrations=r.migrations,
                        preemptions=r.preemptions, cost=r.stats.cost))
        for uid, m in r.bindings.items():
            if rng.random() < 0.9:
                bridge.confirm_binding(uid, m)
            else:
                bridge.binding_failed(uid)
        for uid, (frm, to) in r.migrations.items():
            if rng.random() < 0.9:
                bridge.confirm_migration(uid, to)
            else:
                bridge.restore_running(uid, frm)
        for uid in r.preemptions:
            bridge.confirm_preemption(uid)
        snapshot = []
        for t in bridge.tasks.values():
            roll = rng.random()
            if t.phase == TaskPhase.RUNNING and roll < 0.15:
                snapshot.append(dataclasses.replace(
                    t, phase=TaskPhase.SUCCEEDED))
            elif t.phase == TaskPhase.RUNNING and roll < 0.25:
                snapshot.append(dataclasses.replace(
                    t, machine=f"m{int(rng.integers(0, 5))}"))
            elif t.phase == TaskPhase.RUNNING and roll < 0.32:
                snapshot.append(dataclasses.replace(
                    t, cpu_request=round(rng.random(), 2)))
            elif roll > 0.03:
                snapshot.append(t)
        bridge.observe_pods(snapshot + arrivals(int(rng.integers(0, 4))))
        out.append(graph_record(pkg, bridge, True))
    return out


@pytest.mark.parametrize("script", [
    add_remove_confirm_age, job_disappearance_and_reorder,
    restart_and_node_churn, fuzz_churn, rebalance_lifecycle,
    rebalance_fuzz,
])
def test_incremental_builds_equal_reference(script):
    ref = script(REF)
    port = script(PORT)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, i
    modes = [r["mode"] for r in port if "mode" in r]
    assert "delta" in modes or script is job_disappearance_and_reorder


def test_delta_build_modes_match_reference_expectations():
    """The place-only sequence takes the modes the reference's own test
    pins: a cold full build, then delta builds through placement,
    confirm, aging and arrival churn."""
    modes = [r["mode"] for r in add_remove_confirm_age(PORT)]
    assert modes == ["full", "delta", "delta", "delta"]
    modes = [r["mode"] for r in restart_and_node_churn(PORT)]
    assert modes[1:] == ["full", "full", "delta"]
