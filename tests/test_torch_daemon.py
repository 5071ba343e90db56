"""Differential tests: the port's scheduling daemon vs the reference.

The same scripted cluster histories go through ``poseidon_tpu``'s bridge
and CLI and through ``poseidon_tpu_torch``'s (``device="cpu"``), each
against its own package's fake apiserver. Everything but the timers must
be equal (tolerance 0): bindings, migrations, preemptions, unscheduled
sets, ``SchedulerStats``, ``decision_log`` entries (with each decision's
cost and margin), the solver's result-fetch counts, and the bindings
each CLI POSTs. The slices are:

- the ``tests/test_e2e.py`` slice (10 nodes, 100 pods) on the dense
  path, its cost also equal to the port's C++ oracle on the bridge's own
  cluster view; both CLIs' ``run_loop`` over poll/watch, serial and
  pipelined, small and dense (with preemption: tests/test_torch_watch.py);
  a failing poll skipping a tick; the integer cost-model selector;
- ``tests/test_bridge.py``'s lifecycle and pipelined-equivalence
  sequences, preemption off and on, through the oracle route and the
  dense route.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import poseidon_tpu.apiclient as ref_api
import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cli as ref_cli
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu_torch.apiclient as port_api
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cli as port_cli
import poseidon_tpu_torch.cluster as port_cluster

from tests.test_torch_graph import build_reference_oracle


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    """The reference's side of these tests can solve on its C++ oracle,
    which it builds in place on first use: have the binary whole first
    (``tests/test_torch_graph.py``'s ``build_reference_oracle``)."""
    build_reference_oracle()


REF = types.SimpleNamespace(
    api=ref_api, bridge=ref_bridge, cli=ref_cli, cluster=ref_cluster,
    kw={}, argv=[],
)
PORT = types.SimpleNamespace(
    api=port_api, bridge=port_bridge, cli=port_cli, cluster=port_cluster,
    kw={"device": "cpu"}, argv=["--device=cpu"],
)

# SchedulerStats fields that are host clock readings
TIMERS = frozenset({
    "observe_ms", "build_ms", "price_ms", "solve_ms", "decompose_ms",
    "total_ms", "dispatch_ms", "fetch_wait_ms", "overlap_ms", "wall_ms",
})


def stats_record(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in TIMERS}


def round_record(bridge, res) -> dict:
    return dict(
        bindings=dict(res.bindings),
        order=list(res.bindings),
        unscheduled=list(res.unscheduled),
        migrations=dict(res.migrations),
        preemptions=dict(res.preemptions),
        stats=stats_record(res.stats),
        fetches=bridge.solver.last_round_fetches,
    )


def bridge_state(bridge) -> dict:
    return dict(
        tasks=[dataclasses.astuple(t) for t in bridge.tasks.values()],
        machines=[dataclasses.astuple(m) for m in bridge.machines.values()],
        decision_log=list(bridge.decision_log),
        warm=bridge.warm_state is not None,
    )


def make_bridge(pkg, **kw):
    return pkg.bridge.SchedulerBridge(**kw, **pkg.kw)


def _machines(pkg, n, slots=2):
    return [
        pkg.cluster.Machine(
            name=f"m{i}", rack=f"r{i % 2}", cpu_capacity=8,
            cpu_allocatable=8, memory_capacity_kb=1 << 22,
            memory_allocatable_kb=1 << 22, max_tasks=slots,
        )
        for i in range(n)
    ]


def _pods(pkg, n, phase=None):
    phase = phase or pkg.cluster.TaskPhase.PENDING
    return [
        pkg.cluster.Task(uid=f"p{i}", job=f"j{i // 4}", cpu_request=0.5,
                         memory_request_kb=1 << 12, phase=phase)
        for i in range(n)
    ]


# ---- the bridge's lifecycle sequences (tests/test_bridge.py) ----------


def lifecycle_script(pkg, **kw):
    """Pending -> running -> succeeded, then a node removal, a revoked
    and a failed binding, with each round's record."""
    TaskPhase = pkg.cluster.TaskPhase
    bridge = make_bridge(pkg, cost_model=kw.pop("cost_model", "quincy"),
                         **kw)
    out = []
    bridge.observe_nodes(_machines(pkg, 3))
    bridge.observe_pods(_pods(pkg, 4))
    r1 = bridge.run_scheduler()
    out.append(round_record(bridge, r1))
    for uid, m in r1.bindings.items():
        bridge.confirm_binding(uid, m)
    running = [
        dataclasses.replace(t, phase=TaskPhase.RUNNING,
                            machine=r1.bindings.get(t.uid, ""))
        for t in _pods(pkg, 4)
    ]
    bridge.observe_pods(running + _pods(pkg, 8)[4:])
    r2 = bridge.run_scheduler()
    out.append(round_record(bridge, r2))
    done = [dataclasses.replace(t, phase=TaskPhase.SUCCEEDED)
            for t in running]
    still = [t for t in _pods(pkg, 8)[4:] if t.uid not in r2.bindings]
    for uid, m in r2.bindings.items():
        bridge.confirm_binding(uid, m)
    running2 = [
        dataclasses.replace(t, phase=TaskPhase.RUNNING,
                            machine=r2.bindings[t.uid])
        for t in _pods(pkg, 8)[4:] if t.uid in r2.bindings
    ]
    bridge.observe_pods(done + running2 + still)
    r3 = bridge.run_scheduler()
    out.append(round_record(bridge, r3))
    for uid, m in r3.bindings.items():
        bridge.confirm_binding(uid, m)
    # node m0 disappears: its pods flip back to pending and re-place
    bridge.observe_nodes(_machines(pkg, 3)[1:])
    r4 = bridge.run_scheduler()
    out.append(round_record(bridge, r4))
    placed = sorted(r4.bindings)
    if placed:
        bridge.confirm_binding(placed[0], r4.bindings[placed[0]])
        bridge.revoke_binding(placed[0])
    if len(placed) > 1:
        bridge.binding_failed(placed[1])
    out.append(round_record(bridge, bridge.run_scheduler()))
    out.append(bridge_state(bridge))
    return out


def restart_and_aging_script(pkg, **kw):
    """Restart reconcile (adopted running pods), aging under pressure,
    and a warm round over an unchanged pending set."""
    TaskPhase = pkg.cluster.TaskPhase
    Task = pkg.cluster.Task
    bridge = make_bridge(pkg, cost_model="quincy", **kw)
    out = []
    bridge.observe_nodes(_machines(pkg, 2, slots=3))
    running = [
        Task(uid="old0", cpu_request=0.5, phase=TaskPhase.RUNNING,
             machine="m0"),
        Task(uid="old1", cpu_request=0.5, phase=TaskPhase.RUNNING,
             machine="m0"),
    ]
    bridge.observe_pods(running + _pods(pkg, 7))
    for _ in range(3):
        res = bridge.run_scheduler()
        out.append(round_record(bridge, res))
        for uid, m in list(res.bindings.items())[:1]:
            bridge.confirm_binding(uid, m)
    bridge.observe_pods(list(bridge.tasks.values()))
    out.append(round_record(bridge, bridge.run_scheduler()))
    out.append(bridge_state(bridge))
    return out


@pytest.mark.parametrize("script", [lifecycle_script,
                                    restart_and_aging_script])
@pytest.mark.parametrize("small_to_oracle", [True, False])
@pytest.mark.parametrize("preemption", [False, True])
def test_bridge_lifecycle_equal(script, small_to_oracle, preemption):
    kw = dict(small_to_oracle=small_to_oracle, enable_preemption=preemption)
    ref = script(REF, **kw)
    port = script(PORT, **kw)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, i
    if not small_to_oracle:
        backends = {r["stats"]["backend"] for r in port[:-1]}
        assert "dense_auction" in backends


# ---- pipelined vs serial (tests/test_bridge.py) -----------------------


def _obs_stream(pkg, rounds):
    return [
        [
            pkg.cluster.Task(
                uid=f"p{r}-{i}", job=f"j{r}-{i // 3}", cpu_request=0.25,
                memory_request_kb=1 << 12,
                data_prefs={f"m{(r + i) % 5}": 60 + i},
            )
            for i in range(4 + (r % 3))
        ]
        for r in range(rounds)
    ]


def drive(pkg, pipelined, *, incremental=True, preemption=False,
          small_to_oracle=True, rounds=6):
    """The pipelined-equivalence daemon loop: per-round arrivals, pods placed
    two rounds ago finish; pipelined observes before finishing."""
    TaskPhase = pkg.cluster.TaskPhase
    bridge = make_bridge(
        pkg, cost_model="quincy", incremental_build=incremental,
        enable_preemption=preemption, small_to_oracle=small_to_oracle,
    )
    bridge.observe_nodes(_machines(pkg, 5, slots=3))
    stream = _obs_stream(pkg, rounds)
    results = []
    inflight = None

    def land(res):
        for uid, m in res.bindings.items():
            bridge.confirm_binding(uid, m)
        for uid, (_frm, to) in res.migrations.items():
            bridge.confirm_migration(uid, to)
        for uid in res.preemptions:
            bridge.confirm_preemption(uid)
        results.append(res)

    records = []
    for r in range(rounds):
        done = set(results[r - 2].bindings) if r >= 2 else set()
        bridge.observe_pods([
            dataclasses.replace(t, phase=TaskPhase.SUCCEEDED)
            if t.uid in done else t
            for t in bridge.tasks.values()
        ] + stream[r])
        if pipelined:
            if inflight is not None:
                res = bridge.finish_round(inflight)
                records.append(round_record(bridge, res))
                land(res)
            inflight = bridge.begin_round()
        else:
            res = bridge.run_scheduler()
            records.append(round_record(bridge, res))
            land(res)
    if inflight is not None:
        res = bridge.finish_round(inflight)
        records.append(round_record(bridge, res))
        land(res)
    return records, bridge_state(bridge)


@pytest.mark.parametrize("pipelined,incremental,preemption,small_to_oracle", [
    (False, True, False, True),
    (True, True, False, True),
    (True, True, True, True),
    (False, True, True, False),
    (True, True, False, False),
    (True, False, False, False),
])
def test_pipelined_rounds_equal(pipelined, incremental, preemption,
                                small_to_oracle):
    kw = dict(incremental=incremental, preemption=preemption,
              small_to_oracle=small_to_oracle)
    ref, ref_state = drive(REF, pipelined, **kw)
    port, port_state = drive(PORT, pipelined, **kw)
    assert ref == port
    assert ref_state == port_state
    if not small_to_oracle:
        # confirmed placements shift the pending order under the warm
        # state carried by task index: a warm round's stale start fails
        # to certify and re-runs cold, one fetch a solve, in both
        # packages alike
        assert 2 in [r["fetches"] for r in port]
    if pipelined:
        # and pipelining changes no decision in the port
        serial, _ = drive(PORT, False, **kw)
        for s, p in zip(serial, port):
            assert s["bindings"] == p["bindings"]
            assert s["stats"]["cost"] == p["stats"]["cost"]
            assert sorted(s["unscheduled"]) == sorted(p["unscheduled"])


def test_double_begin_raises_and_worker_error_fails_the_round():
    bridge = make_bridge(PORT, cost_model="trivial", small_to_oracle=False)
    bridge.observe_nodes(_machines(PORT, 2))
    bridge.observe_pods(_pods(PORT, 3))
    ir = bridge.begin_round()
    with pytest.raises(RuntimeError):
        bridge.begin_round()
    bridge.finish_round(ir)

    # an exception on the solver's worker surfaces in finish_round: the
    # round fails, no oracle answer stands in for it
    def boom(*_a, **_k):
        raise ValueError("worker failed")

    bridge.solver._run_chain = boom
    bridge.observe_pods(_pods(PORT, 5))
    ir = bridge.begin_round()
    assert ir.solve is not None and ir.solve.future is not None
    with pytest.raises(ValueError, match="worker failed"):
        bridge.finish_round(ir)


# ---- the e2e slice (tests/test_e2e.py) --------------------------------


def _populate(server, n_nodes=10, n_pods=100):
    for i in range(n_nodes):
        server.add_node(
            f"n{i:02d}", cpu="8", memory="16Gi", pods=12,
            rack=f"rack{i % 3}",
        )
    for j in range(n_pods):
        prefs = {f"n{j % n_nodes:02d}": 50} if j % 3 == 0 else None
        server.add_pod(
            f"pod-{j:03d}", cpu="250m", memory="256Mi",
            job=f"job{j // 8}", data_prefs=prefs,
        )


def e2e_slice(pkg):
    with pkg.api.FakeApiServer() as server:
        _populate(server)
        client = pkg.api.K8sApiClient("127.0.0.1", server.port)
        bridge = make_bridge(pkg, cost_model="quincy", small_to_oracle=False)
        bridge.observe_nodes(client.all_nodes())
        bridge.observe_pods(client.all_pods())
        view = bridge.cluster_state()
        result = bridge.run_scheduler()
        for uid, machine in result.bindings.items():
            assert client.bind_pod_to_node(uid, machine)
        bound = {p.uid: p.machine for p in client.all_pods()}
        return bridge, view, round_record(bridge, result), bound


def test_e2e_slice_equal_and_equal_to_the_oracle():
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models import build_cost_inputs, get_cost_model
    from poseidon_tpu_torch.oracle import solve_oracle

    _, _, ref, ref_bound = e2e_slice(REF)
    bridge, view, port, port_bound = e2e_slice(PORT)
    assert port == ref
    assert port_bound == ref_bound
    assert port["stats"]["backend"] == "dense_auction"
    assert port["stats"]["pods_placed"] == 100
    assert port["fetches"] == 1
    # the port's oracle on the bridge's own view of the round
    net, meta = FlowGraphBuilder().build(view)
    pending = view.pending()
    inputs = build_cost_inputs(
        net, meta, device="cpu",
        task_cpu_milli=np.array([int(t.cpu_request * 1000) for t in pending]),
        task_mem_kb=np.array([t.memory_request_kb for t in pending]),
        task_usage=bridge.knowledge.task_cpu_usage([t.uid for t in pending]),
        machine_load=bridge.knowledge.machine_load(
            [m.name for m in view.machines]),
        machine_mem_free=bridge.knowledge.machine_mem_free(
            [m.name for m in view.machines]),
    )
    o = solve_oracle(net.with_costs(get_cost_model("quincy")(inputs)),
                     algorithm="cost_scaling")
    assert port["stats"]["cost"] == o.cost


def run_cli(pkg, argv, *, n_nodes=6, n_pods=40, fail_next=0):
    """One daemon run against its own package's fake apiserver; returns
    the exit code, the POSTed bindings and the final pod states."""
    with pkg.api.FakeApiServer() as server:
        _populate(server, n_nodes=n_nodes, n_pods=n_pods)
        if fail_next:
            server.fail_next(fail_next)
        rc = pkg.cli.run_loop(pkg.cli.parse_args([
            f"--k8s_apiserver_port={server.port}",
            "--k8s_apiserver_host=127.0.0.1",
            "--polling_frequency=1000",
            *argv, *pkg.argv,
        ]))
        pods = pkg.api.K8sApiClient("127.0.0.1", server.port).all_pods()
        return rc, dict(server.bindings), {p.uid: p.machine for p in pods}


@pytest.mark.parametrize("argv,n_nodes,n_pods", [
    (["--max_rounds=3"], 6, 40),
    (["--max_rounds=3", "--round_pipeline=false",
      "--run_incremental_scheduler=false", "--incremental_build=false"],
     6, 40),
    (["--max_rounds=3", "--watch=true"], 6, 40),
    # past the small-instance bound (64 machines): the dense route
    (["--max_rounds=2", "--watch=true"], 70, 300),
    # the reference's shipped selector (6: octopus) on the dense route
    (["--max_rounds=2", "--flow_scheduling_cost_model=6"], 70, 300),
])
def test_cli_posts_the_same_bindings(argv, n_nodes, n_pods):
    ref = run_cli(REF, argv, n_nodes=n_nodes, n_pods=n_pods)
    port = run_cli(PORT, argv, n_nodes=n_nodes, n_pods=n_pods)
    assert ref[0] == port[0] == 0
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert len(port[1]) > 0


def test_poll_failure_skips_tick():
    argv = ["--flow_scheduling_cost_model=trivial", "--max_rounds=2"]
    ref = run_cli(REF, argv, n_nodes=2, n_pods=4, fail_next=10)
    port = run_cli(PORT, argv, n_nodes=2, n_pods=4, fail_next=10)
    assert ref[0] == port[0] == 0
    assert len(port[1]) == 4
    assert port[1] == ref[1]


@pytest.mark.parametrize("selector", ["0", "1", "3", "4", "5", "6"])
def test_integer_cost_model_selector(selector):
    argv = [f"--flow_scheduling_cost_model={selector}", "--max_rounds=1"]
    ref = run_cli(REF, argv, n_nodes=2, n_pods=4)
    port = run_cli(PORT, argv, n_nodes=2, n_pods=4)
    assert ref[0] == port[0] == 0
    assert port[1] == ref[1]

