"""Failure-domain survival: the port's degradation ladder and chaos
harness against the reference's.

The analogue of ``tests/test_chaos.py`` with its seeds and shapes, over
``poseidon_tpu_torch`` (``device="cpu"``, ``--device=cpu``):

- unit: the client's retry classes, the mass-eviction guard's grace
  exit, the staged displaced-pod re-queue, the actuation outbox and
  the watch subsystem's bounded memory under an outage;
- the daemon loop: the round-deadline watchdog and the express shed;
- scenarios: ``poseidon_tpu_torch.chaos`` drives the port's daemon
  through the reference's acceptance scenarios at their own sizes and
  seeds, and the invariants hold; the same scenario through both
  packages' harnesses and daemons applies the same faults;
- the scaled scenario (``scenario_composite(nodes=80, pods=320)``,
  above the small-instance threshold, so its rounds run the dense
  path, the one ``chip_smoke.py`` ``[chaos]`` runs on the card): in
  both daemons the same applied faults, the same dense rounds, the
  same final pod -> node map, and the invariants held, with a dense
  round after every fault;
- fuzz (slow, as the reference marks it): the scenarios across seeds.
"""

from __future__ import annotations

import time

import pytest

import poseidon_tpu.chaos as ref_chaos
import poseidon_tpu.chaos.scenarios as ref_scenarios
from poseidon_tpu_torch.apiclient import FakeApiServer, K8sApiClient
from poseidon_tpu_torch.apiclient.client import backoff_delay
from poseidon_tpu_torch.apiclient.watch import ClusterWatcher
from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.chaos import (
    check_invariants,
    rounds_to_recover,
    run_daemon_scenario,
    scenario_apiserver_outage,
    scenario_composite,
    scenario_node_storm,
    scenario_overload_burst,
)
from poseidon_tpu_torch.chaos.scenarios import SCENARIOS
from poseidon_tpu_torch.cluster import Machine, Task, TaskPhase
from poseidon_tpu_torch.ha import ActuationOutbox, OutageDetector
from poseidon_tpu_torch.obs import MetricsRegistry, SchedulerMetrics

from tests.test_torch_graph import build_reference_oracle

CPU = ("--device=cpu",)

# the scaled scenario chip_smoke.py [chaos] runs on the card: the
# composite at 80 nodes (> the oracle's 64-machine threshold, and 67
# still after its 13-node storm) x 320 pods, the reference scenario's
# own seed and fault schedule
SCALED = dict(nodes=80, pods=320)


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    build_reference_oracle()


def _machines(n: int, prefix: str = "n") -> list[Machine]:
    return [
        Machine(name=f"{prefix}{i}", cpu_capacity=8.0,
                cpu_allocatable=8.0, max_tasks=10)
        for i in range(n)
    ]


def _bridge(**kw) -> SchedulerBridge:
    return SchedulerBridge(cost_model="trivial", device="cpu", **kw)


# ---------------------------------------------------------------------------
# client: the hung apiserver is its own retry class
# ---------------------------------------------------------------------------


class TestClientRetryStats:
    def test_timeout_counted_distinctly_from_5xx(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            client = K8sApiClient(
                port=server.port, timeout_s=0.15, retries=1,
                backoff_base_s=0.01, backoff_cap_s=0.02,
            )
            server.delay_next(2, seconds=1.0)
            with pytest.raises(Exception):
                client.all_nodes()
            assert client.retry_stats["timeout"] >= 1
            assert client.retry_stats["5xx"] == 0
            server.delay_next(0, 0)
            server.fail_next(2)
            with pytest.raises(Exception):
                client.all_nodes()
            assert client.retry_stats["5xx"] >= 1

    def test_429_and_transport_classes(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            client = K8sApiClient(
                port=server.port, timeout_s=1.0, retries=1,
                backoff_base_s=0.01, backoff_cap_s=0.02,
            )
            server.rate_limit_next(1, retry_after_s=0.01)
            client.all_nodes()
            assert client.retry_stats["429"] == 1
            server.disconnect_next(1)
            client.all_nodes()
            assert client.retry_stats["transport"] >= 1

    def test_backoff_delay_bounded_with_jitter(self):
        for attempt in (0, 3, 10, 60):
            for _ in range(50):
                d = backoff_delay(attempt, base_s=0.05, cap_s=2.0)
                assert d <= 2.0 * 1.5 + 1e-9
                assert d >= 0


# ---------------------------------------------------------------------------
# the mass-eviction guard: grace exit + observability
# ---------------------------------------------------------------------------


class TestGuardGraceExit:
    def test_grace_window_accepts_before_strikes(self):
        metrics = SchedulerMetrics(MetricsRegistry())
        bridge = _bridge(shrink_grace_s=0.05, metrics=metrics)
        bridge.observe_nodes(_machines(10))
        assert len(bridge.machines) == 10
        survivors = _machines(10)[:3]
        bridge.observe_nodes(survivors)        # strike 1: held
        assert len(bridge.machines) == 10
        time.sleep(0.06)
        bridge.observe_nodes(survivors)        # grace elapsed: accept
        assert len(bridge.machines) == 3
        events = [e.event for e in bridge.trace.events]
        assert "EVICTION_GUARD_HOLD" in events
        rel = [e for e in bridge.trace.events
               if e.event == "EVICTION_GUARD_RELEASE"]
        assert rel and rel[-1].detail["outcome"] == "accepted"
        assert rel[-1].detail["kind"] == "node"
        text = metrics.registry.render()
        assert 'poseidon_eviction_guard_holds_total{kind="node"} 1' \
            in text
        assert ('poseidon_eviction_guard_releases_total'
                '{kind="node",outcome="accepted"} 1') in text
        assert 'poseidon_eviction_guard_active{kind="node"} 0' in text

    def test_recovered_release_when_snapshot_heals(self):
        metrics = SchedulerMetrics(MetricsRegistry())
        bridge = _bridge(shrink_grace_s=60.0, metrics=metrics)
        full = _machines(10)
        bridge.observe_nodes(full)
        bridge.observe_nodes(full[:3])         # strike 1: held
        assert bridge._node_shrink_strikes == 1
        bridge.observe_nodes(full)             # healed
        assert bridge._node_shrink_strikes == 0
        rel = [e for e in bridge.trace.events
               if e.event == "EVICTION_GUARD_RELEASE"]
        assert rel and rel[-1].detail["outcome"] == "recovered"
        assert len(bridge.machines) == 10
        text = metrics.registry.render()
        assert ('poseidon_eviction_guard_releases_total'
                '{kind="node",outcome="recovered"} 1') in text

    def test_strikes_exit_still_works(self):
        bridge = _bridge(shrink_grace_s=3600.0)
        full = _machines(10)
        bridge.observe_nodes(full)
        survivors = full[:3]
        bridge.observe_nodes(survivors)
        bridge.observe_nodes(survivors)
        assert len(bridge.machines) == 10      # still held
        bridge.observe_nodes(survivors)        # strike 3: accepted
        assert len(bridge.machines) == 3


# ---------------------------------------------------------------------------
# staged displaced-pod re-queue
# ---------------------------------------------------------------------------


class TestStagedRequeue:
    def _bridge_with_running(self, n_nodes=4, per_node=3, budget=4):
        bridge = _bridge(max_migrations_per_round=budget)
        bridge.observe_nodes(_machines(n_nodes))
        pods = []
        for i in range(n_nodes):
            for j in range(per_node):
                pods.append(Task(
                    uid=f"p{i}-{j}", phase=TaskPhase.RUNNING,
                    machine=f"n{i}", cpu_request=0.1,
                ))
        bridge.observe_pods(pods)
        return bridge

    def test_rack_loss_drains_in_budget_waves(self):
        bridge = self._bridge_with_running(
            n_nodes=4, per_node=3, budget=4,
        )
        for name in ("n1", "n2", "n3"):
            bridge.observe_node_event("DELETED", Machine(name=name))
        assert all(
            bridge.tasks[f"p{i}-{j}"].phase == TaskPhase.PENDING
            for i in (1, 2, 3) for j in range(3)
        )
        admitted = []
        for _ in range(4):
            r = bridge.run_scheduler()
            admitted.append(r.stats.requeue_admitted)
            for uid, m in r.bindings.items():
                bridge.confirm_binding(uid, m)
        assert admitted[:3] == [4, 4, 1]
        assert bridge._displaced_parked == {}
        evict_events = [
            e for e in bridge.trace.events if e.event == "EVICT"
        ]
        assert len(evict_events) == 9
        assert all(e.detail["parked"] for e in evict_events)

    def test_small_removal_admitted_same_tick(self):
        bridge = self._bridge_with_running(
            n_nodes=4, per_node=3, budget=64,
        )
        bridge.observe_node_event("DELETED", Machine(name="n3"))
        r = bridge.run_scheduler()
        assert r.stats.requeue_admitted == 3
        assert r.stats.displaced_parked == 0

    def test_parked_pod_deleted_while_waiting(self):
        bridge = self._bridge_with_running(
            n_nodes=2, per_node=4, budget=2,
        )
        bridge.observe_node_event("DELETED", Machine(name="n1"))
        assert len(bridge._displaced_parked) == 4
        parked = list(bridge._displaced_parked)
        bridge.observe_pod_event("DELETED", bridge.tasks[parked[0]])
        bridge.observe_pod_event("DELETED", bridge.tasks[parked[1]])
        assert len(bridge._displaced_parked) == 2
        r = bridge.run_scheduler()
        assert r.stats.requeue_admitted == 2
        assert bridge._displaced_parked == {}

    def test_parked_pods_excluded_from_cluster_view(self):
        bridge = self._bridge_with_running(
            n_nodes=2, per_node=4, budget=1,
        )
        bridge.observe_node_event("DELETED", Machine(name="n1"))
        cluster = bridge.cluster_state()
        assert len(cluster.tasks) == 4
        assert len(bridge.tasks) == 8


# ---------------------------------------------------------------------------
# the actuation outbox
# ---------------------------------------------------------------------------


class TestOutbox:
    def test_park_and_replay_exactly_once(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            server.add_pod("p0")
            client = K8sApiClient(
                port=server.port, timeout_s=1.0, retries=0,
                backoff_base_s=0.01, backoff_cap_s=0.02,
            )
            settled = []
            outbox = ActuationOutbox(
                client, base_backoff_s=0.01, cap_backoff_s=0.05,
                on_settled=lambda e, o: settled.append((e.uid, o)),
            )
            server.set_outage(True)
            assert client.bind_outcome("default/p0", "n0") \
                == "unreachable"
            outbox.enqueue("bind", "default/p0", machine="n0")
            time.sleep(0.08)
            counts = outbox.pump()
            assert counts["waiting"] == 1
            assert outbox.pending == 1
            server.set_outage(False)
            time.sleep(0.12)
            counts = outbox.pump()
            assert counts["replayed"] == 1
            assert settled == [("default/p0", "replayed")]
            assert outbox.pending == 0
            server.apply_pending()
            assert server.bindings == [("default/p0", "n0")]
            outbox.enqueue("bind", "default/p0", machine="n0")
            time.sleep(0.03)
            counts = outbox.pump()
            assert counts["already-applied"] == 1
            assert server.bindings == [("default/p0", "n0")]

    def test_recovery_drains_whole_backlog_in_one_pump(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            for i in range(6):
                server.add_pod(f"p{i}")
            client = K8sApiClient(port=server.port, timeout_s=1.0,
                                  retries=0)
            outbox = ActuationOutbox(
                client, base_backoff_s=5.0, cap_backoff_s=10.0,
            )
            for i in range(6):
                outbox.enqueue("bind", f"default/p{i}", machine="n0")
            counts = outbox.pump(force=True)
            assert counts["replayed"] == 6
            assert outbox.pending == 0

    def test_dead_letter_on_rejection(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            server.add_pod("p0", node="n1-gone", phase="Running")
            client = K8sApiClient(port=server.port, retries=0)
            dead = []
            outbox = ActuationOutbox(
                client, base_backoff_s=0.01,
                on_dead_letter=lambda e: dead.append(e.uid),
            )
            outbox.enqueue("bind", "default/p0", machine="n0")
            time.sleep(0.03)
            outbox.pump()
            assert dead == ["default/p0"]
            assert outbox.pending == 0
            assert outbox.dead_letters_total == 1

    def test_outage_detector_one_episode(self):
        flips = []
        det = OutageDetector(3, on_change=flips.append)
        for _ in range(2):
            det.note_failure()
        assert not det.active
        det.note_failure()
        assert det.active and flips == [True]
        for _ in range(5):
            det.note_failure()
        assert det.episodes == 1
        det.note_success()
        assert not det.active and flips == [True, False]


# ---------------------------------------------------------------------------
# watch subsystem under a long outage: bounded memory
# ---------------------------------------------------------------------------


class TestWatchOutageBounded:
    def test_reconnect_queue_stays_bounded(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            server.add_pod("p0")
            client = K8sApiClient(port=server.port, timeout_s=0.5)
            watcher = ClusterWatcher(
                client, max_lag_s=30.0,
                backoff_base_s=0.005, backoff_cap_s=0.01,
            )
            try:
                watcher.tick()
                server.set_outage(True)
                time.sleep(0.6)
                for stream in watcher._streams.values():
                    assert stream.queue.qsize() <= 3, (
                        stream.resource, stream.queue.qsize(),
                    )
                total_coalesced = sum(
                    s.coalesced_reconnects
                    for s in watcher._streams.values()
                )
                assert total_coalesced >= 5
                server.set_outage(False)
                delta = watcher.tick()
                assert delta.reconnects >= total_coalesced
            finally:
                watcher.stop()

    def test_no_resync_storm_from_quiet_outage(self):
        with FakeApiServer() as server:
            server.add_node("n0")
            client = K8sApiClient(port=server.port, timeout_s=0.5)
            watcher = ClusterWatcher(
                client, max_lag_s=30.0,
                backoff_base_s=0.005, backoff_cap_s=0.01,
            )
            try:
                watcher.tick()
                server.set_outage(True)
                for _ in range(5):
                    time.sleep(0.02)
                    watcher.tick()
                assert watcher.resyncs_total == 0
            finally:
                watcher.stop()


# ---------------------------------------------------------------------------
# the daemon loop: watchdog + express shed
# ---------------------------------------------------------------------------


class TestWatchdogAndShed:
    def test_round_deadline_watchdog_traces_misses(self, tmp_path):
        from poseidon_tpu_torch.cli import parse_args, run_loop
        from poseidon_tpu_torch.trace import read_trace

        with FakeApiServer() as server:
            for i in range(3):
                server.add_node(f"n{i}")
            for i in range(6):
                server.add_pod(f"p{i}")
            trace_path = str(tmp_path / "trace.jsonl")
            args = parse_args([
                f"--k8s_apiserver_port={server.port}",
                "--polling_frequency=20000",
                "--max_rounds=6",
                "--round_deadline_ms=0.0001",
                f"--trace_log={trace_path}",
                *CPU,
            ])
            assert run_loop(args) == 0
        misses = [
            e for e in read_trace(trace_path)
            if e.event == "ROUND_DEADLINE_MISS"
        ]
        assert len(misses) >= 2
        assert misses[-1].detail["consecutive"] >= 2

    def test_express_shed_on_deep_queue(self):
        with FakeApiServer() as server:
            server.add_node("n0", pods=200)
            client = K8sApiClient(port=server.port, timeout_s=1.0)
            watcher = ClusterWatcher(client, max_lag_s=30.0)
            try:
                watcher.tick()
                for i in range(40):
                    server.add_pod(f"burst-{i:03d}")
                assert watcher.wait_caught_up(server.current_rv())
                ev = watcher.express_poll(0.2, max_events=16, shed_queue=8)
                assert ev.shed and ev.needs_tick
                assert ev.pod_events == []
                delta = watcher.tick()
                assert len(delta.pod_events) == 40
            finally:
                watcher.stop()


# ---------------------------------------------------------------------------
# the seeded scenarios (the acceptance ladder, single-seed fast pass)
# ---------------------------------------------------------------------------


def run_port(sc, workdir):
    workdir.mkdir(parents=True, exist_ok=True)
    return run_daemon_scenario(
        sc, str(workdir), polling_ms=25.0, extra_flags=CPU
    )


def run_ref(sc, workdir):
    workdir.mkdir(parents=True, exist_ok=True)
    return ref_chaos.run_daemon_scenario(sc, str(workdir), polling_ms=25.0)


class TestScenarios:
    def test_node_storm_survival(self, tmp_path):
        run = run_port(scenario_node_storm(), tmp_path)
        rep = check_invariants(
            run, expect_guard=True, guard_release_rounds=5,
        )
        rep.assert_ok()
        admits = [r.get("requeue_admitted", 0) for r in run.stats]
        assert max(admits) <= 12
        assert sum(admits) >= 12

    def test_apiserver_outage_survival(self, tmp_path):
        run = run_port(scenario_apiserver_outage(), tmp_path)
        check_invariants(run).assert_ok()
        phases = [
            (e.detail or {}).get("phase")
            for e in run.trace_events if e.event == "OUTAGE"
        ]
        assert phases == ["begin", "end"]
        assert sum(r.get("bind_failures", 0) for r in run.stats) == 0
        assert any(r.get("outbox_pending", 0) > 0 for r in run.stats)

    def test_writes_down_outage_does_not_flap(self, tmp_path):
        from poseidon_tpu_torch.chaos.scenarios import (
            ChaosScenario,
            FaultAction,
        )

        sc = ChaosScenario(
            name="writes_down", seed=7,
            actions=(
                FaultAction(1, "outage_begin", {"writes_only": True}),
                FaultAction(12, "outage_end"),
            ),
            rounds=60, fault_clear_round=12, recover_within=47,
            nodes=8, pods=24,
        )
        run = run_port(sc, tmp_path)
        check_invariants(run).assert_ok()
        phases = [
            (e.detail or {}).get("phase")
            for e in run.trace_events if e.event == "OUTAGE"
        ]
        assert phases == ["begin", "end"], (
            f"outage flapped despite healthy reads: {phases}"
        )

    def test_overload_burst_survival(self, tmp_path):
        run = run_port(scenario_overload_burst(), tmp_path)
        check_invariants(run).assert_ok()
        placed = max(r.get("pods_placed", 0) for r in run.stats)
        assert placed >= 150

    def test_composite_survival(self, tmp_path):
        run = run_port(SCENARIOS["composite"](), tmp_path)
        check_invariants(run).assert_ok()
        assert rounds_to_recover(
            run.stats, run.scenario.fault_clear_round
        ) is not None


def final_map(run) -> dict[str, str]:
    return {
        key: doc.get("spec", {}).get("nodeName", "")
        for key, doc in sorted(run.server.pods.items())
    }


class TestAgainstReference:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_same_scenario_same_faults(self, tmp_path, name):
        """The port's harness builds the reference's scenario (same
        schedule, sizes and seed) and applies the same faults to its
        daemon as the reference's harness does to the reference's."""
        port_sc = SCENARIOS[name]()
        ref_sc = ref_scenarios.SCENARIOS[name]()
        assert port_sc.actions == tuple(
            type(port_sc.actions[0])(a.at_round, a.kind, dict(a.args))
            for a in ref_sc.actions
        )
        for f in ("name", "seed", "rounds", "fault_clear_round",
                  "recover_within", "nodes", "pods", "flags"):
            assert getattr(port_sc, f) == getattr(ref_sc, f), f
        if name == "composite":
            return  # 90 rounds; TestScenarios runs it in the port
        port = run_port(port_sc, tmp_path / "port")
        ref = run_ref(ref_sc, tmp_path / "ref")
        assert port.applied == ref.applied
        check_invariants(port).assert_ok()
        ref_chaos.check_invariants(ref).assert_ok()

    def test_scaled_composite_on_the_dense_path(self, tmp_path):
        """The scenario chip_smoke.py [chaos] runs on the card, above
        the small-instance threshold: both daemons apply the same
        faults, end with the same pod -> node map, and hold the
        invariants; every round with pending pods ran the dense path,
        and a dense round follows every fault: the burst whose POSTs
        ride into the outage, the storm's staged drain and the
        post-fault burst (after ``fault_clear_round``)."""
        port = run_port(scenario_composite(**SCALED), tmp_path / "p")
        ref = run_ref(ref_chaos.scenario_composite(**SCALED), tmp_path / "r")
        check_invariants(port).assert_ok()
        ref_chaos.check_invariants(ref).assert_ok()
        assert port.applied == ref.applied
        assert final_map(port) == final_map(ref)
        busy = [r for r in port.stats if r["pods_pending"]]
        assert {r["backend"] for r in busy} == {"dense_auction"}
        dense = [r["round_num"] for r in busy]
        assert dense == [r["round_num"] for r in ref.stats
                         if r["pods_pending"]]
        assert [(r["pods_pending"], r["pods_placed"]) for r in busy] == [
            (r["pods_pending"], r["pods_placed"]) for r in ref.stats
            if r["pods_pending"]]
        for at, kind, _ in port.applied:
            assert any(d > at for d in dense), (at, kind, dense)
        assert max(dense) >= port.scenario.fault_clear_round
        assert rounds_to_recover(
            port.stats, port.scenario.fault_clear_round
        ) == rounds_to_recover(ref.stats, ref.scenario.fault_clear_round)


@pytest.mark.slow
class TestScenarioFuzz:
    """The same invariants across seeds — a failed seed reproduces
    exactly (the orchestrator is schedule+seed deterministic)."""

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_node_storm_seeds(self, tmp_path, seed):
        run = run_port(scenario_node_storm(seed=seed), tmp_path)
        check_invariants(
            run, expect_guard=True, guard_release_rounds=5,
        ).assert_ok()

    @pytest.mark.parametrize("seed", [4, 5])
    def test_outage_seeds(self, tmp_path, seed):
        run = run_port(scenario_apiserver_outage(seed=seed), tmp_path)
        check_invariants(run).assert_ok()
