"""The quality observatory: the port's shadow audit and SLO engine
against the reference's.

The analogue of ``tests/test_observatory.py``'s audit and SLO parts
(and its restart-lifecycle case, which rides the journal) with its
seeds and shapes, over ``poseidon_tpu_torch`` (``device="cpu"``):

- shadow audit: regret is bit-zero on a certified steady state,
  positive on the config-6 drift cluster (through EMPTY place-only
  rounds too), and falls to zero as rebalancing settles — each audit
  equal to the reference's on the same cluster (costs, regret, drift,
  fragmentation); the audit's pricing asks for the CPU explicitly;
- SLO engine: grammar, multi-window burn rates, the breach latch
  firing exactly once per breach window, ``/slo`` — each evaluation's
  status equal to the reference engine's on the same metric history;
- the daemon: ``--audit_every``, ``--slo`` and ``--metrics_port``
  together serve ``/slo`` and record the audit's regret.
"""

import dataclasses
import json
import time
import types
import urllib.error
import urllib.request

import pytest

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.obs as ref_obs
import poseidon_tpu.obs.slo as ref_slo
import poseidon_tpu.synth as ref_synth
import poseidon_tpu.trace as ref_trace
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.obs as port_obs
import poseidon_tpu_torch.obs.slo as port_slo
import poseidon_tpu_torch.synth as port_synth
import poseidon_tpu_torch.trace as port_trace
from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.cluster import Task
from poseidon_tpu_torch.obs import (
    HealthState,
    LifecycleTracker,
    ObsServer,
    ShadowAuditor,
    SloEngine,
)
from poseidon_tpu_torch.obs.slo import SloParseError, parse_objective
from poseidon_tpu_torch.synth import config6_rebalance, make_synthetic_cluster
from poseidon_tpu_torch.trace import TraceGenerator

from tests.test_torch_graph import build_reference_oracle

REF = types.SimpleNamespace(
    name="ref", bridge=ref_bridge, obs=ref_obs, slo=ref_slo,
    synth=ref_synth, trace=ref_trace, kw={},
)
PORT = types.SimpleNamespace(
    name="port", bridge=port_bridge, obs=port_obs, slo=port_slo,
    synth=port_synth, trace=port_trace, kw={"device": "cpu"},
)


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    build_reference_oracle()


def _metrics(pkg=PORT):
    return pkg.obs.SchedulerMetrics(pkg.obs.MetricsRegistry())


def _settle(br, rounds=1):
    last = None
    for _ in range(rounds):
        last = br.run_scheduler()
        for uid, mach in last.bindings.items():
            br.confirm_binding(uid, mach)
        for uid, (_f, to) in last.migrations.items():
            br.confirm_migration(uid, to)
        for uid in last.preemptions:
            br.confirm_preemption(uid)
    return last


def audit_view(res) -> dict:
    d = dataclasses.asdict(res)
    d.pop("audit_ms")
    return d


# ---------------------------------------------------------------------------
# the shadow audit
# ---------------------------------------------------------------------------


def steady_state_audit(pkg):
    aud = pkg.obs.ShadowAuditor(sample_every=1, background=False)
    br = pkg.bridge.SchedulerBridge(
        cost_model="quincy", small_to_oracle=False, auditor=aud, **pkg.kw,
    )
    c = pkg.synth.make_synthetic_cluster(16, 30, seed=1, prefs_per_task=2)
    br.observe_nodes(list(c.machines))
    br.observe_pods(list(c.tasks))
    _settle(br)        # certified round, placements confirmed
    br.run_scheduler()  # the next round's begin captures them
    return aud.run_pending()


def drift_audits(pkg, rounds=8):
    aud = pkg.obs.ShadowAuditor(sample_every=1, background=False)
    br = pkg.bridge.SchedulerBridge(
        cost_model="quincy", enable_preemption=True,
        migration_hysteresis=20, max_migrations_per_round=64,
        auditor=aud, **pkg.kw,
    )
    dc = pkg.synth.config6_rebalance(48, 120, seed=0)
    br.observe_nodes(dc.machines)
    br.observe_pods(dc.tasks)
    out = []
    for _ in range(rounds):
        _settle(br)
        res = aud.run_pending()
        if res is not None:
            out.append(audit_view(res))
    return out


class TestShadowAudit:
    def test_regret_bit_zero_on_certified_steady_state(self):
        out = steady_state_audit(PORT)
        assert out is not None and not out.error
        assert out.regret == 0
        assert out.status_quo_cost == out.optimal_cost
        assert out.drift_pods == 0
        assert audit_view(out) == audit_view(steady_state_audit(REF))

    def test_drift_cluster_regret_positive_even_on_empty_rounds(self):
        got = {}
        for pkg in (PORT, REF):
            aud = pkg.obs.ShadowAuditor(sample_every=1, background=False)
            br = pkg.bridge.SchedulerBridge(
                cost_model="quincy", auditor=aud, **pkg.kw
            )
            dc = pkg.synth.config6_rebalance(48, 120, seed=0)
            br.observe_nodes(dc.machines)
            br.observe_pods(dc.tasks)
            r = br.run_scheduler()
            assert r.stats.backend == ""  # empty round, nothing pending
            out = aud.run_pending()
            assert out is not None and not out.error
            got[pkg.name] = audit_view(out)
        assert got["port"]["regret"] > 0
        assert got["port"]["drift_pods"] > 0
        assert got["port"] == got["ref"]

    def test_rebalancing_drives_regret_to_zero(self):
        port = drift_audits(PORT)
        regrets = [a["regret"] for a in port]
        assert regrets[0] > 0          # drifted at first sight
        assert regrets[-1] == 0        # settled: promise measured
        assert sorted(regrets, reverse=True) == regrets  # monotone
        assert port == drift_audits(REF)

    def test_fragmentation_index_bounded_sku_classes(self):
        from poseidon_tpu_torch.cluster import Machine, TaskPhase
        from poseidon_tpu_torch.obs.audit import (
            AuditSnapshot,
            fragmentation_index,
        )

        machines = [
            Machine(
                name=f"m{i}", rack="r0", cpu_capacity=float(4 + i),
                cpu_allocatable=4.0, memory_capacity_kb=1 << 20,
                memory_allocatable_kb=1 << 20, max_tasks=4,
            )
            for i in range(12)  # 12 distinct SKUs > MAX_SKU_CLASSES
        ]
        tasks = [Task(uid="t0", cpu_request=0.1, memory_request_kb=1,
                      phase=TaskPhase.RUNNING, machine="m0")]
        snap = AuditSnapshot(
            round_num=1, cost_model="quincy", hysteresis=0,
            machines=machines, tasks=tasks, uids=["t0"],
            names=[m.name for m in machines],
            task_usage=None, machine_load=None, machine_mem_free=None,
        )
        frag = fragmentation_index(snap)
        assert len(frag) <= 9 and "other" in frag
        assert frag["4c-1g-4s"] == 3
        snap.machines = machines + [dataclasses.replace(
            machines[0], name="new", cpu_capacity=1.0,
        )]
        assert fragmentation_index(snap)["4c-1g-4s"] == 3

    def test_vanished_sku_class_is_zeroed(self):
        from poseidon_tpu_torch.obs.audit import AuditResult

        m = _metrics()
        m.record_audit(AuditResult(
            round_num=1, frag_slots={"8c-16g-12s": 5, "4c-8g-8s": 2},
        ))
        m.record_audit(AuditResult(
            round_num=2, frag_slots={"8c-16g-12s": 4},
        ))
        text = m.registry.render()
        assert 'poseidon_audit_frag_slots{sku="8c-16g-12s"} 4' in text
        assert 'poseidon_audit_frag_slots{sku="4c-8g-8s"} 0' in text

    def test_background_worker_and_metrics(self):
        m = _metrics()
        aud = ShadowAuditor(metrics=m, sample_every=1, background=True)
        try:
            br = SchedulerBridge(
                cost_model="quincy", small_to_oracle=False, metrics=m,
                auditor=aud, device="cpu",
            )
            c = make_synthetic_cluster(12, 20, seed=0)
            br.observe_nodes(list(c.machines))
            br.observe_pods(list(c.tasks))
            _settle(br, rounds=2)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                with aud._lock:
                    if aud.completed:
                        break
                time.sleep(0.05)
            assert aud.completed >= 1
            text = m.registry.render()
            assert "poseidon_audit_regret" in text
            assert 'poseidon_audit_runs_total{outcome="ok"}' in text
        finally:
            aud.stop()

    def test_pricing_asks_for_the_cpu(self, monkeypatch):
        """The audit prices on the CPU by an explicit device, never on
        the round's device: every tensor it makes is asked for on
        ``cpu``."""
        from poseidon_tpu_torch.models.costs import CostInputs

        asked = []
        orig = CostInputs.to_device

        def spy(self, device):
            asked.append(str(device))
            return orig(self, device)

        monkeypatch.setattr(CostInputs, "to_device", spy)
        aud = ShadowAuditor(sample_every=1, background=False)
        dc = config6_rebalance(24, 60, seed=0)
        br = SchedulerBridge(cost_model="quincy", auditor=aud, device="cpu")
        br.observe_nodes(dc.machines)
        br.observe_pods(dc.tasks)
        br.run_scheduler()  # an empty round: only the audit prices
        asked.clear()
        out = aud.run_pending()
        assert out is not None and not out.error
        assert asked == ["cpu"]

    def test_capture_skips_when_worker_busy(self):
        aud = ShadowAuditor(sample_every=1, background=False)
        br = SchedulerBridge(cost_model="quincy", auditor=aud, device="cpu")
        dc = config6_rebalance(24, 60, seed=0)
        br.observe_nodes(dc.machines)
        br.observe_pods(dc.tasks)
        for _ in range(4):  # queue bound is 2; the rest are skipped
            br.run_scheduler()
        assert aud.skipped == 2
        assert aud.run_pending() is not None

    def test_audit_error_is_counted_not_raised(self):
        m = _metrics()
        aud = ShadowAuditor(metrics=m, sample_every=1, background=False)
        br = SchedulerBridge(cost_model="quincy", auditor=aud, device="cpu")
        dc = config6_rebalance(24, 60, seed=0)
        br.observe_nodes(dc.machines)
        br.observe_pods(dc.tasks)
        br.run_scheduler()
        snap = aud._q.get_nowait()
        snap.cost_model = "no-such-model"
        aud._q.put_nowait(snap)
        out = aud.run_pending()
        assert out.error
        assert aud.failures == 1
        assert 'poseidon_audit_runs_total{outcome="error"}' in \
            m.registry.render()

    def test_no_capture_without_running_tasks(self):
        aud = ShadowAuditor(sample_every=1, background=False)
        br = SchedulerBridge(cost_model="quincy", auditor=aud, device="cpu")
        c = make_synthetic_cluster(8, 10, seed=0)
        br.observe_nodes(list(c.machines))
        br.observe_pods(list(c.tasks))  # all pending, none running
        br.run_scheduler()
        assert aud.run_pending() is None


# ---------------------------------------------------------------------------
# the SLO engine
# ---------------------------------------------------------------------------


class TestSloGrammar:
    SPECS = (
        "e2b_p99_ms < 10 by lane=express", "e2c_p50_ms < 100",
        "round_p999_ms < 500", "regret == 0", "ready",
    )

    @pytest.mark.parametrize("spec", SPECS)
    def test_objectives_equal_reference(self, spec):
        assert dataclasses.asdict(parse_objective(spec)) == \
            dataclasses.asdict(ref_slo.parse_objective(spec))

    def test_histogram_objective(self):
        o = parse_objective("e2b_p99_ms < 10 by lane=express")
        assert o.kind == "histogram"
        assert o.family == "poseidon_express_e2b_ms"
        assert o.op == "<" and o.threshold == 10.0
        assert abs(o.budget - 0.01) < 1e-9
        assert o.labels == (("lane", "express"),)

    def test_percentile_is_the_budget(self):
        assert abs(parse_objective("e2c_p50_ms < 100").budget - 0.5) < 1e-9
        assert abs(
            parse_objective("round_p999_ms < 500").budget - 0.001
        ) < 1e-9
        for bad in ("e2b_p100_ms < 10", "e2b_p950_ms < 10",
                    "e2b_p0_ms < 10"):
            with pytest.raises(SloParseError, match="percentile"):
                parse_objective(bad)

    def test_gauge_and_bool_objectives(self):
        o = parse_objective("regret == 0")
        assert o.kind == "gauge"
        assert o.family == "poseidon_audit_regret"
        r = parse_objective("ready")
        assert (r.op, r.threshold) == ("==", 1.0)

    def test_threshold_below_smallest_bucket_rejected(self):
        with pytest.raises(SloParseError, match="smallest bucket"):
            SloEngine(["e2b_p99_ms < 0.2"], metrics=_metrics())
        SloEngine(["e2b_p99_ms < 0.2"], metrics=None)

    @pytest.mark.parametrize("bad", [
        "nope_p99_ms < 10", "regret", "e2b_p99_ms", "e2b_p99_ms > 10",
        "e2b_p99_ms < 10 by lane",
    ])
    def test_parse_errors(self, bad):
        with pytest.raises(SloParseError):
            parse_objective(bad)
        with pytest.raises(ref_slo.SloParseError):
            ref_slo.parse_objective(bad)


def regret_history(pkg):
    """The reference test's breach-window history; returns every
    evaluation's status and the breach events."""
    m = _metrics(pkg)
    trace = pkg.trace.TraceGenerator()
    eng = pkg.obs.SloEngine(
        ["regret == 0"], metrics=m, trace=trace,
        short_window=2, long_window=4,
    )
    statuses = []
    for regret, start, n in ((0, 0, 4), (137, 10, 10), (0, 30, 6),
                             (9, 50, 10)):
        m.audit_regret.set(regret)
        for i in range(n):
            eng.evaluate(start + i)
            statuses.append(eng.status())
    breaches = [e.detail for e in trace.events if e.event == "SLO_BREACH"]
    return statuses, breaches, m


class TestSloEngine:
    def test_gauge_breach_fires_exactly_once_per_window(self):
        statuses, breaches, m = regret_history(PORT)
        # burns for ten rounds twice, fires exactly once per window
        assert len(breaches) == 2
        assert statuses[13]["objectives"][0]["healthy"] is False
        assert statuses[13]["objectives"][0]["breaches"] == 1
        assert statuses[19]["objectives"][0]["healthy"] is True
        text = m.registry.render()
        assert "poseidon_slo_breaches_total" in text
        assert 'poseidon_slo_burn_rate{slo="regret == 0",window="short"}' \
            in text
        ref_statuses, ref_breaches, _ = regret_history(REF)
        assert statuses == ref_statuses
        assert breaches == ref_breaches

    def test_histogram_objective_burn(self):
        out = {}
        for pkg in (PORT, REF):
            m = _metrics(pkg)
            eng = pkg.obs.SloEngine(
                ["e2b_p99_ms < 10"], metrics=m,
                short_window=2, long_window=4,
            )
            seen = []
            for _ in range(3):
                m.record_express_batch([1.0, 2.0, 3.0])
                eng.evaluate(0)
                seen.append(eng.status())
            for _ in range(4):
                m.record_express_batch([50.0, 80.0])
                eng.evaluate(1)
                seen.append(eng.status())
            out[pkg.name] = seen
        assert out["port"][2]["objectives"][0]["healthy"] is True
        assert out["port"][2]["objectives"][0]["burn_short"] == 0.0
        assert out["port"][-1]["objectives"][0]["burn_short"] > 1.0
        assert out["port"][-1]["objectives"][0]["healthy"] is False
        assert out["port"] == out["ref"]

    def test_ready_objective_tracks_latch(self):
        m = _metrics()
        health = HealthState(ready_gauge=m.ready)
        eng = SloEngine(["ready"], metrics=m, short_window=2,
                        long_window=2)
        eng.evaluate(1)
        eng.evaluate(2)
        assert eng.status()["objectives"][0]["healthy"] is False
        health.mark_seeded()
        health.mark_round("dense_auction")
        for i in range(3):
            eng.evaluate(3 + i)
        assert eng.status()["objectives"][0]["healthy"] is True

    def test_inf_percentile_never_breaks_render_or_json(self):
        m = _metrics()
        eng = SloEngine(["e2b_p99_ms < 10"], metrics=m, short_window=1,
                        long_window=1)
        m.record_express_batch([10_000.0, 20_000.0])
        eng.evaluate(1)
        text = m.registry.render()
        assert 'poseidon_slo_value{slo="e2b_p99_ms < 10"} +Inf' in text
        doc = json.loads(json.dumps(eng.status()))
        assert doc["objectives"][0]["value"] is None

    def test_no_samples_is_healthy(self):
        eng = SloEngine(["e2b_p99_ms < 10 by lane=express"],
                        metrics=_metrics())
        eng.evaluate(1)
        st = eng.status()["objectives"][0]
        assert st["healthy"] is True and st["burn_short"] == 0.0

    def test_slo_endpoint(self):
        m = _metrics()
        eng = SloEngine(["regret == 0"], metrics=m)
        eng.evaluate(1)
        srv = ObsServer(m.registry, HealthState(), port=0, slo=eng)
        with srv:
            url = f"http://127.0.0.1:{srv.port}/slo"
            with urllib.request.urlopen(url, timeout=5) as resp:
                doc = json.loads(resp.read())
            assert doc["evaluations"] == 1
            assert doc["objectives"][0]["spec"] == "regret == 0"
        srv2 = ObsServer(m.registry, HealthState(), port=0)
        with srv2:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv2.port}/slo", timeout=5
                )
            assert ei.value.code == 404
            srv2.slo = eng
            with urllib.request.urlopen(
                f"http://127.0.0.1:{srv2.port}/slo", timeout=5
            ) as resp:
                assert json.loads(resp.read())["evaluations"] == 1

    def test_breach_lands_in_trace_report(self, tmp_path):
        path = tmp_path / "t.jsonl"
        with open(path, "w") as fh:
            trace = TraceGenerator(sink=fh)
            m = _metrics()
            eng = SloEngine(["regret == 0"], metrics=m, trace=trace,
                            short_window=1, long_window=1)
            m.audit_regret.set(5)
            eng.evaluate(3)
        from poseidon_tpu_torch.obs.report import (
            analyze_trace,
            render_report,
        )

        data = analyze_trace(str(path))
        assert data["slo_breaches"] == {"regret == 0": 1}
        assert "SLO breaches" in render_report(data)


# ---------------------------------------------------------------------------
# the journal's lifecycle stamp, and the daemon's flags
# ---------------------------------------------------------------------------


def test_restart_replay_closes_pre_crash_timeline(tmp_path):
    """A bind journaled with its lifecycle wall stamp before a crash
    closes into lane="restart" spanning the PRE-crash wait."""
    from poseidon_tpu_torch.apiclient.client import K8sApiClient
    from poseidon_tpu_torch.apiclient.fake_server import FakeApiServer
    from poseidon_tpu_torch.ha import ActuationJournal, replay_journal

    path = str(tmp_path / "j.jsonl")
    j = ActuationJournal(path)
    pre_crash_us = int((time.time() - 5.0) * 1e6)
    j.intents([{
        "op": "bind", "uid": "default/p000", "machine": "n0",
        "t_event_us": pre_crash_us,
    }], 7)
    j.close()
    j2 = ActuationJournal(path)  # the restart
    entries = j2.incomplete()
    assert entries[0].t_event_us == pre_crash_us
    m = _metrics()
    lc = LifecycleTracker(m)
    with FakeApiServer() as server:
        server.add_node("n0", cpu="8", memory="16Gi", pods=8)
        server.add_pod("p000", cpu="250m", memory="256Mi")
        client = K8sApiClient("127.0.0.1", server.port)
        out = replay_journal(client, entries, journal=j2, lifecycle=lc)
    j2.close()
    assert out["replayed"] == 1
    uid, lane, e2c = lc.last_closed
    assert (uid, lane) == ("default/p000", "restart")
    assert 4500 < e2c < 60_000
    assert "default/p000" not in lc.open
    assert 'lane="restart"' in m.registry.render()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_daemon_audit_slo_and_endpoint():
    """``--audit_every=1``, one ``--slo`` objective and a metrics port:
    ``/slo`` is served while the loop runs, one evaluation a round,
    and the audit's regret is recorded."""
    from poseidon_tpu_torch.apiclient import FakeApiServer
    from poseidon_tpu_torch.cli import parse_args, run_loop

    port = _free_port()
    seen = {}

    def _get(route):
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=5
        ) as resp:
            return resp.read().decode()

    def hook(rounds, _result):
        if rounds == 3:
            seen["slo"] = _get("/slo")
            seen["metrics"] = _get("/metrics")

    with FakeApiServer() as s:
        for i in range(4):
            s.add_node(f"n{i}", cpu="8", memory="16Gi", pods=10)
        for j in range(20):
            s.add_pod(f"pod-{j}", cpu="250m", memory="256Mi")
        args = parse_args([
            f"--k8s_apiserver_port={s.port}",
            "--polling_frequency=100000", "--max_rounds=4",
            "--device=cpu", "--audit_every=1", "--slo=regret == 0",
            f"--metrics_port={port}", "--metrics_host=127.0.0.1",
        ])
        assert run_loop(args, round_hook=hook) == 0
    doc = json.loads(seen["slo"])
    assert doc["objectives"][0]["spec"] == "regret == 0"
    assert doc["evaluations"] == 3
    assert "poseidon_audit_regret" in seen["metrics"]
