"""Explainer: the port's ``obs/explain.py`` and
``models/costs.arc_cost_terms`` against the reference's.

The analogue of ``tests/test_explain.py`` with its seeds and shapes,
over ``poseidon_tpu_torch`` (``device="cpu"``): across rounds over five
cost models with preemption on and off, every decision's term
breakdown sums bit-exactly to the solver's arc cost (the fetched
``cost`` in the decision log), and every unscheduled pod's diagnosis
is validated by applying its minimal relaxation and re-solving. Side
by side with the reference on the same sessions: the per-arc term
tables are equal term for term, every task's explanation (terms,
channel, runner-up, margin, diagnosis, relaxation) is equal, and so
are the validations.
"""

import dataclasses
import types

import numpy as np
import pytest

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.models.costs as ref_costs
import poseidon_tpu.obs.explain as ref_explain
import poseidon_tpu.obs.flightrec as ref_flightrec
import poseidon_tpu.synth as ref_synth
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.models.costs as port_costs
import poseidon_tpu_torch.obs.explain as port_explain
import poseidon_tpu_torch.obs.flightrec as port_flightrec
import poseidon_tpu_torch.synth as port_synth
from poseidon_tpu_torch.obs.explain import (
    ExplainError,
    render_explanation,
)

from tests.test_torch_graph import build_reference_oracle

MODELS = ("quincy", "octopus", "coco", "wharemap", "trivial")

REF = types.SimpleNamespace(
    name="ref", bridge=ref_bridge, cluster=ref_cluster, costs=ref_costs,
    explain=ref_explain, fr=ref_flightrec, synth=ref_synth, kw={},
    ex_kw={},
)
PORT = types.SimpleNamespace(
    name="port", bridge=port_bridge, cluster=port_cluster,
    costs=port_costs, explain=port_explain, fr=port_flightrec,
    synth=port_synth, kw={"device": "cpu"}, ex_kw={"device": "cpu"},
)


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    build_reference_oracle()


def _session(model, *, preempt=False, seed=3, machines=10, pods=40,
             rounds=2, prefs=2, pkg=PORT, **kw):
    """A small recorded session: seed round + churn rounds; returns
    (bridge, recorder)."""
    fr = pkg.fr.FlightRecorder("unused-dir", rounds=4)
    bridge = pkg.bridge.SchedulerBridge(
        cost_model=model, small_to_oracle=False, flightrec=fr,
        enable_preemption=preempt, **kw, **pkg.kw,
    )
    cluster = pkg.synth.make_synthetic_cluster(
        machines, pods, seed=seed, prefs_per_task=prefs
    )
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    for _ in range(rounds):
        res = bridge.run_scheduler()
        for uid, m in res.bindings.items():
            bridge.confirm_binding(uid, m)
        for uid, (_f, to) in res.migrations.items():
            bridge.confirm_migration(uid, to)
        for uid in res.preemptions:
            bridge.confirm_preemption(uid)
    return bridge, fr


def explainer(pkg, rec):
    return pkg.explain.RoundExplainer.from_record(rec, **pkg.ex_kw)


def _machine(pkg, name, **kw):
    base = dict(cpu_capacity=8.0, cpu_allocatable=8.0,
                memory_capacity_kb=1 << 20, memory_allocatable_kb=1 << 20,
                rack="r0")
    base.update(kw)
    return pkg.cluster.Machine(name=name, **base)


def _task(pkg, uid, **kw):
    base = dict(cpu_request=0.1, memory_request_kb=64)
    base.update(kw)
    return pkg.cluster.Task(uid=uid, **base)


class TestAttributionExactness:
    @pytest.mark.parametrize("model", MODELS)
    @pytest.mark.parametrize("preempt", [False, True])
    def test_terms_sum_to_the_solvers_cost(self, model, preempt):
        """For every logged decision: the term breakdown sums to its
        own cost, that cost equals the fetched cost the decision log
        carries, the margins agree, and the per-task costs sum to the
        round's exact objective — and every task explains as the
        reference's explainer explains it."""
        out = {}
        for pkg in (PORT, REF):
            bridge, fr = _session(model, preempt=preempt, pkg=pkg)
            rec = fr.last_round_record()
            assert rec is not None and rec.result is not None
            ex = explainer(pkg, rec)
            for rnd, kind, uid, detail in bridge.decision_log:
                if rnd != rec.round_num or not isinstance(detail, dict):
                    continue
                if detail.get("cost") is None:
                    continue
                e = ex.explain(uid)
                assert sum(e.terms.values()) == e.cost, (uid, e.terms)
                assert e.cost == detail["cost"], (kind, uid, e, detail)
                if detail.get("margin") is not None:
                    assert e.margin == detail["margin"], (kind, uid)
            expl = [dataclasses.asdict(ex.explain(u))
                    for u in rec.meta.task_uids]
            assert sum(e["cost"] for e in expl) == rec.result["cost"]
            out[pkg.name] = expl
        assert out["port"] == out["ref"]

    @pytest.mark.parametrize("model", MODELS + ("random",))
    @pytest.mark.parametrize("preempt", [False, True])
    def test_term_tables_equal_reference(self, model, preempt):
        """``arc_cost_terms`` on the same inputs: the same term names
        and the same int32 values per arc, padding slots included."""
        bridge, fr = _session(
            model if model != "random" else "quincy", preempt=preempt,
            pkg=REF, rounds=1,
        )
        rec = fr.last_round_record()
        ck = {k: v for k, v in rec.cost_kwargs.items() if v is not None}
        ref_in = ref_costs.build_cost_inputs_host(
            rec.meta.n_arcs + 5, rec.meta, **ck
        )
        port_in = port_costs.build_cost_inputs_host(
            rec.meta.n_arcs + 5, rec.meta, **ck
        )
        ref_terms = ref_costs.arc_cost_terms(model, ref_in)
        port_terms = port_costs.arc_cost_terms(
            model, port_in, device="cpu"
        )
        assert list(port_terms) == list(ref_terms)
        for k in ref_terms:
            assert port_terms[k].dtype == np.int32
            assert np.array_equal(port_terms[k], ref_terms[k]), k

    def test_migrate_decisions_attributed(self):
        out = {}
        for pkg in (PORT, REF):
            fr = pkg.fr.FlightRecorder("unused", rounds=2)
            bridge = pkg.bridge.SchedulerBridge(
                cost_model="quincy", small_to_oracle=False, flightrec=fr,
                enable_preemption=True, migration_hysteresis=1, **pkg.kw,
            )
            bridge.observe_nodes([
                _machine(pkg, f"m{i}", cpu_capacity=16.0,
                         cpu_allocatable=16.0, max_tasks=4,
                         rack=f"r{i % 2}")
                for i in range(4)
            ])
            bridge.observe_pods([
                _task(pkg, f"run-{i}",
                      phase=pkg.cluster.TaskPhase.RUNNING,
                      machine=f"m{3 - i % 2}",
                      data_prefs={f"m{i % 2}": 500})
                for i in range(3)
            ])
            res = bridge.run_scheduler()
            assert res.migrations, "expected rebalancing migrations"
            rec = fr.last_round_record()
            ex = explainer(pkg, rec)
            seen = []
            for rnd, kind, uid, detail in bridge.decision_log:
                if kind != "MIGRATE" or rnd != rec.round_num:
                    continue
                assert detail["cost"] is not None
                e = ex.explain(uid)
                assert e.kind == "MIGRATE"
                assert e.cost == detail["cost"]
                assert sum(e.terms.values()) == e.cost
                seen.append(dataclasses.asdict(e))
            assert len(seen) == len(res.migrations)
            out[pkg.name] = seen
        assert out["port"] == out["ref"]


def diagnose(pkg, rec, uids) -> list:
    ex = explainer(pkg, rec)
    out = []
    for uid in uids:
        e = ex.explain(uid)
        out.append((dataclasses.asdict(e), ex.validate(e)))
    return out


class TestUnscheduledDiagnosis:
    def test_priced_out_validates(self):
        out = {}
        for pkg in (PORT, REF):
            _bridge, fr = _session("quincy", rounds=1, pkg=pkg)
            rec = fr.last_round_record()
            unsched = rec.result["unscheduled"]
            assert unsched, "scenario must park some pods"
            out[pkg.name] = diagnose(pkg, rec, unsched)
            for e, v in out[pkg.name]:
                assert e["kind"] == "UNSCHEDULED"
                assert e["diagnosis"] == "priced-out", e
                assert sum(e["terms"].values()) == e["cost"]
                assert v["ok"], (e, v)
        assert out["port"] == out["ref"]

    def test_capacity_exhausted_validates(self):
        out = {}
        for pkg in (PORT, REF):
            fr = pkg.fr.FlightRecorder("unused", rounds=2)
            bridge = pkg.bridge.SchedulerBridge(
                cost_model="octopus", small_to_oracle=False, flightrec=fr,
                max_tasks_per_machine=3, **pkg.kw,
            )
            bridge.observe_nodes([
                _machine(pkg, f"m{i}", max_tasks=3) for i in range(2)
            ])
            bridge.observe_pods([_task(pkg, f"p{i}") for i in range(9)])
            res = bridge.run_scheduler()
            assert res.unscheduled, "6 seats, 9 pods: some must park"
            out[pkg.name] = diagnose(
                pkg, fr.last_round_record(), res.unscheduled
            )
            for e, v in out[pkg.name]:
                assert e["diagnosis"] == "capacity-exhausted", e
                assert v["ok"], (e, v)
        assert out["port"] == out["ref"]

    def test_pref_pruned_validates(self):
        out = {}
        for pkg in (PORT, REF):
            fr = pkg.fr.FlightRecorder("unused", rounds=2)
            bridge = pkg.bridge.SchedulerBridge(
                cost_model="quincy", small_to_oracle=False, flightrec=fr,
                topk_prefs=1, max_tasks_per_machine=1, **pkg.kw,
            )
            bridge.observe_nodes([
                _machine(pkg, n, max_tasks=1) for n in ("mA", "mB")
            ])
            bridge.observe_pods([
                _task(pkg, "occupant",
                      phase=pkg.cluster.TaskPhase.RUNNING, machine="mA"),
                _task(pkg, "victim", data_prefs={"mA": 45, "mB": 30}),
            ])
            res = bridge.run_scheduler()
            assert "victim" in res.unscheduled, res.stats
            out[pkg.name] = diagnose(
                pkg, fr.last_round_record(), ["victim"]
            )
            (e, v), = out[pkg.name]
            assert e["diagnosis"] == "pref-pruned", e
            assert e["relaxation"]["topk_prefs"] == 2
            assert v["ok"] and v["placed_on"] == "mB", v
        assert out["port"] == out["ref"]

    def test_churn_budget_deferred_validates(self):
        out = {}
        for pkg in (PORT, REF):
            fr = pkg.fr.FlightRecorder("unused", rounds=2)
            bridge = pkg.bridge.SchedulerBridge(
                cost_model="quincy", small_to_oracle=False, flightrec=fr,
                enable_preemption=True, migration_hysteresis=1,
                max_migrations_per_round=1, **pkg.kw,
            )
            bridge.observe_nodes([
                _machine(pkg, f"m{i}", cpu_capacity=16.0,
                         cpu_allocatable=16.0, max_tasks=4)
                for i in range(4)
            ])
            bridge.observe_pods([
                _task(pkg, f"run-{i}",
                      phase=pkg.cluster.TaskPhase.RUNNING,
                      machine=f"m{2 + i % 2}",
                      data_prefs={f"m{i % 2}": 500})
                for i in range(3)
            ])
            res = bridge.run_scheduler()
            rec = fr.last_round_record()
            deferred = rec.result["deferred"]
            assert deferred, (res.migrations, res.stats)
            out[pkg.name] = diagnose(pkg, rec, deferred)
            for e, v in out[pkg.name]:
                assert e["diagnosis"] == "churn-budget-deferred", e
                assert v["ok"], (e, v)
        assert out["port"] == out["ref"]


class TestExplainerSurface:
    def test_render_transcript(self):
        texts = {}
        for pkg in (PORT, REF):
            bridge, fr = _session("quincy", rounds=1, pkg=pkg)
            rec = fr.last_round_record()
            ex = explainer(pkg, rec)
            placed = [
                uid for rnd, kind, uid, d in bridge.decision_log
                if kind == "PLACE" and rnd == rec.round_num
            ]
            un = rec.result["unscheduled"]
            texts[pkg.name] = (
                pkg.explain.render_explanation(ex.explain(placed[0])),
                pkg.explain.render_explanation(ex.explain(un[0])),
            )
        text, text_u = texts["port"]
        assert "sums exactly" in text
        assert "runner-up" in text
        assert "diagnosis: priced-out" in text_u
        assert "minimal relaxation" in text_u
        assert texts["port"] == texts["ref"]
        assert render_explanation is port_explain.render_explanation

    def test_unknown_uid_raises(self):
        _bridge, fr = _session("trivial", rounds=1, pods=8)
        ex = explainer(PORT, fr.last_round_record())
        with pytest.raises(ExplainError):
            ex.explain("no-such-pod")

    def test_from_record_requires_result(self):
        with pytest.raises(ExplainError):
            port_explain.RoundExplainer.from_record(None, device="cpu")

    def test_oracle_path_costs_match_dense(self):
        fr = PORT.fr.FlightRecorder("unused", rounds=2)
        bridge = PORT.bridge.SchedulerBridge(
            cost_model="quincy", small_to_oracle=True, flightrec=fr,
            device="cpu",
        )
        cluster = PORT.synth.make_synthetic_cluster(
            6, 30, seed=5, prefs_per_task=2
        )
        bridge.observe_nodes(list(cluster.machines))
        bridge.observe_pods(list(cluster.tasks))
        res = bridge.run_scheduler()
        assert res.stats.backend == "oracle:small-instance"
        rec = fr.last_round_record()
        ex = explainer(PORT, rec)
        n = 0
        for rnd, _kind, uid, detail in bridge.decision_log:
            if rnd != rec.round_num or detail.get("cost") is None:
                continue
            assert ex.explain(uid).cost == detail["cost"], uid
            n += 1
        assert n > 0

    def test_margin_negative_when_capacity_forces(self):
        fr = PORT.fr.FlightRecorder("unused", rounds=2)
        bridge = PORT.bridge.SchedulerBridge(
            cost_model="quincy", small_to_oracle=False, flightrec=fr,
            max_tasks_per_machine=1, device="cpu",
        )
        bridge.observe_nodes([
            _machine(PORT, n, max_tasks=1) for n in ("good", "meh")
        ])
        bridge.observe_pods([
            _task(PORT, f"p{i}", data_prefs={"good": 49, "meh": 48})
            for i in range(2)
        ])
        res = bridge.run_scheduler()
        assert sorted(res.bindings.values()) == ["good", "meh"]
        ex = explainer(PORT, fr.last_round_record())
        squeezed = next(u for u, m in res.bindings.items() if m == "meh")
        e = ex.explain(squeezed)
        assert e.margin is not None and e.margin < 0, e

    def test_cli_explain_at_exit(self, capsys):
        """``--explain`` with ``--flight_recorder``: when the loop
        exits, the daemon prints the explanation of a pod of the last
        captured round."""
        from poseidon_tpu_torch.apiclient import FakeApiServer
        from poseidon_tpu_torch.cli import main

        with FakeApiServer() as s:
            for i in range(4):
                s.add_node(f"n{i}", cpu="8", memory="16Gi", pods=10)
            for j in range(20):
                s.add_pod(f"pod-{j}", cpu="250m", memory="256Mi")
            assert main([
                f"--k8s_apiserver_port={s.port}",
                "--polling_frequency=1000", "--max_rounds=1",
                "--device=cpu", "--flight_recorder=true",
                "--flight_dir=unused", "--explain=default/pod-3",
            ]) == 0
        out = capsys.readouterr().out
        assert "== explain default/pod-3 ==" in out
        assert "sums exactly" in out
