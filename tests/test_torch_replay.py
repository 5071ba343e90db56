"""Replay fidelity: the port's ``obs/replay.py`` against the
reference's.

The analogue of ``tests/test_replay.py`` with its seeds and shapes, over
``poseidon_tpu_torch`` (``device="cpu"``): dumps re-run offline
bit-identically (warm chains, express windows, aggregated and sharded
rounds, an oracle-routed round), and doctored dumps report divergence
instead of crashing. Across the packages (the dump layout is shared):
a reference dump replayed by the port's ``obs.replay`` has every record
``ok``, a port dump replayed by the reference's likewise, and the two
replays report the same backends and costs.
"""

import json
import types

import numpy as np
import pytest

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.obs.flightrec as ref_flightrec
import poseidon_tpu.obs.replay as ref_replay
import poseidon_tpu.synth as ref_synth
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.obs.flightrec as port_flightrec
import poseidon_tpu_torch.obs.replay as port_replay
import poseidon_tpu_torch.synth as port_synth
from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.obs import replay as replay_mod
from poseidon_tpu_torch.obs.flightrec import FlightRecorder, load_dump
from poseidon_tpu_torch.obs.replay import render_report, replay_dump
from poseidon_tpu_torch.synth import make_synthetic_cluster

from tests.test_torch_graph import build_reference_oracle

REF = types.SimpleNamespace(
    name="ref", bridge=ref_bridge, cluster=ref_cluster, fr=ref_flightrec,
    replay=ref_replay, synth=ref_synth, kw={}, replay_kw={},
)
PORT = types.SimpleNamespace(
    name="port", bridge=port_bridge, cluster=port_cluster,
    fr=port_flightrec, replay=port_replay, synth=port_synth,
    kw={"device": "cpu"}, replay_kw={"device": "cpu"},
)


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    build_reference_oracle()


def _record_session(tmp_path, *, rounds=3, churn=4, seed=0,
                    machines=12, pods=50, model="quincy", pkg=PORT,
                    **bridge_kw):
    fr = pkg.fr.FlightRecorder(str(tmp_path / f"fr-{pkg.name}"), rounds=8)
    bridge = pkg.bridge.SchedulerBridge(
        cost_model=model, small_to_oracle=False, flightrec=fr,
        **bridge_kw, **pkg.kw,
    )
    cluster = pkg.synth.make_synthetic_cluster(
        machines, pods, seed=seed, prefs_per_task=2
    )
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    running = []
    seq = 0
    for i in range(rounds):
        if i:
            for _ in range(churn):
                if not running:
                    break
                done = running.pop(0)
                freed = bridge.pod_to_machine[done]
                bridge.observe_pod_event("DELETED", bridge.tasks[done])
                bridge.observe_pod_event("ADDED", pkg.cluster.Task(
                    uid=f"x-{seq}", cpu_request=0.1,
                    memory_request_kb=128, data_prefs={freed: 400},
                ))
                seq += 1
        res = bridge.run_scheduler()
        for uid, m in res.bindings.items():
            bridge.confirm_binding(uid, m)
            running.append(uid)
    return bridge


def _express_session(tmp_path, pkg=PORT):
    fr = pkg.fr.FlightRecorder(str(tmp_path / f"fr-{pkg.name}"), rounds=6)
    bridge = pkg.bridge.SchedulerBridge(
        cost_model="quincy", small_to_oracle=False, flightrec=fr,
        express_lane=True, **pkg.kw,
    )
    cluster = pkg.synth.make_synthetic_cluster(
        12, 50, seed=1, prefs_per_task=2
    )
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    res = bridge.run_scheduler()
    for uid, m in res.bindings.items():
        bridge.confirm_binding(uid, m)
    for k in range(3):
        er = bridge.express_batch([("ADDED", pkg.cluster.Task(
            uid=f"late-{k}", cpu_request=0.1, memory_request_kb=128,
        ))])
        assert er is not None and er.bindings
        for uid, m in er.bindings.items():
            bridge.confirm_binding(uid, m)
    # the correction round runs off express-mutated warm state
    # (warm_seed is None for it: the chained replay must reproduce it
    # through the express records)
    bridge.run_scheduler()
    return bridge, fr


def _assert_identical(path):
    report = replay_dump(load_dump(path), device="cpu")
    assert report["identical"] is True, render_report(report)
    assert report["compared"] >= 1
    return report


class TestRoundReplay:
    def test_warm_churned_rounds_bit_identical(self, tmp_path):
        bridge = _record_session(tmp_path, rounds=4)
        report = _assert_identical(bridge.flight_dump("manual"))
        assert report["compared"] == 4

    def test_preemption_rounds_bit_identical(self, tmp_path):
        bridge = _record_session(
            tmp_path, rounds=3, enable_preemption=True,
            migration_hysteresis=5,
        )
        _assert_identical(bridge.flight_dump("manual"))

    def test_aggregated_round_bit_identical(self, tmp_path):
        bridge = _record_session(
            tmp_path, rounds=3, model="octopus",
            aggregate_classes=True, topk_prefs=1,
            machines=16, pods=60,
        )
        _assert_identical(bridge.flight_dump("manual"))

    @pytest.mark.parametrize("mesh", [1, 8])
    def test_sharded_round_bit_identical(self, tmp_path, mesh):
        bridge = _record_session(tmp_path, rounds=2, mesh_width=mesh)
        report = _assert_identical(bridge.flight_dump("manual"))
        # a CPU replay lays any recorded width out on the CPU
        assert report["notes"] == []

    def test_oracle_routed_round_replays(self, tmp_path):
        fr = FlightRecorder(str(tmp_path / "fr"), rounds=2)
        bridge = SchedulerBridge(
            cost_model="quincy", small_to_oracle=True, flightrec=fr,
            device="cpu",
        )
        cluster = make_synthetic_cluster(6, 30, seed=4)
        bridge.observe_nodes(list(cluster.machines))
        bridge.observe_pods(list(cluster.tasks))
        res = bridge.run_scheduler()
        assert res.stats.backend.startswith("oracle:")
        _assert_identical(bridge.flight_dump("manual"))


class TestExpressReplay:
    def test_express_window_and_correction_round(self, tmp_path):
        bridge, fr = _express_session(tmp_path)
        rounds = [r for r in fr.records if r.kind == "round"]
        assert rounds[-1].warm_used and rounds[-1].warm_seed is None
        express = [r for r in fr.records if r.kind == "express"]
        assert len(express) == 3
        report = _assert_identical(bridge.flight_dump("manual"))
        kinds = [r["kind"] for r in report["records"]]
        assert kinds == ["round", "express", "express", "express",
                         "round"]


def _session(kind, tmp_path, pkg):
    if kind == "express":
        return _express_session(tmp_path, pkg=pkg)[0]
    kw = {
        "warm": dict(rounds=4),
        "preemption": dict(rounds=3, enable_preemption=True,
                           migration_hysteresis=5),
        "aggregated": dict(rounds=3, model="octopus",
                           aggregate_classes=True, topk_prefs=1,
                           machines=16, pods=60),
        "sharded": dict(rounds=2, mesh_width=4),
    }[kind]
    return _record_session(tmp_path, pkg=pkg, **kw)


def _verdicts(report):
    return [(r["kind"], r["round_num"], r["ok"], r["backend"], r["cost"])
            for r in report["records"]]


class TestCrossPackage:
    @pytest.mark.parametrize("kind", [
        "warm", "preemption", "aggregated", "sharded", "express",
    ])
    def test_reference_dump_replayed_by_port(self, tmp_path, kind):
        """A dump the reference's daemon wrote replays through the
        port's ``obs.replay`` with every record ``ok``, and the port's
        replay reports what the reference's own replay reports."""
        bridge = _session(kind, tmp_path, REF)
        path = bridge.flight_dump("manual")
        port = port_replay.replay_dump(
            port_flightrec.load_dump(path), device="cpu"
        )
        assert port["identical"] is True, port_replay.render_report(port)
        assert all(r["ok"] for r in port["records"])
        ref = ref_replay.replay_dump(ref_flightrec.load_dump(path))
        assert _verdicts(port) == _verdicts(ref)

    @pytest.mark.parametrize("kind", ["warm", "express"])
    def test_port_dump_replayed_by_reference(self, tmp_path, kind):
        bridge = _session(kind, tmp_path, PORT)
        path = bridge.flight_dump("manual")
        ref = ref_replay.replay_dump(ref_flightrec.load_dump(path))
        assert ref["identical"] is True, ref_replay.render_report(ref)
        assert all(r["ok"] for r in ref["records"])
        port = port_replay.replay_dump(
            port_flightrec.load_dump(path), device="cpu"
        )
        assert _verdicts(port) == _verdicts(ref)


class TestDivergence:
    def _doctor(self, path, mutate):
        z = dict(np.load(path.replace(".json", ".npz")))
        mutate(z)
        np.savez_compressed(path.replace(".json", ".npz"), **z)

    def test_doctored_assignment_reports_divergence(self, tmp_path):
        bridge = _record_session(tmp_path, rounds=2)
        path = bridge.flight_dump("manual")

        def mutate(z):
            key = sorted(k for k in z if k.endswith("result/assignment"))[0]
            z[key] = z[key].copy()
            z[key][0] = -1 if z[key][0] >= 0 else 0

        self._doctor(path, mutate)
        report = replay_dump(load_dump(path), device="cpu")
        assert report["identical"] is False
        bad = [r for r in report["records"] if r["ok"] is False]
        assert bad and "assignment" in bad[0]["divergence"]
        assert replay_mod.main([path, "--device=cpu"]) == 1

    def test_doctored_input_reports_divergence(self, tmp_path):
        bridge = _record_session(tmp_path, rounds=2)
        path = bridge.flight_dump("manual")

        def mutate(z):
            key = sorted(k for k in z if k.endswith("meta/arc_weight"))[0]
            w = z[key].copy()
            w[w > 0] = w[w > 0] // 2  # halve every locality weight
            z[key] = w

        self._doctor(path, mutate)
        report = replay_dump(load_dump(path), device="cpu")
        assert report["identical"] is False

    def test_truncated_manifest_is_a_load_error(self, tmp_path):
        bridge = _record_session(tmp_path, rounds=2)
        path = bridge.flight_dump("manual")
        raw = open(path).read()
        open(path, "w").write(raw[: len(raw) // 2])
        assert replay_mod.main([path, "--device=cpu"]) == 2


class TestReplayCli:
    def test_main_explain(self, tmp_path, capsys):
        bridge = _record_session(tmp_path, rounds=2)
        uid = next(
            u for r, k, u, _d in reversed(bridge.decision_log)
            if k == "PLACE" and r == bridge.round_num
        )
        path = bridge.flight_dump("manual")
        rc = replay_mod.main([path, "--explain", uid, "--device=cpu"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "BIT-IDENTICAL" in out
        assert "sums exactly" in out
        assert f"explain {uid}" in out

    def test_main_explain_unknown_uid_is_readable(self, tmp_path, capsys):
        bridge = _record_session(tmp_path, rounds=2)
        path = bridge.flight_dump("manual")
        rc = replay_mod.main(
            [path, "--explain", "no-such-pod", "--device=cpu"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert "BIT-IDENTICAL" in out
        assert "no-such-pod" in out and "not a task" in out

    def test_main_json(self, tmp_path, capsys):
        bridge = _record_session(tmp_path, rounds=2)
        path = bridge.flight_dump("manual")
        rc = replay_mod.main([path, "--json", "--device=cpu"])
        assert rc == 0
        data = json.loads(capsys.readouterr().out)
        assert data["identical"] is True
        assert data["compared"] == 2

    def test_explain_equals_reference(self, tmp_path):
        """``--explain`` against the replayed last round renders the
        same transcript in both packages."""
        out = {}
        for pkg in (REF, PORT):
            bridge = _record_session(tmp_path, rounds=2, pkg=pkg)
            uid = next(
                u for r, k, u, _d in reversed(bridge.decision_log)
                if k == "PLACE" and r == bridge.round_num
            )
            report = pkg.replay.replay_dump(
                pkg.fr.load_dump(bridge.flight_dump("manual")),
                explain_uid=uid, **pkg.replay_kw,
            )
            out[pkg.name] = (uid, report["explain"]["rendered"])
        assert out["port"] == out["ref"]

    def test_default_device_is_the_card(self, tmp_path):
        """Without ``--device`` the replay wants the card; a host
        without one raises and names ``device="cpu"``."""
        import torch

        if torch.cuda.is_available():
            return
        bridge = _record_session(tmp_path, rounds=1)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            replay_dump(load_dump(bridge.flight_dump("manual")))
