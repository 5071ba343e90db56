"""Flight recorder: the port's ``obs/flightrec.py`` against the
reference's.

The analogue of ``tests/test_flightrec.py`` with its seeds and shapes,
over ``poseidon_tpu_torch`` (``device="cpu"``): the bounded ring,
dump/load round trip, anomaly triggers (express degrade, fetch
timeout, resync storm) and the zero-interference contract. Side by
side with the reference on the same session: the records each ring
holds are equal (arrays, metadata, flags, floors, dims, warm seed,
results), each package's ``load_dump`` reads the other's dump to the
same records, and recording costs no read of the card (the round's
fetch and loop-read counts are those of a session without it).
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.obs.flightrec as ref_flightrec
import poseidon_tpu.synth as ref_synth
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.obs.flightrec as port_flightrec
import poseidon_tpu_torch.synth as port_synth
from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.cluster import Task
from poseidon_tpu_torch.guards import FetchTimeout
from poseidon_tpu_torch.obs.flightrec import (
    DUMP_REASONS,
    FlightRecorder,
    load_dump,
)
from poseidon_tpu_torch.obs.metrics import (
    MetricsRegistry,
    STORM_RESYNCS,
    SchedulerMetrics,
)
from poseidon_tpu_torch.synth import make_synthetic_cluster

from tests.test_torch_graph import build_reference_oracle

REF = types.SimpleNamespace(
    name="ref", bridge=ref_bridge, cluster=ref_cluster, fr=ref_flightrec,
    synth=ref_synth, kw={},
)
PORT = types.SimpleNamespace(
    name="port", bridge=port_bridge, cluster=port_cluster,
    fr=port_flightrec, synth=port_synth, kw={"device": "cpu"},
)


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    build_reference_oracle()


def _churn_session(tmp_path, *, rounds=3, churn=3, recorder=True,
                   pkg=PORT, **bridge_kw):
    fr = (
        pkg.fr.FlightRecorder(str(tmp_path / f"fr-{pkg.name}"), rounds=4)
        if recorder else None
    )
    bridge = pkg.bridge.SchedulerBridge(
        cost_model="quincy", small_to_oracle=False, flightrec=fr,
        **bridge_kw, **pkg.kw,
    )
    cluster = pkg.synth.make_synthetic_cluster(
        10, 40, seed=0, prefs_per_task=2
    )
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    res = bridge.run_scheduler()
    results = [res]
    running = []
    for uid, m in res.bindings.items():
        bridge.confirm_binding(uid, m)
        running.append(uid)
    seq = 0
    for _ in range(rounds - 1):
        for _ in range(churn):
            done = running.pop(0)
            freed = bridge.pod_to_machine[done]
            bridge.observe_pod_event("DELETED", bridge.tasks[done])
            bridge.observe_pod_event("ADDED", pkg.cluster.Task(
                uid=f"x-{seq}", cpu_request=0.1,
                memory_request_kb=128, data_prefs={freed: 400},
            ))
            seq += 1
        r = bridge.run_scheduler()
        results.append(r)
        for uid, m in r.bindings.items():
            bridge.confirm_binding(uid, m)
            if uid.startswith("x-"):
                running.append(uid)
    return bridge, fr, results


def record_view(rec) -> dict:
    """A record as plain values (timers out of its stats)."""
    if rec.kind == "express":
        return dataclasses.asdict(rec)
    stats = dict(rec.stats or {})
    for k in list(stats):
        if k.endswith("_ms"):
            stats.pop(k)
    return dict(
        round_num=rec.round_num, cost_model=rec.cost_model,
        flags=rec.flags,
        arrays={k: np.asarray(v).tolist()
                for k, v in sorted(rec.arrays.items())},
        meta={f.name: (np.asarray(getattr(rec.meta, f.name)).tolist()
                       if isinstance(getattr(rec.meta, f.name),
                                     np.ndarray)
                       else getattr(rec.meta, f.name))
              for f in dataclasses.fields(rec.meta)},
        cost_kwargs={k: np.asarray(v).tolist()
                     for k, v in sorted(rec.cost_kwargs.items())
                     if v is not None},
        pad_floors=rec.pad_floors, dims=rec.dims,
        warm_used=rec.warm_used,
        warm=[np.asarray(a).tolist() for a in rec.warm_seed or ()],
        rv=rec.rv, stats=stats,
        result=None if rec.result is None else {
            k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                else v)
            for k, v in rec.result.items()
        },
    )


class TestRing:
    def test_ring_is_bounded_by_rounds(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=7)
        rounds = [r for r in fr.records if r.kind == "round"]
        assert len(rounds) == 4  # the recorder's K
        assert rounds[-1].round_num == 7
        assert rounds[0].round_num == 4  # oldest three dropped

    def test_capture_copies_not_references(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=2)
        rec = [r for r in fr.records if r.kind == "round"][0]
        snap = {k: v.copy() for k, v in rec.arrays.items()}
        wait_snap = rec.meta.task_wait.copy()
        for k in range(2):
            bridge.observe_pod_event("ADDED", Task(
                uid=f"later-{k}", cpu_request=0.1, memory_request_kb=64,
            ))
            r = bridge.run_scheduler()
            for uid, m in r.bindings.items():
                bridge.confirm_binding(uid, m)
        for k, v in snap.items():
            assert np.array_equal(rec.arrays[k], v), k
        assert np.array_equal(rec.meta.task_wait, wait_snap)

    def test_result_attached_at_finish(self, tmp_path):
        _, fr, _ = _churn_session(tmp_path, rounds=2)
        for rec in fr.records:
            if rec.kind != "round":
                continue
            assert rec.result is not None
            assert rec.result["backend"] == "dense_auction"
            assert "unscheduled" in rec.result
            assert rec.stats["round_num"] == rec.round_num

    def test_records_equal_reference(self, tmp_path):
        """The same churned session fills both rings with the same
        records: every input, floor, dim, warm seed and result."""
        views = {}
        for pkg in (REF, PORT):
            _, fr, _ = _churn_session(tmp_path, rounds=4, pkg=pkg)
            views[pkg.name] = [record_view(r) for r in fr.records]
        assert views["port"] == views["ref"]
        assert sum(v["warm_used"] for v in views["port"]) == 3


class TestDump:
    def test_dump_roundtrip(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=3)
        path = bridge.flight_dump("manual", label="test")
        assert path and os.path.exists(path)
        assert os.path.exists(path.replace(".json", ".npz"))
        manifest = json.load(open(path))
        assert manifest["reason"] == "manual"
        assert manifest["label"] == "test"
        assert manifest["device"] == "cpu"
        dump = load_dump(path)
        got = [r for r in dump["records"] if r.kind == "round"]
        want = [r for r in fr.records if r.kind == "round"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.round_num == w.round_num
            assert g.cost_model == w.cost_model
            assert g.flags == w.flags
            assert g.pad_floors == w.pad_floors
            for k in w.arrays:
                assert np.array_equal(g.arrays[k], w.arrays[k]), k
            assert g.meta.task_uids == w.meta.task_uids
            assert np.array_equal(
                g.result["assignment"], w.result["assignment"]
            )
            assert g.result["cost"] == w.result["cost"]
            if w.warm_seed is not None:
                for a, b in zip(g.warm_seed, w.warm_seed):
                    assert np.array_equal(a, b)

    def test_dumps_cross_load(self, tmp_path):
        """Each package's ``load_dump`` reads the other's dump to the
        same records; the manifests differ only in the version keys."""
        paths, manifests = {}, {}
        for pkg in (REF, PORT):
            bridge, _, _ = _churn_session(tmp_path, rounds=3, pkg=pkg)
            paths[pkg.name] = bridge.flight_dump("manual", label="x")
            m = json.load(open(paths[pkg.name]))
            for k in ("created_unix", "poseidon_tpu", "jax", "torch",
                      "device"):
                m.pop(k, None)
            for rec in m["records"]:
                for k in list(rec.get("stats") or {}):
                    if k.endswith("_ms"):
                        rec["stats"].pop(k)  # host clock readings
            manifests[pkg.name] = m
        assert manifests["port"] == manifests["ref"]
        for path in paths.values():
            a = [record_view(r)
                 for r in ref_flightrec.load_dump(path)["records"]]
            b = [record_view(r)
                 for r in port_flightrec.load_dump(path)["records"]]
            assert a == b
        assert port_flightrec.DUMP_FORMAT == ref_flightrec.DUMP_FORMAT

    def test_dump_emits_trace_event_and_metric(self, tmp_path):
        metrics = SchedulerMetrics(MetricsRegistry())
        fr = FlightRecorder(str(tmp_path / "fr"), rounds=2, metrics=metrics)
        bridge = SchedulerBridge(
            cost_model="trivial", small_to_oracle=False, flightrec=fr,
            device="cpu",
        )
        cluster = make_synthetic_cluster(8, 20, seed=1)
        bridge.observe_nodes(list(cluster.machines))
        bridge.observe_pods(list(cluster.tasks))
        bridge.run_scheduler()
        path = bridge.flight_dump("manual")
        assert path is not None
        evs = [e for e in bridge.trace.events
               if e.event == "FLIGHTREC_DUMP"]
        assert len(evs) == 1
        assert evs[0].detail["reason"] == "manual"
        assert evs[0].detail["path"] == path
        text = metrics.registry.render()
        assert 'poseidon_flightrec_dumps_total{reason="manual"} 1' in text

    def test_empty_ring_dump_is_none(self, tmp_path):
        bridge = SchedulerBridge(
            cost_model="trivial", device="cpu",
            flightrec=FlightRecorder(str(tmp_path / "fr")),
        )
        assert bridge.flight_dump("manual") is None

    def test_undeclared_reason_raises(self, tmp_path):
        fr = FlightRecorder(str(tmp_path / "fr"))
        with pytest.raises(ValueError):
            fr.dump("because")
        assert "manual" in DUMP_REASONS
        assert DUMP_REASONS == ref_flightrec.DUMP_REASONS

    def test_anomaly_dumps_are_cooldown_throttled(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=2)
        assert fr.dump("degrade") is not None
        assert fr.dump("degrade") is None  # within cooldown
        assert fr.dumps_suppressed == 1
        assert fr.dump("fetch-timeout") is not None  # other reason
        assert fr.dump("manual") is not None
        assert fr.dump("manual") is not None
        fr._last_dump["degrade"] -= fr.cooldown_s + 1
        assert fr.dump("degrade") is not None  # window elapsed

    def test_dump_stem_is_boot_unique(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=2)
        path = bridge.flight_dump("manual")
        assert f"flightrec-{fr._boot}-r" in os.path.basename(path)

    def test_watch_rv_stamped_into_records(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=1)
        bridge.flight_rv = "nodes=17,pods=42"
        bridge.observe_pod_event("ADDED", Task(
            uid="rv-pod", cpu_request=0.1, memory_request_kb=64,
        ))
        bridge.run_scheduler()
        rec = fr.last_round_record()
        assert rec.rv == "nodes=17,pods=42"
        path = bridge.flight_dump("manual")
        loaded = load_dump(path)
        last = [r for r in loaded["records"] if r.kind == "round"][-1]
        assert last.rv == "nodes=17,pods=42"


class TestAnomalyTriggers:
    @pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
    def test_express_degrade_dumps(self, tmp_path, pkg):
        fr = pkg.fr.FlightRecorder(str(tmp_path / "fr"), rounds=4)
        bridge = pkg.bridge.SchedulerBridge(
            cost_model="quincy", small_to_oracle=False, flightrec=fr,
            express_lane=True, express_max_batch=1, **pkg.kw,
        )
        cluster = pkg.synth.make_synthetic_cluster(
            10, 30, seed=2, prefs_per_task=2
        )
        bridge.observe_nodes(list(cluster.machines))
        bridge.observe_pods(list(cluster.tasks))
        res = bridge.run_scheduler()
        for uid, m in res.bindings.items():
            bridge.confirm_binding(uid, m)
        assert bridge.solver.express_ready
        events = [
            ("ADDED", pkg.cluster.Task(
                uid=f"burst-{k}", cpu_request=0.1, memory_request_kb=64))
            for k in range(2)
        ]
        assert bridge.express_batch(events) is None
        dumps = [
            f for f in os.listdir(tmp_path / "fr")
            if "express-degrade" in f and f.endswith(".json")
        ]
        assert len(dumps) == 1
        dump = pkg.fr.load_dump(str(tmp_path / "fr" / dumps[0]))
        ex = [r for r in dump["records"] if r.kind == "express"]
        assert ex and not ex[-1].result["ok"]
        assert {a["uid"] for a in ex[-1].arrivals} == {
            "burst-0", "burst-1"
        }

    def test_fetch_timeout_dumps(self, tmp_path, monkeypatch):
        bridge, fr, _ = _churn_session(tmp_path, rounds=2)

        def boom(_):
            raise FetchTimeout("synthetic deadline miss")

        monkeypatch.setattr(bridge.solver, "finish_round", boom)
        ir = bridge.begin_round()
        with pytest.raises(FetchTimeout):
            bridge.finish_round(ir)
        dumps = [
            f for f in os.listdir(tmp_path / "fr-port")
            if "fetch-timeout" in f and f.endswith(".json")
        ]
        assert len(dumps) == 1
        dump = load_dump(str(tmp_path / "fr-port" / dumps[0]))
        last = dump["records"][-1]
        assert last.kind == "round" and last.result is None

    def test_resync_storm_dumps_once(self, tmp_path):
        bridge, fr, _ = _churn_session(tmp_path, rounds=2)
        for _ in range(3):
            bridge.note_watch_activity(resyncs=STORM_RESYNCS)
            bridge.run_scheduler()
        dumps = [
            f for f in os.listdir(tmp_path / "fr-port")
            if "resync-storm" in f and f.endswith(".json")
        ]
        assert len(dumps) == 1  # latched: a persisting storm != spam


class TestZeroInterference:
    def test_recorder_does_not_change_decisions(self, tmp_path):
        _, _, with_fr = _churn_session(tmp_path, rounds=3, recorder=True)
        _, _, without = _churn_session(tmp_path, rounds=3, recorder=False)
        for a, b in zip(with_fr, without):
            assert a.bindings == b.bindings
            assert a.stats.cost == b.stats.cost
            assert a.stats.backend == b.stats.backend

    def test_recorder_adds_no_device_read(self, tmp_path):
        """Capture reads host arrays the round already holds: every
        round's result fetches and loop reads equal the same round's
        with the recorder off."""
        counts = {}
        for recorder in (True, False):
            bridge, _, _ = _churn_session(
                tmp_path / str(recorder), rounds=1, recorder=recorder,
            )
            seen = []
            for k in range(3):
                bridge.observe_pod_event("ADDED", Task(
                    uid=f"c-{k}", cpu_request=0.1, memory_request_kb=64,
                ))
                r = bridge.run_scheduler()
                for uid, m in r.bindings.items():
                    bridge.confirm_binding(uid, m)
                seen.append((bridge.solver.last_round_fetches,
                             bridge.solver.last_round_loop_syncs))
            counts[recorder] = seen
        # (a warm round that does not certify re-runs cold with a
        # second fetch, recorder or not: ROADMAP Queue 3, "Stale warm
        # starts")
        assert counts[True] == counts[False]

    def test_decision_log_detail_is_typed(self, tmp_path):
        bridge, _, _ = _churn_session(tmp_path, rounds=2)
        places = [
            d for _r, kind, _u, d in bridge.decision_log
            if kind == "PLACE"
        ]
        assert places
        for d in places:
            assert isinstance(d, dict)
            assert isinstance(d["cost"], int)
            assert d["margin"] is None or isinstance(d["margin"], int)
