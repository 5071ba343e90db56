"""Crash safety & HA: the port's ``ha/`` against the reference's.

The analogue of ``tests/test_ha.py`` with its seeds and shapes: each
case runs through ``poseidon_tpu_torch`` (``device="cpu"``) and, where
the case has an output, through ``poseidon_tpu`` on the same inputs,
and the two must be equal (tolerance 0):

- checkpoints round-trip the full warm surface (bridge state with
  aging, knowledge rings, pad floors, warm solve seed, builder
  columns, watch rv) through the same atomic, checksummed on-disk
  format — a snapshot of the same history is the same in both
  packages, and each package restores the other's checkpoints with
  its first round bit-identical to the writer's own;
- restore is invisible: the first post-restore round equals the
  uninterrupted twin's (and the reference's), preemption and the
  express flag on and off, as a warm delta build;
- the journal yields exactly-once actuation across every kill point,
  with the first post-restart round equal to the crash-free
  baseline's and to the reference's sweep, case for case;
- HA: lease election, a warm standby taking over, SIGTERM shutdown
  (in-process and a real subprocess) and the ``restored_warm`` detail.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import poseidon_tpu.apiclient as ref_api
import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cli as ref_cli
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.ha as ref_ha
import poseidon_tpu.ha.journal as ref_journal
import poseidon_tpu.ha.standby as ref_standby
import poseidon_tpu_torch.apiclient as port_api
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cli as port_cli
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.ha as port_ha
import poseidon_tpu_torch.ha.journal as port_journal
import poseidon_tpu_torch.ha.standby as port_standby

from tests.test_torch_graph import build_reference_oracle

REF = types.SimpleNamespace(
    name="ref", api=ref_api, bridge=ref_bridge, cli=ref_cli,
    cluster=ref_cluster, ha=ref_ha, journal=ref_journal,
    standby=ref_standby, kw={}, argv=[], module="poseidon_tpu.cli",
)
PORT = types.SimpleNamespace(
    name="port", api=port_api, bridge=port_bridge, cli=port_cli,
    cluster=port_cluster, ha=port_ha, journal=port_journal,
    standby=port_standby, kw={"device": "cpu"}, argv=["--device=cpu"],
    module="poseidon_tpu_torch.cli",
)
BOTH = [REF, PORT]


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    build_reference_oracle()


def make_bridge(pkg, **kw):
    kw.setdefault("small_to_oracle", False)
    return pkg.bridge.SchedulerBridge(
        cost_model=kw.pop("cost_model", "quincy"), **kw, **pkg.kw
    )


def synth_machines(pkg, n=6):
    return [
        pkg.cluster.Machine(
            name=f"n{i}", cpu_capacity=8.0, cpu_allocatable=8.0,
            memory_capacity_kb=1 << 24, memory_allocatable_kb=1 << 24,
            rack=f"r{i % 2}", max_tasks=8,
        )
        for i in range(n)
    ]


def synth_tasks(pkg, n=18, n_m=6, start=0):
    return [
        pkg.cluster.Task(
            uid=f"p{j:03d}", cpu_request=0.25, memory_request_kb=256,
            job=f"j{j // 6}",
            data_prefs={f"n{j % n_m}": 50} if j % 3 == 0 else {},
        )
        for j in range(start, start + n)
    ]


def task(pkg, **kw):
    return pkg.cluster.Task(**kw)


def run_and_confirm(bridge):
    r = bridge.run_scheduler()
    for uid, m in r.bindings.items():
        bridge.confirm_binding(uid, m)
    for uid, (_f, to) in r.migrations.items():
        bridge.confirm_migration(uid, to)
    for uid in r.preemptions:
        bridge.confirm_preemption(uid)
    return r


def round_key(r) -> dict:
    return dict(
        cost=r.stats.cost, bindings=dict(r.bindings),
        order=list(r.bindings), migrations=dict(r.migrations),
        preemptions=dict(r.preemptions), backend=r.stats.backend,
        build_mode=r.stats.build_mode,
    )


def _populate(server, n_nodes=5, n_pods=15):
    for i in range(n_nodes):
        server.add_node(f"n{i}", cpu="8", memory="16Gi", pods=8,
                        rack=f"r{i % 2}")
    for j in range(n_pods):
        prefs = {f"n{j % n_nodes}": 50} if j % 3 == 0 else None
        server.add_pod(f"p{j:03d}", cpu="250m", memory="256Mi",
                       job=f"j{j // 5}", data_prefs=prefs)


def _warm_bridge(pkg, **kw):
    b = make_bridge(pkg, **kw)
    b.observe_nodes(synth_machines(pkg))
    b.observe_pods(synth_tasks(pkg))
    run_and_confirm(b)
    # churn + a second round so the warm seed and delta columns are
    # genuinely exercised state, not first-round accidents
    b.observe_pod_event("ADDED", task(
        pkg, uid="x000", cpu_request=0.1, memory_request_kb=128,
    ))
    run_and_confirm(b)
    return b


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def snapshot_record(snap) -> dict:
    """Everything a checkpoint carries, as plain values."""
    cols = snap.cols
    return dict(
        round_num=snap.round_num, cost_model=snap.cost_model,
        flags=snap.flags,
        tasks=[dataclasses.astuple(t) for t in snap.tasks],
        machines=[dataclasses.astuple(m) for m in snap.machines],
        pad_floors=snap.pad_floors,
        warm=[np.asarray(a).tolist() for a in snap.warm_seed or ()],
        knowledge={
            side: {k: np.asarray(v).tolist()
                   for k, v in snap.knowledge[side].items()}
            for side in ("machines", "tasks")
        },
        cols=None if cols is None else {
            f.name: (getattr(cols, f.name).tolist()
                     if isinstance(getattr(cols, f.name), np.ndarray)
                     else getattr(cols, f.name))
            for f in dataclasses.fields(cols)
        },
        rv=snap.rv,
    )


class TestCheckpointRoundTrip:
    def test_round_trip_equality(self, tmp_path):
        b = _warm_bridge(PORT)
        mgr = PORT.ha.CheckpointManager(str(tmp_path))
        snap = mgr.capture(b)
        assert snap.warm_seed is not None
        assert snap.cols is not None
        mgr.write_sync(snap)
        got = PORT.ha.load_latest(str(tmp_path))
        assert got is not None
        assert got.round_num == b.round_num
        assert got.tasks == list(b.tasks.values())
        assert got.machines == list(b.machines.values())
        assert got.pad_floors == b.solver.pad_floors
        for a, g in zip(snap.warm_seed, got.warm_seed):
            assert np.array_equal(a, g)
        # knowledge aggregates reproduce bit-exactly
        names = list(b.machines)
        restored = make_bridge(PORT)
        restored.knowledge.restore_state(got.knowledge)
        assert np.array_equal(
            b.knowledge.machine_load(names),
            restored.knowledge.machine_load(names),
        )
        uids = list(b.tasks)
        assert np.array_equal(
            b.knowledge.task_cpu_usage(uids),
            restored.knowledge.task_cpu_usage(uids),
        )
        # builder columns round-trip (numeric + object columns)
        assert got.cols.machine_names == snap.cols.machine_names
        assert got.cols.uids.tolist() == snap.cols.uids.tolist()
        assert np.array_equal(got.cols.pref_m, snap.cols.pref_m)

    def test_snapshot_equals_reference(self, tmp_path):
        """The same history captures the same checkpoint in both
        packages, in memory and after a write/load round trip."""
        recs = {}
        for pkg in BOTH:
            b = _warm_bridge(pkg)
            mgr = pkg.ha.CheckpointManager(str(tmp_path / pkg.name))
            snap = mgr.capture(b)
            mgr.write_sync(snap)
            got = pkg.ha.load_latest(str(tmp_path / pkg.name))
            recs[pkg.name] = (snapshot_record(snap), snapshot_record(got))
        assert recs["port"] == recs["ref"]

    def test_manifest_keys_equal_reference(self, tmp_path):
        manifests = {}
        for pkg in BOTH:
            b = _warm_bridge(pkg)
            mgr = pkg.ha.CheckpointManager(str(tmp_path / pkg.name))
            path = mgr.write_sync(mgr.capture(b))
            with open(path) as fh:
                m = json.load(fh)
            for k in ("created_unix", "npz_sha256", "npz_bytes"):
                m.pop(k)
            manifests[pkg.name] = m
        assert manifests["port"] == manifests["ref"]
        assert port_ha.checkpoint.CKPT_FORMAT == ref_ha.checkpoint.CKPT_FORMAT

    def test_prune_keeps_newest(self, tmp_path):
        b = _warm_bridge(PORT)
        mgr = PORT.ha.CheckpointManager(str(tmp_path), keep=2)
        for _ in range(4):
            mgr.write_sync(mgr.capture(b))
        manifests = [n for n in os.listdir(tmp_path)
                     if n.endswith(".json")]
        assert len(manifests) == 2

    def test_torn_npz_falls_back(self, tmp_path):
        b = _warm_bridge(PORT)
        mgr = PORT.ha.CheckpointManager(str(tmp_path), keep=4)
        mgr.write_sync(mgr.capture(b))
        first_round = b.round_num
        run_and_confirm(b)
        mgr.write_sync(mgr.capture(b))
        newest = sorted(
            n for n in os.listdir(tmp_path) if n.endswith(".npz")
        )[-1]
        path = tmp_path / newest
        data = path.read_bytes()
        path.write_bytes(data[: len(data) // 2])  # torn write
        got = PORT.ha.load_latest(str(tmp_path))
        assert got is not None
        assert got.round_num == first_round

    def test_manifest_without_npz_skipped(self, tmp_path):
        b = _warm_bridge(PORT)
        mgr = PORT.ha.CheckpointManager(str(tmp_path), keep=4)
        mgr.write_sync(mgr.capture(b))
        first_round = b.round_num
        run_and_confirm(b)
        mgr.write_sync(mgr.capture(b))
        newest = sorted(
            n for n in os.listdir(tmp_path) if n.endswith(".npz")
        )[-1]
        os.remove(tmp_path / newest)
        got = PORT.ha.load_latest(str(tmp_path))
        assert got.round_num == first_round

    def test_empty_dir_is_none(self, tmp_path):
        assert PORT.ha.load_latest(str(tmp_path)) is None
        assert PORT.ha.load_latest(str(tmp_path / "missing")) is None

    def test_mismatched_cost_model_drops_warm_keeps_floors(
        self, tmp_path
    ):
        b = _warm_bridge(PORT)
        mgr = PORT.ha.CheckpointManager(str(tmp_path))
        mgr.write_sync(mgr.capture(b))
        other = make_bridge(PORT, cost_model="octopus")
        PORT.ha.restore_bridge(other, PORT.ha.load_latest(str(tmp_path)))
        assert other.solver.warm_seed_host is None
        assert other.solver.pad_floors == b.solver.pad_floors

    def test_cross_boot_ordering_survives_round_reset(self, tmp_path):
        """A cold-restarted daemon's round numbers reset; the boot
        token keeps the newest boot's checkpoints newest."""
        b = _warm_bridge(PORT)
        old_mgr = PORT.ha.CheckpointManager(str(tmp_path), keep=2)
        old_snap = old_mgr.capture(b)
        old_snap.round_num = 100  # the long-lived dead boot
        old_mgr.write_sync(old_snap)
        time.sleep(0.002)  # ms-resolution boot token
        new_mgr = PORT.ha.CheckpointManager(str(tmp_path), keep=2)
        new_snap = new_mgr.capture(b)
        new_snap.round_num = 1  # fresh boot, counters reset
        new_mgr.write_sync(new_snap)
        got = PORT.ha.load_latest(str(tmp_path))
        assert got.round_num == 1, "resurrected the dead boot's state"
        new_mgr.write_sync(new_snap)  # prune (keep=2) runs
        kept = sorted(
            n for n in os.listdir(tmp_path) if n.endswith(".json")
        )
        assert len(kept) == 2
        assert all("-r00000001-" in n for n in kept), kept

    def test_background_writer_lands(self, tmp_path):
        b = _warm_bridge(PORT)
        mgr = PORT.ha.CheckpointManager(str(tmp_path))
        mgr.submit(mgr.capture(b))
        mgr.close()
        assert PORT.ha.load_latest(str(tmp_path)) is not None
        assert mgr.writes_total == 1

    def test_capture_reads_no_device_tensor(self, tmp_path):
        """The warm seed a checkpoint stores is the host numpy mirror
        the round's one fetch already brought back: capturing and
        writing it adds no result fetch and no loop read."""
        b = _warm_bridge(PORT)
        fetches = b.solver._fetches.count
        loops = b.solver._loop_syncs.count
        mgr = PORT.ha.CheckpointManager(str(tmp_path))
        snap = mgr.capture(b)
        mgr.write_sync(snap)
        assert all(isinstance(a, np.ndarray) for a in snap.warm_seed)
        assert b.solver._fetches.count == fetches
        assert b.solver._loop_syncs.count == loops


# ---------------------------------------------------------------------------
# restore differential: the first post-restore round is bit-identical
# ---------------------------------------------------------------------------


def restore_case(pkg, tmp_path, preemption, express, writer=None):
    """The reference test's history: two warm rounds, a checkpoint, two
    arrivals; returns (the uninterrupted twin's round, the restored
    bridge's round). ``writer`` (a package) writes the checkpoint the
    restored bridge of ``pkg`` reads (default: ``pkg`` itself)."""
    writer = writer or pkg
    flags = dict(enable_preemption=preemption, express_lane=express)
    A = make_bridge(writer, **flags)
    A.observe_nodes(synth_machines(writer))
    A.observe_pods(synth_tasks(writer))
    run_and_confirm(A)
    done = next(iter(A.pod_to_machine))
    A.observe_pod_event("DELETED", A.tasks[done])
    A.observe_pod_event("ADDED", task(
        writer, uid="x000", cpu_request=0.1, memory_request_kb=128,
        data_prefs={"n2": 70},
    ))
    run_and_confirm(A)

    ckpt = str(tmp_path / f"ckpt-{writer.name}-{pkg.name}")
    mgr = writer.ha.CheckpointManager(ckpt)
    mgr.write_sync(mgr.capture(A))

    def arrivals(p):
        return [
            task(p, uid="x001", cpu_request=0.1, memory_request_kb=128,
                 data_prefs={"n3": 70}),
            task(p, uid="x002", cpu_request=0.3, memory_request_kb=512),
        ]

    for t in arrivals(writer):
        A.observe_pod_event("ADDED", t)
    rA = A.run_scheduler()

    B = make_bridge(pkg, **flags)
    snap = pkg.ha.load_latest(ckpt)
    assert snap.warm_seed is not None, "checkpoint lost the seed"
    pkg.ha.restore_bridge(B, snap)
    for t in arrivals(pkg):
        B.observe_pod_event("ADDED", t)
    rB = B.run_scheduler()
    return round_key(rA), round_key(rB), B


class TestRestoreDifferential:
    @pytest.mark.parametrize("express", [False, True])
    @pytest.mark.parametrize("preemption", [False, True])
    def test_first_round_bit_identical(
        self, tmp_path, preemption, express
    ):
        rA, rB, B = restore_case(PORT, tmp_path, preemption, express)
        assert rB == rA
        # the restore was WARM: the primed builder columns patched (no
        # cold re-extract), the dense lane solved, one result fetch
        assert rB["build_mode"] == "delta"
        assert rB["backend"] == "dense_auction"
        assert B.solver.last_round_fetches == 1
        ref_A, ref_B, _ = restore_case(REF, tmp_path, preemption, express)
        assert rB == ref_B

    @pytest.mark.parametrize("writer,reader", [
        ("ref", "port"), ("port", "ref"),
    ], ids=["ref-writes-port-restores", "port-writes-ref-restores"])
    def test_cross_package_checkpoint(self, tmp_path, writer, reader):
        """A checkpoint one package writes, the other restores: the
        first post-restore round equals the writer package's own
        uninterrupted round, bit for bit."""
        w = REF if writer == "ref" else PORT
        r = PORT if reader == "port" else REF
        rA, rB, _ = restore_case(r, tmp_path, True, False, writer=w)
        assert rB == rA
        assert rB["build_mode"] == "delta"
        assert rB["backend"] == "dense_auction"

    def test_restored_bridge_keeps_scheduling(self, tmp_path):
        A = make_bridge(PORT)
        A.observe_nodes(synth_machines(PORT))
        A.observe_pods(synth_tasks(PORT, n=12))
        run_and_confirm(A)
        mgr = PORT.ha.CheckpointManager(str(tmp_path))
        mgr.write_sync(mgr.capture(A))
        B = make_bridge(PORT)
        PORT.ha.restore_bridge(B, PORT.ha.load_latest(str(tmp_path)))
        for k in range(3):
            B.observe_pod_event("ADDED", task(
                PORT, uid=f"y{k}", cpu_request=0.1, memory_request_kb=128,
            ))
            r = run_and_confirm(B)
            assert r.stats.pods_placed == 1
            assert r.stats.backend == "dense_auction"

    def test_rebalancing_restart_no_migration_storm(self, tmp_path):
        A = make_bridge(PORT, enable_preemption=True)
        A.observe_nodes(synth_machines(PORT))
        A.observe_pods(synth_tasks(PORT))
        run_and_confirm(A)
        for _ in range(4):
            r = run_and_confirm(A)
            if not (r.migrations or r.preemptions):
                break
        settled = run_and_confirm(A)
        assert not settled.migrations and not settled.preemptions
        mgr = PORT.ha.CheckpointManager(str(tmp_path))
        mgr.write_sync(mgr.capture(A))
        B = make_bridge(PORT, enable_preemption=True)
        PORT.ha.restore_bridge(B, PORT.ha.load_latest(str(tmp_path)))
        rB = B.run_scheduler()
        assert rB.migrations == {}
        assert rB.preemptions == {}


# ---------------------------------------------------------------------------
# watch resume from the checkpointed rv
# ---------------------------------------------------------------------------


class TestWatchResume:
    def test_resume_delivers_only_post_checkpoint_events(self):
        from poseidon_tpu_torch.apiclient.watch import ClusterWatcher

        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=3)
            client = PORT.api.K8sApiClient("127.0.0.1", server.port)
            w1 = ClusterWatcher(client)
            seed = w1.tick()
            assert seed.resynced
            rvs = w1.applied_rvs
            w1.stop()
            server.add_pod("late-1", cpu="100m", memory="128Mi")
            w2 = ClusterWatcher(client)
            w2.resume(rvs)
            assert w2.wait_caught_up(server.current_rv())
            delta = w2.tick()
            w2.stop()
            assert not delta.resynced
            uids = [t.uid for _typ, t in delta.pod_events]
            assert uids == ["default/late-1"]

    def test_resume_compacted_rv_resyncs_loudly(self):
        from poseidon_tpu_torch.apiclient.watch import ClusterWatcher

        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=3)
            client = PORT.api.K8sApiClient("127.0.0.1", server.port)
            w1 = ClusterWatcher(client)
            w1.tick()
            rvs = w1.applied_rvs
            w1.stop()
            server.add_pod("late-1", cpu="100m", memory="128Mi")
            server.compact_watch_log()  # rvs now too old: 410
            w2 = ClusterWatcher(client)
            w2.resume(rvs)
            deadline = time.monotonic() + 5.0
            resynced = False
            while time.monotonic() < deadline:
                d = w2.tick()
                if d.resynced:
                    resynced = True
                    assert any(
                        t.uid == "default/late-1" for t in d.pods
                    )
                    break
                time.sleep(0.02)
            w2.stop()
            assert resynced, "compacted rv did not force a resync"


# ---------------------------------------------------------------------------
# the actuation journal
# ---------------------------------------------------------------------------


def _journal_lines(path) -> list[dict]:
    with open(path) as fh:
        out = [json.loads(x) for x in fh if x.strip()]
    for d in out:
        d.pop("t", None)  # the wall clock of the write
    return out


class TestJournal:
    def test_incomplete_folding(self, tmp_path):
        j = PORT.ha.ActuationJournal(str(tmp_path / "j.jsonl"))
        seqs = j.intents([
            {"op": "bind", "uid": "a", "machine": "n0"},
            {"op": "bind", "uid": "b", "machine": "n1"},
            {"op": "evict", "uid": "c", "from": "n2"},
        ], 7)
        j.posted(seqs[("bind", "a")])
        j.confirmed(seqs[("bind", "a")])
        j.posted(seqs[("bind", "b")])
        j.failed(seqs[("evict", "c")])
        j.close()
        inc = PORT.journal.incomplete_entries(str(tmp_path / "j.jsonl"))
        assert [(e.op, e.uid, e.phase) for e in inc] == [
            ("bind", "b", "posted")
        ]
        assert inc[0].round_num == 7

    def test_same_file_as_reference(self, tmp_path):
        """The same journal calls write the same JSONL in both
        packages (wall-clock stamps aside), and each package folds the
        other's file to the same incomplete entries."""
        paths = {}
        for pkg in BOTH:
            path = str(tmp_path / f"{pkg.name}.jsonl")
            j = pkg.ha.ActuationJournal(path)
            seqs = j.intents([
                {"op": "bind", "uid": "a", "machine": "n0",
                 "t_event_us": 5},
                {"op": "migrate", "uid": "b", "machine": "n1",
                 "from": "n2"},
                {"op": "evict", "uid": "c", "from": "n2"},
            ], 3)
            j.posted(seqs[("bind", "a")])
            j.confirmed(seqs[("bind", "a")])
            j.posted(seqs[("migrate", "b")])
            j.close()
            with open(path, "a") as fh:
                fh.write('{"seq": 9, "phase": "conf')  # a torn tail
            paths[pkg.name] = path
        with open(paths["ref"]) as a, open(paths["port"]) as b:
            ref_lines, port_lines = a.read(), b.read()
        ref_lines = ref_lines[: ref_lines.rindex("\n") + 1]
        port_lines = port_lines[: port_lines.rindex("\n") + 1]
        strip = [{k: v for k, v in json.loads(x).items() if k != "t"}
                 for x in ref_lines.splitlines()]
        assert strip == [
            {k: v for k, v in json.loads(x).items() if k != "t"}
            for x in port_lines.splitlines()
        ]

        def fold(mod, path):
            return [dataclasses.astuple(e)
                    for e in mod.incomplete_entries(path)]

        assert fold(PORT.journal, paths["ref"]) == fold(
            REF.journal, paths["ref"]
        )
        assert fold(REF.journal, paths["port"]) == fold(
            PORT.journal, paths["port"]
        )

    def test_rotate_keeps_incomplete(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = PORT.ha.ActuationJournal(path)
        seqs = j.intents([
            {"op": "bind", "uid": "a", "machine": "n0"},
            {"op": "bind", "uid": "b", "machine": "n1"},
        ], 1)
        j.confirmed(seqs[("bind", "a")])
        assert j.rotate() == 1
        inc = j.incomplete()
        assert [(e.op, e.uid) for e in inc] == [("bind", "b")]
        seqs2 = j.intents(
            [{"op": "bind", "uid": "d", "machine": "n2"}], 2
        )
        assert seqs2[("bind", "d")] > seqs[("bind", "b")]
        j.close()

    def test_torn_tail_tolerated(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = PORT.ha.ActuationJournal(path)
        j.intents([{"op": "bind", "uid": "a", "machine": "n0"}], 1)
        j.close()
        with open(path, "a") as fh:
            fh.write('{"seq": 99, "phase": "conf')  # crash mid-write
        inc = PORT.journal.incomplete_entries(path)
        assert [(e.op, e.uid) for e in inc] == [("bind", "a")]

    def test_reopen_repairs_torn_tail(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = PORT.ha.ActuationJournal(path)
        j.intents([{"op": "bind", "uid": "a", "machine": "n0"}], 1)
        j.close()
        with open(path, "a") as fh:
            fh.write('{"seq": 2, "phase": "int')  # crash mid-write
        j2 = PORT.ha.ActuationJournal(path)  # the restart
        j2.intents([{"op": "bind", "uid": "b", "machine": "n1"}], 2)
        assert [(e.op, e.uid) for e in j2.incomplete()] == [
            ("bind", "a"), ("bind", "b"),
        ]
        assert j2.rotate() == 2  # parses clean end to end
        j2.close()

    def test_discard_drops_everything_loudly(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = PORT.ha.ActuationJournal(path)
        j.intents([{"op": "bind", "uid": "a", "machine": "n0"}], 1)
        assert j.discard() == 1
        assert j.incomplete() == []
        j.close()

    def test_replay_bind_lands_and_is_idempotent(self):
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=2)
            client = PORT.api.K8sApiClient("127.0.0.1", server.port)
            entries = incomplete_from_ops(PORT, [
                {"op": "bind", "uid": "default/p000", "machine": "n0"},
            ])
            out = PORT.ha.replay_journal(client, entries)
            assert out["replayed"] == 1
            out2 = PORT.ha.replay_journal(client, entries)
            assert out2["already-applied"] == 1
            assert server.bindings == [("default/p000", "n0")]

    def test_replay_after_post_landed_without_ack(self):
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=2)
            client = PORT.api.K8sApiClient(
                "127.0.0.1", server.port, retries=0
            )
            server.apply_then_disconnect_next(1)
            ok = client.bind_pod_to_node("default/p000", "n0")
            assert not ok
            assert server.bindings == [("default/p000", "n0")]
            entries = incomplete_from_ops(PORT, [
                {"op": "bind", "uid": "default/p000", "machine": "n0"},
            ])
            out = PORT.ha.replay_journal(client, entries)
            assert out["already-applied"] == 1
            assert server.bindings == [("default/p000", "n0")]

    @pytest.mark.parametrize("pkg", BOTH, ids=["ref", "port"])
    def test_replay_stale_and_migrate_halfway(self, pkg):
        """The same replay outcomes and pod state in both packages."""
        with pkg.api.FakeApiServer() as server:
            _populate(server, n_nodes=3, n_pods=3)
            client = pkg.api.K8sApiClient("127.0.0.1", server.port)
            server.delete_pod("p002")
            assert client.bind_pod_to_node("default/p001", "n0")
            assert client.evict_pod("default/p001")
            entries = incomplete_from_ops(pkg, [
                {"op": "bind", "uid": "default/p002", "machine": "n1"},
                {"op": "migrate", "uid": "default/p001",
                 "machine": "n2", "from": "n0"},
            ])
            out = pkg.ha.replay_journal(client, entries)
            assert out["stale"] == 1
            assert out["replayed"] == 1
            pod = client.get_pod("default/p001")
            assert pod.machine == "n2"


def incomplete_from_ops(pkg, ops):
    """Incomplete JournalEntry objects built directly ('the journal
    held these intents at the crash')."""
    return [
        pkg.journal.JournalEntry(
            seq=i + 1, op=o["op"], uid=o["uid"],
            machine=o.get("machine", ""),
            from_machine=o.get("from", ""),
        )
        for i, o in enumerate(ops)
    ]


class TestBindConflict409:
    def test_daemon_does_not_requeue_on_duplicate(self):
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=4)
            client = PORT.api.K8sApiClient("127.0.0.1", server.port)
            bridge = PORT.bridge.SchedulerBridge(
                cost_model="trivial", device="cpu"
            )
            bridge.observe_nodes(client.all_nodes())
            bridge.observe_pods(client.all_pods())
            result = bridge.run_scheduler()
            for uid, m, ok in port_cli._post_bindings(
                client, bridge, result.bindings
            ):
                assert ok
                bridge.confirm_binding(uid, m)
            for uid, m, ok in port_cli._post_bindings(
                client, bridge, result.bindings
            ):
                assert ok, f"duplicate bind of {uid} read as failure"
            r2 = bridge.begin_round()
            assert r2.stats.bind_failures == 0
            bridge.cancel_round(r2)


# ---------------------------------------------------------------------------
# crash/restart fault-injection fuzz
# ---------------------------------------------------------------------------


class SimulatedCrash(Exception):
    pass


KILL_POINTS = (
    "after-intent",          # intents durable, nothing on the wire
    "mid-actuation",         # half the POSTs landed
    "between-post-and-mark",  # a POST landed, posted-mark lost
    "after-posted",          # posted recorded, confirm lost
    "post-landed-no-ack",    # server applied, connection died
    "mid-write",             # checkpoint npz staged, crash
    "pre-manifest",          # checkpoint npz live, manifest staged
)


class _CrashDaemon:
    """A minimal serial daemon mirroring cli.run_loop's journaled
    actuation order (intents -> POST -> posted -> confirm ->
    confirmed), with named kill points."""

    def __init__(self, pkg, server, tmp, preemption, express):
        self.pkg = pkg
        self.server = server
        self.tmp = str(tmp)
        self.preemption = preemption
        self.express = express
        self.client = pkg.api.K8sApiClient(
            "127.0.0.1", server.port, retries=0
        )

    def boot(self, restore, crash_hook=None):
        pkg = self.pkg
        bridge = make_bridge(
            pkg, enable_preemption=self.preemption,
            express_lane=self.express,
        )
        journal = pkg.ha.ActuationJournal(
            os.path.join(self.tmp, "journal.jsonl")
        )
        mgr = pkg.ha.CheckpointManager(self.tmp, crash_hook=crash_hook)
        if restore:
            snap = pkg.ha.load_latest(self.tmp)
            assert snap is not None
            pkg.ha.restore_bridge(bridge, snap)
            pkg.ha.replay_journal(
                self.client, journal.incomplete(), journal=journal
            )
        bridge.observe_nodes(self.client.all_nodes())
        bridge.observe_pods(self.client.all_pods())
        return bridge, journal, mgr

    def round(self, bridge, journal, kill=None):
        def kp(point):
            if kill == point:
                raise SimulatedCrash(point)

        result = bridge.run_scheduler()
        binds = list(result.bindings.items())
        seqs = journal.intents(
            [{"op": "bind", "uid": u, "machine": m} for u, m in binds],
            bridge.round_num,
        )
        kp("after-intent")
        if kill == "post-landed-no-ack" and binds:
            self.server.apply_then_disconnect_next(1)
        for i, (uid, machine) in enumerate(binds):
            if kill == "mid-actuation" and i == max(len(binds) // 2, 1):
                raise SimulatedCrash(kill)
            ok = self.client.bind_pod_to_node(
                uid, machine, namespace="default"
            )
            if kill == "post-landed-no-ack" and i == 0:
                assert not ok
                raise SimulatedCrash(kill)
            assert ok
            kp("between-post-and-mark")
            journal.posted(seqs[("bind", uid)])
            kp("after-posted")
            bridge.confirm_binding(uid, machine)
            journal.confirmed(seqs[("bind", uid)])
        return result


def crash_sweep(pkg, tmp_path, preemption, express, kill_points):
    """Every kill point of one flag combination in one package; returns
    {kill: (server pod -> node, first post-restart cost, bindings)}."""
    outcomes = {}
    for kill in (None,) + tuple(kill_points):
        case = tmp_path / f"{pkg.name}-{kill or 'baseline'}"
        case.mkdir()
        with pkg.api.FakeApiServer() as server:
            _populate(server, n_nodes=5, n_pods=10)
            drv = _CrashDaemon(pkg, server, case, preemption, express)
            bridge, journal, mgr = drv.boot(restore=False)
            drv.round(bridge, journal)            # round 1: places
            mgr.write_sync(mgr.capture(bridge))   # the checkpoint
            journal.rotate()
            for k in range(3):
                server.add_pod(f"x{k}", cpu="100m", memory="128Mi",
                               data_prefs={f"n{k}": 60})
            bridge.observe_pods(drv.client.all_pods())
            if kill in ("mid-write", "pre-manifest"):
                drv.round(bridge, journal)

                def hook(p, _kill=kill):
                    if p == _kill:
                        raise SimulatedCrash(p)

                mgr.crash_hook = hook
                with pytest.raises(SimulatedCrash):
                    mgr.write_sync(mgr.capture(bridge))
            elif kill is not None:
                with pytest.raises(SimulatedCrash):
                    drv.round(bridge, journal, kill=kill)
            else:
                drv.round(bridge, journal)        # baseline round 2
            journal.close()
            for k in range(2):
                server.add_pod(f"z{k}", cpu="100m", memory="128Mi",
                               data_prefs={f"n{k + 2}": 60})

            # ---- "restart": fresh process state, restore + replay ----
            bridge2, journal2, _ = drv.boot(restore=True)
            r3 = bridge2.run_scheduler()
            assert journal2.incomplete() == [], (
                f"{pkg.name} kill={kill}: journal not settled"
            )
            journal2.close()
            server.apply_pending()
            bound = {
                k: d.get("spec", {}).get("nodeName", "")
                for k, d in server.pods.items()
            }
            pods_bound_log = [p for p, _n in server.bindings]
            assert len(pods_bound_log) == len(set(pods_bound_log)), (
                f"{pkg.name} kill={kill}: duplicate binding accepted"
            )
            for k in range(3):
                assert bound.get(f"default/x{k}"), (
                    f"{pkg.name} kill={kill}: placement of x{k} lost"
                )
            outcomes[kill] = (
                dict(sorted(bound.items())), r3.stats.cost,
                dict(sorted(r3.bindings.items())),
            )
    return outcomes


@pytest.mark.parametrize("preemption,express", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_crash_fuzz_exactly_once_and_twin_identical(
    tmp_path, preemption, express
):
    """Sweep every kill point: exactly-once actuation server-side, the
    first post-restart round equal to the crash-free baseline's, and
    every case equal to the reference's sweep."""
    kill_points = KILL_POINTS if not (preemption or express) else (
        "after-intent", "mid-actuation", "post-landed-no-ack",
    )
    port = crash_sweep(PORT, tmp_path, preemption, express, kill_points)
    baseline = port[None]
    for kill in kill_points:
        assert port[kill] == baseline, f"kill={kill} diverged"
    ref = crash_sweep(REF, tmp_path, preemption, express, kill_points)
    assert port == ref


# ---------------------------------------------------------------------------
# leader election + warm standby
# ---------------------------------------------------------------------------


def daemon_argv(pkg, server, *extra):
    return [
        f"--k8s_apiserver_port={server.port}",
        "--k8s_apiserver_host=127.0.0.1",
        "--flow_scheduling_cost_model=trivial",
        *pkg.argv, *extra,
    ]


class TestLeaderElection:
    def test_acquire_conflict_expiry_release(self):
        with PORT.api.FakeApiServer() as server:
            client = PORT.api.K8sApiClient("127.0.0.1", server.port)
            e1 = PORT.ha.LeaderElector(client, identity="a", duration_s=0.3)
            e2 = PORT.ha.LeaderElector(client, identity="b", duration_s=0.3)
            assert e1.try_acquire()
            assert not e2.try_acquire()
            assert e1.renew()
            assert not e2.try_acquire()
            time.sleep(0.4)
            assert e2.try_acquire()
            assert not e1.renew()
            e2.release()
            assert e1.try_acquire()

    def test_leader_steps_down_on_lost_lease(self):
        class _LostLease:
            def renew(self):
                return False

        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=4)
            rc = port_cli.run_loop(port_cli.parse_args(daemon_argv(
                PORT, server, "--polling_frequency=1000",
                "--max_rounds=5",
            )), lease=_LostLease())
            assert rc == 1
            assert server.bindings == []

    def test_warm_standby_takes_over_without_cold_start(self, tmp_path):
        """The leader checkpoints; it dies; the standby (which followed
        the checkpoints) wins the lease and serves its first round
        WARM — and that round equals the reference standby's."""
        out = {}
        for pkg in BOTH:
            leader = make_bridge(pkg, enable_preemption=True)
            leader.observe_nodes(synth_machines(pkg))
            leader.observe_pods(synth_tasks(pkg))
            run_and_confirm(leader)
            for _ in range(4):
                r = run_and_confirm(leader)
                if not (r.migrations or r.preemptions):
                    break
            ckpt = str(tmp_path / pkg.name)
            mgr = pkg.ha.CheckpointManager(ckpt)
            mgr.write_sync(mgr.capture(leader))
            with pkg.api.FakeApiServer() as server:
                client = pkg.api.K8sApiClient("127.0.0.1", server.port)
                e_leader = pkg.ha.LeaderElector(
                    client, identity="leader", duration_s=0.3
                )
                e_standby = pkg.ha.LeaderElector(
                    client, identity="standby", duration_s=0.3
                )
                assert e_leader.try_acquire()
                snap, _mtime = pkg.standby.follow_checkpoints(
                    ckpt, None, 0.0
                )
                assert snap is not None
                assert not e_standby.try_acquire()
                time.sleep(0.4)
                assert e_standby.try_acquire()
            standby = make_bridge(pkg, enable_preemption=True)
            pkg.ha.restore_bridge(standby, snap)
            assert standby.solver.warm_seed_host is not None
            r = standby.run_scheduler()
            assert r.stats.build_mode == "delta"
            assert r.stats.backend == "dense_auction"
            assert r.migrations == {} and r.preemptions == {}
            out[pkg.name] = round_key(r)
        assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# graceful shutdown (SIGTERM)
# ---------------------------------------------------------------------------


class TestGracefulShutdown:
    def test_stop_event_finishes_and_checkpoints(self, tmp_path):
        trace_path = str(tmp_path / "trace.jsonl")
        ckpt_dir = str(tmp_path / "ckpt")
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=4, n_pods=12)
            stop = threading.Event()
            args = port_cli.parse_args(daemon_argv(
                PORT, server, "--polling_frequency=20000",
                f"--checkpoint_dir={ckpt_dir}", "--checkpoint_every=1",
                f"--trace_log={trace_path}",
            ))
            rc_box = {}

            def _run():
                rc_box["rc"] = port_cli.run_loop(args, stop_event=stop)

            t = threading.Thread(target=_run)
            t.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and \
                    len(server.bindings) < 12:
                time.sleep(0.05)
            stop.set()
            t.join(timeout=30)
            assert not t.is_alive()
            assert rc_box["rc"] == 0
            assert len(server.bindings) == 12
        snap = PORT.ha.load_latest(ckpt_dir)
        assert snap is not None
        with open(trace_path) as fh:
            events = [json.loads(line) for line in fh if line.strip()]
        finals = [e for e in events if e["event"] == "CHECKPOINT"
                  and e["detail"]["final"]]
        assert len(finals) == 1

    def test_sigterm_subprocess_exits_zero(self, tmp_path):
        """The real signal path: a daemon subprocess gets SIGTERM
        mid-run and exits 0 with a loadable checkpoint and an untorn
        trace tail."""
        trace_path = str(tmp_path / "trace.jsonl")
        ckpt_dir = str(tmp_path / "ckpt")
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=4, n_pods=12)
            proc = subprocess.Popen(
                [sys.executable, "-m", PORT.module, *daemon_argv(
                    PORT, server, "--polling_frequency=50000",
                    f"--checkpoint_dir={ckpt_dir}",
                    "--checkpoint_every=1", f"--trace_log={trace_path}",
                )],
            )
            try:
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline and \
                        len(server.bindings) < 12:
                    time.sleep(0.1)
                assert len(server.bindings) == 12, "daemon never bound"
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            assert rc == 0
        snap = PORT.ha.load_latest(ckpt_dir)
        assert snap is not None
        assert sorted(t.uid for t in snap.tasks) == sorted(
            f"default/p{j:03d}" for j in range(12)
        )
        with open(trace_path) as fh:
            events = [json.loads(line) for line in fh if line.strip()]
        assert any(e["event"] == "CHECKPOINT" and e["detail"]["final"]
                   for e in events)


# ---------------------------------------------------------------------------
# observability satellites
# ---------------------------------------------------------------------------


class TestHaObservability:
    def test_metrics_families(self):
        from poseidon_tpu_torch.obs import MetricsRegistry, SchedulerMetrics

        m = SchedulerMetrics(MetricsRegistry())
        m.record_checkpoint(12345)
        m.record_checkpoint_age(3.5)
        m.record_journal_replay("replayed")
        m.record_journal_replay("already-applied")
        m.record_restore()
        text = m.registry.render()
        assert "poseidon_checkpoint_bytes 12345" in text
        assert "poseidon_checkpoint_age_seconds 3.5" in text
        assert ('poseidon_journal_replays_total{outcome="replayed"} 1'
                in text)
        assert "poseidon_restores_total 1" in text

    def test_readyz_restored_warm_detail(self):
        from poseidon_tpu_torch.obs import (
            HealthState,
            MetricsRegistry,
            ObsServer,
        )

        health = HealthState()
        srv = ObsServer(MetricsRegistry(), health, port=0,
                        host="127.0.0.1")
        port = srv.start()
        try:
            health.mark_seeded()
            health.mark_round("dense_auction")
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/readyz"
            ) as r:
                assert r.status == 200
                assert b"restored_warm" not in r.read()
            health.mark_restored_warm()
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/readyz"
            ) as r:
                assert r.status == 200
                assert b"restored_warm=true" in r.read()
        finally:
            srv.stop()

    def test_flight_dump_retention(self, tmp_path):
        from poseidon_tpu_torch.obs.flightrec import (
            FlightRecorder,
            load_dump,
        )

        fr = FlightRecorder(str(tmp_path), max_dumps=2, cooldown_s=0.0)
        bridge = make_bridge(PORT, flightrec=fr)
        bridge.observe_nodes(synth_machines(PORT, n=3))
        bridge.observe_pods(synth_tasks(PORT, n=6, n_m=3))
        run_and_confirm(bridge)
        for _ in range(4):
            assert bridge.flight_dump("manual") is not None
        manifests = [n for n in os.listdir(tmp_path)
                     if n.endswith(".json")]
        assert len(manifests) == 2
        assert fr.dumps_pruned == 2
        assert fr.dumps_total == 4
        for n in manifests:
            load_dump(str(tmp_path / n))

    @pytest.mark.parametrize("pkg", BOTH, ids=["ref", "port"])
    def test_journal_replays_on_cold_start_without_checkpoint(
        self, tmp_path, pkg
    ):
        """A crash BEFORE the first checkpoint still leaves journaled
        intents that settle exactly once — in both daemons alike."""
        ckpt_dir = tmp_path / "ckpt"
        ckpt_dir.mkdir()
        with pkg.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=2)
            j = pkg.ha.ActuationJournal(str(ckpt_dir / "journal.jsonl"))
            j.intents(
                [{"op": "bind", "uid": "default/p000",
                  "machine": "n1"}], 1,
            )
            j.close()
            rc = pkg.cli.run_loop(pkg.cli.parse_args(daemon_argv(
                pkg, server, "--polling_frequency=1000",
                "--max_rounds=1", f"--checkpoint_dir={ckpt_dir}",
            )))
            assert rc == 0
            assert ("default/p000", "n1") in server.bindings
            pods = [p for p, _n in server.bindings]
            assert len(pods) == len(set(pods)) == 2
        assert pkg.journal.incomplete_entries(
            str(ckpt_dir / "journal.jsonl")
        ) == []

    def test_run_standby_takes_over_and_schedules(self, tmp_path):
        """The full --standby path: a previous boot's checkpoint
        exists, the lease is free — run_standby acquires, restores warm
        from the FINAL checkpoint, schedules new work, exits cleanly."""
        ckpt_dir = str(tmp_path / "ckpt")
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=3, n_pods=6)
            base = daemon_argv(
                PORT, server, "--polling_frequency=1000",
                f"--checkpoint_dir={ckpt_dir}", "--checkpoint_every=1",
                "--standby_lease_s=1.0",
            )
            assert port_cli.run_loop(
                port_cli.parse_args(base + ["--max_rounds=2"])
            ) == 0
            server.add_pod("late-0", cpu="100m", memory="128Mi")
            rc = port_standby.run_standby(port_cli.parse_args(base + [
                "--max_rounds=1", "--restore=auto",
            ]))
            assert rc == 0
            assert server.bindings[-1][0] == "default/late-0"
            assert len(server.bindings) == 7

    def test_main_standby_flag(self, tmp_path):
        """``main`` routes ``--standby=true`` to the standby loop."""
        ckpt_dir = str(tmp_path / "ckpt")
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=3, n_pods=6)
            rc = port_cli.main(daemon_argv(
                PORT, server, "--polling_frequency=1000",
                f"--checkpoint_dir={ckpt_dir}", "--standby=true",
                "--standby_lease_s=1.0", "--max_rounds=1",
            ))
            assert rc == 0
            assert len(server.bindings) == 6

    def test_restore_emits_trace_and_metrics(self, tmp_path):
        ckpt_dir = str(tmp_path / "ckpt")
        trace_path = str(tmp_path / "trace.jsonl")
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=4, n_pods=8)
            base = daemon_argv(
                PORT, server, "--polling_frequency=1000",
                f"--checkpoint_dir={ckpt_dir}", "--checkpoint_every=1",
            )
            assert port_cli.run_loop(port_cli.parse_args(
                base + ["--max_rounds=2"]
            )) == 0
            server.add_pod("late-0", cpu="100m", memory="128Mi")
            assert port_cli.run_loop(port_cli.parse_args(base + [
                "--max_rounds=1", "--restore=true",
                f"--trace_log={trace_path}",
            ])) == 0
            assert len(server.bindings) == 9
        with open(trace_path) as fh:
            events = [json.loads(line) for line in fh if line.strip()]
        restore = next(e for e in events if e["event"] == "RESTORE")
        assert restore["detail"]["warm"] in (True, False)

    def test_restore_true_without_checkpoint_exits_one(self, tmp_path):
        with PORT.api.FakeApiServer() as server:
            _populate(server, n_nodes=2, n_pods=2)
            rc = port_cli.run_loop(port_cli.parse_args(daemon_argv(
                PORT, server, "--polling_frequency=1000",
                "--max_rounds=1",
                f"--checkpoint_dir={tmp_path / 'empty'}",
                "--restore=true",
            )))
            assert rc == 1
            assert server.bindings == []
            # no final checkpoint for a loop that never ran
            assert PORT.ha.load_latest(str(tmp_path / "empty")) is None
