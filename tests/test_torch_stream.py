"""Differential tests: the port's stream lane vs the reference's.

The port of ``tests/test_stream.py``: the same clusters and watch-event
windows go through ``poseidon_tpu``'s bridge and ``poseidon_tpu_torch``'s
(``device="cpu"``) side by side. Every flush is compared window by
window — the compacted rows and assignments, n_changes, the latch
(live), conv, domain_ok, repair rounds and primal — and then the final
carry (table, u, w, s, task_valid, asg, lvl, floor), the bindings, the
trace and the next round's stats, all with tolerance 0. Beside them,
K7 ``stream_commit``'s plain twins against the reference's lines: its
commit piece against the scan step's (``ops/resident.py:658-690``) at
its edge inputs (a live window, the first dead window, an already-dead
stream, a report on a column driven below 0, rows 0 and Tp-1), and the
whole window tail against ``_express_step``'s l.526-545 chained with
the scan step's, with and without the commit, at 0, cap and cap + 1
changed rows, for live and dead windows.

The scale-lane composition of the reference's differential class runs
too: aggregation, mesh width 1 and mesh width 8 (the port's mesh on
``[cpu] * width``, the reference's on its 8 forced host devices); so do
an 8-window flush and a rebalancing-mode freeze of more running rows
than one K5 chunk holds (one multi-chunk backlog a call in both lanes).
"""

from __future__ import annotations

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.synth as ref_synth
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.ops.dense_auction as port_da
import poseidon_tpu_torch.ops.resident as port_res
import poseidon_tpu_torch.synth as port_synth
from poseidon_tpu.compat import enable_x64
from poseidon_tpu.trace import TraceGenerator as RefTrace
from poseidon_tpu_torch.kernels.stream_commit import (
    commit_plain,
    log_width,
)
from poseidon_tpu_torch.trace import TraceGenerator as PortTrace

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REF = types.SimpleNamespace(bridge=ref_bridge, cluster=ref_cluster,
                            synth=ref_synth, trace=RefTrace, kw={},
                            name="ref")
PORT = types.SimpleNamespace(bridge=port_bridge, cluster=port_cluster,
                             synth=port_synth, trace=PortTrace,
                             kw={"device": "cpu"}, name="port")
INF = 2**29


def make_stream_bridge(pkg, n_machines=20, n_tasks=90, seed=3, *,
                       stream_windows=3, trace=None, confirm=True, **kw):
    """A bridge on the dense lane with the stream lane armed and one
    certified round behind it, plus its cluster."""
    cluster = pkg.synth.make_synthetic_cluster(
        n_machines, n_tasks, seed=seed, prefs_per_task=2,
        **({"running_fraction": kw.pop("running_fraction")}
           if "running_fraction" in kw else {}),
    )
    bridge = pkg.bridge.SchedulerBridge(
        cost_model="quincy", small_to_oracle=False, express_lane=True,
        stream_windows=stream_windows, trace=trace, **kw, **pkg.kw,
    )
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    res = bridge.run_scheduler()
    if confirm:
        for uid, m in res.bindings.items():
            bridge.confirm_binding(uid, m)
    return bridge, cluster


def arrival(pkg, uid, cluster=None, k=0, cpu=0.2, mem=256):
    prefs = {}
    if cluster is not None:
        prefs = {cluster.machines[k % len(cluster.machines)].name: 400}
    return pkg.cluster.Task(uid=uid, cpu_request=cpu, memory_request_kb=mem,
                            data_prefs=prefs)


def flush_logs(pkg, bridge) -> dict:
    """Flush, then read the in-flight batch's per-window logs and final
    carry (before ``stream_finish`` consumes them) as host arrays."""
    bridge.stream_flush()
    inf = bridge.solver._stream_inflight
    assert inf is not None
    if pkg is REF:
        (rows, asg, nchg, live, conv, dom, rnds,
         primal) = inf.future.result(60.0)
        carry = [np.asarray(x) for x in inf.carry]
    else:
        log, rnds, carry, _t = inf.future.result(60.0)
        cap = (log.shape[1] - 6) // 2
        rows, asg = log[:, :cap], log[:, cap: 2 * cap]
        nchg, live, conv, dom, primal = (log[:, 2 * cap + i]
                                         for i in range(5))
        carry = [torch.cat(x.blocks) if isinstance(x, port_da.RowBlocks)
                 else x for x in carry]   # a mesh's table: its row blocks
        carry = [x.numpy() for x in carry]
        carry[-1] = carry[-1][0]   # the port's latch is an int32[1]
    out = {
        "rows": np.asarray(rows, np.int64), "asg": np.asarray(asg, np.int64),
        "n_changes": np.asarray(nchg, np.int64),
        "live": np.asarray(live).astype(bool),
        "conv": np.asarray(conv).astype(bool),
        "domain_ok": np.asarray(dom).astype(bool),
        "rounds": np.asarray(rnds, np.int64),
        "primal": np.asarray(primal, np.int64),
    }
    names = ("c", "u", "w", "s", "valid", "asg", "lvl", "floor", "live")
    out.update({f"carry_{n}": np.asarray(v).astype(np.int64)
                for n, v in zip(names, carry)})
    return out


def assert_logs_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), (k, a[k], b[k])


def result_record(r):
    if r is None:
        return None
    return dict(r.bindings), r.cost, r.rounds


def both(script):
    ref_out, port_out = script(REF), script(PORT)
    assert port_out == ref_out
    return port_out


class TestStreamBasics:
    def test_k_windows_one_flush_binds_all(self):
        logs = {}

        def script(pkg):
            trace = pkg.trace()
            bridge, cluster = make_stream_bridge(pkg, stream_windows=3,
                                                 trace=trace)
            t0 = time.perf_counter()
            for w in range(3):
                assert bridge.stream_window(
                    [("ADDED", arrival(pkg, f"sw-{w}", cluster, w))],
                    t_event=t0,
                )
            assert bridge.solver.stream_pending_windows == 3
            logs[pkg.name] = flush_logs(pkg, bridge)
            assert bridge.solver.stream_inflight
            r = bridge.stream_finish()
            assert r is not None and r.latency_ms > 0
            assert bridge.solver.stream_fetches == 1
            assert bridge.solver.last_stream_windows == 3
            assert bridge.solver.last_stream_fetches == 1
            flush_ev = next(e for e in trace.events
                            if e.event == "STREAM_FLUSH")
            places = [(e.task, e.machine, e.detail["stream_window"])
                      for e in trace.events if e.event == "EXPRESS_PLACE"]
            for uid, m in r.bindings.items():
                bridge.confirm_binding(uid, m)
            stats = bridge.run_scheduler().stats
            return (result_record(r), sorted(r.bindings), flush_ev.detail,
                    places, stats.express_batches, stats.express_places,
                    stats.express_degrades, stats.cost,
                    list(bridge.decision_log))

        out = both(script)
        assert out[1] == ["sw-0", "sw-1", "sw-2"]
        assert out[2] == {"windows": 3, "placements": 3, "fetches": 1,
                          "failed_window": -1}
        assert out[4:7] == (3, 3, 0)
        assert_logs_equal(logs["ref"], logs["port"])
        assert logs["port"]["live"].all()

    def test_short_flush_pads_with_noop_windows(self):
        logs = {}

        def script(pkg):
            bridge, cluster = make_stream_bridge(pkg, stream_windows=4)
            assert bridge.stream_window(
                [("ADDED", arrival(pkg, "dr-0", cluster))])
            logs[pkg.name] = flush_logs(pkg, bridge)
            r = bridge.stream_finish()
            return (result_record(r), bridge.solver.last_stream_windows,
                    bridge.solver.stream_fetches)

        out = both(script)
        assert out[0][0] == {"dr-0": out[0][0]["dr-0"]}
        assert out[1:] == (1, 1)
        # four windows ran, three of them the no-op padding
        assert logs["port"]["rows"].shape[0] == 4
        assert_logs_equal(logs["ref"], logs["port"])

    def test_replay_noise_accumulates_nothing(self):
        def script(pkg):
            bridge, cluster = make_stream_bridge(pkg, stream_windows=3)
            bridge.stream_window([("ADDED", arrival(pkg, "rn-0", cluster))])
            bridge.stream_flush()
            r = bridge.stream_finish()
            bridge.confirm_binding("rn-0", r.bindings["rn-0"])
            pending0 = bridge.solver.stream_pending_windows
            ok = bridge.stream_window([("ADDED", bridge.tasks["rn-0"])])
            pending1 = bridge.solver.stream_pending_windows
            bridge.stream_flush()
            r2 = bridge.stream_finish()
            return (result_record(r), ok, pending0, pending1,
                    result_record(r2))

        out = both(script)
        assert out[1] and out[3] in (out[2], out[2] + 1)
        assert out[4] is None or out[4][0] == {}

    def test_buffer_overflow_degrades_loudly(self):
        def script(pkg):
            bridge, cluster = make_stream_bridge(pkg, stream_windows=2)
            oks = [bridge.stream_window(
                [("ADDED", arrival(pkg, f"of-{w}", cluster, w))])
                for w in range(3)]
            ready = bridge.solver.express_ready
            res = bridge.run_scheduler()
            return oks, ready, res.stats.express_degrades, dict(res.bindings)

        oks, ready, degrades, bindings = both(script)
        assert oks == [True, True, False] and not ready
        assert degrades == 1
        assert all(f"of-{w}" in bindings for w in range(3))

    def test_unconfirmed_stream_placement_blocks_next_window(self):
        def script(pkg):
            bridge, cluster = make_stream_bridge(pkg, stream_windows=2)
            bridge.stream_window([("ADDED", arrival(pkg, "uc-0", cluster))])
            bridge.stream_flush()
            r = bridge.stream_finish()
            ok = bridge.stream_window(
                [("ADDED", arrival(pkg, "uc-1", cluster))])
            res = bridge.run_scheduler()
            return (result_record(r), ok, res.stats.express_degrades,
                    dict(res.bindings))

        r, ok, degrades, bindings = both(script)
        assert "uc-0" in r[0] and not ok and degrades == 1
        assert "uc-1" in bindings

    def test_begin_round_abandons_pending_windows(self):
        def script(pkg):
            bridge, cluster = make_stream_bridge(pkg, stream_windows=3)
            bridge.stream_window([("ADDED", arrival(pkg, "ab-0", cluster))])
            pending = bridge.solver.stream_pending_windows
            res = bridge.run_scheduler()
            return (pending, bridge.solver.stream_pending_windows,
                    bridge.solver.stream_inflight, dict(res.bindings))

        pending, after, inflight, bindings = both(script)
        assert pending >= 1 and after == 0 and not inflight
        assert "ab-0" in bindings

    def test_begin_round_abandons_an_inflight_flush(self):
        """A flushed but unjoined batch is abandoned (and counted) by the
        next round, which starts from the same warm state as the
        reference's."""
        def script(pkg):
            bridge, cluster = make_stream_bridge(pkg, stream_windows=2)
            bridge.stream_window([("ADDED", arrival(pkg, "ai-0", cluster))])
            bridge.stream_flush()
            if pkg is PORT:
                bridge.solver._stream_inflight.future.result(60.0)
            res = bridge.run_scheduler()
            return (bridge.solver.stream_abandoned, dict(res.bindings),
                    res.stats.cost, res.stats.backend)

        out = both(script)
        assert out[0] == 1 and "ai-0" in out[1]


class TestStreamDifferential:
    """The K-window composition equals K synced express batches — same
    placements, costs and correction round — under churn and
    preemption, in both packages, and the two packages agree window by
    window."""

    def _drive_pair(self, pkg, K, cycles, seed, *, preemption=False,
                    opts=None, n_machines=16, n_tasks=70, running=None):
        kw = dict(opts or {})
        if preemption:
            kw.update(enable_preemption=True, migration_hysteresis=5,
                      running_fraction=running or 0.25)
        else:
            kw["running_fraction"] = running or 0.2
        sync, cl_a = make_stream_bridge(
            pkg, n_machines=n_machines, n_tasks=n_tasks, seed=seed,
            stream_windows=0, **dict(kw),
        )
        strm, cl_b = make_stream_bridge(
            pkg, n_machines=n_machines, n_tasks=n_tasks, seed=seed,
            stream_windows=K, **dict(kw),
        )
        rng = np.random.default_rng(seed)
        record = []
        for cycle in range(cycles):
            # victims come from ONE shared snapshot at the flush
            # boundary, where both bridges agree
            run_a = sorted(u for u, t in sync.tasks.items()
                           if t.phase.value == "Running")
            run_b = sorted(u for u, t in strm.tasks.items()
                           if t.phase.value == "Running")
            assert run_a == run_b
            victims = list(run_a)
            placed_sync: dict[str, str] = {}
            schedule = []
            for w in range(K):
                arr = [
                    (f"c{cycle}w{w}-{k}", int(rng.integers(16)),
                     float(rng.choice([0.1, 0.2, 0.4])))
                    for k in range(int(rng.integers(0, 3)))
                ]
                victim = None
                if victims and rng.random() < 0.5:
                    victim = victims.pop(int(rng.integers(len(victims))))
                schedule.append((arr, victim))
            for arr, victim in schedule:
                events = [("ADDED", arrival(pkg, u, cl_a, k, cpu=c))
                          for u, k, c in arr]
                if victim is not None:
                    events.append(("DELETED", sync.tasks[victim]))
                r = sync.express_batch(events)
                assert sync.solver.express_ready, "synced lane degraded"
                for uid, m in (r.bindings if r else {}).items():
                    placed_sync[uid] = m
                    sync.confirm_binding(uid, m)
            for arr, victim in schedule:
                events = [("ADDED", arrival(pkg, u, cl_b, k, cpu=c))
                          for u, k, c in arr]
                if victim is not None:
                    events.append(("DELETED", strm.tasks[victim]))
                assert strm.stream_window(events), "stream window degraded"
            logs = flush_logs(pkg, strm)
            r = strm.stream_finish()
            placed_strm = dict(r.bindings) if r is not None else {}
            for uid, m in placed_strm.items():
                strm.confirm_binding(uid, m)
            assert placed_strm == placed_sync, (cycle, placed_strm,
                                                placed_sync)
            record.append((placed_strm, logs))
        res_a = sync.run_scheduler()
        res_b = strm.run_scheduler()
        assert dict(res_b.bindings) == dict(res_a.bindings)
        assert res_b.stats.cost == res_a.stats.cost
        assert dict(res_b.migrations) == dict(res_a.migrations)
        assert set(res_b.preemptions) == set(res_a.preemptions)
        return (record, dict(res_b.bindings), res_b.stats.cost,
                dict(res_b.migrations), sorted(res_b.preemptions),
                strm.solver.stream_fetches, sync.solver.express_fetches,
                strm.solver.express_fetches)

    def _compare(self, K, cycles, seed, **kw):
        ref = self._drive_pair(REF, K, cycles, seed, **kw)
        port = self._drive_pair(PORT, K, cycles, seed, **kw)
        for (p_ref, l_ref), (p_port, l_port) in zip(ref[0], port[0]):
            assert p_port == p_ref
            assert_logs_equal(l_ref, l_port)
        assert port[1:] == ref[1:]
        return port

    @pytest.mark.parametrize("seed", [7, 19])
    def test_churn_fuzz_bit_identical(self, seed):
        out = self._compare(3, 3, seed)
        stream_fetches, sync_fetches, strm_express = out[5:]
        assert stream_fetches == 3
        assert sync_fetches > strm_express + stream_fetches

    def test_preemption_mode_bit_identical(self):
        self._compare(3, 2, 23, preemption=True)

    def test_eight_window_flush_bit_identical(self):
        out = self._compare(8, 2, 41)
        assert out[5] == 2

    def test_freeze_past_one_chunk_bit_identical(self, monkeypatch):
        """Rebalancing mode with more running rows than one K5 chunk
        holds: the synced lane's first batch patches the freeze and its
        own retires as a multi-chunk backlog, the stream lane's
        ``_stream_apply_freeze`` as one; each in one call."""
        calls = []
        patch = port_res._express_patch

        def recording(state, backlog, out=None):
            calls.append(tuple(backlog.shape))
            return patch(state, backlog, out)

        monkeypatch.setattr(port_res, "_express_patch", recording)
        self._compare(2, 1, 47, preemption=True, n_machines=240,
                      n_tasks=1500, running=0.75)
        assert sum(1 for s in calls if s[0] >= 2) >= 2, calls

    @pytest.mark.parametrize("opts", [
        {"aggregate_classes": True}, {"mesh_width": 1}, {"mesh_width": 8},
    ])
    def test_scale_lane_options_wait_for_their_item(self, opts):
        """The scale lane is ported: the reference's scale cases of this
        differential (``tests/test_stream.py``) run here, the port's
        mesh laid out over ``[cpu] * width``."""
        self._compare(2, 2, 31, opts=opts)


class TestStreamCertificate:
    def test_failed_first_window_binds_nothing_and_degrades(self):
        logs = {}

        def script(pkg):
            trace = pkg.trace()
            bridge, cluster = make_stream_bridge(pkg, stream_windows=2,
                                                 trace=trace)
            # cap 0: any placement overflows the compacted log; a
            # mid-stream window cannot fetch, so it latches dead
            bridge.solver.express_change_cap = 0
            for w in range(2):
                assert bridge.stream_window(
                    [("ADDED", arrival(pkg, f"cf-{w}", cluster, w))])
            logs[pkg.name] = flush_logs(pkg, bridge)
            r = bridge.stream_finish()
            ready = bridge.solver.express_ready
            flush_ev = next(e for e in trace.events
                            if e.event == "STREAM_FLUSH")
            why = next(e for e in trace.events
                       if e.event == "EXPRESS_DEGRADE").detail["why"]
            res = bridge.run_scheduler()
            return (r, ready, flush_ev.detail, why,
                    res.stats.express_degrades, dict(res.bindings))

        r, ready, detail, why, degrades, bindings = both(script)
        assert r is None and not ready
        assert detail["failed_window"] == 0 and detail["placements"] == 0
        assert "window 0" in why and "change_cap" in why
        assert degrades == 1
        assert all(f"cf-{w}" in bindings for w in range(2))
        assert_logs_equal(logs["ref"], logs["port"])
        assert not logs["port"]["live"].any()

    def test_good_prefix_binds_before_failed_window(self):
        logs = {}

        def script(pkg):
            trace = pkg.trace()
            bridge, cluster = make_stream_bridge(pkg, stream_windows=3,
                                                 trace=trace)
            # cap 1: a one-arrival window certifies, a two-arrival
            # window overflows and latches the stream there
            bridge.solver.express_change_cap = 1
            assert bridge.stream_window(
                [("ADDED", arrival(pkg, "gp-0", cluster, 0))])
            assert bridge.stream_window(
                [("ADDED", arrival(pkg, "gp-1a", cluster, 1)),
                 ("ADDED", arrival(pkg, "gp-1b", cluster, 2))])
            logs[pkg.name] = flush_logs(pkg, bridge)
            r = bridge.stream_finish()
            ready = bridge.solver.express_ready
            flush_ev = next(e for e in trace.events
                            if e.event == "STREAM_FLUSH")
            bridge.confirm_binding("gp-0", r.bindings["gp-0"])
            res = bridge.run_scheduler()
            return (result_record(r), ready, flush_ev.detail,
                    res.stats.express_degrades, dict(res.bindings))

        r, ready, detail, degrades, bindings = both(script)
        assert list(r[0]) == ["gp-0"] and not ready
        assert detail["failed_window"] == 1
        assert degrades == 1
        assert "gp-1a" in bindings and "gp-1b" in bindings
        assert "gp-0" not in bindings
        assert_logs_equal(logs["ref"], logs["port"])
        assert list(logs["port"]["live"]) == [True, False, False]


class TestStreamBuildBudget:
    def test_no_kernel_build_or_new_plan_in_steady_state(self):
        """The port's counterpart of the reference's zero-recompile
        budget: after a full and a draining flush of each shape, later
        flushes (full, draining, full + short) make no kernel build and
        no new launch plan."""
        from poseidon_tpu_torch.guards import CompileCounter

        bridge, cluster = make_stream_bridge(PORT, n_machines=20,
                                             n_tasks=90, seed=7,
                                             stream_windows=3)

        def cycle(uids, flush_at):
            for i, uid in enumerate(uids):
                assert bridge.stream_window(
                    [("ADDED", arrival(PORT, uid, cluster, i))])
                if bridge.solver.stream_pending_windows >= flush_at:
                    bridge.stream_flush()
                    r = bridge.stream_finish()
                    for u, m in (r.bindings if r else {}).items():
                        bridge.confirm_binding(u, m)
            if bridge.solver.stream_pending_windows:
                bridge.stream_flush()
                r = bridge.stream_finish()
                for u, m in (r.bindings if r else {}).items():
                    bridge.confirm_binding(u, m)

        cycle([f"warm-{k}" for k in range(3)], 3)
        cycle(["warm-3"], 3)
        counter = CompileCounter()
        with counter:
            cycle([f"st-{k}" for k in range(3)], 3)
            cycle(["st-3"], 3)
            cycle([f"st2-{k}" for k in range(5)], 3)
        assert counter.count == 0


class TestStreamBudget:
    def test_event_buffer_charged_and_hint_names_fitting_k(self):
        from poseidon_tpu.ops import dense_auction as ref_da
        from poseidon_tpu_torch.ops import dense_auction as port_da

        Tp, Mp = 4096, 2048
        stream_ints = 5_000_000
        for da in (ref_da, port_da):
            da.check_table_budget(Tp, Mp)
        fit = port_da.max_stream_windows_for(Tp, Mp, stream_ints)
        assert fit == ref_da.max_stream_windows_for(Tp, Mp, stream_ints)
        assert fit >= 1
        with pytest.raises(port_da.DenseMemoryTooLarge) as ei:
            port_da.check_table_budget(
                Tp, Mp, stream_windows=fit + 64, stream_ints=stream_ints,
            )
        msg = str(ei.value)
        assert f"--stream_windows={fit}" in msg
        assert "stream event buffer" in msg

    def test_fitting_k_passes(self):
        from poseidon_tpu_torch.ops.dense_auction import (
            check_table_budget,
            max_stream_windows_for,
        )

        Tp, Mp = 4096, 2048
        stream_ints = 5_000_000
        fit = max_stream_windows_for(Tp, Mp, stream_ints)
        check_table_budget(Tp, Mp, stream_windows=fit,
                           stream_ints=stream_ints)

    def test_event_ints_equal_the_reference(self):
        from poseidon_tpu.ops import resident as ref_res
        from poseidon_tpu_torch.ops import resident as port_res

        for args in ((16, 3, 16, 1024), (1, 1, 1, 1), (64, 4, 2048, 64)):
            assert (port_res._stream_event_ints(*args)
                    == ref_res._stream_event_ints(*args))


class TestStreamMetrics:
    def test_flush_records_fetch_lane_and_amortization_gauge(self):
        def script(pkg):
            obs = __import__(f"{pkg.bridge.__name__.split('.')[0]}.obs",
                             fromlist=["MetricsRegistry"])
            m = obs.SchedulerMetrics(obs.MetricsRegistry())
            bridge, cluster = make_stream_bridge(pkg, stream_windows=2,
                                                 metrics=m)
            for w in range(2):
                assert bridge.stream_window(
                    [("ADDED", arrival(pkg, f"mx-{w}", cluster, w))])
            bridge.stream_flush()
            r = bridge.stream_finish()
            text = m.registry.render()
            return (len(r.bindings),
                    'poseidon_solver_fetches_total{lane="stream"} 1' in text,
                    "poseidon_stream_flushes_total 1" in text,
                    "poseidon_placements_per_fetch 2" in text)

        assert both(script) == (2, True, True, True)

    def test_stream_span_tree_equals_the_reference(self):
        from poseidon_tpu.obs.spans import stream_span_tree as ref_tree
        from poseidon_tpu_torch.obs.spans import stream_span_tree as port_tree

        timings = {"prep_ms": 1.25, "upload_ms": 0.5, "stack_ms": 0.125,
                   "solve_ms": 7.0}
        for latency in (0.0, 5.0, 40.0):
            assert (port_tree(latency, timings, windows=3)
                    == ref_tree(latency, timings, windows=3))


def _watch_server(api, n_nodes=4, n_pods=6):
    server = api.FakeApiServer().start()
    for i in range(n_nodes):
        server.add_node(f"n{i}", cpu="8", memory="16Gi", pods=8)
    for j in range(n_pods):
        server.add_pod(f"p{j}", cpu="100m", memory="64Mi")
    return server, api.K8sApiClient("127.0.0.1", server.port)


class TestWatchStreamWindows:
    """ClusterWatcher.express_poll_windows on the port's watcher and
    fake apiserver."""

    def test_backlog_splits_into_windows(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _watch_server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            for k in range(3):
                server.add_pod(f"late-{k}", cpu="100m", memory="64Mi")
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            evs = watcher.express_poll_windows(1.0, max_events=1,
                                               windows=3)
            assert len(evs) == 3
            assert [t.uid for ev in evs for _typ, t in ev.pod_events] == [
                f"default/late-{k}" for k in range(3)]
            assert not any(ev.needs_tick for ev in evs)
        finally:
            watcher.stop()
            server.stop()

    def test_dry_stream_stops_after_first_empty_window(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _watch_server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            server.add_pod("only-0", cpu="100m", memory="64Mi")
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            evs = watcher.express_poll_windows(1.0, max_events=8,
                                               windows=4)
            assert len(evs) <= 2
            assert [t.uid for _typ, t in evs[0].pod_events] == [
                "default/only-0"]
        finally:
            watcher.stop()
            server.stop()

    def test_needs_tick_only_in_last_window(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _watch_server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            server.add_pod("pre-n", cpu="100m", memory="64Mi")
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            server.add_node("n-new", cpu="8", memory="16Gi", pods=8)
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            evs = watcher.express_poll_windows(2.0, max_events=1,
                                               windows=4)
            assert evs[-1].needs_tick
            assert not any(ev.needs_tick for ev in evs[:-1])
        finally:
            watcher.stop()
            server.stop()


def test_stream_flag_parses_as_the_reference():
    import poseidon_tpu.cli as ref_cli
    import poseidon_tpu_torch.cli as port_cli

    argv = ["--watch=true", "--express_lane=true", "--stream_windows=4"]
    port = vars(port_cli.parse_args(argv + ["--device=cpu"]))
    ref = vars(ref_cli.parse_args(argv))
    assert port["stream_windows"] == ref["stream_windows"] == 4
    assert "stream_windows" not in port_cli.UNPORTED_FLAGS


def test_daemon_stream_lane_binds_a_burst():
    """The daemon with ``--stream_windows=3`` on the CPU: a burst that
    arrives after round 1 binds in stream flushes between the ticks,
    and every round reports the "stream" lane. (When the bound pods'
    watch echoes reach a tick rather than a stream window, the tick's
    ``express_batch`` meets retires the stream already applied and
    degrades loudly, as the reference's does: ROADMAP Queue 3.)"""
    from tests.test_torch_express import _run_express_cli

    rc, bound, rows, _ = _run_express_cli(
        ["--stream_windows=3", "--express_correction_rounds=1",
         "--polling_frequency=700000", "--max_rounds=3"], burst=4,
    )
    assert rc == 0
    for k in range(4):
        assert f"default/late-{k}" in bound
    assert sum(r["express_places"] for r in rows) >= 4
    assert all(r["lane"] == "stream" for r in rows)


# ---------------------------------------------------------------------------
# K7's plain twin against the reference's scan-step lines
# ---------------------------------------------------------------------------

def _reference_commit(live, conv, domain_ok, n_changes, change_cap,
                      rows_out, asg_out, primal, report, asg_f, lvl_f,
                      floor_f, u_n, w_n, valid_n, s_n, c_new, u, w, s,
                      valid, asg_c, lvl_c, floor_c, c):
    """``poseidon_tpu/ops/resident.py:658-690`` (the tail of
    ``_stream_chain``'s step), line for line in jnp."""
    Tp, Mp = c.shape
    win_ok = conv & domain_ok & (n_changes <= jnp.int32(change_cap))
    live2 = live & win_ok
    valid_r = valid_n & ~report
    u_r = jnp.where(report, 0, u_n)
    w_r = jnp.where(report, INF, w_n)
    s_r = s_n.at[
        jnp.where(report, jnp.clip(asg_f, 0, Mp - 1), Mp)
    ].add(-1, mode="drop")
    s_r = jnp.maximum(s_r, 0)
    asg_r = jnp.where(report, Mp, asg_f)
    lvl_r = jnp.where(report, 0, lvl_f)

    def sel(new, old):
        return jnp.where(live2, new, old)

    carry2 = (
        sel(c_new, c), sel(u_r, u), sel(w_r, w), sel(s_r, s),
        jnp.where(live2, valid_r, valid), sel(asg_r, asg_c),
        sel(lvl_r, lvl_c), sel(floor_f, floor_c), live2,
    )
    ys = (
        jnp.where(live2, rows_out, Tp), jnp.where(live2, asg_out, -1),
        n_changes, live2, conv, domain_ok,
        jnp.where(live2, primal, jnp.int64(0)),
    )
    return carry2, ys


def _commit_case(seed, *, live, conv, domain_ok, n_changes, change_cap,
                 Tp=32, Mp=16, kmax=4, cap=8):
    rng = np.random.default_rng(seed)
    c_old = rng.integers(0, 1000, (Tp, Mp)).astype(np.int32)
    add_row = np.array([0, Tp - 1, -1, 5][:kmax], np.int32)
    c_new = c_old.copy()
    for r in add_row:
        if r >= 0:
            c_new[r] = rng.integers(0, 1000, Mp)
    report = rng.random(Tp) < 0.3
    report[[0, Tp - 1]] = True
    asg_f = rng.integers(-1, Mp + 1, Tp).astype(np.int32)
    asg_f[0], asg_f[Tp - 1] = 3, 3     # two reports on one column
    s_n = rng.integers(0, 3, Mp).astype(np.int32)
    s_n[3] = 1                          # driven below 0, clamped
    arrs = dict(
        live=np.array([int(live)], np.int32), conv=np.array(conv),
        domain_ok=np.array(domain_ok),
        n_changes=np.array(n_changes, np.int32),
        rows_out=np.sort(rng.choice(Tp + 1, cap)).astype(np.int32),
        asg_out=rng.integers(-1, Mp, cap).astype(np.int32),
        primal=np.array(int(rng.integers(0, 2**40)), np.int64),
        report=report, asg_f=asg_f,
        lvl_f=rng.integers(0, 500, Tp).astype(np.int32),
        floor_f=rng.integers(0, 500, Mp).astype(np.int32),
        u_n=rng.integers(0, 500, Tp).astype(np.int32),
        w_n=rng.integers(0, 500, Tp).astype(np.int32),
        valid_n=rng.random(Tp) < 0.8, s_n=s_n,
        u=rng.integers(0, 500, Tp).astype(np.int32),
        w=rng.integers(0, 500, Tp).astype(np.int32),
        s=rng.integers(0, 4, Mp).astype(np.int32),
        valid=rng.random(Tp) < 0.8,
        asg=rng.integers(-1, Mp + 1, Tp).astype(np.int32),
        lvl=rng.integers(0, 500, Tp).astype(np.int32),
        floor=rng.integers(0, 500, Mp).astype(np.int32),
    )
    return arrs, add_row, c_old, c_new


@pytest.mark.parametrize("case", [
    dict(live=True, conv=True, domain_ok=True, n_changes=3, change_cap=8),
    dict(live=True, conv=False, domain_ok=True, n_changes=3, change_cap=8),
    dict(live=True, conv=True, domain_ok=False, n_changes=3, change_cap=8),
    dict(live=True, conv=True, domain_ok=True, n_changes=9, change_cap=8),
    dict(live=False, conv=True, domain_ok=True, n_changes=3, change_cap=8),
    dict(live=True, conv=True, domain_ok=True, n_changes=8, change_cap=8),
], ids=["live", "first-dead-conv", "first-dead-domain", "first-dead-cap",
        "already-dead", "at-cap"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stream_commit_twin_equals_reference_step(case, seed):
    arrs, add_row, c_old, c_new = _commit_case(seed, **case)
    with enable_x64(True):   # the reference's stream runs under x64
        j = {k: jnp.asarray(v) for k, v in arrs.items()}
        carry2, ys = _reference_commit(
            j["live"][0].astype(bool), j["conv"], j["domain_ok"],
            j["n_changes"], case["change_cap"], j["rows_out"],
            j["asg_out"], j["primal"], j["report"], j["asg_f"],
            j["lvl_f"], j["floor_f"], j["u_n"], j["w_n"], j["valid_n"],
            j["s_n"], jnp.asarray(c_new), j["u"], j["w"], j["s"],
            j["valid"], j["asg"], j["lvl"], j["floor"],
            jnp.asarray(c_old),
        )
        carry2 = [np.asarray(x) for x in carry2]
        ys = [np.asarray(x) for x in ys]
    t = {k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}
    c = torch.from_numpy(c_new.copy())          # K4 already wrote its rows
    c_saved = torch.from_numpy(
        c_old[np.clip(add_row, 0, c_old.shape[0] - 1)])
    cap = arrs["rows_out"].shape[0]
    log = torch.zeros(log_width(cap), dtype=torch.int64)
    commit_plain(
        t["live"], t["conv"], t["domain_ok"], t["n_changes"],
        case["change_cap"], t["rows_out"], t["asg_out"], t["primal"],
        t["report"], t["asg_f"], t["lvl_f"], t["floor_f"], t["u_n"],
        t["w_n"], t["valid_n"], t["s_n"], torch.from_numpy(add_row),
        c_saved, t["u"], t["w"], t["valid"], t["asg"], t["lvl"], t["s"],
        t["floor"], c, log,
    )
    c_r, u_r, w_r, s_r, valid_r, asg_r, lvl_r, floor_r, live_r = (
        np.asarray(x) for x in carry2)
    for got, want in ((c, c_r), (t["u"], u_r), (t["w"], w_r),
                      (t["s"], s_r), (t["valid"], valid_r),
                      (t["asg"], asg_r), (t["lvl"], lvl_r),
                      (t["floor"], floor_r)):
        assert np.array_equal(got.numpy(), want)
    assert int(t["live"][0]) == int(live_r)
    rows_r, asgo_r, nchg_r, live2_r, conv_r, dom_r, primal_r = (
        np.asarray(x) for x in ys)
    h = log.numpy()
    assert np.array_equal(h[:cap], rows_r)
    assert np.array_equal(h[cap: 2 * cap], asgo_r)
    assert list(h[2 * cap: 2 * cap + 5]) == [
        int(nchg_r), int(live2_r), int(conv_r), int(dom_r), int(primal_r)]


# ---------------------------------------------------------------------------
# K7 as the window's tail: its twin against the reference's lines
# ---------------------------------------------------------------------------

def _reference_tail(valid2, asg0, asg_f, u2, c2, change_cap):
    """``poseidon_tpu/ops/resident.py:526-545`` (the tail of
    ``_express_step``: the report, the change count, the compaction and
    the objective), line for line in jnp."""
    Tp, Mp = c2.shape
    pos = jnp.arange(Tp, dtype=jnp.int32)
    report = valid2 & (asg_f >= 0) & (asg_f < Mp) & (asg_f != asg0)
    n_changes = jnp.sum(report, dtype=jnp.int32)
    key = jnp.sort(jnp.where(report, pos, Tp))
    rows_out = key[:change_cap]
    asg_out = jnp.where(
        rows_out < Tp, asg_f[jnp.minimum(rows_out, Tp - 1)], -1
    )
    on_m = (asg_f >= 0) & (asg_f < Mp)
    c_asg = jnp.take_along_axis(
        c2, jnp.clip(asg_f, 0, Mp - 1)[:, None], axis=1
    )[:, 0]
    per = jnp.where(
        valid2, jnp.where(on_m, c_asg, jnp.where(asg_f == Mp, u2, INF)),
        0,
    )
    primal = jnp.sum(per.astype(jnp.int64))
    n_active = jnp.sum(valid2, dtype=jnp.int32)
    return report, n_changes, rows_out, asg_out, primal, n_active


def _tail_case(seed, n_rep, *, Tp=40, Mp=16, kmax=4):
    """A window after its repair with exactly ``n_rep`` reported rows
    (rows 0 and Tp-1 first); the other rows inactive, off every machine
    (-1, Mp: unscheduled, Mp + 1) or where their repair started. Two
    reports share column 3, which has one seat left."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([[0, Tp - 1],
                           rng.permutation(np.arange(1, Tp - 1))])[:n_rep]
    rep = np.zeros(Tp, bool)
    rep[rows] = True
    valid = rng.random(Tp) < 0.7
    asg_f = rng.integers(-1, Mp + 2, Tp)
    asg0 = rng.integers(-1, Mp + 1, Tp)
    kind = rng.integers(0, 3, Tp)
    valid[(kind == 0) & ~rep] = False
    asg_f[(kind == 1) & ~rep] = -1
    same = (kind == 2) & ~rep
    asg_f[same] = rng.integers(0, Mp, int(same.sum()))
    asg0[same] = asg_f[same]
    valid[rep] = True
    asg_f[rep] = rng.integers(0, Mp, n_rep)
    asg_f[rows[:2]] = 3
    asg0[rep] = -1
    s_n = rng.integers(0, 3, Mp)
    s_n[3] = 1
    add_row = np.array([0, Tp - 1, -1, 5][:kmax], np.int32)
    c_old = rng.integers(0, 1000, (Tp, Mp)).astype(np.int32)
    c_new = c_old.copy()
    for r in add_row[add_row >= 0]:
        c_new[r] = rng.integers(0, 1000, Mp)
    i32 = np.int32
    return dict(
        valid2=valid, asg0=asg0.astype(i32), asg_f=asg_f.astype(i32),
        u2=rng.integers(0, 500, Tp).astype(i32),
        w2=rng.integers(0, 500, Tp).astype(i32),
        lvl_f=rng.integers(0, 500, Tp).astype(i32),
        floor_f=rng.integers(0, 500, Mp).astype(i32), s_n=s_n.astype(i32),
        u=rng.integers(0, 500, Tp).astype(i32),
        w=rng.integers(0, 500, Tp).astype(i32),
        s=rng.integers(0, 4, Mp).astype(i32), valid=rng.random(Tp) < 0.8,
        asg=rng.integers(-1, Mp + 1, Tp).astype(i32),
        lvl=rng.integers(0, 500, Tp).astype(i32),
        floor=rng.integers(0, 500, Mp).astype(i32),
    ), add_row, c_old, c_new


@pytest.mark.parametrize("n_rep", [0, 8, 9], ids=["none", "at-cap",
                                                  "over-cap"])
@pytest.mark.parametrize("window", [
    dict(live=True, conv=True, domain_ok=True),
    dict(live=True, conv=False, domain_ok=True),
    dict(live=True, conv=True, domain_ok=False),
    dict(live=False, conv=True, domain_ok=True),
], ids=["live", "dead-conv", "dead-domain", "already-dead"])
@pytest.mark.parametrize("commit", [True, False], ids=["stream", "synced"])
def test_window_tail_twin_equals_reference(n_rep, window, commit):
    """K7's twin (the whole tail) against ``_reference_tail`` and, in the
    stream lane, ``_reference_commit`` chained after it: the report, the
    log row (rows, assignments, n_changes, the verdict, conv, domain_ok,
    the objective, n_active), and with the commit the carry, the table
    (a dead window's rows put back) and the latch. Without the commit
    the verdict is the window's certificate and nothing is masked."""
    from poseidon_tpu_torch.kernels.stream_commit import (
        Commit,
        stream_commit,
    )

    cap = 8
    x, add_row, c_old, c_new = _tail_case(n_rep, n_rep)
    Tp, Mp = c_new.shape
    with enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in x.items()}
        tail = _reference_tail(j["valid2"], j["asg0"], j["asg_f"], j["u2"],
                               jnp.asarray(c_new), cap)
        report_r, nchg_r, rows_r, asgo_r, primal_r, nact_r = tail
        win_ok = window["conv"] and window["domain_ok"] and int(nchg_r) <= cap
        if commit:
            carry2, ys = _reference_commit(
                jnp.asarray(window["live"]), jnp.asarray(window["conv"]),
                jnp.asarray(window["domain_ok"]), nchg_r, cap, rows_r,
                asgo_r, primal_r, report_r, j["asg_f"], j["lvl_f"],
                j["floor_f"], j["u2"], j["w2"], j["valid2"], j["s_n"],
                jnp.asarray(c_new), j["u"], j["w"], j["s"], j["valid"],
                j["asg"], j["lvl"], j["floor"], jnp.asarray(c_old))
            carry2 = [np.asarray(v) for v in carry2]
            want_log = [np.asarray(v) for v in ys]
        else:
            want_log = [np.asarray(rows_r), np.asarray(asgo_r),
                        np.asarray(nchg_r), np.asarray(win_ok),
                        np.asarray(window["conv"]),
                        np.asarray(window["domain_ok"]),
                        np.asarray(primal_r)]
        report_r, nact_r = np.asarray(report_r), int(nact_r)
    assert int(nchg_r) == n_rep
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    c = torch.from_numpy(c_new.copy())       # K4 already wrote its rows
    log = torch.full((log_width(cap),), -9, dtype=torch.int64)
    report = torch.zeros(Tp, dtype=torch.bool)
    live = torch.tensor([int(window["live"])], dtype=torch.int32)
    com = None
    if commit:
        com = Commit(
            live, t["lvl_f"], t["floor_f"], t["w2"], t["s_n"],
            torch.from_numpy(add_row),
            torch.from_numpy(c_old[np.clip(add_row, 0, Tp - 1)]), c,
            t["u"], t["w"], t["valid"], t["asg"], t["lvl"], t["s"],
            t["floor"])
    stream_commit(log, report, t["valid2"], t["asg0"], t["asg_f"], t["u2"],
                  c, Mp, torch.tensor(window["conv"]),
                  torch.tensor(window["domain_ok"]), cap, com)
    assert np.array_equal(report.numpy(), report_r)
    h = log.numpy()
    assert np.array_equal(h[:cap], want_log[0])
    assert np.array_equal(h[cap: 2 * cap], want_log[1])
    assert list(h[2 * cap:]) == [int(v) for v in want_log[2:]] + [nact_r]
    if not commit:
        assert np.array_equal(c.numpy(), c_new)
        return
    c_r, u_r, w_r, s_r, valid_r, asg_r, lvl_r, floor_r, live_r = carry2
    for got, want in ((c, c_r), (t["u"], u_r), (t["w"], w_r),
                      (t["s"], s_r), (t["valid"], valid_r),
                      (t["asg"], asg_r), (t["lvl"], lvl_r),
                      (t["floor"], floor_r)):
        assert np.array_equal(got.numpy(), want)
    assert int(live[0]) == int(live_r)
