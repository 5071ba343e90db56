"""Differential tests: the port's watch path vs its poll path and vs the
reference's.

The poll-vs-watch differential of ``tests/test_watch.py``, run in each
package: a watch-driven bridge and a poll-driven bridge consume one
scripted event history — across an injected mid-stream disconnect and a
410 resync — in rebalancing mode, and must agree every round (bindings,
migrations, preemptions, unscheduled, cost, build mode, builder
columns). The port's watch side must then equal the reference's watch
side round by round, timers excluded (tolerance 0), and so must the
watch-driven CLI loop with preemption.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import pytest

import poseidon_tpu.apiclient as ref_api
import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cli as ref_cli
import poseidon_tpu_torch.apiclient as port_api
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cli as port_cli

from tests.test_torch_daemon import stats_record
from tests.test_torch_graph import build_reference_oracle


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    """The reference's side of these tests can solve on its C++ oracle,
    which it builds in place on first use: have the binary whole first
    (``tests/test_torch_graph.py``'s ``build_reference_oracle``)."""
    build_reference_oracle()


REF = types.SimpleNamespace(api=ref_api, bridge=ref_bridge, cli=ref_cli,
                            kw={}, argv=[])
PORT = types.SimpleNamespace(api=port_api, bridge=port_bridge, cli=port_cli,
                             kw={"device": "cpu"}, argv=["--device=cpu"])
HYST = 20


def _populate(server):
    for i in range(4):
        server.add_node(f"m{i}", cpu="8", memory="16Gi", pods=4,
                        rack=f"r{i % 2}")
    # running pods crowded on m0/m1 whose data lives on m2/m3
    for i in range(6):
        server.add_pod(
            f"q{i}", cpu="250m", memory="128Mi", job="jr",
            data_prefs={f"m{2 + i % 2}": 200},
            phase="Running", node=f"m{i % 2}",
        )
    for j in range(6):
        server.add_pod(f"p{j}", cpu="250m", memory="128Mi",
                       job=f"j{j // 3}", data_prefs={f"m{j % 4}": 60})


def _script(round_num, server):
    if round_num == 1:
        server.add_pod("late-0", cpu="250m", memory="128Mi", job="jl",
                       data_prefs={"m1": 80})
        server.add_pod("late-1", cpu="250m", memory="128Mi", job="jl")
    elif round_num == 2:
        server.succeed_pod("q0")
        server.add_pod("late-2", cpu="250m", memory="128Mi")
    elif round_num == 3:
        server.delete_pod("late-1")
    elif round_num == 5:
        server.add_pod("late-3", cpu="250m", memory="128Mi",
                       data_prefs={"m2": 90})


def _apply(bridge, delta):
    """The cli.py consumer contract."""
    if delta.resynced:
        bridge.observe_nodes(delta.nodes)
        bridge.observe_pods(delta.pods)
    else:
        for typ, machine in delta.node_events:
            bridge.observe_node_event(typ, machine)
        for typ, task in delta.pod_events:
            bridge.observe_pod_event(typ, task)
    bridge.note_watch_activity(delta.resyncs, delta.reconnects)


def _actuate(client, bridge, res):
    for uid, machine in res.bindings.items():
        assert client.bind_pod_to_node(uid, machine)
        bridge.confirm_binding(uid, machine)
    for uid, (_frm, to) in res.migrations.items():
        assert client.evict_pod(uid)
        assert client.bind_pod_to_node(uid, to)
        bridge.confirm_migration(uid, to)
    for uid in res.preemptions:
        assert client.evict_pod(uid)
        bridge.confirm_preemption(uid)


def _columns(cols):
    if cols is None:
        return None
    return {
        f.name: (getattr(cols, f.name).tolist()
                 if isinstance(getattr(cols, f.name), np.ndarray)
                 else getattr(cols, f.name))
        for f in dataclasses.fields(type(cols))
    }


def _record(res, bridge):
    return dict(
        bindings=dict(res.bindings), migrations=dict(res.migrations),
        preemptions=dict(res.preemptions),
        unscheduled=sorted(res.unscheduled),
        stats=stats_record(res.stats),
        columns=_columns(bridge._graph.columns),
    )


def watch_differential(pkg, rounds=6):
    """Poll and watch side by side in one package; asserts they agree
    every round and returns the watch side's records and end state."""
    def bridge():
        return pkg.bridge.SchedulerBridge(
            cost_model="quincy", enable_preemption=True,
            migration_hysteresis=HYST, max_migrations_per_round=3, **pkg.kw,
        )

    records = []
    with pkg.api.FakeApiServer() as sp, pkg.api.FakeApiServer() as sw:
        _populate(sp)
        _populate(sw)
        cp = pkg.api.K8sApiClient("127.0.0.1", sp.port)
        cw = pkg.api.K8sApiClient("127.0.0.1", sw.port)
        bp, bw = bridge(), bridge()
        watcher = pkg.api.ClusterWatcher(cw, max_lag_s=60.0)
        try:
            saw_disconnect = saw_resync = False
            for r in range(rounds):
                sw.apply_pending()
                if r == 2:
                    sw.disconnect_watch_next(1)
                _script(r, sp)
                _script(r, sw)
                if r == 4:
                    sw.gone_next_watch(1)
                bp.observe_nodes(cp.all_nodes())
                bp.observe_pods(cp.all_pods())
                if r == 0:
                    d = watcher.tick()
                    assert d.resynced
                    _apply(bw, d)
                elif r == 4:
                    deadline = time.monotonic() + 8.0
                    while True:
                        d = watcher.tick()
                        _apply(bw, d)
                        if d.resynced:
                            saw_resync = True
                            break
                        assert time.monotonic() < deadline
                        time.sleep(0.02)
                else:
                    assert watcher.wait_caught_up(sw.current_rv(), 8.0)
                    d = watcher.tick()
                    saw_disconnect |= bool(d.reconnects)
                    _apply(bw, d)
                res_p = bp.run_scheduler()
                res_w = bw.run_scheduler()
                rec_p, rec_w = _record(res_p, bp), _record(res_w, bw)
                for key in ("bindings", "migrations", "preemptions",
                            "unscheduled", "columns"):
                    assert rec_p[key] == rec_w[key], (r, key)
                assert rec_p["stats"]["cost"] == rec_w["stats"]["cost"], r
                assert (rec_p["stats"]["build_mode"]
                        == rec_w["stats"]["build_mode"]), r
                records.append(rec_w)
                _actuate(cp, bp, res_p)
                _actuate(cw, bw, res_w)
            assert saw_disconnect and saw_resync
            assert sw.evictions and sp.evictions == sw.evictions
            assert list(bp.tasks) == list(bw.tasks)
            assert bp.tasks == bw.tasks
            assert bp.machines == bw.machines
            end = dict(
                tasks=[dataclasses.astuple(t) for t in bw.tasks.values()],
                decision_log=list(bw.decision_log),
                evictions=list(sw.evictions),
                bindings=list(sw.bindings),
            )
        finally:
            watcher.stop()
    return records, end


def test_watch_rounds_equal_poll_and_reference():
    ref, ref_end = watch_differential(REF)
    port, port_end = watch_differential(PORT)
    assert len(ref) == len(port)
    for r, (a, b) in enumerate(zip(ref, port)):
        assert a == b, r
    assert ref_end == port_end


def _watch_loop(pkg):
    with pkg.api.FakeApiServer() as server:
        for i in range(4):
            server.add_node(f"m{i}", cpu="8", memory="16Gi", pods=4,
                            rack=f"r{i % 2}")
        for i in range(6):
            server.add_pod(
                f"q{i}", cpu="250m", memory="128Mi", job="jr",
                data_prefs={f"m{2 + i % 2}": 200},
                phase="Running", node=f"m{i % 2}",
            )
        for j in range(8):
            server.add_pod(f"p{j}", cpu="250m", memory="128Mi",
                           job=f"j{j // 4}")
        rc = pkg.cli.run_loop(pkg.cli.parse_args([
            "--k8s_apiserver_host=127.0.0.1",
            f"--k8s_apiserver_port={server.port}",
            "--watch=true", "--round_pipeline=true",
            "--enable_preemption=true", f"--migration_hysteresis={HYST}",
            "--flow_scheduling_cost_model=quincy",
            "--polling_frequency=20000", "--max_rounds=5", *pkg.argv,
        ]))
        pods = pkg.api.K8sApiClient("127.0.0.1", server.port).all_pods()
        return (rc, dict(server.bindings), sorted(server.evictions),
                {p.uid: p.machine for p in pods})


def test_watch_loop_with_preemption_equal():
    ref = _watch_loop(REF)
    port = _watch_loop(PORT)
    assert ref[0] == port[0] == 0
    assert port[2], "the drifted packing was not corrected"
    assert port == ref
