"""Differential tests: the port's express lane vs the reference's.

The port of ``tests/test_express.py`` (all but the recompile budget,
which is JAX's; the scale-lane composition runs with the port's mesh
on ``[cpu] * width``): the same clusters and watch-event batches go
through ``poseidon_tpu``'s bridge and ``poseidon_tpu_torch``'s
(``device="cpu"``) side by side, and every batch's placements, cost,
repair rounds and the bridges' decision logs and round stats must be
equal (tolerance 0). Beside them:

- the plain twins of the two express kernels against the reference's
  device programs: K5 against ``_express_patch`` on random chunks
  (duplicate columns, sums driven below zero, -1 lanes, chunk order),
  and K4 inside the whole express step against ``_express_chain`` on a
  hand-made instance (arrival rows 0 and Tp-1, -1 lanes, preferences
  on padded columns, racks of -1, columns without seats, int32 sums
  that wrap);
- a batch that degrades after its patch: the next full round starts
  from the same warm state as the reference's (rounds, phases,
  assignment);
- the watch window (``ClusterWatcher.express_poll``) and the daemon
  loop end to end with ``--watch=true --express_lane=true``.

The tests share a few cluster shapes, so the reference's express
programs compile once per shape.
"""

from __future__ import annotations

import dataclasses
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.models.costs as ref_costs
import poseidon_tpu.ops.dense_auction as ref_da
import poseidon_tpu.ops.resident as ref_res
import poseidon_tpu.synth as ref_synth
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.models.costs as port_costs
import poseidon_tpu_torch.ops.dense_auction as port_da
import poseidon_tpu_torch.ops.resident as port_res
import poseidon_tpu_torch.synth as port_synth
from poseidon_tpu.compat import enable_x64
from poseidon_tpu.trace import TraceGenerator as RefTrace
from poseidon_tpu_torch.kernels.express_patch import express_patch
from poseidon_tpu_torch.trace import TraceGenerator as PortTrace

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REF = types.SimpleNamespace(
    bridge=ref_bridge, cluster=ref_cluster, synth=ref_synth, res=ref_res,
    trace=RefTrace, kw={},
)
PORT = types.SimpleNamespace(
    bridge=port_bridge, cluster=port_cluster, synth=port_synth,
    res=port_res, trace=PortTrace, kw={"device": "cpu"},
)

# SchedulerStats fields that are host clock readings
TIMERS = frozenset({
    "observe_ms", "build_ms", "price_ms", "solve_ms", "decompose_ms",
    "total_ms", "dispatch_ms", "fetch_wait_ms", "overlap_ms", "wall_ms",
    "express_e2b_p50_ms", "express_e2b_p99_ms",
})


def stats_record(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in TIMERS}


def make_bridge(pkg, n_machines=20, n_tasks=90, seed=3, *, trace=None,
                run_first_round=True, confirm=True, **kw):
    """A bridge on the dense lane with one certified round behind it
    (the express context's precondition), plus its cluster."""
    cluster = pkg.synth.make_synthetic_cluster(
        n_machines, n_tasks, seed=seed, prefs_per_task=2,
        **({"running_fraction": kw.pop("running_fraction")}
           if "running_fraction" in kw else {}),
    )
    bridge = pkg.bridge.SchedulerBridge(
        cost_model=kw.pop("cost_model", "quincy"), small_to_oracle=False,
        express_lane=True, trace=trace, **kw, **pkg.kw,
    )
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    if run_first_round:
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


def batch_record(r) -> tuple | None:
    """An express batch's result without its timers."""
    if r is None:
        return None
    return dict(r.bindings), list(r.bindings), r.cost, r.rounds


def both(script):
    """Run ``script(pkg)`` for both packages; assert equal outputs and
    return the port's."""
    ref_out, port_out = script(REF), script(PORT)
    assert port_out == ref_out
    return port_out


class TestExpressBasics:
    def test_arrival_binds_between_rounds(self):
        def script(pkg):
            trace = pkg.trace()
            bridge, cluster = make_bridge(pkg, trace=trace)
            assert bridge.solver.express_ready
            t0 = time.perf_counter()
            r = bridge.express_batch(
                [("ADDED", arrival(pkg, "xp-0", cluster))], t_event=t0
            )
            assert r is not None and list(r.bindings) == ["xp-0"]
            assert r.latency_ms > 0
            assert "EXPRESS_PLACE" in {e.event for e in trace.events}
            bridge.confirm_binding("xp-0", r.bindings["xp-0"])
            stats = bridge.run_scheduler().stats
            assert stats.express_batches == 1
            assert stats.express_places == 1
            assert stats.express_degrades == 0
            assert stats.express_e2b_p50_ms > 0
            assert stats.express_e2b_p99_ms >= stats.express_e2b_p50_ms
            return (batch_record(r), stats_record(stats),
                    list(bridge.decision_log))

        both(script)

    def test_one_fetch_per_batch(self):
        bridge, cluster = make_bridge(PORT)
        r = bridge.express_batch([("ADDED", arrival(PORT, "xp-0", cluster))])
        assert r is not None and r.bindings
        assert bridge.solver.last_round_fetches == 1
        assert bridge.solver.express_fetches == 1
        assert bridge.solver.last_round_loop_syncs >= 1

    def test_no_context_applies_events_and_waits(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg, run_first_round=False)
            assert not bridge.solver.express_ready
            r = bridge.express_batch(
                [("ADDED", arrival(pkg, "xp-0", cluster))]
            )
            assert r is None
            res = bridge.run_scheduler()
            assert "xp-0" in res.bindings
            return dict(res.bindings), stats_record(res.stats)

        both(script)

    def test_completion_frees_seat_no_placement(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg, running_fraction=0.3)
            run = next(t for t in bridge.tasks.values()
                       if t.phase == pkg.cluster.TaskPhase.RUNNING)
            r = bridge.express_batch([("DELETED", run)])
            assert r is None or r.bindings == {}
            assert run.uid not in bridge.tasks
            return batch_record(r), bridge.solver.express_ready

        both(script)

    def test_oversize_batch_degrades_loudly(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg, express_max_batch=4)
            pods = [arrival(pkg, f"xp-{k}", cluster, k) for k in range(6)]
            r = bridge.express_batch([("ADDED", p) for p in pods])
            assert r is None
            assert not bridge.solver.express_ready
            res = bridge.run_scheduler()
            assert res.stats.express_degrades == 1
            assert all(f"xp-{k}" in res.bindings for k in range(6))
            return dict(res.bindings), stats_record(res.stats)

        both(script)

    def test_adoption_outside_vocabulary_degrades(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            adopted = pkg.cluster.Task(
                uid="adopted-0", phase=pkg.cluster.TaskPhase.RUNNING,
                machine=cluster.machines[0].name,
            )
            r = bridge.express_batch([("ADDED", adopted)])
            assert r is None
            assert not bridge.solver.express_ready
            stats = bridge.run_scheduler().stats
            assert stats.express_degrades == 1
            return stats_record(stats)

        both(script)

    def test_unconfirmed_placement_blocks_next_batch(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            r = bridge.express_batch(
                [("ADDED", arrival(pkg, "xp-0", cluster))]
            )
            assert r is not None and r.bindings
            r2 = bridge.express_batch(
                [("ADDED", arrival(pkg, "xp-1", cluster))]
            )
            assert r2 is None
            res = bridge.run_scheduler()
            assert res.stats.express_degrades == 1
            assert "xp-1" in res.bindings
            return batch_record(r), dict(res.bindings)

        both(script)

    def test_node_event_invalidates_context(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            assert bridge.solver.express_ready
            bridge.observe_node_event("DELETED", cluster.machines[-1])
            assert not bridge.solver.express_ready

        both(script)

    def test_revoked_binding_invalidates_context(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            r = bridge.express_batch(
                [("ADDED", arrival(pkg, "xp-0", cluster))]
            )
            assert r is not None and r.bindings
            bridge.binding_failed("xp-0")
            assert not bridge.solver.express_ready
            return batch_record(r)

        both(script)


class TestCoalesce:
    def test_duplicate_added_coalesces_to_one_row(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            pod = arrival(pkg, "dup-0", cluster)
            r = bridge.express_batch([("ADDED", pod), ("ADDED", pod),
                                      ("MODIFIED", pod)])
            assert r is not None and list(r.bindings) == ["dup-0"]
            bridge.confirm_binding("dup-0", r.bindings["dup-0"])
            stats = bridge.run_scheduler().stats
            assert stats.express_places == 1
            assert stats.express_degrades == 0
            return batch_record(r), stats_record(stats)

        both(script)

    def test_added_then_deleted_is_net_noop(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            # flush the first round's retire backlog first
            first = bridge.express_batch([])
            pod = arrival(pkg, "flash-0", cluster)
            r = bridge.express_batch([("ADDED", pod), ("DELETED", pod)])
            assert r is None
            assert bridge.solver.express_ready
            assert "flash-0" not in bridge.tasks
            stats = bridge.run_scheduler().stats
            assert stats.express_degrades == 0
            return batch_record(first), stats_record(stats)

        both(script)

    def test_replayed_arrival_across_batches_is_noop(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            pod = arrival(pkg, "rep-0", cluster)
            r = bridge.express_batch([("ADDED", pod)])
            assert r is not None and r.bindings
            bridge.confirm_binding("rep-0", r.bindings["rep-0"])
            r2 = bridge.express_batch([("ADDED", pod)])
            assert r2 is None or r2.bindings == {}
            assert bridge.solver.express_ready
            assert bridge.pod_to_machine.get("rep-0") is not None
            return batch_record(r), batch_record(r2)

        both(script)


class TestDifferential:
    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_express_equals_next_round_choice(self, seed):
        def script(pkg):
            bridge, cluster = make_bridge(pkg, seed=seed)
            rng = np.random.default_rng(seed)
            pods = [
                arrival(pkg, f"xp-{seed}-{k}", cluster,
                        int(rng.integers(20)),
                        cpu=float(rng.choice([0.1, 0.2, 0.4])))
                for k in range(5)
            ]
            r = bridge.express_batch([("ADDED", p) for p in pods])
            assert r is not None and len(r.bindings) >= 1
            res = bridge.run_scheduler()
            for uid, machine in r.bindings.items():
                assert res.bindings.get(uid) == machine
            return (batch_record(r), dict(res.bindings),
                    stats_record(res.stats))

        both(script)

    @pytest.mark.parametrize("preemption", [False, True])
    def test_churn_mix_fuzz(self, preemption):
        def script(pkg):
            kw = dict(enable_preemption=True, migration_hysteresis=5,
                      running_fraction=0.25) if preemption else {}
            bridge, cluster = make_bridge(pkg, n_machines=16, n_tasks=80,
                                          seed=29, **kw)
            rng = np.random.default_rng(29)
            out = []
            for window in range(3):
                events = []
                for k in range(int(rng.integers(1, 5))):
                    events.append(("ADDED", arrival(
                        pkg, f"w{window}-{k}", cluster,
                        int(rng.integers(16)),
                    )))
                running = [t for t in bridge.tasks.values()
                           if t.phase == pkg.cluster.TaskPhase.RUNNING]
                if running:
                    events.append(("DELETED", running[
                        int(rng.integers(len(running)))]))
                r = bridge.express_batch(events)
                placed = dict(r.bindings) if r is not None else {}
                for uid, m in placed.items():
                    bridge.confirm_binding(uid, m)
                res = bridge.run_scheduler()
                s = res.stats
                corrected = {
                    u for u in placed
                    if u in res.migrations or u in res.preemptions
                }
                assert s.express_corrected == len(corrected)
                for uid, m in placed.items():
                    if uid not in corrected:
                        assert bridge.pod_to_machine.get(uid) == m
                for uid, (_frm, to) in res.migrations.items():
                    bridge.confirm_migration(uid, to)
                for uid in res.preemptions:
                    bridge.confirm_preemption(uid)
                out.append((batch_record(r), dict(res.bindings),
                            dict(res.migrations), dict(res.preemptions),
                            stats_record(s)))
            for uid, m in bridge.pod_to_machine.items():
                assert m in bridge.machines
            out.append(list(bridge.decision_log))
            return out

        both(script)

    @pytest.mark.parametrize("model", ["octopus", "coco"])
    def test_windows_of_retires_and_arrivals(self, model):
        """Three windows, each confirming the last one's express
        placements (so they reach K5 as retires) and adding arrivals
        with machine or rack preferences; then the correction round."""
        def script(pkg):
            bridge, cluster = make_bridge(pkg, n_machines=24, n_tasks=120,
                                          seed=7, cost_model=model)
            rng = np.random.default_rng(7)
            racks = sorted({m.rack for m in cluster.machines})
            out = []
            last = {}
            for window in range(3):
                for uid, m in last.items():
                    bridge.confirm_binding(uid, m)
                pods = []
                for k in range(4):
                    if k % 2:
                        prefs = {cluster.machines[
                            int(rng.integers(24))].name: 300}
                    else:
                        prefs = {racks[int(rng.integers(len(racks)))]: 200}
                    pods.append(pkg.cluster.Task(
                        uid=f"x{window}-{k}", cpu_request=0.25,
                        memory_request_kb=512, data_prefs=prefs,
                    ))
                r = bridge.express_batch([("ADDED", p) for p in pods])
                assert r is not None
                last = dict(r.bindings)
                out.append(batch_record(r))
            res = bridge.run_scheduler()
            out.append((dict(res.bindings), stats_record(res.stats)))
            return out

        both(script)


class TestScaleComposition:
    """Express composes with the scale lane (the reference's cases): the
    same placements under aggregation and a mesh in both packages, and
    the same as the plain lane. The port's mesh lies on ``[cpu] *
    width``, the reference's on its 8 forced host devices."""

    @pytest.mark.parametrize("opts", [
        {"aggregate_classes": True},
        {"mesh_width": 1},
        {"mesh_width": 8},
        {"mesh_width": 8, "aggregate_classes": True},
    ])
    def test_bit_identical_to_plain_lane(self, opts):
        def drive(pkg, **kw):
            bridge, cluster = make_bridge(pkg, n_machines=24, n_tasks=100,
                                          seed=5, **kw)
            pods = [arrival(pkg, f"xp-{k}", cluster, k) for k in range(4)]
            r = bridge.express_batch([("ADDED", p) for p in pods])
            assert r is not None, "express degraded"
            return batch_record(r), list(bridge.decision_log)

        def script(pkg):
            return drive(pkg, **opts)

        scaled = both(script)
        assert scaled[0][:3] == drive(PORT)[0][:3]

    def test_aggregated_expansion_respects_capacity(self):
        """Arrivals through one class spill over its members; every
        placement lands on a real machine with a free seat, equal in
        both packages."""
        def script(pkg):
            bridge, cluster = make_bridge(pkg, n_machines=12, n_tasks=40,
                                          seed=17, aggregate_classes=True,
                                          max_tasks_per_machine=6)
            seats = {m.name: m.max_tasks for m in cluster.machines}
            for _uid, m in bridge.pod_to_machine.items():
                seats[m] -= 1
            placed = {}
            for k in range(8):
                r = bridge.express_batch([("ADDED", arrival(pkg, f"sp-{k}"))])
                if r is None:
                    break
                for uid, m in r.bindings.items():
                    placed[uid] = m
                    bridge.confirm_binding(uid, m)
            for _uid, m in placed.items():
                seats[m] -= 1
            assert all(v >= 0 for v in seats.values()), seats
            return placed

        assert both(script)


class TestFlagOffBitIdentity:
    def test_rounds_identical_with_and_without_flag(self):
        results = []
        for lane in (False, True):
            cluster = port_synth.make_synthetic_cluster(
                18, 70, seed=41, prefs_per_task=2
            )
            bridge = port_bridge.SchedulerBridge(
                cost_model="quincy", small_to_oracle=False,
                express_lane=lane, device="cpu",
            )
            bridge.observe_nodes(list(cluster.machines))
            bridge.observe_pods(list(cluster.tasks))
            rounds = []
            for n in range(3):
                res = bridge.run_scheduler()
                for uid, m in res.bindings.items():
                    bridge.confirm_binding(uid, m)
                rounds.append(
                    (dict(res.bindings), res.stats.cost,
                     res.stats.pods_unscheduled)
                )
                bridge.observe_pod_event(
                    "ADDED", arrival(PORT, f"t{n}", cluster, n)
                )
            results.append(rounds)
        assert results[0] == results[1]


class TestChangeCapOverflow:
    def test_overflow_binds_everything_and_counts_degrade(self):
        def script(pkg):
            trace = pkg.trace()
            bridge, cluster = make_bridge(pkg, trace=trace)
            bridge.solver.express_change_cap = 1
            pods = [arrival(pkg, f"cc-{k}", cluster, k) for k in range(3)]
            r = bridge.express_batch([("ADDED", p) for p in pods])
            assert r is not None
            assert sorted(r.bindings) == ["cc-0", "cc-1", "cc-2"]
            assert bridge.solver.express_ready
            why = next(e for e in trace.events
                       if e.event == "EXPRESS_DEGRADE")
            assert "change_cap" in why.detail["why"]
            for uid, m in r.bindings.items():
                bridge.confirm_binding(uid, m)
            stats = bridge.run_scheduler().stats
            assert stats.express_degrades == 1
            assert stats.express_places == 3
            assert bridge.solver.express_fetches >= 2
            return batch_record(r), stats_record(stats)

        both(script)

    def test_under_cap_stays_on_compacted_path(self):
        def script(pkg):
            bridge, cluster = make_bridge(pkg)
            bridge.solver.express_change_cap = 8
            r = bridge.express_batch(
                [("ADDED", arrival(pkg, "uc-0", cluster))]
            )
            assert r is not None and list(r.bindings) == ["uc-0"]
            bridge.confirm_binding("uc-0", r.bindings["uc-0"])
            stats = bridge.run_scheduler().stats
            assert stats.express_degrades == 0
            return batch_record(r), stats_record(stats)

        both(script)


class TestDegradeAfterPatch:
    def test_next_round_starts_from_the_unpatched_warm_state(
        self, monkeypatch
    ):
        """A batch whose repair cannot certify (a fuse of one auction
        round) degrades after K5 retired the first round's bindings and
        K4 wrote its arrival rows. The warm state the next full round
        starts from is the one before the batch, so its rounds, phases
        and assignment equal the reference's."""
        monkeypatch.setattr(ref_res, "EXPRESS_FUSE", 1)
        monkeypatch.setattr(port_res, "EXPRESS_FUSE", 1)

        def script(pkg):
            bridge, cluster = make_bridge(pkg, seed=5)
            pods = [arrival(pkg, f"dg-{k}", cluster, 3 * k)
                    for k in range(6)]
            r = bridge.express_batch([("ADDED", p) for p in pods])
            assert r is None
            assert not bridge.solver.express_ready
            res = bridge.run_scheduler()
            warm = bridge.solver.warm
            assert res.stats.express_degrades == 1
            return (dict(res.bindings), stats_record(res.stats),
                    int(warm.rounds), int(warm.phases),
                    np.asarray(warm.asg).tolist(),
                    bridge.solver.last_round_fetches)

        out = both(script)
        assert out[2] > 0


# ---- the kernels' plain twins against the reference's programs -------


def _patch_case(rng, Tp, Mp, n):
    rows = rng.integers(-1, Tp + 2, n).astype(np.int32)
    rows[rng.random(n) < 0.3] = -1
    cols = rng.integers(-1, Mp + 2, n).astype(np.int32)
    cols[: n // 4] = cols[0]          # one column many times
    deltas = rng.integers(-3, 3, n).astype(np.int32)
    return rows, cols, deltas


@pytest.mark.parametrize("seed", range(4))
def test_patch_twin_equals_reference(seed):
    """K5's twin against ``_express_patch``, chunk after chunk (the
    clamp sits between chunks), with duplicate columns, rows and
    columns of -1 or past the axis, and sums driven below zero."""
    rng = np.random.default_rng(seed)
    Tp, Mp = 96, 20
    u = rng.integers(0, 1000, Tp).astype(np.int32)
    w = rng.integers(0, 1000, Tp).astype(np.int32)
    valid = rng.random(Tp) < 0.8
    s = rng.integers(0, 4, Mp).astype(np.int32)
    asg = rng.integers(-1, Mp + 1, Tp).astype(np.int32)
    lvl = rng.integers(0, 500, Tp).astype(np.int32)
    backlog = [_patch_case(rng, Tp, Mp, int(rng.integers(1, 2600)))]
    if seed == 0:
        # order matters: -2 then +1 on one column across a boundary
        r = np.full(1025, -1, np.int32)
        c = np.full(1025, 3, np.int32)
        d = np.zeros(1025, np.int32)
        d[0], d[1024] = -2 - int(s[3]), 1
        backlog = [(r, c, d)]
    chunks_ref = ref_res._express_patch_chunks(*backlog[0])
    chunks_port = port_res._express_patch_chunks(*backlog[0])
    assert len(chunks_ref) == len(chunks_port)
    ref_state = tuple(jnp.asarray(x) for x in (u, w, valid, s, asg, lvl))
    port_state = tuple(torch.from_numpy(x.copy())
                       for x in (u, w, valid, s, asg, lvl))
    for (rr, rc, rd), (pr, pc, pd) in zip(chunks_ref, chunks_port):
        assert np.array_equal(rr, pr) and np.array_equal(rc, pc)
        assert np.array_equal(rd, pd)
        ref_state = ref_res._express_patch(
            *ref_state, jnp.asarray(rr), jnp.asarray(rc), jnp.asarray(rd)
        )
        port_res._express_patch(
            *port_state, torch.from_numpy(pr), torch.from_numpy(pc),
            torch.from_numpy(pd),
        )
    for a, b in zip(ref_state, port_state):
        assert np.array_equal(np.asarray(a), b.numpy())
    if seed == 0:
        assert int(port_state[3][3]) == 1


def test_patch_twin_empty_and_one_column():
    Tp, Mp = 16, 16
    u = torch.arange(Tp, dtype=torch.int32)
    s = torch.full((Mp,), 2, dtype=torch.int32)
    state = [u.clone(), u.clone(), torch.ones(Tp, dtype=torch.bool),
             s.clone(), u.clone(), u.clone()]
    none = torch.full((1024,), -1, dtype=torch.int32)
    express_patch(*state, none, none, torch.zeros(1024, dtype=torch.int32))
    assert torch.equal(state[0], u) and torch.equal(state[3], s)
    cols = torch.full((1024,), 5, dtype=torch.int32)
    ones = torch.ones(1024, dtype=torch.int32)
    express_patch(*state, none, cols, ones)
    assert int(state[3][5]) == 1026
    express_patch(*state, none, cols, -2 * ones)
    assert int(state[3][5]) == 0 and int(state[3].sum()) == 2 * (Mp - 1)


def _weight_model_ref(inputs):
    return inputs.weight


def _weight_model_port(inputs):
    return inputs.weight.clone()


def _step_case(rng, *, wrap: bool, kmax: int, pk: int):
    """A hand-made warm instance (Tp 64, Mp 16, 12 real machines) and an
    arrival batch at K4's edges."""
    Tp, Mp, M, T, E = 64, 16, 12, 40, 200
    scale = T + 1
    s = np.concatenate([rng.integers(0, 3, M), np.zeros(Mp - M)])
    s[2] = 0                              # a real column without seats
    rack_of = np.concatenate([rng.integers(0, 3, M), np.full(Mp - M, -1)])
    cost_dev = rng.integers(0, 60, E).astype(np.int32)
    arc_m2s = np.concatenate([rng.integers(0, E, M), np.full(Mp - M, -1)])
    arc_r2m = np.concatenate([rng.integers(0, E, M), np.full(Mp - M, -1)])
    INF = ref_da.INF
    c = (rng.integers(0, 3000, (Tp, Mp)) * scale).astype(np.int64)
    c[:, s == 0] = INF
    c = np.minimum(c, INF).astype(np.int32)
    dgen = (rng.integers(0, 80, Mp) * scale).astype(np.int32)
    dgen[M:] = INF
    valid = np.arange(Tp) < T
    u = np.where(valid, rng.integers(0, 4000, Tp) * scale, 0).astype(np.int32)
    w = np.where(valid, rng.integers(0, 100, Tp) * scale, INF).astype(np.int32)
    asg = np.full(Tp, Mp, np.int32)       # unscheduled (padding: Mp)
    asg[:T:3] = -1                        # some awaiting a bid
    lvl = np.zeros(Tp, np.int32)
    floor = np.zeros(Mp, np.int32)
    # lanes of -1 beside rows 0 and Tp-1 (a live row rewritten, the
    # last padded row) and two free rows
    lanes = [-1, 0, Tp - 1, 50, 45, -1] if kmax > 1 else [Tp - 1]
    add_row = np.array((lanes * kmax)[:kmax], np.int32)
    add_pm = np.full((kmax, pk), -1, np.int32)
    add_pr = np.full((kmax, pk), -1, np.int32)
    for k in range(kmax):
        for j in range(pk):
            pick = rng.random()
            if pick < 0.35:
                # padded columns (>= M) and seatless ones included
                add_pm[k, j] = rng.choice([2, 13, 15, int(rng.integers(M))])
            elif pick < 0.7:
                add_pr[k, j] = rng.choice([-1, 0, 1, 2])
    Em = kmax * (3 + pk)
    hi = (1 << 29) - 7 if wrap else 3000
    weight = rng.integers(0, hi, Em).astype(np.int32)
    mini = dict(
        kind=np.full(Em, -1, np.int32), task=np.zeros(Em, np.int32),
        machine=np.zeros(Em, np.int32), weight=weight,
        discount=np.zeros(Em, np.int32), valid=np.ones(Em, bool),
        task_wait=np.zeros(kmax, np.int32),
        task_running=np.zeros(kmax, bool),
        task_input=np.zeros(kmax, np.int32),
        task_cpu=np.zeros(kmax, np.int32),
        task_mem_kb=np.zeros(kmax, np.int32),
        task_usage=np.zeros(kmax, np.float32),
        machine_load=np.zeros(Mp, np.float32),
        machine_mem_free=np.ones(Mp, np.float32),
        machine_used_slots=np.zeros(Mp, np.int32),
    )
    dt = dict(
        arc_unsched=np.full(Tp, -1, np.int32),
        arc_cluster=np.full(Tp, -1, np.int32),
        arc_u2s=np.full(Tp, -1, np.int32),
        arc_pref=np.full((Tp, pk), -1, np.int32),
        pref_machine=np.full((Tp, pk), -1, np.int32),
        pref_rack=np.full((Tp, pk), -1, np.int32),
        arc_c2m=np.full(Mp, -1, np.int32),
        arc_r2m=arc_r2m.astype(np.int32), arc_m2s=arc_m2s.astype(np.int32),
        rack_of=rack_of.astype(np.int32), slots=s.astype(np.int32),
    )
    inst = dict(c=c, u=u, w=w, dgen=dgen, s=s.astype(np.int32),
                task_valid=valid)
    return dict(inst=inst, dt=dt, mini=mini, cost=cost_dev, scale=scale,
                asg=asg, lvl=lvl, floor=floor, add_row=add_row,
                add_pm=add_pm, add_pr=add_pr, T=T)


@pytest.mark.parametrize("kmax,pk,wrap,seed", [
    (6, 3, False, 0), (6, 3, True, 1), (1, 1, False, 2), (4, 5, True, 3),
])
def test_express_step_equals_reference(kmax, pk, wrap, seed):
    """The whole express step (mini pricing, K4's rows through its twin,
    the arrival scatters, the eps=1 repair, the compaction and the
    primal) against the reference's ``_express_chain`` on the same
    hand-made inputs."""
    case = _step_case(np.random.default_rng(seed), wrap=wrap, kmax=kmax,
                      pk=pk)
    kw = dict(kmax=kmax, pk=pk, alpha=1024, max_rounds=5000, smax=4,
              change_cap=8)
    i, d = case["inst"], case["dt"]
    with enable_x64(True):
        rdev = ref_da.DenseInstance(
            **{k: jnp.asarray(v) for k, v in i.items()},
            scale=jnp.int32(case["scale"]), cmax=jnp.int32(0), smax=4,
        )
        rdt = ref_res.DenseTopology(
            **{k: jnp.asarray(v) for k, v in d.items()},
            n_tasks=jnp.int32(case["T"]),
        )
        rmini = ref_costs.CostInputs(
            **{k: jnp.asarray(v) for k, v in case["mini"].items()}
        )
        out_ref = ref_res._express_chain(
            rdev, rdt, jnp.asarray(case["cost"]), rmini,
            *(jnp.asarray(case[k]) for k in ("asg", "lvl", "floor",
                                              "add_row", "add_pm",
                                              "add_pr")),
            model_fn=_weight_model_ref, **kw,
        )
    # copies: K4 writes the port's table in place
    t = {k: torch.from_numpy(v.copy()) for k, v in i.items()}
    pdev = port_da.DenseInstance(**t, scale=case["scale"],
                                 cmax=torch.tensor(0, dtype=torch.int32),
                                 smax=4)
    pdt = port_res.DenseTopology(
        **{k: torch.from_numpy(v) for k, v in d.items()},
        n_tasks=case["T"],
    )
    pmini = port_costs.CostInputs(
        **{k: torch.from_numpy(v) for k, v in case["mini"].items()}
    )
    out_port = port_res._express_step(
        pdev, pdt, torch.from_numpy(case["cost"]), pmini,
        *(torch.from_numpy(case[k]) for k in ("asg", "lvl", "floor",
                                              "add_row", "add_pm",
                                              "add_pr")),
        model_fn=_weight_model_port, **kw,
    )
    rdev2, pdev2 = out_ref[0], out_port[0]
    for f in ("c", "u", "w", "task_valid", "s"):
        assert np.array_equal(np.asarray(getattr(rdev2, f)),
                              getattr(pdev2, f).numpy()), f
    names = ("asg", "lvl", "floor", "gap", "conv", "rounds", "phases",
             "rows_out", "asg_out", "n_changes", "domain_ok", "primal",
             "n_active", "report")
    for name, a, b in zip(names, out_ref[1:], out_port[1:]):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert np.array_equal(np.asarray(a), b), name
    # the edges were reached: live rows were written, lanes of -1 not
    live = case["add_row"][case["add_row"] >= 0]
    assert not np.array_equal(np.asarray(rdev2.c)[live], i["c"][live])
    assert bool(np.asarray(out_ref[11])) == (not wrap)


# ---- the watch window and the daemon loop ---------------------------


def _server(pkg_api, n_nodes=4, n_pods=6):
    server = pkg_api.FakeApiServer().start()
    for i in range(n_nodes):
        server.add_node(f"n{i}", cpu="8", memory="16Gi", pods=8)
    for j in range(n_pods):
        server.add_pod(f"p{j}", cpu="100m", memory="64Mi")
    return server, pkg_api.K8sApiClient("127.0.0.1", server.port)


class TestWatchExpressWindow:
    def test_poll_returns_pod_events_and_tracks_rv(self):
        import poseidon_tpu.apiclient as ref_api
        import poseidon_tpu_torch.apiclient as port_api

        def script(api):
            server, client = _server(api)
            watcher = api.ClusterWatcher(client, max_lag_s=120.0)
            try:
                watcher.tick()
                server.add_pod("late-0", cpu="100m", memory="64Mi")
                server.add_pod("late-1", cpu="100m", memory="64Mi")
                assert watcher.wait_caught_up(server.current_rv(), 10.0)
                ev = watcher.express_poll(1.0, max_events=8)
                assert not ev.needs_tick
                assert ev.t_first > 0
                assert len(ev.t_events) == len(ev.pod_events)
                delta = watcher.tick()
                assert delta.pod_events == [] and not delta.resynced
                return [(typ, t.uid, t.cpu_request)
                        for typ, t in ev.pod_events]
            finally:
                watcher.stop()
                server.stop()

        out = script(port_api)
        assert out == script(ref_api)
        assert [u for _t, u, _c in out] == [
            "default/late-0", "default/late-1"
        ]

    def test_node_event_requests_tick_and_is_not_lost(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            server.add_node("n-new", cpu="8", memory="16Gi", pods=8)
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            ev = watcher.express_poll(1.0)
            assert ev.needs_tick and ev.pod_events == []
            delta = watcher.tick()
            assert [m.name for _t, m in delta.node_events] == ["n-new"]
        finally:
            watcher.stop()
            server.stop()

    def test_pod_events_and_needs_tick_in_one_poll(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            server.add_pod("mid-drain", cpu="100m", memory="64Mi")
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            watcher._streams["pods"].queue.put(
                ("GONE", "test: injected mid-drain")
            )
            ev = watcher.express_poll(2.0, max_events=8)
            assert ev.needs_tick
            assert [t.uid for _typ, t in ev.pod_events] == [
                "default/mid-drain"
            ]
            delta = watcher.tick()
            assert all(t.uid != "default/mid-drain"
                       for _typ, t in delta.pod_events)
        finally:
            watcher.stop()
            server.stop()

    def test_gone_stream_requests_tick_resync(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            server.add_pod("pre-410", cpu="100m", memory="64Mi")
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            ev = watcher.express_poll(1.0)
            assert [t.uid for _typ, t in ev.pod_events] == [
                "default/pre-410"
            ]
            server.gone_next_watch(2)
            server.add_pod("post-410", cpu="100m", memory="64Mi")
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                ev = watcher.express_poll(0.2)
                if ev.needs_tick:
                    break
            assert ev.needs_tick
            delta = watcher.tick()
            assert delta.resynced
            assert any(t.uid == "default/post-410" for t in delta.pods)
        finally:
            watcher.stop()
            server.stop()

    def test_shed_hands_a_burst_to_the_tick(self):
        import poseidon_tpu_torch.apiclient as api

        server, client = _server(api)
        watcher = api.ClusterWatcher(client, max_lag_s=120.0)
        try:
            watcher.tick()
            for k in range(6):
                server.add_pod(f"burst-{k}", cpu="100m", memory="64Mi")
            assert watcher.wait_caught_up(server.current_rv(), 10.0)
            ev = watcher.express_poll(1.0, shed_queue=2)
            assert ev.shed and ev.needs_tick and ev.pod_events == []
            delta = watcher.tick()
            assert len([t for _typ, t in delta.pod_events]) == 6
        finally:
            watcher.stop()
            server.stop()


def _run_express_cli(argv, *, burst, feed_after_round=1, force_tick=False,
                     monkeypatch=None):
    """The port's daemon with the express lane against its fake
    apiserver on the dense route (>64 machines); ``burst`` pods arrive
    right after round ``feed_after_round`` completes."""
    import json
    import tempfile

    from poseidon_tpu_torch.apiclient import FakeApiServer
    from poseidon_tpu_torch.apiclient.watch import ClusterWatcher
    from poseidon_tpu_torch.cli import parse_args, run_loop

    forced: list[bool] = []
    if force_tick:
        orig = ClusterWatcher.express_poll

        def poll(self, timeout_s, max_events=16, **kw):
            ev = orig(self, timeout_s, max_events=max_events, **kw)
            if ev.pod_events and not forced:
                forced.append(True)
                ev.needs_tick = True
            return ev

        monkeypatch.setattr(ClusterWatcher, "express_poll", poll)
    stats_path = tempfile.mktemp(suffix=".jsonl")
    with FakeApiServer() as server:
        for i in range(66):
            server.add_node(f"n{i:03d}", cpu="16", memory="32Gi",
                            pods=8, rack=f"r{i % 8}")
        for j in range(90):
            server.add_pod(f"pod-{j:03d}", cpu="100m", memory="64Mi",
                           job=f"job{j // 10}")

        def hook(rounds, _result):
            if rounds == feed_after_round:
                for k in range(burst):
                    server.add_pod(f"late-{k}", cpu="100m",
                                   memory="64Mi")

        rc = run_loop(parse_args([
            "--k8s_apiserver_host=127.0.0.1",
            f"--k8s_apiserver_port={server.port}",
            "--watch=true", "--express_lane=true",
            "--flow_scheduling_cost_model=quincy",
            "--device=cpu", f"--stats_json={stats_path}", *argv,
        ]), round_hook=hook)
        bound = dict(server.bindings)
    rows = [json.loads(line) for line in open(stats_path)]
    return rc, bound, rows, forced


class TestExpressCliE2E:
    def test_intertick_arrivals_bind_express(self):
        rc, bound, rows, _ = _run_express_cli(
            ["--express_correction_rounds=1", "--polling_frequency=700000",
             "--max_rounds=3"], burst=4,
        )
        assert rc == 0
        for k in range(4):
            assert f"default/late-{k}" in bound
        assert sum(r["express_places"] for r in rows) >= 4
        assert any(r["express_e2b_p50_ms"] > 0 for r in rows)
        assert all(r["lane"] == "express" for r in rows)
        assert sum(r["express_degrades"] for r in rows) == 0

    def test_needs_tick_mid_drain_batch_still_binds(self, monkeypatch):
        rc, bound, _rows, forced = _run_express_cli(
            ["--express_correction_rounds=3", "--polling_frequency=700000",
             "--max_rounds=2"], burst=1, force_tick=True,
            monkeypatch=monkeypatch,
        )
        assert rc == 0
        assert forced, "the mid-drain needs_tick case never fired"
        assert "default/late-0" in bound


def test_express_flags_accept_reference_values():
    """The four express flags parse at any value the reference takes."""
    import poseidon_tpu.cli as ref_cli
    import poseidon_tpu_torch.cli as port_cli

    argv = ["--express_lane=true", "--express_max_batch=4",
            "--express_correction_rounds=3", "--express_shed_queue=0"]
    port = vars(port_cli.parse_args(argv + ["--device=cpu"]))
    ref = vars(ref_cli.parse_args(argv))
    for name in ("express_lane", "express_max_batch",
                 "express_correction_rounds", "express_shed_queue"):
        assert port[name] == ref[name]


def test_express_metric_recorders():
    from poseidon_tpu_torch.obs import MetricsRegistry, SchedulerMetrics

    m = SchedulerMetrics(MetricsRegistry())
    m.record_express_batch([1.5, 2.5])
    m.record_express_degrade("repair uncertified after 3 rounds")
    m.record_express_fetch()
    m.record_express_shed()
    text = m.registry.render()
    assert "poseidon_express_batches_total 1" in text
    assert "poseidon_express_places_total 2" in text
    assert 'why="uncertified"' in text
    assert 'lane="express"' in text
    assert "poseidon_express_shed_total 1" in text
