"""Differential tests: the port's multi-tenant service vs the reference's.

The port of ``tests/test_service.py``: the same tenant clusters go
through ``poseidon_tpu``'s ``SchedulingService`` and
``poseidon_tpu_torch``'s (``device="cpu"``) side by side, and every
tenant's round — bindings, migrations, preemptions, cost, backend and
rounds — must be equal (tolerance 0). Each class mirrors the
reference's: the bucket solve against the solo solve (the reference's
``solve_transport_dense`` on the same instance), the bridge
differential with and without preemption, warm waves, chunked dispatch,
the build budget in steady state (the port's ``CompileCounter``:
kernel builds and new launch plans), isolation, the budget messages,
the front door, and ``--serve=true --serve_tenants=3`` posting the same
bindings as the reference's CLI.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import pytest

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.cluster as ref_cluster
import poseidon_tpu.service as ref_service
import poseidon_tpu.synth as ref_synth
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.cluster as port_cluster
import poseidon_tpu_torch.service as port_service
import poseidon_tpu_torch.synth as port_synth
from poseidon_tpu.ops.dense_auction import solve_transport_dense
from poseidon_tpu.ops.transport import TransportInstance as RefInstance

from tests.test_torch_graph import build_reference_oracle


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    """The reference's side of these tests can solve on its C++ oracle,
    which it builds in place on first use: have the binary whole first
    (``tests/test_torch_graph.py``'s ``build_reference_oracle``)."""
    build_reference_oracle()


pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REF = types.SimpleNamespace(bridge=ref_bridge, cluster=ref_cluster,
                            service=ref_service, synth=ref_synth,
                            kw={}, solo_kw={})
PORT = types.SimpleNamespace(bridge=port_bridge, cluster=port_cluster,
                             service=port_service, synth=port_synth,
                             kw={"device": "cpu"}, solo_kw={"device": "cpu"})
MODELS = ("quincy", "coco", "octopus")


def _tenant_cluster(pkg, i: int, *, n_machines=None, n_tasks=None,
                    running_fraction=0.0, seed=None, prefix=""):
    """A small tenant cluster (the reference test's shapes: every tenant
    in one (32, 16) padding bucket while T/M stay heterogeneous);
    ``prefix`` namespaces uids and machines per tenant."""
    cluster = pkg.synth.make_synthetic_cluster(
        n_machines if n_machines is not None else 5 + (i % 4),
        n_tasks if n_tasks is not None else 18 + 4 * (i % 4),
        seed=seed if seed is not None else 1000 + i,
        prefs_per_task=2,
        running_fraction=running_fraction,
    )
    if not prefix:
        return cluster
    machines = [dataclasses.replace(m, name=f"{prefix}{m.name}")
                for m in cluster.machines]
    tasks = [
        dataclasses.replace(
            t, uid=f"{prefix}{t.uid}",
            machine=f"{prefix}{t.machine}" if t.machine else "",
            data_prefs={(f"{prefix}{k}" if k.startswith("m") else k): v
                        for k, v in t.data_prefs.items()},
        )
        for t in cluster.tasks
    ]
    return dataclasses.replace(cluster, machines=machines, tasks=tasks)


def _feed(service, tid, cluster):
    bridge = service.sessions[tid].bridge
    bridge.observe_nodes(cluster.machines)
    bridge.observe_pods(cluster.tasks)


def _round_all(service, tenants):
    futs = {t: service.submit(t) for t in tenants}
    service.pump()
    service.flush()
    return {t: f.result(timeout=60) for t, f in futs.items()}


def _record(results) -> dict:
    return {
        t: (dict(r.bindings), dict(r.migrations), sorted(r.preemptions),
            r.stats.cost, r.stats.backend, r.stats.round_num,
            r.stats.pods_placed, r.stats.lane)
        for t, r in results.items()
    }


def _ref_instance(inst) -> RefInstance:
    return RefInstance(**{f.name: getattr(inst, f.name)
                          for f in dataclasses.fields(RefInstance)})


def _assert_solo(service, tid, result):
    """A bucketed tenant round equals the reference's solo dense solve
    of the same instance."""
    solver = service.sessions[tid].solver
    res, _ = solve_transport_dense(_ref_instance(solver.last_instance))
    assert res.converged
    assert result.stats.cost == res.cost
    assert np.array_equal(solver.last_assignment, res.assignment)


def both(script):
    ref_out, port_out = script(REF), script(PORT)
    assert port_out == ref_out
    return port_out


class TestHeterogeneousKernel:
    def test_bit_identity_mixed_shapes_and_models(self):
        from tests.helpers import build_priced
        from poseidon_tpu.ops.transport import extract_instance
        from poseidon_tpu_torch.ops.batch import solve_heterogeneous
        from poseidon_tpu_torch.ops.transport import TransportInstance

        rng = np.random.default_rng(7)
        insts, solo = [], []
        for shape, model in [((5, 18), "quincy"), ((7, 26), "coco"),
                             ((8, 31), "octopus")]:
            net, meta, _ = build_priced(rng, *shape, model=model)
            inst = extract_instance(net, meta)
            insts.append(TransportInstance(**{
                f.name: getattr(inst, f.name)
                for f in dataclasses.fields(TransportInstance)}))
            solo.append(solve_transport_dense(inst)[0])
        br = solve_heterogeneous(insts, device="cpu")
        for b, (inst, res) in enumerate(zip(insts, solo)):
            T = inst.n_tasks
            assert bool(br.converged[b])
            assert int(br.costs[b]) == res.cost
            assert np.array_equal(br.assignments[b, :T], res.assignment)


class TestServiceExactness:
    @pytest.mark.parametrize("model", MODELS)
    def test_cold_round_bit_identical_to_solo(self, model):
        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            tenants = []
            for i in range(3):
                tid = f"t{i}"
                m = model if i == 0 else MODELS[
                    (MODELS.index(model) + i) % len(MODELS)]
                service.add_tenant(tid, cost_model=m)
                _feed(service, tid, _tenant_cluster(pkg, i))
                tenants.append(tid)
            results = _round_all(service, tenants)
            for tid in tenants:
                assert results[tid].stats.backend == "dense_service"
                _assert_solo(service, tid, results[tid])
            return _record(results)

        both(script)

    @pytest.mark.parametrize("preemption", [False, True])
    def test_bridge_differential_vs_solo_scheduler(self, preemption):
        def script(pkg):
            cluster = _tenant_cluster(
                pkg, 0, n_machines=6, n_tasks=24,
                running_fraction=0.25 if preemption else 0.0, seed=77,
            )
            solo = pkg.bridge.SchedulerBridge(
                cost_model="quincy", small_to_oracle=False,
                enable_preemption=preemption, **pkg.solo_kw,
            )
            solo.observe_nodes(cluster.machines)
            solo.observe_pods(cluster.tasks)
            solo_result = solo.run_scheduler()
            service = pkg.service.SchedulingService(**pkg.kw)
            service.add_tenant("t0", cost_model="quincy",
                               enable_preemption=preemption)
            service.add_tenant("t1", cost_model="coco")
            _feed(service, "t0", cluster)
            _feed(service, "t1", _tenant_cluster(pkg, 1, seed=78))
            svc = _round_all(service, ["t0", "t1"])["t0"]
            assert svc.bindings == solo_result.bindings
            assert svc.migrations == solo_result.migrations
            assert svc.preemptions == solo_result.preemptions
            assert svc.stats.cost == solo_result.stats.cost
            return (dict(svc.bindings), dict(svc.migrations),
                    sorted(svc.preemptions), svc.stats.cost)

        both(script)

    def test_warm_round_stays_optimal(self):
        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            for i in range(2):
                service.add_tenant(f"t{i}", cost_model="quincy")
                _feed(service, f"t{i}", _tenant_cluster(pkg, i))
            first = _round_all(service, ["t0", "t1"])
            results = _round_all(service, ["t0", "t1"])  # warm wave
            for tid in ("t0", "t1"):
                assert results[tid].stats.backend == "dense_service"
                _assert_solo(service, tid, results[tid])
            return _record(first), _record(results)

        both(script)

    def test_chunked_dispatch_still_exact(self):
        def script(pkg):
            service = pkg.service.SchedulingService(max_batch=2, **pkg.kw)
            tenants = []
            for i in range(5):
                tid = f"t{i}"
                service.add_tenant(tid, cost_model="quincy")
                _feed(service, tid, _tenant_cluster(pkg, i, seed=300 + i))
                tenants.append(tid)
            results = _round_all(service, tenants)
            for tid in tenants:
                _assert_solo(service, tid, results[tid])
            return _record(results), service.dispatcher.dispatches

        rec, dispatches = both(script)
        assert dispatches >= 2

    def test_one_fetch_per_chunk(self):
        service = port_service.SchedulingService(max_batch=2, device="cpu")
        tenants = [f"t{i}" for i in range(5)]
        for i, tid in enumerate(tenants):
            service.add_tenant(tid, cost_model="quincy")
            _feed(service, tid, _tenant_cluster(PORT, i, seed=300 + i))
        _round_all(service, tenants)
        d = service.dispatcher
        assert d.dispatches == 3
        assert d.fetches.count == d.dispatches
        assert d.loop_syncs.count > 0


def _churn(pkg, cluster, rng, round_no):
    tasks = [t for t in cluster.tasks if t.phase.value == "Pending"]
    keep = tasks[2:] if len(tasks) > 10 else tasks
    machines = cluster.machines
    new = [
        pkg.cluster.Task(
            uid=f"{machines[0].name}-new-{round_no}-{k}",
            job=f"job-new-{round_no}",
            cpu_request=0.25,
            memory_request_kb=1 << 18,
            data_prefs={
                machines[int(rng.integers(0, len(machines)))].name:
                    int(rng.integers(20, 120))
            },
        )
        for k in range(2)
    ]
    cluster.tasks[:] = keep + new
    return cluster


class TestZeroRebuild:
    def test_steady_state_waves_build_nothing(self):
        """After a cold and a warm wave, three waves of churning tenant
        shapes make no kernel build and no new launch plan, and every
        round equals the reference's."""
        from poseidon_tpu_torch.guards import CompileCounter

        def script(pkg, counter=None):
            rng = np.random.default_rng(5)
            service = pkg.service.SchedulingService(**pkg.kw)
            clusters = {}
            for i in range(3):
                tid = f"t{i}"
                service.add_tenant(tid, cost_model="quincy")
                clusters[tid] = _tenant_cluster(pkg, i, seed=500 + i)
                _feed(service, tid, clusters[tid])
            tenants = list(clusters)
            out = [_record(_round_all(service, tenants)),
                   _record(_round_all(service, tenants))]
            with counter or contextlib.nullcontext():
                for w in range(3):
                    for tid in tenants:
                        c = _churn(pkg, clusters[tid], rng, w)
                        bridge = service.sessions[tid].bridge
                        bridge.observe_nodes(c.machines)
                        bridge.observe_pods(c.tasks)
                    results = _round_all(service, tenants)
                    for r in results.values():
                        assert r.stats.backend == "dense_service"
                    out.append(_record(results))
            return out

        counter = CompileCounter()
        assert script(PORT, counter) == script(REF)
        assert counter.count == 0


class TestIsolation:
    def test_no_cross_tenant_uids_in_trace_or_decision_log(self):
        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            clusters = {}
            for i in range(3):
                tid = f"t{i}"
                service.add_tenant(tid, cost_model=MODELS[i])
                clusters[tid] = _tenant_cluster(pkg, i, seed=900 + i,
                                                prefix=f"{tid}-")
                _feed(service, tid, clusters[tid])
            tenants = list(clusters)
            results = _round_all(service, tenants)
            for tid, r in results.items():
                for uid, machine in r.bindings.items():
                    service.sessions[tid].bridge.confirm_binding(uid,
                                                                 machine)
            second = _round_all(service, tenants)
            uids = {tid: {t.uid for t in clusters[tid].tasks}
                    for tid in tenants}
            for tid in tenants:
                session = service.sessions[tid]
                own = uids[tid]
                foreign = set().union(*(uids[o] for o in tenants
                                        if o != tid))
                for ev in session.trace.events:
                    if ev.task:
                        assert ev.task in own and ev.task not in foreign
                for _r, _kind, uid, _d in session.bridge.decision_log:
                    assert uid in own
            return _record(results), _record(second)

        both(script)

    def test_per_tenant_stats_isolated(self):
        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            for i in range(2):
                service.add_tenant(f"t{i}", cost_model="quincy")
                _feed(service, f"t{i}", _tenant_cluster(pkg, i,
                                                        seed=910 + i))
            results = _round_all(service, ["t0", "t1"])
            for r in results.values():
                assert r.stats.pods_placed == len(r.bindings)
            return _record(results)

        rec = both(script)
        assert rec["t0"][5] == rec["t1"][5] == 1
        assert rec["t0"][7] == "service"


class TestBudgetMessage:
    def test_batched_overflow_suggests_largest_fitting_batch(
        self, monkeypatch
    ):
        from poseidon_tpu_torch.ops import dense_auction as port_da

        monkeypatch.setattr(port_da, "DENSE_TABLE_BUDGET_BYTES", 64 << 20)
        with pytest.raises(port_da.DenseMemoryTooLarge) as ei:
            port_da.check_table_budget(2048, 2048, 8)
        msg = str(ei.value)
        assert "n_variants <= 4" in msg and "--serve_max_batch" in msg
        assert port_da.max_variants_for(2048, 2048) == 4

    def test_single_instance_overflow_has_no_batch_hint(self, monkeypatch):
        from poseidon_tpu_torch.ops import dense_auction as port_da

        monkeypatch.setattr(port_da, "DENSE_TABLE_BUDGET_BYTES", 1 << 20)
        with pytest.raises(port_da.DenseMemoryTooLarge) as ei:
            port_da.check_table_budget(2048, 2048, 1)
        msg = str(ei.value)
        assert "n_variants" not in msg
        assert "POSEIDON_TPU_TORCH_DENSE_TABLE_BUDGET_MB" in msg

    def test_dispatcher_chunks_against_budget(self, monkeypatch):
        import poseidon_tpu.service.dispatch as ref_dispatch
        import poseidon_tpu_torch.service.dispatch as port_dispatch

        for mod in (ref_dispatch, port_dispatch):
            real_fit = mod.max_variants_for

            def tiny_fit(Tp, Mp, side_ints_per_variant=0, _real=real_fit,
                         **kw):
                return min(_real(Tp, Mp,
                                 side_ints_per_variant=side_ints_per_variant,
                                 **kw), 2)

            monkeypatch.setattr(mod, "max_variants_for", tiny_fit)

        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            tenants = []
            for i in range(5):
                tid = f"t{i}"
                service.add_tenant(tid, cost_model="quincy")
                _feed(service, tid, _tenant_cluster(pkg, i, seed=700 + i))
                tenants.append(tid)
            results = _round_all(service, tenants)
            for tid in tenants:
                _assert_solo(service, tid, results[tid])
            return _record(results), service.dispatcher.dispatches

        _rec, dispatches = both(script)
        assert dispatches >= 3


class TestFrontDoor:
    def test_tenant_resubmitted_while_in_flight_waits_a_wave(self):
        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            service.add_tenant("t0", cost_model="quincy")
            _feed(service, "t0", _tenant_cluster(pkg, 0, seed=40))
            f1 = service.submit("t0")
            service.pump()
            f2 = service.submit("t0")
            service.pump()
            done1 = f1.done()
            service.flush()
            return (done1, f2.done(), f1.result().stats.round_num,
                    f2.result().stats.round_num,
                    _record({"a": f1.result(), "b": f2.result()}))

        out = both(script)
        assert out[:4] == (True, True, 1, 2)

    def test_unknown_tenant_raises(self):
        service = port_service.SchedulingService(device="cpu")
        with pytest.raises(KeyError):
            service.submit("nope")

    def test_duplicate_tenant_raises(self):
        service = port_service.SchedulingService(device="cpu")
        service.add_tenant("t0")
        with pytest.raises(ValueError):
            service.add_tenant("t0")

    def test_empty_round_resolves_synchronously(self):
        def script(pkg):
            service = pkg.service.SchedulingService(**pkg.kw)
            service.add_tenant("t0", cost_model="quincy")
            _feed(service, "t0",
                  _tenant_cluster(pkg, 0, n_tasks=0, seed=41))
            fut = service.submit("t0")
            service.pump()
            return fut.done(), fut.result().bindings

        assert both(script) == (True, {})

    def test_oracle_degrade_is_loud(self, monkeypatch):
        import poseidon_tpu.service.dispatch as ref_dispatch
        import poseidon_tpu_torch.service.dispatch as port_dispatch

        def script(pkg):
            mod = ref_dispatch if pkg is REF else port_dispatch
            err = (mod.DenseMemoryTooLarge)

            def no_fit(*a, **kw):
                raise err("forced by test")

            service = pkg.service.SchedulingService(**pkg.kw)
            service.add_tenant("t0", cost_model="quincy")
            _feed(service, "t0", _tenant_cluster(pkg, 0, seed=42))
            with monkeypatch.context() as m:
                m.setattr(mod, "check_table_budget", no_fit)
                results = _round_all(service, ["t0"])
            return _record(results)

        rec = both(script)
        assert rec["t0"][4] == "oracle:memory-envelope"
        assert rec["t0"][6] > 0


class TestServeDriver:
    def test_serve_three_fake_tenants_post_the_reference_bindings(self):
        """``--serve=true --serve_tenants=3``: every pod of each fake
        tenant binds on ITS OWN apiserver, to the same nodes as the
        reference's CLI binds them."""
        import poseidon_tpu.cli as ref_cli
        import poseidon_tpu.service.serve as ref_serve
        import poseidon_tpu_torch.cli as port_cli
        import poseidon_tpu_torch.service.serve as port_serve

        def run(cli, serve_mod, extra):
            captured = {}
            real = serve_mod._fake_tenants

            def capture(n, stack):
                out = real(n, stack)
                captured["tenants"] = [(tid, server)
                                       for tid, server, _m, _p in out]
                return out

            serve_mod._fake_tenants = capture
            try:
                rc = cli.main(["--serve=true", "--serve_tenants=3",
                               "--polling_frequency=100000",
                               "--max_rounds=8", *extra])
            finally:
                serve_mod._fake_tenants = real
            assert rc == 0
            out = {}
            for tid, server in captured["tenants"]:
                i = tid.split("-")[1]
                assert len(server.bindings) == len(server.pods), tid
                for key, node in server.bindings:
                    assert key.startswith(f"default/t{i}-pod-"), key
                    assert node.startswith(f"t{i}-n"), (key, node)
                out[tid] = sorted(server.bindings)
            return out

        ref = run(ref_cli, ref_serve, [])
        port = run(port_cli, port_serve, ["--device=cpu"])
        assert port == ref
        assert len(port) == 3

    def test_serve_needs_a_tenant_source(self):
        import poseidon_tpu_torch.cli as port_cli

        assert port_cli.main(["--serve=true", "--device=cpu"]) == 2

    def test_serve_flags_parse_as_the_reference(self):
        import poseidon_tpu.cli as ref_cli
        import poseidon_tpu_torch.cli as port_cli

        argv = ["--serve=true", "--serve_apiservers=127.0.0.1:1,h:2",
                "--serve_tenants=5", "--serve_max_batch=8"]
        port = vars(port_cli.parse_args(argv + ["--device=cpu"]))
        ref = vars(ref_cli.parse_args(argv))
        for name in ("serve", "serve_apiservers", "serve_tenants",
                     "serve_max_batch"):
            assert port[name] == ref[name]
            assert name not in port_cli.UNPORTED_FLAGS


def test_service_metric_recorders():
    def script(pkg):
        obs = __import__(f"{pkg.bridge.__name__.split('.')[0]}.obs",
                         fromlist=["MetricsRegistry"])
        m = obs.SchedulerMetrics(obs.MetricsRegistry())
        m.record_service_round("t0", 12.5, 3)
        m.record_service_dispatch("32x16x2", 2)
        m.record_service_compiles(0)
        return sorted(line for line in m.registry.render().splitlines()
                      if line.startswith("poseidon_service")
                      and "_bucket{" not in line)

    assert both(script)
