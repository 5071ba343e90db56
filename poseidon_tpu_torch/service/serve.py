"""The ``--serve`` driver: N tenant apiservers, one scheduling device.

The port of ``poseidon_tpu/service/serve.py``; ``--device`` picks the
card (the default) or the CPU.

Each tenant is a (client, session) pair: the loop polls every tenant's
apiserver, submits a round for each tenant with schedulable work, pumps
the service's double-buffered pipeline once, and actuates the finished
wave's deltas back against each tenant's own apiserver — so wave k's
binding POSTs overlap wave k+1's in-flight batch. Per-tenant isolation
holds end to end: every tenant has its own bridge, trace stream, and
decision log, and a binding only ever POSTs to the apiserver it was
observed from.

Tenant sources:

- ``--serve_apiservers=host:port,host:port,...`` — real endpoints, one
  tenant each (named ``tenant-<i>``);
- ``--serve_tenants=N`` — N in-process fake apiservers with
  heterogeneous synthetic workloads (distinct node/pod counts, cost
  models cycled across the registry, preemption enabled on every 4th
  tenant): the zero-dependency demo/smoke mode CI drives.

``--max_rounds`` counts dispatch cycles (0 = forever); the loop exits
early in fake mode once every tenant's pods are bound.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time

from poseidon_tpu_torch.apiclient.client import ApiError, K8sApiClient
from poseidon_tpu_torch.service.service import SchedulingService
from poseidon_tpu_torch.trace import TraceGenerator

log = logging.getLogger("poseidon_tpu_torch.serve")

# fake-mode tenant heterogeneity: cost models cycled per tenant (the
# registry minus 'random', whose hashed costs make bit-identity sweeps
# noisy to read), preemption on every 4th tenant
_FAKE_MODELS = ("quincy", "coco", "octopus")


def _fake_tenants(n: int, stack: contextlib.ExitStack):
    """Spin up N in-process fake apiservers with heterogeneous synthetic
    workloads; returns [(tenant_id, server, cost_model, preemption)]."""
    from poseidon_tpu_torch.apiclient.fake_server import FakeApiServer

    out = []
    for i in range(n):
        server = stack.enter_context(FakeApiServer())
        n_nodes = 4 + 3 * (i % 5)
        n_pods = 24 + 11 * (i % 7)
        for k in range(n_nodes):
            server.add_node(
                f"t{i}-n{k:03d}", cpu="16", memory="32Gi", pods=10,
                rack=f"t{i}-r{k % 3}",
            )
        for j in range(n_pods):
            prefs = (
                {f"t{i}-n{j % n_nodes:03d}": 40 + (j % 5) * 10}
                if j % 3 == 0 else None
            )
            server.add_pod(
                f"t{i}-pod-{j:04d}", cpu="100m", memory="64Mi",
                job=f"t{i}-job{j // 6}", data_prefs=prefs,
            )
        out.append((
            f"tenant-{i}", server, _FAKE_MODELS[i % len(_FAKE_MODELS)],
            i % 4 == 3,
        ))
    return out


def run_serve(args: argparse.Namespace) -> int:
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr if args.logtostderr else None,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    # observability (shared across tenants; per-tenant series carry a
    # bounded tenant label — see obs/metrics.py)
    obs_server = None
    health = None
    sched_metrics = None
    if args.metrics_port:
        from poseidon_tpu_torch.obs import (
            HealthState,
            MetricsRegistry,
            ObsServer,
            SchedulerMetrics,
        )

        sched_metrics = SchedulerMetrics(MetricsRegistry())
        health = HealthState(ready_gauge=sched_metrics.ready)
        obs_server = ObsServer(
            sched_metrics.registry, health, port=args.metrics_port,
            host=args.metrics_host,
        )
    service = SchedulingService(
        oracle_timeout_s=args.max_solver_runtime / 1e6,
        max_batch=args.serve_max_batch,
        metrics=sched_metrics,
        device=args.device,
    )

    with contextlib.ExitStack() as stack:
        trace_fh = None
        if args.trace_log:
            trace_fh = stack.enter_context(open(args.trace_log, "a"))
        tenants: list[tuple[str, K8sApiClient]] = []
        fake = []
        if args.serve_apiservers:
            endpoints = [
                e for e in args.serve_apiservers.split(",") if e
            ]
            for i, ep in enumerate(endpoints):
                host, _, port = ep.partition(":")
                tid = f"tenant-{i}"
                service.add_tenant(
                    tid,
                    cost_model=args.flow_scheduling_cost_model,
                    trace=TraceGenerator(sink=trace_fh),
                    enable_preemption=args.enable_preemption == "true",
                    incremental_build=args.incremental_build == "true",
                    max_tasks_per_machine=args.max_tasks_per_pu,
                )
                tenants.append((
                    tid,
                    K8sApiClient(
                        host or "127.0.0.1", int(port or 8080),
                        args.k8s_api_version, timeout_s=10.0,
                    ),
                ))
        elif args.serve_tenants > 0:
            fake = _fake_tenants(args.serve_tenants, stack)
            for tid, server, model, preempt in fake:
                service.add_tenant(
                    tid,
                    cost_model=model,
                    trace=TraceGenerator(sink=trace_fh),
                    enable_preemption=preempt,
                    incremental_build=args.incremental_build == "true",
                    max_tasks_per_machine=args.max_tasks_per_pu,
                )
                tenants.append((
                    tid,
                    K8sApiClient("127.0.0.1", server.port,
                                 args.k8s_api_version, timeout_s=10.0),
                ))
        else:
            log.error(
                "--serve needs --serve_apiservers=h:p,... or "
                "--serve_tenants=N"
            )
            return 2
        clients = dict(tenants)

        def _observe(tid: str) -> bool:
            session = service.sessions[tid]
            try:
                nodes = clients[tid].all_nodes()
                pods = clients[tid].all_pods()
            except ApiError as e:
                log.error(
                    "tenant %s poll failed, skipping: %s", tid, e
                )
                return False
            session.bridge.observe_nodes(nodes)
            session.bridge.observe_pods(pods)
            return True

        def _actuate(tid: str, result) -> None:
            from poseidon_tpu_torch.cli import (
                _actuate_rebalance,
                _post_bindings,
            )

            session = service.sessions[tid]
            client = clients[tid]
            if result.bindings:
                for uid, machine, outcome in _post_bindings(
                    client, session.bridge, result.bindings
                ):
                    if outcome == "ok":
                        session.bridge.confirm_binding(uid, machine)
                    else:
                        log.warning(
                            "tenant %s bind POST failed for %s; "
                            "re-queueing", tid, uid,
                        )
                        session.bridge.binding_failed(uid)
            if result.migrations or result.preemptions:
                _actuate_rebalance(
                    client, session.bridge, result.migrations,
                    result.preemptions, confirm=True,
                )

        if obs_server is not None:
            obs_server.start()
        try:
            cycles = 0
            while True:
                tick_start = time.perf_counter()
                observed = [t for t, _ in tenants if _observe(t)]
                if health is not None and observed:
                    health.mark_seeded()
                for tid in observed:
                    service.submit(tid)
                # one pipeline advance: finishes (and returns) the
                # previous wave, then launches this one — the returned
                # wave's binding POSTs below overlap the batch now in
                # flight
                for tid, result in service.pump():
                    _actuate(tid, result)
                    s = result.stats
                    log.info(
                        "%s round %d: pending=%d placed=%d cost=%d "
                        "backend=%s total=%.1fms", tid, s.round_num,
                        s.pods_pending, s.pods_placed, s.cost,
                        s.backend, s.total_ms,
                    )
                    if health is not None:
                        health.mark_round(s.backend)
                cycles += 1
                if args.max_rounds and cycles >= args.max_rounds:
                    break
                if fake and all(
                    len(server.bindings) >= len(server.pods)
                    for _, server, _, _ in fake
                ):
                    break
                elapsed = time.perf_counter() - tick_start
                time.sleep(
                    max(args.polling_frequency / 1e6 - elapsed, 0.0)
                )
            # drain: finish the last in-flight wave and POST its deltas
            for tid, result in service.flush():
                _actuate(tid, result)
        finally:
            if obs_server is not None:
                obs_server.stop()
    return 0
