"""Scheduling-as-a-service: one device, a fleet of tenant clusters.

The port of ``poseidon_tpu/service/service.py``. ONE ``SchedulingService``
serves N heterogeneous tenants: each tenant keeps a fully isolated
``SchedulerBridge`` (own cluster state, stats, trace stream, decision
log, knowledge base — no tenant ever sees another's uids), while every
tenant's round solve routes through one shared ``BatchDispatcher``
(service/dispatch.py) that pads instances into shape buckets and
solves each bucket as one batched device program with one batched
fetch.

The front door is an async request queue: ``submit(tenant_id)``
enqueues one scheduling round and returns a ``concurrent.futures
.Future`` resolving to that tenant's ``RoundResult``. The driver (cli
``--serve``, ``chip_smoke.py``, or an embedding process) calls ``pump()``
to advance the double-buffered pipeline, the PR-1 begin/finish split
writ multi-tenant:

    pump k:   finish wave k-1 (join ITS fetch, deltas, stats)
              begin + launch wave k (builds, pricing, upload,
              dispatch; the solves and the fetch on a worker)                          ──┐
    driver:   actuate wave k-1's binding POSTs, observe the     │ overlap
              next tick, queue the next submissions           ◄─┘

so the driver's actuation and observe host work elapse while wave k's
batch is in flight on the device, and every tenant completes one
round per pump. Same-tick duplicate submissions for one tenant wait
for the next wave (one round in flight per tenant, the bridge's own
invariant).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import logging
import time

from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.service.dispatch import BatchDispatcher, TenantSolver
from poseidon_tpu_torch.trace import TraceGenerator

log = logging.getLogger(__name__)

# Prometheus label-cardinality bound: the first N registered tenants
# get their own label value, later ones collapse into "other" (the
# per-tenant series stay finite no matter how many tenants churn
# through a long-lived service).
MAX_TENANT_LABELS = 24


@dataclasses.dataclass
class TenantSession:
    """One tenant's isolated scheduling state inside the service."""

    tenant_id: str
    bridge: SchedulerBridge
    solver: TenantSolver
    trace: TraceGenerator
    label: str                      # bounded metrics label
    rounds: int = 0
    placed_total: int = 0
    last_round_ms: float = 0.0


@dataclasses.dataclass
class _Wave:
    """One in-flight dispatch wave: (session, InflightRound, future,
    t_submit) per member."""

    entries: list = dataclasses.field(default_factory=list)


class SchedulingService:
    """The multi-tenant front door (``device=None`` is the card).
    Single-threaded by contract on the pump side (every bridge/dispatcher call happens on the pump
    caller's thread); ``submit`` may be called from any thread — the
    deque append and the Future are the documented handoffs."""

    def __init__(
        self,
        *,
        alpha: int = 1024,
        max_rounds: int | None = None,
        oracle_fallback: bool = True,
        oracle_timeout_s: float = 1000.0,
        max_batch: int = 64,
        metrics=None,
        device=None,
    ):
        self.metrics = metrics
        self.dispatcher = BatchDispatcher(
            alpha=alpha,
            max_rounds=max_rounds,
            oracle_fallback=oracle_fallback,
            oracle_timeout_s=oracle_timeout_s,
            max_batch=max_batch,
            metrics=metrics,
            device=device,
        )
        self.sessions: dict[str, TenantSession] = {}
        # submissions: (tenant_id, Future, t_submit); deque append/pop
        # are atomic (GIL) — the cross-thread handoff for submit()
        self._submissions: collections.deque = collections.deque()
        self._inflight: _Wave | None = None
        self.waves = 0

    # ---- tenants -------------------------------------------------------

    def add_tenant(
        self,
        tenant_id: str,
        *,
        cost_model: str = "quincy",
        trace: TraceGenerator | None = None,
        enable_preemption: bool = False,
        migration_hysteresis: int = 20,
        max_migrations_per_round: int = 64,
        incremental_build: bool = True,
        max_tasks_per_machine: int = 10,
    ) -> TenantSession:
        """Register one tenant: its own bridge (isolated state, trace,
        decision log) wired to the shared dispatcher through a
        ``TenantSolver``. Per-tenant cost models and flag sets are the
        point — heterogeneity is batched, not normalized away."""
        if tenant_id in self.sessions:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        solver = TenantSolver(tenant_id, self.dispatcher)
        tr = trace or TraceGenerator()
        # every event this session emits carries the tenant id,
        # so N tenants can share one trace sink and still be
        # reported individually (trace report --tenant)
        tr.tenant = tenant_id
        lifecycle = None
        if self.metrics is not None:
            # per-tenant lifecycle timelines close into the SHARED
            # e2c histogram under lane="service" (the bridge stamps
            # the lane from its own lane label)
            from poseidon_tpu_torch.obs.lifecycle import LifecycleTracker

            lifecycle = LifecycleTracker(self.metrics)
        bridge = SchedulerBridge(
            cost_model=cost_model,
            max_tasks_per_machine=max_tasks_per_machine,
            trace=tr,
            enable_preemption=enable_preemption,
            migration_hysteresis=migration_hysteresis,
            max_migrations_per_round=max_migrations_per_round,
            incremental_build=incremental_build,
            solver=solver,
            lifecycle=lifecycle,
        )
        bridge.lane = "service"
        label = (
            tenant_id if len(self.sessions) < MAX_TENANT_LABELS
            else "other"
        )
        session = TenantSession(
            tenant_id=tenant_id, bridge=bridge, solver=solver,
            trace=tr, label=label,
        )
        self.sessions[tenant_id] = session
        return session

    # ---- the async front door ------------------------------------------

    def submit(self, tenant_id: str) -> concurrent.futures.Future:
        """Enqueue one scheduling round for a tenant; the Future
        resolves to its ``RoundResult`` after a later ``pump()``
        dispatches and finishes the wave containing it."""
        if tenant_id not in self.sessions:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._submissions.append((tenant_id, fut, time.perf_counter()))
        return fut

    def pump(self) -> list[tuple[str, object]]:
        """Advance the pipeline one wave: finish the previous wave
        (join ITS batched fetch), then begin + launch the next one
        from the queued submissions. Returns the finished wave's
        [(tenant_id, RoundResult)] (empty on the priming call).

        The overlap window is everything the caller does AFTER pump
        returns and before the next pump — actuating the returned
        wave's binding POSTs, observing the next tick — all of which
        elapses while the just-launched wave is in flight on the
        device. (Finishing BEFORE beginning is what lets every tenant
        complete one round per pump: the alternative ordering skips
        any tenant still in flight, halving throughput and growing
        the submission queue without bound under a steady driver.)
        """
        done = self._finish_wave(self._inflight)
        self._inflight = None
        wave = _Wave()
        skipped: list = []
        seen: set[str] = set()
        while self._submissions:
            tenant_id, fut, t_submit = self._submissions.popleft()
            if tenant_id in seen:
                # one round per tenant per wave: same-tick duplicate
                # submissions wait for the next wave (order preserved)
                skipped.append((tenant_id, fut, t_submit))
                continue
            seen.add(tenant_id)
            session = self.sessions[tenant_id]
            try:
                ir = session.bridge.begin_round()
            except Exception as e:  # a failed build must not kill the wave
                log.exception(
                    "tenant %s begin_round failed", tenant_id
                )
                fut.set_exception(e)
                continue
            if ir.result is not None:
                # empty round: completed synchronously
                self._account(session, ir.result, t_submit)
                fut.set_result(ir.result)
                continue
            wave.entries.append((session, ir, fut, t_submit))
        self._submissions.extendleft(reversed(skipped))
        if wave.entries:
            self.dispatcher.launch()
            self.waves += 1
            self._inflight = wave
        return done

    def flush(self) -> list[tuple[str, object]]:
        """Finish the in-flight wave (and any still-queued submissions)
        without starting a new one: pump until the pipeline drains."""
        out = self._finish_wave(self._inflight)
        self._inflight = None
        while self._submissions:
            out.extend(self.pump())
        out.extend(self._finish_wave(self._inflight))
        self._inflight = None
        return out

    def _finish_wave(self, wave: _Wave | None) -> list:
        if wave is None:
            return []
        done = []
        for session, ir, fut, t_submit in wave.entries:
            try:
                result = session.bridge.finish_round(ir)
            except Exception as e:
                log.exception(
                    "tenant %s finish_round failed",
                    session.tenant_id,
                )
                session.bridge.cancel_round(ir)
                fut.set_exception(e)
                continue
            self._account(session, result, t_submit)
            fut.set_result(result)
            done.append((session.tenant_id, result))
        return done

    def _account(self, session, result, t_submit: float) -> None:
        session.rounds += 1
        session.placed_total += len(result.bindings)
        session.last_round_ms = (
            time.perf_counter() - t_submit
        ) * 1000
        if self.metrics is not None:
            self.metrics.record_service_round(
                session.label, session.last_round_ms,
                len(result.bindings),
            )
