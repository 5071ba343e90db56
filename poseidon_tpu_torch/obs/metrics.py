"""Dependency-free metrics registry + the scheduler's instrument set.

Three instrument kinds, all label-aware, all guarded by ONE registry
lock (recording sites run inside the round's hot path on the daemon loop
thread; ``render`` runs on the metrics server's handler thread — the
shared lock is the documented discipline, declared in
``analysis/contracts.py`` under PTA004):

- ``Counter``: monotonically increasing float (``inc``);
- ``Gauge``: last-write-wins float (``set``);
- ``Histogram``: fixed cumulative buckets + sum + count (``observe``).
  Buckets are FIXED at registration — no dynamic re-bucketing on the
  hot path, one tuple shared by every labelset.

``render()`` emits Prometheus text exposition format (version 0.0.4):
``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples,
``_bucket``/``_sum``/``_count`` for histograms with cumulative ``le``.

``SchedulerMetrics`` declares every instrument the scheduler feeds and
owns the recording helpers the bridge / resident solver / watcher /
express lane call. The contract: recording happens at finish/actuate
time ONLY, from host-side values the caller already holds (stats
fields, perf-counter durations, outcome counts) — never a device
fetch, never an O(cluster) walk. The family names are the
reference's (``tests/test_torch_obs.py`` holds the two expositions to
the same set).
"""

from __future__ import annotations

import collections
import math
import threading

from poseidon_tpu_torch.obs.lifecycle import bounded_lane

# Default latency buckets (milliseconds): spans sub-ms express repairs
# through multi-second degraded rounds. One shared tuple — the bucket
# loop on the hot path is a fixed 13 iterations, not data-dependent.
LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
)

# Express event-to-bind buckets: the lane's budget is single-digit ms,
# so the resolution lives there.
E2B_BUCKETS_MS = (
    0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 25.0, 50.0, 100.0, 250.0,
)

# Lifecycle event-to-confirmed buckets: the tick lane waits for a
# round (polling periods are seconds), the express lane binds in
# single-digit ms, the restart lane spans a process death — one set
# covers ms through minutes.
E2C_BUCKETS_MS = (
    1.0, 5.0, 10.0, 25.0, 100.0, 500.0, 1000.0, 5000.0, 15_000.0,
    60_000.0, 300_000.0,
)

# compile latency buckets (ms): first-use builds run 100ms-10s+
COMPILE_BUCKETS_MS = (
    10.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    10_000.0, 30_000.0,
)


def _labelkey(labels: dict) -> tuple:
    """Canonical hashable key for one labelset."""
    return tuple(sorted(labels.items()))


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render without the '.0';
    non-finite values use the exposition format's spellings (an inf
    gauge — e.g. an SLO percentile beyond the top histogram bucket —
    must not crash every subsequent scrape)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return str(int(f)) if f == int(f) else repr(f)


def _fmt_labels(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    """Base: name, help text, and the registry's shared lock."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, lock: threading.Lock):
        self.name = name
        self.help = help_
        self._lock = lock

    def _render(self, out: list[str]) -> None:  # pragma: no cover
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help_: str, lock: threading.Lock):
        super().__init__(name, help_, lock)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount == 0:
            return
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def _render(self, out: list[str]) -> None:
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help_: str, lock: threading.Lock):
        super().__init__(name, help_, lock)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def snapshot(self) -> dict[tuple, float]:
        """Labelset -> value copy under the lock (the SLO engine's
        read surface)."""
        with self._lock:
            return dict(self._values)

    def _render(self, out: list[str]) -> None:
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(
        self, name: str, help_: str, lock: threading.Lock,
        buckets: tuple[float, ...],
    ):
        super().__init__(name, help_, lock)
        self.buckets = tuple(sorted(buckets))
        # labelset -> (per-bucket counts list, sum, count)
        self._values: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _labelkey(labels)
        with self._lock:
            slot = self._values.get(key)
            if slot is None:
                slot = [[0] * len(self.buckets), 0.0, 0]
                self._values[key] = slot
            counts, _, _ = slot
            for i, le in enumerate(self.buckets):
                if value <= le:
                    counts[i] += 1
            slot[1] += value
            slot[2] += 1

    def snapshot(self) -> dict[tuple, tuple]:
        """Labelset -> (bucket counts copy, sum, count) under the
        lock — the SLO engine's windowed-burn read surface."""
        with self._lock:
            return {
                key: (list(counts), total, n)
                for key, (counts, total, n) in self._values.items()
            }

    def _render(self, out: list[str]) -> None:
        for key, (counts, total, n) in sorted(self._values.items()):
            for le, c in zip(self.buckets, counts):
                le_label = 'le="%s"' % _fmt_value(le)
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, le_label)} {c}"
                )
            inf_label = 'le="+Inf"'
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(key, inf_label)} {n}"
            )
            out.append(
                f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}"
            )
            out.append(f"{self.name}_count{_fmt_labels(key)} {n}")


class MetricsRegistry:
    """Owns every instrument + the one lock they all record under.

    Registration is idempotent (same name returns the existing
    instrument; a kind mismatch raises — two subsystems silently
    sharing a name as different kinds is a bug).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Instrument] = {}

    def _register(self, cls, name: str, help_: str, **kw) -> _Instrument:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                return existing
            m = cls(name, help_, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge, name, help_)

    def histogram(
        self, name: str, help_: str = "",
        buckets: tuple[float, ...] = LATENCY_BUCKETS_MS,
    ) -> Histogram:
        return self._register(Histogram, name, help_, buckets=buckets)

    def render(self) -> str:  # pta: background-thread
        """Prometheus text exposition; called from the metrics server's
        handler thread (the shared lock is the cross-thread contract)."""
        out: list[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    out.append(f"# HELP {name} {m.help}")
                out.append(f"# TYPE {name} {m.kind}")
                m._render(out)
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# the scheduler's instrument set
# ---------------------------------------------------------------------------

# resync-storm detection: gauge flips to 1 when the last STORM_WINDOW
# rounds saw >= STORM_RESYNCS full-LIST resyncs (a flapping watch
# stream re-listing the cluster every tick is an operational incident,
# not a per-event log line)
STORM_WINDOW = 8
STORM_RESYNCS = 3

# deliberate oracle ROUTING (small instances, non-taxonomy graphs) is
# dispatch, not degradation — mirrors the bridge's degrades_total rule
_ROUTED_WHYS = ("small-instance", "not-scheduling-shaped")


def _backend_family(backend: str) -> str:
    if not backend:
        return "empty"
    if backend.startswith("oracle:"):
        return "oracle"
    return "dense"


def resync_reason_label(reason: str) -> str:
    """Bounded label for a free-text resync reason (Prometheus label
    cardinality must stay finite)."""
    if "410" in reason:
        return "gone"
    if "watch_max_lag" in reason:
        return "stale"
    if "unparseable" in reason or "undecodable" in reason:
        return "decode"
    return "error"


# every label value a record_* helper mints is folded onto one of
# these bounded vocabularies BEFORE it reaches an instrument — an
# out-of-vocabulary value becomes "other", never a fresh series
# (unbounded label churn is how a metrics endpoint ODs its scraper;
# the reference's observatory tests fuzz every fold)

# daemon loop lane compositions (cli builds "watch+pipelined+sharded"...)
_LANE_PARTS = frozenset({
    "poll", "watch", "express", "pipelined", "sharded", "agg",
    "round", "service", "bench",
})

_DEGRADE_WHYS = frozenset({
    "memory-envelope", "cost-domain", "uncertified", "kernel-envelope",
    "general-unconverged", "general-infeasible", "general-guard",
    "small-instance", "not-scheduling-shaped",
})

_BUILD_MODES = frozenset({"delta", "full", "legacy", "none"})

_RESOURCES = frozenset({"nodes", "pods"})


def lane_label(lane: str) -> str:
    """Fold a daemon loop lane composition onto the bounded vocabulary:
    every '+'-part must be known, else the whole value is "other"."""
    if not lane:
        return "round"
    if all(p in _LANE_PARTS for p in lane.split("+")):
        return lane
    return "other"


def degrade_why_label(why: str) -> str:
    return why if why in _DEGRADE_WHYS else "other"


def build_mode_label(mode: str) -> str:
    mode = mode or "none"
    return mode if mode in _BUILD_MODES else "other"


def resource_label(resource: str) -> str:
    return resource if resource in _RESOURCES else "other"


class SchedulerMetrics:
    """Every instrument the scheduler feeds, plus recording helpers.

    One instance per daemon, shared by the bridge, the resident solver,
    and the watcher. All ``record_*`` methods take host-side values the
    caller already holds, under the reference's family names.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.rounds = registry.counter(
            "poseidon_rounds_total",
            "scheduling rounds completed, by lane and backend family",
        )
        self.round_latency = registry.histogram(
            "poseidon_round_latency_ms",
            "per-round host critical path (SchedulerStats.total_ms), "
            "by lane and build mode",
        )
        self.round_phase = registry.gauge(
            "poseidon_round_phase_ms",
            "last round's per-phase host timers, by phase",
        )
        self.pods = registry.gauge(
            "poseidon_pods",
            "pod counts at the last round, by state",
        )
        self.round_cost = registry.gauge(
            "poseidon_round_cost",
            "last round's exact solve objective",
        )
        self.deltas = registry.counter(
            "poseidon_deltas_total",
            "scheduling deltas emitted, by kind "
            "(place/migrate/preempt/noop/deferred)",
        )
        self.evictions = registry.counter(
            "poseidon_evictions_total",
            "tasks evicted by node loss",
        )
        self.bind_failures = registry.counter(
            "poseidon_bind_failures_total",
            "binding/actuation POSTs that failed (pod re-queued)",
        )
        self.fetch_timeouts = registry.counter(
            "poseidon_fetch_timeouts_total",
            "pipelined placement fetches that missed "
            "--max_solver_runtime",
        )
        self.degrades = registry.counter(
            "poseidon_degrades_total",
            "dense-lane degrades to the CPU oracle, by why "
            "(deliberate small-instance routing is not counted)",
        )
        self.degraded = registry.gauge(
            "poseidon_degraded",
            "1 while the most recent SOLVING round degraded to the "
            "oracle, by why; cleared by the next non-degraded solve "
            "(certified dense or deliberate oracle routing); empty "
            "no-solve rounds leave it unchanged",
        )
        self.watch_resyncs = registry.counter(
            "poseidon_watch_resyncs_total",
            "watch degradations to a full LIST resync, by reason "
            "(gone/decode/stale/error)",
        )
        self.watch_reconnects = registry.counter(
            "poseidon_watch_reconnects_total",
            "error-path watch stream reconnects, by resource",
        )
        self.resync_storm = registry.gauge(
            "poseidon_watch_resync_storm",
            f"1 while >= {STORM_RESYNCS} resyncs landed within the "
            f"last {STORM_WINDOW} rounds",
        )
        self.express_batches = registry.counter(
            "poseidon_express_batches_total",
            "express-lane batches that completed certified "
            "(including retire/completion-only batches with zero "
            "placements)",
        )
        self.express_places = registry.counter(
            "poseidon_express_places_total",
            "pods bound between round ticks by the express lane",
        )
        self.express_degrades = registry.counter(
            "poseidon_express_degrades_total",
            "express batches that fell back to the round path, by why",
        )
        self.express_corrected = registry.counter(
            "poseidon_express_corrected_total",
            "express placements the correction round moved",
        )
        self.express_e2b = registry.histogram(
            "poseidon_express_e2b_ms",
            "express event-to-bind-decision latency",
            buckets=E2B_BUCKETS_MS,
        )
        self.solver_fetches = registry.counter(
            "poseidon_solver_fetches_total",
            "sanctioned device->host placement fetches, by lane "
            "(round/express/stream)",
        )
        self.stream_flushes = registry.counter(
            "poseidon_stream_flushes_total",
            "stream-lane flushes (K accumulated windows scanned as "
            "one device program with one fetch)",
        )
        self.placements_per_fetch = registry.gauge(
            "poseidon_placements_per_fetch",
            "placements per sanctioned fetch in the last stream "
            "flush (the sync-floor amortization the stream lane "
            "buys; the synced express lane pins this at its "
            "per-batch placement count)",
        )
        self.solver_warm = registry.gauge(
            "poseidon_solver_warm",
            "1 while a warm device DenseState is live",
        )
        self.express_context_ready = registry.gauge(
            "poseidon_express_context_ready",
            "1 while a warm express context is patchable between ticks",
        )
        self.ready = registry.gauge(
            "poseidon_ready",
            "the /readyz latch: 1 after seed LIST + first round over "
            "real state (certified solve or proven-empty)",
        )
        # ---- the quality observatory (obs/lifecycle|audit|slo) ----
        self.pod_e2c = registry.histogram(
            "poseidon_pod_e2c_ms",
            "per-pod event-to-confirmed latency by (bounded) "
            "lifecycle lane (tick/express/service/restart/other); "
            "restart-lane samples are wall-differenced across the "
            "process boundary (the documented clock-contract "
            "exception)",
            buckets=E2C_BUCKETS_MS,
        )
        self.unsched_wait = registry.gauge(
            "poseidon_unsched_wait_rounds",
            "wait-age distribution of STANDING unscheduled pods at "
            "the last round, by quantile (p50/p95/max)",
        )
        self.lifecycle_dropped = registry.counter(
            "poseidon_lifecycle_dropped_total",
            "pod timelines dropped because the lifecycle tracker was "
            "at its open-timeline bound",
        )
        self.trace_dropped = registry.counter(
            "poseidon_trace_dropped_total",
            "trace events overwritten by the bounded in-memory ring "
            "before any flush (a post-mortem trace missing them is "
            "partial, not complete)",
        )
        self.audit_regret = registry.gauge(
            "poseidon_audit_regret",
            "shadow audit: status-quo placement cost minus the "
            "certified optimum of the same re-priced instance (0 = "
            "placing optimally within the stated hysteresis)",
        )
        self.audit_drift = registry.gauge(
            "poseidon_audit_drift_pods",
            "shadow audit: running pods whose placement differs from "
            "the audit optimum (tie-noisy; regret is the alertable "
            "number)",
        )
        self.audit_frag = registry.gauge(
            "poseidon_audit_frag_slots",
            "shadow audit fragmentation index: largest free seat "
            "count on any single machine, by (bounded) SKU class — "
            "the biggest one-machine gang that could still land",
        )
        self.audit_ms = registry.gauge(
            "poseidon_audit_ms",
            "wall time of the most recent shadow audit (background "
            "thread; not on any round's critical path)",
        )
        self.audit_runs = registry.counter(
            "poseidon_audit_runs_total",
            "completed shadow audits, by outcome (ok/error)",
        )
        self.slo_healthy = registry.gauge(
            "poseidon_slo_healthy",
            "1 while the objective's burn-rate alert is inactive, by "
            "slo (operator-declared specs: bounded by construction)",
        )
        self.slo_burn = registry.gauge(
            "poseidon_slo_burn_rate",
            "error-budget burn rate by slo and window (short/long); "
            ">1 sustained in both windows trips the breach latch",
        )
        self.slo_value = registry.gauge(
            "poseidon_slo_value",
            "current point value of the objective's source (display "
            "estimate; the burn math uses exact bucket counts)",
        )
        self.slo_breaches = registry.counter(
            "poseidon_slo_breaches_total",
            "SLO breach-latch trips (exactly one per breach window), "
            "by slo",
        )
        # ---- device telemetry: live device memory + kernel builds ----
        self.device_hbm = registry.gauge(
            "poseidon_device_hbm_bytes",
            "device memory by kind: live = the backend's own "
            "bytes-in-use (platforms that expose memory_stats), "
            "predicted = check_table_budget's per-device estimate "
            "for the last dense round — the budget guard's math "
            "cross-checked against real hardware",
        )
        self.xla_compile = registry.histogram(
            "poseidon_xla_compile_ms",
            "first-use nvcc build latency of the CUDA kernels (the "
            "reference's XLA compile family, same name; nonzero only "
            "at the first dense round of a process)",
            buckets=COMPILE_BUCKETS_MS,
        )
        self.flightrec_dumps = registry.counter(
            "poseidon_flightrec_dumps_total",
            "anomaly flight-recorder dumps written, by (bounded) "
            "reason (degrade/express-degrade/fetch-timeout/"
            "resync-storm/manual)",
        )
        # ---- failure-domain survival ----
        self.guard_holds = registry.counter(
            "poseidon_eviction_guard_holds_total",
            "mass-eviction guard holds (an implausible >50% snapshot "
            "shrink held pending strikes/grace), by kind (node/pod)",
        )
        self.guard_releases = registry.counter(
            "poseidon_eviction_guard_releases_total",
            "mass-eviction guard releases, by kind and outcome "
            "(accepted = honored as true death after the strike/grace "
            "bound; recovered = the snapshot healed mid-hold)",
        )
        self.guard_active = registry.gauge(
            "poseidon_eviction_guard_active",
            "1 while the mass-eviction guard is holding a shrink, by "
            "kind (node/pod)",
        )
        self.outage = registry.gauge(
            "poseidon_outage",
            "1 while the apiserver-outage degradation ladder is "
            "active (consecutive transport failures crossed "
            "--outage_threshold); rounds keep solving from last-known "
            "state, POSTs park in the actuation outbox",
        )
        self.outage_episodes = registry.counter(
            "poseidon_outage_episodes_total",
            "apiserver outage windows entered (ONE per window, "
            "however many POSTs/polls failed inside it)",
        )
        self.outbox_pending = registry.gauge(
            "poseidon_outbox_pending",
            "actuations parked in the outbox awaiting a reachable "
            "apiserver",
        )
        self.outbox_retries = registry.counter(
            "poseidon_outbox_retries_total",
            "outbox retry attempts (jittered backoff per entry)",
        )
        self.outbox_settled = registry.counter(
            "poseidon_outbox_settled_total",
            "outboxed actuations settled, by outcome (replayed/"
            "already-applied/stale)",
        )
        self.outbox_dead_letters = registry.counter(
            "poseidon_outbox_dead_letters_total",
            "outboxed actuations that exhausted their retry budget "
            "(pod re-queued through binding_failed), by op",
        )
        self.express_shed = registry.counter(
            "poseidon_express_shed_total",
            "express windows shed to the tick path because the pods "
            "stream queue exceeded --express_shed_queue (overload "
            "backpressure: the full round absorbs the burst)",
        )
        self.round_deadline_misses = registry.counter(
            "poseidon_round_deadline_misses_total",
            "rounds whose wall span exceeded --round_deadline_ms "
            "(the overload watchdog)",
        )
        self.overload = registry.gauge(
            "poseidon_overload",
            "1 while consecutive round-deadline misses have declared "
            "degraded=overload (express windows shed to the tick "
            "path); cleared by a round meeting the deadline",
        )
        # ---- crash safety / HA ----
        self.checkpoint_bytes = registry.gauge(
            "poseidon_checkpoint_bytes",
            "size of the most recent completed warm-state checkpoint "
            "(npz + manifest)",
        )
        self.checkpoint_age = registry.gauge(
            "poseidon_checkpoint_age_seconds",
            "seconds since the most recent completed warm-state "
            "checkpoint (alert when this exceeds a few cadences: the "
            "writer is wedged or failing)",
        )
        self.journal_replays = registry.counter(
            "poseidon_journal_replays_total",
            "incomplete journaled actuations replayed at restart, by "
            "outcome (replayed/already-applied/stale/failed/conflict)",
        )
        self.restores = registry.counter(
            "poseidon_restores_total",
            "warm-state restores performed at startup",
        )
        self.build_info = registry.gauge(
            "poseidon_build_info",
            "constant 1; the labels carry the build identity "
            "(package version, torch and CUDA versions, device kind, "
            "mesh_width) — "
            "join on it to slice any series by deploy",
        )
        # ---- the service lane ----
        self.service_rounds = registry.counter(
            "poseidon_service_rounds_total",
            "service-lane tenant rounds completed, by (bounded) tenant",
        )
        self.service_round_ms = registry.histogram(
            "poseidon_service_round_ms",
            "per-tenant submit-to-result round latency in the service "
            "lane, by (bounded) tenant",
        )
        self.service_placements = registry.counter(
            "poseidon_service_placements_total",
            "pods placed across ALL tenants by the service lane (the "
            "aggregate pods/sec numerator)",
        )
        self.service_dispatches = registry.counter(
            "poseidon_service_dispatches_total",
            "batched bucket dispatches (one upload + one batched "
            "fetch each), by bucket shape TpxMpxP",
        )
        self.service_bucket_occupancy = registry.gauge(
            "poseidon_service_bucket_occupancy",
            "tenant instances in the most recent dispatch of each "
            "bucket shape",
        )
        self.service_compiles = registry.counter(
            "poseidon_service_compiles_total",
            "compiles triggered by service launches (nonzero only "
            "during warmup / bucket growth; 0 in steady state)",
        )
        # degraded-gauge bookkeeping: whys currently set to 1, so a
        # recovery round can clear exactly what an earlier round set
        self._degraded_whys: set[str] = set()
        self._resync_window: collections.deque[int] = collections.deque(
            maxlen=STORM_WINDOW
        )
        # fragmentation SKU labels the last audit published (a drained
        # class is zeroed, not left at its last value)
        self._frag_skus: set[str] = set()

    # ---- per-round recording (bridge finish/begin path) ---------------

    def record_round(self, stats) -> None:
        """Record one completed round from its ``SchedulerStats`` —
        every input is a host float/int the bridge already computed."""
        lane = lane_label(stats.lane)
        family = _backend_family(stats.backend)
        self.rounds.inc(lane=lane, backend=family)
        if stats.backend:
            # latency/cost/phase describe a SOLVE: an idle cluster's
            # empty rounds (one per tick, ~µs total_ms, cost 0) would
            # otherwise collapse the histogram's p50 toward zero and
            # clobber the last real round's gauges — the same rounds
            # the trace report excludes ("no solve to time")
            self.round_latency.observe(
                stats.total_ms, lane=lane,
                build_mode=build_mode_label(stats.build_mode),
            )
            for phase, dur in (
                ("observe", stats.observe_ms),
                ("build", stats.build_ms),
                ("price", stats.price_ms),
                ("solve", stats.solve_ms),
                ("decompose", stats.decompose_ms),
                ("dispatch", stats.dispatch_ms),
                ("fetch_wait", stats.fetch_wait_ms),
                ("overlap", stats.overlap_ms),
            ):
                self.round_phase.set(dur, phase=phase)
            self.round_cost.set(stats.cost)
        self.pods.set(stats.pods_total, state="total")
        self.pods.set(stats.pods_pending, state="pending")
        self.pods.set(stats.pods_placed, state="placed")
        self.pods.set(stats.pods_unscheduled, state="unscheduled")
        self.deltas.inc(stats.deltas_place, kind="place")
        self.deltas.inc(stats.deltas_migrate, kind="migrate")
        self.deltas.inc(stats.deltas_preempt, kind="preempt")
        self.deltas.inc(stats.deltas_noop, kind="noop")
        self.deltas.inc(stats.deltas_deferred, kind="deferred")
        self.evictions.inc(stats.evictions)
        self.bind_failures.inc(stats.bind_failures)
        self.fetch_timeouts.inc(stats.fetch_timeouts)
        self.express_corrected.inc(stats.express_corrected)
        # degraded-to-oracle state as a labeled gauge tracking the
        # most recent SOLVE: set on a degraded round, cleared by any
        # non-degraded solve (certified dense or deliberately-routed
        # oracle). Empty rounds carry no solve evidence either way.
        why = ""
        if stats.backend.startswith("oracle:"):
            w = stats.backend.split(":", 1)[1]
            if w not in _ROUTED_WHYS:
                why = degrade_why_label(w)
        if why:
            self.degraded.set(1, why=why)
            self._degraded_whys.add(why)
        elif stats.backend:
            for w in self._degraded_whys:
                self.degraded.set(0, why=w)
            self._degraded_whys.clear()
        # resync storm over a sliding round window
        self._resync_window.append(stats.watch_resyncs)
        self.resync_storm.set(
            1 if sum(self._resync_window) >= STORM_RESYNCS else 0
        )

    def record_degrade(self, why: str) -> None:
        """One non-deliberate dense-lane degrade (the DEGRADE event's
        metrics twin)."""
        self.degrades.inc(why=degrade_why_label(why))

    # ---- failure-domain survival ----------------------------------------

    def record_guard_hold(self, kind: str) -> None:
        """One mass-eviction-guard hold (bridge observe path; kind is
        the bridge's own node/pod vocabulary — folded for safety)."""
        kind = kind if kind in ("node", "pod") else "other"
        self.guard_holds.inc(kind=kind)
        self.guard_active.set(1, kind=kind)

    def record_guard_release(self, kind: str, outcome: str) -> None:
        kind = kind if kind in ("node", "pod") else "other"
        outcome = outcome if outcome in ("accepted", "recovered") \
            else "other"
        self.guard_releases.inc(kind=kind, outcome=outcome)
        self.guard_active.set(0, kind=kind)

    def record_outage(self, active: bool) -> None:
        """The outage ladder flipped (ONE episode tick per entry)."""
        self.outage.set(1 if active else 0)
        if active:
            self.outage_episodes.inc()

    def record_outbox(
        self, pending: int, *, retries: int = 0, settled: str = "",
        dead_letter_op: str = "",
    ) -> None:
        """Outbox bookkeeping after a pump/enqueue (host ints the
        outbox already holds)."""
        self.outbox_pending.set(pending)
        if retries:
            self.outbox_retries.inc(retries)
        if settled:
            outcome = settled if settled in (
                "replayed", "already-applied", "stale"
            ) else "other"
            self.outbox_settled.inc(outcome=outcome)
        if dead_letter_op:
            op = dead_letter_op if dead_letter_op in (
                "bind", "evict", "migrate"
            ) else "other"
            self.outbox_dead_letters.inc(op=op)

    def record_express_shed(self) -> None:
        self.express_shed.inc()

    def record_deadline_miss(self, overloaded: bool) -> None:
        """One round-deadline miss; ``overloaded`` is the watchdog's
        current degraded-state verdict."""
        self.round_deadline_misses.inc()
        self.overload.set(1 if overloaded else 0)

    def record_overload_cleared(self) -> None:
        self.overload.set(0)

    def record_flightrec_dump(self, reason: str) -> None:
        """One flight-recorder dump written (reason is the recorder's
        own bounded vocabulary, flightrec.DUMP_REASONS)."""
        self.flightrec_dumps.inc(reason=reason)

    # ---- crash safety / HA (poseidon_tpu_torch/ha/) ---------------------

    def record_checkpoint(self, nbytes: int) -> None:
        """One completed checkpoint write (writer thread; host ints —
        the registry lock is the cross-thread discipline)."""
        self.checkpoint_bytes.set(nbytes)
        self.checkpoint_age.set(0.0)

    def record_checkpoint_age(self, age_s: float) -> None:
        """Loop-thread per-round age refresh (host float)."""
        self.checkpoint_age.set(age_s)

    def record_journal_replay(self, outcome: str) -> None:
        self.journal_replays.inc(outcome=outcome)

    def record_restore(self) -> None:
        self.restores.inc()

    # ---- the quality observatory ---------------------------------------

    def record_pod_e2c(self, e2c_ms: float, lane: str) -> None:
        """One closed pod timeline. The tracker pre-folds its lanes;
        the fold here keeps the PUBLIC seam bounded for any other
        caller (module-level import — no per-call cost)."""
        self.pod_e2c.observe(e2c_ms, lane=bounded_lane(lane))

    def record_unsched_wait(
        self, p50: float, p95: float, mx: float
    ) -> None:
        """The round's standing-unscheduled wait-age quantiles (host
        floats the lifecycle tracker already computed)."""
        self.unsched_wait.set(p50, q="p50")
        self.unsched_wait.set(p95, q="p95")
        self.unsched_wait.set(mx, q="max")

    def record_lifecycle_dropped(self) -> None:
        self.lifecycle_dropped.inc()

    def record_trace_dropped(self, n: int) -> None:
        """Trace-ring overwrites since the last round (bridge-reported
        delta; zero increments are free)."""
        self.trace_dropped.inc(n)

    def record_audit(self, res) -> None:
        """One completed shadow audit (worker thread; host ints — the
        registry lock is the cross-thread discipline, the same pattern
        as record_checkpoint)."""
        self.audit_runs.inc(outcome="error" if res.error else "ok")
        self.audit_ms.set(res.audit_ms)
        if res.error:
            return
        self.audit_regret.set(res.regret)
        self.audit_drift.set(res.drift_pods)
        for sku, slots in res.frag_slots.items():
            self.audit_frag.set(slots, sku=sku)
        # a SKU class that drained out of the fleet must not keep
        # reporting its last capacity forever: zero vanished labels
        # (labelsets cannot be deleted, so 0 is the tombstone)
        for sku in self._frag_skus - set(res.frag_slots):
            self.audit_frag.set(0, sku=sku)
        self._frag_skus = set(res.frag_slots)

    def record_slo(
        self, spec: str, *, healthy: bool, burn_short: float,
        burn_long: float, value, breached: bool,
    ) -> None:
        """One objective's evaluation tick (SLO engine, loop thread;
        ``spec`` is operator-declared, bounded by construction)."""
        self.slo_healthy.set(1 if healthy else 0, slo=spec)
        self.slo_burn.set(burn_short, slo=spec, window="short")
        self.slo_burn.set(burn_long, slo=spec, window="long")
        if value is not None:
            self.slo_value.set(value, slo=spec)
        if breached:
            self.slo_breaches.inc(slo=spec)

    # ---- device telemetry ----------------------------------------------

    def record_predicted_bytes(self, nbytes: int) -> None:
        """The dense round's per-device table estimate (the
        check_table_budget math; a host int the solver already
        computed)."""
        self.device_hbm.set(nbytes, kind="predicted")

    def record_live_hbm(self, device=None) -> int | None:
        """Read the caching allocator's own stats for ``device`` (the
        solver's device) and publish bytes-in-use (a CPU device
        publishes nothing). Called from the daemon loop once per tick,
        never inside the round window: the query is allocator
        bookkeeping, not a device sync, but it has no business on the
        hot path either."""
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(dev)
        if "allocated_bytes.all.current" not in stats:
            return None
        live = int(stats["allocated_bytes.all.current"])
        self.device_hbm.set(live, kind="live")
        return live

    def record_compile(self, duration_ms: float) -> None:
        """One first-use ``nvcc`` build of the CUDA kernels
        (guards.py's compile-duration seam, fed by kernels/loader.py;
        may be called from any thread — the registry lock covers it).
        The family keeps the reference's name."""
        self.xla_compile.observe(duration_ms)

    def set_build_info(self, info: dict) -> None:
        """Publish the build-identity gauge (value 1, labels = the
        ``build_info()`` dict). Called once at daemon startup; also
        echoed in the /healthz JSON body."""
        self.build_info.set(1, **{
            k: str(v) for k, v in info.items()
        })

    # ---- express lane --------------------------------------------------

    def record_express_batch(self, e2b_ms_samples) -> None:
        """One certified express dispatch: per-placement
        event-to-bind-decision samples (already computed from
        perf-counter stamps; empty for a retire/completion-only
        batch)."""
        self.express_batches.inc()
        self.express_places.inc(len(e2b_ms_samples))
        for e2b in e2b_ms_samples:
            self.express_e2b.observe(e2b)

    def record_express_degrade(self, why: str) -> None:
        self.express_degrades.inc(why=_bounded_why(why))

    # ---- watch subsystem ----------------------------------------------

    def record_resync(self, reason: str) -> None:
        self.watch_resyncs.inc(reason=resync_reason_label(reason))

    def record_reconnect(self, resource: str, amount: int = 1) -> None:
        """``amount`` > 1 folds a stream's coalesced (queue-
        suppressed) reconnects in one increment (watch.py outage
        bounding)."""
        self.watch_reconnects.inc(
            amount, resource=resource_label(resource)
        )

    # ---- resident solver ----------------------------------------------

    def record_solver_round(
        self, fetches: int, warm: bool, express_ready: bool
    ) -> None:
        """Called by the solver at finish time: sanctioned-fetch count
        and warm-state liveness (host ints/bools it already holds)."""
        self.solver_fetches.inc(fetches, lane="round")
        self.solver_warm.set(1 if warm else 0)
        self.express_context_ready.set(1 if express_ready else 0)

    def record_express_fetch(self) -> None:
        self.solver_fetches.inc(lane="express")

    # ---- the stream lane -------------------------------------------------

    def record_stream_fetch(self) -> None:
        self.solver_fetches.inc(lane="stream")

    def record_stream_flush(
        self, windows: int, placements: int
    ) -> None:
        """One stream flush joined: K windows' placements landed on ONE
        result fetch (host ints the bridge already holds)."""
        self.stream_flushes.inc()
        self.placements_per_fetch.set(placements)

    # ---- the service lane ------------------------------------------------

    def record_service_round(
        self, tenant: str, total_ms: float, placed: int
    ) -> None:
        """One tenant round finished by the service pipeline: the
        submit-to-result latency and its placement count (``tenant`` is
        pre-bounded)."""
        self.service_rounds.inc(tenant=tenant)
        self.service_round_ms.observe(total_ms, tenant=tenant)
        self.service_placements.inc(placed)

    def record_service_dispatch(
        self, bucket: str, occupancy: int
    ) -> None:
        """One batched bucket dispatch (one upload + one batched
        fetch): its shape key and how many tenant instances rode it."""
        self.service_dispatches.inc(bucket=bucket)
        self.service_bucket_occupancy.set(occupancy, bucket=bucket)

    def record_service_compiles(self, compiles: int) -> None:
        """Kernel builds and new launch plans a service launch caused
        (0 in steady state)."""
        self.service_compiles.inc(compiles)


# express degrade reasons are free text (they embed uids/counts);
# collapse to a bounded vocabulary for the label
_WHY_BUCKETS = (
    ("unconfirmed", "unconfirmed"),
    ("domain", "domain"),
    ("uncertified", "uncertified"),
    ("change cap", "change-cap"),
    ("change_cap", "change-cap"),
    ("stream", "stream"),
    ("arrivals >", "batch-size"),
    ("rows exhausted", "rows-exhausted"),
    ("no-context", "no-context"),
    ("no warm state", "no-context"),
    ("round-in-flight", "round-in-flight"),
    ("class", "aggregation"),
    ("prefs", "prefs"),
)


def _bounded_why(why: str) -> str:
    for needle, label in _WHY_BUCKETS:
        if needle in why:
            return label
    return "vocabulary"


def build_info(mesh_width: int = 0, device=None) -> dict:
    """The build-identity labelset shared by the
    ``poseidon_build_info`` gauge and the ``/healthz`` JSON body:
    package version, torch version, CUDA version torch was built for,
    the device kind the solver runs on, and the configured mesh width.
    Called once at daemon startup, never on the hot path."""
    import torch

    import poseidon_tpu_torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        kind = torch.cuda.get_device_name(dev)
    elif dev.type == "cuda":
        kind = "none"  # no card at all
    else:
        kind = dev.type
    return {
        "package": "poseidon-tpu-torch",
        "version": poseidon_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": kind,
        "mesh_width": mesh_width,
    }
