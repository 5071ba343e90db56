"""Scheduler bridge: pod/machine state machine driving the resident solver.

The port of ``poseidon_tpu/bridge/bridge.py``: the full and pipelined
round paths, observe (poll and watch), confirm, revoke and rebalance,
the express lane (``express_batch``) and the stream lane
(``stream_window`` / ``stream_flush`` / ``stream_finish``), with the
same decisions, decision log and stats bit for bit, the flight
recorder's capture sites (``flightrec=``), the shadow auditor's sampled
capture (``auditor=``) and the warm restore (``restore_state``).
``device`` picks the solver's device (``None``
= the card); ``solver`` injects another implementation of the
begin/finish seam (the service lane's per-tenant ``TenantSolver``).

The first-party core of the reference (src/firmament/scheduler_bridge.cc)
re-expressed around ``solve_scheduling``: nodes/pods observed from the
apiserver become the ``ClusterState`` the graph builder prices, one flow
solve per round turns into placement deltas, and per-round statistics are
collected instead of dropped (the reference requests ``SchedulerStats``
and never reads it, scheduler_bridge.cc:170-172).

Deliberate fixes over the reference's semantics:

- **Restart reconcile.** The reference CHECK-crashes when it restarts and
  meets an already-Running pod it has no binding for
  (scheduler_bridge.cc:146-147, pod_to_node_map_ lookup). Here a Running
  pod observed with a node binding is adopted as state (the apiserver is
  the source of truth, SURVEY §5.4) and its machine's capacity is
  discounted.
- **Node removal.** The reference only ever adds resources
  (scheduler_bridge.cc:81-111). Here a node that disappears from a poll
  releases its machine; its Running pods flip back to Pending (they will
  be re-placed) and are logged as evictions.
- **Succeeded/Failed handling.** The reference TODO-stubs Succeeded and
  ignores Failed (scheduler_bridge.cc:151-157). Here both retire the
  task and free its slot.
- **Starvation pressure.** ``wait_rounds`` grows for every pod that a
  round leaves unscheduled, feeding the Quincy/CoCo unscheduled-cost
  terms so parked pods eventually win a slot (the aging input the
  round-2 advisor found dead, ADVICE.md item 4).
- **Mass-eviction guard.** A poll whose snapshot would remove more than
  half of the known nodes or pods is held (upserts still apply, the
  disappearances don't) until the shrink persists for
  ``SHRINK_STRIKES`` consecutive polls. A truncated list response —
  an apiserver bug, a dropped page, a mid-rollover partial cache —
  otherwise reads as mass deletion and wipes scheduler state in one
  tick. The reference trusts every snapshot blindly
  (k8s_api_client.cc:100-160).

Round pipeline: the round is split into ``begin_round`` (graph build +
cost-input prep + upload; the auction loop and the one result fetch
start at once on the solver's background worker) and ``finish_round``
(join the worker, apply placement deltas). Serial callers use
``run_scheduler`` — exactly ``finish_round(begin_round())`` — while
pipelined callers (cli.py) do next-round host work (poll parse,
observe, KnowledgeBase feed, binding POSTs of the previous round)
between the two calls, so the device's solve elapses under host work
instead of serializing after it. A worker exception surfaces in
``finish_round``. State mutations keep the serial order — observations
commute with the previous round's placement deltas (verified by the
pipelined-vs-serial equivalence test in tests/test_torch_daemon.py), and
``finish_round`` drops placements whose pod the overlap window's poll
already moved (retired, or adopted Running elsewhere) rather than
clobbering observed truth — so pipelining changes round latency, never
placements or costs.

Graph builds are O(churn), not O(cluster): every pod/machine state
transition the bridge applies is mirrored into an
``IncrementalFlowGraphBuilder`` note, and ``begin_round`` patches the
previous round's builder columns instead of re-walking every task
object (``incremental_build=False`` restores the legacy full rebuild).

Event-driven observe (the watch path, apiclient/watch.py): instead of
re-diffing a full poll snapshot every tick, callers may feed typed
``ADDED | MODIFIED | DELETED`` events through ``observe_node_event`` /
``observe_pod_event``. Both paths share the same per-entity upsert and
removal helpers, so an event drives the exact same state transitions
and incremental-builder churn notes as the poll diff would — a
watch-driven round is bit-identical to a poll-driven one over the same
event history (tests/test_torch_watch.py differential). The mass-eviction
guard is a *snapshot* defense (an explicit DELETED event is not a
truncated list), so events bypass it; a watch resync replays the full
snapshot through ``observe_nodes`` / ``observe_pods`` and gets the
guard back. Observe host time is accumulated into the next round's
``SchedulerStats.observe_ms``, and the watcher's degradation counters
land in ``watch_resyncs`` / ``watch_reconnects`` via
``note_watch_activity``.

Rebalancing (``enable_preemption=True``): running tasks enter the flow
graph with a hysteresis-discounted continuation arc and a priced
unscheduled arc (graph/builder.py rebalancing mode), and each round's
solved assignment is diffed against current placements into typed
``PLACE | MIGRATE | PREEMPT | NOOP`` deltas (graph/deltas.py) under a
per-round ``max_migrations_per_round`` churn budget. The bridge emits
the decisions (``RoundResult.migrations`` / ``.preemptions``); the
daemon loop actuates them against the apiserver (MIGRATE = eviction POST +
re-bind, PREEMPT = eviction POST) and reports back through
``confirm_migration`` / ``confirm_preemption`` / ``restore_running``,
mirroring the existing ``confirm_binding`` / ``revoke_binding``
contract for PLACE. With the flag off, behavior is byte-identical to
place-only scheduling.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time

import numpy as np

from poseidon_tpu_torch.cluster import ClusterState, Machine, Task, TaskPhase
from poseidon_tpu_torch.graph.builder import (
    FlowGraphBuilder,
    IncrementalFlowGraphBuilder,
)
from poseidon_tpu_torch.graph.deltas import extract_deltas
from poseidon_tpu_torch.models.knowledge import (
    KnowledgeBase,
    MachineSample,
    TaskSample,
)
from poseidon_tpu_torch.guards import FetchTimeout
from poseidon_tpu_torch.ops.resident import (
    ExpressArrival,
    ExpressBatch,
    ExpressDegrade,
    InflightSolve,
    ResidentSolver,
)
from poseidon_tpu_torch.obs.metrics import STORM_RESYNCS, STORM_WINDOW
from poseidon_tpu_torch.obs.spans import (
    emit_span,
    express_span_tree,
    stream_span_tree,
    round_span_tree,
)
from poseidon_tpu_torch.ops.transport import topology_from_columns
from poseidon_tpu_torch.trace import TraceGenerator

log = logging.getLogger(__name__)

# Mass-eviction guard: hold a >50% disappearance (of at least
# SHRINK_MIN_KNOWN known entities) unless it repeats this many polls.
SHRINK_STRIKES = 3
SHRINK_MIN_KNOWN = 8
# The guard's time-based exit (the NotReady grace window): a held
# shrink that persists this many seconds is accepted as true death
# even before SHRINK_STRIKES polls land — watch-mode daemons resync
# rarely, so a purely poll-counted guard could hold a real rack loss
# for as long as the streams stay healthy. 0 disables the time exit.
SHRINK_GRACE_S = 45.0


@dataclasses.dataclass
class SchedulerStats:
    """Per-round statistics (the reference collects these and drops
    them; here they are the observability surface, SURVEY §5.1/§5.5).

    ``total_ms`` is the round's HOST critical path: time spent inside
    ``begin_round`` plus time spent inside ``finish_round`` — for a
    serial round that is the whole round, for a pipelined round it
    excludes the overlap window where the host was doing other work.
    The overlap-model companions: ``build_mode`` ("delta" | "full" |
    "legacy"), ``dispatch_ms`` (prep + upload + async dispatch inside
    the solver), ``fetch_wait_ms`` (the part of the placement download
    the host actually blocked on — the sync floor minus whatever the
    overlap already absorbed), ``overlap_ms`` (wall time between
    begin and finish, i.e. how much host work was hidden), and
    ``wall_ms`` (begin start to finish end, the round's wall span).
    """

    round_num: int = 0
    pods_total: int = 0
    pods_pending: int = 0
    pods_placed: int = 0
    pods_unscheduled: int = 0
    evictions: int = 0
    # rebalancing delta counts (graph/deltas.py vocabulary; all zero in
    # place-only mode except deltas_place == pods_placed)
    deltas_place: int = 0
    deltas_migrate: int = 0
    deltas_preempt: int = 0
    deltas_noop: int = 0
    deltas_deferred: int = 0
    # placement/migration POSTs the daemon loop reported failed since the
    # previous round (the pods were re-queued, not silently believed
    # placed). During a declared apiserver outage, unreachable POSTs
    # park in the actuation outbox instead (ha/outbox.py) and do NOT
    # count here until they dead-letter — so an outage reads as one
    # episode, not a failure per pod per round.
    bind_failures: int = 0
    # staged node-death re-queue (the mass-eviction guard's exit):
    # displaced RUNNING pods admitted into this round's schedulable
    # set, and the backlog still parked awaiting a later wave
    requeue_admitted: int = 0
    displaced_parked: int = 0
    # actuations parked in the daemon loop's outbox when this round was
    # logged (cli stamps it; 0 without an outbox) — the chaos
    # harness's time-to-recovered clock includes the drain
    outbox_pending: int = 0
    # watch-mode degradation counters since the previous round: full
    # LIST resyncs (410 Gone / decode error / staleness) and error-path
    # stream reconnects (apiclient/watch.py; zero in poll mode)
    watch_resyncs: int = 0
    watch_reconnects: int = 0
    # pipelined placement fetches that missed their
    # --max_solver_runtime deadline since the previous round (each one
    # abandoned its round loudly: FETCH_TIMEOUT trace event + this)
    fetch_timeouts: int = 0
    # lifetime count of dense-lane degrades to the CPU oracle
    # (memory-envelope / cost-domain / uncertified — NOT the deliberate
    # small-instance routing); each one also emits a DEGRADE trace
    # event, so oversize rounds are observable, not just logged
    degrades_total: int = 0
    # express-lane activity: batches dispatched, pods placed between
    # ticks, batches that degraded to the round path (EXPRESS_DEGRADE),
    # and the event-to-bind-decision latency accumulator's p50/p99
    # over the window (ms) — all counted since the previous round —
    # plus the express placements THIS round's correction pass moved
    # (EXPRESS_CORRECTED, counted by the round that corrects them)
    express_batches: int = 0
    express_places: int = 0
    express_corrected: int = 0
    express_degrades: int = 0
    express_e2b_p50_ms: float = 0.0
    express_e2b_p99_ms: float = 0.0
    cost: int = 0
    backend: str = ""
    # which daemon loop lane produced this round (set by the daemon loop via
    # ``SchedulerBridge.lane``: poll / watch / +pipelined / express /
    # +sharded / +agg compositions) — the metrics/report grouping key
    lane: str = ""
    # host time spent in observe_* (poll snapshot diff or watch event
    # application) since the previous round — the observe phase the
    # per-phase timers were missing (build/price/solve/decompose never
    # covered the snapshot walk)
    observe_ms: float = 0.0
    build_ms: float = 0.0
    price_ms: float = 0.0
    solve_ms: float = 0.0
    decompose_ms: float = 0.0
    total_ms: float = 0.0
    build_mode: str = ""
    dispatch_ms: float = 0.0
    fetch_wait_ms: float = 0.0
    overlap_ms: float = 0.0
    wall_ms: float = 0.0


@dataclasses.dataclass
class RoundResult:
    """One scheduling round's output: deltas to actuate + stats."""

    bindings: dict[str, str]          # pod uid -> machine name (new PLACEs)
    stats: SchedulerStats
    unscheduled: list[str]            # pods left pending this round
    # rebalancing decisions (empty in place-only mode): the daemon loop
    # actuates these against the apiserver and confirms back
    migrations: dict[str, tuple[str, str]] = dataclasses.field(
        default_factory=dict)         # uid -> (from_machine, to_machine)
    preemptions: dict[str, str] = dataclasses.field(
        default_factory=dict)         # uid -> from_machine


@dataclasses.dataclass
class ExpressResult:
    """One express batch's actuatable output (the fast-path analog of
    ``RoundResult``): bindings to POST now, plus the batch's exact cost
    and repair-round count for observability. Stats ride on the NEXT
    full round's ``SchedulerStats`` (express counters + the
    event-to-bind accumulator)."""

    bindings: dict[str, str]
    cost: int = 0
    rounds: int = 0
    latency_ms: float = 0.0
    timings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class InflightRound:
    """A begun-but-not-finished scheduling round (solve in flight)."""

    stats: SchedulerStats
    result: RoundResult | None = None   # set when the round completed
                                        # synchronously (nothing to do)
    solve: InflightSolve | None = None
    meta: object = None                 # GraphMeta of this round's build
    t_begin_start: float = 0.0
    t_begin_end: float = 0.0
    begin_ms: float = 0.0
    # the flight recorder's begin-time record of this round's inputs
    # (obs/flightrec.py); finish_round attaches the outcome to it
    flight: object = None


class SchedulerBridge:
    """Owns cluster state across rounds and runs the scheduling loop."""

    def __init__(
        self,
        cost_model: str = "quincy",
        *,
        max_tasks_per_machine: int = 10,
        sample_queue_size: int = 100,
        trace: TraceGenerator | None = None,
        solver_timeout_s: float = 1000.0,
        small_to_oracle: bool = True,
        incremental_build: bool = True,
        enable_preemption: bool = False,
        migration_hysteresis: int = 20,
        max_migrations_per_round: int = 64,
        mesh_width: int = 0,
        aggregate_classes: bool = False,
        topk_prefs: int = 0,
        mesh_devices=None,
        express_lane: bool = False,
        express_max_batch: int = 16,
        stream_windows: int = 0,
        shrink_grace_s: float = SHRINK_GRACE_S,
        metrics=None,
        profile_spans: bool = False,
        solver=None,
        flightrec=None,
        lifecycle=None,
        auditor=None,
        device=None,
    ):
        self.cost_model = cost_model
        self.max_tasks_per_machine = max_tasks_per_machine
        self.enable_preemption = enable_preemption
        self.migration_hysteresis = migration_hysteresis
        self.max_migrations_per_round = max_migrations_per_round
        self.express_lane = express_lane
        self.stream_windows = stream_windows
        self.trace = trace or TraceGenerator()
        # observability: ``metrics`` is an obs.SchedulerMetrics (or
        # None); recording happens ONLY at finish/actuate time from
        # host values this class already holds — no new device syncs
        # (the recording helpers are PTA001/PTA002 scopes).
        # ``profile_spans`` emits a SPAN trace event per round/express
        # batch (--trace_profile); ``lane`` is a loop-set label
        # (poll / watch / +pipelined / express ...) stamped onto each
        # round's stats for the metrics/report grouping.
        self.metrics = metrics
        self.profile_spans = profile_spans
        # the anomaly flight recorder (obs/flightrec.py, --flight_
        # recorder): captures each round's full host-side inputs at
        # begin time and dumps the ring on DEGRADE / EXPRESS_DEGRADE /
        # FETCH_TIMEOUT / resync-storm or on demand. None = off, zero
        # cost.
        self.flightrec = flightrec
        # the quality observatory (obs/lifecycle.py, obs/audit.py):
        # ``lifecycle`` stamps per-pod timelines at every stage the
        # bridge drives (event/decided/confirmed — the cli stamps the
        # journal/POST stages it owns); ``auditor`` captures a sampled
        # cluster snapshot per cadence for the background shadow
        # re-solve. Both None = off, zero cost.
        self.lifecycle = lifecycle
        self.auditor = auditor
        # the watch stream position recorded with each round's flight
        # record (loop-set: the cli stamps ClusterWatcher.applied_rv
        # per tick; "" = poll mode)
        self.flight_rv = ""
        # trace-ring overwrites already mirrored into the metrics
        # counter (per-round delta against trace.dropped_total)
        self._trace_drops_seen = 0
        self.lane = ""
        self.knowledge = KnowledgeBase(queue_size=sample_queue_size)
        self.machines: dict[str, Machine] = {}
        self.tasks: dict[str, Task] = {}
        self.pod_to_machine: dict[str, str] = {}
        self.round_num = 0
        # device-resident solve chain; its warm DenseState lives on the
        # device across rounds (the reference's --run_incremental_scheduler
        # seam). The scale lane rides here too: mesh_width lays the
        # round's task axis out over a device mesh (mesh_devices lists
        # its devices, which may repeat), aggregate_classes/topk_prefs
        # shrink the machine/pref axes (graph/aggregate.py).
        # ``solver`` injects a different implementation of the same
        # begin/finish seam — the multi-tenant service routes every
        # tenant bridge through a shared batching dispatcher this way
        # (service/dispatch.TenantSolver); None = own ResidentSolver.
        self.solver = solver if solver is not None else ResidentSolver(
            device=device,
            oracle_timeout_s=solver_timeout_s,
            small_to_oracle=small_to_oracle,
            mesh_width=mesh_width,
            aggregate_classes=aggregate_classes,
            topk_prefs=topk_prefs,
            mesh_devices=mesh_devices,
            express_lane=express_lane,
            express_max_batch=express_max_batch,
            stream_windows=stream_windows,
            metrics=metrics,
        )
        if flightrec is not None and flightrec.device is None:
            # the recorder names the device its rounds were solved on
            # in each dump's manifest
            flightrec.device = getattr(self.solver, "device", None)
        # O(churn) graph maintenance: every state transition below is
        # mirrored as a note; begin_round patches instead of rebuilding
        self.incremental_build = incremental_build
        self._graph = (
            IncrementalFlowGraphBuilder(
                preemption=enable_preemption,
                migration_hysteresis=migration_hysteresis,
            )
            if incremental_build else None
        )
        # bounded: a daemon running forever must not grow without bound
        # (full history goes to the trace stream when a sink is set).
        # Entries are (round_num, kind, uid, detail) where detail is
        # the machine (PLACE), "from->to" (MIGRATE), or the evicted-
        # from machine (PREEMPT).
        self.decision_log: collections.deque[
            tuple[int, str, str, str]
        ] = collections.deque(maxlen=100_000)
        self._evictions_this_round = 0
        self._bind_failures = 0
        self._fetch_timeouts = 0
        self._degrades_total = 0
        # per-round accumulators surfaced in SchedulerStats: observe
        # host time and watch degradation counts since the last round
        self._observe_ms = 0.0
        self._watch_resyncs = 0
        self._watch_reconnects = 0
        # consecutive implausible-shrink polls (mass-eviction guard),
        # plus the monotonic stamp of each hold's first strike (the
        # NotReady grace window's clock; 0.0 = not holding)
        self._node_shrink_strikes = 0
        self._pod_shrink_strikes = 0
        self._node_shrink_strikes_first = 0.0
        self._pod_shrink_strikes_first = 0.0
        self.shrink_grace_s = shrink_grace_s
        # staged re-queue of node-death displacement: RUNNING pods on
        # a dead node flip to Pending but only ``max_migrations_per_
        # round`` of them become SCHEDULABLE per round — the rest park
        # here (ordered, FIFO admission at begin_round) so a rack loss
        # drains as bounded waves, not one migration-storm round.
        # Parked pods stay in self.tasks (state truth) but are
        # excluded from cluster_state()/the graph until admitted.
        self._displaced_parked: dict[str, None] = {}
        self._requeue_budget_left: int | None = (
            max_migrations_per_round
            if max_migrations_per_round > 0 else None
        )  # None = unlimited; refreshed every begin_round
        # resync-storm trip for the flight recorder: a sliding window
        # of per-round resync counts (the obs/metrics.py storm gauge's
        # twin), latched so a persisting storm dumps once, not every
        # round
        self._resync_window: collections.deque[int] = collections.deque(
            maxlen=STORM_WINDOW
        )
        self._storm_dumped = False
        self._inflight: InflightRound | None = None
        # ---- express-lane bookkeeping (all empty with the flag off) ----
        # bound pods whose device rows the next express dispatch
        # retires (uid, machine); cleared when a round replaces the
        # context
        self._express_retire: list[tuple[str, str]] = []
        # express placements awaiting the caller's confirm_binding — a
        # second batch before confirmation would re-solve rows whose
        # POST is already on the wire, so express refuses until drained
        self._express_unconfirmed: set[str] = set()
        # placements since the last full round, for the correction
        # pass's differential verify (uid -> machine)
        self._express_placed: dict[str, str] = {}
        # per-round-window counters + the event-to-bind accumulator
        self._express_batches = 0
        self._express_places = 0
        self._express_degrades = 0
        self._express_e2b: list[float] = []
        # ---- stream-lane bookkeeping (--stream_windows K) ----
        # per-uid watch receipt stamps of the windows accumulated since
        # the last flush/finish: each stream placement's e2b is ITS
        # latency measured at finish time, spanning the whole K-window
        # accumulation
        self._stream_uid_t: dict[str, float] = {}
        self._stream_t0: float | None = None
        self._stream_flushes = 0

    def _guard_release(self, kind: str, outcome: str, *,
                       gone: int = 0, known: int = 0,
                       strikes: int = 0, held_s: float = 0.0) -> None:
        """One guard release: trace event + metrics (outcome is
        "accepted" — the shrink was honored as true death — or
        "recovered" — the snapshot healed before the bound)."""
        self.trace.emit(
            "EVICTION_GUARD_RELEASE", round_num=self.round_num,
            detail={"kind": kind, "outcome": outcome, "gone": gone,
                    "known": known, "strikes": strikes,
                    "held_s": round(held_s, 3)},
        )
        if self.metrics is not None:
            self.metrics.record_guard_release(kind, outcome)

    def _hold_shrink(self, counter: str, kind: str, known: int,
                     gone: int) -> bool:
        """Mass-eviction guard: True = hold this poll's disappearances.

        ``known`` is the entity count BEFORE the poll's upserts — a
        truncated snapshot that also carries new names must not inflate
        the denominator and slip past the threshold.

        Two exits (both loud — EVICTION_GUARD_RELEASE + metrics):
        the shrink persists ``SHRINK_STRIKES`` consecutive polls, or
        it persists past the ``shrink_grace_s`` NotReady grace window
        (``--node_grace_s``) — after either, the disappearances are
        accepted as TRUE death and the displaced RUNNING pods drain
        through the staged-requeue budget instead of one storm round.
        A snapshot that heals mid-hold releases with
        ``outcome="recovered"`` and nothing is evicted.
        """
        first_attr = counter + "_first"
        if known < SHRINK_MIN_KNOWN or gone * 2 <= known:
            if getattr(self, counter):
                # the hold healed: the disappearance was transient
                self._guard_release(
                    kind, "recovered", gone=gone, known=known,
                    strikes=getattr(self, counter),
                    held_s=time.monotonic() - getattr(self, first_attr),
                )
            setattr(self, counter, 0)
            setattr(self, first_attr, 0.0)
            return False
        strikes = getattr(self, counter) + 1
        setattr(self, counter, strikes)
        now = time.monotonic()
        if strikes == 1:
            setattr(self, first_attr, now)
        held_s = now - getattr(self, first_attr)
        grace_hit = (
            self.shrink_grace_s > 0 and held_s >= self.shrink_grace_s
        )
        if strikes < SHRINK_STRIKES and not grace_hit:
            log.warning(
                "%s snapshot lost %d of %d known; holding (strike "
                "%d/%d, held %.1fs of %.1fs grace) — truncated list "
                "response?",
                kind, gone, known, strikes, SHRINK_STRIKES, held_s,
                self.shrink_grace_s,
            )
            self.trace.emit(
                "EVICTION_GUARD_HOLD", round_num=self.round_num,
                detail={"kind": kind, "gone": gone, "known": known,
                        "strike": strikes,
                        "held_s": round(held_s, 3)},
            )
            if self.metrics is not None:
                self.metrics.record_guard_hold(kind)
            return True
        log.warning(
            "%s shrink persisted (%d polls, %.1fs); accepting it as "
            "true death", kind, strikes, held_s,
        )
        self._guard_release(
            kind, "accepted", gone=gone, known=known,
            strikes=strikes, held_s=held_s,
        )
        setattr(self, counter, 0)
        setattr(self, first_attr, 0.0)
        return False

    # ---- observation (the poll side) -----------------------------------

    def _upsert_node(self, node: Machine) -> str:
        """One node's upsert: state, churn notes, knowledge sample.
        Shared by the poll snapshot diff and the watch event path so
        both drive identical transitions. Returns the node name."""
        g = self._graph
        if node.max_tasks <= 0:
            node = dataclasses.replace(
                node, max_tasks=self.max_tasks_per_machine
            )
        prev = self.machines.get(node.name)
        if prev is None:
            log.info("new node %s (rack=%s)", node.name, node.rack)
            if g:
                g.note_full_rebuild("node added")
        elif g and (prev.rack != node.rack
                    or prev.max_tasks != node.max_tasks):
            # graph-shaping attributes changed under us
            g.note_full_rebuild("node reshaped")
        self.machines[node.name] = node
        cap = max(node.cpu_capacity, 1e-9)
        mem_cap = max(node.memory_capacity_kb, 1)
        self.knowledge.add_machine_sample(
            node.name,
            MachineSample(
                cpu_idle=min(node.cpu_allocatable / cap, 1.0),
                mem_free_frac=min(
                    node.memory_allocatable_kb / mem_cap, 1.0
                ),
            ),
        )
        return node.name

    def _requeue_take(self) -> bool:
        """Consume one unit of the per-round staged-requeue budget
        (True = schedulable now, False = park for a later wave)."""
        if self._requeue_budget_left is None:
            return True
        if self._requeue_budget_left > 0:
            self._requeue_budget_left -= 1
            return True
        return False

    def _remove_node(self, name: str) -> None:
        """Release a machine: its Running tasks flip back to Pending
        (they will be re-placed) and are logged as evictions.

        Displacement is budget-staged: every displaced pod parks in
        ``_displaced_parked`` and re-enters the schedulable set in
        FIFO waves of at most ``max_migrations_per_round`` per
        ``begin_round`` (shared across every node death — a rack loss
        via N watch DELETED events drains exactly like one mass poll
        shrink). Observe precedes begin in the tick, so a small
        removal's pods are admitted the SAME tick they were displaced
        — behavior is unchanged below the budget; above it, the storm
        drains as bounded waves instead of one re-placement storm.
        State truth is immediate (the pod IS Pending, the machine IS
        gone); only the *re-placement rate* is bounded."""
        if name not in self.machines:
            return
        log.warning("node %s removed; evicting its tasks", name)
        if self._graph:
            self._graph.note_full_rebuild("node removed")
        del self.machines[name]
        self.knowledge.retire_machine(name)
        for uid, task in list(self.tasks.items()):
            if task.machine == name:
                self.tasks[uid] = dataclasses.replace(
                    task, phase=TaskPhase.PENDING, machine=""
                )
                self.pod_to_machine.pop(uid, None)
                self._displaced_parked[uid] = None
                self.trace.emit("EVICT", task=uid, machine=name,
                                round_num=self.round_num,
                                detail={"parked": True})
                self._evictions_this_round += 1

    def observe_nodes(self, nodes: list[Machine]) -> None:
        """Upsert machines; release the ones that disappeared."""
        t0 = time.perf_counter()
        # a snapshot diff can move anything (and node changes reshape
        # the machine axis): the device express context cannot follow
        if self.express_lane:
            self.solver.invalidate_express()
        try:
            known_before = len(self.machines)
            known_names = set(self.machines)
            seen = set()
            for node in nodes:
                seen.add(self._upsert_node(node))
            gone = known_names - seen
            if self._hold_shrink(
                "_node_shrink_strikes", "node", known_before, len(gone)
            ):
                return
            for name in gone:
                self._remove_node(name)
        finally:
            self._observe_ms += (time.perf_counter() - t0) * 1000

    def observe_node_event(
        self, type_: str, node: Machine
    ) -> None:
        """Event-driven observe: one typed node event from the watch
        stream (ADDED | MODIFIED upsert, DELETED release). Drives the
        same transitions and churn notes as the poll diff; an explicit
        DELETED bypasses the mass-eviction guard on purpose — the guard
        defends against *truncated snapshots*, and an event stream
        never infers deletion from absence (resyncs go back through
        ``observe_nodes`` and get the guard)."""
        t0 = time.perf_counter()
        if self.express_lane:
            self.solver.invalidate_express()
        try:
            if type_ == "DELETED":
                self._remove_node(node.name)
            else:
                self._upsert_node(node)
        finally:
            self._observe_ms += (time.perf_counter() - t0) * 1000

    def _pending_reobserved(
        self, known: Task, pod: Task, stored: Task
    ) -> None:
        """Graph notes for a pending pod re-observed as pending (the
        stored object is swapped; only cpu/mem changes are patchable —
        job/pref reshapes change arc structure mid-order)."""
        g = self._graph
        if not g:
            return
        if pod.uid in self._displaced_parked:
            # parked displacement: the builder never saw this task
            # (cluster_state excludes it), so no targeted note can
            # apply — the admitted task carries its current shape
            return
        if known.job != pod.job or not (
            known.data_prefs is pod.data_prefs
            or known.data_prefs == pod.data_prefs
        ):
            g.note_full_rebuild("pending pod reshaped")
        elif (known.cpu_request != pod.cpu_request
              or known.memory_request_kb != pod.memory_request_kb):
            g.note_task_updated(stored)

    def _upsert_pod(self, pod: Task) -> str:
        """One pod's state-machine dispatch (the reference's per-pod
        switch, scheduler_bridge.cc:132-162). Shared by the poll
        snapshot diff and the watch event path so both drive identical
        transitions and churn notes. Returns the uid."""
        g = self._graph
        known = self.tasks.get(pod.uid)
        if pod.phase == TaskPhase.PENDING:
            if known is None:
                log.info("new pending pod %s", pod.uid)
                self.trace.emit("SUBMIT", task=pod.uid,
                                round_num=self.round_num)
                if self.lifecycle is not None:
                    # timeline zero: first sight of schedulable work
                    # (the express path backdates to the watch
                    # dequeue stamp when the daemon loop has one)
                    self.lifecycle.stamp_event(pod.uid)
                self.tasks[pod.uid] = pod
                if g:
                    g.note_task_added(pod)
            elif (
                known.phase == TaskPhase.RUNNING and known.machine
            ):
                # a locally-confirmed binding outlives apiserver
                # poll latency: the pod still reads Pending until
                # the watch cache catches up, and downgrading here
                # would re-schedule it (double-binding + the slot
                # discount lost)
                pass
            else:
                # keep our aging counter across polls
                stored = dataclasses.replace(
                    pod, wait_rounds=known.wait_rounds
                )
                if known.phase != TaskPhase.PENDING:
                    if g:
                        g.note_full_rebuild("pod re-entered pending")
                else:
                    self._pending_reobserved(known, pod, stored)
                self.tasks[pod.uid] = stored
        elif pod.phase == TaskPhase.RUNNING:
            if pod.machine and pod.machine not in self.machines:
                # The apiserver still reports a binding to a node we
                # no longer know (removed in observe_nodes). Adopting
                # it would silently undo the eviction and park the
                # pod on a ghost machine forever; keep it Pending
                # (aging preserved) so the next round re-places it.
                log.warning(
                    "pod %s bound to unknown node %s; keeping it "
                    "Pending for re-placement", pod.uid, pod.machine,
                )
                wait = known.wait_rounds if known is not None else 0
                stored = dataclasses.replace(
                    pod, phase=TaskPhase.PENDING, machine="",
                    wait_rounds=wait,
                )
                if known is None:
                    if g:
                        g.note_task_added(stored)
                elif known.phase == TaskPhase.PENDING:
                    self._pending_reobserved(known, pod, stored)
                elif g:
                    g.note_full_rebuild("pod re-entered pending")
                self.tasks[pod.uid] = stored
                self.pod_to_machine.pop(pod.uid, None)
                return pod.uid
            if known is None or known.machine != pod.machine:
                # restart reconcile: adopt the apiserver's binding
                # instead of the reference's CHECK-crash
                # (scheduler_bridge.cc:146-147)
                log.info(
                    "adopting running pod %s on %s",
                    pod.uid, pod.machine,
                )
            # the poll carries no aging (wait_rounds is bridge-
            # internal): preserve it so a later preemption parks
            # the pod with its starvation pressure intact
            stored = (
                dataclasses.replace(
                    pod, wait_rounds=known.wait_rounds
                )
                if known is not None else pod
            )
            if pod.uid in self._displaced_parked:
                # a parked displacement adopted Running on a live
                # machine (external writer / node resurrection):
                # unpark; the builder never saw the parked task, so
                # targeted notes below cannot apply — one full
                # rebuild covers the transition
                del self._displaced_parked[pod.uid]
                if g:
                    g.note_full_rebuild("parked pod adopted running")
                g = None
            if g:
                if known is not None and known.phase == TaskPhase.PENDING:
                    g.note_task_removed(pod.uid)
                was_on = (
                    known.machine
                    if known is not None
                    and known.phase == TaskPhase.RUNNING else ""
                )
                if self.enable_preemption:
                    self._running_reobserved(
                        known, pod, stored, was_on
                    )
                elif was_on != pod.machine:
                    if was_on and was_on in self.machines:
                        g.note_slots_changed(was_on, -1)
                    if pod.machine:
                        g.note_slots_changed(pod.machine, +1)
            self.tasks[pod.uid] = stored
            if pod.machine:
                self.pod_to_machine[pod.uid] = pod.machine
            self.knowledge.add_task_sample(
                pod.uid,
                TaskSample(
                    cpu_usage=pod.cpu_request,
                    mem_usage_kb=pod.memory_request_kb,
                ),
            )
        else:  # Succeeded / Failed / Unknown: retire, free the slot
            if known is not None:
                log.info("retiring pod %s (%s)", pod.uid, pod.phase)
                self.trace.emit("FINISH", task=pod.uid,
                                machine=known.machine,
                                round_num=self.round_num,
                                detail={"phase": str(pod.phase.value)})
                self._retire_notes(known)
                self.tasks.pop(pod.uid, None)
                self.pod_to_machine.pop(pod.uid, None)
                self.knowledge.retire_task(pod.uid)
                if self.lifecycle is not None:
                    self.lifecycle.drop(pod.uid)
        return pod.uid

    def _remove_pod(self, uid: str) -> None:
        """A pod left the cluster without a terminal phase (poll: gone
        from the snapshot; watch: an explicit DELETED event): retire it
        silently — no FINISH event, matching the poll diff."""
        task = self.tasks.pop(uid, None)
        if task is not None:
            self._retire_notes(task)
        self.pod_to_machine.pop(uid, None)
        self.knowledge.retire_task(uid)
        if self.lifecycle is not None:
            self.lifecycle.drop(uid)

    def observe_pods(self, pods: list[Task]) -> None:
        """The reference's per-pod dispatch (scheduler_bridge.cc:132-162),
        with restart reconcile and terminal-state retirement."""
        t0 = time.perf_counter()
        if self.express_lane:
            self.solver.invalidate_express()
        try:
            known_before = len(self.tasks)
            known_uids = set(self.tasks)
            seen = set()
            for pod in pods:
                seen.add(self._upsert_pod(pod))
            gone = known_uids - seen
            if self._hold_shrink(
                "_pod_shrink_strikes", "pod", known_before, len(gone)
            ):
                return
            for uid in gone:
                self._remove_pod(uid)
        finally:
            self._observe_ms += (time.perf_counter() - t0) * 1000

    def observe_pod_event(self, type_: str, pod: Task) -> None:
        """Event-driven observe: one typed pod event from the watch
        stream. ADDED | MODIFIED run the normal per-pod dispatch
        (which already handles every phase, including terminal ones);
        DELETED retires the pod like a poll disappearance. Explicit
        deletions bypass the mass-eviction guard by design — see
        ``observe_node_event``."""
        t0 = time.perf_counter()
        try:
            if type_ == "DELETED":
                self._remove_pod(pod.uid)
            else:
                self._upsert_pod(pod)
        finally:
            self._observe_ms += (time.perf_counter() - t0) * 1000

    def note_watch_activity(
        self, resyncs: int = 0, reconnects: int = 0
    ) -> None:
        """Caller reports the watcher's degradation counts for this
        tick; they surface in the next round's ``SchedulerStats``."""
        self._watch_resyncs += resyncs
        self._watch_reconnects += reconnects

    def _note_trace_drops(self) -> None:
        """Mirror the trace ring's overwrite count into the metrics
        counter (per-round delta; zero increments are free)."""
        drops = self.trace.dropped_total
        if drops != self._trace_drops_seen:
            self.metrics.record_trace_dropped(
                drops - self._trace_drops_seen
            )
            self._trace_drops_seen = drops

    def flight_dump(
        self, reason: str = "manual", label: str = ""
    ) -> str | None:
        """Dump the flight-recorder ring (anomaly sites call this with
        their bounded reason; operators and the daemon call it on
        demand).
        Returns the manifest path, or None when the recorder is off or
        the ring is empty. Every dump is loud: a FLIGHTREC_DUMP trace
        event plus ``poseidon_flightrec_dumps_total{reason}``."""
        if self.flightrec is None:
            return None
        path = self.flightrec.dump(reason, label=label)
        if path is not None:
            self.trace.emit(
                "FLIGHTREC_DUMP", round_num=self.round_num,
                detail={"reason": reason, "label": label,
                        "path": path},
            )
            self.trace.flush()
        return path

    # ---- the express lane (between-ticks fast path) --------------------

    def _express_invalidate(self, count_degrade: bool = False,
                            why: str = "") -> None:
        if self.solver.express_ready:
            self.solver.invalidate_express()
            if count_degrade:
                self._express_degrades += 1
                self.trace.emit(
                    "EXPRESS_DEGRADE", round_num=self.round_num,
                    detail={"why": why},
                )
                self.trace.flush()
                if self.metrics is not None:
                    self.metrics.record_express_degrade(why)
                self.flight_dump("express-degrade", label=why)

    def _express_transitions(
        self, before: dict[str, Task | None]
    ) -> tuple[list[Task], list[str], list[tuple[str, int]]]:
        """Net per-uid effect of one applied event batch: arrivals,
        pending removals, and slot restores. Duplicate watch events for
        one uid (stream replays) coalesce here BY CONSTRUCTION — the
        diff is before-state vs after-state, so a double ADDED or an
        ADDED+DELETED pair within one batch can never double-apply at
        the device patch. Raises ``ValueError`` (caught by the caller
        into a degrade) for any transition outside the express
        vocabulary."""
        arrivals: list[Task] = []
        removals: list[str] = []
        slot_deltas: list[tuple[str, int]] = []
        for uid, b in before.items():
            a = self.tasks.get(uid)
            if b is None and a is None:
                continue  # arrived and left inside the batch: net noop
            if b is None:
                if a.phase == TaskPhase.PENDING:
                    arrivals.append(a)
                else:
                    raise ValueError(
                        f"{uid} entered as {a.phase.value} (adoption)"
                    )
            elif a is None:
                if b.phase == TaskPhase.PENDING:
                    removals.append(uid)
                elif b.phase == TaskPhase.RUNNING and b.machine:
                    slot_deltas.append((b.machine, +1))
                else:
                    raise ValueError(
                        f"{uid} left from phase {b.phase.value}"
                    )
            elif (b.phase == TaskPhase.PENDING
                  and a.phase == TaskPhase.PENDING):
                if (b.cpu_request != a.cpu_request
                        or b.memory_request_kb != a.memory_request_kb
                        or b.job != a.job
                        or b.data_prefs != a.data_prefs):
                    raise ValueError(f"{uid} reshaped while pending")
                # identical re-observation (replayed event): noop
            elif (b.phase == TaskPhase.RUNNING
                  and a.phase == TaskPhase.RUNNING):
                if b.machine != a.machine:
                    raise ValueError(f"{uid} moved machines externally")
            else:
                raise ValueError(
                    f"{uid} transitioned {b.phase.value} -> "
                    f"{a.phase.value}"
                )
        return arrivals, removals, slot_deltas

    def express_batch(
        self,
        pod_events: list[tuple[str, Task]],
        *,
        t_event: float | None = None,
        t_events: list[float] | None = None,
    ) -> ExpressResult | None:
        """The express fast path: apply a small watch-event batch and —
        when the device context can represent its net effect — turn it
        into bindings NOW, without waiting for the round tick.

        The events are ALWAYS applied to bridge state (via the same
        ``observe_pod_event`` transitions and incremental-builder notes
        as the tick path, so the periodic correction round sees an
        identical graph). Returns ``None`` when the express lane is
        off, no warm context exists, or the batch degrades — the pods
        then simply wait for the next full round. ``t_event`` (a
        ``perf_counter`` stamp of the earliest event's receipt) feeds
        the event-to-bind latency accumulator; ``t_events`` (parallel
        to ``pod_events``, watch ``ExpressEvents.t_events``) gives each
        placement a real per-event sample — without it every placement
        reports the batch latency measured from ``t_event``.
        """
        t0 = time.perf_counter()
        before: dict[str, Task | None] = {}
        for _typ, pod in pod_events:
            if pod.uid not in before:
                before[pod.uid] = self.tasks.get(pod.uid)
        for typ, pod in pod_events:
            self.observe_pod_event(typ, pod)
        if self.lifecycle is not None and t_events is not None:
            # per-event watch receipt stamps precede the observe that
            # minted the timelines: backdate (earliest wins)
            for (_typ, pod), ts in zip(pod_events, t_events):
                self.lifecycle.backdate_event(pod.uid, ts)
        if not self.express_lane:
            return None
        if not self.solver.express_ready or self._inflight is not None:
            # no warm context (or a round owns the device): the events
            # wait for the round path; nothing to invalidate beyond
            # what observe already did
            self.solver.invalidate_express()
            return None
        if self._express_unconfirmed:
            # a prior batch's placements were never confirmed: their
            # rows are still live on device and a re-solve could move
            # pods whose POSTs are on the wire
            self._express_invalidate(
                count_degrade=True, why="unconfirmed placements"
            )
            return None
        try:
            arrivals, removals, slot_deltas = (
                self._express_transitions(before)
            )
        except ValueError as e:
            self._express_invalidate(count_degrade=True, why=str(e))
            return None
        if not (arrivals or removals or slot_deltas
                or self._express_retire):
            return None  # pure replay noise: nothing to do
        try:
            maps = self.solver.express_maps()
        except ExpressDegrade as e:
            self._express_invalidate(count_degrade=True, why=str(e))
            return None
        if maps is None:
            return None
        midx, rack_idx = maps
        builder = (
            self._graph.builder if self._graph is not None
            else FlowGraphBuilder(preemption=self.enable_preemption)
        )
        batch = ExpressBatch(
            arrivals=[
                ExpressArrival(
                    uid=t.uid,
                    wait_rounds=t.wait_rounds,
                    cpu_milli=int(t.cpu_request * 1000),
                    mem_kb=t.memory_request_kb,
                    prefs=tuple(
                        builder.task_arc_rows(t, midx, rack_idx)
                    ),
                )
                for t in arrivals
            ],
            retires=self._express_retire,
            removals=removals,
            slot_deltas=slot_deltas,
        )
        self._express_retire = []
        outcome = self.solver.express_round(batch)
        if not outcome.ok:
            self._express_degrades += 1
            self.trace.emit(
                "EXPRESS_DEGRADE", round_num=self.round_num,
                detail={"why": outcome.reason},
            )
            self.trace.flush()
            if self.metrics is not None:
                self.metrics.record_express_degrade(outcome.reason)
            if self.flightrec is not None:
                # record the degraded batch's inputs, then dump: "what
                # exactly did the express lane choke on" survives
                self.flightrec.capture_express(
                    self.round_num, batch, outcome
                )
                self.flight_dump(
                    "express-degrade", label=outcome.reason
                )
            return None
        if outcome.degrade_reason:
            # a CERTIFIED batch that degraded loudly mid-flight (the
            # change-cap overflow's full placement fetch): every
            # placement below still binds and the context stays warm —
            # trace + count the degrade WITHOUT invalidating
            self._express_degrades += 1
            self.trace.emit(
                "EXPRESS_DEGRADE", round_num=self.round_num,
                detail={"why": outcome.degrade_reason},
            )
            if self.metrics is not None:
                self.metrics.record_express_degrade(
                    outcome.degrade_reason
                )
        self._express_batches += 1
        bindings: dict[str, str] = {}
        t_done = time.perf_counter()
        latency = (t_done - (t_event if t_event is not None else t0)) \
            * 1000
        # per-uid receipt stamps (earliest wins across coalesced
        # duplicates) so each placement's e2b is ITS latency, not the
        # batch's replicated onto every event
        uid_t: dict[str, float] = {}
        if t_events is not None:
            for (_typ, pod), ts in zip(pod_events, t_events):
                uid_t.setdefault(pod.uid, ts)
        e2b_samples: list[float] = []
        for uid, machine in outcome.placements:
            task = self.tasks.get(uid)
            if (task is None or task.phase != TaskPhase.PENDING
                    or machine not in self.machines):
                # should be unreachable (express_batch owns the window
                # between observe and bind): degrade rather than bind
                # against moved state
                self._express_invalidate(
                    count_degrade=True,
                    why=f"placement target moved for {uid}",
                )
                return None
            bindings[uid] = machine
            self._express_placed[uid] = machine
            self._express_unconfirmed.add(uid)
            if self.lifecycle is not None:
                self.lifecycle.stamp_decided(uid, "express")
            self.decision_log.append((
                self.round_num, "PLACE", uid,
                {"machine": machine, "express": True},
            ))
            e2b = (
                (t_done - uid_t[uid]) * 1000 if uid in uid_t
                else latency
            )
            self.trace.emit(
                "EXPRESS_PLACE", task=uid, machine=machine,
                round_num=self.round_num,
                # per-placement event-to-bind-decision latency (ms,
                # monotonic-clock difference from the event's OWN
                # receipt stamp when the caller supplied one)
                detail={"e2b_ms": round(e2b, 3)},
            )
            self._express_e2b.append(e2b)
            e2b_samples.append(e2b)
        self._express_places += len(bindings)
        if self.profile_spans:
            emit_span(
                self.trace,
                express_span_tree(latency, outcome.timings),
                self.round_num,
            )
        self.trace.flush()
        if self.metrics is not None:
            self.metrics.record_express_batch(e2b_samples)
        if self.flightrec is not None:
            self.flightrec.capture_express(
                self.round_num, batch, outcome, placements=bindings
            )
        return ExpressResult(
            bindings=bindings,
            cost=outcome.cost,
            rounds=outcome.rounds,
            latency_ms=latency,
            timings=outcome.timings,
        )

    # ---- the stream lane (--stream_windows K) ---------------------------

    def stream_window(
        self,
        pod_events: list[tuple[str, Task]],
        *,
        t_event: float | None = None,
        t_events: list[float] | None = None,
    ) -> bool:
        """Accumulate one watch-event window into the pending stream
        batch (``express_batch``'s head — the same observe transitions,
        coalescing and degrade gates — but the solve is deferred:
        ``stream_flush`` runs K accumulated windows with ONE result
        fetch). Returns True when the window was accumulated (or was
        pure replay noise); False means the stream degraded and the
        events wait for the next full round. The events are ALWAYS
        applied to bridge state either way."""
        t0 = time.perf_counter()
        before: dict[str, Task | None] = {}
        for _typ, pod in pod_events:
            if pod.uid not in before:
                before[pod.uid] = self.tasks.get(pod.uid)
        for typ, pod in pod_events:
            self.observe_pod_event(typ, pod)
        if self.lifecycle is not None and t_events is not None:
            for (_typ, pod), ts in zip(pod_events, t_events):
                self.lifecycle.backdate_event(pod.uid, ts)
        if not self.express_lane:
            return False
        if not self.solver.express_ready or self._inflight is not None:
            self.solver.invalidate_express()
            return False
        if self._express_unconfirmed:
            self._express_invalidate(
                count_degrade=True, why="unconfirmed placements"
            )
            return False
        try:
            arrivals, removals, slot_deltas = (
                self._express_transitions(before)
            )
        except ValueError as e:
            self._express_invalidate(count_degrade=True, why=str(e))
            return False
        if not (arrivals or removals or slot_deltas
                or self._express_retire):
            return True  # pure replay noise: nothing to accumulate
        try:
            maps = self.solver.express_maps()
        except ExpressDegrade as e:
            self._express_invalidate(count_degrade=True, why=str(e))
            return False
        if maps is None:
            return False
        midx, rack_idx = maps
        builder = (
            self._graph.builder if self._graph is not None
            else FlowGraphBuilder(preemption=self.enable_preemption)
        )
        batch = ExpressBatch(
            arrivals=[
                ExpressArrival(
                    uid=t.uid,
                    wait_rounds=t.wait_rounds,
                    cpu_milli=int(t.cpu_request * 1000),
                    mem_kb=t.memory_request_kb,
                    prefs=tuple(
                        builder.task_arc_rows(t, midx, rack_idx)
                    ),
                )
                for t in arrivals
            ],
            retires=self._express_retire,
            removals=removals,
            slot_deltas=slot_deltas,
        )
        self._express_retire = []
        outcome = self.solver.stream_window(batch)
        if not outcome.ok:
            self._express_degrades += 1
            self.trace.emit(
                "EXPRESS_DEGRADE", round_num=self.round_num,
                detail={"why": outcome.reason},
            )
            self.trace.flush()
            if self.metrics is not None:
                self.metrics.record_express_degrade(outcome.reason)
            if self.flightrec is not None:
                self.flightrec.capture_express(
                    self.round_num, batch, outcome
                )
                self.flight_dump(
                    "express-degrade", label=outcome.reason
                )
            return False
        # receipt stamps for the finish-side per-placement e2b
        # (earliest wins across coalesced duplicates)
        if self._stream_t0 is None:
            self._stream_t0 = t_event if t_event is not None else t0
        if t_events is not None:
            for (_typ, pod), ts in zip(pod_events, t_events):
                self._stream_uid_t.setdefault(pod.uid, ts)
        elif t_event is not None:
            for _typ, pod in pod_events:
                self._stream_uid_t.setdefault(pod.uid, t_event)
        return True

    def stream_flush(self) -> None:
        """Start the accumulated windows on the solver's background
        worker (ONE result fetch for all of them). Never blocks: the
        next batch's windows accumulate meanwhile; ``stream_finish``
        joins it."""
        self.solver.stream_flush()

    def stream_finish(self) -> ExpressResult | None:
        """Join the in-flight stream batch and bind every GOOD window's
        placements (a mid-stream certificate failure still binds the
        windows the latch proved before freezing — the degrade is traced
        and the failed window's events onward wait for the next full
        round). Returns ``None`` when nothing was in flight or nothing
        could bind."""
        out = self.solver.stream_finish()
        if out is None:
            return None
        t_done = time.perf_counter()
        t0 = self._stream_t0
        self._stream_t0 = None
        latency = (t_done - t0) * 1000 if t0 is not None else 0.0
        bindings: dict[str, str] = {}
        e2b_samples: list[float] = []
        for uid, machine, wdx in out.placements:
            task = self.tasks.get(uid)
            if task is None or task.phase != TaskPhase.PENDING:
                # the pod left (or bound elsewhere) in a LATER window of
                # the same batch — the deletion was applied to bridge
                # state at accumulate time, so the placement is stale
                self._stream_uid_t.pop(uid, None)
                continue
            if machine not in self.machines:
                self._express_invalidate(
                    count_degrade=True,
                    why=f"placement target moved for {uid}",
                )
                return None
            bindings[uid] = machine
            self._express_placed[uid] = machine
            self._express_unconfirmed.add(uid)
            if self.lifecycle is not None:
                self.lifecycle.stamp_decided(uid, "stream")
            self.decision_log.append((
                self.round_num, "PLACE", uid,
                {"machine": machine, "express": True,
                 "stream_window": wdx},
            ))
            ts = self._stream_uid_t.pop(uid, None)
            e2b = (t_done - ts) * 1000 if ts is not None else latency
            self.trace.emit(
                "EXPRESS_PLACE", task=uid, machine=machine,
                round_num=self.round_num,
                detail={"e2b_ms": round(e2b, 3),
                        "stream_window": wdx},
            )
            self._express_e2b.append(e2b)
            e2b_samples.append(e2b)
        good = len(out.window_costs)
        self._express_batches += good
        self._express_places += len(bindings)
        self._stream_flushes += 1
        self.trace.emit(
            "STREAM_FLUSH", round_num=self.round_num,
            detail={
                "windows": out.windows,
                "placements": len(bindings),
                "fetches": out.fetches,
                "failed_window": out.failed_window,
            },
        )
        if self.profile_spans:
            emit_span(
                self.trace,
                stream_span_tree(
                    latency, out.timings, windows=out.windows,
                ),
                self.round_num,
            )
        if not out.ok:
            # the solver already invalidated the context; the good
            # windows above are bound, the failed window's events
            # onward wait for the round path
            self._express_degrades += 1
            self.trace.emit(
                "EXPRESS_DEGRADE", round_num=self.round_num,
                detail={"why": out.reason},
            )
            if self.metrics is not None:
                self.metrics.record_express_degrade(out.reason)
            self.flight_dump("express-degrade", label=out.reason)
        self.trace.flush()
        if self.metrics is not None:
            self.metrics.record_express_batch(e2b_samples)
            self.metrics.record_stream_flush(
                out.windows, len(bindings)
            )
        if not bindings and not out.ok:
            return None
        return ExpressResult(
            bindings=bindings,
            cost=sum(out.window_costs),
            rounds=max(out.window_rounds, default=0),
            latency_ms=latency,
            timings=out.timings,
        )

    def _running_reobserved(
        self, known: Task | None, pod: Task, stored: Task, was_on: str
    ) -> None:
        """Rebalancing-mode graph notes for a pod observed RUNNING.

        The running block keys on (uid, machine, job, prefs): machine
        changes patch as moves, cpu/mem as updates, job/pref reshapes
        force a rebuild (they change arc structure mid-order).
        """
        g = self._graph
        if known is None or known.phase != TaskPhase.RUNNING \
                or not was_on:
            # entering the running block (adoption, pending->running,
            # or a Running pod that previously lacked a nodeName)
            if pod.machine:
                g.note_running_added(stored)
            return
        if not pod.machine:
            g.note_running_removed(pod.uid)
            return
        if known.job != pod.job or not (
            known.data_prefs is pod.data_prefs
            or known.data_prefs == pod.data_prefs
        ):
            g.note_full_rebuild("running pod reshaped")
            return
        if was_on != pod.machine:
            g.note_running_moved(pod.uid, pod.machine)
        if (known.cpu_request != pod.cpu_request
                or known.memory_request_kb != pod.memory_request_kb):
            g.note_running_updated(stored)

    def _retire_notes(self, task: Task) -> None:
        """Graph notes for a task leaving the cluster entirely."""
        if task.uid in self._displaced_parked:
            # retired while parked: the builder never saw it — no
            # note; just release the parking slot
            del self._displaced_parked[task.uid]
            return
        g = self._graph
        if not g:
            return
        if task.phase == TaskPhase.PENDING:
            g.note_task_removed(task.uid)
        elif (task.phase == TaskPhase.RUNNING
              and task.machine in self.machines):
            if self.enable_preemption:
                g.note_running_removed(task.uid)
            else:
                g.note_slots_changed(task.machine, -1)

    # ---- the scheduling round ------------------------------------------

    def cluster_state(self) -> ClusterState:
        tasks = list(self.tasks.values())
        if self._displaced_parked:
            # parked node-death displacement waits for its staged-
            # requeue wave: excluded from the schedulable view (state
            # truth — self.tasks — keeps them as Pending throughout)
            parked = self._displaced_parked
            tasks = [t for t in tasks if t.uid not in parked]
        return ClusterState(
            machines=list(self.machines.values()),
            tasks=tasks,
        )

    def run_scheduler(self) -> RoundResult:
        """One serial round: build -> price -> solve -> deltas (the
        reference's RunScheduler + ScheduleAllJobs,
        scheduler_bridge.cc:129-192). Exactly ``begin_round`` +
        ``finish_round`` with no overlapped work between."""
        return self.finish_round(self.begin_round())

    def begin_round(self) -> InflightRound:
        """Build the graph and dispatch the solve asynchronously.

        Returns an ``InflightRound``; the caller may do unrelated host
        work (next poll, binding POSTs) before ``finish_round``. One
        round in flight at a time.
        """
        if self._inflight is not None:
            raise RuntimeError(
                "a scheduling round is already in flight; call "
                "finish_round() first"
            )
        self.round_num += 1
        stats = SchedulerStats(round_num=self.round_num)
        stats.lane = self.lane
        stats.evictions = self._evictions_this_round
        self._evictions_this_round = 0
        stats.bind_failures = self._bind_failures
        self._bind_failures = 0
        stats.fetch_timeouts = self._fetch_timeouts
        self._fetch_timeouts = 0
        stats.degrades_total = self._degrades_total
        stats.observe_ms = round(self._observe_ms, 3)
        self._observe_ms = 0.0
        stats.watch_resyncs = self._watch_resyncs
        self._watch_resyncs = 0
        stats.watch_reconnects = self._watch_reconnects
        self._watch_reconnects = 0
        if self.flightrec is not None:
            # resync-storm trip (the obs storm gauge's recorder twin):
            # a flapping watch stream re-listing the cluster every tick
            # is exactly the incident whose inputs should survive
            self._resync_window.append(stats.watch_resyncs)
            if sum(self._resync_window) >= STORM_RESYNCS:
                if not self._storm_dumped:
                    self._storm_dumped = True
                    self.flight_dump(
                        "resync-storm",
                        label=f"{sum(self._resync_window)} resyncs "
                              f"in the last {STORM_WINDOW} rounds",
                    )
            else:
                self._storm_dumped = False
        stats.express_batches = self._express_batches
        self._express_batches = 0
        stats.express_places = self._express_places
        self._express_places = 0
        stats.express_degrades = self._express_degrades
        self._express_degrades = 0
        if self._express_e2b:
            lat = np.asarray(self._express_e2b)
            stats.express_e2b_p50_ms = round(
                float(np.percentile(lat, 50)), 3
            )
            stats.express_e2b_p99_ms = round(
                float(np.percentile(lat, 99)), 3
            )
            self._express_e2b = []
        if (
            self.auditor is not None
            and self.machines and self.tasks
            and self.auditor.due(self.round_num)
        ):
            # the shadow audit's sampled capture: post-observe cluster
            # state handed to the background re-solve (host data
            # only, no device read; the O(cluster) list copy
            # amortizes over the sampling cadence like the checkpoint
            # capture). Captured BEFORE the build so empty rounds —
            # a drifted place-only cluster with nothing pending rounds
            # empty forever — still get audited.
            self.auditor.capture(
                round_num=self.round_num,
                cost_model=self.cost_model,
                hysteresis=self.migration_hysteresis,
                machines=self.machines,
                tasks=self.tasks,
                knowledge=self.knowledge,
            )
        # staged-requeue wave: refresh the per-round displacement
        # budget and admit the next FIFO wave of parked node-death
        # displacement into the schedulable set (note_task_added —
        # from the builder's view these ARE new pending arrivals)
        self._requeue_budget_left = (
            self.max_migrations_per_round
            if self.max_migrations_per_round > 0 else None
        )
        admitted = 0
        while self._displaced_parked:
            uid = next(iter(self._displaced_parked))
            task = self.tasks.get(uid)
            if task is None or task.phase != TaskPhase.PENDING:
                # moved on while parked (retired/adopted): discard
                # WITHOUT burning a budget unit — a wave peppered
                # with stale entries must still admit a full budget
                # of real pods
                del self._displaced_parked[uid]
                continue
            if not self._requeue_take():
                break
            del self._displaced_parked[uid]
            # re-enter at the END of the insertion order: the builder
            # appends admitted tasks to its pending order, and the
            # cluster view must agree or the self-heal verify would
            # force a full rebuild every admission wave
            del self.tasks[uid]
            self.tasks[uid] = task
            if self._graph:
                self._graph.note_task_added(task)
            admitted += 1
        stats.requeue_admitted = admitted
        stats.displaced_parked = len(self._displaced_parked)
        t_start = time.perf_counter()

        cluster = self.cluster_state()
        pending = cluster.pending()
        stats.pods_total = len(cluster.tasks)
        stats.pods_pending = len(pending)
        # rebalancing rounds run on running tasks alone — correcting a
        # drifted packing needs no pending arrivals. pod_to_machine
        # holds exactly the RUNNING-on-a-known-machine set (every
        # transition that breaks that pops the entry), so this is the
        # O(1) form of the old O(cluster) any()-walk the contract
        # linter flagged (PTA002).
        has_rebal = self.enable_preemption and bool(self.pod_to_machine)
        if not self.machines or (not pending and not has_rebal):
            # an empty round leaves the express context warm (nothing
            # to rebuild) but closes the verify window: place-only
            # placements have no correction pass to wait for
            self._express_placed.clear()
            stats.total_ms = (time.perf_counter() - t_start) * 1000
            stats.wall_ms = stats.total_ms
            self.trace.emit(
                "ROUND", round_num=self.round_num,
                detail=dataclasses.asdict(stats),
            )
            self.trace.flush()
            if self.metrics is not None:
                # empty rounds still carry the window's counters
                # (evictions, watch resyncs, express activity)
                self.metrics.record_round(stats)
                self._note_trace_drops()
            return InflightRound(
                stats=stats,
                result=RoundResult(bindings={}, stats=stats,
                                   unscheduled=[]),
            )

        t0 = time.perf_counter()
        topology = None
        if self._graph is not None:
            arrays, meta = self._graph.build_arrays(cluster, pending)
            stats.build_mode = self._graph.last_build_mode
            cols = self._graph.columns
            topology = topology_from_columns(cols)
            cpu_col, mem_col = self._graph.cost_columns()
        else:
            fb = FlowGraphBuilder(
                preemption=self.enable_preemption,
                migration_hysteresis=self.migration_hysteresis,
            )
            cols = fb.merge_columns(fb.extract_columns(cluster))
            arrays, meta = fb.assemble(cols)
            stats.build_mode = "legacy"
            cpu_col, mem_col = cols.cpu_milli, cols.mem_kb
        stats.build_ms = (time.perf_counter() - t0) * 1000

        machine_names = meta.machine_names
        cost_kwargs = dict(
            task_cpu_milli=cpu_col,
            task_mem_kb=mem_col,
            task_usage=self.knowledge.task_cpu_usage(
                meta.task_uids
            ),
            machine_load=self.knowledge.machine_load(machine_names),
            machine_mem_free=self.knowledge.machine_mem_free(
                machine_names
            ),
        )
        if self.enable_preemption:
            # rebalancing needs the models to see the CURRENT packing:
            # occupancy (running tasks per machine) is what makes a
            # drifted machine expensive and a migration worth its
            # hysteresis. Gated on the flag so place-only pricing stays
            # byte-identical to the pre-rebalancing scheduler. Derived
            # from the merged builder columns (current_m), not a Python
            # walk of cluster.tasks — this path is O(churn) + numpy.
            cur = cols.current_m
            cost_kwargs["machine_used_slots"] = (
                np.bincount(
                    cur[cur >= 0], minlength=len(machine_names)
                ).astype(np.int32)
                if cur is not None
                else np.zeros(len(machine_names), np.int32)
            )
        t0 = time.perf_counter()
        solve = self.solver.begin_round(
            arrays, meta,
            cost_model=self.cost_model,
            topology=topology,
            cost_input_kwargs=cost_kwargs,
        )
        t_end = time.perf_counter()
        stats.dispatch_ms = (t_end - t0) * 1000
        ir = InflightRound(
            stats=stats,
            solve=solve,
            meta=meta,
            t_begin_start=t_start,
            t_begin_end=t_end,
            begin_ms=(t_end - t_start) * 1000,
        )
        if self.flightrec is not None:
            # capture AFTER the dispatch: the arrays are exactly what
            # the solve consumed, the solver's padding floors/dims are
            # this round's, and the warm seed (when clean) is the host
            # mirror the LAST round's fetch already brought back — no
            # device read, vectorized copies only
            ir.flight = self.flightrec.capture_begin(
                round_num=self.round_num,
                cost_model=self.cost_model,
                flags={
                    **self.round_flags, "build_mode": stats.build_mode,
                },
                arrays=arrays,
                meta=meta,
                cost_kwargs=cost_kwargs,
                pad_floors=getattr(self.solver, "pad_floors", {}),
                dims={
                    "Tp": getattr(solve, "Tp", 0),
                    "Mp": getattr(solve, "Mp", 0),
                    "n_prefs": getattr(solve, "n_prefs", 0),
                    "smax": getattr(solve, "smax", 0),
                },
                warm_used=getattr(solve, "warm_used", False),
                warm_seed=(
                    getattr(self.solver, "warm_seed_host", None)
                    if getattr(solve, "warm_used", False) else None
                ),
                rv=self.flight_rv,
            )
        self._inflight = ir
        return ir

    def finish_round(self, ir: InflightRound) -> RoundResult:
        """Join the in-flight solve and apply this round's deltas
        (bindings, aging, stats, trace)."""
        if ir.result is not None:
            return ir.result
        if self._inflight is not ir:
            raise RuntimeError("finish_round() got a stale round")
        self._inflight = None
        stats = ir.stats
        t_fin = time.perf_counter()
        stats.overlap_ms = (t_fin - ir.t_begin_end) * 1000

        # span stamps on the monotonic clock (trace.py clock contract:
        # wall time is for timestamps only, never durations)
        t_join0 = time.monotonic()
        try:
            outcome = self.solver.finish_round(ir.solve)
        except FetchTimeout as e:
            # the pipelined fetch missed its --max_solver_runtime
            # deadline: degrade LOUDLY (trace event + counter surfaced
            # in the NEXT round's stats, since this one is abandoned)
            # and let the daemon loop's round-failure path skip the tick.
            self._fetch_timeouts += 1
            self.trace.emit(
                "FETCH_TIMEOUT", round_num=ir.stats.round_num,
                detail={"error": str(e)},
            )
            self.trace.flush()
            self.flight_dump("fetch-timeout", label=str(e))
            raise
        t_join1 = time.monotonic()
        meta = ir.meta
        # a finished round replaces the express context: whatever
        # retire backlog / unconfirmed set the OLD window accumulated
        # is stale against the new round's rows (stream stamps too —
        # the solver abandoned any pending/in-flight stream batch at
        # begin_round)
        self._express_retire = []
        self._express_unconfirmed.clear()
        self._stream_uid_t.clear()
        self._stream_t0 = None
        # phase accounting: prep+upload feed the price column, the pure
        # device compute is the solve column, the result download the
        # decompose column (transfer vs compute stays distinguishable)
        stats.price_ms = (
            outcome.timings.get("prep_ms", 0.0)
            + outcome.timings.get("upload_ms", 0.0)
        )
        stats.solve_ms = outcome.timings.get("solve_ms", 0.0)
        stats.decompose_ms = (
            outcome.timings.get("fetch_ms", 0.0)
            + outcome.timings.get("oracle_ms", 0.0)
        )
        stats.fetch_wait_ms = outcome.timings.get("fetch_wait_ms", 0.0)
        stats.backend = outcome.backend
        stats.cost = outcome.cost
        # oversize/uncertified degrades are OBSERVABLE, not just
        # logged: a DEGRADE trace event + the lifetime counter in
        # stats. Deliberate routing (small-instance, non-taxonomy
        # graphs) is dispatch, not degradation, and stays uncounted.
        flight_dump_why = ""
        if outcome.backend.startswith("oracle:"):
            why = outcome.backend.split(":", 1)[1]
            if why not in ("small-instance", "not-scheduling-shaped"):
                self._degrades_total += 1
                self.trace.emit(
                    "DEGRADE", round_num=ir.stats.round_num,
                    detail={"why": why, "backend": outcome.backend},
                )
                if self.metrics is not None:
                    self.metrics.record_degrade(why)
                # dumped AFTER the outcome is attached to the record
                # below, so the dump carries this round's result too
                flight_dump_why = why
        stats.degrades_total = self._degrades_total

        # the decision layer: diff the solved assignment against current
        # placements into typed PLACE | MIGRATE | PREEMPT | NOOP records
        # (graph/deltas.py), budget-bounded in rebalancing mode. In
        # place-only mode every task is pending, so this reduces to the
        # old place-or-age classification exactly. Each delta carries
        # its exact route cost + runner-up margin (the attribution pair
        # the solver's one fetch brought back) into the decision log,
        # the trace events, and the explainer.
        dset = extract_deltas(
            meta, outcome.assignment,
            max_migrations=(
                self.max_migrations_per_round
                if self.enable_preemption else 0
            ),
            task_cost=outcome.task_cost,
            task_margin=outcome.task_margin,
        )

        bindings: dict[str, str] = {}
        unscheduled: list[str] = []
        unsched_ages: list[int] = []
        migrations: dict[str, tuple[str, str]] = {}
        preemptions: dict[str, str] = {}
        g = self._graph
        def _age(uid: str, task: Task) -> None:
            # aging: parked pods push harder next round (the
            # Quincy/CoCo unscheduled-cost input)
            self.tasks[uid] = dataclasses.replace(
                task, wait_rounds=task.wait_rounds + 1
            )
            if g:
                g.note_task_aged(uid)
            unscheduled.append(uid)
            unsched_ages.append(task.wait_rounds + 1)

        def _live_pending(uid: str) -> Task | None:
            task = self.tasks.get(uid)
            if task is None or task.phase != TaskPhase.PENDING:
                # the overlap window's poll already moved this pod —
                # retired, or adopted as Running elsewhere (another
                # scheduler / watch catch-up). The in-flight decision
                # is stale for it: binding it would clobber observed
                # truth with a conflicting POST, aging it would age a
                # pod that is not waiting. Skip; a still-pending pod
                # is simply re-offered next round.
                return None
            return task

        for d in dset.place:
            task = _live_pending(d.task)
            if task is None:
                continue
            if d.machine not in self.machines:
                # the target machine disappeared during the overlap
                # window (node removal): confirming would park the pod
                # Running on a ghost. Treat the pod as unplaced — it
                # ages and is reported unscheduled like any other
                # pending pod this round left behind (the node removal
                # already forced a full rebuild).
                _age(d.task, task)
                continue
            bindings[d.task] = d.machine
            if self.lifecycle is not None:
                self.lifecycle.stamp_decided(d.task, "tick")
            self.decision_log.append((
                self.round_num, "PLACE", d.task,
                {"machine": d.machine, "cost": d.cost,
                 "margin": d.margin},
            ))
            self.trace.emit("SCHEDULE", task=d.task, machine=d.machine,
                            round_num=ir.stats.round_num,
                            detail={"cost": d.cost,
                                    "margin": d.margin})
            log.info(
                "round %d: PLACE %s -> %s",
                ir.stats.round_num, d.task, d.machine,
            )
        for uid in dset.unscheduled:
            task = _live_pending(uid)
            if task is not None:
                _age(uid, task)
        for d in dset.migrate:
            task = self.tasks.get(d.task)
            if (task is None or task.phase != TaskPhase.RUNNING
                    or task.machine != d.from_machine
                    or d.machine not in self.machines):
                # stale: the pod moved/retired during the overlap
                # window, or the target node vanished — re-proposed
                # next round if still worthwhile
                continue
            migrations[d.task] = (d.from_machine, d.machine)
            self.decision_log.append((
                self.round_num, "MIGRATE", d.task,
                {"from": d.from_machine, "to": d.machine,
                 "cost": d.cost, "margin": d.margin},
            ))
            self.trace.emit(
                "MIGRATE", task=d.task, machine=d.machine,
                round_num=ir.stats.round_num,
                detail={"from": d.from_machine, "cost": d.cost,
                        "margin": d.margin},
            )
            log.info(
                "round %d: MIGRATE %s %s -> %s", ir.stats.round_num,
                d.task, d.from_machine, d.machine,
            )
        for d in dset.preempt:
            task = self.tasks.get(d.task)
            if (task is None or task.phase != TaskPhase.RUNNING
                    or task.machine != d.from_machine):
                continue
            preemptions[d.task] = d.from_machine
            self.decision_log.append((
                self.round_num, "PREEMPT", d.task,
                {"from": d.from_machine, "cost": d.cost,
                 "margin": d.margin},
            ))
            self.trace.emit(
                "PREEMPT", task=d.task, machine=d.from_machine,
                round_num=ir.stats.round_num,
                detail={"cost": d.cost, "margin": d.margin},
            )
            log.info(
                "round %d: PREEMPT %s off %s", ir.stats.round_num,
                d.task, d.from_machine,
            )
        stats.pods_placed = len(bindings)
        stats.pods_unscheduled = len(unscheduled)
        stats.deltas_place = len(bindings)
        stats.deltas_migrate = len(migrations)
        stats.deltas_preempt = len(preemptions)
        stats.deltas_noop = len(dset.noop)
        stats.deltas_deferred = len(dset.deferred)
        if self.express_lane:
            # the correction pass's differential verify: an express
            # placement this round moves (MIGRATE) or parks (PREEMPT)
            # was provably improvable by more than the hysteresis —
            # corrected, counted, traced. Everything else the round
            # left in place is verified final under the stated bound
            # (any remaining per-pod gap is < migration_hysteresis, or
            # the round would have moved it).
            for uid, m in self._express_placed.items():
                if uid in migrations or uid in preemptions:
                    stats.express_corrected += 1
                    self.trace.emit(
                        "EXPRESS_CORRECTED", task=uid, machine=m,
                        round_num=ir.stats.round_num,
                    )
            self._express_placed.clear()
            if self.enable_preemption and (
                preemptions or dset.deferred
            ):
                # the device seats disagree with reality after a
                # preemption (pod re-enters pending) or a deferred
                # migration (seated at the solve's target, running at
                # the old machine): express sits this window out
                self.solver.invalidate_express()
        t_now = time.perf_counter()
        stats.total_ms = ir.begin_ms + (t_now - t_fin) * 1000
        stats.wall_ms = (t_now - ir.t_begin_start) * 1000
        if self.profile_spans:
            emit_span(
                self.trace,
                round_span_tree(
                    stats,
                    join_ms=(t_join1 - t_join0) * 1000,
                    actuate_ms=(time.monotonic() - t_join1) * 1000,
                ),
                ir.stats.round_num,
            )
        self.trace.emit(
            "ROUND", round_num=ir.stats.round_num,
            detail=dataclasses.asdict(stats),
        )
        self.trace.flush()
        if self.lifecycle is not None:
            # the standing-unscheduled wait-age surface (the ages the
            # _age walk above already collected — no second walk)
            self.lifecycle.note_unscheduled(unsched_ages)
        if self.metrics is not None:
            self.metrics.record_round(stats)
            self._note_trace_drops()
        if self.flightrec is not None:
            self.flightrec.capture_finish(
                ir.flight, outcome, dataclasses.asdict(stats),
                extra={
                    "unscheduled": list(unscheduled),
                    "deferred": [d.task for d in dset.deferred],
                },
            )
            if flight_dump_why:
                self.flight_dump("degrade", label=flight_dump_why)
        return RoundResult(
            bindings=bindings, stats=stats, unscheduled=unscheduled,
            migrations=migrations, preemptions=preemptions,
        )

    def cancel_round(self, ir: InflightRound | None = None) -> None:
        """Abandon an in-flight round (daemon loop error path): join and
        discard the solve so the next ``begin_round`` starts clean."""
        ir = ir if ir is not None else self._inflight
        if ir is None:
            return
        if self._inflight is ir:
            self._inflight = None
        if ir.solve is not None:
            # drain-only: certificate checks / oracle fallback would
            # block the error-recovery path (up to the full oracle
            # timeout) for a result being thrown away. A fetch that
            # misses its deadline here is still surfaced (counter +
            # trace event) like a finish_round miss — discard_round
            # swallows the exception, so diff its counter.
            before = self.solver.fetch_timeouts
            self.solver.discard_round(ir.solve)
            missed = self.solver.fetch_timeouts - before
            if missed:
                self._fetch_timeouts += missed
                self.trace.emit(
                    "FETCH_TIMEOUT", round_num=ir.stats.round_num,
                    detail={"error": "fetch abandoned in cancel_round"},
                )
                self.trace.flush()
                self.flight_dump(
                    "fetch-timeout",
                    label="fetch abandoned in cancel_round",
                )

    def restore_state(
        self,
        *,
        machines: list[Machine],
        tasks: list[Task],
        round_num: int,
        knowledge_state: dict | None = None,
        builder_cols=None,
    ) -> None:
        """Warm-restore rehydration (ha/checkpoint.py): adopt a
        checkpointed cluster image wholesale on a freshly-constructed
        bridge — tasks/machines in their checkpointed insertion order
        (the pending order every graph build depends on), the derived
        ``pod_to_machine`` set, the knowledge sample rings, and
        (optionally) the incremental builder's patchable columns so the
        first post-restore build patches instead of re-extracting.
        The device express context did not survive the process, so the
        express bookkeeping starts clean; mass-eviction-guard strikes
        reset (a restore begins a fresh observation history — the
        guard itself stays armed across the boundary)."""
        self.machines = {m.name: m for m in machines}
        self.tasks = {t.uid: t for t in tasks}
        self.pod_to_machine = {
            t.uid: t.machine for t in tasks
            if t.phase == TaskPhase.RUNNING
            and t.machine in self.machines
        }
        self.round_num = int(round_num)
        if knowledge_state is not None:
            self.knowledge.restore_state(knowledge_state)
        if self._graph is not None:
            if builder_cols is not None:
                self._graph.restore_columns(builder_cols)
            else:
                self._graph.note_full_rebuild("restore")
        self._express_retire = []
        self._express_unconfirmed.clear()
        self._express_placed.clear()
        self._stream_uid_t.clear()
        self._stream_t0 = None
        if self.express_lane:
            self.solver.invalidate_express()
        self._node_shrink_strikes = 0
        self._pod_shrink_strikes = 0
        self._node_shrink_strikes_first = 0.0
        self._pod_shrink_strikes_first = 0.0
        # parking does not survive the process: restored pods are all
        # schedulable at once (documented — at worst one placement
        # burst after a crash mid-drain, bounded by what was parked)
        self._displaced_parked = {}

    @property
    def solver_timeout_s(self) -> float:
        """Oracle-fallback budget; delegates to the live solver (the
        reference's --max_solver_runtime, poseidon.cfg:14-15)."""
        return self.solver.oracle_timeout_s

    @solver_timeout_s.setter
    def solver_timeout_s(self, value: float) -> None:
        self.solver.oracle_timeout_s = value

    @property
    def round_flags(self) -> dict:
        """The settings a round runs under: the flags the flight
        recorder captures each round (with the round's ``build_mode``)
        and the replay rebuilds its solver from — the scale lane's
        ``mesh_width``, ``aggregate_classes`` and ``topk_prefs`` among
        them."""
        return {
            "enable_preemption": self.enable_preemption,
            "migration_hysteresis": self.migration_hysteresis,
            "max_migrations_per_round": self.max_migrations_per_round,
            "express_lane": self.express_lane,
            "express_max_batch": getattr(
                self.solver, "express_max_batch", 16
            ),
            "small_to_oracle": getattr(self.solver, "small_to_oracle", True),
            "mesh_width": getattr(self.solver, "mesh_width", 0),
            "aggregate_classes": getattr(
                self.solver, "aggregate_classes", False
            ),
            "topk_prefs": getattr(self.solver, "topk_prefs", 0),
            "lane": self.lane,
        }

    @property
    def warm_state(self):
        """The solver's device warm handle (assign None to force cold)."""
        return self.solver.warm

    @warm_state.setter
    def warm_state(self, value) -> None:
        if value is not None:
            raise ValueError(
                "warm_state is device-owned; only None (reset) is "
                "assignable"
            )
        self.solver.reset()

    def confirm_binding(self, uid: str, machine: str) -> None:
        """Caller reports a successful bindings POST: mark Running so the
        next build discounts the slot even before the poll reflects it."""
        task = self.tasks.get(uid)
        if task is None:
            return
        stored = dataclasses.replace(
            task, phase=TaskPhase.RUNNING, machine=machine
        )
        g = self._graph
        if g:
            if task.phase == TaskPhase.PENDING:
                g.note_task_removed(uid)
                if self.enable_preemption:
                    g.note_running_added(stored)
                else:
                    g.note_slots_changed(machine, +1)
            elif task.phase == TaskPhase.RUNNING and \
                    task.machine != machine:
                if self.enable_preemption:
                    g.note_running_moved(uid, machine)
                else:
                    if task.machine and task.machine in self.machines:
                        g.note_slots_changed(task.machine, -1)
                    g.note_slots_changed(machine, +1)
        self.tasks[uid] = stored
        self.pod_to_machine[uid] = machine
        if self.lifecycle is not None:
            # the lifecycle close: event -> confirmed, recorded under
            # the lane stamped at decision time
            self.lifecycle.close_confirmed(uid)
        if self.express_lane:
            # the bound pod leaves the pending set: queue the device
            # retire (row deactivates, seat becomes used capacity) for
            # the next express dispatch
            self._express_unconfirmed.discard(uid)
            if self.solver.express_ready:
                self._express_retire.append((uid, machine))

    def revoke_binding(self, uid: str) -> None:
        """A bindings POST failed after an optimistic ``confirm_binding``
        (the pipelined loop confirms before POSTing, cli.py): flip the
        pod back to Pending so the next round re-offers it. The pod
        re-enters the pending order mid-sequence, so the next graph
        build is a full rebuild."""
        task = self.tasks.get(uid)
        if task is None:
            return
        self.tasks[uid] = dataclasses.replace(
            task, phase=TaskPhase.PENDING, machine=""
        )
        self.pod_to_machine.pop(uid, None)
        if self.lifecycle is not None:
            # the optimistic confirm already closed the timeline:
            # reopen it from its ORIGINAL event stamp so the pod's
            # real end-to-end wait is measured when it finally binds
            self.lifecycle.reopen(uid)
        if self._graph:
            self._graph.note_full_rebuild("binding revoked")
        if self.express_lane:
            # a revoked pod re-enters pending mid-window: outside the
            # express patch vocabulary, wait for the next full round
            self._express_unconfirmed.discard(uid)
            self.solver.invalidate_express()

    def confirm_migration(self, uid: str, machine: str) -> None:
        """Caller reports a MIGRATE actuated (eviction + re-bind POSTs
        landed): move the running task to its new machine."""
        task = self.tasks.get(uid)
        if task is None:
            return
        g = self._graph
        if g:
            if task.phase == TaskPhase.RUNNING:
                if task.machine != machine:
                    g.note_running_moved(uid, machine)
            else:
                g.note_full_rebuild("migration of non-running pod")
        self.tasks[uid] = dataclasses.replace(
            task, phase=TaskPhase.RUNNING, machine=machine
        )
        self.pod_to_machine[uid] = machine

    def confirm_preemption(self, uid: str) -> None:
        """Caller reports a PREEMPT actuated (eviction POST landed):
        park the pod Pending with its aging preserved. The pod re-enters
        the pending order mid-sequence, so the next graph build is a
        full rebuild."""
        task = self.tasks.get(uid)
        if task is None:
            return
        self.tasks[uid] = dataclasses.replace(
            task, phase=TaskPhase.PENDING, machine=""
        )
        self.pod_to_machine.pop(uid, None)
        if self._graph:
            self._graph.note_full_rebuild("preempted back to pending")
        if self.express_lane:
            self.solver.invalidate_express()

    def restore_running(self, uid: str, machine: str) -> None:
        """An eviction/re-bind POST failed (possibly after an optimistic
        ``confirm_migration``/``confirm_preemption``): restore the pod
        to RUNNING on ``machine`` — the apiserver's last-known truth —
        count the failure, and force a full rebuild. If the eviction
        half of a migration did land, the next poll re-observes the true
        state and reconciles."""
        self._bind_failures += 1
        task = self.tasks.get(uid)
        if task is None:
            return
        self.tasks[uid] = dataclasses.replace(
            task, phase=TaskPhase.RUNNING, machine=machine
        )
        self.pod_to_machine[uid] = machine
        if self._graph:
            self._graph.note_full_rebuild("actuation failed")
        if self.express_lane:
            # reality no longer matches the device seats
            self.solver.invalidate_express()

    def binding_failed(self, uid: str) -> None:
        """A bindings POST for a PLACE failed: count it and re-queue the
        pod as unscheduled — aging preserved and bumped like any other
        round it sat waiting — instead of silently believing the
        placement landed. Handles both the serial path (pod still
        Pending, never confirmed) and the optimistic pipelined path
        (pod confirmed Running first: revoked, then aged)."""
        self._bind_failures += 1
        if self.express_lane:
            # whether revoked or never confirmed, the pod's device row
            # no longer matches reality (seated but unbound, or aged)
            self._express_unconfirmed.discard(uid)
            self.solver.invalidate_express()
        task = self.tasks.get(uid)
        if task is None:
            return
        if task.phase == TaskPhase.RUNNING:
            self.revoke_binding(uid)
            task = self.tasks[uid]
        if task.phase == TaskPhase.PENDING:
            self.tasks[uid] = dataclasses.replace(
                task, wait_rounds=task.wait_rounds + 1
            )
            if self._graph:
                self._graph.note_task_aged(uid)
