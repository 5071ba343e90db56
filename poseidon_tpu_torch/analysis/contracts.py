"""The declared contracts the lint rules check against, for the port.

The counterpart of the reference's ``poseidon_tpu/analysis/
contracts.py``: every scope, thread class, handoff and floor marker
there has its entry here, written against the port's modules, so the
port's ``# pta:`` markers and reasoned suppressions keep their meaning.
The fields the reference has keep its names (a test maps the
reference's ``DEFAULT_CONTRACTS`` into this class field by field and
runs both packages' framework-independent passes side by side); the
torch meanings add fields of their own: what a device tensor is to
PTA001, the launch hygiene of PTA003, the plan keys of PTA007, the
op-trace audit's declared uploads (PTA008) and the runtime sync map's
sanctioned sites.

Everything repo-specific lives here, separate from the rule logic, so
(a) a reviewer can see the whole enforced surface in one file and
(b) the analyzer tests can run the same rules against synthetic
contracts pointed at snippet trees.

Paths are repo-root-relative POSIX suffixes: a file matches a scope
entry when its normalized path ENDS WITH the entry, so the same
contracts work on the real tree and on a test-built mirror of it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ThreadContract:
    """PTA004 per-class declaration.

    ``lock_attr`` names the designated lock (``with self.<lock_attr>:``
    satisfies the rule at a conflicting access site). ``handoffs`` maps
    attribute name -> the documented reason the cross-thread access is
    safe WITHOUT the lock (a queue, an Event happens-before pair, a
    benign-race close). Background contexts are not listed here — they
    are declared next to the code with a ``# pta: background-thread``
    marker comment on the ``def`` line, so the declaration cannot drift
    from the thread that actually runs the function.
    """

    lock_attr: str = "_lock"
    handoffs: dict[str, str] = dataclasses.field(default_factory=dict)


# the observability recording/span-assembly scopes run INSIDE the
# round's finish/actuate window and the express fast path: hot under
# BOTH PTA001 (no host sync) and PTA002 (no O(cluster) walk) from day
# one — one constant referenced from both maps so the two enforcement
# surfaces cannot drift apart
_OBS_HOT_SCOPES = {
    "poseidon_tpu_torch/obs/flightrec.py": (
        # the flight recorder's capture helpers run inside the round's
        # begin/finish window and the express fast path: vectorized
        # np copies of already-host arrays only — never a device sync,
        # never an O(cluster) Python walk (the dump WRITER is not
        # listed: it runs on the anomaly/on-demand path, off the
        # round's critical path by design)
        "FlightRecorder.capture_begin",
        "FlightRecorder.capture_finish",
        "FlightRecorder.capture_express",
        "FlightRecorder._trim",
        "_copy_meta",
    ),
    "poseidon_tpu_torch/obs/lifecycle.py": (
        # lifecycle stamps run inside the round window and the express
        # fast path: dict ops + clock reads only (note_unscheduled's
        # percentile runs over the age list the caller's existing
        # unscheduled walk produced — no second walk, no device)
        "LifecycleTracker.stamp_event",
        "LifecycleTracker.backdate_event",
        "LifecycleTracker.stamp",
        "LifecycleTracker.stamp_decided",
        "LifecycleTracker.event_wall_us",
        "LifecycleTracker.close_confirmed",
        "LifecycleTracker.close_replayed",
        "LifecycleTracker.drop",
        "LifecycleTracker.note_unscheduled",
        "bounded_lane",
    ),
    "poseidon_tpu_torch/obs/metrics.py": (
        "Counter.inc",
        "Gauge.set",
        "Histogram.observe",
        "SchedulerMetrics.record_pod_e2c",
        "SchedulerMetrics.record_unsched_wait",
        "SchedulerMetrics.record_lifecycle_dropped",
        "SchedulerMetrics.record_trace_dropped",
        "SchedulerMetrics.record_predicted_bytes",
        "SchedulerMetrics.record_round",
        "SchedulerMetrics.record_degrade",
        "SchedulerMetrics.record_express_batch",
        "SchedulerMetrics.record_express_degrade",
        "SchedulerMetrics.record_resync",
        "SchedulerMetrics.record_reconnect",
        "SchedulerMetrics.record_solver_round",
        "SchedulerMetrics.record_express_fetch",
        "SchedulerMetrics.record_stream_fetch",
        "SchedulerMetrics.record_stream_flush",
        "SchedulerMetrics.record_service_round",
        "SchedulerMetrics.record_service_dispatch",
        "SchedulerMetrics.record_service_compiles",
        "SchedulerMetrics.record_checkpoint",
        "SchedulerMetrics.record_checkpoint_age",
        "SchedulerMetrics.record_journal_replay",
        "SchedulerMetrics.record_restore",
        # failure-domain recorders: guard hold/release fire inside
        # the observe path, outage/outbox/shed/watchdog inside the
        # driver tick — all host ints already in hand
        "SchedulerMetrics.record_guard_hold",
        "SchedulerMetrics.record_guard_release",
        "SchedulerMetrics.record_outage",
        "SchedulerMetrics.record_outbox",
        "SchedulerMetrics.record_express_shed",
        "SchedulerMetrics.record_deadline_miss",
        "SchedulerMetrics.record_overload_cleared",
    ),
    "poseidon_tpu_torch/obs/spans.py": (
        "round_span_tree",
        "express_span_tree",
        "stream_span_tree",
        "emit_span",
    ),
}


@dataclasses.dataclass(frozen=True)
class Contracts:
    """The full declared surface consumed by the rules."""

    # ---- PTA001: hot-path scopes (no host syncs) ----------------------
    # whole files whose every function is hot
    hot_path_files: tuple[str, ...] = ()
    # path suffix -> qualified function names ("Class.method"); nested
    # functions inherit their enclosing scope
    hot_path_functions: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )
    # dotted-name prefixes / bare callables whose results are device
    # arrays (the int()/float() taint sources)
    device_producers: tuple[str, ...] = ()
    # producers excluded from taint even though they match a prefix
    # (jax.device_get RESULTS are host arrays)
    device_producer_exceptions: tuple[str, ...] = ()

    # ---- PTA002: O(churn) scopes (no cluster-sized loops) -------------
    ochurn_functions: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )
    # terminal attribute/variable names that hold cluster-sized
    # collections (iterating one of these in an O(churn) scope flags)
    cluster_sized_names: tuple[str, ...] = ()

    # ---- PTA004 + PTA006: thread discipline ---------------------------
    thread_classes: dict[str, ThreadContract] = dataclasses.field(
        default_factory=dict
    )
    # PTA006 spawn inference: callables that run a callable argument on
    # a background thread (the repo's thread-launching wrappers). A
    # lambda / function reference passed to one of these is a thread
    # root: its body executes concurrently with the caller.
    thread_spawn_wrappers: tuple[str, ...] = ()

    # ---- PTA007: recompile-hazard dataflow ----------------------------
    # attribute reads that are data-dependent quantities (live-state
    # maxima, per-round counts): deriving a static arg or pad floor
    # from one of these without riding a grow-only floor is the
    # recompile bug class PR 8 had to flush out at runtime
    hazard_attrs: tuple[str, ...] = ()
    # name fragments that mark a value as riding a grow-only floor
    # (matching is substring for "floor", exact for the pad-parameter
    # vocabulary): an expression referencing one of these is sanctified
    floor_markers: tuple[str, ...] = ()
    # host padding helpers whose listed keyword args are SHAPE floors:
    # a tainted, un-floored value flowing into one of these recompiles
    # the fused chain exactly like a tainted static arg
    pad_sinks: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )

    # ---- per-path rule scoping ----------------------------------------
    # (path prefix, codes enforced there); first match wins, files
    # matching no entry get every rule. tests/ runs the jit-hygiene +
    # vocabulary rules only (test files deliberately contain seeded
    # violations for the rest, as data)
    path_rules: tuple[tuple[str, tuple[str, ...]], ...] = ()

    # ---- PTA005: trace vocabulary + flag surface ----------------------
    trace_module: str = "poseidon_tpu_torch/trace.py"
    trace_vocab_name: str = "EVENT_TYPES"
    flag_module: str = "poseidon_tpu_torch/cli.py"
    flag_doc_files: tuple[str, ...] = ("README.md", "deploy/poseidon-tpu.cfg")
    # metric-name drift: every ``poseidon_*`` family registered in the
    # metrics module must appear in the doc file's observability
    # reference, and every family the doc names must still be
    # registered (a renamed family silently orphans dashboards)
    metrics_module: str = "poseidon_tpu_torch/obs/metrics.py"
    metrics_doc_file: str = "README.md"

    # ---- PTA009: per-kernel mask contracts ----------------------------
    # kernel name -> ((primitive, function, reason), ...): reductions
    # that consume padding-tainted operands SAFELY — the padded lanes
    # are benign by construction (INF fills, zero-weight rows) rather
    # than by a visible select_n mask. Verified live both ways: an
    # unsanctioned tainted reduction is a violation, and a sanction no
    # trace exercises is reported stale (the PTA006 handoff
    # discipline).
    kernel_mask_contracts: dict[
        str, tuple[tuple[str, str, str], ...]
    ] = dataclasses.field(default_factory=dict)

    # ---- PTA010: lock-order + no-blocking-under-lock ------------------
    # terminal callable/method names that BLOCK (filesystem barriers,
    # apiserver round-trips, solver dispatch): executing one while any
    # lock is held stalls every thread contending that lock for the
    # call's full latency. ``.join()``/``queue.put(block=True)`` are
    # recognized structurally by the rule; this vocabulary covers the
    # repo's I/O surface. Plain buffered ``.write``/``.flush`` are NOT
    # blocking (page-cache writes — the journal's write-under-lock is
    # by design; only the fsync barrier must leave the region).
    blocking_call_names: tuple[str, ...] = ()
    # the terminal names of the ``SyncCounter`` instances the port reads
    # through (``syncs.read(x)``): a read is a blocking device->host
    # copy to PTA010 and a host barrier (its result is host data) to
    # PTA001
    sync_counter_names: tuple[str, ...] = ()

    # ---- PTA001 (torch): what a device tensor is ----------------------
    # parameter annotations naming a device-resident value: a parameter
    # annotated with one of these, and every non-metadata attribute,
    # subscript or method result of it, is device data
    device_annotations: tuple[str, ...] = ()

    # ---- PTA003 (torch): launch hygiene -------------------------------
    # the one module that may load a shared library with ctypes
    kernel_loader_module: str = ""
    # launch-plan builders (dotted call suffix) -> path suffixes or
    # "path::Qual.name" prefixes where a call is the plan's cache (or a
    # harness that prints a plan), each with its reason
    plan_builders: dict[str, tuple[tuple[str, str], ...]] = \
        dataclasses.field(default_factory=dict)

    # ---- PTA007 (torch): the plan-key registry ------------------------
    # callable terminal name -> the parameters that key a launch plan,
    # a fresh allocation shape or a pad floor (the port's counterpart of
    # the reference's static_argnames)
    plan_key_params: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )

    # ---- PTA008 (torch): the op-trace audit ---------------------------
    # entry -> ((path suffix, function name, reason), ...): the only
    # places inside an audited entry where a tensor may be made from
    # host data or moved between devices (its declared uploads)
    optrace_uploads: dict[str, tuple[tuple[str, str, str], ...]] = \
        dataclasses.field(default_factory=dict)

    # ---- the runtime sync map (chip_smoke [analysis]) -----------------
    # (path suffix, function name, reason): a synchronising call the
    # card may see outside ``SyncCounter.read`` in a round, an express
    # batch or a stream flush — the blocking uploads of host data
    sync_sites: tuple[tuple[str, str, str], ...] = ()


# The marker comment declaring a function runs on a background thread
# (PTA004). Lives on the ``def`` line:  def run(self):  # pta: background-thread
BACKGROUND_MARKER = "pta: background-thread"


# PTA009 (padding_taint.py): folds over padded lanes that are safe by
# construction, per (entry, aten op, function), each with its reason.
# "*" = every entry whose recording reaches the site (the solve family
# shares these). Verified live: an entry with no matching unmasked fold
# in the current recordings is reported stale.
_KERNEL_MASK_CONTRACTS: dict = {
    "*": (
        ("any", "head",
         "the loop's flag any(waiting) over the sorted carry, where "
         "padded tasks ride the DUMP segment and are never WAIT — no "
         "padded lane can hold the loop open"),
        ("any", "pre",
         "any(viol_now) over violators(), which ANDs task_valid in "
         "before it returns"),
        ("any", "tighten",
         "any(viol) over violators(), which ANDs task_valid in; "
         "any(stranded), which ANDs s > 0 in and so excludes the "
         "zero-slot padded machines (the pad contract) — no padded lane "
         "can hold the loop open or end it"),
        ("sum", "_certify",
         "the dual's machine-side term sums s * lam: padded machines "
         "carry s == 0 by the pad contract, exact zeros in the "
         "certificate"),
    ),
    "resident_chain": (
        ("max", "_redensify",
         "the outer fold of the domain guard runs over the five channel "
         "maxima (a 5-lane stack, no padded lane); each channel's own "
         "fold masks its INF lanes with torch.where at the fold"),
        ("min", "_redensify",
         "the outer fold over the five channel minima, as the max "
         "above; each channel's fold masks with torch.where"),
    ),
}

# PTA008 (optrace_check.py): the declared uploads of each audited entry,
# (path suffix, function, reason) by entry ("*": every entry). None:
# every entry takes its tables through its arguments, uploaded before it
# runs (the sync sites above), and makes its constants on the device
_OPTRACE_UPLOADS: dict = {}

# The synchronising calls a round, an express batch or a stream flush
# may make outside SyncCounter.read: the blocking uploads of host data
# (a pageable host->device copy waits for the stream). PTA001 reports an
# upload in a hot scope unless its function is listed here, and the
# runtime sync map (chip_smoke [analysis]) holds every site the card
# reports to this list. Each is the counterpart of one of the
# reference's explicit device_puts.
_SYNC_SITES: tuple = (
    ("poseidon_tpu_torch/models/costs.py", "CostInputs.to_device",
     "the round's (or the window's mini) pricing inputs: one upload a "
     "field of the padded host arrays, before the round's launches"),
    ("poseidon_tpu_torch/ops/resident.py", "DenseTopology.to_device",
     "the round's padded topology: one upload a field, with the "
     "pricing inputs, before the round's launches"),
    ("poseidon_tpu_torch/ops/resident.py", "ResidentSolver._express_round",
     "the batch's arrival rows and retire/slot patch chunks: one upload "
     "each, before the batch's launches"),
    ("poseidon_tpu_torch/ops/resident.py", "ResidentSolver._stream_put",
     "a stream window's encoding, uploaded at accumulate time so that "
     "it overlaps an in-flight flush"),
    ("poseidon_tpu_torch/ops/resident.py",
     "ResidentSolver._stream_apply_freeze",
     "the rebalancing freeze's backlog: one upload, once a window"),
    ("poseidon_tpu_torch/ops/resident.py",
     "ResidentSolver.restore_for_replay",
     "a restored warm seed: three uploads, once a restore"),
    ("poseidon_tpu_torch/ops/batch.py", "upload_members",
     "the bucket's ONE upload of its stacked member tables"),
    ("poseidon_tpu_torch/ops/dense_auction.py", "build_dense_instance",
     "the solo lane's upload of its padded tables, once a solve"),
    ("poseidon_tpu_torch/ops/cost_scaling.py", "residual_csr",
     "a general solve's residual CSR: one upload a column, once a solve, "
     "before its graph"),
    ("poseidon_tpu_torch/ops/cost_scaling.py", "_BatchSolve.__init__",
     "a batch solve's per-element residual costs and first eps: two "
     "uploads, once a batch, before its graph"),
    ("poseidon_tpu_torch/kernels/csr_plan.py", "make_plan",
     "the residual CSR's launch plan: two uploads, once a solve"),
    ("poseidon_tpu_torch/ops/ssp.py", "_Solve.__init__",
     "SSP's forward arc ends for its path step: two uploads, once a "
     "solve"),
)


DEFAULT_CONTRACTS = Contracts(
    hot_path_files=(
        # the whole resident round is the hot path: ONE upload, the
        # round's launches, ONE sanctioned fetch (module docstring)
        "poseidon_tpu_torch/ops/resident.py",
        # the auction itself (``_solve`` and its passes, the cold
        # start, the certificate): its only host reads are the loop's
        # counted flag reads through SyncCounter.read
        "poseidon_tpu_torch/ops/dense_auction.py",
        # the what-if batch and the service's member solve: one upload,
        # the members' solves, one batched fetch
        "poseidon_tpu_torch/ops/batch.py",
        # the general lane: its tables' uploads, one graph a solve on the
        # card, one fetch (the CPU's host loop reads its flags through
        # SyncCounter.read)
        "poseidon_tpu_torch/ops/cost_scaling.py",
        "poseidon_tpu_torch/ops/ssp.py",
    ),
    hot_path_functions={
        # the general lane's launch plan, made once a solve
        "poseidon_tpu_torch/kernels/csr_plan.py": ("make_plan",),
        # the incremental-build path: O(churn) numpy patching, never a
        # device sync
        "poseidon_tpu_torch/graph/builder.py": (
            "IncrementalFlowGraphBuilder.build_arrays",
            "IncrementalFlowGraphBuilder._apply_deltas",
        ),
        # the begin_round -> finish_round window the pipelined driver
        # overlaps host work under, plus the express fast path (the
        # event-to-bind latency budget is single-digit ms: one
        # dispatch, one sanctioned fetch, no host syncs)
        "poseidon_tpu_torch/bridge/bridge.py": (
            "SchedulerBridge.begin_round",
            "SchedulerBridge.finish_round",
            "SchedulerBridge.express_batch",
            "SchedulerBridge.stream_window",
            "SchedulerBridge.stream_flush",
            "SchedulerBridge.stream_finish",
            "SchedulerBridge._express_transitions",
        ),
        # the scale lane: aggregation planning/expansion runs inside
        # the resident round (hot from day one — pure vectorized host
        # numpy, no device syncs)
        "poseidon_tpu_torch/graph/aggregate.py": (
            "plan_from_costs",
            "plan_from_signatures",
            "aggregate_topology",
            "prune_topology_prefs",
            "expand_assignment",
            "_plan_from_keys",
            "_pinned_mask",
            "_float_bits",
        ),
        # the sharded-round layout helper: explicit device_put only
        "poseidon_tpu_torch/parallel/sharded.py": (
            "resident_round_shardings",
        ),
        # the service lane (multi-tenant batching): begin prices on the
        # CPU backend (its fetch never crosses the device link, the one
        # noqa'd site), launch does one explicit upload + per-member
        # dispatches, finish joins the chunk's ONE sanctioned batched
        # fetch — no other host sync may slip into the dispatch window
        "poseidon_tpu_torch/service/dispatch.py": (
            "TenantSolver.begin_round",
            "TenantSolver.finish_round",
            "BatchDispatcher.register",
            "BatchDispatcher.launch",
            "BatchDispatcher._stage_chunk",
            "BatchDispatcher._dispatch_chunk",
            "BatchDispatcher.finish",
        ),
        # the front door pipeline: pure host bookkeeping (queues,
        # futures, stats) — never a device call of its own
        "poseidon_tpu_torch/service/service.py": (
            "SchedulingService.pump",
            "SchedulingService._finish_wave",
            "SchedulingService._account",
        ),
        # the checkpoint capture path (ha/checkpoint.py) runs on the
        # driver thread right after a round: shallow dict copies +
        # host-array copies only, never a device sync (the warm seed
        # is the mirror the round's own fetch already downloaded); it
        # is deliberately NOT an O(churn) scope — the amortized-
        # cadence O(cluster) dict copy is its documented design
        "poseidon_tpu_torch/ha/checkpoint.py": (
            "capture_snapshot",
            "CheckpointManager.capture",
        ),
        # the shadow audit's capture (obs/audit.py) runs on the
        # driver thread at the sampling cadence: list/array copies of
        # host data only, never a device sync. Like the checkpoint
        # capture it is deliberately NOT an O(churn) scope — the
        # amortized-cadence O(cluster) copy is its documented design
        # (the audit WORKER runs on its own background thread, off
        # every hot path, and is deliberately unlisted)
        "poseidon_tpu_torch/obs/audit.py": (
            "ShadowAuditor.due",
            "ShadowAuditor.capture",
        ),
        # observability recording + span assembly (_OBS_HOT_SCOPES):
        # pure host arithmetic on values the caller already fetched,
        # never a new device sync
        **_OBS_HOT_SCOPES,
        # the pricing inputs' upload, inside every round and window
        "poseidon_tpu_torch/models/costs.py": (
            "CostInputs.to_device",
        ),
    },
    device_producers=(
        # torch calls are device producers when they name a device or
        # take a device operand (rules.py decides; the prefix only
        # marks the family)
        "torch.",
        # the round's device pieces: their results are device tensors
        "_resident_chain",
        "_redensify",
        "_finalize",
        "_decision_stats",
        "_express_step",
        "_stream_chain",
        "_express_patch",
        "_solve",
        "_solve_member",
        "_densify",
        "_task_options",
        "cold_start",
        "model_fn",
    ),
    device_producer_exceptions=(
        # a tensor over host memory (the device is named by a later
        # .to(device), which PTA001 reads as an upload)
        "torch.from_numpy",
    ),
    sync_counter_names=(
        "syncs", "fetches", "loop_syncs", "_fetches", "_loop_syncs",
        "counter",
    ),
    device_annotations=(
        "Tensor",
        "DenseInstance",
        "DenseTopology",
        "DenseState",
        "RowBlocks",
        "ResidualCSR",
        "PathStep",
    ),
    ochurn_functions={
        # express_batch / _express_transitions / express_round run per
        # EVENT BATCH, between ticks: an O(cluster) walk there would
        # turn the single-digit-ms lane back into a round
        "poseidon_tpu_torch/bridge/bridge.py": (
            "SchedulerBridge.begin_round",
            "SchedulerBridge.finish_round",
            "SchedulerBridge.express_batch",
            "SchedulerBridge.stream_window",
            "SchedulerBridge.stream_flush",
            "SchedulerBridge.stream_finish",
            "SchedulerBridge._express_transitions",
        ),
        "poseidon_tpu_torch/graph/builder.py": (
            "IncrementalFlowGraphBuilder.build_arrays",
            "IncrementalFlowGraphBuilder._apply_deltas",
        ),
        "poseidon_tpu_torch/ops/resident.py": (
            "ResidentSolver.begin_round",
            "ResidentSolver.finish_round",
            "ResidentSolver.express_round",
            # the stream lane runs per event WINDOW between ticks,
            # same latency budget as the express fast path
            "ResidentSolver.stream_window",
            "ResidentSolver.stream_flush",
            "ResidentSolver.stream_finish",
            "ResidentSolver._stream_apply_freeze",
            # the express context's lazy host-map build: its two
            # deliberate O(T) walks carry reasoned suppressions (the
            # suppression audit proved the previous scope omission
            # made those noqas dead — any NEW cluster walk here now
            # actually fails CI)
            "ResidentSolver._express_finalize",
        ),
        # the service dispatch/pipeline scopes run once per WAVE across
        # N tenants: an O(tenants x cluster) host walk there turns the
        # batched lane back into N serial schedulers
        "poseidon_tpu_torch/service/dispatch.py": (
            "TenantSolver.begin_round",
            "TenantSolver.finish_round",
            "BatchDispatcher.register",
            "BatchDispatcher.launch",
            "BatchDispatcher._stage_chunk",
            "BatchDispatcher._dispatch_chunk",
            "BatchDispatcher.finish",
        ),
        "poseidon_tpu_torch/service/service.py": (
            "SchedulingService.pump",
            "SchedulingService._finish_wave",
            "SchedulingService._account",
        ),
        # aggregation planning/expansion must stay vectorized numpy:
        # a Python walk over machines here is O(cluster) every round
        "poseidon_tpu_torch/graph/aggregate.py": (
            "plan_from_costs",
            "plan_from_signatures",
            "aggregate_topology",
            "prune_topology_prefs",
            "expand_assignment",
            "_plan_from_keys",
            "_pinned_mask",
        ),
        # the actuation outbox (ha/outbox.py) pumps once per tick in
        # the driver loop's observe window: O(outbox-entries) only —
        # an O(cluster) walk here would bill every healthy tick for
        # the outage machinery
        "poseidon_tpu_torch/ha/outbox.py": (
            "ActuationOutbox.enqueue",
            "ActuationOutbox.pump",
            "ActuationOutbox._pump_pass",
            "OutageDetector.note_failure",
            "OutageDetector.note_success",
        ),
        # the chaos orchestrator's injection step runs on the driver
        # thread between rounds (cli round_hook): schedule lookups
        # and bounded injections only, never a cluster walk
        "poseidon_tpu_torch/chaos/scenarios.py": (
            "ChaosOrchestrator.on_round",
        ),
        # metric recording + span assembly (_OBS_HOT_SCOPES): an
        # O(cluster) walk there would bill every round for its own
        # observability
        **_OBS_HOT_SCOPES,
    },
    cluster_sized_names=(
        "tasks",
        "machines",
        "pods",
        "nodes",
        "pending",
        "task_uids",
        "machine_names",
        "pod_to_machine",
    ),
    thread_classes={
        # The bridge is single-threaded BY CONTRACT: no background
        # context may mutate it at all (any marker-declared background
        # function writing bridge state must hold the lock — and there
        # is deliberately no lock, so the right fix is a handoff
        # through the driver loop).
        "SchedulerBridge": ThreadContract(lock_attr="_lock", handoffs={}),
        "ResidentSolver": ThreadContract(lock_attr="_lock", handoffs={}),
        # resident.py's single-shot fetch handle: the Event set/wait
        # pair is the documented happens-before edge
        "_AsyncFetch": ThreadContract(
            lock_attr="_lock",
            handoffs={
                "_value": "written before _done.set(); read only after "
                          "_done.wait() — Event establishes happens-before",
                "_exc": "same Event happens-before as _value",
            },
        ),
        # the metrics registry: recording sites run on the driver
        # thread inside the round, render() on the metrics server's
        # handler threads — every access to the instrument maps holds
        # the one shared registry lock
        "MetricsRegistry": ThreadContract(lock_attr="_lock", handoffs={}),
        # the /readyz latch: driver-thread marks, handler-thread reads,
        # both under the lock (the booleans flip once, but reasons()
        # must not see a torn seeded/round pair)
        "HealthState": ThreadContract(lock_attr="_lock", handoffs={}),
        # the endpoint server: started/stopped from the driver thread
        # only; the serving thread touches the httpd object, never
        # ObsServer attributes (the former ``_httpd`` handoff entry was
        # PTA006-audited stale: no background context reads the
        # attribute — the serving thread holds the httpd OBJECT via
        # Thread(target=), it never dereferences ``self._httpd``).
        # ``slo`` IS read per /slo request by handler threads, via a
        # captured server reference the lockset pass cannot attribute
        # — the benign-race rationale (atomic reference assignment; a
        # stale read costs one 404 scrape) is documented at the read
        # site in obs/server.py
        "ObsServer": ThreadContract(lock_attr="_lock", handoffs={}),
        # the checkpoint manager (ha/checkpoint.py): capture on the
        # driver thread, serialization on the background writer; the
        # snapshot handoff is a queue.Queue of immutable-after-capture
        # snapshots (frozen dataclasses + copy-on-write arrays), and
        # the writer statistics are read/written under _lock on both
        # sides
        "CheckpointManager": ThreadContract(
            lock_attr="_lock", handoffs={}
        ),
        # the actuation journal (ha/journal.py): intents/terminal
        # marks from the driver thread, ``posted`` marks from the
        # bounded binding-POST pool — every file write holds _lock
        "ActuationJournal": ThreadContract(
            lock_attr="_lock", handoffs={}
        ),
        # the actuation outbox (ha/outbox.py): pump/drop on the
        # driver thread, enqueue ALSO from the bounded binding-POST
        # pool workers (cli _post_bindings) — the entry list is
        # guarded by _lock on every access; the lifetime counters
        # are pump-side (driver-thread) only
        "ActuationOutbox": ThreadContract(
            lock_attr="_lock", handoffs={}
        ),
        # the shadow auditor (obs/audit.py): capture on the driver
        # thread, the re-solve on the audit worker; the snapshot
        # handoff is a bounded queue.Queue of immutable-after-capture
        # snapshots, and results/counters are written and read under
        # _lock on both sides
        # (the snapshot handoff is a queue.Queue — construction-only
        # attribute, so no handoff entry is needed: the queue's own
        # lock is the happens-before edge)
        "ShadowAuditor": ThreadContract(lock_attr="_lock"),
        # the SLO engine: evaluate() on the driver thread, status()
        # on the obs server's handler threads — window state is read
        # and written under _lock on both sides
        "SloEngine": ThreadContract(lock_attr="_lock", handoffs={}),
        # watch.py's per-resource reader thread (the former ``rv``
        # handoff entry was PTA006-audited stale: the reconnect cursor
        # is reader-thread-private — construction aside, no main-thread
        # access exists, so there is no handoff to document)
        "_WatchStream": ThreadContract(
            lock_attr="_lock",
            handoffs={
                "_resp": "benign race with stop(): closing a stale "
                         "response object at worst forces one counted "
                         "reconnect; queue.Queue carries the real data",
                "seen_rv": "monotonic int advanced only after the event "
                           "is enqueued; torn reads impossible on a GIL "
                           "int, staleness means one extra wait loop",
                "last_activity": "monotonic float heartbeat; a stale "
                                 "read only delays the staleness resync "
                                 "by one tick",
                "coalesced_reconnects":
                    "monotonic int advanced only by the reader thread "
                    "(queue-suppressed reconnects during an outage); "
                    "the consumer folds deltas via a private cursor — "
                    "same GIL-int pattern as seen_rv, staleness costs "
                    "one tick of count lag, never a lost count",
            },
        ),
    },
    thread_spawn_wrappers=(
        # ops/resident.py's single-shot background download: the fn
        # passed to its constructor runs on the fetch daemon thread
        "_AsyncFetch",
    ),
    hazard_attrs=(
        # data-dependent shape/width sources: topology maxima and
        # builder counts change with live cluster state every round
        "max_prefs",
        "n_arcs",
        "n_tasks",
        "n_machines",
    ),
    floor_markers=(
        "floor",        # substring: _s_floor, ctx.p_floor, _b_floor...
        "t_min",
        "m_min",
        "p_min",
        "minimum",
    ),
    pad_sinks={
        "pad_topology": ("t_min", "m_min", "p_min"),
        "build_cost_inputs_host": ("t_min", "m_min"),
    },
    path_rules=(
        ("tests/", ("PTA000", "PTA003", "PTA005")),
    ),
    kernel_mask_contracts=_KERNEL_MASK_CONTRACTS,
    blocking_call_names=(
        # filesystem barrier: the one call whose whole point is to
        # WAIT for the platters/flash
        "fsync",
        # apiserver round-trips (apiclient/client.py surface): each is
        # an HTTP request with network latency and retry loops
        "get_pod",
        "bind_pod_to_node",
        "evict_pod",
        "bind_outcome",
        "evict_outcome",
        "list_pods",
        "list_nodes",
        "urlopen",
        "getresponse",
        "sendall",
        # solver dispatch / device sync: a round or a fetch pinned
        # under a lock serializes the daemon on kernel latency
        "run_round",
        "solve_scheduling",
        "synchronize",
        "item",
        # deliberate delay: sleeping under a lock turns an injected
        # or polled delay into a stall for every contender
        "sleep",
    ),
    kernel_loader_module="poseidon_tpu_torch/kernels/loader.py",
    plan_builders={
        "row_stream.plan": (
            ("poseidon_tpu_torch/kernels/row_stream.py::PlanCache",
             "the cache itself: a plan is made once per (device, rows, "
             "Mp, *shape) and note_build() counts it"),
        ),
        "tile_stream.plan": (),
        "gap_rows.plan": (),
        "top_will.plan": (
            ("poseidon_tpu_torch/kernels/top_will.py::PlanCache",
             "the cache itself: a plan is made once per (device, rows, "
             "Mp, smax) and note_build() counts it"),
        ),
        "seat_sort.sort_plan": (
            ("poseidon_tpu_torch/kernels/seat_sort.py::_Plans",
             "the cache itself: a plan is made once per (device, n, "
             "field widths) and note_build() counts it"),
        ),
        "seat_sort.compact_plan": (
            ("poseidon_tpu_torch/kernels/seat_sort.py::_Plans",
             "the cache itself: a plan is made once per (device, n) and "
             "note_build() counts it"),
        ),
        "make_plan": (
            ("poseidon_tpu_torch/ops/cost_scaling.py::residual_csr",
             "the residual CSR is built once a solve and carries its "
             "plan: every sweep and round of that solve reuses it"),
        ),
        # harnesses: they print or hold a plan, they launch nothing
        # with it
        "*": (
            ("tests/", "the plan tests hold a plan's arithmetic on the "
                       "CPU, one plan per case"),
            ("chip_smoke.py", "the card check prints the plans its "
                              "kernels ran with"),
            ("kernel_ab.py", "the A/B harness prints the plans it timed"),
        ),
    },
    plan_key_params={
        # the auction's loop allocates its [Mp, smax] willingness table
        # and the chains their [kmax, ...] window buffers from these:
        # a value that shrinks and grows again reallocates every time
        # (and re-captures, once graphs are captured)
        "_solve": ("smax",),
        "_resident_chain": ("n_prefs", "smax"),
        "_redensify": ("n_prefs", "smax"),
        "_express_step": ("kmax", "pk", "smax", "change_cap"),
        "_stream_chain": ("kmax", "pk", "smax", "change_cap"),
        "_solve_member": ("n_prefs", "smax"),
        "_densify": ("n_prefs",),
        "densify": ("n_prefs",),
        # the round's in-flight record carries the keys from
        # begin_round to the chain on the worker
        "InflightSolve": ("n_prefs", "smax"),
    },
    optrace_uploads=_OPTRACE_UPLOADS,
    sync_sites=_SYNC_SITES,
)
