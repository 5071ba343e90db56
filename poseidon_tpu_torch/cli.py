"""The scheduling daemon: poll or watch loop + flag surface.

The port of ``poseidon_tpu/cli.py``: an endless loop of observe (poll
or watch) -> schedule (one resident round over the bridge) -> POST
bindings -> sleep, with the reference's flags, flagfiles and lanes
where the port has them:

- poll and watch observe (``--watch``), serial and pipelined rounds
  (``--round_pipeline``, default true: round N's auction runs on the
  solver's worker while the loop POSTs round N-1's bindings and
  observes the next tick), incremental build and warm rounds,
  preemption and rebalancing, ``--trace_log``, ``--stats_json``,
  ``--metrics_port`` (with per-pod lifecycle tracing), ``--max_rounds``,
  the apiserver-outage outbox and the round-deadline watchdog;
- ``--express_lane=true`` (with ``--watch=true``) adds the between-
  ticks fast path: the inter-tick sleep becomes an express window that
  blocks on the pods watch stream, turns small event batches into
  bindings from the warm device state between round ticks
  (``SchedulerBridge.express_batch``), and POSTs them at once; full
  rounds become serial correction passes (every
  ``--express_correction_rounds`` ticks while the context is live)
  that differential-verify express placements; anything the express
  vocabulary cannot represent (node events, stream degradation,
  oversize batches) degrades loudly to the next full round, and a
  queue deeper than ``--express_shed_queue`` sheds to the tick;
- ``--stream_windows=K`` (K > 1, with the express lane) accumulates up
  to K express windows and runs them as one stream flush with one
  result fetch (``SchedulerBridge.stream_window`` / ``stream_flush`` /
  ``stream_finish``);
- ``--serve=true`` schedules N tenant clusters (``--serve_apiservers``
  or ``--serve_tenants`` in-process fakes) through one batched
  pipeline (``service/serve.py``);
- ``--device`` (default ``cuda``) picks the solver's device; without a
  card the default raises, and ``--device=cpu`` runs on the CPU;
- the flags of modules not ported yet (standby and checkpoints, flight recorder, explainer, shadow
  audit, SLOs, the device mesh, class aggregation, preference pruning)
  are parsed so the reference's flagfiles load, and any of them given a
  value other than its default stops the daemon with an error naming
  it (``unported_flags``); none is ignored silently.

The kernel loader's first-use ``nvcc`` builds feed the compile-latency
histogram (``poseidon_xla_compile_ms``, the reference's family name)
when ``--metrics_port`` is set.

Run: ``python -m poseidon_tpu_torch.cli --k8s_apiserver_port=8080
--flow_scheduling_cost_model=quincy --max_rounds=0`` (add
``--device=cpu`` on a host without a card).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import logging
import signal
import sys
import threading
import time

from poseidon_tpu_torch.apiclient.client import ApiError, K8sApiClient
from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.models import COST_MODELS, get_cost_model

log = logging.getLogger("poseidon_tpu_torch.cli")

_BOOL = ("true", "false")

# flags whose modules are not ported yet: name -> (the reference's
# default, type or choices, the ROADMAP.md Queue 1 item that brings it).
# They parse so the reference's flagfiles load; any other value than
# the default is refused (``unported_flags``)
UNPORTED_FLAGS = {
    "flight_recorder": ("false", _BOOL, 7),
    "flight_dir": ("flightrec", str, 7),
    "flight_max_dumps": (16, int, 7),
    "explain": ("", str, 7),
    "audit_every": (0, int, 7),
    "slo": ("", str, 7),
    "slo_short_window": (6, int, 7),
    "slo_long_window": (60, int, 7),
    "slo_burn_threshold": (1.0, float, 7),
    "checkpoint_dir": ("", str, 7),
    "checkpoint_every": (10, int, 7),
    "restore": ("auto", ("auto", "true", "false"), 7),
    "standby": ("false", _BOOL, 7),
    "standby_lease_s": (15.0, float, 7),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="poseidon-tpu-torch",
        description="flow scheduler daemon on PyTorch (CUDA or CPU)",
        fromfile_prefix_chars="@",
    )
    # the reference's own flags (scheduler_integration.cc:30-33,
    # k8s_api_client.cc:39-43)
    p.add_argument("--polling_frequency", type=int, default=10_000_000,
                   help="microseconds between ticks (reference default)")
    p.add_argument("--k8s_apiserver_host", default="localhost")
    p.add_argument("--k8s_apiserver_port", type=int, default=8080)
    p.add_argument("--k8s_api_version", default="v1")
    # the Firmament flagfile surface (deploy/poseidon.cfg)
    p.add_argument("--flow_scheduling_cost_model", default="quincy",
                   help="name or the reference's integer selector "
                        f"(known: {sorted(COST_MODELS)})")
    p.add_argument("--max_tasks_per_pu", type=int, default=10)
    p.add_argument("--max_sample_queue_size", type=int, default=100)
    p.add_argument("--run_incremental_scheduler",
                   default="true", choices=["true", "false"],
                   help="reuse the device warm state across rounds")
    p.add_argument("--round_pipeline",
                   default="true", choices=["true", "false"],
                   help="overlap the in-flight solve/fetch with next-"
                        "round host work (poll, observe, binding "
                        "POSTs); false = strictly serial ticks")
    p.add_argument("--incremental_build",
                   default="true", choices=["true", "false"],
                   help="O(churn) delta graph builds across rounds; "
                        "false = full rebuild every round")
    # event-driven observe: the k8s watch protocol instead of full
    # GET /nodes + GET /pods lists every tick — the reference's
    # O(cluster) poll (k8s_api_client.cc:100-209) becomes O(churn)
    p.add_argument("--watch",
                   default="false", choices=["true", "false"],
                   help="observe the cluster via watch streams "
                        "(ADDED/MODIFIED/DELETED events from a "
                        "resourceVersion) instead of full-list polls; "
                        "falls back to a full LIST resync on 410 Gone, "
                        "decode errors, or staleness")
    p.add_argument("--watch_max_lag", type=float, default=30.0,
                   help="seconds without watch-stream activity before "
                        "degrading to a full LIST resync")
    # rebalancing: the full SchedulingDelta vocabulary (PLACE /
    # MIGRATE / PREEMPT / NOOP) — running pods get a hysteresis-
    # discounted continuation arc and a priced unscheduled arc, and
    # the solver may move or park them whenever the global cost
    # improves by more than the hysteresis
    p.add_argument("--enable_preemption",
                   default="false", choices=["true", "false"],
                   help="let rounds MIGRATE/PREEMPT running pods "
                        "(rebalancing); false = place-only, byte-"
                        "identical to the pre-rebalancing scheduler")
    p.add_argument("--migration_hysteresis", type=int, default=20,
                   help="cost discount on a running pod's continuation "
                        "arc: a migration must improve the objective "
                        "by more than this to be proposed")
    p.add_argument("--max_migrations_per_round", type=int, default=64,
                   help="churn budget: MIGRATE+PREEMPT deltas actuated "
                        "per round (0 = unlimited); excess deltas are "
                        "deferred and re-proposed next round")
    # the scale lane: lay the resident round out over a device mesh
    # and/or collapse the machine axis to equivalence classes, so the
    # dense table fits the device budget at 64k-machine / 512k-pod
    # scale instead of degrading to the CPU oracle (graph/aggregate.py,
    # parallel/)
    p.add_argument("--mesh_width", type=int, default=0,
                   help="shard the resident round's task axis over N "
                        "devices (power of two; 0 = plain single-"
                        "device layout, 1 = one-device mesh — bit-"
                        "identical results either way)")
    p.add_argument("--aggregate_classes",
                   default="false", choices=["true", "false"],
                   help="collapse the machine axis to cost-equivalence "
                        "classes before the dense solve (exact; "
                        "machines named by preference arcs stay "
                        "individually addressable); requires a "
                        "signature-pricing cost model (all registry "
                        "models except random)")
    p.add_argument("--topk_prefs", type=int, default=0,
                   help="keep only each task's K heaviest preference "
                        "arcs (0 = keep all; exact when K covers every "
                        "task's prefs, a stated approximation below "
                        "that; rebalancing continuation arcs are never "
                        "pruned)")
    # the express lane: small watch-event batches become bindings
    # BETWEEN round ticks via a device patch + bounded eps=1 repair of
    # the last round's warm dense state (ops/resident.py express lane);
    # the full resident round is demoted to a periodic correction pass
    # that differential-verifies express placements. Requires --watch
    # (events are the trigger) and runs serial ticks (the inter-tick
    # window IS the express window, so --round_pipeline — which parks a
    # solve in flight across that window — is ignored)
    p.add_argument("--express_lane",
                   default="false", choices=["true", "false"],
                   help="bind small pod-arrival batches between round "
                        "ticks by patching the warm device dense state "
                        "and running a bounded eps=1 repair; full "
                        "rounds become periodic correction passes. "
                        "Requires --watch=true; implies serial ticks")
    p.add_argument("--express_max_batch", type=int, default=16,
                   help="max pod arrivals per express dispatch (a fixed "
                        "shape); larger event bursts degrade to the "
                        "next full round")
    p.add_argument("--stream_windows", type=int, default=0,
                   help="stream-lane depth K: accumulate up to K "
                        "express windows and solve them as ONE stream "
                        "flush with ONE result fetch (0/1 = synced "
                        "per-window batches). Requires --express_lane")
    p.add_argument("--express_correction_rounds", type=int, default=1,
                   help="run the full correction round every Nth tick "
                        "while the express context is live (1 = every "
                        "tick); a degraded/invalidated express context "
                        "forces the round on the next tick")
    p.add_argument("--express_shed_queue", type=int, default=512,
                   help="overload backpressure: when the pods watch "
                        "queue holds more than this many undrained "
                        "items, the express window sheds to the tick "
                        "path (one full solve absorbs the burst) and "
                        "poseidon_express_shed_total counts it. "
                        "0 = never shed")
    # scheduling as a service: one daemon, N tenant clusters. Every
    # tenant keeps an isolated bridge/stats/trace/decision log; their
    # round solves pad into shape buckets and dispatch as one batched
    # device program with one batched fetch per bucket chunk
    # (poseidon_tpu_torch/service/)
    p.add_argument("--serve",
                   default="false", choices=["true", "false"],
                   help="multi-tenant service mode: schedule N tenant "
                        "clusters (from --serve_apiservers or "
                        "--serve_tenants fakes) through one batched "
                        "device pipeline; per-tenant state/trace/"
                        "decision logs stay isolated")
    p.add_argument("--serve_apiservers", default="",
                   help="comma list of tenant apiserver host:port "
                        "endpoints for --serve (one tenant each)")
    p.add_argument("--serve_tenants", type=int, default=0,
                   help="with --serve and no --serve_apiservers: spin "
                        "up N in-process fake-apiserver tenants with "
                        "heterogeneous synthetic workloads")
    p.add_argument("--serve_max_batch", type=int, default=64,
                   help="max tenant instances per batched bucket "
                        "dispatch; the memory budget may split a wave "
                        "into smaller chunks regardless (each chunk "
                        "is one upload + one batched fetch)")
    p.add_argument("--device", default="cuda",
                   help="the solver's torch device: cuda (default; "
                        "raises without a card), cuda:N, or cpu")
    p.add_argument("--max_solver_runtime", type=int,
                   default=1_000_000_000,
                   help="microseconds; bounds one oracle-fallback solve "
                        "AND the pipelined round's background placement "
                        "fetch (a miss degrades loudly: FETCH_TIMEOUT "
                        "trace event + stats counter, round abandoned; "
                        "the auction itself is bounded by its round "
                        "fuse; reference poseidon.cfg:14-15)")
    p.add_argument("--logtostderr", action="store_true")
    p.add_argument("--flagfile", default="",
                   help="gflags-style file of --name=value lines")
    # Firmament's solver flags, which the reference also accepts and
    # ignores so its flagfiles load unchanged (deploy/poseidon.cfg):
    # the solve is in-process (no binary, algorithm or solver log to
    # choose) and incremental change batching is subsumed by the warm
    # device re-solve
    for compat in (
        "--scheduler", "--flow_scheduling_solver",
        "--flow_scheduling_binary", "--flowlessly_algorithm",
        "--only_read_assignment_changes", "--remove_duplicate_changes",
        "--merge_changes_to_same_arc",
        "--purge_changes_before_node_removal", "--log_solver_stderr",
    ):
        # nargs="?": gflags booleans appear both bare
        # (--only_read_assignment_changes) and as --flag=value
        p.add_argument(compat, nargs="?", const="true", default=None,
                       help=argparse.SUPPRESS)
    # operational extras
    p.add_argument("--max_rounds", type=int, default=0,
                   help="exit after N scheduling rounds (0 = forever)")
    p.add_argument("--stats_json", default="",
                   help="append per-round SchedulerStats JSON lines here")
    p.add_argument("--trace_log", default="",
                   help="append cluster-trace-style scheduler events "
                        "(SUBMIT/SCHEDULE/EVICT/FINISH/ROUND) here")
    # the operational surface (poseidon_tpu_torch/obs/): a daemon-thread HTTP
    # server exposing Prometheus metrics + health, and per-phase span
    # profiling into the trace stream
    p.add_argument("--metrics_port", type=int, default=0,
                   help="serve /metrics (Prometheus text format), "
                        "/healthz (liveness) and /readyz (ready = seed "
                        "LIST applied + first round over real state done) "
                        "on "
                        "this port (0 = disabled)")
    p.add_argument("--metrics_host", default="0.0.0.0",
                   help="interface the metrics/health endpoint binds "
                        "(the endpoint is unauthenticated: bind "
                        "127.0.0.1 or the pod IP on hosts with "
                        "untrusted interfaces)")
    p.add_argument("--trace_profile",
                   default="false", choices=["true", "false"],
                   help="emit a SPAN phase-span tree per round into "
                        "the trace stream (inspect "
                        "with python -m poseidon_tpu_torch.trace report / "
                        "chrome)")
    # failure-domain survival (poseidon_tpu_torch/ha/outbox.py): the
    # mass-eviction guard's NotReady grace exit, the apiserver-outage
    # degradation ladder (actuation outbox + declared degraded=outage),
    # and the round-deadline watchdog
    p.add_argument("--node_grace_s", type=float, default=45.0,
                   help="NotReady grace window: a held implausible "
                        "node/pod snapshot shrink that persists this "
                        "many seconds is accepted as TRUE death (the "
                        "mass-eviction guard's time exit; strikes "
                        "still accept after 3 consecutive polls); "
                        "displaced RUNNING pods then drain through "
                        "the --max_migrations_per_round staged-"
                        "requeue budget. 0 = strikes-only")
    p.add_argument("--outage_threshold", type=int, default=3,
                   help="consecutive apiserver transport failures "
                        "(failed polls/LISTs, unreachable POSTs) "
                        "before declaring the degraded=outage state: "
                        "rounds keep solving from last-known state, "
                        "actuations park in the outbox, /readyz and "
                        "poseidon_outage surface the window. "
                        "0 = never declare (the outbox still parks)")
    p.add_argument("--outbox_dead_letter_s", type=float, default=120.0,
                   help="an outboxed actuation older than this dead-"
                        "letters loudly (OUTBOX_DEAD_LETTER trace + "
                        "counter) and the pod re-queues with ONE "
                        "aging bump; until then unreachable POSTs "
                        "retry with jittered backoff instead of "
                        "re-POST storms every round. 0 = age-"
                        "unbounded (an attempt-cap backstop applies "
                        "instead)")
    p.add_argument("--round_deadline_ms", type=float, default=0.0,
                   help="overload watchdog: a round whose wall span "
                        "exceeds this is a counted deadline miss; "
                        "two consecutive misses declare degraded="
                        "overload until a round meets the deadline. "
                        "0 = off")
    # the flags of modules not ported yet, at the reference's defaults
    for name, (default, kind, item) in UNPORTED_FLAGS.items():
        typed = {"choices": kind} if isinstance(kind, tuple) else {
            "type": kind}
        p.add_argument(f"--{name}", default=default, **typed,
                       help=f"not ported yet (ROADMAP.md Queue 1 item "
                            f"{item}); only the default is accepted")
    return p


def read_flagfile(path: str) -> list[str]:
    """gflags --flagfile format: one --name=value per line, # comments."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def _strip_flagfile(tokens: list[str]) -> list[str]:
    """Remove --flagfile=X and the two-token --flagfile X forms."""
    out = []
    skip = False
    for tok in tokens:
        if skip:
            skip = False
            continue
        if tok == "--flagfile":
            skip = True
            continue
        if tok.startswith("--flagfile="):
            continue
        out.append(tok)
    return out



def unported_flags(args: argparse.Namespace) -> list[str]:
    """The flags of unported modules that carry a non-default value."""
    defaults = build_parser().parse_args([])
    return sorted(
        f"--{name}" for name in UNPORTED_FLAGS
        if getattr(args, name) != getattr(defaults, name)
    )


def _unported_message(flags: list[str]) -> str:
    items = ", ".join(
        f"{f} (ROADMAP.md Queue 1 item {UNPORTED_FLAGS[f[2:]][2]})"
        for f in flags
    )
    return f"not ported to poseidon_tpu_torch yet: {items}"


def parse_args(argv: list[str]) -> argparse.Namespace:
    """Parse the command line (and ``--flagfile``); a flag of an
    unported module with a non-default value exits with an error."""
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    if args.flagfile:
        expanded = read_flagfile(args.flagfile) + _strip_flagfile(
            list(argv)
        )
        args = parser.parse_args(expanded)
    else:
        args = parser.parse_args(argv)
    bad = unported_flags(args)
    if bad:
        parser.error(_unported_message(bad))
    return args


def _post_bindings(client, bridge, bindings: dict[str, str], outbox=None):
    """POST bindings concurrently (bounded): serially, a 10k-placement
    round is 10k sequential HTTP round trips — the reference has the
    same flaw (one pplx chain joined per pod, k8s_api_client.cc:225).
    Returns [(uid, machine, outcome)] with outcome in ok / rejected /
    unreachable / parked; the caller decides confirm/revoke (the
    bridge is not thread-safe, so state changes stay on the main
    thread). With an ``outbox``, unreachable POSTs park there (outcome
    "parked"): the pod stays confirmed and the outbox pump owns the
    retries — the apiserver-outage ladder."""

    def _bind(item):
        uid, machine = item
        task = bridge.tasks.get(uid)
        ns = task.namespace if task else "default"
        outcome = client.bind_outcome(uid, machine, namespace=ns)
        if outcome == "unreachable" and outbox is not None:
            outbox.enqueue(
                "bind", uid, machine=machine, round_num=bridge.round_num,
            )
            outcome = "parked"
        return uid, machine, outcome

    workers = min(16, len(bindings))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(_bind, bindings.items()))


def _actuate_rebalance(client, bridge, migrations, preemptions, *,
                       confirm: bool, outbox=None):
    """Actuate MIGRATE (evict + re-bind) and PREEMPT (evict) deltas.

    ``confirm=True`` is the serial contract (state changes only after
    the POSTs land); ``confirm=False`` the optimistic pipelined one
    (the bridge already confirmed at finish time — failures restore the
    pod to its old machine and the next poll reconciles). With an
    ``outbox``, unreachable POSTs park there (the decision stands, only
    the wire is broken): the pod keeps its confirmed state and the pump
    replays idempotently.
    """
    def _ns(uid):
        task = bridge.tasks.get(uid)
        return task.namespace if task else "default"

    for uid, frm in preemptions.items():
        out = client.evict_outcome(uid, namespace=_ns(uid))
        if out == "ok":
            if confirm:
                bridge.confirm_preemption(uid)
        elif out == "unreachable" and outbox is not None:
            if confirm:
                bridge.confirm_preemption(uid)
            outbox.enqueue(
                "evict", uid, from_machine=frm, round_num=bridge.round_num,
            )
        else:
            log.warning("eviction POST failed for %s; restoring", uid)
            bridge.restore_running(uid, frm)
    for uid, (frm, to) in migrations.items():
        ns = _ns(uid)
        out = client.evict_outcome(uid, namespace=ns)
        if out == "ok":
            out = client.bind_outcome(uid, to, namespace=ns)
        if out == "ok":
            if confirm:
                bridge.confirm_migration(uid, to)
        elif out == "unreachable" and outbox is not None:
            if confirm:
                bridge.confirm_migration(uid, to)
            outbox.enqueue(
                "migrate", uid, machine=to, from_machine=frm,
                round_num=bridge.round_num,
            )
        else:
            log.warning("migration POSTs failed for %s; restoring", uid)
            bridge.restore_running(uid, frm)


def run_loop(
    args: argparse.Namespace,
    stop_event: threading.Event | None = None,
    round_hook=None,
) -> int:
    """The scheduling daemon loop.

    ``stop_event`` is the graceful-shutdown latch: SIGTERM sets it (a
    handler is installed while the loop runs on the main thread, and
    the previous one is put back on exit; embedded callers and tests
    pass their own event) and the loop then finishes the in-flight
    round, flushes its deltas and the trace, and exits 0.
    ``round_hook`` (tests, chip_smoke.py) is called on the daemon loop
    thread after every completed round with ``(rounds_completed,
    result)``: the deterministic injection seam.
    """
    bad = unported_flags(args)
    if bad:
        raise NotImplementedError(_unported_message(bad))
    # an unknown or unported cost model raises here, once, instead of
    # failing every round
    get_cost_model(args.flow_scheduling_cost_model)
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr if args.logtostderr else None,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    client = K8sApiClient(
        args.k8s_apiserver_host,
        args.k8s_apiserver_port,
        args.k8s_api_version,
        timeout_s=10.0,
    )
    trace = None
    trace_fh = None
    if args.trace_log:
        from poseidon_tpu_torch.trace import TraceGenerator

        trace_fh = open(args.trace_log, "a")
        trace = TraceGenerator(sink=trace_fh)
    # the observability stack (--metrics_port): metrics registry +
    # health latch + endpoint server; the bridge/solver/watcher record
    # into it at finish/actuate time from values they already hold
    obs_server = None
    health = None
    sched_metrics = None
    lifecycle = None
    compile_sink_set = False
    if args.metrics_port:
        from poseidon_tpu_torch.guards import set_compile_duration_sink
        from poseidon_tpu_torch.obs import (
            HealthState,
            LifecycleTracker,
            MetricsRegistry,
            ObsServer,
            SchedulerMetrics,
            build_info,
        )

        sched_metrics = SchedulerMetrics(MetricsRegistry())
        # the latch owns the poseidon_ready gauge: both flip under one
        # lock, so /readyz and /metrics can never disagree mid-scrape
        health = HealthState(ready_gauge=sched_metrics.ready)
        # build identity: the poseidon_build_info gauge + the /healthz
        # JSON echo (one startup-time resolution, never the hot path)
        binfo = build_info(mesh_width=args.mesh_width, device=args.device)
        sched_metrics.set_build_info(binfo)
        obs_server = ObsServer(
            sched_metrics.registry, health, port=args.metrics_port,
            host=args.metrics_host, build=binfo,
        )
        # per-pod lifecycle tracing and the kernels' first-use build
        # latency ride the metrics surface
        lifecycle = LifecycleTracker(sched_metrics)
        compile_sink_set = set_compile_duration_sink(
            sched_metrics.record_compile
        )
    stats_fh = None
    watcher = None
    old_sigterm = None
    # bind the metrics port only once construction can no longer
    # raise; the finally below releases everything built so far
    try:
        bridge = SchedulerBridge(
            cost_model=args.flow_scheduling_cost_model,
            max_tasks_per_machine=args.max_tasks_per_pu,
            sample_queue_size=args.max_sample_queue_size,
            trace=trace,
            solver_timeout_s=args.max_solver_runtime / 1e6,
            incremental_build=args.incremental_build == "true",
            enable_preemption=args.enable_preemption == "true",
            migration_hysteresis=args.migration_hysteresis,
            max_migrations_per_round=args.max_migrations_per_round,
            mesh_width=args.mesh_width,
            aggregate_classes=args.aggregate_classes == "true",
            topk_prefs=args.topk_prefs,
            shrink_grace_s=args.node_grace_s,
            metrics=sched_metrics,
            profile_spans=args.trace_profile == "true",
            lifecycle=lifecycle,
            express_lane=args.express_lane == "true",
            express_max_batch=args.express_max_batch,
            stream_windows=args.stream_windows,
            device=args.device,
        )
        # ---- the failure-domain ladder --------------------------------
        # actuation outbox: unreachable POSTs park with jittered backoff
        # + a dead-letter bound instead of per-round re-POST storms; the
        # outage detector declares degraded=outage at
        # --outage_threshold consecutive transport failures (rounds
        # keep solving from last-known state); the round-deadline
        # watchdog declares degraded=overload on consecutive
        # --round_deadline_ms misses
        from poseidon_tpu_torch.ha import ActuationOutbox, OutageDetector

        def _outage_changed(active: bool) -> None:
            bridge.trace.emit(
                "OUTAGE", round_num=bridge.round_num,
                detail={"phase": "begin" if active else "end",
                        "outbox_pending": outbox.pending},
            )
            bridge.trace.flush()
            if sched_metrics is not None:
                sched_metrics.record_outage(active)
            if health is not None:
                health.set_degraded("outage", active)

        def _outbox_dead(entry) -> None:
            # the wire never healed for this op: give the pod back to
            # the normal failure paths — ONE aging bump for the outage
            bridge.trace.emit(
                "OUTBOX_DEAD_LETTER", task=entry.uid,
                machine=entry.machine, round_num=bridge.round_num,
                detail={"op": entry.op, "attempts": entry.attempts,
                        "from": entry.from_machine},
            )
            bridge.trace.flush()
            if entry.op == "bind":
                bridge.binding_failed(entry.uid)
            else:  # evict/migrate: apiserver's last-known truth wins
                bridge.restore_running(entry.uid, entry.from_machine)

        outbox = ActuationOutbox(
            client,
            dead_letter_s=args.outbox_dead_letter_s,
            metrics=sched_metrics,
            on_dead_letter=_outbox_dead,
        )
        detector = OutageDetector(
            max(args.outage_threshold, 1), on_change=_outage_changed,
        ) if args.outage_threshold > 0 else OutageDetector(
            threshold=1_000_000_000  # never declares; outbox still parks
        )
        incremental = args.run_incremental_scheduler == "true"
        pipelined = args.round_pipeline == "true"
        stats_fh = open(args.stats_json, "a") if args.stats_json else None
        if args.watch == "true":
            from poseidon_tpu_torch.apiclient.watch import ClusterWatcher

            watcher = ClusterWatcher(
                client,
                trace=bridge.trace,
                max_lag_s=args.watch_max_lag,
                metrics=sched_metrics,
            )
        express = args.express_lane == "true"
        if express and watcher is None:
            log.warning(
                "--express_lane needs --watch=true (watch events are the "
                "express trigger); express lane disabled"
            )
            express = False
        if express and pipelined:
            # the pipeline parks a solve in flight across the inter-tick
            # window — exactly where the express lane lives; serial
            # correction rounds replace it
            log.info(
                "--express_lane runs serial correction rounds; "
                "--round_pipeline ignored"
            )
            pipelined = False
        if express and not incremental:
            log.warning(
                "--express_lane needs warm device state "
                "(--run_incremental_scheduler=true); every express batch "
                "will degrade to the round path"
            )
        stream_k = max(args.stream_windows, 0)
        if stream_k > 1 and not express:
            log.warning(
                "--stream_windows needs --express_lane=true (the stream "
                "lane runs express windows); streaming disabled"
            )
            stream_k = 0
        # the lane label every round's stats carry (the metrics/report
        # grouping key)
        lane = (
            ("stream" if stream_k > 1 else "express") if express
            else "watch" if watcher is not None else "poll"
        ) + ("+pipelined" if pipelined else "")
        if args.mesh_width:
            lane += "+sharded"
        if args.aggregate_classes == "true":
            lane += "+agg"
        bridge.lane = lane

        # graceful shutdown: SIGTERM finishes the in-flight round,
        # flushes deltas + trace, and exits 0
        stop = stop_event if stop_event is not None else threading.Event()
        try:
            old_sigterm = signal.signal(
                signal.SIGTERM, lambda _s, _f: stop.set()
            )
        except ValueError:
            pass  # not the main thread: embedded callers own signals
        if obs_server is not None:
            obs_server.start()
        return _loop(
            args, client, bridge, watcher, outbox, detector, stop,
            health=health, sched_metrics=sched_metrics,
            stats_fh=stats_fh, incremental=incremental,
            pipelined=pipelined, express=express, stream_k=stream_k,
            round_hook=round_hook,
        )
    finally:
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        if watcher is not None:
            watcher.stop()
        if compile_sink_set:
            # the sink slot is process-global: a later run_loop in
            # this process must not keep feeding this run's registry
            set_compile_duration_sink(None)
        if obs_server is not None:
            obs_server.stop()
        if stats_fh:
            stats_fh.close()
        if trace_fh:
            trace_fh.close()


def _loop(args, client, bridge, watcher, outbox, detector, stop, *,
          health, sched_metrics, stats_fh, incremental, pipelined,
          express, stream_k, round_hook) -> int:
    """The ticks of ``run_loop``, after everything is built."""

    def _note_read_success() -> None:
        """A read (poll/LIST) succeeded. That proves the READ path
        only: while actuations are still parked in the outbox, the
        outage is not over (reads-OK/writes-down apiservers exist), so
        clearing here would flap the declared state. A successful
        WRITE-path interaction clears via detector.note_success at its
        own sites."""
        if outbox.pending == 0:
            detector.note_success()

    def _observe_tick() -> bool:
        """One tick's cluster observation; False = skip the tick
        (unless an outage is declared — then the loop keeps rounding
        from last-known state). Feeds the outage detector: every real
        apiserver interaction counts, success or transport failure."""
        if watcher is None:
            try:
                nodes = client.all_nodes()
                pods = client.all_pods()
            except ApiError as e:
                log.error("poll failed, skipping tick: %s", e)
                detector.note_failure()
                return False
            _note_read_success()
            bridge.observe_nodes(nodes)
            bridge.observe_pods(pods)
            return True
        try:
            delta = watcher.tick()
        except ApiError as e:
            log.error("watch sync failed, skipping tick: %s", e)
            detector.note_failure()
            return False
        if delta.resynced:
            # a resync performed real LISTs; full snapshot: replay the
            # poll-diff path (mass-eviction guard included)
            _note_read_success()
            bridge.observe_nodes(delta.nodes)
            bridge.observe_pods(delta.pods)
        else:
            for typ, machine in delta.node_events:
                bridge.observe_node_event(typ, machine)
            if express:
                # express lane on: pod events go through the batch
                # path so the device context is patched (or degraded
                # loudly) in lockstep with bridge state — events that
                # can still bind do so even at tick time
                _post_express(bridge.express_batch(delta.pod_events))
            else:
                for typ, task in delta.pod_events:
                    bridge.observe_pod_event(typ, task)
        bridge.note_watch_activity(delta.resyncs, delta.reconnects)
        return True

    def _mark_bind(uid, outcome: str) -> None:
        """Detector/lifecycle marks for one pool result ("ok" /
        "rejected" / "parked")."""
        if outcome == "parked":
            detector.note_failure()
        elif outcome == "ok":
            detector.note_success()
            if bridge.lifecycle is not None:
                # stamped on the loop thread as each pool result is
                # consumed; a no-op for timelines the optimistic
                # confirm closed
                bridge.lifecycle.stamp(uid, "posted")

    def _post_express(result) -> None:
        """POST one express batch's bindings; rejections re-queue (the
        bridge invalidates the context, so the next full round owns
        recovery); unreachable POSTs park in the outbox with the pod
        confirmed."""
        if result is None or not result.bindings:
            return
        for uid, machine, outcome in _post_bindings(
            client, bridge, result.bindings, outbox=outbox,
        ):
            _mark_bind(uid, outcome)
            if outcome in ("ok", "parked"):
                bridge.confirm_binding(uid, machine)
            else:
                log.warning(
                    "express bind POST failed for %s; re-queueing", uid
                )
                bridge.binding_failed(uid)

    def _express_window(window_s: float) -> None:
        """The inter-tick express window: turn small watch-event
        batches into bindings until the window closes or something
        outside the express vocabulary arrives (node events, stream
        degradation — the next tick's observe handles those with the
        full resync/mass-eviction guards)."""
        deadline = time.monotonic() + window_s
        while True:
            if stop.is_set():
                return  # shutdown: the loop top finishes the round
            wait = deadline - time.monotonic()
            if wait <= 0:
                return
            ev = watcher.express_poll(
                wait, max_events=args.express_max_batch,
                shed_queue=args.express_shed_queue,
            )
            if ev.shed:
                # overload backpressure: the queued burst outgrew the
                # express lane — loudly hand it to the tick's single
                # full solve
                log.warning(
                    "express window shed to tick: pods stream queue "
                    "exceeds --express_shed_queue=%d",
                    args.express_shed_queue,
                )
                if sched_metrics is not None:
                    sched_metrics.record_express_shed()
            if ev.reconnects:
                bridge.note_watch_activity(0, ev.reconnects)
            if ev.pod_events:
                # always apply consumed pod events, even when the poll
                # also requests a tick (node event / stream degradation
                # mid-drain): express_poll already advanced the shared
                # resourceVersion past them, so tick() would skip them
                # as replayed history. express_batch applies them
                # through the same observe transitions whether or not
                # a placement happens.
                _post_express(
                    bridge.express_batch(
                        ev.pod_events, t_event=ev.t_first,
                        t_events=ev.t_events,
                    )
                )
            if ev.needs_tick:
                return

    def _stream_drain() -> None:
        """Join the in-flight stream batch and flush+join whatever is
        still pending, POSTing every binding — the tick path must start
        with no stream work in flight (begin_round abandons it, and
        abandoned windows wait a whole round)."""
        _post_express(bridge.stream_finish())
        if bridge.solver.stream_pending_windows:
            bridge.stream_flush()
            _post_express(bridge.stream_finish())

    def _stream_window(window_s: float) -> None:
        """The inter-tick stream window (--stream_windows K > 1):
        accumulate up to K coalesced express windows and run them as ONE
        stream flush with ONE result fetch. Under a backlogged stream
        consecutive batches pipeline — batch k+1's event uploads happen
        while batch k runs on the solver's worker; a dry stream flushes
        short so placements never sit on accumulated windows until the
        tick."""
        deadline = time.monotonic() + window_s
        while True:
            if stop.is_set():
                _stream_drain()
                return
            wait = deadline - time.monotonic()
            if wait <= 0:
                _stream_drain()
                return
            if bridge.solver.stream_inflight:
                # a flush is in flight: sub-poll so its join (and the
                # bindings' POSTs) lands within ms of the fetch
                wait = min(wait, 0.005)
            evs = watcher.express_poll_windows(
                wait, max_events=args.express_max_batch,
                windows=stream_k,
                shed_queue=args.express_shed_queue,
            )
            for ev in evs:
                if ev.shed:
                    log.warning(
                        "stream window shed to tick: pods stream "
                        "queue exceeds --express_shed_queue=%d",
                        args.express_shed_queue,
                    )
                    if sched_metrics is not None:
                        sched_metrics.record_express_shed()
                if ev.reconnects:
                    bridge.note_watch_activity(0, ev.reconnects)
                if ev.pod_events:
                    bridge.stream_window(
                        ev.pod_events, t_event=ev.t_first,
                        t_events=ev.t_events,
                    )
                if bridge.solver.stream_pending_windows >= stream_k:
                    # batch full: join the previous flush (its windows
                    # ran while these uploaded), then start this one
                    _post_express(bridge.stream_finish())
                    bridge.stream_flush()
            if evs and (evs[-1].needs_tick or evs[-1].shed):
                _stream_drain()
                return
            if not any(ev.pod_events for ev in evs):
                # idle poll: join the in-flight batch and flush any
                # short remainder
                _post_express(bridge.stream_finish())
                if bridge.solver.stream_pending_windows:
                    bridge.stream_flush()

    rounds = 0
    # round-pipeline state: at most one solve in flight across ticks,
    # plus the finished-but-not-yet-POSTed deltas of the last round
    inflight = None
    to_post: dict[str, str] = {}
    to_rebal: tuple[dict, dict] = ({}, {})
    # express-lane demotion state: full rounds become a periodic
    # correction pass (every --express_correction_rounds ticks) while
    # the express context is live; a dead context forces the round
    ticks_since_round = 0

    def _log_round(result):
        s = result.stats
        s.outbox_pending = outbox.pending
        log.info(
            "round %d: pending=%d placed=%d unsched=%d cost=%d "
            "backend=%s build=%s solve=%.1fms total=%.1fms "
            "overlap=%.1fms",
            s.round_num, s.pods_pending, s.pods_placed,
            s.pods_unscheduled, s.cost, s.backend,
            s.build_mode or "-", s.solve_ms, s.total_ms, s.overlap_ms,
        )
        if stats_fh:
            stats_fh.write(json.dumps(vars(s)) + "\n")
            stats_fh.flush()

    def _post_and_revoke(to_post):
        """POST optimistically-confirmed bindings; rejections re-queue
        the pod as unscheduled (counted in SchedulerStats) so it is
        re-offered next round; unreachable POSTs park in the outbox
        (the pod stays confirmed — outage semantics)."""
        for uid, machine, outcome in _post_bindings(
            client, bridge, to_post, outbox=outbox,
        ):
            _mark_bind(uid, outcome)
            if outcome not in ("ok", "parked"):
                log.warning("bind POST failed for %s; re-queueing", uid)
                bridge.binding_failed(uid)

    def _flush_pending():
        """POST any deltas still queued from the last finished round."""
        nonlocal to_post, to_rebal
        if to_post:
            _post_and_revoke(to_post)
            to_post = {}
        if to_rebal[0] or to_rebal[1]:
            _actuate_rebalance(
                client, bridge, to_rebal[0], to_rebal[1],
                confirm=False, outbox=outbox,
            )
            to_rebal = ({}, {})

    def _finish_inflight():
        """Join the in-flight solve, confirm optimistically, stage the
        POSTs."""
        nonlocal inflight, to_post, to_rebal
        result = bridge.finish_round(inflight)
        inflight = None
        # optimistic confirm: the next build sees the new placements
        # now; the POSTs follow in the overlap window and a failure
        # re-queues/restores
        for uid, machine in result.bindings.items():
            bridge.confirm_binding(uid, machine)
        for uid, (_frm, to) in result.migrations.items():
            bridge.confirm_migration(uid, to)
        for uid in result.preemptions:
            bridge.confirm_preemption(uid)
        to_post = dict(result.bindings)
        to_rebal = (dict(result.migrations), dict(result.preemptions))
        return result

    # overload watchdog state: consecutive round-deadline misses
    # (>= 2 declares degraded=overload; a met deadline clears it)
    deadline_misses = 0
    overloaded = False

    def _watchdog(stats) -> None:
        """Round-deadline watchdog: degrade (declared overload state,
        express windows shed to tick) rather than wedge."""
        nonlocal deadline_misses, overloaded
        if args.round_deadline_ms <= 0:
            return
        if stats.wall_ms > args.round_deadline_ms:
            deadline_misses += 1
            bridge.trace.emit(
                "ROUND_DEADLINE_MISS", round_num=stats.round_num,
                detail={"wall_ms": round(stats.wall_ms, 3),
                        "deadline_ms": args.round_deadline_ms,
                        "consecutive": deadline_misses},
            )
            bridge.trace.flush()
            if deadline_misses >= 2 and not overloaded:
                overloaded = True
                log.warning(
                    "round deadline missed %d times in a row "
                    "(%.1fms > %.1fms); declaring degraded=overload",
                    deadline_misses, stats.wall_ms,
                    args.round_deadline_ms,
                )
                if health is not None:
                    health.set_degraded("overload", True)
            if sched_metrics is not None:
                sched_metrics.record_deadline_miss(overloaded)
        else:
            deadline_misses = 0
            if overloaded:
                overloaded = False
                log.info("round met its deadline; overload cleared")
                if health is not None:
                    health.set_degraded("overload", False)
                if sched_metrics is not None:
                    sched_metrics.record_overload_cleared()

    def _round_done(result, flush):
        """Log + count one completed round; True = max_rounds reached
        (any not-yet-POSTed deltas are flushed before exiting)."""
        nonlocal rounds
        _log_round(result)
        _watchdog(result.stats)
        if health is not None:
            # /readyz flips once a round over real observed state
            # landed — proven-empty counts
            health.mark_round(result.stats.backend)
        if sched_metrics is not None:
            # live device memory of the solver's device (a CPU device
            # publishes nothing); allocator bookkeeping, outside the
            # round window by design
            sched_metrics.record_live_hbm(bridge.solver.device)
        rounds += 1
        if round_hook is not None:
            round_hook(rounds, result)
        if args.max_rounds and rounds >= args.max_rounds:
            if flush:
                _flush_pending()
            return True
        return False

    while True:
        if stop.is_set():
            # graceful shutdown: finish what is in flight, flush the
            # staged deltas
            log.info("shutdown requested; finishing in-flight round")
            if inflight is not None:
                try:
                    _log_round(_finish_inflight())
                except Exception:
                    log.exception("in-flight round failed during shutdown")
                    bridge.cancel_round(inflight)
                    inflight = None
            _flush_pending()
            if outbox.pending:
                # one immediate best-effort drain (backoff ignored: the
                # process is leaving); whatever stays parked is lost,
                # loudly
                outbox.pump(force=True)
                if outbox.pending:
                    log.warning(
                        "exiting with %d actuation(s) parked in the "
                        "outbox", outbox.pending,
                    )
            return 0
        tick_start = time.perf_counter()
        if outbox.pending:
            # retry parked actuations (jittered backoff per entry; one
            # probe failure aborts the pump). A settle proves the
            # apiserver reachable again.
            counts = outbox.pump()
            if (counts["replayed"] or counts["already-applied"]
                    or counts["stale"]):
                detector.note_success()
        observed = _observe_tick()
        if not observed and not detector.active:
            time.sleep(args.polling_frequency / 1e6)
            continue
        # declared outage: keep rounding from last-known state
        if observed and health is not None:
            health.mark_seeded()
        if not incremental and not pipelined:
            bridge.warm_state = None
        try:
            if pipelined:
                # finish the solve dispatched last tick (its auction
                # ran while we slept/polled/observed), then start this
                # tick's round and POST the finished round's deltas
                # while the new solve is in flight
                if inflight is not None:
                    result = _finish_inflight()
                    if _round_done(result, True):
                        return 0
                if not incremental:
                    # AFTER finish_round (which commits the fresh warm
                    # handle) and before the next dispatch
                    bridge.warm_state = None
                ir = bridge.begin_round()
                if ir.result is not None:
                    # empty round: completed synchronously
                    if _round_done(ir.result, True):
                        return 0
                else:
                    inflight = ir
                _flush_pending()
            elif (
                express and bridge.solver.express_ready
                and ticks_since_round + 1
                < max(args.express_correction_rounds, 1)
            ):
                # express context live and no correction due this tick:
                # the round is skipped, the express window below keeps
                # binding between ticks
                ticks_since_round += 1
            else:
                ticks_since_round = 0
                result = bridge.run_scheduler()
                if result.bindings:
                    for uid, machine, outcome in _post_bindings(
                        client, bridge, result.bindings, outbox=outbox,
                    ):
                        _mark_bind(uid, outcome)
                        if outcome in ("ok", "parked"):
                            # parked: the decision stands, the outbox
                            # owns the wire (a dead-letter revokes and
                            # re-queues later)
                            bridge.confirm_binding(uid, machine)
                        else:
                            bridge.binding_failed(uid)
                if result.migrations or result.preemptions:
                    _actuate_rebalance(
                        client, bridge, result.migrations,
                        result.preemptions, confirm=True, outbox=outbox,
                    )
                if _round_done(result, False):
                    return 0
        except Exception:
            # a failed round (oracle timeout, device fault, a worker's
            # exception) must not kill the daemon: it is logged, the
            # round is abandoned, and state is rebuilt from the next
            # poll
            log.exception("scheduling round failed; skipping tick")
            if inflight is not None:
                bridge.cancel_round(inflight)
                inflight = None
            # deltas confirmed before the failure must still reach the
            # apiserver
            try:
                _flush_pending()
            except Exception:
                log.exception("deferred delta POSTs failed")
            time.sleep(args.polling_frequency / 1e6)
            continue
        elapsed = time.perf_counter() - tick_start
        remaining = max(args.polling_frequency / 1e6 - elapsed, 0.0)
        if express and remaining > 0 and not overloaded:
            # the inter-tick sleep IS the express window: block on the
            # pods watch stream and bind arrivals at once. Declared
            # overload skips the window — the tick path absorbs the
            # backlog in one solve.
            if stream_k > 1:
                _stream_window(remaining)
            else:
                _express_window(remaining)
        else:
            time.sleep(remaining)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.serve == "true":
        from poseidon_tpu_torch.service.serve import run_serve

        return run_serve(args)
    return run_loop(args)


if __name__ == "__main__":
    sys.exit(main())
