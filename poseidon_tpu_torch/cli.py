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
- crash safety (``--checkpoint_dir``, ``--checkpoint_every``,
  ``--restore``): warm-state checkpoints written by a background thread
  and a write-ahead actuation journal, restored and replayed before the
  first observe; ``--standby=true`` follows the leader's checkpoints
  behind a lease and takes over warm (``ha/``);
- the observability tools: the flight recorder (``--flight_recorder``,
  ``--flight_dir``, ``--flight_max_dumps``), ``--explain`` at the
  loop's exit, the shadow audit (``--audit_every``) and the SLO engine
  (``--slo*``, served on ``/slo``) (``obs/``);
- a flag of a module not ported yet would parse at the reference's
  default and stop the daemon at any other value
  (``UNPORTED_FLAGS``, ``unported_flags``); none is ignored silently,
  and today the table is empty.

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
import os
import signal
import sys
import threading
import time

from poseidon_tpu_torch.apiclient.client import ApiError, K8sApiClient
from poseidon_tpu_torch.bridge import SchedulerBridge
from poseidon_tpu_torch.models import COST_MODELS, get_cost_model

log = logging.getLogger("poseidon_tpu_torch.cli")

# flags whose modules are not ported yet: name -> (the reference's
# default, type or choices, the ROADMAP.md Queue 1 item that brings it).
# They parse so the reference's flagfiles load; any other value than
# the default is refused (``unported_flags``). Every module of the
# reference is ported, so the table is empty; it stays as the place
# for a future one.
UNPORTED_FLAGS: dict[str, tuple] = {}


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
    p.add_argument("--device", default="cuda",  # noqa: PTA005 -- the port's own flag: deploy/poseidon-tpu.cfg is the reference's deployment file, which the port leaves as it is; README's port section documents it
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
    # the decision-evidence layer (obs/flightrec|replay|explain): the
    # anomaly flight recorder keeps the last K rounds' full solve
    # inputs in a bounded ring and dumps .npz + JSON on DEGRADE /
    # EXPRESS_DEGRADE / FETCH_TIMEOUT / resync storms; replay offline
    # with python -m poseidon_tpu_torch.obs.replay <dump>
    p.add_argument("--flight_recorder",
                   default="false", choices=["true", "false"],
                   help="record the last rounds' full host-side solve "
                        "inputs (graph, cost inputs, flags, warm "
                        "seed) in a bounded ring and dump it to "
                        "--flight_dir on anomalies; replay with "
                        "python -m poseidon_tpu_torch.obs.replay")
    p.add_argument("--flight_dir", default="flightrec",
                   help="directory the flight recorder writes dumps "
                        "to (.npz array blob + .json manifest per "
                        "dump)")
    p.add_argument("--explain", default="", metavar="POD_UID",
                   help="with --flight_recorder: when the loop exits, "
                        "print the per-decision cost attribution / "
                        "unscheduled diagnosis for this pod uid from "
                        "the last captured round (the on-call's 'why "
                        "did X land on Y' / 'why is Z still pending' "
                        "answer)")
    # the quality observatory (poseidon_tpu_torch/obs/): per-pod
    # lifecycle tracing rides --metrics_port for free; the shadow audit
    # re-solves a sampled cluster snapshot on a background thread (CPU
    # pricing + the subprocess oracle — never a launch on the card)
    # and publishes placement regret vs the
    # certified optimum; the SLO engine evaluates declarative
    # objectives with multi-window burn rates and latched SLO_BREACH
    # alerting
    p.add_argument("--audit_every", type=int, default=0,
                   help="shadow-audit the live placement every N "
                        "rounds on a background thread (regret vs "
                        "certified optimum, fragmentation index, "
                        "drift; poseidon_audit_* metrics); 0 = off")
    p.add_argument("--slo", default="",
                   help="comma-separated SLO objectives (grammar: "
                        "'<source> <op> <threshold> [by label=value]' "
                        "— e.g. 'e2b_p99_ms < 10 by lane=express, "
                        "regret == 0, ready'); evaluated per round "
                        "with multi-window burn rates, surfaced as "
                        "poseidon_slo_* metrics, /slo, and SLO_BREACH "
                        "trace events. Needs --metrics_port")
    p.add_argument("--slo_short_window", type=int, default=6,
                   help="SLO burn-rate short window, in completed "
                        "rounds (detection speed)")
    p.add_argument("--slo_long_window", type=int, default=60,
                   help="SLO burn-rate long window, in completed "
                        "rounds (sustained-burn confirmation)")
    p.add_argument("--slo_burn_threshold", type=float, default=1.0,
                   help="burn rate both windows must exceed to trip "
                        "the breach latch (1.0 = budget exhausts "
                        "within the window)")
    p.add_argument("--flight_max_dumps", type=int, default=16,
                   help="keep only the N most recent flight-recorder "
                        "dumps in --flight_dir (oldest-first GC, so a "
                        "flapping daemon cannot fill the disk; 0 = "
                        "unbounded)")
    # crash safety & HA (poseidon_tpu_torch/ha/): atomic warm-state
    # checkpoints + a write-ahead actuation
    # journal make a process death survivable — a restart rehydrates
    # the warm solve seed, pad floors, bridge pod state, knowledge
    # rings and watch position instead of paying a cold LIST + cold
    # solve (and, with rebalancing on, risking a migration storm)
    p.add_argument("--checkpoint_dir", default="",
                   help="directory for atomic warm-state checkpoints "
                        "(solve seed, pad floors, pod/machine state "
                        "machine, knowledge rings, builder columns, "
                        "watch resourceVersion) and the write-ahead "
                        "actuation journal; empty = crash safety off")
    p.add_argument("--checkpoint_every", type=int, default=10,
                   help="checkpoint cadence in completed rounds; the "
                        "in-round capture is a cheap host snapshot "
                        "(the warm seed is the host mirror the round's "
                        "fetch already holds), serialization + fsync "
                        "run on a background writer thread")
    p.add_argument("--restore", default="auto",
                   choices=["auto", "true", "false"],
                   help="rehydrate from the newest loadable checkpoint "
                        "in --checkpoint_dir at startup and replay "
                        "incomplete journaled actuations idempotently: "
                        "auto = when one exists, true = required "
                        "(exit 1 when none loads), false = always "
                        "cold-start")
    p.add_argument("--standby", default="false",
                   choices=["true", "false"],
                   help="HA mode: contend for the k8s Lease-style "
                        "lock on the apiserver; the holder schedules "
                        "(renewing each tick), non-holders follow "
                        "--checkpoint_dir warm and take over on lease "
                        "expiry without a cold start")
    p.add_argument("--standby_lease_s", type=float, default=15.0,
                   help="leader lease duration in seconds (renewed "
                        "every tick; a standby may take over after "
                        "this long without a renewal — keep it above "
                        "the polling period)")
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
    # (none today)
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


def _post_bindings(client, bridge, bindings: dict[str, str],
                   journal=None, seqs=None, outbox=None):
    """POST bindings concurrently (bounded): serially, a 10k-placement
    round is 10k sequential HTTP round trips — the reference has the
    same flaw (one pplx chain joined per pod, k8s_api_client.cc:225).
    Returns [(uid, machine, outcome)] with outcome in ok / rejected /
    unreachable / parked; the caller decides confirm/revoke (the
    bridge is not thread-safe, so state changes stay on the main
    thread). When an actuation journal rides along (``--checkpoint_
    dir``), each successful POST is marked ``posted`` — the caller
    must have journaled the intents (with their ``seqs``) BEFORE this
    call, that ordering is the crash-consistency contract. With an
    ``outbox``, unreachable POSTs park there (outcome "parked"): the
    pod stays confirmed, the journal intent stays open, and the
    outbox pump owns the retries — the apiserver-outage ladder."""

    def _bind(item):
        uid, machine = item
        task = bridge.tasks.get(uid)
        ns = task.namespace if task else "default"
        outcome = client.bind_outcome(uid, machine, namespace=ns)
        if outcome == "ok" and journal is not None and seqs:
            journal.posted(seqs.get(("bind", uid), 0))
        if outcome == "unreachable" and outbox is not None:
            outbox.enqueue(
                "bind", uid, machine=machine,
                seq=(seqs or {}).get(("bind", uid), 0),
                round_num=bridge.round_num,
            )
            outcome = "parked"
        return uid, machine, outcome

    workers = min(16, len(bindings))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(_bind, bindings.items()))


def _actuate_rebalance(client, bridge, migrations, preemptions, *,
                       confirm: bool, journal=None, seqs=None,
                       outbox=None):
    """Actuate MIGRATE (evict + re-bind) and PREEMPT (evict) deltas.

    ``confirm=True`` is the serial contract (state changes only after
    the POSTs land); ``confirm=False`` the optimistic pipelined one
    (the bridge already confirmed at finish time — failures restore the
    pod to its old machine and the next poll reconciles). Journaled
    like the bindings: intents must already be on disk; this marks
    posted/confirmed/failed per delta. With an ``outbox``, unreachable
    POSTs park there (the decision stands, only the wire is broken):
    the pod keeps its confirmed state, the journal intent stays open,
    and the pump replays idempotently.
    """
    def _ns(uid):
        task = bridge.tasks.get(uid)
        return task.namespace if task else "default"

    def _mark(kind, uid, phase):
        if journal is not None and seqs:
            getattr(journal, phase)(seqs.get((kind, uid), 0))

    for uid, frm in preemptions.items():
        out = client.evict_outcome(uid, namespace=_ns(uid))
        if out == "ok":
            _mark("evict", uid, "posted")
            if confirm:
                bridge.confirm_preemption(uid)
            _mark("evict", uid, "confirmed")
        elif out == "unreachable" and outbox is not None:
            if confirm:
                bridge.confirm_preemption(uid)
            outbox.enqueue(
                "evict", uid, from_machine=frm,
                seq=(seqs or {}).get(("evict", uid), 0),
                round_num=bridge.round_num,
            )
        else:
            log.warning("eviction POST failed for %s; restoring", uid)
            _mark("evict", uid, "failed")
            bridge.restore_running(uid, frm)
    for uid, (frm, to) in migrations.items():
        ns = _ns(uid)
        out = client.evict_outcome(uid, namespace=ns)
        if out == "ok":
            out = client.bind_outcome(uid, to, namespace=ns)
        if out == "ok":
            _mark("migrate", uid, "posted")
            if confirm:
                bridge.confirm_migration(uid, to)
            _mark("migrate", uid, "confirmed")
        elif out == "unreachable" and outbox is not None:
            if confirm:
                bridge.confirm_migration(uid, to)
            outbox.enqueue(
                "migrate", uid, machine=to, from_machine=frm,
                seq=(seqs or {}).get(("migrate", uid), 0),
                round_num=bridge.round_num,
            )
        else:
            log.warning("migration POSTs failed for %s; restoring", uid)
            _mark("migrate", uid, "failed")
            bridge.restore_running(uid, frm)


def _take_checkpoint(args, bridge, watcher, ckpt_mgr, journal,
                     final: bool = False) -> None:
    """Capture + hand off one warm-state checkpoint (and rotate the
    journal's terminal entries — their effects now live in the
    snapshot). The final (shutdown) checkpoint writes synchronously
    after draining the writer."""
    snap = ckpt_mgr.capture(bridge, watcher)
    bridge.trace.emit(
        "CHECKPOINT", round_num=bridge.round_num,
        detail={"cadence": args.checkpoint_every,
                "warm": snap.warm_seed is not None,
                "final": final},
    )
    bridge.trace.flush()
    if journal is not None:
        journal.rotate()
    if final:
        ckpt_mgr.close(final_snap=snap)
    else:
        ckpt_mgr.submit(snap)


def run_loop(
    args: argparse.Namespace,
    stop_event: threading.Event | None = None,
    lease=None,
    preloaded=None,
    round_hook=None,
) -> int:
    """The scheduling daemon loop.

    ``stop_event`` is the graceful-shutdown latch: SIGTERM sets it (a
    handler is installed while the loop runs on the main thread, and
    the previous one is put back on exit; embedded callers and tests
    pass their own event) and the loop then finishes the in-flight
    round, flushes its deltas, writes a final checkpoint + trace
    flush, and exits 0. ``lease`` (ha/standby.LeaderElector) is
    renewed every tick in HA mode — a failed renewal steps down with
    exit code 1 instead of scheduling against a lost lock.
    ``preloaded`` short-circuits the checkpoint read with a snapshot a
    standby already followed into memory. ``round_hook`` (tests, the
    chaos harness, chip_smoke.py) is called on the daemon loop thread
    after every completed round with ``(rounds_completed, result)``:
    the deterministic injection seam.
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
    bridge = None
    flightrec = None
    auditor = None
    ckpt_mgr = None
    journal = None
    # the final checkpoint and --explain belong to a loop that ran
    ran = False
    # bind the metrics port only once construction can no longer
    # raise; the finally below releases everything built so far
    try:
        if args.flight_recorder == "true":
            from poseidon_tpu_torch.obs import FlightRecorder

            flightrec = FlightRecorder(
                args.flight_dir, metrics=sched_metrics,
                max_dumps=args.flight_max_dumps, device=args.device,
            )
        if args.audit_every > 0:
            from poseidon_tpu_torch.obs import ShadowAuditor

            auditor = ShadowAuditor(
                metrics=sched_metrics, sample_every=args.audit_every,
            )
        # crash safety (--checkpoint_dir): the checkpoint manager + the
        # write-ahead actuation journal live side by side in one
        # directory
        if args.checkpoint_dir:
            from poseidon_tpu_torch.ha import (
                ActuationJournal,
                CheckpointManager,
            )

            ckpt_mgr = CheckpointManager(
                args.checkpoint_dir, metrics=sched_metrics,
            )
            journal = ActuationJournal(
                os.path.join(args.checkpoint_dir, "journal.jsonl")
            )
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
            flightrec=flightrec,
            auditor=auditor,
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

        def _outbox_settled(entry, outcome: str) -> None:
            # the parked actuation landed (or was already visible):
            # close its journal intent; bridge state was confirmed at
            # decision time, so nothing moves here
            if journal is not None and entry.seq:
                journal.confirmed(entry.seq)

        def _outbox_dead(entry) -> None:
            # the wire never healed for this op: give the pod back to
            # the normal failure paths — ONE aging bump for the outage
            if journal is not None and entry.seq:
                journal.failed(entry.seq)
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
            on_settled=_outbox_settled,
            on_dead_letter=_outbox_dead,
        )
        detector = OutageDetector(
            max(args.outage_threshold, 1), on_change=_outage_changed,
        ) if args.outage_threshold > 0 else OutageDetector(
            threshold=1_000_000_000  # never declares; outbox still parks
        )
        # the SLO engine reads its sources from the metrics registry
        # and emits SLO_BREACH into the bridge's trace stream
        slo_engine = None
        if args.slo:
            if sched_metrics is None:
                log.warning(
                    "--slo needs --metrics_port (the objectives read "
                    "their sources from the metrics registry); SLO "
                    "engine disabled"
                )
            else:
                from poseidon_tpu_torch.obs import SloEngine

                slo_engine = SloEngine(
                    [x for x in
                     (o.strip() for o in args.slo.split(",")) if x],
                    metrics=sched_metrics,
                    trace=bridge.trace,
                    short_window=args.slo_short_window,
                    long_window=args.slo_long_window,
                    burn_threshold=args.slo_burn_threshold,
                )
                obs_server.slo = slo_engine
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

        # ---- warm restore (--restore): rehydrate, replay, resume ------
        if ckpt_mgr is not None and args.restore == "false":
            # explicit cold start: the previous boot's state is
            # disowned, including its journal — a stale intent replayed
            # at some LATER restart against a cluster that moved on
            # could evict a healthy pod (discard logs what it drops)
            journal.discard()
        elif ckpt_mgr is not None:
            from poseidon_tpu_torch.ha import replay_journal, restore_bridge

            snap = preloaded if preloaded is not None \
                else ckpt_mgr.load_latest()
            if snap is None and args.restore == "true":
                log.error(
                    "--restore=true but no loadable checkpoint in %s",
                    args.checkpoint_dir,
                )
                return 1
            # replay incomplete journaled actuations BEFORE the first
            # observe/round — on EVERY start, checkpoint or not: the
            # journal's consistency contract is with the apiserver,
            # and a crash before the first checkpoint still leaves
            # intents that must settle exactly once (the observe path
            # then delivers their effects as ordinary events)
            outcomes = replay_journal(
                client, journal.incomplete(), journal=journal,
                trace=bridge.trace, metrics=sched_metrics,
                lifecycle=lifecycle,
            )
            if any(outcomes.values()):
                log.info("journal replay outcomes: %s", {
                    k: v for k, v in outcomes.items() if v
                })
            if snap is None:
                log.info(
                    "no checkpoint in %s; cold start", args.checkpoint_dir
                )
            else:
                restored_rv = restore_bridge(bridge, snap)
                bridge.trace.emit(
                    "RESTORE", round_num=bridge.round_num,
                    detail={
                        "round": snap.round_num,
                        "warm": snap.warm_seed is not None,
                        "rv": dict(restored_rv),
                        "checkpoint_unix": snap.created_unix,
                    },
                )
                bridge.trace.flush()
                if sched_metrics is not None:
                    sched_metrics.record_restore()
                if health is not None:
                    health.mark_restored_warm()
                if watcher is not None and restored_rv:
                    watcher.resume(restored_rv)
                log.info(
                    "warm restore: checkpoint round %d, %d tasks, %d "
                    "machines, warm_seed=%s",
                    snap.round_num, len(snap.tasks), len(snap.machines),
                    snap.warm_seed is not None,
                )

        # graceful shutdown: SIGTERM finishes the in-flight round,
        # flushes deltas + trace + a final checkpoint, and exits 0
        stop = stop_event if stop_event is not None else threading.Event()
        try:
            old_sigterm = signal.signal(
                signal.SIGTERM, lambda _s, _f: stop.set()
            )
        except ValueError:
            pass  # not the main thread: embedded callers own signals
        if obs_server is not None:
            obs_server.start()
        ran = True
        return _loop(
            args, client, bridge, watcher, outbox, detector, stop,
            health=health, sched_metrics=sched_metrics,
            stats_fh=stats_fh, incremental=incremental,
            pipelined=pipelined, express=express, stream_k=stream_k,
            round_hook=round_hook, journal=journal, ckpt_mgr=ckpt_mgr,
            flightrec=flightrec, slo_engine=slo_engine, lease=lease,
        )
    finally:
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        if watcher is not None:
            watcher.stop()
        if auditor is not None:
            auditor.stop()
        if compile_sink_set:
            # the sink slot is process-global: a later run_loop in
            # this process must not keep feeding this run's registry
            set_compile_duration_sink(None)
        if ckpt_mgr is not None and ran:
            # the final checkpoint: whatever warm state the daemon
            # held at exit survives to the next boot (or the standby)
            try:
                _take_checkpoint(
                    args, bridge, watcher, ckpt_mgr, journal, final=True
                )
            except Exception:
                log.exception("final checkpoint failed")
        if journal is not None:
            journal.close()
        if obs_server is not None:
            obs_server.stop()
        if args.explain and ran:
            _explain_at_exit(args, flightrec)
        if stats_fh:
            stats_fh.close()
        if trace_fh:
            trace_fh.close()


def _explain_at_exit(args, flightrec) -> None:
    """The operator's exit question (``--explain``): why did/didn't
    this pod place — answered from the last captured round, on the
    daemon's device."""
    if flightrec is None:
        log.error(
            "--explain needs --flight_recorder=true (the explainer "
            "reads the captured round inputs)"
        )
        return
    from poseidon_tpu_torch.obs.explain import (
        ExplainError,
        RoundExplainer,
        render_explanation,
    )

    try:
        ex = RoundExplainer.from_record(
            flightrec.last_round_record(), device=args.device
        )
        print(render_explanation(ex.explain(args.explain)))
    except ExplainError as e:
        log.error("--explain %s: %s", args.explain, e)


def _loop(args, client, bridge, watcher, outbox, detector, stop, *,
          health, sched_metrics, stats_fh, incremental, pipelined,
          express, stream_k, round_hook, journal, ckpt_mgr, flightrec,
          slo_engine, lease) -> int:
    """The ticks of ``run_loop``, after everything is built."""
    lifecycle = bridge.lifecycle

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
        if flightrec is not None:
            # stamp the applied watch position onto the next round's
            # flight record, so a dump correlates with the apiserver's
            # event history
            bridge.flight_rv = watcher.applied_rv
        return True

    def _bind_seqs(bindings: dict[str, str]) -> dict:
        """Journal bind intents (one fsync) BEFORE any POST/confirm.
        Each intent carries the pod's lifecycle event stamp (wall us)
        so a restart replay closes the pre-crash timeline."""
        if journal is None or not bindings:
            return {}
        seqs = journal.intents(
            [{"op": "bind", "uid": u, "machine": m,
              "t_event_us": (
                  lifecycle.event_wall_us(u)
                  if lifecycle is not None else 0
              )}
             for u, m in bindings.items()],
            bridge.round_num,
        )
        if lifecycle is not None:
            for uid in bindings:
                lifecycle.stamp(uid, "journal")
        return seqs

    def _rebal_seqs(migrations, preemptions) -> dict:
        if journal is None or not (migrations or preemptions):
            return {}
        ops = [
            {"op": "evict", "uid": u, "from": frm}
            for u, frm in preemptions.items()
        ] + [
            {"op": "migrate", "uid": u, "machine": to, "from": frm}
            for u, (frm, to) in migrations.items()
        ]
        return journal.intents(ops, bridge.round_num)

    def _mark_bind(seqs, uid, outcome: str) -> None:
        """Journal/detector/lifecycle marks for one pool result ("ok" /
        "rejected" / "parked" — a parked bind's intent stays OPEN: the
        outbox pump closes it when the wire heals)."""
        if outcome == "parked":
            detector.note_failure()
            return
        if outcome == "ok":
            detector.note_success()
            if lifecycle is not None:
                # stamped on the loop thread as each pool result is
                # consumed; a no-op for timelines the optimistic
                # confirm closed
                lifecycle.stamp(uid, "posted")
        if journal is not None and seqs:
            seq = seqs.get(("bind", uid), 0)
            (journal.confirmed if outcome == "ok"
             else journal.failed)(seq)

    def _post_express(result) -> None:
        """POST one express batch's bindings; rejections re-queue (the
        bridge invalidates the context, so the next full round owns
        recovery); unreachable POSTs park in the outbox with the pod
        confirmed."""
        if result is None or not result.bindings:
            return
        seqs = _bind_seqs(result.bindings)
        for uid, machine, outcome in _post_bindings(
            client, bridge, result.bindings, journal=journal,
            seqs=seqs, outbox=outbox,
        ):
            _mark_bind(seqs, uid, outcome)
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
    # (and their journal intent seqs — written at finish time, before
    # the optimistic confirms, so a checkpoint taken between rounds is
    # always consistent with the journal)
    inflight = None
    to_post: dict[str, str] = {}
    to_rebal: tuple[dict, dict] = ({}, {})
    to_post_seqs: dict = {}
    to_rebal_seqs: dict = {}
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

    def _post_and_revoke(to_post, seqs):
        """POST optimistically-confirmed bindings; rejections re-queue
        the pod as unscheduled (counted in SchedulerStats) so it is
        re-offered next round; unreachable POSTs park in the outbox
        (the pod stays confirmed — outage semantics)."""
        for uid, machine, outcome in _post_bindings(
            client, bridge, to_post, journal=journal, seqs=seqs,
            outbox=outbox,
        ):
            _mark_bind(seqs, uid, outcome)
            if outcome not in ("ok", "parked"):
                log.warning("bind POST failed for %s; re-queueing", uid)
                bridge.binding_failed(uid)

    def _flush_pending():
        """POST any deltas still queued from the last finished round."""
        nonlocal to_post, to_rebal, to_post_seqs, to_rebal_seqs
        if to_post:
            _post_and_revoke(to_post, to_post_seqs)
            to_post = {}
            to_post_seqs = {}
        if to_rebal[0] or to_rebal[1]:
            _actuate_rebalance(
                client, bridge, to_rebal[0], to_rebal[1],
                confirm=False, journal=journal, seqs=to_rebal_seqs,
                outbox=outbox,
            )
            to_rebal = ({}, {})
            to_rebal_seqs = {}

    def _finish_inflight():
        """Join the in-flight solve: journal its deltas' intents (the
        write-ahead edge — BEFORE the optimistic confirms, so a crash
        or checkpoint from here on always finds the decisions durably
        recorded), confirm optimistically, stage the POSTs."""
        nonlocal inflight, to_post, to_rebal
        nonlocal to_post_seqs, to_rebal_seqs
        result = bridge.finish_round(inflight)
        inflight = None
        to_post_seqs = _bind_seqs(result.bindings)
        to_rebal_seqs = _rebal_seqs(
            result.migrations, result.preemptions
        )
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
        if slo_engine is not None:
            # one SLO evaluation per completed round (the burn-rate
            # windows are measured in rounds)
            slo_engine.evaluate(result.stats.round_num)
        rounds += 1
        if round_hook is not None:
            round_hook(rounds, result)
        if ckpt_mgr is not None:
            ckpt_mgr.record_age()
            if rounds % max(args.checkpoint_every, 1) == 0:
                _take_checkpoint(args, bridge, watcher, ckpt_mgr, journal)
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
                # process is leaving). Whatever stays parked is covered
                # by the open journal intents — the next boot replays
                # them idempotently; without a journal the loss is
                # loud, not silent.
                outbox.pump(force=True)
                if outbox.pending or journal is None:
                    log.warning(
                        "exiting with %d actuation(s) parked in the "
                        "outbox%s", outbox.pending,
                        "" if journal is not None else
                        " and NO journal to replay them",
                    )
            return 0
        if lease is not None and not lease.renew():
            # leadership lost (partition / apiserver-side expiry): never
            # schedule against a lock someone else may hold
            log.error("lease renewal failed; stepping down")
            return 1
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
                # write-ahead: ALL of this round's intended actuations
                # hit the journal (one fsync) before the first POST goes
                # on the wire
                seqs = _bind_seqs(result.bindings)
                rebal_seqs = _rebal_seqs(
                    result.migrations, result.preemptions
                )
                if result.bindings:
                    for uid, machine, outcome in _post_bindings(
                        client, bridge, result.bindings, journal=journal,
                        seqs=seqs, outbox=outbox,
                    ):
                        _mark_bind(seqs, uid, outcome)
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
                        result.preemptions, confirm=True,
                        journal=journal, seqs=rebal_seqs, outbox=outbox,
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
    if args.standby == "true":
        from poseidon_tpu_torch.ha.standby import run_standby

        return run_standby(args)
    return run_loop(args)


if __name__ == "__main__":
    sys.exit(main())
