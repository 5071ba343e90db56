"""Scheduler event trace: the TraceGenerator analog.

The reference wires a ``TraceGenerator`` + injected ``WallTime`` into its
scheduler so Firmament can emit Google-cluster-trace-style event logs
(reference src/firmament/scheduler_bridge.{h,cc}:29,31,36,42; SURVEY
§5.1). Here the trace is a first-class JSONL stream: one object per
scheduler event, with an injectable clock so tests are deterministic.

Event types mirror the cluster-trace vocabulary: SUBMIT (pod observed),
SCHEDULE (placement decision), MIGRATE (rebalancing move, ``detail.
from`` names the old machine), PREEMPT (rebalancing park), EVICT (node
loss), FINISH (pod retired), WATCH_RESYNC (the watch subsystem degraded
to a full LIST resync — ``detail.reason`` names why: 410 Gone, decode
error, or staleness), WATCH_RECONNECT (an error-path watch-stream
reconnect, ``detail.resource``/``detail.reason``), FETCH_TIMEOUT
(the pipelined round's background placement fetch missed its
``--max_solver_runtime`` deadline; the round is abandoned loudly) and
DEGRADE (the dense lane fell back to the CPU oracle this round —
``detail.why`` names the guard: memory-envelope, cost-domain, or
uncertified; counted in ``SchedulerStats.degrades_total``). The
express lane (``--express_lane``) adds EXPRESS_PLACE (a pod bound
between round ticks by the device incremental re-solve),
EXPRESS_CORRECTED (the periodic correction round moved an express
placement — the differential-verify outcome), and EXPRESS_DEGRADE (an
express batch fell back to the round path, ``detail.why`` names the
guard that fired). The crash-safety layer (``--checkpoint_dir``,
poseidon_tpu_torch/ha/) adds CHECKPOINT (a warm-state snapshot captured),
RESTORE (the daemon rehydrated from a checkpoint at startup —
``detail.warm`` says whether the solve seed survived) and
JOURNAL_REPLAY (an incomplete journaled actuation replayed
idempotently on restart, ``detail.op``/``detail.outcome``),
The failure-domain layer adds EVICTION_GUARD_HOLD /
EVICTION_GUARD_RELEASE (the mass-eviction guard holding or releasing
an implausible snapshot shrink — release ``detail.outcome`` is
"accepted" true-death or "recovered"), OUTAGE (the apiserver-outage
degradation ladder flipping, ``detail.phase`` begin/end),
OUTBOX_DEAD_LETTER (an outboxed actuation exhausted its retry budget)
and ROUND_DEADLINE_MISS (the overload watchdog: a round's wall span
exceeded ``--round_deadline_ms``),
plus ROUND records carrying the per-phase timing/stat payload
(``SchedulerStats`` as a dict — including the round-pipeline timers:
``build_mode`` delta/full/legacy, ``dispatch_ms``, ``fetch_wait_ms``,
``overlap_ms``, ``wall_ms``; ``total_ms`` is the host critical path,
excluding the overlap window where the loop worked on other rounds)
and SPAN records carrying a structured per-phase span tree for a round
or express batch (``--trace_profile``; the tree schema lives in
``poseidon_tpu_torch/obs/spans.py``, the consumers are the Chrome-trace
exporter and ``python -m poseidon_tpu_torch.trace report``).

**Clock contract.** ``timestamp_us`` is WALL-clock microseconds
(``time.time()`` by default): it exists to correlate events across
hosts and with apiserver/audit logs, and it is NOT safe to difference —
NTP steps/slews make wall-clock intervals lie. Every DURATION in the
stream (the ROUND record's ``*_ms`` timers, SPAN ``dur_ms``/``off_ms``
values, EXPRESS_PLACE ``e2b_ms``) is therefore measured by the
producers on the monotonic clock family (``time.monotonic`` /
``time.perf_counter``) and shipped as an already-computed value.
Consumers: read durations from the payloads, never from timestamp
deltas. An injected ``clock_us`` (tests) replaces only the timestamp
source.

Pipelined rounds (bridge ``begin_round``/``finish_round``) emit their
ROUND record at finish time, so a round's SCHEDULE/ROUND events may
interleave with the NEXT round's SUBMIT events in the stream;
``read_trace`` does the ``round_num`` ordering for consumers.

Command line: ``python -m poseidon_tpu_torch.trace report <file>`` renders
the operator's one-pager (round-latency percentiles by lane/build
mode, express event-to-bind percentiles, degrade/resync/timeout
tallies with reasons, placement-churn summary; ``--json`` for the raw
data model), and ``python -m poseidon_tpu_torch.trace chrome <file>`` writes
a Chrome-trace/Perfetto JSON of the SPAN events.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import time
from typing import Callable, IO

log = logging.getLogger(__name__)

# The DECLARED event vocabulary. Consumers key on these names, so an
# emit outside the set is a silent contract break for every downstream
# trace reader: the static pass (analysis/rules.py PTA005) checks every
# ``*.emit("NAME")`` call site against this set, and ``emit`` enforces
# it at runtime. Extending the vocabulary = adding the name here (and
# documenting it in the module docstring above).
EVENT_TYPES = frozenset({
    "SUBMIT",           # pod observed
    "SCHEDULE",         # placement decision
    "MIGRATE",          # rebalancing move
    "PREEMPT",          # rebalancing park
    "EVICT",            # node loss
    "FINISH",           # pod retired
    "ROUND",            # per-round stats payload
    "WATCH_RESYNC",     # watch degraded to a full LIST resync
    "WATCH_RECONNECT",  # error-path watch-stream reconnect
    "FETCH_TIMEOUT",    # pipelined placement fetch missed its deadline
    "DEGRADE",          # dense lane degraded this round to the oracle
    "EXPRESS_PLACE",    # express-lane placement between round ticks
    "EXPRESS_CORRECTED",  # correction round moved an express placement
    "EXPRESS_DEGRADE",  # express batch fell back to the round path
    "STREAM_FLUSH",     # one stream-lane flush: K accumulated windows
                        # scanned as one device program with ONE fetch
                        # (detail.windows/placements/fetches/
                        # failed_window; ops/resident.py stream lane)
    "SPAN",             # per-round/per-batch phase span tree
                        # (--trace_profile; obs/spans.py schema)
    "FLIGHTREC_DUMP",   # the anomaly flight recorder wrote a dump
                        # (detail.reason names the trigger, detail.path
                        # the manifest; obs/flightrec.py)
    "CHECKPOINT",       # a warm-state checkpoint was captured
                        # (ha/checkpoint.py; detail.round/cadence)
    "RESTORE",          # the daemon rehydrated from a checkpoint at
                        # startup (detail.round/warm/rv)
    "JOURNAL_REPLAY",   # an incomplete journaled actuation was
                        # replayed idempotently on restart
                        # (ha/journal.py; detail.op/outcome)
    "SLO_BREACH",       # an SLO burn-rate alert latched (obs/slo.py;
                        # detail.slo names the objective spec,
                        # detail.burn_short/burn_long the rates —
                        # emitted exactly once per breach window)
    "EVICTION_GUARD_HOLD",     # the mass-eviction guard held an
                               # implausible snapshot shrink
                               # (detail.kind node|pod, detail.gone/
                               # known/strike)
    "EVICTION_GUARD_RELEASE",  # the guard released: detail.outcome is
                               # "accepted" (the shrink persisted past
                               # the strike/grace bound and was honored
                               # as true death; the displaced-pod
                               # staging shows up as EVICT events and
                               # SchedulerStats.requeue_admitted/
                               # displaced_parked) or "recovered" (the
                               # snapshot healed); detail carries kind/
                               # gone/known/strikes/held_s
    "OUTAGE",           # the apiserver-outage ladder flipped: detail.
                        # phase is "begin" (consecutive transport
                        # failures crossed --outage_threshold; rounds
                        # keep solving from last-known state, POSTs
                        # park in the actuation outbox) or "end"
                        # (first success; the outbox replays)
    "OUTBOX_DEAD_LETTER",  # an outboxed actuation exhausted its retry
                           # budget (detail.op/uid/attempts); the pod
                           # is re-queued through binding_failed
    "ROUND_DEADLINE_MISS",  # a round's wall span exceeded
                            # --round_deadline_ms (detail.wall_ms);
                            # consecutive misses declare
                            # degraded=overload and shed the express
                            # window to the tick path
})


@dataclasses.dataclass
class TraceEvent:
    timestamp_us: int
    event: str              # one of EVENT_TYPES
    task: str = ""
    machine: str = ""
    round_num: int = 0
    detail: dict | None = None
    # which tenant's session emitted this (the service lane writes all
    # tenants' streams into ONE file; "" = single-tenant daemon)
    tenant: str = ""


class TraceGenerator:
    """Appends one JSON object per line to ``sink`` (file-like).

    ``tenant`` stamps every emitted event (the reference's service lane
    gives each tenant session its own generator over one shared sink;
    "" here), and ``python -m poseidon_tpu_torch.trace report --tenant
    <id>`` filters on the stamp."""

    def __init__(
        self,
        sink: IO[str] | None = None,
        clock_us: Callable[[], int] | None = None,
        buffer_events: int = 10_000,
        tenant: str = "",
    ):
        self.sink = sink
        self.clock_us = clock_us or (lambda: int(time.time() * 1e6))
        self.tenant = tenant
        # with no sink, keep a bounded ring (a daemon running forever
        # must not accumulate events without bound)
        self.events: collections.deque[TraceEvent] = collections.deque(
            maxlen=buffer_events
        )
        # ring-overwrite visibility: events the bounded ring dropped
        # before anyone read them. A post-mortem against the in-memory
        # ring must KNOW it is partial — the bridge mirrors the count
        # into poseidon_trace_dropped_total per round, and the first
        # overwrite warns once.
        self.dropped_total = 0

    def emit(
        self,
        event: str,
        *,
        task: str = "",
        machine: str = "",
        round_num: int = 0,
        detail: dict | None = None,
    ) -> None:
        if event not in EVENT_TYPES:
            raise ValueError(
                f"undeclared trace event {event!r}; the vocabulary is "
                f"trace.EVENT_TYPES (PTA005)"
            )
        ev = TraceEvent(
            timestamp_us=self.clock_us(),
            event=event,
            task=task,
            machine=machine,
            round_num=round_num,
            detail=detail,
            tenant=self.tenant,
        )
        if self.sink is not None:
            self.sink.write(json.dumps(dataclasses.asdict(ev)) + "\n")
        else:
            if (
                self.events.maxlen is not None
                and len(self.events) == self.events.maxlen
            ):
                if not self.dropped_total:
                    log.warning(
                        "trace ring full (%d events, no sink): "
                        "overwriting oldest — this in-memory trace is "
                        "now PARTIAL (counted in dropped_total / "
                        "poseidon_trace_dropped_total)",
                        self.events.maxlen,
                    )
                self.dropped_total += 1
            self.events.append(ev)

    def flush(self) -> None:
        if self.sink is not None:
            self.sink.flush()


# the reader's known schema: any other key in a line is a field some
# NEWER version writes — forward compatibility means dropping it with a
# warning, not TypeError-ing on the whole file
_EVENT_FIELDS = frozenset(
    f.name for f in dataclasses.fields(TraceEvent)
)


def read_trace(path: str):
    """Yield a trace file's events ordered by ``round_num``.

    Pipelined rounds interleave a round's SCHEDULE/ROUND records with
    the next round's SUBMIT records in file order; this reader restores
    round order (stable within a round, so per-round event order is
    file order) so consumers do not have to re-implement the sort the
    module docstring used to prescribe. Blank lines are skipped; a
    malformed line raises ``json.JSONDecodeError`` like any other
    corrupt input.

    Forward compatibility: a trace written by a NEWER version may carry
    fields this reader does not know. Unknown keys are dropped (one
    warning per file naming them) instead of raising ``TypeError`` —
    an old analysis binary must still read a new daemon's trace.

    Torn tails: a process killed mid-``write`` (crash, OOM-kill — the
    flight recorder exists for exactly these) leaves a truncated FINAL
    line. That is a normal post-mortem artifact, not corruption: the
    reader drops it with one warning and yields everything before it.
    A malformed line anywhere ELSE still raises
    ``json.JSONDecodeError`` — mid-file corruption is real corruption.
    """
    dropped: set[str] = set()
    events: list[TraceEvent] = []
    # torn-tail tolerance is one-line deferral, streaming: hold a
    # parse failure and forgive it only if no later non-blank line
    # follows (loading the whole file just to find the last line would
    # double the report's peak memory on multi-hundred-MB daemon
    # traces)
    pending_error: json.JSONDecodeError | None = None
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            if pending_error is not None:
                raise pending_error  # garbage mid-file: real corruption
            try:
                doc = json.loads(line)
            except json.JSONDecodeError as e:
                pending_error = e
                continue
            unknown = doc.keys() - _EVENT_FIELDS
            if unknown:
                dropped |= unknown
                doc = {
                    k: v for k, v in doc.items() if k in _EVENT_FIELDS
                }
            events.append(TraceEvent(**doc))
    if pending_error is not None:
        log.warning(
            "read_trace(%s): dropping truncated final line "
            "(crash mid-write?)", path,
        )
    if dropped:
        log.warning(
            "read_trace(%s): dropped unknown field(s) %s — trace "
            "written by a newer version?", path, sorted(dropped),
        )
    events.sort(key=lambda e: e.round_num)  # stable: file order within
    yield from events


# ---------------------------------------------------------------------------
# the analysis CLI: python -m poseidon_tpu_torch.trace report|chrome <file>
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys as _sys

    p = argparse.ArgumentParser(
        prog="python -m poseidon_tpu_torch.trace",
        description="Analyze a scheduler trace JSONL file",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report",
        help="the operator's one-pager: round-latency percentiles by "
             "lane/build mode, express event-to-bind percentiles, "
             "degrade/resync/timeout tallies, placement churn",
    )
    rep.add_argument("file")
    rep.add_argument("--json", action="store_true",
                     help="emit the raw data model as JSON")
    rep.add_argument("--tenant", default="",
                     help="report only one tenant's events (the "
                          "service lane stamps each session's tenant "
                          "id onto its trace events)")
    chrome = sub.add_parser(
        "chrome",
        help="export SPAN events (--trace_profile) as Chrome-trace/"
             "Perfetto JSON for chrome://tracing / ui.perfetto.dev",
    )
    chrome.add_argument("file")
    chrome.add_argument("-o", "--out", default="",
                        help="output path (default: <file>.chrome.json)")
    args = p.parse_args(argv)
    # local imports: obs.report/spans import back into this module
    from poseidon_tpu_torch.obs import report as _report
    from poseidon_tpu_torch.obs import spans as _spans

    if args.cmd == "report":
        data = _report.analyze_trace(args.file, tenant=args.tenant)
        if args.json:
            print(json.dumps(data, indent=2))
        else:
            print(_report.render_report(data))
    else:
        out = args.out or (args.file + ".chrome.json")
        _spans.write_chrome_trace(read_trace(args.file), out)
        print(out, file=_sys.stdout)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
