"""Actuation outbox + apiserver-outage detection (the degradation
ladder between delta extraction and the wire).

The failure this closes: during an apiserver outage every bind/evict
POST fails, the daemon loop re-queues each pod (``binding_failed``), the
next round re-places the SAME pods, re-POSTs, fails again — so an
N-minute outage costs N/tick rounds of full re-POST storms, inflates
``bind_failures`` by pods x rounds, and ages every affected pod as if
the POD were the problem (distorting the wait-aging cost inputs the
solver prices). The reference has no story at all here — its pplx
chains dissolve transport errors into logged JSON.

The ladder:

- **Classify.** ``K8sApiClient.bind_outcome`` / ``evict_outcome``
  split failures into *rejected* (the apiserver answered and said no —
  re-queue the pod, the decision is wrong) and *unreachable* (the WIRE
  is the problem — transport error, socket timeout, 5xx/429 exhausted;
  the decision stands).
- **Park.** Unreachable actuations enter the ``ActuationOutbox``: the
  pod stays optimistically confirmed in bridge state (it does not
  re-enter the solve, does not age, is not re-POSTed by later rounds),
  and its journal intent stays open (ha/journal.py) so a crash during
  the outage replays it like any other incomplete actuation.
- **Declare.** ``OutageDetector`` counts consecutive transport-level
  failures (failed polls/LISTs, unreachable POSTs); at the threshold
  it declares ``degraded=outage`` — OUTAGE trace event, ONE
  ``poseidon_outage_episodes_total`` tick, ``poseidon_outage`` gauge
  (SLO-visible: ``--slo='outage == 0'``), /readyz condition detail.
  Rounds keep solving from last-known state; the observe path keeps
  probing.
- **Retry.** ``pump()`` (loop thread, once per tick) retries due
  entries with jittered exponential backoff. Each retry is IDEMPOTENT
  via the journal-replay semantics: the pod's current state is read
  first, an effect already visible counts as applied, a re-POSTed
  bind that answers 409-on-the-same-target counts as success. One
  probe failure aborts the pump early — a down apiserver is not
  hammered once per entry.
- **Recover / dead-letter.** The first success clears the outage
  (OUTAGE end event, gauge 0) and the pump drains the backlog. An
  entry that outlives ``dead_letter_s`` (or, in age-unbounded
  configurations, exhausts ``max_attempts``) dead-letters LOUDLY: OUTBOX_DEAD_LETTER trace +
  ``poseidon_outbox_dead_letters_total{op}``, and the daemon loop's
  callback re-queues the pod through the normal ``binding_failed`` /
  ``restore_running`` paths (exactly one aging bump for the whole
  outage, not one per round).

Threading: ``enqueue`` may be called from the bounded binding-POST
pool (cli ``_post_bindings`` workers); ``pump`` runs on the daemon loop
thread only. The entry list is guarded by ``_lock`` (declared in
analysis/contracts.py; PTA006-verified).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time

from poseidon_tpu_torch.apiclient.client import ApiError, backoff_delay

log = logging.getLogger(__name__)

# pump outcome vocabulary (mirrors journal REPLAY_OUTCOMES where the
# semantics coincide; "dead-letter" and "waiting" are outbox-only)
PUMP_OUTCOMES = (
    "replayed", "already-applied", "stale", "dead-letter", "waiting",
)


@dataclasses.dataclass
class OutboxEntry:
    """One parked actuation awaiting a reachable apiserver."""

    op: str                  # bind | evict | migrate
    uid: str
    machine: str = ""        # bind/migrate target
    from_machine: str = ""   # evict/migrate source
    seq: int = 0             # journal intent seq (0 = unjournaled)
    round_num: int = 0
    attempts: int = 0
    t_enqueued: float = 0.0  # monotonic
    next_retry: float = 0.0  # monotonic


class OutageDetector:
    """Consecutive-transport-failure ladder -> declared outage state.

    Loop-thread-only (fed from the observe loop and the pump's
    outcomes, both on the loop thread). ``on_change`` fires on every
    transition with the new state — the cli wires it to the trace
    event, the metrics gauge/episode counter, and the /readyz detail.
    """

    def __init__(self, threshold: int = 3, *, on_change=None):
        self.threshold = max(1, threshold)
        self.on_change = on_change
        self.consecutive_failures = 0
        self.active = False
        self.episodes = 0

    def note_failure(self) -> bool:
        """One transport-level failure (failed poll/LIST, unreachable
        POST). Returns True when this failure DECLARED the outage."""
        self.consecutive_failures += 1
        if (not self.active
                and self.consecutive_failures >= self.threshold):
            self.active = True
            self.episodes += 1
            log.warning(
                "apiserver outage declared (%d consecutive transport "
                "failures); rounds continue from last-known state, "
                "actuations park in the outbox",
                self.consecutive_failures,
            )
            if self.on_change is not None:
                self.on_change(True)
            return True
        return False

    def note_success(self) -> bool:
        """One successful apiserver interaction. Returns True when it
        CLEARED an active outage."""
        self.consecutive_failures = 0
        if self.active:
            self.active = False
            log.warning("apiserver outage cleared; replaying outbox")
            if self.on_change is not None:
                self.on_change(False)
            return True
        return False


class ActuationOutbox:
    """Parked actuations with per-entry jittered backoff + dead-letter.

    ``on_settled(entry, outcome)`` fires for replayed /
    already-applied / stale entries (the cli marks the journal and
    lifecycle); ``on_dead_letter(entry)`` fires when an entry exhausts
    its budget (the cli re-queues the pod and marks the journal
    failed).
    """

    def __init__(
        self,
        client,
        *,
        max_attempts: int = 8,
        dead_letter_s: float = 120.0,
        base_backoff_s: float = 0.5,
        cap_backoff_s: float = 10.0,
        metrics=None,
        on_settled=None,
        on_dead_letter=None,
        rng=random.random,
    ):
        self.client = client
        self.max_attempts = max_attempts
        self.dead_letter_s = dead_letter_s
        self.base_backoff_s = base_backoff_s
        self.cap_backoff_s = cap_backoff_s
        self.metrics = metrics
        self.on_settled = on_settled
        self.on_dead_letter = on_dead_letter
        self.rng = rng
        self._lock = threading.Lock()
        self._entries: list[OutboxEntry] = []
        # lifetime counters (host ints; read by stats/tests)
        self.retries_total = 0
        self.dead_letters_total = 0
        self.settled_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def pending(self) -> int:
        return len(self)

    def enqueue(
        self, op: str, uid: str, *, machine: str = "",
        from_machine: str = "", seq: int = 0, round_num: int = 0,
    ) -> None:
        """Park one unreachable actuation (POST-pool or daemon loop
        thread). The first retry waits one base backoff — the POST
        that just failed IS attempt zero."""
        now = time.monotonic()
        entry = OutboxEntry(
            op=op, uid=uid, machine=machine,
            from_machine=from_machine, seq=seq, round_num=round_num,
            attempts=1, t_enqueued=now,
            next_retry=now + backoff_delay(
                0, base_s=self.base_backoff_s,
                cap_s=self.cap_backoff_s, rng=self.rng,
            ),
        )
        with self._lock:
            # one entry per (op, uid): a re-decision for the same pod
            # supersedes the parked one (latest target wins)
            self._entries = [
                e for e in self._entries
                if not (e.op == op and e.uid == uid)
            ]
            self._entries.append(entry)
            pending = len(self._entries)
        log.warning(
            "outbox: parked %s %s -> %s (pending=%d)",
            op, uid, machine or from_machine, pending,
        )
        if self.metrics is not None:
            self.metrics.record_outbox(pending)

    # ---- the retry pump (loop thread, once per tick) -----------------
    # (a pod retired while parked needs no explicit cleanup: the
    # retry's get_pod probe answers "stale" and the entry settles)

    def pump(
        self, now: float | None = None, *, force: bool = False
    ) -> dict[str, int]:
        """Retry due entries idempotently; returns outcome counts.

        The first transport-level probe failure aborts the pump for
        this tick (the apiserver is still down — hammering the rest
        of the backlog would recreate the storm the outbox exists to
        prevent); the failed entry's backoff advances so the next
        pump spaces out. ``force=True`` (graceful shutdown's one
        best-effort drain) treats every entry as due and never
        dead-letters — what stays parked is the journal's problem.
        """
        now = time.monotonic() if now is None else now
        counts = dict.fromkeys(PUMP_OUTCOMES, 0)
        with self._lock:
            entries = list(self._entries)
        if not entries:
            return counts
        retries_before = self.retries_total
        aborted = self._pump_pass(entries, now, counts,
                                  respect_backoff=not force)
        settled = (counts["replayed"] + counts["already-applied"]
                   + counts["stale"])
        if not aborted and settled and self.pending:
            # the wire is PROVABLY healed (something just settled):
            # recovery drains the whole backlog now instead of
            # honoring per-entry backoff stamps minted during the
            # outage — "recovery replays the outbox", not "recovery
            # trickles it out over the old retry schedule"
            counts["waiting"] = 0
            with self._lock:
                remaining = list(self._entries)
            self._pump_pass(remaining, now, counts,
                            respect_backoff=False)
        if self.metrics is not None:
            # one recording per pump (not per entry): pending gauge +
            # the pass's retry count folded in a single call
            self.metrics.record_outbox(
                self.pending,
                retries=self.retries_total - retries_before,
            )
        return counts

    def _pump_pass(
        self, entries: list[OutboxEntry], now: float, counts,
        *, respect_backoff: bool,
    ) -> bool:
        """One pass over ``entries``; True = aborted on an
        unreachable apiserver."""
        for e in entries:
            if respect_backoff and e.next_retry > now:
                counts["waiting"] += 1
                continue
            # with an age bound configured, age is THE bound: the
            # attempt cap applying too would dead-letter mid-outage
            # long before the operator's window (attempts grow one
            # per pump against a down apiserver), re-queue the pod,
            # re-park it next round, and repeat — re-creating the
            # per-cycle aging/bind_failures inflation the outbox
            # exists to prevent. The cap is the backstop for
            # age-unbounded (dead_letter_s == 0) configurations only.
            expired = respect_backoff and (
                (self.dead_letter_s > 0
                 and now - e.t_enqueued >= self.dead_letter_s)
                or (self.dead_letter_s <= 0
                    and e.attempts >= self.max_attempts)
            )
            if expired:
                self._dead_letter(e, counts)
                continue
            self.retries_total += 1
            try:
                outcome = self._retry_one(e)
            except ApiError:
                # still unreachable: back off this entry and stop
                # probing the rest this tick
                self._backoff(e, now)
                counts["waiting"] += 1
                return True
            if outcome == "unreachable":
                self._backoff(e, now)
                counts["waiting"] += 1
                return True
            if outcome in ("replayed", "already-applied", "stale"):
                self._settle(e, outcome, counts)
            else:  # rejected / conflict: the decision cannot land
                self._dead_letter(e, counts)
        return False

    def _retry_one(self, e: OutboxEntry) -> str:
        """One idempotent retry: read-then-write, journal-replay
        semantics (ha/journal.py). Raises ApiError when the state
        probe itself cannot reach the apiserver."""
        pod = self.client.get_pod(e.uid)
        if pod is None:
            return "stale"
        if e.op == "bind":
            if pod.machine == e.machine:
                return "already-applied"
            if pod.machine:
                return "conflict"  # bound elsewhere: not ours to undo
            out = self.client.bind_outcome(
                e.uid, e.machine, namespace=pod.namespace
            )
            return "replayed" if out == "ok" else out
        if e.op == "evict":
            if not pod.machine:
                return "already-applied"
            if e.from_machine and pod.machine != e.from_machine:
                return "conflict"
            out = self.client.evict_outcome(
                e.uid, namespace=pod.namespace
            )
            return "replayed" if out == "ok" else out
        if e.op == "migrate":
            if pod.machine == e.machine:
                return "already-applied"
            if pod.machine and pod.machine != e.from_machine:
                return "conflict"
            if pod.machine == e.from_machine:
                out = self.client.evict_outcome(
                    e.uid, namespace=pod.namespace
                )
                if out != "ok":
                    return out
            out = self.client.bind_outcome(
                e.uid, e.machine, namespace=pod.namespace
            )
            return "replayed" if out == "ok" else out
        return "conflict"

    def _backoff(self, e: OutboxEntry, now: float) -> None:
        with self._lock:
            for live in self._entries:
                if live is e or (
                    live.op == e.op and live.uid == e.uid
                ):
                    live.attempts += 1
                    live.next_retry = now + backoff_delay(
                        live.attempts,
                        base_s=self.base_backoff_s,
                        cap_s=self.cap_backoff_s, rng=self.rng,
                    )
                    break

    def _settle(self, e: OutboxEntry, outcome: str, counts) -> None:
        counts[outcome] += 1
        self.settled_total += 1
        with self._lock:
            self._entries = [
                x for x in self._entries
                if not (x.op == e.op and x.uid == e.uid)
            ]
        log.info(
            "outbox: %s %s -> %s settled (%s, attempt %d)",
            e.op, e.uid, e.machine or e.from_machine, outcome,
            e.attempts,
        )
        if self.metrics is not None:
            self.metrics.record_outbox(self.pending, settled=outcome)
        if self.on_settled is not None:
            self.on_settled(e, outcome)

    def _dead_letter(self, e: OutboxEntry, counts) -> None:
        counts["dead-letter"] += 1
        self.dead_letters_total += 1
        with self._lock:
            self._entries = [
                x for x in self._entries
                if not (x.op == e.op and x.uid == e.uid)
            ]
        log.error(
            "outbox: DEAD-LETTER %s %s -> %s after %d attempts / "
            "%.1fs; re-queueing the pod",
            e.op, e.uid, e.machine or e.from_machine, e.attempts,
            time.monotonic() - e.t_enqueued,
        )
        if self.metrics is not None:
            self.metrics.record_outbox(
                self.pending, dead_letter_op=e.op
            )
        if self.on_dead_letter is not None:
            self.on_dead_letter(e)
