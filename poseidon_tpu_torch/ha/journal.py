"""Write-ahead actuation journal: crash-consistent bind/evict POSTs.

The failure the journal closes: the daemon decides a round's deltas,
starts POSTing them, and dies. Without a record, a restarted scheduler
cannot tell which placements the apiserver already accepted — it
either re-binds pods that are already Running (double-actuation) or
silently forgets placements it optimistically confirmed (a pod the
bridge believes Running that the apiserver still lists Pending is
stranded forever by the confirm-outlives-poll-latency guard).

Protocol (one JSONL file, one lock):

- ``intents(ops)`` journals EVERY delta of the batch — bind, evict,
  migrate — as ``phase="intent"`` lines and fsyncs ONCE **before the
  first byte goes on the wire**. From that point a crash anywhere
  leaves a durable record of the full intended actuation;
- ``posted(seq)`` marks the HTTP success (the apiserver has durably
  accepted the op); ``confirmed(seq)`` marks the daemon having applied
  the result to bridge state; ``failed(seq)`` marks a POST the daemon
  saw fail and re-queued (terminal: the pod is re-offered normally).
  These are flushed but not fsync'd — losing one costs exactly one
  idempotent replay, never a lost or doubled actuation;
- on restart, ``incomplete()`` folds the file into entries with an
  intent but no terminal record, and ``replay_journal`` re-issues each
  one **idempotently**: the current pod state is read first
  (``client.get_pod``), an op whose effect is already visible counts
  as applied, and a re-POSTed bind that answers 409-Conflict-on-the-
  same-target counts as success (apiclient/client.py) — so replay
  after any kill point yields exactly-once actuation.

Torn tails: a crash mid-write leaves a truncated FINAL line; the
reader drops it with a warning (the same contract as ``read_trace``).
An intent line torn mid-write means the POST it would have preceded
never went out — dropping it is correct, not lossy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

# ops vocabulary (entry "op")
OPS = ("bind", "evict", "migrate")

# replay outcome vocabulary (the poseidon_journal_replays_total label)
REPLAY_OUTCOMES = (
    "replayed",         # the op was re-issued and landed
    "already-applied",  # the apiserver already shows the op's effect
    "stale",            # the pod no longer exists; nothing to do
    "failed",           # the re-issue failed (surfaced, not retried)
    "conflict",         # pod state matches neither side; left alone
)


@dataclasses.dataclass
class JournalEntry:
    """One folded actuation: the intent plus its latest phase."""

    seq: int
    op: str                  # bind | evict | migrate
    uid: str
    machine: str = ""        # bind/migrate target
    from_machine: str = ""   # evict/migrate source
    round_num: int = 0
    phase: str = "intent"    # intent | posted | confirmed | failed
    # lifecycle seed (obs/lifecycle.py): WALL µs of the pod's event
    # receipt, journaled with the intent so a restart-replayed bind
    # closes its PRE-CRASH timeline instead of minting a new one
    # (monotonic clocks do not survive the process). 0 = not stamped.
    t_event_us: int = 0


class ActuationJournal:
    """Append-only JSONL journal with batched fsync'd intents.

    Thread-safe by one internal lock: intents and confirms come from
    the loop thread, ``posted`` marks come from the bounded binding
    POST pool (cli ``_post_bindings``).
    """

    def __init__(self, path: str, *, fsync: bool = True,
                 crash_hook=None):
        self.path = path
        self.fsync = fsync
        # fault-injection seam (crash fuzz): raising at a named point
        # simulates a process death exactly there. None in production.
        self.crash_hook = crash_hook
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # repair a torn tail BEFORE reopening in append mode: a crash
        # mid-write leaves a truncated final line, and appending the
        # next record after it would merge the two into one garbage
        # line MID-file — which read_journal treats as real corruption
        # (only a torn FINAL line is forgiven). One crash must never
        # become a crash loop.
        _truncate_torn_tail(path)
        self._seq = 0
        for e in read_journal(path):
            self._seq = max(self._seq, e["seq"])
        self._fh = open(path, "a")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    # ---- the write-ahead protocol --------------------------------------

    def intents(
        self, ops: list[dict], round_num: int = 0
    ) -> dict[tuple[str, str], int]:
        """Journal a batch of intended actuations with ONE fsync;
        returns ``(op, uid) -> seq`` for the phase marks. Each op dict:
        ``{"op": "bind"|"evict"|"migrate", "uid": ..., "machine": ...,
        "from": ...}``. MUST be called before any of the POSTs go on
        the wire — that ordering is the whole crash-consistency
        contract."""
        seqs: dict[tuple[str, str], int] = {}
        if not ops:
            return seqs
        with self._lock:
            for op in ops:
                self._seq += 1
                kind = op["op"]
                if kind not in OPS:
                    raise ValueError(f"unknown journal op {kind!r}")
                seqs[(kind, op["uid"])] = self._seq
                self._fh.write(json.dumps({
                    "seq": self._seq, "phase": "intent", "op": kind,
                    "uid": op["uid"],
                    "machine": op.get("machine", ""),
                    "from": op.get("from", ""),
                    "round": round_num, "t": time.time(),
                    # wall-µs lifecycle event stamp (0 = untracked):
                    # the cross-restart e2c seed
                    "t_event_us": int(op.get("t_event_us", 0)),
                }) + "\n")
            self._fh.flush()
            fd = self._fh.fileno()
        # the fsync BARRIER runs outside the lock: holding it would
        # stall the POST pool's _mark() calls for the disk's full
        # flush latency (no blocking I/O under the lock).
        # Correctness is unchanged: the intent lines are ordered by
        # the buffered writes above, a concurrent _mark that slips in
        # before the barrier merely gets persisted early, and the
        # crash-consistency contract — fsync before the first byte on
        # the wire — holds because we still return only after the
        # barrier. rotate() cannot close this fd concurrently: rotate
        # and intents are both loop-thread ops.
        if self.fsync:
            os.fsync(fd)
        if self.crash_hook is not None:
            self.crash_hook("after-intent")
        return seqs

    def _mark(self, seq: int, phase: str) -> None:
        if seq <= 0:
            return
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(
                json.dumps({"seq": seq, "phase": phase}) + "\n"
            )
            self._fh.flush()

    def posted(self, seq: int) -> None:
        """The op's POST returned success (apiserver-durable)."""
        self._mark(seq, "posted")
        if self.crash_hook is not None:
            self.crash_hook("after-posted")

    def confirmed(self, seq: int) -> None:
        """The daemon applied the op's result to bridge state."""
        self._mark(seq, "confirmed")

    def failed(self, seq: int) -> None:
        """The daemon saw the POST fail and re-queued the pod."""
        self._mark(seq, "failed")

    # ---- restart-side reads -------------------------------------------

    def incomplete(self) -> list[JournalEntry]:
        with self._lock:
            self._fh.flush()
        return incomplete_entries(self.path)

    def discard(self) -> int:
        """Drop the journal wholesale (the ``--restore=false`` cold
        start: the operator disowned the previous boot's state, and a
        stale intent replayed against a cluster that moved on could
        evict a healthy pod days later). Returns the number of
        incomplete entries discarded — logged loudly, never silent."""
        dropped = incomplete_entries(self.path)
        with self._lock:
            self._fh.close()
            self._fh = open(self.path, "w")
        if dropped:
            log.warning(
                "journal %s: discarding %d incomplete actuation "
                "intent(s) on cold start (--restore=false): %s",
                self.path, len(dropped),
                [(e.op, e.uid) for e in dropped],
            )
        return len(dropped)

    def rotate(self) -> int:
        """Drop terminal entries (their effects live in bridge state /
        the latest checkpoint); keep incomplete ones. Called at
        checkpoint cadence so a forever-running daemon's journal stays
        bounded. Returns the number of entries kept."""
        keep = incomplete_entries(self.path)
        tmp = self.path + ".tmp"
        with self._lock:
            self._fh.flush()
            with open(tmp, "w") as fh:
                for e in keep:
                    fh.write(json.dumps({
                        "seq": e.seq, "phase": "intent", "op": e.op,
                        "uid": e.uid, "machine": e.machine,
                        "from": e.from_machine, "round": e.round_num,
                        "t_event_us": e.t_event_us,
                    }) + "\n")
                    if e.phase == "posted":
                        fh.write(json.dumps({
                            "seq": e.seq, "phase": "posted",
                        }) + "\n")
                fh.flush()
                if self.fsync:
                    # the tmp-file fsync must stay inside the lock:
                    # the lock covers the whole tmp-write -> fsync ->
                    # os.replace swap, or a _mark() landing between
                    # barrier and swap would be written to the file
                    # the replace is about to discard. rotate runs at
                    # checkpoint cadence (seconds apart), so the
                    # bounded stall is rare and sized by the journal's
                    # incomplete tail, not its full history.
                    os.fsync(fh.fileno())  # noqa: PTA010 -- lock must cover the tmp->live swap; see comment above
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a")
        return len(keep)


def _truncate_torn_tail(path: str) -> None:
    """Physically drop a crash-truncated final line so the file can be
    safely appended to. A torn write is a line prefix without its
    terminating newline (each record is one ``write`` of line+\\n), but
    a newline-terminated-yet-unparseable final line is cut the same
    way — the intent it would have preceded never went on the wire, so
    dropping it is correct, never lossy."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "rb+") as fh:
        data = fh.read()
        cut = size
        if not data.endswith(b"\n"):
            # torn tail: drop the unterminated prefix
            cut = data.rfind(b"\n") + 1
        else:
            # a terminated-but-unparseable FINAL line is cut the same
            # way; mid-file garbage is NOT repaired here — it cannot
            # arise from append semantics, so read_journal raising on
            # it is the honest outcome
            last_start = data.rfind(b"\n", 0, size - 1) + 1
            try:
                json.loads(data[last_start:])
            except json.JSONDecodeError:
                cut = last_start
        if cut != size:
            log.warning(
                "journal %s: truncating torn tail (%d of %d bytes "
                "kept; crash mid-write?)", path, cut, size,
            )
            fh.truncate(cut)


def read_journal(path: str) -> list[dict]:
    """Raw journal lines, torn-final-line tolerant."""
    if not os.path.exists(path):
        return []
    out: list[dict] = []
    pending_error = None
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            if pending_error is not None:
                raise pending_error
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                pending_error = e
                continue
    if pending_error is not None:
        log.warning(
            "journal %s: dropping truncated final line (crash "
            "mid-write?)", path,
        )
    return out


def incomplete_entries(path: str) -> list[JournalEntry]:
    """Fold the journal; entries with an intent but no terminal
    (confirmed/failed) record, in seq order."""
    entries: dict[int, JournalEntry] = {}
    for doc in read_journal(path):
        seq = int(doc.get("seq", 0))
        phase = doc.get("phase", "")
        if phase == "intent":
            entries[seq] = JournalEntry(
                seq=seq, op=doc.get("op", ""), uid=doc.get("uid", ""),
                machine=doc.get("machine", ""),
                from_machine=doc.get("from", ""),
                round_num=int(doc.get("round", 0)),
                t_event_us=int(doc.get("t_event_us", 0)),
            )
        elif seq in entries:
            entries[seq].phase = phase
    return [
        e for _, e in sorted(entries.items())
        if e.phase in ("intent", "posted")
    ]


def replay_journal(
    client, entries: list[JournalEntry], *, journal=None,
    trace=None, metrics=None, lifecycle=None,
) -> dict[str, int]:
    """Re-issue incomplete actuations idempotently (restart path).

    For each entry the pod's CURRENT apiserver state decides:

    - effect already visible (bound to the target / already off the
      source) -> ``already-applied``, nothing sent;
    - pod still in the pre-op state -> the op is re-POSTed
      (``replayed``); a concurrent duplicate collapses to success via
      the 409-same-target rule in ``bind_pod_to_node``;
    - pod gone -> ``stale``; pod in a third state (another writer) ->
      ``conflict``, left alone for the observe path to reconcile.

    Returns outcome counts; each entry also emits a JOURNAL_REPLAY
    trace event and ticks ``poseidon_journal_replays_total{outcome}``.
    When the live ``journal`` rides along, settled entries (replayed /
    already-applied / stale) are marked terminal so the NEXT restart
    does not replay them again; failed/conflict entries stay
    incomplete on purpose — they retry at the next boot.
    """
    counts = dict.fromkeys(REPLAY_OUTCOMES, 0)
    for e in entries:
        outcome = _replay_one(client, e)
        counts[outcome] += 1
        if journal is not None and outcome in (
            "replayed", "already-applied", "stale"
        ):
            journal.confirmed(e.seq)
        if (
            lifecycle is not None and e.op == "bind"
            and outcome in ("replayed", "already-applied")
        ):
            # the pre-crash timeline closes here: e2c measured from
            # the journaled wall stamp under lane="restart"
            # (obs/lifecycle.py's documented clock-contract exception)
            lifecycle.close_replayed(e.uid, e.t_event_us)
        if trace is not None:
            trace.emit(
                "JOURNAL_REPLAY", task=e.uid, machine=e.machine,
                round_num=e.round_num,
                detail={"op": e.op, "outcome": outcome,
                        "from": e.from_machine},
            )
        if metrics is not None:
            metrics.record_journal_replay(outcome)
        log.info(
            "journal replay: %s %s -> %s: %s",
            e.op, e.uid, e.machine or e.from_machine, outcome,
        )
    if trace is not None:
        trace.flush()
    return counts


def _replay_one(client, e: JournalEntry) -> str:
    pod = client.get_pod(e.uid)
    if pod is None:
        return "stale"
    if e.op == "bind":
        if pod.machine == e.machine:
            return "already-applied"
        if pod.machine:
            return "conflict"  # bound elsewhere: not ours to undo
        return "replayed" if client.bind_pod_to_node(
            e.uid, e.machine, namespace=pod.namespace
        ) else "failed"
    if e.op == "evict":
        if not pod.machine:
            return "already-applied"
        if e.from_machine and pod.machine != e.from_machine:
            return "conflict"
        return "replayed" if client.evict_pod(
            e.uid, namespace=pod.namespace
        ) else "failed"
    if e.op == "migrate":
        if pod.machine == e.machine:
            return "already-applied"
        if pod.machine and pod.machine != e.from_machine:
            return "conflict"
        ok = True
        if pod.machine == e.from_machine:
            ok = client.evict_pod(e.uid, namespace=pod.namespace)
        ok = ok and client.bind_pod_to_node(
            e.uid, e.machine, namespace=pod.namespace
        )
        return "replayed" if ok else "failed"
    return "conflict"
