"""Per-pod lifecycle tracing: event-to-confirmed latency, by lane.

The latency story without this module is partial on purpose: the
express lane's ``e2b_ms`` covers the express lane's event-to-bind-DECISION only, and
the round path's ``total_ms`` times the solver, not the pod. Nothing
answered the operator's actual question — "from the moment the
apiserver told us about this pod, how long until its binding was
confirmed, end to end?" — across the tick lane (wait for the round),
the express lane (between-tick fast path), the service lane
(multi-tenant sessions), and the restart-replay lane (a bind whose
POST the previous process journaled and died before confirming).

``LifecycleTracker`` keeps a BOUNDED per-uid timeline stamped at every
stage the pod passes through:

- ``event``    — the pod became schedulable work: watch-event dequeue
  (the express path's per-event receipt stamp when the daemon loop has
  one) or the observe that first saw it Pending;
- ``decided``  — a round/express solve chose its machine;
- ``journal``  — the actuation intent hit the write-ahead journal
  (``--checkpoint_dir``);
- ``posted``   — the bind POST returned success;
- ``confirmed``— the daemon loop applied the confirm to bridge state. This
  CLOSES the timeline and records one event-to-confirmed sample into
  ``poseidon_pod_e2c_ms{lane=...}``.

A pod whose POST fails keeps its timeline open (aging is part of its
latency, not a reset); a pod that retires or is deleted before
confirming drops its timeline. The per-round wait-age distribution of
STANDING unscheduled pods (how long has the queue's tail been waiting,
in rounds) lands in ``poseidon_unsched_wait_rounds{q=p50|p95|max}`` —
the starvation surface ``wait_rounds`` feeds the cost models with but
nothing ever reported.

**Clock contract** (trace.py has the full statement): every in-process
duration is a ``time.monotonic`` difference — never wall clock. The
ONE exception is the restart-replay lane: a monotonic clock does not
survive the process, so the journal carries the event's WALL stamp
(``t_event_us``) and ``close_replayed`` computes the cross-process
e2c as a wall difference. Those samples are recorded under
``lane="restart"`` exactly so a consumer can tell the NTP-step-safe
samples from the cross-boot ones.

**Bounds.** At most ``max_open`` open timelines (default 65536); when
full, new timelines are dropped and counted
(``poseidon_lifecycle_dropped_total``) — a scheduler 65k pods behind
on confirms has bigger problems than a missing histogram sample, and
an unbounded dict keyed by uid is how a daemon leaks. Lanes fold to
the bounded ``LANES`` vocabulary before they reach a metric label.

Hot-path discipline: ``stamp_*`` / ``close_*`` run inside the bridge's
round window and the express fast path — dict ops and perf-counter
reads only, registered PTA001/PTA002 scopes (analysis/contracts.py).
``note_unscheduled`` takes the wait-age list the caller's existing
unscheduled walk already produced (no second walk).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time

import numpy as np

log = logging.getLogger(__name__)

# the bounded lane vocabulary (metric label values); anything else
# folds to "other"
LANES = ("tick", "express", "stream", "service", "restart", "other")

# timeline stage names, in lifecycle order
STAGES = ("event", "decided", "journal", "posted", "confirmed")


def bounded_lane(lane: str) -> str:
    """Fold a free-text lane onto the bounded vocabulary."""
    return lane if lane in LANES else "other"


@dataclasses.dataclass
class PodTimeline:
    """One pod's in-flight lifecycle: monotonic stamps per stage plus
    the wall twin of the event stamp (the journal's cross-restart
    seed). ``lane`` is stamped at decision time — the same pod riding
    the tick lane one day and the express lane the next reports into
    the right bucket each time."""

    t_event: float            # perf_counter at first sight
    t_event_wall_us: int      # wall µs twin (journaled for restarts)
    lane: str = ""
    stages: dict = dataclasses.field(default_factory=dict)


class LifecycleTracker:
    """Bounded per-uid timelines + the histograms they close into.

    One instance per bridge, loop-thread only (the bridge's own
    single-thread contract covers it; nothing here takes a lock).
    ``metrics`` is an ``obs.SchedulerMetrics`` (or None: stamps still
    tracked — tests read ``last_closed`` — but nothing is published).
    """

    def __init__(self, metrics=None, *, max_open: int = 65536):
        self.metrics = metrics
        self.max_open = max_open
        self.open: dict[str, PodTimeline] = {}
        self.dropped = 0
        self.closed_total = 0
        # (uid, lane, e2c_ms) of the most recently closed timeline —
        # the lifecycle-differential tests' read surface — plus its
        # stage stamps (decided/journal/posted offsets, debugging)
        self.last_closed: tuple[str, str, float] | None = None
        self.last_closed_stages: dict = {}
        # recently-closed stamps, bounded: the pipelined daemon loop
        # confirms OPTIMISTICALLY (before the POST), so a failed POST
        # must be able to REOPEN the timeline from its original event
        # stamp — otherwise the pod's real (longer) wait is never
        # measured and the histogram reads optimistic exactly when
        # the apiserver is flaky
        self._closed_stash: collections.OrderedDict[
            str, tuple[float, int]
        ] = collections.OrderedDict()
        self._stash_max = 4096

    # ---- stamps (hot scopes: dict ops + clock reads only) --------------

    def stamp_event(
        self, uid: str, t_event: float | None = None
    ) -> None:
        """First sight of schedulable work for ``uid``. Idempotent —
        re-observations keep the ORIGINAL stamp (latency is measured
        from first sight, not last poll). ``t_event`` is the daemon loop's
        own receipt stamp (watch dequeue) when it has one."""
        if uid in self.open:
            return
        if len(self.open) >= self.max_open:
            if not self.dropped:
                log.warning(
                    "lifecycle tracker full (%d open timelines); "
                    "dropping new ones (counted)", self.max_open,
                )
            self.dropped += 1
            if self.metrics is not None:
                self.metrics.record_lifecycle_dropped()
            return
        now = time.perf_counter()
        self.open[uid] = PodTimeline(
            t_event=t_event if t_event is not None else now,
            t_event_wall_us=int(time.time() * 1e6),
        )

    def backdate_event(self, uid: str, t_event: float) -> None:
        """Move an open timeline's event stamp EARLIER (never later):
        the express window dequeues events with their own receipt
        stamps, which precede the observe that minted the timeline.
        The wall twin (the journal's cross-restart seed) backdates by
        the same delta, so a restart-replayed bind's e2c also starts
        at the receipt, not the observe."""
        tl = self.open.get(uid)
        if tl is not None and t_event < tl.t_event:
            tl.t_event_wall_us -= int(
                (tl.t_event - t_event) * 1e6
            )
            tl.t_event = t_event

    def event_wall_us(self, uid: str) -> int:
        """The journaled cross-restart seed: wall µs of the event
        stamp (0 = unknown uid)."""
        tl = self.open.get(uid)
        return tl.t_event_wall_us if tl is not None else 0

    def stamp(self, uid: str, stage: str) -> None:
        """Mark one mid-life stage (``decided``/``journal``/``posted``)
        at now; unknown uids are ignored (a journaled op for a pod the
        tracker never saw — e.g. a restore-path migration — is not an
        error)."""
        tl = self.open.get(uid)
        if tl is not None:
            tl.stages[stage] = time.perf_counter()

    def stamp_decided(self, uid: str, lane: str) -> None:
        """The solve chose this pod's machine; ``lane`` is the bounded
        lifecycle lane the eventual e2c sample reports under."""
        tl = self.open.get(uid)
        if tl is not None:
            tl.lane = bounded_lane(lane)
            tl.stages["decided"] = time.perf_counter()

    def close_confirmed(self, uid: str) -> float | None:
        """The binding confirm landed: close the timeline and record
        its event-to-confirmed sample (ms, monotonic). Returns the
        sample, or None for an untracked uid.

        The pipelined daemon loop confirms OPTIMISTICALLY (POST follows in
        the overlap window), so this sample measures event-to-commit;
        if the POST then fails, ``reopen`` restores the timeline from
        its original event stamp and the eventual successful bind
        records the pod's full wait as a second sample."""
        tl = self.open.pop(uid, None)
        if tl is None:
            return None
        e2c = (time.perf_counter() - tl.t_event) * 1000
        lane = tl.lane or "other"
        self.closed_total += 1
        self.last_closed = (uid, lane, e2c)
        self.last_closed_stages = dict(tl.stages)
        self._closed_stash[uid] = (tl.t_event, tl.t_event_wall_us)
        while len(self._closed_stash) > self._stash_max:
            self._closed_stash.popitem(last=False)
        if self.metrics is not None:
            self.metrics.record_pod_e2c(e2c, lane)
        return e2c

    def reopen(self, uid: str) -> None:
        """A bind that was optimistically confirmed failed its POST
        (the pod re-queues): restore the timeline from its ORIGINAL
        event stamp so the pod's real end-to-end wait is still
        measured when it finally binds. No-op for unknown uids or
        already-open timelines."""
        if uid in self.open:
            return
        stash = self._closed_stash.pop(uid, None)
        if stash is None:
            return
        if len(self.open) >= self.max_open:
            self.dropped += 1
            if self.metrics is not None:
                self.metrics.record_lifecycle_dropped()
            return
        self.open[uid] = PodTimeline(
            t_event=stash[0], t_event_wall_us=stash[1]
        )

    def drop(self, uid: str) -> None:
        """The pod left the cluster unconfirmed (retired, deleted,
        evicted-for-good): the timeline is moot."""
        self.open.pop(uid, None)
        self._closed_stash.pop(uid, None)

    # ---- the restart-replay lane ---------------------------------------

    # ---- the standing-unscheduled surface ------------------------------

    def note_unscheduled(self, wait_rounds: list[int]) -> None:
        """Per-round wait-age distribution of pods the round left
        unscheduled. The caller's existing unscheduled walk collected
        the ages — this is one numpy percentile over that list, not a
        second walk."""
        if self.metrics is None:
            return
        if not wait_rounds:
            self.metrics.record_unsched_wait(0.0, 0.0, 0.0)
            return
        ages = np.asarray(wait_rounds, np.int64)
        self.metrics.record_unsched_wait(
            float(np.percentile(ages, 50)),
            float(np.percentile(ages, 95)),
            float(ages.max()),
        )

    def close_replayed(self, uid: str, t_event_us: int) -> float | None:
        """A journal replay settled this pod's bind after a restart:
        record the CROSS-PROCESS e2c from the journaled wall stamp
        (the pre-crash timeline's event receipt) instead of minting a
        fresh timeline that would erase the pre-crash wait. Wall-
        differenced by necessity (the clock-contract exception this
        lane documents); samples land under ``lane="restart"``.
        Returns the sample, or None when no stamp was journaled."""
        if not t_event_us:
            return None
        e2c = max((time.time() * 1e6 - t_event_us) / 1000, 0.0)
        # a fresh-process tracker has no open timeline for the uid —
        # and must not mint one: the bind is settled
        self.open.pop(uid, None)
        self.closed_total += 1
        self.last_closed = (uid, "restart", e2c)
        if self.metrics is not None:
            self.metrics.record_pod_e2c(e2c, "restart")
        return e2c

    # ---- the standing-unscheduled surface ------------------------------

    def note_unscheduled(self, wait_rounds: list[int]) -> None:
        """Per-round wait-age distribution of pods the round left
        unscheduled. The caller's existing unscheduled walk collected
        the ages — this is one numpy percentile over that list, not a
        second walk."""
        if self.metrics is None:
            return
        if not wait_rounds:
            self.metrics.record_unsched_wait(0.0, 0.0, 0.0)
            return
        ages = np.asarray(wait_rounds, np.int64)
        self.metrics.record_unsched_wait(
            float(np.percentile(ages, 50)),
            float(np.percentile(ages, 95)),
            float(ages.max()),
        )
