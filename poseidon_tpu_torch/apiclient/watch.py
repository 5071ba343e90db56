"""Event-driven cluster observation: the Kubernetes watch protocol.

The reference polls the apiserver with full ``GET /nodes`` + ``GET
/pods`` lists every tick (k8s_api_client.cc:100-209) and re-diffs the
whole cluster — O(cluster) host work per round even when nothing
changed. The real control plane's answer is the watch protocol, and
Firmament itself is built around incremental cluster-state deltas; this
module closes that gap:

- ``ClusterWatcher.sync()`` does ONE paginated LIST per resource to
  seed a snapshot plus its ``resourceVersion``;
- two long-lived chunked watch streams (nodes, pods) then deliver typed
  ``ADDED | MODIFIED | DELETED | BOOKMARK`` events from that rv, each
  stream tracking its own rv so a reconnect resumes exactly where it
  left off (``?watch=true&resourceVersion=N`` returns events with
  rv > N — at-most-once delivery by construction, and ``tick()``
  re-checks ``rv <= applied`` so a replaying server cannot double-apply
  either);
- streams reconnect with jittered exponential backoff
  (``client.backoff_delay``) after transport errors; clean server-side
  closes (idle bookmark + EOF) resume immediately;
- the watcher **degrades loudly to a full LIST resync** — never guesses
  — on ``410 Gone`` (either HTTP shape), an undecodable event, or a
  staleness bound (no stream activity for ``max_lag_s``, the cli's
  ``--watch_max_lag``). Every resync and every error-path reconnect is
  emitted as a ``WATCH_RESYNC`` / ``WATCH_RECONNECT`` trace event and
  surfaced in ``ObserveDelta`` so the bridge counts them in
  ``SchedulerStats``.

Threading model: one daemon reader thread per stream blocks on the
HTTP response and pushes decoded items into a per-stream queue; all
state mutation (rv accounting, resync decisions, object parsing, trace
emission) happens on the caller's thread inside ``tick()``, so the
bridge — which is not thread-safe — only ever sees events from its own
daemon loop. ``tick()`` never blocks on the network except during a
resync's LISTs.

The consumer contract (cli.py, tests/test_torch_watch.py):

    delta = watcher.tick()
    if delta.resynced:            # seed, 410, decode error, staleness
        bridge.observe_nodes(delta.nodes)     # snapshot diff path —
        bridge.observe_pods(delta.pods)       # mass-eviction guard on
    else:
        for typ, m in delta.node_events:
            bridge.observe_node_event(typ, m)
        for typ, t in delta.pod_events:
            bridge.observe_pod_event(typ, t)
    bridge.note_watch_activity(delta.resyncs, delta.reconnects)
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from poseidon_tpu_torch.apiclient.client import (
    ApiError,
    K8sApiClient,
    backoff_delay,
)
from poseidon_tpu_torch.cluster import Machine, Task
from poseidon_tpu_torch.trace import TraceGenerator

log = logging.getLogger(__name__)

RESOURCES = ("nodes", "pods")


class WatchGone(Exception):
    """The apiserver no longer holds history for the requested rv."""


@dataclasses.dataclass
class ObserveDelta:
    """One ``tick()``'s worth of cluster observation.

    Either a full snapshot (``resynced=True``: consume ``nodes`` /
    ``pods`` through the bridge's snapshot-diff path) or incremental
    typed events (``node_events`` / ``pod_events`` as ``(type, obj)``
    pairs, type in ADDED|MODIFIED|DELETED). ``resyncs`` / ``reconnects``
    are this tick's degradation counts for ``SchedulerStats``.
    """

    resynced: bool = False
    nodes: list[Machine] = dataclasses.field(default_factory=list)
    pods: list[Task] = dataclasses.field(default_factory=list)
    node_events: list[tuple[str, Machine]] = dataclasses.field(
        default_factory=list)
    pod_events: list[tuple[str, Task]] = dataclasses.field(
        default_factory=list)
    resyncs: int = 0
    reconnects: int = 0


@dataclasses.dataclass
class ExpressEvents:
    """One ``express_poll()``'s worth of between-tick pod events.

    ``pod_events`` are typed ``(type, Task)`` pairs exactly like
    ``ObserveDelta.pod_events`` — the express window feeds them to
    ``SchedulerBridge.express_batch``. ``t_first`` is the
    ``perf_counter`` stamp at which the first event was dequeued (the
    event-to-bind latency clock's zero); ``t_events`` carries one such
    dequeue stamp PER event (parallel to ``pod_events``), so the bind
    path can report a real per-event latency sample instead of
    replicating the batch's. ``needs_tick=True`` means
    something the express lane must not handle arrived (node events, a
    410/decode degradation, an un-seeded watcher): the caller should
    fall through to a full observe tick, where the normal resync /
    snapshot-diff guards apply.
    """

    pod_events: list[tuple[str, Task]] = dataclasses.field(
        default_factory=list)
    t_first: float = 0.0
    t_events: list[float] = dataclasses.field(default_factory=list)
    reconnects: int = 0
    needs_tick: bool = False
    # overload backpressure: the pods stream's queue depth exceeded
    # the shed threshold — the express lane stepped aside so the full
    # round (which handles arbitrarily large batches in one solve)
    # absorbs the burst instead of the per-batch fast path grinding
    # through it event by event. Counted loudly by the daemon loop.
    shed: bool = False


class _WatchStream(threading.Thread):
    """One resource's watch connection, kept alive across reconnects.

    Pushes ``("EVENT", rv, type, raw_object)`` / ``("BOOKMARK", rv)`` /
    ``("RECONNECT", reason)`` / ``("GONE", reason)`` items into
    ``self.queue``. After GONE the thread exits — only a full LIST
    resync (which replaces the stream object) can continue.
    """

    def __init__(
        self,
        base: str,
        resource: str,
        start_rv: int,
        *,
        read_timeout_s: float,
        backoff_base_s: float,
        backoff_cap_s: float,
    ):
        super().__init__(daemon=True, name=f"watch-{resource}")
        self.base = base
        self.resource = resource
        self.rv = start_rv        # reconnect-from rv (this thread only)
        self.seen_rv = start_rv   # newest rv enqueued (read by others)
        self.read_timeout_s = read_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.queue: queue.Queue = queue.Queue()
        self.gone = threading.Event()
        self.last_activity = time.monotonic()
        # reconnect coalescing: during a long apiserver outage the
        # retry loop fails every backoff period — enqueueing one
        # RECONNECT item per attempt would grow the pending-event
        # queue without bound for as long as the outage lasts. Only
        # the FIRST failure of a consecutive run is enqueued (it
        # carries the reason); the rest advance this monotonic
        # counter, which the consumer folds into its reconnect counts
        # (the seen_rv read pattern). Queue memory during an outage
        # is O(1), the counts stay exact.
        self.coalesced_reconnects = 0
        self._halt = threading.Event()
        self._resp = None

    # ---- lifecycle ----

    def stop(self) -> None:
        self._halt.set()
        resp = self._resp
        if resp is not None:
            try:
                resp.close()  # unblocks a reader parked in readline
            except Exception:
                pass

    # ---- the reconnect loop ----

    def run(self) -> None:  # pta: background-thread
        attempt = 0
        while not (self._halt.is_set() or self.gone.is_set()):
            try:
                resp = self._connect()
            except WatchGone as e:
                self._push_gone(str(e))
                return
            except (OSError, http.client.HTTPException,
                    urllib.error.URLError) as e:
                if self._halt.is_set():
                    return
                if attempt == 0:
                    self.queue.put(
                        ("RECONNECT", f"connect failed: {e}")
                    )
                else:
                    # consecutive failures coalesce (bounded queue
                    # memory over a long outage); the count stays
                    # exact via the monotonic counter
                    self.coalesced_reconnects += 1
                time.sleep(backoff_delay(
                    attempt, base_s=self.backoff_base_s,
                    cap_s=self.backoff_cap_s,
                ))
                attempt += 1
                continue
            self._resp = resp
            self.last_activity = time.monotonic()
            clean = self._consume(resp)
            try:
                resp.close()
            except Exception:
                pass
            self._resp = None
            if self._halt.is_set() or self.gone.is_set():
                return
            if clean:
                attempt = 0  # routine idle close: resume immediately
            else:
                self.queue.put(("RECONNECT", "stream error"))
                time.sleep(backoff_delay(
                    attempt, base_s=self.backoff_base_s,
                    cap_s=self.backoff_cap_s,
                ))
                attempt += 1

    def _connect(self):  # pta: background-thread
        params = urllib.parse.urlencode({
            "watch": "true",
            "resourceVersion": str(self.rv),
            "allowWatchBookmarks": "true",
        })
        url = f"{self.base}/{self.resource}?{params}"
        try:
            return urllib.request.urlopen(
                urllib.request.Request(url),
                timeout=self.read_timeout_s,
            )
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise WatchGone(
                    f"rv {self.rv} expired (HTTP 410)"
                ) from e
            raise

    def _push_gone(self, reason: str) -> None:  # pta: background-thread
        self.gone.set()
        self.queue.put(("GONE", reason))

    def _consume(self, resp) -> bool:  # pta: background-thread
        """Decode one connection's stream; True = clean server close.

        http.client's chunked reader swallows an abrupt mid-stream cut
        (IncompleteRead surfaces as a silent EOF), so transport alone
        cannot tell a dirty close from a server ending its watch
        window. The protocol-level tell: a server closing *cleanly*
        ends with a BOOKMARK (we request allowWatchBookmarks); an EOF
        whose last delivered item was a real event means the stream
        died mid-flow and the reconnect is counted + backed off.
        """
        ended_on_bookmark = False
        try:
            for raw in resp:
                if self._halt.is_set():
                    return True
                line = raw.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                    typ = doc["type"]
                    obj = doc["object"]
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    # an undecodable stream cannot be trusted to have
                    # delivered everything before the garbage either:
                    # degrade loudly, never guess
                    self._push_gone(f"undecodable watch line: {e!r}")
                    return False
                if typ == "ERROR":
                    code = obj.get("code") if isinstance(obj, dict) \
                        else None
                    self._push_gone(
                        "rv expired (410 ERROR event)" if code == 410
                        else f"watch ERROR event: {obj}"
                    )
                    return False
                try:
                    rv = int(
                        obj.get("metadata", {})
                        .get("resourceVersion", 0) or 0
                    )
                except (TypeError, ValueError):
                    rv = 0
                self.last_activity = time.monotonic()
                if rv > self.rv:
                    self.rv = rv
                if typ == "BOOKMARK":
                    self.queue.put(("BOOKMARK", rv))
                    ended_on_bookmark = True
                else:
                    self.queue.put(("EVENT", rv, typ, obj))
                    ended_on_bookmark = False
                # seen_rv advances only AFTER the item is enqueued:
                # wait_caught_up readers must find the event already
                # in the queue when they observe the new rv
                if rv > self.seen_rv:
                    self.seen_rv = rv
            return ended_on_bookmark or self._halt.is_set()
        except TimeoutError:
            # an idle read window elapsing on a quiet stream is NOT a
            # stream error: real apiservers space bookmarks/window
            # closes further apart than the socket timeout, and
            # treating the timeout as dirty would back off and count
            # reconnects forever on a perfectly healthy idle cluster.
            # Resume immediately from the current rv; last_activity
            # refreshes on the reconnect, so the staleness bound only
            # fires when a stream cannot be RE-ESTABLISHED for
            # max_lag_s (TimeoutError must precede OSError: it is one)
            return True
        except (OSError, http.client.HTTPException, ValueError,
                AttributeError):
            # AttributeError: http.client nulls its fp when stop()
            # closes the response under a parked readline
            return self._halt.is_set()


class ClusterWatcher:
    """Holds the seed snapshot + two watch streams; see module doc."""

    def __init__(
        self,
        client: K8sApiClient,
        *,
        trace: TraceGenerator | None = None,
        max_lag_s: float = 30.0,
        read_timeout_s: float | None = None,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        metrics=None,
    ):
        self.client = client
        self.trace = trace or TraceGenerator()
        # observability (obs.SchedulerMetrics or None): resyncs and
        # reconnects are recorded at their trace-emit sites, on the
        # caller's thread, from the reason strings already in hand
        self.metrics = metrics
        self.max_lag_s = max_lag_s
        self.read_timeout_s = (
            read_timeout_s if read_timeout_s is not None
            else client.timeout_s
        )
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._streams: dict[str, _WatchStream] = {}
        # per-resource cursor into each stream's coalesced-reconnect
        # counter (folded into tick()'s counts; reset when sync/resume
        # replace the stream objects — any unfolded residual is
        # carried so the counts stay exact across a resync)
        self._coalesced_seen: dict[str, int] = dict.fromkeys(
            RESOURCES, 0
        )
        self._carry_coalesced: dict[str, int] = dict.fromkeys(
            RESOURCES, 0
        )
        self._applied_rv: dict[str, int] = dict.fromkeys(RESOURCES, 0)
        self._seeded = False
        # a degradation whose resync LIST has not succeeded yet; kept
        # so a failed resync is RETRIED next tick (and still counted/
        # traced when it finally lands) instead of silently stranding
        # the watcher with no streams
        self._resync_reason = ""
        # lifetime counters (per-tick deltas ride on ObserveDelta)
        self.resyncs_total = 0
        self.reconnects_total = 0

    # ---- lifecycle ----

    def stop(self) -> None:
        for s in self._streams.values():
            s.stop()
        for s in self._streams.values():
            s.join(timeout=2.0)
        self._streams = {}

    def __enter__(self) -> "ClusterWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- sync (seed / resync) ----

    def _carry_residual_coalesced(self) -> None:
        """Before discarding the stream objects, bank each stream's
        not-yet-folded coalesced reconnects — a resync mid-outage
        must not lose exactly the counts the outage minted."""
        for resource, s in self._streams.items():
            residual = (
                s.coalesced_reconnects
                - self._coalesced_seen.get(resource, 0)
            )
            if residual > 0:
                self._carry_coalesced[resource] = (
                    self._carry_coalesced.get(resource, 0) + residual
                )

    def _take_carry(self) -> int:
        """Fold the banked residuals into the metrics; returns the
        total (the caller adds it to this tick's reconnect count,
        whose flow already feeds ``reconnects_total``)."""
        total = 0
        for resource, n in self._carry_coalesced.items():
            if n > 0:
                total += n
                if self.metrics is not None:
                    self.metrics.record_reconnect(resource, amount=n)
        if total:
            self._carry_coalesced = dict.fromkeys(RESOURCES, 0)
        return total

    def sync(self) -> tuple[list[Machine], list[Task]]:
        """Full paginated LIST of both resources; restarts both streams
        from the snapshot rvs. Raises ``ApiError`` if the LISTs fail
        (the caller skips the tick, like a failed poll) — the watcher
        stays un-seeded so the NEXT tick retries the sync rather than
        ticking over zero streams forever."""
        self._carry_residual_coalesced()
        self.stop()
        self._seeded = False
        nodes, nodes_rv = self.client.nodes_with_rv()
        pods, pods_rv = self.client.pods_with_rv()
        self._coalesced_seen = dict.fromkeys(RESOURCES, 0)
        self._applied_rv = {"nodes": nodes_rv, "pods": pods_rv}
        for resource, rv in (("nodes", nodes_rv), ("pods", pods_rv)):
            s = _WatchStream(
                self.client.base, resource, rv,
                read_timeout_s=self.read_timeout_s,
                backoff_base_s=self.backoff_base_s,
                backoff_cap_s=self.backoff_cap_s,
            )
            self._streams[resource] = s
            s.start()
        self._seeded = True
        return nodes, pods

    def resume(self, rvs: dict[str, int]) -> None:
        """Warm-restore resumption (ha/checkpoint.py): restart both
        streams from CHECKPOINTED resourceVersions without a seeding
        LIST — the restored bridge already holds the snapshot those rvs
        describe, so events with rv > checkpoint replay exactly the
        history the dead process missed. If the apiserver has compacted
        past a checkpointed rv the stream goes 410 and the next
        ``tick()`` degrades to the LOUD full-LIST resync (snapshot-diff
        path, mass-eviction guard armed) — stale resumption never
        guesses."""
        self._carry_residual_coalesced()
        self.stop()
        self._coalesced_seen = dict.fromkeys(RESOURCES, 0)
        self._applied_rv = {
            r: int(rvs.get(r, 0)) for r in RESOURCES
        }
        for resource in RESOURCES:
            s = _WatchStream(
                self.client.base, resource, self._applied_rv[resource],
                read_timeout_s=self.read_timeout_s,
                backoff_base_s=self.backoff_base_s,
                backoff_cap_s=self.backoff_cap_s,
            )
            self._streams[resource] = s
            s.start()
        self._seeded = True

    @property
    def applied_rvs(self) -> dict[str, int]:
        """Per-resource applied resourceVersions (the checkpoint's
        watch-position payload; ``applied_rv`` is the string form)."""
        return dict(self._applied_rv)

    @property
    def applied_rv(self) -> str:
        """The per-resource resourceVersions the bridge has APPLIED up
        to, as one ``nodes=N,pods=M`` string — the stream-position
        stamp the flight recorder records with each round so a dump
        correlates with the apiserver's watch history."""
        return ",".join(
            f"{r}={self._applied_rv[r]}" for r in sorted(
                self._applied_rv
            )
        )

    # ---- the per-tick pump ----

    def tick(self) -> ObserveDelta:
        """Drain both streams into typed events, or degrade to a full
        resync (410 / decode error / staleness). Non-blocking except
        during a resync's LISTs."""
        if not self._seeded:
            # first seed, or the retry of a resync whose LIST failed
            reason = self._resync_reason
            nodes, pods = self.sync()
            carried = self._take_carry()
            self.reconnects_total += carried
            if reason:
                self._resync_reason = ""
                self.resyncs_total += 1
                self.trace.emit(
                    "WATCH_RESYNC", detail={"reason": reason}
                )
                if self.metrics is not None:
                    self.metrics.record_resync(reason)
                return ObserveDelta(
                    resynced=True, nodes=nodes, pods=pods, resyncs=1,
                    reconnects=carried,
                )
            return ObserveDelta(
                resynced=True, nodes=nodes, pods=pods,
                reconnects=carried,
            )
        # residuals banked by a previous sync/resume (streams replaced
        # mid-outage) fold into this tick's count
        reconnects = self._take_carry()
        node_events: list[tuple[str, Machine]] = []
        pod_events: list[tuple[str, Task]] = []
        resync_reason = ""
        now = time.monotonic()
        for resource, stream in self._streams.items():
            while True:
                try:
                    item = stream.queue.get_nowait()
                except queue.Empty:
                    break
                kind = item[0]
                if kind == "RECONNECT":
                    reconnects += 1
                    self.trace.emit(
                        "WATCH_RECONNECT",
                        detail={"resource": resource,
                                "reason": item[1]},
                    )
                    if self.metrics is not None:
                        self.metrics.record_reconnect(resource)
                elif kind == "BOOKMARK":
                    self._applied_rv[resource] = max(
                        self._applied_rv[resource], item[1]
                    )
                elif kind == "GONE":
                    resync_reason = resync_reason or (
                        f"{resource}: {item[1]}"
                    )
                    break
                else:  # EVENT
                    _, rv, typ, obj = item
                    if rv and rv <= self._applied_rv[resource]:
                        # replayed history (reconnect overlap): a
                        # resync-storm must never double-apply
                        continue
                    try:
                        parsed = self._parse(resource, obj)
                    except (KeyError, ValueError, TypeError) as e:
                        resync_reason = resync_reason or (
                            f"{resource}: unparseable {typ} event: {e!r}"
                        )
                        break
                    if rv:
                        self._applied_rv[resource] = rv
                    if resource == "nodes":
                        node_events.append((typ, parsed))
                    else:
                        pod_events.append((typ, parsed))
            # fold the stream's coalesced (queue-suppressed)
            # reconnects into this tick's counts — exact totals with
            # O(1) queue memory over a long outage
            cr = stream.coalesced_reconnects
            coalesced = cr - self._coalesced_seen[resource]
            if coalesced > 0:
                self._coalesced_seen[resource] = cr
                reconnects += coalesced
                if self.metrics is not None:
                    self.metrics.record_reconnect(
                        resource, amount=coalesced
                    )
            if not resync_reason and stream.gone.is_set():
                resync_reason = f"{resource}: stream gone"
            if not resync_reason and (
                now - stream.last_activity > self.max_lag_s
            ):
                resync_reason = (
                    f"{resource}: no stream activity for "
                    f"{self.max_lag_s:g}s (--watch_max_lag)"
                )
        self.reconnects_total += reconnects
        if resync_reason:
            log.warning(
                "watch degrading to full LIST resync: %s", resync_reason
            )
            # drained-but-unapplied events are superseded by the
            # snapshot; dropping them cannot lose state. Recorded
            # BEFORE the sync so a failed LIST leaves the reason (and
            # the un-seeded state) in place for the next tick's retry.
            self._resync_reason = resync_reason
            nodes, pods = self.sync()
            self._resync_reason = ""
            self.resyncs_total += 1
            self.trace.emit(
                "WATCH_RESYNC", detail={"reason": resync_reason}
            )
            if self.metrics is not None:
                self.metrics.record_resync(resync_reason)
            return ObserveDelta(
                resynced=True, nodes=nodes, pods=pods,
                resyncs=1, reconnects=reconnects,
            )
        return ObserveDelta(
            node_events=node_events, pod_events=pod_events,
            reconnects=reconnects,
        )

    def _parse(self, resource: str, obj: dict):
        if resource == "nodes":
            return self.client._parse_node(obj)
        return self.client._parse_pod(obj)

    # ---- the express window (between-tick pod events) ----

    def _express_nodes_pending(
        self, nodes: _WatchStream | None, out: ExpressEvents
    ) -> bool:
        """True when the nodes stream holds work only a full tick may
        apply. Pure bookkeeping items (BOOKMARK rv advances, counted
        RECONNECTs — idle streams bookmark routinely) are consumed
        here so they cannot pin the express window shut; a real node
        EVENT is pushed back for ``tick()`` and ends the window."""
        if nodes is None:
            return False
        if nodes.gone.is_set():
            return True
        while True:
            # peek under the queue lock: a get+put-back would reorder
            # the stream behind later events and the rv guard would
            # then silently drop the displaced one
            with nodes.queue.mutex:
                head = (
                    nodes.queue.queue[0] if nodes.queue.queue else None
                )
            if head is None:
                return False
            kind = head[0]
            if kind not in ("BOOKMARK", "RECONNECT"):
                return True  # EVENT or GONE: tick's business
            item = nodes.queue.get_nowait()
            if item[0] == "BOOKMARK":
                self._applied_rv["nodes"] = max(
                    self._applied_rv["nodes"], item[1]
                )
            else:
                out.reconnects += 1
                self.reconnects_total += 1
                self.trace.emit(
                    "WATCH_RECONNECT",
                    detail={"resource": "nodes", "reason": item[1]},
                )
                if self.metrics is not None:
                    self.metrics.record_reconnect("nodes")

    def express_poll(
        self, timeout_s: float, max_events: int = 16,
        shed_queue: int = 0,
    ) -> ExpressEvents:
        """Block up to ``timeout_s`` for pod watch events between round
        ticks; returns as soon as a small batch is available.

        The express lane's event source: waits on the pods stream for
        the FIRST event, then drains whatever else already arrived (up
        to ``max_events`` — the express batch bound). rv accounting is
        shared with ``tick()`` so a later tick can never double-apply
        an express-consumed event. Anything outside the express
        vocabulary — node events waiting, a stream gone/undecodable,
        an un-seeded watcher — sets ``needs_tick`` and leaves the rest
        for the full observe tick (410/staleness resyncs stay on the
        tick path, where the snapshot-diff guards live).
        """
        out = ExpressEvents()
        pods = self._streams.get("pods")
        nodes = self._streams.get("nodes")
        if not self._seeded or pods is None or pods.gone.is_set():
            out.needs_tick = True
            return out
        if shed_queue > 0 and pods.queue.qsize() > shed_queue:
            # overload shed: more events are queued than the express
            # lane should grind through batch by batch — hand the
            # whole burst to the tick path's single full solve.
            # qsize() is advisory but one-sided-safe here: an
            # undercount delays the shed by one poll, never loses
            # events (they stay queued for tick()).
            out.needs_tick = True
            out.shed = True
            return out
        deadline = time.monotonic() + timeout_s
        while len(out.pod_events) < max_events:
            if self._express_nodes_pending(nodes, out):
                # node events reshape the machine axis: the express
                # patch vocabulary cannot follow, tick handles them
                out.needs_tick = True
                break
            try:
                if out.pod_events:
                    item = pods.queue.get_nowait()
                else:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        # zero-timeout poll (a stream lane's later
                        # window): drain what already arrived, never
                        # block
                        item = pods.queue.get_nowait()
                    else:
                        item = pods.queue.get(timeout=min(wait, 0.05))
            except queue.Empty:
                if out.pod_events or time.monotonic() >= deadline:
                    break
                continue
            if not out.pod_events:
                out.t_first = time.perf_counter()
            kind = item[0]
            if kind == "RECONNECT":
                out.reconnects += 1
                self.reconnects_total += 1
                self.trace.emit(
                    "WATCH_RECONNECT",
                    detail={"resource": "pods", "reason": item[1]},
                )
                if self.metrics is not None:
                    self.metrics.record_reconnect("pods")
            elif kind == "BOOKMARK":
                self._applied_rv["pods"] = max(
                    self._applied_rv["pods"], item[1]
                )
            elif kind == "GONE":
                # put it back for tick() so the resync keeps its reason
                pods.queue.put(item)
                out.needs_tick = True
                break
            else:  # EVENT
                _, rv, typ, obj = item
                if rv and rv <= self._applied_rv["pods"]:
                    continue  # replayed history: never double-apply
                try:
                    parsed = self._parse("pods", obj)
                except (KeyError, ValueError, TypeError) as e:
                    # same degradation as tick(): an unparseable event
                    # means the stream cannot be trusted — mark it gone
                    # with the real reason and let the tick resync
                    pods.queue.put(
                        ("GONE", f"unparseable {typ} event: {e!r}")
                    )
                    pods.gone.set()
                    out.needs_tick = True
                    break
                if rv:
                    self._applied_rv["pods"] = rv
                out.pod_events.append((typ, parsed))
                out.t_events.append(time.perf_counter())
        return out

    def express_poll_windows(
        self, timeout_s: float, max_events: int = 16,
        windows: int = 1, shed_queue: int = 0,
    ) -> list[ExpressEvents]:
        """The stream lane's event source: up to ``windows`` coalesced
        express windows from one poll call. The first window blocks
        like ``express_poll``; later windows only DRAIN what already
        arrived (timeout 0) — a backlogged stream fills K windows for
        one flush, an idle one returns a single window and the driver
        flushes short. Stops early at a window that needs the tick path
        (node events, gone stream, shed) or that came back empty; the
        list always carries at least one entry, and only its LAST entry
        can have ``needs_tick``/``shed`` set. rv accounting is shared
        with ``tick()`` exactly as in ``express_poll``."""
        out: list[ExpressEvents] = []
        for w in range(max(windows, 1)):
            ev = self.express_poll(
                timeout_s if w == 0 else 0.0,
                max_events=max_events, shed_queue=shed_queue,
            )
            if not ev.pod_events and w > 0 and not (
                ev.needs_tick or ev.shed or ev.reconnects
            ):
                break  # drained dry: flush what we have
            out.append(ev)
            if ev.needs_tick or ev.shed:
                break
        return out

    # ---- test helpers ----

    def wait_caught_up(self, rv: int, timeout_s: float = 5.0) -> bool:
        """Block until every stream has ENQUEUED events up to ``rv`` (or
        gone 410, which the next ``tick`` turns into a resync). Lets
        hermetic tests and chip_smoke.py make event arrival deterministic
        without polling ``tick`` in a loop."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(
                s.gone.is_set() or s.seen_rv >= rv
                for s in self._streams.values()
            ) and self._streams:
                return True
            if not self._seeded:
                return False
            time.sleep(0.005)
        return False


# re-exported for callers that only import the watch module
__all__ = [
    "ClusterWatcher",
    "ExpressEvents",
    "ObserveDelta",
    "WatchGone",
    "ApiError",
]
