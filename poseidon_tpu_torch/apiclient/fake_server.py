"""In-process fake Kubernetes apiserver for hermetic end-to-end tests.

The reference leaves this as a seam — all apiserver traffic goes through
one base URI (k8s_api_client.h:61) and the JSON shapes are documented in
comments (k8s_api_client.cc:96-99) — but never builds the fixture
(SURVEY §4: zero tests). This serves the core-v1 subset the client uses:

- ``GET /api/v1/nodes``  (optional labelSelector, exact-match subset)
- ``GET /api/v1/pods``
- ``GET /api/v1/{nodes,pods}?watch=true&resourceVersion=N`` — the watch
  protocol: a chunked stream of ``{"type": ADDED|MODIFIED|DELETED|
  BOOKMARK, "object": ...}`` lines for every mutation with rv > N, in
  mutation order, each object stamped with its ``metadata.
  resourceVersion``. Idle streams get a BOOKMARK (current rv, no
  object) and a clean close, like a real apiserver ending a watch
  window; clients reconnect from their last rv. A watch from an rv
  older than the retained event log answers ``410 Gone`` (both shapes
  the real control plane uses: a plain HTTP 410, and an in-stream
  ``ERROR`` event with ``code: 410``).
- ``POST /api/v1/namespaces/{ns}/bindings`` — applies the binding: the
  pod's ``spec.nodeName`` is set and its phase flips to Running on the
  NEXT poll or watch-stream wake (bindings are acknowledged before they
  are observable, like the real control plane).
- ``POST /api/v1/namespaces/{ns}/pods/{name}/eviction`` — unbinds the
  pod: ``spec.nodeName`` is cleared and its phase flips back to Pending
  on the NEXT poll. Evictions and bindings are applied in POST order,
  so a MIGRATE (evict + re-bind) lands as one visible move.

Fault injection for resilience tests: ``fail_next(n)`` makes the next n
requests return HTTP 500; ``rate_limit_next(n)`` answers 429 with a
``Retry-After`` header; ``disconnect_next(n)`` closes the connection
mid-body (a promised Content-Length never delivered); ``delay_next(n,
seconds)`` serves the next n requests only after sleeping — the HUNG
apiserver (the common real outage shape): a client whose socket
timeout is shorter sees a read timeout, not an error status;
``set_outage(True)`` answers EVERY request 503 until cleared (a whole
apiserver outage window, time-based rather than request-counted;
``writes_only=True`` fails only mutations — the reads-OK/writes-down
shape of an etcd write-quorum loss);
``drop_node(name)``
removes a node between polls (the node-removal path the reference never
handled) and — like the real node-lifecycle controller — orphans its
bound pods back to Pending (``orphan_pods=False`` restores the old
leave-them-bound behavior); ``truncate_lists(n)`` serves only the
first n items WITHOUT a
continue token (a partial snapshot masquerading as complete — the
failure mode the bridge's mass-eviction guard exists for). Watch-side:
``gone_next_watch(n)`` answers the next n watch connects with HTTP 410;
``disconnect_watch_next(n)`` cuts n active watch streams mid-event-flow
without a terminating chunk; ``corrupt_next_watch(n)`` emits undecodable
JSON lines; ``compact_watch_log()`` forgets all history so any resumed
rv is too old (the natural 410).

List requests honor ``limit``/``continue`` pagination the way the real
apiserver chunks responses, so the client's token-following is testable,
and every list carries ``metadata.resourceVersion`` so a watch can
continue exactly where the list snapshot ended.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class FakeApiServer:
    """Runs on a random localhost port; mutate state between polls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.nodes: dict[str, dict] = {}
        self.pods: dict[str, dict] = {}
        self.bindings: list[tuple[str, str]] = []
        self.evictions: list[str] = []
        # the ONE ordered actuation history ("bind"|"evict", pod, node)
        # in accepted-POST order — the chaos invariant checker's
        # exactly-once evidence (bindings/evictions above are separate
        # lists and lose the interleaving)
        self.op_log: list[tuple[str, str, str]] = []
        # bind/evict ops applied in POST order on the next pods poll
        self._pending_ops: list[tuple[str, str, str]] = []
        self._fail_next = 0
        self._rate_limit_next = 0
        self._rate_limit_retry_after = 0.05
        self._disconnect_next = 0
        # slow-response injection: the next n requests sleep this long
        # before answering (a HUNG apiserver — clients with shorter
        # socket timeouts see a read timeout, not an error)
        self._delay_next = 0
        self._delay_s = 0.0
        # outage window: while set, EVERY request answers 503 —
        # or only mutations (POST/PUT/DELETE) with writes_only, the
        # reads-OK/writes-down shape an etcd write-quorum loss has
        self._outage = False
        self._outage_writes_only = False
        # crash-consistency injection (ha/ tests): the next n mutation
        # POSTs are APPLIED and then the connection dies without a
        # response — the "op landed but the caller never learned"
        # world a process crash between POST and ack produces
        self._apply_then_disconnect_next = 0
        self._truncate = 0
        self.requests_served = 0
        # Lease objects (leader election): key "ns/name" ->
        # {holder, duration_s, renew_unix, transitions}
        self.leases: dict[str, dict] = {}
        # ---- watch protocol state ----
        # monotonic resourceVersion; every mutation appends one
        # (rv, kind, type, object-copy) record to the event log
        self._rv = 0
        self._events: list[tuple[int, str, str, dict]] = []
        # rv horizon: a watch may only resume from rv >= this (older
        # history has been compacted away -> 410 Gone)
        self._compact_floor = 0
        self._event_retention = 10_000
        self._gone_next_watch = 0
        self._disconnect_watch_next = 0
        self._corrupt_next_watch = 0
        self._closing = False
        # how long an idle watch stream waits for events before sending
        # a bookmark and closing cleanly (clients reconnect from rv)
        self.watch_idle_close_s = 0.25
        self.watch_bookmarks = True

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def _reply(
                self, code: int, doc: dict,
                headers: dict[str, str] | None = None,
            ):
                payload = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _drop_mid_body(self):
                """Promise a body, deliver half of it, cut the
                connection — the client's read raises IncompleteRead
                (the mid-body transport error class)."""
                payload = json.dumps({"items": []}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header(
                    "Content-Length", str(len(payload) * 2)
                )
                self.end_headers()
                self.wfile.write(payload)
                self.wfile.flush()
                self.close_connection = True

            def _injected_fault(self, write: bool = False) -> str:
                """Consume one injected request-level fault, if armed."""
                with server._lock:
                    server.requests_served += 1
                    if server._outage and (
                        write or not server._outage_writes_only
                    ):
                        return "outage"
                    if server._fail_next > 0:
                        server._fail_next -= 1
                        return "fail"
                    if server._rate_limit_next > 0:
                        server._rate_limit_next -= 1
                        return "rate"
                    if server._disconnect_next > 0:
                        server._disconnect_next -= 1
                        return "disconnect"
                    if server._delay_next > 0:
                        server._delay_next -= 1
                        return "delay"
                return ""

            def _apply_fault(self, fault: str) -> bool:
                if fault == "fail":
                    self._reply(500, {"error": "injected"})
                elif fault == "outage":
                    self._reply(503, {"error": "outage window"})
                elif fault == "rate":
                    self._reply(
                        429, {"error": "throttled"},
                        headers={
                            "Retry-After":
                                str(server._rate_limit_retry_after)
                        },
                    )
                elif fault == "disconnect":
                    self._drop_mid_body()
                elif fault == "delay":
                    # slow, not broken: sleep OUTSIDE the lock, then
                    # serve normally — a client whose socket timeout is
                    # shorter has hung up by then (its write error is
                    # swallowed by the quiet server's handle_error)
                    time.sleep(server._delay_s)
                    return False
                else:
                    return False
                return True

            def do_GET(self):
                if self._apply_fault(self._injected_fault()):
                    return
                url = urlparse(self.path)
                query = parse_qs(url.query)
                if (
                    query.get("watch", ["false"])[0] == "true"
                    and url.path in ("/api/v1/nodes", "/api/v1/pods")
                ):
                    try:
                        self._serve_watch(
                            url.path.rsplit("/", 1)[1], query
                        )
                    except (OSError, ValueError):
                        pass  # client went away mid-stream
                    return
                with server._lock:
                    selector = query.get("labelSelector", [""])[0]
                    parts = url.path.strip("/").split("/")
                    if url.path == "/api/v1/nodes":
                        items = server._select(
                            server.nodes.values(), selector
                        )
                        self._reply(200, server._page(items, query))
                    elif url.path == "/api/v1/pods":
                        server._apply_pending()
                        items = server._select(
                            server.pods.values(), selector
                        )
                        self._reply(200, server._page(items, query))
                    # api/v1/namespaces/{ns}/pods/{name}: the single-
                    # pod read the binding-conflict check and the
                    # actuation-journal replay decide idempotency from
                    elif (
                        len(parts) == 6
                        and parts[2] == "namespaces"
                        and parts[4] == "pods"
                    ):
                        server._apply_pending()
                        doc = server.pods.get(f"{parts[3]}/{parts[5]}")
                        if doc is None:
                            self._reply(
                                404,
                                {"error": f"no pod "
                                          f"{parts[3]}/{parts[5]}"},
                            )
                        else:
                            self._reply(200, doc)
                    # api/v1/namespaces/{ns}/leases/{name}
                    elif (
                        len(parts) == 6
                        and parts[2] == "namespaces"
                        and parts[4] == "leases"
                    ):
                        lease = server.leases.get(
                            f"{parts[3]}/{parts[5]}"
                        )
                        if lease is None:
                            self._reply(404, {"error": self.path})
                        else:
                            self._reply(
                                200, server._lease_doc(
                                    parts[3], parts[5], lease
                                )
                            )
                    else:
                        self._reply(404, {"error": self.path})

            # ---- the watch stream ----------------------------------

            def _chunk(self, doc: dict) -> None:
                self._chunk_raw(json.dumps(doc).encode() + b"\n")

            def _chunk_raw(self, data: bytes) -> None:
                self.wfile.write(
                    f"{len(data):X}\r\n".encode() + data + b"\r\n"
                )
                self.wfile.flush()

            def _serve_watch(self, kind: str, query: dict) -> None:
                rv = int(
                    query.get("resourceVersion", ["0"])[0] or 0
                )
                with server._lock:
                    if server._gone_next_watch > 0:
                        server._gone_next_watch -= 1
                        gone = "http"
                    elif rv < server._compact_floor:
                        gone = "stream"
                    else:
                        gone = ""
                if gone == "http":
                    self._reply(
                        410,
                        {"kind": "Status", "code": 410,
                         "reason": "Expired"},
                    )
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                if gone == "stream":
                    # the real apiserver's other 410 shape: an ERROR
                    # event inside an accepted stream
                    self._chunk({
                        "type": "ERROR",
                        "object": {"kind": "Status", "code": 410,
                                   "reason": "Expired"},
                    })
                    self._chunk_raw(b"")
                    return
                while True:
                    with server._cond:
                        if server._closing:
                            break
                        server._apply_pending()
                        batch = server._events_after(rv, kind)
                        if not batch:
                            server._cond.wait(
                                server.watch_idle_close_s
                            )
                            if server._closing:
                                break
                            server._apply_pending()
                            batch = server._events_after(rv, kind)
                        cur_rv = server._rv
                        disconnect = corrupt = False
                        if batch:
                            if server._disconnect_watch_next > 0:
                                server._disconnect_watch_next -= 1
                                disconnect = True
                            elif server._corrupt_next_watch > 0:
                                server._corrupt_next_watch -= 1
                                corrupt = True
                    if disconnect:
                        # mid-stream cut: one event goes out, then the
                        # connection dies without a terminating chunk
                        self._chunk({
                            "type": batch[0][2], "object": batch[0][3],
                        })
                        self.connection.close()
                        return
                    if corrupt:
                        self._chunk_raw(b'{"type": "ADDED", "obj\n')
                        self._chunk_raw(b"")
                        return
                    if batch:
                        for rv_i, _k, typ, obj in batch:
                            self._chunk({"type": typ, "object": obj})
                            rv = rv_i
                        continue
                    # idle window elapsed: bookmark + clean close
                    if server.watch_bookmarks:
                        self._chunk({
                            "type": "BOOKMARK",
                            "object": {
                                "kind": kind,
                                "metadata": {
                                    "resourceVersion": str(cur_rv)
                                },
                            },
                        })
                    break
                self._chunk_raw(b"")  # terminating chunk

            def do_POST(self):
                fault = self._injected_fault(write=True)
                if self._apply_fault(fault):
                    return
                with server._lock:
                    url = urlparse(self.path)
                    parts = url.path.strip("/").split("/")
                    # api/v1/namespaces/{ns}/bindings
                    if (
                        len(parts) == 5
                        and parts[2] == "namespaces"
                        and parts[4] == "bindings"
                    ):
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n) or b"{}")
                        pod = body["metadata"]["name"]
                        node = body["target"]["name"]
                        # pods are stored per namespace (the URL names
                        # it) — same-named pods in two namespaces are
                        # distinct objects, like the real apiserver
                        key = f"{parts[3]}/{pod}"
                        if key not in server.pods:
                            self._reply(404, {"error": f"no pod {key}"})
                            return
                        if node not in server.nodes:
                            self._reply(404, {"error": f"no node {node}"})
                            return
                        # the real apiserver answers 409 Conflict when
                        # a binding already exists; queued ops fold in
                        # first so "already bound" is authoritative in
                        # POST order (a MIGRATE's evict+bind still
                        # lands as one move)
                        server._apply_pending()
                        cur = server.pods[key].get("spec", {}).get(
                            "nodeName", ""
                        )
                        if cur:
                            self._reply(
                                409,
                                {"kind": "Status", "code": 409,
                                 "reason": "Conflict",
                                 "message": f"pod {key} is already "
                                            f"bound to {cur}"},
                            )
                            return
                        server._pending_ops.append(("bind", key, node))
                        server.bindings.append((key, node))
                        server.op_log.append(("bind", key, node))
                        # wake parked watch streams so the binding
                        # becomes observable at their next wake, like
                        # the next poll would make it
                        server._cond.notify_all()
                        if server._take_apply_then_disconnect():
                            # crash injection: the op IS applied, the
                            # caller never hears back
                            self.close_connection = True
                            return
                        self._reply(201, {"status": "Bound"})
                    # api/v1/namespaces/{ns}/pods/{name}/eviction
                    elif (
                        len(parts) == 7
                        and parts[2] == "namespaces"
                        and parts[4] == "pods"
                        and parts[6] == "eviction"
                    ):
                        key = f"{parts[3]}/{parts[5]}"
                        if key not in server.pods:
                            self._reply(404, {"error": f"no pod {key}"})
                            return
                        server._pending_ops.append(("evict", key, ""))
                        server.evictions.append(key)
                        server.op_log.append(("evict", key, ""))
                        server._cond.notify_all()
                        if server._take_apply_then_disconnect():
                            self.close_connection = True
                            return
                        self._reply(201, {"status": "Evicted"})
                    else:
                        self._reply(404, {"error": self.path})

            # ---- leases (leader election, ha/standby.py) -----------

            def do_PUT(self):
                if self._apply_fault(self._injected_fault(write=True)):
                    return
                url = urlparse(self.path)
                parts = url.path.strip("/").split("/")
                if not (
                    len(parts) == 6
                    and parts[2] == "namespaces"
                    and parts[4] == "leases"
                ):
                    self._reply(404, {"error": self.path})
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                spec = body.get("spec", {})
                holder = str(spec.get("holderIdentity", ""))
                duration = float(
                    spec.get("leaseDurationSeconds", 15) or 15
                )
                key = f"{parts[3]}/{parts[5]}"
                with server._lock:
                    cur = server.leases.get(key)
                    now = time.time()
                    expired = (
                        cur is not None
                        and now - cur["renew_unix"] > cur["duration_s"]
                    )
                    if (cur is None or expired
                            or cur["holder"] == holder):
                        transitions = (
                            cur["transitions"]
                            + (1 if cur["holder"] != holder else 0)
                        ) if cur is not None else 0
                        server.leases[key] = {
                            "holder": holder,
                            "duration_s": duration,
                            "renew_unix": now,
                            "transitions": transitions,
                        }
                        self._reply(
                            200, server._lease_doc(
                                parts[3], parts[5], server.leases[key]
                            )
                        )
                    else:
                        self._reply(
                            409,
                            {"kind": "Status", "code": 409,
                             "reason": "Conflict",
                             "details": {"holder": cur["holder"]}},
                        )

            def do_DELETE(self):
                if self._apply_fault(self._injected_fault(write=True)):
                    return
                url = urlparse(self.path)
                query = parse_qs(url.query)
                parts = url.path.strip("/").split("/")
                if not (
                    len(parts) == 6
                    and parts[2] == "namespaces"
                    and parts[4] == "leases"
                ):
                    self._reply(404, {"error": self.path})
                    return
                key = f"{parts[3]}/{parts[5]}"
                identity = query.get("holderIdentity", [""])[0]
                with server._lock:
                    cur = server.leases.get(key)
                    if cur is None:
                        self._reply(404, {"error": self.path})
                    elif identity and cur["holder"] != identity:
                        self._reply(
                            409,
                            {"kind": "Status", "code": 409,
                             "reason": "Conflict",
                             "details": {"holder": cur["holder"]}},
                        )
                    else:
                        del server.leases[key]
                        self._reply(200, {"status": "Released"})

        class _QuietServer(ThreadingHTTPServer):
            # the daemon POSTs bindings from a 16-thread pool: a listen
            # backlog of socketserver's default 5 drops connects, and
            # each dropped one waits a 1 s SYN retransmit
            request_queue_size = 128

            def handle_error(self, request, client_address):
                # a delayed reply hitting a hung-up client (the
                # delay_next injection outliving the client's socket
                # timeout) is the EXPECTED outcome, not a server bug —
                # keep the default traceback spam out of test output
                import sys
                exc = sys.exc_info()[1]
                if isinstance(exc, (BrokenPipeError,
                                    ConnectionResetError)):
                    return
                super().handle_error(request, client_address)

        self._httpd = _QuietServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        # a short poll interval: stop() waits for one
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> "FakeApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- state helpers -------------------------------------------------

    def _emit(self, kind: str, typ: str, obj: dict) -> None:
        """Append one watch event (lock held). The object is deep-copied
        and stamped with its rv, since the live dicts mutate in place."""
        self._rv += 1
        copy = json.loads(json.dumps(obj))
        copy.setdefault("metadata", {})["resourceVersion"] = str(
            self._rv
        )
        self._events.append((self._rv, kind, typ, copy))
        if len(self._events) > self._event_retention:
            # trim in one slice (amortized O(1) per event, not a
            # pop(0) shuffle of the whole retained log each time)
            cut = len(self._events) - self._event_retention
            self._compact_floor = self._events[cut - 1][0]
            del self._events[:cut]
        self._cond.notify_all()

    def _events_after(self, rv: int, kind: str) -> list[tuple]:
        """Events with rv' > rv for ``kind`` (lock held). The log is
        rv-sorted, so the resume point is a binary search — a stream
        wake is O(log E + batch), not a rescan of the retained log."""
        idx = bisect.bisect_right(self._events, rv, key=lambda e: e[0])
        return [e for e in self._events[idx:] if e[1] == kind]

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def apply_pending(self) -> None:
        """Make queued bind/evict ops observable NOW (tests use this to
        pin the visibility point that a poll's GET or a watch stream's
        next wake would otherwise pick nondeterministically)."""
        with self._lock:
            self._apply_pending()

    @staticmethod
    def _lease_doc(ns: str, name: str, lease: dict) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "holderIdentity": lease["holder"],
                "leaseDurationSeconds": lease["duration_s"],
                "renewTime": lease["renew_unix"],
                "leaseTransitions": lease["transitions"],
            },
        }

    def _take_apply_then_disconnect(self) -> bool:
        """Consume one armed apply-then-disconnect fault (lock held)."""
        if self._apply_then_disconnect_next > 0:
            self._apply_then_disconnect_next -= 1
            return True
        return False

    @staticmethod
    def _select(items, selector: str) -> list[dict]:
        out = list(items)
        if selector:
            want = dict(
                kv.split("=", 1) for kv in selector.split(",") if "=" in kv
            )
            out = [
                i for i in out
                if all(
                    i.get("metadata", {}).get("labels", {}).get(k) == v
                    for k, v in want.items()
                )
            ]
        return out

    def _page(self, items: list[dict], query: dict) -> dict:
        """Apply truncation fault, then limit/continue chunking. The
        continue token is the plain offset (opaque to clients anyway).
        Every page carries the list's ``resourceVersion``."""
        if self._truncate > 0:
            items = items[: self._truncate]
        offset = int(query.get("continue", ["0"])[0] or 0)
        limit = int(query.get("limit", ["0"])[0] or 0)
        meta = {"resourceVersion": str(self._rv)}
        if limit <= 0:
            return {"items": items[offset:], "metadata": meta}
        chunk = items[offset: offset + limit]
        doc: dict = {"items": chunk, "metadata": meta}
        if offset + limit < len(items):
            doc["metadata"]["continue"] = str(offset + limit)
        return doc

    def _apply_pending(self) -> None:
        """Bindings/evictions become observable on the next pods poll or
        watch-stream wake, applied in POST order (a MIGRATE's evict +
        re-bind collapses to one visible move)."""
        for op, pod, node in self._pending_ops:
            doc = self.pods.get(pod)
            if doc is None:
                continue
            if op == "bind":
                doc.setdefault("spec", {})["nodeName"] = node
                doc.setdefault("status", {})["phase"] = "Running"
            else:  # evict
                doc.setdefault("spec", {}).pop("nodeName", None)
                doc.setdefault("status", {})["phase"] = "Pending"
            self._emit("pods", "MODIFIED", doc)
        self._pending_ops.clear()

    def add_node(
        self,
        name: str,
        *,
        cpu: str = "8",
        memory: str = "16Gi",
        pods: int = 10,
        rack: str = "",
        alloc_cpu: str = "",
        alloc_memory: str = "",
    ) -> None:
        """Add or replace a node. ``alloc_cpu``/``alloc_memory`` set
        its allocatable resources apart from its capacity (empty = the
        capacity)."""
        labels = {"rack": rack} if rack else {}
        with self._lock:
            typ = "MODIFIED" if name in self.nodes else "ADDED"
            self.nodes[name] = {
                "metadata": {"name": name, "labels": labels},
                "status": {
                    "capacity": {
                        "cpu": cpu, "memory": memory, "pods": str(pods),
                    },
                    "allocatable": {
                        "cpu": alloc_cpu or cpu,
                        "memory": alloc_memory or memory,
                        "pods": str(pods),
                    },
                },
            }
            self._emit("nodes", typ, self.nodes[name])

    def add_pod(
        self,
        name: str,
        *,
        namespace: str = "default",
        cpu: str = "100m",
        memory: str = "128Mi",
        job: str = "",
        data_prefs: dict[str, int] | None = None,
        phase: str = "Pending",
        node: str = "",
    ) -> None:
        meta: dict = {"name": name, "namespace": namespace, "labels": {}}
        if job:
            meta["labels"]["job-name"] = job
        if data_prefs:
            meta["annotations"] = {
                "poseidon.io/data-prefs": json.dumps(data_prefs)
            }
        key = f"{namespace}/{name}"
        with self._lock:
            typ = "MODIFIED" if key in self.pods else "ADDED"
            self.pods[key] = {
                "metadata": meta,
                "spec": {
                    "containers": [
                        {
                            "resources": {
                                "requests": {"cpu": cpu, "memory": memory}
                            }
                        }
                    ],
                    **({"nodeName": node} if node else {}),
                },
                "status": {"phase": phase},
            }
            self._emit("pods", typ, self.pods[key])

    def delete_pod(self, name: str, namespace: str = "default") -> None:
        """Remove a pod outright (k8s object deletion -> DELETED event;
        polls simply stop listing it)."""
        key = name if "/" in name else f"{namespace}/{name}"
        with self._lock:
            doc = self.pods.pop(key, None)
            if doc is not None:
                self._emit("pods", "DELETED", doc)

    def drop_node(self, name: str, orphan_pods: bool = True) -> None:
        """Remove a node. Like the real node-lifecycle controller,
        pods bound to it are orphaned back to Pending (nodeName
        cleared, MODIFIED events) so the scheduler's re-placement
        bindings do not 409 against a binding to a dead node;
        ``orphan_pods=False`` leaves them bound (the stale-cache
        shape some control planes expose briefly)."""
        with self._lock:
            doc = self.nodes.pop(name, None)
            if doc is not None:
                # fold queued bind/evict ops FIRST: a bind POSTed but
                # not yet applied to this node would otherwise escape
                # the orphan scan (nodeName still unset) and later
                # land the pod Running on a dead node
                self._apply_pending()
                self._emit("nodes", "DELETED", doc)
                if orphan_pods:
                    for key, pod in self.pods.items():
                        if pod.get("spec", {}).get("nodeName") == name:
                            pod["spec"].pop("nodeName", None)
                            pod.setdefault("status", {})[
                                "phase"] = "Pending"
                            # the op_log's "this pod may legitimately
                            # be re-bound" marker (chaos exactly-once
                            # checker): node death, not an eviction
                            self.op_log.append(("orphan", key, name))
                            self._emit("pods", "MODIFIED", pod)

    def fail_next(self, n: int) -> None:
        with self._lock:
            self._fail_next = n

    def rate_limit_next(self, n: int, retry_after_s: float = 0.05) -> None:
        """Answer the next n requests with 429 + ``Retry-After``."""
        with self._lock:
            self._rate_limit_next = n
            self._rate_limit_retry_after = retry_after_s

    def disconnect_next(self, n: int) -> None:
        """Cut the next n requests mid-body (Content-Length promised,
        half delivered)."""
        with self._lock:
            self._disconnect_next = n

    def delay_next(self, n: int, seconds: float) -> None:
        """Serve the next n requests only after sleeping ``seconds``
        — the hung apiserver. A client whose socket timeout is
        shorter sees a READ TIMEOUT (counted distinctly from 5xx in
        ``K8sApiClient.retry_stats``), not an error status; the
        request is otherwise served normally after the sleep."""
        with self._lock:
            self._delay_next = n
            self._delay_s = seconds

    def set_outage(self, on: bool, writes_only: bool = False) -> None:
        """An apiserver outage window: while on, EVERY request
        (lists, watches, mutations, leases) answers 503. Time-based
        where ``fail_next`` is request-counted — the shape a real
        control-plane outage has. ``writes_only=True`` fails only the
        mutations (POST/PUT/DELETE) while reads keep answering — the
        reads-OK/writes-down shape an etcd write-quorum loss produces
        (a successful poll must NOT clear a declared outage while
        actuations still cannot land)."""
        with self._lock:
            self._outage = on
            self._outage_writes_only = writes_only

    def apply_then_disconnect_next(self, n: int) -> None:
        """The crash-consistency fault: the next n mutation POSTs are
        APPLIED server-side, then the connection dies without a
        response — exactly what a scheduler crash between the POST
        landing and the ack being read produces. The caller's journal
        replay must treat the re-issued op as already-applied (bind
        409-on-same-target = success), never double-actuate."""
        with self._lock:
            self._apply_then_disconnect_next = n

    def gone_next_watch(self, n: int) -> None:
        """Answer the next n watch connects with HTTP 410 Gone."""
        with self._lock:
            self._gone_next_watch = n

    def disconnect_watch_next(self, n: int) -> None:
        """Cut n watch streams mid-event-flow (one event delivered,
        then the connection dies without a terminating chunk)."""
        with self._lock:
            self._disconnect_watch_next = n

    def corrupt_next_watch(self, n: int) -> None:
        """Emit undecodable JSON on n watch streams (the decode-error
        degrade path)."""
        with self._lock:
            self._corrupt_next_watch = n

    def compact_watch_log(self) -> None:
        """Forget all watch history: any resumed rv is now too old, so
        the next reconnect gets the in-stream 410 ERROR event."""
        with self._lock:
            self._compact_floor = self._rv
            self._events.clear()

    def truncate_lists(self, n: int) -> None:
        """Serve only the first n items of every list, with no continue
        token (0 restores full lists)."""
        with self._lock:
            self._truncate = n

    def succeed_pod(self, name: str, namespace: str = "default") -> None:
        key = name if "/" in name else f"{namespace}/{name}"
        with self._lock:
            doc = self.pods.get(key)
            if doc is not None:
                doc["status"]["phase"] = "Succeeded"
                self._emit("pods", "MODIFIED", doc)
