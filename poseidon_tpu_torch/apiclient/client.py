"""Kubernetes core-v1 REST client (the reference's five-operation surface).

Mirrors src/apiclient/k8s_api_client.{h,cc}: GET ``nodes`` / ``pods``
(optionally label-filtered) parsed into the framework's ``Machine`` /
``Task`` DTOs, and the bindings POST that makes placements real
(k8s_api_client.cc:67-94, JSON shape at :75-79). Differences on purpose:

- unit parsing is correct for the full k8s quantity grammar (m-suffixed
  CPU, Ki/Mi/Gi/K/M/G memory) instead of the reference's "strip the last
  two characters and hope it was Ki" (k8s_api_client.cc:260-265) — a
  noted fidelity gap (SURVEY §3.4);
- the namespace comes from the pod instead of being hardcoded
  ``default`` (k8s_api_client.cc:222);
- transport errors raise ``ApiError`` after bounded retries instead of
  dissolving into logged JSON (utils.cc:47-61); the daemon loop decides
  to skip the tick. Retries use jittered exponential backoff and apply
  only to failures that CAN heal (429, 5xx, transport/decode errors);
  a 404/400 fails fast — re-asking the same question three times just
  delays the inevitable and hammers a struggling apiserver. A 429's
  ``Retry-After`` header is honored as a lower bound on the delay;
- list pagination is followed (``metadata.continue`` tokens, chunked via
  ``limit``). The reference does one unpaginated GET and parses whatever
  came back (k8s_api_client.cc:100-160); against an apiserver that
  chunks its responses that silently drops every item after the first
  page — and a dropped page reads as "those pods/nodes are gone", which
  would mass-evict scheduler state. A page fetch that still fails after
  retries raises instead of returning the partial list for the same
  reason.

Transport is stdlib urllib on purpose: the control plane is a few small
JSON GETs per 10-second tick (deploy/poseidon.cfg / --polling_frequency),
three orders of magnitude off the solve path.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable

from poseidon_tpu_torch.cluster import Machine, Task, TaskPhase

log = logging.getLogger(__name__)

RACK_LABELS = (
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
    "rack",
)


class ApiError(RuntimeError):
    """The apiserver could not be reached or answered garbage.

    ``code`` carries the HTTP status when one was received (0 for
    transport-level failures), so callers can branch on protocol
    answers — 404 pod-gone in ``get_pod``, 409 binding-conflict in
    ``bind_pod_to_node``, 409 lease-held in ``acquire_lease`` —
    without parsing the message string.
    """

    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


def backoff_delay(
    attempt: int,
    *,
    base_s: float = 0.05,
    cap_s: float = 2.0,
    rng: Callable[[], float] = random.random,
) -> float:
    """Jittered exponential backoff: ``min(cap, base·2^attempt)``
    scaled by a uniform [0.5, 1.5) jitter factor.

    The jitter matters operationally: a fleet of schedulers whose
    apiserver hiccuped would otherwise all retry on the same metronome
    and re-create the thundering herd that caused the hiccup. Shared by
    the request retry loop here and the watch-stream reconnects
    (apiclient/watch.py).
    """
    return min(cap_s, base_s * (2.0 ** attempt)) * (0.5 + rng())


# retry-stat classes: every retried failure is attributed to exactly
# one of these, so "the apiserver is hanging" (timeout) reads
# differently from "the apiserver is erroring" (5xx) in the stats —
# a hung apiserver is the common real-world outage shape and the two
# need different operator responses (socket timeouts vs error budgets)
RETRY_CLASSES = ("5xx", "429", "timeout", "transport", "decode")


def _failure_class(e: Exception) -> str:
    """Attribute one retried failure to a RETRY_CLASSES bucket."""
    if isinstance(e, urllib.error.HTTPError):
        return "429" if e.code == 429 else "5xx"
    if isinstance(e, json.JSONDecodeError):
        return "decode"
    # socket timeouts surface either bare (http.client reads) or
    # wrapped in URLError(reason=timeout) (urlopen connects)
    if isinstance(e, TimeoutError):
        return "timeout"
    if isinstance(e, urllib.error.URLError) and isinstance(
        getattr(e, "reason", None), TimeoutError
    ):
        return "timeout"
    return "transport"


def _wire_failure(code: int) -> bool:
    """True when an ApiError's code means the WIRE (not the request)
    is the problem: transport-level (0), throttled past the retry
    budget (429), or server-side trouble (5xx). The single source of
    the outage ladder's unreachable-vs-rejected split — bind and
    evict must never disagree on it."""
    return code == 0 or code == 429 or code >= 500


def parse_cpu(q: str | int | float) -> float:
    """k8s CPU quantity -> cores ("100m" -> 0.1, "2" -> 2.0)."""
    if isinstance(q, (int, float)):
        return float(q)
    q = q.strip()
    if not q:
        return 0.0
    if q.endswith("m"):
        return float(q[:-1]) / 1000.0
    return float(q)


_MEM_FACTORS = {"Ki": 1, "Mi": 1 << 10, "Gi": 1 << 20, "Ti": 1 << 30}


def parse_memory_kb(q: str | int) -> int:
    """k8s memory quantity -> KiB ("128Mi" -> 131072, "1Gi" -> 1048576,
    plain integers are bytes)."""
    if isinstance(q, int):
        return q >> 10
    q = q.strip()
    if not q:
        return 0
    for suffix in ("Ki", "Mi", "Gi", "Ti"):
        if q.endswith(suffix):
            return int(float(q[: -len(suffix)]) * _MEM_FACTORS[suffix])
    for suffix, f in (("T", 976562500), ("G", 976563), ("M", 977),
                      ("k", 1), ("K", 1)):
        if q.endswith(suffix):
            return int(float(q[:-1]) * f)
    return int(q) >> 10  # bare bytes


class K8sApiClient:
    """Five operations against one base URI (k8s_api_client.h:44-48)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 8080,
        api_version: str = "v1",
        *,
        timeout_s: float = 10.0,
        retries: int = 2,
        page_limit: int = 500,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
    ):
        self.base = f"http://{host}:{port}/api/{api_version}"
        self.timeout_s = timeout_s
        self.retries = retries
        self.page_limit = page_limit
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # per-class retried-failure counts (RETRY_CLASSES); requests
        # run concurrently from the binding-POST pool, so increments
        # hold a lock. A hung apiserver ("timeout") is counted
        # distinctly from an erroring one ("5xx").
        self.retry_stats: dict[str, int] = dict.fromkeys(
            RETRY_CLASSES, 0
        )
        self._stats_lock = threading.Lock()
        log.info("k8s api client -> %s", self.base)

    # ---- transport -----------------------------------------------------

    def _count_failure(self, e: Exception) -> None:
        with self._stats_lock:
            self.retry_stats[_failure_class(e)] += 1

    def _request(
        self, path: str, body: dict | None = None,
        method: str | None = None,
    ) -> dict:
        url = f"{self.base}/{path}"
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            retry_after = ""
            try:
                req = urllib.request.Request(
                    url, data=data, headers=headers, method=method
                )
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as resp:
                    payload = resp.read()
                return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as e:
                # checked BEFORE the transport clause: HTTPError is an
                # OSError, and retrying a 404/400 just burns every
                # attempt on an answer that will not change. Only 429
                # (throttled) and 5xx (server-side trouble) can heal.
                if e.code != 429 and e.code < 500:
                    raise ApiError(
                        f"{url}: HTTP {e.code}", code=e.code
                    ) from e
                if e.code == 429:
                    retry_after = e.headers.get("Retry-After", "")
                last = e
                self._count_failure(e)
            except (
                OSError,
                http.client.HTTPException,
                json.JSONDecodeError,
            ) as e:
                # OSError covers URLError, TimeoutError AND the raw
                # socket errors (ConnectionResetError) that surface
                # under concurrent bindings POSTs mid-body-read;
                # HTTPException covers IncompleteRead when the server
                # drops the connection mid-body. A socket timeout (the
                # hung-apiserver case) is attributed to its own retry-
                # stat class, distinct from 5xx/transport.
                last = e
                self._count_failure(e)
            if attempt < self.retries:
                delay = backoff_delay(
                    attempt,
                    base_s=self.backoff_base_s,
                    cap_s=self.backoff_cap_s,
                )
                if retry_after:
                    try:
                        delay = max(delay, float(retry_after))
                    except ValueError:
                        pass  # HTTP-date form: keep the jittered delay
                time.sleep(delay)
        raise ApiError(
            f"{url}: {last}",
            code=last.code
            if isinstance(last, urllib.error.HTTPError) else 0,
        ) from last

    def _list(self, resource: str, selector: str = "") -> list[dict]:
        return self._list_rv(resource, selector)[0]

    def _list_rv(
        self, resource: str, selector: str = ""
    ) -> tuple[list[dict], int]:
        """Chunked list: follow ``metadata.continue`` until exhausted.
        Returns ``(items, resourceVersion)`` — the rv is the watch
        protocol's starting point (apiclient/watch.py).

        All pages of one logical list are fetched before parsing; a page
        failure (after per-request retries) raises so the caller never
        sees a silently truncated snapshot — the bridge would read the
        missing tail as mass deletion.
        """
        items: list[dict] = []
        token = ""
        rv = 0
        # bounded like every other failure mode in this client: a server
        # that replays the same continue token (or pages forever) must
        # surface as a skipped tick, not a silent daemon hang
        max_pages = 10_000
        for _ in range(max_pages):
            params: dict[str, str] = {}
            if selector:
                params["labelSelector"] = selector
            if self.page_limit > 0:
                params["limit"] = str(self.page_limit)
            if token:
                params["continue"] = token
            path = resource
            if params:
                path += "?" + urllib.parse.urlencode(params)
            doc = self._request(path)
            items.extend(doc.get("items", []))
            meta = doc.get("metadata", {})
            try:
                rv = int(meta.get("resourceVersion", rv) or rv)
            except (TypeError, ValueError):
                pass  # apiservers may use opaque rvs; watch needs ints
            next_token = meta.get("continue", "") or ""
            if not next_token:
                return items, rv
            if next_token == token:
                raise ApiError(
                    f"{resource}: apiserver replayed continue token "
                    f"{token!r}"
                )
            token = next_token
        raise ApiError(f"{resource}: pagination exceeded {max_pages} pages")

    # ---- nodes ---------------------------------------------------------

    def nodes_with_label(self, selector: str = "") -> list[Machine]:
        out = []
        for item in self._list("nodes", selector):
            try:
                out.append(self._parse_node(item))
            except (KeyError, ValueError) as e:
                log.error("skipping unparseable node: %s", e)
        return out

    def all_nodes(self) -> list[Machine]:
        return self.nodes_with_label("")

    def nodes_with_rv(self) -> tuple[list[Machine], int]:
        """Full node list plus the list's ``resourceVersion`` — the
        snapshot+rv pair a watch stream continues from."""
        items, rv = self._list_rv("nodes")
        out = []
        for item in items:
            try:
                out.append(self._parse_node(item))
            except (KeyError, ValueError) as e:
                log.error("skipping unparseable node: %s", e)
        return out, rv

    @staticmethod
    def _parse_node(item: dict) -> Machine:
        meta = item["metadata"]
        status = item.get("status", {})
        cap = status.get("capacity", {})
        alloc = status.get("allocatable", cap)
        labels = meta.get("labels", {})
        rack = ""
        for key in RACK_LABELS:
            if key in labels:
                rack = labels[key]
                break
        return Machine(
            name=meta["name"],
            cpu_capacity=parse_cpu(cap.get("cpu", "0")),
            cpu_allocatable=parse_cpu(alloc.get("cpu", "0")),
            memory_capacity_kb=parse_memory_kb(cap.get("memory", "0")),
            memory_allocatable_kb=parse_memory_kb(
                alloc.get("memory", "0")
            ),
            rack=rack,
            max_tasks=int(cap.get("pods", 0) or 0),
        )

    # ---- pods ----------------------------------------------------------

    def pods_with_label(self, selector: str = "") -> list[Task]:
        out = []
        for item in self._list("pods", selector):
            try:
                out.append(self._parse_pod(item))
            except (KeyError, ValueError) as e:
                log.error("skipping unparseable pod: %s", e)
        return out

    def all_pods(self) -> list[Task]:
        return self.pods_with_label("")

    def pods_with_rv(self) -> tuple[list[Task], int]:
        """Full pod list plus the list's ``resourceVersion``."""
        items, rv = self._list_rv("pods")
        out = []
        for item in items:
            try:
                out.append(self._parse_pod(item))
            except (KeyError, ValueError) as e:
                log.error("skipping unparseable pod: %s", e)
        return out, rv

    @staticmethod
    def _parse_pod(item: dict) -> Task:
        meta = item["metadata"]
        spec = item.get("spec", {})
        status = item.get("status", {})
        cpu = 0.0
        mem_kb = 0
        for c in spec.get("containers", []):
            req = c.get("resources", {}).get("requests", {})
            cpu += parse_cpu(req.get("cpu", "0"))
            mem_kb += parse_memory_kb(req.get("memory", "0"))
        annotations = meta.get("annotations", {})
        prefs: dict[str, int] = {}
        raw_prefs = annotations.get("poseidon.io/data-prefs", "")
        if raw_prefs:
            try:
                prefs = {
                    k: int(v) for k, v in json.loads(raw_prefs).items()
                }
            except (json.JSONDecodeError, ValueError):
                log.error("bad data-prefs annotation on %s", meta["name"])
        phase_raw = status.get("phase", "Unknown")
        try:
            phase = TaskPhase(phase_raw)
        except ValueError:
            phase = TaskPhase.UNKNOWN
        ns = meta.get("namespace", "default")
        job = meta.get("labels", {}).get("job-name", "")
        return Task(
            # namespace-qualified: pod (and job) names are only unique
            # per namespace; the bridge keys all state by uid, and the
            # graph builder buckets tasks by job_id — an unqualified
            # job label would merge same-named jobs across namespaces
            # into one unscheduled aggregator
            uid=f"{ns}/{meta['name']}",
            namespace=ns,
            job=f"{ns}/{job}" if job else "",
            cpu_request=cpu,
            memory_request_kb=mem_kb,
            phase=phase,
            machine=spec.get("nodeName", "") or "",
            data_prefs=prefs,
        )

    def get_pod(
        self, pod: str, namespace: str = "default"
    ) -> Task | None:
        """One pod's current state, or None when it no longer exists.

        The idempotency primitive: the binding-conflict check and the
        actuation-journal replay (ha/journal.py) both decide "has this
        op's effect already landed" from the answer. ``pod`` accepts
        the same bare-or-qualified forms as ``bind_pod_to_node``.
        """
        if "/" in pod:
            namespace, pod = pod.split("/", 1)
        try:
            doc = self._request(f"namespaces/{namespace}/pods/{pod}")
        except ApiError as e:
            if e.code == 404:
                return None
            raise
        try:
            return self._parse_pod(doc)
        except (KeyError, ValueError) as e:
            raise ApiError(f"unparseable pod {namespace}/{pod}: {e}")

    # ---- bindings ------------------------------------------------------

    def bind_pod_to_node(
        self, pod: str, node: str, namespace: str = "default"
    ) -> bool:
        """POST the binding that makes a placement real
        (k8s_api_client.cc:67-94; body shape at :75-79).

        ``pod`` may be a bare pod name (with ``namespace`` naming its
        namespace) or a qualified ``"ns/name"`` uid as produced by
        ``_parse_pod`` — the qualifier then wins over ``namespace``.
        """
        return self.bind_outcome(pod, node, namespace) == "ok"

    def bind_outcome(
        self, pod: str, node: str, namespace: str = "default"
    ) -> str:
        """Outcome-classified binding POST — the actuation-outbox
        seam (ha/outbox.py). Returns one of:

        - ``"ok"``: the binding landed (or a 409 Conflict whose
          existing binding targets the SAME node — a duplicate of an
          op that already landed: a retried request, a journal replay
          after a crash, a restarted daemon re-actuating. Counting it
          as failed would inflate bind_failures and age/re-queue a
          pod the apiserver already placed exactly where we asked);
        - ``"rejected"``: the apiserver answered and said no (404
          pod/node gone, 409 bound elsewhere, 4xx) — retrying the
          same POST cannot heal it, the pod must be re-queued;
        - ``"unreachable"``: the apiserver could not be reached or
          kept erroring (transport, timeout, 5xx/429 exhausted) —
          the *wire* is the problem, not the decision, so the op
          belongs in the outbox, not back in the solver.
        """
        if "/" in pod:
            namespace, pod = pod.split("/", 1)
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": pod},
            "target": {
                "apiVersion": "v1", "kind": "Node", "name": node,
            },
        }
        try:
            self._request(f"namespaces/{namespace}/bindings", body)
            return "ok"
        except ApiError as e:
            if e.code == 409:
                try:
                    cur = self.get_pod(pod, namespace=namespace)
                except ApiError:
                    cur = None
                if cur is not None and cur.machine == node:
                    log.info(
                        "binding %s -> %s already exists; counting "
                        "the duplicate POST as success", pod, node,
                    )
                    return "ok"
            log.error("binding %s -> %s failed: %s", pod, node, e)
            return "unreachable" if _wire_failure(e.code) \
                else "rejected"

    # ---- evictions -----------------------------------------------------

    def evict_pod(self, pod: str, namespace: str = "default") -> bool:
        """POST the Eviction subresource that unbinds a running pod.

        The actuation half of the rebalancing deltas the reference
        never implemented: MIGRATE = evict_pod + bind_pod_to_node,
        PREEMPT = evict_pod alone (the pod parks Pending and is
        re-offered with its aging preserved). ``pod`` accepts the same
        bare-or-qualified forms as ``bind_pod_to_node``.
        """
        return self.evict_outcome(pod, namespace) == "ok"

    def evict_outcome(
        self, pod: str, namespace: str = "default"
    ) -> str:
        """Outcome-classified eviction POST; the same
        ok / rejected / unreachable vocabulary as ``bind_outcome``."""
        if "/" in pod:
            namespace, pod = pod.split("/", 1)
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod, "namespace": namespace},
        }
        try:
            self._request(
                f"namespaces/{namespace}/pods/{pod}/eviction", body
            )
            return "ok"
        except ApiError as e:
            log.error("eviction of %s failed: %s", pod, e)
            return "unreachable" if _wire_failure(e.code) \
                else "rejected"

    # ---- leases (HA leader election, ha/standby.py) --------------------

    def acquire_lease(
        self,
        name: str,
        identity: str,
        duration_s: float,
        namespace: str = "kube-system",
    ) -> bool:
        """PUT the Lease; True = granted (free, expired, or already
        ours — an acquire doubles as a renew). False = held by someone
        else (HTTP 409). Transport failures raise like any request."""
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {
                "holderIdentity": identity,
                "leaseDurationSeconds": duration_s,
            },
        }
        try:
            self._request(
                f"namespaces/{namespace}/leases/{name}", body,
                method="PUT",
            )
            return True
        except ApiError as e:
            if e.code == 409:
                return False
            raise

    def read_lease(
        self, name: str, namespace: str = "kube-system"
    ) -> dict | None:
        try:
            return self._request(f"namespaces/{namespace}/leases/{name}")
        except ApiError as e:
            if e.code == 404:
                return None
            raise

    def release_lease(
        self, name: str, identity: str,
        namespace: str = "kube-system",
    ) -> None:
        """DELETE the Lease (clean step-down); a 404/409 (already gone
        / stolen) is not an error worth failing shutdown over."""
        try:
            self._request(
                f"namespaces/{namespace}/leases/{name}"
                f"?holderIdentity={urllib.parse.quote(identity)}",
                method="DELETE",
            )
        except ApiError as e:
            if e.code not in (404, 409):
                raise
