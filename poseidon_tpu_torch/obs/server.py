"""The metrics/health HTTP endpoint: /metrics, /healthz, /readyz, /slo.

A ``ThreadingHTTPServer`` on a daemon thread (one short-lived handler
thread per scrape; the registry's shared lock makes renders safe
against in-flight recording — analysis/contracts.py PTA004 declares
the discipline). Endpoints:

- ``GET /metrics``: Prometheus text exposition of the registry
  (version 0.0.4);
- ``GET /healthz``: process liveness — 200 as long as the daemon can
  answer at all (the loop owns no state a liveness probe should gate
  on; a wedged round shows up in ``/readyz`` and the metrics, not
  here). The body is JSON: ``{"status": "ok", "build": {...}}`` with
  the same build-identity labelset the ``poseidon_build_info`` gauge
  publishes (package, torch and CUDA versions, device kind, mesh width) — so "what
  exactly is this pod running" is one curl, not a registry query;
- ``GET /readyz``: readiness — 200 only after BOTH (a) the seed
  LIST/snapshot has been applied to the bridge and (b) the first
  scheduling round over that real cluster state has completed (every
  completed solve here is exact — certified dense or oracle — and a
  proven-EMPTY round counts too: an idle cluster with nothing pending
  is the steady state of a fully operational scheduler, and gating
  readiness on a solve would wedge a readiness-gated rollout there
  forever). Until then 503 with the missing conditions in the body, so
  an operator can tell "waiting for the apiserver" from "waiting for
  the first solve". A 200 body carries the ``restored_warm`` condition
  detail when the daemon rehydrated from a checkpoint at startup
  (ha/checkpoint.py), and ``degraded=outage,overload`` while the
  failure-domain ladder has declared a degraded window (apiserver
  unreachable / round-deadline watchdog tripping) — informational,
  never a gate: a degraded scheduler is still scheduling from
  last-known state. Degraded-to-oracle
  and resync-storm states are NOT
  readiness failures — they surface as labeled gauges
  (``poseidon_degraded{why=...}``, ``poseidon_watch_resync_storm``)
  since a degraded scheduler is still scheduling.

- ``GET /slo``: the SLO engine's evaluation state (obs/slo.py) as
  JSON — per objective: spec, healthy, short/long burn rates, breach
  count, current value. 404 when no ``--slo`` objectives were
  declared.

``HealthState`` is the loop-fed latch behind ``/readyz``; the cli
marks it from the observe/round loop (cli.py), tests drive it
directly.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading

from poseidon_tpu_torch.obs.metrics import MetricsRegistry

log = logging.getLogger(__name__)


class HealthState:
    """Readiness latch: seeded observe + first round over real state.

    Written by the daemon loop, read by the handler threads; a lock
    guards the two booleans (they flip once, but torn multi-field
    reads would make ``reasons()`` lie during the flip).

    ``ready_gauge`` (the registry's ``poseidon_ready`` gauge, or None)
    is updated INSIDE the latch's lock: a scraper that has seen
    ``/readyz`` return 200 can never read the gauge at 0, because the
    readyz handler's own ``ready`` read serializes behind the flip
    that already set the gauge.
    """

    def __init__(self, ready_gauge=None):
        self._lock = threading.Lock()
        self._seeded = False
        self._round_done = False
        # informational condition detail, not a readiness gate: True
        # when the daemon rehydrated warm state from a checkpoint at
        # startup (ha/checkpoint.py) — "did this pod cold-start or
        # warm-restore" is the first rollout question after a bounce
        self._restored_warm = False
        # declared degraded modes (the failure-domain ladder:
        # "outage" while the apiserver is unreachable, "overload"
        # while the round-deadline watchdog is tripping). NEVER a
        # readiness gate — a degraded scheduler is still scheduling —
        # but surfaced in the 200 body so a rollout can tell a
        # healthy pod from one riding out an incident.
        self._degraded: set[str] = set()
        self._gauge = ready_gauge
        if ready_gauge is not None:
            ready_gauge.set(0)

    def mark_seeded(self) -> None:
        """The seed LIST (or first successful poll snapshot) has been
        applied to the bridge."""
        with self._lock:
            self._seeded = True
            if self._gauge is not None:
                self._gauge.set(
                    1 if self._seeded and self._round_done else 0
                )

    def mark_round(self, backend: str) -> None:
        """A scheduling round completed; ``backend`` is its
        ``SchedulerStats.backend``. Empty-backend rounds count too:
        the loop only rounds after a successful observe, so an empty
        round is PROVEN-empty real state (an idle cluster's steady
        state), not a startup transient — the separate seeded latch
        already guards against reporting ready before real state
        arrived."""
        del backend  # kept for the call sites' self-documentation
        with self._lock:
            self._round_done = True
            if self._gauge is not None:
                self._gauge.set(
                    1 if self._seeded and self._round_done else 0
                )

    def mark_restored_warm(self) -> None:
        """The startup path rehydrated warm state from a checkpoint
        (surfaced as a /readyz condition detail, never a gate)."""
        with self._lock:
            self._restored_warm = True

    @property
    def restored_warm(self) -> bool:
        with self._lock:
            return self._restored_warm

    def set_degraded(self, mode: str, active: bool) -> None:
        """Declare or clear a degraded mode ("outage", "overload").
        Informational: /readyz stays 200, the body carries
        ``degraded=<modes>``."""
        with self._lock:
            if active:
                self._degraded.add(mode)
            else:
                self._degraded.discard(mode)

    def degraded_modes(self) -> list[str]:  # pta: background-thread
        with self._lock:
            return sorted(self._degraded)

    @property
    def ready(self) -> bool:
        with self._lock:
            return self._seeded and self._round_done

    def reasons(self) -> list[str]:  # pta: background-thread
        """What readiness is still waiting on (handler threads)."""
        with self._lock:
            out = []
            if not self._seeded:
                out.append("waiting for the seed LIST/snapshot")
            if not self._round_done:
                out.append("waiting for the first scheduling round")
            return out


class ObsServer:
    """The background endpoint server; start() binds and returns the
    port (pass ``port=0`` to let the OS pick — tests do)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        health: HealthState,
        *,
        port: int = 0,
        host: str = "0.0.0.0",
        build: dict | None = None,
        slo=None,
    ):
        self.registry = registry
        self.health = health
        self.host = host
        self.port = port
        # the /healthz build-identity echo (obs.metrics.build_info());
        # immutable after start, so handler threads read it lock-free
        self.build = dict(build or {})
        # the SLO engine behind /slo (obs/slo.py; None = 404):
        # status() serves handler threads under the engine's own lock
        self.slo = slo
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        registry = self.registry
        health = self.health
        srv = self  # handlers read srv.slo PER REQUEST (below)
        healthz_body = json.dumps(
            {"status": "ok", "build": self.build}
        ).encode() + b"\n"

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # pta: background-thread
                # probes and agents append query params freely
                # (?verbose=1, cache busters): route on the path alone
                route = self.path.split("?", 1)[0]
                if route == "/metrics":
                    body = registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif route == "/healthz":
                    body = healthz_body
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/json")
                elif route == "/slo":
                    # read per request, not captured at start():
                    # callers assign server.slo by attribute and must
                    # not need to order that before start() (reference
                    # assignment is atomic; a stale read costs one
                    # 404 scrape, never a crash)
                    slo_engine = srv.slo
                    if slo_engine is None:
                        body = (
                            b"no SLO engine configured (--slo)\n"
                        )
                        self.send_response(404)
                        self.send_header("Content-Type",
                                         "text/plain")
                    else:
                        body = json.dumps(
                            slo_engine.status(), indent=1
                        ).encode() + b"\n"
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/json")
                elif route == "/readyz":
                    if health.ready:
                        # condition details: did this process warm-
                        # restore, and is it riding out a declared
                        # degraded window (outage/overload)? Both
                        # informational, never gates.
                        parts = ["ready"]
                        if health.restored_warm:
                            parts.append("restored_warm=true")
                        modes = health.degraded_modes()
                        if modes:
                            parts.append(
                                "degraded=" + ",".join(modes)
                            )
                        body = (" ".join(parts) + "\n").encode()
                        self.send_response(200)
                    else:
                        body = (
                            "; ".join(health.reasons()) + "\n"
                        ).encode()
                        self.send_response(503)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # pta: background-thread
                pass  # scrapes are not log lines

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), _Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-server",
            daemon=True,
        )
        self._thread.start()
        log.info("obs server listening on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "ObsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
