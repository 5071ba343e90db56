"""Observability: metrics, health endpoints, span profiling, reports.

The parts of the reference's ``obs/`` package the daemon's main path
uses, held against it:

- ``metrics``: a dependency-free metrics registry (counters, gauges,
  fixed-bucket histograms) rendered in Prometheus text exposition
  format, plus ``SchedulerMetrics`` — every instrument the scheduler
  feeds, under the reference's family names. Recording happens only
  from values the loop already holds on the host (stats fields,
  perf-counter durations, outcome counts) at finish/actuate time.
- ``server``: a daemon-thread HTTP server exposing ``/metrics``,
  ``/healthz`` (process liveness) and ``/readyz`` (ready = the seed
  LIST applied AND the first round completed), with ``HealthState``
  as the loop-fed readiness latch.
- ``spans`` + ``report``: phase-span profiling (a ``SPAN`` trace event
  per round, exported as Chrome-trace/Perfetto JSON) and the analysis
  behind ``python -m poseidon_tpu_torch.trace report``.
- ``lifecycle``: bounded per-pod timelines closed into
  event-to-confirmed latency histograms.
- ``flightrec`` + ``replay`` + ``explain``: the anomaly flight
  recorder keeps the last rounds' full host-side solve inputs in a
  bounded ring and dumps them (the reference's dump layout);
  ``python -m poseidon_tpu_torch.obs.replay <dump>`` re-runs them on
  the card and asserts bit-identity; the explainer attributes a
  decision's cost to the model's named terms and diagnoses an
  unscheduled pod.
- ``audit`` + ``slo``: the shadow auditor re-solves a sampled cluster
  snapshot on a background thread (CPU pricing + the subprocess
  oracle — never a launch on the card) and publishes placement regret
  and a fragmentation index; the SLO engine evaluates declarative
  objectives with multi-window burn rates, latched ``SLO_BREACH``
  trace events and the ``/slo`` endpoint.
"""

from poseidon_tpu_torch.obs.audit import ShadowAuditor
from poseidon_tpu_torch.obs.flightrec import FlightRecorder
from poseidon_tpu_torch.obs.lifecycle import LifecycleTracker
from poseidon_tpu_torch.obs.metrics import (
    MetricsRegistry,
    SchedulerMetrics,
    build_info,
)
from poseidon_tpu_torch.obs.server import HealthState, ObsServer
from poseidon_tpu_torch.obs.slo import SloEngine

__all__ = [
    "FlightRecorder",
    "HealthState",
    "LifecycleTracker",
    "MetricsRegistry",
    "ObsServer",
    "SchedulerMetrics",
    "ShadowAuditor",
    "SloEngine",
    "build_info",
]
