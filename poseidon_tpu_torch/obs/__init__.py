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

The flight recorder, explainer, replay, shadow audit and SLO engine
are not ported yet (ROADMAP.md, Queue 1 item 7).
"""

from poseidon_tpu_torch.obs.lifecycle import LifecycleTracker
from poseidon_tpu_torch.obs.metrics import (
    MetricsRegistry,
    SchedulerMetrics,
    build_info,
)
from poseidon_tpu_torch.obs.server import HealthState, ObsServer

__all__ = [
    "HealthState",
    "LifecycleTracker",
    "MetricsRegistry",
    "ObsServer",
    "SchedulerMetrics",
    "build_info",
]
