"""Trace analysis: the operator's one-pager from a trace JSONL file.

Backend of ``python -m poseidon_tpu_torch.trace report <file>``. One pass
over ``trace.read_trace`` builds:

- **round latency** p50/p95/p99 of ``total_ms`` (the host critical
  path) grouped by (lane, build_mode) plus a per-backend-family
  breakdown — the "is the watch/pipelined/express/sharded lane doing
  what PERF.md says" table;
- **express**: event-to-bind percentiles from the per-placement
  ``e2b_ms`` carried on EXPRESS_PLACE events (real per-event samples,
  not window aggregates), plus batch/place/corrected/degrade tallies;
- **degradations**: DEGRADE / EXPRESS_DEGRADE / WATCH_RESYNC /
  WATCH_RECONNECT / FETCH_TIMEOUT tallies with their reasons, so an
  operator sees WHY the dense lane fell back, not just that it did;
- **placement churn**: SCHEDULE / MIGRATE / PREEMPT / EVICT /
  EXPRESS_PLACE totals and per-round rates, deferred-delta pressure,
  and the bind-failure count;
- **spans** (when ``--trace_profile`` was on): per-phase duration p50s
  across rounds.

Everything is computed from the JSONL alone — the report runs against
a live daemon's trace file or a post-mortem copy equally.
"""

from __future__ import annotations

import collections

import numpy as np

from poseidon_tpu_torch.trace import read_trace

# events that count as placement churn, in report order
_CHURN_EVENTS = (
    "SCHEDULE", "MIGRATE", "PREEMPT", "EVICT", "EXPRESS_PLACE",
    "EXPRESS_CORRECTED", "FINISH", "SUBMIT",
)


def _pct(values, q) -> float:
    return round(float(np.percentile(np.asarray(values, float), q)), 3)


def _pcts(values) -> dict:
    if not values:
        return {"n": 0}
    return {
        "n": len(values),
        "p50": _pct(values, 50),
        "p95": _pct(values, 95),
        "p99": _pct(values, 99),
    }


def _why_of(detail) -> str:
    if not isinstance(detail, dict):
        return "unknown"
    return str(
        detail.get("why") or detail.get("reason")
        or detail.get("error") or "unknown"
    )


def analyze_trace(path: str, *, tenant: str = "") -> dict:
    """One pass over the trace -> the report's data model (a plain
    JSON-able dict; ``render_report`` formats it for humans).

    ``tenant`` filters to one service-lane session's events (every
    tenant's generator stamps its id; "" = no filter, the whole
    stream)."""
    lane_lat: dict[tuple[str, str], list[float]] = (
        collections.defaultdict(list)
    )
    backend_lat: dict[str, list[float]] = collections.defaultdict(list)
    e2b: list[float] = []
    tallies: dict[str, collections.Counter] = {
        k: collections.Counter()
        for k in ("DEGRADE", "EXPRESS_DEGRADE", "WATCH_RESYNC",
                  "WATCH_RECONNECT", "FETCH_TIMEOUT",
                  "FLIGHTREC_DUMP")
    }
    churn = collections.Counter()
    slo_breaches = collections.Counter()
    span_phases: dict[str, list[float]] = collections.defaultdict(list)
    rounds = 0
    nonempty_rounds = 0
    express = collections.Counter()
    deferred = 0
    bind_failures = 0
    first_round = last_round = None
    for ev in read_trace(path):
        if tenant and ev.tenant != tenant:
            continue
        if ev.event == "ROUND":
            rounds += 1
            if first_round is None:
                first_round = ev.round_num
            last_round = ev.round_num
            d = ev.detail or {}
            # window counters accumulate on EVERY round record: the
            # bridge deliberately flushes them into empty rounds too
            # (an express window that bound everything ends in one)
            express["batches"] += d.get("express_batches", 0)
            express["places"] += d.get("express_places", 0)
            express["corrected"] += d.get("express_corrected", 0)
            express["degrades"] += d.get("express_degrades", 0)
            deferred += d.get("deltas_deferred", 0)
            bind_failures += d.get("bind_failures", 0)
            backend = d.get("backend", "")
            if not backend:
                continue  # empty round: no solve to time
            nonempty_rounds += 1
            lane = d.get("lane") or "round"
            mode = d.get("build_mode") or "none"
            total = float(d.get("total_ms", 0.0))
            lane_lat[(lane, mode)].append(total)
            family = (
                "oracle" if backend.startswith("oracle:") else "dense"
            )
            backend_lat[family].append(total)
        elif ev.event in tallies:
            tallies[ev.event][_why_of(ev.detail)] += 1
        elif ev.event == "SLO_BREACH":
            d = ev.detail if isinstance(ev.detail, dict) else {}
            slo_breaches[str(d.get("slo", "unknown"))] += 1
        elif ev.event == "EXPRESS_PLACE":
            churn[ev.event] += 1
            if isinstance(ev.detail, dict) and "e2b_ms" in ev.detail:
                e2b.append(float(ev.detail["e2b_ms"]))
        elif ev.event == "SPAN":
            d = ev.detail or {}
            lane = d.get("lane", "round")
            # recurse: subspans nest (fetch-wait under solve-wait)
            stack = list(d.get("children", ()))
            while stack:
                child = stack.pop()
                span_phases[
                    f"{lane}:{child.get('name')}"
                ].append(float(child.get("dur_ms", 0.0)))
                stack.extend(child.get("children", ()))
        if ev.event in _CHURN_EVENTS and ev.event != "EXPRESS_PLACE":
            churn[ev.event] += 1
    per_round = max(nonempty_rounds, 1)
    return {
        "tenant": tenant,
        "rounds": rounds,
        "nonempty_rounds": nonempty_rounds,
        "round_range": [first_round, last_round],
        "round_latency_ms": {
            f"{lane}/{mode}": _pcts(v)
            for (lane, mode), v in sorted(lane_lat.items())
        },
        "backend_latency_ms": {
            k: _pcts(v) for k, v in sorted(backend_lat.items())
        },
        "express": {
            "e2b_ms": _pcts(e2b),
            **{k: int(v) for k, v in sorted(express.items())},
        },
        "degradations": {
            k: dict(c.most_common()) for k, c in tallies.items()
        },
        # SLO breach-latch trips by objective spec (obs/slo.py emits
        # exactly one SLO_BREACH per breach window)
        "slo_breaches": dict(slo_breaches.most_common()),
        "churn": {
            "totals": {k: int(churn.get(k, 0)) for k in _CHURN_EVENTS},
            "per_round": {
                k: round(churn.get(k, 0) / per_round, 2)
                for k in _CHURN_EVENTS
            },
            "deltas_deferred": deferred,
            "bind_failures": bind_failures,
        },
        "span_phase_p50_ms": {
            k: _pct(v, 50) for k, v in sorted(span_phases.items())
        },
    }


def render_report(data: dict) -> str:
    """The human one-pager."""
    out: list[str] = []
    add = out.append
    lo, hi = data["round_range"]
    add("== poseidon-tpu trace report ==")
    if data.get("tenant"):
        add(f"tenant: {data['tenant']}")
    add(
        f"rounds: {data['rounds']} "
        f"({data['nonempty_rounds']} with a solve), "
        f"round_num {lo}..{hi}"
    )
    add("")
    add("-- round latency (total_ms host critical path) --")
    add(f"{'lane/build_mode':<28}{'n':>6}{'p50':>10}{'p95':>10}"
        f"{'p99':>10}")
    for key, p in data["round_latency_ms"].items():
        add(f"{key:<28}{p['n']:>6}{p.get('p50', '-'):>10}"
            f"{p.get('p95', '-'):>10}{p.get('p99', '-'):>10}")
    for fam, p in data["backend_latency_ms"].items():
        add(f"{'backend=' + fam:<28}{p['n']:>6}{p.get('p50', '-'):>10}"
            f"{p.get('p95', '-'):>10}{p.get('p99', '-'):>10}")
    add("")
    ex = data["express"]
    e2b = ex["e2b_ms"]
    add("-- express lane --")
    if e2b["n"]:
        add(f"event-to-bind ms: n={e2b['n']} p50={e2b['p50']} "
            f"p95={e2b['p95']} p99={e2b['p99']}")
    else:
        add("event-to-bind ms: no samples (lane off or no arrivals)")
    add(f"batches={ex.get('batches', 0)} places={ex.get('places', 0)} "
        f"corrected={ex.get('corrected', 0)} "
        f"degrades={ex.get('degrades', 0)}")
    add("")
    add("-- degradations (count by reason) --")
    any_deg = False
    for kind, reasons in data["degradations"].items():
        for reason, n in reasons.items():
            any_deg = True
            add(f"{kind:<18}{n:>6}  {reason}")
    if not any_deg:
        add("none")
    add("")
    add("-- SLO breaches (latch trips by objective) --")
    if data.get("slo_breaches"):
        for spec, n in data["slo_breaches"].items():
            add(f"{n:>4}  {spec}")
    else:
        add("none")
    add("")
    ch = data["churn"]
    add("-- placement churn --")
    add(f"{'event':<20}{'total':>8}{'per round':>12}")
    for k in _CHURN_EVENTS:
        if ch["totals"][k]:
            add(f"{k:<20}{ch['totals'][k]:>8}"
                f"{ch['per_round'][k]:>12}")
    add(f"deltas deferred: {ch['deltas_deferred']}  "
        f"bind failures: {ch['bind_failures']}")
    if data["span_phase_p50_ms"]:
        add("")
        add("-- span phases (p50 ms; --trace_profile) --")
        for k, v in data["span_phase_p50_ms"].items():
            add(f"{k:<28}{v:>10}")
    return "\n".join(out)
