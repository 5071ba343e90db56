"""Declarative SLO engine: objectives, burn rates, breach latching.

The pager question the metrics endpoint alone cannot answer: "is my
latency/quality objective burning error budget RIGHT NOW, fast enough
to care?". Scrape-side burn-rate alerting works, but every deployment
re-derives the same PromQL — and the quality observatory's own
sources (lifecycle e2c, shadow-audit regret) deserve first-class
objectives the daemon itself evaluates and traces.

**Objective grammar** (``--slo``, comma/repeat separated)::

    <source> <op> <threshold> [by <label>=<value> ...]
    <bool-source>

    e2b_p99_ms < 10 by lane=express     # express event-to-bind p99
    e2c_p95_ms < 5000 by lane=tick      # lifecycle event-to-confirmed
    round_p99_ms < 250                  # round host critical path
    regret == 0                         # shadow-audit placement regret
    ready                               # the /readyz latch holds

Histogram sources are ``<base>_p<NN>_ms``: the percentile IS the
error budget (``p99`` = 1% of observations may violate the threshold,
``p50`` = 50%, ``p999`` = 0.1%) — the standard reinterpretation of a
percentile objective as a good/bad-event ratio, which is what makes
multi-window burn rates well-defined. Thresholds snap DOWN to the
nearest histogram bucket edge (documented, deterministic; buckets are
fixed at registration). Gauge sources (``regret``, ``ready``,
``drift_pods``, and the failure-domain ladder's ``outage`` /
``overload`` — write ``outage == 0``: their healthy value is 0)
contribute one good/bad event per evaluation with a
``GAUGE_BUDGET`` (1%) budget. A ``by`` filter matches labelsets whose
matching keys agree; a key the instrument never carries matches all
samples (so ``e2b_p99_ms by lane=express`` reads naturally even
though the express histogram is single-lane by construction).

**Burn rate.** ``burn = (bad fraction in window) / budget`` over two
sliding windows measured in evaluations (one evaluation per completed
round — deterministic under test, cadence-proportional in
production): a short window (default 6) for detection speed and a
long window (default 60) for sustained-burn confirmation. The alert
goes ACTIVE when BOTH windows burn above ``burn_threshold`` (default
1.0 = "budget exhausts within the window"), and that transition emits
exactly one ``SLO_BREACH`` trace event + one
``poseidon_slo_breaches_total{slo}`` tick — latched until the short
window recovers, so a sustained breach pages once per breach window,
not once per round. Surfaces: ``poseidon_slo_healthy{slo}``,
``poseidon_slo_burn_rate{slo,window}``, ``poseidon_slo_value{slo}``,
the ``/slo`` endpoint (obs/server.py), and the ``trace report`` SLO
section.

``evaluate()`` runs on the loop thread once per round: histogram
snapshot deltas + a bounded deque of per-evaluation (good, total)
pairs per objective — host arithmetic only.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
import threading

log = logging.getLogger(__name__)


def _json_value(v):
    """JSON-safe point value: a percentile beyond the top bucket is
    ``inf`` internally (the metrics renderer spells it ``+Inf``), but
    strict-JSON consumers of /slo and the trace get null instead of
    the non-standard ``Infinity`` token."""
    if v is None or not math.isfinite(v):
        return None
    return v

# histogram source vocabulary: friendly base -> registry family
HIST_SOURCES = {
    "e2b": "poseidon_express_e2b_ms",
    "e2c": "poseidon_pod_e2c_ms",
    "round": "poseidon_round_latency_ms",
}

# gauge source vocabulary: name -> (registry family, boolean?)
GAUGE_SOURCES = {
    "regret": ("poseidon_audit_regret", False),
    "ready": ("poseidon_ready", True),
    "drift_pods": ("poseidon_audit_drift_pods", False),
    # the failure-domain degradation ladder: 'outage == 0' /
    # 'overload == 0' alert on sustained degraded windows (non-bool:
    # the healthy value is 0, so the bare-name boolean default of
    # "== 1 is good" would invert them)
    "outage": ("poseidon_outage", False),
    "overload": ("poseidon_overload", False),
}

# error budget for gauge objectives (1 sample per evaluation): 1% of
# evaluations may violate before burn exceeds 1x
GAUGE_BUDGET = 0.01

SHORT_WINDOW_DEFAULT = 6
LONG_WINDOW_DEFAULT = 60
BURN_THRESHOLD_DEFAULT = 1.0

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}

_COND_RE = re.compile(
    r"^\s*(?P<name>[A-Za-z_][\w]*)\s*"
    r"(?:(?P<op><=|>=|==|!=|<|>)\s*(?P<thr>-?\d+(?:\.\d+)?))?\s*$"
)
_HIST_RE = re.compile(r"^(?P<base>[a-z0-9]+)_p(?P<pct>\d+)_ms$")


class SloParseError(ValueError):
    """The objective spec does not parse (unknown source, bad op)."""


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One parsed objective."""

    spec: str                 # the normalized spec (the metric label)
    kind: str                 # "histogram" | "gauge"
    family: str               # registry instrument family
    op: str
    threshold: float
    budget: float             # allowed bad fraction
    labels: tuple             # ((k, v), ...) "by" filter


def parse_objective(spec: str) -> SloObjective:
    """Parse one objective spec (see the module docstring grammar)."""
    spec = " ".join(spec.split())
    cond, *by = spec.split(" by ")
    labels: list[tuple[str, str]] = []
    for clause in by:
        for part in clause.split():
            if "=" not in part:
                raise SloParseError(
                    f"bad 'by' clause {part!r} in {spec!r} "
                    f"(want label=value)"
                )
            k, v = part.split("=", 1)
            labels.append((k, v))
    m = _COND_RE.match(cond)
    if not m:
        raise SloParseError(f"cannot parse objective {spec!r}")
    name, op, thr = m.group("name"), m.group("op"), m.group("thr")
    hm = _HIST_RE.match(name)
    if hm and hm.group("base") in HIST_SOURCES:
        if op is None:
            raise SloParseError(
                f"histogram objective {name!r} needs '<op> "
                f"<threshold>' ({spec!r})"
            )
        if op not in ("<", "<="):
            # latency percentiles are upper-bound objectives; a '>'
            # objective would need the threshold snapped UP to stay
            # conservative, and cumulative buckets make that
            # half-broken — reject instead of under-counting burn
            raise SloParseError(
                f"histogram objective {spec!r}: only '<'/'<=' "
                f"thresholds are supported (latency percentiles are "
                f"upper bounds)"
            )
        pct_str = hm.group("pct")
        pct = int(pct_str)
        # p99 -> 0.99, p999 -> 0.999 (three+ digits read as 99.9);
        # a 3+-digit spelling with a trailing zero (p100, p950) is
        # ambiguous with its shorter form (p10, p95) and silently
        # guts the budget — reject it, like pct 0
        if pct == 0 or (len(pct_str) >= 3 and pct % 10 == 0):
            raise SloParseError(
                f"ambiguous percentile p{pct_str} in {spec!r}: "
                f"write p1..p99 or p999-style (no trailing zero)"
            )
        frac = pct / 100 if len(pct_str) <= 2 \
            else pct / 10 ** len(pct_str)
        budget = max(1.0 - frac, 1e-6)
        return SloObjective(
            spec=spec, kind="histogram",
            family=HIST_SOURCES[hm.group("base")],
            op=op, threshold=float(thr), budget=budget,
            labels=tuple(labels),
        )
    if name in GAUGE_SOURCES:
        family, is_bool = GAUGE_SOURCES[name]
        if op is None:
            if not is_bool:
                raise SloParseError(
                    f"gauge objective {name!r} needs '<op> "
                    f"<threshold>' ({spec!r})"
                )
            op, thr = "==", "1"
        return SloObjective(
            spec=spec, kind="gauge", family=family,
            op=op, threshold=float(thr), budget=GAUGE_BUDGET,
            labels=tuple(labels),
        )
    raise SloParseError(
        f"unknown SLO source {name!r} in {spec!r}; histogram bases: "
        f"{sorted(HIST_SOURCES)} (as <base>_pNN_ms), gauges: "
        f"{sorted(GAUGE_SOURCES)}"
    )


def _labels_match(key: tuple, want: tuple) -> bool:
    """A labelset matches when every 'by' key it CARRIES agrees; keys
    the instrument never mints match everything (documented)."""
    have = dict(key)
    return all(have.get(k, v) == v for k, v in want)


class _ObjectiveState:
    """Per-objective sliding windows + breach latch."""

    def __init__(self, obj: SloObjective, long_window: int):
        self.obj = obj
        # per-evaluation (good, total) deltas, newest last
        self.window: list[tuple[int, int]] = []
        self.long_window = long_window
        # histogram cumulative baseline from the previous evaluation:
        # {labelkey: (good_cum, total_cum)}
        self.prev: dict[tuple, tuple[int, int]] = {}
        self.active = False
        self.breaches = 0
        self.last_value: float | None = None

    def push(self, good: int, total: int) -> None:
        self.window.append((good, total))
        if len(self.window) > self.long_window:
            del self.window[: len(self.window) - self.long_window]

    def burn(self, n: int) -> float:
        tail = self.window[-n:]
        total = sum(t for _, t in tail)
        if total <= 0:
            return 0.0
        bad = total - sum(g for g, _ in tail)
        return (bad / total) / self.obj.budget


class SloEngine:
    """Evaluates declared objectives against the metrics registry.

    Loop-thread only (one ``evaluate()`` per completed round); the
    registry's own lock makes the snapshot reads safe against scrape
    threads. ``trace`` (a TraceGenerator) receives the SLO_BREACH
    events; ``metrics`` (SchedulerMetrics) the ``poseidon_slo_*``
    series.
    """

    def __init__(
        self,
        objectives: list[str] | list[SloObjective],
        *,
        metrics=None,
        trace=None,
        short_window: int = SHORT_WINDOW_DEFAULT,
        long_window: int = LONG_WINDOW_DEFAULT,
        burn_threshold: float = BURN_THRESHOLD_DEFAULT,
    ):
        self.metrics = metrics
        self.trace = trace
        self.short_window = max(int(short_window), 1)
        self.long_window = max(int(long_window), self.short_window)
        self.burn_threshold = float(burn_threshold)
        # evaluate() runs on the loop thread; status() serves the
        # obs server's handler threads — window state is read and
        # written under this lock
        self._lock = threading.Lock()
        self.states: list[_ObjectiveState] = []
        for spec in objectives:
            obj = (
                spec if isinstance(spec, SloObjective)
                else parse_objective(spec)
            )
            self._check_threshold(obj)
            self.states.append(_ObjectiveState(obj, self.long_window))
        self.evaluations = 0

    def _check_threshold(self, obj: SloObjective) -> None:
        """Reject a '<' histogram threshold below the family's
        smallest bucket edge: the documented snap-DOWN has no edge to
        snap to, and evaluating it would silently invert 'all good'
        into 'all bad' (a permanently-firing false breach)."""
        if obj.kind != "histogram" or obj.op not in ("<", "<="):
            return
        reg = self._registry()
        hist = reg._metrics.get(obj.family) if reg else None
        if hist is None:
            return  # family not registered: nothing to check against
        lo = min(hist.buckets)
        if obj.threshold < lo:
            raise SloParseError(
                f"objective {obj.spec!r}: threshold {obj.threshold:g} "
                f"is below {obj.family}'s smallest bucket edge "
                f"({lo:g}) — the threshold snaps down to a bucket "
                f"edge, so nothing could ever count as good"
            )

    # ---- source reads ---------------------------------------------------

    def _registry(self):
        return self.metrics.registry if self.metrics is not None \
            else None

    def _eval_histogram(self, st: _ObjectiveState) -> tuple[int, int]:
        reg = self._registry()
        hist = reg._metrics.get(st.obj.family) if reg else None
        if hist is None:
            return 0, 0
        snap = hist.snapshot()
        buckets = hist.buckets
        # snap the threshold DOWN to a bucket edge: counts at le <=
        # threshold are provably-good observations
        bi = -1
        for i, le in enumerate(buckets):
            if le <= st.obj.threshold:
                bi = i
        good = total = 0
        values = []
        for key, (counts, _sum, n) in snap.items():
            if not _labels_match(key, st.obj.labels):
                continue
            # '<'/'<=' only (parse_objective rejects the rest):
            # good = observations at or under the snapped edge
            g = counts[bi] if bi >= 0 else 0
            pg, pt = st.prev.get(key, (0, 0))
            good += g - pg
            total += n - pt
            st.prev[key] = (g, n)
            values.append((counts, n))
        # display value: the objective's percentile over the
        # whole-life histogram (bucket upper-edge estimate)
        st.last_value = _percentile_estimate(
            values, buckets, 1.0 - st.obj.budget
        )
        return max(good, 0), max(total, 0)

    def _eval_gauge(self, st: _ObjectiveState) -> tuple[int, int]:
        reg = self._registry()
        gauge = reg._metrics.get(st.obj.family) if reg else None
        if gauge is None:
            return 0, 0
        vals = [
            v for key, v in gauge.snapshot().items()
            if _labels_match(key, st.obj.labels)
        ]
        if not vals:
            return 0, 0
        ok = all(
            _OPS[st.obj.op](v, st.obj.threshold) for v in vals
        )
        st.last_value = vals[0] if len(vals) == 1 else max(vals)
        return (1, 1) if ok else (0, 1)

    # ---- the per-round evaluation --------------------------------------

    def evaluate(self, round_num: int = 0) -> None:
        """One evaluation tick (loop thread, once per completed
        round): refresh windows, update burn rates, latch breaches."""
        with self._lock:
            self.evaluations += 1
        for st in self.states:
            with self._lock:
                good, total = (
                    self._eval_histogram(st)
                    if st.obj.kind == "histogram"
                    else self._eval_gauge(st)
                )
                st.push(good, total)
                short = st.burn(self.short_window)
                long_ = st.burn(self.long_window)
                breaching = (
                    short > self.burn_threshold
                    and long_ > self.burn_threshold
                )
                fired = False
                if breaching and not st.active:
                    # the once-per-breach-window edge: latched until
                    # the short window recovers
                    st.active = True
                    st.breaches += 1
                    fired = True
                elif st.active and short <= self.burn_threshold:
                    st.active = False
                healthy = not st.active
                value = st.last_value
            if fired:
                log.warning(
                    "SLO breach: %s (burn short=%.2f long=%.2f)",
                    st.obj.spec, short, long_,
                )
                if self.trace is not None:
                    self.trace.emit(
                        "SLO_BREACH", round_num=round_num,
                        detail={
                            "slo": st.obj.spec,
                            "burn_short": round(short, 3),
                            "burn_long": round(long_, 3),
                            "value": _json_value(value),
                        },
                    )
                    self.trace.flush()
            if self.metrics is not None:
                self.metrics.record_slo(
                    st.obj.spec, healthy=healthy,
                    burn_short=short, burn_long=long_,
                    value=value, breached=fired,
                )

    # ---- the /slo endpoint's data model --------------------------------

    def status(self) -> dict:  # pta: background-thread
        """JSON-able evaluation state (the ``/slo`` endpoint body and
        the smoke test's assertion surface); served from the obs
        server's handler threads under the engine lock."""
        with self._lock:
            return {
                "evaluations": self.evaluations,
                "short_window": self.short_window,
                "long_window": self.long_window,
                "burn_threshold": self.burn_threshold,
                "objectives": [
                    {
                        "spec": st.obj.spec,
                        "kind": st.obj.kind,
                        "family": st.obj.family,
                        "budget": st.obj.budget,
                        "healthy": not st.active,
                        "burn_short": round(
                            st.burn(self.short_window), 4
                        ),
                        "burn_long": round(
                            st.burn(self.long_window), 4
                        ),
                        "breaches": st.breaches,
                        "value": _json_value(st.last_value),
                    }
                    for st in self.states
                ],
            }


def _percentile_estimate(values, buckets, q: float) -> float | None:
    """Bucket-edge percentile estimate over summed labelsets (display
    only — the burn math uses exact bucket counts)."""
    if not values:
        return None
    total = sum(n for _, n in values)
    if total <= 0:
        return None
    acc = [0] * len(buckets)
    for counts, _n in values:
        for i, c in enumerate(counts):
            acc[i] += c
    want = q * total
    for i, c in enumerate(acc):
        if c >= want:
            return float(buckets[i])
    return float("inf")
