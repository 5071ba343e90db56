"""Seeded, schedule-driven fault orchestration + survival invariants.

**Why deterministic.** Chaos testing that fires faults off wall-clock
timers produces unreproducible failures; this harness keys every
injection on *completed round numbers* (the ``round_hook`` seam
``cli.run_loop`` exposes: the hook runs on the loop thread between
rounds) and draws every random choice (which nodes a storm kills,
which pods a burst adds) from one seeded ``random.Random`` — the same
scenario + seed replays the same fault sequence against the same
daemon decisions, so a failed invariant is a debuggable artifact, not
a flake.

**The orchestrator** drives the fake apiserver's injection surface:
``fail_next`` / ``rate_limit_next`` / ``disconnect_next`` /
``delay_next`` (hung apiserver) / ``gone_next_watch`` /
``apply_then_disconnect_next`` / ``compact_watch_log`` /
``set_outage`` (whole-control-plane 503 window) plus ``node_storm``
(seeded mass ``drop_node``) and ``pod_burst`` (seeded arrivals).

**The invariants** (``check_invariants``) define "survived":

- *exactly-once actuation*: in the apiserver's ordered ``op_log``, no
  pod is bound twice without an intervening eviction or node-death
  orphaning — retries, journal replays, and outbox replays collapsed
  idempotently;
- *zero lost pods*: every pod the apiserver knows ends the run
  Running with a node (nothing stranded Pending, nothing forgotten);
- *guard release within the bound*: every EVICTION_GUARD_HOLD run is
  closed by a RELEASE, and an accepted release lands within the
  strike/grace bound of the first hold;
- *bounded recovery*: the first post-fault-clear round with no
  pending, no unscheduled, and no parked displacement arrives within
  ``recover_within`` rounds (``rounds_to_recover`` measures it);
- *no silent degrades*: ``degrades_total`` stays zero — every
  recovery round kept its exactness certificate.

Scenarios are plain data (``ChaosScenario``); ``run_daemon_scenario``
runs one against the REAL daemon loop — journal, outbox, guard,
watchdog, metrics all live — and returns the evidence (stats rows,
trace events, the server's final state) for the checker.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random

log = logging.getLogger(__name__)

# the injection vocabulary (FaultAction.kind)
ACTIONS = frozenset({
    "fail_next",                  # args: n
    "rate_limit_next",            # args: n, retry_after_s
    "disconnect_next",            # args: n
    "delay_next",                 # args: n, seconds
    "gone_next_watch",            # args: n
    "apply_then_disconnect_next",  # args: n
    "compact_watch_log",          # args: -
    "outage_begin",               # args: writes_only? (reads-OK/
                                  # writes-down etcd-quorum shape)
    "outage_end",                 # args: -
    "node_storm",                 # args: kill (count; seeded choice)
    "pod_burst",                  # args: n, cpu?, memory?
})


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One scheduled injection: fires after round ``at_round``
    completes (the hook's rounds-completed counter)."""

    at_round: int
    kind: str
    args: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """A named, seeded fault schedule over a synthetic cluster."""

    name: str
    seed: int
    actions: tuple[FaultAction, ...]
    rounds: int               # total daemon rounds to drive
    fault_clear_round: int    # last round with an active/armed fault
    recover_within: int       # max rounds after clear to full recovery
    nodes: int = 16
    pods: int = 64
    flags: tuple[str, ...] = ()   # extra cli flags (e.g. --watch=true)


class ChaosOrchestrator:
    """Applies a scenario's due actions from the ``round_hook`` seam
    (loop thread, between rounds — deterministic by construction).
    ``applied`` records (round, kind, detail) for the post-mortem."""

    def __init__(self, server, scenario: ChaosScenario):
        self.server = server
        self.scenario = scenario
        self.rng = random.Random(scenario.seed)
        self.applied: list[tuple[int, str, str]] = []
        self._by_round: dict[int, list[FaultAction]] = {}
        for a in scenario.actions:
            self._by_round.setdefault(a.at_round, []).append(a)

    def on_round(self, rounds_completed: int, result=None) -> None:
        for a in self._by_round.pop(rounds_completed, []):
            detail = self._apply(a)
            self.applied.append((rounds_completed, a.kind, detail))
            log.info(
                "chaos[%s] round %d: %s %s",
                self.scenario.name, rounds_completed, a.kind, detail,
            )

    def _apply(self, a: FaultAction) -> str:
        s, args = self.server, a.args
        if a.kind == "fail_next":
            s.fail_next(args.get("n", 1))
            return f"n={args.get('n', 1)}"
        if a.kind == "rate_limit_next":
            s.rate_limit_next(
                args.get("n", 1), args.get("retry_after_s", 0.02)
            )
            return f"n={args.get('n', 1)}"
        if a.kind == "disconnect_next":
            s.disconnect_next(args.get("n", 1))
            return f"n={args.get('n', 1)}"
        if a.kind == "delay_next":
            s.delay_next(args.get("n", 1), args.get("seconds", 0.5))
            return f"n={args.get('n', 1)} s={args.get('seconds', 0.5)}"
        if a.kind == "gone_next_watch":
            s.gone_next_watch(args.get("n", 1))
            return f"n={args.get('n', 1)}"
        if a.kind == "apply_then_disconnect_next":
            s.apply_then_disconnect_next(args.get("n", 1))
            return f"n={args.get('n', 1)}"
        if a.kind == "compact_watch_log":
            s.compact_watch_log()
            return ""
        if a.kind == "outage_begin":
            s.set_outage(
                True, writes_only=args.get("writes_only", False)
            )
            return "writes_only" if args.get("writes_only") else ""
        if a.kind == "outage_end":
            s.set_outage(False)
            return ""
        if a.kind == "node_storm":
            kill = args.get("kill", 1)
            with s._lock:
                alive = sorted(s.nodes)
            victims = self.rng.sample(alive, min(kill, len(alive)))
            for name in victims:
                s.drop_node(name)
            return f"killed={victims}"
        if a.kind == "pod_burst":
            n = args.get("n", 16)
            base = self.rng.randrange(1_000_000)
            for i in range(n):
                s.add_pod(
                    f"burst-{base}-{i:04d}",
                    cpu=args.get("cpu", "100m"),
                    memory=args.get("memory", "64Mi"),
                )
            return f"n={n}"
        raise AssertionError(a.kind)


def seed_cluster(
    server, nodes: int, pods: int, *, racks: int = 4, seed: int = 0,
    max_pods_per_node: int = 10,
) -> None:
    """Populate the fake apiserver with a deterministic cluster (all
    pods Pending; the daemon's first rounds place them)."""
    rng = random.Random(seed)
    names = [f"node-{i:03d}" for i in range(nodes)]
    for i, name in enumerate(names):
        server.add_node(
            name, rack=f"rack-{i % racks}", pods=max_pods_per_node
        )
    for i in range(pods):
        prefs = {}
        if rng.random() < 0.5:
            prefs = {rng.choice(names): rng.randrange(100, 500)}
        server.add_pod(
            f"pod-{i:04d}", cpu="100m", memory="64Mi",
            data_prefs=prefs or None,
        )


# ---------------------------------------------------------------------------
# the three acceptance scenarios (+ the CI composite)
# ---------------------------------------------------------------------------


def scenario_node_storm(
    *, seed: int = 0, nodes: int = 16, pods: int = 64,
    kill: int = 9, at_round: int = 4, rounds: int = 26,
) -> ChaosScenario:
    """Mass node loss vs the eviction guard: >50% of nodes die at
    once (poll mode — the guard holds the implausible shrink, accepts
    it at the strike/grace bound, and the displaced pods drain through
    the staged-requeue budget)."""
    # guard: 3 strikes to accept, then ceil(displaced/budget) staged
    # waves — the small budget forces a real multi-round drain
    return ChaosScenario(
        name="node_storm", seed=seed, nodes=nodes, pods=pods,
        actions=(FaultAction(at_round, "node_storm", {"kill": kill}),),
        rounds=rounds, fault_clear_round=at_round,
        recover_within=rounds - at_round - 1,
        flags=("--max_migrations_per_round=12",),
    )


def scenario_apiserver_outage(
    *, seed: int = 1, nodes: int = 12, pods: int = 36,
    begin: int = 1, duration: int = 6, rounds: int = 60,
) -> ChaosScenario:
    """A whole-control-plane outage window right as a round's binding
    POSTs go out: the outbox parks them, degraded=outage is declared,
    rounds keep running from last-known state, and recovery replays
    the outbox idempotently (exactly-once)."""
    return ChaosScenario(
        name="apiserver_outage", seed=seed, nodes=nodes, pods=pods,
        actions=(
            FaultAction(begin, "outage_begin"),
            FaultAction(begin + duration, "outage_end"),
        ),
        rounds=rounds, fault_clear_round=begin + duration,
        recover_within=rounds - begin - duration - 1,
        # pipelined: POSTs ride the overlap window, so the outage
        # window catches the staged POSTs exactly as decided
        flags=("--round_pipeline=true",),
    )


def scenario_overload_burst(
    *, seed: int = 2, nodes: int = 24, pods: int = 24,
    burst: int = 150, at_round: int = 2, rounds: int = 12,
) -> ChaosScenario:
    """An arrival burst plus a 429 throttle burst: the tick path must
    absorb the whole burst in a bounded number of certified rounds
    (placement is not budget-staged — only node-death re-queue is)
    while the client's retry path rides out the throttles."""
    return ChaosScenario(
        name="overload_burst", seed=seed, nodes=nodes, pods=pods,
        actions=(
            FaultAction(at_round, "pod_burst", {"n": burst}),
            FaultAction(at_round, "rate_limit_next",
                        {"n": 8, "retry_after_s": 0.02}),
        ),
        rounds=rounds, fault_clear_round=at_round + 1,
        recover_within=rounds - at_round - 2,
    )


def scenario_composite(
    *, seed: int = 3, nodes: int = 24, pods: int = 40,
    rounds: int = 90,
) -> ChaosScenario:
    """The CI smoke composite: an arrival burst whose binding POSTs
    ride straight into an apiserver outage window (outbox parks +
    replays, degraded=outage declared and cleared), then a >50% node
    storm (the mass-eviction guard holds, accepts, and the displaced
    pods drain through the staged-requeue budget), then a 429 +
    arrival burst — one daemon survives all three in sequence (poll
    mode: the guard is a snapshot defense, so the storm must arrive
    as a poll diff to exercise it)."""
    return ChaosScenario(
        name="composite", seed=seed, nodes=nodes, pods=pods,
        actions=(
            # burst decided at round ~9; its POSTs ride the next
            # tick's overlap window — exactly when the outage begins
            FaultAction(8, "pod_burst", {"n": 24}),
            FaultAction(9, "outage_begin"),
            FaultAction(16, "outage_end"),
            # 13 of 24 nodes (54%): over the guard threshold
            FaultAction(35, "node_storm", {"kill": 13}),
            FaultAction(55, "rate_limit_next",
                        {"n": 6, "retry_after_s": 0.02}),
            FaultAction(55, "pod_burst", {"n": 32}),
        ),
        rounds=rounds, fault_clear_round=56,
        recover_within=rounds - 57,
        flags=("--max_migrations_per_round=8",),
    )


SCENARIOS = {
    "node_storm": scenario_node_storm,
    "apiserver_outage": scenario_apiserver_outage,
    "overload_burst": scenario_overload_burst,
    "composite": scenario_composite,
}


# ---------------------------------------------------------------------------
# the daemon harness
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScenarioRun:
    """One scenario's evidence bundle."""

    scenario: ChaosScenario
    exit_code: int
    stats: list[dict]
    trace_events: list
    applied: list[tuple[int, str, str]]
    server: object            # the (stopped) FakeApiServer
    stats_path: str = ""
    trace_path: str = ""


def run_daemon_scenario(
    scenario: ChaosScenario, workdir: str, *,
    polling_ms: float = 30.0, extra_flags: tuple[str, ...] = (),
) -> ScenarioRun:
    """Drive the REAL daemon loop (cli.run_loop) through one scenario
    against a fresh fake apiserver; returns the evidence bundle. The
    server is stopped (but its final state kept) before returning. The
    daemon runs on the card unless ``extra_flags`` names another
    ``--device`` (``--device=cpu`` in the CPU tests)."""
    from poseidon_tpu_torch.apiclient.fake_server import FakeApiServer
    from poseidon_tpu_torch.cli import parse_args, run_loop
    from poseidon_tpu_torch.trace import read_trace

    server = FakeApiServer().start()
    try:
        seed_cluster(
            server, scenario.nodes, scenario.pods, seed=scenario.seed
        )
        orch = ChaosOrchestrator(server, scenario)
        stats_path = os.path.join(
            workdir, f"{scenario.name}-stats.jsonl"
        )
        trace_path = os.path.join(
            workdir, f"{scenario.name}-trace.jsonl"
        )
        for path in (stats_path, trace_path):
            # the daemon appends; a re-run of the same scenario in
            # the same workdir (a warm-up pass, then a counted one) must
            # start from empty evidence files
            if os.path.exists(path):
                os.remove(path)
        argv = [
            f"--k8s_apiserver_port={server.port}",
            f"--polling_frequency={int(polling_ms * 1000)}",
            f"--max_rounds={scenario.rounds}",
            f"--stats_json={stats_path}",
            f"--trace_log={trace_path}",
            "--max_solver_runtime=30000000",
            *scenario.flags,
            *extra_flags,
        ]
        args = parse_args(argv)
        code = run_loop(args, round_hook=orch.on_round)
        server.apply_pending()
        stats = read_stats(stats_path)
        events = list(read_trace(trace_path))
        return ScenarioRun(
            scenario=scenario, exit_code=code, stats=stats,
            trace_events=events, applied=list(orch.applied),
            server=server, stats_path=stats_path,
            trace_path=trace_path,
        )
    finally:
        server.stop()


def read_stats(path: str) -> list[dict]:
    """The daemon's --stats_json lines (one SchedulerStats per round,
    file order = round order)."""
    out: list[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            if line.strip():
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InvariantReport:
    ok: bool
    failures: list[str]
    details: dict

    def assert_ok(self) -> None:
        assert self.ok, "; ".join(self.failures)


def rounds_to_recover(
    stats: list[dict], after_round: int
) -> int | None:
    """Rounds from ``after_round`` to the first FULLY recovered round
    (no pending, no unscheduled, no parked displacement) that is never
    followed by new scheduling pressure. None = never recovered."""
    recovered_at = None
    for row in stats:
        rn = row.get("round_num", 0)
        if rn <= after_round:
            continue
        settled = (
            row.get("pods_pending", 0) == 0
            and row.get("pods_unscheduled", 0) == 0
            and row.get("displaced_parked", 0) == 0
            and row.get("outbox_pending", 0) == 0
        )
        if settled and recovered_at is None:
            recovered_at = rn
        elif not settled:
            recovered_at = None  # pressure returned: not recovered yet
    if recovered_at is None:
        return None
    return recovered_at - after_round


def check_invariants(
    run: ScenarioRun, *,
    expect_guard: bool = False,
    guard_release_rounds: int | None = None,
) -> InvariantReport:
    """Machine-check the survival invariants over one scenario run."""
    failures: list[str] = []
    details: dict = {}
    server = run.server
    stats = run.stats

    if run.exit_code != 0:
        failures.append(f"daemon exited {run.exit_code}")

    # ---- exactly-once actuation (the apiserver's ordered op_log:
    # a pod may be re-bound only after an eviction or a node-death
    # orphaning put it back to Pending) ----
    bound: dict[str, str] = {}
    double_binds: list[str] = []
    for op, pod, node in server.op_log:
        if op == "bind":
            if pod in bound:
                double_binds.append(
                    f"{pod}: bound to {node} while bound to "
                    f"{bound[pod]}"
                )
            bound[pod] = node
        elif op in ("evict", "orphan"):
            bound.pop(pod, None)
    details["op_log_len"] = len(server.op_log)
    details["double_binds"] = double_binds
    if double_binds:
        failures.append(
            f"exactly-once violated: {double_binds[:5]} "
            f"(+{max(len(double_binds) - 5, 0)} more)"
        )

    # ---- zero lost pods: everything the apiserver knows ends
    # Running on a live node ----
    lost = []
    with server._lock:
        for key, doc in server.pods.items():
            phase = doc.get("status", {}).get("phase", "")
            node = doc.get("spec", {}).get("nodeName", "")
            if phase != "Running" or not node:
                lost.append(f"{key} ({phase or 'no phase'})")
            elif node not in server.nodes:
                lost.append(f"{key} (on dead node {node})")
    details["lost_pods"] = lost
    if lost:
        failures.append(
            f"{len(lost)} pod(s) not Running on a live node at end: "
            f"{lost[:5]}"
        )

    # ---- guard holds are always closed, accepted within the bound --
    holds: dict[str, int] = {}      # kind -> first-hold round
    releases: list[tuple[str, str, int]] = []
    open_holds: dict[str, int] = {}
    for ev in run.trace_events:
        if ev.event == "EVICTION_GUARD_HOLD":
            kind = (ev.detail or {}).get("kind", "?")
            holds.setdefault(kind, ev.round_num)
            open_holds.setdefault(kind, ev.round_num)
        elif ev.event == "EVICTION_GUARD_RELEASE":
            d = ev.detail or {}
            kind = d.get("kind", "?")
            releases.append((kind, d.get("outcome", "?"),
                             ev.round_num))
            first = open_holds.pop(kind, None)
            if (
                d.get("outcome") == "accepted"
                and guard_release_rounds is not None
                and first is not None
                and ev.round_num - first > guard_release_rounds
            ):
                failures.append(
                    f"guard {kind} released after "
                    f"{ev.round_num - first} rounds "
                    f"(bound {guard_release_rounds})"
                )
    details["guard_holds"] = holds
    details["guard_releases"] = releases
    if open_holds:
        failures.append(
            f"guard hold(s) never released: {open_holds}"
        )
    if expect_guard and not holds:
        failures.append(
            "expected the mass-eviction guard to hold, but it never "
            "fired"
        )
    if expect_guard and not any(
        o == "accepted" for _, o, _ in releases
    ):
        failures.append("guard never ACCEPTED the shrink")

    # ---- bounded recovery to a settled certified state ----
    rtr = rounds_to_recover(stats, run.scenario.fault_clear_round)
    details["rounds_to_recover"] = rtr
    if rtr is None:
        failures.append(
            f"never recovered after round "
            f"{run.scenario.fault_clear_round}"
        )
    elif rtr > run.scenario.recover_within:
        failures.append(
            f"recovery took {rtr} rounds "
            f"(bound {run.scenario.recover_within})"
        )

    # ---- no silent degrades: every solve kept its certificate ----
    degrades = max(
        (row.get("degrades_total", 0) for row in stats), default=0
    )
    details["degrades_total"] = degrades
    if degrades:
        failures.append(f"{degrades} dense-lane degrade(s) during run")

    return InvariantReport(
        ok=not failures, failures=failures, details=details
    )
