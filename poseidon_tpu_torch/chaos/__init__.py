"""Deterministic chaos harness: seeded fault schedules + invariants.

The failure-domain survival story (node-failure storms, apiserver
outages, overload bursts) is only real if it is *machine-checked*:
``scenarios.py`` drives the REAL daemon loop (cli.run_loop, fake
apiserver, journal/outbox/guard all live) through seeded,
round-scheduled fault injections and asserts the invariants that
define "survived" — exactly-once actuation, zero lost pods, guard
release within the grace bound, and bounded time back to a certified
round after the fault clears. The port of ``poseidon_tpu/chaos/``:
the same scenarios, seeds and invariants, over the port's daemon
(``tests/test_torch_chaos.py``; ``chip_smoke.py`` ``[chaos]`` on the
card).
"""

from poseidon_tpu_torch.chaos.scenarios import (
    ChaosOrchestrator,
    ChaosScenario,
    FaultAction,
    InvariantReport,
    check_invariants,
    read_stats,
    rounds_to_recover,
    run_daemon_scenario,
    scenario_apiserver_outage,
    scenario_composite,
    scenario_node_storm,
    scenario_overload_burst,
    seed_cluster,
)

__all__ = [
    "ChaosOrchestrator",
    "ChaosScenario",
    "FaultAction",
    "InvariantReport",
    "check_invariants",
    "read_stats",
    "rounds_to_recover",
    "run_daemon_scenario",
    "scenario_apiserver_outage",
    "scenario_composite",
    "scenario_node_storm",
    "scenario_overload_burst",
    "seed_cluster",
]
