"""The scheduler bridge (cluster state <-> resident solver)."""

from poseidon_tpu_torch.bridge.bridge import (
    InflightRound,
    RoundResult,
    SchedulerBridge,
    SchedulerStats,
)

__all__ = [
    "InflightRound",
    "SchedulerBridge",
    "SchedulerStats",
    "RoundResult",
]
