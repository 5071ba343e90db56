"""Dispatch thresholds shared by the solver entry points.

Only the small-instance predicate lives here for now: the resident
round (ops/resident.py) routes tiny instances to the C++ oracle. The
``solve_scheduling`` front door comes with a later part of the port.
"""

from __future__ import annotations

# Small-instance dispatch thresholds: below this size the device's
# per-launch floor exceeds the whole subprocess-oracle solve (the same
# bounds as the reference package).
SMALL_INSTANCE_TASKS = 256
SMALL_INSTANCE_MACHINES = 64


def is_small_instance(n_tasks: int, n_machines: int) -> bool:
    """True when the subprocess oracle beats the device launch floor."""
    return (
        0 < n_tasks <= SMALL_INSTANCE_TASKS
        and n_machines <= SMALL_INSTANCE_MACHINES
    )
