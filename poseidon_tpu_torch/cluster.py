"""Cluster domain model: machines, tasks, utilization samples.

This is the framework-internal mirror of what the reference builds from the
Kubernetes API: nodes become schedulable resources (reference
src/firmament/scheduler_bridge.cc:81-111, one RESOURCE_PU per node parented
to a synthetic coordinator root) and pending pods become single-task jobs
(scheduler_bridge.cc:61-79). The structs below correspond to the
reference's ``NodeStatistics`` / ``PodStatistics`` DTOs
(src/apiclient/utils.h:39-52) plus the topology facts (rack) that the
Quincy cost model needs.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Sequence


class TaskPhase(str, Enum):
    """Pod lifecycle phases the bridge dispatches on.

    Mirrors the k8s ``status.phase`` strings the reference switches over in
    scheduler_bridge.cc:132-162.
    """

    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclasses.dataclass(frozen=True)
class Machine:
    """A schedulable machine (k8s node -> Firmament RESOURCE_PU).

    Capacity fields mirror reference utils.h:39-45; ``max_tasks`` is the
    reference's --max_tasks_per_pu knob (deploy/poseidon.cfg:4).
    """

    name: str
    cpu_capacity: float = 1.0
    cpu_allocatable: float = 1.0
    memory_capacity_kb: int = 1 << 20
    memory_allocatable_kb: int = 1 << 20
    rack: str = ""
    max_tasks: int = 10


@dataclasses.dataclass(frozen=True)
class Task:
    """A unit of work to place (pending pod -> single-task Firmament job).

    ``cpu_request`` / ``memory_request_kb`` mirror utils.h:47-52 (summed
    container requests, k8s_api_client.cc:291-301). ``data_prefs`` carries
    Quincy-style data locality: machine/rack names mapped to the number of
    input bytes (scaled units) local there.
    """

    # The scheduler-wide identity. The API client qualifies it as
    # "{namespace}/{name}" — pod names are only unique per namespace, so
    # keying bridge state by the bare name would collide two same-named
    # pods from different namespaces into one task (state corruption the
    # reference ducks only by hardcoding namespace "default",
    # k8s_api_client.cc:222). Synthetic/test tasks may use bare uids.
    uid: str
    namespace: str = "default"
    job: str = ""
    cpu_request: float = 0.1
    memory_request_kb: int = 0
    phase: TaskPhase = TaskPhase.PENDING
    # machine name a RUNNING task is bound to ("" if not placed) — consumed
    # by the builder to discount already-used machine slots
    machine: str = ""
    # Quincy data locality: {machine_or_rack_name: locality_weight}
    data_prefs: dict[str, int] = dataclasses.field(default_factory=dict)
    # Rounds this task has sat unscheduled — Quincy's unscheduled-cost input
    # (grows each round the bridge re-offers the task; SURVEY.md section 7.4)
    wait_rounds: int = 0

    @property
    def job_id(self) -> str:
        return self.job or self.uid

    @property
    def name(self) -> str:
        """Bare pod name (the uid without its namespace qualifier) —
        what the k8s bindings POST wants in ``metadata.name``."""
        return self.uid.split("/", 1)[1] if "/" in self.uid else self.uid


@dataclasses.dataclass
class ClusterState:
    """The full scheduling input for one round."""

    machines: list[Machine]
    tasks: list[Task]

    def pending(self) -> list[Task]:
        return [t for t in self.tasks if t.phase == TaskPhase.PENDING]

    def machine_index(self) -> dict[str, int]:
        return {m.name: i for i, m in enumerate(self.machines)}

    def racks(self) -> list[str]:
        seen: dict[str, None] = {}
        for m in self.machines:
            if m.rack:
                seen.setdefault(m.rack, None)
        return list(seen)


def make_cluster(
    machines: Sequence[Machine] | None = None,
    tasks: Sequence[Task] | None = None,
) -> ClusterState:
    return ClusterState(machines=list(machines or []), tasks=list(tasks or []))
