"""SchedulingDelta vocabulary: solved assignment -> typed decisions.

Firmament turns each solve into ``SchedulingDelta`` records of four
kinds — PLACE a pending task, MIGRATE a running task to a better
machine, PREEMPT a running task back to unscheduled, or NOOP (keep it
where it is). The reference only ever actuates PLACE (its
``scheduler_bridge.cc:176-190`` loop binds new placements and nothing
else); this module closes the vocabulary: ``extract_deltas`` diffs the
solver's per-task assignment against the current placements recorded in
``GraphMeta.task_current`` and emits typed records, with a per-round
migration budget so one solve cannot churn the whole cluster at once.

Budget semantics: MIGRATE and PREEMPT are both disruptive (each tears a
running pod off its machine), so they share the ``max_migrations``
budget, granted in task order (stable across rounds). Deltas beyond the
budget are returned as ``deferred`` — nothing is actuated for them, the
tasks stay where they are, and the next round's solve re-proposes
whatever still improves the objective, so dropped migrations re-enter
naturally.

Pending tasks the solver left unassigned are not deltas (there is
nothing to do); they are returned as ``unscheduled`` uids so the bridge
can age them.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np

from poseidon_tpu_torch.graph.builder import GraphMeta


class DeltaKind(IntEnum):
    PLACE = 0     # pending task -> machine (a new binding)
    MIGRATE = 1   # running task -> different machine (unbind + rebind)
    PREEMPT = 2   # running task -> unscheduled (evict + park, aged)
    NOOP = 3      # running task keeps its machine


# Sentinel for "runner-up margin not computed / no finite alternative"
# (int64-safe; a real margin can be negative when capacity forces a
# worse-than-runner-up choice, so 0/-1 cannot be the sentinel).
MARGIN_UNKNOWN = np.int64(2) ** 62


@dataclasses.dataclass(frozen=True)
class SchedulingDelta:
    """One typed scheduling decision for one task.

    ``cost`` is the decision's exact int64 route cost under the round's
    instance (the solver's per-task objective contribution: the chosen
    machine route for PLACE/MIGRATE/NOOP, the priced unsched route for
    PREEMPT); ``margin`` is runner-up-minus-chosen — how much worse the
    next-best alternative was (negative when capacity forced this task
    off its cheapest machine). Both default to "unknown" when the
    caller has no per-task cost vector (legacy/flow-only backends)."""

    kind: DeltaKind
    task: str            # task uid
    machine: str = ""    # target machine (PLACE/MIGRATE; "" otherwise)
    from_machine: str = ""  # current machine (MIGRATE/PREEMPT/NOOP)
    cost: int | None = None
    margin: int | None = None


@dataclasses.dataclass
class DeltaSet:
    """One round's typed decisions, budget already applied."""

    place: list[SchedulingDelta]
    migrate: list[SchedulingDelta]
    preempt: list[SchedulingDelta]
    noop: list[SchedulingDelta]
    # disruptive deltas dropped by the migration budget (typed as what
    # they would have been); nothing is actuated for these
    deferred: list[SchedulingDelta]
    unscheduled: list[str]   # pending uids the solver left unassigned

    @property
    def counts(self) -> dict[str, int]:
        return {
            "place": len(self.place),
            "migrate": len(self.migrate),
            "preempt": len(self.preempt),
            "noop": len(self.noop),
            "deferred": len(self.deferred),
        }


def extract_deltas(
    meta: GraphMeta,
    assignment: np.ndarray,
    *,
    max_migrations: int = 0,
    task_cost: np.ndarray | None = None,
    task_margin: np.ndarray | None = None,
) -> DeltaSet:
    """Diff a solved assignment against current placements.

    ``assignment`` is the solver's per-task machine index (or -1 =
    unscheduled) over ``meta.task_uids`` order; ``meta.task_current``
    names where each task runs today (-1 = pending). ``max_migrations``
    bounds MIGRATE+PREEMPT per round (0 = unlimited); excess disruptive
    deltas land in ``deferred`` in task order.

    ``task_cost`` / ``task_margin`` (optional, int64 over task order)
    stamp each typed delta with its exact route cost and runner-up
    margin (``ResidentOutcome.task_cost``/``task_margin``); a
    ``MARGIN_UNKNOWN`` margin entry maps to None.
    """
    asg = np.asarray(assignment, np.int64)
    cur = np.asarray(meta.task_current, np.int64)
    if asg.shape != cur.shape:
        raise ValueError(
            f"assignment length {asg.shape} does not match the "
            f"metadata task count {cur.shape}"
        )
    names = meta.machine_names
    uids = meta.task_uids
    is_run = cur >= 0

    def _cost(i) -> int | None:
        return int(task_cost[i]) if task_cost is not None else None

    def _margin(i) -> int | None:
        if task_margin is None:
            return None
        m = int(task_margin[i])
        return None if m == MARGIN_UNKNOWN else m

    place = [
        SchedulingDelta(DeltaKind.PLACE, uids[i], machine=names[asg[i]],
                        cost=_cost(i), margin=_margin(i))
        for i in np.flatnonzero(~is_run & (asg >= 0))
    ]
    unscheduled = [
        uids[i] for i in np.flatnonzero(~is_run & (asg < 0))
    ]
    noop = [
        SchedulingDelta(DeltaKind.NOOP, uids[i],
                        machine=names[cur[i]],
                        from_machine=names[cur[i]],
                        cost=_cost(i), margin=_margin(i))
        for i in np.flatnonzero(is_run & (asg == cur))
    ]

    disruptive: list[SchedulingDelta] = []
    for i in np.flatnonzero(is_run & (asg != cur)):
        if asg[i] >= 0:
            disruptive.append(SchedulingDelta(
                DeltaKind.MIGRATE, uids[i], machine=names[asg[i]],
                from_machine=names[cur[i]],
                cost=_cost(i), margin=_margin(i),
            ))
        else:
            disruptive.append(SchedulingDelta(
                DeltaKind.PREEMPT, uids[i], from_machine=names[cur[i]],
                cost=_cost(i), margin=_margin(i),
            ))
    budget = max_migrations if max_migrations > 0 else len(disruptive)
    granted, deferred = disruptive[:budget], disruptive[budget:]
    return DeltaSet(
        place=place,
        migrate=[d for d in granted if d.kind == DeltaKind.MIGRATE],
        preempt=[d for d in granted if d.kind == DeltaKind.PREEMPT],
        noop=noop,
        deferred=deferred,
        unscheduled=unscheduled,
    )
