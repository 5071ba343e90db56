"""Equivalence-class aggregation: shrink the machine axis before densify.

The dense auction's device footprint is the [T, M] cost table, so the
scale ceiling is the MACHINE axis: a 512k-task x 64k-machine round is
~128 GiB of int32 and the budget guard
(ops/dense_auction.py::check_table_budget) degrades it to the CPU
oracle. Firmament's cost models route tasks through machine-class
*equivalence aggregators*, the arc-compression trick that made Quincy's
flow formulation tractable at cluster scale. This module is that trick
for the dense lane; it restates ``poseidon_tpu/graph/aggregate.py``
(host numpy) over the port's ``TransportTopology``, array for array.

Machines are partitioned into **equivalence classes**: two machines
share a class when every channel cost any task could pay at them is
identical — the generic route (cluster->m + m->sink), the rack route
(rack(m)->m + m->sink) and the rack id itself. Members of a class are
then interchangeable goods, so the dense table only needs ONE column
per class, with capacity = the summed member slots, and the aggregated
optimum equals the all-pairs optimum *exactly* (any class assignment
expands to a member assignment of identical cost, and vice versa; the
differential tests hold it instance by instance). Machines named by a
task's machine-preference arc (including rebalancing continuation arcs)
are **pinned** into singleton classes —
a preference prices one specific machine, so that machine must stay
individually addressable for the class-level pref hit to stay exact.

Two plan builders, one per lane:

- ``plan_from_costs`` keys the signature on the PRICED arc table
  (d, g, ra, rack) — exact for any cost model, used where host costs
  exist (the differential tests, host tooling);
- ``plan_from_signatures`` keys on the cost model's per-machine INPUTS
  (rack, load, mem-free, used slots — the capacity bucket / label /
  knowledge-base utilization band of the Firmament taxonomy), so the
  production resident round (ops/resident.py) can plan BEFORE pricing
  without a host sync. Equal inputs imply equal prices for every
  registry model that prices machines by their signature (all of them
  except ``random``, which hashes the machine index and is rejected by
  the resident lane's guard).

``expand_assignment`` maps the winning class assignment back to real
machines, keeping every task already running on a member of its
assigned class in place (so rebalancing deltas reflect real moves, not
expansion noise), then filling remaining seats in canonical machine
order. ``prune_topology_prefs`` is the companion top-k preference
pruning: arcs grow O(tasks * k) instead of O(tasks * max_prefs), exact
whenever k covers every task's prefs, a stated approximation below
that; continuation arcs are never pruned (dropping one would force a
spurious migration).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from poseidon_tpu_torch.ops.transport import TransportTopology


@dataclasses.dataclass(frozen=True)
class AggregatePlan:
    """A machine -> equivalence-class partition (host-side, O(M) ints).

    Columns are numbered by first member in machine order, so the plan
    is deterministic for a given signature table. ``rep_machine`` names
    the member whose arcs price the whole column (members are
    cost-identical by construction, so any member works; the first is
    canonical). Pinned columns (preference targets) are singletons.
    """

    col_of_machine: np.ndarray  # int32[M] column of each machine
    rep_machine: np.ndarray     # int32[C] representative member
    col_slots: np.ndarray       # int32[C] summed member slot capacity
    n_machines: int
    n_pinned: int               # singleton columns forced by pref arcs

    @property
    def n_cols(self) -> int:
        return len(self.rep_machine)


def _pinned_mask(topo: TransportTopology) -> np.ndarray:
    """Machines named by any task's machine-preference arc."""
    pin = np.zeros(topo.n_machines, bool)
    pm = topo.pref_machine
    hit = pm[pm >= 0]
    if len(hit):
        pin[hit] = True
    return pin


def _plan_from_keys(
    key: np.ndarray, slots: np.ndarray, n_pinned: int
) -> AggregatePlan:
    """Group machines by identical key rows; column order follows the
    first member's machine index (deterministic, machine-order stable).
    """
    M = len(slots)
    _, inverse = np.unique(key, axis=0, return_inverse=True)
    inverse = inverse.reshape(M)
    C = int(inverse.max(initial=-1)) + 1
    rep = np.full(C, M, np.int64)
    np.minimum.at(rep, inverse, np.arange(M, dtype=np.int64))
    order = np.argsort(rep, kind="stable")
    renum = np.empty(C, np.int64)
    renum[order] = np.arange(C, dtype=np.int64)
    col = renum[inverse]
    col_slots = np.zeros(C, np.int64)
    np.add.at(col_slots, col, slots.astype(np.int64))
    return AggregatePlan(
        col_of_machine=col.astype(np.int32),
        rep_machine=rep[order].astype(np.int32),
        col_slots=np.minimum(col_slots, np.int64(2**31 - 1)).astype(
            np.int32
        ),
        n_machines=M,
        n_pinned=n_pinned,
    )


def plan_from_costs(
    topo: TransportTopology, cost: np.ndarray
) -> AggregatePlan:
    """Partition machines by their PRICED signature (exact for any
    model): (pinned, cluster->m cost, m->sink cost, rack->m cost,
    rack id). ``cost`` is the host int cost vector over the real arcs.
    """
    M = topo.n_machines
    cost = cost.astype(np.int64, copy=False)
    g = cost[topo.arc_m2s]
    c2m = cost[topo.arc_c2m]
    r2m = np.where(
        topo.arc_r2m >= 0, cost[np.maximum(topo.arc_r2m, 0)],
        np.int64(-1),
    )
    pin = _pinned_mask(topo)
    key = np.column_stack([
        np.where(pin, np.arange(M, dtype=np.int64) + 1, 0),
        c2m, g, r2m, topo.rack_of.astype(np.int64),
    ])
    return _plan_from_keys(key, topo.slots, int(pin.sum()))


def _float_bits(arr, n: int) -> np.ndarray:
    """Exact-equality int64 key for a per-machine float column (None =
    the build_cost_inputs_host default: an unsampled cluster)."""
    if arr is None:
        return np.zeros(n, np.int64)
    a = arr.astype(np.float32, copy=False)
    return np.ascontiguousarray(a).view(np.int32).astype(np.int64)


def plan_from_signatures(
    topo: TransportTopology,
    *,
    machine_load: np.ndarray | None = None,
    machine_mem_free: np.ndarray | None = None,
    machine_used_slots: np.ndarray | None = None,
) -> AggregatePlan:
    """Partition machines by their COST-MODEL-INPUT signature, before
    any pricing happens: (pinned, rack id, load band, free-mem band,
    used slots). Exact whenever the model prices a machine purely from
    these inputs — true for every registry model except ``random``
    (which hashes the machine index; the resident lane rejects it).
    Float bands use exact bit equality: identical knowledge-base
    aggregates, identical class. The arguments mirror
    ``build_cost_inputs_host``'s machine-side kwargs (None = the same
    unsampled defaults).
    """
    M = topo.n_machines
    pin = _pinned_mask(topo)
    used = (
        machine_used_slots.astype(np.int64, copy=False)
        if machine_used_slots is not None else np.zeros(M, np.int64)
    )
    key = np.column_stack([
        np.where(pin, np.arange(M, dtype=np.int64) + 1, 0),
        topo.rack_of.astype(np.int64),
        _float_bits(machine_load, M)[:M],
        _float_bits(machine_mem_free, M)[:M],
        used[:M],
    ])
    return _plan_from_keys(key, topo.slots, int(pin.sum()))


def aggregate_topology(
    topo: TransportTopology, plan: AggregatePlan
) -> TransportTopology:
    """The class-level transport skeleton: machine axis = plan columns.

    Arc indices still point into the ORIGINAL arc table (each column
    prices through its representative member's arcs), so the aggregated
    topology composes with ``instance_from_topology`` and the resident
    chain's on-device cost gathers unchanged. Task-side and job-side
    structure is untouched; machine preferences remap to their target's
    (pinned, singleton) column.
    """
    rep = plan.rep_machine
    pm = topo.pref_machine
    col_pm = np.where(
        pm >= 0, plan.col_of_machine[np.maximum(pm, 0)], -1
    ).astype(np.int32)
    return TransportTopology(
        job_of=topo.job_of,
        arc_unsched=topo.arc_unsched,
        arc_cluster=topo.arc_cluster,
        arc_u2s=topo.arc_u2s,
        arc_pref=topo.arc_pref,
        pref_machine=col_pm,
        pref_rack=topo.pref_rack,
        arc_c2m=topo.arc_c2m[rep],
        arc_r2m=topo.arc_r2m[rep],
        arc_m2s=topo.arc_m2s[rep],
        rack_of=topo.rack_of[rep],
        slots=plan.col_slots,
        arc_job_sink=topo.arc_job_sink,
        job_sink_cap=topo.job_sink_cap,
        n_racks=topo.n_racks,
    )


def prune_topology_prefs(
    topo: TransportTopology,
    arc_weight: np.ndarray,
    arc_discount: np.ndarray,
    k: int,
) -> TransportTopology:
    """Keep each task's k heaviest preference rows (Quincy's locality
    weight = how much input data the pref makes local, so the heaviest
    prefs are the ones the optimum plausibly uses). Identity when k
    already covers ``max_prefs``; a bounded approximation below that
    (the dropped prefs' tasks still route via the generic channel).
    Rebalancing continuation arcs (``arc_discount > 0``) are never
    pruned — dropping one would turn "stay put" into a forced
    migration/preemption.
    """
    P = topo.max_prefs
    if k <= 0 or P <= k:
        return topo
    ap = topo.arc_pref
    w = np.where(
        ap >= 0,
        arc_weight[np.maximum(ap, 0)].astype(np.int64),
        np.int64(-1),
    )
    protected = (ap >= 0) & (arc_discount[np.maximum(ap, 0)] > 0)
    eff = np.where(protected, np.int64(2**62), w)
    order = np.argsort(-eff, axis=1, kind="stable")[:, :k]
    return dataclasses.replace(
        topo,
        arc_pref=np.take_along_axis(ap, order, axis=1),
        pref_machine=np.take_along_axis(topo.pref_machine, order, axis=1),
        pref_rack=np.take_along_axis(topo.pref_rack, order, axis=1),
    )


def expand_assignment(
    plan: AggregatePlan,
    machine_slots: np.ndarray,
    current: np.ndarray,
    assignment: np.ndarray,
) -> np.ndarray:
    """Expand a per-task COLUMN assignment to real machine indices.

    Churn-minimizing and exact: a task whose ``current`` machine is a
    member of its assigned column keeps that machine (capped at the
    member's slots), so NOOP stays NOOP and rebalancing deltas reflect
    genuine moves; remaining tasks fill free member seats in canonical
    (column, machine-index) order. Members of a column are
    cost-identical by construction, so every expansion choice prices
    the same — the objective is preserved exactly. Raises ValueError if
    the assignment overfills a column (a solver-contract violation, not
    a degradable condition).
    """
    T = len(assignment)
    out = np.full(T, -1, np.int32)
    on = assignment >= 0
    if not on.any():
        return out
    col = plan.col_of_machine
    C = plan.n_cols
    M = plan.n_machines
    if (assignment[on] >= C).any():
        raise ValueError("assignment references a column past the plan")
    counts = np.bincount(assignment[on], minlength=C)
    if (counts > plan.col_slots).any():
        bad = int(np.flatnonzero(counts > plan.col_slots)[0])
        raise ValueError(
            f"aggregated assignment overfills column {bad}: "
            f"{int(counts[bad])} tasks > {int(plan.col_slots[bad])} slots"
        )
    slots = machine_slots.astype(np.int64, copy=False)

    # keep pass: tasks already on a member of their assigned column
    keep = np.flatnonzero(on & (current >= 0) & (current < M))
    if len(keep):
        keep = keep[col[current[keep]] == assignment[keep]]
    if len(keep):
        m = current[keep]
        order = np.argsort(m, kind="stable")
        ms = m[order]
        starts = np.searchsorted(ms, np.arange(M, dtype=np.int64))
        rank = np.arange(len(ms), dtype=np.int64) - starts[ms]
        kept = keep[order[rank < slots[ms]]]
        out[kept] = current[kept]

    used = np.bincount(out[out >= 0], minlength=M)
    rem = slots - used.astype(np.int64)

    # fill pass: remaining tasks take free seats in (column, machine)
    # order; feasibility follows from the column-capacity check above
    # (kept tasks occupy seats of their own column, so free seats per
    # column >= remaining tasks per column)
    need = np.flatnonzero(on & (out < 0))
    if len(need):
        m_order = np.argsort(col, kind="stable")
        seat_machine = np.repeat(m_order, rem[m_order])
        seat_col = col[seat_machine]
        col_start = np.searchsorted(
            seat_col, np.arange(C, dtype=np.int64)
        )
        cols_n = assignment[need]
        order = np.argsort(cols_n, kind="stable")
        sc = cols_n[order]
        nstart = np.searchsorted(sc, np.arange(C, dtype=np.int64))
        rank = np.arange(len(sc), dtype=np.int64) - nstart[sc]
        out[need[order]] = seat_machine[
            col_start[sc] + rank
        ].astype(np.int32)
    return out
