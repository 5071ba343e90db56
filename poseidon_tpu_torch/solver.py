"""The solver front door: priced flow network in, placements-ready flows out.

A port of ``poseidon_tpu/solver.py``. ``solve_scheduling`` dispatches a
priced network:

- an instance under the small-instance thresholds goes to the C++
  oracle (the device's per-launch floor exceeds the whole CPU solve);
- a graph that matches the builder taxonomy solves as a transportation
  problem on the dense auction (``ops/dense_auction.py``), which
  certifies its own exactness; an uncertified solve re-runs on the
  oracle;
- a graph outside the taxonomy (hand-written DIMACS, exotic topologies)
  solves on the general-graph lane, cost-scaling push-relabel
  (``ops/cost_scaling.py``), with the oracle only on its guards.

The returned ``SolveOutcome.state`` is the warm handle: pass it back as
``warm`` on the next round over the same padded shapes and the auction
re-settles at eps = 1. The resident round (``ops/resident.py``) shares
the small-instance predicate.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import weakref

import numpy as np

from poseidon_tpu_torch.graph.builder import GraphMeta
from poseidon_tpu_torch.graph.network import FlowNetwork
from poseidon_tpu_torch.guards import GuardError
from poseidon_tpu_torch.ops.dense_auction import (
    CostDomainTooLarge,
    DenseMemoryTooLarge,
    DenseState,
    solve_transport_dense,
)
from poseidon_tpu_torch.ops.transport import (
    NotSchedulingShaped,
    TransportInstance,
    TransportTopology,
    extract_topology,
    flows_from_assignment,
    instance_from_topology,
)

log = logging.getLogger(__name__)

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


@dataclasses.dataclass(frozen=True)
class SolveOutcome:
    """Result of one scheduling solve, whatever backend produced it."""

    flows: np.ndarray        # int32 per-arc flows over the real arcs
    cost: int                # exact integer objective
    backend: str             # "dense_auction" | "cost_scaling" | "oracle:<why>"
    exact: bool              # certified optimal (always True on return)
    solve_ms: float          # wall time of the successful solve
    state: DenseState | None  # warm handle for the next round (dense path)
    instance: TransportInstance | None
    # per-task machine index (or -1) when the backend produced an
    # assignment directly: callers skip flow decomposition
    assignment: np.ndarray | None = None


def assignment_from_outcome(
    outcome: SolveOutcome, meta: GraphMeta, net: FlowNetwork
) -> np.ndarray:
    """Per-task machine indices (-1 = unscheduled) for any outcome.

    Backends that assign directly (the dense auction) return it as-is;
    flow-only backends (oracle fallbacks, the general lane) decompose
    their flows into placements first.
    """
    if outcome.assignment is not None:
        return np.asarray(outcome.assignment, np.int32)
    from poseidon_tpu_torch.graph.decompose import extract_placements

    host = net.to_host()
    placements = extract_placements(
        np.asarray(outcome.flows, np.int64), meta,
        host["src"], host["dst"],
    )
    midx = {name: i for i, name in enumerate(meta.machine_names)}
    asg = np.full(len(meta.task_uids), -1, np.int32)
    for i, uid in enumerate(meta.task_uids):
        m = placements.get(uid)
        if m is not None:
            asg[i] = midx[m]
    return asg


# Topology cache: repeated solves over the SAME GraphMeta object skip the
# O(arcs) taxonomy validation; only the cost refill runs per call. Keyed
# by id(meta) with a weakref finalizer so entries die with their meta
# (GraphMeta holds ndarrays and is not hashable).
_TOPO_CACHE: dict[int, TransportTopology] = {}


def _topology_for(net: FlowNetwork, meta: GraphMeta):
    """(topology, host arrays) for a priced net, cached per meta."""
    if int(net.n_arcs) != int(meta.n_arcs) or int(net.n_nodes) != int(
        meta.n_nodes
    ):
        raise NotSchedulingShaped(
            f"network ({net.n_nodes} nodes / {net.n_arcs} arcs) does "
            f"not match the builder metadata ({meta.n_nodes} / "
            f"{meta.n_arcs})"
        )
    host = net.to_host()
    cached = _TOPO_CACHE.get(id(meta))
    if cached is not None:
        # capacities live in the NET, not the meta: refill the
        # cap-derived fields from this call's arc table, after the cheap
        # parallel-cap consistency check (cluster->machine and
        # rack->machine caps mirror the machine->sink slots); a mismatch
        # falls through to the full validating extraction (which raises)
        cap = np.asarray(host["cap"], np.int64)
        slots = cap[cached.arc_m2s].astype(np.int32)
        r2m_ok = cached.arc_r2m >= 0
        if (cap[cached.arc_c2m] == slots).all() and (
            cap[cached.arc_r2m[r2m_ok]] == slots[r2m_ok]
        ).all():
            return dataclasses.replace(
                cached,
                slots=slots,
                job_sink_cap=cap[cached.arc_job_sink],
            ), host
        _TOPO_CACHE.pop(id(meta), None)
    topo = extract_topology(meta, host["src"], host["dst"], host["cap"])
    _TOPO_CACHE[id(meta)] = topo
    weakref.finalize(meta, _TOPO_CACHE.pop, id(meta), None)
    return topo, host


def solve_scheduling(
    net: FlowNetwork,
    meta: GraphMeta,
    *,
    warm: DenseState | None = None,
    oracle_fallback: bool = True,
    oracle_timeout_s: float = 1000.0,
    small_to_oracle: bool = True,
    topology: TransportTopology | None = None,
    device=None,
) -> SolveOutcome:
    """Solve a priced scheduling network exactly; prefer the device.

    ``device`` (``None``: the card; ``"cpu"`` runs the kernels' plain
    twins) carries both device lanes. ``warm`` is a previous round's
    ``SolveOutcome.state`` over the same padded shapes (a shape change
    falls back to a cold solve). ``small_to_oracle`` lets instances under
    the SMALL_INSTANCE_* thresholds go straight to the oracle.
    ``topology`` (optional) is a pre-derived transport skeleton; repeated
    calls over the same ``meta`` object hit the topology cache either
    way.

    Error surface: with ``oracle_fallback=False``, kernel-envelope guards
    re-raise their typed exceptions (``CostDomainTooLarge``,
    ``DenseMemoryTooLarge``, ``GuardError``), while a solve that runs but
    cannot certify (the auction exhausting its round fuse, or the
    general lane failing its guards) raises ``RuntimeError``. Only a
    host guard (``GuardError``) degrades to the oracle: an error a
    kernel wrapper raises at launch propagates either way.
    """
    from poseidon_tpu_torch.ops.resident import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    # size dispatch BEFORE extraction: meta alone names the instance size
    if (
        small_to_oracle
        and oracle_fallback
        and warm is None
        and is_small_instance(
            len(meta.task_uids), len(meta.machine_names)
        )
    ):
        return _solve_on_oracle(
            net, t0, why="small-instance", timeout_s=oracle_timeout_s
        )
    try:
        if topology is not None:
            host = net.to_host()
        else:
            topology, host = _topology_for(net, meta)
        inst = instance_from_topology(topology, host["cost"])
    except NotSchedulingShaped:
        return _solve_general(
            net, t0, oracle_fallback=oracle_fallback,
            timeout_s=oracle_timeout_s, device=dev,
        )

    try:
        res, state = solve_transport_dense(inst, warm=warm, device=dev)
    except CostDomainTooLarge:
        if not oracle_fallback:
            raise
        return _solve_on_oracle(net, t0, why="cost-domain",
                                timeout_s=oracle_timeout_s)
    except DenseMemoryTooLarge:
        # the [Tp, Mp] table would blow the memory budget: degrade loudly
        log.warning(
            "instance %dx%d exceeds the dense memory budget; degrading "
            "to oracle", inst.n_tasks, inst.n_machines,
        )
        if not oracle_fallback:
            raise
        return _solve_on_oracle(net, t0, why="memory-envelope",
                                timeout_s=oracle_timeout_s)
    except GuardError:
        # an instance outside the kernel's envelope (e.g. negative costs
        # from a custom model) degrades, loudly
        log.exception(
            "dense kernel rejected the instance; degrading to oracle"
        )
        if not oracle_fallback:
            raise
        return _solve_on_oracle(net, t0, why="kernel-envelope",
                                timeout_s=oracle_timeout_s)
    if not res.converged and warm is not None:
        # a stale warm start can strand the eps=1 settle; retry cold
        res, state = solve_transport_dense(inst, warm=None, device=dev)
    if res.converged:
        flows = flows_from_assignment(inst, res, int(net.n_arcs))
        return SolveOutcome(
            flows=flows,
            cost=res.cost,
            backend="dense_auction",
            exact=True,
            solve_ms=(time.perf_counter() - t0) * 1000,
            state=state,
            instance=inst,
            assignment=res.assignment,
        )
    if not oracle_fallback:
        raise RuntimeError(
            f"dense auction did not certify (gap still open after "
            f"{res.rounds} rounds) and oracle fallback is disabled"
        )
    return _solve_on_oracle(net, t0, why="uncertified",
                            timeout_s=oracle_timeout_s)


def _solve_general(
    net: FlowNetwork, t0: float, *, oracle_fallback: bool,
    timeout_s: float, device,
) -> SolveOutcome:
    """Non-taxonomy graphs: the exact general-graph backend
    (``ops/cost_scaling``), with the C++ oracle only on its guards: the
    int32 excess-wrap precheck, a blown sweep fuse, or an instance the
    forcing-arc construction reports capacity-infeasible."""
    from poseidon_tpu_torch.ops.cost_scaling import (
        solution_cost,
        solve_cost_scaling,
    )

    guard_err: GuardError | None = None
    try:
        res = solve_cost_scaling(net, device=device)
        if res.converged and res.feasible:
            return SolveOutcome(
                flows=np.asarray(res.flows, np.int32),
                cost=solution_cost(net, res),
                backend="cost_scaling",
                exact=True,
                solve_ms=(time.perf_counter() - t0) * 1000,
                state=None,
                instance=None,
            )
        why = "general-unconverged" if not res.converged else "general-infeasible"
    except GuardError as e:
        # the excess-wrap precheck: a documented guard, not a kernel bug
        log.warning("general backend rejected the graph: %s", e)
        guard_err = e
        why = "general-guard"
    if not oracle_fallback:
        # chain the guard's error so the traceback names the check
        raise RuntimeError(
            f"general solve failed ({why}) and oracle fallback is disabled"
        ) from guard_err
    return _solve_on_oracle(net, t0, why=why, timeout_s=timeout_s)


def _solve_on_oracle(
    net: FlowNetwork, t0: float, why: str, timeout_s: float = 1000.0
) -> SolveOutcome:
    from poseidon_tpu_torch.oracle import solve_oracle

    o = solve_oracle(net, algorithm="cost_scaling", timeout_s=timeout_s)
    return SolveOutcome(
        flows=np.asarray(o.flows, np.int32),
        cost=int(o.cost),
        backend=f"oracle:{why}",
        exact=True,
        solve_ms=(time.perf_counter() - t0) * 1000,
        state=None,
        instance=None,
    )
