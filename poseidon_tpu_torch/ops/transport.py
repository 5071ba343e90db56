"""Transportation form of the builder's scheduling graphs.

The flow graphs the builder emits (graph/builder.py, the
Firmament taxonomy the reference drives through ``FlowScheduler`` —
reference src/firmament/scheduler_bridge.cc:61-127) have a rigid 4-layer
shape: every unit of flow goes task -> {unsched | cluster | rack pref |
machine pref} -> machine -> sink, and the ONLY binding capacities are the
per-machine slot counts (machine->sink; the parallel cluster->machine and
rack->machine caps equal it) and the unit task arcs. Such an instance is a
*transportation problem* with mostly-separable costs:

    minimize  sum_t c_t(a_t)   over assignments a_t in {unsched} | [M]
    subject to |{t : a_t = m}| <= slots_m

where c_t(m) routes through the cheapest of the task's channels to m.
This module holds the validated extraction of that form's cost-free
skeleton (``extract_topology``, raising ``NotSchedulingShaped`` for
anything outside the taxonomy so callers fall back to the oracle), its
pricing (``instance_from_topology``), the shared result type, and the
expansion of an assignment back to per-arc flows.
The solver itself is the dense class-price auction in
ops/dense_auction.py; the independent correctness baseline is the C++
oracle (oracle/).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from poseidon_tpu_torch.graph.builder import ArcKind, BuilderColumns, GraphMeta

INF = np.int64(2**48)

# Channel codes in the assignment result.
CH_UNSCHED = 0
CH_CLUSTER = 1
CH_PREF = 2  # CH_PREF + k = assigned via pref arc k


class NotSchedulingShaped(ValueError):
    """The instance is not a builder-taxonomy scheduling graph."""


@dataclasses.dataclass(frozen=True)
class TransportTopology:
    """The cost-free skeleton of a scheduling graph: index maps + slots.

    This is everything ``extract_instance`` derives that does NOT depend
    on arc costs — the per-round-stable part. The device-resident solve
    path (ops/resident.py) uploads these index arrays and gathers the
    priced arc table on device, so repricing a round never crosses the
    host boundary (the TPU analog of the reference's graph-change
    batching seam, deploy/poseidon.cfg:12-19).
    """

    # per task
    job_of: np.ndarray        # int32[T] job index (unsched aggregator)
    arc_unsched: np.ndarray   # int32[T] task->unsched arc
    arc_cluster: np.ndarray   # int32[T] task->cluster arc
    arc_u2s: np.ndarray       # int32[T] unsched_j->sink arc for t's job
    # prefs, padded [T, P]
    arc_pref: np.ndarray      # int32[T, P] pref arc or -1
    pref_machine: np.ndarray  # int32[T, P] machine index or -1
    pref_rack: np.ndarray     # int32[T, P] rack index or -1
    # per machine
    arc_c2m: np.ndarray       # int32[M] cluster->machine arc or -1
    arc_r2m: np.ndarray       # int32[M] rack->machine arc or -1
    arc_m2s: np.ndarray       # int32[M] machine->sink arc or -1
    rack_of: np.ndarray       # int32[M] rack index or -1
    slots: np.ndarray         # int32[M] free slot capacity
    # per job (unsched aggregator)
    arc_job_sink: np.ndarray  # int32[J] unsched_j->sink arc
    job_sink_cap: np.ndarray  # int64[J] unsched_j->sink capacity
    n_racks: int

    @property
    def n_tasks(self) -> int:
        return self.arc_unsched.shape[0]

    @property
    def n_machines(self) -> int:
        return self.arc_m2s.shape[0]

    @property
    def max_prefs(self) -> int:
        return self.arc_pref.shape[1]


@dataclasses.dataclass(frozen=True)
class TransportInstance:
    """Compact transportation form of a scheduling flow graph.

    All costs are int64 and *route-inclusive*: ``d``/``ra``/``pref_cost``
    for machine-targeting channels already include the machine->sink leg,
    so a slot price is the single dual variable per unit of machine
    capacity.
    """

    # per task
    u: np.ndarray           # int64[T] unsched route cost
    w: np.ndarray           # int64[T] cluster-channel arc cost
    pref_cost: np.ndarray   # int64[T, P] channel cost (INF = no pref)
    pref_machine: np.ndarray  # int32[T, P] machine index or -1
    pref_rack: np.ndarray   # int32[T, P] rack index or -1
    # per machine
    d: np.ndarray           # int64[M] cluster->m + m->sink cost
    ra: np.ndarray          # int64[M] rack(m)->m + m->sink cost (INF none)
    slots: np.ndarray       # int32[M]
    rack_of: np.ndarray     # int32[M] rack index or -1
    # split arc costs (callers that re-price or re-route need the
    # per-arc legs, not just the route-combined values above)
    g: np.ndarray           # int64[M] m->sink arc cost
    tu: np.ndarray          # int64[T] task->unsched arc cost
    job_of: np.ndarray      # int32[T] job index (unsched aggregator)
    job_sink_cost: np.ndarray  # int64[J] unsched_j->sink arc cost
    job_sink_cap: np.ndarray   # int64[J] unsched_j->sink capacity
    # arc-index maps for flow reconstruction (index into the real arcs)
    arc_unsched: np.ndarray   # int32[T] task->unsched arc
    arc_cluster: np.ndarray   # int32[T] task->cluster arc
    arc_pref: np.ndarray      # int32[T, P] pref arc or -1
    arc_c2m: np.ndarray       # int32[M] cluster->machine arc or -1
    arc_r2m: np.ndarray       # int32[M] rack->machine arc or -1
    arc_m2s: np.ndarray       # int32[M] machine->sink arc or -1
    arc_u2s: np.ndarray       # int32[T] unsched_j->sink arc for t's job
    n_racks: int

    @property
    def n_tasks(self) -> int:
        return self.u.shape[0]

    @property
    def n_machines(self) -> int:
        return self.d.shape[0]

    @property
    def max_prefs(self) -> int:
        return self.pref_cost.shape[1]


def extract_topology(
    meta: GraphMeta,
    src: np.ndarray,
    dst: np.ndarray,
    cap: np.ndarray,
) -> TransportTopology:
    """Validate the builder taxonomy and derive the cost-free skeleton.

    ``src``/``dst``/``cap`` are host arrays over the REAL arcs (no
    padding). Raises NotSchedulingShaped if the arc table does not match
    the builder's shape contract (in which case callers fall back to the
    general solvers).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    cap = np.asarray(cap, np.int64)
    if len(src) != meta.n_arcs or len(cap) != meta.n_arcs:
        raise NotSchedulingShaped(
            f"arc arrays ({len(src)}) do not match the builder metadata "
            f"({meta.n_arcs})"
        )
    kind = meta.arc_kind
    T, M = len(meta.task_uids), len(meta.machine_names)
    R = len(meta.rack_names)

    def arcs_of(k: ArcKind) -> np.ndarray:
        return np.where(kind == int(k))[0]

    def unique_per_key(arcs, keys, n, label) -> np.ndarray:
        """Scatter arc ids by key; every key exactly once (vectorized —
        the per-arc Python loops here ran every scheduling round and
        cost more than the solve at 12k machines)."""
        keys = np.asarray(keys)
        if (keys < 0).any():
            raise NotSchedulingShaped(f"unlabeled {label} arc")
        if (keys >= n).any():
            raise NotSchedulingShaped(f"{label} arc label out of range")
        counts = np.bincount(keys, minlength=n)
        if (counts > 1).any():
            raise NotSchedulingShaped(f"duplicate {label} arc")
        if (counts == 0).any():
            raise NotSchedulingShaped(f"missing {label} arc")
        out = np.full(n, -1, np.int32)
        out[keys] = arcs
        return out

    # machine -> sink: the binding capacity
    m2s = arcs_of(ArcKind.MACHINE_TO_SINK)
    arc_m2s = unique_per_key(m2s, meta.arc_machine[m2s], M, "machine->sink")
    slots = cap[arc_m2s].astype(np.int32)

    c2m = arcs_of(ArcKind.CLUSTER_TO_MACHINE)
    arc_c2m = unique_per_key(
        c2m, meta.arc_machine[c2m], M, "cluster->machine"
    )
    if (cap[arc_c2m] != slots).any():
        raise NotSchedulingShaped("cluster->machine cap != machine slots")

    # rack -> machine is optional per machine
    r2m = arcs_of(ArcKind.RACK_TO_MACHINE)
    arc_r2m = np.full(M, -1, np.int32)
    rack_of = np.full(M, -1, np.int32)
    if len(r2m):
        rm = meta.arc_machine[r2m]
        if (rm < 0).any():
            raise NotSchedulingShaped("unlabeled rack->machine arc")
        if (rm >= M).any():
            raise NotSchedulingShaped("rack->machine arc label out of range")
        if np.bincount(rm, minlength=M).max(initial=0) > 1:
            raise NotSchedulingShaped("duplicate rack->machine arc")
        arc_r2m[rm] = r2m
        rack_of[rm] = meta.arc_rack[r2m]
        if (cap[r2m] != slots[rm]).any():
            raise NotSchedulingShaped("rack->machine cap != machine slots")

    # unsched aggregators: task->unsched + unsched->sink
    u2s = arcs_of(ArcKind.UNSCHED_TO_SINK)
    J = len(u2s)
    job_sink_cap = cap[u2s] if J else np.zeros(0, np.int64)
    # map aggregator node id -> job index via a dense node lookup
    node_job = np.full(meta.n_nodes, -1, np.int32)
    node_job[src[u2s].astype(np.int64)] = np.arange(J, dtype=np.int32)

    t2u = arcs_of(ArcKind.TASK_TO_UNSCHED)
    arc_unsched = unique_per_key(
        t2u, meta.arc_task[t2u], T, "task->unsched"
    )
    drain = dst[arc_unsched].astype(np.int64)
    job_of = node_job[drain]
    if (job_of < 0).any():
        raise NotSchedulingShaped("unsched arc without aggregator drain")
    arc_u2s = u2s[job_of].astype(np.int32)

    t2c = arcs_of(ArcKind.TASK_TO_CLUSTER)
    arc_cluster = unique_per_key(
        t2c, meta.arc_task[t2c], T, "task->cluster"
    )

    # preference arcs, ragged -> padded [T, P] (rank by stable sort)
    tm = arcs_of(ArcKind.TASK_TO_MACHINE)
    tr = arcs_of(ArcKind.TASK_TO_RACK)
    pa = np.concatenate([tm, tr]).astype(np.int32)
    pt = np.concatenate([meta.arc_task[tm], meta.arc_task[tr]])
    if len(pa) and ((pt < 0).any() or (pt >= T).any()):
        raise NotSchedulingShaped("unlabeled preference arc")
    pm = np.concatenate(
        [meta.arc_machine[tm], np.full(len(tr), -1, np.int32)]
    )
    pr = np.concatenate(
        [np.full(len(tm), -1, np.int32), meta.arc_rack[tr]]
    )
    if len(pa):
        order = np.argsort(pt, kind="stable")
        pt, pm, pr, pa = pt[order], pm[order], pr[order], pa[order]
        counts = np.bincount(pt, minlength=T)
        P = max(int(counts.max(initial=0)), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(pa)) - starts[pt]
    else:
        P = 1
        rank = np.zeros(0, np.int64)
    pref_machine = np.full((T, P), -1, np.int32)
    pref_rack = np.full((T, P), -1, np.int32)
    arc_pref = np.full((T, P), -1, np.int32)
    if len(pa):
        pref_machine[pt, rank] = pm
        pref_rack[pt, rank] = pr
        arc_pref[pt, rank] = pa

    labeled = (
        len(t2u) + len(t2c) + len(c2m) + len(r2m) + len(m2s) + len(u2s)
        + int((arc_pref >= 0).sum())
    )
    if labeled != meta.n_arcs:
        raise NotSchedulingShaped(
            f"arc table has {meta.n_arcs - labeled} arcs outside the taxonomy"
        )
    return TransportTopology(
        job_of=job_of, arc_unsched=arc_unsched, arc_cluster=arc_cluster,
        arc_u2s=arc_u2s, arc_pref=arc_pref, pref_machine=pref_machine,
        pref_rack=pref_rack, arc_c2m=arc_c2m, arc_r2m=arc_r2m,
        arc_m2s=arc_m2s, rack_of=rack_of, slots=slots,
        arc_job_sink=u2s.astype(np.int32), job_sink_cap=job_sink_cap,
        n_racks=R,
    )


def topology_from_columns(cols: BuilderColumns) -> TransportTopology:
    """Derive the transport skeleton straight from builder columns.

    ``FlowGraphBuilder.assemble`` lays the arc families out
    deterministically ([task->unsched, task->cluster, machine prefs,
    rack prefs, cluster->machine, rack->machine, machine->sink,
    unsched->sink], each family in canonical order), so every arc index
    ``extract_topology`` would recover by validating the emitted arc
    table is computable analytically in O(T + M) vectorized numpy — no
    re-validation per round. The equivalence against
    ``extract_topology`` over the assembled arrays is asserted in
    tests/test_torch_incremental.py.
    """
    T, M = len(cols.uids), len(cols.machine_names)
    J = len(cols.jobs)
    is_mp = cols.pref_m >= 0
    n_mp = int(is_mp.sum())
    n_rp = len(cols.pref_m) - n_mp
    has_rack = cols.m_rack >= 0
    n_hr = int(has_rack.sum())

    base_mp = 2 * T
    base_rp = base_mp + n_mp
    base_c2m = base_rp + n_rp
    base_r2m = base_c2m + M
    base_m2s = base_r2m + n_hr
    base_u2s = base_m2s + M

    arc_unsched = np.arange(0, T, dtype=np.int32)
    arc_cluster = np.arange(T, 2 * T, dtype=np.int32)
    arc_c2m = np.arange(base_c2m, base_c2m + M, dtype=np.int32)
    arc_m2s = np.arange(base_m2s, base_m2s + M, dtype=np.int32)
    arc_r2m = np.full(M, -1, np.int32)
    arc_r2m[has_rack] = np.arange(
        base_r2m, base_r2m + n_hr, dtype=np.int32
    )
    u2s = np.arange(base_u2s, base_u2s + J, dtype=np.int32)
    slots = np.maximum(cols.m_max - cols.used_slots, 0).astype(np.int32)

    # ragged prefs -> padded [T, P]: within a task, machine prefs rank
    # before rack prefs, each in flat (data_prefs) order — the same
    # order extract_topology's stable sort produces
    counts = cols.pref_counts
    p_t = np.repeat(np.arange(T, dtype=np.int32), counts)
    P = max(int(counts.max(initial=0)), 1)
    pref_machine = np.full((T, P), -1, np.int32)
    pref_rack = np.full((T, P), -1, np.int32)
    arc_pref = np.full((T, P), -1, np.int32)
    if len(p_t):
        t_mp = p_t[is_mp]
        t_rp = p_t[~is_mp]
        cnt_m = np.bincount(t_mp, minlength=T)
        cnt_r = np.bincount(t_rp, minlength=T)
        start_m = np.concatenate([[0], np.cumsum(cnt_m)[:-1]])
        start_r = np.concatenate([[0], np.cumsum(cnt_r)[:-1]])
        rank_m = np.arange(n_mp) - start_m[t_mp]
        rank_r = cnt_m[t_rp] + np.arange(n_rp) - start_r[t_rp]
        pref_machine[t_mp, rank_m] = cols.pref_m[is_mp]
        pref_rack[t_rp, rank_r] = cols.pref_r[~is_mp]
        arc_pref[t_mp, rank_m] = np.arange(
            base_mp, base_mp + n_mp, dtype=np.int32
        )
        arc_pref[t_rp, rank_r] = np.arange(
            base_rp, base_rp + n_rp, dtype=np.int32
        )

    job_of = cols.job_idx
    arc_u2s = (
        u2s[job_of] if T else np.zeros(0, np.int32)
    )
    return TransportTopology(
        job_of=job_of,
        arc_unsched=arc_unsched,
        arc_cluster=arc_cluster,
        arc_u2s=arc_u2s,
        arc_pref=arc_pref,
        pref_machine=pref_machine,
        pref_rack=pref_rack,
        arc_c2m=arc_c2m,
        arc_r2m=arc_r2m,
        arc_m2s=arc_m2s,
        rack_of=cols.m_rack,
        slots=slots,
        arc_job_sink=u2s,
        job_sink_cap=cols.job_counts.astype(np.int64),
        n_racks=len(cols.racks),
    )


def instance_from_topology(
    topo: TransportTopology, cost: np.ndarray
) -> TransportInstance:
    """Fill a topology skeleton with host arc costs -> TransportInstance."""
    cost = np.asarray(cost, np.int64)
    g = cost[topo.arc_m2s]
    d = cost[topo.arc_c2m] + g
    ra = np.where(
        topo.arc_r2m >= 0,
        cost[np.maximum(topo.arc_r2m, 0)] + g,
        INF,
    )
    jsc = cost[topo.arc_job_sink]
    tu = cost[topo.arc_unsched]
    u = tu + cost[topo.arc_u2s]
    w = cost[topo.arc_cluster]
    mp = topo.pref_machine
    pref_cost = np.where(
        topo.arc_pref >= 0,
        cost[np.maximum(topo.arc_pref, 0)]
        + np.where(mp >= 0, g[np.maximum(mp, 0)], 0),
        INF,
    )
    return TransportInstance(
        u=u, w=w, pref_cost=pref_cost, pref_machine=topo.pref_machine,
        pref_rack=topo.pref_rack, d=d, ra=ra, slots=topo.slots,
        rack_of=topo.rack_of, g=g, tu=tu, job_of=topo.job_of,
        job_sink_cost=jsc, job_sink_cap=topo.job_sink_cap,
        arc_unsched=topo.arc_unsched, arc_cluster=topo.arc_cluster,
        arc_pref=topo.arc_pref, arc_c2m=topo.arc_c2m,
        arc_r2m=topo.arc_r2m, arc_m2s=topo.arc_m2s, arc_u2s=topo.arc_u2s,
        n_racks=topo.n_racks,
    )


def extract_instance(net, meta: GraphMeta) -> TransportInstance:
    """Validate the builder taxonomy of a priced network and compact it
    to transportation form (host arrays).

    Raises NotSchedulingShaped if the arc table does not match the
    builder's shape contract. The per-round production loop uses the
    device-resident path in ops/resident.py instead.
    """
    if int(net.n_arcs) != int(meta.n_arcs) or int(net.n_nodes) != int(
        meta.n_nodes
    ):
        raise NotSchedulingShaped(
            f"network ({net.n_nodes} nodes / {net.n_arcs} arcs) does not "
            f"match the builder metadata ({meta.n_nodes} / {meta.n_arcs})"
        )
    host = net.to_host()
    topo = extract_topology(meta, host["src"], host["dst"], host["cap"])
    return instance_from_topology(topo, host["cost"])


def assignment_cost(
    inst: TransportInstance, assignment: np.ndarray
) -> int:
    """Objective of a FIXED assignment over a transport instance: each
    assigned task routes through its cheapest channel to its machine,
    unassigned tasks pay their unsched route. Raises ValueError if some
    assigned machine is unreachable for its task (no channel covers it).
    """
    asg = np.asarray(assignment, np.int64)
    T = inst.n_tasks
    if T == 0:
        return 0
    on = asg >= 0
    m = np.clip(asg, 0, max(inst.n_machines - 1, 0))
    best = np.where(on, inst.w + inst.d[m], INF)  # cluster channel
    hit_m = inst.pref_machine == asg[:, None]
    pc = np.where(hit_m, inst.pref_cost, INF)
    hit_r = (inst.pref_rack >= 0) & (
        inst.pref_rack == inst.rack_of[m][:, None]
    )
    pc = np.minimum(
        pc, np.where(hit_r, inst.pref_cost + inst.ra[m][:, None], INF)
    )
    best = np.minimum(best, pc.min(axis=1, initial=INF))
    if (best[on] >= INF).any():
        bad = int(np.flatnonzero(on & (best >= INF))[0])
        raise ValueError(
            f"task {bad} cannot reach its assigned machine "
            f"{int(asg[bad])} through any channel"
        )
    return int(np.where(on, best, inst.u).sum())


@dataclasses.dataclass(frozen=True)
class TransportResult:
    assignment: np.ndarray   # int32[T] machine index, -1 = unscheduled
    channel: np.ndarray      # int32[T] CH_* code
    cost: int                # exact objective (unscaled)
    rounds: int              # auction rounds across all phases
    phases: int
    converged: bool


def flows_from_assignment(
    inst: TransportInstance, result: TransportResult, n_arc_slots: int
) -> np.ndarray:
    """Expand an assignment back to per-arc flows on the arc table.

    Vectorized: one np.add.at scatter per arc family (the per-task loop
    cost ~20 ms per round at the flagship scale)."""
    f = np.zeros(n_arc_slots, np.int64)
    T = inst.n_tasks
    if T == 0:
        return f.astype(np.int32)
    ch = np.asarray(result.channel)
    asg = np.asarray(result.assignment)
    t_ids = np.arange(T)

    uns = (ch == CH_UNSCHED) | (ch < 0)
    np.add.at(f, inst.arc_unsched[uns], 1)
    np.add.at(f, inst.arc_u2s[uns], 1)

    clu = ch == CH_CLUSTER
    m_clu = asg[clu]
    np.add.at(f, inst.arc_cluster[clu], 1)
    np.add.at(f, inst.arc_c2m[m_clu], 1)
    np.add.at(f, inst.arc_m2s[m_clu], 1)

    prf = ch >= CH_PREF
    if prf.any():
        k = ch[prf] - CH_PREF
        tp = t_ids[prf]
        mp = asg[prf]
        np.add.at(f, inst.arc_pref[tp, k], 1)
        via_rack = inst.pref_machine[tp, k] < 0
        np.add.at(f, inst.arc_r2m[mp[via_rack]], 1)
        np.add.at(f, inst.arc_m2s[mp], 1)
    return f.astype(np.int32)
