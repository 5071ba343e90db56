"""Host-side flow-graph builder: ClusterState -> FlowNetwork + metadata.

Reproduces the Firmament flow-network taxonomy that the reference drives
through ``FlowScheduler`` (reference src/firmament/scheduler_bridge.cc:
37-42,61-127): task nodes with unit supply, one unscheduled aggregator per
job, a cluster aggregator, optional rack aggregators, machine nodes (the
reference registers one RESOURCE_PU per k8s node under a coordinator root,
scheduler_bridge.cc:94-127), and a sink absorbing all flow. Costs are NOT
assigned here — the builder emits per-arc metadata (kind + endpoint
indices) and a cost model (models/) computes the int32 cost
vector on device, so cost recompute per round is a pure vectorized op.

Node order (deterministic): [sink, cluster_agg, racks..., machines...,
unsched_aggs..., tasks...].

The build is split in two stages so the per-round cost can scale with
*churn* instead of cluster size:

- ``FlowGraphBuilder.extract_columns`` walks the Python task/machine
  objects once and compacts them into ``BuilderColumns`` (numpy columns
  in canonical pending order) — the only O(tasks·prefs) Python work;
- ``FlowGraphBuilder.assemble`` turns columns into the arc families +
  ``GraphMeta`` with pure vectorized numpy.

The incremental (O(churn)) builder that patches ``BuilderColumns``
between rounds is not part of this package yet.

Rebalancing mode (``preemption=True``, the Firmament semantics behind
``SchedulingDelta::MIGRATE``/``PREEMPT``): RUNNING tasks enter the
graph as schedulable task nodes instead of merely discounting machine
slots. Each running task gets (a) a *continuation* arc to its current
machine — structurally an ordinary ``TASK_TO_MACHINE`` preference arc
(so the transportation form and the dense kernel apply unchanged)
carrying a ``migration_hysteresis`` discount the cost layer subtracts,
(b) the usual wildcard/preference arcs (the migration destinations),
and (c) a priced unscheduled arc whose selection means PREEMPT (the
cost layer overlays the preemption penalty). The running block is kept
in uid-sorted order, separate from the pending block, so O(churn)
patches never shift pending positions; running tasks route their
unsched arcs through per-job aggregators of their own (``run:<job>``)
— aggregator→sink arcs cost 0 under every registry model, so the split
is cost-neutral while keeping the two blocks independently patchable.
"""

from __future__ import annotations

import dataclasses
import logging
from enum import IntEnum

import numpy as np

from poseidon_tpu_torch.cluster import ClusterState, Task, TaskPhase
from poseidon_tpu_torch.graph.network import FlowNetwork

log = logging.getLogger(__name__)


class NodeRole(IntEnum):
    SINK = 0
    CLUSTER_AGG = 1
    RACK = 2
    MACHINE = 3
    UNSCHED = 4
    TASK = 5


class ArcKind(IntEnum):
    TASK_TO_UNSCHED = 0    # always present: leaving a task unscheduled
    TASK_TO_CLUSTER = 1    # wildcard arc through the cluster aggregator
    TASK_TO_MACHINE = 2    # preference arc (data locality)
    TASK_TO_RACK = 3       # preference arc to a rack aggregator
    CLUSTER_TO_MACHINE = 4
    RACK_TO_MACHINE = 5
    MACHINE_TO_SINK = 6
    UNSCHED_TO_SINK = 7


@dataclasses.dataclass(frozen=True)
class GraphMeta:
    """Host-side metadata parallel to the padded arc/node tables.

    Arrays are over REAL arcs/nodes (unpadded); index -1 means
    not-applicable. This is what cost models and the delta extractor
    consume.
    """

    node_role: np.ndarray     # int8[n_nodes]
    arc_kind: np.ndarray      # int8[n_arcs]
    arc_task: np.ndarray      # int32[n_arcs]  task index or -1
    arc_machine: np.ndarray   # int32[n_arcs]  machine index or -1
    arc_rack: np.ndarray      # int32[n_arcs]  rack index or -1
    arc_weight: np.ndarray    # int32[n_arcs]  data-locality weight (pref
                              # arcs; 0 elsewhere) — Quincy's input
    arc_discount: np.ndarray  # int32[n_arcs]  hysteresis discount
                              # (continuation arcs; 0 elsewhere)
    task_wait: np.ndarray     # int32[n_tasks] rounds each task has waited
    task_current: np.ndarray  # int32[n_tasks] current machine of a
                              # RUNNING task, -1 for pending — what the
                              # delta extractor diffs assignments against
    task_node: np.ndarray     # int32[n_tasks] node id of each task
    machine_node: np.ndarray  # int32[n_machines]
    node_machine: np.ndarray  # int32[n_nodes] machine index or -1
    task_uids: list[str]
    machine_names: list[str]
    rack_names: list[str]
    job_ids: list[str]        # per unsched-aggregator job id
    n_nodes: int
    n_arcs: int


@dataclasses.dataclass
class BuilderColumns:
    """Numpy-columnar snapshot of one round's scheduling input.

    Everything ``assemble`` needs, in canonical order (machines in
    cluster order; pending tasks in ``ClusterState.pending()`` order;
    jobs by first occurrence among pending tasks; a task's preference
    rows task-major in ``data_prefs`` iteration order). ``cpu_milli`` /
    ``mem_kb`` ride along for the bridge's pricing inputs so a delta
    round does not re-walk the task objects for them either.
    """

    machine_names: list[str]
    midx: dict[str, int]      # machine name -> index
    m_rack: np.ndarray        # int32[M] rack index or -1
    m_max: np.ndarray         # int64[M] max_tasks per machine
    used_slots: np.ndarray    # int64[M] RUNNING tasks bound per machine
    racks: list[str]
    uids: np.ndarray          # object[T] pending task uids
    jobs: np.ndarray          # object[J] job ids, first-occurrence order
    job_idx: np.ndarray       # int32[T]
    job_counts: np.ndarray    # int64[J] pending tasks per job
    wait: np.ndarray          # int32[T]
    pref_counts: np.ndarray   # int64[T] preference rows per task
    pref_m: np.ndarray        # int32[Ep] machine index or -1
    pref_r: np.ndarray        # int32[Ep] rack index or -1
    pref_w: np.ndarray        # int32[Ep] locality weight
    cpu_milli: np.ndarray     # int64[T] requested milli-cores
    mem_kb: np.ndarray        # int64[T] requested memory
    # Rebalancing block (preemption mode): RUNNING tasks in uid-sorted
    # order, kept separate from the pending block so O(churn) patches
    # on either block never shift the other's positions. Empty in
    # place-only mode. ``merge_columns`` flattens this block into the
    # canonical task sequence (pending first, then running) before
    # assembly / topology derivation.
    run_uids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, object))   # object[Rt]
    run_job: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, object))   # object[Rt]
    run_machine: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))  # int32[Rt]
    run_wait: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))  # int32[Rt]
    run_cpu: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))  # int64[Rt]
    run_mem: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))  # int64[Rt]
    run_pref_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))  # int64[Rt]
    run_pref_m: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))  # int32[Erp]
    run_pref_r: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))  # int32[Erp]
    run_pref_w: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))  # int32[Erp]
    # Merged-view extras, set by ``merge_columns`` only (None on the
    # patchable form): current machine per task (-1 = pending) and the
    # per-pref-row hysteresis discount.
    current_m: np.ndarray | None = None   # int32[T]
    pref_d: np.ndarray | None = None      # int32[Ep]


class FlowGraphBuilder:
    """Builds the MCMF instance for one scheduling round.

    ``pref_arcs`` controls whether task data-preference arcs (Quincy-style)
    are emitted; the trivial cost model routes everything through the
    cluster aggregator like Firmament's TrivialCostModel does.

    ``preemption`` turns on rebalancing mode: RUNNING tasks become
    schedulable nodes with a continuation arc to their current machine
    (discounted by ``migration_hysteresis``) and a priced unscheduled
    arc, so the solver may keep, migrate, or preempt them. Machine
    slots are then NOT discounted for running tasks — they hold their
    seats through their own unit of flow.
    """

    def __init__(
        self,
        *,
        pref_arcs: bool = True,
        rack_aggs: bool = True,
        preemption: bool = False,
        migration_hysteresis: int = 20,
    ):
        self.pref_arcs = pref_arcs
        self.rack_aggs = rack_aggs
        self.preemption = preemption
        self.migration_hysteresis = int(migration_hysteresis)

    def build(self, cluster: ClusterState) -> tuple[FlowNetwork, GraphMeta]:
        """Build the padded (host) FlowNetwork + metadata."""
        arrays, meta = self.build_arrays(cluster)
        net = FlowNetwork.from_arrays(
            arrays["src"], arrays["dst"], arrays["cap"],
            np.zeros(meta.n_arcs, dtype=np.int32),  # costs: the model's job
            arrays["supply"],
        )
        return net, meta

    def build_arrays(
        self, cluster: ClusterState
    ) -> tuple[dict[str, np.ndarray], GraphMeta]:
        """Build the graph as HOST arrays only (no device upload).

        The device-resident round (ops/resident.py) consumes these
        directly: topology index maps are derived host-side and the only
        per-round device traffic is one batched upload of pricing inputs
        — the builder must not force its own src/dst/cap transfer.
        """
        return self.assemble(self.extract_columns(cluster))

    # ---- stage 1: Python-object walk -> numpy columns -----------------

    def _task_prefs(
        self, task: Task, midx: dict[str, int], rack_idx: dict[str, int]
    ) -> list[tuple[int, int, int]]:
        """One task's resolved (machine_idx, rack_idx, weight) pref rows,
        in ``data_prefs`` iteration order (unknown names dropped)."""
        if not self.pref_arcs:
            return []
        return [
            (midx.get(name, -1), rack_idx.get(name, -1), int(weight))
            for name, weight in task.data_prefs.items()
            if name in midx or name in rack_idx
        ]

    def task_arc_rows(
        self, task: Task, midx: dict[str, int], rack_idx: dict[str, int]
    ) -> list[tuple[int, int, int]]:
        """Public single-event column patch: ONE task's resolved pref
        rows, exactly as a full extract or an incremental delta build
        would produce them. The express lane (bridge ``express_batch``
        -> ``ops/resident.py`` arrival rows) prices arrivals from this
        same resolution, so the periodic correction round — whose
        incremental build applies the identical patch — sees an
        identical graph for the pod."""
        return self._task_prefs(task, midx, rack_idx)

    def extract_columns(self, cluster: ClusterState) -> BuilderColumns:
        """The O(tasks·prefs) Python walk, done once per full rebuild."""
        machines = cluster.machines
        tasks = cluster.pending()
        racks = cluster.racks() if self.rack_aggs else []
        rack_idx = {r: i for i, r in enumerate(racks)}
        midx = cluster.machine_index()

        jobs: list[str] = []
        job_lookup: dict[str, int] = {}
        for t in tasks:
            if t.job_id not in job_lookup:
                job_lookup[t.job_id] = len(jobs)
                jobs.append(t.job_id)
        J = len(jobs)
        T = len(tasks)
        job_idx = np.array(
            [job_lookup[t.job_id] for t in tasks], dtype=np.int32
        )
        job_counts = (
            np.bincount(job_idx, minlength=J).astype(np.int64)
            if T else np.zeros(J, np.int64)
        )

        # Slots already consumed by RUNNING tasks: the reference tracks
        # running tasks against --max_tasks_per_pu inside Firmament; we
        # discount machine capacity here so re-offered slots are real.
        # In rebalancing mode running tasks are schedulable nodes and
        # hold their seats through their own unit of flow, so slots
        # stay undiscounted.
        used_slots = np.zeros(len(machines), dtype=np.int64)
        run_block: dict = {}
        if self.preemption:
            running_tasks = sorted(
                (t for t in cluster.tasks
                 if t.phase == TaskPhase.RUNNING and t.machine in midx),
                key=lambda t: t.uid,
            )
            per_run = [
                self._task_prefs(t, midx, rack_idx) for t in running_tasks
            ]
            run_trip = [row for rows in per_run for row in rows]
            run_block = dict(
                run_uids=np.array(
                    [t.uid for t in running_tasks], dtype=object
                ),
                run_job=np.array(
                    [t.job_id for t in running_tasks], dtype=object
                ),
                run_machine=np.array(
                    [midx[t.machine] for t in running_tasks], np.int32
                ),
                run_wait=np.array(
                    [t.wait_rounds for t in running_tasks], np.int32
                ),
                run_cpu=np.array(
                    [int(t.cpu_request * 1000) for t in running_tasks],
                    np.int64,
                ),
                run_mem=np.array(
                    [t.memory_request_kb for t in running_tasks],
                    np.int64,
                ),
                run_pref_counts=np.array(
                    [len(rows) for rows in per_run], np.int64
                ),
                run_pref_m=np.array([x[0] for x in run_trip], np.int32),
                run_pref_r=np.array([x[1] for x in run_trip], np.int32),
                run_pref_w=np.array([x[2] for x in run_trip], np.int32),
            )
        else:
            running = [
                midx[t.machine] for t in cluster.tasks
                if t.phase == TaskPhase.RUNNING and t.machine in midx
            ]
            if running:
                np.add.at(used_slots, running, 1)

        per_task = [self._task_prefs(t, midx, rack_idx) for t in tasks]
        trip = [row for rows in per_task for row in rows]
        pref_counts = np.array(
            [len(rows) for rows in per_task], dtype=np.int64
        ) if T else np.zeros(0, np.int64)

        return BuilderColumns(
            machine_names=[m.name for m in machines],
            midx=midx,
            m_rack=np.array(
                [rack_idx.get(m.rack, -1) if m.rack else -1
                 for m in machines],
                dtype=np.int32,
            ),
            m_max=np.array(
                [int(m.max_tasks) for m in machines], np.int64
            ),
            used_slots=used_slots,
            racks=racks,
            uids=np.array([t.uid for t in tasks], dtype=object),
            jobs=np.array(jobs, dtype=object),
            job_idx=job_idx,
            job_counts=job_counts,
            wait=np.array([t.wait_rounds for t in tasks], dtype=np.int32),
            pref_counts=pref_counts,
            pref_m=np.array([x[0] for x in trip], dtype=np.int32),
            pref_r=np.array([x[1] for x in trip], dtype=np.int32),
            pref_w=np.array([x[2] for x in trip], dtype=np.int32),
            cpu_milli=np.array(
                [int(t.cpu_request * 1000) for t in tasks], np.int64
            ),
            mem_kb=np.array(
                [t.memory_request_kb for t in tasks], np.int64
            ),
            **run_block,
        )

    # ---- stage 1.5: flatten the running block (pure numpy) ------------

    def merge_columns(self, cols: BuilderColumns) -> BuilderColumns:
        """Flatten the rebalancing block into the canonical task order.

        Returns ``cols`` unchanged when there is no running block (or it
        is already merged), so place-only mode pays nothing. Running
        tasks follow the pending block; each contributes its
        continuation row (current machine, weight 0, hysteresis
        discount) as its FIRST preference row, then its data prefs;
        their unsched aggregators are per-job but namespaced
        (``run:<job>``) so the two blocks stay independently patchable
        — aggregator→sink arcs cost 0 under every registry model, so
        the split is cost-neutral.
        """
        Rt = len(cols.run_uids)
        if cols.current_m is not None or Rt == 0:
            return cols
        T, J = len(cols.uids), len(cols.jobs)
        # running-block jobs: first occurrence among uid-sorted tasks
        rj, first, inv = np.unique(
            cols.run_job, return_index=True, return_inverse=True
        )
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), np.int32)
        rank[order] = np.arange(len(order), dtype=np.int32)
        run_job_idx = rank[inv].astype(np.int32)
        run_jobs = rj[order]
        run_job_counts = np.bincount(
            run_job_idx, minlength=len(run_jobs)
        ).astype(np.int64)
        # continuation rows, inserted as each task's first pref row
        starts = np.zeros(Rt, np.int64)
        if Rt > 1:
            starts[1:] = np.cumsum(cols.run_pref_counts)[:-1]
        h = np.int32(self.migration_hysteresis)
        n_rp = len(cols.run_pref_m)
        pref_m2 = np.insert(cols.run_pref_m, starts, cols.run_machine)
        pref_r2 = np.insert(
            cols.run_pref_r, starts, np.full(Rt, -1, np.int32)
        )
        pref_w2 = np.insert(
            cols.run_pref_w, starts, np.zeros(Rt, np.int32)
        )
        pref_d2 = np.insert(
            np.zeros(n_rp, np.int32), starts, np.full(Rt, h, np.int32)
        )
        return dataclasses.replace(
            cols,
            uids=np.concatenate([cols.uids, cols.run_uids]),
            jobs=np.concatenate([
                cols.jobs,
                np.array([f"run:{j}" for j in run_jobs], dtype=object),
            ]),
            job_idx=np.concatenate([cols.job_idx, run_job_idx + J]),
            job_counts=np.concatenate([cols.job_counts, run_job_counts]),
            wait=np.concatenate([cols.wait, cols.run_wait]),
            pref_counts=np.concatenate(
                [cols.pref_counts, cols.run_pref_counts + 1]
            ),
            pref_m=np.concatenate([cols.pref_m, pref_m2]),
            pref_r=np.concatenate([cols.pref_r, pref_r2]),
            pref_w=np.concatenate([cols.pref_w, pref_w2]),
            cpu_milli=np.concatenate([cols.cpu_milli, cols.run_cpu]),
            mem_kb=np.concatenate([cols.mem_kb, cols.run_mem]),
            current_m=np.concatenate([
                np.full(T, -1, np.int32), cols.run_machine,
            ]),
            pref_d=np.concatenate([
                np.zeros(len(cols.pref_m), np.int32), pref_d2,
            ]),
            run_uids=np.zeros(0, object),
            run_job=np.zeros(0, object),
            run_machine=np.zeros(0, np.int32),
            run_wait=np.zeros(0, np.int32),
            run_cpu=np.zeros(0, np.int64),
            run_mem=np.zeros(0, np.int64),
            run_pref_counts=np.zeros(0, np.int64),
            run_pref_m=np.zeros(0, np.int32),
            run_pref_r=np.zeros(0, np.int32),
            run_pref_w=np.zeros(0, np.int32),
        )

    # ---- stage 2: columns -> arc families + meta (pure numpy) ---------

    def assemble(
        self, cols: BuilderColumns
    ) -> tuple[dict[str, np.ndarray], GraphMeta]:
        cols = self.merge_columns(cols)
        M, T = len(cols.machine_names), len(cols.uids)
        R, J = len(cols.racks), len(cols.jobs)
        # node layout
        SINK = 0
        CLUSTER = 1
        rack_base = 2
        machine_base = rack_base + R
        unsched_base = machine_base + M
        task_base = unsched_base + J
        n_nodes = task_base + T

        node_role = np.empty(n_nodes, dtype=np.int8)
        node_role[SINK] = NodeRole.SINK
        node_role[CLUSTER] = NodeRole.CLUSTER_AGG
        node_role[rack_base:machine_base] = NodeRole.RACK
        node_role[machine_base:unsched_base] = NodeRole.MACHINE
        node_role[unsched_base:task_base] = NodeRole.UNSCHED
        node_role[task_base:] = NodeRole.TASK

        node_machine = np.full(n_nodes, -1, dtype=np.int32)
        node_machine[machine_base:unsched_base] = np.arange(
            M, dtype=np.int32
        )

        # Everything below is vectorized per arc FAMILY (a per-arc
        # Python append loop costs ~300 ms at the 10k-pod flagship and
        # runs every scheduling round). Family order:
        # [task->unsched, task->cluster, prefs..., cluster->machine,
        #  rack->machine, machine->sink, unsched->sink]; nothing
        # downstream depends on arc order, only on kind labels.
        job_of = cols.job_idx
        job_task_count = cols.job_counts

        t_ids = np.arange(T, dtype=np.int32)
        t_nodes = task_base + t_ids

        p_t = np.repeat(t_ids, cols.pref_counts)
        p_m, p_r, p_w = cols.pref_m, cols.pref_r, cols.pref_w
        p_d = (
            cols.pref_d if cols.pref_d is not None
            else np.zeros(len(p_m), np.int32)
        )
        current_m = (
            cols.current_m if cols.current_m is not None
            else np.full(T, -1, np.int32)
        )
        is_mp = p_m >= 0

        m_ids = np.arange(M, dtype=np.int32)
        m_nodes = machine_base + m_ids
        slots = np.maximum(cols.m_max - cols.used_slots, 0).astype(
            np.int32
        )
        m_rack = cols.m_rack
        has_rack = m_rack >= 0

        def fam(n, s, d, c, k, ti=None, mi=None, ri=None, wt=None,
                dc=None):
            neg1 = np.full(n, -1, np.int32)
            return (
                np.broadcast_to(np.asarray(s, np.int32), (n,)),
                np.broadcast_to(np.asarray(d, np.int32), (n,)),
                np.broadcast_to(np.asarray(c, np.int32), (n,)),
                np.full(n, int(k), np.int8),
                neg1 if ti is None else np.asarray(ti, np.int32),
                neg1 if mi is None else np.asarray(mi, np.int32),
                neg1 if ri is None else np.asarray(ri, np.int32),
                np.zeros(n, np.int32) if wt is None
                else np.asarray(wt, np.int32),
                np.zeros(n, np.int32) if dc is None
                else np.asarray(dc, np.int32),
            )

        families = [
            fam(T, t_nodes, unsched_base + job_of, 1,
                ArcKind.TASK_TO_UNSCHED, ti=t_ids),
            fam(T, t_nodes, CLUSTER, 1, ArcKind.TASK_TO_CLUSTER,
                ti=t_ids),
            fam(int(is_mp.sum()), task_base + p_t[is_mp],
                machine_base + p_m[is_mp], 1, ArcKind.TASK_TO_MACHINE,
                ti=p_t[is_mp], mi=p_m[is_mp], wt=p_w[is_mp],
                dc=p_d[is_mp]),
            fam(int((~is_mp).sum()), task_base + p_t[~is_mp],
                rack_base + p_r[~is_mp], 1, ArcKind.TASK_TO_RACK,
                ti=p_t[~is_mp], ri=p_r[~is_mp], wt=p_w[~is_mp],
                dc=p_d[~is_mp]),
            fam(M, CLUSTER, m_nodes, slots, ArcKind.CLUSTER_TO_MACHINE,
                mi=m_ids),
            fam(int(has_rack.sum()), rack_base + m_rack[has_rack],
                m_nodes[has_rack], slots[has_rack],
                ArcKind.RACK_TO_MACHINE, mi=m_ids[has_rack],
                ri=m_rack[has_rack]),
            fam(M, m_nodes, SINK, slots, ArcKind.MACHINE_TO_SINK,
                mi=m_ids),
            fam(J, unsched_base + np.arange(J, dtype=np.int32), SINK,
                job_task_count.astype(np.int32),
                ArcKind.UNSCHED_TO_SINK),
        ]
        (src, dst, cap, kind, a_task, a_machine, a_rack, a_weight,
         a_discount) = (
            np.concatenate(cols_) for cols_ in zip(*families)
        )

        supply = np.zeros(n_nodes, dtype=np.int64)
        supply[task_base:] = 1
        supply[SINK] = -T

        n_arcs = len(src)
        arrays = {"src": src, "dst": dst, "cap": cap, "supply": supply}
        meta = GraphMeta(
            node_role=node_role,
            arc_kind=kind,
            arc_task=a_task,
            arc_machine=a_machine,
            arc_rack=a_rack,
            arc_weight=a_weight,
            arc_discount=a_discount,
            task_wait=cols.wait,
            task_current=current_m,
            task_node=np.arange(task_base, task_base + T, dtype=np.int32),
            machine_node=np.arange(machine_base, machine_base + M,
                                   dtype=np.int32),
            node_machine=node_machine,
            task_uids=cols.uids.tolist(),
            machine_names=list(cols.machine_names),
            rack_names=list(cols.racks),
            job_ids=cols.jobs.tolist(),
            n_nodes=n_nodes,
            n_arcs=n_arcs,
        )
        return arrays, meta
