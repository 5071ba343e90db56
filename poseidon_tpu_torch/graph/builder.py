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

``IncrementalFlowGraphBuilder`` keeps a live ``BuilderColumns`` and
patches it from O(K) churn events (task add/remove/update/age, slot
deltas) fed by the scheduler bridge, falling back to a full re-extract
on anything it cannot patch (machine-set changes, mid-order pending
re-inserts). Because both paths share ``assemble``, a delta build is
bit-identical to a from-scratch build by construction; the differential
suite in tests/test_torch_incremental.py asserts it anyway.

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

import collections
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


class _DeltaUnsupported(Exception):
    """A buffered churn event the delta path cannot patch exactly."""


class IncrementalFlowGraphBuilder:
    """O(churn) graph maintenance across scheduling rounds.

    The owner (SchedulerBridge) feeds ``note_*`` events as cluster state
    mutates; ``build_arrays`` patches the cached ``BuilderColumns`` and
    re-assembles — O(K) Python work for K churned pods plus vectorized
    numpy over the arrays, instead of the full O(tasks·prefs) object
    walk. Any event outside the patchable set (machine add/remove/
    attribute change, a pod re-entering the pending order mid-sequence,
    pref/job content changes) flips ``note_full_rebuild`` and the next
    build re-extracts from the cluster.

    Copy-on-write discipline: columns are replaced, never mutated in
    place, so arrays referenced by a previous round's ``GraphMeta`` (or
    already shipped to an in-flight solve) stay frozen.

    Self-healing: every delta build verifies the cached pending-uid
    sequence and machine-name list against the live cluster; a mismatch
    (a missed event path) logs a warning and falls back to a full
    rebuild, so a bookkeeping bug degrades to the old cost, never to a
    wrong graph.
    """

    def __init__(
        self,
        *,
        pref_arcs: bool = True,
        rack_aggs: bool = True,
        preemption: bool = False,
        migration_hysteresis: int = 20,
    ):
        self.builder = FlowGraphBuilder(
            pref_arcs=pref_arcs, rack_aggs=rack_aggs,
            preemption=preemption,
            migration_hysteresis=migration_hysteresis,
        )
        self._cols: BuilderColumns | None = None
        self._merged: BuilderColumns | None = None
        self._uid_pos: dict[str, int] = {}
        self._added: dict[str, Task] = {}
        self._removed: set[str] = set()
        self._updated: dict[str, Task] = {}
        self._aged: collections.Counter[str] = collections.Counter()
        self._slot_delta: collections.Counter[str] = collections.Counter()
        # running-block buffers (rebalancing mode)
        self._run_pos: dict[str, int] = {}
        self._run_added: dict[str, Task] = {}
        self._run_removed: set[str] = set()
        self._run_moved: dict[str, str] = {}
        self._run_updated: dict[str, Task] = {}
        self._rebuild: str | None = "cold"
        self.last_build_mode = ""
        self.builds_full = 0
        self.builds_delta = 0

    @property
    def preemption(self) -> bool:
        return self.builder.preemption

    # ---- churn notifications (all O(1)) -------------------------------

    def note_full_rebuild(self, why: str) -> None:
        if self._rebuild is None:
            self._rebuild = why
            self._added.clear()
            self._removed.clear()
            self._updated.clear()
            self._aged.clear()
            self._slot_delta.clear()
            self._run_added.clear()
            self._run_removed.clear()
            self._run_moved.clear()
            self._run_updated.clear()

    def note_task_added(self, task: Task) -> None:
        """A NEW pending pod appended at the end of the pending order."""
        if self._rebuild is not None:
            return
        if task.uid in self._removed or task.uid in self._uid_pos \
                or task.uid in self._added:
            # re-adds / duplicates cannot preserve the canonical order
            self.note_full_rebuild("pending re-insert")
            return
        self._added[task.uid] = task

    def note_task_removed(self, uid: str) -> None:
        """A pod left the pending set (placed, retired, disappeared)."""
        if self._rebuild is not None:
            return
        if uid in self._added:
            del self._added[uid]
            self._aged.pop(uid, None)
            self._updated.pop(uid, None)
            return
        if uid in self._uid_pos:
            self._removed.add(uid)
            self._updated.pop(uid, None)
            return
        self.note_full_rebuild("unknown pending removal")

    def note_task_updated(self, task: Task) -> None:
        """An existing pending pod's cpu/mem request changed in place
        (same uid, same position, same job + prefs)."""
        if self._rebuild is not None:
            return
        if task.uid in self._added:
            self._added[task.uid] = task
        elif task.uid in self._uid_pos:
            self._updated[task.uid] = task
        else:
            self.note_full_rebuild("unknown pending update")

    def note_task_aged(self, uid: str, rounds: int = 1) -> None:
        """A pending pod's wait_rounds grew by ``rounds``."""
        if self._rebuild is not None:
            return
        self._aged[uid] += rounds

    def note_slots_changed(self, machine: str, delta: int) -> None:
        """A machine's RUNNING-task count changed by ``delta``.

        Rebalancing mode ignores slot deltas: running tasks hold their
        seats through their own unit of flow, so capacity stays full.
        """
        if self._rebuild is not None or self.preemption:
            return
        self._slot_delta[machine] += delta

    # ---- running-block notifications (rebalancing mode, all O(1)) -----

    def note_running_added(self, task: Task) -> None:
        """A task entered the RUNNING set (confirm/adoption)."""
        if self._rebuild is not None:
            return
        uid = task.uid
        if uid in self._run_pos or uid in self._run_added \
                or uid in self._run_removed:
            # duplicates / re-adds inside one window would need a
            # remove+insert ordering the sorted merge cannot replay
            self.note_full_rebuild("running re-add")
            return
        if not task.machine:
            self.note_full_rebuild("running add without machine")
            return
        self._run_added[uid] = task

    def note_running_removed(self, uid: str) -> None:
        """A task left the RUNNING set (retired, preempted, evicted)."""
        if self._rebuild is not None:
            return
        if uid in self._run_added:
            del self._run_added[uid]
            self._run_moved.pop(uid, None)
            self._run_updated.pop(uid, None)
            return
        if uid in self._run_pos:
            self._run_removed.add(uid)
            self._run_moved.pop(uid, None)
            self._run_updated.pop(uid, None)
            return
        self.note_full_rebuild("unknown running removal")

    def note_running_moved(self, uid: str, machine: str) -> None:
        """A RUNNING task's machine changed (migration applied)."""
        if self._rebuild is not None:
            return
        if uid in self._run_added:
            self._run_added[uid] = dataclasses.replace(
                self._run_added[uid], machine=machine
            )
        elif uid in self._run_pos and uid not in self._run_removed:
            self._run_moved[uid] = machine
        else:
            self.note_full_rebuild("unknown running move")

    def note_running_updated(self, task: Task) -> None:
        """A RUNNING task's cpu/mem request changed in place (same
        uid, machine, job + prefs)."""
        if self._rebuild is not None:
            return
        uid = task.uid
        if uid in self._run_added:
            self._run_added[uid] = task
        elif uid in self._run_pos and uid not in self._run_removed:
            self._run_updated[uid] = task
        else:
            self.note_full_rebuild("unknown running update")

    # ---- build --------------------------------------------------------

    @property
    def columns(self) -> BuilderColumns | None:
        """The last build's MERGED columns (identical to the patchable
        columns in place-only mode, where the merge is the identity)."""
        return self._merged if self._merged is not None else self._cols

    def cost_columns(self) -> tuple[np.ndarray, np.ndarray]:
        """(task_cpu_milli, task_mem_kb) for the current task order
        (pending, then the running block in rebalancing mode)."""
        cols = self.columns
        assert cols is not None
        return cols.cpu_milli, cols.mem_kb

    def checkpoint_columns(self) -> BuilderColumns | None:
        """The patchable column set, checkpoint-clean (ha/checkpoint
        .py): buffered churn notes are folded in first (the exact
        O(churn) patch the next build would apply — the state machine
        is idempotent, so the next build simply finds nothing pending),
        because a snapshot of half-applied state would prime a restored
        builder with columns the notes never reached. None while a
        full rebuild is pending — there is nothing patchable to save.
        """
        if self._rebuild is not None or self._cols is None:
            return None
        try:
            self._apply_deltas()
        except _DeltaUnsupported as e:
            self.note_full_rebuild(str(e))
            return None
        return self._cols

    def restore_columns(self, cols: BuilderColumns) -> None:
        """Warm-restore priming (ha/checkpoint.py): adopt a
        checkpointed patchable column set as the cached state, so the
        first post-restore build patches O(churn) instead of
        re-extracting the whole cluster. Safe by construction: the
        next ``build_arrays`` runs the same self-heal verify every
        delta build runs — a snapshot that does not match the restored
        cluster degrades to a full rebuild loudly, never to a wrong
        graph."""
        self._cols = cols
        self._merged = None
        self._uid_pos = {
            u: i for i, u in enumerate(cols.uids.tolist())
        }
        self._run_pos = {
            u: i for i, u in enumerate(cols.run_uids.tolist())
        }
        self._added.clear()
        self._removed.clear()
        self._updated.clear()
        self._aged.clear()
        self._slot_delta.clear()
        self._run_added.clear()
        self._run_removed.clear()
        self._run_moved.clear()
        self._run_updated.clear()
        self._rebuild = None

    def build_arrays(
        self,
        cluster: ClusterState,
        pending: list[Task] | None = None,
    ) -> tuple[dict[str, np.ndarray], GraphMeta]:
        if pending is None:
            pending = cluster.pending()
        if self._rebuild is None and self._cols is not None:
            try:
                self._apply_deltas()
            except _DeltaUnsupported as e:
                self.note_full_rebuild(str(e))
        if self._rebuild is None and self._cols is not None:
            cols = self._cols
            # self-healing guard: the pending-uid sequence is the one
            # invariant every patch depends on — verify it in full each
            # build (O(T) C-level compare). Machines change only
            # through observe_nodes, which always notes; the length
            # check catches a bypassing mutation without paying an
            # O(M) name walk per round at 12k machines.
            ok = (
                len(pending) == len(cols.uids)
                and len(cluster.machines) == len(cols.machine_names)
                and [t.uid for t in pending] == cols.uids.tolist()  # noqa: PTA002 -- deliberate O(T) self-heal verify: a missed churn event must degrade to a full rebuild, never a wrong graph (class docstring)
            )
            if ok and self.preemption:
                # the running block is equally load-bearing in
                # rebalancing mode: verify (uid, machine) pairs against
                # the live cluster in canonical (uid-sorted) order
                live = sorted(  # noqa: PTA002 -- deliberate O(T) self-heal verify of the rebalancing running block (same contract as the pending check above)
                    (t.uid, t.machine) for t in cluster.tasks
                    if t.phase == TaskPhase.RUNNING
                    and t.machine in cols.midx
                )
                names = np.array(cols.machine_names, dtype=object)
                ok = len(live) == len(cols.run_uids) and live == list(
                    zip(cols.run_uids.tolist(),
                        names[cols.run_machine].tolist())
                )
            if not ok:
                log.warning(
                    "incremental graph state diverged from the cluster "
                    "(missed churn event?); falling back to full rebuild"
                )
                self.note_full_rebuild("verify-mismatch")
        if self._rebuild is not None:
            self._cols = self.builder.extract_columns(cluster)
            self._uid_pos = {
                u: i for i, u in enumerate(self._cols.uids.tolist())
            }
            self._run_pos = {
                u: i for i, u in enumerate(self._cols.run_uids.tolist())
            }
            self._rebuild = None
            self._added.clear()
            self._removed.clear()
            self._updated.clear()
            self._aged.clear()
            self._slot_delta.clear()
            self._run_added.clear()
            self._run_removed.clear()
            self._run_moved.clear()
            self._run_updated.clear()
            self.last_build_mode = "full"
            self.builds_full += 1
        else:
            self.last_build_mode = "delta"
            self.builds_delta += 1
        self._merged = self.builder.merge_columns(self._cols)
        return self.builder.assemble(self._merged)

    # ---- the O(K) patch ----------------------------------------------

    def _apply_deltas(self) -> None:
        cols = self._cols
        assert cols is not None
        if not (self._added or self._removed or self._updated
                or self._aged or self._slot_delta or self._run_added
                or self._run_removed or self._run_moved
                or self._run_updated):
            return
        uids = cols.uids
        jobs = cols.jobs
        job_idx = cols.job_idx
        job_counts = cols.job_counts
        wait = cols.wait
        pref_counts = cols.pref_counts
        pref_m, pref_r, pref_w = cols.pref_m, cols.pref_r, cols.pref_w
        cpu, mem = cols.cpu_milli, cols.mem_kb
        used_slots = cols.used_slots
        T, J = len(uids), len(jobs)

        if self._updated:
            cpu = cpu.copy()
            mem = mem.copy()
            for uid, t in self._updated.items():
                p = self._uid_pos[uid]
                cpu[p] = int(t.cpu_request * 1000)
                mem[p] = t.memory_request_kb

        if self._aged:
            wait = wait.copy()
            for uid, n in self._aged.items():
                p = self._uid_pos.get(uid)
                if p is None:
                    raise _DeltaUnsupported("aging of unknown task")
                wait[p] += n

        if self._removed:
            pos = np.fromiter(
                (self._uid_pos[u] for u in self._removed),
                np.int64, len(self._removed),
            )
            keep = np.ones(T, bool)
            keep[pos] = False
            pref_keep = np.repeat(keep, pref_counts)
            job_counts = job_counts - np.bincount(
                job_idx[pos], minlength=J
            )
            uids = uids[keep]
            job_idx = job_idx[keep]
            wait = wait[keep]
            cpu = cpu[keep]
            mem = mem[keep]
            pref_counts = pref_counts[keep]
            pref_m = pref_m[pref_keep]
            pref_r = pref_r[pref_keep]
            pref_w = pref_w[pref_keep]
            if (job_counts == 0).any():
                jkeep = job_counts > 0
                remap = (np.cumsum(jkeep) - 1).astype(np.int32)
                job_idx = remap[job_idx]
                jobs = jobs[jkeep]
                job_counts = job_counts[jkeep]
            # canonical job order is first occurrence among pending
            # tasks; removals can promote a later block's job past an
            # earlier one — re-permute to match what a fresh extract
            # would produce
            if len(job_idx):
                _, first = np.unique(job_idx, return_index=True)
                perm = np.argsort(first, kind="stable")
                if not np.array_equal(perm, np.arange(len(perm))):
                    inv = np.empty(len(perm), np.int32)
                    inv[perm] = np.arange(len(perm), dtype=np.int32)
                    job_idx = inv[job_idx]
                    jobs = jobs[perm]
                    job_counts = job_counts[perm]

        if self._added:
            midx = cols.midx
            rack_idx = {r: i for i, r in enumerate(cols.racks)}
            job_lookup = {j: i for i, j in enumerate(jobs.tolist())}
            new_jobs: list[str] = []
            a_job, a_wait, a_cpu, a_mem, a_cnt = [], [], [], [], []
            a_pm, a_pr, a_pw = [], [], []
            for t in self._added.values():
                jid = t.job_id
                ji = job_lookup.get(jid)
                if ji is None:
                    ji = len(job_lookup)
                    job_lookup[jid] = ji
                    new_jobs.append(jid)
                a_job.append(ji)
                a_wait.append(t.wait_rounds)
                a_cpu.append(int(t.cpu_request * 1000))
                a_mem.append(t.memory_request_kb)
                rows = self.builder._task_prefs(t, midx, rack_idx)
                a_cnt.append(len(rows))
                for m, r, w in rows:
                    a_pm.append(m)
                    a_pr.append(r)
                    a_pw.append(w)
            a_job_arr = np.array(a_job, np.int32)
            uids = np.concatenate([
                uids, np.array(list(self._added), dtype=object),
            ])
            job_idx = np.concatenate([job_idx, a_job_arr])
            wait = np.concatenate([wait, np.array(a_wait, np.int32)])
            cpu = np.concatenate([cpu, np.array(a_cpu, np.int64)])
            mem = np.concatenate([mem, np.array(a_mem, np.int64)])
            pref_counts = np.concatenate(
                [pref_counts, np.array(a_cnt, np.int64)]
            )
            pref_m = np.concatenate([pref_m, np.array(a_pm, np.int32)])
            pref_r = np.concatenate([pref_r, np.array(a_pr, np.int32)])
            pref_w = np.concatenate([pref_w, np.array(a_pw, np.int32)])
            if new_jobs:
                jobs = np.concatenate(
                    [jobs, np.array(new_jobs, dtype=object)]
                )
            job_counts = np.bincount(
                a_job_arr, minlength=len(jobs)
            ).astype(np.int64) + np.concatenate([
                job_counts,
                np.zeros(len(jobs) - len(job_counts), np.int64),
            ])

        if self._slot_delta:
            used_slots = used_slots.copy()
            for name, d in self._slot_delta.items():
                i = cols.midx.get(name)
                if i is None:
                    raise _DeltaUnsupported("slot delta on unknown machine")
                used_slots[i] += d
            if (used_slots < 0).any():
                raise _DeltaUnsupported("negative running-slot count")

        # ---- running block (rebalancing mode) -------------------------
        run_uids = cols.run_uids
        run_job = cols.run_job
        run_machine = cols.run_machine
        run_wait = cols.run_wait
        run_cpu = cols.run_cpu
        run_mem = cols.run_mem
        run_pc = cols.run_pref_counts
        run_pm, run_pr, run_pw = (
            cols.run_pref_m, cols.run_pref_r, cols.run_pref_w
        )

        if self._run_moved:
            run_machine = run_machine.copy()
            for uid, name in self._run_moved.items():
                i = cols.midx.get(name)
                if i is None:
                    raise _DeltaUnsupported("move to unknown machine")
                run_machine[self._run_pos[uid]] = i

        if self._run_updated:
            run_cpu = run_cpu.copy()
            run_mem = run_mem.copy()
            for uid, t in self._run_updated.items():
                p = self._run_pos[uid]
                run_cpu[p] = int(t.cpu_request * 1000)
                run_mem[p] = t.memory_request_kb

        if self._run_removed:
            pos = np.fromiter(
                (self._run_pos[u] for u in self._run_removed),
                np.int64, len(self._run_removed),
            )
            keep = np.ones(len(run_uids), bool)
            keep[pos] = False
            pkeep = np.repeat(keep, run_pc)
            run_uids = run_uids[keep]
            run_job = run_job[keep]
            run_machine = run_machine[keep]
            run_wait = run_wait[keep]
            run_cpu = run_cpu[keep]
            run_mem = run_mem[keep]
            run_pc = run_pc[keep]
            run_pm = run_pm[pkeep]
            run_pr = run_pr[pkeep]
            run_pw = run_pw[pkeep]

        if self._run_added:
            midx = cols.midx
            rack_idx = {r: i for i, r in enumerate(cols.racks)}
            add = sorted(self._run_added.values(), key=lambda t: t.uid)
            if any(t.machine not in midx for t in add):
                raise _DeltaUnsupported("running add on unknown machine")
            per = [
                self.builder._task_prefs(t, midx, rack_idx) for t in add
            ]
            trip = [row for rows in per for row in rows]
            a_pc = np.array([len(rows) for rows in per], np.int64)
            # merge-sort the sorted additions into the uid-sorted block
            all_uids = np.concatenate([
                run_uids, np.array([t.uid for t in add], dtype=object),
            ])
            order = np.argsort(all_uids, kind="stable")
            counts_all = np.concatenate([run_pc, a_pc])
            new_counts = counts_all[order]
            tot = int(counts_all.sum())
            pm_all = np.concatenate(
                [run_pm, np.array([x[0] for x in trip], np.int32)]
            )
            pr_all = np.concatenate(
                [run_pr, np.array([x[1] for x in trip], np.int32)]
            )
            pw_all = np.concatenate(
                [run_pw, np.array([x[2] for x in trip], np.int32)]
            )
            if tot:
                starts = np.zeros(len(counts_all), np.int64)
                starts[1:] = np.cumsum(counts_all)[:-1]
                new_starts = np.zeros(len(new_counts), np.int64)
                new_starts[1:] = np.cumsum(new_counts)[:-1]
                gather = np.repeat(
                    starts[order] - new_starts, new_counts
                ) + np.arange(tot)
                pm_all = pm_all[gather]
                pr_all = pr_all[gather]
                pw_all = pw_all[gather]
            run_uids = all_uids[order]
            run_job = np.concatenate([
                run_job, np.array([t.job_id for t in add], dtype=object),
            ])[order]
            run_machine = np.concatenate([
                run_machine,
                np.array([midx[t.machine] for t in add], np.int32),
            ])[order]
            run_wait = np.concatenate([
                run_wait,
                np.array([t.wait_rounds for t in add], np.int32),
            ])[order]
            run_cpu = np.concatenate([
                run_cpu,
                np.array(
                    [int(t.cpu_request * 1000) for t in add], np.int64
                ),
            ])[order]
            run_mem = np.concatenate([
                run_mem,
                np.array(
                    [t.memory_request_kb for t in add], np.int64
                ),
            ])[order]
            run_pc = new_counts
            run_pm, run_pr, run_pw = pm_all, pr_all, pw_all

        self._cols = dataclasses.replace(
            cols, uids=uids, jobs=jobs, job_idx=job_idx,
            job_counts=job_counts, wait=wait, pref_counts=pref_counts,
            pref_m=pref_m, pref_r=pref_r, pref_w=pref_w,
            cpu_milli=cpu, mem_kb=mem, used_slots=used_slots,
            run_uids=run_uids, run_job=run_job, run_machine=run_machine,
            run_wait=run_wait, run_cpu=run_cpu, run_mem=run_mem,
            run_pref_counts=run_pc, run_pref_m=run_pm,
            run_pref_r=run_pr, run_pref_w=run_pw,
        )
        if self._removed:
            self._uid_pos = {
                u: i for i, u in enumerate(uids.tolist())
            }
        elif self._added:
            base = len(self._uid_pos)
            for k, uid in enumerate(self._added):
                self._uid_pos[uid] = base + k
        if self._run_removed or self._run_added:
            self._run_pos = {
                u: i for i, u in enumerate(run_uids.tolist())
            }
        self._added.clear()
        self._removed.clear()
        self._updated.clear()
        self._aged.clear()
        self._slot_delta.clear()
        self._run_added.clear()
        self._run_removed.clear()
        self._run_moved.clear()
        self._run_updated.clear()
