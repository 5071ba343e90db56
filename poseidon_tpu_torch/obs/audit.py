"""Shadow audit: measured placement quality, strictly off the hot path.

The port of ``poseidon_tpu/obs/audit.py``. The quality question nothing answered before this module: the round
solve is certified exact *for the instance it was given*, but the
CLUSTER drifts between and around those instances — place-only
placements go stale as load moves, express repairs promise only
optimal-within-hysteresis, aggregation/top-k are stated
approximations, and deferred migrations park improvements behind the
churn budget. The correction pass's implicit promise ("any remaining
per-pod gap is under the hysteresis") was never a measured number.

``ShadowAuditor`` makes it one. On a sampled cadence the bridge
captures a host snapshot of the live cluster (machines, tasks, the
KnowledgeBase pricing aggregates — the flight-recorder capture style:
list/array copies on the loop thread, no device traffic) and a
background worker re-solves it from scratch:

- build a REBALANCING-mode graph over the snapshot's RUNNING tasks
  (every one gets its continuation arc at the bridge's own
  hysteresis, so the audit measures exactly the promise the
  correction pass makes). Pending pods are deliberately OUT of the
  audit instance: their story is the wait-age distribution
  (obs/lifecycle.py) and the per-pod unscheduled diagnosis
  (obs/explain.py) — folding them in would make regret oscillate
  with the aging-pressure lag between rounds (a parked pod's
  unsched price rises every round, so the state decided under LAST
  round's prices always trails an optimum priced with this round's)
  instead of measuring placement quality;
- price it with the registry cost model on the CPU, by an explicit
  ``device="cpu"`` (a stated design, not a fallback): the audit
  thread never launches on, or synchronises, the card's streams, so
  it cannot contend with an in-flight round between dispatch and
  fetch;
- solve it exactly on the subprocess oracle via the host DIMACS path
  (``oracle.solve_dimacs`` — no ``FlowNetwork``, no tensors on the
  card);
- price the STATUS QUO (every task where it actually is,
  ``transport.assignment_cost``) over the same instance.

Published per audit (``poseidon_audit_*`` gauges + the SLO engine's
``regret`` source):

- **regret** = status-quo cost − certified optimum: bit-zero on a
  settled steady state, measurably positive the moment drift /
  aggregation / express repair / budget deferral has cost anything
  beyond the stated hysteresis bound;
- **drift pods**: placements that differ from the audit optimum
  (informational — ties make this noisier than regret);
- **fragmentation index**: per machine-SKU class, the largest
  schedulable gang slot (max free seats on any single machine of the
  class) — the "could a k-gang still land anywhere" capacity surface;
- audit wall time and failure count.

Thread discipline: the capture runs on the loop thread and hands the
immutable snapshot through a bounded ``queue.Queue``; results and
counters are written under ``_lock`` on the worker and read under it
from the loop/scrape side. The capture reads host data only (no device
syncs) — like the checkpoint capture it is deliberately NOT an
O(churn) scope: the amortized-cadence O(cluster) list copy is its
documented design.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time

import numpy as np

log = logging.getLogger(__name__)

# default sampling cadence (rounds between captures); the daemon
# overrides it via --audit_every
AUDIT_EVERY_DEFAULT = 16

# bounded SKU-class label cardinality for the fragmentation gauge:
# classes beyond this fold into "other" (a heterogeneous fleet has a
# handful of SKUs; a metrics label must not scale with machine count)
MAX_SKU_CLASSES = 8


@dataclasses.dataclass
class AuditSnapshot:
    """One sampled capture of the live cluster (loop thread; every
    field is an owned copy — the worker never touches bridge state)."""

    round_num: int
    cost_model: str
    hysteresis: int
    machines: list                 # Machine dataclasses (immutable)
    tasks: list                    # Task dataclasses (immutable)
    # KnowledgeBase aggregates in snapshot order (uids/names below)
    uids: list
    names: list
    task_usage: np.ndarray
    machine_load: np.ndarray
    machine_mem_free: np.ndarray


@dataclasses.dataclass
class AuditResult:
    """One completed audit."""

    round_num: int
    status_quo_cost: int = 0
    optimal_cost: int = 0
    regret: int = 0
    drift_pods: int = 0
    frag_slots: dict = dataclasses.field(default_factory=dict)
    audit_ms: float = 0.0
    error: str = ""


class ShadowAuditor:
    """Sampled background re-solve of the live placement's quality.

    ``background=False`` (tests, determinism) skips the worker
    thread; ``run_pending()`` then processes captures inline.
    """

    def __init__(
        self,
        *,
        metrics=None,
        sample_every: int = AUDIT_EVERY_DEFAULT,
        background: bool = True,
        oracle_timeout_s: float = 120.0,
    ):
        self.metrics = metrics
        self.sample_every = max(int(sample_every), 1)
        self.oracle_timeout_s = oracle_timeout_s
        self._lock = threading.Lock()
        # bounded handoff: if the worker is still chewing on the last
        # snapshot, the next capture is simply skipped (counted) —
        # the audit is a sample, not a log
        self._q: queue.Queue[AuditSnapshot | None] = queue.Queue(
            maxsize=2
        )
        self.last: AuditResult | None = None
        self.completed = 0
        self.failures = 0
        self.skipped = 0
        # grow-only padding floors for the CPU pricing (shared with
        # prewarm under _lock): every audit's slightly different
        # task/arc counts pad to one bucketed shape, as the
        # reference's do
        self._t_floor = 16
        self._m_floor = 16
        self._e_floor = 256
        self._thread: threading.Thread | None = None
        if background:
            self._thread = threading.Thread(
                target=self._worker, name="shadow-audit", daemon=True
            )
            self._thread.start()

    # ---- the loop-thread side ------------------------------------------

    def prewarm(
        self, *, tasks: int, machines: int, arcs: int = 0
    ) -> None:
        """Pin the pricing-shape floors ahead of growth.

        The floors are grow-only either way; pinning them to the
        cluster's expected bounds up front keeps the worker's pricing
        at ONE padded shape from the first sample instead of one per
        bucket crossing while a ramping cluster grows through them.
        ``arcs`` defaults to a generous rebalancing-mode estimate
        from the task/machine counts."""
        from poseidon_tpu_torch.graph.network import pad_bucket

        if not arcs:
            arcs = tasks * 8 + machines * 4
        with self._lock:  # the worker grows the same floors
            self._t_floor = pad_bucket(
                max(tasks, 1), minimum=self._t_floor
            )
            self._m_floor = pad_bucket(
                max(machines, 1), minimum=self._m_floor
            )
            self._e_floor = pad_bucket(
                max(arcs, 1), minimum=self._e_floor
            )

    def due(self, round_num: int) -> bool:
        """Is this round a sample? (the bridge's cadence gate)."""
        return round_num % self.sample_every == 0

    def capture(
        self,
        *,
        round_num: int,
        cost_model: str,
        hysteresis: int,
        machines: dict,
        tasks: dict,
        knowledge,
    ) -> bool:
        """Snapshot the live cluster for the worker (loop thread —
        list/array copies of host data only, no device reads; the
        O(cluster) copy amortizes over the sampling cadence exactly
        like the checkpoint capture). Returns False when the worker is
        still busy with the previous sample (capture skipped)."""
        from poseidon_tpu_torch.cluster import TaskPhase

        # the audit instance is the RUNNING placement (module
        # docstring: pending pods' story is wait-age + diagnosis)
        running = [
            t for t in tasks.values()
            if t.phase == TaskPhase.RUNNING and t.machine in machines
        ]
        if not running:
            return False
        uids = [t.uid for t in running]
        names = list(machines.keys())
        snap = AuditSnapshot(
            round_num=round_num,
            cost_model=cost_model,
            hysteresis=int(hysteresis),
            machines=list(machines.values()),
            tasks=running,
            uids=uids,
            names=names,
            task_usage=np.array(knowledge.task_cpu_usage(uids)),
            machine_load=np.array(knowledge.machine_load(names)),
            machine_mem_free=np.array(
                knowledge.machine_mem_free(names)
            ),
        )
        try:
            self._q.put_nowait(snap)
            return True
        except queue.Full:
            with self._lock:
                self.skipped += 1
            return False

    def stop(self) -> None:
        """Stop the worker (daemon close path) WITHOUT stalling:
        pending snapshots are discarded (a shutdown does not owe the
        queue an audit), and a worker stuck in a long oracle solve is
        abandoned to its daemon-thread fate after the join timeout —
        a blocking ``put`` on the bounded queue here could hold the
        SIGTERM path for a whole oracle timeout."""
        if self._thread is None:
            return
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # worker mid-pop refilled nothing; it will re-block
        self._thread.join(timeout=10.0)
        self._thread = None

    def run_pending(self) -> AuditResult | None:
        """Synchronous mode: process every queued capture inline
        (tests, determinism; returns the last result)."""
        out = None
        while True:
            try:
                snap = self._q.get_nowait()
            except queue.Empty:
                return out
            if snap is not None:
                out = self._process(snap)

    # ---- the worker ----------------------------------------------------

    def _worker(self) -> None:  # pta: background-thread
        while True:
            snap = self._q.get()
            if snap is None:
                return
            self._process(snap)

    def _process(self, snap: AuditSnapshot) -> AuditResult:
        t0 = time.perf_counter()
        try:
            res = self._audit(snap)
        except Exception as e:  # never crash the daemon for an audit
            log.exception("shadow audit failed (round %d)",
                          snap.round_num)
            res = AuditResult(round_num=snap.round_num, error=str(e))
        res.audit_ms = (time.perf_counter() - t0) * 1000
        with self._lock:
            self.last = res
            if res.error:
                self.failures += 1
            else:
                self.completed += 1
        if self.metrics is not None:
            self.metrics.record_audit(res)
        return res

    def _audit(self, snap: AuditSnapshot) -> AuditResult:
        """The actual re-solve: host numpy + CPU pricing + the
        subprocess oracle. Never a launch on the card."""
        from poseidon_tpu_torch.cluster import ClusterState
        from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
        from poseidon_tpu_torch.graph.decompose import extract_placements
        from poseidon_tpu_torch.graph.dimacs import write_dimacs_host
        from poseidon_tpu_torch.models.costs import build_cost_inputs_host
        from poseidon_tpu_torch.oracle import solve_dimacs
        from poseidon_tpu_torch.ops.transport import (
            assignment_cost,
            extract_topology,
            instance_from_topology,
        )

        cluster = ClusterState(
            machines=snap.machines, tasks=snap.tasks
        )
        # rebalancing-mode graph at the bridge's OWN hysteresis: the
        # audit measures the correction pass's stated promise, not a
        # stricter one it never made
        fb = FlowGraphBuilder(
            preemption=True, migration_hysteresis=snap.hysteresis
        )
        cols = fb.merge_columns(fb.extract_columns(cluster))
        arrays, meta = fb.assemble(cols)
        # the pricing aggregates, re-ordered from the snapshot's
        # capture order onto the build's canonical order
        usage = dict(zip(snap.uids, snap.task_usage))
        load = dict(zip(snap.names, snap.machine_load))
        memf = dict(zip(snap.names, snap.machine_mem_free))
        cur = cols.current_m
        used = (
            np.bincount(
                cur[cur >= 0], minlength=len(meta.machine_names)
            ).astype(np.int32)
            if cur is not None
            else np.zeros(len(meta.machine_names), np.int32)
        )
        from poseidon_tpu_torch.graph.network import pad_bucket

        # pricing shapes ride grow-only bucketed floors (the solver's
        # idiom): one padded shape per bucket, not one per audit. The
        # lock covers the race with a loop-thread prewarm().
        with self._lock:
            self._e_floor = pad_bucket(
                meta.n_arcs, minimum=self._e_floor
            )
            self._t_floor = pad_bucket(
                len(meta.task_uids), minimum=self._t_floor
            )
            self._m_floor = pad_bucket(
                len(meta.machine_names), minimum=self._m_floor
            )
            e_floor, t_floor, m_floor = (
                self._e_floor, self._t_floor, self._m_floor
            )
        inputs = build_cost_inputs_host(
            e_floor, meta,
            t_min=t_floor,
            m_min=m_floor,
            task_cpu_milli=cols.cpu_milli,
            task_mem_kb=cols.mem_kb,
            task_usage=np.array(
                [usage[u] for u in meta.task_uids]
            ),
            machine_load=np.array(
                [load[n] for n in meta.machine_names]
            ),
            machine_mem_free=np.array(
                [memf[n] for n in meta.machine_names]
            ),
            machine_used_slots=used,
        )
        cost = _price_on_cpu(snap.cost_model, inputs, meta.n_arcs)
        topo = extract_topology(
            meta, arrays["src"], arrays["dst"], arrays["cap"]
        )
        inst = instance_from_topology(topo, cost)
        sq = assignment_cost(inst, meta.task_current)
        text = write_dimacs_host(
            arrays["src"], arrays["dst"], arrays["cap"], cost,
            arrays["supply"], meta.n_nodes, meta.n_arcs,
        )
        o = solve_dimacs(
            text, meta.n_arcs, algorithm="cost_scaling",
            timeout_s=self.oracle_timeout_s,
        )
        placements = extract_placements(
            np.asarray(o.flows, np.int64), meta,
            arrays["src"], arrays["dst"],
        )
        names = meta.machine_names
        drift = sum(
            1 for i, uid in enumerate(meta.task_uids)
            if int(meta.task_current[i]) >= 0
            and placements.get(uid)
            != names[int(meta.task_current[i])]
        )
        return AuditResult(
            round_num=snap.round_num,
            status_quo_cost=int(sq),
            optimal_cost=int(o.cost),
            regret=int(sq) - int(o.cost),
            drift_pods=int(drift),
            frag_slots=fragmentation_index(snap),
        )


def _price_on_cpu(
    cost_model: str, inputs, n_arcs: int
) -> np.ndarray:
    """Run the registry cost model on the CPU, by an explicit
    ``device="cpu"``: the audit's pricing runs on host cores and never
    launches on, or synchronises, the card the round owns (the same
    priced table either way: the models are bit-identical on both)."""
    from poseidon_tpu_torch.models import get_cost_model

    out = get_cost_model(cost_model)(inputs.to_device("cpu"))
    return out.numpy().astype(np.int32)[:n_arcs]


def fragmentation_index(snap: AuditSnapshot) -> dict[str, int]:
    """Largest schedulable gang slot per machine-SKU class.

    SKU class = (cpu capacity, memory capacity, max_tasks), labeled
    by CONTENT (``8c-16g-12s``) so the label's meaning can never be
    silently remapped by fleet churn (a positional ``sku0``/``sku1``
    scheme renumbers every class the moment a new SKU sorts first).
    The value is the MAX free seat count on any single machine of the
    class — the biggest all-on-one-machine gang that could still land
    there. Only the ``MAX_SKU_CLASSES`` most-populous classes keep
    their own label; the tail folds into ``"other"`` (label
    cardinality stays bounded on any fleet)."""
    used: dict[str, int] = {}
    for t in snap.tasks:
        if t.machine:
            used[t.machine] = used.get(t.machine, 0) + 1
    largest: dict[tuple, int] = {}
    members: dict[tuple, int] = {}
    for m in snap.machines:
        key = (m.cpu_capacity, m.memory_capacity_kb, m.max_tasks)
        free = max(int(m.max_tasks) - used.get(m.name, 0), 0)
        if free > largest.get(key, -1):
            largest[key] = free
        members[key] = members.get(key, 0) + 1
    keep = sorted(
        largest, key=lambda k: (-members[k], k)
    )[:MAX_SKU_CLASSES]
    out: dict[str, int] = {}
    for key in sorted(largest):
        cpu, mem_kb, slots = key
        label = (
            f"{cpu:g}c-{int(mem_kb) >> 20}g-{int(slots)}s"
            if key in keep else "other"
        )
        out[label] = max(out.get(label, 0), largest[key])
    return out
