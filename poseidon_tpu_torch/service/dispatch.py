"""Shape-bucket router + batch dispatcher: N tenants, one device.

The port of ``poseidon_tpu/service/dispatch.py``, the solver seam of the
multi-tenant service (``service/service.py`` is the front door). Each
tenant's ``SchedulerBridge`` talks to a ``TenantSolver`` — the same
``begin_round``/``finish_round`` surface as ``ResidentSolver`` — but
begin registers the tenant's priced instance with the shared
``BatchDispatcher`` instead of dispatching it alone. At launch, queued
instances group into shape buckets keyed by their padded (Tp, Mp, P)
dims (each tenant pads to its OWN grow-only floors —
``ops/resident.TenantWarmPool`` — so a tenant's in-bucket solve is the
same function as its solo solve), and each bucket chunk is ONE upload
of the stacked channel tables, the members' solves (K1 on each member's
slice, then the auction with K2/K3) on a background worker, and ONE
batched fetch at the end of that worker.

Pricing runs on the host, on CPU tensors (the reference prices on its
CPU backend): the cost models are O(arcs) elementwise, and the CPU and
the card price every model identically. The chunk's batched fetch is
the dispatch's one result read; the members' auction loops read their
flags as every solve of the port does (counted in ``loop_syncs``).

Per-tenant exactness: a member's bucketed solve equals its solo solve
bit for bit; an uncertified warm solve retries cold, and anything past
that degrades LOUDLY to the C++ oracle for that tenant alone.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from poseidon_tpu_torch.graph.builder import GraphMeta
from poseidon_tpu_torch.graph.network import FlowNetwork, pad_bucket
from poseidon_tpu_torch.guards import CompileCounter, FetchTimeout, SyncCounter
from poseidon_tpu_torch.models.costs import build_cost_inputs_host, get_cost_model
from poseidon_tpu_torch.ops.batch import (
    _solve_member,
    build_member_tables,
    member_bucket_dims,
    stack_members,
    upload_members,
)
from poseidon_tpu_torch.ops.dense_auction import (
    I32,
    I64,
    CostDomainTooLarge,
    DenseMemoryTooLarge,
    DenseState,
    TableSlots,
    _channels_for,
    check_table_budget,
    default_fuse,
    max_variants_for,
    member_side_ints,
)
from poseidon_tpu_torch.ops.resident import (
    ResidentOutcome,
    TenantWarmPool,
    _AsyncFetch,
    on_device,
    resolve_device,
)
from poseidon_tpu_torch.ops.transport import (
    NotSchedulingShaped,
    TransportTopology,
    extract_topology,
    instance_from_topology,
)

log = logging.getLogger(__name__)

_CPU = torch.device("cpu")


# Budget accounting: each bucket member is charged its dense table plus
# TWICE its channel side tables (the batch-axis padding to a grow-only
# pad_bucket width is at most 2x the live member count, and padding
# slots carry channel tables only).
def _budget_side_ints(Tp: int, Mp: int, P: int) -> int:
    return 2 * member_side_ints(Tp, Mp, P)


@dataclasses.dataclass
class PendingSolve:
    """One tenant's registered-but-not-yet-dispatched round solve,
    returned by ``TenantSolver.begin_round`` and consumed by
    ``finish_round``. Degrade paths resolve synchronously and carry
    ``outcome`` directly."""

    tenant: str = ""
    outcome: ResidentOutcome | None = None
    inst: object = None              # TransportInstance
    meta: GraphMeta | None = None
    topo: TransportTopology | None = None
    arrays: dict | None = None
    cost_host: np.ndarray | None = None
    tables: dict | None = None       # padded host channel tables
    T: int = 0
    n_machines: int = 0
    Tp: int = 0
    Mp: int = 0
    P: int = 0
    smax: int = 1
    warm: DenseState | None = None
    warm_used: bool = False
    chunk: object = None             # _Chunk, set at launch
    slot: int = -1
    timings: dict = dataclasses.field(default_factory=dict)
    consumed: bool = False


@dataclasses.dataclass
class _Chunk:
    """One launched bucket chunk: the stacked device tables and the
    background worker that solves the members and makes the one
    batched fetch."""

    key: tuple
    members: list
    stacked: object = None           # upload_members output
    future: _AsyncFetch | None = None
    smax: int = 1
    t_dispatch: float = 0.0
    # set when the chunk's fetch missed its deadline: later members
    # fail fast instead of each re-waiting on the same dead worker
    failed: bool = False


class TenantSolver:
    """The ResidentSolver-shaped seam one tenant's bridge drives.

    ``begin_round`` prices the tenant's graph on the host, compacts it
    to transportation form and registers it with the shared dispatcher;
    ``finish_round`` joins the bucket's batched fetch and completes this
    tenant's round (certificate check, cold retry, warm commit, oracle
    degrade). ``last_instance`` / ``last_assignment`` / ``last_cost_host``
    keep the last round's exact solver inputs and output."""

    def __init__(self, tenant_id: str, dispatcher: "BatchDispatcher"):
        self.tenant_id = tenant_id
        self.dispatcher = dispatcher
        # bridge-compat surface (the bridge reads/sets these)
        self.fetch_timeouts = 0
        self.oracle_timeout_s = dispatcher.oracle_timeout_s
        self.express_fetches = 0
        self.last_instance = None
        self.last_assignment = None
        self.last_cost_host = None
        self.last_arrays = None
        self.last_meta = None
        self.last_backend = ""

    # ---- bridge-compat stubs (the service has no express lane) ----

    @property
    def express_ready(self) -> bool:
        return False

    def invalidate_express(self) -> None:
        pass

    @property
    def warm(self):
        return self.dispatcher.pool.context(self.tenant_id).state

    def reset(self) -> None:
        self.dispatcher.pool.invalidate(self.tenant_id)

    # ---- the round ----------------------------------------------------

    def begin_round(
        self,
        arrays: dict[str, np.ndarray],
        meta: GraphMeta,
        *,
        cost_model: str,
        cost_input_kwargs: dict | None = None,
        topology: TransportTopology | None = None,
    ) -> PendingSolve:
        """Price + compact + register one tenant round with the shared
        dispatcher. The batched dispatch happens at the service's next
        ``launch()`` (or on this tenant's ``finish_round``: the serial
        one-tenant case)."""
        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        ctx = self.dispatcher.pool.context(self.tenant_id)
        topo = topology
        if topo is None:
            try:
                topo = extract_topology(
                    meta, arrays["src"], arrays["dst"], arrays["cap"]
                )
            except NotSchedulingShaped:
                topo = None
        # ---- price on the host (CPU tensors, O(arcs) elementwise) ----
        ctx.e_floor = pad_bucket(max(meta.n_arcs, 1), minimum=ctx.e_floor)
        ctx.ti_floor = pad_bucket(
            max(len(meta.task_uids), 1), minimum=ctx.ti_floor
        )
        ctx.mi_floor = pad_bucket(
            max(len(meta.machine_names), 1), minimum=ctx.mi_floor
        )
        inputs_host = build_cost_inputs_host(
            ctx.e_floor, meta, t_min=ctx.ti_floor, m_min=ctx.mi_floor,
            **(cost_input_kwargs or {}),
        )
        cost = get_cost_model(cost_model)(inputs_host.to_device(_CPU))
        cost_host = cost.numpy().astype(np.int32)[: meta.n_arcs]
        timings["prep_ms"] = (time.perf_counter() - t0) * 1000
        self.last_cost_host = cost_host
        self.last_arrays = arrays
        self.last_meta = meta
        if topo is None:
            # non-taxonomy graph: the transportation form does not apply
            # — solve this tenant on the oracle now
            return PendingSolve(
                tenant=self.tenant_id,
                outcome=self._oracle_outcome(
                    arrays, meta, None, cost_host, timings,
                    why="not-scheduling-shaped",
                ),
            )
        inst = instance_from_topology(topo, cost_host)
        self.last_instance = inst
        return self.dispatcher.register(
            self, inst, arrays, meta, topo, cost_host, timings
        )

    def finish_round(self, pending: PendingSolve) -> ResidentOutcome:
        """Join this tenant's slice of the batched fetch and complete
        the round. Launches the dispatcher first if the wave was never
        launched (the serial path)."""
        if pending.outcome is not None:
            pending.consumed = True
            self.last_backend = pending.outcome.backend
            return pending.outcome
        self.dispatcher.ensure_launched(pending)
        out = self.dispatcher.finish(self, pending)
        self.last_backend = out.backend
        return out

    def discard_round(self, pending: PendingSolve) -> None:
        """Join and drop (driver error path): waits out the chunk's
        worker; warm state is left as it was."""
        if pending.outcome is not None or pending.consumed:
            return
        pending.consumed = True
        chunk = pending.chunk
        if chunk is None or chunk.future is None or chunk.failed:
            return
        try:
            chunk.future.result(timeout_s=self.dispatcher.oracle_timeout_s)
        except FetchTimeout:
            chunk.failed = True
            self.fetch_timeouts += 1
            log.error(
                "discard_round(%s): abandoning a batched fetch still "
                "pending", self.tenant_id,
            )
        except Exception:
            log.exception(
                "discard_round(%s): in-flight fetch failed",
                self.tenant_id,
            )

    def _oracle_outcome(
        self, arrays, meta, topo, cost_host, timings, *, why: str
    ) -> ResidentOutcome:
        """Degrade ONE tenant's round to the C++ oracle (the host costs
        are already in hand)."""
        from poseidon_tpu_torch.graph.decompose import extract_placements
        from poseidon_tpu_torch.oracle import solve_oracle

        t0 = time.perf_counter()
        net = FlowNetwork.from_arrays(
            arrays["src"], arrays["dst"], arrays["cap"], cost_host,
            arrays["supply"],
        )
        o = solve_oracle(
            net, algorithm="cost_scaling", timeout_s=self.oracle_timeout_s,
        )
        placements = extract_placements(
            np.asarray(o.flows, np.int64), meta,
            arrays["src"], arrays["dst"],
        )
        T = len(meta.task_uids)
        midx = {name: i for i, name in enumerate(meta.machine_names)}
        asg = np.full(T, -1, np.int32)
        for i, uid in enumerate(meta.task_uids):
            m = placements.get(uid)
            if m is not None:
                asg[i] = midx[m]
        if topo is not None:
            channel = _channels_for(
                instance_from_topology(topo, cost_host), asg
            )
        else:
            channel = np.full(T, -1, np.int32)
        timings["oracle_ms"] = (time.perf_counter() - t0) * 1000
        self.last_assignment = asg
        return ResidentOutcome(
            assignment=asg,
            channel=channel,
            cost=int(o.cost),
            backend=f"oracle:{why}",
            converged=True,
            rounds=0,
            phases=0,
            topology=topo,
            timings=timings,
        )


class BatchDispatcher:
    """Groups registered tenant solves into shape buckets and solves
    each bucket chunk as one upload, the members' solves and one batched
    fetch.

    Single-threaded by contract (the service pump thread owns it); the
    cross-thread structures are each chunk's worker and its result.
    Chunk workers run one after another on the device, in launch order.
    ``max_batch`` bounds instances per chunk on top of the memory
    budget's own fit (``max_variants_for``)."""

    def __init__(
        self,
        *,
        alpha: int = 1024,
        max_rounds: int | None = None,
        oracle_fallback: bool = True,
        oracle_timeout_s: float = 1000.0,
        max_batch: int = 64,
        metrics=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.alpha = alpha
        self.max_rounds = (
            max_rounds if max_rounds is not None else default_fuse()
        )
        self.oracle_fallback = oracle_fallback
        self.oracle_timeout_s = oracle_timeout_s
        self.max_batch = max(max_batch, 1)
        self.metrics = metrics
        self.pool = TenantWarmPool()
        self._queue: list[PendingSolve] = []
        # grow-only per-bucket floors: batch-axis width and smax, so a
        # churning tenant count or free-slot high-water keeps one shape
        self._b_floor: dict[tuple, int] = {}
        self._smax_floor: dict[tuple, int] = {}
        # the previous chunk's worker: the next one starts after it
        self._last_done: threading.Event | None = None
        # lifetime dispatches, the last launch's builds (0 in steady
        # state), the cold retries of stale warm starts, the chunks'
        # result fetches (one a chunk, one more per cold retry) and the
        # members' auction-loop reads
        self.dispatches = 0
        self.last_launch_compiles = 0
        self.cold_retries = 0
        self.fetches = SyncCounter()
        self.loop_syncs = SyncCounter()
        # the members' tables at fixed addresses, one a bucket shape:
        # the members solve in turn, so each keeps its loop graph
        self._tables = TableSlots()

    # ---- registration --------------------------------------------------

    def register(
        self, solver: TenantSolver, inst, arrays, meta, topo,
        cost_host, timings,
    ) -> PendingSolve:
        ctx = self.pool.context(solver.tenant_id)
        Tp, Mp, P = member_bucket_dims(
            inst, t_min=ctx.t_floor, m_min=ctx.m_floor, p_min=ctx.p_floor,
        )
        try:
            check_table_budget(
                Tp, Mp, 1,
                side_ints_per_variant=_budget_side_ints(Tp, Mp, P),
            )
            tables = build_member_tables(inst, Tp, Mp, P)
        except DenseMemoryTooLarge as e:
            # this tenant alone exceeds the budget: degrade it (and reset
            # its floors — a floor raised by a past larger cluster must
            # not re-pad a fitting instance over budget forever)
            self.pool.reset_floors(solver.tenant_id)
            if not self.oracle_fallback:
                raise
            log.warning(
                "tenant %s exceeds the dense memory budget (%s); "
                "degrading to oracle", solver.tenant_id, e,
            )
            return PendingSolve(
                tenant=solver.tenant_id,
                outcome=solver._oracle_outcome(
                    arrays, meta, topo, cost_host, timings,
                    why="memory-envelope",
                ),
            )
        except (CostDomainTooLarge, ValueError) as e:
            if not self.oracle_fallback:
                raise
            log.warning(
                "tenant %s rejected by the dense kernel (%s); "
                "degrading to oracle", solver.tenant_id, e,
            )
            return PendingSolve(
                tenant=solver.tenant_id,
                outcome=solver._oracle_outcome(
                    arrays, meta, topo, cost_host, timings,
                    why="cost-domain",
                ),
            )
        ctx.t_floor, ctx.m_floor, ctx.p_floor = Tp, Mp, P
        ctx.s_floor = pad_bucket(
            max(int(inst.slots.max(initial=1)), 1), minimum=ctx.s_floor
        )
        pending = PendingSolve(
            tenant=solver.tenant_id, inst=inst, meta=meta, topo=topo,
            arrays=arrays, cost_host=cost_host, tables=tables,
            T=inst.n_tasks, n_machines=inst.n_machines,
            Tp=Tp, Mp=Mp, P=P, smax=min(ctx.s_floor, Tp),
            warm=self.pool.warm(solver.tenant_id, Tp, Mp),
            timings=timings,
        )
        pending.warm_used = pending.warm is not None
        self._queue.append(pending)
        return pending

    def ensure_launched(self, pending: PendingSolve) -> None:
        if pending.chunk is None and pending.outcome is None:
            self.launch()

    # ---- launch: bucket, stack, upload, dispatch -----------------------

    def launch(self) -> int:
        """Dispatch every registered solve: group by (Tp, Mp, P) shape
        bucket, chunk against the memory budget and ``max_batch``, and
        for each chunk do ONE upload and start its worker (the members'
        solves, then ONE batched fetch). Returns the number of chunks."""
        queue, self._queue = self._queue, []
        if not queue:
            return 0
        buckets: dict[tuple, list[PendingSolve]] = {}
        for p in queue:
            buckets.setdefault((p.Tp, p.Mp, p.P), []).append(p)
        n_chunks = 0
        counter = CompileCounter()
        with counter:
            for key, members in sorted(buckets.items()):
                Tp, Mp, P = key
                fit = max_variants_for(
                    Tp, Mp,
                    side_ints_per_variant=_budget_side_ints(Tp, Mp, P),
                )
                width = max(min(self.max_batch, fit), 1)
                for i in range(0, len(members), width):
                    self._dispatch_chunk(key, members[i: i + width])
                    n_chunks += 1
        self.last_launch_compiles = counter.count
        if self.metrics is not None:
            self.metrics.record_service_compiles(counter.count)
        return n_chunks

    def _dispatch_chunk(self, key: tuple, members: list) -> None:
        """ONE upload of the chunk's stacked member tables, then a
        worker that solves the members in order and makes the chunk's
        ONE batched fetch."""
        Tp, Mp, P = key
        # grow-only batch-axis bucket and smax: one shape per bucket as
        # the tenant count churns
        Bp = pad_bucket(len(members), minimum=self._b_floor.get(key, 1))
        self._b_floor[key] = Bp
        smax = max(self._smax_floor.get(key, 1),
                   max(m.smax for m in members))
        self._smax_floor[key] = smax
        t0 = time.perf_counter()
        with on_device(self.device):
            stacked = upload_members(
                stack_members([m.tables for m in members], Bp), self.device
            )
        up_ms = (time.perf_counter() - t0) * 1000
        chunk = _Chunk(key=key, members=members, smax=smax,
                       stacked=stacked)
        for i, m in enumerate(members):
            m.chunk = chunk
            m.slot = i
            m.timings["upload_ms"] = up_ms / len(members)
        warms = [m.warm for m in members]
        prev, done = self._last_done, threading.Event()
        self._last_done = done
        fetches, loop_syncs = self.fetches, self.loop_syncs

        def run():
            try:
                if prev is not None:
                    prev.wait()
                with on_device(self.device):
                    zeros_t = torch.zeros(Tp, dtype=I32, device=self.device)
                    zeros_m = torch.zeros(Mp, dtype=I32, device=self.device)
                    outs = [
                        _solve_member(
                            stacked, i,
                            w.asg if w is not None else zeros_t,
                            w.lvl if w is not None else zeros_t,
                            w.floor if w is not None else zeros_m,
                            n_prefs=P, smax=smax, alpha=self.alpha,
                            max_rounds=self.max_rounds,
                            warm_start=w is not None, syncs=loop_syncs,
                            tables=self._tables,
                        )
                        for i, w in enumerate(warms)
                    ]
                    # THE chunk's one batched fetch: every member's
                    # cost, certificate and assignment
                    B = len(outs)
                    h = fetches.read(torch.cat([
                        torch.stack([o[0][0] for o in outs]),
                        torch.stack([o[0][1] for o in outs]).to(I64),
                        torch.stack([o[1][0] for o in outs]).to(I64),
                        torch.stack([o[0][2] for o in outs]).to(I64)
                        .reshape(-1),
                    ]))
                vals = [
                    (int(h[i]), bool(h[B + i]),
                     h[3 * B + i * Tp: 3 * B + (i + 1) * Tp],
                     int(h[2 * B + i]))
                    for i in range(B)
                ]
                return vals, [o[0] for o in outs], outs, time.perf_counter()
            finally:
                done.set()

        chunk.t_dispatch = time.perf_counter()
        chunk.future = _AsyncFetch(run)
        self.dispatches += 1
        if self.metrics is not None:
            self.metrics.record_service_dispatch(
                f"{Tp}x{Mp}x{P}", len(members)
            )

    # ---- finish: join, certify, commit, degrade ------------------------

    def finish(
        self, solver: TenantSolver, pending: PendingSolve
    ) -> ResidentOutcome:
        pending.consumed = True
        chunk: _Chunk = pending.chunk
        timings = pending.timings
        t0 = time.perf_counter()
        if chunk.failed:
            solver.fetch_timeouts += 1
            self.pool.invalidate(pending.tenant)
            raise FetchTimeout(
                f"batched fetch for tenant {pending.tenant}'s chunk "
                f"already missed its deadline"
            )
        try:
            vals, states, outs, t_done = chunk.future.result(
                timeout_s=self.oracle_timeout_s
            )
        except FetchTimeout:
            chunk.failed = True
            solver.fetch_timeouts += 1
            self.pool.invalidate(pending.tenant)
            log.error(
                "batched placement fetch missed its deadline; "
                "abandoning tenant %s's round", pending.tenant,
            )
            raise
        timings["fetch_wait_ms"] = (time.perf_counter() - t0) * 1000
        timings["solve_ms"] = (t_done - chunk.t_dispatch) * 1000
        timings["fetch_ms"] = 0.0
        cost_np, conv, asg_np, rounds = vals[pending.slot]
        state = states[pending.slot]
        rounds_d, phases_d = outs[pending.slot][1]
        if not conv and pending.warm_used:
            # a stale warm start stranded the eps=1 settle: retry cold on
            # the chunk's still-resident tables (one more solve and one
            # more fetch, this member only)
            self.pool.invalidate(pending.tenant)
            self.cold_retries += 1
            t0 = time.perf_counter()
            with on_device(self.device):
                zeros_t = torch.zeros(pending.Tp, dtype=I32,
                                      device=self.device)
                zeros_m = torch.zeros(pending.Mp, dtype=I32,
                                      device=self.device)
                state, (rounds_d, phases_d) = _solve_member(
                    chunk.stacked, pending.slot, zeros_t, zeros_t, zeros_m,
                    n_prefs=pending.P, smax=chunk.smax, alpha=self.alpha,
                    max_rounds=self.max_rounds, warm_start=False,
                    syncs=self.loop_syncs, tables=self._tables,
                )
                h = self.fetches.read(torch.cat([
                    torch.stack([state[0], state[1].to(I64),
                                 rounds_d.to(I64)]),
                    state[2].to(I64),
                ]))
            cost_np, conv, asg_np = int(h[0]), bool(h[1]), h[3:]
            rounds = int(h[2])
            timings["solve_ms"] += (time.perf_counter() - t0) * 1000
        if not conv:
            self.pool.invalidate(pending.tenant)
            if not self.oracle_fallback:
                raise RuntimeError(
                    f"service solve for tenant {pending.tenant} did not "
                    f"certify and oracle fallback is disabled"
                )
            return solver._oracle_outcome(
                pending.arrays, pending.meta, pending.topo,
                pending.cost_host, timings, why="uncertified",
            )
        # commit the member's device state as the tenant's warm context
        _cost, conv_d, asg_d, lvl_d, floor_d, gap_d = state
        self.pool.commit(
            pending.tenant,
            DenseState(asg=asg_d, lvl=lvl_d, floor=floor_d, gap=gap_d,
                       converged=conv_d, rounds=rounds_d, phases=phases_d),
            pending.Tp, pending.Mp,
        )
        T = pending.T
        asg = np.asarray(asg_np[:T], np.int32)
        asg = np.where(
            (asg >= 0) & (asg < pending.n_machines), asg, -1
        ).astype(np.int32)
        channel = _channels_for(pending.inst, asg)
        solver.last_assignment = asg
        return ResidentOutcome(
            assignment=asg,
            channel=channel,
            cost=int(cost_np) // (T + 1),
            backend="dense_service",
            converged=True,
            rounds=rounds,
            phases=0,
            topology=pending.topo,
            timings=timings,
        )
