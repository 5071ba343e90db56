"""Device-resident scheduling rounds: one upload in, one fetch out.

A round prices the arcs, densifies the cost table, runs the auction
and finalizes channels and objective on the device, then brings the
result back in ONE batched transfer (``_resident_chain`` + the fetch in
``begin_round``). This restates ``poseidon_tpu/ops/resident.py`` (the
round half: no express or stream lane, no aggregation, no mesh) on
PyTorch tensors, with identical outputs bit for bit.

Host syncs. The reference's round is one compiled program with one host
sync. Here the auction's loop runs on the host and reads a small flag
tensor per iteration (see ``ops/dense_auction.py``); those reads are
counted as ``last_round_loop_syncs``, and the round's result comes back
in one sanctioned fetch, counted as ``last_round_fetches`` (1 on the
certified dense path).

Devices. ``ResidentSolver(device=None)`` runs on ``"cuda"``; without a
card it raises instead of drifting onto the CPU. Pass ``device="cpu"``
to run the plain (non-kernel) versions on the CPU, as the tests do.

Fallbacks, as in the reference: a cost table outside the auction's
integer domain (checked on the device, read with the result), a dense
table beyond the memory budget, or an uncertified solve degrades to the
C++ CPU oracle; a non-taxonomy graph goes straight to the oracle.
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
from poseidon_tpu_torch.guards import FetchTimeout, SyncCounter
from poseidon_tpu_torch.kernels.row_options import row_options
from poseidon_tpu_torch.models.costs import (
    CostInputs,
    build_cost_inputs_host,
    get_cost_model,
)
from poseidon_tpu_torch.ops.dense_auction import (
    I32,
    I64,
    INF,
    MAX_SCALED_COST,
    DenseInstance,
    DenseMemoryTooLarge,
    DenseState,
    _densify,
    _solve,
    check_table_budget,
    cold_start,
    default_fuse,
)
from poseidon_tpu_torch.ops.transport import (
    CH_CLUSTER,
    CH_PREF,
    CH_UNSCHED,
    NotSchedulingShaped,
    TransportTopology,
    extract_topology,
    instance_from_topology,
)
from poseidon_tpu_torch.solver import is_small_instance

log = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises and
    names the way to run on the CPU; nothing falls back on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "poseidon_tpu_torch runs on the GPU by default, and no CUDA "
            "device is available; pass device=\"cpu\" to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class DenseTopology:
    """Padded copy of the TransportTopology index maps (numpy from
    ``pad_topology``, tensors after ``to_device``).

    Index value -1 marks padding / absent arcs; gathers clip and mask.
    """

    arc_unsched: object   # i32[Tp]
    arc_cluster: object   # i32[Tp]
    arc_u2s: object       # i32[Tp]
    arc_pref: object      # i32[Tp, P]
    pref_machine: object  # i32[Tp, P]
    pref_rack: object     # i32[Tp, P]
    arc_c2m: object       # i32[Mp]
    arc_r2m: object       # i32[Mp]
    arc_m2s: object       # i32[Mp]
    rack_of: object       # i32[Mp]
    slots: object         # i32[Mp] (0 on padding)
    n_tasks: int

    def to_device(self, device) -> "DenseTopology":
        return DenseTopology(**{
            f.name: (
                getattr(self, f.name) if f.name == "n_tasks"
                else torch.as_tensor(getattr(self, f.name)).to(device)
            )
            for f in dataclasses.fields(self)
        })


def pad_topology(
    topo: TransportTopology, *, t_min: int = 16, m_min: int = 16,
    p_min: int = 0,
) -> DenseTopology:
    """Host-side padding of the skeleton (numpy; uploaded in one batch).

    ``t_min``/``m_min``/``p_min`` are grow-only bucket floors from the
    owning solver: a task count or pref width oscillating across a
    bucket boundary keeps one padded shape.
    """
    T, M = topo.n_tasks, topo.n_machines
    P = max(topo.max_prefs, p_min)
    Tp = pad_bucket(max(T, 1), minimum=t_min)
    Mp = pad_bucket(max(M, 1), minimum=m_min)

    def pad1(x, size, fill):
        out = np.full(size, fill, np.int32)
        out[: len(x)] = x
        return out

    def pad2(x, shape, fill):
        out = np.full(shape, fill, np.int32)
        out[: x.shape[0], : x.shape[1]] = x
        return out

    return DenseTopology(
        arc_unsched=pad1(topo.arc_unsched, Tp, -1),
        arc_cluster=pad1(topo.arc_cluster, Tp, -1),
        arc_u2s=pad1(topo.arc_u2s, Tp, -1),
        arc_pref=pad2(topo.arc_pref, (Tp, P), -1),
        pref_machine=pad2(topo.pref_machine, (Tp, P), -1),
        pref_rack=pad2(topo.pref_rack, (Tp, P), -1),
        arc_c2m=pad1(topo.arc_c2m, Mp, -1),
        arc_r2m=pad1(topo.arc_r2m, Mp, -1),
        arc_m2s=pad1(topo.arc_m2s, Mp, -1),
        rack_of=pad1(topo.rack_of, Mp, -1),
        slots=pad1(topo.slots, Mp, 0),
        n_tasks=int(T),
    )


def _redensify(dt: DenseTopology, cost: torch.Tensor, n_prefs: int,
               smax: int):
    """Gather the priced arc table into a scaled DenseInstance.

    Returns (DenseInstance, domain_ok, pc_scaled, ra_scaled). The domain
    check (non-negative costs, 2*cmax*(T+1) < MAX_SCALED_COST) is a
    device boolean read with the result.
    """
    Tp = dt.arc_unsched.shape[0]
    device = cost.device
    scale = dt.n_tasks + 1

    def gat(idx, fill):
        return torch.where(
            idx >= 0, cost[torch.clamp(idx, min=0).long()], fill
        )

    g = gat(dt.arc_m2s, INF)                      # [Mp] m->sink leg
    d_u = torch.clamp(gat(dt.arc_c2m, INF) + g, max=INF)
    ra_u = torch.clamp(gat(dt.arc_r2m, INF) + g, max=INF)
    u_u = gat(dt.arc_unsched, 0) + gat(dt.arc_u2s, 0)   # 0 on padding
    w_u = gat(dt.arc_cluster, INF)
    pm_leg = torch.where(
        dt.pref_machine >= 0,
        g[torch.clamp(dt.pref_machine, min=0).long()], 0,
    )
    pc_u = torch.clamp(gat(dt.arc_pref, INF) + pm_leg, max=INF)

    # integer-domain guard, in int64
    chans = (u_u, w_u, pc_u, d_u, ra_u)
    cmax_u = torch.stack(
        [torch.where(x < INF, x, 0).max() for x in chans]
    ).max()
    cmin_u = torch.stack(
        [torch.where(x < INF, x, 0).min() for x in chans]
    ).min()
    cmax_scaled = 2 * cmax_u.to(I64) * scale
    domain_ok = (cmin_u >= 0) & (cmax_scaled < MAX_SCALED_COST)

    def sc(x):
        # the x*scale lanes where x is INF-saturated may wrap (int32
        # wraps in two's complement on the CPU and the card); the
        # where() discards them before anything reads the value
        return torch.where(x >= INF, INF, x * scale).to(I32)

    u_s, w_s, d_s, ra_s = sc(u_u), sc(w_u), sc(d_u), sc(ra_u)
    pc_s = sc(pc_u)
    task_valid = torch.arange(Tp, device=device) < dt.n_tasks
    u_s = torch.where(task_valid, u_s, 0)

    c = _densify(
        w_s, d_s, ra_s, dt.rack_of, dt.slots, pc_s,
        dt.pref_machine, dt.pref_rack, n_prefs=n_prefs,
    )
    dev = DenseInstance(
        c=c,
        u=u_s,
        w=w_s,
        dgen=d_s,
        s=dt.slots,
        task_valid=task_valid,
        scale=scale,
        cmax=torch.clamp(cmax_scaled, max=INF - 1).to(I32),
        smax=smax,
    )
    return dev, domain_ok, pc_s, ra_s


def _finalize(dev: DenseInstance, dt: DenseTopology, pc_s, ra_s, asg):
    """Channel codes + scaled primal objective for a final assignment."""
    Tp, Mp = dev.c.shape
    P = pc_s.shape[1]
    on = (asg >= 0) & (asg < Mp) & dev.task_valid
    m = torch.clamp(asg, 0, Mp - 1).long()
    best = torch.where(on, torch.clamp(dev.w + dev.dgen[m], max=INF), INF)
    ch = torch.where(on, CH_CLUSTER, CH_UNSCHED).to(I32)
    for k in range(P):
        pm = dt.pref_machine[:, k]
        pr = dt.pref_rack[:, k]
        pck = pc_s[:, k]
        val = torch.where(on & (pm == asg), pck, INF)
        hit_r = on & (pr >= 0) & (pr == dt.rack_of[m])
        val = torch.minimum(
            val,
            torch.where(hit_r, torch.clamp(pck + ra_s[m], max=INF), INF),
        )
        better = val < best
        best = torch.where(better, val, best)
        ch = torch.where(better, CH_PREF + k, ch)
    c_asg = dev.c.gather(1, m[:, None])[:, 0]
    per = torch.where(dev.task_valid, torch.where(on, c_asg, dev.u), 0)
    return ch, per.to(I64).sum()


def _decision_stats(dev: DenseInstance, asg):
    """Per-decision attribution over the final assignment: the chosen
    route's SCALED cost and the runner-up alternative's SCALED cost.

    The reference takes a masked row-min of the table with the chosen
    column masked to INF. K2 at p = 0 gives the same number without a
    masked copy: every entry of c is at most INF (densify saturates), so
    the row-min excluding column ``asg`` is v2 when asg is the argmin
    m1 and b1v otherwise."""
    Tp, Mp = dev.c.shape
    on = (asg >= 0) & (asg < Mp) & dev.task_valid
    m = torch.clamp(asg, 0, Mp - 1).long()
    c_asg = dev.c.gather(1, m[:, None])[:, 0]
    chosen = torch.where(on, c_asg, dev.u)
    b1v, m1, v2 = row_options(
        dev.c, torch.zeros(Mp, dtype=I32, device=dev.c.device)
    )
    alt_m = torch.where(on & (m1 == asg), v2, b1v)
    alt = torch.where(on, torch.minimum(alt_m, dev.u), alt_m)
    return chosen, alt


class _AsyncFetch:
    """Single-shot background worker with a bounded join.

    The worker is a daemon thread, so a round wedged on a dead device
    can neither block interpreter exit nor poison a shared pool; a
    timed-out round is simply abandoned. ``_value``/``_exc`` are written
    before ``_done.set()`` and read only after ``wait()`` returns.
    """

    def __init__(self, fn):
        self._fn = fn
        self._done = threading.Event()
        self._value = None
        self._exc: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="resident-fetch", daemon=True
        )
        self._thread.start()

    def _run(self):
        try:
            self._value = self._fn()
        except BaseException as e:  # delivered to the joining thread
            self._exc = e
        finally:
            self._done.set()

    def result(self, timeout_s: float | None = None):
        """Join; raises ``FetchTimeout`` past the deadline (the worker
        keeps running — the caller decides to abandon)."""
        if not self._done.wait(timeout_s):
            raise FetchTimeout(
                f"background placement fetch still pending after "
                f"{timeout_s:g}s (--max_solver_runtime)"
            )
        if self._exc is not None:
            raise self._exc
        return self._value


def _resident_chain(
    dt: DenseTopology,
    inputs_dev: CostInputs,
    warm_asg,
    warm_lvl,
    warm_floor,
    *,
    model_fn,
    n_prefs: int,
    smax: int,
    alpha: int,
    max_rounds: int,
    warm_start: bool,
    syncs: SyncCounter | None = None,
):
    """The whole resident round on the device: cost model → densify →
    auction → channel/objective finalize → decision stats. When
    ``warm_start`` is False the warm_* arguments are ignored.

    Returns the reference's 14-tuple: (asg, lvl, floor, gap, converged,
    rounds, phases, ch, primal, domain_ok, chosen, alt, cost, dev), with
    ``rounds``/``phases`` as Python ints."""
    cost = model_fn(inputs_dev)
    dev, domain_ok, pc_s, ra_s = _redensify(
        dt, cost, n_prefs=n_prefs, smax=smax
    )
    if warm_start:
        asg, lvl, floor, gap, converged, rounds, phases, _ = _solve(
            dev, warm_asg, warm_lvl, warm_floor, 1,
            alpha=alpha, max_rounds=max_rounds, smax=smax,
            analytic_init=False, syncs=syncs,
        )
    else:
        asg0, lvl0, floor0, eps0 = cold_start(dev, alpha)
        asg, lvl, floor, gap, converged, rounds, phases, _ = _solve(
            dev, asg0, lvl0, floor0, eps0, alpha=alpha,
            max_rounds=max_rounds, smax=smax, analytic_init=True,
            syncs=syncs,
        )
    ch, primal = _finalize(dev, dt, pc_s, ra_s, asg)
    chosen, alt = _decision_stats(dev, asg)
    return (asg, lvl, floor, gap, converged, rounds, phases, ch,
            primal, domain_ok, chosen, alt, cost, dev)


@dataclasses.dataclass(frozen=True)
class _Fetched:
    """A round's result on the host, from its one batched transfer."""

    asg: np.ndarray
    ch: np.ndarray
    chosen: np.ndarray
    alt: np.ndarray
    lvl: np.ndarray
    floor: np.ndarray
    converged: bool
    primal: int
    domain_ok: bool


def _fetch_result(fetches: SyncCounter, asg, ch, chosen, alt, lvl, floor,
                  converged, primal, domain_ok) -> _Fetched:
    """Pack every result array into one int64 buffer and bring it to the
    host in ONE counted transfer."""
    Tp, Mp = asg.shape[0], floor.shape[0]
    packed = torch.cat([
        asg.to(I64), ch.to(I64), chosen.to(I64), alt.to(I64), lvl.to(I64),
        floor.to(I64),
        torch.stack([converged.to(I64), primal.to(I64), domain_ok.to(I64)]),
    ])
    h = fetches.read(packed)
    o = np.cumsum([0, Tp, Tp, Tp, Tp, Tp, Mp])
    return _Fetched(
        asg=h[o[0]:o[1]].astype(np.int32), ch=h[o[1]:o[2]].astype(np.int32),
        chosen=h[o[2]:o[3]], alt=h[o[3]:o[4]],
        lvl=h[o[4]:o[5]].astype(np.int32),
        floor=h[o[5]:o[6]].astype(np.int32),
        converged=bool(h[o[6]]), primal=int(h[o[6] + 1]),
        domain_ok=bool(h[o[6] + 2]),
    )


@dataclasses.dataclass
class ResidentOutcome:
    """One resident round's result, fully host-side."""

    assignment: np.ndarray   # int32[T] machine index or -1
    channel: np.ndarray      # int32[T] CH_* code
    cost: int                # exact unscaled objective
    backend: str             # "dense_auction" | "oracle:<why>"
    converged: bool
    rounds: int
    phases: int
    # None only on a non-taxonomy graph (oracle path)
    topology: TransportTopology | None
    timings: dict[str, float]
    # per-decision attribution (int64 over task order, unscaled): the
    # chosen route's objective contribution and runner-up-minus-chosen
    # (deltas.MARGIN_UNKNOWN = no finite runner-up / not computed)
    task_cost: np.ndarray | None = None
    task_margin: np.ndarray | None = None


@dataclasses.dataclass
class InflightSolve:
    """A dispatched-but-not-finished resident round.

    ``begin_round`` returns one of these with the round running on a
    background worker (the auction loop and the one result fetch);
    ``finish_round`` joins it and completes the round. Rounds that
    resolved synchronously (degrade paths) carry ``outcome`` directly.
    """

    outcome: ResidentOutcome | None = None
    future: _AsyncFetch | None = None
    arrays: dict | None = None
    meta: GraphMeta | None = None
    topo: TransportTopology | None = None
    dt: DenseTopology | None = None
    inputs_dev: CostInputs | None = None
    model_fn: object = None
    n_prefs: int = 0
    smax: int = 1
    max_rounds: int = 0
    warm_used: bool = False
    Tp: int = 0
    Mp: int = 0
    T: int = 0
    n_machines: int = 0
    timings: dict | None = None
    t_dispatch: float = 0.0
    # set by finish_round on first join; guards double-finish
    consumed: bool = False


class ResidentSolver:
    """Owns the device-resident solve chain + warm state across rounds.

    Warm state (``DenseState``) stays on the device between rounds; it
    survives task-set churn because a stale assignment is only a
    starting point — the auction's violator release and certificate
    repair it exactly.

    The express/stream lanes, machine aggregation, preference pruning
    and the device mesh are not part of this port yet: asking for any
    of them raises ``NotImplementedError``.
    """

    # runner-up computation on the oracle path is O(T·M) host work;
    # above this many cells it is skipped (margins report MARGIN_UNKNOWN)
    ORACLE_MARGIN_CELLS = 1 << 22

    def __init__(
        self,
        *,
        device=None,
        alpha: int = 1024,
        max_rounds: int | None = None,
        oracle_fallback: bool = True,
        oracle_timeout_s: float = 1000.0,
        small_to_oracle: bool = True,
        fetch_timeout_s: float | None = None,
        mesh_width: int = 0,
        aggregate_classes: bool = False,
        topk_prefs: int = 0,
        express_lane: bool = False,
        stream_windows: int = 0,
    ):
        later = {
            "mesh_width": mesh_width, "aggregate_classes": aggregate_classes,
            "topk_prefs": topk_prefs, "express_lane": express_lane,
            "stream_windows": stream_windows,
        }
        asked = sorted(k for k, v in later.items() if v)
        if asked:
            raise NotImplementedError(
                f"ResidentSolver options {asked} are not ported to "
                f"poseidon_tpu_torch yet (ROADMAP.md)"
            )
        self.device = resolve_device(device)
        self.alpha = alpha
        self.max_rounds = max_rounds
        self.oracle_fallback = oracle_fallback
        self.oracle_timeout_s = oracle_timeout_s
        self.fetch_timeout_s = fetch_timeout_s
        # dispatch heuristic: tiny instances go straight to the oracle
        self.small_to_oracle = small_to_oracle
        self._warm: DenseState | None = None
        # grow-only padding-bucket floors (one padded shape while counts
        # oscillate across a bucket boundary)
        self._e_floor = 16
        self._t_floor = 16
        self._m_floor = 16
        self._ti_floor = 1
        self._mi_floor = 1
        self._s_floor = 1
        self._p_floor = 0
        # one round in flight at a time
        self._inflight = False
        self.fetch_timeouts = 0
        # host reads of the last round: result fetches (1 on the
        # certified dense path) and the auction loop's flag reads
        self._fetches = SyncCounter()
        self._loop_syncs = SyncCounter()
        # host mirror of the warm state (asg/lvl/floor from the round's
        # own fetch): the replay/restore seed
        self._warm_seed: tuple | None = None

    @property
    def last_round_fetches(self) -> int:
        return self._fetches.count

    @property
    def last_round_loop_syncs(self) -> int:
        return self._loop_syncs.count

    @property
    def warm(self) -> DenseState | None:
        """The device warm handle carried across rounds (None = cold)."""
        return self._warm

    @property
    def warm_seed_host(self) -> tuple | None:
        """Host (asg, lvl, floor) int32 mirror of the live warm state,
        or None when cold."""
        if self._warm is None:
            return None
        return self._warm_seed

    @property
    def pad_floors(self) -> dict[str, int]:
        """The grow-only padding-bucket floors as of now (same keys as
        the reference's)."""
        return {
            "e": self._e_floor, "t": self._t_floor, "m": self._m_floor,
            "ti": self._ti_floor, "mi": self._mi_floor,
            "s": self._s_floor, "p": self._p_floor,
        }

    def restore_for_replay(
        self, floors: dict[str, int] | None, warm_seed: tuple | None,
    ) -> None:
        """Restore recorded padding floors and (optionally) upload a
        recorded warm (asg, lvl, floor) mirror as the next round's warm
        start. The inputs are the reference's ``pad_floors`` dict and
        ``warm_seed_host`` tuple, so the next round starts from exactly
        the carry the reference would use."""
        if floors:
            self._e_floor = floors["e"]
            self._t_floor = floors["t"]
            self._m_floor = floors["m"]
            self._ti_floor = floors["ti"]
            self._mi_floor = floors["mi"]
            self._s_floor = floors["s"]
            self._p_floor = floors["p"]
        if warm_seed is None:
            return
        asg, lvl, floor = (np.array(x, np.int32) for x in warm_seed[:3])
        self._warm = DenseState(
            asg=torch.from_numpy(asg).to(self.device),
            lvl=torch.from_numpy(lvl).to(self.device),
            floor=torch.from_numpy(floor).to(self.device),
            gap=torch.zeros((), dtype=I64, device=self.device),
            converged=torch.ones((), dtype=torch.bool, device=self.device),
            rounds=0, phases=0,
        )
        self._warm_seed = (asg, lvl, floor)

    def _fetch_deadline_s(self) -> float:
        return (
            self.fetch_timeout_s if self.fetch_timeout_s is not None
            else self.oracle_timeout_s
        )

    def run_round(
        self,
        arrays: dict[str, np.ndarray],
        meta: GraphMeta,
        *,
        cost_model: str,
        cost_input_kwargs: dict | None = None,
        topology: TransportTopology | None = None,
    ) -> ResidentOutcome:
        """One full scheduling round from builder host arrays
        (``begin_round`` immediately joined by ``finish_round``)."""
        return self.finish_round(self.begin_round(
            arrays, meta, cost_model=cost_model,
            cost_input_kwargs=cost_input_kwargs, topology=topology,
        ))

    def begin_round(
        self,
        arrays: dict[str, np.ndarray],
        meta: GraphMeta,
        *,
        cost_model: str,
        cost_input_kwargs: dict | None = None,
        topology: TransportTopology | None = None,
    ) -> InflightSolve:
        """Prep + upload + background run of one resident round.

        Returns an ``InflightSolve`` whose device work (auction loop and
        result fetch) runs on a background worker; the caller overlaps
        host work and then calls ``finish_round``. Degrade paths (small
        instance, non-taxonomy, memory envelope) solve synchronously on
        the oracle and come back with ``outcome`` already set.
        """
        if self._inflight:
            raise RuntimeError(
                "a resident round is already in flight; finish_round() "
                "must be called before the next begin_round()"
            )
        self._fetches = SyncCounter()
        self._loop_syncs = SyncCounter()
        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        model_fn = get_cost_model(cost_model)
        self._e_floor = pad_bucket(
            max(meta.n_arcs, 1), minimum=self._e_floor
        )
        self._ti_floor = pad_bucket(
            max(len(meta.task_uids), 1), minimum=self._ti_floor
        )
        self._mi_floor = pad_bucket(
            max(len(meta.machine_names), 1), minimum=self._mi_floor
        )
        inputs_host = build_cost_inputs_host(
            self._e_floor, meta, t_min=self._ti_floor, m_min=self._mi_floor,
            **(cost_input_kwargs or {}),
        )

        def degrade(why: str, topo, *, price_on_cpu: bool = False):
            # price the arcs and solve this round on the oracle; the
            # small lane prices on the CPU (its point is to skip the
            # device launch floor)
            where = torch.device("cpu") if price_on_cpu else self.device
            cost = model_fn(inputs_host.to_device(where))
            return InflightSolve(outcome=self._oracle_round(
                arrays, meta, topo, cost, timings, why=why
            ))

        topo = topology
        if topo is None:
            try:
                topo = extract_topology(
                    meta, arrays["src"], arrays["dst"], arrays["cap"]
                )
            except NotSchedulingShaped:
                return degrade("not-scheduling-shaped", None)
        T = topo.n_tasks
        if (
            self.small_to_oracle
            and self.oracle_fallback
            and self._warm is None
            and (T == 0 or is_small_instance(T, topo.n_machines))
        ):
            return degrade("small-instance", topo, price_on_cpu=True)
        self._p_floor = max(topo.max_prefs, self._p_floor)
        P = self._p_floor
        dt_host = pad_topology(
            topo, t_min=self._t_floor, m_min=self._m_floor,
            p_min=self._p_floor,
        )
        Tp = dt_host.arc_unsched.shape[0]
        Mp = dt_host.slots.shape[0]
        try:
            check_table_budget(Tp, Mp)
        except DenseMemoryTooLarge as e:
            # degrade loudly BEFORE any device allocation; a floor
            # raised by a past larger cluster must not keep re-padding a
            # fitting instance over budget forever
            self._warm = None
            self._t_floor = 16
            self._m_floor = 16
            self._ti_floor = 1
            self._mi_floor = 1
            self._s_floor = 1
            self._p_floor = 0
            if not self.oracle_fallback:
                raise
            log.warning(
                "resident round exceeds the dense memory budget (%s); "
                "degrading to oracle", e,
            )
            return degrade("memory-envelope", topo)
        self._t_floor = Tp
        self._m_floor = Mp
        # power-of-two smax bound, grow-only like the other floors
        self._s_floor = pad_bucket(
            max(int(topo.slots.max(initial=1)), 1),
            minimum=self._s_floor,
        )
        smax = min(self._s_floor, Tp)
        timings["prep_ms"] = (time.perf_counter() - t0) * 1000

        warm = self._warm
        if warm is not None and (
            warm.asg.shape[0] != Tp or warm.floor.shape[0] != Mp
        ):
            warm = None  # cluster outgrew its padding bucket
        max_rounds = (
            self.max_rounds if self.max_rounds is not None
            else default_fuse()
        )
        t0 = time.perf_counter()
        inputs_dev = inputs_host.to_device(self.device)
        dt = dt_host.to_device(self.device)
        timings["upload_ms"] = (time.perf_counter() - t0) * 1000
        inflight = InflightSolve(
            arrays=arrays, meta=meta, topo=topo, dt=dt,
            inputs_dev=inputs_dev, model_fn=model_fn, n_prefs=P,
            smax=smax, max_rounds=max_rounds, warm_used=warm is not None,
            Tp=Tp, Mp=Mp, T=T, n_machines=topo.n_machines,
            timings=timings, t_dispatch=time.perf_counter(),
        )
        fetches, loop_syncs = self._fetches, self._loop_syncs
        self._inflight = True
        inflight.future = _AsyncFetch(
            lambda: self._dispatch(inflight, warm, fetches, loop_syncs)
        )
        return inflight

    def _dispatch(self, inflight: InflightSolve, warm: DenseState | None,
                  fetches: SyncCounter, loop_syncs: SyncCounter):
        """Run the chain and fetch its result (on the round's worker)."""
        zeros_t = torch.zeros(inflight.Tp, dtype=I32, device=self.device)
        zeros_m = torch.zeros(inflight.Mp, dtype=I32, device=self.device)
        (asg, lvl, floor, gap, conv, rounds, phases, ch, primal, dom_ok,
         chosen, alt, cost, dev) = _resident_chain(
            inflight.dt, inflight.inputs_dev,
            warm.asg if warm is not None else zeros_t,
            warm.lvl if warm is not None else zeros_t,
            warm.floor if warm is not None else zeros_m,
            model_fn=inflight.model_fn, n_prefs=inflight.n_prefs,
            smax=inflight.smax, alpha=self.alpha,
            max_rounds=inflight.max_rounds, warm_start=warm is not None,
            syncs=loop_syncs,
        )
        fetched = _fetch_result(fetches, asg, ch, chosen, alt, lvl, floor,
                                conv, primal, dom_ok)
        state = DenseState(asg=asg, lvl=lvl, floor=floor, gap=gap,
                           converged=conv, rounds=rounds, phases=phases)
        return fetched, state, cost, time.perf_counter()

    def discard_round(self, inflight: InflightSolve) -> None:
        """Join and drop an in-flight round the caller is abandoning
        (no cold retry, no oracle fallback; warm state unchanged)."""
        if inflight.outcome is not None or inflight.consumed:
            return
        self._inflight = False
        inflight.consumed = True
        try:
            inflight.future.result(timeout_s=self._fetch_deadline_s())
        except FetchTimeout:
            self.fetch_timeouts += 1
            log.error(
                "discard_round: abandoning a round still pending after "
                "%gs", self._fetch_deadline_s(),
            )
        except Exception:
            log.exception("discard_round: in-flight round failed")

    def finish_round(self, inflight: InflightSolve) -> ResidentOutcome:
        """Join the round and complete it (certificate checks, cold
        retry, warm-state commit)."""
        if inflight.outcome is not None:
            return inflight.outcome
        self._inflight = False
        inflight.consumed = True
        timings = inflight.timings
        topo = inflight.topo
        T = inflight.T
        t0 = time.perf_counter()
        try:
            res, state, cost_dev, t_done = inflight.future.result(
                timeout_s=self._fetch_deadline_s()
            )
        except FetchTimeout:
            self.fetch_timeouts += 1
            self._warm = None
            log.error(
                "placement fetch missed its %gs deadline "
                "(--max_solver_runtime); abandoning the round",
                self._fetch_deadline_s(),
            )
            raise
        timings["fetch_wait_ms"] = (time.perf_counter() - t0) * 1000
        timings["solve_ms"] = (t_done - inflight.t_dispatch) * 1000

        if not res.domain_ok:
            self._warm = None
            return self._oracle_round(
                inflight.arrays, inflight.meta, topo, cost_dev, timings,
                why="cost-domain",
            )
        if not res.converged and inflight.warm_used:
            # stale warm start stranded the eps=1 settle: retry cold
            # (synchronously; this round pays twice)
            self._warm = None
            t0 = time.perf_counter()
            res, state, cost_dev, _ = self._dispatch(
                inflight, None, self._fetches, self._loop_syncs
            )
            timings["solve_ms"] += (time.perf_counter() - t0) * 1000
        if not res.converged:
            self._warm = None
            return self._oracle_round(
                inflight.arrays, inflight.meta, topo, cost_dev, timings,
                why="uncertified",
            )

        self._warm = state
        self._warm_seed = (res.asg, res.lvl, res.floor)
        Mp = inflight.Mp
        asg = res.asg[:T]
        scale = np.int64(T + 1)
        task_cost = res.chosen[:T] // scale
        from poseidon_tpu_torch.graph.deltas import MARGIN_UNKNOWN

        alt64 = res.alt[:T]
        task_margin = np.where(
            alt64 >= int(INF), MARGIN_UNKNOWN, alt64 // scale - task_cost,
        )
        asg = np.where(
            (asg >= 0) & (asg < Mp) & (asg < inflight.n_machines), asg, -1,
        ).astype(np.int32)
        return ResidentOutcome(
            assignment=asg,
            channel=res.ch[:T],
            cost=res.primal // (T + 1),
            backend="dense_auction",
            converged=True,
            rounds=int(state.rounds),
            phases=int(state.phases),
            topology=topo,
            timings=timings,
            task_cost=task_cost,
            task_margin=task_margin,
        )

    @staticmethod
    def _host_decision_stats(topo, cost_host, asg):
        """Host twin of ``_decision_stats`` for oracle-solved rounds:
        per-task chosen route cost + runner-up alternative from the
        priced arc table (the runner-up part is O(T·M) and skipped over
        the cell budget)."""
        from poseidon_tpu_torch.graph.deltas import MARGIN_UNKNOWN
        from poseidon_tpu_torch.ops.transport import INF as TINF

        inst = instance_from_topology(topo, cost_host)
        T, M = inst.n_tasks, inst.n_machines
        if T == 0:
            z = np.zeros(0, np.int64)
            return z, z
        asg = np.asarray(asg, np.int64)
        on = asg >= 0
        m = np.clip(asg, 0, max(M - 1, 0))
        best = np.where(on, inst.w + inst.d[m], TINF)
        hit_m = inst.pref_machine == asg[:, None]
        pc = np.where(hit_m, inst.pref_cost, TINF)
        hit_r = (inst.pref_rack >= 0) & (
            inst.pref_rack == inst.rack_of[m][:, None]
        )
        pc = np.minimum(
            pc, np.where(hit_r, inst.pref_cost + inst.ra[m][:, None],
                         TINF)
        )
        best = np.minimum(best, pc.min(axis=1, initial=TINF))
        chosen = np.where(on, best, inst.u).astype(np.int64)
        if T * M > ResidentSolver.ORACLE_MARGIN_CELLS:
            return chosen, np.full(T, MARGIN_UNKNOWN, np.int64)
        # full route table [T, M]: cluster channel + pref channels
        row = inst.w[:, None] + inst.d[None, :]
        for k in range(inst.max_prefs):
            pm = inst.pref_machine[:, k: k + 1]
            pr = inst.pref_rack[:, k: k + 1]
            pck = inst.pref_cost[:, k: k + 1]
            mids = np.arange(M)[None, :]
            row = np.minimum(
                row, np.where((pm == mids) & (pm >= 0), pck, TINF)
            )
            hit = (pr >= 0) & (pr == inst.rack_of[None, :])
            row = np.minimum(
                row, np.where(hit, pck + inst.ra[None, :], TINF)
            )
        masked = np.where(
            (np.arange(M)[None, :] == asg[:, None]) & on[:, None],
            TINF, row,
        )
        alt_m = masked.min(axis=1, initial=TINF)
        alt = np.where(on, np.minimum(alt_m, inst.u), alt_m)
        margin = np.where(
            alt >= TINF, MARGIN_UNKNOWN, alt - chosen
        ).astype(np.int64)
        return chosen, margin

    def _oracle_round(
        self, arrays, meta, topo, cost_dev, timings, *, why: str
    ) -> ResidentOutcome:
        """Degrade one round to the C++ oracle (fetches the arc table).

        ``topo`` is None on a non-taxonomy graph — the outcome then
        carries no topology and its channel codes are -1.
        """
        if not self.oracle_fallback:
            raise RuntimeError(
                f"resident solve failed ({why}) and oracle fallback is "
                f"disabled"
            )
        from poseidon_tpu_torch.graph.decompose import extract_placements
        from poseidon_tpu_torch.ops.dense_auction import _channels_for
        from poseidon_tpu_torch.oracle import solve_oracle

        t0 = time.perf_counter()
        cost_host = self._fetches.read(cost_dev).astype(np.int32)[
            : meta.n_arcs
        ]
        net = FlowNetwork.from_arrays(
            arrays["src"], arrays["dst"], arrays["cap"], cost_host,
            arrays["supply"],
        )
        o = solve_oracle(
            net, algorithm="cost_scaling", timeout_s=self.oracle_timeout_s
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
        task_cost = task_margin = None
        if topo is not None:
            # real channel codes, so the outcome stays flow-decomposable
            channel = _channels_for(
                instance_from_topology(topo, cost_host), asg
            )
            task_cost, task_margin = self._host_decision_stats(
                topo, cost_host, asg
            )
        else:
            channel = np.full(T, -1, np.int32)
        timings["oracle_ms"] = (time.perf_counter() - t0) * 1000
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
            task_cost=task_cost,
            task_margin=task_margin,
        )
