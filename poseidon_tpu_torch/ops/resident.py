"""Device-resident scheduling rounds: one upload in, one fetch out.

A round prices the arcs, densifies the cost table, runs the auction
and finalizes channels and objective on the device, then brings the
result back in ONE batched transfer (``_resident_chain`` + the fetch in
``begin_round``). Between rounds the express lane patches the round's
warm device instance and repairs it (``express_round``: K5 retires
rows, K4 writes arrival rows, an eps=1 repair, one fetch), and the
stream lane runs K such windows back to back with one fetch for all of
them (``stream_window`` / ``stream_flush`` / ``stream_finish``; K7
commits each window on the device). This restates
``poseidon_tpu/ops/resident.py`` (the round half, the express and
stream lanes, the service lane's per-tenant warm pool and the scale
lane) on PyTorch tensors, with identical outputs bit for bit.

The scale lane. ``topk_prefs`` caps each task's preference columns,
``aggregate_classes`` collapses the machine axis to its equivalence
classes (``graph/aggregate.py``; the fetched class assignment expands
back to machines in ``finish_round``), and ``mesh_width`` lays the
dense table out as row blocks over a task-axis mesh (``parallel/``):
K1 builds each shard's rows, K2/K3/K4 and the gathers run per shard,
K7 undoes a dead stream window's rows in the shard that owns them, and
the certificate's table pass is K8 per shard. Width 0 is the plain
layout; width 1 is a one-shard mesh with the same results.

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

import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from poseidon_tpu_torch.graph.aggregate import (
    aggregate_topology,
    expand_assignment,
    plan_from_signatures,
    prune_topology_prefs,
)
from poseidon_tpu_torch.graph.builder import ArcKind, GraphMeta
from poseidon_tpu_torch.graph.network import FlowNetwork, pad_bucket
from poseidon_tpu_torch.guards import FetchTimeout, SyncCounter
from poseidon_tpu_torch.kernels.express_patch import express_patch
from poseidon_tpu_torch.kernels.express_rows import express_rows
from poseidon_tpu_torch.kernels.stream_commit import (
    Commit,
    log_width,
    stream_commit,
    stream_restore,
)
from poseidon_tpu_torch.models.costs import (
    CostInputs,
    build_cost_inputs_host,
    get_cost_model,
    resolve_cost_model_name,
)
from poseidon_tpu_torch.ops.dense_auction import (
    I32,
    I64,
    INF,
    MAX_SCALED_COST,
    DenseInstance,
    DenseMemoryTooLarge,
    DenseState,
    RowBlocks,
    _budget_need,
    _densify,
    _solve,
    check_table_budget,
    cold_start,
    default_fuse,
    rows_of,
    table_gather,
    table_row_options,
    to_dev,
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
from poseidon_tpu_torch.parallel import make_mesh
from poseidon_tpu_torch.solver import is_small_instance

log = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises and
    names the way to run on the CPU; nothing falls back on its own. A
    CUDA device without an index gets the caller's current one, so a
    round's worker thread (whose current device is its own) still
    allocates on the device the solver was made for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "poseidon_tpu_torch runs on the GPU by default, and no CUDA "
            "device is available; pass device=\"cpu\" to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(device: torch.device):
    """``device`` as the current CUDA device for a block (a no-op on the
    CPU): a worker thread starts on device 0."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
               smax: int, mesh=None):
    """Gather the priced arc table into a scaled DenseInstance.

    Returns (DenseInstance, domain_ok, pc_scaled, ra_scaled). The domain
    check (non-negative costs, 2*cmax*(T+1) < MAX_SCALED_COST) is a
    device boolean read with the result. With a ``mesh`` the table is
    ``RowBlocks``: K1 runs once per shard over its rows of the
    task-major fields; the [Tp] and [Mp] vectors stay on the mesh's
    first device.
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

    if mesh is None:
        c = _densify(
            w_s, d_s, ra_s, dt.rack_of, dt.slots, pc_s,
            dt.pref_machine, dt.pref_rack, n_prefs=n_prefs,
        )
    else:
        # the task-major operands by rows (the pref fields are in
        # parallel.RESIDENT_TASK_FIELDS), the machine vectors whole
        blocks = [
            _densify(
                rows_of(w_s, r0, r1, d), to_dev(d_s, d), to_dev(ra_s, d),
                to_dev(dt.rack_of, d), to_dev(dt.slots, d),
                rows_of(pc_s, r0, r1, d),
                rows_of(dt.pref_machine, r0, r1, d),
                rows_of(dt.pref_rack, r0, r1, d), n_prefs=n_prefs,
            )
            for (r0, r1), d in zip(mesh.rows(Tp), mesh.devices)
        ]
        c = RowBlocks(blocks, mesh)
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
    c_asg = table_gather(dev.c, m)
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
    c_asg = table_gather(dev.c, m)
    chosen = torch.where(on, c_asg, dev.u)
    b1v, m1, v2 = table_row_options(
        dev.c, torch.zeros(Mp, dtype=I32, device=dev.c.device)
    )
    alt_m = torch.where(on & (m1 == asg), v2, b1v)
    alt = torch.where(on, torch.minimum(alt_m, dev.u), alt_m)
    return chosen, alt


# ---------------------------------------------------------------------------
# the express lane: device patch + bounded eps=1 repair between rounds
# ---------------------------------------------------------------------------

# Bounded repair fuse: an express batch is 1-K arrivals/completions
# against warm prices, so the repair is sparse local work; a batch that
# genuinely needs a price war this long is cheaper as a full round
# (converged=False -> EXPRESS_DEGRADE, the next round handles it).
EXPRESS_FUSE = 5_000

# chunk width of the retire/slot patch: backlogs larger than one chunk
# (a big round's bindings, a rebalancing-mode freeze of every running
# row) apply as several chunks of one K5 launch, in order
_EXPRESS_PATCH_CHUNK = 1024


def _express_patch(state, backlog, out=None):
    """Deactivate table rows + apply slot-capacity deltas, chunk after
    chunk (K5, one launch; ``backlog`` int32[n_chunks, 3, W] of rows,
    slot columns and deltas, -1 for unused entries).

    The retire half of the express patch vocabulary: a pod whose
    binding POST landed leaves the pending set, so its (seated) row
    deactivates and its machine's capacity drops by one — net zero on
    the auction's feasible set, so warm prices stay eps-CS and no repair
    is needed. Also carries bare slot deltas (completions of running
    pods free a seat, +1). Reads ``state`` = (u, w, task_valid, s, asg,
    lvl) and returns the patched six: into ``out`` when given, whose
    entries may be the state's own tensors (patched in place) or None
    (new tensors); else all six are new, as the reference's are. A
    degraded batch keeps the warm state's asg and lvl, so callers never
    patch those in place."""
    return express_patch(state, out, backlog)


def _express_patch_chunks(rows, cols, deltas):
    """Pad retire/slot patches into fixed-width chunks: int32[n_chunks,
    3, W] (rows, cols, deltas), the backlog one K5 launch applies."""
    n = len(rows)
    W = _EXPRESS_PATCH_CHUNK
    out = np.full((-(-n // W), 3, W), -1, np.int32)
    out[:, 2] = 0
    for k, i in enumerate(range(0, n, W)):
        m = min(W, n - i)
        out[k, 0, :m] = rows[i: i + W]
        out[k, 1, :m] = cols[i: i + W]
        out[k, 2, :m] = deltas[i: i + W]
    return out


def _stream_event_ints(kmax: int, pk: int, pw: int, m_in: int) -> int:
    """Per-window i32 count of the stream event encoding, for the
    budget guard: the mini cost inputs (~8 arc-axis arrays over the
    kmax x (3 + pk) mini arc budget plus task/machine side arrays), the
    arrival row/pref slices, and the patch triple at width ``pw``. An
    upper-bound estimate; the guard doubles it for the staging twin."""
    e_mini = kmax * (3 + pk)
    return (
        e_mini * 8          # mini arc-axis cost-input arrays
        + kmax * 6          # mini task-axis arrays
        + m_in * 4          # mini machine-axis arrays
        + 2 * kmax * pk     # add_pm / add_pr
        + kmax              # add_row
        + 3 * pw            # prow / pcol / pdelta
    )


def _write_arrival_rows(dev, dt, w_s, u_s, pc_s, add_row, add_pm, add_pr,
                        ra_s, asg, lvl, c_saved=None):
    """K4, the window's head: the arrival rows into the table and u, w,
    task_valid at them, in place; returns ``(asg0, lvl0)`` (new tensors,
    -1 / 0 at the arrival rows). With ``c_saved`` (one [kmax, Mp] buffer
    a shard) the rows' old contents are kept for a dead stream window.
    Under a mesh each shard's launch writes the rows it owns; the first
    shard's also writes the [Tp] vectors."""
    c = dev.c
    vectors = (u_s, dev.u, dev.w, dev.task_valid, asg, lvl)
    head = (w_s, pc_s, add_row, add_pm, add_pr, dev.dgen, ra_s, dt.rack_of,
            dev.s)
    if not isinstance(c, RowBlocks):
        return express_rows(c, *head, vectors,
                            c_saved[0] if c_saved else None)
    return [
        express_rows(b, *(to_dev(x, d) for x in head),
                     None if i else vectors,
                     c_saved[i] if c_saved else None, r0)
        for i, (b, r0, _r1, d) in enumerate(c.shards())
    ][0]


@dataclasses.dataclass
class _StreamCarry:
    """The stream lane's carry between windows, overwritten in place by
    each live window's tail: ``live`` int32[1] (the latch), u/w/valid/
    asg/lvl [Tp], s/floor [Mp], and ``saved``, one int32 [kmax, Mp]
    buffer a table shard for the rows the head overwrites."""

    live: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor
    asg: torch.Tensor
    lvl: torch.Tensor
    s: torch.Tensor
    floor: torch.Tensor
    saved: list


def _express_step(
    dev: DenseInstance,
    dt: DenseTopology,
    cost_dev,
    mini_inputs,
    asg, lvl, floor,
    add_row,      # i32[kmax] padded row to activate (-1 unused)
    add_pm,       # i32[kmax, pk] pref machine COLUMN (-1 none)
    add_pr,       # i32[kmax, pk] pref rack index (-1 none)
    *,
    model_fn,
    kmax: int,
    pk: int,
    alpha: int,
    max_rounds: int,
    smax: int,
    change_cap: int,
    syncs: SyncCounter | None = None,
    carry: _StreamCarry | None = None,
    log_row: torch.Tensor | None = None,
):
    """One express window on the device (the reference's
    ``_express_step``, which its ``_express_chain`` runs one window a
    dispatch): price the arrivals' task-side arcs with the round's cost
    model, activate their table rows and scatter u, w, task_valid, asg
    and lvl at them (the head, K4: one launch) against the warm
    instance, run a bounded eps=1 repair from the existing prices
    (``_solve``: K2, K3, the sorts), and compact the changed placements
    into one int64 log row for the one result fetch (the tail, K7: one
    launch; ``log_width`` entries, into ``log_row`` when given). The
    trailing ``report`` mask stays on the device; only the change-cap
    overflow path fetches it. With ``carry`` (the stream lane) the head
    saves the rows it overwrites and the tail commits the window into
    the carry, latching and masking as ``_stream_chain`` says.

    No rebuild, no cold eps ladder: machine-side routes (``dev.dgen``,
    the m->sink / rack legs gathered from ``cost_dev``) are the LAST
    round's prices by design — the periodic correction round re-prices
    everything and differential-verifies what express placed. The
    repair's certificate gates every batch. ``dev.c`` is patched in
    place, and so are its u, w and task_valid (the context's vectors have
    no other reader: a degraded batch drops the context); asg/lvl are
    not (``asg`` may be the warm state). ``rounds`` and ``phases`` come
    back as Python ints; rows_out, asg_out, n_changes, primal and
    n_active are views of the log row.
    """
    Tp, Mp = dev.c.shape
    device = dev.c.device

    # ---- price the arrivals' task-side arcs (shared cost model) ----
    cost_mini = model_fn(mini_inputs)
    u_u = (cost_mini[:kmax]
           + cost_mini[2 * kmax + kmax * pk: 3 * kmax + kmax * pk])
    w_u = cost_mini[kmax: 2 * kmax]
    pc_raw = cost_mini[2 * kmax: 2 * kmax + kmax * pk].reshape(kmax, pk)

    # machine-side legs from the round's priced arc table (the same
    # gathers as _redensify, [Mp]-cheap)
    def gat(idx, fill):
        return torch.where(
            idx >= 0, cost_dev[torch.clamp(idx, min=0).long()], fill
        )

    g = gat(dt.arc_m2s, INF)
    ra_u = torch.clamp(gat(dt.arc_r2m, INF) + g, max=INF)
    scale = dev.scale

    has_pref = (add_pm >= 0) | (add_pr >= 0)
    pm_leg = torch.where(
        add_pm >= 0, g[torch.clamp(add_pm, min=0).long()], 0
    )
    pc_route = torch.where(
        has_pref, torch.clamp(pc_raw + pm_leg, max=INF), INF
    )

    # integer-domain guard for the batch, in int64
    def finmax(x):
        return torch.where(x < INF, x, 0).max()

    cmax_new = torch.maximum(
        torch.maximum(finmax(u_u), finmax(w_u)), finmax(pc_route)
    )
    # the min side masks the unused arrival lanes (add_row == -1): the
    # mini inputs fill them with a synthetic zero pod the cost model
    # still prices, and a model pricing that phantom below zero must
    # not fail the domain check of every batch
    arr_valid = add_row >= 0
    cmin_new = torch.minimum(
        torch.where(arr_valid, u_u, 0).min(),
        torch.minimum(
            torch.where(arr_valid, w_u, 0).min(),
            torch.where(has_pref, pc_route, 0).min(),
        ),
    )
    domain_ok = (cmin_new >= 0) & (
        2 * cmax_new.to(I64) * scale < MAX_SCALED_COST
    )

    def sc(x):
        # int32 times the Python-int scale wraps; the where() discards
        # the INF-saturated lanes before anything reads them
        return torch.where(x >= INF, INF, x * scale).to(I32)

    u_s, w_s = sc(u_u), sc(w_u)
    pc_s = sc(pc_route)
    ra_s = sc(ra_u)

    # ---- the head (K4): the arrival rows and scatters, one launch ----
    asg0, lvl0 = _write_arrival_rows(
        dev, dt, w_s, u_s, pc_s, add_row, add_pm, add_pr, ra_s, asg, lvl,
        carry.saved if carry is not None else None)
    dev2 = dataclasses.replace(dev, smax=smax)

    # ---- bounded eps=1 repair from the existing prices ----
    asg_f, lvl_f, floor_f, gap, conv, rounds, phases, _ = _solve(
        dev2, asg0, lvl0, floor, 1, alpha=alpha, max_rounds=max_rounds,
        smax=smax, analytic_init=False, syncs=syncs,
    )

    # ---- the tail (K7): report, count, ordered compaction, objective
    # (and the stream's commit), one launch with no host read ----
    cap = min(change_cap, Tp)
    if log_row is None:
        log_row = torch.empty(log_width(cap), dtype=I64, device=device)
    report = torch.empty(Tp, dtype=torch.bool, device=device)
    c2 = dev2.c
    cost = c2
    if isinstance(c2, RowBlocks):
        cost = table_gather(c2, torch.clamp(asg_f, 0, Mp - 1).long())
    commit = None
    if carry is not None:
        first = c2.shards()[0][0] if isinstance(c2, RowBlocks) else c2
        commit = Commit(
            live=carry.live, lvl_f=lvl_f, floor_f=floor_f, w_n=dev2.w,
            s_n=dev2.s, add_row=add_row, c_saved=carry.saved[0], c=first,
            u=carry.u, w=carry.w, valid=carry.valid, asg=carry.asg,
            lvl=carry.lvl, s=carry.s, floor=carry.floor,
        )
    stream_commit(log_row, report, dev2.task_valid, asg0, asg_f, dev2.u,
                  cost, Mp, conv, domain_ok, change_cap, commit)
    rows_out, asg_out = log_row[:cap], log_row[cap: 2 * cap]
    n_changes, primal, n_active = (log_row[2 * cap + i] for i in (0, 4, 5))

    return (dev2, asg_f, lvl_f, floor_f, gap, conv, rounds, phases,
            rows_out, asg_out, n_changes, domain_ok, primal, n_active,
            report, log_row)


def _stream_chain(
    dev: DenseInstance,
    dt: DenseTopology,
    cost_dev,
    windows,       # K tuples (mini, add_row, add_pm, add_pr, patch[1, 3, pw])
    asg, lvl, floor,
    *,
    model_fn,
    kmax: int,
    pk: int,
    alpha: int,
    max_rounds: int,
    smax: int,
    change_cap: int,
    syncs: SyncCounter | None = None,
):
    """The stream lane: K express windows back to back on the device,
    with no host read of their own (the reference's ``_stream_chain``,
    one ``lax.scan``; here a host loop over the windows).

    Each window replays what the synced lane does per window: the
    window's retire/removal/slot patch (K5, out of place: the carry into
    the flush's window buffers),
    then ``_express_step`` with the carry: pricing, the head (K4: the
    arrival rows, their old contents saved), the eps=1 repair, and the
    tail (K7 ``stream_commit``; under a mesh, then K7's restore in every
    other shard): the compaction, the certificate latch ``live`` (an
    int32[1] on the device), the in-device auto-retire of the window's
    placements, the latched select of the carry, the undo of K4's rows
    in a dead window, and the masked log row. A dead
    window still runs its repair from the frozen carry, as the
    reference's scan does, so every window's conv, domain_ok, n_changes
    and rounds match it; its outputs read as masked.

    ``asg``/``lvl``/``floor`` are overwritten in place (pass copies);
    ``dev``'s u/w/s/task_valid and c likewise carry the stream's state.
    Returns ``(carry, log, rounds)``: carry = (c, u, w, s, valid, asg,
    lvl, floor, live), log an int64 [K, log_width(change_cap)] device
    tensor of the masked per-window logs (the flush's one fetch), rounds
    the windows' repair rounds (host ints)."""
    Tp, Mp = dev.c.shape
    device = dev.c.device
    c = dev.c
    shards = (c.shards() if isinstance(c, RowBlocks)
              else [(c, 0, Tp, device)])
    carry = _StreamCarry(
        live=torch.ones(1, dtype=I32, device=device), u=dev.u, w=dev.w,
        valid=dev.task_valid, asg=asg, lvl=lvl, s=dev.s, floor=floor,
        saved=[torch.empty((kmax, Mp), dtype=I32, device=d)
               for *_, d in shards],
    )
    cap = min(change_cap, Tp)
    log = torch.empty((len(windows), log_width(cap)), dtype=I64,
                      device=device)
    rounds_all = []
    # the window's patched vectors, one set a flush: window k + 1's K5
    # writes them only after window k's K7 (the last reader of w/s/valid/u
    # here) on the same stream, and reads nothing but the carry
    state = (carry.u, carry.w, carry.valid, carry.s, carry.asg, carry.lvl)
    buffers = tuple(torch.empty_like(x) for x in state)
    for k, (mini, add_row, add_pm, add_pr, patch) in enumerate(windows):
        u1, w1, valid1, s1, asg1, lvl1 = _express_patch(state, patch,
                                                        buffers)
        dev_w = DenseInstance(
            c=c, u=u1, w=w1, dgen=dev.dgen, s=s1, task_valid=valid1,
            scale=dev.scale, cmax=dev.cmax, smax=smax,
        )
        *_, rounds, _phases = _express_step(
            dev_w, dt, cost_dev, mini, asg1, lvl1, carry.floor,
            add_row, add_pm, add_pr,
            model_fn=model_fn, kmax=kmax, pk=pk, alpha=alpha,
            max_rounds=max_rounds, smax=smax, change_cap=change_cap,
            syncs=syncs, carry=carry, log_row=log[k],
        )[:8]
        # under a mesh the other shards undo their own rows of a dead
        # window, reading the verdict K7 just wrote to ``live``
        for (b, r0, _r1, d), saved in zip(shards[1:], carry.saved[1:]):
            stream_restore(to_dev(carry.live, d), to_dev(add_row, d), saved,
                           b, Tp, r0)
        rounds_all.append(rounds)
    return ((c, carry.u, carry.w, carry.s, carry.valid, carry.asg, carry.lvl,
             carry.floor, carry.live), log, rounds_all)


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
    mesh=None,
):
    """The whole resident round on the device: cost model → densify →
    auction → channel/objective finalize → decision stats. When
    ``warm_start`` is False the warm_* arguments are ignored. ``mesh``
    lays the table out as row blocks (``_redensify``).

    Returns the reference's 14-tuple: (asg, lvl, floor, gap, converged,
    rounds, phases, ch, primal, domain_ok, chosen, alt, cost, dev), with
    ``rounds``/``phases`` as Python ints."""
    cost = model_fn(inputs_dev)
    dev, domain_ok, pc_s, ra_s = _redensify(
        dt, cost, n_prefs=n_prefs, smax=smax, mesh=mesh
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
    # host machine-side cost inputs of the round, kept for the express
    # lane's mini pricing
    machine_kwargs: dict | None = None
    # the scale lane: the machine-class plan the solve ran over (None =
    # all-pairs) and the base topology's real machine slots
    agg_plan: object = None
    base_slots: object = None
    # set by finish_round on first join; guards double-finish
    consumed: bool = False


@dataclasses.dataclass(frozen=True)
class ExpressArrival:
    """One new pending pod for the express lane, in builder-column
    vocabulary: ``prefs`` are the (machine_idx, rack_idx, weight) rows
    ``FlowGraphBuilder.task_arc_rows`` resolves — the SAME single-event
    column patch the incremental builder applies, so the periodic
    correction round builds an identical graph for this pod."""

    uid: str
    wait_rounds: int = 0
    cpu_milli: int = 0
    mem_kb: int = 0
    prefs: tuple = ()    # ((machine_idx | -1, rack_idx | -1, weight), ...)


@dataclasses.dataclass
class ExpressBatch:
    """One coalesced watch-event batch for ``express_round``.

    ``retires`` are pods whose binding POST landed since the last
    dispatch (row deactivates, target machine's capacity drops one);
    ``removals`` are pending pods that left the cluster; ``slot_deltas``
    are bare capacity changes (a running pod completing frees a seat)."""

    arrivals: list[ExpressArrival] = dataclasses.field(
        default_factory=list)
    retires: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)      # (uid, machine name)
    removals: list[str] = dataclasses.field(default_factory=list)
    slot_deltas: list[tuple[str, int]] = dataclasses.field(
        default_factory=list)      # (machine name, +/- seats)


@dataclasses.dataclass
class ExpressOutcome:
    """One express dispatch's result. ``ok=False`` means the batch
    DEGRADED (reason says why): nothing was placed, the express context
    is invalidated, and the events simply wait for the next full round
    — never a silent wrong placement (the in-kernel certificate gates
    every batch)."""

    ok: bool
    placements: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)      # (uid, machine name)
    cost: int = 0
    rounds: int = 0
    reason: str = ""
    # ok=True but something degraded LOUDLY along the way (change-cap
    # overflow's full placement fetch): the bridge traces/counts an
    # EXPRESS_DEGRADE with this reason while still binding everything
    degrade_reason: str = ""
    timings: dict = dataclasses.field(default_factory=dict)


class ExpressDegrade(Exception):
    """This batch cannot take the express path. Raised internally by
    the patch/repair chain (``express_round`` turns it into an
    ``ExpressOutcome(ok=False)``) and by ``express_maps`` when
    finalizing the context degrades (the bridge invalidates + counts)."""


@dataclasses.dataclass
class _ExpressContext:
    """The warm device state the express lane patches between rounds.

    Created by ``finish_round`` on every certified dense round (express
    lane on), dropped by the next ``begin_round``. Device handles keep
    the round's densified table / topology / priced arcs resident; the
    host maps are built LAZILY on first express use so rounds that see
    no inter-round events pay nothing beyond the references.
    """

    dev: object                 # device DenseInstance (the warm table)
    dt: object                  # device DenseTopology
    cost_dev: object            # device priced arc table (round prices)
    meta: object                # GraphMeta of the round's build
    topo: object                # base TransportTopology
    agg_plan: object            # AggregatePlan | None
    assignment: np.ndarray      # round's final machine assignment
    machine_kwargs: dict        # host machine-side cost inputs (stale
                                # by design: "from the existing prices")
    model_fn: object
    n_prefs: int
    smax: int
    Tp: int
    Mp: int
    T: int
    scale: int
    # ---- lazy host maps (built on first express dispatch) ----
    ready: bool = False
    uid_row: dict | None = None
    row_uid: dict | None = None
    free_rows: list | None = None
    midx: dict | None = None
    rack_idx: dict | None = None
    # aggregation: machine -> column, members in column order, column
    # bounds into that order, members per column, free seats per real
    # machine (express placements take them, completions restore them)
    col_of: np.ndarray | None = None
    col_bounds: np.ndarray | None = None
    col_order: np.ndarray | None = None
    members_per_col: np.ndarray | None = None
    member_slots_left: np.ndarray | None = None
    # rebalancing mode: running rows frozen out of the express auction
    # (their seats become used capacity), applied with the first batch
    pending_freeze: tuple | None = None
    batches: int = 0
    # uids the stream lane already retired on the device (K7's
    # auto-retire): the later confirm-driven retire for the same uid
    # must not apply its seat decrement twice
    stream_retired: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class StreamOutcome:
    """One stream flush's result (K windows, one result fetch).

    ``ok=False`` with ``failed_window >= 0`` means a window failed its
    certificate: ``placements`` still carries every good window's
    bindings (the windows before ``failed_window``: the latch froze the
    carry there, so they are what a synced replay would have produced),
    the context is invalidated, and the failed window's events onward
    wait for the next full round."""

    ok: bool
    placements: list[tuple[str, str, int]] = dataclasses.field(
        default_factory=list)     # (uid, machine name, window idx)
    window_costs: list[int] = dataclasses.field(default_factory=list)
    window_rounds: list[int] = dataclasses.field(default_factory=list)
    windows: int = 0              # real (non-padding) windows flushed
    failed_window: int = -1
    reason: str = ""
    fetches: int = 0              # result fetches of this flush (1)
    timings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _StreamWindow:
    """One accumulated-but-not-flushed stream window: the host event
    encoding and its device copy (uploaded at accumulate time, so the
    next batch's uploads overlap an in-flight flush)."""

    host: tuple                   # (mini, add_row, add_pm, add_pr,
                                  #  prow, pcol, pdelta)
    dev: tuple                    # device copy of ``host``
    pw: int                       # patch width the window was padded to
    journal: list                 # [(row, old_uid|None, new_uid|None)]
    prep_ms: float = 0.0
    upload_ms: float = 0.0


@dataclasses.dataclass
class _InflightStream:
    """A flushed stream batch: its K windows run on a background worker
    that ends with the batch's one result fetch; the next batch's
    windows accumulate meanwhile."""

    future: object                # _AsyncFetch -> (log, rounds, carry, t)
    ctx: object                   # the _ExpressContext it solved under
    n_windows: int                # real windows (the rest are no-op pads)
    journals: list                # per real window row-map journals
    row_uid_end: dict             # ctx.row_uid snapshot at flush time
    fetches: SyncCounter = dataclasses.field(default_factory=SyncCounter)
    timings: dict = dataclasses.field(default_factory=dict)
    t_dispatch: float = 0.0


# ---------------------------------------------------------------------------
# per-tenant warm contexts (the service lane, poseidon_tpu_torch/service/)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantContext:
    """One tenant's warm solve context in the multi-tenant service: the
    tenant's ``DenseState`` from its last certified in-bucket solve
    (valid while its padded dims stay (Tp, Mp)) and its grow-only
    padding floors, so a tenant whose counts oscillate across a bucket
    boundary keeps one padded shape."""

    state: DenseState | None = None
    Tp: int = 0
    Mp: int = 0
    # grow-only bucket floors (reset by the pool on budget overflow)
    e_floor: int = 16     # arc-count bucket (cost-input pricing pad)
    t_floor: int = 16     # task-axis padding bucket
    m_floor: int = 16     # machine-axis padding bucket
    p_floor: int = 0      # preference-column floor
    s_floor: int = 1      # smax (max free slots) floor
    ti_floor: int = 1     # build_cost_inputs_host per-task pad
    mi_floor: int = 1     # build_cost_inputs_host per-machine pad


class TenantWarmPool:
    """Warm per-tenant contexts keyed by tenant id. Single-threaded by
    contract (the service's pump thread); it only holds references to
    the device tensors the member solves produced."""

    def __init__(self) -> None:
        self._ctx: dict[str, TenantContext] = {}

    def context(self, tenant_id: str) -> TenantContext:
        ctx = self._ctx.get(tenant_id)
        if ctx is None:
            ctx = TenantContext()
            self._ctx[tenant_id] = ctx
        return ctx

    def warm(self, tenant_id: str, Tp: int, Mp: int) -> DenseState | None:
        """The tenant's warm handle, or None when cold or the tenant
        outgrew its padding bucket (a shape change means a cold solve)."""
        ctx = self._ctx.get(tenant_id)
        if ctx is None or ctx.state is None:
            return None
        if ctx.Tp != Tp or ctx.Mp != Mp:
            return None
        return ctx.state

    def commit(
        self, tenant_id: str, state: DenseState, Tp: int, Mp: int
    ) -> None:
        ctx = self.context(tenant_id)
        ctx.state = state
        ctx.Tp = Tp
        ctx.Mp = Mp

    def invalidate(self, tenant_id: str | None = None) -> None:
        """Drop warm state (one tenant, or everyone when None). Floors
        survive: the next solve is cold, the tenant did not shrink."""
        if tenant_id is not None:
            ctx = self._ctx.get(tenant_id)
            if ctx is not None:
                ctx.state = None
            return
        for ctx in self._ctx.values():
            ctx.state = None

    def reset_floors(self, tenant_id: str) -> None:
        """Budget-overflow escape: a floor raised by a past larger
        cluster must not keep re-padding a fitting tenant over budget."""
        self._ctx[tenant_id] = TenantContext()


class ResidentSolver:
    """Owns the device-resident solve chain + warm state across rounds.

    Warm state (``DenseState``) stays on the device between rounds; it
    survives task-set churn because a stale assignment is only a
    starting point — the auction's violator release and certificate
    repair it exactly.

    ``express_lane`` keeps each certified round's densified table,
    topology and prices resident on the device, so small watch-event
    batches re-solve between rounds (``express_round``: K5 patches, K4
    arrival rows, a bounded eps=1 repair, one result fetch), and
    ``stream_windows`` K > 1 runs K such windows per result fetch
    (``stream_window`` / ``stream_flush`` / ``stream_finish``).

    The scale lane: ``topk_prefs`` caps each task's preference columns,
    ``aggregate_classes`` solves over machine equivalence classes (and
    refuses the ``random`` model, which prices by machine index), and
    ``mesh_width`` lays the table out over a task-axis mesh of that
    width: the first ``mesh_width`` CUDA devices, ``[device] *
    mesh_width`` on the CPU, or the list ``mesh_devices`` (which may
    repeat a device). Width 0 is the plain layout.
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
        mesh_devices=None,
        express_lane: bool = False,
        express_max_batch: int = 16,
        express_change_cap: int = 256,
        stream_windows: int = 0,
        metrics=None,
    ):
        self.device = resolve_device(device)
        # ---- the scale lane (graph/aggregate.py + parallel/) ----
        # mesh_width 0 = the plain layout; >= 1 lays the table out over
        # a task-axis mesh of that width (width 1 is a one-shard mesh,
        # bit-identical to plain). aggregate_classes collapses the
        # machine axis to its equivalence classes before densify;
        # topk_prefs caps preference columns (0 = keep all).
        self.aggregate_classes = aggregate_classes
        self.topk_prefs = topk_prefs
        self._mesh = None
        if mesh_devices is not None:
            self._mesh = make_mesh(mesh_width or None, devices=mesh_devices)
        elif mesh_width and self.device.type == "cuda":
            self._mesh = make_mesh(mesh_width)
        elif mesh_width:
            self._mesh = make_mesh(devices=[self.device] * mesh_width)
        if self._mesh is not None and self._mesh.first != self.device:
            raise ValueError(
                f"the mesh's first device {self._mesh.first} is not the "
                f"solver's device {self.device}"
            )
        self.mesh_width = self._mesh.width if self._mesh is not None else 0
        # the machine classes the last round solved over (0 = all-pairs)
        self.last_round_classes = 0
        self.alpha = alpha
        # observability (obs.SchedulerMetrics or None): the solver
        # reports its fetch count and warm/express-context liveness at
        # finish time, from host values it already holds
        self.metrics = metrics
        # ---- the express lane (between-rounds fast path) ----
        # express_lane keeps each certified round's densified table /
        # topology / prices resident so small watch-event batches
        # re-solve with ONE result fetch (express_round);
        # express_max_batch bounds arrivals per dispatch (a fixed
        # shape), and express_change_cap bounds the compacted changed-
        # placement fetch (more changes than that cost one more fetch)
        self.express_lane = express_lane
        self.express_max_batch = express_max_batch
        self.express_change_cap = express_change_cap
        self._express: _ExpressContext | None = None
        # lifetime express result fetches (one per express batch, one
        # more on a change-cap overflow)
        self.express_fetches = 0
        # ---- the stream lane (K express windows per result fetch) ----
        # stream_windows K > 1 accumulates K express windows and runs
        # them back to back with ONE result fetch of their K logs
        # (_stream_chain); 0/1 = off (synced express)
        self.stream_windows = stream_windows
        # grow-only per-window patch-width bucket (one padded shape for
        # the retire/removal/slot slice of every window)
        self._stream_pw_floor = 16
        self._stream_pending: list[_StreamWindow] = []
        self._stream_inflight: _InflightStream | None = None
        # lifetime stream fetches (one per flush), the window count the
        # last flush carried, and the last flush's result fetches (1)
        self.stream_fetches = 0
        self.last_stream_windows = 0
        self.last_stream_fetches = 0
        # flushed-but-unjoined stream batches a full round abandoned
        # (the daemon drains streams before every tick: nonzero means a
        # driver bug worth surfacing)
        self.stream_abandoned = 0
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
        self._solves = 0
        # host mirror of the warm state (asg/lvl/floor from the round's
        # own fetch): the replay/restore seed, stale once an express
        # batch has moved the warm state on the device
        self._warm_seed: tuple | None = None
        self._warm_mutated = True

    def reset(self) -> None:
        """Drop the warm state (and the express context): the next
        round starts cold."""
        self._warm = None
        self._express = None
        self._warm_seed = None
        self._warm_mutated = True
        self._stream_pending = []
        self._stream_inflight = None

    @property
    def express_ready(self) -> bool:
        """True when a warm express context exists (a certified dense
        round finished and no full round has begun since)."""
        return self._express is not None

    def invalidate_express(self) -> None:
        """Drop the express context: the next batches wait for a full
        round. Pending (unflushed) stream windows reference the context,
        so they drop with it; their events are already in bridge state
        and wait for the round like any degraded batch."""
        self._express = None
        self._stream_pending = []

    # ---- the stream lane (K windows per result fetch) -------------------

    @property
    def stream_pending_windows(self) -> int:
        """Accumulated-but-not-flushed stream windows."""
        return len(self._stream_pending)

    @property
    def stream_inflight(self) -> bool:
        """True while a flushed stream batch has not been joined."""
        return self._stream_inflight is not None

    def _stream_abandon(self) -> None:
        """Round-boundary cleanup: drop pending windows and abandon any
        in-flight stream batch (its worker finishes harmlessly; the
        round replaces the device state). Counted, never silent."""
        self._stream_pending = []
        if self._stream_inflight is not None:
            self._stream_inflight = None
            self.stream_abandoned += 1

    def _record_round(self) -> None:
        if self.metrics is not None:
            self.metrics.record_solver_round(
                self.last_round_fetches,
                self._warm is not None,
                self._express is not None,
            )

    @property
    def last_round_fetches(self) -> int:
        """Result fetches of the last dispatch: a round, or an express
        batch (1, 2 on a change-cap overflow)."""
        return self._fetches.count

    @property
    def last_round_loop_syncs(self) -> int:
        """The auction loop's flag reads in the last dispatch (a round
        or an express batch's repair)."""
        return self._loop_syncs.count

    @property
    def last_round_solves(self) -> int:
        """Auction solves of the last round: 1, or 2 when a stale warm
        start did not certify and the round re-ran cold (each solve
        makes one result fetch)."""
        return self._solves

    @property
    def warm(self) -> DenseState | None:
        """The device warm handle carried across rounds (None = cold)."""
        return self._warm

    @property
    def warm_seed_host(self) -> tuple | None:
        """Host (asg, lvl, floor) int32 mirror of the live warm state,
        or None when cold or when an express batch has patched the warm
        state on the device since the last full-state fetch."""
        if self._warm is None or self._warm_mutated:
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
        # under a mesh the warm state lives with the auction's control
        # state, on the mesh's first device (the solver's device)
        self._warm = DenseState(
            asg=torch.from_numpy(asg).to(self.device),
            lvl=torch.from_numpy(lvl).to(self.device),
            floor=torch.from_numpy(floor).to(self.device),
            gap=torch.zeros((), dtype=I64, device=self.device),
            converged=torch.ones((), dtype=torch.bool, device=self.device),
            rounds=0, phases=0,
        )
        self._warm_seed = (asg, lvl, floor)
        self._warm_mutated = False

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
        # a full round supersedes the inter-round express state; drop
        # the context FIRST so its device memory (the retained dense
        # table) is free before this round's chain allocates a new one
        self._express = None
        self._stream_abandon()
        self.last_stream_windows = 0
        self.last_stream_fetches = 0
        self._fetches = SyncCounter()
        self._loop_syncs = SyncCounter()
        self._solves = 0
        self.last_round_classes = 0
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
        # ---- the scale lane: prune prefs, aggregate the machine axis.
        # The BASE topology (original machine axis, pruned pref columns)
        # is what the outcome reports and the oracle degrade prices; the
        # solve runs over the class columns when aggregation is on, and
        # finish_round expands the fetched assignment back ----
        if self.topk_prefs:
            topo = prune_topology_prefs(
                topo, meta.arc_weight, meta.arc_discount, self.topk_prefs,
            )
        base_topo = topo
        T = topo.n_tasks
        if (
            self.small_to_oracle
            and self.oracle_fallback
            and self._warm is None
            and (T == 0 or is_small_instance(T, topo.n_machines))
        ):
            return degrade("small-instance", base_topo, price_on_cpu=True)
        agg_plan = None
        if self.aggregate_classes:
            if resolve_cost_model_name(cost_model) == "random":
                raise ValueError(
                    "aggregate_classes requires a cost model that "
                    "prices machines by their signature; 'random' "
                    "hashes the machine index (see graph/aggregate.py)"
                )
            kw = cost_input_kwargs or {}
            agg_plan = plan_from_signatures(
                base_topo,
                machine_load=kw.get("machine_load"),
                machine_mem_free=kw.get("machine_mem_free"),
                machine_used_slots=kw.get("machine_used_slots"),
            )
            topo = aggregate_topology(base_topo, agg_plan)
            self.last_round_classes = agg_plan.n_cols
        self._p_floor = max(topo.max_prefs, self._p_floor)
        P = self._p_floor
        dt_host = pad_topology(
            topo, t_min=self._t_floor, m_min=self._m_floor,
            p_min=self._p_floor,
        )
        Tp = dt_host.arc_unsched.shape[0]
        Mp = dt_host.slots.shape[0]
        try:
            stream_k = (
                self.stream_windows
                if self.express_lane and self.stream_windows > 0
                else 0
            )
            check_table_budget(
                Tp, Mp, mesh_width=max(self.mesh_width, 1),
                stream_windows=stream_k,
                stream_ints=_stream_event_ints(
                    self.express_max_batch, P,
                    self._stream_pw_floor, self._mi_floor,
                ) if stream_k else 0,
            )
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
            return degrade("memory-envelope", base_topo)
        if self.metrics is not None:
            # the budget guard's per-device estimate, beside the live
            # bytes the daemon records (host arithmetic only)
            self.metrics.record_predicted_bytes(_budget_need(
                Tp, Mp, 1, 0, 0, max(self.mesh_width, 1)
            ))
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
            arrays=arrays, meta=meta, topo=base_topo, dt=dt,
            inputs_dev=inputs_dev, model_fn=model_fn, n_prefs=P,
            smax=smax, max_rounds=max_rounds, warm_used=warm is not None,
            Tp=Tp, Mp=Mp, T=T, n_machines=base_topo.n_machines,
            agg_plan=agg_plan, base_slots=base_topo.slots,
            timings=timings, t_dispatch=time.perf_counter(),
            machine_kwargs={
                k: (cost_input_kwargs or {}).get(k)
                for k in ("machine_load", "machine_mem_free",
                          "machine_used_slots")
            },
        )
        fetches, loop_syncs = self._fetches, self._loop_syncs
        self._inflight = True
        inflight.future = _AsyncFetch(
            lambda: self._dispatch(inflight, warm, fetches, loop_syncs)
        )
        return inflight

    def _dispatch(self, inflight: InflightSolve, warm: DenseState | None,
                  fetches: SyncCounter, loop_syncs: SyncCounter):
        """Run the chain and fetch its result (on the round's worker,
        with the solver's device current: a thread starts on device 0)."""
        self._solves += 1
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._run_chain(inflight, warm, fetches, loop_syncs)
        return self._run_chain(inflight, warm, fetches, loop_syncs)

    def _run_chain(self, inflight: InflightSolve, warm: DenseState | None,
                   fetches: SyncCounter, loop_syncs: SyncCounter):
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
            syncs=loop_syncs, mesh=self._mesh,
        )
        fetched = _fetch_result(fetches, asg, ch, chosen, alt, lvl, floor,
                                conv, primal, dom_ok)
        state = DenseState(asg=asg, lvl=lvl, floor=floor, gap=gap,
                           converged=conv, rounds=rounds, phases=phases)
        return fetched, state, cost, dev, time.perf_counter()

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
            res, state, cost_dev, dev, t_done = inflight.future.result(
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
            res, state, cost_dev, dev, _ = self._dispatch(
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
        self._warm_mutated = False
        Mp = inflight.Mp
        asg = res.asg[:T]
        scale = np.int64(T + 1)
        task_cost = res.chosen[:T] // scale
        from poseidon_tpu_torch.graph.deltas import MARGIN_UNKNOWN

        alt64 = res.alt[:T]
        task_margin = np.where(
            alt64 >= int(INF), MARGIN_UNKNOWN, alt64 // scale - task_cost,
        )
        plan = inflight.agg_plan
        if plan is not None:
            # the solve ran over class columns: expand the winning class
            # assignment back to real machines (current placements kept,
            # so deltas are genuine moves)
            cols = np.where(
                (asg >= 0) & (asg < plan.n_cols), asg, -1
            ).astype(np.int32)
            asg = expand_assignment(
                plan, inflight.base_slots, inflight.meta.task_current, cols,
            )
        else:
            asg = np.where(
                (asg >= 0) & (asg < Mp) & (asg < inflight.n_machines),
                asg, -1,
            ).astype(np.int32)
        if self.express_lane:
            # keep this round's device instance warm for the express
            # lane (host maps are built lazily on first express use)
            self._express = _ExpressContext(
                dev=dev,
                dt=inflight.dt,
                cost_dev=cost_dev,
                meta=inflight.meta,
                topo=topo,
                agg_plan=inflight.agg_plan,
                assignment=asg,
                machine_kwargs=inflight.machine_kwargs or {},
                model_fn=inflight.model_fn,
                n_prefs=max(inflight.n_prefs, 1),
                smax=inflight.smax,
                Tp=inflight.Tp,
                Mp=Mp,
                T=T,
                scale=T + 1,
            )
        self._record_round()
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

    # ---- the express lane ------------------------------------------------

    def _express_finalize(self, ctx: _ExpressContext) -> None:
        """Build the context's host maps on first express use (off the
        round's critical path; the one O(T) walk is the uid<->row map a
        whole inter-round window of batches then shares)."""
        if ctx.ready:
            return
        ctx.uid_row = {u: i for i, u in enumerate(ctx.meta.task_uids)}
        ctx.row_uid = {i: u for u, i in ctx.uid_row.items()}
        ctx.free_rows = list(range(ctx.Tp - 1, ctx.T - 1, -1))
        ctx.midx = {n: i for i, n in enumerate(ctx.meta.machine_names)}
        ctx.rack_idx = {n: i for i, n in enumerate(ctx.meta.rack_names)}
        plan = ctx.agg_plan
        if plan is not None:
            ctx.col_of = plan.col_of_machine
            order = np.argsort(plan.col_of_machine, kind="stable")
            ctx.col_order = order
            ctx.col_bounds = np.searchsorted(
                plan.col_of_machine[order], np.arange(plan.n_cols + 1),
            )
            ctx.members_per_col = np.bincount(
                plan.col_of_machine, minlength=plan.n_cols
            )
            # free seats per REAL machine: the round's base free slots
            # minus its placements (express placements take seats at
            # report time; completions restore them)
            left = np.asarray(ctx.topo.slots, np.int64).copy()
            placed = ctx.assignment[ctx.assignment >= 0]
            left -= np.bincount(placed, minlength=len(left))
            ctx.member_slots_left = np.maximum(left, 0)
        # rebalancing mode: running rows are NOT express-movable (rebal
        # deltas stay round-only), so freeze them — deactivate the row,
        # turn the seat into used capacity at the machine the round
        # SEATED it on (its solved assignment; the bridge invalidates
        # the context whenever actuation diverges from that: failed
        # migrations, preemptions, deferred deltas)
        cur = np.asarray(ctx.meta.task_current)
        run_rows = np.flatnonzero(cur >= 0)
        if len(run_rows):
            tgt = ctx.assignment[run_rows]
            if (tgt < 0).any():
                raise ExpressDegrade(
                    "running task preempted by the round; express "
                    "waits for the next context"
                )
            cols = ctx.col_of[tgt] if ctx.col_of is not None else tgt
            ctx.pending_freeze = (
                run_rows.astype(np.int32), cols.astype(np.int32),
            )
            for i in run_rows.tolist():
                u = ctx.row_uid.pop(i, None)
                if u is not None:
                    ctx.uid_row.pop(u, None)
                ctx.free_rows.append(i)
        ctx.ready = True

    def express_maps(self):
        """(machine_idx, rack_idx) of the express context's round —
        what the bridge resolves arrival preference rows against (the
        builder's ``task_arc_rows`` vocabulary). None when no context
        is live. Raises ``ExpressDegrade`` when finalizing the context
        fails (e.g. a running task the round preempted) — the context
        stays set so the caller's invalidate path counts and traces
        the degrade before dropping it."""
        ctx = self._express
        if ctx is None:
            return None
        self._express_finalize(ctx)
        return ctx.midx, ctx.rack_idx

    def _express_col(self, ctx: _ExpressContext, machine_idx: int) -> int:
        """The solve column of a machine (its class under aggregation)."""
        return (
            int(ctx.col_of[machine_idx]) if ctx.col_of is not None
            else machine_idx
        )

    def _express_member(self, ctx: _ExpressContext, col: int) -> str:
        """Expand a winning solve column to a real machine name (class
        -> first member with a free seat, in canonical order: the
        express analog of ``expand_assignment``'s fill pass)."""
        if ctx.agg_plan is None:
            if col >= len(ctx.meta.machine_names):
                raise ExpressDegrade(f"placement on padding col {col}")
            return ctx.meta.machine_names[col]
        lo, hi = ctx.col_bounds[col], ctx.col_bounds[col + 1]
        members = ctx.col_order[lo:hi]
        avail = ctx.member_slots_left[members] > 0
        if not avail.any():
            raise ExpressDegrade(f"class {col} overfull on expansion")
        m = int(members[int(np.argmax(avail))])
        ctx.member_slots_left[m] -= 1
        return ctx.meta.machine_names[m]

    def _express_mini_inputs(
        self, ctx: _ExpressContext, arrivals: list[ExpressArrival],
        kmax: int, pk: int,
    ):
        """Host CostInputs for the arrivals' task-side arcs: a mini arc
        table (unsched + cluster + pref + unsched->sink per slot) fed
        through ``build_cost_inputs_host`` with the ROUND's machine
        aggregates, so express pricing is the same registry model over
        the same input construction as the full round. Unused lanes
        hold a synthetic zero pod (``_express_step`` masks them)."""
        E = kmax * (3 + pk)
        kind = np.full(E, -1, np.int8)
        a_task = np.zeros(E, np.int32)
        a_machine = np.full(E, -1, np.int32)
        a_weight = np.zeros(E, np.int32)
        ks = np.arange(kmax, dtype=np.int32)
        kind[:kmax] = int(ArcKind.TASK_TO_UNSCHED)
        kind[kmax: 2 * kmax] = int(ArcKind.TASK_TO_CLUSTER)
        u2s = 2 * kmax + kmax * pk
        kind[u2s: u2s + kmax] = int(ArcKind.UNSCHED_TO_SINK)
        a_task[:kmax] = ks
        a_task[kmax: 2 * kmax] = ks
        a_task[u2s: u2s + kmax] = ks
        wait = np.zeros(kmax, np.int32)
        cpu = np.zeros(kmax, np.int64)
        mem = np.zeros(kmax, np.int64)
        uids = [""] * kmax
        for k, a in enumerate(arrivals):
            uids[k] = a.uid
            wait[k] = a.wait_rounds
            cpu[k] = a.cpu_milli
            mem[k] = a.mem_kb
            for j, (m, _r, wgt) in enumerate(a.prefs):
                i = 2 * kmax + k * pk + j
                kind[i] = int(
                    ArcKind.TASK_TO_MACHINE if m >= 0
                    else ArcKind.TASK_TO_RACK
                )
                a_task[i] = k
                a_machine[i] = m
                a_weight[i] = wgt
        zero = np.zeros(0, np.int32)
        mini_meta = GraphMeta(
            node_role=np.zeros(0, np.int8),
            arc_kind=kind,
            arc_task=a_task,
            arc_machine=a_machine,
            arc_rack=np.full(E, -1, np.int32),
            arc_weight=a_weight,
            arc_discount=np.zeros(E, np.int32),
            task_wait=wait,
            task_current=np.full(kmax, -1, np.int32),
            task_node=zero,
            machine_node=zero,
            node_machine=zero,
            task_uids=uids,
            machine_names=ctx.meta.machine_names,
            rack_names=[],
            job_ids=[],
            n_nodes=0,
            n_arcs=E,
        )
        kw = {
            k: v for k, v in ctx.machine_kwargs.items() if v is not None
        }
        return build_cost_inputs_host(
            E, mini_meta, task_cpu_milli=cpu, task_mem_kb=mem, **kw
        )

    def express_round(self, batch: ExpressBatch) -> ExpressOutcome:
        """Turn one coalesced watch-event batch into bindings WITHOUT a
        round: patch the warm device instance (K5 retires bound rows and
        adjusts slot capacities, K4 activates the priced arrival rows)
        and run the bounded eps=1 repair, with ONE result fetch of only
        the affected placements (counted in ``last_round_fetches``; the
        repair's flag reads in ``last_round_loop_syncs``). Runs on the
        caller's thread with the solver's device current.

        Degrades loudly (``ok=False`` + the context invalidated) on
        anything the patch vocabulary cannot represent or the
        certificate cannot prove — the events then simply wait for the
        next full round. Never raises for a representational miss.
        """
        ctx = self._express
        if ctx is None:
            return ExpressOutcome(ok=False, reason="no-context")
        if self._inflight:
            return ExpressOutcome(ok=False, reason="round-in-flight")
        self._fetches = SyncCounter()
        self._loop_syncs = SyncCounter()
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._express_round(ctx, batch)
        return self._express_round(ctx, batch)

    def _express_round(self, ctx: _ExpressContext,
                       batch: ExpressBatch) -> ExpressOutcome:
        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        try:
            self._express_finalize(ctx)
            kmax = self.express_max_batch
            pk = ctx.n_prefs
            arrivals = batch.arrivals
            if len(arrivals) > kmax:
                raise ExpressDegrade(
                    f"{len(arrivals)} arrivals > --express_max_batch "
                    f"{kmax}"
                )
            # ---- map retires / removals / slot deltas to patches ----
            rows: list[int] = []
            cols: list[int] = []
            deltas: list[int] = []
            if ctx.pending_freeze is not None:
                # first batch of a rebalancing-mode window: freeze the
                # running block out of the express auction
                fr, fc = ctx.pending_freeze
                rows.extend(fr.tolist())
                cols.extend(fc.tolist())
                deltas.extend([-1] * len(fr))
                ctx.pending_freeze = None
            for uid, mname in batch.retires:
                r = ctx.uid_row.pop(uid, None)
                if r is None:
                    raise ExpressDegrade(f"retire of unknown {uid}")
                ctx.row_uid.pop(r, None)
                ctx.free_rows.append(r)
                m = ctx.midx.get(mname)
                if m is None:
                    raise ExpressDegrade(
                        f"retire on unknown machine {mname}"
                    )
                rows.append(r)
                cols.append(self._express_col(ctx, m))
                deltas.append(-1)
            for uid in batch.removals:
                r = ctx.uid_row.pop(uid, None)
                if r is None:
                    raise ExpressDegrade(f"removal of unknown {uid}")
                ctx.row_uid.pop(r, None)
                ctx.free_rows.append(r)
                rows.append(r)
                cols.append(-1)
                deltas.append(0)
            for mname, d in batch.slot_deltas:
                m = ctx.midx.get(mname)
                if m is None:
                    raise ExpressDegrade(
                        f"slot delta on unknown machine {mname}"
                    )
                rows.append(-1)
                cols.append(self._express_col(ctx, m))
                deltas.append(d)
                if ctx.member_slots_left is not None:
                    ctx.member_slots_left[m] = max(
                        ctx.member_slots_left[m] + d, 0
                    )
            # ---- map arrivals to rows + solve-space pref targets ----
            add_row = np.full(kmax, -1, np.int32)
            add_pm = np.full((kmax, pk), -1, np.int32)
            add_pr = np.full((kmax, pk), -1, np.int32)
            for k, a in enumerate(arrivals):
                if a.uid in ctx.uid_row:
                    raise ExpressDegrade(f"duplicate arrival {a.uid}")
                if len(a.prefs) > pk:
                    raise ExpressDegrade(
                        f"{a.uid} has {len(a.prefs)} prefs > the "
                        f"round's pref width {pk}"
                    )
                if not ctx.free_rows:
                    raise ExpressDegrade(
                        "padded task rows exhausted (cluster outgrew "
                        "the round's bucket)"
                    )
                r = ctx.free_rows.pop()
                ctx.uid_row[a.uid] = r
                ctx.row_uid[r] = a.uid
                add_row[k] = r
                for j, (m, rk, _w) in enumerate(a.prefs):
                    if m >= 0:
                        col = self._express_col(ctx, m)
                        if (ctx.members_per_col is not None
                                and ctx.members_per_col[col] != 1):
                            raise ExpressDegrade(
                                f"{a.uid} prefers machine {m} inside "
                                f"a non-singleton class (not pinned "
                                f"at the last round)"
                            )
                        add_pm[k, j] = col
                    else:
                        add_pr[k, j] = rk
            mini_host = self._express_mini_inputs(ctx, arrivals, kmax, pk)
            timings["prep_ms"] = (time.perf_counter() - t0) * 1000

            # ---- upload + patch chunks (K5) + the repair ----
            warm = self._warm
            if warm is None:
                raise ExpressDegrade("no warm state")
            t0u = time.perf_counter()
            device = self.device
            mini_dev = mini_host.to_device(device)
            arr_dev = torch.from_numpy(np.concatenate(
                [add_row[:, None], add_pm, add_pr], axis=1
            )).to(device)
            chunks = _express_patch_chunks(rows, cols, deltas)
            patch_dev = (torch.from_numpy(chunks).to(device)
                         if len(chunks) else None)
            timings["upload_ms"] = (time.perf_counter() - t0u) * 1000
            t_dispatch = time.perf_counter()
            dev = ctx.dev
            asg, lvl, floor = warm.asg, warm.lvl, warm.floor
            if patch_dev is not None:
                # asg/lvl out of place: a degraded batch keeps the warm
                # state; the context's u/w/valid/s in place
                vec = (dev.u, dev.w, dev.task_valid, dev.s)
                *_, asg, lvl = _express_patch((*vec, asg, lvl), patch_dev,
                                              (*vec, None, None))
            (dev2, asg_f, lvl_f, floor_f, gap, conv, rounds, phases,
             *_, report, log_row) = _express_step(
                dev, ctx.dt, ctx.cost_dev, mini_dev, asg, lvl, floor,
                arr_dev[:, 0].contiguous(),
                arr_dev[:, 1: 1 + pk].contiguous(),
                arr_dev[:, 1 + pk:].contiguous(),
                model_fn=ctx.model_fn, kmax=kmax, pk=pk, alpha=self.alpha,
                max_rounds=EXPRESS_FUSE, smax=ctx.smax,
                change_cap=self.express_change_cap,
                syncs=self._loop_syncs,
            )
            # the batch's ONE result fetch: only the affected
            # placements + the certificate bits
            self.express_fetches += 1
            if self.metrics is not None:
                self.metrics.record_express_fetch()
            h = self._fetches.read(log_row)
            n_out = (h.shape[0] - 6) // 2
            rows_np, asg_np = h[:n_out], h[n_out: 2 * n_out]
            n_chg, _ok, conv_h, dom_h, primal_h = (
                int(x) for x in h[2 * n_out: 2 * n_out + 5])
            timings["solve_ms"] = (time.perf_counter() - t_dispatch) * 1000
            if not dom_h:
                raise ExpressDegrade("cost domain exceeded")
            if not conv_h:
                raise ExpressDegrade(
                    f"repair uncertified after {rounds} rounds"
                )
            degrade_reason = ""
            if n_chg > self.express_change_cap:
                # the repair is CERTIFIED — only the compacted log is
                # truncated: degrade LOUDLY to one more fetch of the
                # changed-row mask + assignment; every placement still
                # binds and the context stays warm
                degrade_reason = (
                    f"change_cap: {n_chg} changed placements > "
                    f"cap {self.express_change_cap} (full placement "
                    f"fetch)"
                )
                self.express_fetches += 1
                if self.metrics is not None:
                    self.metrics.record_express_fetch()
                Tp = ctx.Tp
                full = self._fetches.read(
                    torch.cat([report.to(I64), asg_f.to(I64)])
                )
                rows_np = np.flatnonzero(full[:Tp]).astype(np.int32)
                asg_np = full[Tp:][rows_np]
                n_chg = len(rows_np)
            # ---- commit: the patched instance + repaired state ARE
            # the warm state the next round/batch starts from ----
            ctx.dev = dev2
            ctx.batches += 1
            self._warm = DenseState(
                asg=asg_f, lvl=lvl_f, floor=floor_f, gap=gap,
                converged=conv, rounds=rounds, phases=phases,
            )
            # the warm state moved on the device without a full-state
            # fetch: the host mirror is stale until the next round
            self._warm_mutated = True
            placements: list[tuple[str, str]] = []
            for i in range(n_chg):
                r = int(rows_np[i])
                uid = ctx.row_uid.get(r)
                if uid is None:
                    raise ExpressDegrade(
                        f"placement on unmapped row {r}"
                    )
                placements.append(
                    (uid, self._express_member(ctx, int(asg_np[i])))
                )
            return ExpressOutcome(
                ok=True,
                placements=placements,
                cost=primal_h // ctx.scale,
                rounds=rounds,
                degrade_reason=degrade_reason,
                timings=timings,
            )
        except ExpressDegrade as e:
            self._express = None
            return ExpressOutcome(ok=False, reason=str(e),
                                  timings=timings)

    # ---- the stream lane: accumulate / flush / finish --------------------

    def _stream_put(self, host: tuple) -> tuple:
        """Upload one window's host encoding (mini CostInputs, then six
        int32 arrays) to the solver's device: the arrival arrays as they
        are, the patch triple as one K5 backlog int32[1, 3, pw]."""
        mini, *arrays, prow, pcol, pdelta = host
        patch = np.stack([prow, pcol, pdelta])[None]
        return (mini.to_device(self.device),
                *(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in (*arrays, patch)))

    def _stream_apply_freeze(self, ctx: _ExpressContext, warm) -> None:
        """Rebalancing mode's first stream window: the running block's
        freeze is cluster-sized, so it applies at once as the synced
        lane's chunked K5 patch (one upload, one launch, no fetch)
        instead of widening every window's patch slice. The order
        matches the synced lane: the freeze lands before window 0's own
        patch and repair. The warm asg/lvl are patched out of place, as
        the express lane does."""
        fr, fc = ctx.pending_freeze
        ctx.pending_freeze = None
        if not len(fr):
            return
        backlog = torch.from_numpy(_express_patch_chunks(
            fr.tolist(), fc.tolist(), [-1] * len(fr))).to(self.device)
        dev = ctx.dev
        vec = (dev.u, dev.w, dev.task_valid, dev.s)
        *_, asg, lvl = _express_patch((*vec, warm.asg, warm.lvl), backlog,
                                      (*vec, None, None))
        self._warm = dataclasses.replace(warm, asg=asg, lvl=lvl)
        self._warm_mutated = True

    def stream_window(self, batch: ExpressBatch) -> ExpressOutcome:
        """Accumulate one coalesced watch-event window into the pending
        stream batch WITHOUT solving it: encode the window into the
        fixed-shape per-window slices ``_stream_chain`` runs (arrival
        rows at kmax x pk, patches padded to the grow-only patch-width
        bucket) and upload it now, so it overlaps an in-flight flush.
        ``ok=True`` means "accumulated"; placements come back from
        ``stream_flush`` + ``stream_finish``.

        Host maps (uid<->row, free rows) advance at accumulate time
        exactly as the synced lane's, every mutation journaled so the
        finish can roll the map back to each window's view. Degrades
        like ``express_round`` (ok=False; context and pending windows
        dropped; the events wait for the next full round)."""
        ctx = self._express
        if ctx is None:
            return ExpressOutcome(ok=False, reason="no-context")
        if self._inflight:
            return ExpressOutcome(ok=False, reason="round-in-flight")
        if len(self._stream_pending) >= max(self.stream_windows, 1):
            # driver contract: flush at K windows; refuse loudly rather
            # than grow past the batch length
            self._express = None
            self._stream_pending = []
            return ExpressOutcome(
                ok=False, reason="stream buffer full (flush first)"
            )
        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        journal: list[tuple[int, str | None, str | None]] = []
        try:
            self._express_finalize(ctx)
            kmax = self.express_max_batch
            pk = ctx.n_prefs
            arrivals = batch.arrivals
            if len(arrivals) > kmax:
                raise ExpressDegrade(
                    f"{len(arrivals)} arrivals > --express_max_batch "
                    f"{kmax}"
                )
            warm = self._warm
            if warm is None:
                raise ExpressDegrade("no warm state")
            if ctx.pending_freeze is not None:
                with on_device(self.device):
                    self._stream_apply_freeze(ctx, warm)
            # ---- map retires / removals / slot deltas to patches ----
            rows: list[int] = []
            cols: list[int] = []
            deltas: list[int] = []
            for uid, mname in batch.retires:
                if uid in ctx.stream_retired:
                    # K7 already retired this row at placement time: the
                    # confirm-driven twin must not decrement again
                    ctx.stream_retired.discard(uid)
                    continue
                r = ctx.uid_row.pop(uid, None)
                if r is None:
                    raise ExpressDegrade(f"retire of unknown {uid}")
                ctx.row_uid.pop(r, None)
                ctx.free_rows.append(r)
                journal.append((r, uid, None))
                m = ctx.midx.get(mname)
                if m is None:
                    raise ExpressDegrade(
                        f"retire on unknown machine {mname}"
                    )
                rows.append(r)
                cols.append(self._express_col(ctx, m))
                deltas.append(-1)
            for uid in batch.removals:
                r = ctx.uid_row.pop(uid, None)
                if r is None:
                    raise ExpressDegrade(f"removal of unknown {uid}")
                ctx.row_uid.pop(r, None)
                ctx.free_rows.append(r)
                journal.append((r, uid, None))
                rows.append(r)
                cols.append(-1)
                deltas.append(0)
            for mname, d in batch.slot_deltas:
                m = ctx.midx.get(mname)
                if m is None:
                    raise ExpressDegrade(
                        f"slot delta on unknown machine {mname}"
                    )
                rows.append(-1)
                cols.append(self._express_col(ctx, m))
                deltas.append(d)
                if ctx.member_slots_left is not None:
                    ctx.member_slots_left[m] = max(
                        ctx.member_slots_left[m] + d, 0
                    )
            # ---- map arrivals to rows + solve-space pref targets ----
            add_row = np.full(kmax, -1, np.int32)
            add_pm = np.full((kmax, pk), -1, np.int32)
            add_pr = np.full((kmax, pk), -1, np.int32)
            for k, a in enumerate(arrivals):
                if a.uid in ctx.uid_row:
                    raise ExpressDegrade(f"duplicate arrival {a.uid}")
                if len(a.prefs) > pk:
                    raise ExpressDegrade(
                        f"{a.uid} has {len(a.prefs)} prefs > the "
                        f"round's pref width {pk}"
                    )
                if not ctx.free_rows:
                    raise ExpressDegrade(
                        "padded task rows exhausted (cluster outgrew "
                        "the round's bucket)"
                    )
                r = ctx.free_rows.pop()
                ctx.uid_row[a.uid] = r
                ctx.row_uid[r] = a.uid
                journal.append((r, None, a.uid))
                add_row[k] = r
                for j, (m, rk, _w) in enumerate(a.prefs):
                    if m >= 0:
                        col = self._express_col(ctx, m)
                        if (ctx.members_per_col is not None
                                and ctx.members_per_col[col] != 1):
                            raise ExpressDegrade(
                                f"{a.uid} prefers machine {m} inside "
                                f"a non-singleton class (not pinned "
                                f"at the last round)"
                            )
                        add_pm[k, j] = col
                    else:
                        add_pr[k, j] = rk
            mini_host = self._express_mini_inputs(ctx, arrivals, kmax, pk)
            # fixed-width patch slice under a grow-only bucket floor
            pw = pad_bucket(max(len(rows), 1),
                            minimum=self._stream_pw_floor)
            self._stream_pw_floor = max(self._stream_pw_floor, pw)
            prow = np.full(pw, -1, np.int32)
            pcol = np.full(pw, -1, np.int32)
            pdelta = np.zeros(pw, np.int32)
            n = len(rows)
            prow[:n] = rows
            pcol[:n] = cols
            pdelta[:n] = deltas
            timings["prep_ms"] = (time.perf_counter() - t0) * 1000
            host = (mini_host, add_row, add_pm, add_pr, prow, pcol, pdelta)
            t0u = time.perf_counter()
            devt = self._stream_put(host)
            timings["upload_ms"] = (time.perf_counter() - t0u) * 1000
            self._stream_pending.append(_StreamWindow(
                host=host, dev=devt, pw=pw, journal=journal,
                prep_ms=timings["prep_ms"],
                upload_ms=timings["upload_ms"],
            ))
            return ExpressOutcome(ok=True, timings=timings)
        except ExpressDegrade as e:
            self._express = None
            self._stream_pending = []
            return ExpressOutcome(ok=False, reason=str(e), timings=timings)

    def stream_flush(self) -> None:
        """Run the accumulated windows as one ``_stream_chain`` on a
        background worker that ends with the batch's ONE result fetch
        (the K masked window logs). No-op when nothing is pending or a
        batch is already in flight (``stream_finish`` first). Never
        joins: the next batch's windows accumulate meanwhile."""
        if not self._stream_pending:
            return
        if self._stream_inflight is not None:
            return
        ctx = self._express
        warm = self._warm
        if ctx is None or warm is None:
            self._stream_pending = []
            return
        windows = list(self._stream_pending)
        self._stream_pending = []
        K = max(self.stream_windows, 1)
        real = len(windows)
        timings = {
            "prep_ms": sum(w.prep_ms for w in windows),
            "upload_ms": sum(w.upload_ms for w in windows),
        }
        kmax = self.express_max_batch
        pk = ctx.n_prefs
        pw = self._stream_pw_floor
        t0 = time.perf_counter()
        for wdw in windows:
            if wdw.pw != pw:
                # the patch-width floor grew mid-batch: re-pad the
                # earlier windows to the batch's width
                mini, a_r, a_pm, a_pr, pr0, pc0, pd0 = wdw.host
                pr1 = np.full(pw, -1, np.int32)
                pc1 = np.full(pw, -1, np.int32)
                pd1 = np.zeros(pw, np.int32)
                pr1[:len(pr0)] = pr0
                pc1[:len(pc0)] = pc0
                pd1[:len(pd0)] = pd0
                wdw.host = (mini, a_r, a_pm, a_pr, pr1, pc1, pd1)
                wdw.dev = self._stream_put(wdw.host)
                wdw.pw = pw
        if real < K:
            # a short flush pads with no-op windows (no arrivals, no
            # patches), as the reference pads its scan
            noop_host = (
                self._express_mini_inputs(ctx, [], kmax, pk),
                np.full(kmax, -1, np.int32),
                np.full((kmax, pk), -1, np.int32),
                np.full((kmax, pk), -1, np.int32),
                np.full(pw, -1, np.int32),
                np.full(pw, -1, np.int32),
                np.zeros(pw, np.int32),
            )
            noop = _StreamWindow(host=noop_host,
                                 dev=self._stream_put(noop_host), pw=pw,
                                 journal=[])
            windows = windows + [noop] * (K - real)
        timings["stack_ms"] = (time.perf_counter() - t0) * 1000
        # the worker overwrites the carry in place: the warm state's
        # asg/lvl/floor are copied (an abandoned batch leaves the warm
        # start of the next round untouched; the context it patches is
        # dropped with it)
        asg, lvl, floor = warm.asg.clone(), warm.lvl.clone(), \
            warm.floor.clone()
        self._loop_syncs = SyncCounter()
        loop_syncs = self._loop_syncs
        inflight = _InflightStream(
            future=None, ctx=ctx, n_windows=real,
            journals=[w.journal for w in windows[:real]],
            row_uid_end=dict(ctx.row_uid),
            timings=timings, t_dispatch=time.perf_counter(),
        )
        fetches = inflight.fetches
        dev_windows = [w.dev for w in windows]
        change_cap = self.express_change_cap

        def run():
            with on_device(self.device):
                carry, log, rounds = _stream_chain(
                    ctx.dev, ctx.dt, ctx.cost_dev, dev_windows,
                    asg, lvl, floor,
                    model_fn=ctx.model_fn, kmax=kmax, pk=pk,
                    alpha=self.alpha, max_rounds=EXPRESS_FUSE,
                    smax=ctx.smax, change_cap=change_cap,
                    syncs=loop_syncs,
                )
                # the batch's ONE result fetch: K masked window logs
                return fetches.read(log), rounds, carry, time.perf_counter()

        self.stream_fetches += 1
        self.last_stream_windows = real
        if self.metrics is not None:
            self.metrics.record_stream_fetch()
        inflight.future = _AsyncFetch(run)
        self._stream_inflight = inflight

    def stream_finish(self) -> StreamOutcome | None:
        """Join the in-flight stream batch: the ONE fetch carrying K
        windows' masked logs and certificate bits. Commits the final
        carry as the warm device state (the latch makes it the last
        good window's state even when a later window failed), resolves
        each window's compacted rows to uids through the journal
        rollback, and returns the placements in window order. Returns
        None when nothing is in flight; never raises for a failed
        window."""
        inf = self._stream_inflight
        if inf is None:
            return None
        self._stream_inflight = None
        ctx = inf.ctx
        real = inf.n_windows
        try:
            log_np, rnds, carry, t_done = inf.future.result(
                self._fetch_deadline_s()
            )
        except FetchTimeout:
            self.fetch_timeouts += 1
            # the device is suspect: drop everything warm (the round
            # path's abandon) — never a silent wait
            self._express = None
            self._stream_pending = []
            self._warm = None
            self._warm_mutated = True
            return StreamOutcome(
                ok=False, reason="stream fetch deadline missed",
                windows=real, fetches=1, timings=inf.timings,
            )
        self.last_stream_fetches = inf.fetches.count
        timings = dict(inf.timings)
        timings["solve_ms"] = (t_done - inf.t_dispatch) * 1000
        if self._express is not ctx:
            # a degrade invalidated the context between flush and
            # finish: nothing to commit against; the events already wait
            # for the round path
            return StreamOutcome(
                ok=False, reason="context invalidated mid-flight",
                windows=real, fetches=1, timings=timings,
            )
        cap = min(self.express_change_cap, ctx.Tp)
        rows_np = log_np[:, :cap]
        asg_np = log_np[:, cap: 2 * cap]
        nchg_np, live_np, conv_np, dom_np, primal_np = (
            log_np[:, 2 * cap + i] for i in range(5)
        )
        # ---- first failed window (if any) + its reason ----
        failed = -1
        reason = ""
        for wdx in range(real):
            if live_np[wdx]:
                continue
            failed = wdx
            if not dom_np[wdx]:
                reason = f"window {wdx}: cost domain exceeded"
            elif not conv_np[wdx]:
                reason = (
                    f"window {wdx}: repair uncertified after "
                    f"{rnds[wdx]} rounds"
                )
            elif int(nchg_np[wdx]) > self.express_change_cap:
                reason = (
                    f"window {wdx}: change_cap: {int(nchg_np[wdx])} "
                    f"changed placements > cap "
                    f"{self.express_change_cap}"
                )
            else:
                reason = f"window {wdx}: certificate failed"
            break
        good = real if failed < 0 else failed
        # ---- commit the final carry as the warm device state ----
        c_d, u_d, w_d, s_d, valid_d, asg_d, lvl_d, floor_d, _live = carry
        ctx.dev = dataclasses.replace(ctx.dev, c=c_d, u=u_d, w=w_d, s=s_d,
                                      task_valid=valid_d)
        ctx.batches += good
        self._warm = DenseState(
            asg=asg_d, lvl=lvl_d, floor=floor_d,
            gap=torch.zeros((), dtype=I64, device=self.device),
            converged=torch.ones((), dtype=torch.bool, device=self.device),
            rounds=0, phases=0,
        )
        self._warm_mutated = True
        # ---- resolve per-window compacted rows to uids: roll the
        # row<->uid map back through the journals, last window first ----
        Tp = ctx.Tp
        by_win: dict[int, list[tuple[str, int]]] = {}
        cur = inf.row_uid_end
        bad = ""
        for wdx in range(real - 1, -1, -1):
            if wdx < good and not bad:
                out: list[tuple[str, int]] = []
                for i in range(min(int(nchg_np[wdx]), cap)):
                    r = int(rows_np[wdx, i])
                    if r >= Tp:
                        break
                    uid = cur.get(r)
                    if uid is None:
                        bad = (
                            f"window {wdx}: placement on unmapped "
                            f"row {r}"
                        )
                        break
                    out.append((uid, int(asg_np[wdx, i])))
                by_win[wdx] = out
            for row, old, _new in reversed(inf.journals[wdx]):
                if old is None:
                    cur.pop(row, None)
                else:
                    cur[row] = old
        if bad:
            self._express = None
            self._stream_pending = []
            return StreamOutcome(
                ok=False, reason=bad, windows=real, fetches=1,
                timings=timings,
            )
        placements: list[tuple[str, str, int]] = []
        try:
            for wdx in range(good):
                for uid, col in by_win.get(wdx, ()):
                    placements.append(
                        (uid, self._express_member(ctx, col), wdx)
                    )
        except ExpressDegrade as e:
            self._express = None
            self._stream_pending = []
            return StreamOutcome(
                ok=False, reason=str(e), windows=real, fetches=1,
                timings=timings,
            )
        # host twin of K7's auto-retire: free the placed rows and mark
        # the uids so the confirm-driven retire is a no-op
        for uid, _m, _w in placements:
            r = ctx.uid_row.pop(uid, None)
            if r is not None:
                ctx.row_uid.pop(r, None)
                ctx.free_rows.append(r)
            ctx.stream_retired.add(uid)
        window_costs = [int(primal_np[w]) // ctx.scale for w in range(good)]
        window_rounds = [int(rnds[w]) for w in range(good)]
        if failed >= 0:
            self._express = None
            self._stream_pending = []
            return StreamOutcome(
                ok=False, placements=placements,
                window_costs=window_costs, window_rounds=window_rounds,
                windows=real, failed_window=failed, reason=reason,
                fetches=1, timings=timings,
            )
        return StreamOutcome(
            ok=True, placements=placements, window_costs=window_costs,
            window_rounds=window_rounds, windows=real, fetches=1,
            timings=timings,
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
        self._record_round()
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
