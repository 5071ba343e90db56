"""Dense class-price transportation auction, on PyTorch tensors.

The builder taxonomy collapses every scheduling graph to a
transportation problem (``ops/transport.py``): T tasks each pick one of
M machines (capacity ``slots[m]``) or their own unscheduled route. This
module solves that form exactly over a dense ``[Tp, Mp]`` int32 cost
table. It restates ``poseidon_tpu/ops/dense_auction.py`` operation for
operation — the same int32/int64 widths, the same stable lexicographic
sorts, the same tie-breaks — so every output (assignment, levels,
floors, gap, rounds, phases, the debug histogram) is identical bit for
bit to the reference's on the same inputs.

Algorithm (see the reference module for the full derivation): an
eps-scaling auction for the transportation problem with Jacobi rounds
and one price per machine. The loop carries the machine-sorted seat
layout ``(sm, slvl, st)``; each round compacts the unassigned tasks into
a bid window, computes their best and second-best option (the K3 bid
pass) and re-sorts holders and bids together. Production solves run one
phase at eps = 1 from the analytic two-stage market clearing (cold) or
from the previous round's state (warm); exactness is certified by the
primal-dual gap.

The dense passes are hand-written CUDA kernels (``kernels/``): K1
``densify`` builds the table, K2 ``row_options`` is every masked
row-min, K3 ``bid_pass`` is the bid window's pass. On the CPU the same
wrappers run their plain twins.

Row-block mesh. ``DenseInstance.c`` is either one [Tp, Mp] tensor or a
``RowBlocks`` table, whose row block k lives on device k of a
``parallel.TaskMesh`` (the reference lays the same table out over a
``jax.sharding.Mesh``). Every reader of the table goes through the
``table_*`` helpers below: K2, K3 and the gathers run once per shard on
the shard's rows and their [Tp] results are put together on the mesh's
first device, where the seat layout, the [Tp] carry and the [Mp] prices
stay; the certificate's table pass is K8 ``gap_rows``, once per shard.
A plain tensor takes exactly the code path it took before the mesh.

Control flow. The reference runs the whole loop as one
``lax.while_loop`` on the device, and so does the port on the card: the
loop's five bodies (``_Loop``: head, round, phase-shift check, refight,
tighten) are captured once per solve shape and table address into one
CUDA graph (``kernels/loop_graph.py``) whose WHILE and IF nodes K14
``loop_ctl`` sets on the device. A solve copies its start into the
graph's buffers, launches it once and reads nothing until the caller's
result fetch; eps, rounds, phases, done, the fuse and alpha are device
tensors. On CPU tensors (and for a row-block table over several
devices) the same bodies run under the host loop, which reads its
branch flags through a ``SyncCounter``:

- every iteration reads whether the solve is done and whether any task
  is waiting;
- an iteration that finds everyone seated (a phase boundary) reads one
  more flag, whether any standing assignment violates eps-CS, to choose
  between ``refight`` and ``tighten``.

``rounds`` advances on every run-round, refight and tighten step and
``phases`` on every tighten, exactly as in the reference; the fuse
(``max_rounds``) bounds the loop the same way.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import threading

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import pad_bucket
from poseidon_tpu_torch.guards import GuardError, SyncCounter, census
from poseidon_tpu_torch.kernels.bid_pass import bid_pass
from poseidon_tpu_torch.kernels.densify import densify
from poseidon_tpu_torch.kernels.gap_rows import gap_rows
from poseidon_tpu_torch.kernels.loop_graph import GraphCache
from poseidon_tpu_torch.kernels.row_options import row_options
from poseidon_tpu_torch.kernels.seat_sort import INT32, seat_compact, seat_sort
from poseidon_tpu_torch.kernels.top_will import top_will
from poseidon_tpu_torch.ops.transport import (
    CH_CLUSTER,
    CH_PREF,
    CH_UNSCHED,
    TransportInstance,
    TransportResult,
)

I32 = torch.int32
I64 = torch.int64
INF = 2**29                 # saturation cap; all finite values stay below
_NPINF = np.int64(2**48)    # host INF used by TransportInstance
MAX_SCALED_COST = 2**27     # guard: scaled costs must stay below this

# Overflow analysis (the reference's, unchanged): every int32 sum has at
# most two INF-saturated terms (w+d, pc+ra, c+p, b1+eps), so the worst
# partial is 2*INF = 2^30 < 2^31; wider sums (beta, the violator value,
# the dual) are int64 and clipped back. Where a sum can still leave the
# domain (scaling an INF lane in ops/resident.py), PyTorch's int32
# arithmetic wraps in two's complement on the CPU and the card alike,
# as XLA's does, and the lane is discarded by a where().


class CostDomainTooLarge(GuardError):
    """Scaled costs exceed the int32 auction domain; use a fallback."""


class DenseMemoryTooLarge(GuardError):
    """The dense [Tp, Mp] table would exceed the device memory budget;
    use a fallback instead of running out of memory mid-solve."""


# Device-memory envelope for the dense [Tp, Mp] int32 cost table, the
# footprint that dominates the solve (its transients are a small multiple
# of it). Oversize instances raise DenseMemoryTooLarge and the resident
# round degrades loudly to the oracle.
DENSE_TABLE_BUDGET_BYTES = (
    int(os.environ.get("POSEIDON_TPU_TORCH_DENSE_TABLE_BUDGET_MB", "2048"))
    << 20
)


def _budget_need(
    Tp: int, Mp: int, n_variants: int, side_ints_per_variant: int,
    extra_ints: int, mesh_width: int,
) -> int:
    per_device_table = -(-Tp * Mp // max(mesh_width, 1))
    return (per_device_table + side_ints_per_variant) * 4 * n_variants \
        + extra_ints * 4


def max_variants_for(
    Tp: int, Mp: int, side_ints_per_variant: int = 0,
    extra_ints: int = 0, mesh_width: int = 1,
) -> int:
    """Largest ``n_variants`` (batch / bucket width) of this [Tp, Mp]
    shape that fits the budget; 0 if even one instance does not fit.
    The batched lanes (what-if variants, the service's shape-bucket
    dispatcher) size their chunks with this, so an oversize wave splits
    into fitting dispatches instead of raising."""
    base = _budget_need(
        Tp, Mp, 0, side_ints_per_variant, extra_ints, mesh_width
    )
    per = _budget_need(
        Tp, Mp, 1, side_ints_per_variant, extra_ints, mesh_width
    ) - base
    if per <= 0:
        return 0
    return max((DENSE_TABLE_BUDGET_BYTES - base) // per, 0)


def max_stream_windows_for(
    Tp: int, Mp: int, stream_ints: int,
    side_ints_per_variant: int = 0, extra_ints: int = 0,
    mesh_width: int = 1,
) -> int:
    """Largest ``--stream_windows K`` whose event-stream buffer (plus
    its staging twin: 2 copies of K windows x ``stream_ints`` i32 each)
    still fits next to one dense [Tp, Mp] table; 0 if even K=1 does not
    fit."""
    base = _budget_need(
        Tp, Mp, 1, side_ints_per_variant, extra_ints, mesh_width
    )
    per = 2 * max(stream_ints, 1) * 4
    return max((DENSE_TABLE_BUDGET_BYTES - base) // per, 0)


def check_table_budget(
    Tp: int, Mp: int, n_variants: int = 1,
    side_ints_per_variant: int = 0, extra_ints: int = 0,
    mesh_width: int = 1, stream_windows: int = 0,
    stream_ints: int = 0,
) -> None:
    """Raise DenseMemoryTooLarge if ``n_variants`` dense [Tp, Mp] i32
    tables exceed the PER-DEVICE budget
    (POSEIDON_TPU_TORCH_DENSE_TABLE_BUDGET_MB).

    ``side_ints_per_variant`` counts per-variant i32 arrays beyond the
    main table (the what-if batch's perturbed u/w/dgen, the service
    members' channel tables); ``extra_ints`` counts one-off i32
    scratch. ``mesh_width`` is the task-axis shard count of a row-block
    mesh (``parallel/``): each device holds Tp/width rows of the table.
    ``stream_windows`` / ``stream_ints`` charge the stream lane's event
    buffer: K windows x ``stream_ints`` i32, doubled for the staging
    twin.

    An overflow names what would fit: the largest batch
    (``n_variants``) or ``--stream_windows`` of this shape, the smallest
    ``--mesh_width``, and ``--aggregate_classes`` / ``--topk_prefs``,
    which shrink the machine axis to its equivalence classes.
    """
    stream_bytes = 2 * max(stream_windows, 0) * max(stream_ints, 0) * 4
    need = _budget_need(
        Tp, Mp, n_variants, side_ints_per_variant, extra_ints, mesh_width,
    ) + stream_bytes
    if need <= DENSE_TABLE_BUDGET_BYTES:
        return
    batch_hint = ""
    if stream_windows > 0 and stream_ints > 0:
        fit_k = max_stream_windows_for(
            Tp, Mp, stream_ints, side_ints_per_variant, extra_ints,
            mesh_width,
        )
        if fit_k >= 1:
            batch_hint = (
                f"the largest stream batch of this shape that fits "
                f"is --stream_windows={fit_k}; "
            )
    if n_variants > 1:
        fit_b = max_variants_for(
            Tp, Mp, side_ints_per_variant, extra_ints, mesh_width
        )
        if fit_b >= 1:
            batch_hint = (
                f"the largest batch of this shape that fits is "
                f"n_variants <= {fit_b} (shrink the what-if batch / "
                f"service bucket width, --serve_max_batch); "
            )
    fit_w = max(mesh_width, 1)
    while fit_w < 1024 and _budget_need(
        Tp, Mp, n_variants, side_ints_per_variant, extra_ints, fit_w
    ) > DENSE_TABLE_BUDGET_BYTES:
        fit_w *= 2
    if _budget_need(
        Tp, Mp, n_variants, side_ints_per_variant, extra_ints, fit_w
    ) <= DENSE_TABLE_BUDGET_BYTES:
        mesh_hint = (
            f"a task-sharded mesh of width >= {fit_w} would fit "
            f"(--mesh_width={fit_w})"
        )
    else:
        mesh_hint = "no practical mesh width fits this shape alone"
    stream_note = (
        f", {stream_bytes >> 20} MiB double-buffered stream event "
        f"buffer ({stream_windows} windows)"
        if stream_bytes else ""
    )
    raise DenseMemoryTooLarge(
        f"dense cost table {n_variants} x [{Tp}, {Mp}] i32 "
        f"(+ {side_ints_per_variant} side ints/variant, "
        f"{extra_ints} scratch ints, mesh width {max(mesh_width, 1)}"
        f"{stream_note}) "
        f"= {need >> 20} MiB/device exceeds the "
        f"{DENSE_TABLE_BUDGET_BYTES >> 20} MiB budget "
        f"(POSEIDON_TPU_TORCH_DENSE_TABLE_BUDGET_MB); {batch_hint}"
        f"{mesh_hint}; --aggregate_classes collapses the machine axis "
        f"to its equivalence classes (add --topk_prefs=K to cap "
        f"preference columns), typically orders of magnitude fewer "
        f"columns"
    )


@dataclasses.dataclass(frozen=True)
class DenseInstance:
    """Scaled, padded dense transportation instance (tensors on one device)."""

    c: object                 # i32[Tp, Mp] cost of machine m for task t
                              # (INF): a tensor, or RowBlocks on a mesh
    u: torch.Tensor           # i32[Tp] unsched route cost (0 on padding)
    w: torch.Tensor           # i32[Tp] generic (cluster) channel task cost
    dgen: torch.Tensor        # i32[Mp] generic channel machine route cost
    s: torch.Tensor           # i32[Mp] slot capacity (0 on padding)
    task_valid: torch.Tensor  # bool[Tp]
    scale: int                # n_tasks + 1
    cmax: torch.Tensor        # i32 scalar: max finite scaled cost
    smax: int                 # max slots of any machine (top-k width)


@dataclasses.dataclass(frozen=True)
class DenseState:
    """Solver state; feed back in for warm re-solves."""

    asg: torch.Tensor         # i32[Tp]: -1 | machine | Mp (= unsched)
    lvl: torch.Tensor         # i32[Tp] committed price
    floor: torch.Tensor       # i32[Mp] machine reserve price
    gap: torch.Tensor         # i64 scalar: primal - dual (scaled)
    converged: torch.Tensor   # bool scalar
    rounds: torch.Tensor      # i32 scalar
    phases: torch.Tensor      # i32 scalar


def _sc(x: np.ndarray, scale: np.int64) -> np.ndarray:
    v = np.asarray(x, np.int64)
    return np.where(v >= _NPINF, np.int64(INF), v * scale).astype(np.int32)


# the reference's name for the table build: K1 (or its twin on the CPU)
_densify = densify


def member_side_ints(Tp: int, Mp: int, P: int) -> int:
    """Per-instance i32 side tables beyond the dense [Tp, Mp] solve
    table, in the channel-table form ``build_member_tables`` produces:
    u/w/task_valid (Tp each), d/ra/rack_of/slots (Mp each), pc/pm/pr
    (Tp x P each) — what the batched budget accounting charges each
    what-if variant / service bucket member."""
    return 3 * Tp + 4 * Mp + 3 * Tp * max(P, 1)


def build_member_tables(
    inst: TransportInstance, Tp: int, Mp: int, P: int
) -> dict[str, np.ndarray]:
    """Scale + pad one instance's channel tables to (Tp, Mp, P), on the
    host, with exactly the reference's fills and guards. Raises
    ``CostDomainTooLarge`` / ``GuardError`` per the kernel envelope."""
    T = inst.n_tasks
    if T > Tp or inst.n_machines > Mp or inst.max_prefs > P:
        raise ValueError(
            f"instance ({T} x {inst.n_machines}, {inst.max_prefs} "
            f"prefs) does not fit bucket ({Tp} x {Mp}, {P} prefs)"
        )
    scale = np.int64(T + 1)
    cmax = 0
    for arr in (inst.u, inst.w, inst.pref_cost, inst.d, inst.ra):
        a = np.asarray(arr, np.int64)
        fin = a[a < _NPINF]
        if fin.size:
            if (fin < 0).any():
                raise GuardError("auction requires non-negative costs")
            cmax = max(cmax, int(fin.max()))
    # route costs add at most two finite legs before saturation
    cmax_scaled = 2 * cmax * int(scale)
    if cmax_scaled >= MAX_SCALED_COST:
        raise CostDomainTooLarge(
            f"scaled cost domain {cmax_scaled} exceeds int32 auction "
            f"limit {MAX_SCALED_COST}"
        )

    def pad1(x, size, fill):
        out = np.full(size, fill, np.int32)
        v = np.asarray(x)
        out[: v.shape[0]] = v
        return out

    def pad2(x, shape, fill):
        out = np.full(shape, fill, np.int32)
        v = np.asarray(x)
        out[: v.shape[0], : v.shape[1]] = v
        return out

    Pw = max(P, 1)
    if inst.max_prefs:
        pc = pad2(_sc(inst.pref_cost, scale), (Tp, Pw), INF)
        pm = pad2(inst.pref_machine, (Tp, Pw), -1)
        pr = pad2(inst.pref_rack, (Tp, Pw), -1)
    else:
        pc = np.full((Tp, Pw), INF, np.int32)
        pm = np.full((Tp, Pw), -1, np.int32)
        pr = np.full((Tp, Pw), -1, np.int32)
    return {
        "u": pad1(_sc(inst.u, scale), Tp, 0),
        "w": pad1(_sc(inst.w, scale), Tp, INF),
        "d": pad1(_sc(inst.d, scale), Mp, INF),
        "ra": pad1(_sc(inst.ra, scale), Mp, INF),
        "rack_of": pad1(inst.rack_of, Mp, -1),
        "slots": pad1(inst.slots, Mp, 0),
        "pc": pc,
        "pm": pm,
        "pr": pr,
        "task_valid": np.arange(Tp) < T,
        "scale": np.int32(scale),
        "cmax": np.int32(min(cmax_scaled, int(INF) - 1)),
    }


def build_dense_instance(inst: TransportInstance, device) -> DenseInstance:
    """Scale + pad a host TransportInstance and densify it on ``device``."""
    T, M, P = inst.n_tasks, inst.n_machines, inst.max_prefs
    Tp = pad_bucket(max(T, 1))
    Mp = pad_bucket(max(M, 1))
    check_table_budget(Tp, Mp)
    t = build_member_tables(inst, Tp, Mp, P)
    g = {k: torch.as_tensor(v).to(device) for k, v in t.items()
         if k not in ("scale", "cmax")}
    c = _densify(g["w"], g["d"], g["ra"], g["rack_of"], g["slots"],  # noqa: PTA007 -- one-shot solo lane: build_dense_instance plans per instance shape by design; warm rounds ride ResidentSolver's grow-only floors
                 g["pc"], g["pm"], g["pr"], n_prefs=P)
    return DenseInstance(
        c=c, u=g["u"], w=g["w"], dgen=g["d"], s=g["slots"],
        task_valid=g["task_valid"], scale=int(t["scale"]),
        cmax=torch.tensor(int(t["cmax"]), dtype=I32, device=device),
        smax=max(min(int(np.max(t["slots"], initial=0)), Tp), 1),
    )


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

class RowBlocks:
    """The dense [Tp, Mp] table as row blocks over a ``TaskMesh``:
    ``blocks[k]`` holds rows ``bounds[k]`` on ``mesh.devices[k]``. It
    answers ``shape`` and ``device`` (the mesh's first device) like the
    tensor it stands for."""

    def __init__(self, blocks, mesh):
        self.blocks = list(blocks)
        self.mesh = mesh
        Tp = sum(int(b.shape[0]) for b in self.blocks)
        self.shape = torch.Size((Tp, int(self.blocks[0].shape[1])))
        self.bounds = mesh.rows(Tp)
        self.device = mesh.first

    def shards(self):
        """(block, r0, r1, device) of every shard, in row order."""
        return [
            (b, r0, r1, d)
            for b, (r0, r1), d in zip(self.blocks, self.bounds,
                                      self.mesh.devices)
        ]


def to_dev(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` (no copy when it is there already)."""
    return x if x.device == device else x.to(device)


def rows_of(x: torch.Tensor, r0: int, r1: int, device) -> torch.Tensor:
    """Rows [r0, r1) of a task-major tensor on ``device``. A kernel reads
    16-byte vectors, so a slice that starts off that alignment on the
    card is copied."""
    v = x[r0:r1]
    if v.device != device:
        return v.to(device)
    if device.type == "cuda" and v.data_ptr() % 16:
        return v.clone()
    return v


def _cat_first(parts, device) -> torch.Tensor:
    if len(parts) == 1:
        return to_dev(parts[0], device)
    return torch.cat([to_dev(x, device) for x in parts])


def table_row_options(c, p):
    """K2 over the table: (b1v, m1, v2) per row, on the first device."""
    if not isinstance(c, RowBlocks):
        return row_options(c, p)
    outs = [row_options(b, to_dev(p, d)) for b, _r0, _r1, d in c.shards()]
    return tuple(_cat_first([o[i] for o in outs], c.device)
                 for i in range(3))


def table_gather(c, col: torch.Tensor) -> torch.Tensor:
    """``c[t, col[t]]`` for every row t (``col`` int64 [Tp], in range)."""
    if not isinstance(c, RowBlocks):
        return c.gather(1, col[:, None])[:, 0]
    return _cat_first([
        b.gather(1, rows_of(col, r0, r1, d)[:, None])[:, 0]
        for b, r0, r1, d in c.shards()
    ], c.device)


def table_bid_pass(c, p, u, btask, bvalid, eps: torch.Tensor):
    """K3 over the bid window (``eps`` an int32 0-d tensor). Under a
    mesh each shard takes the window entries whose task it owns (the
    others masked invalid, btask made relative to the shard) and the
    owners' outputs are merged."""
    if not isinstance(c, RowBlocks):
        return bid_pass(c, p, u, btask, bvalid, eps)
    out = None
    for b, r0, r1, d in c.shards():
        own = (btask >= r0) & (btask < r1)
        res = bid_pass(
            b, to_dev(p, d), rows_of(u, r0, r1, d),
            to_dev(torch.where(own, btask - r0, 0), d),
            to_dev(bvalid & own, d), to_dev(eps, d), task0=r0,
        )
        res = [to_dev(x, c.device) for x in res]
        out = res if out is None else [
            torch.where(own, x, y) for x, y in zip(res, out)
        ]
    return tuple(out)


def table_top_willingness(c, alt1, alt2, m1, task_valid, s, smax: int):
    """The clearing level of the deflate step (K12): per machine m the
    ``clamp(s - 1, 0, smax - 1)``-th entry of ``top_k(will.T, smax)``,
    will[t, m] = clamp(alt[t, m] - c[t, m]) with alt the task's best
    alternative to machine m, -INF on invalid rows. Under a mesh K12
    makes one pass a shard and merges the shards' candidates."""
    if not isinstance(c, RowBlocks):
        return top_will([(c, alt1, alt2, m1, task_valid)], s, smax)
    return top_will([
        (b, *(rows_of(x, r0, r1, d) for x in (alt1, alt2, m1, task_valid)))
        for b, r0, r1, d in c.shards()
    ], s, smax)


def table_gap_sums(c, u, task_valid, s, lam, asg) -> torch.Tensor:
    """The certificate's table pass under a mesh: K8 on every shard,
    int64 (primal, b1 sum) summed on the first device."""
    parts = [
        to_dev(gap_rows(b, *(rows_of(x, r0, r1, d)
                             for x in (u, task_valid)),
                        to_dev(s, d), to_dev(lam, d),
                        rows_of(asg, r0, r1, d)), c.device)
        for b, r0, r1, d in c.shards()
    ]
    return torch.stack(parts).sum(dim=0)


def _i32(x: int, device) -> torch.Tensor:
    """An int32 scalar made on ``device`` (a fill: no blocking upload
    of host data, as ``torch.tensor(x, device=...)`` would be)."""
    return torch.full((), x, dtype=I32, device=device)


def _task_options(dev: DenseInstance, p, with_values: bool = False):
    """Per-task best/second-best machine values at prices p (K2); with
    ``with_values`` also the [Tp, Mp] values (a plain table only)."""
    b1v, m1, v2 = table_row_options(dev.c, p)
    if with_values:
        return b1v, m1, v2, torch.clamp(dev.c + p[None, :], max=INF)
    return b1v, m1, v2


def _theta_clearing(dev: DenseInstance):
    """Closed-form equilibrium of the generic seat market, cleared twice
    (the second time on willingness raised by each task's preference
    gain at the stage-one prices). See the reference for the economics.

    Returns (asg0, lvl0, lam, theta)."""
    Tp, Mp = dev.c.shape
    device = dev.c.device
    UNS = Mp
    s_pos = dev.s > 0
    d_eff = torch.where(s_pos, dev.dgen, INF)
    # machines sorted by generic route cost (ties by machine index);
    # cumulative seat supply
    order = torch.argsort(d_eff, stable=True)
    sd, sdm, scap = d_eff[order], order.to(I32), dev.s[order]
    cumcap = torch.cumsum(torch.where(sd < INF, scap, 0).to(I64), dim=0)

    def supply_at(x):
        ix = torch.searchsorted(sd, x, right=True)
        return torch.where(
            ix > 0, cumcap[torch.clamp(ix - 1, min=0)],
            torch.zeros((), dtype=I64, device=device),
        )

    def clear(y):
        y_sorted = torch.sort(y).values
        cands = torch.cat([sd, y])
        supply = supply_at(cands)
        demand = Tp - torch.searchsorted(y_sorted, cands, right=True)
        feasible = supply >= demand
        theta = torch.where(feasible, cands, INF).min()
        # seat up to capacity among WEAKLY willing tasks (y >= theta)
        ix = torch.searchsorted(sd, theta[None], right=True)[0]
        idx_t = torch.clamp(torch.clamp(ix - 1, min=0), max=Mp - 1)
        # a one-element index, not a 0-d one: indexing by a 0-d tensor
        # reads it to the host (a sync on the card)
        sup_theta = torch.where(
            ix > 0, cumcap[idx_t.reshape(1)].reshape(()),
            torch.zeros((), dtype=I64, device=device),
        )
        k = torch.minimum(sup_theta, ((y >= theta) & dev.task_valid).sum())
        return theta, k

    y1 = torch.where(dev.task_valid, dev.u - dev.w, -INF)
    theta1, _k1 = clear(y1)
    lam1 = torch.where(s_pos, torch.clamp(theta1 - d_eff, 0, INF), 0)
    # stage two: each task's pref gain over its generic option at the
    # stage-one prices raises its effective willingness
    v1 = _task_options(dev, torch.where(s_pos, lam1, INF))[0]
    gen1 = torch.minimum(
        dev.u,
        torch.clamp(
            dev.w + torch.where(s_pos, d_eff + lam1, INF).min(), max=INF
        ),
    )
    gain = torch.where(
        dev.task_valid, torch.clamp(gen1 - v1, 0, INF), 0
    ).to(I32)
    y = torch.where(
        dev.task_valid,
        torch.clamp(y1.to(I64) + gain, max=INF - 1).to(I32),
        -INF,
    )
    theta, k = clear(y)
    # rank tasks by effective willingness (desc, tid asc); top-k get
    # seats in cheapest-first order via the capacity boundaries
    rt = torch.argsort(-y, stable=True)
    rank = torch.empty(Tp, dtype=I32, device=device)
    rank[rt] = torch.arange(Tp, dtype=I32, device=device)
    seat_machine = sdm[
        torch.clamp(
            torch.searchsorted(cumcap, rank.to(I64), right=True), max=Mp - 1
        )
    ]
    lam = torch.clamp(theta - d_eff, 0, INF)
    lam = torch.where(s_pos, lam, 0)
    seated = (rank < k) & dev.task_valid
    asg0 = torch.where(
        dev.task_valid,
        torch.where(seated, seat_machine, -1),
        UNS,
    ).to(I32)
    lvl0 = torch.where(seated, lam[seat_machine.long()], 0).to(I32)
    return asg0, lvl0, lam, theta


@dataclasses.dataclass
class LoopState:
    """The auction loop's carry (the reference's ``while_loop`` carry)
    and its scalar inputs, all tensors on the solve's device: the
    machine-sorted seat layout, the reserves, eps and the counters."""

    sm: torch.Tensor          # i32[Tp] segment by position
    slvl: torch.Tensor        # i32[Tp] level by position
    st: torch.Tensor          # i32[Tp] task by position
    floor: torch.Tensor       # i32[Mp] machine reserve price
    eps: torch.Tensor         # i32 0-d
    rounds: torch.Tensor      # i32 0-d
    phases: torch.Tensor      # i32 0-d
    done: torch.Tensor        # bool 0-d
    hist: torch.Tensor        # i32[128]
    max_rounds: torch.Tensor  # i32 0-d
    alpha: torch.Tensor       # i32 0-d


class _Loop:
    """The loop of one solve shape: its geometry, its state and its five
    bodies. ``head`` lays out the carry and asks whether anyone waits;
    ``run_round`` is one auction round; ``pre`` is the phase shift's
    violator check; ``refight`` and ``tighten`` are its two outcomes.
    Each body reads the state and writes it in place, with no host read
    and no Python branch on data, so one code runs under the host loop
    (CPU tensors) and inside the loop's CUDA graph. Tensors a body
    leaves for a later one (the layout, the flags, the phase shift's
    asks and violators) are attributes.

    With ``static`` the instance's u, s and task_valid are the loop's own
    buffers, filled by ``load`` (a graph reads its inputs at fixed
    addresses; the table is read where it lies)."""

    def __init__(self, dev: DenseInstance, smax: int, collect_hist: bool,
                 static: bool = False):
        c = dev.c
        Tp, Mp = c.shape
        device = c.device
        if static:
            dev = dataclasses.replace(
                dev, u=torch.empty_like(dev.u), s=torch.empty_like(dev.s),
                task_valid=torch.empty_like(dev.task_valid))
        self.dev = dev
        self.static = static
        self.smax = smax
        self.collect_hist = collect_hist
        self.Tp, self.Mp = Tp, Mp
        self.UNS = Mp            # segment for unscheduled tasks
        self.WAIT = Mp + 1       # for unassigned tasks awaiting a bid slot
        self.DUMP = Mp + 2       # for non-participants (padding tasks)
        self.NSEG = Mp + 3
        self.B = min(Tp, max(1024, Tp // 4))   # bid-window width
        # the sort keys' domains (K13 packs each key into these bits):
        # the segment, the task id (tids and the carried st are
        # permutations of it); the negated level takes the whole range
        self.SEG, self.TASK = (0, self.NSEG - 1), (0, Tp - 1)
        self.tids = torch.arange(Tp, dtype=I32, device=device)
        self.seg_ids = torch.arange(self.NSEG + 1, dtype=I32, device=device)
        self.s_pos = dev.s > 0
        self.k_uns, self.k_wait, self.k_dump, self.k_neg1 = (
            _i32(x, device) for x in (self.UNS, self.WAIT, self.DUMP, -1))
        self.one = torch.ones(1, dtype=I32, device=device)
        z = torch.zeros((), dtype=I32, device=device)
        self.S = LoopState(
            sm=torch.empty(Tp, dtype=I32, device=device),
            slvl=torch.empty(Tp, dtype=I32, device=device),
            st=torch.empty(Tp, dtype=I32, device=device),
            floor=torch.empty(Mp, dtype=I32, device=device),
            eps=z.clone(), rounds=z.clone(), phases=z.clone(),
            done=torch.zeros((), dtype=torch.bool, device=device),
            hist=torch.zeros(128, dtype=I32, device=device),
            max_rounds=z.clone(), alpha=z.clone(),
        )

    # ---- the reference's helpers --------------------------------------

    def to_sorted(self, asg, lvl):
        Mp = self.Mp
        on_m = (asg >= 0) & (asg < Mp)
        km = torch.where(
            on_m, asg,
            torch.where(asg == self.UNS, self.k_uns,
                        torch.where(self.dev.task_valid, self.k_wait,
                                    self.k_dump)),
        )
        kl = torch.where(on_m & (km < Mp), lvl, 0)
        sm, snl, st = seat_sort((km, -kl, self.tids),
                                (self.SEG, INT32, self.TASK))
        return sm, -snl, st

    def layout(self, sm):
        Mp, s = self.Mp, self.dev.s
        bnd = torch.searchsorted(sm, self.seg_ids, out_int32=True)
        segsz = bnd[1: Mp + 1] - bnd[:Mp]
        occ = torch.minimum(segsz, s)
        full = segsz >= s
        rank = self.tids - bnd[torch.clamp(sm, max=self.NSEG - 1).long()]
        in_m = sm < Mp
        seated = in_m & (rank < s[torch.clamp(sm, max=Mp - 1).long()])
        waiting = (in_m & ~seated) | (sm == self.WAIT)
        return bnd, occ, full, seated, waiting

    def to_task(self, sm, slvl, st, seated):
        Tp, device = self.Tp, sm.device
        val = torch.where(
            seated, sm,
            torch.where((sm == self.UNS) | (sm == self.DUMP), self.k_uns,
                        self.k_neg1),
        )
        asg = torch.zeros(Tp, dtype=I32, device=device)
        asg[st.long()] = val
        lvl = torch.zeros(Tp, dtype=I32, device=device)
        lvl[st.long()] = torch.where(seated, slvl, 0)
        return asg, lvl

    def ask(self, slvl, bnd, occ, full, floor):
        last = torch.clamp(bnd[:self.Mp] + occ - 1, 0, self.Tp - 1)
        minlvl = torch.where(occ > 0, slvl[last.long()], INF)
        p = torch.where(full, torch.clamp(minlvl, max=INF), floor)
        return torch.where(self.s_pos, p, INF)

    def _scatter_window(self, base, bpos, vals):
        """``base.at[bpos].set(vals, mode="drop")``: window positions are
        distinct, and the fill position Tp lands in a spare slot that is
        cut off again."""
        ext = torch.cat([base, base.new_zeros(1)])
        ext[bpos.long()] = vals.to(base.dtype)
        return ext[:self.Tp]

    def auction_round(self, lay):
        S, Tp = self.S, self.Tp
        sm, slvl, st = S.sm, S.slvl, S.st
        bnd, occ, full, seated, waiting = lay
        p = self.ask(slvl, bnd, occ, full, S.floor)
        # compact the (few) unassigned tasks into the bid window; any
        # overflow waits in the WAIT segment
        bpos = seat_compact(waiting, self.B)
        bvalid = bpos < Tp
        btask = st[torch.clamp(bpos, max=Tp - 1).long()]
        m1, _b1v, _v2, take_uns, beta = table_bid_pass(
            self.dev.c, p, self.dev.u, btask, bvalid, S.eps
        )
        bids = bvalid & ~take_uns
        # new keys per position: holders keep their seats, everyone
        # else parks in WAIT unless this window gave them a bid
        new_km = torch.where(
            seated, sm,
            torch.where(sm == self.UNS, self.k_uns,
                        torch.where(sm == self.DUMP, self.k_dump,
                                    self.k_wait)),
        )
        new_kl = torch.where(seated, slvl, 0)
        upd_km = torch.where(take_uns, self.k_uns,
                             torch.where(bids, m1, self.k_wait))
        upd_kl = torch.where(bids, beta, 0)
        new_km = self._scatter_window(new_km, bpos, upd_km)
        new_kl = self._scatter_window(new_kl, bpos, upd_kl)
        # holders outrank bidders at equal level
        is_bid = self._scatter_window(
            torch.zeros(Tp, dtype=I32, device=sm.device), bpos, bids.to(I32)
        )
        sm2, snl2, _isb, st2 = seat_sort(
            (new_km, -new_kl, is_bid, st),
            (self.SEG, INT32, (0, 1), self.TASK))
        return sm2, -snl2, st2

    def violators(self, asg, p, eps):
        """Standing assignments more than eps worse than the task's best
        option at the ask prices."""
        dev, Mp = self.dev, self.Mp
        b1v, _, _ = _task_options(dev, p)
        b1 = torch.minimum(b1v, dev.u)
        on_machine = (asg >= 0) & (asg < Mp)
        asg_safe = torch.clamp(asg, 0, Mp - 1).long()
        pa = p[asg_safe]
        cur = torch.where(
            on_machine,
            torch.clamp(
                table_gather(dev.c, asg_safe).to(I64)
                + torch.where(pa >= INF, 0, pa).to(I64),
                max=INF,
            ).to(I32),
            torch.where(asg == self.UNS, dev.u, INF),
        )
        return dev.task_valid & (asg >= 0) & (cur > b1 + eps)

    def deflate(self, p, full, floor, eps):
        """Reverse-auction step for FREE machines: the reserve falls to
        the s_m-th highest willingness-to-pay, minus eps + 1."""
        dev = self.dev
        b1v, m1, v2 = _task_options(dev, p)
        alt1 = torch.minimum(b1v, dev.u)
        alt2 = torch.minimum(v2, dev.u)
        clear = table_top_willingness(dev.c, alt1, alt2, m1,
                                      dev.task_valid, dev.s, self.smax)
        return torch.minimum(
            torch.where(full, torch.minimum(floor, p), floor),
            torch.clamp(clear - eps - 1, 0, INF),
        )

    def release(self, viol):
        """Re-sort the carry with violators (a task-space mask) sent to
        WAIT, into the state."""
        S = self.S
        viol_pos = viol[S.st.long()]
        km = torch.where(viol_pos, self.k_wait, S.sm)
        kl = torch.where(viol_pos, 0, S.slvl)
        s2, nl2, t2 = seat_sort((km, -kl, S.st),
                                (self.SEG, INT32, self.TASK))
        self._store(s2, -nl2, t2)

    def _store(self, sm, slvl, st):
        self.S.sm.copy_(sm)
        self.S.slvl.copy_(slvl)
        self.S.st.copy_(st)

    def _hist_add(self, row: int, value) -> None:
        """hist[min(phases, 31) + row] += value."""
        h = torch.clamp(self.S.phases, max=31).reshape(1).long() + row
        self.S.hist.index_add_(0, h, value.reshape(1))

    # ---- the state ----------------------------------------------------

    def load(self, dev: DenseInstance, asg0, lvl0, floor0, eps0,
             alpha: int, max_rounds: int) -> None:
        """The solve's start: a static loop takes the instance's vectors
        into its buffers; the carry is laid out from (asg0, lvl0) (a warm
        state may carry more holders on a machine than its, possibly
        shrunk, capacity allows; the sorted layout trims it). ``eps0`` is
        an int or an int32 0-d tensor, copied without a read."""
        S = self.S
        if self.static:
            self.dev.u.copy_(dev.u)
            self.dev.s.copy_(dev.s)
            self.dev.task_valid.copy_(dev.task_valid)
            torch.gt(self.dev.s, 0, out=self.s_pos)
        self._store(*self.to_sorted(asg0, lvl0))
        S.floor.copy_(floor0)
        if isinstance(eps0, torch.Tensor):
            S.eps.copy_(eps0)
        else:
            S.eps.fill_(int(eps0))
        S.rounds.zero_()
        S.phases.zero_()
        S.done.zero_()
        S.hist.zero_()
        S.max_rounds.fill_(int(max_rounds))
        S.alpha.fill_(int(alpha))

    # ---- the five bodies ---------------------------------------------

    def head(self) -> None:
        self.lay = self.layout(self.S.sm)
        self.any_waiting = self.lay[4].any()

    def run_round(self) -> None:
        if self.collect_hist:
            self._hist_add(0, self.one)
            self._hist_add(96, self.lay[4].sum(dtype=I32))
        self._store(*self.auction_round(self.lay))
        self.S.rounds.add_(1)

    def pre(self) -> None:
        S = self.S
        bnd, occ, full, seated, _waiting = self.lay
        # task-space asg for the violator check; the re-sorted carry is
        # rebuilt from position-space releases
        val = torch.where(seated, S.sm,
                          torch.where(S.sm >= self.UNS, self.k_uns,
                                      self.k_neg1))
        asg = torch.zeros(self.Tp, dtype=I32, device=val.device)
        asg[S.st.long()] = val
        self.asg = asg
        self.p_now = self.ask(S.slvl, bnd, occ, full, S.floor)
        self.viol_now = self.violators(asg, self.p_now, S.eps)
        self.any_now = self.viol_now.any()

    def refight(self) -> None:
        """Release the violators at the current eps."""
        if self.collect_hist:
            self._hist_add(32, self.viol_now.sum(dtype=I32))
        self.release(self.viol_now)
        self.S.rounds.add_(1)

    def tighten(self) -> None:
        """Deflate free-machine reserves, shrink eps (or finish at eps ==
        1), release the violators the tighter tolerance exposes; at the
        eps = 1 fixpoint a remaining positive reserve on a free machine
        is forced to 0."""
        S = self.S
        bnd, occ, full, _seated, _waiting = self.lay
        next_eps = torch.clamp(
            torch.div(S.eps, S.alpha, rounding_mode="floor"), min=1)
        at_floor = S.eps <= 1
        eps_chk = torch.where(at_floor, S.eps, next_eps)
        f0 = self.deflate(self.p_now, full, S.floor, eps_chk)
        viol = self.violators(
            self.asg, self.ask(S.slvl, bnd, occ, full, f0), eps_chk)
        stranded = ~full & self.s_pos & (f0 > 0)
        force = at_floor & ~viol.any() & stranded.any()
        f1 = torch.where(force & stranded, 0, f0)
        # the reference's inner cond: the check at the forced reserves,
        # which are f0 itself (so the set is viol) when the force is off
        viol2 = self.violators(
            self.asg, self.ask(S.slvl, bnd, occ, full, f1), eps_chk)
        done = at_floor & ~viol2.any() & ~(
            ~full & self.s_pos & (f1 > 0)).any()
        if self.collect_hist:
            self._hist_add(64, viol2.sum(dtype=I32))
        self.release(viol2)
        S.floor.copy_(f1)
        S.eps.copy_(next_eps)
        S.done.copy_(done)
        S.rounds.add_(1)
        S.phases.add_(1)

    def bodies(self) -> dict:
        return {"head": self.head, "round": self.run_round,
                "pre": self.pre, "refight": self.refight,
                "tighten": self.tighten}


def _host_loop(loop: _Loop, max_rounds: int, syncs: SyncCounter,
               trace: list | None = None) -> None:
    """The loop on the host (the plain version, CPU tensors): one read an
    iteration of whether the solve is done and whether anyone waits, and
    at a phase shift one more, whether any assignment violates eps-CS.
    Every iteration is one round, so the fuse is the iteration count.
    ``trace`` receives each iteration's flags and branch."""
    S = loop.S
    for it in range(max_rounds):
        loop.head()
        done, any_waiting = (bool(x) for x in syncs.read(
            torch.stack([S.done, loop.any_waiting])))
        if done:
            if trace is not None:
                trace.append((it, any_waiting, True, None, "exit"))
            return
        if any_waiting:
            loop.run_round()
            branch, any_now = "round", None
        else:
            loop.pre()
            any_now = bool(syncs.read(loop.any_now))
            branch = "refight" if any_now else "tighten"
            loop.refight() if any_now else loop.tighten()
        if trace is not None:
            trace.append((it, any_waiting, False, any_now, branch))


# ---------------------------------------------------------------------------
# the loop as one CUDA graph a solve (the card)
# ---------------------------------------------------------------------------

GRAPH_CACHE_SIZE = 96        # loop graphs kept (LRU): one per table address


@dataclasses.dataclass
class _GraphEntry:
    """One captured loop: the static loop (never run eagerly again: its
    attributes hold the tensors the captured bodies pass between them)
    and its graph. ``free`` is recorded once a solve's certificate has
    read the state; the next solve's stream waits for it."""

    loop: _Loop
    graph: object
    lock: threading.Lock
    free: torch.cuda.Event
    device: torch.device
    stream: object = None

    def run(self, start: tuple) -> None:
        """One solve's loop (the entry's lock held): on the current
        stream, after the previous solve's certificate has read the
        state, load the start and launch the graph."""
        self.stream = torch.cuda.current_stream(self.device)
        self.stream.wait_event(self.free)
        self.loop.load(*start)
        self.graph.launch()

    def release(self) -> None:
        """The certificate has been enqueued: the state is free."""
        self.free.record(self.stream)

    def close(self) -> None:
        self.graph.close()


class TableSlots:
    """Dense tables on the card at fixed addresses, reused from solve to
    solve by one owner (a resident solver, a service dispatcher): the
    loop's graph reads its table where it lies, so a table that keeps
    its address keeps its graph (no capture), and K1 writes each solve's
    table in place (no copy). A slot is handed out again only once
    nothing but the slots holds it (its reference count: the express
    context, a round or stream batch in flight and any view keep theirs),
    else another slot is made. Past ``SHAPES`` shapes the free slots of
    the least recently used let go. CPU tables take no slot."""

    SHAPES = 8

    def __init__(self) -> None:
        self._slots: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, device, shape: tuple, part: int = 0):
        """A free [rows, Mp] int32 table on ``device`` (None on the
        CPU); ``part`` tells a mesh's row blocks apart."""
        device = torch.device(device)
        if device.type == "cpu":
            return None
        key = (device, tuple(shape), part)
        with self._lock:
            slots = self._slots.setdefault(key, [])
            self._slots.move_to_end(key)
            for k in list(self._slots)[:-self.SHAPES]:
                kept = [t for t in self._slots[k] if sys.getrefcount(t) > 3]
                if kept:
                    self._slots[k] = kept
                else:
                    del self._slots[k]
            for t in slots:
                # the list, the loop variable and getrefcount's argument
                if sys.getrefcount(t) == 3:
                    return t
            t = torch.empty(shape, dtype=I32, device=device)
            slots.append(t)
            return t


_graphs = GraphCache(GRAPH_CACHE_SIZE)
_warmed: set = set()
# the loop graphs' captures: (Tp, Mp, smax, table layout, collect_hist, ms)
CAPTURES = _graphs.captures


def graph_key(dev: DenseInstance, smax: int, collect_hist: bool) -> tuple:
    """The loop graph's cache key: the device, Tp, Mp, the bid window,
    smax, the table's layout and address(es), collect_hist. The fuse,
    alpha and eps0 are device inputs, so they are not in it; nor are u,
    s and task_valid, which the solve copies into the graph's buffers."""
    c = dev.c
    Tp, Mp = c.shape
    if isinstance(c, RowBlocks):
        layout = ("rows", tuple(tuple(b) for b in c.bounds))
        addr = tuple(b.data_ptr() for b in c.blocks)
    else:
        layout = ("table",)
        addr = (c.data_ptr(),)
    return (c.device, Tp, Mp, min(Tp, max(1024, Tp // 4)), smax, layout,
            addr, collect_hist)


def uses_graph(c) -> bool:
    """Whether a solve over table ``c`` runs its loop as the graph: a
    table on one CUDA device (a plain tensor, or row blocks all on one
    card). Row blocks over several devices keep the host loop."""
    if isinstance(c, RowBlocks):
        return len({b.device for b in c.blocks}) == 1 \
            and c.blocks[0].device.type == "cuda"
    return c.device.type == "cuda"


def _graph_entry(dev: DenseInstance, smax: int, collect_hist: bool,
                 start: tuple) -> _GraphEntry:
    """The cached graph of this solve's key, or a new capture: the static
    loop is loaded with ``start`` (dev, asg0, lvl0, floor0, eps0, alpha,
    max_rounds), every body runs once eagerly at a shape not seen before
    (kernel builds, launch plans, occupancy queries), then the bodies
    are captured and the graph is built. A failure raises. The entry
    comes back with its lock held (``GraphCache.get``); the caller
    releases it."""
    from poseidon_tpu_torch.kernels.loop_graph import LoopGraph

    key = graph_key(dev, smax, collect_hist)
    device = key[0]

    def make() -> _GraphEntry:
        with torch.cuda.device(device):
            loop = _Loop(dev, smax, collect_hist, static=True)
            loop.load(*start)
            shape = key[:6] + (collect_hist,)
            if shape not in _warmed:
                for body in ("head", "run_round", "pre", "refight", "head",
                             "pre", "tighten"):
                    getattr(loop, body)()
                _warmed.add(shape)
            S = loop.S
            graph = LoopGraph(
                device, loop.bodies(),
                (lambda: loop.any_waiting, lambda: loop.any_now),
                S.rounds, S.max_rounds, S.done)
            # the graph reads the table by its address (in the key); the
            # entry must not keep the tensor, or the table's slot could
            # never be handed out again (TableSlots)
            loop.dev = dataclasses.replace(loop.dev, c=None)
        return _GraphEntry(loop=loop, graph=graph, lock=threading.Lock(),
                           free=torch.cuda.Event(), device=device)

    return _graphs.get(key, make, (key[1], key[2], smax, key[5],
                                   collect_hist))[0]


def _solve(
    dev: DenseInstance,
    asg0: torch.Tensor,
    lvl0: torch.Tensor,
    floor0: torch.Tensor,
    eps0,
    alpha: int,
    max_rounds: int,
    smax: int,
    analytic_init: bool = False,
    collect_hist: bool = False,
    syncs: SyncCounter | None = None,
    trace: list | None = None,
    host_loop: bool = False,
):
    """The auction loop over the machine-sorted seat layout.

    ``eps0`` is an int or a 0-d int32 tensor (never read on the host).
    On a table on one CUDA device the loop runs as one CUDA graph
    (``kernels/loop_graph.py``) and the host reads nothing; elsewhere
    the host loop runs it, its reads counted by ``syncs`` (and its
    iterations recorded in ``trace``). ``host_loop`` runs the host loop
    on the card too: the plain version the graph is held against
    (``chip_smoke.py`` [loop]); no entry point passes it. Returns
    ``(asg, lvl, floor, gap, converged, rounds, phases, hist)`` like the
    reference, ``rounds`` and ``phases`` as int32 0-d tensors (read with
    the caller's fetch).
    """
    syncs = syncs if syncs is not None else SyncCounter()
    if analytic_init:
        asg0, lvl0, floor0, _theta = _theta_clearing(dev)
        eps0 = 1
    start = (dev, asg0, lvl0, floor0, eps0, alpha, max_rounds)
    with contextlib.ExitStack() as held:
        with census("loop.auction"):
            if uses_graph(dev.c) and not host_loop:
                entry = _graph_entry(dev, smax, collect_hist, start)
                held.callback(entry.lock.release)
                entry.run(start)
                loop = entry.loop
            else:
                entry = None
                loop = _Loop(dev, smax, collect_hist)
                loop.load(*start)
                _host_loop(loop, max_rounds, syncs, trace)
        out = _certify(loop, dev)
        if entry is not None:
            entry.release()
    return out


def _certify(loop: _Loop, dev: DenseInstance):
    """The solve's outputs from the final state: the task-space
    assignment and the exactness certificate, primal - dual at the ask
    prices with lam = 0 on every non-full machine (complementary
    slackness)."""
    S = loop.S
    c, s, u, task_valid = dev.c, dev.s, dev.u, dev.task_valid
    Mp, UNS = loop.Mp, loop.UNS
    s_pos = s > 0
    bnd_f, occ_f, full_f, seated_f, _waiting = loop.layout(S.sm)
    asg, lvl = loop.to_task(S.sm, S.slvl, S.st, seated_f)
    floor = S.floor.clone()
    lam = loop.ask(S.slvl, bnd_f, occ_f, full_f, floor)
    lam = torch.where(full_f & s_pos, lam, 0)
    price_mass = (s.to(I64) * lam.to(I64)).sum()
    if isinstance(c, RowBlocks):
        # the table pass per shard (K8), summed in int64
        primal, b1_sum = table_gap_sums(c, u, task_valid, s, lam, asg)
    else:
        b1v, _, _ = _task_options(dev, torch.where(s_pos, lam, INF))
        b1 = torch.minimum(b1v, u)
        on_machine = (asg >= 0) & (asg < Mp)
        c_asg = table_gather(c, torch.clamp(asg, 0, Mp - 1).long())
        per_task = torch.where(
            on_machine, c_asg, torch.where(asg == UNS, u, INF)
        )
        per_task = torch.where(task_valid, per_task, 0)
        primal = per_task.to(I64).sum()
        b1_sum = torch.where(task_valid, b1, 0).to(I64).sum()
    dual = b1_sum - price_mass
    gap = primal - dual
    converged = S.done & (gap >= 0) & (gap < dev.scale)
    return (asg, lvl, floor, gap, converged, S.rounds.clone(),
            S.phases.clone(), S.hist.clone())


def cold_start(inst_dev: DenseInstance, alpha: int = 1024):
    """Canonical cold-start state: (asg0, lvl0, floor0, eps0)."""
    Tp, Mp = inst_dev.c.shape
    device = inst_dev.c.device
    asg0 = torch.where(inst_dev.task_valid, -1, Mp).to(I32)
    lvl0 = torch.zeros(Tp, dtype=I32, device=device)
    floor0 = torch.zeros(Mp, dtype=I32, device=device)
    eps0 = torch.clamp(inst_dev.cmax // alpha, min=1)
    return asg0, lvl0, floor0, eps0


def _solve_warm(dev: DenseInstance, asg0, lvl0, floor0, alpha: int,
                max_rounds: int, smax: int, syncs: SyncCounter | None = None):
    """Warm entry: re-settle a carried state at eps = 1."""
    return _solve(
        dev, asg0, lvl0, floor0, 1, alpha=alpha, max_rounds=max_rounds,
        smax=smax, analytic_init=False, syncs=syncs,
    )


def _solve_cold(dev: DenseInstance, alpha: int, max_rounds: int,
                smax: int, syncs: SyncCounter | None = None):
    """Cold entry: the analytic clearing replaces the placeholder start."""
    asg0, lvl0, floor0, eps0 = cold_start(dev, alpha)
    return _solve(
        dev, asg0, lvl0, floor0, eps0, alpha=alpha, max_rounds=max_rounds,
        smax=smax, analytic_init=True, syncs=syncs,
    )


def default_fuse() -> int:
    """Round fuse: flat 20k (see the reference for why it is not scaled
    with the instance)."""
    return 20_000


def solve_dense(
    inst_dev: DenseInstance,
    *,
    warm: DenseState | None = None,
    alpha: int = 1024,
    max_rounds: int | None = None,
    syncs: SyncCounter | None = None,
) -> DenseState:
    """Run the auction on the instance's device; returns device state.

    ``warm`` (a previous solve's state over the same padded shapes)
    skips the analytic init and re-settles at eps = 1.
    """
    Tp, Mp = inst_dev.c.shape
    smax = inst_dev.smax
    if warm is not None and (
        warm.asg.shape[0] != Tp or warm.floor.shape[0] != Mp
    ):
        warm = None  # cluster outgrew its padding bucket: cold solve
    if max_rounds is None:
        max_rounds = default_fuse()
    if warm is None:
        out = _solve_cold(inst_dev, alpha=alpha, max_rounds=max_rounds,
                          smax=smax, syncs=syncs)
    else:
        out = _solve_warm(inst_dev, warm.asg, warm.lvl, warm.floor,
                          alpha=alpha, max_rounds=max_rounds, smax=smax,
                          syncs=syncs)
    asg, lvl, floor, gap, converged, rounds, phases, _ = out
    return DenseState(
        asg=asg, lvl=lvl, floor=floor, gap=gap, converged=converged,
        rounds=rounds, phases=phases,
    )


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def _channels_for(inst: TransportInstance, asg: np.ndarray) -> np.ndarray:
    """Cheapest channel code per task for a machine assignment."""
    T = inst.n_tasks
    ch = np.full(T, CH_UNSCHED, np.int32)
    on = asg >= 0
    if not on.any():
        return ch
    m = np.maximum(asg, 0)
    w = np.asarray(inst.w, np.int64)
    d = np.asarray(inst.d, np.int64)
    ra = np.asarray(inst.ra, np.int64)
    best = np.where(on, np.minimum(w + d[m], _NPINF), _NPINF)
    ch = np.where(on, CH_CLUSTER, CH_UNSCHED).astype(np.int32)
    for k in range(inst.max_prefs):
        pc = np.asarray(inst.pref_cost[:, k], np.int64)
        hit_m = on & (inst.pref_machine[:, k] == asg)
        val = np.where(hit_m, pc, _NPINF)
        hit_r = on & (inst.pref_rack[:, k] >= 0) & (
            inst.pref_rack[:, k] == inst.rack_of[m]
        )
        val = np.minimum(val, np.where(hit_r, pc + ra[m], _NPINF))
        better = val < best
        best = np.where(better, val, best)
        ch = np.where(better, CH_PREF + k, ch).astype(np.int32)
    return ch


def _objective(inst: TransportInstance, ch: np.ndarray,
               asg: np.ndarray) -> int:
    T = inst.n_tasks
    if T == 0:
        return 0
    m = np.maximum(np.asarray(asg), 0)
    k = np.maximum(np.asarray(ch) - CH_PREF, 0)
    pref_c = np.take_along_axis(
        np.asarray(inst.pref_cost, np.int64), k[:, None], axis=1
    )[:, 0]
    is_rack = np.take_along_axis(
        inst.pref_rack, k[:, None], axis=1
    )[:, 0] >= 0
    per_task = np.where(
        (ch == CH_UNSCHED) | (asg < 0),
        np.asarray(inst.u, np.int64),
        np.where(
            ch == CH_CLUSTER,
            np.asarray(inst.w, np.int64) + np.asarray(inst.d, np.int64)[m],
            pref_c + np.where(is_rack, np.asarray(inst.ra, np.int64)[m], 0),
        ),
    )
    return int(per_task.sum())


def solve_transport_dense(
    inst: TransportInstance,
    *,
    warm: DenseState | None = None,
    alpha: int = 1024,
    max_rounds: int | None = None,
    device=None,
) -> tuple[TransportResult, DenseState | None]:
    """Host-facing wrapper: densify, solve on ``device`` (``None``: the
    card), read the assignment and the certificate back in one fetch."""
    from poseidon_tpu_torch.ops.resident import on_device, resolve_device

    dev = resolve_device(device)
    T = inst.n_tasks
    if T == 0:
        return (
            TransportResult(
                assignment=np.zeros(0, np.int32),
                channel=np.zeros(0, np.int32),
                cost=0, rounds=0, phases=0, converged=True,
            ),
            None,
        )
    with on_device(dev):
        inst_dev = build_dense_instance(inst, dev)
        state = solve_dense(inst_dev, warm=warm, alpha=alpha,
                            max_rounds=max_rounds)
        got = SyncCounter().read(torch.cat([
            state.asg[:T], torch.stack([state.converged.to(I32),
                                        state.rounds, state.phases])]))
    Mp = inst_dev.c.shape[1]
    asg = np.asarray(got[:T], np.int32)
    asg = np.where((asg >= 0) & (asg < Mp) & (asg < inst.n_machines),
                   asg, -1).astype(np.int32)
    ch = _channels_for(inst, asg)
    return (
        TransportResult(
            assignment=asg,
            channel=ch,
            cost=_objective(inst, ch, asg),
            rounds=int(got[T + 1]),
            phases=int(got[T + 2]),
            converged=bool(got[T]),
        ),
        state,
    )
