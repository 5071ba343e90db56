"""Task-axis sharding of the dense auction over a row-block mesh.

The reference (``poseidon_tpu/parallel/sharded.py``) runs the unchanged
auction under GSPMD with the task axis sharded and the machine tables
replicated, and has an explicit ``shard_map`` + ``psum`` certificate.
Here the same two mechanisms, both exact:

- ``solve_dense_sharded``: the unchanged ``solve_dense`` over a
  ``DenseInstance`` whose table is ``RowBlocks``: K2, K3 and the
  table's gathers run once per shard on the shard's rows, and their
  [Tp] results come together on the mesh's first device, where the
  seat-layout sorts, the [Tp] carry and the [Mp] prices stay. GSPMD
  also shards those O(T) vectors; the port keeps them in one place
  (they are O(T + M) ints next to the [Tp, Mp] table), so its
  cross-shard traffic is the shards' row results and the prices.
  Results are bit-identical to one device: the function is the same.
- ``sharded_certificate_gap``: the primal-dual gap with explicit
  per-shard partials. Holder minima and counts per machine (torch, per
  shard) are combined on the first device into the prices ``lam``;
  then K8 ``gap_rows`` reads each shard's rows once for its primal and
  b1 sums, and the int64 partials are added up.

Machine-side state is kept whole (M ints), so nothing of [T, M] size
ever crosses between shards (``collective_account``).
"""

from __future__ import annotations

import dataclasses

import torch

from poseidon_tpu_torch.ops.dense_auction import (
    I32,
    I64,
    INF,
    DenseInstance,
    DenseState,
    RowBlocks,
    solve_dense,
    table_gap_sums,
    to_dev,
    rows_of,
)


def shard_instance(dev: DenseInstance, mesh) -> DenseInstance:
    """Lay the instance out over the mesh: the table as row blocks (one
    per mesh device), the [Tp] and [Mp] vectors on the first device."""
    c = dev.c.blocks if isinstance(dev.c, RowBlocks) else None
    if c is None:
        Tp = dev.c.shape[0]
        c = [rows_of(dev.c, r0, r1, d)
             for (r0, r1), d in zip(mesh.rows(Tp), mesh.devices)]
    first = mesh.first
    return dataclasses.replace(
        dev,
        c=RowBlocks(c, mesh),
        u=to_dev(dev.u, first),
        w=to_dev(dev.w, first),
        dgen=to_dev(dev.dgen, first),
        s=to_dev(dev.s, first),
        task_valid=to_dev(dev.task_valid, first),
        cmax=to_dev(dev.cmax, first),
    )


def solve_dense_sharded(
    sharded: DenseInstance,
    *,
    warm: DenseState | None = None,
    alpha: int = 1024,
    max_rounds: int | None = None,
    syncs=None,
) -> DenseState:
    """Solve an instance laid out by ``shard_instance``: the unchanged
    ``solve_dense``, so converged results match one device bit for bit.
    Taking the laid-out instance (not re-sharding here) keeps a warm
    re-solve free of table traffic."""
    return solve_dense(sharded, warm=warm, alpha=alpha,
                       max_rounds=max_rounds, syncs=syncs)


# The resident round's task-major topology fields (ops/resident.py
# DenseTopology): the reference shards them over the mesh's task axis.
# The port splits them by rows where the table is built (K1 runs once
# per shard over its rows); every field, and the derived [Tp] vectors,
# also stays whole on the first device with the auction's control state.
RESIDENT_TASK_FIELDS = frozenset({
    "arc_unsched", "arc_cluster", "arc_u2s",
    "arc_pref", "pref_machine", "pref_rack",
})


def resident_round_shardings(mesh, dt_host):
    """(inputs placement, topology placement) of one resident round:
    ``"first"`` (on the mesh's first device) or ``"rows"`` (split by
    rows over the mesh, for the per-shard table build) for every field
    of the host ``DenseTopology``; the priced arc table's inputs go to
    the first device."""
    del mesh  # every mesh places the fields alike
    return "first", {
        f.name: ("rows" if f.name in RESIDENT_TASK_FIELDS else "first")
        for f in dataclasses.fields(dt_host)
    }


def _holder_partials(asg, lvl, Mp: int):
    """Per-machine (min level of its holders, holder count) of one
    shard's tasks: the reference's ``segment_min`` / ``segment_sum``."""
    on_machine = (asg >= 0) & (asg < Mp)
    seg = torch.where(on_machine, asg, Mp).long()
    low = torch.full((Mp + 1,), INF, dtype=I32, device=asg.device)
    low = low.scatter_reduce(0, seg, torch.where(on_machine, lvl, INF),
                             "amin", include_self=True)
    cnt = torch.bincount(seg, minlength=Mp + 1)
    return low[:Mp], cnt[:Mp]


def sharded_certificate_gap(dev: DenseInstance, state: DenseState,
                            mesh) -> int:
    """The primal-dual gap of ``state`` from explicit per-shard partials
    (the reference's ``shard_map`` + ``pmax``/``psum``): holder minima
    and counts per shard, combined on the first device into ``lam``;
    K8 per shard for the primal and b1 sums; one int64 subtraction.
    Equals the gap the solve certified. One host read: the gap."""
    if not isinstance(dev.c, RowBlocks):
        dev = shard_instance(dev, mesh)
    c = dev.c
    first = c.device
    Mp = c.shape[1]
    low = cnt = None
    for _b, r0, r1, d in c.shards():
        lo, n = _holder_partials(rows_of(state.asg, r0, r1, d),
                                 rows_of(state.lvl, r0, r1, d), Mp)
        lo, n = to_dev(lo, first), to_dev(n, first)
        low = lo if low is None else torch.minimum(low, lo)
        cnt = n if cnt is None else cnt + n
    s = dev.s
    full = cnt >= s
    lam = torch.where(full & (s > 0), torch.clamp(low, max=INF), 0).to(I32)
    primal, b1_sum = table_gap_sums(c, dev.u, dev.task_valid, s, lam,
                                    state.asg)
    price_mass = (s.to(I64) * lam.to(I64)).sum()
    return int(primal - (b1_sum - price_mass))


_COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-permute",
    "reduce-scatter",
)


def collective_account(sharded: DenseInstance) -> dict[str, dict]:
    """The cross-shard exchanges of one auction round of the sharded
    solve, under the reference's five collective names (its count of
    the compiled loop body's collectives).

    Shard 0 shares the first device; every other shard k exchanges with
    it: the bid pass (K3) sends the prices, the shard's u rows and the
    window (``collective-permute``: one device to another) and brings
    its five window outputs back (``all-gather`` onto the first device).
    Nothing is reduced in a bid round, and no exchange carries the
    [Tp, Mp] table. Returns ``{name: {"count", "bytes", "max_bytes"}}``
    (count of copies, their bytes, the largest copy), zero for the
    names the port does not use.
    """
    c = sharded.c
    if not isinstance(c, RowBlocks):
        raise ValueError("collective_account needs a sharded instance")
    Tp, Mp = c.shape
    B = min(Tp, max(1024, Tp // 4))   # the bid window of _solve
    acct = {op: {"count": 0, "bytes": 0, "max_bytes": 0}
            for op in _COLLECTIVE_OPS}

    def add(op, nbytes):
        a = acct[op]
        a["count"] += 1
        a["bytes"] += nbytes
        a["max_bytes"] = max(a["max_bytes"], nbytes)

    for _b, r0, r1, _d in c.shards()[1:]:
        for nbytes in (4 * Mp, 4 * (r1 - r0), 4 * B, B):
            add("collective-permute", nbytes)   # p, u rows, btask, bvalid
        for nbytes in (4 * B, 4 * B, 4 * B, B, 4 * B):
            add("all-gather", nbytes)   # m1, b1v, v2, take_uns, beta
    return acct
