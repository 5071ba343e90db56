"""Batched scheduling: what-if variants and heterogeneous tenant
instances, one result fetch per batch.

The port of ``poseidon_tpu/ops/batch.py``. Two lanes:

- ``solve_what_if`` (BASELINE config 5): ``n_variants`` perturbed copies
  of one instance — K6 ``perturb`` builds every variant's table in one
  launch with the reference's random bits — solved one after another
  from their analytic cold start, with ONE batched fetch of every
  variant's cost, certificate and assignment at the end;
- ``solve_heterogeneous``: N different instances padded to one shape
  bucket, their channel tables stacked and uploaded once, each member's
  table built by K1 on its own contiguous slice, solved in turn, with
  ONE batched fetch. The service lane's dispatcher
  (``service/dispatch.py``) runs the same member solve with warm
  contexts and grow-only floors.

Host syncs. The reference's per-variant solves are compiled programs
dispatched back to back with no host sync between them. Here each
solve's auction loop runs on the host and reads one small flag tensor
per iteration (counted by ``loop_syncs``); there is no other read
between variants, and the results come back in one counted fetch
(``fetches``). "Compiled once" becomes: no ``nvcc`` build and no new
launch plan after the first batch of a shape.

Exactness: a member's in-bucket solve is the same function as its solo
solve whenever the padded dims agree (identical scaling, densify, cold
start and eps ladder); extra all-absent preference columns are skipped
masks in densify, and ``smax`` only widens the clearing top-k window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import pad_bucket
from poseidon_tpu_torch.guards import SyncCounter
from poseidon_tpu_torch.kernels.perturb import perturb
from poseidon_tpu_torch.ops.dense_auction import (
    I32,
    I64,
    DenseInstance,
    TableSlots,
    _densify,
    _solve,
    build_dense_instance,
    build_member_tables,
    check_table_budget,
    cold_start,
    default_fuse,
    member_side_ints,
)
from poseidon_tpu_torch.ops.resident import on_device, resolve_device
from poseidon_tpu_torch.ops.transport import TransportInstance


@dataclasses.dataclass(frozen=True)
class BatchResult:
    """One entry per variant; arrays are host numpy."""

    costs: np.ndarray        # int64[B] exact objective per variant
    converged: np.ndarray    # bool[B]
    assignments: np.ndarray  # int32[B, T] machine index, or -1 (unsched)
    rounds: np.ndarray       # int32[B]


def _objective(c1, u1, task_valid, asg):
    """The exact scaled objective of an assignment (int64 sum)."""
    Mp = c1.shape[1]
    on_m = (asg >= 0) & (asg < Mp)
    c_asg = c1.gather(1, torch.clamp(asg, 0, Mp - 1).long()[:, None])[:, 0]
    per_task = torch.where(on_m, c_asg, torch.where(asg == Mp, u1, 0))
    return torch.where(task_valid, per_task, 0).to(I64).sum()


def _solve_variant(c, u, w, dg, cm, b: int, s, task_valid, scale: int, *,
                   smax: int, alpha: int, max_rounds: int,
                   syncs: SyncCounter | None = None):
    """Variant ``b``'s full certified solve (analytic cold start, the
    eps ladder) and exact objective, over the stacked tables. Returns
    device (cost, converged, asg, rounds)."""
    c1, u1 = c[b], u[b]
    dev = DenseInstance(
        c=c1, u=u1, w=w[b], dgen=dg[b], s=s, task_valid=task_valid,
        scale=scale, cmax=cm[b], smax=smax,
    )
    asg0, lvl0, floor0, eps0 = cold_start(dev, alpha)
    asg, _lvl, _floor, _gap, converged, rounds, _phases, _ = _solve(
        dev, asg0, lvl0, floor0, eps0, alpha=alpha, max_rounds=max_rounds,
        smax=smax, analytic_init=True, syncs=syncs,
    )
    return _objective(c1, u1, task_valid, asg), converged, asg, rounds


def perturb_costs(
    inst_dev: DenseInstance, n_variants: int, seed: int,
    magnitude_pct: int = 10,
):
    """Deterministic multiplicative jitter on the finite cost entries
    (K6). Variant 0 is the unperturbed instance; every other variant
    scales each finite cost by an independent factor in
    [1 - magnitude_pct%, 1 + magnitude_pct%], drawn as the reference
    draws it. Returns device (c, u, w, dgen, cmax)."""
    return perturb(
        inst_dev.c, inst_dev.u, inst_dev.w, inst_dev.dgen, inst_dev.s,
        n_variants, inst_dev.scale, seed, magnitude_pct,
    )


def _host_assignments(asg_np: np.ndarray, T: int, M: int) -> np.ndarray:
    a = asg_np[..., :T]
    return np.where((a >= 0) & (a < M), a, -1).astype(np.int32)


def solve_what_if(
    inst: TransportInstance,
    *,
    n_variants: int = 64,
    seed: int = 0,
    magnitude_pct: int = 10,
    alpha: int = 1024,
    max_rounds: int = 20_000,
    device=None,
    loop_syncs: SyncCounter | None = None,
    fetches: SyncCounter | None = None,
) -> BatchResult:
    """Solve ``n_variants`` perturbed copies of ``inst``: one K6 launch
    builds the variants, the variants solve one after another with no
    host read beyond their auction loops', and ONE batched fetch brings
    every result back. ``device=None`` is the card."""
    device = resolve_device(device)
    fetches = fetches if fetches is not None else SyncCounter()
    with on_device(device):
        dev = build_dense_instance(inst, device)
        Tp, Mp = dev.c.shape
        # the batch holds n_variants full tables at once, plus each
        # variant's u/w/dgen and the twin's one-off [Tp, Mp] scratch
        check_table_budget(
            Tp, Mp, n_variants,
            side_ints_per_variant=2 * Tp + Mp,
            extra_ints=2 * Tp * Mp,
        )
        c, u, w, dg, cmax = perturb_costs(
            dev, n_variants, seed, magnitude_pct=magnitude_pct
        )
        outs = [
            _solve_variant(
                c, u, w, dg, cmax, b, dev.s, dev.task_valid, dev.scale,
                smax=dev.smax, alpha=alpha, max_rounds=max_rounds,
                syncs=loop_syncs,
            )
            for b in range(n_variants)
        ]
        # ONE batched fetch for ALL variants
        h = fetches.read(torch.cat([
            torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]).to(I64),
            torch.stack([o[3] for o in outs]).to(I64),
            torch.stack([o[2] for o in outs]).to(I64).reshape(-1),
        ]))
    B = n_variants
    T = inst.n_tasks
    asg = h[3 * B:].reshape(B, Tp).astype(np.int32)
    # scaled costs: every per-task term is a multiple of scale
    return BatchResult(
        costs=h[:B].astype(np.int64) // (T + 1),
        converged=h[B: 2 * B].astype(bool),
        assignments=_host_assignments(asg, T, inst.n_machines),
        rounds=h[2 * B: 3 * B].astype(np.int32),
    )


# ---------------------------------------------------------------------------
# the heterogeneous lane: N different instances, one batch, one fetch
# ---------------------------------------------------------------------------

# host channel-table vocabulary for one padded bucket member, in
# stacking order (every entry is one np array; bool for task_valid)
MEMBER_KEYS = (
    "u", "w", "d", "ra", "rack_of", "slots", "pc", "pm", "pr",
    "task_valid", "scale", "cmax",
)


def member_bucket_dims(
    inst: TransportInstance, *, t_min: int = 16, m_min: int = 16,
    p_min: int = 0,
) -> tuple[int, int, int]:
    """(Tp, Mp, P) padding dims for one instance under grow-only floors
    (the ``pad_bucket`` ladder ``build_dense_instance`` uses, so a
    fresh-floor member pads exactly like its solo solve)."""
    Tp = pad_bucket(max(inst.n_tasks, 1), minimum=t_min)
    Mp = pad_bucket(max(inst.n_machines, 1), minimum=m_min)
    return Tp, Mp, max(inst.max_prefs, p_min)


def stack_members(
    members: list[dict[str, np.ndarray]], Bp: int
) -> dict[str, np.ndarray]:
    """Stack member channel tables into one [Bp, ...] host tree.
    ``Bp >= len(members)`` is the batch-axis padding bucket; padding
    slots are zero-filled and never solved."""
    B = len(members)
    if B == 0 or B > Bp:
        raise ValueError(f"{B} members do not fit batch bucket {Bp}")
    out = {}
    for k in MEMBER_KEYS:
        first = np.asarray(members[0][k])
        stacked = np.zeros((Bp,) + first.shape, first.dtype)
        for i, m in enumerate(members):
            stacked[i] = m[k]
        out[k] = stacked
    return out


def upload_members(stacked_host: dict[str, np.ndarray], device) -> dict:
    """ONE upload of a stacked bucket: every channel table as a device
    tensor, plus ``scale`` kept on the host (the solve reads it as an
    int)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in stacked_host.items() if k != "scale"}
    out["scale"] = stacked_host["scale"]
    return out


def _solve_member(
    stacked: dict, b: int, warm_asg, warm_lvl, warm_floor,
    *,
    n_prefs: int,
    smax: int,
    alpha: int,
    max_rounds: int,
    warm_start: bool,
    syncs: SyncCounter | None = None,
    tables: TableSlots | None = None,
):
    """Bucket member ``b``'s full certified solve over the stacked
    channel tables: K1 densifies the member's contiguous slice (into a
    slot of ``tables`` on the card: one address, one loop graph, for
    every member of the bucket), then the
    unchanged ``_solve`` (warm: the eps=1 settle from the tenant's last
    state; cold: the analytic ladder, as its solo solve) and the exact
    scaled objective. Returns device (cost, converged, asg, lvl, floor,
    gap) and (rounds, phases), int32 0-d device tensors."""
    def one(k):
        return stacked[k][b]

    u1, w1 = one("u"), one("w")
    d1, s1 = one("d"), one("slots")
    tv1 = one("task_valid")
    Tp, Mp = u1.shape[0], d1.shape[0]
    c1 = _densify(w1, d1, one("ra"), one("rack_of"), s1, one("pc"),
                  one("pm"), one("pr"), n_prefs=n_prefs,
                  out=None if tables is None else tables.get(
                      u1.device, (Tp, Mp)))
    dev = DenseInstance(
        c=c1, u=u1, w=w1, dgen=d1, s=s1, task_valid=tv1,
        scale=int(stacked["scale"][b]), cmax=one("cmax"), smax=smax,
    )
    if warm_start:
        asg, lvl, floor, gap, converged, rounds, phases, _ = _solve(
            dev, warm_asg, warm_lvl, warm_floor, 1, alpha=alpha,
            max_rounds=max_rounds, smax=smax, analytic_init=False,
            syncs=syncs,
        )
    else:
        asg0, lvl0, floor0, eps0 = cold_start(dev, alpha)
        asg, lvl, floor, gap, converged, rounds, phases, _ = _solve(
            dev, asg0, lvl0, floor0, eps0, alpha=alpha,
            max_rounds=max_rounds, smax=smax, analytic_init=True,
            syncs=syncs,
        )
    cost = _objective(c1, u1, tv1, asg)
    return (cost, converged, asg, lvl, floor, gap), (rounds, phases)


def solve_heterogeneous(
    instances: list[TransportInstance],
    *,
    alpha: int = 1024,
    max_rounds: int | None = None,
    device=None,
    loop_syncs: SyncCounter | None = None,
    fetches: SyncCounter | None = None,
) -> BatchResult:
    """Solve N heterogeneous instances padded to ONE shape bucket: one
    upload, the members solved in turn, one batched fetch. Bucket dims
    are the max over the members' natural pads and every member solves
    cold (the service's dispatcher adds warm contexts, floors and
    chunking around the same member solve). ``device=None`` is the
    card."""
    if not instances:
        return BatchResult(
            costs=np.zeros(0, np.int64),
            converged=np.zeros(0, bool),
            assignments=np.zeros((0, 0), np.int32),
            rounds=np.zeros(0, np.int32),
        )
    device = resolve_device(device)
    fetches = fetches if fetches is not None else SyncCounter()
    if max_rounds is None:
        max_rounds = default_fuse()
    dims = [member_bucket_dims(i) for i in instances]
    Tp = max(t for t, _, _ in dims)
    Mp = max(m for _, m, _ in dims)
    P = max(p for _, _, p in dims)
    B = len(instances)
    members = [build_member_tables(i, Tp, Mp, P) for i in instances]
    check_table_budget(
        Tp, Mp, B, side_ints_per_variant=member_side_ints(Tp, Mp, P),
    )
    smax = max(
        max(min(int(np.max(m["slots"], initial=0)), Tp), 1)
        for m in members
    )
    with on_device(device):
        stacked = upload_members(stack_members(members, B), device)
        zeros_t = torch.zeros(Tp, dtype=I32, device=device)
        zeros_m = torch.zeros(Mp, dtype=I32, device=device)
        outs = [  # noqa: PTA007 -- one-shot convenience lane: solve_heterogeneous plans per shape mix by design; the warm/floored path is BatchDispatcher (service/dispatch.py)
            _solve_member(
                stacked, b, zeros_t, zeros_t, zeros_m,
                n_prefs=P, smax=smax, alpha=alpha, max_rounds=max_rounds,
                warm_start=False, syncs=loop_syncs,
            )
            for b in range(B)
        ]
        # ONE batched fetch for every member
        h = fetches.read(torch.cat([
            torch.stack([o[0][0] for o in outs]),
            torch.stack([o[0][1] for o in outs]).to(I64),
            torch.stack([o[1][0] for o in outs]).to(I64),
            torch.stack([o[0][2] for o in outs]).to(I64).reshape(-1),
        ]))
    asg_all = h[3 * B:].reshape(B, Tp)
    Tmax = max(i.n_tasks for i in instances)
    asg_out = np.full((B, Tmax), -1, np.int32)
    costs = np.zeros(B, np.int64)
    for b, inst in enumerate(instances):
        T = inst.n_tasks
        asg_out[b, :T] = _host_assignments(asg_all[b], T, inst.n_machines)
        costs[b] = int(h[b]) // (T + 1)
    return BatchResult(
        costs=costs,
        converged=h[B: 2 * B].astype(bool),
        assignments=asg_out,
        rounds=h[2 * B: 3 * B].astype(np.int32),
    )
