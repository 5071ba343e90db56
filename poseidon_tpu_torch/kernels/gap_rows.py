"""K8 ``gap_rows``: the table pass of the sharded exactness certificate,
and its plain twin.

Replaces the per-shard table reduction of
``poseidon_tpu/parallel/sharded.py:183`` ``_gap_kernel`` (the body
``sharded_certificate_gap`` runs under ``shard_map``). The CUDA source
is ``csrc/gap_rows.cu``; its header note gives the byte bound and the
design. One call covers one row block of the table: the caller sums the
blocks' partials in int64 and subtracts the price mass.

Its launch plan (``plan``: rows loaded at once, rows a warp, grid,
staged prices) is host
arithmetic, made once per device and shape, so the CPU tests reach it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from poseidon_tpu_torch.kernels import row_stream
from poseidon_tpu_torch.kernels._args import (
    kernel_arg, on_card, sm_count, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import (
    Kernel, check_launch, library, occupancy,
)

INF = 2**29

KERNEL = Kernel(
    name="gap_rows",
    source="poseidon_tpu_torch/kernels/csrc/gap_rows.cu",
    replaces="poseidon_tpu/parallel/sharded.py:183",
)

WARPS = 8                 # warps of one block (csrc/gap_rows.cu GAP_WARPS)
STAGE_MAX = 8_192         # columns whose prices a block stages (32 KiB)


@dataclasses.dataclass(frozen=True)
class Plan:
    rows_at_once: int     # rows a lane loads together (the kernel's R)
    rows_per_warp: int    # every warp's run of rows (the last may be short)
    grid: int             # blocks: one wave on the card
    smem: int             # dynamic shared memory: lam_inf staged, or 0


def rows_at_once(Mp: int) -> int:
    """Rows whose vectors a lane loads together, so that it keeps UNROLL
    (4) 16-byte loads in flight: 4 at Mp <= 128, 2 at Mp <= 256, else
    1."""
    vecs = Mp // 4
    return 4 if vecs <= 32 else 2 if vecs <= 64 else 1


def plan(rows: int, Mp: int, sm_count: int,
         occupancy: Callable[[int, int], int]) -> Plan:
    """Deal ``rows`` rows to one wave of warps: ``occupancy(R, smem)``
    blocks of the kernel for R rows at once fit on one SM, so at most
    ``sm_count * occupancy * WARPS`` warps run at once; each takes
    ``ceil(rows / that)`` consecutive rows, rounded up to a multiple of
    R, and the grid has just enough warps for all of them. Warp w of the
    grid covers rows [w * rows_per_warp, (w + 1) * rows_per_warp) cut at
    ``rows`` (``warp_rows``)."""
    if Mp < 4 or Mp % 4:
        raise ValueError(f"gap_rows: Mp={Mp} must be a positive multiple of 4")
    R = rows_at_once(Mp)
    smem = Mp * 4 if Mp <= STAGE_MAX else 0
    blocks = occupancy(R, smem)
    if blocks < 1:
        raise RuntimeError(f"no gap_rows block of {smem} B shared memory "
                           f"fits on an SM")
    wave = sm_count * blocks * WARPS
    per = max(1, -(-rows // wave))
    per = -(-per // R) * R
    warps = max(1, -(-rows // per))
    return Plan(rows_at_once=R, rows_per_warp=per, grid=-(-warps // WARPS),
                smem=smem)


def warp_rows(p: Plan, rows: int, warp: int) -> range:
    """The rows that warp ``warp`` of the grid reduces (the kernel's
    ``first``/``last``)."""
    first = warp * p.rows_per_warp
    return range(first, min(first + p.rows_per_warp, rows))


PLANS = row_stream.PlanCache(make=plan)


def gap_rows_plain(c, u, task_valid, s, lam, asg):
    """The reference lines restated in PyTorch: int64[2] = (sum of the
    rows' primal terms, sum of their b1 terms)."""
    Mp = c.shape[1]
    lam_inf = torch.where(s > 0, lam, INF)
    v = torch.clamp(c + lam_inf[None, :], max=INF)
    b1 = torch.minimum(v.min(dim=1).values, u)
    on_machine = (asg >= 0) & (asg < Mp)
    c_asg = c.gather(1, torch.clamp(asg, 0, Mp - 1).long()[:, None])[:, 0]
    per_task = torch.where(
        on_machine, c_asg, torch.where(asg == Mp, u, INF)
    )
    per_task = torch.where(task_valid, per_task, 0)
    i64 = torch.int64
    return torch.stack([
        per_task.to(i64).sum(), torch.where(task_valid, b1, 0).to(i64).sum()
    ])


def gap_rows(c, u, task_valid, s, lam, asg):
    """(primal, b1 sum) int64[2] of one row block: c[rows, Mp] int32,
    u/asg[rows] int32, task_valid[rows] bool, s/lam[Mp] int32. CPU
    tensors take the plain twin; CUDA tensors launch K8."""
    if not on_card(c, u, task_valid, s, lam, asg):
        return gap_rows_plain(c, u, task_valid, s, lam, asg)
    rows, Mp = c.shape
    if Mp % 4:
        raise ValueError(f"gap_rows: Mp={Mp} must be a multiple of 4")
    i32 = torch.int32
    dev = c.device
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        lib = library("gap_rows")
        p = PLANS.get(
            dev, rows, Mp, lambda: sm_count(dev),
            lambda R, smem: occupancy(
                KERNEL, lambda *a: lib.gap_rows_occupancy(R, *a), smem),
        )
        err = lib.gap_rows_launch(
            kernel_arg(c, "c", i32, (rows, Mp)),
            kernel_arg(u, "u", i32, (rows,)),
            kernel_arg(task_valid, "task_valid", torch.bool, (rows,)),
            kernel_arg(s, "s", i32, (Mp,)),
            kernel_arg(lam, "lam", i32, (Mp,)),
            kernel_arg(asg, "asg", i32, (rows,)),
            rows, Mp, p.grid, p.rows_per_warp, p.rows_at_once, p.smem,
            out.data_ptr(),
            stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return out
