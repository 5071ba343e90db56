"""K8 ``gap_rows``: the table pass of the sharded exactness certificate,
and its plain twin.

Replaces the per-shard table reduction of
``poseidon_tpu/parallel/sharded.py:183`` ``_gap_kernel`` (the body
``sharded_certificate_gap`` runs under ``shard_map``). The CUDA source
is ``csrc/gap_rows.cu``; its header note gives the byte bound and the
design. One call covers one row block of the table: the caller sums the
blocks' partials in int64 and subtracts the price mass.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import (
    kernel_arg, on_card, sm_count, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="gap_rows",
    source="poseidon_tpu_torch/kernels/csrc/gap_rows.cu",
    replaces="poseidon_tpu/parallel/sharded.py:183",
)

# warps of one block (csrc/gap_rows.cu GAP_WARPS) and blocks per SM of
# the grid-stride launch
_WARPS = 8
_BLOCKS_PER_SM = 8


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
    grid = max(1, min(-(-rows // _WARPS), sm_count(dev) * _BLOCKS_PER_SM))
    with torch.cuda.device(dev):
        err = library("gap_rows").gap_rows_launch(
            kernel_arg(c, "c", i32, (rows, Mp)),
            kernel_arg(u, "u", i32, (rows,)),
            kernel_arg(task_valid, "task_valid", torch.bool, (rows,)),
            kernel_arg(s, "s", i32, (Mp,)),
            kernel_arg(lam, "lam", i32, (Mp,)),
            kernel_arg(asg, "asg", i32, (rows,)),
            rows, Mp, grid, out.data_ptr(), stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return out
