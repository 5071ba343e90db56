"""K4 ``express_rows``: the express lane's arrival rows of the dense
cost table, written in place, and their plain twin.

Replaces the row build and scatter of
``poseidon_tpu/ops/resident.py:383`` ``_express_step`` (l.486-502). The
CUDA source is ``csrc/express_rows.cu``; its header note gives the
byte bound and the design (one block per arrival lane).
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="express_rows",
    source="poseidon_tpu_torch/kernels/csrc/express_rows.cu",
    replaces="poseidon_tpu/ops/resident.py:486",
)


def express_rows_plain(c, w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s,
                       rack_of, s):
    """The reference lines restated in PyTorch (int32, same order); the
    rows land in ``c`` in place, and ``c`` is returned."""
    Tp, Mp = c.shape
    pk = add_pm.shape[1]
    mids = torch.arange(Mp, dtype=torch.int32, device=c.device)
    row = torch.clamp(w_s[:, None] + dgen[None, :], max=INF)
    for j in range(pk):
        pm_j = add_pm[:, j: j + 1]
        pr_j = add_pr[:, j: j + 1]
        pc_j = pc_s[:, j: j + 1]
        hit_m = (pm_j == mids[None, :]) & (pm_j >= 0)
        row = torch.minimum(row, torch.where(hit_m, pc_j, INF))
        hit_r = (pr_j == rack_of[None, :]) & (pr_j >= 0)
        row = torch.minimum(
            row,
            torch.where(hit_r, torch.clamp(pc_j + ra_s[None, :], max=INF),
                        INF),
        )
    row = torch.where(s[None, :] > 0, row, INF)
    live = (add_row >= 0) & (add_row < Tp)
    c[add_row[live].long()] = row[live]
    return c


def express_rows(c, w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s,
                 rack_of, s):
    """Write the arrival rows into c[Tp, Mp] in place and return it:
    w_s/add_row[kmax], pc_s/add_pm/add_pr[kmax, pk], dgen/ra_s/rack_of/s
    [Mp], all int32. Lanes with ``add_row`` -1 write nothing. CPU
    tensors take the plain twin; CUDA tensors launch K4."""
    args = (c, w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s, rack_of, s)
    if not on_card(*args):
        return express_rows_plain(*args)
    Tp, Mp = c.shape
    kmax, pk = add_pm.shape
    i32 = torch.int32
    ptrs = [
        kernel_arg(w_s, "w_s", i32, (kmax,)),
        kernel_arg(pc_s, "pc_s", i32, (kmax, pk)),
        kernel_arg(add_row, "add_row", i32, (kmax,)),
        kernel_arg(add_pm, "add_pm", i32, (kmax, pk)),
        kernel_arg(add_pr, "add_pr", i32, (kmax, pk)),
    ]
    for t, name in ((dgen, "dgen"), (ra_s, "ra_s"), (rack_of, "rack_of"),
                    (s, "s")):
        ptrs.append(kernel_arg(t, name, i32, (Mp,)))
    ptrs.append(kernel_arg(c, "c", i32, (Tp, Mp)))
    with torch.cuda.device(c.device):
        err = library("express_rows").express_rows_launch(
            *ptrs, kmax, pk, Tp, Mp, stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return c
