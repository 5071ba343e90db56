"""K4 ``express_rows``: the head of an express window (the arrival rows
of the dense cost table and every arrival scatter, in one launch), and
its plain twin.

Replaces the row build and the six ``mode="drop"`` scatters of
``poseidon_tpu/ops/resident.py:383`` ``_express_step`` (l.486-507). The
CUDA source is ``csrc/express_rows.cu``; its header note gives the byte
bound and the design (a block per arrival lane, a block per tile of the
[Tp] vectors). The arrival rows must be distinct: the host coalesces
duplicate arrivals before it encodes a window.
"""

from __future__ import annotations

import ctypes

import torch

from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="express_rows",
    source="poseidon_tpu_torch/kernels/csrc/express_rows.cu",
    replaces="poseidon_tpu/ops/resident.py:486",
)


class _Args(ctypes.Structure):
    """``RowsArgs`` of ``csrc/express_rows.cu``: every field 8 bytes."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "w_s", "u_s", "pc_s", "add_row", "add_pm", "add_pr", "dgen", "ra_s",
        "rack_of", "s", "c", "c_saved", "u", "w", "valid", "asg", "lvl",
        "asg0", "lvl0")] + [
        (n, ctypes.c_longlong) for n in (
            "kmax", "pk", "Tp", "Mp", "row0", "c_rows")]


def express_rows_plain(c, w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s,
                       rack_of, s, vectors=None, c_saved=None, row0: int = 0):
    """The reference lines restated in PyTorch (int32, same order), with
    the kernel's contract: the rows ``c`` owns land in it in place (their
    old contents in ``c_saved`` first), the [Tp] vectors are set in
    place, and ``(asg0, lvl0)`` come back new (None without ``vectors``)."""
    rows, Mp = c.shape
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
    local = add_row - row0
    own = (add_row >= 0) & (local >= 0) & (local < rows)
    idx = local[own].long()
    if c_saved is not None:
        c_saved[own] = c[idx]
    c[idx] = row[own]
    if vectors is None:
        return None
    u_s, u, w, valid, asg, lvl = vectors
    hit = (add_row >= 0) & (add_row < u.shape[0])
    r = add_row[hit].long()
    u[r] = u_s[hit]
    w[r] = w_s[hit]
    valid[r] = True
    asg0, lvl0 = asg.clone(), lvl.clone()
    asg0[r] = -1
    lvl0[r] = 0
    return asg0, lvl0


@census_op("express_rows")
def express_rows(c, w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s, rack_of,
                 s, vectors=None, c_saved=None, row0: int = 0):
    """The window's head. ``c`` [rows, Mp] holds the table's rows from
    ``row0`` on (all of it outside a mesh); w_s/add_row [kmax],
    pc_s/add_pm/add_pr [kmax, pk] and dgen/ra_s/rack_of/s [Mp] are int32.
    The arrival rows ``c`` owns are written in place; with ``c_saved``
    int32 [kmax, Mp] each one's old contents go to its lane's row first
    (other lanes' rows are left alone). ``vectors`` = (u_s [kmax], u, w,
    valid, asg, lvl [Tp]) sets u/w/valid at the arrival rows in place and
    returns ``(asg0, lvl0)``, new tensors with -1 / 0 there; without it
    (a mesh shard past the first) the call returns None. Lanes of -1 or
    past the table write nothing. CPU tensors take the plain twin; CUDA
    tensors launch K4."""
    extra = tuple(vectors or ()) + ((c_saved,) if c_saved is not None else ())
    args = (c, w_s, pc_s, add_row, add_pm, add_pr, dgen, ra_s, rack_of, s)
    if not on_card(*args, *extra):
        return express_rows_plain(*args, vectors, c_saved, row0)
    rows, Mp = c.shape
    kmax, pk = add_pm.shape
    i32 = torch.int32
    ptrs = dict(
        w_s=kernel_arg(w_s, "w_s", i32, (kmax,)),
        pc_s=kernel_arg(pc_s, "pc_s", i32, (kmax, pk)),
        add_row=kernel_arg(add_row, "add_row", i32, (kmax,)),
        add_pm=kernel_arg(add_pm, "add_pm", i32, (kmax, pk)),
        add_pr=kernel_arg(add_pr, "add_pr", i32, (kmax, pk)),
        c=kernel_arg(c, "c", i32, (rows, Mp)),
    )
    for t, name in ((dgen, "dgen"), (ra_s, "ra_s"), (rack_of, "rack_of"),
                    (s, "s")):
        ptrs[name] = kernel_arg(t, name, i32, (Mp,))
    if c_saved is not None:
        ptrs["c_saved"] = kernel_arg(c_saved, "c_saved", i32, (kmax, Mp))
    out = None
    Tp = row0 + rows
    if vectors is not None:
        u_s, u, w, valid, asg, lvl = vectors
        Tp = u.shape[0]
        out = torch.empty_like(asg), torch.empty_like(lvl)
        ptrs["u_s"] = kernel_arg(u_s, "u_s", i32, (kmax,))
        for t, name, dt in ((u, "u", i32), (w, "w", i32),
                            (valid, "valid", torch.bool), (asg, "asg", i32),
                            (lvl, "lvl", i32), (out[0], "asg0", i32),
                            (out[1], "lvl0", i32)):
            ptrs[name] = kernel_arg(t, name, dt, (Tp,))
    a = _Args(**ptrs, kmax=kmax, pk=pk, Tp=Tp, Mp=Mp, row0=row0,
              c_rows=rows)
    with torch.cuda.device(c.device):
        err = library("express_rows").express_rows_launch(
            ctypes.byref(a), stream_ptr(c))
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return out
