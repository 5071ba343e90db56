"""K7 ``stream_commit``: the tail of an express window (the report mask,
the change count, the ordered compaction and the objective, and in the
stream lane the window's commit), in one launch across a thread-block
cluster, and its plain twins.

Replaces ``poseidon_tpu/ops/resident.py:526-545``, the tail of
``_express_step``, and l.658-690, the tail of ``_stream_chain``'s scan
step: the certificate latch, the in-device auto-retire of the window's
placements, the latched select of the carry against the previous
window's, and the masking of the window's outputs. The CUDA source is
``csrc/stream_commit.cu``; its header note gives the byte bound and the
design (the count meets at a cluster barrier before any block writes the
carry). The latch stays on the device: ``live`` is an int32[1] the
kernel reads and writes, so a window never syncs the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="stream_commit",
    source="poseidon_tpu_torch/kernels/csrc/stream_commit.cu",
    replaces="poseidon_tpu/ops/resident.py:526",
)


def log_width(cap: int) -> int:
    """Entries of one window's log row: rows_out[cap], asg_out[cap],
    n_changes, live, conv, domain_ok, primal, n_active (the last also
    keeps every row of a [K, width] buffer 16-byte aligned)."""
    return 2 * cap + 6


class Commit(NamedTuple):
    """The stream lane's half of the tail. ``live`` int32[1] is the
    stream's latch (read, then written with this window's verdict);
    ``lvl_f`` [Tp] and ``floor_f`` [Mp] are the repair's, ``w_n`` [Tp]
    and ``s_n`` [Mp] the window's after its head (``s_n`` is consumed:
    the seat decrements land in it); ``add_row`` int32[kmax] and
    ``c_saved`` int32[kmax, Mp] the arrival rows and their contents
    before K4 wrote them into ``c`` [rows, Mp] (the table, or the first
    shard's rows under a mesh, whose other shards ``stream_restore``
    undoes); ``u``/``w``/``valid``/``asg``/``lvl`` [Tp] and ``s``/
    ``floor`` [Mp] are the carry, overwritten in place by a live
    window."""

    live: torch.Tensor
    lvl_f: torch.Tensor
    floor_f: torch.Tensor
    w_n: torch.Tensor
    s_n: torch.Tensor
    add_row: torch.Tensor
    c_saved: torch.Tensor
    c: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor
    asg: torch.Tensor
    lvl: torch.Tensor
    s: torch.Tensor
    floor: torch.Tensor


class _Args(ctypes.Structure):
    """``TailArgs`` of ``csrc/stream_commit.cu``: every field 8 bytes."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "valid_n", "asg0", "asg_f", "u_n", "cost", "conv", "domain_ok",
        "report", "log_row", *Commit._fields)] + [
        (n, ctypes.c_longlong) for n in (
            "col_step", "change_cap", "cap", "kmax", "Tp", "Mp", "c_rows")]


def _restore_rows_plain(keep, add_row, c_saved, c, Tp, row0):
    """``c`` holds rows [row0, row0 + len(c)) of the table: put back the
    arrival rows it owns unless ``keep`` (out-of-range lanes write into
    a spare row that is cut off again)."""
    rows, Mp = c.shape
    r = add_row - row0
    r = torch.where((add_row >= 0) & (add_row < Tp) & (r >= 0) & (r < rows),
                    r, rows).long()
    c_ext = torch.cat([c, c.new_zeros(1, Mp)])
    c_ext[r] = torch.where(keep, c_ext[r], c_saved)
    c.copy_(c_ext[:rows])


def compact_plain(valid_n, asg0, asg_f, u_n, cost, Mp: int, cap: int):
    """The reference's l.526-545 restated in PyTorch: ``(report,
    n_changes, rows_out, asg_out, primal, n_active)``. ``cost`` is the
    table [Tp, Mp] or the per-row cost at ``clip(asg_f, 0, Mp - 1)``
    [Tp] (what ``table_gather`` returns under a mesh)."""
    Tp = asg_f.shape[0]
    pos = torch.arange(Tp, dtype=torch.int32, device=asg_f.device)
    on_m = (asg_f >= 0) & (asg_f < Mp)
    report = valid_n & on_m & (asg_f != asg0)
    n_changes = report.sum(dtype=torch.int32)
    rows_out = torch.sort(torch.where(report, pos, Tp)).values[:cap]
    asg_out = torch.where(
        rows_out < Tp, asg_f[torch.clamp(rows_out, max=Tp - 1).long()], -1)
    col = torch.clamp(asg_f, 0, Mp - 1).long()
    c_asg = cost.gather(1, col[:, None])[:, 0] if cost.dim() == 2 else cost
    per = torch.where(
        valid_n,
        torch.where(on_m, c_asg, torch.where(asg_f == Mp, u_n, INF)),
        0,
    )
    return (report, n_changes, rows_out, asg_out, per.to(torch.int64).sum(),
            valid_n.sum(dtype=torch.int32))


def commit_plain(live, conv, domain_ok, n_changes, change_cap, rows_out,
                 asg_out, primal, report, asg_f, lvl_f, floor_f, u_n, w_n,
                 valid_n, s_n, add_row, c_saved, u, w, valid, asg, lvl, s,
                 floor, c, log_row, n_active=0):
    """The reference's l.658-690 restated in PyTorch, with the kernel's
    in-place contract (no host read: every branch is a ``where``)."""
    Tp, Mp = u.shape[0], s.shape[0]
    cap = rows_out.shape[0]
    live2 = (live[0] != 0) & conv & domain_ok & (n_changes <= change_cap)
    # auto-retire, as the reference computes it before the select; the
    # decrements land in s_n (consumed, as the kernel's atomics leave it)
    m = torch.where(report, torch.clamp(asg_f, 0, Mp - 1), Mp).long()
    s_ext = torch.cat([s_n, s_n.new_zeros(1)])
    s_ext.index_add_(0, m, torch.full_like(asg_f, -1))
    s_n.copy_(torch.where(live2, s_ext[:Mp], s_n))
    s_r = torch.clamp(s_n, min=0)
    valid.copy_(torch.where(live2, valid_n & ~report, valid))
    u.copy_(torch.where(live2, torch.where(report, 0, u_n), u))
    w.copy_(torch.where(live2, torch.where(report, INF, w_n), w))
    asg.copy_(torch.where(live2, torch.where(report, Mp, asg_f), asg))
    lvl.copy_(torch.where(live2, torch.where(report, 0, lvl_f), lvl))
    s.copy_(torch.where(live2, s_r, s))
    floor.copy_(torch.where(live2, floor_f, floor))
    # a dead window puts back the rows K4 wrote
    _restore_rows_plain(live2, add_row, c_saved, c, Tp, 0)
    _log_row(log_row, live2, live2, rows_out, asg_out, n_changes, conv,
             domain_ok, primal, n_active, Tp)
    live.copy_(live2.to(live.dtype).reshape(1))


def _log_row(log_row, keep, live2, rows_out, asg_out, n_changes, conv,
             domain_ok, primal, n_active, Tp):
    """The window's log row, its entries masked unless ``keep``."""
    i64 = torch.int64
    cap = rows_out.shape[0]
    log_row[:cap] = torch.where(keep, rows_out.to(i64), Tp)
    log_row[cap: 2 * cap] = torch.where(keep, asg_out.to(i64), -1)
    log_row[2 * cap:] = torch.stack([
        n_changes.to(i64), live2.to(i64), conv.to(i64), domain_ok.to(i64),
        torch.where(keep, primal.to(i64), 0),
        torch.as_tensor(n_active, dtype=i64, device=log_row.device),
    ])


def stream_commit_plain(log_row, report, valid_n, asg0, asg_f, u_n, cost,
                        Mp: int, conv, domain_ok, change_cap: int,
                        commit: Commit | None = None):
    """The whole tail from its two pieces, with the kernel's contract:
    ``compact_plain``, then ``commit_plain`` with the commit, or the
    unmasked log row (live2 = the window's certificate) without it."""
    Tp = asg_f.shape[0]
    cap = (log_row.shape[0] - 6) // 2
    rep, n_changes, rows_out, asg_out, primal, n_active = compact_plain(
        valid_n, asg0, asg_f, u_n, cost, Mp, cap)
    report.copy_(rep)
    if commit is None:
        win_ok = conv & domain_ok & (n_changes <= change_cap)
        _log_row(log_row, torch.ones((), dtype=torch.bool,
                                     device=log_row.device), win_ok,
                 rows_out, asg_out, n_changes, conv, domain_ok, primal,
                 n_active, Tp)
        return
    k = commit
    commit_plain(k.live, conv, domain_ok, n_changes, change_cap, rows_out,
                 asg_out, primal, rep, asg_f, k.lvl_f, k.floor_f, u_n,
                 k.w_n, valid_n, k.s_n, k.add_row, k.c_saved, k.u, k.w,
                 k.valid, k.asg, k.lvl, k.s, k.floor, k.c, log_row,
                 n_active)


@census_op("stream_commit")
def stream_commit(log_row, report, valid_n, asg0, asg_f, u_n, cost, Mp: int,
                  conv, domain_ok, change_cap: int,
                  commit: Commit | None = None):
    """The tail of one window.

    ``valid_n``/``u_n`` [Tp] are the window's after its head, ``asg0``
    its repair's start and ``asg_f`` its end (int32 [Tp]); ``cost`` the
    table [Tp, Mp] or, under a mesh, the per-row cost gathered at
    ``clip(asg_f, 0, Mp - 1)`` [Tp]; ``conv``/``domain_ok`` bool[] the
    certificate. Writes ``report`` bool[Tp] and ``log_row``
    int64[``log_width(cap)``], cap <= Tp (rows_out, asg_out, n_changes,
    live2, conv, domain_ok, primal, n_active). With ``commit`` (the
    stream lane) live2 latches with the carry and the masks apply; without
    it live2 is the certificate and nothing is masked. CPU tensors take
    the plain twin; CUDA tensors launch K7."""
    Tp = asg_f.shape[0]
    cap = (log_row.shape[0] - 6) // 2
    if not 0 <= cap <= Tp:
        raise ValueError(f"log_row: cap {cap} outside [0, Tp={Tp}]")
    args = (log_row, report, valid_n, asg0, asg_f, u_n, cost, conv,
            domain_ok, *(commit or ()))
    if not on_card(*args):
        stream_commit_plain(log_row, report, valid_n, asg0, asg_f, u_n, cost,
                            Mp, conv, domain_ok, change_cap, commit)
        return
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    table = cost.dim() == 2
    spec = [
        (valid_n, "valid_n", b8, (Tp,)), (asg0, "asg0", i32, (Tp,)),
        (asg_f, "asg_f", i32, (Tp,)), (u_n, "u_n", i32, (Tp,)),
        (cost, "cost", i32, (Tp, Mp) if table else (Tp,)),
        (conv, "conv", b8, ()), (domain_ok, "domain_ok", b8, ()),
        (report, "report", b8, (Tp,)),
        (log_row, "log_row", i64, (log_width(cap),)),
    ]
    kmax = c_rows = 0
    if commit is not None:
        k = commit
        kmax, c_rows = k.add_row.shape[0], k.c.shape[0]
        spec += [
            (k.live, "live", i32, (1,)), (k.lvl_f, "lvl_f", i32, (Tp,)),
            (k.floor_f, "floor_f", i32, (Mp,)), (k.w_n, "w_n", i32, (Tp,)),
            (k.s_n, "s_n", i32, (Mp,)), (k.add_row, "add_row", i32, (kmax,)),
            (k.c_saved, "c_saved", i32, (kmax, Mp)),
            (k.c, "c", i32, (c_rows, Mp)), (k.u, "u", i32, (Tp,)),
            (k.w, "w", i32, (Tp,)), (k.valid, "valid", b8, (Tp,)),
            (k.asg, "asg", i32, (Tp,)), (k.lvl, "lvl", i32, (Tp,)),
            (k.s, "s", i32, (Mp,)), (k.floor, "floor", i32, (Mp,)),
        ]
    a = _Args(**{name: kernel_arg(t, name, dt, shape)
                 for t, name, dt, shape in spec},
              col_step=int(table), change_cap=change_cap, cap=cap, kmax=kmax,
              Tp=Tp, Mp=Mp, c_rows=c_rows)
    with torch.cuda.device(asg_f.device):
        err = library("stream_commit").stream_commit_launch(
            ctypes.byref(a), stream_ptr(asg_f))
    check_launch(KERNEL, err)
    KERNEL.launches += 1


@census_op("stream_commit")
def stream_restore(live, add_row, c_saved, c, Tp: int, row0: int):
    """A dead window's undo in one more shard, after ``stream_commit``
    wrote the window's verdict to ``live``: ``c`` holds the table's rows
    [row0, row0 + len(c)) of Tp, and the arrival rows it owns come back
    from ``c_saved`` [kmax, Mp] unless ``live`` is set. CPU tensors take
    the plain twin; CUDA tensors launch K7's restore entry point."""
    if not on_card(live, add_row, c_saved, c):
        _restore_rows_plain(live[0] != 0, add_row, c_saved, c, Tp, row0)
        return
    c_rows, Mp = c.shape
    kmax = add_row.shape[0]
    i32 = torch.int32
    with torch.cuda.device(c.device):
        err = library("stream_commit").stream_restore_launch(
            kernel_arg(live, "live", i32, (1,)),
            kernel_arg(add_row, "add_row", i32, (kmax,)),
            kernel_arg(c_saved, "c_saved", i32, (kmax, Mp)),
            kernel_arg(c, "c", i32, (c_rows, Mp)),
            kmax, Tp, Mp, row0, c_rows, stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
