"""K7 ``stream_commit``: the stream lane's per-window commit, in place,
and its plain twin.

Replaces ``poseidon_tpu/ops/resident.py:658-690``, the tail of
``_stream_chain``'s scan step: the certificate latch, the in-device
auto-retire of the window's placements, the latched select of the carry
against the previous window's, and the masking of the window's outputs.
The CUDA source is ``csrc/stream_commit.cu``; its header note gives the
byte bound and the design (one block; seat decrements by global atomics,
then the clamp). The latch stays on the device: ``live`` is an int32[1]
the kernel reads and writes, so a window never syncs the host.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="stream_commit",
    source="poseidon_tpu_torch/kernels/csrc/stream_commit.cu",
    replaces="poseidon_tpu/ops/resident.py:658",
)


def log_width(cap: int) -> int:
    """Entries of one window's log row: rows_out[cap], asg_out[cap],
    n_changes, live, conv, domain_ok, primal, and one spare entry that
    keeps every row of a [K, width] buffer 16-byte aligned."""
    return 2 * cap + 6


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


def stream_commit_plain(live, conv, domain_ok, n_changes, change_cap,
                        rows_out, asg_out, primal, report, asg_f, lvl_f,
                        floor_f, u_n, w_n, valid_n, s_n, add_row, c_saved,
                        u, w, valid, asg, lvl, s, floor, c, log_row,
                        row0: int = 0):
    """The reference lines restated in PyTorch, with the same in-place
    contract as the kernel (no host read: every branch is a ``where``)."""
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
    _restore_rows_plain(live2, add_row, c_saved, c, Tp, row0)
    i64 = torch.int64
    log_row[:cap] = torch.where(live2, rows_out.to(i64), Tp)
    log_row[cap: 2 * cap] = torch.where(live2, asg_out.to(i64), -1)
    log_row[2 * cap: 2 * cap + 5] = torch.stack([
        n_changes.to(i64), live2.to(i64), conv.to(i64), domain_ok.to(i64),
        torch.where(live2, primal.to(i64), 0),
    ])
    live.copy_(live2.to(live.dtype).reshape(1))


def stream_commit(live, conv, domain_ok, n_changes, change_cap, rows_out,
                  asg_out, primal, report, asg_f, lvl_f, floor_f, u_n, w_n,
                  valid_n, s_n, add_row, c_saved, u, w, valid, asg, lvl, s,
                  floor, c, log_row, row0: int = 0):
    """Commit one stream window.

    ``live`` int32[1] is the stream's latch (read, then written with this
    window's verdict); ``conv``/``domain_ok`` bool[], ``n_changes``
    int32[] and ``primal`` int64[] are the window's certificate and
    objective; ``rows_out``/``asg_out`` int32[cap] its compacted log.
    ``report``/``asg_f``/``lvl_f``/``u_n``/``w_n``/``valid_n`` [Tp],
    ``floor_f`` [Mp] and ``s_n`` [Mp] (consumed: the seat decrements land
    in it) are the step's results; ``u``/``w``/``valid``/``asg``/``lvl``
    [Tp], ``s``/``floor`` [Mp] are the carry, overwritten in place.
    ``add_row`` int32[kmax] and ``c_saved`` int32[kmax, Mp] are the
    window's arrival rows and their contents before K4 wrote them into
    ``c`` [Tp, Mp]; under a row-block mesh ``c`` is one shard's rows
    from ``row0`` on, and ``stream_restore`` undoes the other shards'.
    ``log_row`` int64[``log_width(cap)``] receives the masked log. CPU
    tensors take the plain twin; CUDA tensors launch K7."""
    args = (live, conv, domain_ok, n_changes, rows_out, asg_out, primal,
            report, asg_f, lvl_f, floor_f, u_n, w_n, valid_n, s_n, add_row,
            c_saved, u, w, valid, asg, lvl, s, floor, c, log_row)
    if not on_card(*args):
        stream_commit_plain(live, conv, domain_ok, n_changes, change_cap,
                            rows_out, asg_out, primal, report, asg_f,
                            lvl_f, floor_f, u_n, w_n, valid_n, s_n,
                            add_row, c_saved, u, w, valid, asg, lvl, s,
                            floor, c, log_row, row0)
        return
    Tp, Mp = u.shape[0], s.shape[0]
    c_rows = c.shape[0]
    cap = rows_out.shape[0]
    kmax = add_row.shape[0]
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    spec = (
        (live, "live", i32, (1,)), (conv, "conv", b8, ()),
        (domain_ok, "domain_ok", b8, ()), (n_changes, "n_changes", i32, ()),
        (rows_out, "rows_out", i32, (cap,)), (asg_out, "asg_out", i32, (cap,)),
        (primal, "primal", i64, ()), (report, "report", b8, (Tp,)),
        (asg_f, "asg_f", i32, (Tp,)), (lvl_f, "lvl_f", i32, (Tp,)),
        (floor_f, "floor_f", i32, (Mp,)), (u_n, "u_n", i32, (Tp,)),
        (w_n, "w_n", i32, (Tp,)), (valid_n, "valid_n", b8, (Tp,)),
        (s_n, "s_n", i32, (Mp,)), (add_row, "add_row", i32, (kmax,)),
        (c_saved, "c_saved", i32, (kmax, Mp)), (u, "u", i32, (Tp,)),
        (w, "w", i32, (Tp,)), (valid, "valid", b8, (Tp,)),
        (asg, "asg", i32, (Tp,)), (lvl, "lvl", i32, (Tp,)),
        (s, "s", i32, (Mp,)), (floor, "floor", i32, (Mp,)),
        (c, "c", i32, (c_rows, Mp)),
        (log_row, "log_row", i64, (log_width(cap),)),
    )
    ptrs = [kernel_arg(t, name, dt, shape) for t, name, dt, shape in spec]
    with torch.cuda.device(c.device):
        err = library("stream_commit").stream_commit_launch(
            *ptrs, change_cap, cap, kmax, Tp, Mp, row0, c_rows, stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1


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
