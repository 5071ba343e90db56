"""K5 ``express_patch``: retire rows and apply seat deltas of a whole
patch backlog, chunk after chunk, out of place, and its plain twin.

Replaces ``poseidon_tpu/ops/resident.py:320`` ``_express_patch``,
applied to each chunk in order. The CUDA source is
``csrc/express_patch.cu``; its header note gives the byte bound and the
design (one launch: tile blocks copy and retire, one seat block adds and
clamps chunk by chunk). ``s`` is clamped at 0 after each chunk, as the
reference does between its chunk dispatches.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29
STAGE_MAX = 12_288    # seat columns the seat block stages (48 KiB)

KERNEL = Kernel(
    name="express_patch",
    source="poseidon_tpu_torch/kernels/csrc/express_patch.cu",
    replaces="poseidon_tpu/ops/resident.py:320",
)

NAMES = ("u", "w", "valid", "s", "asg", "lvl")


def _destinations(src, dst):
    """``dst`` with each None replaced by a new tensor like its source.
    A destination is its own source (in place) or shares no storage with
    any source."""
    if dst is None:
        dst = (None,) * len(NAMES)
    if len(src) != len(NAMES) or len(dst) != len(NAMES):
        raise ValueError(f"express_patch: src and dst are ({', '.join(NAMES)})")
    dst = tuple(torch.empty_like(a) if b is None else b
                for a, b in zip(src, dst))
    ptrs = {a.data_ptr() for a in src}
    for name, a, b in zip(NAMES, src, dst):
        if b.data_ptr() != a.data_ptr() and b.data_ptr() in ptrs:
            raise ValueError(f"express_patch: dst {name} is another source")
    return dst


def express_patch_plain(src, dst, backlog):
    """The reference lines restated in PyTorch, chunk after chunk, from
    ``src`` into ``dst`` (u, w, valid, s, asg, lvl; None entries made
    new, as ``express_patch`` makes them); returns ``dst``."""
    dst = _destinations(src, dst)
    for a, b in zip(src, dst):
        if b.data_ptr() != a.data_ptr():
            b.copy_(a)
    u, w, valid, s, asg, lvl = dst
    Tp, Mp = u.shape[0], s.shape[0]
    rows = backlog[:, 0].reshape(-1)
    r = rows[(rows >= 0) & (rows < Tp)].long()
    valid[r] = False
    u[r] = 0
    w[r] = INF
    asg[r] = Mp
    lvl[r] = 0
    for cols, deltas in zip(backlog[:, 1], backlog[:, 2]):
        live = (cols >= 0) & (cols < Mp)
        s.index_add_(0, cols[live].long(), deltas[live])
        s.clamp_(min=0)
    return dst


def express_patch(src, dst, backlog):
    """Apply a backlog int32[n_chunks, 3, W] (rows, cols, deltas; -1 =
    unused entry) from ``src`` = (u, w, valid, s, asg, lvl) into ``dst``
    (u/w/asg/lvl int32[Tp], valid bool[Tp], s int32[Mp]); returns
    ``dst``. An entry of ``dst`` may be its source (patched in place) or
    None (a new tensor); ``dst`` None makes all six new. CPU tensors
    take the plain twin; CUDA tensors launch K5, once whatever the
    chunk count."""
    dst = _destinations(src, dst)
    if not on_card(*src, *dst, backlog):
        return express_patch_plain(src, dst, backlog)
    Tp, Mp = src[0].shape[0], src[3].shape[0]
    n_chunks, _three, W = backlog.shape
    i32 = torch.int32
    shapes = ((i32, (Tp,)), (i32, (Tp,)), (torch.bool, (Tp,)), (i32, (Mp,)),
              (i32, (Tp,)), (i32, (Tp,)))
    ptrs = [kernel_arg(backlog, "backlog", i32, (n_chunks, 3, W))]
    for side, vecs in (("src", src), ("dst", dst)):
        ptrs += [kernel_arg(t, f"{side} {name}", dt, shape)
                 for t, name, (dt, shape) in zip(vecs, NAMES, shapes)]
    smem = Mp * 4 if Mp <= STAGE_MAX else 0
    with torch.cuda.device(src[0].device):
        err = library("express_patch").express_patch_launch(
            *ptrs, n_chunks, W, Tp, Mp, smem, stream_ptr(src[0]),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return dst
