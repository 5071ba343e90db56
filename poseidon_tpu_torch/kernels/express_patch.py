"""K5 ``express_patch``: retire rows and apply seat deltas of one patch
chunk, in place, and its plain twin.

Replaces ``poseidon_tpu/ops/resident.py:320`` ``_express_patch``. The
CUDA source is ``csrc/express_patch.cu``; its header note gives the
byte bound and the design (one block, global atomics, then the clamp).
The caller launches it once per chunk, in order: ``s`` is clamped at 0
after each chunk, as the reference does between its chunk dispatches.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="express_patch",
    source="poseidon_tpu_torch/kernels/csrc/express_patch.cu",
    replaces="poseidon_tpu/ops/resident.py:320",
)


def express_patch_plain(u, w, valid, s, asg, lvl, rows, cols, deltas):
    """The reference lines restated in PyTorch, in place on
    u/w/valid/s/asg/lvl."""
    Tp, Mp = u.shape[0], s.shape[0]
    r = rows[(rows >= 0) & (rows < Tp)].long()
    valid[r] = False
    u[r] = 0
    w[r] = INF
    asg[r] = Mp
    lvl[r] = 0
    live = (cols >= 0) & (cols < Mp)
    s.index_add_(0, cols[live].long(), deltas[live])
    s.clamp_(min=0)


def express_patch(u, w, valid, s, asg, lvl, rows, cols, deltas):
    """Apply one chunk in place: rows/cols/deltas int32[n] (-1 = unused
    entry) against u/w/asg/lvl int32[Tp], valid bool[Tp] and s int32[Mp].
    The caller owns every patched tensor (clone the warm state's asg and
    lvl first). CPU tensors take the plain twin; CUDA tensors launch
    K5."""
    args = (u, w, valid, s, asg, lvl, rows, cols, deltas)
    if not on_card(*args):
        express_patch_plain(*args)
        return
    Tp, Mp, n = u.shape[0], s.shape[0], rows.shape[0]
    i32 = torch.int32
    ptrs = [kernel_arg(t, name, i32, (n,))
            for t, name in ((rows, "rows"), (cols, "cols"),
                            (deltas, "deltas"))]
    ptrs += [kernel_arg(u, "u", i32, (Tp,)), kernel_arg(w, "w", i32, (Tp,)),
             kernel_arg(valid, "valid", torch.bool, (Tp,)),
             kernel_arg(asg, "asg", i32, (Tp,)),
             kernel_arg(lvl, "lvl", i32, (Tp,)),
             kernel_arg(s, "s", i32, (Mp,))]
    with torch.cuda.device(u.device):
        err = library("express_patch").express_patch_launch(
            *ptrs, n, Tp, Mp, stream_ptr(u),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
