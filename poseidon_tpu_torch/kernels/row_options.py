"""K2 ``row_options``: per-row best value, first-index argmin and
runner-up of ``min(c + p, INF)``, and its plain twin.

Replaces the row reductions of ``poseidon_tpu/ops/dense_auction.py:445``
``_task_options``. The CUDA source is ``csrc/row_options.cu``; its
header note gives the byte bound and the design. Its launch plan (grid,
ring depth, tile width, shared memory) comes from ``row_stream``, made
once per device and shape.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels import row_stream
from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, sm_count, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import (
    Kernel, check_launch, library, occupancy,
)

INF = 2**29

KERNEL = Kernel(
    name="row_options",
    source="poseidon_tpu_torch/kernels/csrc/row_options.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:445",
)

PLANS = row_stream.PlanCache()


def row_options_plain(c, p):
    """The reference lines restated in PyTorch: (b1v, m1, v2), int32[Tp]."""
    v = torch.clamp(c + p[None, :], max=INF)
    b1v = v.min(dim=1).values
    m1 = torch.argmin(v, dim=1).to(torch.int32)
    cols = torch.arange(v.shape[1], dtype=torch.int32, device=v.device)
    masked = torch.where(cols[None, :] == m1[:, None], INF, v)
    return b1v, m1, masked.min(dim=1).values


@census_op("row_options")
def row_options(c, p):
    """(b1v, m1, v2) of ``min(c + p, INF)`` per row of c[Tp, Mp] with
    prices p[Mp]. CPU tensors take the plain twin; CUDA tensors launch
    K2."""
    if not on_card(c, p):
        return row_options_plain(c, p)
    Tp, Mp = c.shape
    if Mp % 4:
        raise ValueError(f"row_options: Mp={Mp} must be a multiple of 4")
    i32 = torch.int32
    dev = c.device
    b1v, m1, v2 = (torch.empty(Tp, dtype=i32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        lib = library("row_options")
        plan = PLANS.get(
            dev, Tp, Mp, lambda: sm_count(dev),
            lambda smem: occupancy(KERNEL, lib.row_options_occupancy, smem),
        )
        lay = plan.layout
        err = lib.row_options_launch(
            kernel_arg(c, "c", i32, (Tp, Mp)), kernel_arg(p, "p", i32, (Mp,)),
            b1v.data_ptr(), m1.data_ptr(), v2.data_ptr(), Tp, Mp,
            plan.grid, lay.stages, lay.chunk, int(lay.p_resident), lay.smem,
            stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return b1v, m1, v2
