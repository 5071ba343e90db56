"""K3 ``bid_pass``: the auction round's bid-window pass, and its plain twin.

Replaces the bid pass of ``auction_round`` in
``poseidon_tpu/ops/dense_auction.py:710-746`` (``_solve``). The CUDA
source is ``csrc/bid_pass.cu``; its header note gives the byte bound,
the rotated tie-break and the design. Its launch plan comes from
``row_stream``, made once per device and shape.
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
    name="bid_pass",
    source="poseidon_tpu_torch/kernels/csrc/bid_pass.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:710",
)

# per-warp slot metadata in shared memory: task, u[task] and bvalid of
# two batches of 32 slots (csrc/bid_pass.cu META)
META_INTS = 3 * 64
PLANS = row_stream.PlanCache(meta_ints=META_INTS)


def bid_pass_plain(c, p, u, btask, bvalid, eps, task0: int = 0):
    """The reference lines restated in PyTorch (``eps`` an int32 0-d
    tensor). Returns (m1, b1v, v2, take_uns, beta) over the window."""
    Mp = c.shape[1]
    bt = btask.long()
    cb = c[bt]                                   # [B, Mp] gather
    vb = torch.clamp(cb + p[None, :], max=INF)
    b1v = vb.min(dim=1).values
    midx = torch.arange(Mp, dtype=torch.int32, device=c.device)[None, :]
    # the reference multiplies in uint32: emulate the wrap in int64
    rot = (((bt + task0) * 40503) % 2**32 % Mp).to(torch.int32)[:, None]
    tie_rank = torch.remainder(midx - rot, Mp)   # floor modulo
    m1 = torch.argmin(
        torch.where(vb == b1v[:, None], tie_rank, Mp + 1), dim=1
    ).to(torch.int32)
    masked = torch.where(midx == m1[:, None], INF, vb)
    v2 = masked.min(dim=1).values
    ub = u[bt]
    take_uns = bvalid & (ub <= b1v)
    b2 = torch.minimum(v2, ub)
    c1 = cb.gather(1, m1[:, None].long())[:, 0]
    beta = torch.clamp(
        b2.long() + eps - c1.long(), max=INF - 1
    ).to(torch.int32)
    return m1, b1v, v2, take_uns, beta


@census_op("bid_pass")
def bid_pass(c, p, u, btask, bvalid, eps, task0: int = 0):
    """The bid pass over window tasks ``btask[B]`` (``bvalid[B]`` marks
    real slots) at prices p[Mp] and bid increment ``eps``, an int32 0-d
    tensor beside them (K3 reads it on the device, so a captured launch
    takes each run's eps). Under a row-block mesh c and u hold the rows
    from ``task0`` on and btask is relative to it; the tie-break ranks
    by the absolute task. CPU tensors take the plain twin; CUDA tensors
    launch K3."""
    if not isinstance(eps, torch.Tensor):
        raise TypeError("bid_pass: eps must be an int32 0-d tensor")
    if not on_card(c, p, u, btask, bvalid, eps):
        return bid_pass_plain(c, p, u, btask, bvalid, eps, task0)
    Tp, Mp = c.shape
    B = btask.shape[0]
    if Mp % 4:
        raise ValueError(f"bid_pass: Mp={Mp} must be a multiple of 4")
    i32 = torch.int32
    dev = c.device
    m1, b1v, v2, beta = (torch.empty(B, dtype=i32, device=dev) for _ in range(4))
    take_uns = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        lib = library("bid_pass")
        plan = PLANS.get(
            dev, B, Mp, lambda: sm_count(dev),
            lambda smem: occupancy(KERNEL, lib.bid_pass_occupancy, smem),
        )
        lay = plan.layout
        err = lib.bid_pass_launch(
            kernel_arg(c, "c", i32, (Tp, Mp)), kernel_arg(p, "p", i32, (Mp,)),
            kernel_arg(u, "u", i32, (Tp,)), kernel_arg(btask, "btask", i32, (B,)),
            kernel_arg(bvalid, "bvalid", torch.bool, (B,)),
            kernel_arg(eps, "eps", i32, ()), B, Mp, int(task0), plan.grid, lay.stages, lay.chunk,
            int(lay.p_resident), lay.smem,
            m1.data_ptr(), b1v.data_ptr(), v2.data_ptr(), take_uns.data_ptr(),
            beta.data_ptr(), stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return m1, b1v, v2, take_uns, beta
