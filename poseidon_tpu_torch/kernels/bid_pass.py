"""K3 ``bid_pass``: the auction round's bid-window pass, and its plain twin.

Replaces the bid pass of ``auction_round`` in
``poseidon_tpu/ops/dense_auction.py:710-746`` (``_solve``). The CUDA
source is ``csrc/bid_pass.cu``; its header note gives the byte bound,
the rotated tie-break and the design.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="bid_pass",
    source="poseidon_tpu_torch/kernels/csrc/bid_pass.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:710",
)


def bid_pass_plain(c, p, u, btask, bvalid, eps: int):
    """The reference lines restated in PyTorch. Returns (m1, b1v, v2,
    take_uns, beta) over the window."""
    Mp = c.shape[1]
    bt = btask.long()
    cb = c[bt]                                   # [B, Mp] gather
    vb = torch.clamp(cb + p[None, :], max=INF)
    b1v = vb.min(dim=1).values
    midx = torch.arange(Mp, dtype=torch.int32, device=c.device)[None, :]
    # the reference multiplies in uint32: emulate the wrap in int64
    rot = ((bt * 40503) % 2**32 % Mp).to(torch.int32)[:, None]
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


def bid_pass(c, p, u, btask, bvalid, eps: int):
    """The bid pass over window tasks ``btask[B]`` (``bvalid[B]`` marks
    real slots) at prices p[Mp] and bid increment ``eps``. CPU tensors
    take the plain twin; CUDA tensors launch K3."""
    if not on_card(c, p, u, btask, bvalid):
        return bid_pass_plain(c, p, u, btask, bvalid, eps)
    Tp, Mp = c.shape
    B = btask.shape[0]
    if Mp % 4:
        raise ValueError(f"bid_pass: Mp={Mp} must be a multiple of 4")
    i32 = torch.int32
    dev = c.device
    m1, b1v, v2, beta = (torch.empty(B, dtype=i32, device=dev) for _ in range(4))
    take_uns = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(c.device):
        err = library("bid_pass").bid_pass_launch(
            kernel_arg(c, "c", i32, (Tp, Mp)), kernel_arg(p, "p", i32, (Mp,)),
            kernel_arg(u, "u", i32, (Tp,)), kernel_arg(btask, "btask", i32, (B,)),
            kernel_arg(bvalid, "bvalid", torch.bool, (B,)),
            B, Mp, int(eps),
            m1.data_ptr(), b1v.data_ptr(), v2.data_ptr(), take_uns.data_ptr(),
            beta.data_ptr(), stream_ptr(c),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return m1, b1v, v2, take_uns, beta
