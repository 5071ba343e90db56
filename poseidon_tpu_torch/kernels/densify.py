"""K1 ``densify``: the dense [Tp, Mp] cost table, and its plain twin.

Replaces ``poseidon_tpu/ops/dense_auction.py:311`` ``_densify``. The
CUDA source is ``csrc/densify.cu``; its header note gives the byte
bound and the design. Its launch plan (column chunk, tile height,
stages, shared memory, grid) comes from ``tile_stream``, made once per
device and shape.
"""

from __future__ import annotations

import functools

import torch

from poseidon_tpu_torch.kernels import row_stream, tile_stream
from poseidon_tpu_torch.kernels._args import (
    kernel_arg, on_card, sm_count, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import (
    Kernel, check_launch, library, occupancy,
)

INF = 2**29

KERNEL = Kernel(
    name="densify",
    source="poseidon_tpu_torch/kernels/csrc/densify.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:311",
)

PLANS = row_stream.PlanCache(make=tile_stream.plan)


def densify_plain(w, d, ra, rack_of, slots, pc, pm, pr, n_prefs: int):
    """The reference lines restated in PyTorch (int32, same order)."""
    Mp = d.shape[0]
    mids = torch.arange(Mp, dtype=torch.int32, device=d.device)
    c = torch.clamp(w[:, None] + d[None, :], max=INF)
    for k in range(n_prefs):
        pmk = pm[:, k]
        prk = pr[:, k]
        pck = pc[:, k]
        hit_m = (pmk[:, None] == mids[None, :]) & (pmk[:, None] >= 0)
        c = torch.minimum(c, torch.where(hit_m, pck[:, None], INF))
        hit_r = (prk[:, None] == rack_of[None, :]) & (prk[:, None] >= 0)
        rv = torch.clamp(pck[:, None] + ra[None, :], max=INF)
        c = torch.minimum(c, torch.where(hit_r, rv, INF))
    return torch.where(slots[None, :] > 0, c, INF)


def densify(w, d, ra, rack_of, slots, pc, pm, pr, n_prefs: int):
    """c[Tp, Mp] int32 from the channel arrays: w[Tp], d/ra/rack_of/
    slots[Mp], pc/pm/pr[Tp, Pw] with ``n_prefs <= Pw`` live columns.
    CPU tensors take the plain twin; CUDA tensors launch K1."""
    card = on_card(w, d, ra, rack_of, slots, pc, pm, pr)
    Tp, Mp = w.shape[0], d.shape[0]
    Pw = pc.shape[1]
    if Mp % 4:
        raise ValueError(f"densify: Mp={Mp} must be a multiple of 4")
    if not 0 <= n_prefs <= Pw:
        raise ValueError(f"densify: n_prefs={n_prefs} outside [0, {Pw}]")
    if not card:
        return densify_plain(w, d, ra, rack_of, slots, pc, pm, pr, n_prefs)
    i32 = torch.int32
    dev = w.device
    c = torch.empty((Tp, Mp), dtype=i32, device=dev)
    args = [kernel_arg(w, "w", i32, (Tp,))]
    for t, name in ((d, "d"), (ra, "ra"), (rack_of, "rack_of"), (slots, "slots")):
        args.append(kernel_arg(t, name, i32, (Mp,)))
    for t, name in ((pc, "pc"), (pm, "pm"), (pr, "pr")):
        args.append(kernel_arg(t, name, i32, (Tp, Pw)))
    args.append(kernel_arg(c, "c", i32, (Tp, Mp)))
    with torch.cuda.device(dev):
        lib = library("densify")
        plan = PLANS.get(
            dev, Tp, Mp, lambda: sm_count(dev),
            lambda smem: occupancy(
                KERNEL, functools.partial(lib.densify_occupancy, n_prefs), smem),
            Pw, n_prefs,
        )
        err = lib.densify_launch(
            *args, Tp, Mp, n_prefs, Pw, plan.cols, plan.stages, plan.grid,
            plan.smem, stream_ptr(w),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return c
