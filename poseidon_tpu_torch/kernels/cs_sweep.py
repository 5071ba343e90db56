"""K9 ``cs_sweep``: one discharge sweep of cost-scaling push-relabel, and
its plain twin.

Replaces ``poseidon_tpu/ops/cost_scaling.py:120-170``, the ``sweep`` of
``_solve``. The CUDA source is ``csrc/cs_sweep.cu``; its header note
gives the byte bound and the design (the work split by positions
through the launch plan of ``kernels/csr_plan.py``: light nodes in runs
a block, each heavy node's segment over one thread-block cluster; two
passes over a node's positions).

The residual CSR (built once per solve by ``ops/cost_scaling.py``): the
2F residual arcs stably sorted by tail; node v's out-arcs are positions
``[seg[v], seg[v + 1])`` and ``arc``/``head``/``cost`` hold each
position's residual arc id (a < F forward, a >= F the mirror of a - F),
head node and scaled int64 cost. A sweep reads the pre-sweep ``flow``,
``excess_in`` and ``price_in``, updates ``flow`` in place and writes
``excess_out`` and ``price_out``.

``cs_sweep_batch`` is one sweep of a batch (the reference's ``_solve``
under ``jax.vmap`` over cost vectors): B elements over one CSR and plan,
each with its own cost row, flow, excess, price and eps, and a mask word
on the device; a masked element keeps its state (its excess and price
carried into the output buffers). ``cs_sweep`` is the same kernel at
B = 1 with no mask.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, stream_ptr,
)
from poseidon_tpu_torch.kernels.csr_plan import CsrPlan, plan_args
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

KERNEL = Kernel(
    name="cs_sweep",
    source="poseidon_tpu_torch/kernels/csrc/cs_sweep.cu",
    replaces="poseidon_tpu/ops/cost_scaling.py:120",
)


def csr_tails(seg: torch.Tensor) -> torch.Tensor:
    """The tail node of every CSR position (int64)."""
    NN = seg.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(NN, device=seg.device), (seg[1:] - seg[:-1]).long()
    )


def residual(arc, fcap, flow):
    """Residual capacity of each position's arc (int32)."""
    F = fcap.shape[0]
    fwd = arc < F
    slot = torch.where(fwd, arc, arc - F).long()
    return torch.where(fwd, fcap[slot] - flow[slot], flow[slot])


def cs_sweep_plain(seg, arc, head, cost, fcap, flow, excess_in, price_in,
                   eps, excess_out, price_out):
    """The reference lines restated in PyTorch over the CSR positions
    (each residual arc once), with the kernel's in-place contract;
    ``eps`` an int or an int64 0-d tensor beside the others."""
    NN = seg.shape[0] - 1
    F = fcap.shape[0]
    i64, dev = torch.int64, seg.device
    node = csr_tails(seg)
    hd = head.long()
    res = residual(arc, fcap, flow)
    rc = cost + price_in[node] - price_in[hd]
    active = excess_in > 0
    adm = (res > 0) & (rc < 0) & active[node]
    adm_amt = torch.where(adm, res, 0).to(i64)
    total = torch.zeros(NN, dtype=i64, device=dev).index_add_(0, node, adm_amt)
    exc64 = excess_in.to(i64)
    prop = torch.minimum(
        adm_amt, (exc64[node] * adm_amt) // torch.clamp(total[node], min=1)
    )
    sum_prop = torch.zeros(NN, dtype=i64, device=dev).index_add_(0, node, prop)
    sent = 2 * F
    choice = torch.full((NN,), sent, dtype=arc.dtype, device=dev).scatter_reduce_(
        0, node, torch.where(adm, arc, sent), "amin"
    )
    is_chosen = adm & (arc == choice[node])
    leftover = (exc64 - sum_prop)[node]
    extra = torch.where(is_chosen, torch.minimum(adm_amt - prop, leftover), 0)
    push32 = (prop + extra).to(torch.int32)
    fwd = arc < F
    slot = torch.where(fwd, arc, arc - F).long()
    flow.index_add_(0, slot, torch.where(fwd, push32, -push32))
    out = torch.zeros(NN, dtype=torch.int32, device=dev).index_add_(0, node, push32)
    inn = torch.zeros(NN, dtype=torch.int32, device=dev).index_add_(0, hd, push32)
    excess_out.copy_(excess_in + inn - out)
    has_adm = torch.zeros(NN, dtype=torch.int32, device=dev).index_add_(
        0, node, adm.to(torch.int32)) > 0
    price_out.copy_(torch.where(active & ~has_adm, price_in - eps, price_in))


def cs_sweep_batch_plain(seg, arc, head, cost, fcap, flow, excess_in,
                        price_in, eps, excess_out, price_out, mask):
    """``cs_sweep_plain`` over a batch in one pass, restated over the
    positions of the active nodes' segments only (an inactive node's arcs
    are not admissible, so they push nothing and feed no sum), each
    element's nodes and arc slots at their own offsets in the flattened
    [B * NN] and [B * F] vectors; an element whose ``mask`` word is 0 has
    no active node (so it pushes nothing and keeps its excess and
    price)."""
    B, NN = excess_in.shape
    F = fcap.shape[0]
    R = arc.shape[0]
    i64, dev = torch.int64, seg.device
    tails = csr_tails(seg)
    active = (excess_in > 0) & (mask != 0)[:, None]
    at = active[:, tails].reshape(-1).nonzero().squeeze(1)   # b * R + p
    b, p = at // R, at % R
    a = arc[p]
    key = b * NN + tails[p]                                  # the tail
    hd = b * NN + head[p].long()
    fwd = a < F
    slot = torch.where(fwd, a, a - F).long()
    fs = b * F + slot
    fl = flow.reshape(-1)
    res = torch.where(fwd, fcap[slot] - fl[fs], fl[fs])
    p_in = price_in.reshape(-1)
    rc = cost.reshape(-1)[at] + p_in[key] - p_in[hd]
    adm = (res > 0) & (rc < 0)
    adm_amt = torch.where(adm, res, 0).to(i64)
    total = torch.zeros(B * NN, dtype=i64, device=dev).index_add_(
        0, key, adm_amt)
    exc64 = excess_in.reshape(-1).to(i64)
    prop = torch.minimum(
        adm_amt, (exc64[key] * adm_amt) // torch.clamp(total[key], min=1))
    sum_prop = torch.zeros(B * NN, dtype=i64, device=dev).index_add_(
        0, key, prop)
    sent = 2 * F
    choice = torch.full((B * NN,), sent, dtype=arc.dtype,
                        device=dev).scatter_reduce_(
        0, key, torch.where(adm, a, sent), "amin")
    is_chosen = adm & (a == choice[key])
    leftover = (exc64 - sum_prop)[key]
    extra = torch.where(is_chosen, torch.minimum(adm_amt - prop, leftover), 0)
    push32 = (prop + extra).to(torch.int32)
    fl.index_add_(0, fs, torch.where(fwd, push32, -push32))
    excess_out.copy_(excess_in)
    ex = excess_out.view(-1)
    ex.index_add_(0, key, -push32)
    ex.index_add_(0, hd, push32)
    has_adm = torch.zeros(B * NN, dtype=torch.int32, device=dev).index_add_(
        0, key, adm.to(torch.int32)).view(B, NN) > 0
    price_out.copy_(torch.where(active & ~has_adm,
                                price_in - eps[:, None], price_in))


def _launch(plan, seg, arc, head, cost, fcap, flow, excess_in, price_in,
            eps, excess_out, price_out, mask, B: int) -> None:
    NN = seg.shape[0] - 1
    F = fcap.shape[0]
    R = 2 * F
    i32, i64 = torch.int32, torch.int64
    rows = () if mask is None else (B,)
    spec = (
        (seg, "seg", i32, (NN + 1,)), (arc, "arc", i32, (R,)),
        (head, "head", i32, (R,)), (cost, "cost", i64, (*rows, R)),
        (fcap, "fcap", i32, (F,)), (flow, "flow", i32, (*rows, F)),
        (excess_in, "excess_in", i32, (*rows, NN)),
        (price_in, "price_in", i64, (*rows, NN)),
        (excess_out, "excess_out", i32, (*rows, NN)),
        (price_out, "price_out", i64, (*rows, NN)),
        (eps, "eps", i64, rows),
    )
    ptrs = [kernel_arg(t, name, dt, shape) for t, name, dt, shape in spec]
    m = None if mask is None else kernel_arg(mask, "mask", i32, (B,))
    pp = plan_args(plan, NN, R)
    with torch.cuda.device(flow.device):
        err = library("cs_sweep").cs_sweep_launch(
            *pp, *ptrs[1:], m, plan.n_heavy, plan.n_light, NN, F, B,
            stream_ptr(flow),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1


@census_op("cs_sweep")
def cs_sweep_batch(seg, arc, head, cost, fcap, flow, excess_in, price_in,
                   eps, excess_out, price_out, mask, plan: CsrPlan):
    """One discharge sweep of B elements over one CSR: ``cost`` int64[B,
    2F], ``flow`` int32[B, F], ``excess_*`` int32[B, NN], ``price_*``
    int64[B, NN], ``eps`` int64[B] and ``mask`` int32[B] on the device
    (element b sweeps where ``mask[b]`` is non-zero and keeps its state
    where it is 0); ``seg``/``arc``/``head``/``fcap`` and ``plan`` as
    ``cs_sweep``'s. CPU tensors take the plain twin; CUDA tensors launch
    K9 once for the batch."""
    args = (seg, arc, head, cost, fcap, flow, excess_in, price_in,
            excess_out, price_out, eps, mask)
    if not on_card(*args):
        cs_sweep_batch_plain(seg, arc, head, cost, fcap, flow, excess_in,
                             price_in, eps, excess_out, price_out, mask)
        return
    _launch(plan, seg, arc, head, cost, fcap, flow, excess_in, price_in,
            eps, excess_out, price_out, mask, excess_in.shape[0])


@census_op("cs_sweep")
def cs_sweep(seg, arc, head, cost, fcap, flow, excess_in, price_in,
             eps, excess_out, price_out, plan: CsrPlan):
    """One discharge sweep at ``eps``. ``seg`` int32[NN + 1], ``arc``/
    ``head`` int32[2F], ``cost`` int64[2F] (the CSR), ``fcap``/``flow``
    int32[F], ``excess_*`` int32[NN], ``price_*`` int64[NN]; ``eps`` an
    int64 0-d tensor beside them (K9 reads it on the device, so a
    captured launch takes each run's eps); ``plan`` the CSR's launch plan
    (``ResidualCSR.plan``). CPU tensors take the plain twin, which needs
    no plan; CUDA tensors launch K9 (the batch's kernel at B = 1, no
    mask)."""
    if not isinstance(eps, torch.Tensor):
        raise TypeError("cs_sweep: eps must be an int64 0-d tensor")
    args = (seg, arc, head, cost, fcap, flow, excess_in, price_in,
            excess_out, price_out)
    if not on_card(*args, eps):
        cs_sweep_plain(seg, arc, head, cost, fcap, flow, excess_in,
                       price_in, eps, excess_out, price_out)
        return
    _launch(plan, seg, arc, head, cost, fcap, flow, excess_in, price_in,
            eps, excess_out, price_out, None, 1)
