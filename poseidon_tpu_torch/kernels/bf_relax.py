"""K10 ``bf_relax``: one Bellman-Ford relaxation round over the residual
CSR, and its plain twins.

Two entry points, one per reference loop:

- ``bf_relax_out`` replaces ``poseidon_tpu/ops/cost_scaling.py:193-200``
  (the global price update's ``bf_round``): the min over a node's
  residual out-arcs of ``d[head] + ln``;
- ``bf_relax_in`` replaces ``poseidon_tpu/ops/ssp.py:104-116`` (SSP's
  ``round_``): the min over a node's residual in-arcs of
  ``dist[tail] + rc``, with the predecessor arc.

The CUDA source is ``csrc/bf_relax.cu``; its header note gives the byte
bound and the design (a segmented min split by positions through the
launch plan of ``kernels/csr_plan.py``, as K9). The CSR and its plan are
the ones K9 reads (``kernels/cs_sweep.py``). Each launch writes the new
distances into a second buffer. ``out`` sets ``changed`` (int32[1]) when
any improved, and its caller swaps the buffers; ``in`` takes the pair by
SSP's parity word and ends its round on the solve's loop words
(``kernels/ssp_loop.py``), so SSP's round is this one launch.

``bf_relax_out_batch`` is one ``out`` round of a batch (the reference's
``_solve`` under ``jax.vmap`` over cost vectors): B elements over one
CSR and plan, each with its own ln row, d rows and ``changed`` word, and
a mask word on the device; a masked element copies d_in to d_out and
reports no change. ``bf_relax_out`` is the same kernel at B = 1 with no
mask.
"""

from __future__ import annotations

import ctypes

import torch

from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, stream_ptr,
)
from poseidon_tpu_torch.kernels.cs_sweep import csr_tails
from poseidon_tpu_torch.kernels.csr_plan import CsrPlan, plan_args
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library
from poseidon_tpu_torch.kernels.ssp_loop import D, SspLoop, round_tail_plain

INF_K = 2**50   # cost_scaling.py's "no path" distance
INF = 2**30     # ssp.py's

KERNEL = Kernel(
    name="bf_relax",
    source="poseidon_tpu_torch/kernels/csrc/bf_relax.cu",
    replaces="poseidon_tpu/ops/cost_scaling.py:193",
)


def bf_relax_out_plain(seg, head, ln, d_in, d_out, changed):
    """The reference's ``bf_round`` restated over the CSR positions; ``ln``
    is INF_K on arcs without residual capacity."""
    NN = seg.shape[0] - 1
    node = csr_tails(seg)
    dh = d_in[head.long()]
    via = torch.where((ln < INF_K) & (dh < INF_K), dh + ln, INF_K)
    best = torch.full((NN,), INF_K, dtype=torch.int64,
                      device=seg.device).scatter_reduce_(0, node, via, "amin")
    new = torch.minimum(d_in, best)
    d_out.copy_(new)
    changed.copy_((new < d_in).any().to(torch.int32).reshape(1))


def bf_relax_out_batch_plain(seg, head, ln, d_in, d_out, changed, mask):
    """``bf_relax_out_plain`` over a batch in one pass, restated over the
    positions that can lower a distance (residual capacity, a finite
    head distance, a running element), each element's nodes at its own
    offset in the flattened [B * NN] vector; an element whose ``mask``
    word is 0 relaxes no arc."""
    B, NN = d_in.shape
    R = head.shape[0]
    dh = d_in.index_select(1, head.long())
    on = (ln < INF_K) & (dh < INF_K) & (mask != 0)[:, None]
    at = on.reshape(-1).nonzero().squeeze(1)                 # b * R + p
    key = at // R * NN + csr_tails(seg)[at % R]
    via = dh.reshape(-1)[at] + ln.reshape(-1)[at]
    best = torch.full((B * NN,), INF_K, dtype=torch.int64,
                      device=seg.device).scatter_reduce_(
        0, key, via, "amin").view(B, NN)
    new = torch.minimum(d_in, best)
    d_out.copy_(new)
    changed.copy_((new < d_in).any(dim=1).to(torch.int32))


def bf_relax_in_plain(seg, arc, head, mrc, dist_a, dist_b, pred,
                      loop: SspLoop):
    """The reference's ``round_`` restated over the CSR positions, then
    the round's end (``ssp_loop.round_tail_plain``): position p stands
    for the mirror m of ``arc[p]``, an in-arc of p's tail with tail
    ``head[p]``; ``mrc[p]`` is rc[m], or INF where m has no capacity
    left. The round reads ``dist_a`` and writes ``dist_b`` when the
    loop's dist parity is even, the other way when it is odd."""
    dist_in, dist_out = dist_a, dist_b
    if int(loop.words[D]) & 1:
        dist_in, dist_out = dist_out, dist_in
    NN = seg.shape[0] - 1
    F = arc.shape[0] // 2
    node = csr_tails(seg)
    m = torch.where(arc < F, arc + F, arc - F)
    ds = dist_in[head.long()]
    cand = torch.where((mrc < INF) & (ds < INF), ds + mrc, INF)
    best = torch.full((NN,), INF, dtype=torch.int32,
                      device=seg.device).scatter_reduce_(0, node, cand, "amin")
    improved = best < dist_in
    is_best = improved[node] & (cand < INF) & (cand == best[node])
    pred_new = torch.full((NN,), 2 * F, dtype=torch.int32,
                          device=seg.device).scatter_reduce_(
        0, node, torch.where(is_best, m, 2 * F), "amin")
    pred.copy_(torch.where(improved, pred_new, pred))
    dist_out.copy_(torch.minimum(dist_in, best))
    round_tail_plain(loop, improved.any())


@census_op("bf_relax")
def bf_relax_out(seg, head, ln, d_in, d_out, changed, plan: CsrPlan):
    """One round of the global price update: ``seg`` int32[NN + 1],
    ``head`` int32[2F], ``ln`` int64[2F] (INF_K where no residual
    capacity), ``d_in``/``d_out`` int64[NN], ``changed`` int32[1];
    ``plan`` the CSR's launch plan. CPU tensors take the plain twin, which
    needs no plan; CUDA tensors launch K10."""
    if not on_card(seg, head, ln, d_in, d_out, changed):
        bf_relax_out_plain(seg, head, ln, d_in, d_out, changed)
        return
    _launch_out(plan, seg, head, ln, d_in, d_out, changed, None, 1)


@census_op("bf_relax")
def bf_relax_out_batch(seg, head, ln, d_in, d_out, changed, mask,
                       plan: CsrPlan):
    """One round of the global price update for B elements over one CSR:
    ``ln`` int64[B, 2F], ``d_in``/``d_out`` int64[B, NN], ``changed``
    int32[B] (each element's "any improved" this round; 0 for a masked
    element) and ``mask`` int32[B] on the device (element b relaxes where
    ``mask[b]`` is non-zero and copies d_in to d_out where it is 0);
    ``seg``, ``head`` and ``plan`` as ``bf_relax_out``'s. CPU tensors take
    the plain twin; CUDA tensors launch K10 once for the batch."""
    if not on_card(seg, head, ln, d_in, d_out, changed, mask):
        bf_relax_out_batch_plain(seg, head, ln, d_in, d_out, changed, mask)
        return
    _launch_out(plan, seg, head, ln, d_in, d_out, changed, mask,
                d_in.shape[0])


def _launch_out(plan, seg, head, ln, d_in, d_out, changed, mask,
                B: int) -> None:
    NN = seg.shape[0] - 1
    R = head.shape[0]
    i32, i64 = torch.int32, torch.int64
    rows = () if mask is None else (B,)
    spec = (
        (seg, "seg", i32, (NN + 1,)), (head, "head", i32, (R,)),
        (ln, "ln", i64, (*rows, R)), (d_in, "d_in", i64, (*rows, NN)),
        (d_out, "d_out", i64, (*rows, NN)),
        (changed, "changed", i32, (B,)),
    )
    ptrs = [kernel_arg(t, name, dt, shape) for t, name, dt, shape in spec]
    m = None if mask is None else kernel_arg(mask, "mask", i32, (B,))
    pp = plan_args(plan, NN, R)
    with torch.cuda.device(d_in.device):
        err = library("bf_relax").bf_relax_out_launch(
            *pp, *ptrs[1:], m, plan.n_heavy, plan.n_light, NN, R, B,
            stream_ptr(d_in))
    check_launch(KERNEL, err)
    KERNEL.launches += 1


@census_op("bf_relax")
def bf_relax_in(seg, arc, head, mrc, dist_a, dist_b, pred, plan: CsrPlan,
                loop: SspLoop):
    """One SSP relaxation round and its end: ``seg`` int32[NN + 1],
    ``arc``/``head``/``mrc`` int32[2F], ``dist_a``/``dist_b``/``pred``
    int32[NN] (pred in place); ``plan`` the CSR's launch plan; ``loop``
    the solve's loop words (``kernels/ssp_loop.py``): when its dist parity
    is even the round reads ``dist_a`` and writes ``dist_b``, when it is
    odd the other way, and the round's end advances the word, counts the
    round and decides the round loop. CPU tensors take the plain twin,
    which needs no plan; CUDA tensors launch K10."""
    if not on_card(seg, arc, head, mrc, dist_a, dist_b, pred, loop.words):
        bf_relax_in_plain(seg, arc, head, mrc, dist_a, dist_b, pred, loop)
        return
    NN = seg.shape[0] - 1
    R = arc.shape[0]
    i32 = torch.int32
    spec = (
        (seg, "seg", i32, (NN + 1,)), (arc, "arc", i32, (R,)),
        (head, "head", i32, (R,)), (mrc, "mrc", i32, (R,)),
        (dist_a, "dist_a", i32, (NN,)), (dist_b, "dist_b", i32, (NN,)),
        (pred, "pred", i32, (NN,)),
    )
    ptrs = [kernel_arg(t, name, dt, shape) for t, name, dt, shape in spec]
    pp = plan_args(plan, NN, R)
    with torch.cuda.device(dist_a.device):
        err = library("bf_relax").bf_relax_in_launch(
            *pp, *ptrs[1:], plan.n_heavy, plan.n_light, R // 2,
            ctypes.byref(loop.c), stream_ptr(dist_a))
    check_launch(KERNEL, err)
    KERNEL.launches += 1
