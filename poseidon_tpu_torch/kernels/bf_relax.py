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
    NN = seg.shape[0] - 1
    R = head.shape[0]
    i32, i64 = torch.int32, torch.int64
    spec = (
        (seg, "seg", i32, (NN + 1,)), (head, "head", i32, (R,)),
        (ln, "ln", i64, (R,)), (d_in, "d_in", i64, (NN,)),
        (d_out, "d_out", i64, (NN,)), (changed, "changed", i32, (1,)),
    )
    ptrs = [kernel_arg(t, name, dt, shape) for t, name, dt, shape in spec]
    pp = plan_args(plan, NN, R)
    with torch.cuda.device(d_in.device):
        err = library("bf_relax").bf_relax_out_launch(
            *pp, *ptrs[1:], plan.n_heavy, plan.n_light, stream_ptr(d_in))
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
