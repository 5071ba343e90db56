"""K12 ``top_will``: the clearing level of the deflate step (the
(clamp(s - 1, 0, smax - 1) + 1)-th largest willingness of every machine
column), and its plain twin.

Replaces ``poseidon_tpu/ops/dense_auction.py:830`` (``deflate``'s will
table, ``jax.lax.top_k(will.T, smax)`` and the gather at l.831-833). The
CUDA source is ``csrc/top_will.cu``; its header note gives the byte
bound and the design. The launch plan (``plan``: the method by smax, the
list length, the row slabs) is host arithmetic, made once per device and
shape, so the CPU tests reach it.

One call covers the whole table or, under a row-block mesh, every shard:
``parts`` holds one (c, alt1, alt2, m1, task_valid) tuple a shard, each
on its shard's device, and the result lands on the device of ``s``.
"""

from __future__ import annotations

import dataclasses

import torch

from poseidon_tpu_torch.guards import note_build
from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, sm_count, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29

KERNEL = Kernel(
    name="top_will",
    source="poseidon_tpu_torch/kernels/csrc/top_will.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:830",
)

LIST_KS = (1, 2, 4, 8, 16, 32)   # the list method's lengths (LIST_MAX = 32)
LIST_THREADS = 128               # columns of a list block (csrc LIST_THREADS)
HIST_COLS = 32                   # columns of a histogram block
BINS = 256
RADIX_PASSES = 4                 # one a byte of the int32 key
LIST_BLOCKS_PER_SM = 4           # list blocks the plan aims to keep on an SM
HIST_BLOCKS_PER_SM = 6           # histogram blocks (32 KiB of shared memory each)


@dataclasses.dataclass(frozen=True)
class Plan:
    method: str          # "list" (one pass and a merge) or "radix"
    k: int               # the list length (0 for radix)
    slabs: int           # row slabs of the shard (the grid's y)
    rows_per_slab: int


def plan(rows: int, Mp: int, smax: int, sm_count: int) -> Plan:
    """The method and the slabs of one shard of ``rows`` rows: the list
    method, its length smax rounded up to a power of two, while smax <=
    32; radix selection above. Slabs split the rows so that the grid
    (column blocks x slabs) fills the card about once, but a list slab
    keeps at least 4 K rows (the merge reads K values a slab and a
    column) and a histogram slab at least 8 (one a warp)."""
    if rows < 1 or Mp < 1 or not 1 <= smax:
        raise ValueError(f"top_will: rows={rows}, Mp={Mp}, smax={smax}")
    if smax <= LIST_KS[-1]:
        k = next(x for x in LIST_KS if x >= smax)
        col_blocks = -(-Mp // LIST_THREADS)
        want = -(-sm_count * LIST_BLOCKS_PER_SM // col_blocks)
        min_rows = 4 * k
        method = "list"
    else:
        k = 0
        col_blocks = -(-Mp // HIST_COLS)
        want = -(-sm_count * HIST_BLOCKS_PER_SM // col_blocks)
        min_rows = 8
        method = "radix"
    slabs = max(1, min(want, rows // min_rows))
    per = -(-rows // slabs)
    return Plan(method=method, k=k, slabs=-(-rows // per), rows_per_slab=per)


def slab_rows(p: Plan, rows: int, slab: int) -> range:
    """The rows slab ``slab`` of a plan covers (the kernels' r0, r1)."""
    r0 = slab * p.rows_per_slab
    return range(r0, min(rows, r0 + p.rows_per_slab))


class PlanCache:
    """Plans by (device, rows, Mp, smax), made on first use."""

    def __init__(self):
        self._plans: dict[tuple, Plan] = {}

    def get(self, device, rows: int, Mp: int, smax: int) -> Plan:
        key = (device, rows, Mp, smax)
        p = self._plans.get(key)
        if p is None:
            p = self._plans[key] = plan(rows, Mp, smax, sm_count(device))
            note_build()
        return p

    def __getitem__(self, key: tuple) -> Plan:
        return self._plans[key]

    def __len__(self) -> int:
        return len(self._plans)


PLANS = PlanCache()


def top_will_plain(parts, s, smax: int):
    """The reference lines restated in PyTorch: ``top_k(will.T, smax)``
    values per machine (under a mesh each shard's top ``min(smax,
    rows)`` and one more ``topk`` over the candidates: only values are
    read, so the result is the same), gathered at ``clamp(s - 1, 0,
    smax - 1)``. int32[Mp] on the device of ``s``."""
    def will_of(cb, a1, a2, mm, tv):
        mids = torch.arange(cb.shape[1], dtype=torch.int32, device=cb.device)
        alt = torch.where(mids[None, :] == mm[:, None], a2[:, None],
                          a1[:, None])
        will = torch.clamp(alt - cb, -INF, INF)
        return torch.where(tv[:, None], will, -INF)

    if len(parts) == 1:
        will = will_of(*parts[0])
        topw = torch.topk(will.T.contiguous(), smax, dim=1).values
    else:
        cands = [
            torch.topk(will_of(*p).T.contiguous(),
                       min(smax, p[0].shape[0]), dim=1).values.to(s.device)
            for p in parts
        ]
        topw = torch.topk(torch.cat(cands, dim=1), smax, dim=1).values
    sidx = torch.clamp(s - 1, 0, smax - 1)
    return topw.to(s.device).gather(1, sidx[:, None].long())[:, 0]


def _shard_args(part):
    c, alt1, alt2, m1, tv = part
    rows, Mp = c.shape
    i32 = torch.int32
    return (
        kernel_arg(c, "c", i32, (rows, Mp)),
        kernel_arg(alt1, "alt1", i32, (rows,)),
        kernel_arg(alt2, "alt2", i32, (rows,)),
        kernel_arg(m1, "m1", i32, (rows,)),
        kernel_arg(tv, "task_valid", torch.bool, (rows,)),
    )


@census_op("top_will")
def top_will(parts, s, smax: int):
    """The k-th largest willingness per machine column, k = clamp(s - 1,
    0, smax - 1) + 1: int32[Mp] on the device of ``s``. ``parts`` is a
    sequence of (c[rows, Mp] int32, alt1/alt2/m1[rows] int32,
    task_valid[rows] bool), one a row block, each on one device; smax
    lies in [1, total rows]. CPU tensors take the plain twin; CUDA
    tensors launch K12 (a slab pass a shard and a merge, or four count
    passes a shard and four picks)."""
    parts = [tuple(p) for p in parts]
    kinds = {on_card(*p) for p in parts} | {on_card(s)}
    if len(kinds) != 1:
        raise ValueError("top_will: CPU and CUDA tensors mixed")
    if not kinds.pop():
        return top_will_plain(parts, s, smax)
    Mp = parts[0][0].shape[1]
    total = sum(p[0].shape[0] for p in parts)
    if any(p[0].shape[1] != Mp for p in parts):
        raise ValueError("top_will: shards differ in Mp")
    if not 1 <= smax <= total:
        raise ValueError(f"top_will: smax={smax} outside [1, {total}]")
    i32 = torch.int32
    home = s.device
    s_ptr = kernel_arg(s, "s", i32, (Mp,))
    out = torch.empty(Mp, dtype=i32, device=home)
    plans = [PLANS.get(p[0].device, p[0].shape[0], Mp, smax) for p in parts]
    with torch.cuda.device(home):
        lib = library("top_will")
    if plans[0].method == "list":
        _list(lib, parts, plans, Mp, s_ptr, smax, out)
    else:
        _radix(lib, parts, plans, Mp, s, smax, out)
    KERNEL.launches += 1
    return out


def _list(lib, parts, plans, Mp, s_ptr, smax, out):
    """One slab pass a shard into its rows of ``lists``, then the merge."""
    K = plans[0].k
    home = out.device
    n_lists = sum(p.slabs for p in plans)
    lists = torch.empty((n_lists, K, Mp), dtype=torch.int32, device=home)
    at = 0
    for part, p in zip(parts, plans):
        dev = part[0].device
        dst = lists[at:at + p.slabs] if dev == home else torch.empty(
            (p.slabs, K, Mp), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.top_will_list_launch(
                *_shard_args(part), part[0].shape[0], Mp, K, p.slabs,
                p.rows_per_slab, dst.data_ptr(), stream_ptr(part[0]))
        check_launch(KERNEL, err)
        if dev != home:
            lists[at:at + p.slabs].copy_(dst)
        at += p.slabs
    with torch.cuda.device(home):
        err = lib.top_will_merge_launch(lists.data_ptr(), n_lists, Mp, K,
                                        s_ptr, smax, out.data_ptr(),
                                        stream_ptr(out))
    check_launch(KERNEL, err)


def _radix(lib, parts, plans, Mp, s, smax, out):
    """Four passes: every shard counts byte q into its part of ``hist``,
    then one pick a column fixes the byte."""
    home = out.device
    hist = torch.zeros((len(parts), BINS, Mp), dtype=torch.int32, device=home)
    state = torch.empty((2, Mp), dtype=torch.int32, device=home)
    own = [
        hist[q] if part[0].device == home else torch.zeros(
            (BINS, Mp), dtype=torch.int32, device=part[0].device)
        for q, part in enumerate(parts)
    ]
    args = [_shard_args(part) for part in parts]
    for q in range(RADIX_PASSES):
        for i, (part, p) in enumerate(zip(parts, plans)):
            dev = part[0].device
            st = state if dev == home else state.to(dev)
            with torch.cuda.device(dev):
                err = lib.top_will_hist_launch(
                    *args[i], part[0].shape[0], Mp, p.slabs,
                    p.rows_per_slab, q, st.data_ptr(), own[i].data_ptr(),
                    stream_ptr(part[0]))
            check_launch(KERNEL, err)
            if dev != home:
                hist[i].copy_(own[i])
                own[i].zero_()
        with torch.cuda.device(home):
            err = lib.top_will_pick_launch(
                hist.data_ptr(), len(parts), Mp, q, s.data_ptr(), smax,
                state.data_ptr(), out.data_ptr(), stream_ptr(out))
        check_launch(KERNEL, err)
