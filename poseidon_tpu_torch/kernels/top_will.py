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

import ctypes
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
LIST_COLS = 32                   # columns of a list block, a lane each (csrc)
LIST_CLUSTER = 4                 # blocks of a list cluster: one column group's slabs
LIST_CLUSTER_MAX = 8             # a portable cluster (csrc)
LIST_STAMPS = 8                  # int64 phase stamps of a list launch (csrc)
HIST_COLS = 16                   # columns of a histogram block (csrc)
BINS = 2048                      # the widest digit's bins (csrc)
DIGIT_BITS = (11, 11, 10)        # the radix passes' digits, most significant first
RADIX_PASSES = len(DIGIT_BITS)


@dataclasses.dataclass(frozen=True)
class Plan:
    method: str          # "list" (one cluster launch) or "radix"
    k: int               # the list length (0 for radix)
    slabs: int           # row slabs: a list cluster's blocks, the radix grid's y
    rows_per_slab: int
    col_blocks: int      # the grid's x: column groups (LIST_COLS or HIST_COLS)


def plan(rows: int, Mp: int, smax: int, sm_count: int,
         resident=None) -> Plan:
    """The method and the slabs of one shard of ``rows`` rows: the list
    method, its length smax rounded up to a power of two, while smax <=
    32; radix selection above. A list launch is one cluster a column
    group of 32, its blocks the row slabs: at most LIST_CLUSTER, each of
    at least 4 K rows (so a block's fold outweighs its merges), and the
    most for which ``resident(k, slabs)`` (the clusters the card holds at
    once; None: all of them) covers every column group, so that the
    launch is one wave (one block an SM); radix slabs split the rows so
    that the grid (column blocks x slabs, one block an SM) is one wave
    of at most ``sm_count`` blocks, a slab at least 8 rows."""
    if rows < 1 or Mp < 1 or not 1 <= smax:
        raise ValueError(f"top_will: rows={rows}, Mp={Mp}, smax={smax}")
    if smax <= LIST_KS[-1]:
        k = next(x for x in LIST_KS if x >= smax)
        col_blocks = -(-Mp // LIST_COLS)
        slabs = max(1, min(LIST_CLUSTER, rows // (4 * k)))
        if resident is not None:
            slabs = next((n for n in range(slabs, 0, -1)
                          if resident(k, n) >= col_blocks), slabs)
    else:
        k = 0
        col_blocks = -(-Mp // HIST_COLS)
        slabs = max(1, min(sm_count // col_blocks, rows // 8))
    per = -(-rows // slabs)
    method = "list" if k else "radix"
    return Plan(method=method, k=k, slabs=-(-rows // per), rows_per_slab=per,
                col_blocks=col_blocks)


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
            p = self._plans[key] = plan(
                rows, Mp, smax, sm_count(device),
                lambda k, slabs: _resident(device, Mp, k, slabs))
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
    tensors launch K12 (the list method: one launch, and under a mesh
    one a shard and a merge; radix: three count passes a shard and three
    picks)."""
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


def _list_launch(lib, part, p: Plan, s_ptr, smax, out, lists, stamps=None):
    """One list launch over one shard: ``out`` (the k-th values), or the
    K-entry ``lists`` of every column where ``lists`` is given; ``lib``
    the stamps build where ``stamps`` (int64[LIST_STAMPS]) is given."""
    with torch.cuda.device(part[0].device):
        err = lib.top_will_list_launch(
            *_shard_args(part), part[0].shape[0], part[0].shape[1], p.k,
            p.slabs, p.rows_per_slab, s_ptr, smax,
            None if out is None else out.data_ptr(),
            None if lists is None else lists.data_ptr(),
            *([] if stamps is None else [stamps.data_ptr()]),
            stream_ptr(part[0]))
    check_launch(KERNEL, err)


def _list(lib, parts, plans, Mp, s_ptr, smax, out):
    """One launch for a whole table; under a mesh one a shard into its
    row of ``lists``, then the merge of the shards' lists."""
    if len(parts) == 1:
        _list_launch(lib, parts[0], plans[0], s_ptr, smax, out, None)
        return
    K = plans[0].k
    home = out.device
    lists = torch.empty((len(parts), K, Mp), dtype=torch.int32, device=home)
    for q, (part, p) in enumerate(zip(parts, plans)):
        dev = part[0].device
        dst = lists[q] if dev == home else torch.empty(
            (K, Mp), dtype=torch.int32, device=dev)
        _list_launch(lib, part, p, s_ptr, smax, None, dst)
        if dev != home:
            lists[q].copy_(dst)
    with torch.cuda.device(home):
        err = lib.top_will_merge_launch(lists.data_ptr(), len(parts), Mp, K,
                                        s_ptr, smax, out.data_ptr(),
                                        stream_ptr(out))
    check_launch(KERNEL, err)


def _resident(device, Mp: int, k: int, slabs: int) -> int:
    """Clusters of a list launch over Mp columns in ``slabs`` slabs that
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    got = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = library("top_will").top_will_list_clusters(
            Mp, k, slabs, ctypes.byref(got))
    check_launch(KERNEL, err)
    return got.value


def list_clusters(device, Mp: int, smax: int, rows: int) -> dict[int, int]:
    """The clusters the card holds at once for each slab count of this
    shape's list launch: a diagnostic ``chip_smoke.py`` prints beside the
    plan."""
    k = PLANS.get(device, rows, Mp, smax).k
    return {n: _resident(device, Mp, k, n)
            for n in range(1, LIST_CLUSTER_MAX + 1)}


def phase_stamps(part, s, smax: int) -> list[int]:
    """One list launch of K12 over one table part by the stamps build,
    its phase stamps (clock64() on one SM: start, folded, the block's
    tree, the cluster's read, written). A measurement, not a call of the
    main path: the launch is not counted."""
    Mp = part[0].shape[1]
    p = PLANS.get(part[0].device, part[0].shape[0], Mp, smax)
    if p.method != "list":
        raise ValueError(f"top_will: smax={smax} takes the radix method")
    out = torch.empty(Mp, dtype=torch.int32, device=s.device)
    stamps = torch.full((LIST_STAMPS,), -1, dtype=torch.int64, device=s.device)
    _list_launch(library("top_will_stamps"), part, p,
                 kernel_arg(s, "s", torch.int32, (Mp,)), smax, out, None,
                 stamps)
    return stamps.tolist()


def _radix(lib, parts, plans, Mp, s, smax, out):
    """RADIX_PASSES passes: every shard counts digit q into its part of
    ``hist``, then one pick a column fixes the digit."""
    home = out.device
    hist = torch.zeros((len(parts), Mp, BINS), dtype=torch.int32, device=home)
    state = torch.empty((2, Mp), dtype=torch.int32, device=home)
    own = [
        hist[q] if part[0].device == home else torch.zeros(
            (Mp, BINS), dtype=torch.int32, device=part[0].device)
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
