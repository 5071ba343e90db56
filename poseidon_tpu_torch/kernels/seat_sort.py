"""K13 ``seat_sort``: the auction loop's seat-layout sorts (a
lexicographic sort of 1-4 int32 keys, returning the sorted keys) and the
bid window's compaction, and their plain twins.

Replaces ``poseidon_tpu/ops/dense_auction.py:629`` (``to_sorted``),
``:770`` (``auction_round``), ``:872`` (``release``) and ``:710`` (the
compaction): ``jax.lax.sort`` each. The CUDA source is
``csrc/seat_sort.cu``; its header note gives the bound and the design.

Every key comes with its domain, a span (lo, hi) the caller states and
the packed key is built from: a key's field takes ``(hi - lo)
.bit_length()`` bits. On the CPU the wrapper checks each key against its
span before it runs the twin, so every CPU test of a solve also holds
the callers' domains; on the card a key outside its span would be cut to
its field, so the span must hold by construction.

The launch plans (``sort_plan``, ``compact_plan``) are host arithmetic,
made once per device and shape, so the CPU tests reach them.
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

KERNEL = Kernel(
    name="seat_sort",
    source="poseidon_tpu_torch/kernels/csrc/seat_sort.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:770",
)

INT32 = (-2**31, 2**31 - 1)   # the span of a key with no narrower domain
MAX_KEYS = 4
DIGIT_BITS = 8
BLOCK_WARPS = 16              # a block of the shared-memory sort: 512 threads
RADIX = 256
MAX_PASSES = 16
CLUSTER = 8                   # blocks of the shared-memory sort's cluster
# shared memory of a cluster block before its two key buffers
# (csrc/seat_sort.cu BLOCK_FIXED_INTS)
BLOCK_FIXED_BYTES = (BLOCK_WARPS * RADIX + 2 * RADIX + 32 + MAX_PASSES) * 4
TILE = 4096                   # keys a tile of the tiled sort
COMPACT_CHUNK = 8192          # flags a compaction block scans at once
COMPACT_ONE_BLOCK = 65536     # flags one compaction block takes alone
COMPACT_MAX_BLOCKS = 1024


def field_bits(span: tuple[int, int]) -> int:
    lo, hi = span
    if not INT32[0] <= lo <= hi <= INT32[1]:
        raise ValueError(f"seat_sort: span {span} is not an int32 range")
    return (hi - lo).bit_length()


@dataclasses.dataclass(frozen=True)
class SortPlan:
    words: int    # 64-bit words of a packed key (1, or 2 past 64 bits)
    passes: int   # 8-bit digit passes
    cluster: int  # blocks of the shared-memory sort (CLUSTER), 0: tiles
    smem: int     # a cluster block's dynamic shared memory
    tiles: int    # the tiled method's tiles of TILE keys (0 for a cluster)


def block_smem(n: int, words: int, cluster: int) -> int:
    """Shared memory of one block of a ``cluster``-block sort of n keys:
    its counters and both buffers of its ceil(n / cluster) keys."""
    return BLOCK_FIXED_BYTES + 2 * words * 8 * -(-n // cluster)


def sort_plan(n: int, bits: tuple[int, ...], smem_optin: int) -> SortPlan:
    """The method for n keys of these field widths on a card whose
    block may take ``smem_optin`` bytes of shared memory: a cluster of
    CLUSTER blocks where each block's share of both key buffers fits
    beside its counters, else tiles of 4,096."""
    if n < 1 or not 1 <= len(bits) <= MAX_KEYS:
        raise ValueError(f"seat_sort: n={n}, {len(bits)} keys")
    width = sum(bits)
    words = 1 if width <= 64 else 2
    passes = -(-width // DIGIT_BITS)
    smem = block_smem(n, words, CLUSTER)
    if smem <= smem_optin:
        return SortPlan(words=words, passes=passes, cluster=CLUSTER,
                        smem=smem, tiles=0)
    return SortPlan(words=words, passes=passes, cluster=0, smem=0,
                    tiles=-(-n // TILE))


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    blocks: int      # one block, or a count launch and a write launch
    per_block: int   # flags a block covers (a multiple of COMPACT_CHUNK)


def compact_plan(n: int, sm_count: int) -> CompactPlan:
    if n < 1:
        raise ValueError(f"seat_compact: n={n}")
    if n <= COMPACT_ONE_BLOCK:
        return CompactPlan(blocks=1, per_block=n)
    per = -(-n // min(2 * sm_count, COMPACT_MAX_BLOCKS))
    per = -(-per // COMPACT_CHUNK) * COMPACT_CHUNK
    return CompactPlan(blocks=-(-n // per), per_block=per)


class _Plans:
    """Sort and compaction plans by device and shape, made on first use
    (the card's shared-memory limit is read once a device)."""

    def __init__(self):
        self._plans: dict[tuple, object] = {}
        self._optin: dict = {}

    def _smem_optin(self, device) -> int:
        got = self._optin.get(device)
        if got is None:
            optin = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = library("seat_sort").seat_sort_setup(ctypes.byref(optin))
            if err != 0:
                raise RuntimeError(f"seat_sort setup failed: cudaError {err}")
            got = self._optin[device] = optin.value
        return got

    def sort(self, device, n: int, bits: tuple[int, ...]) -> SortPlan:
        key = ("sort", device, n, bits)
        p = self._plans.get(key)
        if p is None:
            p = self._plans[key] = sort_plan(n, bits, self._smem_optin(device))
            note_build()
        return p

    def compact(self, device, n: int) -> CompactPlan:
        key = ("compact", device, n)
        p = self._plans.get(key)
        if p is None:
            p = self._plans[key] = compact_plan(n, sm_count(device))
            note_build()
        return p

    def __getitem__(self, key: tuple):
        return self._plans[key]

    def __len__(self) -> int:
        return len(self._plans)


PLANS = _Plans()


def seat_sort_plain(*keys: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Stable lexicographic sort of equal-length 1-D keys, first key most
    significant (``jax.lax.sort`` with ``num_keys=len(keys)``): stable
    passes from the last key to the first. Returns the sorted keys."""
    perm = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return tuple(k[perm] for k in keys)


def seat_compact_plain(waiting: torch.Tensor, B: int) -> torch.Tensor:
    """``sort(where(waiting, pos, n))[:B]``: the waiting positions in
    ascending order, then the fill n."""
    n = waiting.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=waiting.device)
    return torch.sort(torch.where(waiting, pos, n)).values[:B]


def _check_spans(keys, spans) -> None:
    """Raise where a CPU key leaves its span (read through numpy: a
    host-side guard, outside the recorded op stream)."""
    for i, (k, (lo, hi)) in enumerate(zip(keys, spans)):
        a = k.numpy()
        if a.size and (int(a.min()) < lo or int(a.max()) > hi):
            raise ValueError(
                f"seat_sort: key {i} in [{int(a.min())}, {int(a.max())}] "
                f"leaves its span [{lo}, {hi}]")


@census_op("seat_sort")
def seat_sort(keys, spans) -> tuple[torch.Tensor, ...]:
    """The keys (1-4 int32[n] tensors on one device, the first most
    significant) sorted lexicographically. ``spans[i] = (lo, hi)`` bounds
    key i. CPU tensors take the plain twin (after the span check); CUDA
    tensors launch K13 (one launch where the keys fit in the shared
    memory of an 8-block cluster, else 3 launches a digit pass and
    two)."""
    keys = tuple(keys)
    spans = tuple(spans)
    if len(keys) != len(spans) or not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"seat_sort: {len(keys)} keys, {len(spans)} spans")
    bits = tuple(field_bits(sp) for sp in spans)
    if not on_card(*keys):
        _check_spans(keys, spans)
        return seat_sort_plain(*keys)
    n = keys[0].shape[0]
    dev = keys[0].device
    i32 = torch.int32
    ins = [kernel_arg(k, f"key {i}", i32, (n,)) for i, k in enumerate(keys)]
    outs = [torch.empty(n, dtype=i32, device=dev) for _ in keys]
    pad = MAX_KEYS - len(keys)
    with torch.cuda.device(dev):
        lib = library("seat_sort")
        p = PLANS.sort(dev, n, bits)
        if p.cluster:
            buf = hist = None
        else:
            buf = torch.empty(2 * p.words * n, dtype=torch.int64, device=dev)
            hist = torch.empty(RADIX * p.tiles, dtype=i32, device=dev)
        err = lib.seat_sort_launch(
            *ins, *[None] * pad, *[o.data_ptr() for o in outs], *[None] * pad,
            n, len(keys), *[sp[0] for sp in spans], *[0] * pad,
            *bits, *[0] * pad, p.words, p.cluster, p.smem, p.tiles,
            None if buf is None else buf.data_ptr(),
            None if hist is None else hist.data_ptr(), stream_ptr(keys[0]),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return tuple(outs)


@census_op("seat_compact")
def seat_compact(waiting: torch.Tensor, B: int) -> torch.Tensor:
    """int32[B]: the positions where ``waiting`` (bool[n]) is set, in
    ascending order, then n, cut at B. CPU tensors take the plain twin;
    CUDA tensors launch K13's compaction (one launch up to 65,536 flags,
    else two)."""
    if not on_card(waiting):
        return seat_compact_plain(waiting, B)
    n = waiting.shape[0]
    if not 1 <= B:
        raise ValueError(f"seat_compact: B={B}")
    dev = waiting.device
    out = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = library("seat_sort")
        p = PLANS.compact(dev, n)
        counts = (torch.empty(p.blocks, dtype=torch.int32, device=dev)
                  if p.blocks > 1 else None)
        err = lib.seat_compact_launch(
            kernel_arg(waiting, "waiting", torch.bool, (n,)), n, B, p.blocks,
            p.per_block, None if counts is None else counts.data_ptr(),
            out.data_ptr(), stream_ptr(waiting),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return out
