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
DIGIT_BITS = 8                # a digit pass of the onesweep method
RADIX = 256
MAX_PASSES = 16               # digit passes of a 128-bit key
# the onesweep method (csrc/seat_sort.cu SWEEP_*, HIST_*, WORK_HEAD, ...)
SWEEP_THREADS = 512           # a pass block; its tile SWEEP_THREADS x rounds keys
SWEEP_ROUNDS = (8, 4)         # a warp's rounds of 32 keys, largest first
SWEEP_MIN_TILES = 64          # tiles the plan keeps a pass at (or the smallest tile)
SWEEP_FIXED_INTS = 4656       # a pass block's ints beside its tile
STRIDE_KEYS = 32              # a buffer row's keys: a multiple of 32
HIST_THREADS = 512            # the up-front block
HIST_ITEMS = 8                # keys a thread of the up-front block
WORK_HEAD = 32                # the workspace's ints after the histograms
STATUS_COUNT_BITS = 26        # a look-back word's count: n < 2^26
# the split method (csrc/seat_sort.cu SPLIT_*, SMALL, DIGIT_MAX)
SPLIT_THREADS = 1024
SPLIT_CLUSTER = 8             # blocks of the split's cluster
SPLIT_MAX_N = 32768           # keys of a split (a bin's count in 16 bits)
SMALL = 32                    # a bucket the last step ranks as it is
DIGIT_MAX = 11                # bits of a level's digit
SPLIT_FIXED_INTS = 48
METHODS = {"onesweep": 0, "split": 1}   # csrc METHOD_*
# the stamps build's slots (csrc STAMP_*): clock64() at the split's phase
# ends; levels and steps are counted from 0
STAMPS = 32
STAMP_START = 0
STAMP_PACKED = 1
STAMP_LEVEL = 2               # the end of level l at STAMP_LEVEL + l
STAMP_LEVEL_MAX = 8
STAMP_STEPS = (18, 10)        # level l < 2: its steps' ends from here on
STEPS = ("digits", "count+barrier", "read counts", "scan", "cursors+heads",
         "scatter+barrier")
STAMP_LEVELS = 24             # the number of levels
STAMP_LISTED = 25             # keys split at level l at STAMP_LISTED + l
STAMP_LISTED_MAX = 6
STAMP_END = 31
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
    words: int        # 64-bit words of a packed key (1, or 2 past 64 bits)
    passes: int       # 8-bit digit passes of the onesweep method (at least 1)
    method: str       # "split" or "onesweep"
    cluster: int = 0  # blocks of the split's cluster
    smem: int = 0     # dynamic shared memory of a split or pass block
    tiles: int = 0    # the onesweep's tiles of SWEEP_THREADS x rounds keys
    rounds: int = 0   # a warp's rounds of 32 keys in a onesweep tile
    stride: int = 0   # keys a row of the onesweep's buffer pair
    hist_blocks: int = 0   # blocks of the onesweep's up-front launch
    work: int = 0     # int32 of the onesweep's workspace

    @property
    def tile(self) -> int:
        return SWEEP_THREADS * self.rounds


def split_lmax(n: int) -> int:
    """Buckets of more than SMALL keys that n keys can hold, plus one."""
    return n // (SMALL + 1) + 1


def split_smem(n: int, words: int, cluster: int) -> int:
    """Shared memory of a split block for n keys over ``cluster`` blocks
    (csrc ``split_smem``): the block's two key buffers of ceil(n /
    cluster) keys, its part of each listed bucket's AND and OR, then
    ints: its counts, cursors and next-level slots of the bins (at most
    n / 2 a level), the head bitmap, nine bucket lists, the warp sums and
    the scalars."""
    chunk = -(-n // cluster)
    lmax = split_lmax(n)
    ints = 3 * ((n + 1) // 2) + n // 32 + 2 + 9 * lmax + SPLIT_FIXED_INTS
    return 16 * words * (chunk + lmax) + 4 * ints


def sweep_smem(words: int, rounds: int) -> int:
    """Shared memory of a onesweep pass block (csrc ``sweep_smem``): its
    tile's keys, then SWEEP_FIXED_INTS ints (each warp's count of each
    digit, each digit's offset and tile start, the warp sums and the
    scalars)."""
    return 8 * words * SWEEP_THREADS * rounds + 4 * SWEEP_FIXED_INTS


def sweep_work(passes: int, tiles: int) -> int:
    """Ints of the onesweep's workspace (csrc ``Work``): every pass's
    histogram, WORK_HEAD ints (the finished up-front blocks, the live
    mask, a tile counter a pass), a look-back word per tile and digit."""
    return passes * RADIX + WORK_HEAD + tiles * RADIX


def onesweep_plan(n: int, bits: tuple[int, ...], rounds: int) -> SortPlan:
    """The onesweep method for n keys of these field widths at tiles of
    SWEEP_THREADS x ``rounds`` keys."""
    if rounds not in SWEEP_ROUNDS:
        raise ValueError(f"seat_sort: rounds={rounds}")
    if not 1 <= n < 2 ** STATUS_COUNT_BITS:
        raise ValueError(f"seat_sort: n={n} past the onesweep's look-back words")
    width = sum(bits)
    words = 1 if width <= 64 else 2
    passes = max(1, -(-width // DIGIT_BITS))
    tiles = -(-n // (SWEEP_THREADS * rounds))
    return SortPlan(
        words=words, passes=passes, method="onesweep",
        smem=sweep_smem(words, rounds), tiles=tiles, rounds=rounds,
        stride=-(-n // STRIDE_KEYS) * STRIDE_KEYS,
        hist_blocks=-(-n // (HIST_THREADS * HIST_ITEMS)),
        work=sweep_work(passes, tiles))


def sort_plan(n: int, bits: tuple[int, ...], smem_optin: int) -> SortPlan:
    """The method for n keys of these field widths on a card whose
    block may take ``smem_optin`` bytes of shared memory: the split over
    SPLIT_CLUSTER blocks while n <= SPLIT_MAX_N and a block's share
    fits, else the onesweep at the largest tile that still gives
    SWEEP_MIN_TILES tiles (the smallest tile below that)."""
    if n < 1 or not 1 <= len(bits) <= MAX_KEYS:
        raise ValueError(f"seat_sort: n={n}, {len(bits)} keys")
    width = sum(bits)
    words = 1 if width <= 64 else 2
    smem = split_smem(n, words, SPLIT_CLUSTER)
    if n <= SPLIT_MAX_N and smem <= smem_optin:
        return SortPlan(words=words, passes=max(1, -(-width // DIGIT_BITS)),
                        method="split", cluster=SPLIT_CLUSTER, smem=smem)
    rounds = next((r for r in SWEEP_ROUNDS
                   if -(-n // (SWEEP_THREADS * r)) >= SWEEP_MIN_TILES),
                  SWEEP_ROUNDS[-1])
    return onesweep_plan(n, bits, rounds)


def split_digit(width: int, size: int) -> int:
    """Bits of the digit that splits a bucket of ``size`` keys whose
    keys vary in their low ``width`` bits (csrc: min(width, DIGIT_MAX,
    log2(size) - 1); 0 where the keys are all equal)."""
    if width == 0:
        return 0
    return min(width, DIGIT_MAX, size.bit_length() - 2)


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


def _launch(keys, spans, p: SortPlan, stamps=None) -> tuple[torch.Tensor, ...]:
    """Launch K13 on CUDA keys by plan ``p``; with ``stamps`` (an
    int64[STAMPS] tensor) the stamps build's kernel, which writes its
    phase stamps there."""
    n = keys[0].shape[0]
    dev = keys[0].device
    i32 = torch.int32
    ins = [kernel_arg(k, f"key {i}", i32, (n,)) for i, k in enumerate(keys)]
    outs = [torch.empty(n, dtype=i32, device=dev) for _ in keys]
    pad = MAX_KEYS - len(keys)
    bits = [field_bits(sp) for sp in spans]
    PLANS._smem_optin(dev)   # the kernels' shared-memory caps, once a device
    with torch.cuda.device(dev):
        lib = library("seat_sort" if stamps is None else "seat_sort_stamps")
        if p.method == "onesweep":
            buf = torch.empty(2 * p.words * p.stride, dtype=torch.int64,
                              device=dev)
            work = torch.empty(p.work, dtype=i32, device=dev)
        else:
            buf = work = None
        err = lib.seat_sort_launch(
            *ins, *[None] * pad, *[o.data_ptr() for o in outs], *[None] * pad,
            n, len(keys), *[sp[0] for sp in spans], *[0] * pad,
            *bits, *[0] * pad, p.words, METHODS[p.method], p.cluster, p.smem,
            p.tiles, p.rounds, p.stride, p.hist_blocks,
            None if buf is None else buf.data_ptr(),
            None if work is None else work.data_ptr(),
            *([] if stamps is None else [stamps.data_ptr()]), stream_ptr(keys[0]),
        )
    check_launch(KERNEL, err)
    return tuple(outs)


@census_op("seat_sort")
def seat_sort(keys, spans) -> tuple[torch.Tensor, ...]:
    """The keys (1-4 int32[n] tensors on one device, the first most
    significant) sorted lexicographically. ``spans[i] = (lo, hi)`` bounds
    key i. CPU tensors take the plain twin (after the span check); CUDA
    tensors launch K13 (one launch up to the split's limit, else a
    memset, one launch up front and one a digit pass; the launch is
    counted by method in ``KERNEL.by``)."""
    keys = tuple(keys)
    spans = tuple(spans)
    if len(keys) != len(spans) or not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"seat_sort: {len(keys)} keys, {len(spans)} spans")
    bits = tuple(field_bits(sp) for sp in spans)
    if not on_card(*keys):
        _check_spans(keys, spans)
        return seat_sort_plain(*keys)
    p = PLANS.sort(keys[0].device, keys[0].shape[0], bits)
    outs = _launch(keys, spans, p)
    KERNEL.launched(p.method)
    return outs


def seat_order(key: torch.Tensor, span) -> tuple[torch.Tensor, torch.Tensor]:
    """A stable argsort by K13: ``(sorted key, perm)``, ``perm`` int32 with
    ``key[perm]`` the sorted key and ties in ascending position
    (``torch.sort(key, stable=True)``). A stable sort is a two-key sort
    over (key, position), so this is one ``seat_sort`` call with the
    position as its last key; ``span`` bounds the key. CPU tensors take
    the twin (after the span check); CUDA tensors launch K13. No key (an
    empty CSR): nothing to sort, no launch."""
    n = key.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=key.device)
    if n == 0:
        return key.clone(), pos
    return seat_sort((key, pos), (span, (0, n - 1)))


def phase_stamps(keys, spans) -> list[int]:
    """One launch of K13's split on CUDA keys by the stamps build, its
    phase stamps (clock64() on one SM at the STAMP_* slots; -1 where a
    slot was not reached). A measurement, not a call of the main path:
    the launch is not counted."""
    keys = tuple(keys)
    dev = keys[0].device
    p = PLANS.sort(dev, keys[0].shape[0], tuple(field_bits(sp) for sp in spans))
    if p.method != "split":
        raise ValueError(f"seat_sort: phase stamps of the split, not {p.method}")
    stamps = torch.full((STAMPS,), -1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        # the stamps build's own kernel takes the shared-memory cap too
        err = library("seat_sort_stamps").seat_sort_setup(
            ctypes.byref(ctypes.c_int(0)))
    if err != 0:
        raise RuntimeError(f"seat_sort setup failed: cudaError {err}")
    _launch(keys, spans, p, stamps)
    return stamps.tolist()


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
    KERNEL.launched("compact")
    return out
