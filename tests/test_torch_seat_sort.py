"""K13 ``seat_sort`` (the auction loop's seat-layout sorts and the bid
window's compaction) on the CPU.

The plain twins ``kernels/seat_sort.py::seat_sort_plain`` and
``seat_compact_plain`` are held against ``jax.lax.sort(keys,
num_keys=k)`` for k = 1, 3 and 4 (the reference's sites,
``poseidon_tpu/ops/dense_auction.py:629, 710, 770, 872``) on the same
numpy keys, tolerance 0, at the keys' domain ends (segment 0 and Mp + 2,
level 0 and INF and the whole int32 range, is_bid all 0 and all 1, one
segment), and by a hypothesis property against ``np.lexsort``. The
wrapper's span check, the launch plans and the packed key's layout (the
fields the CUDA source packs, restated with Python ints, sorted as one
integer give the twin's order) are held here too, and both sort methods
restated on Python ints (``split_model``, ``onesweep_model``) against
the twin; the kernel itself runs only on the card.
"""

from __future__ import annotations

import pathlib
import random
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from poseidon_tpu_torch.kernels import KERNELS, reset_launch_counts
from poseidon_tpu_torch.kernels import seat_sort as k13

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "poseidon_tpu_torch" / "kernels" / "csrc")
INF = 2**29
H100_SMEM_OPTIN = 232448


def ref_sort(keys):
    out = jax.lax.sort(tuple(jnp.asarray(k) for k in keys),
                       num_keys=len(keys))
    return [np.asarray(x) for x in out]


def loop_keys(rng, n, Mp, nkeys, kind):
    """numpy int32 keys and their spans as the auction loop makes them
    (``chip_smoke.seat_keys``'s kinds)."""
    nseg = Mp + 3
    km = rng.integers(0, nseg, n)
    km[0], km[-1] = 0, nseg - 1
    kl = np.where(rng.random(n) < 0.3, 0, rng.integers(0, INF + 1, n))
    kl[-1] = INF
    isb = rng.integers(0, 2, n)
    tid = rng.permutation(n)
    seg, task = (0, nseg - 1), (0, n - 1)
    if kind == "oneseg":
        km[:] = nseg // 2
    elif kind == "bid0":
        isb[:] = 0
    elif kind == "bid1":
        isb[:] = 1
    elif kind == "kl0":
        kl[:] = 0
    elif kind == "klinf":
        kl[:] = INF
    elif kind in ("sized", "sizedlvl"):
        km = bucket_segments(rng, n, nseg)
        if kind == "sized":
            kl[:] = 0
            isb[:] = 0
    elif kind == "onepass":   # only the task id's low byte varies
        km[:] = nseg // 2
        kl[:] = 0
        isb[:] = 0
    elif kind == "cold":
        km[:] = nseg - 2
        km[n - n // 40:] = nseg - 1
        kl[:] = 0
        isb[:] = 0
    elif kind == "wide":
        keys = [rng.integers(-2**31, 2**31, n) for _ in range(nkeys)]
        return [k.astype(np.int32) for k in keys], [k13.INT32] * nkeys
    elif kind in ("same", "dup"):
        hi = 0 if kind == "same" else 2
        keys = [rng.integers(0, hi + 1, n) for _ in range(nkeys)]
        return [k.astype(np.int32) for k in keys], [(0, 2)] * nkeys
    else:
        assert kind == "rand", kind
    i32 = lambda a: a.astype(np.int64).astype(np.int32)  # noqa: E731
    if nkeys == 4:
        return ([i32(km), i32(-kl), i32(isb), i32(tid)],
                [seg, k13.INT32, (0, 1), task])
    if nkeys == 3:
        return [i32(km), i32(-kl), i32(tid)], [seg, k13.INT32, task]
    waiting = rng.random(n) < 0.5
    return [i32(np.where(waiting, np.arange(n), n))], [(0, n)]


EDGE_BUCKETS = (0, 1, 31, 32, 33, 63, 64, 65)   # chip_smoke.EDGE_BUCKETS


def bucket_segments(rng, n, nseg):
    """``chip_smoke.bucket_segments``: segments whose sizes run through
    EDGE_BUCKETS, the keys left over in the last, in a random order."""
    km = np.full(n, nseg - 1)
    at = 0
    for seg in range(nseg - 1):
        size = EDGE_BUCKETS[seg % len(EDGE_BUCKETS)]
        if at + size > n:
            break
        km[at:at + size] = seg
        at += size
    return km[rng.permutation(n)]


SORT_CASES = [  # (n, Mp, nkeys, kind)
    (1, 16, 4, "rand"), (2, 16, 3, "rand"), (3, 16, 4, "rand"),
    (1, 16, 1, "rand"), (3, 16, 1, "rand"), (127, 64, 4, "rand"),
    (128, 64, 3, "rand"), (129, 64, 1, "rand"), (500, 16, 4, "oneseg"),
    (500, 16, 4, "bid0"), (500, 16, 4, "bid1"), (500, 16, 3, "kl0"),
    (500, 16, 4, "klinf"), (300, 65539, 4, "rand"), (300, 16, 4, "wide"),
    (300, 16, 3, "wide"), (1025, 1024, 4, "rand"),
]


@pytest.mark.parametrize("n,Mp,nkeys,kind", SORT_CASES)
def test_twin_equals_lax_sort(n, Mp, nkeys, kind):
    rng = np.random.default_rng(n * 131 + nkeys + Mp)
    keys, spans = loop_keys(rng, n, Mp, nkeys, kind)
    want = ref_sort(keys)
    got = k13.seat_sort([torch.from_numpy(k) for k in keys], spans)
    assert len(got) == nkeys
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [1, 3, 64, 1024, 1500])
def test_compaction_twin_equals_reference_line(n):
    """``jax.lax.sort(jnp.where(waiting, pos, Tp))[:B]`` (l.710) with 0,
    B - 1, B, B + 1 and n waiting."""
    B = min(n, max(1024, n // 4))
    rng = np.random.default_rng(n)
    pos = jnp.arange(n, dtype=jnp.int32)
    for count in sorted({0, B - 1, B, min(B + 1, n), n}):
        waiting = np.zeros(n, dtype=bool)
        waiting[rng.choice(n, size=count, replace=False)] = True
        want = np.asarray(jax.lax.sort(jnp.where(waiting, pos, n))[:B])
        got = k13.seat_compact(torch.from_numpy(waiting), B)
        assert got.dtype == torch.int32 and got.shape == (B,)
        np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_twin_sorts_like_np_lexsort(data):
    n = data.draw(st.integers(1, 300))
    nkeys = data.draw(st.sampled_from([1, 2, 3, 4]))
    hi = data.draw(st.sampled_from([1, 3, 1000, 2**31 - 1]))
    lo = data.draw(st.sampled_from([0, -5, -2**31]))
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    keys = [rng.integers(lo, hi + 1, n).astype(np.int32)
            for _ in range(nkeys)]
    got = k13.seat_sort([torch.from_numpy(k) for k in keys],
                        [(lo, hi)] * nkeys)
    order = np.lexsort(keys[::-1])
    for g, k in zip(got, keys):
        np.testing.assert_array_equal(g.numpy(), k[order])


@pytest.mark.parametrize("n", [0, 1, 2, 33, 1024, 10240])
@pytest.mark.parametrize("kind", ["ties", "distinct", "wide", "one"])
def test_seat_order_is_a_stable_argsort(n, kind):
    """``seat_order`` (K13 over (key, position); its twin on the CPU)
    equals a stable argsort: the sorted key, and the permutation with
    ties in ascending position, as ``jax.lax.sort((key, arange),
    num_keys=1)`` and ``np.argsort(kind="stable")`` give them."""
    rng = np.random.default_rng(n)
    if kind == "ties":
        key, span = rng.integers(0, 4, n), (0, 3)
    elif kind == "distinct":
        key, span = rng.permutation(n), (0, max(n - 1, 0))
    elif kind == "wide":
        key, span = rng.integers(-2**31, 2**31, n), k13.INT32
    else:
        key, span = np.full(n, -INF), (-INF, INF)
    key = key.astype(np.int32)
    got, perm = k13.seat_order(torch.from_numpy(key), span)
    want = np.argsort(key, kind="stable")
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), key[want])
    ref_key, ref_perm = ref_sort([key, np.arange(n, dtype=np.int32)])
    np.testing.assert_array_equal(perm.numpy(), ref_perm)
    np.testing.assert_array_equal(got.numpy(), ref_key)


def test_seat_order_checks_its_span():
    with pytest.raises(ValueError, match="leaves its span"):
        k13.seat_order(torch.tensor([0, 5, 9], dtype=torch.int32), (0, 8))


def test_span_check_on_the_cpu():
    keys = [torch.tensor([0, 5, 2], dtype=torch.int32),
            torch.tensor([2, 0, 1], dtype=torch.int32)]
    k13.seat_sort(keys, [(0, 5), (0, 2)])
    with pytest.raises(ValueError):
        k13.seat_sort(keys, [(0, 4), (0, 2)])
    with pytest.raises(ValueError):
        k13.seat_sort(keys, [(1, 5), (0, 2)])
    with pytest.raises(ValueError):
        k13.seat_sort(keys, [(0, 5)])
    with pytest.raises(ValueError):
        k13.field_bits((0, 2**31))


def test_wrappers_take_the_twin_for_cpu_tensors():
    rng = np.random.default_rng(9)
    keys, spans = loop_keys(rng, 200, 16, 4, "rand")
    reset_launch_counts()
    n_plans = len(k13.PLANS)
    t = [torch.from_numpy(k) for k in keys]
    got = k13.seat_sort(t, spans)
    want = k13.seat_sort_plain(*t)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    w = torch.from_numpy(rng.random(200) < 0.3)
    assert torch.equal(k13.seat_compact(w, 100),
                       k13.seat_compact_plain(w, 100))
    assert all(k.launches == 0 for k in KERNELS)
    assert len(k13.PLANS) == n_plans
    with pytest.raises(ValueError):
        k13.seat_sort([t[0], t[1].to("meta")], spans[:2])


def _pack(values, spans):
    """The packed key of one position as csrc/seat_sort.cu builds it:
    field i = (key_i - lo_i) mod 2^32 in bits_i bits, the first key
    highest, split into (lo, hi) 64-bit words where pos > 32 straddles
    them; returned as one Python int."""
    bits = [k13.field_bits(sp) for sp in spans]
    pos = [sum(bits[i + 1:]) for i in range(len(bits))]
    lo_w = hi_w = 0
    m64 = 2**64 - 1
    for v, (lo, _), b, p in zip(values, spans, bits, pos):
        f = ((int(v) - lo) % 2**32) & (2**b - 1)
        if p < 64:
            lo_w |= (f << p) & m64
            if p > 32:
                hi_w |= f >> (64 - p)
        else:
            hi_w |= (f << (p - 64)) & m64
    return (hi_w << 64) | lo_w


def _unpack(packed, spans, i):
    bits = [k13.field_bits(sp) for sp in spans]
    p = sum(bits[i + 1:])
    f = (packed >> p) & (2**bits[i] - 1)
    v = (f + spans[i][0]) % 2**32
    return v - 2**32 if v >= 2**31 else v


@pytest.mark.parametrize("n,Mp,nkeys,kind", [
    (200, 1024, 4, "rand"), (200, 1024, 3, "klinf"), (200, 65539, 4, "rand"),
    (200, 16, 4, "wide"), (200, 16, 3, "wide"), (100, 16, 1, "rand"),
])
def test_packed_key_orders_like_the_twin(n, Mp, nkeys, kind):
    """Sorting the packed keys as integers (what the radix passes do,
    digit by digit) gives the twin's order, and unpacking gives the
    keys back."""
    rng = np.random.default_rng(n + nkeys)
    keys, spans = loop_keys(rng, n, Mp, nkeys, kind)
    packed = sorted(_pack(vals, spans) for vals in zip(*keys))
    want = k13.seat_sort_plain(*[torch.from_numpy(k) for k in keys])
    for i, w in enumerate(want):
        assert [_unpack(p, spans, i) for p in packed] == w.tolist()
    width = sum(k13.field_bits(sp) for sp in spans)
    assert max(packed).bit_length() <= width


# the one-word limit of the LSD cluster sort the split replaced (8 blocks,
# each its share of two key buffers beside 18,624 bytes of counters): an n
# the grid keeps
ONE_WORD_CLUSTER_MAX = 8 * ((H100_SMEM_OPTIN - 18624) // 16)
ONE_WORD_SPLIT_MAX = max(
    n for n in range(1, k13.SPLIT_MAX_N + 1)
    if k13.split_smem(n, 1, k13.SPLIT_CLUSTER) <= H100_SMEM_OPTIN)


TWO_WORD_SPLIT_MAX = max(
    n for n in range(1, k13.SPLIT_MAX_N + 1)
    if k13.split_smem(n, 2, k13.SPLIT_CLUSTER) <= H100_SMEM_OPTIN)


@pytest.mark.parametrize("n", [1, 8, 33, 1024, 10240, ONE_WORD_SPLIT_MAX,
                               ONE_WORD_SPLIT_MAX + 1, TWO_WORD_SPLIT_MAX + 1,
                               53456, 53457, ONE_WORD_CLUSTER_MAX + 1,
                               145410, 524288, 2**20])
@pytest.mark.parametrize("bits", [(11, 32, 14), (11, 32, 1, 14),
                                  (17, 32, 1, 16), (32, 32, 32, 32), (14,)])
def test_sort_plan(n, bits):
    """The method by n and the key width: the split cluster while n <=
    32,768 and a block's share fits (the flagship's 3- and 4-key sorts),
    the onesweep above: a tile of SWEEP_THREADS x rounds keys, the
    largest that still gives SWEEP_MIN_TILES tiles, its buffer rows,
    up-front blocks and workspace sized from n and the passes."""
    p = k13.sort_plan(n, bits, H100_SMEM_OPTIN)
    width = sum(bits)
    assert p.words == (1 if width <= 64 else 2)
    assert p.passes == -(-width // 8) <= k13.MAX_PASSES
    split = k13.split_smem(n, p.words, k13.SPLIT_CLUSTER)
    if n <= k13.SPLIT_MAX_N and split <= H100_SMEM_OPTIN:
        assert (p.method, p.cluster, p.tiles, p.work) == ("split", 8, 0, 0)
        assert p.smem == split
    else:
        assert (p.method, p.cluster) == ("onesweep", 0)
        assert (p.tiles - 1) * p.tile < n <= p.tiles * p.tile
        assert p.tile == k13.SWEEP_THREADS * p.rounds
        bigger = [r for r in k13.SWEEP_ROUNDS if r > p.rounds]
        assert all(-(-n // (k13.SWEEP_THREADS * r)) < k13.SWEEP_MIN_TILES
                   for r in bigger)
        assert (p.tiles >= k13.SWEEP_MIN_TILES
                or p.rounds == min(k13.SWEEP_ROUNDS))
        assert p.smem == k13.sweep_smem(p.words, p.rounds) <= H100_SMEM_OPTIN
        assert p.stride % k13.STRIDE_KEYS == 0 and 0 <= p.stride - n < 32
        assert ((p.hist_blocks - 1) * k13.HIST_THREADS * k13.HIST_ITEMS < n
                <= p.hist_blocks * k13.HIST_THREADS * k13.HIST_ITEMS)
        assert p.work == k13.sweep_work(p.passes, p.tiles)
        assert n < 2 ** k13.STATUS_COUNT_BITS
    assert p.method in k13.METHODS
    # the flagship's 3- and 4-key sorts: the split cluster, one word
    if n == 10240 and width <= 64:
        assert p.method == "split" and p.words == 1
    # past the split's limit (23,936 one-word keys on an H100, 19,056
    # two-word ones) the onesweep takes over
    if n > ONE_WORD_SPLIT_MAX or (n > TWO_WORD_SPLIT_MAX and width > 64):
        assert p.method == "onesweep"
    # config 8's argsort and 4-key sort (4,096-key tiles), the flagship's
    # CSR tails (2,048): a tile for most SMs at once
    if n in (524288, 145410) and p.method == "onesweep":
        assert (p.tile, p.tiles) == ((4096, 128) if n == 524288
                                     else (2048, 72))


def test_onesweep_plan_checks_its_arguments():
    with pytest.raises(ValueError):
        k13.onesweep_plan(1000, (14,), 3)
    with pytest.raises(ValueError):
        k13.onesweep_plan(2 ** k13.STATUS_COUNT_BITS, (32,), 8)
    p = k13.onesweep_plan(1, (0,), 4)        # no bit varies: one pass
    assert (p.passes, p.tiles, p.stride) == (1, 1, 32)


def test_split_smem_sums_the_kernel_layout():
    """split_smem is the csrc layout's sum: a block's two key buffers and
    its part of the AND and OR of lmax buckets in 64-bit words, then ints
    (counts, cursors and next-level slots of the bins, bitmap, nine
    lists, fixed)."""
    for n, words, cl in ((1, 1, 8), (33, 1, 8), (10240, 1, 8),
                         (10240, 2, 8), (10240, 1, 1), (19056, 2, 8)):
        lmax = n // 33 + 1
        assert k13.split_lmax(n) == lmax
        ints = 3 * ((n + 1) // 2) + n // 32 + 2 + 9 * lmax + 48
        assert k13.split_smem(n, words, cl) == (16 * words * -(-n // cl)
                                                + 16 * words * lmax
                                                + 4 * ints)
    assert ONE_WORD_SPLIT_MAX == 23936
    assert max(n for n in range(1, k13.SPLIT_MAX_N + 1)
               if k13.split_smem(n, 2, 8) <= H100_SMEM_OPTIN) == 19056
    # a bin's count and the next level's slot share one int in the scan
    assert k13.SPLIT_MAX_N < 2 ** 16 and (k13.SPLIT_MAX_N // 33 + 1) < 2 ** 15


@pytest.mark.parametrize("width", [0, 1, 4, 12, 14, 58, 128])
@pytest.mark.parametrize("size", [33, 64, 65, 240, 10240, 12288])
def test_split_digit(width, size):
    """A bucket's digit: its top varying bits, at most DIGIT_MAX, and at
    most log2(size) - 1 so that a level's bins number at most n / 2; no
    digit (one bin) where the keys are all equal."""
    d = k13.split_digit(width, size)
    if width == 0:
        assert d == 0
        return
    assert 1 <= d <= min(width, k13.DIGIT_MAX)
    assert 2 ** d <= size // 2
    assert d == width or d == k13.DIGIT_MAX or 2 ** (d + 1) > size // 2


def split_model(packed, n, width0):
    """csrc/seat_sort.cu's split method restated on Python ints: levels
    split every bucket of more than SMALL keys by its top varying bits,
    the first bucket by the top bits of the packed width ``width0``
    (the bins' keys laid out in reverse order of arrival: a split needs
    no stability), each non-empty bin a bucket (a head bit); then each
    key finds its bucket in the head bitmap as the kernel does (its word
    and the next or previous one) and takes its rank by counting. Returns
    the keys as the kernel writes them and each level's (buckets, keys
    split, bins, first digit's shift and width)."""
    a = list(packed)
    head = [0] * (n // 32 + 2)
    head[0] = 1
    buckets = [(0, n)] if n > k13.SMALL else []
    levels = []
    while buckets:
        nxt, bins, listed = [], 0, 0
        for i, (start, size) in enumerate(buckets):
            keys = a[start:start + size]
            andv = orv = keys[0]
            for x in keys:
                andv &= x
                orv |= x
            width = (andv ^ orv).bit_length() if levels else width0
            d = k13.split_digit(width, size)
            shift = width - d
            if i == 0:
                first = (shift, d)
            groups = [[] for _ in range(1 << d)]
            for x in keys:
                groups[(x >> shift) & ((1 << d) - 1)].append(x)
            pos = start
            for g in groups:
                if g:
                    head[pos >> 5] |= 1 << (pos & 31)
                    if len(g) > k13.SMALL and d > 0:
                        nxt.append((pos, len(g)))
                    a[pos:pos + len(g)] = g[::-1]
                    pos += len(g)
            bins += 1 << d
            listed += size
        assert bins <= (n + 1) // 2
        assert len(nxt) <= k13.split_lmax(n)
        levels.append((len(buckets), listed, bins, first))
        buckets = nxt
    out = [None] * n
    for e in range(n):
        w0, upto = e >> 5, (1 << ((e & 31) + 1)) - 1
        below, above = head[w0] & upto, head[w0] & ~upto
        s = t = -1
        if below:
            s = (w0 << 5) + below.bit_length() - 1
        elif w0 > 0 and head[w0 - 1]:
            s = ((w0 - 1) << 5) + head[w0 - 1].bit_length() - 1
        if above:
            t = (w0 << 5) + (above & -above).bit_length() - 1
        elif (w0 + 1) << 5 >= n:
            t = n
        elif head[w0 + 1]:
            t = ((w0 + 1) << 5) + (head[w0 + 1] & -head[w0 + 1]).bit_length() - 1
        elif (w0 + 2) << 5 >= n:
            t = n
        rank = e
        if s >= 0 and t >= 0 and t - s <= k13.SMALL:
            rank = s + sum(a[q] < a[e] or (q < e and a[q] == a[e])
                           for q in range(s, t))
        else:   # a bucket past SMALL is one of equal keys, in place
            lo = hi = e
            while not head[lo >> 5] >> (lo & 31) & 1:
                lo -= 1
            while hi + 1 < n and not head[(hi + 1) >> 5] >> ((hi + 1) & 31) & 1:
                hi += 1
            assert hi + 1 - lo > k13.SMALL
            assert all(x == a[e] for x in a[lo:hi + 1])
        assert out[rank] is None
        out[rank] = a[e]
    return out, levels


SPLIT_CASES = SORT_CASES + [
    (10240, 1024, 4, "rand"), (10240, 1024, 3, "rand"),
    (10240, 1024, 4, "sized"), (2000, 64, 3, "sized"),
    (10240, 1024, 4, "sizedlvl"), (10240, 1024, 4, "cold"),
    (600, 16, 3, "cold"), (33, 16, 4, "oneseg"), (32, 16, 4, "oneseg"),
    (65, 16, 3, "cold"), (4000, 16, 4, "same"), (4000, 16, 1, "dup"),
    (3000, 16, 3, "dup"), (2000, 16, 1, "wide"), (2000, 16, 2, "wide"),
]


@pytest.mark.parametrize("n,Mp,nkeys,kind", SPLIT_CASES)
def test_split_model_sorts_like_the_twin(n, Mp, nkeys, kind):
    """The split method restated (``split_model``) writes every key once
    and in the twin's order, on the sort cases above and at the split's
    edges: buckets of 0, 1, 31-33 and 63-65 keys, all n keys in one
    bucket, n past and at SMALL, keys of 32 and 64 bits, equal keys."""
    rng = np.random.default_rng(n * 7 + nkeys + Mp)
    keys, spans = loop_keys(rng, n, Mp, nkeys, kind)
    packed = [_pack(vals, spans) for vals in zip(*keys)]
    got, levels = split_model(packed, n,
                              sum(k13.field_bits(sp) for sp in spans))
    want = k13.seat_sort_plain(*[torch.from_numpy(k) for k in keys])
    for i, w in enumerate(want):
        assert [_unpack(p, spans, i) for p in got] == w.tolist()
    assert (levels == []) == (n <= k13.SMALL)


def test_split_model_at_the_flagship():
    """The flagship's 4-key sort (58-bit keys): the first digit is the
    top 11 bits, the segment (bits 47-57); where only WAIT and DUMP occur
    (level 0, not bidding: a cold round's layout) each of the two buckets
    splits once more, by the task id, in two levels in all."""
    rng = np.random.default_rng(2)
    for kind in ("rand", "cold"):
        keys, spans = loop_keys(rng, 10240, 1024, 4, kind)
        packed = [_pack(vals, spans) for vals in zip(*keys)]
        got, levels = split_model(packed, 10240, 58)
        assert got == sorted(packed)
        assert levels[0][3] == (47, 11)
        if kind == "cold":
            assert len(levels) == 2
            assert levels[1][:2] == (2, 10240)  # WAIT and DUMP, every key


@pytest.mark.parametrize("n", [1, 3, 10240, 65536, 65537, 524288, 2**22])
def test_compact_plan_covers_every_flag(n):
    p = k13.compact_plan(n, 132)
    assert 1 <= p.blocks <= k13.COMPACT_MAX_BLOCKS
    if p.blocks == 1:
        assert n <= k13.COMPACT_ONE_BLOCK and p.per_block >= n
    else:
        assert p.per_block % k13.COMPACT_CHUNK == 0
        assert (p.blocks - 1) * p.per_block < n <= p.blocks * p.per_block


def onesweep_model(packed, width, warps, rounds, seed):
    """csrc/seat_sort.cu's onesweep method restated on Python ints, at a
    tile of ``warps`` x ``rounds`` x 32 keys. The up-front launch's
    histograms; the live passes (no bin holding all n keys; pass 0 where
    none is); each live pass reading the side the parity of the live
    passes before it names (the side it leaves is emptied, so a wrong
    parity reads holes); a tile's stable ranks by the kernel's warp walk
    (warp w's rounds of 32, the warps before it, the digit's start in the
    tile); the look-back words, one set for all passes, each carrying its
    pass, with tiles taking their ids in order and stepping in a seeded
    random order: a tile publishes its aggregates (tile 0 its prefix),
    loads LOOK words at a time for each digit as they stand, takes them
    nearest first until one not written in this pass, stops at a prefix,
    publishes its own; then each key goes to the digit's global offset
    plus its tile's prefix plus its place in the tile's run. The last
    live pass writes the outputs. Returns the keys in output order and
    the live passes."""
    n = len(packed)
    tile = warps * rounds * 32
    passes = max(1, -(-width // k13.DIGIT_BITS))
    tiles = -(-n // tile)
    look = 8                                   # csrc LOOK

    def digit(x, q):
        return (x >> (k13.DIGIT_BITS * q)) & (k13.RADIX - 1)

    def exclusive(counts):
        out, run = [], 0
        for c in counts:
            out.append(run)
            run += c
        return out

    hist = [[0] * k13.RADIX for _ in range(passes)]
    for x in packed:
        for q in range(passes):
            hist[q][digit(x, q)] += 1
    live = [q for q in range(passes) if max(hist[q]) != n] or [0]
    sides = [list(packed), [None] * n]
    out = [None] * n
    status = [[(0, 0, 0)] * k13.RADIX for _ in range(tiles)]  # flag, pass, count
    rng = random.Random(seed)
    for q in live:
        src = sum(v < q for v in live) % 2
        offs = exclusive(hist[q])
        tiles_of = []
        for t in range(tiles):
            keys = sides[src][t * tile:(t + 1) * tile]
            assert None not in keys
            cnt = [[0] * k13.RADIX for _ in range(warps)]
            rank = []
            for i, x in enumerate(keys):       # i = (w * rounds + r) * 32 + lane
                w = i // (rounds * 32)
                rank.append(cnt[w][digit(x, q)])
                cnt[w][digit(x, q)] += 1
            count = [0] * k13.RADIX
            for d in range(k13.RADIX):
                for w in range(warps):
                    cnt[w][d], count[d] = count[d], count[d] + cnt[w][d]
            lstart = exclusive(count)
            local = [None] * len(keys)
            for i, x in enumerate(keys):
                at = (lstart[digit(x, q)] + cnt[i // (rounds * 32)][digit(x, q)]
                      + rank[i])
                assert local[at] is None
                local[at] = x
            tiles_of.append((count, lstart, local))
        # the chained scan, tiles stepping in a random order
        prefix = [None] * tiles
        cursor = {}                            # tile: (next tile read, sums) a digit
        started = 0
        while prefix.count(None):
            can = [t for t in cursor] + ([started] if started < tiles else [])
            t = rng.choice(can)
            count = tiles_of[t][0]
            if t == started:                   # takes its id, publishes
                started += 1
                flag = 2 if t == 0 else 1
                status[t] = [(flag, q, c) for c in count]
                if t == 0:
                    prefix[0] = [0] * k13.RADIX
                else:
                    cursor[t] = ([t - 1] * k13.RADIX, [0] * k13.RADIX)
                continue
            nxt, sums = cursor[t]
            for d in range(k13.RADIX):
                if nxt[d] is None:
                    continue
                window = [status[u][d] if u >= 0 else (2, q, 0)
                          for u in range(nxt[d], nxt[d] - look, -1)]
                for flag, qq, c in window:
                    if flag == 0 or qq != q:
                        break
                    sums[d] += c
                    if flag == 2:
                        nxt[d] = None
                        break
                    nxt[d] -= 1
            if all(x is None for x in nxt):
                prefix[t] = sums
                status[t] = [(2, q, b + c) for b, c in zip(sums, count)]
                del cursor[t]
        for t in range(tiles):
            assert prefix[t] == [sum(tiles_of[u][0][d] for u in range(t))
                                 for d in range(k13.RADIX)]
        dst = out if q == live[-1] else [None] * n
        for t, (count, lstart, local) in enumerate(tiles_of):
            for j, x in enumerate(local):
                d = digit(x, q)
                at = offs[d] + prefix[t][d] + j - lstart[d]
                assert dst[at] is None
                dst[at] = x
        if q != live[-1]:
            sides[src ^ 1] = dst
        sides[src] = [None] * n
    return out, live


ONESWEEP_CASES = SORT_CASES + [  # (n, Mp, nkeys, kind, warps, rounds)
    (50, 16, 4, "rand"), (64, 16, 3, "rand"), (200, 16, 3, "rand"),
    (319, 64, 4, "rand"), (320, 64, 4, "rand"), (321, 64, 4, "rand"),
    (200, 16, 4, "onepass"), (256, 16, 3, "onepass"), (640, 16, 4, "cold"),
    (500, 16, 3, "same"), (600, 16, 1, "dup"), (700, 16, 4, "wide"),
    (1025, 16, 3, "wide"), (640, 16, 2, "wide"), (1500, 1024, 4, "sizedlvl"),
]


@pytest.mark.parametrize("n,Mp,nkeys,kind", ONESWEEP_CASES)
def test_onesweep_model_sorts_like_the_twin(n, Mp, nkeys, kind):
    """The onesweep method restated (``onesweep_model``, 64-key tiles of
    two warps of one round; 128-key tiles of two rounds where n is odd)
    writes every key once and in the twin's order: the sort cases above,
    one tile, a ragged last tile, n at a multiple of the tile and one off
    it, every pass but one dead (only the task id's low byte varies), the
    cold layout's dead middle passes, no live pass (equal keys), keys past
    64 bits."""
    rng = np.random.default_rng(n * 5 + nkeys + Mp)
    keys, spans = loop_keys(rng, n, Mp, nkeys, kind)
    packed = [_pack(vals, spans) for vals in zip(*keys)]
    width = sum(k13.field_bits(sp) for sp in spans)
    rounds = 2 if n % 2 else 1
    got, live = onesweep_model(packed, width, 2, rounds, seed=n + nkeys)
    want = k13.seat_sort_plain(*[torch.from_numpy(k) for k in keys])
    for i, w in enumerate(want):
        assert [_unpack(p, spans, i) for p in got] == w.tolist()
    passes = max(1, -(-width // 8))
    assert live and set(live) <= set(range(passes))
    if kind == "onepass":
        assert live == [0]
    if kind == "cold" and nkeys == 4:
        # 48 bits: the task id in bits 0-9, is_bid 10, the level 11-42
        # (all 0), the segment 43-47: passes 2-4 see one digit each
        assert live == [0, 1, 5]


def test_onesweep_model_at_config8_layout():
    """Config 8's 4-key auction sort (Mp 256, task ids over Tp 524,288:
    61-bit keys, 8 passes), restated at 2,000 keys with distinct ids drawn
    over the whole span: in a cold layout (level 0, not bidding, every
    task WAIT or DUMP) the passes inside the level (bits 24-47) and the
    segment's top bits are dead; with segments, levels and bids drawn all
    8 are live."""
    n, Mp = 2000, 256
    rng = np.random.default_rng(8)
    nseg = Mp + 3
    tid = rng.choice(524288, n, replace=False).astype(np.int32)
    spans = [(0, nseg - 1), k13.INT32, (0, 1), (0, 524287)]
    width = sum(k13.field_bits(sp) for sp in spans)
    assert width == 61
    for layout in ("cold", "drawn"):
        cold = layout == "cold"
        km = rng.integers(nseg - 2 if cold else 0, nseg, n)
        kl = np.zeros(n) if cold else rng.integers(0, 2**29, n)
        isb = np.zeros(n) if cold else rng.integers(0, 2, n)
        keys = [a.astype(np.int32) for a in (km, -kl, isb)] + [tid]
        packed = [_pack(vals, spans) for vals in zip(*keys)]
        got, live = onesweep_model(packed, width, 2, 1, seed=3)
        assert got == sorted(packed)
        assert live == ([0, 1, 2, 6] if cold else list(range(8)))


def test_sweep_smem_and_work_sum_the_kernel_layout():
    """sweep_smem is the csrc pass block's layout (its tile's keys, then
    the warps' digit counts, the digits' offsets and tile starts, the
    warp sums and the scalars), and sweep_work the workspace's (the
    histograms, the head the memset zeroes with them, the look-back
    words); every tile fits a block on the H100."""
    src = (CSRC / "seat_sort.cu").read_text()
    assert ("static_assert(SWEEP_FIXED_INTS == SWEEP_WARPS * RADIX + 2 * RADIX"
            " + 48" in src)
    warps = k13.SWEEP_THREADS // 32
    assert k13.SWEEP_FIXED_INTS == warps * k13.RADIX + 2 * k13.RADIX + 48
    assert ("return 8 * words * SWEEP_THREADS * rounds + 4 * SWEEP_FIXED_INTS;"
            in src)
    for words in (1, 2):
        for rounds in k13.SWEEP_ROUNDS:
            got = k13.sweep_smem(words, rounds)
            assert got == (8 * words * k13.SWEEP_THREADS * rounds
                           + 4 * k13.SWEEP_FIXED_INTS)
            assert got <= H100_SMEM_OPTIN
    # the workspace: histograms, head, look-back words; the memset covers
    # the first two
    assert "w.head = base + passes * RADIX;" in src
    assert "w.status = reinterpret_cast<unsigned*>(w.head + WORK_HEAD);" in src
    assert "sizeof(int) * static_cast<size_t>(f.passes * RADIX + WORK_HEAD)" in src
    for passes, tiles in ((1, 1), (7, 128), (8, 128), (16, 256)):
        assert k13.sweep_work(passes, tiles) == (
            passes * k13.RADIX + k13.WORK_HEAD + tiles * k13.RADIX)
    # the head: done, live, a tile counter a pass
    assert k13.WORK_HEAD >= 2 + k13.MAX_PASSES
    p = k13.sort_plan(524288, (9, 32, 1, 19), H100_SMEM_OPTIN)
    assert (p.passes, p.tiles, p.work) == (8, 128, 8 * 256 + 32 + 128 * 256)


def test_launch_counts_by_method():
    """K13's launches by method: the wrapper's own calls, and a loop
    graph's bodies settled from its tally (a body's launches by method
    times its runs), beside the total."""
    from poseidon_tpu_torch.kernels import loop_graph

    k = k13.KERNEL
    count, by = k.count, dict(k.by)
    try:
        k.count, k.by = 0, {}
        k.launched("onesweep")
        k.launched("split")
        k.launched("onesweep")
        assert k.launches == 3
        assert k.launches_by == {"onesweep": 2, "split": 1}
        g = object.__new__(loop_graph.LoopGraph)
        g.done_event = types.SimpleNamespace(query=lambda: True)
        g._host_view = np.zeros(loop_graph.TALLY, np.int32)
        g._settled = np.zeros(loop_graph.TALLY, np.int64)
        g.per_body = {"head": {}, "round": {"seat_sort": 2,
                                           ("seat_sort", "onesweep"): 1,
                                           ("seat_sort", "compact"): 1},
                      "pre": {}, "refight": {}, "tighten": {}}
        g._host_view[:5] = (10, 0, 0, 0, 1)   # 10 rounds, one launch
        assert g.settle()
        assert k.launches == 3 + 20
        assert k.launches_by == {"onesweep": 12, "split": 1, "compact": 10}
        k.launches = 0
        assert k.launches_by == {}
    finally:
        k.count, k.by = count, by


def test_kernel_constants_agree_with_the_plan():
    src = (CSRC / "seat_sort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("RADIX") == k13.RADIX == 2 ** k13.DIGIT_BITS
    assert const("MAX_KEYS") == k13.MAX_KEYS
    assert const("MAX_PASSES") == k13.MAX_PASSES
    assert k13.MAX_PASSES * k13.DIGIT_BITS == 32 * k13.MAX_KEYS
    for name in ("SWEEP_THREADS", "SWEEP_FIXED_INTS", "STRIDE_KEYS",
                 "HIST_THREADS", "HIST_ITEMS", "WORK_HEAD",
                 "STATUS_COUNT_BITS"):
        assert const(name) == getattr(k13, name), name
    # the tiles the launch dispatches: the plan's rounds
    for r in k13.SWEEP_ROUNDS:
        assert f"case {r}: return sweep_passes<WORDS, {r}>" in src or (
            r == max(k13.SWEEP_ROUNDS)
            and f"default: return sweep_passes<WORDS, {r}>" in src)
        for w in (1, 2):
            assert f"seat_sweep_pass_kernel<{w}, {r}>, sweep_smem({w}, {r})" in src
    assert "rounds != 4 && rounds != 8" in src
    assert (const("COMPACT_THREADS") * const("COMPACT_ITEMS")
            == k13.COMPACT_CHUNK)
    assert const("COMPACT_THREADS") == k13.COMPACT_MAX_BLOCKS
    assert const("SPLIT_THREADS") == k13.SPLIT_THREADS
    assert const("SPLIT_CLUSTER") == k13.SPLIT_CLUSTER
    assert const("SPLIT_MAX_N") == k13.SPLIT_MAX_N
    assert const("SMALL") == k13.SMALL
    assert const("DIGIT_MAX") == k13.DIGIT_MAX
    assert const("SPLIT_FIXED_INTS") == k13.SPLIT_FIXED_INTS
    for name in ("STAMPS", "STAMP_START", "STAMP_PACKED", "STAMP_LEVEL",
                 "STAMP_LEVEL_MAX", "STAMP_LEVELS",
                 "STAMP_LISTED", "STAMP_LISTED_MAX", "STAMP_END"):
        assert const(name) == getattr(k13, name)
    assert const("STAMP_STEP0") == k13.STAMP_STEPS[0]
    assert const("STAMP_STEP1") == k13.STAMP_STEPS[1]
    for name, value in k13.METHODS.items():
        assert const(f"METHOD_{name.upper()}") == value
    assert "return n / (SMALL + 1) + 1;" in src      # split_lmax
    for name in ("seat_pack_kernel", "seat_unpack_kernel", "seat_hist_kernel",
                 "seat_scan_kernel", "seat_scatter_kernel", "TILE_"):
        assert name not in src                   # the tiles method is gone
