"""K12 ``top_will`` (the deflate step's clearing level) on the CPU.

The plain twin ``kernels/top_will.py::top_will_plain`` is held against
the reference's own lines (``poseidon_tpu/ops/dense_auction.py:826-833``:
the will table, ``jax.lax.top_k(will.T, smax)[0]`` and the gather at
``clip(s - 1, 0, smax - 1)``) restated in jnp on the same numpy inputs,
tolerance 0 (every value is an int32), on the edges ``chip_smoke.py
[edges]`` runs on the card at small sizes: both methods' smax, Tp 1 and
3, all -INF columns, no valid task, s 0 and past smax, ties, alt - c past
+-INF and wrapping int32, and 2- and 4-shard merges. The launch plan
(method, list length, the list cluster's slabs and column groups) and
the list method's merges (``merge_top`` and the tree over a block's
warps and a cluster's blocks, restated) are held on the CPU; the kernel
itself runs only on the card.
"""

from __future__ import annotations

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu_torch.kernels import KERNELS, reset_launch_counts
from poseidon_tpu_torch.kernels import top_will as k12

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "poseidon_tpu_torch" / "kernels" / "csrc")
INF = 2**29
I32 = jnp.int32


@jax.jit
def _ref_topw(c, alt1, alt2, m1, tv):
    """The reference's deflate lines up to the table (l.826-829)."""
    Mp = c.shape[1]
    alt = jnp.where(
        jnp.arange(Mp, dtype=I32)[None, :] == m1[:, None],
        alt2[:, None], alt1[:, None],
    )
    will = jnp.clip(alt - c, -INF, INF)
    return jnp.where(tv[:, None], will, -INF)


def ref_clear(c, alt1, alt2, m1, tv, s, smax):
    """``top_k(will.T, smax)[0]`` gathered at ``clip(s - 1, 0, smax - 1)``
    (l.830-833)."""
    will = _ref_topw(c, alt1, alt2, m1, tv)
    topw = jax.lax.top_k(will.T, smax)[0]
    sidx = jnp.clip(jnp.asarray(s) - 1, 0, smax - 1)
    return np.asarray(jnp.take_along_axis(topw, sidx[:, None], axis=1)[:, 0])


def inputs(rng, Tp, Mp, smax, kind):
    """numpy int32 (c, alt1, alt2, m1), bool task_valid and int32 s of one
    edge kind (``chip_smoke.top_will_inputs``'s kinds)."""
    c = rng.integers(0, 5000, (Tp, Mp))
    c[rng.random((Tp, Mp)) < 0.1] = INF
    alt1 = rng.integers(0, 6000, Tp)
    alt2 = np.minimum(alt1 + rng.integers(0, 500, Tp), INF)
    alt1[rng.random(Tp) < 0.05] = INF
    m1 = rng.integers(0, Mp, Tp)
    tv = rng.random(Tp) < 0.9
    if kind == "tied":
        c[:] = 7
        alt1[:] = 100
        alt2[:] = 100
        tv[:] = True
    elif kind == "inf":
        c = rng.integers(-2**31, 2**31, (Tp, Mp))
        alt1 = rng.integers(-2**31, 2**31, Tp)
        alt2 = rng.integers(-2**31, 2**31, Tp)
    elif kind == "ninfcol":
        c[:, ::3] = 2**31 - 1
    elif kind == "invalid":
        tv[:] = False
    else:
        assert kind == "rand", kind
    s = rng.integers(0, smax + 3, Mp)
    s[0] = 0
    s[-1] = smax + 5
    i32 = lambda a: a.astype(np.int64).astype(np.int32)  # noqa: E731
    return i32(c), i32(alt1), i32(alt2), i32(m1), tv, i32(s)


def torch_part(c, alt1, alt2, m1, tv):
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (c, alt1, alt2, m1, tv))


CASES = [  # (Tp, Mp, smax, kind)
    (1, 16, 1, "rand"), (3, 16, 2, "rand"), (3, 20, 3, "rand"),
    (70, 16, 16, "rand"), (70, 36, 33, "rand"), (200, 16, 100, "rand"),
    (65, 24, 65, "rand"), (100, 36, 1, "rand"), (256, 64, 16, "rand"),
    (50, 300, 40, "rand"), (60, 64, 16, "tied"), (60, 64, 40, "tied"),
    (80, 36, 8, "inf"), (80, 36, 50, "inf"), (30, 16, 4, "invalid"),
    (30, 16, 30, "invalid"), (60, 64, 32, "ninfcol"), (60, 64, 2, "ninfcol"),
]


@pytest.mark.parametrize("Tp,Mp,smax,kind", CASES)
def test_twin_equals_reference_lines(Tp, Mp, smax, kind):
    rng = np.random.default_rng(Tp * 7919 + Mp * 31 + smax)
    c, a1, a2, m1, tv, s = inputs(rng, Tp, Mp, smax, kind)
    want = ref_clear(c, a1, a2, m1, tv, s, smax)
    got = k12.top_will_plain([torch_part(c, a1, a2, m1, tv)],
                             torch.from_numpy(s), smax)
    assert got.dtype == torch.int32 and got.shape == (Mp,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("Tp,Mp,smax", [(64, 36, 16), (128, 16, 40),
                                        (64, 64, 64)])
def test_shard_merge_equals_whole_table(Tp, Mp, smax, shards):
    """Under a mesh each shard's top min(smax, rows) and a merge give the
    whole table's values (the wrapper on CPU tensors: the twin)."""
    rng = np.random.default_rng(shards * 1000 + smax)
    c, a1, a2, m1, tv, s = inputs(rng, Tp, Mp, smax, "rand")
    h = Tp // shards
    parts = [torch_part(c[k * h:(k + 1) * h], a1[k * h:(k + 1) * h],
                        a2[k * h:(k + 1) * h], m1[k * h:(k + 1) * h],
                        tv[k * h:(k + 1) * h]) for k in range(shards)]
    got = k12.top_will(parts, torch.from_numpy(s), smax)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_clear(c, a1, a2, m1, tv, s, smax))


def test_wrapper_takes_the_twin_for_cpu_tensors():
    rng = np.random.default_rng(5)
    c, a1, a2, m1, tv, s = inputs(rng, 40, 16, 8, "rand")
    reset_launch_counts()
    n_plans = len(k12.PLANS)
    part = torch_part(c, a1, a2, m1, tv)
    got = k12.top_will([part], torch.from_numpy(s), 8)
    want = k12.top_will_plain([part], torch.from_numpy(s), 8)
    assert torch.equal(got, want)
    assert all(k.launches == 0 for k in KERNELS)
    assert len(k12.PLANS) == n_plans
    with pytest.raises(ValueError):
        k12.top_will([part], torch.from_numpy(s).to("meta"), 8)


PLAN_SHAPES = [(rows, smax, Mp)
               for rows in (1, 3, 7, 100, 1025, 10240, 65536, 524288)
               for smax in (1, 2, 16, 32, 33, 1024, 3072) if smax <= rows
               for Mp in (16, 256, 1028, 12292)]


@pytest.mark.parametrize("rows,smax,Mp", PLAN_SHAPES)
def test_plan_deals_every_row_once(rows, smax, Mp):
    """The list method: one cluster a group of 32 columns (the grid's x),
    its blocks the row slabs (at most LIST_CLUSTER, each of at least 4 K
    rows unless there is one); radix: HIST_COLS columns a block, slabs of
    at least 8 rows. Either way every row lies in one slab."""
    p = k12.plan(rows, Mp, smax, 132)
    if smax <= 32:
        assert p.method == "list" and p.k >= smax and p.k in k12.LIST_KS
        assert p.k < 2 * smax
        assert p.col_blocks == -(-Mp // k12.LIST_COLS)
        assert 1 <= p.slabs <= k12.LIST_CLUSTER   # a portable cluster
        assert p.slabs == 1 or p.rows_per_slab >= 4 * p.k
        if rows >= 4 * p.k * k12.LIST_CLUSTER:
            assert p.slabs == k12.LIST_CLUSTER
    else:
        assert p.method == "radix" and p.k == 0
        assert p.col_blocks == -(-Mp // k12.HIST_COLS)
        assert p.slabs == 1 or p.rows_per_slab >= 8
        assert p.col_blocks * p.slabs <= max(132, p.col_blocks)  # one wave
    assert 1 <= p.slabs <= 65535          # the grid's y dimension
    # slabs are consecutive runs: every row once, no slab empty
    firsts = [k12.slab_rows(p, rows, q) for q in range(p.slabs)]
    assert firsts[0].start == 0 and firsts[-1].stop == rows
    assert all(a.stop == b.start for a, b in zip(firsts, firsts[1:]))
    assert all(len(r) > 0 for r in firsts)


def test_plan_fills_the_card_at_the_flagship():
    """The flagship's first deflate (smax 16): 32 column groups x a
    cluster of 4 slabs, 128 blocks of 1,024 threads, one an SM: one wave
    over the card's 132 SMs. Config 8's radix grid fills it 6 times."""
    p = k12.plan(10240, 1024, 16, 132)
    assert (p.method, p.k) == ("list", 16)
    assert (p.col_blocks, p.slabs, p.rows_per_slab) == (32, 4, 2560)
    assert p.col_blocks * p.slabs <= 132
    r = k12.plan(524288, 256, 3072, 132)
    assert r.method == "radix"
    # config 8's histograms: 16 column groups x 8 slabs, one block an SM
    assert (r.col_blocks, r.slabs) == (16, 8)
    assert 132 - r.col_blocks < r.col_blocks * r.slabs <= 132


def test_plan_rejects_bad_shapes():
    for args in ((0, 16, 1), (10, 0, 1), (10, 16, 0)):
        with pytest.raises(ValueError):
            k12.plan(*args, 132)


def test_kernel_constants_agree_with_the_plan():
    src = (CSRC / "top_will.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("LIST_COLS") == k12.LIST_COLS
    assert const("LIST_CLUSTER_MAX") == k12.LIST_CLUSTER_MAX
    assert k12.LIST_CLUSTER <= k12.LIST_CLUSTER_MAX
    assert const("LIST_STAMPS") == k12.LIST_STAMPS
    assert const("HIST_COLS") == k12.HIST_COLS
    assert const("BINS") == k12.BINS
    assert const("RADIX_PASSES") == k12.RADIX_PASSES
    assert "return pass == RADIX_PASSES - 1 ? 10 : 11;" in src  # digit_bits
    assert k12.DIGIT_BITS == (11, 11, 10) and sum(k12.DIGIT_BITS) == 32
    assert k12.BINS == 2 ** max(k12.DIGIT_BITS)
    for k in k12.LIST_KS:
        assert f"case {k}: return" in src


def _merge_top(a, b):
    """csrc/top_will.cu ``merge_top``, restated."""
    K = len(a)
    for i in range(K):
        a[i] = max(a[i], b[K - 1 - i])
    stride = K >> 1
    while stride > 0:
        for i in range(K):
            if (i & stride) == 0:
                a[i], a[i + stride] = (max(a[i], a[i + stride]),
                                       min(a[i], a[i + stride]))
        stride >>= 1


@pytest.mark.parametrize("K", k12.LIST_KS)
def test_kernel_merge_keeps_the_k_largest(K):
    """The list method's merge, restated: descending lists of K values
    merged one by one into the list give the K largest values, ties and
    the empty fill included."""
    rng = np.random.default_rng(K)
    for trial in range(20):
        n_lists = int(rng.integers(1, 9))
        hi = 3 if trial % 2 else 10**6
        lists = [sorted(rng.integers(-hi, hi, int(rng.integers(0, K + 1)))
                        .tolist(), reverse=True) for _ in range(n_lists)]
        a = [-2**31] * K
        for b in lists:
            _merge_top(a, (b + [-2**31] * K)[:K])
        want = (sorted(sum(lists, []), reverse=True) + [-2**31] * K)[:K]
        assert a == want


def _tree_merge(lists_of_warps):
    """csrc/top_will.cu ``tree_merge``, restated: warps [half, lists)
    hand their lists to warps [0, lists - half), which merge, halves
    until one is left; returns warp 0's list and the slots used."""
    a = [list(x) for x in lists_of_warps]
    lists = len(a)
    span = 1
    while span < lists:
        span <<= 1
    half, slots = span >> 1, 0
    while half >= 1:
        keep = {w - half: list(a[w]) for w in range(half, lists)}
        slots = max(slots, len(keep))
        for w in range(half):
            if w + half < lists:
                _merge_top(a[w], keep[w])
        lists, half = half, half >> 1
    return a[0], slots


@pytest.mark.parametrize("K", k12.LIST_KS)
@pytest.mark.parametrize("lists", [1, 2, 3, 5, 8, 16, 32])
def test_kernel_tree_keeps_the_k_largest(K, lists):
    """The one-launch list method's merges, restated: a block's 16 or 32
    warps (or a cluster's 1-8 blocks) meet in a tree of ``merge_top`` steps
    through at most lists / 2 slots of shared memory, and the first
    list holds the K largest values of all, ties and the empty fill
    included."""
    rng = np.random.default_rng(K * 100 + lists)
    for trial in range(10):
        hi = 3 if trial % 2 else 10**6
        raw = [sorted(rng.integers(-hi, hi, int(rng.integers(0, K + 1)))
                      .tolist(), reverse=True) for _ in range(lists)]
        got, slots = _tree_merge([(b + [-2**31] * K)[:K] for b in raw])
        want = (sorted(sum(raw, []), reverse=True) + [-2**31] * K)[:K]
        assert got == want
        assert slots <= max(1, lists // 2)


def _sort_desc(v):
    """csrc/top_will.cu ``sort_desc``: the bitonic network, restated."""
    v, n = list(v), len(v)
    size = 2
    while size <= n:
        stride = size >> 1
        while stride > 0:
            for i in range(n):
                j = i ^ stride
                if j > i:
                    hi, lo = max(v[i], v[j]), min(v[i], v[j])
                    down = (i & size) == 0
                    v[i], v[j] = (hi, lo) if down else (lo, hi)
            stride >>= 1
        size <<= 1
    return v


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("kind", ["rand", "tied", "rising"])
def test_kernel_fold_in_sorted_batches_keeps_the_k_largest(K, kind):
    """The list method's fold for K >= 8, restated: a lane's values of a
    turn go in by batches of K, each sorted by the bitonic network and
    merged into the list by ``merge_top``; the list keeps its column's K
    largest values, ties and the empty fill included."""
    rng = np.random.default_rng(K + len(kind))
    unroll = 16 if K <= 16 else 32
    rows = unroll * 9
    if kind == "tied":
        col = rng.integers(0, 3, rows).tolist()
    elif kind == "rising":
        col = sorted(rng.integers(-10**6, 10**6, rows).tolist())
    else:
        col = rng.integers(-10**6, 10**6, rows).tolist()
    empty = -2**31
    a = [empty] * K
    for turn in range(0, rows, unroll):
        for b0 in range(turn, turn + unroll, K):
            batch = _sort_desc(col[b0:b0 + K])
            assert batch == sorted(batch, reverse=True)
            _merge_top(a, batch)
    assert a == sorted(col, reverse=True)[:K]


def _radix_select(wills, k):
    """csrc/top_will.cu's radix method, restated for one column: the
    k-th largest of ``wills`` (int32) by DIGIT_BITS digits of the
    order-preserving key will ^ 0x80000000, most significant first: a
    pass counts the digit among the keys that share the prefix so far,
    and the pick walks the counts from the top."""
    keys = [(w + 2**31) % 2**32 for w in wills]
    prefix, rest, low = 0, k, 32
    for bits in k12.DIGIT_BITS:
        low -= bits
        high_mask = (2**32 - 1) ^ (2**(low + bits) - 1)
        counts = [0] * 2**bits
        for key in keys:
            if key & high_mask == prefix:
                counts[(key >> low) & (2**bits - 1)] += 1
        acc = 0
        for digit in range(2**bits - 1, -1, -1):
            if acc + counts[digit] >= rest:
                break
            acc += counts[digit]
        rest -= acc
        prefix |= digit << low
    return prefix - 2**31   # key ^ 0x80000000 as an int32


@pytest.mark.parametrize("kind", ["rand", "tied", "ends", "small"])
def test_radix_digits_select_the_kth_largest(kind):
    """The radix method's three digits (11, 11, 10 bits) select the k-th
    largest value exactly, at k 1, 2, n / 2 and n, ties, the int32 ends
    and values within one digit's span."""
    rng = np.random.default_rng(len(kind))
    n = 400
    if kind == "tied":
        wills = rng.integers(-3, 3, n)
    elif kind == "ends":
        wills = rng.choice([-2**31, 2**31 - 1, -INF, INF, 0, -1], n)
    elif kind == "small":
        wills = rng.integers(1000, 1000 + 2**10, n)
    else:
        wills = rng.integers(-2**31, 2**31, n)
    wills = [int(w) for w in wills]
    ordered = sorted(wills, reverse=True)
    for k in (1, 2, n // 2, n):
        assert _radix_select(wills, k) == ordered[k - 1]
