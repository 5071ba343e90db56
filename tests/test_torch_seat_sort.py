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
integer give the twin's order) are held here too; the kernel itself runs
only on the card.
"""

from __future__ import annotations

import pathlib
import re

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
    elif kind == "wide":
        keys = [rng.integers(-2**31, 2**31, n) for _ in range(nkeys)]
        return [k.astype(np.int32) for k in keys], [k13.INT32] * nkeys
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


ONE_WORD_CLUSTER_MAX = 8 * ((H100_SMEM_OPTIN - k13.BLOCK_FIXED_BYTES) // 16)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1024, 10240, 53456, 53457,
                               ONE_WORD_CLUSTER_MAX,
                               ONE_WORD_CLUSTER_MAX + 1, 524288])
@pytest.mark.parametrize("bits", [(11, 32, 14), (11, 32, 1, 14),
                                  (17, 32, 1, 16), (32, 32, 32, 32), (14,)])
def test_sort_plan(n, bits):
    p = k13.sort_plan(n, bits, H100_SMEM_OPTIN)
    width = sum(bits)
    assert p.words == (1 if width <= 64 else 2)
    assert p.passes == -(-width // 8) <= k13.MAX_PASSES
    if k13.block_smem(n, p.words, k13.CLUSTER) <= H100_SMEM_OPTIN:
        assert p.cluster == k13.CLUSTER and p.tiles == 0
        assert p.smem == k13.BLOCK_FIXED_BYTES + 16 * p.words * -(-n // p.cluster)
        assert p.smem <= H100_SMEM_OPTIN
    else:
        assert p.cluster == 0 and p.smem == 0
        assert (p.tiles - 1) * k13.TILE < n <= p.tiles * k13.TILE
    # the flagship's 3- and 4-key sorts: one launch of an 8-block cluster
    if n == 10240 and width <= 64:
        assert p.cluster == 8 and p.words == 1


@pytest.mark.parametrize("n", [1, 3, 10240, 65536, 65537, 524288, 2**22])
def test_compact_plan_covers_every_flag(n):
    p = k13.compact_plan(n, 132)
    assert 1 <= p.blocks <= k13.COMPACT_MAX_BLOCKS
    if p.blocks == 1:
        assert n <= k13.COMPACT_ONE_BLOCK and p.per_block >= n
    else:
        assert p.per_block % k13.COMPACT_CHUNK == 0
        assert (p.blocks - 1) * p.per_block < n <= p.blocks * p.per_block


def test_kernel_constants_agree_with_the_plan():
    src = (CSRC / "seat_sort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    warps = const("BLOCK_THREADS") // 32
    assert warps == k13.BLOCK_WARPS
    assert const("RADIX") == k13.RADIX
    assert const("MAX_PASSES") == k13.MAX_PASSES
    assert const("MAX_KEYS") == k13.MAX_KEYS
    assert re.search(r"BLOCK_FIXED_INTS = BLOCK_WARPS \* RADIX \+ 2 \* RADIX "
                     r"\+ 32 \+ MAX_PASSES;", src)
    assert const("CLUSTER_MAX") == k13.CLUSTER
    assert const("TILE_THREADS") * const("TILE_ROUNDS") == k13.TILE
    assert (const("COMPACT_THREADS") * const("COMPACT_ITEMS")
            == k13.COMPACT_CHUNK)
    assert const("COMPACT_THREADS") == k13.COMPACT_MAX_BLOCKS
