"""K1's plain twin against the reference's ``_densify`` at the edge inputs.

``densify_plain`` is the oracle ``chip_smoke.py`` holds the K1 kernel
against on the card, so it must equal the reference
(``poseidon_tpu.ops.dense_auction._densify``) exactly, at the inputs
whole instances rarely reach: no preference at all, preferences on
padded columns and racks of -1, every slot 0, every task cost INF, sums
that wrap int32, n_prefs of 0 or below Pw, and an empty preference
table (Pw = 0, which the resident round passes when no task has a
preference). The same numpy inputs, made from a seed, go to both;
tolerance 0 (every output is an integer).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu.ops.dense_auction as ref
from poseidon_tpu_torch.kernels import KERNELS, densify, reset_launch_counts

INF = 2**29
KINDS = ("rand", "none", "padhit", "noslots", "winf", "wrap")
SHAPES = [  # (Tp, Mp, Pw, n_prefs)
    (1, 16, 1, 1), (3, 64, 3, 3), (5, 132, 5, 5), (37, 16, 5, 0),
    (100, 64, 3, 1), (48, 128, 1, 0), (9, 16, 0, 0), (64, 1028, 5, 5),
]


def densify_inputs(rng, Tp, Mp, Pw, kind):
    """int32 numpy channel arrays of one edge kind: w[Tp], d/ra/rack_of/
    slots[Mp], pc/pm/pr[Tp, Pw]; the last eighth of the columns is
    padding (slots 0, rack -1), as a padded instance has."""
    racks = max(Mp // 8, 1)
    real = Mp - Mp // 8
    rack_of = np.where(np.arange(Mp) < real, rng.integers(0, racks, Mp), -1)
    slots = np.where(np.arange(Mp) < real, rng.integers(0, 4, Mp), 0)
    w = np.where(rng.random(Tp) < 0.1, INF, rng.integers(0, 5000, Tp))
    d = np.where(rng.random(Mp) < 0.1, INF, rng.integers(0, 5000, Mp))
    ra = np.where(rng.random(Mp) < 0.1, INF, rng.integers(0, 5000, Mp))
    pc = np.where(rng.random((Tp, Pw)) < 0.1, INF,
                  rng.integers(0, 3000, (Tp, Pw)))
    pm = np.where(rng.random((Tp, Pw)) < 0.3, -1,
                  rng.integers(0, real, (Tp, Pw)))
    pr = np.where(rng.random((Tp, Pw)) < 0.5, -1,
                  rng.integers(0, racks, (Tp, Pw)))
    if kind == "none":
        pm[:], pr[:] = -1, -1
    elif kind == "padhit":
        pm = rng.integers(real - 1, Mp, (Tp, Pw))
        pr = rng.integers(-1, 1, (Tp, Pw))
    elif kind == "noslots":
        slots[:] = 0
    elif kind == "winf":
        w[:] = INF
    elif kind == "wrap":
        w = rng.integers(2**31 - 2**20, 2**31, Tp)
        d = rng.integers(2**30, 2**31, Mp)
        pc = rng.integers(2**31 - 2**20, 2**31, (Tp, Pw))
        ra = rng.integers(2**30, 2**31, Mp)
    return tuple(np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)
                 for a in (w, d, ra, rack_of, slots, pc, pm, pr))


@pytest.mark.parametrize("kind", KINDS)
def test_twin_equals_reference_at_edge_inputs(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    reset_launch_counts()
    for Tp, Mp, Pw, n in SHAPES:
        a = densify_inputs(rng, Tp, Mp, Pw, kind)
        want = np.asarray(ref._densify(*map(jnp.asarray, a), n_prefs=n))
        got = densify.densify(*map(torch.from_numpy, a), n_prefs=n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{kind} {(Tp, Mp, Pw, n)}")
    assert all(k.launches == 0 for k in KERNELS)


def test_edge_kinds_reach_their_edges():
    """The inputs do what their names say, so the test above covers the
    wrap, the all-INF and the padded-column hits."""
    rng = np.random.default_rng(99)
    w, d, ra, rack_of, slots, pc, pm, pr = densify_inputs(
        rng, 64, 64, 3, "wrap")
    assert (w.astype(np.int64)[:, None] + d > 2**31 - 1).all()
    assert (pc.astype(np.int64)[..., None] + ra > 2**31 - 1).all()
    *_, slots, pc, pm, pr = densify_inputs(rng, 64, 64, 3, "padhit")
    assert (slots[pm] == 0).mean() > 0.5 and (pr == -1).any()
    c = densify.densify_plain(
        *map(torch.from_numpy, densify_inputs(rng, 16, 64, 3, "noslots")),
        n_prefs=3)
    assert (c == INF).all()
    a = densify_inputs(rng, 16, 64, 3, "winf")
    c = densify.densify_plain(*map(torch.from_numpy, a), n_prefs=0)
    assert (c == INF).all()
