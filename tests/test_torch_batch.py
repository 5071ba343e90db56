"""Differential tests: the port's batched lanes vs the reference's.

- K6 ``perturb``'s plain twin against the reference's
  ``_perturb_kernel`` under ``enable_x64(True)`` (the reference's own
  call context), on all five outputs: seeds 0, 123 and 2^31-1, B in
  {1, 2, 5}, ``magnitude_pct`` in {0, 10, 50}, INF entries (INF w rows,
  an INF dgen column), zero-slot columns, scale 1 and above 1;
- ``solve_what_if`` and ``solve_heterogeneous`` on the CPU against the
  reference at small sizes over mixed shapes and all six cost models:
  costs, certificates, assignments and rounds, tolerance 0;
- the batched budget guard's message and ``max_variants_for``;
- K6's table launch plan (``kernels/perturb.py`` ``table_plan``, which
  the CUDA kernel reads): every cell of the table in exactly one tile
  and thread slot, every variant in exactly one staged chunk, shared
  memory within a block's budget and aligned, at B 1, 2, 33, 34 (a
  chunk's edge), 63, 64, 65 and past one chunk, Tp not a multiple of the row tile, Mp 16 and 1028; the
  kernel's constants the plan's own.

The reference's instances come from ``tests/helpers.build_priced`` (the
reference's builder and models); the port solves the same
``TransportInstance`` arrays.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.compat import enable_x64
from poseidon_tpu.ops import batch as ref_batch
from poseidon_tpu.ops import dense_auction as ref_da
from poseidon_tpu.ops.transport import extract_instance
from poseidon_tpu_torch.guards import SyncCounter
from poseidon_tpu_torch.kernels import perturb as k6
from poseidon_tpu_torch.kernels.perturb import perturb, variant_keys
from poseidon_tpu_torch.ops import batch as port_batch
from poseidon_tpu_torch.ops import dense_auction as port_da
from poseidon_tpu_torch.ops.transport import TransportInstance
from tests.helpers import build_priced

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

INF = 2**29
MODELS = ("trivial", "random", "quincy", "wharemap", "coco", "octopus")


def port_instance(inst) -> TransportInstance:
    """The reference's TransportInstance as the port's (same arrays)."""
    return TransportInstance(**{
        f.name: getattr(inst, f.name)
        for f in dataclasses.fields(TransportInstance)
    })


def _table(seed, Tp, Mp, scale):
    """A dense instance as densify leaves it: w + dgen, a preference
    overlay on ~20% of the entries, INF rows and columns, zero-slot
    columns set to INF."""
    rng = np.random.default_rng(seed)
    w0 = (rng.integers(0, 60, Tp) * scale).astype(np.int32)
    w0[-3:] = INF
    d0 = (rng.integers(0, 60, Mp) * scale).astype(np.int32)
    d0[min(2, Mp - 1)] = INF
    s = rng.integers(0, 3, Mp).astype(np.int32)
    s[0] = 0
    c0 = np.minimum(w0[:, None].astype(np.int64) + d0[None, :], INF)
    pref = rng.random((Tp, Mp)) < 0.2
    c0 = np.where(pref, np.minimum(c0, rng.integers(0, 50, (Tp, Mp)) * scale),
                  c0)
    c0 = np.where(s[None, :] > 0, c0, INF).astype(np.int32)
    u0 = (rng.integers(0, 90, Tp) * scale).astype(np.int32)
    u0[-2:] = 0
    return c0, u0, w0, d0, s


@pytest.mark.parametrize("seed", [0, 123, 2**31 - 1])
@pytest.mark.parametrize("n_variants", [1, 2, 5])
@pytest.mark.parametrize("pct", [0, 10, 50])
@pytest.mark.parametrize("scale", [1, 7])
def test_perturb_twin_equals_reference(seed, n_variants, pct, scale):
    c0, u0, w0, d0, s = _table(seed % 1000 + n_variants, 48, 20, scale)
    with enable_x64(True):
        ref = ref_batch._perturb_kernel(
            jnp.asarray(c0), jnp.asarray(u0), jnp.asarray(w0),
            jnp.asarray(d0), jnp.asarray(s), jnp.asarray(scale),
            jnp.int32(seed), n_variants, pct,
        )
        ref = [np.asarray(x) for x in ref]
    got = perturb(*(torch.from_numpy(x) for x in (c0, u0, w0, d0, s)),
                  n_variants, scale, seed, pct)
    for name, r, g in zip(("c", "u", "w", "dgen", "cmax"), ref, got):
        assert np.array_equal(g.numpy(), r), name


def test_perturb_keys_equal_jax_random():
    """The port's copy of threefry2x32 and the partitionable key layout
    gives jax.random's fold_in / split keys."""
    import jax

    for seed in (0, 7, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        for b in (1, 3):
            ks = np.asarray(jax.random.split(jax.random.fold_in(key, b), 4))
            mine = variant_keys(seed, b)
            for i in range(4):
                sub = np.asarray(jax.random.split(ks[i], 2))
                assert tuple(int(x) for x in sub[0]) == mine[i][0]
                assert tuple(int(x) for x in sub[1]) == mine[i][1]


def test_perturb_costs_on_a_densified_instance():
    """``perturb_costs`` over ``build_dense_instance`` equals the
    reference's over its own (variant 0 unperturbed)."""
    rng = np.random.default_rng(11)
    net, meta, _ = build_priced(rng, 6, 30, model="quincy")
    inst = extract_instance(net, meta)
    ref_dev = ref_da.build_dense_instance(inst)
    port_dev = port_da.build_dense_instance(port_instance(inst), "cpu")
    with enable_x64(True):
        ref = [np.asarray(x)
               for x in ref_batch.perturb_costs(ref_dev, 3, 5)]
    got = port_batch.perturb_costs(port_dev, 3, 5)
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), r)
    assert np.array_equal(got[0][0].numpy(), np.asarray(ref_dev.c))


SHAPES = [((5, 18), "trivial"), ((7, 26), "random"), ((8, 31), "quincy"),
          ((6, 22), "wharemap"), ((9, 35), "coco"), ((4, 40), "octopus")]


@pytest.mark.parametrize("shape,model", SHAPES,
                         ids=[m for _s, m in SHAPES])
def test_what_if_equals_reference(shape, model):
    rng = np.random.default_rng(sum(shape))
    net, meta, _ = build_priced(rng, *shape, model=model)
    inst = extract_instance(net, meta)
    # a fuse of 2,000 rounds: a variant the auction cannot certify
    # (trivial pricing with preferences, ROADMAP Queue 3) runs to it in
    # both packages, and the runs must still agree
    ref = ref_batch.solve_what_if(inst, n_variants=4, seed=9,
                                  magnitude_pct=20, max_rounds=2_000)
    fetches, loops = SyncCounter(), SyncCounter()
    got = port_batch.solve_what_if(
        port_instance(inst), n_variants=4, seed=9, magnitude_pct=20,
        max_rounds=2_000, device="cpu", fetches=fetches, loop_syncs=loops,
    )
    for f in ("costs", "converged", "assignments", "rounds"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert fetches.count == 1
    assert loops.count >= int(got.rounds.sum())


@pytest.mark.parametrize("trial", [0, 1])
def test_heterogeneous_equals_reference(trial):
    """Six members, one per model, mixed natural pads in one bucket."""
    rng = np.random.default_rng(100 + trial)
    insts = []
    for model in MODELS:
        m = int(rng.integers(3, 12))
        t = int(rng.integers(8, 40))
        net, meta, _ = build_priced(rng, m, t, model=model)
        insts.append(extract_instance(net, meta))
    ref = ref_batch.solve_heterogeneous(insts)
    fetches = SyncCounter()
    got = port_batch.solve_heterogeneous(
        [port_instance(i) for i in insts], device="cpu", fetches=fetches,
    )
    for f in ("costs", "converged", "assignments", "rounds"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert fetches.count == 1
    assert got.converged.all()


def test_heterogeneous_member_equals_its_solo_solve():
    """A member solved in a bucket with larger mates equals the port's
    own what-if variant 0 of the same instance (its solo cold solve)."""
    rng = np.random.default_rng(5)
    small = extract_instance(*build_priced(rng, 5, 18, model="quincy")[:2])
    big = extract_instance(*build_priced(rng, 12, 60, model="coco")[:2])
    b = port_batch.solve_heterogeneous(
        [port_instance(small), port_instance(big)], device="cpu")
    solo = port_batch.solve_what_if(port_instance(small), n_variants=1,
                                    device="cpu")
    T = small.n_tasks
    assert int(b.costs[0]) == int(solo.costs[0])
    assert np.array_equal(b.assignments[0, :T], solo.assignments[0])


def test_heterogeneous_empty_batch():
    out = port_batch.solve_heterogeneous([], device="cpu")
    assert out.costs.shape == (0,)


def test_member_helpers_equal_reference():
    rng = np.random.default_rng(3)
    insts = [extract_instance(*build_priced(rng, m, t, model="quincy")[:2])
             for m, t in ((5, 18), (9, 40))]
    for inst in insts:
        for floors in ({}, {"t_min": 64, "m_min": 32, "p_min": 3}):
            assert (port_batch.member_bucket_dims(port_instance(inst),
                                                  **floors)
                    == ref_batch.member_bucket_dims(inst, **floors))
    Tp, Mp, P = 64, 16, 2
    members_r = [ref_da.build_member_tables(i, Tp, Mp, P) for i in insts]
    members_p = [port_da.build_member_tables(port_instance(i), Tp, Mp, P)
                 for i in insts]
    a = ref_batch.stack_members(members_r, 4)
    b = port_batch.stack_members(members_p, 4)
    assert port_batch.MEMBER_KEYS == ref_batch.MEMBER_KEYS
    for k in ref_batch.MEMBER_KEYS:
        assert np.array_equal(np.asarray(a[k]), b[k]), k
    assert (port_da.member_side_ints(Tp, Mp, P)
            == ref_da.member_side_ints(Tp, Mp, P))
    with pytest.raises(ValueError):
        port_batch.stack_members(members_p, 1)


def test_batched_budget_names_the_fitting_batch(monkeypatch):
    monkeypatch.setattr(port_da, "DENSE_TABLE_BUDGET_BYTES", 64 << 20)
    monkeypatch.setattr(ref_da, "DENSE_TABLE_BUDGET_BYTES", 64 << 20)
    for da in (ref_da, port_da):
        with pytest.raises(da.DenseMemoryTooLarge) as ei:
            da.check_table_budget(2048, 2048, 8)
        assert "n_variants <= 4" in str(ei.value)
        assert "--serve_max_batch" in str(ei.value)
    assert port_da.max_variants_for(2048, 2048) == 4
    for args in ((4096, 1024, 3 * 4096 + 4 * 1024), (64, 16, 0)):
        assert (port_da.max_variants_for(*args)
                == ref_da.max_variants_for(*args))


def test_what_if_budget_overflow_raises(monkeypatch):
    monkeypatch.setattr(port_da, "DENSE_TABLE_BUDGET_BYTES", 1 << 20)
    rng = np.random.default_rng(2)
    inst = extract_instance(*build_priced(rng, 6, 24, model="quincy")[:2])
    with pytest.raises(port_da.DenseMemoryTooLarge, match="n_variants"):
        port_batch.solve_what_if(port_instance(inst), n_variants=4096,
                                 device="cpu")


def test_mesh_width_waits_for_its_item():
    """The scale lane is ported: a mesh width divides the per-device
    table estimate, as the reference's does."""
    port_da.check_table_budget(64, 16, mesh_width=2)
    for args in ((4096, 1024, 0, 2), (64, 16, 4 * 16, 8)):
        assert (port_da.max_variants_for(*args[:3], mesh_width=args[3])
                == ref_da.max_variants_for(*args[:3], mesh_width=args[3]))


# ---- K6's table launch plan ------------------------------------------

PLAN_SHAPES = [(4096, 1024), (4095, 1024), (33, 1024), (100, 1028),
               (4095, 16), (1, 16), (7, 4)]
PLAN_VARIANTS = [1, 2, 33, 34, 63, 64, 65, 130, 200]


def plan_cells(plan, Tp: int, Mp: int) -> np.ndarray:
    """The (row, 16-byte column group) of every thread slot of the grid
    that stores, by the kernel's own index arithmetic: block -> tile
    (row0, g0), thread -> (lane_row, column group), slot k -> row
    lane_row + k * rows-a-pass."""
    rpp = k6.TABLE_THREADS // plan.cgw
    blk = np.arange(plan.grid)[:, None, None]
    tid = np.arange(k6.TABLE_THREADS)[None, :, None]
    k = np.arange(k6.TILE_GROUPS)[None, None, :]
    row = (blk // plan.col_tiles) * plan.tile_rows + tid // plan.cgw + k * rpp
    cg = (blk % plan.col_tiles) * plan.cgw + tid % plan.cgw
    row, cg = np.broadcast_arrays(row, cg)
    keep = (row < Tp) & (cg < Mp // 4)
    return row[keep] * (Mp // 4) + cg[keep]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_table_plan_stores_every_cell_once(shape):
    Tp, Mp = shape
    plan = k6.table_plan(64, Tp, Mp)
    cells = plan_cells(plan, Tp, Mp)
    assert np.array_equal(np.sort(cells), np.arange(Tp * Mp // 4))
    # every tile holds at least one real cell
    assert plan.row_tiles == -(-Tp // plan.tile_rows)
    assert plan.col_tiles * plan.cgw >= Mp // 4 > (plan.col_tiles - 1) * plan.cgw


@pytest.mark.parametrize("B", PLAN_VARIANTS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_table_plan_stages_every_variant_once(B, shape):
    """Variants 1..B-1 are staged in chunks (variant 0 is c0, written as
    read), as the kernel's loop ``b0 = 1, 1 + chunk, ...`` takes them,
    within the shared-memory budget, each part 16-byte aligned."""
    Tp, Mp = shape
    plan = k6.table_plan(B, Tp, Mp)
    staged = [b for b0 in range(1, B, plan.chunk)
              for b in range(b0, min(b0 + plan.chunk, B))]
    assert staged == list(range(1, B))
    assert 1 <= plan.chunk <= k6.VARIANT_CHUNK
    per_variant = (plan.tile_rows + plan.tile_cols + 4 + 1) * 4
    # the warps' preference lists: 512 entries a warp (4 + 4 + 2 bytes)
    assert k6.HASH_SMEM == k6.TABLE_THREADS // 32 * 512 * 10
    assert plan.smem == k6.HASH_SMEM + plan.chunk * per_variant <= k6.SMEM_CAP
    # a chunk is cut below VARIANT_CHUNK variants (and B - 1) only where
    # one more variant would not fit
    assert (plan.chunk == min(k6.VARIANT_CHUNK, max(B - 1, 1))
            or plan.smem + per_variant > k6.SMEM_CAP)
    # the w and dg stages start 16-byte aligned (dg is read as int4)
    assert k6.HASH_SMEM % 16 == 0
    assert (plan.chunk * plan.tile_rows) % 4 == 0 and plan.tile_cols % 4 == 0
    # powers of two (the kernel shifts and masks by them); a tile row is
    # at most one warp's 32 groups
    for x in (plan.cgw, plan.tile_rows):
        assert x & (x - 1) == 0
    assert plan.cgw <= 32 and plan.tile_rows * plan.cgw == (
        k6.TABLE_THREADS * k6.TILE_GROUPS)
    if B > k6.VARIANT_CHUNK + 1:
        assert len(range(1, B, plan.chunk)) > 1


def test_table_plan_at_config5():
    """BASELINE config 5 with 64 variants: 1,024 tiles of 32 rows x 128
    columns, variants 1-63 in chunks of 32; 62 KB of shared memory, so
    three blocks fit an SM."""
    plan = k6.table_plan(64, 4096, 1024)
    assert (plan.cgw, plan.tile_rows, plan.tile_cols, plan.grid,
            plan.chunk) == (32, 32, 128, 1024, 32)
    assert 3 * plan.smem <= 228 * 1024 - 3 * 1024


def test_table_plan_refuses_a_ragged_row():
    for bad in ((1, 8, 18), (0, 8, 16), (2, 0, 16)):
        with pytest.raises(ValueError):
            k6.table_plan(*bad)


def test_table_constants_agree_with_the_source():
    src = (pathlib.Path(k6.__file__).parent / "csrc" / "perturb.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (TABLE_THREADS|GROUPS) = (\d+);", src)}
    assert got == {"TABLE_THREADS": k6.TABLE_THREADS,
                   "GROUPS": k6.TILE_GROUPS}
    # the preference lists' layout the plan sizes
    assert "WARP_ENTRIES = 32 * ENTRIES" in src
    assert "ENTRIES = 4 * GROUPS" in src
