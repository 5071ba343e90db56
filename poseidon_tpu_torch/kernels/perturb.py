"""K6 ``perturb``: the what-if batch's B jittered variants of one dense
instance, bit for bit with the reference's random bits, and its plain
twin.

Replaces ``poseidon_tpu/ops/batch.py:100`` ``_perturb_kernel``. The
reference draws its jitter factors with ``jax.random.randint`` under
``enable_x64`` (an int64 draw: 64 random bits per value) from
``fold_in(PRNGKey(seed), b)`` split four ways, with jax's
``threefry2x32`` generator and its partitionable counter layout (the
bits of entry n hash the counter ``(n >> 32, n & 0xffffffff)``). This
module carries its own copy of that algorithm: ``threefry2x32`` and
``variant_keys`` here are what the CUDA source computes, and the twin
does the same arithmetic in int64 torch, masked to 32 bits. The CUDA
source is ``csrc/perturb.cu``; its header note gives the bounds and the
design. ``table_plan`` is the table kernel's launch plan (tile sizes,
variant chunk, shared memory and grid), here so that the CPU tests
reach its arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**29
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

TABLE_THREADS = 256     # a table block (csrc/perturb.cu)
TILE_GROUPS = 4         # 16-byte groups a thread holds, down one column
MAX_CGW = 32            # 16-byte column groups of a tile row: one warp
VARIANT_CHUNK = 32      # variants staged in shared memory at a time
SMEM_CAP = 232_448      # shared memory a Hopper block may opt into
# each warp's preference list: its 32 x 4 x TILE_GROUPS entries' c0 and
# jittered values (int32) and lane/entry ids (uint16)
HASH_SMEM = TABLE_THREADS // 32 * 32 * 4 * TILE_GROUPS * (4 + 4 + 2)

KERNEL = Kernel(
    name="perturb",
    source="poseidon_tpu_torch/kernels/csrc/perturb.cu",
    replaces="poseidon_tpu/ops/batch.py:100",
)


@dataclasses.dataclass(frozen=True)
class TablePlan:
    """The table kernel's launch plan: one block a tile of ``tile_rows``
    rows x ``4 * cgw`` columns, variants 1..B-1 staged ``chunk`` at a
    time; ``smem`` bytes of shared memory hold the warps' preference
    lists (HASH_SMEM) and one chunk's stage."""

    cgw: int          # 16-byte column groups of a tile row (threads a row)
    tile_rows: int    # rows of a tile: (TABLE_THREADS / cgw) * TILE_GROUPS
    row_tiles: int
    col_tiles: int
    chunk: int        # variants staged at a time
    smem: int         # dynamic shared memory of a block, bytes

    @property
    def tile_cols(self) -> int:
        return 4 * self.cgw

    @property
    def grid(self) -> int:
        return self.row_tiles * self.col_tiles


def table_plan(B: int, Tp: int, Mp: int) -> TablePlan:
    """The plan of ``B`` variants of a [Tp, Mp] table (Mp a multiple of
    4): a tile row spans the narrowest power of two of 16-byte groups
    that covers Mp, at most one warp's 32 (512 bytes); a thread holds
    TILE_GROUPS groups of one column, TABLE_THREADS / cgw rows apart; the
    chunk is at most VARIANT_CHUNK variants and what fits SMEM_CAP
    beside the preference lists."""
    if B < 1 or Tp < 1 or Mp < 4 or Mp % 4:
        raise ValueError(f"no table plan for B={B}, [{Tp}, {Mp}]")
    mg = Mp // 4
    cgw = min(MAX_CGW, 1 << (mg - 1).bit_length())
    tile_rows = TABLE_THREADS // cgw * TILE_GROUPS
    per_variant = (tile_rows + 4 * cgw + 4 + 1) * 4
    chunk = max(1, min(VARIANT_CHUNK, B - 1,
                       (SMEM_CAP - HASH_SMEM) // per_variant))
    return TablePlan(cgw=cgw, tile_rows=tile_rows,
                     row_tiles=-(-Tp // tile_rows), col_tiles=-(-mg // cgw),
                     chunk=chunk, smem=HASH_SMEM + chunk * per_variant)


def threefry2x32(k0, k1, x0, x1):
    """jax's threefry2x32 hash (20 rounds, 5 key injections) on int64
    tensors or Python ints holding uint32 values; returns (y0, y1)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _derive(key: tuple[int, int], i: int) -> tuple[int, int]:
    """``threefry(key, (0, i))``: jax's ``fold_in(key, i)`` and entry i
    of its partitionable ``split(key, n)``."""
    return threefry2x32(key[0], key[1], 0, i)


def variant_keys(seed: int, b: int) -> tuple:
    """The randint subkeys of variant b, in the reference's order
    (w, dgen, pref part, u): for each, the (high-bits, low-bits) pair of
    keys of one int64 draw."""
    kb = _derive((0, seed & _M32), b)
    out = []
    for i in range(4):
        k = _derive(kb, i)
        out.append((_derive(k, 0), _derive(k, 1)))
    return tuple(out)


def _jitter(keys, x: torch.Tensor, scale: int, pct: int) -> torch.Tensor:
    """``jitter`` of the reference on one array: a factor drawn at each
    flat index, floor divisions in int64, INF kept as INF."""
    span = 2 * pct + 1
    m32 = (1 << 32) % span
    mul = (m32 * m32) % span
    n = torch.arange(x.numel(), dtype=torch.int64, device=x.device).reshape(
        x.shape)
    hi_n, lo_n = n >> 32, n & _M32

    def bits_mod(k):
        y0, y1 = threefry2x32(k[0], k[1], hi_n, lo_n)
        return ((y0 % span) * m32 + y1 % span) % span

    hi, lo = keys
    f = (100 - pct) + (bits_mod(hi) * mul + bits_mod(lo)) % span
    x64 = x.to(torch.int64)
    y = torch.clamp((x64 // scale * f // 100) * scale, 0, INF - 1)
    return torch.where(x64 < INF, y, INF).to(torch.int32)


def perturb_plain(c0, u0, w0, dgen0, s, n_variants: int, scale: int,
                  seed: int, pct: int):
    """The reference's ``_perturb_kernel`` restated in PyTorch, one
    variant at a time."""
    Tp, Mp = c0.shape
    B = n_variants
    i32 = torch.int32
    c = torch.empty((B, Tp, Mp), dtype=i32, device=c0.device)
    u = torch.empty((B, Tp), dtype=i32, device=c0.device)
    w = torch.empty((B, Tp), dtype=i32, device=c0.device)
    dg = torch.empty((B, Mp), dtype=i32, device=c0.device)
    generic = torch.clamp(
        w0[:, None].to(torch.int64) + dgen0[None, :].to(torch.int64), max=INF
    ).to(i32)
    pref_part = torch.where(c0 < generic, c0, INF)
    for b in range(B):
        if b == 0:
            c[0], u[0], w[0], dg[0] = c0, u0, w0, dgen0
            continue
        k1, k2, k3, k4 = variant_keys(seed, b)
        w[b] = _jitter(k1, w0, scale, pct)
        dg[b] = _jitter(k2, dgen0, scale, pct)
        p_b = _jitter(k3, pref_part, scale, pct)
        g_b = torch.clamp(
            w[b][:, None].to(torch.int64) + dg[b][None, :].to(torch.int64),
            max=INF,
        ).to(i32)
        c[b] = torch.where(s[None, :] > 0, torch.minimum(g_b, p_b), INF)
        u[b] = _jitter(k4, u0, scale, pct)
    cmax = torch.clamp(
        torch.where(c < INF, c, 0).amax(dim=(1, 2)) * 2, min=1
    ).to(i32)
    return c, u, w, dg, cmax


def perturb(c0, u0, w0, dgen0, s, n_variants: int, scale: int, seed: int,
            pct: int):
    """Build ``n_variants`` jittered copies of one instance: c0 int32
    [Tp, Mp], u0/w0 int32[Tp], dgen0/s int32[Mp]; returns (c [B, Tp, Mp],
    u [B, Tp], w [B, Tp], dg [B, Mp], cmax [B]), all int32, variant 0 the
    input. ``scale`` is the instance's scale (n_tasks + 1), ``seed`` the
    reference's int32 seed, ``pct`` its ``magnitude_pct``. CPU tensors
    take the plain twin; CUDA tensors launch K6."""
    if not on_card(c0, u0, w0, dgen0, s):
        return perturb_plain(c0, u0, w0, dgen0, s, n_variants, scale, seed,
                             pct)
    Tp, Mp = c0.shape
    B = n_variants
    if B < 1:
        raise ValueError(f"n_variants must be >= 1, got {B}")
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    if not 0 <= pct < 2**30 or scale < 1:
        raise ValueError(f"pct {pct} must be in [0, 2^30) and scale "
                         f"{scale} at least 1")
    if Mp % 4:
        raise ValueError(f"[{Tp}, {Mp}]: Mp must be a multiple of 4 (the "
                         f"kernel moves 16-byte groups of a row)")
    i32 = torch.int32
    dev = c0.device
    c = torch.empty((B, Tp, Mp), dtype=i32, device=dev)
    u = torch.empty((B, Tp), dtype=i32, device=dev)
    w = torch.empty((B, Tp), dtype=i32, device=dev)
    dg = torch.empty((B, Mp), dtype=i32, device=dev)
    cmax = torch.empty(B, dtype=i32, device=dev)
    keys = torch.empty((B, 4), dtype=i32, device=dev)
    ptrs = [
        kernel_arg(c0, "c0", i32, (Tp, Mp)), kernel_arg(u0, "u0", i32, (Tp,)),
        kernel_arg(w0, "w0", i32, (Tp,)),
        kernel_arg(dgen0, "dgen0", i32, (Mp,)), kernel_arg(s, "s", i32, (Mp,)),
        c.data_ptr(), u.data_ptr(), w.data_ptr(), dg.data_ptr(),
        cmax.data_ptr(), keys.data_ptr(),
    ]
    plan = table_plan(B, Tp, Mp)
    with torch.cuda.device(dev):
        err = library("perturb").perturb_launch(
            *ptrs, B, Tp, Mp, int(scale), int(seed), int(pct), plan.cgw,
            plan.tile_rows, plan.col_tiles, plan.chunk, plan.smem, plan.grid,
            stream_ptr(c0),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return c, u, w, dg, cmax
