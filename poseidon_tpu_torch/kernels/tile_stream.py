"""Launch plan of the tile writer (K1 ``densify``): column chunk, tile
height, input stages, dynamic shared memory and grid.

K1 writes the [Tp, Mp] int32 table in work items of one row tile by one
column chunk (``csrc/densify.cu``). A thread owns 4 adjacent columns of
the chunk, so a chunk of ``cols`` columns takes ``cols / 4`` threads per
row and the block's 256 threads cover ``rows_per_pass`` rows at once;
a tile is ``ROWS_PER_THREAD`` such passes. Each full tile's task-side
inputs (``w`` and the ``pc/pm/pr`` rows) arrive in a shared-memory
stage by 1-D bulk copies while the tile before it is written; a tile
that ends past Tp (the last, when Tp is not a multiple of the tile
height) is read from global memory directly, so no copy reads past a
tensor. The arithmetic lives here so the CPU tests reach it; the kernel
takes the plan's numbers as arguments. ``densify.PLANS`` (a
``row_stream.PlanCache``) keeps a plan per (device, Tp, Mp, Pw,
n_prefs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from poseidon_tpu_torch.kernels import row_stream

THREADS = 32 * row_stream.WARPS       # csrc/common.cuh THREADS
CHUNK_COLUMNS_MAX = 4 * THREADS       # one 16-byte vector per thread and row
ROWS_PER_THREAD = 4                   # rows of a tile per thread (csrc/densify.cu)
NP_UNROLLED = 4                       # n_prefs 0..4 unrolled, more: a runtime loop
RING_BYTES = 16_384                   # stage bytes a block aims to keep in flight
STAGES_MIN, STAGES_MAX = 2, 4


@dataclasses.dataclass(frozen=True)
class TilePlan:
    cols: int            # columns of a chunk: 4 x threads per row, a power of two
    stages: int          # input stages (0: every tile read from global memory)
    p_staged: bool       # a stage carries the tile's pc/pm/pr rows (n_prefs > 0)
    smem: int            # dynamic shared memory bytes of one block
    grid: int            # persistent blocks: min(items, SMs x blocks per SM)

    @property
    def rows_per_pass(self) -> int:
        return THREADS // (self.cols // 4)

    @property
    def tile_rows(self) -> int:
        return tile_rows(self.cols)


def chunk_columns(Mp: int) -> int:
    """Columns of one chunk: the least power of two x 4 that holds Mp,
    at most 1024 (every thread of a full-width row stores)."""
    if Mp < 4 or Mp % 4:
        raise ValueError(f"Mp={Mp} must be a positive multiple of 4")
    tpr = 1
    while tpr * 4 < Mp and tpr < THREADS:
        tpr *= 2
    return 4 * tpr


def tile_rows(cols: int) -> int:
    """Rows of a tile: ROWS_PER_THREAD passes of THREADS / (cols / 4)
    rows (a multiple of 4, so every full tile's bulk copies are 16-byte
    aligned at any Pw)."""
    return ROWS_PER_THREAD * (THREADS // (cols // 4))


def items(Tp: int, Mp: int, cols: int) -> int:
    """Work items (row tile x column chunk) of a Tp x Mp table."""
    return -(-Tp // tile_rows(cols)) * -(-Mp // cols)


def stage_bytes(cols: int, Pw: int, p_staged: bool) -> int:
    """Bytes of one input stage: w, then pc, pm, pr (tile_rows x Pw
    each) when p is staged."""
    return tile_rows(cols) * (1 + 3 * Pw if p_staged else 1) * 4


def smem_bytes(cols: int, stages: int, Pw: int, p_staged: bool) -> int:
    """Dynamic shared memory of a block, in the kernel's order: the
    stages' mbarriers (padded to 16 bytes), then the stages."""
    return -(-stages * 8 // 16) * 16 + stages * stage_bytes(cols, Pw, p_staged)


def layout(Mp: int, Pw: int, n_prefs: int) -> tuple[int, int, bool, int]:
    """(cols, stages, p_staged, smem) for rows of Mp columns and Pw
    preference columns of which n_prefs are live. The ring holds about
    16 KiB, 2 to 4 stages; when even 2 stages do not fit in 227 KB (a
    very wide Pw), every tile is read from global memory."""
    if not 0 <= n_prefs <= Pw:
        raise ValueError(f"n_prefs={n_prefs} outside [0, {Pw}]")
    cols = chunk_columns(Mp)
    p_staged = n_prefs > 0
    ring = RING_BYTES // stage_bytes(cols, Pw, p_staged)
    stages = max(STAGES_MIN, min(STAGES_MAX, ring))
    smem = smem_bytes(cols, stages, Pw, p_staged)
    if smem > row_stream.SMEM_MAX:
        stages, smem = 0, 0
    return cols, stages, p_staged, smem


def plan(Tp: int, Mp: int, Pw: int, n_prefs: int, sm_count: int,
         occupancy: Callable[[int], int]) -> TilePlan:
    """The plan for a Tp x Mp table; ``occupancy(smem)`` gives the
    blocks that fit on one SM."""
    cols, stages, p_staged, smem = layout(Mp, Pw, n_prefs)
    blocks = occupancy(smem)
    if blocks < 1:
        raise RuntimeError(f"no block of {smem} B shared memory fits on an SM")
    grid = row_stream.grid(items(Tp, Mp, cols), sm_count, blocks)
    return TilePlan(cols, stages, p_staged, smem, grid)


def bulk_copies(p: TilePlan, Tp: int, Pw: int, tile: int):
    """The bulk copies (byte offset into the source tensor, bytes) that
    fill row tile ``tile``'s stage, in the kernel's order (w, pc, pm,
    pr), or None when the kernel reads that tile from global memory."""
    R = p.tile_rows
    t0 = tile * R
    if p.stages == 0 or t0 + R > Tp:
        return None
    out = [(t0 * 4, R * 4)]
    if p.p_staged:
        out += [(t0 * Pw * 4, R * Pw * 4)] * 3
    return out
