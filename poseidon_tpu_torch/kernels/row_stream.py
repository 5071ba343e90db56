"""Launch plans of the row-stream kernels (K2 ``row_options``, K3
``bid_pass``): grid, ring depth, tile width and dynamic shared memory.

Both kernels walk rows of the [Tp, Mp] int32 table through a ring of
shared-memory stages (``csrc/common.cuh`` "Row streams"). The arithmetic
of a plan lives here, in Python, so the CPU tests reach it; the kernels
take the plan's numbers as arguments. A plan depends on the device only
through two numbers read once per device and shape: the SM count and
the blocks of the kernel that fit on one SM (an occupancy query, which
also lifts the kernel's dynamic shared-memory cap). ``PlanCache`` keeps
every plan it made, so a launch costs one dictionary lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

SMEM_MAX = 232_448          # dynamic shared memory one block may use on sm_90 (227 KB)
WARPS = 8                   # warps per block (csrc/common.cuh THREADS = 256)
TILE_COLUMNS_MAX = 1024     # columns of c one stage holds (4 KiB)
RING_BYTES = 8_192          # bytes of tiles a warp aims to keep in its ring
STAGES_MIN, STAGES_MAX = 2, 8


@dataclasses.dataclass(frozen=True)
class Layout:
    """What a block holds in shared memory, for one Mp."""

    stages: int          # ring depth per warp
    chunk: int           # columns per tile (a multiple of 4: 16-byte tiles)
    p_resident: bool     # p staged once per block (else: in every stage)
    smem: int            # dynamic shared memory bytes of one block

    @property
    def stage_bytes(self) -> int:
        return self.chunk * 4 * (1 if self.p_resident else 2)


@dataclasses.dataclass(frozen=True)
class Plan:
    layout: Layout
    grid: int            # persistent blocks: min(rows, SMs x blocks per SM)


def layout(Mp: int, meta_ints: int = 0) -> Layout:
    """The shared-memory layout for rows of Mp columns, ``meta_ints``
    ints of per-warp metadata. Rows are cut into ``ceil(Mp / 1024)``
    tiles of equal width (rounded up to 4 columns); the ring holds about
    8 KiB per warp, between 2 and 8 tiles (at Mp >= 1024 two 4 KiB
    tiles: on the H100 more resident warps beat a deeper ring, and the
    smaller ring lets 3 blocks share an SM). p is resident when it fits
    beside the ring, else each stage carries p's chunk too, so the total
    stays under the 227 KB a block may use at any Mp."""
    if Mp < 4 or Mp % 4:
        raise ValueError(f"Mp={Mp} must be a positive multiple of 4")
    ntile = -(-Mp // TILE_COLUMNS_MAX)
    chunk = -(-Mp // ntile)
    chunk += -chunk % 4
    for p_resident in (True, False):
        stage_bytes = chunk * 4 * (1 if p_resident else 2)
        stages = max(STAGES_MIN, min(STAGES_MAX, RING_BYTES // stage_bytes))
        smem = (WARPS * stages * 8                 # one mbarrier per stage
                + WARPS * meta_ints * 4
                + (Mp * 4 if p_resident else 0)
                + WARPS * stages * stage_bytes)
        if smem <= SMEM_MAX:
            return Layout(stages, chunk, p_resident, smem)
    raise AssertionError("unreachable: a 2-stage ring of 8 KiB tiles fits")


def grid(rows: int, sm_count: int, blocks_per_sm: int) -> int:
    """One wave of persistent blocks, never more blocks than rows."""
    return max(1, min(rows, sm_count * blocks_per_sm))


def plan(rows: int, Mp: int, meta_ints: int, sm_count: int,
         occupancy: Callable[[int], int]) -> Plan:
    """The plan for ``rows`` rows of Mp columns; ``occupancy(smem)``
    gives the blocks that fit on one SM."""
    lay = layout(Mp, meta_ints)
    blocks = occupancy(lay.smem)
    if blocks < 1:
        raise RuntimeError(f"no block of {lay.smem} B shared memory fits on an SM")
    return Plan(lay, grid(rows, sm_count, blocks))


class PlanCache:
    """Plans by (device, rows, Mp, *shape), made on first use by
    ``make(rows, Mp, *shape, sm_count, occupancy)``: the row-stream
    ``plan`` with ``meta_ints`` unless another maker is given (K1's
    ``tile_stream.plan``, whose shape adds Pw and n_prefs)."""

    def __init__(self, meta_ints: int = 0, make: Callable | None = None):
        self._make = make or (
            lambda rows, Mp, sm, occ: plan(rows, Mp, meta_ints, sm, occ))
        self._plans: dict[tuple, object] = {}

    def get(self, device, rows: int, Mp: int, sm_count: Callable[[], int],
            occupancy: Callable[[int], int], *shape: int):
        key = (device, rows, Mp, *shape)
        p = self._plans.get(key)
        if p is None:
            p = self._plans[key] = self._make(rows, Mp, *shape, sm_count(),
                                              occupancy)
        return p

    def __getitem__(self, key: tuple):
        """The plan made for (device, rows, Mp, *shape)."""
        return self._plans[key]

    def __len__(self) -> int:
        return len(self._plans)
