"""The launch plan of K9 ``cs_sweep`` and K10 ``bf_relax`` over a residual
CSR (``csrc/csr_plan.cuh`` reads it; the constants here are its own).

The work is split by positions, not by nodes. A node of degree above
``CHUNK`` is HEAVY: its segment is dealt in ``CHUNK``-position chunks over
the ``CLUSTER`` blocks of one thread-block cluster (block rank r takes
chunks r, r + CLUSTER, ...). The other nodes are LIGHT: runs of
consecutive light nodes, at most ``MAX_NODES`` nodes and ``CHUNK``
positions a run, one block each. Each item is four int32s, ``(node_lo,
node_hi, pos_lo, pos_hi)``: the heavy items first (one node each), then
the light ones. The plan is made once per CSR on the host from the
degree counts, with no device read, and uploaded with each position's
tail node (int32), which a light block needs to find a position's node.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from poseidon_tpu_torch.kernels._args import kernel_arg

THREADS = 256          # a block
ITEMS = 8              # positions a thread per chunk
CHUNK = THREADS * ITEMS  # 2048: a light block's positions, a heavy chunk
CLUSTER = 8            # blocks of a heavy node (the portable cluster size)
MAX_NODES = THREADS    # nodes of a light block


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """One CSR's launch plan on its device."""

    items: torch.Tensor   # int32[n_heavy + n_light, 4]
    tail: torch.Tensor    # int32[R]: each position's tail node
    n_heavy: int
    n_light: int
    NN: int               # the CSR's nodes

    @property
    def blocks(self) -> int:
        """The launch's grid: a cluster per heavy node, the light blocks
        rounded up to whole clusters."""
        return CLUSTER * (self.n_heavy + -(-self.n_light // CLUSTER))

    @functools.cached_property
    def pointers(self) -> tuple[int, int]:
        """The two tables' device pointers, checked once: a plan's tensors
        never change, and a sweep launches thousands of times."""
        return (
            kernel_arg(self.items, "plan.items", torch.int32,
                       (self.n_heavy + self.n_light, 4)),
            kernel_arg(self.tail, "plan.tail", torch.int32,
                       (self.tail.shape[0],)),
        )


def plan_items(seg: np.ndarray) -> tuple[np.ndarray, int]:
    """The plan's items for segment offsets ``seg`` (int[NN + 1]) and the
    number of heavy items, which come first."""
    seg = np.asarray(seg, np.int64)
    NN = seg.shape[0] - 1
    deg = np.diff(seg)
    heavy = np.flatnonzero(deg > CHUNK)
    items = [(v, v + 1, seg[v], seg[v + 1]) for v in heavy]
    # light runs: cut at every heavy node, then greedily at MAX_NODES
    # nodes or CHUNK positions (a light node alone fits, so each run
    # takes at least one node)
    stops = np.append(heavy, NN)
    lo = 0
    for stop in stops:
        while lo < stop:
            by_pos = int(np.searchsorted(seg, seg[lo] + CHUNK, "right")) - 1
            hi = min(int(stop), lo + MAX_NODES, by_pos)
            items.append((lo, hi, seg[lo], seg[hi]))
            lo = hi
        lo = int(stop) + 1
    out = np.asarray(items, np.int32).reshape(-1, 4)
    return out, len(heavy)


def make_plan(seg: np.ndarray, device) -> CsrPlan:
    """The plan of the CSR with host offsets ``seg``, uploaded to
    ``device``."""
    items, n_heavy = plan_items(seg)
    seg = np.asarray(seg, np.int64)
    tail = np.repeat(np.arange(seg.shape[0] - 1, dtype=np.int32),
                     np.diff(seg))
    return CsrPlan(
        items=torch.as_tensor(items, device=device),
        tail=torch.as_tensor(tail, device=device),
        n_heavy=n_heavy,
        n_light=items.shape[0] - n_heavy,
        NN=seg.shape[0] - 1,
    )


def plan_args(plan: CsrPlan, NN: int, R: int) -> tuple[int, int]:
    """The plan's two device pointers, for a CSR of ``NN`` nodes and ``R``
    positions: a plan deals positions, so another CSR's plan would deal
    the wrong ones."""
    if (plan.NN, plan.tail.shape[0]) != (NN, R):
        raise ValueError(f"plan: made for {plan.NN} nodes and "
                         f"{plan.tail.shape[0]} positions, the CSR has {NN} "
                         f"and {R}")
    return plan.pointers
