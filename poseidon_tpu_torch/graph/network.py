"""L0 flow-network data model: structure-of-arrays, padded.

The flow network is a set of int32 arc/node tables padded to bucketed
sizes. In this package the tables stay on the host as numpy arrays:
the device-resident round (ops/resident.py) never uploads the network
itself, only the topology index maps and the pricing inputs; the
general-graph solvers (ops/cost_scaling.py, ops/ssp.py) upload a whole
network once per solve, and the C++ oracle reads it as DIMACS text.

Conventions
-----------
* Arcs are directed ``src -> dst`` with integer capacity ``cap >= 0`` and
  integer unit cost ``cost``. Lower bounds are always 0.
* ``supply[v] > 0`` means v is a source of that many flow units, ``< 0`` a
  demand. Supplies sum to 0 over real nodes.
* Padding: arc slots with index >= n_arcs have cap == 0, cost == 0 and
  src == dst == 0. Node slots >= n_nodes have supply == 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


def pad_bucket(n: int, minimum: int = 16) -> int:
    """Next padding bucket >= max(n, minimum).

    Powers of two up to 1024, then multiples of 1024. The fine ladder
    keeps padding overhead under 10% at the flagship scale (10k tasks
    pad to 10240, not 16384) while the number of distinct padded
    shapes stays O(log n + n / 1024).
    """
    b = minimum
    while b < n and b < 1024:
        b *= 2
    if n <= b:
        return b
    return ((n + 1023) // 1024) * 1024


@dataclasses.dataclass(frozen=True)
class FlowNetwork:
    """A padded min-cost-flow instance as host int32 arrays.

    Shapes: arcs padded to E slots, nodes padded to N slots; ``n_nodes``
    / ``n_arcs`` carry the real counts.
    """

    src: np.ndarray      # int32[E] arc tail
    dst: np.ndarray      # int32[E] arc head
    cap: np.ndarray      # int32[E] capacity (0 on padding)
    cost: np.ndarray     # int32[E] unit cost (0 on padding)
    supply: np.ndarray   # int32[N] node supply (+source / -demand)
    n_nodes: int
    n_arcs: int

    @property
    def num_node_slots(self) -> int:
        return self.supply.shape[-1]

    @property
    def num_arc_slots(self) -> int:
        return self.src.shape[-1]

    @staticmethod
    def from_arrays(
        src: Any,
        dst: Any,
        cap: Any,
        cost: Any,
        supply: Any,
        *,
        node_slots: int | None = None,
        arc_slots: int | None = None,
        validate: bool = True,
    ) -> "FlowNetwork":
        """Build a padded instance from host arrays (any integer dtype)."""
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        cap = np.asarray(cap, dtype=np.int32)
        cost = np.asarray(cost, dtype=np.int32)
        supply = np.asarray(supply, dtype=np.int32)
        n_arcs = src.shape[0]
        n_nodes = supply.shape[0]
        if validate:
            if not (dst.shape[0] == cap.shape[0] == cost.shape[0] == n_arcs):
                raise ValueError("arc arrays disagree on length")
            if n_arcs and (src.min() < 0 or src.max() >= n_nodes):
                raise ValueError("arc src out of range")
            if n_arcs and (dst.min() < 0 or dst.max() >= n_nodes):
                raise ValueError("arc dst out of range")
            if n_arcs and cap.min() < 0:
                raise ValueError("negative capacity")
            if int(supply.sum()) != 0:
                raise ValueError(f"supplies must sum to 0, got {supply.sum()}")
        N = node_slots or pad_bucket(n_nodes)
        E = arc_slots or pad_bucket(n_arcs)
        if N < n_nodes or E < n_arcs:
            raise ValueError("padding slots smaller than real counts")

        def pad(a: np.ndarray, size: int) -> np.ndarray:
            out = np.zeros(size, dtype=np.int32)
            out[: a.shape[0]] = a
            return out

        return FlowNetwork(
            src=pad(src, E),
            dst=pad(dst, E),
            cap=pad(cap, E),
            cost=pad(cost, E),
            supply=pad(supply, N),
            n_nodes=int(n_nodes),
            n_arcs=int(n_arcs),
        )

    def with_costs(self, cost: Any) -> "FlowNetwork":
        """Same topology, new arc costs (host array or CPU/CUDA tensor)."""
        if hasattr(cost, "detach"):
            cost = cost.detach().cpu().numpy()
        return dataclasses.replace(self, cost=np.asarray(cost, np.int32))

    def to_host(self) -> dict[str, np.ndarray]:
        na, nn = self.n_arcs, self.n_nodes
        return {
            "src": self.src[:na],
            "dst": self.dst[:na],
            "cap": self.cap[:na],
            "cost": self.cost[:na],
            "supply": self.supply[:nn],
        }


def total_supply(net: FlowNetwork) -> int:
    """Total positive supply (the flow value a feasible solution must route)."""
    s = np.asarray(net.supply)
    return int(s[s > 0].sum())
