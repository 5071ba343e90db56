"""DIMACS min-cost-flow text format: read and write an instance, parse a
solution.

DIMACS is the interchange with the C++ CPU oracle (oracle/), and
``read_dimacs`` is the general-graph lane's entry for hand-written
graphs (``solver.solve_scheduling`` routes them to cost-scaling).

Format (1-indexed nodes):
    c <comment>
    p min <n_nodes> <n_arcs>
    n <node_id> <supply>          (only nonzero supplies listed)
    a <src> <dst> <low> <cap> <cost>
"""

from __future__ import annotations

import io

import numpy as np

from poseidon_tpu_torch.graph.network import FlowNetwork


def write_dimacs(net: FlowNetwork) -> str:
    h = net.to_host()
    return write_dimacs_host(
        h["src"], h["dst"], h["cap"], h["cost"], h["supply"],
        net.n_nodes, net.n_arcs,
    )


def write_dimacs_host(
    src, dst, cap, cost, supply, n_nodes: int, n_arcs: int
) -> str:
    """Render a DIMACS min-cost instance from host arrays."""
    out = io.StringIO()
    out.write(f"p min {n_nodes} {n_arcs}\n")
    supply = np.asarray(supply)
    for v in np.flatnonzero(supply):
        out.write(f"n {v + 1} {int(supply[v])}\n")
    for a in range(n_arcs):
        out.write(
            f"a {int(src[a]) + 1} {int(dst[a]) + 1} 0 "
            f"{int(cap[a])} {int(cost[a])}\n"
        )
    return out.getvalue()


def read_dimacs(text: str) -> FlowNetwork:
    """Parse a DIMACS min-cost instance into a padded ``FlowNetwork``."""
    n_nodes = n_arcs = -1
    supply: np.ndarray | None = None
    src: list[int] = []
    dst: list[int] = []
    cap: list[int] = []
    cost: list[int] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("c"):
            continue
        parts = line.split()
        if parts[0] == "p":
            if parts[1] != "min":
                raise ValueError(f"not a min-cost problem line: {line!r}")
            n_nodes, n_arcs = int(parts[2]), int(parts[3])
            supply = np.zeros(n_nodes, dtype=np.int64)
        elif parts[0] == "n":
            if supply is None:
                raise ValueError("n line before p line")
            v = int(parts[1])
            if not 1 <= v <= n_nodes:
                # without this, node id 0 would alias supply[-1] silently
                raise ValueError(f"node id {v} out of range 1..{n_nodes}")
            supply[v - 1] = int(parts[2])
        elif parts[0] == "a":
            if int(parts[3]) != 0:
                raise ValueError("nonzero lower bounds unsupported")
            src.append(int(parts[1]) - 1)
            dst.append(int(parts[2]) - 1)
            cap.append(int(parts[4]))
            cost.append(int(parts[5]))
    if supply is None:
        raise ValueError("missing p line")
    if len(src) != n_arcs:
        raise ValueError(f"expected {n_arcs} arcs, got {len(src)}")
    return FlowNetwork.from_arrays(src, dst, cap, cost, supply)


def parse_flow_output(text: str, n_arcs: int) -> tuple[int, np.ndarray]:
    """Parse DIMACS solution lines: ``s <cost>`` + ``f <src> <dst> <flow>``.

    The C++ oracle prints exactly one ``f`` line per input arc, in input
    order (including zero flows), so the k-th ``f`` line is the flow on
    arc k. Returns (total_cost, int64[n_arcs] flows).
    """
    total: int | None = None
    flows = np.zeros(n_arcs, dtype=np.int64)
    k = 0
    for raw in text.splitlines():
        parts = raw.split()
        if not parts:
            continue
        if parts[0] == "s":
            total = int(parts[1])
        elif parts[0] == "f":
            if k >= n_arcs:
                raise ValueError("more f lines than arcs")
            flows[k] = int(parts[3])
            k += 1
    if total is None:
        raise ValueError("no 's' (solution cost) line in solver output")
    if k not in (0, n_arcs):
        raise ValueError(f"expected 0 or {n_arcs} f lines, got {k}")
    return total, flows
