"""Successive-shortest-paths MCMF on PyTorch tensors.

A port of ``poseidon_tpu/ops/ssp.py`` that returns the same flows, routed
units and path count, bit for bit:

* shortest paths by parallel Bellman-Ford over the residual arcs with
  potentials (reduced costs stay non-negative), one round a launch of the
  hand kernel K10 ``bf_relax`` (``in``: the min over a node's residual
  in-arcs, with the lowest-id predecessor, rewritten only on strict
  improvement);
* the walk T -> S along the predecessors and the augment, one launch of
  K11 ``ssp_augment``;
* the potential update, torch.

Both kernels read the residual CSR of ``ops/cost_scaling.py`` (built once
per solve). Exactness: all arithmetic is int32; ``solve_ssp`` refuses a
network whose ``max|cost| * 3 * (n_nodes + 3)`` reaches 2**30 (INF).

Internal super-source/sink framing: node slots [N] and [N+1] of an
(N+2)-wide node space are S and T; one S-arc and one T-arc per node slot
carries max(+-supply, 0).

Control flow: the reference's two nested ``while_loop``s are host loops
with one counted read a relaxation round (its ``changed`` flag) and one
a path (``routed`` and ``delta``); the flows come back in one fetch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import FlowNetwork, total_supply
from poseidon_tpu_torch.guards import GuardError, SyncCounter
from poseidon_tpu_torch.kernels.bf_relax import INF, bf_relax_in
from poseidon_tpu_torch.kernels.ssp_augment import ssp_augment
from poseidon_tpu_torch.ops.cost_scaling import ResidualCSR, residual_csr

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SolveResult:
    flows: np.ndarray       # int32[E] flow per input arc slot
    routed: int             # units actually routed
    wanted: int             # total positive supply
    iterations: int         # augmenting-path count
    loop_syncs: int = 0     # the loops' counted device->host reads
    fetches: int = 0        # result fetches (one a solve)

    @property
    def feasible(self) -> bool:
        return self.routed == self.wanted


def _residual_tables(net: FlowNetwork):
    """Forward arc tables for the S/T-augmented graph (host numpy).

    Forward arc slots: [0, E) input arcs, [E, E+N) S->v arcs,
    [E+N, E+2N) v->T arcs. Residual slots: [0, F) forward, [F, 2F)
    backward (endpoints swapped, cost negated).
    """
    N = net.num_node_slots
    S, T = N, N + 1
    node_ids = np.arange(N, dtype=np.int32)
    supply = np.asarray(net.supply, np.int32)
    fsrc = np.concatenate([net.src, np.full(N, S, np.int32), node_ids])
    fdst = np.concatenate([net.dst, node_ids, np.full(N, T, np.int32)])
    fcap = np.concatenate([net.cap, np.maximum(supply, 0),
                           np.maximum(-supply, 0)])
    fcost = np.concatenate([net.cost, np.zeros(2 * N, np.int32)])
    return (fsrc.astype(np.int32), fdst.astype(np.int32),
            fcap.astype(np.int32), fcost.astype(np.int32), S, T)


def mirror_costs(g: ResidualCSR, pot: torch.Tensor,
                 flow: torch.Tensor) -> torch.Tensor:
    """K10 ``in``'s per-position input: position p stands for the mirror m
    of ``arc[p]``, an in-arc of p's tail with tail ``head[p]`` and cost
    ``-cost[p]``; its reduced cost under ``pot``, or INF where m has no
    capacity left (the reference's ``rc`` and ``cap_ok``)."""
    F = g.fcap.shape[0]
    fwd = g.arc < F
    slot = torch.where(fwd, g.arc, g.arc - F).long()
    mrc = -g.cost + pot[g.head.long()] - pot[g.tail]
    cap_m = torch.where(fwd, flow[slot], g.fcap[slot] - flow[slot])
    return torch.where(cap_m > 0, mrc, INF).contiguous()


def _solve(net: FlowNetwork, max_paths: int, device) -> SolveResult:
    fsrc, fdst, fcap, fcost, S, T = _residual_tables(net)
    F = fsrc.shape[0]
    NN = net.num_node_slots + 2  # node space incl. S, T
    g = residual_csr(fsrc, fdst, fcap,
                     np.concatenate([fcost, -fcost]), NN, device)
    fsrc_d = torch.as_tensor(fsrc, device=device)
    fdst_d = torch.as_tensor(fdst, device=device)
    wanted = total_supply(net)
    NO_PRED = 2 * F
    syncs = SyncCounter()
    changed = torch.zeros(1, dtype=I32, device=device)
    dist2 = torch.empty(NN, dtype=I32, device=device)
    state = torch.zeros(2, dtype=I32, device=device)   # routed, delta

    def bellman_ford(pot, flow):
        """Parallel Bellman-Ford with in-round predecessor tracking;
        predecessors are rewritten only on strict improvement, so the
        parent graph stays acyclic and the walk terminates."""
        nonlocal dist2
        mrc = mirror_costs(g, pot, flow)
        dist = torch.full((NN,), INF, dtype=I32, device=device)
        dist[S] = 0
        pred = torch.full((NN,), NO_PRED, dtype=I32, device=device)
        more, it = True, 0
        while more and it < NN:
            bf_relax_in(g.seg, g.arc, g.head, mrc, dist, dist2, pred, changed)
            dist, dist2 = dist2, dist
            it += 1
            more = bool(syncs.read(changed)[0])
        return dist, pred

    flow = torch.zeros(F, dtype=I32, device=device)
    pot = torch.zeros(NN, dtype=I32, device=device)
    routed, paths, done = 0, 0, False
    while routed < wanted and not done and paths < max_paths:
        dist, pred = bellman_ford(pot, flow)
        ssp_augment(pred, dist, fsrc_d, fdst_d, g.fcap, flow, state,
                    wanted, S, T)
        pot = pot + torch.where(dist < INF, dist, 0)
        routed, delta = (int(x) for x in syncs.read(state))
        paths += 1
        # a zero-unit round means no augmenting path exists: stop
        done = delta == 0
    fetch = SyncCounter()
    flows = fetch.read(flow)[: net.num_arc_slots].copy()
    return SolveResult(flows=flows, routed=routed, wanted=wanted,
                       iterations=paths, loop_syncs=syncs.count,
                       fetches=fetch.count)


def check_cost_bound(net: FlowNetwork) -> None:
    """Worst finite intermediate: cand = dist + rc where dist <= maxc*NN,
    |rc| <= maxc*(2*NN + 1) (cost plus two potentials), so the sum must
    stay under INF = 2**30 for the masked int32 arithmetic to be exact."""
    maxc = int(np.abs(np.asarray(net.cost)).max()) if net.num_arc_slots else 0
    if maxc * 3 * (net.num_node_slots + 3) >= 2**30:
        raise GuardError(
            f"cost magnitude {maxc} too large for exact int32 SSP on "
            f"{net.num_node_slots} node slots"
        )


def solve_ssp(net: FlowNetwork, *, max_paths: int | None = None,
              device=None) -> SolveResult:
    """Solve ``net`` exactly via successive shortest paths on ``device``
    (``None``: the card; ``"cpu"`` runs the kernels' plain twins).

    ``max_paths`` bounds augmentations (default: total supply + 1; each
    successful augmentation routes >= 1 unit). A stalled instance (routed
    < wanted on return) means the remaining supplies are infeasible.
    """
    from poseidon_tpu_torch.ops.resident import on_device, resolve_device

    dev = resolve_device(device)
    check_cost_bound(net)
    if max_paths is None:
        max_paths = total_supply(net) + 1
    with on_device(dev):
        return _solve(net, max_paths, dev)


def solution_cost(net: FlowNetwork, result: SolveResult) -> int:
    """Exact int64 cost of a solve, computed host-side."""
    f = np.asarray(result.flows).astype(np.int64)
    c = np.asarray(net.cost).astype(np.int64)
    return int((f * c).sum())
