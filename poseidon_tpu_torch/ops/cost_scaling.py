"""Cost-scaling push-relabel MCMF over a residual CSR, on PyTorch tensors.

The general-graph lane's exact solver: a port of
``poseidon_tpu/ops/cost_scaling.py`` (the device-side analog of
Goldberg's cs2) that returns the same flows, sweep and phase counts and
convergence flag, bit for bit.

Algorithm (the reference's): epsilon-scaling on the min-cost circulation
made by adding a T->S forcing arc of cost -BIG. Each refine(eps) phase
saturates every residual arc of negative reduced cost, then runs bursts
of ``sweeps_per_update`` discharge sweeps, each burst after a global
price update (a multi-source Bellman-Ford from the deficit nodes in arc
lengths ``max(0, floor(rc / eps) + 1)``), until no node holds excess.

The per-arc passes run over one residual CSR built once per solve (the
2F residual arcs stably sorted by tail, ``residual_csr``): a discharge
sweep is the hand kernel K9 ``cs_sweep`` and a Bellman-Ford round is K10
``bf_relax`` (``out``); the saturation, the arc lengths and the price
shift are torch. On the CPU the same wrappers run their plain twins.

Control flow. The reference runs the phase, refine and Bellman-Ford
loops as nested ``while_loop``s on the device. Here they are host loops:

- the eps ladder (``eps0 = BIG * NN``, then ``max(1, eps // alpha)``
  until the eps = 1 phase) is known on the host from the costs;
- a refine burst starts after one read of ``any(excess > 0)``
  (``sweeps < max_sweeps`` is known on the host), and its 16 sweeps are
  launched blind (converged sweeps are no-ops, and count, as in the
  reference);
- a global update reads its ``changed`` flag once per burst of 8 rounds
  and applies the shift only when Bellman-Ford converged.

Every read goes through a ``SyncCounter``: the result reports them as
``loop_syncs``, and the flows come back in one fetch (``fetches``).
Prices are int64 (the n-scaled cost domain overflows int32), flows and
excesses int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import FlowNetwork, total_supply
from poseidon_tpu_torch.guards import GuardError, SyncCounter
from poseidon_tpu_torch.kernels.bf_relax import INF_K, bf_relax_out
from poseidon_tpu_torch.kernels.cs_sweep import cs_sweep, residual

I32 = torch.int32
I64 = torch.int64
BF_BURST = 8


@dataclasses.dataclass(frozen=True)
class CostScalingResult:
    flows: np.ndarray      # int32[E] flow per input arc slot
    routed: int            # units through the forcing arc
    wanted: int            # total positive supply
    sweeps: int            # total discharge sweeps executed
    phases: int            # epsilon phases executed
    converged: bool        # every refine drained all excess
    loop_syncs: int = 0    # the loops' counted device->host reads
    fetches: int = 0       # result fetches (one a solve)

    @property
    def feasible(self) -> bool:
        return self.routed == self.wanted


@dataclasses.dataclass(frozen=True)
class ResidualCSR:
    """The 2F residual arcs (a < F forward arc a, a >= F the mirror of
    a - F) stably sorted by tail: node v's out-arcs are positions
    ``[seg[v], seg[v + 1])``, in ascending arc id."""

    seg: torch.Tensor    # int32[NN + 1]
    arc: torch.Tensor    # int32[2F] residual arc id of each position
    head: torch.Tensor   # int32[2F]
    tail: torch.Tensor   # int64[2F] (for torch gathers)
    cost: torch.Tensor   # [2F] residual cost, the caller's dtype
    fcap: torch.Tensor   # int32[F] forward capacities


def residual_csr(fsrc: np.ndarray, fdst: np.ndarray, fcap: np.ndarray,
                 rcost: np.ndarray, NN: int, device) -> ResidualCSR:
    """Upload the forward tables and build the residual CSR on ``device``."""
    rsrc = torch.as_tensor(np.concatenate([fsrc, fdst]).astype(np.int64),
                           device=device)
    rdst = torch.as_tensor(np.concatenate([fdst, fsrc]).astype(np.int32),
                           device=device)
    order = torch.argsort(rsrc, stable=True)
    seg = torch.zeros(NN + 1, dtype=I64, device=device)
    seg[1:] = torch.cumsum(torch.bincount(rsrc, minlength=NN), 0)
    return ResidualCSR(
        seg=seg.to(I32),
        arc=order.to(I32),
        head=rdst[order].contiguous(),
        tail=rsrc[order].contiguous(),
        cost=torch.as_tensor(rcost, device=device)[order].contiguous(),
        fcap=torch.as_tensor(np.ascontiguousarray(fcap, np.int32),
                             device=device),
    )


def reduced_costs(g: ResidualCSR, flow: torch.Tensor,
                  price: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual capacity (int32) and reduced cost (int64) per position."""
    res = residual(g.arc, g.fcap, flow)
    return res, g.cost + price[g.tail] - price[g.head.long()]


def arc_lengths(g: ResidualCSR, flow: torch.Tensor, price: torch.Tensor,
                eps: int) -> torch.Tensor:
    """The global update's arc lengths ``max(0, floor(rc / eps) + 1)`` per
    position (floor division: rc may be negative), INF_K on arcs without
    residual capacity: K10 ``out``'s input."""
    res, rc = reduced_costs(g, flow, price)
    return torch.where(
        res > 0,
        torch.clamp(torch.div(rc, eps, rounding_mode="floor") + 1, min=0),
        INF_K,
    )


def _wrap64(x: int) -> int:
    """``x`` as the int64 the reference's arithmetic would hold."""
    return (x + 2**63) % 2**64 - 2**63


def _augmented_tables(net: FlowNetwork):
    """Forward arc tables for the S/T-augmented circulation (host numpy).

    Slots: [0, E) input arcs, [E, E+N) S->v supply arcs, [E+N, E+2N)
    v->T demand arcs, [E+2N] the T->S forcing arc. Node space: [0, N)
    real slots, N = S, N+1 = T.
    """
    N = net.num_node_slots
    S, T = N, N + 1
    node_ids = np.arange(N, dtype=np.int32)
    supply = np.asarray(net.supply, np.int32)
    wanted = total_supply(net)
    # BIG dominates any simple path: (maxc + 1) * (node space + 1)
    # int32 abs, as the reference takes it
    maxc = int(np.abs(np.asarray(net.cost, np.int32)).max())
    big = _wrap64((maxc + 1) * (N + 3))
    fsrc = np.concatenate([net.src, np.full(N, S, np.int32), node_ids,
                           [T]]).astype(np.int32)
    fdst = np.concatenate([net.dst, node_ids, np.full(N, T, np.int32),
                           [S]]).astype(np.int32)
    fcap = np.concatenate([net.cap, np.maximum(supply, 0),
                           np.maximum(-supply, 0), [wanted]]).astype(np.int32)
    fcost = np.concatenate([np.asarray(net.cost, np.int64),
                            np.zeros(2 * N, np.int64), [-big]])
    return fsrc, fdst, fcap, fcost, S, T, wanted, big


class _Solve:
    """One solve's device state and loops (the reference's closures)."""

    def __init__(self, net: FlowNetwork, device, alpha: int,
                 max_sweeps: int, sweeps_per_update: int):
        fsrc, fdst, fcap, fcost, S, T, wanted, big = _augmented_tables(net)
        self.F = F = fsrc.shape[0]
        self.NN = NN = net.num_node_slots + 2
        self.E = net.num_arc_slots
        self.wanted, self.big = wanted, big
        # scaled cost domain (int64 products wrap as the reference's)
        with np.errstate(over="ignore"):
            rcost = np.concatenate([fcost, -fcost]) * np.int64(NN)
        self.g = residual_csr(fsrc, fdst, fcap, rcost, NN, device)
        self.alpha, self.max_sweeps = alpha, max_sweeps
        self.sweeps_per_update = sweeps_per_update
        self.syncs = SyncCounter()
        self.flow = torch.zeros(F, dtype=I32, device=device)
        self.price = torch.zeros(NN, dtype=I64, device=device)
        self.excess = torch.zeros(NN, dtype=I32, device=device)
        self._excess2 = torch.empty_like(self.excess)
        self._price2 = torch.empty_like(self.price)
        self._d2 = torch.empty(NN, dtype=I64, device=device)
        self._changed = torch.zeros(1, dtype=I32, device=device)
        self.sweeps = 0

    def _reduced_costs(self) -> tuple[torch.Tensor, torch.Tensor]:
        return reduced_costs(self.g, self.flow, self.price)

    def saturate(self) -> None:
        """Saturate every residual arc of negative reduced cost; the
        excesses start from the pushed amounts."""
        g, F = self.g, self.F
        res, rc = self._reduced_costs()
        amt = torch.where((res > 0) & (rc < 0), res, 0)
        fwd = g.arc < F
        slot = torch.where(fwd, g.arc, g.arc - F).long()
        self.flow.index_add_(0, slot, torch.where(fwd, amt, -amt))
        self.excess.zero_()
        self.excess.index_add_(0, g.tail, -amt)
        self.excess.index_add_(0, g.head.long(), amt)

    def global_update(self, eps: int) -> None:
        """The cs2 price update: the least k per node such that lowering
        its price by k * eps opens an admissible path to a deficit,
        applied only when Bellman-Ford converged; nodes with no residual
        path to a deficit drop to k_max + 1."""
        ln = arc_lengths(self.g, self.flow, self.price, eps)
        d = torch.where(self.excess < 0, 0, INF_K).to(I64)
        d2 = self._d2
        changed, it = True, 0
        while changed and it < self.NN:
            for _ in range(BF_BURST):
                bf_relax_out(self.g.seg, self.g.head, ln, d, d2, self._changed)
                d, d2 = d2, d
            it += BF_BURST
            changed = bool(self.syncs.read(self._changed)[0])
        self._d2 = d2
        if not changed:
            reach = d < INF_K
            k_max = torch.where(reach, d, 0).max()
            k = torch.where(reach, d, k_max + 1)
            self.price = self.price - k * eps

    def sweep_burst(self, eps: int) -> None:
        """``sweeps_per_update`` K9 sweeps, the buffers swapped between
        them."""
        g = self.g
        for _ in range(self.sweeps_per_update):
            cs_sweep(g.seg, g.arc, g.head, g.cost, g.fcap, self.flow,
                     self.excess, self.price, eps, self._excess2,
                     self._price2)
            self.excess, self._excess2 = self._excess2, self.excess
            self.price, self._price2 = self._price2, self.price
        self.sweeps += self.sweeps_per_update

    def refine(self, eps: int) -> bool:
        self.saturate()
        while True:
            active = bool(self.syncs.read((self.excess > 0).any()))
            if not active or self.sweeps >= self.max_sweeps:
                return not active
            self.global_update(eps)
            self.sweep_burst(eps)

    def run(self) -> CostScalingResult:
        eps = _wrap64(self.big * self.NN)
        phases, ok = 0, True
        while True:
            ok &= self.refine(eps)
            phases += 1
            done = eps == 1
            eps = max(1, eps // self.alpha)
            if done:
                break
        fetch = SyncCounter()
        flow = fetch.read(self.flow)
        return CostScalingResult(
            flows=flow[: self.E].copy(),
            routed=int(flow[-1]),   # the forcing arc
            wanted=self.wanted,
            sweeps=self.sweeps,
            phases=phases,
            converged=ok,
            loop_syncs=self.syncs.count,
            fetches=fetch.count,
        )


def check_excess_bound(net: FlowNetwork) -> None:
    """Excess accumulators are int32: a node's excess after the saturation
    step is bounded by its incident residual capacity (plus its supply
    arc), which must not wrap."""
    cap = np.asarray(net.cap, dtype=np.int64)
    sup = np.asarray(net.supply, dtype=np.int64)
    N = net.num_node_slots
    incident = np.zeros(N, np.int64)
    np.add.at(incident, np.asarray(net.src), cap)
    np.add.at(incident, np.asarray(net.dst), cap)
    incident += np.abs(sup)
    worst = max(int(incident.max(initial=0)), int(np.abs(sup).sum()))
    if worst >= 2**30:
        raise GuardError(
            f"per-node incident capacity {worst} can wrap the int32 "
            "excess accumulator; rescale capacities"
        )


def solve_cost_scaling(
    net: FlowNetwork,
    *,
    max_sweeps: int | None = None,
    alpha: int = 8,
    sweeps_per_update: int = 16,
    device=None,
) -> CostScalingResult:
    """Solve ``net`` exactly via cost-scaling push-relabel on ``device``
    (``None``: the card; ``"cpu"`` runs the kernels' plain twins).

    ``alpha`` is the epsilon division factor per phase. ``max_sweeps`` is
    a global fuse across all phases; the default scales with problem
    size. Raises ``GuardError`` (a ``ValueError``) when capacities could
    wrap the int32
    excess accumulators.
    """
    from poseidon_tpu_torch.ops.resident import on_device, resolve_device

    dev = resolve_device(device)
    if max_sweeps is None:
        # generous: phases * O(per-phase sweeps), as the reference sizes it
        max_sweeps = 200 * (net.num_node_slots.bit_length() + 8) * 8
    check_excess_bound(net)
    with on_device(dev):
        return _Solve(net, dev, alpha, max_sweeps, sweeps_per_update).run()


def solution_cost(net: FlowNetwork, result) -> int:
    """Exact int64 cost of the returned flow, computed host-side."""
    f = np.asarray(result.flows).astype(np.int64)
    c = np.asarray(net.cost).astype(np.int64)
    return int((f * c).sum())
