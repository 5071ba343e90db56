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
2F residual arcs stably sorted by tail, ``residual_csr``, with the
kernels' launch plan made on the host from its degrees): a discharge
sweep is the hand kernel K9 ``cs_sweep`` and a Bellman-Ford round is K10
``bf_relax`` (``out``); the saturation, the arc lengths and the price
shift are torch. On the CPU the same wrappers run their plain twins.

Control flow. The reference runs the phase, refine and Bellman-Ford
loops as nested ``while_loop``s on the device (cost_scaling.py:283,
:258, :212), and so does the port on the card. The loops' state lives on
the device (eps, sweeps, phases, ok, done, the Bellman-Ford round count,
``changed``, any(excess > 0)) and ``_Solve``'s six bodies update it in
fixed buffers: ``enter`` (the saturation), ``bf_init`` (arc lengths and
d0), ``bf_burst`` (8 K10 rounds), ``update`` (the branchless price
shift), ``sweep_burst`` (16 K9 sweeps, K9 reading eps on the device) and
``exit`` (ok, done, the next eps, phases). On a CUDA device they are
captured into one CUDA graph a solve (``GRAPH``:
``WHILE phase { enter; WHILE refine { bf_init; WHILE bf { bf_burst };
update; sweep_burst }; exit }``, each WHILE set by K14 ``loop_ctl`` on
the device at the reference's checks: ``!done`` after a phase,
``any(excess > 0) & sweeps < max_sweeps`` before a burst, ``changed &
it < NN`` after 8 rounds), launched once; the host reads nothing until
the result fetch. On the CPU (or with ``_host_loop``) the same bodies run
under the host loop, whose reads go through a ``SyncCounter``:

- the eps ladder (``eps0 = BIG * NN``, then ``max(1, eps // alpha)``
  until the eps = 1 phase) is known on the host from the costs;
- a refine burst starts after one read of ``any(excess > 0)``
  (``sweeps < max_sweeps`` is known on the host), and its 16 sweeps are
  launched blind (converged sweeps are no-ops, and count, as in the
  reference);
- a global update reads its ``changed`` flag once per burst of 8 rounds
  and applies the shift only when Bellman-Ford converged.

The result reports those reads as ``loop_syncs`` (0 on the card), and
the flows, sweeps, phases and ok come back in one fetch (``fetches``).
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
from poseidon_tpu_torch.kernels.csr_plan import CsrPlan, make_plan
from poseidon_tpu_torch.kernels.loop_graph import (
    LOOP, CaptureLog, Cond, Seq, Step, run_once, runs_graph,
)

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
    ``[seg[v], seg[v + 1])``, in ascending arc id. ``plan`` is K9's and
    K10's launch plan over it."""

    seg: torch.Tensor    # int32[NN + 1]
    arc: torch.Tensor    # int32[2F] residual arc id of each position
    head: torch.Tensor   # int32[2F]
    tail: torch.Tensor   # int64[2F] (for torch gathers)
    cost: torch.Tensor   # [2F] residual cost, the caller's dtype
    fcap: torch.Tensor   # int32[F] forward capacities
    plan: CsrPlan


def residual_csr(fsrc: np.ndarray, fdst: np.ndarray, fcap: np.ndarray,
                 rcost: np.ndarray, NN: int, device) -> ResidualCSR:
    """Upload the forward tables and build the residual CSR on ``device``;
    the segment offsets and the launch plan come from the host's degree
    counts (no device read)."""
    rsrc_h = np.concatenate([fsrc, fdst]).astype(np.int64)
    seg_h = np.zeros(NN + 1, np.int64)
    seg_h[1:] = np.cumsum(np.bincount(rsrc_h, minlength=NN))
    rsrc = torch.as_tensor(rsrc_h, device=device)
    rdst = torch.as_tensor(np.concatenate([fdst, fsrc]).astype(np.int32),
                           device=device)
    order = torch.argsort(rsrc, stable=True)
    return ResidualCSR(
        seg=torch.as_tensor(seg_h.astype(np.int32), device=device),
        arc=order.to(I32),
        head=rdst[order].contiguous(),
        tail=rsrc[order].contiguous(),
        cost=torch.as_tensor(rcost, device=device)[order].contiguous(),
        fcap=torch.as_tensor(np.ascontiguousarray(fcap, np.int32),
                             device=device),
        plan=make_plan(seg_h, device),
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


# the solve's int32 scalars on the device (``_Solve.st``)
SWEEPS, PHASES, OK, DONE, IT, ACTIVE = range(6)
# K14's tally slots in the solve's graph: launches, phase runs, refine
# bursts, Bellman-Ford bursts
T_LAUNCH, T_PHASE, T_REFINE, T_BF = range(4)


def _refine_go(go: int) -> Step:
    """The refine loop's condition: any(excess > 0) & sweeps < max_sweeps."""
    return Step(LOOP, sets=("refine",), go=go,
                terms=((None, "active"), ("sweeps", "max_sweeps")))


# the reference's nested while_loops (cost_scaling.py:283, :258, :212) as
# one graph: each WHILE's condition set by K14 before the node and at the
# end of its body
GRAPH = Seq((T_LAUNCH,), (
    Step(LOOP, sets=("phase",), terms=(("done", None),), go=T_PHASE,
         run=T_LAUNCH),
    Cond("while", "phase", Seq((T_PHASE,), (
        "enter",
        _refine_go(T_REFINE),
        Cond("while", "refine", Seq((T_REFINE,), (
            "bf_init",
            Step(LOOP, sets=("bf",), terms=(("it", "nn"),), go=T_BF),
            Cond("while", "bf", Seq((T_BF,), (
                "bf_burst",
                Step(LOOP, sets=("bf",), go=T_BF,
                     terms=((None, "changed"), ("it", "nn"))),
            ))),
            "update",
            "sweep_burst",
            _refine_go(T_REFINE),
        ))),
        "exit",
        Step(LOOP, sets=("phase",), terms=(("done", None),), go=T_PHASE),
    ))),
))
CAPTURES = CaptureLog()      # (NN, 2F, capture_ms, solve_ms) per graph solve


class _Solve:
    """One solve's device state and the reference's loop bodies over it.

    Every quantity a loop's condition or a kernel reads lives on the
    device: eps (int64 0-d), ``st`` (sweeps, phases, ok, done, the
    Bellman-Ford round count, any(excess > 0)), ``changed``, and the
    limits max_sweeps and NN. The bodies write the solve's fixed buffers
    in place. On the card the loops run as one graph (``GRAPH``); on the
    CPU, or with ``host_loop``, the host loop runs the same bodies and
    reads the flags."""

    def __init__(self, net: FlowNetwork, device, alpha: int,
                 max_sweeps: int, sweeps_per_update: int):
        fsrc, fdst, fcap, fcost, S, T, wanted, big = _augmented_tables(net)
        self.F = F = fsrc.shape[0]
        self.NN = NN = net.num_node_slots + 2
        self.E = net.num_arc_slots
        self.device = device
        self.wanted, self.big = wanted, big
        self.eps0 = _wrap64(big * NN)
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
        self.ln = torch.empty(2 * F, dtype=I64, device=device)
        self.d = torch.empty(NN, dtype=I64, device=device)
        self._d2 = torch.empty(NN, dtype=I64, device=device)
        self.changed = torch.zeros(1, dtype=I32, device=device)
        # the solve's start: no flow, prices 0, eps0, no sweep or phase
        # yet, ok
        self.eps = torch.full((), self.eps0, dtype=I64, device=device)
        self.st = torch.zeros(8, dtype=I32, device=device)
        self.st[OK:OK + 1].fill_(1)
        self.limits = torch.empty(2, dtype=I32, device=device)
        self.limits[0:1].fill_(min(max_sweeps, 2**31 - 1))
        self.limits[1:2].fill_(NN)

    def _reduced_costs(self) -> tuple[torch.Tensor, torch.Tensor]:
        return reduced_costs(self.g, self.flow, self.price)

    def _count_active(self) -> None:
        self.st[ACTIVE].copy_((self.excess > 0).any())

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

    # ---- the bodies (the graph's nodes, the host loop's steps) ----------

    def enter(self) -> None:
        """A phase's start: the saturation, then any(excess > 0)."""
        self.saturate()
        self._count_active()

    def bf_init(self) -> None:
        """The global update's inputs: the arc lengths
        ``max(0, floor(rc / eps) + 1)`` and the deficits' distance 0."""
        self.ln.copy_(arc_lengths(self.g, self.flow, self.price, self.eps))
        self.d.copy_(torch.where(self.excess < 0, 0, INF_K))
        self.st[IT].zero_()

    def bf_burst(self) -> None:
        """``BF_BURST`` K10 rounds, the distance buffers swapped between
        them (an even count: the burst ends in ``d``)."""
        g = self.g
        d, d2 = self.d, self._d2
        for _ in range(BF_BURST):
            bf_relax_out(g.seg, g.head, self.ln, d, d2, self.changed, g.plan)
            d, d2 = d2, d
        self.st[IT].add_(BF_BURST)

    def update(self) -> None:
        """The cs2 price update: the least k per node such that lowering
        its price by k * eps opens an admissible path to a deficit,
        applied only when Bellman-Ford converged; nodes with no residual
        path to a deficit drop to k_max + 1."""
        reach = self.d < INF_K
        k_max = torch.where(reach, self.d, 0).max()
        k = torch.where(reach, self.d, k_max + 1)
        self.price.copy_(torch.where(self.changed == 0,
                                     self.price - k * self.eps, self.price))

    def sweep_burst(self) -> None:
        """``sweeps_per_update`` K9 sweeps, the buffers swapped between
        them and back in place after an odd count; then
        any(excess > 0)."""
        g = self.g
        for _ in range(self.sweeps_per_update):
            cs_sweep(g.seg, g.arc, g.head, g.cost, g.fcap, self.flow,
                     self.excess, self.price, self.eps, self._excess2,
                     self._price2, g.plan)
            self.excess, self._excess2 = self._excess2, self.excess
            self.price, self._price2 = self._price2, self.price
        if self.sweeps_per_update % 2:
            self._excess2.copy_(self.excess)
            self._price2.copy_(self.price)
            self.excess, self._excess2 = self._excess2, self.excess
            self.price, self._price2 = self._price2, self.price
        self.st[SWEEPS].add_(self.sweeps_per_update)
        self._count_active()

    def exit(self) -> None:
        """A phase's end: ok &= no excess left, done = eps == 1, eps =
        max(1, eps // alpha), phases += 1."""
        st = self.st
        st[OK].mul_(1 - st[ACTIVE])
        st[DONE].copy_(self.eps == 1)
        self.eps.copy_(torch.clamp(
            torch.div(self.eps, self.alpha, rounding_mode="floor"), min=1))
        st[PHASES].add_(1)

    def bodies(self) -> dict:
        return {"enter": self.enter, "bf_init": self.bf_init,
                "bf_burst": self.bf_burst, "update": self.update,
                "sweep_burst": self.sweep_burst, "exit": self.exit}

    # ---- the loops --------------------------------------------------------

    def host_loop(self) -> None:
        """The loops on the host over the same bodies: one read of
        any(excess > 0) before each refine burst and one of ``changed``
        after each Bellman-Ford burst; the eps ladder, the sweep count
        and the round count are known on the host."""
        eps, sweeps = self.eps0, 0
        while True:
            self.enter()
            while True:
                active = bool(self.syncs.read(self.st[ACTIVE]))
                if not active or sweeps >= self.max_sweeps:
                    break
                self.bf_init()
                it = 0
                while True:
                    self.bf_burst()
                    it += BF_BURST
                    changed = bool(self.syncs.read(self.changed)[0])
                    if not (changed and it < self.NN):
                        break
                self.update()
                self.sweep_burst()
                sweeps += self.sweeps_per_update
            self.exit()
            done = eps == 1
            eps = max(1, eps // self.alpha)
            if done:
                return

    def _result(self) -> torch.Tensor:
        """The flows, sweeps, phases and ok in one tensor: the one fetch."""
        return torch.cat([self.flow, self.st[SWEEPS:OK + 1]])

    def _fetch(self, fetches: SyncCounter):
        """The solve's one result read."""
        return fetches.read(self._result())

    def run(self, host_loop: bool = False) -> CostScalingResult:
        fetches = SyncCounter()
        if runs_graph(self.device) and not host_loop:
            tensors = {"done": self.st[DONE], "active": self.st[ACTIVE],
                       "sweeps": self.st[SWEEPS], "it": self.st[IT],
                       "changed": self.changed,
                       "max_sweeps": self.limits[0], "nn": self.limits[1]}
            out, cap_ms, solve_ms = run_once(
                self.device, GRAPH, self.bodies(), tensors,
                lambda: self._fetch(fetches),
                "the cost-scaling loop")
            CAPTURES.add((self.NN, 2 * self.F, cap_ms, solve_ms))
        else:
            self.host_loop()
            out = self._fetch(fetches)
        flow = out[: self.F]
        sweeps, phases, ok = (int(x) for x in out[self.F:])
        return CostScalingResult(
            flows=flow[: self.E].copy(),
            routed=int(flow[-1]),   # the forcing arc
            wanted=self.wanted,
            sweeps=sweeps,
            phases=phases,
            converged=bool(ok),
            loop_syncs=self.syncs.count,
            fetches=fetches.count,
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
    _host_loop: bool = False,
) -> CostScalingResult:
    """Solve ``net`` exactly via cost-scaling push-relabel on ``device``
    (``None``: the card, one graph a solve; ``"cpu"`` runs the kernels'
    plain twins under the host loop).

    ``alpha`` is the epsilon division factor per phase. ``max_sweeps`` is
    a global fuse across all phases; the default scales with problem
    size. Raises ``GuardError`` (a ``ValueError``) when capacities could
    wrap the int32 excess accumulators. The private ``_host_loop`` runs
    the host loop on the card too: the plain version ``chip_smoke.py``
    [general] holds the graph against; no caller in the package passes
    it.
    """
    from poseidon_tpu_torch.ops.resident import on_device, resolve_device

    dev = resolve_device(device)
    if max_sweeps is None:
        # generous: phases * O(per-phase sweeps), as the reference sizes it
        max_sweeps = 200 * (net.num_node_slots.bit_length() + 8) * 8
    check_excess_bound(net)
    with on_device(dev):
        return _Solve(net, dev, alpha, max_sweeps,
                      sweeps_per_update).run(_host_loop)


def solution_cost(net: FlowNetwork, result) -> int:
    """Exact int64 cost of the returned flow, computed host-side."""
    f = np.asarray(result.flows).astype(np.int64)
    c = np.asarray(net.cost).astype(np.int64)
    return int((f * c).sum())
