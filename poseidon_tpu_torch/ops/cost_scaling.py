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

``solve_cost_scaling_batch`` is the reference's ``_solve`` under
``jax.vmap`` over cost vectors (``tests/test_cost_scaling.py:105``): one
topology, B cost vectors, each element's flows, sweeps, phases and ok
equal to its own single solve. ``_BatchSolve`` keeps the same six bodies
over [B, ...] state, each advancing only the elements for which every
enclosing loop's condition holds (as a vmapped ``while_loop`` keeps the
carry of an element whose predicate is false); K9 and K10 take the batch
in one launch each, a mask word an element. On the card the batch is one
graph (``BATCH_GRAPH``: each WHILE while any element is in its loop).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import FlowNetwork, total_supply
from poseidon_tpu_torch.guards import GuardError, SyncCounter
from poseidon_tpu_torch.kernels.bf_relax import (
    INF_K, bf_relax_out, bf_relax_out_batch,
)
from poseidon_tpu_torch.kernels.cs_sweep import (
    cs_sweep, cs_sweep_batch, residual,
)
from poseidon_tpu_torch.kernels.csr_plan import CsrPlan, make_plan
from poseidon_tpu_torch.kernels.loop_graph import (
    LOOP, CaptureLog, Cond, Seq, Step, run_once, runs_graph,
)
from poseidon_tpu_torch.kernels.seat_sort import seat_order

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
    rsrc = torch.as_tensor(rsrc_h.astype(np.int32), device=device)
    rdst = torch.as_tensor(np.concatenate([fdst, fsrc]).astype(np.int32),
                           device=device)
    # a stable argsort by tail: K13 over (tail, arc id)
    tail, arc = seat_order(rsrc, (0, max(NN - 1, 0)))
    order = arc.long()
    return ResidualCSR(
        seg=torch.as_tensor(seg_h.astype(np.int32), device=device),
        arc=arc,
        head=rdst[order].contiguous(),
        tail=tail.long(),
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
# (NN, 2F, B, capture_ms, solve_ms) per graph solve (B = 1: a single solve)
CAPTURES = CaptureLog()


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
            CAPTURES.add((self.NN, 2 * self.F, 1, cap_ms, solve_ms))
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


@dataclasses.dataclass(frozen=True)
class CostScalingBatchResult:
    """``CostScalingResult``'s fields with a leading [B], as the vmapped
    reference's pytree has them; one ``loop_syncs`` and one ``fetches``
    for the batch."""

    flows: np.ndarray      # int32[B, E]
    routed: np.ndarray     # int32[B]
    wanted: np.ndarray     # int32[B] (the topology's: the same in each)
    sweeps: np.ndarray     # int32[B]
    phases: np.ndarray     # int32[B]
    converged: np.ndarray  # bool[B]
    loop_syncs: int = 0
    fetches: int = 0

    @property
    def feasible(self) -> np.ndarray:
        return self.routed == self.wanted

    def __getitem__(self, b: int) -> CostScalingResult:
        """Element b as a single solve's result (the batch's reads)."""
        return CostScalingResult(
            flows=self.flows[b], routed=int(self.routed[b]),
            wanted=int(self.wanted[b]), sweeps=int(self.sweeps[b]),
            phases=int(self.phases[b]), converged=bool(self.converged[b]),
            loop_syncs=self.loop_syncs, fetches=self.fetches)


# a batch's loop counts on the device (``_BatchSolve.n``): the elements
# still in the phase, refine and Bellman-Ford loops
N_PHASE, N_REFINE, N_BF = range(3)


def _any_go(go: int, sets: str, count: str) -> Step:
    """A batch loop's condition: 0 < the count of elements still in it."""
    return Step(LOOP, sets=(sets,), terms=((None, count),), go=go)


# ``GRAPH`` for a batch: the same nodes, each WHILE set while any element
# is still in its loop (the vmapped ``while_loop``s run their bodies while
# any element's predicate holds; the bodies advance only those elements)
BATCH_GRAPH = Seq((T_LAUNCH,), (
    Step(LOOP, sets=("phase",), terms=((None, "n_phase"),), go=T_PHASE,
         run=T_LAUNCH),
    Cond("while", "phase", Seq((T_PHASE,), (
        "enter",
        _any_go(T_REFINE, "refine", "n_refine"),
        Cond("while", "refine", Seq((T_REFINE,), (
            "bf_init",
            _any_go(T_BF, "bf", "n_bf"),
            Cond("while", "bf", Seq((T_BF,), (
                "bf_burst",
                _any_go(T_BF, "bf", "n_bf"),
            ))),
            "update",
            "sweep_burst",
            _any_go(T_REFINE, "refine", "n_refine"),
        ))),
        "exit",
        _any_go(T_PHASE, "phase", "n_phase"),
    ))),
))


def _phase_count(eps0: int, alpha: int) -> int:
    """The phases of a solve from ``eps0``: through the eps = 1 phase."""
    n, eps = 1, eps0
    while eps != 1:
        eps = max(1, eps // alpha)
        n += 1
    return n


class _BatchSolve:
    """A batch of solves over one topology, element b under cost vector
    ``costs[b]``: the reference's ``_solve`` under ``jax.vmap``.

    The topology, the residual CSR and its launch plan are shared; each
    element has its own scaled residual costs ([B, 2F]), BIG, eps ladder,
    flow, excess, price and scalars (``st`` [B, 8], ``changed`` [B]). As
    under ``vmap``, a loop runs its body while any element's condition
    holds, and the body advances only the elements for which every
    enclosing loop's condition holds (the others keep their carry): the
    phase loop's ``!done``, the refine loop's ``active & sweeps <
    max_sweeps`` (``go_r``), the Bellman-Ford loop's ``changed & it < NN``
    (``go_bf``). The kernels read the masks on the device; each level's
    last body writes its count of running elements (``n``), which K14's
    LOOP reads on the card and the host loop reads on the CPU."""

    def __init__(self, net: FlowNetwork, costs: np.ndarray, device,
                 alpha: int, max_sweeps: int, sweeps_per_update: int):
        self.B = B = costs.shape[0]
        per = [_augmented_tables(net.with_costs(c)) for c in costs]
        fsrc, fdst, fcap, _fcost, S, T, wanted, _big = per[0]
        self.F = F = fsrc.shape[0]
        self.NN = NN = net.num_node_slots + 2
        self.E = net.num_arc_slots
        self.device = device
        self.wanted = wanted
        self.eps0 = [_wrap64(t[7] * NN) for t in per]
        with np.errstate(over="ignore"):
            rcost = np.stack([np.concatenate([t[3], -t[3]]) for t in per]
                             ) * np.int64(NN)
        self.g = residual_csr(fsrc, fdst, fcap, rcost[0], NN, device)
        order = self.g.arc.long()
        self.cost = torch.as_tensor(rcost, device=device)[:, order].contiguous()
        self.alpha, self.max_sweeps = alpha, max_sweeps
        self.sweeps_per_update = sweeps_per_update
        self.syncs = SyncCounter()
        self.flow = torch.zeros(B, F, dtype=I32, device=device)
        self.price = torch.zeros(B, NN, dtype=I64, device=device)
        self.excess = torch.zeros(B, NN, dtype=I32, device=device)
        self._excess2 = torch.empty_like(self.excess)
        self._price2 = torch.empty_like(self.price)
        self.ln = torch.empty(B, 2 * F, dtype=I64, device=device)
        self.d = torch.empty(B, NN, dtype=I64, device=device)
        self._d2 = torch.empty_like(self.d)
        self.changed = torch.zeros(B, dtype=I32, device=device)
        self._round_changed = torch.zeros(B, dtype=I32, device=device)
        self.go_r = torch.zeros(B, dtype=I32, device=device)
        self.go_bf = torch.zeros(B, dtype=I32, device=device)
        self.eps = torch.as_tensor(np.asarray(self.eps0, np.int64),
                                   device=device)
        self.st = torch.zeros(B, 8, dtype=I32, device=device)
        self.st[:, OK].fill_(1)
        self.n = torch.zeros(4, dtype=I32, device=device)
        self.n[N_PHASE:N_PHASE + 1].fill_(B)
        self._rows = torch.arange(B, device=device)[:, None]
        g = self.g
        fwd = g.arc < F
        self._fwd = fwd
        slot = torch.where(fwd, g.arc, g.arc - F).long()
        self._slot = slot[None, :] + self._rows * F            # [B, 2F]
        self._tail = g.tail[None, :] + self._rows * NN
        self._head = g.head.long()[None, :] + self._rows * NN
        self._fcap = g.fcap[slot]

    def _reduced_costs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Residual capacity and reduced cost per element and position."""
        fl = self.flow.reshape(-1)[self._slot]
        res = torch.where(self._fwd, self._fcap - fl, fl)
        p = self.price.reshape(-1)
        return res, self.cost + p[self._tail] - p[self._head]

    def _count_refine(self) -> None:
        """go_r (still in a phase, any(excess > 0), sweeps < max_sweeps)
        and its count."""
        st = self.st
        go = ((st[:, DONE] == 0) & (st[:, ACTIVE] != 0)
              & (st[:, SWEEPS] < self.max_sweeps))
        self.go_r.copy_(go)
        self.n[N_REFINE].copy_(go.sum())

    # ---- the bodies --------------------------------------------------------

    def enter(self) -> None:
        """A phase's start for the elements still in the loop: the
        saturation, then any(excess > 0); then the refine loop's mask."""
        live = self.st[:, DONE] == 0
        res, rc = self._reduced_costs()
        amt = torch.where((res > 0) & (rc < 0) & live[:, None], res, 0)
        self.flow.reshape(-1).index_add_(
            0, self._slot.reshape(-1),
            torch.where(self._fwd, amt, -amt).reshape(-1))
        exc = torch.zeros(self.B * self.NN, dtype=I32, device=self.device)
        exc.index_add_(0, self._tail.reshape(-1), -amt.reshape(-1))
        exc.index_add_(0, self._head.reshape(-1), amt.reshape(-1))
        exc = exc.view(self.B, self.NN)
        self.excess.copy_(torch.where(live[:, None], exc, self.excess))
        self.st[:, ACTIVE].copy_(torch.where(
            live, (self.excess > 0).any(dim=1).to(I32), self.st[:, ACTIVE]))
        self._count_refine()

    def bf_init(self) -> None:
        """The global update's inputs (every element's: only go_r's are
        read) and the Bellman-Ford loop's start for go_r: it = 0,
        changed = 1."""
        res, rc = self._reduced_costs()
        self.ln.copy_(torch.where(
            res > 0,
            torch.clamp(torch.div(rc, self.eps[:, None],
                                  rounding_mode="floor") + 1, min=0),
            INF_K))
        self.d.copy_(torch.where(self.excess < 0, 0, INF_K))
        go = self.go_r != 0
        self.st[:, IT].copy_(torch.where(go, 0, self.st[:, IT]))
        self.changed.copy_(torch.where(go, 1, self.changed))
        self.go_bf.copy_(self.go_r)
        self.n[N_BF].copy_(self.n[N_REFINE])

    def bf_burst(self) -> None:
        """``BF_BURST`` K10 rounds of the go_bf elements (the others copy
        their distances), then their ``changed`` and round count, and the
        loop's next mask."""
        g = self.g
        d, d2 = self.d, self._d2
        for _ in range(BF_BURST):
            bf_relax_out_batch(g.seg, g.head, self.ln, d, d2,
                               self._round_changed, self.go_bf, g.plan)
            d, d2 = d2, d
        go = self.go_bf != 0
        self.changed.copy_(torch.where(go, self._round_changed, self.changed))
        it = self.st[:, IT]
        it.copy_(torch.where(go, it + BF_BURST, it))
        go = go & (self.changed != 0) & (it < self.NN)
        self.go_bf.copy_(go)
        self.n[N_BF].copy_(go.sum())

    def update(self) -> None:
        """The price update of the go_r elements whose Bellman-Ford
        converged (``update`` of the single solve, a row each)."""
        reach = self.d < INF_K
        k_max = torch.where(reach, self.d, 0).amax(dim=1, keepdim=True)
        k = torch.where(reach, self.d, k_max + 1)
        apply = (self.go_r != 0) & (self.changed == 0)
        self.price.copy_(torch.where(apply[:, None],
                                     self.price - k * self.eps[:, None],
                                     self.price))

    def sweep_burst(self) -> None:
        """``sweeps_per_update`` K9 sweeps of the go_r elements (the
        others keep their state), the buffers swapped as the single
        solve's; then their sweep count and any(excess > 0), and the
        refine loop's next mask."""
        g = self.g
        for _ in range(self.sweeps_per_update):
            cs_sweep_batch(g.seg, g.arc, g.head, self.cost, g.fcap,
                           self.flow, self.excess, self.price, self.eps,
                           self._excess2, self._price2, self.go_r, g.plan)
            self.excess, self._excess2 = self._excess2, self.excess
            self.price, self._price2 = self._price2, self.price
        if self.sweeps_per_update % 2:
            self._excess2.copy_(self.excess)
            self._price2.copy_(self.price)
            self.excess, self._excess2 = self._excess2, self.excess
            self.price, self._price2 = self._price2, self.price
        st, go = self.st, self.go_r != 0
        st[:, SWEEPS].add_(self.go_r * self.sweeps_per_update)
        st[:, ACTIVE].copy_(torch.where(
            go, (self.excess > 0).any(dim=1).to(I32), st[:, ACTIVE]))
        self._count_refine()

    def exit(self) -> None:
        """A phase's end for the elements still in the loop: ok &= no
        excess left, done = eps == 1, eps = max(1, eps // alpha), phases
        += 1; then the phase loop's count."""
        st = self.st
        live = st[:, DONE] == 0
        st[:, OK].copy_(torch.where(live, st[:, OK] * (1 - st[:, ACTIVE]),
                                    st[:, OK]))
        st[:, DONE].copy_(torch.where(live, (self.eps == 1).to(I32),
                                      st[:, DONE]))
        self.eps.copy_(torch.where(live, torch.clamp(
            torch.div(self.eps, self.alpha, rounding_mode="floor"), min=1),
            self.eps))
        st[:, PHASES].add_(live.to(I32))
        self.n[N_PHASE].copy_((st[:, DONE] == 0).sum())

    def bodies(self) -> dict:
        return {"enter": self.enter, "bf_init": self.bf_init,
                "bf_burst": self.bf_burst, "update": self.update,
                "sweep_burst": self.sweep_burst, "exit": self.exit}

    # ---- the loops --------------------------------------------------------

    def host_loop(self) -> None:
        """The loops on the host over the same bodies: one read of the
        refine count before each refine burst and one of the Bellman-Ford
        count after each Bellman-Ford burst; the phase loop runs as many
        phases as the longest eps ladder, which the host knows."""
        for _ in range(max(_phase_count(e, self.alpha) for e in self.eps0)):
            self.enter()
            while int(self.syncs.read(self.n[N_REFINE])):
                self.bf_init()
                while True:
                    self.bf_burst()
                    if not int(self.syncs.read(self.n[N_BF])):
                        break
                self.update()
                self.sweep_burst()
            self.exit()

    def _result(self) -> torch.Tensor:
        return torch.cat([self.flow.reshape(-1),
                          self.st[:, SWEEPS:OK + 1].reshape(-1)])

    def run(self, host_loop: bool = False) -> CostScalingBatchResult:
        fetches = SyncCounter()
        if runs_graph(self.device) and not host_loop:
            n = self.n
            tensors = {"n_phase": n[N_PHASE], "n_refine": n[N_REFINE],
                       "n_bf": n[N_BF]}
            out, cap_ms, solve_ms = run_once(
                self.device, BATCH_GRAPH, self.bodies(), tensors,
                lambda: fetches.read(self._result()),
                "the batched cost-scaling loop")
            CAPTURES.add((self.NN, 2 * self.F, self.B, cap_ms, solve_ms))
        else:
            self.host_loop()
            out = fetches.read(self._result())
        B, F = self.B, self.F
        flow = out[: B * F].reshape(B, F)
        sc = out[B * F:].reshape(B, 3)
        return CostScalingBatchResult(
            flows=flow[:, : self.E].copy(),
            routed=flow[:, -1].copy(),
            wanted=np.full(B, self.wanted, np.int32),
            sweeps=sc[:, 0].copy(),
            phases=sc[:, 1].copy(),
            converged=sc[:, 2] != 0,
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


def solve_cost_scaling_batch(
    net: FlowNetwork,
    costs,
    *,
    max_sweeps: int | None = None,
    alpha: int = 8,
    sweeps_per_update: int = 16,
    device=None,
    _host_loop: bool = False,
) -> CostScalingBatchResult:
    """Solve ``net``'s topology under each row of ``costs`` (a host
    int[B, E], one cost vector an element): the counterpart of ``jax.vmap(lambda c:
    _solve(net.with_costs(c), max_sweeps, alpha))``. Element b's flows,
    routed, sweeps, phases and converged equal ``solve_cost_scaling(
    net.with_costs(costs[b]))``'s. On the card the batch is one CUDA
    graph (``BATCH_GRAPH``: no loop read, one fetch), each K9 sweep and
    K10 round one launch for all B elements; on the CPU (or with the
    private ``_host_loop``) the host loop runs the same bodies. The
    arguments are ``solve_cost_scaling``'s."""
    from poseidon_tpu_torch.ops.resident import on_device, resolve_device

    costs = np.asarray(costs)
    if costs.ndim != 2 or costs.shape[0] < 1 \
            or costs.shape[1] != net.num_arc_slots:
        raise ValueError(f"solve_cost_scaling_batch: costs of shape "
                         f"{costs.shape}, expected [B >= 1, "
                         f"{net.num_arc_slots}]")
    dev = resolve_device(device)
    if max_sweeps is None:
        max_sweeps = 200 * (net.num_node_slots.bit_length() + 8) * 8
    check_excess_bound(net)
    with on_device(dev):
        return _BatchSolve(net, costs, dev, alpha, max_sweeps,
                           sweeps_per_update).run(_host_loop)


def solution_cost(net: FlowNetwork, result) -> int:
    """Exact int64 cost of the returned flow, computed host-side."""
    f = np.asarray(result.flows).astype(np.int64)
    c = np.asarray(net.cost).astype(np.int64)
    return int((f * c).sum())
