"""Successive-shortest-paths MCMF on PyTorch tensors.

A port of ``poseidon_tpu/ops/ssp.py`` that returns the same flows, routed
units and path count, bit for bit:

* shortest paths by parallel Bellman-Ford over the residual arcs with
  potentials (reduced costs stay non-negative), one round a launch of the
  hand kernel K10 ``bf_relax`` (``in``: the min over a node's residual
  in-arcs, with the lowest-id predecessor, rewritten only on strict
  improvement);
* everything between two relaxation loops, one library call of K11
  ``ssp_augment`` a path: the walk T -> S along the predecessors, the
  augment, the potential update, the next loop's mirror costs and its
  dist0/pred0 (the first path's call is the prologue: the mirror costs
  and dist0/pred0 only).

Both kernels read the residual CSR of ``ops/cost_scaling.py`` (built once
per solve); K11's tensors are checked once per solve, when its
``PathStep`` is made. Exactness: all arithmetic is int32; ``solve_ssp``
refuses a network whose ``max|cost| * 3 * (n_nodes + 3)`` reaches 2**30
(INF).

Internal super-source/sink framing: node slots [N] and [N+1] of an
(N+2)-wide node space are S and T; one S-arc and one T-arc per node slot
carries max(+-supply, 0).

Control flow. The reference runs the path loop (ssp.py:165) around its
Bellman-Ford (:120) as nested ``while_loop``s on the device, and so
does the port on the card: the loops' state lives on the device (routed
and delta in the step's ``state``, the path and round counts,
``changed``, and the parity words of the dist and pot pairs, which K10
``in`` and K11 read there) and ``_Solve``'s three bodies, ``prologue``
(K11 ``first``), ``round`` (K10 ``in``) and ``step`` (K11), update it.
On a CUDA device they are captured into one CUDA graph a solve
(``GRAPH``: ``IF first { prologue }; WHILE path { WHILE bf { round };
step }``, K14 ``loop_ctl`` setting each node on the device: ``routed <
wanted & !done & paths < max_paths`` before a path, ``changed & it <
NN`` after a round), launched once; the host reads nothing until the
result fetch. On the CPU (or with ``_host_loop``) the same bodies run
under the host loop, with one counted read a relaxation round (its
``changed`` flag) and one a path (``routed`` and ``delta``). The flows,
routed and the path count come back in one fetch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import FlowNetwork, total_supply
from poseidon_tpu_torch.guards import GuardError, SyncCounter
from poseidon_tpu_torch.kernels.bf_relax import bf_relax_in
from poseidon_tpu_torch.kernels.loop_graph import (
    LOOP, CaptureLog, Cond, Seq, Step, run_once, runs_graph,
)
from poseidon_tpu_torch.kernels.ssp_augment import PathStep, ssp_augment
from poseidon_tpu_torch.ops.cost_scaling import residual_csr

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


# the solve's int32 counters on the device (``_Solve.ctr``): the parity
# words of the dist and pot pairs (K10 ``in`` and K11 read their low
# bits), the path count, the relaxation rounds of the current path
D, P, PATHS, IT = range(4)
# the limits K14 reads (``_Solve.limits``)
WANTED, MAX_PATHS, NN_ = range(3)
# K14's tally slots in the solve's graph: launches, the first path's
# entry, the further paths, relaxation rounds
T_LAUNCH, T_FIRST, T_PATH, T_ROUND = range(4)

# the reference's path loop (ssp.py:165) around its Bellman-Ford (:120)
# as one graph; the path loop's ``!done`` is ``0 < delta`` (the step's
# delta, never negative), and before the first path ``done`` is False
GRAPH = Seq((T_LAUNCH,), (
    Step(LOOP, sets=("first", "path"), go=T_FIRST, run=T_LAUNCH,
         terms=(("routed", "wanted"), ("paths", "max_paths"))),
    Cond("if", "first", Seq((T_FIRST,), ("prologue",))),
    Cond("while", "path", Seq((T_FIRST, T_PATH), (
        Step(LOOP, sets=("bf",), terms=(("it", "nn"),), go=T_ROUND),
        Cond("while", "bf", Seq((T_ROUND,), (
            "round",
            Step(LOOP, sets=("bf",), go=T_ROUND,
                 terms=((None, "changed"), ("it", "nn"))),
        ))),
        "step",
        Step(LOOP, sets=("path",), go=T_PATH,
             terms=(("routed", "wanted"), (None, "delta"),
                    ("paths", "max_paths"))),
    ))),
))
CAPTURES = CaptureLog()      # (NN, 2F, capture_ms, solve_ms) per graph solve


class _Solve:
    """One solve's device state and the reference's loop bodies over it:
    the path step's state (``PathStep``, its parity words on the device),
    ``ctr`` (the parities, paths, rounds), ``changed`` and the limits
    wanted, max_paths and NN. On the card the loops run as one graph
    (``GRAPH``); on the CPU, or with ``host_loop``, the host loop runs the
    same bodies and reads the flags."""

    def __init__(self, net: FlowNetwork, max_paths: int, device):
        fsrc, fdst, fcap, fcost, S, T = _residual_tables(net)
        self.NN = NN = net.num_node_slots + 2  # node space incl. S, T
        self.E = net.num_arc_slots
        self.device = device
        self.g = residual_csr(fsrc, fdst, fcap,
                              np.concatenate([fcost, -fcost]), NN, device)
        self.wanted = total_supply(net)
        self.max_paths = max_paths
        self.syncs = SyncCounter()
        self.changed = torch.zeros(1, dtype=I32, device=device)
        self.ctr = torch.zeros(4, dtype=I32, device=device)
        self.limits = torch.empty(3, dtype=I32, device=device)
        for i, v in ((WANTED, self.wanted), (MAX_PATHS, max_paths),
                     (NN_, NN)):
            self.limits[i:i + 1].fill_(min(v, 2**31 - 1))
        g = self.g
        self.step = PathStep(g.arc, g.head, g.plan.tail, g.cost, g.fcap,
                             torch.as_tensor(fsrc, device=device),
                             torch.as_tensor(fdst, device=device), NN,
                             self.wanted, S, T, parity=self.ctr[D:P + 1])

    # ---- the bodies (the graph's nodes, the host loop's steps) ----------

    def prologue(self) -> None:
        """The first path's set-up (K11 ``first``): the mirror costs and
        dist0/pred0; the parities advance."""
        ssp_augment(self.step, first=True)
        self.ctr[D:P + 1].add_(1)

    def round(self) -> None:
        """One Bellman-Ford round (K10 ``in``) with in-round predecessor
        tracking from the step's dist0/pred0 over its mirror costs;
        predecessors are rewritten only on strict improvement, so the
        parent graph stays acyclic and the walk terminates. The dist
        parity and the round count advance."""
        g, st = self.g, self.step
        bf_relax_in(g.seg, g.arc, g.head, st.mrc, st.dist[0], st.dist[1],
                    st.pred, self.changed, g.plan, parity=self.ctr[D:D + 1])
        self.ctr[D:IT + 1:IT - D].add_(1)

    def path_step(self) -> None:
        """The path's walk and augment and the next round's set-up (K11):
        the parities and the path count advance, the round count
        restarts."""
        ssp_augment(self.step)
        self.ctr[D:PATHS + 1].add_(1)
        self.ctr[IT].zero_()

    def bodies(self) -> dict:
        return {"prologue": self.prologue, "round": self.round,
                "step": self.path_step}

    # ---- the loops --------------------------------------------------------

    def host_loop(self) -> None:
        """The loops on the host over the same bodies: one read of
        ``changed`` a relaxation round and one of (routed, delta) a path;
        the path and round counts are known on the host."""
        routed, paths, done = 0, 0, False
        while routed < self.wanted and not done and paths < self.max_paths:
            if paths == 0:
                self.prologue()
            more, it = True, 0
            while more and it < self.NN:
                self.round()
                it += 1
                more = bool(self.syncs.read(self.changed)[0])
            self.path_step()
            routed, delta = (int(x) for x in self.syncs.read(self.step.state))
            paths += 1
            # a zero-unit round means no augmenting path exists: stop
            done = delta == 0

    def _result(self) -> torch.Tensor:
        """The flows, routed and the path count in one tensor: the one
        fetch."""
        st = self.step
        return torch.cat([st.flow, st.state[0:1], self.ctr[PATHS:PATHS + 1]])

    def _fetch(self, fetches: SyncCounter):
        """The solve's one result read."""
        return fetches.read(self._result())

    def run(self, host_loop: bool = False) -> SolveResult:
        fetches = SyncCounter()
        if runs_graph(self.device) and not host_loop:
            st = self.step
            tensors = {"routed": st.state[0], "delta": st.state[1],
                       "paths": self.ctr[PATHS], "it": self.ctr[IT],
                       "changed": self.changed,
                       "wanted": self.limits[WANTED],
                       "max_paths": self.limits[MAX_PATHS],
                       "nn": self.limits[NN_]}
            out, cap_ms, solve_ms = run_once(
                self.device, GRAPH, self.bodies(), tensors,
                lambda: self._fetch(fetches), "the SSP loop")
            CAPTURES.add((self.NN, 2 * self.step.F, cap_ms, solve_ms))
        else:
            self.host_loop()
            out = self._fetch(fetches)
        return SolveResult(flows=out[: self.E].copy(), routed=int(out[-2]),
                           wanted=self.wanted, iterations=int(out[-1]),
                           loop_syncs=self.syncs.count,
                           fetches=fetches.count)


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
              device=None, _host_loop: bool = False) -> SolveResult:
    """Solve ``net`` exactly via successive shortest paths on ``device``
    (``None``: the card, one graph a solve; ``"cpu"`` runs the kernels'
    plain twins under the host loop).

    ``max_paths`` bounds augmentations (default: total supply + 1; each
    successful augmentation routes >= 1 unit). A stalled instance (routed
    < wanted on return) means the remaining supplies are infeasible.
    The private ``_host_loop`` runs the host loop on the card too: the
    plain version ``chip_smoke.py`` [general] holds the graph against; no
    caller in the package passes it.
    """
    from poseidon_tpu_torch.ops.resident import on_device, resolve_device

    dev = resolve_device(device)
    check_cost_bound(net)
    if max_paths is None:
        max_paths = total_supply(net) + 1
    with on_device(dev):
        return _Solve(net, max_paths, dev).run(_host_loop)


def solution_cost(net: FlowNetwork, result: SolveResult) -> int:
    """Exact int64 cost of a solve, computed host-side."""
    f = np.asarray(result.flows).astype(np.int64)
    c = np.asarray(net.cost).astype(np.int64)
    return int((f * c).sum())
