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
and delta in the step's ``state``; the parity words of the dist and pot
pairs, the path and round counts, ``changed`` and the go words in the
solve's loop words, ``kernels/ssp_loop.py``) and ``_Solve``'s three
bodies, ``prologue`` (K11 ``first``), ``round`` (K10 ``in``) and
``step`` (K11), are one kernel launch each. Each kernel ends its own
launch on the loop words: K10 ``in`` decides the round loop (``changed
& it < NN``) and K11 the path loop (``routed < wanted & !done & paths <
max_paths``, ``!done`` being ``0 < delta``) and arms the round loop for
the next path. On a CUDA device the bodies are captured into one CUDA
graph a solve (``GRAPH``: ``IF first { prologue }; WHILE path { WHILE
bf { round }; step }``), the kernels setting the WHILE nodes from their
last blocks and K14 ``loop_ctl`` only the entry; the host reads nothing
until the result fetch. On the CPU (or with ``_host_loop``) the same
bodies run under the host loop, which reads the go word the kernel wrote:
one counted read a relaxation round and one a path. The flows, routed
and the path count come back in one fetch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poseidon_tpu_torch.graph.network import FlowNetwork, total_supply
from poseidon_tpu_torch.guards import GuardError, SyncCounter
from poseidon_tpu_torch.kernels.bf_relax import bf_relax_in
from poseidon_tpu_torch.kernels.loop_graph import (
    LOOP, Body, CaptureLog, Cond, Seq, Step, run_once, runs_graph,
)
from poseidon_tpu_torch.kernels.ssp_augment import PathStep, ssp_augment
from poseidon_tpu_torch.kernels.ssp_loop import (
    GO_BF, GO_PATH, PATHS, T_FIRST, T_LAUNCH, T_PATH, T_ROUND, SspLoop,
)
from poseidon_tpu_torch.ops.cost_scaling import residual_csr


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


# the reference's path loop (ssp.py:165) around its Bellman-Ford (:120)
# as one graph. K14 decides the entry (before the first path ``done`` is
# False); K11's step decides the path loop (its ``!done`` is ``0 <
# delta``, the step's delta, never negative) and arms the round loop
# for the next path, which the prologue arms for the first; K10 ``in``
# decides the round loop after each round
GRAPH = Seq((T_LAUNCH,), (
    Step(LOOP, sets=("first", "path"), go=T_FIRST, run=T_LAUNCH,
         terms=(("routed", "wanted"), ("paths", "max_paths"))),
    Cond("if", "first", Seq((T_FIRST,), (
        Body("prologue", sets=(("bf", "go_bf"),)),))),
    Cond("while", "path", Seq((T_FIRST, T_PATH), (
        Cond("while", "bf", Seq((T_ROUND,), (
            Body("round", sets=(("bf", "go_bf"),)),))),
        Body("step", sets=(("path", "go_path"), ("bf", "go_bf"))),
    ))),
))
CAPTURES = CaptureLog()      # (NN, 2F, capture_ms, solve_ms) per graph solve


class _Solve:
    """One solve's device state and the reference's loop bodies over it:
    the path step's state (``PathStep``) and the loop words (``loop``:
    the parities, the path and round counts, ``changed``, the go words,
    the limits wanted, max_paths and NN, the graph's tally). On the card
    the loops run as one graph (``GRAPH``); on the CPU, or with
    ``host_loop``, the host loop runs the same bodies and reads the go
    words."""

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
        self.loop = SspLoop(device, self.wanted, max_paths, NN)
        g = self.g
        self.step = PathStep(g.arc, g.head, g.plan.tail, g.cost, g.fcap,
                             torch.as_tensor(fsrc, device=device),
                             torch.as_tensor(fdst, device=device), NN,
                             self.wanted, S, T, self.loop)

    # ---- the bodies (the graph's nodes, the host loop's steps) ----------

    def prologue(self) -> None:
        """The first path's set-up (K11 ``first``): the mirror costs and
        dist0/pred0; the parities advance and the round loop is armed."""
        ssp_augment(self.step, first=True)

    def round(self) -> None:
        """One Bellman-Ford round (K10 ``in``) with in-round predecessor
        tracking from the step's dist0/pred0 over its mirror costs;
        predecessors are rewritten only on strict improvement, so the
        parent graph stays acyclic and the walk terminates. The round's
        end advances the dist parity and the round count and decides the
        round loop."""
        g, st = self.g, self.step
        bf_relax_in(g.seg, g.arc, g.head, st.mrc, st.dist[0], st.dist[1],
                    st.pred, g.plan, self.loop)

    def path_step(self) -> None:
        """The path's walk and augment and the next round's set-up (K11);
        its end advances the parities and the path count, restarts the
        round count, decides the path loop and arms the round loop."""
        ssp_augment(self.step)

    def bodies(self) -> dict:
        return {"prologue": self.prologue, "round": self.round,
                "step": self.path_step}

    # ---- the loops --------------------------------------------------------

    def host_loop(self) -> None:
        """The loops on the host over the same bodies, as the graph runs
        them: the entry from the host's wanted and max_paths, then one
        read of the round loop's go word a relaxation round and one of
        both go words a path."""
        w = self.loop.words
        if not (0 < self.wanted and 0 < self.max_paths):
            return
        self.prologue()
        go_path, go_bf = True, 0 < self.NN
        while go_path:
            while go_bf:
                self.round()
                go_bf = bool(self.syncs.read(w[GO_BF:GO_BF + 1])[0])
            self.path_step()
            go_bf, go_path = (bool(x) for x in self.syncs.read(
                w[GO_BF:GO_PATH + 1]))

    def _result(self) -> torch.Tensor:
        """The flows, routed and the path count in one tensor: the one
        fetch."""
        st = self.step
        return torch.cat([st.flow, st.state[0:1],
                          self.loop.words[PATHS:PATHS + 1]])

    def _fetch(self, fetches: SyncCounter):
        """The solve's one result read."""
        return fetches.read(self._result())

    def run(self, host_loop: bool = False) -> SolveResult:
        fetches = SyncCounter()
        if runs_graph(self.device) and not host_loop:
            st, L = self.step, self.loop
            tensors = {"routed": st.state[0], "delta": st.state[1],
                       "paths": L.words[PATHS], "go_bf": L.words[GO_BF],
                       "go_path": L.words[GO_PATH],
                       "wanted": L.limits[0], "max_paths": L.limits[1]}
            out, cap_ms, solve_ms = run_once(
                self.device, GRAPH, self.bodies(), tensors,
                lambda: self._fetch(fetches), "the SSP loop", L.tally,
                L.arm)
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
