"""K11 ``ssp_augment``: one path step of successive shortest paths, and
its plain twins.

Replaces the per-path work of ``poseidon_tpu/ops/ssp.py:73`` ``_solve``
outside its relaxation loop: the walk and augment (l.130-157), the
potential update (l.156) and the next ``bellman_ford``'s set-up (its
reduced costs and capacity mask, l.101-102, and dist0/pred0, l.119-120).
Walk T -> S along the predecessor arcs (``NN`` steps at most; the
sentinel arc ``2F`` has tail T and residual 0), take the bottleneck,
route ``delta = min(bneck, wanted - routed)`` (0 unless the walk reached
S from a reachable T) and apply it once to every path arc; then
``pot += where(dist < INF, dist, 0)``, the mirror costs K10 ``in`` reads
under the new potentials and flow, and the next relaxation's distances
and predecessors. The first path's step is the prologue: no walk and no
potential update.

``PathStep`` holds one solve's device state: the tensors are checked
once, when it is made, and each step is one library call with integer
arguments (``csrc/ssp_augment.cu``: its header note gives the bound and
the design). ``dist`` and ``pot`` are buffer pairs: ``dist[d]`` is what
the next relaxation reads, ``pot[p]`` the current potentials; a step
reads ``dist[d]`` and writes the next distances into ``dist[d ^ 1]``,
never into the buffer it reads, then flips ``d`` and ``p``. ``state``
int32[2] carries ``routed`` in and out and receives ``delta``: the host
reads both in one read a path.
"""

from __future__ import annotations

import ctypes

import torch

from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**30
# arc ids of a path the walk keeps in shared memory (4 KiB; the launch
# sizes its dynamic shared memory by it); a longer path is walked a
# second time past them (csrc/ssp_augment.cu)
WALK_RECORD = 1024

KERNEL = Kernel(
    name="ssp_augment",
    source="poseidon_tpu_torch/kernels/csrc/ssp_augment.cu",
    replaces="poseidon_tpu/ops/ssp.py:133",
)


class _Args(ctypes.Structure):
    """``SspArgs`` of ``csrc/ssp_augment.cu``: every field 8 bytes."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "arc", "head", "tail", "cost", "fcap", "fsrc", "fdst", "flow",
        "pred", "mrc", "state", "dist0", "dist1", "pot0", "pot1")] + [
        (n, ctypes.c_longlong) for n in (
            "wanted", "S", "T", "NN", "F", "R", "record")]


class PathStep:
    """One SSP solve's path-step state on the CSR's device.

    ``arc``/``head``/``tail``/``cost`` are the residual CSR's int32 [2F]
    columns (``tail`` the launch plan's int32 copy), ``fcap``/``fsrc``/
    ``fdst`` the forward tables int32[F]. The step owns ``flow`` int32[F]
    (zero), ``pred`` int32[NN], ``mrc`` int32[2F], ``state`` int32[2]
    (zero) and the ``dist``/``pot`` pairs int32[NN] (potentials zero);
    the caller may fill any of them before a step."""

    def __init__(self, arc, head, tail, cost, fcap, fsrc, fdst, NN: int,
                 wanted: int, S: int, T: int):
        dev = arc.device
        F, R = fcap.shape[0], arc.shape[0]
        i32 = torch.int32
        self.arc, self.head, self.tail, self.cost = arc, head, tail, cost
        self.fcap, self.fsrc, self.fdst = fcap, fsrc, fdst
        self.NN, self.F, self.wanted, self.S, self.T = NN, F, wanted, S, T
        self.flow = torch.zeros(F, dtype=i32, device=dev)
        self.pred = torch.full((NN,), 2 * F, dtype=i32, device=dev)
        self.mrc = torch.empty(R, dtype=i32, device=dev)
        self.state = torch.zeros(2, dtype=i32, device=dev)
        self.dist = (torch.empty(NN, dtype=i32, device=dev),
                     torch.empty(NN, dtype=i32, device=dev))
        self.pot = (torch.zeros(NN, dtype=i32, device=dev),
                    torch.zeros(NN, dtype=i32, device=dev))
        self.d = 0
        self.p = 0
        self.card = on_card(arc, head, tail, cost, fcap, fsrc, fdst)
        if not self.card:
            return
        spec = (
            ("arc", arc, R), ("head", head, R), ("tail", tail, R),
            ("cost", cost, R), ("fcap", fcap, F), ("fsrc", fsrc, F),
            ("fdst", fdst, F), ("flow", self.flow, F), ("pred", self.pred, NN),
            ("mrc", self.mrc, R), ("state", self.state, 2),
            ("dist0", self.dist[0], NN), ("dist1", self.dist[1], NN),
            ("pot0", self.pot[0], NN), ("pot1", self.pot[1], NN),
        )
        self._args = _Args(
            *(kernel_arg(t, name, i32, (n,)) for name, t, n in spec),
            wanted, S, T, NN, F, R, WALK_RECORD)
        self._addr = ctypes.addressof(self._args)
        self.device = dev
        self._stream = stream_ptr(arc)
        self._launch = library("ssp_augment").ssp_step_launch


def mirror_costs_plain(arc, head, tail, cost, fcap, pot, flow):
    """K10 ``in``'s per-position input: position p stands for the mirror m
    of ``arc[p]``, an in-arc of p's tail with tail ``head[p]`` and cost
    ``-cost[p]``; its reduced cost under ``pot``, or INF where m has no
    capacity left (the reference's ``rc`` and ``cap_ok``)."""
    F = fcap.shape[0]
    fwd = arc < F
    slot = torch.where(fwd, arc, arc - F).long()
    mrc = -cost + pot[head.long()] - pot[tail.long()]
    cap_m = torch.where(fwd, flow[slot], fcap[slot] - flow[slot])
    return torch.where(cap_m > 0, mrc, INF).contiguous()


def ssp_augment_plain(pred, dist, fsrc, fdst, fcap, flow, state,
                      wanted: int, S: int, T: int):
    """The walk and augment: the reference lines restated, the full masked
    walk to the step cap, then one masked update of the flow."""
    NN = dist.shape[0]
    F = fcap.shape[0]
    dev = flow.device
    rsrc_ext = torch.cat([fsrc, fdst, torch.tensor([T], dtype=torch.int32,
                                                    device=dev)]).tolist()
    res_ext = torch.cat([fcap - flow, flow,
                         torch.zeros(1, dtype=torch.int32, device=dev)]).tolist()
    p = pred.tolist()
    reachable = int(dist[T]) < INF
    v, bneck, steps = T, INF, 0
    marked = set()
    while v != S and steps < NN:
        a = p[v]
        marked.add(a)
        bneck = min(bneck, res_ext[a])
        v = rsrc_ext[a]
        steps += 1
    routed = int(state[0])
    delta = min(bneck, wanted - routed) if reachable and v == S else 0
    mask = torch.zeros(2 * F + 1, dtype=torch.bool, device=dev)
    mask[torch.tensor(sorted(marked), dtype=torch.long, device=dev)] = True
    flow += delta * (mask[:F].to(torch.int32) - mask[F:2 * F].to(torch.int32))
    state.copy_(torch.tensor([routed + delta, delta], dtype=torch.int32,
                             device=dev))


def ssp_step_plain(step: PathStep, first: bool = False) -> None:
    """The whole path step, from its reference pieces: the walk's twin
    (unless ``first``), the torch potential update, ``mirror_costs_plain``
    and the next relaxation's dist0/pred0. Leaves ``d`` and ``p`` as they
    are (``ssp_augment`` flips them)."""
    dist, dist_next = step.dist[step.d], step.dist[step.d ^ 1]
    pot, pot_next = step.pot[step.p], step.pot[step.p ^ 1]
    if first:
        pot_next.copy_(pot)
    else:
        ssp_augment_plain(step.pred, dist, step.fsrc, step.fdst, step.fcap,
                          step.flow, step.state, step.wanted, step.S, step.T)
        pot_next.copy_(pot + torch.where(dist < INF, dist, 0))
    step.mrc.copy_(mirror_costs_plain(step.arc, step.head, step.tail,
                                      step.cost, step.fcap, pot_next,
                                      step.flow))
    dist_next.fill_(INF)
    dist_next[step.S] = 0
    step.pred.fill_(2 * step.F)


@census_op("ssp_augment")
def ssp_augment(step: PathStep, first: bool = False) -> None:
    """One path step of ``step`` (the prologue when ``first``), then flip
    its ``dist`` and ``pot`` buffers. A step on CPU tensors runs the
    plain twin; on CUDA tensors it is one launch call of K11 (two
    kernels on the current stream of the step's making)."""
    if step.card:
        with torch.cuda.device(step.device):
            err = step._launch(step._addr, step.d, step.p, int(first),
                               step._stream)
        check_launch(KERNEL, err)
        KERNEL.launches += 1
    else:
        ssp_step_plain(step, first)
    step.d ^= 1
    step.p ^= 1
