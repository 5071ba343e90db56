"""K14 ``loop_ctl`` and the auction loop's CUDA graph, with K14's plain twin.

Replaces ``poseidon_tpu/ops/dense_auction.py:946-951``: the ``cond``
and the ``lax.while_loop`` of ``_solve`` (the ``lax.cond``s of its body,
:839-938, choose the branch). The CUDA source is ``csrc/loop_graph.cu``;
its header note draws the graph and gives K14's modes.

``LoopGraph`` captures the loop's five bodies (head, round,
pre, refight, tighten: callables of the port's own PyTorch code and
kernels) into graphs of one shared private pool, each with
``torch.cuda.CUDAGraph(keep_graph=True)`` in ``thread_local`` mode on a
side stream, and has ``csrc/loop_graph.cu`` build the loop around them:
a WHILE node whose body chooses its branch by IF nodes that K14 sets on
the device. ``launch`` is one ``cudaGraphLaunch``: the host reads
nothing until the caller's result fetch. (torch 2.11 exposes no
conditional capture of its own; the graph is built from raw graphs.)

Launch counts. A kernel in a body launches when the graph runs that
body, not when its wrapper is called at capture. So the capture's
wrapper calls are taken back out of the counts and recorded per body;
K14 keeps a running tally of the branches the graph ran (int32[8] on
the device, copied into pinned host memory by the graph's last node),
and once a launch has completed (``torch.cuda.Event.query``, no host
wait) ``settle`` adds each body's launches times its runs to the
kernels' counts. ``loader.Kernel.launches`` settles before it answers.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from poseidon_tpu_torch.guards import note_build
from poseidon_tpu_torch.kernels._args import (
    census_op, kernel_arg, on_card, stream_ptr,
)
from poseidon_tpu_torch.kernels.loader import (
    Kernel, check_launch, library, register_settle,
)

KERNEL = Kernel(
    name="loop_ctl",
    source="poseidon_tpu_torch/kernels/csrc/loop_graph.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:946",
)

# K14's modes (csrc/loop_graph.cu)
ENTER, BRANCH, PHASE, NEXT = 0, 1, 2, 3
BODIES = ("head", "round", "pre", "refight", "tighten")
TALLY = 8     # tally[0..3] branch runs, tally[4] graph launches


def loop_ctl_plain(mode: int, flag, rounds, max_rounds, done, codes, tally):
    """K14 restated in PyTorch, in place on ``codes`` int32[4] and
    ``tally`` int32[8]. Returns the values it gives the two conditional
    handles (int32 tensors; ENTER and NEXT set one, the loop's)."""
    if mode in (BRANCH, PHASE):
        a = flag.to(torch.int32).reshape(())
        lo = 0 if mode == BRANCH else 2
        if mode == BRANCH:
            codes[2:4] = 0
        codes[lo] = a
        codes[lo + 1] = 1 - a
        tally[lo] += a
        tally[lo + 1] += 1 - a
        return a, 1 - a
    go = (~done & (rounds < max_rounds)).to(torch.int32)
    if mode == ENTER:
        tally[4] += 1
    return go, go


@census_op("loop_ctl")
def loop_ctl(mode: int, flag, rounds, max_rounds, done, codes, tally):
    """One K14 step outside a graph (no handles): the check against the
    twin. CPU tensors take the twin; CUDA tensors launch K14. Returns
    the handle values on the CPU and None on the card, where no handle
    exists outside a graph."""
    if mode not in (ENTER, BRANCH, PHASE, NEXT):
        raise ValueError(f"loop_ctl: mode {mode}")
    if not on_card(flag, rounds, max_rounds, done, codes, tally):
        return loop_ctl_plain(mode, flag, rounds, max_rounds, done, codes, tally)
    i32 = torch.int32
    dev = codes.device
    with torch.cuda.device(dev):
        err = library("loop_graph").loop_ctl_launch(
            mode, kernel_arg(flag, "flag", torch.bool, ()),
            kernel_arg(rounds, "rounds", i32, ()),
            kernel_arg(max_rounds, "max_rounds", i32, ()),
            kernel_arg(done, "done", torch.bool, ()),
            kernel_arg(codes, "codes", i32, (4,)),
            kernel_arg(tally, "tally", i32, (TALLY,)), stream_ptr(codes),
        )
    check_launch(KERNEL, err)
    KERNEL.launches += 1
    return None


# graphs with launches whose tallies are not yet in the kernels' counts
_pending: set = set()
_pending_lock = threading.Lock()
# set on a thread while it captures: its wrappers' count updates must
# not query events then
_capturing = threading.local()


def settle() -> None:
    """Add the completed graph launches' kernel launches to the counts
    (non-blocking: a launch still running is settled later)."""
    if not _pending or getattr(_capturing, "on", False):
        return
    with _pending_lock:
        for g in list(_pending):
            if g.settle():
                _pending.discard(g)


register_settle(settle)


def _kernels():
    from poseidon_tpu_torch import kernels
    return kernels.KERNELS


class LoopGraph:
    """The auction loop of one solve shape as one executable graph.

    ``bodies`` maps each name of ``BODIES`` to a callable that runs it
    on the loop's static tensors; ``flags`` gives the two bool 0-d
    tensors K14 reads (``any_waiting`` after ``head``, ``any_now`` after
    ``pre``) once the bodies have been captured. ``rounds``,
    ``max_rounds`` and ``done`` are the loop state K14 reads."""

    def __init__(self, device, bodies: dict, flags, rounds, max_rounds,
                 done):
        self.device = device
        i32 = torch.int32
        self.codes = torch.zeros(4, dtype=i32, device=device)
        self.tally = torch.zeros(TALLY, dtype=i32, device=device)
        self.tally_host = torch.zeros(TALLY, dtype=i32, pin_memory=True)
        self._host_view = self.tally_host.numpy()
        self._settled = np.zeros(TALLY, np.int64)
        self.done_event = torch.cuda.Event()
        self.per_body: dict[str, dict[str, int]] = {}
        self.graphs = []
        self._graph = self._exec = None
        pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        kern = _kernels()
        _capturing.on = True
        try:
            self._capture(bodies, pool, side, kern)
        finally:
            _capturing.on = False
        cur.wait_stream(side)
        any_waiting, any_now = (f() for f in flags)
        raw = (ctypes.c_void_p * len(BODIES))(
            *[g.raw_cuda_graph() for g in self.graphs])
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            err = library("loop_graph").loop_graph_build(
                ctypes.cast(raw, ctypes.c_void_p),
                kernel_arg(any_waiting, "any_waiting", torch.bool, ()),
                kernel_arg(any_now, "any_now", torch.bool, ()),
                kernel_arg(rounds, "rounds", i32, ()),
                kernel_arg(max_rounds, "max_rounds", i32, ()),
                kernel_arg(done, "done", torch.bool, ()),
                self.codes.data_ptr(), self.tally.data_ptr(),
                self.tally_host.data_ptr(), ctypes.byref(graph),
                ctypes.byref(exe))
        if err != 0:
            raise RuntimeError(
                f"the auction loop's graph failed to build: cudaError {err}")
        self._graph, self._exec = graph.value, exe.value
        note_build()

    def _capture(self, bodies, pool, side, kern) -> None:
        """Each body into its own graph of the shared pool, on the side
        stream; the wrappers' launch counts of the capture are taken
        back and kept per body."""
        with torch.cuda.stream(side):
            for name in BODIES:
                before = {k.name: k.count for k in kern}
                g = torch.cuda.CUDAGraph(keep_graph=True)
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    bodies[name]()
                except BaseException:
                    try:
                        g.capture_end()
                    except Exception:
                        pass
                    raise
                g.capture_end()
                self.graphs.append(g)
                # a captured wrapper call launched nothing: it launches
                # each time the graph runs the body
                self.per_body[name] = {
                    k.name: k.count - before[k.name] for k in kern
                    if k.count != before[k.name]}
                for k in kern:
                    k.count = before[k.name]

    def launch(self) -> None:
        """One run of the loop on the current stream."""
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device):
            err = library("loop_graph").loop_graph_launch(
                self._exec, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"the auction loop's graph failed to launch: cudaError {err}")
        self.done_event.record(stream)
        with _pending_lock:
            _pending.add(self)

    def settle(self) -> bool:
        """Fold this graph's completed runs into the kernels' counts;
        False while its last launch is still running."""
        if not self.done_event.query():
            return False
        now = self._host_view.astype(np.int64)
        d = now - self._settled
        self._settled = now
        runs = {"head": d[0] + d[1], "round": d[0], "pre": d[1],
                "refight": d[2], "tighten": d[3]}
        for k in _kernels():
            k.count += int(sum(self.per_body[b].get(k.name, 0) * runs[b]
                               for b in BODIES))
        # ENTER a launch; BRANCH and NEXT an iteration; PHASE a phase shift
        KERNEL.count += int(d[4] + 2 * (d[0] + d[1]) + d[1])
        return True

    def close(self) -> None:
        """Destroy the graph once its last launch has completed (the
        pool's memory may not be handed out while the graph runs)."""
        if self._exec is None:
            return
        self.done_event.synchronize()
        with _pending_lock:
            if self.settle():
                _pending.discard(self)
        err = library("loop_graph").loop_graph_destroy(self._graph,
                                                       self._exec)
        self._graph = self._exec = None
        for g in self.graphs:
            g.reset()
        self.graphs = []
        if err != 0:
            raise RuntimeError(
                f"the auction loop's graph failed to close: cudaError {err}")
