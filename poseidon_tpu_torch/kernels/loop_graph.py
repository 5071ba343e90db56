"""K14 ``loop_ctl`` and the port's device loops as CUDA graphs, with K14's
plain twin.

Replaces ``poseidon_tpu/ops/dense_auction.py:946-951`` (the ``cond``
and the ``lax.while_loop`` of ``_solve``; the ``lax.cond``s of its
body, :839-938, choose the branch) and the conditions of the general
lane's nested ``lax.while_loop``s (``poseidon_tpu/ops/cost_scaling.py``
:283, :258, :212; ``poseidon_tpu/ops/ssp.py`` :165, :120). The CUDA
source is ``csrc/loop_graph.cu``; its header note gives K14's modes.

A loop is described here as a ``Seq``: the nodes of one graph in order,
each a captured body (a name, or a ``Body`` whose kernel sets
conditional handles itself), a K14 ``Step`` or a ``Cond`` (an IF or
WHILE node with its own ``Seq``). ``ControlGraph`` captures the bodies
(callables of the port's own PyTorch code and kernels) into graphs of
one shared private pool, each with ``torch.cuda.CUDAGraph(keep_graph=
True)`` in ``thread_local`` mode on a side stream, and builds the
description from ``csrc/loop_graph.cu``'s pieces; K14 sets every
conditional handle on the device. ``launch`` is one ``cudaGraphLaunch``:
the host reads nothing until the caller's result fetch. (torch 2.11
exposes no conditional capture of its own; the graph is built from raw
graphs.) ``LoopGraph`` is the auction's loop (``AUCTION``); the general
lane's loops are ``ops/cost_scaling.py``'s and ``ops/ssp.py``'s, one
graph a solve (``run_once``); the stream lane's flush (``STREAM``: the
reference's ``lax.scan`` over K windows, ``poseidon_tpu/ops/
resident.py:703``, each window's repair the auction's loop nested in
it) is ``ops/resident.py``'s ``_StreamGraph``, one graph a flush shape.

Launch counts. A kernel in a body launches when the graph runs that
body, not when its wrapper is called at capture. So the capture's
wrapper calls are taken back out of the counts and recorded per body;
K14 keeps a running tally of the branches and loop bodies the graph ran
(int32[8] on the device, copied into pinned host memory by the graph's
last node): each ``Seq`` names the tally slots whose sum counts its
runs. Once a launch has completed (``torch.cuda.Event.query``, no host
wait) ``settle`` adds each body's launches times its runs, and each K14
node's runs, to the kernels' counts. ``loader.Kernel.launches`` settles
before it answers.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
import time

import numpy as np
import torch

from poseidon_tpu_torch.guards import note_build
from poseidon_tpu_torch.kernels._args import census_op, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import (
    Kernel, check_launch, library, register_settle,
)

KERNEL = Kernel(
    name="loop_ctl",
    source="poseidon_tpu_torch/kernels/csrc/loop_graph.cu",
    replaces="poseidon_tpu/ops/dense_auction.py:946",
)

# K14's modes (csrc/loop_graph.cu)
ENTER, BRANCH, PHASE, NEXT, LOOP = 0, 1, 2, 3, 4
TALLY = 8     # the auction: tally[0..3] branch runs, tally[4] graph
              # launches; the stream flush: tally[5] windows, tally[6]
              # flushes (``T_WINDOWS``, ``T_FLUSHES``)
TERMS = 3     # a LOOP step's most terms


# ---- a loop's description ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step:
    """A K14 node. ``sets`` names the conditional handles it sets (h0,
    then h1). The auction's modes read ``flag`` (a tensor's name) and the
    tensors named rounds, max_rounds and done; LOOP reads ``terms``,
    (lhs, rhs) pairs of tensor names (None: 0 on the left, 1 on the
    right), and counts ``go`` into tally slot ``go`` and the step's run
    into slot ``run`` (-1: none)."""

    mode: int
    sets: tuple = ()
    flag: str | None = None
    terms: tuple = ()
    go: int = -1
    run: int = -1


@dataclasses.dataclass(frozen=True)
class Body:
    """A captured body whose kernel ends by setting conditional handles
    (SSP's K10 ``in`` and K11, ``kernels/ssp_loop.py``): ``sets`` holds
    (handle, word) pairs, each handle set to the device word the kernel
    writes beside it (its go word, which the host loop reads)."""

    name: str
    sets: tuple = ()


@dataclasses.dataclass(frozen=True)
class Cond:
    """An IF (``kind`` "if") or WHILE node on the handle ``handle``, its
    body the graph ``body``."""

    kind: str
    handle: str
    body: "Seq"


@dataclasses.dataclass(frozen=True)
class Seq:
    """One graph's nodes in order: bodies (names or ``Body``s), ``Step``s
    and ``Cond``s.
    ``runs``: the tally slots whose sum counts the graph's runs."""

    runs: tuple
    items: tuple


def _walk(seq: Seq):
    """(item, its Seq) for every item, depth first in order."""
    for item in seq.items:
        yield item, seq
        if isinstance(item, Cond):
            yield from _walk(item.body)


def body_name(item) -> str:
    """A body item's name (a name, or a ``Body``'s)."""
    return item.name if isinstance(item, Body) else item


@functools.lru_cache(maxsize=None)
def layout(spec: Seq) -> tuple:
    """(bodies, steps): each body's name with its Seq's run slots, in
    capture order, and each K14 step's run slots."""
    bodies = tuple((body_name(it), s.runs) for it, s in _walk(spec)
                   if isinstance(it, (str, Body)))
    steps = tuple(s.runs for it, s in _walk(spec) if isinstance(it, Step))
    return bodies, steps


# the auction's loop (ops/dense_auction.py ``_Loop``):
#   ENTER -> WHILE w { head -> BRANCH -> IF round { round }
#                      -> IF phase { pre -> PHASE -> IF refight { refight }
#                                               -> IF tighten { tighten } }
#                      -> NEXT }
AUCTION = Seq((4,), (
    Step(ENTER, sets=("w",)),
    Cond("while", "w", Seq((0, 1), (
        "head",
        Step(BRANCH, sets=("round", "phase"), flag="any_waiting"),
        Cond("if", "round", Seq((0,), ("round",))),
        Cond("if", "phase", Seq((1,), (
            "pre",
            Step(PHASE, sets=("refight", "tighten"), flag="any_now"),
            Cond("if", "refight", Seq((2,), ("refight",))),
            Cond("if", "tighten", Seq((3,), ("tighten",))),
        ))),
        Step(NEXT, sets=("w",)),
    ))),
))

# the stream lane's flush (ops/resident.py ``_StreamGraph``, the
# reference's ``lax.scan`` over K windows), each window's repair the
# auction's loop nested in it:
#   LOOP(k < K) -> WHILE win { window_head -> <AUCTION's items>
#                              -> window_tail -> LOOP(k < K) }
# tally[5] counts the windows run, tally[6] the flushes (graph launches)
T_WINDOWS, T_FLUSHES = 5, 6
STREAM = Seq((T_FLUSHES,), (
    Step(LOOP, sets=("win",), terms=(("k", "K"),), go=T_WINDOWS,
         run=T_FLUSHES),
    Cond("while", "win", Seq((T_WINDOWS,), (
        "window_head",
        *AUCTION.items,
        "window_tail",
        Step(LOOP, sets=("win",), terms=(("k", "K"),), go=T_WINDOWS),
    ))),
))


# ---- K14 eagerly, and its twin -------------------------------------------

class _Ctl(ctypes.Structure):
    """``Ctl`` of ``csrc/loop_graph.cu``."""

    _fields_ = [("lhs", ctypes.c_void_p * TERMS),
                ("rhs", ctypes.c_void_p * TERMS)] + [
        (n, ctypes.c_void_p) for n in (
            "flag", "rounds", "max_rounds", "done", "codes", "tally")] + [
        ("h0", ctypes.c_ulonglong), ("h1", ctypes.c_ulonglong)] + [
        (n, ctypes.c_int) for n in ("mode", "go_slot", "run_slot",
                                    "n_handles")]


def _word(t, name: str, dtype: torch.dtype) -> int:
    """The device address of a one-element tensor K14 reads or writes."""
    if t.dtype != dtype or t.numel() != 1:
        raise TypeError(f"loop_ctl {name}: one {dtype} element, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    return t.data_ptr()


def _vector(t, name: str, n: int) -> int:
    if t.dtype != torch.int32 or tuple(t.shape) != (n,) \
            or not t.is_contiguous():
        raise TypeError(f"loop_ctl {name}: int32[{n}] contiguous")
    return t.data_ptr()


def _ctl(step: Step, tensors: dict, codes, tally, handles=()) -> _Ctl:
    c = _Ctl()
    c.mode, c.go_slot, c.run_slot = step.mode, step.go, step.run
    if step.mode == LOOP:
        if len(step.terms) > TERMS:
            raise ValueError(f"loop_ctl: at most {TERMS} terms")
        for i, (lhs, rhs) in enumerate(step.terms):
            c.lhs[i] = None if lhs is None else _word(tensors[lhs], lhs, torch.int32)
            c.rhs[i] = None if rhs is None else _word(tensors[rhs], rhs, torch.int32)
    else:
        if step.flag is not None:
            c.flag = _word(tensors[step.flag], step.flag, torch.bool)
        c.rounds = _word(tensors["rounds"], "rounds", torch.int32)
        c.max_rounds = _word(tensors["max_rounds"], "max_rounds", torch.int32)
        c.done = _word(tensors["done"], "done", torch.bool)
        c.codes = _vector(codes, "codes", 4)
    c.tally = _vector(tally, "tally", TALLY)
    if len(handles) > 2:
        raise ValueError("loop_ctl: at most two handles")
    c.n_handles = len(handles)
    c.h0, c.h1 = (*handles, 0, 0)[:2]
    return c


def _launch_eager(step: Step, tensors: dict, codes, tally) -> None:
    dev = tally.device
    ctl = _ctl(step, tensors, codes, tally)
    with torch.cuda.device(dev):
        err = library("loop_graph").loop_ctl_launch(ctypes.byref(ctl),
                                                   stream_ptr(tally))
    check_launch(KERNEL, err)
    KERNEL.launches += 1


def loop_ctl_plain(mode: int, flag, rounds, max_rounds, done, codes, tally):
    """K14's auction modes restated in PyTorch, in place on ``codes``
    int32[4] and ``tally`` int32[8]. Returns the values it gives the two
    conditional handles (int32 tensors; ENTER and NEXT set one, the
    loop's)."""
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
    """One K14 step of the auction's modes outside a graph (no handles):
    the check against the twin. CPU tensors take the twin; CUDA tensors
    launch K14. Returns the handle values on the CPU and None on the
    card, where no handle exists outside a graph."""
    if mode not in (ENTER, BRANCH, PHASE, NEXT):
        raise ValueError(f"loop_ctl: mode {mode}")
    if not on_card(flag, rounds, max_rounds, done, codes, tally):
        return loop_ctl_plain(mode, flag, rounds, max_rounds, done, codes, tally)
    _launch_eager(Step(mode, flag="flag"),
                  {"flag": flag, "rounds": rounds, "max_rounds": max_rounds,
                   "done": done}, codes, tally)
    return None


def loop_step_plain(terms, tally, go_slot: int = -1, run_slot: int = -1):
    """K14's LOOP mode restated in PyTorch: ``terms`` (lhs, rhs) pairs of
    one-element int32 tensors or None (0 on the left, 1 on the right),
    the tally updated in place. Returns go (an int32 0-d tensor)."""
    i32 = torch.int32
    go = torch.ones((), dtype=i32, device=tally.device)
    for lhs, rhs in terms:
        if lhs is None and rhs is None:
            continue
        a = torch.zeros((), dtype=i32) if lhs is None else lhs.reshape(())
        b = torch.ones((), dtype=i32) if rhs is None else rhs.reshape(())
        go = go & (a < b).to(i32)
    if go_slot >= 0:
        tally[go_slot] += go
    if run_slot >= 0:
        tally[run_slot] += 1
    return go


@census_op("loop_ctl")
def loop_step(terms, tally, go_slot: int = -1, run_slot: int = -1):
    """One K14 LOOP step outside a graph (no handles): the check against
    the twin. CPU tensors take the twin and return go; CUDA tensors
    launch K14 and return None."""
    given = [t for pair in terms for t in pair if t is not None]
    if not on_card(tally, *given):
        return loop_step_plain(terms, tally, go_slot, run_slot)
    names = [tuple(None if t is None else f"t{i}{j}" for j, t in enumerate(p))
             for i, p in enumerate(terms)]
    tensors = {f"t{i}{j}": t for i, p in enumerate(terms)
               for j, t in enumerate(p) if t is not None}
    _launch_eager(Step(LOOP, terms=tuple(names), go=go_slot, run=run_slot),
                  tensors, None, tally)
    return None


# ---- the graphs ------------------------------------------------------------

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


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError {err}")


class ControlGraph:
    """One loop as one executable graph. ``spec`` describes it,
    ``bodies`` maps each body name to a callable that runs it on the
    loop's static tensors, and ``tensors`` maps the names K14's steps read
    to one-element device tensors (or to callables returning them, read
    once the bodies have been captured). ``tally``: the int32[TALLY]
    tally the graph's K14 steps and copy use, where the bodies' kernels
    count into it too (None: the graph's own). ``arm(handles)``: called
    with every conditional handle by name once the graph is built, before
    any launch, where the bodies' kernels set handles themselves (they
    were captured before the handles existed). ``snapshot``: the graph's
    first node copies the tally into pinned host memory too
    (``_start_view``), so a launch's own runs are the tally's host view
    less it, however many launches went before unread."""

    spec: Seq
    label = "a loop"

    def __init__(self, device, spec: Seq, bodies: dict, tensors: dict,
                 label: str | None = None, tally=None, arm=None,
                 snapshot: bool = False):
        self.device = device
        self.spec = spec
        if label is not None:
            self.label = label
        i32 = torch.int32
        self.codes = torch.zeros(4, dtype=i32, device=device)
        self.tally = (torch.zeros(TALLY, dtype=i32, device=device)
                      if tally is None else tally)
        self.handles: dict[str, int] = {}
        self.tally_host = torch.zeros(TALLY, dtype=i32, pin_memory=True)
        self._host_view = self.tally_host.numpy()
        self.start_host = (torch.zeros(TALLY, dtype=i32, pin_memory=True)
                           if snapshot else None)
        self._start_view = self.start_host.numpy() if snapshot else None
        self._settled = np.zeros(TALLY, np.int64)
        self.done_event = torch.cuda.Event()
        self.per_body: dict[str, dict[str, int]] = {}
        self.graphs: dict = {}
        self._graph = self._exec = None
        pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        _capturing.on = True
        try:
            self._capture(bodies, pool, side, _kernels())
        finally:
            _capturing.on = False
        cur.wait_stream(side)
        resolved = {k: v() if callable(v) else v for k, v in tensors.items()}
        graph = ctypes.c_void_p()
        lib = library("loop_graph")
        with torch.cuda.device(device):
            _check(lib.lg_create(ctypes.byref(graph)),
                   f"{self.label}'s graph failed to build")
            self._graph = graph.value
            try:
                first = None
                if snapshot:
                    node = ctypes.c_void_p()
                    _check(lib.lg_copy(self._graph, None,
                                       self.start_host.data_ptr(),
                                       self.tally.data_ptr(), TALLY * 4,
                                       ctypes.byref(node)),
                           f"{self.label}'s graph failed to build")
                    first = node.value
                last = self._build(lib, self._graph, spec, {}, resolved,
                                   first)
                node = ctypes.c_void_p()
                _check(lib.lg_copy(self._graph, last, self.tally_host.data_ptr(),
                                   self.tally.data_ptr(), TALLY * 4,
                                   ctypes.byref(node)),
                       f"{self.label}'s graph failed to build")
                if arm is not None:
                    arm(dict(self.handles))
                exe = ctypes.c_void_p()
                _check(lib.lg_instantiate(self._graph, ctypes.byref(exe)),
                       f"{self.label}'s graph failed to build")
            except BaseException:
                lib.lg_destroy(self._graph, None)
                self._graph = None
                raise
        self._exec = exe.value
        note_build()

    def _capture(self, bodies, pool, side, kern) -> None:
        """Each body into its own graph of the shared pool, on the side
        stream; the wrappers' launch counts of the capture are taken
        back and kept per body."""
        with torch.cuda.stream(side):
            for name, _runs in layout(self.spec)[0]:
                if name in self.graphs:
                    raise ValueError(f"{self.label}: body {name!r} twice")
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
                self.graphs[name] = g
                # a captured wrapper call launched nothing: it launches
                # each time the graph runs the body
                self.per_body[name] = {
                    k.name: k.count - before[k.name] for k in kern
                    if k.count != before[k.name]}
                for k in kern:
                    k.count = before[k.name]

    def _build(self, lib, graph, seq: Seq, handles: dict, tensors: dict,
               prev=None):
        """Add ``seq``'s nodes to ``graph`` in order (each after the one
        before, the first after ``prev``); returns the last node. The handles of its conditional
        nodes are made first, so a step may set a handle of its own graph
        or of an enclosing one."""
        what = f"{self.label}'s graph failed to build"
        handles = dict(handles)
        for item in seq.items:
            if isinstance(item, Cond):
                h = ctypes.c_ulonglong()
                _check(lib.lg_handle(graph, ctypes.byref(h)), what)
                handles[item.handle] = self.handles[item.handle] = h.value
        for item in seq.items:
            node = ctypes.c_void_p()
            if isinstance(item, (str, Body)):
                _check(lib.lg_child(
                    graph, prev, self.graphs[body_name(item)].raw_cuda_graph(),
                    ctypes.byref(node)), what)
            elif isinstance(item, Step):
                ctl = _ctl(item, tensors, self.codes, self.tally,
                           [handles[n] for n in item.sets])
                _check(lib.lg_ctl(graph, prev, ctypes.byref(ctl),
                                  ctypes.byref(node)), what)
            else:
                body = ctypes.c_void_p()
                _check(lib.lg_cond(graph, prev, handles[item.handle],
                                   int(item.kind == "while"),
                                   ctypes.byref(node), ctypes.byref(body)),
                       what)
                self._build(lib, body.value, item.body, handles, tensors)
            prev = node.value
        return prev

    def launch(self) -> None:
        """One run of the loop on the current stream."""
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device):
            err = library("loop_graph").lg_launch(self._exec, stream.cuda_stream)
        _check(err, f"{self.label}'s graph failed to launch")
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
        bodies, steps = layout(self.spec)

        def runs(slots) -> int:
            return int(sum(d[s] for s in slots))

        for k in _kernels():
            k.count += sum(self.per_body[b].get(k.name, 0) * runs(slots)
                           for b, slots in bodies)
        KERNEL.count += sum(runs(slots) for slots in steps)
        return True

    def close(self) -> None:
        """Destroy the graph once its last launch has completed (the
        pool's memory may not be handed out while the graph runs)."""
        if self._exec is None:
            return
        if not self.done_event.query():
            self.done_event.synchronize()
        with _pending_lock:
            if self.settle():
                _pending.discard(self)
        err = library("loop_graph").lg_destroy(self._graph, self._exec)
        self._graph = self._exec = None
        for g in self.graphs.values():
            g.reset()
        self.graphs = {}
        _check(err, f"{self.label}'s graph failed to close")


class LoopGraph(ControlGraph):
    """The auction loop of one solve shape (``AUCTION``). ``bodies`` maps
    head, round, pre, refight and tighten to callables; ``flags`` gives
    the two bool 0-d tensors K14 reads (``any_waiting`` after ``head``,
    ``any_now`` after ``pre``) once the bodies have been captured.
    ``rounds``, ``max_rounds`` and ``done`` are the loop state K14
    reads."""

    spec = AUCTION
    label = "the auction loop"

    def __init__(self, device, bodies: dict, flags, rounds, max_rounds,
                 done):
        any_waiting, any_now = flags
        super().__init__(device, AUCTION, bodies, {
            "any_waiting": any_waiting, "any_now": any_now,
            "rounds": rounds, "max_rounds": max_rounds, "done": done})


# ---- a general solve's loop, one graph a solve ------------------------------

class CaptureLog:
    """A loop's graph captures: how many there were (``total``) and the
    last 4,096 rows (the caller's tuples, ms last)."""

    def __init__(self) -> None:
        self.total = 0
        self._recent: collections.deque = collections.deque(maxlen=4096)

    def add(self, row: tuple) -> None:
        self.total += 1
        self._recent.append(row)

    def since(self, total: int) -> list:
        """The captures made after the log stood at ``total``."""
        n = self.total - total
        return list(self._recent)[-n:] if n > 0 else []


class GraphCache:
    """Captured graphs by key, the least recently used closed past
    ``size`` (the auction's loops and the stream lane's flushes). An
    entry has a ``lock``, held while a caller stages and launches it,
    and a ``close()``; ``captures`` logs each capture."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.captures = CaptureLog()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, make, row: tuple):
        """``(entry, capture_ms)``: the entry of ``key`` (capture ms 0.0),
        or ``make()``'s new one, logged as ``row + (ms,)``. The entry comes
        back with its lock held (taken under the cache's lock, so an
        eviction cannot close it first); the caller releases it. A
        failure of ``make`` raises and caches nothing."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                e.lock.acquire()
                return e, 0.0
            t0 = time.perf_counter()
            e = make()
            ms = (time.perf_counter() - t0) * 1e3
            self.captures.add(row + (ms,))
            e.lock.acquire()
            self._entries[key] = e
            while len(self._entries) > self.size:
                _key, old = self._entries.popitem(last=False)
                with old.lock:
                    old.close()
            return e, ms

    def values(self) -> list:
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        """Close and drop every entry (each once its lock is free)."""
        with self._lock:
            entries, self._entries = (list(self._entries.values()),
                                      collections.OrderedDict())
        for e in entries:
            with e.lock:
                e.close()

    def __len__(self) -> int:
        return len(self._entries)


def runs_graph(device) -> bool:
    """Whether a general solve on ``device`` runs its loops as one graph
    (a CUDA device) or on the host (the CPU)."""
    return torch.device(device).type == "cuda"


def run_once(device, spec: Seq, bodies: dict, tensors: dict, fetch,
             label: str, tally=None, arm=None):
    """One solve's loop as one graph: capture the bodies and build the
    graph, launch it once and return ``(fetch(), capture_ms, solve_ms)``:
    ``fetch`` is the solve's one result read; solve_ms runs from the
    launch to the fetch's end. A capture launches nothing, so the state
    the graph starts from is the one the caller made. ``tally`` and
    ``arm``: as ``ControlGraph`` takes them. The graph is destroyed
    before this returns; a failure raises."""
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        graph = ControlGraph(device, spec, bodies, tensors, label, tally,
                             arm)
        t1 = time.perf_counter()
        try:
            graph.launch()
            out = fetch()
            t2 = time.perf_counter()
        finally:
            graph.close()
    return out, (t1 - t0) * 1e3, (t2 - t1) * 1e3
