"""The stream lane's flush as one CUDA graph, on the CPU.

On the card the port runs a flush of K windows as one CUDA graph
(``ops/resident.py`` ``_StreamGraph``, described by
``kernels/loop_graph.STREAM``): the reference's ``lax.scan`` over the
windows as a WHILE node set by K14, each window's repair the auction's
loop nested in it, the bodies reading the graph's own buffers, into
which each flush is staged by copies. These tests run that route on
the CPU with the graph interpreted (``tests/test_torch_flow_graph.py``
``interpret``, K14's plain twins) over the graph's own fixed buffers,
and hold every window's log row, rounds and the carry against the host
loop's (the plain version) and the reference's ``_stream_chain``
exactly (tolerance 0: every output is an integer): an 8-window flush, a
padded 3-window flush, a flush whose window 3 fails its certificate, a
rebalancing freeze past one K5 chunk and a width-2 row-block flush on
one device. Beside them: the description is well formed, the route
(a table on one card takes the graph; the CPU, row blocks over several
cards and ``host_loop`` take the host loop; a capture failure raises),
the cache (a second flush of one key captures nothing, a grown patch
width captures once; the LRU both lanes share; an abandoned flush's
counts stay out of the next one's) and the fixed addresses (a flush leaves the warm
state the one before it committed unchanged). The graph itself runs
only on the card: ``python3 chip_smoke.py --phases=stream,parity``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import poseidon_tpu_torch.ops.dense_auction as port_da
import poseidon_tpu_torch.ops.resident as port_res
from poseidon_tpu_torch.kernels import loop_graph as k14
from poseidon_tpu_torch.kernels.loop_graph import Body, Cond, Step

from tests.test_torch_flow_graph import interpret
from tests.test_torch_stream import (
    PORT,
    REF,
    arrival,
    assert_logs_equal,
    flush_logs,
    make_stream_bridge,
)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the windows run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeStreamGraph:
    """The flush graph interpreted on the CPU: ``launch`` copies the
    tally (the card's first node, ``snapshot``), then runs ``STREAM``
    over the entry's bodies and words with K14's twins; the tally is the
    graph's (``runs`` reads both host views)."""

    def __init__(self, entry):
        self.entry = entry
        self.tally = torch.zeros(k14.TALLY, dtype=torch.int32)
        self._host_view = self.tally.numpy()
        self._start_view = self._host_view.copy()
        self.launches = 0

    def launch(self):
        self._start_view[:] = self._host_view
        interpret(k14.STREAM, self.entry.bodies(), self.entry.words(),
                  self.tally)
        self.launches += 1

    def close(self):
        pass


@pytest.fixture
def graph_route(monkeypatch):
    """The graph route on the CPU: every table counts as one on a card,
    and a capture makes an interpreted graph. The cache is emptied
    after the test. Yields the captures made."""
    made = []

    def capture(self):
        self.graph = FakeStreamGraph(self)
        made.append(self)

    monkeypatch.setattr(port_res, "uses_graph", lambda c: True)
    monkeypatch.setattr(port_res._StreamGraph, "capture", capture)
    yield made
    port_res._stream_graphs.clear()


# ---- the description ------------------------------------------------------

def test_stream_description_is_well_formed():
    """Every handle a step sets names a conditional node of its own graph
    or an enclosing one, every conditional node's handle is set by a
    step before it, the bodies are named once; the window loop nests the
    auction's items between its two bodies, four conditional levels
    deep, and counts its windows and launches in tally slots of its
    own."""
    spec = k14.STREAM
    seen = []

    def check(seq, outer, depth):
        mine = {it.handle for it in seq.items if isinstance(it, Cond)}
        known = outer | mine
        set_here = set()
        deepest = depth
        for it in seq.items:
            if isinstance(it, (str, Body)):
                seen.append(k14.body_name(it))
            elif isinstance(it, Step):
                assert set(it.sets) <= known, it
                set_here |= set(it.sets)
            else:
                assert it.handle in set_here, it
                deepest = max(deepest, check(it.body, known, depth + 1))
        return deepest

    assert check(spec, set(), 0) == 4
    assert len(seen) == len(set(seen))
    window = spec.items[1].body
    assert window.items[0] == "window_head"
    assert window.items[1:-2] == k14.AUCTION.items
    assert window.items[-2] == "window_tail"
    assert spec.runs == (k14.T_FLUSHES,) and window.runs == (k14.T_WINDOWS,)
    assert {k14.T_WINDOWS, k14.T_FLUSHES}.isdisjoint(
        {s for _b, runs in k14.layout(k14.AUCTION)[0] for s in runs} | {4})
    first, last = spec.items[0], window.items[-1]
    for step in (first, last):
        assert step.mode == k14.LOOP and step.terms == (("k", "K"),)
        assert step.go == k14.T_WINDOWS
    assert first.run == k14.T_FLUSHES and last.run == -1


# ---- the graph route against the host loop and the reference -------------

def _flush(pkg, K, sizes, seed, *, deletes=1, cap=None, n_machines=64,
           n_tasks=600, **kw):
    """A stream bridge on a seeded ``n_machines`` x ``n_tasks`` cluster
    behind one certified round, then ONE flush of ``len(sizes)`` windows:
    window w brings ``sizes[w]`` arrivals (each preferring a machine)
    and ``deletes`` completions of running pods. Returns the flush's
    logs and carry (``flush_logs``), its placements and the bridge."""
    bridge, cluster = make_stream_bridge(
        pkg, n_machines=n_machines, n_tasks=n_tasks, seed=seed,
        stream_windows=K, **kw)
    if cap is not None:
        bridge.solver.express_change_cap = cap
    rng = np.random.default_rng(seed)
    running = sorted(u for u, t in bridge.tasks.items()
                     if t.phase.value == "Running")
    victims = [running[int(i)] for i in rng.choice(
        len(running), size=deletes * len(sizes), replace=False)]
    for w, n in enumerate(sizes):
        events = [("ADDED", arrival(
            pkg, f"g{w}-{j}", cluster, int(rng.integers(n_machines)),
            cpu=float(rng.choice([0.1, 0.2, 0.4])))) for j in range(n)]
        events += [("DELETED", bridge.tasks[v])
                   for v in victims[w * deletes: (w + 1) * deletes]]
        assert bridge.stream_window(events), w
    logs = flush_logs(pkg, bridge)
    r = bridge.stream_finish()
    return (logs, sorted(r.bindings.items()) if r is not None else None,
            bridge)


CASES = {
    "eight": dict(K=8, sizes=[2, 1, 3, 0, 2, 1, 2, 3], seed=41),
    "padded": dict(K=8, sizes=[2, 1, 3], seed=43),
    # cap 2: the one-arrival windows certify; window 3's five arrivals
    # overflow the compacted log and latch the stream dead there
    "failing": dict(K=8, sizes=[1, 1, 1, 5, 1, 1, 1, 1], seed=45, cap=2,
                    deletes=0),
    # rebalancing mode: the first window's freeze of the running rows
    # (more than one K5 chunk) lands before the flush
    "freeze": dict(K=2, sizes=[2, 1], seed=47, n_machines=240,
                   n_tasks=1500, enable_preemption=True,
                   migration_hysteresis=5, running_fraction=0.75),
    "rowblocks": dict(K=4, sizes=[2, 1, 2, 1], seed=49, mesh_width=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graph_route_equals_host_loop_and_reference(case, monkeypatch):
    """The interpreted graph's flush equals the host loop's and the
    reference's window for window (rows, assignments, n_changes, the
    latch, conv, domain_ok, rounds, primal) and in the carry (table, u,
    w, s, task_valid, asg, lvl, floor, live), with the same placements;
    the graph ran once, K windows by its tally, with no host read."""
    kw = CASES[case]
    ref_logs, ref_placed, _ = _flush(REF, **kw)
    host_logs, host_placed, host_b = _flush(PORT, **kw)
    assert host_b.solver.last_stream_graph == {}
    made = []

    def capture(self):
        self.graph = FakeStreamGraph(self)
        made.append(self)

    monkeypatch.setattr(port_res, "uses_graph", lambda c: True)
    monkeypatch.setattr(port_res._StreamGraph, "capture", capture)
    try:
        graph_logs, graph_placed, graph_b = _flush(PORT, **kw)
    finally:
        port_res._stream_graphs.clear()
    assert_logs_equal(ref_logs, host_logs)
    assert_logs_equal(host_logs, graph_logs)
    assert ref_placed == host_placed == graph_placed
    solver = graph_b.solver
    assert len(made) == 1 and made[0].graph.launches == 1
    stats = solver.last_stream_graph
    assert (stats["launches"], stats["windows_run"]) == (1, kw["K"])
    assert solver.last_round_loop_syncs == 0
    assert solver.last_stream_fetches == 1
    if case == "failing":
        live = graph_logs["live"].tolist()
        assert live == [True] * 3 + [False] * 5, live
    if case == "rowblocks":
        assert isinstance(made[0].dev.c, port_da.RowBlocks)


# ---- the route --------------------------------------------------------------

def _chain_args(bridge):
    """``_stream_chain``'s arguments for one no-op window over a bridge's
    express context."""
    solver = bridge.solver
    ctx = solver._express
    solver._express_finalize(ctx)
    kmax, pk = solver.express_max_batch, ctx.n_prefs
    host = (solver._express_mini_inputs(ctx, [], kmax, pk),
            np.full(kmax, -1, np.int32), np.full((kmax, pk), -1, np.int32),
            np.full((kmax, pk), -1, np.int32), np.full(16, -1, np.int32),
            np.full(16, -1, np.int32), np.zeros(16, np.int32))
    warm = solver.warm
    args = (ctx.dev, ctx.dt, ctx.cost_dev, [solver._stream_put(host)],
            warm.asg.clone(), warm.lvl.clone(), warm.floor.clone())
    kw = dict(model_fn=ctx.model_fn, kmax=kmax, pk=pk, alpha=solver.alpha,
              max_rounds=port_res.EXPRESS_FUSE, smax=ctx.smax,
              change_cap=solver.express_change_cap)
    return args, kw


def test_route_card_table_takes_the_graph(monkeypatch):
    """A table taken for one on a card runs the graph route and never
    the host loop; the CPU, row blocks over several cards and
    ``host_loop`` run the host loop; a capture failure raises (no
    quiet fallback to the host loop)."""
    bridge, _ = make_stream_bridge(PORT, n_machines=20, n_tasks=90, seed=3,
                                   stream_windows=2)
    args, kw = _chain_args(bridge)
    calls = []
    graph_run = port_res._stream_graph_run
    host_loop = port_res._stream_host_loop

    def record(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(port_res, "_stream_graph_run",
                        record("graph", graph_run))
    monkeypatch.setattr(port_res, "_stream_host_loop",
                        record("host", host_loop))
    port_res._stream_chain(*args, **kw)
    assert calls == ["host"]                      # the CPU

    def blocks(*devices):
        rb = object.__new__(port_da.RowBlocks)
        rb.blocks = [types.SimpleNamespace(device=torch.device(d))
                     for d in devices]
        return rb

    assert port_res.uses_graph is port_da.uses_graph
    assert port_res.uses_graph(blocks("cuda:0", "cuda:0"))
    assert not port_res.uses_graph(blocks("cuda:0", "cuda:1"))

    monkeypatch.setattr(port_res, "uses_graph", lambda c: True)
    monkeypatch.setattr(port_res._StreamGraph, "capture",
                        lambda self: setattr(self, "graph",
                                             FakeStreamGraph(self)))
    try:
        calls.clear()
        port_res._stream_chain(*args, **kw)
        assert calls == ["graph"]
        calls.clear()
        port_res._stream_chain(*args, host_loop=True, **kw)
        assert calls == ["host"]
        port_res._stream_graphs.clear()

        def broken(self):
            raise RuntimeError("the stream flush's graph failed to build")

        monkeypatch.setattr(port_res._StreamGraph, "capture", broken)
        calls.clear()
        with pytest.raises(RuntimeError, match="failed to build"):
            port_res._stream_chain(*args, **kw)
        assert calls == ["graph"]
        assert not port_res._stream_graphs
    finally:
        port_res._stream_graphs.clear()


# ---- the cache ----------------------------------------------------------------

def _windows(bridge, cluster, tag, sizes, deletes=None):
    """Accumulate windows of ``sizes[w]`` arrivals and ``deletes[w]``
    completions of running pods (seeded)."""
    deletes = deletes or [0] * len(sizes)
    running = sorted(u for u, t in bridge.tasks.items()
                     if t.phase.value == "Running")
    victims = [running[int(i)] for i in np.random.default_rng(0).choice(
        len(running), size=sum(deletes), replace=False)]
    for w, n in enumerate(sizes):
        events = [("ADDED", arrival(PORT, f"{tag}{w}-{j}", cluster, j))
                  for j in range(n)]
        d0 = sum(deletes[:w])
        events += [("DELETED", bridge.tasks[v])
                   for v in victims[d0: d0 + deletes[w]]]
        assert bridge.stream_window(events)


def _finish(bridge):
    r = bridge.stream_finish()
    for uid, m in (r.bindings if r is not None else {}).items():
        bridge.confirm_binding(uid, m)
    return r


def test_same_key_captures_nothing_grown_patch_captures_once(graph_route):
    """A second flush of the same key reuses the graph (no capture); a
    window whose patch outgrows the width floor (pw 16 -> 32) makes one
    new capture, which the next flush at that width reuses."""
    # the round's bindings unconfirmed: the first window's patch holds no
    # retires, so the patch width starts at its floor, 16
    bridge, cluster = make_stream_bridge(PORT, n_machines=64, n_tasks=600,
                                         seed=11, stream_windows=2,
                                         confirm=False,
                                         running_fraction=0.3)
    total = port_res.STREAM_CAPTURES.total
    _windows(bridge, cluster, "a", [1, 2])
    bridge.stream_flush()
    _finish(bridge)
    assert port_res.STREAM_CAPTURES.total == total + 1
    _windows(bridge, cluster, "b", [2, 1])
    bridge.stream_flush()
    _finish(bridge)
    assert port_res.STREAM_CAPTURES.total == total + 1
    assert len(graph_route) == 1 and graph_route[0].graph.launches == 2
    _windows(bridge, cluster, "c", [1, 1], deletes=[20, 0])
    pw = bridge.solver._stream_pw_floor
    assert pw == 32
    bridge.stream_flush()
    r = _finish(bridge)
    assert r is not None and bridge.solver.express_ready
    new = port_res.STREAM_CAPTURES.since(total + 1)
    assert len(new) == 1 and new[0][5] == pw
    _windows(bridge, cluster, "d", [1, 1])
    bridge.stream_flush()
    _finish(bridge)
    assert port_res.STREAM_CAPTURES.total == total + 2
    assert [g.graph.launches for g in graph_route] == [2, 2]


def test_graph_cache_lru_lock_handoff_and_failed_capture():
    """``GraphCache`` (the auction's and the stream lane's): a key's entry
    comes back with its lock held, captured once; past its size the
    least recently used entry is closed (once its lock is free) and
    dropped; a failed capture raises and caches and logs nothing."""
    import threading

    cache = k14.GraphCache(2)
    closed = []

    def maker(name):
        def make():
            return types.SimpleNamespace(lock=threading.Lock(), name=name,
                                         close=lambda: closed.append(name))
        return make

    a, ms = cache.get("a", maker("a"), ("a",))
    assert a.lock.locked() and ms >= 0.0
    a.lock.release()
    again, ms = cache.get("a", maker("other"), ("a",))
    assert again is a and ms == 0.0 and cache.captures.total == 1
    a.lock.release()
    for key in ("b", "a", "c"):              # "b" is now the oldest
        cache.get(key, maker(key), (key,))[0].lock.release()
    assert closed == ["b"] and len(cache) == 2
    assert [e.name for e in cache.values()] == ["a", "c"]
    assert [row[0] for row in cache.captures.since(0)] == ["a", "b", "c"]

    def broken():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get("d", broken, ("d",))
    assert len(cache) == 2 and cache.captures.total == 3
    cache.clear()
    assert sorted(closed) == ["a", "b", "c"] and not cache


def test_abandoned_flush_leaves_no_trace_in_the_next(graph_route):
    """A flush's launches and windows are its launch's own (the tally at
    its end less the tally at its start): a flush whose counts were
    never read (abandoned in flight) adds nothing to the next flush's,
    which reads 1 launch of its K windows."""
    bridge, _ = make_stream_bridge(PORT, n_machines=20, n_tasks=90, seed=5,
                                   stream_windows=2)
    args, kw = _chain_args(bridge)
    abandoned, stats = {}, {}
    port_res._stream_chain(*args, graph_stats=abandoned, **kw)
    port_res._stream_chain(*args, graph_stats=stats, **kw)
    assert abandoned["entry"] is stats["entry"]
    assert stats["entry"].runs() == (len(args[3]), 1)
    assert graph_route[0].graph.launches == 2


# ---- fixed addresses ------------------------------------------------------------

def test_next_flush_leaves_the_committed_warm_state(graph_route):
    """The warm state a flush commits is a copy, never a graph buffer:
    the next flush of the same graph, run to its end, leaves it as it
    was, and the host loop from it gives that flush's outputs."""
    bridge, cluster = make_stream_bridge(PORT, n_machines=64, n_tasks=600,
                                         seed=13, stream_windows=2)
    _windows(bridge, cluster, "a", [2, 1])
    bridge.stream_flush()
    _finish(bridge)
    solver = bridge.solver
    entry = graph_route[0]
    warm, dev = solver.warm, solver._express.dev
    committed = {"asg": warm.asg, "lvl": warm.lvl, "floor": warm.floor,
                 "u": dev.u, "w": dev.w, "s": dev.s,
                 "valid": dev.task_valid}
    before = {k: v.clone() for k, v in committed.items()}
    graph_ptrs = {t.data_ptr() for t in (
        *entry.buffers, entry.carry.u, entry.carry.w, entry.carry.s,
        entry.carry.valid, entry.carry.asg, entry.carry.lvl,
        entry.carry.floor, entry.carry.live)}
    assert not graph_ptrs & {t.data_ptr() for t in committed.values()}
    _windows(bridge, cluster, "b", [3, 2])
    bridge.stream_flush()
    inf = solver._stream_inflight
    log, _rounds, carry, _t = inf.future.result(60.0)
    assert entry.graph.launches == 2
    for k, t in committed.items():
        assert torch.equal(t, before[k]), k
    # the second flush consumed seats where it placed (K7's auto-retire)
    assert not torch.equal(carry[3], before["s"])
    _finish(bridge)
