"""The auction loop with its state on the device, on the CPU.

The port runs ``_solve``'s loop on the card as one CUDA graph
(``kernels/loop_graph.py``): five bodies of tensor code over a
``LoopState`` of device tensors, chosen by K14 ``loop_ctl`` on the
device. On the CPU the same bodies run under the host loop, which reads
the branch flags. These tests hold that device-state loop against the
reference's ``_solve_cold``/``_solve_warm``/``_solve`` bit for bit on
seeded instances (tolerance 0: every output is an integer), K14's plain
twin against the branches the host loop took, the graph cache's key,
the choice of the graph path for a table on a card (with the graph
faked on the CPU), and the graph's launch accounting. The graph itself
runs only on the card: ``python3 chip_smoke.py --phases=loop``.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

import poseidon_tpu.ops.dense_auction as ref
import poseidon_tpu_torch.ops.dense_auction as port
from poseidon_tpu.compat import enable_x64
from poseidon_tpu.graph.builder import FlowGraphBuilder
from poseidon_tpu.ops.transport import extract_instance
from poseidon_tpu_torch import parallel as port_par
from poseidon_tpu_torch.guards import SyncCounter
from poseidon_tpu_torch.kernels import loop_graph
from poseidon_tpu_torch.ops.transport import TransportInstance

from tests.helpers import price, random_cluster

CPU = torch.device("cpu")
NAMES = ("asg", "lvl", "floor", "gap", "converged", "rounds", "phases",
         "hist")


def _instance(seed, n_machines=12, n_tasks=128, model="quincy"):
    rng = np.random.default_rng(seed)
    cluster = random_cluster(rng, n_machines, n_tasks)
    net, meta = FlowGraphBuilder().build(cluster)
    return extract_instance(price(net, meta, model, cluster), meta)


def _port_inst(inst) -> TransportInstance:
    return TransportInstance(**{
        f.name: getattr(inst, f.name)
        for f in dataclasses.fields(TransportInstance)
    })


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(seed, **kw):
        key = (seed, tuple(sorted(kw.items())))
        if key not in cache:
            inst = _instance(seed, **kw)
            cache[key] = (inst, ref.build_dense_instance(inst),
                          port.build_dense_instance(_port_inst(inst), CPU))
        return cache[key]
    return get


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(out_ref, out_port, names=NAMES):
    for name, a, b in zip(names, out_ref, out_port):
        assert np.array_equal(np.asarray(a), _np(b)), name


def _ref_cold(dev, max_rounds=20_000):
    with enable_x64(True):
        return ref._solve_cold(dev, alpha=1024, max_rounds=max_rounds,
                               smax=dev.smax)


def _port_cold(dev, alpha=1024, max_rounds=20_000, **kw):
    return port._solve(dev, *port.cold_start(dev, alpha), alpha=alpha,
                       max_rounds=max_rounds, smax=dev.smax,
                       analytic_init=True, **kw)


@pytest.mark.parametrize("seed", [1, 4, 7, 11])
def test_cold_equals_reference(built, seed):
    """Seeds 4, 7 and 11 refight and tighten on their way (7-15
    rounds)."""
    _, dref, dport = built(seed)
    want = _ref_cold(dref)
    got = _port_cold(dport)
    _assert_equal(want, got, NAMES[:7])
    assert bool(got[4])


@pytest.mark.parametrize("seed", [4, 7])
def test_warm_equals_reference(built, seed):
    """A warm re-settle at eps = 1 from the cold state over a
    capacity-shrunk copy (holders past the new capacity re-bid)."""
    inst, dref, dport = built(seed)
    cold_ref = _ref_cold(dref)
    cold = _port_cold(dport)
    shrunk = dataclasses.replace(
        inst, slots=np.maximum(inst.slots - 1, 0).astype(np.int32))
    d2_ref = ref.build_dense_instance(shrunk)
    d2 = port.build_dense_instance(_port_inst(shrunk), CPU)
    with enable_x64(True):
        want = ref._solve_warm(d2_ref, cold_ref[0], cold_ref[1],
                               cold_ref[2], alpha=1024, max_rounds=20_000,
                               smax=d2_ref.smax)
    got = port._solve(d2, cold[0], cold[1], cold[2], 1, alpha=1024,
                      max_rounds=20_000, smax=d2.smax)
    _assert_equal(want, got, NAMES[:7])


def test_tensor_eps0_is_not_read(built):
    """eps0 as a device tensor without the analytic init: the ladder
    runs from cmax // alpha, equal to the reference, and the host loop
    reads only its flags (one read an iteration and one a phase shift:
    eps0 itself is copied into the state, never read)."""
    _, dref, dport = built(11)
    alpha = 8
    with enable_x64(True):
        assert int(ref.cold_start(dref, alpha)[3]) > 1
        want = ref._solve(dref, *ref.cold_start(dref, alpha), alpha, 20_000,
                          dref.smax, analytic_init=False, collect_hist=True)
    syncs, trace = SyncCounter(), []
    eps0 = port.cold_start(dport, alpha)[3]
    assert isinstance(eps0, torch.Tensor) and eps0.dim() == 0
    got = port._solve(dport, *port.cold_start(dport, alpha), alpha, 20_000,
                      dport.smax, analytic_init=False, collect_hist=True,
                      syncs=syncs, trace=trace)
    _assert_equal(want, got)
    assert int(got[6]) >= 2
    shifts = sum(1 for t in trace if t[4] in ("refight", "tighten"))
    assert syncs.count == len(trace) + shifts


@pytest.mark.parametrize("seed", [4, 11])
def test_collect_hist_equals_reference(built, seed):
    _, dref, dport = built(seed)
    asg0, lvl0, floor0, eps0 = ref.cold_start(dref, 1024)
    with enable_x64(True):
        want = ref._solve(dref, asg0, lvl0, floor0, eps0, 1024, 20_000,
                          dref.smax, analytic_init=True, collect_hist=True)
    got = _port_cold(dport, collect_hist=True)
    _assert_equal(want, got)
    assert int(np.asarray(want[7]).sum()) > 0


def test_fuse_limited_equals_reference(built):
    """A fuse shorter than the solve needs: rounds == max_rounds and the
    solve is not converged, in both packages at the same state."""
    _, dref, dport = built(4)
    full = _port_cold(dport)
    short = int(full[5]) // 2
    assert short >= 2
    want = _ref_cold(dref, max_rounds=short)
    got = _port_cold(dport, max_rounds=short)
    _assert_equal(want, got, NAMES[:7])
    assert int(got[5]) == short
    assert not bool(got[4])


def test_row_blocks_width_two_equals_reference(built):
    """A RowBlocks table of width 2 (both blocks on the CPU: the host
    loop) equals the reference's solve of the whole table."""
    _, dref, dport = built(4)
    sharded = port_par.shard_instance(
        dport, port_par.make_mesh(devices=[CPU] * 2))
    assert isinstance(sharded.c, port.RowBlocks)
    assert not port.uses_graph(sharded.c)
    want = _ref_cold(dref)
    got = _port_cold(sharded)
    _assert_equal(want, got, NAMES[:7])


# ---- K14's plain twin against the host loop's trajectory ---------------

def _i32(x):
    return torch.tensor(int(x), dtype=torch.int32)


def _b(x):
    return torch.tensor(bool(x))


@pytest.mark.parametrize("seed,alpha", [(4, 1024), (11, 8), (4, 8)])
def test_loop_ctl_twin_takes_the_host_loops_branches(built, seed, alpha):
    """At every iteration of a recorded trajectory (refights, tightens
    and an eps ladder among them), K14's twin gives the branch the host
    loop took: BRANCH on the waiting flag, PHASE on the violator flag,
    and NEXT/ENTER go on exactly while the host loop goes on."""
    _, _, dport = built(seed)
    trace = []
    max_rounds = 20_000
    out = port._solve(dport, *port.cold_start(dport, alpha), alpha,
                      max_rounds, dport.smax, analytic_init=(alpha == 1024),
                      trace=trace)
    branches = [t[4] for t in trace]
    assert {"round", "tighten"} <= set(branches)
    codes = torch.zeros(4, dtype=torch.int32)
    tally = torch.zeros(loop_graph.TALLY, dtype=torch.int32)
    go, _ = loop_graph.loop_ctl(loop_graph.ENTER, _b(False), _i32(0),
                                _i32(max_rounds), _b(False), codes, tally)
    assert int(go) == 1
    for i, (it, waiting, done, any_now, branch) in enumerate(trace):
        assert it == i
        if branch == "exit":
            assert done and i == len(trace) - 1
            break
        h0, h1 = loop_graph.loop_ctl(loop_graph.BRANCH, _b(waiting),
                                     _i32(it), _i32(max_rounds), _b(done),
                                     codes, tally)
        assert (int(h0), int(h1)) == ((1, 0) if branch == "round"
                                      else (0, 1))
        if branch != "round":
            h0, h1 = loop_graph.loop_ctl(loop_graph.PHASE, _b(any_now),
                                         _i32(it), _i32(max_rounds),
                                         _b(done), codes, tally)
            assert (int(h0), int(h1)) == ((1, 0) if branch == "refight"
                                          else (0, 1))
        want = [branch == "round", branch != "round", branch == "refight",
                branch == "tighten"]
        assert codes.tolist() == [int(x) for x in want]
        nxt_done = trace[i + 1][2] if i + 1 < len(trace) else False
        go, _ = loop_graph.loop_ctl(loop_graph.NEXT, _b(False), _i32(it + 1),
                                    _i32(max_rounds), _b(nxt_done), codes,
                                    tally)
        assert int(go) == int(i + 1 < len(trace) and not nxt_done)
    n = {b: branches.count(b) for b in ("round", "refight", "tighten")}
    assert tally[:5].tolist() == [n["round"], n["refight"] + n["tighten"],
                                  n["refight"], n["tighten"], 1]
    assert n["round"] + n["refight"] + n["tighten"] == int(out[5])
    assert n["tighten"] == int(out[6])


# ---- the graph cache's key and the graph path, with the graph faked -----

def test_graph_key(built):
    """The key names the table's address, shape, layout, smax and
    collect_hist; the fuse, alpha and eps0 are device inputs (not in
    it), and u, s and task_valid are copied into the graph's buffers."""
    _, _, dev = built(4)
    key = port.graph_key(dev, dev.smax, False)
    moved = dataclasses.replace(dev, u=dev.u.clone(), s=dev.s.clone(),
                                task_valid=dev.task_valid.clone())
    assert port.graph_key(moved, dev.smax, False) == key
    other = dataclasses.replace(dev, c=dev.c.clone())
    assert port.graph_key(other, dev.smax, False) != key
    assert port.graph_key(dev, dev.smax, True) != key
    assert port.graph_key(dev, dev.smax + 1, False) != key
    Tp, Mp = dev.c.shape
    assert key[1:4] == (Tp, Mp, min(Tp, max(1024, Tp // 4)))
    sharded = port_par.shard_instance(
        dev, port_par.make_mesh(devices=[CPU] * 2))
    skey = port.graph_key(sharded, dev.smax, False)
    assert skey[5][0] == "rows" and len(skey[6]) == 2


class _FakeEntry:
    """A graph entry whose "graph" is the host loop, for the path test."""

    def __init__(self, dev, smax, collect_hist, host_loop):
        self.loop = port._Loop(dev, smax, collect_hist)
        self.lock = threading.Lock()
        self.host_loop = host_loop
        self.runs = 0

    def run(self, start):
        self.loop.load(*start)
        self.host_loop(self.loop, int(self.loop.S.max_rounds),
                       SyncCounter())
        self.runs += 1

    def release(self):
        pass


def test_card_table_takes_the_graph_path(built, monkeypatch):
    """With the table taken for one on a card, ``_solve`` asks the graph
    cache for its entry and runs it, and never runs the host loop
    itself; one key serves another fuse, alpha and eps0, and another
    table address makes a new one."""
    _, _, dev = built(4)
    host_loop = port._host_loop
    want = _port_cold(dev, collect_hist=True)
    keys, entries = [], {}

    def entry(d, smax, collect_hist, start):
        k = port.graph_key(d, smax, collect_hist)
        keys.append(k)
        if k not in entries:
            entries[k] = _FakeEntry(d, smax, collect_hist, host_loop)
        entries[k].lock.acquire()       # as the cache hands it out
        return entries[k]

    def no_host_loop(*a, **k):
        raise AssertionError("the host loop ran on a card table")

    monkeypatch.setattr(port, "uses_graph", lambda c: True)
    monkeypatch.setattr(port, "_graph_entry", entry)
    monkeypatch.setattr(port, "_host_loop", no_host_loop)
    syncs = SyncCounter()
    got = _port_cold(dev, collect_hist=True, syncs=syncs)
    _assert_equal(want, got)
    assert syncs.count == 0
    _port_cold(dev, alpha=8, max_rounds=50, collect_hist=True)
    port._solve(dev, got[0], got[1], got[2], 1, alpha=1024,
                max_rounds=20_000, smax=dev.smax, collect_hist=True)
    assert len(keys) == 3 and len(set(keys)) == 1
    other = dataclasses.replace(dev, c=dev.c.clone())
    _port_cold(other, collect_hist=True)
    assert len(set(keys)) == 2
    # the plain version on request: the host loop, not the graph
    monkeypatch.setattr(port, "_host_loop", host_loop)
    runs = sum(e.runs for e in entries.values())
    out = _port_cold(dev, collect_hist=True, host_loop=True)
    _assert_equal(want, out)
    assert sum(e.runs for e in entries.values()) == runs
    assert not any(e.lock.locked() for e in entries.values())


def test_row_blocks_over_several_cards_keep_the_host_loop():
    """Row blocks all on one card take the graph; blocks spread over
    several cards keep the host loop (``uses_graph``)."""
    def blocks(*devices):
        rb = object.__new__(port.RowBlocks)
        rb.blocks = [types.SimpleNamespace(device=torch.device(d))
                     for d in devices]
        return rb

    assert port.uses_graph(blocks("cuda:0", "cuda:0"))
    assert not port.uses_graph(blocks("cuda:0", "cuda:1"))
    assert not port.uses_graph(blocks("cpu", "cpu"))
    assert not port.uses_graph(torch.zeros(2, 2, dtype=torch.int32))


def test_graph_launch_accounting():
    """A completed graph run adds each body's kernel launches times the
    runs K14 tallied, and K14's own launches (ENTER a launch, BRANCH and
    NEXT an iteration, PHASE a phase shift), once."""
    from poseidon_tpu_torch import kernels

    g = object.__new__(loop_graph.LoopGraph)
    g.done_event = types.SimpleNamespace(query=lambda: True)
    g._host_view = np.zeros(loop_graph.TALLY, np.int32)
    g._settled = np.zeros(loop_graph.TALLY, np.int64)
    g.per_body = {"head": {"seat_sort": 0}, "round": {"bid_pass": 1,
                                                      "seat_sort": 2},
                  "pre": {"row_options": 1}, "refight": {"seat_sort": 1},
                  "tighten": {"row_options": 3, "top_will": 1,
                              "seat_sort": 1}}
    names = ("bid_pass", "seat_sort", "row_options", "top_will", "loop_ctl")
    by = {k.name: k for k in kernels.KERNELS}
    before = {n: by[n].count for n in names}
    # 10 rounds, 3 phase shifts (1 refight, 2 tightens), one launch
    g._host_view[:5] = (10, 3, 1, 2, 1)
    assert g.settle()
    got = {n: by[n].count - before[n] for n in names}
    assert got == {"bid_pass": 10, "seat_sort": 20 + 1 + 2,
                   "row_options": 3 + 6, "top_will": 2,
                   "loop_ctl": 1 + 2 * 13 + 3}
    assert g.settle()                      # nothing new: nothing added
    assert {n: by[n].count - before[n] for n in names} == got
    for n in names:
        by[n].count = before[n]


def test_table_slots_keep_an_address_while_free():
    """A table slot is handed out again once nothing else holds it (so a
    solve's table keeps its address and its loop graph), never while a
    holder or a view of it lives; the CPU takes no slot."""
    slots = port.TableSlots()
    assert slots.get(CPU, (4, 8)) is None
    meta = torch.device("meta")
    a = slots.get(meta, (4, 8))
    assert a.shape == (4, 8) and a.dtype == torch.int32
    b = slots.get(meta, (4, 8))
    assert b is not a                  # a is held here
    ids = (id(a), id(b))
    del a, b
    assert id(slots.get(meta, (4, 8))) == ids[0]     # free again
    view = slots.get(meta, (4, 8))[1:]               # held by a view
    assert id(slots.get(meta, (4, 8))) == ids[1]
    del view
    assert id(slots.get(meta, (4, 8))) == ids[0]
    assert slots.get(meta, (4, 8), part=1) is not slots.get(meta, (4, 8))
    for n in range(port.TableSlots.SHAPES + 2):
        slots.get(meta, (n + 16, 8))
    assert len(slots._slots) <= port.TableSlots.SHAPES
