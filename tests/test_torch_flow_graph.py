"""The general lane's loops with their state on the device, on the CPU.

The port runs cost-scaling's three nested loops and SSP's two as one
CUDA graph a solve on the card (``ops/cost_scaling.py`` and
``ops/ssp.py`` ``GRAPH``): bodies of tensor code over device scalars,
each WHILE node set by K14 ``loop_ctl``'s LOOP mode. On the CPU the same
bodies run under the host loop, which reads the flags. These tests hold
that device-state loop against the reference's ``solve_cost_scaling``
and ``solve_ssp`` bit for bit (tolerance 0: every output is an integer)
on seeded scheduling graphs and on the zero-trip and fuse cases; the
graphs' descriptions run by an interpreter with K14's twin and the
bodies' own handle settings (the graph path faked on the CPU: no host
read, one fetch, the same outputs and the tally the host loop's
counts); K14's LOOP twin term by term; K9's twin with eps on the
device; K10 ``in``'s and K11's twins with their parity words on the
device and, since SSP's loop conditions are folded into them, held
round by round and step by step against the sequence they replace
(memset, relax, ``add_``, K14's LOOP twin); the launch accounting of
the nested bodies; and the order in which a description's graph is
built. The graphs
themselves run only on the card: ``python3 chip_smoke.py
--phases=general``.
"""

import types

import numpy as np
import pytest
import torch

import poseidon_tpu.ops.cost_scaling as ref_cs
import poseidon_tpu.ops.ssp as ref_ssp
import poseidon_tpu_torch.ops.cost_scaling as cs
import poseidon_tpu_torch.ops.ssp as ssp
from poseidon_tpu.graph.builder import FlowGraphBuilder
from poseidon_tpu.graph.network import FlowNetwork
from poseidon_tpu_torch.kernels import bf_relax as k10
from poseidon_tpu_torch.kernels import cs_sweep as k9
from poseidon_tpu_torch.kernels import loop_graph as k14
from poseidon_tpu_torch.kernels import ssp_augment as k11
from poseidon_tpu_torch.kernels import ssp_loop
from poseidon_tpu_torch.kernels.loop_graph import Body, Cond, Step

from tests.helpers import price, random_cluster
from tests.test_torch_cost_scaling import to_port
from tests.test_torch_ssp import make_step, walk_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the loops run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster_net(seed: int, n_machines: int = 6, n_tasks: int = 40,
                 model: str = "quincy") -> FlowNetwork:
    rng = np.random.default_rng(seed)
    cluster = random_cluster(rng, n_machines, n_tasks)
    net, meta = FlowGraphBuilder().build(cluster)
    return price(net, meta, model, cluster)


NETS = {
    "no_supply": FlowNetwork.from_arrays([0, 1], [1, 2], [5, 5], [3, 1],
                                         [0, 0, 0]),
    # a negative cycle and no supply: the saturation moves flow, and
    # leaves no excess
    "no_supply_cycle": FlowNetwork.from_arrays(
        [0, 1, 2], [1, 2, 0], [4, 4, 4], [-2, 1, -3], [0, 0, 0]),
    "infeasible": FlowNetwork.from_arrays([0], [1], [2], [1], [5, -5]),
    "single_arc": FlowNetwork.from_arrays([0], [1], [5], [3], [5, -5]),
}


def _net(name: str) -> FlowNetwork:
    """``cluster<seed>`` (6 x 40) or ``cluster<seed>_<M>x<T>``, else one
    of ``NETS``."""
    if name.startswith("cluster"):
        seed, _, size = name[len("cluster"):].partition("_")
        m, t = (int(x) for x in size.split("x")) if size else (6, 40)
        return _cluster_net(int(seed), m, t)
    return NETS[name]


CASES = ["cluster1", "cluster2", "cluster5", *NETS]


def _cs_fields(r):
    return (np.asarray(r.flows).tolist(), int(r.routed), int(r.wanted),
            int(r.sweeps), int(r.phases), bool(r.converged))


def _ssp_fields(r):
    return (np.asarray(r.flows).tolist(), int(r.routed), int(r.wanted),
            int(r.iterations))


# ---- the device-state loops against the reference ----------------------

@pytest.mark.parametrize("name,max_sweeps", [
    *((c, None) for c in CASES), ("cluster1", 16), ("cluster2", 48)])
def test_cost_scaling_equals_reference(name, max_sweeps):
    """Every output field bit for bit; a small fuse leaves the solve
    unconverged in both."""
    net = _net(name)
    kw = {} if max_sweeps is None else {"max_sweeps": max_sweeps}
    want = ref_cs.solve_cost_scaling(net, **kw)
    got = cs.solve_cost_scaling(to_port(net), device="cpu", **kw)
    assert _cs_fields(got) == _cs_fields(want)
    assert got.fetches == 1
    if max_sweeps is not None:
        assert not got.converged and got.sweeps == max_sweeps


@pytest.mark.parametrize("name,max_paths", [
    *((c, None) for c in CASES), ("cluster1", 3), ("cluster2", 0)])
def test_ssp_equals_reference(name, max_paths):
    """Every output field bit for bit: at max_paths, with no supply (no
    path taken) and infeasible (stopped by delta == 0)."""
    net = _net(name)
    kw = {} if max_paths is None else {"max_paths": max_paths}
    want = ref_ssp.solve_ssp(net, **kw)
    got = ssp.solve_ssp(to_port(net), device="cpu", **kw)
    assert _ssp_fields(got) == _ssp_fields(want)
    assert got.fetches == 1
    if max_paths is not None:
        assert got.iterations == max_paths
    if name.startswith("no_supply"):
        assert got.iterations == 0 and got.loop_syncs == 0
    if name == "infeasible":
        assert got.routed < got.wanted


# ---- the graphs, interpreted on the CPU ----------------------------------

def interpret(spec, bodies, tensors, tally, goes=None):
    """Run a graph description eagerly: bodies in order, K14's steps by
    its twin (``loop_step_plain``), IF and WHILE nodes on the values the
    steps, and the bodies whose kernels set handles, gave their handles.
    ``goes`` receives each step's (step, go)."""
    handles = {}

    def word(name):
        return None if name is None else tensors[name]

    def run(seq):
        for item in seq.items:
            if isinstance(item, str):
                bodies[item]()
            elif isinstance(item, Body):
                bodies[item.name]()
                for h, w in item.sets:
                    handles[h] = int(tensors[w])
            elif isinstance(item, Step):
                go = int(k14.loop_step_plain(
                    [(word(a), word(b)) for a, b in item.terms], tally,
                    item.go, item.run))
                if goes is not None:
                    goes.append((item, go))
                for h in item.sets:
                    handles[h] = go
            elif item.kind == "if":
                if handles[item.handle]:
                    run(item.body)
            else:
                while handles[item.handle]:
                    run(item.body)

    run(spec)


class FakeGraph:
    """``run_once`` with the graph interpreted: records the tally and
    every K14 step's go."""

    def __init__(self):
        self.tally = torch.zeros(k14.TALLY, dtype=torch.int32)
        self.goes = []
        self.runs = 0

    def __call__(self, device, spec, bodies, tensors, fetch, label,
                 tally=None, arm=None):
        if tally is not None:       # the bodies' kernels count into it too
            self.tally = tally
        interpret(spec, bodies, tensors, self.tally, self.goes)
        self.runs += 1
        return fetch(), 1.0, 2.0


def _fake_graph(monkeypatch, module):
    fake = FakeGraph()
    monkeypatch.setattr(module, "runs_graph", lambda device: True)
    monkeypatch.setattr(module, "run_once", fake)

    def no_host_loop(self):
        raise AssertionError("the host loop ran on the graph path")

    host_loop = module._Solve.host_loop
    monkeypatch.setattr(module._Solve, "host_loop", no_host_loop)
    return fake, host_loop


class _Counted:
    """Counts each body's runs on a ``_Solve`` (wrapping ``bodies``)."""

    def __init__(self, solve):
        self.n = {}
        real = solve.bodies()
        for name, fn in real.items():
            setattr(solve, _METHOD.get(name, name), self._wrap(name, fn))

    def _wrap(self, name, fn):
        def run():
            self.n[name] = self.n.get(name, 0) + 1
            fn()
        return run


_METHOD = {"step": "path_step"}


@pytest.mark.parametrize("name,max_sweeps", [
    ("cluster1", None), ("cluster5", None), ("no_supply_cycle", None),
    ("cluster2", 48), ("cluster1_12x120", None)])
def test_cost_scaling_graph_path_faked(name, max_sweeps, monkeypatch):
    """The graph path (faked on the CPU) takes no host read and one fetch
    and gives the host loop's outputs; its tally counts one launch and the
    phases, refine bursts and Bellman-Ford bursts the host loop ran."""
    net = to_port(_net(name))
    fuse = max_sweeps or 200 * (net.num_node_slots.bit_length() + 8) * 8
    host = cs._Solve(net, torch.device("cpu"), 8, fuse, 16)
    counted = _Counted(host)
    want = host.run()
    fake, _ = _fake_graph(monkeypatch, cs)
    got = cs._Solve(net, torch.device("cpu"), 8, fuse, 16).run()
    assert _cs_fields(got) == _cs_fields(want)
    assert (got.loop_syncs, got.fetches, fake.runs) == (0, 1, 1)
    n = counted.n
    assert n["enter"] == n["exit"] == want.phases
    assert n["update"] == n["sweep_burst"] == n["bf_init"]
    assert want.sweeps == 16 * n["sweep_burst"]
    assert fake.tally[:4].tolist() == [1, n["enter"], n["bf_init"],
                                       n["bf_burst"]]
    # the host loop read any(excess > 0) before every refine check and
    # changed after every burst: one read for each go K14 decided there
    refine_checks = sum(1 for s, _ in fake.goes if s.go == cs.T_REFINE)
    bf_checks = sum(1 for s, _ in fake.goes
                    if s.go == cs.T_BF and len(s.terms) == 2)
    assert want.loop_syncs == refine_checks + bf_checks


@pytest.mark.parametrize("name,max_paths", [
    ("cluster1", None), ("cluster5", None), ("no_supply", None),
    ("infeasible", None), ("cluster2", 3), ("cluster1", 0)])
def test_ssp_graph_path_faked(name, max_paths, monkeypatch):
    """As for cost-scaling: the faked graph equals the host loop, with no
    host read and one fetch; its tally counts the first path's entry,
    the further paths and the relaxation rounds the host loop ran, and
    K11 runs paths + 1 times (0 without a path)."""
    net = to_port(_net(name))
    mp = max_paths if max_paths is not None else int(
        np.maximum(net.supply, 0).sum()) + 1
    host = ssp._Solve(net, mp, torch.device("cpu"))
    counted = _Counted(host)
    want = host.run()
    fake, _ = _fake_graph(monkeypatch, ssp)
    got = ssp._Solve(net, mp, torch.device("cpu")).run()
    assert _ssp_fields(got) == _ssp_fields(want)
    assert (got.loop_syncs, got.fetches, fake.runs) == (0, 1, 1)
    n = counted.n
    paths = want.iterations
    assert fake.tally[:4].tolist() == [1, int(paths > 0), max(paths - 1, 0),
                                       n.get("round", 0)]
    assert n.get("prologue", 0) + n.get("step", 0) == (paths + 1 if paths
                                                         else 0)
    assert want.loop_syncs == n.get("round", 0) + paths


def test_solve_entries_choose_the_graph_on_the_card(monkeypatch):
    """``solve_cost_scaling`` and ``solve_ssp`` take the graph when
    ``runs_graph`` says so and the host loop on request (the private
    ``_host_loop``), never the other way."""
    net = to_port(_net("cluster1"))
    for module, solve in ((cs, cs.solve_cost_scaling),
                          (ssp, ssp.solve_ssp)):
        fake, host_loop = _fake_graph(monkeypatch, module)
        got = solve(net, device="cpu")
        assert fake.runs == 1 and got.loop_syncs == 0
        monkeypatch.setattr(module._Solve, "host_loop", host_loop)
        plain = solve(net, device="cpu", _host_loop=True)
        assert fake.runs == 1 and plain.loop_syncs > 0
        assert plain.flows.tolist() == got.flows.tolist()


# ---- K14's LOOP mode: the twin term by term ------------------------------

def _w(x):
    return torch.tensor([x], dtype=torch.int32)


@pytest.mark.parametrize("terms,want", [
    ((), 1),
    (((None, None),), 1),
    (((None, 1),), 1), (((None, 0),), 0),        # a flag: 0 < flag
    (((0, None),), 1), (((1, None),), 0),        # !done: done < 1
    (((3, 4),), 1), (((4, 4),), 0), (((5, 4),), 0),
    (((None, 1), (7, 8)), 1), (((None, 1), (8, 8)), 0),
    (((2, 9), (None, 3), (0, 1)), 1), (((2, 9), (None, 0), (0, 1)), 0),
])
def test_loop_step_twin_terms(terms, want):
    tally = torch.arange(k14.TALLY, dtype=torch.int32)
    before = tally.clone()
    args = [tuple(None if x is None else _w(x) for x in t) for t in terms]
    go = k14.loop_step(args, tally, go_slot=2, run_slot=5)
    assert int(go) == want
    d = (tally - before).tolist()
    assert d == [0, 0, want, 0, 0, 1, 0, 0]
    go = k14.loop_step(args, tally)
    assert int(go) == want and (tally - before).tolist() == d


def test_loop_step_twin_takes_the_host_loops_branches():
    """At every read of a cost-scaling solve's host loop, K14's twin over
    the device words gives the branch the host loop took: a refine check
    goes on once a refine burst and stops once a phase; a Bellman-Ford
    check goes on once a burst but the first of its loop, and stops once
    a loop."""
    net = to_port(_net("cluster1_12x120"))
    s = cs._Solve(net, torch.device("cpu"), 8, 10_000, 16)
    counted = _Counted(s)
    tally = torch.zeros(k14.TALLY, dtype=torch.int32)
    refine = [(None, s.st[cs.ACTIVE]), (s.st[cs.SWEEPS], s.limits[0])]
    bf = [(None, s.changed), (s.st[cs.IT], s.limits[1])]
    goes = {"refine": [], "bf": []}
    read = s.syncs.read

    def checked(t):
        got = read(t)
        kind = "bf" if t.data_ptr() == s.changed.data_ptr() else "refine"
        terms = bf if kind == "bf" else refine
        goes[kind].append(int(k14.loop_step_plain(terms, tally)))
        return got

    s.syncs.read = checked
    res = s.run()
    n = counted.n
    assert sum(goes["refine"]) == n["bf_init"]
    assert goes["refine"].count(0) == res.phases
    assert goes["bf"].count(0) == n["bf_init"]
    assert sum(goes["bf"]) == n["bf_burst"] - n["bf_init"]
    assert res.converged and n["bf_burst"] > n["bf_init"] > 0
    # a Bellman-Ford loop converged in its first burst: one burst, no more
    assert goes["bf"].count(0) > sum(goes["bf"])


# ---- the kernels' device scalars against their host forms ---------------

def _edge_csr(seed: int, NN: int = 40, F: int = 150):
    rng = np.random.default_rng(seed)
    fsrc = rng.integers(0, NN, F).astype(np.int32)
    fdst = rng.integers(0, NN, F).astype(np.int32)
    fcap = rng.integers(0, 10, F).astype(np.int32)
    fcost = rng.integers(-400, 400, F).astype(np.int64)
    g = cs.residual_csr(fsrc, fdst, fcap, np.concatenate([fcost, -fcost]),
                        NN, "cpu")
    flow = torch.from_numpy(
        (rng.random(F) * (fcap + 1)).astype(np.int32).clip(0, fcap))
    excess = torch.from_numpy(rng.integers(-6, 9, NN).astype(np.int32))
    price_ = torch.from_numpy(rng.integers(-900, 900, NN).astype(np.int64))
    return g, flow, excess, price_, rng


@pytest.mark.parametrize("seed,eps", [(0, 1), (1, 3), (2, 64), (3, 2**40)])
def test_cs_sweep_eps_on_the_device(seed, eps):
    """K9 with eps as an int64 0-d tensor (its wrapper, on the CPU its
    twin) equals the twin given eps as an int; the wrapper takes only the
    tensor."""
    g, flow, excess, price_, _ = _edge_csr(seed)
    outs = []
    for sweep, e in ((k9.cs_sweep_plain, eps),
                     (k9.cs_sweep, torch.tensor(eps, dtype=torch.int64))):
        fl = flow.clone()
        e_o, p_o = torch.empty_like(excess), torch.empty_like(price_)
        args = (g.seg, g.arc, g.head, g.cost, g.fcap, fl, excess, price_, e,
                e_o, p_o)
        sweep(*args, g.plan) if sweep is k9.cs_sweep else sweep(*args)
        outs.append([fl, e_o, p_o])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="eps"):
        k9.cs_sweep(g.seg, g.arc, g.head, g.cost, g.fcap, flow.clone(),
                    excess, price_, eps, torch.empty_like(excess),
                    torch.empty_like(price_), g.plan)


def _loop(NN: int, words=(), wanted: int = 10, max_paths: int = 10):
    """A CPU ``SspLoop`` with its words set from ``words`` (slot, value)
    pairs."""
    loop = ssp_loop.SspLoop("cpu", wanted, max_paths, NN)
    for i, v in words:
        loop.words[i] = v
    return loop


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("word", [0, 1, 2, 7])
def test_bf_relax_in_parity_on_the_device(seed, word):
    """K10 ``in`` with the pair and the loop's parity word (its wrapper,
    on the CPU its twin): an even word reads the first buffer and writes
    the second, an odd one the other way, exactly as the round with word
    0 and the data in the first buffer; the round's end advances the word
    by one and decides the same go."""
    g, flow, excess, price_, rng = _edge_csr(seed)
    NN, F = g.seg.shape[0] - 1, g.fcap.shape[0]
    pot = (price_ % 50).to(torch.int32)
    mrc = k11.mirror_costs_plain(g.arc, g.head, g.tail, g.cost, g.fcap, pot,
                                 flow).to(torch.int32)
    dist = torch.where(excess > 0, excess * 3, k10.INF).to(torch.int32)
    other = torch.full((NN,), -5, dtype=torch.int32)
    pred0 = torch.from_numpy(rng.integers(0, 2 * F + 1, NN).astype(np.int32))
    # word 0: the data in the first buffer
    d_o, p_o, l_o = torch.empty_like(dist), pred0.clone(), _loop(NN)
    k10.bf_relax_in(g.seg, g.arc, g.head, mrc, dist.clone(), d_o, p_o, g.plan,
                    l_o)
    # the device's: the same distances in the buffer the word names
    pair = (dist.clone(), other.clone()) if word % 2 == 0 else (
        other.clone(), dist.clone())
    p2, l2 = pred0.clone(), _loop(NN, [(ssp_loop.D, word)])
    k10.bf_relax_in(g.seg, g.arc, g.head, mrc, pair[0], pair[1], p2, g.plan,
                    l2)
    read, written = (pair[0], pair[1]) if word % 2 == 0 else (pair[1],
                                                               pair[0])
    assert torch.equal(written, d_o) and torch.equal(read, dist)
    assert torch.equal(p2, p_o)
    assert int(l2.words[ssp_loop.D]) == word + 1
    l2.words[ssp_loop.D] = 1
    assert torch.equal(l2.words, l_o.words) and torch.equal(l2.tally,
                                                            l_o.tally)


@pytest.mark.parametrize("name", sorted(walk_cases()))
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("d,p", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_ssp_augment_parity_on_the_device(name, first, d, p):
    """K11's twin with the loop's parity words naming buffers (d, p)
    equals the step with words (0, 0) and the same data in buffers (0,
    0): every output, each in the buffer its own words name, the buffers
    it reads left as they were; the step's end advances both words by
    one."""
    fsrc, fdst, fcap, flow, pred, dist, routed, wanted, S, T = \
        walk_cases()[name]
    NN = len(dist)
    pot = np.random.default_rng(NN).integers(-40, 40, NN).astype(np.int32)
    steps = []
    for words in ((0, 0), (d + 2, p + 4)):
        st, _ = make_step(fsrc, fdst, fcap, flow, pred, dist, routed,
                          wanted, S, T, pot=pot)
        if d and words != (0, 0):   # the data into the buffers d, p name
            st.dist[1].copy_(st.dist[0])
            st.dist[0].fill_(-3)
        if p and words != (0, 0):
            st.pot[1].copy_(st.pot[0])
            st.pot[0].fill_(-4)
        w = st.loop.words
        w[ssp_loop.D], w[ssp_loop.P] = words
        k11.ssp_augment(st, first=first)
        assert (int(w[ssp_loop.D]), int(w[ssp_loop.P])) == (words[0] + 1,
                                                            words[1] + 1)
        steps.append(st)
    ref, dev = steps
    for a, b in zip([ref.flow, ref.state, ref.mrc, ref.pred, ref.dist[0],
                     ref.dist[1], ref.pot[0], ref.pot[1], ref.loop.tally,
                     ref.loop.words[ssp_loop.PATHS:]],
                    [dev.flow, dev.state, dev.mrc, dev.pred, dev.dist[d],
                     dev.dist[d ^ 1], dev.pot[p], dev.pot[p ^ 1],
                     dev.loop.tally, dev.loop.words[ssp_loop.PATHS:]]):
        assert torch.equal(a, b)


# ---- SSP's loop conditions folded into K10 ``in`` and K11 ----------------

def _unfolded_round(s, read, written, ctr, changed, tally):
    """The round's control as the kernels' callers made it before the
    fold: ``changed`` from the memset and the relaxation (any distance
    improved), the dist parity and the round count advanced by an
    ``add_``, then K14's LOOP twin over (0 < changed) and (it < NN)."""
    changed.copy_((written != read).any().to(torch.int32).reshape(1))
    ctr[ssp_loop.D] += 1
    ctr[ssp_loop.IT] += 1
    return int(k14.loop_step_plain(
        [(None, changed), (ctr[ssp_loop.IT:ssp_loop.IT + 1],
                           s.loop.limits[ssp_loop.NN:])],
        tally, go_slot=ssp_loop.T_ROUND))


def _unfolded_step(s, ctr, tally, first: bool):
    """The step's control before the fold: the parities (and after a path
    the path count) advanced and the round count zeroed by ``add_`` and
    ``zero_``, K14's LOOP twin over the path loop's terms, and the path
    body's entry step over (it < NN) where the path loop goes on. Returns
    (go_path, go_bf); go_path None for the prologue."""
    L, st = s.loop, s.step
    ctr[ssp_loop.D] += 1
    ctr[ssp_loop.P] += 1
    go_path = None
    if not first:
        ctr[ssp_loop.PATHS] += 1
        ctr[ssp_loop.IT] = 0
        go_path = int(k14.loop_step_plain(
            [(st.state[0:1], L.limits[0:1]), (None, st.state[1:2]),
             (ctr[ssp_loop.PATHS:ssp_loop.PATHS + 1], L.limits[1:2])],
            tally, go_slot=ssp_loop.T_PATH))
    go_bf = 0
    if first or go_path:
        go_bf = int(k14.loop_step_plain(
            [(ctr[ssp_loop.IT:ssp_loop.IT + 1], L.limits[2:3])], tally,
            go_slot=ssp_loop.T_ROUND))
    return go_path, go_bf


@pytest.mark.parametrize("name,max_paths", [
    ("cluster1", None), ("cluster5", None), ("infeasible", None),
    ("single_arc", None), ("cluster2", 3)])
def test_folded_loop_ends_equal_the_unfolded_sequence(name, max_paths):
    """At every round and every step of a solve, the folded twins
    (``bf_relax_in_plain``, ``ssp_step_plain``) leave the same parity,
    path and round words and the same tally as the sequence they replace
    (memset, relax, ``add_``, K14's LOOP twin), and write the go that
    sequence's K14 step decided."""
    net = to_port(_net(name))
    mp = max_paths if max_paths is not None else int(
        np.maximum(net.supply, 0).sum()) + 1
    s = ssp._Solve(net, mp, torch.device("cpu"))
    L, st = s.loop, s.step
    ctr = torch.zeros(4, dtype=torch.int32)
    changed = torch.zeros(1, dtype=torch.int32)
    tally = torch.zeros(k14.TALLY, dtype=torch.int32)
    rounds = steps = 0

    def same(go_word, go):
        assert torch.equal(L.words[:4], ctr)
        assert torch.equal(L.tally[1:], tally[1:])
        assert int(L.words[go_word]) == go
        assert int(L.words[ssp_loop.CHANGED]) == 0

    assert 0 < s.wanted and 0 < mp
    s.prologue()
    _, go_bf = _unfolded_step(s, ctr, tally, True)
    same(ssp_loop.GO_BF, go_bf)
    go_path = True
    while go_path:
        while go_bf:
            d = int(L.words[ssp_loop.D]) & 1
            read = st.dist[d].clone()
            s.round()
            rounds += 1
            go_bf = _unfolded_round(s, read, st.dist[d ^ 1], ctr, changed,
                                    tally)
            same(ssp_loop.GO_BF, go_bf)
        s.path_step()
        steps += 1
        go_path, go_bf = _unfolded_step(s, ctr, tally, False)
        same(ssp_loop.GO_PATH, go_path)
        same(ssp_loop.GO_BF, go_bf)
    got = s._result().numpy()
    want = ref_ssp.solve_ssp(_net(name), **(
        {} if max_paths is None else {"max_paths": max_paths}))
    assert got[:s.E].tolist() == np.asarray(want.flows).tolist()
    assert (int(got[-2]), int(got[-1])) == (int(want.routed),
                                            int(want.iterations))
    assert steps == int(want.iterations) and rounds == int(tally[3])


def test_folded_round_over_a_csr_with_no_segment():
    """A CSR of no node (no heavy and no light item in its plan; on the
    card the launch still runs one cluster of idle blocks, whose last
    ends the round): the round writes nothing, reads no changed, and
    ends the round loop."""
    seg = torch.zeros(1, dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    plan = cs.residual_csr(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), np.zeros(0, np.int64), 0,
                           "cpu").plan
    assert plan.n_heavy == plan.n_light == 0
    loop = _loop(0, [(ssp_loop.D, 3)])
    k10.bf_relax_in(seg, empty, empty, empty, empty, empty.clone(),
                    empty.clone(), plan, loop)
    w = loop.words
    assert (int(w[ssp_loop.D]), int(w[ssp_loop.IT]),
            int(w[ssp_loop.GO_BF])) == (4, 1, 0)
    assert int(loop.tally[ssp_loop.T_ROUND]) == 0


# ---- launch accounting and the build order -------------------------------

def _accounting(spec, per_body, tally_head):
    from poseidon_tpu_torch import kernels

    g = object.__new__(k14.ControlGraph)
    g.spec = spec
    g.done_event = types.SimpleNamespace(query=lambda: True)
    g._host_view = np.zeros(k14.TALLY, np.int32)
    g._settled = np.zeros(k14.TALLY, np.int64)
    g.per_body = per_body
    names = ("cs_sweep", "bf_relax", "ssp_augment", "loop_ctl")
    by = {k.name: k for k in kernels.KERNELS}
    before = {n: by[n].count for n in names}
    g._host_view[:len(tally_head)] = tally_head
    try:
        assert g.settle()
        got = {n: by[n].count - before[n] for n in names}
        assert g.settle()                  # nothing new: nothing added
        assert {n: by[n].count - before[n] for n in names} == got
    finally:
        for n in names:
            by[n].count = before[n]
    return got


def test_cost_scaling_graph_launch_accounting():
    """K9 16 a refine burst, K10 8 a Bellman-Ford burst; K14 once a launch,
    twice a phase (its refine check and its own), twice a refine burst
    (its Bellman-Ford entry and its refine check) and once a
    Bellman-Ford burst."""
    per_body = {"enter": {}, "bf_init": {}, "bf_burst": {"bf_relax": 8},
                "update": {}, "sweep_burst": {"cs_sweep": 16}, "exit": {}}
    # the flagship's counts: 13 phases, 162 refine bursts, 241 BF bursts
    got = _accounting(cs.GRAPH, per_body, (1, 13, 162, 241))
    assert got == {"cs_sweep": 16 * 162, "bf_relax": 8 * 241,
                   "ssp_augment": 0,
                   "loop_ctl": 1 + 2 * 13 + 2 * 162 + 241}


def test_ssp_graph_launch_accounting():
    """K11 once for the prologue and once a path, K10 once a round; K14
    once a launch: the loops' conditions are set by K10 and K11."""
    per_body = {"prologue": {"ssp_augment": 1}, "round": {"bf_relax": 1},
                "step": {"ssp_augment": 1}}
    got = _accounting(ssp.GRAPH, per_body, (1, 1, 9_999, 83_642))
    assert got == {"cs_sweep": 0, "bf_relax": 83_642,
                   "ssp_augment": 10_001, "loop_ctl": 1}
    # no path: the prologue does not run either
    assert _accounting(ssp.GRAPH, per_body, (1, 0, 0, 0)) == {
        "cs_sweep": 0, "bf_relax": 0, "ssp_augment": 0, "loop_ctl": 1}


class _FakeLib:
    """``csrc/loop_graph.cu``'s builder entry points, recorded."""

    def __init__(self):
        self.calls = []
        self._n = 0

    def _new(self):
        self._n += 1
        return self._n

    def lg_handle(self, graph, h):
        h._obj.value = self._new()
        self.calls.append(("handle", graph, h._obj.value))
        return 0

    def lg_child(self, graph, dep, child, node):
        node._obj.value = self._new()
        self.calls.append(("child", graph, dep, child))
        return 0

    def lg_ctl(self, graph, dep, ctl, node):
        c = ctl._obj
        node._obj.value = self._new()
        self.calls.append(("ctl", graph, dep, c.mode, c.n_handles, c.h0,
                           c.h1, c.go_slot, c.run_slot))
        return 0

    def lg_cond(self, graph, dep, h, is_while, node, body):
        node._obj.value = self._new()
        body._obj.value = self._new()
        self.calls.append(("cond", graph, dep, h, is_while,
                           body._obj.value))
        return 0


def test_graph_build_order(monkeypatch):
    """A description becomes its nodes in order, each after the one
    before; each conditional handle is made in the graph that holds its
    node, and the graph keeps every handle by name (for the bodies'
    kernels, which set SSP's WHILE nodes themselves); the entry step sets
    its handles by name."""
    monkeypatch.setattr(k14.ctypes, "byref", lambda x: types.SimpleNamespace(
        _obj=x))
    g = object.__new__(k14.ControlGraph)
    g.label = "test"
    g.codes = torch.zeros(4, dtype=torch.int32)
    g.tally = torch.zeros(k14.TALLY, dtype=torch.int32)
    g.handles = {}
    names = [n for n, _ in k14.layout(ssp.GRAPH)[0]]
    g.graphs = {n: types.SimpleNamespace(raw_cuda_graph=lambda n=n: n)
                for n in names}
    w = torch.zeros(8, dtype=torch.int32)
    tensors = {k: w[i:i + 1] for i, k in enumerate(
        ("routed", "delta", "paths", "go_bf", "go_path", "wanted",
         "max_paths"))}
    lib = _FakeLib()
    g._build(lib, 1000, ssp.GRAPH, {}, tensors)
    assert [c[0] for c in lib.calls] == [
        "handle", "handle", "ctl", "cond", "child", "cond", "handle",
        "cond", "child", "child"]
    # root: two handles, the entry step setting both, IF then WHILE
    h_first, h_path = lib.calls[0][2], lib.calls[1][2]
    entry = lib.calls[2]
    assert entry[1] == 1000 and entry[2] is None
    assert (entry[3], entry[4], entry[5], entry[6]) == (k14.LOOP, 2,
                                                        h_first, h_path)
    conds = [c for c in lib.calls if c[0] == "cond"]
    assert [(c[3], c[4]) for c in conds[:2]] == [(h_first, 0), (h_path, 1)]
    assert conds[0][1] == conds[1][1] == 1000
    # the WHILE bf node is in the path body, its handle made there; no
    # K14 node sets it: its body's kernel and the step's do
    path_body = conds[1][5]
    bf = conds[2]
    assert bf[1] == path_body and bf[4] == 1
    h_bf = bf[3]
    assert ("handle", path_body, h_bf) in lib.calls
    assert [c for c in lib.calls if c[0] == "ctl"] == [entry]
    assert g.handles == {"first": h_first, "path": h_path, "bf": h_bf}
    # every child is a captured body, chained after its predecessor: the
    # step after the WHILE bf node, in the path body
    children = [c for c in lib.calls if c[0] == "child"]
    assert [c[3] for c in children] == ["prologue", "round", "step"]
    assert children[0][1] == conds[0][5] and children[1][1] == bf[5]
    assert children[2][1] == path_body and children[2][2] is not None


def test_ssp_loop_arm_writes_the_handles():
    """``arm`` hands the round loop's and the path loop's handles to the
    kernels (as int64 bit patterns) and their count; an eager loop keeps
    the count 0."""
    loop = ssp_loop.SspLoop("cpu", 4, 5, 6)
    assert loop.handles.tolist() == [0, 0, 0]
    assert loop.limits.tolist() == [4, 5, 6]
    loop.arm({"first": 1, "bf": 7, "path": 2**64 - 1})
    assert loop.handles.tolist() == [2, 7, -1]


def test_descriptions_are_well_formed():
    """Every handle a step or a body sets names a conditional node of the
    description (a step's: of its own graph or an enclosing one), and
    every conditional node's handle is set before the node is reached: by
    a step before it in its graph or by a body run earlier; the bodies
    are named once."""
    for spec in (k14.AUCTION, cs.GRAPH, ssp.GRAPH):
        seen_bodies = []
        handles = {it.handle for it, _ in k14._walk(spec)
                   if isinstance(it, Cond)}
        by_body = set()

        def check(seq, outer):
            mine = {it.handle for it in seq.items if isinstance(it, Cond)}
            known = outer | mine
            set_here = set()
            for it in seq.items:
                if isinstance(it, (str, Body)):
                    seen_bodies.append(k14.body_name(it))
                    if isinstance(it, Body):
                        sets = {h for h, _ in it.sets}
                        assert sets <= handles, it
                        by_body.update(sets)
                elif isinstance(it, Step):
                    assert set(it.sets) <= known, it
                    set_here |= set(it.sets)
                else:
                    assert it.handle in set_here | by_body, it
                    check(it.body, known)

        check(spec, set())
        assert len(seen_bodies) == len(set(seen_bodies))
