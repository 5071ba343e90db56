"""The batched cost-scaling solve (``solve_cost_scaling_batch``) against
the reference's ``_solve`` under ``jax.vmap`` over cost vectors, on the
CPU.

``tests/test_cost_scaling.py::TestWhatIfBatching::test_vmap_over_costs``
solves one topology under a batch of cost vectors as one device program
(BASELINE config 5's what-if, over the general lane). The same numpy
cost batch goes through ``jax.vmap(lambda c: _solve(base.with_costs(c),
max_sweeps, 8))`` under ``enable_x64`` and through the port's batch on
the CPU, where the batched K9 and K10 run their plain twins. Every
output is an integer, so every comparison is exact (tolerance 0):
flows, routed, sweeps, phases and converged of every element. The cases:
the reference test's own instance and cost recipe; a batch of one;
elements whose max |cost| differs (their BIG, eps ladder and phase
count differ); a fuse that one element blows while the others converge;
a topology with no supply; each element against the port's single
solve; the host loop's reads; the batch's graph description run by an
interpreter with K14's twin; and the batched K9/K10 twins against B
calls of the single twins, masked elements kept as they were. The
graph itself runs only on the card: ``python3 chip_smoke.py
--phases=csbatch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu_torch.ops.cost_scaling as cs
from poseidon_tpu.compat import enable_x64
from poseidon_tpu.graph.network import FlowNetwork
from poseidon_tpu.ops.cost_scaling import _solve
from poseidon_tpu_torch.kernels import bf_relax as k10
from poseidon_tpu_torch.kernels import cs_sweep as k9
from poseidon_tpu_torch.kernels import loop_graph as k14

from tests.test_oracle import random_instance
from tests.test_torch_cost_scaling import to_port
from tests.test_torch_flow_graph import interpret

FUSE = 20000
K = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the loops run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_batch():
    """``test_vmap_over_costs``'s instance and cost batch: seed 55, K = 8,
    each vector the base costs plus a draw in [0, 5), the padding cost
    slots zeroed."""
    rng = np.random.default_rng(55)
    base = random_instance(rng)
    costs = np.stack([
        np.asarray(base.cost) + rng.integers(0, 5, size=base.num_arc_slots)
        for _ in range(K)
    ]).astype(np.int32)
    costs[:, int(base.n_arcs):] = 0
    return base, costs


def vmapped(base: FlowNetwork, costs: np.ndarray, max_sweeps: int = FUSE):
    """The reference: ``_solve`` under ``jax.vmap`` over the cost rows."""
    with enable_x64(True):
        out = jax.vmap(lambda c: _solve(base.with_costs(c), max_sweeps, 8))(
            jnp.asarray(costs))
    return {k: np.asarray(getattr(out, k)) for k in (
        "flows", "routed", "wanted", "sweeps", "phases", "converged")}


def assert_vmap_equal(base, costs, max_sweeps: int = FUSE):
    """The port's batch on the CPU equals the vmapped reference in every
    field of every element; returns the port's result."""
    want = vmapped(base, costs, max_sweeps)
    got = cs.solve_cost_scaling_batch(to_port(base), costs,
                                      max_sweeps=max_sweeps, device="cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    assert got.flows.dtype == np.int32 and got.converged.dtype == bool
    assert got.fetches == 1
    return got


def assert_singles_equal(base, costs, got, max_sweeps: int = FUSE):
    """Each element equals the port's single solve of its cost vector."""
    net = to_port(base)
    for b in range(costs.shape[0]):
        one = cs.solve_cost_scaling(net.with_costs(costs[b]),
                                    max_sweeps=max_sweeps, device="cpu")
        e = got[b]
        np.testing.assert_array_equal(e.flows, one.flows)
        assert (e.routed, e.wanted, e.sweeps, e.phases, e.converged) == (
            one.routed, one.wanted, one.sweeps, one.phases, one.converged)


def test_reference_vmap_instance():
    """The reference test's own batch, bit for bit, and each element
    against the port's single solve."""
    base, costs = reference_batch()
    got = assert_vmap_equal(base, costs)
    assert got.converged.all() and got.feasible.all()
    assert_singles_equal(base, costs, got)


def test_batch_of_one():
    base, costs = reference_batch()
    got = assert_vmap_equal(base, costs[3:4])
    assert got.flows.shape == (1, base.num_arc_slots)
    assert_singles_equal(base, costs[3:4], got)


def test_elements_with_different_eps_ladders():
    """Max |cost| differs by element (x1, x40, x3,000 and a row of
    zeros), so BIG, eps0 and the phase count differ: the phase loop runs
    while any element is in it, and each element stops at its own."""
    base, costs = reference_batch()
    scaled = np.stack([costs[0], costs[1] * 40, costs[2] * 3000,
                       np.zeros_like(costs[0]), costs[4]]).astype(np.int32)
    got = assert_vmap_equal(base, scaled)
    assert len(set(got.phases.tolist())) >= 3
    assert_singles_equal(base, scaled, got)


def test_fuse_blown_by_some_elements():
    """A fuse between the elements' sweep counts: the elements past it
    stop unconverged at the fuse, the others converge as they would."""
    base, costs = reference_batch()
    full = cs.solve_cost_scaling_batch(to_port(base), costs, device="cpu",
                                       max_sweeps=FUSE)
    fuse = int(np.sort(full.sweeps)[K // 2])
    got = assert_vmap_equal(base, costs, fuse)
    assert 0 < got.converged.sum() < K
    assert (got.sweeps[~got.converged] == fuse).all()
    assert_singles_equal(base, costs, got, fuse)


def test_no_supply():
    """A topology with no supply (the saturation alone moves flow on a
    negative cycle): every element finishes with no excess."""
    net = FlowNetwork.from_arrays([0, 1, 2, 0], [1, 2, 0, 2], [4, 4, 4, 3],
                                  [-2, 1, -3, 5], [0, 0, 0])
    costs = np.stack([np.asarray(net.cost) * k for k in (1, 2, -1)]
                     ).astype(np.int32)
    got = assert_vmap_equal(net, costs)
    assert (got.routed == 0).all() and (got.wanted == 0).all()
    assert_singles_equal(net, costs, got)


def test_costs_shape_is_checked():
    base, costs = reference_batch()
    with pytest.raises(ValueError):
        cs.solve_cost_scaling_batch(to_port(base), costs[0], device="cpu")
    with pytest.raises(ValueError):
        cs.solve_cost_scaling_batch(to_port(base), costs[:, :-1],
                                    device="cpu")


# ---- the loops: the host loop's reads and the graph, interpreted --------

class _Counted:
    """Counts each body's runs on a ``_BatchSolve``."""

    def __init__(self, solve):
        self.n = {}
        for name, fn in solve.bodies().items():
            setattr(solve, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def run():
            self.n[name] = self.n.get(name, 0) + 1
            fn()
        return run


def _batch_solve(base, costs, max_sweeps=FUSE):
    return cs._BatchSolve(to_port(base), costs, torch.device("cpu"), 8,
                          max_sweeps, 16)


@pytest.mark.parametrize("case", ["reference", "ladders", "fuse"])
def test_host_loop_reads_and_graph_interpreted(case, monkeypatch):
    """The host loop reads the refine count before every refine burst and
    once more to end each phase's refine loop, and the Bellman-Ford count
    after every burst; it runs as many phases as the longest eps ladder.
    The batch's graph (``BATCH_GRAPH``), run by an interpreter with K14's
    twin over the same bodies, makes no read and one fetch, gives the
    host loop's outputs, and its tally counts one launch and the phases,
    refine bursts and Bellman-Ford bursts the host loop ran."""
    base, costs = reference_batch()
    fuse = FUSE
    if case == "ladders":
        costs = np.stack([costs[0], costs[1] * 50, costs[2] * 4000])
    elif case == "fuse":
        fuse = 256
    host = _batch_solve(base, costs, fuse)
    counted = _Counted(host)
    want = host.run()
    n = counted.n
    ladders = [cs._phase_count(e, 8) for e in host.eps0]
    assert n["enter"] == n["exit"] == max(ladders)
    assert want.phases.tolist() == ladders
    assert n["update"] == n["sweep_burst"] == n["bf_init"]
    assert want.loop_syncs == n["bf_init"] + n["enter"] + n["bf_burst"]

    tally = torch.zeros(k14.TALLY, dtype=torch.int32)
    runs = []

    def fake_run_once(device, spec, bodies, tensors, fetch, label,
                      tally=None, arm=None):
        interpret(spec, bodies, tensors, tally_box[0])
        runs.append(spec)
        return fetch(), 1.0, 2.0

    tally_box = [tally]
    monkeypatch.setattr(cs, "runs_graph", lambda device: True)
    monkeypatch.setattr(cs, "run_once", fake_run_once)
    got = _batch_solve(base, costs, fuse).run()
    assert runs == [cs.BATCH_GRAPH]
    for k in ("flows", "routed", "sweeps", "phases", "converged"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.loop_syncs, got.fetches) == (0, 1)
    assert tally[:4].tolist() == [1, n["enter"], n["bf_init"],
                                  n["bf_burst"]]
    assert cs.CAPTURES.since(cs.CAPTURES.total - 1)[0][2] == len(costs)


def test_batch_entry_chooses_the_graph_on_the_card(monkeypatch):
    """``solve_cost_scaling_batch`` takes the graph when ``runs_graph``
    says so and the host loop on request (the private ``_host_loop``)."""
    base, costs = reference_batch()
    calls = []

    def fake_run_once(device, spec, bodies, tensors, fetch, label,
                      tally=None, arm=None):
        interpret(spec, bodies, tensors,
                  torch.zeros(k14.TALLY, dtype=torch.int32))
        calls.append(label)
        return fetch(), 1.0, 2.0

    monkeypatch.setattr(cs, "runs_graph", lambda device: True)
    monkeypatch.setattr(cs, "run_once", fake_run_once)
    net = to_port(base)
    got = cs.solve_cost_scaling_batch(net, costs[:2], device="cpu")
    assert len(calls) == 1 and got.loop_syncs == 0
    plain = cs.solve_cost_scaling_batch(net, costs[:2], device="cpu",
                                        _host_loop=True)
    assert len(calls) == 1 and plain.loop_syncs > 0
    np.testing.assert_array_equal(plain.flows, got.flows)


# ---- the batched K9/K10 twins against the single twins ------------------

def _csr_batch(seed: int, B: int, NN: int = 40, F: int = 150):
    """A random residual CSR (a hub of 60 arcs on node 1, node NN - 1 of
    degree 0) and B elements over it, each with its own costs, flow,
    excess, price and eps (1, 3, 64 and 2^40 in turn)."""
    rng = np.random.default_rng(seed)
    fsrc = rng.integers(0, NN - 1, F).astype(np.int32)
    fdst = rng.integers(0, NN - 1, F).astype(np.int32)
    fsrc[:60] = 1
    fcap = rng.integers(0, 10, F).astype(np.int32)
    fcost = rng.integers(-400, 400, (B, F)).astype(np.int64)
    g = cs.residual_csr(fsrc, fdst, fcap,
                        np.concatenate([fcost[0], -fcost[0]]), NN, "cpu")
    order = g.arc.long()
    cost = torch.as_tensor(np.concatenate([fcost, -fcost], axis=1))[:, order]
    flow = torch.as_tensor((rng.random((B, F)) * (fcap + 1)).astype(np.int32)
                           .clip(0, fcap))
    excess = torch.as_tensor(rng.integers(-6, 9, (B, NN)).astype(np.int32))
    price = torch.as_tensor(rng.integers(-900, 900, (B, NN)).astype(np.int64))
    eps = torch.as_tensor(np.array([(1, 3, 64, 2**40)[b % 4]
                                    for b in range(B)], np.int64))
    return g, cost.contiguous(), flow, excess, price, eps


MASKS = {"all": lambda B: [1] * B, "none": lambda B: [0] * B,
         "alternate": lambda B: [b % 2 for b in range(B)]}


@pytest.mark.parametrize("B", [1, 2, 5])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_batched_sweep_twin_equals_single_twins(B, mask):
    """``cs_sweep_batch`` (its twin, through the wrapper) equals B calls
    of ``cs_sweep_plain`` for the running elements; a masked element
    keeps its flow, and its excess and price come out as they went in."""
    g, cost, flow, excess, price, eps = _csr_batch(B, B)
    m = torch.tensor(MASKS[mask](B), dtype=torch.int32)
    fl = flow.clone()
    e_o = torch.full_like(excess, -1)
    p_o = torch.full_like(price, -1)
    k9.cs_sweep_batch(g.seg, g.arc, g.head, cost, g.fcap, fl, excess, price,
                      eps, e_o, p_o, m, g.plan)
    for b in range(B):
        if m[b]:
            f1 = flow[b].clone()
            e1, p1 = torch.empty_like(excess[b]), torch.empty_like(price[b])
            k9.cs_sweep_plain(g.seg, g.arc, g.head, cost[b], g.fcap, f1,
                              excess[b], price[b], eps[b], e1, p1)
        else:
            f1, e1, p1 = flow[b], excess[b], price[b]
        assert torch.equal(fl[b], f1)
        assert torch.equal(e_o[b], e1)
        assert torch.equal(p_o[b], p1)


@pytest.mark.parametrize("B", [1, 2, 5])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_batched_relax_twin_equals_single_twins(B, mask):
    """``bf_relax_out_batch`` (its twin, through the wrapper) equals B
    calls of ``bf_relax_out_plain`` for the running elements; a masked
    element copies its distances and reports no change."""
    g, cost, flow, excess, price, eps = _csr_batch(10 + B, B)
    m = torch.tensor(MASKS[mask](B), dtype=torch.int32)
    ln = torch.stack([cs.arc_lengths(
        cs.ResidualCSR(g.seg, g.arc, g.head, g.tail, cost[b], g.fcap,
                       g.plan), flow[b], price[b], int(eps[b]))
        for b in range(B)])
    d = torch.where(excess < 0, 0, k10.INF_K).to(torch.int64)
    d[:, 1] = 3      # a few finite starts beside the deficits
    d_o = torch.full_like(d, -1)
    ch = torch.full((B,), 7, dtype=torch.int32)
    k10.bf_relax_out_batch(g.seg, g.head, ln, d, d_o, ch, m, g.plan)
    for b in range(B):
        if m[b]:
            d1 = torch.empty_like(d[b])
            c1 = torch.zeros(1, dtype=torch.int32)
            k10.bf_relax_out_plain(g.seg, g.head, ln[b], d[b], d1, c1)
        else:
            d1, c1 = d[b], torch.zeros(1, dtype=torch.int32)
        assert torch.equal(d_o[b], d1)
        assert int(ch[b]) == int(c1[0])
