"""Differential tests: the port's host graph layer vs the JAX reference.

Builder arrays and ``GraphMeta``, the transport topology and instance,
``pad_topology``, the DIMACS text, flow decomposition and
``extract_deltas`` must equal the reference's exactly on the same
clusters (``tests.helpers.random_cluster`` seeds and synthetic clusters
with running pods, in place-only and rebalancing mode).

``build_reference_oracle`` puts the reference's C++ oracle binary in
place for the port tests whose reference code runs it: the reference
builds it in place on first use (``make``, ``g++ -o`` over the binary),
so a test worker could execute it while another was still writing it.
"""

import dataclasses
import fcntl
import os
import pathlib
import subprocess

import numpy as np
import pytest

import poseidon_tpu.graph.deltas as ref_deltas
import poseidon_tpu.oracle.oracle as ref_oracle
import poseidon_tpu.ops.resident as ref_res
import poseidon_tpu.ops.transport as ref_tr
import poseidon_tpu_torch.graph.deltas as port_deltas
import poseidon_tpu_torch.ops.resident as port_res
import poseidon_tpu_torch.ops.transport as port_tr
from poseidon_tpu.graph.builder import FlowGraphBuilder as RefBuilder
from poseidon_tpu.synth import make_synthetic_cluster
from poseidon_tpu_torch import cluster as port_cluster
from poseidon_tpu_torch.graph.builder import FlowGraphBuilder as PortBuilder

from tests.helpers import random_cluster

REF_ORACLE_DIR = pathlib.Path(ref_oracle.__file__).resolve().parent


def build_reference_oracle() -> pathlib.Path:
    """Have the reference oracle's binary whole at its path before a test
    runs reference code that calls it. Under an exclusive ``flock`` of a
    lock file in the (gitignored) build directory, a missing or stale
    binary is compiled with the reference Makefile's flags to a temporary
    name and renamed over the path: every worker then sees no binary or a
    whole one, and the reference's own ``_ensure_built`` finds it fresh
    and builds nothing. The reference's module is left as it is."""
    src = REF_ORACLE_DIR / "mcmf_oracle.cc"
    binary = REF_ORACLE_DIR / "build" / "mcmf_oracle"
    binary.parent.mkdir(parents=True, exist_ok=True)
    with open(binary.parent / ".port-tests.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not binary.exists()
                or binary.stat().st_mtime < src.stat().st_mtime):
            tmp = binary.with_name(f"{binary.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", "-std=c++17", "-O2", "-Wall", "-Wextra", "-o",
                 str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"reference oracle build failed:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, binary)
    return binary


def to_port_cluster(cluster):
    """The same cluster as the port's own dataclasses."""
    return port_cluster.ClusterState(
        machines=[port_cluster.Machine(**dataclasses.asdict(m))
                  for m in cluster.machines],
        tasks=[
            port_cluster.Task(**{
                **dataclasses.asdict(t),
                "phase": port_cluster.TaskPhase(t.phase.value),
            })
            for t in cluster.tasks
        ],
    )


def delta_rows(ds):
    """A DeltaSet as comparable plain tuples."""
    def rows(items):
        return [(int(d.kind), d.task, d.machine, d.from_machine, d.cost,
                 d.margin) for d in items]

    return {
        "place": rows(ds.place), "migrate": rows(ds.migrate),
        "preempt": rows(ds.preempt), "noop": rows(ds.noop),
        "deferred": rows(ds.deferred), "unscheduled": list(ds.unscheduled),
    }


def _clusters():
    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        out.append((f"random{seed}", random_cluster(
            rng, int(rng.integers(3, 40)), int(rng.integers(5, 200))
        )))
    out.append(("synth_running", make_synthetic_cluster(
        48, 400, seed=7, running_fraction=0.3, machines_per_rack=8
    )))
    return out


CLUSTERS = dict(_clusters())


def _meta_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _topology_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _build(name, preemption):
    cluster = CLUSTERS[name]
    ra, rm = RefBuilder(preemption=preemption).build_arrays(cluster)
    pa, pm = PortBuilder(preemption=preemption).build_arrays(
        to_port_cluster(cluster)
    )
    return (ra, rm), (pa, pm)


@pytest.mark.parametrize("preemption", [False, True])
@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_builder_and_topology_equal(name, preemption):
    (ra, rm), (pa, pm) = _build(name, preemption)
    assert sorted(ra) == sorted(pa)
    for k in ra:
        assert ra[k].dtype == pa[k].dtype and np.array_equal(ra[k], pa[k]), k
    _meta_equal(rm, pm)
    rt = ref_tr.extract_topology(rm, ra["src"], ra["dst"], ra["cap"])
    pt = port_tr.extract_topology(pm, pa["src"], pa["dst"], pa["cap"])
    _topology_equal(rt, pt)
    for floors in ({}, dict(t_min=256, m_min=64, p_min=5)):
        rd = ref_res.pad_topology(rt, **floors)
        pd = port_res.pad_topology(pt, **floors)
        for f in dataclasses.fields(pd):
            x, y = getattr(rd, f.name), getattr(pd, f.name)
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_instance_and_dimacs_equal(name):
    """Priced with the same arc costs, the transport instance and the
    DIMACS text the oracle reads are identical."""
    import poseidon_tpu.graph.dimacs as ref_dimacs
    import poseidon_tpu_torch.graph.dimacs as port_dimacs
    from poseidon_tpu.graph.network import FlowNetwork as RefNet
    from poseidon_tpu_torch.graph.network import FlowNetwork as PortNet

    (ra, rm), (pa, pm) = _build(name, False)
    cost = np.random.default_rng(len(name)).integers(
        0, 500, rm.n_arcs
    ).astype(np.int32)
    rt = ref_tr.extract_topology(rm, ra["src"], ra["dst"], ra["cap"])
    pt = port_tr.extract_topology(pm, pa["src"], pa["dst"], pa["cap"])
    ri = ref_tr.instance_from_topology(rt, cost)
    pi = port_tr.instance_from_topology(pt, cost)
    _topology_equal(ri, pi)
    rnet = RefNet.from_arrays(ra["src"], ra["dst"], ra["cap"], cost,
                              ra["supply"])
    pnet = PortNet.from_arrays(pa["src"], pa["dst"], pa["cap"], cost,
                               pa["supply"])
    assert ref_dimacs.write_dimacs(rnet) == port_dimacs.write_dimacs(pnet)


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_flows_from_assignment_equal(name):
    """An assignment (with its cheapest channels) expands to the same
    per-arc flows."""
    from poseidon_tpu.ops.dense_auction import _channels_for as ref_ch
    from poseidon_tpu_torch.ops.dense_auction import _channels_for as p_ch

    (ra, rm), (pa, pm) = _build(name, False)
    cost = np.random.default_rng(len(name) + 2).integers(
        0, 400, rm.n_arcs
    ).astype(np.int32)
    ri = ref_tr.instance_from_topology(
        ref_tr.extract_topology(rm, ra["src"], ra["dst"], ra["cap"]), cost)
    pi = port_tr.instance_from_topology(
        port_tr.extract_topology(pm, pa["src"], pa["dst"], pa["cap"]), cost)
    rng = np.random.default_rng(len(name))
    asg = rng.integers(-1, ri.n_machines, ri.n_tasks).astype(np.int32)
    rch, pch = ref_ch(ri, asg), p_ch(pi, asg)
    assert np.array_equal(rch, pch)
    rres = ref_tr.TransportResult(asg, rch, 0, 0, 0, True)
    pres = port_tr.TransportResult(asg, pch, 0, 0, 0, True)
    assert np.array_equal(
        ref_tr.flows_from_assignment(ri, rres, rm.n_arcs + 5),
        port_tr.flows_from_assignment(pi, pres, pm.n_arcs + 5),
    )


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_oracle_and_decomposition_equal(name):
    """The port's oracle wrapper (its own build of its own copy of the
    C++ source) solves to the reference's optimum, and the flows
    decompose to the same placements. The reference's binary is put in
    place first (``build_reference_oracle``)."""
    from poseidon_tpu.graph.decompose import extract_placements as ref_ep
    from poseidon_tpu.graph.network import FlowNetwork as RefNet
    from poseidon_tpu.oracle import solve_oracle as ref_solve
    from poseidon_tpu_torch.graph.decompose import extract_placements as p_ep
    from poseidon_tpu_torch.graph.network import FlowNetwork as PortNet
    from poseidon_tpu_torch.oracle import solve_oracle as port_solve

    build_reference_oracle()
    (ra, rm), (pa, pm) = _build(name, False)
    cost = np.random.default_rng(len(name) + 1).integers(
        0, 300, rm.n_arcs
    ).astype(np.int32)
    ro = ref_solve(RefNet.from_arrays(ra["src"], ra["dst"], ra["cap"], cost,
                                      ra["supply"]), algorithm="cost_scaling")
    po = port_solve(PortNet.from_arrays(pa["src"], pa["dst"], pa["cap"],
                                        cost, pa["supply"]),
                    algorithm="cost_scaling")
    assert ro.cost == po.cost
    assert np.array_equal(ro.flows, po.flows)
    assert ref_ep(ro.flows, rm, ra["src"], ra["dst"]) == p_ep(
        po.flows, pm, pa["src"], pa["dst"]
    )


@pytest.mark.parametrize("budget", [0, 2])
@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_extract_deltas_equal(name, budget):
    """Typed deltas over a random assignment (with costs and margins,
    some unknown) are identical, migration budget included."""
    (_, rm), (_, pm) = _build(name, True)
    rng = np.random.default_rng(len(name) + budget)
    T, M = len(rm.task_uids), len(rm.machine_names)
    asg = rng.integers(-1, M, T).astype(np.int32)
    cost = rng.integers(0, 1000, T).astype(np.int64)
    margin = rng.integers(-50, 50, T).astype(np.int64)
    margin[rng.random(T) < 0.2] = ref_deltas.MARGIN_UNKNOWN
    rd = ref_deltas.extract_deltas(rm, asg, max_migrations=budget,
                                   task_cost=cost, task_margin=margin)
    pd = port_deltas.extract_deltas(pm, asg, max_migrations=budget,
                                    task_cost=cost, task_margin=margin)
    assert delta_rows(rd) == delta_rows(pd)
    assert rd.counts == pd.counts
