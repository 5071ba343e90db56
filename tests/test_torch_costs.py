"""Differential tests: the port's cost models vs the JAX reference.

On the same builder arrays and knowledge-base inputs, each of the six
models prices every arc exactly as the reference's model does (exact
equality, int32), with preemption off and on; the float models
(octopus, wharemap, coco) also at float edges: loads whose x100 is not
exact in float32, zero free memory, zero usage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poseidon_tpu.models.costs as ref
import poseidon_tpu_torch.models.costs as port
from poseidon_tpu.graph.builder import FlowGraphBuilder as RefBuilder
from poseidon_tpu.synth import make_synthetic_cluster
from poseidon_tpu_torch.graph.builder import FlowGraphBuilder as PortBuilder

from tests.helpers import random_cluster
from tests.test_torch_graph import to_port_cluster


def _kwargs(cluster, rng):
    pending = cluster.pending()
    M = len(cluster.machines)
    return dict(
        task_cpu_milli=np.array([int(t.cpu_request * 1000) for t in pending]),
        task_mem_kb=np.array([t.memory_request_kb for t in pending]),
        machine_load=rng.random(M).astype(np.float32),
        machine_mem_free=rng.random(M).astype(np.float32),
        machine_used_slots=rng.integers(0, 5, M).astype(np.int32),
    )


def _cases():
    out = {}
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        out[f"random{seed}"] = random_cluster(
            rng, int(rng.integers(3, 30)), int(rng.integers(10, 150))
        )
    out["synth_running"] = make_synthetic_cluster(
        40, 300, seed=3, running_fraction=0.25, machines_per_rack=8
    )
    return out


CASES = _cases()


@pytest.mark.parametrize("preemption", [False, True])
@pytest.mark.parametrize("model", sorted(ref.COST_MODELS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_arc_costs_equal(name, model, preemption):
    cluster = CASES[name]
    rnet, rmeta = RefBuilder(preemption=preemption).build(cluster)
    pnet, pmeta = PortBuilder(preemption=preemption).build(
        to_port_cluster(cluster)
    )
    kw = _kwargs(cluster, np.random.default_rng(len(name)))
    want = np.asarray(
        ref.get_cost_model(model)(ref.build_cost_inputs(rnet, rmeta, **kw))
    )
    inputs = port.build_cost_inputs(pnet, pmeta, device="cpu", **kw)
    got = port.get_cost_model(model)(inputs)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def test_cost_inputs_equal():
    """The padded host inputs themselves, floors included."""
    cluster = CASES["synth_running"]
    _, rmeta = RefBuilder().build_arrays(cluster)
    _, pmeta = PortBuilder().build_arrays(to_port_cluster(cluster))
    kw = _kwargs(cluster, np.random.default_rng(0))
    r = ref.build_cost_inputs_host(2048, rmeta, t_min=512, m_min=64, **kw)
    p = port.build_cost_inputs_host(2048, pmeta, t_min=512, m_min=64, **kw)
    for f in ("kind", "task", "machine", "weight", "discount", "valid",
              "task_wait", "task_running", "task_input", "task_cpu",
              "task_mem_kb", "task_usage", "machine_load",
              "machine_mem_free", "machine_used_slots"):
        a, b = getattr(r, f), getattr(p, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_registry_names_match_reference():
    assert sorted(port.COST_MODELS) == sorted(ref.COST_MODELS)
    assert port.COST_MODEL_SELECTORS == ref.COST_MODEL_SELECTORS
    assert port.get_cost_model(3) is port.quincy_cost
    assert port.get_cost_model("0") is port.trivial_cost


def _edge_inputs(rng, E=4096, Tp=512, Mp=128):
    """Raw pricing inputs at the float models' edges: machine loads
    whose x100 is not exact in float32 (0.29, 0.57, 0.58, 0.07 ...),
    loads of 0 and 1 (cpu headroom at its 0.05 floor), free memory of 0
    and just under the 0.05 floor, zero usage and zero requests beside
    large ones. Every kind (padding -1 included) on every arc."""
    edge_load = np.array([0.0, 1.0, 0.29, 0.57, 0.58, 0.07, 0.14, 0.035,
                          0.95, 0.999, 0.01, 0.555], np.float32)
    load = rng.random(Mp).astype(np.float32)
    load[: len(edge_load)] = edge_load
    mem_free = rng.random(Mp).astype(np.float32)
    mem_free[:6] = [0.0, 0.0, 0.05, 0.0499, 1.0, 0.3]
    usage = (rng.random(Tp) * 9).astype(np.float32)
    usage[: Tp // 4] = 0.0
    cpu = rng.integers(0, 20_000, Tp).astype(np.int32)
    cpu[: Tp // 8] = 0
    mem = rng.integers(0, 1 << 24, Tp).astype(np.int32)
    mem[Tp // 8: Tp // 4] = 0
    return dict(
        kind=rng.integers(-1, 9, E).astype(np.int32),
        task=rng.integers(0, Tp, E).astype(np.int32),
        machine=rng.integers(0, Mp, E).astype(np.int32),
        weight=rng.integers(0, 100, E).astype(np.int32),
        discount=rng.integers(0, 3, E).astype(np.int32),
        valid=rng.random(E) < 0.9,
        task_wait=rng.integers(0, 100, Tp).astype(np.int32),
        task_running=rng.random(Tp) < 0.3,
        task_input=rng.integers(0, 500, Tp).astype(np.int32),
        task_cpu=cpu, task_mem_kb=mem, task_usage=usage,
        machine_load=load, machine_mem_free=mem_free,
        machine_used_slots=rng.integers(0, 20, Mp).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("model", ["octopus", "wharemap", "coco"])
def test_float_models_equal_at_edges(model, seed):
    raw = _edge_inputs(np.random.default_rng(seed))
    want = np.asarray(ref.get_cost_model(model)(
        ref.CostInputs(**{k: jnp.asarray(v) for k, v in raw.items()})
    ))
    got = port.get_cost_model(model)(
        port.CostInputs(**{k: torch.from_numpy(v) for k, v in raw.items()})
    )
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    # the edges were reached: some arcs priced from a nonzero score
    assert (want > 0).any()


def test_unknown_model_raises_keyerror():
    with pytest.raises(KeyError):
        port.get_cost_model("nope")
    with pytest.raises(KeyError):
        port.get_cost_model(2)
