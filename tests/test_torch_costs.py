"""Differential tests: the port's cost models vs the JAX reference.

On the same builder arrays and knowledge-base inputs, the port's
``quincy`` and ``trivial`` price every arc exactly as the reference does
(exact equality, int32), with preemption off and on. Models not ported
yet keep their registry names and raise instead of pricing.
"""

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
@pytest.mark.parametrize("model", ["quincy", "trivial"])
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


@pytest.mark.parametrize("name", ["random", "octopus", "wharemap", "coco",
                                  6, "5"])
def test_unported_model_raises(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        port.get_cost_model(name)
    resolved = port.resolve_cost_model_name(name)
    with pytest.raises(NotImplementedError, match="not ported"):
        port.COST_MODELS[resolved](None)


def test_unknown_model_raises_keyerror():
    with pytest.raises(KeyError):
        port.get_cost_model("nope")
    with pytest.raises(KeyError):
        port.get_cost_model(2)
