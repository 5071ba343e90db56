"""The adversarial fuse sweep on the port, beside the reference's.

- the port's ``synth.random_cluster`` (its own copy of the reference's
  test helper) draws the same clusters as ``tests.helpers.
  random_cluster``, field by field, over several seeds and shapes, and
  leaves the generator in the same state;
- the sweep's first 12 trials (two per cost model) through both
  packages on the CPU: the same converged flags, rounds and dense
  costs; every converged cost equal to the C++ oracle's, every
  exhausted one exact through the port's front door;
- (slow) all 240 trials through both packages: the same exhausted
  list, pinned in ``chip_smoke.py`` as ``ADVERSARIAL_EXHAUSTED``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from poseidon_tpu.graph.builder import FlowGraphBuilder
from poseidon_tpu.ops.dense_auction import solve_transport_dense
from poseidon_tpu.ops.transport import extract_instance
from poseidon_tpu.oracle import solve_oracle
from poseidon_tpu_torch import adversarial, synth
from tests.helpers import price, random_cluster
from tests.test_torch_graph import build_reference_oracle

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One intra-op thread (the auction's CPU loop runs many tiny ops)
    and the reference's oracle binary built whole before use."""
    build_reference_oracle()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cluster):
    return (
        [dataclasses.asdict(m) for m in cluster.machines],
        [{**dataclasses.asdict(t), "phase": t.phase.value}
         for t in cluster.tasks],
    )


@pytest.mark.parametrize("seed,M,T", [
    (0, 2, 2), (1, 3, 150), (7, 39, 149), (20260730, 17, 60), (5, 40, 3),
])
def test_random_cluster_matches_reference(seed, M, T):
    r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        assert _fields(synth.random_cluster(p_rng, M, T)) == \
            _fields(random_cluster(r_rng, M, T))
    assert p_rng.integers(0, 2**31) == r_rng.integers(0, 2**31)


def _reference_trials(n: int) -> list[tuple]:
    """(model, M, T, converged, rounds, cost, oracle cost) of the
    reference script's first ``n`` trials (its dense solve on the CPU)."""
    out = []
    for trial, model, M, T, rng in adversarial.shapes(n):
        cluster = random_cluster(rng, M, T)
        net, meta = FlowGraphBuilder().build(cluster)
        net = price(net, meta, model, cluster)
        res, _ = solve_transport_dense(extract_instance(net, meta))
        o = solve_oracle(net, algorithm="cost_scaling")
        out.append((model, M, T, bool(res.converged), int(res.rounds),
                    int(res.cost), int(o.cost)))
    return out


def test_first_twelve_trials_match_reference():
    ref = _reference_trials(12)
    got, launches = adversarial.sweep(12, CPU, workers=2)
    assert launches and not any(launches.values())  # the CPU runs twins
    assert [r.model for r in got] == list(adversarial.MODELS) * 2
    for r, (model, M, T, conv, rounds, cost, ocost) in zip(got, ref):
        assert (r.model, r.M, r.T) == (model, M, T)
        assert (r.converged, r.rounds, r.cost) == (conv, rounds, cost), r
        assert r.oracle_cost == ocost
        assert not r.wrong, r
        if r.converged:
            assert r.cost == r.oracle_cost and r.front_cost is None
        else:
            assert r.rounds == 20_000 and r.front_cost == r.oracle_cost


@pytest.mark.slow
def test_full_sweep_exhausted_list_matches_reference():
    """All 240 trials in both packages: the same exhausted list (the
    source of ``chip_smoke.ADVERSARIAL_EXHAUSTED``), no wrong trial."""
    ref = _reference_trials(adversarial.TRIALS)
    got, _ = adversarial.sweep(adversarial.TRIALS, CPU)
    ref_ex = [(i, m, M, T) for i, (m, M, T, conv, *_r) in enumerate(ref)
              if not conv]
    assert adversarial.exhausted(got) == ref_ex
    assert [r.trial for r in got if r.wrong] == []
    for r, (_m, _M, _T, conv, rounds, cost, _o) in zip(got, ref):
        assert (r.converged, r.rounds, r.cost) == (conv, rounds, cost)
    import chip_smoke

    assert chip_smoke.ADVERSARIAL_EXHAUSTED == tuple(ref_ex)
