"""Differential tests: the scale lane end to end, the port beside the
reference (the cases of ``tests/test_scale.py``).

Both packages run the same clusters (each built by its own ``synth``
from the same seeds) through ``ResidentSolver`` and ``SchedulerBridge``
with ``mesh_width``, ``aggregate_classes`` and ``topk_prefs``. The
reference's mesh is its 8 forced host devices; the port's is
``[torch.device("cpu")] * w`` (``device="cpu"`` with ``mesh_width=w``
lays it out so, or ``mesh_devices`` names it). Every integer output
(assignment, channels, cost, rounds, phases, backend) must be equal
between the packages and across widths 0, 1, 2 and 8 (tolerance 0);
aggregated rounds equal the oracle's cost.
"""

from __future__ import annotations

import io
import json
import re

import numpy as np
import pytest
import torch

import poseidon_tpu.bridge as ref_bridge
import poseidon_tpu.ops.dense_auction as ref_da
import poseidon_tpu.ops.resident as ref_res
import poseidon_tpu.synth as ref_synth
import poseidon_tpu.trace as ref_trace
import poseidon_tpu_torch.bridge as port_bridge
import poseidon_tpu_torch.ops.dense_auction as port_da
import poseidon_tpu_torch.ops.resident as port_res
import poseidon_tpu_torch.synth as port_synth
import poseidon_tpu_torch.trace as port_trace
from poseidon_tpu.graph.builder import FlowGraphBuilder as RefBuilder
from poseidon_tpu_torch.graph.builder import FlowGraphBuilder as PortBuilder
from poseidon_tpu_torch.obs.metrics import MetricsRegistry, SchedulerMetrics
from poseidon_tpu_torch.oracle import solve_oracle
from tests.helpers import price
from tests.test_torch_cost_scaling import to_port
from tests.test_torch_graph import build_reference_oracle


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    """The reference's side of these tests can solve on its C++ oracle,
    which it builds in place on first use: have the binary whole first
    (``tests/test_torch_graph.py``'s ``build_reference_oracle``)."""
    build_reference_oracle()


pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU loops run thousands of tiny ops; one intra-op
    thread keeps them from waiting on a pool the other test workers
    share (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round_inputs(cluster, builder):
    arrays, meta = builder().build_arrays(cluster)
    pending = cluster.pending()
    kw = dict(
        task_cpu_milli=np.array(
            [int(t.cpu_request * 1000) for t in pending]),
        task_mem_kb=np.array([t.memory_request_kb for t in pending]),
    )
    return arrays, meta, kw


def outcome_record(out) -> tuple:
    return (out.backend, out.cost, out.assignment.tolist(),
            out.channel.tolist(), out.rounds, out.phases)


def run_both(make_cluster, rounds=1, model="quincy", **opts):
    """``rounds`` resident rounds per package (warm after the first);
    returns (reference records, port records, port solver)."""
    out = {}
    solver = None
    for pkg in ("ref", "port"):
        synth, builder = ((ref_synth, RefBuilder) if pkg == "ref"
                          else (port_synth, PortBuilder))
        arrays, meta, kw = _round_inputs(make_cluster(synth), builder)
        if pkg == "ref":
            ref_opts = dict(opts)
            if "mesh_devices" in ref_opts:
                ref_opts["mesh_width"] = len(ref_opts.pop("mesh_devices"))
            solver = ref_res.ResidentSolver(small_to_oracle=False,
                                            **ref_opts)
        else:
            solver = port_res.ResidentSolver(device="cpu",
                                             small_to_oracle=False, **opts)
        out[pkg] = [
            outcome_record(solver.run_round(
                arrays, meta, cost_model=model, cost_input_kwargs=kw))
            for _ in range(rounds)
        ]
    return out["ref"], out["port"], solver


def synthetic(*args, **kw):
    return lambda synth: synth.make_synthetic_cluster(*args, **kw)


def config8(*args, **kw):
    return lambda synth: synth.config8_scale(*args, **kw)


class TestShardedResidentRound:
    @pytest.mark.parametrize("opts", [
        {"mesh_width": 1}, {"mesh_width": 2}, {"mesh_width": 8},
    ])
    def test_mesh_bit_identical_to_single_device(self, opts):
        make = synthetic(48, 500, seed=21, prefs_per_task=2)
        ref_plain, port_plain, _ = run_both(make)
        ref_mesh, port_mesh, solver = run_both(make, **opts)
        assert port_plain == ref_plain
        assert port_mesh == ref_mesh == port_plain
        assert port_mesh[0][0] == "dense_auction"
        assert solver.mesh_width == opts["mesh_width"]

    def test_mesh8_warm_rounds_stay_resident(self):
        make = synthetic(48, 400, seed=23, prefs_per_task=1)
        ref_out, port_out, solver = run_both(make, rounds=2, mesh_width=8)
        assert port_out == ref_out
        assert solver.warm is not None
        assert port_out[1][0] == "dense_auction"
        assert port_out[1][1] == port_out[0][1]

    def test_mesh_devices_lists_the_mesh(self):
        make = synthetic(48, 400, seed=23, prefs_per_task=1)
        _, by_width, _ = run_both(make, mesh_width=4)
        _, by_list, solver = run_both(make, mesh_devices=[CPU] * 4)
        assert by_list == by_width
        assert solver.mesh_width == 4
        with pytest.raises(ValueError, match="power of two"):
            port_res.ResidentSolver(device="cpu", mesh_devices=[CPU] * 3)

    def test_mesh8_aggregated_exact_vs_oracle(self):
        make = config8(64, 512, seed=5, machines_per_rack=16, n_skus=2)
        ref_out, port_out, _ = run_both(
            make, mesh_width=8, aggregate_classes=True, topk_prefs=2)
        assert port_out == ref_out
        assert port_out[0][0] == "dense_auction"
        cluster = make(ref_synth)
        net, meta = RefBuilder().build(cluster)
        net = price(net, meta, "quincy", cluster)
        assert port_out[0][1] == solve_oracle(
            to_port(net), algorithm="cost_scaling").cost

    @pytest.mark.parametrize("width", [0, 1, 2])
    def test_downsampled_config8_widths_equal(self, width):
        make = config8(256, 2048, seed=1, machines_per_rack=32, n_skus=2)
        ref_out, port_out, _ = run_both(
            make, rounds=2, mesh_width=width, aggregate_classes=True,
            topk_prefs=2)
        assert port_out == ref_out
        assert all(r[0] == "dense_auction" for r in port_out)


def _drive_bridge(pkg, check_dense, **flags):
    synth = ref_synth if pkg == "ref" else port_synth
    cluster = synth.config8_scale(32, 300, seed=7, machines_per_rack=8,
                                  n_skus=2)
    mod = ref_bridge if pkg == "ref" else port_bridge
    extra = {} if pkg == "ref" else {"device": "cpu"}
    br = mod.SchedulerBridge(cost_model="quincy", small_to_oracle=False,
                             **flags, **extra)
    br.observe_nodes(cluster.machines)
    br.observe_pods(cluster.tasks)
    out = []
    for _ in range(2):
        res = br.run_scheduler()
        for uid, m in res.bindings.items():
            br.confirm_binding(uid, m)
        if check_dense and res.stats.pods_pending:
            assert res.stats.backend == "dense_auction"
            assert res.stats.degrades_total == 0
        out.append((res.stats.cost, res.stats.backend, dict(res.bindings)))
    return out, br


class TestAggregatedBridgeRounds:
    def test_bridge_rounds_with_aggregation_match_plain(self):
        # the plain lane of this tied instance runs the auction's whole
        # fuse and degrades to the exact oracle (both packages; the
        # port's plain rounds are held to the reference elsewhere), so
        # only the reference drives it here
        ref_plain, _ = _drive_bridge("ref", False)
        flags = dict(aggregate_classes=True, topk_prefs=2, mesh_width=1)
        ref_scaled, _ = _drive_bridge("ref", True, **flags)
        port_scaled, br = _drive_bridge("port", True, **flags)
        assert port_scaled == ref_scaled
        assert [c for c, _b, _m in port_scaled] == \
            [c for c, _b, _m in ref_plain]
        assert br.round_flags["mesh_width"] == 1
        assert br.round_flags["aggregate_classes"] is True
        assert br.round_flags["topk_prefs"] == 2

    def test_aggregation_rejects_index_hashing_model(self):
        for pkg, synth, builder in (("ref", ref_synth, RefBuilder),
                                    ("port", port_synth, PortBuilder)):
            arrays, meta, kw = _round_inputs(
                synth.make_synthetic_cluster(16, 80, seed=9), builder)
            solver = (
                ref_res.ResidentSolver(small_to_oracle=False,
                                       aggregate_classes=True)
                if pkg == "ref" else port_res.ResidentSolver(
                    device="cpu", small_to_oracle=False,
                    aggregate_classes=True))
            with pytest.raises(ValueError) as ei:
                solver.run_round(arrays, meta, cost_model="random",
                                 cost_input_kwargs=kw)
            assert "'random' hashes the machine index" in str(ei.value)


class TestDegradeObservability:
    def test_degrade_counted_and_traced(self, monkeypatch):
        monkeypatch.setattr(ref_da, "DENSE_TABLE_BUDGET_BYTES", 1024)
        monkeypatch.setattr(port_da, "DENSE_TABLE_BUDGET_BYTES", 1024)
        got = {}
        for pkg in ("ref", "port"):
            synth, mod, trace = (
                (ref_synth, ref_bridge, ref_trace) if pkg == "ref"
                else (port_synth, port_bridge, port_trace))
            extra = {} if pkg == "ref" else {"device": "cpu"}
            sink = io.StringIO()
            cluster = synth.make_synthetic_cluster(
                8, 40, seed=11, max_tasks_per_machine=8)
            br = mod.SchedulerBridge(
                cost_model="trivial", small_to_oracle=False,
                trace=trace.TraceGenerator(sink=sink), mesh_width=2,
                aggregate_classes=True, **extra,
            )
            br.observe_nodes(cluster.machines)
            br.observe_pods(cluster.tasks)
            res = br.run_scheduler()
            res2 = br.run_scheduler()
            degrades = [
                e["detail"]["why"] for e in map(
                    json.loads, sink.getvalue().splitlines())
                if e["event"] == "DEGRADE"
            ]
            got[pkg] = (res.stats.backend, res.stats.degrades_total,
                        res2.stats.degrades_total, res.stats.cost,
                        degrades)
        assert got["port"] == got["ref"]
        assert got["port"][:3] == ("oracle:memory-envelope", 1, 2)


class TestBudgetMessage:
    def test_suggests_fitting_mesh_width(self):
        with pytest.raises(port_da.DenseMemoryTooLarge) as ei:
            port_da.check_table_budget(524288, 16384)
        msg = str(ei.value)
        assert "--mesh_width=" in msg and "--aggregate_classes" in msg
        w = int(re.search(r"--mesh_width=(\d+)", msg).group(1))
        port_da.check_table_budget(524288, 16384, mesh_width=w)
        with pytest.raises(port_da.DenseMemoryTooLarge):
            port_da.check_table_budget(524288, 16384, mesh_width=w // 2)

    def test_mesh_width_divides_the_per_device_estimate(self):
        for da in (ref_da, port_da):
            with pytest.raises(da.DenseMemoryTooLarge):
                da.check_table_budget(65536, 16384)
            da.check_table_budget(65536, 16384, mesh_width=8)
        assert port_da._budget_need(65536, 16384, 1, 0, 0, 8) \
            == ref_da._budget_need(65536, 16384, 1, 0, 0, 8)

    def test_hopeless_shape_says_so(self):
        with pytest.raises(port_da.DenseMemoryTooLarge) as ei:
            port_da.check_table_budget(2**22, 2**22)
        assert "no practical mesh width" in str(ei.value)
        assert "--aggregate_classes" in str(ei.value)

    def test_config8_unaggregated_table_is_refused(self):
        # config 8 all-pairs: [524288, 65536] i32 = 128 GiB
        with pytest.raises(port_da.DenseMemoryTooLarge) as ei:
            port_da.check_table_budget(524288, 65536)
        assert "131072 MiB/device" in str(ei.value)
        # aggregated to 128 rack classes it fits one device
        port_da.check_table_budget(524288, 128)

    def test_predicted_bytes_metric(self):
        metrics = SchedulerMetrics(MetricsRegistry())
        cluster = port_synth.make_synthetic_cluster(48, 400, seed=23)
        arrays, meta, kw = _round_inputs(cluster, PortBuilder)
        solver = port_res.ResidentSolver(device="cpu", small_to_oracle=False,
                                         mesh_width=2, metrics=metrics)
        solver.run_round(arrays, meta, cost_model="quincy",
                         cost_input_kwargs=kw)
        Tp, Mp = solver.pad_floors["t"], solver.pad_floors["m"]
        want = port_da._budget_need(Tp, Mp, 1, 0, 0, 2)
        assert f'poseidon_device_hbm_bytes{{kind="predicted"}} {want}' \
            in metrics.registry.render()


@pytest.mark.parametrize("argv", [
    ["--max_rounds=2", "--aggregate_classes=true", "--topk_prefs=2",
     "--mesh_width=2"],
    ["--max_rounds=2", "--watch=true", "--mesh_width=1"],
])
def test_cli_scale_lane_posts_the_same_bindings(argv):
    """The daemon with the scale flags on (past the small-instance
    bound, so rounds take the dense route): both CLIs POST the same
    bindings and leave the same pod states."""
    from tests.test_torch_daemon import PORT, REF, run_cli

    ref = run_cli(REF, argv, n_nodes=70, n_pods=300)
    port = run_cli(PORT, argv, n_nodes=70, n_pods=300)
    assert ref[0] == port[0] == 0
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert len(port[1]) > 0
