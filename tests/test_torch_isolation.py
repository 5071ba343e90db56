"""The port stands alone: no JAX, no reference package, no silent CPU.

- every ``poseidon_tpu_torch`` module (and ``chip_smoke.py``) imports in
  a fresh interpreter where ``jax`` cannot be imported, and afterwards
  no ``poseidon_tpu`` / ``poseidon_tpu.*`` module is loaded (the check
  minds the shared name prefix: ``poseidon_tpu_torch`` is not one); the
  daemon's modules, named one by one, do so too, and its command lines
  start;
- ``ResidentSolver()`` with no device on a host without CUDA raises and
  names ``device="cpu"``, and so do a mesh of CUDA devices and the
  general lane's entry points;
- the port's C++ oracle source is a byte-identical copy of the
  reference's, so the two cannot drift.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import poseidon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    poseidon_tpu_torch.__path__, prefix="poseidon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(
    n for n in sys.modules
    if n == "poseidon_tpu" or n.startswith("poseidon_tpu.")
)
jax_loaded = sorted(n for n in sys.modules
                    if (n == "jax" or n.startswith("jax.") or n == "jaxlib"
                        or n.startswith("jaxlib."))
                    and sys.modules[n] is not None)
print(json.dumps({"n": len(names), "leaked": leaked, "jax": jax_loaded}))
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] >= 20, got
    assert got["leaked"] == [], got
    assert got["jax"] == [], got


DAEMON_MODULES = (
    "poseidon_tpu_torch.cli",
    "poseidon_tpu_torch.trace",
    "poseidon_tpu_torch.bridge",
    "poseidon_tpu_torch.bridge.bridge",
    "poseidon_tpu_torch.apiclient",
    "poseidon_tpu_torch.apiclient.client",
    "poseidon_tpu_torch.apiclient.fake_server",
    "poseidon_tpu_torch.apiclient.watch",
    "poseidon_tpu_torch.obs",
    "poseidon_tpu_torch.obs.lifecycle",
    "poseidon_tpu_torch.obs.metrics",
    "poseidon_tpu_torch.obs.report",
    "poseidon_tpu_torch.obs.server",
    "poseidon_tpu_torch.obs.spans",
    "poseidon_tpu_torch.ha",
    "poseidon_tpu_torch.ha.outbox",
)

_DAEMON_PROBE = r"""
import importlib, json, runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
# the daemon's and the trace tool's command lines start without jax
for mod in ("poseidon_tpu_torch.cli", "poseidon_tpu_torch.trace"):
    sys.argv = [mod, "--help"]
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (mod, e.code)
from poseidon_tpu_torch.obs import build_info
build_info(device="cpu")
leaked = sorted(
    n for n in sys.modules
    if n == "poseidon_tpu" or n.startswith("poseidon_tpu.")
)
jax_loaded = sorted(n for n in sys.modules
                    if (n == "jax" or n.startswith("jax."))
                    and sys.modules[n] is not None)
print(json.dumps({"leaked": leaked, "jax": jax_loaded}))
"""


def test_daemon_modules_import_and_start_without_jax():
    """Every module of the daemon's path imports with jax blocked, and
    ``python -m poseidon_tpu_torch.cli --help`` and ``... .trace
    --help`` run so."""
    out = subprocess.run(
        [sys.executable, "-c", _DAEMON_PROBE, json.dumps(DAEMON_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "jax": []}, got


SLICE_MODULES = (
    "poseidon_tpu_torch.service",
    "poseidon_tpu_torch.service.dispatch",
    "poseidon_tpu_torch.service.service",
    "poseidon_tpu_torch.service.serve",
    "poseidon_tpu_torch.ops.batch",
    "poseidon_tpu_torch.kernels.perturb",
    "poseidon_tpu_torch.kernels.stream_commit",
)


def test_stream_service_and_batch_modules_import_without_jax():
    """The stream, what-if and service modules import with jax blocked,
    and the daemon's ``--help`` (which now lists the stream and serve
    flags) runs so."""
    out = subprocess.run(
        [sys.executable, "-c", _DAEMON_PROBE, json.dumps(SLICE_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "jax": []}, got


SCALE_MODULES = (
    "poseidon_tpu_torch.graph.aggregate",
    "poseidon_tpu_torch.parallel",
    "poseidon_tpu_torch.parallel.mesh",
    "poseidon_tpu_torch.parallel.sharded",
    "poseidon_tpu_torch.kernels.gap_rows",
)


def test_scale_lane_modules_import_without_jax():
    """The scale lane's modules (aggregation, the mesh, K8's wrapper)
    import with jax blocked, and the daemon's ``--help`` (which lists
    --mesh_width, --aggregate_classes and --topk_prefs) runs so."""
    out = subprocess.run(
        [sys.executable, "-c", _DAEMON_PROBE, json.dumps(SCALE_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "jax": []}, got


GENERAL_MODULES = (
    "poseidon_tpu_torch.solver",
    "poseidon_tpu_torch.ops.cost_scaling",
    "poseidon_tpu_torch.ops.ssp",
    "poseidon_tpu_torch.graph.dimacs",
    "poseidon_tpu_torch.kernels.cs_sweep",
    "poseidon_tpu_torch.kernels.bf_relax",
    "poseidon_tpu_torch.kernels.ssp_augment",
)


def test_general_lane_modules_import_without_jax():
    """The general-graph lane (cost-scaling, SSP, their kernels K9-K11,
    the front door, DIMACS input) imports with jax blocked."""
    out = subprocess.run(
        [sys.executable, "-c", _DAEMON_PROBE, json.dumps(GENERAL_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "jax": []}, got


def test_general_lane_entry_points_default_to_the_card(monkeypatch):
    """``solve_cost_scaling``, ``solve_ssp``, ``solve_transport_dense``
    and ``solve_scheduling`` with no device want the card, and raise
    naming ``device="cpu"`` without one."""
    from poseidon_tpu_torch import solve_scheduling
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.dimacs import read_dimacs
    from poseidon_tpu_torch.ops import solve_ssp
    from poseidon_tpu_torch.ops.cost_scaling import solve_cost_scaling
    from poseidon_tpu_torch.ops.dense_auction import solve_transport_dense
    from poseidon_tpu_torch.cluster import ClusterState

    net = read_dimacs("p min 2 1\nn 1 3\nn 2 -3\na 1 2 0 5 2\n")
    _, meta = FlowGraphBuilder().build(ClusterState(machines=[], tasks=[]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: solve_cost_scaling(net), lambda: solve_ssp(net),
                 lambda: solve_scheduling(net, meta),
                 lambda: solve_transport_dense(object())):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert solve_scheduling(net, meta, device="cpu").cost == 6
    assert solve_ssp(net, device="cpu").routed == 3


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """``make_mesh`` without devices wants CUDA devices and raises
    without them; a CPU solver lays its mesh out on the CPU only when
    asked for the CPU."""
    from poseidon_tpu_torch.ops.resident import ResidentSolver
    from poseidon_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ResidentSolver(mesh_width=2)
    solver = ResidentSolver(device="cpu", mesh_width=2)
    assert {d.type for d in solver._mesh.devices} == {"cpu"}


def test_batch_and_service_entry_points_default_to_the_card(monkeypatch):
    from poseidon_tpu_torch.ops.batch import solve_heterogeneous
    from poseidon_tpu_torch.service import SchedulingService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SchedulingService()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        solve_heterogeneous([object()])
    assert SchedulingService(device="cpu").dispatcher.device.type == "cpu"


def test_package_sources_never_name_jax_or_reference_imports():
    """A static guard beside the dynamic one: no source line of the port
    imports jax or the reference package."""
    bad = []
    for path in sorted((REPO / "poseidon_tpu_torch").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            mod = s.split()[1]
            if mod in ("jax", "jaxlib") or mod.startswith(("jax.", "jaxlib.")):
                bad.append(f"{path}:{i}: {s}")
            if mod == "poseidon_tpu" or mod.startswith("poseidon_tpu."):
                bad.append(f"{path}:{i}: {s}")
    assert not bad, bad


def test_default_device_is_the_card(monkeypatch):
    from poseidon_tpu_torch.ops.resident import ResidentSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ResidentSolver()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ResidentSolver(device="cuda")
    assert ResidentSolver(device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_the_twin_only_for_cpu_tensors():
    """A wrapper picks its path by the tensors' device alone, and refuses
    tensors split across devices."""
    from poseidon_tpu_torch.kernels import KERNELS, reset_launch_counts
    from poseidon_tpu_torch.kernels._args import on_card
    from poseidon_tpu_torch.kernels.row_options import row_options

    reset_launch_counts()
    c = torch.randint(0, 100, (8, 16), dtype=torch.int32)
    p = torch.zeros(16, dtype=torch.int32)
    row_options(c, p)
    assert all(k.launches == 0 for k in KERNELS)
    assert on_card(c, p) is False
    with pytest.raises(ValueError):
        on_card(c, p.to("meta"))


def test_oracle_source_is_a_byte_identical_copy():
    ref = (REPO / "poseidon_tpu" / "oracle" / "mcmf_oracle.cc").read_bytes()
    port = (REPO / "poseidon_tpu_torch" / "oracle" /
            "mcmf_oracle.cc").read_bytes()
    assert ref == port


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


HA_OBS_CHAOS_MODULES = (
    "poseidon_tpu_torch.chaos",
    "poseidon_tpu_torch.chaos.scenarios",
    "poseidon_tpu_torch.ha.checkpoint",
    "poseidon_tpu_torch.ha.journal",
    "poseidon_tpu_torch.ha.standby",
    "poseidon_tpu_torch.obs.flightrec",
    "poseidon_tpu_torch.obs.replay",
    "poseidon_tpu_torch.obs.explain",
    "poseidon_tpu_torch.obs.audit",
    "poseidon_tpu_torch.obs.slo",
)

_REPLAY_HELP_PROBE = r"""
import runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.argv = ["poseidon_tpu_torch.obs.replay", "--help"]
try:
    runpy.run_module("poseidon_tpu_torch.obs.replay", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = [n for n in sys.modules
          if n == "poseidon_tpu" or n.startswith("poseidon_tpu.")]
assert not leaked, leaked
"""


def test_crash_safety_observability_and_chaos_import_without_jax():
    """The crash-safety, observability and chaos modules import with
    jax blocked (the daemon's ``--help``, which lists their flags, runs
    so), and ``python -m poseidon_tpu_torch.obs.replay --help`` works."""
    out = subprocess.run(
        [sys.executable, "-c", _DAEMON_PROBE,
         json.dumps(HA_OBS_CHAOS_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "jax": []}, got
    out = subprocess.run(
        [sys.executable, "-c", _REPLAY_HELP_PROBE], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "dump" in out.stdout


# the 14 flags of ROADMAP Queue 1 item 7, each at a non-default value
ITEM7_FLAGS = {
    "flight_recorder": "true", "flight_dir": "fr",
    "flight_max_dumps": "2", "explain": "pod-00", "audit_every": "2",
    "slo": "ready", "slo_short_window": "3", "slo_long_window": "30",
    "slo_burn_threshold": "2.0", "checkpoint_dir": "ckpt",
    "checkpoint_every": "5", "restore": "false", "standby": "true",
    "standby_lease_s": "5",
}


def test_unported_flags_table_is_empty_and_item7_flags_parse():
    from poseidon_tpu_torch import cli

    assert cli.UNPORTED_FLAGS == {}
    args = cli.parse_args(
        [f"--{k}={v}" for k, v in ITEM7_FLAGS.items()] + ["--device=cpu"]
    )
    defaults = cli.parse_args([])
    assert cli.unported_flags(args) == []
    for name in ITEM7_FLAGS:
        assert getattr(args, name) != getattr(defaults, name), name


_CHECKER_PROBE = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
import poseidon_tpu_torch.adversarial
import poseidon_tpu_torch.analysis
import poseidon_tpu_torch.analysis.__main__
from poseidon_tpu_torch.analysis import (
    locks, optrace_check, padding_taint, recompile, rules, threads,
)
leaked = sorted(
    n for n in sys.modules
    if n == "poseidon_tpu" or n.startswith("poseidon_tpu.")
)
print(json.dumps({"leaked": leaked,
                  "main": poseidon_tpu_torch.analysis.__main__.__name__}))
"""


def test_checker_and_sweep_import_without_jax():
    """The contract checker and the adversarial sweep stand alone too:
    they import with jax blocked and load nothing of the reference."""
    out = subprocess.run(
        [sys.executable, "-c", _CHECKER_PROBE], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == [], got


def test_checker_and_sweep_entry_points_default_to_the_card(monkeypatch):
    """The op-trace audit and the adversarial sweep run tensors: without
    a device they want the card, and raise naming device="cpu"."""
    from poseidon_tpu_torch import adversarial
    from poseidon_tpu_torch.analysis import optrace_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        optrace_check.record_entries()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        adversarial.sweep(1)
