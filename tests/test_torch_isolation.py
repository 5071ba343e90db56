"""The port stands alone: no JAX, no reference package, no silent CPU.

- every ``poseidon_tpu_torch`` module (and ``chip_smoke.py``) imports in
  a fresh interpreter where ``jax`` cannot be imported, and afterwards
  no ``poseidon_tpu`` / ``poseidon_tpu.*`` module is loaded (the check
  minds the shared name prefix: ``poseidon_tpu_torch`` is not one);
- ``ResidentSolver()`` with no device on a host without CUDA raises and
  names ``device="cpu"``;
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
