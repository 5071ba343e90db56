"""Python wrapper around the C++ MCMF oracle binary.

The oracle is the exact CPU solver behind every degrade path, and the
independent plain reference the card's objective is checked against.
Its source (``mcmf_oracle.cc``) is compiled with ``g++`` on first use
into ``oracle/_build/`` beside it; no network, no install.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pathlib
import subprocess

import numpy as np

from poseidon_tpu_torch.graph.dimacs import parse_flow_output, write_dimacs
from poseidon_tpu_torch.graph.network import FlowNetwork

log = logging.getLogger(__name__)

_ORACLE_DIR = pathlib.Path(__file__).resolve().parent
_SOURCE = _ORACLE_DIR / "mcmf_oracle.cc"
_BINARY = _ORACLE_DIR / "_build" / "mcmf_oracle"


class OracleInfeasible(RuntimeError):
    """The instance's supplies cannot be routed."""


@dataclasses.dataclass(frozen=True)
class OracleResult:
    cost: int
    flows: np.ndarray       # int64 per real input arc, input order
    solve_ms: float         # solver-internal timing
    algorithm: str


def ensure_built() -> pathlib.Path:
    """Compile the oracle if the binary is missing or older than its
    source. The binary is written under a temporary name and renamed, so
    concurrent test workers never run a half-written file."""
    if _BINARY.exists() and _BINARY.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return _BINARY
    _BINARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = _BINARY.with_name(f"{_BINARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"oracle build failed:\n{proc.stderr}")
    os.replace(tmp, _BINARY)
    return _BINARY


def solve_oracle(
    net: FlowNetwork,
    algorithm: str = "ssp",
    timeout_s: float = 1000.0,
) -> OracleResult:
    """Solve ``net`` exactly on the CPU. ``timeout_s`` bounds the
    subprocess (the --max_solver_runtime ceiling)."""
    return solve_dimacs(
        write_dimacs(net), net.n_arcs,
        algorithm=algorithm, timeout_s=timeout_s,
    )


def solve_dimacs(
    text: str,
    n_arcs: int,
    *,
    algorithm: str = "ssp",
    timeout_s: float = 1000.0,
) -> OracleResult:
    """Solve an already-rendered DIMACS instance on the CPU binary."""
    binary = ensure_built()
    try:
        proc = subprocess.run(
            [str(binary), algorithm],
            input=text,
            capture_output=True,
            text=True,
            timeout=timeout_s,
        )
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(
            f"oracle exceeded max solver runtime ({timeout_s}s)"
        ) from e
    if proc.stderr:
        log.debug("oracle stderr: %s", proc.stderr.strip())
    if proc.returncode == 1 and "infeasible" in proc.stdout:
        raise OracleInfeasible(proc.stdout.strip())
    if proc.returncode != 0:
        raise RuntimeError(
            f"oracle failed rc={proc.returncode}: {proc.stderr[:500]}"
        )
    cost, flows = parse_flow_output(proc.stdout, n_arcs)
    solve_ms = 0.0
    for line in proc.stdout.splitlines():
        if line.startswith("c time_ms"):
            solve_ms = float(line.split()[2])
    return OracleResult(
        cost=cost, flows=flows, solve_ms=solve_ms, algorithm=algorithm
    )
