"""Solver ops: transport form, dense auction, the device-resident round,
and the general-graph solvers (cost-scaling, successive shortest paths)."""
from poseidon_tpu_torch.ops.ssp import SolveResult, solve_ssp

__all__ = ["SolveResult", "solve_ssp"]
