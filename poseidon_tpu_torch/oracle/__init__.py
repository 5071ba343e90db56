from poseidon_tpu_torch.oracle.oracle import (
    OracleInfeasible,
    OracleResult,
    solve_dimacs,
    solve_oracle,
)

__all__ = ["OracleInfeasible", "OracleResult", "solve_dimacs", "solve_oracle"]
