"""The scale lane's task-axis mesh: the dense table as row blocks over
several devices, each shard's dense passes on its own device, and the
certificate from per-shard partials (the reference's ``parallel/``,
``jax.sharding`` and ``shard_map``, restated over a list of devices).
"""

from poseidon_tpu_torch.parallel.mesh import TaskMesh, make_mesh
from poseidon_tpu_torch.parallel.sharded import (
    RESIDENT_TASK_FIELDS,
    collective_account,
    resident_round_shardings,
    shard_instance,
    sharded_certificate_gap,
    solve_dense_sharded,
)

__all__ = [
    "RESIDENT_TASK_FIELDS",
    "TaskMesh",
    "collective_account",
    "make_mesh",
    "resident_round_shardings",
    "shard_instance",
    "sharded_certificate_gap",
    "solve_dense_sharded",
]
