"""Scheduling-as-a-service: batch N heterogeneous tenant clusters onto
one device behind an async front door (the port of
``poseidon_tpu/service/``).

- ``service.SchedulingService`` — the front door: per-tenant isolated
  ``SchedulerBridge`` sessions, ``submit(tenant) -> Future``, and the
  double-buffered ``pump()`` pipeline;
- ``dispatch.BatchDispatcher`` / ``dispatch.TenantSolver`` — the shared
  solver seam: shape-bucket routing, grow-only bucket floors, one
  batched upload, the members' solves and one batched fetch per
  dispatch chunk (``ops/batch._solve_member``);
- ``serve.run_serve`` — the cli ``--serve`` driver (N real or fake
  tenant apiservers).
"""

from poseidon_tpu_torch.service.dispatch import BatchDispatcher, TenantSolver
from poseidon_tpu_torch.service.service import (
    MAX_TENANT_LABELS,
    SchedulingService,
    TenantSession,
)

__all__ = [
    "BatchDispatcher",
    "MAX_TENANT_LABELS",
    "SchedulingService",
    "TenantSession",
    "TenantSolver",
]
