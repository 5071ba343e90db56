"""Contract linter for the port: whole-program analysis enforcing the
port's performance and concurrency invariants.

The counterpart of the reference's ``poseidon_tpu/analysis/``, with the
same rule codes (PTA000-PTA010) so the port's ``# pta:`` markers and
reasoned suppressions keep their meaning:

- ``python -m poseidon_tpu_torch.analysis`` runs every registered rule
  over the port's tree (``poseidon_tpu_torch/``, ``chip_smoke.py``,
  ``kernel_ab.py``, and ``tests/test_torch_*.py`` under a narrowed
  per-rule scope) and exits non-zero on any violation
  (``--audit-suppressions``: DEAD ``# noqa`` comments fail too).
- The file-local set (``rules.py``, PTA001-PTA005) covers host syncs
  in their torch meaning (``.item()``, ``.cpu()``, ``int()`` of a
  device tensor, ``torch.cuda.synchronize()``, the ops that size their
  result from the data, blocking uploads outside the declared sites:
  the one sanctioned read is ``guards.SyncCounter.read``), cluster
  loops, launch hygiene (no ``torch.compile``/``torch.jit``, one
  library loader, plans only from their caches), marker-based lock
  discipline, and the trace/flag surface. The whole-program set is the
  reference's: PTA006 (``threads.py``, the lockset race check), PTA007
  (``recompile.py``, plan-key provenance) and PTA010 (``locks.py``,
  lock order and blocking under a lock).
- ``--optrace`` (``optrace_check.py``, PTA008) records the production
  entries on tiny shapes under a dispatch mode and audits the aten ops
  they run (the counterpart of the reference's ``--jaxpr``), and
  ``padding_taint.py`` (PTA009) runs the padding-mask dataflow over the
  same recording.
- Violations are suppressed inline with ``# noqa: PTA001 -- reason``;
  the reason is REQUIRED (a bare suppression is PTA000).

The runtime counterpart of PTA001 — the reference's
``jax.transfer_guard`` teeth — is ``chip_smoke.py``'s [analysis] phase:
a sync map under ``torch.cuda.set_sync_debug_mode("warn")`` held to
the solver's own counters.
"""

from poseidon_tpu_torch.analysis.contracts import Contracts, DEFAULT_CONTRACTS
from poseidon_tpu_torch.analysis.core import (
    Violation,
    analyze_and_audit,
    analyze_file,
    analyze_tree,
    audit_suppressions,
    default_targets,
    format_human,
    format_json,
)

__all__ = [
    "Contracts",
    "DEFAULT_CONTRACTS",
    "Violation",
    "analyze_and_audit",
    "analyze_file",
    "analyze_tree",
    "audit_suppressions",
    "default_targets",
    "format_human",
    "format_json",
]
