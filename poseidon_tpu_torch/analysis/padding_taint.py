"""PTA009: padding-mask dataflow audit over the recorded entries.

The counterpart of the reference's ``poseidon_tpu/analysis/
padding_taint.py``, over the op recordings of ``optrace_check.py`` in
place of closed jaxprs. The bug class is the reference's: a PADDED lane
(a row beyond the t/m/p grow-only floors, a ``-1`` index sentinel, a
zero-slot machine; the contract declared at ``ops/resident.py``
``DenseTopology``) escaping into a cross-axis fold without a dominating
mask, so the fold takes garbage into a scalar the whole round trusts.

The recording runs with kernel suspension OFF: inside each hand
kernel's wrapper the CPU runs its plain twin, so the audit reads the
kernels' folds through their twins — the code the kernels are held
equal to, bit for bit, on the card.

- **sources**: every tensor of rank >= 1 an entry receives (its
  arguments, their dataclass fields and containers) is padding-tainted
  — by the pad contract every table carries lanes beyond the true
  t/m/p extents; tensors the entry makes itself (``arange``, ``full``,
  ``zeros``) are clean;
- **propagation**: any tainted input taints the outputs (elementwise
  ops, gathers, scatters, sorts, cumsums, slices); an in-place op
  taints the tensor it writes;
- **sinks**: a cross-axis fold (``min``/``max``/``amin``/``amax``/
  ``sum``/``prod``/``argmin``/``argmax`` and ``any``/``all``; not
  their elementwise overloads) over a padding-tainted operand fires
  unless the mask DOMINATES the fold: the operand is the output of
  ``torch.where``, ``clamp`` or ``masked_fill``, reached through view,
  reshape, expand and dtype casts only. This is the port's fold idiom —
  ``gat``/``finmax`` in ``ops/resident.py`` apply ``torch.where``
  inside the reduction call. A mask further upstream does not count
  (the reference's express-lane bug was a fold over model output that
  WAS masked upstream, on the wrong axis). Counting folds over bool
  masks (``mask.sum()``) are exempt, but ``any``/``all`` over an
  unmasked tainted mask still fire.

A site is attributed to the innermost ``poseidon_tpu_torch`` frame
(function name and line). Folds that are safe by construction rather
than by a visible mask are sanctioned in
``Contracts.kernel_mask_contracts``, one reasoned entry per (entry,
aten op, function), ``"*"`` for every entry; the list is verified live
both ways: an unsanctioned candidate is a violation, and an entry no
current recording exercises is reported STALE.
"""

from __future__ import annotations

import pathlib

from poseidon_tpu_torch.analysis.core import Violation


def candidates(recordings) -> list[tuple]:
    """(entry, op, function, path, line) of every unmasked tainted fold
    in the recordings, sorted."""
    out = set()
    for entry, rec in recordings.items():
        for (op, fn, path, line) in rec.candidates:
            out.add((entry, op, fn, path, line))
    return sorted(out, key=lambda c: (c[0], c[2] or "", c[4], c[1]))


def run_padding_audit(
    root: pathlib.Path, *, recordings=None, contracts=None, device=None,
) -> tuple[list[Violation], int]:
    """Run the taint pass over the production entries and reconcile it
    against ``Contracts.kernel_mask_contracts``. Returns (violations,
    entries audited)."""
    from poseidon_tpu_torch.analysis.contracts import DEFAULT_CONTRACTS
    from poseidon_tpu_torch.analysis.optrace_check import record_entries

    contracts = contracts or DEFAULT_CONTRACTS
    if recordings is None:
        recordings = record_entries(device, taint=True)
    sanctioned = {
        (entry, op, fn): reason
        for entry, items in contracts.kernel_mask_contracts.items()
        for op, fn, reason in items
    }
    used: set = set()
    violations: list[Violation] = []
    for entry, op, fn, path, line in candidates(recordings):
        hit = next((k for k in ((entry, op, fn), ("*", op, fn))
                    if k in sanctioned), None)
        if hit is not None:
            used.add(hit)
            continue
        violations.append(Violation(
            code="PTA009", rule="padding-taint",
            path=path or "poseidon_tpu_torch/analysis/contracts.py",
            line=line or 1, col=0,
            message=(
                f"{entry}: {op} in {fn or '<unknown>'} folds a padding-"
                "tainted operand with no dominating mask — padded lanes "
                "(rows beyond the t/m/p floors, -1 sentinels, zero-slot "
                "machines) reach this fold unmasked; fold through "
                "torch.where(valid, x, <identity>) at the reduction, or "
                "add a reasoned entry to Contracts.kernel_mask_contracts"
            ),
        ))
    for entry, op, fn in sorted(set(sanctioned) - used,
                                key=lambda k: (k[0], k[2], k[1])):
        violations.append(Violation(
            code="PTA009", rule="padding-taint",
            path="poseidon_tpu_torch/analysis/contracts.py", line=1, col=0,
            message=(
                f"stale kernel_mask_contracts entry: ({op!r}, {fn!r}) in "
                f"entry {entry!r} matches no tainted fold in the current "
                "recordings — the site was masked or removed; delete the "
                "entry"
            ),
        ))
    return violations, len(recordings)
