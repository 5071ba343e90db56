"""The port's shadow audits held against the reference's on the same
captured snapshots.

``chip_smoke.py``'s ``[observe]`` phase pickles each snapshot its
daemon's ``ShadowAuditor`` audited (into ``DIR/audits`` with
``--keep_dir=DIR`` on the card; the CPU rehearsal in
``tests/test_torch_chip_phases.py`` passes a temporary directory)
beside a JSON list of the port's results. This
module converts each snapshot to the reference's types, audits it with
the reference's ``ShadowAuditor`` (pricing on the CPU, the C++ oracle's
solve) and compares regret, status quo and optimum.

    python3 -m tests.audit_against_reference DIR

prints one line per snapshot and exits 1 on any difference. It imports
both packages, so it runs on a host with jax, not on the card.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import pickle
import sys


def reference_snapshot(snap):
    """The port's ``AuditSnapshot`` as the reference's."""
    from poseidon_tpu.cluster import Machine, Task, TaskPhase
    from poseidon_tpu.obs.audit import AuditSnapshot

    fields = {f.name: getattr(snap, f.name)
              for f in dataclasses.fields(snap)}
    fields["machines"] = [Machine(**dataclasses.asdict(m))
                          for m in snap.machines]
    fields["tasks"] = [
        Task(**{**dataclasses.asdict(t), "phase": TaskPhase(t.phase.value)})
        for t in snap.tasks
    ]
    return AuditSnapshot(**fields)


def reference_audit(snap) -> tuple[int, int, int]:
    """(regret, status quo, optimum) of the reference's audit of the
    port's snapshot ``snap``."""
    from poseidon_tpu.obs import ShadowAuditor

    res = ShadowAuditor(background=False)._process(reference_snapshot(snap))
    if res.error:
        raise RuntimeError(f"reference audit of round {snap.round_num}: "
                           f"{res.error}")
    return res.regret, res.status_quo_cost, res.optimal_cost


def compare(directory: str) -> list[str]:
    """One line per audited snapshot in ``directory``; a line that
    starts with ``DIFF`` marks a difference."""
    with open(os.path.join(directory, "audits.json")) as fh:
        port = {a["round"]: a for a in json.load(fh)}
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "audit-*.pkl"))):
        with open(path, "rb") as fh:
            snap = pickle.load(fh)
        a = port[snap.round_num]
        mine = (a["regret"], a["sq"], a["opt"])
        ref = reference_audit(snap)
        tag = "same" if mine == ref else "DIFF"
        out.append(f"{tag} round {snap.round_num}: port (regret, status "
                   f"quo, optimum) {mine}, reference {ref}; "
                   f"{len(snap.tasks)} running tasks on "
                   f"{len(snap.machines)} machines")
    return out


def main(argv: list[str]) -> int:
    lines = compare(argv[0])
    for line in lines:
        print(line)
    return 1 if not lines or any(x.startswith("DIFF") for x in lines) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
