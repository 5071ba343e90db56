"""CLI entry: ``python -m poseidon_tpu_torch.analysis [options] [paths]``.

Exit codes: 0 clean, 1 violations found, 2 usage error.

Passes:

- the AST rules (always): PTA001-PTA005 file/repo rules plus the
  whole-program passes — PTA006 (lockset race detection over the
  thread model), PTA007 (plan-key provenance) and PTA010 (lock-order
  deadlock + no-blocking-under-lock);
- ``--audit-suppressions``: additionally report DEAD ``# noqa:
  PTA0xx`` comments (rule no longer fires on that statement);
- ``--optrace``: additionally record the production entries on a tiny
  instance and audit what they run — the op census and structure
  audit (PTA008, ``analysis/op_fingerprints.json``) and the
  padding-taint dataflow audit (PTA009, ``analysis/padding_taint.py``).
  ``--optrace-only`` runs just those audits. ``--update-fingerprints``
  re-pins the census file instead of diffing (structural problems
  still report). ``--device`` picks where the entries run (default
  the card, where the census must equal the pinned one; ``cpu`` runs
  the kernels' twins, as the tests do);
- ``--rule PTA0NN[,PTA0MM]``: run only the named rule(s) (an unknown
  code exits 2). Selecting no op-trace rule skips the recording;
  selecting ONLY op-trace rules skips the AST walk.

A path argument that exists but contains no Python targets is a usage
error (exit 2), not a clean run.

The JSON document keeps the reference's schema: ``violations``
(objects with exactly code/rule/path/line/col/message, sorted by (path,
line, col, code)), ``count``, ``files_scanned``, and — only when
``--optrace`` ran — ``kernels_audited`` (the entries audited).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from poseidon_tpu_torch.analysis.core import (
    FILE_RULES,
    REPO_RULES,
    _ensure_rules_loaded,
    analyze_and_audit,
    analyze_tree,
    format_human,
    format_json,
)

# codes not produced by a registered AST rule: PTA000 comes from the
# parser/suppression layer, PTA008/PTA009 from the op-trace audits
_EXTRA_CODES = ("PTA000", "PTA008", "PTA009")
_OPTRACE_CODES = frozenset(("PTA008", "PTA009"))


def _known_codes() -> set[str]:
    _ensure_rules_loaded()
    codes = {code for code, _name, _fn in FILE_RULES}
    codes.update(code for code, _name, _fn in REPO_RULES)
    codes.update(_EXTRA_CODES)
    return codes


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m poseidon_tpu_torch.analysis",
        description=(
            "Contract linter for the PyTorch port: enforce the port's "
            "hot-path (host syncs), O(churn), launch-hygiene, thread-"
            "discipline, surface-consistency, lockset-race, plan-key "
            "and lock-order invariants (PTA001-PTA007, PTA010), plus "
            "the op-trace audits of the production entries (PTA008 "
            "census, analysis/optrace_check.py; PTA009 padding-taint "
            "dataflow, analysis/padding_taint.py)"
        ),
    )
    p.add_argument(
        "paths", nargs="*",
        help="files to scan (default: the port's tree — "
             "poseidon_tpu_torch/, chip_smoke.py, kernel_ab.py, "
             "tests/test_torch_*.py)",
    )
    p.add_argument(
        "--format", choices=("human", "json"), default="human",
        help="output format",
    )
    p.add_argument(
        "--root", default=".",
        help="repo root (scopes and doc files resolve against it)",
    )
    p.add_argument(
        "--rule", default=None, metavar="PTA0NN[,PTA0MM]",
        help="run only the named rule(s); unknown codes exit 2",
    )
    p.add_argument(
        "--audit-suppressions", action="store_true",
        help="also report dead '# noqa: PTA0xx' suppressions "
             "(reasoned noqas whose rule no longer fires there)",
    )
    p.add_argument(
        "--optrace", action="store_true",
        help="also record the production entries and audit the ops "
             "they run (census/f64/host reads/uploads via PTA008, "
             "padding-taint dataflow via PTA009)",
    )
    p.add_argument(
        "--optrace-only", action="store_true",
        help="run ONLY the op-trace audits, skipping the AST rules",
    )
    p.add_argument(
        "--update-fingerprints", action="store_true",
        help="re-record the entries and rewrite analysis/"
             "op_fingerprints.json (implies --optrace)",
    )
    p.add_argument(
        "--device", default=None,
        help="where the op-trace audit runs the entries (default: the "
             "card, cuda; cpu runs the kernels' twins)",
    )
    args = p.parse_args(argv)

    selection: set[str] | None = None
    if args.rule is not None:
        selection = {c.strip() for c in args.rule.split(",") if c.strip()}
        unknown = selection - _known_codes()
        if not selection or unknown:
            bad = ", ".join(sorted(unknown)) or "(empty)"
            print(
                f"unknown rule id(s): {bad} — known: "
                + ", ".join(sorted(_known_codes())),
                file=sys.stderr,
            )
            return 2

    root = pathlib.Path(args.root).resolve()
    paths = None
    if args.paths:
        paths = []
        for raw in args.paths:
            path = pathlib.Path(raw).resolve()
            if not path.exists():
                print(f"no such file: {raw}", file=sys.stderr)
                return 2
            if not path.is_relative_to(root):
                print(
                    f"{raw} is outside --root {root} (scopes are "
                    "declared root-relative)", file=sys.stderr,
                )
                return 2
            if path.is_dir():
                paths.extend(sorted(path.rglob("*.py")))
            else:
                paths.append(path)
        if not paths:
            # a target that exists but holds no Python files is a
            # typo'd CI path, not a clean tree: refuse the green stamp
            print(
                "no Python targets under: "
                + " ".join(args.paths)
                + " — pass files or directories containing .py "
                "files (usage error, exit 2)",
                file=sys.stderr,
            )
            return 2

    optrace_requested = (
        args.optrace or args.optrace_only or args.update_fingerprints
    )
    run_ast = not args.optrace_only and (
        selection is None or bool(selection - _OPTRACE_CODES)
    )
    run_pta008 = args.update_fingerprints or (
        optrace_requested and (selection is None or "PTA008" in selection)
    )
    run_pta009 = optrace_requested and (
        selection is None or "PTA009" in selection
    )

    if run_ast:
        run = (
            analyze_and_audit if args.audit_suppressions
            else analyze_tree
        )
        violations, files_scanned = run(root, paths)
    else:
        violations, files_scanned = [], 0
    kernels_audited = None
    if run_pta008:
        from poseidon_tpu_torch.analysis.optrace_check import (
            run_optrace_audit,
        )

        found, kernels_audited = run_optrace_audit(
            root, update=args.update_fingerprints, device=args.device
        )
        violations = violations + found
    if run_pta009:
        from poseidon_tpu_torch.analysis.padding_taint import (
            run_padding_audit,
        )

        found, kernels_audited = run_padding_audit(
            root, device=args.device
        )
        violations = violations + found
    if selection is not None:
        violations = [v for v in violations if v.code in selection]
    # the merged document keeps the locked (path, line, col, code)
    # ordering whichever passes contributed
    violations = sorted(
        violations, key=lambda v: (v.path, v.line, v.col, v.code)
    )

    if args.format == "json":
        print(format_json(violations, files_scanned, kernels_audited))
    else:
        out = format_human(violations, files_scanned)
        if kernels_audited is not None:
            out += f"\n{kernels_audited} entry op trace(s) audited"
        print(out)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
