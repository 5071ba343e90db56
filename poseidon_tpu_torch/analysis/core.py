"""The lint framework: rule registry, suppressions, file walking, output.

The counterpart of the reference's ``poseidon_tpu/analysis/core.py``,
rule-agnostic and unchanged in behaviour: the suppression grammar, the
statement spans, the audit and both output formats are the reference's,
so a violation list from either package over the same files and
contracts is the same list. What differs is ``default_targets``: the
port's own tree (``poseidon_tpu_torch/``, ``chip_smoke.py``,
``kernel_ab.py`` and ``tests/test_torch_*.py``), never the reference's.

Rule logic lives in ``rules.py``; the repo-specific declarations in
``contracts.py``. This module owns everything rule-agnostic:

- ``FileContext``: one parsed file (AST + comment map + suppression
  map + background-thread markers), built once and shared by every
  file-scoped rule;
- ``RepoContext``: every parsed file plus the repo root, for rules
  that check cross-file surfaces (PTA005);
- suppressions: ``# noqa: PTA001 -- reason`` on the violation's
  statement. A suppression covers the whole span of the statement it
  sits on (a decorated ``def``'s span runs from its first decorator
  through the ``def`` line, a multi-line call from its first line to
  its closing paren), so a ``# noqa`` on the ``def`` line covers a
  violation reported on the decorator line and vice versa. The reason
  is mandatory — a bare ``# noqa: PTA001`` is itself reported as
  PTA000 (suppression-hygiene), so CI fails until the author writes
  down WHY the exception is sanctioned;
- per-path rule scoping: ``Contracts.path_rules`` narrows which rule
  codes are enforced under a path prefix (``tests/`` runs only the
  jit-hygiene/vocabulary/hygiene rules — test files deliberately
  contain seeded-violation snippets for the other rules);
- the suppression audit (``audit_suppressions``): a reasoned ``# noqa``
  whose rule no longer fires anywhere in its statement's span is DEAD
  and reported as PTA000, so stale exceptions rot out of the tree
  instead of silently sanctioning future violations;
- output: human one-line-per-violation or a JSON document for CI.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import pathlib
import re
import tokenize
from typing import Callable

from poseidon_tpu_torch.analysis.contracts import (
    BACKGROUND_MARKER,
    Contracts,
    DEFAULT_CONTRACTS,
)

# files/dirs never scanned
_SKIP_DIRS = {"__pycache__", ".git", "build", "build-asan", "build-tsan",
              "_build"}

# Suppression comments: ``noqa: PTA001 -- reason`` with one or more
# comma-separated codes after the hash. Only PTA codes are claimed;
# plain ruff noqas are ignored. (Spelled without a leading hash here
# so this documentation is not itself parsed as a suppression — the
# dead-suppression audit caught exactly that.)
_NOQA_RE = re.compile(
    r"#\s*noqa:\s*(?P<codes>PTA\d{3}(?:\s*,\s*PTA\d{3})*)"
    r"(?:\s*--\s*(?P<reason>\S.*))?"
)


@dataclasses.dataclass(frozen=True)
class Violation:
    code: str          # "PTA001"
    rule: str          # "no-host-sync"
    path: str          # repo-root-relative POSIX path
    line: int
    col: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FileContext:
    """One parsed source file plus everything the rules derive from it."""

    path: str                       # repo-relative POSIX
    source: str
    tree: ast.AST
    comments: dict[int, str]        # line -> comment text
    suppressions: dict[int, set[str]]   # line -> suppressed PTA codes
                                        # (expanded over statement spans)
    # the raw reasoned-suppression comments, pre-span-expansion:
    # (comment line, statement span (start, end), codes) — the audit
    # checks each of these against the raw violation set
    suppression_comments: list[tuple[int, tuple[int, int], set[str]]] = \
        dataclasses.field(default_factory=list)
    background_lines: set[int] = dataclasses.field(default_factory=set)
    contracts: Contracts = None

    def in_scope(self, scopes: dict[str, tuple[str, ...]],
                 qualname: str) -> bool:
        """True when ``qualname`` (dot-joined def nesting, no class
        dots collapsed) matches a declared scope for this file. A
        nested function inherits its enclosing function's scope."""
        for suffix, names in scopes.items():
            if not self.path.endswith(suffix):
                continue
            for name in names:
                if qualname == name or qualname.startswith(name + "."):
                    return True
        return False


@dataclasses.dataclass
class RepoContext:
    root: pathlib.Path
    files: dict[str, FileContext]   # repo-relative path -> context
    contracts: Contracts

    def read_text(self, rel: str) -> str | None:
        p = self.root / rel
        try:
            return p.read_text()
        except OSError:
            return None


FileRule = Callable[[FileContext], list[Violation]]
RepoRule = Callable[[RepoContext], list[Violation]]

FILE_RULES: list[tuple[str, str, FileRule]] = []
REPO_RULES: list[tuple[str, str, RepoRule]] = []


def file_rule(code: str, name: str):
    def deco(fn: FileRule) -> FileRule:
        FILE_RULES.append((code, name, fn))
        return fn
    return deco


def repo_rule(code: str, name: str):
    def deco(fn: RepoRule) -> RepoRule:
        REPO_RULES.append((code, name, fn))
        return fn
    return deco


# ---- parsing -----------------------------------------------------------


def _stmt_header_spans(tree: ast.AST) -> list[tuple[int, int]]:
    """(start, end) line span of every statement's HEADER.

    For compound statements (def/class/with/for/if/try...) the span
    covers the decorators and header lines up to the first body
    statement — NOT the body (a ``# noqa`` on a ``with`` line must not
    blanket-suppress the block under it). For simple statements the
    span is the whole (possibly multi-line) statement.
    """
    spans: list[tuple[int, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        start = node.lineno
        decorators = getattr(node, "decorator_list", [])
        if decorators:
            start = min(start, min(d.lineno for d in decorators))
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.stmt):
            end = max(start, body[0].lineno - 1)
        else:
            end = getattr(node, "end_lineno", None) or node.lineno
        spans.append((start, end))
    return spans


def _span_for_line(spans: list[tuple[int, int]], line: int) -> tuple[int, int]:
    """The innermost statement-header span containing ``line`` (the one
    with the latest start); a comment on its own line between
    statements keeps line-exact behavior."""
    best: tuple[int, int] | None = None
    for start, end in spans:
        if start <= line <= end:
            if best is None or start > best[0] or (
                start == best[0] and end < best[1]
            ):
                best = (start, end)
    return best if best is not None else (line, line)


def _scan_comments(source: str) -> dict[int, str]:
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError):
        pass  # the ast.parse error is the authoritative one
    return out


def build_file_context(
    path: pathlib.Path, rel: str, contracts: Contracts
) -> tuple[FileContext | None, list[Violation]]:
    """Parse one file. Returns (context, violations-so-far); a syntax
    error yields (None, [PTA-syntax violation])."""
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return None, [Violation(
            code="PTA000", rule="parse-error", path=rel,
            line=e.lineno or 1, col=e.offset or 0,
            message=f"file does not parse: {e.msg}",
        )]
    comments = _scan_comments(source)
    spans = _stmt_header_spans(tree)
    suppressions: dict[int, set[str]] = {}
    suppression_comments: list[tuple[int, tuple[int, int], set[str]]] = []
    violations: list[Violation] = []
    background_lines: set[int] = set()
    for line, text in comments.items():
        if BACKGROUND_MARKER in text:
            background_lines.add(line)
        m = _NOQA_RE.search(text)
        if not m:
            continue
        codes = {c.strip() for c in m.group("codes").split(",")}
        if not m.group("reason"):
            violations.append(Violation(
                code="PTA000", rule="suppression-hygiene", path=rel,
                line=line, col=0,
                message=(
                    "suppression without a reason: write "
                    f"'# noqa: {','.join(sorted(codes))} -- <why this "
                    "is sanctioned>'"
                ),
            ))
            continue  # a reasonless suppression suppresses nothing
        # a suppression covers its whole statement: normalize from the
        # comment's line to the enclosing statement-header span, so a
        # # noqa on a decorated def covers violations reported on the
        # decorator line (and vice versa)
        start, end = _span_for_line(spans, line)
        suppression_comments.append((line, (start, end), codes))
        for ln in range(start, end + 1):
            suppressions.setdefault(ln, set()).update(codes)
    ctx = FileContext(
        path=rel, source=source, tree=tree, comments=comments,
        suppressions=suppressions,
        suppression_comments=suppression_comments,
        background_lines=background_lines,
        contracts=contracts,
    )
    return ctx, violations


def _apply_suppressions(
    violations: list[Violation], ctx: FileContext
) -> list[Violation]:
    out = []
    for v in violations:
        if v.code in ctx.suppressions.get(v.line, ()):
            continue
        out.append(v)
    return out


# ---- driving -----------------------------------------------------------


def default_targets(root: pathlib.Path) -> list[pathlib.Path]:
    """The port's shipped tree: the package, ``chip_smoke.py``,
    ``kernel_ab.py`` and the port's tests (``tests/test_torch_*.py``).
    Tests run under a NARROWED rule set (``Contracts.path_rules``): the
    launch hygiene and the trace/flag vocabulary apply to test code
    too, but the hot-path/O(churn)/thread rules do not — test files
    deliberately contain seeded-violation snippets (as data) and drive
    private APIs the contracts exempt. The reference package
    (``poseidon_tpu/``) is never scanned: it has its own analyzer."""
    out: list[pathlib.Path] = []
    d = root / "poseidon_tpu_torch"
    if d.is_dir():
        out.extend(
            p for p in sorted(d.rglob("*.py"))
            if not any(part in _SKIP_DIRS for part in p.parts)
        )
    for single in ("chip_smoke.py", "kernel_ab.py"):
        p = root / single
        if p.is_file():
            out.append(p)
    tests = root / "tests"
    if tests.is_dir():
        out.extend(sorted(tests.glob("test_torch_*.py")))
    return out


def _allowed_codes(contracts: Contracts, path: str) -> tuple[str, ...] | None:
    """The rule codes enforced for ``path`` (None = every rule). First
    matching ``path_rules`` prefix wins."""
    for prefix, codes in contracts.path_rules:
        if path.startswith(prefix):
            return codes
    return None


def files_enforcing(
    repo: "RepoContext", code: str
) -> dict[str, FileContext]:
    """The scanned files whose EVIDENCE a whole-program pass for
    ``code`` may use: where path_rules enforce that code. Excluded
    files (tests/) must not feed access maps or registries either —
    a test poking privates would otherwise fabricate main-thread
    'evidence' anchored in production code, which the violation-path
    filter alone cannot undo."""
    out: dict[str, FileContext] = {}
    for rel, fctx in repo.files.items():
        allowed = _allowed_codes(repo.contracts, rel)
        if allowed is None or code in allowed:
            out[rel] = fctx
    return out


def _path_scope_filter(
    violations: list[Violation], contracts: Contracts
) -> list[Violation]:
    out = []
    for v in violations:
        allowed = _allowed_codes(contracts, v.path)
        if allowed is not None and v.code not in allowed:
            continue
        out.append(v)
    return out


def _ensure_rules_loaded() -> None:
    """Rule registration is an import-time side effect of the rule
    modules; every public entry point must force it or it would run
    with an empty registry and report anything as clean."""
    import poseidon_tpu_torch.analysis.locks  # noqa: F401 (registry side effect)
    import poseidon_tpu_torch.analysis.recompile  # noqa: F401 (registry side effect)
    import poseidon_tpu_torch.analysis.rules  # noqa: F401 (registry side effect)
    import poseidon_tpu_torch.analysis.threads  # noqa: F401 (registry side effect)


def analyze_file(
    path: pathlib.Path,
    root: pathlib.Path,
    contracts: Contracts = DEFAULT_CONTRACTS,
) -> list[Violation]:
    _ensure_rules_loaded()
    rel = path.relative_to(root).as_posix()
    ctx, violations = build_file_context(path, rel, contracts)
    if ctx is None:
        return violations
    found: list[Violation] = []
    for _code, _name, rule in FILE_RULES:
        found.extend(rule(ctx))
    return _path_scope_filter(
        violations + _apply_suppressions(found, ctx), contracts
    )


def _run_rules(
    root: pathlib.Path,
    paths: list[pathlib.Path] | None,
    contracts: Contracts,
) -> tuple[list[Violation], list[Violation], dict[str, FileContext]]:
    """Shared driver: returns (kept, raw, contexts). ``raw`` is every
    rule finding BEFORE suppressions (but after path-rule scoping) —
    the suppression audit diffs the two."""
    _ensure_rules_loaded()
    root = root.resolve()
    targets = paths if paths is not None else default_targets(root)
    files: dict[str, FileContext] = {}
    kept: list[Violation] = []
    raw: list[Violation] = []
    for path in targets:
        rel = path.resolve().relative_to(root).as_posix()
        ctx, pre = build_file_context(path, rel, contracts)
        kept.extend(pre)
        if ctx is None:
            continue
        files[rel] = ctx
        found: list[Violation] = []
        for _code, _name, rule in FILE_RULES:
            found.extend(rule(ctx))
        found = _path_scope_filter(found, contracts)
        raw.extend(found)
        kept.extend(_apply_suppressions(found, ctx))
    repo_ctx = RepoContext(root=root, files=files, contracts=contracts)
    for _code, _name, rule in REPO_RULES:
        found = _path_scope_filter(rule(repo_ctx), contracts)
        raw.extend(found)
        # repo-rule violations anchored in a scanned file honor that
        # file's suppressions too
        for v in found:
            fctx = files.get(v.path)
            if fctx is not None and v.code in fctx.suppressions.get(
                v.line, ()
            ):
                continue
            kept.append(v)
    kept = _path_scope_filter(kept, contracts)
    kept.sort(key=lambda v: (v.path, v.line, v.col, v.code))
    return kept, raw, files


def analyze_tree(
    root: pathlib.Path,
    paths: list[pathlib.Path] | None = None,
    contracts: Contracts = DEFAULT_CONTRACTS,
) -> tuple[list[Violation], int]:
    """Run every rule over ``paths`` (default: the shipped tree).
    Returns (violations, files_scanned)."""
    kept, _raw, files = _run_rules(root, paths, contracts)
    return kept, len(files)


def audit_suppressions(
    root: pathlib.Path,
    paths: list[pathlib.Path] | None = None,
    contracts: Contracts = DEFAULT_CONTRACTS,
) -> tuple[list[Violation], int]:
    """Report DEAD suppressions: a reasoned ``# noqa: PTA0xx`` whose
    named rule no longer fires anywhere within its statement's span.

    Dead suppressions are how a linter rots: the exception outlives
    the code it sanctioned, then silently blesses the NEXT violation
    someone writes on that line. CI runs this after the main pass
    (``--audit-suppressions``) so stale entries are cleaned out while
    the reason is still in memory. Returns (violations,
    files_scanned) like ``analyze_tree``.
    """
    _kept, raw, files = _run_rules(root, paths, contracts)
    return _dead_suppressions(raw, files), len(files)


def _dead_suppressions(
    raw: list[Violation], files: dict[str, FileContext]
) -> list[Violation]:
    fired: dict[str, set[tuple[str, int]]] = {}
    for v in raw:
        fired.setdefault(v.path, set()).add((v.code, v.line))
    out: list[Violation] = []
    for rel, ctx in files.items():
        hits = fired.get(rel, set())
        for line, (start, end), codes in ctx.suppression_comments:
            for code in sorted(codes):
                if any(
                    (code, ln) in hits for ln in range(start, end + 1)
                ):
                    continue
                out.append(Violation(
                    code="PTA000", rule="dead-suppression", path=rel,
                    line=line, col=0,
                    message=(
                        f"dead suppression: {code} does not fire on "
                        "this statement any more — delete the noqa "
                        "(or the code it sanctioned has moved)"
                    ),
                ))
    out.sort(key=lambda v: (v.path, v.line, v.col, v.code))
    return out


def analyze_and_audit(
    root: pathlib.Path,
    paths: list[pathlib.Path] | None = None,
    contracts: Contracts = DEFAULT_CONTRACTS,
) -> tuple[list[Violation], int]:
    """One combined pass: rule violations MERGED with dead-suppression
    reports, from a single rule run (the CLI's --audit-suppressions
    lane — running ``analyze_tree`` and ``audit_suppressions``
    back-to-back would execute every rule twice)."""
    kept, raw, files = _run_rules(root, paths, contracts)
    merged = sorted(
        kept + _dead_suppressions(raw, files),
        key=lambda v: (v.path, v.line, v.col, v.code),
    )
    return merged, len(files)


# ---- output ------------------------------------------------------------


def format_human(violations: list[Violation], files_scanned: int) -> str:
    lines = [
        f"{v.path}:{v.line}:{v.col}: {v.code} [{v.rule}] {v.message}"
        for v in violations
    ]
    lines.append(
        f"{len(violations)} violation(s) in {files_scanned} file(s) scanned"
        if violations
        else f"clean: 0 violations in {files_scanned} file(s) scanned"
    )
    return "\n".join(lines)


def format_json(
    violations: list[Violation],
    files_scanned: int,
    kernels_audited: int | None = None,
) -> str:
    """The CLI's JSON document — the ONE writer of the schema CI and
    downstream tooling depend on (tests/test_analysis.py::
    TestJsonSchema locks it). ``kernels_audited`` appears only when
    the jaxpr audit ran."""
    doc = {
        "violations": [v.as_dict() for v in violations],
        "count": len(violations),
        "files_scanned": files_scanned,
    }
    if kernels_audited is not None:
        doc["kernels_audited"] = kernels_audited
    return json.dumps(doc, indent=2)
