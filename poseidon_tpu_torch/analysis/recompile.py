"""PTA007: plan-key / pad-shape provenance — the recompile-hazard pass.

The counterpart of the reference's ``poseidon_tpu/analysis/
recompile.py``, in its torch meaning. The reference's bug class (its PR
8 flushed out three at run time) is a value derived from a data-
dependent quantity — a ``max`` over live state, a ``len`` of the
pending pool, a topology's ``max_prefs`` — reaching a position that
pins a compiled shape WITHOUT riding a grow-only floor. The port
compiles nothing at run time, but the same values key what it does
build: a kernel's launch plan (``kernels/row_stream.PlanCache``, made
once per key and counted by ``guards.note_build`` / ``CompileCounter``),
the auction's ``[Mp, smax]`` willingness table and the lanes' window
buffers (fresh allocations at every new size), and the pad floors of
the host padding helpers. A value that shrinks across a bucket and
grows again pays a new plan and new allocations each time — and, once
the rounds are captured as CUDA graphs, a re-capture.

1. **Registry.** ``Contracts.plan_key_params`` names, per callable, the
   parameters that key a plan or a shape (the counterpart of
   ``static_argnames``); the positional parameter list comes from the
   callable's own ``def`` (a method drops ``self``; a dataclass takes
   its fields in order) in the enforcing files.

2. **Taint (function-local, flow-ordered).** A local is tainted when
   it derives from a hazard source — a ``max(...)`` / ``len(...)``
   call, a ``.max()`` reduction, or a declared hazard attribute
   (``.max_prefs``) — via assignments replayed in source order, so a
   later clean re-binding (``P = self._p_floor``) clears the name.

3. **Floors sanctify.** An expression that references a grow-only
   floor (``Contracts.floor_markers``) is clean.

4. **Sinks.** A tainted, un-floored expression arriving at a key
   parameter of a registered callable, or at a declared pad floor of
   the padding helpers (``Contracts.pad_sinks``), is the violation.

One-shot lanes (a cold ``solve_transport_dense`` in a test) plan per
call BY DESIGN — such sites carry a reasoned ``# noqa: PTA007``.
"""

from __future__ import annotations

import ast

from poseidon_tpu_torch.analysis.contracts import Contracts
from poseidon_tpu_torch.analysis.core import (
    RepoContext,
    Violation,
    files_enforcing,
    repo_rule,
)
from poseidon_tpu_torch.analysis.rules import (
    _bound_names,
    _dotted,
    iter_functions,
    iter_own_nodes,
)


def build_plan_registry(
    files, c: Contracts
) -> dict[str, tuple[list[str], set[str]]]:
    """Terminal callable name -> (positional params, key param names)
    for every callable ``Contracts.plan_key_params`` declares, with its
    positional list from its own ``def`` (or dataclass) in the
    ENFORCING files (a tests/ def must not shadow a production
    signature). A name defined twice with different positional lists
    is ambiguous and keeps keyword matching only."""
    registry: dict[str, tuple[list[str], set[str]]] = {
        name: ([], set(keys)) for name, keys in c.plan_key_params.items()
    }
    seen: dict[str, list[str]] = {}
    ambiguous: set[str] = set()
    for fctx in files.values():
        for node in ast.walk(fctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in registry:
                params = [a.arg for a in
                          node.args.posonlyargs + node.args.args]
                if params and params[0] in ("self", "cls"):
                    params = params[1:]
            elif isinstance(node, ast.ClassDef) and node.name in registry:
                params = [
                    s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)
                ]
            else:
                continue
            prev = seen.setdefault(node.name, params)
            if prev != params:
                ambiguous.add(node.name)
    for name, params in seen.items():
        if name not in ambiguous:
            registry[name] = (params, registry[name][1])
    return registry


def _has_floor_marker(expr: ast.AST, c: Contracts) -> bool:
    exact = {m for m in c.floor_markers if m != "floor"}
    for n in ast.walk(expr):
        name = None
        if isinstance(n, ast.Name):
            name = n.id
        elif isinstance(n, ast.Attribute):
            name = n.attr
        elif isinstance(n, ast.keyword):
            name = n.arg
        if name is None:
            continue
        if "floor" in name.lower() or name in exact:
            return True
    return False


def _has_hazard_source(expr: ast.AST, c: Contracts) -> str | None:
    """The hazard in ``expr``, or None. max()/len() calls, ``.max()``
    reductions, and declared hazard attributes are data-dependent."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Name) and \
                    n.func.id in ("max", "len") and n.args and not all(
                        isinstance(a, ast.Constant) for a in n.args
                    ):
                return f"{n.func.id}(...)"
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr in ("max", "argmax"):
                return f".{n.func.attr}() reduction"
            d = _dotted(n.func)
            if d in ("np.max", "numpy.max", "np.amax"):
                return d
        if isinstance(n, ast.Attribute) and n.attr in c.hazard_attrs:
            return f".{n.attr}"
    return None


def _ordered_assigns(
    fn: ast.AST,
) -> list[tuple[int, set[str], ast.AST, bool]]:
    """(lineno, bound names, value expr, is_augmented) in source order
    — the taint replay is flow-ORDERED: a later clean re-binding of a
    name (``P = self._p_floor`` after ``P = topo.max_prefs``) clears
    its taint, which a flow-insensitive union would keep forever."""
    items: list[tuple[int, set[str], ast.AST, bool]] = []
    for node in iter_own_nodes(fn):
        if isinstance(node, ast.Assign):
            targets: set[str] = set()
            for t in node.targets:
                targets |= _bound_names(t)
            items.append((node.lineno, targets, node.value, False))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                isinstance(node.target, ast.Name) and \
                node.value is not None:
            items.append((
                node.lineno, {node.target.id}, node.value,
                isinstance(node, ast.AugAssign),
            ))
    items.sort(key=lambda it: it[0])
    return items


def _taint_at(
    assigns: list[tuple[int, set[str], ast.AST, bool]],
    line: int,
    c: Contracts,
) -> dict[str, str]:
    """Name -> hazard description as of (just before) ``line``,
    replaying assignments in source order. Loops that assign below
    their use are out of scope (grow-only floors do not live in
    loops)."""
    tainted: dict[str, str] = {}
    for ln, targets, value, augmented in assigns:
        if ln >= line:
            break
        if _has_floor_marker(value, c):
            for t in targets:
                tainted.pop(t, None)  # rides a floor: sanctified
            continue
        hazard = _has_hazard_source(value, c)
        if hazard is None:
            carried = [
                n.id for n in ast.walk(value)
                if isinstance(n, ast.Name) and n.id in tainted
            ]
            if not carried:
                if not augmented:
                    for t in targets:
                        tainted.pop(t, None)  # clean re-binding
                continue
            hazard = tainted[carried[0]]
        for t in targets:
            tainted[t] = hazard
    return tainted


def _expr_hazard(
    expr: ast.AST, tainted: dict[str, str], c: Contracts
) -> str | None:
    if _has_floor_marker(expr, c):
        return None
    hazard = _has_hazard_source(expr, c)
    if hazard is not None:
        return hazard
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in tainted:
            return tainted[n.id]
    return None


@repo_rule("PTA007", "recompile-hazard")
def recompile_hazard(repo: RepoContext) -> list[Violation]:
    c = repo.contracts
    files = files_enforcing(repo, "PTA007")
    registry = build_plan_registry(files, c)
    out: list[Violation] = []
    for rel, fctx in files.items():
        for fn, qual, _depth in iter_functions(fctx.tree):
            assigns = _ordered_assigns(fn)
            for node in iter_own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = None
                if isinstance(node.func, ast.Name):
                    callee = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    callee = node.func.attr
                if callee is None:
                    continue
                sinks: list[tuple[str, ast.AST]] = []
                if callee in registry:
                    params, static = registry[callee]
                    for i, a in enumerate(node.args):
                        if i < len(params) and params[i] in static:
                            sinks.append((params[i], a))
                    for kw in node.keywords:
                        if kw.arg in static:
                            sinks.append((kw.arg, kw.value))
                if callee in c.pad_sinks:
                    floors = c.pad_sinks[callee]
                    for kw in node.keywords:
                        if kw.arg in floors:
                            sinks.append((kw.arg, kw.value))
                if not sinks:
                    continue
                tainted = _taint_at(assigns, node.lineno, c)
                for pname, value in sinks:
                    hazard = _expr_hazard(value, tainted, c)
                    if hazard is None:
                        continue
                    out.append(Violation(
                        code="PTA007", rule="recompile-hazard",
                        path=rel, line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"plan-keying argument '{pname}' of "
                            f"{callee}() in {qual} derives from "
                            f"data-dependent {hazard} without riding "
                            "a grow-only floor: when the live value "
                            "shrinks across a bucket boundary the "
                            "round makes a new launch plan and fresh "
                            "allocations mid-steady-state (a CUDA-"
                            "graph re-capture once rounds are "
                            "captured); route it through a grow-only "
                            "*_floor / pad_bucket(minimum=...) or "
                            "suppress with the one-shot-lane reason"
                        ),
                    ))
    return out
