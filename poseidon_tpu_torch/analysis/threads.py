"""PTA006: a whole-program lockset race detector over the thread model.

The reference's pass (``poseidon_tpu/analysis/threads.py``), unchanged
— it does not depend on the framework — and run with the port's
contracts (its thread classes, handoffs and ``_AsyncFetch`` spawn
wrapper). The reference's notes:

PTA004 (rules.py) checks lock discipline *file-locally* and trusts two
declarations: the ``# pta: background-thread`` def-line markers and the
``ThreadContract.handoffs`` allowlist. This pass VERIFIES both, in the
lockset style of Eraser-class race detection (compute the set of locks
held at every access; a shared attribute whose accesses hold no common
lock is a candidate race), but statically and repo-wide:

1. **Thread model.** Background contexts come from the markers PLUS
   inference the markers cannot drift from:

   - ``threading.Thread(target=self.m)`` spawn sites make ``m`` a
     thread root whether or not it carries a marker;
   - classes subclassing ``threading.Thread`` make ``run`` a root;
   - a lambda / local function passed to a declared spawn wrapper
     (``Contracts.thread_spawn_wrappers`` — ``_AsyncFetch``) is a
     background context: its body runs on the wrapper's daemon thread;
   - methods reachable from a root via ``self.m()`` calls inherit the
     background domain (an unmarked helper called only from ``run`` is
     still background code).

   All background contexts of a class collapse into one "background"
   domain (the classes here run one background thread each; two
   distinct background threads racing each other is out of scope and
   documented as such).

2. **Access maps, across classes.** Every ``self.attr`` read/write in
   a class's methods is recorded with its domain and the lockset held.
   Accesses from OTHER classes are attributed too, through light type
   inference: constructor assignments (``s = _WatchStream(...)``),
   parameter/attribute annotations (``nodes: _WatchStream | None``,
   ``self._streams: dict[str, _WatchStream]``), and container
   derivations (``.get(...)``, ``[...]``, ``.values()`` / ``.items()``
   iteration) — this is what lets the detector see that
   ``ClusterWatcher.tick`` reads ``stream.last_activity`` on the main
   thread while the reader thread writes it.

3. **Lockset intersection.** An attribute written outside ``__init__``
   and reachable from two domains must either hold one common lock on
   the SAME instance at every access (``with self._lock:`` in its own
   methods, ``with stream._lock:`` at a cross-class site) or be a
   declared handoff. ``__init__``'s main-thread accesses are exempt —
   construction happens-before any thread start — but a background
   context ``__init__`` itself creates (a state-touching lambda handed
   to a spawn wrapper) runs concurrently with every later access and
   is NOT exempt.

4. **Handoff verification.** Every declared handoff must correspond to
   a genuinely cross-thread, not-fully-locked attribute; otherwise the
   entry is STALE and reported — a stale allowlist entry is how the
   next real race on that attribute gets silently blessed.

Known limitations (deliberate): races between two distinct background
threads of one class, accesses through untyped aliases, executor-pool
submissions (``pool.map``/``submit`` — the one use in cli.py blocks the
main thread for the pool's lifetime), and attribute mutation through a
method call (``x.gone.set()`` mutates the Event, not the attribute
binding — Event/Queue objects are internally synchronized).
"""

from __future__ import annotations

import ast
import dataclasses

from poseidon_tpu_torch.analysis.contracts import ThreadContract
from poseidon_tpu_torch.analysis.core import (
    FileContext,
    RepoContext,
    Violation,
    files_enforcing,
    repo_rule,
)


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

MAIN = "main"
BACKGROUND = "background"


@dataclasses.dataclass
class Site:
    """One attribute access."""

    path: str
    line: int
    col: int
    write: bool
    domain: str          # MAIN or BACKGROUND
    lockset: frozenset   # lock attr names held on the SAME instance


@dataclasses.dataclass
class _ClassInfo:
    name: str
    path: str
    lineno: int
    node: ast.ClassDef
    methods: dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    member_names: set[str] = dataclasses.field(default_factory=set)
    # method name -> why it is a background context (marker text /
    # "spawn-site" / "thread-subclass run" / "wrapper arg" / "reached
    # from <root>")
    bg_methods: dict[str, str] = dataclasses.field(default_factory=dict)
    # attr -> (kind, class name): light types for self attributes
    attr_types: dict[str, tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )
    accesses: dict[str, list[Site]] = dataclasses.field(
        default_factory=dict
    )


def _terminal_name(node: ast.AST) -> str | None:
    """'Thread' for both ``Thread`` and ``threading.Thread``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _annotation_type(
    node: ast.AST | None, known: set[str]
) -> tuple[str, str] | None:
    """(kind, class) from an annotation mentioning a known class.
    ``C`` / ``C | None`` / ``Optional[C]`` -> ("one", C);
    ``dict[str, C]`` / ``list[C]`` -> ("many", C)."""
    if node is None:
        return None
    names = {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    } | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
    }
    hits = names & known
    if len(hits) != 1:
        return None
    cls = next(iter(hits))
    kind = "one"
    if isinstance(node, ast.Subscript):
        root = _terminal_name(node.value)
        if root in ("dict", "list", "set", "tuple", "frozenset",
                    "Dict", "List", "Set", "Tuple"):
            kind = "many"
    # string annotations ("C") parse as Constant: skip those (rare)
    return kind, cls


def _iter_class_defs(tree: ast.AST):
    """Every ClassDef in the file, including nested ones."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node


# ---------------------------------------------------------------------------
# pass 1: classes, roots, attribute types
# ---------------------------------------------------------------------------


def _collect_classes(
    repo: RepoContext,
    files: dict[str, FileContext],
) -> dict[str, _ClassInfo]:
    """Index every class (by name — the contracts key on bare class
    names) with its methods, background roots, and self-attr types."""
    c = repo.contracts
    out: dict[str, _ClassInfo] = {}
    for rel, fctx in files.items():
        for node in _iter_class_defs(fctx.tree):
            info = _ClassInfo(
                name=node.name, path=rel, lineno=node.lineno, node=node
            )
            for stmt in node.body:
                if isinstance(stmt, _FUNC_NODES):
                    info.methods[stmt.name] = stmt
                    info.member_names.add(stmt.name)
                    if stmt.lineno in fctx.background_lines:
                        info.bg_methods[stmt.name] = "marker"
            if any(
                _terminal_name(b) == "Thread" for b in node.bases
            ) and "run" in info.methods:
                info.bg_methods.setdefault("run", "threading.Thread "
                                                  "subclass")
            # a later class of the same name would shadow the earlier
            # in this index; the repo has no duplicates and the
            # contracts key on bare names, so first wins deterministic
            out.setdefault(node.name, info)

    known = set(out)
    wrappers = set(c.thread_spawn_wrappers)
    for rel, fctx in files.items():
        for node in _iter_class_defs(fctx.tree):
            info = out.get(node.name)
            if info is None or info.path != rel:
                continue
            for meth in info.methods.values():
                args = meth.args.posonlyargs + meth.args.args
                self_name = args[0].arg if args else None
                for sub in ast.walk(meth):
                    # self.<a>: C = ... / self.<a> = C(...)
                    if isinstance(sub, ast.AnnAssign) and \
                            self_name is not None and \
                            isinstance(sub.target, ast.Attribute) and \
                            isinstance(sub.target.value, ast.Name) and \
                            sub.target.value.id == self_name:
                        t = _annotation_type(sub.annotation, known)
                        if t is not None:
                            info.attr_types.setdefault(
                                sub.target.attr, t
                            )
                    if isinstance(sub, ast.Assign) and \
                            isinstance(sub.value, ast.Call):
                        callee = _terminal_name(sub.value.func)
                        if callee in known:
                            for t in sub.targets:
                                if isinstance(t, ast.Attribute) and \
                                        isinstance(t.value, ast.Name) \
                                        and t.value.id == self_name:
                                    info.attr_types.setdefault(
                                        t.attr, ("one", callee)
                                    )
                    # threading.Thread(target=self.m) spawn inference
                    if isinstance(sub, ast.Call) and \
                            _terminal_name(sub.func) == "Thread":
                        for kw in sub.keywords:
                            if kw.arg != "target":
                                continue
                            v = kw.value
                            if isinstance(v, ast.Attribute) and \
                                    isinstance(v.value, ast.Name) and \
                                    v.value.id == self_name and \
                                    v.attr in info.methods:
                                info.bg_methods.setdefault(
                                    v.attr, "Thread(target=) spawn site"
                                )
                    # spawn wrappers: _AsyncFetch(self.m) makes m a
                    # root; _AsyncFetch(lambda: ...) / _AsyncFetch(fn)
                    # marks the class as having a background context
                    # (the lambda/local-def bodies get their domain in
                    # the access walk)
                    if isinstance(sub, ast.Call) and \
                            _terminal_name(sub.func) in wrappers:
                        for a in list(sub.args) + [
                            kw.value for kw in sub.keywords
                        ]:
                            if isinstance(a, ast.Attribute) and \
                                    isinstance(a.value, ast.Name) and \
                                    a.value.id == self_name and \
                                    a.attr in info.methods:
                                info.bg_methods.setdefault(
                                    a.attr,
                                    f"{_terminal_name(sub.func)} arg"
                                )
                            elif isinstance(a, (ast.Lambda, ast.Name)):
                                # pseudo-entry: never a method name, so
                                # it only flips the class interesting
                                info.bg_methods.setdefault(
                                    f"~wrapper:{meth.name}",
                                    "spawn-wrapper callable context",
                                )
            # call-graph closure: self.m() from a background method
            # makes m background too (unmarked helpers stay honest)
            changed = True
            while changed:
                changed = False
                for mname, meth in info.methods.items():
                    if mname not in info.bg_methods:
                        continue
                    args = meth.args.posonlyargs + meth.args.args
                    self_name = args[0].arg if args else None
                    if self_name is None:
                        continue
                    for sub in ast.walk(meth):
                        if isinstance(sub, ast.Call) and \
                                isinstance(sub.func, ast.Attribute) and \
                                isinstance(sub.func.value, ast.Name) \
                                and sub.func.value.id == self_name and \
                                sub.func.attr in info.methods and \
                                sub.func.attr not in info.bg_methods:
                            info.bg_methods[sub.func.attr] = (
                                f"reached from {mname}"
                            )
                            changed = True
    return out


# ---------------------------------------------------------------------------
# pass 2: attribute accesses with domains + locksets
# ---------------------------------------------------------------------------


def _local_types(
    fn: ast.AST,
    known: set[str],
    self_name: str | None,
    own_info: _ClassInfo | None,
) -> dict[str, str]:
    """Flow-insensitive name -> class for this function's locals."""
    types: dict[str, str] = {}

    def attr_kind(expr: ast.AST) -> tuple[str, str] | None:
        """Type of ``self.<a>`` per the owning class's attr_types."""
        if own_info is not None and isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == self_name:
            return own_info.attr_types.get(expr.attr)
        return None

    def value_type(expr: ast.AST) -> str | None:
        """Class of an expression that yields ONE instance."""
        if isinstance(expr, ast.Call):
            callee = _terminal_name(expr.func)
            if callee in known:
                return callee
            # self._streams.get("pods") -> element type
            if isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr == "get":
                t = attr_kind(expr.func.value)
                if t is not None and t[0] == "many":
                    return t[1]
        if isinstance(expr, ast.Subscript):
            t = attr_kind(expr.value)
            if t is not None and t[0] == "many":
                return t[1]
        t = attr_kind(expr)
        if t is not None and t[0] == "one":
            return t[1]
        if isinstance(expr, ast.Name) and expr.id in types:
            return types[expr.id]
        return None

    def elem_type(it: ast.AST) -> tuple[str | None, bool]:
        """(class, values-are-second-tuple-elt) for an iteration
        source: ``self._streams.values()`` / ``.items()`` / a typed
        list attribute."""
        if isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("values", "items"):
            t = attr_kind(it.func.value)
            if t is not None and t[0] == "many":
                return t[1], it.func.attr == "items"
        t = attr_kind(it)
        if t is not None and t[0] == "many":
            return t[1], False
        return None, False

    # parameter annotations
    for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        t = _annotation_type(a.annotation, known)
        if t is not None and t[0] == "one":
            types[a.arg] = t[1]

    for _ in range(2):  # one hop of name->name propagation
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign):
                cls = value_type(sub.value)
                if cls is not None:
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            types[t.id] = cls
            elif isinstance(sub, ast.AnnAssign) and \
                    isinstance(sub.target, ast.Name):
                t = _annotation_type(sub.annotation, known)
                if t is not None and t[0] == "one":
                    types[sub.target.id] = t[1]
            elif isinstance(sub, (ast.For, ast.AsyncFor)):
                cls, is_items = elem_type(sub.iter)
                if cls is not None:
                    tgt = sub.target
                    if is_items and isinstance(tgt, ast.Tuple) and \
                            len(tgt.elts) == 2 and \
                            isinstance(tgt.elts[1], ast.Name):
                        types[tgt.elts[1].id] = cls
                    elif not is_items and isinstance(tgt, ast.Name):
                        types[tgt.id] = cls
            elif isinstance(sub, ast.comprehension):
                cls, is_items = elem_type(sub.iter)
                if cls is not None:
                    tgt = sub.target
                    if is_items and isinstance(tgt, ast.Tuple) and \
                            len(tgt.elts) == 2 and \
                            isinstance(tgt.elts[1], ast.Name):
                        types[tgt.elts[1].id] = cls
                    elif not is_items and isinstance(tgt, ast.Name):
                        types[tgt.id] = cls
    return types


def _collect_accesses(
    repo: RepoContext,
    files: dict[str, FileContext],
    classes: dict[str, _ClassInfo],
    interesting: set[str],
) -> None:
    """Walk every function in the repo recording attribute accesses on
    interesting classes — ``self.attr`` inside the class's own methods
    and ``x.attr`` through typed bases anywhere else — with the
    access's thread domain and held lockset."""
    wrappers = set(repo.contracts.thread_spawn_wrappers)
    known = set(classes)

    def record(cls: str, attr: str, path: str, node: ast.Attribute,
               domain: str, lockset: frozenset):
        info = classes[cls]
        if attr in info.member_names:
            return  # method/property references are calls, not state
        info.accesses.setdefault(attr, []).append(Site(
            path=path, line=node.lineno, col=node.col_offset,
            write=isinstance(node.ctx, (ast.Store, ast.Del)),
            domain=domain, lockset=lockset,
        ))

    def walk_fn(
        fn: ast.AST,
        fctx: FileContext,
        own: _ClassInfo | None,
        self_name: str | None,
        domain: str,
        record_main: bool = True,
    ) -> None:
        types = _local_types(fn, known, self_name, own)

        # lambdas / local defs passed to spawn wrappers run on the
        # wrapper's background thread
        bg_nodes: set[int] = set()
        local_defs: dict[str, ast.AST] = {}
        for sub in ast.walk(fn):
            if isinstance(sub, _FUNC_NODES) and sub is not fn:
                local_defs.setdefault(sub.name, sub)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) and \
                    _terminal_name(sub.func) in wrappers:
                for a in list(sub.args) + [
                    kw.value for kw in sub.keywords
                ]:
                    if isinstance(a, ast.Lambda):
                        bg_nodes.add(id(a))
                    elif isinstance(a, ast.Name) and \
                            a.id in local_defs:
                        bg_nodes.add(id(local_defs[a.id]))

        def base_repr(expr: ast.AST) -> str | None:
            if isinstance(expr, ast.Name):
                return expr.id
            return None

        def rec(n: ast.AST, dom: str, held: tuple):
            if isinstance(n, _FUNC_NODES + (ast.Lambda,)) and n is not fn:
                ndom = dom
                if id(n) in bg_nodes:
                    ndom = BACKGROUND
                elif isinstance(n, _FUNC_NODES) and \
                        n.lineno in fctx.background_lines:
                    ndom = BACKGROUND
                # a lock held at definition time is NOT held when the
                # closure later runs
                body = n.body if isinstance(n.body, list) else [n.body]
                for stmt in body:
                    rec(stmt, ndom, ())
                return
            if isinstance(n, ast.ClassDef):
                return  # nested classes analyzed as their own scopes
            now = held
            if isinstance(n, ast.With):
                for item in n.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Attribute) and \
                            isinstance(ce.value, ast.Name):
                        now = now + ((ce.value.id, ce.attr),)
            def resolve(attr_node: ast.Attribute) -> str | None:
                b = base_repr(attr_node.value)
                if b is None:
                    return None
                cls = None
                if b == self_name and own is not None:
                    cls = own.name
                elif b in types:
                    cls = types[b]
                if cls in classes and cls in interesting:
                    return cls
                return None

            def lockset_for(attr_node: ast.Attribute) -> frozenset:
                b = base_repr(attr_node.value)
                return frozenset(
                    la for (bb, la) in now if bb == b
                )

            if isinstance(n, ast.Attribute):
                cls = resolve(n)
                if cls is not None and (
                    record_main or dom == BACKGROUND
                ):
                    record(cls, n.attr, fctx.path, n, dom,
                           lockset_for(n))
            # ``self.d[k] = v`` / ``del self.d[k]`` mutate the mapping
            # the attribute holds: a WRITE of the attribute for race
            # purposes even though the attribute node itself is only
            # loaded (the metrics-registry pattern). Mutator METHOD
            # calls (``.append``/``.update``) stay reads — documented
            # limitation in the module docstring.
            if isinstance(n, ast.Subscript) and \
                    isinstance(n.ctx, (ast.Store, ast.Del)) and \
                    isinstance(n.value, ast.Attribute):
                cls = resolve(n.value)
                if cls is not None and (
                    record_main or dom == BACKGROUND
                ):
                    site_attr = n.value
                    info = classes[cls]
                    if site_attr.attr not in info.member_names:
                        info.accesses.setdefault(
                            site_attr.attr, []
                        ).append(Site(
                            path=fctx.path, line=n.lineno,
                            col=n.col_offset, write=True,
                            domain=dom,
                            lockset=lockset_for(site_attr),
                        ))
            for child in ast.iter_child_nodes(n):
                rec(child, dom, now)

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            rec(stmt, domain, ())

    for rel, fctx in files.items():
        # class methods (self-based + typed cross-class accesses)
        for node in _iter_class_defs(fctx.tree):
            info = classes.get(node.name)
            if info is None or info.node is not node:
                # a class shadowed in the name index still contributes
                # CROSS-CLASS typed evidence (self-accesses cannot be
                # attributed — its own attr map was not indexed)
                for stmt in node.body:
                    if isinstance(stmt, _FUNC_NODES):
                        dom = (
                            BACKGROUND
                            if stmt.lineno in fctx.background_lines
                            else MAIN
                        )
                        walk_fn(stmt, fctx, None, None, dom)
                continue
            for mname, meth in info.methods.items():
                args = meth.args.posonlyargs + meth.args.args
                self_name = args[0].arg if args else None
                domain = (
                    BACKGROUND if mname in info.bg_methods else MAIN
                )
                # __init__'s MAIN-domain accesses are exempt —
                # construction happens-before any thread start — but
                # a background context it CREATES (a state-touching
                # lambda handed to a spawn wrapper) runs concurrently
                # with every later access and IS recorded
                walk_fn(
                    meth, fctx, info, self_name, domain,
                    record_main=mname != "__init__",
                )
        # module-level functions (typed cross-class accesses only)
        for node in ast.iter_child_nodes(fctx.tree):
            if isinstance(node, _FUNC_NODES):
                walk_fn(node, fctx, None, None, MAIN)


# ---------------------------------------------------------------------------
# the rule: race + stale-handoff reports
# ---------------------------------------------------------------------------


@repo_rule("PTA006", "lockset-races")
def lockset_races(repo: RepoContext) -> list[Violation]:
    c = repo.contracts
    files = files_enforcing(repo, "PTA006")
    classes = _collect_classes(repo, files)
    # a class is analyzed when it has background contexts (declared or
    # inferred) or a declared ThreadContract (whose handoffs must then
    # verify)
    interesting = {
        name for name, info in classes.items()
        if info.bg_methods or name in c.thread_classes
    }
    if not interesting:
        return []
    _collect_accesses(repo, files, classes, interesting)

    out: list[Violation] = []
    for name in sorted(interesting):
        info = classes[name]
        tc = c.thread_classes.get(name)
        declared = tc is not None
        if tc is None:
            tc = ThreadContract()
        for attr, sites in sorted(info.accesses.items()):
            domains = {s.domain for s in sites}
            writes = [s for s in sites if s.write]
            cross = len(domains) >= 2 and bool(writes)
            common = frozenset.intersection(
                *(s.lockset for s in sites)
            ) if sites else frozenset()
            if not cross:
                continue
            if common:
                continue  # consistently protected by one lock
            if attr in tc.handoffs:
                continue  # documented handoff (verified live below)
            bad = next(
                (s for s in writes if not s.lockset), None
            ) or next((s for s in sites if not s.lockset), sites[0])
            extra = (
                "" if declared else
                f"; declare a ThreadContract for {name} in "
                "analysis/contracts.py"
            )
            out.append(Violation(
                code="PTA006", rule="lockset-races",
                path=bad.path, line=bad.line, col=bad.col,
                message=(
                    f"{name}.{attr} is written cross-thread with no "
                    f"common lock (accessed from "
                    f"{' and '.join(sorted(domains))} across "
                    f"{len(sites)} site(s); designated lock "
                    f"self.{tc.lock_attr}): hold the lock at every "
                    "site or declare a documented handoff in "
                    f"analysis/contracts.py{extra}"
                ),
            ))
        # handoff verification: every declared entry must still name a
        # genuinely cross-thread, not-fully-locked attribute
        if declared:
            for attr in sorted(tc.handoffs):
                sites = info.accesses.get(attr, [])
                domains = {s.domain for s in sites}
                writes = [s for s in sites if s.write]
                why = None
                if not sites:
                    why = ("the attribute is never accessed outside "
                           "__init__")
                elif len(domains) < 2:
                    why = (f"every access is on the "
                           f"{next(iter(domains))} thread")
                elif not writes:
                    why = "no thread writes it after construction"
                elif frozenset.intersection(
                    *(s.lockset for s in sites)
                ):
                    why = ("every access already holds a common lock "
                           "— the handoff is redundant")
                if why is not None:
                    out.append(Violation(
                        code="PTA006", rule="lockset-races",
                        path=info.path, line=info.lineno, col=0,
                        message=(
                            f"stale handoff: {name}.{attr} is "
                            f"allowlisted in analysis/contracts.py "
                            f"but {why}; delete the entry (a stale "
                            "allowlist silently blesses the next "
                            "real race on this attribute)"
                        ),
                    ))
    return out
