"""PTA010: lock-order deadlock detection + no-blocking-under-lock.

The reference's pass (``poseidon_tpu/analysis/locks.py``), unchanged
in its analysis and retargeted at the port's contracts: the blocking
vocabulary's device waits are ``torch.cuda.synchronize``, ``.item``
and a ``SyncCounter.read`` (``<counter>.read(...)`` on one of
``Contracts.sync_counter_names``), where the reference's are
``block_until_ready`` and ``device_get``. The reference's notes:

PRs 13-15 grew the daemon from one lock to a dozen — checkpoint
writer, journal, outbox pump, auditor queue, SLO engine, metrics
registry, health latch — each guarding its own class, most of them
touched from both the driver thread and a background thread. Two
whole-program hazards come with that, and nothing verified either
statically until this pass:

1. **Lock-order cycles.** If thread A acquires L1 then L2 while
   thread B acquires L2 then L1, the daemon deadlocks the first time
   the interleaving lands — and a flow-scheduler daemon that stops
   scheduling is strictly worse than one that crashes (the node-failure
   storm tests of PR 15 exist precisely because liveness IS the
   product). This pass records the held-set at every acquisition site
   (``with self._lock:`` / ``with stream._lock:`` through the same
   cross-class type inference PTA006 uses, plus explicit
   ``.acquire()`` calls on lock-named attributes), closes the
   call graph so a lock taken three frames below a ``with`` still
   counts, builds the acquisition-order digraph over (class, attr)
   lock nodes, and reports every strongly-connected component of two
   or more nodes — and every self-edge, because ``threading.Lock`` is
   non-reentrant, so re-acquiring the lock you hold deadlocks a single
   thread with no second party needed (the repo deliberately has no
   RLock: "unknown lock hold times" is exactly the disease this pass
   treats).

2. **Blocking under a lock.** A lock region that performs a blocking
   operation — ``fsync``, a socket round-trip, ``queue.put`` with
   ``block=True``, ``thread.join``, ``time.sleep``, a solver dispatch
   — stalls every thread contending for that lock for the operation's
   full latency. The journal's fsync can take tens of milliseconds on
   a loaded disk; holding the journal lock across it would freeze the
   POST pool's ``_mark`` calls for exactly that long. The vocabulary
   of blocking terminal names lives in
   ``Contracts.blocking_call_names``; two shapes are recognized
   structurally because a name list cannot express them:

   - ``x.join()`` with **zero positional arguments** is a thread
     join (``",".join(parts)`` and ``os.path.join(a, b)`` carry
     positional args and never match; ``t.join(timeout=2.0)``, being
     keyword-only, still matches — a bounded join under a lock still
     stalls contenders for the full timeout);
   - ``q.put(...)`` without ``block=False`` is a blocking enqueue
     (``put_nowait`` and ``put(x, block=False)`` are fine).

   ``.wait()`` is deliberately NOT in the vocabulary:
   ``Condition.wait`` *releases* the underlying lock while waiting —
   flagging it would indict the one pattern that is actually correct
   under a lock. Plain ``.write()``/``.flush()`` are also exempt:
   buffered writes under a lock are how the journal orders its
   records; it is the *barrier* (fsync) that must leave the region.

Both analyses share one method-summary fixpoint: every method's
direct acquisitions, blocking calls, and intra/cross-class callees
(``self.m()``, ``typed_obj.m()``) are collected with the held-set
*inside* the method, then call sites lift callee effects into the
caller under the union of both held-sets until nothing changes. A
blocking call is reported once, at its own site, naming every lock
that can be held when it runs; nested defs and lambdas reset the
held-set (their bodies run later, not under the enclosing ``with``).

Known limitations (deliberate, mirroring PTA006): locks reached
through untyped aliases get file-scoped nodes (sound for blocking
detection — any lock is a lock — but two unresolved aliases of one
lock are two graph nodes, so a cycle through an alias can be missed);
``Lock()`` objects passed as bare function arguments are invisible;
executor-pool submission is not treated as a call edge.
"""

from __future__ import annotations

import ast
import dataclasses

from poseidon_tpu_torch.analysis.core import (
    RepoContext,
    Violation,
    files_enforcing,
    repo_rule,
)
from poseidon_tpu_torch.analysis.threads import (
    _collect_classes,
    _local_types,
    _terminal_name,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# Attribute names treated as locks when they appear as a ``with``
# context manager: anything lock-ish, plus conditions (entering a
# Condition acquires its underlying lock).
_LOCKISH = ("lock", "cond", "mutex")


def _is_lock_attr(attr: str) -> bool:
    a = attr.lower()
    return any(tok in a for tok in _LOCKISH)


@dataclasses.dataclass(frozen=True)
class _Node:
    """One lock in the acquisition-order graph: (owner, attr).

    ``owner`` is a class name when the base object resolves through
    the thread model's type inference (``self`` / a typed local),
    otherwise ``<file>::<name>`` so unrelated unresolved bases never
    collapse into one node.
    """

    owner: str
    attr: str

    def label(self) -> str:
        return f"{self.owner}.{self.attr}"


@dataclasses.dataclass(frozen=True)
class _Site:
    path: str
    line: int
    col: int
    where: str   # "Class.method"


@dataclasses.dataclass
class _Summary:
    """Per-method effects, with the held-set internal to the method."""

    # (held frozenset[_Node], acquired _Node, _Site)
    acqs: set = dataclasses.field(default_factory=set)
    # (held frozenset[_Node], kind str, _Site)
    blocks: set = dataclasses.field(default_factory=set)
    # (held frozenset[_Node], (class, method))
    calls: set = dataclasses.field(default_factory=set)


def _blocking_kind(call: ast.Call, vocab: frozenset) -> str | None:
    """Why this call blocks, or None."""
    name = _terminal_name(call.func)
    if name in vocab:
        return name
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr == "read" and \
            f"read@{_terminal_name(call.func.value)}" in vocab:
        # a SyncCounter.read: a blocking device->host copy
        return "read"
    if call.func.attr == "join" and not call.args:
        # zero positional args: thread join, not str/path join
        return "join"
    if call.func.attr == "put":
        for kw in call.keywords:
            if kw.arg == "block" and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value is False:
                return None
        return "put"
    return None


def _summarize_method(
    rel: str,
    cls_name: str,
    fn: ast.AST,
    classes: dict,
):
    """Returns (summary, rec) — the caller drives ``rec`` over the
    method body so module-level code could reuse the walker later."""
    info = classes.get(cls_name)
    self_name = None
    if fn.args.args:
        self_name = fn.args.args[0].arg
    ltypes = _local_types(fn, set(classes), self_name, info)
    summ = _Summary()

    def owner_of(base: ast.AST) -> str | None:
        if isinstance(base, ast.Name):
            if base.id == self_name:
                return cls_name
            if base.id in ltypes:
                return ltypes[base.id]
            return f"{rel}::{base.id}"
        return None

    def lock_node(expr: ast.AST) -> _Node | None:
        """``<base>.<lockish-attr>`` -> a graph node."""
        if isinstance(expr, ast.Attribute) and _is_lock_attr(expr.attr):
            owner = owner_of(expr.value)
            if owner is not None:
                return _Node(owner, expr.attr)
        return None

    where = f"{cls_name}.{getattr(fn, 'name', '<lambda>')}"

    def site(n: ast.AST) -> _Site:
        return _Site(rel, n.lineno, n.col_offset, where)

    def rec(n: ast.AST, held: frozenset, vocab: frozenset) -> None:
        if isinstance(n, (ast.With, ast.AsyncWith)):
            cur = held
            for item in n.items:
                rec(item.context_expr, cur, vocab)
                node = lock_node(item.context_expr)
                if node is not None:
                    summ.acqs.add((cur, node, site(item.context_expr)))
                    cur = cur | {node}
            for stmt in n.body:
                rec(stmt, cur, vocab)
            return
        if isinstance(n, ast.Call):
            # explicit .acquire() on a lock-named attribute is an
            # acquisition event (held-set unknown past this statement,
            # so it contributes order edges but opens no region)
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "acquire":
                node = lock_node(n.func.value)
                if node is not None:
                    summ.acqs.add((held, node, site(n)))
            kind = _blocking_kind(n, vocab)
            if kind is not None:
                summ.blocks.add((held, kind, site(n)))
            # call edges: self.m() and typed_obj.m()
            if isinstance(n.func, ast.Attribute) and \
                    isinstance(n.func.value, ast.Name):
                base, meth = n.func.value.id, n.func.attr
                target = None
                if base == self_name and info is not None and \
                        meth in info.methods:
                    target = (cls_name, meth)
                elif base in ltypes and \
                        meth in classes[ltypes[base]].methods:
                    target = (ltypes[base], meth)
                if target is not None:
                    summ.calls.add((held, target))
            for child in ast.iter_child_nodes(n):
                rec(child, held, vocab)
            return
        if isinstance(n, _FUNC_NODES + (ast.Lambda,)) and n is not fn:
            # a nested def/lambda runs later, not under this lock
            for child in ast.iter_child_nodes(n):
                rec(child, frozenset(), vocab)
            return
        for child in ast.iter_child_nodes(n):
            rec(child, held, vocab)

    return summ, rec


def _build_summaries(
    repo: RepoContext, files: dict, classes: dict
) -> dict:
    vocab = frozenset(repo.contracts.blocking_call_names) | frozenset(
        f"read@{r}" for r in repo.contracts.sync_counter_names
    )
    summaries: dict[tuple[str, str], _Summary] = {}
    for cls_name, info in classes.items():
        for mname, fn in info.methods.items():
            summ, rec = _summarize_method(
                info.path, cls_name, fn, classes
            )
            for stmt in fn.body:
                rec(stmt, frozenset(), vocab)
            summaries[(cls_name, mname)] = summ
    return summaries


def _close_summaries(summaries: dict) -> None:
    """Lift callee effects into callers until fixpoint. Monotone over
    finite sets of (held, payload) pairs, so this terminates; the cap
    is a backstop against pathological call chains."""
    for _ in range(32):
        changed = False
        for summ in summaries.values():
            for held, target in list(summ.calls):
                callee = summaries.get(target)
                if callee is None:
                    continue
                for h2, node, s in callee.acqs:
                    eff = (held | h2, node, s)
                    if eff not in summ.acqs:
                        summ.acqs.add(eff)
                        changed = True
                for h2, kind, s in callee.blocks:
                    eff = (held | h2, kind, s)
                    if eff not in summ.blocks:
                        summ.blocks.add(eff)
                        changed = True
        if not changed:
            return


def _cycles(edges: dict) -> list[list[_Node]]:
    """SCCs of size >= 2, plus self-loop nodes, as node lists."""
    index: dict[_Node, int] = {}
    low: dict[_Node, int] = {}
    on_stack: set[_Node] = set()
    stack: list[_Node] = []
    counter = [0]
    out: list[list[_Node]] = []
    nodes = set(edges)
    for targets in edges.values():
        nodes.update(targets)

    def strong(v: _Node) -> None:
        # iterative Tarjan (the lock graph is tiny, but recursion
        # depth should not depend on analyzed-repo shape)
        work = [(v, iter(sorted(edges.get(v, {}),
                                key=lambda n: (n.owner, n.attr))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(
                        edges.get(w, {}),
                        key=lambda n: (n.owner, n.attr)))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w is node:
                        break
                if len(scc) >= 2 or (
                    len(scc) == 1 and scc[0] in edges.get(scc[0], {})
                ):
                    out.append(sorted(
                        scc, key=lambda n: (n.owner, n.attr)
                    ))

    for v in sorted(nodes, key=lambda n: (n.owner, n.attr)):
        if v not in index:
            strong(v)
    return out


@repo_rule("PTA010", "lock-order")
def lock_order(repo: RepoContext) -> list[Violation]:
    files = files_enforcing(repo, "PTA010")
    if not files:
        return []
    classes = _collect_classes(repo, files)
    summaries = _build_summaries(repo, files, classes)
    _close_summaries(summaries)

    out: list[Violation] = []

    # ---- no blocking under a lock ------------------------------------
    # report each blocking site once, naming every lock that can be
    # held when it runs (direct region or any calling chain)
    by_site: dict[_Site, tuple[str, set]] = {}
    for summ in summaries.values():
        for held, kind, s in summ.blocks:
            if not held:
                continue
            kind0, locks = by_site.setdefault(s, (kind, set()))
            locks.update(held)
    for s in sorted(by_site, key=lambda s: (s.path, s.line, s.col)):
        kind, locks = by_site[s]
        names = ", ".join(sorted(n.label() for n in locks))
        out.append(Violation(
            code="PTA010", rule="lock-order",
            path=s.path, line=s.line, col=s.col,
            message=(
                f"blocking call '{kind}' in {s.where} runs while "
                f"holding {names} — every thread contending for the "
                "lock stalls for the call's full latency; move the "
                "call outside the lock region (snapshot under the "
                "lock, block after release) or add a reasoned "
                "'# noqa: PTA010 -- why' if the lock MUST cover it"
            ),
        ))

    # ---- acquisition-order cycles ------------------------------------
    # edge held-lock -> acquired-lock, keeping one witness site per
    # edge (the earliest in file order, for a stable report)
    edges: dict[_Node, dict[_Node, _Site]] = {}
    for summ in summaries.values():
        for held, node, s in summ.acqs:
            for h in held:
                tgt = edges.setdefault(h, {})
                prev = tgt.get(node)
                if prev is None or (s.path, s.line) < \
                        (prev.path, prev.line):
                    tgt[node] = s
    for scc in _cycles(edges):
        # describe the cycle through its witness edges
        parts = []
        anchor: _Site | None = None
        scc_set = set(scc)
        for a in scc:
            for b, s in sorted(
                edges.get(a, {}).items(),
                key=lambda kv: (kv[0].owner, kv[0].attr),
            ):
                if b in scc_set and (len(scc) > 1 or a == b):
                    parts.append(
                        f"{a.label()} -> {b.label()} "
                        f"(in {s.where} at {s.path}:{s.line})"
                    )
                    if anchor is None or (s.path, s.line) < \
                            (anchor.path, anchor.line):
                        anchor = s
        if anchor is None:
            continue
        out.append(Violation(
            code="PTA010", rule="lock-order",
            path=anchor.path, line=anchor.line, col=anchor.col,
            message=(
                "lock acquisition-order cycle (deadlock): "
                + "; ".join(parts)
                + " — two threads taking these locks in opposite "
                "order deadlock on the first bad interleaving "
                "(and a self-edge deadlocks a single thread: "
                "threading.Lock is non-reentrant); pick one global "
                "order and acquire in it everywhere"
            ),
        ))

    out.sort(key=lambda v: (v.path, v.line, v.col))
    return out
