"""The port's file-local rule set (PTA001-PTA005), in torch meanings.

The counterpart of the reference's ``poseidon_tpu/analysis/rules.py``.
PTA002, PTA004 and PTA005 are the reference's passes unchanged (they do
not depend on the framework; PTA005 is held against the port's
``trace.py`` vocabulary and ``cli.py`` flags). PTA001 and PTA003 keep
their codes and their intent, with what a device sync and a rebuilt
program are in PyTorch. Rules are scoped by ``contracts.py`` — the
hot-path files/functions, the cluster-sized collection names, the
thread classes — so a generic pattern (a ``for`` loop, an ``int()``
call) is only a violation where the repo's stated invariants forbid it.

PTA001 no-host-sync
    BAD  (inside a hot-path scope)::

        val = cost.item()              # device sync mid-round
        host = asg_dev.cpu().numpy()   # host materialization
        rows = torch.nonzero(mask)     # sizes itself from the data
        if conv:                       # bool() of a device tensor
    GOOD::

        flags = syncs.read(torch.stack([done, any_waiting]))  # counted

    Device data: parameters annotated with a device type, torch calls
    that name a device or take a device operand, the round's device
    pieces, ``.to(device)``; the one sanctioned read is
    ``SyncCounter.read`` (its result is host data).

PTA002 no-cluster-loops
    BAD  (inside an O(churn) scope)::

        for t in cluster.tasks: ...    # O(cluster) every round
    GOOD::

        for d in dset.place: ...       # O(churn): only this round's deltas

PTA003 launch-hygiene
    BAD::

        fast = torch.compile(price)    # not a hand kernel
        lib = ctypes.CDLL(path)        # outside kernels/loader.py
        p = row_stream.plan(rows, Mp, 0, sms, occ)   # outside its cache
        def _solve(dev, smax=[]): ...  # mutable default on a plan key
    GOOD::

        plan = PLANS.get(dev, Tp, Mp, sm_fn, occ_fn)  # cached, counted

PTA004 lock-discipline
    BAD::

        def run(self):  # pta: background-thread
            self.rounds += 1           # unlocked cross-thread mutation
    GOOD::

        def run(self):  # pta: background-thread
            with self._lock:
                self.rounds += 1
    (or declare the attribute as a documented handoff in contracts.py)

PTA005 surface-consistency
    BAD::

        self.trace.emit("REBALANCE")   # not in trace.EVENT_TYPES
        p.add_argument("--new_flag")   # absent from README / deploy cfg
    GOOD::

        self.trace.emit("MIGRATE")     # declared vocabulary
"""

from __future__ import annotations

import ast
import builtins
import re

from poseidon_tpu_torch.analysis.contracts import Contracts
from poseidon_tpu_torch.analysis.core import (
    FileContext,
    RepoContext,
    Violation,
    file_rule,
    repo_rule,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_BUILTINS = frozenset(dir(builtins))


# ---- shared AST helpers ------------------------------------------------


def _dotted(node: ast.AST) -> str | None:
    """'jax.device_get' for Attribute chains rooted at a Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_functions(tree: ast.AST):
    """Yield (node, qualname, depth) for every def, depth-first.
    Qualnames join class and function names with '.'; depth counts
    enclosing FUNCTIONS only (a method of a top-level class is depth 0).
    """
    def walk(node, prefix, depth):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                qual = f"{prefix}{child.name}"
                yield child, qual, depth
                yield from walk(child, qual + ".", depth + 1)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", depth)
            else:
                yield from walk(child, prefix, depth)
    yield from walk(tree, "", 0)


def iter_own_nodes(fn: ast.AST):
    """Walk a function's own body, NOT descending into nested defs or
    classes (they are analyzed as their own scopes)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNC_NODES + (ast.ClassDef,)):
            continue  # nested scope: analyzed as its own function
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _names_in(node: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    }


def _bound_names(target: ast.AST) -> set[str]:
    """Names a target expression BINDS. ``obj.attr = x`` / ``d[k] = x``
    mutate an object without binding any name, so they contribute
    nothing (unlike ``_names_in``, which would claim ``obj``)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        out: set[str] = set()
        for e in target.elts:
            out |= _bound_names(e)
        return out
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return set()


# ---- PTA001: no host syncs in hot-path scopes --------------------------

# tensor attributes and methods that read metadata the host already
# holds: they never touch the device
_METADATA_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "layout",
    "itemsize", "nbytes", "requires_grad",
})
_METADATA_METHODS = frozenset({
    "size", "dim", "numel", "nelement", "is_contiguous", "data_ptr",
    "element_size", "get_device", "stride", "storage_offset",
    "is_floating_point",
})
# device->host reads of a tensor (``.item()`` fires on any base, as the
# reference's does; the others on a device tensor)
_READ_METHODS = ("tolist", "numpy")
_HOST_MATERIALIZERS = {"np.asarray", "numpy.asarray", "np.array",
                       "numpy.array"}
# ops whose output size depends on the data: on CUDA each one copies a
# count back to the host before it can allocate its result
_IMPLICIT_SYNC_OPS = frozenset({
    "nonzero", "masked_select", "unique", "unique_consecutive",
    "argwhere",
})


def _terminal(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _terminal(node.func)
    return None


def _is_sync_read(call: ast.Call, c: Contracts) -> bool:
    """``<counter>.read(x)``: the one sanctioned device->host read
    (``guards.SyncCounter.read``); its result is host data."""
    f = call.func
    return (
        isinstance(f, ast.Attribute) and f.attr == "read"
        and (_terminal(f.value) in c.sync_counter_names
             or _terminal(f.value) == "SyncCounter")
    )


def _is_cpu_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (
        isinstance(node, ast.Call) and _dotted(node.func) == "torch.device"
        and bool(node.args) and _is_cpu_literal(node.args[0])
    )


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
    "cpu"))``."""
    return any(_is_cpu_literal(a) for a in call.args) or any(
        kw.arg == "device" and _is_cpu_literal(kw.value)
        for kw in call.keywords
    )


def _annotation_names(node: ast.AST | None) -> set[str]:
    if node is None:
        return set()
    out = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    out |= {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}
    out |= {
        w for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
        for w in re.findall(r"\w+", n.value)
    }
    return out


class _DeviceTaint:
    """Which expressions of one function hold device data.

    Sources: parameters annotated with a device type
    (``Contracts.device_annotations``), torch calls that name a device
    (``device=`` other than the CPU) or take a device operand, the
    round's device pieces (``Contracts.device_producers``), and
    ``.to(<device>)`` / ``.cuda()``. Device data spreads through
    arithmetic, subscripts, non-metadata attributes and method calls;
    ``.shape``/``.dtype``/``.numel()`` and friends are host metadata,
    and a ``SyncCounter.read`` result is host data (the barrier)."""

    def __init__(self, fn, c: Contracts, inherited: set[str]):
        self.c = c
        self.names: set[str] = set(inherited)
        args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        for a in args:
            if _annotation_names(a.annotation) & set(c.device_annotations):
                self.names.add(a.arg)
        assigns: list[tuple[set[str], ast.AST]] = []
        for node in iter_own_nodes(fn):
            if isinstance(node, ast.Assign):
                targets: set[str] = set()
                for t in node.targets:
                    targets |= _bound_names(t)
                assigns.append((targets, node.value))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                    isinstance(node.target, ast.Name) and \
                    node.value is not None:
                assigns.append(({node.target.id}, node.value))
            elif isinstance(node, ast.NamedExpr):
                assigns.append(({node.target.id}, node.value))
        for _ in range(4):  # name -> name propagation to a fixpoint
            before = len(self.names)
            for targets, value in assigns:
                if self.tainted(value):
                    self.names |= targets
            if len(self.names) == before:
                break

    def _producer(self, call: ast.Call) -> bool:
        c = self.c
        d = _dotted(call.func)
        if d is None:
            return False
        if d.startswith("torch."):
            named = [kw.value for kw in call.keywords if kw.arg == "device"]
            if named:
                return not _is_cpu_literal(named[0])
            if d in c.device_producer_exceptions:
                return False
            return any(self.tainted(a) for a in call.args) or any(
                self.tainted(kw.value) for kw in call.keywords
            )
        for p in c.device_producers:
            if p.endswith("."):
                continue
            if d == p or d.endswith("." + p):
                return True
        return False

    def tainted(self, e: ast.AST | None) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            return e.attr not in _METADATA_ATTRS and self.tainted(e.value)
        if isinstance(e, ast.Subscript):
            return self.tainted(e.value)
        if isinstance(e, ast.Starred):
            return self.tainted(e.value)
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(self.tainted(x) for x in e.elts)
        if isinstance(e, ast.BinOp):
            return self.tainted(e.left) or self.tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.tainted(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.tainted(x) for x in e.values)
        if isinstance(e, ast.IfExp):
            return self.tainted(e.body) or self.tainted(e.orelse)
        if isinstance(e, ast.Compare):
            if all(isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for o in e.ops):
                return False
            return any(self.tainted(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.Call):
            if _is_sync_read(e, self.c):
                return False
            f = e.func
            if isinstance(f, ast.Name) and f.id in _BUILTINS and \
                    f.id not in self.c.device_producers:
                return False
            if isinstance(f, ast.Attribute):
                if f.attr in _METADATA_METHODS or f.attr in _READ_METHODS \
                        or f.attr in ("item", "cpu"):
                    return False
                if f.attr == "cuda":
                    return True
                if f.attr == "to":
                    if _to_cpu(e):
                        return False
                    if self.tainted(f.value):
                        return True
                    return any(
                        "device" in (_terminal(a) or "")
                        for a in [*e.args, *(k.value for k in e.keywords)]
                    )
                if self.tainted(f.value):
                    return True
            return self._producer(e)
        return False

    def truthiness(self, test: ast.AST) -> bool:
        """Does evaluating ``test`` as a condition read a device value
        (``bool(tensor)``)?"""
        if isinstance(test, ast.BoolOp):
            return any(self.truthiness(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.truthiness(test.operand)
        return self.tainted(test)


def _is_upload(call: ast.Call, taint: "_DeviceTaint") -> bool:
    """A copy of host data to a device: ``torch.tensor``/``as_tensor``
    naming a device, or ``.to(<device>)``/``.cuda()`` of host data."""
    f = call.func
    d = _dotted(f)
    if d in ("torch.tensor", "torch.as_tensor"):
        return any(kw.arg == "device" and not _is_cpu_literal(kw.value)
                   for kw in call.keywords)
    if isinstance(f, ast.Attribute) and not taint.tainted(f.value):
        if f.attr == "cuda":
            return True
        if f.attr == "to" and not _to_cpu(call):
            return any(
                "device" in (_terminal(a) or "")
                for a in [*call.args, *(k.value for k in call.keywords)]
            )
    return False


def _sync_site(c: Contracts, path: str, qual: str) -> bool:
    return any(
        path.endswith(suffix) and (qual == fn or qual.startswith(fn + "."))
        for suffix, fn, _reason in c.sync_sites
    )


def iter_sync_sites(ctx: FileContext):
    """Every synchronising call PTA001 can name in ``ctx``'s hot-path
    scopes, as (node, kind, message, qualname): ``kind`` is "read" (a
    ``SyncCounter.read``, sanctioned and counted), "upload-declared" (a
    blocking upload in a function ``Contracts.sync_sites`` declares),
    "upload" (an undeclared one) or "sync" (any other device read).
    PTA001 reports the last two; the runtime sync map (chip_smoke
    [analysis]) holds every site the card reports to this inventory."""
    c = ctx.contracts
    whole_file = any(ctx.path.endswith(s) for s in c.hot_path_files)
    taints: dict[int, set[str]] = {}
    for fn, qual, _depth in iter_functions(ctx.tree):
        # a nested function closes over its parent's device names
        # (defs come parent first, so the nearest ancestor writes last)
        taint = _DeviceTaint(fn, c, taints.get(id(fn), set()))
        for sub in ast.walk(fn):
            if isinstance(sub, _FUNC_NODES) and sub is not fn:
                taints[id(sub)] = set(taint.names)
        if not (whole_file or ctx.in_scope(c.hot_path_functions, qual)):
            continue
        where = f"hot-path scope {qual}"
        for node in iter_own_nodes(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if taint.truthiness(node.test):
                    yield (node.test, "sync", "the truth value of a device "
                           f"tensor blocks on the device ({where})", qual)
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            d = _dotted(f)
            if _is_sync_read(node, c):
                yield node, "read", "the sanctioned, counted read", qual
                continue
            if isinstance(f, ast.Attribute) and f.attr in ("item", "cpu"):
                yield (node, "sync", f".{f.attr}() forces a device sync "
                       f"inside {where}", qual)
                continue
            if isinstance(f, ast.Attribute) and f.attr in _READ_METHODS \
                    and taint.tainted(f.value):
                yield (node, "sync", f".{f.attr}() reads a device tensor "
                       f"to the host inside {where}", qual)
                continue
            if isinstance(f, ast.Attribute) and f.attr == "to" and \
                    _to_cpu(node) and taint.tainted(f.value):
                yield (node, "sync", ".to('cpu') reads a device tensor to "
                       f"the host inside {where}", qual)
                continue
            if d is not None and (d == "torch.cuda.synchronize"
                                  or d.endswith(".synchronize")):
                yield (node, "sync", f"{d}() waits for the device inside "
                       f"{where}", qual)
                continue
            if d in _HOST_MATERIALIZERS and node.args and \
                    taint.tainted(node.args[0]):
                yield (node, "sync", f"{d} of a device tensor materializes "
                       f"it on the host inside {where}", qual)
                continue
            if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
                    and node.args and taint.tainted(node.args[0]):
                yield (node, "sync", f"{f.id}() on a device tensor blocks "
                       f"on the device ({where})", qual)
                continue
            if _is_upload(node, taint):
                if _sync_site(c, ctx.path, qual):
                    yield node, "upload-declared", "declared upload", qual
                else:
                    yield (node, "upload", "blocking upload of host data (a "
                           "synchronising copy on the card) inside "
                           f"{where}: fill on the device, or declare the "
                           "upload in Contracts.sync_sites with its reason",
                           qual)
                continue
            op = None
            if d is not None and d.startswith("torch.") and \
                    d[len("torch."):] in _IMPLICIT_SYNC_OPS:
                op = d
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _IMPLICIT_SYNC_OPS and taint.tainted(f.value):
                op = f".{f.attr}()"
            elif d == "torch.where" and len(node.args) == 1 and \
                    not node.keywords:
                op = "torch.where(cond)"
            elif (d == "torch.repeat_interleave" or (
                    isinstance(f, ast.Attribute)
                    and f.attr == "repeat_interleave"
                    and taint.tainted(f.value))) and not any(
                        kw.arg == "output_size" for kw in node.keywords):
                op = "repeat_interleave without output_size"
            if op is not None:
                yield (node, "sync", f"{op} sizes its result from the data: "
                       f"on the card it copies a count to the host ({where})",
                       qual)


@file_rule("PTA001", "no-host-sync")
def no_host_sync(ctx: FileContext) -> list[Violation]:
    return [
        Violation(code="PTA001", rule="no-host-sync", path=ctx.path,
                  line=node.lineno, col=node.col_offset, message=msg)
        for node, kind, msg, _qual in iter_sync_sites(ctx)
        if kind in ("sync", "upload")
    ]


def sync_inventory(root, contracts: Contracts | None = None) -> list[dict]:
    """The static sync inventory of the port's tree: one dict per site
    of ``iter_sync_sites`` (path, first and last line of the call,
    qualname, kind), suppressed sites included."""
    import pathlib

    from poseidon_tpu_torch.analysis.contracts import DEFAULT_CONTRACTS
    from poseidon_tpu_torch.analysis.core import (
        build_file_context, default_targets,
    )

    contracts = contracts or DEFAULT_CONTRACTS
    root = pathlib.Path(root).resolve()
    out = []
    for path in default_targets(root):
        rel = path.resolve().relative_to(root).as_posix()
        ctx, _ = build_file_context(path, rel, contracts)
        if ctx is None:
            continue
        for node, kind, _msg, qual in iter_sync_sites(ctx):
            out.append({"path": rel, "start": node.lineno,
                        "end": node.end_lineno or node.lineno,
                        "qual": qual, "kind": kind})
    return out


# ---- PTA002: no cluster-sized loops in O(churn) scopes -----------------


def _cluster_sized_ref(node: ast.AST, c: Contracts) -> str | None:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in c.cluster_sized_names:
            return n.id
        if isinstance(n, ast.Attribute) and n.attr in c.cluster_sized_names:
            return n.attr
    return None


@file_rule("PTA002", "no-cluster-loops")
def no_cluster_loops(ctx: FileContext) -> list[Violation]:
    c = ctx.contracts
    out: list[Violation] = []
    for fn, qual, _depth in iter_functions(ctx.tree):
        if not ctx.in_scope(c.ochurn_functions, qual):
            continue
        for node in iter_own_nodes(fn):
            if isinstance(node, ast.For):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            else:
                continue
            for it in iters:
                name = _cluster_sized_ref(it, c)
                if name:
                    out.append(Violation(
                        code="PTA002", rule="no-cluster-loops",
                        path=ctx.path, line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"Python loop over cluster-sized '{name}' "
                            f"in O(churn) scope {qual}: iterate this "
                            "round's deltas, or maintain a counter"
                        ),
                    ))
                    break
    return out


# ---- PTA003: launch hygiene --------------------------------------------
#
# The reference's jit hygiene keeps compiled programs from being rebuilt
# per call. Its torch meaning: a hand kernel is built once by the loader
# and launched with a cached plan, so (a) nothing is compiled by
# torch.compile or torch.jit (neither is a port of a kernel), (b) only
# the loader opens a shared library, (c) a launch plan is made only by
# its cache, and (d) an argument that keys a plan carries no mutable
# default.

_MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_LIBRARY_LOADERS = ("CDLL", "PyDLL", "LoadLibrary")


def _plan_site_allowed(
    sites: tuple[tuple[str, str], ...], path: str, qual: str
) -> bool:
    for site, _reason in sites:
        file, _, scope = site.partition("::")
        if not (path.endswith(file) or path.startswith(file)):
            continue
        if not scope or qual == scope or qual.startswith(scope + "."):
            return True
    return False


def _plan_builder(call: ast.Call, path: str, builders) -> str | None:
    """The declared plan builder ``call`` invokes, or None: a dotted
    suffix match (``row_stream.plan(...)``), or the bare name inside the
    builder's own module (``plan(...)`` in ``kernels/row_stream.py``)."""
    d = _dotted(call.func)
    if d is None:
        return None
    for key in builders:
        if key == "*":
            continue
        if d == key or d.endswith("." + key):
            return key
        mod, _, name = key.rpartition(".")
        if mod and d == name and path.endswith(f"kernels/{mod}.py"):
            return key
    return None


@file_rule("PTA003", "launch-hygiene")
def launch_hygiene(ctx: FileContext) -> list[Violation]:
    c = ctx.contracts
    out: list[Violation] = []

    def flag(node, msg):
        out.append(Violation(
            code="PTA003", rule="launch-hygiene", path=ctx.path,
            line=node.lineno, col=node.col_offset, message=msg,
        ))

    quals: dict[int, str] = {}
    for fn, qual, _depth in iter_functions(ctx.tree):
        for node in iter_own_nodes(fn):
            quals[id(node)] = qual
        # (d) a mutable default on an argument that keys a plan
        keys = c.plan_key_params.get(fn.name)
        if keys:
            pos = fn.args.posonlyargs + fn.args.args
            pairs = list(zip(pos[len(pos) - len(fn.args.defaults):],
                             fn.args.defaults))
            pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs,
                                             fn.args.kw_defaults)
                      if d is not None]
            for a, default in pairs:
                if a.arg in keys and (
                    isinstance(default, _MUTABLE_DEFAULTS) or (
                        isinstance(default, ast.Call)
                        and isinstance(default.func, ast.Name)
                        and default.func.id in ("list", "dict", "set"))
                ):
                    flag(default, f"mutable default on '{a.arg}' of "
                                  f"{qual}, which keys a launch plan: "
                                  "one shared object mutated between "
                                  "calls changes the plan under the "
                                  "cache's key")
    loader = c.kernel_loader_module
    wild = c.plan_builders.get("*", ())
    inner = {
        id(n.value) for n in ast.walk(ctx.tree)
        if isinstance(n, ast.Attribute)
    }
    for node in ast.walk(ctx.tree):
        d = _dotted(node) if isinstance(node, ast.Attribute) else None
        # (a) torch.compile / torch.jit.*: as a call, a decorator or a
        # bare reference alike
        if d is not None and (d == "torch.compile" or d == "torch.jit"
                              or d.startswith("torch.jit.")):
            if id(node) not in inner:  # the outermost chain only
                flag(node, f"{d}: the port compiles nothing with "
                           "torch.compile or TorchScript — a kernel is "
                           "written by hand and built by the loader")
            continue
        if not isinstance(node, ast.Call):
            continue
        cd = _dotted(node.func)
        qual = quals.get(id(node), "<module>")
        # (b) shared libraries are opened by the kernel loader only
        if cd is not None and cd.rpartition(".")[2] in _LIBRARY_LOADERS \
                and not (loader and ctx.path.endswith(loader)):
            flag(node, f"{cd}(...) outside {loader or 'the loader'}: "
                       "kernel libraries are built, loaded and bound "
                       "once, by the loader")
            continue
        # (c) launch plans are made by their caches
        key = _plan_builder(node, ctx.path, c.plan_builders)
        if key is not None and not _plan_site_allowed(
            c.plan_builders.get(key, ()) + wild, ctx.path, qual
        ):
            flag(node, f"launch plan {key}(...) built in {qual}, outside "
                       "its cache: a plan is made once per key and "
                       "counted by note_build(); take it from the cache")
    return out


# ---- PTA004: lock discipline for cross-thread state --------------------


@file_rule("PTA004", "lock-discipline")
def lock_discipline(ctx: FileContext) -> list[Violation]:
    c = ctx.contracts
    out: list[Violation] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        tc = c.thread_classes.get(node.name)
        if tc is None:
            continue
        # (attr -> list of (line, col, is_write, domain, locked))
        accesses: dict[str, list[tuple[int, int, bool, str, bool]]] = {}

        def visit_fn(fn, self_name, domain):
            lock_expr = f"{self_name}.{tc.lock_attr}"

            def rec(n, locked):
                if isinstance(n, _FUNC_NODES):
                    nested_domain = (
                        "background"
                        if n.lineno in ctx.background_lines
                        else domain
                    )
                    # nested functions capture self from the method;
                    # a lock held at DEFINITION time is not held when
                    # the closure later runs, so locked resets
                    for stmt in n.body:
                        rec_nested(stmt, False, nested_domain)
                    return
                if isinstance(n, ast.ClassDef):
                    return
                now_locked = locked
                if isinstance(n, ast.With):
                    if any(
                        _dotted(item.context_expr) == lock_expr
                        for item in n.items
                    ):
                        now_locked = True
                if isinstance(n, ast.Attribute) and \
                        isinstance(n.value, ast.Name) and \
                        n.value.id == self_name:
                    is_write = isinstance(n.ctx, (ast.Store, ast.Del))
                    accesses.setdefault(n.attr, []).append(
                        (n.lineno, n.col_offset, is_write, domain,
                         now_locked)
                    )
                for child in ast.iter_child_nodes(n):
                    rec(child, now_locked)

            def rec_nested(n, locked, nested_domain):
                nonlocal domain
                saved, domain = domain, nested_domain
                rec(n, locked)
                domain = saved

            for stmt in fn.body:
                rec(stmt, False)

        for fn in node.body:
            if not isinstance(fn, _FUNC_NODES):
                continue
            if fn.name == "__init__":
                # construction happens-before any thread start: the
                # documented handoff for initial state
                continue
            args = fn.args.posonlyargs + fn.args.args
            if not args:
                continue
            self_name = args[0].arg
            domain = (
                "background" if fn.lineno in ctx.background_lines
                else "main"
            )
            visit_fn(fn, self_name, domain)

        for attr, sites in accesses.items():
            domains_writing = {d for (_, _, w, d, _) in sites if w}
            domains_all = {d for (_, _, _, d, _) in sites}
            if not domains_writing or len(domains_all) < 2:
                continue
            if attr in tc.handoffs:
                continue
            for line, col, is_write, domain, locked in sites:
                if locked:
                    continue
                out.append(Violation(
                    code="PTA004", rule="lock-discipline",
                    path=ctx.path, line=line, col=col,
                    message=(
                        f"{node.name}.{attr} is written cross-thread "
                        f"({'write' if is_write else 'read'} from the "
                        f"{domain} thread without holding "
                        f"self.{tc.lock_attr}); lock it or declare a "
                        "documented handoff in analysis/contracts.py"
                    ),
                ))
    return out


# ---- PTA005: trace vocabulary + flag surface consistency ---------------


def _trace_vocab(ctx: FileContext, vocab_name: str) -> set[str] | None:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == vocab_name
            for t in node.targets
        ):
            consts = {
                n.value for n in ast.walk(node.value)
                if isinstance(n, ast.Constant)
                and isinstance(n.value, str)
            }
            if consts:
                return consts
    return None


@repo_rule("PTA005", "surface-consistency")
def surface_consistency(repo: RepoContext) -> list[Violation]:
    c = repo.contracts
    out: list[Violation] = []

    # -- trace event vocabulary --
    trace_ctx = next(
        (f for rel, f in repo.files.items()
         if rel.endswith(c.trace_module)),
        None,
    )
    vocab: set[str] | None = None
    if trace_ctx is not None:
        vocab = _trace_vocab(trace_ctx, c.trace_vocab_name)
        if vocab is None:
            out.append(Violation(
                code="PTA005", rule="surface-consistency",
                path=trace_ctx.path, line=1, col=0,
                message=(
                    f"{c.trace_vocab_name} vocabulary declaration not "
                    f"found in {c.trace_module}"
                ),
            ))
    if vocab is not None:
        for rel, fctx in repo.files.items():
            for node in ast.walk(fctx.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "emit"):
                    continue
                base = node.func.value
                base_name = (
                    base.attr if isinstance(base, ast.Attribute)
                    else base.id if isinstance(base, ast.Name) else None
                )
                if base_name != "trace":
                    continue
                if not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    if arg.value not in vocab:
                        out.append(Violation(
                            code="PTA005", rule="surface-consistency",
                            path=rel, line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"trace event '{arg.value}' is not in "
                                f"the declared {c.trace_vocab_name} "
                                f"vocabulary ({c.trace_module})"
                            ),
                        ))
                else:
                    out.append(Violation(
                        code="PTA005", rule="surface-consistency",
                        path=rel, line=node.lineno, col=node.col_offset,
                        message=(
                            "dynamic trace event name: emit a literal "
                            "from the declared vocabulary (or suppress "
                            "with a reason)"
                        ),
                    ))

    # -- cli flag surface --
    cli_ctx = next(
        (f for rel, f in repo.files.items()
         if rel.endswith(c.flag_module)),
        None,
    )
    if cli_ctx is not None:
        flags: list[tuple[str, int, int]] = []
        for node in ast.walk(cli_ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"
                    and node.args):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith("--")):
                continue
            hidden = any(
                kw.arg == "help"
                and isinstance(kw.value, ast.Attribute)
                and kw.value.attr == "SUPPRESS"
                for kw in node.keywords
            )
            if not hidden:
                flags.append((arg.value, node.lineno, node.col_offset))
        doc_texts = {
            doc: repo.read_text(doc) for doc in c.flag_doc_files
        }
        for doc, text in doc_texts.items():
            if text is None:
                out.append(Violation(
                    code="PTA005", rule="surface-consistency",
                    path=cli_ctx.path, line=1, col=0,
                    message=f"flag doc file '{doc}' not found",
                ))
        for flag, line, col in flags:
            pattern = re.compile(re.escape(flag) + r"(?![\w-])")
            for doc, text in doc_texts.items():
                if text is not None and not pattern.search(text):
                    out.append(Violation(
                        code="PTA005", rule="surface-consistency",
                        path=cli_ctx.path, line=line, col=col,
                        message=(
                            f"flag {flag} is not documented in {doc}"
                        ),
                    ))

    # -- metric family surface --
    # every poseidon_* family registered in the metrics module must
    # appear in the README's observability reference and vice versa:
    # an operator alerting on a renamed family pages on silence, and a
    # documented-but-unregistered family is a dashboard query that
    # matches nothing. Same drift-proofing shape as the trace
    # vocabulary above: the code side is the AST (literal first args
    # to .counter/.gauge/.histogram), the doc side is a token scan.
    metrics_ctx = next(
        (f for rel, f in repo.files.items()
         if rel.endswith(c.metrics_module)),
        None,
    )
    if metrics_ctx is not None:
        registered: dict[str, tuple[int, int]] = {}
        for node in ast.walk(metrics_ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in (
                        "counter", "gauge", "histogram")
                    and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) and \
                    arg.value.startswith("poseidon_"):
                registered.setdefault(
                    arg.value, (node.lineno, node.col_offset)
                )
        doc_text = repo.read_text(c.metrics_doc_file)
        if doc_text is None:
            out.append(Violation(
                code="PTA005", rule="surface-consistency",
                path=metrics_ctx.path, line=1, col=0,
                message=(
                    f"metric doc file '{c.metrics_doc_file}' not found"
                ),
            ))
        elif registered:
            documented = {
                m for m in re.findall(
                    r"\bposeidon_[a-z0-9_]+", doc_text
                )
                if not m.startswith("poseidon_tpu")
            }
            for name in sorted(registered):
                if name not in documented:
                    line, col = registered[name]
                    out.append(Violation(
                        code="PTA005", rule="surface-consistency",
                        path=metrics_ctx.path, line=line, col=col,
                        message=(
                            f"metric family '{name}' is registered "
                            f"but not documented in "
                            f"{c.metrics_doc_file}'s observability "
                            "reference"
                        ),
                    ))
            # reverse direction: histogram exports add per-series
            # _bucket/_sum/_count suffixes, so strip those before
            # deciding a documented token names a missing family; a
            # token ending in '_' is a prose prefix reference
            # ("the poseidon_outbox_* family") — fine as long as some
            # registered family matches, but it does NOT satisfy the
            # forward per-family requirement above
            def _family(tok: str) -> str:
                for suf in ("_bucket", "_sum", "_count"):
                    if tok.endswith(suf) and \
                            tok[: -len(suf)] in registered:
                        return tok[: -len(suf)]
                return tok
            for tok in sorted(documented):
                if tok.endswith("_") and any(
                    name.startswith(tok) for name in registered
                ):
                    continue
                if _family(tok) not in registered:
                    out.append(Violation(
                        code="PTA005", rule="surface-consistency",
                        path=metrics_ctx.path, line=1, col=0,
                        message=(
                            f"{c.metrics_doc_file} documents metric "
                            f"family '{tok}' that is not registered "
                            f"in {c.metrics_module} — delete the "
                            "stale reference or register the family"
                        ),
                    ))
    return out
