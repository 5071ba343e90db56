"""PTA008: the op-trace auditor — the port's counterpart of the
reference's ``poseidon_tpu/analysis/jaxpr_check.py``.

The reference traces its production kernels with ``jax.make_jaxpr`` and
audits the closed jaxprs. PyTorch has no program to trace: the round is
eager. So this module records what each production entry actually runs
on a tiny seeded instance, under a
``torch.utils._python_dispatch.TorchDispatchMode`` that sees every aten
op the entry dispatches (from Python or from C++ inside an op), and
audits the recording:

- **kernels count once** — each hand kernel's wrapper (K1-K11,
  ``kernels._args.census_op``) is one op under its name
  (``kernel.row_options``), and nothing inside it is recorded; a
  ``SyncCounter.read`` is one op (``SyncCounter.read``) the same way.
  The census is therefore the same on the CPU (the twins) and on the
  card (the kernels);
- **transfers are counted apart** — a ``_to_copy`` that only changes
  the device, or a ``copy_`` between devices, is a no-op on the CPU; it
  stays out of the census and is audited against the entry's declared
  uploads (``Contracts.optrace_uploads``);
- **no float64** — int64 is the domain type and allowed, a float64
  tensor anywhere is a leak;
- **no device-to-host read except inside SyncCounter.read** — an
  ``_local_scalar_dense`` (``int()``/``bool()``/``.item()`` of a
  tensor), a copy to the host, or an op that sizes its result from the
  data (``nonzero``, ``masked_select``, ``unique``, a boolean-mask
  index, ``repeat_interleave`` without ``output_size``) is a hidden
  sync on the card;
- **no tensor made from host data inside the entry** beyond its
  declared uploads (``lift_fresh``: ``torch.tensor``/``as_tensor``/
  ``from_numpy`` of host values is a blocking upload on the card);
- **a pinned per-entry census** (``analysis/op_fingerprints.json``):
  the instances are fixed and the auction is deterministic, so even
  the host loop's op counts are stable; a diff is a changed program.
  ``--update-fingerprints`` re-pins the file. Each entry pins two
  counts: ``ops``, every op, and ``card_ops``, the same with the
  auction loop (the ``loop.auction`` seam of ``_solve``) as one op. On
  the card the loop is one CUDA graph launch, whose ops run without
  the dispatcher, so a card recording is held to ``card_ops``; the ops
  inside the seam are still checked for the problems below.

Audited entries (the counterparts of the reference's audited set):
``ops/dense_auction.py::_solve``, ``ops/resident.py::_resident_chain``,
``_express_patch``, ``_express_step``, ``_stream_chain`` and
``ops/batch.py::_solve_member``. ``record_entries(device="cuda")``
records the same entries on the card (``chip_smoke.py`` [analysis]),
where the census must equal the pinned CPU one.

With ``taint=True`` the recorder records inside the kernels and reads
too (their twins run on the CPU) and propagates padding taint for the
PTA009 audit (``padding_taint.py``), which reads the same recording.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import sys

import numpy as np

from poseidon_tpu_torch.analysis.core import Violation

FINGERPRINT_FILE = "poseidon_tpu_torch/analysis/op_fingerprints.json"

ENTRIES = ("solve", "resident_chain", "express_patch", "express_step",
           "stream_chain", "solve_member")

# ops that size their result from the data: each copies a count to the
# host on the card before it can allocate
_IMPLICIT_SYNC = frozenset({
    "nonzero", "masked_select", "unique_dim", "_unique", "_unique2",
    "unique_consecutive",
})
# (``item``, ``int()`` and ``bool()`` of a tensor reach the recorder as
# ``_local_scalar_dense``)
_HOST_READ = frozenset({"_local_scalar_dense", "equal"})

_PKG_DIR = str(pathlib.Path(__file__).resolve().parent.parent)
_ANALYSIS_DIR = str(pathlib.Path(__file__).resolve().parent)
_GUARDS = str(pathlib.Path(_PKG_DIR) / "guards.py")
_ARGS = str(pathlib.Path(_PKG_DIR) / "kernels" / "_args.py")
_ROOT = pathlib.Path(_PKG_DIR).parent


def _site():
    """(repo-relative path, line, function name) of the innermost
    ``poseidon_tpu_torch`` frame below the recorder (the analysis
    package and the census seams excluded)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG_DIR) and not fn.startswith(_ANALYSIS_DIR) \
                and fn not in (_GUARDS, _ARGS):
            try:
                rel = pathlib.Path(fn).resolve().relative_to(_ROOT)
            except ValueError:
                rel = pathlib.Path(fn)
            return rel.as_posix(), f.f_lineno, f.f_code.co_name
        f = f.f_back
    return None, 0, None


@dataclasses.dataclass
class Recording:
    """One entry's recording."""

    entry: str
    census: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # (kind, message, (path, line, function))
    problems: list = dataclasses.field(default_factory=list)
    # (path, line, function) -> count of device moves
    transfers: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # PTA009 candidates: (op, function, path, line)
    candidates: set = dataclasses.field(default_factory=set)
    # the census with each ``loop.*`` seam as one op
    card_census: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    device: str = "cpu"


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _entry_sources(obj, out, depth=0):
    """Every tensor reachable from an entry's arguments (tensors,
    tuples, lists, dicts, dataclasses), for the PTA009 sources."""
    import torch

    if depth > 4:
        return
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _entry_sources(x, out, depth + 1)
    elif isinstance(obj, dict):
        for x in obj.values():
            _entry_sources(x, out, depth + 1)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _entry_sources(getattr(obj, f.name), out, depth + 1)


# ---------------------------------------------------------------------------
# PTA009's op classes (padding_taint.py documents the semantics)
# ---------------------------------------------------------------------------

_ARITH_SINKS = frozenset({"min", "max", "amin", "amax", "sum", "prod",
                          "argmin", "argmax"})
_BOOL_SINKS = frozenset({"any", "all"})
# elementwise overloads of the reduction names
_ELEMENTWISE_OVERLOADS = frozenset({"other", "binary_out", "other_out"})
_MASK_OPS = frozenset({"where", "clamp", "clamp_min", "clamp_max",
                       "masked_fill", "masked_fill_", "clamp_",
                       "clamp_min_", "clamp_max_"})
_TRANSPARENT = frozenset({"view", "_unsafe_view", "reshape", "expand",
                          "unsqueeze", "squeeze", "t", "transpose",
                          "permute", "alias", "detach", "clone",
                          "_to_copy", "contiguous", "lift_fresh"})


def _recorder_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpRecorder(TorchDispatchMode):
        """Records the aten ops an entry dispatches (see the module
        docstring). ``enter``/``exit`` are the census seam's calls
        (``guards.census``)."""

        def __init__(self, rec: Recording, taint: bool = False):
            super().__init__()
            self.rec = rec
            self.taint = taint
            self.depth = 0
            self.group = 0      # inside a ``loop.*`` seam
            self.in_read = 0
            self.flags: dict = {}     # id(tensor) -> (taint, masked, bool)
            self.keep: list = []      # keeps ids unique while recording

        # ---- the census seam -----------------------------------------
        def enter(self, name: str) -> None:
            if name.startswith("loop."):
                # a group: its ops stay in the census (and are
                # checked); the card census counts the group once
                if not self.taint and self.depth == 0 and not self.group:
                    self.rec.card_census[name] += 1
                self.group += 1
                return
            if name == "SyncCounter.read":
                self.in_read += 1
            if self.taint:
                return
            if self.depth == 0:
                self.rec.census[name] += 1
                if not self.group:
                    self.rec.card_census[name] += 1
            self.depth += 1

        def exit(self, name: str) -> None:
            if name.startswith("loop."):
                self.group -= 1
                return
            if name == "SyncCounter.read":
                self.in_read -= 1
            if not self.taint:
                self.depth -= 1

        # ---- taint ----------------------------------------------------
        def mark_sources(self, tensors) -> None:
            for t in tensors:
                self.keep.append(t)
                self.flags[id(t)] = (t.dim() >= 1, False,
                                     t.dtype == torch.bool)

        def _get(self, t):
            return self.flags.get(id(t), (False, False,
                                          t.dtype == torch.bool))

        def _propagate(self, func, args, kwargs, out):
            name = func.overloadpacket.__name__
            ins = [self._get(t) for t in _tensors((args, kwargs))]
            any_t = any(t for t, _, _ in ins)
            if (name in _ARITH_SINKS or name in _BOOL_SINKS) and \
                    func._overloadname not in _ELEMENTWISE_OVERLOADS and ins:
                t, m, b = ins[0]
                if t and not m and (name in _BOOL_SINKS or not b):
                    path, line, fn = _site()
                    self.rec.candidates.add((name, fn, path, line))
            if name in _MASK_OPS:
                res = (any_t, True, False)
            elif name in _TRANSPARENT and ins:
                res = ins[0]
            else:
                res = (any_t, False, False)
            outs = _tensors(out)
            if func._schema.is_mutable and args and \
                    isinstance(args[0], torch.Tensor):
                outs.append(args[0])
            for o in outs:
                self.keep.append(o)
                self.flags[id(o)] = (res[0], res[1],
                                     res[2] or o.dtype == torch.bool)

        # ---- the dispatch hook -----------------------------------------
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if self.taint:
                out = func(*args, **kwargs)
                self._propagate(func, args, kwargs, out)
                return out
            if self.depth:
                return func(*args, **kwargs)
            name = func.overloadpacket.__name__
            rec = self.rec
            ins = _tensors((args, kwargs))
            devs = {t.device for t in ins}
            moved = False
            if name == "_to_copy" and ins:
                dev = kwargs.get("device")
                same_dtype = kwargs.get("dtype") in (None, ins[0].dtype)
                if dev is not None and torch.device(dev) != ins[0].device \
                        and same_dtype:
                    moved = True
            elif name in ("copy_", "_copy_from") and len(devs) > 1:
                moved = True
            if moved:
                site = _site()
                to_host = (name == "_to_copy"
                           and torch.device(kwargs["device"]).type == "cpu")
                if to_host or (name != "_to_copy"
                               and args[0].device.type == "cpu"):
                    rec.problems.append((
                        "host-read", "device-to-host copy outside "
                        "SyncCounter.read", site))
                else:
                    rec.transfers[site] += 1
                return func(*args, **kwargs)
            if name in _HOST_READ or name in _IMPLICIT_SYNC or (
                name == "repeat_interleave"
                and kwargs.get("output_size") is None
                and len(args) < 4
            ) or (name in ("index", "index_put", "index_put_") and any(
                t is not None and getattr(t, "dtype", None) == torch.bool
                for t in (args[1] if len(args) > 1 else ())
            )):
                if not self.in_read:
                    rec.problems.append((
                        "host-read", f"{func} reads the device from the "
                        "host (a sync on the card) outside "
                        "SyncCounter.read", _site()))
            if name == "lift_fresh":
                rec.problems.append(("host-tensor", "tensor made from "
                                     "host data", _site()))
            rec.census[str(func)] += 1
            if not self.group:
                rec.card_census[str(func)] += 1
            out = func(*args, **kwargs)
            for o in _tensors(out):
                if o.dtype == torch.float64:
                    rec.problems.append((
                        "float64", f"{func} makes a float64 tensor "
                        f"{tuple(o.shape)}", _site()))
            return out

    return OpRecorder


def record(entry: str, fn, args=(), kwargs=None, *,
           taint: bool = False) -> tuple[Recording, object]:
    """Run ``fn(*args, **kwargs)`` under a recorder; returns the
    recording and fn's result."""
    from poseidon_tpu_torch import guards

    rec = Recording(entry=entry)
    mode = _recorder_class()(rec, taint=taint)
    if taint:
        src: list = []
        _entry_sources((args, kwargs), src)
        mode.mark_sources(src)
    guards._census.append(mode)
    try:
        with mode:
            out = fn(*args, **(kwargs or {}))
    finally:
        guards._census.remove(mode)
    return rec, out


# ---------------------------------------------------------------------------
# the production entries on a tiny seeded instance
# ---------------------------------------------------------------------------


def production_entries(device=None) -> list[tuple[str, object, tuple, dict]]:
    """Drive one tiny cold round through the real construction path
    (synthetic cluster -> FlowGraphBuilder -> ResidentSolver, 8
    machines x 12 tasks, the reference's instance) on ``device`` and
    return ``(entry, fn, args, kwargs)`` for the audited set, each built
    from the solver's own warm context (``device=None``: the card). The calls mutate that context
    (the express and stream windows patch the table), so run them once
    each, in order, on a fresh list."""
    import torch

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.guards import SyncCounter
    from poseidon_tpu_torch.models.costs import build_cost_inputs_host
    from poseidon_tpu_torch.ops import resident as res
    from poseidon_tpu_torch.ops.batch import (
        _solve_member, member_bucket_dims, stack_members, upload_members,
    )
    from poseidon_tpu_torch.ops.dense_auction import (
        _solve, build_member_tables, default_fuse,
    )
    from poseidon_tpu_torch.ops.transport import (
        extract_topology, instance_from_topology,
    )
    from poseidon_tpu_torch.synth import make_synthetic_cluster

    device = res.resolve_device(device)
    cluster = make_synthetic_cluster(
        8, 12, seed=11, machines_per_rack=4, max_tasks_per_machine=4,
        prefs_per_task=2, tasks_per_job=4,
    )
    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    solver = res.ResidentSolver(
        device=device, oracle_fallback=False, small_to_oracle=False,
        express_lane=True, express_max_batch=4,
    )
    outcome = solver.run_round(arrays, meta, cost_model="quincy")
    if not outcome.converged or solver._express is None:
        raise RuntimeError("op-trace audit: the tiny bootstrap round did "
                           "not certify")
    ctx = solver._express
    warm = solver._warm
    solver._express_finalize(ctx)
    kmax, pk = solver.express_max_batch, ctx.n_prefs
    Tp, Mp = ctx.Tp, ctx.Mp
    i32 = torch.int32

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # one arrival with a machine and a rack preference, as the
    # reference's audit bootstrap
    arrival = res.ExpressArrival(
        uid="optrace-audit-pod", wait_rounds=0, cpu_milli=100,
        mem_kb=1 << 16, prefs=((0, -1, 3), (-1, 0, 5)),
    )
    add_row = np.full(kmax, -1, np.int32)
    add_row[0] = Tp - 1
    add_pm = np.full((kmax, pk), -1, np.int32)
    add_pr = np.full((kmax, pk), -1, np.int32)
    add_pm[0, 0] = solver._express_col(ctx, 0)
    add_pr[0, 1] = 0
    mini = solver._express_mini_inputs(ctx, [arrival], kmax, pk)
    mini_dev = mini.to_device(device)
    # a retire of row 0 on its machine (K5's vocabulary)
    m0 = int(max(outcome.assignment[0], 0))
    backlog = up(res._express_patch_chunks(
        [0], [solver._express_col(ctx, m0)], [-1]))

    # the stream lane: two windows, the arrival then a no-op window
    pw = solver._stream_pw_floor
    noop = solver._express_mini_inputs(ctx, [], kmax, pk)
    windows = []
    for mi, ar in ((mini, add_row), (noop, np.full(kmax, -1, np.int32))):
        patch = np.stack([np.full(pw, -1, np.int32),
                          np.full(pw, -1, np.int32),
                          np.zeros(pw, np.int32)])[None]
        windows.append((mi.to_device(device), up(ar), up(add_pm),
                        up(add_pr), up(patch)))

    # the service lane's stacked members: 2 copies of the round's
    # instance through the same tables production builds
    topo = extract_topology(meta, arrays["src"], arrays["dst"],
                            arrays["cap"])
    cost_host = SyncCounter().read(ctx.cost_dev).astype(np.int64)[
        : meta.n_arcs]
    inst = instance_from_topology(topo, cost_host)
    bTp, bMp, bP = member_bucket_dims(inst)
    members = [build_member_tables(inst, bTp, bMp, bP) for _ in range(2)]
    stacked = upload_members(stack_members(members, 2), device)
    bsmax = max(min(int(np.max(members[0]["slots"], initial=0)), bTp), 1)

    inputs_dev = build_cost_inputs_host(
        solver._e_floor, meta, t_min=solver._ti_floor,
        m_min=solver._mi_floor,
    ).to_device(device)
    zeros_t = torch.zeros(Tp, dtype=i32, device=device)
    zeros_m = torch.zeros(Mp, dtype=i32, device=device)
    zb_t = torch.zeros(bTp, dtype=i32, device=device)
    zb_m = torch.zeros(bMp, dtype=i32, device=device)
    fuse = default_fuse()
    dev = ctx.dev
    state = (dev.u.clone(), dev.w.clone(), dev.task_valid.clone(),
             dev.s.clone(), warm.asg.clone(), warm.lvl.clone())
    common = dict(model_fn=ctx.model_fn, kmax=kmax, pk=pk,
                  alpha=solver.alpha, max_rounds=res.EXPRESS_FUSE,
                  smax=ctx.smax, change_cap=solver.express_change_cap)
    return [
        ("solve", _solve,
         (dev, warm.asg, warm.lvl, warm.floor, 1),
         dict(alpha=solver.alpha, max_rounds=fuse, smax=ctx.smax,
              analytic_init=False)),
        ("resident_chain", res._resident_chain,
         (ctx.dt, inputs_dev, zeros_t, zeros_t, zeros_m),
         dict(model_fn=ctx.model_fn, n_prefs=pk, smax=ctx.smax,
              alpha=solver.alpha, max_rounds=fuse, warm_start=False)),
        ("express_patch", res._express_patch, (state, backlog), {}),
        ("express_step", res._express_step,
         (dev, ctx.dt, ctx.cost_dev, mini_dev, warm.asg, warm.lvl,
          warm.floor, up(add_row), up(add_pm), up(add_pr)), common),
        ("stream_chain", res._stream_chain,
         (dev, ctx.dt, ctx.cost_dev, windows, warm.asg.clone(),
          warm.lvl.clone(), warm.floor.clone()), common),
        ("solve_member", _solve_member,
         (stacked, 1, zb_t, zb_t, zb_m),
         dict(n_prefs=bP, smax=bsmax, alpha=solver.alpha, max_rounds=fuse,
              warm_start=False)),
    ]


def record_entries(device=None, *, taint: bool = False) -> dict:
    """{entry: Recording} of the audited set on ``device`` (None: the
    card)."""
    from poseidon_tpu_torch.ops.resident import resolve_device

    kind = resolve_device(device).type
    out = {}
    for name, fn, args, kwargs in production_entries(device):
        out[name], _ = record(name, fn, args, kwargs, taint=taint)
        out[name].device = kind
    return out


# ---------------------------------------------------------------------------
# the audit entry point
# ---------------------------------------------------------------------------


def _declared(contracts, entry: str, site) -> bool:
    path, _line, fn = site
    for key in (entry, "*"):
        for suffix, func, _reason in contracts.optrace_uploads.get(key, ()):
            if path and path.endswith(suffix) and fn == func:
                return True
    return False


def structural_problems(rec: Recording, contracts) -> list[tuple]:
    """(message, site) for every contract a recording breaks, apart
    from the pinned census."""
    out = []
    seen = set()
    for kind, msg, site in rec.problems:
        if kind == "host-tensor" and _declared(contracts, rec.entry, site):
            continue
        key = (kind, msg, site)
        if key in seen:
            continue
        seen.add(key)
        out.append((f"{rec.entry}: {msg}", site))
    for site, n in sorted(rec.transfers.items(), key=str):
        if not _declared(contracts, rec.entry, site):
            out.append((f"{rec.entry}: {n} device move(s) that are not "
                        "a declared upload", site))
    return out


def fingerprint(rec: Recording) -> dict:
    """The pinned form: a card recording has only ``card_ops`` (its
    loop ran as a graph)."""
    card = {"card_ops": dict(sorted(rec.card_census.items()))}
    if rec.device == "cuda":
        return card
    return {"ops": dict(sorted(rec.census.items())), **card}


def diff_fingerprint(name: str, got: dict, want: dict) -> list[str]:
    problems = []
    for key in ("ops", "card_ops"):
        if key not in got:
            continue
        g, w = got[key], want.get(key, {})
        for op in sorted(set(g) | set(w)):
            if g.get(op, 0) != w.get(op, 0):
                problems.append(
                    f"{name}: {'op' if key == 'ops' else 'card op'} "
                    f"'{op}' count {g.get(op, 0)} != pinned "
                    f"{w.get(op, 0)} (a changed program — if intentional, "
                    "re-pin with --update-fingerprints and say why)")
    return problems


def run_optrace_audit(
    root: pathlib.Path, *, update: bool = False, recordings=None,
    contracts=None, device=None,
) -> tuple[list[Violation], int]:
    """Record, check structure, and diff against the committed census.
    Returns (violations, entries audited). ``update`` rewrites
    ``op_fingerprints.json`` instead of diffing."""
    from poseidon_tpu_torch.analysis.contracts import DEFAULT_CONTRACTS

    contracts = contracts or DEFAULT_CONTRACTS
    if recordings is None:
        recordings = record_entries(device)
    fp_path = pathlib.Path(root) / FINGERPRINT_FILE
    violations: list[Violation] = []

    def flag(msg: str, site=(None, 0, None)):
        path, line, _fn = site
        violations.append(Violation(
            code="PTA008", rule="optrace-audit",
            path=path or FINGERPRINT_FILE, line=line or 1, col=0,
            message=msg,
        ))

    for rec in recordings.values():
        for msg, site in structural_problems(rec, contracts):
            flag(msg, site)
    got = {name: fingerprint(r) for name, r in recordings.items()}
    if update:
        fp_path.write_text(json.dumps({
            "_comment": (
                "Pinned per-entry op census (python -m "
                "poseidon_tpu_torch.analysis --update-fingerprints). A "
                "diff here means the recorded programs changed: say why "
                "in the PR."),
            "entries": got,
        }, indent=2, sort_keys=True) + "\n")
        return violations, len(recordings)
    if not fp_path.is_file():
        flag(f"{FINGERPRINT_FILE} is missing: run python -m "
             "poseidon_tpu_torch.analysis --update-fingerprints")
        return violations, len(recordings)
    want = json.loads(fp_path.read_text()).get("entries", {})
    for name in sorted(set(got) | set(want)):
        if name not in got:
            flag(f"{name}: pinned in {FINGERPRINT_FILE} but not recorded")
        elif name not in want:
            flag(f"{name}: recorded but not pinned in {FINGERPRINT_FILE}")
        else:
            for p in diff_fingerprint(name, got[name], want[name]):
                flag(p)
    return violations, len(recordings)
