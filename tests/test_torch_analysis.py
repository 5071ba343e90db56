"""The port's contract linter (poseidon_tpu_torch/analysis), beside the
reference's.

The counterparts of ``tests/test_analysis.py``'s classes: per-rule
known-bad/known-good snippet pairs for PTA001-PTA007 in their torch
meanings, the suppression contract (a reason is mandatory, a
suppression covers its statement's span, dead ones are reported), the
port's default targets, the JSON schema, the CLI and ``--rule``, the
self-check (the port's tree is violation-free) and the acceptance
injections (a ``primal.item()`` in a copy of ``ops/resident.py`` fires
PTA001; an unlocked ``# pta: background-thread`` mutation in a copy of
``bridge/bridge.py`` fires PTA004).

The differential class runs the framework-independent passes (PTA000
with its spans and the suppression audit, PTA002, PTA004, PTA006 and
PTA010) of BOTH packages with the reference's ``DEFAULT_CONTRACTS``
(mapped into the port's ``Contracts`` field by field) over the
reference's fixture corpus and the reference's own tree: the two
violation lists must be identical.

Seeded violations live in strings only, so this file stays clean under
both analyzers' self-checks.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from poseidon_tpu_torch.analysis import (
    DEFAULT_CONTRACTS,
    analyze_and_audit,
    analyze_tree,
)
from poseidon_tpu_torch.analysis.contracts import Contracts, ThreadContract

REPO = pathlib.Path(__file__).resolve().parent.parent
HOT = "poseidon_tpu_torch/ops/resident.py"
BRIDGE = "poseidon_tpu_torch/bridge/bridge.py"
ANY = "poseidon_tpu_torch/pkg/mod.py"


def write_tree(tmp_path, files) -> list[pathlib.Path]:
    paths = []
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        if rel.endswith(".py"):
            paths.append(p)
    return paths


def run_on(tmp_path, files, contracts=DEFAULT_CONTRACTS):
    """Write a snippet tree under tmp_path and analyze it."""
    violations, _ = analyze_tree(tmp_path, write_tree(tmp_path, files),
                                 contracts)
    return violations


def codes(violations):
    return [v.code for v in violations]


def run_cli(tmp_path, files, *extra):
    paths = [str(p) for p in write_tree(tmp_path, files)]
    proc = subprocess.run(
        [sys.executable, "-m", "poseidon_tpu_torch.analysis",
         "--format=json", "--root", str(tmp_path), *extra, *paths],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    return proc, json.loads(proc.stdout) if proc.stdout else None


@pytest.fixture(scope="module")
def tree_run():
    """One whole-tree run (rules + suppression audit) for the module."""
    return analyze_and_audit(REPO)


class TestPTA001HostSync:
    def test_device_reads_flagged(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            import numpy as np
            import torch

            def round_step(dev: DenseInstance, x):
                conv = _solve(dev)[4]
                a = int(conv)
                b = dev.u.tolist()
                c = np.asarray(dev.w)
                d = dev.c.to("cpu")
                e = x.item()
                f = dev.u.cpu()
                torch.cuda.synchronize()
                if conv:
                    pass
                return a, b, c, d, e, f
        """})
        assert codes(vs) == ["PTA001"] * 8, [v.message for v in vs]

    def test_implicit_syncs_flagged(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            import torch

            def round_step(dev: DenseInstance):
                a = torch.nonzero(dev.c)
                b = torch.where(dev.u > 0)
                c = dev.u.unique()
                d = torch.masked_select(dev.u, dev.task_valid)
                e = dev.u.repeat_interleave(dev.w)
                ok = dev.u.repeat_interleave(dev.w, output_size=8)
                return a, b, c, d, e, ok
        """})
        assert codes(vs) == ["PTA001"] * 5, [v.message for v in vs]
        assert "sizes its result from the data" in vs[0].message

    def test_counted_read_is_a_barrier(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            import torch

            def round_step(dev: DenseInstance, syncs):
                conv = (dev.u > 0).any()
                flags = syncs.read(torch.stack([conv, conv]))
                if flags[0]:
                    return int(flags[1]), int(dev.c.shape[0])
                return 0, 0
        """})
        assert vs == []

    def test_metadata_and_is_none_do_not_sync(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            def round_step(dev: DenseInstance, carry: torch.Tensor):
                Tp, Mp = dev.c.shape
                if carry is not None and dev.c.numel() > 0:
                    return int(Tp) + int(dev.c.dim())
                return Mp
        """})
        assert vs == []

    def test_upload_needs_a_declared_site(self, tmp_path):
        src = """\
            import numpy as np
            import torch

            def ship(host, device):
                return torch.from_numpy(np.asarray(host)).to(device)

            def scalar(x, device):
                return torch.tensor(x, device=device)

            def fill(x, device):
                return torch.full((), x, device=device)
        """
        vs = run_on(tmp_path, {HOT: src})
        assert codes(vs) == ["PTA001", "PTA001"]
        assert all("blocking upload" in v.message for v in vs)
        declared = dataclasses.replace(DEFAULT_CONTRACTS, sync_sites=(
            (HOT, "ship", "test: the round's one upload"),
            (HOT, "scalar", "test: a declared scalar"),
        ))
        assert run_on(tmp_path, {HOT: src}, declared) == []

    def test_nested_function_inherits_device_names(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            def round_step(dev: DenseInstance):
                waiting = dev.u > 0

                def inner():
                    return bool(waiting.any())
                return inner()
        """})
        assert codes(vs) == ["PTA001"]

    def test_out_of_scope_file_not_checked(self, tmp_path):
        vs = run_on(tmp_path, {"poseidon_tpu_torch/elsewhere.py": """\
            def f(x):
                return x.item()
        """})
        assert vs == []


class TestPTA002ClusterLoops:
    def test_loop_in_scope_flagged(self, tmp_path):
        vs = run_on(tmp_path, {BRIDGE: """\
            class SchedulerBridge:
                def begin_round(self):
                    n = 0
                    for t in self.tasks:
                        n += 1
                    return n
        """})
        assert codes(vs) == ["PTA002"]

    def test_genexp_over_cluster_flagged(self, tmp_path):
        vs = run_on(tmp_path, {BRIDGE: """\
            class SchedulerBridge:
                def begin_round(self, cluster):
                    return any(t.live for t in cluster.tasks)
        """})
        assert codes(vs) == ["PTA002"]

    def test_churn_loop_and_out_of_scope_clean(self, tmp_path):
        vs = run_on(tmp_path, {BRIDGE: """\
            class SchedulerBridge:
                def begin_round(self, dset):
                    for d in dset.place:
                        self.apply(d)

                def observe_nodes(self, nodes):
                    for n in nodes:
                        self.upsert(n)
        """})
        assert vs == []


class TestPTA003LaunchHygiene:
    def test_torch_compile_and_jit_flagged(self, tmp_path):
        vs = run_on(tmp_path, {"poseidon_tpu_torch/x.py": """\
            import torch

            @torch.compile
            def price(x):
                return x * 2

            def script(f):
                return torch.jit.script(f)
        """})
        assert codes(vs) == ["PTA003", "PTA003"]
        assert all("torch" in v.message for v in vs)

    def test_library_loaded_outside_the_loader_flagged(self, tmp_path):
        src = """\
            import ctypes

            def load(path):
                return ctypes.CDLL(path), ctypes.cdll.LoadLibrary(path)
        """
        vs = run_on(tmp_path, {"poseidon_tpu_torch/ops/x.py": src})
        assert codes(vs) == ["PTA003", "PTA003"]
        tmp2 = tmp_path / "loader"
        assert run_on(tmp2, {"poseidon_tpu_torch/kernels/loader.py": src}) \
            == []

    def test_plan_outside_its_cache_flagged(self, tmp_path):
        vs = run_on(tmp_path, {
            "poseidon_tpu_torch/ops/x.py": """\
                from poseidon_tpu_torch.kernels import gap_rows, row_stream

                def launch(rows, Mp, sms, occ):
                    return (row_stream.plan(rows, Mp, 0, sms, occ),
                            gap_rows.plan(rows, Mp, sms, occ))
            """,
            "poseidon_tpu_torch/kernels/row_stream.py": """\
                def plan(rows, Mp, meta_ints, sms, occ):
                    return rows

                class PlanCache:
                    def __init__(self):
                        self._make = lambda r, m, s, o: plan(r, m, 0, s, o)
            """,
        })
        assert codes(vs) == ["PTA003", "PTA003"]
        assert all(v.path == "poseidon_tpu_torch/ops/x.py" for v in vs)

    def test_mutable_default_on_a_plan_key(self, tmp_path):
        vs = run_on(tmp_path, {ANY: """\
            def _solve(dev, asg0, lvl0, floor0, eps0, smax=[]):
                return dev

            def other(x, opts=[]):
                return x
        """})
        assert codes(vs) == ["PTA003"]
        assert "'smax'" in vs[0].message


class TestPTA004LockDiscipline:
    BAD = """\
        class SchedulerBridge:
            def __init__(self):
                self.round_num = 0

            def bump(self):
                self.round_num += 1

            def poll(self):  # pta: background-thread
                self.round_num += 1
    """

    def test_unlocked_cross_thread_write_flagged(self, tmp_path):
        vs = run_on(tmp_path, {BRIDGE: self.BAD})
        assert codes(vs).count("PTA004") == 2
        assert codes(vs).count("PTA006") == 1

    def test_locked_sites_clean(self, tmp_path):
        vs = run_on(tmp_path, {BRIDGE: """\
            class SchedulerBridge:
                def __init__(self):
                    self.round_num = 0

                def bump(self):
                    with self._lock:
                        self.round_num += 1

                def poll(self):  # pta: background-thread
                    with self._lock:
                        self.round_num += 1
        """})
        assert vs == []

    def test_declared_handoff_clean(self, tmp_path):
        contracts = Contracts(thread_classes={
            "SchedulerBridge": ThreadContract(
                handoffs={"round_num": "test: monotonic counter"}),
        })
        assert run_on(tmp_path, {BRIDGE: self.BAD}, contracts) == []


class TestPTA005Surface:
    def test_undeclared_and_dynamic_event_flagged(self, tmp_path):
        vs = run_on(tmp_path, {
            "poseidon_tpu_torch/trace.py": """\
                EVENT_TYPES = frozenset({"ROUND", "SCHEDULE"})
            """,
            "poseidon_tpu_torch/other.py": """\
                class T:
                    def go(self, name):
                        self.trace.emit("ROUND")
                        self.trace.emit("BOGUS")
                        self.trace.emit(name)
            """,
        })
        assert codes(vs) == ["PTA005", "PTA005"]

    def test_undocumented_flag_flagged(self, tmp_path):
        files = {
            "poseidon_tpu_torch/cli.py": """\
                import argparse

                def build_parser():
                    p = argparse.ArgumentParser()
                    p.add_argument("--alpha", type=int)
                    p.add_argument("--hidden", help=argparse.SUPPRESS)
                    return p
            """,
            "README.md": "docs mention --alpha here\n",
            "deploy/poseidon-tpu.cfg": "# no flags here\n",
        }
        vs = run_on(tmp_path, files)
        assert codes(vs) == ["PTA005"]
        assert "deploy/poseidon-tpu.cfg" in vs[0].message
        files["deploy/poseidon-tpu.cfg"] = "--alpha=3\n"
        assert run_on(tmp_path, files) == []


class TestPTA006LocksetRaces:
    def test_spawn_site_inference_without_marker(self, tmp_path):
        vs = run_on(tmp_path, {ANY: """\
            import threading

            class Pump:
                def start(self):
                    threading.Thread(target=self._drain).start()

                def _drain(self):
                    self.pending += 1

                def feed(self):
                    self.pending += 1
        """})
        assert codes(vs) == ["PTA006"]
        assert "Pump.pending" in vs[0].message

    def test_wrapper_lambda_is_background(self, tmp_path):
        vs = run_on(tmp_path, {ANY: """\
            from poseidon_tpu_torch.ops.resident import _AsyncFetch

            class Solver:
                def dispatch(self):
                    self._warm = object()
                    return _AsyncFetch(lambda: self._warm)
        """})
        assert codes(vs) == ["PTA006"]
        assert "Solver._warm" in vs[0].message

    def test_every_declared_handoff_is_load_bearing(self, tmp_path):
        """Dropping any handoff of the port's contracts fires PTA006 on
        the port's own files."""
        files = [REPO / HOT, REPO / "poseidon_tpu_torch/apiclient/watch.py"]
        checked = 0
        for cls, tc in DEFAULT_CONTRACTS.thread_classes.items():
            for attr in tc.handoffs:
                h = {k: v for k, v in tc.handoffs.items() if k != attr}
                classes = dict(DEFAULT_CONTRACTS.thread_classes)
                classes[cls] = ThreadContract(lock_attr=tc.lock_attr,
                                              handoffs=h)
                c = dataclasses.replace(DEFAULT_CONTRACTS,
                                        thread_classes=classes)
                vs, _ = analyze_tree(REPO, files, c)
                assert any(v.code == "PTA006" and f"{cls}.{attr}" in
                           v.message for v in vs), f"{cls}.{attr}"
                checked += 1
        assert checked >= 5


class TestPTA007RecompileHazard:
    SOLVE = """\
        def _solve(dev, asg0, lvl0, floor0, eps0, smax):
            return dev

"""

    def test_unfloored_key_flagged(self, tmp_path):
        vs = run_on(tmp_path, {ANY: self.SOLVE + """\
        def round_step(dev, topo):
            smax = max(int(topo.slots_max), 1)
            return _solve(dev, 0, 0, 0, 1, smax)
        """})
        assert codes(vs) == ["PTA007"]
        assert "'smax'" in vs[0].message

    def test_floored_key_clean(self, tmp_path):
        vs = run_on(tmp_path, {ANY: self.SOLVE + """\
        def round_step(self, dev, topo):
            self._s_floor = max(int(topo.slots_max), self._s_floor)
            return _solve(dev, 0, 0, 0, 1, smax=self._s_floor)
        """})
        assert vs == []

    def test_pad_sink_flagged(self, tmp_path):
        vs = run_on(tmp_path, {ANY: """\
            def prep(E, meta, build_cost_inputs_host, pad_bucket):
                t = pad_bucket(max(len(meta.task_uids), 1))
                return build_cost_inputs_host(E, meta, t_min=t)
        """})
        assert codes(vs) == ["PTA007"]

    def test_acceptance_reverted_smax_floor(self, tmp_path):
        """Reverting the resident round's grow-only smax floor (smax
        follows the live max free seats again) fires at the round's
        in-flight record, which carries it to the chain."""
        src = (REPO / HOT).read_text()
        floored = "        smax = min(self._s_floor, Tp)\n"
        assert floored in src
        bad = src.replace(floored, "        smax = max(int(topo.slots.max("
                                   "initial=1)), 1)\n", 1)
        vs = run_on(tmp_path, {HOT: bad})
        assert any(v.code == "PTA007" and "'smax'" in v.message
                   and "InflightSolve" in v.message for v in vs), vs

    def test_acceptance_reverted_pref_width_floor(self, tmp_path):
        src = (REPO / HOT).read_text()
        floored = ("        self._p_floor = max(topo.max_prefs, "
                   "self._p_floor)\n        P = self._p_floor\n")
        assert floored in src
        bad = src.replace(floored, "        P = topo.max_prefs\n", 1)
        vs = run_on(tmp_path, {HOT: bad})
        assert any(v.code == "PTA007" and "'n_prefs'" in v.message
                   for v in vs), vs


class TestSuppressions:
    def test_suppression_without_reason_fails(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            def f(x):
                return x.item()  # noqa: PTA001
        """})
        assert codes(vs) == ["PTA000", "PTA001"]

    def test_suppression_with_reason_suppresses(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            def f(x):
                return x.item()  # noqa: PTA001 -- test fixture: sanctioned
        """})
        assert vs == []

    def test_noqa_on_def_covers_decorator_violation(self, tmp_path):
        vs = run_on(tmp_path, {"poseidon_tpu_torch/x.py": """\
            import torch

            @torch.compile
            def f(x):  # noqa: PTA003 -- test fixture: span regression
                return x
        """})
        assert vs == []

    def test_noqa_covers_multiline_statement(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            def f(x, g):
                v = g(
                    x.item(),
                )  # noqa: PTA001 -- test fixture: same-statement span
                return v
        """})
        assert vs == []

    def test_noqa_on_with_header_does_not_blanket_body(self, tmp_path):
        vs = run_on(tmp_path, {HOT: """\
            def f(x, lock):
                with lock:  # noqa: PTA001 -- test fixture: header only
                    return x.item()
        """})
        assert codes(vs) == ["PTA001"]

    def test_dead_and_half_dead_suppressions_reported(self, tmp_path):
        paths = write_tree(tmp_path, {HOT: """\
            def f(x):
                return x + 1  # noqa: PTA001 -- nothing syncs here any more

            def g(x):
                return x.item()  # noqa: PTA001,PTA002 -- half stale
        """})
        vs, _ = analyze_and_audit(tmp_path, paths)
        assert [(v.rule, v.line) for v in vs] == [
            ("dead-suppression", 2), ("dead-suppression", 5)]
        assert "PTA002" in vs[1].message


class TestWidenedTargets:
    def test_default_targets_are_the_ports_tree(self):
        from poseidon_tpu_torch.analysis import default_targets

        rels = {p.relative_to(REPO).as_posix()
                for p in default_targets(REPO)}
        assert "tests/test_torch_analysis.py" in rels
        assert {"chip_smoke.py", "kernel_ab.py"} <= rels
        assert HOT in rels
        assert not any(r.startswith("poseidon_tpu/") for r in rels)
        assert "tests/test_analysis.py" not in rels

    def test_tests_dir_runs_the_narrowed_rules(self, tmp_path):
        vs = run_on(tmp_path, {"tests/test_torch_x.py": """\
            import torch

            def test_something(model, x):
                y = x.item()
                return torch.compile(model)(x)  # noqa: PTA003
        """})
        # no PTA001 under tests/; PTA003 and the bare noqa's PTA000 do
        assert codes(vs) == ["PTA000", "PTA003"]


class TestJsonSchema:
    KEYS = ["code", "rule", "path", "line", "col", "message"]

    def test_clean_tree_schema_and_exit_zero(self, tmp_path):
        proc, doc = run_cli(tmp_path, {"poseidon_tpu_torch/x.py": "A = 1\n"})
        assert proc.returncode == 0, proc.stderr
        assert doc == {"violations": [], "count": 0, "files_scanned": 1}

    def test_dirty_tree_schema_ordering_and_exit_one(self, tmp_path):
        proc, doc = run_cli(tmp_path, {
            HOT: """\
                def b(x):
                    return x.item()

                def a(x):
                    return x.cpu()
            """,
            "poseidon_tpu_torch/a_first.py": """\
                import torch

                def f(model):
                    return torch.compile(model)
            """,
        })
        assert proc.returncode == 1
        assert doc["count"] == len(doc["violations"]) == 3
        for v in doc["violations"]:
            assert list(v) == self.KEYS
        keys = [(v["path"], v["line"], v["col"], v["code"])
                for v in doc["violations"]]
        assert keys == sorted(keys)
        assert doc["violations"][0]["path"].endswith("a_first.py")
        assert "kernels_audited" not in doc


class TestCli:
    DIRTY = {
        HOT: """\
            def f(x):
                return x.item()
        """,
        "poseidon_tpu_torch/misc.py": """\
            import torch

            def g(model):
                return torch.compile(model)
        """,
    }

    def test_rule_filter(self, tmp_path):
        proc, doc = run_cli(tmp_path, self.DIRTY, "--rule", "PTA001")
        assert proc.returncode == 1
        assert [v["code"] for v in doc["violations"]] == ["PTA001"]
        proc, doc = run_cli(tmp_path, self.DIRTY, "--rule", "PTA001,PTA003")
        assert sorted(v["code"] for v in doc["violations"]) == \
            ["PTA001", "PTA003"]
        proc, doc = run_cli(tmp_path, self.DIRTY, "--rule", "PTA010")
        assert proc.returncode == 0 and doc["violations"] == []

    def test_usage_errors_exit_two(self, tmp_path):
        proc, _ = run_cli(tmp_path, self.DIRTY, "--rule", "PTA099")
        assert proc.returncode == 2 and "PTA099" in proc.stderr
        sub = tmp_path / "empty"
        sub.mkdir()
        (sub / "notes.md").write_text("no code here\n")
        proc = subprocess.run(
            [sys.executable, "-m", "poseidon_tpu_torch.analysis",
             "--root", str(tmp_path), str(sub)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2 and "no Python targets" in proc.stderr

    def test_audit_flag_fails_on_dead_noqa(self, tmp_path):
        proc, doc = run_cli(tmp_path, {HOT: """\
            def f(x):
                return x + 1  # noqa: PTA001 -- stale reason
        """}, "--audit-suppressions")
        assert proc.returncode == 1
        assert doc["violations"][0]["rule"] == "dead-suppression"


class TestSelfCheck:
    def test_ports_tree_is_violation_free(self, tree_run):
        violations, files_scanned = tree_run
        assert files_scanned > 100
        assert violations == [], "\n".join(
            f"{v.path}:{v.line} {v.code} {v.message}" for v in violations)

    def test_injected_item_in_resident_round_fails(self, tmp_path):
        src = (REPO / HOT).read_text()
        anchor = "    ch, primal = _finalize(dev, dt, pc_s, ra_s, asg)\n"
        assert anchor in src
        bad = src.replace(anchor, anchor + "    leak = primal.item()\n", 1)
        vs = run_on(tmp_path, {HOT: bad})
        assert [v.code for v in vs] == ["PTA001"]
        assert ".item()" in vs[0].message and "_resident_chain" in \
            vs[0].message

    def test_injected_unlocked_mutation_in_bridge_fails(self, tmp_path):
        src = (REPO / BRIDGE).read_text()
        anchor = "    def cancel_round("
        assert anchor in src
        bad = src.replace(anchor, (
            "    def _bg_refresh(self):  # pta: background-thread\n"
            "        self.round_num += 1\n\n") + anchor, 1)
        vs = run_on(tmp_path, {BRIDGE: bad})
        assert any(v.code == "PTA004" and "round_num" in v.message
                   for v in vs)

    def test_unmodified_copies_stay_clean(self, tmp_path):
        vs = run_on(tmp_path, {HOT: (REPO / HOT).read_text(),
                               BRIDGE: (REPO / BRIDGE).read_text()})
        assert vs == []


# ---- the differential: both packages, the reference's contracts ----------

FRAMEWORK_FREE = ("PTA002", "PTA004", "PTA006", "PTA010")


def _mapped_reference_contracts() -> Contracts:
    """The reference's DEFAULT_CONTRACTS as the port's Contracts, field
    by field (the port's own torch fields keep their defaults)."""
    from poseidon_tpu.analysis.contracts import DEFAULT_CONTRACTS as ref

    kw = {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.name == "thread_classes":
            v = {k: ThreadContract(lock_attr=tc.lock_attr,
                                   handoffs=dict(tc.handoffs))
                 for k, tc in v.items()}
        kw[f.name] = v
    return Contracts(**kw)


def _both(monkeypatch, root, paths) -> tuple[list, list]:
    """(reference, port) violation lists of the framework-independent
    passes plus PTA000 and the suppression audit, as plain tuples."""
    import poseidon_tpu.analysis.core as rcore
    from poseidon_tpu.analysis.contracts import DEFAULT_CONTRACTS as ref_c

    import poseidon_tpu_torch.analysis.core as pcore

    out = []
    for core, contracts in ((rcore, ref_c),
                            (pcore, _mapped_reference_contracts())):
        core._ensure_rules_loaded()
        monkeypatch.setattr(core, "FILE_RULES", [
            r for r in core.FILE_RULES if r[0] in FRAMEWORK_FREE])
        monkeypatch.setattr(core, "REPO_RULES", [
            r for r in core.REPO_RULES if r[0] in FRAMEWORK_FREE])
        vs, _ = core.analyze_and_audit(root, paths, contracts)
        out.append([(v.code, v.rule, v.path, v.line, v.col, v.message)
                    for v in vs])
    return out[0], out[1]


class TestDifferential:
    @pytest.mark.parametrize("code", ["PTA000", "PTA002", "PTA004",
                                      "PTA006", "PTA010"])
    @pytest.mark.parametrize("side", ["bad", "good"])
    def test_reference_corpus(self, code, side, tmp_path, monkeypatch):
        import shutil

        src = REPO / "tests" / "fixtures" / "analysis" / code / side
        paths = []
        for f in sorted(src.rglob("*")):
            if f.is_dir():
                continue
            rel = f.relative_to(src).as_posix()
            rel = rel[: -len(".txt")] if rel.endswith(".py.txt") else rel
            out = tmp_path / rel
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(f, out)
            if rel.endswith(".py"):
                paths.append(out)
        ref, port = _both(monkeypatch, tmp_path, paths)
        assert port == ref
        if side == "bad":
            assert any(v[0] == code for v in ref)

    def test_reference_tree(self, monkeypatch):
        from poseidon_tpu.analysis.core import default_targets

        paths = default_targets(REPO)
        ref, port = _both(monkeypatch, REPO, paths)
        assert len(paths) > 100
        assert port == ref


class TestSyncMapChecks:
    """chip_smoke.py [analysis]'s runtime sync map is held on the card;
    its checks are pure host code, rehearsed here on sites shaped like
    the card's (a round's reads and its two declared uploads)."""

    @pytest.fixture(scope="class")
    def inventory(self):
        from poseidon_tpu_torch.analysis.rules import sync_inventory

        return sync_inventory(REPO)

    @staticmethod
    def sanctioned():
        return {(p, q) for p, q, _ in DEFAULT_CONTRACTS.sync_sites}

    def _line(self, rel, needle):
        src = (REPO / rel).read_text().splitlines()
        return next(i for i, ln in enumerate(src, 1) if needle in ln)

    def test_round_shaped_sites_pass(self, inventory):
        import chip_smoke

        upload = ("poseidon_tpu_torch/models/costs.py",
                  self._line("poseidon_tpu_torch/models/costs.py",
                             "torch.as_tensor(getattr(self, f.name))"),
                  False)
        read = (HOT, self._line(HOT, "h = fetches.read(packed)"), True)
        got = chip_smoke.check_sync_window(
            "rehearsal", [upload] * 15 + [read] * 3, 3, inventory,
            self.sanctioned())
        assert got == {"reads": 3, "uploads": 15}

    def test_count_mismatch_and_stray_site_fail(self, inventory):
        import chip_smoke

        read = (HOT, self._line(HOT, "h = fetches.read(packed)"), True)
        with pytest.raises(AssertionError, match="the solver counted 2"):
            chip_smoke.check_sync_window("rehearsal", [read], 2, inventory,
                                         self.sanctioned())
        stray = (HOT, self._line(HOT, "Tp, Mp = dev.c.shape"), False)
        with pytest.raises(AssertionError, match="Contracts.sync_sites"):
            chip_smoke.check_sync_window("rehearsal", [read, stray], 1,
                                         inventory, self.sanctioned())

    def test_every_declared_site_is_in_the_static_inventory(self,
                                                            inventory):
        kinds = {(d["path"], d["qual"]) for d in inventory
                 if d["kind"] == "upload-declared"}
        assert {(p, q) for p, q, _ in DEFAULT_CONTRACTS.sync_sites} == kinds
