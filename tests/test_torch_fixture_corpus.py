"""Golden fixture corpus of the port's contract linter
(tests/fixtures/torch_analysis/).

The counterpart of ``tests/test_fixture_corpus.py``: one parametrized
test per rule code, enumerating all eleven (PTA000-PTA010), so a
missing pair fails. A tree rule's known-bad mini-tree must fire the
rule under ``poseidon_tpu_torch.analysis``'s default contracts and its
known-good one must not; PTA008 and PTA009 run their fixture module's
``bad``/``good`` functions under the op recorder and audit the
recordings. Sources are stored as ``*.py.txt`` so the seeded
violations never enter either analyzer's clean run.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import pathlib
import shutil

import pytest

from poseidon_tpu_torch.analysis import DEFAULT_CONTRACTS, analyze_tree
from poseidon_tpu_torch.analysis import optrace_check

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_analysis"

ALL_RULES = tuple(f"PTA{n:03d}" for n in range(11))
OPTRACE_RULES = ("PTA008", "PTA009")


def _materialize(side: pathlib.Path, dst: pathlib.Path) -> list:
    """Copy a fixture mini-tree, stripping the .txt armor."""
    paths = []
    for src in sorted(side.rglob("*")):
        if src.is_dir():
            continue
        rel = src.relative_to(side).as_posix()
        if rel.endswith(".py.txt"):
            rel = rel[: -len(".txt")]
        out = dst / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, out)
        if rel.endswith(".py"):
            paths.append(out)
    return paths


def _load_fixture_module(code: str):
    path = FIXTURES / code / "fixture.py.txt"
    loader = importlib.machinery.SourceFileLoader(
        f"_torch_corpus_{code.lower()}", str(path)
    )
    spec = importlib.util.spec_from_loader(loader.name, loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _optrace_fires(code: str, mod, which: str) -> bool:
    fn = getattr(mod, which)
    args = mod.example_args()[which]
    rec, _ = optrace_check.record("fixture", fn, args,
                                  taint=code == "PTA009")
    if code == "PTA008":
        return bool(optrace_check.structural_problems(rec,
                                                      DEFAULT_CONTRACTS))
    return bool(rec.candidates)


@pytest.mark.parametrize("code", ALL_RULES)
def test_fixture_pair(code, tmp_path):
    root = FIXTURES / code
    assert root.is_dir(), (
        f"no fixture corpus for {code}: adding a rule requires adding "
        f"its bad/good pair under {root}"
    )
    if code in OPTRACE_RULES:
        mod = _load_fixture_module(code)
        assert _optrace_fires(code, mod, "bad"), f"{code} bad did not fire"
        assert not _optrace_fires(code, mod, "good"), f"{code} good fired"
        return
    for side, expect in (("bad", True), ("good", False)):
        dst = tmp_path / side
        paths = _materialize(root / side, dst)
        assert paths, f"{code}/{side} has no Python fixtures"
        violations, _ = analyze_tree(dst, paths)
        fired = any(v.code == code for v in violations)
        assert fired == expect, (
            f"{code}/{side}: expected fired={expect}, got "
            + "; ".join(f"{v.code} {v.path}:{v.line} {v.message}"
                        for v in violations)
        )
