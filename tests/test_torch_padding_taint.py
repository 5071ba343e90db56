"""The port's padding-taint audit (poseidon_tpu_torch/analysis/
padding_taint.py, PTA009), the counterpart of tests/test_padding_taint.py.

Unit cases run small torch functions under the taint recorder (the
fold-dominance rule, the transparent ops, the bool-counting exemption,
in-place writes); the production cases run the audited entries on the
CPU (their kernels' twins included): no unsanctioned fold, every
sanction load-bearing, a stale one reported. The acceptance case is the
reference's: stripping ``_express_step``'s arrival-lane masks (a fold
over model output that is masked upstream, on the wrong axis) makes
two unmasked ``min`` folds, and the shipped step has none.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import types

import pytest
import torch

from poseidon_tpu_torch.analysis import DEFAULT_CONTRACTS
from poseidon_tpu_torch.analysis import optrace_check, padding_taint

REPO = pathlib.Path(__file__).resolve().parent.parent
HOT = REPO / "poseidon_tpu_torch" / "ops" / "resident.py"
INF = 2**29


@pytest.fixture(scope="module")
def taint_recordings():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield optrace_check.record_entries("cpu", taint=True)
    finally:
        torch.set_num_threads(n)


def folds(fn, *args):
    rec, _ = optrace_check.record("unit", fn, args, taint=True)
    return sorted(op for op, *_ in rec.candidates)


class TestFoldDominance:
    x = torch.arange(8, dtype=torch.int32)
    valid = torch.arange(8) < 5

    def test_unmasked_fold_over_input_fires(self):
        assert folds(lambda x: x.min(), self.x) == ["min"]
        assert folds(lambda x: torch.argmax(x), self.x) == ["argmax"]
        assert folds(lambda x: x.sum(dim=0), self.x) == ["sum"]

    def test_mask_at_the_fold_is_clean(self):
        assert folds(lambda x, v: torch.where(v, x, INF).min(),
                     self.x, self.valid) == []
        assert folds(lambda x: torch.clamp(x, max=INF).min(), self.x) == []
        assert folds(lambda x, v: x.masked_fill(~v, 0).sum(),
                     self.x, self.valid) == []

    def test_mask_survives_transparent_ops_only(self):
        assert folds(lambda x, v: torch.where(v, x, 0).reshape(2, 4)
                     .to(torch.int64).sum(), self.x, self.valid) == []
        # arithmetic after the mask: the mask no longer dominates
        assert folds(lambda x, v: (torch.where(v, x, 0) + x).min(),
                     self.x, self.valid) == ["min"]

    def test_bool_counting_exempt_but_any_fires(self):
        assert folds(lambda v: v.sum(), self.valid) == []
        assert folds(lambda v: v.any(), self.valid) == ["any"]

    def test_elementwise_min_is_not_a_fold(self):
        assert folds(lambda x: torch.min(x, x + 1), self.x) == []

    def test_tensors_made_inside_are_clean(self):
        assert folds(lambda x: torch.arange(8).min() + x.shape[0],
                     self.x) == []

    def test_in_place_write_taints_its_target(self):
        def f(x):
            buf = torch.zeros(8, dtype=torch.int32)
            buf.copy_(x)
            return buf.max()

        assert folds(f, self.x) == ["max"]


class TestProduction:
    def test_entries_clean(self, taint_recordings):
        vs, n = padding_taint.run_padding_audit(
            REPO, recordings=taint_recordings)
        assert n == len(optrace_check.ENTRIES)
        assert vs == [], [v.message for v in vs]

    def test_sanctioned_sites_still_seen(self, taint_recordings):
        """The sanctioned folds are FOUND (safe by construction, not by a
        visible mask): the pass has not gone blind."""
        got = {(c[1], c[2]) for c in padding_taint.candidates(
            taint_recordings)}
        assert {("any", "head"), ("any", "pre"), ("any", "tighten"),
                ("sum", "_certify")} <= got, got

    def test_every_sanction_is_load_bearing(self, taint_recordings):
        checked = 0
        for entry, items in DEFAULT_CONTRACTS.kernel_mask_contracts.items():
            for item in items:
                left = {e: tuple(i for i in its if i is not item)
                        for e, its in
                        DEFAULT_CONTRACTS.kernel_mask_contracts.items()}
                c = dataclasses.replace(DEFAULT_CONTRACTS,
                                        kernel_mask_contracts=left)
                vs, _ = padding_taint.run_padding_audit(
                    REPO, recordings=taint_recordings, contracts=c)
                assert any(f"{item[0]} in {item[1]}" in v.message
                           for v in vs), item
                checked += 1
        assert checked >= 4

    def test_stale_sanction_reported(self, taint_recordings):
        extra = dict(DEFAULT_CONTRACTS.kernel_mask_contracts)
        extra["solve"] = (("max", "no_such_function", "test: stale"),)
        c = dataclasses.replace(DEFAULT_CONTRACTS,
                                kernel_mask_contracts=extra)
        vs, _ = padding_taint.run_padding_audit(
            REPO, recordings=taint_recordings, contracts=c)
        assert [v.message.split(":")[0] for v in vs] == [
            "stale kernel_mask_contracts entry"]


# the arrival-lane masks of _express_step's domain guard (in its head,
# _express_head, which the stream lane's window shares)
_MASKED_U = "torch.where(arr_valid, u_u, 0).min(),"
_MASKED_W = "torch.where(arr_valid, w_u, 0).min(),"


def _express_step_folds(module) -> list:
    entries = optrace_check.production_entries("cpu")
    _name, _fn, args, kwargs = next(e for e in entries
                                    if e[0] == "express_step")
    rec, _ = optrace_check.record("express_step", module._express_step,
                                  args, kwargs, taint=True)
    return sorted((op, line) for op, fn, _p, line in rec.candidates
                  if fn in ("_express_step", "_express_head"))


class TestExpressAcceptance:
    def test_reverted_arrival_mask_fires(self):
        src = HOT.read_text()
        assert _MASKED_U in src and _MASKED_W in src
        bad = src.replace(_MASKED_U, "u_u.min(),", 1).replace(
            _MASKED_W, "w_u.min(),", 1)
        name = "poseidon_tpu_torch.ops._reverted_resident"
        mod = types.ModuleType(name)
        sys.modules[name] = mod    # its dataclasses resolve through it
        try:
            # compiled under the real file's name, so the recorder
            # attributes its folds to ops/resident.py's _express_step
            exec(compile(bad, str(HOT), "exec"), mod.__dict__)
            hits = _express_step_folds(mod)
        finally:
            del sys.modules[name]
        assert [op for op, _ in hits] == ["min", "min"], hits

    def test_shipped_express_step_is_clean(self):
        from poseidon_tpu_torch.ops import resident

        assert _express_step_folds(resident) == []
