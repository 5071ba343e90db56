"""The port's op-trace audit (poseidon_tpu_torch/analysis/optrace_check.py,
PTA008), the counterpart of tests/test_jaxpr_check.py.

Detectors on small functions run under the recorder: a float64 leak, a
host read in a loop (``.item()``, ``int()`` of a tensor, a boolean-mask
index) outside ``SyncCounter.read``, a tensor made from host data in a
loop, a device move counted apart from the census, the kernel seam
counting a wrapper as one op. Production: the six audited entries on
the CPU give exactly the pinned census (``analysis/op_fingerprints.json``)
with no structural problem, ``--update-fingerprints`` reproduces the
committed file, a changed count is reported, and the CLI's JSON carries
``kernels_audited``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from poseidon_tpu_torch.analysis import DEFAULT_CONTRACTS, optrace_check
from poseidon_tpu_torch.guards import SyncCounter
from poseidon_tpu_torch.kernels import row_options

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def recordings():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield optrace_check.record_entries("cpu")
    finally:
        torch.set_num_threads(n)


def problems(fn, *args, contracts=DEFAULT_CONTRACTS):
    rec, _ = optrace_check.record("unit", fn, args)
    return [m for m, _site in optrace_check.structural_problems(
        rec, contracts)], rec


class TestDetectors:
    x = torch.arange(16, dtype=torch.int32)

    def test_float64_leak(self):
        got, _ = problems(lambda x: x.to(torch.float64) * 2, self.x)
        assert any("float64" in m for m in got), got
        got, _ = problems(lambda x: x.to(torch.int64) * 2, self.x)
        assert got == []

    def test_host_read_in_a_loop(self):
        def loop(x):
            total = 0
            for _ in range(3):
                total += (x > 0).sum().item()
            return total

        got, _ = problems(loop, self.x)
        assert len(got) == 1 and "outside SyncCounter.read" in got[0]

    def test_counted_read_is_one_op(self):
        def loop(x):
            syncs = SyncCounter()
            return [int(syncs.read((x > k).sum())) for k in range(3)]

        got, rec = problems(loop, self.x)
        assert got == []
        assert rec.census["SyncCounter.read"] == 3
        assert "aten._to_copy.default" not in rec.census

    def test_implicit_syncs(self):
        got, _ = problems(lambda x: x[x > 3], self.x)
        assert len(got) == 1 and "index" in got[0]
        got, _ = problems(lambda x: torch.nonzero(x), self.x)
        assert len(got) == 1 and "nonzero" in got[0]

    def test_host_tensor_made_in_a_loop(self):
        def loop(x):
            for k in range(2):
                x = x + torch.tensor(k, dtype=torch.int32)
            return x

        def fill(x):
            for k in range(2):
                x = x + torch.full((), k, dtype=torch.int32)
            return x

        got, _ = problems(loop, self.x)
        assert got and all("host data" in m for m in got)
        assert problems(fill, self.x)[0] == []

    def test_declared_upload_is_sanctioned(self):
        import numpy as np

        from poseidon_tpu_torch.ops.batch import upload_members

        host = {"u": np.zeros((2, 4), np.int32), "scale": np.ones(2)}
        got, rec = problems(upload_members, host, "cpu")
        assert len(got) == 1 and "host data" in got[0]
        c = dataclasses.replace(DEFAULT_CONTRACTS, optrace_uploads={
            "unit": (("poseidon_tpu_torch/ops/batch.py", "upload_members",
                      "test: a declared upload"),)})
        assert optrace_check.structural_problems(rec, c) == []

    def test_device_move_counted_apart(self):
        got, rec = problems(lambda x: x.to("meta"), self.x)
        assert "aten._to_copy.default" not in rec.census
        assert sum(rec.transfers.values()) == 1
        assert any("not a declared upload" in m for m in got)

    def test_kernel_wrapper_is_one_op(self):
        c = torch.randint(0, 100, (8, 16), dtype=torch.int32)
        p = torch.zeros(16, dtype=torch.int32)
        got, rec = problems(row_options.row_options, c, p)
        assert got == []
        assert dict(rec.census) == {"kernel.row_options": 1}
        # with suspension off (the taint pass) the twin's ops are seen
        trec, _ = optrace_check.record("unit", row_options.row_options,
                                       (c, p), taint=True)
        assert not trec.census


class TestProduction:
    def test_census_matches_pinned(self, recordings):
        vs, n = optrace_check.run_optrace_audit(REPO, recordings=recordings)
        assert n == len(optrace_check.ENTRIES) == 6
        assert vs == [], [v.message for v in vs]

    def test_every_entry_runs_its_kernels(self, recordings):
        census = {k: v.census for k, v in recordings.items()}
        assert census["express_patch"] == {"kernel.express_patch": 1}
        for name in ("resident_chain", "solve_member"):
            assert {"kernel.densify", "kernel.row_options",
                    "kernel.bid_pass"} <= set(census[name]), name
        assert census["stream_chain"]["kernel.stream_commit"] == 2
        assert census["express_step"]["kernel.express_rows"] == 1
        for name in ("solve", "resident_chain", "express_step",
                     "stream_chain", "solve_member"):
            assert census[name]["SyncCounter.read"] >= 1, name
            assert not recordings[name].transfers, name

    def test_update_reproduces_the_committed_file(self, recordings,
                                                  tmp_path):
        out = tmp_path / optrace_check.FINGERPRINT_FILE
        out.parent.mkdir(parents=True)
        optrace_check.run_optrace_audit(tmp_path, update=True,
                                        recordings=recordings)
        assert out.read_text() == (REPO / optrace_check.FINGERPRINT_FILE
                                   ).read_text()

    def test_changed_count_is_reported(self, recordings, tmp_path):
        pinned = json.loads((REPO / optrace_check.FINGERPRINT_FILE)
                            .read_text())
        pinned["entries"]["solve"]["ops"]["SyncCounter.read"] += 1
        out = tmp_path / optrace_check.FINGERPRINT_FILE
        out.parent.mkdir(parents=True)
        out.write_text(json.dumps(pinned))
        vs, _ = optrace_check.run_optrace_audit(tmp_path,
                                                recordings=recordings)
        assert [v.code for v in vs] == ["PTA008"]
        assert "solve: op 'SyncCounter.read'" in vs[0].message


def test_cli_optrace_json_schema():
    proc = subprocess.run(
        [sys.executable, "-m", "poseidon_tpu_torch.analysis",
         "--optrace-only", "--format=json", "--device=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc == {"violations": [], "count": 0, "files_scanned": 0,
                   "kernels_audited": 6}
