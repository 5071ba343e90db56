"""``chip_smoke.py``'s ``[ha]``, ``[observe]`` and ``[chaos]`` phases,
rehearsed on the CPU.

The phases run the port's daemons in child processes against the fake
apiserver's process; on the card they serve the flagship. Here
``chip_smoke.DEVICE = "cpu"`` runs them end to end with the kernels'
twins over ``REHEARSAL_SHAPE`` (100 machines x 1,000 pods): a daemon
SIGKILLed mid-actuation, a warm restart that replays its journal and a
standby that takes over when the restarted daemon is SIGKILLed
mid-actuation in turn and replays its journal (every pod bound at most
once, none lost); the flight recorder, a dump
replayed bit for bit, ``--explain``, ``validate``, the audit (each
equal to the reference's audit of the same snapshot) and ``/slo``;
the reference's four chaos scenarios and the scaled one on the dense
path, every invariant held and every dense round equal to the C++
oracle.
"""

import pytest

import chip_smoke
from tests.audit_against_reference import compare


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


def test_ha_phase_rehearsal(cpu_rehearsal, capsys):
    chip_smoke.ha_phase(None, "cpu rehearsal")
    out = capsys.readouterr().out
    assert "A SIGKILLed in round 3's actuation" in out
    assert "B SIGKILLed in round 4's actuation" in out
    assert "B: restored checkpoint round 2 (warm)" in out
    assert "S: restored checkpoint round 3 (warm)" in out
    assert "[ha] S round 4: " in out and "[ha] S round 5: " in out
    assert "DEGRADED" not in out  # no round runs out the fuse here
    assert "none lost" in out


def test_observe_phase_rehearsal(cpu_rehearsal, capsys, tmp_path):
    """Besides the phase's own checks, every audit (regret, status quo,
    optimum) equals the reference's audit of the same snapshot."""
    audits = chip_smoke.observe_phase(None, "cpu rehearsal",
                                      audit_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "explain: == explain default/pod-x1-000 ==" in out
    assert "records bit-identical on cpu" in out
    assert [a["round"] for a in audits] == [2, 3]
    lines = compare(str(tmp_path))
    assert len(lines) == len(audits)
    assert all(line.startswith("same ") for line in lines), lines


def test_chaos_phase_rehearsal(cpu_rehearsal, capsys):
    chip_smoke.chaos_phase(None, "cpu rehearsal")
    out = capsys.readouterr().out
    assert out.count("invariants ok=True") == 5
    assert "scaled scenario: " in out
