"""Host-sync accounting for the device-resident round.

The reference enforces "one host sync per round" with a transfer
guard. PyTorch has no such guard, so the port counts instead: every
sanctioned device->host transfer goes through a ``SyncCounter``, and
the resident solver reports the counts of its last round
(``last_round_fetches`` for result fetches, ``last_round_loop_syncs``
for the auction loop's branch-flag reads). Tests assert the counts.

``FetchTimeout`` is raised by the resident solver when a round's
background result fetch exceeds its deadline.

``GuardError`` is raised by a host guard that refuses an instance
outside a kernel's envelope before anything launches (the dense
table's cost domain and memory budget, cost-scaling's excess wrap,
SSP's cost bound). The front door degrades to the oracle on this type
alone; a wrapper's own argument errors are plain ``ValueError`` and
propagate.

``set_compile_duration_sink`` installs a ``fn(duration_ms)`` that the
kernel loader calls after each first-use ``nvcc`` build (the port's
counterpart of the reference's XLA-compile monitoring seam; the daemon
feeds it to the compile-latency histogram).

``CompileCounter`` counts, inside its block, what the port pays where
the reference compiles: ``nvcc`` builds and new kernel launch plans
(``note_build``, called by the loader and the plan caches). The service
and stream lanes assert it stays at 0 in steady state.

``census`` is the seam of the op-trace audit
(``analysis/optrace_check.py``): while a recorder is active, a
``SyncCounter.read`` and each hand kernel's wrapper
(``kernels._args.census_op``) tell it where they begin and end, so the
audit counts each as one op under its own name — the same census on
the CPU (the twins) and on the card (the kernels). With no recorder it
costs one list test.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_sink_lock = threading.Lock()
_duration_sink = None
_counter_lock = threading.Lock()
_active_counters: list["CompileCounter"] = []


class FetchTimeout(RuntimeError):
    """The background placement fetch missed its deadline."""


class GuardError(ValueError):
    """A host guard refused the instance before any launch."""


# the active op-trace recorders (analysis/optrace_check.py)
_census: list = []


class census:
    """``with census(name):`` marks one counted op (a sanctioned read or
    a hand kernel) for every active op-trace recorder."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        for r in _census:
            r.enter(self.name)

    def __exit__(self, *exc) -> None:
        for r in reversed(_census):
            r.exit(self.name)


class SyncCounter:
    """Counts sanctioned device->host reads. ``read`` is the only way
    the solve loop and the result fetch bring device values to the
    host; each call is one synchronising copy."""

    def __init__(self) -> None:
        self.count = 0

    def read(self, t: torch.Tensor) -> np.ndarray:
        self.count += 1
        if _census:
            with census("SyncCounter.read"):
                return t.detach().to("cpu").numpy()
        return t.detach().to("cpu").numpy()


def set_compile_duration_sink(sink) -> bool:
    """Install a ``fn(duration_ms: float)`` receiving every kernel
    build's latency (None to clear). Returns True: the loader always
    reports."""
    global _duration_sink
    with _sink_lock:
        _duration_sink = sink
    return True


class CompileCounter:
    """Context manager counting kernel builds and new launch plans made
    in the block (the reference counts XLA compiles). ``supported`` is
    always True: every build and plan goes through ``note_build``."""

    supported = True

    def __init__(self) -> None:
        self.count = 0

    def __enter__(self) -> "CompileCounter":
        with _counter_lock:
            _active_counters.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _counter_lock:
            _active_counters.remove(self)


def note_build() -> None:
    """One kernel build or one new launch plan, for every active
    ``CompileCounter``."""
    with _counter_lock:
        for c in _active_counters:
            c.count += 1


def report_compile(duration_ms: float) -> None:
    """Called by the kernel loader after a build; a failing sink must
    not break the build."""
    note_build()
    with _sink_lock:
        sink = _duration_sink
    if sink is not None:
        try:
            sink(duration_ms)
        except Exception:
            pass
