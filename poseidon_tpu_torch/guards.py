"""Host-sync accounting for the device-resident round.

The reference enforces "one host sync per round" with a transfer
guard. PyTorch has no such guard, so the port counts instead: every
sanctioned device->host transfer goes through a ``SyncCounter``, and
the resident solver reports the counts of its last round
(``last_round_fetches`` for result fetches, ``last_round_loop_syncs``
for the auction loop's branch-flag reads). Tests assert the counts.

``FetchTimeout`` is raised by the resident solver when a round's
background result fetch exceeds its deadline.

``set_compile_duration_sink`` installs a ``fn(duration_ms)`` that the
kernel loader calls after each first-use ``nvcc`` build (the port's
counterpart of the reference's XLA-compile monitoring seam; the daemon
feeds it to the compile-latency histogram).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_sink_lock = threading.Lock()
_duration_sink = None


class FetchTimeout(RuntimeError):
    """The background placement fetch missed its deadline."""


class SyncCounter:
    """Counts sanctioned device->host reads. ``read`` is the only way
    the solve loop and the result fetch bring device values to the
    host; each call is one synchronising copy."""

    def __init__(self) -> None:
        self.count = 0

    def read(self, t: torch.Tensor) -> np.ndarray:
        self.count += 1
        return t.detach().to("cpu").numpy()


def set_compile_duration_sink(sink) -> bool:
    """Install a ``fn(duration_ms: float)`` receiving every kernel
    build's latency (None to clear). Returns True: the loader always
    reports."""
    global _duration_sink
    with _sink_lock:
        _duration_sink = sink
    return True


def report_compile(duration_ms: float) -> None:
    """Called by the kernel loader after a build; a failing sink must
    not break the build."""
    with _sink_lock:
        sink = _duration_sink
    if sink is not None:
        try:
            sink(duration_ms)
        except Exception:
            pass
