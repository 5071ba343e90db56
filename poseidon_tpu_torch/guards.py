"""Host-sync accounting for the device-resident round.

The reference enforces "one host sync per round" with a transfer
guard. PyTorch has no such guard, so the port counts instead: every
sanctioned device->host transfer goes through a ``SyncCounter``, and
the resident solver reports the counts of its last round
(``last_round_fetches`` for result fetches, ``last_round_loop_syncs``
for the auction loop's branch-flag reads). Tests assert the counts.

``FetchTimeout`` is raised by the resident solver when a round's
background result fetch exceeds its deadline.
"""

from __future__ import annotations

import numpy as np
import torch


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
