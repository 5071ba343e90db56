"""SSP's loop words, which K10 ``in`` and K11 read and end their launches
on, and the plain twins of those ends.

Step 2 of K14 for SSP: the kernel that computes a loop's condition sets
it. ``csrc/ssp_loop.cuh`` holds the device side; this module lays out the
same words. The last block of a K10 ``in`` launch ends the relaxation
round (the dist parity and the round count advance; the round loop's
``changed && it < NN`` goes to a go word, the tally and, inside SSP's
graph, the WHILE node's handle); the last block of a K11 step ends the
path step (both parities and the path count advance, the round count
restarts; ``routed < wanted && delta > 0 && paths < max_paths`` decides
the path loop, and the round loop is armed for the next path). Replaces
the K14 LOOP nodes of SSP's graph (``poseidon_tpu/ops/ssp.py`` :165 and
:120's conditions), the memset of ``changed`` and the host's ``add_``s
between the bodies.

The conditional handles are made after the bodies are captured, so the
kernels read them from ``handles`` (int64[3]: how many, the round loop's,
the path loop's), written once by ``arm`` after the graph is built; an
eager launch (the host loop, the tests, the edge battery) leaves the
count 0 and sets nothing.
"""

from __future__ import annotations

import ctypes

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg
from poseidon_tpu_torch.kernels.loop_graph import TALLY

# the words (csrc/ssp_loop.cuh ``Word``): the parities of the dist and
# pot pairs, the path count, the rounds of the current path, a round's
# ``changed``, the go words of the round loop and of the path loop, the
# launch ticket
D, P, PATHS, IT, CHANGED, GO_BF, GO_PATH, TICKET = range(8)
WORDS = 8
# the limits (``Limit``)
WANTED, MAX_PATHS, NN = range(3)
# the tally slots of SSP's graph: launches, the first path's entry, the
# further paths, relaxation rounds
T_LAUNCH, T_FIRST, T_PATH, T_ROUND = range(4)
# the handle words (``Handle``)
H_COUNT, H_BF, H_PATH = range(3)


class _Loop(ctypes.Structure):
    """``ssp::Loop`` of ``csrc/ssp_loop.cuh``: four device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "words", "limits", "tally", "handles")]


class SspLoop:
    """One SSP solve's loop words on its device: ``words`` int32[8] (all
    0 at the start), ``limits`` int32[3] (wanted, max_paths, NN, each
    capped at 2^31 - 1), ``tally`` int32[8] (the solve graph's tally) and
    ``handles`` int64[3]."""

    def __init__(self, device, wanted: int, max_paths: int, nn: int):
        i32 = torch.int32
        self.words = torch.zeros(WORDS, dtype=i32, device=device)
        self.limits = torch.empty(3, dtype=i32, device=device)
        for i, v in ((WANTED, wanted), (MAX_PATHS, max_paths), (NN, nn)):
            # a fill: no blocking upload of host data
            self.limits[i:i + 1].fill_(min(v, 2**31 - 1))
        self.tally = torch.zeros(TALLY, dtype=i32, device=device)
        self.handles = torch.zeros(3, dtype=torch.int64, device=device)
        self.c = None       # the kernels' ``ssp::Loop``, on the card
        if self.words.device.type == "cuda":
            self.c = _Loop(
                kernel_arg(self.words, "loop.words", i32, (WORDS,)),
                kernel_arg(self.limits, "loop.limits", i32, (3,)),
                kernel_arg(self.tally, "loop.tally", i32, (TALLY,)),
                kernel_arg(self.handles, "loop.handles", torch.int64, (3,)))

    def arm(self, handles: dict) -> None:
        """Hand the graph's handles ``bf`` (the round loop's) and ``path``
        to the kernels, on the current stream before the launch."""
        for slot, name in ((H_BF, "bf"), (H_PATH, "path")):
            h = handles[name]
            self.handles[slot:slot + 1].fill_(h - 2**64 if h >= 2**63 else h)
        self.handles[H_COUNT:H_COUNT + 1].fill_(2)


def round_tail_plain(loop: SspLoop, improved) -> None:
    """A relaxation round's end (``round_tail``), in place: ``improved``
    (bool 0-d) ORs into ``changed``, which is read and zeroed; the round
    count and the dist parity advance; go = changed && it < NN."""
    w = loop.words
    changed = (w[CHANGED] != 0) | improved
    w[IT] += 1
    w[D] += 1
    go = (changed & (w[IT] < loop.limits[NN])).to(torch.int32)
    loop.tally[T_ROUND] += go
    w[GO_BF] = go
    w[CHANGED] = 0


def step_tail_plain(loop: SspLoop, state, first: bool) -> None:
    """A path step's end (``step_tail``), in place: both parities advance;
    after a path the path count too, the round count restarts and the
    path loop's go is decided from ``state`` (routed, delta); the round
    loop is armed for the next path's first round."""
    w = loop.words
    w[D] += 1
    w[P] += 1
    go = torch.ones((), dtype=torch.int32, device=w.device)
    if not first:
        w[PATHS] += 1
        w[IT] = 0
        go = ((state[0] < loop.limits[WANTED]) & (0 < state[1])
              & (w[PATHS] < loop.limits[MAX_PATHS])).to(torch.int32)
        loop.tally[T_PATH] += go
        w[GO_PATH] = go
    arm = (go.bool() & (w[IT] < loop.limits[NN])).to(torch.int32)
    loop.tally[T_ROUND] += arm
    w[GO_BF] = arm
