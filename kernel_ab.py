#!/usr/bin/env python3
"""Time the row kernels (K2 ``row_options``, K3 ``bid_pass``) of one or
more checkouts on one GPU, in turns, in one run.

    python3 kernel_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (for example a
``git archive`` of an older commit unpacked into a directory that
``.gitignore`` lists). Each is measured in its own process, in the order
given, so list them in turns (old, new, new, old) to see the card's
drift. Every process builds its checkout's kernels, makes flagship-shaped
inputs from one seed (Tp = 10240, Mp = 1024, bid window B = 2560: the
shapes of BASELINE config 2), checks each kernel against its plain twin
(tolerance 0) and prints one JSON line:

- ``cold_ms``: median CUDA-event time of one call, the L2 cache flushed
  first by reading 128 MiB (so L2 holds no dirty line) and the card held
  busy (``torch.cuda._sleep``) until the host has enqueued the call, so
  the time is the card's alone;
- ``cold_dirty_ms``: the same, but flushed by writing the 128 MiB (the
  flush ``chip_smoke.py`` used before it read instead): the call's reads
  then also pay for writing back the ~50 MB of dirty lines they evict;
- ``read_floor_ms``: as ``cold_ms``, for one PyTorch reduction that
  reads the bytes the kernel must read (``c.max()``; for K3 ``B``
  contiguous rows): a yardstick of what the card reaches on such a read,
  not a call the port makes;
- ``warm_ms``: CUDA-event time of 20 back-to-back calls over 20, the
  table left in L2 (the auction loop's case: the 40 MiB table fits in
  the 50 MB L2), the card again held busy until all 20 are enqueued;
- ``host_us``: host time per wrapper call over 100 calls without a
  synchronise, and ``wall_us`` the same with the one synchronise at the
  end; each the median of 7 such batches, every worker pinned to the
  same CPU core.

The card's name and power limit come first, from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPEATS = 30
WARM_CALLS = 20
HOST_CALLS = 100
HOST_BATCHES = 7
SLEEP_CYCLES = 1_000_000


def worker(root: str) -> dict:
    # every worker on the same one core, so host times compare
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".") != here]
    import numpy as np
    import torch

    import poseidon_tpu_torch
    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import loader
    from poseidon_tpu_torch.kernels import row_options as k2

    report = loader.build_all()
    regs = {
        src: [ln.strip() for ln in text.splitlines()
              if "registers" in ln or "spill" in ln]
        for src, text in report.ptxas.items()
    }
    rng = np.random.default_rng(0)
    Tp, Mp, B, inf = 10240, 1024, 2560, 2**29
    c = rng.integers(0, 3000, (Tp, Mp))
    c[rng.random((Tp, Mp)) < 0.05] = inf
    p = rng.integers(0, 2000, Mp)
    u = rng.integers(0, 4000, Tp)
    dev = torch.device("cuda")
    c, p, u = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (c, p, u))
    btask = torch.from_numpy(
        rng.choice(Tp, size=B, replace=False).astype(np.int32)).to(dev)
    bvalid = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    calls = {
        "row_options": (k2.row_options, k2.row_options_plain, (c, p)),
        "bid_pass": (k3.bid_pass, k3.bid_pass_plain,
                     (c, p, u, btask, bvalid, 1)),
    }
    # yardsticks: one PyTorch reduction that reads the same bytes (all
    # of c; B contiguous rows of c), timed as cold_ms is
    floors = {"row_options": lambda: c.max(),
              "bid_pass": lambda: c[:B].max()}
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)
    out = {"root": root, "package": poseidon_tpu_torch.__file__, "ptxas": regs}
    for name, (fn, plain, args) in calls.items():
        for g, w in zip(fn(*args), plain(*args)):
            if not torch.equal(g, w):
                raise AssertionError(f"{root}: {name} != its plain twin")
        cold = {}
        for how, flush_l2, call in (
            ("cold_ms", lambda: flush.max(), lambda: fn(*args)),
            ("cold_dirty_ms", flush.zero_, lambda: fn(*args)),
            ("read_floor_ms", lambda: flush.max(), floors[name]),
        ):
            times = []
            for _ in range(REPEATS):
                flush_l2()
                torch.cuda._sleep(SLEEP_CYCLES)
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                call()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            times.sort()
            cold[how] = times[len(times) // 2]
        fn(*args)
        torch.cuda._sleep(SLEEP_CYCLES * WARM_CALLS)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(WARM_CALLS):
            fn(*args)
        b.record()
        b.synchronize()
        host, wall = [], []
        for _ in range(HOST_BATCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) / HOST_CALLS * 1e6)
            wall.append((t2 - t0) / HOST_CALLS * 1e6)
        out[name] = {
            **cold,
            "warm_ms": a.elapsed_time(b) / WARM_CALLS,
            "host_us": sorted(host)[HOST_BATCHES // 2],
            "wall_us": sorted(wall)[HOST_BATCHES // 2],
        }
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    for root in argv:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(root)],
            cwd=root, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
