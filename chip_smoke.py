#!/usr/bin/env python3
"""Drive poseidon_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, the CUDA toolkit (``nvcc``) and ``g++``, and no network. It
exits non-zero, printing no result line, when any phase fails, when no
card is visible, or when the package is not importable.

Phases (each prints its own lines):

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compiles the three CUDA kernels from ``poseidon_tpu_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel) and the C++
   oracle, and prints the build seconds;
3. kernels: at the flagship's shapes (BASELINE config 2: 1,000 machines,
   10,000 pods -> Tp = 10240, Mp = 1024, bid window 2560) each kernel's
   output must equal its plain PyTorch twin's on the same card inputs
   bit for bit (tolerance 0: every output is an integer); prints the
   median CUDA-event time of the kernel and of the twin over repeats,
   each with the L2 cache flushed first, and the kernel's least possible
   time on an H100 (its bytes over 3.35 TB/s vs its operations over
   67 T/s of 32-bit scalar throughput); K1's write floor, one ``fill_``
   of a table of c's size timed the same way (a yardstick, not a call
   the port makes); the host time of one wrapper call of K1, K2 and K3
   with its launch plan (``host_us``: N calls timed without a
   synchronise, over N; ``wall_us`` adds the one synchronise at the
   end; medians of 7 batches); and an edge battery that holds the
   kernels against their twins (tolerance 0) at their designs' edges:
   for K1 Mp of 16, 64, 1028 and 41984, Tp of 1, 3, 5 and past a whole
   tile, Pw of 0, 1, 3, 5 and 48 (no stage fits) with n_prefs 0, 1 and
   Pw, no preference at all, preferences on padded columns and racks
   of -1, every slot 0, every task cost INF and sums that wrap int32;
   for K2 and K3 Mp of 16, 64, 1028 and past the shared-memory p
   budget, fewer rows than resident warps, one slot and fewer slots
   than SMs, repeated window tasks, all-tied rows, all-INF rows, and
   costs and prices that wrap int32;
4. parity: a small flagship-shaped cluster (64 machines x 600 pods), one
   cold and two churned warm rounds on the card and on the CPU (the
   twins): every field of every round must be equal;
5. main path: ``config2_quincy_flagship(seed=0)`` through
   ``ResidentSolver(device="cuda", small_to_oracle=False).run_round``,
   one cold round and three warm rounds over a seeded 1% churn of pods
   (100 retired, 100 new). Launch counts are zeroed just before and
   read just after. Every round must be ``dense_auction``, certified,
   equal in cost to the C++ oracle on the same priced graph, with one
   result fetch; every kernel must have launched in every round. One
   more warm round under ``torch.profiler`` prints the device busy and
   idle share, the top device items, and each hand kernel's device time
   by its CUDA symbol: total, launches, and time per launch as the
   auction loop calls it, and the time of K2's first launch after K1
   (it reads the table K1 has just written).

The last lines are the kernels' JSON record, the ``nvidia-smi`` line,
and the contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12          # 32-bit scalar (non-tensor) peak, same sheet
REPEATS = 30
SLEEP_CYCLES = 1_000_000         # ~0.5 ms of card time ahead of each timed call
# the hand kernels' CUDA symbols, as the profiler names them
KERNEL_SYMBOLS = ("densify_kernel", "row_options_kernel", "bid_pass_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cost_kwargs(cluster):
    import numpy as np

    pending = cluster.pending()
    return dict(
        task_cpu_milli=np.array(
            [int(t.cpu_request * 1000) for t in pending], np.int64),
        task_mem_kb=np.array(
            [t.memory_request_kb for t in pending], np.int64),
    )


def churn(cluster, round_no: int, fraction: float = 0.01):
    """Retire ``fraction`` of the pods and add as many new ones, seeded
    by the round number (new pods are shaped like the synth's)."""
    import numpy as np

    from poseidon_tpu_torch.cluster import ClusterState, Task

    rng = np.random.default_rng(1000 + round_no)
    tasks = list(cluster.tasks)
    k = max(int(len(tasks) * fraction), 1)
    drop = set(rng.choice(len(tasks), size=k, replace=False).tolist())
    kept = [t for i, t in enumerate(tasks) if i not in drop]
    machines = cluster.machines
    names = [m.name for m in machines]
    racks = sorted({m.rack for m in machines})
    for j in range(k):
        home = racks[int(rng.integers(0, len(racks)))]
        in_home = [n for n, m in zip(names, machines) if m.rack == home]
        prefs = {
            str(n): int(rng.integers(20, 200))
            for n in rng.choice(in_home, size=min(2, len(in_home)),
                                replace=False)
        }
        if rng.random() < 0.3:
            prefs[home] = int(rng.integers(10, 100))
        kept.append(Task(
            uid=f"pod-r{round_no}-{j:05d}", job=f"job-r{round_no}-{j // 8}",
            cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
            memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
            data_prefs=prefs, wait_rounds=int(rng.integers(0, 4)),
        ))
    return ClusterState(machines=machines, tasks=kept)


class Timer:
    """Median CUDA-event time of a call, the L2 cache flushed first by
    reading 128 MiB (a read leaves no dirty line in L2 for the call's
    own reads to write back on eviction, as a flush by writing would).

    The card spins for ~0.5 ms (``torch.cuda._sleep``) between the flush
    and the start event, so the host has enqueued the call before the
    card reaches the start event: the time is the card's alone, not the
    wrapper's host time (which a slow host can make longer than the
    flush)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, repeats: int = REPEATS) -> float:
        torch = self.torch
        fn()                                   # warm up
        times = []
        for _ in range(repeats):
            self.flush.max()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def max_abs_err(got, want) -> int:
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        d = g.to(torch.int64) - w.to(torch.int64)
        err = max(err, int(d.abs().max()) if d.numel() else 0)
    return err


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flagship_inputs(torch, device):
    """The flagship round's densify inputs, priced on the card."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.network import pad_bucket
    from poseidon_tpu_torch.models.costs import (
        build_cost_inputs_host, quincy_cost,
    )
    from poseidon_tpu_torch.ops.resident import _redensify, pad_topology
    from poseidon_tpu_torch.ops.transport import extract_topology
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    cluster = config2_quincy_flagship(seed=0)
    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    topo = extract_topology(meta, arrays["src"], arrays["dst"], arrays["cap"])
    dt = pad_topology(topo).to_device(device)
    inputs = build_cost_inputs_host(
        pad_bucket(meta.n_arcs), meta, **cost_kwargs(cluster)
    ).to_device(device)
    smax = min(pad_bucket(int(topo.slots.max()), minimum=1),
               dt.arc_unsched.shape[0])
    return dt, quincy_cost(inputs), smax


def kernel_phase(torch, timer):
    """Hold K1-K3 against their twins at the flagship's shapes and time
    them. Returns the kernels' records (launches filled in later)."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import densify as k1
    from poseidon_tpu_torch.kernels import row_options as k2
    from poseidon_tpu_torch.ops.dense_auction import INF, _theta_clearing
    from poseidon_tpu_torch.ops.resident import _redensify

    dev = torch.device("cuda")
    dt, cost, smax = flagship_inputs(torch, dev)
    P = dt.pref_machine.shape[1]
    inst, _, pc_s, ra_s = _redensify(dt, cost, n_prefs=P, smax=smax)
    # the channel arrays exactly as _redensify hands them to densify
    a1 = (inst.w, inst.dgen, ra_s, dt.rack_of, dt.slots, pc_s,
          dt.pref_machine, dt.pref_rack)
    Tp, Mp = inst.c.shape
    records = []

    # K1 densify
    got = k1.densify(*a1, n_prefs=P)
    want = k1.densify_plain(*a1, n_prefs=P)
    err = max_abs_err([got], [want])
    b = Tp * Mp * 4 + Tp * 4 + 4 * Mp * 4 + 3 * Tp * a1[5].shape[1] * 4
    ops = Tp * Mp * (3 + 6 * P)
    records.append((k1.KERNEL, err, timer(lambda: k1.densify(*a1, n_prefs=P)),
                    timer(lambda: k1.densify_plain(*a1, n_prefs=P)),
                    *bound_ms(b, ops), (Tp, Mp, P)))
    # yardstick, not a call the port makes: one fill_ of a table of c's
    # size, what the card reaches writing the same bytes
    table = torch.empty((Tp, Mp), dtype=torch.int32, device=dev)
    log(f"[kernels] densify write_floor_ms={timer(lambda: table.fill_(0)):.6f} "
        f"(one fill_ of an int32 [{Tp}, {Mp}] table, L2 flushed)")
    del table

    # K2 row_options, at the stage-one clearing prices of the cold round
    lam = _theta_clearing(inst)[2]
    p = torch.where(inst.s > 0, lam, INF).contiguous()
    got = k2.row_options(inst.c, p)
    want = k2.row_options_plain(inst.c, p)
    err = max_abs_err(got, want)
    b = Tp * Mp * 4 + Mp * 4 + 3 * Tp * 4
    ops = Tp * Mp * 6
    records.append((k2.KERNEL, err, timer(lambda: k2.row_options(inst.c, p)),
                    timer(lambda: k2.row_options_plain(inst.c, p)),
                    *bound_ms(b, ops), (Tp, Mp)))

    # K3 bid_pass: a full window (B = 2560) of distinct tasks with a
    # fifth of the slots invalid, at the same prices, eps = 1
    B = min(Tp, max(1024, Tp // 4))
    rng = np.random.default_rng(7)
    btask = torch.from_numpy(
        rng.choice(Tp, size=B, replace=False).astype(np.int32)).to(dev)
    bvalid = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    args3 = (inst.c, p, inst.u, btask, bvalid, 1)
    got = k3.bid_pass(*args3)
    want = k3.bid_pass_plain(*args3)
    err = max_abs_err(got, want)
    rows = int(torch.unique(btask).numel())
    b = rows * Mp * 4 + Mp * 4 + rows * 4 + B * 4 + B + 4 * B * 4 + B
    ops = rows * Mp * 8
    records.append((k3.KERNEL, err, timer(lambda: k3.bid_pass(*args3)),
                    timer(lambda: k3.bid_pass_plain(*args3)),
                    *bound_ms(b, ops), (B, Mp)))
    torch.cuda.synchronize()
    for mod, fn, args, key in (
        (k1, lambda *a: k1.densify(*a, n_prefs=P), a1, (Tp, Mp, P, P)),
        (k2, k2.row_options, (inst.c, p), (Tp, Mp)),
        (k3, k3.bid_pass, args3, (B, Mp)),
    ):
        host, wall = host_us(torch, lambda: fn(*args))
        plan = mod.PLANS[(inst.c.device, *key)]
        log(f"[kernels] {mod.KERNEL.name} wrapper host_us={host:.3f} "
            f"wall_us={wall:.3f} per call (median of {HOST_BATCHES} x "
            f"{HOST_CALLS} calls) plan={plan}")
    edge_battery(torch)
    for k, err, ms, plain, bms, by, shape in records:
        log(f"[kernels] {k.name} shape={shape} max_abs_err={err} "
            f"ms={ms:.6f} plain_ms={plain:.6f} bound_ms={bms:.6f} ({by})")
        if err != 0:
            raise AssertionError(f"{k.name}: kernel != plain twin "
                                 f"(max_abs_err {err}, tolerance 0)")
    return records


HOST_CALLS = 100
HOST_BATCHES = 7


def host_us(torch, fn) -> tuple[float, float]:
    """Host microseconds per call of ``fn`` over HOST_CALLS calls: the
    calls alone (no synchronise), and with the one synchronise at the
    end; each the median of HOST_BATCHES batches."""
    fn()
    host, wall = [], []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / HOST_CALLS * 1e6)
        wall.append((t2 - t0) / HOST_CALLS * 1e6)
    return sorted(host)[HOST_BATCHES // 2], sorted(wall)[HOST_BATCHES // 2]


def edge_tables(torch, rng, Tp, Mp, kind):
    """A table c[Tp, Mp] and prices p[Mp] on the card (int32) of one
    edge kind."""
    import numpy as np

    inf = 2**29
    if kind == "rand":           # costs with INF holes, a few INF prices
        c = rng.integers(0, 5000, (Tp, Mp))
        c[rng.random((Tp, Mp)) < 0.1] = inf
        p = rng.integers(0, 3000, Mp)
        p[rng.random(Mp) < 0.05] = inf
    elif kind == "tied":         # c + p is one value per row: all tie
        p = rng.integers(0, 3000, Mp)
        c = rng.integers(3000, 9000, (Tp, 1)) - p[None, :]
    elif kind == "inf":          # every entry INF-saturates
        c = np.full((Tp, Mp), inf)
        p = rng.integers(0, 3000, Mp)
    elif kind == "wrap":         # sums leave int32 and wrap negative
        c = rng.integers(2**31 - 2**20, 2**31, (Tp, Mp))
        p = rng.integers(0, 2**30, Mp)
        p[rng.random(Mp) < 0.1] = inf
    elif kind == "saturate":     # INF + INF and INF + small everywhere
        c = np.where(rng.random((Tp, Mp)) < 0.5, inf,
                     rng.integers(0, 100, (Tp, Mp)))
        p = np.where(rng.random(Mp) < 0.5, inf, rng.integers(0, 100, Mp))
    else:
        raise ValueError(kind)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)).to("cuda")
    return to(c), to(p)


def densify_inputs(torch, rng, Tp, Mp, Pw, kind):
    """K1's channel arrays on the card (int32) of one edge kind: w[Tp],
    d/ra/rack_of/slots[Mp], pc/pm/pr[Tp, Pw]. The last eighth of the
    columns is padding (slots 0, rack -1), as the padded instance has."""
    import numpy as np

    inf = 2**29
    racks = max(Mp // 8, 1)
    real = Mp - Mp // 8
    rack_of = np.where(np.arange(Mp) < real, rng.integers(0, racks, Mp), -1)
    slots = np.where(np.arange(Mp) < real, rng.integers(0, 4, Mp), 0)
    w = np.where(rng.random(Tp) < 0.1, inf, rng.integers(0, 5000, Tp))
    d = np.where(rng.random(Mp) < 0.1, inf, rng.integers(0, 5000, Mp))
    ra = np.where(rng.random(Mp) < 0.1, inf, rng.integers(0, 5000, Mp))
    pc = np.where(rng.random((Tp, Pw)) < 0.1, inf,
                  rng.integers(0, 3000, (Tp, Pw)))
    pm = np.where(rng.random((Tp, Pw)) < 0.3, -1,
                  rng.integers(0, real, (Tp, Pw)))
    pr = np.where(rng.random((Tp, Pw)) < 0.5, -1,
                  rng.integers(0, racks, (Tp, Pw)))
    if kind == "none":           # no task has a preference
        pm[:], pr[:] = -1, -1
    elif kind == "padhit":       # preferences on padded columns, racks -1
        pm = rng.integers(real - 1, Mp, (Tp, Pw))
        pr = rng.integers(-1, 1, (Tp, Pw))
    elif kind == "noslots":      # every slot 0: the whole table is INF
        slots[:] = 0
    elif kind == "winf":         # w all INF: only preferences are finite
        w[:] = inf
    elif kind == "wrap":         # w + d and pc + ra leave int32 and wrap
        w = rng.integers(2**31 - 2**20, 2**31, Tp)
        d = rng.integers(2**30, 2**31, Mp)
        pc = rng.integers(2**31 - 2**20, 2**31, (Tp, Pw))
        ra = rng.integers(2**30, 2**31, Mp)
    elif kind != "rand":
        raise ValueError(kind)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)).to("cuda")
    return tuple(map(to, (w, d, ra, rack_of, slots, pc, pm, pr)))


def densify_edges(torch, rng, big):
    """K1 equals its twin (tolerance 0) at the tile writer's edges."""
    from poseidon_tpu_torch.kernels import densify as k1

    cases = [  # (Tp, Mp, Pw, n_prefs, kind)
        (1, 16, 1, 1, "rand"), (3, 64, 3, 3, "rand"),
        (5, 1028, 5, 5, "rand"), (1003, 1024, 3, 3, "rand"),
        (700, 16, 5, 5, "rand"), (700, 64, 3, 1, "rand"),
        (150, 1028, 5, 0, "rand"), (64, big, 3, 3, "rand"),
        (517, 1024, 5, 5, "none"), (800, 64, 3, 3, "padhit"),
        (41, 1028, 1, 1, "padhit"), (200, 1024, 3, 3, "noslots"),
        (333, 1028, 1, 1, "winf"), (1000, 1024, 5, 5, "wrap"),
        (77, big, 5, 5, "wrap"), (2000, 16, 3, 3, "wrap"),
        (129, 1024, 0, 0, "rand"), (300, 16, 48, 48, "rand"),
    ]
    for Tp, Mp, Pw, n, kind in cases:
        a = densify_inputs(torch, rng, Tp, Mp, Pw, kind)
        err = max_abs_err([k1.densify(*a, n_prefs=n)],
                          [k1.densify_plain(*a, n_prefs=n)])
        plan = k1.PLANS[a[0].device, Tp, Mp, Pw, n]
        log(f"[edges] densify Tp={Tp} Mp={Mp} Pw={Pw} n_prefs={n} {kind}: "
            f"max_abs_err={err} grid={plan.grid} cols={plan.cols} "
            f"tile_rows={plan.tile_rows} stages={plan.stages}")
        if err != 0:
            raise AssertionError(f"densify edge Tp={Tp} Mp={Mp} Pw={Pw} "
                                 f"n_prefs={n} {kind}: kernel != twin "
                                 f"(max_abs_err {err})")


def edge_battery(torch):
    """K1, K2 and K3 equal their twins (tolerance 0) at the designs' edges."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import row_options as k2
    from poseidon_tpu_torch.kernels import row_stream

    # the first Mp on the pad_bucket ladder (multiples of 1024) whose p
    # does not fit in shared memory beside K3's ring, nor K2's
    big = 1024
    while (row_stream.layout(big).p_resident
           or row_stream.layout(big, k3.META_INTS).p_resident):
        big += 1024
    rng = np.random.default_rng(2024)
    densify_edges(torch, rng, big)
    cases2 = [  # (Tp, Mp, kind)
        (37, 16, "rand"), (1000, 64, "rand"), (700, 1028, "rand"),
        (150, big, "rand"), (5, 1024, "rand"), (3, 16, "rand"),
        (600, 1024, "tied"), (300, 1028, "inf"), (500, 1024, "wrap"),
        (64, big, "wrap"), (400, 64, "saturate"), (90, big, "tied"),
    ]
    for Tp, Mp, kind in cases2:
        c, p = edge_tables(torch, rng, Tp, Mp, kind)
        err = max_abs_err(k2.row_options(c, p), k2.row_options_plain(c, p))
        plan = k2.PLANS[c.device, Tp, Mp]
        log(f"[edges] row_options Tp={Tp} Mp={Mp} {kind}: max_abs_err={err} "
            f"grid={plan.grid} stages={plan.layout.stages} "
            f"chunk={plan.layout.chunk} p_resident={plan.layout.p_resident}")
        if err != 0:
            raise AssertionError(f"row_options edge Tp={Tp} Mp={Mp} {kind}: "
                                 f"kernel != twin (max_abs_err {err})")
    cases3 = [  # (Tp, Mp, B, kind, btask mode, eps)
        (100, 1024, 1, "rand", "distinct", 1),
        (1000, 1024, 100, "rand", "distinct", 3),
        (5, 64, 5, "rand", "distinct", 1),
        (2000, 1024, 1024, "rand", "padded", 1),
        (64, 16, 64, "rand", "repeat", 7),
        (700, 1028, 300, "rand", "padded", 1),
        (200, big, 150, "rand", "padded", 2),
        (600, 1024, 512, "tied", "distinct", 1),
        (300, 1024, 256, "inf", "padded", 1),
        (500, 1024, 500, "wrap", "repeat", 2**28),
        (400, 64, 333, "saturate", "padded", 1),
        (64, big, 40, "wrap", "repeat", 5),
    ]
    for Tp, Mp, B, kind, mode, eps in cases3:
        c, p = edge_tables(torch, rng, Tp, Mp, kind)
        u = torch.from_numpy(np.where(
            rng.random(Tp) < 0.2, 2**29, rng.integers(0, 6000, Tp)
        ).astype(np.int32)).to("cuda")
        if mode == "distinct":
            bt = rng.choice(Tp, size=B, replace=False)
            ok = rng.random(B) < 0.8
        elif mode == "padded":   # the window's padding slots: row Tp-1
            n = B // 2
            bt = np.concatenate([rng.choice(Tp - 1, size=n, replace=False),
                                 np.full(B - n, Tp - 1)])
            ok = np.arange(B) < n
        else:                    # any task, any number of times
            bt = rng.integers(0, Tp, B)
            ok = rng.random(B) < 0.5
        btask = torch.from_numpy(bt.astype(np.int32)).to("cuda")
        bvalid = torch.from_numpy(ok).to("cuda")
        args = (c, p, u, btask, bvalid, eps)
        err = max_abs_err(k3.bid_pass(*args), k3.bid_pass_plain(*args))
        plan = k3.PLANS[c.device, B, Mp]
        log(f"[edges] bid_pass Tp={Tp} Mp={Mp} B={B} {kind} {mode} eps={eps}: "
            f"max_abs_err={err} grid={plan.grid} stages={plan.layout.stages} "
            f"chunk={plan.layout.chunk} p_resident={plan.layout.p_resident}")
        if err != 0:
            raise AssertionError(f"bid_pass edge Tp={Tp} Mp={Mp} B={B} {kind}: "
                                 f"kernel != twin (max_abs_err {err})")


def run_rounds(device, clusters, model="quincy"):
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.resident import ResidentSolver

    solver = ResidentSolver(device=device, small_to_oracle=False)
    outs = []
    for cluster in clusters:
        arrays, meta = FlowGraphBuilder().build_arrays(cluster)
        outs.append(solver.run_round(arrays, meta, cost_model=model,
                                     cost_input_kwargs=cost_kwargs(cluster)))
    return outs


def parity_phase():
    """Small rounds on the card equal the same rounds on the CPU."""
    import numpy as np

    from poseidon_tpu_torch.synth import make_synthetic_cluster

    clusters = [make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8)]
    for r in (1, 2):
        clusters.append(churn(clusters[-1], r, fraction=0.05))
    card = run_rounds("cuda", clusters)
    host = run_rounds("cpu", clusters)
    for r, (a, b) in enumerate(zip(card, host)):
        for f in ("assignment", "channel", "task_cost", "task_margin"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"parity round {r}: {f} differs")
        for f in ("cost", "backend", "converged", "rounds", "phases"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(
                    f"parity round {r}: {f} {getattr(a, f)} != {getattr(b, f)}")
        log(f"[parity] round {r}: card == cpu (cost={a.cost} "
            f"backend={a.backend} rounds={a.rounds})")


def oracle_cost(cluster, device) -> tuple[int, float]:
    """The C++ oracle's optimum of the round's priced graph."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import build_cost_inputs, quincy_cost
    from poseidon_tpu_torch.oracle import solve_oracle

    net, meta = FlowGraphBuilder().build(cluster)
    inputs = build_cost_inputs(net, meta, device=device, **cost_kwargs(cluster))
    t0 = time.perf_counter()
    o = solve_oracle(net.with_costs(quincy_cost(inputs)),
                     algorithm="cost_scaling")
    return o.cost, (time.perf_counter() - t0) * 1e3


def profile_round(torch, solver, cluster):
    """One more warm round under torch.profiler: device busy share and
    the device time by kernel name (after the main path's counts were
    read, so these launches are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder

    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    kw = cost_kwargs(cluster)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = solver.run_round(arrays, meta, cost_model="quincy",
                               cost_input_kwargs=kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (a CPU op's own self time on the device
    # is 0; its kernels are listed under their own names)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels_us = sum(t for k, t, _ in rows if not k.startswith("Memcpy")
                     and not k.startswith("Memset"))
    busy = sum(t for _, t, _ in rows)
    log(f"[profile] warm round: wall_us={wall_us:.1f} rounds={out.rounds} "
        f"device_busy_us={busy:.1f} (kernels {kernels_us:.1f}) "
        f"idle_share={1 - min(busy / wall_us, 1):.3f}")
    rows.sort(key=lambda r: -r[1])
    for key, t, n in rows[:12]:
        log(f"[profile]   {t:10.1f} us  x{n:<5d} {key[:90]}")
    for k in KERNEL_SYMBOLS:
        hits = [(t, n) for key, t, n in rows if k in key]
        total = sum(t for t, _ in hits)
        count = sum(n for _, n in hits)
        log(f"[profile] kernel {k}: total_us={total:.1f} launches={count} "
            f"us_per_launch={total / max(count, 1):.3f}")
    # K2's first launch after K1 reads the table K1 has just written: a
    # change in where K1's stores leave c (L2 or memory) shows up here
    from torch.autograd import DeviceType

    order = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
    k1_at = [i for i, e in enumerate(order) if KERNEL_SYMBOLS[0] in e.name]
    after = [e for e in order[k1_at[0] + 1:] if KERNEL_SYMBOLS[1] in e.name] \
        if k1_at else []
    log(f"[profile] first {KERNEL_SYMBOLS[1]} after {KERNEL_SYMBOLS[0]}: "
        + (f"us={after[0].time_range.elapsed_us():.3f}" if after
           else "not found"))


def main_path_phase(torch):
    """The flagship resident round on the card: cold + 3 churned warm."""
    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.resident import ResidentSolver
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    clusters = [config2_quincy_flagship(seed=0)]
    for r in (1, 2, 3):
        clusters.append(churn(clusters[-1], r))
    built = [FlowGraphBuilder().build_arrays(c) for c in clusters]
    solver = ResidentSolver(device="cuda", small_to_oracle=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    per_round = []
    for cluster, (arrays, meta) in zip(clusters, built):
        before = {k.name: k.launches for k in kernels.KERNELS}
        t0 = time.perf_counter()
        out = solver.run_round(arrays, meta, cost_model="quincy",
                               cost_input_kwargs=cost_kwargs(cluster))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k.name: k.launches - before[k.name]
                    for k in kernels.KERNELS}
        per_round.append((cluster, out, wall, launched,
                          solver.last_round_fetches,
                          solver.last_round_loop_syncs))
    launches = {k.name: k.launches for k in kernels.KERNELS}
    profile_round(torch, solver, churn(clusters[-1], 4))
    for r, (cluster, out, wall, launched, fetches, syncs) in enumerate(per_round):
        want, oracle_ms = oracle_cost(cluster, torch.device("cuda"))
        log(f"[main] round {r} ({'cold' if r == 0 else 'warm'}): "
            f"tasks={len(out.assignment)} wall_ms={wall:.3f} "
            f"prep_ms={out.timings['prep_ms']:.3f} "
            f"upload_ms={out.timings['upload_ms']:.3f} "
            f"solve_ms={out.timings['solve_ms']:.3f} "
            f"backend={out.backend} converged={out.converged} "
            f"rounds={out.rounds} phases={out.phases} loop_syncs={syncs} "
            f"fetches={fetches} cost={out.cost} oracle_cost={want} "
            f"oracle_ms={oracle_ms:.1f} launches={launched}")
        if out.backend != "dense_auction" or not out.converged:
            raise AssertionError(f"round {r}: backend {out.backend}")
        if out.cost != want:
            raise AssertionError(f"round {r}: cost {out.cost} != oracle {want}")
        if fetches != 1:
            raise AssertionError(f"round {r}: {fetches} result fetches")
        idle = [n for n, c in launched.items() if c == 0]
        if idle:
            raise AssertionError(f"round {r}: kernels not launched: {idle}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import poseidon_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    from poseidon_tpu_torch.kernels import loader
    from poseidon_tpu_torch.oracle import oracle

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = loader.build_all()
    oracle.ensure_built()
    log(f"[build] kernels {report.seconds:.2f} s (parallel nvcc), "
        f"kernels + oracle {time.perf_counter() - t0:.2f} s")
    for src, text in report.ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    records = kernel_phase(torch, Timer(torch))
    parity_phase()
    launches = main_path_phase(torch)

    out = {"kernels": [
        {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        }
        for k, err, ms, plain, bms, by, _shape in records
    ]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
