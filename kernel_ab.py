#!/usr/bin/env python3
"""Time the hand kernels (K1 ``densify``, K2 ``row_options``, K3
``bid_pass``, K8 ``gap_rows``, K9 ``cs_sweep``, K10 ``bf_relax`` ``out``
and ``in``, K11 ``ssp_augment``, K12 ``top_will``, K13 ``seat_sort``, K6
``perturb``), and the express and stream lanes' windows
(K4 ``express_rows``, K5 ``express_patch``, K7 ``stream_commit`` and
what surrounds them), of one or more checkouts on one GPU, in turns, in
one run.

    python3 kernel_ab.py [--parts=window,kernels,syncs,graph] ROOT [ROOT ...]

``--parts`` names what to measure (``window`` and ``kernels`` by
default): ``sorts`` K13's sorts past the split and the flagship's 4-key
sort alone (``sort_part``), ``window`` the lanes (``window_lanes``: its note says what
each number is), ``kernels`` the rest below, ``syncs`` the flagship's
synchronising calls (``sync_rounds``: a cold and three churned warm
rounds under ``torch.cuda.set_sync_debug_mode("warn")``, each call
counted and split into ``SyncCounter.read`` and the rest, beside the
solver's own counters and the round's wall), ``graph`` the auction
loop's CUDA graph as the checkout builds it (``auction_graph``: one
adversarial trial's dense solve, its graph printed by the driver's
``cuGraphDebugDotPrint`` with addresses and handles masked, so two
checkouts that build the same nodes print the same text).

Each ROOT is the root of a checkout of this repository (for example a
``git archive`` of an older commit unpacked into a directory that
``.gitignore`` lists). Each is measured in its own process, in the order
given, so list them in turns (old, new, new, old) to see the card's
drift. Every process builds its checkout's kernels, makes flagship-shaped
inputs from one seed (Tp = 10240, Mp = 1024, P = 3 preference columns,
bid window B = 2560: the shapes of BASELINE config 2), checks each
kernel against its plain twin (tolerance 0) and prints one JSON line:

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
  not a call the port makes; for K1 ``write_floor_ms``, one ``fill_`` of
  an int32 [Tp, Mp] table (the bytes K1 writes);
- ``warm_ms``: CUDA-event time of 20 back-to-back calls over 20, the
  table left in L2 (the auction loop's case: the 40 MiB table fits in
  the 50 MB L2; for K1 its inputs and output stay there), the card
  again held busy until all 20 are enqueued;
- ``host_us``: host time per wrapper call over 100 calls without a
  synchronise, and ``wall_us`` the same with the one synchronise at the
  end; each the median of 7 such batches, every worker pinned to the
  same CPU core;
- for K1 also ``one_tile_ms`` and ``one_tile_fill_ms``: as ``cold_ms``,
  K1 on the first 4 rows (one tile, one block) and a ``fill_`` of as
  many bytes: the fixed cost of a cold launch, before the bytes count.

K9 and K10 run at the general lane's flagship states, which each
process builds with its own checkout's solvers: BASELINE config 2 priced
by quincy as a general graph (NN 12,290); K9 at the first sweep of the
cost-scaling solve's busiest refine burst (the state after its global
update; ``chip_smoke.py``'s ``[kernels]`` state) and K10 ``out`` at the
first round of that state's next global update; K10 ``in`` at SSP's
first relaxation round. Each calls its checkout's own wrapper (a
checkout whose residual CSR carries a launch plan passes it; an older
one takes none) and is checked against the twin (tolerance 0). K9
updates the flow in place, so its repeated calls sweep on from the
state they leave; every checkout makes the same calls from the same
state, and the kernels agree bit for bit, so each times the same work.
They print ``cold_ms``, ``warm_ms``, ``host_us`` and ``wall_us``.

K11 ``ssp_augment`` runs at SSP's first path over the same flagship
(its converged distances and predecessors): what one path costs between
two relaxation loops. A checkout whose K11 is the path step (a
``PathStep``) makes one step call; an older one makes what its
``ops/ssp.py`` made a path: the walk-and-augment launch, the torch
potential update, the next round's ``mirror_costs`` and its
dist0/pred0. Each timed call first restores the flow, routed and pred
(three ``copy_``), timed alone as ``restore_ms``/``restore_host_us`` and
taken off ``cold_ms`` and ``warm_ms``; ``host_us`` and ``wall_us`` are
the call's with the restore (``restore_host_us`` beside them). Each is
checked against its checkout's own twin (tolerance 0) and prints a
digest of what it wrote (routed, delta, the flow's and the next mirror
costs' sums), which must agree across checkouts. Beside it the launch
floor: ``torch.cuda._sleep(0)`` (an empty kernel), ``cold_ms``,
``warm_ms`` and ``host_us``.

K8 ``gap_rows`` (``gap_rows_10240x1024``, ``gap_rows_524288x256``)
runs at the flagship's table and config 8's aggregated one, made on the
card from a seed, checked against its twin (tolerance 0), with
``cold_ms``, ``cold_dirty_ms``, ``warm_ms``, ``host_us``, ``wall_us``
and ``read_floor_ms``: one ``c.amin()`` over the same table, timed as
``cold_ms`` (a yardstick: no single PyTorch call computes K8's
function).

K12 ``top_will`` and K13 ``seat_sort`` run as the auction loop calls
them (``loop_kernel_calls``): K12's list method and K13's 4-key sort,
3-key sort and compaction on the inputs of their first calls in a
flagship cold solve, each checkout's own solver; K12's radix method at
config 8's shape ([524288, 256], smax 3,072, drawn on the card from a
seed); K13's sorts past the split (``wide_sort_calls``: config 8's
argsort and 4-key sort, the flagship CSR's argsort by tail). Each is checked against its twin (tolerance 0) and prints
``cold_ms``, ``warm_ms``, ``host_us`` and ``wall_us``.

K6 ``perturb`` runs at BASELINE config 5 with 64 variants (Tp 4096, Mp
1024, seed 7, 10 %), each checkout's own instance build, checked against
its twin (tolerance 0); ``write_floor_ms`` is one ``fill_`` of an int32
[64, 4096, 1024] table, timed as ``cold_ms``.

``ssp_solve`` is the whole flagship SSP solve with the checkout's
``solve_ssp`` (the general lane's path through K10 ``in`` and K11):
``wall_ms`` of each of two solves after a warm-up solve, with its
paths, loop reads and cost.

The card's name and power limit come first, from ``nvidia-smi``.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

PARTS = ("window", "kernels", "syncs", "graph", "sorts")
DEFAULT_PARTS = ("window", "kernels")
# K8's shapes: the flagship's table (a width-1 mesh's one shard) and
# config 8's aggregated table
GAP_SHAPES = ((10240, 1024), (524288, 256))
REPEATS = 30
WARM_CALLS = 20
HOST_CALLS = 100
HOST_BATCHES = 7
SLEEP_CYCLES = 1_000_000


def worker(root: str, parts: tuple[str, ...] = DEFAULT_PARTS) -> dict:
    # every worker on the same one core, so host times compare
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".") != here]
    sys.modules.pop("chip_smoke", None)
    import numpy as np
    import torch

    import poseidon_tpu_torch
    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import densify as k1
    from poseidon_tpu_torch.kernels import gap_rows as k8
    from poseidon_tpu_torch.kernels import loader
    from poseidon_tpu_torch.kernels import row_options as k2
    from poseidon_tpu_torch.ops import ssp

    report = loader.build_all()
    regs = {
        src: [ln.strip() for ln in text.splitlines()
              if "registers" in ln or "spill" in ln]
        for src, text in report.ptxas.items()
    }
    out = {"root": root, "package": poseidon_tpu_torch.__file__, "ptxas": regs}
    dev = torch.device("cuda")
    if "syncs" in parts:
        out["syncs"] = sync_rounds(torch)
    if "window" in parts:
        out.update(window_lanes(torch, dev))
    if "graph" in parts:
        out["graph"] = auction_graph(torch)
    if "sorts" in parts:
        out.update(sort_part(torch, dev))
    if "kernels" not in parts:
        return out
    rng = np.random.default_rng(0)
    Tp, Mp, B, P, inf = 10240, 1024, 2560, 3, 2**29
    c = rng.integers(0, 3000, (Tp, Mp))
    c[rng.random((Tp, Mp)) < 0.05] = inf
    p = rng.integers(0, 2000, Mp)
    u = rng.integers(0, 4000, Tp)
    c, p, u = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (c, p, u))
    btask = torch.from_numpy(
        rng.choice(Tp, size=B, replace=False).astype(np.int32)).to(dev)
    bvalid = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    # K1's channel arrays: 7 of 8 machines real (racks of 100), two
    # machine and one rack preference column per task, a few INF costs
    real = Mp - Mp // 8
    rack_of = np.where(np.arange(Mp) < real, np.arange(Mp) // 100, -1)
    slots = np.where(np.arange(Mp) < real, 10, 0)
    pm = np.where(rng.random((Tp, P)) < 0.2, -1, rng.integers(0, real, (Tp, P)))
    pm[:, 2] = -1
    pr = np.full((Tp, P), -1)
    pr[:, 2] = np.where(rng.random(Tp) < 0.3, rng.integers(0, 9, Tp), -1)
    pc = np.where(rng.random((Tp, P)) < 0.05, inf, rng.integers(0, 3000, (Tp, P)))
    a1 = tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
        rng.integers(0, 9000, Tp), rng.integers(0, 9000, Mp),
        rng.integers(0, 9000, Mp), rack_of, slots, pc, pm, pr))
    table = torch.empty((Tp, Mp), dtype=torch.int32, device=dev)
    # (call, its twin, args, yardstick name, yardstick): the yardstick
    # is one PyTorch call that moves the same bytes (a fill_ of c's size;
    # a reduction over all of c, over B contiguous rows of c), timed as
    # cold_ms is
    calls = {
        "densify": (lambda *a: (k1.densify(*a, n_prefs=P),),
                    lambda *a: (k1.densify_plain(*a, n_prefs=P),), a1,
                    "write_floor_ms", lambda: table.fill_(0)),
        "row_options": (k2.row_options, k2.row_options_plain, (c, p),
                        "read_floor_ms", lambda: c.max()),
        "bid_pass": (k3.bid_pass, k3.bid_pass_plain,
                     (c, p, u, btask, bvalid,
                      torch.ones((), dtype=torch.int32, device=dev)),
                     "read_floor_ms", lambda: c[:B].max()),
    }
    for rows, Mp8 in GAP_SHAPES:
        ga = gap_args(torch, dev, rows, Mp8, seed=rows + Mp8)
        calls[f"gap_rows_{rows}x{Mp8}"] = (
            lambda *a: (k8.gap_rows(*a),),
            lambda *a: (k8.gap_rows_plain(*a),), ga,
            "read_floor_ms", lambda c8=ga[0]: c8.amin())
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)

    def cold_time(flush_l2, call) -> float:
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
        return times[len(times) // 2]

    for name, (fn, plain, args, floor_name, floor) in calls.items():
        for g, w in zip(fn(*args), plain(*args)):
            if not torch.equal(g, w):
                raise AssertionError(f"{root}: {name} != its plain twin")
        cold = {
            "cold_ms": cold_time(lambda: flush.max(), lambda: fn(*args)),
            "cold_dirty_ms": cold_time(flush.zero_, lambda: fn(*args)),
            floor_name: cold_time(lambda: flush.max(), floor),
        }
        out[name] = {**cold, **warm_and_host(torch, lambda: fn(*args))}
    # K1's fixed cost: one 4-row tile (one block), and a fill_ of as many
    # bytes, each cold; what a launch costs before its bytes do
    tile = tuple(x[:4] for x in a1[:1]) + a1[1:5] + tuple(x[:4] for x in a1[5:])
    out["densify"]["one_tile_ms"] = cold_time(
        lambda: flush.max(), lambda: k1.densify(*tile, n_prefs=P))
    out["densify"]["one_tile_fill_ms"] = cold_time(
        lambda: flush.max(), lambda: table[:4].fill_(0))
    del table
    net = flagship_net(dev)
    for name, (call, check) in general_calls(torch, dev, net).items():
        if not check():
            raise AssertionError(f"{root}: {name} != its plain twin")
        out[name] = {"cold_ms": cold_time(lambda: flush.max(), call),
                     **warm_and_host(torch, call)}
    call, restore, check, digest = ssp_step_call(torch, dev, net)
    if not check():
        raise AssertionError(f"{root}: ssp_augment != its plain twin")
    cold_r = cold_time(lambda: flush.max(), restore)
    timed = warm_and_host(torch, call)
    rest = warm_and_host(torch, restore)
    out["ssp_augment"] = {
        "cold_ms": cold_time(lambda: flush.max(), call) - cold_r,
        "warm_ms": timed["warm_ms"] - rest["warm_ms"],
        "host_us": timed["host_us"], "wall_us": timed["wall_us"],
        "restore_ms": cold_r, "restore_host_us": rest["host_us"],
        "digest": digest,
    }
    out["launch_floor"] = {
        "cold_ms": cold_time(lambda: flush.max(),
                             lambda: torch.cuda._sleep(0)),
        **warm_and_host(torch, lambda: torch.cuda._sleep(0)),
    }
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ssp.solve_ssp(net, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["ssp_solve"] = {"wall_ms": walls[1:], "paths": res.iterations,
                        "loop_syncs": res.loop_syncs,
                        "cost": ssp.solution_cost(net, res)}
    for name, (call, check) in loop_kernel_calls(torch, dev).items():
        if not check():
            raise AssertionError(f"{root}: {name} != its plain twin")
        out[name] = {"cold_ms": cold_time(lambda: flush.max(), call),
                     **warm_and_host(torch, call)}
    call, check = perturb_call(torch, dev)
    if not check():
        raise AssertionError(f"{root}: perturb != its plain twin")
    big = torch.empty((64, 4096, 1024), dtype=torch.int32, device=dev)
    out["perturb"] = {
        "cold_ms": cold_time(lambda: flush.max(), call),
        **warm_and_host(torch, call),
        "write_floor_ms": cold_time(lambda: flush.max(),
                                    lambda: big.fill_(0)),
    }
    return out


def gap_args(torch, dev, rows: int, Mp: int, seed: int) -> tuple:
    """K8's inputs (c, u, task_valid, s, lam, asg) for one row block,
    made on ``dev`` from a seed: a table with ~5 % INF entries, seats,
    prices, and an ``asg`` that reaches every class (a machine, the
    unscheduled route Mp, -1 and out of range). ``chip_smoke.py``'s K8
    cases start from these too."""
    inf = 2**29
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, dtype=torch.int32, device=dev,
                             generator=g)

    c = ints(0, 2**24, (rows, Mp))
    c.masked_fill_(ints(0, 20, (rows, Mp)) == 0, inf)
    asg = ints(-1, Mp + 1, (rows,))
    asg = torch.where(ints(0, 8, (rows,)) == 0,
                      ints(-5, 2 * Mp + 5, (rows,)), asg)
    return (c, ints(0, 2**25, (rows,)), ints(0, 20, (rows,)) != 0,
            ints(0, 12, (Mp,)), ints(0, 2**22, (Mp,)), asg)


def flagship_net(dev):
    """BASELINE config 2 priced by quincy, as a general graph."""
    import numpy as np

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import build_cost_inputs, quincy_cost
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    cluster = config2_quincy_flagship(seed=0)
    net, meta = FlowGraphBuilder().build(cluster)
    pending = cluster.pending()
    inputs = build_cost_inputs(
        net, meta, device=dev,
        task_cpu_milli=np.array([int(t.cpu_request * 1000) for t in pending],
                                np.int64),
        task_mem_kb=np.array([t.memory_request_kb for t in pending],
                             np.int64))
    return net.with_costs(quincy_cost(inputs))


def mirror_costs(g, pot, flow):
    """K10 ``in``'s mirror costs over ``g`` with this process's checkout:
    a newer one has ``kernels.ssp_augment.mirror_costs_plain``, an older
    one ``ops.ssp.mirror_costs``."""
    from poseidon_tpu_torch.kernels import ssp_augment as k11

    if hasattr(k11, "mirror_costs_plain"):
        return k11.mirror_costs_plain(g.arc, g.head, g.tail, g.cost, g.fcap,
                                      pot, flow)
    from poseidon_tpu_torch.ops import ssp

    return ssp.mirror_costs(g, pot, flow)


def in_parity(torch, dev, k10) -> tuple:
    """K10 ``in``'s parity word (even: read the first buffer of the pair)
    where this process's checkout takes one, else nothing."""
    if "parity" in inspect.signature(k10.bf_relax_in).parameters:
        return (torch.zeros(1, dtype=torch.int32, device=dev),)
    return ()


def folded(k10) -> bool:
    """Whether this process's checkout ends SSP's round in K10 ``in``
    itself (its loop words, ``kernels/ssp_loop.py``)."""
    return "loop" in inspect.signature(k10.bf_relax_in).parameters


def ssp_words(dev, NN: int, wanted: int = 1, max_paths: int = 2):
    """Fresh SSP loop words of a folded checkout (parities 0)."""
    from poseidon_tpu_torch.kernels.ssp_loop import SspLoop

    return SspLoop(dev, wanted, max_paths, NN)


def in_round(torch, dev, k10, g, mrc, da, db, pred, loop=None):
    """One K10 ``in`` round with this process's checkout, reading ``da``
    and writing ``db`` (a folded checkout: by ``loop``'s parity, which
    the round advances; an older one: its ``changed`` flag, returned)."""
    if folded(k10):
        k10.bf_relax_in(g.seg, g.arc, g.head, mrc, da, db, pred, g.plan, loop)
        return None
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    plan = (g.plan,) if hasattr(g, "plan") else ()
    k10.bf_relax_in(g.seg, g.arc, g.head, mrc, da, db, pred, changed, *plan,
                    *in_parity(torch, dev, k10))
    return changed


def ssp_step_call(torch, dev, net):
    """K11 at SSP's first path of the flagship (``net``), with this
    process's checkout: (timed call, its restore, check against the twin,
    digest)."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bf_relax as k10
    from poseidon_tpu_torch.kernels import ssp_augment as k11
    from poseidon_tpu_torch.ops import cost_scaling as cs
    from poseidon_tpu_torch.ops import ssp

    fsrc, fdst, fcap, fcost, S, T = ssp._residual_tables(net)
    F, NN = fsrc.shape[0], net.num_node_slots + 2
    g = cs.residual_csr(fsrc, fdst, fcap, np.concatenate([fcost, -fcost]),
                        NN, dev)
    i32 = torch.int32
    wanted = int(np.maximum(net.supply, 0).sum())
    fsrc_d, fdst_d = (torch.as_tensor(x, device=dev) for x in (fsrc, fdst))
    pot0 = torch.zeros(NN, dtype=i32, device=dev)
    flow0 = torch.zeros(F, dtype=i32, device=dev)
    mrc = mirror_costs(g, pot0, flow0)
    dist = torch.full((NN,), k10.INF, dtype=i32, device=dev)
    dist[S] = 0
    pred = torch.full((NN,), 2 * F, dtype=i32, device=dev)
    d2 = torch.empty_like(dist)
    if folded(k10):
        from poseidon_tpu_torch.kernels.ssp_loop import GO_BF

        words = ssp_words(dev, NN)
        while True:
            even = int(words.words[0]) % 2 == 0
            in_round(torch, dev, k10, g, mrc, dist, d2, pred, words)
            if not int(words.words[GO_BF]):
                break
        if even:
            dist, d2 = d2, dist
    else:
        while True:
            changed = in_round(torch, dev, k10, g, mrc, dist, d2, pred)
            dist, d2 = d2, dist
            if not int(changed[0]):
                break
    state0 = torch.zeros(2, dtype=i32, device=dev)

    if hasattr(k11, "PathStep"):
        # a checkout whose step ends on SSP's loop words takes fresh ones
        # (parities 0); one that reads its parity words on the device
        # takes them (0, 0); an older one keeps the host's d and p
        sig = inspect.signature(k11.PathStep).parameters
        words = "parity" in sig or "loop" in sig

        def make():
            if "loop" in sig:
                par = (ssp_words(dev, NN, wanted, wanted + 1),)
            else:
                par = (torch.zeros(2, dtype=i32, device=dev),) if words else ()
            st = k11.PathStep(g.arc, g.head, g.plan.tail, g.cost, g.fcap,
                              fsrc_d, fdst_d, NN, wanted, S, T, *par)
            st.flow.copy_(flow0)
            st.pred.copy_(pred)
            st.dist[0].copy_(dist)
            return st

        st = make()

        def restore():
            st.flow.copy_(flow0)
            st.state.copy_(state0)
            st.pred.copy_(pred)
            if "loop" in sig:
                st.loop.words.zero_()
            elif not words:
                st.d, st.p = 0, 0

        def call():
            restore()
            k11.ssp_augment(st)

        def outputs(step_fn):
            s1 = make()
            step_fn(s1)
            return [s1.flow, s1.state, s1.mrc, s1.pred, *s1.dist, *s1.pot]

        def check():
            return all(torch.equal(x, y) for x, y in zip(
                outputs(k11.ssp_augment), outputs(k11.ssp_step_plain)))

        def digest():
            call()
            torch.cuda.synchronize()
            return [*st.state.tolist(), int(st.flow.sum()),
                    int(st.mrc.long().sum())]
    else:
        flow, state, pr = flow0.clone(), state0.clone(), pred.clone()
        res = {}

        def restore():
            flow.copy_(flow0)
            state.copy_(state0)
            pr.copy_(pred)

        def step(augment, fl, stt):
            # what the older ops/ssp.py ran between two relaxation loops
            augment(pr, dist, fsrc_d, fdst_d, g.fcap, fl, stt, wanted, S, T)
            pot = pot0 + torch.where(dist < k10.INF, dist, 0)
            res["mrc"] = mirror_costs(g, pot, fl)
            nd = torch.full((NN,), k10.INF, dtype=i32, device=dev)
            nd[S] = 0
            res["pred"] = torch.full((NN,), 2 * F, dtype=i32, device=dev)
            return [fl, stt, res["mrc"], res["pred"], nd, pot]

        def call():
            restore()
            step(k11.ssp_augment, flow, state)

        def check():
            a = step(k11.ssp_augment, flow0.clone(), state0.clone())
            b = step(k11.ssp_augment_plain, flow0.clone(), state0.clone())
            return all(torch.equal(x, y) for x, y in zip(a, b))

        def digest():
            call()
            torch.cuda.synchronize()
            return [*state.tolist(), int(flow.sum()),
                    int(res["mrc"].long().sum())]

    return call, restore, check, digest()


# config 8's aggregated table (524,288 tasks x 256 classes) and a deflate
# smax of its order: K12's radix method
RADIX_SHAPE = (524288, 256, 3072)
# the flagship's residual CSR: arcs (2F) and nodes (NN)
CSR_SHAPE = (145410, 12290)


def radix_inputs(torch, dev):
    """K12's arguments at config 8's shape (RADIX_SHAPE), drawn on the card
    from a seed: ([table part], s, smax)."""
    rows, Mp, kr = RADIX_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(8)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    a1 = ints(0, 6000, (rows,))
    return ([(ints(0, 5000, (rows, Mp)), a1, a1 + ints(0, 500, (rows,)),
              ints(0, Mp, (rows,)), ints(0, 10, (rows,)) < 9)],
            ints(0, kr + 3, (Mp,)), kr)


def wide_sort_calls(torch, dev) -> dict:
    """K13's sorts past the split, (call, check) by name, on keys drawn
    from one seed (every checkout gets the same): ``seat_order_config8``,
    config 8's clearing argsort of Tp 524,288 tasks by (-y, task);
    ``seat_order_csr``, the flagship residual CSR's argsort of its 2F
    145,410 arcs by tail (NN 12,290); ``seat_sort4_config8``, config 8's
    4-key auction sort (segment over Mp + 3 = 259, negated level, is_bid,
    task id). Each check holds the call against its twin (tolerance 0);
    the third member is the library's stable sort of the same keys (of
    the packed keys for the 4-key sort)."""
    import numpy as np

    import chip_smoke
    from poseidon_tpu_torch.kernels import seat_sort as k13

    rng = np.random.default_rng(22)
    Tp, Mp, _k = RADIX_SHAPE
    arcs, nodes = CSR_SHAPE

    def on(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)

    y = on(-rng.integers(-2**29, 2**29, Tp))
    tails = on(np.sort(rng.integers(0, nodes, arcs))[rng.permutation(arcs)])
    keys4 = tuple(on(c) for c in (
        rng.integers(0, Mp + 3, Tp), -rng.integers(0, 2**29, Tp),
        rng.integers(0, 2, Tp), rng.permutation(Tp)))
    spans4 = ((0, Mp + 2), k13.INT32, (0, 1), (0, Tp - 1))

    def order_check(key, span):
        got = k13.seat_order(key, span)
        want = torch.sort(key, stable=True)
        return (torch.equal(got[0], want.values)
                and torch.equal(got[1].long(), want.indices))

    packed4 = chip_smoke.packed_keys(torch, keys4, spans4)
    return {
        "seat_order_config8": (lambda: k13.seat_order(y, k13.INT32),
                               lambda: order_check(y, k13.INT32),
                               lambda: torch.sort(y, stable=True)),
        "seat_order_csr": (lambda: k13.seat_order(tails, (0, nodes - 1)),
                           lambda: order_check(tails, (0, nodes - 1)),
                           lambda: torch.sort(tails, stable=True)),
        "seat_sort4_config8": (
            lambda: k13.seat_sort(keys4, spans4),
            lambda: all(torch.equal(a, b) for a, b in zip(
                k13.seat_sort(keys4, spans4), k13.seat_sort_plain(*keys4))),
            lambda: torch.sort(packed4, stable=True)),
    }


def sort_part(torch, dev) -> dict:
    """``--parts=sorts``: K13's sorts past the split (``wide_sort_calls``)
    and the flagship's 4-key sort, each checked, then ``cold_ms`` (L2
    flushed by a 128 MiB read, the card held busy until the call is
    enqueued, median of REPEATS) and ``warm_and_host``; beside each the
    library's stable sort of the same keys (``torch.sort``), cold; and
    K12's radix method at config 8's shape beside ``torch.topk`` of the
    transposed will table."""
    import chip_smoke
    from poseidon_tpu_torch.kernels import seat_sort as k13
    from poseidon_tpu_torch.kernels import top_will as k12
    from poseidon_tpu_torch.ops.resident import _redensify

    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)

    def cold(call) -> float:
        call()
        times = []
        for _ in range(REPEATS):
            flush.max()
            torch.cuda._sleep(SLEEP_CYCLES)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    calls = wide_sort_calls(torch, dev)
    dt, cost, smax = chip_smoke.flagship_inputs(torch, dev)
    inst = _redensify(dt, cost, n_prefs=dt.pref_machine.shape[1],
                      smax=smax)[0]
    keys4, spans4 = chip_smoke.loop_calls(torch, inst, smax)["sort4"]
    packed4 = chip_smoke.packed_keys(torch, keys4, spans4)
    calls["seat_sort4"] = (
        lambda: k13.seat_sort(keys4, spans4),
        lambda: all(torch.equal(a, b) for a, b in zip(
            k13.seat_sort(keys4, spans4), k13.seat_sort_plain(*keys4))),
        lambda: torch.sort(packed4, stable=True))
    # K12's radix method at config 8's shape, beside torch.topk of the
    # transposed will table (made outside the timing)
    radix = radix_inputs(torch, dev)
    will_t = chip_smoke.will_table_t(torch, radix[0][0])
    calls["top_will_radix"] = (
        lambda: k12.top_will(*radix),
        lambda: all(torch.equal(a, b) for a, b in zip(
            *((x if isinstance(x, tuple) else (x,)) for x in (
                k12.top_will(*radix), k12.top_will_plain(*radix))))),
        lambda: torch.topk(will_t, radix[2], dim=1))
    out = {}
    for name, (call, check, lib) in calls.items():
        if not check():
            raise AssertionError(f"{name} != its twin")
        out[name] = {"cold_ms": cold(call), **warm_and_host(torch, call),
                     "library_cold_ms": cold(lib)}
    return out


def loop_kernel_calls(torch, dev) -> dict:
    """K12 and K13 as the auction loop calls them: (call, check) by name.
    ``top_will`` (K12's list method), ``seat_sort4``, ``seat_sort3`` and
    ``seat_compact`` (K13) on the inputs of their first calls in a
    flagship cold solve (``chip_smoke.loop_calls``, the checkout's own
    solver: every checkout solves bit for bit alike, so all get the same
    inputs); ``top_will_radix`` at config 8's shape (RADIX_SHAPE), its
    table drawn on the card from a seed. Each check holds the call
    against its twin (tolerance 0)."""
    import chip_smoke
    from poseidon_tpu_torch.kernels import seat_sort as k13
    from poseidon_tpu_torch.kernels import top_will as k12
    from poseidon_tpu_torch.ops.resident import _redensify

    dt, cost, smax = chip_smoke.flagship_inputs(torch, dev)
    inst = _redensify(dt, cost, n_prefs=dt.pref_machine.shape[1],
                      smax=smax)[0]
    got = chip_smoke.loop_calls(torch, inst, smax)
    parts, s, k = got["top_will"]
    keys4, spans4 = got["sort4"]
    keys3, spans3 = got["sort3"]
    waiting, B = got["compact"]
    radix = radix_inputs(torch, dev)

    def same(a, b):
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    return {
        **{name: c[:2] for name, c in wide_sort_calls(torch, dev).items()},
        "top_will": (lambda: k12.top_will(parts, s, k),
                     lambda: same(k12.top_will(parts, s, k),
                                  k12.top_will_plain(parts, s, k))),
        "top_will_radix": (lambda: k12.top_will(*radix),
                           lambda: same(k12.top_will(*radix),
                                        k12.top_will_plain(*radix))),
        "seat_sort4": (lambda: k13.seat_sort(keys4, spans4),
                       lambda: same(k13.seat_sort(keys4, spans4),
                                    k13.seat_sort_plain(*keys4))),
        "seat_sort3": (lambda: k13.seat_sort(keys3, spans3),
                       lambda: same(k13.seat_sort(keys3, spans3),
                                    k13.seat_sort_plain(*keys3))),
        "seat_compact": (lambda: k13.seat_compact(waiting, B),
                         lambda: same(k13.seat_compact(waiting, B),
                                      k13.seat_compact_plain(waiting, B))),
    }


def perturb_call(torch, dev):
    """K6 at BASELINE config 5, 64 variants, with this process's
    checkout: (timed call, check against the twin)."""
    import numpy as np

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.network import pad_bucket
    from poseidon_tpu_torch.kernels import perturb as k6
    from poseidon_tpu_torch.models.costs import (
        build_cost_inputs_host, quincy_cost,
    )
    from poseidon_tpu_torch.ops.dense_auction import build_dense_instance
    from poseidon_tpu_torch.ops.transport import (
        extract_topology, instance_from_topology,
    )
    from poseidon_tpu_torch.synth import config5_whatif

    cluster = config5_whatif(seed=0)
    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    pending = cluster.pending()
    inputs = build_cost_inputs_host(
        pad_bucket(meta.n_arcs), meta,
        task_cpu_milli=np.array([int(t.cpu_request * 1000) for t in pending],
                                np.int64),
        task_mem_kb=np.array([t.memory_request_kb for t in pending],
                             np.int64)).to_device(dev)
    cost = quincy_cost(inputs).cpu().numpy().astype(np.int32)[: meta.n_arcs]
    topo = extract_topology(meta, arrays["src"], arrays["dst"], arrays["cap"])
    d = build_dense_instance(instance_from_topology(topo, cost), dev)
    args = (d.c, d.u, d.w, d.dgen, d.s, 64, d.scale, 7, 10)

    def check():
        got, want = k6.perturb(*args), k6.perturb_plain(*args)
        return all(torch.equal(x, y) for x, y in zip(got, want))

    return lambda: k6.perturb(*args), check


def warm_and_host(torch, call) -> dict:
    """``warm_ms``, ``host_us`` and ``wall_us`` of ``call`` (the module
    note says how)."""
    call()
    torch.cuda._sleep(SLEEP_CYCLES * WARM_CALLS)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(WARM_CALLS):
        call()
    b.record()
    b.synchronize()
    host, wall = [], []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / HOST_CALLS * 1e6)
        wall.append((t2 - t0) / HOST_CALLS * 1e6)
    return {"warm_ms": a.elapsed_time(b) / WARM_CALLS,
            "host_us": sorted(host)[HOST_BATCHES // 2],
            "wall_us": sorted(wall)[HOST_BATCHES // 2]}


def general_calls(torch, dev, net) -> dict:
    """K9 and K10 at the flagship's general-lane states (``net``, the
    flagship priced by quincy), built with this process's checkout:
    name -> (timed call, check against the twin)."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bf_relax as k10
    from poseidon_tpu_torch.kernels import cs_sweep as k9
    from poseidon_tpu_torch.ops import cost_scaling as cs
    from poseidon_tpu_torch.ops import ssp

    fuse = 200 * (net.num_node_slots.bit_length() + 8) * 8
    # a checkout whose solve keeps eps on the device splits the global
    # update into bodies (bf_init, bf_burst, update) and runs its host
    # loop on request; an older one has global_update(eps)
    bodies = not hasattr(cs._Solve, "global_update")

    class Sampled(cs._Solve):
        """The solve, keeping the state at the start of the refine burst
        whose active nodes hold the most positions."""
        best = (-1, None)

        def sample(self, eps: int) -> None:
            act = self.excess > 0
            deg = (self.g.seg[1:] - self.g.seg[:-1]).long()
            load = int(deg[act].sum())
            if load > self.best[0]:
                self.best = (load, (self.flow.clone(), self.excess.clone(),
                                    self.price.clone(), eps))

        if bodies:
            def bf_init(self) -> None:
                self.sample(int(self.eps))
                super().bf_init()
        else:
            def global_update(self, eps: int) -> None:
                self.sample(eps)
                super().global_update(eps)

    sampled = Sampled(net, dev, 8, fuse, 16)
    sampled.run(host_loop=True) if bodies else sampled.run()
    flow, excess, price, eps = sampled.best[1]
    s = cs._Solve(net, dev, 8, fuse, 16)
    s.flow.copy_(flow)
    s.excess.copy_(excess)
    s.price.copy_(price)
    if bodies:
        s.eps.fill_(eps)
        s.bf_init()
        it = 0
        while True:
            s.bf_burst()
            it += 8
            if not (int(s.changed[0]) and it < s.NN):
                break
        s.update()
    else:
        s.global_update(eps)
    g = s.g
    plan = (g.plan,) if hasattr(g, "plan") else ()

    # a checkout whose solve keeps eps on the device passes it there
    eps_arg = torch.tensor(eps, dtype=torch.int64, device=dev) if bodies \
        else eps

    def sweep_args(fl):
        return (g.seg, g.arc, g.head, g.cost, g.fcap, fl, s.excess, s.price,
                eps_arg, torch.empty_like(s.excess),
                torch.empty_like(s.price))

    def check_sweep():
        a, b = sweep_args(s.flow.clone()), sweep_args(s.flow.clone())
        k9.cs_sweep(*a, *plan)
        k9.cs_sweep_plain(*b)
        return all(torch.equal(x, y) for x, y in
                   zip((a[5], a[9], a[10]), (b[5], b[9], b[10])))

    timed_flow = s.flow.clone()
    sweep_call = sweep_args(timed_flow)
    ln = cs.arc_lengths(g, s.flow, s.price, eps)
    d = torch.where(s.excess < 0, 0, k10.INF_K).to(torch.int64)

    def out_args():
        return (g.seg, g.head, ln, d, torch.empty_like(d),
                torch.zeros(1, dtype=torch.int32, device=dev))

    def check_out():
        a, b = out_args(), out_args()
        k10.bf_relax_out(*a, *plan)
        k10.bf_relax_out_plain(*b)
        return torch.equal(a[4], b[4]) and torch.equal(a[5], b[5])

    out_call = out_args()
    fsrc, fdst, fcap, fcost, S, T = ssp._residual_tables(net)
    F, NN = fsrc.shape[0], net.num_node_slots + 2
    g2 = cs.residual_csr(fsrc, fdst, fcap, np.concatenate([fcost, -fcost]),
                         NN, dev)
    plan2 = (g2.plan,) if hasattr(g2, "plan") else ()
    mrc = mirror_costs(g2, torch.zeros(NN, dtype=torch.int32, device=dev),
                       torch.zeros(F, dtype=torch.int32, device=dev))
    dist = torch.full((NN,), k10.INF, dtype=torch.int32, device=dev)
    dist[S] = 0

    if folded(k10):
        # the round and its end, as SSP's graph runs it; the timed calls
        # alternate the pair by the parity the round advances
        def in_args():
            return (g2.seg, g2.arc, g2.head, mrc, dist.clone(),
                    torch.empty_like(dist),
                    torch.full((NN,), 2 * F, dtype=torch.int32, device=dev))

        def check_in():
            a, b = in_args(), in_args()
            la, lb = ssp_words(dev, NN), ssp_words(dev, NN)
            k10.bf_relax_in(*a, g2.plan, la)
            k10.bf_relax_in_plain(*b, lb)
            return all(torch.equal(x, y) for x, y in zip(
                (*a[4:], la.words, la.tally), (*b[4:], lb.words, lb.tally)))

        in_call, in_loop = in_args(), ssp_words(dev, NN)
        in_timed = (lambda: k10.bf_relax_in(*in_call, g2.plan, in_loop))
    else:
        def in_args():
            return (g2.seg, g2.arc, g2.head, mrc, dist, torch.empty_like(dist),
                    torch.full((NN,), 2 * F, dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))

        par = in_parity(torch, dev, k10)

        def check_in():
            a, b = in_args(), in_args()
            k10.bf_relax_in(*a, *plan2, *par)
            k10.bf_relax_in_plain(*b)
            return all(torch.equal(x, y) for x, y in zip(a[5:], b[5:]))

        in_call = in_args()
        in_timed = (lambda: k10.bf_relax_in(*in_call, *plan2, *par))
    return {
        "cs_sweep": (lambda: k9.cs_sweep(*sweep_call, *plan), check_sweep),
        "bf_relax_out": (lambda: k10.bf_relax_out(*out_call, *plan),
                         check_out),
        "bf_relax_in": (in_timed, check_in),
    }


# ---- the express and stream lanes: what a window costs around _solve ----

SOLVE_SPAN = "kernel_ab:_solve"
WINDOW_SYMBOLS = ("express_rows", "express_patch", "stream_commit")
FLUSHES = 5


class SolveMarks:
    """While active, every ``_solve`` call of ``resident`` (the eps=1
    repair both lanes run a window) runs inside a profiler span named
    ``SOLVE_SPAN`` and adds its host seconds to ``solve_s``; calls of
    ``_stream_chain`` and ``_express_step`` add theirs to ``chain_s`` and
    ``step_s``. Every checkout has these three module functions."""

    def __init__(self, torch, resident):
        self.torch, self.mod = torch, resident
        self.solve_s = self.chain_s = self.step_s = 0.0

    def _wrap(self, name, attr, span=None):
        inner = getattr(self.mod, name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            if span is None:
                out = inner(*a, **kw)
            else:
                with self.torch.profiler.record_function(span):
                    out = inner(*a, **kw)
            setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)
            return out

        return inner, call

    def __enter__(self):
        self.saved = {}
        for name, attr, span in (("_solve", "solve_s", SOLVE_SPAN),
                                 ("_stream_chain", "chain_s", None),
                                 ("_express_step", "step_s", None)):
            self.saved[name], call = self._wrap(name, attr, span)
            setattr(self.mod, name, call)
        return self

    def __exit__(self, *exc):
        for name, inner in self.saved.items():
            setattr(self.mod, name, inner)

    def reset(self):
        self.solve_s = self.chain_s = self.step_s = 0.0


class InlineFetch:
    """Stands in for ``resident._AsyncFetch`` in a profiled flush: runs
    the stream batch on the calling thread, whose spans the profiler
    records (it does not follow the solver's worker thread)."""

    def __init__(self, fn):
        self._value = fn()

    def result(self, timeout_s=None):
        return self._value


def window_profile(prof, wall_us: float) -> dict:
    """One profiled call of a lane: device kernels in all and those
    launched outside every ``SOLVE_SPAN`` (a kernel's launch time is its
    runtime call's, matched by correlation id; ``unlinked`` counts the
    device events without one, placed by their device start), the device
    time of everything launched outside them (copies and sets too),
    copies and sets (``memcpy``/``memset``), device busy and idle share,
    and each window kernel's device time a launch by its CUDA symbol."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in cpu
             if e.name == SOLVE_SPAN]
    runtime = {e.id: e.time_range.start for e in cpu
               if e.name.startswith("cu")}
    # the device timeline also holds each span as an annotation
    dev_evs = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.name != SOLVE_SPAN
               and not getattr(e, "is_user_annotation", False)]
    def copy(e):
        return "memcpy" in e.name.lower() or "memset" in e.name.lower()

    kernels = [e for e in dev_evs if not copy(e)]
    outside = unlinked = 0
    outside_us = 0.0
    for e in dev_evs:
        t = runtime.get(e.id)
        if t is None:
            unlinked += 1
            t = e.time_range.start
        if not any(a <= t <= b for a, b in spans):
            outside += not copy(e)
            outside_us += e.time_range.end - e.time_range.start
    busy = sum(e.time_range.end - e.time_range.start for e in dev_evs)
    per = {}
    for sym in WINDOW_SYMBOLS:
        hits = [e for e in kernels if sym in e.name]
        total = sum(e.time_range.end - e.time_range.start for e in hits)
        per[sym] = {"launches": len(hits),
                    "us_per_launch": total / max(len(hits), 1)}
    return {"kernels": len(kernels), "kernels_outside_solve": outside,
            "device_us_outside_solve": outside_us, "unlinked": unlinked,
            "copies": len(dev_evs) - len(kernels),
            "solve_spans": len(spans), "wall_us": wall_us,
            "device_busy_us": busy,
            "idle_share": 1 - min(busy / max(wall_us, 1e-9), 1),
            "as_called": per}


def lane_events(bridge, rng, tag: str, sizes, completions: int = 2):
    """Windows of watch events drawn from one snapshot of ``bridge``:
    ``sizes[w]`` seeded arrivals with one machine (free seat) or rack
    preference each, and ``completions`` running pods that finish, none
    twice (``chip_smoke.py``'s ``[express]``/``[stream]`` schedule)."""
    from poseidon_tpu_torch.cluster import Task, TaskPhase

    used = {}
    for t in bridge.tasks.values():
        if t.phase == TaskPhase.RUNNING:
            used[t.machine] = used.get(t.machine, 0) + 1
    free = sorted(m.name for m in bridge.machines.values()
                  if used.get(m.name, 0) + 2 < m.max_tasks)
    racks = sorted({m.rack for m in bridge.machines.values()})
    running = sorted(u for u, t in bridge.tasks.items()
                     if t.phase == TaskPhase.RUNNING)
    victims = [running[int(i)] for i in rng.choice(
        len(running), size=completions * len(sizes), replace=False)]
    out = []
    for w, n in enumerate(sizes):
        ev = []
        for k in range(n):
            if rng.random() < 0.3:
                prefs = {racks[int(rng.integers(len(racks)))]:
                         int(rng.integers(10, 100))}
            else:
                prefs = {free[int(rng.integers(len(free)))]:
                         int(rng.integers(20, 200))}
            ev.append(("ADDED", Task(
                uid=f"ab-{tag}-{w}-{k:03d}", job=f"job-ab-{tag}-{w}",
                cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
                memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
                data_prefs=prefs)))
        for u in victims[w * completions: (w + 1) * completions]:
            ev.append(("DELETED", bridge.tasks[u]))
        out.append(ev)
    return out


def window_lanes(torch, dev, K: int = 8, n: int = 16) -> dict:
    """The stream lane (flushes of K windows of n arrivals and 2
    completions) and the synced express lane (batches of the same shape)
    on bridges over the flagship (config 2, quincy), each behind one
    certified round: after a warm-up flush and batch, ``FLUSHES`` timed
    ones, then one profiled (``window_profile``; the flush on the calling
    thread, ``InlineFetch``). ``flush_ms``: host
    clock from ``stream_flush`` to ``stream_finish``'s return;
    ``window_host_us``: ``_stream_chain``'s host time less its
    ``_solve`` calls', a window; ``e2b_p50_ms``/``e2b_p99_ms``: the
    flush's placements' event-to-bind (from each window's accumulate to
    the finish); ``batch_ms``: ``express_batch``'s wall,
    ``solve_ms`` its own timing; ``step_host_us``: ``_express_step``'s
    host time less its ``_solve``'s; ``launches``: the wrappers'
    counts a flush or batch. Every checkout sees the same events."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.bridge import SchedulerBridge
    from poseidon_tpu_torch.ops import resident
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    cluster = config2_quincy_flagship(seed=0)

    def bridge(windows):
        b = SchedulerBridge(cost_model="quincy", small_to_oracle=False,
                            express_lane=True, device=str(dev),
                            stream_windows=windows)
        b.observe_nodes(list(cluster.machines))
        b.observe_pods(list(cluster.tasks))
        for uid, m in b.run_scheduler().bindings.items():
            b.confirm_binding(uid, m)
        return b

    def counts():
        return {k.name: k.launches for k in kernels.KERNELS}

    def delta(c0):
        return {k: v - c0[k] for k, v in counts().items() if v != c0[k]}

    out = {}
    rng = np.random.default_rng(2024)
    sb = bridge(K)
    async_fetch = resident._AsyncFetch
    rows = {"flush_ms": [], "window_host_us": [], "placed": [],
            "e2b_p50_ms": [], "e2b_p99_ms": []}
    with SolveMarks(torch, resident) as marks:
        for f in range(FLUSHES + 2):
            windows = lane_events(sb, rng, f"s{f}", [n] * K)
            n_e2b = len(sb._express_e2b)
            for ev in windows:
                sb.stream_window(ev, t_event=time.perf_counter())
            marks.reset()
            c0 = counts()
            torch.cuda.synchronize()
            prof = None
            if f == FLUSHES + 1:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                resident._AsyncFetch = InlineFetch
            t0 = time.perf_counter()
            sb.stream_flush()
            r = sb.stream_finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                resident._AsyncFetch = async_fetch
                out["stream_profile"] = window_profile(prof, wall * 1e6)
            if r is None or sb.solver.last_stream_fetches != 1:
                raise AssertionError(f"stream flush {f}: {r}")
            for uid, m in r.bindings.items():
                sb.confirm_binding(uid, m)
            if 0 < f <= FLUSHES:
                rows["flush_ms"].append(wall * 1e3)
                rows["window_host_us"].append(
                    (marks.chain_s - marks.solve_s) / K * 1e6)
                rows["placed"].append(len(r.bindings))
                rows["launches"] = delta(c0)
                # each placement's event-to-bind: from its window's
                # accumulate to the flush's finish
                e2b = sb._express_e2b[n_e2b:]
                rows["e2b_p50_ms"].append(float(np.percentile(e2b, 50)))
                rows["e2b_p99_ms"].append(float(np.percentile(e2b, 99)))
    out["stream"] = rows
    del sb
    xb = bridge(0)
    rows = {"batch_ms": [], "solve_ms": [], "step_host_us": [], "placed": []}
    with SolveMarks(torch, resident) as marks:
        for f in range(FLUSHES + 2):
            ev = lane_events(xb, rng, f"x{f}", [n])[0]
            marks.reset()
            c0 = counts()
            torch.cuda.synchronize()
            prof = None
            if f == FLUSHES + 1:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            r = xb.express_batch(ev, t_event=t0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                out["express_profile"] = window_profile(prof, wall * 1e6)
            if r is None or xb.solver.last_round_fetches != 1:
                raise AssertionError(f"express batch {f}: {r}")
            for uid, m in r.bindings.items():
                xb.confirm_binding(uid, m)
            if 0 < f <= FLUSHES:
                rows["batch_ms"].append(wall * 1e3)
                rows["solve_ms"].append(r.timings.get("solve_ms", 0.0))
                rows["step_host_us"].append(
                    (marks.step_s - marks.solve_s) * 1e6)
                rows["placed"].append(len(r.bindings))
                rows["launches"] = delta(c0)
    out["express"] = rows
    return out


def own_driver():
    """The CUDA driver from this script's own checkout's loader (an older
    checkout's has no ``driver``); it is the same library for every
    one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kernel_ab_loader", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "poseidon_tpu_torch", "kernels", "loader.py"))
    own = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own.driver()


def graph_text(graph) -> str:
    """A graph's text from the driver's ``cuGraphDebugDotPrint`` (verbose,
    child and conditional bodies included) with what differs between two
    builds of the same nodes masked: hexadecimal addresses, numbers of 7
    or more digits (node ids, handles), the graphs' numbers (their order
    of creation) and the per-file hashes in the kernels' mangled
    names."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        err = own_driver().cuGraphDebugDotPrint(graph, path.encode(), 1)
        if err:
            raise RuntimeError(f"cuGraphDebugDotPrint: CUresult {err}")
        with open(path) as f:
            text = f.read()
    for pattern, mask in ((r"0x[0-9a-fA-F]+", "0x_"), (r"\b\d{7,}\b", "N"),
                          (r"\b(graph|cluster)_\d+", r"\1_X"),
                          (r"(_GLOBAL__N__|_cu_)[0-9a-f]{8}", r"\1H")):
        text = re.sub(pattern, mask, text)
    return text


def auction_graph(torch, trial: int = 8) -> dict:
    """The auction loop's graph of adversarial trial ``trial`` (8: coco,
    34 machines x 128 tasks, converged after thousands of rounds, every
    branch taken), as this process's checkout builds it: the trial's
    outcome and the graph's masked text (``graph_text``). ``sha256`` is
    that text's digest; ``sha256_k14`` the digest once K14's mangled name
    (its argument list) is cut to ``loop_ctl_kernel`` too; ``nodes``
    counts the nodes by kind. Also SSP's graph (``ssp_graph``)."""
    import collections
    import hashlib
    import re

    from poseidon_tpu_torch import adversarial
    from poseidon_tpu_torch.ops import dense_auction as da

    (job,) = [j for j in adversarial.trial_inputs(trial + 1) if j[0] == trial]
    rec = adversarial.run_trial(*job, "cuda")
    torch.cuda.synchronize()
    (entry,) = list(da._graphs.values())
    text = graph_text(entry.graph._graph)
    k14 = re.sub(r"_ZN\w*loop_ctl_kernel\w*", "loop_ctl_kernel", text)
    kinds = collections.Counter(re.findall(r'label="\{(\w+)', text))
    return {"trial": trial, "rounds": rec.rounds, "cost": rec.cost,
            "converged": rec.converged, "nodes": dict(kinds),
            "sha256": hashlib.sha256(text.encode()).hexdigest(),
            "sha256_k14": hashlib.sha256(k14.encode()).hexdigest(),
            "dot": text, "ssp": ssp_graph(torch)}


# the kernels SSP's graph may hold, by a part of their (mangled) names
SSP_KERNELS = ("loop_ctl_kernel", "bf_in_kernel", "ssp_walk_kernel",
               "ssp_wide_kernel", "elementwise_kernel", "fill")


def ssp_graph(torch, paths: int = 3) -> dict:
    """SSP's graph as this process's checkout builds it for the flagship
    (BASELINE config 2 priced by quincy, ``paths`` paths), printed as
    ``graph_text`` just before the solve destroys it, and its nodes
    (``ssp_graph_nodes``)."""
    from poseidon_tpu_torch.kernels import loop_graph
    from poseidon_tpu_torch.ops import ssp

    texts = []
    close = loop_graph.ControlGraph.close

    def dump_then_close(self):
        if self._graph is not None:
            texts.append(graph_text(self._graph))
        close(self)

    loop_graph.ControlGraph.close = dump_then_close
    try:
        res = ssp.solve_ssp(flagship_net(torch.device("cuda")),
                            max_paths=paths, device="cuda")
    finally:
        loop_graph.ControlGraph.close = close
    (text,) = texts
    summary = ssp_graph_nodes(text)
    return {"paths": res.iterations, **summary, "dot": text}


def ssp_graph_nodes(text: str) -> dict:
    """From SSP's graph text: its nodes by kind, its kernel nodes by
    kernel (``SSP_KERNELS``, a node's function is on the line after its
    kind), and the nodes of each subgraph that holds K10 ``in`` (the
    captured round body and the WHILE body around it), by kind and
    kernel."""
    import collections
    import re

    def nodes(lines):
        out = []
        for i, ln in enumerate(lines):
            kind = re.search(r'label="\{(\w+)', ln)
            if kind:
                fn = lines[i + 1] if i + 1 < len(lines) else ""
                out.append((kind.group(1),
                            next((k for k in SSP_KERNELS if k in fn), None)))
        return out

    def summary(ns):
        return {"kinds": dict(collections.Counter(k for k, _ in ns)),
                "kernels": dict(collections.Counter(f for _, f in ns if f))}

    lines = text.splitlines()
    stack, bodies = [], []
    for ln in lines:
        if ln.strip().startswith("subgraph"):
            stack.append([])
        elif ln.strip() == "}" and stack:
            done = stack.pop()
            if any("bf_in_kernel" in x for x in done):
                bodies.append(done)
            if stack:
                stack[-1].extend(done)
        elif stack:
            stack[-1].append(ln)
    whole = summary(nodes(lines))
    return {"nodes": whole["kinds"], "kernels": whole["kernels"],
            "round_body": [summary(nodes(b)) for b in bodies[:2]]}


def sync_rounds(torch, rounds: int = 4) -> list[dict]:
    """The flagship (``config2_quincy_flagship(seed=0)``, the checkout's
    own ``chip_smoke.churn`` a warm round) through the checkout's own
    ``ResidentSolver`` on the card: per round the synchronising calls
    the card's sync debug mode reports from every thread, the ones made
    inside ``SyncCounter.read``, the solver's own count (fetches + loop
    reads) and the round's wall ms."""
    import warnings

    from chip_smoke import churn, cost_kwargs
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.resident import ResidentSolver
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    clusters = [config2_quincy_flagship(seed=0)]
    for r in range(1, rounds):
        clusters.append(churn(clusters[-1], r))
    built = [FlowGraphBuilder().build_arrays(c) for c in clusters]
    solver = ResidentSolver(device="cuda", small_to_oracle=False)
    out = []
    for c, (arrays, meta) in zip(clusters, built):
        calls = []

        def show(message, *a, **k):
            if "synchronizing CUDA operation" in str(message):
                f = sys._getframe(1)
                via = False
                while f is not None:
                    if f.f_code.co_filename.endswith("guards.py") and \
                            f.f_code.co_name == "read":
                        via = True
                        break
                    f = f.f_back
                calls.append(via)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                o = solver.run_round(arrays, meta, cost_model="quincy",
                                     cost_input_kwargs=cost_kwargs(c))
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            wall = (time.perf_counter() - t0) * 1e3
        out.append({
            "calls": len(calls), "in_read": sum(calls),
            "counted": solver.last_round_fetches
            + solver.last_round_loop_syncs,
            "rounds": o.rounds, "cost": o.cost, "wall_ms": wall,
        })
    return out


def main(argv: list[str]) -> int:
    parts = DEFAULT_PARTS
    if argv and argv[0].startswith("--parts="):
        parts = tuple(argv.pop(0).split("=", 1)[1].split(","))
        if not set(parts) <= set(PARTS):
            print(f"--parts takes {','.join(PARTS)}", file=sys.stderr)
            return 2
    if len(argv) >= 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1], parts)), flush=True)
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
            [sys.executable, os.path.abspath(__file__),
             f"--parts={','.join(parts)}", "--worker", os.path.abspath(root)],
            cwd=root, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
