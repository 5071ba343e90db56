"""Synthetic cluster generators for the BASELINE benchmark ladder.

The reference publishes no benchmarks (SURVEY.md section 6); the project's
north star is the BASELINE.md config ladder (Trivial 10/100 -> Quincy
1k/10k -> CoCo 1k -> trace replay -> vmap x64). These generators produce
``ClusterState`` instances at those scales with realistic structure: racks
of ~32 machines, multi-task jobs, Zipf-ish data-locality preferences, and
a fraction of already-running tasks occupying slots.
"""

from __future__ import annotations

import numpy as np

from poseidon_tpu_torch.cluster import ClusterState, Machine, Task, TaskPhase


def make_synthetic_cluster(
    n_machines: int,
    n_tasks: int,
    *,
    seed: int = 0,
    machines_per_rack: int = 32,
    max_tasks_per_machine: int = 10,
    prefs_per_task: int = 2,
    tasks_per_job: int = 8,
    running_fraction: float = 0.0,
) -> ClusterState:
    """A synthetic cluster shaped like the BASELINE configs.

    ``running_fraction`` of the tasks are marked RUNNING and bound to a
    machine (consuming slots via the builder's discounting); the rest are
    PENDING and carry ``prefs_per_task`` data-locality preferences drawn
    with rack affinity (a task's preferred machines cluster in one rack,
    like Quincy input-data placement).
    """
    rng = np.random.default_rng(seed)
    n_racks = max(1, (n_machines + machines_per_rack - 1) // machines_per_rack)
    machines = [
        Machine(
            name=f"m{i:05d}",
            rack=f"rack{i % n_racks:03d}",
            cpu_capacity=float(rng.choice([8, 16, 32])),
            cpu_allocatable=float(rng.choice([6, 12, 24])),
            memory_capacity_kb=int(rng.choice([1, 2, 4])) << 24,
            memory_allocatable_kb=int(rng.choice([1, 2, 4])) << 23,
            max_tasks=max_tasks_per_machine,
        )
        for i in range(n_machines)
    ]

    n_running = int(n_tasks * running_fraction)
    tasks: list[Task] = []
    for j in range(n_tasks):
        running = j < n_running
        prefs: dict[str, int] = {}
        if not running and prefs_per_task:
            # rack-affine preferences: most of a task's input lives in one
            # rack, so its preferred machines (and one rack pref) do too
            home = int(rng.integers(0, n_racks))
            in_home = np.flatnonzero(
                np.arange(n_machines) % n_racks == home
            )
            k = min(prefs_per_task, len(in_home))
            for m in rng.choice(in_home, size=k, replace=False):
                prefs[machines[int(m)].name] = int(rng.integers(20, 200))
            if rng.random() < 0.3:
                prefs[f"rack{home:03d}"] = int(rng.integers(10, 100))
        tasks.append(
            Task(
                uid=f"pod-{j:06d}",
                job=f"job-{j // tasks_per_job:05d}",
                cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
                memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
                phase=TaskPhase.RUNNING if running else TaskPhase.PENDING,
                machine=(
                    machines[int(rng.integers(0, n_machines))].name
                    if running else ""
                ),
                data_prefs=prefs,
                wait_rounds=int(rng.integers(0, 4)),
            )
        )
    return ClusterState(machines=machines, tasks=tasks)


# ---- the BASELINE.md ladder ----

def config1_trivial_small(seed: int = 0) -> ClusterState:
    """BASELINE config 1: Trivial model, 10 nodes / 100 pods."""
    return make_synthetic_cluster(10, 100, seed=seed, prefs_per_task=0,
                                  max_tasks_per_machine=12)


def config2_quincy_flagship(seed: int = 0) -> ClusterState:
    """BASELINE config 2: Quincy, 1k nodes / 10k pods (the headline)."""
    return make_synthetic_cluster(1000, 10_000, seed=seed,
                                  prefs_per_task=2)


def config3_coco(seed: int = 0) -> ClusterState:
    """BASELINE config 3: CoCo interference, 1k nodes."""
    return make_synthetic_cluster(1000, 8000, seed=seed, prefs_per_task=1,
                                  running_fraction=0.2)


def config5_whatif(seed: int = 0) -> ClusterState:
    """BASELINE config 5 cluster: Quincy at 1k machines / 4k pods.

    On the config-1 toy, per-variant overhead dominates and serial CPU
    solves win; batched what-if variants pay off where one solve is
    expensive and the lockstep variants amortize it — this is that
    scale.
    """
    return make_synthetic_cluster(1000, 4000, seed=seed, prefs_per_task=2)


def config6_rebalance(
    n_machines: int = 48,
    n_running: int = 120,
    *,
    seed: int = 0,
) -> ClusterState:
    """Config 6: a drifted cluster for the rebalancing bench.

    Every task is already RUNNING, crowded onto the first quarter of
    the machines (the packing a restart-adoption or a long
    arrival-burst leaves behind), while each task's input data lives on
    a machine drawn across the whole cluster. A place-only scheduler is
    stuck with this packing forever; the rebalancing subsystem
    (``--enable_preemption``) migrates tasks toward their data under
    the churn budget until the cluster quiesces.
    """
    rng = np.random.default_rng(seed)
    crowd = max(n_machines // 4, 1)
    slots = -(-n_running // crowd) + 2  # crowded fit + headroom
    machines = [
        Machine(
            name=f"m{i:03d}",
            rack=f"rack{i % 4}",
            cpu_capacity=16.0,
            cpu_allocatable=16.0,
            memory_capacity_kb=1 << 24,
            memory_allocatable_kb=1 << 24,
            max_tasks=slots,
        )
        for i in range(n_machines)
    ]
    tasks = [
        Task(
            uid=f"run-{j:04d}",
            job=f"job-{j // 6}",
            cpu_request=0.25,
            memory_request_kb=1 << 12,
            phase=TaskPhase.RUNNING,
            machine=f"m{j % crowd:03d}",
            data_prefs={
                f"m{int(rng.integers(0, n_machines)):03d}":
                    int(rng.integers(100, 300))
            },
        )
        for j in range(n_running)
    ]
    return ClusterState(machines=machines, tasks=tasks)


def config8_scale(
    n_machines: int = 65_536,
    n_tasks: int = 524_288,
    *,
    seed: int = 0,
    machines_per_rack: int = 512,
    n_skus: int = 2,
    max_tasks_per_machine: int = 10,
) -> ClusterState:
    """Config 8 (scale_ceiling): the cluster the single-chip dense
    table cannot hold — ROADMAP item 1's 64k machines / 512k pods.

    Shaped like a real hyperscale fleet: a small number of hardware
    SKUs (homogeneous machines are the norm at this scale — machine
    diversity shows up as a handful of SKU classes, which is exactly
    what equivalence-class aggregation exploits), big racks, and
    rack-level data preferences (input data is replicated per
    rack/cell, so tasks prefer a rack, not one machine — machine-level
    pins would force singleton classes). Preference weights and
    ``wait_rounds`` are kept small so the quincy cost domain stays
    inside the auction's int32 envelope at T = 512k (the scaled-cost
    bound 2*cmax*(T+1) < 2^27 admits per-arc costs < ~128 there; see
    ops/dense_auction.py's overflow analysis), and capacity has ~25%
    headroom so placed pods do not starve and age past the bound.
    """
    rng = np.random.default_rng(seed)
    n_racks = max(
        1, (n_machines + machines_per_rack - 1) // machines_per_rack
    )
    # SKUs differ in their allocatable/capacity RATIOS (what the
    # knowledge base actually aggregates), so each SKU is a distinct
    # utilization band and classes = racks x SKUs as documented
    skus = [
        (16.0, 12.0, 2 << 24, 1 << 24),   # cpu .75, mem .5
        (32.0, 16.0, 4 << 24, 3 << 24),   # cpu .5,  mem .75
        (8.0, 7.0, 1 << 24, 1 << 23),     # cpu .875, mem .5
        (64.0, 16.0, 8 << 24, 2 << 24),   # cpu .25, mem .25
    ][: max(n_skus, 1)]
    machines = []
    for i in range(n_machines):
        cpu_cap, cpu_alloc, mem_cap, mem_alloc = skus[
            (i // n_racks) % len(skus)
        ]
        machines.append(Machine(
            name=f"m{i:06d}",
            rack=f"rack{i % n_racks:04d}",
            cpu_capacity=cpu_cap,
            cpu_allocatable=cpu_alloc,
            memory_capacity_kb=mem_cap,
            memory_allocatable_kb=mem_alloc,
            max_tasks=max_tasks_per_machine,
        ))
    home = rng.integers(0, n_racks, size=n_tasks)
    weight = rng.integers(1, 4, size=n_tasks)
    tasks = [
        Task(
            uid=f"pod-{j:07d}",
            job=f"job-{j // 16:06d}",
            cpu_request=0.25,
            memory_request_kb=1 << 18,
            data_prefs={f"rack{int(home[j]):04d}": int(weight[j])},
            wait_rounds=0,
        )
        for j in range(n_tasks)
    ]
    return ClusterState(machines=machines, tasks=tasks)


def config8_arrivals(
    n_racks: int,
    n_new: int,
    round_no: int,
    *,
    seed: int = 0,
) -> list[Task]:
    """Per-round arrival burst for the scale_ceiling churn rounds,
    shaped like ``config8_scale``'s pods."""
    rng = np.random.default_rng(seed + round_no)
    home = rng.integers(0, n_racks, size=n_new)
    weight = rng.integers(1, 4, size=n_new)
    return [
        Task(
            uid=f"pod-r{round_no:03d}-{j:06d}",
            job=f"job-r{round_no:03d}-{j // 16:05d}",
            cpu_request=0.25,
            memory_request_kb=1 << 18,
            data_prefs={f"rack{int(home[j]):04d}": int(weight[j])},
            wait_rounds=0,
        )
        for j in range(n_new)
    ]


def config4_trace_replay(
    n_machines: int = 12_000,
    *,
    seed: int = 0,
    arrivals_per_round: int = 500,
    finish_fraction: float = 0.3,
):
    """BASELINE config 4: cluster-trace-style replay (12k machines).

    Returns (machines, round_iter) where round_iter yields per-round
    (new_tasks, finished_uids): a churn stream shaped like cluster-trace
    replays — bursts of arrivals, a fraction of running work finishing
    each round — to drive the bridge's incremental re-solve path. The
    real Google trace is not redistributable; the statistics here (job
    sizes, arrival burstiness) follow its published shape: many small
    jobs, a heavy tail.
    """
    rng = np.random.default_rng(seed)
    base = make_synthetic_cluster(
        n_machines, 0, seed=seed, machines_per_rack=40,
        max_tasks_per_machine=10,
    )
    machines = base.machines

    def rounds():
        counter = 0
        running: list[str] = []
        while True:
            # bursty arrivals: heavy-tailed job sizes
            n_arrive = max(1, int(rng.poisson(arrivals_per_round)))
            new_tasks = []
            while n_arrive > 0:
                job_size = min(int(rng.pareto(1.5)) + 1, 64, n_arrive)
                job = f"tracejob-{counter}"
                for _ in range(job_size):
                    uid = f"tracepod-{counter:07d}"
                    counter += 1
                    prefs = {}
                    if rng.random() < 0.4:
                        m = int(rng.integers(0, n_machines))
                        prefs[machines[m].name] = int(
                            rng.integers(20, 200)
                        )
                    new_tasks.append(
                        Task(
                            uid=uid, job=job,
                            cpu_request=float(
                                rng.choice([0.1, 0.25, 0.5, 1.0])
                            ),
                            memory_request_kb=int(
                                rng.choice([1, 2, 8])
                            ) << 18,
                            data_prefs=prefs,
                        )
                    )
                n_arrive -= job_size
            # a fraction of running work finishes
            n_done = int(len(running) * finish_fraction)
            done = [
                running.pop(int(rng.integers(0, len(running))))
                for _ in range(n_done)
            ]
            running.extend(t.uid for t in new_tasks)
            yield new_tasks, done

    return machines, rounds()
