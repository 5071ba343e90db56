"""The adversarial fuse-exhaustion sweep, on the port.

The counterpart of the reference's ``scripts/adversarial_sweep.py``:
240 trials over the shapes that stress the auction's round fuse — the
six cost models in rotation (``trivial, quincy, coco, wharemap,
octopus, random``) over random clusters of 2-40 machines and 2-150
tasks (``synth.random_cluster``, the reference's draws), heavy
oversubscription included (a 2-machine cluster offers ~20 seats to up
to 150 tasks). Every converged dense solve
(``solve_transport_dense``) must equal the C++ oracle's
(``cost_scaling``) cost; every exhausted one must come out exact
through the front door (``solve_scheduling(..., small_to_oracle=
False)``). The exhausted list is the sweep's finding: a change in it is
a change in the auction's tie and termination behaviour.

Run: ``python -m poseidon_tpu_torch.adversarial [--trials=240]
[--device=cpu] [--workers=N]`` (default: the card, one process). It
prints one JSON line per trial and a summary, and exits 1 when any
trial is wrong.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

SEED = 20260730
MODELS = ("trivial", "quincy", "coco", "wharemap", "octopus", "random")
TRIALS = 240


@dataclasses.dataclass(frozen=True)
class Trial:
    """One trial's record: the dense solve's verdict, the oracle's cost
    and, for an exhausted solve, the front door's cost (else None)."""

    trial: int
    model: str
    M: int
    T: int
    converged: bool
    rounds: int
    cost: int
    oracle_cost: int
    front_cost: int | None
    wall_s: float

    @property
    def wrong(self) -> bool:
        got = self.cost if self.converged else self.front_cost
        return got != self.oracle_cost


def shapes(trials: int = TRIALS):
    """(trial, model, M, T, rng) in the reference's draw order: M and T
    from the sweep's generator, then the cluster's own draws."""
    rng = np.random.default_rng(SEED)
    for trial in range(trials):
        model = MODELS[trial % len(MODELS)]
        M = int(rng.integers(2, 40))
        T = int(rng.integers(2, 150))
        yield trial, model, M, T, rng


def trial_inputs(trials: int = TRIALS) -> list[tuple]:
    """(trial, model, M, T, cluster) of the first ``trials`` trials,
    drawn in order (the clusters consume the generator between the
    shapes, as in the reference's script)."""
    from poseidon_tpu_torch.synth import random_cluster

    return [(trial, model, M, T, random_cluster(rng, M, T))
            for trial, model, M, T, rng in shapes(trials)]


def run_trial(trial: int, model: str, M: int, T: int, cluster,
              device) -> Trial:
    """One trial: the dense solve, the oracle and, when the dense solve
    ran out of its fuse, the front door."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.dense_auction import solve_transport_dense
    from poseidon_tpu_torch.ops.transport import extract_instance
    from poseidon_tpu_torch.oracle import solve_oracle
    from poseidon_tpu_torch.solver import solve_scheduling
    from poseidon_tpu_torch.synth import price

    t0 = time.perf_counter()
    net, meta = FlowGraphBuilder().build(cluster)
    net = price(net, meta, model, cluster, device=device)
    inst = extract_instance(net, meta)
    res, _ = solve_transport_dense(inst, device=device)
    o = solve_oracle(net, algorithm="cost_scaling")
    front = None
    if not res.converged:
        front = solve_scheduling(net, meta, small_to_oracle=False,
                                 device=device).cost
    return Trial(trial=trial, model=model, M=M, T=T,
                 converged=bool(res.converged), rounds=int(res.rounds),
                 cost=int(res.cost), oracle_cost=int(o.cost),
                 front_cost=None if front is None else int(front),
                 wall_s=time.perf_counter() - t0)


def _worker_trial(job) -> tuple[Trial, dict]:
    """A pool worker's trial, with the hand kernels' launches it made."""
    from poseidon_tpu_torch import kernels

    import torch

    *args, device = job
    # one intra-op thread a worker: a tiny trial's loop runs many small
    # ops, and the workers share the host's cores
    torch.set_num_threads(1)
    kernels.reset_launch_counts()
    rec = run_trial(*args, device)
    return rec, {k.name: k.launches for k in kernels.KERNELS}


def sweep(trials: int = TRIALS, device=None, progress=None,
          workers: int = 1) -> tuple[list[Trial], dict]:
    """Run the first ``trials`` trials on ``device`` (None: the card),
    over ``workers`` processes (each its own CUDA context: the auction's
    host loop, not the card, bounds a tiny trial). Returns the trials in
    order and the hand kernels' launches summed over them;
    ``progress(trial_record)`` is called as each finishes."""
    from poseidon_tpu_torch.ops.resident import resolve_device

    device = str(resolve_device(device))
    jobs = [(*t, device) for t in trial_inputs(trials)]
    launches: dict = {}
    out: list[Trial] = []

    def take(result) -> None:
        rec, counts = result
        out.append(rec)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if progress is not None:
            progress(rec)

    if workers <= 1:
        for job in jobs:
            take(_worker_trial(job))
    else:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            for result in pool.imap_unordered(_worker_trial, jobs):
                take(result)
    out.sort(key=lambda r: r.trial)
    return out, launches


def exhausted(records: list[Trial]) -> list[tuple]:
    """(trial, model, M, T) of every trial whose dense solve ran out of
    its fuse, in trial order (the reference script's list)."""
    return [(r.trial, r.model, r.M, r.T) for r in records
            if not r.converged]


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m poseidon_tpu_torch.adversarial",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--trials", type=int, default=TRIALS)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--workers", type=int, default=1,
                   help="processes running trials side by side")
    args = p.parse_args(argv)

    def show(r: Trial) -> None:
        print(json.dumps(dataclasses.asdict(r)), flush=True)

    records, _launches = sweep(args.trials, args.device, progress=show,
                               workers=args.workers)
    wrong = [r.trial for r in records if r.wrong]
    walls = sorted(r.wall_s for r in records)
    print(json.dumps({
        "trials": len(records), "exhausted": exhausted(records),
        "wrong": wrong,
        "wall_s_p50": walls[len(walls) // 2] if walls else None,
        "wall_s_max": walls[-1] if walls else None,
    }), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
