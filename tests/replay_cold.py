"""Replay a flight-recorder dump's round records through either
package's solver, as recorded or cold.

``obs.replay`` replays a round from the state it started in (its
padding floors and warm seed). To ask whether a round is hard for the
auction itself, and not for the warm state it was handed, this replays
it also cold: without the warm seed, with or without the floors. Both
packages read each other's dumps, so one dump taken on the card replays
here through the reference (``ref``, jax on the CPU) and through the
port (``cpu`` or ``cuda``).

    python3 -m tests.replay_cold ref DUMP.json cold_nofloors 5
    python3 -m tests.replay_cold cuda DUMP.json recorded,cold_floors

Arguments: the solver (``ref``, ``cpu``, ``cuda``), the dump, the
variants (comma-separated; default all three) and the rounds (default
all). One line per record and variant: the backend (``oracle:
uncertified`` when both solves ran out the fuse), the cost, the
fetches, the auction rounds of a certified solve and the seconds.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np

VARIANTS = ("recorded", "cold_floors", "cold_nofloors")


def replay(pkg: str, path: str, variants=VARIANTS, rounds=None) -> list[str]:
    if pkg == "ref":
        from poseidon_tpu.obs import replay as rp
        from poseidon_tpu.obs.flightrec import load_dump

        def build(flags):
            return rp._build_solver(flags, [])
    else:
        from poseidon_tpu_torch.obs import replay as rp
        from poseidon_tpu_torch.obs.flightrec import load_dump

        def build(flags):
            return rp._build_solver(flags, [], pkg)
    out = []
    for rec in load_dump(path)["records"]:
        if rec.kind != "round" or (rounds and rec.round_num not in rounds):
            continue
        for variant in variants:
            solver = build(rec.flags)
            floors = None if variant == "cold_nofloors" else rec.pad_floors
            seed = rec.warm_seed if variant == "recorded" else None
            solver.restore_for_replay(floors or None, seed)
            t0 = time.perf_counter()
            o = solver.run_round(
                rec.arrays, rec.meta, cost_model=rec.cost_model,
                cost_input_kwargs={k: v for k, v in rec.cost_kwargs.items()
                                   if v is not None},
            )
            warm = getattr(solver, "_warm", None)
            digest = hashlib.sha256(
                np.asarray(o.assignment, np.int64).tobytes()).hexdigest()
            out.append(
                f"{pkg} round {rec.round_num} {variant}: pending "
                f"{len(rec.meta.task_uids)} backend {o.backend} cost "
                f"{o.cost} (recorded {rec.result and rec.result['cost']}) "
                f"fetches {solver.last_round_fetches} auction rounds "
                f"{None if warm is None else int(warm.rounds)} assignment "
                f"sha256 {digest[:16]} {time.perf_counter() - t0:.3f} s")
            print(out[-1], flush=True)
    return out


def main(argv: list[str]) -> int:
    variants = argv[2].split(",") if len(argv) > 2 else VARIANTS
    rounds = [int(r) for r in argv[3].split(",")] if len(argv) > 3 else None
    replay(argv[0], argv[1], variants, rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
