"""Deterministic offline replay of flight-recorder dumps.

``python -m poseidon_tpu_torch.obs.replay <dump.json>`` reconstructs every
recorded round/express batch from the dump (the port's or the
reference's: the layout is shared), re-runs the REAL solve path
(``ops/resident.ResidentSolver`` — the same round, the same
certificates, the same degrade routing) offline on the card
(``--device=cpu`` on request), and asserts
bit-identity with the recorded assignment and cost. A mismatch is
REPORTED as a divergence (per record: what differed and how), never an
assert crash — a doctored or cross-version dump yields a readable
diff and exit code 1.

Fidelity mechanics:

- each round record carries the solver's grow-only padding floors and
  (when clean) a host mirror of the warm state the solve started from
  (``RoundRecord.pad_floors`` / ``warm_seed``, both riding the round's
  ONE fetch on the live path) — the replay seeds both, so the replayed
  round pads to the same shapes and starts from the exact state;
- express batches are replayed through ``express_round`` against the
  replayed round's own device context, reproducing the inter-round
  warm-state mutations deterministically — a subsequent round whose
  warm seed was express-dirty (``warm_seed=None``) chains off that
  replayed state;
- sharded rounds (``mesh_width=N``) replay on the recorded mesh when
  the replay's device kind has the devices (N CUDA devices; a CPU
  replay lays any width out on the CPU), else on the plain
  single-device layout — bit-identical either way (the scale lane's
  own pinned invariant, tests/test_torch_scale.py).

``--explain <uid>`` additionally runs the explainer
(``obs/explain.py``) against the LAST replayed round — term breakdown,
runner-up margin, and (for unscheduled pods) the diagnosis + minimal
relaxation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from poseidon_tpu_torch.obs.flightrec import (
    ExpressRecord,
    RoundRecord,
    load_dump,
)

_SOLVER_FLAG_DEFAULTS = {
    "mesh_width": 0,
    "aggregate_classes": False,
    "topk_prefs": 0,
    "express_lane": False,
    "express_max_batch": 16,
    "small_to_oracle": True,
}


@dataclasses.dataclass
class RecordReplay:
    """One record's replay verdict."""

    kind: str
    round_num: int
    ok: bool | None          # None = nothing recorded to compare
    backend: str = ""
    cost: int | None = None
    divergence: dict | None = None
    note: str = ""


def _device_count(device) -> int | None:
    """How many devices a mesh of the replay's device kind can span:
    the visible CUDA devices, or None (no limit) on the CPU, where a
    mesh lays every shard on the one host device."""
    import torch

    from poseidon_tpu_torch.ops.resident import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return None


def _build_solver(flags: dict, notes: list[str], device=None):
    from poseidon_tpu_torch.ops.resident import ResidentSolver

    f = {**_SOLVER_FLAG_DEFAULTS, **(flags or {})}
    mesh = int(f["mesh_width"] or 0)
    count = _device_count(device)
    if mesh and count is not None and mesh > count:
        notes.append(
            f"recorded mesh_width={mesh} > {count} local "
            f"device(s); replaying on the plain layout (bit-identical "
            f"by the scale lane's pinned invariant)"
        )
        mesh = 0
    return ResidentSolver(
        device=device,
        mesh_width=mesh,
        aggregate_classes=bool(f["aggregate_classes"]),
        topk_prefs=int(f["topk_prefs"] or 0),
        express_lane=bool(f["express_lane"]),
        express_max_batch=int(f["express_max_batch"] or 16),
        small_to_oracle=bool(f["small_to_oracle"]),
    )


def _replay_round(solver, rec: RoundRecord) -> tuple:
    """(RecordReplay, outcome) for one round record."""
    if not rec.warm_used:
        # the live round ran cold (first round / floors reset):
        # drop any chained replay state so the variant matches
        solver.reset()
    solver.restore_for_replay(rec.pad_floors or None, rec.warm_seed)
    outcome = solver.run_round(
        rec.arrays, rec.meta,
        cost_model=rec.cost_model,
        cost_input_kwargs={
            k: v for k, v in rec.cost_kwargs.items() if v is not None
        },
    )
    rr = RecordReplay(
        kind="round", round_num=rec.round_num, ok=None,
        backend=outcome.backend, cost=outcome.cost,
    )
    if rec.result is None:
        rr.note = (
            "no recorded result (round was abandoned live); replay "
            "solved it"
        )
        return rr, outcome
    div = {}
    rec_asg = np.asarray(rec.result["assignment"], np.int64)
    got_asg = np.asarray(outcome.assignment, np.int64)
    if rec_asg.shape != got_asg.shape:
        div["assignment"] = (
            f"shape {rec_asg.shape} recorded vs {got_asg.shape} "
            f"replayed"
        )
    elif not np.array_equal(rec_asg, got_asg):
        bad = np.flatnonzero(rec_asg != got_asg)
        div["assignment"] = {
            "differing_tasks": int(bad.size),
            "first": {
                "uid": rec.meta.task_uids[int(bad[0])],
                "recorded": int(rec_asg[bad[0]]),
                "replayed": int(got_asg[bad[0]]),
            },
        }
    if int(rec.result["cost"]) != int(outcome.cost):
        div["cost"] = {
            "recorded": int(rec.result["cost"]),
            "replayed": int(outcome.cost),
        }
    if rec.result.get("backend", "") != outcome.backend:
        # informational unless the numbers diverged too: the same
        # instance can legitimately route differently on a host with
        # a different memory budget / missing oracle
        rr.note = (
            f"backend differs: recorded "
            f"{rec.result.get('backend')} vs replayed "
            f"{outcome.backend}"
        )
    rr.ok = not div
    rr.divergence = div or None
    return rr, outcome


def _replay_express(solver, rec: ExpressRecord) -> RecordReplay:
    from poseidon_tpu_torch.ops.resident import ExpressArrival, ExpressBatch

    batch = ExpressBatch(
        arrivals=[
            ExpressArrival(
                uid=a["uid"],
                wait_rounds=int(a["wait_rounds"]),
                cpu_milli=int(a["cpu_milli"]),
                mem_kb=int(a["mem_kb"]),
                prefs=tuple(tuple(p) for p in a["prefs"]),
            )
            for a in rec.arrivals
        ],
        retires=[tuple(r) for r in rec.retires],
        removals=list(rec.removals),
        slot_deltas=[tuple(s) for s in rec.slot_deltas],
    )
    outcome = solver.express_round(batch)
    rr = RecordReplay(
        kind="express", round_num=rec.round_num, ok=None,
        backend="express" if outcome.ok
        else f"express-degrade:{outcome.reason}",
        cost=outcome.cost if outcome.ok else None,
    )
    if rec.result is None:
        rr.note = "no recorded outcome; replay ran the batch"
        return rr
    div = {}
    if bool(rec.result.get("ok")) != outcome.ok:
        div["ok"] = {
            "recorded": bool(rec.result.get("ok")),
            "replayed": outcome.ok,
            "replayed_reason": outcome.reason,
        }
    elif outcome.ok:
        want = sorted(
            (str(u), str(m)) for u, m in rec.result["placements"]
        )
        got = sorted(
            (str(u), str(m)) for u, m in outcome.placements
        )
        if want != got:
            div["placements"] = {"recorded": want, "replayed": got}
        if int(rec.result["cost"]) != int(outcome.cost):
            div["cost"] = {
                "recorded": int(rec.result["cost"]),
                "replayed": int(outcome.cost),
            }
    rr.ok = not div
    rr.divergence = div or None
    return rr


def replay_dump(
    dump: dict, *, explain_uid: str = "", device=None,
) -> dict:
    """Replay every record in order through ONE solver on ``device``
    (None = the card); returns the report data model (JSON-able)."""
    records = dump["records"]
    notes: list[str] = []
    first_round = next(
        (r for r in records if r.kind == "round"), None
    )
    if first_round is None:
        return {
            "identical": None,
            "notes": ["dump contains no round records"],
            "records": [],
        }
    solver = _build_solver(first_round.flags, notes, device)
    out: list[RecordReplay] = []
    last_round_rec = None
    last_outcome = None
    for rec in records:
        if rec.kind == "round":
            rr, outcome = _replay_round(solver, rec)
            last_round_rec, last_outcome = rec, outcome
        else:
            rr = _replay_express(solver, rec)
        out.append(rr)
    compared = [r for r in out if r.ok is not None]
    report = {
        "identical": all(r.ok for r in compared) if compared else None,
        "compared": len(compared),
        "notes": notes,
        "records": [dataclasses.asdict(r) for r in out],
    }
    if explain_uid and last_round_rec is not None:
        report["explain"] = _explain_replayed(
            last_round_rec, last_outcome, explain_uid, device
        )
    return report


def _explain_replayed(
    rec: RoundRecord, outcome, uid: str, device=None
) -> dict:
    """Run the explainer against the REPLAYED round (not the recorded
    numbers): the whole point of replay is trusting the offline
    re-derivation."""
    from poseidon_tpu_torch.graph.deltas import extract_deltas
    from poseidon_tpu_torch.obs.explain import (
        ExplainError,
        RoundExplainer,
        render_explanation,
    )

    dset = extract_deltas(
        rec.meta, outcome.assignment,
        max_migrations=(
            int(rec.flags.get("max_migrations_per_round", 0))
            if rec.flags.get("enable_preemption") else 0
        ),
        task_cost=outcome.task_cost,
        task_margin=outcome.task_margin,
    )
    try:
        ex = RoundExplainer(
            meta=rec.meta,
            arrays=rec.arrays,
            cost_model=rec.cost_model,
            cost_kwargs=rec.cost_kwargs,
            assignment=outcome.assignment,
            flags=rec.flags,
            unscheduled=tuple(dset.unscheduled),
            deferred=tuple(d.task for d in dset.deferred),
            device=device,
        )
        expl = ex.explain(uid)
    except ExplainError as e:
        # a typo'd / long-retired uid must yield a readable line, not
        # a traceback after the whole replay already ran
        return {
            "rendered": f"explain {uid}: {e}",
            "error": str(e),
        }
    return {
        "rendered": render_explanation(expl),
        "explanation": dataclasses.asdict(expl),
    }


def render_report(report: dict) -> str:
    out = ["== poseidon-tpu-torch flight replay =="]
    for n in report.get("notes", ()):
        out.append(f"note: {n}")
    for r in report["records"]:
        tag = {True: "BIT-IDENTICAL", False: "DIVERGED",
               None: "(nothing recorded)"}[r["ok"]]
        line = (
            f"r{r['round_num']:>5} {r['kind']:<8} {tag}"
            f"  backend={r['backend']}"
        )
        if r["cost"] is not None:
            line += f" cost={r['cost']}"
        out.append(line)
        if r["note"]:
            out.append(f"        {r['note']}")
        if r["divergence"]:
            out.append(
                "        divergence: "
                + json.dumps(r["divergence"], default=str)
            )
    verdict = report["identical"]
    out.append(
        "verdict: "
        + ("all compared records bit-identical" if verdict
           else "nothing to compare" if verdict is None
           else "DIVERGENCE — recorded run is not reproducible from "
                "this dump on this host")
    )
    if "explain" in report:
        out.append("")
        out.append(report["explain"]["rendered"])
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m poseidon_tpu_torch.obs.replay",
        description="replay a flight-recorder dump offline and assert "
                    "bit-identity with the recorded rounds",
    )
    p.add_argument("dump", help="dump manifest (.json) or .npz path")
    p.add_argument("--explain", default="", metavar="UID",
                   help="also explain one uid against the replayed "
                        "last round")
    p.add_argument("--json", action="store_true",
                   help="emit the raw report data model as JSON")
    p.add_argument("--device", default="cuda",
                   help="the replay solver's torch device: cuda "
                        "(default; raises without a card), cuda:N, or "
                        "cpu")
    args = p.parse_args(argv)
    try:
        dump = load_dump(args.dump)
    except (OSError, ValueError, KeyError) as e:
        print(f"cannot load dump: {e}", file=sys.stderr)
        return 2
    report = replay_dump(
        dump, explain_uid=args.explain, device=args.device
    )
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render_report(report))
    return 0 if report["identical"] in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())
