"""The explainer: per-decision cost attribution + unscheduled-pod
diagnosis.

The port of ``poseidon_tpu/obs/explain.py``. Answers the two
questions the on-call actually asks:

- **"why did pod X land on machine Y"** — for any decided uid,
  decompose the chosen route's cost into the cost model's NAMED terms
  (locality, load, wait-aging, hysteresis discount, preemption
  penalty, fixed channel fees; ``models/costs.py::arc_cost_terms``)
  such that the terms provably sum to the solver's exact int64 arc
  cost, and report the runner-up alternative and its margin;
- **"why is pod Z still unscheduled"** — a machine-checkable diagnosis
  from the closed vocabulary {``priced-out``, ``capacity-exhausted``,
  ``pref-pruned``, ``churn-budget-deferred``}, plus the MINIMAL
  relaxation (unsched-cost slack, seat count, pref rank, or churn
  budget) that would place the pod — and ``validate()`` re-solves the
  round with that relaxation applied to PROVE the pod places.

The explainer works over one round's full host-side inputs — exactly
what the flight recorder captures (``obs/flightrec.py::RoundRecord``),
so it serves both the live daemon (``--explain`` against the last
captured round) and the offline replay harness (``--explain`` against
a replayed dump). Everything here is offline/on-demand analysis: it
recomputes the priced arc table with the same registry model the
solve ran (bit-identical on the card and the CPU — the models are
elementwise integer/float32 chains with no reassociation), never
touches the hot path, and is held against the reference's explainer in
``tests/test_torch_explain.py``. ``device`` (None = the card) is where
the table is priced and where ``validate`` re-solves.

Route vocabulary: a decision's cost is the sum of the arc costs along
its chosen channel (task->unsched->sink | task->cluster->machine->sink
| pref arc (+ rack hop) ->machine->sink), mirroring the dense solver's
``_finalize`` channel selection including its tie-breaks (cluster wins
ties, earlier pref columns win later ones).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from poseidon_tpu_torch.graph.aggregate import prune_topology_prefs
from poseidon_tpu_torch.graph.builder import GraphMeta
from poseidon_tpu_torch.models.costs import (
    arc_cost_terms,
    build_cost_inputs_host,
    resolve_cost_model_name,
)
from poseidon_tpu_torch.ops.transport import (
    INF,
    TransportInstance,
    extract_topology,
    instance_from_topology,
)

DIAGNOSES = (
    "priced-out",            # parking beat every seat-available route
    "capacity-exhausted",    # affordable routes exist, seats do not
    "pref-pruned",           # top-k dropped the winning preference arc
    "churn-budget-deferred", # the decision lost the migration budget
    "anomaly",               # the inputs say it SHOULD have placed —
                             # replay/divergence material, not a state
)


class ExplainError(ValueError):
    """The uid/round cannot be explained (unknown uid, missing data)."""


@dataclasses.dataclass
class DecisionExplanation:
    """One decided uid, fully attributed."""

    uid: str
    kind: str                # PLACE | MIGRATE | PREEMPT | NOOP | UNSCHEDULED
    machine: str             # chosen machine ("" for unscheduled)
    from_machine: str        # current machine ("" for pending)
    channel: str             # "cluster" | "pref[k]" | "unsched"
    cost: int                # exact route cost (sums from terms)
    terms: dict              # {term_name: int} — nonzero terms only
    runner_up: str           # next-best alternative ("" = none finite)
    runner_up_cost: int | None
    margin: int | None       # runner_up_cost - cost (negative =
                             # capacity forced a worse-than-best seat)
    diagnosis: str = ""      # one of DIAGNOSES (unscheduled only)
    relaxation: dict | None = None  # the minimal change that places it


class RoundExplainer:
    """Attribution + diagnosis over one round's captured inputs.

    Construct via ``from_record`` (a flight-recorder ``RoundRecord``,
    live or loaded from a dump). The assignment is the round's final
    base-machine assignment (post class-expansion). ``device`` (None =
    the card) prices the arc table and runs ``validate``'s re-solves."""

    def __init__(
        self,
        *,
        meta: GraphMeta,
        arrays: dict,
        cost_model: str,
        cost_kwargs: dict | None = None,
        assignment: np.ndarray,
        flags: dict | None = None,
        unscheduled: tuple = (),
        deferred: tuple = (),
        device=None,
    ):
        self.meta = meta
        self.device = device
        self.cost_model = resolve_cost_model_name(cost_model)
        self.assignment = np.asarray(assignment, np.int64)
        self.flags = dict(flags or {})
        self.unscheduled = set(unscheduled)
        self.deferred = list(deferred)
        self._uid_idx = {u: i for i, u in enumerate(meta.task_uids)}
        full_topo = extract_topology(
            meta, arrays["src"], arrays["dst"], arrays["cap"]
        )
        topk = int(self.flags.get("topk_prefs", 0) or 0)
        self.topk = topk
        self.full_topo = full_topo
        self.topo = (
            prune_topology_prefs(
                full_topo, meta.arc_weight, meta.arc_discount, topk
            )
            if topk else full_topo
        )
        # the priced arc table + its term decomposition, host-side,
        # with the SAME registry model/inputs construction the solver
        # priced with (arc_cost_terms asserts terms sum to the model)
        inputs = build_cost_inputs_host(
            meta.n_arcs, meta, **{
                k: v for k, v in (cost_kwargs or {}).items()
                if v is not None
            },
        )
        self.terms = {
            k: np.asarray(v, np.int64)[: meta.n_arcs]
            for k, v in arc_cost_terms(
                self.cost_model, inputs, device=device
            ).items()
        }
        # the priced arc table IS the term sum: arc_cost_terms already
        # verified the terms sum bit-exactly to the registry model's
        # output, so summing here avoids pricing the table a second
        # time (and a second device round trip) per explainer
        cost = np.zeros(meta.n_arcs, np.int64)
        for v in self.terms.values():
            cost += v
        self.cost = cost
        self.inst = instance_from_topology(self.topo, self.cost)
        self.inst_full = (
            instance_from_topology(full_topo, self.cost)
            if topk else self.inst
        )
        # seats left after THIS round's assignment (base machines)
        occ = np.bincount(
            self.assignment[self.assignment >= 0],
            minlength=self.inst.n_machines,
        )
        self.free = np.asarray(self.topo.slots, np.int64) - occ

    @classmethod
    def from_record(cls, rec, device=None) -> "RoundExplainer":
        """Build from a flight-recorder ``RoundRecord`` (live ring or
        loaded dump). The record must carry a finished result."""
        if rec is None or rec.result is None:
            raise ExplainError(
                "no finished round record to explain (the flight "
                "recorder captures results at finish_round)"
            )
        return cls(
            meta=rec.meta,
            arrays=rec.arrays,
            cost_model=rec.cost_model,
            cost_kwargs=rec.cost_kwargs,
            assignment=rec.result["assignment"],
            flags=rec.flags,
            unscheduled=tuple(rec.result.get("unscheduled", ())),
            deferred=tuple(rec.result.get("deferred", ())),
            device=device,
        )

    # ---- per-task route machinery --------------------------------------

    def _tidx(self, uid: str) -> int:
        try:
            return self._uid_idx[uid]
        except KeyError:
            raise ExplainError(
                f"uid {uid!r} is not a task of this round"
            ) from None

    def _route(self, t: int, m: int, inst: TransportInstance):
        """(cost, channel_code, arc_list) of the cheapest channel from
        task t to machine m — the host mirror of ``_finalize``'s
        selection, tie-breaks included."""
        topo = self.topo if inst is self.inst else self.full_topo
        best = int(inst.w[t] + inst.d[m])
        ch = "cluster"
        arcs = [
            int(topo.arc_cluster[t]), int(topo.arc_c2m[m]),
            int(topo.arc_m2s[m]),
        ]
        for k in range(inst.max_prefs):
            pm = int(inst.pref_machine[t, k])
            pr = int(inst.pref_rack[t, k])
            pc = inst.pref_cost[t, k]
            if pc >= INF:
                continue
            if pm == m:
                val = int(pc)
                cand = [int(topo.arc_pref[t, k]), int(topo.arc_m2s[m])]
            elif pr >= 0 and pr == int(inst.rack_of[m]) \
                    and inst.ra[m] < INF:
                val = int(pc + inst.ra[m])
                cand = [
                    int(topo.arc_pref[t, k]), int(topo.arc_r2m[m]),
                    int(topo.arc_m2s[m]),
                ]
            else:
                continue
            if val < best:
                best, ch, arcs = val, f"pref[{k}]", cand
        return best, ch, arcs

    def _row(self, t: int, inst: TransportInstance) -> np.ndarray:
        """Route cost from task t to EVERY machine (int64[M]; INF =
        unreachable). Vectorized; one task at a time (offline)."""
        row = inst.w[t] + inst.d
        for k in range(inst.max_prefs):
            pm = int(inst.pref_machine[t, k])
            pr = int(inst.pref_rack[t, k])
            pc = inst.pref_cost[t, k]
            if pc >= INF:
                continue
            if pm >= 0:
                row = row.copy()
                row[pm] = min(row[pm], int(pc))
            elif pr >= 0:
                hit = inst.rack_of == pr
                row = np.minimum(
                    row, np.where(hit, pc + inst.ra, INF)
                )
        return np.minimum(row, INF)

    # ---- the decision side ---------------------------------------------

    def explain(self, uid: str) -> DecisionExplanation:
        """Attribute one decided uid: chosen route, exact term
        breakdown (sums to the solver's arc cost), runner-up +
        margin; unscheduled pods additionally get their diagnosis."""
        t = self._tidx(uid)
        asg = int(self.assignment[t])
        cur = int(self.meta.task_current[t])
        names = self.meta.machine_names
        if asg < 0:
            return self._explain_unscheduled(uid, t, cur)
        cost, channel, arcs = self._route(t, asg, self.inst)
        terms = self._sum_terms(arcs)
        row = self._row(t, self.inst)
        masked = row.copy()
        masked[asg] = INF
        alt_m = int(masked.min(initial=INF))
        u = int(self.inst.u[t])
        if alt_m <= u:
            ru_cost, ru = alt_m, names[int(masked.argmin())]
        else:
            ru_cost, ru = u, "unscheduled"
        if ru_cost >= INF:
            ru, ru_cost, margin = "", None, None
        else:
            margin = ru_cost - cost
        if cur >= 0:
            kind = "NOOP" if asg == cur else "MIGRATE"
        else:
            kind = "PLACE"
        expl = DecisionExplanation(
            uid=uid, kind=kind, machine=names[asg],
            from_machine=names[cur] if cur >= 0 else "",
            channel=channel, cost=cost, terms=terms,
            runner_up=ru, runner_up_cost=ru_cost, margin=margin,
        )
        if uid in self.deferred:
            # the solver DECIDED this move but the churn budget
            # deferred its actuation: the pod is still where it was
            expl.diagnosis, expl.relaxation = self._diagnose(
                uid, t, row, u
            )
        return expl

    def _sum_terms(self, arcs: list[int]) -> dict:
        out = {}
        for name, vec in self.terms.items():
            v = int(sum(int(vec[a]) for a in arcs))
            if v != 0:
                out[name] = v
        return out

    # ---- the unscheduled side ------------------------------------------

    def _explain_unscheduled(
        self, uid: str, t: int, cur: int
    ) -> DecisionExplanation:
        topo_u = self.topo
        u_arcs = [int(topo_u.arc_unsched[t]), int(topo_u.arc_u2s[t])]
        u = int(self.inst.u[t])
        terms = self._sum_terms(u_arcs)
        row = self._row(t, self.inst)
        alt = int(row.min(initial=INF))
        ru = (
            self.meta.machine_names[int(row.argmin())]
            if alt < INF else ""
        )
        diagnosis, relaxation = self._diagnose(uid, t, row, u)
        kind = "PREEMPT" if cur >= 0 else "UNSCHEDULED"
        return DecisionExplanation(
            uid=uid, kind=kind, machine="",
            from_machine=(
                self.meta.machine_names[cur] if cur >= 0 else ""
            ),
            channel="unsched", cost=u, terms=terms,
            runner_up=ru,
            runner_up_cost=alt if alt < INF else None,
            margin=(alt - u) if alt < INF else None,
            diagnosis=diagnosis, relaxation=relaxation,
        )

    def _diagnose(self, uid: str, t: int, row: np.ndarray, u: int):
        """One reason from DIAGNOSES + the minimal relaxation that
        places the pod (validated by ``validate``'s re-solve)."""
        if uid in self.deferred:
            # the decision existed but lost the per-round churn
            # budget: granting (position+1) budget slots actuates it
            return "churn-budget-deferred", {
                "kind": "churn-budget",
                "max_migrations_per_round":
                    self.deferred.index(uid) + 1 + int(
                        self.flags.get("max_migrations_per_round", 0)
                    ),
            }
        free = self.free
        affordable = row < u
        if bool((affordable & (free > 0)).any()):
            # a strictly-cheaper seat sat free and the solver parked
            # the pod anyway: that contradicts exactness — this is
            # replay/divergence material, not a cluster state
            return "anomaly", None
        if self.topk:
            row_full = self._row(t, self.inst_full)
            win = (row_full < u) & (free > 0)
            if bool(win.any()):
                m = int(np.where(win, row_full, INF).argmin())
                return "pref-pruned", {
                    "kind": "restore-prefs",
                    "machine": self.meta.machine_names[m],
                    "topk_prefs": self._pref_rank(t, m),
                }
        if bool(affordable.any()):
            # affordable machines exist but every one is out of seats
            m = int(np.where(affordable, row, INF).argmin())
            return "capacity-exhausted", {
                "kind": "add-seats",
                "machine": self.meta.machine_names[m],
                "seats": 1,
            }
        feasible_free = (row < INF) & (free > 0)
        if bool(feasible_free.any()):
            best = int(np.where(feasible_free, row, INF).min())
            m = int(np.where(feasible_free, row, INF).argmin())
            return "priced-out", {
                "kind": "unsched-slack",
                "machine": self.meta.machine_names[m],
                "slack": best - u + 1,
            }
        # no free seat anywhere AND no affordable route: seats first,
        # plus the slack that makes the freed seat worth taking
        feasible = row < INF
        if not bool(feasible.any()):
            return "capacity-exhausted", None  # unreachable entirely
        m = int(np.where(feasible, row, INF).argmin())
        return "capacity-exhausted", {
            "kind": "add-seats",
            "machine": self.meta.machine_names[m],
            "seats": 1,
            "slack": max(int(row[m]) - u + 1, 0),
        }

    def _pref_rank(self, t: int, m: int) -> int:
        """How many prefs (by the pruner's heaviest-first order) must
        be kept for task t's pref on machine m to survive — the
        minimal ``--topk_prefs``."""
        topo = self.full_topo
        ap = topo.arc_pref[t]
        w = np.where(
            ap >= 0,
            self.meta.arc_weight[np.maximum(ap, 0)].astype(np.int64),
            -1,
        )
        order = np.argsort(-w, kind="stable")
        for rank, k in enumerate(order):
            pm = int(topo.pref_machine[t, k])
            pr = int(topo.pref_rack[t, k])
            if pm == m or (
                pr >= 0 and pr == int(topo.rack_of[m])
            ):
                return rank + 1
        return int((ap >= 0).sum())

    # ---- relaxation validation (the machine-checkable part) ------------

    def validate(self, expl: DecisionExplanation) -> dict:
        """Apply the explanation's minimal relaxation and RE-SOLVE the
        round offline; returns {"ok": bool, "placed_on": name, ...}.
        For ``churn-budget-deferred`` the re-check is the delta
        extractor with the relaxed budget (the decision actuates); for
        the others the dense solver must place the pod. A diagnosis
        whose relaxation does not place the pod is a bug — tests
        assert ok for every fuzzed unscheduled pod."""
        from poseidon_tpu_torch.graph.deltas import extract_deltas

        if expl.relaxation is None:
            return {"ok": False, "why": "no relaxation"}
        t = self._tidx(expl.uid)
        r = expl.relaxation
        if r["kind"] == "churn-budget":
            dset = extract_deltas(
                self.meta, self.assignment,
                max_migrations=r["max_migrations_per_round"],
            )
            granted = {
                d.task for d in
                dset.place + dset.migrate + dset.preempt
            }
            return {
                "ok": expl.uid in granted,
                "budget": r["max_migrations_per_round"],
            }
        inst = self.inst
        if r["kind"] == "restore-prefs":
            inst = self.inst_full
        u2 = np.array(inst.u, np.int64)
        if r.get("slack"):
            u2 = u2.copy()
            u2[t] += int(r["slack"])
        slots2 = np.array(inst.slots, np.int32)
        seats = int(r.get("seats", 0))
        midx = (
            self.meta.machine_names.index(r["machine"])
            if "machine" in r else -1
        )
        placed_on, seats_used = "", seats
        # seats may need to grow past 1 when other unscheduled pods
        # outbid this one for the freed seat: search upward, bounded
        # by the unscheduled population (each extra seat places at
        # least one of them ahead of this pod)
        for extra in range(max(seats, 0), len(self.unscheduled) + 1):
            s = slots2
            if midx >= 0 and extra:
                s = slots2.copy()
                s[midx] += extra
            res = self._resolve(
                dataclasses.replace(inst, u=u2, slots=s)
            )
            if int(res.assignment[t]) >= 0:
                placed_on = self.meta.machine_names[
                    int(res.assignment[t])
                ]
                seats_used = extra
                break
            if r["kind"] != "add-seats":
                break  # slack/pref relaxations are one-shot checks
        out = {"ok": bool(placed_on), "placed_on": placed_on}
        if r["kind"] == "add-seats":
            out["seats"] = seats_used
        return out

    def _resolve(self, inst: TransportInstance):
        from poseidon_tpu_torch.ops.dense_auction import (
            solve_transport_dense,
        )

        res, _ = solve_transport_dense(inst, device=self.device)
        if not res.converged:
            raise ExplainError(
                "relaxation re-solve did not certify; cannot validate"
            )
        return res


def render_explanation(expl: DecisionExplanation) -> str:
    """The operator-facing transcript (cli --explain / replay
    --explain)."""
    out = [f"== explain {expl.uid} =="]
    if expl.kind == "UNSCHEDULED":
        out.append("decision: UNSCHEDULED (parked, aging)")
    elif expl.kind == "PREEMPT":
        out.append(
            f"decision: PREEMPT off {expl.from_machine} (parked)"
        )
    elif expl.kind == "MIGRATE":
        out.append(
            f"decision: MIGRATE {expl.from_machine} -> "
            f"{expl.machine} via {expl.channel}"
        )
    else:
        out.append(
            f"decision: {expl.kind} -> {expl.machine} "
            f"via {expl.channel}"
        )
    out.append(f"cost: {expl.cost}")
    width = max((len(k) for k in expl.terms), default=4)
    for name, v in sorted(
        expl.terms.items(), key=lambda kv: -abs(kv[1])
    ):
        out.append(f"  {name:<{width}}  {v:+d}")
    out.append(f"  {'=':<{width}}  {expl.cost:+d} (sums exactly)")
    if expl.runner_up:
        out.append(
            f"runner-up: {expl.runner_up} at {expl.runner_up_cost} "
            f"(margin {expl.margin:+d})"
        )
    else:
        out.append("runner-up: none (no finite alternative)")
    if expl.diagnosis:
        out.append(f"diagnosis: {expl.diagnosis}")
        if expl.relaxation:
            out.append(
                "minimal relaxation: "
                + ", ".join(
                    f"{k}={v}" for k, v in expl.relaxation.items()
                    if k != "kind"
                )
                + f" ({expl.relaxation['kind']})"
            )
    return "\n".join(out)
