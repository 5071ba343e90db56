"""Anomaly flight recorder: the last K rounds' full inputs, dumpable.

The port of ``poseidon_tpu/obs/flightrec.py``, with the same records,
dump layout and ``DUMP_FORMAT``, so each package's ``load_dump`` reads
the other's dumps. When a round degrades to the oracle, an express
batch falls back, a placement fetch times out, or the watch stream
storms into repeated resyncs, the DEGRADE / EXPRESS_DEGRADE /
FETCH_TIMEOUT counters tick — and the inputs that triggered them
would evaporate. The flight recorder keeps a bounded ring of the last
K rounds' complete host-side solve inputs (graph arrays, GraphMeta,
cost-model inputs, flags, padding floors, padded dims, warm-start
seed, stats) plus the inter-round express batches, captured at
``begin_round`` time from arrays the builder/bridge already
materialized. On an anomaly (or on demand) the ring dumps to an
``.npz`` (every array) + a JSON manifest (every scalar/name), and
``python -m poseidon_tpu_torch.obs.replay <dump>`` reconstructs the
instances, re-runs the real solve path offline, and asserts
bit-identity with the recorded assignment/cost.

Capture cost discipline: the capture helpers run inside the round's
begin/finish window — vectorized ``np.copy`` / ``list()`` only, no
device reads, no O(cluster) Python loops. The warm-start seed is the
host mirror the solver's ONE result fetch already brought back
(``ResidentSolver.warm_seed_host``) — capturing it moves bytes that
are already on the host, never a new sync.

Replay-fidelity contract: a round record carries everything the
resident solver's round reads — the replayed round runs the SAME
solve over the SAME inputs from the SAME warm state, so its
assignment and cost are bit-identical, not merely cost-equal. Rounds
whose warm state had been patched on device by express batches carry
``warm_seed=None``; the recorded express batches in between reproduce
that state deterministically when the ring contains the full chain
(obs/replay.py replays records in order through one solver).

The manifest names the package version, the torch version and the
device the recording solver ran on (``"torch"``, ``"device"``) where
the reference's names its JAX version; every other key is the
reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import time

import numpy as np

from poseidon_tpu_torch.graph.builder import GraphMeta

log = logging.getLogger(__name__)

# default ring depth: how many rounds of inputs survive to a dump
FLIGHT_ROUNDS_DEFAULT = 8

# the dump format version (manifest "format"): bump on layout changes
# so replay can refuse dumps it does not understand instead of
# misreading them
DUMP_FORMAT = 1

# bounded dump-reason vocabulary — the trigger sites map their free-
# text causes onto these before they reach the metrics label
DUMP_REASONS = (
    "degrade",          # dense lane fell back to the oracle
    "express-degrade",  # an express batch fell back to the round path
    "fetch-timeout",    # the pipelined placement fetch missed deadline
    "resync-storm",     # repeated full-LIST resyncs within the window
    "manual",           # operator / caller requested
)

_META_ARRAYS = (
    "node_role", "arc_kind", "arc_task", "arc_machine", "arc_rack",
    "arc_weight", "arc_discount", "task_wait", "task_current",
    "task_node", "machine_node", "node_machine",
)
_META_LISTS = ("task_uids", "machine_names", "rack_names", "job_ids")


@dataclasses.dataclass
class RoundRecord:
    """One round's full host-side solve input (+ its result, attached
    at finish time)."""

    round_num: int
    cost_model: str
    flags: dict
    arrays: dict                 # src/dst/cap/supply (copies)
    meta: GraphMeta              # deep-copied host metadata
    cost_kwargs: dict            # KnowledgeBase aggregates (copies)
    pad_floors: dict             # solver grow-only padding floors
    dims: dict                   # Tp/Mp/n_prefs/smax the solve padded to
    warm_used: bool
    warm_seed: tuple | None      # host (asg, lvl, floor) or None
    rv: str = ""                 # watch resourceVersion, when known
    stats: dict | None = None
    result: dict | None = None   # assignment/channel/cost/backend/...

    kind = "round"


@dataclasses.dataclass
class ExpressRecord:
    """One inter-round express batch (inputs + outcome)."""

    round_num: int               # the round window it patched
    arrivals: list               # [{uid, wait_rounds, cpu_milli, mem_kb, prefs}]
    retires: list                # [(uid, machine)]
    removals: list               # [uid]
    slot_deltas: list            # [(machine, delta)]
    result: dict | None = None   # ok/reason/placements/cost/rounds

    kind = "express"


def _copy_meta(meta: GraphMeta) -> GraphMeta:
    """Deep host copy of a GraphMeta: the incremental builder patches
    its cached columns in place across rounds, so retained references
    would silently mutate under the ring."""
    return dataclasses.replace(
        meta,
        **{k: np.array(getattr(meta, k), copy=True)
           for k in _META_ARRAYS},
        **{k: list(getattr(meta, k)) for k in _META_LISTS},
    )


class FlightRecorder:
    """Bounded ring of round/express records + the dump writer.

    One instance per bridge (the daemon builds it from
    ``--flight_recorder``/``--flight_dir``). Single-threaded by the
    bridge's own contract — every capture happens on the loop thread
    inside the round window. ``device`` (the recording solver's device)
    is written into each dump's manifest.
    """

    # per-reason anomaly-dump cooldown: a persistently-anomalous
    # daemon (e.g. every round degrading to the oracle) must not
    # serialize the full ring to disk every round forever — one dump
    # per reason per window preserves the evidence without turning the
    # recorder into the incident. "manual" dumps are never throttled.
    COOLDOWN_S = 300.0

    # default on-disk retention: newest dumps kept per --flight_dir (a
    # flapping daemon writing one ring .npz per cooldown window must
    # not fill the disk before anyone reads the evidence); 0 disables
    # the GC entirely
    MAX_DUMPS_DEFAULT = 16

    def __init__(
        self,
        out_dir: str = "flightrec",
        *,
        rounds: int = FLIGHT_ROUNDS_DEFAULT,
        metrics=None,
        cooldown_s: float = COOLDOWN_S,
        max_dumps: int = MAX_DUMPS_DEFAULT,
        device=None,
    ):
        self.out_dir = out_dir
        self.device = device
        self.rounds = max(int(rounds), 1)
        self.metrics = metrics
        self.cooldown_s = cooldown_s
        self.max_dumps = max(int(max_dumps), 0)
        self.records: collections.deque = collections.deque()
        self.dumps_total = 0
        self.dumps_suppressed = 0
        self.dumps_pruned = 0
        self._seq = 0
        self._last_dump: dict[str, float] = {}
        # boot-unique filename token: a restarted daemon's round
        # numbers and sequence counter reset, and overwriting the
        # PREVIOUS boot's dump would destroy exactly the post-mortem
        # evidence the recorder exists to preserve
        self._boot = time.strftime("%Y%m%dT%H%M%S", time.gmtime())

    # ---- capture (hot scopes: vectorized copies only) ------------------

    def capture_begin(
        self,
        *,
        round_num: int,
        cost_model: str,
        flags: dict,
        arrays: dict,
        meta: GraphMeta,
        cost_kwargs: dict,
        pad_floors: dict,
        dims: dict,
        warm_used: bool,
        warm_seed: tuple | None,
        rv: str = "",
    ) -> RoundRecord:
        rec = RoundRecord(
            round_num=round_num,
            cost_model=str(cost_model),
            flags=dict(flags),
            arrays={
                k: np.array(v, copy=True) for k, v in arrays.items()
            },
            meta=_copy_meta(meta),
            cost_kwargs={
                k: (np.array(v, copy=True) if v is not None else None)
                for k, v in cost_kwargs.items()
            },
            pad_floors=dict(pad_floors),
            dims=dict(dims),
            warm_used=bool(warm_used),
            warm_seed=(
                tuple(np.array(a, copy=True) for a in warm_seed)
                if warm_seed is not None else None
            ),
            rv=rv,
        )
        self.records.append(rec)
        self._trim()
        return rec

    def capture_finish(self, rec: RoundRecord | None, outcome,
                       stats_dict: dict | None,
                       extra: dict | None = None) -> None:
        """Attach a finished round's outcome (the replay assertion
        target) to its begin-time record. ``extra`` carries decision-
        layer context (unscheduled/deferred uids) for the explainer."""
        if rec is None:
            return
        if outcome is not None:
            rec.result = {
                "assignment": np.array(outcome.assignment, copy=True),
                "channel": np.array(outcome.channel, copy=True),
                "cost": int(outcome.cost),
                "backend": outcome.backend,
                "converged": bool(outcome.converged),
                **(extra or {}),
            }
        if stats_dict is not None:
            rec.stats = dict(stats_dict)

    def capture_express(
        self, round_num: int, batch, outcome,
        placements: dict | None = None,
    ) -> ExpressRecord:
        """One express batch: the coalesced inputs (already plain host
        scalars/tuples) + its outcome. ``placements`` is the bridge's
        post-validation uid->machine map when the batch bound pods."""
        rec = ExpressRecord(
            round_num=round_num,
            arrivals=[
                {
                    "uid": a.uid,
                    "wait_rounds": int(a.wait_rounds),
                    "cpu_milli": int(a.cpu_milli),
                    "mem_kb": int(a.mem_kb),
                    "prefs": [list(map(int, p)) for p in a.prefs],
                }
                for a in batch.arrivals
            ],
            retires=[list(r) for r in batch.retires],
            removals=list(batch.removals),
            slot_deltas=[[m, int(d)] for m, d in batch.slot_deltas],
        )
        if outcome is not None:
            rec.result = {
                "ok": bool(outcome.ok),
                "reason": outcome.reason,
                "placements": (
                    sorted(placements.items())
                    if placements is not None
                    else [list(p) for p in outcome.placements]
                ),
                "cost": int(outcome.cost),
                "rounds": int(outcome.rounds),
            }
        self.records.append(rec)
        self._trim()
        return rec

    def last_round_record(self) -> RoundRecord | None:
        """The most recent round record (the live ``--explain``
        target), or None before the first captured round."""
        for r in reversed(self.records):
            if r.kind == "round":
                return r
        return None

    # express records kept per retained round window: a daemon parked
    # in one endless express window (no round ticking) must not grow
    # the ring without bound — the oldest batches drop first, and a
    # replay of the truncated chain reports divergence honestly
    EXPRESS_PER_ROUND = 64

    def _trim(self) -> None:
        """Keep at most ``rounds`` RoundRecords (express records ride
        with their round window; leading orphans drop with it) and a
        bounded number of express records."""
        n_rounds = sum(
            1 for r in self.records if r.kind == "round"
        )
        while n_rounds > self.rounds and self.records:
            dropped = self.records.popleft()
            if dropped.kind == "round":
                n_rounds -= 1
        # orphan express records older than the first retained round
        while self.records and self.records[0].kind != "round":
            self.records.popleft()
        n_express = len(self.records) - n_rounds
        if n_express > self.rounds * self.EXPRESS_PER_ROUND:
            kept: collections.deque = collections.deque()
            to_drop = n_express - self.rounds * self.EXPRESS_PER_ROUND
            for r in self.records:
                if to_drop and r.kind == "express":
                    to_drop -= 1
                    continue
                kept.append(r)
            self.records = kept

    # ---- the dump writer (anomaly / on-demand; NOT a hot scope) --------

    def dump(self, reason: str, *, label: str = "") -> str | None:
        """Write the ring as ``<stem>.npz`` + ``<stem>.json``; returns
        the manifest path (None when the ring is empty, or when the
        same anomaly reason already dumped within ``cooldown_s`` —
        "manual" is never throttled). ``reason`` must be one of
        ``DUMP_REASONS``; ``label`` carries the free-text cause into
        the manifest."""
        if reason not in DUMP_REASONS:
            raise ValueError(
                f"undeclared dump reason {reason!r}; the vocabulary "
                f"is flightrec.DUMP_REASONS"
            )
        if not self.records:
            return None
        now = time.monotonic()
        if reason != "manual":
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.cooldown_s:
                self.dumps_suppressed += 1
                log.info(
                    "flight recorder: %s dump suppressed (%gs "
                    "cooldown; %d suppressed so far)",
                    reason, self.cooldown_s, self.dumps_suppressed,
                )
                return None
            self._last_dump[reason] = now
        os.makedirs(self.out_dir, exist_ok=True)
        last_round = max(
            (r.round_num for r in self.records), default=0
        )
        self._seq += 1
        stem = os.path.join(
            self.out_dir,
            f"flightrec-{self._boot}-r{last_round:06d}-{reason}-"
            f"{self._seq:03d}",
        )
        blobs: dict[str, np.ndarray] = {}
        manifest_records = []
        for i, rec in enumerate(self.records):
            pre = f"{i:03d}"
            if rec.kind == "express":
                manifest_records.append({
                    "kind": "express",
                    "round_num": rec.round_num,
                    "arrivals": rec.arrivals,
                    "retires": rec.retires,
                    "removals": rec.removals,
                    "slot_deltas": rec.slot_deltas,
                    "result": rec.result,
                })
                continue
            for k, v in rec.arrays.items():
                blobs[f"{pre}/arrays/{k}"] = v
            for k in _META_ARRAYS:
                blobs[f"{pre}/meta/{k}"] = getattr(rec.meta, k)
            for k, v in rec.cost_kwargs.items():
                if v is not None:
                    blobs[f"{pre}/ck/{k}"] = v
            if rec.warm_seed is not None:
                for name, v in zip(("asg", "lvl", "floor"),
                                   rec.warm_seed):
                    blobs[f"{pre}/warm/{name}"] = v
            if rec.result is not None:
                blobs[f"{pre}/result/assignment"] = \
                    rec.result["assignment"]
                blobs[f"{pre}/result/channel"] = rec.result["channel"]
            manifest_records.append({
                "kind": "round",
                "round_num": rec.round_num,
                "cost_model": rec.cost_model,
                "flags": rec.flags,
                "pad_floors": rec.pad_floors,
                "dims": rec.dims,
                "warm_used": rec.warm_used,
                "has_warm_seed": rec.warm_seed is not None,
                "rv": rec.rv,
                "meta": {
                    **{k: getattr(rec.meta, k) for k in _META_LISTS},
                    "n_nodes": int(rec.meta.n_nodes),
                    "n_arcs": int(rec.meta.n_arcs),
                },
                "cost_kwargs_present": sorted(
                    k for k, v in rec.cost_kwargs.items()
                    if v is not None
                ),
                "stats": rec.stats,
                "result": (
                    {
                        k: v for k, v in rec.result.items()
                        if k not in ("assignment", "channel")
                    }
                    if rec.result is not None else None
                ),
            })
        import torch

        import poseidon_tpu_torch

        manifest = {
            "format": DUMP_FORMAT,
            "reason": reason,
            "label": label,
            "created_unix": time.time(),
            "poseidon_tpu": poseidon_tpu_torch.__version__,
            "torch": torch.__version__,
            "device": _device_name(self.device),
            "records": manifest_records,
        }
        np.savez_compressed(stem + ".npz", **blobs)
        with open(stem + ".json", "w") as fh:
            json.dump(manifest, fh, indent=1, default=str)
        self.dumps_total += 1
        if self.metrics is not None:
            self.metrics.record_flightrec_dump(reason)
        log.warning(
            "flight recorder dumped %d record(s) to %s.{npz,json} "
            "(reason=%s%s)", len(self.records), stem, reason,
            f": {label}" if label else "",
        )
        self._prune_dumps()
        return stem + ".json"

    def _prune_dumps(self) -> None:
        """Bound the on-disk dump set to the ``max_dumps`` most recent
        (oldest-first GC over every ``flightrec-*`` stem in the
        directory — previous boots' dumps age out the same way, which
        is the point: the disk bound must hold across restarts)."""
        if not self.max_dumps:
            return
        try:
            names = sorted(
                n for n in os.listdir(self.out_dir)
                if n.startswith("flightrec-") and n.endswith(".json")
            )
        except OSError:
            return
        for stale in names[:-self.max_dumps]:
            stem = os.path.join(self.out_dir, stale[: -len(".json")])
            for suffix in (".json", ".npz"):
                try:
                    os.remove(stem + suffix)
                except OSError:
                    pass
            self.dumps_pruned += 1
            log.info("flight recorder pruned old dump %s", stem)


def _device_name(device) -> str:
    """``cpu``, or ``cuda:N (<card name>)`` for a CUDA device (a
    dump-time read, never in the round window)."""
    import torch

    if device is None:
        return ""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return str(dev)
    index = dev.index if dev.index is not None else 0
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"


# ---------------------------------------------------------------------------
# dump loading (the replay harness's input side)
# ---------------------------------------------------------------------------


def load_dump(manifest_path: str) -> dict:
    """Load a dump back into record objects.

    Returns ``{"manifest": dict, "records": [RoundRecord |
    ExpressRecord]}``. Tolerant of doctored dumps to the extent of
    raising ``ValueError`` with a reason (unknown format, missing
    blobs) rather than crashing deeper in."""
    if manifest_path.endswith(".npz"):
        manifest_path = manifest_path[: -len(".npz")] + ".json"
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != DUMP_FORMAT:
        raise ValueError(
            f"dump format {manifest.get('format')!r} != supported "
            f"{DUMP_FORMAT}"
        )
    npz_path = manifest_path[: -len(".json")] + ".npz"
    with np.load(npz_path) as z:
        blobs = {k: z[k] for k in z.files}

    def blob(pre, key):
        full = f"{pre}/{key}"
        if full not in blobs:
            raise ValueError(f"dump is missing array {full!r}")
        return blobs[full]

    records = []
    for i, m in enumerate(manifest.get("records", [])):
        pre = f"{i:03d}"
        if m.get("kind") == "express":
            records.append(ExpressRecord(
                round_num=int(m["round_num"]),
                arrivals=m["arrivals"],
                retires=m["retires"],
                removals=m["removals"],
                slot_deltas=m["slot_deltas"],
                result=m.get("result"),
            ))
            continue
        mm = m["meta"]
        meta = GraphMeta(
            **{k: blob(pre, f"meta/{k}") for k in _META_ARRAYS},
            **{k: list(mm[k]) for k in _META_LISTS},
            n_nodes=int(mm["n_nodes"]),
            n_arcs=int(mm["n_arcs"]),
        )
        arrays = {
            k.split("/", 2)[2]: v for k, v in blobs.items()
            if k.startswith(f"{pre}/arrays/")
        }
        cost_kwargs = {
            k: blob(pre, f"ck/{k}")
            for k in m.get("cost_kwargs_present", [])
        }
        warm_seed = None
        if m.get("has_warm_seed"):
            warm_seed = tuple(
                blob(pre, f"warm/{name}")
                for name in ("asg", "lvl", "floor")
            )
        result = None
        if m.get("result") is not None:
            result = dict(m["result"])
            result["assignment"] = blob(pre, "result/assignment")
            result["channel"] = blob(pre, "result/channel")
        records.append(RoundRecord(
            round_num=int(m["round_num"]),
            cost_model=m["cost_model"],
            flags=m.get("flags", {}),
            arrays=arrays,
            meta=meta,
            cost_kwargs=cost_kwargs,
            pad_floors=m.get("pad_floors", {}),
            dims=m.get("dims", {}),
            warm_used=bool(m.get("warm_used")),
            warm_seed=warm_seed,
            rv=m.get("rv", ""),
            stats=m.get("stats"),
            result=result,
        ))
    return {"manifest": manifest, "records": records}
