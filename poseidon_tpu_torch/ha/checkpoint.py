"""Atomic warm-state checkpoints + the warm restore path.

What a checkpoint carries (the full warm surface a restart loses):

- the **warm solve seed** — the host (asg, lvl, floor) mirror of the
  device ``DenseState`` that the round's ONE result fetch already
  brought back (``ResidentSolver.warm_seed_host``, the same seam the
  flight recorder rides), stored as numpy — so the first post-restore
  round warm-starts on the solver's device instead of solving cold,
  and a checkpoint adds no device sync;
- the solver's **grow-only padding floors** (``pad_floors``) — so the
  restored round pads to the same Tp/Mp and reuses the kernels'
  cached launch plans across the restart;
- the **bridge pod/machine state machine** — tasks (with their
  bridge-internal ``wait_rounds`` aging), machines, both in dict
  insertion order (the pending order every graph build depends on);
- the **KnowledgeBase sample rings** — the utilization history the
  cost models price from (without it the restored round would price
  from one cold sample and diverge);
- the **incremental-builder columns** (when checkpoint-clean) — so the
  first post-restore build patches O(churn) instead of re-walking the
  cluster; the builder's own self-heal verify guards adoption;
- the **watch resourceVersion** per resource — so the restored watcher
  resumes the event stream exactly where the dead one stopped (a
  compacted rv degrades to the loud 410 resync path, never a guess).

Write discipline: capture is a cheap loop-thread snapshot (dict
copies of the bridge maps — Task/Machine are frozen dataclasses and
the builder columns are copy-on-write, so references stay frozen; the
knowledge rings mutate in place and are the one real copy).
Serialization + disk I/O run on a background writer thread, off the
round's critical path: arrays into ``<stem>.npz`` (tmp + fsync +
rename), then the manifest into ``<stem>.json`` (tmp + fsync + rename)
carrying the npz's SHA-256. A torn write therefore leaves either an
ignored ``*.tmp`` or an npz without a manifest — ``load_latest`` walks
manifests newest-first, verifies the checksum, and falls back to the
previous complete checkpoint on any damage.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import queue
import threading
import time

import numpy as np

from poseidon_tpu_torch.cluster import Machine, Task, TaskPhase
from poseidon_tpu_torch.graph.builder import BuilderColumns

log = logging.getLogger(__name__)

# the checkpoint format version (manifest "format"): bump on layout
# changes so restore refuses snapshots it would misread
CKPT_FORMAT = 1

# numeric BuilderColumns fields riding the npz; the object-dtype
# columns (uids/jobs/run_uids/run_job) ride the manifest as lists
_COLS_NUMERIC = (
    "m_rack", "m_max", "used_slots", "job_idx", "job_counts", "wait",
    "pref_counts", "pref_m", "pref_r", "pref_w", "cpu_milli", "mem_kb",
    "run_machine", "run_wait", "run_cpu", "run_mem", "run_pref_counts",
    "run_pref_m", "run_pref_r", "run_pref_w",
)
_COLS_OBJECT = ("uids", "jobs", "run_uids", "run_job")


@dataclasses.dataclass
class CheckpointSnapshot:
    """One captured warm-state image (host-side, write-ready)."""

    round_num: int
    cost_model: str
    flags: dict
    tasks: list[Task]            # bridge insertion order (load-bearing)
    machines: list[Machine]      # bridge insertion order
    knowledge: dict              # KnowledgeBase.export_state (copies)
    pad_floors: dict
    warm_seed: tuple | None      # host (asg, lvl, floor) or None
    cols: BuilderColumns | None  # patchable builder columns or None
    rv: dict[str, int]           # per-resource watch position
    created_unix: float = 0.0


def _task_doc(t: Task) -> dict:
    return {
        "uid": t.uid, "ns": t.namespace, "job": t.job,
        "cpu": t.cpu_request, "mem": t.memory_request_kb,
        "phase": t.phase.value, "machine": t.machine,
        "prefs": dict(t.data_prefs), "wait": t.wait_rounds,
    }


def _task_from_doc(d: dict) -> Task:
    return Task(
        uid=d["uid"], namespace=d["ns"], job=d["job"],
        cpu_request=float(d["cpu"]), memory_request_kb=int(d["mem"]),
        phase=TaskPhase(d["phase"]), machine=d["machine"],
        data_prefs={k: int(v) for k, v in d["prefs"].items()},
        wait_rounds=int(d["wait"]),
    )


def _machine_doc(m: Machine) -> dict:
    return {
        "name": m.name, "cpu_cap": m.cpu_capacity,
        "cpu_alloc": m.cpu_allocatable,
        "mem_cap": m.memory_capacity_kb,
        "mem_alloc": m.memory_allocatable_kb,
        "rack": m.rack, "max_tasks": m.max_tasks,
    }


def _machine_from_doc(d: dict) -> Machine:
    return Machine(
        name=d["name"], cpu_capacity=float(d["cpu_cap"]),
        cpu_allocatable=float(d["cpu_alloc"]),
        memory_capacity_kb=int(d["mem_cap"]),
        memory_allocatable_kb=int(d["mem_alloc"]),
        rack=d["rack"], max_tasks=int(d["max_tasks"]),
    )


def capture_snapshot(bridge, watcher=None) -> CheckpointSnapshot:
    """Snapshot a bridge's warm state (loop thread, post-round).

    Cheap by design: the task/machine maps shallow-copy (their values
    are frozen dataclasses the bridge replaces, never mutates), the
    warm seed and builder columns are references frozen by the
    copy-on-write discipline, and only the knowledge rings — which DO
    mutate in place — are copied. Amortized over the ``--checkpoint_
    every`` cadence; no device tensor is read (the warm seed is the
    host mirror the round's fetch already holds).
    """
    solver = bridge.solver
    graph = getattr(bridge, "_graph", None)
    cols = graph.checkpoint_columns() if graph is not None else None
    rv: dict[str, int] = {}
    if watcher is not None:
        rv = watcher.applied_rvs
    return CheckpointSnapshot(
        round_num=bridge.round_num,
        cost_model=str(bridge.cost_model),
        flags={
            "enable_preemption": bridge.enable_preemption,
            "migration_hysteresis": bridge.migration_hysteresis,
            "max_migrations_per_round": bridge.max_migrations_per_round,
            "express_lane": bridge.express_lane,
            "incremental_build": bridge.incremental_build,
            "mesh_width": getattr(solver, "mesh_width", 0),
            "aggregate_classes": getattr(
                solver, "aggregate_classes", False
            ),
            "topk_prefs": getattr(solver, "topk_prefs", 0),
        },
        tasks=list(bridge.tasks.values()),
        machines=list(bridge.machines.values()),
        knowledge=bridge.knowledge.export_state(),
        pad_floors=dict(getattr(solver, "pad_floors", {})),
        warm_seed=getattr(solver, "warm_seed_host", None),
        cols=cols,
        rv=rv,
        created_unix=time.time(),
    )


class CheckpointManager:
    """Owns one checkpoint directory: capture, background writes,
    pruning, loading.

    Threading: ``capture``/``write_sync``/``load_latest`` run on the
    loop thread; ``submit`` hands a snapshot to the writer thread
    through a ``queue.Queue`` (snapshots are immutable after capture —
    frozen dataclasses + copy-on-write arrays — so the queue IS the
    handoff). Writer statistics are read and written under ``_lock``
    on both sides. The same manifest, npz layout and ``CKPT_FORMAT``
    as the reference's, so either package restores the other's
    checkpoints.
    """

    def __init__(
        self,
        out_dir: str,
        *,
        keep: int = 2,
        fsync: bool = True,
        metrics=None,
        crash_hook=None,
    ):
        self.out_dir = out_dir
        self.keep = max(int(keep), 1)
        self.fsync = fsync
        self.metrics = metrics
        # fault-injection seam (tests/test_ha.py crash fuzz): called
        # with a named kill point; raising there simulates a process
        # death at exactly that boundary. None in production.
        self.crash_hook = crash_hook
        self._lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._halt = threading.Event()
        self._thread: threading.Thread | None = None
        self._seq = 0
        # boot-unique, lexicographically-monotonic stem token (epoch
        # milliseconds): a restarted daemon's round numbers can RESET
        # (--restore=false cold start), and round-numbered stems alone
        # would then sort the fresh boot's checkpoints BEFORE the dead
        # boot's — _prune would delete the new ones and load_latest
        # would resurrect the ancient state. Same trick as the flight
        # recorder's boot token.
        self._boot = f"{int(time.time() * 1000):015d}"
        # writer stats (guarded by _lock on both threads)
        self.writes_total = 0
        self.write_failures = 0
        self.last_path = ""
        self.last_bytes = 0
        self.last_unix = 0.0

    # ---- capture (loop thread) --------------------------------------

    def capture(self, bridge, watcher=None) -> CheckpointSnapshot:
        return capture_snapshot(bridge, watcher)

    # ---- the background writer ----------------------------------------

    def submit(self, snap: CheckpointSnapshot) -> None:
        """Queue a snapshot for the writer thread (latest wins: a slow
        disk drops the OLDEST queued snapshot, never blocks a round)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._write_loop, name="ckpt-writer", daemon=True
            )
            self._thread.start()
        while True:
            try:
                self._queue.put_nowait(snap)
                return
            except queue.Full:
                try:
                    dropped = self._queue.get_nowait()
                    log.warning(
                        "checkpoint writer lagging; dropping queued "
                        "round-%d snapshot", dropped.round_num,
                    )
                except queue.Empty:
                    pass

    def _write_loop(self) -> None:  # pta: background-thread
        while not self._halt.is_set():
            try:
                snap = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if snap is None:
                return
            try:
                self.write_sync(snap)
            except Exception:
                with self._lock:
                    self.write_failures += 1
                log.exception("checkpoint write failed")

    def close(self, final_snap: CheckpointSnapshot | None = None) -> None:
        """Drain the writer; optionally write one final synchronous
        checkpoint (the graceful-shutdown path)."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=10.0)
            self._halt.set()
            self._thread = None
        if final_snap is not None:
            self.write_sync(final_snap)

    # ---- serialization (writer thread or shutdown path) ---------------

    def write_sync(self, snap: CheckpointSnapshot) -> str:
        """Serialize + atomically publish one snapshot; returns the
        manifest path."""
        os.makedirs(self.out_dir, exist_ok=True)
        with self._lock:
            self._seq += 1
            seq = self._seq
        stem = os.path.join(
            self.out_dir,
            f"ckpt-{self._boot}-r{snap.round_num:08d}-{seq:04d}",
        )
        if self.crash_hook is not None:
            self.crash_hook("pre-write")
        blobs: dict[str, np.ndarray] = {}
        if snap.warm_seed is not None:
            for name, arr in zip(("asg", "lvl", "floor"),
                                 snap.warm_seed):
                blobs[f"warm/{name}"] = np.asarray(arr)
        for store, pre in ((snap.knowledge["machines"], "know_m"),
                           (snap.knowledge["tasks"], "know_t")):
            for k in ("buf", "sum", "count"):
                blobs[f"{pre}/{k}"] = store[k]
        if snap.cols is not None:
            for k in _COLS_NUMERIC:
                blobs[f"cols/{k}"] = getattr(snap.cols, k)
        npz_tmp = stem + ".npz.tmp"
        with open(npz_tmp, "wb") as fh:
            np.savez_compressed(fh, **blobs)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        if self.crash_hook is not None:
            self.crash_hook("mid-write")  # npz staged, nothing published
        os.replace(npz_tmp, stem + ".npz")
        sha = hashlib.sha256()
        with open(stem + ".npz", "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                sha.update(chunk)
        nbytes = os.path.getsize(stem + ".npz")
        manifest = {
            "format": CKPT_FORMAT,
            "round_num": snap.round_num,
            "cost_model": snap.cost_model,
            "flags": snap.flags,
            "rv": snap.rv,
            "pad_floors": snap.pad_floors,
            "has_warm_seed": snap.warm_seed is not None,
            "created_unix": snap.created_unix,
            "npz_sha256": sha.hexdigest(),
            "npz_bytes": nbytes,
            "tasks": [_task_doc(t) for t in snap.tasks],
            "machines": [_machine_doc(m) for m in snap.machines],
            "knowledge": {
                "queue_size": snap.knowledge["queue_size"],
                "m_idx": snap.knowledge["machines"]["idx"],
                "m_free": snap.knowledge["machines"]["free"],
                "t_idx": snap.knowledge["tasks"]["idx"],
                "t_free": snap.knowledge["tasks"]["free"],
            },
            "cols": (
                None if snap.cols is None else {
                    "machine_names": list(snap.cols.machine_names),
                    "racks": list(snap.cols.racks),
                    **{
                        k: getattr(snap.cols, k).tolist()
                        for k in _COLS_OBJECT
                    },
                }
            ),
        }
        json_tmp = stem + ".json.tmp"
        with open(json_tmp, "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        if self.crash_hook is not None:
            self.crash_hook("pre-manifest")  # npz live, manifest staged
        os.replace(json_tmp, stem + ".json")
        total = nbytes + os.path.getsize(stem + ".json")
        with self._lock:
            self.writes_total += 1
            self.last_path = stem + ".json"
            self.last_bytes = total
            self.last_unix = time.time()
        if self.metrics is not None:
            self.metrics.record_checkpoint(total)
        self._prune()
        log.info(
            "checkpoint round %d written to %s (%d bytes)",
            snap.round_num, stem + ".json", total,
        )
        return stem + ".json"

    def _prune(self) -> None:
        """Keep the newest ``keep`` complete checkpoints + drop stale
        tmp files (a crashed writer's leftovers)."""
        try:
            names = sorted(os.listdir(self.out_dir))
        except OSError:
            return
        manifests = [n for n in names if n.startswith("ckpt-")
                     and n.endswith(".json")]
        for stale in manifests[:-self.keep]:
            stem = os.path.join(
                self.out_dir, stale[: -len(".json")]
            )
            for suffix in (".json", ".npz"):
                try:
                    os.remove(stem + suffix)
                except OSError:
                    pass
        for n in names:
            if n.startswith("ckpt-") and n.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.out_dir, n))
                except OSError:
                    pass

    # ---- age bookkeeping (loop thread, per round) --------------------

    def record_age(self) -> float:
        """Update the checkpoint-age gauge from the last completed
        write; called per round from the daemon loop (host floats
        only)."""
        with self._lock:
            last = self.last_unix
        age = (time.time() - last) if last else -1.0
        if self.metrics is not None and last:
            self.metrics.record_checkpoint_age(age)
        return age

    def load_latest(self) -> CheckpointSnapshot | None:
        return load_latest(self.out_dir)


# ---------------------------------------------------------------------------
# loading + restore
# ---------------------------------------------------------------------------


def _load_one(manifest_path: str) -> CheckpointSnapshot:
    with open(manifest_path) as fh:
        m = json.load(fh)
    if m.get("format") != CKPT_FORMAT:
        raise ValueError(
            f"checkpoint format {m.get('format')!r} != supported "
            f"{CKPT_FORMAT}"
        )
    npz_path = manifest_path[: -len(".json")] + ".npz"
    sha = hashlib.sha256()
    with open(npz_path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            sha.update(chunk)
    if sha.hexdigest() != m["npz_sha256"]:
        raise ValueError(f"{npz_path}: checksum mismatch (torn write?)")
    with np.load(npz_path) as z:
        blobs = {k: z[k] for k in z.files}
    warm_seed = None
    if m.get("has_warm_seed"):
        warm_seed = tuple(
            blobs[f"warm/{name}"] for name in ("asg", "lvl", "floor")
        )
    km = m["knowledge"]
    knowledge = {
        "queue_size": int(km["queue_size"]),
        "machines": {
            "buf": blobs["know_m/buf"], "sum": blobs["know_m/sum"],
            "count": blobs["know_m/count"],
            "idx": km["m_idx"], "free": km["m_free"],
            "queue_size": int(km["queue_size"]),
        },
        "tasks": {
            "buf": blobs["know_t/buf"], "sum": blobs["know_t/sum"],
            "count": blobs["know_t/count"],
            "idx": km["t_idx"], "free": km["t_free"],
            "queue_size": int(km["queue_size"]),
        },
    }
    cols = None
    if m.get("cols") is not None:
        cm = m["cols"]
        machine_names = list(cm["machine_names"])
        cols = BuilderColumns(
            machine_names=machine_names,
            midx={n: i for i, n in enumerate(machine_names)},
            racks=list(cm["racks"]),
            **{
                k: np.array(cm[k], dtype=object)
                for k in _COLS_OBJECT
            },
            **{k: blobs[f"cols/{k}"] for k in _COLS_NUMERIC},
        )
    return CheckpointSnapshot(
        round_num=int(m["round_num"]),
        cost_model=m["cost_model"],
        flags=dict(m.get("flags", {})),
        tasks=[_task_from_doc(d) for d in m["tasks"]],
        machines=[_machine_from_doc(d) for d in m["machines"]],
        knowledge=knowledge,
        pad_floors={k: int(v) for k, v in m["pad_floors"].items()},
        warm_seed=warm_seed,
        cols=cols,
        rv={k: int(v) for k, v in m.get("rv", {}).items()},
        created_unix=float(m.get("created_unix", 0.0)),
    )


def load_latest(out_dir: str) -> CheckpointSnapshot | None:
    """Newest loadable checkpoint in ``out_dir``, or None.

    Torn-write tolerant: manifests are tried newest-first; a damaged
    one (missing/corrupt npz, checksum mismatch, unparseable JSON)
    logs a warning and falls back to the previous complete checkpoint
    instead of failing the restore outright.
    """
    try:
        names = sorted(os.listdir(out_dir), reverse=True)
    except OSError:
        return None
    for name in names:
        if not (name.startswith("ckpt-") and name.endswith(".json")):
            continue
        path = os.path.join(out_dir, name)
        try:
            return _load_one(path)
        except (OSError, ValueError, KeyError) as e:
            log.warning(
                "checkpoint %s unloadable (%s); trying the previous "
                "one", path, e,
            )
    return None


def restore_bridge(bridge, snap: CheckpointSnapshot) -> dict[str, int]:
    """Rehydrate a freshly-constructed bridge from a snapshot; returns
    the checkpointed watch rv map (for ``ClusterWatcher.resume``).

    The warm solve seed is only adopted when the snapshot's cost model
    matches the bridge's — a seed priced by a different model would
    warm-start the auction from prices the first round never computed.
    Pad floors restore regardless (they are shape state, not prices).
    Mismatched preemption mode drops the builder columns the same way
    (the running block exists only in rebalancing mode).
    """
    bridge.restore_state(
        machines=snap.machines,
        tasks=snap.tasks,
        round_num=snap.round_num,
        knowledge_state=snap.knowledge,
        builder_cols=(
            snap.cols
            if bool(snap.flags.get("enable_preemption"))
            == bridge.enable_preemption
            else None
        ),
    )
    warm = snap.warm_seed
    if warm is not None and snap.cost_model != str(bridge.cost_model):
        log.warning(
            "checkpoint cost model %s != configured %s; dropping the "
            "warm solve seed (floors still restore)",
            snap.cost_model, bridge.cost_model,
        )
        warm = None
    bridge.solver.restore_for_replay(snap.pad_floors or None, warm)
    return dict(snap.rv)
