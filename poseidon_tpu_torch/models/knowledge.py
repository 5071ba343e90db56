"""KnowledgeBase': bounded ring buffers of cluster utilization samples.

The reference feeds node/pod utilization into Firmament's KnowledgeBase
every poll tick (reference src/firmament/knowledge_base_populator.cc:65-99:
``AddMachineSample`` / ``AddTaskSample``), bounded by
``--max_sample_queue_size=100`` (reference deploy/poseidon.cfg:5); the cost
models price interference and load from those samples (SURVEY.md section
2.2). Here the store is a fixed-shape numpy ring per machine/task so the
aggregates the cost models consume are O(1) vectorized reductions, ready
to ship to device as dense arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_QUEUE_SIZE = 100  # reference deploy/poseidon.cfg:5


@dataclasses.dataclass(frozen=True)
class MachineSample:
    """One utilization sample for a machine.

    Mirrors the fields the reference's populator fills into
    ``MachinePerfStatisticsSample`` (knowledge_base_populator.cc:68-81):
    free RAM and per-cpu idle fraction (the reference fabricates idle from
    allocatable/capacity counts, :35-63 — here it is a real input).
    """

    cpu_idle: float        # [0, 1] fraction of CPU idle
    mem_free_frac: float   # [0, 1] fraction of memory free


@dataclasses.dataclass(frozen=True)
class TaskSample:
    """One usage sample for a running task (TaskPerfStatisticsSample,
    knowledge_base_populator.cc:84-99, plus the final-report fields the
    reference stubs out at :101-113)."""

    cpu_usage: float       # cores actually used
    mem_usage_kb: int


class _RingStore:
    """2-D sample rings: one row per name, running sums for O(1) means.

    A per-name Python loop would sit inside the priced path at 12k
    machines every round. Storage here is ``[n_fields, rows, queue_size]`` with a
    per-row running sum maintained on insert (overwrite subtracts the
    evicted sample), so an aggregate over N names is one gather +
    divide. The only per-name Python left is the name->row dict lookup
    (~1 ms for 12k names).
    """

    def __init__(self, queue_size: int, n_fields: int):
        self.queue_size = queue_size
        self.n_fields = n_fields
        self._idx: dict[str, int] = {}
        self._free: list[int] = []   # rows of retired names, reusable
        cap = 256
        self._buf = np.zeros((n_fields, cap, queue_size), np.float32)
        self._sum = np.zeros((n_fields, cap), np.float64)
        self._count = np.zeros(cap, np.int64)

    def _row(self, name: str) -> int:
        row = self._idx.get(name)
        if row is None:
            if self._free:
                row = self._free.pop()
            else:
                row = len(self._idx)
                if row >= self._count.shape[0]:
                    cap = self._count.shape[0] * 2
                    self._buf = np.concatenate(
                        [self._buf, np.zeros_like(self._buf)], axis=1
                    )
                    self._sum = np.concatenate(
                        [self._sum, np.zeros_like(self._sum)], axis=1
                    )
                    self._count = np.concatenate(
                        [self._count, np.zeros(cap // 2, np.int64)]
                    )
            self._idx[name] = row
        return row

    def retire(self, name: str) -> None:
        """Free a name's row for reuse (a forever-running daemon with
        pod churn must not grow a ring per retired uid forever)."""
        row = self._idx.pop(name, None)
        if row is not None:
            self._buf[:, row, :] = 0
            self._sum[:, row] = 0
            self._count[row] = 0
            self._free.append(row)

    def add(self, name: str, *values: float) -> None:
        row = self._row(name)
        slot = self._count[row] % self.queue_size
        for f, v in enumerate(values):
            # accumulate the float32-rounded value the buffer stores, so
            # the eventual eviction subtracts exactly what was added (a
            # full-precision add would leave a permanent residual per
            # sample — unbounded drift in a forever-running daemon)
            v32 = np.float32(v)
            self._sum[f, row] += float(v32) - float(self._buf[f, row, slot])
            self._buf[f, row, slot] = v32
        self._count[row] += 1

    def export_state(self) -> dict:
        """Host-array snapshot for checkpointing (ha/checkpoint.py).

        The rings mutate in place every observe tick, so the arrays are
        copied here; ``restore_state`` of the returned dict reproduces
        the store bit-exactly — the aggregates the cost models consume
        are running sums over these buffers, so a restored scheduler
        prices the next round from the same utilization history the
        crashed one held, not from one cold re-observed sample.
        """
        return {
            "buf": np.array(self._buf, copy=True),
            "sum": np.array(self._sum, copy=True),
            "count": np.array(self._count, copy=True),
            "idx": dict(self._idx),
            "free": list(self._free),
            "queue_size": self.queue_size,
        }

    def restore_state(self, state: dict) -> None:
        """Adopt an ``export_state`` snapshot wholesale."""
        if int(state["queue_size"]) != self.queue_size:
            raise ValueError(
                f"checkpointed queue_size {state['queue_size']} != "
                f"configured {self.queue_size}"
            )
        self._buf = np.array(state["buf"], np.float32, copy=True)
        self._sum = np.array(state["sum"], np.float64, copy=True)
        self._count = np.array(state["count"], np.int64, copy=True)
        self._idx = {str(k): int(v) for k, v in state["idx"].items()}
        self._free = [int(r) for r in state["free"]]

    def means(
        self, names: list[str], field: int, default: float
    ) -> np.ndarray:
        n = len(names)
        rows = np.fromiter(
            (self._idx.get(name, -1) for name in names), np.int64, n
        )
        r = np.maximum(rows, 0)
        denom = np.minimum(self._count[r], self.queue_size)
        out = np.where(
            (rows >= 0) & (denom > 0),
            self._sum[field][r] / np.maximum(denom, 1),
            default,
        )
        return out.astype(np.float32)


class KnowledgeBase:
    """Fixed-capacity sample rings keyed by machine / task name.

    ``machine_load()`` and friends return dense arrays aligned to a caller
    -supplied name order, so cost models can consume them directly as
    device arrays.
    """

    def __init__(self, queue_size: int = DEFAULT_QUEUE_SIZE):
        if queue_size <= 0:
            raise ValueError("queue_size must be positive")
        self.queue_size = queue_size
        self._machines = _RingStore(queue_size, 2)
        self._tasks = _RingStore(queue_size, 2)

    # ---- ingestion ----

    def add_machine_sample(self, name: str, sample: MachineSample) -> None:
        self._machines.add(name, sample.cpu_idle, sample.mem_free_frac)

    def add_task_sample(self, uid: str, sample: TaskSample) -> None:
        self._tasks.add(uid, sample.cpu_usage, float(sample.mem_usage_kb))

    def retire_task(self, uid: str) -> None:
        """Drop a retired pod's ring (called when the bridge retires it)."""
        self._tasks.retire(uid)

    def retire_machine(self, name: str) -> None:
        """Drop a removed node's ring."""
        self._machines.retire(name)

    # ---- aggregates (dense, order given by the caller) ----

    def machine_cpu_idle(self, names: list[str]) -> np.ndarray:
        """Mean idle fraction per machine; 1.0 (fully idle) if unsampled."""
        return self._machines.means(names, 0, 1.0)

    def machine_mem_free(self, names: list[str]) -> np.ndarray:
        return self._machines.means(names, 1, 1.0)

    def machine_load(self, names: list[str]) -> np.ndarray:
        """1 - idle: the load signal Octopus/CoCo price (0 if unsampled)."""
        return 1.0 - self.machine_cpu_idle(names)

    def task_cpu_usage(self, uids: list[str]) -> np.ndarray:
        return self._tasks.means(uids, 0, 0.0)

    # ---- checkpoint/restore (ha/checkpoint.py) ----

    def export_state(self) -> dict:
        """Both stores' ring state, copied (see ``_RingStore``)."""
        return {
            "queue_size": self.queue_size,
            "machines": self._machines.export_state(),
            "tasks": self._tasks.export_state(),
        }

    def restore_state(self, state: dict) -> None:
        if int(state["queue_size"]) != self.queue_size:
            raise ValueError(
                f"checkpointed queue_size {state['queue_size']} != "
                f"configured {self.queue_size}"
            )
        self._machines.restore_state(state["machines"])
        self._tasks.restore_state(state["tasks"])
