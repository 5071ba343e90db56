"""The port's lock-order detector (poseidon_tpu_torch/analysis/locks.py,
PTA010), held to the reference's tests (``tests/test_locks.py``).

The same snippet pairs — acquisition-order cycles (the self-edge
included: ``threading.Lock`` is non-reentrant) and blocking calls
under a held lock, direct and lifted through call edges, with the
structural recognizers (``.join()`` vs ``",".join``,
``queue.put(block=False)``, the ``Condition.wait`` exemption) — run
against the port's analyzer, plus the port's blocking vocabulary (a
``SyncCounter.read``, ``torch.cuda.synchronize()`` and ``.item()``
under a lock) and the acceptance cases against the port's actuation
journal: its ``rotate()`` fsync (``ha/journal.py:244``) fires without
its reasoned suppression, a re-buried ``intents()`` fsync or an
inverted lock order fires, and an unmodified copy stays clean."""

from __future__ import annotations

import pathlib
import textwrap

from poseidon_tpu_torch.analysis import DEFAULT_CONTRACTS, analyze_tree

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_on(tmp_path, files, contracts=DEFAULT_CONTRACTS):
    paths = []
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        if rel.endswith(".py"):
            paths.append(p)
    violations, _ = analyze_tree(tmp_path, paths, contracts)
    return violations


def pta010(violations):
    return [v for v in violations if v.code == "PTA010"]


MOD = "poseidon_tpu_torch/pkg/mod.py"


class TestLockOrderCycles:
    def test_self_edge_through_call_edge_fires(self, tmp_path):
        """outer() calls inner() with the lock held; inner() takes the
        same lock. threading.Lock is non-reentrant — a single thread
        deadlocks itself on the first call."""
        vs = run_on(tmp_path, {MOD: """\
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def outer(self):
                    with self._lock:
                        self.inner()

                def inner(self):
                    with self._lock:
                        self.n += 1
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "cycle" in hits[0].message
        assert "non-reentrant" in hits[0].message

    def test_two_class_inversion_fires(self, tmp_path):
        """Typed method params (the thread model's _local_types
        inference) give the lock nodes class-scoped owners."""
        vs = run_on(tmp_path, {MOD: """\
            from __future__ import annotations

            import threading

            class A:
                def __init__(self):
                    self._lock = threading.Lock()

                def one(self, b: B):
                    with self._lock:
                        with b._lock:
                            return 1

            class B:
                def __init__(self):
                    self._lock = threading.Lock()

                def two(self, a: A):
                    with self._lock:
                        with a._lock:
                            return 2
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "A._lock" in hits[0].message
        assert "B._lock" in hits[0].message

    def test_consistent_global_order_clean(self, tmp_path):
        """Same two classes, same nesting depth — but both paths take
        A._lock before B._lock. No cycle, no finding."""
        vs = run_on(tmp_path, {MOD: """\
            from __future__ import annotations

            import threading

            class A:
                def __init__(self):
                    self._lock = threading.Lock()

                def one(self, b: B):
                    with self._lock:
                        with b._lock:
                            return 1

            class B:
                def __init__(self):
                    self._lock = threading.Lock()

                def two(self, a: A):
                    with a._lock:
                        with self._lock:
                            return 2
        """})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]


class TestBlockingUnderLock:
    def test_fsync_under_lock_fires(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import os
            import threading

            class Journal:
                def __init__(self, fh):
                    self._lock = threading.Lock()
                    self.fh = fh

                def save(self):
                    with self._lock:
                        self.fh.write("x")
                        os.fsync(self.fh.fileno())
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "'fsync'" in hits[0].message
        assert "Journal._lock" in hits[0].message

    def test_fsync_lifted_through_call_edge_fires(self, tmp_path):
        """The blocking call hides one method deep: save() holds the
        lock, _sync() does the fsync. The summary fixpoint lifts it."""
        vs = run_on(tmp_path, {MOD: """\
            import os
            import threading

            class Journal:
                def __init__(self, fh):
                    self._lock = threading.Lock()
                    self.fh = fh

                def save(self):
                    with self._lock:
                        self._sync()

                def _sync(self):
                    os.fsync(self.fh.fileno())
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "'fsync'" in hits[0].message

    def test_fsync_outside_lock_clean(self, tmp_path):
        """The shipped journal idiom: buffered writes under the lock,
        fd captured, barrier after release."""
        vs = run_on(tmp_path, {MOD: """\
            import os
            import threading

            class Journal:
                def __init__(self, fh):
                    self._lock = threading.Lock()
                    self.fh = fh

                def save(self):
                    with self._lock:
                        self.fh.write("x")
                        self.fh.flush()
                        fd = self.fh.fileno()
                    os.fsync(fd)
        """})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]

    def test_queue_put_block_true_fires(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import queue
            import threading

            class Pump:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.q = queue.Queue(maxsize=4)

                def push(self, item):
                    with self._lock:
                        self.q.put(item)
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "'put'" in hits[0].message

    def test_queue_put_nonblocking_clean(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import queue
            import threading

            class Pump:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.q = queue.Queue(maxsize=4)

                def push(self, item):
                    with self._lock:
                        self.q.put(item, block=False)
        """})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]

    def test_thread_join_fires_string_join_clean(self, tmp_path):
        """.join() with no positional args is a thread join (a timeout
        keyword still blocks for the timeout); ','.join(xs) and
        os.path.join(a, b) carry positional args and are string ops."""
        vs = run_on(tmp_path, {MOD: """\
            import os.path
            import threading

            class Owner:
                def __init__(self, worker):
                    self._lock = threading.Lock()
                    self.worker = worker

                def stop(self):
                    with self._lock:
                        self.worker.join(timeout=2.0)

                def label(self, parts):
                    with self._lock:
                        return ",".join(parts) + os.path.join("a", "b")
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "'join'" in hits[0].message
        assert hits[0].line < 15  # the thread join, not the string ops

    def test_sleep_under_lock_fires(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import threading
            import time

            class Delayer:
                def __init__(self):
                    self._lock = threading.Lock()

                def poke(self):
                    with self._lock:
                        time.sleep(0.01)
        """})
        hits = pta010(vs)
        assert len(hits) == 1, [v.message for v in vs]
        assert "'sleep'" in hits[0].message

    def test_condition_wait_exempt(self, tmp_path):
        """Condition.wait RELEASES the lock while blocked — waiting
        under the condition's own lock is the designed idiom."""
        vs = run_on(tmp_path, {MOD: """\
            import threading

            class Gate:
                def __init__(self):
                    self._cond = threading.Condition()
                    self.ready = False

                def await_ready(self):
                    with self._cond:
                        while not self.ready:
                            self._cond.wait()
        """})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]

    def test_reasoned_noqa_suppresses(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import os
            import threading

            class Journal:
                def __init__(self, fh):
                    self._lock = threading.Lock()
                    self.fh = fh

                def swap(self):
                    with self._lock:
                        os.fsync(self.fh.fileno())  # noqa: PTA010 -- lock must cover the swap
        """})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]

    def test_tests_dir_not_enforced(self, tmp_path):
        """Test helpers block under locks all the time (joins in
        teardown); PTA010's scope excludes tests/ like the other
        concurrency rules."""
        vs = run_on(tmp_path, {"tests/helper.py": """\
            import os
            import threading

            class Helper:
                def __init__(self, fh):
                    self._lock = threading.Lock()
                    self.fh = fh

                def save(self):
                    with self._lock:
                        os.fsync(self.fh.fileno())
        """})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]


class TestPTA010Acceptance:
    """Negative injections against the REAL tree (the PR 10
    discipline): re-introducing the fixed fsync-under-lock, or
    inverting a lock order, must fail CI."""

    JOURNAL = "poseidon_tpu_torch/ha/journal.py"

    def test_reburied_journal_fsync_fires(self, tmp_path):
        """Move intents()' fsync barrier back inside the lock — the
        exact bug this wave's journal fix removed."""
        src = (REPO / self.JOURNAL).read_text()
        anchor = (
            "            self._fh.flush()\n"
            "            fd = self._fh.fileno()\n"
        )
        assert anchor in src, "journal anchor moved: update the test"
        bad = src.replace(anchor, (
            "            self._fh.flush()\n"
            "            if self.fsync:\n"
            "                os.fsync(self._fh.fileno())\n"
            "            fd = self._fh.fileno()\n"
        ), 1)
        vs = run_on(tmp_path, {self.JOURNAL: bad})
        hits = pta010(vs)
        assert any(
            "'fsync'" in v.message
            and "ActuationJournal.intents" in v.message
            for v in hits
        ), [v.message for v in vs]

    def test_inverted_mark_lock_order_fires(self, tmp_path):
        """Give _mark a second lock taken in one order and intents the
        opposite order: the classic two-lock inversion, injected into
        the real journal class."""
        src = (REPO / self.JOURNAL).read_text()
        init_anchor = "        self._lock = threading.Lock()\n"
        assert init_anchor in src
        bad = src.replace(
            init_anchor,
            init_anchor + "        self._io_lock = threading.Lock()\n",
            1,
        )
        intents_anchor = (
            "        with self._lock:\n"
            "            for op in ops:\n"
        )
        assert intents_anchor in bad, "intents anchor moved"
        bad = bad.replace(intents_anchor, (
            "        with self._lock:\n"
            "          with self._io_lock:\n"
            "            for op in ops:\n"
        ), 1)
        mark_anchor = (
            "        with self._lock:\n"
            "            if self._fh.closed:\n"
            "                return\n"
        )
        assert mark_anchor in bad, "_mark anchor moved"
        bad = bad.replace(mark_anchor, (
            "        with self._io_lock:\n"
            "          with self._lock:\n"
            "            if self._fh.closed:\n"
            "                return\n"
        ), 1)
        vs = run_on(tmp_path, {self.JOURNAL: bad})
        hits = [v for v in pta010(vs) if "cycle" in v.message]
        assert any(
            "ActuationJournal._lock" in v.message
            and "ActuationJournal._io_lock" in v.message
            for v in hits
        ), [v.message for v in vs]

    def test_unmodified_journal_stays_clean(self, tmp_path):
        """The shipped journal — including rotate()'s sanctioned
        in-lock fsync — is PTA010-clean."""
        src = (REPO / self.JOURNAL).read_text()
        vs = run_on(tmp_path, {self.JOURNAL: src})
        assert pta010(vs) == [], [v.message for v in pta010(vs)]


class TestTorchBlockingVocabulary:
    def test_device_waits_under_a_lock_fire(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import threading

            import torch

            class Fetcher:
                def __init__(self):
                    self._lock = threading.Lock()

                def fetch(self, x):
                    with self._lock:
                        h = self._fetches.read(x)
                        torch.cuda.synchronize()
                        return h, x.item()
        """})
        kinds = sorted(v.message.split("'")[1] for v in pta010(vs))
        assert kinds == ["item", "read", "synchronize"], \
            [v.message for v in vs]

    def test_device_waits_after_release_clean(self, tmp_path):
        vs = run_on(tmp_path, {MOD: """\
            import threading

            class Fetcher:
                def __init__(self):
                    self._lock = threading.Lock()

                def fetch(self, x):
                    with self._lock:
                        y = x
                    return self._fetches.read(y)
        """})
        assert pta010(vs) == []


def test_rotate_fsync_fires_without_its_suppression(tmp_path):
    """The journal's sanctioned in-lock fsync (rotate(): the lock covers
    the tmp -> live swap) is a live PTA010 finding: the reasoned noqa
    on it is load-bearing."""
    rel = "poseidon_tpu_torch/ha/journal.py"
    src = (REPO / rel).read_text()
    noqa = ("  # noqa: PTA010 -- lock must cover the tmp->live swap; see "
            "comment above")
    assert noqa in src
    line = next(i for i, ln in enumerate(src.splitlines(), 1) if noqa in ln)
    vs = run_on(tmp_path, {rel: src.replace(noqa, "", 1)})
    hits = pta010(vs)
    assert [(v.line, "rotate" in v.message) for v in hits] == [(line, True)]
