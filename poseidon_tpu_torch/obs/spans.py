"""Phase-span profiling: structured span trees in the trace stream.

With ``--trace_profile`` on, every completed round, every express
batch and every stream flush emits ONE ``SPAN`` trace event whose
``detail`` is a self-describing span tree — the per-phase decomposition
the flat ``ROUND`` stats already carry, laid out as intervals so
host/device overlap is visually inspectable:

    {"name": "round", "lane": "watch+pipelined", "dur_ms": 7.1,
     "children": [
       {"name": "observe",   "off_ms": 0.0, "dur_ms": 0.6},
       {"name": "build",     "off_ms": 0.6, "dur_ms": 0.9},
       ...
       {"name": "solve-wait", "off_ms": 5.0, "dur_ms": 1.8,
        "children": [{"name": "fetch-wait", ...}]},
       {"name": "device-solve", "track": "device", ...}]}

Clock contract (trace.py module docstring has the full statement): the
SPAN event's ``timestamp_us`` is WALL clock like every trace event —
correlate across hosts with it, never difference it. All ``dur_ms`` /
``off_ms`` values are measured on the monotonic clock family
(``time.monotonic`` / ``perf_counter``) by the producers, so they are
NTP-step-safe. Offsets are a sequential reconstruction from the phase
durations (phases on one track run back-to-back; the device track
overlaps), not independent stamps.

``chrome_trace`` converts a trace's SPAN events into Chrome-trace /
Perfetto JSON ("trace event format", ``ph: "X"`` complete events) —
load the output in ``chrome://tracing`` or ui.perfetto.dev. Rounds are
anchored on their wall timestamps, so inter-round gaps are real; the
intra-round layout is the reconstruction above.

The builders run inside the bridge's finish/actuate window: pure dict
assembly from host floats the caller already holds, never a device
sync, never a cluster-sized walk. (The stream lane's span tree comes
with that lane.)
"""

from __future__ import annotations

import json


def round_span_tree(
    stats, *, join_ms: float, actuate_ms: float
) -> dict:
    """One round's span tree from its ``SchedulerStats`` plus the two
    finish-side durations only the caller's monotonic stamps know
    (``join_ms``: the solver fetch-join; ``actuate_ms``: delta
    application + trace emission)."""
    children = []
    off = 0.0
    for name, dur in (
        ("observe", stats.observe_ms),
        ("build", stats.build_ms),
        ("dispatch", stats.dispatch_ms),
        ("overlap", stats.overlap_ms),
        ("solve-wait", join_ms),
        ("actuate", actuate_ms),
    ):
        node = {
            "name": name,
            "off_ms": round(off, 3),
            "dur_ms": round(dur, 3),
        }
        if name == "solve-wait" and stats.fetch_wait_ms:
            node["children"] = [{
                "name": "fetch-wait",
                "off_ms": round(off, 3),
                "dur_ms": round(stats.fetch_wait_ms, 3),
            }]
        children.append(node)
        off += dur
    # the device program runs concurrently with the overlap window:
    # anchor it at dispatch end, on its own track
    dev_off = stats.observe_ms + stats.build_ms + stats.dispatch_ms
    children.append({
        "name": "device-solve",
        "track": "device",
        "off_ms": round(dev_off, 3),
        "dur_ms": round(stats.solve_ms, 3),
    })
    return {
        "name": "round",
        "lane": stats.lane or "round",
        "build_mode": stats.build_mode,
        "backend": stats.backend,
        "dur_ms": round(off, 3),
        "children": children,
    }


def emit_span(trace, tree: dict, round_num: int) -> None:
    """One SPAN trace event per tree (the PTA005-declared type)."""
    trace.emit("SPAN", round_num=round_num, detail=tree)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------


def _emit_node(
    out: list[dict], node: dict, t0_us: float, tid: str, pid: int
) -> None:
    ts = t0_us + float(node.get("off_ms", 0.0)) * 1000.0
    dur = float(node.get("dur_ms", 0.0)) * 1000.0
    out.append({
        "name": node.get("name", "span"),
        "ph": "X",
        "ts": ts,
        "dur": dur,
        "pid": pid,
        "tid": node.get("track", tid),
        "cat": "poseidon",
    })
    for child in node.get("children", ()):
        _emit_node(out, child, t0_us, tid, pid)


def chrome_trace(events) -> dict:
    """Convert trace events (``trace.read_trace`` output or any
    iterable of ``TraceEvent``) into a Chrome-trace JSON document.

    Only SPAN events contribute intervals; each tree's root anchors at
    its event's wall ``timestamp_us`` MINUS its duration (spans are
    emitted at finish time), children at root + their reconstructed
    offsets. Lanes become thread names so round / express / device
    tracks stack separately.
    """
    out: list[dict] = []
    tids: set[str] = set()
    for ev in events:
        if ev.event != "SPAN" or not isinstance(ev.detail, dict):
            continue
        tree = ev.detail
        tid = tree.get("lane", "round")
        t0 = float(ev.timestamp_us) - float(
            tree.get("dur_ms", 0.0)
        ) * 1000.0
        root = dict(tree)
        root.setdefault("off_ms", 0.0)
        _emit_node(out, root, t0, tid, pid=1)
        tids.add(tid)
        for node in tree.get("children", ()):
            if "track" in node:
                tids.add(node["track"])
    meta = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
         "args": {"name": f"poseidon:{t}"}}
        for t in sorted(tids)
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_chrome_trace(events, path: str) -> str:
    doc = chrome_trace(events)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def express_span_tree(latency_ms: float, timings: dict) -> dict:
    """One express batch's span tree from its already-measured phase
    timings (prep / upload / solve, ops/resident.py vocabulary).

    The root spans the whole event-to-bind window; the work phases
    tile its END (the batch binds when solve finishes), so any
    event-receipt queue wait renders BEFORE the work — where it
    actually happened — not as a trailing gap."""
    work = sum(
        float(timings.get(n, 0.0))
        for n in ("prep_ms", "upload_ms", "solve_ms")
    )
    children = []
    off = max(latency_ms - work, 0.0)
    if off:
        children.append({
            "name": "e2b-wait",
            "off_ms": 0.0,
            "dur_ms": round(off, 3),
        })
    for name in ("prep_ms", "upload_ms", "solve_ms"):
        dur = float(timings.get(name, 0.0))
        children.append({
            "name": name[:-3],
            "off_ms": round(off, 3),
            "dur_ms": round(dur, 3),
        })
        off += dur
    return {
        "name": "express-batch",
        "lane": "express",
        "dur_ms": round(latency_ms, 3),
        "children": children,
    }


def stream_span_tree(
    latency_ms: float, timings: dict, *, windows: int = 0
) -> dict:
    """One stream flush's span tree (K windows, one fetch): the
    per-window prep/upload phases on the host track (they overlapped the
    previous batch's windows on the device), the padding/stack step and
    the windows' run with its one fetch on the device track."""
    prep = float(timings.get("prep_ms", 0.0))
    upload = float(timings.get("upload_ms", 0.0))
    stack = float(timings.get("stack_ms", 0.0))
    solve = float(timings.get("solve_ms", 0.0))
    work = prep + upload + stack + solve
    children = []
    off = max(latency_ms - work, 0.0)
    if off:
        children.append({
            "name": "accumulate-wait",
            "off_ms": 0.0,
            "dur_ms": round(off, 3),
        })
    for name, dur in (("prep", prep), ("upload", upload)):
        children.append({
            "name": name,
            "off_ms": round(off, 3),
            "dur_ms": round(dur, 3),
        })
        off += dur
    children.append({
        "name": "stack",
        "track": "device",
        "off_ms": round(off, 3),
        "dur_ms": round(stack, 3),
    })
    off += stack
    children.append({
        "name": "scan+fetch",
        "track": "device",
        "off_ms": round(off, 3),
        "dur_ms": round(solve, 3),
    })
    off += solve
    return {
        "name": "stream-flush",
        "lane": "stream",
        "windows": windows,
        "dur_ms": round(max(latency_ms, off), 3),
        "children": children,
    }
