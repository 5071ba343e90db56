"""Flow decomposition: per-arc flows -> per-task placements.

The solver returns arc flows; tasks routing through aggregators (cluster /
rack) lose their identity inside the aggregate, so the flow must be
decomposed into task->...->machine paths. Firmament does the same
internally before emitting ``SchedulingDelta::PLACE`` records (surface at
reference src/firmament/scheduler_bridge.cc:170-190). Greedy path peeling
is exact here because every task carries exactly one unit of flow.
"""

from __future__ import annotations

import numpy as np

from poseidon_tpu_torch.graph.builder import GraphMeta, NodeRole


def extract_placements(
    flows: np.ndarray, meta: GraphMeta, src: np.ndarray, dst: np.ndarray
) -> dict[str, str | None]:
    """Map each task uid to a machine name, or None if left unscheduled.

    ``flows`` must be non-negative per-arc flows over the REAL arcs (length
    meta.n_arcs); ``src``/``dst`` the real arc endpoints.
    """
    n = meta.n_nodes
    res = np.asarray(flows[: meta.n_arcs]).astype(np.int64).copy()
    src = np.asarray(src[: meta.n_arcs])
    dst = np.asarray(dst[: meta.n_arcs])

    # out-adjacency over arcs with positive flow, rebuilt lazily
    out_arcs: list[list[int]] = [[] for _ in range(n)]
    for a in np.flatnonzero(res > 0):
        out_arcs[src[a]].append(int(a))

    role = meta.node_role
    placements: dict[str, str | None] = {}
    for ti, uid in enumerate(meta.task_uids):
        v = int(meta.task_node[ti])
        path: list[int] = []
        dead = False
        while role[v] not in (NodeRole.MACHINE, NodeRole.UNSCHED, NodeRole.SINK):
            adv = None
            while out_arcs[v]:
                a = out_arcs[v][-1]
                if res[a] > 0:
                    adv = a
                    break
                out_arcs[v].pop()
            if adv is None:
                dead = True
                break
            path.append(adv)
            v = int(dst[adv])
        if dead:
            raise ValueError(
                f"flow decomposition stuck at node {v} for task {uid}; "
                "flows are not a feasible routing of all task supplies"
            )
        for a in path:
            res[a] -= 1
        if role[v] == NodeRole.MACHINE:
            placements[uid] = meta.machine_names[meta.node_machine[v]]
        else:
            placements[uid] = None  # unscheduled (or degenerate direct sink)
    return placements
