from poseidon_tpu_torch.graph.network import FlowNetwork, pad_bucket
from poseidon_tpu_torch.graph.builder import (
    ArcKind,
    BuilderColumns,
    FlowGraphBuilder,
    GraphMeta,
    NodeRole,
)
from poseidon_tpu_torch.graph.deltas import (
    DeltaKind,
    DeltaSet,
    SchedulingDelta,
    extract_deltas,
)

__all__ = [
    "FlowNetwork", "pad_bucket", "FlowGraphBuilder", "GraphMeta",
    "NodeRole", "ArcKind", "BuilderColumns", "DeltaKind", "DeltaSet",
    "SchedulingDelta", "extract_deltas",
]
