"""Kubernetes API client, watch subsystem + fake apiserver fixture."""

from poseidon_tpu_torch.apiclient.client import (
    K8sApiClient,
    parse_cpu,
    parse_memory_kb,
)
from poseidon_tpu_torch.apiclient.fake_server import FakeApiServer
from poseidon_tpu_torch.apiclient.watch import ClusterWatcher, ObserveDelta

__all__ = [
    "K8sApiClient",
    "FakeApiServer",
    "ClusterWatcher",
    "ObserveDelta",
    "parse_cpu",
    "parse_memory_kb",
]
