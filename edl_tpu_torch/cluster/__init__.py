"""Cluster inventory & actuation layer (role of reference pkg/cluster.go) —
the port's copy of edl_tpu.cluster's interface and in-memory fake."""

from edl_tpu_torch.cluster.base import (Cluster, ConflictError, PodCounts,
                                        PodPhase)
from edl_tpu_torch.cluster.fake import FakeCluster, FakeNode, FakePod
from edl_tpu_torch.cluster.resource import ClusterResource, NodeResources

__all__ = [
    "ClusterResource",
    "NodeResources",
    "Cluster",
    "ConflictError",
    "PodPhase",
    "PodCounts",
    "FakeCluster",
    "FakeNode",
    "FakePod",
]
