"""Cluster inventory & actuation layer (role of reference pkg/cluster.go) —
the port's copy of edl_tpu.cluster: the interface, the in-memory fake, the
process-backed kubelet that runs its pods, and the Kubernetes backend."""

from edl_tpu_torch.cluster.base import (Cluster, ConflictError, PodCounts,
                                        PodPhase)
from edl_tpu_torch.cluster.exec_kubelet import ProcessKubelet
from edl_tpu_torch.cluster.fake import FakeCluster, FakeNode, FakePod
from edl_tpu_torch.cluster.k8s import K8sCluster, PodView
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
    "K8sCluster",
    "PodView",
    "ProcessKubelet",
]
