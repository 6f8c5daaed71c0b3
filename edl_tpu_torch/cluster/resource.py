"""Cluster resource snapshot — the value type the planner plans over; the
port's copy of edl_tpu.cluster.resource, with the accelerator dimension
GPU cards (as in the original system) and NVLink domains where the JAX
package has TPU chips and ICI domains.

Port of the reference's ``ClusterResource`` / ``Nodes`` structs
(reference pkg/cluster.go:32-61), extended with per-node free-card
tracking so the planner can keep a job's cards inside one NVLink domain
(a tp or fsdp mesh must not span hosts that are not NVLink-linked).

The snapshot is deliberately a plain mutable value type: the planner mutates
a *copy* during its dry run and the real cluster is never touched
(reference pkg/autoscaler.go:296 passes ClusterResource by value — the
property its whole unit-test suite relies on).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class NodeResources:
    """Per-node idle/free maps — reference pkg/cluster.go:56-61 (``Nodes``),
    plus free cards and NVLink-domain membership per node."""

    nodes_cpu_idle_milli: dict[str, int] = field(default_factory=dict)
    nodes_memory_free_mega: dict[str, int] = field(default_factory=dict)
    nodes_gpu_free: dict[str, int] = field(default_factory=dict)
    #: node → NVLink domain (hosts wired into one NVLink fabric).  A node
    #: absent here is its own domain: a single-host mesh is always local.
    nodes_nvlink_domain: dict[str, str] = field(default_factory=dict)

    def copy(self) -> "NodeResources":
        return NodeResources(
            dict(self.nodes_cpu_idle_milli),
            dict(self.nodes_memory_free_mega),
            dict(self.nodes_gpu_free),
            dict(self.nodes_nvlink_domain),
        )

    def domain_of(self, node: str) -> str:
        return self.nodes_nvlink_domain.get(node) or node


@dataclass
class ClusterResource:
    """Whole-cluster totals + requested/limited sums — reference
    pkg/cluster.go:32-54."""

    node_count: int = 0

    # Accelerator cards (GPURequest/GPULimit/GPUTotal).
    gpu_request: int = 0
    gpu_limit: int = 0
    gpu_total: int = 0

    cpu_request_milli: int = 0
    cpu_limit_milli: int = 0
    cpu_total_milli: int = 0

    memory_request_mega: int = 0
    memory_limit_mega: int = 0
    memory_total_mega: int = 0

    nodes: NodeResources = field(default_factory=NodeResources)

    #: job uid → the NVLink domain its running GPU pods occupy.  Written by
    #: ``inquiry_resource`` (from live pods) and by the planner's dry run
    #: (pinning the domain it chose, so later fixpoint rounds keep growing
    #: the job in the same fabric instead of re-choosing per round).
    jobs_nvlink_domain: dict[str, str] = field(default_factory=dict)

    def copy(self) -> "ClusterResource":
        """Value-semantics copy handed to the dry-run planner
        (role of Go's pass-by-value at reference pkg/autoscaler.go:296)."""
        c = ClusterResource(**{
            k: v for k, v in self.__dict__.items()
            if k not in ("nodes", "jobs_nvlink_domain")})
        c.nodes = self.nodes.copy()
        c.jobs_nvlink_domain = dict(self.jobs_nvlink_domain)
        return c

    def utilization(self) -> float:
        """Card utilization if the cluster has cards, else CPU utilization."""
        if self.gpu_total > 0:
            return self.gpu_limit / self.gpu_total
        if self.cpu_total_milli > 0:
            return self.cpu_request_milli / self.cpu_total_milli
        return 0.0
