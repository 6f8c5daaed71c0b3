"""Elastic scheduler: the pure dry-run planner (the count packer and the
marginal-goodput allocator), the autoscaler loop (role of reference
pkg/autoscaler.go), the serving SLO policy, and the fleet simulation
that proves the allocator — the port's copy of edl_tpu.scheduler."""

from edl_tpu_torch.scheduler.planner import (
    GoodputPlan,
    PlannedJob,
    plan_cluster,
    scale_all_jobs_dry_run,
    scale_all_jobs_goodput,
    scale_dry_run,
    sorted_jobs,
)
from edl_tpu_torch.scheduler.topology import POW2_POLICY, SliceShapePolicy
from edl_tpu_torch.scheduler.autoscaler import Autoscaler, ServingScaler
from edl_tpu_torch.scheduler.sim import FleetSim, SimConfig, compare_objectives

__all__ = [
    "GoodputPlan",
    "PlannedJob",
    "plan_cluster",
    "scale_all_jobs_dry_run",
    "scale_all_jobs_goodput",
    "scale_dry_run",
    "sorted_jobs",
    "SliceShapePolicy",
    "POW2_POLICY",
    "Autoscaler",
    "ServingScaler",
    "FleetSim",
    "SimConfig",
    "compare_objectives",
]
