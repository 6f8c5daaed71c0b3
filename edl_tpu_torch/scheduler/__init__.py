"""Elastic scheduler: the pure dry-run planner and the autoscaler loop
(role of reference pkg/autoscaler.go) — the port's copy of
edl_tpu.scheduler's count objective.  The marginal-goodput allocator, its
curves and ``sim.py``, and the serving scaler wait (ROADMAP.md, queue 1
items 8 and 11)."""

from edl_tpu_torch.scheduler.planner import (
    GoodputPlan,
    PlannedJob,
    plan_cluster,
    scale_all_jobs_dry_run,
    scale_dry_run,
    sorted_jobs,
)
from edl_tpu_torch.scheduler.topology import POW2_POLICY, SliceShapePolicy
from edl_tpu_torch.scheduler.autoscaler import Autoscaler

__all__ = [
    "GoodputPlan",
    "PlannedJob",
    "plan_cluster",
    "scale_all_jobs_dry_run",
    "scale_dry_run",
    "sorted_jobs",
    "SliceShapePolicy",
    "POW2_POLICY",
    "Autoscaler",
]
