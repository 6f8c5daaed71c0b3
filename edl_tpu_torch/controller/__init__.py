"""Controller layer: job compilation, per-job lifecycle actors, the
reconciler and the TrainingJob CR sync loop (role of reference
pkg/controller.go, pkg/jobparser.go, pkg/updater/) — the port's copy of
edl_tpu.controller."""

from edl_tpu_torch.controller.updater import TrainingJobUpdater
from edl_tpu_torch.controller.controller import Controller
from edl_tpu_torch.controller.jobparser import parse_to_manifests
from edl_tpu_torch.controller.sync import TrainingJobSyncLoop

__all__ = ["parse_to_manifests", "TrainingJobUpdater", "Controller",
           "TrainingJobSyncLoop"]
