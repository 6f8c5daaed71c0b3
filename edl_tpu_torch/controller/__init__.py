"""Controller layer: per-job lifecycle actors + reconciler (role of
reference pkg/controller.go, pkg/updater/) — the port's copy of
edl_tpu.controller.  The jobparser and ``sync.py`` wait with
``cluster/k8s.py``, ``api/serde.py`` and ``cli.py``: the k8s/CLI group of
ROADMAP.md queue 1 item 11."""

from edl_tpu_torch.controller.updater import TrainingJobUpdater
from edl_tpu_torch.controller.controller import Controller

__all__ = ["TrainingJobUpdater", "Controller"]
