"""Cluster interface — the façade the controller/scheduler talk through;
the port's copy of edl_tpu.cluster.base.

Role of the reference's ``Cluster`` struct (reference pkg/cluster.go:31-291):
inventory snapshots (`InquiryResource`, cluster.go:176-242), trainer-group
actuation (`GetTrainerJob`/`UpdateTrainerJob`, cluster.go:91-113), and pod
counting by job label (`JobPods`, cluster.go:117-136).

Implementations: :class:`edl_tpu_torch.cluster.fake.FakeCluster` (in-memory,
used by the tests, the local elastic job and the process-backed kubelet)
and :class:`edl_tpu_torch.cluster.k8s.K8sCluster` (a live cluster through
the ``kubernetes`` package).
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.resource import ClusterResource


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    TERMINATING = "Terminating"  # deletion_timestamp set (k8s_tools.py:29-36)
    UNKNOWN = "Unknown"  # kubelet unreachable; standard k8s phase


@dataclass(frozen=True)
class PodCounts:
    """Per-job trainer pod counts — reference cluster.go:117-136 plus the
    Succeeded/Failed counts the Gen-2 phase machine needs
    (reference pkg/updater/trainingJobUpdater.go:343-382)."""

    total: int = 0
    running: int = 0
    pending: int = 0
    succeeded: int = 0
    failed: int = 0


class Cluster(abc.ABC):
    """What the autoscaler and controller need from the substrate."""

    # -- inventory ---------------------------------------------------------

    @abc.abstractmethod
    def inquiry_resource(self) -> ClusterResource:
        """Snapshot totals + requests + per-node idleness
        (reference cluster.go:176-242)."""

    # -- trainer-group actuation ------------------------------------------

    @abc.abstractmethod
    def get_trainer_parallelism(self, job: TrainingJob) -> int:
        """Current desired trainer count (role of GetTrainerJob →
        Spec.Parallelism, reference cluster.go:91-97)."""

    @abc.abstractmethod
    def update_trainer_parallelism(self, job: TrainingJob, parallelism: int) -> None:
        """Actuate a resize (role of UpdateTrainerJob, cluster.go:100-113).
        May raise ConflictError; callers retry (autoscaler.go:339-376)."""

    @abc.abstractmethod
    def job_pods(self, job: TrainingJob) -> PodCounts:
        """Count the job's trainer pods by phase (cluster.go:117-136)."""

    @abc.abstractmethod
    def list_pods(self, job_uid: str | None = None, role: str | None = None):
        """Pod records (FakePod attribute surface: name/job_uid/role/phase/
        node/...), optionally scoped to one job and/or role — what the
        collector, pod discovery and per-role status reporting consume."""

    # -- resource lifecycle (role of CreateJob/DeleteJob/Create|DeleteReplicaSet,
    #    cluster.go:245-291) ----------------------------------------------

    @abc.abstractmethod
    def create_resources(self, job: TrainingJob) -> None:
        """Materialize the job's worker groups (trainer/master/pserver)."""

    @abc.abstractmethod
    def delete_resources(self, job: TrainingJob) -> None:
        """Tear the job's worker groups down (foreground-GC semantics)."""


class ConflictError(RuntimeError):
    """Optimistic-concurrency conflict on actuation (k8s resourceVersion)."""
