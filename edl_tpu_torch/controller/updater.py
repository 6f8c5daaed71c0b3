"""Per-job lifecycle actor — the port's copy of edl_tpu.controller.updater.

Port of the reference's Gen-2 updater — the richer, corrected design the
reference wrote but never wired in (reference
pkg/updater/trainingJobUpdater.go:19-481; SURVEY §0 "Gen-2"):

* one actor (thread) per job, fed by a bounded event queue with a
  near-full warning (reference :19-25, 80-86);
* ``init_resource`` drives None → Creating → Running: validate, create
  worker groups, wait until the minimum trainer cohort is Running with a
  confirm ticker (reference :209-257, 417-449);
* a periodic ``convert`` tick recomputes the phase from live pod counts —
  a fault-tolerant job fails only when **all** trainers have failed, a
  non-FT job when **any** has; succeeded when a pod succeeded and none are
  active (reference :343-382, 385-414);
* terminal phases release the job's resources and stop the ticker
  (reference :400-412, 471-478).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from edl_tpu_torch.api.types import (
    JobPhase,
    ResourceState,
    TrainingJob,
    TrainingResourceStatus,
)
from edl_tpu_torch.api.validation import ValidationError, validate_any
from edl_tpu_torch.cluster.base import Cluster, PodPhase
from edl_tpu_torch.observability.logging import get_logger

EVENT_QUEUE_SIZE = 1000  # reference trainingJobUpdater.go:19-25
CONVERT_SECONDS = 10.0  # reference trainingJobUpdater.go:22 (10 s Convert tick)
CONFIRM_SECONDS = 5.0  # reference trainingJobUpdater.go:24 (5 s ready confirm)
CREATE_TIMEOUT_SECONDS = 120.0

log = get_logger("updater")

#: cluster pod-role name → TrainingResourceType (reference
#: pkg/apis/paddlepaddle/v1/types.go:139-147).
ROLE_TYPES = (("master", "MASTER"), ("pserver", "PSERVER"),
              ("trainer", "TRAINER"), ("server", "SERVER"))

_POD_TO_RESOURCE_STATE = {
    PodPhase.PENDING: ResourceState.STARTING,
    PodPhase.RUNNING: ResourceState.RUNNING,
    PodPhase.SUCCEEDED: ResourceState.SUCCEEDED,
    PodPhase.FAILED: ResourceState.FAILED,
    PodPhase.TERMINATING: ResourceState.NONE,
    PodPhase.UNKNOWN: ResourceState.NONE,
}


def compute_replica_statuses(cluster: Cluster, job_uid: str
                             ) -> list[TrainingResourceStatus]:
    """Per-role, per-pod states from live pods (the detail the reference
    declares in TrainingResourceStatus, pkg/apis/paddlepaddle/v1/
    types.go:154-162, and fills from the updater).  Shared by the updater
    (which writes it into job.status each convert tick) and the CLI's
    ``status`` verb (which computes the same view statelessly).

    One LIST for the whole job, bucketed by role client-side — per-role
    LISTs would be 3 API calls per convert tick per job on a live
    apiserver."""
    by_role: dict[str, list] = {}
    for p in cluster.list_pods(job_uid=job_uid):
        by_role.setdefault(p.role, []).append(p)
    statuses: list[TrainingResourceStatus] = []
    for role, rtype in ROLE_TYPES:
        if role == "server" and role not in by_role:
            # the serving role only reports when it exists: a
            # TrainingJob's status keeps its historical three rows, a
            # ServingJob grows its SERVER row from live pods
            continue
        states = {
            p.name: _POD_TO_RESOURCE_STATE.get(p.phase, ResourceState.NONE)
            for p in by_role.get(role, ())
        }
        vals = list(states.values())
        if not vals:
            agg = ResourceState.NONE
        elif all(s == ResourceState.SUCCEEDED for s in vals):
            agg = ResourceState.SUCCEEDED
        elif any(s == ResourceState.RUNNING for s in vals):
            agg = ResourceState.RUNNING
        elif any(s == ResourceState.STARTING for s in vals):
            agg = ResourceState.STARTING
        elif any(s == ResourceState.FAILED for s in vals):
            agg = ResourceState.FAILED
        else:
            agg = ResourceState.NONE
        statuses.append(TrainingResourceStatus(
            resource_type=rtype, state=agg, resource_states=states))
    return statuses


class TrainingJobUpdater:
    """Actor owning one job's lifecycle, from creation to teardown."""

    def __init__(
        self,
        job: TrainingJob,
        cluster: Cluster,
        convert_seconds: float = CONVERT_SECONDS,
        confirm_seconds: float = CONFIRM_SECONDS,
        create_timeout: float = CREATE_TIMEOUT_SECONDS,
        auto_start: bool = True,
    ) -> None:
        self.job = job
        self.cluster = cluster
        self.convert_seconds = convert_seconds
        self.confirm_seconds = confirm_seconds
        self.create_timeout = create_timeout
        self._events: "queue.Queue[str]" = queue.Queue(maxsize=EVENT_QUEUE_SIZE)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._released = False
        if auto_start:
            self.start()

    # -- public API (role of Modify/Delete/notify, reference :78-97) -------

    @property
    def phase(self) -> JobPhase:
        return self.job.status.phase

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"updater-{self.job.full_name}"
        )
        self._thread.start()

    def notify_delete(self) -> None:
        self._notify("delete")

    def modify(self, job: TrainingJob) -> None:
        self.job.spec = job.spec
        self._notify("modify")

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(timeout=5)

    # -- lifecycle ---------------------------------------------------------

    def init_resource(self) -> None:
        """None → Creating → Running|Failed (reference :417-449)."""
        try:
            validate_any(self.job)  # kind-dispatching: training OR serving
        except ValidationError as exc:
            self._set_phase(JobPhase.FAILED, f"invalid spec: {exc}")
            return

        self._set_phase(JobPhase.CREATING)
        try:
            self.cluster.create_resources(self.job)
        except Exception as exc:
            self._set_phase(JobPhase.FAILED, f"create failed: {exc}")
            return

        # Wait for the minimum cohort, confirming on a ticker
        # (role of createResource's ReadyReplicas==Replicas wait, :209-257).
        # The wait also services delete events so a teardown of a
        # still-CREATING job doesn't dangle until the create timeout.
        deadline = self._now() + self.create_timeout
        while not self._stop.is_set():
            try:
                counts = self.cluster.job_pods(self.job)
            except Exception as exc:  # transient inventory error: keep waiting
                log.error("ready-wait: job_pods failed",
                          job=self.job.full_name, error=str(exc))
                counts = None
            min_replicas = self.job.group_range()[0]
            if counts is not None:
                if counts.running >= min_replicas:
                    self._refresh_replica_statuses()
                    self._set_phase(JobPhase.RUNNING)
                    return
                if self._now() > deadline:
                    self._set_phase(
                        JobPhase.FAILED,
                        f"timed out waiting for {min_replicas}"
                        f" running replicas (have {counts.running})",
                    )
                    self._release()
                    return
            try:
                evt = self._events.get(timeout=self.confirm_seconds)
            except queue.Empty:
                continue
            if evt == "delete":
                self.delete()
                return

    def convert(self) -> None:
        """Recompute phase + per-role replica statuses from live pods
        (reference :343-414 and the Gen-2 TrainingResourceStatus detail
        nothing populated in round 1)."""
        if self.phase not in (JobPhase.RUNNING, JobPhase.SCALING):
            return
        try:
            counts = self.cluster.job_pods(self.job)
        except Exception as exc:
            log.error("convert: job_pods failed", job=self.job.full_name,
                      error=str(exc))
            return
        self._refresh_replica_statuses()

        active = counts.running + counts.pending
        if self.job.replaceable_on_failure():
            # FT trainers / serving replicas: failed only when ALL
            # replicas have failed (reference :359-368)
            if counts.failed > 0 and active == 0 and counts.succeeded == 0:
                self._set_phase(JobPhase.FAILED, "all replicas failed")
                self._release()
                return
        else:
            # non-FT: any failure is fatal (reference :370-380)
            if counts.failed > 0:
                self._set_phase(JobPhase.FAILED,
                                f"{counts.failed} trainer(s) failed")
                self._release()
                return
        if counts.succeeded > 0 and active == 0:
            self._set_phase(JobPhase.SUCCEEDED)
            self._release()
            return
        # Resize in flight (an addition to the reference's phases):
        # the autoscaler rewrote the desired parallelism and the pod set
        # hasn't caught up — surface it so operators can tell "scaling"
        # from "steady" (kubectl-visible, like the reference's phases).
        # Only when the count gap is actually a resize: early successes
        # (wind-down) and FT failure recovery also diverge running from
        # desired and must keep their own phase/reason.
        if counts.succeeded > 0 or counts.failed > 0:
            return
        try:
            desired = self.cluster.get_trainer_parallelism(self.job)
        except Exception as exc:
            # keep the current phase, but a persistent fault (e.g. the
            # trainer group deleted out-of-band) must not be silent
            log.error("convert: get_trainer_parallelism failed",
                      job=self.job.full_name, error=str(exc))
            return
        if counts.running != desired:
            self._set_phase(
                JobPhase.SCALING,
                f"replicas {counts.running} -> {desired}")
        else:
            self._set_phase(JobPhase.RUNNING)

    def delete(self) -> None:
        """Full teardown (reference deleteTrainingJob, :99-207)."""
        self._release()
        self._stop.set()

    # -- actor loop --------------------------------------------------------

    def _run(self) -> None:
        try:
            self.init_resource()
        except Exception as exc:  # never let the actor die silently
            log.error("init_resource crashed", job=self.job.full_name,
                      error=str(exc))
            self._set_phase(JobPhase.FAILED, f"init error: {exc}")
            self._release()
            return
        while not self._stop.is_set() and not self.phase.terminal():
            try:
                evt = self._events.get(timeout=self.convert_seconds)
            except queue.Empty:
                self.convert()  # the 10 s Convert ticker (reference :460-480)
                continue
            if evt == "delete":
                self.delete()
                return
            if evt == "modify":
                self.convert()

    def _notify(self, evt: str) -> None:
        # near-full warning (reference :80-86)
        if self._events.qsize() > EVENT_QUEUE_SIZE * 0.9:
            log.warn("event queue near full", job=self.job.full_name,
                     qsize=self._events.qsize())
        try:
            self._events.put_nowait(evt)
        except queue.Full:
            log.error("event queue full, dropping event",
                      job=self.job.full_name, event=evt)

    def _refresh_replica_statuses(self) -> None:
        """Status DETAIL only — a failure here must never block the phase
        machine (the CRD's phase is load-bearing; replica_statuses is
        operator information)."""
        try:
            self.job.status.replica_statuses = compute_replica_statuses(
                self.cluster, self.job.full_name)
        except Exception as exc:
            log.warn("replica-status refresh failed",
                     job=self.job.full_name, error=str(exc))

    def _release(self) -> None:
        """Release the job's cluster resources once (role of
        releaseResource/deleteTrainingJob, reference :99-207, 400-412)."""
        if self._released:
            return
        self._released = True
        try:
            self.cluster.delete_resources(self.job)
        except Exception as exc:
            log.error("release failed", job=self.job.full_name, error=str(exc))

    def _set_phase(self, phase: JobPhase, reason: str = "") -> None:
        if self.job.status.phase != phase:  # write only on change (:295-307)
            log.info("job phase", job=self.job.full_name,
                     phase=phase.value, reason=reason)
        self.job.status.phase = phase
        self.job.status.reason = reason

    @staticmethod
    def _now() -> float:
        import time

        return time.monotonic()
