"""The controller: job registry → per-job actors + autoscaler feed — the
port's copy of edl_tpu.controller.controller, for a ``TrainingJob``.

Role of the reference's Gen-1 controller (reference pkg/controller.go:44-161)
with the Gen-2 per-job-actor design it was migrating toward (SURVEY §0):
where the reference watches a k8s informer, this controller exposes an
explicit ``submit``/``modify``/``delete`` API (the local/in-process
equivalent of job CRUD) and fans events out to

* a :class:`TrainingJobUpdater` actor per job (lifecycle, phases,
  ready-confirmation, teardown — the Gen-2 semantics),
* the :class:`~edl_tpu_torch.scheduler.autoscaler.Autoscaler` (elastic
  planning of a ``TrainingJob`` — the Gen-1 semantics), and
* the :class:`~edl_tpu_torch.scheduler.autoscaler.ServingScaler` (the SLO
  policy dialling a ``ServingJob``'s replicas),

fixing the Gen-1 quirks: resources are created via the updater only after
validation, and master/pserver groups are only created when the spec calls
for them (contrast reference pkg/controller.go:134-141, which creates both
unconditionally and never validates).

Not ported yet: the scrape plane (``scraper``) and the marginal-goodput
objective (``goodput_curves``), both ROADMAP.md queue 1 item 11.  Each
raises, naming its item.  The reference's train+serve chip arbitration
(an elastic fleet whose replica dial the goodput planner owns, its SLO
policy only observing and hinting) needs that curve source, so here the
SLO policy dials every serving job.
"""

from __future__ import annotations

import threading
from typing import Optional

from edl_tpu_torch.api.types import JobPhase, ServingJob, TrainingJob
from edl_tpu_torch.api.validation import ValidationError, validate_any
from edl_tpu_torch.cluster.base import Cluster
from edl_tpu_torch.controller.updater import TrainingJobUpdater
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.scheduler.autoscaler import Autoscaler, ServingScaler
from edl_tpu_torch.scheduler.topology import SliceShapePolicy, UNIT_POLICY

log = get_logger("controller")


class Controller:
    """One per cluster; owns the autoscaler and all job actors."""

    def __init__(
        self,
        cluster: Cluster,
        max_load_desired: float = 0.97,  # reference default (cmd/edl/edl.go:19)
        shape_policy: SliceShapePolicy = UNIT_POLICY,
        autoscaler_loop_seconds: float = 5.0,
        updater_convert_seconds: float = 10.0,
        updater_confirm_seconds: float = 5.0,
        resize_cooldown_s: float = 0.0,
        min_resize_delta: int = 1,
        mesh_shape_for=None,
        goodput_curves=None,
        serving_stats_for=None,
        serving_loop_seconds: float = 2.0,
        coord_for=None,
        scraper=None,
    ) -> None:
        if scraper is not None:
            raise NotImplementedError(
                "scraper: observability/scrape.py's MetricsScraper and "
                "FleetView wait for ROADMAP.md queue 1 item 11")
        self.cluster = cluster
        self.autoscaler = Autoscaler(
            cluster,
            max_load_desired=max_load_desired,
            shape_policy=shape_policy,
            loop_seconds=autoscaler_loop_seconds,
            resize_cooldown_s=resize_cooldown_s,
            min_resize_delta=min_resize_delta,
            mesh_shape_for=mesh_shape_for,
            goodput_curves=goodput_curves,
        )
        #: optional ``coord_for(job) -> kv-client | None`` hook: on job
        #: deletion the controller sweeps the job's coordinator KV
        #: (goodput curve, vw map/cursors, serving generation —
        #: edl_tpu_torch.coord.gc.JOB_KV_PREFIXES); without it those keys
        #: outlive the job on any shared coordinator.  The serving scaler
        #: also records each fleet's measured QPS-capacity curve through
        #: it (goodput-curve/<job>).
        self.coord_for = coord_for
        #: SLO-driven replica scaling for ServingJob kinds — fed by
        #: ``serving_stats_for(uid)`` (windowed p50/p99/qps, read off the
        #: in-process fleet), actuating the same cluster replica-group
        #: dial the trainer autoscaler uses
        self.serving_scaler = ServingScaler(
            cluster=cluster,
            stats_for=serving_stats_for,
            loop_seconds=serving_loop_seconds,
            coord_for=coord_for,
        )
        self._updater_convert_seconds = updater_convert_seconds
        self._updater_confirm_seconds = updater_confirm_seconds
        self._updaters: dict[str, TrainingJobUpdater] = {}
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Run the scaling loops in the background
        (role of Controller.Run, reference pkg/controller.go:64-76)."""
        self.autoscaler.start()
        self.serving_scaler.start()

    def stop(self) -> None:
        self.autoscaler.stop()
        self.serving_scaler.stop()
        with self._lock:
            updaters = list(self._updaters.values())
        for u in updaters:
            u.stop()

    # -- TrainingJob CRUD (role of onAdd/onUpdate/onDelete,
    #    reference pkg/controller.go:110-161) ------------------------------

    def submit(self, job: "TrainingJob | ServingJob") -> TrainingJobUpdater:
        """Validate, spawn the job's actor, register with the matching
        scaler (trainer autoscaler for TrainingJob, the SLO policy for
        ServingJob — the updater lifecycle actor is shared)."""
        validate_any(job)  # raises ValidationError on bad spec
        with self._lock:
            if job.full_name in self._updaters:
                raise ValidationError(f"job {job.full_name} already submitted")
            updater = TrainingJobUpdater(
                job,
                self.cluster,
                convert_seconds=self._updater_convert_seconds,
                confirm_seconds=self._updater_confirm_seconds,
            )
            self._updaters[job.full_name] = updater
        if isinstance(job, ServingJob):
            self.serving_scaler.on_add(job)
        else:
            self.autoscaler.on_add(job)
        log.info("job submitted", job=job.full_name,
                 kind=type(job).__name__)
        return updater

    def modify(self, job: "TrainingJob | ServingJob") -> None:
        validate_any(job)  # same gate as submit
        with self._lock:
            updater = self._updaters.get(job.full_name)
        if updater is None:
            raise KeyError(f"job {job.full_name} not found")
        if isinstance(job, ServingJob):
            updater.modify(job)
            self.serving_scaler.on_update(job)
            return
        old = updater.job.spec
        if old.trainer.allow_multi_domain != job.spec.trainer.allow_multi_domain:
            # The flag is baked into the running pods' labels (the cluster
            # inventory's pin/no-pin decision reads pods, not the spec) and
            # into where the mesh already sits; flipping it in place would
            # let the planner grow a "single-domain" mesh across an NVLink
            # boundary.  Like pod-template fields, it is create-time.
            raise ValidationError(
                "allow_multi_domain is immutable on a running job; "
                "delete and resubmit to change it")
        updater.modify(job)
        self.autoscaler.on_update(job)

    def delete(self, job: "TrainingJob | ServingJob") -> None:
        with self._lock:
            updater = self._updaters.pop(job.full_name, None)
        if updater is not None:
            updater.notify_delete()
            updater.join(timeout=10)
        if isinstance(job, ServingJob):
            self.serving_scaler.on_del(job)
        else:
            self.autoscaler.on_del(job)
        self._gc_job_kv(job)
        log.info("job deleted", job=job.full_name)

    def _gc_job_kv(self, job) -> None:
        """Sweep the deleted job's coordinator KV (goodput curve, vw
        map/cursors, serving generation): job-scoped keys deliberately
        survive every reform/failover, so deletion is the ONLY moment
        they can be collected — on a shared coordinator they would
        otherwise leak forever (and poison a resubmitted job under the
        same name with the dead job's curve and cursors).  Best-effort:
        teardown never fails on an unreachable coordinator."""
        if self.coord_for is None:
            return
        try:
            coord = self.coord_for(job)
            if coord is None:
                return
            from edl_tpu_torch.coord.gc import gc_job_kv

            gc_job_kv(coord, job.full_name)
        except Exception as exc:
            log.warn("job KV sweep failed", job=job.full_name,
                     error=str(exc)[:200])

    # -- introspection -----------------------------------------------------

    def get_updater(self, job: TrainingJob) -> Optional[TrainingJobUpdater]:
        with self._lock:
            return self._updaters.get(job.full_name)

    def phase(self, job: TrainingJob) -> JobPhase:
        u = self.get_updater(job)
        return u.phase if u is not None else JobPhase.NONE

    def jobs(self) -> list[TrainingJob]:
        with self._lock:
            return [u.job for u in self._updaters.values()]
