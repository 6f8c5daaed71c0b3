"""The controller: job registry → per-job actors + autoscaler feed — the
port's copy of edl_tpu.controller.controller, for a ``TrainingJob``.

Role of the reference's Gen-1 controller (reference pkg/controller.go:44-161)
with the Gen-2 per-job-actor design it was migrating toward (SURVEY §0):
where the reference watches a k8s informer, this controller exposes an
explicit ``submit``/``modify``/``delete`` API (the local/in-process
equivalent of TrainingJob CRUD) and fans events out to

* a :class:`TrainingJobUpdater` actor per job (lifecycle, phases,
  ready-confirmation, teardown — the Gen-2 semantics), and
* the :class:`~edl_tpu_torch.scheduler.autoscaler.Autoscaler` (elastic
  planning — the Gen-1 semantics),

fixing the Gen-1 quirks: resources are created via the updater only after
validation, and master/pserver groups are only created when the spec calls
for them (contrast reference pkg/controller.go:134-141, which creates both
unconditionally and never validates).

Not ported yet: a ``ServingJob`` and its SLO scaler (``serving_stats_for``,
ROADMAP.md queue 1 item 8), the scrape plane (``scraper``) and the
marginal-goodput objective (``goodput_curves``), both item 11.  Each
raises, naming its item.
"""

from __future__ import annotations

import threading
from typing import Optional

from edl_tpu_torch.api.types import JobPhase, TrainingJob
from edl_tpu_torch.api.validation import ValidationError, validate_any
from edl_tpu_torch.cluster.base import Cluster
from edl_tpu_torch.controller.updater import TrainingJobUpdater
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.scheduler.autoscaler import Autoscaler
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
        coord_for=None,
        scraper=None,
    ) -> None:
        if serving_stats_for is not None:
            raise NotImplementedError(
                "serving_stats_for: the SLO-driven ServingScaler waits for "
                "the serving plane (ROADMAP.md queue 1 item 8)")
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
        #: outlive the job on any shared coordinator
        self.coord_for = coord_for
        self._updater_convert_seconds = updater_convert_seconds
        self._updater_confirm_seconds = updater_confirm_seconds
        self._updaters: dict[str, TrainingJobUpdater] = {}
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Run the scaling loop in the background
        (role of Controller.Run, reference pkg/controller.go:64-76)."""
        self.autoscaler.start()

    def stop(self) -> None:
        self.autoscaler.stop()
        with self._lock:
            updaters = list(self._updaters.values())
        for u in updaters:
            u.stop()

    # -- TrainingJob CRUD (role of onAdd/onUpdate/onDelete,
    #    reference pkg/controller.go:110-161) ------------------------------

    def submit(self, job: TrainingJob) -> TrainingJobUpdater:
        """Validate, spawn the job's actor, register with the autoscaler."""
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
        self.autoscaler.on_add(job)
        log.info("job submitted", job=job.full_name,
                 kind=type(job).__name__)
        return updater

    def modify(self, job: TrainingJob) -> None:
        validate_any(job)  # same gate as submit
        with self._lock:
            updater = self._updaters.get(job.full_name)
        if updater is None:
            raise KeyError(f"job {job.full_name} not found")
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

    def delete(self, job: TrainingJob) -> None:
        validate_any(job)  # a serving job raises: it was never submitted
        with self._lock:
            updater = self._updaters.pop(job.full_name, None)
        if updater is not None:
            updater.notify_delete()
            updater.join(timeout=10)
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
