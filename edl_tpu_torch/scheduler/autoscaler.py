"""Autoscaler loop: events in, scaling plans out, actuation with retries —
the port's copy of edl_tpu.scheduler.autoscaler's trainer ``Autoscaler``.

Port of the reference's ``Autoscaler`` (reference pkg/autoscaler.go:66-95,
339-511).  State is confined to one actor: events arrive on a queue and are
folded into the job map by the same thread that plans and actuates — the
reference's goroutine-confinement discipline (autoscaler.go:71, 159-171,
451-459) kept verbatim.

Deterministic by construction: :meth:`Autoscaler.tick` runs exactly one
plan-and-actuate pass (what the 5 s ticker triggers in the reference) so
tests drive the loop synchronously; :meth:`Autoscaler.run` wraps it in the
timed loop for production.

Plans come from the count objective (:func:`~edl_tpu_torch.scheduler.
planner.plan_cluster` with ``objective="count"``).  A ``goodput_curves``
hook — the marginal-goodput objective's curve source — raises, naming
ROADMAP.md queue 1 item 11; the count objective never stands in for it.
The SLO-driven ``ServingScaler`` waits for the serving plane (item 8).
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.base import Cluster
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.scheduler.planner import PlannedJob, plan_cluster
from edl_tpu_torch.scheduler.topology import SliceShapePolicy, UNIT_POLICY

DEFAULT_LOOP_SECONDS = 5.0  # reference autoscaler.go:31
UPDATE_RETRIES = 5  # reference autoscaler.go:346
#: hysteresis defaults: off (cooldown 0, any nonzero delta actuates) so
#: the planner's pure behavior is unchanged unless a deployment opts in —
#: production manifests set a cooldown so watchdog-triggered world
#: reforms and load flapping don't thrash the mesh with resize churn
DEFAULT_RESIZE_COOLDOWN_S = 0.0
DEFAULT_MIN_RESIZE_DELTA = 1

log = get_logger("autoscaler")


class EventType(enum.Enum):
    ADD = "add"
    DEL = "del"
    UPDATE = "update"


@dataclass
class Event:
    type: EventType
    job: TrainingJob


class Autoscaler:
    def __init__(
        self,
        cluster: Cluster,
        max_load_desired: float = 1.0,
        shape_policy: SliceShapePolicy = UNIT_POLICY,
        loop_seconds: float = DEFAULT_LOOP_SECONDS,
        resize_cooldown_s: float = DEFAULT_RESIZE_COOLDOWN_S,
        min_resize_delta: int = DEFAULT_MIN_RESIZE_DELTA,
        mesh_shape_for: Optional[Callable[[str, int], object]] = None,
        goodput_curves: Optional[Callable[[str], object]] = None,
        clock=time.monotonic,
    ) -> None:
        if goodput_curves is not None:
            # a curve source must not be quietly planned by count
            raise NotImplementedError(
                "goodput_curves: the marginal-goodput objective (goodput's "
                "ScalingCurve and CurveStore, scheduler/sim.py and "
                "scale_all_jobs_goodput) waits for ROADMAP.md queue 1 item "
                "11; the port's autoscaler plans by count")
        self.cluster = cluster
        self.max_load_desired = max_load_desired
        self.shape_policy = shape_policy
        self.loop_seconds = loop_seconds
        #: hysteresis: a job resized less than ``resize_cooldown_s`` ago
        #: is left alone this tick, and a plan delta smaller than
        #: ``min_resize_delta`` cards is not worth a reshard (every
        #: actuation costs the runtime a group build + state move —
        #: flapping load or watchdog-triggered reforms must not turn
        #: into resize churn)
        self.resize_cooldown_s = resize_cooldown_s
        self.min_resize_delta = max(int(min_resize_delta), 1)
        self._clock = clock
        self._last_resize: dict[str, float] = {}  # uid -> actuation time
        #: uid -> consecutive ticks observed with pending pods (feeds
        #: PlannedJob.pending_age)
        self._pending_age: dict[str, int] = {}
        self.jobs: dict[str, PlannedJob] = {}  # keyed by uid (namespace/name)
        self._events: "queue.Queue[Event]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: log of (job -> target) plans, for tests/observability
        self.plan_history: list[dict[str, int]] = []
        #: log of {uid: reason} suppressions, for tests/observability
        self.suppressed_history: list[dict[str, str]] = []
        #: speculative-prewarm hint hook: called as ``hint_sink(uid,
        #: target_parallelism)`` the moment a plan is decided — BEFORE
        #: actuation, pods moving, or the training loop observing any of
        #: it.  A runtime that wires this to ElasticTrainer.prewarm builds
        #: the next layout's groups while the pods are still being
        #: created, so the eventual resize pays only the reshard hop.
        #: Must be cheap and non-blocking (it runs on the scaling loop);
        #: exceptions are swallowed and logged — hints are an
        #: optimization, never a dependency.
        self.hint_sink: Optional[Callable[[str, object], None]] = None
        #: reparallelization policy hook: maps ``(uid, target_count)`` to
        #: the mesh layout the job should run at that world size (a
        #: MeshShape, or the count unchanged).  When set, hint_sink fires
        #: ``(uid, target_shape)`` instead of the bare count.  Planning
        #: and actuation still walk instance counts; the shape is carried
        #: alongside, never instead.
        self.mesh_shape_for = mesh_shape_for
        #: the last plan's objective mode — what
        #: edl_autoscaler_objective{mode=} reports
        self.objective_mode: str = "count"
        #: monotonic time of each tick's start and its actuated targets
        #: ``(t, {uid: target})`` — what a tick-to-resize latency reads
        self.tick_history: "list[tuple[float, dict[str, int]]]" = []

    # -- event intake (reference autoscaler.go:159-171) --------------------

    def on_add(self, job: TrainingJob) -> None:
        self._events.put(Event(EventType.ADD, job))

    def on_del(self, job: TrainingJob) -> None:
        self._events.put(Event(EventType.DEL, job))

    def on_update(self, job: TrainingJob) -> None:
        self._events.put(Event(EventType.UPDATE, job))

    # -- the loop ----------------------------------------------------------

    def drain_events(self) -> None:
        """Fold queued events into the job map (updateJobList,
        reference autoscaler.go:383-402)."""
        while True:
            try:
                evt = self._events.get_nowait()
            except queue.Empty:
                return
            if evt.type in (EventType.ADD, EventType.UPDATE):
                j = PlannedJob(config=evt.job, shape_policy=self.shape_policy)
                self.jobs[j.uid] = j
                self._sync_parallelism(j)
            elif evt.type == EventType.DEL:
                self.jobs.pop(evt.job.full_name, None)
                self._pending_age.pop(evt.job.full_name, None)
                # drop the cooldown stamp too: a re-submitted job under
                # the same uid starts with a clean hysteresis slate (and
                # a long-lived controller must not leak one float per
                # deleted job)
                self._last_resize.pop(evt.job.full_name, None)

    def tick(self) -> dict[str, int]:
        """One plan-and-actuate pass; returns the actuated targets
        (reference autoscaler.go:451-485)."""
        started = self._clock()
        self.drain_events()
        try:
            r = self.cluster.inquiry_resource()
        except Exception as exc:  # keep looping, as the reference does
            log.error("inquiry_resource failed", error=str(exc))
            return {}

        candidates = self._reschedulable_jobs()
        plan = plan_cluster(candidates, r, self.max_load_desired,
                            objective="count")
        diff = plan.diff
        self._note_objective(plan.mode)

        # Zero deltas are dropped: no no-op actuation writes, no plan spam
        # (the reference re-writes unchanged Parallelism every tick — a
        # quirk, not a behavior worth keeping).  Hysteresis drops two
        # more classes: deltas below min_resize_delta (not worth the
        # reshard) and jobs inside their resize cooldown (no thrash when
        # load flaps or a watchdog-triggered reform wobbles the pod
        # count) — each suppression is logged and counted.
        now = self._clock()
        target: dict[str, int] = {}
        suppressed: dict[str, str] = {}
        for uid, delta in diff.items():
            if uid not in self.jobs or delta == 0:
                continue
            if abs(delta) < self.min_resize_delta:
                suppressed[uid] = "min_delta"
                continue
            last = self._last_resize.get(uid)
            if (self.resize_cooldown_s > 0 and last is not None
                    and now - last < self.resize_cooldown_s):
                suppressed[uid] = "cooldown"
                continue
            target[uid] = self.jobs[uid].parallelism + delta
        if suppressed:
            for uid, reason in suppressed.items():
                log.info("resize suppressed", job=uid, reason=reason,
                         delta=diff[uid])
                get_counters().inc("resizes_suppressed", reason=reason)
            self.suppressed_history.append(suppressed)
        if target:
            log.info("scaling plan", target=target)
            self.plan_history.append(dict(target))
            self.tick_history.append((started, dict(target)))
            get_counters().inc("autoscaler_plans")
            get_counters().inc("autoscaler_resizes_actuated", n=len(target))
            for uid in target:
                self._last_resize[uid] = now
            if self.hint_sink is not None:
                # hint BEFORE actuation: the plan is the earliest moment
                # the next parallelism is known.  With a shape policy the
                # hint carries the full target layout (uid, MeshShape);
                # shape-policy failures degrade to the bare count — a
                # hint is never a dependency.
                for uid, n in target.items():
                    hint = n
                    if self.mesh_shape_for is not None:
                        try:
                            hint = self.mesh_shape_for(uid, n)
                        except Exception as exc:
                            log.warn("mesh shape policy failed; hinting "
                                     "bare count", job=uid, error=str(exc))
                    try:
                        self.hint_sink(uid, hint)
                    except Exception as exc:
                        log.warn("prewarm hint sink failed", job=uid,
                                 error=str(exc))
        self._scale_all_jobs(target)
        return target

    def _note_objective(self, mode: str) -> None:
        """Record which objective ruled this tick (the
        ``edl_autoscaler_objective{mode=}`` gauge — 1 on the active mode,
        0 on the others, so a scrape always sees all three series)."""
        self.objective_mode = mode
        gauge = get_registry().gauge(
            "autoscaler_objective",
            help="active packing objective (1 = this mode ruled the "
                 "last plan): goodput | count | degraded")
        for m in ("goodput", "count", "degraded"):
            gauge.set(1.0 if m == mode else 0.0, mode=m)

    def run(self) -> None:
        """Timed loop (role of Run + ticker, reference autoscaler.go:451-459)."""
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.loop_seconds)

    def start(self) -> None:
        self.register_metrics()
        self._thread = threading.Thread(target=self.run, daemon=True, name="autoscaler")
        self._thread.start()

    def register_metrics(self, registry=None) -> None:
        """Expose live planner state on the port's registry (callback
        gauges, evaluated at scrape time) next to every counter the loop
        already bumps (autoscaler_plans, resizes_suppressed{reason})."""
        if registry is None:
            registry = get_registry()
        registry.gauge_fn("autoscaler_jobs_tracked",
                          lambda: len(self.jobs),
                          help="jobs in the autoscaler's job map")
        registry.gauge_fn("autoscaler_loop_alive",
                          lambda: float(self.is_alive()),
                          help="1 while the planning loop thread lives")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def is_alive(self) -> bool:
        """Liveness of the background loop — the /healthz probe truth."""
        return self._thread is not None and self._thread.is_alive()

    # -- internals ---------------------------------------------------------

    def _sync_parallelism(self, j: PlannedJob) -> bool:
        """Refresh current parallelism from the cluster
        (tryToRetrieveTrainerJobInTrainingJob, reference autoscaler.go:424-447)."""
        try:
            j.parallelism = self.cluster.get_trainer_parallelism(j.config)
            return True
        except Exception as exc:
            log.error("trainer group not found yet, will sync later",
                      job=j.name, error=str(exc))
            return False

    def _reschedulable_jobs(self) -> list[PlannedJob]:
        """One inventory sweep feeding both reference predicates
        (findPendingJob, autoscaler.go:406-422, and
        findTrainingJobsMightBeRescheduled, autoscaler.go:487-511):
        a job is a candidate if it is stable (all pods running), or if any
        job is fully pending — then *every* job is fair game, so the planner
        can shrink others to make room.

        Pods that ended (Failed, Succeeded) are not counted in either
        predicate: a job is stable when its running pods equal its live
        ones, and fully pending when its pending pods do.  The JAX package
        compares both with ``total``, which counts a killed trainer's
        Failed pod: it keeps a fault-tolerant job whose killed trainer was
        replaced out of every later plan, and a job whose trainers were all
        killed and wait for room never makes the others fair game
        (ROADMAP.md queue 3).  With no ended pod the two agree."""
        surveyed: list[tuple[PlannedJob, int, "object"]] = []
        have_pending = False
        for j in self.jobs.values():
            if not self._sync_parallelism(j):
                continue
            try:
                counts = self.cluster.job_pods(j.config)
            except Exception as exc:
                log.error("job_pods failed", job=j.name, error=str(exc))
                continue
            j.pending = counts.pending
            if counts.pending > 0:
                j.pending_age = self._pending_age.get(j.uid, 0)
                self._pending_age[j.uid] = j.pending_age + 1
            else:
                j.pending_age = 0
                self._pending_age.pop(j.uid, None)
            live = counts.total - counts.failed - counts.succeeded
            surveyed.append((j, live, counts))
            if live == counts.pending:
                have_pending = True
        return [
            j for j, live, counts in surveyed
            if live == counts.running or have_pending
        ]

    def _scale_all_jobs(self, target: dict[str, int]) -> None:
        """Actuate with refresh-then-write and bounded retries
        (reference autoscaler.go:339-376)."""
        for uid, n in target.items():
            j = self.jobs.get(uid)
            if j is None:
                continue
            for retry in range(UPDATE_RETRIES):
                if not self._sync_parallelism(j):
                    continue
                try:
                    self.cluster.update_trainer_parallelism(j.config, n)
                    j.parallelism = n
                    break
                except Exception as exc:
                    log.warn("error updating trainer group", job=uid,
                             error=str(exc), remaining_retry=UPDATE_RETRIES - retry - 1)
