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

With a ``goodput_curves`` source wired (and ``goodput_objective`` on, the
default) plans come from the marginal-goodput allocator
(:func:`~edl_tpu_torch.scheduler.planner.plan_cluster` with
``objective="goodput"``: priorities, preemption, gang placement, and
train+serve arbitration), degrading bit-for-bit to count packing when no
curve resolves; without one, from the reference's count packer.

:class:`ServingScaler` is the serving policy: it dials a ``ServingJob``'s
replica count on p99-vs-SLO and per-replica throughput, fires the fleet's
prewarm hint before it actuates, and records each fleet's measured
(replicas → qps) points into the job's goodput curve in coordinator KV.
Fed from the scrape plane (:meth:`ServingScaler.feed_from` a
``FleetView``), it sees exactly what a scraper can see; a fleet whose dial
the goodput planner owns is ``observe_only``: observed, recorded and
prewarm-hinted, never actuated.
"""

from __future__ import annotations

import enum
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.base import Cluster
from edl_tpu_torch.observability import calib
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.goodput import CurveStore
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.scheduler.planner import (
    PlannedJob,
    plan_cluster,
    scale_all_jobs_dry_run,
)
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
        goodput_objective: bool = True,
        clock=time.monotonic,
    ) -> None:
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
        #: goodput curve hook: maps a job uid to its measured
        #: :class:`~edl_tpu_torch.observability.goodput.ScalingCurve` (e.g.
        #: ``lambda uid: goodput.load_curve(coord, uid)``).  With
        #: ``goodput_objective`` on (the default) the curves DRIVE the
        #: packing: plans come from the marginal-goodput allocator
        #: (planner.scale_all_jobs_goodput — priorities, preemption,
        #: gang placement), degrading bit-for-bit to count packing when
        #: no curve resolves.  Every actuated plan still logs the
        #: marginal advisory + the
        #: ``edl_autoscaler_marginal_tokens_per_chip{job=}`` gauge.
        self.goodput_curves = goodput_curves
        #: objective switch: True (default) prices cards by marginal
        #: goodput whenever a curve source is wired; False pins the
        #: reference's count-based packing regardless.
        self.goodput_objective = goodput_objective
        #: log of (uid, target, measured_at, marginal) advisories, for
        #: tests/observability — BOUNDED: this is appended on every
        #: actuated plan for the life of the controller process
        self.advisory_history: "deque[dict]" = deque(maxlen=256)
        #: the last plan's objective mode ("count" | "goodput" |
        #: "degraded") — what edl_autoscaler_objective{mode=} reports
        self.objective_mode: str = ("goodput" if goodput_objective
                                    else "count")
        #: with ``record_plans`` on, each goodput tick appends its
        #: ``(t, mode)`` to ``mode_log``, and each one whose plan moves a
        #: job appends what it planned from and what it decided to
        #: ``plan_records`` — ``{"t", "jobs" (uid → parallelism,
        #: pending, pending_age), "resource" (the ClusterResource
        #: snapshot), "curves" (uid → the curve's JSON or None, as the
        #: tick's memo resolved it), "plan", "target"}`` — so an audit
        #: can re-run the planner on exactly that tick's inputs.  Both
        #: bounded like the advisory log.
        self.record_plans = False
        self.mode_log: "deque[tuple[float, str]]" = deque(maxlen=4096)
        self.plan_records: "deque[dict]" = deque(maxlen=256)
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
                # serving fleets are replica groups, not meshes: their
                # replicas are independent, so the trainer slice-shape
                # quantization (e.g. a pow2 policy) must not bind their
                # dial — a 5-replica fleet is a perfectly good fleet
                policy = (UNIT_POLICY
                          if getattr(evt.job, "replica_role", "trainer")
                          == "server" else self.shape_policy)
                j = PlannedJob(config=evt.job, shape_policy=policy)
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
                # and the advisory gauge series: a deleted job must stop
                # being reported, not freeze at its last marginal value
                # (nor grow the series set without bound as jobs churn)
                get_registry().gauge(
                    "autoscaler_marginal_tokens_per_chip").remove(
                        job=evt.job.full_name)

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
        plan = None
        curves = self._tick_curve_source()
        if self.goodput_objective and curves is not None:
            snapshot = r.copy() if self.record_plans else None
            try:
                plan = plan_cluster(candidates, r, self.max_load_desired,
                                    curves=curves, objective="goodput")
                diff = plan.diff
            except Exception as exc:
                # the loop thread must survive ANY planner failure: log,
                # fall back to the reference packer for this tick
                log.error("goodput plan failed; count packing this tick",
                          error=str(exc)[:300])
                diff = scale_all_jobs_dry_run(candidates, r,
                                              self.max_load_desired)
        else:
            snapshot = None
            diff = scale_all_jobs_dry_run(candidates, r,
                                          self.max_load_desired)
        self._note_objective(plan)

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
        if plan is not None:
            # preemption overrides hysteresis: a higher-priority gang's
            # admission must not wait out its victim's resize cooldown
            for rec in plan.preemptions:
                v = rec["victim"]
                if v in suppressed and v in self.jobs and diff.get(v):
                    del suppressed[v]
                    target[v] = self.jobs[v].parallelism + diff[v]
            # a rebalance is one decision with two legs (victim shrink +
            # winner grant): hysteresis must drop them ATOMICALLY — a
            # suppressed shrink with an actuated grant strands the
            # winner's pods, an actuated shrink with a suppressed grant
            # idles the freed cards for a whole cooldown
            for rec in plan.reclaims:
                if rec.get("reason") != "rebalance":
                    continue
                v, w = rec["victim"], rec["for_job"]
                if v in suppressed and w in target:
                    suppressed[w] = "paired_reclaim"
                    del target[w]
                elif w in suppressed and v in target:
                    suppressed[v] = "paired_reclaim"
                    del target[v]
        if snapshot is not None and plan is not None:
            self.mode_log.append((started, plan.mode))
        if (snapshot is not None and plan is not None
                and any(plan.diff.values())):
            self.plan_records.append(dict(
                t=started,
                jobs={j.uid: (j.parallelism, j.pending, j.pending_age)
                      for j in candidates},
                resource=snapshot,
                curves={j.uid: (None if curves(j.uid) is None
                                else curves(j.uid).to_json())
                        for j in candidates},
                plan=plan, target=dict(target)))
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
            self._advise_goodput(target, plan, curves)
        self._scale_all_jobs(target)
        return target

    def _tick_curve_source(self):
        """One curve fetch per job per tick: wrap ``goodput_curves`` in
        a tick-scoped memo so the planner's resolve pass and the
        advisory path share one KV round-trip per job — with a
        ``load_curve`` wiring every call is a synchronous coordinator
        fetch.  A raising source memoizes None (the planner and the
        advisory both degrade)."""
        src = self.goodput_curves
        if src is None:
            return None
        memo: dict[str, object] = {}

        def cached(uid: str):
            if uid not in memo:
                try:
                    memo[uid] = src(uid)
                except Exception as exc:
                    log.warn("goodput curve lookup failed", job=uid,
                             error=str(exc)[:200])
                    memo[uid] = None
            return memo[uid]

        return cached

    def _note_objective(self, plan) -> None:
        """Record which objective ruled this tick (the
        ``edl_autoscaler_objective{mode=}`` gauge — 1 on the active mode,
        0 on the others, so a scrape always sees all three series) plus
        the preemption/rollback evidence counters."""
        mode = plan.mode if plan is not None else "count"
        self.objective_mode = mode
        gauge = get_registry().gauge(
            "autoscaler_objective",
            help="active packing objective (1 = this mode ruled the "
                 "last plan): goodput | count | degraded")
        for m in ("goodput", "count", "degraded"):
            gauge.set(1.0 if m == mode else 0.0, mode=m)
        if plan is None:
            return
        if plan.preemptions:
            get_counters().inc("sched_preemptions",
                               n=len(plan.preemptions))
            for p in plan.preemptions:
                log.info("preemption planned", **p)
        if plan.reclaims:
            get_counters().inc("sched_reclaims", n=len(plan.reclaims))
        if plan.rollbacks:
            get_counters().inc("sched_gang_rollbacks",
                               n=len(plan.rollbacks))
            for rb in plan.rollbacks:
                log.info("gang admission rolled back", **rb)

    def _advise_goodput(self, target: dict[str, int], plan=None,
                        curves=None) -> None:
        """Log each actuated job's measured marginal throughput per card
        at its new target — the price the goodput objective paid for the
        plan, surfaced next to the decision (and still just a log line
        in count mode).  Reads the tick-scoped curve memo (no second KV
        fetch) and carries the plan's own step price when it granted
        one.  A missing/raising curve source degrades to silence — the
        advisory is never a dependency."""
        if curves is None:
            curves = self._tick_curve_source()
        if curves is None:
            return
        for uid, n in target.items():
            try:
                curve = curves(uid)
                if curve is None:
                    continue
                at = curve.nearest_world_size(n)
                marginal = (curve.marginal_tokens_per_second_per_chip(at)
                            if at is not None else None)
            except Exception as exc:
                log.warn("goodput curve lookup failed", job=uid,
                         error=str(exc)[:200])
                continue
            if marginal is None:
                continue
            advisory = {"job": uid, "target": n, "measured_at": at,
                        "marginal_tok_s_per_chip": round(marginal, 2)}
            if plan is not None and uid in plan.marginals:
                # the exact per-card price the allocator paid for this
                # job's last granted step (GoodputPlan.marginals)
                advisory["priced_at_grant"] = round(
                    plan.marginals[uid], 2)
            log.info("goodput advisory", **advisory)
            self.advisory_history.append(advisory)
            get_counters().inc("autoscaler_goodput_advisories")
            get_registry().gauge(
                "autoscaler_marginal_tokens_per_chip",
                help="measured marginal tok/s per card at the plan's "
                     "target (advisory)").set(marginal, job=uid)

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


# -- serving: SLO-driven replica scaling -------------------------------------


class ServingScaler:
    """The serving policy: scale replica counts on p99-vs-SLO and
    per-replica throughput instead of trainer load.

    Where :class:`Autoscaler` packs trainer counts against cluster
    capacity, a serving fleet defends a LATENCY objective: the windowed
    p99 crossing ``slo_p99_ms`` (or QPS exceeding the per-replica
    target) grows the fleet immediately; sustained headroom shrinks it
    after a cooldown.  Scale-ups fire :attr:`hint_sink` BEFORE
    actuation — the same head start the training prewarm pipeline gets:
    the new replica builds and warms up while the pod is still being
    created, so the ready gate opens (and traffic shifts) with the build
    already paid.

    ``stats_for(uid)`` supplies the signal — a
    :class:`~edl_tpu_torch.runtime.serving.FleetStats`-shaped object
    (windowed p50/p99/qps/queue depth).  The deployed source is the scrape
    plane: :meth:`feed_from` wires a
    :class:`~edl_tpu_torch.observability.scrape.FleetView` built over
    scraped replica ``/metrics``; handing the in-process ``fleet.stats``
    directly remains as a test seam.  ``actuate(uid, n)`` applies the plan; when None, the cluster's
    replica-group dial (``update_trainer_parallelism`` — the group dial
    is workload-agnostic) is used with the same bounded retries the
    trainer path gets.  Deterministic like Autoscaler: :meth:`tick` runs
    one pass; :meth:`run` wraps it for production.
    """

    def __init__(
        self,
        cluster: Optional[Cluster] = None,
        stats_for: Optional[Callable[[str], object]] = None,
        actuate: Optional[Callable[[str, int], None]] = None,
        loop_seconds: float = 2.0,
        scale_down_cooldown_s: float = 30.0,
        scale_up_cooldown_s: float = 2.0,
        shrink_headroom: float = 0.3,
        coord_for: Optional[Callable[[object], object]] = None,
        clock=time.monotonic,
    ) -> None:
        self.cluster = cluster
        self.stats_for = stats_for
        self.actuate = actuate
        #: optional ``coord_for(job) -> kv-client | None``: when set,
        #: every observed tick RECORDS the fleet's (replica_count → qps)
        #: point into the job's goodput :class:`CurveStore`
        #: (``goodput-curve/<job>`` in coordinator KV) — so serving jobs
        #: arrive at the goodput planner with a real measured
        #: QPS-capacity curve, not just the optimistic prior
        self.coord_for = coord_for
        self._curve_stores: dict[str, object] = {}
        self.loop_seconds = loop_seconds
        #: a shrink must wait this long after ANY scaling action — p99
        #: recovers slowly after a resize and a premature shrink would
        #: oscillate; scale-UPS take only the short up-cooldown (an SLO
        #: breach is an emergency, flapping protection still applies)
        self.scale_down_cooldown_s = scale_down_cooldown_s
        self.scale_up_cooldown_s = scale_up_cooldown_s
        #: shrink only while p99 is under this fraction of the SLO (and
        #: the queue is empty) — the hysteresis band between "breach ⇒
        #: grow" and "idle ⇒ shrink"
        self.shrink_headroom = shrink_headroom
        self._clock = clock
        self.jobs: dict[str, object] = {}  # uid → ServingJob
        self._last_change: dict[str, float] = {}
        self._targets: dict[str, int] = {}
        self.plan_history: list[dict] = []
        #: uid → the last plan's post-scale PREDICTION ({target, t,
        #: pred_qps, pred_p99}), resolved against the realized window
        #: once the fleet has settled at the target (calibration plane)
        self._pending_calib: dict[str, dict] = {}
        #: how long after a plan the fleet must sit at the target before
        #: its window counts as the plan's realized outcome (p99 windows
        #: need post-resize requests, not the breach that triggered it)
        self.calib_settle_s = 2 * loop_seconds
        #: fires (uid, target_replicas) the moment a plan is decided,
        #: BEFORE actuation — wire to ServingFleet.hint (in-process) or
        #: to whatever warms pods in a deployment.  Exceptions are
        #: swallowed: hints are an optimization, never a dependency.
        self.hint_sink: Optional[Callable[[str, int], None]] = None
        #: uids whose replica dial the GOODPUT PLANNER owns (train+serve
        #: card arbitration): this policy still observes, records the
        #: capacity curve, and fires prewarm hints, but never actuates —
        #: two loops dialing one group would fight
        self.observe_only: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def feed_from(self, view) -> "ServingScaler":
        """Feed the policy from the scrape plane: ``view`` is a
        :class:`~edl_tpu_torch.observability.scrape.FleetView` whose
        ``stats_for(uid)`` rolls scraped replica ``/metrics`` up into
        the FleetStats shape :meth:`decide` consumes — the scaler sees
        exactly what a scraper can see, no in-process hook."""
        self.stats_for = view.stats_for
        return self

    # -- registry ----------------------------------------------------------

    def on_add(self, job) -> None:
        self.jobs[job.full_name] = job
        self._targets.setdefault(job.full_name, job.spec.min_replicas)

    def on_update(self, job) -> None:
        self.jobs[job.full_name] = job

    def on_del(self, job) -> None:
        self.jobs.pop(job.full_name, None)
        self._last_change.pop(job.full_name, None)
        self._targets.pop(job.full_name, None)
        self._curve_stores.pop(job.full_name, None)
        self._pending_calib.pop(job.full_name, None)
        self.observe_only.discard(job.full_name)
        get_registry().gauge("serving_target_replicas").remove(
            job=job.full_name)

    # -- the policy --------------------------------------------------------

    def decide(self, job, stats, current: int) -> Optional[int]:
        """Pure policy: (spec, windowed stats, current replicas) → new
        target, or None to hold.  Grow on an SLO p99 breach or QPS above
        the per-replica target (queue pressure adds replicas
        proportionally, not one-at-a-time — a traffic step function
        should converge in one or two plans); shrink one step at a time
        inside the headroom band."""
        s = job.spec
        lo, hi = job.group_range()
        current = max(int(current), 1)
        # no window yet (cold fleet, idle service): nothing to decide on
        if stats is None or stats.requests_windowed == 0:
            return None
        want = current
        if s.slo_p99_ms and stats.p99_ms > s.slo_p99_ms:
            # breach: add capacity for the queue we can see — at least
            # one replica, more when the backlog is deep
            backlog = stats.queue_depth / max(s.max_batch_size, 1)
            want = current + max(1, min(int(backlog / max(current, 1)),
                                        current))
        ttft = getattr(stats, "ttft_p99_ms", 0.0)
        slo_ttft = getattr(s, "slo_ttft_ms", 0.0)
        if slo_ttft and ttft > slo_ttft:
            # decode fleet breaching its first-token objective: prefill
            # is starved behind decode — same proportional response
            backlog = stats.queue_depth / max(
                getattr(s, "decode_slots", 1) or 1, 1)
            want = max(want, current + max(
                1, min(int(backlog / max(current, 1)), current)))
        if s.target_qps_per_replica:
            by_qps = int(math.ceil(stats.qps / s.target_qps_per_replica))
            want = max(want, by_qps)
        if want <= current:
            # consider shrinking: p99 comfortably inside the SLO, no
            # queue, and the remaining replicas could absorb the load
            fits_after = (not s.target_qps_per_replica
                          or stats.qps <= s.target_qps_per_replica
                          * (current - 1))
            ttft_ok = (not slo_ttft
                       or ttft < slo_ttft * self.shrink_headroom)
            if (current > lo and stats.queue_depth == 0 and fits_after
                    and ttft_ok
                    and (not s.slo_p99_ms
                         or stats.p99_ms < s.slo_p99_ms
                         * self.shrink_headroom)):
                want = current - 1
        want = max(lo, min(want, hi))
        return want if want != current else None

    def tick(self) -> dict[str, int]:
        """One observe-decide-hint-actuate pass; returns actuated
        targets."""
        actuated: dict[str, int] = {}
        now = self._clock()
        for uid, job in list(self.jobs.items()):
            stats = None
            if self.stats_for is not None:
                try:
                    stats = self.stats_for(uid)
                except Exception as exc:
                    log.warn("serving stats source failed", job=uid,
                             error=str(exc)[:200])
                    continue
            current = self._current(uid, job, stats)
            self._record_capacity(uid, job, stats, current)
            self._resolve_calib(uid, stats, current, now)
            target = self.decide(job, stats, current)
            if target is None:
                continue
            if uid in self.observe_only:
                # card arbitration: the goodput planner owns the dial;
                # this policy's decision survives as the prewarm hint
                # (scale-ups build ahead regardless of who actuates)
                if self.hint_sink is not None and target > current:
                    try:
                        self.hint_sink(uid, target)
                    except Exception as exc:
                        log.warn("serving prewarm hint sink failed",
                                 job=uid, error=str(exc)[:200])
                continue
            last = self._last_change.get(uid, -1e18)
            cooldown = (self.scale_up_cooldown_s if target > current
                        else self.scale_down_cooldown_s)
            if now - last < cooldown:
                get_counters().inc("resizes_suppressed",
                                   reason="serving_cooldown")
                continue
            self._plan(uid, job, stats, current, target, now)
            actuated[uid] = target
        return actuated

    def _record_capacity(self, uid: str, job, stats, current: int) -> None:
        """Fold the live FleetView observation into the job's goodput
        curve: one (replica_count → fleet qps) sample per observed tick,
        persisted under ``goodput-curve/<job>`` so the goodput planner
        prices this fleet's chips from MEASURED capacity.  A saturated
        fleet's curve rises ~linearly with replicas (steep marginal —
        it outbids a flat-curve trainer); a fleet past its demand goes
        flat (its marginal collapses and the chips flow elsewhere).
        Best-effort: a missing coordinator or a raising store never
        perturbs the scaling decision."""
        if (self.coord_for is None or stats is None or current < 1
                or stats.requests_windowed == 0
                or getattr(stats, "qps", 0) <= 0):
            return
        try:
            store = self._curve_stores.get(uid)
            if store is None:
                coord = self.coord_for(job)
                if coord is None:
                    return
                store = CurveStore(coord, uid)
                # seed from the persisted curve: CurveStore's local
                # curve is the authoritative copy it republishes WHOLE
                # on every record — a fresh store after a controller
                # restart must not clobber the fleet's accumulated
                # multi-point curve with a single new cell
                persisted = store.load()
                if persisted is not None:
                    store.curve = persisted
                self._curve_stores[uid] = store
            # recency-bounded fold (~1 min of ticks): the capacity curve
            # must track a traffic step, not freeze into a lifetime
            # demand average the planner can never re-price from
            store.record(current, stats.qps, shape="serving",
                         max_samples=30)
        except Exception as exc:
            log.warn("serving capacity curve record failed", job=uid,
                     error=str(exc)[:200])

    def _resolve_calib(self, uid: str, stats, current: int,
                       now: float) -> None:
        """Close the loop on the last plan's prediction: once the fleet
        has SETTLED at the planned target (settle window elapsed, a
        realized request window exists), pair the plan's predicted
        post-scale qps/p99 with what the window measured.  A superseded
        or never-reached target resolves to nothing — a prediction
        scored against a different fleet size calibrates nothing."""
        pend = self._pending_calib.get(uid)
        if pend is None or stats is None:
            return
        age = now - pend["t"]
        if age < self.calib_settle_s:
            return
        if current != pend["target"] or age > 20 * self.calib_settle_s:
            self._pending_calib.pop(uid, None)
            return
        if stats.requests_windowed == 0:
            return  # settled but idle: keep waiting for a real window
        if pend.get("pred_qps"):
            calib.record("serving_scale_qps", pend["pred_qps"],
                         getattr(stats, "qps", 0.0), unit="qps", job=uid)
        if pend.get("pred_p99"):
            calib.record("serving_scale_p99", pend["pred_p99"],
                         getattr(stats, "p99_ms", 0.0), unit="ms",
                         job=uid)
        self._pending_calib.pop(uid, None)

    def _current(self, uid: str, job, stats) -> int:
        if stats is not None and getattr(stats, "replicas_active", 0):
            return stats.replicas_active
        if self.cluster is not None:
            try:
                return self.cluster.get_trainer_parallelism(job)
            except Exception:
                pass
        return self._targets.get(uid, job.spec.min_replicas)

    def _plan(self, uid: str, job, stats, current: int, target: int,
              now: float) -> None:
        direction = "up" if target > current else "down"
        log.info("serving scaling plan", job=uid, replicas=current,
                 target=target, direction=direction,
                 p99_ms=getattr(stats, "p99_ms", None),
                 qps=getattr(stats, "qps", None),
                 queue=getattr(stats, "queue_depth", None),
                 slo_p99_ms=job.spec.slo_p99_ms)
        self.plan_history.append({
            "job": uid, "from": current, "target": target,
            "p99_ms": getattr(stats, "p99_ms", None),
            "qps": getattr(stats, "qps", None)})
        # calibration: stash what this plan PREDICTS the post-scale
        # window looks like.  Post-scale qps: the measured capacity
        # curve at the target when growing into known capacity, else
        # demand carryover (a resize does not change offered load).
        # Post-scale p99: the SLO the plan promises to restore (that IS
        # the scaler's latency model).  Resolved by _resolve_calib.
        pred_qps = None
        store = self._curve_stores.get(uid)
        if store is not None and target > current:
            try:
                pred_qps = store.curve.tokens_per_second(target)
            except Exception:
                pred_qps = None
        if not pred_qps:
            pred_qps = getattr(stats, "qps", None)
        self._pending_calib[uid] = {
            "target": target, "t": now, "pred_qps": pred_qps,
            "pred_p99": job.spec.slo_p99_ms or None}
        get_counters().inc("autoscaler_serving_plans", direction=direction)
        get_registry().gauge(
            "serving_target_replicas",
            help="the serving policy's current replica target"
        ).set(target, job=uid)
        if self.hint_sink is not None and target > current:
            # hint BEFORE actuation: the plan is the earliest moment the
            # new replica count is known — every millisecond of head
            # start is serve-step compile time off the traffic path
            try:
                self.hint_sink(uid, target)
            except Exception as exc:
                log.warn("serving prewarm hint sink failed", job=uid,
                         error=str(exc)[:200])
        self._targets[uid] = target
        self._last_change[uid] = now
        if self.actuate is not None:
            try:
                self.actuate(uid, target)
            except Exception as exc:
                log.warn("serving actuation failed", job=uid,
                         error=str(exc)[:200])
            return
        if self.cluster is not None:
            for retry in range(UPDATE_RETRIES):
                try:
                    self.cluster.update_trainer_parallelism(job, target)
                    break
                except Exception as exc:
                    log.warn("error updating server group", job=uid,
                             error=str(exc),
                             remaining_retry=UPDATE_RETRIES - retry - 1)

    # -- loop --------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.loop_seconds)

    def start(self) -> None:
        self.register_metrics()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="serving-scaler")
        self._thread.start()

    def register_metrics(self, registry=None) -> None:
        if registry is None:
            registry = get_registry()
        registry.gauge_fn("serving_jobs_tracked",
                          lambda: len(self.jobs),
                          help="serving jobs under SLO autoscaling")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
