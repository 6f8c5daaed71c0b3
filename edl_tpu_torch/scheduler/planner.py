"""The pure elastic planner — the port's copy of edl_tpu.scheduler.planner,
its count objective.

Behavioral port of the reference's dry-run scaling core
(reference pkg/autoscaler.go:191-337):

* ``scale_dry_run``       ~ scaleDryRun        (autoscaler.go:201-291)
* ``scale_all_jobs_dry_run`` ~ scaleAllJobsDryRun (autoscaler.go:296-337)
* ``sorted_jobs``         ~ sortedJobs + jobs.Less (autoscaler.go:99-125, 175-189)
* ``PlannedJob.fulfillment`` ~ job.Fulfillment  (autoscaler.go:54-64)
* ``search_assignable_nodes`` ~ searchAssignableNode (autoscaler.go:191-199)

The planner is a pure function over a value-type :class:`ClusterResource`
snapshot — the reference's single best design decision (it takes the snapshot
by value at autoscaler.go:296), which makes the whole scheduling policy
unit-testable with zero infrastructure.  All accounting is done in the same
units (CPU milli-cores, memory megabytes, whole GPU cards, the reference's
own accelerator dimension), and a GPU job stays inside one NVLink domain
unless it opts out (``trainer.allow_multi_domain``).

Each job may carry a :class:`SliceShapePolicy` quantizing its
instance-count walk to valid mesh sizes (see
edl_tpu_torch.scheduler.topology).  With the default unit policy the
behavior is the reference's, which tests/test_torch_planner.py holds side
by side with the JAX package's planner on the same snapshots.

Two objectives live here, behind the one entry point the autoscaler and
the scheduler simulation (scheduler/sim.py) call, :func:`plan_cluster`:

* :func:`scale_all_jobs_dry_run` — the reference's COUNT-based packer:
  every card granted to every job is worth the same, jobs are leveled by
  fulfillment.  Unchanged, and the degraded-mode fallback.
* :func:`scale_all_jobs_goodput` — the MARGINAL-GOODPUT allocator: cards
  are granted (and reclaimed) by descending measured
  ``marginal_tokens_per_second_per_chip`` from each job's
  :class:`~edl_tpu_torch.observability.goodput.ScalingCurve`, layered with
  priorities, pending-gang preemption (planned resizes of cheapest-
  marginal victims, floored at min_instance, rolled back whole when no
  domain can land the gang) and whole-gang NVLink placement.  Jobs may be
  TrainingJobs or ServingJobs — a serving fleet's "curve" is its measured
  QPS-capacity vs replica count, so a saturated fleet (steep curve)
  outbids a flat-curve trainer in the same loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.resource import ClusterResource
from edl_tpu_torch.scheduler.topology import SliceShapePolicy, UNIT_POLICY

#: marginal value assumed for a job with no measured curve: optimistic
#: (+inf outranks every measured marginal) so unmeasured jobs still get
#: capacity and become measured — exploration is never starved by honest
#: pricing of the already-measured fleet
OPTIMISTIC_PRIOR = float("inf")

#: a same-priority reclaim (shrink B to grow A) requires A's marginal to
#: beat B's by this fractional headroom — the hysteresis band that keeps
#: two jobs with near-equal curves from trading the same cards forever
REBALANCE_HEADROOM = 0.25

#: starvation aging: an INFEASIBLE gang (no domain can hold it right
#: now) is excluded from the over-commit arithmetic — but only for this
#: many consecutive plans.  Past it, the gang's claim re-enters the
#: drain so capacity is carved toward it anyway (the count packer's
#: blind-drain behavior) — throughput-protective exclusion must never
#: become tail-latency starvation.
GANG_STARVATION_PLANS = 3


@dataclass
class PlannedJob:
    """A job as the planner sees it: config + current parallelism.

    Role of the reference's ``job`` struct (autoscaler.go:34-37), with the
    live batch ``Job``'s Parallelism flattened to an int.  ``config`` is
    any kind speaking the replica-group protocol (group_range /
    group_resources / gpus_per_replica / sched_priority) — a
    TrainingJob's trainer group or a ServingJob's server fleet plan
    through the same accessors.
    """

    config: TrainingJob
    parallelism: int = 0
    shape_policy: SliceShapePolicy = field(default=UNIT_POLICY)
    #: pods requested but not yet placed (a pending gang waiting for
    #: capacity) — what the goodput objective's admission/preemption
    #: phase works from
    pending: int = 0
    #: consecutive plans this job has been seen pending (tracked by the
    #: caller — Autoscaler/sim).  Preemption is AGE-GATED: a gang
    #: pending for 0 plans may well be placed by the kubelet before the
    #: next tick, so only an age-tested gang shrinks victims — an
    #: arrival burst at light load must not churn running jobs.
    pending_age: int = 0

    @property
    def name(self) -> str:
        return self.config.name

    @property
    def uid(self) -> str:
        """namespace/name — the key all planner/autoscaler maps use, so
        same-named jobs in different namespaces never collide."""
        u = self.__dict__.get("_uid")
        if u is None:
            u = self.__dict__["_uid"] = self.config.full_name
        return u

    @property
    def priority(self) -> int:
        """Scheduling priority (api.types.SchedPriority scale)."""
        fn = getattr(self.config, "sched_priority", None)
        return int(fn()) if fn is not None else 1

    # Accounting accessors — reference autoscaler.go:39-52, generalized
    # to the replica-group protocol both job kinds speak.  The resource
    # scalars are memoized: they are pure functions of the (immutable
    # per planning pass) config, Quantity math is Fraction math, and
    # the goodput allocator reads them tens of thousands of times per
    # plan at fleet size.
    def gpu_limit(self) -> int:
        v = self.__dict__.get("_gpus")
        if v is None:
            v = self.__dict__["_gpus"] = self.config.gpus_per_replica()
        return v

    def cpu_request_milli(self) -> int:
        v = self.__dict__.get("_cpu_milli")
        if v is None:
            v = self.__dict__["_cpu_milli"] = (
                self.config.group_resources().cpu_request().milli_value())
        return v

    def mem_request_mega(self) -> int:
        v = self.__dict__.get("_mem_mega")
        if v is None:
            v = self.__dict__["_mem_mega"] = (
                self.config.group_resources().memory_request()
                .scaled_value(6))
        return v

    def fulfillment(self) -> float:
        """How satisfied the job is in [0, 1] — reference autoscaler.go:54-64."""
        lo, hi = self.config.group_range()
        if lo == hi:
            return 1.0
        return (self.parallelism - lo) / (hi - lo)

    def elastic(self) -> bool:
        return self.config.elastic()

    def need_gpu(self) -> bool:
        # need_gpu() is cards-per-replica > 0; read it
        # through the memoized accessor (the raw path is Fraction math)
        return self.gpu_limit() > 0

    def multi_domain(self) -> bool:
        """Multi-domain opt-in (TrainingJob trainer flag; serving fleets
        are independent replicas — each replica is its own mesh — so the
        single-domain gang rule binds per replica, not per fleet)."""
        trainer = getattr(self.config.spec, "trainer", None)
        if trainer is not None:
            return bool(trainer.allow_multi_domain)
        # a serving fleet's replicas don't share one mesh: replicas
        # may land on any fabric, so placement-wise it spans
        return True


def sorted_jobs(jobs: Iterable[PlannedJob], *filters) -> list[PlannedJob]:
    """Ascending by fulfillment, tiebroken by card limit, then CPU request,
    then memory request (reference autoscaler.go:103-125, 175-189): the
    *least* fulfilled, *cheapest* job scales up first."""
    out = [j for j in jobs if all(f(j) for f in filters)]
    out.sort(
        key=lambda j: (
            j.fulfillment(),
            j.gpu_limit(),  # same accessor the accounting path uses
            j.config.group_resources().cpu_request().exact,
            j.config.group_resources().memory_request().exact,
        )
    )
    return out


def elastic(j: PlannedJob) -> bool:
    """Filter: elastic jobs only (reference autoscaler.go:132-134)."""
    return j.elastic()


def need_gpu(j: PlannedJob) -> bool:
    """Filter: accelerator jobs only (role of gpu(), autoscaler.go:137-139)."""
    return j.need_gpu()


def search_assignable_nodes(
    r: ClusterResource, j: PlannedJob, count: int
) -> Optional[tuple[list[str], Optional[str]]]:
    """Find nodes with headroom for ``count`` more instances of ``j``
    (generalizes searchAssignableNode, reference autoscaler.go:191-199).

    Greedy: instances may land on the same node while it has headroom.
    Returns ``(chosen_node_per_instance, nvlink_domain)`` or None if the
    instances do not fit.  Does NOT mutate ``r``.

    NVLink contiguity (where the JAX package keeps a TPU job on one ICI
    domain): a GPU job's tp and fsdp collectives must ride NVLink, so every
    card instance — existing and planned — must live in ONE NVLink domain.
    A job already running (or already grown in an earlier fixpoint round —
    ``r.jobs_nvlink_domain``) is pinned to its domain; an unpinned job
    considers each domain whole, preferring the one with the most free
    cards (best packing headroom), name-tiebroken for determinism.  The
    fake kubelet enforces the same rule at placement time
    (cluster/fake.py), so a plan accepted here never strands Pending pods
    on a domain boundary.

    Multi-domain opt-out (``trainer.allow_multi_domain``): a job whose
    gradient sync may ride the network between domains may span them —
    instances place across domains ordered most-free-cards-first, so the
    job still consolidates into as few domains as possible (single-domain
    whenever it fits) and is never pinned.  Without the opt-in, elastic
    growth deliberately caps at the largest domain.
    """
    cpu = j.cpu_request_milli()
    mem = j.mem_request_mega()
    gpus = j.gpu_limit()

    def try_nodes(allowed: Optional[list[str]]) -> Optional[list[str]]:
        # copy/scan only the candidate nodes: on a fleet of single-host
        # domains an unpinned job tries many domains, and full-cluster
        # copies per attempt would make this O(domains x nodes)
        names = (r.nodes.nodes_cpu_idle_milli if allowed is None
                 else allowed)
        idle_cpu = {n: r.nodes.nodes_cpu_idle_milli[n] for n in names}
        free_mem = {n: r.nodes.nodes_memory_free_mega.get(n, 0)
                    for n in names}
        free_gpu = {n: r.nodes.nodes_gpu_free[n] for n in names
                    if n in r.nodes.nodes_gpu_free}
        chosen: list[str] = []
        for _ in range(count):
            placed = False
            for name, idle in idle_cpu.items():
                if cpu <= idle and mem <= free_mem.get(name, 0):
                    # Card-aware placement: only enforced when the snapshot
                    # tracks cards for this node (the reference tracked
                    # CPU/mem only).
                    if gpus and name in free_gpu and free_gpu[name] < gpus:
                        continue
                    idle_cpu[name] = idle - cpu
                    free_mem[name] -= mem
                    if name in free_gpu:
                        free_gpu[name] -= gpus
                    chosen.append(name)
                    placed = True
                    break
            if not placed:
                return None
        return chosen

    if not gpus:
        nodes = try_nodes(None)
        return (nodes, None) if nodes is not None else None

    # insertion-ordered node lists keep placement deterministic (the same
    # snapshot always yields the same plan, the property every planner test
    # relies on)
    by_domain: dict[str, list[str]] = {}
    for name in r.nodes.nodes_cpu_idle_milli:
        by_domain.setdefault(r.nodes.domain_of(name), []).append(name)

    free_gpus = lambda d: sum(
        r.nodes.nodes_gpu_free.get(n, 0) for n in by_domain[d])

    if j.multi_domain():
        # multi-domain job: still consolidate when possible — try each
        # domain WHOLE first (most-free-cards order), and only when no
        # single domain holds the step fall back to one greedy pass over
        # all nodes in the same domain order.  (A naive single greedy pass
        # can spill even when a fit exists: with domains {4,2} and {6}
        # free and two 3-card instances, greedy starts in the 6-card
        # most-free domain... or lands one instance in a roomy node of a
        # domain whose remainder can't take the second.)  No pin in either
        # case — a pin would re-cap the job at one domain.
        domain_order = sorted(by_domain, key=lambda d: (-free_gpus(d), d))
        for domain in domain_order:
            nodes = try_nodes(by_domain[domain])
            if nodes is not None:
                return nodes, None
        ordered = [n for d in domain_order for n in by_domain[d]]
        nodes = try_nodes(ordered)
        return (nodes, None) if nodes is not None else None

    pinned = r.jobs_nvlink_domain.get(j.uid)
    if pinned is not None:
        candidates = [pinned] if pinned in by_domain else []
    else:
        candidates = sorted(by_domain, key=lambda d: (-free_gpus(d), d))
    for domain in candidates:
        nodes = try_nodes(by_domain[domain])
        if nodes is not None:
            return nodes, domain
    return None


def scale_dry_run(
    r: ClusterResource,
    j: PlannedJob,
    cur_diff: int,
    max_load_desired: float,
    scale_down: bool,
) -> int:
    """One planning step for one job; mutates ``r``'s accounting by the
    returned delta.  Port of scaleDryRun (reference autoscaler.go:201-291),
    generalized from ±1 steps to the job's slice-shape policy steps.
    """
    cpu = j.cpu_request_milli()
    mem = j.mem_request_mega()
    gpus = j.gpu_limit()
    policy = j.shape_policy

    planned = j.parallelism + cur_diff
    lo, hi = j.config.group_range()

    additional = 0
    assigned_nodes: list[str] = []
    assigned_domain: Optional[str] = None

    def account() -> int:
        # Adjust-resource-upon-return block (reference autoscaler.go:209-217).
        r.gpu_limit += gpus * additional
        r.cpu_request_milli += cpu * additional
        r.memory_request_mega += mem * additional
        for node in assigned_nodes:
            r.nodes.nodes_cpu_idle_milli[node] -= cpu
            r.nodes.nodes_memory_free_mega[node] -= mem
            if node in r.nodes.nodes_gpu_free:
                r.nodes.nodes_gpu_free[node] -= gpus
        if assigned_nodes and assigned_domain is not None:
            # Pin the dry-run's domain choice so later fixpoint rounds keep
            # growing this job in the same NVLink domain.
            r.jobs_nvlink_domain.setdefault(j.uid, assigned_domain)
        return additional

    # ===================== scale down (autoscaler.go:230-248) =============
    if scale_down:
        if planned > hi:
            # Forced over max: step down to the next valid count (the
            # reference's unconditional -1, quantized).
            additional = policy.next_down(planned, lo) - planned
            return account()
        # Cards drain only on true over-commit (capacity loss), not at
        # max_load_desired: the up-pass deliberately packs accelerators to
        # 100% (reference's own NOTE at autoscaler.go:270-271), and the
        # reference's down-pass GPULimit > Total*maxLoadDesired check
        # (autoscaler.go:235) contradicts it — on a small cluster a full
        # pack would be planned and immediately reversed, capping card jobs
        # at floor(total*mld) forever.  Idle cards are pure waste;
        # the CPU ceiling below keeps its reference semantics.
        over_gpu = r.gpu_limit > r.gpu_total
        over_cpu = r.cpu_request_milli > r.cpu_total_milli * max_load_desired
        if over_gpu or over_cpu:
            if planned > lo:
                # next_down floors at lo; returns planned ("no step") when
                # no valid count exists in [lo, planned).
                additional = policy.next_down(planned, lo) - planned
                return account()
            return 0  # cannot scale down further
        return 0  # not overloaded: a down pass never scales up

    # ===================== scale up (autoscaler.go:252-290) ===============
    if planned >= hi:
        # At (or forced over) max: clamp to the largest *valid* count <= max,
        # never grow (reference jumps to max; we additionally re-quantize so
        # e.g. a POW2 job whose max was lowered to 6 lands on 4, not 6).
        if planned > hi:
            target = policy.clamp(hi, lo)
            if target > 0:  # no valid count in [lo, hi] → take no step
                additional = target - planned
        return account()

    target = policy.next_up(planned, hi)
    step = target - planned
    if step <= 0:
        return 0  # no valid mesh size between planned and max

    if r.memory_total_mega - r.memory_request_mega <= mem * step:
        return 0  # insufficient memory headroom (autoscaler.go:259-263)

    found = search_assignable_nodes(r, j, step)
    if found is None:
        return 0  # no node fits (autoscaler.go:264-267)
    nodes, domain = found

    # CPU is capped at max_load_desired of the cluster; accelerators may be
    # packed to 100% (autoscaler.go:269-278).
    cpu_ok = r.cpu_total_milli * max_load_desired - r.cpu_request_milli >= cpu * step
    gpu_ok = (not gpus) or (r.gpu_total - r.gpu_limit >= gpus * step)

    if cpu_ok and gpu_ok:
        additional = step
        assigned_nodes = nodes
        assigned_domain = domain
    return account()


def scale_all_jobs_dry_run(
    jobs: Iterable[PlannedJob],
    r: ClusterResource,
    max_load_desired: float = 1.0,
) -> dict[str, int]:
    """Compute the per-job instance delta for the whole cluster, keyed by
    job uid (namespace/name).

    Port of scaleAllJobsDryRun (reference autoscaler.go:296-337): iterate to
    a fixpoint; each round does an up-pass over elastic jobs neediest-first,
    then a down-pass least-needy-first.  Operates on a *copy* of ``r``.
    """
    r = r.copy()
    diff: dict[str, int] = {}

    while True:
        no_change = True
        ordered = sorted_jobs(jobs, elastic)

        def dry_run(j: PlannedJob, is_scale_down: bool) -> None:
            nonlocal no_change
            additional = scale_dry_run(
                r, j, diff.get(j.uid, 0), max_load_desired, is_scale_down
            )
            diff[j.uid] = diff.get(j.uid, 0) + additional
            if additional != 0:
                no_change = False

        for j in ordered:  # scale up the neediest first
            dry_run(j, False)
        for j in reversed(ordered):  # scale down the least needy first
            dry_run(j, True)

        if no_change:
            break

    return diff


# ---------------------------------------------------------------------------
# The marginal-goodput objective
# ---------------------------------------------------------------------------


@dataclass
class GoodputPlan:
    """What the goodput allocator decided, and why.

    ``diff`` has the same shape/keys as :func:`scale_all_jobs_dry_run`
    (uid → instance delta) so the autoscaler's actuation path is
    objective-agnostic; the rest is the evidence trail: every preemption
    (a victim shrink performed so a higher-priority pending gang can
    land), every reclaim (over-commit drain or marginal rebalance), and
    every rollback (a gang no domain could hold even after shrinking
    all eligible victims to min — nothing was shrunk for it).
    """

    diff: dict[str, int]
    mode: str  # "goodput" | "degraded" | "count"
    preemptions: list[dict] = field(default_factory=list)
    reclaims: list[dict] = field(default_factory=list)
    rollbacks: list[dict] = field(default_factory=list)
    #: uid → the marginal tok/s-per-card that priced the job's last
    #: granted step (measured jobs only; prior-priced grants are omitted)
    marginals: dict[str, float] = field(default_factory=dict)


def _step_marginal(curve, n_to: int, gpus_per_instance: int,
                   prior: float, calib_factor: float = 1.0) -> float:
    """Price one up-step ending at ``n_to`` instances: the curve's
    marginal tok/s per card read at the nearest measured size (the slope
    of the last measured step rules beyond the measured range — linear
    extrapolation; the smallest measured point's average rules below
    it), normalized by this job's cards per instance.  No curve → the
    optimistic prior.

    ``calib_factor`` is the calibration plane's measured/predicted
    correction for curve-derived predictions (the ``goodput_curve``
    factor): it scales ONLY the measured branch — the optimistic prior
    is a deliberate exploration bonus, not a curve prediction, and
    correcting it would just rename the prior."""
    if curve is None:
        return prior
    try:
        at = curve.nearest_world_size(n_to)
        if at is None:
            return prior
        m = curve.marginal_tokens_per_second_per_chip(at)
    except Exception:
        return prior
    if m is None:
        return prior
    return m / max(gpus_per_instance, 1) * calib_factor


def scale_all_jobs_goodput(
    jobs: Iterable[PlannedJob],
    r: ClusterResource,
    max_load_desired: float = 1.0,
    curves: Optional[Callable[[str], object]] = None,
    optimistic_prior: float = OPTIMISTIC_PRIOR,
    rebalance_headroom: float = REBALANCE_HEADROOM,
    calibration=None,
) -> GoodputPlan:
    """The marginal-goodput allocator: grant (and reclaim) cards by
    descending measured marginal-throughput-per-card, under priorities,
    pending-gang preemption, and whole-gang NVLink placement.

    Phases, in order, over a copy of ``r`` (the same value-semantics
    discipline as the count packer):

    0. **clamp** — jobs found over max step down to the largest valid
       count (parity with the count packer's forced-down rule).
    1. **gang admission + preemption** — each pending gang, highest
       priority first, either reserves free cards in a feasible NVLink
       domain, or (if it outranks running work) shrinks strictly-lower-
       priority elastic victims in one domain — cheapest marginal first,
       never below min_instance — until the whole gang fits there.  A
       gang no domain can hold is ROLLED BACK whole: nothing is shrunk
       for it, and its pending claim is excluded from the over-commit
       arithmetic so it cannot churn the fleet either.
    2. **over-commit drain** — capacity loss or equal-priority pending
       claims shrink the cheapest-marginal victims first (the count
       packer's admission-by-shrinking, re-ranked by marginal value).
    3. **marginal up-pass** — repeatedly grant the single highest-value
       step in the fleet: (priority, marginal, neediness)-ordered, each
       step placed whole via :func:`search_assignable_nodes` (gang
       discipline: a step that cannot land entirely in a feasible
       domain is not granted at all).  Unmeasured jobs price at the
       optimistic prior so exploration happens.  A measured job whose
       step is capacity-blocked may RECLAIM from a cheaper victim in
       its domain (same priority requires a ``rebalance_headroom``
       marginal dominance; lower priority just the dominance) — the
       shrink is planned now, the grant lands a tick later once the
       victim's pods have actually vacated.

    Degraded mode: when NO job resolves a measured curve there is
    nothing to price by, and the plan falls back to
    :func:`scale_all_jobs_dry_run` bit-for-bit (``mode="degraded"``).

    ``calibration`` (opt-in, the calibration plane's read-back hook) is
    a :class:`~edl_tpu_torch.observability.calib.CalibrationFactors`-shaped
    object (``factor(predictor) -> float``) or a plain callable; when
    supplied, curve-derived marginals are scaled by the persisted
    ``goodput_curve`` measured/predicted factor, so an optimistic curve
    (factor < 1) stops over-granting before the curve itself re-learns.
    """
    jobs = list(jobs)
    resolved: dict[str, object] = {}
    for j in jobs:
        c = None
        if curves is not None:
            try:
                c = curves(j.uid)
                if c is not None and not c.world_sizes():
                    c = None
            except Exception:
                c = None
        resolved[j.uid] = c
    if not any(c is not None for c in resolved.values()):
        return GoodputPlan(
            diff=scale_all_jobs_dry_run(jobs, r, max_load_desired),
            mode="degraded")

    r = r.copy()
    diff: dict[str, int] = {j.uid: 0 for j in jobs}
    plan = GoodputPlan(diff=diff, mode="goodput")

    def planned(j: PlannedJob) -> int:
        return j.parallelism + diff[j.uid]

    _floor_cache: dict[tuple[str, int], int] = {}

    def floor_of(j: PlannedJob) -> int:
        """Lowest valid count reachable from planned(j) by policy steps
        (>= min_instance) — where preemption/reclaim must stop.
        Memoized per (job, planned): the reclaim feasibility scans read
        it for every victim candidate."""
        n = planned(j)
        key = (j.uid, n)
        v = _floor_cache.get(key)
        if v is None:
            lo = j.config.group_range()[0]
            while True:
                m = j.shape_policy.next_down(n, lo)
                if m >= n:
                    break
                n = m
            v = _floor_cache[key] = n
        return v

    # curves are immutable within one plan: memoize the pricing — the
    # up-pass re-prices every candidate per grant, and each raw read
    # takes the curve's lock and walks its cells
    _price_cache: dict[tuple[str, int], float] = {}

    # the read-back factor is resolved ONCE per plan (one KV-backed
    # lookup, not one per candidate re-price) and degrades to neutral
    calib_factor = 1.0
    if calibration is not None:
        try:
            calib_factor = float(
                calibration.factor("goodput_curve")
                if hasattr(calibration, "factor")
                else calibration("goodput_curve"))
        except Exception:
            calib_factor = 1.0
        if not calib_factor > 0.0:
            calib_factor = 1.0

    def step_marginal(j: PlannedJob, n_to: int) -> float:
        key = (j.uid, n_to)
        m = _price_cache.get(key)
        if m is None:
            m = _step_marginal(resolved[j.uid], n_to, j.gpu_limit(),
                               optimistic_prior, calib_factor)
            _price_cache[key] = m
        return m

    def hold_marginal(j: PlannedJob) -> Optional[float]:
        """What j's topmost held step is worth (the cost of shrinking
        it one step) — None when j is at its floor."""
        lo = j.config.group_range()[0]
        p = planned(j)
        prev = j.shape_policy.next_down(p, lo)
        if prev >= p:
            return None
        return step_marginal(j, p)

    def up_target(j: PlannedJob) -> Optional[int]:
        lo, hi = j.config.group_range()
        p = planned(j)
        if p >= hi:
            return None
        if p < lo:
            # whole-gang discipline: a sub-min job grows straight to the
            # smallest valid count >= min, never to a partial gang
            t = j.shape_policy.next_up(max(lo - 1, 0), hi)
            return t if t >= lo else None
        t = j.shape_policy.next_up(p, hi)
        return t if t > p else None

    def account_totals(j: PlannedJob, delta: int) -> None:
        # scale-downs move the cluster totals only, like the count
        # packer's down path: which NODES a shrinking job vacates is the
        # kubelet's knowledge, visible in the next tick's snapshot
        r.gpu_limit += j.gpu_limit() * delta
        r.cpu_request_milli += j.cpu_request_milli() * delta
        r.memory_request_mega += j.mem_request_mega() * delta

    _dom_nodes: dict[Optional[str], list[str]] = {None: []}
    for n in r.nodes.nodes_cpu_idle_milli:
        _dom_nodes.setdefault(r.nodes.domain_of(n), []).append(n)
        _dom_nodes[None].append(n)
    domains = sorted(d for d in _dom_nodes if d is not None)

    def domain_nodes(d: Optional[str]) -> list[str]:
        return _dom_nodes.get(d, [])

    def free_gpus(d: Optional[str]) -> int:
        return sum(r.nodes.nodes_gpu_free.get(n, 0)
                   for n in domain_nodes(d))

    def reserve_gpus(d: Optional[str], need: int) -> None:
        """Earmark ``need`` free cards (domain ``d``, or anywhere when
        None) for a pending gang by taking them out of the visible node
        maps — the up-pass can no longer grant capacity a gang was just
        promised.  Totals are untouched: the gang's pending pods already
        count in gpu_limit/cpu_request."""
        nodes = sorted(domain_nodes(d),
                       key=lambda n: (-r.nodes.nodes_gpu_free.get(n, 0), n))
        left = need
        for n in nodes:
            take = min(r.nodes.nodes_gpu_free.get(n, 0), left)
            if take > 0:
                r.nodes.nodes_gpu_free[n] -= take
                left -= take
            if left <= 0:
                return

    def shrink_one_step(v: PlannedJob) -> int:
        """One policy step down (floored); returns cards freed."""
        p = planned(v)
        m = v.shape_policy.next_down(p, v.config.group_range()[0])
        if m >= p:
            return 0
        diff[v.uid] += m - p
        account_totals(v, m - p)
        return (p - m) * v.gpu_limit()

    def victim_order(v: PlannedJob):
        hm = hold_marginal(v)
        return (v.priority, hm if hm is not None else math.inf,
                -v.fulfillment(), v.uid)

    def shrinkable_gpus(v: PlannedJob, d: Optional[str]) -> int:
        """Chips v could yield toward domain ``d`` (None = anywhere) by
        shrinking to its floor.  A victim PINNED to another domain
        yields nothing here; an UNPINNED card victim (a multi-domain
        job, a serving fleet whose replicas spread) counts everywhere —
        the snapshot cannot say which nodes its pods vacate, so the
        claim is optimistic and the admission converges over ticks,
        exactly like the count packer's blind drain."""
        if not v.elastic() or not v.need_gpu():
            return 0
        if d is not None:
            vd = r.jobs_nvlink_domain.get(v.uid)
            if vd is not None and vd != d:
                return 0
        return (planned(v) - floor_of(v)) * v.gpu_limit()

    def reclaim_for(needer: PlannedJob, need_pods: int,
                    eligible: Callable[[PlannedJob], bool],
                    reason: str, reserve_free: bool = True) -> str:
        """All-or-nothing capacity transfer toward ``needer``'s next
        ``need_pods`` instances.  In order:

        * the gang PLACES whole on real nodes right now →
          ``"reserved"``: those exact node cards (+cpu/mem) are
          earmarked so the up-pass cannot grant capacity a pending gang
          was just promised (``reserve_free=False`` skips the earmark —
          the rebalance path must not hide free capacity it cannot use);
        * some domain's free cards plus what ``eligible`` victims there
          can yield cover the need → ``"preempted"``: victims shrink
          cheapest-marginal-first, never below their floor, and the
          domain's free part is earmarked;
        * a domain could hold it only if ANY-priority victims yielded →
          ``"blocked"`` (the over-commit drain's business — nothing is
          shrunk here);
        * no domain can ever hold it → ``"infeasible"`` (shrink no one).
        """
        gpus = needer.gpu_limit()
        need_gpus = need_pods * gpus
        found = search_assignable_nodes(r, needer, need_pods)
        if found is not None:
            if reserve_free:
                nodes, _ = found
                cpu, mem = needer.cpu_request_milli(), needer.mem_request_mega()
                for n in nodes:
                    r.nodes.nodes_cpu_idle_milli[n] -= cpu
                    r.nodes.nodes_memory_free_mega[n] -= mem
                    if n in r.nodes.nodes_gpu_free:
                        r.nodes.nodes_gpu_free[n] -= gpus
            return "reserved"
        if needer.multi_domain():
            cand: list[Optional[str]] = [None]
        else:
            pin = r.jobs_nvlink_domain.get(needer.uid)
            cand = [pin] if pin is not None else list(domains)
        feasible_somewhere = False
        for d in cand:
            have = free_gpus(d)
            if have + sum(shrinkable_gpus(v, d) for v in jobs
                          if v is not needer) >= need_gpus:
                feasible_somewhere = True
            shortfall = need_gpus - have
            if shortfall <= 0:
                # cards are free but fragmented (the whole-gang walk
                # above failed): shrinking victims would not obviously
                # defragment — wait for natural churn instead
                continue
            victims = []
            for v in jobs:
                if v is needer or shrinkable_gpus(v, d) <= 0:
                    continue
                if not eligible(v):
                    continue
                victims.append(v)
            victims.sort(key=victim_order)
            reclaimable = sum(shrinkable_gpus(v, d) for v in victims)
            if have + reclaimable < need_gpus:
                continue
            freed = 0
            for v in victims:
                while freed < shortfall:
                    before = planned(v)
                    got = shrink_one_step(v)
                    if got == 0:
                        break
                    freed += got
                    rec = {"victim": v.uid, "for_job": needer.uid,
                           "from": before, "to": planned(v),
                           "domain": d, "reason": reason}
                    (plan.preemptions if reason == "preempt"
                     else plan.reclaims).append(rec)
                if freed >= shortfall:
                    break
            reserve_gpus(d, have)  # the free part is spoken for too
            return "preempted"
        return "blocked" if feasible_somewhere else "infeasible"

    # -- phase 0: clamp anything found over max (count-packer parity) ------
    for j in sorted(jobs, key=lambda j: j.uid):
        lo, hi = j.config.group_range()
        if planned(j) > hi:
            target = j.shape_policy.clamp(hi, lo)
            if target > 0:
                delta = target - planned(j)
                diff[j.uid] += delta
                account_totals(j, delta)

    # -- phase 1: pending gangs — admission + priority preemption ----------
    unplaceable_pending_gpus = 0
    gangs = sorted((j for j in jobs if j.pending > 0 and j.need_gpu()),
                   key=lambda j: (-j.priority, j.fulfillment(), j.uid))
    for g in gangs:
        need_pods = min(g.pending, max(planned(g), 0))
        need = need_pods * g.gpu_limit()
        if need <= 0:
            continue
        outcome = reclaim_for(
            g, need_pods,
            # age gate: a freshly-pending gang reserves free capacity
            # but does not yet shrink anyone — if it is still pending at
            # the next plan, it has earned the preemption
            eligible=(lambda v, g=g: v.priority < g.priority)
            if g.pending_age >= 1 else (lambda v: False),
            reason="preempt")
        if outcome == "infeasible":
            # no domain can hold this gang even with every elastic
            # victim at floor: roll it back whole — nothing is shrunk
            # for it, and its pending claim is kept out of the
            # over-commit arithmetic so it cannot churn the fleet.
            # Starvation aging bounds the exclusion: a gang pending
            # past GANG_STARVATION_PLANS re-enters the drain, so the
            # fleet is squeezed toward it rather than starving its tail.
            plan.rollbacks.append({"job": g.uid, "gpus_needed": need,
                                   "reason": "no_feasible_domain"})
            if g.pending_age < GANG_STARVATION_PLANS:
                unplaceable_pending_gpus += need
            else:
                # starved: HOARD capacity toward the gang — earmark its
                # best candidate domain's free cards (up to the need) so
                # the up-pass stops feeding every small release to
                # incumbent growth and releases ACCUMULATE until the
                # whole gang fits.  (The count packer gets this for free:
                # its down-pass vetoes growth while anything pends.)
                if g.multi_domain():
                    hoard_d: Optional[str] = None
                else:
                    pin = r.jobs_nvlink_domain.get(g.uid)
                    cands = [pin] if pin is not None else domains
                    if not cands:
                        continue  # empty node snapshot: nothing to hoard
                    hoard_d = sorted(
                        cands, key=lambda d: (-free_gpus(d), d))[0]
                reserve_gpus(hoard_d,
                              min(free_gpus(hoard_d), need))
        # "blocked" (feasible, but only same/higher-priority victims
        # hold the capacity) deliberately falls through: phase 2's
        # over-commit drain performs the count-packer's equal-priority
        # admission-by-shrinking, cheapest-marginal victims first

    # -- phase 2: over-commit drain (cheapest marginal first) --------------
    def overcommitted() -> bool:
        return ((r.gpu_limit - unplaceable_pending_gpus) > r.gpu_total
                or r.cpu_request_milli
                > r.cpu_total_milli * max_load_desired)

    while overcommitted():
        victims = [v for v in jobs
                   if v.elastic() and planned(v) > floor_of(v)]
        if not victims:
            break
        victims.sort(key=victim_order)
        v = victims[0]
        before = planned(v)
        if shrink_one_step(v) == 0 and v.cpu_request_milli() == 0:
            break  # pragma: no cover - floor_of already excludes this
        plan.reclaims.append({"victim": v.uid, "from": before,
                              "to": planned(v), "reason": "overcommit"})

    # -- phase 3: marginal up-pass -----------------------------------------
    blocked: set[str] = set()
    rebalanced_for: set[str] = set()
    by_uid = sorted(jobs, key=lambda j: j.uid)
    while True:
        best = None
        best_key = None
        for j in by_uid:
            if j.uid in blocked or not j.elastic() or j.pending > 0:
                # a gang whose pods haven't placed yet does not grow its
                # dial further — its claim is phase 1's business
                continue
            t = up_target(j)
            if t is None:
                continue
            m = step_marginal(j, t)
            key = (j.priority, m, -j.fulfillment())
            if best_key is None or key > best_key:  # first (lowest uid) wins ties
                best, best_key = (j, t, m), key
        if best is None:
            break
        j, t, m = best
        step = t - planned(j)
        if _try_place_step(r, j, step, max_load_desired):
            diff[j.uid] += step
            if math.isfinite(m):
                plan.marginals[j.uid] = m
            continue
        blocked.add(j.uid)
        # capacity-blocked: a measured, dominant step may reclaim from a
        # cheaper victim in its domain (the grant lands next tick, once
        # the victim's pods have vacated real nodes)
        if j.uid in rebalanced_for or not math.isfinite(m):
            continue

        def dominates(v: PlannedJob, m=m, j=j) -> bool:
            if v.priority > j.priority:
                return False
            hm = hold_marginal(v)
            if hm is None or not math.isfinite(hm):
                return False  # unmeasured holdings are never reclaimed
            if v.priority < j.priority:
                return hm < m
            return m > hm * (1.0 + rebalance_headroom) or (hm <= 0 < m)

        rebalanced_for.add(j.uid)
        outcome = reclaim_for(j, step, eligible=dominates,
                              reason="rebalance", reserve_free=False)
        if outcome == "preempted":
            # pair the grant with the reclaim IN THIS PLAN: the grown
            # pods ride the normal pending→place path and land the
            # moment the victims' pods vacate — without this, the freed
            # cards idle a whole planning period before the winner's
            # next step is even considered
            cpu_ok = (r.cpu_total_milli * max_load_desired
                      - r.cpu_request_milli
                      >= j.cpu_request_milli() * step)
            mem_ok = (r.memory_total_mega - r.memory_request_mega
                      > j.mem_request_mega() * step)
            gpu_ok = (r.gpu_total - r.gpu_limit
                      >= j.gpu_limit() * step)
            if cpu_ok and mem_ok and gpu_ok:
                diff[j.uid] += step
                account_totals(j, step)
                if math.isfinite(m):
                    plan.marginals[j.uid] = m

    return plan


def _try_place_step(r: ClusterResource, j: PlannedJob, step: int,
                    max_load_desired: float) -> bool:
    """Admit one whole up-step: the same memory/node/CPU-ceiling/card
    checks as :func:`scale_dry_run`'s up path, with the accounting
    applied on success (and not at all on failure — all-or-nothing)."""
    cpu = j.cpu_request_milli()
    mem = j.mem_request_mega()
    gpus = j.gpu_limit()
    if r.memory_total_mega - r.memory_request_mega <= mem * step:
        return False
    found = search_assignable_nodes(r, j, step)
    if found is None:
        return False
    nodes, domain = found
    cpu_ok = (r.cpu_total_milli * max_load_desired
              - r.cpu_request_milli >= cpu * step)
    gpu_ok = (not gpus) or (r.gpu_total - r.gpu_limit >= gpus * step)
    if not (cpu_ok and gpu_ok):
        return False
    r.gpu_limit += gpus * step
    r.cpu_request_milli += cpu * step
    r.memory_request_mega += mem * step
    for node in nodes:
        r.nodes.nodes_cpu_idle_milli[node] -= cpu
        r.nodes.nodes_memory_free_mega[node] -= mem
        if node in r.nodes.nodes_gpu_free:
            r.nodes.nodes_gpu_free[node] -= gpus
    if domain is not None:
        r.jobs_nvlink_domain.setdefault(j.uid, domain)
    return True


def plan_cluster(
    jobs: Iterable[PlannedJob],
    r: ClusterResource,
    max_load_desired: float = 1.0,
    curves: Optional[Callable[[str], object]] = None,
    objective: str = "goodput",
    **kw,
) -> GoodputPlan:
    """The one planning entry point the autoscaler (and the scheduler
    simulation) calls: ``objective="goodput"`` runs the marginal
    allocator (degrading to count packing when no curve resolves);
    ``objective="count"`` is the reference packer wrapped in the same
    result shape."""
    if objective != "goodput":
        return GoodputPlan(
            diff=scale_all_jobs_dry_run(jobs, r, max_load_desired),
            mode="count")
    return scale_all_jobs_goodput(jobs, r, max_load_desired,
                                  curves=curves, **kw)
