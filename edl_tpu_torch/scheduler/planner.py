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

:func:`plan_cluster` is the one entry point the autoscaler calls.  Its
``objective="count"`` is the reference's count-based packer, wrapped in
the :class:`GoodputPlan` result shape.  The marginal-goodput allocator
(``objective="goodput"``) waits for goodput's ``ScalingCurve`` and
``CurveStore`` and the scheduler simulation (ROADMAP.md, queue 1 item
11); asking for it raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.resource import ClusterResource
from edl_tpu_torch.scheduler.topology import SliceShapePolicy, UNIT_POLICY


@dataclass
class PlannedJob:
    """A job as the planner sees it: config + current parallelism.

    Role of the reference's ``job`` struct (autoscaler.go:34-37), with the
    live batch ``Job``'s Parallelism flattened to an int.  ``config`` is
    any kind speaking the replica-group protocol (group_range /
    group_resources / gpus_per_replica / sched_priority): a
    TrainingJob's trainer group, and a serving fleet once its types are
    ported.
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


def plan_cluster(
    jobs: Iterable[PlannedJob],
    r: ClusterResource,
    max_load_desired: float = 1.0,
    curves: Optional[Callable[[str], object]] = None,
    objective: str = "count",
) -> GoodputPlan:
    """The one planning entry point the autoscaler calls.
    ``objective="count"`` is the reference packer wrapped in the
    :class:`GoodputPlan` result shape; ``"goodput"`` (the marginal
    allocator, which reads ``curves``) is not ported yet and raises."""
    if objective != "count":
        raise NotImplementedError(
            f"objective {objective!r}: the marginal-goodput allocator "
            "(scale_all_jobs_goodput, with goodput's ScalingCurve and "
            "CurveStore and scheduler/sim.py) waits for ROADMAP.md queue 1 "
            "item 11; the port plans with objective='count'")
    return GoodputPlan(
        diff=scale_all_jobs_dry_run(jobs, r, max_load_desired), mode="count")
