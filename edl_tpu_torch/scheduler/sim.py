"""Fleet-scale scheduler simulation — the proof harness for the
marginal-goodput objective; the port's copy of edl_tpu.scheduler.sim.

A discrete-event simulation of a multi-domain GPU fleet under thousands
of synthetic jobs, driven through the REAL planner code
(:func:`edl_tpu_torch.scheduler.planner.plan_cluster` — the same function
the autoscaler ticks), never a reimplementation:

* the sim owns a **kubelet model** (nodes, NVLink domains, all-or-nothing
  gang placement with the single-domain rule — the contract
  cluster/fake.py enforces) and a **workload model** (arrival process,
  per-job scaling curves sampled from recorded template shapes, work
  sizes, serving fleets with demand), and
* every planning decision — grants, priorities, preemption, gang
  rollback — comes from ``plan_cluster`` over a
  :class:`~edl_tpu_torch.cluster.resource.ClusterResource` snapshot built
  the same way ``inquiry_resource`` builds one (pending pods count in the
  request totals; placed pods consume node maps; card pods pin their
  NVLink domain).

Jobs only *measure* their curve at world sizes they have actually run
at (with a small deterministic observation jitter), so the goodput
objective starts from the optimistic prior and learns — the dynamic
where ``ScalingCurve``s accumulate in coordinator KV as jobs run.

:func:`compare_objectives` runs the identical fleet (same seed, same
arrivals, same curves) under the marginal-goodput objective and the
count-based baseline and reports ``sched_goodput_uplift_pct`` (aggregate
goodput, work-units integrated over the horizon),
``sched_admission_p99_s`` (submit → min-gang running, never-admitted jobs
censored at the horizon), ``sched_preemptions``, and the invariants —
``sched_gang_strandings == 0`` (no job ever holds a partial or
domain-split gang) and ``min_violations == 0`` (no planned resize ever
takes a running world below min_instance).  Both packages' simulations
iterate in the same order over the same seeded ``random`` and ``crc32``
jitter, so on equal inputs they return equal dicts.
"""

from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass, field
from typing import Optional

from edl_tpu_torch.api.types import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_GPU,
    ResourceRequirements,
    SchedPriority,
    ServingJob,
    ServingSpec,
    TrainerSpec,
    TrainingJob,
    TrainingJobSpec,
)
from edl_tpu_torch.cluster.resource import ClusterResource, NodeResources
from edl_tpu_torch.observability.goodput import ScalingCurve
from edl_tpu_torch.scheduler.planner import PlannedJob, plan_cluster
from edl_tpu_torch.scheduler.topology import UNIT_POLICY

#: Scaling-curve template shapes (normalized tok/s vs world size),
#: sampled from the classes the bench fleet actually records: the
#: near-linear llama-class walk (goodput leg's measured 2→4 doubling),
#: the sublinear bert-class, and the input-bound resnet-class that
#: saturates early.  A job's true curve is one of these scaled by a
#: per-job base rate with multiplicative jitter.
CURVE_TEMPLATES: dict[str, dict[int, float]] = {
    "linear": {1: 1.0, 2: 1.97, 4: 3.88, 8: 7.5, 16: 14.6},
    "sublinear": {1: 1.0, 2: 1.82, 4: 3.1, 8: 4.7, 16: 6.2},
    "flat": {1: 1.0, 2: 1.55, 4: 2.0, 8: 2.2, 16: 2.3},
}


@dataclass
class SimConfig:
    """Knobs of one simulated fleet.

    The defaults are the reference fleet: 120 jobs on 128 cards across 4
    domains at moderate contention — the regime where elastic headroom
    exists and the two objectives genuinely differ."""

    n_jobs: int = 120
    hosts: int = 16
    chips_per_host: int = 8
    domains: int = 4          # hosts are split evenly across NVLink domains
    seed: int = 17
    horizon_s: float = 900.0
    dt_s: float = 2.0         # accrual/reconcile step
    plan_every_s: float = 10.0
    arrival_spread_s: float = 700.0   # arrivals uniform over [0, spread)
    serve_fraction: float = 0.15      # fraction of jobs that are fleets
    high_fraction: float = 0.10       # P(priority=HIGH)
    low_fraction: float = 0.25       # P(priority=LOW)
    max_load_desired: float = 1.0
    measure_jitter: float = 0.03      # deterministic observation noise


@dataclass
class SimJob:
    name: str
    kind: str                 # "train" | "serve"
    chips: int
    lo: int
    hi: int
    priority: int
    arrival_s: float
    template: str
    base: float               # work-units/s of one instance at size 1
    work: float = 0.0         # train: total work-units to finish
    demand: float = 0.0       # serve: offered load, work-units/s
    duration_s: float = 0.0   # serve: how long the fleet lives
    config: object = None     # the api job object handed to PlannedJob
    # -- runtime state ------------------------------------------------------
    dial: int = 0             # replica-group parallelism (the planner's dial)
    placed: list = field(default_factory=list)   # node name per instance
    admitted_at: Optional[float] = None
    completed_at: Optional[float] = None
    done: float = 0.0
    measured: ScalingCurve = field(default_factory=ScalingCurve)

    @property
    def uid(self) -> str:
        return f"default/{self.name}"

    def true_rate(self, n: int) -> float:
        """Work-units/s the job really produces at n instances —
        piecewise-linear over the template's measured points, last-slope
        extrapolation beyond them, demand-capped for serving."""
        if n <= 0:
            return 0.0
        if self.kind == "serve":
            return min(self.demand, self.base * n)
        tpl = CURVE_TEMPLATES[self.template]
        keys = sorted(tpl)
        if n in tpl:
            return self.base * tpl[n]
        lo_k = max((k for k in keys if k < n), default=keys[0])
        hi_k = min((k for k in keys if k > n), default=None)
        if hi_k is None:  # beyond the template: last measured slope rules
            k1, k2 = keys[-2], keys[-1]
            slope = (tpl[k2] - tpl[k1]) / (k2 - k1)
            return self.base * max(tpl[k2] + slope * (n - k2), 0.0)
        frac = (n - lo_k) / (hi_k - lo_k)
        return self.base * (tpl[lo_k] + frac * (tpl[hi_k] - tpl[lo_k]))


def _mk_jobs(cfg: SimConfig) -> list[SimJob]:
    """The synthetic fleet: seeded, so the goodput and count runs see a
    bit-identical workload."""
    rng = random.Random(cfg.seed)
    jobs: list[SimJob] = []
    for i in range(cfg.n_jobs):
        serve = rng.random() < cfg.serve_fraction
        u = rng.random()
        if u < cfg.high_fraction:
            pri = int(SchedPriority.HIGH)
        elif u < cfg.high_fraction + cfg.low_fraction:
            pri = int(SchedPriority.LOW)
        else:
            pri = int(SchedPriority.NORMAL)
        arrival = rng.uniform(0.0, cfg.arrival_spread_s)
        base = rng.uniform(50.0, 150.0)
        if serve:
            # serving fleets defend user traffic: biased HIGH, and their
            # capacity curve is linear-per-replica up to the demand
            pri = max(pri, int(SchedPriority.HIGH)
                      if rng.random() < 0.5 else pri)
            chips = rng.choice((1, 2))
            lo = 1
            hi = rng.choice((4, 6, 8))
            j = SimJob(
                name=f"serve-{i}", kind="serve", chips=chips, lo=lo,
                hi=hi, priority=pri, arrival_s=arrival, template="linear",
                base=base,
                demand=base * rng.uniform(1.5, hi * 0.9),
                duration_s=rng.uniform(120.0, 420.0))
        else:
            template = rng.choices(("linear", "sublinear", "flat"),
                                   weights=(0.4, 0.3, 0.3))[0]
            chips = rng.choice((1, 1, 2, 4))
            # min gangs stay small (the fleet norm: a job can START tiny
            # and earn growth); the elastic headroom above min is the
            # capacity the two objectives allocate differently
            lo = rng.choice((1, 1, 1, 2))
            hi = lo + rng.choice((3, 5, 7))
            j = SimJob(
                name=f"train-{i}", kind="train", chips=chips, lo=lo,
                hi=hi, priority=pri, arrival_s=arrival, template=template,
                base=base)
            # sized so a mid-allocation run finishes in 1-5 minutes
            j.work = j.true_rate((lo + hi) // 2) * rng.uniform(60.0, 300.0)
        j.measured = ScalingCurve(job=j.uid)
        j.config = _mk_config(j)
        jobs.append(j)
    jobs.sort(key=lambda j: (j.arrival_s, j.name))
    return jobs


def _mk_config(j: SimJob):
    """The api-layer job object the planner prices (the sim feeds the
    REAL PlannedJob protocol, not a stand-in)."""
    res = ResourceRequirements(
        requests={RESOURCE_CPU: "1", RESOURCE_MEMORY: "1000M"},
        limits={RESOURCE_CPU: "1", RESOURCE_MEMORY: "1000M",
                RESOURCE_GPU: str(j.chips)},
    )
    if j.kind == "serve":
        return ServingJob(
            name=j.name,
            spec=ServingSpec(min_replicas=j.lo, max_replicas=j.hi,
                             resources=res, priority=j.priority))
    return TrainingJob(
        name=j.name,
        spec=TrainingJobSpec(
            fault_tolerant=True,
            trainer=TrainerSpec(min_instance=j.lo, max_instance=j.hi,
                                resources=res, priority=j.priority)))


def _jitter(name: str, n: int, amplitude: float) -> float:
    """Deterministic observation noise in [-amplitude, +amplitude] —
    a pure function of (job, size) so repeated runs and both objectives
    measure identically."""
    h = zlib.crc32(f"{name}:{n}".encode()) / 0xFFFFFFFF
    return (2.0 * h - 1.0) * amplitude


class FleetSim:
    """One simulated fleet run under one objective."""

    CPU_PER_HOST = 64_000     # milli — deliberately non-binding
    MEM_PER_HOST = 512_000    # mega — deliberately non-binding
    CPU_PER_INSTANCE = 1_000
    MEM_PER_INSTANCE = 1_000

    def __init__(self, cfg: SimConfig) -> None:
        self.cfg = cfg
        self.jobs = _mk_jobs(cfg)
        self.by_uid = {j.uid: j for j in self.jobs}
        self.node_domain: dict[str, str] = {}
        self.node_free: dict[str, int] = {}
        per_domain = max(cfg.hosts // cfg.domains, 1)
        for h in range(cfg.hosts):
            name = f"host{h}"
            self.node_domain[name] = f"pod{min(h // per_domain, cfg.domains - 1)}"
            self.node_free[name] = cfg.chips_per_host
        self.total_chips = cfg.hosts * cfg.chips_per_host
        # evidence counters
        self._pending_age: dict[str, int] = {}
        self.preemptions = 0
        self.rollbacks = 0
        self.strandings = 0
        self.min_violations = 0
        self.resizes = 0
        self.goodput = 0.0
        self.util_integral = 0.0

    # -- snapshot: what inquiry_resource would report ----------------------

    def _snapshot(self, active: list[SimJob]) -> ClusterResource:
        cfg = self.cfg
        r = ClusterResource(node_count=cfg.hosts)
        nodes = NodeResources()
        for name in self.node_domain:
            nodes.nodes_cpu_idle_milli[name] = self.CPU_PER_HOST
            nodes.nodes_memory_free_mega[name] = self.MEM_PER_HOST
            nodes.nodes_gpu_free[name] = cfg.chips_per_host
            nodes.nodes_nvlink_domain[name] = self.node_domain[name]
            r.cpu_total_milli += self.CPU_PER_HOST
            r.memory_total_mega += self.MEM_PER_HOST
            r.gpu_total += cfg.chips_per_host
        for j in active:
            # every live pod (placed or pending) counts in the request
            # totals; placed pods additionally consume their node
            r.cpu_request_milli += self.CPU_PER_INSTANCE * j.dial
            r.memory_request_mega += self.MEM_PER_INSTANCE * j.dial
            r.gpu_limit += j.chips * j.dial
            r.gpu_request += j.chips * j.dial
            for node in j.placed:
                nodes.nodes_cpu_idle_milli[node] -= self.CPU_PER_INSTANCE
                nodes.nodes_memory_free_mega[node] -= self.MEM_PER_INSTANCE
                nodes.nodes_gpu_free[node] -= j.chips
            if (j.chips and j.placed and j.kind == "train"):
                r.jobs_nvlink_domain.setdefault(
                    j.uid, self.node_domain[j.placed[0]])
        r.nodes = nodes
        return r

    # -- the kubelet model -------------------------------------------------

    def _find_gang(self, j: SimJob, count: int) -> Optional[list[str]]:
        """All-or-nothing placement of ``count`` more instances.  A
        card-training job's mesh stays in ONE NVLink domain (pinned by its
        existing pods); serving replicas are independent meshes and may
        spread.  Returns the chosen node list or None."""
        free = dict(self.node_free)

        def try_domain(names: list[str]) -> Optional[list[str]]:
            chosen = []
            for _ in range(count):
                ok = None
                for n in names:
                    if free[n] >= j.chips:
                        ok = n
                        break
                if ok is None:
                    return None
                free[ok] -= j.chips
                chosen.append(ok)
            return chosen

        domains = sorted({d for d in self.node_domain.values()})
        dom_nodes = {d: sorted(n for n, dd in self.node_domain.items()
                               if dd == d) for d in domains}
        if j.kind == "train" and j.chips:
            if j.placed:
                cand = [self.node_domain[j.placed[0]]]
            else:
                cand = sorted(
                    domains,
                    key=lambda d: (-sum(free[n] for n in dom_nodes[d]), d))
            for d in cand:
                got = try_domain(dom_nodes[d])
                if got is not None:
                    return got
            return None
        # serving (or cardless): consolidating spread, most-free first
        order = sorted(
            domains, key=lambda d: (-sum(free[n] for n in dom_nodes[d]), d))
        return try_domain([n for d in order for n in dom_nodes[d]])

    def _reconcile(self, t: float, active: list[SimJob]) -> None:
        """Place pending pods, all-or-nothing per job, arrival order."""
        for j in active:
            pend = j.dial - len(j.placed)
            if pend <= 0:
                continue
            got = self._find_gang(j, pend)
            if got is None:
                continue
            for n in got:
                self.node_free[n] -= j.chips
                j.placed.append(n)
            if j.admitted_at is None and len(j.placed) >= j.lo:
                j.admitted_at = t

    def _release(self, j: SimJob, n_instances: int) -> None:
        for _ in range(n_instances):
            if not j.placed:
                break
            node = j.placed.pop()  # newest-first, like the fake kubelet
            self.node_free[node] += j.chips

    # -- plan application --------------------------------------------------

    def _apply_plan(self, plan, active: list[SimJob]) -> None:
        self.preemptions += len(plan.preemptions)
        self.rollbacks += len(plan.rollbacks)
        for uid, delta in plan.diff.items():
            if delta == 0:
                continue
            j = self.by_uid[uid]
            target = j.dial + delta
            if j.admitted_at is not None and target < j.lo:
                # the acceptance invariant: a planned resize must never
                # take a running world below its min
                self.min_violations += 1
                target = j.lo
            if target == j.dial:
                continue
            if target < j.dial:
                drop = j.dial - target
                pend = j.dial - len(j.placed)
                from_pending = min(pend, drop)
                self._release(j, drop - from_pending)
            j.dial = target
            if j.admitted_at is not None:
                self.resizes += 1

    # -- one full run ------------------------------------------------------

    def run(self, objective: str) -> dict:
        cfg = self.cfg
        t = 0.0
        next_plan = 0.0
        arrivals = list(self.jobs)  # sorted by arrival
        active: list[SimJob] = []

        def curve_for(uid: str):
            j = self.by_uid.get(uid)
            if j is None or not j.measured.world_sizes():
                return None
            return j.measured

        while t < cfg.horizon_s and (arrivals or active):
            while arrivals and arrivals[0].arrival_s <= t:
                j = arrivals.pop(0)
                j.dial = j.lo  # the min gang is requested at submit
                active.append(j)

            if t >= next_plan and active:
                snap = self._snapshot(active)
                pjobs = []
                for j in active:
                    pend = j.dial - len(j.placed)
                    age = self._pending_age.get(j.uid, 0) if pend else 0
                    self._pending_age[j.uid] = age + 1 if pend else 0
                    pjobs.append(PlannedJob(
                        config=j.config, parallelism=j.dial,
                        shape_policy=UNIT_POLICY, pending=pend,
                        pending_age=age))
                plan = plan_cluster(pjobs, snap, cfg.max_load_desired,
                                    curves=curve_for, objective=objective)
                self._apply_plan(plan, active)
                next_plan = t + cfg.plan_every_s

            self._reconcile(t, active)

            # accrue goodput + measurements on what actually runs
            used_chips = 0
            for j in active:
                n = len(j.placed)
                used_chips += n * j.chips
                if n < j.lo:
                    continue
                rate = j.true_rate(n)
                self.goodput += rate * cfg.dt_s
                if j.kind == "train":
                    j.done += rate * cfg.dt_s
                j.measured.observe(
                    n, rate * (1.0 + _jitter(j.name, n, cfg.measure_jitter)))
            self.util_integral += used_chips * cfg.dt_s

            # gang invariants, checked every step: never a partial gang,
            # never a domain-split training mesh
            for j in active:
                n = len(j.placed)
                if 0 < n < j.lo:
                    self.strandings += 1
                if j.kind == "train" and j.chips and n > 1:
                    doms = {self.node_domain[x] for x in j.placed}
                    if len(doms) > 1:
                        self.strandings += 1

            # completions
            still = []
            for j in active:
                done = (j.done >= j.work if j.kind == "train"
                        else (j.admitted_at is not None
                              and t - j.admitted_at >= j.duration_s))
                if done:
                    j.completed_at = t
                    self._release(j, len(j.placed))
                    j.dial = 0
                else:
                    still.append(j)
            active = still
            t += cfg.dt_s

        arrived = [j for j in self.jobs if j.arrival_s < cfg.horizon_s]
        admissions = [
            (j.admitted_at - j.arrival_s) if j.admitted_at is not None
            else (cfg.horizon_s - j.arrival_s)  # censored at the horizon
            for j in arrived
        ]
        admissions.sort()

        def pct(p: float) -> float:
            if not admissions:
                return 0.0
            k = min(int(math.ceil(p * len(admissions))) - 1,
                    len(admissions) - 1)
            return admissions[max(k, 0)]

        return {
            "objective": objective,
            "jobs": len(arrived),
            "jobs_admitted": sum(1 for j in arrived
                                 if j.admitted_at is not None),
            "jobs_completed": sum(1 for j in arrived
                                  if j.completed_at is not None),
            "aggregate_goodput": round(self.goodput, 1),
            "admission_p50_s": round(pct(0.50), 2),
            "admission_p99_s": round(pct(0.99), 2),
            "preemptions": self.preemptions,
            "gang_rollbacks": self.rollbacks,
            "gang_strandings": self.strandings,
            "min_violations": self.min_violations,
            "resizes": self.resizes,
            "chip_util_mean_pct": round(
                100.0 * self.util_integral
                / (self.total_chips * max(t, cfg.dt_s)), 2),
        }


def compare_objectives(cfg: SimConfig, register: bool = True) -> dict:
    """Run the identical fleet under both objectives and report the
    headline comparison; optionally export the ``edl_sched_*`` series
    on the shared registry (strict-parser clean, as every scrape is)."""
    good = FleetSim(cfg).run("goodput")
    count = FleetSim(cfg).run("count")
    base = max(count["aggregate_goodput"], 1e-9)
    uplift = 100.0 * (good["aggregate_goodput"]
                      - count["aggregate_goodput"]) / base
    out = {
        "sim_jobs": good["jobs"],
        "sched_goodput_uplift_pct": round(uplift, 2),
        "sched_admission_p99_s": good["admission_p99_s"],
        "sched_admission_p99_s_count": count["admission_p99_s"],
        "sched_preemptions": good["preemptions"],
        "sched_gang_strandings": (good["gang_strandings"]
                                  + count["gang_strandings"]),
        "sched_min_violations": (good["min_violations"]
                                 + count["min_violations"]),
        "goodput": good,
        "count": count,
    }
    if register:
        from edl_tpu_torch.observability.collector import get_counters
        from edl_tpu_torch.observability.metrics import get_registry

        reg = get_registry()
        reg.gauge("sched_goodput_uplift_pct",
                  help="simulated aggregate-goodput uplift of the "
                       "marginal objective vs count-based packing"
                  ).set(out["sched_goodput_uplift_pct"])
        reg.gauge("sched_admission_p99_s",
                  help="simulated admission p99 (submit → min gang "
                       "running), censored at the horizon"
                  ).set(good["admission_p99_s"], objective="goodput")
        reg.gauge("sched_admission_p99_s").set(count["admission_p99_s"],
                                               objective="count")
        reg.gauge("sched_gang_strandings",
                  help="simulated partial/domain-split gangs observed "
                       "(must be 0)").set(out["sched_gang_strandings"])
        if good["preemptions"]:
            get_counters().inc("sched_preemptions",
                               n=good["preemptions"])
    return out
