"""The port's marginal-goodput objective (edl_tpu_torch.scheduler.planner's
allocator, the Autoscaler's goodput half, the ServingScaler's arbitration
and the Controller's) against the JAX package's: every scenario of
tests/test_sched_goodput.py built on both packages from one description —
TPU chips mapped onto GPU cards, ICI domains onto NVLink domains — run
with the reference's assertions on each, and the two packages' results
(each ``GoodputPlan``'s diff, mode, preemptions, reclaims, rollbacks and
marginals, or the loop's outcome) required equal; then 50 seeded random
clusters through both packages' ``plan_cluster(objective="goodput")``.

``test_priority_threads_api_serde_crd``, which round-trips the priority
through ``api/serde.py`` and the CRD schemas, is in
tests/test_torch_serde_cli.py with the port's serde.
"""

import math
import types
from collections import deque

import numpy as np
import pytest

import edl_tpu.scheduler.autoscaler as jauto
import edl_tpu_torch.scheduler.autoscaler as tauto
from edl_tpu.api import types as jtypes
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.cluster.resource import (ClusterResource as JaxResource,
                                      NodeResources as JaxNodes)
from edl_tpu.controller.controller import Controller as JaxController
from edl_tpu.observability import goodput as jgoodput
from edl_tpu.observability import metrics as jmetrics
from edl_tpu.scheduler import planner as jplanner
from edl_tpu.scheduler import topology as jtopology
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.cluster.resource import ClusterResource, NodeResources
from edl_tpu_torch.controller import Controller as TorchController
from edl_tpu_torch.observability import goodput as tgoodput
from edl_tpu_torch.observability import metrics as tmetrics
from edl_tpu_torch.scheduler import planner as tplanner
from edl_tpu_torch.scheduler import topology as ttopology


class Pkg:
    """One package's scheduler, built from a package-neutral description:
    ``acc`` totals, limits and per-node free counts are TPU chips on the
    JAX side and GPU cards on the port's."""

    def __init__(self, jax: bool) -> None:
        self.jax = jax
        self.t = jtypes if jax else ttypes
        self.planner = jplanner if jax else tplanner
        self.topology = jtopology if jax else ttopology
        self.goodput = jgoodput if jax else tgoodput
        self.metrics = jmetrics if jax else tmetrics
        self.auto = jauto if jax else tauto
        self.Controller = JaxController if jax else TorchController
        self.res_key = jtypes.RESOURCE_TPU if jax else ttypes.RESOURCE_GPU

    # -- cluster snapshots -------------------------------------------------

    def cr(self, nodes=None, acc_total=0, acc_limit=0, pins=None, **kw):
        """``nodes``: name → (cpu idle, mem free[, acc free[, domain]])."""
        acc = "tpu" if self.jax else "gpu"
        kw.update({f"{acc}_total": acc_total, f"{acc}_limit": acc_limit})
        node_kw = dict(nodes_cpu_idle_milli={}, nodes_memory_free_mega={})
        free, doms = {}, {}
        for name, spec in (nodes or {}).items():
            node_kw["nodes_cpu_idle_milli"][name] = spec[0]
            node_kw["nodes_memory_free_mega"][name] = spec[1]
            if len(spec) > 2 and spec[2] is not None:
                free[name] = spec[2]
            if len(spec) > 3:
                doms[name] = spec[3]
        if self.jax:
            r = JaxResource(nodes=JaxNodes(nodes_tpu_free=free,
                                           nodes_ici_domain=doms, **node_kw),
                            **kw)
            r.jobs_ici_domain.update(pins or {})
        else:
            r = ClusterResource(nodes=NodeResources(
                nodes_gpu_free=free, nodes_nvlink_domain=doms, **node_kw),
                **kw)
            r.jobs_nvlink_domain.update(pins or {})
        return r

    def free(self, r) -> dict:
        return r.nodes.nodes_tpu_free if self.jax else r.nodes.nodes_gpu_free

    def set_limit(self, r, n: int) -> None:
        if self.jax:
            r.tpu_limit = n
        else:
            r.gpu_limit = n

    def pins(self, r) -> dict:
        return r.jobs_ici_domain if self.jax else r.jobs_nvlink_domain

    def big(self, cpu=64_000, mem=64_000):
        return self.cr({"node0": (cpu, mem)}, cpu_total_milli=cpu,
                       memory_total_mega=mem)

    def one_domain(self, nodes=2, per_node=4):
        return self.cr({f"n{i}": (8000, 16000, per_node, "D")
                        for i in range(nodes)},
                       acc_total=per_node * nodes,
                       cpu_total_milli=8000 * nodes,
                       memory_total_mega=16000 * nodes)

    def two_domain(self):
        return self.cr({n: (8000, 16000, 2, n[0].upper())
                        for n in ("a0", "a1", "b0", "b1")},
                       acc_total=8, cpu_total_milli=32_000,
                       memory_total_mega=64_000)

    def fake(self, nodes):
        """A fake cluster of ``(name, cpu, mem, acc, domain)`` nodes."""
        c = JaxCluster() if self.jax else TorchCluster()
        for name, cpu, mem, acc, dom in nodes:
            if self.jax:
                c.add_node(name, cpu_milli=cpu, memory_mega=mem,
                           tpu_chips=acc, ici_domain=dom)
            else:
                c.add_node(name, cpu_milli=cpu, memory_mega=mem, gpus=acc,
                           nvlink_domain=dom)
        return c

    # -- jobs and curves ---------------------------------------------------

    def make_job(self, name, cpu_req, cpu_lim, mem_req, mem_lim, acc, lo, hi,
                 p, policy=None, multi=False):
        t = self.t
        job = t.TrainingJob(name=name, spec=t.TrainingJobSpec(
            trainer=t.TrainerSpec(
                min_instance=lo, max_instance=hi, allow_multi_domain=multi,
                resources=t.ResourceRequirements(
                    requests={"cpu": cpu_req, "memory": mem_req},
                    limits={"cpu": cpu_lim, "memory": mem_lim,
                            self.res_key: acc}))))
        return self.planner.PlannedJob(
            config=job, parallelism=p,
            shape_policy=policy or self.topology.UNIT_POLICY)

    def priced(self, name, acc, lo, hi, p, priority="NORMAL", policy=None):
        j = self.make_job(name, "1", "1", "1Mi", "1Mi", str(acc), lo, hi, p,
                          policy=policy)
        j.config.spec.trainer.priority = int(self.t.SchedPriority[priority])
        return j

    def mk_job(self, name, lo, hi, cpu="1", mem="100M"):
        """tests/test_autoscaler.py's ``mk_job``: a CPU-only job."""
        t = self.t
        return t.TrainingJob(name=name, spec=t.TrainingJobSpec(
            fault_tolerant=True, trainer=t.TrainerSpec(
                min_instance=lo, max_instance=hi,
                resources=t.ResourceRequirements(
                    requests={"cpu": cpu, "memory": mem},
                    limits={"cpu": cpu, "memory": mem}))))

    def cluster_with(self, cpu_milli=10_000, mem=100_000):
        c = JaxCluster() if self.jax else TorchCluster()
        c.add_node("n0", cpu_milli=cpu_milli, memory_mega=mem)
        return c

    def serving(self, name="fleet", lo=1, hi=4, acc="1", **spec):
        t = self.t
        res = t.ResourceRequirements(requests={"cpu": "1", "memory": "1Mi"},
                                     limits={self.res_key: acc})
        return t.ServingJob(name=name, spec=t.ServingSpec(
            min_replicas=lo, max_replicas=hi, resources=res, **spec))

    def curve(self, points, job=""):
        c = self.goodput.ScalingCurve(job=job)
        for ws, tok in sorted(points.items()):
            c.observe(ws, tok)
        return c

    def curves_for(self, mapping):
        built = {uid: (self.curve(v) if isinstance(v, dict) else v)
                 for uid, v in mapping.items()}
        return lambda uid: built.get(uid)

    def plan(self, jobs, r, curves=None, objective="goodput"):
        return self.planner.plan_cluster(jobs, r, 1.0, curves=curves,
                                         objective=objective)


JAX, TORCH = Pkg(True), Pkg(False)


def view(plan) -> dict:
    """A plan in package-neutral form (the rollback record's chip count
    under one key)."""
    rollbacks = [{("needed" if k in ("chips_needed", "gpus_needed") else k): v
                  for k, v in rb.items()} for rb in plan.rollbacks]
    return dict(diff=plan.diff, mode=plan.mode, preemptions=plan.preemptions,
                reclaims=plan.reclaims, rollbacks=rollbacks,
                marginals=plan.marginals)


def both(fn):
    """``fn(pkg)`` on the JAX package and on the port; asserts the two
    equal and returns the port's."""
    want, got = fn(JAX), fn(TORCH)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# degraded mode: bit-for-bit count-packing parity
# ---------------------------------------------------------------------------


def test_degraded_mode_matches_count_packing_bit_for_bit():
    def run(p):
        fixtures = [
            ([p.make_job("j", "1", "1", "1Mi", "1Mi", "0", 1, 8, 1,
                         policy=p.topology.POW2_POLICY)], p.big()),
            ([p.make_job("a", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0),
              p.make_job("b", "1", "1", "1Mi", "1Mi", "2", 0, 2, 0)],
             p.two_domain()),
        ]
        out = []
        for cv in (None, lambda uid: None, p.curves_for({})):
            for jobs, r in fixtures:
                expect = p.planner.scale_all_jobs_dry_run(jobs, r.copy(), 1.0)
                plan = p.plan(jobs, r.copy(), cv)
                assert plan.mode == "degraded"
                assert plan.diff == expect
                assert not plan.preemptions and not plan.rollbacks
                out.append(view(plan))
        return out
    both(run)


def test_raising_curve_source_degrades_not_raises():
    def run(p):
        def broken(uid):
            raise RuntimeError("curve store unreachable")

        j = p.make_job("j", "1", "1", "1Mi", "1Mi", "0", 1, 4, 1)
        r = p.big()
        plan = p.plan([j], r, broken)
        assert plan.mode == "degraded"
        assert plan.diff == p.planner.scale_all_jobs_dry_run([j], r, 1.0)
        return view(plan)
    both(run)


def test_count_objective_is_the_reference_packer_wrapped():
    def run(p):
        j = p.make_job("j", "1", "1", "1Mi", "1Mi", "0", 1, 4, 1)
        r = p.big()
        plan = p.plan([j], r, p.curves_for({"default/j": {1: 100.0}}),
                      objective="count")
        assert plan.mode == "count"
        assert plan.diff == p.planner.scale_all_jobs_dry_run([j], r, 1.0)
        return view(plan)
    both(run)


# ---------------------------------------------------------------------------
# the marginal objective
# ---------------------------------------------------------------------------


def test_marginal_packing_prefers_steep_curve():
    def run(p):
        r = p.one_domain(nodes=1, per_node=4)
        steep = p.priced("steep", 1, 0, 4, 0)
        flat = p.priced("flat", 1, 0, 4, 0)
        cv = p.curves_for({
            "default/steep": {1: 100.0, 2: 200.0, 4: 400.0},
            "default/flat": {1: 50.0, 2: 52.0, 4: 53.0}})
        plan = p.plan([steep, flat], r, cv)
        assert plan.mode == "goodput"
        assert plan.diff["default/steep"] == 4
        assert plan.diff["default/flat"] == 0
        assert plan.marginals["default/steep"] == pytest.approx(100.0)
        leveled = p.planner.scale_all_jobs_dry_run([steep, flat], r, 1.0)
        assert leveled["default/steep"] == leveled["default/flat"] == 2
        return view(plan), leveled
    both(run)


def test_optimistic_prior_explores_unmeasured_jobs():
    def run(p):
        r = p.one_domain(nodes=1, per_node=4)
        measured = p.priced("measured", 1, 0, 4, 0)
        fresh = p.priced("fresh", 1, 0, 4, 0)
        cv = p.curves_for({"default/measured": {1: 100.0, 2: 190.0}})
        plan = p.plan([measured, fresh], r, cv)
        assert plan.diff["default/fresh"] == 4
        assert plan.diff["default/measured"] == 0
        return view(plan)
    both(run)


def test_zero_marginal_jobs_still_pack_leftover_capacity():
    def run(p):
        r = p.one_domain(nodes=2, per_node=4)
        steep = p.priced("steep", 1, 0, 4, 0)
        flat = p.priced("flat", 1, 0, 4, 0)
        cv = p.curves_for({
            "default/steep": {1: 100.0, 2: 200.0},
            "default/flat": {1: 100.0, 2: 100.0, 4: 100.0}})
        plan = p.plan([steep, flat], r, cv)
        assert plan.diff["default/steep"] == 4
        assert plan.diff["default/flat"] == 4
        return view(plan)
    both(run)


def test_fresh_pending_gang_does_not_preempt_yet():
    def run(p):
        r = p.one_domain(nodes=2, per_node=4)
        victim = p.priced("victim", 2, 1, 3, 2)
        p.free(r)["n0"] = 0
        p.free(r)["n1"] = 2
        p.set_limit(r, 4 + 4)
        p.pins(r)["default/victim"] = "D"
        gang = p.priced("gang", 2, 2, 2, 2, priority="HIGH")
        gang.pending = 2
        cv = p.curves_for({"default/victim": {1: 100.0, 2: 101.0}})
        plan = p.plan([victim, gang], r, cv)
        assert not plan.preemptions
        assert plan.diff["default/victim"] == 0
        return view(plan)
    both(run)


def test_pending_high_gang_preempts_cheapest_victim_to_min():
    def run(p):
        r = p.one_domain(nodes=2, per_node=4)
        v_flat = p.priced("vflat", 2, 1, 3, 2)
        v_steep = p.priced("vsteep", 2, 1, 2, 1)
        p.free(r)["n0"] = 0
        p.free(r)["n1"] = 2
        p.set_limit(r, 6 + 4)
        r.cpu_request_milli = 3 * 1_000_000 + 2 * 1_000_000
        p.pins(r).update({"default/vflat": "D", "default/vsteep": "D"})
        gang = p.priced("gang", 2, 2, 2, 2, priority="HIGH")
        gang.pending = 2
        gang.pending_age = 1
        cv = p.curves_for({"default/vflat": {1: 100.0, 2: 101.0},
                           "default/vsteep": {1: 400.0}})
        plan = p.plan([v_flat, v_steep, gang], r, cv)
        assert plan.mode == "goodput"
        assert plan.preemptions, "no preemption planned"
        assert {x["victim"] for x in plan.preemptions} == {"default/vflat"}
        assert plan.diff["default/vflat"] == -1
        assert plan.diff["default/vsteep"] == 0
        assert v_flat.parallelism + plan.diff["default/vflat"] >= 1
        assert not plan.rollbacks
        return view(plan)
    both(run)


def test_gang_rolled_back_whole_when_no_domain_feasible():
    def run(p):
        r = p.two_domain()
        va = p.priced("va", 2, 1, 1, 1, priority="LOW")
        vb = p.priced("vb", 2, 1, 1, 1, priority="LOW")
        p.free(r)["a0"] = 0
        p.free(r)["b0"] = 0
        p.set_limit(r, 4 + 6)
        p.pins(r).update({"default/va": "A", "default/vb": "B"})
        gang = p.priced("gang", 2, 3, 3, 3, priority="HIGH")
        gang.pending = 3
        gang.pending_age = 1
        cv = p.curves_for({"default/va": {1: 100.0}})
        plan = p.plan([va, vb, gang], r, cv)
        assert plan.rollbacks and plan.rollbacks[0]["job"] == "default/gang"
        assert not plan.preemptions
        assert all(d >= 0 for d in plan.diff.values()), plan.diff
        return view(plan)
    both(run)


def test_equal_priority_pending_rides_overcommit_drain():
    def run(p):
        r = p.one_domain(nodes=2, per_node=4)
        v_flat = p.priced("vflat", 2, 1, 3, 2)
        v_steep = p.priced("vsteep", 2, 1, 2, 2)
        p.free(r)["n0"] = 0
        p.free(r)["n1"] = 0
        p.set_limit(r, 8 + 2)
        p.pins(r).update({"default/vflat": "D", "default/vsteep": "D"})
        gang = p.priced("gang", 2, 1, 1, 1)
        gang.pending = 1
        cv = p.curves_for({"default/vflat": {1: 100.0, 2: 102.0},
                           "default/vsteep": {1: 100.0, 2: 300.0}})
        plan = p.plan([v_flat, v_steep, gang], r, cv)
        assert not plan.preemptions
        assert any(rec["reason"] == "overcommit" for rec in plan.reclaims)
        assert plan.diff["default/vflat"] == -1
        assert plan.diff["default/vsteep"] == 0
        return view(plan)
    both(run)


def test_rebalance_saturated_serving_outbids_flat_trainer():
    def run(p):
        r = p.one_domain(nodes=1, per_node=4)
        fleet = p.serving(priority=int(p.t.SchedPriority.NORMAL))
        serving = p.planner.PlannedJob(config=fleet, parallelism=1)
        trainer = p.priced("batch", 1, 1, 4, 3)
        p.free(r)["n0"] = 0
        p.set_limit(r, 4)
        p.pins(r)["default/batch"] = "D"
        cv = p.curves_for({"default/fleet": {1: 500.0, 2: 1000.0},
                           "default/batch": {1: 100.0, 3: 110.0}})
        plan = p.plan([serving, trainer], r, cv)
        assert plan.diff["default/batch"] == -1
        assert plan.diff["default/fleet"] == 1
        assert any(rec["reason"] == "rebalance"
                   and rec["victim"] == "default/batch"
                   for rec in plan.reclaims)
        return view(plan)
    both(run)


def test_unmeasured_holdings_are_never_reclaimed():
    def run(p):
        r = p.one_domain(nodes=1, per_node=4)
        grower = p.priced("grower", 1, 1, 4, 1)
        fresh = p.priced("fresh", 1, 1, 4, 3)
        p.free(r)["n0"] = 0
        p.set_limit(r, 4)
        p.pins(r).update({"default/grower": "D", "default/fresh": "D"})
        cv = p.curves_for({"default/grower": {1: 500.0, 2: 1000.0}})
        plan = p.plan([grower, fresh], r, cv)
        assert plan.diff["default/fresh"] == 0
        assert not plan.reclaims and not plan.preemptions
        return view(plan)
    both(run)


def test_priority_tiers_rule_before_marginals():
    def run(p):
        r = p.one_domain(nodes=1, per_node=2)
        high_flat = p.priced("hflat", 1, 0, 2, 0, priority="HIGH")
        norm_steep = p.priced("nsteep", 1, 0, 2, 0)
        cv = p.curves_for({"default/hflat": {1: 10.0, 2: 11.0},
                           "default/nsteep": {1: 100.0, 2: 200.0}})
        plan = p.plan([high_flat, norm_steep], r, cv)
        assert plan.diff["default/hflat"] == 2
        assert plan.diff["default/nsteep"] == 0
        return view(plan)
    both(run)


# ---------------------------------------------------------------------------
# multi-domain contention under the new objective
# ---------------------------------------------------------------------------


def test_spanning_and_pinned_contention_under_goodput_objective():
    def run(p):
        r = p.cr({"a0": (8000, 16000, 0, "A"), "a1": (8000, 16000, 2, "A"),
                  "b0": (8000, 16000, 0, "B"), "b1": (8000, 16000, 2, "B")},
                 acc_total=8, acc_limit=4, cpu_total_milli=32_000,
                 memory_total_mega=64_000, pins={"default/p": "A"})
        pinned = p.make_job("p", "1", "1", "1Mi", "1Mi", "2", 1, 2, 1)
        spanning = p.make_job("s", "1", "1", "1Mi", "1Mi", "2", 1, 3, 1,
                              multi=True)
        cv = p.curves_for({"default/p": {1: 100.0, 2: 220.0},
                           "default/s": {1: 100.0, 2: 190.0}})
        plan = p.plan([pinned, spanning], r.copy(), cv)
        assert plan.mode == "goodput"
        assert pinned.parallelism + plan.diff["default/p"] == 2
        assert spanning.parallelism + plan.diff["default/s"] == 2
        count = p.planner.scale_all_jobs_dry_run([pinned, spanning],
                                                 r.copy(), 1.0)
        assert plan.diff == count
        return view(plan)
    both(run)


def test_unequal_domains_spanning_world_under_goodput_objective():
    def run(p):
        cluster = p.fake([("a0", 8000, 16000, 2, "A"),
                          ("a1", 8000, 16000, 1, "A"),
                          ("b0", 8000, 16000, 1, "B")])
        j = p.make_job("j", "1", "1", "1Mi", "1Mi", "1", 1, 4, 1,
                       multi=True)
        cluster.create_resources(j.config)
        cluster.reconcile()
        r = cluster.inquiry_resource()
        j.parallelism = cluster.get_trainer_parallelism(j.config)
        plan = p.plan([j], r, p.curves_for({"default/j": {1: 100.0,
                                                          2: 198.0}}))
        target = j.parallelism + plan.diff["default/j"]
        assert target == 4
        cluster.update_trainer_parallelism(j.config, target)
        cluster.reconcile()
        counts = cluster.job_pods(j.config)
        assert counts.pending == 0 and counts.running == 4
        return view(plan), (counts.pending, counts.running)
    both(run)


# ---------------------------------------------------------------------------
# ScalingCurve pricing edge cases (the allocator leans on these)
# ---------------------------------------------------------------------------


def test_empty_curve_prices_at_prior():
    def run(p):
        c = p.goodput.ScalingCurve()
        prior = p.planner.OPTIMISTIC_PRIOR
        assert c.world_sizes() == []
        assert c.tokens_per_second(4) is None
        assert c.nearest_world_size(4) is None
        assert c.marginal_tokens_per_second_per_chip(4) is None
        assert p.planner._step_marginal(c, 4, 1, prior) == prior
        assert p.planner._step_marginal(None, 4, 1, 123.0) == 123.0
        return prior
    assert both(run) == math.inf


def test_single_measured_size_marginal_is_average_per_chip():
    def run(p):
        c = p.curve({4: 400.0})
        sm = p.planner._step_marginal
        assert c.marginal_tokens_per_second_per_chip(4) == pytest.approx(100.0)
        assert sm(c, 8, 1, 0.0) == pytest.approx(100.0)
        assert sm(c, 2, 1, 0.0) == pytest.approx(100.0)
        assert sm(c, 8, 4, 0.0) == pytest.approx(25.0)
        return [sm(c, 8, 1, 0.0), sm(c, 2, 1, 0.0), sm(c, 8, 4, 0.0)]
    both(run)


def test_queries_beyond_measured_range_use_the_curve_edge():
    def run(p):
        c = p.curve({2: 100.0, 4: 180.0})
        sm = p.planner._step_marginal
        assert c.nearest_world_size(100) == 4
        assert sm(c, 100, 1, 0.0) == pytest.approx(40.0)
        assert c.nearest_world_size(1) == 2
        assert sm(c, 1, 1, 0.0) == pytest.approx(50.0)
        return [sm(c, n, 1, 0.0) for n in (1, 2, 3, 4, 5, 100)]
    both(run)


def test_nearest_world_size_tie_breaking():
    def run(p):
        c = p.curve({2: 100.0, 4: 180.0, 8: 260.0})
        got = [c.nearest_world_size(n) for n in (2, 3, 7, 8, 1)]
        assert got == [2, 2, 4, 8, 2]
        return got
    both(run)


def test_degraded_parity_pin_when_no_curves_resolve():
    def run(p):
        jobs = [p.priced("a", 1, 1, 6, 2), p.priced("b", 1, 1, 6, 2)]
        r = p.big()
        empty = p.curves_for({"default/a": p.goodput.ScalingCurve(),
                              "default/b": p.goodput.ScalingCurve()})
        plan = p.planner.scale_all_jobs_goodput(jobs, r.copy(), 1.0,
                                                curves=empty)
        assert plan.mode == "degraded"
        assert plan.diff == p.planner.scale_all_jobs_dry_run(jobs, r.copy(),
                                                             1.0)
        return view(plan)
    both(run)


def test_empty_node_snapshot_never_crashes():
    def run(p):
        r = p.cr()
        gang = p.priced("gang", 2, 2, 2, 2, priority="HIGH")
        gang.pending = 2
        gang.pending_age = 10
        other = p.priced("other", 1, 1, 2, 1)
        plan = p.plan([gang, other], r,
                      p.curves_for({"default/other": {1: 100.0}}))
        assert plan.rollbacks and not plan.preemptions
        return view(plan)
    both(run)


# ---------------------------------------------------------------------------
# the loop: the autoscaler's goodput half
# ---------------------------------------------------------------------------


def test_autoscaler_loop_survives_a_raising_planner(monkeypatch):
    def run(p):
        c = p.cluster_with(cpu_milli=10_000)
        a = p.auto.Autoscaler(c, goodput_curves=lambda uid: p.curve(
            {1: 100.0}))
        job = p.mk_job("example", lo=2, hi=10)
        c.create_resources(job)
        a.on_add(job)

        def boom(*args, **kw):
            raise RuntimeError("planner bug")

        with monkeypatch.context() as m:
            m.setattr(p.auto, "plan_cluster", boom)
            target = a.tick()
        assert target and c.get_trainer_parallelism(job) == 10
        return target
    both(run)


def test_curve_source_fetched_once_per_tick():
    def run(p):
        calls = []
        cv = p.curve({2: 1000.0, 8: 3000.0})

        def source(uid):
            calls.append(uid)
            return cv

        c = p.cluster_with(cpu_milli=10_000)
        a = p.auto.Autoscaler(c, goodput_curves=source)
        job = p.mk_job("example", lo=2, hi=10)
        c.create_resources(job)
        a.on_add(job)
        target = a.tick()
        assert target
        assert a.advisory_history
        assert calls == ["default/example"]
        return target, list(a.advisory_history), calls
    both(run)


def test_advisory_history_is_bounded():
    def run(p):
        cv = p.curve({2: 1000.0, 8: 3000.0}, job="default/x")
        a = p.auto.Autoscaler(p.cluster_with(), goodput_curves=lambda uid: cv)
        assert isinstance(a.advisory_history, deque)
        assert a.advisory_history.maxlen == 256
        for _ in range(300):
            a._advise_goodput({"default/x": 4})
        assert len(a.advisory_history) == 256
        return list(a.advisory_history)[-1]
    both(run)


class KV:
    def __init__(self):
        self.d = {}

    def kv_set(self, k, v):
        self.d[k] = v

    def kv_get(self, k):
        return self.d.get(k)


def test_serving_scaler_records_capacity_curve():
    def run(p):
        kv = KV()
        job = p.t.ServingJob(name="fleet", spec=p.t.ServingSpec(
            min_replicas=1, max_replicas=8, slo_p99_ms=100.0))
        stats_by_tick = []

        def stats_for(uid):
            return stats_by_tick[-1]

        actuations = []
        s = p.auto.ServingScaler(
            stats_for=stats_for,
            actuate=lambda uid, n: actuations.append((uid, n)),
            coord_for=lambda j: kv, clock=lambda: 1000.0)
        s.on_add(job)
        stats_by_tick.append(types.SimpleNamespace(
            requests_windowed=500, qps=120.0, p99_ms=40.0, queue_depth=0,
            replicas_active=2))
        s.tick()
        stats_by_tick.append(types.SimpleNamespace(
            requests_windowed=900, qps=260.0, p99_ms=150.0, queue_depth=12,
            replicas_active=4))
        s._clock = lambda: 2000.0
        s.tick()
        c = p.goodput.load_curve(kv, "default/fleet")
        assert c is not None
        assert c.world_sizes() == [2, 4]
        assert c.tokens_per_second(2) == pytest.approx(120.0)
        assert c.tokens_per_second(4) == pytest.approx(260.0)
        assert c.marginal_tokens_per_second_per_chip(4) == pytest.approx(70.0)
        s2 = p.auto.ServingScaler(stats_for=stats_for,
                                  actuate=lambda uid, n: None,
                                  coord_for=lambda j: kv,
                                  clock=lambda: 3000.0)
        s2.on_add(job)
        stats_by_tick.append(types.SimpleNamespace(
            requests_windowed=400, qps=330.0, p99_ms=60.0, queue_depth=0,
            replicas_active=6))
        s2.tick()
        c = p.goodput.load_curve(kv, "default/fleet")
        assert c.world_sizes() == [2, 4, 6]
        return actuations, c.summary()
    both(run)


def test_capacity_curve_tracks_a_traffic_step():
    def run(p):
        c = p.goodput.ScalingCurve("default/fleet")
        for _ in range(500):
            c.observe(4, 100.0, shape="serving", max_samples=30)
        for _ in range(120):
            c.observe(4, 400.0, shape="serving", max_samples=30)
        got = c.tokens_per_second(4)
        assert got > 350.0, got
        frozen = p.goodput.ScalingCurve()
        for _ in range(500):
            frozen.observe(4, 100.0)
        for _ in range(120):
            frozen.observe(4, 400.0)
        assert frozen.tokens_per_second(4) < 180.0
        return got, frozen.tokens_per_second(4)
    both(run)


def test_arbitrated_serving_fleet_is_not_shape_quantized():
    def run(p):
        cluster = p.fake([("n0", 64_000, 64_000, 8, "")])
        fleet = p.serving(hi=6, slo_p99_ms=50.0)
        a = p.auto.Autoscaler(cluster, shape_policy=p.topology.POW2_POLICY,
                              goodput_curves=lambda uid: p.curve(
                                  {1: 100.0, 2: 200.0}))
        cluster.create_resources(fleet)
        a.on_add(fleet)
        for _ in range(8):
            a.tick()
        assert cluster.get_trainer_parallelism(fleet) == 6
        return a.plan_history
    both(run)


def test_paired_rebalance_legs_suppress_atomically(monkeypatch):
    def run(p):
        cluster = p.fake([("n0", 64_000, 64_000, 4, "")])
        clock_t = [1000.0]
        a = p.auto.Autoscaler(cluster, goodput_curves=lambda uid: p.curve(
            {1: 100.0}), resize_cooldown_s=30.0, clock=lambda: clock_t[0])
        winner = p.priced("winner", 1, 1, 4, 1).config
        victim = p.priced("victim", 1, 1, 4, 3).config
        cluster.create_resources(winner)
        cluster.create_resources(victim)
        a.on_add(winner)
        a.on_add(victim)
        a.drain_events()
        a._last_resize["default/victim"] = clock_t[0] - 1.0

        def fake_plan(jobs, r, mld=1.0, **kw):
            return p.planner.GoodputPlan(
                diff={"default/victim": -1, "default/winner": 1},
                mode="goodput",
                reclaims=[{"victim": "default/victim",
                           "for_job": "default/winner",
                           "from": 3, "to": 2, "reason": "rebalance"}])

        with monkeypatch.context() as m:
            m.setattr(p.auto, "plan_cluster", fake_plan)
            actuated = a.tick()
        assert actuated == {}, actuated
        assert a.suppressed_history[-1] == {
            "default/victim": "cooldown",
            "default/winner": "paired_reclaim"}
        return actuated, a.suppressed_history
    both(run)


def test_preemption_overrides_victim_cooldown(monkeypatch):
    def run(p):
        c = p.cluster_with()
        clock_t = [1000.0]
        a = p.auto.Autoscaler(c, goodput_curves=lambda uid: p.curve(
            {1: 100.0}), resize_cooldown_s=30.0, clock=lambda: clock_t[0])
        victim = p.priced("victim", 0, 1, 8, 4).config
        c.create_resources(victim)
        c.update_trainer_parallelism(victim, 4)
        a.on_add(victim)
        a.drain_events()
        a._last_resize["default/victim"] = clock_t[0] - 1.0
        plan = p.planner.GoodputPlan(
            diff={"default/victim": -2}, mode="goodput",
            preemptions=[{"victim": "default/victim",
                          "for_job": "default/gang", "from": 4, "to": 2,
                          "domain": None, "reason": "preempt"}])
        with monkeypatch.context() as m:
            m.setattr(p.auto, "plan_cluster",
                      lambda jobs, r, mld=1.0, **kw: plan)
            actuated = a.tick()
        assert actuated == {"default/victim": 2}, actuated
        return actuated
    both(run)


def test_observe_only_serving_job_hints_but_never_actuates():
    def run(p):
        job = p.t.ServingJob(name="fleet", spec=p.t.ServingSpec(
            min_replicas=1, max_replicas=8, slo_p99_ms=100.0))
        breach = types.SimpleNamespace(requests_windowed=900, qps=260.0,
                                       p99_ms=400.0, queue_depth=40,
                                       replicas_active=2)
        actuations, hints = [], []
        s = p.auto.ServingScaler(
            stats_for=lambda uid: breach,
            actuate=lambda uid, n: actuations.append((uid, n)),
            clock=lambda: 1000.0)
        s.hint_sink = lambda uid, n: hints.append((uid, n))
        s.on_add(job)
        s.observe_only.add(job.full_name)
        s.tick()
        assert actuations == []
        assert hints and hints[0][1] > 2
        return hints
    both(run)


def test_autoscaler_objective_gauge_reports_active_mode():
    def run(p):
        cv = p.curve({2: 1000.0, 8: 3000.0})
        c = p.cluster_with()
        a = p.auto.Autoscaler(c, goodput_curves=lambda uid: cv)
        job = p.mk_job("example", lo=2, hi=10)
        c.create_resources(job)
        a.on_add(job)
        a.tick()
        series = p.metrics.parse_exposition(
            p.metrics.get_registry().render())
        assert series['edl_autoscaler_objective{mode="goodput"}'] == 1.0
        assert series['edl_autoscaler_objective{mode="count"}'] == 0.0
        c2 = p.cluster_with()
        b = p.auto.Autoscaler(c2, goodput_curves=lambda uid: cv,
                              goodput_objective=False)
        job2 = p.mk_job("example", lo=2, hi=10)
        c2.create_resources(job2)
        b.on_add(job2)
        b.tick()
        series = p.metrics.parse_exposition(
            p.metrics.get_registry().render())
        assert series['edl_autoscaler_objective{mode="count"}'] == 1.0
        return a.objective_mode, b.objective_mode
    assert both(run) == ("goodput", "count")


def test_controller_arbitrates_elastic_chip_serving_fleets():
    def run(p):
        cluster = p.fake([("n0", 64_000, 64_000, 8, "")])
        ctl = p.Controller(cluster, goodput_curves=lambda uid: None)
        job = p.serving(hi=4, slo_p99_ms=50.0)
        seen = []
        try:
            ctl.submit(job)
            ctl.autoscaler.drain_events()
            seen.append((job.full_name in ctl.autoscaler.jobs,
                         job.full_name in ctl.serving_scaler.observe_only))
            ctl.delete(job)
            ctl.autoscaler.drain_events()
            seen.append((job.full_name in ctl.autoscaler.jobs,
                         job.full_name in ctl.serving_scaler.observe_only))
        finally:
            ctl.stop()
        assert seen == [(True, True), (False, False)]
        return seen
    both(run)


def test_controller_modify_reconciles_arbitration_both_ways():
    def run(p):
        cluster = p.fake([("n0", 64_000, 64_000, 8, "")])
        ctl = p.Controller(cluster, goodput_curves=lambda uid: None)
        job = p.serving(lo=2, hi=2, slo_p99_ms=50.0)
        seen = []

        def look():
            ctl.autoscaler.drain_events()
            seen.append((job.full_name in ctl.serving_scaler.observe_only,
                         job.full_name in ctl.autoscaler.jobs))

        try:
            ctl.submit(job)
            look()
            job.spec.max_replicas = 4
            ctl.modify(job)
            look()
            job.spec.max_replicas = 2
            ctl.modify(job)
            look()
        finally:
            ctl.delete(job)
            ctl.stop()
        assert seen == [(False, False), (True, True), (False, False)]
        return seen
    both(run)


# ---------------------------------------------------------------------------
# seeded random clusters
# ---------------------------------------------------------------------------


def random_case(seed: int) -> dict:
    """A package-neutral random cluster: domains of nodes with free
    accelerators, jobs (some multi-domain, some serving) at random
    priorities, parallelism, pending gangs and pins, and curves (some
    falling) for a random subset."""
    rng = np.random.default_rng(seed)
    nodes, pins = {}, {}
    for d in range(int(rng.integers(1, 4))):
        for k in range(int(rng.integers(1, 4))):
            nodes[f"d{d}n{k}"] = (int(rng.integers(4, 17)) * 1000,
                                  int(rng.integers(8, 33)) * 1000,
                                  int(rng.integers(0, 5)), f"D{d}")
    total = sum(n[2] for n in nodes.values()) + int(rng.integers(0, 5))
    jobs = []
    for i in range(int(rng.integers(1, 6))):
        lo = int(rng.integers(0, 3))
        hi = lo + int(rng.integers(0, 6))
        jobs.append(dict(
            name=f"j{i}", acc=int(rng.choice([0, 1, 1, 2])), lo=lo, hi=hi,
            p=int(rng.integers(0, hi + 2)),
            priority=["LOW", "NORMAL", "HIGH"][int(rng.integers(0, 3))],
            multi=bool(rng.random() < 0.3),
            serving=bool(rng.random() < 0.2),
            pending=int(rng.integers(1, 4)) if rng.random() < 0.5 else 0,
            age=int(rng.integers(0, 5)),
            curve={int(w): float(rng.uniform(10, 1000))
                   for w in sorted(rng.choice(
                       np.arange(1, 9), size=int(rng.integers(1, 4)),
                       replace=False))}
            if rng.random() < 0.7 else None))
        if jobs[-1]["pending"] and rng.random() < 0.5:
            jobs[-1]["priority"] = "HIGH"  # a gang that may preempt
        if rng.random() < 0.4:
            pins[f"default/j{i}"] = f"D{int(rng.integers(0, 3))}"
    return dict(nodes=nodes, pins=pins, total=total,
                limit=int(rng.integers(0, total + 4)),
                cpu=int(rng.integers(8, 64)) * 1000,
                cpu_req=int(rng.integers(0, 8)) * 1000,
                mem=int(rng.integers(16, 128)) * 1000, jobs=jobs)


def build(p: Pkg, case: dict):
    r = p.cr(case["nodes"], acc_total=case["total"], acc_limit=case["limit"],
             pins=case["pins"], cpu_total_milli=case["cpu"],
             cpu_request_milli=case["cpu_req"],
             memory_total_mega=case["mem"])
    jobs, curves = [], {}
    for j in case["jobs"]:
        if j["serving"]:
            cfg = p.serving(j["name"], lo=max(j["lo"], 1),
                            hi=max(j["hi"], 1), acc=str(j["acc"]),
                            priority=int(p.t.SchedPriority[j["priority"]]))
            pj = p.planner.PlannedJob(config=cfg, parallelism=j["p"])
        else:
            pj = p.priced(j["name"], j["acc"], j["lo"], j["hi"], j["p"],
                          priority=j["priority"])
            pj.config.spec.trainer.allow_multi_domain = j["multi"]
        pj.pending = j["pending"]
        pj.pending_age = j["age"]
        jobs.append(pj)
        if j["curve"] is not None:
            curves[f"default/{j['name']}"] = j["curve"]
    return jobs, r, p.curves_for(curves)


@pytest.mark.parametrize("seed", range(50))
def test_random_clusters_plan_equal(seed):
    case = random_case(seed)

    def run(p):
        jobs, r, curves = build(p, case)
        before = r.copy()
        plan = p.plan(jobs, r, curves)
        # the snapshot is a value: planning never mutates the caller's
        assert p.pins(r) == p.pins(before) and dict(p.free(r)) == dict(
            p.free(before))
        return view(plan)
    both(run)
