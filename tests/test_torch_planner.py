"""The port's count planner (edl_tpu_torch.scheduler.{planner,topology})
against the JAX package's: tests/test_planner.py's scenarios (the
reference's pkg/autoscaler_internal_test.go cases, the slice-shape
policies, NVLink-domain contiguity and the multi-domain opt-in) built on
both packages from one description — TPU chips mapped onto GPU cards, ICI
domains onto NVLink domains — each result required equal to the
reference's and to its expected value; then seeded random clusters, on
which ``scale_all_jobs_dry_run`` and ``search_assignable_nodes`` must give
equal diffs and placements."""

import numpy as np
import pytest

from edl_tpu.api import types as jtypes
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.cluster.resource import (ClusterResource as JaxResource,
                                      NodeResources as JaxNodes)
from edl_tpu.scheduler import planner as jplanner
from edl_tpu.scheduler import topology as jtopology
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.cluster.resource import ClusterResource, NodeResources
from edl_tpu_torch.scheduler import planner as tplanner
from edl_tpu_torch.scheduler import topology as ttopology


class Pkg:
    """One package's planner, built from a package-neutral description:
    ``gpu_*`` totals and per-node ``gpu`` free counts and ``domain``s."""

    def __init__(self, jax: bool) -> None:
        self.jax = jax
        self.planner = jplanner if jax else tplanner
        self.topology = jtopology if jax else ttopology
        self.types = jtypes if jax else ttypes
        self.gpu_key = jtypes.RESOURCE_TPU if jax else ttypes.RESOURCE_GPU

    def cr(self, nodes=None, gpu_total=0, gpu_limit=0, gpu_request=0,
           pins=None, **kw):
        """``nodes``: name → (cpu idle, mem free[, gpu free[, domain]])."""
        acc = ("tpu" if self.jax else "gpu")
        kw.update({f"{acc}_total": gpu_total, f"{acc}_limit": gpu_limit,
                   f"{acc}_request": gpu_request})
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
            nr = JaxNodes(nodes_tpu_free=free, nodes_ici_domain=doms,
                          **node_kw)
            r = JaxResource(nodes=nr, **kw)
            r.jobs_ici_domain.update(pins or {})
        else:
            nr = NodeResources(nodes_gpu_free=free, nodes_nvlink_domain=doms,
                               **node_kw)
            r = ClusterResource(nodes=nr, **kw)
            r.jobs_nvlink_domain.update(pins or {})
        return r

    def pins(self, r) -> dict:
        return dict(r.jobs_ici_domain if self.jax else r.jobs_nvlink_domain)

    def gpu_total(self, r) -> int:
        return r.tpu_total if self.jax else r.gpu_total

    def job(self, name, cpu_req, cpu_lim, mem_req, mem_lim, gpu_lim, lo, hi,
            p, policy="unit", multi=False):
        t = self.types
        job = t.TrainingJob(name=name, spec=t.TrainingJobSpec(
            trainer=t.TrainerSpec(
                min_instance=lo, max_instance=hi, allow_multi_domain=multi,
                resources=t.ResourceRequirements(
                    requests={"cpu": cpu_req, "memory": mem_req},
                    limits={"cpu": cpu_lim, "memory": mem_lim,
                            self.gpu_key: gpu_lim}))))
        if policy == "unit":
            pol = self.topology.UNIT_POLICY
        elif policy == "pow2":
            pol = self.topology.POW2_POLICY
        else:
            pol = self.topology.explicit_policy(policy)
        return self.planner.PlannedJob(config=job, parallelism=p,
                                       shape_policy=pol)

    def cards(self, j) -> int:
        return j.tpu_chip_limit() if self.jax else j.gpu_limit()

    def cluster(self, nodes):
        """A fake cluster of ``(name, domain, cards)`` nodes."""
        c = JaxCluster() if self.jax else TorchCluster()
        for name, dom, n in nodes:
            if self.jax:
                c.add_node(name, cpu_milli=8000, memory_mega=16000,
                           tpu_chips=n, ici_domain=dom)
            else:
                c.add_node(name, cpu_milli=8000, memory_mega=16000, gpus=n,
                           nvlink_domain=dom)
        return c

    def node_domain(self, c, name) -> str:
        n = c._nodes[name]
        return n.ici_domain if self.jax else n.nvlink_domain


JAX, TORCH = Pkg(True), Pkg(False)


def both(fn):
    """``fn(pkg)`` on the JAX package and on the port; asserts the two
    equal and returns the port's."""
    want, got = fn(JAX), fn(TORCH)
    assert got == want
    return got


def all_idle(p, **kw):
    return p.cr(nodes={"node0": (99999, 99999)}, **kw)


def dry(r_kw, job_args, calls, idle=True):
    """``scale_dry_run`` results for ``calls`` of (cur_diff, mld, down)."""
    def run(p):
        r = all_idle(p, **r_kw) if idle else p.cr(**r_kw)
        j = p.job(*job_args)
        return [p.planner.scale_dry_run(r, j, d, m, down)
                for d, m, down in calls]
    return both(run)


def dry_all(r_kw, jobs, mld=1.0, idle=True):
    def run(p):
        r = all_idle(p, **r_kw) if idle else p.cr(**r_kw)
        return p.planner.scale_all_jobs_dry_run(
            [p.job(*a) for a in jobs], r, mld)
    return both(run)


# -- the reference's cases (autoscaler_internal_test.go:96-438) ------------------


def test_trainer_request_limit():
    got = both(lambda p: (lambda j: (j.cpu_request_milli(),
                                     j.mem_request_mega(), p.cards(j)))(
        p.job("name", "1k", "1k", "100Mi", "100Mi", "10", 1, 1, 1)))
    assert got == (1_000_000, 105, 10)


def test_scale_dry_run_satisfied():
    got = dry(dict(cpu_total_milli=2000, memory_total_mega=1000),
              ("name", "1000Mi", "1000Mi", "100Mi", "100Mi", "0", 1, 2, 2),
              [(0, 1.0, False)], idle=False)
    assert got == [0]


CPU_R = dict(cpu_limit_milli=100, cpu_request_milli=100,
             cpu_total_milli=3000, memory_request_mega=100,
             memory_limit_mega=100, memory_total_mega=1000)


@pytest.mark.parametrize("r_kw, job, calls, want", [
    (CPU_R, ("name", "1", "1", "100Mi", "100Mi", "0", 1, 3, 1),
     [(0, 1.0, False)], [1]),
    (dict(CPU_R, cpu_limit_milli=1000, cpu_request_milli=1000,
          cpu_total_milli=1000),
     ("name", "1", "1", "100Mi", "100Mi", "0", 1, 3, 1),
     [(0, 1.0, False)], [0]),
    (dict(cpu_total_milli=2000, memory_request_mega=100,
          memory_limit_mega=100, memory_total_mega=1000, gpu_total=10),
     ("name", "1", "1", "10Mi", "10Mi", "1", 1, 3, 1),
     [(0, 1.0, False), (0, 1.0, True)], [1, 0]),
    (dict(cpu_total_milli=2000, memory_request_mega=100,
          memory_limit_mega=100, memory_total_mega=1000, gpu_limit=10,
          gpu_request=10, gpu_total=10),
     ("name", "1", "1", "10Mi", "10Mi", "1", 1, 3, 1),
     [(0, 1.0, False)], [0]),
    (dict(cpu_limit_milli=5000, cpu_request_milli=5000, cpu_total_milli=3000,
          memory_request_mega=1000, memory_limit_mega=1000,
          memory_total_mega=1000, gpu_limit=10, gpu_request=10,
          gpu_total=10),
     ("name", "1", "1", "10Mi", "10Mi", "0", 1, 3, 3),
     [(0, 1.0, True), (-1, 1.0, True), (-2, 1.0, True)], [-1, -1, 0]),
    (dict(cpu_limit_milli=2000, cpu_request_milli=2000, cpu_total_milli=1000,
          memory_request_mega=1000, memory_limit_mega=1000,
          memory_total_mega=1000, gpu_limit=10, gpu_request=10,
          gpu_total=10),
     ("name", "1", "1", "10Mi", "10Mi", "0", 1, 3, 3),
     [(0, 1.0, True), (0, 1.0, False)], [-1, 0]),
    (dict(cpu_limit_milli=1000, cpu_request_milli=1000, cpu_total_milli=1000,
          memory_request_mega=1000, memory_limit_mega=1000,
          memory_total_mega=1000, gpu_limit=10, gpu_request=10,
          gpu_total=10),
     ("name", "1", "1", "100Mi", "100Mi", "0", 1, 3, 1),
     [(0, 1.0, False)], [0]),
], ids=["more_cpu", "no_more_cpu", "more_gpu", "no_more_gpu",
        "scale_down_to_min", "scale_down_full_cluster", "no_mem"])
def test_scale_dry_run(r_kw, job, calls, want):
    assert dry(r_kw, job, calls) == want


def test_scale_dry_run_scale_down_more_than_expected():
    got = dry(dict(cpu_limit_milli=1000, cpu_request_milli=1000,
                   cpu_total_milli=1000, memory_request_mega=1000,
                   memory_limit_mega=1000, memory_total_mega=1000,
                   gpu_limit=10, gpu_request=10, gpu_total=10),
              ("name", "1", "1", "10Mi", "10Mi", "0", 1, 3, 6),
              [(0, 1.0, True), (-1, 1.0, True), (-2, 1.0, True),
               (-3, 1.0, True)], idle=False)
    assert got == [-1, -1, -1, 0]


@pytest.mark.parametrize("r_kw, job, mld, want", [
    (dict(cpu_total_milli=1000, memory_request_mega=1000,
          memory_limit_mega=1000, memory_total_mega=1000, gpu_total=10),
     ("name", "1", "1", "1", "1", "1", 1, 3, 1), 1.0, 0),
    (dict(cpu_limit_milli=1000, cpu_request_milli=1000, cpu_total_milli=4000,
          memory_request_mega=100, memory_limit_mega=100,
          memory_total_mega=1000, gpu_limit=8, gpu_request=8, gpu_total=10),
     ("name", "1", "1", "100Mi", "100Mi", "0", 1, 3, 1), 1.0, 2),
    (dict(CPU_R, cpu_limit_milli=1000, cpu_request_milli=1000,
          gpu_total=10),
     ("name", "1", "1", "100Mi", "100Mi", "0", 1, 3, 1), 0.8, 1),
    (dict(CPU_R, cpu_limit_milli=3000, cpu_request_milli=3000,
          gpu_total=10),
     ("name", "1", "1", "100Mi", "100Mi", "0", 1, 3, 3), 0.8, -1),
    (dict(CPU_R, cpu_limit_milli=2000, cpu_request_milli=2000, gpu_limit=8,
          gpu_request=8, gpu_total=10),
     ("name", "1", "1", "1", "1", "1", 1, 3, 1), 1.0, 1),
    (dict(cpu_limit_milli=990, cpu_request_milli=990, cpu_total_milli=2000,
          memory_request_mega=100, memory_limit_mega=100,
          memory_total_mega=1000, gpu_limit=9, gpu_request=9, gpu_total=10),
     ("name", "1", "1", "1", "1", "1", 1, 3, 1), 1.0, 1),
], ids=["no_mem", "all", "not_full", "down_not_full", "less_cpu",
        "less_gpu"])
def test_scale_all_dry_run(r_kw, job, mld, want):
    assert dry_all(r_kw, [job], mld) == {"default/name": want}


def test_fulfillment():
    got = both(lambda p: [p.job("name", "1", "1", "1", "1", "1", 1, hi, n)
                          .fulfillment() for hi, n in ((2, 2), (2, 1),
                                                       (3, 2))])
    assert got == [1.0, 0.0, 0.5]


@pytest.mark.parametrize("jobs, filt, want", [
    ([("a", "1", "1", "1", "1", "1", 1, 2, 2),
      ("b", "1", "1", "1", "1", "1", 1, 20, 2),
      ("c", "1", "1", "1", "1", "1", 1, 10, 2),
      ("d", "1", "1", "1", "1", "1", 1, 1, 2)], "elastic", ["b", "c", "a"]),
    ([("a", "1", "1", "1", "1", "1", 1, 2, 2),
      ("b", "1", "1", "1", "1", "0", 1, 20, 2),
      ("c", "1", "1", "1", "1", "0", 1, 10, 2),
      ("d", "1", "1", "1", "1", "0", 1, 1, 2)], "accelerator", ["a"]),
    ([("a", "1", "0", "1", "1", "1", 1, 2, 1),
      ("b", "1", "1", "1", "1", "0", 1, 2, 1),
      ("c", "10", "10", "1", "1", "0", 1, 2, 1),
      ("d", "1", "1", "2", "2", "0", 1, 2, 1)], "elastic",
     ["b", "d", "c", "a"]),
], ids=["sorted", "accelerator_only", "with_tie"])
def test_sorted_jobs(jobs, filt, want):
    def run(p):
        f = (p.planner.elastic if filt == "elastic" else
             p.planner.need_tpu if p.jax else p.planner.need_gpu)
        return [j.name for j in p.planner.sorted_jobs(
            [p.job(*a) for a in jobs], f)]
    assert both(run) == want


# -- slice-shape policies ------------------------------------------------------------


def big(p, cpu=64_000, mem=64_000):
    return p.cr(nodes={"node0": (cpu, mem)}, cpu_total_milli=cpu,
                memory_total_mega=mem)


@pytest.mark.parametrize("hi, policy, want", [
    (8, "pow2", 7), (6, "pow2", 3), (16, [1, 4, 8, 16], 15)],
    ids=["pow2_steps", "pow2_stops_below_max", "explicit"])
def test_policy_walks_valid_counts(hi, policy, want):
    got = both(lambda p: p.planner.scale_all_jobs_dry_run(
        [p.job("j", "1", "1", "1Mi", "1Mi", "0", 1, hi, 1, policy=policy)],
        big(p), 1.0))
    assert got == {"default/j": want}


def test_pow2_policy_rejects_partial_steps():
    got = both(lambda p: p.planner.scale_all_jobs_dry_run(
        [p.job("j", "1", "1", "1Mi", "1Mi", "0", 1, 8, 2, policy="pow2")],
        p.cr(nodes={"node0": (1000, 64_000)}, cpu_total_milli=3000,
             cpu_request_milli=2000, memory_total_mega=64_000), 1.0))
    assert got == {"default/j": 0}


def test_pow2_policy_scale_down_steps():
    def run(p):
        r = p.cr(cpu_total_milli=1000, cpu_request_milli=8000,
                 memory_total_mega=1000)
        j = p.job("j", "1", "1", "1Mi", "1Mi", "0", 2, 8, 8, policy="pow2")
        return [p.planner.scale_dry_run(r, j, d, 1.0, True)
                for d in (0, -4, -6)]
    assert both(run) == [-4, -2, 0]


def test_planner_does_not_mutate_input_snapshot():
    def run(p):
        r = big(p)
        before = (r.cpu_request_milli, dict(r.nodes.nodes_cpu_idle_milli))
        p.planner.scale_all_jobs_dry_run(
            [p.job("j", "1", "1", "1Mi", "1Mi", "0", 1, 4, 1)], r, 1.0)
        return (r.cpu_request_milli,
                dict(r.nodes.nodes_cpu_idle_milli)) == before
    assert both(run) is True


def test_two_jobs_share_cluster_fairly():
    got = both(lambda p: p.planner.scale_all_jobs_dry_run(
        [p.job(n, "1", "1", "1Mi", "1Mi", "0", 1, 10, 1) for n in "ab"],
        p.cr(nodes={"node0": (4000, 64_000)}, cpu_total_milli=6000,
             cpu_request_milli=2000, memory_total_mega=64_000), 1.0))
    assert got["default/a"] + got["default/b"] == 4
    assert abs(got["default/a"] - got["default/b"]) <= 1


# -- NVLink-domain contiguity (the JAX package's ICI domains) ----------------------


DOMAINS = {"a0": "A", "a1": "A", "b0": "B", "b1": "B"}


def two_domain(p, free=None, **kw):
    """Two domains of 2 nodes x 2 cards each (4 cards a domain)."""
    free = free or {}
    return p.cr(nodes={n: (8000, 16000, free.get(n, 2), d)
                       for n, d in DOMAINS.items()},
                cpu_total_milli=32_000, memory_total_mega=64_000,
                gpu_total=8, **kw)


def test_planner_caps_a_card_job_at_one_domain():
    got = both(lambda p: p.planner.scale_all_jobs_dry_run(
        [p.job("j", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0)], two_domain(p),
        1.0))
    assert got == {"default/j": 2}


def test_planner_respects_existing_domain_pin():
    got = both(lambda p: p.planner.scale_all_jobs_dry_run(
        [p.job("j", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0)],
        two_domain(p, free={"b1": 0}, gpu_limit=2,
                   pins={"default/j": "B"}), 1.0))
    assert got == {"default/j": 1}


def test_planner_prefers_roomier_domain():
    def run(p):
        r = two_domain(p, free={"a0": 0, "a1": 0}, gpu_limit=4)
        diff = p.planner.scale_all_jobs_dry_run(
            [p.job("j", "1", "1", "1Mi", "1Mi", "2", 0, 2, 0)], r, 1.0)
        return diff, p.pins(r)
    assert both(run) == ({"default/j": 2}, {})


def test_two_card_jobs_land_in_distinct_domains():
    def run(p):
        r = two_domain(p)
        diff = p.planner.scale_all_jobs_dry_run(
            [p.job(n, "1", "1", "1Mi", "1Mi", "2", 0, 2, 0) for n in "ab"],
            r, 1.0)
        return diff, p.gpu_total(r)
    assert both(run) == ({"default/a": 2, "default/b": 2}, 8)


def _actuate(p, nodes, jobs) -> dict:
    """Plan ``jobs`` on a fake cluster of ``nodes`` and actuate the plan:
    each job's target, pod counts and the domains its pods run in."""
    c = p.cluster(nodes)
    out = {}
    for j in jobs:
        c.create_resources(j.config)
        c.reconcile()
    r = c.inquiry_resource()
    out["pins"] = sorted(p.pins(r))
    for j in jobs:
        j.parallelism = c.get_trainer_parallelism(j.config)
    diff = p.planner.scale_all_jobs_dry_run(jobs, r, 1.0)
    for j in jobs:
        c.update_trainer_parallelism(j.config, j.parallelism + diff[j.uid])
    c.reconcile()
    for j in jobs:
        counts = c.job_pods(j.config)
        out[j.name] = (j.parallelism + diff[j.uid], counts.running,
                       counts.pending, sorted(
                           p.node_domain(c, q.node)
                           for q in c.list_pods(job_uid=j.uid)))
    return out


FOUR_NODES = [(n, d, 2) for n, d in DOMAINS.items()]


def test_planner_and_fake_kubelet_agree_on_domains():
    got = both(lambda p: _actuate(p, FOUR_NODES, [
        p.job("j", "1", "1", "1Mi", "1Mi", "2", 1, 4, 1)]))
    target, running, pending, doms = got["j"]
    assert got["pins"] == ["default/j"]
    assert (target, running, pending) == (2, 2, 0) and len(set(doms)) == 1


def test_multi_domain_job_spans_domains():
    def run(p):
        r = two_domain(p)
        diff = p.planner.scale_all_jobs_dry_run(
            [p.job("j", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0, multi=True)],
            r, 1.0)
        return diff, p.pins(r)
    assert both(run) == ({"default/j": 4}, {})


def test_multi_domain_job_consolidates_when_it_fits():
    nodes, domain = both(lambda p: p.planner.search_assignable_nodes(
        two_domain(p), p.job("j", "1", "1", "1Mi", "1Mi", "2", 0, 2, 0,
                             multi=True), 2))
    assert domain is None and len({DOMAINS[n] for n in nodes}) == 1


def test_multi_domain_fake_kubelet_places_across_domains():
    got = both(lambda p: _actuate(p, FOUR_NODES, [
        p.job("j", "1", "1", "1Mi", "1Mi", "2", 1, 4, 1, multi=True)]))
    assert got["pins"] == []
    assert got["j"] == (4, 4, 0, ["A", "A", "B", "B"])


def test_single_domain_default_still_caps():
    got = both(lambda p: p.planner.scale_all_jobs_dry_run(
        [p.job("p", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0),
         p.job("s", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0, multi=True)],
        two_domain(p), 1.0))
    assert got == {"default/p": 2, "default/s": 2}


def test_card_pack_to_100pct_not_reversed_by_down_pass():
    def run(p):
        packed = p.planner.scale_all_jobs_dry_run(
            [p.job("j", "1", "1", "1Mi", "1Mi", "2", 0, 4, 0, multi=True)],
            two_domain(p), 0.97)
        r2 = two_domain(p, gpu_limit=6)
        if p.jax:
            r2.tpu_total = 4
        else:
            r2.gpu_total = 4
        drained = p.planner.scale_dry_run(
            r2, p.job("jr", "1", "1", "1Mi", "1Mi", "2", 1, 4, 3), 0, 0.97,
            True)
        return packed, drained
    assert both(run) == ({"default/j": 4}, -1)


def test_multi_domain_consolidates_via_whole_domain_try():
    got = both(lambda p: p.planner.search_assignable_nodes(
        p.cr(nodes={"a0": (8000, 16000, 4, "A"), "a1": (8000, 16000, 2, "A"),
                    "b0": (8000, 16000, 6, "B")},
             cpu_total_milli=24_000, memory_total_mega=48_000, gpu_total=12),
        p.job("j", "1", "1", "1Mi", "1Mi", "3", 0, 2, 0, multi=True), 2))
    assert got == (["b0", "b0"], None)


def test_spanning_and_pinned_jobs_contend_for_overlapping_domains():
    def run(p):
        r = p.cr(nodes={"a0": (8000, 16000, 0, "A"),
                        "a1": (8000, 16000, 2, "A"),
                        "b0": (8000, 16000, 0, "B"),
                        "b1": (8000, 16000, 2, "B")},
                 cpu_total_milli=32_000, memory_total_mega=64_000,
                 gpu_total=8, gpu_limit=4, pins={"default/p": "A"})
        pinned = p.job("p", "1", "1", "1Mi", "1Mi", "2", 1, 2, 1)
        spanning = p.job("s", "1", "1", "1Mi", "1Mi", "2", 1, 3, 1,
                         multi=True)
        search = p.planner.search_assignable_nodes
        placed = (search(r, spanning, 1), search(r, spanning, 2),
                  search(r, pinned, 1))
        diff = p.planner.scale_all_jobs_dry_run([pinned, spanning],
                                                r.copy(), 1.0)
        live = _actuate(p, FOUR_NODES, [
            p.job("p", "1", "1", "1Mi", "1Mi", "2", 1, 2, 1),
            p.job("s", "1", "1", "1Mi", "1Mi", "2", 1, 3, 1, multi=True)])
        return placed, diff, live

    placed, diff, live = both(run)
    assert placed[0] == (["a1"], None)
    assert placed[1] == (["a1", "b1"], None)
    assert placed[2][1] == "A"
    assert diff == {"default/p": 1, "default/s": 1}
    for name in "ps":  # the world IS the plan, nothing stranded
        assert live[name][1:3] == (live[name][0], 0)
    assert len(set(live["p"][3])) == 1  # the pinned job kept its domain
    assert 2 * (live["p"][0] + live["s"][0]) == 8


def test_spanning_world_across_unequal_domains_3_plus_1():
    def run(p):
        nodes = [("a0", "A", 2), ("a1", "A", 1), ("b0", "B", 1)]
        c = p.cluster(nodes)
        j = p.job("j", "1", "1", "1Mi", "1Mi", "1", 1, 4, 1, multi=True)
        c.create_resources(j.config)
        c.reconcile()
        r = c.inquiry_resource()
        found = p.planner.search_assignable_nodes(r, j, 3)
        doms = [r.nodes.domain_of(n) for n in found[0]]
        return p.pins(r), doms, _actuate(p, nodes, [
            p.job("j", "1", "1", "1Mi", "1Mi", "1", 1, 4, 1, multi=True)])
    pins, doms, live = both(run)
    assert pins == {} and doms == ["A", "A", "B"]
    assert live["j"] == (4, 4, 0, ["A", "A", "A", "B"])


# -- the port's objective switch ----------------------------------------------------


def test_plan_cluster_count_wraps_the_packer():
    def run(p):
        jobs = [p.job("j", "1", "1", "1Mi", "1Mi", "0", 1, 4, 1)]
        plan = p.planner.plan_cluster(jobs, big(p), 1.0, objective="count")
        return plan.diff, plan.mode, plan.preemptions, plan.reclaims
    assert both(run) == ({"default/j": 3}, "count", [], [])


# -- seeded random clusters ----------------------------------------------------------


def random_case(seed: int):
    """A random snapshot (nodes with cards in two domains, some already
    used, pins) and jobs (CPU or card, some multi-domain, POW2 or unit),
    as a package-neutral description."""
    rng = np.random.default_rng(seed)
    nodes = {}
    for i in range(int(rng.integers(1, 6))):
        cards = int(rng.choice([0, 1, 2, 4, 8]))
        nodes[f"n{i}"] = (int(rng.integers(1, 9)) * 1000,
                          int(rng.integers(1, 9)) * 4000,
                          int(rng.integers(0, cards + 1)) if cards else None,
                          f"d{int(rng.integers(2))}")
    total_cpu = sum(n[0] for n in nodes.values()) + int(rng.integers(0, 4)) * 1000
    total_mem = sum(n[1] for n in nodes.values())
    total_cards = sum(n[2] or 0 for n in nodes.values()) + int(rng.integers(0, 4))
    jobs = []
    for i in range(int(rng.integers(1, 5))):
        lo = int(rng.integers(0, 3))
        hi = lo + int(rng.integers(0, 7))
        jobs.append((f"j{i}", str(int(rng.integers(1, 3)) * 500) + "m",
                     "1", f"{int(rng.integers(1, 5)) * 100}Mi", "1Gi",
                     str(int(rng.choice([0, 0, 1, 2]))), lo, hi,
                     int(rng.integers(lo, hi + 2)),
                     str(rng.choice(["unit", "pow2"])),
                     bool(rng.integers(2))))
    r_kw = dict(cpu_total_milli=total_cpu,
                cpu_request_milli=int(rng.integers(0, total_cpu + 1)),
                memory_total_mega=total_mem,
                memory_request_mega=int(rng.integers(0, total_mem // 2 + 1)),
                gpu_total=total_cards,
                gpu_limit=int(rng.integers(0, total_cards + 2)))
    pins = {f"default/{j[0]}": f"d{int(rng.integers(2))}" for j in jobs
            if not j[-1] and rng.integers(3) == 0}
    return nodes, r_kw, pins, jobs, float(rng.choice([0.8, 0.97, 1.0]))


def _build(p, seed):
    nodes, r_kw, pins, jobs, mld = random_case(seed)
    r = p.cr(nodes=nodes, pins=pins, **r_kw)
    return r, [p.job(*a[:9], policy=a[9], multi=a[10]) for a in jobs], mld


@pytest.mark.parametrize("seed", range(40))
def test_random_clusters_plan_alike(seed):
    def run(p):
        r, jobs, mld = _build(p, seed)
        diff = p.planner.scale_all_jobs_dry_run(jobs, r, mld)
        placements = [p.planner.search_assignable_nodes(r, j, n)
                      for j in jobs for n in (1, 2, 3)]
        steps = [p.planner.scale_dry_run(r.copy(), j, 0, mld, down)
                 for j in jobs for down in (False, True)]
        return diff, placements, steps, p.pins(r)
    both(run)
