"""The port's Autoscaler (edl_tpu_torch.scheduler.autoscaler) against the
JAX package's: tests/test_autoscaler.py's scenarios and seeded random
clusters, each driven on two identical fake clusters — one per package —
tick by tick, the targets of every ``tick()`` required equal, and the
reference's assertions held on the port.  The port's one deliberate
difference — a killed trainer's Failed pod is not counted, so a job whose
killed trainer was replaced stays in the plans and a job whose trainers
were all killed makes the others fair game (ROADMAP.md queue 3) — has its
own tests, and seeded clusters with pod kills show that it is the only
one: the port ticks as the reference does once the Failed pods are gone."""

import time
from dataclasses import astuple

import numpy as np
import pytest

from edl_tpu.api import types as jtypes
from edl_tpu.cluster.base import PodPhase as JaxPodPhase
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.scheduler.autoscaler import Autoscaler as JaxAutoscaler
from edl_tpu.scheduler.topology import POW2_POLICY as JAX_POW2
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.scheduler import POW2_POLICY
from edl_tpu_torch.scheduler.autoscaler import Autoscaler


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _job(t, name, lo, hi, cpu="1", mem="100M", gpus=0, multi=False,
         gpu_key=None):
    limits = {"cpu": cpu, "memory": mem}
    if gpus:
        limits[gpu_key] = str(gpus)
    return t.TrainingJob(name=name, spec=t.TrainingJobSpec(
        fault_tolerant=True, trainer=t.TrainerSpec(
            min_instance=lo, max_instance=hi, allow_multi_domain=multi,
            resources=t.ResourceRequirements(
                requests={"cpu": cpu, "memory": mem}, limits=limits))))


class Twin:
    """The same cluster script on the JAX package's FakeCluster +
    Autoscaler and on the port's; ``tick()`` ticks both and requires equal
    targets.  With ``gc_ref`` a killed pod's Failed pod is removed from the
    reference's cluster (Kubernetes' pod garbage collection) and lingers
    on the port's."""

    def __init__(self, pow2=False, gc_ref=False, **kw):
        self.gc_ref = gc_ref
        self.clock = FakeClock()
        self.ref_cluster, self.cluster = JaxCluster(), TorchCluster()
        if pow2:
            kw_ref = dict(kw, shape_policy=JAX_POW2)
            kw = dict(kw, shape_policy=POW2_POLICY)
        else:
            kw_ref = kw
        self.ref = JaxAutoscaler(self.ref_cluster, clock=self.clock, **kw_ref)
        self.a = Autoscaler(self.cluster, clock=self.clock, **kw)
        self.jobs: dict = {}

    def add_node(self, name, cpu_milli=10_000, mem=100_000, gpus=0,
                 domain=""):
        self.ref_cluster.add_node(name, cpu_milli=cpu_milli,
                                  memory_mega=mem, tpu_chips=gpus,
                                  ici_domain=domain)
        self.cluster.add_node(name, cpu_milli=cpu_milli, memory_mega=mem,
                              gpus=gpus, nvlink_domain=domain)

    def add_system_pod(self, name, node, cpu=1000, mem=100):
        for c in (self.ref_cluster, self.cluster):
            c.add_system_pod(name, node, cpu_request_milli=cpu,
                             memory_request_mega=mem)

    def remove_system_pod(self, name):
        for c in (self.ref_cluster, self.cluster):
            c.remove_system_pod(name)

    def submit(self, name, lo, hi, **kw):
        pair = (_job(jtypes, name, lo, hi, gpu_key=jtypes.RESOURCE_TPU, **kw),
                _job(ttypes, name, lo, hi, gpu_key=ttypes.RESOURCE_GPU, **kw))
        for c, s, j in zip((self.ref_cluster, self.cluster),
                           (self.ref, self.a), pair):
            c.create_resources(j)
            s.on_add(j)
        self.jobs[name] = pair
        return pair[1]

    def delete(self, name):
        for c, s, j in zip((self.ref_cluster, self.cluster),
                           (self.ref, self.a), self.jobs.pop(name)):
            c.delete_resources(j)
            s.on_del(j)

    def kill(self, name, index) -> bool:
        """Kill the ``index``-th live trainer pod (creation order, modulo
        the count) of job ``name`` on both clusters; False when it has
        none."""
        pods = [p.name for p in sorted(
            self.ref_cluster.list_pods(job_uid=self.jobs[name][0].full_name,
                                       role="trainer"), key=lambda p: p.seq)
            if p.phase in (JaxPodPhase.RUNNING, JaxPodPhase.PENDING)]
        if not pods:
            return False
        for c in (self.ref_cluster, self.cluster):
            c.kill_pod(pods[index % len(pods)])
        if self.gc_ref:
            with self.ref_cluster._lock:
                for p in list(self.ref_cluster._pods.values()):
                    if p.phase == JaxPodPhase.FAILED:
                        del self.ref_cluster._pods[p.name]
        return True

    def fail_next_updates(self, n):
        self.ref_cluster.fail_next_updates = n
        self.cluster.fail_next_updates = n

    def tick(self) -> dict:
        want, got = self.ref.tick(), self.a.tick()
        assert got == want
        assert self.a.suppressed_history == self.ref.suppressed_history
        return got

    def parallelism(self, name) -> int:
        ref, port = self.jobs[name]
        want = self.ref_cluster.get_trainer_parallelism(ref)
        got = self.cluster.get_trainer_parallelism(port)
        assert got == want
        assert (self.cluster.job_pods(port).running
                == self.ref_cluster.job_pods(ref).running)
        return got


# -- tests/test_autoscaler.py ----------------------------------------------------


def test_resize_cooldown_suppresses_thrash():
    tw = Twin(max_load_desired=1.0, resize_cooldown_s=30.0)
    tw.add_node("n0")
    job = tw.submit("example", 2, 10)
    assert tw.tick()  # first resize actuates immediately (no prior)
    grown = tw.parallelism("example")
    assert grown > 2
    for i in range(4):
        tw.add_system_pod(f"nginx-{i}", "n0")
    tw.clock.t += 5.0  # still inside the cooldown
    assert tw.tick() == {}  # suppressed, not actuated
    assert tw.parallelism("example") == grown
    assert tw.a.suppressed_history[-1] == {job.full_name: "cooldown"}
    tw.clock.t += 40.0  # cooldown lapsed: the shrink goes through
    target = tw.tick()
    assert target and target[job.full_name] < grown
    assert tw.parallelism("example") < grown


def test_min_resize_delta_ignores_one_card_wobble():
    tw = Twin(max_load_desired=1.0, min_resize_delta=4)
    tw.add_node("n0")
    job = tw.submit("example", 2, 10)
    assert tw.tick()
    assert tw.parallelism("example") == 10
    tw.add_system_pod("nginx", "n0")
    assert tw.tick() == {}
    assert tw.parallelism("example") == 10
    assert tw.a.suppressed_history[-1] == {job.full_name: "min_delta"}


def test_cooldown_stamp_cleared_on_job_deletion():
    tw = Twin(max_load_desired=1.0, resize_cooldown_s=300.0)
    tw.add_node("n0")
    tw.submit("example", 2, 10)
    assert tw.tick()
    tw.delete("example")
    tw.a.drain_events()
    tw.ref.drain_events()
    assert tw.a._last_resize == {} == tw.ref._last_resize
    tw.clock.t += 1.0
    tw.submit("example", 2, 10)
    assert tw.tick()  # the reborn job's first scale-up is NOT suppressed
    assert tw.parallelism("example") == 10


def test_hysteresis_defaults_off_preserve_pure_planner():
    tw = Twin(max_load_desired=1.0)
    tw.add_node("n0")
    tw.submit("example", 2, 10)
    for _ in range(3):
        tw.tick()
    assert tw.parallelism("example") == 10
    assert tw.a.suppressed_history == []


def test_single_job_scales_to_max():
    tw = Twin(max_load_desired=1.0)
    tw.add_node("n0")
    job = tw.submit("example", 2, 10)
    for _ in range(12):
        tw.tick()
    assert tw.parallelism("example") == 10
    assert tw.cluster.job_pods(job).running == 10


def test_max_load_desired_ceiling():
    tw = Twin(max_load_desired=0.8)
    tw.add_node("n0")
    tw.submit("example", 2, 10)
    for _ in range(12):
        tw.tick()
    assert tw.parallelism("example") == 8  # 80% of 10 CPUs


def test_second_job_forces_rebalance():
    tw = Twin(max_load_desired=1.0)
    tw.add_node("n0")
    tw.submit("example", 2, 10)
    for _ in range(10):
        tw.tick()
    assert tw.parallelism("example") == 10
    j2 = tw.submit("example1", 2, 8)
    for _ in range(20):
        tw.tick()
    p1, p2 = tw.parallelism("example"), tw.parallelism("example1")
    assert p1 + p2 <= 10
    assert p2 >= j2.spec.trainer.min_instance
    assert tw.cluster.job_pods(j2).pending == 0


def test_job_deletion_returns_capacity():
    tw = Twin()
    tw.add_node("n0", cpu_milli=4_000)
    tw.submit("one", 2, 4)
    tw.submit("two", 2, 4)
    for _ in range(10):
        tw.tick()
    assert tw.parallelism("one") + tw.parallelism("two") == 4
    tw.delete("two")
    for _ in range(10):
        tw.tick()
    assert tw.parallelism("one") == 4


def test_actuation_retries_on_conflict():
    tw = Twin()
    tw.add_node("n0")
    tw.submit("example", 2, 4)
    tw.fail_next_updates(2)  # two conflicts, then success
    for _ in range(6):
        tw.tick()
    assert tw.parallelism("example") == 4


def test_non_elastic_job_untouched():
    tw = Twin()
    tw.add_node("n0")
    tw.submit("fixed", 3, 3)
    for _ in range(5):
        tw.tick()
    assert tw.parallelism("fixed") == 3


def test_background_thread_smoke():
    c = TorchCluster()
    c.add_node("n0", cpu_milli=5_000, memory_mega=100_000)
    a = Autoscaler(c, loop_seconds=0.01)
    job = _job(ttypes, "example", 1, 5)
    c.create_resources(job)
    a.on_add(job)
    a.start()
    assert a.is_alive()
    deadline = time.time() + 5
    while time.time() < deadline and c.get_trainer_parallelism(job) < 5:
        time.sleep(0.02)
    a.stop()
    assert c.get_trainer_parallelism(job) == 5
    assert not a.is_alive()
    rendered = get_registry().render()
    assert "edl_autoscaler_jobs_tracked 1" in rendered
    assert 'edl_autoscaler_objective{mode="count"} 1' in rendered
    assert get_counters().get("autoscaler_plans") >= 1


# -- the port's own ---------------------------------------------------------------


def test_hint_sink_gets_the_shape_policys_layout():
    c = TorchCluster()
    c.add_node("n0", cpu_milli=4_000, memory_mega=100_000)
    a = Autoscaler(c, mesh_shape_for=lambda uid, n: ("shape", n))
    hints = []
    a.hint_sink = lambda uid, hint: hints.append((uid, hint))
    job = _job(ttypes, "j", 1, 4)
    c.create_resources(job)
    a.on_add(job)
    assert a.tick() == {"default/j": 4}
    assert hints == [("default/j", ("shape", 4))]
    assert a.tick_history[-1][1] == {"default/j": 4}


def test_a_replaced_kill_keeps_the_job_in_the_plans():
    """After a killed trainer is replaced, its Failed pod lingers: the
    JAX package's stability check (running == total) drops the job from
    every later plan, so competing load never shrinks it; the port counts
    live pods only, and shrinks it (ROADMAP.md queue 3)."""
    tw = Twin(max_load_desired=1.0)
    tw.add_node("n0", cpu_milli=4_000)
    tw.submit("j", 1, 4)
    ref_job, job = tw.jobs["j"]
    assert tw.tick() == {"default/j": 4}
    for c, j in ((tw.ref_cluster, ref_job), (tw.cluster, job)):
        c.kill_pod(c.list_pods(job_uid=j.full_name)[0].name)
    tw.add_system_pod("nginx", "n0", cpu=2000)
    assert tw.ref.tick() == {}
    assert tw.ref_cluster.get_trainer_parallelism(ref_job) == 4
    assert tw.a.tick() == {"default/j": 2}
    assert tw.cluster.get_trainer_parallelism(job) == 2


def test_a_killed_job_waiting_for_room_makes_the_others_fair_game():
    """Job b's one trainer is killed and its replacement waits for room,
    while job c, one trainer killed too, is partly pending: the JAX
    package's fully-pending check (pending == total) counts b's Failed pod,
    so no job is a candidate and b starves; the port counts live pods,
    takes b as fully pending, shrinks c, and b's replacement runs
    (ROADMAP.md queue 3)."""
    tw = Twin(max_load_desired=1.0)
    tw.add_node("n0", cpu_milli=4_000)
    tw.submit("b", 1, 1)
    tw.submit("c", 1, 4)
    assert tw.tick() == {"default/c": 3}
    tw.add_system_pod("nginx", "n0", cpu=2000)
    assert tw.kill("b", 0) and tw.kill("c", 0)
    (ref_b, b), (ref_c, c) = tw.jobs["b"], tw.jobs["c"]
    for cluster, jb, jc in ((tw.ref_cluster, ref_b, ref_c),
                            (tw.cluster, b, c)):
        assert astuple(cluster.job_pods(jb)) == (2, 0, 1, 0, 1)
        assert astuple(cluster.job_pods(jc)) == (4, 2, 1, 0, 1)
    assert tw.ref.tick() == {}
    assert tw.ref_cluster.get_trainer_parallelism(ref_c) == 3
    assert tw.ref_cluster.job_pods(ref_b).running == 0
    assert tw.a.tick() == {"default/c": 1}
    assert tw.cluster.get_trainer_parallelism(c) == 1
    assert tw.cluster.job_pods(b).running == 1


@pytest.mark.parametrize("scenario", ["replaced", "waiting"])
def test_kill_scenarios_tick_alike_once_failed_pods_are_gone(scenario):
    """The two tests above with the Failed pods removed from the
    reference's cluster: the two packages tick alike."""
    tw = Twin(max_load_desired=1.0, gc_ref=True)
    tw.add_node("n0", cpu_milli=4_000)
    if scenario == "replaced":
        tw.submit("j", 1, 4)
        assert tw.tick() == {"default/j": 4}
        assert tw.kill("j", 0)
        tw.add_system_pod("nginx", "n0", cpu=2000)
        assert tw.tick() == {"default/j": 2}
    else:
        tw.submit("b", 1, 1)
        tw.submit("c", 1, 4)
        assert tw.tick() == {"default/c": 3}
        tw.add_system_pod("nginx", "n0", cpu=2000)
        assert tw.kill("b", 0) and tw.kill("c", 0)
        assert tw.tick() == {"default/c": 1}
        assert tw.parallelism("b") == 1


# -- seeded random clusters ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_random_clusters_tick_alike(seed):
    """Random nodes (cards in NVLink domains), jobs (CPU or card, some
    multi-domain, some POW2), competing load appearing and going and jobs
    deleted, over 25 ticks: every tick's targets equal the reference's."""
    rng = np.random.default_rng(seed)
    tw = Twin(pow2=bool(rng.integers(2)),
              max_load_desired=float(rng.choice([0.8, 0.97, 1.0])),
              min_resize_delta=int(rng.integers(1, 3)))
    nodes = [f"n{i}" for i in range(int(rng.integers(1, 5)))]
    for name in nodes:
        tw.add_node(name, cpu_milli=int(rng.integers(2, 9)) * 1000,
                    gpus=int(rng.choice([0, 2, 4, 8])),
                    domain=f"d{int(rng.integers(2))}")
    live = []
    for i in range(int(rng.integers(1, 4))):
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 6))
        gpus = int(rng.choice([0, 1, 2]))
        tw.submit(f"job{i}", lo, hi, gpus=gpus, multi=bool(rng.integers(2)))
        live.append(f"job{i}")
    pods = 0
    for t in range(25):
        event = rng.integers(6)
        if event == 0:
            tw.add_system_pod(f"sys{pods}", str(rng.choice(nodes)),
                              cpu=int(rng.integers(1, 4)) * 500)
            pods += 1
        elif event == 1 and pods:
            tw.remove_system_pod(f"sys{int(rng.integers(pods))}")
        elif event == 2 and len(live) > 1 and t > 10:
            tw.delete(live.pop(int(rng.integers(len(live)))))
        tw.tick()
        for name in live:
            tw.parallelism(name)
    assert tw.a.plan_history == tw.ref.plan_history


@pytest.mark.parametrize("seed", range(12))
def test_random_clusters_with_kills_tick_alike_once_failed_pods_are_gone(seed):
    """As above, with trainer pods killed (at ticks 4 and 12 and at
    random) and their replacements placed by the job controller: the
    Failed pods linger on the port's cluster and are removed from the
    reference's, and every tick's targets are equal — the port differs
    from the JAX package only where a Failed pod lingers."""
    rng = np.random.default_rng(1000 + seed)
    tw = Twin(pow2=bool(rng.integers(2)), gc_ref=True,
              max_load_desired=float(rng.choice([0.8, 0.97, 1.0])),
              min_resize_delta=int(rng.integers(1, 3)))
    nodes = [f"n{i}" for i in range(int(rng.integers(1, 5)))]
    for name in nodes:
        tw.add_node(name, cpu_milli=int(rng.integers(2, 9)) * 1000,
                    gpus=int(rng.choice([0, 2, 4, 8])),
                    domain=f"d{int(rng.integers(2))}")
    live = []
    for i in range(int(rng.integers(1, 4))):
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 6))
        tw.submit(f"job{i}", lo, hi, gpus=int(rng.choice([0, 1, 2])),
                  multi=bool(rng.integers(2)))
        live.append(f"job{i}")
    pods = kills = 0
    for t in range(25):
        event = rng.integers(6)
        if event == 0:
            tw.add_system_pod(f"sys{pods}", str(rng.choice(nodes)),
                              cpu=int(rng.integers(1, 4)) * 500)
            pods += 1
        elif event == 1 and pods:
            tw.remove_system_pod(f"sys{int(rng.integers(pods))}")
        elif event == 2 and len(live) > 1 and t > 10:
            tw.delete(live.pop(int(rng.integers(len(live)))))
        if event == 3 or t in (4, 12):
            kills += tw.kill(str(rng.choice(live)), int(rng.integers(8)))
        tw.tick()
        for name in live:
            tw.parallelism(name)
    assert kills >= 1
    assert tw.a.plan_history == tw.ref.plan_history
