"""The port's controller, updater and validation (edl_tpu_torch.controller,
edl_tpu_torch.api.validation): tests/test_controller.py's training-job
scenarios run on the JAX package and on the port alike (``pkg``), each with
the reference's assertions, the two held equal where a scenario is
deterministic.  The serving job's scenarios are in
tests/test_torch_serving_control.py; train+serve arbitration (an elastic
card-holding ``ServingJob`` registered with both loops under the goodput
objective, tests/test_sched_goodput.py's two controller scenarios) and the
scraper the controller owns are held here on both packages; a replica
wider than one card still raises, naming its ROADMAP item.

All timers are shrunk so the actor loops run at test speed; phases are
polled with deadlines rather than sleeps.
"""

import time
import types

import pytest

from edl_tpu.api import types as jtypes
from edl_tpu.api import validation as jvalidation
from edl_tpu.cluster import base as jbase
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.controller.controller import Controller as JaxController
from edl_tpu.controller.updater import TrainingJobUpdater as JaxUpdater
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.api import validation as tvalidation
from edl_tpu_torch.cluster import base as tbase
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.controller import Controller as TorchController
from edl_tpu_torch.controller import TrainingJobUpdater as TorchUpdater
from edl_tpu.observability import metrics as jmetrics
from edl_tpu.observability import scrape as jscrape
from edl_tpu_torch.observability import metrics as tmetrics
from edl_tpu_torch.observability import scrape as tscrape

PKGS = {
    "jax": types.SimpleNamespace(
        t=jtypes, v=jvalidation, base=jbase, Cluster=JaxCluster,
        Controller=JaxController, Updater=JaxUpdater),
    "torch": types.SimpleNamespace(
        t=ttypes, v=tvalidation, base=tbase, Cluster=TorchCluster,
        Controller=TorchController, Updater=TorchUpdater),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def mk_job(p, name="j", lo=2, hi=4, ft=True, cpu="1", mem="100M"):
    t = p.t
    return t.TrainingJob(
        name=name,
        spec=t.TrainingJobSpec(
            fault_tolerant=ft,
            trainer=t.TrainerSpec(
                entrypoint="python train.py", workspace="/workspace",
                min_instance=lo, max_instance=hi,
                resources=t.ResourceRequirements(
                    requests={"cpu": cpu, "memory": mem},
                    limits={"cpu": cpu, "memory": mem},
                ),
            ),
        ),
    )


def wait_phase(get_phase, want, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if get_phase() == want:
            return True
        time.sleep(0.01)
    return get_phase() == want


def fast_controller(p, cluster, **kw):
    kw.setdefault("autoscaler_loop_seconds", 0.02)
    kw.setdefault("updater_convert_seconds", 0.02)
    kw.setdefault("updater_confirm_seconds", 0.01)
    return p.Controller(cluster, **kw)


def updater(p, job, c, **kw):
    return p.Updater(job, c, convert_seconds=0.02, confirm_seconds=0.01,
                     **kw)


# -- validation ---------------------------------------------------------------


def test_defaults_and_validation_match_the_reference():
    """Defaults filled alike; each bad spec refused alike, with the same
    message."""
    def gate(p, **kw):
        job = mk_job(p, **kw)
        try:
            p.v.set_defaults_and_validate(job)
        except p.v.ValidationError as exc:
            return "refused", str(exc)
        s = job.spec
        return s.port, s.ports_num, s.ports_num_for_sparse, s.image, s.passes

    for kw in ({}, dict(lo=0), dict(lo=3, hi=2), dict(lo=1, hi=4, ft=False),
               dict(name="")):
        assert gate(PKGS["torch"], **kw) == gate(PKGS["jax"], **kw), kw
    bad = mk_job(PKGS["torch"])
    bad.spec.trainer.priority = -1
    with pytest.raises(tvalidation.ValidationError, match="priority"):
        tvalidation.set_defaults_and_validate(bad)


def test_a_serving_job_raises_naming_its_item():
    """A serving job passes the gate and every controller verb; its whole
    plane is ported: a fleet of replicas wider than one card (item 12,
    done) builds, each replica taking two devices
    (tests/test_torch_serving_wide.py serves through one).  The async
    front door is ported: serve_main raises only for a front door it does
    not know, before touching the lineage."""
    import numpy as np

    from edl_tpu_torch.models import mlp
    from edl_tpu_torch.runtime.serving import ServingFleet, serve_main

    serving = ttypes.ServingJob(name="s")
    tvalidation.validate_any(serving)
    assert serving.port == ttypes.DEFAULT_SERVING_PORT
    c = TorchCluster()
    ctl = TorchController(c)
    try:
        ctl.submit(serving)
        ctl.modify(serving)
        ctl.delete(serving)
    finally:
        ctl.stop()
    wide = ServingFleet(lambda p, b: mlp.apply(p, b[0]),
                        mlp.MLP([4, 2], device="cpu"),
                        example_row=(np.zeros(4, np.float32),),
                        chips_per_replica=2, device="cpu")
    assert wide.replicas_active() == 0
    assert [d.type for d in wide._slot_devices(0)] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="'async' and 'legacy'"):
        serve_main({"EDL_SERVING_MODEL_DIR": "/nonexistent",
                    "EDL_SERVING_FRONTDOOR": "item-8"}, device="cpu")


# -- updater actor -----------------------------------------------------------


def test_updater_reaches_running(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    u = updater(pkg, mk_job(pkg), c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    u.stop()


def test_updater_invalid_spec_fails_fast(pkg):
    c = pkg.Cluster()
    job = mk_job(pkg, lo=3, hi=2)  # max < min
    u = updater(pkg, job, c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.FAILED)
    assert "max_instance" in job.status.reason


def test_updater_create_timeout_fails_and_releases(pkg):
    c = pkg.Cluster()  # no nodes: pods never run
    job = mk_job(pkg)
    u = updater(pkg, job, c, create_timeout=0.1)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.FAILED)
    assert c.job_pods(job).total == 0  # resources released


def test_updater_non_ft_fails_on_any_trainer_failure(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    job = mk_job(pkg, ft=False, lo=2, hi=2)
    u = updater(pkg, job, c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    victim = c.list_pods(job_uid=job.full_name, role="trainer")[0]
    # fail the pod and prevent the fake job-controller from replacing it
    # before convert() observes the failure
    with c._lock:
        c._pods[victim.name].phase = pkg.base.PodPhase.FAILED
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.FAILED)


def test_updater_ft_survives_single_failure(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    job = mk_job(pkg, ft=True, lo=2, hi=4)
    u = updater(pkg, job, c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    victim = c.list_pods(job_uid=job.full_name, role="trainer")[0]
    c.kill_pod(victim.name)  # replacement spawns via reconcile
    time.sleep(0.2)
    assert u.phase == pkg.t.JobPhase.RUNNING
    u.stop()


def test_updater_success_when_pod_succeeds(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    job = mk_job(pkg, lo=1, hi=1, ft=False)
    u = updater(pkg, job, c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    pod = c.list_pods(job_uid=job.full_name, role="trainer")[0]
    c.kill_pod(pod.name, pkg.base.PodPhase.SUCCEEDED)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.SUCCEEDED)


def test_updater_populates_replica_statuses(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    job = mk_job(pkg)
    u = updater(pkg, job, c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    deadline = time.time() + 5
    while time.time() < deadline and not job.status.replica_statuses:
        time.sleep(0.01)
    by_type = {s.resource_type: s for s in job.status.replica_statuses}
    assert set(by_type) == {"MASTER", "PSERVER", "TRAINER"}
    tr = by_type["TRAINER"]
    assert tr.state == pkg.t.ResourceState.RUNNING
    assert len(tr.resource_states) >= job.spec.trainer.min_instance
    assert all(s == pkg.t.ResourceState.RUNNING
               for s in tr.resource_states.values())
    u.stop()


def test_replica_statuses_match_the_reference():
    """``compute_replica_statuses`` over one pod script on both packages."""
    from edl_tpu.controller.updater import compute_replica_statuses as jrs
    from edl_tpu_torch.controller.updater import (
        compute_replica_statuses as trs)

    def statuses(p, fn):
        c = p.Cluster()
        c.add_node("n0", cpu_milli=3000, memory_mega=8000)
        job = mk_job(p, lo=4, hi=4)
        c.create_resources(job)
        c.kill_pod(c.list_pods(job_uid=job.full_name)[0].name)
        return [(s.resource_type, s.state.value,
                 sorted(v.value for v in s.resource_states.values()))
                for s in fn(c, job.full_name)]

    assert statuses(PKGS["torch"], trs) == statuses(PKGS["jax"], jrs)


def test_updater_surfaces_scaling_phase(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=2500, memory_mega=16000)  # room for 2
    job = mk_job(pkg, lo=2, hi=6)
    u = updater(pkg, job, c)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    c.update_trainer_parallelism(job, 4)
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.SCALING)
    assert "2 -> 4" in job.status.reason
    c.add_node("n1", cpu_milli=2500, memory_mega=16000)
    c.reconcile()  # capacity arrives; the kubelet places the pods
    assert wait_phase(lambda: u.phase, pkg.t.JobPhase.RUNNING)
    u.stop()


# -- controller --------------------------------------------------------------


def test_controller_end_to_end_scales_job(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=10_000, memory_mega=100_000)
    ctl = fast_controller(pkg, c, max_load_desired=1.0)
    ctl.start()
    job = mk_job(pkg, lo=2, hi=8)
    ctl.submit(job)
    assert wait_phase(lambda: ctl.phase(job), pkg.t.JobPhase.RUNNING)
    deadline = time.time() + 5
    while time.time() < deadline and c.get_trainer_parallelism(job) < 8:
        time.sleep(0.02)
    assert c.get_trainer_parallelism(job) == 8
    ctl.stop()


def test_controller_rejects_invalid_and_duplicate(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    ctl = fast_controller(pkg, c)
    with pytest.raises(pkg.v.ValidationError):
        ctl.submit(mk_job(pkg, lo=1, hi=4, ft=False))  # elastic needs FT
    job = mk_job(pkg)
    ctl.submit(job)
    with pytest.raises(pkg.v.ValidationError):
        ctl.submit(mk_job(pkg))  # duplicate name
    assert [j.name for j in ctl.jobs()] == ["j"]
    ctl.stop()


def test_controller_delete_tears_down(pkg):
    c = pkg.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    ctl = fast_controller(pkg, c)
    ctl.start()
    job = mk_job(pkg)
    ctl.submit(job)
    assert wait_phase(lambda: ctl.phase(job), pkg.t.JobPhase.RUNNING)
    ctl.delete(job)
    assert c.job_pods(job).total == 0
    assert ctl.get_updater(job) is None
    assert ctl.phase(job) == pkg.t.JobPhase.NONE
    ctl.stop()


def test_controller_delete_sweeps_the_jobs_coordinator_keys():
    """``coord_for``: deleting a job sweeps its job-scoped KV through the
    port's coord/gc.py; another job's keys stay."""
    from edl_tpu_torch.coord import PyCoordService

    coord = PyCoordService()
    c = TorchCluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    ctl = fast_controller(PKGS["torch"], c, coord_for=lambda job: coord)
    job = mk_job(PKGS["torch"])
    ctl.submit(job)
    for key in ("vw-map/default/j", "vw-cursor/default/j/0",
                "goodput-curve/default/j", "vw-map/default/other"):
        coord.kv_set(key, b"x")
    ctl.delete(job)
    assert coord.kv_keys("") == ["vw-map/default/other"]
    ctl.stop()


def test_modify_refuses_to_flip_multi_domain():
    p = PKGS["torch"]
    c = p.Cluster()
    c.add_node("n0", cpu_milli=8000, memory_mega=8000)
    ctl = fast_controller(p, c)
    job = mk_job(p)
    ctl.submit(job)
    flipped = mk_job(p)
    flipped.spec.trainer.allow_multi_domain = True
    with pytest.raises(tvalidation.ValidationError, match="immutable"):
        ctl.modify(flipped)
    grown = mk_job(p, hi=6)
    ctl.modify(grown)
    assert ctl.get_updater(job).job.spec.trainer.max_instance == 6
    with pytest.raises(KeyError):
        ctl.modify(mk_job(p, name="nope"))
    ctl.stop()


# -- train+serve arbitration and the scrape plane ---------------------------------


def serving_job(p, lo=1, hi=4):
    t = p.t
    key = jtypes.RESOURCE_TPU if p.t is jtypes else ttypes.RESOURCE_GPU
    return t.ServingJob(name="fleet", spec=t.ServingSpec(
        min_replicas=lo, max_replicas=hi, slo_p99_ms=50.0,
        resources=t.ResourceRequirements(
            requests={"cpu": "1", "memory": "1Mi"}, limits={key: "1"})))


def card_cluster(p):
    c = p.Cluster()
    if p.t is jtypes:
        c.add_node("n0", cpu_milli=64_000, memory_mega=64_000, tpu_chips=8)
    else:
        c.add_node("n0", cpu_milli=64_000, memory_mega=64_000, gpus=8)
    return c


def test_controller_arbitrates_elastic_card_serving_fleets(pkg):
    """An elastic card-holding ServingJob submitted under the goodput
    objective registers with both loops (the SLO policy observes, the
    goodput planner owns the dial) and leaves both on delete; without a
    curve source, or with the objective off, the SLO policy alone owns
    it."""
    seen = []
    for kw in (dict(goodput_curves=lambda uid: None), {},
               dict(goodput_curves=lambda uid: None,
                    goodput_objective=False)):
        ctl = pkg.Controller(card_cluster(pkg), **kw)
        job = serving_job(pkg)
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
    assert seen == [(True, True), (False, False), (False, False),
                    (False, False), (False, False), (False, False)]


def test_controller_modify_reconciles_arbitration_both_ways(pkg):
    """A spec change can flip arbitration eligibility: exactly one loop
    owns the replica dial afterwards, in either direction."""
    ctl = pkg.Controller(card_cluster(pkg), goodput_curves=lambda uid: None)
    job = serving_job(pkg, lo=2, hi=2)
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


def test_controller_owns_the_scraper_and_feeds_the_slo_policy(pkg):
    """A scraper handed to the controller is rolled up by a FleetView that
    feeds the serving scaler (unless a stats hook is given explicitly),
    started with the controller's loops and stopped with them."""
    scrape = jscrape if pkg.t is jtypes else tscrape
    metrics = jmetrics if pkg.t is jtypes else tmetrics
    reg = metrics.MetricsRegistry()
    reg.gauge("serving_replicas_active").set(3, job="default/fleet")
    scraper = scrape.MetricsScraper(fetch=lambda t: reg.render(),
                                    interval_s=0.02,
                                    registry=metrics.MetricsRegistry())
    scraper.add_target(scrape.ScrapeTarget(name="r0", addr="r0:0"))
    ctl = fast_controller(pkg, card_cluster(pkg), scraper=scraper,
                          scrape_window_s=5.0)
    assert ctl.fleet_view is not None and ctl.fleet_view.window_s == 5.0
    assert ctl.serving_scaler.stats_for == ctl.fleet_view.stats_for
    ctl.start()
    try:
        deadline = time.monotonic() + 5
        while scraper.sweeps < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert scraper.is_alive() and scraper.sweeps >= 2
        assert ctl.serving_scaler.stats_for(
            "default/fleet").replicas_active == 3
    finally:
        ctl.stop()
    assert not scraper.is_alive()

    def hook(uid):
        return None

    explicit = pkg.Controller(card_cluster(pkg), scraper=scraper,
                              serving_stats_for=hook)
    assert explicit.serving_scaler.stats_for is hook
    explicit.stop()
