"""The serving job on the port's control plane, beside the JAX package's:
the ``ServingJob`` gate (``set_defaults_and_validate_serving`` through
``validate_any``) on specs both gates accept or refuse alike; the
controller lifecycle of tests/test_serving.py (Running with its server
pods, the SLO scaler owning the job, a scale of the group, teardown), a
failed server pod replaced, and a deleted job's coordinator KV swept, each
on twin FakeClusters with equal phases and pod counts; ``serve_health``'s
scenarios of tests/test_observability.py; and ``AddrPublisher``'s TTL'd
value against the reference's."""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from edl_tpu.api import types as jtypes
from edl_tpu.api import validation as jvalidation
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.controller import updater as jupdater
from edl_tpu.controller.controller import Controller as JaxController
from edl_tpu.coord import PyCoordService as JaxCoord
from edl_tpu.coord import gc as jgc
from edl_tpu.observability import scrape as jscrape
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.api import validation as tvalidation
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.controller import updater as tupdater
from edl_tpu_torch.controller.controller import Controller as TorchController
from edl_tpu_torch.coord import PyCoordService as TorchCoord
from edl_tpu_torch.coord import gc as tgc
from edl_tpu_torch.observability import scrape as tscrape
from edl_tpu_torch.observability.health import serve_health

PKGS = {
    "jax": types.SimpleNamespace(
        t=jtypes, v=jvalidation, Cluster=JaxCluster, Controller=JaxController,
        updater=jupdater, Coord=JaxCoord, gc=jgc, scrape=jscrape),
    "torch": types.SimpleNamespace(
        t=ttypes, v=tvalidation, Cluster=TorchCluster,
        Controller=TorchController, updater=tupdater, Coord=TorchCoord,
        gc=tgc, scrape=tscrape),
}


def twin(fn):
    """``fn(pkg)`` on both packages, in threads (each scenario waits on its
    own controller's loops); returns {name: result}."""
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {n: ex.submit(fn, p) for n, p in PKGS.items()}
        return {n: f.result(timeout=60) for n, f in futs.items()}


# -- the gate -------------------------------------------------------------------


def _spec_cases():
    """(name, job fields, spec fields): accepted and refused specs."""
    return [
        ("defaults", {}, {}),
        ("elastic_with_slo", {}, dict(min_replicas=1, max_replicas=4)),
        ("elastic_on_qps_alone", {}, dict(min_replicas=1, max_replicas=3,
                                          slo_p99_ms=0.0,
                                          target_qps_per_replica=20.0)),
        ("static_no_signal", {}, dict(min_replicas=2, max_replicas=2,
                                      slo_p99_ms=0.0)),
        ("explicit_image_port", dict(image="img", port=9000), {}),
        ("no_name", dict(name=""), {}),
        ("zero_min", {}, dict(min_replicas=0)),
        ("max_below_min", {}, dict(min_replicas=3, max_replicas=2)),
        ("negative_slo", {}, dict(slo_p99_ms=-1.0)),
        ("negative_qps", {}, dict(target_qps_per_replica=-2.0)),
        ("elastic_no_signal", {}, dict(min_replicas=1, max_replicas=4,
                                       slo_p99_ms=0.0,
                                       target_qps_per_replica=0.0)),
        ("zero_batch", {}, dict(max_batch_size=0)),
        ("negative_queue", {}, dict(max_queue_ms=-0.5)),
        ("zero_drain_defaults", {}, dict(drain_timeout_s=0.0)),
        ("negative_reload_poll", {}, dict(reload_poll_s=-1.0)),
        ("negative_priority", {}, dict(priority=-1)),
        ("high_priority", {}, dict(priority=2)),
    ]


@pytest.mark.parametrize("name,job_kw,spec_kw", _spec_cases(),
                         ids=[c[0] for c in _spec_cases()])
def test_serving_gate_matches_the_reference(name, job_kw, spec_kw):
    def gate(p):
        job = p.t.ServingJob(**{"name": "svc", **job_kw},
                             spec=p.t.ServingSpec(**spec_kw))
        try:
            p.v.validate_any(job)
        except p.v.ValidationError as exc:
            return "refused", str(exc)
        s = job.spec
        return job.image, job.port, s.drain_timeout_s, s.min_replicas

    got = {n: gate(p) for n, p in PKGS.items()}
    assert got["torch"] == got["jax"], name


def test_a_serving_replica_claims_cards():
    job = ttypes.ServingJob(name="svc", spec=ttypes.ServingSpec(
        resources=ttypes.ResourceRequirements(
            limits={ttypes.RESOURCE_GPU: "2"})))
    assert job.gpus_per_replica() == 2 and job.need_gpu()
    assert job.replica_role == "server"
    assert job.replaceable_on_failure()
    assert ttypes.DEFAULT_SERVING_PORT == jtypes.DEFAULT_SERVING_PORT
    assert ttypes.SERVING_LABEL == jtypes.SERVING_LABEL


# -- the controller -------------------------------------------------------------


def _cluster(p, nodes=4):
    c = p.Cluster()
    for i in range(nodes):
        c.add_node(f"n{i}", cpu_milli=8000, memory_mega=32000)
    return c


def _serving_job(p, name="svc", lo=2, hi=6):
    return p.t.ServingJob(name=name, spec=p.t.ServingSpec(
        min_replicas=lo, max_replicas=hi, slo_p99_ms=50.0,
        resources=p.t.ResourceRequirements(requests={"cpu": "1"})))


def _server_pods(cluster, job_uid="default/svc"):
    return cluster.list_pods(job_uid=job_uid, role="server")


def _wait(pred, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_controller_lifecycle_on_fake_cluster():
    def scenario(p):
        cluster = _cluster(p)
        ctl = p.Controller(cluster, updater_convert_seconds=0.05,
                           updater_confirm_seconds=0.05)
        try:
            job = _serving_job(p)
            u = ctl.submit(job)
            _wait(lambda: u.phase == p.t.JobPhase.RUNNING)
            out = dict(phase=u.phase.value, pods=len(_server_pods(cluster)),
                       scaler="default/svc" in ctl.serving_scaler.jobs,
                       packer="default/svc" in ctl.autoscaler.jobs)
            rows = {s.resource_type: s for s in
                    p.updater.compute_replica_statuses(cluster,
                                                       "default/svc")}
            out.update(server_state=rows["SERVER"].state.value,
                       server_rows=len(rows["SERVER"].resource_states))
            # the replica dial scales the group
            cluster.update_trainer_parallelism(job, 4)
            _wait(lambda: len(_server_pods(cluster)) == 4)
            out["scaled_pods"] = len(_server_pods(cluster))
            ctl.delete(job)
            out["after_delete"] = len(cluster.list_pods(
                job_uid="default/svc"))
            out["tracked_after_delete"] = ("default/svc"
                                           in ctl.serving_scaler.jobs)
            return out
        finally:
            ctl.stop()

    got = twin(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"] == dict(
        phase="Running", pods=2, scaler=True, packer=False,
        server_state="Running", server_rows=2, scaled_pods=4,
        after_delete=0, tracked_after_delete=False)


def test_failed_server_pod_is_replaced():
    """ReplicaSet semantics: a crashed server is replaced, the job never
    statically fails (replaceable_on_failure)."""
    def scenario(p):
        cluster = _cluster(p)
        job = _serving_job(p, lo=2, hi=2)
        job.image = "img"
        cluster.create_resources(job)
        pods = _server_pods(cluster)
        before = len(pods)
        cluster.kill_pod(pods[0].name)
        live = [q for q in _server_pods(cluster)
                if q.phase.value == "Running"]
        return before, len(live), len(_server_pods(cluster))

    got = twin(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (2, 2)  # replacement spawned


def test_job_deletion_sweeps_job_scoped_coordinator_kv():
    """goodput-curve/vw-map/vw-cursor/serving-gen and the other job-scoped
    keys outlive every reform and failover but NOT the job — the
    controller's delete sweeps exactly the deleted job's keys."""
    def scenario(p):
        coord = p.Coord()
        prefixes = p.gc.JOB_KV_PREFIXES
        for prefix in prefixes:
            coord.kv_set(f"{prefix}default/svc", b"x")
            coord.kv_set(f"{prefix}default/other", b"y")
        # a survivor sharing a NAME PREFIX with the victim must survive
        coord.kv_set("vw-map/default/svc2", b"z")
        cluster = _cluster(p)
        ctl = p.Controller(cluster, updater_convert_seconds=0.05,
                           updater_confirm_seconds=0.05,
                           coord_for=lambda job: coord)
        try:
            job = _serving_job(p)
            ctl.submit(job)
            ctl.delete(job)
        finally:
            ctl.stop()
        return dict(
            prefixes=list(prefixes),
            victim=[coord.kv_get(f"{pf}default/svc") for pf in prefixes],
            other=[coord.kv_get(f"{pf}default/other") for pf in prefixes],
            svc2=coord.kv_get("vw-map/default/svc2"),
            pods=len(cluster.list_pods(job_uid="default/svc")))

    got = twin(scenario)
    assert got["torch"] == got["jax"]
    out = got["torch"]
    assert out["victim"] == [None] * len(out["prefixes"])
    assert out["other"] == [b"y"] * len(out["prefixes"])
    assert out["svc2"] == b"z" and out["pods"] == 0


def test_controller_feeds_the_scaler_from_the_fleet_seam():
    """``serving_stats_for`` reaches the controller's ServingScaler, whose
    plans dial the job's server group on the cluster."""
    from edl_tpu_torch.runtime.serving import FleetStats

    cluster = _cluster(PKGS["torch"])
    stats = FleetStats(p99_ms=200.0, qps=50.0, replicas_active=2,
                       replicas_ready=2, requests_windowed=100)
    ctl = TorchController(cluster, updater_convert_seconds=0.05,
                          updater_confirm_seconds=0.05,
                          serving_stats_for=lambda uid: stats,
                          serving_loop_seconds=0.05)
    hints = []
    ctl.serving_scaler.hint_sink = lambda uid, n: hints.append(n)
    ctl.start()
    try:
        job = _serving_job(PKGS["torch"], lo=2, hi=3)
        ctl.submit(job)
        assert _wait(lambda: len(_server_pods(cluster)) == 3)
        assert hints and hints[0] == 3
        assert ctl.serving_scaler.plan_history[0]["target"] == 3
    finally:
        ctl.stop()


# -- serve_health --------------------------------------------------------------


def _get(port, path="/healthz"):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_health_ok_then_unhealthy_then_shutdown():
    state = {"alive": True}
    srv = serve_health(0, {"autoscaler": lambda: state["alive"]},
                       host="127.0.0.1")
    try:
        port = srv.server_address[1]
        code, body = _get(port)
        doc = json.loads(body)
        assert code == 200
        assert doc["status"] == "ok" and doc["autoscaler"] is True
        # per-check detail: latency + timeout verdict in the body
        assert doc["checks"]["autoscaler"]["ok"] is True
        assert doc["checks"]["autoscaler"]["timed_out"] is False
        assert doc["checks"]["autoscaler"]["latency_ms"] >= 0
        state["alive"] = False  # the thread died
        code, body = _get(port)
        assert code == 503 and json.loads(body)["autoscaler"] is False
        # a check that RAISES counts as dead, not as a 500
        srv2 = serve_health(0, {"boom": lambda: 1 / 0}, host="127.0.0.1")
        try:
            assert _get(srv2.server_address[1])[0] == 503
        finally:
            srv2.shutdown()
        # /metrics serves the process registry in the exposition format
        code, body = _get(port, "/metrics")
        assert code == 200 and body.decode().endswith("\n")
        assert _get(port, "/nope")[0] == 404
    finally:
        srv.shutdown()


def test_wedged_check_times_out_instead_of_blocking_probe():
    release = threading.Event()

    def wedged() -> bool:
        release.wait(30)  # a check stuck in a lock/collective
        return True

    srv = serve_health(0, {"wedged": wedged, "fine": lambda: True},
                       host="127.0.0.1", check_timeout_s=0.3)
    try:
        port = srv.server_address[1]
        t0 = time.monotonic()
        code, body = _get(port)
        assert code == 503
        doc = json.loads(body)
        assert time.monotonic() - t0 < 5  # probe was never blocked
        assert doc["wedged"] is False
        assert doc["checks"]["wedged"]["timed_out"] is True
        assert doc["checks"]["wedged"]["latency_ms"] >= 300
        assert doc["fine"] is True
        assert doc["checks"]["fine"]["timed_out"] is False
        # a SECOND probe while the check is still wedged must not stack
        # another thread: it reports the check stuck instantly
        before_threads = threading.active_count()
        code, body = _get(port)
        doc2 = json.loads(body)
        assert doc2["checks"]["wedged"]["stuck"] is True
        assert doc2["checks"]["wedged"]["timed_out"] is True
        assert doc2["fine"] is True
        assert threading.active_count() <= before_threads + 2
    finally:
        release.set()
        srv.shutdown()


def test_concurrent_probes_share_inflight_check_no_false_503():
    def slowish() -> bool:
        time.sleep(0.15)  # well inside the timeout
        return True

    srv = serve_health(0, {"slowish": slowish}, host="127.0.0.1",
                       check_timeout_s=2.0)
    try:
        port = srv.server_address[1]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            results = list(ex.map(lambda _: _get(port), range(4)))
        for code, body in results:
            doc = json.loads(body)
            assert code == 200, doc
            assert doc["slowish"] is True
            assert "stuck" not in doc["checks"]["slowish"]
    finally:
        srv.shutdown()


# -- address publication --------------------------------------------------------


def test_addr_publisher_writes_the_reference_value(monkeypatch):
    """Both packages' publishers write the same TTL'd value (the address
    and its expiry stamp on one frozen clock) and delete the key on
    stop; both parsers read it back alike."""
    values = {}
    for name, p in PKGS.items():
        monkeypatch.setattr(p.scrape, "time",
                            types.SimpleNamespace(time=lambda: 1.7e9))
        kv = p.Coord()
        pub = p.scrape.AddrPublisher(
            kv, f"{p.scrape.SUPERVISOR_METRICS_ADDR_PREFIX}w0",
            "10.0.0.5:9100", ttl_s=30.0)
        pub.start()
        assert _wait(lambda: kv.kv_get("metrics-addr-w0") is not None, 5)
        values[name] = kv.kv_get("metrics-addr-w0")
        key = p.scrape.publish_serving_metrics_addr(
            kv, "ns/svc", "r0", "10.0.0.6:8080", ttl_s=12.5)
        values[name + "-serving"] = (key, kv.kv_get(key))
        pub.stop()
        assert kv.kv_get("metrics-addr-w0") is None
        values[name + "-parsed"] = [p.scrape.parse_addr_value(v) for v in (
            values[name], b"junk", b"1.2.3.4:5 1.0", b"1.2.3.4:5")]
    assert values["torch"] == values["jax"] == b"10.0.0.5:9100 1700000030.000"
    assert values["torch-serving"] == values["jax-serving"]
    assert values["torch-parsed"] == values["jax-parsed"]
    assert tscrape.publish_host("10.1.1.1") == jscrape.publish_host(
        "10.1.1.1") == "10.1.1.1"
    assert tscrape.DEFAULT_ADDR_TTL_S == jscrape.DEFAULT_ADDR_TTL_S
    assert (tscrape.SERVING_METRICS_ADDR_PREFIX
            == jscrape.SERVING_METRICS_ADDR_PREFIX)
