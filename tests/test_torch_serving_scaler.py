"""The port's SLO policy (edl_tpu_torch.scheduler.autoscaler.ServingScaler)
and the goodput curves it records (edl_tpu_torch.observability.goodput:
ScalingCurve, CurveStore, load_curve), beside the JAX package's.

tests/test_serving.py's policy scenarios run on both packages (``pkg``)
with the reference's assertions; a twin run feeds both scalers one seeded
sequence of 200 windowed stats on a fake clock and requires equal
actuations, plan histories, hint calls and ``goodput-curve/<job>`` bytes;
the scaler drives the port's fleet through a burst on the CPU; and
tests/test_goodput.py's curve scenarios run on the port's curve and store
(the failover one against the port's native HA pair)."""

from __future__ import annotations

import signal
import threading
import time
import types

import numpy as np
import pytest

from edl_tpu.api import types as jtypes
from edl_tpu.coord import PyCoordService as JaxCoord
from edl_tpu.runtime import serving as jserving
from edl_tpu.scheduler import autoscaler as jautoscaler
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.coord import PyCoordService as TorchCoord
from edl_tpu_torch.observability import goodput
from edl_tpu_torch.observability.goodput import CurveStore, ScalingCurve
from edl_tpu_torch.observability.metrics import MetricsRegistry
from edl_tpu_torch.runtime import serving as tserving
from edl_tpu_torch.scheduler import autoscaler as tautoscaler

PKGS = {
    "jax": types.SimpleNamespace(t=jtypes, serving=jserving,
                                 autoscaler=jautoscaler, Coord=JaxCoord),
    "torch": types.SimpleNamespace(t=ttypes,
                                   serving=tserving, autoscaler=tautoscaler,
                                   Coord=TorchCoord),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _job(pkg, lo=1, hi=8, slo=50.0, qps_target=0.0, batch=8):
    return pkg.t.ServingJob(name="svc", spec=pkg.t.ServingSpec(
        min_replicas=lo, max_replicas=hi, slo_p99_ms=slo,
        target_qps_per_replica=qps_target, max_batch_size=batch))


def _stats(pkg, p99=10.0, qps=10.0, depth=0, active=2, windowed=20):
    return pkg.serving.FleetStats(
        p50_ms=p99 / 3, p99_ms=p99, qps=qps, queue_depth=depth,
        replicas_ready=active, replicas_active=active,
        requests_windowed=windowed)


# ------------------------------------------------------- the SLO policy


def test_policy_grows_on_p99_breach_and_holds_inside_slo(pkg):
    sc = pkg.autoscaler.ServingScaler()
    job = _job(pkg, slo=50.0)
    assert sc.decide(job, _stats(pkg, p99=80.0, active=2), 2) == 3
    assert sc.decide(job, _stats(pkg, p99=30.0, depth=1, active=2),
                     2) is None


def test_policy_breach_with_deep_backlog_adds_proportionally(pkg):
    sc = pkg.autoscaler.ServingScaler()
    job = _job(pkg, slo=50.0, batch=8)
    # queue of 64 ≈ 8 batches over 2 replicas → grow by more than one
    assert sc.decide(job, _stats(pkg, p99=90.0, depth=64, active=2),
                     2) == 4


def test_policy_qps_target_scales_by_throughput(pkg):
    sc = pkg.autoscaler.ServingScaler()
    job = _job(pkg, slo=0.0, qps_target=30.0)
    assert sc.decide(job, _stats(pkg, p99=1.0, qps=100.0, active=2),
                     2) == 4
    # and caps at max_replicas
    job2 = _job(pkg, hi=3, slo=0.0, qps_target=10.0)
    assert sc.decide(job2, _stats(pkg, qps=500.0, active=2), 2) == 3


def test_policy_shrinks_only_with_headroom_and_empty_queue(pkg):
    sc = pkg.autoscaler.ServingScaler()
    job = _job(pkg, lo=1, slo=50.0)
    assert sc.decide(job, _stats(pkg, p99=5.0, depth=0, active=3), 3) == 2
    assert sc.decide(job, _stats(pkg, p99=5.0, depth=4, active=3),
                     3) is None
    assert sc.decide(job, _stats(pkg, p99=30.0, depth=0, active=3),
                     3) is None
    assert sc.decide(job, _stats(pkg, p99=5.0, depth=0, active=1),
                     1) is None
    # a cold window (no requests) decides nothing
    assert sc.decide(job, _stats(pkg, windowed=0), 3) is None


def test_tick_hints_before_actuating_and_respects_cooldown(pkg):
    clock = [100.0]
    calls: list[str] = []
    stats = {"default/svc": _stats(pkg, p99=80.0, active=2)}
    sc = pkg.autoscaler.ServingScaler(
        stats_for=lambda uid: stats[uid],
        actuate=lambda uid, n: calls.append(f"act:{n}"),
        clock=lambda: clock[0])
    sc.hint_sink = lambda uid, n: calls.append(f"hint:{n}")
    sc.on_add(_job(pkg))
    out = sc.tick()
    assert out == {"default/svc": 3}
    assert calls == ["hint:3", "act:3"]  # hint FIRST — the head start
    # breach persists inside the up-cooldown: suppressed, no thrash
    stats["default/svc"] = _stats(pkg, p99=80.0, active=3)
    assert sc.tick() == {}
    clock[0] += 10.0
    assert sc.tick() == {"default/svc": 4}
    # shrink waits out the longer down-cooldown
    stats["default/svc"] = _stats(pkg, p99=2.0, active=4)
    clock[0] += 10.0
    assert sc.tick() == {}
    clock[0] += sc.scale_down_cooldown_s
    assert sc.tick() == {"default/svc": 3}


def _twin_stats(seed: int, n: int):
    """n windowed observations: a p99 and qps random walk with breaches,
    idle windows and queue bursts, from ``seed``."""
    rng = np.random.default_rng(seed)
    out, p99, qps = [], 20.0, 40.0
    for _ in range(n):
        p99 = float(np.clip(p99 * rng.lognormal(0.0, 0.35), 0.5, 400.0))
        qps = float(np.clip(qps * rng.lognormal(0.0, 0.3), 0.0, 900.0))
        windowed = 0 if rng.random() < 0.08 else int(rng.integers(1, 500))
        depth = int(rng.integers(0, 80)) if rng.random() < 0.3 else 0
        out.append((round(p99, 3), round(qps, 2), depth, windowed))
    return out


def _twin_run(pkg, seq) -> dict:
    coord = pkg.Coord()
    clock = [1000.0]
    acts, hints = [], []
    active = [1]
    i = [0]

    def stats_for(uid):
        p99, qps, depth, windowed = seq[i[0]]
        return pkg.serving.FleetStats(
            p50_ms=p99 / 3, p99_ms=p99, qps=qps, queue_depth=depth,
            replicas_ready=active[0], replicas_active=active[0],
            requests_windowed=windowed)

    def actuate(uid, n):
        acts.append((i[0], uid, n))
        active[0] = n

    sc = pkg.autoscaler.ServingScaler(
        stats_for=stats_for, actuate=actuate, loop_seconds=1.0,
        scale_down_cooldown_s=6.0, scale_up_cooldown_s=2.0,
        coord_for=lambda job: coord, clock=lambda: clock[0])
    sc.hint_sink = lambda uid, n: hints.append((i[0], uid, n))
    sc.on_add(_job(pkg, lo=1, hi=6, slo=60.0, qps_target=50.0))
    ticks = []
    for k in range(len(seq)):
        i[0] = k
        ticks.append(sc.tick())
        clock[0] += 1.0
    return dict(acts=acts, hints=hints, ticks=ticks,
                plans=sc.plan_history,
                curve=coord.kv_get("goodput-curve/default/svc"))


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_scalers_plan_alike(seed):
    """The port's scaler and the reference's, fed the same 200 windowed
    observations on a fake clock, actuate, plan, hint and record the
    capacity curve alike, byte for byte."""
    seq = _twin_stats(seed, 200)
    got = {name: _twin_run(p, seq) for name, p in PKGS.items()}
    assert got["torch"]["acts"] == got["jax"]["acts"]
    assert got["torch"]["hints"] == got["jax"]["hints"]
    assert got["torch"]["ticks"] == got["jax"]["ticks"]
    assert got["torch"]["plans"] == got["jax"]["plans"]
    assert got["torch"]["curve"] == got["jax"]["curve"]
    # the run moves both ways and records a curve of several sizes
    dirs = {p["target"] > p["from"] for p in got["torch"]["plans"]}
    assert dirs == {True, False}
    assert len(ScalingCurve.from_json(
        got["torch"]["curve"].decode()).world_sizes()) >= 2


@pytest.mark.timeout_s(120)
def test_scaler_drives_a_live_fleet_through_a_burst():
    """Closed loop: Poisson burst → p99 breaches → the port's scaler
    hints and scales the port's fleet → burst absorbed with zero drops."""
    from edl_tpu_torch.models import mlp

    model = mlp.MLP([16, 32, 4], device="cpu", seed=0)
    fleet = tserving.ServingFleet(
        lambda p, b: mlp.apply(p, b[0]), model,
        example_row=(np.zeros((16,), np.float32),), job="default/svc",
        slo_p99_ms=60.0, max_queue_ms=0.5, drain_timeout_s=5.0,
        device="cpu")
    try:
        fleet.scale_to(1)
        job = _job(PKGS["torch"], lo=1, hi=3, slo=60.0)
        sc = tautoscaler.ServingScaler(
            stats_for=lambda uid: fleet.stats(window_s=2.0),
            actuate=lambda uid, n: fleet.scale_to(n))
        sc.hint_sink = lambda uid, n: fleet.hint(n)
        sc.on_add(job)
        traffic = tserving.PoissonTraffic(
            fleet, lambda i: (np.full((16,), i % 7, np.float32),),
            qps=400, seed=7)
        th = threading.Thread(target=lambda: traffic.run(2.0))
        th.start()
        grew = False
        for _ in range(40):
            time.sleep(0.05)
            if sc.tick():
                grew = True
        th.join()
        tally = traffic.await_all(timeout_s=30)
        assert tally["dropped"] == 0 and tally["errors"] == 0, tally
        assert grew or fleet.stats().p99_ms <= 60.0
    finally:
        fleet.stop()


def test_on_del_drops_the_target_gauge():
    from edl_tpu_torch.observability.metrics import get_registry

    sc = tautoscaler.ServingScaler(
        stats_for=lambda uid: _stats(PKGS["torch"], p99=80.0, active=1),
        actuate=lambda uid, n: None)
    job = _job(PKGS["torch"])
    sc.on_add(job)
    assert sc.tick() == {"default/svc": 2}

    def target_lines():
        return [ln for ln in get_registry().render().splitlines()
                if ln.startswith("edl_serving_target_replicas")
                and 'job="default/svc"' in ln]

    assert target_lines() == ['edl_serving_target_replicas'
                              '{job="default/svc"} 2']
    sc.on_del(job)
    assert target_lines() == []
    assert sc.jobs == {}


# ------------------------------------------------------ the goodput curves


def test_curve_aggregation_and_marginals():
    c = ScalingCurve("j")
    c.observe(2, 100.0, shape="dp2", mfu_pct=60.0)
    c.observe(2, 120.0, shape="dp2", mfu_pct=62.0)
    c.observe(4, 180.0, shape="dp4")
    c.observe(4, 150.0, shape="dp2xfsdp2")
    assert c.tokens_per_second(2) == 110.0
    assert c.tokens_per_second(4) == 180.0  # best shape rules
    assert c.marginal_tokens_per_second_per_chip(2) == pytest.approx(55.0)
    assert c.marginal_tokens_per_second_per_chip(4) == pytest.approx(35.0)
    assert c.nearest_world_size(3) == 2
    assert c.nearest_world_size(100) == 4
    assert c.nearest_world_size(1) == 2
    assert c.marginal_tokens_per_second_per_chip(7) is None  # unmeasured
    rt = ScalingCurve.from_json(c.to_json())
    assert rt.summary() == c.summary()
    assert rt.sample_count() == 4


def test_curve_json_matches_the_reference():
    from edl_tpu.observability.goodput import ScalingCurve as JaxCurve

    curves = [ScalingCurve("j"), JaxCurve("j")]
    for c in curves:
        c.observe(2, 100.0, shape="dp2", mfu_pct=60.0)
        c.observe(2, 120.0, shape="dp2", mfu_pct=62.0)
        for k in range(40):
            c.observe(3, 10.0 * k, shape="serving", max_samples=30)
    assert curves[0].to_json() == curves[1].to_json()


def test_curve_store_roundtrip_on_py_backend():
    svc = TorchCoord()
    reg = MetricsRegistry()
    store = CurveStore(svc, "ns/job", registry=reg)
    store.record(2, 1000.0, shape="dp2", mfu_pct=50.0)
    store.record(4, 1800.0, shape="dp4")
    # persisted under the documented key, loadable by a fresh reader
    assert svc.kv_get("goodput-curve/ns/job") is not None
    loaded = goodput.load_curve(svc, "ns/job")
    assert loaded.world_sizes() == [2, 4]
    assert loaded.tokens_per_second(4) == 1800.0
    # curve gauges refreshed on record
    text = reg.render()
    assert ('edl_goodput_curve_tokens_per_second'
            '{job="ns/job",world_size="4"} 1800') in text
    assert 'edl_goodput_marginal_tokens_per_second_per_chip' in text


@pytest.mark.timeout_s(120)
def test_curve_survives_primary_failover(tmp_path):
    """Curve samples recorded against the port's HA pair's primary are
    readable from the promoted standby after a SIGKILL."""
    from edl_tpu_torch.coord import CoordClient, native_available
    from edl_tpu_torch.coord import spawn_ha_pair

    if not native_available():
        pytest.skip("no native coordinator core")
    pr, sb = spawn_ha_pair(str(tmp_path), repl_lease_ms=1000)
    c = CoordClient("127.0.0.1", pr.port, timeout=2.0,
                    reconnect_window_s=12.0, promote_grace_s=0.2,
                    endpoints=[("127.0.0.1", sb.port)])
    try:
        store = CurveStore(c, "ha/job")
        store.record(2, 900.0, shape="dp2")
        store.record(4, 1500.0, shape="dp4")
        pr.process.send_signal(signal.SIGKILL)
        pr.process.wait(timeout=10)
        # the next read transparently fails over and promotes
        survived = goodput.load_curve(c, "ha/job")
        assert (c.host, c.port) == ("127.0.0.1", sb.port)
        assert survived is not None
        assert survived.world_sizes() == [2, 4]
        assert survived.tokens_per_second(4) == 1500.0
        # and the promoted primary accepts NEW samples onto the curve
        store.record(8, 2100.0, shape="dp8")
        assert goodput.load_curve(c, "ha/job").world_sizes() == [2, 4, 8]
    finally:
        c.close()
        pr.stop()
        sb.stop()
