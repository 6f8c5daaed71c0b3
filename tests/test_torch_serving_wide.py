"""The port's serving replicas wider than one device
(``ServingFleet(chips_per_replica=2)``: each replica two rank processes
forked from ``elastic.rank_processes``, a gloo CPU world of their own, behind
``serving.RankGroupServer``) on the CPU, on the MLP [16, 32, 4] holding the
JAX init (tests/torch_world.py's ``mlp_rows`` is the forward the ranks
import):

* answers within 1e-5 of the JAX package's ``ServingFleet(
  chips_per_replica=2)`` on the virtual CPU mesh, for the same rows, before
  and after a rolling reload, and the slices both fleets cut;
* a scale-up after a reload serves the new generation on every rank (the
  port's repair of the reference's ``scale_to``, ROADMAP.md queue 3);
* a killed rank ends its replica: its requests fail typed
  (``ReplicaRankDied``, a ``RequestDropped``) within 10 s, its other rank
  is killed, the fleet replaces it, and nothing else is lost;
* the five serving fault kinds strike a wide replica behind a front door
  (``BatchApp`` over a ``RankGroupServer``) as they strike a thread
  replica: zero wrong payloads, each kind injected and recovered once."""

from __future__ import annotations

import os
import random
import signal
import threading
import time

import jax
import numpy as np
import pytest

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.runtime import serving as jserving
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.faults import (
    SERVING_KINDS,
    ChaosProxy,
    FaultContext,
    FaultPlan,
    FaultPlanEngine,
    GrayReplica,
)
from edl_tpu_torch.runtime.frontdoor import (
    SERVING_ADDR_PREFIX,
    BatchApp,
    FrontDoor,
    build_predict_request,
    format_serving_addr,
)
from edl_tpu_torch.runtime.lb import BRK_CLOSED, ServingLB
from edl_tpu_torch.runtime.serving import (
    PoissonTraffic,
    RankGroupServer,
    ReplicaRankDied,
    RequestDropped,
    ServingFleet,
)
from tests.torch_wire import (
    PartitionableKV,
    connect,
    read_responses,
    spin_replica,
    wait_routable,
)

pytestmark = pytest.mark.timeout_s(180)

ATOL = 1e-5
SIZES = [16, 32, 4]
PARAMS = jmlp.init(jax.random.key(0), SIZES)
CPU4 = ["cpu"] * 4


def tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def module(params=PARAMS) -> mlp.MLP:
    return interop.params_from_numpy(mlp.MLP(SIZES, device="cpu"),
                                     tree(params))


def shifted(params, fn):
    return jax.tree.map(fn, params)


def make_fleet(job: str, params=PARAMS, **kw) -> ServingFleet:
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_queue_ms", 1.0)
    kw.setdefault("drain_timeout_s", 10.0)
    return ServingFleet(tw.mlp_rows, module(params),
                        example_row=(np.zeros((16,), np.float32),),
                        job=job, device="cpu", chips_per_replica=2,
                        devices=CPU4, **kw)


def rows(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 16)).astype(
        np.float32)


def answers(fleet, xs: np.ndarray) -> np.ndarray:
    reqs = [fleet.submit((x,)) for x in xs]
    return np.stack([np.asarray(r.wait(60)) for r in reqs])


def close(got, want) -> bool:
    return np.allclose(np.asarray(got), want, atol=ATOL, rtol=ATOL)


def test_wide_fleet_matches_the_reference_fleet_through_a_reload():
    ref = jserving.ServingFleet(
        lambda p, b: jmlp.apply(p, b[0]), PARAMS,
        example_row=(np.zeros((16,), np.float32),), job="t/wide-ref",
        max_batch_size=8, max_queue_ms=1.0, chips_per_replica=2,
        devices=jax.devices()[:4])
    fl = make_fleet("t/wide-parity")
    xs = rows(16)
    p2 = shifted(PARAMS, lambda a: a * 2.0 - 0.5)
    try:
        assert fl._max_replicas() == ref._max_replicas() == 2
        for slot in (0, 1):
            assert len(fl._slot_devices(slot)) \
                == len(ref._slot_devices(slot)) == 2
        ref.scale_to(1)
        fl.scale_to(1)
        wide = fl.replicas()[0].server
        assert isinstance(wide, RankGroupServer) and wide.world_size == 2
        before = answers(fl, xs)
        assert close(before, answers(ref, xs))
        assert close(before, np.asarray(jmlp.apply(PARAMS, xs)))
        assert ref.rolling_reload(p2, 2) == fl.rolling_reload(module(p2),
                                                              2) == 1
        after = answers(fl, xs)
        assert close(after, answers(ref, xs))
        assert close(after, np.asarray(jmlp.apply(p2, xs)))
        # every rank loaded generation 2 and served its half of each batch
        counts = wide.rank_counts()
        assert len(counts) == 2
        assert counts[0]["forwards"] == counts[1]["forwards"] >= 3
        host = wide.params_host()
        for name, p in host.named_parameters():
            assert np.array_equal(p.detach().numpy(), np.asarray(p2[name]))
    finally:
        fl.stop()
        ref.stop()
    assert all(not p.is_alive() for p in wide.procs)
    assert wide.final_counts is not None


@pytest.mark.parametrize("source", ["rolling_reload", "lineage"])
def test_scale_up_after_a_reload_serves_the_new_generation(source,
                                                           tmp_path):
    """A standby hinted on the boot weights, a reload onto generation 2,
    then the standby adopted under traffic: every answer, from either
    replica, is generation 2's (the reference's scale_to routes the
    standby before it swaps; queue 3)."""
    fl = make_fleet(f"t/wide-scaleup-{source}")
    p2 = shifted(PARAMS, lambda a: a + 1.0)
    try:
        fl.scale_to(1)
        assert fl.hint(2) == 1
        if source == "lineage":
            ck = ElasticCheckpointer(tmp_path / "lineage", max_to_keep=3)
            ck.save(2, {"params": module(p2)})
            try:
                assert fl.reload_from_lineage(ck) == 2
            finally:
                ck.close()
        else:
            fl.rolling_reload(module(p2), 2)
        traffic = PoissonTraffic(fl, lambda i: (rows(64, 5)[i % 64],),
                                 qps=200, seed=5)
        t = threading.Thread(target=traffic.run, args=(0.8,))
        t.start()
        time.sleep(0.2)
        assert fl.scale_to(2) == 2
        t.join(60)
        tally = traffic.await_all(timeout_s=60)
        assert tally["dropped"] == tally["errors"] == 0
        assert fl.prewarm_hits == 1
        assert {r.generation for r in fl.replicas()} == {2}
        want = np.asarray(jmlp.apply(p2, rows(64, 5)))
        for i, req in enumerate(traffic.sent):
            assert close(req.result, want[i % 64]), i
        for r in fl.replicas():
            assert all(c["forwards"] >= 2 for c in r.server.rank_counts())
    finally:
        fl.stop()


def test_killed_rank_fails_its_requests_typed_within_10_s():
    fl = make_fleet("t/wide-kill")
    try:
        fl.scale_to(2)
        r0, r1 = fl.replicas()
        victim, other = r0.server.procs
        stop = threading.Event()
        sent: list = []

        def load():
            i = 0
            while not stop.is_set():
                sent.append(fl.submit((rows(1, i)[0],)))
                i += 1
                time.sleep(0.002)

        t = threading.Thread(target=load)
        t.start()
        time.sleep(0.3)
        t_kill = time.monotonic()
        os.kill(victim.pid, signal.SIGKILL)
        time.sleep(0.5)
        stop.set()
        t.join()
        failed_at = {}
        for req in sent:
            try:
                req.wait(10)
            except ReplicaRankDied:
                failed_at[req.id] = time.monotonic()
        assert failed_at, "no request was on the killed replica"
        assert max(failed_at.values()) - t_kill < 10.0
        assert all(isinstance(r.error, RequestDropped) for r in sent
                   if r.error is not None)
        served = [r for r in sent if r.error is None]
        assert served and len(served) + len(failed_at) == len(sent)
        assert r0.state == "stopped" and not other.is_alive()
        assert r1.routable()
        # the fleet replaces it: the dead replica leaves, a new one serves
        assert fl.scale_to(2) == 2
        assert r0 not in fl.replicas()
        xs = rows(8, 9)
        assert close(answers(fl, xs), np.asarray(jmlp.apply(PARAMS, xs)))
        assert get_counters().get("serving_replica_rank_deaths") >= 1
    finally:
        fl.stop()


def test_an_error_on_the_ranks_ends_the_replica_typed():
    """A batch the ranks' forward refuses (16 columns expected, 3 given):
    rank 0 answers the error and ends, and the replica with it — the call
    raises ReplicaRankDied, no rank is left, and a later call raises the
    same at once."""
    srv = RankGroupServer(tw.mlp_rows, module(),
                          (np.zeros((8, 16), np.float32),), ["cpu"] * 2,
                          name="t/wide-error")
    try:
        with pytest.raises(ReplicaRankDied, match="failed on its ranks"):
            srv.serve((np.zeros((8, 3), np.float32),))
        assert not any(p.is_alive() for p in srv.procs)
        with pytest.raises(ReplicaRankDied):
            srv.serve((np.zeros((8, 16), np.float32),))
    finally:
        srv.close()


# -- the five serving fault kinds on a wide replica ---------------------------

SOAK_SEED = 1601


def wide_replica(job: str, replica: str):
    """A front door whose BatchApp serves through a two-rank replica."""
    app = BatchApp(lambda: RankGroupServer(
        tw.mlp_rows, module(), (np.zeros((8, 16), np.float32),), ["cpu"] * 2,
        name=f"{job}/{replica}"), SIZES[0], job=job, replica=replica,
        kv=None, max_batch=16, max_queue_ms=0.5, addr_ttl_s=5.0)
    door = FrontDoor(app, host="127.0.0.1", job=f"{job}-{replica}").start()
    assert app.wait_ready(120)
    return app, door


def test_the_five_serving_kinds_strike_a_wide_replica():
    """tests/test_torch_serving_chaos.py's seeded plan of all five kinds,
    each aimed at the wide replica r0 (the coordinator partition strikes
    discovery), with thread replicas r1 and r2 beside it behind chaos
    proxies and the LB: zero wrong payloads, each kind injected and
    recovered once, every breaker closed at the end."""
    kv = PartitionableKV()
    job = "twide/chaos"
    apps, doors, proxies = {}, {}, {}
    apps["r0"], doors["r0"] = wide_replica(job, "r0")
    for name in ("r1", "r2"):
        apps[name], doors[name] = spin_replica(None, job, name)
    for name, door in doors.items():
        proxies[name] = ChaosProxy(("127.0.0.1", door.port))
    pub_stop = threading.Event()

    def publish(name):
        key = f"{SERVING_ADDR_PREFIX}{job}/{name}"
        addr = f"{proxies[name].host}:{proxies[name].port}"
        while not pub_stop.is_set():
            kv.kv_set(key, format_serving_addr(addr, 2.0))
            pub_stop.wait(0.3)

    for name in apps:
        threading.Thread(target=publish, args=(name,), daemon=True).start()
    lb = ServingLB(
        job=job, host="127.0.0.1", kv=kv, pool=2, discovery_s=0.1,
        sweep_ms=3.0, addr_grace_s=1.0, hedge_floor_ms=25.0,
        hedge_cap_ms=250.0, request_timeout_s=2.0, breaker_errors=4,
        breaker_ratio=0.5, breaker_min=10, breaker_window_s=0.5,
        breaker_cooldown_s=0.3, breaker_probes=1).start()

    def partition_coord(duration_s):
        kv.partition(duration_s, mode="raise")
        until = time.monotonic() + duration_s
        return lambda: (time.monotonic() >= until + 0.3
                        and len(lb.app.upstreams) == len(apps))

    plan = FaultPlan.random(SOAK_SEED, kinds=SERVING_KINDS, n_faults=5,
                            first_step=3, last_step=40, min_gap=5,
                            flake_duration_s=0.8)
    for a in plan.actions:
        if isinstance(a, GrayReplica):
            a.rate = max(a.rate, 0.85)
        if hasattr(a, "replica"):
            a.replica = "r0"
    c = get_counters()
    inj0 = {k: c.get("faults_injected", type=k) for k in SERVING_KINDS}
    rec0 = {k: c.get("recoveries_completed", type=k) for k in SERVING_KINDS}
    stop = threading.Event()
    stats = {}

    def traffic(tid):
        rng = random.Random(SOAK_SEED * 100 + tid)
        v = float(tid + 1)
        x = np.full((SIZES[0],), v, np.float32)
        exp = np.asarray(jmlp.apply(PARAMS, x[None]))[0]
        ok = err = wrong = 0
        s = None
        while not stop.is_set():
            if s is None:
                try:
                    s = connect(lb.port)
                except OSError:
                    err += 1
                    time.sleep(0.05)
                    continue
            k = rng.randrange(1, 5)
            try:
                s.sendall(build_predict_request(x) * k)
                resps = read_responses(s, k, timeout=6.0)
            except OSError:
                s.close()
                s = None
                err += k
                continue
            for st, body in resps:
                if st != 200:
                    err += 1
                elif np.allclose(np.frombuffer(body, "<f4"), exp,
                                 atol=1e-4):
                    ok += 1
                else:
                    wrong += 1
            time.sleep(min(rng.expovariate(125.0), 0.05))
        if s is not None:
            s.close()
        stats[tid] = (ok, err, wrong)

    try:
        assert wait_routable(lb, len(apps))
        ctx = FaultContext(replica_proxies=proxies,
                           gray={n: apps[n].set_gray for n in apps},
                           serving_lb=lb.app, partition_coord=partition_coord,
                           rng=random.Random(SOAK_SEED))
        engine = FaultPlanEngine(plan, ctx)
        threads = [threading.Thread(target=traffic, args=(tid,),
                                    daemon=True) for tid in range(3)]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        while time.monotonic() < t0 + 60.0:
            engine(int((time.monotonic() - t0) * 10))
            if engine.quiescent():
                break
            time.sleep(0.02)
        quiesced = engine.quiescent()
        end = time.monotonic() + 10.0
        while time.monotonic() < end and any(
                up.breaker.state != BRK_CLOSED
                for up in lb.app.upstreams.values()):
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=20)
        assert quiesced, (engine.unfired(), engine.fired, engine.recovered)
        assert sorted(k for _, k in engine.fired) == sorted(SERVING_KINDS)
        assert sorted(engine.recovered) == sorted(SERVING_KINDS)
        for k in SERVING_KINDS:
            assert c.get("faults_injected", type=k) == inj0[k] + 1, k
            assert c.get("recoveries_completed", type=k) == rec0[k] + 1, k
        for up in lb.app.upstreams.values():
            assert up.breaker.state == BRK_CLOSED
        ok, err, wrong = (sum(v[i] for v in stats.values())
                          for i in range(3))
        assert wrong == 0 and ok > 0
        assert apps["r0"].server.rank_counts()[1]["forwards"] > 1
    finally:
        stop.set()
        pub_stop.set()
        lb.stop()
        for p in proxies.values():
            p.close()
        for d in doors.values():
            d.stop()
        apps["r0"].server.close()
    assert all(not p.is_alive() for p in apps["r0"].server.procs)
