"""The port's serving-plane chaos drills on the CPU: tests/test_serving_
chaos.py's scenarios — circuit breakers ejecting gray replicas and
re-admitting them through half-open probes, the retry budget degrading
hedges, the response-integrity nonce catching corrupted payloads with zero
wrong answers, front-door brownout with hysteresis, discovery freezing
under a coordinator partition, the exit-3 bootstrap marker, and the seeded
soak of all five serving fault kinds (``slow``, as the reference's is) —
with port replicas of the MLP [16, 32, 4] holding the JAX init, every
answer held to the JAX package's ``mlp.apply``.

Beyond the reference's list: ``FaultPlan.random(seed, kinds=
SERVING_KINDS)`` describes exactly as the reference's for the same seed,
and the port's registry renders through the reference's strict exposition
parser."""

from __future__ import annotations

import glob
import os
import random
import socket
import threading
import time

import numpy as np
import pytest

from edl_tpu.runtime import faults as jfaults
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.metrics import get_registry
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
    CoordBootstrapError,
    FrontDoor,
    bootstrap_kv,
    build_predict_request,
    format_serving_addr,
    replica_main,
)
from edl_tpu_torch.runtime.lb import BRK_CLOSED, BRK_OPEN, ServingLB, lb_main
from tests.torch_wire import (
    SIZES,
    FakeKV,
    PartitionableKV,
    connect,
    payload_ok,
    port_server,
    read_responses,
    ref_row,
    spin_replica,
    wait_routable,
)

pytestmark = pytest.mark.timeout_s(120)


def req_of(v: float) -> bytes:
    return build_predict_request(np.full((SIZES[0],), v, np.float32))


class TestBreakerAndIntegrity:
    """Gray replica ra behind a breaker-armed LB: error-mode grays trip
    the breaker (eject → half-open probe → re-admit), corrupt-mode grays
    are caught by the per-block nonce and masked by rescue resends — the
    client never sees a wrong payload."""

    JOB = "tchaos/fleet"

    @classmethod
    def setup_class(cls):
        import tempfile

        cls.kv = FakeKV()
        cls.app_a, cls.door_a = spin_replica(cls.kv, cls.JOB, "ra")
        cls.app_b, cls.door_b = spin_replica(cls.kv, cls.JOB, "rb")
        cls.flight = tempfile.mkdtemp(prefix="edl-tchaos-flight-")
        cls.lb = ServingLB(
            job=cls.JOB, host="127.0.0.1", kv=cls.kv, pool=2,
            discovery_s=0.1, sweep_ms=3.0,
            hedge_floor_ms=60000.0, hedge_cap_ms=60000.0,
            request_timeout_s=20.0,
            breaker_errors=3, breaker_ratio=0.5, breaker_min=10,
            breaker_window_s=0.5, breaker_cooldown_s=0.25,
            breaker_probes=1, flight_dir=cls.flight).start()
        assert wait_routable(cls.lb, 2), cls.lb.app.upstreams

    @classmethod
    def teardown_class(cls):
        cls.lb.stop()
        cls.door_a.stop()
        cls.door_b.stop()

    def _round(self, v=1.0, k=8):
        out = []
        s1, s2 = connect(self.lb.port), connect(self.lb.port)
        try:
            s1.sendall(req_of(v) * k)
            s2.sendall(req_of(v) * k)
            out.extend(read_responses(s1, k, timeout=30))
            out.extend(read_responses(s2, k, timeout=30))
        finally:
            s1.close()
            s2.close()
        return out

    def _breaker(self, name):
        up = self.lb.app.upstreams.get(name)
        return None if up is None else up.breaker.state

    def _drive_until(self, predicate, deadline_s=15.0, v=1.0):
        wrong = errs = total = 0
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            for st, body in self._round(v=v):
                total += 1
                if st == 200:
                    wrong += not payload_ok(body, v)
                else:
                    errs += 1
            if predicate():
                return wrong, errs, total
            time.sleep(0.01)
        raise AssertionError(
            f"predicate never held (breaker={self._breaker('ra')}, "
            f"total={total}, errs={errs})")

    def test_error_gray_trips_breaker_then_half_open_readmit(self):
        c = get_counters()
        trans0 = {t: c.get("lb_breaker_transitions", job=self.JOB, to=t)
                  for t in ("open", "half_open", "closed")}
        self.app_a.set_gray(1.0, "error", duration_s=2.0)
        wrong, _, _ = self._drive_until(
            lambda: self._breaker("ra") == BRK_OPEN)
        assert wrong == 0
        assert c.get("lb_breaker_transitions", job=self.JOB,
                     to="open") > trans0["open"]
        assert glob.glob(os.path.join(self.flight, "*lb-breaker-open*"))
        for st, body in self._round():
            assert st == 200 and payload_ok(body, 1.0)
        time.sleep(2.0)
        wrong, _, _ = self._drive_until(
            lambda: self._breaker("ra") == BRK_CLOSED)
        assert wrong == 0
        for t in ("half_open", "closed"):
            assert c.get("lb_breaker_transitions", job=self.JOB,
                         to=t) > trans0[t]
        assert wait_routable(self.lb, 2)

    def test_metrics_render_strict_with_bounded_labels(self):
        """The port's exposition passes the reference's strict 0.0.4
        parser, and the breaker gauge's upstream labels are exactly the
        replica names."""
        from edl_tpu.observability.metrics import parse_exposition

        series = parse_exposition(get_registry().render())
        ups = set()
        for key in series:
            if (key.startswith("edl_lb_breaker_state{")
                    and f'job="{self.JOB}"' in key):
                for part in key[key.index("{") + 1:-1].split(","):
                    k, _, val = part.partition("=")
                    if k == "upstream":
                        ups.add(val.strip('"'))
        assert ups and ups <= {"ra", "rb"}, ups
        for name in ("edl_lb_breaker_transitions_total",
                     "edl_lb_integrity_failures_total",
                     "edl_lb_retry_budget_exhausted_total",
                     "edl_frontdoor_brownout_seconds_total"):
            assert any(k.startswith(name) for k in series), name

    def test_corrupt_gray_caught_by_nonce_zero_wrong_payloads(self):
        """mode="corrupt" answers 200s with garbage bodies and a wrong
        nonce echo; the LB poisons the connection and rescues the block
        to the healthy replica: every client answer correct."""
        c = get_counters()
        integ0 = c.get("lb_integrity_failures", job=self.JOB)
        self.app_a.set_gray(1.0, "corrupt", duration_s=1.0)
        deadline = time.monotonic() + 1.2
        wrong = total = 0
        while time.monotonic() < deadline:
            for st, body in self._round(v=2.0):
                total += 1
                assert st == 200, st
                wrong += not payload_ok(body, 2.0)
        assert wrong == 0 and total >= 32
        assert c.get("lb_integrity_failures", job=self.JOB) > integ0
        self._drive_until(lambda: self._breaker("ra") == BRK_CLOSED, v=2.0)


def test_retry_budget_exhaustion_degrades_hedges(tmp_path):
    kv = FakeKV()
    _a, door_a = spin_replica(kv, "tchaos/budget", "r0")
    _b, door_b = spin_replica(kv, "tchaos/budget", "r1")
    lb = ServingLB(
        job="tchaos/budget", host="127.0.0.1", kv=kv, pool=2,
        discovery_s=0.1, sweep_ms=2.0, hedge_floor_ms=0.1, hedge_cap_ms=0.1,
        request_timeout_s=20.0, retry_budget_cap=0.0, retry_ratio=0.0,
        flight_dir=str(tmp_path)).start()
    try:
        assert wait_routable(lb, 2)
        c = get_counters()
        ex0 = c.get("lb_retry_budget_exhausted", job="tchaos/budget")
        socks = [connect(lb.port) for _ in range(4)]
        try:
            for s in socks:
                s.sendall(req_of(3.0) * 64)
            for s in socks:
                for st, body in read_responses(s, 64, timeout=30):
                    assert st == 200 and payload_ok(body, 3.0)
        finally:
            for s in socks:
                s.close()
        assert c.get("lb_retry_budget_exhausted", job="tchaos/budget") > ex0
        assert glob.glob(str(tmp_path / "*lb-retry-budget*"))
    finally:
        lb.stop()
        door_a.stop()
        door_b.stop()


def test_coord_partition_freezes_discovery_serving_continues():
    kv = PartitionableKV()
    job = "tchaos/freeze"
    _a, door_a = spin_replica(kv, job, "ra")
    _b, door_b = spin_replica(kv, job, "rb")
    lb = ServingLB(
        job=job, host="127.0.0.1", kv=kv, pool=2,
        discovery_s=0.05, sweep_ms=3.0, addr_grace_s=0.3,
        hedge_floor_ms=30.0, request_timeout_s=20.0).start()
    c = get_counters()

    def burst(v):
        s = connect(lb.port)
        try:
            s.sendall(req_of(v) * 4)
            return read_responses(s, 4, timeout=30)
        finally:
            s.close()

    try:
        assert wait_routable(lb, 2)
        f0 = c.get("lb_discovery_freezes", job=job)
        kv.partition(0.7, mode="raise")
        time.sleep(0.45)  # > addr_grace_s, still inside the partition
        assert set(lb.app.upstreams) == {"ra", "rb"}
        for st, body in burst(4.0):
            assert st == 200 and payload_ok(body, 4.0)
        assert c.get("lb_discovery_freezes", job=job) > f0
        while kv.partitioned():
            time.sleep(0.05)
        time.sleep(0.2)
        f1 = c.get("lb_discovery_freezes", job=job)
        kv.partition(0.6, mode="empty")
        time.sleep(0.4)
        assert set(lb.app.upstreams) == {"ra", "rb"}
        assert lb.app._disc_frozen
        for st, body in burst(5.0):
            assert st == 200 and payload_ok(body, 5.0)
        assert c.get("lb_discovery_freezes", job=job) > f1
        while kv.partitioned():
            time.sleep(0.05)
        deadline = time.monotonic() + 5
        while lb.app._disc_frozen and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not lb.app._disc_frozen
        door_a.stop()
        kv.kv_del(f"{SERVING_ADDR_PREFIX}{job}/ra")
        deadline = time.monotonic() + 5
        while "ra" in lb.app.upstreams and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "ra" not in lb.app.upstreams and "rb" in lb.app.upstreams
        for st, body in burst(6.0):
            assert st == 200 and payload_ok(body, 6.0)
    finally:
        lb.stop()
        door_b.stop()


def _silent_listener():
    """A black-holed coordinator: accepts TCP, never answers PONG."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    return srv, srv.getsockname()[1]


def test_bootstrap_kv_contract():
    assert bootstrap_kv({}, disabled="discovery disabled") is None
    with pytest.raises(CoordBootstrapError):
        bootstrap_kv({"EDL_COORD_ENDPOINT": "host:notaport"},
                     disabled="discovery disabled")


def test_lb_main_exit3_on_black_holed_coordinator(capsys, tmp_path):
    srv, port = _silent_listener()
    try:
        rc = lb_main({"EDL_COORD_ENDPOINT": f"127.0.0.1:{port}",
                      "EDL_COORD_BOOTSTRAP_DEADLINE_S": "0.6",
                      "EDL_LB_JOB": "tchaos/boot",
                      "EDL_FLIGHTREC_DIR": str(tmp_path)})
    finally:
        srv.close()
    assert rc == 3
    out = capsys.readouterr().out
    assert "lb FAILED (coordinator bootstrap:" in out
    assert "unreachable for" in out
    assert glob.glob(str(tmp_path / "*lb-coord-bootstrap*"))


def test_replica_main_exit3_on_black_holed_coordinator(capsys, tmp_path):
    srv, port = _silent_listener()
    try:
        rc = replica_main({"EDL_COORD_ENDPOINT": f"127.0.0.1:{port}",
                           "EDL_COORD_BOOTSTRAP_DEADLINE_S": "0.6",
                           "EDL_FD_MODEL": "mlp:16,32,4",
                           "EDL_FD_REPLICA": "rboot",
                           "EDL_FLIGHTREC_DIR": str(tmp_path)},
                          device="cpu")
    finally:
        srv.close()
    assert rc == 3
    out = capsys.readouterr().out
    assert "frontdoor FAILED replica=rboot" in out
    assert "coordinator bootstrap" in out
    assert glob.glob(str(tmp_path / "*frontdoor-coord-bootstrap*"))


def test_brownout_enters_on_lag_breach_and_exits_with_hysteresis():
    job, replica = "tchaos/brown", "r0"
    app = BatchApp(port_server, SIZES[0], job=job, replica=replica,
                   max_batch=16, max_queue_ms=0.5,
                   brownout_sustain=2, brownout_min_s=0.3)
    door = FrontDoor(app, host="127.0.0.1", job=job).start()
    try:
        assert app.wait_ready(120)
        s = connect(door.port)
        s.sendall(req_of(7.0) * 4)
        read_responses(s, 4)
        assert not app._brownout and app.brownouts == 0
        seconds = get_registry().counter("frontdoor_brownout_seconds")
        b0 = seconds.value(job=job, replica=replica)
        app.note_lag_breach()
        deadline = time.monotonic() + 10
        while not app._brownout and time.monotonic() < deadline:
            s.sendall(req_of(7.0))
            read_responses(s, 1)
        assert app._brownout and app.brownouts == 1
        s.sendall(req_of(7.0) * 4)
        for st, body in read_responses(s, 4):
            assert st == 200 and payload_ok(body, 7.0)
        deadline = time.monotonic() + 10
        while app._brownout and time.monotonic() < deadline:
            s.sendall(req_of(7.0))
            read_responses(s, 1)
            time.sleep(0.02)
        assert not app._brownout
        assert seconds.value(job=job, replica=replica) > b0
        s.close()
    finally:
        door.stop()


def test_admin_gray_drill_verb():
    """/admin/gray is the out-of-process injection seam: body "<rate>
    <mode> <duration_s>", malformed → 400."""
    from tests.test_torch_frontdoor import make_replica

    app, door = make_replica("tchaos/admingray")
    try:
        assert app.wait_ready(120)
        s = connect(door.port)

        def gray(body):
            s.sendall(b"POST /admin/gray HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: %d\r\n\r\n" % len(body) + body)
            return read_responses(s, 1)[0][0]

        assert gray(b"1.0 error 0.4") == 200
        s.sendall(req_of(8.0))
        assert read_responses(s, 1)[0][0] == 500
        assert get_counters().get("frontdoor_gray_responses",
                                  job="tchaos/admingray", mode="error") >= 1
        time.sleep(0.45)  # the drill window lapses on its own
        s.sendall(req_of(8.0))
        (st, resp), = read_responses(s, 1)
        assert st == 200 and payload_ok(resp, 8.0)
        assert gray(b"1.0 bogus 0.4") == 400
        s.close()
    finally:
        door.stop()


# -- the seeded multi-fault soak ---------------------------------------------

SOAK_SEED = 1601
N_REPLICAS = 3


def _soak_plan(seed, faults_mod=None):
    f = faults_mod
    plan = (f.FaultPlan if f else FaultPlan).random(
        seed, kinds=SERVING_KINDS, n_faults=5, first_step=3, last_step=40,
        min_gap=5, flake_duration_s=0.8)
    gray = f.GrayReplica if f else GrayReplica
    for a in plan.actions:
        if isinstance(a, gray):
            a.rate = max(a.rate, 0.85)
    return plan


def test_soak_plan_seeded_reproducibility():
    p1, p2 = _soak_plan(SOAK_SEED), _soak_plan(SOAK_SEED)
    assert p1.describe() == p2.describe()
    assert sorted(d["kind"] for d in p1.describe()) == sorted(SERVING_KINDS)
    assert _soak_plan(SOAK_SEED + 1).describe() != p1.describe()
    assert p1.describe() == _soak_plan(SOAK_SEED, jfaults).describe()


@pytest.mark.parametrize("seed", [0, 7, 19, 1601])
def test_serving_plan_describes_as_the_reference(seed):
    """``FaultPlan.random(seed, kinds=SERVING_KINDS)`` is the reference's
    plan for the seed, at the defaults and at a short campaign that draws
    its mix from the seed."""
    for kw in ({}, dict(n_faults=3, flake_duration_s=1.6)):
        assert FaultPlan.random(seed, kinds=SERVING_KINDS, **kw).describe() \
            == jfaults.FaultPlan.random(seed, kinds=jfaults.SERVING_KINDS,
                                        **kw).describe()


@pytest.mark.slow
def test_serving_chaos_soak_zero_wrong_payloads():
    """All five serving fault kinds fire (seeded schedule, steps =
    deciseconds) against a 3-replica fleet behind chaos proxies under
    traffic: zero wrong payloads, a bounded error rate, the breaker arc,
    every fault injected and recovered exactly once."""
    kv = PartitionableKV()
    job = "tchaos/soak"
    apps, doors, proxies = {}, {}, {}
    pub_stop = threading.Event()
    for i in range(N_REPLICAS):
        name = f"r{i}"
        # kv=None: the chaos proxy in front of the door is the address
        apps[name], doors[name] = spin_replica(None, job, name)
        proxies[name] = ChaosProxy(("127.0.0.1", doors[name].port))

    def publish(name):
        key = f"{SERVING_ADDR_PREFIX}{job}/{name}"
        addr = f"{proxies[name].host}:{proxies[name].port}"
        while not pub_stop.is_set():
            kv.kv_set(key, format_serving_addr(addr, 2.0))
            pub_stop.wait(0.3)

    for name in apps:
        threading.Thread(target=publish, args=(name,), daemon=True).start()
    lb = ServingLB(
        job=job, host="127.0.0.1", kv=kv, pool=2,
        discovery_s=0.1, sweep_ms=3.0, addr_grace_s=1.0,
        hedge_floor_ms=25.0, hedge_cap_ms=250.0, request_timeout_s=2.0,
        breaker_errors=4, breaker_ratio=0.5, breaker_min=10,
        breaker_window_s=0.5, breaker_cooldown_s=0.3,
        breaker_probes=1).start()

    def partition_coord(duration_s):
        kv.partition(duration_s, mode="raise")
        until = time.monotonic() + duration_s
        return lambda: (time.monotonic() >= until + 0.3
                        and len(lb.app.upstreams) == N_REPLICAS)

    c = get_counters()
    stop = threading.Event()
    stats = {}

    def traffic(tid):
        rng = random.Random(SOAK_SEED * 100 + tid)
        v = float(tid + 1)
        exp = ref_row(v)
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
                s.sendall(req_of(v) * k)
                resps = read_responses(s, k, timeout=6.0)
            except OSError:
                s.close()
                s = None
                err += k
                continue
            for st, body in resps:
                if st != 200:
                    err += 1
                elif np.allclose(np.frombuffer(body, "<f4"), exp, atol=1e-4):
                    ok += 1
                else:
                    wrong += 1
            time.sleep(min(rng.expovariate(125.0), 0.05))
        if s is not None:
            s.close()
        stats[tid] = (ok, err, wrong)

    try:
        assert wait_routable(lb, N_REPLICAS)
        plan = _soak_plan(SOAK_SEED)
        ctx = FaultContext(replica_proxies=proxies,
                           gray={n: apps[n].set_gray for n in apps},
                           serving_lb=lb.app,
                           partition_coord=partition_coord,
                           rng=random.Random(SOAK_SEED))
        inj0 = {k: c.get("faults_injected", type=k) for k in SERVING_KINDS}
        rec0 = {k: c.get("recoveries_completed", type=k)
                for k in SERVING_KINDS}
        trans0 = {t: c.get("lb_breaker_transitions", job=job, to=t)
                  for t in ("open", "half_open", "closed")}
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
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=20)
        assert quiesced, (engine.unfired(), engine.fired, engine.recovered)
        assert sorted(k for _, k in engine.fired) == sorted(SERVING_KINDS)
        assert sorted(engine.recovered) == sorted(SERVING_KINDS)
        for k in SERVING_KINDS:
            assert c.get("faults_injected", type=k) == inj0[k] + 1, k
            assert c.get("recoveries_completed", type=k) == rec0[k] + 1, k
        for t in ("open", "half_open", "closed"):
            assert c.get("lb_breaker_transitions", job=job,
                         to=t) > trans0[t], t
        for up in lb.app.upstreams.values():
            assert up.breaker.state == BRK_CLOSED
        ok, err, wrong = (sum(v[i] for v in stats.values())
                          for i in range(3))
        total = ok + err + wrong
        assert wrong == 0, f"{wrong} wrong payloads out of {total}"
        assert total >= 300, total
        assert err / total <= 0.15, f"error rate {err}/{total}"
    finally:
        stop.set()
        pub_stop.set()
        lb.stop()
        for p in proxies.values():
            p.close()
        for d in doors.values():
            d.stop()
