"""The port's coordination service (edl_tpu_torch.coord): its
PyCoordService held against the JAX package's on the same operation
sequences.

A ``Twin`` runs every call on both services, each under one ``FakeClock``
that the scenario advances, and asserts the two return values equal
(statuses by name and value, ``QueueStats`` field by field); after each
scenario the two snapshots (tasks, passes, epochs, KV, members, fence and
stream position), ``stats()`` and ``server_metrics()`` must be equal.  The
scenarios are every ``kind="python"`` case of tests/test_coord.py and the
Python pair of tests/test_coord_ha.py.  The long-poll contract of
tests/test_coord_wait.py (``wait_epoch``, ``kv_wait``, TTL expiry, waiters
under churn) runs on the port's service alone, in real time; that file's
server and discovery cases run on the port's native core and server in
tests/test_torch_coord_native.py.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time

import pytest

from edl_tpu.coord import PyCoordService as JaxCoord
from edl_tpu_torch.coord import (CoordFenced, LeaseStatus, PyCoordService,
                                 QueueStats, local_service)
from edl_tpu_torch.observability.metrics import MetricsRegistry


class FakeClock:
    def __init__(self) -> None:
        self.ms = 1_000_000

    def __call__(self) -> int:
        return self.ms

    def advance(self, ms: int) -> None:
        self.ms += ms


def _norm(x):
    """A value comparable across the two packages' types."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.asdict(x))
    if isinstance(x, (tuple, list)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


class Twin:
    """Every call on the reference's service and the port's; returns the
    port's result once both agree (an error must match by type name and
    message, and is raised as a RuntimeError naming it)."""

    def __init__(self, **kw) -> None:
        self.clock = FakeClock()
        self.ref = JaxCoord(clock=self.clock, **kw)
        self.port = PyCoordService(clock=self.clock, **kw)

    def advance(self, ms: int) -> None:
        self.clock.advance(ms)

    def __getattr__(self, name):
        ref, port = getattr(self.ref, name), getattr(self.port, name)

        def call(*args, **kw):
            outs = []
            for fn in (ref, port):
                try:
                    outs.append(("ok", fn(*args, **kw)))
                except Exception as exc:
                    outs.append(("raised", type(exc).__name__, str(exc)))
            assert _norm(outs[0]) == _norm(outs[1]), (name, args, outs)
            if outs[1][0] == "raised":
                raise RuntimeError(f"{outs[1][1]}: {outs[1][2]}")
            return outs[1][1]
        return call

    def check_state(self) -> None:
        """Queue, passes, epochs, KV, members, fence and stream position,
        the queue's counts and the op counters: equal."""
        for fn in ("stats", "server_metrics"):
            a, b = getattr(self.ref, fn)(), getattr(self.port, fn)()
            assert _norm(a) == _norm(b), fn
        assert (self.ref.snapshot(include_members=True)
                == self.port.snapshot(include_members=True))
        assert self.ref.stream_version() == self.port.stream_version()


@pytest.fixture
def twin_factory():
    made = []

    def make(**kw):
        t = Twin(**kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.check_state()


# -- tests/test_coord.py, kind="python" -------------------------------------


def test_lease_complete_done(twin_factory):
    s = twin_factory()
    ids = [s.add_task(f"shard-{i}".encode()) for i in range(3)]
    seen = set()
    for _ in range(3):
        status, tid, payload = s.lease("w0")
        assert status == LeaseStatus.OK
        assert payload.startswith(b"shard-")
        seen.add(tid)
        assert s.complete(tid)
    assert seen == set(ids)
    assert s.lease("w0")[0] == LeaseStatus.DONE
    assert s.all_done()


def test_timeout_redispatch(twin_factory):
    s = twin_factory(task_timeout_ms=16_000)
    s.add_task(b"t")
    status, tid, _ = s.lease("dead-worker")
    assert status == LeaseStatus.OK
    assert s.lease("w1")[0] == LeaseStatus.EMPTY
    s.advance(16_001)
    status, tid2, payload = s.lease("w1")
    assert status == LeaseStatus.OK and payload == b"t" and tid2 == tid
    assert s.complete(tid2)
    assert not s.complete(tid)
    assert s.all_done()


@pytest.mark.parametrize("passes", [1, 3])
def test_fail_requeues_then_drops_poison(twin_factory, passes):
    """Three failures drop the task; across a multi-pass queue too the run
    ends instead of livelocking."""
    s = twin_factory(passes=passes)
    s.add_task(b"poison")
    for _ in range(3):
        status, tid, _ = s.lease("w")
        assert status == LeaseStatus.OK
        assert s.fail(tid)
    assert s.lease("w")[0] == LeaseStatus.DONE
    assert s.stats().dropped == 1
    assert s.all_done()


def test_release_worker_returns_leases(twin_factory):
    s = twin_factory()
    s.add_task(b"a")
    s.add_task(b"b")
    s.lease("w0")
    s.lease("w0")
    assert s.release_worker("w0") == 2
    st = s.stats()
    assert st.todo == 2 and st.leased == 0


def test_renew_and_redispatch(twin_factory):
    """A renewed lease outlives the timeout; ``redispatch`` returns the
    expired ones to the queue."""
    s = twin_factory(task_timeout_ms=1_000)
    a, b = s.add_task(b"a"), s.add_task(b"b")
    s.lease("w0")
    s.lease("w1")
    s.advance(800)
    assert s.renew(a, "w0")
    assert not s.renew(b, "w0")  # not its lease
    s.advance(800)
    assert s.redispatch() == 1
    assert s.stats().todo == 1 and s.stats().leased == 1


@pytest.mark.parametrize("passes", [2, 5])
def test_multi_pass(twin_factory, passes):
    s = twin_factory(passes=passes)
    if passes == 5:  # no tasks at all: terminates at once
        assert s.lease("w")[0] == LeaseStatus.DONE
        return
    s.add_task(b"x")
    status, tid, _ = s.lease("w")
    s.complete(tid)
    assert s.current_pass() in (0, 1)
    status, tid, payload = s.lease("w")
    assert status == LeaseStatus.OK and payload == b"x"
    s.complete(tid)
    assert s.lease("w")[0] == LeaseStatus.DONE
    assert s.current_pass() == 1


def test_membership_epochs(twin_factory):
    s = twin_factory(member_ttl_ms=15_000)
    e1 = s.join("w0", "host0:1")
    e2 = s.join("w1", "host1:1")
    assert e2 > e1
    epoch, members = s.members()
    assert [m[0] for m in members] == ["w0", "w1"]
    s.advance(10_000)
    assert s.heartbeat("w0") and s.heartbeat("w1")
    s.advance(10_000)
    assert s.heartbeat("w1")
    s.advance(6_000)
    epoch2, members2 = s.members()
    assert [m[0] for m in members2] == ["w1"] and epoch2 > epoch
    assert s.leave("w1")
    assert s.epoch() > epoch2
    assert not s.heartbeat("w0")
    s.join("w0", "host0:1")
    assert s.members()[1] == [("w0", "host0:1")]
    assert s.heartbeat_many(["w0", "gone"]) == {"w0": True, "gone": False}


def test_kv_and_cas(twin_factory):
    s = twin_factory()
    assert s.kv_get("k") is None
    s.kv_set("k", b"v1")
    assert s.kv_get("k") == b"v1"
    assert s.kv_cas("slot/0", b"", b"w0")
    assert not s.kv_cas("slot/0", b"", b"w1")
    assert s.kv_cas("slot/0", b"w0", b"w1")
    assert s.kv_get("slot/0") == b"w1"
    assert s.kv_keys("slot/") == ["slot/0"]
    assert s.kv_del("k")
    assert s.kv_get("k") is None


@pytest.mark.parametrize("payload", [b"", bytes(range(256)) * 1024],
                         ids=["empty", "256KiB"])
def test_payload_roundtrip(twin_factory, payload):
    s = twin_factory()
    s.kv_set("big", payload)
    assert s.kv_get("big") == payload
    tid = s.add_task(payload)
    status, got, out = s.lease("w")
    assert status == LeaseStatus.OK and got == tid and out == payload
    assert s.complete(tid)


def test_snapshot_restores_across_the_packages(twin_factory):
    """A snapshot of either service restores into the other."""
    s = twin_factory(member_ttl_ms=15_000)
    s.add_task(b"a")
    s.add_task(b"b")
    s.lease("w0")
    s.join("w0", "addr")
    s.kv_set("k", b"v")
    blob = s.port.snapshot()
    assert blob == s.ref.snapshot()
    for src, dst in ((s.port, JaxCoord()), (s.ref, PyCoordService())):
        assert dst.restore(src.snapshot())
        assert dst.snapshot() == src.snapshot()
        assert dst.kv_get("k") == b"v" and dst.stats().todo == 2


# -- tests/test_coord_ha.py, the Python pair ----------------------------------


def _pair(**kw):
    pr = PyCoordService(**kw)
    sb = PyCoordService(role="standby")
    pr.add_replica(sb)
    return pr, sb


def test_stream_before_ack_and_promotion():
    pr, sb = _pair()
    pr.add_task(b"shard-0")
    pr.join("w0", "a0")
    pr.kv_set("ckpt/1", b"/gen-1")
    assert sb.promote(1) == 1
    assert sb.kv_get("ckpt/1") == b"/gen-1"
    assert sb.stats().todo == 1
    assert sb.members() == (1, [("w0", "a0")])
    assert sb.heartbeat("w0") and sb.epoch() == 1


def test_standby_rejects_reads_writes_and_waits():
    _, sb = _pair()
    for op in (lambda: sb.kv_get("k"), lambda: sb.kv_set("k", b"v"),
               lambda: sb.epoch(), lambda: sb.members(),
               lambda: sb.stats(), lambda: sb.lease("w"),
               lambda: sb.wait_epoch(0, 0.05),
               lambda: sb.kv_wait("k", 0.05)):
        with pytest.raises(CoordFenced):
            op()
    assert sb.fencing_rejects >= 8


def test_deposed_primary_self_fences_and_tokens_ratchet():
    pr, sb = _pair()
    pr.kv_set("k", b"v")
    sb.promote(3)
    with pytest.raises(CoordFenced):
        pr.kv_set("k", b"stale")
    assert pr.role == "fenced"
    with pytest.raises(CoordFenced):
        pr.kv_get("k")
    assert sb.kv_get("k") == b"v"
    with pytest.raises(CoordFenced):
        sb.promote(2)
    assert sb.promote(5) == 5
    sb2 = PyCoordService(role="standby")
    sb.add_replica(sb2)
    sb.kv_set("k2", b"v2")
    assert sb2.fence == 5
    with pytest.raises(CoordFenced):
        sb2.promote(5)


def test_lease_guard_fences_reads_without_a_mutation():
    pr, sb = _pair(repl_lease_s=0.05)
    pr.kv_set("k", b"v")
    sb.promote(1)
    time.sleep(0.1)
    with pytest.raises(CoordFenced):
        pr.kv_get("k")
    assert pr.role == "fenced"


def test_metrics_register_on_the_ports_registry():
    """The coordinator's series on the port's own registry, name-matched
    to the reference's: callback counters render as ``_total``."""
    s = local_service(prefer_native=False)
    assert isinstance(s, PyCoordService)
    reg = MetricsRegistry()
    s.register_metrics(reg)
    s.add_task(b"t")
    s.lease("w")
    text = reg.render()
    assert "# TYPE edl_coord_requests_total counter" in text
    assert 'edl_coord_queue_tasks{state="leased"} 1' in text
    assert "edl_coord_verb_seconds_count" in text
    assert isinstance(s.stats(), QueueStats)


# -- tests/test_coord_wait.py on the port's service, in real time --------------


def _service():
    return PyCoordService(member_ttl_ms=2000)


def _park(fn, *args):
    got = {}

    def run():
        t0 = time.monotonic()
        got["value"] = fn(*args)
        got["dt"] = time.monotonic() - t0

    t = threading.Thread(target=run)
    t.start()
    return t, got


def test_wait_epoch_fires_on_join_and_honors_timeout():
    svc = _service()
    svc.join("a")
    known = svc.epoch()
    t, got = _park(svc.wait_epoch, known, 10.0)
    time.sleep(0.2)
    svc.join("b")
    t.join(timeout=5)
    assert not t.is_alive() and got["value"] != known and got["dt"] < 2.0
    known = svc.epoch()
    t0 = time.monotonic()
    assert svc.wait_epoch(known, timeout_s=0.3) == known
    assert 0.25 <= time.monotonic() - t0 < 2.0


def test_kv_wait_fires_on_set_and_on_epoch_move():
    svc = _service()
    svc.join("a")
    known = svc.epoch()
    t1, kv = _park(svc.kv_wait, "the-key", 10.0)
    t2, ep = _park(lambda: svc.kv_wait("never-set", timeout_s=10.0,
                                       known_epoch=known))
    time.sleep(0.2)
    svc.kv_set("the-key", b"payload")
    svc.join("b")
    t1.join(timeout=5), t2.join(timeout=5)
    assert kv["value"][0] == b"payload"
    v, epoch = ep["value"]
    assert v is None and epoch is not None and epoch != known
    # a key already there returns at once
    t0 = time.monotonic()
    assert svc.kv_wait("the-key", timeout_s=10.0)[0] == b"payload"
    assert time.monotonic() - t0 < 1.0


def test_kv_wait_changed_fires_on_a_new_value():
    svc = _service()
    svc.kv_set("k", b"old")
    t, got = _park(svc.kv_wait_changed, "k", b"old", 10.0)
    time.sleep(0.2)
    svc.kv_set("k", b"old")  # the same value is no change
    time.sleep(0.1)
    assert t.is_alive()
    assert svc.kv_cas("k", b"old", b"new")
    t.join(timeout=5)
    assert got["value"] == (True, b"new")
    assert svc.kv_wait_changed("k", b"new", 0.05) == (False, None)
    assert svc.kv_del("k")
    assert svc.kv_wait_changed("k", b"new", 1.0) == (True, None)


def test_kv_wait_timeout_vs_fire_ordering():
    svc = _service()
    t1, short = _park(svc.kv_wait, "ordered", 0.3)
    t2, long = _park(svc.kv_wait, "ordered", 10.0)
    time.sleep(0.6)
    svc.kv_set("ordered", b"late")
    t1.join(timeout=5), t2.join(timeout=5)
    assert short["value"][0] is None
    assert long["value"][0] == b"late"


def test_waiters_survive_concurrent_churn():
    svc = _service()
    svc.join("base")
    stop = threading.Event()
    outcomes: list = []
    lock = threading.Lock()

    def churner(i):
        for round_ in range(10):
            svc.join(f"w{i}-{round_}")
            time.sleep(0.01)
            svc.leave(f"w{i}-{round_}")
            svc.kv_set(f"churn/{i}/{round_}", b"x")

    def parked_epoch():
        while not stop.is_set():
            known = svc.epoch()
            got = svc.wait_epoch(known, timeout_s=0.5)
            with lock:
                outcomes.append((known, got))

    churners = [threading.Thread(target=churner, args=(i,))
                for i in range(3)]
    parkers = [threading.Thread(target=parked_epoch) for _ in range(4)]
    for t in churners + parkers:
        t.start()
    for t in churners:
        t.join(timeout=30)
    stop.set()
    for t in parkers:
        t.join(timeout=10)
        assert not t.is_alive(), "parked waiter wedged through churn"
    assert any(k != g for k, g in outcomes)


def test_wait_epoch_fires_on_ttl_expiry():
    svc = _service()
    svc.join("dies")
    known = svc.epoch()
    t0 = time.monotonic()
    got = svc.wait_epoch(known, timeout_s=10.0)
    assert got != known, "TTL expiry never fired the waiter"
    assert time.monotonic() - t0 < 5.0


def test_server_metrics_counts_fired_waits():
    svc = _service()
    svc.join("a")
    known = svc.epoch()
    t, _ = _park(svc.wait_epoch, known, 10.0)
    time.sleep(0.2)
    svc.join("b")
    t.join(timeout=5)
    m = svc.server_metrics()
    assert m["longpolls_fired"] >= 1 and m["longpolls_parked"] >= 1
