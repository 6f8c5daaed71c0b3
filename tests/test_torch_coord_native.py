"""The port's native coordination core (edl_tpu_torch/coord/native, built by
edl_tpu_torch.coord.bindings into build/edl_tpu_torch/coord/), its TCP
server and its clients, held against the JAX package's:

* the ``kind``-parametrised scenarios of tests/test_coord.py on the port's
  in-process :class:`NativeCoordService` and the reference's, side by side
  under one FakeClock (results, snapshots and stats equal);
* the server scenarios of tests/test_coord.py and the wait contract of
  tests/test_coord_wait.py on the port's spawned server (and, for the
  waits, its in-process core);
* the same line-protocol script sent to the reference's server and to the
  port's gets byte-equal replies;
* snapshots restore across the packages (tests/test_coord_ha.py's
  TestSnapshotParity, reference Python backend ↔ port native core);
* the HA pair (TestNativePair), the durability drills of
  tests/test_coord_durability.py (kill -9 and restart, power loss
  mid-persist), and the coordinator failover of
  tests/test_accuracy_elasticity.py on the port's VirtualWorkerLoop with a
  ``CoordClient`` as its store.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import random
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from edl_tpu.coord import NativeCoordService as JaxNative
from edl_tpu.coord import PyCoordService as JaxPy
from edl_tpu.coord import native_available as jax_native_available
from edl_tpu.coord.server import spawn_server as jax_spawn_server
from edl_tpu.models import mlp as jmlp
from edl_tpu_torch import interop
from edl_tpu_torch.coord import (CoordClient, CoordUnavailable, LeaseStatus,
                                 NativeCoordService, PyCoordService,
                                 local_service, native_available,
                                 spawn_ha_pair, spawn_server)
from edl_tpu_torch.coord import bindings
from edl_tpu_torch.coord.client import BACKOFF_CAP_S, backoff_delay
from edl_tpu_torch.models import mlp
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.data import ShardRegistry
from edl_tpu_torch.runtime.discovery import CoordDiscovery, wait_epoch_change
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.virtual import (CursorStore, OwnershipMap,
                                           VirtualBatches, VirtualConfig,
                                           VirtualWorkerLoop)



@pytest.fixture(autouse=True)
def _native_cores():
    """Both packages' native cores, built on first use (in a test, not while
    the module is collected, so xdist workers do not all build at once)."""
    if not (native_available() and jax_native_available()):
        pytest.skip("no C++ toolchain for the native cores")


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
    return x


class NativeTwin:
    """Every call on the reference's native core and the port's, under one
    FakeClock; returns the port's result once both agree."""

    def __init__(self, **kw) -> None:
        self.clock = FakeClock()
        self.ref = JaxNative(clock=self.clock, **kw)
        self.port = NativeCoordService(clock=self.clock, **kw)

    def advance(self, ms: int) -> None:
        self.clock.advance(ms)

    def __getattr__(self, name):
        ref, port = getattr(self.ref, name), getattr(self.port, name)

        def call(*args, **kw):
            a, b = ref(*args, **kw), port(*args, **kw)
            assert _norm(a) == _norm(b), (name, args, a, b)
            return b
        return call

    def check_state(self) -> None:
        assert _norm(self.ref.stats()) == _norm(self.port.stats())
        assert (self.ref.snapshot(include_members=True)
                == self.port.snapshot(include_members=True))
        assert self.ref.stream_version() == self.port.stream_version()
        assert self.ref.fence() == self.port.fence()


@pytest.fixture
def make_service():
    made = []

    def make(**kw):
        t = NativeTwin(**kw)
        made.append(t)
        return t, t.clock

    yield make
    for t in made:
        t.check_state()


# -- tests/test_coord.py, kind="native" -------------------------------------


def test_the_core_builds_out_of_the_source_tree():
    assert bindings.LIB_PATH.parent == bindings.BUILD_DIR
    assert "build/edl_tpu_torch/coord/" in bindings.BUILD_DIR.as_posix()
    assert bindings.SERVER_PATH.exists() and bindings.LIB_PATH.exists()
    assert not list(bindings.NATIVE_DIR.glob("*.o"))
    assert not (bindings.NATIVE_DIR / "build").exists()
    assert isinstance(local_service(), NativeCoordService)
    assert isinstance(local_service(prefer_native=False), PyCoordService)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                         tmp_path):
    """Where make cannot build (here: no compiler at all), the build raises
    with make's message; ``native_available`` turns it into False."""
    monkeypatch.setattr(bindings, "_built", False)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(bindings, "LIB_PATH", tmp_path / "b" / "lib.so")
    monkeypatch.setattr(bindings, "SERVER_PATH", tmp_path / "b" / "srv")
    monkeypatch.setenv("PATH", str(tmp_path))  # no make, no g++
    with pytest.raises(RuntimeError, match="native coordination core"):
        bindings.ensure_built()


def test_lease_complete_done(make_service):
    s, _ = make_service()
    ids = [s.add_task(f"shard-{i}".encode()) for i in range(3)]
    seen = set()
    for _ in range(3):
        status, tid, payload = s.lease("w0")
        assert status == LeaseStatus.OK
        assert payload.startswith(b"shard-")
        seen.add(tid)
        assert s.complete(tid)
    assert seen == set(ids)
    status, _, _ = s.lease("w0")
    assert status == LeaseStatus.DONE
    assert s.all_done()


def test_timeout_redispatch(make_service):
    s, clock = make_service(task_timeout_ms=16_000)
    s.add_task(b"t")
    status, tid, _ = s.lease("dead-worker")
    assert status == LeaseStatus.OK
    status, _, _ = s.lease("w1")
    assert status == LeaseStatus.EMPTY
    s.advance(16_001)
    status, tid2, payload = s.lease("w1")
    assert status == LeaseStatus.OK and payload == b"t"
    assert tid2 == tid
    assert s.complete(tid2)
    assert not s.complete(tid)
    assert s.all_done()


@pytest.mark.parametrize("passes", [1, 3])
def test_fail_requeues_then_drops_poison(make_service, passes):
    """tests/test_coord.py's poison case, and its multi-pass twin
    (test_all_tasks_dropped_multi_pass_terminates)."""
    s, _ = make_service(passes=passes)
    s.add_task(b"poison")
    for _ in range(3):  # max failures = 3
        status, tid, _ = s.lease("w")
        assert status == LeaseStatus.OK
        assert s.fail(tid)
    status, _, _ = s.lease("w")
    assert status == LeaseStatus.DONE  # dropped, not wedged
    assert s.stats().dropped == 1 and s.all_done()


def test_release_worker_returns_leases(make_service):
    s, _ = make_service()
    s.add_task(b"a")
    s.add_task(b"b")
    s.lease("w0")
    s.lease("w0")
    assert s.release_worker("w0") == 2
    st = s.stats()
    assert st.todo == 2 and st.leased == 0


def test_multi_pass_recycles_tasks(make_service):
    s, _ = make_service(passes=2)
    s.add_task(b"x")
    status, tid, _ = s.lease("w")
    s.complete(tid)
    status, tid, payload = s.lease("w")
    assert status == LeaseStatus.OK and payload == b"x"
    s.complete(tid)
    status, _, _ = s.lease("w")
    assert status == LeaseStatus.DONE
    assert s.current_pass() == 1


def test_zero_task_multi_pass_terminates(make_service):
    s, _ = make_service(passes=5)
    status, _, _ = s.lease("w")
    assert status == LeaseStatus.DONE


def test_membership_epochs(make_service):
    s, clock = make_service(member_ttl_ms=15_000)
    e1 = s.join("w0", "host0:1")
    e2 = s.join("w1", "host1:1")
    assert e2 > e1
    epoch, members = s.members()
    assert [m[0] for m in members] == ["w0", "w1"]
    s.advance(10_000)
    assert s.heartbeat("w0")
    assert s.heartbeat("w1")
    s.advance(10_000)
    assert s.heartbeat("w1")
    s.advance(6_000)
    epoch2, members2 = s.members()
    assert [m[0] for m in members2] == ["w1"]
    assert epoch2 > epoch
    assert s.leave("w1")
    assert s.epoch() > epoch2
    assert not s.heartbeat("w0")
    s.join("w0", "host0:1")
    assert s.members()[1] == [("w0", "host0:1")]


def test_kv_and_cas(make_service):
    s, _ = make_service()
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
def test_payload_roundtrip(make_service, payload):
    """test_empty_payload_task and test_large_payload_roundtrip (past the
    bindings' 64 KiB first buffer: grow and retry)."""
    s, _ = make_service()
    s.kv_set("big", payload)
    assert s.kv_get("big") == payload
    tid = s.add_task(payload)
    status, got, out = s.lease("w")
    assert status == LeaseStatus.OK and got == tid and out == payload
    assert s.complete(tid)


# -- the server: tests/test_coord.py's server cases ---------------------------


@pytest.fixture(scope="module")
def server():
    h = spawn_server(port=0, task_timeout_ms=300)
    yield h
    h.stop()


@pytest.mark.timeout_s(60)
def test_server_binary_is_the_ports_build(server):
    assert server.process.args[0] == str(bindings.SERVER_PATH)


@pytest.mark.timeout_s(60)
def test_the_module_entry_point_runs_the_ports_server():
    """``python -m edl_tpu_torch.coord.server --port 0`` execs the port's
    binary, which answers on the port it prints."""
    import re
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.coord.server", "--port", "0",
         "--health-port", "-1"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        for _ in range(10):  # the banner follows any startup notes
            m = re.search(rb"listening on (\d+)", proc.stdout.readline())
            if m:
                break
        port = int(m.group(1))
        assert os.readlink(f"/proc/{proc.pid}/exe") == str(
            bindings.SERVER_PATH)
        assert _raw(port, "PING") == "PONG"
    finally:
        proc.kill()
        proc.wait(10)


@pytest.mark.timeout_s(60)
def test_server_roundtrip(server):
    c = server.client()
    assert c.ping()
    tid = c.add_task(b"hello \x00 binary")
    status, got, payload = c.lease("w0")
    assert status == LeaseStatus.OK and got == tid
    assert payload == b"hello \x00 binary"
    assert c.complete(tid)
    status, _, _ = c.lease("w0")
    assert status == LeaseStatus.DONE
    c.close()


@pytest.mark.timeout_s(60)
def test_server_timeout_redispatch_realtime(server):
    c = server.client()
    c.add_task(b"work")
    status, _, _ = c.lease("dead")
    assert status == LeaseStatus.OK
    time.sleep(0.4)  # server runs with task_timeout_ms=300
    status, t2, payload = c.lease("alive")
    assert status == LeaseStatus.OK and payload == b"work"
    assert c.complete(t2)
    c.close()


@pytest.mark.timeout_s(60)
def test_server_membership_and_kv(server):
    c1, c2 = server.client(), server.client()
    e1 = c1.join("trainer-0", "10.0.0.1:7164")
    e2 = c2.join("trainer-1", "10.0.0.2:7164")
    assert e2 > e1
    _, members = c1.members()
    assert ("trainer-0", "10.0.0.1:7164") in members
    assert ("trainer-1", "10.0.0.2:7164") in members
    assert c1.kv_cas("ckpt/latest", b"", b"step-100")
    assert c2.kv_get("ckpt/latest") == b"step-100"
    assert c2.heartbeat("trainer-1")
    assert c1.leave("trainer-0")
    c1.close(), c2.close()


@pytest.mark.timeout_s(60)
def test_server_concurrent_lease_no_double_grant(server):
    c = server.client()
    n = 50
    for i in range(n):
        c.add_task(f"task-{i}".encode())
    granted: list[int] = []
    lock = threading.Lock()

    def worker(wid):
        cc = server.client()
        while True:
            status, tid, _ = cc.lease(f"w{wid}")
            if status != LeaseStatus.OK:
                break
            with lock:
                granted.append(tid)
            cc.complete(tid)
        cc.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(granted)) == len(granted) >= n
    c.close()


@pytest.mark.timeout_s(60)
def test_server_survives_malformed_commands(server):
    raw = socket.create_connection(("127.0.0.1", server.port))
    raw.sendall(b"COMPLETE abc\nFAIL 99999999999999999999999\nPING\n")
    f = raw.makefile("rb")
    l1, l2, l3 = f.readline(), f.readline(), f.readline()
    assert l1.startswith(b"ERR") and l2.startswith(b"ERR")
    assert l3.strip() == b"PONG"
    raw.close()


@pytest.mark.timeout_s(60)
def test_server_empty_values_and_addresses(server):
    """test_server_empty_kv_value and test_server_join_empty_address."""
    c = server.client()
    c.kv_set("empty", b"")
    assert c.kv_get("empty") == b""
    assert c.kv_cas("empty2", b"", b"")
    assert c.kv_get("empty2") == b""
    c.join("bare-worker")
    assert ("bare-worker", "") in c.members()[1]
    c.leave("bare-worker")
    c.close()


@pytest.mark.timeout_s(60)
def test_health_endpoint_serves_stats_and_404():
    h = spawn_server(port=0, task_timeout_ms=300, health_port=0)
    try:
        assert h.health_port and h.health_port > 0
        c = h.client()
        c.add_task(b"a")
        c.add_task(b"b")
        c.join("w0", "10.0.0.1:1")
        url = f"http://127.0.0.1:{h.health_port}/healthz"
        with urllib.request.urlopen(url, timeout=5) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert doc["status"] == "ok"
        assert doc["tasks"]["todo"] == 2 and doc["members"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{h.health_port}/nope", timeout=5)
        assert e.value.code == 404
        assert c.ping()
        c.close()
    finally:
        h.stop()


@pytest.mark.timeout_s(60)
@pytest.mark.parametrize("health_port", [None, -1])
def test_health_port_disabled(health_port):
    h = spawn_server(port=0, health_port=health_port)
    try:
        assert h.health_port is None
        assert h.client().ping()
    finally:
        h.stop()


def test_backoff_delay_envelope():
    rng = random.Random(42)
    delays = [backoff_delay(a, rng) for a in range(12)]
    for attempt, d in enumerate(delays):
        env = min(BACKOFF_CAP_S, 0.05 * 2 ** attempt)
        assert env / 2 < d <= env, (attempt, d)
    assert backoff_delay(10_000, rng) <= BACKOFF_CAP_S
    assert delays[0] < 0.06


@pytest.mark.timeout_s(60)
def test_client_degraded_hook_fires_during_outage(server):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        CoordClient("127.0.0.1", dead_port, timeout=1.0,
                    reconnect_window_s=0.8)
    assert 0.7 < time.monotonic() - t0 < 10.0
    c = server.client()
    events = []
    c.on_degraded = lambda attempt, elapsed: events.append(("deg", attempt))
    c.on_recovered = lambda outage: events.append(("rec", outage))
    c._sock.shutdown(socket.SHUT_RDWR)
    assert c.ping()
    kinds = [k for k, _ in events]
    assert "deg" in kinds and "rec" in kinds
    assert kinds.index("deg") < kinds.index("rec")
    c.close()


# -- the same protocol script, both packages' servers -------------------------

#: one client's lines, replies deterministic (no clock in them): tasks,
#: membership, KV, waits that fire at once, errors, the HA role, metrics
SCRIPT = [
    "PING", "CONFIG", "ADD 73686172642d30", "ADD 73686172642d31", "ADD -",
    "LEASE w0", "COMPLETE 0 w0", "LEASE w1", "FAIL 1 w1", "RENEW 2 w0",
    "LEASE w1", "RELEASE w1", "STATS", "JOIN a 10.0.0.1:1", "JOIN b -",
    "HB a", "HB ghost", "MEMBERS", "KVSET ckpt/1 2f67656e2d31",
    "KVGET ckpt/1", "KVGET nope", "KVCAS slot - 7730", "KVCAS slot - 7731",
    "KVCAS slot 7730 7731", "KEYS ", "KEYS ckpt/", "KVDEL slot",
    "KVDEL slot", "WAITEPOCH 0 50", "KVWAIT ckpt/1 50 -",
    "KVWAITNE ckpt/1 - 50", "KEEPALIVE a,b,ghost", "LEAVE b", "LEAVE b",
    "MEMBERS", "COMPLETE abc", "NOSUCHVERB", "#7 PING", "ROLE", "STATS",
    "METRICS",
]


def _converse(port: int, script) -> list[bytes]:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.settimeout(5)
        f = s.makefile("rb")
        out = []
        for line in script:
            s.sendall(line.encode() + b"\n")
            out.append(f.readline())
    return out


@pytest.mark.timeout_s(60)
def test_the_same_script_gets_byte_equal_replies():
    kw = dict(port=0, task_timeout_ms=60_000, member_ttl_ms=60_000)
    ref, port = jax_spawn_server(**kw), spawn_server(**kw)
    try:
        a, b = _converse(ref.port, SCRIPT), _converse(port.port, SCRIPT)
    finally:
        ref.stop(), port.stop()
    assert a == b
    assert len(b) == len(SCRIPT) and b[0] == b"PONG\n"
    assert b[SCRIPT.index("KVGET ckpt/1")] == b"OK 2f67656e2d31\n"


# -- tests/test_coord_wait.py: the native core and the native server ---------


@pytest.fixture
def wait_server():
    srv = spawn_server(member_ttl_ms=2000)
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture(params=["native", "native-server"])
def kind(request):
    return request.param


def _service_and_clients(kind, server, n=1):
    """One mutating handle + n independent waiter handles."""
    if kind == "native":
        s = NativeCoordService(member_ttl_ms=2000)
        return s, [s] * n
    return server.client(), [server.client() for _ in range(n)]


@pytest.mark.timeout_s(60)
def test_wait_epoch_fires_on_join_and_honors_timeout(kind, wait_server):
    svc, (waiter,) = _service_and_clients(kind, wait_server)
    svc.join("a")
    known = svc.epoch()
    t0 = time.monotonic()
    assert waiter.wait_epoch(known, timeout_s=0.3) == known
    assert 0.25 <= time.monotonic() - t0 < 2.0
    got = {}

    def park():
        t0 = time.monotonic()
        got["epoch"] = waiter.wait_epoch(known, timeout_s=10.0)
        got["dt"] = time.monotonic() - t0

    t = threading.Thread(target=park)
    t.start()
    time.sleep(0.2)
    svc.join("b")
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["epoch"] != known and got["dt"] < 2.0


@pytest.mark.timeout_s(60)
def test_kv_wait_fires_on_set_and_on_epoch_move(kind, wait_server):
    svc, (w1, w2) = _service_and_clients(kind, wait_server, n=2)
    svc.join("a")
    known = svc.epoch()
    got = {}

    def park_kv():
        got["kv"] = w1.kv_wait("the-key", timeout_s=10.0)

    def park_epoch():
        got["ep"] = w2.kv_wait("never-set", timeout_s=10.0,
                               known_epoch=known)

    t1 = threading.Thread(target=park_kv)
    t2 = threading.Thread(target=park_epoch)
    t1.start(), t2.start()
    time.sleep(0.2)
    svc.kv_set("the-key", b"payload")
    svc.join("b")
    t1.join(timeout=5), t2.join(timeout=5)
    assert got["kv"][0] == b"payload"
    v, ep = got["ep"]
    assert v is None and ep is not None and ep != known
    t0 = time.monotonic()
    assert w1.kv_wait("the-key", timeout_s=10.0)[0] == b"payload"
    assert time.monotonic() - t0 < 1.0  # a present key: at once


@pytest.mark.timeout_s(60)
def test_kv_wait_timeout_vs_fire_ordering(kind, wait_server):
    svc, (w1, w2) = _service_and_clients(kind, wait_server, n=2)
    results = {}

    def short():
        results["short"] = w1.kv_wait("ordered", timeout_s=0.3)

    def long():
        results["long"] = w2.kv_wait("ordered", timeout_s=10.0)

    t1, t2 = threading.Thread(target=short), threading.Thread(target=long)
    t1.start(), t2.start()
    time.sleep(0.6)
    svc.kv_set("ordered", b"late")
    t1.join(timeout=5), t2.join(timeout=5)
    assert results["short"][0] is None
    assert results["long"][0] == b"late"


@pytest.mark.timeout_s(60)
def test_kv_wait_changed_fires_on_a_new_value(kind, wait_server):
    svc, (waiter,) = _service_and_clients(kind, wait_server)
    svc.kv_set("gen", b"1")
    assert waiter.kv_wait_changed("gen", b"1", 0.2) == (False, None)
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "v", waiter.kv_wait_changed("gen", b"1", 10.0)))
    t.start()
    time.sleep(0.2)
    svc.kv_set("gen", b"2")
    t.join(timeout=5)
    assert got["v"] == (True, b"2")


@pytest.mark.timeout_s(60)
def test_waiters_survive_concurrent_churn(kind, wait_server):
    svc, waiters = _service_and_clients(kind, wait_server, n=4)
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

    def parked_epoch(w):
        while not stop.is_set():
            known = w.epoch()
            got = w.wait_epoch(known, timeout_s=0.5)
            with lock:
                outcomes.append((known, got))

    churners = [threading.Thread(target=churner, args=(i,))
                for i in range(3)]
    parkers = [threading.Thread(target=parked_epoch, args=(w,))
               for w in waiters]
    for t in churners + parkers:
        t.start()
    for t in churners:
        t.join(timeout=30)
    stop.set()
    for t in parkers:
        t.join(timeout=10)
        assert not t.is_alive(), "parked waiter wedged through churn"
    assert [o for o in outcomes if o[0] != o[1]]


@pytest.mark.timeout_s(60)
def test_wait_epoch_fires_on_ttl_expiry(kind, wait_server):
    svc, (waiter,) = _service_and_clients(kind, wait_server)
    svc.join("dies")
    known = svc.epoch()
    t0 = time.monotonic()
    got = waiter.wait_epoch(known, timeout_s=10.0)
    assert got != known, "TTL expiry never fired the waiter"
    assert time.monotonic() - t0 < 5.0


@pytest.mark.timeout_s(60)
def test_wait_members_event_driven(kind, wait_server):
    svc, (waiter,) = _service_and_clients(kind, wait_server)
    d = CoordDiscovery(waiter, "me", "addr0")
    d.join()
    got = {}

    def park():
        got["peers"] = d.wait_members(3, timeout_s=10.0)

    t = threading.Thread(target=park)
    t.start()
    time.sleep(0.1)
    svc.join("p1", "addr1")
    svc.join("p2", "addr2")
    t.join(timeout=5)
    assert [n for n, _ in got["peers"]] == ["me", "p1", "p2"]


@pytest.mark.timeout_s(60)
def test_parked_waiters_do_not_thundering_herd(wait_server):
    mut = wait_server.client()
    mut.join("a")
    known = mut.epoch()
    waiters = [wait_server.client() for _ in range(4)]
    before = mut.server_metrics()
    threads = [threading.Thread(target=w.wait_epoch, args=(known, 1.8))
               for w in waiters]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    after = mut.server_metrics()
    requests = after["requests_served"] - before["requests_served"] - 1
    assert requests <= 20, requests
    assert after["longpolls_parked"] > before["longpolls_parked"]
    w = wait_server.client()
    t = threading.Thread(target=w.wait_epoch, args=(mut.epoch(), 10.0))
    t.start()
    time.sleep(0.2)
    mut.join("b")
    t.join(timeout=5)
    assert mut.server_metrics()["longpolls_fired"] >= 1


def test_wait_epoch_change_falls_back_without_longpoll():
    class Minimal:
        def __init__(self):
            self._e = 0

        def epoch(self):
            return self._e

    m = Minimal()

    def bump():
        time.sleep(0.2)
        m._e = 1

    threading.Thread(target=bump).start()
    assert wait_epoch_change(m, 0, timeout_s=5.0, poll_s=0.02) == 1


# -- tests/test_coord_ha.py: snapshot parity across the packages --------------


def _populate(svc):
    svc.add_task(b"shard-0")
    svc.add_task(b"shard-1")
    _, tid, _ = svc.lease("w0")
    svc.complete(tid, "w0")
    svc.join("w0", "addr-0")
    svc.join("w1", "addr-1")
    svc.kv_set("ckpt/2", b"/gen-2")


class TestSnapshotParity:
    def test_reference_python_blob_restores_into_the_ports_native(self):
        py = JaxPy()
        _populate(py)
        native = NativeCoordService()
        assert native.restore_repl(py.snapshot(include_members=True))
        assert native.kv_get("ckpt/2") == b"/gen-2"
        assert native.stats().todo == 1 and native.stats().done == 1
        epoch, members = native.members()
        assert members == [("w0", "addr-0"), ("w1", "addr-1")]
        assert epoch == py.epoch()

    def test_ports_native_blob_restores_into_the_reference_python(self):
        native = NativeCoordService()
        _populate(native)
        py = JaxPy(role="standby")
        py.sync_from(0, 7, native.snapshot(include_members=True))
        py.promote(1)
        assert py.kv_get("ckpt/2") == b"/gen-2"
        assert py.stats().todo == 1 and py.stats().done == 1
        assert py.members()[1] == [("w0", "addr-0"), ("w1", "addr-1")]

    def test_empty_fields_survive_both_ways(self):
        py = JaxPy()
        py.join("w0")
        py.kv_set("flag", b"")
        py.add_task(b"")
        native = NativeCoordService()
        assert native.restore_repl(py.snapshot(include_members=True))
        assert native.members()[1] == [("w0", "")]
        assert native.kv_get("flag") == b""
        st, _tid, payload = native.lease("w")
        assert st.name == "OK" and payload == b""
        py2 = JaxPy(role="standby")
        py2.sync_from(0, 9, native.snapshot(include_members=True))
        py2.promote(1)
        assert py2.members()[1] == [("w0", "")]
        assert py2.kv_get("flag") == b""

    def test_torn_blob_is_refused(self):
        native = NativeCoordService()
        native.kv_set("k", b"v")
        assert not native.restore("EDLCOORD1\ntruncated")
        assert native.kv_get("k") == b"v"
        with pytest.raises(ValueError):
            native.apply_delta("EDLDELTA1\ntorn")

    def test_the_ports_python_and_native_blobs_are_one_format(self):
        py, native = PyCoordService(), NativeCoordService()
        for svc in (py, native):
            _populate(svc)
        assert py.snapshot() == native.snapshot()


# -- tests/test_coord_ha.py::TestNativePair -----------------------------------


def _kill9(handle) -> None:
    handle.process.send_signal(signal.SIGKILL)
    handle.process.wait(timeout=10)


def _wait_stopped(pid: int, timeout_s: float = 5.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] == "T":
                return
        time.sleep(0.01)
    raise TimeoutError(f"pid {pid} never stopped")


def _raw(port: int, line: str, timeout: float = 3.0) -> str:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall((line + "\n").encode())
        return s.makefile("rb").readline().decode().strip()


def _ha_client(primary, standby, **kw):
    kw.setdefault("timeout", 2.0)
    kw.setdefault("reconnect_window_s", 12.0)
    kw.setdefault("promote_grace_s", 0.2)
    return CoordClient("127.0.0.1", primary.port,
                       endpoints=[("127.0.0.1", standby.port)], **kw)


@pytest.mark.timeout_s(90)
class TestNativePair:
    def test_failover_preserves_state_and_membership(self, tmp_path):
        pr, sb = spawn_ha_pair(str(tmp_path), member_ttl_ms=5000,
                               repl_lease_ms=1000)
        assert pr.process.args[0] == str(bindings.SERVER_PATH)
        c = _ha_client(pr, sb)
        try:
            c.add_task(b"shard-0")
            c.kv_set("ckpt/1", b"/gen-1")
            assert c.join("w0", "a0") == 1
            before = get_counters().get("coord_failovers")
            _kill9(pr)
            assert c.kv_get("ckpt/1") == b"/gen-1"
            assert (c.host, c.port) == ("127.0.0.1", sb.port)
            assert get_counters().get("coord_failovers") == before + 1
            assert c.stats().todo == 1
            assert c.heartbeat("w0")
            assert c.epoch() == 1
            assert _raw(sb.port, "ROLE").startswith("OK primary 1 ")
        finally:
            c.close()
            pr.stop()
            sb.stop()

    def test_longpoll_reparks_on_promoted_standby(self, tmp_path):
        pr, sb = spawn_ha_pair(str(tmp_path), member_ttl_ms=5000,
                               repl_lease_ms=1000)
        c = _ha_client(pr, sb)
        fired = []
        try:
            c.join("w0", "a0")
            t = threading.Thread(
                target=lambda: fired.append(c.wait_epoch(1, 20.0)))
            t.start()
            time.sleep(0.3)
            _kill9(pr)
            c2 = _ha_client(sb, sb)
            try:
                c2.join("w1", "a1")
            finally:
                c2.close()
            t.join(timeout=15)
            assert fired == [2], fired
        finally:
            c.close()
            pr.stop()
            sb.stop()

    def test_gc_paused_primary_comes_back_fenced(self, tmp_path):
        pr, sb = spawn_ha_pair(str(tmp_path), member_ttl_ms=10000,
                               repl_lease_ms=300)
        c = _ha_client(pr, sb)
        try:
            c.kv_set("k", b"v")
            c.join("w0", "a0")
            pr.process.send_signal(signal.SIGSTOP)
            _wait_stopped(pr.process.pid)
            assert c.kv_get("k") == b"v"
            assert (c.host, c.port) == ("127.0.0.1", sb.port)
            pr.process.send_signal(signal.SIGCONT)
            time.sleep(0.1)
            assert _raw(pr.port, "KVSET k 646561").startswith("ERR fenced")
            assert _raw(pr.port, "KVGET k").startswith("ERR fenced")
            assert _raw(pr.port, "WAITEPOCH 0 100").startswith("ERR fenced")
            assert _raw(pr.port, "ROLE").startswith("OK fenced")
            before = get_counters().get("coord_fencing_rejects")
            c_stale = CoordClient("127.0.0.1", pr.port, timeout=1.0,
                                  reconnect_window_s=0.8)
            t0 = time.monotonic()
            with pytest.raises(CoordUnavailable):
                c_stale.kv_get("k")
            assert time.monotonic() - t0 < 2 * 0.8 + 1.0
            assert get_counters().get("coord_fencing_rejects") > before
            c_stale.close()
            assert c.kv_get("k") == b"v"
        finally:
            c.close()
            pr.stop()
            sb.stop()

    def test_all_endpoints_dead_returns_within_twice_budget(self, tmp_path):
        pr, sb = spawn_ha_pair(str(tmp_path))
        budget = 1.5
        c = _ha_client(pr, sb, reconnect_window_s=budget)
        try:
            c.kv_set("k", b"v")
            _kill9(pr)
            _kill9(sb)
            t0 = time.monotonic()
            with pytest.raises(CoordUnavailable):
                c.kv_get("k")
            assert time.monotonic() - t0 < 2 * budget
            t0 = time.monotonic()
            with pytest.raises(CoordUnavailable):
                CoordClient("127.0.0.1", pr.port, timeout=1.0,
                            reconnect_window_s=budget,
                            endpoints=[("127.0.0.1", sb.port)])
            assert time.monotonic() - t0 < 2 * budget + 1.0
        finally:
            c.close()
            pr.stop()
            sb.stop()

    def test_second_standby_catches_up_after_outage(self, tmp_path):
        sb1 = spawn_server(standby=True,
                           state_file=str(tmp_path / "b1.state"))
        sb2 = spawn_server(standby=True,
                           state_file=str(tmp_path / "b2.state"))
        pr = spawn_server(
            state_file=str(tmp_path / "a.state"),
            replicate_to=f"127.0.0.1:{sb1.port},127.0.0.1:{sb2.port}",
            repl_lease_ms=600)
        c = CoordClient("127.0.0.1", pr.port, timeout=2.0,
                        reconnect_window_s=8.0)
        try:
            c.kv_set("k", b"v1")
            _kill9(sb2)
            c.kv_set("k", b"v2")
            sv = int(_raw(pr.port, "ROLE").split(" ")[3])
            assert int(_raw(sb1.port, "ROLE").split(" ")[3]) == sv
            sb2b = spawn_server(port=sb2.port, standby=True,
                                state_file=str(tmp_path / "b2.state"))
            deadline = time.monotonic() + 10
            caught_up = -1
            while time.monotonic() < deadline:
                caught_up = int(_raw(sb2.port, "ROLE").split(" ")[3])
                if caught_up >= sv:
                    break
                time.sleep(0.1)
            assert caught_up >= sv, (caught_up, sv)
            assert _raw(sb2.port, "PROMOTE 1").startswith("OK 1 ")
            assert _raw(sb2.port, "KVGET k") == "OK " + b"v2".hex()
            sb2b.stop()
        finally:
            c.close()
            pr.stop()
            sb1.stop()
            sb2.stop()

    def test_respawned_old_primary_rejoins_as_standby(self, tmp_path):
        pr, sb = spawn_ha_pair(str(tmp_path), repl_lease_ms=500)
        c = _ha_client(pr, sb)
        try:
            c.kv_set("k", b"v1")
            old_port = pr.port
            _kill9(pr)
            assert c.kv_get("k") == b"v1"
            pr2 = spawn_server(port=old_port, standby=True,
                               state_file=str(tmp_path / "coord-a.state"),
                               repl_lease_ms=500)
            assert _raw(c.port, f"REPLICATE 127.0.0.1:{old_port}") == "OK"
            c.kv_set("k", b"v2")
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                role = _raw(old_port, "ROLE").split(" ")
                if int(role[3]) >= 2:
                    break
                time.sleep(0.05)
            assert role[1] == "standby" and role[2] == "1", role
            _kill9(sb)
            assert c.kv_get("k") == b"v2"
            assert (c.host, c.port) == ("127.0.0.1", old_port)
            assert _raw(old_port, "ROLE").startswith("OK primary 2 ")
            pr2.stop()
        finally:
            c.close()
            pr.stop()
            sb.stop()


# -- tests/test_coord_durability.py -------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout_s(90)
class TestDurability:
    def test_state_survives_kill9_restart(self, tmp_path):
        state = str(tmp_path / "coord.state")
        srv = spawn_server(member_ttl_ms=3000, task_timeout_ms=60000,
                           state_file=state)
        try:
            c = srv.client()
            for i in range(8):
                c.add_task(f"shard-{i}".encode())
            _, id1, _ = c.lease("w0")
            _, id2, _ = c.lease("w0")
            assert c.complete(id1, "w0")
            c.kv_set("ckpt/3", b"/ckpt/gen-3")
            assert c.join("w0") == 1
            assert c.join("w1") == 2
            pre = c.stats()
            assert (pre.todo, pre.leased, pre.done) == (6, 1, 1)
        finally:
            _kill9(srv)
        srv2 = spawn_server(member_ttl_ms=3000, task_timeout_ms=60000,
                            state_file=state)
        try:
            c = srv2.client()
            s = c.stats()
            assert (s.todo, s.leased, s.done, s.dropped) == (7, 0, 1, 0)
            assert c.kv_get("ckpt/3") == b"/ckpt/gen-3"
            epoch, members = c.members()
            assert epoch >= 2 and members == []
            assert not c.complete(id2, "w0")
            seen = set()
            while True:
                st, tid, payload = c.lease("w1")
                if st.name != "OK":
                    break
                assert payload not in seen
                seen.add(payload)
                assert c.complete(tid, "w1")
            s = c.stats()
            assert s.done == 8 and s.todo == 0 and s.dropped == 0
        finally:
            _kill9(srv2)

    def test_lease_driven_rollover_survives_kill9(self, tmp_path):
        state = str(tmp_path / "coord.state")
        srv = spawn_server(task_timeout_ms=60000, state_file=state, passes=2)
        try:
            c = srv.client()
            for i in range(2):
                c.add_task(f"shard-{i}".encode())
            for _ in range(2):
                st, tid, _ = c.lease("w0")
                assert c.complete(tid, "w0")
            st, tid, _ = c.lease("w0")
            assert st.name == "OK" and c.stats().current_pass == 1
        finally:
            _kill9(srv)
        srv2 = spawn_server(task_timeout_ms=60000, state_file=state,
                            passes=2)
        try:
            s = srv2.client().stats()
            assert s.current_pass == 1
            assert (s.todo, s.leased, s.done, s.dropped) == (2, 0, 0, 0)
        finally:
            _kill9(srv2)

    def test_power_loss_mid_persist_keeps_last_acked_snapshot(self,
                                                             tmp_path):
        from edl_tpu_torch.coord.client import CoordError

        state = str(tmp_path / "coord.state")
        srv = spawn_server(state_file=state, crash_on_persist="3:tmp")
        c = CoordClient("127.0.0.1", srv.port, reconnect_window_s=1.0)
        c.add_task(b"shard-0")
        c.kv_set("ckpt/latest", b"/ckpt/gen-7")
        with pytest.raises((CoordError, OSError)):
            c.kv_set("ckpt/latest", b"/ckpt/gen-8")
        srv.process.wait(timeout=10)
        assert srv.process.returncode == 137
        assert (tmp_path / "coord.state.tmp").exists()
        srv2 = spawn_server(state_file=state)
        try:
            c2 = srv2.client()
            assert c2.kv_get("ckpt/latest") == b"/ckpt/gen-7"
            s = c2.stats()
            assert (s.todo, s.done) == (1, 0)
        finally:
            _kill9(srv2)

    def test_durable_but_unacked_converges_on_retry(self, tmp_path):
        state = str(tmp_path / "coord.state")
        port = _free_port()
        srv = spawn_server(port=port, state_file=state,
                           crash_on_persist="2:acked")
        c = srv.client()
        c.kv_set("a", b"1")
        result: dict = {}

        def do_set():
            try:
                c.kv_set("b", b"2")
                result["ok"] = True
            except Exception as exc:  # pragma: no cover - fails the test
                result["error"] = str(exc)

        t = threading.Thread(target=do_set)
        t.start()
        srv.process.wait(timeout=10)
        assert srv.process.returncode == 137
        srv2 = spawn_server(port=port, state_file=state)
        try:
            t.join(timeout=30)
            assert result.get("ok"), result
            c2 = srv2.client()
            assert c2.kv_get("a") == b"1"
            assert c2.kv_get("b") == b"2"
        finally:
            _kill9(srv2)

    def test_client_reconnects_across_restart(self, tmp_path):
        state = str(tmp_path / "coord.state")
        port = _free_port()
        srv = spawn_server(port=port, state_file=state)
        c = srv.client()
        c.kv_set("k", b"v1")
        _kill9(srv)
        srv2 = spawn_server(port=port, state_file=state)
        try:
            assert c.kv_get("k") == b"v1"
            c.kv_set("k", b"v2")
            assert c.kv_get("k") == b"v2"
        finally:
            _kill9(srv2)


# -- tests/test_accuracy_elasticity.py: a coordinator failover mid-run --------

CFG = VirtualConfig(vw_count=8, global_batch=64, job_seed=3)
MLP_PARAMS = jax.tree.map(np.asarray,
                          jmlp.init(jax.random.key(0), [16, 32, 4]))


def _loop(kv=None, job="job", on_step=None):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, 2048).astype(np.int32)
    x = rng.normal(size=(2048, 16)).astype(np.float32)
    reg = ShardRegistry()
    ids = reg.register_arrays((x, y), num_shards=16)
    model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                      MLP_PARAMS)
    trainer = ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                             devices=[torch.device("cpu")],
                             accum_mode="replicated")
    loop = VirtualWorkerLoop(trainer, CFG,
                             VirtualBatches(CFG, ids, reg.get, passes=2),
                             kv=kv, job=job)
    return loop.run(max_steps=16, on_step=on_step)


@pytest.mark.timeout_s(120)
def test_coordinator_failover_preserves_cursors_and_equivalence(tmp_path):
    """Coordinator-primary SIGKILL mid-run: the ownership map and cursors
    ride HA replication, the client fails over, the run completes, and the
    trajectory still equals the control's, bitwise."""
    ctrl = _loop()
    pr, sb = spawn_ha_pair(str(tmp_path), repl_lease_ms=1000)
    client = CoordClient("127.0.0.1", pr.port, timeout=2.0,
                         reconnect_window_s=12.0, promote_grace_s=0.2,
                         endpoints=[("127.0.0.1", sb.port)])
    killed = []

    def on_step(step, loss, world):
        if step == 8 and not killed:
            killed.append(True)
            pr.process.send_signal(signal.SIGKILL)
            pr.process.wait(timeout=10)

    try:
        res = _loop(kv=client, job="ha", on_step=on_step)
        assert killed and ctrl.losses == res.losses
        assert (client.host, client.port) == ("127.0.0.1", sb.port)
        assert CursorStore(client, job="ha").load()["step"] == 16
        assert OwnershipMap.load(client, job="ha") is not None
        assert res.rows_duplicated() == 0
    finally:
        client.close()
        pr.stop()
        sb.stop()
