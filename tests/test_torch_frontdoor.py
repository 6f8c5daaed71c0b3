"""The port's async serving front door (edl_tpu_torch.runtime.frontdoor)
on the CPU: tests/test_frontdoor.py's scenarios — keep-alive and
pipelining, the f32 fast path against the JSON contract, bounded-admission
429s, the priority shed order, the ready gate, the satellite units, the
request spans and the loop-lag probe — on the MLP [16, 32, 4] holding the
JAX init, every answer held to the JAX package's ``mlp.apply`` within
1e-5 (fp32).

Beyond the reference's list, parity on the same bytes: one pipelined
request stream goes into the reference's front door and the port's (over
``FleetApp`` and ``BatchApp`` alike), and the status lines, their order,
the echoed ``X-EDL-Trace-Id`` / ``X-EDL-Block-Nonce`` and the outputs must
agree; ``HeadMeta`` gives the reference's fields on a fixed corpus of heads,
the bad ones included; the ready-gate value round-trips across the
packages; histograms with and without exemplars render byte-identically to
the reference's; ``/generate`` over a TINY ``DecodeFleet`` answers the
full-context greedy tokens, as the reference's ``FleetApp`` does."""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from edl_tpu.runtime import frontdoor as jfd
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime import frontdoor as tfd
from edl_tpu_torch.runtime.frontdoor import (
    FD_READY,
    BatchApp,
    FleetApp,
    FrontDoor,
    build_predict_request,
    format_serving_addr,
    parse_serving_addr,
)
from edl_tpu_torch.runtime.serving import ServeRequest
from tests.torch_wire import (
    ATOL,
    MODEL,
    SIZES,
    connect,
    json_request,
    port_server,
    read_raw_responses,
    read_responses,
    ref_out,
)

pytestmark = pytest.mark.timeout_s(120)


def make_replica(job, *, max_batch=16, max_queue_ms=1.0, kv=None,
                 replica="r0", hard_cap_rows=4096, soft_cap_rows=0,
                 build_gate=None):
    def build():
        if build_gate is not None:
            build_gate.wait(30)
        return port_server()

    app = BatchApp(build, SIZES[0], job=job, replica=replica,
                   max_batch=max_batch, max_queue_ms=max_queue_ms,
                   hard_cap_rows=hard_cap_rows,
                   soft_cap_rows=soft_cap_rows, kv=kv, addr_ttl_s=5.0)
    door = FrontDoor(app, host="127.0.0.1", job=job).start()
    return app, door


class TestFrontDoor:
    @classmethod
    def setup_class(cls):
        cls.app, cls.door = make_replica("tfdtest/pipe")
        assert cls.app.wait_ready(120)

    @classmethod
    def teardown_class(cls):
        cls.door.stop()

    def test_keepalive_pipelining_in_order(self):
        """N pipelined requests over ONE connection come back as N
        in-order responses, each row's output the JAX package's — and the
        door saw one connection for all of them."""
        conns_before = self.door.connections
        n = 32
        rows = [np.full((SIZES[0],), i, np.float32) for i in range(n)]
        blob = b"".join(build_predict_request(r) for r in rows)
        s = connect(self.door.port)
        s.sendall(blob)
        resps = read_responses(s, n)
        s.close()
        ref = ref_out(np.stack(rows))
        for i, (status, body) in enumerate(resps):
            assert status == 200
            np.testing.assert_allclose(np.frombuffer(body, "<f4"), ref[i],
                                       atol=ATOL, rtol=ATOL)
        assert self.door.connections == conns_before + 1

    def test_json_contract_matches_f32(self):
        row = np.arange(SIZES[0], dtype=np.float32)
        s = connect(self.door.port)
        s.sendall(json_request(row) + build_predict_request(row))
        (st1, b1), (st2, b2) = read_responses(s, 2)
        s.close()
        assert st1 == 200 and st2 == 200
        out_json = np.asarray(json.loads(b1.decode())["outputs"])
        out_f32 = np.frombuffer(b2, "<f4")
        np.testing.assert_allclose(out_json, out_f32, atol=ATOL)
        np.testing.assert_allclose(out_f32, ref_out(row[None])[0],
                                   atol=ATOL, rtol=ATOL)

    def test_mixed_pipelining_order_held(self):
        """A JSON request sandwiched between f32 runs: responses come
        back in request order (the pending-ring guarantee)."""
        row = np.ones((SIZES[0],), np.float32)
        freq = build_predict_request(row)
        s = connect(self.door.port)
        s.sendall(freq * 3 + json_request(row) + freq * 3)
        resps = read_responses(s, 7)
        s.close()
        assert [st for st, _ in resps] == [200] * 7
        assert b"outputs" in resps[3][1]  # the JSON one is the 4th
        for i in (0, 1, 2, 4, 5, 6):
            assert b"outputs" not in resps[i][1]

    def test_healthz(self):
        s = connect(self.door.port)
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
        (status, _), = read_responses(s, 1)
        s.close()
        assert status == 200


def test_ready_gate_503_until_built():
    gate = threading.Event()
    app, door = make_replica("tfdtest/gate", build_gate=gate)
    try:
        s = connect(door.port)
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
        (status, _), = read_responses(s, 1)
        assert status == 503  # still building
        gate.set()
        assert app.wait_ready(120)
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
        (status, _), = read_responses(s, 1)
        assert status == 200
        s.close()
    finally:
        gate.set()
        door.stop()


def test_failed_build_503s_and_wait_ready_false():
    """A replica whose build dies answers fast 503s and ``wait_ready``
    reports the failure instead of True-on-dead."""
    def broken():
        raise RuntimeError("synthetic build failure")

    app = BatchApp(broken, SIZES[0], job="tfdtest/deadbuild")
    door = FrontDoor(app, host="127.0.0.1", job="tfdtest/deadbuild").start()
    try:
        assert app.wait_ready(30) is False
        assert app.failed
        s = connect(door.port)
        s.sendall(build_predict_request(np.zeros((SIZES[0],), np.float32)))
        t0 = time.perf_counter()
        (status, _), = read_responses(s, 1, timeout=10)
        assert status == 503
        assert time.perf_counter() - t0 < 5.0  # fast, not a hang
        s.close()
    finally:
        door.stop()


def test_drain_never_clobbered_by_reload():
    """A reload never regates a DRAINING replica back to READY: refused at
    entry, and via the CAS if the drain lands mid-swap."""
    from edl_tpu_torch.runtime.frontdoor import FD_DRAINING, FD_RELOADING

    app = BatchApp(port_server, SIZES[0], job="tfdtest/drainrace")
    door = FrontDoor(app, host="127.0.0.1", job="tfdtest/drainrace").start()
    try:
        assert app.wait_ready(120)
        app._set_state(FD_DRAINING)
        assert app.swap_weights(MODEL, 2) is False  # refused at entry
        assert app.state == FD_DRAINING
        assert app._set_state_if(FD_RELOADING, FD_READY) is False
        assert app.state == FD_DRAINING
    finally:
        door.stop()


def test_huge_and_negative_content_length_rejected():
    """A Content-Length past max_body_bytes is a 413 and a close before
    anything is buffered; a negative one a 400; a Transfer-Encoding body
    a 411 and a close."""
    app, door = make_replica("tfdtest/bodycap")
    assert app.wait_ready(120)
    try:
        for head, want in (
                (b"Content-Length: 4294967296\r\n\r\n", 413),
                (b"Content-Length: -5\r\n\r\n", 400),
                (b"Transfer-Encoding: chunked\r\n\r\n"
                 b"5\r\nhello\r\n0\r\n\r\n", 411)):
            s = connect(door.port)
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n" + head)
            (st, _), = read_responses(s, 1, timeout=10)
            assert st == want
            assert s.recv(1 << 16) == b""  # connection closed
            s.close()
    finally:
        door.stop()


def test_start_surfaces_bind_error():
    """A listener bind failure raises from start() with the real cause at
    once, not after a 30 s wait."""
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]

    class NullApp:
        wants_raw = False

    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="failed to start"):
            FrontDoor(NullApp(), host="127.0.0.1", port=port,
                      job="tfdtest/bind").start()
        assert time.monotonic() - t0 < 10
    finally:
        blocker.close()


def test_failed_swap_keeps_batcher_alive():
    """Incompatible weights do not kill the batcher: the swap reports
    False, the old generation keeps serving, the failure is counted."""
    app = BatchApp(port_server, SIZES[0], job="tfdtest/badswap")
    door = FrontDoor(app, host="127.0.0.1", job="tfdtest/badswap").start()
    try:
        assert app.wait_ready(120)
        c = get_counters()
        fails0 = c.get("serving_reload_failures", job="tfdtest/badswap")
        orig = app.server.load_params

        def boom(params):
            raise RuntimeError("synthetic corrupt weights")

        app.server.load_params = boom
        try:
            assert app.swap_weights(MODEL, 2, timeout_s=10) is False
        finally:
            app.server.load_params = orig
        assert app.state == FD_READY
        assert app.generation == 0
        assert c.get("serving_reload_failures",
                     job="tfdtest/badswap") == fails0 + 1
        s = connect(door.port)
        row = np.ones((SIZES[0],), np.float32)
        s.sendall(build_predict_request(row))
        (st, body), = read_responses(s, 1, timeout=10)
        assert st == 200
        np.testing.assert_allclose(np.frombuffer(body, "<f4"),
                                   ref_out(row[None])[0], atol=ATOL)
        s.close()
    finally:
        door.stop()


@pytest.mark.parametrize("n", [1, 3, 21])
def test_short_chunks_served_unpadded(n):
    """The port's forward takes any batch: ``n`` pipelined rows are served
    in chunks of at most ``max_batch`` (8) holding only the real rows, each
    chunk a fresh C-contiguous float32 array, and every answer is the JAX
    package's.  A first request on the connection arms the door's
    fixed-stride path, so the rows after it are views into the request
    bytes (a lone row keeps the request's stride until it is copied)."""
    job = f"tfdtest/unpadded{n}"
    shapes = []

    def build():
        srv = port_server()
        serve = srv.serve

        def record(batch):
            x = batch[0]
            shapes.append((x.shape, x.dtype, x.flags.c_contiguous,
                           x.strides))
            return serve(batch)

        srv.serve = record
        return srv

    app = BatchApp(build, SIZES[0], job=job, max_batch=8, max_queue_ms=50.0)
    door = FrontDoor(app, host="127.0.0.1", job=job).start()
    try:
        assert app.wait_ready(120)
        shapes.clear()  # the warm-up's
        rows = np.random.default_rng(n).normal(
            size=(n, SIZES[0])).astype(np.float32)
        s = connect(door.port)
        s.sendall(build_predict_request(rows[0]))
        read_responses(s, 1, timeout=10)
        s.sendall(b"".join(build_predict_request(r) for r in rows))
        resps = read_responses(s, n, timeout=10)
        s.close()
        ref = ref_out(rows)
        for (st, body), want in zip(resps, ref):
            assert st == 200
            np.testing.assert_allclose(np.frombuffer(body, "<f4"), want,
                                       atol=ATOL, rtol=ATOL)
        assert sum(shape[0] for shape, *_ in shapes) == n + 1
        for shape, dtype, contiguous, strides in shapes:
            assert 1 <= shape[0] <= 8 and shape[1] == SIZES[0]
            assert dtype == np.float32 and contiguous
            assert strides == (4 * SIZES[0], 4)
    finally:
        door.stop()


def test_pipelined_error_never_overtakes_earlier_response():
    app, door = make_replica("tfdtest/errorder")
    assert app.wait_ready(120)
    try:
        s = connect(door.port)
        good = build_predict_request(np.ones((SIZES[0],), np.float32))
        bad = (b"POST /predict HTTP/1.1\r\nHost: t\r\n"
               b"Content-Length: -5\r\n\r\n")
        s.sendall(good + bad)
        (st1, _), (st2, _) = read_responses(s, 2, timeout=10)
        assert (st1, st2) == (200, 400)
        assert s.recv(1 << 16) == b""  # closed after the ordered flush
        s.close()
    finally:
        door.stop()


def test_standby_survives_weight_reload():
    """A warm STANDBY stays unroutable through a reload; activate opens
    the gate, and never revives a draining replica."""
    from edl_tpu_torch.runtime.frontdoor import FD_DRAINING, FD_STANDBY

    app = BatchApp(port_server, SIZES[0], job="tfdtest/standby",
                   standby=True)
    door = FrontDoor(app, host="127.0.0.1", job="tfdtest/standby").start()
    try:
        assert app.wait_ready(120)
        assert app.state == FD_STANDBY
        assert app.swap_weights(MODEL, 2)
        assert app.generation == 2
        assert app.state == FD_STANDBY
        activate = (b"POST /admin/activate HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: 0\r\n\r\n")
        s = connect(door.port)
        s.sendall(activate)
        (st, _), = read_responses(s, 1)
        assert st == 200 and app.state == FD_READY
        app._set_state(FD_DRAINING)
        s.sendall(activate)
        (st, _), = read_responses(s, 1)
        s.close()
        assert st == 409 and app.state == FD_DRAINING
    finally:
        door.stop()


class TestOverload:
    @classmethod
    def setup_class(cls):
        cls.app, cls.door = make_replica(
            "tfdtest/overload", max_batch=8, max_queue_ms=0.5,
            hard_cap_rows=32, soft_cap_rows=16)
        assert cls.app.wait_ready(120)

    @classmethod
    def teardown_class(cls):
        cls.door.stop()

    def _blast(self, n, priority=None, stall_ms=200):
        self.app._stall_once_ms = stall_ms
        row = np.ones((SIZES[0],), np.float32)
        blob = b"".join(build_predict_request(row, priority=priority)
                        for _ in range(n))
        s = connect(self.door.port)
        s.sendall(build_predict_request(row))  # opens the stalled iteration
        time.sleep(0.05)
        s.sendall(blob)
        resps = read_responses(s, n + 1)
        s.close()
        tally = {}
        for st, _ in resps:
            tally[st] = tally.get(st, 0) + 1
        return tally

    def test_backpressure_degrades_to_429(self):
        c = get_counters()
        before = c.get("frontdoor_overload_sheds", job="tfdtest/overload",
                       priority="normal")
        tally = self._blast(200)
        assert tally.get(200, 0) >= 1
        assert tally.get(429, 0) >= 1
        assert sum(tally.values()) == 201
        assert c.get("frontdoor_overload_sheds", job="tfdtest/overload",
                     priority="normal") > before

    def test_priority_shed_order(self):
        """low sheds at the soft watermark while normal still admits;
        high admits past the hard cap's reserve band."""
        c = get_counters()
        job = "tfdtest/overload"
        deadline = time.monotonic() + 20
        while self.app._queued_rows > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert self.app._queued_rows == 0
        self.app._stall_once_ms = 300
        row = np.ones((SIZES[0],), np.float32)
        s = connect(self.door.port)
        s.sendall(build_predict_request(row) * 16)
        time.sleep(0.05)
        low_before = c.get("frontdoor_overload_sheds", job=job,
                           priority="low")
        s.sendall(build_predict_request(row, priority="low"))
        s.sendall(build_predict_request(row, priority="normal"))
        s.sendall(build_predict_request(row, priority="high"))
        statuses = [st for st, _ in read_responses(s, 19)]
        s.close()
        assert statuses[:16] == [200] * 16
        assert statuses[16:] == [429, 200, 200]
        assert c.get("frontdoor_overload_sheds", job=job,
                     priority="low") == low_before + 1


def test_json_path_respects_admission_caps():
    app, door = make_replica("tfdtest/jsoncap", max_batch=8,
                             max_queue_ms=0.5, hard_cap_rows=8,
                             soft_cap_rows=4)
    assert app.wait_ready(120)
    try:
        app._stall_once_ms = 300  # wedge so the queue builds
        row = np.ones((SIZES[0],), np.float32)
        s = connect(door.port)
        s.sendall(build_predict_request(row))
        time.sleep(0.05)
        s.sendall(json_request(row) * 20)
        resps = read_responses(s, 21, timeout=30)
        s.close()
        tally = {}
        for st, _ in resps:
            tally[st] = tally.get(st, 0) + 1
        assert tally.get(429, 0) > 0, tally
        assert tally.get(200, 0) >= 1, tally
    finally:
        door.stop()


def test_fleet_app_request_timeout_500():
    class WedgedFleet:
        generation = 1

        def replicas_ready(self):
            return 1

        def submit(self, batch, trace_id=None, parent_span=None):
            return ServeRequest(payload=batch)  # never completed

    app = FleetApp(WedgedFleet(), SIZES[0], timeout_s=0.5)
    door = FrontDoor(app, host="127.0.0.1", job="tfdtest/fleettmo").start()
    try:
        s = connect(door.port)
        s.sendall(build_predict_request(np.ones((SIZES[0],), np.float32)))
        t0 = time.monotonic()
        (st, _), = read_responses(s, 1, timeout=15)
        assert st == 500
        assert time.monotonic() - t0 < 10
        s.close()
    finally:
        door.stop()


def _port_fleet(job):
    from edl_tpu_torch.models import mlp
    from edl_tpu_torch.runtime.serving import ServingFleet

    fleet = ServingFleet(
        lambda p, b: mlp.apply(p, b[0]), MODEL,
        example_row=(np.zeros((SIZES[0],), np.float32),),
        job=job, max_batch_size=4, max_queue_ms=0.5, device="cpu")
    fleet.scale_to(1)
    return fleet


def test_fleet_app_serves_fleet_with_keepalive():
    fleet = _port_fleet("tfdtest/fleet")
    door = FrontDoor(FleetApp(fleet, SIZES[0]), host="127.0.0.1",
                     job="tfdtest/fleet").start()
    try:
        row = np.arange(SIZES[0], dtype=np.float32)
        s = connect(door.port)
        s.sendall(build_predict_request(row) * 5 + json_request(row))
        resps = read_responses(s, 6)
        s.close()
        assert [st for st, _ in resps] == [200] * 6
        ref = ref_out(row[None])[0]
        np.testing.assert_allclose(
            np.asarray(json.loads(resps[5][1].decode())["outputs"]), ref,
            atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(np.frombuffer(resps[0][1], "<f4"), ref,
                                   atol=ATOL, rtol=ATOL)
    finally:
        door.stop()
        fleet.stop()


@pytest.mark.timeout_s(180)
def test_legacy_serve_main_http11_keepalive(tmp_path):
    """The legacy thread-per-connection door answers two requests over
    ONE connection (HTTP/1.1 + Content-Length = keep-alive)."""
    import re
    import subprocess
    import sys

    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

    ElasticCheckpointer(tmp_path / "lineage").save(1, {"params": MODEL})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update(EDL_SERVING_FRONTDOOR="legacy",
               EDL_SERVING_MODEL_DIR=str(tmp_path / "lineage"),
               EDL_SERVING_MODEL="mlp:16,32,4", EDL_SERVING_PORT="0",
               EDL_HEALTH_PORT="-1", EDL_SERVING_RELOAD_POLL_S="0",
               OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
    logf = tmp_path / "serve.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.runtime.serving", "--device",
         "cpu"], stdout=open(logf, "w"), stderr=subprocess.STDOUT, env=env,
        cwd=root)
    try:
        port = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            m = re.search(r"model server ready.*?port=(\d+)",
                          logf.read_text())
            if m:
                port = int(m.group(1))
                break
            assert proc.poll() is None, logf.read_text()
            time.sleep(0.2)
        assert port, "server never came up"
        req = json_request(np.arange(SIZES[0], dtype=np.float32))
        s = connect(port)
        s.sendall(req)
        (st1, b1), = read_responses(s, 1)
        s.sendall(req)  # SAME socket, second request: keep-alive held
        (st2, b2), = read_responses(s, 1)
        s.close()
        assert st1 == 200 and st2 == 200
        assert (json.loads(b1.decode())["outputs"]
                == json.loads(b2.decode())["outputs"])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()


# -- satellite units ---------------------------------------------------------


def test_serving_addr_value_roundtrip():
    v = format_serving_addr("10.0.0.3:8500", 30.0, "reloading")
    addr, state, expired = parse_serving_addr(v)
    assert addr == "10.0.0.3:8500" and state == "reloading" and not expired
    _, _, expired = parse_serving_addr(
        format_serving_addr("1.2.3.4:1", -5.0, FD_READY))
    assert expired
    addr, state, _ = parse_serving_addr(b"1.2.3.4:1 -")
    assert addr == "1.2.3.4:1" and state == FD_READY
    assert parse_serving_addr(b"garbage")[0] is None
    # across the packages: each parses what the other publishes
    for ttl, state in ((30.0, "ready"), (None, "draining"),
                       (-1.0, "standby")):
        for fmt, parse in ((format_serving_addr, jfd.parse_serving_addr),
                           (jfd.format_serving_addr, parse_serving_addr)):
            assert parse(fmt("9.9.9.9:77", ttl, state)) == \
                jfd.parse_serving_addr(
                    jfd.format_serving_addr("9.9.9.9:77", ttl, state))
    for raw in (b"", b"\xff\xfe", b"1.2.3.4:5 notatime ready", b"h:1 - x y"):
        assert parse_serving_addr(raw) == jfd.parse_serving_addr(raw)


def test_observe_many_matches_observe():
    from edl_tpu_torch.observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    h1 = reg.histogram("a_seconds", buckets=(0.01, 0.1, 1.0))
    h2 = reg.histogram("b_seconds", buckets=(0.01, 0.1, 1.0))
    vals = [0.005, 0.01, 0.05, 0.5, 5.0, 0.09]
    for v in vals:
        h1.observe(v, job="x")
    h2.observe_many(np.asarray(vals), job="x")
    assert h1._counts[(("job", "x"),)] == h2._counts[(("job", "x"),)]
    assert h1.sum(job="x") == pytest.approx(h2.sum(job="x"))
    assert h2.count(job="x") == len(vals)


def test_await_all_shared_wait_bounds_wedged_tail():
    """A wedged tail costs ONE deadline wait, not a poll per request."""
    from edl_tpu_torch.runtime.serving import PoissonTraffic

    traffic = PoissonTraffic.__new__(PoissonTraffic)
    traffic.sent = [ServeRequest(payload=(np.zeros(1),), id=i,
                                 t_enqueue=time.perf_counter())
                    for i in range(2000)]
    for r in traffic.sent[:500]:
        r.complete(np.zeros(1))
    t0 = time.perf_counter()
    tally = traffic.await_all(timeout_s=0.5)
    assert tally["served"] == 500
    assert tally["timeouts"] == 1500
    assert time.perf_counter() - t0 < 2.0


def test_await_all_wakes_on_late_completion():
    from edl_tpu_torch.runtime.serving import PoissonTraffic

    traffic = PoissonTraffic.__new__(PoissonTraffic)
    traffic.sent = [ServeRequest(payload=(np.zeros(1),), id=i,
                                 t_enqueue=time.perf_counter())
                    for i in range(3)]

    def finish_later():
        time.sleep(0.2)
        for r in traffic.sent:
            r.complete(np.zeros(1))

    threading.Thread(target=finish_later).start()
    t0 = time.perf_counter()
    tally = traffic.await_all(timeout_s=10.0)
    assert tally["served"] == 3 and tally["timeouts"] == 0
    assert time.perf_counter() - t0 < 5.0


def test_keepalive_prefers_heartbeat_many():
    """CoordDiscovery.keepalive rides the coalesced verb when the client
    has one, and falls back to per-name heartbeats otherwise."""
    from edl_tpu_torch.runtime.discovery import CoordDiscovery

    class Client:
        def __init__(self, batched):
            self.hb_calls = 0
            self.many_calls = 0
            if not batched:
                self.heartbeat_many = None

        def member_ttl_ms(self):
            return 60

        def heartbeat(self, name):
            self.hb_calls += 1
            return True

        def heartbeat_many(self, names):
            self.many_calls += 1
            return {n: True for n in names}

        def kv_get(self, key):
            return None

    batched = Client(batched=True)
    with CoordDiscovery(batched, "w0").keepalive(interval_s=0.02):
        time.sleep(0.15)
    assert batched.many_calls >= 2 and batched.hb_calls == 0
    plain = Client(batched=False)
    with CoordDiscovery(plain, "w1").keepalive(interval_s=0.02):
        time.sleep(0.15)
    assert plain.hb_calls >= 2


def test_make_worker_coord_mux_default(monkeypatch):
    """The world worker's coordinator client rides a CoordMux by default;
    EDL_COORD_MUX=0 opts out."""
    from edl_tpu_torch.coord.client import CoordClient, MuxCoordClient
    from edl_tpu_torch.coord.server import spawn_server
    from edl_tpu_torch.runtime.multihost_worker import make_worker_coord

    srv = spawn_server()
    try:
        c = make_worker_coord("127.0.0.1", srv.port)
        assert isinstance(c, MuxCoordClient)
        assert c.ping()
        monkeypatch.setenv("EDL_COORD_MUX", "0")
        c2 = make_worker_coord("127.0.0.1", srv.port)
        assert isinstance(c2, CoordClient)
        assert not isinstance(c2, MuxCoordClient)
        c2.close()
    finally:
        srv.process.kill()


def test_gc_sweeps_serving_addr_prefix():
    from edl_tpu_torch.coord.gc import JOB_KV_PREFIXES

    assert tfd.SERVING_ADDR_PREFIX in JOB_KV_PREFIXES


# -- request tracing: f32↔JSON span parity, the loop-lag probe ---------------


def _span_names(trace_id):
    from edl_tpu_torch.observability.tracing import get_tracer

    return sorted({e.name for e in get_tracer().events()
                   if e.trace_id == trace_id})


def test_f32_json_span_parity_and_echo():
    """A traced request gets the same front-door phase taxonomy and the
    same header echo on the f32 fast path and the JSON slow path."""
    from edl_tpu_torch.observability.tracing import new_trace_id

    app, door = make_replica("tfdtest/parity")
    assert app.wait_ready(120)
    try:
        tid_f32, tid_json = new_trace_id(), new_trace_id()
        row = np.ones((SIZES[0],), np.float32)
        s = connect(door.port)
        s.sendall(build_predict_request(row, trace_id=tid_f32))
        status, head, body = read_raw_responses(s, 1)[0]
        assert status == 200
        assert f"X-EDL-Trace-Id: {tid_f32}".encode() in head, head
        assert len(body) == SIZES[-1] * 4  # still a raw f32 body
        s.sendall(json_request(row, b"X-EDL-Trace-Id: " + tid_json.encode()
                               + b"\r\n"))
        status, head, body = read_raw_responses(s, 1)[0]
        assert status == 200
        assert f"X-EDL-Trace-Id: {tid_json}".encode() in head
        s.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                not _span_names(tid_f32) or not _span_names(tid_json)):
            time.sleep(0.05)
        assert _span_names(tid_f32) == _span_names(tid_json) == [
            "frontdoor.admit", "frontdoor.batch", "frontdoor.forward",
            "frontdoor.parse", "frontdoor.queue", "frontdoor.respond",
            "frontdoor_request"]
        assert {tid_f32, tid_json} <= {e["trace_id"] for e in app.exemplars}
        hist_ids = {t for t, _v, _ts in
                    app._hist.exemplars(job="tfdtest/parity")}
        assert tid_f32 in hist_ids or tid_json in hist_ids
    finally:
        door.stop()


def test_traced_head_neither_cached_nor_armed():
    from edl_tpu_torch.observability.tracing import new_trace_id

    app, door = make_replica("tfdtest/headcache")
    assert app.wait_ready(120)
    try:
        row = np.ones((SIZES[0],), np.float32)
        s = connect(door.port)
        tid = new_trace_id()
        s.sendall(build_predict_request(row)
                  + build_predict_request(row, trace_id=tid)
                  + build_predict_request(row))
        assert [st for st, _ in read_responses(s, 3)] == [200] * 3
        assert not any(tid.encode() in h for h in door.head_cache)
        conn = next(iter(door.conns))
        assert conn._fixed is not None
        assert tid.encode() not in conn._fixed[0]
        s.close()
    finally:
        door.stop()


def test_untraced_f32_requests_emit_no_spans():
    from edl_tpu_torch.observability.tracing import get_tracer

    app, door = make_replica("tfdtest/quiet")
    assert app.wait_ready(120)
    try:
        before = sum(1 for e in get_tracer().events()
                     if e.name == "frontdoor_request")
        s = connect(door.port)
        s.sendall(build_predict_request(np.ones((SIZES[0],),
                                                np.float32)) * 8)
        assert [st for st, _ in read_responses(s, 8)] == [200] * 8
        s.close()
        assert sum(1 for e in get_tracer().events()
                   if e.name == "frontdoor_request") == before
        assert len(app.exemplars) == 0
    finally:
        door.stop()


def test_loop_lag_probe_histogram_breach_and_flightrec(tmp_path):
    """A blocking call on the event-loop thread shows in
    edl_loop_lag_seconds, counts breaches, and a sustained lag dumps a
    flight record embedding the exemplar ring."""
    from edl_tpu_torch.observability.metrics import get_registry
    from edl_tpu_torch.runtime.frontdoor import LoopLagProbe

    app, door = make_replica("tfdtest/lag")
    assert app.wait_ready(120)
    probe = None
    try:
        probe = LoopLagProbe(
            door, "tfdtest-lag", interval_s=0.02, breach_s=0.05,
            sustain=2, flight_dir=str(tmp_path),
            exemplars_fn=lambda: list(app.exemplars),
            dump_cooldown_s=0.0).start()
        assert probe._watchdog._last_beat is not None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and probe.ticks < 3:
            time.sleep(0.02)
        assert probe.ticks >= 3, "probe never ran on the loop"
        for _ in range(2):
            door.call_soon(time.sleep, 0.12)
            time.sleep(0.15)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and probe.escalations == 0:
            time.sleep(0.05)
        assert probe.breaches >= 2 and probe.escalations >= 1
        assert get_counters().get("loop_lag_breaches",
                                  loop="tfdtest-lag") >= 2
        recs = [f for f in os.listdir(tmp_path)
                if f.startswith("flightrec-") and "loop-lag" in f]
        assert recs, os.listdir(tmp_path)
        with open(tmp_path / recs[0]) as f:
            doc = json.load(f)
        assert doc["extra"]["loop"] == "tfdtest-lag"
        assert "exemplars" in doc["extra"]
        hist = get_registry().histogram("loop_lag_seconds")
        assert hist.count(loop="tfdtest-lag") >= 3
        assert hist.sum(loop="tfdtest-lag") >= 0.1
    finally:
        if probe is not None:
            probe.stop()
        door.stop()


# -- parity with the reference on the same bytes -----------------------------

#: request heads, good and bad, each parsed by both packages' HeadMeta
HEADS = [
    b"POST /predict HTTP/1.1\r\nHost: t\r\nContent-Type: "
    b"application/x-edl-f32\r\nContent-Length: 64\r\n\r\n",
    b"POST /predict?pri=low&x=1 HTTP/1.1\r\nContent-Length: 3\r\n\r\n",
    b"POST /predict HTTP/1.1\r\nX-EDL-Priority: high\r\nX-EDL-Trace-Id: "
    b"abc\r\nX-EDL-Parent-Span: p1\r\nX-EDL-Block-Nonce: n-7\r\n"
    b"Content-Length: 0\r\n\r\n",
    b"POST /generate HTTP/1.1\r\nX-EDL-Session: s9\r\nConnection: close"
    b"\r\nContent-Length: 12\r\n\r\n",
    b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n",
    b"POST /predict HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    b"POST /predict HTTP/1.1\r\nContent-Length: abc\r\n\r\n",
    b"POST /predict HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n",
    b"POST /predict HTTP/1.1\r\nX-Content-Length: 99\r\n\r\n",
    b"\r\n\r\n",
    b"GARBAGE\r\n\r\n",
    b"POST /predict HTTP/1.1\r\nx-edl-priority: bogus\r\n"
    b"content-length: 4294967296\r\n\r\n",
]


@pytest.mark.parametrize("head", HEADS, ids=range(len(HEADS)))
def test_head_meta_matches_reference(head):
    got, want = tfd.HeadMeta(head), jfd.HeadMeta(head)
    for field in jfd.HeadMeta.__slots__:
        assert getattr(got, field, None) == getattr(want, field, None), field


def _pipeline(port, rows, tids, nonces):
    """One socket, a fixed mixed stream: f32 rows, a traced f32 row, a
    nonce'd JSON row, a healthz, a 404, and more f32 rows."""
    blob = b"".join(build_predict_request(r) for r in rows[:3])
    blob += build_predict_request(rows[3], trace_id=tids[0])
    blob += json_request(rows[4], b"X-EDL-Trace-Id: " + tids[1].encode()
                         + b"\r\nX-EDL-Block-Nonce: " + nonces[0].encode()
                         + b"\r\n")
    blob += b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n"
    blob += b"GET /nowhere HTTP/1.1\r\nHost: t\r\n\r\n"
    nonce_head = (b"POST /predict HTTP/1.1\r\nHost: fd\r\nContent-Type: "
                  b"application/x-edl-f32\r\nX-EDL-Block-Nonce: "
                  + nonces[1].encode() + b"\r\nContent-Length: %d\r\n\r\n"
                  % (SIZES[0] * 4))
    blob += nonce_head + rows[5].astype("<f4").tobytes()
    blob += b"".join(build_predict_request(r) for r in rows[6:])
    s = connect(port)
    s.sendall(blob)
    out = read_raw_responses(s, len(rows) + 2)
    s.close()
    return out


def _echo(head: bytes, name: bytes):
    for line in head.split(b"\r\n"):
        if line.lower().startswith(name.lower() + b":"):
            return line.split(b":", 1)[1].strip()
    return None


def _outputs(head, body):
    if b"application/json" in head:
        return np.asarray(json.loads(body.decode())["outputs"], np.float32)
    return np.frombuffer(body, "<f4")


@pytest.mark.parametrize("app_kind", ["fleet", "batch"])
def test_byte_stream_parity_with_reference(app_kind):
    """The same pipelined stream into the reference's door and the
    port's: status lines and their order, the echoed trace ids and
    nonces, and every output (within 1e-5) agree."""
    from edl_tpu.models import mlp as jmlp
    from edl_tpu.runtime import serving as jserving
    from tests.torch_wire import JPARAMS, ref_server

    rows = np.random.default_rng(7).normal(size=(10, SIZES[0])).astype(
        np.float32)
    tids, nonces = ["tid-a", "tid-b"], ["nonce-1", "nonce-2"]
    doors, fleets, results = [], [], []
    try:
        for pkg in ("ref", "port"):
            job = f"tfdparity/{app_kind}-{pkg}"
            if app_kind == "fleet":
                if pkg == "ref":
                    fleet = jserving.ServingFleet(
                        lambda p, b: jmlp.apply(p, b[0]), JPARAMS,
                        example_row=(np.zeros((SIZES[0],), np.float32),),
                        job=job, max_batch_size=4, max_queue_ms=0.5)
                    fleet.scale_to(1)
                    app = jfd.FleetApp(fleet, SIZES[0])
                else:
                    fleet = _port_fleet(job)
                    app = tfd.FleetApp(fleet, SIZES[0])
                fleets.append(fleet)
            else:
                fd = jfd if pkg == "ref" else tfd
                app = fd.BatchApp(ref_server if pkg == "ref" else port_server,
                                  SIZES[0], job=job, max_batch=8,
                                  max_queue_ms=0.5)
            fd = jfd if pkg == "ref" else tfd
            door = fd.FrontDoor(app, host="127.0.0.1", job=job).start()
            doors.append(door)
            if app_kind == "batch":
                assert app.wait_ready(120)
            results.append(_pipeline(door.port, rows, tids, nonces))
    finally:
        for d in doors:
            d.stop()
        for f in fleets:
            f.stop()
    ref, got = results
    assert [st for st, _h, _b in got] == [st for st, _h, _b in ref]
    assert [st for st, _h, _b in got] == [200] * 5 + [200, 404] + [200] * 5
    for (_, hr, br), (_, hg, bg) in zip(ref, got):
        for name in (b"X-EDL-Trace-Id", b"X-EDL-Block-Nonce",
                     b"Content-Type"):
            assert _echo(hg, name) == _echo(hr, name), name
        if br:
            np.testing.assert_allclose(_outputs(hg, bg), _outputs(hr, br),
                                       atol=ATOL, rtol=ATOL)
    # and every answer is the JAX package's mlp.apply of its row
    answers = [r for r in got if r[2]]
    want = ref_out(rows)
    for (_, h, b), w in zip(answers, want):
        np.testing.assert_allclose(_outputs(h, b), w, atol=ATOL, rtol=ATOL)


def test_histogram_render_matches_reference():
    """Without exemplars a histogram renders byte-identically to the
    reference's; with one, the OpenMetrics suffix is the reference's."""
    from edl_tpu.observability.metrics import MetricsRegistry as JReg
    from edl_tpu_torch.observability.metrics import MetricsRegistry as TReg

    vals = np.asarray([0.0001, 0.0004, 0.003, 0.02, 0.3, 7.0])
    texts = []
    for reg in (JReg(), TReg()):
        h = reg.histogram("fd_seconds", help="h",
                          buckets=tfd.SERVING_LATENCY_BUCKETS)
        h.observe_many(vals, job="j")
        h.observe(0.004, job="k")
        texts.append(reg.render())
    assert texts[0] == texts[1]
    for reg in (JReg(), TReg()):
        h = reg.histogram("fd_seconds", buckets=(0.1, 1.0))
        h.observe(0.05, job="j")
        h.put_exemplar(0.05, "tid-1", job="j")
        lines = [ln for ln in reg.render().splitlines()
                 if 'le="0.1"' in ln]
        texts.append(lines[0].rsplit(" ", 1)[0])  # drop the wall stamp
    assert texts[2] == texts[3]
    assert '# {trace_id="tid-1"} 0.05' in texts[3]


def test_trace_file_sink_dumps_the_ring(tmp_path):
    from edl_tpu_torch.observability.tracing import TraceFileSink, get_tracer

    get_tracer().instant("sink_probe", category="serving")
    sink = TraceFileSink(str(tmp_path), "fd-test", interval_s=0.05)
    sink.start()
    time.sleep(0.2)
    sink.stop()
    assert sink.dumps >= 2
    with open(tmp_path / "trace-fd-test.json") as f:
        doc = json.load(f)
    assert doc["edl"]["process"] == "fd-test"
    assert any(e["name"] == "sink_probe" for e in doc["traceEvents"])


@pytest.mark.timeout_s(180)
def test_generate_pipelined_matches_greedy_and_reference():
    """``POST /generate`` over a TINY ``DecodeFleet``: two sessions
    pipelined over one socket answer the full-context greedy tokens and
    the reference's ``FleetApp`` over its ``DecodeFleet`` on the same
    weights, with ``X-EDL-Session`` headers and no failed session."""
    from edl_tpu.models.transformer import TINY as JTINY
    from edl_tpu.runtime.serving import DecodeFleet as JDecodeFleet
    from edl_tpu_torch.entry import flagship_decode_fleet
    from edl_tpu_torch.models import transformer as tfm
    from tests.torch_decode_ref import PARAMS as TPARAMS
    from tests.torch_decode_ref import port_model, ref_decode_many

    prompts = [[5, 9, 2, 44, 7], [3, 1, 4, 1, 5, 9, 2, 6]]
    n_new = 6
    kw = dict(slots=4, prefill_chunk=8, kv_block_size=8,
              max_blocks_per_session=8, kv_blocks=32)
    fleets = [JDecodeFleet(TPARAMS, JTINY, job="tfdgen/ref", **kw),
              flagship_decode_fleet(device="cpu", cfg=tfm.TINY,
                                    params=port_model(), job="tfdgen/port",
                                    **kw)]
    answers, doors = [], []
    try:
        for fleet, fd in zip(fleets, (jfd, tfd)):
            door = fd.FrontDoor(fd.FleetApp(None, 1, decode_fleet=fleet),
                                host="127.0.0.1",
                                job=f"tfdgen/{fd.__name__}").start()
            doors.append(door)
            blob = b""
            for p in prompts:
                body = json.dumps({"prompt": p,
                                   "max_new_tokens": n_new}).encode()
                blob += (b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body) + body)
            s = connect(door.port)
            s.sendall(blob)
            resps = read_raw_responses(s, len(prompts), timeout=120)
            s.close()
            assert [st for st, _h, _b in resps] == [200] * len(prompts)
            for st, head, body in resps:
                assert _echo(head, b"X-EDL-Session") == str(
                    json.loads(body)["session"]).encode()
                assert _echo(head, b"X-EDL-Session-Done") == b"1"
            answers.append([json.loads(b)["tokens"] for _s, _h, b in resps])
        want = ref_decode_many(prompts, n_new)
        assert answers[1] == want
        assert answers[1] == answers[0]
        assert fleets[1].sessions_failed == 0
    finally:
        for d in doors:
            d.stop()
        for f in fleets:
            f.stop()


def test_loop_lag_escalations_counted_across_threads():
    """``LoopLagProbe._escalate`` runs on the loop thread and on its
    watchdog's thread: many threads escalating at a 1 µs switch interval
    lose no count."""
    import sys

    from edl_tpu_torch.runtime.frontdoor import LoopLagProbe

    class _Door:
        def call_soon(self, fn, *args):
            pass

    probe = LoopLagProbe(_Door(), "tfdtest-esc", flight_dir="")
    threads, n, each = [], 2 * (os.cpu_count() or 4), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(n):
            threads.append(threading.Thread(
                target=lambda: [probe._escalate("loop-lag", 0.3)
                                for _ in range(each)]))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert probe.escalations == n * each
