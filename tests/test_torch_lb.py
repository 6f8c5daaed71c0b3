"""The port's serving load-balancer tier (edl_tpu_torch.runtime.lb) on the
CPU: tests/test_lb.py's scenarios — KV discovery with ready-gate routing,
hedging with first-wins cancellation, connection pooling, priority
shedding, the killed-replica rescue, the request-timeout desync kill,
static upstreams, the trace origin — with port replicas of the MLP
[16, 32, 4] holding the JAX init, every answer held to the JAX package's
``mlp.apply`` within 1e-5; and test_decode.py's ``TestLBAffinity`` and
``TestScalerTTFT``, test_decode_v2.py's ``TestLBAffinityEviction``.

Beyond the reference's list: a mixed tier (the port's LB in front of one
reference replica and one port replica, and the reference's LB in front of
a port replica, every answer within 1e-5 of the plain MLP whichever
replica served it: the two wires agree); 64 KiB answers — FLAGSHIP's
16 384 logits a row — pipelined 8 deep through the LB, and its upstream
parser fed those answers in arbitrary TCP segments; the FLAGSHIP-shaped
path at TINY (``entry.flagship_frontdoor_replica`` behind the port's LB,
against ``score_last_token`` run directly and against the reference's
transformer scoring the same rows); and the process entry points
(``python -m edl_tpu_torch.runtime.frontdoor --device cpu``, ``python -m
edl_tpu_torch.runtime.lb``, ``python -m edl_tpu_torch.entry
frontdoor-replica``) up to their ready markers and a SIGTERM exit 0."""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from edl_tpu.runtime import frontdoor as jfd
from edl_tpu.runtime import lb as jlb
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime.frontdoor import (
    FD_READY,
    FD_RELOADING,
    SERVING_ADDR_PREFIX,
    BatchApp,
    FrontDoor,
    build_predict_request,
)
from edl_tpu_torch.runtime.lb import ServingLB
from tests.torch_wire import (
    ATOL,
    SIZES,
    FakeKV,
    connect,
    json_request,
    port_server,
    read_raw_responses,
    read_responses,
    ref_out,
    spin_replica,
    wait_routable,
)

pytestmark = pytest.mark.timeout_s(120)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ones():
    return np.ones((SIZES[0],), np.float32)


class TestLBTier:
    """Two live replicas and one LB, discovered through the FakeKV the
    replicas publish their ready-gate keys to."""

    JOB = "tlbtest/fleet"

    @classmethod
    def setup_class(cls):
        cls.kv = FakeKV()
        cls.app_a, cls.door_a = spin_replica(cls.kv, cls.JOB, "ra")
        cls.app_b, cls.door_b = spin_replica(cls.kv, cls.JOB, "rb")
        cls.lb = ServingLB(
            job=cls.JOB, host="127.0.0.1", kv=cls.kv, pool=2,
            discovery_s=0.1, sweep_ms=3.0, hedge_floor_ms=30.0,
            request_timeout_s=20.0).start()
        assert wait_routable(cls.lb, 2), cls.lb.app.upstreams

    @classmethod
    def teardown_class(cls):
        cls.lb.stop()
        cls.door_a.stop()
        cls.door_b.stop()

    def _upstream(self, name):
        return self.lb.app.upstreams[name]

    def _send(self, n, sock=None, priority=None):
        s = sock or connect(self.lb.port)
        s.sendall(b"".join(build_predict_request(ones(), priority=priority)
                           for _ in range(n)))
        return s

    def _gate_rb(self, state):
        self.app_b._set_state(state)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and self._upstream("rb").state != state:
            time.sleep(0.02)
        assert self._upstream("rb").state == state

    def _pools_settled(self):
        """Every upstream's pool full again (an earlier test's severed
        connections are re-dialed asynchronously): only then does a
        count of the doors' accepted connections stand still."""
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(u.dialing == 0 and sum(c.connected for c in u.conns)
                   == self.lb.app.pool
                   for u in self.lb.app.upstreams.values()):
                return
            time.sleep(0.02)
        raise AssertionError(f"pools never refilled: {self.lb.app.upstreams}")

    def test_discovery_published_keys(self):
        keys = self.kv.kv_keys(f"{SERVING_ADDR_PREFIX}{self.JOB}/")
        assert len(keys) == 2

    def test_routes_and_answers(self):
        s = self._send(20)
        resps = read_responses(s, 20)
        s.close()
        assert [st for st, _ in resps] == [200] * 20
        ref = ref_out(ones()[None])[0]
        for _, body in resps:
            np.testing.assert_allclose(np.frombuffer(body, "<f4"), ref,
                                       atol=ATOL, rtol=ATOL)

    def test_connection_pool_reuse(self):
        """Hundreds of requests ride the SAME pooled upstream
        connections: the replica doors' accepted-connection count does not
        move while requests pour through."""
        saved = (self.lb.app.hedge_floor_ms, self.lb.app.hedge_cap_ms,
                 self.lb.app.hedge_delay_s)
        self.lb.app.hedge_floor_ms = self.lb.app.hedge_cap_ms = 60_000.0
        self.lb.app.hedge_delay_s = 60.0
        try:
            self._pools_settled()
            conns_before = (self.door_a.connections
                            + self.door_b.connections)
            served0 = self.app_a.requests_served + self.app_b.requests_served
            for _ in range(3):
                s = self._send(100)
                assert [st for st, _ in read_responses(s, 100)] == \
                    [200] * 100
                s.close()
            assert self.door_a.connections + self.door_b.connections \
                == conns_before
            assert (self.app_a.requests_served + self.app_b.requests_served
                    - served0) == 300
        finally:
            (self.lb.app.hedge_floor_ms, self.lb.app.hedge_cap_ms,
             self.lb.app.hedge_delay_s) = saved

    def test_ready_gate_routes_around_reloading(self):
        """A RELOADING replica takes no new traffic; regated, it takes
        traffic again."""
        self._gate_rb(FD_RELOADING)
        served_b = self.app_b.requests_served
        reqs_b = self._upstream("rb").requests
        s = self._send(60)
        assert [st for st, _ in read_responses(s, 60)] == [200] * 60
        s.close()
        assert self._upstream("rb").requests == reqs_b
        assert self.app_b.requests_served == served_b
        self._gate_rb(FD_READY)
        got = False
        for _ in range(10):
            s = self._send(40)
            read_responses(s, 40)
            s.close()
            if self._upstream("rb").requests > reqs_b:
                got = True
                break
        assert got, "regated replica never took traffic again"

    def test_hedge_fires_and_first_wins(self):
        """A straggler iteration on one replica: the LB hedges the aged
        block to the peer (win), and the straggler's late response is
        consumed and discarded (lose)."""
        c = get_counters()
        wins0 = c.get("lb_hedges", job=self.JOB, result="win")
        loses0 = c.get("lb_hedges", job=self.JOB, result="lose")
        self.app_a._stall_once_ms = 1200
        direct = connect(self.door_a.port)
        direct.sendall(build_predict_request(ones()))
        time.sleep(0.05)
        self._gate_rb(FD_RELOADING)
        s = self._send(4)
        time.sleep(0.05)
        self._gate_rb(FD_READY)
        assert [st for st, _ in read_responses(s, 4, timeout=30)] == \
            [200] * 4
        s.close()
        read_responses(direct, 1, timeout=30)
        direct.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                c.get("lb_hedges", job=self.JOB, result="win") == wins0
                or c.get("lb_hedges", job=self.JOB,
                         result="lose") == loses0):
            time.sleep(0.05)
        assert c.get("lb_hedges", job=self.JOB, result="win") > wins0
        assert c.get("lb_hedges", job=self.JOB, result="lose") > loses0

    def test_killed_replica_rescued_zero_errors(self):
        """Sever a replica mid-burst: every outstanding block is re-sent
        to the survivor — 200s only, rescues counted."""
        c = get_counters()
        rescues0 = c.get("lb_rescues", job=self.JOB)
        self.lb.app.hedge_floor_ms = self.lb.app.hedge_cap_ms = 60_000.0
        self.lb.app.hedge_delay_s = 60.0
        self.app_a._stall_once_ms = 3000
        direct = connect(self.door_a.port)
        direct.sendall(build_predict_request(ones()))
        time.sleep(0.05)
        self._gate_rb(FD_RELOADING)
        s = self._send(40)
        time.sleep(0.1)
        self._gate_rb(FD_READY)
        door = self.door_a

        def sever():
            for conn in list(door.conns):
                conn.transport.abort()

        door.call_soon(sever)
        assert [st for st, _ in read_responses(s, 40, timeout=30)] == \
            [200] * 40
        s.close()
        assert c.get("lb_rescues", job=self.JOB) > rescues0
        direct.close()

    def test_connection_close_does_not_kill_upstream_pool(self):
        """A client's hop-by-hop ``Connection: close`` is stripped before
        forwarding: the client hop closes, the pooled upstream
        connections survive."""
        self._pools_settled()
        conns_before = self.door_a.connections + self.door_b.connections
        body = ones().astype("<f4").tobytes()
        req = (b"POST /predict HTTP/1.1\r\nHost: t\r\n"
               b"Content-Type: application/x-edl-f32\r\n"
               b"Connection: close\r\n"
               b"Content-Length: %d\r\n\r\n" % len(body)) + body
        for _ in range(3):
            s = connect(self.lb.port)
            s.sendall(req)
            (st, _), = read_responses(s, 1)
            assert st == 200
            assert s.recv(1 << 16) == b""  # the client hop DID close
            s.close()
        s = self._send(20)
        assert [st for st, _ in read_responses(s, 20)] == [200] * 20
        s.close()
        assert self.door_a.connections + self.door_b.connections \
            == conns_before

    def test_json_forwarded_verbatim(self):
        import json

        row = np.arange(SIZES[0], dtype=np.float32)
        s = connect(self.lb.port)
        s.sendall(json_request(row))
        (st, b), = read_responses(s, 1)
        s.close()
        assert st == 200
        np.testing.assert_allclose(
            np.asarray(json.loads(b.decode())["outputs"]),
            ref_out(row[None])[0], atol=ATOL, rtol=ATOL)

    def test_healthz(self):
        s = connect(self.lb.port)
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
        (st, _), = read_responses(s, 1)
        s.close()
        assert st == 200

    def test_admin_verbs_not_forwarded(self):
        s = connect(self.lb.port)
        s.sendall(b"POST /admin/stall HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: 6\r\n\r\n300000")
        (st, _), = read_responses(s, 1)
        s.close()
        assert st == 404
        assert self.app_a._stall_once_ms == 0.0
        assert self.app_b._stall_once_ms == 0.0


class TestLBShedding:
    JOB = "tlbtest/shed"

    @classmethod
    def setup_class(cls):
        cls.kv = FakeKV()
        cls.app, cls.door = spin_replica(cls.kv, cls.JOB, "r0", max_batch=8)
        cls.lb = ServingLB(
            job=cls.JOB, host="127.0.0.1", kv=cls.kv, pool=1,
            discovery_s=0.1, sweep_ms=5.0, hedge_floor_ms=10_000.0,
            hard_cap_rows=32, soft_cap_rows=16).start()
        assert wait_routable(cls.lb, 1)

    @classmethod
    def teardown_class(cls):
        cls.lb.stop()
        cls.door.stop()

    def test_priority_shed_order_under_overload(self):
        c = get_counters()
        self.app._stall_once_ms = 400
        s = connect(self.lb.port)
        s.sendall(build_predict_request(ones()) * 16)  # fill to soft cap
        time.sleep(0.1)
        low0 = c.get("lb_overload_sheds", job=self.JOB, priority="low")
        for pri in ("low", "normal", "high"):
            s.sendall(build_predict_request(ones(), priority=pri))
        statuses = [st for st, _ in read_responses(s, 19, timeout=30)]
        s.close()
        assert statuses == [200] * 16 + [429, 200, 200]
        assert c.get("lb_overload_sheds", job=self.JOB,
                     priority="low") == low0 + 1


def _fake_upstream():
    """A listening socket that accepts and never answers by itself."""
    accepted = []
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    halt = threading.Event()

    def acceptor():
        while not halt.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            accepted.append(conn)

    threading.Thread(target=acceptor, daemon=True).start()
    return srv, accepted, halt


def test_request_timeout_kills_desynced_upstream_conn():
    """A block expired by the request timeout takes its pipelined upstream
    connection with it (the wedged replica's late answers would otherwise
    be credited to the NEXT block): 503, the stale connection dies, the
    repooled one serves the next request right."""
    c = get_counters()
    srv, accepted, halt = _fake_upstream()
    lb = ServingLB(
        job="tlbtest/timeout", host="127.0.0.1",
        static_upstreams={"r0": f"127.0.0.1:{srv.getsockname()[1]}"},
        pool=1, sweep_ms=5.0, hedge_floor_ms=60_000.0,
        hedge_cap_ms=60_000.0, request_timeout_s=0.3,
        integrity=False).start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not accepted:
            time.sleep(0.02)
        assert accepted, "LB never dialed the upstream"
        first = accepted[0]
        timeouts0 = c.get("lb_timeouts", job="tlbtest/timeout")
        s = connect(lb.port)
        s.sendall(build_predict_request(ones()))
        (st, _), = read_responses(s, 1, timeout=10)
        assert st == 503
        assert c.get("lb_timeouts", job="tlbtest/timeout") == timeouts0 + 1
        first.settimeout(10)
        first.recv(1 << 16)
        assert first.recv(1 << 16) == b""  # EOF: the LB killed the conn
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(accepted) < 2:
            time.sleep(0.02)
        assert len(accepted) >= 2, "LB never repooled after the kill"
        fresh = accepted[-1]
        s.sendall(build_predict_request(ones()))
        fresh.settimeout(10)
        fresh.recv(1 << 16)
        fresh.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nhi")
        assert read_responses(s, 1, timeout=10) == [(200, b"hi")]
        s.close()
    finally:
        halt.set()
        srv.close()
        lb.stop()
        for conn in accepted:
            conn.close()


def test_lb_static_upstreams_no_kv():
    app = BatchApp(port_server, SIZES[0], job="tlbtest/static", replica="r0")
    door = FrontDoor(app, host="127.0.0.1", job="tlbtest/static").start()
    assert app.wait_ready(120)
    lb = ServingLB(job="tlbtest/static", host="127.0.0.1",
                   static_upstreams={"r0": f"127.0.0.1:{door.port}"},
                   pool=1).start()
    try:
        assert wait_routable(lb, 1)
        s = connect(lb.port)
        s.sendall(build_predict_request(ones()) * 10)
        assert [st for st, _ in read_responses(s, 10)] == [200] * 10
        s.close()
    finally:
        lb.stop()
        door.stop()


def test_lb_static_upstream_redialed_after_late_start():
    """A static upstream not yet listening when the LB started is
    re-dialed by the sweep's pool top-up and becomes routable."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    lb = ServingLB(job="tlbtest/latestart", host="127.0.0.1",
                   static_upstreams={"r0": f"127.0.0.1:{port}"},
                   pool=1, sweep_ms=3.0).start()
    door = None
    try:
        time.sleep(0.7)
        assert not any(u.routable() for u in lb.app.upstreams.values())
        app = BatchApp(port_server, SIZES[0], job="tlbtest/latestart",
                       replica="r0")
        door = FrontDoor(app, host="127.0.0.1", port=port,
                         job="tlbtest/latestart").start()
        assert app.wait_ready(120)
        assert wait_routable(lb, 1, 15)
        s = connect(lb.port)
        s.sendall(build_predict_request(ones()) * 5)
        assert [st for st, _ in read_responses(s, 5)] == [200] * 5
        s.close()
    finally:
        lb.stop()
        if door is not None:
            door.stop()


def test_unhedged_rescue_duplicate_not_a_hedge_lose():
    from edl_tpu_torch.runtime.lb import LBApp, _Cell, _OutBlock

    app = LBApp(job="tlbtest/dup")
    c = get_counters()
    lose0 = c.get("lb_hedges", job="tlbtest/dup", result="lose")
    late0 = c.get("lb_late_responses", job="tlbtest/dup")

    class _ClosedConn:
        closed = True

    cell = _Cell()
    cell.done = True
    app.block_done(_OutBlock(_ClosedConn(), None, 3, b"", cell,
                             kind="rescue"))
    assert c.get("lb_hedges", job="tlbtest/dup", result="lose") == lose0
    assert c.get("lb_late_responses", job="tlbtest/dup") == late0 + 3
    hedge = _OutBlock(_ClosedConn(), None, 2, b"", cell, kind="hedge")
    hedge.hedged = True
    app.block_done(hedge)
    assert c.get("lb_hedges", job="tlbtest/dup", result="lose") == lose0 + 2
    assert c.get("lb_late_responses", job="tlbtest/dup") == late0 + 3


def _trace_events(tid):
    from edl_tpu_torch.observability.tracing import get_tracer

    return [e for e in get_tracer().events() if e.trace_id == tid]


class TestTraceOrigin:
    """The LB as trace origin: head sampling injects the header, a hedge
    duel yields winner and loser spans stitched across the tiers."""

    JOB = "tlbtrace/fleet"

    @classmethod
    def setup_class(cls):
        cls.kv = FakeKV()
        cls.app_a, cls.door_a = spin_replica(cls.kv, cls.JOB, "ra")
        cls.app_b, cls.door_b = spin_replica(cls.kv, cls.JOB, "rb")
        cls.lb = ServingLB(
            job=cls.JOB, host="127.0.0.1", kv=cls.kv, pool=2,
            discovery_s=0.1, sweep_ms=3.0, hedge_floor_ms=30.0,
            request_timeout_s=20.0, trace_sample=1.0).start()
        assert wait_routable(cls.lb, 2)

    @classmethod
    def teardown_class(cls):
        cls.lb.stop()
        cls.door_a.stop()
        cls.door_b.stop()

    def _gate_rb(self, state):
        self.app_b._set_state(state)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and self.lb.app.upstreams["rb"].state != state:
            time.sleep(0.02)
        assert self.lb.app.upstreams["rb"].state == state

    def test_head_sampling_injects_and_stitches(self):
        c = get_counters()
        head0 = c.get("traces_sampled", job=self.JOB, origin="head")
        s = connect(self.lb.port)
        s.sendall(build_predict_request(ones()))
        assert read_responses(s, 1)[0][0] == 200
        s.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and c.get(
                "traces_sampled", job=self.JOB, origin="head") == head0:
            time.sleep(0.05)
        assert c.get("traces_sampled", job=self.JOB, origin="head") > head0
        ex = [e for e in self.lb.app.exemplars if e["origin"] == "head"]
        assert ex
        tid = ex[-1]["trace_id"]
        deadline = time.monotonic() + 10
        names = set()
        while time.monotonic() < deadline:
            names = {e.name for e in _trace_events(tid)}
            if "frontdoor_request" in names and "lb_request" in names:
                break
            time.sleep(0.05)
        assert {"lb_request", "lb.route", "lb.upstream",
                "frontdoor_request", "frontdoor.forward"} <= names
        root = next(e for e in _trace_events(tid) if e.name == "lb_request")
        door_root = next(e for e in _trace_events(tid)
                         if e.name == "frontdoor_request")
        assert door_root.parent_id == root.span_id

    def test_hedged_request_tree_marks_loser_discarded(self):
        """A hedged request's spans show the duel: sibling lb.upstream
        spans under the admission root, the winner marked win, the
        straggler's late response discarded, the door's spans under the
        same trace id."""
        from edl_tpu_torch.observability.tracing import new_trace_id

        tid = new_trace_id()
        self.app_a._stall_once_ms = 1200
        direct = connect(self.door_a.port)
        direct.sendall(build_predict_request(ones()))
        time.sleep(0.05)
        self._gate_rb(FD_RELOADING)
        s = connect(self.lb.port)
        s.sendall(build_predict_request(ones(), trace_id=tid))
        time.sleep(0.05)
        self._gate_rb(FD_READY)
        assert read_responses(s, 1, timeout=30)[0][0] == 200
        s.close()
        read_responses(direct, 1, timeout=30)
        direct.close()
        deadline = time.monotonic() + 15
        outcomes = set()
        while time.monotonic() < deadline:
            outcomes = {e.args.get("outcome") for e in _trace_events(tid)
                        if e.name == "lb.upstream"}
            if {"win", "discarded"} <= outcomes:
                break
            time.sleep(0.05)
        assert {"win", "discarded"} <= outcomes, outcomes
        evs = _trace_events(tid)
        root = next(e for e in evs if e.name == "lb_request")
        ups = [e for e in evs if e.name == "lb.upstream"]
        assert {e.parent_id for e in ups} == {root.span_id}
        assert "hedge" in {e.args.get("kind") for e in ups}
        assert any(e.name == "frontdoor_request" for e in evs)
        ex = [e for e in self.lb.app.exemplars if e["trace_id"] == tid]
        assert ex and ex[0]["hedged"] is True
        assert tid in {t for t, _v, _ts in
                       self.lb.app._hist.exemplars(job=self.JOB)}

    def test_trace_disabled_lb_injects_nothing(self):
        from edl_tpu_torch.observability.tracing import get_tracer

        kv = FakeKV()
        app, door = spin_replica(kv, "tlbtrace/off", "rq")
        lb = ServingLB(job="tlbtrace/off", host="127.0.0.1", kv=kv,
                       pool=1, discovery_s=0.1, sweep_ms=3.0,
                       trace=False, trace_sample=1.0).start()
        try:
            assert wait_routable(lb, 1)
            before = len(get_tracer().events())
            s = connect(lb.port)
            s.sendall(build_predict_request(ones()) * 4)
            assert [st for st, _ in read_responses(s, 4)] == [200] * 4
            s.close()
            assert get_counters().get("traces_sampled", job="tlbtrace/off",
                                      origin="head") == 0
            new = [e for e in list(get_tracer().events())[before:]
                   if e.name in ("lb_request", "frontdoor_request")
                   and e.args.get("job") == "tlbtrace/off"]
            assert new == []
        finally:
            lb.stop()
            door.stop()


# -- decode-session affinity (test_decode.py / test_decode_v2.py) -----------


class _FakeUp:
    def __init__(self, name, load=0):
        self.name = name
        self.load = load
        self.alive = True

    def routable(self):
        return self.alive

    def outstanding(self):
        return self.load


class TestLBAffinity:
    def test_session_pins_and_repins_on_death(self):
        from edl_tpu_torch.runtime.lb import LBApp, _Cell, _OutBlock

        lb = LBApp(job="tlb/aff")
        a, b = _FakeUp("a", 5), _FakeUp("b", 0)
        lb.upstreams = {"a": a, "b": b}
        blk = _OutBlock(None, None, 1, b"", _Cell())
        blk.session = "s1"
        assert lb._pick_affine(blk).name == "b"
        b.load = 100
        assert lb._pick_affine(blk).name == "b"  # sticky despite load
        b.alive = False
        assert lb._pick_affine(blk).name == "a"  # fall back + re-pin
        b.alive = True
        assert lb._pick_affine(blk).name == "a"  # re-pinned, stays
        b.load = 0
        blk2 = _OutBlock(None, None, 1, b"", _Cell())
        assert lb._pick_affine(blk2).name == "b"
        assert get_counters().get("lb_affinity_repins", job="tlb/aff") == 1

    def test_affinity_lru_bounded(self):
        from edl_tpu_torch.runtime.lb import LBApp, _Cell, _OutBlock

        lb = LBApp(job="tlb/afflru")
        lb._affinity_cap = 8
        lb.upstreams = {"only": _FakeUp("only")}
        for i in range(50):
            blk = _OutBlock(None, None, 1, b"", _Cell())
            blk.session = f"s{i}"
            lb._pick_affine(blk)
        assert list(lb._affinity) == [f"s{i}" for i in range(42, 50)]


class TestLBAffinityEviction:
    def _lb_with_pin(self, job):
        from edl_tpu_torch.runtime.lb import LBApp, _Cell, _OutBlock

        lb = LBApp(job=job)
        lb.upstreams = {"only": _FakeUp("only")}
        blk = _OutBlock(None, None, 1, b"", _Cell())
        blk.session = "s1"
        lb._pick_affine(blk)
        assert "s1" in lb._affinity
        return lb, blk

    def test_session_done_header_evicts_pin(self):
        lb, blk = self._lb_with_pin("tlb/affev-done")
        blk.acc = [b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n"
                   b"X-EDL-Session-Done: 1\r\n\r\nok"]
        lb._maybe_evict_affinity(blk)
        assert "s1" not in lb._affinity
        assert get_counters().get("lb_affinity_evictions",
                                  job="tlb/affev-done") == 1

    def test_error_response_evicts_pin(self):
        lb, blk = self._lb_with_pin("tlb/affev-err")
        blk.errors = 1
        lb._maybe_evict_affinity(blk)
        assert "s1" not in lb._affinity

    def test_mid_session_response_keeps_pin(self):
        lb, blk = self._lb_with_pin("tlb/affev-keep")
        blk.acc = [b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"]
        lb._maybe_evict_affinity(blk)
        assert "s1" in lb._affinity


class TestScalerTTFT:
    def test_ttft_breach_grows_and_gates_shrink(self):
        """The decode SLO on the port's ServingScaler: a TTFT breach
        grows, an edge inside the SLO holds, deep headroom shrinks — as
        the reference's decides on the same stats."""
        from edl_tpu.api.types import ServingJob as JJob
        from edl_tpu.api.types import ServingSpec as JSpec
        from edl_tpu.runtime.serving import FleetStats as JStats
        from edl_tpu.scheduler.autoscaler import ServingScaler as JScaler
        from edl_tpu_torch.api.types import ServingJob, ServingSpec
        from edl_tpu_torch.runtime.serving import FleetStats
        from edl_tpu_torch.scheduler.autoscaler import ServingScaler

        kw = dict(min_replicas=1, max_replicas=8, slo_p99_ms=0.0,
                  slo_ttft_ms=200.0, decode_slots=4)
        job = ServingJob(name="svc", namespace="t", spec=ServingSpec(**kw))
        jjob = JJob(name="svc", namespace="t", spec=JSpec(**kw))
        pol, jpol = ServingScaler(), JScaler()
        cases = [dict(requests_windowed=10, ttft_p99_ms=900.0,
                      queue_depth=8),
                 dict(requests_windowed=10, ttft_p99_ms=150.0),
                 dict(requests_windowed=10, ttft_p99_ms=10.0)]
        got = [pol.decide(job, FleetStats(**c), current=2) for c in cases]
        assert got[0] > 2
        assert got[1] is None  # inside the SLO, not deep inside: hold
        assert got[2] == 1     # deep headroom, empty queue: shrink
        assert got == [jpol.decide(jjob, JStats(**c), current=2)
                       for c in cases]


# -- the mixed tier: the two wires agree --------------------------------------


def test_port_lb_over_reference_and_port_replicas():
    """The port's LB in front of one reference replica and one port
    replica: both take traffic, every answer within 1e-5 of the plain MLP
    whichever replica served it, every nonce echoed (no integrity
    failure)."""
    kv = FakeKV()
    job = "tlbmix/port-lb"
    app_r, door_r = spin_replica(kv, job, "ref", fd=jfd, max_batch=8)
    app_p, door_p = spin_replica(kv, job, "port", max_batch=8)
    lb = ServingLB(job=job, host="127.0.0.1", kv=kv, pool=2,
                   discovery_s=0.1, sweep_ms=3.0, hedge_floor_ms=60_000.0,
                   hedge_cap_ms=60_000.0).start()
    c = get_counters()
    integ0 = c.get("lb_integrity_failures", job=job)
    try:
        assert wait_routable(lb, 2)
        rows = np.random.default_rng(11).normal(size=(24, SIZES[0])).astype(
            np.float32)
        want = ref_out(rows)
        # rounds of three concurrent sockets until both replicas have
        # answered (least-outstanding routing breaks ties by order, so a
        # round that finishes one block before the next arrives stays on
        # one replica)
        for _ in range(20):
            socks = [connect(lb.port) for _ in range(3)]
            for k, s in enumerate(socks):
                s.sendall(b"".join(build_predict_request(r)
                                   for r in rows[k * 8:(k + 1) * 8]))
            for k, s in enumerate(socks):
                for i, (st, body) in enumerate(read_responses(s, 8)):
                    assert st == 200
                    np.testing.assert_allclose(np.frombuffer(body, "<f4"),
                                               want[k * 8 + i], atol=ATOL,
                                               rtol=ATOL)
                s.close()
            if app_r.requests_served and app_p.requests_served:
                break
        assert app_r.requests_served > 0 and app_p.requests_served > 0
        assert c.get("lb_integrity_failures", job=job) == integ0
    finally:
        lb.stop()
        door_r.stop()
        door_p.stop()


def test_reference_lb_over_port_replica():
    """The reference's LB (nonces on) in front of a port replica: every
    answer within 1e-5 of the plain MLP, no integrity failure."""
    from edl_tpu.observability.collector import get_counters as jcounters

    kv = FakeKV()
    job = "tlbmix/ref-lb"
    app, door = spin_replica(kv, job, "port", max_batch=8)
    lb = jlb.ServingLB(job=job, host="127.0.0.1", kv=kv, pool=2,
                       discovery_s=0.1, sweep_ms=3.0).start()
    integ0 = jcounters().get("lb_integrity_failures", job=job)
    try:
        assert wait_routable(lb, 1)
        rows = np.random.default_rng(12).normal(size=(16, SIZES[0])).astype(
            np.float32)
        s = connect(lb.port)
        s.sendall(b"".join(build_predict_request(r) for r in rows)
                  + json_request(rows[0]))
        resps = read_responses(s, 17)
        s.close()
        assert [st for st, _ in resps] == [200] * 17
        want = ref_out(rows)
        for (_, body), w in zip(resps, want):
            np.testing.assert_allclose(np.frombuffer(body, "<f4"), w,
                                       atol=ATOL, rtol=ATOL)
        assert app.requests_served >= 17
        assert jcounters().get("lb_integrity_failures", job=job) == integ0
    finally:
        lb.stop()
        door.stop()


# -- 64 KiB answers: FLAGSHIP's 16 384 fp32 logits a row ----------------------

#: FLAGSHIP's vocab: an answer of 16 384 fp32 logits is 64 KiB
WIDE = 16_384


def _wide_server():
    """A row → 16 384 outputs map whose every output depends on its row:
    ``out[j] = sum(row) + j``, exact in fp32 for small integer rows."""
    from edl_tpu_torch.runtime.serving import ElasticServer

    lin = torch.nn.Linear(SIZES[0], WIDE)
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.copy_(torch.arange(WIDE, dtype=torch.float32))
    return ElasticServer(lambda m, b: m(b[0]), lin,
                         devices=[torch.device("cpu")])


def _wide_want(row):
    return np.float32(row.astype(np.float32).sum()) + np.arange(
        WIDE, dtype=np.float32)


def test_64kib_answers_pipelined_through_the_lb():
    """Answers of 64 KiB, pipelined 8 deep on each of 3 client sockets
    through the LB: every body spans many TCP segments and many
    pipelined answers share one upstream connection; each comes back
    whole, in order, to the right request."""
    kv = FakeKV()
    job = "tlbwide/fleet"
    doors = []
    for name in ("ra", "rb"):
        app = BatchApp(_wide_server, SIZES[0], job=job, replica=name, kv=kv,
                       max_batch=8, max_queue_ms=0.5, addr_ttl_s=5.0)
        doors.append(FrontDoor(app, host="127.0.0.1",
                               job=f"{job}-{name}").start())
        assert app.wait_ready(60)
    lb = ServingLB(job=job, host="127.0.0.1", kv=kv, pool=2,
                   discovery_s=0.1, sweep_ms=3.0, hedge_floor_ms=60_000.0,
                   hedge_cap_ms=60_000.0).start()
    try:
        assert wait_routable(lb, 2)
        socks = [connect(lb.port) for _ in range(3)]
        rows = {k: [np.full((SIZES[0],), 8 * k + i, np.float32)
                    for i in range(8)] for k in range(3)}
        for k, s in enumerate(socks):
            s.sendall(b"".join(build_predict_request(r) for r in rows[k]))
        for k, s in enumerate(socks):
            resps = read_raw_responses(s, 8, timeout=60)
            s.close()
            for (st, head, body), r in zip(resps, rows[k]):
                assert st == 200 and len(body) == WIDE * 4
                np.testing.assert_array_equal(np.frombuffer(body, "<f4"),
                                              _wide_want(r))
    finally:
        lb.stop()
        for d in doors:
            d.stop()


def test_upstream_parser_handles_64kib_answers_in_any_segments():
    """The LB's ``_UpstreamConn`` parser fed 8 pipelined 64 KiB answers
    (the first echoing its block's nonce) cut into random TCP-sized
    segments: both blocks complete with exactly their answers' bytes,
    no integrity failure."""
    from edl_tpu_torch.runtime.lb import LBApp, _Cell, _OutBlock, _Upstream
    from edl_tpu_torch.runtime.lb import _UpstreamConn

    lb = LBApp(job="tlbwide/parser")
    done = []
    lb.block_done = lambda blk, name=None: done.append(blk)
    up = _Upstream("r0", "127.0.0.1:1", lb)
    conn = _UpstreamConn(up, lb)
    body = np.arange(WIDE, dtype="<f4").tobytes()
    plain = (b"HTTP/1.1 200 OK\r\nContent-Type: application/x-edl-f32\r\n"
             b"Content-Length: %d\r\n\r\n" % len(body))
    blocks = []
    for b, n in enumerate((3, 5)):
        cell = _Cell()
        cell.nonce = f"nonce-{b}".encode()
        blk = _OutBlock(None, None, n, b"", cell)
        conn.expected.append(blk)
        conn.outstanding_rows += n
        blocks.append(blk)
    stream = b""
    for b, n in enumerate((3, 5)):
        echo = plain.replace(b"Content-Length",
                             b"X-EDL-Block-Nonce: nonce-%d\r\nContent-Length"
                             % b)
        stream += echo + body + (plain + body) * (n - 1)
    rng = np.random.default_rng(0)
    off = 0
    while off < len(stream):
        k = int(rng.integers(1, 70_000))
        conn.data_received(stream[off:off + k])
        off += k
    assert done == blocks
    assert get_counters().get("lb_integrity_failures",
                              job="tlbwide/parser") == 0
    for blk in blocks:
        data = b"".join(blk.acc)
        assert data.count(body) == blk.n
    assert conn.outstanding_rows == 0


# -- the FLAGSHIP-shaped path at TINY -----------------------------------------


@pytest.mark.timeout_s(180)
def test_flagship_frontdoor_replica_at_tiny_behind_the_lb():
    """``entry.flagship_frontdoor_replica`` at TINY on the CPU behind the
    port's LB: rows of token ids sent as f32 answer ``score_last_token``
    run directly and the reference's transformer scoring the same rows
    from the same (converted) params, within 1e-4 (fp32 logits)."""
    import jax

    from edl_tpu.models import transformer as jtfm
    from edl_tpu_torch.entry import (flagship_frontdoor_replica,
                                     score_last_token)
    from edl_tpu_torch.models import transformer as tfm
    from tests.torch_decode_ref import PARAMS as TPARAMS
    from tests.torch_decode_ref import port_model

    kv = FakeKV()
    job = "tlbflag/tiny"
    seq = 32
    model = port_model()
    doors = [flagship_frontdoor_replica(
        "cpu", tfm.TINY, params=port_model(), job=job, replica=f"r{i}",
        kv=kv, seq=seq, max_batch=4) for i in range(2)]
    lb = ServingLB(job=job, host="127.0.0.1", kv=kv, pool=2,
                   discovery_s=0.1, sweep_ms=3.0).start()
    try:
        for d in doors:
            assert d.app.wait_ready(120)
        assert wait_routable(lb, 2)
        toks = np.random.default_rng(9).integers(
            0, tfm.TINY.vocab_size, (10, seq))
        s = connect(lb.port)
        s.sendall(b"".join(build_predict_request(t.astype(np.float32))
                           for t in toks))
        resps = read_responses(s, len(toks))
        s.close()
        assert [st for st, _ in resps] == [200] * len(toks)
        got = np.stack([np.frombuffer(b, "<f4") for _, b in resps])
        assert got.shape == (len(toks), tfm.TINY.vocab_size)
        model.cfg = dataclasses.replace(model.cfg, use_flash=True)
        with torch.no_grad():
            direct = score_last_token(model, (torch.from_numpy(toks),))
        np.testing.assert_allclose(got, direct.numpy(), atol=1e-4,
                                   rtol=1e-4)
        ref = np.asarray(jax.jit(lambda t: jtfm.apply(
            TPARAMS, t, jtfm.TINY))(toks.astype(np.int32)))[:, -1]
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        assert sum(d.app.requests_served for d in doors) >= len(toks)
    finally:
        lb.stop()
        for d in doors:
            d.stop()


# -- the process entry points -------------------------------------------------


def _spawn(argv, log, env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.update(env_extra)
    return subprocess.Popen(argv, stdout=open(log, "w"),
                            stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _wait_line(proc, log, pattern, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        m = re.search(pattern, open(log).read())
        if m:
            return m
        if proc.poll() is not None:
            raise AssertionError(f"exited {proc.returncode}:\n"
                                 f"{open(log).read()[-3000:]}")
        time.sleep(0.1)
    raise AssertionError(f"no {pattern!r}:\n{open(log).read()[-3000:]}")


@pytest.mark.timeout_s(240)
def test_process_entry_points_ready_serve_and_exit_zero(tmp_path):
    """``python -m edl_tpu_torch.runtime.frontdoor --device cpu`` (the MLP
    replica), ``python -m edl_tpu_torch.entry frontdoor-replica --device
    cpu --config tiny`` (the FLAGSHIP-shaped replica at TINY), both
    published to the port's native coordinator, and ``python -m
    edl_tpu_torch.runtime.lb`` discovering the MLP replica: each prints
    its ready marker, the LB answers the plain MLP, SIGTERM exits 0 and
    the TINY replica reports its forwards."""
    from edl_tpu_torch.coord.server import spawn_server
    from edl_tpu_torch.entry import spawn_flagship_frontdoor_replica

    srv = spawn_server()
    coord = f"127.0.0.1:{srv.port}"
    procs = []
    try:
        rep = _spawn([sys.executable, "-m", "edl_tpu_torch.runtime.frontdoor",
                      "--device", "cpu"], tmp_path / "rep.log",
                     {"EDL_COORD_ENDPOINT": coord, "EDL_FD_JOB": "t/mlp",
                      "EDL_FD_MODEL": "mlp:16,32,4", "EDL_FD_REPLICA": "r0",
                      "EDL_FD_HOST": "127.0.0.1",
                      "EDL_FD_METRICS_PORT": "-1"})
        procs.append(rep)
        tiny = spawn_flagship_frontdoor_replica(
            "t0", coord=coord, job="t/tiny", device="cpu", config="tiny",
            log_path=str(tmp_path / "tiny.log"))
        procs.append(tiny)
        lb = _spawn([sys.executable, "-m", "edl_tpu_torch.runtime.lb"],
                    tmp_path / "lb.log",
                    {"EDL_COORD_ENDPOINT": coord, "EDL_LB_JOB": "t/mlp",
                     "EDL_LB_HOST": "127.0.0.1", "EDL_LB_METRICS_PORT": "-1",
                     "EDL_LB_DISCOVERY_S": "0.1"})
        procs.append(lb)
        _wait_line(rep, tmp_path / "rep.log", r"frontdoor ready port=(\d+)")
        m = _wait_line(tiny, tmp_path / "tiny.log",
                       r"frontdoor ready port=(\d+) replica=t0 "
                       r"metrics_port=\d+ build_s=[\d.]+ ready_s=[\d.]+")
        tiny_port = int(m.group(1))
        lb_port = int(_wait_line(lb, tmp_path / "lb.log",
                                 r"lb ready port=(\d+)").group(1))
        from edl_tpu_torch.models import mlp

        rows = np.random.default_rng(2).normal(size=(6, 16)).astype(
            np.float32)
        with torch.no_grad():
            want = mlp.apply(mlp.MLP([16, 32, 4], device="cpu", seed=0),
                             torch.from_numpy(rows)).numpy()
        deadline = time.monotonic() + 30
        while True:
            s = connect(lb_port)
            s.sendall(b"".join(build_predict_request(r) for r in rows))
            resps = read_responses(s, len(rows))
            s.close()
            if all(st == 200 for st, _ in resps) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)  # discovery has not dialed the replica yet
        assert [st for st, _ in resps] == [200] * len(rows)
        for (_, body), w in zip(resps, want):
            np.testing.assert_allclose(np.frombuffer(body, "<f4"), w,
                                       atol=ATOL, rtol=ATOL)
        s = connect(tiny_port)
        s.sendall(build_predict_request(np.arange(128, dtype=np.float32)))
        (st, body), = read_responses(s, 1)
        s.close()
        assert st == 200 and len(body) == 256 * 4
        for p in procs:
            p.send_signal(signal.SIGTERM)
        assert [p.wait(60) for p in procs] == [0, 0, 0]
        last = open(tmp_path / "tiny.log").read()
        assert re.search(r'frontdoor launches \{.*"forwards": [2-9]', last)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        srv.process.kill()


def test_replica_main_without_cuda_exits_3(monkeypatch, capsys):
    """No fallback hides the device: a replica asked for the card where
    there is none fails its build and exits 3, with no ready marker."""
    from edl_tpu_torch.runtime.frontdoor import replica_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = replica_main({"EDL_FD_MODEL": "mlp:16,32,4", "EDL_FD_REPLICA": "nc",
                       "EDL_FD_HOST": "127.0.0.1", "EDL_FD_LAG_PROBE_MS": "0",
                       "EDL_FD_METRICS_PORT": "-1"})
    out = capsys.readouterr().out
    assert rc == 3
    assert "frontdoor FAILED replica=nc" in out
    assert "frontdoor ready" not in out
