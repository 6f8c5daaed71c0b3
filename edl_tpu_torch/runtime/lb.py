"""The serving load-balancer tier — the port of edl_tpu.runtime.lb:
ready-gate-aware routing, pooled pipelined upstream connections, and
p99-derived request hedging.  It moves bytes only: no tensor, no device.

Between clients and the :mod:`~edl_tpu_torch.runtime.frontdoor` replicas sits
one (or more — the tier is stateless) ``ServingLB`` process:

* **discovery** — replicas are found through the TTL'd
  ``serving-addr/<job>/<replica>`` coordinator-KV keys each replica's
  front door publishes (value ``host:port <expiry> <state>``); the
  *state* field is the ready gate: ``building``/``reloading``/
  ``draining`` replicas take no new traffic while their in-flight work
  completes — a rolling reload is invisible to clients by construction.
* **connection pooling** — ``pool`` persistent HTTP/1.1 connections per
  upstream, requests pipelined; client request bytes are forwarded
  VERBATIM (they are already valid HTTP/1.1 — zero re-encode, zero
  re-parse beyond the front door's block scan) and upstream response
  bytes are forwarded verbatim back.
* **least-outstanding routing** — each block of pipelined requests goes
  to the ready upstream with the fewest outstanding rows.
* **hedging** — a sweep task watches every upstream's oldest
  outstanding block; past the hedge delay (``max(floor,
  k × observed-p99)``, recomputed continuously from the LB's own
  response latencies) the block is re-sent to a different replica.
  First response wins; the loser's response is consumed off its
  connection and discarded (with pipelining there is no un-send — the
  cancellation is at the response, exactly like production hedging).
* **failure rescue** — a dead upstream connection (killed replica)
  fails fast: every outstanding block is re-sent to a surviving
  replica, so a SIGKILL costs latency, not errors.
* **priority shedding** — the same ``X-EDL-Priority`` classes as the
  front door, applied against the LB-wide outstanding-row count: low
  sheds at the soft watermark, normal at the hard cap, high rides the
  reserve band.
* **circuit breaking** — each upstream carries a :class:`_Breaker`
  (doc/serving.md §gray-failure defenses): consecutive-error or
  windowed-error-rate trip ejects the replica from routing, a cooldown
  later a SINGLE half-open probe block must complete clean
  ``breaker_probes`` times before traffic returns.  Errors are 5xx
  responses, integrity failures, severed connections, and request
  timeouts — the gray-failure signals a crash-only health check never
  sees.
* **retry budget** — hedge twins and rescue resends draw from one
  token bucket (``retry_budget_cap`` burst, refilled ``retry_ratio``
  per admitted block), so a fleet-wide outage degrades to single-send
  instead of amplifying into a resend storm.
* **response integrity** — every forwarded block's first request
  carries an ``X-EDL-Block-Nonce`` that the replica must echo on the
  block's first response; a missing/mismatched echo (misroute, FIFO
  desync, corrupted payload) is never credited or forwarded — the
  connection is aborted (poisoned), the blocks rescue, and the breaker
  hears about it.
* **trace origin** — the LB opens every sampled request's CROSS-TIER
  span tree (doc/serving.md §request tracing): an ``lb_request`` root
  (admission → completion) with ``lb.route`` and one ``lb.upstream``
  span per dispatch — hedge twins as siblings marked
  ``win``/``discarded``, rescue resends parented to the ORIGINAL
  admission and the severed primary marked ``severed``.  Downstream,
  the replica's front door records parse→admit→queue→batch→forward→
  respond under the same trace id (``X-EDL-Trace-Id``) and nests via
  the injected ``X-EDL-Parent-Span``.  Sampling is tail-based
  (impossible to trace everything at 10⁵ qps): hedged / rescued /
  shed / timed-out / p-slowest blocks are always kept; a ~1 %
  deterministic head rate (``trace_sample``) covers the steady state,
  and only head-sampled blocks carry the header — the unsampled
  steady state stays byte-identical on the block parse.  Every tier's
  spans carry the one trace id, so the dumps of the LB and the replicas
  (:class:`~edl_tpu_torch.observability.tracing.TraceFileSink`) stitch
  by it.

Scrape names: ``edl_lb_requests_total`` / ``edl_lb_responses_total`` /
``edl_lb_hedges_total{result=win|lose}`` / ``edl_lb_rescues_total`` /
``edl_lb_overload_sheds_total{priority=}`` / ``edl_lb_timeouts_total``
/ ``edl_lb_discovery_sweeps_total`` /
``edl_lb_discovery_freezes_total`` /
``edl_lb_breaker_transitions_total{to=open|half_open|closed}`` /
``edl_lb_integrity_failures_total`` /
``edl_lb_retry_budget_exhausted_total`` /
``edl_traces_sampled_total{origin=}`` (counters),
``edl_lb_request_seconds`` (histogram, trace-id exemplars on its
buckets) / ``edl_loop_lag_seconds{loop=lb}`` (histogram),
``edl_lb_upstreams_ready`` / ``edl_lb_outstanding_rows`` /
``edl_lb_hedge_delay_ms`` /
``edl_lb_breaker_state{upstream=}`` (gauges; the breaker gauge's
upstream label is the bounded replica NAME, never addr:port churn) —
all labeled ``job=``.
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time
from typing import Optional

import numpy as np

from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (
    SERVING_LATENCY_BUCKETS, dump_flight_record, get_registry,
)
from edl_tpu_torch.observability.tracing import (
    get_tracer, new_span_id, new_trace_id,
)
from edl_tpu_torch.runtime.frontdoor import (
    FD_READY,
    PRI_HIGH,
    PRI_LOW,
    PRIORITY_NAMES,
    RESP_200_EMPTY,
    RESP_404,
    RESP_429,
    RESP_503,
    SERVING_ADDR_PREFIX,
    CoordBootstrapError,
    FrontDoor,
    HeadMeta,
    HttpConn,
    LoopLagProbe,
    bootstrap_kv,
    parse_serving_addr,
)

log = get_logger("runtime.lb")


def _inject_trace_headers(raw: bytes, trace_id: str,
                          parent_span: str) -> bytes:
    """Rebuild a forwarded block with ``X-EDL-Trace-Id`` +
    ``X-EDL-Parent-Span`` inserted into the FIRST request's head only:
    the traced member request takes the replica's slow parse once while
    the rest of the block stays byte-identical on the fixed-stride fast
    path — which is what keeps sampling off the steady state's cost
    model.  Headers already present (a client-supplied id, a hedge
    resend of already-injected bytes) are not duplicated."""
    i = raw.find(b"\r\n\r\n")
    if i < 0:
        return raw
    lower = raw[:i].lower()
    ins = b""
    if b"x-edl-trace-id:" not in lower:
        ins += b"X-EDL-Trace-Id: " + trace_id.encode("latin1") + b"\r\n"
    if b"x-edl-parent-span:" not in lower:
        ins += (b"X-EDL-Parent-Span: " + parent_span.encode("latin1")
                + b"\r\n")
    if not ins:
        return raw
    return raw[:i + 2] + ins + raw[i + 2:]


class _TraceCtx:
    """One sampled block's trace: the id the tiers stitch on, the LB
    root span every dispatch/door span parents to, and the dispatch
    records the hedge-duel outcomes land in.  Shared across hedge and
    rescue twins via the block's :class:`_Cell`."""

    __slots__ = ("tid", "root_sid", "t_admit", "n", "origin", "records",
                 "emitted")

    def __init__(self, tid: str, n: int, origin: str,
                 t_admit: Optional[float] = None) -> None:
        self.tid = tid
        self.root_sid = new_span_id()
        self.t_admit = (t_admit if t_admit is not None
                        else time.perf_counter())
        self.n = n
        self.origin = origin  # client | head | hedge | rescue | slow | …
        #: dispatch records: {kind, replica, sid, t0, t1, outcome}
        self.records: list[dict] = []
        self.emitted = False


def _strip_hop_headers(raw: bytes, meta: HeadMeta, n: int) -> bytes:
    """Drop the client's hop-by-hop ``Connection:`` line before
    forwarding (RFC 7230 §6.1): a ``close`` applies to the CLIENT hop
    only — forwarded verbatim it would make the replica tear down a
    pooled pipelined upstream connection (rescue-resending every other
    in-flight block on it) once per close-marked request."""
    head = raw[:meta.head_len]
    lower = head.lower()
    i = lower.find(b"\r\nconnection:")
    if i < 0:
        return raw
    j = lower.index(b"\r\n", i + 2)
    new_head = head[:i] + head[j:]
    if n == 1:
        return new_head + raw[meta.head_len:]
    stride = meta.total_len  # uniform block: identical heads at stride
    out = bytearray()
    for k in range(n):
        off = k * stride
        out += new_head
        out += raw[off + meta.head_len:off + stride]
    return bytes(out)


class _Cell:
    """Shared first-wins flag between a primary dispatch and its
    hedge/rescue twins: whoever completes first takes it; later
    completions are consumed and discarded.  ``trace`` carries the
    block's :class:`_TraceCtx` (None on the unsampled steady state) so
    a loser's late arrival still finds its duel's spans.  ``nonce``
    carries the block's integrity token (injected into the first
    request's head, echoed on the first response) — shared so hedge and
    rescue twins, which resend the same bytes, expect the same echo."""

    __slots__ = ("done", "trace", "nonce")

    def __init__(self) -> None:
        self.done = False
        self.trace: Optional[_TraceCtx] = None
        self.nonce: Optional[bytes] = None


class _OutBlock:
    """One dispatched run of pipelined requests awaiting ``n`` responses
    on one upstream connection."""

    __slots__ = ("conn", "slot", "n", "remaining", "req_bytes", "t_sent",
                 "t_admit", "cell", "kind", "acc", "hedged", "trace_rec",
                 "probe_up", "errors", "session")

    def __init__(self, conn, slot, n: int, req_bytes: bytes,
                 cell: _Cell, kind: str = "primary",
                 t_admit: Optional[float] = None) -> None:
        self.conn = conn              # client HttpConn (may be closed)
        self.slot = slot              # client RespSlot
        self.n = n
        self.remaining = n
        self.req_bytes = req_bytes    # retained for hedge/rescue resend
        self.t_sent = time.perf_counter()
        # original LB admission time, carried across hedge/rescue
        # resends: every timeout bound anchors here, so a rescued block
        # waits ONE request_timeout total, not a fresh one per resend
        self.t_admit = self.t_sent if t_admit is None else t_admit
        self.cell = cell
        self.kind = kind              # primary | hedge | rescue
        self.acc: list[bytes] = []    # response bytes, in order
        self.hedged = False
        self.trace_rec: Optional[dict] = None  # this dispatch's record
        #: upstream name whose half-open breaker this dispatch probes
        self.probe_up: Optional[str] = None
        self.errors = 0               # 5xx / integrity hits credited here
        #: decode-session id (X-EDL-Session) this block must stick to
        self.session: Optional[str] = None


class _UpstreamConn(asyncio.Protocol):
    """One pooled connection to one replica: pipelined writes, block
    response parsing with the same fixed-stride fast path as the front
    door (upstream responses to a fixed model are byte-identical heads),
    FIFO completion against the expected-block queue."""

    def __init__(self, upstream: "_Upstream", lb: "LBApp") -> None:
        self.up = upstream
        self.lb = lb
        self.transport = None
        self.connected = False
        self.expected: "collections.deque[_OutBlock]" = collections.deque()
        self._buf = bytearray()
        #: (head bytes, total response stride) — armed by the first
        #: parsed response
        self._fixed: Optional[tuple[bytes, int]] = None
        self.outstanding_rows = 0

    # -- lifecycle -----------------------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        try:
            import socket

            transport.get_extra_info("socket").setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except Exception:
            pass
        self.connected = True

    def connection_lost(self, exc) -> None:
        self.connected = False
        try:
            self.up.conns.remove(self)
        except ValueError:
            pass
        self.lb.on_upstream_conn_lost(self)

    # -- dispatch ------------------------------------------------------------

    def send_block(self, blk: _OutBlock) -> None:
        self.expected.append(blk)
        self.outstanding_rows += blk.n
        self.transport.write(blk.req_bytes)

    # -- response parsing ----------------------------------------------------

    def data_received(self, data: bytes) -> None:
        buf = self._buf
        buf += data
        while buf:
            if self._fixed is not None:
                head, stride = self._fixed
                n = len(buf) // stride
                if n > 0 and buf.startswith(head):
                    run = 1
                    while run < n and buf.startswith(head, run * stride):
                        run += 1
                    chunk = bytes(memoryview(buf)[:run * stride])
                    del buf[:run * stride]
                    self._feed_uniform(chunk, run, stride)
                    continue
            if not self._parse_one():
                break

    def _parse_one(self) -> bool:
        buf = self._buf
        idx = buf.find(b"\r\n\r\n")
        if idx < 0:
            return False
        head = bytes(memoryview(buf)[:idx + 4])
        lower = head.lower()
        body_len = 0
        # \r\n-anchored like HeadMeta's lookups (an unanchored match
        # could hit inside another header's name and desync framing)
        ci = lower.find(b"\r\ncontent-length:")
        if ci >= 0:
            end = lower.index(b"\r\n", ci + 2)
            try:
                body_len = int(lower[ci + 17:end].strip())
            except ValueError:
                pass
        total = len(head) + body_len
        if len(buf) < total:
            return False
        raw = bytes(memoryview(buf)[:total])
        del buf[:total]
        status_2xx = lower.startswith(b"http/1.1 2")
        nonce = None
        ni = lower.find(b"\r\nx-edl-block-nonce:")
        if ni >= 0:
            ne = lower.index(b"\r\n", ni + 2)
            nonce = bytes(lower[ni + 20:ne].strip())
        blk = self.expected[0] if self.expected else None
        if blk is not None:
            # the block's FIRST response must echo its nonce; later
            # responses (and other blocks' responses) must not carry
            # one.  A mismatch is a misroute / FIFO desync / corrupted
            # payload — poison, never credited or forwarded.
            want = blk.cell.nonce if blk.remaining == blk.n else None
            if status_2xx and nonce != want:
                self.lb.integrity_failure(
                    self, blk,
                    "missing echo" if nonce is None else "bad echo")
                return False
            if status_2xx:
                self.up.breaker.record_ok()
            elif lower.startswith(b"http/1.1 5"):
                blk.errors += 1
                self.up.breaker.record_error(why="5xx")
        # arm the fast path only on the STEADY-STATE head: a traced
        # response's echoed X-EDL-Trace-Id head (or a nonce echo) is
        # unique to its request — arming on it would push every
        # following (plain) response onto the slow parse until the
        # next re-arm
        if lower.startswith(b"http/1.1 200") and body_len \
                and b"\r\nx-edl-trace-id:" not in lower \
                and b"\r\nx-edl-block-nonce:" not in lower:
            self._fixed = (head, total)
        self._feed(raw, 1)
        return True

    def _feed_uniform(self, chunk: bytes, count: int, stride: int) -> None:
        """``count`` uniform responses of ``stride`` bytes: fill the
        expected-block queue head-first, slicing per block."""
        self.up.breaker.record_ok(count)  # armed head is a steady 200
        off = 0
        while count > 0 and self.expected:
            blk = self.expected[0]
            if blk.cell.nonce is not None and blk.remaining == blk.n:
                # the block's first response must carry the nonce echo,
                # which can never match the armed steady head — a
                # fast-path hit here means the stream desynced
                self.lb.integrity_failure(self, blk, "missing echo")
                return
            take = min(count, blk.remaining)
            blk.acc.append(chunk[off:off + take * stride]
                           if (off or take * stride != len(chunk))
                           else chunk)
            blk.remaining -= take
            self.outstanding_rows -= take
            off += take * stride
            count -= take
            if blk.remaining == 0:
                self.expected.popleft()
                self.lb.block_done(blk, self.up.name)
        if count > 0:
            log.warn("upstream sent unexpected responses",
                     upstream=self.up.name, extra=count)

    def _feed(self, raw: bytes, count: int) -> None:
        for _ in range(count):
            if not self.expected:
                log.warn("upstream sent unexpected response",
                         upstream=self.up.name)
                return
            blk = self.expected[0]
            blk.acc.append(raw)
            blk.remaining -= 1
            self.outstanding_rows -= 1
            if blk.remaining == 0:
                self.expected.popleft()
                self.lb.block_done(blk, self.up.name)


#: circuit breaker states — the gauge values of
#: ``edl_lb_breaker_state{upstream=}`` (and what
#: :mod:`~edl_tpu_torch.runtime.faults` reads for its recovery predicates)
BRK_CLOSED, BRK_OPEN, BRK_HALF = 0, 1, 2
_BRK_NAMES = ("closed", "open", "half_open")


class _Breaker:
    """Per-upstream circuit breaker (doc/serving.md §gray-failure
    defenses).  CLOSED → OPEN on ``breaker_errors`` consecutive errors
    or a windowed error rate ≥ ``breaker_ratio`` over ≥ ``breaker_min``
    responses; OPEN → HALF_OPEN when ``breaker_cooldown_s`` elapses
    (ticked by the sweep); HALF_OPEN admits ONE probe block at a time
    and re-CLOSEs after ``breaker_probes`` clean probes — any probe
    failure re-OPENs.  Errors are 5xx responses, integrity failures,
    severed connections, and request timeouts.  All mutation happens on
    the door's loop thread; :meth:`routable` is pure attribute reads
    (the scrape thread's gauge_fn path calls it)."""

    __slots__ = ("lb", "name", "state", "consec", "win_n", "win_err",
                 "win_t0", "open_until", "opened_at", "probe_inflight",
                 "probe_ok")

    def __init__(self, lb: "LBApp", name: str) -> None:
        self.lb = lb
        self.name = name
        self.state = BRK_CLOSED
        self.consec = 0
        self.win_n = 0
        self.win_err = 0
        self.win_t0 = time.perf_counter()
        self.open_until = 0.0
        self.opened_at = 0.0
        self.probe_inflight = 0
        self.probe_ok = 0

    def routable(self) -> bool:
        if self.state == BRK_CLOSED:
            return True
        if self.state == BRK_HALF:
            return self.probe_inflight == 0
        return False

    def record_ok(self, n: int = 1) -> None:
        self.consec = 0
        self.win_n += n

    def record_error(self, n: int = 1, why: str = "") -> None:
        now = time.perf_counter()
        if now - self.win_t0 > self.lb.breaker_window_s:
            self.win_t0 = now
            self.win_n = 0
            self.win_err = 0
        self.consec += n
        self.win_n += n
        self.win_err += n
        if self.state != BRK_CLOSED:
            return
        if self.consec >= self.lb.breaker_errors or (
                self.win_n >= self.lb.breaker_min
                and self.win_err / self.win_n >= self.lb.breaker_ratio):
            self._trip(now, why)

    def _trip(self, now: float, why: str) -> None:
        self.open_until = now + self.lb.breaker_cooldown_s
        self.opened_at = now
        self._set(BRK_OPEN)
        log.warn("breaker opened", upstream=self.name,
                 why=why or "errors", consec=self.consec,
                 window_err=self.win_err)
        self.lb._on_breaker_open(self.name, why or "errors")

    def tick(self, now: float) -> None:
        if self.state == BRK_OPEN and now >= self.open_until:
            self.probe_ok = 0
            self.probe_inflight = 0
            self._set(BRK_HALF)
            log.info("breaker half-open", upstream=self.name)

    def probe_result(self, ok: bool) -> None:
        self.probe_inflight = max(self.probe_inflight - 1, 0)
        if self.state != BRK_HALF:
            return
        if not ok:
            self._trip(time.perf_counter(), "probe failed")
            return
        self.probe_ok += 1
        if self.probe_ok >= self.lb.breaker_probes:
            self.consec = 0
            self.win_n = 0
            self.win_err = 0
            self._set(BRK_CLOSED)
            log.info("breaker closed", upstream=self.name)

    def _set(self, state: int) -> None:
        self.state = state
        self.lb._breaker_gauge.set(state, job=self.lb.job,
                                   upstream=self.name)
        self.lb._c.inc("lb_breaker_transitions", job=self.lb.job,
                       to=_BRK_NAMES[state])


class _Upstream:
    """One replica as the LB sees it: address, gate state, conn pool,
    circuit breaker."""

    __slots__ = ("name", "addr", "state", "conns", "dialing", "last_seen",
                 "requests", "breaker")

    def __init__(self, name: str, addr: str, lb: "LBApp") -> None:
        self.name = name
        self.addr = addr
        self.state = FD_READY
        self.conns: list[_UpstreamConn] = []
        self.dialing = 0
        self.last_seen = time.monotonic()
        self.requests = 0
        self.breaker = _Breaker(lb, name)

    def routable(self) -> bool:
        return (self.state == FD_READY and bool(self.conns)
                and self.breaker.routable())

    def outstanding(self) -> int:
        return sum(c.outstanding_rows for c in self.conns)

    def least_loaded_conn(self) -> Optional[_UpstreamConn]:
        live = [c for c in self.conns if c.connected]
        if not live:
            return None
        return min(live, key=lambda c: c.outstanding_rows)


class LBApp:
    """The LB's front-door app + upstream manager.  Runs entirely on the
    door's event loop (discovery feeds it via ``call_soon_threadsafe``),
    so no routing state needs locks."""

    wants_raw = True

    def __init__(self, *, job: str = "job", kv=None,
                 static_upstreams: Optional[dict[str, str]] = None,
                 pool: int = 2, discovery_s: float = 0.5,
                 hedge_floor_ms: float = 10.0, hedge_cap_ms: float = 1000.0,
                 hedge_k: float = 3.0, request_timeout_s: float = 30.0,
                 hard_cap_rows: int = 65536, soft_cap_rows: int = 0,
                 sweep_ms: float = 5.0, addr_grace_s: float = 5.0,
                 trace: bool = True, trace_sample: float = 0.01,
                 tail_slow_quantile: float = 0.99,
                 slo_ms: float = 0.0,
                 breaker_errors: int = 5, breaker_ratio: float = 0.5,
                 breaker_min: int = 20, breaker_window_s: float = 1.0,
                 breaker_cooldown_s: float = 1.0, breaker_probes: int = 2,
                 retry_budget_cap: float = 256.0,
                 retry_ratio: float = 0.2, integrity: bool = True,
                 flight_dir: str = "") -> None:
        self.job = job
        self.kv = kv
        self.static_upstreams = dict(static_upstreams or {})
        self.pool = max(int(pool), 1)
        self.discovery_s = float(discovery_s)
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.hedge_cap_ms = float(hedge_cap_ms)
        self.hedge_k = float(hedge_k)
        self.request_timeout_s = float(request_timeout_s)
        self.hard_cap = max(int(hard_cap_rows), 1)
        self.soft_cap = (int(soft_cap_rows) if soft_cap_rows
                         else self.hard_cap // 2)
        self.high_cap = self.hard_cap + self.hard_cap // 4
        self.sweep_ms = float(sweep_ms)
        self.addr_grace_s = float(addr_grace_s)
        # -- gray-failure defenses (doc/serving.md §gray-failure
        # defenses): per-upstream circuit breakers, a fleet-wide resend
        # token bucket, and per-block response-integrity nonces
        self.breaker_errors = max(int(breaker_errors), 1)
        self.breaker_ratio = float(breaker_ratio)
        self.breaker_min = max(int(breaker_min), 1)
        self.breaker_window_s = float(breaker_window_s)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.breaker_probes = max(int(breaker_probes), 1)
        self.retry_budget_cap = float(retry_budget_cap)
        self.retry_ratio = float(retry_ratio)
        self._retry_tokens = self.retry_budget_cap
        self.integrity = bool(integrity)
        self._nonce_prefix = new_span_id()
        self._nonce_seq = 0
        self.flight_dir = str(flight_dir or "")
        self.door: Optional[FrontDoor] = None
        self.upstreams: dict[str, _Upstream] = {}
        self.outstanding_rows = 0
        self.hedge_delay_s = self.hedge_floor_ms / 1e3
        #: blocks with no routable upstream yet: (deadline, blk)
        self._parked: "collections.deque[tuple[float, _OutBlock]]" = (
            collections.deque())
        self._paused_conns: set = set()
        self._lat_ring = np.zeros(4096, np.float64)
        self._lat_n = 0
        self._lat_i = 0
        self._discovery: Optional[threading.Thread] = None
        self._disc_frozen = False
        self._halt = threading.Event()
        self._sweep_handle = None
        self._sweep_n = 0
        # -- tail-sampled request tracing (the LB is the trace ORIGIN:
        # doc/serving.md §request tracing).  Head sampling is
        # deterministic — every `1/trace_sample`-th admitted block gets
        # a trace id injected into its first request; hedged / rescued
        # / shed / timed-out and p-slowest blocks are promoted at the
        # tail regardless, so the interesting 0.1% is always kept.
        self.trace_enabled = bool(trace)
        self.trace_sample = max(float(trace_sample), 0.0)
        self._head_every = (int(round(1.0 / self.trace_sample))
                            if self.trace_sample > 0 else 0)
        self._blocks_seen = 0
        self.tail_slow_quantile = min(max(float(tail_slow_quantile),
                                          0.0), 1.0)
        self.slo_ms = float(slo_ms)
        self._slow_keep_s = float("inf")
        self._last_shed_trace = 0.0
        #: completed trace records — what flight records embed
        self.exemplars: "collections.deque[dict]" = collections.deque(
            maxlen=256)
        reg = get_registry()
        self._c = get_counters()
        self._hist = reg.histogram(
            "lb_request_seconds",
            help="LB-observed latency, dispatch to upstream response",
            buckets=SERVING_LATENCY_BUCKETS)
        reg.gauge_fn("lb_upstreams_ready",
                     lambda: sum(1 for u in self.upstreams.values()
                                 if u.routable()),
                     help="replicas currently routable", job=job)
        reg.gauge_fn("lb_outstanding_rows", lambda: self.outstanding_rows,
                     help="requests in flight to upstreams", job=job)
        self._hedge_gauge = reg.gauge(
            "lb_hedge_delay_ms",
            help="current p99-derived hedge delay")
        self._breaker_gauge = reg.gauge(
            "lb_breaker_state",
            help="per-upstream circuit breaker: 0 closed / 1 open / "
                 "2 half-open")
        # zero-sample pre-registration: the strict exposition parser
        # (and the dashboards) see every defense series from scrape #1
        self._c.inc("lb_integrity_failures", 0, job=job)
        self._c.inc("lb_retry_budget_exhausted", 0, job=job)
        self._c.inc("lb_discovery_freezes", 0, job=job)
        self._c.inc("lb_affinity_repins", 0, job=job)
        self._c.inc("lb_affinity_evictions", 0, job=job)
        #: session-id → upstream name (decode KV affinity).  Bounded
        #: LRU: an abandoned session's pin ages out instead of leaking;
        #: a re-arriving aged-out session just re-pins (the decode
        #: fleet's handoff covers the cache move)
        self._affinity: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict())
        self._affinity_cap = 4096
        for to in _BRK_NAMES:
            self._c.inc("lb_breaker_transitions", 0, job=job, to=to)

    # -- lifecycle -----------------------------------------------------------

    def attach(self, door: FrontDoor) -> None:
        self.door = door
        self._hedge_gauge.set(round(self.hedge_delay_s * 1e3, 3),
                              job=self.job)
        for name, addr in self.static_upstreams.items():
            self._apply_target(name, addr, FD_READY)
        self._schedule_sweep()
        if self.kv is not None:
            self._discovery = threading.Thread(
                target=self._discover_loop, daemon=True,
                name=f"lb-discovery-{self.job}")
            self._discovery.start()

    def detach(self) -> None:
        self._halt.set()
        if self._discovery is not None:
            self._discovery.join(timeout=5)

    # -- discovery (own thread → loop) ---------------------------------------

    def _discover_loop(self) -> None:
        prefix = f"{SERVING_ADDR_PREFIX}{self.job}/"
        while not self._halt.wait(self.discovery_s):
            try:
                targets: dict[str, tuple[str, str]] = {}
                for key in self.kv.kv_keys(prefix):
                    value = self.kv.kv_get(key)
                    if value is None:
                        continue
                    addr, state, expired = parse_serving_addr(value)
                    if addr is None or expired:
                        continue
                    targets[key[len(prefix):]] = (addr, state)
                self._c.inc("lb_discovery_sweeps", job=self.job)
                self.door.call_soon(self._apply_targets, targets)
            except Exception as exc:
                # a coordinator partition: _apply_targets never runs,
                # so addr_grace_s aging is implicitly frozen — serving
                # continues on last-known addresses
                self._c.inc("lb_discovery_freezes", job=self.job)
                log.warn("discovery sweep failed; aging frozen",
                         error=str(exc)[:120])

    def _apply_targets(self, targets: dict) -> None:
        now = time.monotonic()
        for name, (addr, state) in targets.items():
            self._apply_target(name, addr, state, now)
        if not targets and any(n not in self.static_upstreams
                               for n in self.upstreams):
            # EVERY dynamic target vanished in one sweep — that is a
            # coordinator partition or KV wipe (server-side TTL expiry
            # after a partition heals), not a fleet-wide replica death:
            # freeze aging and keep serving on last-known addresses.
            # The next non-empty sweep refreshes last_seen and re-arms
            # addr_grace_s aging.
            self._c.inc("lb_discovery_freezes", job=self.job)
            if not self._disc_frozen:
                self._disc_frozen = True
                log.warn("discovery returned no targets; aging frozen",
                         upstreams=len(self.upstreams))
            return
        if targets and self._disc_frozen:
            self._disc_frozen = False
            log.info("discovery recovered; aging re-armed")
        # a replica that vanished from KV (TTL expiry after a kill, or a
        # clean unpublish) is dropped after a short grace; its dead
        # connections already rescued their blocks on connection_lost
        for name in list(self.upstreams):
            if name in targets or name in self.static_upstreams:
                continue
            up = self.upstreams[name]
            if now - up.last_seen > self.addr_grace_s:
                for conn in list(up.conns):
                    try:
                        conn.transport.close()
                    except Exception:
                        pass
                del self.upstreams[name]
                try:
                    self._breaker_gauge.remove(job=self.job,
                                               upstream=name)
                except Exception:
                    pass
                log.info("upstream dropped", upstream=name)

    def _apply_target(self, name: str, addr: str, state: str,
                      now: Optional[float] = None) -> None:
        up = self.upstreams.get(name)
        if up is None:
            up = _Upstream(name, addr, self)
            up.state = state
            self.upstreams[name] = up
            # pin the breaker series at discovery: bounded label set
            # (replica name), visible to the strict parser before the
            # first transition
            self._breaker_gauge.set(BRK_CLOSED, job=self.job,
                                    upstream=name)
            log.info("upstream discovered", upstream=name, addr=addr,
                     state=state)
        else:
            if state != up.state:
                log.info("upstream state", upstream=name, state=state)
            up.state = state
            up.addr = addr
        up.last_seen = now if now is not None else time.monotonic()
        self._fill_pool(up)

    def _fill_pool(self, up: _Upstream) -> None:
        want = self.pool if up.state == FD_READY else min(self.pool, 1)
        while len(up.conns) + up.dialing < want:
            up.dialing += 1
            asyncio.ensure_future(self._dial(up))

    async def _dial(self, up: _Upstream) -> None:
        host, _, port = up.addr.rpartition(":")
        try:
            _, proto = await asyncio.wait_for(
                asyncio.get_running_loop().create_connection(
                    lambda: _UpstreamConn(up, self), host, int(port)),
                timeout=5.0)
            up.conns.append(proto)
        except Exception as exc:
            log.warn("upstream dial failed", upstream=up.name,
                     addr=up.addr, error=str(exc)[:120])
        finally:
            up.dialing -= 1

    # -- client-side dispatch (loop thread) ----------------------------------

    def handle_raw_block(self, conn: HttpConn, raw: bytes, n: int,
                         meta: HeadMeta) -> None:
        pri = meta.priority
        qd = self.outstanding_rows
        if pri == PRI_LOW and qd + n > self.soft_cap:
            self._shed(conn, n, pri)
            return
        cap = self.high_cap if pri == PRI_HIGH else self.hard_cap
        if qd + n > cap:
            self._shed(conn, n, pri)
            conn.pause()
            self._paused_conns.add(conn)
            return
        self._c.inc("lb_requests", n, job=self.job)
        # every admitted block refills the resend token bucket a little
        # — the budget scales with real traffic, not wall time
        if self._retry_tokens < self.retry_budget_cap:
            self._retry_tokens = min(self.retry_budget_cap,
                                     self._retry_tokens + self.retry_ratio)
        if not meta.keep_alive:  # rare: off the byte-identical hot path
            raw = _strip_hop_headers(raw, meta, n)
        ctx: Optional[_TraceCtx] = None
        if self.trace_enabled:
            if meta.trace_id:
                # client-supplied id: always traced; inject only the
                # parent-span header so the door tree nests under ours
                ctx = _TraceCtx(meta.trace_id, n, "client")
                raw = _inject_trace_headers(raw, ctx.tid, ctx.root_sid)
            elif self._head_every:
                self._blocks_seen += 1
                if self._blocks_seen >= self._head_every:
                    self._blocks_seen = 0
                    ctx = _TraceCtx(new_trace_id(), n, "head")
                    raw = _inject_trace_headers(raw, ctx.tid,
                                                ctx.root_sid)
        nonce = None
        if self.integrity:
            # per-block integrity nonce: rides the FIRST request's head
            # (one slow parse at the replica, like a trace header), must
            # echo on the block's first response.  Resends reuse
            # req_bytes, so hedge/rescue twins expect the same echo.
            self._nonce_seq += 1
            i = raw.find(b"\r\n\r\n")
            if i >= 0:
                nonce = (f"{self._nonce_prefix}-{self._nonce_seq:x}"
                         .encode("latin1"))
                raw = (raw[:i + 2] + b"X-EDL-Block-Nonce: " + nonce
                       + b"\r\n" + raw[i + 2:])
        slot = conn.push_slot(n)
        blk = _OutBlock(conn, slot, n, raw, _Cell())
        blk.cell.trace = ctx
        blk.cell.nonce = nonce
        blk.session = meta.session
        self.outstanding_rows += n
        self._dispatch(blk)

    # -- trace emission (sampled blocks only) --------------------------------

    def _trace_dispatch(self, ctx: _TraceCtx, blk: _OutBlock,
                        up_name: str) -> None:
        """Open one dispatch record (a primary send, a hedge twin, a
        rescue resend) — the spans the duel outcomes land in."""
        rec = {"kind": blk.kind, "replica": up_name,
               "sid": new_span_id(), "t0": time.perf_counter(),
               "t1": None, "outcome": None}
        ctx.records.append(rec)
        blk.trace_rec = rec

    def _trace_rec_end(self, ctx: _TraceCtx, rec: Optional[dict],
                       outcome: str) -> None:
        """Close one dispatch record and emit its ``lb.upstream`` span
        (hedge twins are SIBLINGS under the admission root, each marked
        ``win`` / ``discarded`` / ``severed`` / ``timeout``)."""
        if rec is None or rec["t1"] is not None:
            return
        rec["t1"] = time.perf_counter()
        rec["outcome"] = outcome
        get_tracer().record_span(
            "lb.upstream", "lb", rec["t0"], rec["t1"],
            trace_id=ctx.tid, span_id=rec["sid"],
            parent_id=ctx.root_sid, replica=rec["replica"],
            kind=rec["kind"], outcome=outcome)

    def _trace_complete(self, ctx: _TraceCtx, outcome: str,
                        lat_s: float) -> None:
        """Emit the trace's root (``lb_request``: admission → done) and
        route span, land the completed record in the exemplar ring +
        the latency histogram's exemplar slot, and count it sampled.
        Idempotent — the first completion (winner or timeout) wins."""
        if ctx.emitted:
            return
        ctx.emitted = True
        now = time.perf_counter()
        tracer = get_tracer()
        kinds = {r["kind"] for r in ctx.records}
        tracer.record_span(
            "lb_request", "lb", ctx.t_admit, now,
            trace_id=ctx.tid, span_id=ctx.root_sid, job=self.job,
            n=ctx.n, origin=ctx.origin, outcome=outcome,
            latency_ms=round(lat_s * 1e3, 3),
            hedged="hedge" in kinds, rescued="rescue" in kinds)
        if ctx.records:
            tracer.record_span("lb.route", "lb", ctx.t_admit,
                               ctx.records[0]["t0"], trace_id=ctx.tid,
                               parent_id=ctx.root_sid)
        self._hist.put_exemplar(lat_s, ctx.tid, job=self.job)
        self.exemplars.append({
            "trace_id": ctx.tid, "origin": ctx.origin,
            "outcome": outcome, "n": ctx.n,
            "latency_ms": round(lat_s * 1e3, 3),
            "hedged": "hedge" in kinds, "rescued": "rescue" in kinds,
        })
        self._c.inc("traces_sampled", job=self.job, origin=ctx.origin)

    def _trace_timeout(self, blk: _OutBlock, now: float,
                       up_name: Optional[str] = None) -> None:
        """An expired block (parked or wedged-upstream) is an errored
        request — always kept by the tail sampler."""
        if not self.trace_enabled:
            return
        ctx = blk.cell.trace
        if ctx is None:
            if up_name is not None and blk.t_sent:
                ctx = self._trace_promote(blk, "timeout", up_name)
            else:  # never dispatched: no upstream record to close
                ctx = _TraceCtx(new_trace_id(), blk.n, "timeout",
                                t_admit=blk.t_admit)
                blk.cell.trace = ctx
        self._trace_rec_end(ctx, blk.trace_rec, "timeout")
        self._trace_complete(ctx, "timeout", now - blk.t_admit)

    def _trace_promote(self, blk: _OutBlock, origin: str,
                       up_name: str) -> _TraceCtx:
        """Tail promotion of an UNSAMPLED in-flight block (it just got
        hedged, rescued, or timed out — the always-keep set): open its
        ctx retroactively, with a record for the dispatch already in
        flight so the duel reads complete."""
        ctx = _TraceCtx(new_trace_id(), blk.n, origin,
                        t_admit=blk.t_admit)
        blk.cell.trace = ctx
        rec = {"kind": blk.kind, "replica": up_name,
               "sid": new_span_id(), "t0": blk.t_sent,
               "t1": None, "outcome": None}
        ctx.records.append(rec)
        blk.trace_rec = rec
        return ctx

    def handle_request(self, conn: HttpConn, meta: HeadMeta, body: bytes,
                       raw: bytes) -> None:
        if meta.method == "GET":
            if meta.path == "/healthz":
                ok = any(u.routable() for u in self.upstreams.values())
                conn.complete(conn.push_slot(1),
                              RESP_200_EMPTY if ok else RESP_503)
            else:
                conn.complete(conn.push_slot(1), RESP_404)
            return
        if meta.method != "POST" or meta.path not in ("/predict",
                                                      "/generate"):
            # NOT a transparent proxy for the replica admin surface:
            # /admin/* (stall/drain/activate/reload) on the public LB
            # endpoint would hand any client the drill controls
            conn.complete(conn.push_slot(1), RESP_404)
            return
        # /predict and /generate (JSON included) forward verbatim;
        # /generate blocks additionally carry session affinity
        self.handle_raw_block(conn, raw, 1, meta)

    def on_conn_lost(self, conn: HttpConn) -> None:
        # in-flight blocks complete into a closed conn harmlessly
        self._paused_conns.discard(conn)

    def _shed(self, conn: HttpConn, n: int, pri: int) -> None:
        conn.complete(conn.push_slot(n), RESP_429 * n)
        self._c.inc("lb_overload_sheds", n, job=self.job,
                    priority=PRIORITY_NAMES[pri])
        # sheds are in the tail sampler's always-keep set, but overload
        # sheds come in floods — keep at most ~10/s so the trace ring
        # records that shedding HAPPENED (and at what depth) without
        # the flood becoming its own overload
        if self.trace_enabled:
            now = time.perf_counter()
            if now - self._last_shed_trace >= 0.1:
                self._last_shed_trace = now
                tid = new_trace_id()
                get_tracer().record_span(
                    "lb_request", "lb", now, now, trace_id=tid,
                    job=self.job, n=n, origin="shed", outcome="shed",
                    priority=PRIORITY_NAMES[pri],
                    outstanding_rows=self.outstanding_rows)
                self.exemplars.append({
                    "trace_id": tid, "origin": "shed",
                    "outcome": "shed", "n": n, "latency_ms": 0.0,
                    "hedged": False, "rescued": False,
                })
                self._c.inc("traces_sampled", job=self.job,
                            origin="shed")

    def _pick(self, exclude=None) -> Optional[_Upstream]:
        best = None
        best_load = None
        for up in self.upstreams.values():
            if up is exclude or not up.routable():
                continue
            load = up.outstanding()
            if best is None or load < best_load:
                best, best_load = up, load
        return best

    def _pick_affine(self, blk: _OutBlock, exclude=None
                     ) -> Optional[_Upstream]:
        """Session affinity: a block carrying ``X-EDL-Session`` sticks
        to the replica holding its KV cache.  A dead/unroutable pin
        falls back to least-outstanding and RE-PINS — the decode
        fleet's rescue (re-prefill / KV handoff) makes the new replica
        correct, the repin makes it sticky again."""
        sid = blk.session
        if sid is None:
            return self._pick(exclude)
        pinned = self._affinity.get(sid)
        if pinned is not None:
            up = self.upstreams.get(pinned)
            if up is not None and up.routable() and up is not exclude:
                self._affinity.move_to_end(sid)
                return up
        up = self._pick(exclude)
        if up is not None:
            if pinned is not None and pinned != up.name:
                self._c.inc("lb_affinity_repins", job=self.job)
            self._affinity[sid] = up.name
            self._affinity.move_to_end(sid)
            while len(self._affinity) > self._affinity_cap:
                self._affinity.popitem(last=False)
        return up

    def _maybe_evict_affinity(self, blk: _OutBlock) -> None:
        """Drop a session's affinity pin the moment its session ENDS —
        a terminal response (``X-EDL-Session-Done`` from the front
        door's /generate completion) or a 5xx failure — instead of
        waiting for LRU-cap pressure.  A long-lived LB otherwise keeps
        stale pins that can route a reused session id straight at a
        drained upstream."""
        ended = blk.errors > 0
        if not ended and blk.acc:
            first = blk.acc[0]
            head_end = first.find(b"\r\n\r\n")
            if head_end >= 0:
                ended = (b"\r\nx-edl-session-done:"
                         in first[:head_end + 4].lower())
        if ended and self._affinity.pop(blk.session, None) is not None:
            self._c.inc("lb_affinity_evictions", job=self.job)

    def _dispatch(self, blk: _OutBlock, exclude=None) -> None:
        up = self._pick_affine(blk, exclude)
        if up is None and exclude is not None:
            up = self._pick_affine(blk, None)  # busy twin over nothing
        if up is None:
            self._parked.append(
                (blk.t_admit + self.request_timeout_s, blk))
            return
        conn = up.least_loaded_conn()
        if conn is None:
            self._parked.append(
                (blk.t_admit + self.request_timeout_s, blk))
            return
        up.requests += blk.n
        if up.breaker.state == BRK_HALF:
            # this dispatch IS the half-open probe: one at a time —
            # routable() holds further traffic until it settles
            up.breaker.probe_inflight += 1
            blk.probe_up = up.name
        blk.t_sent = time.perf_counter()
        if blk.cell.trace is not None:
            self._trace_dispatch(blk.cell.trace, blk, up.name)
        conn.send_block(blk)

    # -- completion ----------------------------------------------------------

    def block_done(self, blk: _OutBlock,
                   up_name: Optional[str] = None) -> None:
        # a fully-credited block settles its half-open probe (winner or
        # discarded loser alike: the upstream answered)
        self._probe_settle(blk, True)
        ctx = blk.cell.trace
        if blk.cell.done:
            # consumed but discarded: ONLY a hedge-duel participant
            # (the hedge twin, or a primary/rescue that was hedged)
            # counts toward the win/lose series the dashboards read as
            # duel outcomes — an unhedged rescue's duplicate or a
            # post-timeout response is a late response, not a lost duel
            duel = blk.hedged or blk.kind == "hedge"
            if duel:
                self._c.inc("lb_hedges", blk.n, job=self.job,
                            result="lose")
            else:
                self._c.inc("lb_late_responses", blk.n, job=self.job)
            if ctx is not None:
                # the loser's span, marked for what it was — emitted on
                # arrival, stitched by id (the root already emitted)
                self._trace_rec_end(ctx, blk.trace_rec,
                                    "discarded" if duel else "late")
            return
        blk.cell.done = True
        if blk.session is not None:
            self._maybe_evict_affinity(blk)
        now = time.perf_counter()
        lat = now - blk.t_sent
        self._record_lat(lat)
        self._hist.observe(lat, job=self.job)
        self._c.inc("lb_responses", blk.n, job=self.job)
        if blk.kind == "hedge":
            self._c.inc("lb_hedges", blk.n, job=self.job, result="win")
        elif blk.kind == "rescue":
            self._c.inc("lb_rescues", blk.n, job=self.job)
        self.outstanding_rows -= blk.n
        if not blk.conn.closed:
            blk.conn.complete(
                blk.slot,
                blk.acc[0] if len(blk.acc) == 1 else b"".join(blk.acc))
        lat_admit = now - blk.t_admit
        if ctx is None and self.trace_enabled and (
                lat_admit > self._slow_keep_s
                or (self.slo_ms and lat_admit * 1e3 > self.slo_ms)):
            # tail keep: the p-slowest / SLO-violating completions are
            # sampled even though no header ever left — LB-side spans
            # only (there is no retroactive downstream propagation),
            # which still answers WHERE the time went at this tier
            ctx = self._trace_promote(
                blk, "slo" if self.slo_ms
                and lat_admit * 1e3 > self.slo_ms else "slow",
                up_name or "?")
        if ctx is not None:
            self._trace_rec_end(ctx, blk.trace_rec, "win")
            self._trace_complete(ctx, "served", lat_admit)
        self._maybe_resume()

    def _maybe_resume(self) -> None:
        if self._paused_conns and self.outstanding_rows < self.soft_cap // 2:
            for c in list(self._paused_conns):
                c.resume()
            self._paused_conns.clear()

    def _record_lat(self, lat: float) -> None:
        self._lat_ring[self._lat_i] = lat
        self._lat_i = (self._lat_i + 1) % len(self._lat_ring)
        self._lat_n = min(self._lat_n + 1, len(self._lat_ring))

    # -- gray-failure defenses -----------------------------------------------

    def _probe_settle(self, blk: _OutBlock, ok: bool) -> None:
        """Settle a half-open probe dispatch exactly once: clean
        completion re-admits (after ``breaker_probes`` of them), any
        error / sever / timeout re-opens."""
        name = blk.probe_up
        if name is None:
            return
        blk.probe_up = None
        up = self.upstreams.get(name)
        if up is not None:
            up.breaker.probe_result(ok and blk.errors == 0)

    def _retry_spend(self, blk: _OutBlock, kind: str) -> bool:
        """Take one resend token (a hedge twin or rescue resend).
        Exhaustion degrades to single-send — counted, flight-recorded,
        never amplified into a resend storm."""
        if self._retry_tokens >= 1.0:
            self._retry_tokens -= 1.0
            return True
        self._c.inc("lb_retry_budget_exhausted", job=self.job)
        if self.flight_dir:
            try:
                dump_flight_record(
                    self.flight_dir, "lb-retry-budget",
                    extra={"kind": kind, "n": blk.n,
                           "outstanding_rows": self.outstanding_rows},
                    cooldown_s=30.0)
            except Exception:
                pass
        return False

    def integrity_failure(self, conn: _UpstreamConn, blk: _OutBlock,
                          why: str) -> None:
        """A response that fails the nonce-echo check is connection
        poisoning: never credited, never forwarded.  Abort the
        connection so every in-flight block on it (this one included)
        rescues onto a healthy replica — the client still gets a
        correct payload, the breaker hears an error."""
        self._c.inc("lb_integrity_failures", job=self.job)
        blk.errors += 1
        conn.up.breaker.record_error(why="integrity")
        log.warn("response integrity failure", upstream=conn.up.name,
                 why=why)
        conn._buf.clear()
        conn._fixed = None
        try:
            conn.transport.abort()
        except Exception:
            try:
                conn.transport.close()
            except Exception:
                pass

    def _on_breaker_open(self, name: str, why: str) -> None:
        if not self.flight_dir:
            return
        try:
            dump_flight_record(
                self.flight_dir, "lb-breaker-open",
                extra={"upstream": name, "why": why,
                       "exemplars": list(self.exemplars)[-20:]},
                cooldown_s=30.0)
        except Exception:
            pass

    # -- upstream failure ----------------------------------------------------

    def on_upstream_conn_lost(self, conn: _UpstreamConn) -> None:
        """A replica connection died (kill, crash, close): re-send every
        outstanding block to a surviving replica — the client sees
        latency, never an error."""
        blocks = list(conn.expected)
        conn.expected.clear()
        if blocks and not self._halt.is_set():
            # a sever with work in flight is a breaker error; an idle
            # close (drain, pool recycle) is not
            conn.up.breaker.record_error(why="conn lost")
        for blk in blocks:
            conn.outstanding_rows -= blk.remaining
            self._probe_settle(blk, False)
            if blk.cell.done:
                continue
            if not self._retry_spend(blk, "rescue"):
                # budget exhausted: fail fast (degrade to the single
                # send that just died) rather than join a resend storm
                blk.cell.done = True
                self.outstanding_rows -= blk.n
                self._c.inc("lb_timeouts", blk.n, job=self.job)
                if not blk.conn.closed:
                    blk.conn.complete(blk.slot, RESP_503 * blk.n)
                self._trace_timeout(blk, time.perf_counter(),
                                    conn.up.name)
                continue
            resend_bytes = blk.req_bytes
            if self.trace_enabled:
                # a rescue is always kept (tail sampling's always-keep
                # set): promote the block if it wasn't sampled, mark
                # the severed dispatch, and inject the trace header
                # into the resend so the surviving replica's spans
                # stitch under this admission
                ctx = blk.cell.trace
                if ctx is None:
                    ctx = self._trace_promote(blk, "rescue",
                                              conn.up.name)
                self._trace_rec_end(ctx, blk.trace_rec, "severed")
                resend_bytes = _inject_trace_headers(
                    blk.req_bytes, ctx.tid, ctx.root_sid)
            resend = _OutBlock(blk.conn, blk.slot, blk.n, resend_bytes,
                               blk.cell, kind="rescue",
                               t_admit=blk.t_admit)
            resend.session = blk.session  # affinity re-pins on rescue
            self._dispatch(resend, exclude=conn.up)
        if blocks:
            log.info("upstream connection lost; blocks rescued",
                     upstream=conn.up.name, blocks=len(blocks))
        # keep the pool full while the replica is still advertised
        up = conn.up
        if up.name in self.upstreams and not self._halt.is_set():
            self._apply_target(up.name, up.addr, up.state)

    # -- the sweep (hedge + timeouts + parked + hedge-delay refresh) ---------

    def _schedule_sweep(self) -> None:
        if self._halt.is_set():
            return
        self._sweep_handle = self.door.loop.call_later(
            self.sweep_ms / 1e3, self._sweep)

    def _sweep(self) -> None:
        try:
            now = time.perf_counter()
            # breaker cooldowns: OPEN → HALF_OPEN on the loop thread
            for up in self.upstreams.values():
                up.breaker.tick(now)
            # refresh the p99-derived hedge delay — every ~20th sweep:
            # a full-ring np.quantile per 5 ms sweep would be 200
            # sorts/s on the routing thread, for a threshold that only
            # needs ~100 ms freshness
            self._sweep_n += 1
            if self._lat_n >= 32 and self._sweep_n % 20 == 1:
                window = self._lat_ring[:self._lat_n]
                p99 = float(np.quantile(window, 0.99))
                self.hedge_delay_s = min(
                    max(self.hedge_k * p99, self.hedge_floor_ms / 1e3),
                    self.hedge_cap_ms / 1e3)
                self._hedge_gauge.set(round(self.hedge_delay_s * 1e3, 3),
                                      job=self.job)
                if self.trace_enabled and self.tail_slow_quantile < 1.0:
                    # the tail sampler's p-slowest keep threshold rides
                    # the same windowed quantile refresh
                    self._slow_keep_s = float(np.quantile(
                        window, self.tail_slow_quantile))
            # pool top-up, ~every 0.5 s at the default 5 ms sweep: in
            # KV mode the discovery sweep re-dials, but a STATIC
            # upstream whose initial dial failed (LB started before the
            # replica listened) has no other redial trigger — without
            # this it would be unroutable forever.  last_seen is NOT
            # refreshed here (that would defeat addr_grace_s aging).
            if self._sweep_n % 100 == 1:
                for up in self.upstreams.values():
                    self._fill_pool(up)
            # hedge stragglers
            for up in list(self.upstreams.values()):
                for conn in up.conns:
                    for blk in conn.expected:
                        if now - blk.t_sent <= self.hedge_delay_s:
                            break  # FIFO: the rest are younger
                        if blk.hedged or blk.cell.done:
                            continue
                        target = self._pick(exclude=up)
                        if target is None:
                            break
                        tconn = target.least_loaded_conn()
                        if tconn is None:
                            # no live conn this sweep: leave the block
                            # unmarked so the next sweep retries — a
                            # hedge marked-but-never-sent would wait
                            # out the full request timeout
                            continue
                        if not self._retry_spend(blk, "hedge"):
                            # budget exhausted: this block degrades to
                            # single-send for good — marking it hedged
                            # stops every later sweep re-burning the
                            # exhaustion counter on the same straggler
                            blk.hedged = True
                            continue
                        blk.hedged = True
                        hedge_bytes = blk.req_bytes
                        if self.trace_enabled:
                            # a hedge is always kept: promote if
                            # unsampled, and the RESEND carries the
                            # trace header — the duel's winner records
                            # its door/batch spans under this admission
                            # even though the primary left untraced
                            ctx = blk.cell.trace
                            if ctx is None:
                                ctx = self._trace_promote(
                                    blk, "hedge", up.name)
                            hedge_bytes = _inject_trace_headers(
                                blk.req_bytes, ctx.tid, ctx.root_sid)
                        hedge = _OutBlock(blk.conn, blk.slot, blk.n,
                                          hedge_bytes, blk.cell,
                                          kind="hedge",
                                          t_admit=blk.t_admit)
                        hedge.session = blk.session
                        hedge.hedged = True
                        self._c.inc("lb_hedges_fired", blk.n, job=self.job)
                        target.requests += blk.n
                        if target.breaker.state == BRK_HALF:
                            target.breaker.probe_inflight += 1
                            hedge.probe_up = target.name
                        if hedge.cell.trace is not None:
                            self._trace_dispatch(hedge.cell.trace,
                                                 hedge, target.name)
                        tconn.send_block(hedge)
            # re-dispatch parked blocks / expire them
            parked, self._parked = self._parked, collections.deque()
            for deadline, blk in parked:
                if blk.cell.done:
                    continue
                if now > deadline:
                    blk.cell.done = True
                    self.outstanding_rows -= blk.n
                    self._c.inc("lb_timeouts", blk.n, job=self.job)
                    if not blk.conn.closed:
                        blk.conn.complete(blk.slot, RESP_503 * blk.n)
                    self._trace_timeout(blk, now)
                    continue
                if self._pick() is not None:
                    self._dispatch(blk)
                else:
                    self._parked.append((deadline, blk))
            # expire blocks stuck on a live-but-wedged upstream past the
            # request timeout (hedging should beat this by orders of
            # magnitude; this is the last-resort bound)
            for up in list(self.upstreams.values()):
                for conn in list(up.conns):
                    expired = False
                    while conn.expected and (
                            now - conn.expected[0].t_admit
                            > self.request_timeout_s):
                        blk = conn.expected.popleft()
                        conn.outstanding_rows -= blk.remaining
                        expired = True
                        self._probe_settle(blk, False)
                        up.breaker.record_error(why="timeout")
                        if blk.cell.done:
                            continue
                        blk.cell.done = True
                        self.outstanding_rows -= blk.n
                        self._c.inc("lb_timeouts", blk.n, job=self.job)
                        if not blk.conn.closed:
                            blk.conn.complete(blk.slot, RESP_503 * blk.n)
                        self._trace_timeout(blk, now, up.name)
                    if expired:
                        # the wedged replica may still answer the popped
                        # blocks; on a pipelined FIFO those bytes would
                        # be credited to the NEXT block — kill the
                        # connection so the stream can never desync
                        # (connection_lost rescues the younger blocks
                        # onto a healthy replica and repools)
                        try:
                            conn.transport.abort()
                        except Exception:
                            try:
                                conn.transport.close()
                            except Exception:
                                pass
            self._maybe_resume()
        finally:
            self._schedule_sweep()


class ServingLB:
    """One LB process/listener: a :class:`FrontDoor` over an
    :class:`LBApp` (convenience wrapper for tests and ``lb_main``)."""

    def __init__(self, *, job: str = "job", host: str = "0.0.0.0",
                 port: int = 0, **lb_kwargs) -> None:
        self.app = LBApp(job=job, **lb_kwargs)
        self.door = FrontDoor(self.app, host=host, port=port, job=job)

    def start(self) -> "ServingLB":
        self.door.start()
        return self

    @property
    def port(self) -> int:
        return self.door.port

    def stop(self) -> None:
        self.door.stop()


def lb_main(env=None) -> int:
    """The LB process entrypoint (``python -m edl_tpu_torch.runtime.lb``):
    discovery from EDL_COORD_ENDPOINT, listener on EDL_LB_PORT,
    ``/metrics`` on EDL_LB_METRICS_PORT.

    Observability wiring: ``EDL_LB_TRACE_SAMPLE`` sets the head
    sampling rate (default 0.01 ≈ 1 %; negative disables tracing
    entirely), ``EDL_TRACE_DIR`` dumps the trace ring there every
    second, ``EDL_FLIGHTREC_DIR`` arms flight records on abnormal exit
    / sustained event-loop lag, and ``EDL_LB_LAG_PROBE_MS`` (default
    50, 0 disables) drives the :class:`LoopLagProbe`."""
    import os

    env = os.environ if env is None else env
    try:
        return _lb_main(env)
    except Exception:
        fdir = env.get("EDL_FLIGHTREC_DIR", "")
        if fdir:
            try:
                dump_flight_record(fdir, "lb-abnormal-exit")
            except Exception:
                pass
        raise


def _lb_main(env) -> int:
    import os
    import signal

    job = env.get("EDL_LB_JOB", "default/serving")
    flight_dir = env.get("EDL_FLIGHTREC_DIR", "")
    try:
        # jittered-backoff probe under EDL_COORD_BOOTSTRAP_DEADLINE_S:
        # a down coordinator at pod start fails loudly (exit 3, the
        # supervisor restart marker) instead of hanging past the
        # readiness budget
        kv = bootstrap_kv(env, disabled="discovery disabled")
    except CoordBootstrapError as exc:
        print(f"lb FAILED (coordinator bootstrap: {exc})", flush=True)
        if flight_dir:
            try:
                dump_flight_record(flight_dir, "lb-coord-bootstrap",
                                   extra={"error": str(exc)})
            except Exception:
                pass
        return 3
    static = {}
    for i, addr in enumerate(
            a for a in env.get("EDL_LB_UPSTREAMS", "").split(",") if a):
        static[f"static-{i}"] = addr
    trace_sample = float(env.get("EDL_LB_TRACE_SAMPLE", "0.01"))
    lb = ServingLB(
        job=job, host=env.get("EDL_LB_HOST", "0.0.0.0"),
        port=int(env.get("EDL_LB_PORT", "0")), kv=kv,
        static_upstreams=static,
        pool=int(env.get("EDL_LB_POOL", "2")),
        discovery_s=float(env.get("EDL_LB_DISCOVERY_S", "0.5")),
        hedge_floor_ms=float(env.get("EDL_LB_HEDGE_FLOOR_MS", "10")),
        hedge_cap_ms=float(env.get("EDL_LB_HEDGE_CAP_MS", "1000")),
        hedge_k=float(env.get("EDL_LB_HEDGE_K", "3")),
        hard_cap_rows=int(env.get("EDL_LB_CAP_ROWS", "65536")),
        request_timeout_s=float(env.get("EDL_LB_REQUEST_TIMEOUT_S", "30")),
        sweep_ms=float(env.get("EDL_LB_SWEEP_MS", "5")),
        trace=trace_sample >= 0,
        trace_sample=max(trace_sample, 0.0),
        slo_ms=float(env.get("EDL_LB_SLO_MS", "0")),
        breaker_errors=int(env.get("EDL_LB_BREAKER_ERRORS", "5")),
        breaker_ratio=float(env.get("EDL_LB_BREAKER_RATIO", "0.5")),
        breaker_min=int(env.get("EDL_LB_BREAKER_MIN", "20")),
        breaker_window_s=float(env.get("EDL_LB_BREAKER_WINDOW_S", "1")),
        breaker_cooldown_s=float(
            env.get("EDL_LB_BREAKER_COOLDOWN_S", "1")),
        breaker_probes=int(env.get("EDL_LB_BREAKER_PROBES", "2")),
        retry_budget_cap=float(env.get("EDL_LB_RETRY_BUDGET", "256")),
        retry_ratio=float(env.get("EDL_LB_RETRY_RATIO", "0.2")),
        integrity=env.get("EDL_LB_INTEGRITY", "1") != "0",
        flight_dir=flight_dir)
    lb.start()
    trace_dir = env.get("EDL_TRACE_DIR", "")
    sink = probe = None
    if trace_dir:
        from edl_tpu_torch.observability.tracing import TraceFileSink

        sink = TraceFileSink(trace_dir, f"lb-{os.getpid()}")
        sink.start()
    probe_ms = float(env.get("EDL_LB_LAG_PROBE_MS", "50"))
    if probe_ms > 0:
        probe = LoopLagProbe(
            lb.door, "lb", interval_s=probe_ms / 1e3,
            breach_s=float(env.get("EDL_LB_LAG_BREACH_MS", "250")) / 1e3,
            flight_dir=flight_dir,
            exemplars_fn=lambda: list(lb.app.exemplars)).start()
    metrics_srv = None
    if int(env.get("EDL_LB_METRICS_PORT", "0")) >= 0:
        from edl_tpu_torch.observability.health import serve_health

        metrics_srv = serve_health(
            int(env.get("EDL_LB_METRICS_PORT", "0")),
            {"upstreams": lambda: any(
                u.routable() for u in lb.app.upstreams.values())})
    print(f"lb ready port={lb.port} metrics_port="
          f"{metrics_srv.server_address[1] if metrics_srv else -1}",
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass
    try:
        while not stop.wait(0.5):
            pass
    finally:
        if probe is not None:
            probe.stop()
        lb.stop()
        if sink is not None:
            sink.stop()  # final dump: the ring as of shutdown
        if metrics_srv is not None:
            metrics_srv.shutdown()
        if kv is not None:
            try:
                kv.close()
            except Exception:
                pass
    return 0


if __name__ == "__main__":  # pragma: no cover - process entrypoint
    import sys

    sys.exit(lb_main())
