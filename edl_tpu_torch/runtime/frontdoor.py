"""The serving data plane's front door — the port of
edl_tpu.runtime.frontdoor: an async event-loop HTTP/1.1 server.

A thread-per-connection server pays a TCP handshake and a thread wakeup
per request, which caps out orders of magnitude below the
continuous-batching replicas behind it.  This module is the architecture
high-QPS serving systems converge on:

* **one event loop, persistent connections** — HTTP/1.1 keep-alive with
  pipelining; a connection serves its whole lifetime of requests with
  zero per-request threads and zero handshakes;
* **block parsing** — pipelined requests arrive many to a TCP segment;
  identical request *shapes* (same head bytes, same body length — the
  steady state of any RPC client) are recognized as a fixed-stride
  block and parsed with ONE numpy head-verify + ONE body-slice reshape
  for the whole segment, so per-request Python cost amortizes to ~0;
* **zero-re-encode bodies** — ``Content-Type: application/x-edl-f32``
  bodies are raw little-endian float32 rows handed to the batcher as a
  numpy view of the receive buffer; the JSON ``/predict`` contract still
  works as the compatibility slow path;
* **bounded admission** — the batcher queue has a hard row cap; past it
  requests get an immediate ``429`` (and the transport is paused — TCP
  backpressure), so overload degrades to fast rejections instead of
  queueing to death;
* **priority classes** — ``X-EDL-Priority: high|normal|low`` (or a
  ``?pri=`` query suffix); under overload low sheds at the soft
  watermark, normal at the hard cap, high rides a reserved headroom
  band — load degrades in priority order, never arbitrarily;
* **responses stay ordered** — HTTP/1.1 pipelining requires in-order
  responses per connection; every admitted or shed request takes a slot
  in the connection's pending ring and the flush walks completed slots
  from the head, so a shed can never overtake an earlier in-flight
  request.

Two apps run behind the same door:

* :class:`BatchApp` — one replica process: rows go straight into a
  continuous-batching loop over an :class:`ElasticServer` (the same
  machinery as :class:`~edl_tpu_torch.runtime.serving.ServingReplica`,
  block-oriented).  Its batcher thread is the only thread that touches
  the device: it runs the forward under ``torch.inference_mode`` (which
  is thread-local) and copies the answers to host numpy there, so the
  event-loop thread only ever moves bytes.  This is what
  :func:`replica_main` (``python -m edl_tpu_torch.runtime.frontdoor``)
  serves, and what the load-balancer tier (:mod:`edl_tpu_torch.runtime.
  lb`) routes to.
* :class:`FleetApp` — ``serve_main``'s in-process
  :class:`~edl_tpu_torch.runtime.serving.ServingFleet` behind the async
  door (``serve_main``'s default front door; the thread-per-connection
  server remains as ``EDL_SERVING_FRONTDOOR=legacy``), and a
  :class:`~edl_tpu_torch.runtime.serving.DecodeFleet` behind ``POST
  /generate``.

Replica discovery for the LB tier rides coordinator KV exactly like the
scrape plane's address keys: each replica publishes a TTL'd
``serving-addr/<job>/<replica>`` key whose value is
``host:port <expiry> <state>`` — the *state* field is the ready gate
(``ready``/``building``/``reloading``/``draining``), republished
immediately on every transition so the LB stops routing to a reloading
replica within one discovery sweep.

Scrape names: ``edl_frontdoor_requests_served_total`` /
``edl_frontdoor_connections_total`` /
``edl_frontdoor_overload_sheds_total{priority=}`` /
``edl_frontdoor_request_errors_total`` (counters),
``edl_frontdoor_request_seconds`` (histogram, trace-id exemplars on
its buckets for sampled requests) / ``edl_frontdoor_batch_rows``
(histograms), ``edl_frontdoor_queue_rows`` / ``edl_frontdoor_state``
(gauges) — all labeled ``job=`` — plus
``edl_loop_lag_seconds{loop=frontdoor}`` /
``edl_loop_lag_breaches_total`` from the :class:`LoopLagProbe`.

Request tracing: a sampled block —
one carrying ``X-EDL-Trace-Id``, injected by the LB origin or sent by
the client — gets a ``frontdoor_request`` span tree with the phase
cuts parse → admit → queue → batch → forward → respond, parented to
the LB's admission span via ``X-EDL-Parent-Span``, the id echoed on
the response (f32 and JSON alike), and a record in the bounded
exemplar ring flight records embed.
"""

from __future__ import annotations

import asyncio
import collections
import os
import random
import socket
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (
    SERVING_LATENCY_BUCKETS, dump_flight_record, get_registry,
)
from edl_tpu_torch.observability.scrape import AddrPublisher
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("runtime.frontdoor")

#: event-loop lag histogram boundaries (seconds): sub-ms scheduling
#: noise up to multi-second wedges — the range a "GC pause / blocking
#: call on the loop thread" failure lives in
LOOP_LAG_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

#: coordinator-KV prefix for the serving DATA-plane address + ready gate
#: (``serving-addr/<job>/<replica>`` → ``host:port <expiry> <state>``);
#: TTL'd like serving-metrics-addr/, swept by coord/gc.py on job delete
SERVING_ADDR_PREFIX = "serving-addr/"

#: request priority classes (smaller = more important); the shed order
#: under overload is low → normal → high
PRI_HIGH, PRI_NORMAL, PRI_LOW = 0, 1, 2
PRIORITY_NAMES = {PRI_HIGH: "high", PRI_NORMAL: "normal", PRI_LOW: "low"}
_PRI_BY_NAME = {b"high": PRI_HIGH, b"normal": PRI_NORMAL, b"low": PRI_LOW}

#: replica lifecycle states as published through the ready-gate KV key
FD_BUILDING = "building"
FD_READY = "ready"
FD_RELOADING = "reloading"
FD_DRAINING = "draining"
#: built + warm but deliberately not routable: the serving twin of the
#: trainer's hint→prewarm standby — a scale-up ACTIVATES it (its compile
#: already happened off the traffic path) instead of building inline
FD_STANDBY = "standby"

F32_CONTENT_TYPE = "application/x-edl-f32"

RESP_429 = (b"HTTP/1.1 429 Too Many Requests\r\n"
            b"Content-Length: 0\r\nX-EDL-Shed: 1\r\n\r\n")
RESP_503 = (b"HTTP/1.1 503 Service Unavailable\r\n"
            b"Content-Length: 0\r\n\r\n")
RESP_404 = b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n"
RESP_400 = b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n"
RESP_411 = (b"HTTP/1.1 411 Length Required\r\n"
            b"Content-Length: 0\r\n\r\n")
RESP_413 = (b"HTTP/1.1 413 Payload Too Large\r\n"
            b"Content-Length: 0\r\n\r\n")
RESP_409 = b"HTTP/1.1 409 Conflict\r\nContent-Length: 0\r\n\r\n"
RESP_500 = (b"HTTP/1.1 500 Internal Server Error\r\n"
            b"Content-Length: 0\r\n\r\n")
RESP_200_EMPTY = b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n"


def format_serving_addr(addr: str, ttl_s: Optional[float],
                        state: str = FD_READY) -> bytes:
    """KV value for the data-plane address key: ``host:port`` + the
    expiry stamp the scrape plane's TTL convention uses + the replica's
    ready-gate state."""
    if ttl_s is None:
        return f"{addr} - {state}".encode()
    return f"{addr} {time.time() + ttl_s:.3f} {state}".encode()


def parse_serving_addr(value: bytes) -> tuple[Optional[str], str, bool]:
    """``(addr, state, expired)``; addr None when unparseable."""
    try:
        parts = value.decode().split()
    except UnicodeDecodeError:
        return None, "", True
    if not parts or ":" not in parts[0]:
        return None, "", True
    expired = False
    if len(parts) > 1 and parts[1] != "-":
        try:
            expired = time.time() > float(parts[1])
        except ValueError:
            pass
    state = parts[2] if len(parts) > 2 else FD_READY
    return parts[0], state, expired


def build_predict_request(row: np.ndarray, priority: Optional[str] = None,
                          host: str = "fd",
                          trace_id: Optional[str] = None) -> bytes:
    """One raw-f32 ``/predict`` request (clients, load generators, tests).
    Constant head bytes for a constant row width — which is exactly what
    arms the server's fixed-stride block parser.  ``trace_id`` adds the
    ``X-EDL-Trace-Id`` header (the request is then traced end-to-end and
    the id echoed on the reply — doc/serving.md §request tracing)."""
    body = np.ascontiguousarray(row, dtype="<f4").tobytes()
    pri = f"X-EDL-Priority: {priority}\r\n" if priority else ""
    tid = f"X-EDL-Trace-Id: {trace_id}\r\n" if trace_id else ""
    head = (f"POST /predict HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: {F32_CONTENT_TYPE}\r\n{pri}{tid}"
            f"Content-Length: {len(body)}\r\n\r\n")
    return head.encode() + body


class HeadMeta:
    """Parsed request head, cached by exact head bytes (RPC clients
    resend byte-identical heads; the cache turns per-request header
    parsing into one dict hit)."""

    __slots__ = ("method", "path", "body_len", "f32", "priority",
                 "trace_id", "parent_span", "nonce", "keep_alive",
                 "head_len", "total_len", "bad", "chunked", "session")

    def __init__(self, head: bytes) -> None:
        self.bad = False
        self.chunked = False
        self.body_len = 0
        self.f32 = False
        self.priority = PRI_NORMAL
        self.trace_id: Optional[str] = None
        self.parent_span: Optional[str] = None
        self.nonce: Optional[str] = None
        self.session: Optional[str] = None
        self.keep_alive = True
        self.head_len = len(head)
        try:
            line_end = head.index(b"\r\n")
            parts = head[:line_end].split()
            self.method = parts[0].decode("latin1")
            path = parts[1]
            q = path.find(b"?")
            if q >= 0:
                if b"pri=" in path[q:]:
                    for tok in path[q + 1:].split(b"&"):
                        if tok.startswith(b"pri="):
                            self.priority = _PRI_BY_NAME.get(
                                tok[4:], PRI_NORMAL)
                path = path[:q]
            self.path = path.decode("latin1")
        except (ValueError, IndexError, UnicodeDecodeError):
            self.bad = True
            self.method, self.path = "", ""
            self.total_len = len(head)
            return
        # header lookups are \r\n-ANCHORED: an unanchored substring
        # match would hit inside e.g. an X-Content-Length header and
        # desync the request framing
        lower = head.lower()
        idx = lower.find(b"\r\ncontent-length:")
        if idx >= 0:
            end = lower.index(b"\r\n", idx + 2)
            try:
                self.body_len = int(lower[idx + 17:end].strip())
            except ValueError:
                self.bad = True
            if self.body_len < 0:  # would desync the consume offsets
                self.body_len = 0
                self.bad = True
        # Transfer-Encoding bodies (chunked) have no Content-Length to
        # frame by: parsing on would treat the chunk stream as the next
        # request head and desync the connection — refuse instead
        if b"\r\ntransfer-encoding:" in lower:
            self.chunked = True
        self.f32 = (b"\r\ncontent-type: " + F32_CONTENT_TYPE.encode()
                    in lower)
        idx = lower.find(b"\r\nx-edl-priority:")
        if idx >= 0:
            end = lower.index(b"\r\n", idx + 2)
            self.priority = _PRI_BY_NAME.get(
                lower[idx + 17:end].strip(), PRI_NORMAL)
        idx = lower.find(b"\r\nx-edl-trace-id:")
        if idx >= 0:
            end = lower.index(b"\r\n", idx + 2)
            self.trace_id = head[idx + 17:end].strip().decode("latin1")
        # the LB (trace origin) injects this so downstream span roots
        # nest under its admission span in the stitched tree
        idx = lower.find(b"\r\nx-edl-parent-span:")
        if idx >= 0:
            end = lower.index(b"\r\n", idx + 2)
            self.parent_span = head[idx + 20:end].strip().decode("latin1")
        # end-to-end integrity nonce (doc/serving.md §response
        # integrity): the LB stamps it on a block's first request and
        # requires the echo on that block's first response — a
        # misrouted/desynced/corrupted answer cannot echo it
        idx = lower.find(b"\r\nx-edl-block-nonce:")
        if idx >= 0:
            end = lower.index(b"\r\n", idx + 2)
            self.nonce = head[idx + 20:end].strip().decode("latin1")
        # decode-session affinity (doc/serving.md §autoregressive
        # serving): the LB pins every request carrying this id to the
        # replica holding the session's KV cache
        idx = lower.find(b"\r\nx-edl-session:")
        if idx >= 0:
            end = lower.index(b"\r\n", idx + 2)
            self.session = head[idx + 16:end].strip().decode("latin1")
        if b"\r\nconnection: close" in lower:
            self.keep_alive = False
        self.total_len = self.head_len + self.body_len


class RespSlot:
    """One in-order response obligation on a connection: ``data`` is
    filled exactly once (bytes covering the slot's ``n`` pipelined
    requests) and flushed when every earlier slot has flushed."""

    __slots__ = ("n", "data")

    def __init__(self, n: int) -> None:
        self.n = n
        self.data: Optional[bytes] = None


class HttpConn(asyncio.Protocol):
    """One keep-alive client connection: incremental HTTP/1.1 parser
    with a fixed-stride fast path, plus the in-order pending ring."""

    def __init__(self, door: "FrontDoor") -> None:
        self.door = door
        self.app = door.app
        self.transport = None
        self._buf = bytearray()
        #: (head bytes incl. CRLFCRLF, HeadMeta) — armed after the first
        #: f32 /predict parses on the slow path; identical repeats then
        #: take the block fast path
        self._fixed: Optional[tuple[bytes, HeadMeta]] = None
        self.pending: "collections.deque[RespSlot]" = collections.deque()
        self.closed = False
        self._close_after_flush = False
        self._poisoned = False
        self._paused = False

    # -- lifecycle -----------------------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        try:
            import socket

            transport.get_extra_info("socket").setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except Exception:
            pass
        self.door.connections += 1
        self.door.conns.add(self)

    def connection_lost(self, exc) -> None:
        self.closed = True
        self.door.conns.discard(self)
        self.app.on_conn_lost(self)

    # -- the pending ring ----------------------------------------------------

    def push_slot(self, n: int) -> RespSlot:
        slot = RespSlot(n)
        self.pending.append(slot)
        return slot

    def complete(self, slot: RespSlot, data: bytes) -> None:
        """Fill a slot (loop thread only) and flush the ready head run."""
        slot.data = data
        self.flush()

    def flush(self) -> None:
        if self.closed:
            self.pending.clear()
            return
        out = []
        pending = self.pending
        while pending and pending[0].data is not None:
            out.append(pending.popleft().data)
        if out:
            self.transport.write(out[0] if len(out) == 1 else b"".join(out))
        if self._close_after_flush and not pending:
            self.transport.close()

    # -- parsing -------------------------------------------------------------

    def _poison(self, resp: bytes) -> None:
        """Terminal protocol error: answer IN PIPELINE ORDER (through
        the slot ring — an error must never overtake an earlier
        in-flight response), close once everything pending has flushed,
        and discard the rest of the wire (no parseable boundary)."""
        self._poisoned = True
        self._buf.clear()
        self._close_after_flush = True
        self.complete(self.push_slot(1), resp)

    def data_received(self, data: bytes) -> None:
        if self._poisoned:
            return
        buf = self._buf
        buf += data
        while buf:
            if self._fixed is not None and self._fast_block():
                continue
            if not self._slow_one():
                break

    def _fast_block(self) -> bool:
        """Consume a run of byte-identical-head requests in one pass.
        Returns True when it consumed anything.  Head verification uses
        offset ``startswith`` (no buffer exports — a live numpy view of
        the bytearray would make the consume-resize raise BufferError);
        the row extraction is one reshape+slice over an immutable copy
        of the consumed run."""
        head, meta = self._fixed
        buf = self._buf
        stride = meta.total_len
        n = len(buf) // stride
        if n == 0 or not buf.startswith(head):
            return False
        hl = meta.head_len
        # longest run of identical heads at exact stride offsets
        run = 1
        while run < n and buf.startswith(head, run * stride):
            run += 1
        n = run
        chunk = bytes(memoryview(buf)[:n * stride])
        del buf[:n * stride]
        if self.app.wants_raw:
            self.app.handle_raw_block(self, chunk, n, meta)
        else:
            mat = np.frombuffer(chunk, np.uint8).reshape(n, stride)
            rows = np.ascontiguousarray(
                mat[:, hl:hl + meta.body_len]).view("<f4")
            self.app.handle_rows(self, rows, meta)
        return True

    def _slow_one(self) -> bool:
        """Parse one request incrementally; returns False when the
        buffer holds no complete request yet."""
        buf = self._buf
        idx = buf.find(b"\r\n\r\n")
        if idx < 0:
            if len(buf) > self.door.max_head_bytes:
                self.transport.close()
            return False
        head = bytes(memoryview(buf)[:idx + 4])
        meta = self.door.head_cache.get(head)
        if meta is None:
            meta = HeadMeta(head)
            # traced/nonce'd heads are unique per request (they embed
            # the trace id / block nonce): caching them would churn the
            # bounded cache (each clear() dumps genuinely hot heads)
            # for entries that can never hit again
            if meta.trace_id is None and meta.nonce is None:
                if len(self.door.head_cache) > 512:
                    self.door.head_cache.clear()
                self.door.head_cache[head] = meta
        if meta.bad:
            self._poison(RESP_400)
            return False
        if meta.chunked:
            # no Content-Length boundary to resync on: 411 + close
            self._poison(RESP_411)
            return False
        if meta.body_len > self.door.max_body_bytes:
            # refuse BEFORE buffering: "bounded admission" must bound
            # the transport too, or one huge Content-Length OOMs the
            # process regardless of the row caps
            self._poison(RESP_413)
            return False
        if len(buf) < meta.total_len:
            return False
        body = bytes(memoryview(buf)[meta.head_len:meta.total_len])
        raw = (bytes(memoryview(buf)[:meta.total_len])
               if self.app.wants_raw else b"")
        del buf[:meta.total_len]
        if not meta.keep_alive:
            self._close_after_flush = True
        if (meta.method == "POST" and meta.path == "/predict" and meta.f32
                and meta.body_len >= 4 and meta.body_len % 4 == 0):
            # arm the fixed-stride block parser for the repeats — but
            # never on a traced or nonce'd head: it is unique to its
            # request, so arming would just push the NEXT (plain)
            # request onto the slow path (the LB's response parser has
            # the same guard)
            if meta.trace_id is None and meta.nonce is None:
                self._fixed = (head, meta)
            if self.app.wants_raw:
                self.app.handle_raw_block(self, raw, 1, meta)
            else:
                self.app.handle_rows(
                    self, np.frombuffer(body, "<f4").reshape(1, -1), meta)
        else:
            self.app.handle_request(self, meta, body, raw)
        return True

    # -- backpressure --------------------------------------------------------

    def pause(self) -> None:
        if not self._paused and not self.closed:
            self._paused = True
            try:
                self.transport.pause_reading()
            except Exception:
                pass

    def resume(self) -> None:
        if self._paused and not self.closed:
            self._paused = False
            try:
                self.transport.resume_reading()
            except Exception:
                pass


class FrontDoor:
    """The async server: owns the event loop (on a dedicated thread when
    started via :meth:`start`), the listener, and the per-door counters.

    ``app`` implements the dispatch surface::

        wants_raw: bool     # raw bytes blocks (LB) vs f32 rows (replica)
        handle_rows(conn, rows, meta)            # wants_raw=False
        handle_raw_block(conn, raw, n, meta)     # wants_raw=True
        handle_request(conn, meta, body, raw)    # GET/JSON/admin
        on_conn_lost(conn)
    """

    def __init__(self, app, host: str = "0.0.0.0", port: int = 0,
                 job: str = "job") -> None:
        self.app = app
        self.host = host
        self.port = port
        self.job = job
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.server = None
        self.conns: set[HttpConn] = set()
        self.connections = 0
        self.head_cache: dict[bytes, HeadMeta] = {}
        self.max_head_bytes = 16384
        #: largest accepted request body; a bigger Content-Length gets
        #: an immediate 413 + close instead of being buffered
        self.max_body_bytes = 8 << 20
        self._thread: Optional[threading.Thread] = None
        self._halt: Optional[asyncio.Event] = None
        self._ready = threading.Event()
        self._stopped = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._conn_counter = get_registry().counter(
            "frontdoor_connections",
            help="client connections accepted by the async front door")
        get_registry().gauge_fn(
            "frontdoor_open_connections", lambda: len(self.conns),
            help="currently open front-door connections", job=job)
        self._c = get_counters()

    # -- loop management -----------------------------------------------------

    async def _serve(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.server = await self.loop.create_server(
            lambda: self._make_conn(), self.host, self.port, backlog=512)
        self.port = self.server.sockets[0].getsockname()[1]
        attach = getattr(self.app, "attach", None)
        if attach is not None:
            attach(self)
        self._ready.set()
        try:
            await self.server.serve_forever()
        except asyncio.CancelledError:
            pass

    def _make_conn(self) -> HttpConn:
        self._conn_counter.inc(job=self.job)
        return HttpConn(self)

    def start(self) -> "FrontDoor":
        def run() -> None:
            asyncio.run(self._main())
            self._stopped.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"frontdoor-{self.job}")
        self._thread.start()
        if not self._ready.wait(30):
            raise RuntimeError("front door failed to start")
        if self._start_error is not None:
            raise RuntimeError(
                f"front door failed to start: {self._start_error}"
            ) from self._start_error
        return self

    async def _main(self) -> None:
        self._halt = asyncio.Event()
        serve = asyncio.ensure_future(self._serve())
        halt = asyncio.ensure_future(self._halt.wait())
        await asyncio.wait({serve, halt},
                           return_when=asyncio.FIRST_COMPLETED)
        if serve.done() and serve.exception() is not None:
            # bind/listen failure: surface it to start() instead of
            # parking forever behind a halt that will never be set
            self._start_error = serve.exception()
            halt.cancel()
            self._ready.set()
            return
        if self.server is not None:
            self.server.close()
        for conn in list(self.conns):
            try:
                conn.transport.close()
            except Exception:
                pass
        serve.cancel()
        halt.cancel()
        try:
            await serve
        except asyncio.CancelledError:
            pass

    def stop(self) -> None:
        detach = getattr(self.app, "detach", None)
        if detach is not None:
            detach()
        if self.loop is not None and self._halt is not None:
            try:
                self.loop.call_soon_threadsafe(self._halt.set)
            except RuntimeError:
                pass
        self._stopped.wait(10)
        if self._thread is not None:
            self._thread.join(timeout=10)

    def call_soon(self, fn, *args) -> None:
        """Schedule ``fn`` on the loop thread from any thread."""
        self.loop.call_soon_threadsafe(fn, *args)


# -- the replica app ---------------------------------------------------------


def _to_host(out) -> np.ndarray:
    """One device→host copy of a forward's answers as numpy (bf16 widened
    to fp32): the batcher thread's, never the event loop's."""
    from edl_tpu_torch.runtime.serving import _host

    return out if isinstance(out, np.ndarray) else _host(out)


class _Block:
    """One admitted run of requests from one connection (the batcher's
    unit of work): rows, the response slot, and the admission stamp.
    ``t_recv``/``parent`` are set only for traced blocks (the sampled
    minority) — the span-phase cuts and the cross-tier stitch point."""

    __slots__ = ("conn", "slot", "rows", "t", "json", "trace_id",
                 "t_recv", "parent", "nonce")

    def __init__(self, conn, slot, rows, t, json_resp=False,
                 trace_id=None, t_recv=0.0, parent=None,
                 nonce=None) -> None:
        self.conn = conn
        self.slot = slot
        self.rows = rows
        self.t = t
        self.json = json_resp
        self.trace_id = trace_id
        self.t_recv = t_recv
        self.parent = parent
        self.nonce = nonce


class _StatePublisher(AddrPublisher):
    """The scrape plane's TTL'd :class:`AddrPublisher`, publishing the
    ``serving-addr/<job>/<replica>`` ready-gate value (addr + expiry +
    state) instead of a bare address — ``publish_now()`` on every state
    transition so the LB's next discovery sweep sees the gate."""

    def __init__(self, kv, key: str, addr: str, state_fn: Callable[[], str],
                 ttl_s: float = 15.0) -> None:
        super().__init__(
            kv, key, addr, ttl_s=ttl_s,
            value_fn=lambda: format_serving_addr(
                addr, self.ttl_s, state_fn()))


class BatchApp:
    """One replica process's app: a continuous-batching loop over an
    :class:`~edl_tpu_torch.runtime.serving.ElasticServer`, fed blocks of rows
    straight off the wire.

    Admission policy (rows, against the live queue depth):

    * ``queued + k > hard_cap`` → shed the overflow (``high`` priority
      rides a 25 % reserve band above the cap before it sheds too);
    * ``queued + k > soft_cap`` → shed ``low``-priority blocks entirely;
    * a connection that hits the hard cap is also paused (TCP
      backpressure) until the queue drains under the low watermark.
    """

    wants_raw = False

    def __init__(self, build_server: Callable[[], Any], row_dim: int,
                 *, job: str = "job", replica: str = "r0",
                 max_batch: int = 256, max_queue_ms: float = 2.0,
                 hard_cap_rows: int = 65536, soft_cap_rows: int = 0,
                 slo_p99_ms: float = 0.0, kv=None,
                 advertise_host: str = "127.0.0.1",
                 advertise_port: Optional[int] = None,
                 addr_ttl_s: float = 15.0, standby: bool = False,
                 brownout_enter_ms: float = 0.0,
                 brownout_sustain: int = 3,
                 brownout_min_s: float = 0.5) -> None:
        self.build_server = build_server
        self.row_dim = int(row_dim)
        self.job = job
        self.replica = replica
        self.max_batch = max(int(max_batch), 1)
        self.max_queue_ms = max(float(max_queue_ms), 0.0)
        self.hard_cap = max(int(hard_cap_rows), self.max_batch)
        self.soft_cap = (int(soft_cap_rows) if soft_cap_rows
                         else self.hard_cap // 2)
        self.high_cap = self.hard_cap + self.hard_cap // 4
        self.slo_p99_ms = float(slo_p99_ms)
        self.kv = kv
        self.advertise_host = advertise_host
        #: the port published in the gate key when a middlebox (a chaos
        #: proxy) fronts the door; None publishes the door's own
        self.advertise_port = advertise_port
        self.addr_ttl_s = addr_ttl_s
        self.standby = bool(standby)
        self.server = None
        self.state = FD_BUILDING
        self.failed = False
        self.generation = 0
        self.door: Optional[FrontDoor] = None
        self._publisher: Optional[_StatePublisher] = None
        self._ready_evt = threading.Event()
        self._lock = threading.Lock()
        self._queue: "collections.deque[_Block]" = collections.deque()
        self._queued_rows = 0
        self._cond = threading.Condition(self._lock)
        self._halt = False
        self._stall_once_ms = 0.0
        self._pending_weights: Optional[tuple[Any, int]] = None
        self._swap_applied = threading.Event()
        self._swap_ok = False
        self._batcher: Optional[threading.Thread] = None
        self._paused_conns: set = set()
        self._out_head: Optional[bytes] = None
        self._out_head_arr = None
        self.iterations = 0
        self.requests_served = 0
        #: completed trace records (the sampled minority): what flight
        #: records embed beside the trace dumps — bounded so a
        #: week of serving cannot grow it
        self.exemplars: "collections.deque[dict]" = collections.deque(
            maxlen=256)
        # -- brownout: the degraded mode between healthy and 429-
        # everything (doc/serving.md §brownout).  Entered after
        # ``brownout_sustain`` consecutive batcher iterations whose
        # oldest queued block aged past ``brownout_enter_ms`` (0
        # disables the queue-age trigger), or immediately on a
        # sustained loop-lag escalation relayed via note_lag_breach().
        # While active: admission caps halve, the co-batching admission
        # window collapses to 0 (serve NOW, don't wait for batchmates)
        # and span/exemplar work is shed first — response correctness
        # (bodies, echo headers) is never degraded.  Exit needs
        # ``brownout_min_s`` elapsed AND ``brownout_sustain`` clean
        # iterations (hysteresis: no flapping at the threshold).
        self.brownout_enter_ms = float(brownout_enter_ms)
        self.brownout_sustain = max(int(brownout_sustain), 1)
        self.brownout_min_s = float(brownout_min_s)
        self.brownouts = 0
        self._brownout = False
        self._brn_streak = 0
        self._brn_clear = 0
        self._brn_since = 0.0
        self._brn_last = 0.0
        self._lag_breach = False
        # -- gray-failure seam (GrayReplica drills): for a window, a
        # fraction of blocks get gray answers — 500s ("error") or a
        # wrong-nonce echo + garbage body ("corrupt")
        self._gray_rate = 0.0
        self._gray_mode = "error"
        self._gray_until = 0.0
        self._gray_rng = random.Random(0xED1)
        reg = get_registry()
        self._brn_seconds = reg.counter(
            "frontdoor_brownout_seconds",
            help="seconds spent in brownout (degraded admission)")
        self._brn_seconds.inc(0, job=job, replica=replica)
        reg.gauge_fn("frontdoor_brownout",
                     lambda: 1 if self._brownout else 0,
                     help="1 while the replica serves in brownout",
                     job=job, replica=replica)
        self._hist = reg.histogram(
            "frontdoor_request_seconds",
            help="front-door latency, admission to response write",
            buckets=SERVING_LATENCY_BUCKETS)
        self._bhist = reg.histogram(
            "frontdoor_batch_rows",
            help="rows packed per serve iteration",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._c = get_counters()
        reg.gauge_fn("frontdoor_queue_rows",
                     lambda: self._queued_rows,
                     help="rows queued for the batcher", job=job,
                     replica=replica)
        reg.gauge_fn(
            "frontdoor_state",
            lambda: {FD_BUILDING: 0, FD_READY: 1, FD_RELOADING: 2,
                     FD_DRAINING: 3, FD_STANDBY: 4}.get(self.state, -1),
            help="replica state (0 building/1 ready/2 reloading/"
                 "3 draining/4 standby)", job=job, replica=replica)

    # -- lifecycle -----------------------------------------------------------

    def attach(self, door: FrontDoor) -> None:
        """Called by the door once the listener is bound (loop thread):
        kick off the build + batcher and publish the gate key."""
        self.door = door
        if self.kv is not None:
            self._publisher = _StatePublisher(
                self.kv,
                f"{SERVING_ADDR_PREFIX}{self.job}/{self.replica}",
                f"{self.advertise_host}:{self.advertise_port or door.port}",
                lambda: self.state, ttl_s=self.addr_ttl_s)
            self._publisher.start()
        self._batcher = threading.Thread(
            target=self._run, name=f"fd-batcher-{self.replica}",
            daemon=True)
        self._batcher.start()

    def detach(self) -> None:
        with self._cond:
            self._halt = True
            self._cond.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout=30)
        if self._publisher is not None:
            self._publisher.stop()
            self._publisher = None

    def _set_state(self, state: str) -> None:
        with self._lock:
            self.state = state
        if self._publisher is not None:
            self._publisher.publish_now()

    def _set_state_if(self, expect: str, state: str) -> bool:
        """CAS regate: only transition from ``expect`` — a concurrent
        drain (or activate) that moved the gate first keeps it (the
        gate race ServingReplica closes, same rule here)."""
        with self._lock:
            if self.state != expect:
                return False
            self.state = state
        if self._publisher is not None:
            self._publisher.publish_now()
        return True

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        return self._ready_evt.wait(timeout_s) and not self.failed

    # -- admission (loop thread) ---------------------------------------------

    def _admission(self, k: int, pri: int) -> tuple[int, bool]:
        """The ONE admission policy (f32 and JSON paths both route
        here): ``(rows to admit of k, pause the connection?)`` against
        the live queue depth."""
        qd = self._queued_rows
        soft, hard, high = self.soft_cap, self.hard_cap, self.high_cap
        if self._brownout:
            # degraded admission: half the window at every tier — the
            # queue must SHRINK while browned out, or the lag/age
            # breach that triggered it can never clear
            soft, hard, high = soft // 2, hard // 2, high // 2
        if pri == PRI_LOW and qd + k > soft:
            return 0, False
        cap = high if pri == PRI_HIGH else hard
        if qd + k > cap:
            return max(cap - qd, 0), True
        return k, False

    def handle_rows(self, conn: HttpConn, rows: np.ndarray,
                    meta: HeadMeta) -> None:
        k = len(rows)
        # traced requests (the sampled minority) stamp arrival so the
        # parse→admit phase cut is real; the untraced steady state pays
        # nothing here
        t_recv = time.perf_counter() if meta.trace_id else 0.0
        if self.failed:
            # the build died: nothing will ever drain the queue — fast
            # 503s, not a hang until client timeout
            conn.complete(conn.push_slot(k), RESP_503 * k)
            return
        if rows.shape[1] != self.row_dim:
            conn.complete(conn.push_slot(k), RESP_400 * k)
            self._c.inc("frontdoor_request_errors", k, job=self.job)
            return
        admit, pause = self._admission(k, meta.priority)
        if admit < k:
            if admit:
                self._admit(conn, rows[:admit], meta, t_recv=t_recv)
            self._shed(conn, k - admit, meta.priority)
            if pause:
                conn.pause()
                self._paused_conns.add(conn)
            return
        self._admit(conn, rows, meta, t_recv=t_recv)

    def _shed(self, conn: HttpConn, k: int, pri: int) -> None:
        if k <= 0:
            return
        conn.complete(conn.push_slot(k), RESP_429 * k)
        self._c.inc("frontdoor_overload_sheds", k, job=self.job,
                    priority=PRIORITY_NAMES[pri])

    def _admit(self, conn: HttpConn, rows: np.ndarray,
               meta: HeadMeta, json_resp: bool = False,
               t_recv: float = 0.0) -> None:
        slot = conn.push_slot(len(rows))
        now = time.perf_counter()
        blk = _Block(conn, slot, rows, now,
                     json_resp=json_resp, trace_id=meta.trace_id,
                     t_recv=t_recv or now, parent=meta.parent_span,
                     nonce=meta.nonce)
        with self._cond:
            self._queue.append(blk)
            self._queued_rows += len(rows)
            self._cond.notify()

    # -- slow-path requests (loop thread) ------------------------------------

    def handle_request(self, conn: HttpConn, meta: HeadMeta, body: bytes,
                       raw: bytes) -> None:
        path = meta.path
        if meta.method == "GET":
            if path == "/healthz":
                ok = self.state in (FD_READY, FD_RELOADING, FD_STANDBY)
                conn.complete(conn.push_slot(1),
                              RESP_200_EMPTY if ok else RESP_503)
            else:
                conn.complete(conn.push_slot(1), RESP_404)
            return
        if meta.method == "POST" and path == "/predict":
            t_recv = time.perf_counter() if meta.trace_id else 0.0
            if self.failed:
                conn.complete(conn.push_slot(1), RESP_503)
                return
            # JSON compatibility path (the legacy server's contract)
            try:
                import json

                row = np.asarray(json.loads(body.decode())["inputs"],
                                 np.float32).reshape(1, -1)
                if row.shape[1] != self.row_dim:
                    raise ValueError("row dim")
            except Exception:
                conn.complete(conn.push_slot(1), RESP_400)
                self._c.inc("frontdoor_request_errors", job=self.job)
                return
            # same bounded admission as the f32 path: the JSON contract
            # must not be an uncapped side door into the queue
            admit, pause = self._admission(1, meta.priority)
            if admit < 1:
                self._shed(conn, 1, meta.priority)
                if pause:
                    conn.pause()
                    self._paused_conns.add(conn)
                return
            self._admit(conn, row, meta, json_resp=True, t_recv=t_recv)
            return
        if meta.method == "POST" and path.startswith("/admin/"):
            self._handle_admin(conn, path, body)
            return
        conn.complete(conn.push_slot(1), RESP_404)

    def _handle_admin(self, conn: HttpConn, path: str, body: bytes) -> None:
        verb = path[len("/admin/"):]
        if verb == "stall":
            try:
                self._stall_once_ms = float(body.decode() or "0")
            except ValueError:
                conn.complete(conn.push_slot(1), RESP_400)
                return
            conn.complete(conn.push_slot(1), RESP_200_EMPTY)
        elif verb == "activate":
            # scale-up adoption of a warm standby: the compile already
            # happened off the traffic path; the gate just opens.  CAS
            # from STANDBY only (idempotent when already READY) — an
            # activate must not revive a DRAINING or failed replica.
            if self.state == FD_READY \
                    or self._set_state_if(FD_STANDBY, FD_READY):
                conn.complete(conn.push_slot(1), RESP_200_EMPTY)
            else:
                conn.complete(conn.push_slot(1), RESP_409)
        elif verb == "drain":
            self._set_state(FD_DRAINING)
            conn.complete(conn.push_slot(1), RESP_200_EMPTY)
        elif verb == "gray":
            # chaos drill injection: body is "<rate> <mode> <duration_s>"
            try:
                rate, mode, dur = body.decode().split()
                self.set_gray(float(rate), mode, float(dur))
            except (ValueError, UnicodeDecodeError):
                conn.complete(conn.push_slot(1), RESP_400)
                return
            conn.complete(conn.push_slot(1), RESP_200_EMPTY)
        elif verb == "reload":
            hook = getattr(self, "reload_hook", None)
            if hook is None:
                conn.complete(conn.push_slot(1), RESP_404)
                return
            threading.Thread(target=self._reload_via, args=(hook,),
                             daemon=True).start()
            conn.complete(conn.push_slot(1), RESP_200_EMPTY)
        else:
            conn.complete(conn.push_slot(1), RESP_404)

    def on_conn_lost(self, conn: HttpConn) -> None:
        self._paused_conns.discard(conn)

    # -- weight reloads ------------------------------------------------------

    def _reload_via(self, hook) -> None:
        """Admin-triggered reload: gate (publish RELOADING so the LB
        stops routing), let the queue drain, swap at an iteration
        boundary, regate."""
        prev = self.state
        try:
            loaded = hook()
            if loaded is None:
                return
            params, generation = loaded
            self.swap_weights(params, generation)
        except Exception as exc:
            log.error("reload failed", replica=self.replica,
                      error=str(exc)[:200])
            self._set_state_if(FD_RELOADING,
                               FD_STANDBY if prev == FD_STANDBY
                               else FD_READY)

    def swap_weights(self, params: Any, generation: int,
                     timeout_s: float = 30.0) -> bool:
        # regate to where we came from: a warm STANDBY getting a fleet-
        # wide rolling reload stays unroutable — a reload must not
        # activate a replica behind the autoscaler's back.  A replica
        # already DRAINING (or dead) is leaving: don't reload, and
        # NEVER regate over the drain (the CAS below also covers a
        # drain that lands mid-swap).
        prev = self.state
        if self.failed or prev in (FD_DRAINING, FD_BUILDING):
            return False
        regate = FD_STANDBY if prev == FD_STANDBY else FD_READY
        if not self._set_state_if(prev, FD_RELOADING):
            return False  # the gate moved first (drain/activate race)
        deadline = time.perf_counter() + timeout_s
        while self._queued_rows > 0 and time.perf_counter() < deadline:
            time.sleep(0.002)
        self._swap_applied.clear()
        with self._cond:
            self._pending_weights = (params, generation)
            self._cond.notify()
        ok = self._swap_applied.wait(timeout_s) and self._swap_ok
        self._set_state_if(FD_RELOADING, regate)
        return ok

    # -- the batcher thread --------------------------------------------------

    def _warm(self) -> None:
        t0 = time.perf_counter()
        self.server = self.build_server()
        example = (np.zeros((self.max_batch, self.row_dim), np.float32),)
        self.server.warmup(example)
        out = _to_host(self.server.serve(example))
        self._prep_out_head(out.shape[1] if out.ndim > 1 else 1)
        self._set_state(FD_STANDBY if self.standby else FD_READY)
        self._ready_evt.set()
        log.info("replica ready", replica=self.replica,
                 build_ms=round((time.perf_counter() - t0) * 1e3, 1))

    def _prep_out_head(self, out_dim: int) -> None:
        body_len = out_dim * 4
        head = (f"HTTP/1.1 200 OK\r\nContent-Type: {F32_CONTENT_TYPE}\r\n"
                f"Content-Length: {body_len}\r\n\r\n").encode()
        self.out_dim = out_dim
        self._out_head = head
        self._out_head_arr = np.frombuffer(head, np.uint8)
        self._resp_stride = len(head) + body_len

    def _run(self) -> None:
        try:
            self._warm()
        except Exception as exc:
            log.error("replica build failed", replica=self.replica,
                      error=str(exc)[:300])
            self.failed = True
            self._set_state(FD_DRAINING)
            self._ready_evt.set()
            # anything already admitted would otherwise wait forever
            with self._cond:
                blocks = list(self._queue)
                self._queue.clear()
                self._queued_rows = 0
            if blocks:
                self.door.call_soon(self._deliver, [
                    (b.conn, b.slot, RESP_503 * len(b.rows))
                    for b in blocks])
            self.door.call_soon(self._resume_paused)
            return
        while True:
            blocks = self._take()
            if blocks is None:
                return
            self._maybe_swap()
            if not blocks:
                continue
            t_take = time.perf_counter()
            self._brownout_tick(t_take, blocks)
            if self._stall_once_ms > 0:
                # the injected straggler: this iteration wedges AFTER
                # admission, so its requests age past the LB hedge delay
                ms, self._stall_once_ms = self._stall_once_ms, 0.0
                time.sleep(ms / 1000.0)
            n = sum(len(b.rows) for b in blocks)
            rows = (blocks[0].rows if len(blocks) == 1
                    else np.concatenate([b.rows for b in blocks]))
            t_fwd = time.perf_counter()
            try:
                out = self._forward(rows)
            except Exception as exc:
                log.error("serve iteration failed", error=str(exc)[:200])
                self._c.inc("frontdoor_request_errors", n, job=self.job)
                done = [(b.conn, b.slot, RESP_503 * len(b.rows))
                        for b in blocks]
                self.door.call_soon(self._deliver, done)
                self._drained(n)
                continue
            now = time.perf_counter()
            self.iterations += 1
            self.requests_served += n
            # response matrix, fully vectorized: fixed head prefix per
            # row + the row's f32 output body
            mat = np.empty((n, self._resp_stride), np.uint8)
            mat[:, :len(self._out_head)] = self._out_head_arr
            mat[:, len(self._out_head):] = (
                np.ascontiguousarray(out, dtype="<f4")
                .view(np.uint8).reshape(n, -1))
            done = []
            lats = []
            off = 0
            gray = (self._gray_rate > 0.0
                    and time.perf_counter() < self._gray_until)
            for b in blocks:
                k = len(b.rows)
                if gray:
                    gdata = self._gray_response(b, k)
                    if gdata is not None:
                        done.append((b.conn, b.slot, gdata))
                        lats.append((now - b.t, k))
                        off += k
                        continue
                if b.json:
                    import json

                    payload = json.dumps(
                        {"outputs": out[off].tolist(),
                         "generation": self.generation}).encode()
                    data = (b"HTTP/1.1 200 OK\r\n"
                            b"Content-Type: application/json\r\n"
                            + (f"X-EDL-Trace-Id: {b.trace_id}\r\n".encode()
                               if b.trace_id else b"")
                            + (f"X-EDL-Block-Nonce: {b.nonce}\r\n".encode()
                               if b.nonce else b"")
                            + f"Content-Length: {len(payload)}"
                              f"\r\n\r\n".encode() + payload)
                elif b.trace_id or b.nonce:
                    # traced/nonce'd f32 rows echo the headers too: the
                    # contract holds on the fast path, not just the
                    # JSON slow path (f32↔JSON parity) — and the echo
                    # is NEVER shed, even in brownout (it is what lets
                    # the LB trust the payload)
                    echo = (
                        b"HTTP/1.1 200 OK\r\nContent-Type: "
                        + F32_CONTENT_TYPE.encode()
                        + (b"\r\nX-EDL-Trace-Id: "
                           + b.trace_id.encode("latin1")
                           if b.trace_id else b"")
                        + (b"\r\nX-EDL-Block-Nonce: "
                           + b.nonce.encode("latin1")
                           if b.nonce else b"")
                        + b"\r\nContent-Length: "
                        + str(self.out_dim * 4).encode() + b"\r\n\r\n")
                    bodies = mat[off:off + k, len(self._out_head):]
                    data = b"".join(echo + bodies[i].tobytes()
                                    for i in range(k))
                else:
                    data = mat[off:off + k].tobytes()
                done.append((b.conn, b.slot, data))
                lats.append((now - b.t, k))
                if b.trace_id and not self._brownout:
                    # brownout sheds span/exemplar work first: tracing
                    # is the cheapest thing to stop doing under duress
                    self._emit_block_spans(b, t_take, t_fwd, now)
                off += k
            self.door.call_soon(self._deliver, done)
            self._bhist.observe(n, job=self.job)
            self._hist.observe_many(
                np.repeat([l for l, _ in lats], [k for _, k in lats]),
                job=self.job)
            self._c.inc("frontdoor_requests_served", n, job=self.job)
            if self.slo_p99_ms:
                viol = sum(k for l, k in lats
                           if l * 1000.0 > self.slo_p99_ms)
                if viol:
                    self._c.inc("serving_slo_violations", viol,
                                job=self.job)
            self._drained(n)
            del mat

    def _emit_block_spans(self, b: _Block, t_take: float, t_fwd0: float,
                          t_fwd1: float) -> None:
        """One traced block's span tree: a ``frontdoor_request`` root
        (parented to the LB's admission span via the injected
        ``X-EDL-Parent-Span``, so the cross-tier tree stitches) with the
        phase cuts parse → admit → queue → batch → forward → respond as
        children — the door's third of the LB-origin taxonomy
        (doc/serving.md §request tracing).  Emitted only for the sampled
        minority; the steady state pays nothing."""
        tracer = get_tracer()
        t_done = time.perf_counter()
        lat = t_done - b.t_recv
        root = tracer.record_span(
            "frontdoor_request", "frontdoor", b.t_recv, t_done,
            trace_id=b.trace_id, parent_id=b.parent,
            replica=self.replica, job=self.job, rows=len(b.rows),
            generation=self.generation, path="json" if b.json else "f32",
            latency_ms=round(lat * 1e3, 3))
        for phase, t0, t1 in (
                # parse is ~0 by construction (head cache / block scan);
                # the zero-length span records that honestly
                ("parse", b.t_recv, b.t_recv),
                ("admit", b.t_recv, b.t),
                ("queue", b.t, t_take),
                ("batch", t_take, t_fwd0),
                ("forward", t_fwd0, t_fwd1),
                ("respond", t_fwd1, t_done)):
            tracer.record_span(f"frontdoor.{phase}", "frontdoor", t0,
                               max(t1, t0), trace_id=b.trace_id,
                               parent_id=root)
        self._hist.put_exemplar(lat, b.trace_id, job=self.job)
        self.exemplars.append({
            "trace_id": b.trace_id, "replica": self.replica,
            "latency_ms": round(lat * 1e3, 3), "rows": len(b.rows),
            "queue_ms": round(max(t_take - b.t, 0.0) * 1e3, 3),
            "forward_ms": round((t_fwd1 - t_fwd0) * 1e3, 3),
        })

    # -- gray-failure seam + brownout (chaos drills / degraded mode) ---------

    def set_gray(self, rate: float, mode: str = "error",
                 duration_s: float = 1.0) -> None:
        """Chaos seam for the
        :class:`~edl_tpu_torch.runtime.faults.GrayReplica` drill: for
        ``duration_s`` a ``rate`` fraction of blocks get gray answers.
        ``"error"`` sends 500s; ``"corrupt"`` sends a
        wrong-nonce echo + garbage body on nonce'd blocks only — the
        misroute/desync shape the LB's integrity check exists to catch
        (corrupting an un-nonce'd block would be a silently-wrong
        payload no tier could detect, which the drill invariant
        forbids)."""
        if mode not in ("error", "corrupt"):
            raise ValueError(f"unknown gray mode {mode!r}")
        self._gray_rate = max(float(rate), 0.0)
        self._gray_mode = mode
        self._gray_until = time.perf_counter() + float(duration_s)

    def _gray_response(self, b: _Block, k: int) -> Optional[bytes]:
        if self._gray_rng.random() >= self._gray_rate:
            return None
        if self._gray_mode == "error":
            self._c.inc("frontdoor_gray_responses", k, job=self.job,
                        mode="error")
            return RESP_500 * k
        if b.nonce is None:
            return None
        self._c.inc("frontdoor_gray_responses", k, job=self.job,
                    mode="corrupt")
        body = b"\xde\xad" * (self.out_dim * 2)
        head = (f"HTTP/1.1 200 OK\r\nContent-Type: {F32_CONTENT_TYPE}\r\n"
                f"X-EDL-Block-Nonce: bad-{b.nonce}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        return (head + body) * k

    def note_lag_breach(self) -> None:
        """Relay from the :class:`LoopLagProbe`'s sustained-lag
        escalation (any thread): the next batcher iteration enters
        brownout immediately — the probe already proved sustain."""
        self._lag_breach = True

    def _brownout_tick(self, now: float, blocks: list) -> None:
        lag = self._lag_breach
        if lag:
            self._lag_breach = False
        age_breach = False
        if self.brownout_enter_ms > 0 and blocks:
            age_breach = ((now - blocks[0].t) * 1e3
                          > self.brownout_enter_ms)
        if not self._brownout:
            if lag:
                self._brn_streak = self.brownout_sustain
            elif age_breach:
                self._brn_streak += 1
            else:
                self._brn_streak = 0
            if self._brn_streak >= self.brownout_sustain:
                self._brownout = True
                self.brownouts += 1
                self._brn_since = self._brn_last = now
                self._brn_clear = 0
                self._brn_streak = 0
                log.warn("entering brownout", replica=self.replica,
                         queued_rows=self._queued_rows)
                get_tracer().instant("brownout_entered",
                                     category="serving",
                                     replica=self.replica)
            return
        # in brownout: bank the degraded seconds incrementally (the
        # scrape plane sees the episode GROW, not just its post-mortem
        # total), then exit only with hysteresis
        self._brn_seconds.inc(max(now - self._brn_last, 0.0),
                              job=self.job, replica=self.replica)
        self._brn_last = now
        if lag or age_breach:
            self._brn_clear = 0
            return
        self._brn_clear += 1
        if (now - self._brn_since >= self.brownout_min_s
                and self._brn_clear >= self.brownout_sustain):
            self._brownout = False
            log.info("exiting brownout", replica=self.replica,
                     brownout_s=round(now - self._brn_since, 3))
            get_tracer().instant("brownout_exited", category="serving",
                                 replica=self.replica)

    def _forward(self, rows: np.ndarray) -> np.ndarray:
        """Serve ``rows`` in chunks of at most ``max_batch`` (a burst can
        outrun one batch).  A short chunk is served as it is: the port's
        forward takes any batch, so it is not padded to a fixed shape.
        Each chunk is copied out of the request buffers it views (a lone
        row of a fixed-stride block keeps that block's row stride, which
        no tensor can take).  The answers come back to host numpy on this
        (the batcher) thread."""
        B = self.max_batch
        outs = [_to_host(self.server.serve((rows[i:i + B].copy(),)))
                for i in range(0, len(rows), B)]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _take(self) -> Optional[list[_Block]]:
        with self._cond:
            while not self._queue and not self._halt \
                    and self._pending_weights is None:
                self._cond.wait(0.05)
            if self._halt and not self._queue:
                return None
            if self._queue and self.max_queue_ms > 0 \
                    and not self._brownout:
                # admission window: wait for co-batchees once the first
                # block is in hand, bounded by max_queue_ms (collapsed
                # to 0 in brownout: tightest queue deadline first)
                deadline = time.perf_counter() + self.max_queue_ms / 1e3
                while self._queued_rows < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._halt:
                        break
                    self._cond.wait(remaining)
            blocks: list[_Block] = []
            rows = 0
            while self._queue and (rows < self.max_batch or not blocks):
                blk = self._queue.popleft()
                blocks.append(blk)
                rows += len(blk.rows)
            return blocks

    def _maybe_swap(self) -> None:
        with self._cond:
            pending, self._pending_weights = self._pending_weights, None
        if pending is None:
            return
        params, generation = pending
        try:
            self.server.load_params(params)
        except Exception as exc:
            # corrupt/incompatible weights must not kill the batcher:
            # keep serving the old generation, surface the failure to
            # the waiting swap_weights
            log.error("weight swap failed; keeping old generation",
                      replica=self.replica, generation=generation,
                      error=str(exc)[:200])
            self._c.inc("serving_reload_failures", job=self.job)
            self._swap_ok = False
            self._swap_applied.set()
            return
        self.generation = generation
        self._swap_ok = True
        self._swap_applied.set()
        self._c.inc("serving_reloads", job=self.job)
        log.info("weights swapped", replica=self.replica,
                 generation=generation)

    def _drained(self, n: int) -> None:
        with self._cond:
            self._queued_rows -= n
            resume = (self._paused_conns
                      and self._queued_rows < self.soft_cap // 2)
        if resume:
            self.door.call_soon(self._resume_paused)

    def _resume_paused(self) -> None:
        for conn in list(self._paused_conns):
            conn.resume()
        self._paused_conns.clear()

    @staticmethod
    def _deliver(done: list) -> None:
        touched = set()
        for conn, slot, data in done:
            if conn.closed:
                continue
            slot.data = data
            touched.add(conn)
        for conn in touched:
            conn.flush()


# -- serve_main's in-process fleet behind the async door ---------------------


class FleetApp:
    """``serve_main``'s app: the :class:`ServingFleet` (in-process
    replicas, autoscaling, rolling reloads) served through the async
    front door — keep-alive + pipelining + the f32 fast path for free,
    with the JSON ``/predict`` contract unchanged.  Throughput here is
    bounded by the per-request fleet path; the 10⁵-qps plane is
    :class:`BatchApp` replicas behind :mod:`edl_tpu_torch.runtime.lb`."""

    wants_raw = False

    def __init__(self, fleet, row_dim: int, timeout_s: float = 30.0,
                 decode_fleet=None) -> None:
        self.fleet = fleet
        self.row_dim = int(row_dim)
        self.timeout_s = timeout_s
        #: optional :class:`~edl_tpu_torch.runtime.serving.DecodeFleet` behind
        #: POST /generate (doc/serving.md §autoregressive serving)
        self.decode_fleet = decode_fleet
        self.door: Optional[FrontDoor] = None
        self._c = get_counters()

    def attach(self, door: FrontDoor) -> None:
        self.door = door

    def on_conn_lost(self, conn) -> None:
        pass

    def _submit(self, conn, row: np.ndarray, trace_id, json_resp: bool,
                slot: RespSlot, pri: int = PRI_NORMAL,
                parent_span=None, nonce=None) -> None:
        from edl_tpu_torch.runtime.serving import RequestDropped

        door = self.door

        try:
            req = self.fleet.submit((row,), trace_id=trace_id,
                                    parent_span=parent_span)
        except RequestDropped:
            # a fleet admission shed is OVERLOAD, not failure: the same
            # 429 + shed counter the BatchApp path gives it, so clients
            # back off and shed-rate dashboards see it
            self._c.inc("frontdoor_overload_sheds", job=door.job,
                        priority=PRIORITY_NAMES[pri])
            door.call_soon(conn.complete, slot, RESP_429)
            return

        def finish(r) -> None:
            if r.error is not None:
                data = RESP_503
            elif json_resp:
                import json

                payload = json.dumps({
                    "outputs": np.asarray(r.result).tolist(),
                    "generation": self.fleet.generation,
                    "latency_ms": round(r.latency_s * 1000, 3),
                }).encode()
                data = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: application/json\r\n"
                        + (f"X-EDL-Trace-Id: {trace_id}\r\n".encode()
                           if trace_id else b"")
                        + (f"X-EDL-Block-Nonce: {nonce}\r\n".encode()
                           if nonce else b"")
                        + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                        + payload)
            else:
                body = np.ascontiguousarray(
                    r.result, dtype="<f4").tobytes()
                # the echo contract holds for f32 exactly like JSON
                data = (f"HTTP/1.1 200 OK\r\n"
                        f"Content-Type: {F32_CONTENT_TYPE}\r\n"
                        + (f"X-EDL-Trace-Id: {trace_id}\r\n"
                           if trace_id else "")
                        + (f"X-EDL-Block-Nonce: {nonce}\r\n"
                           if nonce else "")
                        + f"Content-Length: {len(body)}\r\n\r\n"
                        ).encode() + body
            door.call_soon(self._fill, conn, slot, data, timer)

        # the legacy handler's per-request bound, kept: a fleet request
        # that never completes must 500 after timeout_s, not head-of-
        # line-block every later response on the keep-alive connection
        # (_submit runs on the loop thread, so call_later is safe here)
        timer = door.loop.call_later(
            self.timeout_s, self._expire, conn, slot)
        req.add_done_callback(finish)

    def _fill(self, conn, slot: RespSlot, data: bytes, timer) -> None:
        timer.cancel()
        if slot.data is None:
            conn.complete(slot, data)

    def _expire(self, conn, slot: RespSlot) -> None:
        if slot.data is None and not conn.closed:
            self._c.inc("frontdoor_request_errors", job=self.door.job)
            conn.complete(slot, RESP_500)

    def handle_rows(self, conn, rows: np.ndarray, meta: HeadMeta) -> None:
        if rows.shape[1] != self.row_dim:
            conn.complete(conn.push_slot(len(rows)), RESP_400 * len(rows))
            return
        for row in rows:
            self._submit(conn, row, meta.trace_id, False,
                         conn.push_slot(1), meta.priority,
                         parent_span=meta.parent_span, nonce=meta.nonce)

    def handle_request(self, conn, meta: HeadMeta, body: bytes,
                       raw: bytes) -> None:
        if meta.method == "GET":
            if meta.path == "/healthz":
                ok = self.fleet.replicas_ready() >= 1
                conn.complete(conn.push_slot(1),
                              RESP_200_EMPTY if ok else RESP_503)
            else:
                conn.complete(conn.push_slot(1), RESP_404)
            return
        if meta.method == "POST" and meta.path == "/predict":
            try:
                import json

                row = np.asarray(json.loads(body.decode())["inputs"],
                                 np.float32)
            except Exception:
                conn.complete(conn.push_slot(1), RESP_400)
                return
            self._submit(conn, row, meta.trace_id, True, conn.push_slot(1),
                         meta.priority, parent_span=meta.parent_span,
                         nonce=meta.nonce)
            return
        if (meta.method == "POST" and meta.path == "/generate"
                and self.decode_fleet is not None):
            self._generate(conn, meta, body)
            return
        conn.complete(conn.push_slot(1), RESP_404)

    def _generate(self, conn, meta: HeadMeta, body: bytes) -> None:
        """Autoregressive completion: ``{"prompt": [ids], "max_new_tokens":
        N}`` → the session's full greedy generation (a 429 when the KV
        pool's bounded admission sheds).  The response echoes the
        session id so affinity-aware clients/LBs can pin follow-ups."""
        import json

        from edl_tpu_torch.runtime.kvcache import KVPoolExhausted

        door = self.door
        try:
            req = json.loads(body.decode())
            prompt = [int(t) for t in req["prompt"]]
            max_new = int(req.get("max_new_tokens", 16))
        except Exception:
            conn.complete(conn.push_slot(1), RESP_400)
            return
        slot = conn.push_slot(1)

        def finish(sess) -> None:
            if sess.error is not None:
                data = RESP_503
            else:
                payload = json.dumps({
                    "tokens": sess.generated,
                    "session": sess.id,
                    "ttft_ms": round(sess.ttft_s * 1e3, 3),
                    "tpot_ms": round(sess.tpot_s * 1e3, 4),
                    "generation": self.decode_fleet.generation,
                }).encode()
                data = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: application/json\r\n"
                        + f"X-EDL-Session: {sess.id}\r\n".encode()
                        # the session is terminal with this response
                        # (EOS or max_new): an affinity-keeping LB must
                        # evict its pin, not wait for LRU pressure
                        + b"X-EDL-Session-Done: 1\r\n"
                        + (f"X-EDL-Trace-Id: {meta.trace_id}\r\n".encode()
                           if meta.trace_id else b"")
                        + (f"X-EDL-Block-Nonce: {meta.nonce}\r\n".encode()
                           if meta.nonce else b"")
                        + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                        + payload)
            door.call_soon(self._fill_gen, conn, slot, data)

        from edl_tpu_torch.runtime.serving import SessionDropped

        try:
            self.decode_fleet.submit(prompt, max_new,
                                     priority=meta.priority,
                                     trace_id=meta.trace_id,
                                     on_done=finish)
        except KVPoolExhausted:
            self._c.inc("frontdoor_overload_sheds", job=door.job,
                        priority=PRIORITY_NAMES[meta.priority])
            conn.complete(slot, RESP_429)
        except SessionDropped:
            conn.complete(slot, RESP_503)
        except ValueError:
            conn.complete(slot, RESP_400)

    def _fill_gen(self, conn, slot: RespSlot, data: bytes) -> None:
        if slot.data is None:
            conn.complete(slot, data)


# -- event-loop lag watchdog -------------------------------------------------


class LoopLagProbe:
    """Self-timing probe on a :class:`FrontDoor`'s event loop — the
    whole data plane is ONE loop per process, so a GC pause or an
    accidental blocking call on the loop thread stalls every connection
    at once while every existing counter keeps looking healthy.  The
    probe reschedules itself every ``interval_s`` and measures how late
    the loop actually ran it:

    * every tick's lag lands in ``edl_loop_lag_seconds{loop=}``
      (:data:`LOOP_LAG_BUCKETS`) — the scrape plane sees scheduling
      jitter grow BEFORE it becomes an outage;
    * a lag past ``breach_s`` counts ``loop_lag_breaches_total{loop=}``;
      ``sustain`` consecutive breaches escalate: one flight record
      (reason ``loop-lag-<name>``, the exemplar ring embedded, deduped
      by the shared cooldown) so the post-mortem shows what the loop
      was doing while it lagged;
    * a fully WEDGED loop (no ticks at all) is caught by a threaded
      :class:`~edl_tpu_torch.runtime.watchdog.StallWatchdog` fed one beat per
      tick — escalation dumps a ``loop-stall-<name>`` record and counts
      ``stalls_detected{scope=loop-<name>}``, turning the silent-hang
      failure class into evidence."""

    def __init__(self, door: FrontDoor, loop_name: str, *,
                 interval_s: float = 0.05, breach_s: float = 0.25,
                 sustain: int = 3, flight_dir: str = "",
                 exemplars_fn: Optional[Callable[[], list]] = None,
                 dump_cooldown_s: float = 30.0,
                 on_sustained: Optional[Callable[[str, float],
                                                 None]] = None) -> None:
        from edl_tpu_torch.runtime.watchdog import StallWatchdog

        self.door = door
        self.loop_name = loop_name
        self.interval_s = max(float(interval_s), 0.005)
        self.breach_s = float(breach_s)
        self.sustain = max(int(sustain), 1)
        self.flight_dir = flight_dir
        self.exemplars_fn = exemplars_fn
        self.dump_cooldown_s = float(dump_cooldown_s)
        #: escalation relay (``(kind, lag_s)``, loop thread): what wires
        #: sustained lag into the replica's brownout entry
        self.on_sustained = on_sustained
        self.ticks = 0
        self.breaches = 0
        self.escalations = 0
        # _escalate runs on the loop thread (sustained lag) and on the
        # watchdog's thread (a wedged loop): the count is taken under this
        self._esc_lock = threading.Lock()
        self.last_lag_s = 0.0
        self._streak = 0
        self._expected = 0.0
        self._handle = None
        self._stopped = False
        self._hist = get_registry().histogram(
            "loop_lag_seconds",
            help="event-loop scheduling lag of the self-timing probe",
            buckets=LOOP_LAG_BUCKETS)
        self._c = get_counters()
        # the floor bounds detection of a FULLY wedged loop; beats come
        # every interval_s, so the EWMA term stays tiny and the floor is
        # the whole deadline
        self._watchdog = StallWatchdog(
            floor_s=max(4.0 * self.breach_s, 20.0 * self.interval_s, 1.0),
            scope=f"loop-{loop_name}", flight_dir="",
            on_stall=self._on_stall)

    def start(self) -> "LoopLagProbe":
        # seed the deadline clock BEFORE handing anything to the loop:
        # a loop that wedges before the first _tick ever runs would
        # otherwise never arm the watchdog (no beat → check() is a
        # no-op) — the exact silent-hang class this probe exists for
        self._watchdog.beat()
        self.door.call_soon(self._arm)
        self._watchdog.start(poll_s=max(self.interval_s, 0.05))
        return self

    def _arm(self) -> None:
        self._expected = time.perf_counter() + self.interval_s
        self._handle = self.door.loop.call_later(self.interval_s,
                                                 self._tick)

    def _tick(self) -> None:
        if self._stopped:
            return
        now = time.perf_counter()
        lag = max(now - self._expected, 0.0)
        self.ticks += 1
        self.last_lag_s = lag
        self._hist.observe(lag, loop=self.loop_name)
        self._watchdog.beat()
        if lag > self.breach_s:
            self.breaches += 1
            self._c.inc("loop_lag_breaches", loop=self.loop_name)
            self._streak += 1
            # "sustained" = N consecutive breached ticks, OR one pause
            # so long it covers N breach windows by itself (a single
            # multi-second GC pause schedules only ONE late tick — it
            # must not need N repeats to count)
            if self._streak >= self.sustain \
                    or lag >= self.sustain * self.breach_s:
                self._escalate("loop-lag", lag)
                self._streak = 0
        else:
            self._streak = 0
        self._expected = now + self.interval_s
        self._handle = self.door.loop.call_later(self.interval_s,
                                                 self._tick)

    def _on_stall(self, stall) -> None:
        # no beats at all: the loop is WEDGED, not merely laggy
        self._escalate("loop-stall", getattr(stall, "silent_s", 0.0))

    def _escalate(self, kind: str, lag_s: float) -> None:
        with self._esc_lock:
            self.escalations += 1
        log.error("event loop lagging", loop=self.loop_name, kind=kind,
                  lag_ms=round(lag_s * 1e3, 1))
        get_tracer().instant(f"{kind}_escalated", category="loop",
                             loop=self.loop_name,
                             lag_ms=round(lag_s * 1e3, 1))
        if self.on_sustained is not None:
            try:
                self.on_sustained(kind, lag_s)
            except Exception as exc:
                log.warn("loop-lag escalation relay failed",
                         error=str(exc)[:120])
        if not self.flight_dir:
            return
        try:
            extra = {"loop": self.loop_name, "lag_s": lag_s}
            if self.exemplars_fn is not None:
                extra["exemplars"] = list(self.exemplars_fn())
            dump_flight_record(self.flight_dir, f"{kind}-{self.loop_name}",
                               extra=extra,
                               cooldown_s=self.dump_cooldown_s)
        except Exception as exc:
            log.warn("loop-lag flight record dump failed",
                     error=str(exc)[:120])

    def stop(self) -> None:
        self._stopped = True
        self._watchdog.stop()
        handle = self._handle

        def cancel() -> None:
            if handle is not None:
                handle.cancel()

        try:
            self.door.call_soon(cancel)
        except Exception:
            pass  # loop already gone


# -- process entrypoint ------------------------------------------------------


class CoordBootstrapError(RuntimeError):
    """The coordinator endpoint was configured but never answered within
    the bootstrap deadline — the pod must fail loudly (exit 3), not hang
    past its readiness budget or silently run discovery-less."""


def bootstrap_kv(env, *, disabled: str,
                 var: str = "EDL_COORD_ENDPOINT") -> Optional[Any]:
    """Coordinator bootstrap for serving-plane pods (replica + LB mains).

    An UNSET/blank endpoint stays the quiet degraded path (returns None,
    like :func:`~edl_tpu_torch.coord.client.client_from_env`).  A CONFIGURED
    endpoint is a hard dependency: probe it with short-timeout PING
    sockets under jittered exponential backoff until it answers PONG —
    the probe catches black-holed endpoints where the TCP connect
    succeeds but requests hang, which a bare ``CoordClient(...)``
    construct-and-hope never would — and raise
    :class:`CoordBootstrapError` once ``EDL_COORD_BOOTSTRAP_DEADLINE_S``
    (default 10) lapses, so a down coordinator at pod start fails
    loudly inside the readiness budget instead of hanging past it."""
    endpoint = env.get(var, "")
    if ":" not in endpoint:
        log.info(f"{var} not set; {disabled}")
        return None
    host, _, port_s = endpoint.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        raise CoordBootstrapError(f"unparseable {var}={endpoint!r}")
    deadline_s = float(env.get("EDL_COORD_BOOTSTRAP_DEADLINE_S", "10"))
    t0 = time.monotonic()
    rng = random.Random()
    attempt = 0
    while True:
        remaining = t0 + deadline_s - time.monotonic()
        if remaining <= 0:
            raise CoordBootstrapError(
                f"coordinator at {endpoint} unreachable for "
                f"{deadline_s:.1f}s ({attempt} attempts)")
        probe_timeout = min(1.0, max(remaining, 0.05))
        try:
            with socket.create_connection((host, port),
                                          timeout=probe_timeout) as s:
                s.settimeout(probe_timeout)
                s.sendall(b"PING\n")
                if s.makefile("rb").readline().startswith(b"PONG"):
                    from edl_tpu_torch.coord.client import CoordClient

                    return CoordClient(host, port)
        except OSError:
            pass
        attempt += 1
        # jittered exponential backoff, capped at 1 s: fast retries for
        # a restarting coordinator, no thundering herd across a fleet
        delay = min(1.0, 0.05 * (2 ** attempt)) * rng.uniform(0.5, 1.0)
        remaining = t0 + deadline_s - time.monotonic()
        if remaining <= 0:
            raise CoordBootstrapError(
                f"coordinator at {endpoint} unreachable for "
                f"{deadline_s:.1f}s ({attempt} attempts)")
        time.sleep(min(delay, remaining))


def replica_main(env=None, device="cuda") -> int:
    """One data-plane replica process (``python -m
    edl_tpu_torch.runtime.frontdoor``) on ``device`` (the card unless the
    caller asks for another; with no CUDA device the build fails and the
    process exits 3): an :class:`ElasticServer` behind a
    :class:`BatchApp` front door, the ready-gate address published to
    coordinator KV, ``/metrics`` on its own port.  The EDL_FD_* env
    contract mirrors EDL_SERVING_* (doc/serving.md §data-plane); the
    model is ``EDL_FD_MODEL=mlp:IN,HID..,OUT`` with the seed-0 weights of
    :class:`~edl_tpu_torch.models.mlp.MLP`, or the newest verified step of
    the ``EDL_FD_MODEL_DIR`` lineage.

    Observability wiring: ``EDL_TRACE_DIR`` dumps the trace ring as a
    pid-suffixed ``trace-*.json`` every second (Chrome trace JSON, the
    LB's spans stitch to it by trace id); ``EDL_FLIGHTREC_DIR`` arms
    flight records on abnormal exit, build failure, and sustained
    event-loop lag (the exemplar ring embedded); ``EDL_FD_LAG_PROBE_MS``
    (default 50, 0 disables) drives the :class:`LoopLagProbe`."""
    env = os.environ if env is None else env
    try:
        return _replica_main(env, device)
    except Exception:
        # abnormal exit: leave the post-mortem on disk like the
        # supervisor does (pid-suffixed by dump_flight_record)
        fdir = env.get("EDL_FLIGHTREC_DIR", "")
        if fdir:
            try:
                dump_flight_record(fdir, "frontdoor-abnormal-exit")
            except Exception:
                pass
        raise


def _replica_main(env, device) -> int:
    from edl_tpu_torch.models import mlp

    model = env.get("EDL_FD_MODEL", "mlp:16,32,4")
    kind, _, shape = model.partition(":")
    if kind != "mlp":
        print(f"error: unknown EDL_FD_MODEL kind {kind!r}", flush=True)
        return 2
    sizes = [int(x) for x in shape.split(",")]
    job = env.get("EDL_FD_JOB", "default/serving")
    replica = env.get("EDL_FD_REPLICA", f"r{os.getpid()}")
    model_dir = env.get("EDL_FD_MODEL_DIR", "")

    params = mlp.MLP(sizes, device="cpu", seed=0)
    generation = 0
    ckpt = None
    if model_dir:
        from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

        ckpt = ElasticCheckpointer(model_dir)
        step = ckpt.latest_verified_step()
        if step is not None:
            params = ckpt.restore({"params": params}, step=step)["params"]
            generation = step

    try:
        kv = bootstrap_replica_kv(env, replica)
    except CoordBootstrapError:
        return 3

    from edl_tpu_torch.device import resolve
    from edl_tpu_torch.runtime.serving import ElasticServer

    def build() -> ElasticServer:
        # resolve() raises with no CUDA device: the build fails, the
        # replica exits 3, and nothing serves from another device
        return ElasticServer(lambda p, b: mlp.apply(p, b[0]), params,
                             devices=[resolve(device)])

    app = BatchApp(
        build, sizes[0], job=job, replica=replica,
        max_batch=int(env.get("EDL_FD_MAX_BATCH", "256")),
        max_queue_ms=float(env.get("EDL_FD_MAX_QUEUE_MS", "2.0")),
        hard_cap_rows=int(env.get("EDL_FD_CAP_ROWS", "65536")),
        slo_p99_ms=float(env.get("EDL_FD_SLO_P99_MS", "0")),
        kv=kv, addr_ttl_s=float(env.get("EDL_FD_TTL_S", "15")),
        standby=env.get("EDL_FD_STANDBY", "0") == "1",
        brownout_enter_ms=float(env.get("EDL_FD_BROWNOUT_MS", "0")),
        brownout_sustain=int(env.get("EDL_FD_BROWNOUT_SUSTAIN", "3")),
        brownout_min_s=float(env.get("EDL_FD_BROWNOUT_MIN_S", "0.5")))
    app.generation = generation

    def reload_hook():
        if ckpt is None:
            return None
        refresh = getattr(ckpt, "refresh", None)
        if refresh is not None:
            refresh()
        step = ckpt.latest_verified_step()
        if step is None or step <= app.generation:
            return None
        restored = ckpt.restore(
            {"params": app.server.params_host()}, step=step)
        return restored["params"], step

    app.reload_hook = reload_hook

    door = FrontDoor(app, host=env.get("EDL_FD_HOST", "0.0.0.0"),
                     port=int(env.get("EDL_FD_PORT", "0")), job=job)
    door.start()
    return run_replica(
        door, kv, env, replica=replica,
        build_timeout_s=float(env.get("EDL_FD_BUILD_TIMEOUT_S", "120")))


def bootstrap_replica_kv(env, replica: str) -> Optional[Any]:
    """:func:`bootstrap_kv` for a replica process: the coordinator client
    (None when no endpoint is set); when a configured coordinator never
    answers, print the ``frontdoor FAILED`` marker, leave a flight record
    under ``EDL_FLIGHTREC_DIR`` and re-raise, so the process exits 3."""
    try:
        return bootstrap_kv(env, disabled="address not published")
    except CoordBootstrapError as exc:
        # the exit-3 marker: harnesses gate on FAILED/ready lines,
        # and a down coordinator at pod start must fail INSIDE the
        # readiness budget, not hang past it
        print(f"frontdoor FAILED replica={replica} "
              f"(coordinator bootstrap: {exc})", flush=True)
        fdir = env.get("EDL_FLIGHTREC_DIR", "")
        if fdir:
            try:
                dump_flight_record(fdir, "frontdoor-coord-bootstrap",
                                   extra={"replica": replica,
                                          "error": str(exc)})
            except Exception:
                pass
        raise


def run_replica(door: FrontDoor, kv, env, *, replica: str,
                build_timeout_s: float,
                ready_fields: Callable[[], str] = lambda: "",
                on_exit: Optional[Callable[[], None]] = None,
                metrics_host: str = "0.0.0.0") -> int:
    """A replica process's life from its started ``door`` (a
    :class:`BatchApp` behind it) to its exit code: ``/metrics`` on
    ``EDL_FD_METRICS_PORT`` (default 0, -1 disables), the
    ``EDL_TRACE_DIR`` sink and the ``EDL_FD_LAG_PROBE_MS`` probe; exit 3
    without the ready marker when the build fails or outlasts
    ``build_timeout_s``; else a ``frontdoor ready port=... replica=...
    metrics_port=...`` line (``ready_fields()`` appended), then on
    SIGTERM/SIGINT a graceful drain: publish ``draining`` so the LB
    routes away, wait up to 10 s for the queue, stop the door, call
    ``on_exit``, and return 0.  The kv client is closed either way."""
    import signal

    app = door.app
    flight_dir = env.get("EDL_FLIGHTREC_DIR", "")
    trace_dir = env.get("EDL_TRACE_DIR", "")
    sink = probe = metrics_srv = None
    if trace_dir:
        from edl_tpu_torch.observability.tracing import TraceFileSink

        sink = TraceFileSink(
            trace_dir, f"fd-{replica.replace('/', '-')}-{os.getpid()}")
        sink.start()
    probe_ms = float(env.get("EDL_FD_LAG_PROBE_MS", "50"))
    if probe_ms > 0:
        probe = LoopLagProbe(
            door, "frontdoor", interval_s=probe_ms / 1e3,
            breach_s=float(env.get("EDL_FD_LAG_BREACH_MS", "250")) / 1e3,
            flight_dir=flight_dir,
            exemplars_fn=lambda: list(app.exemplars),
            on_sustained=lambda kind, lag: app.note_lag_breach()).start()
    metrics_port = int(env.get("EDL_FD_METRICS_PORT", "0"))
    if metrics_port >= 0:
        from edl_tpu_torch.observability.health import serve_health

        metrics_srv = serve_health(
            metrics_port, {"ready": lambda: app.state == FD_READY},
            host=metrics_host)
    ready = app.wait_ready(build_timeout_s)
    try:
        if not ready:
            # a failed/timed-out build must NOT print the ready marker the
            # harnesses gate on (they would drive traffic into a replica
            # that 503s everything) — fail the process loudly instead
            print(f"frontdoor FAILED replica={replica} "
                  f"(build failed or timed out; see log above)", flush=True)
            if flight_dir:
                try:
                    dump_flight_record(
                        flight_dir, "frontdoor-build-failed",
                        extra={"replica": replica,
                               "exemplars": list(app.exemplars)})
                except Exception:
                    pass
            door.stop()
            return 3
        extra = ready_fields()
        print(f"frontdoor ready port={door.port} replica={replica} "
              f"metrics_port="
              f"{metrics_srv.server_address[1] if metrics_srv else -1}"
              + (f" {extra}" if extra else ""), flush=True)
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
            # graceful: publish draining, let the LB route away, drain the
            # queue, then stop — zero dropped requests on this path
            app._set_state(FD_DRAINING)
            deadline = time.monotonic() + 10
            while app._queued_rows > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            door.stop()
            if on_exit is not None:
                on_exit()
        return 0
    finally:
        if probe is not None:
            probe.stop()
        if sink is not None:
            sink.stop()  # final dump: the ring as of shutdown
        if metrics_srv is not None:
            metrics_srv.shutdown()
        if kv is not None:
            try:
                kv.close()
            except Exception:
                pass


if __name__ == "__main__":  # pragma: no cover - process entrypoint
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="one data-plane replica from the EDL_FD_* env")
    parser.add_argument("--device", default="cuda")
    sys.exit(replica_main(device=parser.parse_args().device))
