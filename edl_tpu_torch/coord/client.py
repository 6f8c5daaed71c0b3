"""TCP client for the edl-coord-server (multi-process / multi-host path) —
the port's copy of edl_tpu.coord.client.

Speaks the newline protocol documented in native/server.cc; same method
surface as PyCoordService/NativeCoordService, so trainers are agnostic to
whether coordination is in-process or remote.  Its counters and trace
instants go to the port's collector and tracer.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import Callable, Optional

from edl_tpu_torch.coord.service import (
    DEFAULT_MEMBER_TTL_MS, DEFAULT_TASK_TIMEOUT_MS, LeaseStatus, QueueStats,
)
from edl_tpu_torch.observability.collector import get_counters


class CoordError(RuntimeError):
    pass


class CoordUnavailable(CoordError, OSError):
    """No coordination endpoint could serve the call within the deadline
    budget: every endpoint was down, fenced, or unreachable for the whole
    window.  Subclasses BOTH CoordError and OSError so every existing
    ``except (OSError, CoordError)`` outage handler keeps working while
    callers that care can catch the typed failure."""


class _Fenced(CoordError):
    """Internal: the active endpoint answered ``ERR fenced`` — it is a
    standby or a deposed primary.  Drives the failover path in
    :meth:`CoordClient._call_traced`; never escapes the client."""


#: Reconnect backoff envelope: first retry lands within ~50 ms (a blip —
#: e.g. one dropped connection — must not stall a step boundary), doubling
#: to a 2 s ceiling (a coordinator POD restart takes seconds; hammering it
#: with a fixed fast cadence from every trainer is a reconnect storm).
BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 2.0

#: Per-request park ceiling for long-poll waits (wait_epoch / kv_wait).
#: The client's request lock serializes every RPC on the one socket —
#: including the keepalive thread's heartbeats — so a single parked wait
#: must stay far inside the heartbeat cadence (member TTL / 3).  1 s keeps
#: the worst-case heartbeat delay harmless at every TTL this repo deploys
#: while still collapsing the old 20 Hz polling loops to ≤1 request/s of
#: idle re-parks (the park itself is event-driven server-side: an epoch
#: move or KV set wakes the request instantly).
LONGPOLL_CHUNK_S = 1.0


def backoff_delay(attempt: int, rng: random.Random,
                  base: float = BACKOFF_BASE_S,
                  cap: float = BACKOFF_CAP_S) -> float:
    """Full-jitter exponential backoff: uniform in (d/2, d] where
    d = min(cap, base·2^attempt).  Jitter de-synchronizes the trainer herd
    redialing a restarted coordinator (they all observed the same outage
    at the same step boundary)."""
    d = min(cap, base * (2 ** min(attempt, 16)))
    return rng.uniform(d / 2, d)


# -- endpoint probing / promotion (shared by CoordClient and CoordMux) ------

def _raw_exchange_ep(ep: tuple[str, int], line: str,
                     timeout: float) -> Optional[list[str]]:
    """One command over a dedicated short-timeout socket (never a riding
    connection); None when unreachable."""
    try:
        with socket.create_connection(ep, timeout=min(timeout, 2.0)) as s:
            s.settimeout(min(timeout, 2.0))
            s.sendall((line + "\n").encode())
            return s.makefile("rb").readline().decode().strip().split(" ")
    except OSError:
        return None


def _verb_unknown_reply(r: list[str]) -> bool:
    """True iff the reply is the server's unknown-command error — the
    only evidence that justifies a protocol-downgrade (an old server
    never grows the verb)."""
    return r[0] == "ERR" and len(r) > 1 and r[1] == "unknown"


def probe_role(ep: tuple[str, int], timeout: float
               ) -> Optional[tuple[str, int, int]]:
    """(role, fence, stream_version), or None when unreachable.
    A pre-HA server answers ROLE with ERR unknown — treated as a plain
    primary so mixed fleets degrade to the old behavior."""
    r = _raw_exchange_ep(ep, "ROLE", timeout)
    if r is None:
        return None
    if r[0] == "OK" and len(r) >= 4:
        try:
            return r[1], int(r[2]), int(r[3])
        except ValueError:
            return None
    if _verb_unknown_reply(r):
        return "primary", 0, -1  # pre-HA server
    return None


def send_promote(ep: tuple[str, int], fence: int, timeout: float) -> bool:
    r = _raw_exchange_ep(ep, f"PROMOTE {fence}", timeout)
    return r is not None and r[0] == "OK"


def select_failover_target(
        endpoints, timeout: float, allow_promote: bool
) -> tuple[Optional[tuple[str, int]], Optional[int],
           dict[tuple[str, int], tuple[str, int, int]]]:
    """Probe every endpoint's ROLE and pick a serving target: a live
    unfenced primary (highest fence wins if two claim it), else — when
    ``allow_promote`` — PROMOTE the standby holding the highest
    replicated stream position under a token beating every token seen.
    Returns ``(target, promoted_fence, roles)``; target None on total
    failure.  The one promotion policy both the plain client's failover
    and the mux's reconnect ride (doc/coordinator_ha.md)."""
    roles: dict[tuple[str, int], tuple[str, int, int]] = {}
    for ep in endpoints:
        info = probe_role(ep, timeout)
        if info is not None:
            roles[ep] = info
    primaries = [(fence, ep) for ep, (role, fence, _v) in roles.items()
                 if role == "primary"]
    if primaries:
        return max(primaries)[1], None, roles
    if allow_promote and roles:
        # fenced nodes are candidates too: a deposed ex-primary holds
        # the newest state any reachable node has (and one that was
        # re-attached as a mirror reports standby again) — excluding
        # it would strand the job on a promotable, current node.  A
        # SUSPENDED node (strict-mode primary with no standby link)
        # is deliberately NOT a candidate: promoting a mirror around
        # it is safe (strict acks nothing un-mirrored) and the
        # suspension ends in deposition when its link heals.
        standbys = [(v, fence, ep)
                    for ep, (role, fence, v) in roles.items()
                    if role in ("standby", "fenced")]
        if standbys:
            # promotion rule: the standby holding the LATEST durably
            # persisted stream position, under a token that beats
            # every fence any reachable node has seen
            _v, _f, ep = max(standbys)
            new_fence = max(f for (_r, f, _sv) in roles.values()) + 1
            if send_promote(ep, new_fence, timeout):
                return ep, new_fence, roles
    return None, None, roles


#: verbs whose OK ack carries a trailing "v<stream_version>" token from a
#: scale-out server — the client's read-your-writes floor for follower
#: reads.  The token is stripped before callers see the reply, so every
#: pre-existing parser keeps its pre-PR shape.
_VERSIONED_VERBS = frozenset({
    "ADD", "COMPLETE", "FAIL", "JOIN", "LEAVE", "KVSET", "KVDEL", "KVCAS",
})


class CoordClient:
    """``reconnect_window_s`` bounds how long a call rides out a
    coordinator restart: on a broken connection the client redials and
    retries until the window lapses.  Safe because every protocol command
    composes with at-least-once delivery — a request that executed but
    whose response was lost behaves like a lease that timed out (the
    durable server persists BEFORE acking, so an acked op is never lost,
    and an unacked op is retried or re-dispatched).

    Outage riding is **degraded mode**: retries back off exponentially
    with full jitter (see :func:`backoff_delay`) instead of hot-spinning a
    fixed cadence, and the optional hooks let the owning trainer observe
    the transition — ``on_degraded(attempt, elapsed_s)`` fires on every
    failed attempt inside an outage (pause at a step boundary, surface
    health, ...), ``on_recovered(outage_s)`` fires when a call finally
    succeeds again.  Hooks run on the calling thread, under the client's
    request lock — keep them cheap and non-reentrant (no coord calls).
    Hooks are process-local: they do not survive pickling (a deserialized
    client starts with both unset).

    **HA failover** (doc/coordinator_ha.md): pass ``endpoints`` — a list
    of ``"host:port"`` strings or ``(host, port)`` tuples covering the
    primary AND its standbys — and the retry loop becomes a failover
    loop.  On a connection break or an ``ERR fenced`` reply the client
    probes every endpoint's ROLE, re-targets a live primary if one
    exists, and otherwise (after ``promote_grace_s`` of outage, so a
    blip never deposes a healthy primary) PROMOTEs the standby holding
    the highest replicated stream position with a fencing token that
    beats every token seen.  In-flight long-polls simply re-park on the
    new primary (the chunked WAITEPOCH/KVWAIT re-issue rides the same
    retry path).  ``coord_failovers`` / ``coord_fencing_rejects`` land
    in the shared metrics registry.  When every endpoint stays down the
    call raises :class:`CoordUnavailable` once ``reconnect_window_s``
    (the per-call deadline budget) lapses — it never hangs forever."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 reconnect_window_s: float = 20.0,
                 endpoints=None, promote_grace_s: float = 0.5,
                 follower_reads: bool = False) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        self.reconnect_window_s = reconnect_window_s
        self.promote_grace_s = promote_grace_s
        eps: list[tuple[str, int]] = [(host, int(port))]
        for ep in endpoints or []:
            if isinstance(ep, str):
                h, _, p = ep.rpartition(":")
                ep = (h, p)
            ep = (ep[0], int(ep[1]))
            if ep not in eps:
                eps.append(ep)
        #: every coordination endpoint (active one first at construction);
        #: failover re-points host/port at whichever member is primary
        self.endpoints = eps
        self._lock = threading.Lock()
        self._rng = random.Random()
        #: set once a WAIT command comes back ERR (older server): every
        #: later wait falls back to sleep-polling instead of re-probing
        self._no_longpoll = False
        #: protocol downgrades discovered at runtime (older servers)
        self._no_batch_hb = False
        self._no_waitne = False
        self._no_follower = False
        #: read-your-writes floor: the highest stream position any of
        #: this client's write acks carried ("v<N>" trailing token);
        #: presented to version-gated follower reads
        self._min_version = 0
        #: highest fencing token observed (ROLE probes / failovers)
        self._fence_seen = 0
        #: opt-in follower-read routing (doc/coordinator_scale.md): read
        #: verbs go to a standby under a READ fence+min-version token,
        #: falling back to the primary on behind/stale/unsupported.
        #: Off by default: single-endpoint deployments and the pinned
        #: HA failover semantics (a read triggers promotion) keep
        #: their exact behavior unless the caller asks to spread reads.
        self.follower_reads = follower_reads and len(eps) > 1
        self._flock = threading.Lock()
        self._fsock: Optional[socket.socket] = None
        self._frfile = None
        self._follower_ep: Optional[tuple[str, int]] = None
        self._follower_down_until = 0.0
        self.on_degraded: Optional[Callable[[int, float], None]] = None
        self.on_recovered: Optional[Callable[[float], None]] = None
        # The FIRST dial also rides the window: clients are routinely
        # (un)pickled into fresh processes during the elastic dance, and a
        # world child spawned while the coordinator pod restarts must not
        # die on ConnectionRefused when a 2 s wait would have connected.
        # With an endpoint set, every member is PROBED CONCURRENTLY each
        # round, short-circuiting on the first live primary — so one
        # black-holed endpoint listed first costs ~one connect timeout,
        # not N x timeout serialized, and a child spawned mid-failover
        # connects to whoever answers.
        deadline = time.monotonic() + max(self.reconnect_window_s, 0.0)
        attempt = 0
        last_exc: Optional[OSError] = None
        while True:
            if len(self.endpoints) == 1:
                remaining = deadline - time.monotonic()
                try:
                    self._connect(connect_timeout=min(
                        self.timeout, max(remaining, 0.05)))
                    break
                except OSError as exc:
                    last_exc = exc
            elif self._dial_concurrent(deadline):
                break
            if time.monotonic() >= deadline:
                raise CoordUnavailable(
                    f"no coordination endpoint reachable within "
                    f"{self.reconnect_window_s}s "
                    f"(tried {self.endpoints}): {last_exc}") from last_exc
            time.sleep(backoff_delay(attempt, self._rng))
            attempt += 1
        # endpoint-set discovery: the supervisor publishes the full HA
        # set to the coord-endpoints KV key (runtime/multihost.py), so a
        # client constructed knowing ONE address learns the standbys it
        # will need when that address dies.  One short side-channel
        # exchange — never the riding connection, never the retry loop
        # (discovery must not promote anyone as a side effect); a fenced
        # or pre-HA server just leaves the set as configured.
        self._discover_endpoints()

    def _discover_endpoints(self) -> None:
        r = self._raw_exchange((self.host, self.port),
                               "KVGET coord-endpoints")
        if not r or r[0] != "OK" or len(r) < 2:
            return
        try:
            import json

            eps = json.loads(bytes.fromhex(r[1]).decode())
        except (ValueError, UnicodeDecodeError):
            return
        for ep_s in eps:
            if not isinstance(ep_s, str) or ":" not in ep_s:
                continue
            h, _, p = ep_s.rpartition(":")
            try:
                ep = (h, int(p))
            except ValueError:
                continue
            if ep not in self.endpoints:
                self.endpoints.append(ep)

    def _dial_concurrent(self, deadline: float) -> bool:
        """One concurrent probe round across the endpoint set: connect to
        every member in parallel, ROLE-probe on the fresh socket, and
        short-circuit on the first live primary (a pre-HA server's ERR
        unknown counts as primary).  Falls back to the first node that
        answered at all (a standby — the first verb's ERR fenced then
        drives the normal failover).  Worst-case construction latency is
        ~one connect timeout, not N x timeout serialized behind a
        black-holed endpoint."""
        import queue as _queue

        results: "_queue.Queue[tuple]" = _queue.Queue()
        remaining = deadline - time.monotonic()
        per_dial = min(self.timeout, max(remaining, 0.05))

        def probe(ep: tuple[str, int]) -> None:
            try:
                s = socket.create_connection(ep, timeout=per_dial)
            except OSError:
                results.put((ep, None, None, None))
                return
            try:
                s.settimeout(min(self.timeout, 2.0))
                rfile = s.makefile("rb")
                s.sendall(b"ROLE\n")
                r = rfile.readline().decode().strip().split(" ")
                if (r and r[0] == "OK" and len(r) >= 4) \
                        or _verb_unknown_reply(r):
                    role = r[1] if r[0] == "OK" else "primary"
                    fence = int(r[2]) if r[0] == "OK" else 0
                else:
                    role, fence = "unknown", 0
                results.put((ep, s, rfile, (role, fence)))
            except (OSError, ValueError, IndexError):
                try:
                    s.close()
                except OSError:
                    pass
                results.put((ep, None, None, None))

        for ep in self.endpoints:
            threading.Thread(target=probe, args=(ep,), daemon=True).start()
        winner = None  # (ep, sock, rfile)
        fallback = None
        pending = len(self.endpoints)
        probe_deadline = time.monotonic() + per_dial + 2.5
        while pending > 0 and winner is None:
            try:
                ep, s, rfile, info = results.get(
                    timeout=max(probe_deadline - time.monotonic(), 0.01))
            except _queue.Empty:
                break  # stragglers: their sockets close in the thread
            pending -= 1
            if s is None:
                continue
            role, fence = info
            self._fence_seen = max(self._fence_seen, fence)
            if role == "primary":
                winner = (ep, s, rfile)
            elif fallback is None:
                fallback = (ep, s, rfile)
            else:
                try:
                    s.close()
                except OSError:
                    pass
        chosen = winner or fallback
        if winner is not None and fallback is not None:
            try:
                fallback[1].close()
            except OSError:
                pass
        if pending > 0:
            # straggler probes may still connect after the winner: reap
            # their sockets off-thread so they never leak
            def reap(n: int) -> None:
                for _ in range(n):
                    try:
                        _ep, s2, _rf, _info = results.get(timeout=per_dial
                                                          + 5.0)
                    except _queue.Empty:
                        return
                    if s2 is not None:
                        try:
                            s2.close()
                        except OSError:
                            pass

            threading.Thread(target=reap, args=(pending,),
                             daemon=True).start()
        if chosen is None:
            return False
        ep, s, rfile = chosen
        self.host, self.port = ep
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._rfile = rfile
        return True

    def _connect(self, connect_timeout: Optional[float] = None) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port),
            timeout=self.timeout if connect_timeout is None
            else connect_timeout)
        self._sock.settimeout(self.timeout)  # operational I/O timeout
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")

    # Picklable by address: a deserialized client opens its own connection.
    # This is what lets the elastic supervisor hand a coord handle to its
    # per-world child processes (runtime.multihost) — sockets can't cross
    # a process boundary, addresses can.  The endpoint SET crosses too, so
    # a child spawned during a failover finds the promoted standby.
    def __getstate__(self) -> dict:
        return {"host": self.host, "port": self.port, "timeout": self.timeout,
                "reconnect_window_s": self.reconnect_window_s,
                "endpoints": list(self.endpoints),
                "promote_grace_s": self.promote_grace_s,
                "follower_reads": self.follower_reads}

    def __setstate__(self, state: dict) -> None:
        self.__init__(**state)

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass
        self._close_follower()

    def _close_follower(self) -> None:
        with self._flock:
            self._close_follower_locked()

    # -- follower reads ----------------------------------------------------

    def _read_call(self, *parts: str) -> list[str]:
        """Route a read verb to a follower when enabled (READ wrapper
        with this client's fence + read-your-writes floor), falling back
        to the primary on behind/stale/unsupported/unreachable — the
        reply grammar is the inner verb's either way."""
        if (self.follower_reads and not self._no_follower
                and time.monotonic() >= self._follower_down_until):
            r = self._follower_exchange(parts)
            if r is not None:
                get_counters().inc("coord_follower_reads",
                                   result="served")
                return r
            get_counters().inc("coord_follower_reads", result="fallback")
        return self._call(*parts)

    def _follower_exchange(self, parts: tuple) -> Optional[list[str]]:
        """One READ exchange over the persistent follower connection;
        None -> caller falls back to the primary."""
        line = (f"READ {self._fence_seen} {self._min_version} "
                + " ".join(parts) + "\n").encode()
        with self._flock:
            try:
                if self._fsock is None:
                    candidates = [ep for ep in self.endpoints
                                  if ep != (self.host, self.port)]
                    if not candidates:
                        return None
                    ep = candidates[self._rng.randrange(len(candidates))]
                    self._fsock = socket.create_connection(
                        ep, timeout=min(self.timeout, 2.0))
                    self._fsock.settimeout(self.timeout)
                    self._fsock.setsockopt(socket.IPPROTO_TCP,
                                           socket.TCP_NODELAY, 1)
                    self._frfile = self._fsock.makefile("rb")
                    self._follower_ep = ep
                self._fsock.sendall(line)
                resp = self._frfile.readline()
                if not resp:
                    raise OSError("follower closed the connection")
            except OSError:
                self._close_follower_locked()
                self._follower_down_until = time.monotonic() + 5.0
                return None
            r = resp.decode().strip().split(" ")
            if r[0] == "ERR":
                if self._verb_unknown(r):
                    # pre-scale-out server: never ask again
                    self._no_follower = True
                elif len(r) > 1 and r[1] in ("behind", "stale"):
                    # lagging/stale mirror: brief cooldown, primary serves
                    self._follower_down_until = time.monotonic() + 0.5
                else:
                    self._follower_down_until = time.monotonic() + 5.0
                return None
            return r

    def _close_follower_locked(self) -> None:
        if self._fsock is not None:
            try:
                self._frfile.close()
                self._fsock.close()
            except OSError:
                pass
            self._fsock = None
            self._frfile = None
            self._follower_ep = None

    def _call(self, *parts: str) -> list[str]:
        return self._call_traced(*parts)[0]

    def _call_traced(self, *parts: str) -> tuple[list[str], bool]:
        """Returns (response tokens, retransmitted) — ``retransmitted`` is
        True iff the request was re-sent after a connection break, i.e.
        the only window in which an executed-but-unacked duplicate is
        possible (kv_cas narrows its lost-ack inference to exactly this;
        an ``ERR fenced`` reply proves the op did NOT execute, so a
        fenced-then-failed-over retry does not widen the window).

        Raises :class:`CoordUnavailable` when the per-call deadline
        budget (``reconnect_window_s``) lapses with no endpoint serving —
        the typed bound that replaced the unbounded outage-riding loop."""
        line = (" ".join(parts) + "\n").encode()
        retransmitted = False
        # per-reform request load is a recorded fact, not a guess: every
        # logical RPC (retries excluded) counts once, so a bench can diff
        # the counter across a reform window
        get_counters().inc("coord_requests")
        with self._lock:
            t0 = time.monotonic()
            deadline = t0 + self.reconnect_window_s
            attempt = 0
            outage_since: Optional[float] = None
            while True:
                try:
                    self._sock.sendall(line)
                    resp = self._rfile.readline()
                    if not resp:
                        raise CoordError(
                            "coordination server closed the connection")
                    r = resp.decode().strip().split(" ")
                    if r[0] == "ERR" and len(r) > 1 and r[1] == "fenced":
                        # standby / deposed primary: the op did not run —
                        # fail over and re-send it at the real primary
                        get_counters().inc("coord_fencing_rejects")
                        raise _Fenced(" ".join(r))
                    r = self._absorb_version_token(parts[0], r)
                    if attempt:
                        self._note_recovered(time.monotonic() - t0)
                    return r, retransmitted
                except (OSError, CoordError) as exc:
                    now = time.monotonic()
                    if now >= deadline:
                        raise CoordUnavailable(
                            f"call {parts[0]} exhausted its "
                            f"{self.reconnect_window_s}s deadline budget "
                            f"across {self.endpoints}: {exc}") from exc
                    if not isinstance(exc, _Fenced):
                        retransmitted = True
                    if outage_since is None:
                        outage_since = now
                    self._note_degraded(attempt, now - t0)
                    time.sleep(backoff_delay(attempt, self._rng))
                    attempt += 1
                    # grace is anchored at the FIRST failure, not call
                    # start: a long-poll chunk can park healthy for up to
                    # a second before a blip, and that healthy time must
                    # not count toward deposing the primary
                    self._reconnect_failover(
                        allow_promote=time.monotonic() - outage_since
                        >= self.promote_grace_s)

    def _absorb_version_token(self, verb: str, r: list[str]) -> list[str]:
        """A scale-out server's mutating OK acks end in "v<position>" —
        the read-your-writes floor version-gated follower reads present.
        Record it and strip it, so every caller sees the pre-PR reply
        shape (and old servers, which never send it, parse identically)."""
        if (verb in _VERSIONED_VERBS and r and r[0] == "OK"
                and r[-1][:1] == "v" and r[-1][1:].isdigit()):
            self._min_version = max(self._min_version, int(r[-1][1:]))
            return r[:-1]
        return r

    # -- failover ----------------------------------------------------------

    def _reconnect_failover(self, allow_promote: bool) -> None:
        """Re-establish a connection to SOME serving endpoint.

        Single endpoint: plain redial (the pre-HA behavior).  Endpoint
        set: probe every member's ROLE; prefer a live unfenced primary
        (highest fence wins if two claim it — the older one will fence
        itself on its next replication exchange), else — once the outage
        outlasted ``promote_grace_s`` — promote the standby holding the
        highest replicated stream position with a token beating every
        token seen.  Best-effort: on total failure the caller's retry
        loop (budget-bounded) comes back here."""
        try:
            self.close()
        except OSError:
            pass
        if len(self.endpoints) == 1:
            try:
                self._connect()
            except OSError:
                pass  # still down; the caller's budget rules
            return
        target, promoted_fence, roles = select_failover_target(
            self.endpoints, self.timeout, allow_promote)
        for _role, fence, _v in roles.values():
            self._fence_seen = max(self._fence_seen, fence)
        if promoted_fence is not None:
            self._fence_seen = max(self._fence_seen, promoted_fence)
        if target is None:
            try:
                self._connect()
            except OSError:
                pass
            return
        prev = (self.host, self.port)
        self.host, self.port = target
        try:
            self._connect()
        except OSError:
            self.host, self.port = prev
            return
        if target != prev:
            # the follower connection may now point at the new primary:
            # drop it, the next read re-picks a mirror
            self._close_follower()
            from edl_tpu_torch.observability.tracing import get_tracer

            get_counters().inc("coord_failovers")
            get_tracer().instant(
                "coord_failover", category="chaos",
                from_endpoint=f"{prev[0]}:{prev[1]}",
                to_endpoint=f"{target[0]}:{target[1]}",
                promoted=promoted_fence is not None,
                fence=promoted_fence if promoted_fence is not None
                else roles[target][1])

    def _raw_exchange(self, ep: tuple[str, int],
                      line: str) -> Optional[list[str]]:
        """One command over a dedicated short-timeout socket (never the
        riding connection); None when unreachable."""
        return _raw_exchange_ep(ep, line, self.timeout)

    def _probe_role(self, ep: tuple[str, int]
                    ) -> Optional[tuple[str, int, int]]:
        return probe_role(ep, self.timeout)

    def _send_promote(self, ep: tuple[str, int], fence: int) -> bool:
        return send_promote(ep, fence, self.timeout)

    def _note_degraded(self, attempt: int, elapsed_s: float) -> None:
        """Record the outage once (trace + counter) and fire the hook on
        every failed attempt — the trainer's cue to hold at a step
        boundary instead of treating the outage as fatal."""
        if attempt == 0:
            from edl_tpu_torch.observability.collector import get_counters
            from edl_tpu_torch.observability.tracing import get_tracer

            get_tracer().instant("coord_degraded", category="chaos",
                                 host=self.host, port=self.port)
            get_counters().inc("coord_outages")
        if self.on_degraded is not None:
            self.on_degraded(attempt, elapsed_s)

    def _note_recovered(self, outage_s: float) -> None:
        from edl_tpu_torch.observability.collector import get_counters
        from edl_tpu_torch.observability.tracing import get_tracer

        get_tracer().instant("coord_reconnected", category="chaos",
                             host=self.host, port=self.port,
                             outage_s=round(outage_s, 3))
        get_counters().inc("coord_reconnects")
        if self.on_recovered is not None:
            self.on_recovered(outage_s)

    # -- task queue --------------------------------------------------------

    def add_task(self, payload: bytes) -> int:
        r = self._call("ADD", payload.hex() or "-")
        if r[0] != "OK":
            raise CoordError(" ".join(r))
        return int(r[1])

    def lease(self, worker: str) -> tuple[LeaseStatus, int, bytes]:
        r = self._call("LEASE", worker)
        if r[0] == "OK":
            payload = bytes.fromhex(r[2]) if len(r) > 2 else b""
            return (LeaseStatus.OK, int(r[1]), payload)
        if r[0] == "EMPTY":
            return (LeaseStatus.EMPTY, -1, b"")
        if r[0] == "DONE":
            return (LeaseStatus.DONE, -1, b"")
        raise CoordError(" ".join(r))

    def complete(self, task_id: int, worker: str | None = None) -> bool:
        args = ["COMPLETE", str(task_id)] + ([worker] if worker else [])
        return self._call(*args)[0] == "OK"

    def fail(self, task_id: int, worker: str | None = None) -> bool:
        args = ["FAIL", str(task_id)] + ([worker] if worker else [])
        return self._call(*args)[0] == "OK"

    def renew(self, task_id: int, worker: str = "") -> bool:
        args = ["RENEW", str(task_id)] + ([worker] if worker else [])
        return self._call(*args)[0] == "OK"

    def release_worker(self, worker: str) -> int:
        r = self._call("RELEASE", worker)
        return int(r[1]) if r[0] == "OK" else 0

    def stats(self) -> QueueStats:
        # NOT follower-routed: a mirror never tracks leases (leased
        # tasks stream as todo), so its QueueStats would report phantom
        # pending work — the primary is the only node whose lease view
        # is real
        r = self._call("STATS")
        if r[0] != "OK":
            raise CoordError(" ".join(r))
        return QueueStats(int(r[1]), int(r[2]), int(r[3]), int(r[4]), int(r[5]))

    def all_done(self) -> bool:
        s = self.stats()
        # DONE is only authoritative from LEASE; stats approximates it.
        return s.todo == 0 and s.leased == 0

    def current_pass(self) -> int:
        return self.stats().current_pass

    # -- membership --------------------------------------------------------

    def join(self, name: str, address: str = "") -> int:
        r = self._call("JOIN", name, address or "-")
        if r[0] != "OK":
            raise CoordError(" ".join(r))
        return int(r[1])

    def heartbeat(self, name: str) -> bool:
        return self._call("HB", name)[0] == "OK"

    def heartbeat_many(self, names) -> dict:
        """Coalesced heartbeat batch (KEEPALIVE): renew every named
        member slot in ONE request — the per-supervisor-host cadence
        that collapses N heartbeat lines to one.  Returns name ->
        renewed; False entries expired and must re-JOIN.  Names must be
        comma- and space-free (every member name the runtime writes is).  Degrades
        to individual HBs against a pre-scale-out server."""
        names = list(names)
        if not names:
            return {}
        if not self._no_batch_hb:
            r = self._call("KEEPALIVE", ",".join(names))
            if r[0] == "OK":
                expired = (set() if len(r) < 3 or r[2] == "-"
                           else set(r[2].split(",")))
                return {n: n not in expired for n in names}
            if self._verb_unknown(r):
                self._no_batch_hb = True  # genuinely old server
            else:
                raise CoordError(" ".join(r))
        return {n: self.heartbeat(n) for n in names}

    def leave(self, name: str) -> bool:
        return self._call("LEAVE", name)[0] == "OK"

    def epoch(self) -> int:
        return self.members()[0]

    def members(self) -> tuple[int, list[tuple[str, str]]]:
        r = self._read_call("MEMBERS")
        if r[0] != "OK":
            raise CoordError(" ".join(r))
        epoch = int(r[1])
        out: list[tuple[str, str]] = []
        if len(r) > 2 and r[2]:
            for item in r[2].split(","):
                if "=" in item:
                    name, addr = item.split("=", 1)
                    out.append((name, "" if addr == "-" else addr))
        return epoch, out

    # -- long-poll waits ---------------------------------------------------

    def wait_epoch(self, known_epoch: int, timeout_s: float) -> int:
        """Block until the membership epoch differs from ``known_epoch``
        or ``timeout_s`` elapses; returns the last observed epoch.

        Event-driven against servers with WAITEPOCH — the request parks
        server-side and an epoch move wakes it instantly; re-parks every
        :data:`LONGPOLL_CHUNK_S` so the shared request lock is never held
        long enough to starve the keepalive heartbeats.  Falls back to
        sleep-polling transparently against older servers."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        epoch = known_epoch
        while epoch == known_epoch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if self._no_longpoll:
                epoch = self.epoch()
                if epoch == known_epoch:
                    time.sleep(min(remaining, 0.05))
                continue
            chunk_ms = max(int(min(remaining, LONGPOLL_CHUNK_S) * 1000), 1)
            r = self._read_call("WAITEPOCH", str(known_epoch),
                                str(chunk_ms))
            # yield between re-parks: CPython locks are unfair, and a
            # tight release/re-acquire loop on the shared request lock
            # could starve the keepalive thread's heartbeat off this same
            # socket — 1 ms per 1 s chunk guarantees the handoff
            time.sleep(0.001)
            if r[0] == "OK":
                epoch = int(r[1])
            elif self._verb_unknown(r):
                self._no_longpoll = True  # genuinely old server
            else:
                # transient server error: one bad reply must not demote
                # this client to sleep-polling for its whole lifetime
                time.sleep(min(remaining, 0.05))
                epoch = self.epoch()
        get_counters().inc(
            "coord_longpolls", kind="epoch",
            result="fired" if epoch != known_epoch else "timeout")
        return epoch

    def kv_wait(self, key: str, timeout_s: float,
                known_epoch: Optional[int] = None
                ) -> tuple[Optional[bytes], Optional[int]]:
        """Block until ``key`` exists, the epoch moves off ``known_epoch``
        (when given), or the timeout lapses.  Returns ``(value, epoch)``
        where exactly one side is meaningful: ``value`` when the key
        fired, ``epoch`` when the epoch moved first, both None-ish on
        timeout (``epoch`` may still report the last observation)."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                get_counters().inc("coord_longpolls", kind="kv",
                                   result="timeout")
                return None, None
            if self._no_longpoll:
                v = self.kv_get(key)
                if v is not None:
                    break
                if known_epoch is not None:
                    e = self.epoch()
                    if e != known_epoch:
                        get_counters().inc("coord_longpolls", kind="kv",
                                           result="fired")
                        return None, e
                time.sleep(min(remaining, 0.05))
                continue
            chunk_ms = max(int(min(remaining, LONGPOLL_CHUNK_S) * 1000), 1)
            r = self._read_call("KVWAIT", key, str(chunk_ms),
                                str(known_epoch) if known_epoch is not None
                                else "-")
            time.sleep(0.001)  # unfair-lock yield (see wait_epoch)
            if r[0] == "OK":
                get_counters().inc("coord_longpolls", kind="kv",
                                   result="fired")
                return (bytes.fromhex(r[1]) if len(r) > 1 and r[1]
                        else b""), None
            if r[0] == "EPOCH":
                get_counters().inc("coord_longpolls", kind="kv",
                                   result="fired")
                return None, int(r[1])
            if r[0] != "NONE":
                if self._verb_unknown(r):
                    self._no_longpoll = True  # genuinely old server
                else:  # transient server error: retry, don't demote
                    time.sleep(min(remaining, 0.05))
        get_counters().inc("coord_longpolls", kind="kv", result="fired")
        return v, None

    def kv_wait_changed(self, key: str, old: Optional[bytes],
                        timeout_s: float
                        ) -> tuple[bool, Optional[bytes]]:
        """Block until ``key``'s value differs from ``old`` (``None`` =
        currently absent, so appearance fires; ``b""`` is a real empty
        value — wire token "=" — and parks like any other) or the
        timeout lapses.  Returns ``(True, new_value)`` on change,
        ``(True, None)`` when the key was deleted, ``(False, None)`` on
        timeout.  Event-driven against servers with KVWAITNE (the
        serving weight watcher's long-poll — doc/coordinator_scale.md);
        transparently sleep-polls against older servers."""
        old_tok = "-" if old is None else (old.hex() or "=")
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                get_counters().inc("coord_longpolls", kind="kvne",
                                   result="timeout")
                return False, None
            if self._no_waitne:
                v = self.kv_get(key)
                if (v is not None and (old is None or v != old)) \
                        or (v is None and old is not None):
                    get_counters().inc("coord_longpolls", kind="kvne",
                                       result="fired")
                    return True, v
                time.sleep(min(remaining, 0.5))
                continue
            chunk_ms = max(int(min(remaining, LONGPOLL_CHUNK_S) * 1000), 1)
            r = self._read_call("KVWAITNE", key, old_tok, str(chunk_ms))
            time.sleep(0.001)  # unfair-lock yield (see wait_epoch)
            if r[0] == "OK":
                get_counters().inc("coord_longpolls", kind="kvne",
                                   result="fired")
                return True, (bytes.fromhex(r[1])
                              if len(r) > 1 and r[1] else b"")
            if r[0] == "GONE":
                get_counters().inc("coord_longpolls", kind="kvne",
                                   result="fired")
                return True, None
            if r[0] != "NONE":
                if self._verb_unknown(r):
                    self._no_waitne = True  # genuinely old server
                else:  # transient server error: retry, don't demote
                    time.sleep(min(remaining, 0.05))

    #: the one protocol-downgrade predicate (module level, shared with
    #: the endpoint probes): an old server never grows the verb
    _verb_unknown = staticmethod(_verb_unknown_reply)

    def server_metrics(self) -> dict:
        """Server-side op counters (METRICS): requests served, long-polls
        parked/fired, and — from scale-out servers — the replication wire
        accounting (delta bytes vs the O(store) snapshot baseline) plus
        follower reads.  Empty dict from older servers; the extended
        fields appear only when the server sends them."""
        try:
            # NOT follower-routed: these counters are node-local by
            # definition — alternating between nodes as the follower
            # connection comes and goes would make every delta/rate
            # computed over them meaningless
            r = self._call("METRICS")
        except (OSError, CoordError):
            return {}
        if r[0] != "OK" or len(r) < 4:
            return {}
        out = {"requests_served": int(r[1]),
               "longpolls_parked": int(r[2]),
               "longpolls_fired": int(r[3])}
        extended = ("repl_bytes", "repl_deltas", "repl_checkpoints",
                    "snapshot_bytes", "follower_reads")
        for i, keyname in enumerate(extended, start=4):
            if len(r) > i:
                out[keyname] = int(r[i])
        return out

    # -- kv ----------------------------------------------------------------

    def kv_set(self, key: str, value: bytes) -> None:
        r = self._call("KVSET", key, value.hex() or "-")
        if r[0] != "OK":
            raise CoordError(" ".join(r))

    def kv_get(self, key: str) -> Optional[bytes]:
        r = self._read_call("KVGET", key)
        if r[0] == "NONE":
            return None
        return bytes.fromhex(r[1]) if len(r) > 1 else b""

    def kv_del(self, key: str) -> bool:
        return self._call("KVDEL", key)[0] == "OK"

    def kv_cas(self, key: str, expect: bytes, value: bytes) -> bool:
        """CAS with retry-safe claim semantics.

        CONTRACT: ``value`` must be claimant-unique — include the caller's
        name, endpoint or a timestamp/nonce, never a shared constant like
        ``b"done"`` (every call site in the runtime writes worker names,
        endpoints or timestamped markers).  Rationale: a CAS that executed
        but whose ack was lost (coordinator crash in the ack window)
        reports FAIL when the reconnect loop re-sends it — the key then
        holds our own value, and 'current value == ours' is 'we won' ONLY
        if no other claimant could have written the same bytes.  The
        inference is applied only when the request was actually
        retransmitted after a connection break, so a plain losing CAS on a
        healthy connection can never misreport victory even if a caller
        breaks the uniqueness contract."""
        exp = expect.hex() if expect else "-"
        r, retransmitted = self._call_traced("KVCAS", key, exp,
                                             value.hex() or "-")
        if r[0] == "OK":
            return True
        return retransmitted and self.kv_get(key) == value

    def kv_keys(self, prefix: str = "") -> list[str]:
        r = (self._read_call("KEYS", prefix) if prefix
             else self._read_call("KEYS"))
        if r[0] != "OK":
            raise CoordError(" ".join(r))
        return [k for k in (r[1].split(",") if len(r) > 1 and r[1] else [])]

    def ping(self) -> bool:
        try:
            return self._call("PING")[0] == "PONG"
        except (CoordError, OSError):
            return False

    def config(self) -> dict:
        """Server config: task_timeout_ms, passes, member_ttl_ms.

        Older servers without CONFIG get the defaults — callers use this
        to derive heartbeat cadence, where a default is safe."""
        r = self._call("CONFIG")
        if r[0] != "OK" or len(r) < 4:
            return {"task_timeout_ms": DEFAULT_TASK_TIMEOUT_MS,
                    "passes": 1, "member_ttl_ms": DEFAULT_MEMBER_TTL_MS}
        return {"task_timeout_ms": int(r[1]), "passes": int(r[2]),
                "member_ttl_ms": int(r[3])}

    def member_ttl_ms(self) -> int:
        return self.config()["member_ttl_ms"]


# ---------------------------------------------------------------------------
# Connection multiplexing (doc/coordinator_scale.md §multiplexing).
#
# One persistent connection per supervisor HOST carries interleaved framed
# requests for all of its member slots: each request goes out tagged
# "#<id> <verb...>" and the server answers "#<id> <reply...>" — park verbs
# run off-thread server-side, so a member slot's parked WAITEPOCH never
# head-of-line-blocks its siblings' heartbeats.  Against a pre-scale-out
# server the tag comes back verbatim missing — detected at connect by a
# tagged PING — and the mux degrades to one-request-at-a-time pipelining
# on the same socket (correct, just serialized).
# ---------------------------------------------------------------------------


class _MuxSlot:
    __slots__ = ("event", "resp")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.resp: Optional[list[str]] = None


class CoordMux:
    """Shared multiplexed transport for many :class:`MuxCoordClient`
    handles (one per member slot).  Owns the socket, the demux reader
    thread, and the failover/promotion state — the same semantics as a
    plain CoordClient's retry loop, paid ONCE per host instead of once
    per slot."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 reconnect_window_s: float = 20.0, endpoints=None,
                 promote_grace_s: float = 0.5) -> None:
        self.host = host
        self.port = int(port)
        self.timeout = timeout
        self.reconnect_window_s = reconnect_window_s
        self.promote_grace_s = promote_grace_s
        eps: list[tuple[str, int]] = [(host, int(port))]
        for ep in endpoints or []:
            if isinstance(ep, str):
                h, _, p = ep.rpartition(":")
                ep = (h, p)
            ep = (ep[0], int(ep[1]))
            if ep not in eps:
                eps.append(ep)
        self.endpoints = eps
        self._rng = random.Random()
        self._send_lock = threading.Lock()
        self._conn_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: dict[int, _MuxSlot] = {}
        self._next_id = 0
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._generation = 0  # bumped per (re)connect; reader exits on drift
        self._closed = False
        self._fence_seen = 0
        #: per-connection capability, probed with a tagged PING at
        #: connect: a pre-scale-out server parses "#<id>" as the command
        #: and answers an UNTAGGED "ERR unknown" — the mux then degrades
        #: to one-request-at-a-time pipelining on the same socket
        #: (correct, just serialized); re-probed after every reconnect
        self._tagged = True
        # first dial rides the budget exactly like a plain client's
        deadline = time.monotonic() + max(reconnect_window_s, 0.0)
        self._ensure_connected(deadline)

    # -- connection management ----------------------------------------------

    def _ensure_connected(self, deadline: float) -> None:
        """(Re)establish the multiplexed connection to a serving
        endpoint, probing ROLEs / promoting exactly like the plain
        client's failover loop.  Raises CoordUnavailable past the
        deadline."""
        with self._conn_lock:
            if self._sock is not None or self._closed:
                if self._closed:
                    raise CoordError("mux closed")
                return
            attempt = 0
            first_failure: Optional[float] = None
            while True:
                target = None
                if len(self.endpoints) == 1:
                    target = self.endpoints[0]
                else:
                    allow = (first_failure is not None
                             and time.monotonic() - first_failure
                             >= self.promote_grace_s)
                    target, promoted, roles = select_failover_target(
                        self.endpoints, self.timeout, allow)
                    for _r, fence, _v in roles.values():
                        self._fence_seen = max(self._fence_seen, fence)
                    if promoted is not None:
                        self._fence_seen = max(self._fence_seen, promoted)
                if target is not None:
                    try:
                        s = socket.create_connection(
                            target, timeout=min(
                                self.timeout,
                                max(deadline - time.monotonic(), 0.05)))
                        s.settimeout(self.timeout)
                        s.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                        rfile = s.makefile("rb")
                        # capability probe: does this server echo tags?
                        s.sendall(b"#0 PING\n")
                        first = rfile.readline()
                        if not first:
                            raise OSError("closed during mux probe")
                        self._tagged = first.startswith(b"#0 ")
                        self._sock = s
                        self._rfile = rfile
                        self.host, self.port = target
                        self._generation += 1
                        if self._tagged:
                            threading.Thread(
                                target=self._reader,
                                args=(self._generation, rfile),
                                daemon=True,
                                name=f"coord-mux-{self.host}:{self.port}",
                            ).start()
                        return
                    except OSError:
                        pass
                if first_failure is None:
                    first_failure = time.monotonic()
                if time.monotonic() >= deadline:
                    raise CoordUnavailable(
                        f"no coordination endpoint reachable within "
                        f"budget (tried {self.endpoints})")
                time.sleep(backoff_delay(attempt, self._rng))
                attempt += 1

    def _teardown_connection(self) -> None:
        with self._conn_lock:
            if self._sock is not None:
                try:
                    self._rfile.close()
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                self._rfile = None
        # fail every in-flight slot: each caller's request loop retries
        # through the reconnect path
        with self._state_lock:
            pending, self._pending = self._pending, {}
        for slot in pending.values():
            slot.event.set()

    def _reader(self, generation: int, rfile) -> None:
        """Demux loop: '#<id> <reply...>' lines wake their slot."""
        while True:
            try:
                line = rfile.readline()
            except (OSError, ValueError):
                line = b""
            if not line:
                break
            tokens = line.decode().strip().split(" ")
            if not tokens or not tokens[0].startswith("#"):
                continue  # stray untagged line: nothing owns it
            try:
                rid = int(tokens[0][1:])
            except ValueError:
                continue
            with self._state_lock:
                slot = self._pending.pop(rid, None)
            if slot is not None:
                slot.resp = tokens[1:]
                slot.event.set()
        # connection died (or was replaced): fail what this generation
        # still owes, unless a newer reader already took over
        with self._conn_lock:
            stale = generation != self._generation
        if not stale:
            self._teardown_connection()

    def close(self) -> None:
        self._closed = True
        self._teardown_connection()

    # -- request path --------------------------------------------------------

    def request(self, parts: tuple, budget_s: float,
                on_degraded=None,
                on_recovered=None) -> tuple[list[str], bool]:
        """One framed request/response with the plain client's retry +
        failover semantics — outage telemetry included (coord_outages /
        coord_reconnects counters + chaos trace instants, same as
        CoordClient._note_degraded/_note_recovered); returns
        (tokens, retransmitted)."""
        line_body = " ".join(parts)
        t0 = time.monotonic()
        deadline = t0 + max(budget_s, 0.0)
        retransmitted = False
        attempt = 0
        outage_since: Optional[float] = None
        while True:
            try:
                self._ensure_connected(deadline)
                if not self._tagged:
                    # pre-scale-out server: one request at a time on the
                    # shared socket (the plain-client shape, paid by every
                    # slot of this host — correct, just serialized)
                    with self._send_lock:
                        sock, rfile = self._sock, self._rfile
                        if sock is None:
                            raise CoordError("mux connection lost")
                        sock.sendall((line_body + "\n").encode())
                        resp = rfile.readline()
                    if not resp:
                        raise CoordError("mux connection closed")
                    r = resp.decode().strip().split(" ")
                    if r and r[0] == "ERR" and len(r) > 1 \
                            and r[1] == "fenced":
                        get_counters().inc("coord_fencing_rejects")
                        raise _Fenced(" ".join(r))
                    if attempt:
                        self._note_recovered(time.monotonic() - t0,
                                             on_recovered)
                    return r, retransmitted
                slot = _MuxSlot()
                with self._state_lock:
                    self._next_id += 1
                    rid = self._next_id
                    self._pending[rid] = slot
                with self._send_lock:
                    sock = self._sock
                    if sock is None:
                        raise CoordError("mux connection lost")
                    sock.sendall(f"#{rid} {line_body}\n".encode())
                # park verbs chunk client-side (LONGPOLL_CHUNK_S), so a
                # healthy reply lands within ~timeout; anything longer is
                # a dead connection
                if not slot.event.wait(timeout=min(
                        self.timeout + LONGPOLL_CHUNK_S + 1.0,
                        max(deadline - time.monotonic(), 0.05) + 1.0)):
                    with self._state_lock:
                        self._pending.pop(rid, None)
                    raise CoordError("mux request timed out")
                if slot.resp is None:
                    raise CoordError("mux connection broke mid-request")
                r = slot.resp
                if r and r[0] == "ERR" and len(r) > 1 and r[1] == "fenced":
                    get_counters().inc("coord_fencing_rejects")
                    raise _Fenced(" ".join(r))
                if attempt:
                    self._note_recovered(time.monotonic() - t0,
                                         on_recovered)
                return r, retransmitted
            except (OSError, CoordError) as exc:
                now = time.monotonic()
                if isinstance(exc, CoordUnavailable) or now >= deadline:
                    raise CoordUnavailable(
                        f"mux call {parts[0]} exhausted its deadline "
                        f"budget across {self.endpoints}: {exc}") from exc
                if not isinstance(exc, _Fenced):
                    retransmitted = True
                if outage_since is None:
                    outage_since = now
                self._note_degraded(attempt, now - t0, on_degraded)
                self._teardown_connection()
                time.sleep(backoff_delay(attempt, self._rng))
                attempt += 1

    def _note_degraded(self, attempt: int, elapsed_s: float,
                       hook) -> None:
        """Outage telemetry, parity with CoordClient._note_degraded."""
        if attempt == 0:
            from edl_tpu_torch.observability.tracing import get_tracer

            get_tracer().instant("coord_degraded", category="chaos",
                                 host=self.host, port=self.port)
            get_counters().inc("coord_outages")
        if hook is not None:
            hook(attempt, elapsed_s)

    def _note_recovered(self, outage_s: float, hook) -> None:
        from edl_tpu_torch.observability.tracing import get_tracer

        get_tracer().instant("coord_reconnected", category="chaos",
                             host=self.host, port=self.port,
                             outage_s=round(outage_s, 3))
        get_counters().inc("coord_reconnects")
        if hook is not None:
            hook(outage_s)

    def client(self, timeout: Optional[float] = None,
               reconnect_window_s: Optional[float] = None
               ) -> "MuxCoordClient":
        """A lightweight per-member-slot handle sharing this transport."""
        return MuxCoordClient(self, timeout=timeout,
                              reconnect_window_s=reconnect_window_s)


class MuxCoordClient(CoordClient):
    """CoordClient surface over a shared :class:`CoordMux` transport —
    the per-member-slot handle a multi-slot supervisor host hands each
    slot instead of a dedicated socket.  Pickles as a PLAIN CoordClient
    (sockets cannot cross processes; a child re-dials solo)."""

    # pylint: disable=super-init-not-called
    def __init__(self, mux: CoordMux, timeout: Optional[float] = None,
                 reconnect_window_s: Optional[float] = None) -> None:
        self._mux = mux
        self.timeout = mux.timeout if timeout is None else timeout
        self.reconnect_window_s = (mux.reconnect_window_s
                                   if reconnect_window_s is None
                                   else reconnect_window_s)
        self.promote_grace_s = mux.promote_grace_s
        self._lock = threading.Lock()
        self._rng = random.Random()
        self._no_longpoll = False
        self._no_batch_hb = False
        self._no_waitne = False
        self._no_follower = True  # reads ride the mux like everything else
        self._min_version = 0
        self.follower_reads = False
        self._flock = threading.Lock()
        self._fsock = None
        self._frfile = None
        self._follower_ep = None
        self._follower_down_until = 0.0
        self.on_degraded = None
        self.on_recovered = None

    # live view of the mux's current target (failover moves it)
    @property
    def host(self) -> str:  # type: ignore[override]
        return self._mux.host

    @property
    def port(self) -> int:  # type: ignore[override]
        return self._mux.port

    @property
    def endpoints(self) -> list[tuple[str, int]]:  # type: ignore[override]
        return self._mux.endpoints

    @property
    def _fence_seen(self) -> int:  # type: ignore[override]
        return self._mux._fence_seen

    @_fence_seen.setter
    def _fence_seen(self, v: int) -> None:
        self._mux._fence_seen = v

    def _call_traced(self, *parts: str) -> tuple[list[str], bool]:
        get_counters().inc("coord_requests")
        r, retransmitted = self._mux.request(
            parts, self.reconnect_window_s,
            on_degraded=self.on_degraded,
            on_recovered=self.on_recovered)
        return self._absorb_version_token(parts[0], r), retransmitted

    def close(self) -> None:
        pass  # the mux owns the socket; CoordMux.close() tears it down

    def __reduce__(self):
        # a pickled slot handle crosses the process boundary as a plain
        # standalone client — the child opens its own connection
        return (CoordClient, (self.host, self.port, self.timeout,
                              self.reconnect_window_s,
                              list(self.endpoints),
                              self.promote_grace_s))


def client_from_env(env, var: str = "EDL_COORD_ENDPOINT",
                    disabled: str = "coordinator features disabled"):
    """Optional :class:`CoordClient` from a ``host:port`` env var — the
    shared bootstrap for process entrypoints (serve_main, replica_main,
    lb_main) whose coordinator wiring is best-effort: returns ``None``
    quietly when the var is unset/blank, and warns + returns ``None``
    when it is set but the endpoint is unreachable (``disabled`` names
    what the caller degrades to)."""
    ep = env.get(var, "")
    if not ep or ":" not in ep:
        return None
    host, _, port = ep.rpartition(":")
    try:
        return CoordClient(host, int(port))
    except Exception as exc:
        print(f"warning: coordinator {ep} unreachable "
              f"({str(exc)[:80]}); {disabled}", flush=True)
        return None
