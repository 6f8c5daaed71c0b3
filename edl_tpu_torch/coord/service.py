"""Pure-Python coordination service + the canonical interface definition —
the port's own copy of edl_tpu.coord.service (pure Python; only the metrics
registry it registers on is the port's).

The same semantics run in the port's C++ core
(:mod:`edl_tpu_torch.coord.bindings`, and the server a
:class:`~edl_tpu_torch.coord.client.CoordClient` talks to); this backend is
the spec and the fallback where no C++ toolchain exists.  The task-lease
behavior mirrors the reference master:
leased-but-unfinished tasks are re-dispatched after a timeout (16 s,
reference docker/paddle_k8s:30) so a dead trainer's work flows to the living.
"""

from __future__ import annotations

import enum
import functools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_TASK_TIMEOUT_MS = 16_000  # reference docker/paddle_k8s:30
DEFAULT_MAX_TASK_FAILURES = 3
DEFAULT_MEMBER_TTL_MS = 15_000
#: how stale the replication lease may go before a primary re-verifies
#: its claim against the standbys (doc/coordinator_ha.md)
DEFAULT_REPL_LEASE_S = 3.0
#: op-log records retained for delta replication; a replica further
#: behind than this gets a compaction checkpoint (native kOpLogCap twin)
OPLOG_CAP = 8192
#: per-verb latency buckets, matched to the native server's
#: kVerbBucketsS so edl_coord_verb_seconds merges across backends
VERB_SECONDS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                        0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _hx(b: bytes) -> str:
    """Binary field framing shared by snapshots and delta records: empty
    frames as "-" (a bare trailing space would be dropped by the stream
    parser)."""
    return b.hex() if b else "-"


class CoordBehind(RuntimeError):
    """A version-gated follower read could not be served: this mirror's
    applied stream position is still below the client's read floor after
    the park budget.  The caller redirects to the primary."""


class CoordFenced(RuntimeError):
    """This node is not the fenced-in primary: it is a standby, or a
    deposed primary that discovered a newer fencing token.  Every verb —
    reads and long-polls included — raises this instead of serving state
    that may be stale; a multi-endpoint client treats it as the signal to
    fail over (see :class:`~edl_tpu_torch.coord.client.CoordClient`).

    ``fence`` carries the raiser's token when known: a primary whose
    replication exchange meets this exception deposes itself ONLY if
    that token beats its own — a stale rejector must not fence the
    rightful primary."""

    def __init__(self, msg: str, fence: Optional[int] = None) -> None:
        super().__init__(msg)
        self.fence = fence


class LeaseStatus(enum.Enum):
    OK = 0
    EMPTY = 1  # nothing leasable right now, but work is in flight
    DONE = 2  # every task of every pass is complete


@dataclass(frozen=True)
class QueueStats:
    todo: int
    leased: int
    done: int
    dropped: int
    current_pass: int


@dataclass
class _Task:
    id: int
    payload: bytes
    failures: int = 0


@dataclass
class _Leased:
    task: _Task
    worker: str
    deadline_ms: int


def _now_ms() -> int:
    return time.monotonic_ns() // 1_000_000


class PyCoordService:
    """One job's coordination state: queue + membership + kv.

    HA surface (the Python twin of the native server's primary/standby
    machinery — doc/coordinator_ha.md): construct with ``role="standby"``
    for a warm mirror, attach it to a primary with
    :meth:`add_replica`, and every acked mutation on the primary streams
    a versioned snapshot to it via :meth:`sync_from` (persist-before-ack
    collapses to apply-before-return in-process).  Fencing: a node whose
    ``role`` is not ``"primary"`` raises :class:`CoordFenced` from every
    verb — reads and long-polls included — and a deposed primary fences
    itself the moment a standby answers its stream or lease probe with a
    newer token."""

    def __init__(
        self,
        task_timeout_ms: int = DEFAULT_TASK_TIMEOUT_MS,
        passes: int = 1,
        member_ttl_ms: int = DEFAULT_MEMBER_TTL_MS,
        max_task_failures: int = DEFAULT_MAX_TASK_FAILURES,
        clock=_now_ms,
        role: str = "primary",
        repl_lease_s: float = DEFAULT_REPL_LEASE_S,
        repl_lease_strict: bool = False,
    ) -> None:
        self._lock = threading.RLock()
        #: wakes long-poll waiters (wait_epoch / kv_wait) the instant a
        #: mutation lands, instead of making every worker poll on a sleep
        self._cond = threading.Condition(self._lock)
        #: long-poll accounting (server_metrics): how many waits actually
        #: parked, and how many of those were woken by an event (vs timeout)
        self.longpolls_parked = 0
        self.longpolls_fired = 0
        #: bumped by the TCP layer per request line; stays 0 in-process
        self.requests_served = 0
        self._clock = clock
        # queue
        self._timeout_ms = task_timeout_ms
        self._total_passes = max(passes, 1)
        self._max_failures = max_task_failures
        self._pass = 0
        self._next_id = 0
        self._dropped = 0
        self._todo: deque[_Task] = deque()
        self._leased: dict[int, _Leased] = {}
        self._done: list[_Task] = []
        # membership
        self._ttl_ms = member_ttl_ms
        self._epoch = 0
        self._members: dict[str, tuple[str, int]] = {}  # name -> (addr, deadline)
        # kv
        self._kv: dict[str, bytes] = {}
        # HA control plane (see class docstring)
        self.role = role  # "primary" | "standby" | "fenced"
        self.fence = 0
        self._version = 0        # durable-version counter (native twin)
        self._version_base = 0   # re-anchors the stream position
        self._replicas: list = []
        self._repl_acked: dict[int, int] = {}  # id(replica) -> position
        self._last_repl_ok = time.monotonic()
        self._repl_lease_s = repl_lease_s
        #: partition policy: False (default) = AVAILABLE, a primary with
        #: no reachable standby keeps serving; True = CONSISTENT, it
        #: suspends (CoordFenced, recoverable) once the lease lapses
        #: without a successful exchange — see doc/coordinator_ha.md
        self._repl_lease_strict = repl_lease_strict
        self.fencing_rejects = 0
        self.repl_syncs = 0
        self.repl_errors = 0
        self.promotions = 0
        # log-structured delta replication (doc/coordinator_scale.md):
        # bounded op log of (stream position, framed record); _replicate
        # ships a mirror the records covering (its position, head] and
        # falls back to a compaction checkpoint whenever the log cannot
        # prove contiguity — deltas are a wire-bytes optimization, never
        # a correctness dependency
        self._oplog: deque[tuple[int, str]] = deque()
        self.repl_bytes = 0
        self.repl_deltas = 0
        self.repl_checkpoints = 0
        self.follower_reads = 0
        #: thread-local follower-read admission (see follower_read):
        #: while set, _check_serving admits read verbs on a non-primary
        #: and the TTL-sweep sites stay quiet (a mirror sees no
        #: heartbeats; sweeping would fabricate epoch bumps)
        self._follower_tls = threading.local()
        self._verb_hist = None  # set by register_metrics

    def member_ttl_ms(self) -> int:
        return self._ttl_ms

    # -- HA: fencing gate + replication stream ------------------------------

    def stream_version(self) -> int:
        """Replication stream position: monotonic along a failover chain
        (the process-local mutation counter re-anchored by snapshots)."""
        with self._lock:
            return self._version_base + self._version

    def _bump(self, record: Optional[str] = None) -> None:
        """A snapshot-visible field changed (native DurableVersion twin);
        caller holds the lock.  ``record`` is the framed op-log record
        replaying this exact mutation on a mirror — a bump WITHOUT one
        (restore paths) breaks log contiguity, so the log drops and the
        next stream to every behind replica is a compaction checkpoint."""
        self._version += 1
        if record is None:
            self._oplog.clear()
        else:
            self._oplog.append((self._version_base + self._version, record))
            while len(self._oplog) > OPLOG_CAP:
                self._oplog.popleft()

    def _in_follower_read(self) -> bool:
        return getattr(self._follower_tls, "active", False)

    @staticmethod
    def _timed(verb: str):
        """Per-verb latency observation (edl_coord_verb_seconds twin);
        near-zero cost until register_metrics arms the histogram."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapped(self, *args, **kwargs):
                hist = self._verb_hist
                if hist is None:
                    return fn(self, *args, **kwargs)
                t0 = time.perf_counter()
                try:
                    return fn(self, *args, **kwargs)
                finally:
                    hist.observe(time.perf_counter() - t0, verb=verb)
            return wrapped
        return deco

    def _check_serving(self) -> None:
        """Fencing gate, called (lock held) before serving any verb: a
        non-primary never answers, and a primary whose replication lease
        went stale re-verifies its claim first — so a GC-paused-then-
        resumed primary discovers its deposition BEFORE handing a client
        stale epoch/KV state."""
        if self._in_follower_read():
            # version-gated read: admissible from ANY role under the
            # fence+min-version token the caller presented (native READ
            # twin — the lease gate is skipped too; staleness is bounded
            # by the version gate, not the lease)
            return
        if self.role != "primary":
            self.fencing_rejects += 1
            raise CoordFenced(
                f"coordinator is {self.role} (fence {self.fence})",
                fence=self.fence)
        if (self._replicas
                and time.monotonic() - self._last_repl_ok
                > self._repl_lease_s):
            any_ok = False
            for replica in self._replicas:
                try:
                    replica.repl_heartbeat(self.fence)
                except CoordFenced as exc:
                    if not self._deposed_by(exc):
                        continue  # stale rejector, not a deposition
                    raise CoordFenced(
                        f"deposed: a standby holds a newer fence than "
                        f"{self.fence}") from None
                except Exception:
                    self.repl_errors += 1  # unreachable ≠ deposed
                else:
                    any_ok = True
                    self._last_repl_ok = time.monotonic()
            if not any_ok and self._repl_lease_strict:
                # CONSISTENT mode: suspend rather than risk acking on a
                # partitioned, possibly-deposed claim.  Recoverable — the
                # role is untouched, so serving resumes when a standby
                # answers a later probe.
                self.fencing_rejects += 1
                raise CoordFenced(
                    f"replication lease expired with no reachable "
                    f"standby (strict mode, fence {self.fence})",
                    fence=self.fence)

    def _self_fence(self) -> None:
        if self.role == "fenced":
            return
        self.role = "fenced"
        # wake every parked long-poll so it raises CoordFenced NOW
        self._cond.notify_all()

    def _deposed_by(self, exc: CoordFenced) -> bool:
        """A replica's fencing reject deposes us only when it carries a
        GENUINELY newer token — a stale/misconfigured rejector must not
        fence the rightful primary.  Self-fences and returns True when it
        does."""
        if exc.fence is not None and exc.fence <= self.fence:
            self.repl_errors += 1
            return False
        self._self_fence()
        return True

    def _delta_blob(self, from_v: int, to_v: int) -> Optional[str]:
        """The EDLDELTA1 blob covering ``(from_v, to_v]``, or None when
        the op log cannot prove contiguity (trimmed past ``from_v``, or
        a record-less bump dropped it) — the caller then ships a
        compaction checkpoint.  Caller holds the lock."""
        if from_v < 0 or from_v >= to_v or not self._oplog:
            return None
        if self._oplog[0][0] > from_v + 1 or self._oplog[-1][0] != to_v:
            return None
        lines = [f"EDLDELTA1 {from_v} {to_v}"]
        lines += [rec for pos, rec in self._oplog if pos > from_v]
        return "\n".join(lines) + "\n.\n"

    def _replicate(self) -> None:
        """Stream the current state to every replica (lock held; runs
        after the mutation, before the caller's return — the in-process
        equivalent of the native server's persist-then-replicate-then-ack
        pipeline) — as the op-log DELTA covering (replica position, head]
        when the log proves contiguity, else as a full compaction
        checkpoint (the full snapshot stream; also the fallback when a
        mirror rejects a delta as behind/torn).  An unreachable replica
        degrades, a replica holding a newer fence deposes us: the
        mutation stays applied locally but the caller sees
        :class:`CoordFenced` instead of an ack, exactly the
        at-least-once contract a retried client op expects."""
        if not self._replicas or self.role != "primary":
            return
        sv = self._version_base + self._version
        behind = [r for r in self._replicas
                  if self._repl_acked.get(id(r), -1) < sv]
        if not behind:
            return
        ckpt: Optional[str] = None  # built lazily: most rounds ship deltas
        any_ok = False
        for replica in behind:
            blob = self._delta_blob(self._repl_acked.get(id(replica), -1),
                                    sv)
            is_delta = blob is not None
            if blob is None:
                if ckpt is None:
                    ckpt = self.snapshot(include_members=True)
                blob = ckpt
            try:
                try:
                    replica.sync_from(self.fence, sv, blob)
                except ValueError:
                    if not is_delta:
                        raise
                    # reachable but couldn't apply the delta (behind /
                    # torn): fall back to a checkpoint NOW — leaving the
                    # mirror behind would be a silent redundancy hole
                    if ckpt is None:
                        ckpt = self.snapshot(include_members=True)
                    blob, is_delta = ckpt, False
                    replica.sync_from(self.fence, sv, blob)
                # per-replica position: one mirror missing a stream
                # (while another acked) still gets its catch-up later
                self._repl_acked[id(replica)] = sv
                any_ok = True
                self.repl_bytes += len(blob)
                if is_delta:
                    self.repl_deltas += 1
                else:
                    self.repl_checkpoints += 1
            except CoordFenced as exc:
                if not self._deposed_by(exc):
                    continue  # stale rejector, not a deposition
                raise CoordFenced(
                    f"deposed while replicating at fence {self.fence}"
                ) from None
            except Exception:
                self.repl_errors += 1
        if any_ok:
            self._last_repl_ok = time.monotonic()
            self.repl_syncs += 1
        elif self._repl_lease_strict:
            # strict mode: an op NO standby acked must not be acked to
            # the caller (applied locally but unacked — the at-least-once
            # retry lands once a mirror is back); role untouched, so this
            # is a recoverable suspension, not a deposition
            self.fencing_rejects += 1
            raise CoordFenced(
                f"no standby acked the stream (strict mode, fence "
                f"{self.fence})", fence=self.fence)

    def add_replica(self, replica) -> None:
        """Attach a warm standby and catch it up NOW: until its first
        stream a mirror holds nothing, and promoting it would forget
        every op acked since."""
        with self._lock:
            self._replicas.append(replica)
            self._repl_acked.pop(id(replica), None)
            if self.role == "primary":
                self._replicate()

    def sync_from(self, fence: int, version: int, blob: str) -> int:
        """Standby side of the stream: apply the primary's snapshot
        (EDLCOORD1 compaction checkpoint, clear-then-restore) or op-log
        delta (EDLDELTA1, applied only when contiguous with the position
        this mirror holds).  Rejects (with the newer token) a stream
        whose fence is stale — the split-brain door a deposed primary
        knocks on — and raises ValueError for a torn blob (position
        never ratchets) or a non-contiguous delta (the primary falls
        back to a checkpoint)."""
        with self._lock:
            if self.role == "primary":
                if fence == self.fence:
                    # dual-primary collision (racing promoters landed the
                    # same token on two nodes): equal tokens can never
                    # depose each other via the stale-rejector rule, so
                    # the RECEIVER yields — one deterministic survivor
                    self._self_fence()
                self.fencing_rejects += 1
                raise CoordFenced(
                    f"stale stream fence {fence} (ours {self.fence})",
                    fence=self.fence)
            if fence < self.fence:
                self.fencing_rejects += 1
                raise CoordFenced(
                    f"stale stream fence {fence} (ours {self.fence})",
                    fence=self.fence)
            if blob.startswith("EDLDELTA1 "):
                self._apply_delta(blob)  # raises ValueError: torn/behind
            elif not self._restore(blob, clear=True, with_members=True):
                # a torn blob must not ratchet the fence or advertise a
                # position this node does not hold (the native twin
                # answers ERR badblob); the primary counts a repl error
                self.repl_errors += 1
                raise ValueError("torn replication blob rejected")
            else:
                self._version_base = version - self._version
            self.fence = max(self.fence, fence)
            if self.role == "fenced":
                # a self-fenced ex-primary accepting a stream is provably
                # a mirror again: regain standby status (and real
                # redundancy for the pair)
                self.role = "standby"
            # the mirror's own op log is meaningless until promoted (its
            # positions were never streamed from); keep it empty so a
            # fresh primary starts from a checkpoint
            self._oplog.clear()
            self.repl_syncs += 1
            self._cond.notify_all()  # wake version-gated follower reads
            return self._version_base + self._version

    def _apply_delta(self, blob: str) -> None:
        """Apply an EDLDELTA1 op-log blob (lock held).  Contiguity and
        framing are validated BEFORE any record applies; an unreplayable
        record mid-blob (diverged mirror) zeroes this node's claimed
        position — promotion must prefer its peers until the checkpoint
        fallback lands."""
        if not blob.endswith("\n.\n"):
            self.repl_errors += 1
            raise ValueError("torn delta blob rejected")
        header, _, body = blob.partition("\n")
        parts = header.split(" ")
        try:
            from_v, to_v = int(parts[1]), int(parts[2])
        except (IndexError, ValueError):
            self.repl_errors += 1
            raise ValueError("torn delta blob rejected") from None
        if from_v >= to_v:
            self.repl_errors += 1
            raise ValueError("torn delta blob rejected")
        if self._version_base + self._version != from_v:
            raise ValueError(
                f"behind: delta starts at {from_v}, mirror holds "
                f"{self._version_base + self._version}")

        def unhex(tok: str) -> bytes:
            return b"" if tok in ("-", "") else bytes.fromhex(tok)

        now = self._clock()
        try:
            for line in body.splitlines():
                if not line or line == ".":
                    continue
                tag, _, rest = line.partition(" ")
                args = rest.split(" ") if rest else []
                if tag == "K":
                    self._kv[bytes.fromhex(args[0]).decode()] = \
                        unhex(args[1]) if len(args) > 1 else b""
                elif tag == "k":
                    self._kv.pop(bytes.fromhex(args[0]).decode(), None)
                elif tag == "J":
                    name = bytes.fromhex(args[0]).decode()
                    addr = (unhex(args[1]).decode()
                            if len(args) > 1 else "")
                    prev = self._members.get(name)
                    if prev is None or prev[0] != addr:
                        self._epoch += 1
                    self._members[name] = (addr, now + self._ttl_ms)
                elif tag == "L":
                    if self._members.pop(
                            bytes.fromhex(args[0]).decode(),
                            None) is not None:
                        self._epoch += 1
                elif tag == "X":
                    # expiry batch: N removals under ONE epoch bump
                    for hexname in args[0].split(","):
                        self._members.pop(bytes.fromhex(hexname).decode(),
                                          None)
                    self._epoch += 1
                elif tag == "A":
                    t = _Task(int(args[0]),
                              unhex(args[1]) if len(args) > 1 else b"")
                    self._todo.append(t)
                    self._next_id = max(self._next_id, t.id + 1)
                elif tag == "C":
                    self._replay_move(int(args[0]), done=True)
                elif tag == "F":
                    self._replay_move(int(args[0]), done=False)
                elif tag == "R":
                    self._maybe_advance_pass()
                # unknown tags: forward compatibility, skip
        except (IndexError, ValueError, KeyError):
            # a prefix may have applied: this mirror is dirty — stop
            # claiming the old position (native twin: ERR badblob after
            # zeroing) until the checkpoint fallback restores it
            self._version_base = -self._version
            self.repl_errors += 1
            raise ValueError("unreplayable delta record rejected") \
                from None
        self._version_base = to_v - self._version

    def _replay_move(self, task_id: int, done: bool) -> None:
        """Replay a task transition on the mirror: the mirror never
        tracks leases (snapshots serialize leased-as-todo), so C/F
        records move/mutate the task by id in todo."""
        for i, t in enumerate(self._todo):
            if t.id == task_id:
                if done:
                    del self._todo[i]
                    self._done.append(t)
                else:
                    t.failures += 1
                    if t.failures >= self._max_failures:
                        del self._todo[i]
                        self._dropped += 1
                return
        raise KeyError(f"task {task_id} not in mirror todo")

    def repl_heartbeat(self, fence: int) -> int:
        """Replication lease probe (primary → standby)."""
        with self._lock:
            if self.role == "primary":
                if fence == self.fence:
                    # dual-primary collision: the receiver yields (see
                    # sync_from) but still rejects this exchange
                    self._self_fence()
                self.fencing_rejects += 1
                raise CoordFenced(
                    f"stale lease fence {fence} (ours {self.fence})",
                    fence=self.fence)
            if fence < self.fence:
                self.fencing_rejects += 1
                raise CoordFenced(
                    f"stale lease fence {fence} (ours {self.fence})",
                    fence=self.fence)
            self.fence = max(self.fence, fence)
            return self.fence

    def promote(self, fence: int) -> int:
        """Become the primary under fencing token ``fence`` (must beat
        every token this node has seen).  Members mirrored from the old
        primary get a full TTL to re-heartbeat here, so a failover prunes
        nobody and bumps no epoch."""
        with self._lock:
            if self.role == "primary":
                if fence < self.fence:
                    raise CoordFenced(f"stale promote token {fence} "
                                      f"(fence {self.fence})")
                self.fence = max(self.fence, fence)
                return self.fence
            if fence <= self.fence:
                raise CoordFenced(f"stale promote token {fence} "
                                  f"(fence {self.fence})")
            self.fence = fence
            self.role = "primary"
            now = self._clock()
            self._members = {n: (a, now + self._ttl_ms)
                             for n, (a, _) in self._members.items()}
            self._last_repl_ok = time.monotonic()
            self.promotions += 1
            self._cond.notify_all()
            return self.fence

    # -- snapshot / restore (native-format parity) --------------------------

    def snapshot(self, include_members: bool = False) -> str:
        """The native snapshot format, byte-compatible with
        ``Service::Snapshot`` / ``SnapshotRepl`` (coord.cc) — one format,
        both backends, so cross-backend restores and the format tests in
        tests/test_coord_ha.py hold the two implementations together."""
        def hx(b: bytes) -> str:
            # empty binary fields frame as "-" (the wire convention): a
            # bare trailing space would be dropped by the stream parser
            return b.hex() if b else "-"

        with self._lock:
            out = ["EDLCOORD1",
                   f"Q {self._pass} {self._next_id} {self._dropped}"]
            pending = sorted(
                list(self._todo) + [l.task for l in self._leased.values()],
                key=lambda t: t.id)
            out += [f"T {t.id} {t.failures} {hx(t.payload)}"
                    for t in pending]
            out += [f"D {t.id} {t.failures} {hx(t.payload)}"
                    for t in self._done]
            out.append(f"E {self._epoch}")
            out += [f"K {k.encode().hex()} {hx(v)}"
                    for k, v in sorted(self._kv.items())]
            out.append(f"F {self.fence} "
                       f"{self._version_base + self._version}")
            if include_members:
                out += [f"M {n.encode().hex()} {hx(a.encode())}"
                        for n, (a, _) in sorted(self._members.items())]
            out.append(".\n")
            return "\n".join(out)

    def restore(self, blob: str) -> bool:
        """Disk-restore semantics (the native LoadFrom twin): queue, KV,
        epoch and fence come back; members re-Join when their heartbeats
        bounce."""
        with self._lock:
            return self._restore(blob, clear=False, with_members=False)

    def _restore(self, blob: str, clear: bool, with_members: bool) -> bool:
        if not blob.startswith("EDLCOORD1\n") or not blob.endswith("\n.\n"):
            return False  # torn blob must not wipe the last good mirror
        if clear:
            self._todo.clear()
            self._leased.clear()
            self._done.clear()
            self._pass = 0
            self._next_id = 0
            self._dropped = 0
            self._kv.clear()
            self._members.clear()
            self._bump()
        def unhex(tok: str) -> bytes:
            return b"" if tok in ("-", "") else bytes.fromhex(tok)

        now = self._clock()
        recorded = None
        for line in blob.splitlines()[1:]:
            if not line or line == ".":
                continue
            parts = line.split(" ")
            tag = parts[0]
            try:
                if tag == "Q":
                    self._pass, self._next_id, self._dropped = (
                        int(parts[1]), int(parts[2]), int(parts[3]))
                elif tag in ("T", "D"):
                    t = _Task(int(parts[1]),
                              unhex(parts[3]) if len(parts) > 3 else b"",
                              failures=int(parts[2]))
                    (self._todo.append(t) if tag == "T"
                     else self._done.append(t))
                elif tag == "E":
                    self._epoch = max(self._epoch, int(parts[1]))
                elif tag == "K":
                    self._kv[bytes.fromhex(parts[1]).decode()] = \
                        unhex(parts[2]) if len(parts) > 2 else b""
                elif tag == "F":
                    if int(parts[1]) > self.fence:
                        self.fence = int(parts[1])
                    recorded = int(parts[2])
                elif tag == "M" and with_members:
                    self._members[bytes.fromhex(parts[1]).decode()] = (
                        unhex(parts[2]).decode()
                        if len(parts) > 2 else "",
                        now + self._ttl_ms)
                # unknown tags: forward compatibility, skip
            except (IndexError, ValueError):
                continue  # one malformed line must not kill the restore
        self._bump()
        if recorded is not None:
            self._version_base = recorded - self._version
        return True

    # -- task queue --------------------------------------------------------

    @_timed("ADD")
    def add_task(self, payload: bytes) -> int:
        with self._lock:
            self._check_serving()
            t = _Task(self._next_id, bytes(payload))
            self._next_id += 1
            self._todo.append(t)
            self._bump(f"A {t.id} {_hx(t.payload)}")
            self._replicate()
            return t.id

    @_timed("LEASE")
    def lease(self, worker: str) -> tuple[LeaseStatus, int, bytes]:
        now = self._clock()
        with self._lock:
            self._check_serving()
            self._redispatch_locked(now)
            self._maybe_advance_pass()
            if not self._todo:
                finished = not self._leased and self._pass + 1 >= self._total_passes
                status = LeaseStatus.DONE if finished else LeaseStatus.EMPTY
                self._replicate()  # a rollover can land inside a LEASE
                return (status, -1, b"")
            t = self._todo.popleft()
            self._leased[t.id] = _Leased(t, worker, now + self._timeout_ms)
            self._replicate()
            return (LeaseStatus.OK, t.id, t.payload)

    @_timed("COMPLETE")
    def complete(self, task_id: int, worker: Optional[str] = None) -> bool:
        """Mark a leased task done.  If ``worker`` is given, the completion
        is rejected unless that worker still holds the lease — so a timed-out
        straggler's late completion can't void a re-dispatched lease."""
        with self._lock:
            self._check_serving()
            leased = self._leased.get(task_id)
            if leased is None:
                return False  # late completion after re-dispatch
            if worker is not None and worker != "" and leased.worker != worker:
                return False  # lease moved to another worker
            del self._leased[task_id]
            self._done.append(leased.task)
            # pending→done is a snapshot-visible move
            self._bump(f"C {task_id}")
            self._maybe_advance_pass()
            self._replicate()
            return True

    @_timed("FAIL")
    def fail(self, task_id: int, worker: Optional[str] = None) -> bool:
        with self._lock:
            self._check_serving()
            leased = self._leased.get(task_id)
            if leased is None:
                return False
            if worker is not None and worker != "" and leased.worker != worker:
                return False
            del self._leased[task_id]
            t = leased.task
            t.failures += 1
            if t.failures >= self._max_failures:
                self._dropped += 1  # poison pill: drop, don't wedge the pass
            else:
                self._todo.append(t)
            # failure count / dropped counter changed
            self._bump(f"F {task_id}")
            self._maybe_advance_pass()
            self._replicate()
            return True

    def renew(self, task_id: int, worker: str) -> bool:
        """Extend a held lease's deadline (call while working a long shard
        so the 16 s re-dispatch clock measures *silence*, not shard size)."""
        now = self._clock()
        with self._lock:
            self._check_serving()
            leased = self._leased.get(task_id)
            if leased is None or (worker and leased.worker != worker):
                return False
            leased.deadline_ms = now + self._timeout_ms
            return True

    def redispatch(self) -> int:
        with self._lock:
            self._check_serving()
            return self._redispatch_locked(self._clock())

    def release_worker(self, worker: str) -> int:
        with self._lock:
            self._check_serving()
            mine = [tid for tid, l in self._leased.items() if l.worker == worker]
            for tid in mine:
                self._todo.append(self._leased.pop(tid).task)
            return len(mine)

    def all_done(self) -> bool:
        with self._lock:
            self._check_serving()
            return (not self._todo and not self._leased
                    and self._pass + 1 >= self._total_passes)

    def current_pass(self) -> int:
        with self._lock:
            self._check_serving()
            return self._pass

    @_timed("STATS")
    def stats(self) -> QueueStats:
        with self._lock:
            self._check_serving()
            return QueueStats(len(self._todo), len(self._leased),
                              len(self._done), self._dropped, self._pass)

    def _redispatch_locked(self, now: int) -> int:
        expired = [tid for tid, l in self._leased.items()
                   if l.deadline_ms <= now]
        for tid in expired:
            self._todo.append(self._leased.pop(tid).task)
        return len(expired)

    def _maybe_advance_pass(self) -> None:
        if self._todo or self._leased:
            return
        if self._pass + 1 < self._total_passes:
            if self._done:
                for t in self._done:
                    t.failures = 0
                    self._todo.append(t)
                self._done.clear()
                self._pass += 1
            else:
                # Nothing survives to recycle (zero tasks, or every task
                # dropped as a poison pill): later passes would be empty
                # too — finish now instead of livelocking on EMPTY.
                self._pass = self._total_passes - 1
            # reached from lease() too: a rollover must stream/persist
            # even though LEASE itself is not a mutating command
            self._bump("R")

    # -- membership --------------------------------------------------------

    @_timed("JOIN")
    def join(self, name: str, address: str = "") -> int:
        now = self._clock()
        with self._lock:
            self._check_serving()
            prev = self._members.get(name)
            change = prev is None or prev[0] != address
            self._members[name] = (address, now + self._ttl_ms)
            if change:
                self._epoch += 1
                self._bump(f"J {name.encode().hex()} "
                           f"{_hx(address.encode())}")
                self._cond.notify_all()
            self._replicate()
            return self._epoch

    @_timed("HB")
    def heartbeat(self, name: str) -> bool:
        now = self._clock()
        with self._lock:
            self._check_serving()
            if name not in self._members:
                return False
            addr, _ = self._members[name]
            self._members[name] = (addr, now + self._ttl_ms)
            return True

    @_timed("LEAVE")
    def leave(self, name: str) -> bool:
        with self._lock:
            self._check_serving()
            if self._members.pop(name, None) is None:
                return False
            self._epoch += 1
            self._bump(f"L {name.encode().hex()}")
            self._cond.notify_all()
            self._replicate()
            return True

    def expire_members(self) -> int:
        now = self._clock()
        with self._lock:
            self._check_serving()
            dead = [n for n, (_, dl) in self._members.items() if dl <= now]
            for n in dead:
                del self._members[n]
            if dead:
                self._epoch += 1
                # one batch record, one epoch bump on the mirror too
                self._bump("X " + ",".join(n.encode().hex()
                                           for n in dead))
                self._cond.notify_all()
            self._replicate()
            return len(dead)

    def epoch(self) -> int:
        with self._lock:
            self._check_serving()
            return self._epoch

    # -- long-poll waits ---------------------------------------------------
    #
    # The event-driven replacement for the fixed-sleep polling loops every
    # worker used to run against membership and KV (discovery.wait_stable,
    # the multihost rendezvous, wait_state): a waiter parks on the service's
    # condition variable and is woken the moment a mutation lands, instead
    # of hammering members()/kv_get() on a 20 Hz sleep.  The short internal
    # re-check cadence exists only for TTL expiry, which no command
    # announces.  Timeouts are real-time (the contract callers hold),
    # independent of the injectable lease/TTL clock.

    #: internal re-check cadence while parked — bounds TTL-expiry
    #: detection latency only; actual mutations wake waiters instantly
    WAIT_RECHECK_S = 0.05

    @_timed("WAITEPOCH")
    def wait_epoch(self, known_epoch: int, timeout_s: float) -> int:
        """Block until the membership epoch differs from ``known_epoch``
        or ``timeout_s`` elapses; returns the current epoch either way."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        parked = False
        with self._cond:
            while True:
                # a wait that outlives this node's primacy must not hand
                # the waiter a stale epoch (_self_fence notifies the cond)
                self._check_serving()
                if not self._in_follower_read():
                    # TTL truth, like MEMBERS' sweep; a follower read
                    # never sweeps (its mirror sees no heartbeats)
                    self.expire_members()
                if self._epoch != known_epoch:
                    if parked:
                        self.longpolls_fired += 1
                    return self._epoch
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._epoch
                if not parked:
                    parked = True
                    self.longpolls_parked += 1
                self._cond.wait(min(remaining, self.WAIT_RECHECK_S))

    @_timed("KVWAIT")
    def kv_wait(self, key: str, timeout_s: float,
                known_epoch: Optional[int] = None
                ) -> tuple[Optional[bytes], Optional[int]]:
        """Block until ``key`` exists (→ ``(value, epoch)``), the epoch
        moves off ``known_epoch`` when one is given (→ ``(None, epoch)``),
        or the timeout lapses (→ ``(None, current_epoch)``)."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        parked = False
        with self._cond:
            while True:
                self._check_serving()  # see wait_epoch
                if not self._in_follower_read():
                    self.expire_members()
                v = self._kv.get(key)
                if v is not None:
                    if parked:
                        self.longpolls_fired += 1
                    return bytes(v), self._epoch
                if known_epoch is not None and self._epoch != known_epoch:
                    if parked:
                        self.longpolls_fired += 1
                    return None, self._epoch
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None, self._epoch
                if not parked:
                    parked = True
                    self.longpolls_parked += 1
                self._cond.wait(min(remaining, self.WAIT_RECHECK_S))

    @_timed("KVWAITNE")
    def kv_wait_changed(self, key: str, old: Optional[bytes],
                        timeout_s: float
                        ) -> tuple[bool, Optional[bytes]]:
        """Block until ``key``'s value differs from ``old`` (``None`` =
        currently absent, so appearance fires) or the timeout lapses.
        Returns ``(True, new_value)`` on a change, ``(True, None)`` when
        the key was deleted, ``(False, None)`` on timeout — the KVWAITNE
        twin the serving weight watcher long-polls on."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        parked = False
        with self._cond:
            while True:
                self._check_serving()
                if not self._in_follower_read():
                    self.expire_members()
                v = self._kv.get(key)
                if v is not None and (old is None or bytes(v) != old):
                    if parked:
                        self.longpolls_fired += 1
                    return True, bytes(v)
                if v is None and old is not None:
                    if parked:
                        self.longpolls_fired += 1
                    return True, None  # deleted counts as a change
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False, None
                if not parked:
                    parked = True
                    self.longpolls_parked += 1
                self._cond.wait(min(remaining, self.WAIT_RECHECK_S))

    # -- follower reads ------------------------------------------------------

    def follower_read(self, fence: int, min_version: int,
                      timeout_s: float = 2.0):
        """Version-gated read admission on a mirror (the native READ
        verb's in-process twin — doc/coordinator_scale.md): a context
        manager under which read verbs are served from ANY role, once
        this node has seen the caller's fencing regime (``fence``) and
        applied at least the caller's read floor (``min_version``, the
        stream position its last write acked at).  A stale mirror parks
        until its replication stream catches up (``sync_from`` notifies)
        and raises :class:`CoordBehind` past ``timeout_s`` — the caller
        then redirects to the primary.  Read-your-writes holds by
        construction; TTL sweeps stay off (a mirror sees no heartbeats).

        ::

            with standby.follower_read(fence, floor):
                value = standby.kv_get("goodput-curve/job")
        """
        svc = self

        class _Admission:
            def __enter__(self):
                with svc._cond:
                    if fence > svc.fence:
                        svc.fencing_rejects += 1
                        raise CoordFenced(
                            f"stale: mirror fence {svc.fence} has not "
                            f"seen regime {fence}", fence=svc.fence)
                    deadline = time.monotonic() + max(timeout_s, 0.0)
                    while (svc._version_base + svc._version
                           < min_version):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise CoordBehind(
                                f"mirror at "
                                f"{svc._version_base + svc._version} < "
                                f"read floor {min_version}")
                        svc._cond.wait(min(remaining,
                                           svc.WAIT_RECHECK_S))
                    svc.follower_reads += 1
                svc._follower_tls.active = True
                return svc

            def __exit__(self, *exc) -> None:
                svc._follower_tls.active = False

        return _Admission()

    @_timed("KEEPALIVE")
    def heartbeat_many(self, names) -> dict:
        """Coalesced heartbeat batch (the KEEPALIVE verb's twin): renew
        every named member in ONE request; returns name -> renewed.  A
        False entry means the member expired and must re-join — exactly
        the per-name ERR-rejoin contract, batched."""
        now = self._clock()
        with self._lock:
            self._check_serving()
            out = {}
            for name in names:
                entry = self._members.get(name)
                if entry is None:
                    out[name] = False
                else:
                    self._members[name] = (entry[0], now + self._ttl_ms)
                    out[name] = True
            return out

    def server_metrics(self) -> dict:
        """Op counters, shape-matched to CoordClient.server_metrics().
        ``snapshot_bytes`` is an O(store) serialization, recomputed at
        most once per 5 s (native METRICS twin) — a metrics poller must
        not hold the verb lock for a full-store walk every call."""
        with self._lock:
            now = time.monotonic()
            cached = getattr(self, "_snap_bytes_cache", None)
            if cached is None or now - cached[0] > 5.0:
                cached = (now, len(self.snapshot(include_members=True)))
                self._snap_bytes_cache = cached
            return {"requests_served": self.requests_served,
                    "longpolls_parked": self.longpolls_parked,
                    "longpolls_fired": self.longpolls_fired,
                    "repl_bytes": self.repl_bytes,
                    "repl_deltas": self.repl_deltas,
                    "repl_checkpoints": self.repl_checkpoints,
                    "snapshot_bytes": cached[1],
                    "follower_reads": self.follower_reads}

    def register_metrics(self, registry=None) -> None:
        """Expose this service's live state on a
        :class:`~edl_tpu_torch.observability.metrics.MetricsRegistry` (default:
        the process-wide one) as callback gauges, name-matched to the
        native server's ``/metrics`` exposition (edl_coord_*) — so a
        process hosting a PyCoordService serves the SAME series names a
        native coordinator pod would, and one scrape config (and one
        dashboard) covers both backends.  The monotonic tallies use
        ``counter_fn`` (rendered ``_total`` counters, exactly like the
        native server) since the service owns the authoritative
        values."""
        if registry is None:
            from edl_tpu_torch.observability.metrics import get_registry

            registry = get_registry()
        # Every callback reads private state under the lock instead of the
        # public verbs: those are fencing-gated, and a standby's /metrics
        # must keep answering (scraping a mirror is how an operator SEES
        # that it is a mirror) while its client surface refuses.
        registry.counter_fn("coord_requests",
                            lambda: self.requests_served,
                            help="protocol requests served")
        registry.counter_fn("coord_longpolls_parked",
                            lambda: self.longpolls_parked,
                            help="long-poll waits that actually parked")
        registry.counter_fn("coord_longpolls_fired",
                            lambda: self.longpolls_fired,
                            help="parked waits woken by an event")
        registry.gauge_fn("coord_membership_epoch",
                          lambda: self._epoch,
                          help="membership epoch")
        registry.gauge_fn("coord_members",
                          lambda: len(self._members),
                          help="live members")
        registry.gauge_fn("coord_pass", lambda: self._pass,
                          help="current task-queue pass")
        queue_len = {"todo": lambda: len(self._todo),
                     "leased": lambda: len(self._leased),
                     "done": lambda: len(self._done),
                     "dropped": lambda: self._dropped}
        for state, fn in queue_len.items():
            registry.gauge_fn(
                "coord_queue_tasks", fn,
                help="task queue depth by state", state=state)
        # HA plane, name-matched to the native /metrics exposition
        role_code = {"primary": 0, "standby": 1, "fenced": 2}
        registry.gauge_fn("coord_role",
                          lambda: role_code.get(self.role, 2),
                          help="0=primary 1=standby 2=fenced")
        registry.gauge_fn("coord_fence", lambda: self.fence,
                          help="fencing token (bumped by every promotion)")
        registry.gauge_fn("coord_stream_version", self.stream_version,
                          help="replication stream position")
        registry.counter_fn("coord_fencing_rejects",
                            lambda: self.fencing_rejects,
                            help="verbs rejected: not the fenced-in "
                                 "primary")
        registry.counter_fn("coord_repl_syncs", lambda: self.repl_syncs,
                            help="replication streams acked/applied")
        registry.counter_fn("coord_repl_errors", lambda: self.repl_errors,
                            help="replication exchanges that failed")
        registry.counter_fn("coord_promotions", lambda: self.promotions,
                            help="standby-to-primary promotions")
        # log-structured replication accounting + follower reads,
        # name-matched to the native /metrics exposition
        registry.counter_fn("coord_repl_bytes", lambda: self.repl_bytes,
                            help="replication wire bytes streamed "
                                 "(deltas + checkpoints)")
        registry.counter_fn("coord_repl_deltas",
                            lambda: self.repl_deltas,
                            help="replication exchanges shipped as "
                                 "op-log deltas")
        registry.counter_fn("coord_repl_checkpoints",
                            lambda: self.repl_checkpoints,
                            help="replication exchanges shipped as "
                                 "compaction checkpoints")
        registry.counter_fn("coord_follower_reads",
                            lambda: self.follower_reads,
                            help="version-gated follower reads served")
        # per-verb latency histogram (native edl_coord_verb_seconds
        # twin); observation stays a no-op until this arms it
        self._verb_hist = registry.histogram(
            "coord_verb_seconds", help="request latency by verb",
            buckets=VERB_SECONDS_BUCKETS)

    @_timed("MEMBERS")
    def members(self) -> tuple[int, list[tuple[str, str]]]:
        """(epoch, [(name, address)]) name-sorted — this order IS the rank
        assignment (replacing IP-sort ranks, reference k8s_tools.py:113-121)."""
        if not self._in_follower_read():
            self.expire_members()
        with self._lock:
            out = sorted((n, a) for n, (a, _) in self._members.items())
            return self._epoch, out

    # -- kv ----------------------------------------------------------------

    @_timed("KVSET")
    def kv_set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._check_serving()
            self._kv[key] = bytes(value)
            self._bump(f"K {key.encode().hex()} {_hx(value)}")
            self._cond.notify_all()
            self._replicate()

    @_timed("KVGET")
    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self._check_serving()
            return self._kv.get(key)

    @_timed("KVDEL")
    def kv_del(self, key: str) -> bool:
        with self._lock:
            self._check_serving()
            removed = self._kv.pop(key, None) is not None
            if removed:
                self._bump(f"k {key.encode().hex()}")
                self._cond.notify_all()
                self._replicate()
            return removed

    @_timed("KVCAS")
    def kv_cas(self, key: str, expect: bytes, value: bytes) -> bool:
        """Set iff current == expect (empty expect: must not exist) — the
        slot-claim primitive (role of etcd pserver slots)."""
        with self._lock:
            self._check_serving()
            cur = self._kv.get(key)
            if expect == b"":
                if cur is not None:
                    return False
            elif cur != expect:
                return False
            self._kv[key] = bytes(value)
            # a winning CAS replicates as a plain put: the mirror needs
            # the outcome, not the race
            self._bump(f"K {key.encode().hex()} {_hx(bytes(value))}")
            self._cond.notify_all()
            self._replicate()
            return True

    @_timed("KEYS")
    def kv_keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            self._check_serving()
            return sorted(k for k in self._kv if k.startswith(prefix))

    def close(self) -> None:  # interface parity with the native handle
        pass
