"""Peer discovery and rendezvous for worker pods — the port's copy of
edl_tpu.runtime.discovery.

TPU-native port of the reference's pod-discovery tool
(reference docker/k8s_tools.py:1-151) with the idiom upgrade called for in
SURVEY §7: **rank comes from the coordination service, not from sorting
pod IPs** (the reference's ``fetch_id`` = index of my IP in the sorted
Running-pod IP list, k8s_tools.py:113-121, breaks the moment a pod is
replaced with a lower IP — fine for its static non-FT path, wrong for an
elastic mesh).

Two discovery backends:

* :class:`CoordDiscovery` — membership via the coordination service
  (``edl_tpu_torch.coord``): join with a stable worker name, ranks are the
  sorted-by-name member index *within an epoch*.  Every join/leave bumps
  the epoch, which is exactly the signal the elastic runtime reshards on.
* :class:`PodDiscovery` — behavioral equivalents of the reference verbs
  (``wait_pods_running``, ``count_pods_by_phase``, ``fetch_addresses``,
  ``fetch_rank``) over any backend exposing ``list_pods()`` (the
  :class:`~edl_tpu_torch.cluster.fake.FakeCluster` contract; a live k8s backend
  lists pods by label selector the same way, k8s_tools.py:95-110).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

from edl_tpu_torch.cluster.base import PodPhase

#: Reference poll cadence (k8s_tools.py:70-78 sleeps 5 s between checks).
POLL_INTERVAL_S = 5.0


class DiscoveryTimeout(TimeoutError):
    pass


def wait_epoch_change(client, known_epoch: int, timeout_s: float,
                      poll_s: float = 0.05) -> int:
    """Block until the membership epoch differs from ``known_epoch`` or
    ``timeout_s`` elapses; returns the last observed epoch.

    The one place the reform-critical path waits on membership: backends
    with a long-poll surface (``wait_epoch`` — the coord service, client
    and native server all grew one) park event-driven and wake within
    microseconds of the join/leave/expiry that matters; duck-typed
    backends without it fall back to the old sleep-poll."""
    wait = getattr(client, "wait_epoch", None)
    if wait is not None:
        try:
            return wait(known_epoch, timeout_s)
        except Exception:
            pass  # degraded backend mid-call: fall back to polling below
    deadline = time.monotonic() + max(timeout_s, 0.0)
    epoch = client.epoch()
    while epoch == known_epoch and time.monotonic() < deadline:
        time.sleep(poll_s)
        epoch = client.epoch()
    return epoch


class CoordDiscovery:
    """Rendezvous through the coordination service's membership epochs."""

    def __init__(self, client, name: str, address: str = "") -> None:
        self._client = client
        self.name = name
        self.address = address
        self.member_id: Optional[int] = None
        self._beat_thread: Optional[threading.Thread] = None
        #: set by the keepalive when an eviction marker names this worker
        self.evicted = False

    def _eviction_marker(self) -> bool:
        """True when a peer wrote an eviction marker for this worker
        (multihost straggler eviction — see ElasticWorld.evict) OR an
        SDC quarantine marker (confirmed silent corruption — see
        edl_tpu_torch.runtime.sdc.quarantine_worker; same protocol, different
        verdict).  The keepalive consults this before an expiry-rejoin:
        without the check, the marked worker's beat thread would undo
        the eviction forever (leave → heartbeat False → rejoin →
        leave → ...)."""
        kv_get = getattr(self._client, "kv_get", None)
        if kv_get is None:
            return False
        try:
            return (kv_get(f"evict/{self.name}") is not None
                    or kv_get(f"sdc-quarantine/{self.name}") is not None)
        except Exception:
            return False  # coordinator unreachable ≠ evicted

    def join(self) -> int:
        """Register this worker; returns the membership epoch after join."""
        self.member_id = self._client.join(self.name, self.address)
        return self._client.epoch()

    def leave(self) -> None:
        # An expiry-rejoin RPC from the keepalive thread can still be in
        # flight when leave() is called; if it lands after our LEAVE the
        # departed worker re-registers as a phantom member until the TTL
        # prunes it (one spurious epoch bump for every peer).  Wait for the
        # beat thread to die and leave again — LEAVE on a non-member is a
        # harmless no-op, so the second call only matters when the race hit.
        t = self._beat_thread
        self._client.leave(self.name)
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
            self._client.leave(self.name)
        self.member_id = None

    def heartbeat(self) -> bool:
        return self._client.heartbeat(self.name)

    @contextlib.contextmanager
    def keepalive(self, interval_s: float | None = None):
        """Background heartbeat for the duration of a ``with`` block.

        The membership TTL assumes someone is heartbeating; a launcher
        that joins and then blocks in the user entrypoint for hours would
        otherwise expire and spuriously bump the epoch, which every peer
        reads as a scale-down.  The cadence defaults to TTL/3 read from
        the server (CONFIG op), so a short-TTL deployment beats faster
        automatically."""
        from edl_tpu_torch.coord.client import CoordError

        if interval_s is None:
            try:
                interval_s = max(self._client.member_ttl_ms() / 3000.0, 0.01)
            except (AttributeError, OSError, CoordError):
                interval_s = 5.0  # DEFAULT_MEMBER_TTL_MS / 3
        stop = threading.Event()

        # default to the coalesced KEEPALIVE verb when the backend grew
        # it (doc/coordinator_scale.md): the kubelet-spawned harnesses
        # ride the same batched path the bench uses — one request shape
        # per beat — instead of a bespoke per-member HB.  Duck-typed
        # backends without it keep the per-name heartbeat.
        hb_many = getattr(self._client, "heartbeat_many", None)

        def one_beat() -> bool:
            if hb_many is not None:
                return bool(hb_many([self.name]).get(self.name, False))
            return self._client.heartbeat(self.name)

        def beat():
            while not stop.wait(interval_s):
                try:
                    if not one_beat() and not stop.is_set():
                        # Expired (ERR rejoin): the server pruned us after
                        # a blip longer than the TTL — rejoin rather than
                        # staying out of membership forever.  The stop
                        # check keeps a late beat from re-registering a
                        # worker that is deliberately leaving.  UNLESS a
                        # peer evicted us (straggler vote): the marker
                        # overrules the rejoin, or the eviction would be
                        # undone every TTL forever.
                        if self._eviction_marker():
                            self.evicted = True
                            return  # stay out; stop beating entirely
                        self._client.join(self.name, self.address)
                except (OSError, CoordError):
                    pass  # coordinator briefly unreachable; retry next tick

        t = threading.Thread(target=beat, daemon=True,
                             name=f"keepalive-{self.name}")
        self._beat_thread = t
        t.start()
        try:
            yield self
        finally:
            stop.set()
            t.join(timeout=interval_s + 1.0)

    def epoch(self) -> int:
        return self._client.epoch()

    def peers(self) -> list[tuple[str, str]]:
        """(name, address) of every live member, sorted by name — the
        stable total order ranks are derived from."""
        _, members = self._client.members()
        return sorted(members)

    def rank_and_world(self) -> tuple[int, int]:
        """My rank = index of my name in the sorted live-member list.

        Stable under pod replacement (a rejoining worker keeps its name →
        keeps its slot) — unlike the reference's IP-sort rank
        (k8s_tools.py:113-121)."""
        peers = self.peers()
        names = [n for n, _ in peers]
        if self.name not in names:
            raise RuntimeError(
                f"worker {self.name!r} not in membership; call join() first")
        return names.index(self.name), len(peers)

    def wait_members(self, n: int, timeout_s: float = 300.0,
                     poll_s: float = 0.1) -> list[tuple[str, str]]:
        """Barrier until ≥ n members are live (role of wait_pods_running,
        k8s_tools.py:70-78 — ``≥`` not ``==`` because "pods may be
        scaled").  Event-driven: the member count only changes when the
        epoch moves, so the wait parks on that instead of re-listing on a
        sleep cadence."""
        deadline = time.monotonic() + timeout_s
        while True:
            epoch, members = self._client.members()
            if len(members) >= n:
                return sorted(members)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DiscoveryTimeout(
                    f"waited {timeout_s}s for {n} members, "
                    f"have {len(members)}")
            wait_epoch_change(self._client, epoch, remaining, poll_s=poll_s)


class BatchKeepalive:
    """Coalesced heartbeats for EVERY member slot a supervisor host owns
    (doc/coordinator_scale.md §multiplexing): one background thread, one
    KEEPALIVE request per beat for N names — instead of N keepalive
    threads each holding a socket and sending its own HB line.  This is
    the request-count collapse the coordinator scale bench measures.

    An expired name (reported back per-batch) is re-joined with its
    registered address, unless an eviction marker names it — the same
    rejoin/eviction contract as :meth:`CoordDiscovery.keepalive`, batched.
    Against a pre-scale-out server the client degrades to individual HBs
    transparently (same thread, same cadence)."""

    def __init__(self, client, interval_s: float | None = None) -> None:
        self._client = client
        self._names: dict[str, str] = {}  # name -> address (for rejoin)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if interval_s is None:
            from edl_tpu_torch.coord.client import CoordError

            try:
                interval_s = max(client.member_ttl_ms() / 3000.0, 0.01)
            except (AttributeError, OSError, CoordError):
                interval_s = 5.0
        self.interval_s = interval_s
        self.beats = 0

    def add(self, name: str, address: str = "") -> None:
        with self._lock:
            self._names[name] = address

    def remove(self, name: str) -> None:
        with self._lock:
            self._names.pop(name, None)

    def _evicted(self, name: str) -> bool:
        kv_get = getattr(self._client, "kv_get", None)
        if kv_get is None:
            return False
        try:
            # eviction (straggler vote) and SDC quarantine (confirmed
            # corruption) share the decline-the-rejoin contract
            return (kv_get(f"evict/{name}") is not None
                    or kv_get(f"sdc-quarantine/{name}") is not None)
        except Exception:
            return False  # coordinator unreachable ≠ evicted

    def beat_once(self) -> int:
        """One coalesced beat; returns how many names were renewed."""
        from edl_tpu_torch.coord.client import CoordError

        with self._lock:
            names = dict(self._names)
        if not names:
            return 0
        try:
            results = self._client.heartbeat_many(list(names))
        except (OSError, CoordError):
            return 0  # coordinator briefly unreachable; next beat rules
        renewed = 0
        for name, ok in results.items():
            if ok:
                renewed += 1
                continue
            # expired: rejoin under the eviction-marker rule
            if self._evicted(name):
                self.remove(name)
                continue
            try:
                self._client.join(name, names.get(name, ""))
            except (OSError, CoordError):
                pass
        self.beats += 1
        return renewed

    def start(self) -> "BatchKeepalive":
        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.beat_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="batch-keepalive")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)

    def __enter__(self) -> "BatchKeepalive":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class PodDiscovery:
    """Reference-verb equivalents over a pod-listing backend."""

    def __init__(self, lister, job_uid: str, role: str = "trainer",
                 poll_s: float = POLL_INTERVAL_S) -> None:
        self._lister = lister
        self._job_uid = job_uid
        self._role = role
        self._poll_s = poll_s

    def _pods(self):
        return self._lister.list_pods(job_uid=self._job_uid, role=self._role)

    def count_pods_by_phase(self, phase: PodPhase) -> int:
        """Reference k8s_tools.py:90-92 (Terminating counted via
        deletion_timestamp, k8s_tools.py:29-36)."""
        n = 0
        for p in self._pods():
            eff = PodPhase.TERMINATING if p.deletion_timestamp else p.phase
            n += eff == phase
        return n

    def wait_pods_running(self, n: int, timeout_s: float = 600.0) -> int:
        """Poll until ≥ n pods Running (k8s_tools.py:70-78)."""
        deadline = time.monotonic() + timeout_s
        while True:
            running = self.count_pods_by_phase(PodPhase.RUNNING)
            if running >= n:
                return running
            if time.monotonic() >= deadline:
                raise DiscoveryTimeout(
                    f"waited {timeout_s}s for {n} running pods, have {running}")
            time.sleep(self._poll_s)

    def snapshot_running(self) -> list[tuple[str, str]]:
        """ONE consistent view of the live peer set: sorted (name, addr)
        for pods that are Running and not Terminating.  The barrier, the
        rank, and the peer addresses must all derive from the same
        snapshot with the same filter, or a pod deleted during startup
        makes EDL_TRAINERS disagree with EDL_TRAINER_ADDRESSES and ranks
        collide across peers.  addr = pod IP when the backend provides
        one (the reference's fetch_ips, k8s_tools.py:95-110), else the
        pod name (in-process fakes)."""
        return sorted(
            (p.name, getattr(p, "ip", "") or p.name)
            for p in self._pods()
            if p.phase == PodPhase.RUNNING and not p.deletion_timestamp)

    def fetch_addresses(self) -> list[str]:
        """Sorted Running-pod addresses (k8s_tools.py:95-110)."""
        return [addr for _name, addr in self.snapshot_running()]

    def fetch_rank(self, my_name: str) -> int:
        """Reference fetch_id semantics (k8s_tools.py:113-121) — kept for
        the static (non-fault-tolerant) path only; elastic jobs use
        :meth:`CoordDiscovery.rank_and_world`."""
        names = [n for n, _addr in self.snapshot_running()]
        try:
            return names.index(my_name)
        except ValueError:
            raise RuntimeError(f"{my_name!r} not among running pods {names}")
