"""Elastic multi-process runtime: membership epochs → supervised
torch.distributed worlds — the port of edl_tpu.runtime.multihost.

A torch process group is **static**: its world size is fixed at
``init_process_group``.  Elasticity is therefore *epochs of static worlds*,
and each world runs in a **supervised child process**:

    supervisor (one per host, long-lived)          world child (one per epoch)
    ───────────────────────────────────────        ───────────────────────────
    joins membership, heartbeats                   never joins membership
    plans the world: stable snapshot →             init_process_group at the
      rank = index in name-sorted members,           epoch's rendezvous, then
      rank 0 claims the epoch's rendezvous           a barrier on its device
      (``init_method``) via KV CAS                 syncs state to the epoch's
    spawns the child with the plan                   published generation
    watches for SIGTERM → announces                trains ElasticTrainer steps,
      leave intent in KV                             leasing data shards from
    child exit 0 → read result, continue             the task queue, polling
    child died     → wait for the epoch              the epoch
      to prune the dead peer, re-plan              publishes the next state
                                                     generation, writes a
                                                     result file, exits 0

Why the child process is load-bearing: a peer SIGKILLed mid-collective
leaves its process group unusable — under gloo a survivor's collective
raises on the closed connection, under NCCL it blocks until the group's
timeout — and a group cannot shrink.  With the world quarantined in a
child, the failure ends one epoch's child (``WORLD_ABORTED``, or a SIGKILL
from the supervisor's stall watchdog for a wedged NCCL collective); the
supervisor, which never initialises CUDA, turns the death into a reform.
The reference's headline property follows: a dead trainer only loses its
leased-but-unfinished tasks, re-dispatched after the task timeout
(reference docker/paddle_k8s:30,119-141).

State flows through generation-tagged checkpoints (``ckpt/<epoch>`` KV
pointers to files on shared storage): every world starts by loading the
generation its leader published for the epoch, and ends by publishing the
next one (one CAS-elected writer saves; the rest block on the pointer).
A fresh joiner therefore can never cold-start into a world whose peers
carry trained state, and a world with no survivors restores the highest
generation ≤ its epoch.  Cold start is deterministic seeded init.

The device is a choice (``device``): ``cuda`` gives rank r
``cuda:(r mod device count)``, one card a rank over NCCL; ranks sharing one
card (``cuda:0``) run over gloo, which NCCL refuses; ``cpu`` is for the
tests, which run N CPU processes over gloo.  The JAX package's persistent
compilation cache has no counterpart: the port's eager step compiles
nothing per world (the CUDA kernels are built once per checkout).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import socket
import sys
import tempfile
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.runtime.discovery import CoordDiscovery, wait_epoch_change

log = get_logger("runtime.multihost")

#: KV namespaces (one coordination service per job).
#: the epoch's process-group rendezvous (``init_method``): rank 0 claims
#: ``tcp://host:port``, or ``file://<ckpt_dir>/store-<epoch>-<nonce>`` when
#: every member is on one host (the JAX package's ``jax-coordinator/``)
_TORCH_STORE_KEY = "torch-store/{epoch}"
_CKPT_KEY = "ckpt/{epoch}"
_CKPT_WRITER_KEY = "ckpt-writer/{epoch}"
#: formation barrier: each supervisor re-writes its marker (a fresh value
#: per planning attempt) when it arrives at an epoch's plan; a member
#: whose marker never changes across repeated formation failures is a
#: straggler (wedged supervisor whose keepalive thread still heartbeats)
_FORM_KEY = "form-arrive/{epoch}/{name}"
#: eviction markers: written ON BEHALF of a straggler; its keepalive
#: reads this and declines the expiry-rejoin that would otherwise undo
#: the eviction forever (CoordDiscovery.keepalive)
_EVICT_KEY = "evict/{name}"
#: mid-world generations: periodic in-world checkpoints so a crash loses
#: at most the cadence window, not everything back to the world's start
#: generation (role of the reference's pserver param residency — a dead
#: trainer there never lost global state, SURVEY §5.4)
_MID_CKPT_KEY = "ckpt-mid/{epoch}/{step}"
_LEAVE_KEY = "leave-intent/{epoch}"
#: reform-trace correlation: the supervisor publishes the root span's
#: (trace_id, span_id, spawn wall-time) here before spawning the epoch's
#: world child; the child parents its startup-phase spans to it, which is
#: what lets Tracer.merge_files show one reform as one span tree across
#: processes.  (EDL_TRACE_ID env covers cold spawns; the KV covers warm
#: pre-spawned children whose env predates the reform.)
_TRACE_KEY = "trace/{epoch}"
#: coordination-endpoint SET (JSON ["host:port", ...]) published by every
#: supervisor whose coord client is HA-aware: tooling and late joiners
#: discover the primary AND its standbys from whichever endpoint they
#: reached first, so a failover mid-join still lands (the endpoint set
#: rides the replication stream like any other KV)
_COORD_ENDPOINTS_KEY = "coord-endpoints"


def _gen_from_key(key: str) -> Optional[int]:
    """Epoch number from a per-generation KV key ('<prefix>/<n>'); the one
    parser latest_state and the GC share."""
    try:
        return int(key.rsplit("/", 1)[1])
    except (IndexError, ValueError):
        return None


def _mid_from_key(key: str) -> Optional[tuple[int, int]]:
    """(epoch, step) from a mid-world key ('ckpt-mid/<epoch>/<step>')."""
    parts = key.split("/")
    if len(parts) != 3:
        return None
    try:
        return int(parts[1]), int(parts[2])
    except ValueError:
        return None

#: Child exit code for "world aborted, reform": a collective that raised on
#: a dead peer's closed connection (gloo), a rendezvous that timed out; a
#: wedged child the stall watchdog SIGKILLs exits with a negative code.
WORLD_ABORTED = 3


class WorkerEvicted(RuntimeError):
    """This worker was evicted from the job (a peer wrote an eviction
    marker on its behalf after it repeatedly missed the epoch barrier).
    A recovered straggler raises this instead of rejoining a world that
    voted it out."""


class FormationTimeout(TimeoutError):
    """plan() exhausted its formation budget: membership never stabilized
    or the coordinator claim never resolved within the window."""


@dataclass(frozen=True)
class WorldPlan:
    """A planned (not yet initialized) world: the supervisor's output."""

    epoch: int
    rank: int
    world_size: int
    coordinator: str
    members: tuple[str, ...]


@dataclass(frozen=True)
class WorldHandle:
    """One live torch.distributed world (one membership epoch): the default
    process group, and the device this rank runs on."""

    epoch: int
    rank: int
    world_size: int
    coordinator: str
    members: tuple[str, ...]
    device: str = "cpu"

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _teardown_backend() -> None:
    """Best-effort process-group teardown (child exit hygiene)."""
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # a dead peer's group: exiting frees it anyway
        pass


def set_pdeathsig(sig: Optional[int] = None) -> None:
    """PR_SET_PDEATHSIG: have the kernel deliver ``sig`` (default SIGKILL)
    to THIS process when its parent dies.  Best-effort (glibc/Linux)."""
    import ctypes
    import signal

    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, sig or signal.SIGKILL)
    except OSError:  # pragma: no cover - non-glibc platform
        pass


def _die_with_parent(parent_pid: int) -> None:
    """Arrange for this (child) process to be SIGKILL'd when its supervisor
    dies, so a killed worker takes its world child down with it and the
    surviving peers' reform logic sees exactly one death."""
    set_pdeathsig()
    if os.getppid() != parent_pid:  # parent already gone before prctl landed
        os._exit(1)


def resolve_world_device(device: str, rank: int):
    """The torch device of ``rank`` for the ``--device`` choice: ``cuda``
    is ``cuda:(rank mod device count)``, one card a rank on one host;
    anything else (``cuda:0``, ``cpu``) names the device itself.  Called in
    the world child only: the supervisor never initialises CUDA."""
    import torch

    from edl_tpu_torch.device import resolve

    if device == "cuda":
        resolve("cuda")  # raises where there is no card
        return torch.device("cuda", rank % torch.cuda.device_count())
    return resolve(device)


def world_backend(device: str) -> str:
    """The process-group backend for the ``--device`` choice: NCCL when
    each rank has its own card (``cuda``), gloo when the ranks share one
    (``cuda:N``: NCCL refuses two ranks on one GPU) or run on the CPU."""
    return "nccl" if device == "cuda" else "gloo"


class ElasticWorld:
    """Membership, world planning, and the state-generation protocol.

    Used from two places: the supervisor (joins membership, plans worlds)
    and each world child (state generations + epoch polls — never joins)."""

    def __init__(
        self,
        coord,
        name: str,
        address: str = "127.0.0.1",
        settle_s: float = 0.5,
        poll_s: float = 0.05,
        store_dir: Optional[str] = None,
    ) -> None:
        self._coord = coord
        self.member = CoordDiscovery(coord, name, address)
        self.name = name
        self.address = address
        self._settle_s = settle_s
        self._poll_s = poll_s
        #: where a one-host world's file rendezvous lives (the job's
        #: shared checkpoint directory); None: always TCP
        self._store_dir = store_dir

    # -- membership --------------------------------------------------------

    def join(self) -> int:
        return self.member.join()

    def leave(self) -> None:
        self.member.leave()

    def epoch(self) -> int:
        return self.member.epoch()

    # -- graceful scale-down -----------------------------------------------
    #
    # A collective needs every process: if a leaver simply stopped stepping,
    # the survivors' next psum would block forever.  Because every step IS a
    # collective, all workers sit at the same global step — so the leaver's
    # supervisor announces intent via KV, every child (leaver's included)
    # stops at the same step boundary, and only then does the leaver drop
    # its membership.

    def announce_leave(self, epoch: int) -> None:
        self._coord.kv_set(_LEAVE_KEY.format(epoch=epoch), self.name.encode())

    def leave_announced(self, epoch: int) -> bool:
        return self._coord.kv_get(_LEAVE_KEY.format(epoch=epoch)) is not None

    def wait_epoch_past(self, epoch: int, timeout_s: float = 60.0) -> None:
        """Block until membership moves past ``epoch`` (a leaver deregisters
        or the TTL prunes a dead one).  Parks on the coordinator's
        long-poll instead of sleep-polling."""
        deadline = time.monotonic() + timeout_s
        while self._coord.epoch() == epoch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"membership stuck at epoch {epoch}")
            wait_epoch_change(self._coord, epoch, remaining,
                              poll_s=self._poll_s)

    def wait_stable(self, min_members: int = 1, timeout_s: float = 120.0
                    ) -> tuple[int, list[str]]:
        """Snapshot membership once it has ≥ min_members and hasn't changed
        for settle_s (a joining wave lands as ONE world, not several).

        Evicted members are filtered from the snapshot: a straggler voted
        out of the job must not re-enter anyone's world plan even if its
        keepalive raced it back into membership for a moment.  Raises
        :class:`WorkerEvicted` when THIS worker is the one voted out.
        """
        deadline = time.monotonic() + timeout_s
        last_epoch, stable_since = -1, time.monotonic()
        evicted: set[str] = set()
        while True:
            epoch, members = self._coord.members()
            if epoch != last_epoch or last_epoch == -1:
                # refresh the eviction set only when membership moved:
                # every eviction bumps the epoch (the leave written on
                # the victim's behalf), so scanning the prefix more often
                # would be coordinator load buying nothing
                evicted = self.evicted_names()
            if self.name in evicted:
                raise WorkerEvicted(
                    f"worker {self.name!r} was evicted from the job")
            names = sorted(n for n, _ in members if n not in evicted)
            now = time.monotonic()
            if epoch != last_epoch:
                last_epoch, stable_since = epoch, now
            elif (len(names) >= min_members
                  and now - stable_since >= self._settle_s
                  and self.name in names):
                return epoch, names
            if now >= deadline:
                raise FormationTimeout(
                    f"membership never stabilized at ≥{min_members} "
                    f"members within {timeout_s}s (have {names})")
            # Event-driven settle: park until the epoch moves (resets the
            # stability window) or the settle window closes — the wait
            # returns at exactly one of the two instants the loop needs
            # to re-evaluate, so a stable membership costs ~1 request per
            # settle window instead of a 20 Hz members() poll.
            settle_left = self._settle_s - (now - stable_since)
            park = min(deadline - now,
                       settle_left if settle_left > 0 else deadline - now)
            wait_epoch_change(self._coord, epoch, max(park, 0.001),
                              poll_s=self._poll_s)

    # -- world planning ----------------------------------------------------

    def plan(self, min_members: int = 1, timeout_s: float = 120.0,
             formation_budget_s: Optional[float] = None) -> WorldPlan:
        """Block until a stable world can form and return its plan — rank,
        size, and the coordinator endpoint rank 0 claimed for the epoch.
        No torch state is touched; the supervisor stays abort-proof.

        ``formation_budget_s`` (when set) overrides ``timeout_s`` as the
        total budget for this ONE formation attempt; on exhaustion
        :class:`FormationTimeout` is raised so the supervisor can count
        the miss against stragglers instead of dying or blocking forever.
        """
        budget = formation_budget_s if formation_budget_s is not None \
            else timeout_s
        deadline = time.monotonic() + budget
        while True:
            epoch, names = self.wait_stable(
                min_members, max(deadline - time.monotonic(), 0.01))
            rank = names.index(self.name)
            endpoint = self._claim_coordinator(epoch, rank,
                                               deadline - time.monotonic())
            if endpoint is None:  # epoch moved under us; re-snapshot
                if time.monotonic() >= deadline:
                    raise FormationTimeout(
                        f"coordinator claim for epoch {epoch} never "
                        f"resolved within {budget}s")
                continue
            return WorldPlan(epoch=epoch, rank=rank, world_size=len(names),
                             coordinator=endpoint, members=tuple(names))

    # -- formation barrier + straggler eviction ----------------------------
    #
    # A wedged supervisor is the quiet twin of a crashed one: its
    # keepalive thread still heartbeats, so membership never prunes it,
    # every plan includes it, and every world init times out against a
    # peer that will never arrive — the job stalls forever at full
    # liveness.  The formation barrier makes that visible: every
    # supervisor re-marks its arrival each time it plans, so a member
    # whose marker stays frozen across repeated formation failures is
    # provably not planning, and the lowest-ranked live supervisor
    # evicts it — a leave written on its behalf plus a durable eviction
    # marker its keepalive respects (CoordDiscovery declines the
    # expiry-rejoin when marked).

    def mark_formed(self, epoch: int) -> None:
        """Arrive at the epoch's formation barrier.  The value changes on
        every attempt, so 'arrived again since the last failure' is
        distinguishable from a marker left by a previous attempt."""
        self._form_attempt = getattr(self, "_form_attempt", 0) + 1
        self._coord.kv_set(
            _FORM_KEY.format(epoch=epoch, name=self.name),
            f"{self.name}:{self._form_attempt}".encode())

    def formation_markers(self, epoch: int, members: tuple
                          ) -> dict[str, Optional[bytes]]:
        """Current barrier marker per member (None = never arrived)."""
        return {m: self._coord.kv_get(_FORM_KEY.format(epoch=epoch, name=m))
                for m in members}

    def evict(self, name: str, reason: str = "straggler") -> None:
        """Evict ``name`` from the job on its behalf: durable marker
        first (so its keepalive cannot rejoin through the race), then the
        membership leave that bumps the epoch for everyone else."""
        log.warn("evicting straggler", member=name, by=self.name,
                 reason=reason)
        self._coord.kv_set(_EVICT_KEY.format(name=name),
                           f"{self.name}:{reason}".encode())
        try:
            self._coord.leave(name)
        except Exception:
            pass  # membership TTL will prune it; the marker already rules
        from edl_tpu_torch.observability.collector import get_counters
        from edl_tpu_torch.observability.tracing import get_tracer

        get_tracer().instant("member_evicted", category="membership",
                             member=name, by=self.name, reason=reason)
        get_counters().inc("members_evicted")

    def evicted_names(self) -> set[str]:
        """Members barred from the world: evicted stragglers plus
        SDC-quarantined workers (confirmed silent corruption — the
        markers are written by ``edl_tpu_torch.runtime.sdc`` but honored by
        the same membership machinery)."""
        return ({key.split("/", 1)[1]
                 for key in self._coord.kv_keys("evict/")}
                | {key.split("/", 1)[1]
                   for key in self._coord.kv_keys("sdc-quarantine/")})

    def clear_eviction(self) -> bool:
        """Lift this worker's own eviction (fresh-start amnesty).

        The marker exists to defeat ONE adversary: the wedged process's
        still-beating keepalive thread.  A *fresh* supervisor invocation
        under the same name (pod restarted by the operator/kubelet) is
        exactly the recovery the eviction was waiting for — without
        amnesty the stable pod name would be locked out of the job
        forever (markers ride the coordinator's durable state).  If the
        new incarnation wedges too, it just gets evicted again."""
        cleared = False
        key = _EVICT_KEY.format(name=self.name)
        if self._coord.kv_get(key) is not None:
            log.warn("clearing own eviction marker on fresh start",
                     member=self.name)
            self._coord.kv_del(key)
            from edl_tpu_torch.observability.collector import get_counters

            get_counters().inc("evictions_cleared")
            cleared = True
        # the SDC quarantine marker follows the same amnesty rule: a
        # fresh incarnation (rescheduled pod, replaced silicon) is the
        # repair the quarantine was waiting for
        from edl_tpu_torch.runtime.sdc import clear_quarantine

        if clear_quarantine(self._coord, self.name):
            cleared = True
        return cleared

    def _rendezvous(self, epoch: int) -> str:
        """The ``init_method`` rank 0 offers for ``epoch``: a file store in
        the job's shared directory when every live member is on this host
        (no port to race for), else a TCP store on a free port here.  The
        file's name is fresh per claim, so a same-epoch reform never
        meets a dead world's store."""
        if self._store_dir:
            _, members = self._coord.members()
            if {addr for _, addr in members} <= {self.address}:
                path = os.path.join(os.path.abspath(self._store_dir),
                                    f"store-{epoch}-{uuid.uuid4().hex[:8]}")
                return f"file://{path}"
        return f"tcp://{self.address}:{free_port(self.address)}"

    def _claim_coordinator(self, epoch: int, rank: int, budget_s: float
                           ) -> Optional[str]:
        """Rank 0 publishes the epoch's rendezvous; others wait for it.
        Returns None if the epoch advances while waiting (stale world)."""
        key = _TORCH_STORE_KEY.format(epoch=epoch)
        if rank == 0:
            endpoint = self._rendezvous(epoch)
            # CAS so a re-formed world at the same epoch reuses one claim
            if not self._coord.kv_cas(key, b"", endpoint.encode()):
                raw = self._coord.kv_get(key)
                endpoint = raw.decode() if raw else endpoint
            return endpoint
        deadline = time.monotonic() + max(budget_s, 0.01)
        kv_wait = getattr(self._coord, "kv_wait", None)
        while time.monotonic() < deadline:
            if kv_wait is not None:
                # one parked request covers both exits: the leader's KVSET
                # fires it instantly, and an epoch move (stale world)
                # fires it with the new epoch instead
                try:
                    raw, seen_epoch = kv_wait(
                        key, max(deadline - time.monotonic(), 0.01),
                        known_epoch=epoch)
                except Exception:
                    kv_wait = None  # degraded backend: poll below
                    continue
                if raw:
                    return raw.decode()
                if seen_epoch is not None and seen_epoch != epoch:
                    return None
                continue
            raw = self._coord.kv_get(key)
            if raw:
                return raw.decode()
            if self._coord.epoch() != epoch:
                return None
            time.sleep(self._poll_s)
        return None

    # -- state generations -------------------------------------------------

    def publish_state(self, epoch: int, save: Callable[[], str]) -> bool:
        """CAS-elect one writer for generation ``epoch``; the winner calls
        ``save()`` (→ checkpoint path) and publishes the pointer.  Returns
        True if this worker was the writer."""
        wkey = _CKPT_WRITER_KEY.format(epoch=epoch)
        if self._coord.kv_cas(wkey, b"", self.name.encode()):
            path = save()
            self._coord.kv_set(_CKPT_KEY.format(epoch=epoch), path.encode())
            return True
        return False

    def state_published(self, epoch: int) -> bool:
        return self._coord.kv_get(_CKPT_KEY.format(epoch=epoch)) is not None

    def broadcast_state(self, epoch: int, save: Callable[[], str]) -> None:
        """Publish generation ``epoch`` as the world leader (unique per
        world).  Skipped by callers when the pointer already exists — after
        a single membership change the new epoch equals the previous
        teardown generation, and rewriting an already-published file races
        readers mid-load."""
        path = save()
        self._coord.kv_set(_CKPT_KEY.format(epoch=epoch), path.encode())

    def publish_mid_state(self, epoch: int, step: int,
                          save: Callable[[], str], keep: int = 2) -> None:
        """Publish an IN-WORLD generation at (epoch, step), then prune this
        epoch's older mids beyond ``keep``.

        Caller contract mirrors the two state protocols: in replicated
        mode only the world leader calls this (every rank holds identical
        state, the save is local); in collective mode EVERY rank calls it
        at the same step — ``save`` is then the collective sharded write
        (a barrier) and the pointer set is idempotent (same bytes from
        every rank).  The pointer is set only after ``save`` returns, so a
        crash mid-save can never publish a partial checkpoint."""
        path = save()
        self._coord.kv_set(_MID_CKPT_KEY.format(epoch=epoch, step=step),
                           path.encode())
        self._prune_mids(epoch, keep=keep)

    def _prune_mids(self, epoch: int, keep: int) -> None:
        """Drop all but the ``keep`` newest mids of ``epoch`` (KV pointer
        + file/dir).  keep≥2 leaves the previous mid intact for a reader
        that resolved it just before this publish; idempotent across
        ranks (collective mode has every rank pruning the same keys)."""
        import shutil

        mids = []
        for key in self._coord.kv_keys(f"ckpt-mid/{epoch}/"):
            parsed = _mid_from_key(key)
            if parsed is not None:
                mids.append((parsed[1], key))
        for _, key in sorted(mids)[:-keep]:
            raw = self._coord.kv_get(key)
            self._coord.kv_del(key)
            if raw:
                path = raw.decode()
                try:
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    else:
                        os.remove(path)
                except OSError:
                    pass  # a peer pruned it first

    def latest_state(self, upto_epoch: int) -> Optional[tuple[int, str]]:
        """Highest published generation ≤ upto_epoch, as (epoch, path).

        Mid-world generations rank between their world's start generation
        and the next boundary: order key (epoch, step) with boundary gens
        at step −1 — so a crash resumes from the newest mid, while a clean
        teardown's gen (epoch+1) still beats every mid of epoch."""
        best: Optional[tuple[int, int, str]] = None
        for key in self._coord.kv_keys("ckpt/"):
            gen = _gen_from_key(key)
            if gen is None or gen > upto_epoch:
                continue
            if best is None or (gen, -1) > best[:2]:
                raw = self._coord.kv_get(key)
                if raw:
                    best = (gen, -1, raw.decode())
        for key in self._coord.kv_keys("ckpt-mid/"):
            parsed = _mid_from_key(key)
            if parsed is None or parsed[0] > upto_epoch:
                continue
            if best is None or parsed > best[:2]:
                raw = self._coord.kv_get(key)
                if raw:
                    best = (*parsed, raw.decode())
        return (best[0], best[2]) if best else None

    def wait_state(self, epoch: int, timeout_s: float = 30.0
                   ) -> Optional[tuple[int, str]]:
        """Wait for the generation written at ``epoch`` (reform sync point);
        falls back to the latest earlier generation at timeout.  Parks on
        the coordinator's KV long-poll — the leader's publish wakes every
        blocked peer at once instead of at their next poll tick."""
        deadline = time.monotonic() + timeout_s
        key = _CKPT_KEY.format(epoch=epoch)
        kv_wait = getattr(self._coord, "kv_wait", None)
        while time.monotonic() < deadline:
            if kv_wait is not None:
                try:
                    raw, _ = kv_wait(
                        key, max(deadline - time.monotonic(), 0.01))
                except Exception:
                    kv_wait = None  # degraded backend: poll below
                    continue
            else:
                raw = self._coord.kv_get(key)
            if raw:
                return epoch, raw.decode()
            if kv_wait is None:
                time.sleep(self._poll_s)
        return self.latest_state(epoch)


# -- the per-world child body ------------------------------------------------

@dataclass
class WorkerConfig:
    """Everything a world child needs; must be picklable (spawn context).

    The callables must be module-level functions or partials of them —
    ``coord`` crosses the process boundary by reconnecting
    (CoordClient.__getstate__).

    ``collective_ckpt`` switches the state protocol for SHARDED state
    (fsdp: every process holds a different block, so no single writer can
    persist a generation): ``save_state`` is then a collective — every
    rank calls it with the same path, the trainer gathers its state to
    rank 0, which writes it layout-free (ElasticCheckpointer) — and
    ``load_state`` collectively restores onto the current world's layout,
    resharding as the world size changes.  The leader-rebroadcast at
    world start disappears in this mode: state always lives on shared
    storage, so a fresh joiner reads the same generation as everyone.
    Consequence: with no generation published yet, EVERY rank calls
    ``init_state()`` locally, so in this mode init_state MUST be
    deterministic and identical across processes (a seeded generator).

    ``device`` chooses the world's device and, through
    :func:`world_backend`, its process-group backend (see
    :func:`resolve_world_device`); ``init_timeout_s`` bounds the
    rendezvous and every collective of the group."""

    coord: Any
    name: str
    init_state: Callable[[], Any]
    train_world: Callable[[WorldHandle, Any, Callable[[], bool]], Any]
    save_state: Callable[[Any, str], str]
    load_state: Callable[[str], Any]
    ckpt_dir: str
    init_timeout_s: float = 60.0
    state_wait_s: float = 30.0
    collective_ckpt: bool = False
    #: progress-heartbeat file the child refreshes every step (atomic
    #: replace); the supervisor's StallWatchdog reads it.  None = no
    #: stall detection for this worker.
    heartbeat_path: Optional[str] = None
    device: str = "cuda"


#: exactly how many of the newest state generations survive GC.  The
#: newest is load-bearing and peers can be mid-load of the one before it
#: during a reform; one more is margin.  Anything older is unreachable by
#: protocol (latest_state always resolves the newest ≤ epoch).
KEEP_GENERATIONS = 3


def prune_generations(coord, ckpt_dir: str, upto_gen: int,
                      keep: int = KEEP_GENERATIONS) -> int:
    """GC everything per-generation older than the ``keep`` newest: the
    gen files (npz) or directories (ElasticCheckpointer), per-epoch result
    reports and rendezvous files, their KV pointers, and the writer and
    rendezvous claims.  Without this, a
    long-running elastic job grows one full checkpoint plus bookkeeping
    per membership change forever (the reference never hit this — pserver
    state lived in place).  Idempotent and concurrency-safe: every
    supervisor prunes; deletes of already-missing things are no-ops."""
    import shutil

    cutoff = upto_gen - keep + 1  # keep exactly the `keep` newest
    if cutoff <= 0:
        return 0
    pruned = 0
    for key in list(coord.kv_keys("ckpt/")) + list(
            coord.kv_keys("ckpt-writer/")) + list(
            coord.kv_keys("torch-store/")) + list(
            coord.kv_keys("trace/")):
        gen = _gen_from_key(key)
        if gen is not None and gen < cutoff:
            coord.kv_del(key)
    for key in coord.kv_keys("ckpt-mid/"):
        parsed = _mid_from_key(key)
        if parsed is not None and parsed[0] < cutoff:
            coord.kv_del(key)
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return pruned
    for entry in entries:
        if entry.startswith("gen-"):
            stem = entry[4:].split(".", 1)[0]
        elif entry.startswith("mid-"):
            stem = entry[4:].split("-", 1)[0]
        elif entry.startswith("result-") and entry.endswith(".json"):
            stem = entry[:-5].rsplit("-", 1)[1]
        elif entry.startswith("store-"):
            stem = entry[6:].split("-", 1)[0]
        else:
            continue
        try:
            gen = int(stem)
        except ValueError:
            continue
        if gen >= cutoff:
            continue
        path = os.path.join(ckpt_dir, entry)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            pruned += 1
        except OSError:
            pass  # a peer pruned it first
    return pruned


@dataclass(frozen=True)
class WorkerOutcome:
    """What the supervisor learned without ever touching devices: where
    the final generation lives and (when the state tree reports one) the
    step it stopped at."""

    state_path: str
    step: Optional[int] = None
    #: True when this worker left because its peers evicted it (straggler)
    evicted: bool = False
    #: final goodput-ledger snapshot for this member slot (chip-second
    #: attribution across the run: productive/reform_dark/stall/queued…,
    #: plus the conservation verdict) — None only when goodput accounting
    #: itself failed, never because the run was short
    goodput: Optional[dict] = None


def _write_result(path: str, result: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".result-")
    with os.fdopen(fd, "w") as f:
        json.dump(result, f)
    os.rename(tmp, path)


def _world_child(plan: WorldPlan, cfg: WorkerConfig, result_path: str,
                 parent_pid: int) -> None:
    """One world, one process: join the epoch's process group, sync state
    to the epoch's generation, train until the world unanimously stops,
    publish the next generation, report, exit.

    The startup path is instrumented into NAMED sub-phases
    (spawn_imports → coordinator_handshake → device_acquire → restore),
    each recorded as a span parented to the supervisor's reform root
    (trace id from the ``trace/{epoch}`` KV key), observed into the
    ``world_start_phase_seconds`` histogram, and printed as one
    machine-parseable ``world_phases`` log line.  ``coordinator_handshake``
    is the process group's rendezvous; ``device_acquire`` is the CUDA
    context (when the device is a card) and the group's first collective,
    a barrier.

    Any failure here — a collective raising on a dead peer's connection,
    a rendezvous timing out — ends only this process; the supervisor
    reforms."""
    _die_with_parent(parent_pid)
    import faulthandler
    import signal as _signal

    faulthandler.register(_signal.SIGUSR1)  # live stack dumps for debugging
    ew = ElasticWorld(cfg.coord, cfg.name)

    from edl_tpu_torch.observability.metrics import get_registry
    from edl_tpu_torch.observability.tracing import get_tracer, set_trace_id

    tracer = get_tracer()
    trace_id = root_id = None
    t_spawn = None
    try:
        raw = cfg.coord.kv_get(_TRACE_KEY.format(epoch=plan.epoch))
        if raw:
            info = json.loads(raw.decode())
            trace_id = info.get("trace_id")
            root_id = info.get("root")
            t_spawn = info.get("t_spawn")
    except Exception:
        pass  # correlation is telemetry, never a failure
    if trace_id:
        set_trace_id(trace_id)
        os.environ["EDL_TRACE_ID"] = trace_id  # grandchildren inherit

    phases: dict[str, float] = {}
    phase_hist = get_registry().histogram(
        "world_start_phase_seconds",
        help="world-child startup latency by named phase")

    def _phase(name: str, t0w: float, t1w: float) -> None:
        phases[name] = round(t1w - t0w, 3)
        try:
            tracer.record_span(
                f"world_start.{name}", "reform",
                tracer.from_wall(t0w), tracer.from_wall(t1w),
                trace_id=trace_id, parent_id=root_id,
                epoch=plan.epoch, rank=plan.rank, phase=name)
            phase_hist.observe(t1w - t0w, phase=name)
        except Exception:
            pass

    import datetime

    import torch
    import torch.distributed as dist

    if t_spawn is not None:
        # interpreter boot + every import, torch included (near-zero for a
        # warm pre-spawned child — the prepay shows up as the phase
        # collapsing, not disappearing)
        _phase("spawn_imports", t_spawn, time.time())

    def _dump_trace() -> None:
        """Per-world trace dump (same EDL_MH_TRACE knob as the
        supervisor's).  Called once when startup completes — a SIGKILLed
        child (stall escalation) still leaves its startup span tree
        behind — and again at exit with the full story (same path,
        superset)."""
        trace_dir = os.environ.get("EDL_MH_TRACE")
        if not trace_dir:
            return
        try:
            os.makedirs(trace_dir, exist_ok=True)
            tracer.dump(
                os.path.join(trace_dir,
                             f"trace-{cfg.name}-world{plan.epoch}"
                             f"-{os.getpid()}.json"),
                process_name=f"{cfg.name}/world-{plan.epoch}"
                             f"-{os.getpid()}")
        except Exception:
            pass  # tracing never fails the child

    t_handshake = time.time()
    backend = world_backend(cfg.device)
    try:
        dist.init_process_group(
            backend, init_method=plan.coordinator, rank=plan.rank,
            world_size=plan.world_size,
            timeout=datetime.timedelta(seconds=max(cfg.init_timeout_s, 1)))
    except Exception as exc:  # peer died mid-handshake → supervisor reforms
        print(f"[{cfg.name}] world init failed at epoch {plan.epoch}: "
              f"{str(exc)[:200]}", file=sys.stderr, flush=True)
        sys.exit(WORLD_ABORTED)
    _phase("coordinator_handshake", t_handshake, time.time())

    try:
        # the device and the group's first collective, on every rank at
        # the same point: a barrier here is where NCCL builds its
        # communicator, and where a rank that never arrives shows
        t_acquire = time.time()
        device = resolve_world_device(cfg.device, plan.rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.empty(1, device=device)  # the CUDA context, now
        dist.barrier(device_ids=[device.index]
                     if backend == "nccl" else None)
        _phase("device_acquire", t_acquire, time.time())
    except Exception as exc:
        print(f"[{cfg.name}] world {plan.epoch} device acquire failed: "
              f"{str(exc)[:200]}", file=sys.stderr, flush=True)
        _teardown_backend()
        sys.exit(WORLD_ABORTED)

    world = WorldHandle(epoch=plan.epoch, rank=plan.rank,
                        world_size=plan.world_size,
                        coordinator=plan.coordinator, members=plan.members,
                        device=str(device))
    # Accuracy-consistent elasticity (runtime.virtual): when the job
    # runs V fixed virtual workers (EDL_MH_VWS), the leader of every
    # formed world republishes the VW→member ownership map to
    # coordinator KV — the remap-on-epoch-bump half of deterministic
    # data ownership, counted (vw_remaps) and HA-replicated.
    # Best-effort: determinism bookkeeping must never abort a world.
    if world.is_leader:
        try:
            vws = int(os.environ.get("EDL_MH_VWS", "0") or 0)
            if vws > 0:
                from edl_tpu_torch.runtime.virtual import OwnershipMap

                # keyed by job (EDL_MH_JOB): two jobs sharing one
                # coordinator must not overwrite each other's map
                OwnershipMap.publish_for(
                    cfg.coord, vws, plan.members,
                    job=os.environ.get("EDL_MH_JOB", "job"))
        except Exception as exc:
            print(f"[{cfg.name}] vw-map publish failed (non-fatal): "
                  f"{str(exc)[:120]}", file=sys.stderr, flush=True)
    try:
        print(f"[{cfg.name}] devices ready epoch={plan.epoch} "
              f"world={plan.world_size} rank={plan.rank} "
              f"members={','.join(plan.members)} device={device} "
              f"wall={time.time():.3f}", flush=True)
        # World-start sync: the leader ensures a generation is published
        # for this epoch (loading the latest earlier one, or cold init);
        # everyone then loads exactly that generation.  If it is already
        # published — the common single-change reform, where this epoch
        # equals the previous teardown generation — the leader must NOT
        # rewrite it (readers may be mid-load).
        t_restore = time.time()
        state = None
        if cfg.collective_ckpt:
            # Sharded state lives on shared storage whole: everyone
            # restores the latest generation onto THIS world's layout
            # (ElasticCheckpointer reshards into any world size), no
            # rebroadcast needed.
            found = ew.latest_state(world.epoch)
            state = cfg.load_state(found[1]) if found else cfg.init_state()
        elif world.is_leader and not ew.state_published(world.epoch):
            found = ew.latest_state(world.epoch)
            state = cfg.load_state(found[1]) if found else cfg.init_state()
            ew.broadcast_state(
                world.epoch,
                lambda: cfg.save_state(state, os.path.join(
                    cfg.ckpt_dir, f"gen-{world.epoch}")))
            # the publisher keeps its in-memory copy — reloading the file
            # it just wrote would double world-start latency while every
            # peer is blocked in wait_state
        if state is None:
            found = ew.wait_state(world.epoch, timeout_s=cfg.state_wait_s)
            if ((found is None or found[0] != world.epoch)
                    and world.world_size > 1):
                # The leader never published this epoch's generation within
                # the window.  With peers present, falling back to an older
                # generation (or cold init) would train replicated-DP ranks
                # on DIVERGENT parameters silently forever.  Abort instead:
                # the supervisor reforms the world, and the reform either
                # gets a live leader to publish or shrinks the world.
                print(f"[edl-mh] world {world.epoch}: state for this epoch "
                      f"never published (have "
                      f"{found[0] if found else 'nothing'}); aborting to "
                      "reform rather than diverge", file=sys.stderr,
                      flush=True)
                sys.exit(WORLD_ABORTED)
            state = cfg.load_state(found[1]) if found else cfg.init_state()
        _phase("restore", t_restore, time.time())
        # one machine-parseable line per world start (chip_smoke's phase
        # (s) reads these)
        print(f"[{cfg.name}] world_phases epoch={plan.epoch} "
              + " ".join(f"{k}_s={v}" for k, v in phases.items()),
              flush=True)
        _dump_trace()  # startup tree survives even a SIGKILL later

        def should_stop() -> bool:
            return (ew.epoch() != world.epoch
                    or ew.leave_announced(world.epoch))

        # Async cadence pipeline (replicated mode): the body already paid
        # the device→host copy; the npz write + KV pointer publish move to
        # a background thread with bounded backpressure — one publish in
        # flight, a second cadence tick blocks only until the previous one
        # lands.  Collective mode stays synchronous: the sharded save IS a
        # collective every rank must enter together.
        mid_inflight: list = []  # 0 or 1 running publish threads

        def _drain_mid() -> None:
            while mid_inflight:
                mid_inflight.pop().join()

        def _publish_mid_bg(cur_state: Any, step: int, dest: str) -> None:
            try:
                ew.publish_mid_state(world.epoch, step,
                                     lambda: cfg.save_state(cur_state, dest))
            except Exception as exc:
                # a mid generation is crash-loss *bounding*, not the
                # durable boundary gen — losing one shrinks nothing but
                # the bound, so log and keep training
                print(f"[{cfg.name}] async mid-checkpoint at step {step} "
                      f"failed: {str(exc)[:200]}", file=sys.stderr,
                      flush=True)

        def mid_checkpoint(cur_state: Any, step: int) -> None:
            """Periodic in-world generation: bounds crash loss to the
            caller's cadence window.  Replicated mode: leader-only (every
            rank holds identical state, the save is local) and async; the
            body hands over host arrays it will not write again.
            Collective mode: every rank calls at the same step — the
            sharded save is a collective."""
            if not (cfg.collective_ckpt or world.is_leader):
                return
            dest = os.path.join(cfg.ckpt_dir, f"mid-{world.epoch}-{step}")
            if cfg.collective_ckpt:
                ew.publish_mid_state(world.epoch, step,
                                     lambda: cfg.save_state(cur_state, dest))
                return
            import threading

            t0 = time.monotonic()
            _drain_mid()  # bounded backpressure: never two in flight
            # non-daemon: joined by _drain_mid before teardown, and an
            # interpreter exit must never tear down a mid-write thread
            t = threading.Thread(target=_publish_mid_bg,
                                 args=(cur_state, step, dest),
                                 name=f"mid-ckpt-{step}")
            mid_inflight.append(t)
            t.start()
            get_tracer().instant(
                "mid_ckpt_async", category="checkpoint", step=step,
                pause_ms=round((time.monotonic() - t0) * 1000, 2))

        def heartbeat(step: int) -> None:
            """Refresh the progress heartbeat the supervisor's stall
            watchdog reads.  Atomic replace: the supervisor can never
            read a torn write; best-effort: a full disk must degrade
            stall DETECTION, not kill the world."""
            if cfg.heartbeat_path is None:
                return
            tmp = cfg.heartbeat_path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    f.write(str(int(step)))
                os.replace(tmp, cfg.heartbeat_path)
            except OSError:
                pass

        # mechanism lives here, cadence policy with the training loop: the
        # body opts in by accepting `checkpoint` / `heartbeat` kwargs
        import inspect

        extra: dict = {}
        try:
            params = inspect.signature(cfg.train_world).parameters
            var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
            if "checkpoint" in params or var_kw:
                extra["checkpoint"] = mid_checkpoint
            if "heartbeat" in params or var_kw:
                extra["heartbeat"] = heartbeat
        except (TypeError, ValueError):  # builtins/partials w/o signature
            pass
        state, stopped = cfg.train_world(world, state, should_stop, **extra)

        # The world is over: land any in-flight async mid publish before
        # the boundary generation, so the kv namespace quiesces in order.
        _drain_mid()

        # Persist this generation before any supervisor re-enters planning.
        # gen = epoch + 1 is unique per world and ≤ the next membership
        # epoch, which is what makes the next leader's latest_state read
        # well-ordered even when that leader is a brand-new process.
        gen = world.epoch + 1
        dest = "final" if not stopped else f"gen-{gen}"
        save = lambda: cfg.save_state(state, os.path.join(cfg.ckpt_dir, dest))
        if cfg.collective_ckpt:
            # Every rank takes part in the sharded save (the world is
            # intact here, stopped at one step boundary), then every rank
            # publishes the SAME pointer bytes (idempotent kv_set).
            ew.broadcast_state(gen, save)
        elif not ew.publish_state(gen, save):
            found = ew.wait_state(gen, timeout_s=cfg.state_wait_s)
            if found is None or found[0] != gen:
                # The CAS winner died between claiming the writer key and
                # setting the pointer.  Take over: every child of this
                # world holds identical state by protocol and the save is
                # atomic (temp + rename to the same dest), so concurrent
                # takeovers publish the same bytes.
                ew.broadcast_state(gen, save)
        raw = cfg.coord.kv_get(_CKPT_KEY.format(epoch=gen))
        # Duck-typed progress report: the state carries a scalar "step";
        # surfacing it here lets the supervisor report final progress
        # without ever loading the checkpoint (which would drag torch and
        # the card into the abort-proof supervisor process).
        try:
            step = int(state["step"])
        except Exception:
            step = None
        _write_result(result_path, {
            "stopped": stopped,
            "state_path": raw.decode() if raw else None,
            "epoch": world.epoch,
            "step": step,
        })
    except Exception as exc:
        print(f"[{cfg.name}] world {plan.epoch} aborted wall={time.time():.3f}"
              f" error: {str(exc)[:300]}", file=sys.stderr, flush=True)
        sys.exit(WORLD_ABORTED)
    finally:
        _dump_trace()  # full story (startup + training events)
        _teardown_backend()


#: extra respawn delay when the live child was a COLD spawn: its own
#: interpreter + torch import is still in flight for roughly this long,
#: and a concurrent warm preload would contend with it
COLD_BOOTSTRAP_S = 8.0


def _should_respawn_warm(elapsed_s: float, was_warm: bool,
                         warm_delay_s: float,
                         cold_bootstrap_s: float = COLD_BOOTSTRAP_S) -> bool:
    """When may the supervisor pre-spawn the NEXT world's warm child?

    After ``warm_delay_s`` (the reform/join that started this world has
    settled) — plus, when the live child was a cold spawn, its bootstrap
    allowance: at warm_delay_s a cold child is still mid-import, and the
    respawn's preload would recreate exactly the contention the delay
    exists to avoid."""
    delay = warm_delay_s + (0.0 if was_warm else cold_bootstrap_s)
    return elapsed_s >= delay


def _warm_world_child(conn, parent_pid: int,
                      preload: tuple = ("torch",)) -> None:
    """A pre-spawned world child: pay the interpreter + import bootstrap
    (the dominant reform term: a torch import is seconds on a small host)
    while the PREVIOUS world is still draining, then block until the
    supervisor pipes over the plan.

    Receives ``(plan, cfg, result_path)`` and becomes _world_child, or
    ``"exit"`` at supervisor teardown.  Importing torch here initialises
    no CUDA context — the card is still the running world's; acquisition
    happens only after the plan arrives (the device and the first
    collective in _world_child)."""
    _die_with_parent(parent_pid)
    import importlib

    for mod in preload:
        try:
            importlib.import_module(mod)
        except Exception:
            pass  # preloading is an optimization, never a failure
    try:
        item = conn.recv()
    except (EOFError, OSError):  # supervisor died; deathsig races this
        os._exit(1)
    if item == "exit":
        return
    plan, cfg, result_path = item
    _world_child(plan, cfg, result_path, parent_pid)


#: consecutive formation failures a member may sit out (marker frozen)
#: before the lowest-ranked live supervisor evicts it
EVICT_AFTER_MISSES = 2


class StragglerTracker:
    """Supervisor-side strike accounting for the formation barrier.

    Fed one :meth:`note_failure` per dead world whose epoch never moved;
    a member whose barrier marker is UNCHANGED across
    ``evict_after`` consecutive failures at the same epoch is evicted by
    the lowest-ranked member that did arrive (deterministic single actor
    — eviction is idempotent anyway, but one evictor keeps the audit
    trail readable).

    ``strike_interval_s`` is the time floor between strikes for one
    member: markers only refresh when a peer's NEXT plan() completes,
    and a healthy peer needs up to the collective timeout just to
    notice the world died — a locally crash-looping child (bad state
    file, instant exits) must not burn through the strike budget faster
    than an honest peer can possibly re-arrive."""

    def __init__(self, ew: ElasticWorld,
                 evict_after: int = EVICT_AFTER_MISSES,
                 strike_interval_s: float = 20.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._ew = ew
        self.evict_after = max(int(evict_after), 1)
        self.strike_interval_s = strike_interval_s
        self._clock = clock
        self._strikes: dict[str, int] = {}
        self._last_strike: dict[str, float] = {}
        self._prev: dict[str, Optional[bytes]] = {}
        self._prev_epoch: Optional[int] = None

    def note_success(self) -> None:
        """A world formed and ran: everyone arrived; clear all strikes."""
        self._strikes.clear()
        self._prev_epoch = None

    def note_failure(self, plan: WorldPlan) -> list[str]:
        """A world died at ``plan.epoch``.  Returns the members evicted
        by THIS call (empty unless this supervisor is the designated
        evictor and someone crossed the strike threshold)."""
        markers = self._ew.formation_markers(plan.epoch, plan.members)
        if self._prev_epoch != plan.epoch:
            # first failure at this epoch: baseline the markers; strikes
            # only accumulate across CONSECUTIVE failures that membership
            # never resolved (a crashed peer is pruned by the TTL and
            # moves the epoch — it never reaches a second strike)
            self._prev, self._prev_epoch = markers, plan.epoch
            return []
        frozen = [m for m in plan.members
                  if m != self._ew.name and markers.get(m) is not None
                  and markers.get(m) == self._prev.get(m)]
        # members that never arrived AT ALL (no marker ever) are equally
        # frozen — a supervisor wedged before its very first plan
        frozen += [m for m in plan.members
                   if m != self._ew.name and markers.get(m) is None
                   and self._prev.get(m) is None]
        now = self._clock()
        for m in plan.members:
            if m in frozen:
                # time floor: a strike only lands if the member had at
                # least strike_interval_s to re-arrive since its last
                # one — rapid local crash-loops must not outrun an
                # honest peer's reform latency
                if now - self._last_strike.get(m, -1e18) \
                        >= self.strike_interval_s:
                    self._strikes[m] = self._strikes.get(m, 0) + 1
                    self._last_strike[m] = now
            else:
                self._strikes.pop(m, None)
                self._last_strike.pop(m, None)
        self._prev = markers
        arrived = [m for m in plan.members if m not in frozen]
        if not arrived or arrived[0] != self._ew.name:
            return []  # another live supervisor is the designated evictor
        evicted = [m for m in frozen
                   if self._strikes.get(m, 0) >= self.evict_after]
        for m in evicted:
            self._ew.evict(m, reason="missed epoch barrier "
                                     f"{self._strikes[m]}x")
            self._strikes.pop(m, None)
        return evicted


# -- the supervisor ----------------------------------------------------------

def _child_context():
    """Multiprocessing context for world children: spawn, deliberately.

    A world child initialises CUDA, and a CUDA context does not survive a
    fork: a forked child of a process that touched the card cannot use
    it, and a forkserver with torch preloaded forks after torch started
    its threads (the fork-after-threads hazard).  Spawn costs an
    interpreter start and a torch import, which the warm child prepays."""
    return mp.get_context("spawn")


def run_elastic_worker(
    coord,
    name: str,
    *,
    init_state: Callable[[], Any],
    train_world: Callable[[WorldHandle, Any, Callable[[], bool]], Any],
    save_state: Callable[[Any, str], str],
    load_state: Callable[[str], Any],
    ckpt_dir: str,
    address: str = "127.0.0.1",
    min_members: int = 1,
    settle_s: float = 0.5,
    max_worlds: int = 100,
    leave_requested: Optional[Callable[[], bool]] = None,
    heartbeat_timeout_s: int = 10,
    init_timeout_s: float = 60.0,
    reform_grace_s: Optional[float] = None,
    collective_ckpt: bool = False,
    warm_spawn: bool = True,
    warm_delay_s: float = 2.0,
    preload: tuple = ("torch",),
    stall_watchdog: bool = True,
    stall_floor_s: Optional[float] = None,
    stall_k: float = 6.0,
    formation_budget_s: float = 120.0,
    evict_after_misses: int = EVICT_AFTER_MISSES,
    metrics_port: Optional[int] = None,
    flight_dir: Optional[str] = None,
    device: str = "cuda",
) -> "WorkerOutcome":
    """The full elastic dance for one worker host: supervise one world
    child per membership epoch (see module docstring for the protocol).

    ``train_world(world, state, should_stop) -> (state, stopped)`` runs IN
    THE CHILD and trains until the world collectively stops (membership
    change / leave intent — ``stopped=True``) or the task queue is drained
    everywhere (``stopped=False``), returning host-resident state (a dict
    of numpy arrays), or in ``collective_ckpt`` mode the live sharded
    state its ``save_state`` writes collectively.  ``should_stop()`` is the child's local observation; its
    verdict must be fed into the step so the world stops unanimously at one
    boundary (see multihost_worker for the canonical loop).  All callables
    must be picklable (module-level functions / partials).

    ``leave_requested`` is polled IN THE SUPERVISOR (e.g. a SIGTERM flag);
    when it fires the supervisor announces leave intent for the running
    epoch, the world stops at a step boundary, and this function returns.

    Returns a :class:`WorkerOutcome` carrying the PATH of the final
    published state generation (plus the last reported step) — not the
    loaded state: loading would initialise CUDA inside the supervisor
    (taking the card in the process that must stay abort-proof and
    device-free).  Callers load it with ``load_state`` in
    whatever process should own the result.  Raises RuntimeError if no
    generation was ever published (the trained state could not be located
    — never silently cold-starts).

    ``min_members`` gates only the FIRST world (the initial quorum — the
    reference starts the trainer Job at Parallelism=MinInstance,
    pkg/jobparser.go:131); later worlds form with whoever is live, which
    is what lets survivors of a crash reform below the initial quorum.

    ``stall_watchdog`` arms the silent-hang tripwire: the world child
    refreshes a heartbeat file every step, and the supervisor runs a
    :class:`~edl_tpu_torch.runtime.watchdog.StallWatchdog` over it (deadline =
    ``max(stall_floor_s, stall_k × EWMA step time)``; floor defaults to
    ``EDL_MH_STALL_FLOOR_S`` or 60 s).  On breach the supervisor SIGKILLs
    the epoch's child — converting a wedged collective, which no crash
    path would ever notice, into the child-death the reform logic already
    handles.  ``formation_budget_s`` bounds each planning attempt, and
    ``evict_after_misses`` is the straggler-eviction threshold: a member
    whose formation-barrier marker stays frozen across that many
    consecutive same-epoch world failures is evicted via a KV leave
    written on its behalf (see :class:`StragglerTracker`) instead of
    wedging the world forever.

    ``metrics_port`` (None reads ``EDL_MH_METRICS_PORT``; absent or
    negative disables) is the JAX package's ``GET /metrics`` + ``/healthz``
    endpoint; it needs the port's ``observability/health.py`` and
    ``scrape.py`` (ROADMAP.md, queue 1 item 11), so a port ≥ 0 raises
    ``ValueError`` until then.  ``flight_dir`` (default
    ``EDL_FLIGHTREC_DIR``, else ``ckpt_dir``) is where stall escalation
    drops its ``flightrec-*.json`` post-mortem (trace ring + counters +
    metrics snapshot).

    Every formation opens a root ``reform`` span whose trace id is
    published to the ``trace/{epoch}`` KV key (and ``EDL_TRACE_ID``) so
    the world child's named startup phases parent to it — with
    ``EDL_MH_TRACE`` set, supervisor and per-world trace files merge
    into one job-level timeline via ``Tracer.merge_files``.

    ``device`` is the world children's (:class:`WorkerConfig`), and
    picks their backend (:func:`world_backend`); the supervisor never
    touches either.

    ``warm_spawn`` keeps one pre-spawned world child idling with
    ``preload`` imported; on reform the plan is piped to it instead of
    paying the spawn + import bootstrap on the critical path (the
    forkserver alternative cannot carry CUDA — see _child_context).  The
    NEXT world's warm child is respawned ``warm_delay_s`` into the current
    world rather than at its start: a world start is exactly when a
    reform/join is in flight, and the respawn's preload imports would
    contend with the critical path on small hosts (the JAX package
    measured its join leg slower with an immediate respawn on a one-core
    box).  A crash inside the delay window falls back to a cold spawn —
    the pre-warm-spawn behavior."""
    # Connection multiplexing (doc/coordinator_scale.md): a harness
    # hosting several member slots in one process passes the shared
    # CoordMux and each supervisor takes a lightweight slot handle —
    # one persistent connection per host instead of one per slot.  The
    # handle pickles to the world children as a plain standalone client
    # (sockets cannot cross processes).
    from edl_tpu_torch.coord.client import CoordMux

    if metrics_port is None:
        try:
            metrics_port = int(os.environ.get("EDL_MH_METRICS_PORT", "-1"))
        except ValueError:
            metrics_port = -1
    if metrics_port is not None and metrics_port >= 0:
        raise ValueError(
            f"metrics_port {metrics_port}: the supervisor's /metrics and "
            "/healthz endpoint needs the port's observability/health.py "
            "and scrape.py (ROADMAP.md, queue 1 item 11); pass -1")
    if isinstance(coord, CoordMux):
        coord = coord.client()
    ew = ElasticWorld(coord, name, address=address, settle_s=settle_s,
                      store_dir=ckpt_dir)
    # Goodput ledger for this member slot: one chip-second per second,
    # attributed queued → productive/reform_dark/stall across the run
    # (world sizes multiply across members — each supervisor speaks only
    # for its own share, so a fleet sum never double-counts).  A ledger a
    # CALLER installed is fed instead of replaced; one left by a previous
    # supervisor run in this process is retired.
    from edl_tpu_torch.observability import goodput

    ledger = goodput.get_process_ledger()
    if ledger is None or getattr(ledger, "_edl_supervisor", None):
        ledger = goodput.GoodputLedger(job=name, world_size=1,
                                       base_phase=goodput.QUEUED)
        ledger._edl_supervisor = name
        goodput.set_process_ledger(ledger)
        goodput.register_metrics(ledger)
    if stall_floor_s is None:
        stall_floor_s = float(os.environ.get("EDL_MH_STALL_FLOOR_S", "60"))
    hb_path = (os.path.join(ckpt_dir, f"hb-{name}")
               if stall_watchdog else None)
    cfg = WorkerConfig(
        coord=coord, name=name, init_state=init_state,
        train_world=train_world, save_state=save_state,
        load_state=load_state, ckpt_dir=ckpt_dir,
        init_timeout_s=init_timeout_s,
        collective_ckpt=collective_ckpt,
        heartbeat_path=hb_path,
        device=device,
    )
    if reform_grace_s is None:
        # a crashed peer is pruned from membership after the TTL; wait a
        # little longer than that before reforming at the same epoch
        try:
            reform_grace_s = coord.member_ttl_ms() / 1000.0 * 2 + 5.0
        except Exception:
            reform_grace_s = 35.0
    ctx = _child_context()
    os.makedirs(ckpt_dir, exist_ok=True)
    if flight_dir is None:
        flight_dir = os.environ.get("EDL_FLIGHTREC_DIR") or ckpt_dir
    def spawn_warm():
        pconn, cconn = ctx.Pipe()
        p = ctx.Process(target=_warm_world_child,
                        args=(cconn, os.getpid(), tuple(preload)),
                        name=f"warm-world-{name}")
        p.start()
        cconn.close()
        return p, pconn

    # the first world's child bootstraps while we join + settle
    warm = spawn_warm() if warm_spawn else None
    # fresh-start amnesty: a restarted pod under an evicted name is the
    # recovery the eviction was waiting for — lift the marker, rejoin
    try:
        ew.clear_eviction()
    except Exception:
        pass  # coordinator briefly unreachable; join's retry path rules
    # HA: publish the coordination endpoint SET so tooling and late
    # joiners that only know one endpoint can discover the standbys (the
    # key replicates with everything else, so it survives the failover
    # it exists to describe).  Supervisors race benignly: same value.
    eps = getattr(coord, "endpoints", None)
    if eps and len(eps) > 1:
        try:
            coord.kv_set(_COORD_ENDPOINTS_KEY, json.dumps(
                [f"{h}:{p}" for h, p in eps]).encode())
        except Exception:
            pass  # discovery metadata, never a formation failure
    ew.join()
    # Reform timeline into the process tracer (the reference had no
    # tracing at all, SURVEY §5.1); EDL_MH_TRACE=<dir> dumps a chrome
    # trace per worker at exit for offline inspection of the dance.
    from edl_tpu_torch.observability.collector import get_counters
    from edl_tpu_torch.observability.tracing import get_tracer, new_trace_id

    tracer = get_tracer()
    prev_env_trace = os.environ.get("EDL_TRACE_ID")
    tracker = StragglerTracker(
        ew, evict_after=evict_after_misses,
        # a peer's children notice a dead world within about this long
        # (a collective's error or timeout) before its supervisor can
        # possibly re-plan — strikes slower than that can't falsely
        # accumulate against it
        strike_interval_s=max(20.0, 2.0 * heartbeat_timeout_s))
    last_path: Optional[str] = None
    last_step: Optional[int] = None
    evicted_self = False
    try:
        with ew.member.keepalive():
            for n_world in range(max_worlds):
                if leave_requested is not None and leave_requested():
                    break
                # every formation is one root span; its trace id rides
                # EDL_TRACE_ID (cold spawns) and the trace/{epoch} KV
                # (warm children) into the world child, whose named
                # startup phases parent to it — one reform, one tree.
                root = tracer.begin(
                    "reform", category="reform", trace_id=new_trace_id(),
                    worker=name,
                    kind="form" if n_world == 0 else "reform")
                os.environ["EDL_TRACE_ID"] = root.trace_id
                try:
                    with tracer.span("reform.plan", category="reform",
                                     parent_id=root.span_id):
                        plan = ew.plan(
                            min_members=min_members if n_world == 0 else 1,
                            formation_budget_s=formation_budget_s)
                except FormationTimeout as exc:
                    log.warn("formation budget exhausted; retrying",
                             error=str(exc))
                    get_counters().inc("formation_timeouts")
                    root.end(outcome="formation_timeout")
                    continue
                except WorkerEvicted:
                    log.warn("this worker was evicted; exiting", name=name)
                    evicted_self = True
                    root.end(outcome="evicted")
                    break
                ew.mark_formed(plan.epoch)
                result_path = os.path.join(
                    ckpt_dir, f"result-{name}-{plan.epoch}.json")
                if os.path.exists(result_path):
                    os.remove(result_path)  # stale attempt at this epoch
                wd = None
                if cfg.heartbeat_path is not None:
                    from edl_tpu_torch.runtime.watchdog import StallWatchdog

                    try:  # stale beat from the previous world
                        os.remove(cfg.heartbeat_path)
                    except OSError:
                        pass
                    wd = StallWatchdog(floor_s=stall_floor_s, k=stall_k,
                                       scope="multihost",
                                       flight_dir=flight_dir)
                last_hb: Optional[str] = None
                world_t0 = time.monotonic()
                #: goodput: the formation/spawn window stays queued (first
                #: world) or reform_dark (reforms) until the child proves
                #: progress — its first heartbeat (or its start, when no
                #: watchdog heartbeats exist to observe)
                world_productive = False
                # publish the reform-trace correlation + spawn wall-time
                # BEFORE the child exists, so even its first instruction
                # is attributable (the spawn_imports phase starts here)
                try:
                    coord.kv_set(
                        _TRACE_KEY.format(epoch=plan.epoch),
                        json.dumps({"trace_id": root.trace_id,
                                    "root": root.span_id,
                                    "t_spawn": time.time()}).encode())
                except Exception:
                    pass  # correlation is telemetry, never a failure
                child = child_conn = None
                if warm is not None and warm[0].is_alive():
                    try:
                        warm[1].send((plan, cfg, result_path))
                        child, child_conn = warm
                    except (OSError, ValueError):  # warm child just died
                        child = None
                if child is None:
                    child = ctx.Process(
                        target=_world_child,
                        args=(plan, cfg, result_path, os.getpid()),
                        name=f"world-{plan.epoch}-{name}")
                    child.start()
                warm = None  # next world's child respawns after the delay
                log.info("world child started", epoch=plan.epoch,
                         rank=plan.rank, world=plan.world_size,
                         pid=child.pid, warm=child_conn is not None)
                tracer.instant(
                    "world_start", category="membership", epoch=plan.epoch,
                    rank=plan.rank, world=plan.world_size,
                    warm=child_conn is not None)
                # the supervisor's share of the reform ends at child
                # start; the child's startup phases (same trace id, KV-
                # propagated) carry the tree through to training resume
                root.end(epoch=plan.epoch, rank=plan.rank,
                         world=plan.world_size,
                         warm=child_conn is not None)
                announced = False
                stall_killed = False
                if wd is None:
                    # no heartbeat channel: optimistically call the world
                    # productive from its start — better than billing an
                    # entire healthy world to dark time
                    ledger.reset(goodput.PRODUCTIVE)
                    world_productive = True
                while child.exitcode is None:
                    child.join(timeout=0.1)
                    if wd is not None and not stall_killed:
                        try:
                            with open(cfg.heartbeat_path) as f:
                                hb = f.read().strip()
                        except OSError:
                            hb = None
                        if hb and hb != last_hb:
                            last_hb = hb
                            if not world_productive:
                                # first observed progress: the reform's
                                # dark window ends here
                                ledger.reset(goodput.PRODUCTIVE)
                                world_productive = True
                            try:
                                wd.beat(int(hb))
                            except ValueError:
                                wd.beat()
                        stall = wd.check()
                        if stall is not None:
                            # A wedged collective never crashes on its
                            # own — SIGKILL the child so the silent hang
                            # becomes the death the reform path already
                            # handles.  (SIGKILL lands on SIGSTOPped
                            # children too.)
                            log.warn(
                                "world child stalled; killing for reform",
                                epoch=plan.epoch, pid=child.pid,
                                step=stall.step,
                                silent_s=round(stall.silent_s, 3),
                                deadline_s=round(stall.deadline_s, 3))
                            print(f"[{name}] stall detected epoch="
                                  f"{plan.epoch} step={stall.step} "
                                  f"silent_s={stall.silent_s:.3f} "
                                  f"deadline_s={stall.deadline_s:.3f}",
                                  file=sys.stderr, flush=True)
                            tracer.instant(
                                "stall_escalated", category="chaos",
                                epoch=plan.epoch, step=stall.step,
                                silent_s=round(stall.silent_s, 3))
                            child.kill()
                            stall_killed = True
                    if (warm is None and warm_spawn
                            and _should_respawn_warm(
                                time.monotonic() - world_t0,
                                was_warm=child_conn is not None,
                                warm_delay_s=warm_delay_s)):
                        # the reform/join that started this world is over;
                        # NOW pre-pay the next world's bootstrap
                        warm = spawn_warm()
                    if (not announced and leave_requested is not None
                            and leave_requested()):
                        ew.announce_leave(plan.epoch)
                        announced = True
                if child_conn is not None:
                    try:
                        child_conn.close()
                    except OSError:
                        pass
                tracer.instant(
                    "world_exit", category="membership", epoch=plan.epoch,
                    rank=plan.rank, world=plan.world_size,
                    exitcode=child.exitcode,
                    lifetime_s=round(time.monotonic() - world_t0, 3))
                if child.exitcode == 0 and os.path.exists(result_path):
                    tracker.note_success()
                    with open(result_path) as f:
                        result = json.load(f)
                    last_path = result.get("state_path") or last_path
                    if result.get("step") is not None:
                        last_step = result["step"]
                    try:
                        prune_generations(coord, ckpt_dir, plan.epoch + 1)
                    except Exception as exc:  # GC must never kill a worker
                        log.warn("generation prune failed", error=str(exc))
                    if not result["stopped"]:  # queue drained — job done
                        ledger.reset(goodput.IDLE)
                        break
                    if announced:  # our own graceful leave completed
                        ledger.reset(goodput.IDLE)
                        break
                    # stopped on a membership change: the chips are dark
                    # from this boundary until the reformed world's first
                    # beat — the graceful-reform share of elastic overhead
                    ledger.reset(goodput.REFORM_DARK)
                    # wait for the membership change to land
                    try:
                        ew.wait_epoch_past(plan.epoch,
                                           timeout_s=reform_grace_s)
                    except TimeoutError:  # pragma: no cover - races only
                        pass
                    continue
                # Child died: a peer crashed mid-collective (the group
                # raised, or the stall watchdog killed a wedged child),
                # init raced a membership change, or the child itself was
                # killed.  Progress since the last generation is lost
                # (bounded by world length).  Wait for the membership to
                # prune the dead peer, then re-plan.
                log.warn("world child died; reforming", epoch=plan.epoch,
                         exitcode=child.exitcode)
                tracer.instant("world_reform", category="membership",
                               epoch=plan.epoch, exitcode=child.exitcode)
                # goodput: whatever phase the world died inside (a stall
                # window, a checkpoint) settles HERE — chips are dark
                # until the reform's next world proves progress
                ledger.reset(goodput.REFORM_DARK)
                if flight_dir and not stall_killed:
                    # fault escalation (the stall path dumped already via
                    # the watchdog): capture the pre-reform evidence
                    try:
                        from edl_tpu_torch.observability.metrics import (
                            dump_flight_record,
                        )

                        dump_flight_record(
                            flight_dir, "world-death",
                            extra={"epoch": plan.epoch,
                                   "exitcode": child.exitcode,
                                   "worker": name})
                    except Exception as exc:
                        log.warn("flight record dump failed",
                                 error=str(exc))
                # the reform IS the recovery transition for a crashed peer
                # — auditable next to the chaos engine's injections
                get_counters().inc("world_reforms")
                # strike accounting: members whose formation marker froze
                # across consecutive same-epoch failures are stragglers;
                # the designated evictor votes them out so the world can
                # form without them (their keepalive respects the marker)
                try:
                    tracker.note_failure(plan)
                except Exception as exc:  # accounting must not kill us
                    log.warn("straggler accounting failed", error=str(exc))
                if plan.rank == 0:
                    # The rendezvous died with our child; clear the
                    # epoch's claim so a same-epoch reform gets a fresh
                    # store instead of reusing a dead (or collided) one
                    # forever.  Peers that already read the stale value
                    # fail one init round and re-plan.
                    coord.kv_del(_TORCH_STORE_KEY.format(epoch=plan.epoch))
                try:
                    ew.wait_epoch_past(plan.epoch, timeout_s=reform_grace_s)
                except TimeoutError:
                    pass  # epoch unmoved — reform at the same epoch
            else:
                raise RuntimeError(
                    f"exceeded {max_worlds} world reformations")
    finally:
        if warm is not None:
            p, conn = warm
            try:
                if p.is_alive():
                    conn.send("exit")
                conn.close()
                p.join(timeout=5)
                if p.is_alive():  # pragma: no cover - wedged preload
                    p.terminate()
            except (OSError, ValueError):
                pass
        try:
            ew.leave()
        except Exception:
            pass
        if prev_env_trace is None:
            os.environ.pop("EDL_TRACE_ID", None)
        else:
            os.environ["EDL_TRACE_ID"] = prev_env_trace
        trace_dir = os.environ.get("EDL_MH_TRACE")
        if trace_dir:
            try:
                os.makedirs(trace_dir, exist_ok=True)
                tracer.dump(os.path.join(trace_dir, f"trace-{name}.json"),
                            process_name=f"supervisor-{name}")
            except Exception as exc:  # tracing never fails the worker
                log.warn("trace dump failed", error=str(exc))
    # final goodput accounting, machine-parseable like world_phases: the
    # soak/bench harnesses parse this line from worker logs, and the
    # snapshot rides the outcome for in-process callers
    goodput_snap: Optional[dict] = None
    try:
        if getattr(ledger, "_edl_supervisor", None) == name:
            # freeze OUR ledger: the callback gauges registered over it
            # keep serving its FINAL numbers instead of drifting — a
            # scrape after the worker returns must not keep accruing
            # wall time into a finished job's last phase.  A ledger the
            # CALLER installed stays live (its lifecycle, its close).
            ledger.close()
        goodput_snap = ledger.snapshot()
        print(f"[{name}] goodput_ledger "
              f"fraction={goodput_snap['goodput_fraction']} "
              f"conserves={int(ledger.conserves())} "
              f"attributed_s={goodput_snap['attributed_chip_seconds']} "
              f"wall_s={goodput_snap['wall_seconds']} "
              + " ".join(f"{p}_s={v}" for p, v in
                         sorted(goodput_snap["chip_seconds"].items())
                         if v > 0),
              flush=True)
    except Exception as exc:  # accounting must never fail the worker
        log.warn("goodput snapshot failed", error=str(exc))
    if last_path is None:
        found = ew.latest_state(ew.epoch() + 1)
        last_path = found[1] if found else None
    if last_path is None:
        if evicted_self:
            # the typical straggler wedged before ever publishing — the
            # caller must see the typed eviction verdict, not a
            # misleading "trained state lost" crash (the job's state
            # lives with the peers that voted it out)
            raise WorkerEvicted(
                f"worker {name!r} was evicted from the job before "
                "publishing any state generation")
        raise RuntimeError(
            "no state generation was ever published — trained state lost")
    return WorkerOutcome(state_path=last_path, step=last_step,
                         evicted=evicted_self, goodput=goodput_snap)


# -- numpy-tree state helpers (the default save/load for replicated state;
#    a sharded job saves through runtime.checkpoint's ElasticCheckpointer) --

def _tree_leaves(tree: Any, path: tuple = ()) -> list:
    """``[(path, leaf)]`` of a tree of dicts, lists and tuples, dict keys
    in sorted order (the order jax flattens a dict in)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _tree_leaves(tree[key], path + (key,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _tree_leaves(sub, path + (i,))
        return out
    return [(path, tree)]


def _tree_unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def save_numpy_tree(tree: Any, path: str) -> str:
    """Atomic npz save: a concurrent reader of the published path can never
    see a truncated archive (temp file + rename).  The leaves are stored
    as ``arr_<i>`` in flatten order, as the JAX package stores them, and
    their paths beside them (``__paths__``, JSON), so the file loads
    without a template."""
    leaves = _tree_leaves(tree)
    final = path + ".npz"
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(final) or ".",
                               prefix=".ckpt-", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, *[np.asarray(x) for _, x in leaves],
                     __paths__=np.asarray(json.dumps(
                         [list(p) for p, _ in leaves])))
        os.rename(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return final


def load_numpy_tree(path: str, like: Any = None) -> Any:
    """The tree :func:`save_numpy_tree` wrote: shaped as ``like`` when
    given, else rebuilt as nested dicts from the stored paths."""
    with np.load(path) as z:
        n = sum(1 for f in z.files if f.startswith("arr_"))
        flat = [z[f"arr_{i}"] for i in range(n)]
        paths = json.loads(str(z["__paths__"])) if like is None else None
    if like is not None:
        return _tree_unflatten(like, flat)
    tree: dict = {}
    for p, leaf in zip(paths, flat):
        node = tree
        for key in p[:-1]:
            node = node.setdefault(key, {})
        node[p[-1]] = leaf
    return tree
