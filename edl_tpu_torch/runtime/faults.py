"""Fault-plan engine: scripted, seeded chaos campaigns — the port of
edl_tpu.runtime.faults, its training and silent-data-corruption kinds.

A :class:`FaultPlan` is an ordered campaign of typed fault actions fired on
step or wall-clock triggers; :meth:`FaultPlan.random` derives a whole
campaign from a single seed, drawing exactly as the reference draws, so a
drill is reproducible from the integer that named it.  The
:class:`FaultPlanEngine` plugs into a training loop as its
``on_step(step, loss, world)`` (as :class:`~edl_tpu_torch.runtime.chaos.
ChaosMonkey` does), fires due actions against a :class:`FaultContext`
(cluster, coord client, chaos proxy, checkpointer, harness hooks), and
then watches each recovery: every injected fault and completed recovery is
a chaos trace event and a labeled counter (``faults_injected{type=...}``,
``recoveries_completed{type=...}``).

The training eight (:data:`TRAINING_KINDS`): :class:`KillTrainer`,
:class:`KillCoordinator` (a respawn from the durable state file, or an HA
pair's failover), :class:`NetworkFlake` (through the :class:`ChaosProxy`
middlebox in front of the coordinator: resets, delay and blackhole
windows), :class:`PreemptDomain` (every trainer of one NVLink domain),
:class:`CorruptCheckpoint` and :class:`DiskFull` (recovered inside the
checkpointer: a fallback restore to the newest verified step, the next
successful save), and the quiet pair :class:`StallStep` /
:class:`WedgeCollective` that hang instead of crash — only the stall
watchdog sees them.

The three SDC kinds (:data:`SDC_KINDS`) strike through the trainer's chaos
seams: :class:`CorruptGradient` (one bit of the summed gradient before the
update), :class:`FlipParamBits` (one bit of a live parameter) and
:class:`PoisonLoss` (a NaN loss report over an honest update).  Their
recovery is the SDC plane's own: a rollback for the first two, a refuted
verdict for the third.

The serving five (:data:`SERVING_KINDS`) strike the data plane with gray
failures the crash drills cannot find: :class:`SlowUpstream` (molasses on
one LB↔replica path), :class:`GrayReplica` (the front door answers 500s or
corrupted payloads at a rate), :class:`ConnFlap` (periodic connection
resets), :class:`PartialPartition` (an LB↔replica black hole, the
coordinator untouched) and :class:`CoordPartition` (the data plane loses
discovery and serves on from last-known addresses).  Their defenses live in
``runtime/lb.py`` (circuit breaker, retry budget, response-integrity nonce)
and ``runtime/frontdoor.py`` (brownout).
"""

from __future__ import annotations

import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("runtime.faults")


# ---------------------------------------------------------------------------
# ChaosProxy: a socket-level chaos middlebox for the coordination server
# ---------------------------------------------------------------------------

class ChaosProxy:
    """TCP proxy in front of the coord server that injects network faults.

    Trainers dial the proxy's ``(host, port)`` instead of the server; the
    proxy pumps bytes both ways until told to misbehave:

    * :meth:`reset_all` — abruptly close every live connection (the
      connection-reset fault; clients see ECONNRESET / empty read);
    * :meth:`delay` — for a window, sleep before forwarding each
      server→client chunk (congested / slow network);
    * :meth:`blackhole` — for a window, accepted connections go nowhere
      and a connection with in-flight bytes is parked for the window and
      then closed (partition: requests vanish, clients block until their
      socket timeout and then ride the reconnect path; never a mid-stream
      byte drop, which TCP's in-order delivery makes unphysical).

    ``set_upstream`` retargets new connections — this is what keeps the
    trainers' endpoint stable across a coordinator restart that came back
    on a different port (the k8s Service's job, emulated at one socket).
    """

    def __init__(self, upstream: tuple[str, int],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._upstream = tuple(upstream)
        self._lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._blackhole_until = 0.0
        self._delay_until = 0.0
        self._delay_s = 0.0
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-proxy-accept")
        self._accept_thread.start()

    # -- fault injection knobs ---------------------------------------------

    def set_upstream(self, host: str, port: int) -> None:
        with self._lock:
            self._upstream = (host, port)

    def reset_all(self) -> int:
        """Close every live proxied connection; returns how many."""
        with self._lock:
            conns, self._conns = self._conns, []
        import struct

        for s in conns:
            try:
                # linger on, 0 s → close sends RST, not FIN (a real reset)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        # _conns holds the (client, upstream) PAIR per proxied connection
        return len(conns) // 2

    def blackhole(self, duration_s: float) -> None:
        with self._lock:
            self._blackhole_until = time.monotonic() + duration_s

    def delay(self, duration_s: float, per_chunk_s: float = 0.2) -> None:
        with self._lock:
            self._delay_until = time.monotonic() + duration_s
            self._delay_s = per_chunk_s

    def faults_active(self) -> bool:
        now = time.monotonic()
        with self._lock:
            return now < self._blackhole_until or now < self._delay_until

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.reset_all()

    # -- internals ----------------------------------------------------------

    def _blackholed(self) -> bool:
        with self._lock:
            return time.monotonic() < self._blackhole_until

    def _current_delay(self) -> float:
        with self._lock:
            return (self._delay_s
                    if time.monotonic() < self._delay_until else 0.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve, args=(client,),
                             daemon=True, name="chaos-proxy-conn").start()

    def _serve(self, client: socket.socket) -> None:
        # A blackholed connection is ACCEPTED and parked: the TCP
        # handshake succeeds but requests vanish — the partition shape
        # that exercises the client's timeout path, not its refused path.
        while self._blackholed() and not self._stop.is_set():
            time.sleep(0.05)
        if self._stop.is_set():
            client.close()
            return
        with self._lock:
            upstream_addr = self._upstream
        try:
            upstream = socket.create_connection(upstream_addr, timeout=5.0)
        except OSError:
            client.close()
            return
        with self._lock:
            self._conns += [client, upstream]
        threading.Thread(target=self._pump, args=(client, upstream, False),
                         daemon=True, name="chaos-proxy-up").start()
        self._pump(upstream, client, True)

    def _pump(self, src: socket.socket, dst: socket.socket,
              is_response: bool) -> None:
        try:
            while not self._stop.is_set():
                data = src.recv(65536)
                if not data:
                    break
                if self._blackholed():
                    # Park until the window lapses, then kill the
                    # connection.  TCP delivers in order — a real
                    # partition can never drop THESE bytes yet deliver
                    # later ones, so swallowing the chunk and pumping the
                    # next would desync the newline protocol mid-stream.
                    # Ending the connection instead sends the client down
                    # the documented reconnect/at-least-once path.
                    while self._blackholed() and not self._stop.is_set():
                        time.sleep(0.05)
                    break  # finally: closes both sides
                if is_response:
                    d = self._current_delay()
                    if d:
                        time.sleep(d)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass
            with self._lock:
                self._conns = [c for c in self._conns
                               if c is not src and c is not dst]


# ---------------------------------------------------------------------------
# Fault actions
# ---------------------------------------------------------------------------

@dataclass
class FaultContext:
    """Everything a campaign may act on.  All fields optional — an action
    whose dependency is absent reports itself unfireable (a planning
    error) rather than crashing the drill."""

    cluster: Any = None          # FakeCluster-compatible backend
    job: Any = None              # TrainingJob the campaign targets
    #: a process-backed kubelet running the pods as real processes
    #: (:class:`~edl_tpu_torch.cluster.exec_kubelet.ProcessKubelet`):
    #: KillTrainer and KillCoordinator then SIGKILL a pod's process group
    #: and its reaper reports the exit; None on the fake cluster alone,
    #: where a kill flips the fake pod
    kubelet: Any = None
    coord: Any = None            # CoordClient/service for recovery probes
    proxy: Optional[ChaosProxy] = None
    checkpointer: Any = None     # ElasticCheckpointer
    #: ElasticTrainer under drill — the SDC faults (CorruptGradient /
    #: FlipParamBits / PoisonLoss) strike through its chaos seams
    trainer: Any = None
    #: non-kubelet drills: SIGKILL + respawn the coord server process
    #: (durable state file carries recovery) — provided by the harness
    restart_coordinator: Optional[Callable[[], None]] = None
    #: HA coordinator pair (doc/coordinator_ha.md): True when ``coord``
    #: is a multi-endpoint client over a primary/standby pair.  Flips
    #: KillCoordinator's recovery contract from "the respawn answers
    #: again" to "a client failover was OBSERVED and zero world reforms
    #: were triggered" — sub-second promotion, not a reform storm.
    ha: bool = False
    #: HA drills: SIGKILL the current primary (no respawn — the standby's
    #: promotion IS the recovery).  Harness-installed; falls back to
    #: ``restart_coordinator`` when unset.
    kill_primary: Optional[Callable[[], None]] = None
    #: quiet-failure hooks (the watchdog drills).  ``stall`` wedges the
    #: training loop for a duration (None = until escalation unwedges
    #: it); ``wedge`` freezes one collective participant (e.g. SIGSTOP a
    #: live world child), returning False when there is nothing to
    #: freeze yet.  Both are harness-installed: the fault describes WHAT
    #: hangs, the harness knows HOW.
    stall: Optional[Callable[[Optional[float]], None]] = None
    wedge: Optional[Callable[[], bool]] = None
    #: serving-plane drills.
    #: ``replica_proxies`` maps replica name → the :class:`ChaosProxy`
    #: sitting between the LB and that replica's front door (per-replica
    #: latency / reset / blackhole injection); ``gray`` maps replica name
    #: → a ``set_gray(rate, mode, duration_s)`` hook on that replica's
    #: BatchApp (the front door itself answers 500s or corrupted
    #: payloads); ``serving_lb`` is the LBApp under test, used read-only
    #: by recovery predicates (breaker back to CLOSED = re-admitted);
    #: ``coord_proxy`` fronts the coordination server for whole-plane
    #: partitions, and ``partition_coord`` is the in-process alternative:
    #: a harness hook that severs the LB's discovery KV for a duration
    #: and returns the recovery predicate.
    replica_proxies: Optional[dict] = None
    gray: Optional[dict] = None
    serving_lb: Any = None
    coord_proxy: Optional[ChaosProxy] = None
    partition_coord: Optional[Callable[[float], Callable[[], bool]]] = None
    rng: random.Random = field(default_factory=random.Random)

    def running_trainers(self) -> list:
        from edl_tpu_torch.cluster.base import PodPhase

        return [p for p in self.cluster.list_pods(
                    job_uid=self.job.full_name, role="trainer")
                if p.phase == PodPhase.RUNNING and not p.deletion_timestamp]

    def kill_pod(self, name: str) -> None:
        """SIGKILL the pod's real process when a kubelet runs it (the
        reaper then reports the exit); otherwise flip the fake pod."""
        if self.kubelet is not None and self.kubelet.pid_of(name) is not None:
            self.kubelet.signal_pod(name)
        else:
            self.cluster.kill_pod(name)

    def coord_alive(self) -> bool:
        c = self.coord
        if c is None:
            return True
        # Probe with a dedicated short-timeout socket, not the production
        # client: CoordClient.ping() rides the reconnect window (seconds)
        # and fires the client's degraded hooks, so polling it from every
        # training-step hook would stall the loop for the whole outage.
        host, port = getattr(c, "host", None), getattr(c, "port", None)
        if host is not None and port is not None:
            try:
                with socket.create_connection((host, port),
                                              timeout=0.5) as s:
                    s.settimeout(0.5)
                    s.sendall(b"PING\n")
                    return s.makefile("rb").readline().startswith(b"PONG")
            except OSError:
                return False
        ping = getattr(c, "ping", None)
        return bool(ping()) if ping is not None else True


#: fire() outcomes
FIRED, RETRY = "fired", "retry"


def _death_then_headcount(ctx: FaultContext, victims: set,
                          baseline: int) -> Callable[[], bool]:
    """Recovery predicate for pod-kill faults: True only after every
    victim has been observed gone from the running set AND the running
    headcount is back to the pre-fault baseline.  The two phases matter
    on the kubelet path, where a SIGKILLed pod keeps listing as RUNNING
    until the reaper polls its exit (~0.2 s) — a plain headcount check
    polled in the same engine call that fired the kill would declare an
    instant, vacuous recovery."""
    seen_dead = [False]

    def recovered() -> bool:
        running = {p.name for p in ctx.running_trainers()}
        if not seen_dead[0]:
            if not (victims & running):
                seen_dead[0] = True
            return False
        return len(running) >= baseline

    return recovered


@dataclass
class FaultAction:
    """One scheduled fault.  ``at_step`` triggers on the training-loop
    hook; ``at_time_s`` (relative to engine start) triggers on tick().
    Subclasses implement ``fire(ctx) -> (outcome, recovery)`` where
    ``recovery`` is an optional zero-arg predicate that turns true when the
    system has healed from this fault."""

    at_step: Optional[int] = None
    at_time_s: Optional[float] = None
    kind: str = "fault"

    def due(self, step: int, elapsed_s: float) -> bool:
        if self.at_step is not None:
            return step >= self.at_step
        if self.at_time_s is not None:
            return elapsed_s >= self.at_time_s
        return False

    def describe(self) -> dict:
        d = {"kind": self.kind}
        if self.at_step is not None:
            d["at_step"] = self.at_step
        if self.at_time_s is not None:
            d["at_time_s"] = self.at_time_s
        return d

    def fire(self, ctx: FaultContext):  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass
class KillTrainer(FaultAction):
    """SIGKILL one running trainer pod — ChaosMonkey's fault, scheduled."""

    kind: str = "kill_trainer"

    def fire(self, ctx: FaultContext):
        victims = ctx.running_trainers()
        if not victims:
            return RETRY, None  # mid-recovery from an earlier fault
        victim = ctx.rng.choice(sorted(victims, key=lambda p: p.name))
        baseline = len(victims)
        log.warn("fault: killing trainer pod", pod=victim.name)
        ctx.kill_pod(victim.name)
        # two-phase recovery: a SIGKILLed pod still lists as RUNNING until
        # the kubelet reaper reports the exit, so a bare count>=baseline
        # check would record an instant bogus recovery — first observe the
        # victim actually gone, THEN the headcount restored (pod names are
        # never reused: FakeCluster names by a global monotonic seq)
        return FIRED, _death_then_headcount(ctx, {victim.name}, baseline)


@dataclass
class KillCoordinator(FaultAction):
    """SIGKILL the coordinator pod/process; durable state (the state file
    on the job volume) carries recovery when the replacement starts.

    In HA mode (``ctx.ha``) the contract hardens: the kill takes down the
    PRIMARY of a replicated pair and recovery means the multi-endpoint
    client was observed failing over (``coord_failovers`` moved) with the
    promoted standby answering — while **zero** world reforms fire.  A
    reform slipping through is recorded loudly
    (``coord_ha_reform_leaks``) so the drill's assertion has evidence,
    not just a green predicate."""

    kind: str = "kill_coordinator"

    def fire(self, ctx: FaultContext):
        if ctx.ha:
            kill = ctx.kill_primary or ctx.restart_coordinator
            if kill is None:
                raise RuntimeError(
                    "HA KillCoordinator needs a kill_primary (or "
                    "restart_coordinator) callable")
            counters = get_counters()
            before_failovers = counters.total("coord_failovers")
            before_reforms = counters.total("world_reforms")
            leak_recorded = [False]
            log.warn("fault: killing HA primary coordinator")
            kill()

            def recovered() -> bool:
                # failover observed first (the counter is the client's
                # own record of re-targeting), then the promoted standby
                # answering the probe
                if counters.total("coord_failovers") <= before_failovers:
                    return False
                if not ctx.coord_alive():
                    return False
                if (counters.total("world_reforms") > before_reforms
                        and not leak_recorded[0]):
                    # the failover was supposed to be invisible to every
                    # world; a reform leaking through fails the HA claim
                    leak_recorded[0] = True
                    log.warn("HA coordinator failover leaked a world "
                             "reform")
                    counters.inc("coord_ha_reform_leaks")
                return True

            return FIRED, recovered
        if ctx.kubelet is not None:
            coords = [n for n in ctx.kubelet.live_pods()
                      if "-coordinator-" in n]
            if not coords:
                return RETRY, None
            log.warn("fault: killing coordinator pod", pod=coords[0])
            ctx.kubelet.signal_pod(coords[0])
            # async kill — same two-phase shape as _death_then_headcount:
            # the SIGKILLed coordinator can still answer a probe in the
            # very _advance call that fired the kill, so require the
            # outage observed before an answered probe counts as recovery
            seen_dead = [False]

            def recovered() -> bool:
                alive = ctx.coord_alive()
                if not seen_dead[0]:
                    if not alive:
                        seen_dead[0] = True
                    return False
                return alive

            return FIRED, recovered
        if ctx.restart_coordinator is not None:
            log.warn("fault: killing coordinator process")
            # synchronous kill+respawn: the outage happens inside the
            # call, so recovery is simply the replacement answering
            ctx.restart_coordinator()
            return FIRED, ctx.coord_alive
        raise RuntimeError("KillCoordinator needs a kubelet or a "
                           "restart_coordinator callable")


@dataclass
class NetworkFlake(FaultAction):
    """Network chaos through the :class:`ChaosProxy`: ``reset`` closes all
    live connections, ``delay`` slows responses for a window, ``blackhole``
    drops everything for a window."""

    mode: str = "reset"  # reset | delay | blackhole
    duration_s: float = 1.0

    kind: str = "network_flake"

    def fire(self, ctx: FaultContext):
        if ctx.proxy is None:
            raise RuntimeError("NetworkFlake needs a ChaosProxy in the ctx")
        log.warn("fault: network flake", mode=self.mode,
                 duration_s=self.duration_s)
        if self.mode == "reset":
            ctx.proxy.reset_all()
        elif self.mode == "delay":
            ctx.proxy.delay(self.duration_s)
        elif self.mode == "blackhole":
            ctx.proxy.blackhole(self.duration_s)
        else:
            raise ValueError(f"unknown flake mode {self.mode!r}")
        proxy = ctx.proxy
        return FIRED, lambda: not proxy.faults_active() and ctx.coord_alive()

    def describe(self) -> dict:
        return {**super().describe(), "mode": self.mode,
                "duration_s": self.duration_s}


@dataclass
class PreemptDomain(FaultAction):
    """Correlated failure: every running trainer pod in ONE NVLink domain
    dies at once (a host group's preemption or maintenance event), forcing
    the world to reform across whatever capacity remains."""

    domain: Optional[str] = None  # None = the domain hosting most trainers

    kind: str = "preempt_domain"

    def fire(self, ctx: FaultContext):
        trainers = ctx.running_trainers()
        if not trainers:
            return RETRY, None
        nodes = {n.name: n.nvlink_domain
                 for n in getattr(ctx.cluster, "_nodes", {}).values()}
        by_domain: dict[str, list] = {}
        for p in trainers:
            dom = nodes.get(p.node, p.node or "")
            by_domain.setdefault(dom, []).append(p)
        domain = self.domain
        if domain is None or domain not in by_domain:
            domain = max(sorted(by_domain), key=lambda d: len(by_domain[d]))
        victims = by_domain[domain]
        baseline = len(trainers)
        log.warn("fault: preempting NVLink domain", domain=domain,
                 pods=[p.name for p in victims])
        for p in victims:
            ctx.kill_pod(p.name)
        return FIRED, _death_then_headcount(
            ctx, {p.name for p in victims}, baseline)

    def describe(self) -> dict:
        d = super().describe()
        if self.domain is not None:
            d["domain"] = self.domain
        return d


@dataclass
class CorruptCheckpoint(FaultAction):
    """Tear the newest saved checkpoint step on disk (flip a byte or
    truncate a file).  Recovery happens inside
    ``ElasticCheckpointer.restore``: the integrity manifest detects the
    damage and the restore falls back to the newest verified step."""

    mode: str = "flip"  # flip | truncate

    kind: str = "corrupt_checkpoint"

    def fire(self, ctx: FaultContext):
        ck = ctx.checkpointer
        if ck is None:
            raise RuntimeError("CorruptCheckpoint needs a checkpointer")
        step = ck.latest_step()
        if step is None:
            return RETRY, None  # nothing saved yet; strike after a save
        root = ck._step_dir(step)
        files = sorted((p for p in root.rglob("*") if p.is_file()),
                       key=lambda p: (p.stat().st_size, str(p)))
        if not files:
            return RETRY, None
        victim = files[-1]  # the largest file holds the parameter bytes
        log.warn("fault: corrupting checkpoint", step=step,
                 file=str(victim), mode=self.mode)
        data = victim.read_bytes()
        if self.mode == "truncate":
            victim.write_bytes(data[:len(data) // 2])
        else:
            b = bytearray(data) or bytearray(1)
            b[len(b) // 2] ^= 0xFF
            victim.write_bytes(bytes(b))
        # recovery = the checkpointer's own fallback restore (counted as
        # recoveries_completed{type=corrupt_checkpoint}) AND the step it
        # lands on re-verifying: its restored param tree must hash to
        # its manifest (verified lineage) — falling back onto a second
        # corrupt step used to pass this drill silently
        before = get_counters().get("recoveries_completed",
                                    type="corrupt_checkpoint")

        def recovered() -> bool:
            moved = get_counters().get("recoveries_completed",
                                       type="corrupt_checkpoint") > before
            return moved and ck.last_restore_hash_ok is not False

        return FIRED, recovered

    def describe(self) -> dict:
        return {**super().describe(), "mode": self.mode}


@dataclass
class DiskFull(FaultAction):
    """ENOSPC at the persist boundary: the next ``saves`` checkpointer
    saves fail.  Recovery is the checkpointer's first subsequent
    successful save (counted as ``recoveries_completed{type=disk_full}``)."""

    saves: int = 1

    kind: str = "disk_full"

    def fire(self, ctx: FaultContext):
        if ctx.checkpointer is None:
            raise RuntimeError("DiskFull needs a checkpointer")
        log.warn("fault: disk full at persist boundary", saves=self.saves)
        ctx.checkpointer.inject_save_failures(self.saves)
        return FIRED, None

    def describe(self) -> dict:
        return {**super().describe(), "saves": self.saves}


def _stalls_detected_total() -> int:
    return get_counters().total("stalls_detected")


@dataclass
class StallStep(FaultAction):
    """The QUIET failure: the training loop wedges mid-step — no crash,
    no closed socket, the host keeps heartbeating.  Nothing in the crash
    path ever notices; only the :class:`~edl_tpu_torch.runtime.watchdog.\
StallWatchdog`'s EWMA deadline does.  ``duration_s=None`` hangs until
    the escalation ladder unwedges it (the honest drill: detection IS
    the recovery trigger).  Recovery is observed as the watchdog's
    ``stalls_detected`` counter moving — the drill asserts the hang was
    *detected*, the escalation path owns what happens next."""

    duration_s: Optional[float] = None

    kind: str = "stall_step"

    def fire(self, ctx: FaultContext):
        if ctx.stall is None:
            raise RuntimeError("StallStep needs a stall hook in the ctx")
        before = _stalls_detected_total()
        log.warn("fault: stalling training step",
                 duration_s=self.duration_s)
        ctx.stall(self.duration_s)
        return FIRED, lambda: _stalls_detected_total() > before

    def describe(self) -> dict:
        d = super().describe()
        if self.duration_s is not None:
            d["duration_s"] = self.duration_s
        return d


@dataclass
class WedgeCollective(FaultAction):
    """Freeze ONE participant of a live collective (the harness typically
    SIGSTOPs a world child): every peer blocks in the collective with the
    process table fully green.  The lease timeout can't fire (the host
    renews), membership can't prune (the supervisor heartbeats) — only
    the stall watchdog's missing progress beats give it away.  Recovery
    observed like :class:`StallStep`: ``stalls_detected`` moved."""

    kind: str = "wedge_collective"

    def fire(self, ctx: FaultContext):
        if ctx.wedge is None:
            raise RuntimeError("WedgeCollective needs a wedge hook in "
                               "the ctx")
        before = _stalls_detected_total()
        if not ctx.wedge():
            return RETRY, None  # nothing to freeze yet (mid-reform)
        log.warn("fault: wedged a collective participant")
        return FIRED, lambda: _stalls_detected_total() > before


# -- the silent three --------------------------------------------------------
#
# A flipped bit in the gradient or a parameter, or a lying loss report:
# nothing crashes and nothing hangs, the model is just WRONG.  Only the SDC
# plane's fingerprint/anomaly/shadow ladder can see these, so detection and
# repair IS each drill's recovery condition.


def _sdc_rollbacks_total() -> int:
    return get_counters().total("sdc_rollbacks")


def _sdc_refuted_total() -> int:
    return get_counters().get("sdc_verdicts", outcome="refuted")


@dataclass
class CorruptGradient(FaultAction):
    """Flip one bit in the summed gradient BEFORE the optimizer update (a
    miscompiled reduction, a bad ALU lane): the update is silently wrong
    and every later step inherits the drift.  Recovery = the SDC plane
    confirmed the corruption and rolled the trajectory back
    (``sdc_rollbacks`` moved)."""

    kind: str = "corrupt_gradient"

    def fire(self, ctx: FaultContext):
        if ctx.trainer is None:
            raise RuntimeError("CorruptGradient needs a trainer in the ctx")
        before = _sdc_rollbacks_total()
        log.warn("fault: corrupting next accumulated gradient")
        ctx.trainer.inject_update_corruption(1)
        return FIRED, lambda: _sdc_rollbacks_total() > before


@dataclass
class FlipParamBits(FaultAction):
    """Flip one bit of one LIVE parameter leaf (a latent chip writing back
    a wrong word between steps).  Recovery like :class:`CorruptGradient`:
    confirmed and rolled back."""

    leaf: int = 0
    bit: int = 17

    kind: str = "flip_param_bits"

    def fire(self, ctx: FaultContext):
        if ctx.trainer is None:
            raise RuntimeError("FlipParamBits needs a trainer in the ctx")
        before = _sdc_rollbacks_total()
        log.warn("fault: flipping live parameter bit", leaf=self.leaf,
                 bit=self.bit)
        ctx.trainer.flip_param_bits(leaf=self.leaf, bit=self.bit)
        return FIRED, lambda: _sdc_rollbacks_total() > before

    def describe(self) -> dict:
        return {**super().describe(), "leaf": self.leaf, "bit": self.bit}


@dataclass
class PoisonLoss(FaultAction):
    """The metric path lies (NaN loss report) over CLEAN parameters — the
    false-alarm half of the drills.  Recovery = the shadow recompute
    REFUTED it (``sdc_verdicts{outcome=refuted}`` moved): the defense must
    not roll back a healthy trainer."""

    kind: str = "poison_loss"

    def fire(self, ctx: FaultContext):
        if ctx.trainer is None:
            raise RuntimeError("PoisonLoss needs a trainer in the ctx")
        before = _sdc_refuted_total()
        log.warn("fault: poisoning next loss report")
        ctx.trainer.inject_loss_poison(1)
        return FIRED, lambda: _sdc_refuted_total() > before


# -- the serving five ---------------------------------------------------------
#
# Gray failures the crash drills cannot find; the defenses they exercise
# live in runtime/lb.py (circuit breaker, retry budget, response-integrity
# nonce) and runtime/frontdoor.py (brownout).

def _pick_replica(ctx: FaultContext, replica: Optional[str],
                  pool: Optional[dict], what: str) -> str:
    """Resolve which replica a serving fault strikes: an explicit name,
    else a seeded draw from the harness-provided pool (sorted so the
    same seed always picks the same victim)."""
    if pool is None or not pool:
        raise RuntimeError(f"{what} needs replica hooks in the ctx")
    if replica is not None:
        if replica not in pool:
            raise RuntimeError(f"{what}: unknown replica {replica!r}")
        return replica
    return ctx.rng.choice(sorted(pool))


def _breaker_closed(ctx: FaultContext, name: str) -> bool:
    """True when the LB's circuit breaker for ``name`` is CLOSED again —
    the re-admit half of a gray-failure recovery.  Read-only peek at the
    LB's upstream table (plain attribute reads, GIL-safe); absence of an
    LB (or of the upstream) degrades to True so harnesses without an LB
    can still run the fault."""
    lb = ctx.serving_lb
    if lb is None:
        return True
    try:
        up = lb.upstreams.get(name)
        if up is None:
            return False  # still ejected/aged out — not recovered
        return up.breaker.state == 0  # BRK_CLOSED
    except Exception:
        return True


@dataclass
class SlowUpstream(FaultAction):
    """Molasses, not a crash: the LB↔replica path answers, slowly.  Each
    response chunk through the replica's :class:`ChaosProxy` is delayed
    for a window — the fault the hedger (and, when sustained, the
    breaker's timeout accounting) must absorb without wrong answers."""

    replica: Optional[str] = None
    duration_s: float = 1.0
    per_chunk_s: float = 0.05

    kind: str = "slow_upstream"

    def fire(self, ctx: FaultContext):
        name = _pick_replica(ctx, self.replica, ctx.replica_proxies,
                             "SlowUpstream")
        proxy = ctx.replica_proxies[name]
        log.warn("fault: slow upstream", replica=name,
                 duration_s=self.duration_s, per_chunk_s=self.per_chunk_s)
        proxy.delay(self.duration_s, per_chunk_s=self.per_chunk_s)
        return FIRED, lambda: not proxy.faults_active()

    def describe(self) -> dict:
        d = {**super().describe(), "duration_s": self.duration_s,
             "per_chunk_s": self.per_chunk_s}
        if self.replica is not None:
            d["replica"] = self.replica
        return d


@dataclass
class GrayReplica(FaultAction):
    """THE gray failure: the replica's front door keeps accepting and
    answering, but a fraction of responses are 500s (``mode="error"``) or
    carry a corrupted body + wrong nonce echo (``mode="corrupt"`` — the
    misroute/desync bug class, detectable only by the LB's end-to-end
    integrity check).  Recovery = the window lapsed AND the LB's breaker
    for that upstream is back to CLOSED (the half-open probe re-admitted
    it) — an ejection without re-admission is not a recovery."""

    replica: Optional[str] = None
    rate: float = 0.5
    mode: str = "error"  # error | corrupt
    duration_s: float = 1.5

    kind: str = "gray_replica"

    def fire(self, ctx: FaultContext):
        name = _pick_replica(ctx, self.replica, ctx.gray, "GrayReplica")
        log.warn("fault: gray replica", replica=name, rate=self.rate,
                 mode=self.mode, duration_s=self.duration_s)
        ctx.gray[name](self.rate, self.mode, self.duration_s)
        until = time.monotonic() + self.duration_s

        def recovered() -> bool:
            return (time.monotonic() >= until
                    and _breaker_closed(ctx, name))

        return FIRED, recovered

    def describe(self) -> dict:
        d = {**super().describe(), "rate": self.rate, "mode": self.mode,
             "duration_s": self.duration_s}
        if self.replica is not None:
            d["replica"] = self.replica
        return d


@dataclass
class ConnFlap(FaultAction):
    """Periodic connection resets on one LB↔replica path: every live
    proxied connection is RST-closed ``resets`` times, ``period_s``
    apart (a flapping NIC / conntrack flush).  Each reset sends every
    in-flight block down the rescue-resend path; recovery = the flapping
    stopped and the LB's breaker shows the upstream re-admitted."""

    replica: Optional[str] = None
    resets: int = 3
    period_s: float = 0.25

    kind: str = "conn_flap"

    def fire(self, ctx: FaultContext):
        name = _pick_replica(ctx, self.replica, ctx.replica_proxies,
                             "ConnFlap")
        proxy = ctx.replica_proxies[name]
        log.warn("fault: connection flapping", replica=name,
                 resets=self.resets, period_s=self.period_s)
        done = threading.Event()

        def flap() -> None:
            for i in range(self.resets):
                proxy.reset_all()
                if i + 1 < self.resets:
                    time.sleep(self.period_s)
            done.set()

        threading.Thread(target=flap, daemon=True,
                         name="fault-conn-flap").start()
        return FIRED, lambda: (done.is_set()
                               and _breaker_closed(ctx, name))

    def describe(self) -> dict:
        d = {**super().describe(), "resets": self.resets,
             "period_s": self.period_s}
        if self.replica is not None:
            d["replica"] = self.replica
        return d


@dataclass
class PartialPartition(FaultAction):
    """LB↔one-replica black hole while the coordinator stays reachable:
    the replica's proxy parks accepted connections for the window (new
    dials hang, in-flight requests vanish), so the LB must time out /
    rescue around it while discovery keeps listing the replica healthy.
    Recovery = the window lapsed and the breaker re-admitted the path."""

    replica: Optional[str] = None
    duration_s: float = 1.0

    kind: str = "partial_partition"

    def fire(self, ctx: FaultContext):
        name = _pick_replica(ctx, self.replica, ctx.replica_proxies,
                             "PartialPartition")
        proxy = ctx.replica_proxies[name]
        log.warn("fault: partial partition (LB↔replica)", replica=name,
                 duration_s=self.duration_s)
        proxy.blackhole(self.duration_s)
        return FIRED, lambda: (not proxy.faults_active()
                               and _breaker_closed(ctx, name))

    def describe(self) -> dict:
        d = {**super().describe(), "duration_s": self.duration_s}
        if self.replica is not None:
            d["replica"] = self.replica
        return d


@dataclass
class CoordPartition(FaultAction):
    """The serving plane loses the coordinator mid-traffic.  Discovery
    must FREEZE (the LB keeps routing to last-known addresses instead of
    aging out the whole fleet) and serving must continue — the drill
    that pins the control plane's failure domain out of the data path.
    Injection prefers the harness's ``partition_coord`` hook (severs the
    LB's KV in-process and hands back the recovery predicate); with a
    :class:`ChaosProxy` fronting the coord server (``coord_proxy``) it
    blackholes the proxy instead and recovery is the window lapsing plus
    the coordinator answering probes again."""

    duration_s: float = 1.5

    kind: str = "coord_partition"

    def fire(self, ctx: FaultContext):
        log.warn("fault: coordinator partition (serving plane)",
                 duration_s=self.duration_s)
        if ctx.partition_coord is not None:
            recovery = ctx.partition_coord(self.duration_s)
            return FIRED, recovery
        if ctx.coord_proxy is not None:
            proxy = ctx.coord_proxy
            proxy.blackhole(self.duration_s)
            return FIRED, lambda: (not proxy.faults_active()
                                   and ctx.coord_alive())
        raise RuntimeError("CoordPartition needs a partition_coord hook "
                           "or a coord_proxy in the ctx")

    def describe(self) -> dict:
        return {**super().describe(), "duration_s": self.duration_s}


#: the training eight, frozen as the reference freezes them, so a
#: seeded campaign draws the same faults as the registry grows
TRAINING_KINDS = ("kill_trainer", "kill_coordinator", "network_flake",
                  "preempt_domain", "corrupt_checkpoint", "disk_full",
                  "stall_step", "wedge_collective")
#: the serving five (gray failures): pass ``kinds=SERVING_KINDS`` to
#: :meth:`FaultPlan.random` for a data-plane drill
SERVING_KINDS = ("slow_upstream", "gray_replica", "conn_flap",
                 "partial_partition", "coord_partition")

#: the silent three: pass ``kinds=SDC_KINDS`` to :meth:`FaultPlan.random`
#: for a corruption campaign
SDC_KINDS = ("corrupt_gradient", "flip_param_bits", "poison_loss")

#: kind string → action class
ACTION_TYPES = {
    cls.kind: cls  # type: ignore[attr-defined]
    for cls in (KillTrainer, KillCoordinator, NetworkFlake, PreemptDomain,
                CorruptCheckpoint, DiskFull, StallStep, WedgeCollective,
                CorruptGradient, FlipParamBits, PoisonLoss,
                SlowUpstream, GrayReplica, ConnFlap, PartialPartition,
                CoordPartition)
}

#: each kind the port lacks → the ROADMAP.md item that brings it (none)
UNPORTED_KINDS: dict[str, str] = {}


def _check_ported(kinds) -> None:
    missing = [k for k in kinds if k not in ACTION_TYPES]
    if missing:
        items = sorted({UNPORTED_KINDS.get(k, "no item") for k in missing})
        raise ValueError(
            f"fault kinds {missing} are not ported yet (ROADMAP.md "
            f"{', '.join(items)}); the port has {sorted(ACTION_TYPES)}")


@dataclass
class FaultPlan:
    """An ordered campaign of fault actions plus the seed that named it."""

    actions: list[FaultAction] = field(default_factory=list)
    seed: Optional[int] = None

    def describe(self) -> list[dict]:
        """The reproducible audit view: what fires when, with what params.
        Two plans built from the same seed describe identically."""
        return [a.describe() for a in self.actions]

    @classmethod
    def random(cls, seed: int, *, n_faults: int = 6,
               first_step: int = 5, last_step: int = 120,
               min_gap: int = 8,
               kinds: tuple[str, ...] = TRAINING_KINDS,
               flake_duration_s: float = 1.0) -> "FaultPlan":
        """Derive a whole campaign deterministically from ``seed``, drawing
        exactly as the reference draws: ``n_faults`` actions from ``kinds``
        (each kind at least once when ``n_faults`` allows), at strictly
        increasing steps at least ``min_gap`` apart, so each recovery has
        room to land before the next strike.  ``kinds`` defaults to the
        training eight; pass :data:`SDC_KINDS` for a corruption campaign,
        :data:`SERVING_KINDS` for a data-plane drill.  ``flake_duration_s``
        shapes the network flakes and the serving windows."""
        _check_ported(kinds)
        rng = random.Random(seed)
        if n_faults < len(kinds):
            # a shortened campaign draws its fault MIX from the seed too,
            # not just its schedule
            chosen = rng.sample(list(kinds), n_faults)
        else:
            chosen = list(kinds)
            while len(chosen) < n_faults:
                chosen.append(rng.choice(kinds))
        rng.shuffle(chosen)
        span = max(last_step - first_step - min_gap * (n_faults - 1), 1)
        offsets = sorted(rng.randrange(span) for _ in range(n_faults))
        actions: list[FaultAction] = []
        for i, kind in enumerate(chosen):
            step = first_step + offsets[i] + min_gap * i
            if kind == "network_flake":
                mode = rng.choice(("reset", "delay", "blackhole"))
                actions.append(NetworkFlake(at_step=step, mode=mode,
                                            duration_s=flake_duration_s))
            elif kind == "corrupt_checkpoint":
                actions.append(CorruptCheckpoint(
                    at_step=step, mode=rng.choice(("flip", "truncate"))))
            elif kind == "disk_full":
                actions.append(DiskFull(at_step=step, saves=1))
            elif kind == "slow_upstream":
                actions.append(SlowUpstream(
                    at_step=step, duration_s=flake_duration_s,
                    per_chunk_s=round(rng.uniform(0.02, 0.08), 3)))
            elif kind == "gray_replica":
                actions.append(GrayReplica(
                    at_step=step, rate=round(rng.uniform(0.3, 0.9), 2),
                    mode=rng.choice(("error", "corrupt")),
                    duration_s=flake_duration_s))
            elif kind == "conn_flap":
                actions.append(ConnFlap(
                    at_step=step, resets=rng.randrange(2, 5),
                    period_s=round(flake_duration_s / 4, 3)))
            elif kind in ("partial_partition", "coord_partition"):
                actions.append(ACTION_TYPES[kind](
                    at_step=step, duration_s=flake_duration_s))
            else:
                actions.append(ACTION_TYPES[kind](at_step=step))
        return cls(actions=actions, seed=seed)


class FaultPlanEngine:
    """Fires a :class:`FaultPlan` against a :class:`FaultContext` and
    audits the recoveries.

    Wire it into a training loop as ``loop.run(on_step=engine)``, or drive
    wall-clock campaigns with periodic :meth:`tick` calls.  Each call fires
    every due, not-yet-fired action (one whose preconditions are not met
    stays armed and retries on the next call), then polls the pending
    recovery predicates.  ``fired`` / ``recovered`` record the audit trail;
    :meth:`quiescent` is the drill's exit condition."""

    def __init__(self, plan: FaultPlan, ctx: FaultContext,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.plan = plan
        self.ctx = ctx
        self._clock = clock
        self._t0 = clock()
        self._armed: list[FaultAction] = list(plan.actions)
        self._pending: list[tuple[str, Callable[[], bool]]] = []
        self._lock = threading.Lock()
        #: (step, kind) of every action actually fired, in firing order
        self.fired: list[tuple[int, str]] = []
        #: kinds whose engine-watched recovery predicate turned true
        self.recovered: list[str] = []

    def __call__(self, step: int, loss: float = 0.0, world: int = 0) -> None:
        self._advance(step)

    def tick(self) -> None:
        """Clock-only advance (time-triggered campaigns, idle polling)."""
        self._advance(-1)

    def quiescent(self) -> bool:
        """True when every action has fired and every engine-watched
        recovery has completed."""
        with self._lock:
            return not self._armed and not self._pending

    def unfired(self) -> list[dict]:
        with self._lock:
            return [a.describe() for a in self._armed]

    # -- internals ----------------------------------------------------------

    def _advance(self, step: int) -> None:
        elapsed = self._clock() - self._t0
        # claim due actions under the lock BEFORE firing: a concurrent
        # on_step/tick caller must not fire the same action twice
        with self._lock:
            due = [a for a in self._armed if a.due(step, elapsed)]
            for a in due:
                self._armed.remove(a)
        for action in due:
            try:
                outcome, recovery = action.fire(self.ctx)
            except Exception as exc:
                # a misconfigured action must not kill the drill loop —
                # surface it in the audit trail and leave it disarmed
                log.warn("fault action failed to fire", kind=action.kind,
                         error=str(exc))
                get_tracer().instant("fault_unfireable", category="chaos",
                                     type=action.kind, error=str(exc)[:120])
                continue
            if outcome == RETRY:
                with self._lock:  # re-arm; strikes when preconditions return
                    self._armed.append(action)
                continue
            with self._lock:
                self.fired.append((step, action.kind))
                if recovery is not None:
                    self._pending.append((action.kind, recovery))
            get_tracer().instant("fault_injected", category="chaos",
                                 type=action.kind, step=step,
                                 elapsed_s=round(elapsed, 3))
            get_counters().inc("faults_injected", type=action.kind)
        self._check_recoveries(step)

    def _check_recoveries(self, step: int) -> None:
        with self._lock:
            pending = list(self._pending)
        for kind, predicate in pending:
            try:
                healed = bool(predicate())
            except Exception:
                healed = False  # probe hiccup ≠ recovery
            if not healed:
                continue
            with self._lock:
                if (kind, predicate) not in self._pending:
                    continue  # a concurrent caller already recorded it
                self._pending.remove((kind, predicate))
                self.recovered.append(kind)
            log.info("recovery completed", type=kind, step=step)
            get_tracer().instant("recovery_completed", category="chaos",
                                 type=kind, step=step)
            get_counters().inc("recoveries_completed", type=kind)
