"""Stall detection: turn silent hangs into already-handled failures — a
copy of edl_tpu.runtime.watchdog over the port's observability.

The fault engine injects *loud* faults — a killed process trips the
supervisor's crash path, a closed socket trips the client's reconnect
path.  The quiet failure mode has no such tripwire: a wedged collective
or a hung step leaves the host alive and heartbeating, so neither the
16 s task-lease timeout nor the membership TTL ever fires, and the job
sits at the same step forever (EasyScale and Tenplex both bound this
with explicit detection deadlines; we previously had none).

:class:`StallWatchdog` derives a per-step deadline from an EWMA of the
recent step times::

    deadline = max(floor_s, k * ewma_step_time)

and watches progress heartbeats (:meth:`beat`).  When no beat arrives
within the deadline it

1. emits a ``stall_detected`` trace event and bumps the
   ``stalls_detected`` counter (labeled by ``scope``),
2. flips :meth:`healthy` — wire it into ``serve_health`` so a stalled
   trainer pod turns its liveness probe red, and
3. escalates through the configurable ``on_stall`` callback.  In the
   multihost supervisor that callback SIGKILLs the epoch's world child,
   which converts the silent hang into the crash the supervisor already
   knows how to survive (reform).  Local harnesses install whatever
   recovery fits (unwedge, resize, abort).

The deadline model is deliberately adaptive: a floor absorbs EWMA
noise on sub-millisecond steps, and ``k × ewma`` grows after a
legitimately slow step (first-step compile, a checkpoint barrier) so one
outlier does not train the watchdog to fire on the next normal pause.
Detection arms at the FIRST beat: the window before it (bootstrap,
compile, restore) is simply unwatched, so slow world starts cannot
false-positive — while a world that makes one step of progress and then
wedges is still caught within the floor (a warmup gate here would leave
exactly that hang — the post-restore collective wedge — undetectable
forever, the inverse of this module's purpose).

Two driving modes:

* **polled** (deterministic; what the multihost supervisor uses): call
  :meth:`check` from an existing loop; it returns a :class:`Stall`
  record on the first breach.
* **threaded**: :meth:`start` spawns a daemon poller for loops that
  cannot be instrumented (a local trainer stepping in C++/CUDA).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from edl_tpu_torch.observability import goodput
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import dump_flight_record
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("runtime.watchdog")

#: default deadline floor — generous enough that CPU-test jitter and a
#: mid-world checkpoint barrier never false-positive, small enough that a
#: wedged collective is caught well inside one scheduler tick
DEFAULT_FLOOR_S = 10.0
#: default EWMA multiplier: a step may take k× its recent average before
#: it counts as hung
DEFAULT_K = 6.0
#: beats before the EWMA is considered settled (deadline_s reports the
#: floor alone until then; detection itself arms at the FIRST beat)
DEFAULT_WARMUP = 3
#: EWMA smoothing factor (weight of the newest sample)
DEFAULT_ALPHA = 0.3


@dataclass(frozen=True)
class Stall:
    """One detected stall: everything the escalation path needs."""

    step: int              # last step that made progress
    silent_s: float        # how long since the last beat
    deadline_s: float      # the deadline that was breached
    ewma_s: float          # the step-time estimate behind it


class StallWatchdog:
    """EWMA-deadline progress watchdog (module docstring for the model)."""

    def __init__(
        self,
        *,
        floor_s: float = DEFAULT_FLOOR_S,
        k: float = DEFAULT_K,
        warmup: int = DEFAULT_WARMUP,
        alpha: float = DEFAULT_ALPHA,
        on_stall: Optional[Callable[[Stall], None]] = None,
        scope: str = "local",
        flight_dir: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if floor_s <= 0:
            raise ValueError("floor_s must be positive")
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self.floor_s = floor_s
        self.k = k
        self.warmup = max(int(warmup), 1)
        self.alpha = alpha
        self.on_stall = on_stall
        self.scope = scope
        #: flight-recorder directory: on the first breach of a silence
        #: the trace ring + counters + metrics snapshot are dumped to a
        #: timestamped flightrec-*.json there, so the post-mortem exists
        #: even when no profiler/scraper was attached.  None falls back
        #: to EDL_FLIGHTREC_DIR; empty/absent disables.
        self.flight_dir = (flight_dir if flight_dir is not None
                           else os.environ.get("EDL_FLIGHTREC_DIR", ""))
        self._clock = clock
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None
        self._last_step = -1
        self._ewma: Optional[float] = None
        self._beats = 0
        self._stalled: Optional[Stall] = None
        self._paused = 0
        self.stalls_detected = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- progress feed -------------------------------------------------------

    def beat(self, step: Optional[int] = None) -> None:
        """Record one unit of progress (a completed step).

        The first beat arms the watchdog; intervals between subsequent
        beats feed the EWMA.  A beat also clears a standing stall — the
        hang resolved (or the escalation recovered it), so the watchdog
        re-arms for the next one rather than latching forever.
        """
        now = self._clock()
        with self._lock:
            if self._last_beat is not None:
                dt = now - self._last_beat
                self._ewma = (dt if self._ewma is None
                              else self.alpha * dt
                              + (1 - self.alpha) * self._ewma)
            self._last_beat = now
            self._beats += 1
            if step is not None:
                self._last_step = step
            else:
                self._last_step += 1
            was_stalled, self._stalled = self._stalled, None
        if was_stalled is not None:
            # the hang resolved: close the goodput stall window the
            # breach opened (no-op without a process ledger)
            goodput.exit_phase(goodput.STALL)

    @contextlib.contextmanager
    def paused(self):
        """A known pause of the loop (a synchronous checkpoint save or a
        restore): its silence is neither watched nor taken as a step
        interval.  The watch resumes, counting silence from then, when the
        pause ends."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1
                if self._last_beat is not None:
                    self._last_beat = self._clock()

    # -- deadline model ------------------------------------------------------

    def ewma_s(self) -> Optional[float]:
        with self._lock:
            return self._ewma

    def deadline_s(self) -> float:
        """Current breach deadline: ``max(floor_s, k × ewma)``.  Before
        the EWMA has a sample (zero or one beat), the floor alone rules."""
        with self._lock:
            return self._deadline_locked()

    def _deadline_locked(self) -> float:
        if self._ewma is None:
            return self.floor_s
        return max(self.floor_s, self.k * self._ewma)

    def armed(self) -> bool:
        """True once the EWMA has ``warmup`` beats behind it (the
        deadline estimate is settled).  Detection itself arms at the
        FIRST beat — gating it on warmup would leave a child that makes
        one step and then wedges undetectable forever."""
        with self._lock:
            return self._beats >= self.warmup

    # -- breach detection ----------------------------------------------------

    def check(self) -> Optional[Stall]:
        """Poll once; on the FIRST breach since the last beat, record it,
        emit the trace/counter evidence, run ``on_stall``, and return the
        :class:`Stall`.  Subsequent checks during the same silence return
        None (the escalation is in flight; one stall = one escalation).

        Armed from the first beat: pre-beat bootstrap/compile/restore is
        unwatched (no false positives), and the deadline's EWMA term —
        which only ever *raises* it above the floor — already protects
        legitimately slow steps from the first interval sample onward."""
        now = self._clock()
        with self._lock:
            if (self._last_beat is None or self._stalled is not None
                    or self._paused):
                return None
            silent = now - self._last_beat
            deadline = self._deadline_locked()
            if silent < deadline:
                return None
            stall = Stall(step=self._last_step, silent_s=silent,
                          deadline_s=deadline, ewma_s=self._ewma or 0.0)
            self._stalled = stall
            self.stalls_detected += 1
        log.warn("stall detected", step=stall.step,
                 silent_s=round(stall.silent_s, 3),
                 deadline_s=round(stall.deadline_s, 3), scope=self.scope)
        get_tracer().instant("stall_detected", category="chaos",
                             scope=self.scope, step=stall.step,
                             silent_s=round(stall.silent_s, 3),
                             deadline_s=round(stall.deadline_s, 3))
        get_counters().inc("stalls_detected", scope=self.scope)
        # goodput: chips are dark from here until the next beat (or the
        # escalation's world reset) — attribute the silence ALREADY spent
        # retroactively, then keep accruing as `stall` until it clears
        goodput.note_span(goodput.STALL, stall.silent_s)
        goodput.enter_phase(goodput.STALL)
        if self.flight_dir:
            # the stall IS the post-mortem moment: capture the trace ring
            # and every counter before escalation mutates the world
            try:
                dump_flight_record(
                    self.flight_dir, f"stall-{self.scope}",
                    extra={"step": stall.step,
                           "silent_s": round(stall.silent_s, 3),
                           "deadline_s": round(stall.deadline_s, 3),
                           "ewma_s": round(stall.ewma_s, 4)})
            except Exception as exc:  # recording must not kill the poller
                log.warn("flight record dump failed", error=str(exc))
        if self.on_stall is not None:
            try:
                self.on_stall(stall)
            except Exception as exc:  # escalation must not kill the poller
                log.warn("on_stall escalation failed", error=str(exc))
        return stall

    def healthy(self) -> bool:
        """Liveness verdict for ``serve_health``: False while a detected
        stall stands (cleared by the next beat)."""
        with self._lock:
            return self._stalled is None

    def last_stall(self) -> Optional[Stall]:
        with self._lock:
            return self._stalled

    # -- threaded mode -------------------------------------------------------

    def start(self, poll_s: float = 0.25) -> "StallWatchdog":
        """Spawn a daemon poller calling :meth:`check` every ``poll_s``."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(poll_s):
                self.check()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"stall-watchdog-{self.scope}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None
