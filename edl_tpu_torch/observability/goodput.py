"""Goodput ledger: attribute every chip-second of a job to a phase — the
part of edl_tpu.observability.goodput that the trainer's resize path and
the multi-process supervisor (runtime/multihost.py) call.

A :class:`GoodputLedger` attributes wall-clock time, weighted by the world
size holding chips, to its accruing phase; durations measured elsewhere
(a resize's compile, replan and reshard windows) are moved into their
phase afterwards with :meth:`GoodputLedger.note_span`, a transfer between
phases that cannot break the conservation invariant

    Σ_phase attributed_chip_seconds  ==  ∫ world_size dt.

Phases nest: :meth:`GoodputLedger.enter` pushes a phase that accrues until
:meth:`GoodputLedger.exit` pops it (the stall watchdog brackets a detected
stall so).  The runtime feeds the process ledger through the module-level
:func:`note_span`, :func:`enter_phase`, :func:`exit_phase` and
:func:`set_world_size`, which are no-ops until one is installed with
:func:`set_process_ledger`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# -- phase taxonomy ----------------------------------------------------------

PRODUCTIVE = "productive"
COMPILE = "compile"
RESHARD = "reshard"
CHECKPOINT_PAUSE = "checkpoint_pause"
STALL = "stall"
REFORM_DARK = "reform_dark"
QUEUED = "queued"
IDLE = "idle"

#: every phase the ledger knows; attribution to anything else raises
ALL_PHASES = (PRODUCTIVE, COMPILE, RESHARD, CHECKPOINT_PAUSE, STALL,
              REFORM_DARK, QUEUED, IDLE)

#: phases that are *lost* time (everything but productive) — what the
#: ``edl_goodput_lost_seconds{phase=...}`` gauges report
LOST_PHASES = tuple(p for p in ALL_PHASES if p != PRODUCTIVE)


class GoodputLedger:
    """Per-job chip-second ledger.

    ``world_size`` weights the accrual: one second at world size 4 is 4
    chip-seconds.  Time accrues to ``base_phase``; :meth:`note_span` moves
    chip-seconds out of it into the phase a measured window belonged to.
    Thread-safe.
    """

    def __init__(self, job: str = "", world_size: int = 1,
                 base_phase: str = QUEUED,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if base_phase not in ALL_PHASES:
            raise ValueError(f"unknown phase {base_phase!r}")
        self.job = job
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._t0 = now
        self._last = now          # attribution accrual timestamp
        self._integral_t = now    # independent conservation-integral stamp
        self._world = max(int(world_size), 0)
        self._attributed: dict[str, float] = {p: 0.0 for p in ALL_PHASES}
        #: the phase stack; its top accrues, its bottom is the base phase
        self._stack = [base_phase]
        self._integral = 0.0      # ∫ world_size dt, chip-seconds
        self._closed = False      # closed: accrual frozen at close time

    def _accrue_locked(self, now: float) -> None:
        """Attribute the elapsed window to the accruing phase AND advance
        the independent integral — two code paths over the same clock
        reads, so a skipped accrual makes them diverge."""
        if self._closed:
            return
        dt = now - self._last
        if dt > 0:
            self._attributed[self._stack[-1]] += dt * self._world
            self._last = now
        di = now - self._integral_t
        if di > 0:
            self._integral += di * self._world
            self._integral_t = now

    @property
    def world_size(self) -> int:
        with self._lock:
            return self._world

    def set_world_size(self, n: int) -> None:
        """World size changed (resize committed): settle the old rate
        first, then accrue at the new one."""
        with self._lock:
            self._accrue_locked(self._clock())
            self._world = max(int(n), 0)

    def note_span(self, phase: str, seconds: float,
                  world_size: Optional[int] = None) -> float:
        """Move ``seconds × world_size`` chip-seconds from the currently
        accruing phase into ``phase``.  A transfer, so conservation holds
        by construction; clamped so the source phase never goes negative.
        Returns the chip-seconds actually moved."""
        if phase not in ALL_PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        if seconds <= 0:
            return 0.0
        with self._lock:
            self._accrue_locked(self._clock())
            src = self._stack[-1]
            if src == phase:
                return 0.0
            ws = self._world if world_size is None else max(int(world_size), 0)
            move = min(seconds * ws, self._attributed[src])
            self._attributed[src] -= move
            self._attributed[phase] += move
            return move

    def enter(self, phase: str) -> bool:
        """Push ``phase``; it accrues until exited.  Entering a phase
        already on the stack is a no-op returning False, so two detectors
        firing on one event cannot double-push."""
        if phase not in ALL_PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        with self._lock:
            if phase in self._stack:
                return False
            self._accrue_locked(self._clock())
            self._stack.append(phase)
            return True

    def exit(self, phase: str) -> bool:
        """Pop the topmost occurrence of ``phase``, wherever it sits; a
        no-op (False) when it is not active or is the base."""
        with self._lock:
            now = self._clock()
            for i in range(len(self._stack) - 1, 0, -1):
                if self._stack[i] == phase:
                    self._accrue_locked(now)
                    del self._stack[i]
                    return True
            return False

    def reset(self, phase: str) -> None:
        """Collapse the whole stack to ``phase`` — the world-death path:
        whatever the process was mid-way through, the chips are now dark
        until the reform lands, and every half-open phase is settled at
        this instant."""
        if phase not in ALL_PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        with self._lock:
            self._accrue_locked(self._clock())
            self._stack = [phase]

    def close(self) -> None:
        """Freeze the ledger: one final accrual now, then every read
        returns the settled numbers (the supervisor closes its ledger at
        worker exit, so its gauges stop accruing a finished job's last
        phase).  Idempotent."""
        with self._lock:
            self._accrue_locked(self._clock())
            self._closed = True

    def chip_seconds(self, phase: str) -> float:
        with self._lock:
            self._accrue_locked(self._clock())
            return self._attributed[phase]

    def conservation_error(self) -> float:
        """|Σ attributed − ∫ world dt| as a fraction of the integral."""
        with self._lock:
            self._accrue_locked(self._clock())
            total = sum(self._attributed.values())
            if self._integral <= 0:
                return 0.0 if total == 0 else float("inf")
            return abs(total - self._integral) / self._integral

    def conserves(self, tolerance: float = 0.01) -> bool:
        """Attributed chip-seconds sum to the world-size integral within
        ``tolerance`` (default 1 %)."""
        return self.conservation_error() <= tolerance

    def goodput_fraction(self) -> float:
        """Productive chip-seconds over all attributed chip-seconds
        (0.0 before anything accrued)."""
        with self._lock:
            self._accrue_locked(self._clock())
            total = sum(self._attributed.values())
            return self._attributed[PRODUCTIVE] / total if total > 0 else 0.0

    def snapshot(self) -> dict:
        """Everything a report wants, in one dict (the reference's keys,
        less its optional token feed)."""
        with self._lock:
            now = self._clock()
            self._accrue_locked(now)
            # a closed ledger's wall clock ends at its close instant
            end = self._last if self._closed else now
            total = sum(self._attributed.values())
            return {
                "job": self.job,
                "world_size": self._world,
                "wall_seconds": round(end - self._t0, 3),
                "chip_seconds": {p: round(v, 3)
                                 for p, v in self._attributed.items()},
                "attributed_chip_seconds": round(total, 3),
                "integral_chip_seconds": round(self._integral, 3),
                "goodput_fraction": round(
                    self._attributed[PRODUCTIVE] / total, 4) if total else 0.0,
                "lost_seconds": {p: round(self._attributed[p], 3)
                                 for p in LOST_PHASES
                                 if self._attributed[p] > 0},
                "conservation_error_pct": round(
                    100.0 * (abs(total - self._integral) / self._integral
                             if self._integral > 0 else 0.0), 4),
                "current_phase": self._stack[-1],
            }


# -- process ledger ----------------------------------------------------------
#
# One ledger per process, installed by whoever owns the job's lifecycle;
# the trainer's resize feeds it best-effort through the helpers below, so
# with no ledger installed every helper is a no-op.

_process_ledger: Optional[GoodputLedger] = None
_process_lock = threading.Lock()


def set_process_ledger(ledger: Optional[GoodputLedger]
                       ) -> Optional[GoodputLedger]:
    """Install (or clear, with None) the process-wide ledger; returns it."""
    global _process_ledger
    with _process_lock:
        _process_ledger = ledger
    return ledger


def get_process_ledger() -> Optional[GoodputLedger]:
    return _process_ledger


def note_span(phase: str, seconds: float,
              world_size: Optional[int] = None) -> None:
    """Best-effort retroactive attribution on the process ledger."""
    led = _process_ledger
    if led is not None:
        try:
            led.note_span(phase, seconds, world_size=world_size)
        except Exception:
            pass  # accounting must never fail the runtime


def enter_phase(phase: str) -> None:
    led = _process_ledger
    if led is not None:
        try:
            led.enter(phase)
        except Exception:
            pass


def exit_phase(phase: str) -> None:
    led = _process_ledger
    if led is not None:
        try:
            led.exit(phase)
        except Exception:
            pass


def set_world_size(n: int) -> None:
    led = _process_ledger
    if led is not None:
        try:
            led.set_world_size(n)
        except Exception:
            pass


def register_metrics(ledger: GoodputLedger, registry=None) -> None:
    """Expose the ledger as ``edl_goodput_*`` series on the shared
    registry (callback gauges, evaluated at render time): the fraction,
    the accrual weight, the conservation error, and the chip-seconds by
    phase (all, and the lost ones alone)."""
    if registry is None:
        from edl_tpu_torch.observability.metrics import get_registry

        registry = get_registry()
    job = ledger.job
    registry.gauge_fn("goodput_fraction", ledger.goodput_fraction,
                      help="productive chip-seconds over attributed",
                      job=job)
    registry.gauge_fn("goodput_world_size",
                      lambda: ledger.world_size,
                      help="current chip-second accrual weight", job=job)
    registry.gauge_fn(
        "goodput_conservation_error_pct",
        lambda: 100.0 * ledger.conservation_error(),
        help="|attributed - integral| as % of the world-size integral",
        job=job)
    for phase in ALL_PHASES:
        registry.gauge_fn(
            "goodput_chip_seconds",
            (lambda p=phase: ledger.chip_seconds(p)),
            help="attributed chip-seconds by phase", job=job, phase=phase)
    for phase in LOST_PHASES:
        registry.gauge_fn(
            "goodput_lost_seconds",
            (lambda p=phase: ledger.chip_seconds(p)),
            help="non-productive chip-seconds by phase", job=job,
            phase=phase)
