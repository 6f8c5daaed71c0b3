"""Goodput ledger: attribute every chip-second of a job to a phase — the
part of edl_tpu.observability.goodput that the trainer's resize path calls.

A :class:`GoodputLedger` attributes wall-clock time, weighted by the world
size holding chips, to its accruing phase; durations measured elsewhere
(a resize's compile, replan and reshard windows) are moved into their
phase afterwards with :meth:`GoodputLedger.note_span`, a transfer between
phases that cannot break the conservation invariant

    Σ_phase attributed_chip_seconds  ==  ∫ world_size dt.

The trainer feeds the process ledger through the module-level
:func:`note_span` and :func:`set_world_size`, which are no-ops until one is
installed with :func:`set_process_ledger`.
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
        self._last = now          # attribution accrual timestamp
        self._integral_t = now    # independent conservation-integral stamp
        self._world = max(int(world_size), 0)
        self._attributed: dict[str, float] = {p: 0.0 for p in ALL_PHASES}
        self._phase = base_phase  # the reference's phase stack, unentered
        self._integral = 0.0      # ∫ world_size dt, chip-seconds

    def _accrue_locked(self, now: float) -> None:
        """Attribute the elapsed window to the accruing phase AND advance
        the independent integral — two code paths over the same clock
        reads, so a skipped accrual makes them diverge."""
        dt = now - self._last
        if dt > 0:
            self._attributed[self._phase] += dt * self._world
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
            src = self._phase
            if src == phase:
                return 0.0
            ws = self._world if world_size is None else max(int(world_size), 0)
            move = min(seconds * ws, self._attributed[src])
            self._attributed[src] -= move
            self._attributed[phase] += move
            return move

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


def set_world_size(n: int) -> None:
    led = _process_ledger
    if led is not None:
        try:
            led.set_world_size(n)
        except Exception:
            pass
