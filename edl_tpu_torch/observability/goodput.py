"""Goodput ledger: attribute every chip-second of a job to a phase — the
part of edl_tpu.observability.goodput that the trainer's resize path and
the multi-process supervisor (runtime/multihost.py) call — and the
per-job scaling curve (:class:`ScalingCurve`, persisted in coordinator KV
by :class:`CurveStore`) that the serving scaler records each fleet's
measured (replicas → qps) points into.  The marginal-goodput allocator
that reads the curves waits for ROADMAP.md queue 1 item 11.

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

import json
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


# -- scaling curve -----------------------------------------------------------

class ScalingCurve:
    """Per-job throughput-vs-world-size curve, aggregated from
    steady-state window samples.

    Each ``(world_size, mesh_shape)`` cell keeps a running mean of the
    observed tokens/second (and MFU when reported) plus the sample
    count; :meth:`tokens_per_second` answers per world size with the
    best shape's mean — the planner cares what the job *can* do at N
    chips, and the runtime's shape policy already picks the layout.
    """

    def __init__(self, job: str = "") -> None:
        self.job = job
        #: (world_size, shape) → {"tok_s": mean, "mfu_pct": mean|None,
        #:                         "n": count}
        self._cells: dict[tuple[int, str], dict] = {}
        self._lock = threading.Lock()

    def observe(self, world_size: int, tokens_per_second: float,
                shape: str = "", mfu_pct: Optional[float] = None,
                max_samples: Optional[int] = None) -> None:
        """Fold one steady-state window sample into the curve.

        ``max_samples`` bounds the cell's effective sample count: past
        it the running mean becomes an EWMA with weight 1/max_samples,
        so a curve fed continuously (the serving capacity recorder — one
        point per scaler tick for the fleet's lifetime) tracks CURRENT
        behavior within ~max_samples ticks instead of freezing into a
        lifetime average a traffic step can never move."""
        key = (int(world_size), shape)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = {"tok_s": 0.0, "mfu_pct": None, "n": 0, "mfu_n": 0}
                self._cells[key] = cell
            n = cell["n"]
            if max_samples is not None and n >= max_samples > 0:
                cell["tok_s"] += (tokens_per_second
                                  - cell["tok_s"]) / max_samples
                cell["n"] = n + 1
                return
            cell["tok_s"] = (cell["tok_s"] * n + tokens_per_second) / (n + 1)
            if mfu_pct is not None:
                # weighted by the number of samples that actually
                # REPORTED mfu — tok/s samples without one must not
                # dilute the mean
                m = cell.get("mfu_n", 0)
                prev = cell["mfu_pct"]
                cell["mfu_pct"] = (mfu_pct if prev is None
                                   else (prev * m + mfu_pct) / (m + 1))
                cell["mfu_n"] = m + 1
            cell["n"] = n + 1

    def world_sizes(self) -> list[int]:
        with self._lock:
            return sorted({ws for ws, _ in self._cells})

    def sample_count(self) -> int:
        with self._lock:
            return sum(c["n"] for c in self._cells.values())

    def tokens_per_second(self, world_size: int) -> Optional[float]:
        """Best mean tok/s observed at ``world_size`` across shapes."""
        with self._lock:
            vals = [c["tok_s"] for (ws, _), c in self._cells.items()
                    if ws == world_size]
            return max(vals) if vals else None

    def nearest_world_size(self, world_size: int) -> Optional[int]:
        """The measured size a question about ``world_size`` should be
        answered from: the largest measured size ≤ it, else the smallest
        measured size (an extrapolating reader must know it is reading
        the curve's edge — the returned size says which point ruled)."""
        sizes = self.world_sizes()
        if not sizes:
            return None
        smaller = [ws for ws in sizes if ws <= world_size]
        return max(smaller) if smaller else min(sizes)

    def marginal_tokens_per_second_per_chip(self, world_size: int
                                            ) -> Optional[float]:
        """The scheduler's number: d(throughput)/d(chips) at
        ``world_size``, as the slope from the nearest smaller measured
        size (average tok/s per chip when ``world_size`` is the smallest
        measured point — the first chips have no smaller anchor)."""
        here = self.tokens_per_second(world_size)
        if here is None:
            return None
        smaller = [ws for ws in self.world_sizes() if ws < world_size]
        if not smaller:
            return here / world_size if world_size else None
        prev = max(smaller)
        prev_tok = self.tokens_per_second(prev)
        if prev_tok is None:  # pragma: no cover - sizes imply samples
            return None
        return (here - prev_tok) / (world_size - prev)

    # -- (de)serialization — the KV wire format ------------------------------

    def to_json(self) -> str:
        with self._lock:
            cells = [{"world_size": ws, "shape": sh, **c}
                     for (ws, sh), c in sorted(self._cells.items())]
        return json.dumps({"job": self.job, "version": 1, "cells": cells})

    @classmethod
    def from_json(cls, raw: str) -> "ScalingCurve":
        doc = json.loads(raw)
        curve = cls(job=doc.get("job", ""))
        for cell in doc.get("cells", []):
            key = (int(cell["world_size"]), cell.get("shape", ""))
            curve._cells[key] = {
                "tok_s": float(cell["tok_s"]),
                "mfu_pct": cell.get("mfu_pct"),
                "n": int(cell.get("n", 1)),
                # older blobs without the count: one sample iff a mean
                # exists (keeps the weighting sane across re-loads)
                "mfu_n": int(cell.get(
                    "mfu_n", 1 if cell.get("mfu_pct") is not None else 0)),
            }
        return curve

    def summary(self) -> dict:
        """world_size → mean tok/s (artifact/log form)."""
        return {ws: round(self.tokens_per_second(ws), 1)
                for ws in self.world_sizes()}


#: KV key template the curve persists under — a plain coordinator KV key,
#: so it streams to the HA standby with every other mutation and is
#: GC-exempt (not per-generation; prune_generations never touches it)
CURVE_KEY = "goodput-curve/{job}"


class CurveStore:
    """Persist one job's :class:`ScalingCurve` in coordinator KV.

    The local curve is authoritative for this writer (one driver per job
    records windows); every :meth:`record` folds the sample in and
    republishes the whole JSON under ``goodput-curve/<job>`` — small
    (one cell per (size, shape)), idempotent, and riding the coordinator's
    persistence + HA replication, which is what makes the curve survive
    both trainer restarts and a primary failover.  Readers (autoscaler,
    tooling) use :meth:`load` against any coordinator endpoint.
    """

    def __init__(self, coord, job: str, registry=None) -> None:
        self._coord = coord
        self.job = job
        self.curve = ScalingCurve(job=job)
        self._registry = registry

    @property
    def key(self) -> str:
        return CURVE_KEY.format(job=self.job)

    def record(self, world_size: int, tokens_per_second: float,
               shape: str = "", mfu_pct: Optional[float] = None,
               max_samples: Optional[int] = None) -> None:
        """Fold a steady-state sample in, persist, refresh the gauges."""
        # calibration (best-effort, no-op unarmed): what the curve
        # PREDICTED this world size delivers — the number the goodput
        # planner granted chips on — vs the steady-state window now
        # measured at that size, paired BEFORE the sample folds in
        pred = self.curve.tokens_per_second(world_size)
        if pred is not None:
            from edl_tpu_torch.observability import calib

            calib.record("goodput_curve", pred, tokens_per_second,
                         unit="tok/s", job=self.job,
                         world_size=world_size)
        self.curve.observe(world_size, tokens_per_second, shape=shape,
                           mfu_pct=mfu_pct, max_samples=max_samples)
        self._coord.kv_set(self.key, self.curve.to_json().encode())
        self._sync_metrics()

    def load(self) -> Optional[ScalingCurve]:
        """The persisted curve, from whichever coordinator answers."""
        raw = self._coord.kv_get(self.key)
        if not raw:
            return None
        try:
            return ScalingCurve.from_json(raw.decode())
        except (ValueError, KeyError):
            return None

    def _sync_metrics(self) -> None:
        """Curve cells as real gauges (set on record, labels dynamic):
        ``edl_goodput_curve_tokens_per_second{job=,world_size=}`` and the
        marginal-throughput-per-chip series the scheduler will read."""
        registry = self._registry
        if registry is None:
            from edl_tpu_torch.observability.metrics import get_registry

            registry = get_registry()
        tok = registry.gauge("goodput_curve_tokens_per_second",
                             help="per-job throughput curve sample mean")
        marg = registry.gauge(
            "goodput_marginal_tokens_per_second_per_chip",
            help="marginal throughput per added chip at world_size")
        for ws in self.curve.world_sizes():
            tok.set(self.curve.tokens_per_second(ws),
                    job=self.job, world_size=ws)
            m = self.curve.marginal_tokens_per_second_per_chip(ws)
            if m is not None:
                marg.set(m, job=self.job, world_size=ws)


def load_curve(coord, job: str) -> Optional[ScalingCurve]:
    """Read-only curve fetch (the autoscaler/tooling side of CurveStore)."""
    return CurveStore(coord, job).load()
