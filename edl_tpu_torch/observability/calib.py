"""Calibration plane: a predicted-vs-measured ledger for the cost models
the decode serving plane and the trainer's resize run on — the part of
edl_tpu.observability.calib that they call.

Instrumented predictors: ``reshard_seconds`` (a resize's planned bytes at
the nominal rate vs its measured reshard), ``kv_move_seconds`` (a D2D KV
move priced at the nominal fabric rate vs its measured placement),
``spec_accept`` (the drafter's acceptance EWMA vs the realized tokens per
verify step),
``interleave_decode_ms`` and ``interleave_prefill_ms`` (the token
scheduler's EWMAs vs the measured iteration).  Every site calls the
module-level :func:`record`, a no-op until a ledger is armed with
:func:`set_process_calib`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from edl_tpu_torch.observability.metrics import MetricsRegistry, get_registry

#: error_pct histogram buckets
ERROR_PCT_BUCKETS = [1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     1000.0]

#: nominal fabric bandwidths the byte-priced predictors start from (the
#: JAX package's priors, kept so factors compare across the two); the
#: calibration factor is the measured correction on top
NOMINAL_ICI_GBPS = 90.0
NOMINAL_DCN_GBPS = 6.25
NOMINAL_HOST_GBPS = 8.0


def nominal_transfer_seconds(bytes_ici: float, bytes_dcn: float = 0.0,
                             host: bool = False) -> float:
    """Planned bytes over the nominal per-path bandwidth (both paths
    summed)."""
    if host:
        return (bytes_ici + bytes_dcn) / (NOMINAL_HOST_GBPS * 1e9)
    return (bytes_ici / (NOMINAL_ICI_GBPS * 1e9)
            + bytes_dcn / (NOMINAL_DCN_GBPS * 1e9))


class CalibrationLedger:
    """Per-job predicted-vs-measured ledger: a bounded sample ring per
    predictor, an ``edl_calibration_error_pct{predictor=}`` histogram and
    a running ``edl_calibration_factor{predictor=}`` gauge
    (measured/predicted, EWMA-smoothed)."""

    def __init__(self, job: str = "", ring_size: int = 256,
                 ewma_alpha: float = 0.1,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.job = job
        self.ring_size = max(int(ring_size), 1)
        self._alpha = min(max(float(ewma_alpha), 0.001), 1.0)
        self._registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        #: predictor → bounded ring of (predicted, measured, error_pct)
        self._rings: dict[str, deque] = {}
        #: predictor → {"factor", "n", "zero", "unit"}
        self._state: dict[str, dict] = {}

    def record(self, predictor: str, predicted: float, measured: float,
               unit: str = "", **labels) -> Optional[float]:
        """Pair one prediction with its measured outcome; returns the
        absolute error percentage, or None when the prediction was
        unusable (zero, negative or not finite: counted, never divided
        by)."""
        predicted = float(predicted)
        measured = float(measured)
        reg = self._registry
        if (not predicted > 0.0 or measured < 0.0
                or predicted != predicted or measured != measured):
            with self._lock:
                self._state_locked(predictor, unit)["zero"] += 1
            reg.counter(
                "calibration_zero_predictions",
                help="predictions unusable for calibration "
                     "(zero/negative/NaN predicted value)").inc(
                1, job=self.job, predictor=predictor)
            return None
        factor = measured / predicted
        error_pct = abs(measured - predicted) / predicted * 100.0
        with self._lock:
            st = self._state_locked(predictor, unit)
            self._rings[predictor].append((predicted, measured, error_pct))
            st["n"] += 1
            st["factor"] = (factor if st["factor"] is None
                            else self._alpha * factor
                            + (1 - self._alpha) * st["factor"])
            current = st["factor"]
        reg.counter(
            "calibration_samples",
            help="predicted-vs-measured pairs recorded per predictor"
        ).inc(1, job=self.job, predictor=predictor)
        reg.histogram(
            "calibration_error_pct",
            help="abs(measured-predicted)/predicted per prediction, %",
            buckets=ERROR_PCT_BUCKETS,
        ).observe(error_pct, job=self.job, predictor=predictor)
        reg.gauge(
            "calibration_factor",
            help="running measured/predicted correction per predictor "
                 "(EWMA; 1.0 = the cost model is honest)"
        ).set(current, job=self.job, predictor=predictor)
        return error_pct

    def _state_locked(self, predictor: str, unit: str) -> dict:
        st = self._state.get(predictor)
        if st is None:
            st = {"factor": None, "n": 0, "zero": 0, "unit": unit}
            self._state[predictor] = st
            self._rings[predictor] = deque(maxlen=self.ring_size)
        return st

    def factor(self, predictor: str) -> Optional[float]:
        with self._lock:
            st = self._state.get(predictor)
            return st["factor"] if st else None

    def sample_count(self, predictor: str) -> int:
        with self._lock:
            st = self._state.get(predictor)
            return st["n"] if st else 0


_process_calib: Optional[CalibrationLedger] = None
_process_lock = threading.Lock()


def set_process_calib(ledger: Optional[CalibrationLedger]
                      ) -> Optional[CalibrationLedger]:
    """Install (or clear, with None) the process-wide ledger; returns it."""
    global _process_calib
    with _process_lock:
        _process_calib = ledger
    return ledger


def get_process_calib() -> Optional[CalibrationLedger]:
    return _process_calib


def record(predictor: str, predicted, measured, unit: str = "",
           **labels) -> None:
    """Best-effort predicted-vs-measured pair on the process ledger: a
    no-op until one is armed, and a failure to record never fails the
    caller."""
    led = _process_calib
    if led is not None:
        try:
            led.record(predictor, predicted, measured, unit=unit, **labels)
        except Exception:
            pass  # calibration must never fail the runtime
