"""Calibration plane: a predicted-vs-measured ledger for every cost
model in the stack — the port's copy of edl_tpu.observability.calib.

A :class:`CalibrationLedger` pairs every prediction with its measured
outcome: ``record(predictor, predicted, measured, unit, **labels)`` feeds a
per-predictor bounded sample ring, an ``edl_calibration_error_pct{predictor=}``
histogram, and a running ``edl_calibration_factor{predictor=}`` gauge
(measured/predicted, EWMA-smoothed).  With a coordinator (``coord=``) each
predictor's record is also persisted to KV ``calib/<job>/<predictor>``, so
factors survive a coordinator failover and outlive any one process.

Instrumented predictors:

======================  =====================================================
``reshard_seconds``     a trainer resize: its planned bytes at the nominal
                        fabric rate vs its measured reshard
``kv_move_seconds``     a decode KV move priced at the nominal fabric rate vs
                        its measured placement
``spec_accept``         the drafter's acceptance EWMA vs the realized tokens
                        per verify step
``interleave_decode_ms``   the token scheduler's decode-iteration EWMA vs the
                        measured iteration
``interleave_prefill_ms``  the same for the prefill chunk
``serving_scale_qps``   the scaler's predicted post-scale fleet qps vs the
                        settled window
``serving_scale_p99``   the scaler's predicted post-scale p99 vs the settled
                        window
``goodput_curve``       a curve's predicted tok/s at a world size vs the next
                        window recorded there
======================  =====================================================

Every site calls the module-level :func:`record`, a no-op until a ledger is
armed with :func:`set_process_calib`.  The read-back side is opt-in:
:class:`CalibrationFactors` caches a job's persisted factors, so the
goodput allocator (``planner.scale_all_jobs_goodput(calibration=)``) can
scale its curve-derived marginals by what reality measured.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

#: KV key template one predictor's factor record persists under — a
#: plain coordinator KV key under the job-scoped ``calib/`` prefix
#: (swept by coord/gc.py on job deletion), so it streams to the HA
#: standby with every other mutation
CALIB_KEY = "calib/{job}/{predictor}"

#: error_pct histogram buckets: a well-calibrated predictor lands in the
#: single digits; the tail buckets catch order-of-magnitude misses
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
    """The prior a byte-priced move predicts from: planned bytes over
    the nominal per-path bandwidth (both paths summed — the plan's hops
    serialize through the same ``device_put``)."""
    if host:
        return (bytes_ici + bytes_dcn) / (NOMINAL_HOST_GBPS * 1e9)
    return (bytes_ici / (NOMINAL_ICI_GBPS * 1e9)
            + bytes_dcn / (NOMINAL_DCN_GBPS * 1e9))


class CalibrationLedger:
    """Per-job predicted-vs-measured ledger.

    Thread-safe and cheap: every :meth:`record` is a ring append, an
    EWMA update, and two metric touches under one lock; KV publication
    (when a coordinator is wired) is one ``kv_set`` of a small JSON
    blob, the same cost profile as the goodput CurveStore.

    ``ewma_alpha`` weights the running factor toward recent samples —
    a factor is a *current* correction, not a lifetime average a
    hardware change could never move.  ``ring_size`` bounds every
    per-predictor sample ring (edge case: a predictor recording every
    decode iteration for a week must not grow memory without end).
    """

    def __init__(self, job: str = "", coord=None, ring_size: int = 256,
                 ewma_alpha: float = 0.1, registry=None) -> None:
        self.job = job
        self._coord = coord
        self.ring_size = max(int(ring_size), 1)
        self._alpha = min(max(float(ewma_alpha), 0.001), 1.0)
        self._registry = registry
        self._lock = threading.Lock()
        #: predictor → bounded ring of (predicted, measured, error_pct)
        self._rings: dict[str, deque] = {}
        #: predictor → {"factor", "n", "zero", "unit", "last_*"}
        self._state: dict[str, dict] = {}

    # -- recording -----------------------------------------------------------

    def record(self, predictor: str, predicted: float, measured: float,
               unit: str = "", **labels) -> Optional[float]:
        """Pair one prediction with its measured outcome; returns the
        absolute error percentage, or None when the prediction was
        unusable (zero/negative/non-finite — counted, never divided
        by: a cost model that predicts nothing moved while something
        did is itself a calibration finding)."""
        predicted = float(predicted)
        measured = float(measured)
        reg = self._reg()
        if (not predicted > 0.0 or measured < 0.0
                or predicted != predicted or measured != measured):
            with self._lock:
                st = self._state_locked(predictor, unit)
                st["zero"] += 1
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
            ring = self._rings[predictor]
            ring.append((predicted, measured, error_pct))
            st["n"] += 1
            st["factor"] = (factor if st["factor"] is None
                            else self._alpha * factor
                            + (1 - self._alpha) * st["factor"])
            st["last_predicted"] = predicted
            st["last_measured"] = measured
            snap = dict(st)
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
        ).set(snap["factor"], job=self.job, predictor=predictor)
        self._publish(predictor, snap, **labels)
        return error_pct

    def _state_locked(self, predictor: str, unit: str) -> dict:
        st = self._state.get(predictor)
        if st is None:
            st = {"factor": None, "n": 0, "zero": 0, "unit": unit,
                  "last_predicted": None, "last_measured": None}
            self._state[predictor] = st
            self._rings[predictor] = deque(maxlen=self.ring_size)
        elif unit and not st["unit"]:
            st["unit"] = unit
        return st

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from edl_tpu_torch.observability.metrics import get_registry

        return get_registry()

    # -- readout -------------------------------------------------------------

    def predictors(self) -> list[str]:
        with self._lock:
            return sorted(self._state)

    def factor(self, predictor: str) -> Optional[float]:
        with self._lock:
            st = self._state.get(predictor)
            return st["factor"] if st else None

    def sample_count(self, predictor: str) -> int:
        with self._lock:
            st = self._state.get(predictor)
            return st["n"] if st else 0

    def samples(self, predictor: str) -> list[tuple]:
        with self._lock:
            return list(self._rings.get(predictor, ()))

    def error_pct_quantile(self, predictor: str, q: float
                           ) -> Optional[float]:
        """Exact quantile over the predictor's ring (the RECENT error
        distribution — the ring bound is the window)."""
        with self._lock:
            ring = self._rings.get(predictor)
            if not ring:
                return None
            errs = sorted(e for _, _, e in ring)
        idx = min(int(q * len(errs)), len(errs) - 1)
        return errs[max(idx, 0)]

    def snapshot(self) -> dict:
        """Everything a flight record / bench artifact wants."""
        out: dict = {"job": self.job, "predictors": {}}
        for p in self.predictors():
            with self._lock:
                st = dict(self._state[p])
            out["predictors"][p] = {
                "factor": (round(st["factor"], 4)
                           if st["factor"] is not None else None),
                "samples": st["n"],
                "zero_predictions": st["zero"],
                "unit": st["unit"],
                "error_pct_p50": _round(self.error_pct_quantile(p, 0.50)),
                "error_pct_p99": _round(self.error_pct_quantile(p, 0.99)),
                "last_predicted": st["last_predicted"],
                "last_measured": st["last_measured"],
            }
        return out

    # -- KV persistence ------------------------------------------------------

    def key(self, predictor: str) -> str:
        return CALIB_KEY.format(job=self.job, predictor=predictor)

    def _publish(self, predictor: str, st: dict, **labels) -> None:
        """Republish this predictor's whole factor record (small,
        idempotent — the CurveStore discipline) under its own key, so a
        reader needs no merge and GC sweeps per-job.  Best-effort: a
        down coordinator must never fail the instrumented hot path."""
        if self._coord is None:
            return
        doc = {
            "version": 1, "job": self.job, "predictor": predictor,
            "unit": st["unit"],
            "factor": (round(st["factor"], 6)
                       if st["factor"] is not None else None),
            "n": st["n"], "zero_predictions": st["zero"],
            "error_pct_p50": _round(self.error_pct_quantile(predictor,
                                                            0.50)),
            "error_pct_p99": _round(self.error_pct_quantile(predictor,
                                                            0.99)),
            "last_predicted": st["last_predicted"],
            "last_measured": st["last_measured"],
        }
        if labels:
            doc["labels"] = {k: str(v) for k, v in labels.items()}
        try:
            self._coord.kv_set(self.key(predictor),
                               json.dumps(doc).encode())
        except Exception:
            pass  # calibration must never fail the runtime


def _round(v: Optional[float], nd: int = 3) -> Optional[float]:
    return round(v, nd) if v is not None else None


# -- read-back ---------------------------------------------------------------


def load_factor(coord, job: str, predictor: str) -> Optional[dict]:
    """One predictor's persisted factor record, from whichever
    coordinator answers (primary or promoted standby)."""
    raw = coord.kv_get(CALIB_KEY.format(job=job, predictor=predictor))
    if not raw:
        return None
    try:
        doc = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def load_factors(coord, job: str) -> dict[str, dict]:
    """Every persisted predictor record for ``job`` (prefix scan)."""
    prefix = f"calib/{job}/"
    out: dict[str, dict] = {}
    try:
        keys = coord.kv_keys(prefix)
    except Exception:
        return out
    for key in keys:
        doc = None
        raw = coord.kv_get(key)
        if raw:
            try:
                doc = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                doc = None
        if isinstance(doc, dict):
            out[key[len(prefix):]] = doc
    return out


class CalibrationFactors:
    """The opt-in read-back hook: a cached view of a job's persisted
    calibration factors, for estimate producers that want to price with
    reality's correction — ``choose_shape`` scaling its per-path
    transfer costs, the goodput allocator scaling its optimistic prior.

    ``factor(predictor)`` answers from a cache refreshed at most every
    ``refresh_s`` (one KV prefix scan); a missing/unreadable record, an
    unsampled predictor, or a dead coordinator all answer the neutral
    1.0 — read-back is an optimization, never a dependency.  Factors
    are clamped to ``[min_factor, max_factor]``: a half-broken record
    must not multiply an estimate by a million."""

    def __init__(self, coord, job: str, refresh_s: float = 10.0,
                 min_samples: int = 3, min_factor: float = 0.05,
                 max_factor: float = 20.0,
                 clock=time.monotonic) -> None:
        self._coord = coord
        self.job = job
        self.refresh_s = float(refresh_s)
        self.min_samples = int(min_samples)
        self.min_factor = float(min_factor)
        self.max_factor = float(max_factor)
        self._clock = clock
        self._lock = threading.Lock()
        self._cache: dict[str, dict] = {}
        self._fetched_at: Optional[float] = None

    def _refresh_locked(self) -> None:
        now = self._clock()
        if (self._fetched_at is not None
                and now - self._fetched_at < self.refresh_s):
            return
        try:
            self._cache = load_factors(self._coord, self.job)
        except Exception:
            pass  # keep the previous cache; read-back degrades to stale
        self._fetched_at = now

    def factor(self, predictor: str, default: float = 1.0) -> float:
        with self._lock:
            self._refresh_locked()
            doc = self._cache.get(predictor)
        if not doc:
            return default
        f = doc.get("factor")
        if not isinstance(f, (int, float)) or not f > 0.0:
            return default
        if doc.get("n", 0) < self.min_samples:
            return default
        return min(max(float(f), self.min_factor), self.max_factor)

    def scale(self, predictor: str, estimate: float) -> float:
        """``estimate × measured/predicted`` — the calibrated estimate."""
        return estimate * self.factor(predictor)


# -- process ledger ----------------------------------------------------------
#
# One ledger per process, armed by whoever owns the job's lifecycle (a
# bench harness, the CI smoke, a deployment's worker main); the
# instrumentation sites below feed it best-effort through record(), so
# wiring is zero-config: no ledger armed → every helper is a no-op and
# no instrumented hot path anywhere slows down or fails.

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
    """Best-effort predicted-vs-measured pair on the process ledger."""
    led = _process_calib
    if led is not None:
        try:
            led.record(predictor, predicted, measured, unit=unit,
                       **labels)
        except Exception:
            pass  # calibration must never fail the runtime
