"""Fleet scrape plane: pull-based metrics aggregation over every
``/metrics`` the port serves — the port's copy of
edl_tpu.observability.scrape, both halves.

The publishing half: a process that serves ``/metrics`` (a serving
replica, a multi-process supervisor) publishes its bound address under a
coordinator KV key with an expiry stamp in the value (plain KV has no
TTL), refreshed by :class:`AddrPublisher` so the key outlives exactly its
publisher.

The consuming half:

* :class:`MetricsScraper` — discovers targets dynamically (coordinator
  KV ``metrics-addr-*`` / ``serving-metrics-addr/*`` keys, supervisor
  address files, ``prometheus.io`` annotations on manifests, static
  lists), polls each target's ``/metrics`` on a jittered interval with a
  per-target timeout, exponential backoff and staleness marking, parses
  with the strict :func:`~edl_tpu_torch.observability.metrics.
  iter_samples` grammar, and keeps bounded per-series rings that answer
  windowed rate / delta / sum-by-label / histogram-quantile queries,
  plus the trace-id exemplars the serving data plane attaches to its
  latency buckets (slowest first from ``exemplars()``).
* :class:`FleetView` — per-job and fleet-wide rollups of the scraped
  ``edl_serving_*`` / ``edl_goodput_*`` / ``edl_coord_*`` series.  Its
  :meth:`FleetView.stats_for` is the signal
  :class:`~edl_tpu_torch.scheduler.autoscaler.ServingScaler` consumes
  through ``feed_from(view)``.
* :class:`AlertEngine` — rule evaluation over the view: SLO burn-rate
  (fast/slow multi-window), goodput-fraction collapse, scrape-target
  down, conservation violation, calibration drift.  Firing rules land in
  ``edl_alerts_firing{rule=}`` gauges, ``edl_alerts_fired_total``
  counters, trace instants, and flight records.

:func:`render_fleet_dashboard` and :func:`render_calib_dashboard` are the
one-screen text views ``python -m edl_tpu_torch.cli fleet`` and ``calib``
print.
"""

from __future__ import annotations

import math
import random
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (
    dump_flight_record, get_registry, iter_samples,
)
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("observability.scrape")

#: coordinator-KV prefix serving replicas publish their /metrics address
#: under (``serving-metrics-addr/<job>/<replica>``); TTL'd via an expiry
#: stamp in the value, refreshed by :class:`AddrPublisher`, swept with
#: the job's other KV state by coord/gc.py JOB_KV_PREFIXES
SERVING_METRICS_ADDR_PREFIX = "serving-metrics-addr/"
#: coordinator-KV key prefix multihost supervisors publish under
#: (``metrics-addr-<member>``) — the KV twin of the ckpt-dir address file
SUPERVISOR_METRICS_ADDR_PREFIX = "metrics-addr-"
#: default publication TTL: a crashed publisher's key stops being a
#: target within this window even though plain KV has no expiry
DEFAULT_ADDR_TTL_S = 30.0


def format_addr_value(addr: str, ttl_s: Optional[float]) -> bytes:
    """KV value for a published /metrics address: ``host:port`` plus an
    optional unix-time expiry stamp (how the scrape plane TTLs keys on a
    KV store that has none)."""
    if ttl_s is None:
        return addr.encode()
    return f"{addr} {time.time() + ttl_s:.3f}".encode()


def parse_addr_value(value: bytes) -> tuple[Optional[str], bool]:
    """``(addr, expired)`` from a published value; addr None when the
    value is unparseable."""
    try:
        parts = value.decode().split()
    except UnicodeDecodeError:
        return None, True
    if not parts or ":" not in parts[0]:
        return None, True
    if len(parts) > 1:
        try:
            if time.time() > float(parts[1]):
                return parts[0], True
        except ValueError:
            pass
    return parts[0], False


@dataclass
class ScrapeTarget:
    """One /metrics endpoint: a stable name, an address, and the labels
    every series scraped from it is attributed with (``job=``,
    ``role=``)."""

    name: str
    addr: str
    path: str = "/metrics"
    labels: dict = field(default_factory=dict)
    #: "static" targets persist for the scraper's life; "discovered"
    #: targets are owned by their discovery source and dropped after it
    #: stops returning them
    source: str = "static"

    def key(self) -> tuple[str, str]:
        return (self.addr, self.path)

    def url(self) -> str:
        return f"http://{self.addr}{self.path}"


class _TargetState:
    __slots__ = ("added_t", "last_attempt_t", "last_success_t",
                 "consecutive_failures", "next_due_t", "last_error",
                 "missing_sweeps", "scrapes", "errors")

    def __init__(self, now: float) -> None:
        self.added_t = now
        self.last_attempt_t: Optional[float] = None
        self.last_success_t: Optional[float] = None
        self.consecutive_failures = 0
        self.next_due_t = now  # due immediately
        self.last_error = ""
        self.missing_sweeps = 0
        self.scrapes = 0
        self.errors = 0


class _Ring:
    """One series' bounded time-series ring: (t, value) samples."""

    __slots__ = ("samples",)

    def __init__(self, retention: int) -> None:
        self.samples: "deque[tuple[float, float]]" = deque(maxlen=retention)


class MetricsScraper:
    """Pull-based aggregator over a dynamic target set (module
    docstring).  Drive it with :meth:`sweep` (deterministic, what tests
    and the CLI's ``--once`` use) or :meth:`start` (jittered background
    loop).

    ``discover`` is a sequence of callables, each returning the CURRENT
    list of :class:`ScrapeTarget` for its source (coordinator KV,
    address files, manifest annotations — see :func:`kv_targets`,
    :func:`file_targets`, :func:`manifest_targets`).  A discovered
    target its source stops returning is dropped after
    ``forget_after_sweeps`` sweeps; statically added targets persist.

    Failure policy per target: one failed scrape starts exponential
    backoff (``backoff_base_s × 2^(failures-1)``, capped at
    ``backoff_max_s``) so a dead endpoint costs one timeout per backoff
    window, not per sweep; targets are scraped CONCURRENTLY inside a
    sweep, so one black-holed endpoint delays the sweep by at most
    ``timeout_s`` and never starves healthy targets of their interval.
    A target whose last success is older than ``stale_after_s`` is
    marked stale — queries still serve its last-known samples (windowed
    queries age them out naturally), and the staleness is visible to
    :class:`AlertEngine`'s target-down rule and the dashboard.
    """

    def __init__(
        self,
        targets: Iterable[ScrapeTarget] = (),
        discover: Sequence[Callable[[], Iterable[ScrapeTarget]]] = (),
        *,
        interval_s: float = 1.0,
        jitter_frac: float = 0.2,
        timeout_s: float = 2.0,
        backoff_base_s: Optional[float] = None,
        backoff_max_s: float = 30.0,
        stale_after_s: Optional[float] = None,
        forget_after_sweeps: int = 5,
        retention: int = 512,
        registry=None,
        fetch: Optional[Callable[[ScrapeTarget], str]] = None,
        clock: Callable[[], float] = time.monotonic,
        seed: int = 0,
    ) -> None:
        self.interval_s = max(float(interval_s), 0.01)
        self.jitter_frac = min(max(float(jitter_frac), 0.0), 0.9)
        self.timeout_s = float(timeout_s)
        self.backoff_base_s = (float(backoff_base_s)
                               if backoff_base_s is not None
                               else self.interval_s)
        self.backoff_max_s = float(backoff_max_s)
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else 3.0 * self.interval_s + self.timeout_s)
        self.forget_after_sweeps = max(int(forget_after_sweeps), 1)
        self.retention = max(int(retention), 8)
        self._discover = list(discover)
        self._fetch = fetch if fetch is not None else self._http_fetch
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._targets: dict[tuple, ScrapeTarget] = {}
        self._state: dict[tuple, _TargetState] = {}
        #: metric name → {(label items, target key) → ring}
        self._series: dict[str, dict[tuple, _Ring]] = {}
        #: histogram exemplars (trace ids riding bucket samples):
        #: family name → {(labels-sans-le, target key) → deque of
        #: (ingest_t, exemplar labels, value)} — keyed per target so a
        #: dead pod's exemplars age out WITH its series
        self._exemplars: dict[str, dict[tuple, "deque"]] = {}
        self.sweeps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registry = registry if registry is not None else get_registry()
        self._sweep_hist = self._registry.histogram(
            "scrape_sweep_seconds",
            help="wall time of one scrape sweep across all due targets")
        self._stale_hist = self._registry.histogram(
            "scrape_staleness_seconds",
            help="age of a target's data at the moment it was refreshed")
        self.register_metrics(self._registry)
        for t in targets:
            self.add_target(t)

    # -- target management ---------------------------------------------------

    def add_target(self, target: ScrapeTarget) -> None:
        with self._lock:
            key = target.key()
            if key not in self._state:
                self._state[key] = _TargetState(self._clock())
            self._targets[key] = target

    def remove_target(self, target: ScrapeTarget) -> None:
        with self._lock:
            self._drop_target_locked(target.key())

    def _drop_target_locked(self, key: tuple) -> None:
        """Remove a target AND its series rings: a dead pod's final
        gauge samples must not be summed into latest() rollups forever,
        and target churn (ephemeral ports) must not grow the ring store
        without bound."""
        self._targets.pop(key, None)
        self._state.pop(key, None)
        for name in list(self._series):
            fam = self._series[name]
            for lkey in [k for k in fam if k[1] == key]:
                del fam[lkey]
            if not fam:
                del self._series[name]
        for name in list(self._exemplars):
            fam = self._exemplars[name]
            for lkey in [k for k in fam if k[1] == key]:
                del fam[lkey]
            if not fam:
                del self._exemplars[name]

    def targets(self) -> list[ScrapeTarget]:
        with self._lock:
            return list(self._targets.values())

    def stale(self, target: ScrapeTarget) -> bool:
        with self._lock:
            st = self._state.get(target.key())
        if st is None:
            return True
        anchor = (st.last_success_t if st.last_success_t is not None
                  else st.added_t)
        return self._clock() - anchor > self.stale_after_s

    def target_states(self) -> list[dict]:
        """One dict per target for dashboards/alerting: name, labels,
        health verdict (``up`` / ``stale`` / ``down``), failure streak,
        staleness."""
        now = self._clock()
        out = []
        with self._lock:
            items = [(t, self._state[k]) for k, t in self._targets.items()]
        for t, st in items:
            anchor = (st.last_success_t if st.last_success_t is not None
                      else st.added_t)
            staleness = now - anchor
            if st.last_success_t is not None and st.consecutive_failures == 0 \
                    and staleness <= self.stale_after_s:
                verdict = "up"
            elif staleness > self.stale_after_s:
                verdict = "down" if st.consecutive_failures else "stale"
            else:
                verdict = "stale"
            out.append({
                "name": t.name, "addr": t.addr, "labels": dict(t.labels),
                "state": verdict, "staleness_s": round(staleness, 3),
                "consecutive_failures": st.consecutive_failures,
                "scrapes": st.scrapes, "errors": st.errors,
                "last_error": st.last_error,
            })
        return out

    def _run_discovery(self) -> None:
        seen: set[tuple] = set()
        # a RAISING source (coordinator blip) must FREEZE its targets,
        # not age them toward forgetting: otherwise a transient outage
        # silently drops the whole discovered fleet — and with the
        # targets gone, TargetDownRule stops reporting and the down
        # alerts implicitly resolve while everything is dark
        sources_ok = True
        for fn in self._discover:
            try:
                found = list(fn())
            except Exception as exc:  # a dead source must not kill sweeps
                log.warn("scrape discovery source failed",
                         error=str(exc)[:200])
                get_counters().inc("scrape_discovery_errors")
                sources_ok = False
                continue
            for t in found:
                t.source = "discovered"
                seen.add(t.key())
                self.add_target(t)
        if not self._discover:
            return
        with self._lock:
            for key, t in list(self._targets.items()):
                if t.source != "discovered":
                    continue
                st = self._state[key]
                if key in seen:
                    st.missing_sweeps = 0
                elif sources_ok:
                    st.missing_sweeps += 1
                    if st.missing_sweeps >= self.forget_after_sweeps:
                        self._drop_target_locked(key)

    # -- scraping ------------------------------------------------------------

    def _http_fetch(self, target: ScrapeTarget) -> str:
        with urllib.request.urlopen(target.url(),
                                    timeout=self.timeout_s) as r:
            return r.read().decode()

    def _scrape_one(self, target: ScrapeTarget) -> Optional[str]:
        """Fetch + parse + ingest one target; returns an error string on
        failure, None on success."""
        now = self._clock()
        exem: list = []
        try:
            text = self._fetch(target)
            samples = iter_samples(text, exemplars=exem)
        except Exception as exc:
            return f"{type(exc).__name__}: {str(exc)[:120]}"
        t_ingest = self._clock()
        with self._lock:
            st = self._state.get(target.key())
            if st is None:  # removed mid-scrape
                return None
            prev_success = st.last_success_t
            if prev_success is not None:
                self._stale_hist.observe(now - prev_success)
            for name, labels, value in samples:
                fam = self._series.setdefault(name, {})
                lkey = (tuple(sorted(labels.items())), target.key())
                ring = fam.get(lkey)
                if ring is None:
                    ring = fam[lkey] = _Ring(self.retention)
                    if prev_success is not None:
                        # a series BORN under observation (a new label
                        # set appearing on an already-scraped target —
                        # the first request of a job, a new phase):
                        # anchor it at zero as of the previous scrape so
                        # windowed deltas/rates count its birth value as
                        # the increase it is, instead of needing a
                        # second sample to start moving
                        ring.samples.append((prev_success, 0.0))
                ring.samples.append((t_ingest, value))
            for name, labels, ex_labels, ex_value, _ex_ts in exem:
                # exemplars ride _bucket sample lines; store under the
                # base family, without the bucket's le label
                if name.endswith("_bucket"):
                    name = name[:-len("_bucket")]
                lkey = (tuple(sorted((k, v) for k, v in labels.items()
                                     if k != "le")), target.key())
                ring = self._exemplars.setdefault(name, {}).get(lkey)
                if ring is None:
                    ring = self._exemplars[name][lkey] = deque(maxlen=8)
                # an exemplar still exposed on re-scrape stays FRESH
                # (timestamp refreshed in place); it only ages once the
                # target stops exposing — or stops answering — it
                for e in list(ring):
                    if e[1] == ex_labels and e[2] == ex_value:
                        ring.remove(e)
                        break
                ring.append((t_ingest, ex_labels, ex_value))
            st.last_success_t = t_ingest
            st.consecutive_failures = 0
            st.next_due_t = t_ingest + self.interval_s
            st.last_error = ""
            st.scrapes += 1
        get_counters().inc("scrape_samples", len(samples))
        return None

    def sweep(self) -> dict:
        """One pass: refresh discovery, scrape every DUE target
        concurrently, apply backoff to failures.  Returns a report the
        CLI/bench print."""
        t0 = self._clock()
        self._run_discovery()
        now = self._clock()
        with self._lock:
            due = [t for k, t in self._targets.items()
                   if self._state[k].next_due_t <= now]
        errors: dict[tuple, str] = {}
        err_lock = threading.Lock()

        def work(t: ScrapeTarget) -> None:
            err = self._scrape_one(t)
            if err is not None:
                with err_lock:
                    errors[t.key()] = err

        threads = [threading.Thread(target=work, args=(t,), daemon=True,
                                    name=f"scrape-{t.addr}") for t in due]
        for th in threads:
            th.start()
        deadline = self._clock() + self.timeout_s + 1.0
        for th in threads:
            th.join(max(deadline - self._clock(), 0.0))
        now = self._clock()
        failed = 0
        with self._lock:
            for t in due:
                key = t.key()
                st = self._state.get(key)
                if st is None:
                    continue
                st.last_attempt_t = now
                err = errors.get(key)
                # a thread still running past the join deadline is a
                # black-holed endpoint: treat as a failure this sweep
                if err is None and st.last_success_t is not None \
                        and st.last_success_t >= t0:
                    continue
                if err is None:
                    err = "timeout: scrape thread still running"
                failed += 1
                st.consecutive_failures += 1
                st.errors += 1
                st.last_error = err
                backoff = min(
                    self.backoff_base_s
                    * (2 ** (st.consecutive_failures - 1)),
                    self.backoff_max_s)
                st.next_due_t = now + backoff
                get_counters().inc("scrape_errors", target=t.name)
        self.sweeps += 1
        get_counters().inc("scrape_sweeps")
        dur = self._clock() - t0
        self._sweep_hist.observe(dur)
        return {"due": len(due), "scraped": len(due) - failed,
                "failed": failed, "duration_s": round(dur, 4)}

    # -- background loop -----------------------------------------------------

    def start(self) -> "MetricsScraper":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run() -> None:
            while not self._stop.is_set():
                try:
                    self.sweep()
                except Exception as exc:  # a bad sweep must not end the loop
                    log.error("scrape sweep failed", error=str(exc)[:200])
                jitter = 1.0 + self._rng.uniform(-self.jitter_frac,
                                                 self.jitter_frac)
                self._stop.wait(self.interval_s * jitter)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="metrics-scraper")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.timeout_s + 5.0)
        self._thread = None

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- query surface -------------------------------------------------------

    @staticmethod
    def _match(series_labels: tuple, labels: Optional[dict]) -> bool:
        if not labels:
            return True
        d = dict(series_labels)
        return all(d.get(k) == str(v) for k, v in labels.items())

    def _matching_rings(self, name: str, labels: Optional[dict]
                        ) -> list[tuple[tuple, _Ring]]:
        fam = self._series.get(name)
        if not fam:
            return []
        return [(lk[0], ring) for lk, ring in fam.items()
                if self._match(lk[0], labels)]

    def latest(self, name: str, labels: Optional[dict] = None,
               agg: str = "sum",
               max_age_s: Optional[float] = None) -> Optional[float]:
        """Aggregate of each matching series' most recent FRESH sample
        (``agg`` ∈ sum/min/max/avg); None when nothing matches.  A
        sample older than ``max_age_s`` (default: the scraper's
        staleness horizon) is excluded — a target that stopped
        answering must stop contributing its frozen gauges to rollups
        (a dead pod's last queue depth would otherwise block shrink
        decisions forever); pass ``max_age_s=float('inf')`` for the
        last-known-value semantics regardless of age."""
        horizon = (self.stale_after_s if max_age_s is None
                   else float(max_age_s))
        cutoff = self._clock() - horizon
        with self._lock:
            vals = [ring.samples[-1][1]
                    for _, ring in self._matching_rings(name, labels)
                    if ring.samples and ring.samples[-1][0] >= cutoff]
        if not vals:
            return None
        if agg == "min":
            return min(vals)
        if agg == "max":
            return max(vals)
        if agg == "avg":
            return sum(vals) / len(vals)
        return sum(vals)

    def _ring_delta(self, ring: _Ring, since: float
                    ) -> tuple[float, Optional[float], Optional[float]]:
        """Counter-reset-aware increase of one ring over [since, now]:
        (delta, first_t, last_t)."""
        samples = list(ring.samples)
        if not samples:
            return 0.0, None, None
        # baseline: the newest sample at-or-before the window start, so
        # an increment that straddles the boundary is attributed
        window = [s for s in samples if s[0] >= since]
        older = [s for s in samples if s[0] < since]
        if older:
            window = [older[-1]] + window
        if len(window) < 2:
            return 0.0, window[0][0] if window else None, \
                window[-1][0] if window else None
        delta = 0.0
        for (t0, v0), (t1, v1) in zip(window, window[1:]):
            if v1 >= v0:
                delta += v1 - v0
            else:  # counter reset (process restart): count from zero
                delta += v1
        return delta, window[0][0], window[-1][0]

    def delta(self, name: str, window_s: float,
              labels: Optional[dict] = None) -> float:
        """Summed counter increase over the window across matching
        series (counter-reset aware)."""
        now = self._clock()
        with self._lock:
            rings = self._matching_rings(name, labels)
            return sum(self._ring_delta(ring, now - window_s)[0]
                       for _, ring in rings)

    def rate(self, name: str, window_s: float,
             labels: Optional[dict] = None) -> float:
        """Per-second rate over the window: summed increase divided by
        the span the samples actually cover (honest under sparse
        scrapes; 0.0 with fewer than two samples)."""
        now = self._clock()
        total = 0.0
        span = 0.0
        with self._lock:
            for _, ring in self._matching_rings(name, labels):
                d, t_first, t_last = self._ring_delta(ring, now - window_s)
                total += d
                if t_first is not None and t_last is not None:
                    span = max(span, t_last - t_first)
        if span <= 0:
            return 0.0
        return total / span

    def sum_by(self, name: str, by: str, window_s: Optional[float] = None,
               labels: Optional[dict] = None) -> dict[str, float]:
        """Group matching series by one label's value: latest-sample sums
        (``window_s`` None) or windowed counter increases."""
        now = self._clock()
        out: dict[str, float] = {}
        with self._lock:
            for slabels, ring in self._matching_rings(name, labels):
                group = dict(slabels).get(by, "")
                if window_s is None:
                    if ring.samples:
                        out[group] = out.get(group, 0.0) \
                            + ring.samples[-1][1]
                else:
                    d, _, _ = self._ring_delta(ring, now - window_s)
                    out[group] = out.get(group, 0.0) + d
        return out

    def label_values(self, name: str, label: str) -> list[str]:
        with self._lock:
            fam = self._series.get(name) or {}
            return sorted({dict(lk[0]).get(label) for lk in fam
                           if dict(lk[0]).get(label) is not None})

    def histogram_quantile(self, name: str, q: float, window_s: float,
                           labels: Optional[dict] = None
                           ) -> Optional[float]:
        """Prometheus-style quantile estimate from windowed bucket
        increases of ``<name>_bucket`` series (summed across targets and
        non-``le`` labels), linearly interpolated inside the bucket.
        None when the window holds no observations."""
        now = self._clock()
        by_le: dict[float, float] = {}
        with self._lock:
            for slabels, ring in self._matching_rings(name + "_bucket",
                                                      labels):
                le_raw = dict(slabels).get("le")
                if le_raw is None:
                    continue
                le = math.inf if le_raw == "+Inf" else float(le_raw)
                d, _, _ = self._ring_delta(ring, now - window_s)
                by_le[le] = by_le.get(le, 0.0) + d
        if not by_le:
            return None
        les = sorted(by_le)
        total = by_le.get(math.inf, 0.0)
        if total <= 0:
            return None
        rank = q * total
        prev_le, prev_cum = 0.0, 0.0
        cum = 0.0
        for le in les:
            cum = by_le[le]
            if cum >= rank:
                if math.isinf(le):
                    return prev_le  # best estimate: the last finite bound
                if cum == prev_cum:
                    return le
                frac = (rank - prev_cum) / (cum - prev_cum)
                return prev_le + (le - prev_le) * max(min(frac, 1.0), 0.0)
            prev_le, prev_cum = le, cum
        return les[-2] if len(les) > 1 else None

    def exemplars(self, name: str, labels: Optional[dict] = None,
                  max_age_s: Optional[float] = None) -> list[dict]:
        """Scraped histogram exemplars for one family (trace ids the
        data plane attached to its latency buckets), newest-kept per
        series, sorted SLOWEST first — the join from a fleet-level
        latency breach to the trace that explains it.  A sample older
        than ``max_age_s`` (default: the staleness horizon; a removed
        target's exemplars are gone entirely) is excluded."""
        horizon = (self.stale_after_s if max_age_s is None
                   else float(max_age_s))
        cutoff = self._clock() - horizon
        out: list[dict] = []
        with self._lock:
            fam = self._exemplars.get(name) or {}
            for (slabels, _tkey), ring in fam.items():
                if not self._match(slabels, labels):
                    continue
                for t, ex_labels, value in ring:
                    if t < cutoff:
                        continue
                    out.append({
                        "labels": dict(slabels),
                        "trace_id": ex_labels.get("trace_id", ""),
                        "value": value,
                        "age_s": round(self._clock() - t, 3),
                    })
        out.sort(key=lambda e: -e["value"])
        return out

    def series_count(self) -> int:
        with self._lock:
            return sum(len(f) for f in self._series.values())

    # -- self-metrics --------------------------------------------------------

    def register_metrics(self, registry=None) -> None:
        """``edl_scrape_*`` self-metrics: the scrape plane is itself a
        scrape target (the controller's /metrics carries these)."""
        reg = registry if registry is not None else get_registry()

        def count_state(state: str) -> float:
            return float(sum(1 for t in self.target_states()
                             if t["state"] == state))

        for state in ("up", "stale", "down"):
            reg.gauge_fn("scrape_targets",
                         lambda s=state: count_state(s),
                         help="scrape targets by health verdict",
                         state=state)
        reg.gauge_fn("scrape_series", lambda: float(self.series_count()),
                     help="time-series rings currently held")
        reg.gauge_fn("scrape_sweeps_done", lambda: float(self.sweeps),
                     help="scrape sweeps completed")


# -- target discovery sources -------------------------------------------------


def kv_targets(kv) -> Callable[[], list[ScrapeTarget]]:
    """Discovery source over coordinator KV: multihost supervisors'
    ``metrics-addr-<member>`` keys and serving replicas' TTL'd
    ``serving-metrics-addr/<job>/<replica>`` keys (expired values are
    skipped — the TTL semantics a plain KV store lacks)."""

    def discover() -> list[ScrapeTarget]:
        out: list[ScrapeTarget] = []
        for key in kv.kv_keys(SUPERVISOR_METRICS_ADDR_PREFIX):
            member = key[len(SUPERVISOR_METRICS_ADDR_PREFIX):]
            val = kv.kv_get(key)
            if val is None:
                continue
            addr, expired = parse_addr_value(val)
            if addr is None or expired:
                continue
            out.append(ScrapeTarget(
                name=f"supervisor/{member}", addr=addr,
                labels={"role": "supervisor", "member": member}))
        for key in kv.kv_keys(SERVING_METRICS_ADDR_PREFIX):
            rest = key[len(SERVING_METRICS_ADDR_PREFIX):]
            job, _, replica = rest.rpartition("/")
            if not job:
                job, replica = rest, ""
            val = kv.kv_get(key)
            if val is None:
                continue
            addr, expired = parse_addr_value(val)
            if addr is None or expired:
                continue
            out.append(ScrapeTarget(
                name=f"serving/{rest}", addr=addr,
                labels={"role": "serving", "job": job,
                        "replica": replica}))
        return out

    return discover


def file_targets(ckpt_dir: str) -> Callable[[], list[ScrapeTarget]]:
    """Discovery source over the supervisor's ``metrics-addr-<name>``
    address files in a checkpoint dir (the pre-KV publication path —
    still what a coordinator-less harness run leaves behind)."""
    import os

    def discover() -> list[ScrapeTarget]:
        out: list[ScrapeTarget] = []
        try:
            names = os.listdir(ckpt_dir)
        except OSError:
            return out
        for fname in names:
            if not fname.startswith(SUPERVISOR_METRICS_ADDR_PREFIX):
                continue
            member = fname[len(SUPERVISOR_METRICS_ADDR_PREFIX):]
            try:
                with open(os.path.join(ckpt_dir, fname)) as f:
                    addr = f.read().strip()
            except OSError:
                continue
            if ":" not in addr:
                continue
            out.append(ScrapeTarget(
                name=f"supervisor/{member}", addr=addr,
                labels={"role": "supervisor", "member": member}))
        return out

    return discover


def manifest_targets(manifests: Iterable[dict], host: str = "127.0.0.1"
                     ) -> Callable[[], list[ScrapeTarget]]:
    """Discovery source over jobparser pod manifests' standard
    ``prometheus.io/{scrape,path,port}`` annotations (controller /
    collector / coordinator ReplicaSets and Deployments).  ``host`` is
    where those ports are reachable from the scraper — pod IPs in a real
    cluster, localhost in the harness.  Returns a CALLABLE like its
    sibling sources (``discover=[manifest_targets(ms)]``); call it
    yourself for a one-shot list."""
    manifests = list(manifests)

    def discover() -> list[ScrapeTarget]:
        return _manifest_targets(manifests, host)

    return discover


def _manifest_targets(manifests: list, host: str) -> list[ScrapeTarget]:
    out: list[ScrapeTarget] = []
    for m in manifests:
        if not isinstance(m, dict):
            continue
        meta = m.get("metadata") or {}
        tmpl = ((m.get("spec") or {}).get("template") or {})
        ann = ((tmpl.get("metadata") or {}).get("annotations")
               or meta.get("annotations") or {})
        if str(ann.get("prometheus.io/scrape", "")).lower() != "true":
            continue
        port = ann.get("prometheus.io/port")
        if port is None:
            continue
        path = ann.get("prometheus.io/path", "/metrics")
        name = meta.get("name") or f"{host}:{port}"
        ns = meta.get("namespace", "default")
        out.append(ScrapeTarget(
            name=f"{ns}/{name}", addr=f"{host}:{port}", path=path,
            labels={"role": m.get("kind", "").lower() or "pod",
                    "manifest": name}))
    return out


def static_targets(addrs: Iterable[str], **labels
                   ) -> list[ScrapeTarget]:
    """Plain host:port list → targets (the CLI's ``--targets`` flag)."""
    return [ScrapeTarget(name=a, addr=a, labels=dict(labels))
            for a in addrs]


# -- address publication ------------------------------------------------------


def publish_host(bind_host: str = "") -> str:
    """The host other machines should dial to reach a port this process
    bound: a SPECIFIC bind address is publishable as-is; a wildcard
    bind publishes the pod IP (``EDL_POD_IP``, the jobparser's downward
    API field) when set, else loopback (the single-host harness case).
    Publishing a raw ``127.0.0.1`` from a pod would point every
    cross-host scraper at its own loopback."""
    import os

    if bind_host and bind_host not in ("0.0.0.0", "::", "*"):
        return bind_host
    return os.environ.get("EDL_POD_IP") or "127.0.0.1"


def publish_serving_metrics_addr(kv, job: str, replica: str, addr: str,
                                 ttl_s: Optional[float] = DEFAULT_ADDR_TTL_S
                                 ) -> str:
    """Write one serving replica's /metrics address to coordinator KV
    (TTL'd; see :data:`SERVING_METRICS_ADDR_PREFIX`).  Returns the key."""
    key = f"{SERVING_METRICS_ADDR_PREFIX}{job}/{replica}"
    kv.kv_set(key, format_addr_value(addr, ttl_s))
    return key


class AddrPublisher(threading.Thread):
    """Background refresher for a TTL'd published address: re-stamps the
    expiry every ``ttl_s/3`` so the key outlives exactly its publisher
    (a crashed process's key expires; a live one's never does), and
    best-effort deletes it on :meth:`stop` (clean shutdown leaves no
    tombstone to wait out)."""

    def __init__(self, kv, key: str, addr: str,
                 ttl_s: float = DEFAULT_ADDR_TTL_S,
                 value_fn: Optional[Callable[[], bytes]] = None) -> None:
        super().__init__(name=f"addr-publish-{key}", daemon=True)
        self.kv = kv
        self.key = key
        self.addr = addr
        self.ttl_s = max(float(ttl_s), 1.0)
        #: value factory — default is the plain TTL'd address; the
        #: serving data plane publishes addr+expiry+ready-gate state
        #: through the same refresher (runtime/frontdoor.py)
        self.value_fn = value_fn
        self._halt = threading.Event()
        self._kick = threading.Event()

    def publish_now(self) -> None:
        """Republish out of band (e.g. on a ready-gate transition) —
        the run loop wakes immediately instead of at the next ttl/3."""
        self._kick.set()

    def _put(self) -> None:
        try:
            value = (self.value_fn() if self.value_fn is not None
                     else format_addr_value(self.addr, self.ttl_s))
            self.kv.kv_set(self.key, value)
        except Exception as exc:  # coordinator blip: keep refreshing
            log.warn("addr publish failed", key=self.key,
                     error=str(exc)[:120])

    def run(self) -> None:
        self._put()
        while True:
            self._kick.wait(self.ttl_s / 3.0)
            self._kick.clear()
            if self._halt.is_set():
                return
            self._put()

    def stop(self) -> None:
        self._halt.set()
        self._kick.set()
        self.join(timeout=5)
        try:
            self.kv.kv_del(self.key)
        except Exception:
            pass


# -- the fleet view -----------------------------------------------------------


class FleetView:
    """Per-job and fleet-wide rollups over a :class:`MetricsScraper` —
    the continuously-measured fleet state every consumer reads:
    :class:`~edl_tpu_torch.scheduler.autoscaler.ServingScaler` (via
    :meth:`stats_for`), the :class:`AlertEngine`, and the ``edl-tpu
    fleet`` dashboard."""

    def __init__(self, scraper: MetricsScraper,
                 window_s: float = 10.0) -> None:
        self.scraper = scraper
        self.window_s = float(window_s)

    # -- serving -------------------------------------------------------------

    def jobs(self) -> list[str]:
        """Every job label seen on serving or goodput series."""
        s = self.scraper
        return sorted(set(s.label_values("edl_serving_requests_total",
                                         "job"))
                      | set(s.label_values("edl_goodput_fraction", "job")))

    def serving_stats(self, job: Optional[str] = None,
                      window_s: Optional[float] = None):
        """Windowed serving rollup shaped like
        :class:`~edl_tpu_torch.runtime.serving.FleetStats` — THE scraped
        replacement for the in-process ``fleet.stats`` hook.  p50/p99
        are histogram-quantile estimates from windowed bucket deltas of
        ``edl_serving_request_seconds`` (resolution = the serving
        buckets), qps is the honest windowed rate of
        ``edl_serving_requests_total``, queue depth / replica counts are
        latest-gauge sums across the job's targets."""
        from edl_tpu_torch.runtime.serving import FleetStats

        w = float(window_s) if window_s is not None else self.window_s
        labels = {"job": job} if job else None
        s = self.scraper
        windowed = s.delta("edl_serving_requests_total", w, labels)
        qps = s.rate("edl_serving_requests_total", w, labels)
        p50 = s.histogram_quantile("edl_serving_request_seconds", 0.50,
                                   w, labels)
        p99 = s.histogram_quantile("edl_serving_request_seconds", 0.99,
                                   w, labels)
        depth = s.latest("edl_serving_fleet_queue_depth", labels) or 0
        ready = s.latest("edl_serving_replicas_ready", labels) or 0
        active = s.latest("edl_serving_replicas_active", labels) or 0
        # decode-serving extension: TTFT/TPOT from the decode-scale
        # histograms, tok/s from the emission counter, sessions + KV
        # occupancy from the replica gauges (all zero on stateless jobs)
        ttft = s.histogram_quantile("edl_serving_ttft_seconds", 0.99,
                                    w, labels)
        tpot = s.histogram_quantile("edl_serving_tpot_seconds", 0.50,
                                    w, labels)
        tps = s.rate("edl_serving_decode_tokens_total", w, labels)
        sessions = s.latest("edl_serving_sessions_active", labels) or 0
        kv_used = s.latest("edl_serving_kv_blocks_used", labels) or 0
        kv_total = s.latest("edl_serving_kv_blocks_total", labels) or 0
        # multi-card speculative decode: chip-normalized throughput and
        # the windowed acceptance rate (accepted/drafted deltas)
        chips = s.latest("edl_serving_chips", labels) or 0
        drafted = s.delta("edl_decode_spec_drafted_total", w, labels)
        accepted = s.delta("edl_decode_spec_accepted_total", w, labels)
        # prefix-share hit rate: windowed index hits over windowed
        # session completions (the closest scrapeable admission proxy —
        # in steady state every admitted session also completes)
        prefix_hits = s.delta("edl_kv_prefix_hits_total", w, labels)
        sessions_done = s.delta("edl_serving_sessions_total", w, labels)
        return FleetStats(
            p50_ms=round((p50 or 0.0) * 1000.0, 3),
            p99_ms=round((p99 or 0.0) * 1000.0, 3),
            qps=round(qps, 2), queue_depth=int(depth),
            replicas_ready=int(ready), replicas_active=int(active),
            requests_windowed=int(windowed),
            ttft_p99_ms=round((ttft or 0.0) * 1000.0, 3),
            tpot_p50_ms=round((tpot or 0.0) * 1000.0, 4),
            decode_tps=round(tps, 2), sessions=int(sessions),
            kv_blocks_used=int(kv_used), kv_blocks_total=int(kv_total),
            chips=int(chips),
            tok_s_per_chip=round(tps / chips, 2) if chips else 0.0,
            spec_accept_rate=round(accepted / drafted, 4) if drafted
            else 0.0,
            prefix_hit_rate=round(prefix_hits / sessions_done, 4)
            if sessions_done else 0.0)

    def stats_for(self, uid: str):
        """The :class:`ServingScaler` seam: ``stats_for=view.stats_for``
        feeds the policy from scraped replica /metrics."""
        return self.serving_stats(job=uid)

    #: latency families whose bucket exemplars carry trace ids
    EXEMPLAR_FAMILIES = ("edl_serving_request_seconds",
                        "edl_frontdoor_request_seconds",
                        "edl_lb_request_seconds")

    def slowest_exemplars(self, job: Optional[str] = None,
                          k: int = 3) -> list[dict]:
        """The slowest scraped trace-id exemplars across the serving
        latency families — the dashboard's "why was THIS slow" handles,
        each feedable straight into ``edl-tpu trace``."""
        labels = {"job": job} if job else None
        out: list[dict] = []
        for fam in self.EXEMPLAR_FAMILIES:
            for ex in self.scraper.exemplars(fam, labels):
                out.append({**ex, "family": fam})
        out.sort(key=lambda e: -e["value"])
        return out[:max(int(k), 1)]

    # -- goodput / coordinator ----------------------------------------------

    def goodput_fraction(self, job: Optional[str] = None
                         ) -> Optional[float]:
        labels = {"job": job} if job else None
        return self.scraper.latest("edl_goodput_fraction", labels,
                                   agg="min")

    def goodput_summary(self) -> dict[str, dict]:
        s = self.scraper
        out: dict[str, dict] = {}
        for job in s.label_values("edl_goodput_fraction", "job"):
            frac = s.latest("edl_goodput_fraction", {"job": job},
                            agg="min")
            out.setdefault(job, {})["fraction"] = (round(frac, 4)
                                                   if frac is not None
                                                   else None)
        # world sizes SUM across a job's member-slot ledgers (each
        # supervisor speaks for world_size=1); conservation takes the
        # worst offender
        for job, v in s.sum_by("edl_goodput_world_size", "job").items():
            out.setdefault(job, {})["world_size"] = v
        for job in s.label_values("edl_goodput_conservation_error_pct",
                                  "job"):
            err = s.latest("edl_goodput_conservation_error_pct",
                           {"job": job}, agg="max")
            if err is not None:
                out.setdefault(job, {})["conservation_error_pct"] = \
                    round(err, 4)
        return out

    def coord_summary(self) -> dict:
        """Coordinator rollup from ``edl_coord_*``: epoch / members /
        role across scraped coordinator targets."""
        s = self.scraper
        return {
            "epoch": s.latest("edl_coord_membership_epoch", agg="max"),
            "members": s.latest("edl_coord_members", agg="max"),
            "requests_total": s.latest("edl_coord_requests_total",
                                       agg="sum"),
            "primaries": s.latest("edl_coord_role_primary", agg="sum"),
        }

    # -- calibration ---------------------------------------------------------

    def calibration_summary(self) -> dict[str, dict[str, dict]]:
        """Per-(job, predictor) calibration rollup from the scraped
        ``edl_calibration_*`` series: the running measured/predicted
        factor, total samples, and windowed error-pct quantiles — the
        dashboard's "which cost model is lying" table."""
        s = self.scraper
        out: dict[str, dict[str, dict]] = {}
        jobs = s.label_values("edl_calibration_factor", "job")
        preds = s.label_values("edl_calibration_factor", "predictor")
        for job in jobs:
            for pred in preds:
                labels = {"job": job, "predictor": pred}
                factor = s.latest("edl_calibration_factor", labels,
                                  agg="max")
                if factor is None:
                    continue  # this (job, predictor) pair never fired
                n = s.latest("edl_calibration_samples_total", labels,
                             agg="sum") or 0
                p50 = s.histogram_quantile("edl_calibration_error_pct",
                                           0.50, self.window_s, labels)
                p99 = s.histogram_quantile("edl_calibration_error_pct",
                                           0.99, self.window_s, labels)
                out.setdefault(job, {})[pred] = {
                    "factor": round(factor, 4), "samples": int(n),
                    "error_pct_p50": (round(p50, 2) if p50 is not None
                                      else None),
                    "error_pct_p99": (round(p99, 2) if p99 is not None
                                      else None),
                }
        return out

    def snapshot(self) -> dict:
        """Everything the dashboard renders, in one dict."""
        per_job = {}
        goodput = self.goodput_summary()  # one series walk, reused below
        for job in self.jobs():
            st = self.serving_stats(job)
            per_job[job] = {
                "qps": st.qps, "p50_ms": st.p50_ms, "p99_ms": st.p99_ms,
                "queue": st.queue_depth,
                "replicas": f"{st.replicas_ready}/{st.replicas_active}",
                "requests_windowed": st.requests_windowed,
                "ttft_p99_ms": st.ttft_p99_ms,
                "decode_tps": st.decode_tps,
                "sessions": st.sessions,
                "kv_blocks": f"{st.kv_blocks_used}/{st.kv_blocks_total}",
                "chips": st.chips,
                "tok_s_per_chip": st.tok_s_per_chip,
                "spec_accept_rate": st.spec_accept_rate,
                "kv_pct": (round(100.0 * st.kv_blocks_used
                                 / st.kv_blocks_total, 1)
                           if st.kv_blocks_total else 0.0),
                "prefix_hit_rate": st.prefix_hit_rate,
            }
            gp = goodput.get(job)
            if gp:
                per_job[job]["goodput"] = gp.get("fraction")
            slow = self.slowest_exemplars(job, k=1)
            if slow:
                per_job[job]["slowest_trace"] = {
                    "trace_id": slow[0]["trace_id"],
                    "latency_ms": round(slow[0]["value"] * 1e3, 3),
                }
        fleet = self.serving_stats(None)
        return {
            "window_s": self.window_s,
            "fleet": {"qps": fleet.qps, "p99_ms": fleet.p99_ms,
                      "queue": fleet.queue_depth,
                      "replicas_active": fleet.replicas_active},
            "jobs": per_job,
            "goodput": goodput,
            "calibration": self.calibration_summary(),
            "coord": self.coord_summary(),
            "targets": self.scraper.target_states(),
        }


# -- alerting -----------------------------------------------------------------


@dataclass
class Alert:
    """One rule evaluation result for one label set."""

    rule: str
    labels: dict
    firing: bool
    value: float = 0.0
    detail: str = ""

    def key(self) -> tuple:
        return (self.rule, tuple(sorted(self.labels.items())))


class AlertRule:
    """Base: subclasses evaluate the scraped state into
    :class:`Alert` records (one per label set, firing or not)."""

    def evaluate(self, view: FleetView) -> list[Alert]:
        raise NotImplementedError


class BurnRateRule(AlertRule):
    """SLO burn-rate, fast/slow multi-window (the SRE-workbook shape,
    compressed): over each window, ``burn = (violation_rate /
    request_rate) / budget_fraction``; the FAST window at a high factor
    catches an acute breach in minutes, the SLOW window at a lower
    factor catches a simmering one.  Windows/factors are constructor
    knobs so tests and the bench can compress time."""

    def __init__(self, job: Optional[str] = None,
                 budget_fraction: float = 0.001,
                 fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                 fast_factor: float = 14.4, slow_factor: float = 6.0,
                 min_requests: int = 10) -> None:
        self.job = job
        self.budget_fraction = max(float(budget_fraction), 1e-9)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_factor = float(fast_factor)
        self.slow_factor = float(slow_factor)
        self.min_requests = int(min_requests)

    def _burn(self, view: FleetView, job: str, window_s: float
              ) -> tuple[float, float]:
        labels = {"job": job}
        reqs = view.scraper.delta("edl_serving_requests_total",
                                  window_s, labels)
        viol = view.scraper.delta("edl_serving_slo_violations_total",
                                  window_s, labels)
        if reqs <= 0:
            return 0.0, 0.0
        return (viol / reqs) / self.budget_fraction, reqs

    def evaluate(self, view: FleetView) -> list[Alert]:
        jobs = [self.job] if self.job else view.jobs()
        out: list[Alert] = []
        for job in jobs:
            for rule, window, factor in (
                    ("slo_fast_burn", self.fast_window_s,
                     self.fast_factor),
                    ("slo_slow_burn", self.slow_window_s,
                     self.slow_factor)):
                burn, reqs = self._burn(view, job, window)
                firing = reqs >= self.min_requests and burn > factor
                out.append(Alert(
                    rule=rule, labels={"job": job}, firing=firing,
                    value=round(burn, 3),
                    detail=f"burn={burn:.1f}x over {window:g}s "
                           f"(threshold {factor:g}x, "
                           f"{int(reqs)} requests)"))
        return out


class GoodputCollapseRule(AlertRule):
    """A job whose measured goodput fraction fell under ``min_fraction``
    is burning chips on non-productive phases — the ledger's headline
    number, alerted on."""

    def __init__(self, job: Optional[str] = None,
                 min_fraction: float = 0.5) -> None:
        self.job = job
        self.min_fraction = float(min_fraction)

    def evaluate(self, view: FleetView) -> list[Alert]:
        jobs = ([self.job] if self.job
                else view.scraper.label_values("edl_goodput_fraction",
                                               "job"))
        out = []
        for job in jobs:
            frac = view.scraper.latest("edl_goodput_fraction",
                                       {"job": job}, agg="min")
            if frac is None:
                continue
            out.append(Alert(
                rule="goodput_collapse", labels={"job": job},
                firing=frac < self.min_fraction, value=round(frac, 4),
                detail=f"goodput {frac:.2%} < {self.min_fraction:.0%}"))
        return out


class TargetDownRule(AlertRule):
    """A scrape target that failed ``down_after_failures`` consecutive
    scrapes (or went stale past the scraper's staleness horizon) is a
    process that may be gone — the scrape plane's own liveness check
    over the fleet."""

    def __init__(self, down_after_failures: int = 3) -> None:
        self.down_after_failures = int(down_after_failures)

    def evaluate(self, view: FleetView) -> list[Alert]:
        out = []
        for t in view.scraper.target_states():
            firing = (t["consecutive_failures"] >= self.down_after_failures
                      or t["state"] == "down")
            out.append(Alert(
                rule="scrape_target_down", labels={"target": t["name"]},
                firing=firing, value=float(t["consecutive_failures"]),
                detail=f"{t['state']}, {t['consecutive_failures']} "
                       f"consecutive failures, stale "
                       f"{t['staleness_s']:.1f}s: {t['last_error']}"))
        return out


class ConservationRule(AlertRule):
    """The goodput ledger's conservation invariant, watched from the
    outside: an ``edl_goodput_conservation_error_pct`` above
    ``max_error_pct`` means a ledger is mis-pricing chip-seconds."""

    def __init__(self, max_error_pct: float = 1.0) -> None:
        self.max_error_pct = float(max_error_pct)

    def evaluate(self, view: FleetView) -> list[Alert]:
        out = []
        for job in view.scraper.label_values(
                "edl_goodput_conservation_error_pct", "job"):
            err = view.scraper.latest(
                "edl_goodput_conservation_error_pct", {"job": job},
                agg="max")
            if err is None:
                continue
            out.append(Alert(
                rule="conservation_violation", labels={"job": job},
                firing=err > self.max_error_pct, value=round(err, 4),
                detail=f"conservation error {err:.2f}% > "
                       f"{self.max_error_pct:g}%"))
        return out


class CalibrationDriftRule(AlertRule):
    """A predictor whose running measured/predicted factor sat outside
    ``[band_lo, band_hi]`` for ``windows`` CONSECUTIVE evaluations has a
    cost model that is systematically lying — every decision priced on
    it (resize grants, interleave budgets, scale plans) inherits the
    bias.  Consecutive-window gating keeps one noisy sample (a cold
    cache, a straggling host) from paging anyone; the factor is already
    EWMA-smoothed underneath."""

    def __init__(self, band_lo: float = 0.5, band_hi: float = 2.0,
                 windows: int = 3, min_samples: int = 3) -> None:
        self.band_lo = float(band_lo)
        self.band_hi = float(band_hi)
        self.windows = max(int(windows), 1)
        self.min_samples = int(min_samples)
        #: (job, predictor) → consecutive out-of-band evaluations
        self._out: dict[tuple, int] = {}

    def evaluate(self, view: FleetView) -> list[Alert]:
        s = view.scraper
        out: list[Alert] = []
        seen: set[tuple] = set()
        for job in s.label_values("edl_calibration_factor", "job"):
            for pred in s.label_values("edl_calibration_factor",
                                       "predictor"):
                labels = {"job": job, "predictor": pred}
                factor = s.latest("edl_calibration_factor", labels,
                                  agg="max")
                if factor is None:
                    continue  # absent (job, predictor) combination
                n = s.latest("edl_calibration_samples_total", labels,
                             agg="sum") or 0
                key = (job, pred)
                seen.add(key)
                outside = (n >= self.min_samples
                           and not (self.band_lo <= factor
                                    <= self.band_hi))
                streak = self._out.get(key, 0) + 1 if outside else 0
                self._out[key] = streak
                out.append(Alert(
                    rule="calibration_drift", labels=labels,
                    firing=streak >= self.windows,
                    value=round(factor, 4),
                    detail=f"factor {factor:.2f} outside "
                           f"[{self.band_lo:g}, {self.band_hi:g}] "
                           f"for {streak} evaluation(s) "
                           f"({int(n)} samples)"))
        # a predictor whose series vanished (job GC'd) drops its streak
        for key in list(self._out):
            if key not in seen:
                del self._out[key]
        return out


def default_rules() -> list[AlertRule]:
    return [BurnRateRule(), GoodputCollapseRule(), TargetDownRule(),
            ConservationRule(), CalibrationDriftRule()]


class AlertEngine:
    """Evaluates :class:`AlertRule`s over a :class:`FleetView` and turns
    firings into operator-visible evidence: ``edl_alerts_firing{rule=}``
    gauges (count of firing label sets per rule),
    ``edl_alerts_fired_total{rule=}`` counters on each rising edge, an
    ``alert_firing`` / ``alert_resolved`` trace instant pair, and — when
    ``flight_dir`` is set — a flight-record dump through the shared dump
    lock, deduped per rule within ``dump_cooldown_s`` (a flapping rule
    must not carpet the disk with near-identical records)."""

    def __init__(self, view: FleetView,
                 rules: Optional[Sequence[AlertRule]] = None,
                 registry=None, flight_dir: Optional[str] = None,
                 dump_cooldown_s: float = 60.0) -> None:
        self.view = view
        self.rules = list(rules) if rules is not None else default_rules()
        self.flight_dir = flight_dir
        self.dump_cooldown_s = float(dump_cooldown_s)
        self._registry = (registry if registry is not None
                          else get_registry())
        self._gauge = self._registry.gauge(
            "alerts_firing", help="firing label sets per alert rule")
        self._known_rules: set[str] = set()
        self._firing: dict[tuple, Alert] = {}
        self.evaluations = 0
        #: recent rising edges, bounded like every other buffer here (a
        #: flapping rule in a weeks-long controller must not grow this
        #: without end; the full record is in the counters/trace/dumps)
        self.history: "deque[Alert]" = deque(maxlen=256)

    def firing(self) -> list[Alert]:
        return sorted(self._firing.values(), key=lambda a: a.key())

    def evaluate(self) -> list[Alert]:
        """One pass over every rule; returns the alerts that are firing
        after it.  Rising edges count/trace/dump; falling edges trace
        resolution and clear the gauge."""
        self.evaluations += 1
        results: list[Alert] = []
        for rule in self.rules:
            try:
                results.extend(rule.evaluate(self.view))
            except Exception as exc:  # one bad rule must not stop the rest
                log.warn("alert rule evaluation failed",
                         rule=type(rule).__name__, error=str(exc)[:200])
        seen: set[tuple] = set()
        for alert in results:
            key = alert.key()
            seen.add(key)
            was = key in self._firing
            if alert.firing and not was:
                self._firing[key] = alert
                self.history.append(alert)
                log.warn("alert firing", rule=alert.rule,
                         value=alert.value, detail=alert.detail,
                         **alert.labels)
                get_counters().inc("alerts_fired", rule=alert.rule)
                get_tracer().instant("alert_firing", category="alert",
                                     rule=alert.rule, value=alert.value,
                                     detail=alert.detail, **alert.labels)
                if self.flight_dir:
                    try:
                        dump_flight_record(
                            self.flight_dir, f"alert-{alert.rule}",
                            extra={"rule": alert.rule,
                                   "labels": alert.labels,
                                   "value": alert.value,
                                   "detail": alert.detail},
                            cooldown_s=self.dump_cooldown_s)
                    except Exception as exc:
                        log.warn("alert flight record dump failed",
                                 error=str(exc)[:120])
            elif alert.firing and was:
                self._firing[key] = alert  # refresh value/detail
            elif not alert.firing and was:
                del self._firing[key]
                log.info("alert resolved", rule=alert.rule,
                         **alert.labels)
                get_tracer().instant("alert_resolved", category="alert",
                                     rule=alert.rule, **alert.labels)
        # a label set a rule stopped reporting entirely (job deleted,
        # target removed) resolves implicitly
        for key in [k for k in self._firing if k not in seen]:
            gone = self._firing.pop(key)
            get_tracer().instant("alert_resolved", category="alert",
                                 rule=gone.rule, **gone.labels)
        by_rule: dict[str, int] = {}
        for a in self._firing.values():
            by_rule[a.rule] = by_rule.get(a.rule, 0) + 1
        # zero every rule EVER seen, not just rules still reporting — a
        # rule whose subjects all vanished (last target removed, job
        # deleted) must read 0, not freeze at its last firing count
        self._known_rules |= {a.rule for a in results} | set(by_rule)
        for rule in self._known_rules:
            self._gauge.set(by_rule.get(rule, 0), rule=rule)
        return self.firing()


# -- the one-screen dashboard -------------------------------------------------


def render_fleet_dashboard(view: FleetView,
                           engine: Optional[AlertEngine] = None) -> str:
    """One screen of fleet state (the ``edl-tpu fleet`` verb's body):
    fleet rollup, per-job serving + goodput rows, coordinator state,
    target health, firing alerts."""
    snap = view.snapshot()
    lines: list[str] = []
    f = snap["fleet"]
    lines.append(f"FLEET  qps={f['qps']:g}  p99={f['p99_ms']:g}ms  "
                 f"queue={f['queue']}  replicas={f['replicas_active']}  "
                 f"(window {snap['window_s']:g}s)")
    if snap["jobs"]:
        lines.append("")
        rows = [("JOB", "QPS", "P50ms", "P99ms", "TTFTp99", "TOK/S",
                 "TOK/S/CHIP", "SPEC%", "SESSIONS", "KV", "KV%",
                 "PREFIX%", "QUEUE", "REPLICAS", "GOODPUT",
                 "SLOWEST-TRACE")]
        for job, j in sorted(snap["jobs"].items()):
            gp = j.get("goodput")
            slow = j.get("slowest_trace")
            kv = j.get("kv_blocks", "0/0")
            spec = j.get("spec_accept_rate", 0.0)
            kv_pct = j.get("kv_pct", 0.0)
            pfx = j.get("prefix_hit_rate", 0.0)
            rows.append((job, f"{j['qps']:g}", f"{j['p50_ms']:g}",
                         f"{j['p99_ms']:g}",
                         (f"{j.get('ttft_p99_ms', 0):g}ms"
                          if j.get("ttft_p99_ms") else "-"),
                         (f"{j.get('decode_tps', 0):g}"
                          if j.get("decode_tps") else "-"),
                         (f"{j.get('tok_s_per_chip', 0):g}"
                          if j.get("tok_s_per_chip") else "-"),
                         f"{spec:.1%}" if spec else "-",
                         str(j.get("sessions", 0)),
                         kv if kv != "0/0" else "-",
                         f"{kv_pct:g}%" if kv_pct else "-",
                         f"{pfx:.1%}" if pfx else "-",
                         str(j["queue"]), j["replicas"],
                         f"{gp:.2%}" if gp is not None else "-",
                         (f"{slow['latency_ms']:g}ms@{slow['trace_id']}"
                          if slow else "-")))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                  for r in rows]
    extra_gp = {j: g for j, g in snap["goodput"].items()
                if j not in snap["jobs"]}
    if extra_gp:
        lines.append("")
        lines.append("GOODPUT (non-serving jobs)")
        for job, g in sorted(extra_gp.items()):
            frac = g.get("fraction")
            lines.append(
                f"  {job}: fraction="
                f"{f'{frac:.2%}' if frac is not None else '-'}"
                f"  world={g.get('world_size', '-')}"
                f"  conservation_err={g.get('conservation_error_pct', '-')}%")
    calib = snap.get("calibration") or {}
    if calib:
        lines.append("")
        lines.append("CALIBRATION (factor = measured/predicted)")
        crows = [("  JOB", "PREDICTOR", "FACTOR", "SAMPLES",
                  "ERR%p50", "ERR%p99")]
        for job, preds in sorted(calib.items()):
            for pred, c in sorted(preds.items()):
                crows.append((
                    f"  {job}", pred, f"{c['factor']:g}",
                    str(c["samples"]),
                    (f"{c['error_pct_p50']:g}"
                     if c["error_pct_p50"] is not None else "-"),
                    (f"{c['error_pct_p99']:g}"
                     if c["error_pct_p99"] is not None else "-")))
        cw = [max(len(r[i]) for r in crows)
              for i in range(len(crows[0]))]
        lines += ["  ".join(c.ljust(w) for c, w in zip(r, cw)).rstrip()
                  for r in crows]
    coord = snap["coord"]
    if coord.get("epoch") is not None or coord.get("members") is not None:
        lines.append("")
        lines.append(f"COORD  epoch={coord.get('epoch')}  "
                     f"members={coord.get('members')}  "
                     f"requests={coord.get('requests_total')}")
    lines.append("")
    lines.append("TARGETS")
    for t in snap["targets"]:
        mark = {"up": "✓", "stale": "~", "down": "✗"}.get(t["state"], "?")
        err = f"  [{t['last_error']}]" if t["last_error"] else ""
        lines.append(f"  {mark} {t['name']:<32} {t['addr']:<22} "
                     f"{t['state']:<6} stale={t['staleness_s']:g}s "
                     f"fails={t['consecutive_failures']}{err}")
    if engine is not None:
        firing = engine.firing()
        lines.append("")
        if firing:
            lines.append(f"ALERTS FIRING ({len(firing)})")
            for a in firing:
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(a.labels.items()))
                lines.append(f"  !! {a.rule}{{{lbl}}}  {a.detail}")
        else:
            lines.append("ALERTS: none firing")
    return "\n".join(lines)


def render_calib_dashboard(view: FleetView,
                           engine: Optional[AlertEngine] = None) -> str:
    """The ``edl-tpu calib`` verb's body: one row per (job, predictor)
    — running measured/predicted factor, sample count, windowed
    error-pct quantiles, and an in-band marker matching the drift
    rule's default band — plus any firing calibration_drift alerts."""
    calib = view.calibration_summary()
    lines: list[str] = []
    lines.append(f"CALIBRATION  (factor = measured/predicted, "
                 f"window {view.window_s:g}s)")
    if not calib:
        lines.append("  no calibration series scraped "
                     "(no armed ledger has recorded a sample)")
    else:
        rows = [("  JOB", "PREDICTOR", "FACTOR", "SAMPLES", "ERR%p50",
                 "ERR%p99", "BAND")]
        for job, preds in sorted(calib.items()):
            for pred, c in sorted(preds.items()):
                in_band = 0.5 <= c["factor"] <= 2.0
                rows.append((
                    f"  {job}", pred, f"{c['factor']:g}",
                    str(c["samples"]),
                    (f"{c['error_pct_p50']:g}"
                     if c["error_pct_p50"] is not None else "-"),
                    (f"{c['error_pct_p99']:g}"
                     if c["error_pct_p99"] is not None else "-"),
                    "ok" if in_band else "DRIFT"))
        widths = [max(len(r[i]) for r in rows)
                  for i in range(len(rows[0]))]
        lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                  for r in rows]
    if engine is not None:
        firing = [a for a in engine.firing()
                  if a.rule == "calibration_drift"]
        lines.append("")
        if firing:
            lines.append(f"CALIBRATION DRIFT FIRING ({len(firing)})")
            for a in firing:
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(a.labels.items()))
                lines.append(f"  !! {a.rule}{{{lbl}}}  {a.detail}")
        else:
            lines.append("DRIFT: none firing")
    return "\n".join(lines)
