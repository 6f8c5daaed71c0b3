"""Metrics registry and Prometheus text exposition: the part of
edl_tpu.observability.metrics that the decode serving plane uses.

Every series renders with the ``edl_`` prefix; counters get the ``_total``
suffix; histograms use fixed buckets so series of different replicas
merge.  Labels are keyword arguments, folded into the key in sorted order.
The text is version 0.0.4 of the exposition format, the grammar the JAX
package's strict ``parse_exposition`` holds it to.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Iterable, Optional

#: default histogram buckets (seconds): sub-ms pauses up to 120 s
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: ms-scale request-latency buckets (seconds): 0.2 ms to 2.5 s
SERVING_LATENCY_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                           0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

#: time-to-first-token buckets (seconds): a prefill latency, ms-scale at
#: the fast end and seconds under chunked-prefill interleave
SERVING_TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: per-output-token buckets (seconds): one decode iteration, dense at the
#: bottom where the decode objective lives
SERVING_TPOT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                        0.01, 0.025, 0.05, 0.1)

#: rendered-name prefix of every series
PREFIX = "edl_"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def sanitize_name(name: str) -> str:
    """Coerce a metric or label name into ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def escape_label_value(value: str) -> str:
    """Backslash-escape per the text-format spec (\\, \", \\n)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_value(v: float) -> str:
    """Integers without a decimal point; floats via repr; +Inf/-Inf/NaN."""
    if isinstance(v, bool):
        return str(int(v))
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _label_key(labels: dict) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: tuple[tuple[str, str], ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(
        f'{sanitize_name(k)}="{escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class _Family:
    """One named metric family: a lock, a help string, labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Family):
    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> float:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            key = _label_key(labels)
            self._values[key] = self._values.get(key, 0) + n
            return self._values[key]

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)

    def render(self, lines: list[str]) -> None:
        name = PREFIX + sanitize_name(self.name)
        if not name.endswith("_total"):
            name += "_total"
        lines.append(f"# HELP {name} {self.help or self.name}")
        lines.append(f"# TYPE {name} counter")
        series = self.series()
        if not series:
            lines.append(f"{name} 0")
            return
        for key in sorted(series):
            lines.append(
                f"{name}{_render_labels(key)} {format_value(series[key])}")


class Gauge(_Family):
    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def render(self, lines: list[str]) -> None:
        name = PREFIX + sanitize_name(self.name)
        lines.append(f"# HELP {name} {self.help or self.name}")
        lines.append(f"# TYPE {name} gauge")
        with self._lock:
            series = dict(self._values)
        if not series:
            lines.append(f"{name} 0")
            return
        for key in sorted(series):
            lines.append(
                f"{name}{_render_labels(key)} {format_value(series[key])}")


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets: tuple[float, ...] = tuple(bs)
        # per label-set: [bucket counts..., +Inf count], and the sum
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def _series_locked(self, key: tuple) -> list[int]:
        counts = self._counts.get(key)
        if counts is None:
            counts = [0] * (len(self.buckets) + 1)
            self._counts[key] = counts
            self._sums[key] = 0.0
        return counts

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        with self._lock:
            key = _label_key(labels)
            counts = self._series_locked(key)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._sums[key] += v

    def touch(self, **labels) -> None:
        """Pre-register a label set with zero observations, so its whole
        bucket/sum/count block renders from the first scrape."""
        with self._lock:
            self._series_locked(_label_key(labels))

    def merged_counts(self, **match) -> list[int]:
        """Bucket counts (the +Inf count last) summed over every label set
        that carries the ``match`` labels."""
        want = set(_label_key(match))
        out = [0] * (len(self.buckets) + 1)
        with self._lock:
            for key, counts in self._counts.items():
                if want <= set(key):
                    out = [a + b for a, b in zip(out, counts)]
        return out

    def quantile_bucket(self, q: float, **match) -> Optional[float]:
        """Upper bound of the bucket holding quantile ``q`` over the label
        sets carrying ``match`` (None with no observations)."""
        counts = self.merged_counts(**match)
        if counts[-1] == 0:
            return None
        rank = q * counts[-1]
        for i, b in enumerate(self.buckets):
            if counts[i] >= rank:
                return b
        return math.inf

    def render(self, lines: list[str]) -> None:
        name = PREFIX + sanitize_name(self.name)
        lines.append(f"# HELP {name} {self.help or self.name}")
        lines.append(f"# TYPE {name} histogram")
        with self._lock:
            snap = {k: (list(self._counts[k]), self._sums[k])
                    for k in sorted(self._counts)}
        for key, (counts, total) in snap.items():
            for i, b in enumerate(self.buckets):
                lines.append(
                    f"{name}_bucket"
                    f"{_render_labels(key, (('le', format_value(b)),))}"
                    f" {counts[i]}")
            lines.append(
                f"{name}_bucket{_render_labels(key, (('le', '+Inf'),))}"
                f" {counts[-1]}")
            lines.append(f"{name}_sum{_render_labels(key)} "
                         f"{format_value(total)}")
            lines.append(f"{name}_count{_render_labels(key)} {counts[-1]}")


class MetricsRegistry:
    """Typed families keyed by raw (unprefixed) name, plus callback gauges
    evaluated at render time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        #: (name, label-key) → (fn, help): several label sets may share
        #: one family name
        self._gauge_fns: dict[tuple[str, tuple],
                              tuple[Callable[[], float], str]] = {}

    def _get_or_create(self, name: str, cls, **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, **kwargs)
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        """Get-or-create a histogram family; ``buckets`` (first
        registration) sets its boundaries, and re-registering with other
        explicit boundaries raises."""
        fam = self._get_or_create(
            name, Histogram, help=help,
            buckets=DEFAULT_BUCKETS if buckets is None else buckets)
        if buckets is not None:
            want = tuple(sorted(float(b) for b in buckets))
            if fam.buckets != want:
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{fam.buckets}; refusing conflicting {want}")
        return fam

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "",
                 **labels) -> None:
        """Register (or replace) a callback gauge; ``fn()`` runs at render
        time, and a raising or None callback is skipped."""
        with self._lock:
            self._gauge_fns[(name, _label_key(labels))] = (fn, help)

    def render(self) -> str:
        """Prometheus text exposition (0.0.4) of every family and callback
        gauge, deterministically ordered."""
        lines: list[str] = []
        with self._lock:
            fams = sorted(self._families.items())
            gfns = sorted(self._gauge_fns.items(), key=lambda kv: kv[0])
        for _, fam in fams:
            fam.render(lines)
        last_name = None
        for (name, lkey), (fn, help) in gfns:
            try:
                v = fn()
            except Exception:
                continue
            if v is None:
                continue
            rname = PREFIX + sanitize_name(name)
            if name != last_name:  # HELP/TYPE once per family
                lines.append(f"# HELP {rname} {help or name}")
                lines.append(f"# TYPE {rname} gauge")
                last_name = name
            lines.append(f"{rname}{_render_labels(lkey)} "
                         f"{format_value(float(v))}")
        return "\n".join(lines) + "\n"


#: the process-wide registry, which get_counters() is backed by
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry
