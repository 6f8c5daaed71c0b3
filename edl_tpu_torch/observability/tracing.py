"""Bounded in-process trace of named events, with cross-process span
correlation — the part of edl_tpu.observability.tracing that the runtime
calls.

Every span carries a ``span_id``; a reform opens a *root* span whose
``trace_id`` travels to other processes through the ``EDL_TRACE_ID``
environment variable and a coordinator KV key (runtime/multihost.py), so
the supervisor's and the world child's events read as one span tree.
:meth:`Tracer.dump` writes Chrome ``chrome://tracing`` JSON with the
process's wall-clock anchor, and a :class:`TraceFileSink` rewrites that
dump every second for a live serving process.  The trace forest and the
merge of dumps wait for the port's control plane (ROADMAP.md, queue 1
item 11).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional


@dataclass(frozen=True)
class TraceEvent:
    name: str
    category: str
    start_s: float
    duration_s: float
    args: dict = field(default_factory=dict)
    #: correlation triplet — None on plain events; spans get a span_id,
    #: and events inside a propagated trace share its trace_id
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


#: thread-local explicit trace id (set_trace_id); falls back to the
#: EDL_TRACE_ID env var — which is how a spawned child inherits the trace
_tls = threading.local()


def set_trace_id(trace_id: Optional[str]) -> None:
    """Pin the current trace id for this thread (None clears it)."""
    _tls.trace_id = trace_id


def current_trace_id() -> Optional[str]:
    tid = getattr(_tls, "trace_id", None)
    if tid:
        return tid
    return os.environ.get("EDL_TRACE_ID") or None


class SpanHandle:
    """An open span: close it with :meth:`end` (explicit begin/end for
    spans that outlive one ``with`` block, like a reform root that spans
    a supervisor loop iteration)."""

    __slots__ = ("_tracer", "name", "category", "t0", "trace_id",
                 "span_id", "parent_id", "args", "_done")

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 trace_id: Optional[str], parent_id: Optional[str],
                 args: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.category = category
        self.t0 = tracer._clock()
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.args = args
        self._done = False

    def end(self, **more) -> None:
        if self._done:  # idempotent: escalation paths may double-close
            return
        self._done = True
        t = self._tracer
        with t._lock:
            t._events.append(TraceEvent(
                self.name, self.category, self.t0, t._clock() - self.t0,
                {**self.args, **more}, trace_id=self.trace_id,
                span_id=self.span_id, parent_id=self.parent_id))


class Tracer:
    def __init__(self, capacity: int = 65536,
                 clock=time.perf_counter) -> None:
        self._events: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._clock = clock
        #: wall time when this tracer's clock read 0: what aligns the
        #: per-process clocks of two dumps on one axis
        self._wall_anchor = time.time() - self._clock()

    def instant(self, name: str, category: str = "event", **args) -> None:
        """Zero-duration marker (resize rolled back, ...)."""
        with self._lock:
            self._events.append(
                TraceEvent(name, category, self._clock(), 0.0, args,
                           trace_id=current_trace_id()))

    @contextmanager
    def span(self, name: str, category: str = "step",
             parent_id: Optional[str] = None, **args) -> Iterator[SpanHandle]:
        """Timed region; the event is recorded when the region exits.
        Yields the open :class:`SpanHandle` so nested work can parent
        itself (``parent_id=handle.span_id``)."""
        handle = SpanHandle(self, name, category, current_trace_id(),
                            parent_id, args)
        try:
            yield handle
        finally:
            handle.end()

    def begin(self, name: str, category: str = "event",
              trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, **args) -> SpanHandle:
        """Open a span explicitly; close it with ``handle.end()``."""
        return SpanHandle(self, name, category,
                          trace_id or current_trace_id(), parent_id, args)

    def from_wall(self, wall_ts: float) -> float:
        """A wall-clock timestamp on this tracer's clock axis (for spans
        whose start was observed in another process, e.g. the
        supervisor's spawn time seen from the world child)."""
        return wall_ts - self._wall_anchor

    def record_span(self, name: str, category: str, start_s: float,
                    end_s: float, trace_id: Optional[str] = None,
                    span_id: Optional[str] = None,
                    parent_id: Optional[str] = None, **args) -> str:
        """Append a span with explicit clock-axis timestamps (use
        :meth:`from_wall` for wall-observed starts).  Returns span_id."""
        sid = span_id or new_span_id()
        with self._lock:
            self._events.append(TraceEvent(
                name, category, start_s, max(end_s - start_s, 0.0), args,
                trace_id=trace_id or current_trace_id(),
                span_id=sid, parent_id=parent_id))
        return sid

    def events(self, category: Optional[str] = None) -> list[TraceEvent]:
        with self._lock:
            evs = list(self._events)
        if category is not None:
            evs = [e for e in evs if e.category == category]
        return evs

    def to_chrome_trace(self, process_name: Optional[str] = None) -> str:
        """Chrome trace-event JSON; the correlation ids travel in each
        event's ``args``, the wall anchor and process name in a top-level
        ``edl`` object (which chrome ignores)."""
        out = []
        if process_name:
            out.append({"name": "process_name", "ph": "M", "pid": 0,
                        "tid": 0, "args": {"name": process_name}})
        for e in self.events():
            args = dict(e.args)
            for k in ("trace_id", "span_id", "parent_id"):
                v = getattr(e, k)
                if v:
                    args[k] = v
            out.append({
                "name": e.name, "cat": e.category,
                "ph": "X" if e.duration_s > 0 else "i",
                "ts": e.start_s * 1e6, "dur": e.duration_s * 1e6,
                "pid": 0, "tid": 0, "args": args,
            })
        return json.dumps({
            "traceEvents": out,
            "edl": {"wall_anchor_s": self._wall_anchor,
                    "process": process_name or f"pid-{os.getpid()}"},
        })

    def dump(self, path: str, process_name: Optional[str] = None) -> None:
        with open(path, "w") as f:
            f.write(self.to_chrome_trace(process_name))


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer."""
    return _default_tracer


class TraceFileSink(threading.Thread):
    """Periodic atomic dumper of a tracer's ring to
    ``<dir>/trace-<name>.json``, so a live process's sampled request
    traces are recoverable without attaching anything.  Final dump on
    :meth:`stop`; a SIGKILLed process leaves its last interval's dump."""

    def __init__(self, trace_dir: str, name: str,
                 interval_s: float = 1.0, tracer: Optional[Tracer] = None
                 ) -> None:
        super().__init__(name=f"trace-sink-{name}", daemon=True)
        self.trace_dir = trace_dir
        self.proc_name = name
        self.interval_s = max(float(interval_s), 0.05)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.path = os.path.join(trace_dir, f"trace-{name}.json")
        self.dumps = 0
        self._halt = threading.Event()

    def dump_once(self) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(self.tracer.to_chrome_trace(self.proc_name))
            os.replace(tmp, self.path)
            self.dumps += 1
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def run(self) -> None:
        while not self._halt.wait(self.interval_s):
            self.dump_once()
        self.dump_once()  # final: the ring as of shutdown

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)
