"""Bounded in-process trace of named events, with cross-process span
correlation — the part of edl_tpu.observability.tracing that the runtime
calls.

Every span carries a ``span_id``; a reform opens a *root* span whose
``trace_id`` travels to other processes through the ``EDL_TRACE_ID``
environment variable and a coordinator KV key (runtime/multihost.py), so
the supervisor's and the world child's events read as one span tree.
:meth:`Tracer.dump` writes Chrome ``chrome://tracing`` JSON with the
process's wall-clock anchor, and a :class:`TraceFileSink` rewrites that
dump every second for a live serving process.  :meth:`Tracer.merge_files`
merges several dumps onto one wall-clock axis, and the loaders
(:func:`load_trace_events`, :func:`build_span_forest`,
:func:`render_trace_tree`, :func:`discover_trace_files`) read dumps and
flight records back into one trace's stitched cross-process span tree.
``python -m edl_tpu_torch.cli trace <id>`` prints it.
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
from typing import Iterable, Iterator, Optional


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

    # -- cross-process merge -------------------------------------------------

    @staticmethod
    def merge_files(paths, out_path: Optional[str] = None) -> dict:
        """Merge per-process chrome traces (written by :meth:`dump`) into
        one job-level timeline: each input file becomes one pid row, and
        every timestamp is shifted onto a shared wall-clock axis using
        the per-file ``edl.wall_anchor_s`` — so a reform recorded by the
        supervisor and its world child's startup phases line up as the
        one span tree they are.  Files without the anchor merge at their
        raw timestamps (degraded but never fatal).  Returns the merged
        document; writes it to ``out_path`` when given."""
        docs = []
        for p in paths:
            try:
                with open(p) as f:
                    docs.append((os.path.basename(p), json.load(f)))
            except (OSError, json.JSONDecodeError):
                continue
        anchors = [d.get("edl", {}).get("wall_anchor_s") for _, d in docs]
        # base over ANCHORED files only: an anchorless file (a pre-plane
        # dump, a foreign chrome trace) merges at its raw timestamps —
        # folding its implicit 0.0 into min() would instead shift every
        # anchored file by its full wall-clock epoch (~decades)
        known = [a for a in anchors if a is not None]
        base = min(known) if known else 0.0
        merged: list[dict] = []
        names: list[str] = []
        for pid, ((fname, doc), anchor) in enumerate(zip(docs, anchors)):
            pname = doc.get("edl", {}).get("process") or fname
            names.append(pname)
            merged.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": pname}})
            shift_us = (anchor - base) * 1e6 if anchor is not None else 0.0
            for e in doc.get("traceEvents", []):
                if e.get("ph") == "M":
                    continue  # replaced by our per-pid metadata
                e = dict(e)
                e["pid"] = pid
                e["ts"] = e.get("ts", 0.0) + shift_us
                merged.append(e)
        out = {"traceEvents": merged,
               "edl": {"wall_anchor_s": base, "merged_from": names}}
        if out_path:
            with open(out_path, "w") as f:
                json.dump(out, f)
        return out


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer."""
    return _default_tracer


# -- cross-process trace stitching (the `edl-tpu trace` surface) -------------
#
# The serving data plane samples request traces at the LB (origin) and
# propagates the trace id via X-EDL-Trace-Id into the front-door
# replicas (doc/serving.md §request tracing).  Each process dumps its
# ring as a merge_files-compatible chrome trace (TraceFileSink below) or
# embeds it in a flight record; these helpers read BOTH formats, align
# every event onto the shared wall-clock axis, and render one trace id's
# spans as the stitched cross-process tree an operator reads.


def load_trace_events(paths: Iterable[str],
                      trace_id: Optional[str] = None) -> list[dict]:
    """Read per-process trace dumps (``Tracer.dump`` chrome JSON) and
    flight records (``flightrec-*.json`` — their ``trace_events`` ride
    the same correlation ids) into normalized event dicts::

        {name, category, ts_s (wall), dur_s, proc, trace_id, span_id,
         parent_id, args}

    Timestamps are wall-aligned via each file's anchor (chrome dumps:
    ``edl.wall_anchor_s``; flight records: ``trace_wall_anchor_s``);
    anchorless files keep raw timestamps (degraded, never fatal).
    ``trace_id`` filters to one trace; unreadable files are skipped.
    The same span appearing in several sources (a ``trace-*.json`` dump
    AND a flight record embedding the same ring, or two flight records
    from one process) is deduplicated by span id — otherwise every
    duplicate occurrence would repeat whole subtrees in the rendered
    tree."""
    out: list[dict] = []
    seen: set[tuple] = set()

    def keep(e: dict) -> bool:
        key = ((e["trace_id"], e["span_id"]) if e["span_id"]
               else (e["trace_id"], e["name"], round(e["ts_s"], 9),
                     round(e["dur_s"], 9)))
        if key in seen:
            return False
        seen.add(key)
        return True
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        if "traceEvents" in doc:  # chrome dump (Tracer.dump)
            meta = doc.get("edl", {})
            anchor = meta.get("wall_anchor_s") or 0.0
            proc = meta.get("process") or os.path.basename(p)
            for e in doc.get("traceEvents", []):
                if e.get("ph") == "M":
                    continue
                args = dict(e.get("args") or {})
                tid = args.pop("trace_id", None)
                sid = args.pop("span_id", None)
                pid = args.pop("parent_id", None)
                if trace_id is not None and tid != trace_id:
                    continue
                ev = {
                    "name": e.get("name", ""),
                    "category": e.get("cat", ""),
                    "ts_s": e.get("ts", 0.0) / 1e6 + anchor,
                    "dur_s": e.get("dur", 0.0) / 1e6,
                    "proc": proc, "trace_id": tid, "span_id": sid,
                    "parent_id": pid, "args": args,
                }
                if keep(ev):
                    out.append(ev)
        elif "trace_events" in doc:  # flight record (metrics.py)
            anchor = doc.get("trace_wall_anchor_s") or 0.0
            proc = f"flightrec-pid{doc.get('pid', '?')}"
            for e in doc.get("trace_events", []):
                tid = e.get("trace_id")
                if trace_id is not None and tid != trace_id:
                    continue
                ev = {
                    "name": e.get("name", ""),
                    "category": e.get("category", ""),
                    "ts_s": e.get("start_s", 0.0) + anchor,
                    "dur_s": e.get("duration_s", 0.0),
                    "proc": proc, "trace_id": tid,
                    "span_id": e.get("span_id"),
                    "parent_id": e.get("parent_id"),
                    "args": dict(e.get("args") or {}),
                }
                if keep(ev):
                    out.append(ev)
    out.sort(key=lambda e: e["ts_s"])
    return out


def build_span_forest(events: list[dict]) -> list[dict]:
    """Nest span events by ``parent_id`` into a forest: each node is the
    event dict plus a ``children`` list (start-time ordered).  Spans
    whose parent is absent from ``events`` (a dropped dump, a ring that
    rotated) surface as roots rather than vanishing."""
    nodes = {e["span_id"]: {**e, "children": []}
             for e in events if e.get("span_id")}
    roots: list[dict] = []
    for e in events:
        node = nodes.get(e.get("span_id"))
        if node is None:  # an instant without a span id: its own root
            node = {**e, "children": []}
        parent = nodes.get(e.get("parent_id")) if e.get("parent_id") else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for n in nodes.values():
        n["children"].sort(key=lambda c: c["ts_s"])
    roots.sort(key=lambda c: c["ts_s"])
    return roots


def render_trace_tree(events: list[dict],
                      trace_id: Optional[str] = None) -> str:
    """Render one trace's stitched cross-process span tree.

    Offsets are milliseconds relative to the trace's earliest event;
    every line carries the recording process, the span's duration, and
    its annotations (hedge winner/loser, rescue kinds, phase names) —
    the ``edl-tpu trace <id>`` output."""
    if trace_id is not None:
        events = [e for e in events if e.get("trace_id") == trace_id]
    if not events:
        return "trace not found"
    t0 = min(e["ts_s"] for e in events)
    procs = sorted({e["proc"] for e in events})
    span_n = sum(1 for e in events if e.get("span_id"))
    dur_ms = (max(e["ts_s"] + e["dur_s"] for e in events) - t0) * 1e3
    tid = trace_id or events[0].get("trace_id") or "?"
    lines = [f"trace {tid}  —  {span_n} spans, {len(procs)} "
             f"process{'es' if len(procs) != 1 else ''}, "
             f"{dur_ms:.1f} ms total"]

    def fmt(node: dict) -> str:
        rel = (node["ts_s"] - t0) * 1e3
        args = " ".join(f"{k}={v}" for k, v in sorted(node["args"].items()))
        return (f"{node['name']}  [{node['proc']}]  "
                f"+{rel:.2f}ms {node['dur_s'] * 1e3:.2f}ms"
                + (f"  {args}" if args else ""))

    def walk(node: dict, prefix: str, last: bool) -> None:
        branch = "└─ " if last else "├─ "
        lines.append(prefix + branch + fmt(node))
        child_prefix = prefix + ("   " if last else "│  ")
        kids = node["children"]
        for i, c in enumerate(kids):
            walk(c, child_prefix, i == len(kids) - 1)

    roots = build_span_forest(events)
    for i, r in enumerate(roots):
        walk(r, "", i == len(roots) - 1)
    return "\n".join(lines)


def discover_trace_files(trace_dir: str) -> list[str]:
    """Every readable trace source under ``trace_dir``: chrome dumps
    (``trace-*.json``) and flight records (``flightrec-*.json``)."""
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return []
    return [os.path.join(trace_dir, n) for n in names
            if n.endswith(".json")
            and (n.startswith("trace-") or n.startswith("flightrec-"))]


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
