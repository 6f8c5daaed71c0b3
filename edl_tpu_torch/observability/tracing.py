"""Bounded in-process trace of named events."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass(frozen=True)
class TraceEvent:
    name: str
    category: str
    start_s: float
    duration_s: float
    args: dict = field(default_factory=dict)


class Tracer:
    def __init__(self, capacity: int = 65536) -> None:
        self._events: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def instant(self, name: str, category: str = "event", **args) -> None:
        """Zero-duration marker (resize rolled back, ...)."""
        with self._lock:
            self._events.append(
                TraceEvent(name, category, time.perf_counter(), 0.0, args))

    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer."""
    return _default_tracer
