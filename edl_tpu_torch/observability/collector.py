"""Thread-safe labeled monotonic counters (``resizes_failed``, ...)."""

from __future__ import annotations

import threading


class Counters:
    """``inc("name", type="x")`` and ``get("name", type="x")`` agree: the
    labels are folded into the key in sorted order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, *sorted(labels.items()))

    def inc(self, name: str, n: int = 1, **labels: str) -> int:
        key = self._key(name, labels)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
            return self._counts[key]

    def get(self, name: str, **labels: str) -> int:
        with self._lock:
            return self._counts.get(self._key(name, labels), 0)


_default_counters = Counters()


def get_counters() -> Counters:
    """The process-wide counters."""
    return _default_counters
