"""Thread-safe labeled monotonic counters (``resizes_failed``, ...)."""

from __future__ import annotations

from edl_tpu_torch.observability.metrics import MetricsRegistry, get_registry


class Counters:
    """``inc("name", type="x")`` and ``get("name", type="x")`` agree: the
    labels are folded into the key in sorted order.  A facade over a
    :class:`MetricsRegistry`: the process-wide instance is backed by
    ``metrics.get_registry()``, so every count renders as
    ``edl_<name>_total{labels}``; a standalone ``Counters()`` gets a
    private registry."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self._registry = registry if registry is not None \
            else MetricsRegistry()

    def inc(self, name: str, n: int = 1, **labels: str) -> int:
        return int(self._registry.counter(name).inc(n, **labels))

    def get(self, name: str, **labels: str) -> int:
        return int(self._registry.counter(name).value(**labels))

    def total(self, name: str) -> int:
        """Sum over every label combination of ``name``."""
        return int(sum(self._registry.counter(name).series().values()))

    def snapshot(self) -> dict[str, int]:
        """Flat ``name{k=v,...}`` → count view of every counter that has
        counted (flight records, tests)."""
        out: dict[str, int] = {}
        for name, fam in sorted(self._registry.counter_families().items()):
            for labels, v in fam.series().items():
                key = name if not labels else name + "{" + ",".join(
                    f"{k}={val}" for k, val in labels) + "}"
                out[key] = int(v)
        return out


_default_counters = Counters(get_registry())


def get_counters() -> Counters:
    """The process-wide counters."""
    return _default_counters
