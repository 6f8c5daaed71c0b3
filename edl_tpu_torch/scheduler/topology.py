"""Slice-shape policies for the elastic planner — the port's copy of
edl_tpu.scheduler.topology.

The reference scales trainer counts in steps of ±1 (reference
pkg/autoscaler.go:201-291 returns ``additional ∈ {-1, 0, 1}``) because its
workers are interchangeable singletons.  A sharded or tp mesh is not: it
wants a count that divides its axes (a power of two keeps the all-reduce
tree balanced and every layout reshardable).  A :class:`SliceShapePolicy`
therefore quantizes the planner's walk over instance counts:
``next_up(cur)`` / ``next_down(cur)`` give the adjacent *valid* counts, and
the planner admits the whole step only if the cluster has headroom for all
of it.

``UNIT_POLICY`` (±1 steps) reproduces the reference behavior exactly and is
the default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence


@dataclass(frozen=True)
class SliceShapePolicy:
    """Quantizes instance counts to valid mesh sizes.

    Both step functions are bounded and return ``cur`` when no valid count
    exists inside the bound — "no step", never an infinite search.
    """

    name: str
    valid: Callable[[int], bool]

    def next_up(self, cur: int, hi: int) -> int:
        """Smallest valid count in (cur, hi], or ``cur`` if none."""
        for n in range(cur + 1, hi + 1):
            if self.valid(n):
                return n
        return cur

    def next_down(self, cur: int, lo: int = 0) -> int:
        """Largest valid count in [max(lo,0), cur), or ``cur`` if none."""
        for n in range(cur - 1, max(lo, 0) - 1, -1):
            if self.valid(n):
                return n
        return cur

    def clamp(self, hi: int, lo: int = 0) -> int:
        """Largest valid count in [max(lo,0), hi], or 0 if none.  Used when
        a job is found over its max: the planner jumps straight to this
        (the reference's ``additional = instanceMax - plannedInstance``,
        autoscaler.go:252-256, quantized)."""
        for n in range(hi, max(lo, 0) - 1, -1):
            if self.valid(n):
                return n
        return 0


UNIT_POLICY = SliceShapePolicy("unit", lambda n: True)

#: Power-of-two trainer counts (1, 2, 4, 8, ...): keeps per-job DP meshes
#: trivially reshardable and all-reduce trees balanced.
POW2_POLICY = SliceShapePolicy("pow2", lambda n: n > 0 and (n & (n - 1)) == 0)


def explicit_policy(counts: Sequence[int], name: str = "explicit") -> SliceShapePolicy:
    """Policy allowing exactly the given instance counts (e.g. the card
    counts a model's tp and fsdp axes divide: 1, 2, 4, 8, ...)."""
    allowed = frozenset(counts)
    return SliceShapePolicy(name, lambda n: n in allowed)
