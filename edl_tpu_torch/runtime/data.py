"""The deterministic shard contract — the part of edl_tpu.runtime.data that
needs no coordinator.

:func:`shard_sizes` and :func:`_row_splits` pin the shard → rows map as a
pure function of ``(rows, shards)``, and :class:`ShardRegistry` holds the
shards in memory, so every process at every world size derives the same
shard stream (the virtual-worker schedule, :mod:`edl_tpu_torch.runtime.
virtual`, plans against it).  The coordinator-backed half — task leases,
``FileShardStore``, ``ensure_seeded`` and ``TaskLeaseBatches`` — waits for
the port's coordinator (ROADMAP.md, queue 1 items 4-5).
"""

from __future__ import annotations

import numpy as np


def shard_sizes(n: int, num_shards: int) -> list[int]:
    """The shard-size contract as pure arithmetic (``np.array_split``
    semantics): the first ``n % num_shards`` shards get
    ``n // num_shards + 1`` rows, the rest ``n // num_shards``."""
    base, extra = divmod(int(n), int(num_shards))
    return [base + 1] * extra + [base] * (num_shards - extra)


def _row_splits(arrays: tuple[np.ndarray, ...],
                num_shards: int) -> list[np.ndarray]:
    """Row-split index sets for ``num_shards`` shards — order-preserving
    and contiguous.  The contract is asserted, not assumed: a drift in the
    split rule must fail here rather than silently train different data
    per worker."""
    n = arrays[0].shape[0]
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError("all arrays must share the leading dim")
    splits = np.array_split(np.arange(n), num_shards)
    sizes = [len(s) for s in splits]
    if sizes != shard_sizes(n, num_shards):
        raise AssertionError(
            f"shard split drifted from the (n={n}, num_shards="
            f"{num_shards}) size contract: {sizes}")
    pos = 0
    for i, s in enumerate(splits):
        if len(s) and (s[0] != pos or s[-1] != pos + len(s) - 1):
            raise AssertionError(
                f"shard {i} is not the contiguous order-preserving "
                f"slice starting at row {pos}")
        pos += len(s)
    if pos != n:
        raise AssertionError(f"shards cover {pos} rows of {n}")
    return splits


class ShardRegistry:
    """In-memory array shards, resolvable by shard id."""

    def __init__(self) -> None:
        self._shards: dict[int, tuple[np.ndarray, ...]] = {}

    def register_arrays(self, arrays: tuple[np.ndarray, ...],
                        num_shards: int) -> list[int]:
        """Split ``arrays`` row-wise into ``num_shards`` shards; returns
        their ids.  Every worker registers the same deterministic split."""
        ids = []
        for idx in _row_splits(arrays, num_shards):
            shard_id = len(self._shards)
            self._shards[shard_id] = tuple(a[idx] for a in arrays)
            ids.append(shard_id)
        return ids

    def get(self, shard_id: int) -> tuple[np.ndarray, ...]:
        return self._shards[shard_id]
