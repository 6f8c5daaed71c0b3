"""Task-lease data dispatch — the port of edl_tpu.runtime.data.

Role of the reference's master task queue + ``cloud_reader``
(example/train_ft.py:112: trainers lease RecordIO chunks from the master;
a dead trainer's chunks are re-dispatched after 16 s): data shards are
tasks in the coordination service's queue (:mod:`edl_tpu_torch.coord`);
trainers lease one, emit its batches, and mark it complete.  Elasticity
falls out: shard assignment is dynamic leases, so trainer count appears
nowhere.

:func:`shard_sizes` and :func:`_row_splits` pin the shard → rows map as a
pure function of ``(rows, shards)``, so every process at every world size
derives the same shard stream (the virtual-worker schedule,
:mod:`edl_tpu_torch.runtime.virtual`, plans against it).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterator, Optional

import numpy as np

from edl_tpu_torch.coord.service import LeaseStatus
from edl_tpu_torch.observability.logging import get_logger

log = get_logger("runtime.data")


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
    """Registers in-memory array shards as queue tasks and resolves leases
    back to data (the local stand-in for RecordIO files on shared
    storage)."""

    def __init__(self) -> None:
        self._shards: dict[int, tuple[np.ndarray, ...]] = {}

    def register_arrays(self, arrays: tuple[np.ndarray, ...],
                        num_shards: int) -> list[int]:
        """Split arrays row-wise into ``num_shards`` locally-resolvable
        shards (no queue interaction).  Every worker registers the same
        deterministic split; only one worker enqueues the tasks — the same
        separation as RecordIO files on shared storage vs. the master's
        task list (reference example/train_ft.py:112)."""
        ids = []
        for idx in _row_splits(arrays, num_shards):
            shard_id = len(self._shards)
            self._shards[shard_id] = tuple(a[idx] for a in arrays)
            ids.append(shard_id)
        return ids

    def get(self, shard_id: int) -> tuple[np.ndarray, ...]:
        return self._shards[shard_id]

    def enqueue(self, coord, shard_ids: list[int]) -> None:
        for shard_id in shard_ids:
            coord.add_task(json.dumps({"shard": shard_id}).encode())

    def add_arrays(self, coord, arrays: tuple[np.ndarray, ...],
                   num_shards: int) -> None:
        """Register + enqueue in one go (single-worker convenience)."""
        self.enqueue(coord, self.register_arrays(arrays, num_shards))

    def fetch(self, payload: bytes) -> tuple[np.ndarray, ...]:
        return self.get(json.loads(payload.decode())["shard"])


class FileShardStore:
    """Shard FILES on (shared) storage, leased through the queue — the
    role of the reference's RecordIO chunk files + master task list
    (example/train_ft.py:112: ``cloud_reader([shards], etcd)``): writers
    shard a dataset into files once; any number of trainers — joining and
    leaving freely — lease file payloads and stream them.  Unlike
    :class:`ShardRegistry`, nothing about the dataset lives in trainer
    memory until a shard is leased, so datasets scale past RAM and a
    fresh joiner needs no registration step.

    Format: one ``.npz`` per shard, arrays stored in batch order under
    keys ``a0..aN`` (numpy's own container — portable, seekable,
    compression-free for mmap-friendly reads)."""

    @staticmethod
    def write_shards(directory: str, arrays: tuple[np.ndarray, ...],
                     num_shards: int, prefix: str = "shard",
                     on_shard: Optional[Callable[[], None]] = None
                     ) -> list[str]:
        """Row-shard ``arrays`` into ``num_shards`` files; returns paths.
        Atomic per file (tmp + rename) so a concurrent reader can never
        see a truncated shard, and idempotent (same inputs → same bytes at
        the same paths) so a takeover re-write after a seeder crash is
        safe.  ``on_shard`` fires after each file — the seeding claim's
        liveness heartbeat."""
        import os

        os.makedirs(directory, exist_ok=True)
        paths = []
        for i, idx in enumerate(_row_splits(arrays, num_shards)):
            path = os.path.join(directory, f"{prefix}-{i:05d}.npz")
            tmp = path + ".tmp.npz"
            np.savez(tmp, **{f"a{j}": a[idx]
                             for j, a in enumerate(arrays)})
            os.replace(tmp, path)
            paths.append(path)
            if on_shard is not None:
                on_shard()
        return paths

    @staticmethod
    def enqueue(coord, paths: list[str]) -> None:
        for path in paths:
            coord.add_task(json.dumps({"file": path}).encode())

    @staticmethod
    def fetch_path(path: str) -> tuple[np.ndarray, ...]:
        with np.load(path) as z:
            return tuple(z[k] for k in sorted(z.files,
                                              key=lambda s: int(s[1:])))

    @staticmethod
    def fetch(payload: bytes) -> tuple[np.ndarray, ...]:
        return FileShardStore.fetch_path(
            json.loads(payload.decode())["file"])


def fetch_payload(payload: bytes,
                  registry: Optional[ShardRegistry] = None
                  ) -> tuple[np.ndarray, ...]:
    """Resolve either payload kind: ``{"shard": id}`` via the in-memory
    registry, ``{"file": path}`` via the file store — so one consumer
    iterates a queue regardless of how the dataset was published."""
    kind = json.loads(payload.decode())
    if "file" in kind:
        return FileShardStore.fetch_path(kind["file"])
    if registry is None:
        raise ValueError("shard-id payload without a registry")
    return registry.get(kind["shard"])


#: seeding-claim liveness: a claim not renewed for this long, with a
#: completely untouched queue, is a dead seeder and may be taken over
SEED_STALE_MS = 30_000


def ensure_seeded(coord, name: str, seed_fn: Callable[[Callable[[], None]],
                                                      None],
                  stale_ms: int = SEED_STALE_MS,
                  poll_s: float = 0.5) -> None:
    """Crash-safe one-time data seeding (closes the window a bare CAS
    leaves: a seeder dying between claiming and enqueueing would hang the
    job forever with an empty queue).

    Protocol on the ``data-seeder`` KV key: claim with a renewable
    ``seeding:<name>:<ms>`` marker, run ``seed_fn(beat)`` — which must
    call ``beat()`` periodically during long writes and enqueue the tasks
    as its LAST step — then flip the marker to ``seeded``.  Everyone else
    blocks here until the flip; a claim gone stale while the queue is
    still completely untouched is taken over (the file writes are
    idempotent).  Residual window: a seeder dying MID-ENQUEUE leaves a
    partially-filled queue that blocks takeover — but the enqueue is a
    few fast RPCs (the long dataset write happens before it), the same
    exposure the in-memory protocol always had."""
    import time as _time

    def now_ms() -> int:
        return int(_time.time() * 1000)

    def claim_bytes() -> bytes:
        return f"seeding:{name}:{now_ms()}".encode()

    #: when WE first observed a marker value we cannot parse an age out of
    #: (foreign writer, format drift) — such a marker is NOT proof of
    #: completed seeding (a pre-enqueue crash would leave the queue empty
    #: forever and the job would terminate 'drained' at step 0), so it is
    #: aged by our own clock and taken over like any stale claim.
    first_seen: dict[bytes, int] = {}

    while True:
        raw = coord.kv_get("data-seeder")
        if raw == b"seeded":
            return
        if raw is None:
            if not coord.kv_cas("data-seeder", b"", claim_bytes()):
                continue  # lost the race; re-read
        else:
            s = coord.stats()
            touched = s.todo or s.leased or s.done
            try:
                _, _, ts = raw.decode().split(":")
                age = now_ms() - int(ts)
            except ValueError:
                if touched:
                    return  # queue has real content; work can proceed
                log.warn("unrecognized data-seeder marker; waiting for "
                         "'seeded' flip, queue content, or staleness",
                         marker=raw[:64])
                age = now_ms() - first_seen.setdefault(raw, now_ms())
            if age < stale_ms or touched:
                _time.sleep(poll_s)
                continue
            if not coord.kv_cas("data-seeder", raw, claim_bytes()):
                continue  # someone else took over first
            log.warn("taking over stale seeding claim", stale=raw[:64])
        # we hold the claim
        beat = lambda: coord.kv_set("data-seeder", claim_bytes())
        seed_fn(beat)
        coord.kv_set("data-seeder", b"seeded")
        return


class TaskLeaseBatches:
    """Iterate minibatches by leasing shards from the coordination service.

    ``fetch`` maps a task payload to arrays (ShardRegistry.fetch locally; a
    shared-storage reader in production).  EMPTY (work in flight elsewhere) polls;
    DONE ends the epoch/pass stream.
    """

    def __init__(
        self,
        coord,
        worker: str,
        fetch: Callable[[bytes], tuple[np.ndarray, ...]],
        batch_size: int,
        poll_seconds: float = 0.05,
        drop_remainder: bool = True,
        on_task_done: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.coord = coord
        self.worker = worker
        self.fetch = fetch
        self.batch_size = batch_size
        self.poll_seconds = poll_seconds
        self.drop_remainder = drop_remainder
        self.on_task_done = on_task_done
        #: the task whose every batch has been handed out and which is not
        #: completed yet (completion waits for the next batch's request)
        self._handed_out: Optional[int] = None

    def finish(self) -> None:
        """Complete the task whose batches have all been handed out: what
        the next request would do first, for a consumer that stops asking
        (``LocalElasticJob.run(until=)``).  A no-op mid-task."""
        tid, self._handed_out = self._handed_out, None
        if tid is not None:
            self._complete(tid)

    def _complete(self, task_id: int) -> None:
        if not self.coord.complete(task_id, self.worker):
            # Lease expired and moved despite renewals (e.g. a stall
            # longer than the timeout): the shard will be re-trained
            # by another worker — log it, losing the race is safe but
            # duplicate gradients deserve a trace.
            log.warn("lease lost before completion; shard may be "
                     "trained twice", task_id=task_id, worker=self.worker)
        elif self.on_task_done is not None:
            self.on_task_done(task_id)

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        while True:
            status, task_id, payload = self.coord.lease(self.worker)
            if status == LeaseStatus.DONE:
                return
            if status == LeaseStatus.EMPTY:
                time.sleep(self.poll_seconds)
                continue
            arrays = self.fetch(payload)
            n = arrays[0].shape[0]
            stop = (n // self.batch_size) * self.batch_size \
                if self.drop_remainder else n
            for lo in range(0, stop, self.batch_size):
                if lo + self.batch_size >= stop:
                    self._handed_out = task_id
                yield tuple(a[lo:lo + self.batch_size] for a in arrays)
                if self._handed_out is None and lo + self.batch_size >= stop:
                    break  # finish() completed it while suspended
                # Keep-alive: a long shard must not look like a dead worker
                # (the 16 s clock measures silence, not shard size).
                renew = getattr(self.coord, "renew", None)
                if renew is not None:
                    renew(task_id, self.worker)
            else:
                self._handed_out = None
                self._complete(task_id)
