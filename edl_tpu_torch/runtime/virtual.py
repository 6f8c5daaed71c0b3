"""Virtual workers: training semantics that are world-size-invariant — the
port of edl_tpu.runtime.virtual over the SPMD ``ElasticTrainer``.

Fix **V virtual workers** at job submission and make every source of
nondeterminism a function of the *job*, never of the physical world (the
EasyScale framing, arxiv 2208.14228):

* **Deterministic data ownership** — VW ``v`` owns shards
  ``v, v+V, v+2V, …`` of the deterministic shard stream
  (:func:`edl_tpu_torch.runtime.data._row_splits` pins the stream itself);
  its row stream is those shards' rows concatenated in registration
  order.  Physical workers are assigned whole VWs by
  :class:`OwnershipMap` — remapped on every membership epoch, counted
  (``vw_remaps``) and published to a KV store.  Batch content at global
  step ``s`` is a pure function of ``(dataset, V, s)``.
* **Consumed-offset cursors** — :class:`VirtualBatches` tracks one
  row-offset per VW, checkpointable mid-shard (:class:`CursorStore` /
  checkpoint ``meta``), so a resize or crash resumes the stream
  **exactly-once**: no row trained twice, none dropped.
* **Derived RNG lineage** — per-VW generators are *derived*, never
  carried: :func:`vw_key` seeds a ``torch.Generator`` with a fixed 64-bit
  mix of ``(job_seed, vw, step)``, so any physical layout derives the
  same draws for VW ``v`` at step ``s``.
* **Constant effective batch** — :class:`VirtualWorkerLoop` drives
  :meth:`ElasticTrainer.step_accumulate`: the V micro-batches of a step
  are accumulated in fixed VW order and applied as ONE optimizer update,
  so the update equals the never-resized run's (bitwise in replicated
  accumulation mode; within :data:`DEFAULT_LOSS_ATOL` /
  :data:`DEFAULT_LOSS_RTOL` in the dp-packed mode, whose all-reduce
  regroups float sums with the world size).

**SPMD.**  Every rank of the default process group runs the same loop with
the same :class:`VirtualConfig` and data, so every rank applies the same
world at the same step boundary (a resize is a collective of every rank).
A rank standing by gets None from ``step_accumulate``: it advances its
cursors like the others, but appends no loss and commits no rows, so rank
0's report is the job's report.  Only rank 0 — live in every world — writes
the checkpoint, the KV cursors and the ownership map; a sharded trainer's
(fsdp, or placed by partition specs) live ranks gather its whole state to
rank 0 for each save (:meth:`ElasticTrainer.whole_state`), so a step is the
same whatever layout wrote it.  Every rank restores from the same store the
step rank 0 picks, once rank 0 has reached the restore (so no rank reads a
step rank 0 is still writing), into the trainer's live layout, which may
differ from the one that saved; the restore raises on every rank unless all
of them restored that same step.

The KV store is anything with ``kv_set(key, bytes)`` and
``kv_get(key) -> bytes | None``.

**SDC.**  ``sdc=`` takes an :class:`~edl_tpu_torch.runtime.sdc.SdcPlane`,
consulted after every update on every rank (a rank standing by too, with no
loss): under a process group the live replicas' fingerprints are
cross-checked, rank 0 judges and every rank takes its verdict (the plane's
module docstring).  A confirmed corruption rolls every rank
back to the verdict's verified checkpoint at the same step boundary — the
restore :meth:`VirtualWorkerLoop.restore_latest` uses, into the trainer's
live layout, the cursors of that step, and the ledger and trajectory
rewound — and the loop replays through the cursors, so the stitched
trajectory is bitwise an uninjected run's (replicated accumulation).  A
refuted NaN loss report is replaced by the shadow's honest loss.  A sharded
trainer's blocks are folded where they live and combined across its live
ranks (:meth:`ElasticTrainer.lane_folds`), so its fingerprint is the whole
tree's, a replicated trainer's on the same parameters.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.device import resolve
from edl_tpu_torch.interop import keystr
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.runtime.checkpoint import param_path
from edl_tpu_torch.runtime.sdc import BlockFolds

log = get_logger("runtime.virtual")

#: KV keys (prefix + job name)
VW_MAP_KEY = "vw-map/{job}"
VW_CURSOR_KEY = "vw-cursor/{job}"

#: loss-trajectory tolerance policy: the dp-packed accumulation mode
#: reorders floating-point reductions with the world size, so "identical"
#: means within this envelope; the replicated mode is held to bitwise
DEFAULT_LOSS_ATOL = 5e-3
DEFAULT_LOSS_RTOL = 1e-3

_MASK64 = (1 << 64) - 1


# -- RNG lineage -------------------------------------------------------------


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def vw_seed(job_seed: int, vw_id: int, step: int) -> int:
    """The 64-bit seed of VW ``vw_id`` at ``step``: splitmix64 folded over
    the job seed, the VW and the step — a fixed function of job-level
    identifiers (never Python's per-process salted ``hash``)."""
    acc = _splitmix64(int(job_seed) & _MASK64)
    acc = _splitmix64(acc ^ (int(vw_id) & _MASK64))
    return _splitmix64(acc ^ (int(step) & _MASK64))


def vw_key(job_seed: int, vw_id: int, step: int,
           device="cuda") -> torch.Generator:
    """The per-(virtual worker, step) generator on ``device``, seeded with
    :func:`vw_seed`: every physical layout derives the same generator, so a
    resize changes which rank draws VW ``v``'s numbers, never the numbers.

    The streams are the same for every layout on one device type; a CUDA
    and a CPU generator with the same seed give different streams, so a run
    keeps one device type."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(vw_seed(job_seed, vw_id, step))
    return gen


def vw_keys(job_seed: int, vw_count: int, step: int,
            device="cuda") -> list[torch.Generator]:
    """All V generators for one global step, in VW order."""
    return [vw_key(job_seed, v, step, device) for v in range(vw_count)]


# -- job-level configuration -------------------------------------------------


@dataclass(frozen=True)
class VirtualConfig:
    """Everything fixed at job submission that training semantics may
    depend on.  Nothing here may change at a resize."""

    #: V — the virtual world size.  Choose it as the largest world the
    #: autoscaler may ever grant (or an LCM-friendly multiple); any
    #: physical world must divide it for the dp-packed accumulation
    #: path, and :meth:`snap_world` snaps arbitrary pod counts down.
    vw_count: int
    #: B — the effective global batch, constant through every resize.
    global_batch: int
    job_seed: int = 0

    def __post_init__(self) -> None:
        if self.vw_count < 1:
            raise ValueError(f"vw_count must be >= 1, got {self.vw_count}")
        if self.global_batch % self.vw_count != 0:
            raise ValueError(
                f"global_batch {self.global_batch} must divide evenly "
                f"into vw_count {self.vw_count} micro-batches")

    @property
    def micro_batch(self) -> int:
        """Rows per VW micro-step: B / V."""
        return self.global_batch // self.vw_count

    def snap_world(self, n: int) -> int:
        """Largest world size <= n that divides V (>= 1).  The virtual
        layer's analogue of the batch-divisor snap: a physical world
        must run whole VWs, ceil(V/N) each, with N | V so every step's
        accumulation covers exactly the V micro-batches."""
        n = max(int(n), 1)
        while n > 1 and self.vw_count % n != 0:
            n -= 1
        return n


# -- deterministic ownership -------------------------------------------------


def assign_ownership(vw_count: int, workers: Sequence[str]) -> dict[int, str]:
    """VW id → physical worker, deterministically: workers are taken in
    sorted-name order (the same stable rank order the multihost world
    uses) and VW ``v`` lands on worker ``v mod N`` — each physical
    worker runs ceil(V/N) VW micro-steps per global step."""
    ws = sorted(dict.fromkeys(workers))
    if not ws:
        raise ValueError("ownership needs at least one worker")
    return {v: ws[v % len(ws)] for v in range(vw_count)}


class OwnershipMap:
    """The live VW→worker assignment, remapped on every membership
    change and published to the job's KV store.

    Replaces first-come lease racing: which worker *executes* VW ``v``
    is policy (this map); *what* VW ``v`` trains on is fixed by the
    schedule — so a remap moves work, never data order."""

    def __init__(self, vw_count: int, workers: Sequence[str]) -> None:
        self.vw_count = int(vw_count)
        self.mapping = assign_ownership(self.vw_count, workers)
        self.remaps = 0

    def remap(self, workers: Sequence[str]) -> int:
        """Re-assign for a new worker set; returns how many VWs moved
        (and counts them into ``vw_remaps``)."""
        new = assign_ownership(self.vw_count, workers)
        moved = sum(1 for v in new if new[v] != self.mapping.get(v))
        if moved:
            get_counters().inc("vw_remaps", moved)
            get_tracer().instant("vw_remapped", category="elastic",
                                 moved=moved, workers=len(set(workers)),
                                 vw_count=self.vw_count)
            self.remaps += 1
        self.mapping = new
        return moved

    def owned_by(self, worker: str) -> list[int]:
        return [v for v, w in self.mapping.items() if w == worker]

    # -- KV round-trip ---------------------------------------------------

    def to_json(self) -> bytes:
        return json.dumps({"vw_count": self.vw_count,
                           "mapping": {str(v): w for v, w in
                                       sorted(self.mapping.items())}},
                          sort_keys=True).encode()

    def publish(self, kv, job: str = "job") -> None:
        kv.kv_set(VW_MAP_KEY.format(job=job), self.to_json())

    @classmethod
    def load(cls, kv, job: str = "job") -> Optional["OwnershipMap"]:
        raw = kv.kv_get(VW_MAP_KEY.format(job=job))
        if raw is None:
            return None
        try:
            doc = json.loads(raw.decode())
            m = cls.__new__(cls)
            m.vw_count = int(doc["vw_count"])
            m.mapping = {int(v): w for v, w in doc["mapping"].items()}
            m.remaps = 0
            return m
        except (ValueError, KeyError, TypeError) as exc:
            log.warn("torn vw-map in KV; ignoring", error=str(exc)[:120])
            return None

    @classmethod
    def publish_for(cls, kv, vw_count: int, workers: Sequence[str],
                    job: str = "job") -> "OwnershipMap":
        """One-shot leader-side publication (the multihost world child's
        hook): load the previous map, remap onto ``workers`` so the
        moved-VW delta is counted, publish, return the new map."""
        prev = cls.load(kv, job)
        if prev is not None and prev.vw_count == int(vw_count):
            prev.remap(workers)
            prev.publish(kv, job)
            return prev
        m = cls(vw_count, workers)
        m.publish(kv, job)
        return m


# -- deterministic shard schedule + cursors ----------------------------------


class VirtualShardSchedule:
    """VW ``v`` owns shards ``v, v+V, …`` (by position in the
    deterministic shard list); its row stream is those shards' rows in
    order.  Pure geometry — resolves (vw, stream offset) to concrete
    (shard position, row) pairs, including mid-shard."""

    def __init__(self, vw_count: int, shard_sizes: Sequence[int]) -> None:
        self.vw_count = int(vw_count)
        self.shard_sizes = [int(s) for s in shard_sizes]
        #: global row id base per shard (row identity for the
        #: exactly-once accounting)
        self.shard_base = np.concatenate(
            ([0], np.cumsum(self.shard_sizes)))[:-1]
        self._owned = {v: list(range(v, len(self.shard_sizes),
                                     self.vw_count))
                       for v in range(self.vw_count)}

    def owned_shards(self, vw: int) -> list[int]:
        return self._owned[vw]

    def stream_len(self, vw: int) -> int:
        return sum(self.shard_sizes[s] for s in self._owned[vw])

    def rows(self, vw: int, lo: int, hi: int) -> list[tuple[int, int, int]]:
        """Stream slice [lo, hi) of VW ``vw`` as
        ``(shard_index, row_in_shard, global_row_id)`` triples — the
        resolver a mid-shard cursor resumes through."""
        out: list[tuple[int, int, int]] = []
        off = 0
        for s in self._owned[vw]:
            n = self.shard_sizes[s]
            a, b = max(lo - off, 0), min(hi - off, n)
            for r in range(a, b):
                out.append((s, r, int(self.shard_base[s]) + r))
            off += n
            if off >= hi:
                break
        if len(out) != hi - lo:
            raise IndexError(
                f"vw {vw} stream slice [{lo},{hi}) exceeds stream "
                f"length {self.stream_len(vw)}")
        return out


class CursorStore:
    """Per-job consumed-offset cursors in the job's KV store: with a
    replicated KV, a promoted standby serves the same cursors after a
    primary kill."""

    def __init__(self, kv, job: str = "job") -> None:
        self._kv = kv
        self._key = VW_CURSOR_KEY.format(job=job)

    def save(self, state: dict) -> None:
        self._kv.kv_set(self._key, json.dumps(state, sort_keys=True).encode())

    def load(self) -> Optional[dict]:
        raw = self._kv.kv_get(self._key)
        if raw is None:
            return None
        try:
            return json.loads(raw.decode())
        except ValueError as exc:
            # torn cursor blob: callers fall back to the pure
            # derive-from-step cursors (VirtualBatches.cursors_for_step)
            log.warn("torn vw-cursor blob in KV; deriving from step",
                     error=str(exc)[:120])
            get_counters().inc("vw_cursor_torn")
            return None


class VirtualBatches:
    """The deterministic micro-batch stream: step ``s`` yields V
    micro-batches (one per VW, in VW order) whose content is a pure
    function of (dataset, V, s) — never of the physical world.

    Stateful only through the per-VW consumed-offset cursors, which are
    checkpointable (:meth:`state` / :meth:`restore`) at micro-step
    granularity, including mid-shard — the exactly-once resume point a
    resize or crash recovers through.
    """

    def __init__(self, cfg: VirtualConfig, shard_ids: Sequence[int],
                 fetch_shard: Callable[[int], tuple[np.ndarray, ...]],
                 passes: int = 1) -> None:
        self.cfg = cfg
        self.shard_ids = list(shard_ids)
        self.fetch_shard = fetch_shard
        self.passes = int(passes)
        sizes = [int(fetch_shard(sid)[0].shape[0]) for sid in self.shard_ids]
        self.schedule = VirtualShardSchedule(cfg.vw_count, sizes)
        #: steps per pass: bounded by the *shortest* VW stream (trailing
        #: rows that cannot fill a full micro-batch on every VW are
        #: dropped deterministically — identically at any world size —
        #: and accounted separately from lost rows)
        m = cfg.micro_batch
        self.steps_per_pass = min(
            self.schedule.stream_len(v) // m for v in range(cfg.vw_count))
        if self.steps_per_pass == 0:
            # a VW with no full micro-batch would make the whole stream
            # yield zero steps SILENTLY (and poison cursors_for_step
            # with a division by zero) — reject at construction: either
            # the dataset is too small for V or the shard count starves
            # some VW (fewer shards than virtual workers)
            starved = [v for v in range(cfg.vw_count)
                       if self.schedule.stream_len(v) < m]
            raise ValueError(
                f"virtual workers {starved} own fewer than one "
                f"micro-batch ({m} rows) of the shard stream "
                f"({len(self.shard_ids)} shards, sizes {sizes[:8]}…) — "
                f"lower vw_count or publish more/larger shards")
        self.rows_dropped_remainder = sum(
            self.schedule.stream_len(v) - self.steps_per_pass * m
            for v in range(cfg.vw_count)) * self.passes
        self.step = 0
        self.cursors = {v: 0 for v in range(cfg.vw_count)}
        self.pass_no = 0
        #: global row ids of the most recent step's micro-batches, per
        #: VW — the loop commits them to its exactly-once ledger only
        #: after the optimizer update applied
        self.last_step_rows: list[np.ndarray] = []
        self._cache: dict[int, tuple[np.ndarray, ...]] = {}

    # -- cursors ---------------------------------------------------------

    def state(self) -> dict:
        """Checkpointable cursor state (JSON-safe)."""
        return {"version": 1, "step": self.step, "pass": self.pass_no,
                "cursors": {str(v): int(off)
                            for v, off in self.cursors.items()}}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.pass_no = int(state["pass"])
        self.cursors = {int(v): int(off)
                        for v, off in state["cursors"].items()}

    def cursors_for_step(self, step: int) -> dict:
        """Pure fallback when the persisted cursor blob is torn: in the
        aligned schedule (all VWs advance m rows per step) the cursors
        are derivable from the step count alone."""
        m = self.cfg.micro_batch
        within = int(step) % self.steps_per_pass
        return {"version": 1, "step": int(step),
                "pass": int(step) // self.steps_per_pass,
                "cursors": {str(v): within * m
                            for v in range(self.cfg.vw_count)}}

    # -- the stream ------------------------------------------------------

    def _fetch(self, shard_pos: int) -> tuple[np.ndarray, ...]:
        sid = self.shard_ids[shard_pos]
        arrays = self._cache.get(sid)
        if arrays is None:
            arrays = self.fetch_shard(sid)
            # bounded shard cache: one resident shard per VW plus slack
            # for micro-batches straddling a boundary
            if len(self._cache) > self.cfg.vw_count + 2:
                self._cache.pop(next(iter(self._cache)))
            self._cache[sid] = arrays
        return arrays

    def next_step(self) -> Optional[list[tuple[np.ndarray, ...]]]:
        """The next global step's V micro-batches (VW order), or None
        when every pass is exhausted.  Advances the cursors."""
        if self.pass_no >= self.passes:
            return None
        m = self.cfg.micro_batch
        within = self.step - self.pass_no * self.steps_per_pass
        if within >= self.steps_per_pass:
            # pass boundary: drop each VW's remainder (deterministic),
            # rewind the streams for the next pass
            self.pass_no += 1
            self.cursors = {v: 0 for v in self.cursors}
            if self.pass_no >= self.passes:
                return None
        micro: list[tuple[np.ndarray, ...]] = []
        rows_per_vw: list[np.ndarray] = []
        for v in range(self.cfg.vw_count):
            lo = self.cursors[v]
            triples = self.schedule.rows(v, lo, lo + m)
            per_leaf: Optional[list[list[np.ndarray]]] = None
            ids = np.empty((m,), np.int64)
            for i, (shard_pos, row, gid) in enumerate(triples):
                arrays = self._fetch(shard_pos)
                if per_leaf is None:
                    per_leaf = [[] for _ in arrays]
                for j, a in enumerate(arrays):
                    per_leaf[j].append(a[row])
                ids[i] = gid
            micro.append(tuple(np.stack(col) for col in per_leaf))
            rows_per_vw.append(ids)
            self.cursors[v] = lo + m
        self.step += 1
        self.last_step_rows = rows_per_vw
        return micro

    @property
    def total_steps(self) -> int:
        return self.steps_per_pass * self.passes


# -- the loop + equivalence helpers ------------------------------------------


@dataclass
class VirtualRunReport:
    losses: list[float] = field(default_factory=list)
    world_sizes: list[int] = field(default_factory=list)
    resizes: int = 0
    vw_moves: int = 0
    #: confirmed-corruption rollbacks the loop performed (SDC plane)
    rollbacks: int = 0
    #: exactly-once ledger: global row id → times an APPLIED update
    #: trained on it (rows consumed by an aborted accumulation are
    #: re-fetched on restore and must appear exactly once here)
    rows_trained: dict[int, int] = field(default_factory=dict)

    def rows_duplicated(self) -> int:
        return sum(c - 1 for c in self.rows_trained.values() if c > 1)

    def rows_missing(self, expected: int) -> int:
        return expected - len(self.rows_trained)


class VirtualWorkerLoop:
    """The loop over the virtual-worker layer, run by every rank (see the
    module docstring).

    Per global step: snap the desired world to a divisor of V, apply the
    resize at the step boundary (remapping and publishing the ownership
    map), assemble the V micro-batches, derive the per-VW generators, and
    run ONE accumulated optimizer update.  Checkpoints at a cadence carry
    the cursor and RNG meta so a crash resumes exactly-once.
    """

    def __init__(self, trainer, cfg: VirtualConfig,
                 batches: VirtualBatches,
                 kv=None, job: str = "job",
                 checkpointer=None, ckpt_every: int = 0,
                 augment: Optional[Callable[[tuple, Any], tuple]] = None,
                 report: Optional[VirtualRunReport] = None,
                 sdc=None) -> None:
        if sdc is not None and not callable(getattr(sdc, "after_step",
                                                    None)):
            raise TypeError(f"sdc= takes an SdcPlane, not {type(sdc)}")
        self.trainer = trainer
        self.cfg = cfg
        self.batches = batches
        self.kv = kv
        self.job = job
        self.checkpointer = checkpointer
        self.ckpt_every = int(ckpt_every)
        #: host-side deterministic augmentation: (micro_batch, generator)
        #: → micro_batch, drawn from the VW lineage, so identical at any
        #: world size
        self.augment = augment
        #: the SDC defense plane (:class:`edl_tpu_torch.runtime.sdc.
        #: SdcPlane`), consulted after every update
        self.sdc = sdc
        #: (step, row ids) of each step this rank committed, kept only
        #: under an SDC plane so a rollback can rewind the ledger
        self._committed: Optional[list[tuple[int, list[int]]]] = (
            [] if sdc is not None else None)
        self.report = report or VirtualRunReport()
        self.ownership: Optional[OwnershipMap] = None
        self.cursors = CursorStore(kv, job) if kv is not None else None
        #: rank 0 writes the checkpoint, the cursors and the map
        self.writer = trainer.rank == 0
        self.trainer.state.job_seed = cfg.job_seed

    # -- checkpoint/restore ---------------------------------------------

    def _meta(self) -> dict:
        return {"cursor": self.batches.state(),
                "rng": {"job_seed": self.cfg.job_seed,
                        "vw_count": self.cfg.vw_count},
                "global_batch": self.cfg.global_batch}

    def _rank0(self, value: int) -> int:
        """Rank 0's ``value`` on every rank of the default group."""
        t = torch.tensor([value], dtype=torch.int64,
                         device=self.trainer.device)
        dist.broadcast(t, 0)
        return int(t.item())

    def _min_max(self, value: int) -> tuple[int, int]:
        """The least and the greatest ``value`` of the default group."""
        t = torch.tensor([value, -value], dtype=torch.int64,
                         device=self.trainer.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t[0].item()), -int(t[1].item())

    def restore_latest(self) -> Optional[int]:
        """Restore trainer state + cursors from the newest verified
        checkpoint (plus KV cursors when available).  Returns the
        restored step or None.  A torn/missing cursor meta falls back
        to the pure derive-from-step cursors — the torn-cursor path.

        Every rank of the default group calls it.  Rank 0 picks the step
        and broadcasts it (no rank reads a step before rank 0, which wrote
        it, has come this far); every rank restores it, and the ranks
        then agree on the step each actually restored — a rank whose read
        fell back alone would train on other weights than its peers, so
        any disagreement raises on every rank.  Each rank takes its blocks
        for the trainer's current layout
        (:meth:`ElasticTrainer.load_whole_state`), whatever layout wrote
        the step.  The step counter, the meta and the cursors are those of
        the step restored, which is older than the one asked for when the
        restore fell back."""
        if self.checkpointer is None:
            return None
        group = dist.is_available() and dist.is_initialized()
        step = (self.checkpointer.latest_verified_step()
                if self.writer or not group else None)
        if group:
            step = self._rank0(-1 if step is None else step)
            step = None if step < 0 else step
        if step is None:
            return None
        return self._restore(step)

    def _restore(self, step: int) -> int:
        """Every rank: restore ``step`` (or the newest good step before it)
        into the trainer's live layout, agree that every rank restored the
        same one, and take its cursors; returns the step restored."""
        group = dist.is_available() and dist.is_initialized()
        tree = {"params": self.trainer.state.params,
                "opt": self.trainer.state.opt_state}
        error: Optional[BaseException] = None
        try:
            restored = self.checkpointer.restore(tree, step=step,
                                                 shardings=self.trainer)
            got = self.checkpointer.last_restored_step
        except Exception as exc:  # re-raised below, after the agreement
            error, got = exc, -1
        if group:
            lo, hi = self._min_max(got)
            if lo != hi:
                raise RuntimeError(
                    f"ranks restored different checkpoint steps (from {lo} "
                    f"to {hi}; this rank {got}, asked for {step}): their "
                    "weights would diverge") from error
        if error is not None:
            raise error
        step = got
        self.trainer.state.params = restored["params"]
        self.trainer.state.opt_state = restored["opt"]
        self.trainer.state.step = step
        meta = self.checkpointer.load_meta(step)
        if meta is not None:
            # the sidecar persists the INVARIANTS so a restart under a
            # drifted config cannot silently resume cursors from a
            # different schedule — a configuration error, not a fallback
            rng = meta.get("rng") or {}
            expect = {"vw_count": self.cfg.vw_count,
                      "job_seed": self.cfg.job_seed,
                      "global_batch": self.cfg.global_batch}
            got = {"vw_count": rng.get("vw_count"),
                   "job_seed": rng.get("job_seed"),
                   "global_batch": meta.get("global_batch")}
            drift = {k: (got[k], expect[k]) for k in expect
                     if got[k] is not None and got[k] != expect[k]}
            if drift:
                raise ValueError(
                    f"checkpoint step {step} was written under a "
                    f"different virtual-worker config: {drift} "
                    "(got, want) — resuming would break exactly-once "
                    "and the RNG lineage; restore with the original "
                    "VirtualConfig")
        cursor = (meta or {}).get("cursor")
        if cursor is None and self.cursors is not None:
            kv_state = self.cursors.load()
            if kv_state is not None and int(kv_state.get("step", -1)) == step:
                cursor = kv_state
        if cursor is None:
            cursor = self.batches.cursors_for_step(step)
            log.warn("cursor meta missing/torn; derived from step",
                     step=step)
        self.batches.restore(cursor)
        return step

    # -- the loop --------------------------------------------------------

    def _apply_world(self, n: int) -> None:
        n = self.cfg.snap_world(n)
        workers = [f"pw{i}" for i in range(n)]
        if self.ownership is None:
            self.ownership = OwnershipMap(self.cfg.vw_count, workers)
            if self.kv is not None and self.writer:
                self.ownership.publish(self.kv, self.job)
        if not self.trainer.matches(n):
            if self.trainer.resize(n):
                self.report.resizes += 1
                moved = self.ownership.remap(workers)
                self.report.vw_moves += moved
                if self.kv is not None and self.writer:
                    self.ownership.publish(self.kv, self.job)

    def run(self, max_steps: Optional[int] = None,
            world_size_for: Optional[Callable[[int], int]] = None,
            on_step: Optional[Callable[[int, float, int], None]] = None
            ) -> VirtualRunReport:
        """Advance the stream ``max_steps`` steps (every rank counts the
        steps it took part in, live or not; a rollback takes back the steps
        it undoes, so they are replayed within the same call);
        ``on_step(step, loss, world)`` runs on the live ranks after each
        applied update."""
        start = self.batches.step
        while max_steps is None or self.batches.step - start < max_steps:
            step = self.batches.step
            if world_size_for is not None:
                self._apply_world(world_size_for(step))
            elif self.ownership is None:
                self._apply_world(self.trainer.world_size)
            micro = self.batches.next_step()
            if micro is None:
                break
            # derive the generators only when something consumes them
            keys = None
            if self.augment is not None or self.trainer.rng_in_loss:
                keys = vw_keys(self.cfg.job_seed, self.cfg.vw_count,
                               self.batches.step - 1,
                               device=self.trainer.device)
            if self.augment is not None:
                micro = [self.augment(mb, k) for mb, k in zip(micro, keys)]
            loss = self.trainer.step_accumulate(
                micro, rng_keys=keys if self.trainer.rng_in_loss else None)
            if self.sdc is not None:
                # the SDC ladder runs BEFORE the step's effects commit: a
                # confirmed corruption must never reach the ledger, the
                # trajectory or a verified save
                verdict = self.sdc.after_step(
                    self.batches.step, loss, self._fingerprinted(),
                    gather=self._gather if dist.is_available()
                    and dist.is_initialized() else None)
                if verdict is not None:
                    if verdict.outcome == "confirmed":
                        if self._rollback(verdict):
                            continue  # replay from the verified anchor
                    elif (loss is not None and not np.isfinite(loss)
                          and np.isfinite(verdict.shadow_loss)):
                        # refuted NaN: the params are clean and the shadow
                        # recomputed the honest loss — repair the METRIC
                        loss = verdict.shadow_loss
                        get_counters().inc("sdc_losses_repaired")
            if loss is None:
                continue  # standing by: cursors advanced, nothing applied
            # the update APPLIED: commit this step's rows to the
            # exactly-once ledger and persist the cursors
            gids = [gid for ids in self.batches.last_step_rows
                    for gid in ids.tolist()]
            for gid in gids:
                self.report.rows_trained[gid] = (
                    self.report.rows_trained.get(gid, 0) + 1)
            if self._committed is not None:
                self._committed.append((self.batches.step, gids))
            if self.cursors is not None and self.writer:
                self.cursors.save(self.batches.state())
            self.report.losses.append(float(loss))
            self.report.world_sizes.append(self.trainer.world_size)
            if (self.checkpointer is not None and self.ckpt_every
                    and self.batches.step % self.ckpt_every == 0):
                if self.writer:
                    self.checkpointer.save(self.batches.step,
                                           self.trainer.whole_state,
                                           meta=self._meta())
                elif self.trainer.sharded:
                    self.trainer.whole_state()  # this rank's gathers

            if on_step is not None:
                on_step(self.batches.step, float(loss),
                        self.trainer.world_size)
        if self.sdc is not None:
            self.sdc.fingerprinter.drain()
        return self.report

    def _fingerprinted(self):
        """What the SDC plane fingerprints: the module's parameters, or a
        sharded trainer's blocks folded in place
        (:class:`~edl_tpu_torch.runtime.sdc.BlockFolds`)."""
        tr = self.trainer
        if not tr.sharded:
            return tr.state.params
        return BlockFolds(
            lanes=tr.lane_folds, device=tr.device, layout=tr.shape,
            whole=lambda: {keystr(param_path(n)): t
                           for n, t in tr.full_params().items()})

    def _gather(self, values) -> list[list[float]]:
        """Every rank's ``values`` (as many on each) on every rank of the
        default group, by rank."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.trainer.device)
        out = torch.empty(dist.get_world_size() * t.numel(),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
        return out.view(-1, t.numel()).tolist()

    def _rollback(self, verdict) -> bool:
        """Every rank: roll the loop back to ``verdict.rollback_step`` (the
        newest verified checkpoint before the corruption) — the state and
        the cursors through :meth:`_restore`, then the exactly-once ledger
        and the recorded trajectory rewound past the step restored — and
        let :meth:`run` replay.  False when no verified anchor exists (the
        loop continues damaged: counted, never wedged)."""
        target = verdict.rollback_step or 0
        if self.checkpointer is None or target <= 0:
            log.warn("sdc rollback impossible: no verified checkpoint "
                     "precedes the corruption", step=verdict.step)
            get_counters().inc("sdc_rollbacks_skipped")
            return False
        t0 = time.monotonic()
        step = self._restore(target)
        while self._committed and self._committed[-1][0] > step:
            _, gids = self._committed.pop()
            for gid in gids:
                n = self.report.rows_trained.get(gid, 0) - 1
                if n > 0:
                    self.report.rows_trained[gid] = n
                else:
                    self.report.rows_trained.pop(gid, None)
            self.report.losses.pop()
            self.report.world_sizes.pop()
        if self.cursors is not None and self.writer:
            self.cursors.save(self.batches.state())
        self.report.rollbacks += 1
        elapsed_ms = round((time.monotonic() - t0) * 1000, 2)
        log.warn("sdc rollback complete; replaying through VW cursors",
                 from_step=verdict.step, to_step=step, elapsed_ms=elapsed_ms)
        get_tracer().instant("sdc_rollback", category="chaos",
                             from_step=verdict.step, to_step=step,
                             elapsed_ms=elapsed_ms)
        get_counters().inc("sdc_rollbacks")
        return True


# -- divergence accounting ---------------------------------------------------


def loss_divergence(control: Sequence[float],
                    resized: Sequence[float]) -> dict:
    """Compare two loss trajectories; records the divergence gauge
    (``edl_determinism_loss_divergence``)."""
    n = min(len(control), len(resized))
    diffs = [abs(control[i] - resized[i]) for i in range(n)]
    max_div = max(diffs) if diffs else float("nan")
    final_delta = (abs(control[n - 1] - resized[n - 1]) if n
                   else float("nan"))
    get_registry().gauge(
        "determinism_loss_divergence",
        help="max |loss_resized - loss_control| over the compared "
             "trajectory").set(max_div if diffs else 0.0)
    return {"steps_compared": n,
            "max_loss_divergence": max_div,
            "final_loss_delta": final_delta,
            "bitwise": bool(diffs) and max_div == 0.0}


def trajectories_equivalent(control: Sequence[float],
                            resized: Sequence[float],
                            atol: float = DEFAULT_LOSS_ATOL,
                            rtol: float = DEFAULT_LOSS_RTOL) -> bool:
    """The documented tolerance policy: pointwise
    ``|a-b| <= atol + rtol*|a|`` over trajectories of equal, non-zero
    length."""
    if len(control) != len(resized) or not control:
        return False
    return all(abs(a - b) <= atol + rtol * abs(a)
               for a, b in zip(control, resized))
