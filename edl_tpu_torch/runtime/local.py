"""Local end-to-end elastic job harness — the port of edl_tpu.runtime.local.

The "minimum end-to-end slice" of SURVEY §7: submit a TrainingJob to the
:class:`~edl_tpu_torch.controller.controller.Controller` → its updater
materializes trainer pods on the (fake) cluster → its
:class:`~edl_tpu_torch.scheduler.autoscaler.Autoscaler` dials parallelism
against live capacity → and HERE the dial becomes a mesh: each running
trainer pod corresponds to one mesh slot, so a parallelism change is
observed by the training loop and applied as an ``ElasticTrainer.resize()``
at the next step boundary, while the task-lease queue keeps data flowing
exactly-once through every resize.  The coordinator may be the in-process
service or a :class:`~edl_tpu_torch.coord.client.CoordClient` (behind a
chaos proxy, riding its reconnects).  A kill that leaves no trainer
running makes rank 0 wait for the replacement pod (:data:`REPLACEMENT_WAIT_S`)
instead of stepping at world 0; past that it raises on every rank.

The reference is a single controller; the port's trainer is SPMD, so the
job is too.  Every rank of the default process group builds a
:class:`LocalElasticJob` around its own trainer; rank 0 alone holds the
job, the cluster and the coordinator (the others pass ``None``), as the
virtual-worker loop has one writer.  At each step boundary rank 0 reads
the pods, leases the global batch, and broadcasts one frame — the resize
target, whether to apply it now, the end of the stream, and the batch —
through the trainer's counting choke point (census label
:data:`DATA_LABEL`); then every rank resizes and steps alike.  A
coordinator or cluster call that raises on rank 0 is sent as an error
frame, so every rank raises with it instead of waiting in a collective.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.base import Cluster
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.parallel.mesh import MeshShape
from edl_tpu_torch.runtime import elastic
from edl_tpu_torch.runtime.data import TaskLeaseBatches
from edl_tpu_torch.runtime.elastic import ElasticTrainer

log = get_logger("runtime.local")

#: the census label of rank 0's step frames
DATA_LABEL = "data"
#: a frame's JSON header occupies its first HEADER_BYTES bytes
HEADER_BYTES = 4096
#: how long rank 0 waits for a replacement pod when no trainer is running
#: (a kill at world 1) before the job raises
REPLACEMENT_WAIT_S = 60.0


class RankZeroFailed(RuntimeError):
    """Rank 0's coordinator or cluster call raised; every rank raises it."""


@dataclass
class RunReport:
    steps: int = 0
    #: each step's loss (None on a rank standing by that step)
    losses: list = field(default_factory=list)
    world_sizes: list[int] = field(default_factory=list)
    resizes: int = 0
    #: wall-clock cost of each reshard: the resize() call plus the first
    #: step on the new mesh
    resize_seconds: list[float] = field(default_factory=list)
    #: completed-step index at which each resize was applied — the exact
    #: loss-trace boundary
    resize_steps: list[int] = field(default_factory=list)
    #: per-resize split from ElasticTrainer.resize_events: how much of
    #: each resize was the layout's group build vs the state reshard, and
    #: how many resizes landed on a prewarmed layout
    resize_compile_ms: list[float] = field(default_factory=list)
    resize_reshard_ms: list[float] = field(default_factory=list)
    #: per-resize transfer plan: how long it took to compute and how many
    #: bytes it said must move (a prediction; resize_gbps is measured)
    resize_replan_ms: list[float] = field(default_factory=list)
    resize_bytes_moved: list[int] = field(default_factory=list)
    resize_gbps: list[float] = field(default_factory=list)
    prewarm_hits: int = 0
    #: steps spent training on the OLD world while the new world's layout
    #: was still building (deferred resize)
    resize_deferred_steps: int = 0
    #: the VirtualRunReport when the run was driven by VirtualBatches
    #: (exactly-once row ledger, vw moves); None on the lease path
    virtual: Optional[object] = None
    #: host ms of each step's data hand-off on the lease path: rank 0's
    #: lease and pod reading plus the frame's broadcast (every rank)
    data_ms: list[float] = field(default_factory=list)

    @property
    def first_loss(self) -> float:
        return self.losses[0] if self.losses else float("nan")

    @property
    def last_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")

    def note_event(self, evt: dict) -> None:
        """Take one of the trainer's resize events into the report."""
        self.resize_compile_ms.append(evt["compile_ms"])
        self.resize_reshard_ms.append(evt["reshard_ms"])
        self.resize_replan_ms.append(evt["replan_ms"])
        self.resize_bytes_moved.append(evt["bytes_moved"])
        self.resize_gbps.append(evt.get("reshard_gbps", 0.0))
        self.prewarm_hits += int(evt["prewarm_hit"])


def _encode_target(target) -> dict:
    if isinstance(target, MeshShape):
        return {"shape": target.axis_sizes()}
    return {"n": int(target)}


def _decode_target(spec: dict):
    if "shape" in spec:
        return MeshShape(**spec["shape"])
    return spec["n"]


class LocalElasticJob:
    """Drives one job's training loop against the control plane, on every
    rank of the default process group (rank 0 holding ``job``,
    ``cluster`` and ``coord``; the others pass None for each)."""

    def __init__(
        self,
        job: Optional[TrainingJob],
        cluster: Optional[Cluster],
        trainer: ElasticTrainer,
        coord,
        fetch: Optional[Callable],
        batch_size: int,
        max_devices: Optional[int] = None,
        prewarm_neighbors: bool = True,
        resize_defer_s: float = 30.0,
        shape_for: Optional[Callable[[int], object]] = None,
        virtual=None,
        shard_ids: Optional[list] = None,
        fetch_shard: Optional[Callable] = None,
        passes: int = 1,
        use_virtual_batches: bool = True,
        job_name: Optional[str] = None,
    ) -> None:
        self.trainer = trainer
        self.rank = trainer.rank
        if self.rank == 0 and (job is None or cluster is None
                               or coord is None):
            raise ValueError("rank 0 holds the job, the cluster and the "
                             "coordinator")
        self.job = job
        self.cluster = cluster
        self.coord = coord
        self.fetch = fetch
        self.batch_size = batch_size
        #: default: every rank of the process group is a slot
        self.max_devices = max_devices or trainer._group_size
        #: the job's name on every rank (rank 0's job.full_name); the
        #: virtual loop keys its cursors and ownership map by it
        self.job_name = job_name or (job.full_name if job is not None
                                     else "job")
        #: with a VirtualConfig (plus the shard stream) the run is driven
        #: by VirtualBatches — the deterministic virtual-worker schedule
        #: with exactly-once cursors — instead of first-come task leases;
        #: ``use_virtual_batches=False`` keeps the lease path
        self.virtual = virtual
        self.shard_ids = shard_ids
        self.fetch_shard = fetch_shard
        self.passes = int(passes)
        self.use_virtual_batches = use_virtual_batches
        #: reparallelization policy: an observed pod count → the layout to
        #: train on at that world size (an int, or a MeshShape); None: the
        #: count itself.  Every rank holds the same policy (prewarm maps
        #: the neighbours through it on every rank)
        self.shape_for = shape_for
        #: after every commit (and after the first step), prewarm the
        #: adjacent valid world sizes
        self.prewarm_neighbors = prewarm_neighbors
        #: while rank 0's build of the target layout is in flight, keep
        #: training on the current world for up to this many seconds (0:
        #: resizes wait for their build inline)
        self.resize_defer_s = resize_defer_s
        self._frame: Optional[torch.Tensor] = None

    def _snap(self, n: int) -> int:
        """Clamp to available devices and snap down to a divisor of the
        global batch."""
        n = min(max(n, 1), self.max_devices)
        while n > 1 and self.batch_size % n != 0:
            n -= 1
        return n

    def desired_world_size(self) -> int:
        """Running trainer pods (rank 0's cluster), clamped and snapped as
        :meth:`_snap` says.  While none is running (a kill at world 1, its
        replacement not placed yet) wait for one, polling: the job never
        steps at world 0, and raises rather than hang once
        :data:`REPLACEMENT_WAIT_S` has passed."""
        running = self.cluster.job_pods(self.job).running
        if running == 0:
            log.warn("no trainer running; waiting for a replacement pod",
                     job=self.job_name)
            deadline = time.monotonic() + REPLACEMENT_WAIT_S
            while running == 0:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"no trainer pod of {self.job_name} running after "
                        f"{REPLACEMENT_WAIT_S} s")
                time.sleep(0.05)
                running = self.cluster.job_pods(self.job).running
        return self._snap(running)

    def _target_for(self, n: int):
        """Pod count → resize target: the shape policy's layout when one is
        configured, else the count itself.  A raising policy degrades to
        the bare count: a layout hint must never kill the job."""
        n = self._snap(n)
        if self.shape_for is None:
            return n
        try:
            return self.shape_for(n)
        except Exception as exc:
            log.warn("shape policy failed; using bare count",
                     job=self.job_name, count=n, error=str(exc)[:200])
            return n

    def _neighbor_sizes(self, current: int) -> list:
        """The adjacent valid world sizes, through the shape policy — the
        prewarm candidates."""
        out = []
        for n in range(current + 1, self.max_devices + 1):
            if self.batch_size % n == 0:
                out.append(n)
                break
        for n in range(current - 1, 0, -1):
            if n == 1 or self.batch_size % n == 0:
                out.append(n)
                break
        if self.shape_for is not None:
            out = [self.shape_for(n) for n in out]
        return out

    def prewarm_for_parallelism(self, target) -> None:
        """Autoscaler plan hint → speculative layout build.  Every rank
        calls it with the same hint at the same step boundary, as it calls
        ``prewarm``: count hints go through the clamp, snap and shape rules
        the loop applies when the pods land; shape hints are taken
        as-is."""
        if isinstance(target, MeshShape):
            self.trainer.prewarm([target])
        else:
            self.trainer.prewarm([self._target_for(int(target))])

    # -- rank 0's frames ---------------------------------------------------

    def _distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    def _send(self, header: dict, arrays=()) -> None:
        """Rank 0: broadcast ``header`` and ``arrays`` as one frame (after
        a frame that grows every rank's buffer, when it must)."""
        if not self._distributed():
            return
        meta = [[a.dtype.str, list(a.shape)] for a in arrays]
        payload = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
        head = json.dumps({**header, "arrays": meta}).encode()
        if len(head) > HEADER_BYTES:
            raise ValueError(f"frame header of {len(head)} bytes")
        size = HEADER_BYTES + len(payload)
        old = HEADER_BYTES if self._frame is None else self._frame.numel()
        if size > old:
            self._bcast(self._host_frame(old, {"grow": size}))
        self._frame = self._host_frame(max(size, old), head, payload)
        self._bcast(self._frame)

    def _host_frame(self, size: int, head, payload: bytes = b""
                    ) -> torch.Tensor:
        """A frame of ``size`` bytes on the trainer's device: the header
        (a dict, or its JSON bytes) zero-padded, then ``payload``."""
        if isinstance(head, dict):
            head = json.dumps(head).encode()
        buf = bytearray(size)
        buf[:len(head)] = head
        buf[HEADER_BYTES:HEADER_BYTES + len(payload)] = payload
        return torch.frombuffer(buf, dtype=torch.uint8).to(
            self.trainer.device)

    def _receive(self) -> tuple[dict, tuple]:
        """Every rank but 0: rank 0's next frame, as (header, arrays)."""
        while True:
            if self._frame is None:
                self._frame = torch.empty(HEADER_BYTES, dtype=torch.uint8,
                                          device=self.trainer.device)
            self._bcast(self._frame)
            raw = self._frame.cpu().numpy()
            header = json.loads(bytes(raw[:HEADER_BYTES]).rstrip(b"\0"))
            if "grow" in header:
                self._frame = torch.empty(header["grow"], dtype=torch.uint8,
                                          device=self.trainer.device)
                continue
            arrays, pos = [], HEADER_BYTES
            for dtype, shape in header.pop("arrays"):
                dt = np.dtype(dtype)
                n = int(np.prod(shape)) * dt.itemsize
                arrays.append(np.frombuffer(raw[pos:pos + n].tobytes(),
                                            dtype=dt).reshape(shape))
                pos += n
            if header.get("error") is not None:
                raise RankZeroFailed(f"rank 0 failed: {header['error']}")
            return header, tuple(arrays)

    def _bcast(self, t: torch.Tensor) -> None:
        elastic._broadcast(t, 0, None, DATA_LABEL)

    def _share(self, produce: Callable[[], tuple[dict, tuple]]
               ) -> tuple[dict, tuple]:
        """Rank 0 runs ``produce()`` → (header, arrays) and broadcasts it;
        every other rank receives it.  When ``produce`` raises on rank 0,
        every rank raises."""
        if self.rank != 0:
            return self._receive()
        try:
            header, arrays = produce()
        except Exception as exc:
            self._send({"error": f"{type(exc).__name__}: {exc}"[:2000]})
            raise
        self._send(header, arrays)
        return header, arrays

    # -- the loop ----------------------------------------------------------

    def run(
        self,
        max_steps: Optional[int] = None,
        on_step: Optional[Callable[[int, float, int], None]] = None,
        until: Optional[Callable[[], bool]] = None,
    ) -> RunReport:
        """Train until the task queue is drained (all passes),
        ``max_steps``, or ``until()`` (rank 0's call, before it leases the
        next batch) says so, on every rank.  Membership changes are
        applied at step boundaries, so there is never a half-resized step.  With a
        :class:`~edl_tpu_torch.runtime.virtual.VirtualConfig` configured
        (and not opted out), the drive is the virtual-worker stream
        instead: see :meth:`_run_virtual`.  ``on_step(step, loss, world)``
        runs on every rank after each step (loss None on a rank standing
        by)."""
        if (self.use_virtual_batches and self.virtual is not None
                and self.shard_ids is not None
                and self.fetch_shard is not None):
            return self._run_virtual(max_steps, on_step)
        report = RunReport()
        leases = (TaskLeaseBatches(
            self.coord, worker=f"{self.job_name}/trainer", fetch=self.fetch,
            batch_size=self.batch_size) if self.rank == 0 else None)
        stream = iter(leases) if leases is not None else None
        defer = {"deadline": None, "target": None}

        def next_step() -> tuple[dict, tuple]:
            if max_steps is not None and report.steps >= max_steps:
                return {"end": True}, ()
            if until is not None and until():
                leases.finish()  # the last trained task is done
                return {"end": True}, ()
            batch = next(stream, None)
            if batch is None:
                return {"end": True}, ()
            want = self._target_for(self.desired_world_size())
            return {"target": _encode_target(want),
                    "apply": self._decide(want, defer, report)}, batch

        while True:
            t0 = time.perf_counter()
            header, batch = self._share(next_step)
            if header.get("end"):
                break
            report.data_ms.append((time.perf_counter() - t0) * 1000)
            want = _decode_target(header["target"])
            if self.rank != 0 and header["apply"] is None:
                report.resize_deferred_steps += 1
            resized_at = None
            if header["apply"]:
                before = self.trainer.shape.describe()
                resized_at = time.perf_counter()
                n_events = len(self.trainer.resize_events)
                ok = self.trainer.resize(want)
                report.resizes += 1
                report.resize_steps.append(report.steps)
                if ok and len(self.trainer.resize_events) > n_events:
                    report.note_event(self.trainer.resize_events[-1])
                if ok and self.prewarm_neighbors:
                    # next hop along the grow/shrink trace, built now
                    self.trainer.prewarm(
                        self._neighbor_sizes(self.trainer.world_size))
                log.info("elastic resize applied", job=self.job_name,
                         from_shape=before,
                         to_shape=self.trainer.shape.describe(),
                         step=self.trainer.state.step)
            loss = self.trainer.step(batch)
            if resized_at is not None:
                report.resize_seconds.append(
                    time.perf_counter() - resized_at)
            report.steps += 1
            if report.steps == 1 and self.prewarm_neighbors:
                self.trainer.prewarm(
                    self._neighbor_sizes(self.trainer.world_size))
            report.losses.append(loss)
            report.world_sizes.append(self.trainer.world_size)
            if on_step is not None:
                on_step(report.steps, loss, self.trainer.world_size)
        return report

    def _decide(self, want, defer: dict, report: RunReport):
        """Rank 0: resize to ``want`` at this boundary (True), not at all
        (False: the layout is the live one), or not yet (None: its build
        is in flight and the deferral budget lasts).  The budget is per
        target: a revised target starts a fresh window."""
        if self.trainer.matches(want):
            defer["deadline"] = defer["target"] = None
            return False
        if self.resize_defer_s > 0 and self.trainer.is_building(want):
            now = time.perf_counter()
            if defer["deadline"] is None or want != defer["target"]:
                defer.update(target=want,
                             deadline=now + self.resize_defer_s)
            if now < defer["deadline"]:
                report.resize_deferred_steps += 1
                return None
        defer["deadline"] = defer["target"] = None
        return True

    def _run_virtual(
        self,
        max_steps: Optional[int],
        on_step: Optional[Callable[[int, float, int], None]],
    ) -> RunReport:
        """The VirtualBatches drive: the step semantics are the port's
        :class:`~edl_tpu_torch.runtime.virtual.VirtualWorkerLoop`, run by
        every rank on its own copy of the shard stream, while this class
        supplies the production inputs: the desired world from rank 0's
        reading of the live pods (broadcast to every rank), and rank 0's
        cursors and ownership map published to the job's coordinator (the
        loop's KV store).  The loss trajectory is therefore
        resize-invariant."""
        from edl_tpu_torch.runtime.virtual import (VirtualBatches,
                                                   VirtualWorkerLoop)

        batches = VirtualBatches(self.virtual, self.shard_ids,
                                 self.fetch_shard, passes=self.passes)
        kv = self.coord if hasattr(self.coord, "kv_set") else None
        loop = VirtualWorkerLoop(self.trainer, self.virtual, batches,
                                 kv=kv, job=self.job_name)

        def world_for(step: int) -> int:
            header, _ = self._share(lambda: ({"n": self.virtual.snap_world(
                self.desired_world_size())}, ()))
            return header["n"]

        vr = loop.run(max_steps=max_steps, world_size_for=world_for,
                      on_step=on_step)
        report = RunReport(
            steps=len(vr.losses), losses=list(vr.losses),
            world_sizes=list(vr.world_sizes), resizes=vr.resizes)
        for evt in self.trainer.resize_events:
            if evt.get("step") is not None:
                report.note_event(evt)
        #: the exactly-once evidence rides along for callers that know
        #: they ran virtually (rows_duplicated()/rows_missing())
        report.virtual = vr
        return report
