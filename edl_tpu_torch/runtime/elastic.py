"""The elastic trainer — the port of edl_tpu.runtime.elastic as an SPMD
data-parallel trainer.

The reference is a single controller over a prefix of ``jax.devices()``.
Torch runs one process a rank, so here every rank of the default process
group constructs the same :class:`ElasticTrainer`, and a world is a rank
prefix ``[0, n)`` of that group (:mod:`edl_tpu_torch.parallel.mesh`).  Ranks
past the prefix stand by: they hold a copy of the model but compute nothing
until a resize takes them in.  Without a process group the world is one
device.

A step: every rank is handed the same global batch; each live rank takes
its contiguous slice of the batch dim, runs the loss and its backward (the
flash kernels on the card), and the gradients and the loss are averaged
over the live group by one all-reduce per dtype before one optimizer update
on every live rank.  Parameters and optimizer state are replicated, and
every live rank applies the same reduced gradient, so they stay bitwise
equal across ranks.

A resize is transactional and agreed.  Every rank of the default group
calls ``resize`` with the same target at the same step boundary:

1. stage: the process group of the new prefix (built once per size), rank
   0's layout of params and optimizer state, the move priced by
   :func:`~edl_tpu_torch.parallel.replan.plan_reshard`, and fresh receive
   buffers on the ranks of the new prefix; a ready vote, since a rank that
   could not allocate cannot enter a broadcast; then params and optimizer
   state broadcast from rank 0 into those buffers.  Live state is not
   written, and ranks that stay keep their own tensors: replicated state
   does not move.
2. agree: one ``all_reduce(MIN)`` of an ok flag over the whole default
   group.
3. commit (pure assignments) only if every rank staged; otherwise every
   rank rolls back, keeps stepping on the old world, returns False and
   counts ``resizes_failed``.

Each successful resize appends the reference's ``resize_events`` record and
feeds the ``resize_phase_seconds`` histogram, the goodput ledger and the
``reshard_seconds`` calibration predictor under the reference's names.
Every collective of the trainer goes through :func:`_broadcast` or
:func:`_all_reduce`.
"""

from __future__ import annotations

import pickle
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from edl_tpu_torch.observability import calib, goodput
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.parallel.mesh import (
    Mesh,
    MeshShape,
    MeshSpec,
    distributed,
    local_device,
    make_mesh,
)
from edl_tpu_torch.parallel.replan import plan_reshard, tree_placements
from edl_tpu_torch.runtime.optim import OptimizerFactory

log = get_logger("runtime.elastic")


def _broadcast(t: torch.Tensor, src: int, group) -> None:
    """Every broadcast of the trainer (the seam tests plant faults in):
    ``t`` of rank ``src`` into ``t`` of every rank of ``group`` (None: the
    default group)."""
    dist.broadcast(t, src, group=group)


def _all_reduce(t: torch.Tensor, op, group) -> None:
    """Every all-reduce of the trainer, in place over ``group`` (None: the
    default group)."""
    dist.all_reduce(t, op=op, group=group)


def _fresh(shape: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A receive buffer of a resize (the seam tests plant an allocation
    failure in)."""
    return torch.empty(shape, dtype=dtype, device=device)


class AccumulationAborted(RuntimeError):
    """Chaos seam: an injected kill landed mid-accumulation.  Nothing was
    applied — the optimizer update is atomic, so recovery is a plain
    restore-and-replay of the whole step."""


@dataclass
class TrainState:
    params: nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0


@dataclass(frozen=True)
class _Buffer:
    """A tensor of rank 0's state that a resize sends by broadcast: its
    shape and dtype (a leaf of the reshard plan)."""

    shape: tuple
    dtype: torch.dtype


@dataclass
class _Staged:
    """The new world, staged: committed as a unit or dropped."""

    mesh: Mesh
    layout: dict
    split: dict
    #: on a rank that joins: rank 0's params and optimizer state, received
    params: Optional[list] = None
    opt: dict = field(default_factory=dict)


class ElasticTrainer:
    """SPMD elastic data-parallel trainer.

    ``loss_fn(params, batch) -> scalar tensor`` defines the model;
    ``optimizer`` is a factory from :mod:`edl_tpu_torch.runtime.optim`.
    Every rank of the default process group constructs the trainer with the
    same arguments; the first world is the whole group, or its first
    ``initial_world_size`` ranks.  ``devices`` names this rank's device
    (default: ``cuda:(rank mod device count)``; without a process group,
    the first CUDA device).  Parameters are replicated
    (``param_sharding="replicated"``, pure data parallel).

    ``accum_mode`` places :meth:`step_accumulate`'s micro-batches, as in the
    reference: ``"dp"`` packs them into rounds of the world's width,
    ``"replicated"`` runs every one on every live rank.
    """

    def __init__(
        self,
        loss_fn: Callable[[nn.Module, Any], torch.Tensor],
        params: nn.Module,
        optimizer: OptimizerFactory,
        spec: MeshSpec = MeshSpec(dp=-1),
        param_sharding: str = "replicated",
        devices: Optional[Sequence[torch.device]] = None,
        initial_world_size: Optional[int] = None,
        accum_mode: str = "dp",
    ) -> None:
        if param_sharding != "replicated":
            raise ValueError(
                f"param_sharding {param_sharding!r}: this trainer replicates "
                "every parameter; fsdp sharding is a later item of the port "
                "(ROADMAP.md, queue 1 item 1)")
        if accum_mode not in ("dp", "replicated"):
            raise ValueError(f"unknown accum_mode {accum_mode!r}")
        self.loss_fn = loss_fn
        self.spec = spec
        self.accum_mode = accum_mode
        if distributed():
            self._device = (torch.device(devices[0]) if devices
                            else local_device())
            self.rank, group_size = dist.get_rank(), dist.get_world_size()
        else:
            self._device = make_mesh(devices=devices).devices[0]
            self.rank, group_size = 0, 1
        self.resizes = 0
        self.resizes_failed = 0
        #: one record per successful resize, with the reference's fields
        self.resize_events: list[dict] = []
        self.mesh: Mesh = self._mesh_for(self._resolve_target(
            initial_world_size or group_size))
        params.to(self._device)
        self.state = TrainState(params=params,
                                opt_state=optimizer(params.parameters()))
        if self.live and self.world_size > 1:
            # replicas start from rank 0's weights, whatever each rank drew
            for p in params.parameters():
                _broadcast(p.detach(), 0, self.mesh.group)

    # -- public API --------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def world_size(self) -> int:
        return self.mesh.size

    @property
    def live(self) -> bool:
        """True when this rank is in the live world (False: standing by)."""
        return self.rank < self.world_size

    @property
    def shape(self) -> MeshShape:
        """The live mesh's concrete axis split."""
        return MeshShape.of_mesh(self.mesh)

    def _resolve_target(self, target) -> MeshShape:
        return MeshShape.resolve(target, spec=self.spec)

    def matches(self, target) -> bool:
        """True when the live mesh already has the target layout; an
        unresolvable target is simply not this layout."""
        try:
            return self._resolve_target(target) == self.shape
        except (TypeError, ValueError):
            return False

    def resize(self, target) -> bool:
        """Move to ``target`` (an int world size or a MeshShape); every
        rank calls it with the same target at the same step boundary.
        Returns True when the live mesh has that layout afterwards.  On any
        failure, on any rank, every rank keeps the current world, counts
        ``resizes_failed`` and returns False."""
        try:
            shape = self._resolve_target(target)
        except Exception as exc:  # an unresolvable target soft-fails
            self._rolled_back(target, exc)
            return False
        if shape == self.shape:
            return True
        old_world = self.world_size
        try:
            staged = self._stage(shape)
        except Exception as exc:  # a failed resize never stops training
            self._rolled_back(target, exc)
            return False
        self._commit(staged)
        self.resizes += 1
        evt = dict(staged.split, size=shape.size, step=self.state.step)
        self.resize_events.append(evt)
        get_tracer().instant("mesh_resized", category="elastic", **evt)
        get_counters().inc("prewarm_misses")  # no prewarm in this trainer
        hist = get_registry().histogram(
            "resize_phase_seconds", help="mesh-resize latency by phase")
        hist.observe(evt["replan_ms"] / 1000.0, phase="replan")
        hist.observe(evt["compile_ms"] / 1000.0, phase="compile")
        hist.observe(evt["reshard_ms"] / 1000.0, phase="reshard")
        # goodput: the group build and the replan+reshard window were paid
        # at the OLD world size; the accrual weight moves at this commit
        goodput.note_span(goodput.COMPILE, evt["compile_ms"] / 1000.0,
                          world_size=old_world)
        goodput.note_span(goodput.RESHARD,
                          (evt["replan_ms"] + evt["reshard_ms"]) / 1000.0,
                          world_size=old_world)
        goodput.set_world_size(shape.size)
        # calibration: what the plan priced the move at against its wall
        calib.record(
            "reshard_seconds",
            calib.nominal_transfer_seconds(
                evt["bytes_ici"], evt["bytes_dcn"],
                host=evt["transfer"] == "host"),
            evt["reshard_ms"] / 1000.0, unit="s",
            path=evt["transfer"], shape=evt["shape"])
        log.info("mesh resized", world_size=shape.size,
                 shape=evt["shape"], replan_ms=evt["replan_ms"],
                 compile_ms=evt["compile_ms"], reshard_ms=evt["reshard_ms"],
                 bytes_moved=evt["bytes_moved"],
                 reshard_gbps=evt["reshard_gbps"],
                 prewarm_hit=evt["prewarm_hit"], step=self.state.step)
        return True

    def step(self, batch) -> Optional[float]:
        """One training step on the live world; returns the loss over the
        whole global batch.  A rank standing by computes nothing and
        returns None."""
        if not self.live:
            return None
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.state.params, self._local(batch))
        loss.backward()
        loss = loss.detach()
        self._mean_over_world([*self._grads(), loss])
        opt.step()
        self.state.step += 1
        return float(loss)

    def eval_loss(self, batch) -> Optional[float]:
        """The training objective over the global batch, touching no state
        (None on a rank standing by)."""
        if not self.live:
            return None
        with torch.no_grad():
            loss = self.loss_fn(self.state.params, self._local(batch))
            self._mean_over_world([loss])
        return float(loss)

    def step_accumulate(self, micro_batches: Sequence,
                        abort_after: Optional[int] = None
                        ) -> Optional[float]:
        """One constant-effective-batch step: the gradients of the V
        micro-batches are summed, scaled by 1 / V and applied as a single
        optimizer update.  Returns the mean of the micro losses (None on a
        rank standing by).

        ``accum_mode="dp"`` packs the micro-batches into ⌈V/N⌉ rounds of the
        world's width N, rank r taking micro-batch ``k·N + r`` of round k,
        and sums the gradients over the live group once; it needs N to
        divide V (else, as in the reference, the micro-batches run as in
        ``"replicated"``), and equals one device's result within float
        bounds.  ``"replicated"`` runs every micro-batch on every live rank
        with no reduction, so the update is bitwise the same at any world
        size.

        ``abort_after=k`` raises :class:`AccumulationAborted` after k
        micro-batches, before the update: state is untouched."""
        V = len(micro_batches)
        if V == 0:
            raise ValueError("step_accumulate needs at least 1 micro-batch")
        if not self.live:
            return None
        n = self.world_size
        use_dp = self.accum_mode == "dp" and n > 1 and V % n == 0
        mine = micro_batches[self.rank::n] if use_dp else micro_batches
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        lsum, done = 0.0, 0
        for mb in mine:
            loss = self.loss_fn(self.state.params, self._to_device(mb))
            loss.backward()  # .grad accumulates the sum
            lsum += float(loss.detach())
            done += n if use_dp else 1
            if abort_after is not None and done >= abort_after:
                raise AccumulationAborted(
                    f"injected kill after {done}/{V} micro-batches "
                    f"at step {self.state.step}")
        grads = self._grads()
        total = torch.tensor(lsum, dtype=torch.float64, device=self.device)
        if use_dp:
            self._sum_over_world([*grads, total])
        with torch.no_grad():
            for g in grads:
                g.mul_(1.0 / V)
        opt.step()
        self.state.step += 1
        return float(total) / V

    # -- the step's collectives --------------------------------------------

    def _local(self, batch):
        """This rank's contiguous slice of the global batch's leading dim,
        on the device."""
        n, r = self.world_size, self.rank
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._local(x) for x in batch)
        x = torch.as_tensor(batch)
        if n > 1:
            if x.shape[0] % n:
                raise ValueError(f"a batch of {x.shape[0]} does not split "
                                 f"over {n} ranks")
            k = x.shape[0] // n
            x = x[r * k:(r + 1) * k]
        return x.to(self.device, non_blocking=True)

    def _to_device(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(x) for x in batch)
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad for p in self.state.params.parameters()
                if p.grad is not None]

    def _sum_over_world(self, tensors: list[torch.Tensor]) -> None:
        """Each tensor ← its sum over the live group, in place: one
        all-reduce of a flat buffer per dtype (nothing on a world of one)."""
        if self.world_size == 1:
            return
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                _all_reduce(flat, dist.ReduceOp.SUM, self.mesh.group)
                for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(part.view_as(t))

    def _mean_over_world(self, tensors: list[torch.Tensor]) -> None:
        if self.world_size == 1:
            return
        self._sum_over_world(tensors)
        with torch.no_grad():
            for t in tensors:
                t.mul_(1.0 / self.world_size)

    # -- resize internals --------------------------------------------------

    def _rolled_back(self, target, exc: Exception) -> None:
        self.resizes_failed += 1
        log.warn("mesh resize failed; rolled back",
                 want=repr(target)[:60], keep_size=self.world_size,
                 step=self.state.step, error=str(exc)[:200])
        get_tracer().instant("resize_rolled_back", category="chaos",
                             want=repr(target)[:60],
                             keep_size=self.world_size,
                             error=str(exc)[:120])
        get_counters().inc("resizes_failed")

    def _mesh_for(self, shape: MeshShape) -> Mesh:
        """The mesh of a pure-dp ``shape`` over the rank prefix of its
        size (building its process group on first use: collective)."""
        if shape.size != shape.dp:
            raise ValueError(
                f"{shape.describe()}: this trainer is pure data parallel; "
                "fsdp, tp, sp and ep axes are later items of the port")
        if shape.size > 1 and not distributed():
            raise ValueError(f"a world of {shape.size} needs a process group "
                             f"of {shape.size} ranks; none is initialised")
        return make_mesh(shape.size, shape.to_spec(), devices=[self.device])

    def _agree(self, ok: bool) -> bool:
        """True when every rank of the default group says ``ok``."""
        if not distributed():
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=self.device)
        _all_reduce(flag, dist.ReduceOp.MIN, None)
        return bool(flag.item())

    def _layout(self) -> dict:
        """What a joining rank needs to know of rank 0's state before the
        bytes move: each parameter's shape and dtype, the optimizer state
        (a :class:`_Buffer` for each tensor on the device, sent by
        broadcast; anything else, such as Adam's host step counts, by
        value), the optimizer's hyperparameters and the step."""
        params = list(self.state.params.parameters())
        opt = self.state.opt_state

        def entry(v):
            if isinstance(v, torch.Tensor) and v.device == self.device:
                return _Buffer(tuple(v.shape), v.dtype)
            return v

        return dict(
            step=self.state.step,
            params=[(name, _Buffer(tuple(p.shape), p.dtype)) for name, p in
                    self.state.params.named_parameters()],
            opt={i: {k: entry(v) for k, v in opt.state[p].items()}
                 for i, p in enumerate(params) if p in opt.state},
            groups=[{k: v for k, v in g.items() if k != "params"}
                    for g in opt.param_groups])

    def _broadcast_layout(self) -> dict:
        """Rank 0's :meth:`_layout` on every rank of the default group."""
        if not distributed():
            return self._layout()
        if self.rank == 0:
            layout = self._layout()
            data = torch.frombuffer(bytearray(pickle.dumps(layout)),
                                    dtype=torch.uint8).to(self.device)
            size = torch.tensor([data.numel()], device=self.device)
        else:
            size = torch.zeros(1, dtype=torch.int64, device=self.device)
        _broadcast(size, 0, None)
        if self.rank != 0:
            data = torch.empty(int(size), dtype=torch.uint8,
                               device=self.device)
        _broadcast(data, 0, None)
        if self.rank == 0:
            return layout
        # bytes rank 0 of this job pickled a moment ago
        return pickle.loads(data.cpu().numpy().tobytes())

    def _stage(self, shape: MeshShape) -> _Staged:
        """Everything the new world needs, without writing live state.
        Raises — on every rank alike — unless every rank of the default
        group staged it (the ready and commit votes)."""
        old_n, new_n = self.world_size, shape.size
        error: Optional[Exception] = None
        t0 = time.perf_counter()
        try:
            mesh = self._mesh_for(shape)
        except Exception as exc:  # voted on below, with every rank
            error = exc
        t1 = t2 = t3 = time.perf_counter()
        staged, sending = None, []
        if error is None:
            try:
                layout = self._broadcast_layout()
                t2 = time.perf_counter()
                tree = {f"params.{name}": b for name, b in layout["params"]}
                tree.update((f"opt.{i}.{k}", v)
                            for i, entries in layout["opt"].items()
                            for k, v in entries.items())
                plan = plan_reshard(
                    tree, tree_placements(tree, self.shape),
                    tree_placements(tree, shape),
                    old_shape=self.shape, new_shape=shape)
                t3 = time.perf_counter()
                staged = _Staged(mesh=mesh, layout=layout, split=dict(
                    compile_ms=round((t1 - t0) * 1000, 2),
                    replan_ms=round((t3 - t2) * 1000, 3),
                    prewarm_hit=False, shape=shape.describe(),
                    bytes_moved=plan.bytes_moved, bytes_ici=plan.bytes_ici,
                    bytes_dcn=plan.bytes_dcn, bytes_naive=plan.bytes_naive,
                    transfer="device"))
                sending = self._receive_buffers(staged, old_n, new_n)
            except Exception as exc:
                error = exc
        if not self._agree(error is None):
            raise error or RuntimeError("another rank could not stage the "
                                        "resize")
        if sending:
            error = self._transfer(sending, mesh.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t4 = time.perf_counter()
        if not self._agree(error is None):
            raise error or RuntimeError("another rank failed to receive the "
                                        "resize's state")
        # the state's move: rank 0's layout, the buffers, the ready vote and
        # the bytes (the plan's own time is replan_ms)
        reshard_s = (t2 - t1) + (t4 - t3)
        staged.split.update(
            reshard_ms=round(reshard_s * 1000, 2),
            reshard_gbps=(round(staged.split["bytes_moved"] / reshard_s
                                / 1e9, 3) if reshard_s > 0 else 0.0))
        return staged

    def _receive_buffers(self, staged: _Staged, old_n: int,
                         new_n: int) -> list[torch.Tensor]:
        """The tensors this rank takes to the state broadcast, in order:
        on rank 0 its live params and optimizer buffers, on every other
        rank of a growing prefix fresh buffers (kept by a rank that joins,
        dropped by one that stays); none when nothing joins."""
        if new_n <= old_n or self.rank >= new_n:
            return []
        layout = staged.layout
        if self.rank == 0:
            params = list(self.state.params.parameters())
            opt = self.state.opt_state.state
            return ([p.detach() for p in params]
                    + [opt[params[i]][k] for i, entries in layout["opt"]
                       .items() for k, v in entries.items()
                       if isinstance(v, _Buffer)])

        def fresh(b: _Buffer) -> torch.Tensor:
            return _fresh(b.shape, b.dtype, self.device)

        params = [fresh(b) for _, b in layout["params"]]
        opt = {i: {k: fresh(v) if isinstance(v, _Buffer) else v
                   for k, v in entries.items()}
               for i, entries in layout["opt"].items()}
        if self.rank >= old_n:  # joining: these become this rank's state
            staged.params, staged.opt = params, opt
        return params + [v for i, entries in layout["opt"].items()
                         for k, v in opt[i].items()
                         if isinstance(entries[k], _Buffer)]

    def _transfer(self, tensors: list[torch.Tensor],
                  group) -> Optional[Exception]:
        """Broadcast each tensor from rank 0 over ``group``, in order.  A
        rank whose broadcast raises still takes part in the rest, so that
        no peer waits on it, and returns its first error for the commit
        vote."""
        error = None
        for t in tensors:
            try:
                _broadcast(t, 0, group)
            except Exception as exc:
                error = error or exc
        return error

    def _commit(self, staged: _Staged) -> None:
        """The commit point: pure assignments.  A rank that joins takes
        rank 0's params, optimizer state, hyperparameters and step."""
        self.mesh = staged.mesh
        if staged.params is None:
            return
        params = list(self.state.params.parameters())
        for p, new in zip(params, staged.params):
            p.data = new
        opt = self.state.opt_state
        state = defaultdict(dict)
        for i, entries in staged.opt.items():
            state[params[i]] = entries
        opt.state = state
        for group, hyper in zip(opt.param_groups, staged.layout["groups"]):
            group.update(hyper)
        self.state.step = staged.layout["step"]
