"""The elastic trainer — the port of edl_tpu.runtime.elastic as an SPMD
trainer, data parallel, fully sharded, or laid out by the model's partition
specs with Megatron tensor parallelism, and sequence parallel over sp.

The reference is a single controller over a prefix of ``jax.devices()``.
Torch runs one process a rank, so here every rank of the default process
group constructs the same :class:`ElasticTrainer`, and a world is a rank
prefix ``[0, n)`` of that group, laid out as a dp×fsdp×tp×sp mesh
(:mod:`edl_tpu_torch.parallel.mesh`).  Ranks past the prefix stand by:
they compute nothing until a resize takes them in.  Without a process group
the world is one device.

Parameters are replicated (``param_sharding="replicated"``, pure data
parallelism) or sharded over the mesh's fsdp axis (``"fsdp"``, ZeRO-3
style): a live rank then holds, of every leaf the reference's rule shards
(:func:`~edl_tpu_torch.parallel.mesh.fsdp_sharding`: the largest dimension
the fsdp size divides), only its 1/k block, and Adam's moments likewise;
a leaf with no such dimension stays replicated.  On a mesh with tp > 1
both kinds replicate every leaf over tp, as the reference's trainer does.
``param_sharding`` may instead be the model's partition specs by parameter
name (``param_partition_specs(cfg)``: a dimension over ``"fsdp"``, over
``"tp"``, or None), the layout the reference's dryrun jits its step with;
each rank then holds its N-D block of every leaf.  The optimizer steps on
these blocks (:attr:`ElasticTrainer.shards`), since Adam is elementwise;
the module's parameters hold nothing between steps.

A step: every rank is handed the same global batch; each live rank takes
its contiguous slice of the batch dim (the batch splits over the data axes
dp×fsdp, by the rank's data coordinate; the ranks of one tp group take the
same slice, and so do those of one sp line), gathers its parameters over
its fsdp group (one all-gather per dtype; the gathered tensors, whole or
this rank's tp block, live for the step only), runs the loss and its
backward (the flash kernels on the card) — in a tp context
(:mod:`edl_tpu_torch.parallel.tensor_parallel`) when a leaf is split over
tp, so that the model writes out the Megatron all-reduces, and in an sp
context (:mod:`edl_tpu_torch.parallel.ring_attention`) on a mesh with sp >
1, so that a model with an sp path (the transformer) takes this rank's
chunk of the sequence and rings its attention over the sp line, each hop
through :func:`_ring_hop`; a model with none computes the whole batch on
every sp rank — and reduces the gradients over the data axes dp+fsdp+sp: a
leaf split over fsdp by a reduce-scatter over the fsdp group and an
all-reduce over the dp+sp group, any other leaf's and the loss by one
all-reduce over the data group, each as a flat buffer per dtype; then
1/(dp·fsdp·sp) and one optimizer update.  The ranks of a tp group hold the
same gradient of a leaf not split over tp, so nothing is summed over tp.
Replicated state stays bitwise equal across ranks.

A resize is transactional and agreed.  Every rank of the default group
calls ``resize`` with the same target at the same step boundary:

1. stage: the mesh of the new layout with its process groups (built once
   per (size, shape) and kept in ``_step_cache``), rank 0's layout of the
   state, the move priced by :func:`~edl_tpu_torch.parallel.replan.
   plan_reshard` over the kind's placements, and fresh buffers for every
   block a rank will hold and does not hold now; a ready vote, since a
   rank that could not allocate cannot enter a broadcast; then the blocks
   move.  Each block a rank lacks comes from the lowest rank of the old
   world that holds it, by one broadcast per (source rank, dtype) over the
   prefix spanning both worlds, so a shrink sends the leaving ranks'
   blocks before they stand by; a block a rank holds is copied locally.
   Live state is not written; a rank whose block does not change keeps its
   tensor.
2. agree: one ``all_reduce(MIN)`` of an ok flag over the whole default
   group.
3. commit (pure assignments) only if every rank staged; otherwise every
   rank rolls back, keeps stepping on the old layout, returns False and
   counts ``resizes_failed``.

The whole state leaves a sharded trainer for a checkpoint through
:meth:`ElasticTrainer.whole_state` (every leaf gathered over fsdp, then tp,
one leaf at a time, to rank 0's host memory, under the paths a replicated
trainer's state is saved under) and comes back into any layout through
:meth:`ElasticTrainer.load_whole_state` (each rank takes its own block of
every leaf).

Each successful resize appends the reference's ``resize_events`` record and
feeds the ``resize_phase_seconds`` histogram, the goodput ledger and the
``reshard_seconds`` calibration predictor under the reference's names.
Every collective of the trainer goes through one of five choke points,
:func:`_broadcast`, :func:`_all_reduce`, :func:`_all_gather`,
:func:`_reduce_scatter` and the ring's :func:`_ring_hop`, each counting its
op and bytes by mesh axis (:func:`collective_census`; ``"world"`` for the
default group's votes, ``"tp"`` for the model's tp collectives, ``"sp"``
for the ring's hops, ``"checkpoint"`` for the gathers of
:meth:`ElasticTrainer.whole_state`, ``"prewarm"`` for the warm-ups below).

**Prewarm.**  What a resize builds before it moves a byte — the layout's
mesh with its process groups, and the group spanning both worlds — is the
port's stand-in for the reference's ahead-of-time compile, timed as
``compile_ms``.  :meth:`ElasticTrainer.prewarm` queues those builds for the
planner's likely next layouts on the process's group-build thread
(:func:`~edl_tpu_torch.parallel.mesh.submit_build`), which the resize's own
builds also go through, so every rank calls ``new_group`` in one order;
a resize of a layout still building waits for that build instead of
starting another.  The first collective on each new group (which is when
NCCL creates its communicator) runs on the caller's thread, never beside
the step's collectives: :meth:`ElasticTrainer.prewarm_quiesce` at a step
boundary, or the resize that takes the layout.  Unused prewarmed layouts
past ``prewarm_cache_limit`` are dropped oldest first (their process
groups stay in :mod:`~edl_tpu_torch.parallel.mesh`'s caches, so a later
hint builds nothing); a layout a resize used is exempt.  A resize records
``prewarm_hit`` and counts ``prewarm_hits``/``prewarm_misses``.

**Chaos seams.**  :meth:`ElasticTrainer.inject_update_corruption`,
:meth:`~ElasticTrainer.inject_loss_poison` and
:meth:`~ElasticTrainer.flip_param_bits` are how the SDC drills
(:mod:`edl_tpu_torch.runtime.faults`) strike.  A flipped bit lands on the
element the reference's single tree would hold it in, wherever that
element lives: every live replica flips it on a replicated world, and only
the rank whose block holds it on a sharded one, so the whole parameters
afterwards are a replicated trainer's after the same seam.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from edl_tpu_torch.interop import keystr
from edl_tpu_torch.observability import calib, goodput
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.parallel import ring_attention, tensor_parallel
from edl_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_DP,
    AXIS_FSDP,
    AXIS_SP,
    AXIS_TP,
    DATA_AXES,
    Mesh,
    MeshShape,
    MeshSpec,
    axis_ranks,
    data_coordinate,
    distributed,
    local_device,
    make_mesh,
    rank_group,
    submit_build,
    tree_shardings,
)
from edl_tpu_torch.parallel.replan import Placement, plan_reshard
from edl_tpu_torch.runtime import sdc
from edl_tpu_torch.runtime.checkpoint import Snapshot, param_path
from edl_tpu_torch.runtime.optim import OptimizerFactory

log = get_logger("runtime.elastic")

#: the census label of whole_state's gathers
CHECKPOINT_LABEL = "checkpoint"
#: the census label of the collectives that warm a prewarmed layout's groups
PREWARM_LABEL = "prewarm"
#: the census label of the SDC fingerprint's gather of block folds
SDC_LABEL = "sdc"
#: how long a resize waits for a speculative build of its layout before it
#: gives up (a wedged build fails the resize, which rolls back)
BUILD_WAIT_TIMEOUT_S = 300.0

#: collective_census's counts: {axis label: {"ops": {op: n}, "bytes": n}}
_census: dict[str, dict] = {}


def rank_processes(*preload: str):
    """The multiprocessing context rank processes start from: a fork
    server that imports the caller's main module, this one and the modules
    named in ``preload`` once, and never touches CUDA, so each rank is
    forked from it instead of importing torch and the port anew (what
    bounds a wide dryrun's start on the card's host); the server forks
    from its one thread, so fork's hazards in a threaded process do not
    arise, and each rank brings up CUDA itself.  The server is one a
    process: the first caller's ``preload`` is the one it keeps."""
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", __name__, *preload])
    return ctx


def collective_census() -> dict[str, dict]:
    """Every collective this process ran through the choke points since
    :func:`reset_census`, by axis label (``"dp"``, ``"fsdp"``, ``"tp"``,
    ``"dp+fsdp"`` for the data group, ``"world"`` for the default group):
    ``{"ops": {op: count}, "bytes": result bytes}``, ops named as the
    reference's HLO census names them (a ring hop's tensor is one
    ``collective-permute``: it goes to the next rank of the line and one
    comes from the previous).  Gloo takes CUDA tensors for the four
    collectives and stages them through host memory itself; the ring's
    point-to-point hop stages them explicitly
    (:func:`~edl_tpu_torch.parallel.ring_attention.exchange`)."""
    return copy.deepcopy(_census)


def reset_census() -> None:
    _census.clear()


def _count(op: str, axis: str, nbytes: int) -> None:
    slot = _census.setdefault(axis, {"ops": {}, "bytes": 0})
    slot["ops"][op] = slot["ops"].get(op, 0) + 1
    slot["bytes"] += int(nbytes)


def _broadcast(t: torch.Tensor, src: int, group, axis: str) -> None:
    """Every broadcast of the trainer (the seam tests plant faults in):
    ``t`` of rank ``src`` into ``t`` of every rank of ``group`` (None: the
    default group)."""
    dist.broadcast(t, src, group=group)
    _count("broadcast", axis, t.nbytes)


def _all_reduce(t: torch.Tensor, op, group, axis: str) -> None:
    """Every all-reduce of the trainer, in place over ``group`` (None: the
    default group)."""
    dist.all_reduce(t, op=op, group=group)
    _count("all-reduce", axis, t.nbytes)


def _all_gather(out: torch.Tensor, t: torch.Tensor, group,
                axis: str) -> None:
    """Every all-gather of the trainer: ``out`` (flat, k times ``t``'s
    elements) ← the flat ``t`` of each of the k ranks of ``group``, in
    rank order."""
    dist.all_gather_into_tensor(out, t, group=group)
    _count("all-gather", axis, out.nbytes)


def _reduce_scatter(out: torch.Tensor, t: torch.Tensor, group,
                    axis: str) -> None:
    """Every reduce-scatter of the trainer: ``out`` ← this rank's chunk
    (its rank's k-th of the elements) of the sum over ``group`` of each
    rank's flat ``t``."""
    dist.reduce_scatter_tensor(out, t, group=group)
    _count("reduce-scatter", axis, out.nbytes)


def _ring_hop(tensors, dst: int, src: int, group,
              axis: str) -> list[torch.Tensor]:
    """Every ring hop of the trainer: each of ``tensors`` to global rank
    ``dst``, as many received from ``src``, over ``group``; one
    ``collective-permute`` a tensor."""
    got = ring_attention.exchange(tensors, dst, src, group)
    for t in tensors:
        _count("collective-permute", axis, t.nbytes)
    return got


def _fresh(shape: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A buffer of a resize (the seam tests plant an allocation failure
    in)."""
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
    #: the virtual-worker job seed the loop stamps (runtime.virtual)
    job_seed: Optional[int] = None


@dataclass(frozen=True)
class _Buffer:
    """A leaf of the state as a resize prices and moves it: its full shape
    and dtype."""

    shape: tuple
    dtype: torch.dtype


#: one block of a leaf: ((start, stop), ...) per dimension
Block = tuple


def _meet(a: Block, b: Block) -> Optional[Block]:
    out = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _within(block: Block, origin: Block) -> tuple:
    """Index of ``block`` in a tensor holding block ``origin``."""
    return tuple(slice(lo - o, hi - o)
                 for (lo, hi), (o, _) in zip(block, origin))


def _placements(tree: dict, specs: dict,
                shape: MeshShape) -> dict[str, Placement]:
    """Each leaf of ``tree`` (name -> anything with ``.shape``) on
    ``shape``, laid out by its partition spec ``specs[name]`` (None:
    replicated).  The one place that decides which block a rank holds: the
    trainer's own block, a resize's moves and its price all read it."""
    return {name: Placement.of_spec(tuple(getattr(leaf, "shape", ()) or ()),
                                    specs[name], shape)
            for name, leaf in tree.items()}


def _numel(block: Block) -> int:
    n = 1
    for lo, hi in block:
        n *= hi - lo
    return n


@dataclass
class _Moves:
    """A resize's transfer as this rank sees it: the broadcasts, the same
    in the same order on every rank of the prefix spanning both worlds,
    each ``(source rank, leaf, block)``; those whose bytes this rank takes;
    the blocks it copies locally; and the new block of each leaf it
    rebuilds."""

    sends: list = field(default_factory=list)
    takes: set = field(default_factory=set)
    local: list = field(default_factory=list)
    new: dict = field(default_factory=dict)


@dataclass
class _Staged:
    """The new layout, staged: committed as a unit or dropped."""

    mesh: Mesh
    layout: dict
    specs: dict
    split: dict
    moves: _Moves
    #: this rank's fresh buffers: its new blocks, and the broadcasts it
    #: cannot send from its state or receive into a new block in place
    blocks: dict = field(default_factory=dict)
    wire: dict = field(default_factory=dict)


class ElasticTrainer:
    """SPMD elastic trainer: data parallel, fully sharded, or laid out by
    the model's partition specs (fsdp and Megatron tp).

    ``loss_fn(params, batch) -> scalar tensor`` defines the model;
    ``optimizer`` is a factory from :mod:`edl_tpu_torch.runtime.optim`.
    Every rank of the default process group constructs the trainer with the
    same arguments; the first world is the whole group, or its first
    ``initial_world_size`` ranks.  ``devices`` names this rank's device
    (default: ``cuda:(rank mod device count)``; without a process group,
    the first CUDA device).  ``param_sharding`` is ``"replicated"`` (pure
    data parallel) or ``"fsdp"`` (params and optimizer state sharded over
    the fsdp axis — give the spec one, e.g. ``MeshSpec(dp=1, fsdp=-1)``),
    as in the reference, both replicated over tp; or a dict of partition
    specs by parameter name, each dimension over ``"fsdp"``, ``"tp"`` or
    None (``param_partition_specs(cfg)``, e.g. with ``MeshSpec(tp=-1)``),
    which every layout, a resize's too, is derived from.  A leaf split
    over tp needs a loss that reads the tp context (the transformer's).
    A spec with sp > 1 (``MeshSpec(sp=-1)``, or the reference dryrun's
    ``MeshSpec(dp=-1, fsdp=2, tp=2, sp=2)``) splits the sequence for a loss
    that reads the sp context (the transformer's) and replicates every
    leaf over sp, as the reference's specs do; any other loss computes the
    whole batch on every rank of an sp line.

    ``accum_mode`` places :meth:`step_accumulate`'s micro-batches, as in the
    reference: ``"dp"`` packs them into rounds of the world's width,
    ``"replicated"`` runs every one on every live rank.

    ``rng_in_loss=True`` makes the loss ``loss_fn(params, batch, key)``, with
    ``key`` a micro-batch's ``torch.Generator`` from the virtual-worker
    lineage (:func:`edl_tpu_torch.runtime.virtual.vw_keys`); such a trainer
    steps only through :meth:`step_accumulate`, which carries the keys.
    """

    def __init__(
        self,
        loss_fn: Callable[[nn.Module, Any], torch.Tensor],
        params: nn.Module,
        optimizer: OptimizerFactory,
        spec: MeshSpec = MeshSpec(dp=-1),
        param_sharding: Union[str, Mapping[str, tuple]] = "replicated",
        devices: Optional[Sequence[torch.device]] = None,
        initial_world_size: Optional[int] = None,
        accum_mode: str = "dp",
        rng_in_loss: bool = False,
        prewarm_cache_limit: int = 4,
    ) -> None:
        if isinstance(param_sharding, Mapping):
            bad = {n: s for n, s in param_sharding.items()
                   if any(e not in (None, AXIS_FSDP, AXIS_TP)
                          for e in tuple(s or ()))}
            if bad:
                raise ValueError(
                    "this trainer splits a dimension over fsdp or tp alone; "
                    f"specs {dict(list(bad.items())[:3])} name other axes")
            param_sharding = {n: tuple(s or ())
                              for n, s in param_sharding.items()}
            kind = "specs"
        elif param_sharding in ("replicated", "fsdp"):
            kind = param_sharding
        else:
            raise ValueError(f"unknown param_sharding {param_sharding!r}: "
                             "'replicated', 'fsdp' or a dict of partition "
                             "specs")
        if accum_mode not in ("dp", "replicated"):
            raise ValueError(f"unknown accum_mode {accum_mode!r}")
        self.loss_fn = loss_fn
        self.spec = spec
        #: "replicated", "fsdp", or "specs" (laid out by partition specs)
        self.param_sharding_kind = kind
        self._sharding = param_sharding
        self.accum_mode = accum_mode
        self.rng_in_loss = rng_in_loss
        if distributed():
            self._device = (torch.device(devices[0]) if devices
                            else local_device())
            self.rank, group_size = dist.get_rank(), dist.get_world_size()
        else:
            self._device = make_mesh(devices=devices).devices[0]
            self.rank, group_size = 0, 1
        self._group_size = group_size
        self.resizes = 0
        self.resizes_failed = 0
        #: one record per successful resize, with the reference's fields
        self.resize_events: list[dict] = []
        #: the mesh of every layout seen, by (size, shape): oscillating
        #: between layouts builds no new process group
        self._step_cache: dict[tuple, Mesh] = {}
        #: who built each cached layout: "resize" inline, or "prewarm"
        self._sources: dict[tuple, str] = {}
        #: speculative builds in flight, by layout, in submission order
        self._building: dict[tuple, concurrent.futures.Future] = {}
        #: prewarmed layouts whose groups no collective has touched yet,
        #: with the group spanning both worlds built beside each (and its
        #: size)
        self._cold: dict[tuple, tuple] = {}
        #: prewarmed layouts no resize has used yet, oldest first: bounded
        #: by ``prewarm_cache_limit``
        self._prewarm_unused: list[tuple] = []
        self.prewarm_cache_limit = max(int(prewarm_cache_limit), 1)
        #: the SDC seams' pending strikes: (leaf, bit) per corrupt update,
        #: and the count of poisoned loss reports
        self._corrupt_updates: list[tuple[int, int]] = []
        self._poison_losses_pending = 0
        self.mesh: Mesh = self._acquire(self._resolve_target(
            initial_world_size or group_size))[0]
        params.to(self._device)
        #: each leaf's full shape and dtype
        self._leaves = {n: _Buffer(tuple(p.shape), p.dtype)
                        for n, p in params.named_parameters()}
        if self.live and self.world_size > 1:
            # replicas start from rank 0's weights, whatever each rank drew
            for p in params.parameters():
                _broadcast(p.detach(), 0, self.mesh.group,
                           self.mesh.label(AXES))
        #: each leaf's partition spec on the live layout
        self._specs = self._specs_for(self.shape, self._leaves)
        self._shards: dict[str, nn.Parameter] = {}
        if self.sharded:
            for n, p in params.named_parameters():
                self._shards[n] = nn.Parameter(
                    self._own_block(p.detach(), n).clone()
                    if self.live else self._empty(p.dtype))
                p.data = self._empty(p.dtype)
        self.state = TrainState(params=params, opt_state=optimizer(
            list(self._shards.values()) if self.sharded
            else list(params.parameters())))

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

    @property
    def sharded(self) -> bool:
        """True for an fsdp trainer or one placed by partition specs
        (whatever the live layout): it keeps its blocks in
        :attr:`shards`."""
        return self.param_sharding_kind != "replicated"

    @property
    def shards(self) -> dict[str, nn.Parameter]:
        """What the optimizer steps, by parameter name: this rank's block
        of each leaf (an fsdp trainer), or the module's parameters."""
        if self.sharded:
            return self._shards
        return dict(self.state.params.named_parameters())

    def full_shapes(self) -> dict[str, tuple]:
        """Each leaf's full shape, by parameter name."""
        return {n: b.shape for n, b in self._leaves.items()}

    def sharded_dims(self) -> dict[str, Optional[int]]:
        """Each leaf's dimension split over the fsdp axis on the live
        layout (None: none is)."""
        return {n: self._axis_dim(n, AXIS_FSDP) for n in self._specs}

    def partition_specs(self) -> dict[str, tuple]:
        """Each leaf's partition spec on the live layout, one entry a
        dimension."""
        return dict(self._specs)

    def full_params(self) -> dict[str, torch.Tensor]:
        """Every parameter whole, as the reference's global arrays read:
        gathered leaf by leaf over the fsdp and tp groups on a live rank
        (collective over the live group), a copy of this rank's on one
        standing by."""
        if not self.live:
            return {n: s.detach().clone() for n, s in self.shards.items()}
        whole = {n: self._whole(n, self.shards[n]) for n in sorted(
            self._leaves)}
        return {n: whole[n] for n in self.shards}

    def whole_state(self) -> Optional[dict]:
        """The whole training state for a checkpoint, flattened to the
        paths a replicated trainer's ``{"params": module, "opt":
        optimizer}`` is saved under (``['params']['layers'][0]['wq']``,
        ``['opt']['layers'][0]['wq']['exp_avg']``, ``…['exp_avg_sq']``,
        ``…['step']``, Adam's count by value); the hyperparameters stay
        the optimizer's, as in a replicated restore.

        Collective over the live group: every live rank calls it (a rank
        standing by need not, and gets None).  Each leaf, the parameter and
        then each of its moments, in the order of the leaves' names, is
        gathered over the fsdp group and then the tp group (census label
        ``"checkpoint"``) and copied to rank 0's host memory before the
        next, so no device holds a second whole state.  Returns the
        :class:`~edl_tpu_torch.runtime.checkpoint.Snapshot` on rank 0 and
        None on the other ranks.  A replicated trainer's rank 0 holds the
        whole state already and returns its module and optimizer (which a
        save copies)."""
        if not self.live:
            return None
        if not self.sharded:
            return ({"params": self.state.params,
                     "opt": self.state.opt_state} if self.rank == 0 else None)
        opt, writer = self.state.opt_state, self.rank == 0
        flat = Snapshot()
        for name in sorted(self._leaves):
            shard = self._shards[name]
            path = param_path(name)
            leaves = [(("params",) + path, shard)]
            for key, v in sorted(opt.state.get(shard, {}).items()):
                leaves.append((("opt",) + path + (key,), v))
            for where, t in leaves:
                if self._is_block(t, shard):
                    t = self._whole(name, t, CHECKPOINT_LABEL)
                if writer:
                    flat[keystr(where)] = t.detach().to("cpu", copy=True)
        return flat if writer else None

    def lane_folds(self) -> list[tuple[str, int, int, str]]:
        """Each parameter's whole-leaf lane xor for the SDC fingerprint
        (:class:`~edl_tpu_torch.runtime.sdc.BlockFolds`): ``(keystr path,
        lane xor, byte count, dtype name)`` by the leaves' flatten order,
        folded where the leaves live.  A sharded trainer's live rank folds
        its blocks' shares (:func:`~edl_tpu_torch.runtime.sdc.block_words`)
        and all-gathers them over the live group (census label ``"sdc"``;
        NCCL has no xor reduce), then xors one rank's share of each distinct
        block: collective over the live group.  A rank standing by must not
        call it."""
        names = sorted(self._leaves, key=param_path)
        local = self.shards
        full = dict(self._leaves)
        places = _placements(full, self._specs, self.shape)
        words = sdc.lane_xors([
            sdc.block_words(local[n], places[n].blocks[self.rank],
                            full[n].shape) for n in names])
        if self.sharded and self.world_size > 1:
            mine = torch.tensor(words, dtype=torch.int64, device=self.device)
            out = torch.empty(self.world_size * len(words),
                              dtype=torch.int64, device=self.device)
            _all_gather(out, mine, self.mesh.group, SDC_LABEL)
            rows = out.view(self.world_size, -1).tolist()
            for i, n in enumerate(names):
                blocks, acc = {}, 0
                for r in range(self.world_size):
                    blocks.setdefault(places[n].blocks[r], r)
                for r in blocks.values():
                    acc ^= rows[r][i]
                words[i] = acc
        return [(keystr(param_path(n)), w,
                 int(np.prod(full[n].shape, dtype=np.int64))
                 * torch.empty((), dtype=full[n].dtype).element_size(),
                 str(full[n].dtype).removeprefix("torch."))
                for n, w in zip(names, words)]

    def load_whole_state(self, flat: Mapping) -> None:
        """``flat`` (whole leaves by the paths :meth:`whole_state` gives
        them, as a checkpoint restores them) into this trainer's live
        layout, on every rank of the default group: a live rank of a
        sharded trainer takes its own block of each parameter and moment
        (cut by this trainer's partition specs, whatever layout saved
        them), a replicated trainer's rank all of them, and a sharded
        trainer's rank standing by drops its blocks.  Entries not shaped as
        the leaf (Adam's count) are taken by value; the hyperparameters and
        the step counter stay this trainer's.  Raises on a leaf whose shape
        is not this trainer's."""
        opt = self.state.opt_state
        if self.sharded and not self.live:
            for s in self._shards.values():
                opt.state.pop(s, None)
                s.data = self._empty(s.dtype)
            return

        def place(name: str, whole: torch.Tensor) -> torch.Tensor:
            if tuple(whole.shape) != self._leaves[name].shape:
                raise ValueError(
                    f"checkpoint leaf {name} has shape {tuple(whole.shape)}, "
                    f"this trainer's {self._leaves[name].shape}")
            block = self._own_block(whole, name) if self.sharded else whole
            return block.to(self.device, copy=True,
                            memory_format=torch.contiguous_format)

        for name, shard in self.shards.items():
            path = param_path(name)
            shard.data = place(name, flat[keystr(("params",) + path)])
            pre = keystr(("opt",) + path) + "['"
            entries = {k[len(pre):-2]: v for k, v in flat.items()
                       if k.startswith(pre) and "[" not in k[len(pre):]}
            if not entries:
                opt.state.pop(shard, None)
                continue
            opt.state[shard] = {
                k: (place(name, v) if tuple(v.shape) ==
                    self._leaves[name].shape else v.clone())
                for k, v in entries.items()}

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
        """Move to ``target`` (an int world size through the spec, or a
        MeshShape: a live dp×fsdp re-split); every rank calls it with the
        same target at the same step boundary.  Returns True when the live
        mesh has that layout afterwards.  On any failure, on any rank,
        every rank keeps the current layout, counts ``resizes_failed`` and
        returns False."""
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
        get_counters().inc("prewarm_hits" if evt["prewarm_hit"]
                           else "prewarm_misses")
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

    def prewarm(self, sizes: Sequence, wait: bool = False
                ) -> Optional[concurrent.futures.Future]:
        """Queue the builds of likely next layouts (an int world size
        through the spec, or a MeshShape) on the group-build thread, so
        that a later :meth:`resize` to one of them pays only the move.
        Targets that are invalid, beyond the process group, current,
        already built or already building are skipped.  Every rank calls
        it with the same targets at the same step boundary, as it calls
        ``resize``.  A failed build is logged and counted
        (``prewarms_failed``) when the trainer next looks, and the resize
        builds inline.

        Returns the future of the last build queued (None when there was
        nothing to do); ``wait=True`` waits for the builds and warms their
        groups on this thread (:meth:`prewarm_quiesce`)."""
        self._collect()
        wanted: list[MeshShape] = []
        for target in sizes:
            try:
                shape = self._resolve_target(target)
                self._check_layout(shape)
            except (TypeError, ValueError):
                continue
            key = self._cache_key(shape)
            if (shape == self.shape or shape in wanted
                    or key in self._step_cache or key in self._building):
                continue
            wanted.append(shape)
        future = None
        for shape in wanted:
            union = max(self.world_size, shape.size)
            future = submit_build(self._build_layout, shape, union)
            self._building[self._cache_key(shape)] = future
        if wait and future is not None:
            self.prewarm_quiesce(BUILD_WAIT_TIMEOUT_S)
        return future

    def is_building(self, target) -> bool:
        """True while a speculative build for ``target`` is in flight: a
        loop may keep stepping on the current world and resize a few steps
        later, when the layout is ready."""
        try:
            key = self._cache_key(self._resolve_target(target))
        except (TypeError, ValueError):
            return False  # unresolvable target: nothing can be building
        self._collect()
        return key in self._building

    def prewarm_quiesce(self, timeout_s: float = 10.0) -> bool:
        """Wait up to ``timeout_s`` for every speculative build, then run
        the first collective on each new group of the built layouts, on
        this thread (NCCL creates a communicator at its group's first
        collective).  Call it on every rank at the same step boundary.
        True when nothing is left building."""
        concurrent.futures.wait(list(self._building.values()),
                                timeout=timeout_s)
        self._collect()
        for key in list(self._cold):
            self._warm(key)
        return not self._building

    def step(self, batch) -> Optional[float]:
        """One training step on the live world; returns the loss over the
        whole global batch.  A rank standing by computes nothing and
        returns None."""
        if self.rng_in_loss:
            raise ValueError(
                "rng_in_loss trainers step via step_accumulate(micro, "
                "rng_keys=...) — the plain step path carries no key")
        if not self.live:
            return None
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        with self._gathered():
            with self._tp(), self._sp(), self._split():
                loss = self.loss_fn(self.state.params, self._local(batch))
                loss.backward()
            loss = loss.detach()
            self._reduce_grads([loss])
        if self._width > 1:
            self._scale([*self._shard_grads(), loss], 1.0 / self._width)
        opt.step()
        opt.zero_grad(set_to_none=True)  # no gradient is kept at rest
        self.state.step += 1
        return float(loss)

    def eval_loss(self, batch) -> Optional[float]:
        """The training objective over the global batch, touching no state
        (None on a rank standing by)."""
        if not self.live:
            return None
        with torch.no_grad(), self._gathered(), self._tp(), self._sp(), \
                self._split():
            loss = self.loss_fn(self.state.params, self._local(batch))
        if self._width > 1:
            self._sum_over(self.mesh.data, self._data_label, [loss])
            self._scale([loss], 1.0 / self._width)
        return float(loss)

    def step_accumulate(self, micro_batches: Sequence,
                        rng_keys: Optional[Sequence] = None,
                        abort_after: Optional[int] = None
                        ) -> Optional[float]:
        """One constant-effective-batch step: the gradients of the V
        micro-batches are summed, scaled by 1 / V and applied as a single
        optimizer update.  Returns the mean of the micro losses (None on a
        rank standing by).

        ``accum_mode="dp"`` packs the micro-batches into ⌈V/N⌉ rounds of the
        world's width N (its batch axes dp·fsdp), the ranks of data
        coordinate r taking micro-batch ``k·N + r`` of round k, and reduces
        the gradients over the data group once; it needs N to
        divide V (else, as in the reference, the micro-batches run as in
        ``"replicated"``), and equals one device's result within float
        bounds.  ``"replicated"`` runs every micro-batch on every live rank
        on the gathered parameters with no reduction (each rank keeps its
        block of the summed gradient), so the update is bitwise the same at
        any world size and layout without sp; on an sp layout each rank
        takes its chunk of every micro-batch and the gradients are averaged
        over the sp line.

        ``abort_after=k`` raises :class:`AccumulationAborted` after k
        micro-batches, before the update: state is untouched.

        ``rng_keys`` (one generator per micro-batch, in VW order) are
        required by an ``rng_in_loss`` trainer and force the replicated
        path: a packed round would smear one key over many VWs."""
        V = len(micro_batches)
        if V == 0:
            raise ValueError("step_accumulate needs at least 1 micro-batch")
        if self.rng_in_loss and (rng_keys is None or len(rng_keys) != V):
            raise ValueError("rng_in_loss trainer needs one rng key per "
                             "micro-batch")
        if not self.live:
            return None
        n, sp = self._batch_width, self.shape.sp
        use_dp = (self.accum_mode == "dp" and not self.rng_in_loss and n > 1
                  and V % n == 0)
        mine = (micro_batches[self._data_index::n] if use_dp
                else micro_batches)
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        lsum, done = 0.0, 0
        with self._gathered():
            with self._tp(), self._sp():
                for v, mb in enumerate(mine):
                    args = (rng_keys[v],) if self.rng_in_loss else ()
                    loss = self.loss_fn(self.state.params,
                                        self._to_device(mb), *args)
                    loss.backward()  # .grad accumulates the sum
                    lsum += float(loss.detach())
                    done += n if use_dp else 1
                    if abort_after is not None and done >= abort_after:
                        raise AccumulationAborted(
                            f"injected kill after {done}/{V} micro-batches "
                            f"at step {self.state.step}")
            total = torch.tensor(lsum, dtype=torch.float64,
                                 device=self.device)
            if use_dp:
                self._reduce_grads([total])
            else:
                if sp > 1:
                    self._sum_over(self.mesh.groups[AXIS_SP], AXIS_SP, [
                        p.grad for p in self._module.values()
                        if p.grad is not None] + [total])
                self._keep_own_grads()
        if self._corrupt_updates:
            # the CorruptGradient seam: ONE bit of the summed gradient
            # flips before the update — the canonical silent corruption
            leaf, bit = self._corrupt_updates.pop(0)
            grads = {}
            for n, s in self.shards.items():
                if s.grad is None:
                    s.grad = torch.zeros_like(s)
                grads[n] = s.grad
            self._strike(grads, leaf, bit)
            log.warn("injected gradient corruption before the update",
                     step=self.state.step, leaf=leaf, bit=bit)
            get_tracer().instant("sdc_gradient_corrupted", category="chaos",
                                 step=self.state.step)
        # every sum above holds each micro-batch once a rank of the sp line
        self._scale(self._shard_grads(), 1.0 / (V * sp))
        opt.step()
        opt.zero_grad(set_to_none=True)
        self.state.step += 1
        if self._poison_losses_pending > 0:
            # the PoisonLoss seam: the REPORT lies, the params are clean
            self._poison_losses_pending -= 1
            log.warn("injected poisoned loss report", step=self.state.step)
            get_tracer().instant("sdc_loss_poisoned", category="chaos",
                                 step=self.state.step)
            return float("nan")
        return float(total) / (V * sp)

    # -- SDC chaos seams ---------------------------------------------------

    def inject_update_corruption(self, n: int = 1, leaf: int = 0,
                                 bit: int = 17) -> None:
        """Flip one bit of the summed gradient of each of the next ``n``
        :meth:`step_accumulate` calls, before the update — the
        ``CorruptGradient`` fault.  The bit is bit ``bit % 8`` of byte
        ``(bit // 8) % nbytes`` of leaf ``leaf`` (leaves counted as the
        reference flattens its gradient tree; its defaults are 0 and 17).
        Each live rank calls it, as the seam strikes where the element
        lives (see the module docstring)."""
        self._corrupt_updates += [(int(leaf), int(bit))] * int(n)

    def inject_loss_poison(self, n: int = 1) -> None:
        """Make the next ``n`` :meth:`step_accumulate` calls RETURN a NaN
        loss while applying the honest update — the ``PoisonLoss`` fault,
        which the SDC shadow recompute must refute, not roll back."""
        self._poison_losses_pending += int(n)

    def flip_param_bits(self, leaf: int = 0, bit: int = 17) -> None:
        """Flip one bit of one live parameter leaf in place — the
        ``FlipParamBits`` fault: bit ``bit % 8`` of byte ``(bit // 8) %
        nbytes`` of leaf ``leaf``, counted as the reference's
        ``flip_tree_bit`` counts them.  Each live rank calls it; the rank
        holding that byte flips it (every replica, on a replicated world);
        a rank standing by does nothing."""
        if not self.live:
            return
        with torch.no_grad():
            self._strike({n: s.detach() for n, s in self.shards.items()},
                         leaf, bit)
        log.warn("injected parameter bit flip", step=self.state.step,
                 leaf=leaf, bit=bit)
        get_tracer().instant("sdc_param_bits_flipped", category="chaos",
                             step=self.state.step, leaf=leaf, bit=bit)

    def _strike(self, local: Mapping[str, torch.Tensor], leaf: int,
                bit: int) -> bool:
        """Flip bit ``bit % 8`` of byte ``(bit // 8) % nbytes`` of leaf
        number ``leaf`` (in the flatten order of its full tensor) in
        ``local[name]``, this rank's block of it, when the block holds that
        byte; True when it did."""
        names = sorted(self._leaves, key=param_path)
        name = names[leaf % len(names)]
        buf = self._leaves[name]
        itemsize = torch.empty((), dtype=buf.dtype).element_size()
        numel = int(np.prod(buf.shape, dtype=np.int64))
        element, byte = divmod((bit // 8) % (numel * itemsize), itemsize)
        index = np.unravel_index(element, buf.shape) if buf.shape else ()
        block = _placements({name: buf}, self._specs,
                            self.shape)[name].blocks[self.rank]
        if not all(lo <= i < hi for i, (lo, hi) in zip(index, block)):
            return False
        t = local[name]
        if not t.is_contiguous():
            raise ValueError(f"{name}: this rank's block is not contiguous")
        at = int(np.ravel_multi_index(
            tuple(i - lo for i, (lo, _) in zip(index, block)),
            tuple(hi - lo for lo, hi in block))) if buf.shape else 0
        word = t.reshape(-1)[at:at + 1].view(torch.uint8)
        word[byte:byte + 1].bitwise_xor_(1 << (bit % 8))
        return True

    # -- the step's collectives --------------------------------------------

    @property
    def _module(self) -> dict[str, nn.Parameter]:
        """The module's parameters by name: what the forward reads."""
        return dict(self.state.params.named_parameters())

    @property
    def _data_label(self) -> str:
        return self.mesh.label(DATA_AXES)

    @property
    def _width(self) -> int:
        """The ranks of the live mesh's data axes, dp·fsdp·sp: what every
        gradient and the loss are averaged over."""
        return self._batch_width * self.shape.sp

    @property
    def _batch_width(self) -> int:
        """The ranks of the live mesh's batch axes, dp·fsdp: the batch's
        split."""
        return self.shape.dp * self.shape.fsdp

    @property
    def _data_index(self) -> int:
        """This rank's coordinate over the data axes: its slice of the
        batch."""
        return data_coordinate(self.shape, self.rank)

    def _axis_dim(self, name: str, axis: str) -> Optional[int]:
        """The dimension of leaf ``name`` split over ``axis`` on the live
        layout (None: none is, or the axis has one rank)."""
        spec = self._specs[name]
        if getattr(self.shape, axis) == 1 or axis not in spec:
            return None
        return spec.index(axis)

    def _specs_for(self, shape: MeshShape, tree: dict) -> dict:
        """Each leaf's partition spec on ``shape``: the fsdp rule's, all
        None, or the trainer's specs."""
        return tree_shardings(shape, tree, self._sharding)

    def _tp(self):
        """The tp context of a step on the live layout (a null context
        when no leaf is split over tp): every tp collective of the model
        goes through :func:`_all_reduce` over this rank's tp group,
        counted under ``"tp"``."""
        if all(self._axis_dim(n, AXIS_TP) is None for n in self._specs):
            return contextlib.nullcontext()
        group, shape = self.mesh.groups[AXIS_TP], self.shape

        def reduce(t: torch.Tensor, op) -> None:
            _all_reduce(t, op, group, AXIS_TP)

        return tensor_parallel.tp_context(tensor_parallel.TPContext(
            size=shape.tp, rank=self.rank // (shape.sp * shape.ep) % shape.tp,
            reduce=reduce))

    def _sp(self):
        """The sp context of a step on the live layout (a null context at
        sp 1): the model's ring hops go through :func:`_ring_hop` to the
        neighbours on this rank's sp line, counted under ``"sp"``."""
        shape = self.shape
        if shape.sp == 1:
            return contextlib.nullcontext()
        group = self.mesh.groups[AXIS_SP]
        line = axis_ranks(shape, AXIS_SP, self.rank)
        i = line.index(self.rank)
        nxt, prv = line[(i + 1) % len(line)], line[i - 1]

        def hop(tensors, reverse: bool = False) -> list[torch.Tensor]:
            dst, src = (prv, nxt) if reverse else (nxt, prv)
            return _ring_hop(tensors, dst, src, group, AXIS_SP)

        return ring_attention.sp_context(ring_attention.SPContext(
            size=shape.sp, rank=i, hop=hop))

    def _split(self):
        """The batch split of a step on the live layout (a null context at
        one data rank): a loss that weighs its tokens asks it for the
        global weight (:func:`tensor_parallel.weight_total`), through
        :func:`_all_reduce` over the data group."""
        if self._width == 1:
            return contextlib.nullcontext()
        group, label = self.mesh.data, self._data_label

        def reduce(t: torch.Tensor, op) -> None:
            _all_reduce(t, op, group, label)

        return tensor_parallel.split_context(tensor_parallel.BatchSplit(
            size=self._width, reduce=reduce))

    def _empty(self, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(0, dtype=dtype, device=self.device)

    def _own_block(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's block of the full tensor of leaf ``name`` (a view)."""
        block = _placements({name: full}, self._specs,
                            self.shape)[name].blocks[self.rank]
        return full[tuple(slice(lo, hi) for lo, hi in block)]

    def _is_block(self, t, shard: torch.Tensor) -> bool:
        """True when ``t`` (an optimizer entry of ``shard``'s leaf, or the
        shard) is shaped as this rank's block of the leaf."""
        return isinstance(t, torch.Tensor) and t.shape == shard.shape \
            and t.device == self.device

    def _whole(self, name: str, block: torch.Tensor,
               label: Optional[str] = None) -> torch.Tensor:
        """Leaf ``name`` whole (a new tensor) from this rank's ``block`` of
        it, the parameter's or a moment's: gathered over the fsdp group,
        then the tp group, under the census ``label`` (default: the
        axis)."""
        t, gathered = block.detach(), False
        for axis in (AXIS_FSDP, AXIS_TP):
            d = self._axis_dim(name, axis)
            if d is not None:
                t = self._gather({name: t}, {name: d}, axis, label)[name]
                gathered = True
        return t if gathered else t.clone()

    def _fsdp_block(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's fsdp block of ``t`` (a leaf gathered over the fsdp
        group) along its dimension ``d`` (a view)."""
        k = self.shape.fsdp
        j = self._data_index % k
        m = t.shape[d] // k
        return t.narrow(d, j * m, m)

    def _by_dtype(self, names) -> dict[torch.dtype, list[str]]:
        out: dict[torch.dtype, list[str]] = {}
        for n in names:
            out.setdefault(self._leaves[n].dtype, []).append(n)
        return out

    @contextlib.contextmanager
    def _gathered(self):
        """The module's parameters for the body, whole or this rank's tp
        block: on a sharded trainer each leaf split over fsdp is
        all-gathered over the fsdp group (one flat buffer per dtype) and
        each other one bound to its shard; on exit the gathered tensors and
        their gradients are dropped again."""
        if not self.sharded:
            yield
            return
        module = self._module
        try:
            split = {n: d for n in module
                     if (d := self._axis_dim(n, AXIS_FSDP)) is not None}
            for n, p in module.items():
                if n not in split:
                    p.data = self._shards[n].data
            if split:
                gathered = self._gather({n: self._shards[n] for n in split},
                                        split, AXIS_FSDP)
                for n, t in gathered.items():
                    module[n].data = t
            yield
        finally:
            for p in module.values():
                p.grad = None
                p.data = self._empty(p.dtype)

    def _gather(self, parts: dict[str, torch.Tensor], dims: dict[str, int],
                axis: str, label: Optional[str] = None
                ) -> dict[str, torch.Tensor]:
        """Each tensor of ``parts`` concatenated, along its dimension
        ``dims[name]``, with those of the other ranks of this rank's
        ``axis`` group, in rank order: one all-gather a dtype, counted under
        ``label`` (default: the axis)."""
        k, group = getattr(self.shape, axis), self.mesh.groups[axis]
        out = {}
        for dtype, names in self._by_dtype(parts).items():
            flats = [parts[n].detach().movedim(dims[n], 0).reshape(-1)
                     for n in names]
            flat = torch.cat(flats)
            buf = torch.empty(k * flat.numel(), dtype=dtype,
                              device=self.device)
            _all_gather(buf, flat, group, label or axis)
            rows, off = buf.view(k, -1), 0
            for n, part in zip(names, flats):
                d, shape = dims[n], parts[n].shape
                moved = (k * shape[d], *shape[:d], *shape[d + 1:])
                out[n] = (rows[:, off:off + part.numel()].reshape(moved)
                          .movedim(0, d).contiguous())
                off += part.numel()
        return out

    def _shard_grads(self) -> list[torch.Tensor]:
        return [s.grad for s in self.shards.values() if s.grad is not None]

    def _scale(self, tensors: list[torch.Tensor], factor: float) -> None:
        with torch.no_grad():
            for t in tensors:
                t.mul_(factor)

    def _keep_own_grads(self) -> None:
        """Each shard's gradient ← its block of the module's gradient (no
        reduction: every rank computed the same sum)."""
        if not self.sharded:
            return
        for n, p in self._module.items():
            if p.grad is not None:
                d = self._axis_dim(n, AXIS_FSDP)
                self._shards[n].grad = (p.grad if d is None else
                                        self._fsdp_block(p.grad, d).clone())

    def _reduce_grads(self, extra: list[torch.Tensor]) -> None:
        """Each shard's gradient ← its block of the gradient summed over the
        data axes, and each tensor of ``extra`` ← its sum over them: a leaf
        split over fsdp by a reduce-scatter over the fsdp group then an
        all-reduce over the dp+sp group, any other leaf and ``extra`` by an
        all-reduce over the data group.  Nothing is summed over tp: the
        ranks of a tp group hold the same gradient of a leaf it does not
        split, and each its own block's of one it does."""
        grads = {n: p.grad for n, p in self._module.items()
                 if p.grad is not None}
        split = {n: d for n in grads
                 if (d := self._axis_dim(n, AXIS_FSDP)) is not None}
        blocks = self._scatter(grads, split) if split else {}
        if blocks and self.shape.dp * self.shape.sp > 1:
            self._sum_over(self.mesh.replica,
                           self.mesh.label((AXIS_DP, AXIS_SP)),
                           list(blocks.values()))
        whole = [g for n, g in grads.items() if n not in blocks]
        if self._width > 1:
            self._sum_over(self.mesh.data, self._data_label, whole + extra)
        if self.sharded:
            for n, g in grads.items():
                self._shards[n].grad = blocks.get(n, g)

    def _scatter(self, grads: dict, dims: dict[str, int]) -> dict:
        """The fsdp reduce-scatter of the gradients of ``dims``' leaves
        along those dimensions: one flat buffer per dtype, each leaf's k
        blocks laid out by rank."""
        k, group = self.shape.fsdp, self.mesh.groups[AXIS_FSDP]
        out = {}
        for dtype, names in self._by_dtype(dims).items():
            rows = [grads[n].movedim(dims[n], 0).reshape(k, -1)
                    for n in names]
            flat = torch.cat(rows, dim=1).reshape(-1)
            mine = torch.empty(flat.numel() // k, dtype=dtype,
                               device=self.device)
            _reduce_scatter(mine, flat, group, AXIS_FSDP)
            off = 0
            for n, r in zip(names, rows):
                d, shape = dims[n], grads[n].shape
                moved = (shape[d] // k, *shape[:d], *shape[d + 1:])
                out[n] = (mine[off:off + r.shape[1]].view(moved)
                          .movedim(0, d).contiguous())
                off += r.shape[1]
        return out

    def _local(self, batch):
        """This rank's contiguous slice of the global batch's leading dim
        (by its data coordinate over dp×fsdp), on the device."""
        n, r = self._batch_width, self._data_index
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

    def _sum_over(self, group, axis: str,
                  tensors: list[torch.Tensor]) -> None:
        """Each tensor ← its sum over ``group``, in place: one all-reduce
        of a flat buffer per dtype."""
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                _all_reduce(flat, dist.ReduceOp.SUM, group, axis)
                for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(part.view_as(t))

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

    def _check_layout(self, shape: MeshShape) -> None:
        """Raise ValueError unless this trainer can lay out ``shape``."""
        if shape.ep > 1:
            raise ValueError(
                f"{shape.describe()}: this trainer lays out dp, fsdp, tp and "
                "sp; the ep axis is not ported, as no model of the reference "
                "shards over it (ROADMAP.md queue 2, 'Configurations the "
                "port does not run')")
        if shape.size > 1 and not distributed():
            raise ValueError(f"a world of {shape.size} needs a process group "
                             f"of {shape.size} ranks; none is initialised")
        if shape.size > self._group_size:
            raise ValueError(f"want {shape.size} ranks, the process group "
                             f"has {self._group_size}")

    @staticmethod
    def _cache_key(shape: MeshShape) -> tuple:
        return shape.size, shape.key()

    def _acquire(self, shape: MeshShape) -> tuple[Mesh, bool]:
        """(the dp×fsdp×tp×sp mesh of ``shape`` over the rank prefix of its
        size, whether prewarm built it), from ``_step_cache`` or built: a
        layout still building speculatively is waited for, not built
        twice; a prewarmed one is warmed here if no quiesce has; one never
        seen is built now, its new process groups on the group-build
        thread (collective)."""
        self._check_layout(shape)
        key = self._cache_key(shape)
        self._collect()
        future = self._building.get(key)
        if future is not None:
            done, _ = concurrent.futures.wait([future],
                                              timeout=BUILD_WAIT_TIMEOUT_S)
            if not done:
                raise RuntimeError(
                    f"the build of {shape.describe()} is still in flight "
                    f"after {BUILD_WAIT_TIMEOUT_S} s; keeping the current "
                    "world")
            self._collect()  # a failed build falls through to build inline
        if key not in self._step_cache:
            self._step_cache[key] = make_mesh(shape.size, shape.to_spec(),
                                              devices=[self.device])
            self._sources[key] = "resize"
        if key in self._cold:
            self._warm(key)
        if key in self._prewarm_unused:
            self._prewarm_unused.remove(key)  # used: exempt from eviction
        return self._step_cache[key], self._sources[key] == "prewarm"

    def _build_layout(self, shape: MeshShape, union: int) -> tuple:
        """On the group-build thread: the mesh of ``shape``, the group
        spanning it and a world of ``union`` ranks, and the build's ms."""
        t0 = time.perf_counter()
        mesh = make_mesh(shape.size, shape.to_spec(), devices=[self.device])
        group = rank_group(union) if union > 1 else None
        return mesh, (group, union), (time.perf_counter() - t0) * 1000

    def _collect(self) -> None:
        """Take every finished speculative build into the cache, in
        submission order (a failed one is counted and dropped), then drop
        the oldest unused prewarmed layouts past the limit."""
        for key, future in list(self._building.items()):
            if not future.done():
                break  # later builds queue behind this one
            del self._building[key]
            try:
                mesh, group, build_ms = future.result()
            except Exception as exc:
                log.warn("mesh prewarm failed; a resize will build inline",
                         shape=dict(key[1]), error=str(exc)[:200])
                get_counters().inc("prewarms_failed")
                continue
            self._step_cache[key] = mesh
            self._sources[key] = "prewarm"
            self._cold[key] = group
            self._prewarm_unused.append(key)
            get_tracer().instant("mesh_prewarmed", category="elastic",
                                 size=key[0], shape=MeshShape.of_mesh(
                                     mesh).describe(),
                                 compile_ms=round(build_ms, 2))
            get_counters().inc("mesh_prewarms")
        while len(self._prewarm_unused) > self.prewarm_cache_limit:
            victim = self._prewarm_unused.pop(0)
            if victim == self._cache_key(self.shape):
                continue
            self._cold.pop(victim, None)
            if self._step_cache.pop(victim, None) is not None:
                self._sources.pop(victim, None)
                log.info("evicted unused prewarmed mesh", size=victim[0])
                get_counters().inc("prewarms_evicted")

    def _warm(self, key: tuple) -> None:
        """One small all-reduce over each group of the prewarmed layout
        ``key`` this rank belongs to (its prefix, the group spanning both
        worlds, its axis lines, its data group), in one order on every
        rank."""
        union, size = self._cold.pop(key)
        mesh = self._step_cache[key]
        groups = []
        if self.rank < mesh.size:
            groups.append(mesh.group)
        if union is not None and self.rank < size:
            groups.append(union)
        groups += [mesh.groups[a] for a in AXES if a in mesh.groups]
        groups += [mesh.data, mesh.replica]
        seen = set()
        for group in groups:
            if group is None or id(group) in seen:
                continue
            seen.add(id(group))
            _all_reduce(torch.zeros(1, device=self.device),
                        dist.ReduceOp.SUM, group, PREWARM_LABEL)

    def _agree(self, ok: bool) -> bool:
        """True when every rank of the default group says ``ok``."""
        if not distributed():
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=self.device)
        _all_reduce(flag, dist.ReduceOp.MIN, None, "world")
        return bool(flag.item())

    def _layout(self) -> dict:
        """What every rank needs to know of rank 0's state before the bytes
        move: each leaf's full shape and dtype, the optimizer state (a
        :class:`_Buffer` of the leaf's full shape for each tensor shaped
        as its block, on the device; anything else, such as Adam's step
        counts, by value),
        the optimizer's hyperparameters and the step."""
        opt = self.state.opt_state

        def entry(name, shard, v):
            if self._is_block(v, shard):
                return _Buffer(self._leaves[name].shape, v.dtype)
            return v

        return dict(
            step=self.state.step, params=list(self._leaves.items()),
            opt={n: {k: entry(n, s, v) for k, v in opt.state[s].items()}
                 for n, s in self.shards.items() if s in opt.state},
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
        _broadcast(size, 0, None, "world")
        if self.rank != 0:
            data = torch.empty(int(size), dtype=torch.uint8,
                               device=self.device)
        _broadcast(data, 0, None, "world")
        if self.rank == 0:
            return layout
        # bytes rank 0 of this job pickled a moment ago
        return pickle.loads(data.cpu().numpy().tobytes())

    @staticmethod
    def _priced_tree(layout: dict, specs: dict) -> tuple[dict, dict]:
        """The state as the plan prices it, leaf for leaf the reference's
        (params, optax state): each parameter, each optimizer tensor of a
        parameter, and each other optimizer entry once (Adam's step count,
        optax's one ``count``, replicated); with each entry's partition
        spec, its parameter's in ``specs``."""
        tree = {f"params.{n}": b for n, b in layout["params"]}
        tree_specs = {f"params.{n}": specs[n] for n, _ in layout["params"]}
        for n, entries in layout["opt"].items():
            for k, v in entries.items():
                if isinstance(v, _Buffer):
                    tree[f"opt.{k}.{n}"] = v
                    tree_specs[f"opt.{k}.{n}"] = specs[n]
                else:
                    tree.setdefault(f"opt.{k}", v)
                    tree_specs[f"opt.{k}"] = None
        return tree, tree_specs

    def _moves(self, layout: dict, old: MeshShape, new: MeshShape,
               new_specs: dict) -> _Moves:
        """The transfer of a resize from ``old`` to ``new``.  A leaf's
        distinct old blocks partition it; for each rank of the new world
        whose block changes, each piece of its new block comes from its own
        old block (a local copy) or else from the lowest rank holding it
        (one broadcast, shared by every rank that needs it)."""
        tensors = [("param", n) for n, _ in layout["params"]]
        tensors += [(k, n) for n, entries in layout["opt"].items()
                    for k, v in entries.items() if isinstance(v, _Buffer)]
        full = dict(layout["params"])
        olds = _placements(full, self._specs, old)
        news = _placements(full, new_specs, new)
        moves, me, sent = _Moves(), self.rank, set()
        for tid in tensors:
            was, will = olds[tid[1]].blocks, news[tid[1]].blocks
            pieces: dict = {}
            for r in range(old.size):
                pieces.setdefault(was[r], r)
            for r in range(new.size):
                ob = was.get(r) if r < old.size else None
                nb = will[r]
                if ob == nb:
                    continue
                if r == me:
                    moves.new[tid] = nb
                for piece, owner in pieces.items():
                    atom = _meet(piece, nb)
                    if atom is None:
                        continue
                    if piece == ob:
                        if r == me:
                            moves.local.append((tid, atom))
                        continue
                    if (tid, atom) not in sent:
                        sent.add((tid, atom))
                        moves.sends.append((owner, tid, atom))
                    if r == me:
                        moves.takes.add((tid, atom))
        return moves

    def _live_tensor(self, tid: tuple) -> torch.Tensor:
        key, name = tid
        shard = self.shards[name]
        if key == "param":
            return shard.detach()
        return self.state.opt_state.state[shard][key]

    def _stage(self, shape: MeshShape) -> _Staged:
        """Everything the new layout needs, without writing live state.
        Raises — on every rank alike — unless every rank of the default
        group staged it (the ready and commit votes)."""
        old = self.shape
        union = max(old.size, shape.size)
        error: Optional[Exception] = None
        t0 = time.perf_counter()
        hit = False
        try:
            mesh, hit = self._acquire(shape)
            group = rank_group(union) if union > 1 else None
        except Exception as exc:  # voted on below, with every rank
            error = exc
        t1 = t2 = t3 = time.perf_counter()
        staged = None
        if error is None:
            try:
                layout = self._broadcast_layout()
                t2 = time.perf_counter()
                specs = self._specs_for(shape, dict(layout["params"]))
                tree, old_specs = self._priced_tree(layout, self._specs)
                _, new_specs = self._priced_tree(layout, specs)
                plan = plan_reshard(
                    tree, _placements(tree, old_specs, old),
                    _placements(tree, new_specs, shape),
                    old_shape=old, new_shape=shape)
                t3 = time.perf_counter()
                staged = _Staged(
                    mesh=mesh, layout=layout, specs=specs,
                    moves=self._moves(layout, old, shape, specs),
                    split=dict(
                        compile_ms=round((t1 - t0) * 1000, 2),
                        replan_ms=round((t3 - t2) * 1000, 3),
                        prewarm_hit=hit, shape=shape.describe(),
                        bytes_moved=plan.bytes_moved,
                        bytes_ici=plan.bytes_ici, bytes_dcn=plan.bytes_dcn,
                        bytes_naive=plan.bytes_naive, transfer="device"))
                self._fresh_buffers(staged, union)
            except Exception as exc:
                error = exc
        if not self._agree(error is None):
            raise error or RuntimeError("another rank could not stage the "
                                        "resize")
        if self.rank < union:
            error = self._transfer(staged, group,
                                   (mesh if shape.size == union
                                    else self.mesh).label(AXES))
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

    def _fresh_buffers(self, staged: _Staged, union: int) -> None:
        """This rank's buffers for the move: each new block it rebuilds,
        and a wire buffer for each broadcast it cannot serve from a
        contiguous block of its state (as the source) or receive into a new
        block whole."""
        if self.rank >= union:
            return
        moves = staged.moves
        full = dict(staged.layout["params"])
        for tid, nb in moves.new.items():
            staged.blocks[tid] = _fresh(
                tuple(hi - lo for lo, hi in nb), full[tid[1]].dtype,
                self.device)
        old_block = self._old_blocks(staged)
        for owner, tid, atom in moves.sends:
            if owner == self.rank:
                if self._source(tid, atom, old_block).is_contiguous():
                    continue
            elif (tid, atom) in moves.takes and atom == moves.new[tid]:
                continue
            staged.wire[tid, atom] = _fresh(
                tuple(hi - lo for lo, hi in atom), full[tid[1]].dtype,
                self.device)

    def _source(self, tid: tuple, atom: Block, old_block: dict
                ) -> torch.Tensor:
        """The block ``atom`` of leaf ``tid`` in this rank's live state."""
        return self._live_tensor(tid)[_within(atom, old_block[tid[1]])]

    def _transfer(self, staged: _Staged, group,
                  axis: str) -> Optional[Exception]:
        """The blocks' move, in order: each broadcast from its source rank
        over the prefix spanning both worlds (sent from the live state,
        which it only reads, or a contiguous copy; received into the new
        block, or a wire buffer copied into it), then the local copies.  A
        rank whose broadcast raises still takes part in the rest, so that
        no peer waits on it, and returns its first error for the commit
        vote."""
        error = None
        moves, me = staged.moves, self.rank
        old_block = self._old_blocks(staged)
        for owner, tid, atom in moves.sends:
            buf = staged.wire.get((tid, atom))
            try:
                if me == owner:
                    src = self._source(tid, atom, old_block)
                    if buf is None:
                        buf = src
                    else:
                        buf.copy_(src)
                elif buf is None:
                    buf = staged.blocks[tid]
            except Exception as exc:
                error = error or exc
            try:
                _broadcast(buf, owner, group, axis)
                if ((tid, atom) in moves.takes
                        and buf is not staged.blocks.get(tid)):
                    staged.blocks[tid][_within(atom, moves.new[tid])].copy_(
                        buf)
            except Exception as exc:
                error = error or exc
        try:
            for tid, atom in moves.local:
                staged.blocks[tid][_within(atom, moves.new[tid])].copy_(
                    self._source(tid, atom, old_block))
        except Exception as exc:
            error = error or exc
        return error

    def _old_blocks(self, staged: _Staged) -> dict:
        """The block of each leaf this rank holds now (the live layout)."""
        if not self.live:
            return {}
        full = dict(staged.layout["params"])
        return {n: p.blocks[self.rank] for n, p
                in _placements(full, self._specs, self.shape).items()}

    def _commit(self, staged: _Staged) -> None:
        """The commit point: pure assignments.  Each rank of the new world
        takes its rebuilt blocks, rank 0's optimizer entries that are not
        tensors, its hyperparameters and its step; a rank of a sharded
        trainer that stands by drops its blocks."""
        self.mesh = staged.mesh
        self._specs = staged.specs
        layout, blocks = staged.layout, staged.blocks
        opt = self.state.opt_state
        if not self.live:
            if self.sharded:
                for s in self._shards.values():
                    opt.state.pop(s, None)
                    s.data = self._empty(s.dtype)
            return
        for name, shard in self.shards.items():
            if ("param", name) in blocks:
                shard.data = blocks["param", name]
            entries = layout["opt"].get(name)
            if entries is None:
                continue
            held = opt.state.get(shard, {})
            opt.state[shard] = {
                k: (blocks[k, name] if (k, name) in blocks else held[k])
                if isinstance(v, _Buffer) else v
                for k, v in entries.items()}
        for group, hyper in zip(opt.param_groups, layout["groups"]):
            group.update(hyper)
        self.state.step = layout["step"]
