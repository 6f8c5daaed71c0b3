"""Mesh shapes and meshes over a prefix of the job's devices — the port of
edl_tpu.parallel.mesh.

:class:`MeshSpec` is the elastic policy ("dp absorbs the rest"),
:class:`MeshShape` one concrete layout, and :class:`Mesh` the devices laid
out in that shape.  Axis conventions: ``dp`` data parallel, ``fsdp`` fully
sharded data parallel, ``tp`` tensor parallel, ``sp`` sequence parallel,
``ep`` expert parallel.

The port is SPMD: one process a rank.  Once ``torch.distributed`` is
initialised a mesh spans a rank prefix ``(0, …, n-1)`` of the default
process group, and carries the process group over that prefix
(:func:`rank_group`, built once per prefix size).  Without a process group a
mesh is a tuple of this process's devices, as before.

``dist.new_group`` is collective over the whole default group, and every
rank must call it the same number of times in the same order.  So every
process group of a mesh is built on one thread of this process, in the
order the builds were submitted (:func:`submit_build`): a build asked for
on the caller's thread waits its turn there, and a speculative one
(``ElasticTrainer.prewarm``) is queued without waiting.  Each rank submits
in program order, so each rank's build thread calls ``new_group`` in the
same order, whichever thread asked.

Ranks are laid out row-major over the axes in declaration order, as the
reference lays out devices: at dp2×fsdp2 over ranks 0-3 the fsdp groups
are {0, 1} and {2, 3} and the dp groups {0, 2} and {1, 3}
(:func:`axis_groups`); at dp2×fsdp2×tp2 over ranks 0-7 the tp groups are
{0, 1}, {2, 3}, … and the data groups (dp+fsdp+sp, :func:`data_group`)
{0, 2, 4, 6} and {1, 3, 5, 7}; sp is the axis inside tp, so at tp2×sp2 the
sp lines are {0, 1} and {2, 3} and the tp lines {0, 2} and {1, 3}.
:func:`fsdp_sharding` is the reference's fsdp rule and
:func:`tree_shardings` gives each leaf's layout, each as a partition spec
(one entry a dimension).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, "ep")


@dataclass(frozen=True)
class MeshSpec:
    """A named mesh shape, e.g. ``MeshSpec(dp=4, tp=2)``; ``-1`` on exactly
    one axis absorbs all remaining devices."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = self.axis_sizes()
        wilds = [a for a, s in sizes.items() if s == -1]
        if len(wilds) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = 1
        for s in sizes.values():
            if s != -1:
                fixed *= s
        if wilds:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wilds[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh spec wants {fixed} devices, got {n_devices}")
        return sizes


@dataclass(frozen=True)
class MeshShape:
    """A resolved mesh shape: a concrete size per axis, no wildcards;
    hashable, so equal shapes are one layout."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def __post_init__(self):
        for a, s in self.axis_sizes().items():
            if not isinstance(s, int) or s < 1:
                raise ValueError(f"MeshShape axis {a} must be a positive "
                                 f"int, got {s!r} (specs, not shapes, may "
                                 "carry -1 wildcards)")

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes().values():
            n *= s
        return n

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    def key(self) -> tuple:
        """Canonical hashable form: ((axis, size), ...) in axis order."""
        return tuple(self.axis_sizes().items())

    def to_spec(self) -> MeshSpec:
        return MeshSpec(**self.axis_sizes())

    def describe(self) -> str:
        """Compact human form, non-unit axes only: ``dp2xfsdp2``."""
        parts = [f"{a}{s}" for a, s in self.axis_sizes().items() if s > 1]
        return "x".join(parts) or "1"

    @classmethod
    def of_mesh(cls, mesh: "Mesh") -> "MeshShape":
        return cls(**{a: mesh.shape.get(a, 1) for a in AXES})

    @classmethod
    def resolve(cls, target, n_devices: Optional[int] = None,
                spec: Optional[MeshSpec] = None) -> "MeshShape":
        """A MeshShape as is, a MeshSpec over ``n_devices``, or an int world
        size through ``spec`` (default: dp absorbs everything)."""
        if isinstance(target, cls):
            return target
        if isinstance(target, MeshSpec):
            if n_devices is None:
                raise ValueError("resolving a MeshSpec needs n_devices")
            return cls(**target.resolve(n_devices))
        return cls(**(spec or MeshSpec(dp=-1)).resolve(int(target)))


@dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over the axes in declaration order.

    Under a process group, ``ranks`` is the rank prefix the mesh spans,
    ``group`` the process group over it, ``groups`` this rank's process
    group along each axis of more than one rank (:func:`axis_groups`),
    ``data`` its group over the data axes dp+fsdp+sp (:func:`data_group`),
    ``replica`` its group over dp+sp (:func:`replica_group`), and
    ``devices`` this process's device; without one, ``ranks`` is empty,
    ``group``, ``data`` and ``replica`` None and ``groups`` empty."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    axis_shape: tuple[int, ...]
    ranks: tuple[int, ...] = ()
    group: Any = field(default=None, compare=False)
    groups: Mapping[str, Any] = field(default_factory=dict, compare=False)
    #: this rank's process group over the data axes (:func:`data_group`)
    data: Any = field(default=None, compare=False)
    #: this rank's process group over dp+sp (:func:`replica_group`)
    replica: Any = field(default=None, compare=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        return len(self.ranks) if self.ranks else len(self.devices)

    def label(self, axes: Sequence[str]) -> str:
        """The census label of a collective over ``axes``: those of more
        than one rank joined by ``+`` (``"dp+fsdp"``), the reference's
        convention."""
        return "+".join(a for a in axes if self.shape.get(a, 1) > 1)


def fsdp_sharding(shape: MeshShape, x: Any) -> tuple:
    """The reference's fsdp rule (ZeRO-3-style) as a partition spec: the
    largest dimension of ``x`` (anything with ``.shape``) that the fsdp
    axis of ``shape`` divides is sharded over it (``"fsdp"``), every other
    is None; a scalar, a leaf with no such dimension, or a mesh with no
    fsdp axis keeps it replicated (None everywhere)."""
    dims = tuple(getattr(x, "shape", ()) or ())
    d = fsdp_dim(dims, shape.fsdp)
    return tuple(AXIS_FSDP if i == d else None for i in range(len(dims)))


def fsdp_dim(dims: Sequence[int], n: int) -> Optional[int]:
    """The dimension :func:`fsdp_sharding` shards of a shape ``dims`` over
    an fsdp axis of ``n``, or None."""
    if n <= 1 or not dims:
        return None
    best = max(range(len(dims)),
               key=lambda i: dims[i] if dims[i] % n == 0 else -1)
    return best if dims[best] % n == 0 else None


def tree_shardings(shape: MeshShape, tree: Mapping[str, Any],
                   kind: Union[str, Mapping[str, Any]] = "replicated"
                   ) -> dict[str, tuple]:
    """Per-leaf layout of ``tree`` (path -> anything with ``.shape``) on
    ``shape``, as a partition spec with one entry a dimension (an axis
    name, a tuple of them, or None): ``"replicated"`` (None everywhere),
    ``"fsdp"`` (:func:`fsdp_sharding`), or the model's own specs by path
    (e.g. ``param_partition_specs(cfg)``; a shorter spec is padded with
    None, as a ``PartitionSpec`` is)."""
    def ndim(x):
        return len(tuple(getattr(x, "shape", ()) or ()))

    if isinstance(kind, Mapping):
        missing = [k for k in tree if k not in kind]
        if missing:
            raise ValueError(f"no partition spec for {missing[:3]}")
        out = {}
        for k, x in tree.items():
            spec = tuple(kind[k] or ())
            out[k] = spec + (None,) * (ndim(x) - len(spec))
        return out
    if kind == "replicated":
        return {k: (None,) * ndim(x) for k, x in tree.items()}
    if kind == "fsdp":
        return {k: fsdp_sharding(shape, x) for k, x in tree.items()}
    raise ValueError(f"unknown sharding kind {kind!r}")


def data_coordinate(shape: MeshShape, rank: int) -> int:
    """``rank``'s index over the data axes dp×fsdp (row-major, the batch's
    split): ``rank // (tp·sp·ep)``."""
    return rank // (shape.tp * shape.sp * shape.ep)


def distributed() -> bool:
    """True when this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


#: the thread every process group of this process is built on, made at
#: the first build
_builds: Optional[ThreadPoolExecutor] = None
_builds_lock = threading.Lock()
_build_ident: list[Optional[int]] = [None]


def _mark_build_thread() -> None:
    _build_ident[0] = threading.get_ident()


def submit_build(fn: Callable, *args) -> Future:
    """Queue ``fn(*args)`` on this process's group-build thread, after every
    build submitted before it, with the caller's CUDA device current
    there; returns its future.  Every rank submits the same builds in the
    same order (see the module docstring)."""
    global _builds
    with _builds_lock:
        if _builds is None:
            _builds = ThreadPoolExecutor(1, thread_name_prefix="mesh-build",
                                          initializer=_mark_build_thread)
    dev = (torch.cuda.current_device() if torch.cuda.is_initialized()
           else None)

    def run():
        if dev is not None:
            torch.cuda.set_device(dev)
        return fn(*args)

    return _builds.submit(run)


def _on_build_thread(fn: Callable, *args):
    """``fn(*args)`` on the build thread, waited for (at once when this is
    the build thread)."""
    if threading.get_ident() == _build_ident[0]:
        return fn(*args)
    return submit_build(fn, *args).result()


#: rank_group's cache: (default group, prefix size) -> process group
_groups: dict[tuple[Any, int], Any] = {}


def rank_group(n: int):
    """The process group over ranks ``[0, n)`` of the default group: the
    default group itself at full size, else one ``dist.new_group`` built the
    first time ``n`` is asked for and cached by ``n`` (on a rank outside the
    prefix, torch's non-member sentinel).  ``new_group`` is collective over
    the default group, so every rank asks for a new size at the same point;
    a size seen before costs nothing and creates no group."""
    world = dist.group.WORLD
    if n == dist.get_world_size():
        return world
    if (world, n) not in _groups:
        _on_build_thread(_build_rank_group, world, n)
    return _groups[world, n]


def _build_rank_group(world, n: int) -> None:
    if (world, n) not in _groups:  # a build queued earlier made it
        _groups[world, n] = dist.new_group(list(range(n)))


def axis_ranks(shape: MeshShape, axis: str, rank: int) -> tuple[int, ...]:
    """The ranks of ``shape``'s mesh (row-major over :data:`AXES`) that
    differ from ``rank`` in the ``axis`` coordinate alone, in order."""
    sizes = list(shape.axis_sizes().values())
    i = AXES.index(axis)
    stride = 1
    for s in sizes[i + 1:]:
        stride *= s
    base = rank - (rank // stride) % sizes[i] * stride
    return tuple(base + j * stride for j in range(sizes[i]))


#: axis_groups' cache: (default group, shape key) -> {axis: group}
_axis_groups: dict[tuple[Any, tuple], dict[str, Any]] = {}


def axis_groups(shape: MeshShape) -> dict[str, Any]:
    """This rank's process group along each axis of ``shape`` that has
    more than one rank, over the rank prefix of ``shape.size``: the
    prefix's own group when the axis spans it (:func:`rank_group`), else
    one ``dist.new_group`` per line of the axis.  ``new_group`` is
    collective over the default group, so every rank builds every line, in
    the same order, the first time ``shape`` is asked for; a rank outside
    a line (or the prefix) keeps no group for it.  Cached by shape."""
    key = (dist.group.WORLD, shape.key())
    if key not in _axis_groups:
        _on_build_thread(_build_axis_groups, key, shape)
    return _axis_groups[key]


def _build_axis_groups(key: tuple, shape: MeshShape) -> None:
    if key not in _axis_groups:
        rank, groups = dist.get_rank(), {}
        for axis, n in shape.axis_sizes().items():
            if n == 1:
                continue
            if n == shape.size:
                group = rank_group(n)
                if rank < n:
                    groups[axis] = group
                continue
            lines = sorted({axis_ranks(shape, axis, r)
                            for r in range(shape.size)})
            for line in lines:
                group = dist.new_group(list(line))
                if rank in line:
                    groups[axis] = group
        _axis_groups[key] = groups


#: span_group's cache: (default group, shape key, axes) -> group or None
_span_groups: dict[tuple[Any, tuple, tuple], Any] = {}

#: the axes a batch is reduced over: its split (dp×fsdp) and, on a mesh with
#: sp > 1, the sequence's split
DATA_AXES = (AXIS_DP, AXIS_FSDP, AXIS_SP)


def span_group(shape: MeshShape, axes: Sequence[str]):
    """This rank's process group over ``axes`` together (the ranks of
    ``shape``'s mesh that differ from it in those coordinates alone, one
    group a line): the prefix's own group when the axes span it, None when
    they have one rank or this rank is outside the prefix.  Built like
    :func:`axis_groups`: collectively, every line in order, once per
    (shape, axes)."""
    axes = tuple(a for a in AXES if a in axes)
    key = (dist.group.WORLD, shape.key(), axes)
    if key not in _span_groups:
        _on_build_thread(_build_span_group, key, shape, axes)
    return _span_groups[key]


def _build_span_group(key: tuple, shape: MeshShape, axes: tuple) -> None:
    if key in _span_groups:
        return
    rank, width = dist.get_rank(), 1
    for a in axes:
        width *= getattr(shape, a)
    group = None
    if width == shape.size:
        group = rank_group(width) if width > 1 else None
    elif width > 1:
        lines = sorted({_span_ranks(shape, axes, r)
                        for r in range(shape.size)})
        for line in lines:
            g = dist.new_group(list(line))
            if rank in line:
                group = g
    _span_groups[key] = group if rank < shape.size else None


def _span_ranks(shape: MeshShape, axes: tuple, rank: int) -> tuple:
    """The ranks that differ from ``rank`` in the coordinates of ``axes``
    alone, in order."""
    line = [rank]
    for a in axes:
        line = [r for base in line for r in axis_ranks(shape, a, base)]
    return tuple(sorted(line))


def data_group(shape: MeshShape):
    """This rank's process group over the data axes (:data:`DATA_AXES`,
    dp+fsdp+sp: one group a tp line), which every gradient and loss is
    averaged over; :func:`span_group` of them."""
    return span_group(shape, DATA_AXES)


def replica_group(shape: MeshShape):
    """This rank's process group over dp+sp: the ranks holding the same
    block of a leaf split over fsdp, over which that block's gradient is
    summed after the fsdp reduce-scatter.  The dp axis' own group when sp
    has one rank, the sp axis' when dp has one, else :func:`span_group`."""
    if shape.sp == 1 or shape.dp == 1:
        axis = AXIS_DP if shape.sp == 1 else AXIS_SP
        return axis_groups(shape).get(axis)
    return span_group(shape, (AXIS_DP, AXIS_SP))


def local_device() -> torch.device:
    """This rank's CUDA device: ``cuda:(rank mod device count)``; raises
    when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices=")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None,
              spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Without a process group, a mesh over the first ``n_devices`` of
    ``devices`` (default: every CUDA device; raises when there is none).

    Under a process group, a mesh over the first ``n_devices`` ranks
    (default: all of them) with their process group; ``devices`` names this
    process's device (default :func:`local_device`).  Every rank makes the
    same meshes in the same order (see :func:`rank_group`)."""
    if distributed():
        world = dist.get_world_size()
        n = world if n_devices is None else n_devices
        if not 1 <= n <= world:
            raise ValueError(f"want {n} ranks, the process group has "
                             f"{world}")
        sizes = (spec or MeshSpec(dp=-1)).resolve(n)
        dev = torch.device(devices[0]) if devices else local_device()
        group = rank_group(n)
        shape = MeshShape(**sizes)
        return Mesh((dev,), tuple(sizes), tuple(sizes.values()),
                    ranks=tuple(range(n)), group=group,
                    groups=axis_groups(shape), data=data_group(shape),
                    replica=replica_group(shape))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"want {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    sizes = (spec or MeshSpec(dp=-1)).resolve(len(devs))
    return Mesh(tuple(devs), tuple(sizes), tuple(sizes.values()))
