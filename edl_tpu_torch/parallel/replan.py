"""Reparallelization planning: minimal-transfer reshard plans between mesh
shapes — the port of edl_tpu.parallel.replan.

Given each leaf's old and new :class:`Placement` (for every rank, the
block of the leaf it holds), :func:`plan_reshard` prices a move per leaf:

* ``bytes_stay``  — bytes already held by the rank that needs them,
* ``bytes_ici``   — bytes that must move, with a source on a rank that
  stays in the world (a rank-to-rank hop),
* ``bytes_dcn``   — bytes whose only sources are ranks leaving the world,
* ``bytes_naive`` — the gather-then-scatter bound a checkpoint round-trip
  would pay.

The names are the reference's, so the records compare one to one; the port
has no topology to look up, so the split is by who holds a byte, not by
fabric.  Overlap volumes are products of per-dimension interval
intersections, and the blocks of a placement partition the leaf, so the
coverage sums never double-count: the numbers equal the reference's byte for
byte on the same shapes and layouts (ranks standing for jax device ids).

:func:`candidate_shapes`, :func:`choose_shape` and :func:`propose_shape`
pick the axis split of a resize by the same arithmetic.
:func:`total_collective_counts` flattens a per-axis collective census, the
trainer's :func:`~edl_tpu_torch.runtime.elastic.collective_census` (the
port's ``collective_stats``: torch has no HLO to count, so the trainer
counts at its four collective choke points).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Union

from edl_tpu_torch.parallel.mesh import AXES, MeshShape, fsdp_dim

# -- placements ---------------------------------------------------------------

#: one block of a leaf: ((start, stop), ...) per dimension
Block = tuple


@dataclass(frozen=True)
class Placement:
    """Where one leaf lives: ``blocks[rank]`` is the index block it holds."""

    blocks: Mapping[int, Block]

    @classmethod
    def replicated(cls, shape: Sequence[int], n: int) -> "Placement":
        """The whole leaf on each of ranks ``[0, n)``."""
        full = tuple((0, d) for d in shape)
        return cls({r: full for r in range(n)})

    @classmethod
    def of_spec(cls, shape: Sequence[int], spec: Optional[Sequence],
                mesh: MeshShape) -> "Placement":
        """The leaf laid out by a partition spec: for each dimension an
        axis name, a tuple of axis names or None; a spec shorter than the
        leaf (or None) leaves the other dimensions whole, as a
        ``PartitionSpec`` does.  A dimension is split in equal blocks over
        the axes it names, the first of a tuple major, and replicated over
        the axes no dimension names; ranks are row-major over
        :data:`~edl_tpu_torch.parallel.mesh.AXES`, as a mesh's devices are,
        so the blocks are those ``NamedSharding(mesh, P(*spec))`` gives
        the devices (rank r standing for device r)."""
        shape = tuple(shape)
        spec = tuple(spec or ())
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than {shape} "
                             "has dimensions")
        sizes = mesh.axis_sizes()
        per_dim, seen = [], set()
        for d, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
            axes = (() if entry is None else
                    (entry,) if isinstance(entry, str) else tuple(entry))
            for a in axes:
                if a not in sizes or a in seen:
                    raise ValueError(f"spec {spec}: axis {a!r} is unknown or "
                                     "named twice")
                seen.add(a)
            parts = math.prod(sizes[a] for a in axes)
            if d % parts:
                raise ValueError(f"spec {spec}: a dimension of {d} of "
                                 f"{shape} does not split in {parts}")
            per_dim.append((axes, d // parts))
        strides, stride = {}, 1
        for a in reversed(AXES):
            strides[a] = stride
            stride *= sizes[a]
        blocks = {}
        for r in range(mesh.size):
            block = []
            for axes, step in per_dim:
                j = 0
                for a in axes:
                    j = j * sizes[a] + (r // strides[a]) % sizes[a]
                block.append((j * step, (j + 1) * step))
            blocks[r] = tuple(block)
        return cls(blocks)

    @classmethod
    def sharded(cls, shape: Sequence[int], dim: int,
                mesh: MeshShape) -> "Placement":
        """Dimension ``dim`` split in equal blocks over the fsdp axis of
        ``mesh``, replicated over its other axes: :meth:`of_spec` with
        ``"fsdp"`` at ``dim``."""
        return cls.of_spec(shape, tuple("fsdp" if i == dim else None
                                        for i in range(len(shape))), mesh)


def fsdp_placement(shape: Sequence[int], mesh: MeshShape) -> Placement:
    """The reference's fsdp rule (:func:`~edl_tpu_torch.parallel.mesh.
    fsdp_sharding`) as a placement: the largest dimension the fsdp axis
    divides is sharded over it; a scalar, or a leaf with no such
    dimension, is replicated."""
    dim = fsdp_dim(shape, mesh.fsdp)
    if dim is None:
        return Placement.replicated(shape, mesh.size)
    return Placement.sharded(shape, dim, mesh)


def tree_placements(tree: Mapping[str, Any], mesh: MeshShape,
                    kind: Union[str, Mapping[str, Any]] = "replicated"
                    ) -> dict[str, Placement]:
    """Per-leaf placements of ``tree`` (path -> anything with ``.shape``)
    on ``mesh``: ``"replicated"``, ``"fsdp"``, or a partition spec per
    path (:meth:`Placement.of_spec`)."""
    if isinstance(kind, Mapping):
        return {k: Placement.of_spec(_shape(x), kind[k], mesh)
                for k, x in tree.items()}
    if kind == "replicated":
        return {k: Placement.replicated(_shape(x), mesh.size)
                for k, x in tree.items()}
    if kind == "fsdp":
        return {k: fsdp_placement(_shape(x), mesh) for k, x in tree.items()}
    raise ValueError(f"unknown sharding kind {kind!r}")


def _shape(leaf: Any) -> tuple:
    return tuple(getattr(leaf, "shape", ()) or ())


def _itemsize(leaf: Any) -> int:
    """Bytes an element: torch and numpy dtypes both carry ``itemsize``;
    anything without a dtype counts as fp32, as in the reference."""
    dtype = getattr(leaf, "dtype", None)
    return int(getattr(dtype, "itemsize", 4)) if dtype is not None else 4


# -- block arithmetic ---------------------------------------------------------


def _vol(block: Block) -> int:
    v = 1
    for a, b in block:
        v *= max(b - a, 0)
    return v


def _overlap(b1: Optional[Block], b2: Optional[Block]) -> int:
    if b1 is None or b2 is None:
        return 0
    v = 1
    for (a1, s1), (a2, s2) in zip(b1, b2):
        v *= max(min(s1, s2) - max(a1, a2), 0)
        if v == 0:
            return 0
    return v


# -- the plan -----------------------------------------------------------------


@dataclass
class LeafPlan:
    """Transfer accounting for ONE leaf."""

    path: str
    nbytes: int
    bytes_stay: int
    bytes_ici: int
    bytes_dcn: int
    bytes_naive: int

    @property
    def bytes_moved(self) -> int:
        return self.bytes_ici + self.bytes_dcn


@dataclass
class ReshardPlan:
    """The full-tree transfer plan for one (old layout) → (new layout)."""

    old_shape: Optional[MeshShape]
    new_shape: Optional[MeshShape]
    leaves: list[LeafPlan] = field(default_factory=list)
    #: resident bytes per NEW-world rank after the reshard — what the
    #: memory-constrained shape chooser filters on
    per_device_bytes: dict[int, int] = field(default_factory=dict)
    #: plan computation wall time, stamped by the caller
    replan_ms: float = 0.0

    def _sum(self, attr: str) -> int:
        return sum(getattr(leaf, attr) for leaf in self.leaves)

    @property
    def bytes_total(self) -> int:
        return self._sum("nbytes")

    @property
    def bytes_stay(self) -> int:
        return self._sum("bytes_stay")

    @property
    def bytes_ici(self) -> int:
        return self._sum("bytes_ici")

    @property
    def bytes_dcn(self) -> int:
        return self._sum("bytes_dcn")

    @property
    def bytes_moved(self) -> int:
        return self.bytes_ici + self.bytes_dcn

    @property
    def bytes_naive(self) -> int:
        return self._sum("bytes_naive")

    @property
    def max_device_bytes(self) -> int:
        return max(self.per_device_bytes.values(), default=0)

    def summary(self) -> dict:
        """The per-resize record."""
        return {
            "old_shape": self.old_shape.describe() if self.old_shape else None,
            "new_shape": self.new_shape.describe() if self.new_shape else None,
            "bytes_total": self.bytes_total,
            "bytes_stay": self.bytes_stay,
            "bytes_moved": self.bytes_moved,
            "bytes_ici": self.bytes_ici,
            "bytes_dcn": self.bytes_dcn,
            "bytes_naive": self.bytes_naive,
            "max_device_bytes": self.max_device_bytes,
            "replan_ms": self.replan_ms,
        }


def _leaf_plan(path: str, leaf: Any, old: Placement, new: Placement,
               new_ranks: set) -> tuple[LeafPlan, dict[int, int]]:
    shape = _shape(leaf)
    itemsize = _itemsize(leaf)
    nbytes = itemsize * math.prod(shape) if shape else itemsize

    # distinct blocks of the OLD placement held by ranks that stay in the
    # world: any needed byte inside one of these moves rank to rank; bytes
    # outside are only on departing ranks
    held_cells = {old.blocks[r] for r in old.blocks if r in new_ranks}

    stay = ici = dcn = 0
    scatter = 0
    per_dev: dict[int, int] = {}
    for rank, need in new.blocks.items():
        need_elems = _vol(need)
        need_b = need_elems * itemsize
        per_dev[rank] = need_b
        scatter += need_b
        own = _overlap(need, old.blocks.get(rank))
        # old blocks partition the leaf, so summing per-block overlaps
        # inside `need` is exact coverage, never double-counted
        covered = sum(_overlap(need, cell) for cell in held_cells)
        stay += own * itemsize
        ici += (covered - own) * itemsize
        dcn += (need_elems - covered) * itemsize
    # the shape-blind bound: gather one full copy, then send every new
    # rank its block (what a checkpoint round-trip costs, ignoring disk)
    naive = nbytes + scatter
    return (LeafPlan(path=path, nbytes=nbytes, bytes_stay=stay,
                     bytes_ici=ici, bytes_dcn=dcn, bytes_naive=naive),
            per_dev)


def plan_reshard(tree: Mapping[str, Any], old: Mapping[str, Placement],
                 new: Mapping[str, Placement],
                 old_shape: Optional[MeshShape] = None,
                 new_shape: Optional[MeshShape] = None) -> ReshardPlan:
    """The transfer plan for moving ``tree`` (path -> tensor, array or
    anything with ``shape`` and ``dtype``; only those are read) from the
    ``old`` placements to the ``new`` ones (both keyed by the same
    paths)."""
    plan = ReshardPlan(old_shape=old_shape, new_shape=new_shape)
    if not new:
        return plan
    new_ranks = set().union(*(p.blocks for p in new.values()))
    for path, leaf in tree.items():
        lp, per_dev = _leaf_plan(path, leaf, old[path], new[path], new_ranks)
        plan.leaves.append(lp)
        for r, b in per_dev.items():
            plan.per_device_bytes[r] = plan.per_device_bytes.get(r, 0) + b
    return plan


# -- shape choice -------------------------------------------------------------


def candidate_shapes(n_devices: int,
                     base: Optional[MeshShape] = None) -> list[MeshShape]:
    """All dp×fsdp factorizations of ``n_devices`` (the axes a resize
    re-splits live), inheriting the base shape's tp/sp/ep when they divide
    the new world and resetting them to 1 otherwise."""
    base = base or MeshShape()
    fixed = base.tp * base.sp * base.ep
    if fixed > 1 and n_devices % fixed == 0:
        rem, tp, sp, ep = n_devices // fixed, base.tp, base.sp, base.ep
    else:
        rem, tp, sp, ep = n_devices, 1, 1, 1
    out = []
    for dp in range(1, rem + 1):
        if rem % dp == 0:
            out.append(MeshShape(dp=dp, fsdp=rem // dp, tp=tp, sp=sp, ep=ep))
    return out


def choose_shape(
    tree: Mapping[str, Any],
    old: Mapping[str, Placement],
    n_devices: int,
    sharding_kind: str = "fsdp",
    candidates: Optional[Sequence[MeshShape]] = None,
    max_bytes_per_device: Optional[int] = None,
    base: Optional[MeshShape] = None,
    reserved_bytes_per_device: int = 0,
    calibration=None,
) -> tuple[MeshShape, ReshardPlan]:
    """The minimal-transfer axis split for an unconstrained resize to
    ``n_devices`` ranks.

    Plans every candidate (dp×fsdp factorizations by default) against the
    live placements and returns the cheapest.  Candidates whose resident
    bytes (plus ``reserved_bytes_per_device``) would overflow
    ``max_bytes_per_device`` are dropped first — the dp→fsdp escape hatch;
    when every one overflows, the least-overflowing wins.  Ties prefer the
    dp-dominant split.  ``calibration`` (an object with ``factor(name)``,
    or a callable) ranks by predicted reshard seconds instead of bytes:
    each plan's bytes over the nominal rates, scaled by the measured
    ``reshard_seconds`` factor."""
    est_seconds = None
    if calibration is not None:
        from edl_tpu_torch.observability.calib import nominal_transfer_seconds

        try:
            f = float(calibration.factor("reshard_seconds")
                      if hasattr(calibration, "factor")
                      else calibration("reshard_seconds"))
        except Exception:
            f = 1.0
        if not f > 0.0:
            f = 1.0
        est_seconds = lambda p: nominal_transfer_seconds(  # noqa: E731
            p.bytes_ici, p.bytes_dcn) * f
    cands = list(candidates) if candidates is not None else candidate_shapes(
        n_devices, base=base)
    scored: list[tuple[tuple, MeshShape, ReshardPlan]] = []
    overflow: list[tuple[tuple, MeshShape, ReshardPlan]] = []
    for shape in cands:
        plan = plan_reshard(tree, old,
                            tree_placements(tree, shape, sharding_kind),
                            old_shape=None, new_shape=shape)
        if est_seconds is not None:
            rank = (est_seconds(plan), plan.bytes_moved, -shape.dp,
                    shape.key())
        else:
            rank = (plan.bytes_moved, -shape.dp, shape.key())
        if (max_bytes_per_device is not None
                and plan.max_device_bytes + reserved_bytes_per_device
                > max_bytes_per_device):
            overflow.append((rank, shape, plan))
            continue
        scored.append((rank, shape, plan))
    if not scored:
        if not overflow:
            raise ValueError(f"no candidate shapes for {n_devices} devices")
        overflow.sort(key=lambda t: (t[2].max_device_bytes, t[0]))
        _, shape, plan = overflow[0]
        return shape, plan
    scored.sort(key=lambda t: t[0])
    _, shape, plan = scored[0]
    return shape, plan


def propose_shape(n_devices: int, state_bytes: int,
                  max_bytes_per_device: Optional[int] = None,
                  base: Optional[MeshShape] = None,
                  reserved_bytes_per_device: int = 0) -> MeshShape:
    """Control-plane shape proposal, no placements needed: pure dp unless
    replicating ``state_bytes`` on each rank would overflow the budget, in
    which case the smallest sufficient factor moves into fsdp."""
    base = base or MeshShape()
    fixed = base.tp * base.sp * base.ep
    if fixed > 1 and n_devices % fixed == 0:
        rem = n_devices // fixed
        tp, sp, ep = base.tp, base.sp, base.ep
    else:
        rem, tp, sp, ep = n_devices, 1, 1, 1
    for fsdp in sorted(d for d in range(1, rem + 1) if rem % d == 0):
        # ceil, not floor: a rank really holds ceil(bytes/fsdp) — floor
        # would bless an over-budget layout right at the boundary
        if (max_bytes_per_device is None
                or -(-state_bytes // fsdp) + reserved_bytes_per_device
                <= max_bytes_per_device):
            return MeshShape(dp=rem // fsdp, fsdp=fsdp, tp=tp, sp=sp, ep=ep)
    return MeshShape(dp=1, fsdp=rem, tp=tp, sp=sp, ep=ep)


def total_collective_counts(stats: dict) -> dict[str, int]:
    """Flatten a per-axis collective census, ``{axis label: {"ops": {op:
    count}, "bytes": n}}`` (the trainer's
    :func:`~edl_tpu_torch.runtime.elastic.collective_census`, the port's
    ``collective_stats``), to ``{op: count}`` totals."""
    out: dict[str, int] = {}
    for slot in stats.values():
        for op, n in slot["ops"].items():
            out[op] = out.get(op, 0) + n
    return out
