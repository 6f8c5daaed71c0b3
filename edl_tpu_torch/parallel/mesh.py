"""Mesh shapes and meshes over a prefix of the job's devices — the port of
edl_tpu.parallel.mesh.

:class:`MeshSpec` is the elastic policy ("dp absorbs the rest"),
:class:`MeshShape` one concrete layout, and :class:`Mesh` the devices laid
out in that shape.  Axis conventions: ``dp`` data parallel, ``fsdp`` fully
sharded data parallel, ``tp`` tensor parallel, ``sp`` sequence parallel,
``ep`` expert parallel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

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
    """Devices laid out row-major over the axes in declaration order."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    axis_shape: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device; raises when there is none)."""
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
