"""The elastic trainer — the port of edl_tpu.runtime.elastic for a world of
one device.

``ElasticTrainer`` owns the model (an ``nn.Module`` standing in for the JAX
params tree), the optimizer bound to it, and the mesh it trains on.  A step
runs eagerly: loss, backward (through the flash kernels on the card), one
optimizer update.  Resizes keep the JAX trainer's transactional contract: a
target that cannot be staged — beyond the devices, or a multi-device world,
which this slice does not build yet — rolls back, leaves training on the
current world, returns False and bumps ``resizes_failed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn as nn

from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.parallel.mesh import Mesh, MeshShape, MeshSpec, make_mesh
from edl_tpu_torch.runtime.optim import OptimizerFactory

log = get_logger("runtime.elastic")


@dataclass
class TrainState:
    params: nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0


class ElasticTrainer:
    """Single-controller elastic trainer over one device.

    ``loss_fn(params, batch) -> scalar tensor`` defines the model;
    ``optimizer`` is a factory from :mod:`edl_tpu_torch.runtime.optim`.
    ``devices`` defaults to every CUDA device (raises when there is none);
    the first world is one device, the first of them, unless
    ``initial_world_size`` asks for more, which fails until the
    multi-device trainer exists.
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
        accum_mode: str = "replicated",
    ) -> None:
        if param_sharding != "replicated":
            raise ValueError(f"param_sharding {param_sharding!r}: one device "
                             "holds every parameter ('replicated')")
        if accum_mode != "replicated":
            raise ValueError(f"accum_mode {accum_mode!r}: this trainer "
                             "accumulates one micro-batch at a time "
                             "('replicated')")
        self.loss_fn = loss_fn
        self.spec = spec
        self.accum_mode = accum_mode
        self._devices = list(make_mesh(devices=devices).devices)
        self.resizes = 0
        self.resizes_failed = 0
        self.mesh: Mesh = self._stage(self._resolve_target(
            initial_world_size or 1))
        params.to(self.device)
        self.state = TrainState(params=params,
                                opt_state=optimizer(params.parameters()))

    # -- public API --------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    @property
    def world_size(self) -> int:
        return self.mesh.size

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
        """Move to ``target`` (an int world size or a MeshShape).  Returns
        True when the live mesh has that layout afterwards; on any failure
        the current world stays live, ``resizes_failed`` grows and the
        answer is False."""
        try:
            shape = self._resolve_target(target)
            if shape == self.shape:
                return True
            mesh = self._stage(shape)
        except Exception as exc:  # a failed resize never stops training
            self.resizes_failed += 1
            log.warn("mesh resize failed; rolled back",
                     want=repr(target)[:60], keep_size=self.world_size,
                     step=self.state.step, error=str(exc)[:200])
            get_tracer().instant("resize_rolled_back", category="chaos",
                                 want=repr(target)[:60],
                                 keep_size=self.world_size,
                                 error=str(exc)[:120])
            get_counters().inc("resizes_failed")
            return False
        self.mesh = mesh
        self.resizes += 1
        return True

    def _to_device(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(x) for x in batch)
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def step(self, batch) -> float:
        """One training step on the current mesh; returns the scalar loss."""
        batch = self._to_device(batch)
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.state.params, batch)
        loss.backward()
        opt.step()
        self.state.step += 1
        return float(loss.detach())

    def eval_loss(self, batch) -> float:
        with torch.no_grad():
            return float(self.loss_fn(self.state.params,
                                      self._to_device(batch)))

    def step_accumulate(self, micro_batches: Sequence) -> float:
        """One constant-effective-batch step: the gradients of the
        micro-batches, taken one at a time in order, are summed, scaled by
        1 / V and applied as a single optimizer update.  Returns the mean
        of the micro losses (the full-batch loss for mean-reduction
        losses)."""
        V = len(micro_batches)
        if V == 0:
            raise ValueError("step_accumulate needs at least 1 micro-batch")
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        lsum = 0.0
        for mb in micro_batches:
            loss = self.loss_fn(self.state.params, self._to_device(mb))
            loss.backward()  # .grad accumulates the sum
            lsum += float(loss.detach())
        with torch.no_grad():
            for p in self.state.params.parameters():
                if p.grad is not None:
                    p.grad.mul_(1.0 / V)
        opt.step()
        self.state.step += 1
        return lsum / V

    # -- internals ---------------------------------------------------------

    def _stage(self, shape: MeshShape) -> Mesh:
        """The mesh for ``shape``, or an exception when it cannot be built."""
        mesh = make_mesh(shape.size, shape.to_spec(), devices=self._devices)
        if mesh.size > 1:
            raise NotImplementedError(
                f"a {shape.describe()} world needs the multi-device trainer, "
                "which this port does not have yet")
        return mesh
