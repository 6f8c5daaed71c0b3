"""MLP classifier — the port of edl_tpu.models.mlp, the model of the
reference's virtual-worker and checkpoint scenarios.

The parameters keep the JAX tree's names (``w{i}``, ``b{i}``) and its
``[in, out]`` orientation (``x @ w``), so weights carry across unchanged
(:func:`edl_tpu_torch.interop.params_from_numpy`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from edl_tpu_torch.device import resolve


class MLP(nn.Module):
    """Params for an MLP with layer ``sizes`` (e.g. [784, 256, 10]):
    ``w{i}`` standard normal · sqrt(2 / fan_in) from a ``torch.Generator``
    seeded with ``seed`` on ``device``, ``b{i}`` zeros; ``forward`` is
    :func:`apply`."""

    def __init__(self, sizes: Sequence[int], device="cuda",
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.sizes = tuple(sizes)
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(
                torch.randn(fan_in, fan_out, generator=gen, device=dev)
                * (2.0 / fan_in) ** 0.5))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros(fan_out, device=dev)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)


def apply(model: MLP, x: torch.Tensor) -> torch.Tensor:
    n_layers = len(model.sizes) - 1
    for i in range(n_layers):
        x = x @ getattr(model, f"w{i}") + getattr(model, f"b{i}")
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def loss_fn(model: MLP, batch: tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch."""
    x, y = batch
    logp = F.log_softmax(apply(model, x), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def accuracy(model: MLP, batch: tuple[torch.Tensor, torch.Tensor]
             ) -> torch.Tensor:
    x, y = batch
    return (apply(model, x).argmax(-1) == y).float().mean()
