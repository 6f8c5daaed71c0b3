"""optax's ``adam``, ``adamw`` and ``identity`` as factories over torch's
optimizers, with optax's defaults written out (torch's AdamW defaults to a
weight decay of 1e-2, optax's to 1e-4).

A factory maps an iterable of parameters to a ``torch.optim.Optimizer``,
which is the role an optax GradientTransformation plays for the JAX
trainer: chosen once, bound to the parameters by the trainer.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            torch.optim.Optimizer]


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
    def make(params):
        return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                                eps=eps, weight_decay=0.0)
    return make


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerFactory:
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make


class _Identity(torch.optim.Optimizer):
    """optax's ``identity``: an optimizer that holds no state and whose
    step changes nothing."""

    def __init__(self, params) -> None:
        super().__init__(params, {})

    def step(self, closure=None):
        return None


def identity() -> OptimizerFactory:
    """The factory of an optimizer that never moves a parameter and keeps
    no state (a forward-only trainer's: a resize moves the params only)."""
    return _Identity
