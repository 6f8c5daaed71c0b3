"""Entry points of the port: the forward pass on the flagship model, and the
main path's trainer.

``entry(device)`` returns ``(fn, example_args)`` with ``fn(*example_args)``
the FLAGSHIP forward on tokens ``[2, 256]`` — the twin of the JAX package's
``__graft_entry__.entry``.  ``flagship_trainer(device)`` returns the
``ElasticTrainer`` and batch that ``chip_smoke.py`` and
``edl_tpu_torch.profile_step`` drive.  Both run on the CUDA device unless
``device`` says otherwise, with the flash kernels on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from edl_tpu_torch.device import resolve
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer


def entry(device="cuda"):
    """(fn, example_args): fn(model, tokens) → logits [2, 256, vocab]."""
    dev = resolve(device)
    cfg = dataclasses.replace(tfm.FLAGSHIP, use_flash=True)
    model = tfm.Transformer(cfg, device=dev, seed=0)
    tokens = torch.zeros((2, 256), dtype=torch.int64, device=dev)
    return tfm.apply, (model, tokens)


def flagship_trainer(batch: int = 16, seq: int = 1024, device="cuda",
                     cfg: tfm.TransformerConfig = tfm.FLAGSHIP):
    """(trainer, (tokens, targets)): ``ElasticTrainer`` on ``cfg`` (FLAGSHIP)
    with the flash kernels and adamw(3e-4), random weights from seed 0, and
    ``batch`` x ``seq`` tokens from seed 1 with the targets shifted by one —
    bench.py's accelerator setting, on one device."""
    dev = resolve(device)
    cfg = dataclasses.replace(cfg, use_flash=True)
    model = tfm.Transformer(cfg, device=dev, seed=0)
    trainer = ElasticTrainer(tfm.loss_fn, model, optim.adamw(3e-4),
                             devices=[dev])
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq), dtype=np.int64)
    data = (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev))
    return trainer, data
