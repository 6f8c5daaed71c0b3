"""Entry points of the port: the forward pass on the flagship model, and the
trainers of the paths that ``chip_smoke.py`` drives, and the decode fleet.

``entry(device)`` returns ``(fn, example_args)`` with ``fn(*example_args)``
the FLAGSHIP forward on tokens ``[2, 256]`` — the twin of the JAX package's
``__graft_entry__.entry``.  ``flagship_trainer(device)`` returns the
``ElasticTrainer`` and batch that ``chip_smoke.py`` and
``edl_tpu_torch.profile_step`` drive, and ``flagship_elastic_world`` the
same for one rank of a multi-rank job; ``resnet_trainer`` and
``bert_trainer`` do the same for bench.py's model-zoo leg (ResNet-50 at
256 x 224², BERT-base MLM at 32 x 512).  ``flagship_decode_fleet(device)``
returns the ``DecodeFleet`` that serves FLAGSHIP token by token.  All run on
the CUDA device unless ``device`` says otherwise, with the kernels on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.device import resolve
from edl_tpu_torch.models import bert
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.serving import DecodeFleet


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
    return trainer, _flagship_data(cfg, batch, seq, dev)


def _flagship_data(cfg: tfm.TransformerConfig, batch: int, seq: int,
                   dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq), dtype=np.int64)
    return (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev))


def flagship_elastic_world(rank: int, world: int, store_path,
                           device="cuda", batch: int = 16, seq: int = 1024,
                           backend: Optional[str] = None,
                           cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                           initial_world_size: Optional[int] = None):
    """(trainer, (tokens, targets)) for rank ``rank`` of a ``world``-rank
    job: :func:`flagship_trainer`'s model, optimizer and global batch on
    this rank's device, its ``ElasticTrainer`` over the job's process group.

    Joins the default process group through a ``FileStore`` at
    ``store_path``.  On the card, ``device="cuda"`` gives rank r its own
    card ``cuda:r`` while there are cards enough, and the ranks NCCL;
    otherwise (more ranks than cards, or a device with an index) the ranks
    share a card and talk gloo, as they do on the CPU.  ``backend``
    overrides the choice.  Every rank calls this with the same arguments
    but its rank; the first world is the whole group unless
    ``initial_world_size`` says fewer."""
    dev = resolve(device)
    shared = True
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:
            shared = world > cards
            dev = torch.device("cuda", 0 if shared else rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("gloo" if shared else "nccl"),
                            store=dist.FileStore(str(store_path), world),
                            rank=rank, world_size=world)
    cfg = dataclasses.replace(cfg, use_flash=True)
    model = tfm.Transformer(cfg, device=dev, seed=0)
    trainer = ElasticTrainer(tfm.loss_fn, model, optim.adamw(3e-4),
                             devices=[dev],
                             initial_world_size=initial_world_size)
    return trainer, _flagship_data(cfg, batch, seq, dev)


def resnet_trainer(batch: int = 256, hw: int = 224, device="cuda",
                   cfg: resnet.ResNetConfig = resnet.RESNET50):
    """(trainer, (images, labels)): ``ElasticTrainer`` on ``cfg`` (RESNET50)
    with adamw(3e-4), random weights from seed 0, ``batch`` standard-normal
    ``hw`` x ``hw`` NHWC images in ``cfg.dtype`` and uniform labels, both
    made on the device from seed 1 — bench.py's model-zoo setting."""
    dev = resolve(device)
    model = resnet.ResNet(cfg, device=dev, seed=0)
    trainer = ElasticTrainer(resnet.loss_fn, model, optim.adamw(3e-4),
                             devices=[dev])
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(batch, hw, hw, 3, generator=gen, device=dev
                         ).to(cfg.dtype)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=dev)
    return trainer, (images, labels)


def bert_trainer(batch: int = 32, seq: int = 512, device="cuda",
                 cfg: bert.BertConfig = bert.BERT_BASE):
    """(trainer, (tokens, targets, mask)): ``ElasticTrainer`` on ``cfg``
    (BERT_BASE) with the flash kernels and adamw(3e-4), random weights from
    seed 0, and bench.py's MLM recipe from seed 1: uniform tokens and
    targets, and a 0/1 mask on ~15 % of the positions."""
    dev = resolve(device)
    model = bert.Bert(cfg, device=dev, seed=0)
    trainer = ElasticTrainer(bert.mlm_loss_fn, model, optim.adamw(3e-4),
                             devices=[dev])
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    targets = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    mask = (rng.random((batch, seq)) < 0.15).astype(np.float32)
    return trainer, tuple(torch.from_numpy(a).to(dev)
                          for a in (tokens, targets, mask))


#: the decode fleet's defaults at FLAGSHIP: 8 slots, 64-token prefill
#: chunks, 16-token blocks, 64 blocks a session (FLAGSHIP's max_seq_len of
#: 1 024 tokens), and blocks for every slot of two replicas at full context
DECODE_DEFAULTS = dict(slots=8, prefill_chunk=64, kv_block_size=16,
                       max_blocks_per_session=64, kv_blocks=2 * 8 * 64)


def flagship_decode_fleet(device="cuda",
                          cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                          **kw) -> DecodeFleet:
    """A ``DecodeFleet`` serving ``cfg`` (FLAGSHIP, bf16) with random
    weights from seed 0 on ``device``; ``kw`` overrides
    :data:`DECODE_DEFAULTS` and passes any other fleet argument (``roles``,
    ``spec_tokens``, ``job``, ...)."""
    dev = resolve(device)
    model = tfm.Transformer(cfg, device=dev, seed=0)
    return DecodeFleet(model, cfg, device=dev, **{**DECODE_DEFAULTS, **kw})
