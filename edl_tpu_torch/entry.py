"""Entry points of the port: the forward pass on the flagship model, and the
trainers of the paths that ``chip_smoke.py`` drives, and the decode fleet.

``entry(device)`` returns ``(fn, example_args)`` with ``fn(*example_args)``
the FLAGSHIP forward on tokens ``[2, 256]`` — the twin of the JAX package's
``__graft_entry__.entry``.  ``flagship_trainer(device)`` returns the
``ElasticTrainer`` and batch that ``chip_smoke.py`` and
``edl_tpu_torch.profile_step`` drive, ``flagship_elastic_world`` the
same for one rank of a multi-rank job (``flagship_tp_world`` laid out by
the model's partition specs over tp), and ``flagship_virtual_world`` that
rank's trainer (replicated, fsdp or tp) with the virtual-worker job's
data; ``resnet_trainer`` and ``bert_trainer`` do the same for bench.py's
model-zoo leg (ResNet-50 at 256 x 224², BERT-base MLM at 32 x 512).
``flagship_decode_fleet(device)`` returns the ``DecodeFleet`` that serves
FLAGSHIP token by token, from seed-0 weights or the ones it is given.  All
run on the CUDA device unless ``device`` says otherwise, with the kernels
on.

``dryrun_multichip(n, device)`` is the twin of
``__graft_entry__.dryrun_multichip``: one sharded train step of TINY over n
ranks (on the card unless ``device`` says otherwise), with the
sharding-economy and per-axis collective claims checked; also
``python -m edl_tpu_torch.entry dryrun N [--device cpu]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.device import resolve
from edl_tpu_torch.models import bert
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.parallel.mesh import MeshShape, MeshSpec
from edl_tpu_torch.runtime import elastic, optim
from edl_tpu_torch.runtime.data import ShardRegistry
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.serving import DecodeFleet
from edl_tpu_torch.runtime.virtual import VirtualConfig


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
    return _flagship(cfg, dev), _flagship_data(cfg, batch, seq, dev)


def _flagship(cfg: tfm.TransformerConfig, dev: torch.device,
              **trainer_kw) -> ElasticTrainer:
    """The ``ElasticTrainer`` of every FLAGSHIP builder: ``cfg`` with the
    flash kernels, weights from seed 0, adamw(3e-4)."""
    model = tfm.Transformer(dataclasses.replace(cfg, use_flash=True),
                            device=dev, seed=0)
    return ElasticTrainer(tfm.loss_fn, model, optim.adamw(3e-4),
                          devices=[dev], **trainer_kw)


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
                           initial_world_size: Optional[int] = None,
                           accum_mode: str = "dp",
                           param_sharding="replicated",
                           spec: Optional[MeshSpec] = None):
    """(trainer, (tokens, targets)) for rank ``rank`` of a ``world``-rank
    job: :func:`flagship_trainer`'s model, optimizer and global batch on
    this rank's device, its ``ElasticTrainer`` over the job's process group
    (joined by :func:`_join_world`).  Every rank calls this with the same
    arguments but its rank; the first world is the whole group unless
    ``initial_world_size`` says fewer; ``accum_mode``, ``param_sharding``
    and ``spec`` (default: dp absorbs every rank) are the trainer's."""
    dev = _join_world(rank, world, store_path, device, backend)
    trainer = _flagship(cfg, dev, initial_world_size=initial_world_size,
                        accum_mode=accum_mode,
                        param_sharding=param_sharding,
                        spec=spec or MeshSpec(dp=-1))
    return trainer, _flagship_data(cfg, batch, seq, dev)


def flagship_tp_world(rank: int, world: int, store_path, device="cuda",
                      batch: int = 16, seq: int = 1024,
                      cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                      initial_world_size: Optional[int] = None):
    """(trainer, (tokens, targets)) for rank ``rank`` of a ``world``-rank
    job, as :func:`flagship_elastic_world` builds them, with every world
    tensor parallel (``MeshSpec(tp=-1)``) and the parameters laid out by
    ``cfg``'s partition specs (``param_partition_specs``): each rank of a
    world holds its tp block of every matrix, embed and lm_head by
    vocabulary, and the whole norms."""
    return flagship_elastic_world(
        rank, world, store_path, device=device, batch=batch, seq=seq,
        cfg=cfg, initial_world_size=initial_world_size,
        param_sharding=tfm.param_partition_specs(cfg), spec=MeshSpec(tp=-1))


def _join_world(rank: int, world: int, store_path, device,
                backend: Optional[str] = None) -> torch.device:
    """This rank's device, after joining the default process group through
    a ``FileStore`` at ``store_path`` (unless this process has joined it
    already: a rank building a fresh trainer after a failure).  On the
    card, ``device="cuda"`` gives rank r its own card ``cuda:r`` while
    there are cards enough, and the ranks NCCL; otherwise (more ranks than
    cards, or a device with an index) the ranks share a card and talk
    gloo, as they do on the CPU.  ``backend`` overrides the choice."""
    dev = resolve(device)
    shared = True
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:
            shared = world > cards
            dev = torch.device("cuda", 0 if shared else rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("gloo" if shared else "nccl"),
                                store=dist.FileStore(str(store_path), world),
                                rank=rank, world_size=world)
    return dev


#: the virtual-worker job's dataset: rows of ``seq`` tokens, in shards
VIRTUAL_ROWS, VIRTUAL_SHARDS = 256, 16


def flagship_virtual_world(rank: int, world: int, store_path,
                           device="cuda",
                           cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                           vw_count: int = 8, global_batch: int = 16,
                           seq: int = 1024, accum_mode: str = "replicated",
                           initial_world_size: Optional[int] = None,
                           param_sharding="replicated",
                           spec: Optional[MeshSpec] = None):
    """(trainer, registry, shard_ids, VirtualConfig) for rank ``rank`` of a
    ``world``-rank virtual-worker job: the trainer as
    :func:`flagship_elastic_world` builds it (with ``accum_mode``,
    ``param_sharding`` and ``spec``: ``"fsdp"`` with ``MeshSpec(dp=1,
    fsdp=-1)``, or ``param_partition_specs(cfg)`` with ``MeshSpec(tp=-1)``
    as :func:`flagship_tp_world` lays it out), and a
    :class:`~edl_tpu_torch.runtime.data.ShardRegistry` of
    :data:`VIRTUAL_ROWS` rows of ``seq`` tokens from seed 1 (the targets
    shifted by one) in :data:`VIRTUAL_SHARDS` shards, for ``vw_count``
    virtual workers and a constant ``global_batch``.  Without a
    ``store_path`` (``world`` 1) it joins no group: the one-process
    control."""
    if store_path is None:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a store_path "
                             "to join through")
        dev = resolve(device)
    else:
        dev = _join_world(rank, world, store_path, device)
    trainer = _flagship(cfg, dev, initial_world_size=initial_world_size,
                        accum_mode=accum_mode, param_sharding=param_sharding,
                        spec=spec or MeshSpec(dp=-1))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (VIRTUAL_ROWS, seq), dtype=np.int64)
    registry = ShardRegistry()
    ids = registry.register_arrays((tokens, np.roll(tokens, -1, axis=1)),
                                   num_shards=VIRTUAL_SHARDS)
    return (trainer, registry, ids,
            VirtualConfig(vw_count=vw_count, global_batch=global_batch))


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
                          params=None, **kw) -> DecodeFleet:
    """A ``DecodeFleet`` serving ``cfg`` (FLAGSHIP, bf16) on ``device``
    with ``params`` (a ``Transformer``, or its weights nested as a
    checkpoint restores them: ``llama.param_tree``), by default random
    weights from seed 0; ``kw`` overrides :data:`DECODE_DEFAULTS` and
    passes any other fleet argument (``roles``, ``spec_tokens``, ``job``,
    ...)."""
    dev = resolve(device)
    if params is None:
        params = tfm.Transformer(cfg, device=dev, seed=0)
    return DecodeFleet(params, cfg, device=dev, **{**DECODE_DEFAULTS, **kw})


# -- the multi-rank dryrun ----------------------------------------------------

#: dryrun_multichip's layouts, the reference's (``__graft_entry__.py``): n 2
#: is fsdp alone, n 4 dp x fsdp, n 8 dp x fsdp x tp; n 16 needs sp
DRYRUN_SPECS = {2: MeshSpec(dp=1, fsdp=-1), 4: MeshSpec(dp=-1, fsdp=2),
                8: MeshSpec(dp=-1, fsdp=2, tp=2)}
#: what the step's collective census must hold on each axis of more than
#: one rank: dp syncs gradients; fsdp gathers params (its reduce may fold
#: into an all-reduce); tp sums the row-parallel matmuls' partial sums
DRYRUN_EXPECTED = {"dp": ("all-reduce",), "fsdp": ("all-gather",),
                   "tp": ("all-reduce",)}
DRYRUN_DEADLINE_S = 240


def _spec_shard_factor(spec: tuple, shape: MeshShape) -> int:
    """Product of the mesh axis sizes a partition spec shards on."""
    sizes, k = shape.axis_sizes(), 1
    for part in spec:
        for ax in (() if part is None else
                   (part,) if isinstance(part, str) else part):
            k *= sizes[ax]
    return k


def _check_sharding_economy(shards: dict, leaves: dict, specs: dict,
                            shape: MeshShape) -> dict:
    """Every leaf the specs shard holds exactly 1/k of its bytes on this
    rank (a copy of the reference's check).  Returns this rank's byte
    table; raises on a leaf placed replicated against its spec."""
    mine = total = sharded_total = 0
    for name, shard in shards.items():
        nbytes = leaves[name]
        k = _spec_shard_factor(specs[name], shape)
        total += nbytes
        mine += shard.nbytes
        if k <= 1:
            continue
        sharded_total += nbytes
        if shard.nbytes != nbytes // k:
            raise AssertionError(
                f"sharding economy violated at {name}: spec {specs[name]} "
                f"promises {nbytes // k} B/device (1/{k} of {nbytes} B) but "
                f"a device holds {shard.nbytes} B — a "
                "replicated-instead-of-sharded layout regression")
    return {"device": mine, "total": total, "sharded_total": sharded_total}


def _dryrun_rank(rank: int, n: int, store: str, out: str,
                 inject: Optional[str], device: str) -> None:
    """One rank of :func:`dryrun_multichip`: the step, its checks and this
    rank's record (or its error) as JSON in ``out``."""
    try:
        torch.set_num_threads(1)
        dev = _join_world(rank, n, store, device)
        cfg = dataclasses.replace(tfm.TINY, one_hot_embed=True)
        model = tfm.Transformer(cfg, device=dev, seed=0)
        nbytes = {k: p.nbytes for k, p in model.named_parameters()}
        # the canonical layout CLAIM, which the economy check holds the
        # placement to whatever the injection below does
        specs = tfm.param_partition_specs(cfg)
        placed = specs
        if inject == "replicate":
            # the deliberate layout regression of the negative control
            placed = {k: (None,) * len(v) for k, v in specs.items()}
        trainer = ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                                 spec=DRYRUN_SPECS[n], param_sharding=placed,
                                 devices=[dev])
        shape = trainer.shape
        rows = max(shape.dp * shape.fsdp, 2)
        batch = (torch.zeros((rows, 16), dtype=torch.int64, device=dev),
                 torch.ones((rows, 16), dtype=torch.int64, device=dev))
        elastic.reset_census()
        loss = trainer.step(batch)
        census = elastic.collective_census()
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss in dryrun: {loss}")
        mem = _check_sharding_economy(trainer.shards, nbytes, specs, shape)
        rec = dict(rank=rank, loss=loss, census=census, mem=mem,
                   mesh=shape.axis_sizes())
    except Exception:
        rec = dict(rank=rank, error=traceback.format_exc())
    with open(out, "w") as f:
        json.dump(rec, f)


def dryrun_multichip(n: int, device="cuda") -> dict:
    """One sharded train step of TINY (one-hot embedding, adam(1e-3)) over
    ``n`` ranks on ``device`` (ranks that share one card, or the CPU, talk
    gloo: :func:`_join_world`), the parameters placed by the model's
    partition specs over the reference's layout for ``n``
    (:data:`DRYRUN_SPECS`), with its claims checked as the reference checks
    them:

    * every leaf the specs shard holds exactly 1/k of its bytes on each rank
      ("sharding economy violated" otherwise; ``EDL_DRYRUN_INJECT=
      replicate`` places every leaf replicated while the claim stays the
      specs, and must fail);
    * the step's collectives, counted by the trainer's choke points, hold
      an all-reduce on dp, an all-gather and a reduce (reduce-scatter or
      all-reduce) on fsdp, and an all-reduce on tp.

    Prints one ``DRYRUN_COMM {json}`` line with the reference's keys and
    returns its record; raises on any failed check."""
    if n not in DRYRUN_SPECS:
        raise ValueError(
            f"dryrun_multichip({n}): the port lays out n 2 (fsdp), 4 "
            "(dp x fsdp) and 8 (dp x fsdp x tp); n 16 needs sp (ROADMAP.md "
            "queue 1 item 9)")
    device = str(resolve(device))
    inject = os.environ.get("EDL_DRYRUN_INJECT")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n)]
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n, os.path.join(tmp, "store"), outs[r],
                                   inject, device))
                 for r in range(n)]
        try:
            for p in procs:
                p.start()
            end = time.monotonic() + DRYRUN_DEADLINE_S
            for p in procs:
                p.join(max(end - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        recs = []
        for r, out in enumerate(outs):
            if not os.path.exists(out):
                raise RuntimeError(f"dryrun rank {r} exited "
                                   f"{procs[r].exitcode} without a record")
            with open(out) as f:
                recs.append(json.load(f))
    errors = [r["error"] for r in recs if "error" in r]
    if errors:
        raise AssertionError("dryrun_multichip failed:\n" + errors[0])
    census = recs[0]["census"]
    mesh = recs[0]["mesh"]

    def axis_ops(axis: str) -> dict:
        ops: dict[str, int] = {}
        for label, slot in census.items():
            if axis in label.split("+"):
                for op, c in slot["ops"].items():
                    ops[op] = ops.get(op, 0) + c
        return ops

    for axis, wanted in DRYRUN_EXPECTED.items():
        if mesh[axis] <= 1:
            continue
        for op in wanted:
            if axis_ops(axis).get(op, 0) < 1:
                raise AssertionError(
                    f"the step has no {op} on mesh axis '{axis}' (size "
                    f"{mesh[axis]}): collective census {census}")
    if mesh["fsdp"] > 1:
        fops = axis_ops("fsdp")
        if fops.get("reduce-scatter", 0) + fops.get("all-reduce", 0) < 1:
            raise AssertionError(f"fsdp axis gathers but never reduces: "
                                 f"{fops}")
    per_rank = [r["mem"]["device"] for r in recs]
    record = {
        "n": n,
        "mesh": mesh,
        "collectives": {label: {"ops": slot["ops"],
                                "bytes": int(slot["bytes"])}
                        for label, slot in sorted(census.items())},
        "comm_bytes_per_step": int(sum(s["bytes"]
                                       for s in census.values())),
        "param_bytes_total": recs[0]["mem"]["total"],
        "param_bytes_sharded": recs[0]["mem"]["sharded_total"],
        "param_bytes_per_device_max": max(per_rank),
        "param_bytes_per_device_min": min(per_rank),
    }
    print("DRYRUN_COMM " + json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] != ["dryrun"] or len(args) not in (2, 4) or (
            len(args) == 4 and args[2] != "--device"):
        sys.exit("usage: python -m edl_tpu_torch.entry dryrun N "
                 "[--device DEVICE]")
    dryrun_multichip(int(args[1]), device=args[3] if len(args) == 4
                     else "cuda")
    print(f"dryrun_multichip({args[1]}) ok")
