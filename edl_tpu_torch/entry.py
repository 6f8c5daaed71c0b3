"""Entry points of the port: the forward pass on the flagship model, and the
trainers of the paths that ``chip_smoke.py`` drives, and the decode fleet.

``entry(device)`` returns ``(fn, example_args)`` with ``fn(*example_args)``
the FLAGSHIP forward on tokens ``[2, 256]`` — the twin of the JAX package's
``__graft_entry__.entry``.  ``flagship_trainer(device)`` returns the
``ElasticTrainer`` and batch that ``chip_smoke.py`` and
``edl_tpu_torch.profile_step`` drive, ``flagship_elastic_world`` the
same for one rank of a multi-rank job (``flagship_tp_world`` laid out by
the model's partition specs over tp, ``flagship_sp_world`` with the
sequence split over sp), and ``flagship_virtual_world`` that
rank's trainer (replicated, fsdp or tp) with the virtual-worker job's
data; ``resnet_trainer`` and ``bert_trainer`` do the same for bench.py's
model-zoo leg (ResNet-50 at 256 x 224², BERT-base MLM at 32 x 512).
``bert_tp_world`` is BERT's trainer laid out by its partition specs over
tp for one rank, and ``flagship_local_job`` one rank's side of the elastic
job the control plane dials (``LocalElasticJob``: the FLAGSHIP trainer, and
on rank 0 the coordinator, the fake cluster, the job and its data);
``flagship_controlled_job`` the same job run by a ``Controller`` (rank 0's
:class:`ControlPlane`: the native coordinator behind a chaos proxy, the
cluster, the controller and a checkpointer), and ``controlled_campaign``
runs it under a seeded campaign of the training fault kinds.
``flagship_decode_fleet(device)`` returns the ``DecodeFleet`` that serves
FLAGSHIP token by token, from seed-0 weights or the ones it is given, and
``flagship_scoring_fleet(device)`` the single-shot ``ServingFleet`` whose
requests are rows of tokens and whose answers are FLAGSHIP's next-token
logits.  ``flagship_frontdoor_replica(device)`` is one replica of the
serving data plane: the same scoring forward behind a ``BatchApp`` front
door that publishes its ready gate for the LB tier, and
``spawn_flagship_frontdoor_replica`` runs it as a process of its own
(``python -m edl_tpu_torch.entry frontdoor-replica ...``).  All
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
from edl_tpu_torch.runtime.frontdoor import BatchApp, FrontDoor
from edl_tpu_torch.runtime.serving import (DecodeFleet, ElasticServer,
                                           ServingFleet)
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


def flagship_sp_world(rank: int, world: int, store_path, device="cuda",
                      batch: int = 4, seq: int = 4096,
                      cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                      initial_world_size: Optional[int] = None):
    """(trainer, (tokens, targets)) for rank ``rank`` of a ``world``-rank
    job, as :func:`flagship_elastic_world` builds them, with every world
    sequence parallel (``MeshSpec(sp=-1)``): each rank of a world holds the
    whole (replicated) parameters and trains its contiguous chunk of every
    sequence of the global batch, its attention ringing the other ranks'
    k/v chunks (the flash ring on the card).  The default batch, 4 × 4 096
    tokens, is a long-context step of the same 16 384 tokens as
    :func:`flagship_trainer`'s."""
    return flagship_elastic_world(
        rank, world, store_path, device=device, batch=batch, seq=seq,
        cfg=cfg, initial_world_size=initial_world_size,
        spec=MeshSpec(sp=-1))


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


def rank_processes():
    """The multiprocessing context rank processes start from: a fork
    server that imports the caller's main module and this one once, and
    never touches CUDA, so each rank is forked from it instead of importing
    torch and the port anew (what bounds a wide dryrun's start on the
    card's host); the server forks from its one thread, so fork's hazards
    in a threaded process do not arise, and each rank brings up CUDA
    itself."""
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "edl_tpu_torch.entry"])
    return ctx


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
    return _bert(cfg, dev), _bert_data(cfg, batch, seq, dev)


def _bert(cfg: bert.BertConfig, dev: torch.device,
          **trainer_kw) -> ElasticTrainer:
    """The ``ElasticTrainer`` of every BERT entry point: ``cfg``, weights
    from seed 0, adamw(3e-4)."""
    model = bert.Bert(cfg, device=dev, seed=0)
    return ElasticTrainer(bert.mlm_loss_fn, model, optim.adamw(3e-4),
                          devices=[dev], **trainer_kw)


def _bert_data(cfg: bert.BertConfig, batch: int, seq: int,
               dev: torch.device) -> tuple[torch.Tensor, ...]:
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    targets = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    mask = (rng.random((batch, seq)) < 0.15).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (tokens, targets, mask))


def bert_tp_world(rank: int, world: int, store_path, device="cuda",
                  batch: int = 32, seq: int = 512,
                  cfg: bert.BertConfig = bert.BERT_BASE):
    """(trainer, (tokens, targets, mask)) for rank ``rank`` of a
    ``world``-rank job: :func:`bert_trainer`'s model, optimizer and MLM
    batch on this rank's device, its ``ElasticTrainer`` over the job's
    process group (joined as :func:`flagship_elastic_world` joins it, every
    rank live) with the world tensor parallel (``MeshSpec(tp=-1)``) and the
    parameters laid out by ``cfg``'s partition specs: each rank holds its
    tp block of every matrix, embed by vocabulary, and the whole norms and
    position table."""
    dev = _join_world(rank, world, store_path, device)
    trainer = _bert(cfg, dev, param_sharding=bert.param_partition_specs(cfg),
                    spec=MeshSpec(tp=-1))
    return trainer, _bert_data(cfg, batch, seq, dev)


#: the elastic job's dataset: rows of ``seq`` tokens in LOCAL_SHARDS tasks
#: of one global batch each
LOCAL_ROWS, LOCAL_SHARDS = 128, 8


def _token_registry(cfg: tfm.TransformerConfig, rows: int, seq: int,
                    shards: int) -> tuple[ShardRegistry, list]:
    """``rows`` token rows from seed 1 (targets shifted by one), split
    into ``shards`` shards of a fresh registry: (registry, shard ids)."""
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (rows, seq), dtype=np.int64)
    registry = ShardRegistry()
    ids = registry.register_arrays((tokens, np.roll(tokens, -1, axis=1)),
                                   num_shards=shards)
    return registry, ids


def flagship_local_job(rank: int, world: int, store_path, device="cuda",
                       cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                       global_batch: int = 16, seq: int = 1024,
                       rows: int = LOCAL_ROWS, shards: int = LOCAL_SHARDS,
                       virtual: Optional[VirtualConfig] = None):
    """(LocalElasticJob, ShardRegistry or None, shard ids) for rank
    ``rank`` of a ``world``-rank elastic job: the FLAGSHIP trainer as
    :func:`flagship_elastic_world` builds it (replicated, the flash
    kernels; ``accum_mode="replicated"`` under ``virtual``), live on rank
    0 alone (the job's minimum), and on rank 0 the control plane: a
    ``PyCoordService``, a ``FakeCluster`` of two nodes of one card each in
    one NVLink domain,
    the ``TrainingJob`` (1 to ``world`` trainers, one card each) created
    there at its minimum, and a ``ShardRegistry`` of ``rows`` token rows
    from seed 1 (targets shifted by one) in ``shards`` shards, enqueued
    as the job's tasks.  With a ``virtual`` config the job drives the
    virtual-worker loop instead, and every rank holds the registry (each
    reads its own micro-batches).  Without a ``store_path`` (``world`` 1)
    it joins no group."""
    from edl_tpu_torch.api.types import (ResourceRequirements, TrainerSpec,
                                         TrainingJob, TrainingJobSpec)
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.coord import PyCoordService
    from edl_tpu_torch.runtime.local import LocalElasticJob

    if store_path is None:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a store_path "
                             "to join through")
        dev = resolve(device)
    else:
        dev = _join_world(rank, world, store_path, device)
    trainer = _flagship(cfg, dev, initial_world_size=1,
                        accum_mode="replicated" if virtual else "dp",
                        spec=MeshSpec(dp=-1))
    registry = ids = None
    if rank == 0 or virtual is not None:
        registry, ids = _token_registry(cfg, rows, seq, shards)
    name = "flagship"
    job = cluster = coord = None
    if rank == 0:
        coord = PyCoordService()
        cluster = FakeCluster()
        for i in range(2):
            cluster.add_node(f"node{i}", cpu_milli=16_000,
                             memory_mega=64_000, gpus=1,
                             nvlink_domain="nvlink0")
        job = TrainingJob(name=name, spec=TrainingJobSpec(
            fault_tolerant=True, trainer=TrainerSpec(
                min_instance=1, max_instance=world,
                resources=ResourceRequirements(
                    requests={"cpu": "1"}, limits={"nvidia.com/gpu": "1"}))))
        cluster.create_resources(job)
        if virtual is None:
            registry.enqueue(coord, ids)
    runner = LocalElasticJob(
        job, cluster, trainer, coord,
        fetch=registry.fetch if registry is not None else None,
        batch_size=global_batch, virtual=virtual, shard_ids=ids,
        fetch_shard=registry.get if registry is not None else None,
        job_name=f"default/{name}")
    return runner, registry, ids


#: the controlled job's dataset: rows of ``seq`` tokens in one task a
#: global batch of 16
CONTROLLED_ROWS, CONTROLLED_SHARDS = 384, 24
#: the controlled job's cluster: two one-card nodes, each its own NVLink
#: domain (so a domain preemption takes one trainer, not the job)
CONTROLLED_NODES = (("node0", "nvlink0"), ("node1", "nvlink1"))
#: the controller's loops (autoscaler tick, updater convert), and the
#: coordinator's task timeout and member TTL: longer than a FLAGSHIP save,
#: during which rank 0 holds its lease without renewing it
CONTROL_LOOP_S = 0.05
CONTROL_TIMEOUT_MS = 30_000


def controlled_training_job(name: str, max_instance: int,
                            gpus: int = 1) -> "TrainingJob":
    """The elastic ``TrainingJob`` a controller runs: 1 to
    ``max_instance`` fault-tolerant trainers of ``gpus`` cards (0: CPU
    pods), allowed across NVLink domains (each of the controlled
    cluster's nodes is a domain of its own)."""
    from edl_tpu_torch.api.types import (ResourceRequirements, TrainerSpec,
                                         TrainingJob, TrainingJobSpec)

    limits = {"nvidia.com/gpu": str(gpus)} if gpus else {}
    return TrainingJob(name=name, spec=TrainingJobSpec(
        fault_tolerant=True, trainer=TrainerSpec(
            min_instance=1, max_instance=max_instance,
            allow_multi_domain=True,
            resources=ResourceRequirements(requests={"cpu": "1"},
                                           limits=limits))))


@dataclasses.dataclass
class ControlPlane:
    """Rank 0's side of a controlled job: the native coordinator (a
    durable state file) behind a ``ChaosProxy`` and a ``CoordClient``
    dialling the proxy, the ``FakeCluster``, the ``Controller`` that runs
    the job (its updater created the pods, its autoscaler dials them), and
    an ``ElasticCheckpointer``."""

    controller: object
    cluster: object
    job: object
    coord: object
    proxy: object
    checkpointer: object
    state_file: str
    server_kw: dict
    servers: list

    def restart_coordinator(self) -> None:
        """SIGKILL the coordinator, respawn it from its state file, and
        point the proxy at the new one (the clients' endpoint stays)."""
        from edl_tpu_torch.coord.server import spawn_server

        old = self.servers[-1]
        old.process.kill()
        old.process.wait(timeout=15)
        self.servers.append(spawn_server(state_file=self.state_file,
                                         **self.server_kw))
        self.proxy.set_upstream("127.0.0.1", self.servers[-1].port)

    def fault_context(self, **hooks):
        """A ``FaultContext`` over this plane; ``hooks`` adds the harness's
        (``stall``, ``wedge``, ``trainer``, ``rng``)."""
        from edl_tpu_torch.runtime.faults import FaultContext

        return FaultContext(cluster=self.cluster, job=self.job,
                            coord=self.coord, proxy=self.proxy,
                            checkpointer=self.checkpointer,
                            restart_coordinator=self.restart_coordinator,
                            **hooks)

    def leaked_servers(self) -> int:
        """Coordinator processes of this plane still running."""
        return sum(h.process.poll() is None for h in self.servers)

    def close(self) -> None:
        self.controller.stop()
        self.coord.close()
        self.proxy.close()
        self.checkpointer.close()
        for h in self.servers:
            h.stop()


def control_plane(job, work_dir, nodes=CONTROLLED_NODES,
                  held_nodes=()) -> ControlPlane:
    """Build rank 0's :class:`ControlPlane` under ``work_dir`` and submit
    ``job`` through its ``Controller`` (``max_load_desired`` 1.0, loops of
    CONTROL_LOOP_S): ``nodes`` are ``(name, nvlink_domain)`` pairs of one
    card each, and a system pod holds the card of each node in
    ``held_nodes`` from the start.  Returns once the job is Running."""
    from edl_tpu_torch.api.types import JobPhase
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.controller import Controller
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.coord.server import spawn_server
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
    from edl_tpu_torch.runtime.faults import ChaosProxy

    work_dir = os.fspath(work_dir)
    os.makedirs(work_dir, exist_ok=True)
    state_file = os.path.join(work_dir, "coord.state")
    server_kw = dict(task_timeout_ms=CONTROL_TIMEOUT_MS,
                     member_ttl_ms=CONTROL_TIMEOUT_MS)
    servers = [spawn_server(state_file=state_file, **server_kw)]
    proxy = ChaosProxy(("127.0.0.1", servers[0].port))
    coord = CoordClient("127.0.0.1", proxy.port, timeout=3.0,
                        reconnect_window_s=40.0)
    cluster = FakeCluster()
    for name, domain in nodes:
        cluster.add_node(name, cpu_milli=16_000, memory_mega=64_000, gpus=1,
                         nvlink_domain=domain)
    for name in held_nodes:
        cluster.add_system_pod(f"hold-{name}", name, gpus=1)
    controller = Controller(cluster, max_load_desired=1.0,
                            autoscaler_loop_seconds=CONTROL_LOOP_S,
                            updater_convert_seconds=CONTROL_LOOP_S,
                            updater_confirm_seconds=CONTROL_LOOP_S / 2)
    controller.start()
    controller.submit(job)
    deadline = time.monotonic() + 30
    while controller.phase(job) != JobPhase.RUNNING:
        if time.monotonic() > deadline:
            raise RuntimeError(f"job {job.full_name} never reached Running "
                               f"({controller.phase(job)})")
        time.sleep(CONTROL_LOOP_S / 2)
    checkpointer = ElasticCheckpointer(os.path.join(work_dir, "ckpt"),
                                       max_to_keep=3)
    return ControlPlane(controller, cluster, job, coord, proxy, checkpointer,
                        state_file, server_kw, servers)


def flagship_controlled_job(rank: int, world: int, store_path, device="cuda",
                            cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                            global_batch: int = 16, seq: int = 1024,
                            rows: int = CONTROLLED_ROWS,
                            shards: int = CONTROLLED_SHARDS,
                            work_dir=None):
    """(LocalElasticJob, ControlPlane or None, ShardRegistry or None) for
    rank ``rank`` of a ``world``-rank elastic job that a ``Controller``
    runs.  Every rank gets :func:`flagship_local_job`'s trainer; rank 0
    also builds the :class:`ControlPlane` under ``work_dir`` (default: a
    directory beside ``store_path``) — the native coordinator behind its
    proxy, a ``FakeCluster`` of :data:`CONTROLLED_NODES` with a system pod
    ``hold-node1`` holding node1's card, and the checkpointer — submits the
    FLAGSHIP ``TrainingJob`` (1 to ``world`` trainers of one card each)
    through the controller, whose updater creates its pods and whose
    autoscaler dials them, and enqueues ``rows`` token rows from seed 1
    (targets shifted by one) as ``shards`` tasks."""
    from edl_tpu_torch.runtime.local import LocalElasticJob

    dev = _join_world(rank, world, store_path, device)
    trainer = _flagship(cfg, dev, initial_world_size=1,
                        spec=MeshSpec(dp=-1))
    name = "flagship-controlled"
    plane = registry = None
    if rank == 0:
        registry, ids = _token_registry(cfg, rows, seq, shards)
        if work_dir is None:
            work_dir = os.path.join(os.path.dirname(os.fspath(store_path)),
                                    f"{name}-plane")
        plane = control_plane(controlled_training_job(name, world),
                              work_dir, held_nodes=("node1",))
        registry.enqueue(plane.coord, ids)
    runner = LocalElasticJob(
        plane.job if plane else None, plane.cluster if plane else None,
        trainer, plane.coord if plane else None,
        fetch=registry.fetch if registry is not None else None,
        batch_size=global_batch, job_name=f"default/{name}")
    return runner, plane, registry


def controlled_campaign(runner, plane: Optional[ControlPlane], seed: int,
                        first_step: int, last_step: int, min_gap: int,
                        save_every: int, on_step=None) -> dict:
    """Run a controlled job to the end of its tasks under a seeded
    training-fault campaign (the JAX package's fault soak), on every rank:
    ``runner`` is this rank's ``LocalElasticJob``, ``plane`` rank 0's
    :class:`ControlPlane` (None elsewhere).

    On rank 0 a ``FaultPlanEngine`` fires ``FaultPlan.random(seed, ...)``,
    one fault of each training kind between ``first_step`` and
    ``last_step`` at least ``min_gap`` apart, from the job's ``on_step``;
    a best-effort checkpoint of the trainer's state is saved every
    ``save_every`` steps;
    the first step after the checkpoint corruption strikes restores the
    store into a scratch copy of the state (the fallback must land on a
    verified step, and the live trainer is untouched); a stall or wedge
    request wedges rank 0's loop until a ``StallWatchdog`` (floor 1 s)
    detects the silence and releases it, while the other
    ranks wait in the next frame's broadcast.  The watchdog is paused over
    each save and the restore: a known pause is no stall, and no step
    interval either.  ``on_step(step, loss,
    world)`` runs first, on every rank.  Returns what rank 0 saw (the run's
    ``RunReport`` on the others): the report, the plan, what fired and
    recovered with their monotonic times, each stall's ``(silent_s,
    deadline_s)`` (None: unseen), each save's ``(step, ms, ok)``, the
    audit's restored step and hash verdict, and each step's end time and
    world."""
    import copy
    import random
    import threading

    from edl_tpu_torch.runtime.faults import (TRAINING_KINDS, FaultPlan,
                                              FaultPlanEngine)
    from edl_tpu_torch.runtime.watchdog import StallWatchdog

    trainer = runner.trainer
    out: dict = dict(fired_s=[], recovered_s=[], stalls=[], saves=[],
                     audit=[], steps=[])
    engine = watchdog = None
    if plane is not None:
        plan = FaultPlan.random(seed, n_faults=len(TRAINING_KINDS),
                                first_step=first_step, last_step=last_step,
                                min_gap=min_gap)
        released = threading.Event()
        stall_requests: list = []
        watchdog = StallWatchdog(floor_s=1.0, k=6.0, warmup=3,
                                 alpha=0.5, on_stall=lambda s: released.set(),
                                 scope="campaign")
        watchdog.start(poll_s=0.05)
        engine = FaultPlanEngine(plan, plane.fault_context(
            stall=lambda d: stall_requests.append(d or 30.0),
            wedge=lambda: bool(stall_requests.append(30.0)) or True,
            rng=random.Random(seed)))
        out["plan"] = plan.describe()

    def note_progress() -> None:
        now = time.monotonic()
        out["fired_s"] += [now] * (len(engine.fired) - len(out["fired_s"]))
        out["recovered_s"] += [
            (kind, now) for kind in engine.recovered[len(out["recovered_s"]):]]

    def step_hook(step: int, loss, world: int) -> None:
        out["steps"].append((time.monotonic(), world))
        if on_step is not None:
            on_step(step, loss, world)
        if engine is None:
            return
        watchdog.beat(step)
        state = {"params": trainer.state.params,
                 "opt": trainer.state.opt_state}
        if step % save_every == 0:
            t0 = time.perf_counter()
            with watchdog.paused():
                ok = plane.checkpointer.save(step, state, best_effort=True)
            out["saves"].append((step, 1e3 * (time.perf_counter() - t0), ok))
        engine(step, loss, world)
        note_progress()
        if not out["audit"] and any(k == "corrupt_checkpoint"
                                    for _, k in engine.fired):
            ck = plane.checkpointer
            with watchdog.paused():
                ck.restore(copy.deepcopy(state))
            out["audit"].append(dict(step=ck.last_restored_step,
                                     hash_ok=ck.last_restore_hash_ok))
        if stall_requests:
            duration = stall_requests.pop()
            released.clear()
            t0 = time.monotonic()
            while (time.monotonic() - t0 < duration
                   and not released.is_set()):
                time.sleep(0.02)  # no beats while wedged
            stall = watchdog.last_stall()
            out["stalls"].append(None if stall is None
                                 else (stall.silent_s, stall.deadline_s))

    report = runner.run(on_step=step_hook)
    if engine is None:
        return dict(report=report, steps=out["steps"])
    deadline = time.monotonic() + 30
    while not engine.quiescent() and time.monotonic() < deadline:
        engine.tick()
        note_progress()
        time.sleep(0.1)
    watchdog.stop()
    out.update(report=report, fired=list(engine.fired),
               recovered=list(engine.recovered), unfired=engine.unfired(),
               quiescent=engine.quiescent())
    return out


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


#: the scoring fleet's request: one row of FLAGSHIP's max_seq_len tokens
SCORING_SEQ = 1024


def score_last_token(model: tfm.Transformer, batch) -> torch.Tensor:
    """The scoring fleet's forward: the next-token logits ``[b, vocab]``
    (fp32) of each row of ``batch[0]``, tokens ``[b, s]``."""
    return tfm.apply(model, batch[0])[:, -1]


def flagship_scoring_fleet(device="cuda",
                           cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                           params: Optional[tfm.Transformer] = None,
                           seq: int = SCORING_SEQ, **kw) -> ServingFleet:
    """A single-shot ``ServingFleet`` serving ``cfg`` (FLAGSHIP, bf16) with
    the flash kernels on ``device``: a request is one row of ``seq`` token
    ids (int64), its answer the row's next-token logits
    (:func:`score_last_token`).  ``params`` is the model (default: random
    weights from seed 0); ``kw`` passes any other fleet argument
    (``max_batch_size``, ``max_queue_ms``, ``job``, ``kv``, ...)."""
    dev = resolve(device)
    if params is None:
        params = tfm.Transformer(cfg, device=dev, seed=0)
    params.cfg = dataclasses.replace(params.cfg, use_flash=True)
    return ServingFleet(score_last_token, params,
                        example_row=(np.zeros((seq,), np.int64),),
                        device=dev, **kw)


def score_f32_rows(model: tfm.Transformer, batch) -> torch.Tensor:
    """The data plane's scoring forward: a request is one raw-f32 row of
    token ids (exact: every id of FLAGSHIP's 16 384 is far under 2^24),
    cast to int64 on the device before the embedding; the answer is
    :func:`score_last_token`'s."""
    return score_last_token(model, (batch[0].to(torch.int64),))


def flagship_frontdoor_replica(device="cuda",
                               cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                               params: Optional[tfm.Transformer] = None, *,
                               job: str = "default/flagship-scoring",
                               replica: str = "r0", kv=None,
                               host: str = "127.0.0.1", port: int = 0,
                               advertise_port: Optional[int] = None,
                               seq: int = SCORING_SEQ, max_batch: int = 8,
                               lineage: Optional[str] = None,
                               generation: int = 0,
                               **app_kw) -> FrontDoor:
    """One replica of the serving data plane, started: a ``BatchApp``
    whose server is ``ElasticServer(score_f32_rows, cfg)`` with the flash
    kernels on ``device`` (random weights from seed 0 unless ``params``
    is given), behind a ``FrontDoor`` on ``host:port``.  With ``kv`` (a
    coordinator client) the door publishes ``serving-addr/<job>/
    <replica>`` with its ready gate; ``advertise_port`` puts another port
    in that address (a middlebox in front of the door).  With ``lineage``
    (an ``ElasticCheckpointer`` directory holding ``{"params": model}``)
    ``POST /admin/reload`` rolls the replica onto the newest verified
    step newer than ``generation`` (the generation the weights it starts
    with are published as).  The build and warm-up run on the app's
    batcher thread: call ``door.app.wait_ready()``.  ``app_kw`` passes any
    other ``BatchApp`` argument."""
    dev = resolve(device)
    if params is None:
        params = tfm.Transformer(cfg, device=dev, seed=0)
    params.cfg = dataclasses.replace(params.cfg, use_flash=True)

    def build() -> ElasticServer:
        return ElasticServer(score_f32_rows, params, devices=[dev])

    app = BatchApp(build, seq, job=job, replica=replica, kv=kv,
                   max_batch=max_batch, advertise_host=host,
                   advertise_port=advertise_port, **app_kw)
    app.generation = int(generation)
    if lineage is not None:
        from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
        from edl_tpu_torch.runtime.serving import _landed, _lineage_step

        ck = ElasticCheckpointer(lineage)

        def reload_hook():
            step = _lineage_step(ck, app.generation, job)
            if step is None:
                return None
            restored = ck.restore({"params": app.server.params_host()},
                                  step=step)
            if not _landed(ck, step, job):
                return None
            return restored["params"], step

        app.reload_hook = reload_hook
    return FrontDoor(app, host=host, port=port, job=job).start()


def spawn_flagship_frontdoor_replica(replica: str, *, coord: str,
                                     job: str = "default/flagship-scoring",
                                     device: str = "cuda",
                                     config: str = "flagship",
                                     port: int = 0,
                                     advertise_port: Optional[int] = None,
                                     lineage: Optional[str] = None,
                                     generation: int = 0,
                                     log_path: Optional[str] = None):
    """Start :func:`flagship_frontdoor_replica` as a process of its own
    (``python -m edl_tpu_torch.entry frontdoor-replica``; ``config``
    ``"tiny"`` runs TINY instead of FLAGSHIP, for the CPU) publishing to
    the coordinator at ``coord`` (``host:port``); returns the
    ``subprocess.Popen``.  Its output goes to ``log_path``: a ``frontdoor
    ready port=... metrics_port=... build_s=... ready_s=...`` line once
    warm, and on SIGTERM a ``frontdoor launches {...}`` JSON line (its
    flash launches and forwards, warm-up included)."""
    import subprocess

    argv = [sys.executable, "-m", "edl_tpu_torch.entry", "frontdoor-replica",
            "--replica", replica, "--coord", coord, "--job", job,
            "--device", device, "--config", config, "--port", str(port),
            "--generation", str(generation)]
    if advertise_port is not None:
        argv += ["--advertise-port", str(advertise_port)]
    if lineage is not None:
        argv += ["--lineage", lineage]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    penv = dict(os.environ)
    penv["PYTHONPATH"] = root + os.pathsep + penv.get("PYTHONPATH", "")
    out = open(log_path, "w") if log_path else subprocess.DEVNULL
    try:
        return subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT,
                                env=penv, cwd=root)
    finally:
        if log_path:
            out.close()


def frontdoor_replica_main(argv: list[str]) -> int:
    """The process behind :func:`spawn_flagship_frontdoor_replica`
    (:func:`~edl_tpu_torch.runtime.frontdoor.run_replica`'s life, the
    ``EDL_FD_METRICS_PORT``, ``EDL_TRACE_DIR`` and ``EDL_FD_LAG_PROBE_MS``
    env included): exit 3 when the coordinator never answers or the build
    fails (no CUDA device included), 0 after a SIGTERM drain."""
    import argparse

    from edl_tpu_torch.observability.metrics import get_registry
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime.frontdoor import (CoordBootstrapError,
                                                 bootstrap_replica_kv,
                                                 run_replica)

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="edl_tpu_torch.entry frontdoor-replica")
    ap.add_argument("--replica", required=True)
    ap.add_argument("--coord", default="")
    ap.add_argument("--job", default="default/flagship-scoring")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=("flagship", "tiny"),
                    default="flagship")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--advertise-port", type=int, default=None)
    ap.add_argument("--lineage", default=None)
    ap.add_argument("--generation", type=int, default=0)
    args = ap.parse_args(argv)
    env = dict(os.environ, EDL_COORD_ENDPOINT=args.coord)
    try:
        kv = bootstrap_replica_kv(env, args.replica)
    except CoordBootstrapError:
        return 3
    cfg = tfm.FLAGSHIP if args.config == "flagship" else tfm.TINY
    try:
        door = flagship_frontdoor_replica(
            args.device, cfg, job=args.job, replica=args.replica, kv=kv,
            port=args.port, advertise_port=args.advertise_port,
            seq=min(SCORING_SEQ, cfg.max_seq_len), lineage=args.lineage,
            generation=args.generation)
    except Exception as exc:
        print(f"frontdoor FAILED replica={args.replica} ({exc})", flush=True)
        if kv is not None:
            kv.close()
        return 3
    app = door.app
    t_door = time.perf_counter()
    reg = get_registry()
    for name in fa.launches:
        reg.counter_fn("flash_launches", lambda n=name: fa.launches[n],
                       help="flash kernel launches in this process",
                       kernel=name)
    reg.counter_fn("frontdoor_forwards",
                   lambda: app.server.forwards if app.server else 0,
                   help="forwards run, the warm-up's included")
    reg.gauge_fn("frontdoor_generation", lambda: app.generation,
                 help="the weights' generation")

    def ready_fields() -> str:
        now = time.perf_counter()
        return f"build_s={now - t_door:.3f} ready_s={now - t_start:.3f}"

    def on_exit() -> None:
        print("frontdoor launches " + json.dumps(dict(
            replica=args.replica, launches=dict(fa.launches),
            forwards=app.server.forwards, generation=app.generation,
            requests_served=app.requests_served,
            iterations=app.iterations)), flush=True)

    return run_replica(door, kv, env, replica=args.replica,
                       build_timeout_s=600, ready_fields=ready_fields,
                       on_exit=on_exit, metrics_host="127.0.0.1")


# -- the multi-rank dryrun ----------------------------------------------------

#: dryrun_multichip's layouts, the reference's (``__graft_entry__.py``): n 2
#: is fsdp alone, n 4 dp x fsdp, n 8 dp x fsdp x tp, n 16 dp x fsdp x tp x sp
DRYRUN_SPECS = {2: MeshSpec(dp=1, fsdp=-1), 4: MeshSpec(dp=-1, fsdp=2),
                8: MeshSpec(dp=-1, fsdp=2, tp=2),
                16: MeshSpec(dp=-1, fsdp=2, tp=2, sp=2)}
#: what the step's collective census must hold on each axis of more than
#: one rank: dp syncs gradients; fsdp gathers params (its reduce may fold
#: into an all-reduce); tp sums the row-parallel matmuls' partial sums; sp
#: rings the k/v chunks (one collective-permute a tensor a hop)
DRYRUN_EXPECTED = {"dp": ("all-reduce",), "fsdp": ("all-gather",),
                   "tp": ("all-reduce",), "sp": ("collective-permute",)}
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
    rank's record (or its error) as JSON in ``out``, with the wall clock
    (``time.time()``) at which it started, joined the group, built its
    trainer and ended its step."""
    clock = {"start": time.time()}
    try:
        torch.set_num_threads(1)
        dev = _join_world(rank, n, store, device)
        clock["joined"] = time.time()
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
        clock["built"] = time.time()
        shape = trainer.shape
        # the batch divides over dp·fsdp and the sequence over sp (16
        # tokens a chunk: TINY's attention takes the plain ring, as the
        # reference's does)
        rows, seq = max(shape.dp * shape.fsdp, 2), 16 * shape.sp
        batch = (torch.zeros((rows, seq), dtype=torch.int64, device=dev),
                 torch.ones((rows, seq), dtype=torch.int64, device=dev))
        elastic.reset_census()
        loss = trainer.step(batch)
        clock["stepped"] = time.time()
        census = elastic.collective_census()
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss in dryrun: {loss}")
        mem = _check_sharding_economy(trainer.shards, nbytes, specs, shape)
        rec = dict(rank=rank, loss=loss, census=census, mem=mem,
                   mesh=shape.axis_sizes(), clock=clock)
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
      all-reduce) on fsdp, an all-reduce on tp, and the ring's
      collective-permutes on sp.

    Prints one ``DRYRUN_COMM {json}`` line with the reference's keys and
    returns its record; raises on any failed check."""
    if n not in DRYRUN_SPECS:
        raise ValueError(
            f"dryrun_multichip({n}): the port lays out n 2 (fsdp), 4 "
            "(dp x fsdp), 8 (dp x fsdp x tp) and 16 (dp x fsdp x tp x sp), "
            "the reference's sweep")
    device = str(resolve(device))
    inject = os.environ.get("EDL_DRYRUN_INJECT")
    ctx = rank_processes()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n)]
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n, os.path.join(tmp, "store"), outs[r],
                                   inject, device))
                 for r in range(n)]
        spawned = time.time()
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
    # where the ranks' time went: the latest rank to reach each point
    print(f"dryrun_multichip({n}) seconds from the spawn to the last rank's "
          + ", ".join(f"{k} {max(r['clock'][k] for r in recs) - spawned:.1f}"
                      for k in ("start", "joined", "built", "stepped")),
          flush=True)

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
    if args[:1] == ["frontdoor-replica"]:
        sys.exit(frontdoor_replica_main(args[1:]))
    if args[:1] != ["dryrun"] or len(args) not in (2, 4) or (
            len(args) == 4 and args[2] != "--device"):
        sys.exit("usage: python -m edl_tpu_torch.entry dryrun N "
                 "[--device DEVICE]")
    dryrun_multichip(int(args[1]), device=args[3] if len(args) == 4
                     else "cuda")
    print(f"dryrun_multichip({args[1]}) ok")
