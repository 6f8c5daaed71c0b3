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

``kubelet_job_manifest`` writes the TrainingJob manifest of an elastic job
of supervised multi-process workers, and ``kubelet_campaign`` runs one from
its CR to Succeeded through the deployed control plane (the CR sync loop,
the ``Controller``, a ``ProcessKubelet`` running its pods as processes),
through a grow, a killed trainer pod and a killed coordinator pod.

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
#: the arbitration cluster: three one-card nodes, each its own NVLink
#: domain; the trainer's job starts with node1's and node2's cards held
ARBITRATION_NODES = (("node0", "nvlink0"), ("node1", "nvlink1"),
                     ("node2", "nvlink2"))
#: the arbitration plane's loops (autoscaler, updater, serving scaler),
#: the scraper's sweep interval and the FleetView's window: a sweep renders
#: and parses the fleet's whole registry under this process's interpreter
#: lock, so it runs at 4 Hz, not at the control loop's rate
ARBITRATION_LOOP_S = 0.1
ARBITRATION_SCRAPE_S = 0.25
ARBITRATION_WINDOW_S = 2.0
#: the arbitrated trainer's dataset: rows of ``seq`` tokens, in one task a
#: global batch of 16 — more tasks than the run leases (it trains until
#: its campaign is done; the rest stay queued)
ARBITRATION_ROWS, ARBITRATION_SHARDS = 4096, 256


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
                  held_nodes=(), arbitrated: bool = False) -> ControlPlane:
    """Build rank 0's :class:`ControlPlane` under ``work_dir`` and submit
    ``job`` through its ``Controller`` (``max_load_desired`` 1.0, loops of
    CONTROL_LOOP_S): ``nodes`` are ``(name, nvlink_domain)`` pairs of one
    card each, and a system pod holds the card of each node in
    ``held_nodes`` from the start.  Returns once the job is Running.

    ``arbitrated`` makes it the train+serve arbitration plane: the
    controller plans by the goodput objective (``goodput_curves`` reads
    each job's curve from the coordinator, ``load_curve``), records each
    planning tick's inputs (``Autoscaler.record_plans``), reaches the
    coordinator for every job (``coord_for``: the serving scaler records
    each fleet's capacity curve there), and owns a ``MetricsScraper`` that
    discovers the serving replicas' ``/metrics`` through the coordinator
    (``kv_targets``) and feeds the serving scaler through a ``FleetView``
    (ARBITRATION_SCRAPE_S, ARBITRATION_WINDOW_S, loops of
    ARBITRATION_LOOP_S)."""
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
    kw: dict = {}
    loop_s = CONTROL_LOOP_S
    if arbitrated:
        from edl_tpu_torch.observability.goodput import load_curve
        from edl_tpu_torch.observability.scrape import (MetricsScraper,
                                                        kv_targets)

        loop_s = ARBITRATION_LOOP_S
        kw = dict(goodput_curves=lambda uid: load_curve(coord, uid),
                  coord_for=lambda _job: coord,
                  scraper=MetricsScraper(discover=[kv_targets(coord)],
                                         interval_s=ARBITRATION_SCRAPE_S,
                                         timeout_s=2.0),
                  scrape_window_s=ARBITRATION_WINDOW_S,
                  serving_loop_seconds=ARBITRATION_LOOP_S)
    controller = Controller(cluster, max_load_desired=1.0,
                            autoscaler_loop_seconds=loop_s,
                            updater_convert_seconds=loop_s,
                            updater_confirm_seconds=loop_s / 2, **kw)
    controller.autoscaler.record_plans = arbitrated
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


def flagship_arbitrated_job(rank: int, world: int, store_path, device="cuda",
                            cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                            global_batch: int = 16, seq: int = 1024,
                            rows: int = ARBITRATION_ROWS,
                            shards: int = ARBITRATION_SHARDS,
                            work_dir=None):
    """(LocalElasticJob, ControlPlane or None, ShardRegistry or None) for
    rank ``rank`` of the trainer of the train+serve arbitration: as
    :func:`flagship_controlled_job`, but rank 0's plane is the arbitration
    plane (``control_plane(arbitrated=True)``: the goodput objective over
    the coordinator's curves, a scraper, :data:`ARBITRATION_NODES` with
    node1's and node2's cards held by system pods at the start)."""
    from edl_tpu_torch.runtime.local import LocalElasticJob

    dev = _join_world(rank, world, store_path, device)
    trainer = _flagship(cfg, dev, initial_world_size=1,
                        spec=MeshSpec(dp=-1))
    name = "flagship-arbitrated"
    plane = registry = None
    if rank == 0:
        registry, ids = _token_registry(cfg, rows, seq, shards)
        if work_dir is None:
            work_dir = os.path.join(os.path.dirname(os.fspath(store_path)),
                                    f"{name}-plane")
        plane = control_plane(controlled_training_job(name, world),
                              work_dir, nodes=ARBITRATION_NODES,
                              held_nodes=("node1", "node2"), arbitrated=True)
        registry.enqueue(plane.coord, ids)
    runner = LocalElasticJob(
        plane.job if plane else None, plane.cluster if plane else None,
        trainer, plane.coord if plane else None,
        fetch=registry.fetch if registry is not None else None,
        batch_size=global_batch, job_name=f"default/{name}")
    return runner, plane, registry


#: the arbitration's fleet: its job, batch and admission window, p99
#: objective (lax: two replicas share one card) and a replica's QPS target
#: as a share of the measured capacity C; the live steps the trainer takes
#: at a world before its curve point (the world's first left out of the
#: median); the Poisson windows (label, share of C, seconds); the window
#: whose scraped view is held to the fleet's own stats, and how far in;
#: the sampled answers; the alert drills' fast burn window and
#: target-down threshold; the fleet-following period and the run's
#: deadline
ARBITRATION_FLEET_JOB = "flagship-scoring"
ARBITRATION_BATCH, ARBITRATION_QUEUE_MS = 8, 2.0
ARBITRATION_SLO_MS, ARBITRATION_TARGET_SHARE = 1000.0, 0.2
ARBITRATION_WORLD_STEPS = 4
ARBITRATION_TRAFFIC = (("steady", 0.25, 3.0), ("burst", 1.25, 5.0),
                       ("trickle", 0.1, 3.0))
ARBITRATION_COMPARE = ("burst", 0.8)
ARBITRATION_SAMPLES = 8
ARBITRATION_BURN_WINDOW_S, ARBITRATION_DOWN_AFTER = 2.0, 3
ARBITRATION_FOLLOW_S, ARBITRATION_TIMEOUT_S = 0.05, 300.0


def arbitrated_campaign(runner, plane: Optional[ControlPlane], fleet, rows,
                        pace_s: float = 0.5, capacity_s: float = 2.0,
                        windows: tuple = ARBITRATION_TRAFFIC,
                        settle_s: float = 30.0, on_step=None) -> dict:
    """Run the train+serve arbitration on every rank: ``runner`` is this
    rank's ``LocalElasticJob`` of :func:`flagship_arbitrated_job`; on rank
    0, ``plane`` its arbitration plane, ``fleet`` a single-shot
    ``ServingFleet`` at one replica (built with ``kv=plane.coord``, so its
    ``/metrics`` address is published where the plane's scraper discovers
    it) and ``rows`` the token rows its traffic sends (None elsewhere).
    ``pace_s`` floors a step's period on rank 0 (room for the shared host
    and card between the trainer's steps), ``capacity_s`` is the
    closed-loop capacity run's length, ``windows`` the Poisson windows and
    ``settle_s`` how long the last may run on for the rebalance to land.

    The trainer steps at world 1 while system pods hold node1's and
    node2's cards; after ARBITRATION_WORLD_STEPS live steps rank 0 records
    the
    world's median tokens/s into the job's curve (``CurveStore``, the
    first step of a world left out) and frees node1, and the goodput
    planner grows the trainer to 2; after as many steps at world 2 it
    records that world and frees node2.  Then a director thread on rank 0
    measures the fleet's closed-loop capacity C, submits the fleet as an
    elastic ``ServingJob`` of 1 to 2 one-card replicas (the controller
    arbitrates it: the goodput planner owns its dial, the SLO policy,
    fed by the scraped ``FleetView``, only observes, records its capacity
    curve and hints), follows its Running pods with ``scale_to`` as
    rank 0's ``LocalElasticJob`` follows the trainer's, and sends the
    Poisson windows, the first starting a scraped window before the
    submission; the last runs on until the trainer is back at 1 and the
    fleet at 2.  The scraped view is held to the fleet's own ``stats()``
    once, inside the window ARBITRATION_COMPARE names.  The
    alert drills follow: an SLO breach (every replica's objective set to
    1 µs under trickle traffic) against a ``BurnRateRule`` evaluated every
    fast window, then the fleet's ``/metrics`` shut against a
    ``TargetDownRule`` over sweeps of the stopped scraper.  The trainer
    steps until the director is done (``LocalElasticJob.run(until=)``):
    tasks it never leased stay queued.  ``on_step(step, loss, world)``
    runs first, on every rank.

    Returns the run's ``RunReport`` on every rank as ``report`` with each
    step's ``(world, live, ms)`` as ``steps``, and on rank 0 what the
    gates read: the curves, C, each window's tally and latencies, the
    compared stats, the ticks (each planning tick's mode, marginals, diff
    and actuated target, and whether the planner re-run on the tick's
    recorded inputs gave the same plan), the trainer's and the fleet's
    resizes with their times, the hints, the card samples, the sampled
    requests' rows and answers, the alert drills and the scraper's sweep
    and staleness figures."""
    import statistics
    import threading

    from edl_tpu_torch.api.types import (JobPhase, ResourceRequirements,
                                         ServingJob, ServingSpec)
    from edl_tpu_torch.observability.goodput import (CurveStore, ScalingCurve,
                                                     load_curve)
    from edl_tpu_torch.observability.metrics import get_registry
    from edl_tpu_torch.observability.scrape import (AlertEngine,
                                                    BurnRateRule,
                                                    TargetDownRule)
    from edl_tpu_torch.runtime.serving import PoissonTraffic
    from edl_tpu_torch.scheduler.planner import PlannedJob, plan_cluster

    trainer = runner.trainer
    on_card = trainer.device.type == "cuda"
    steps: list = []
    real_step = trainer.step

    def timed(batch):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real_step(batch)
        if on_card:
            torch.cuda.synchronize()
        steps.append(dict(world=trainer.world_size, live=trainer.live,
                          ms=1e3 * (time.perf_counter() - t0)))
        return loss

    trainer.step = timed
    if plane is None:
        report = runner.run(on_step=on_step)
        trainer.step = real_step
        return dict(report=report, steps=steps)

    t_origin = time.monotonic()
    tokens = runner.batch_size * int(np.asarray(rows).shape[1])
    ctl, cluster = plane.controller, plane.cluster
    auto, scaler = ctl.autoscaler, ctl.serving_scaler
    uid_train = plane.job.full_name
    uid_fleet = f"default/{ARBITRATION_FLEET_JOB}"
    store = CurveStore(plane.coord, uid_train)
    out: dict = dict(curve_points=[], hints=[], fleet_resizes=[],
                     card_samples=[], windows={}, errors=[], step_ends=[])
    measured = threading.Event()
    director_done = threading.Event()
    stop = threading.Event()
    recorded: set = set()
    last_end = [time.monotonic()]

    def rel(t: float) -> float:
        return round(t - t_origin, 4)

    # -- the harness's side of the trainer: curve points, card releases ----

    def step_hook(step: int, loss, world: int) -> None:
        if on_step is not None:
            on_step(step, loss, world)
        out["step_ends"].append((rel(time.monotonic()), world))
        run = []
        for st in reversed(steps):
            if st["world"] != world or not st["live"]:
                break
            run.append(st["ms"])
        if world not in recorded and len(run) >= ARBITRATION_WORLD_STEPS:
            ms = statistics.median(run[:-1])  # a world's first step left out
            tok_s = tokens / (ms / 1e3)
            store.record(world, tok_s)
            recorded.add(world)
            out["curve_points"].append((world, round(ms, 3), round(tok_s, 1),
                                        rel(time.monotonic())))
            cluster.remove_system_pod(f"hold-node{world}")
            if world == 2:
                measured.set()
        rest = pace_s - (time.monotonic() - last_end[0])
        if rest > 0:
            time.sleep(rest)
        last_end[0] = time.monotonic()

    # -- the fleet's hints, its pods, and the card accounting --------------

    def fleet_hint(uid, n, source):
        out["hints"].append((source, uid, int(n), rel(time.monotonic())))
        if uid == uid_fleet:
            fleet.hint(int(n))

    scaler.hint_sink = lambda uid, n: fleet_hint(uid, n, "slo_policy")
    auto.hint_sink = lambda uid, n: fleet_hint(uid, n, "planner")

    def follow() -> None:
        while not stop.wait(ARBITRATION_FOLLOW_S):
            try:
                n = sum(p.phase.value == "Running" for p in
                        cluster.list_pods(job_uid=uid_fleet, role="server"))
                if n and n != fleet.replicas_active():
                    t0 = time.monotonic()
                    before = fleet.replicas_active()
                    fleet.scale_to(n)
                    out["fleet_resizes"].append((before, n, rel(t0),
                                                 rel(time.monotonic())))
            except Exception as exc:
                out["errors"].append(f"follow: {exc!r}")
                return

    def count_cards() -> None:
        while not stop.wait(ARBITRATION_FOLLOW_S):
            pods = cluster.list_pods()
            running = [p for p in pods if p.phase.value == "Running"]
            out["card_samples"].append((
                rel(time.monotonic()),
                sum(p.gpu_limit for p in running
                    if p.job_uid == uid_train),
                sum(p.gpu_limit for p in running
                    if p.job_uid == uid_fleet),
                sum(p.gpu_limit for p in running if not p.job_uid),
                sum(p.phase.value == "Pending" for p in pods)))

    # -- the director --------------------------------------------------------

    def closed_loop(seconds: float) -> float:
        inflight: list = []
        served, i = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            while len(inflight) < 2 * fleet.max_batch_size:
                inflight.append(fleet.submit((rows[i % len(rows)],)))
                i += 1
            inflight.pop(0).wait(60)
            served += 1
        elapsed = time.perf_counter() - t0
        for req in inflight:
            req.wait(60)
        return served / elapsed

    def compare(window_s: float) -> None:
        own = fleet.stats(window_s=window_s)
        seen = ctl.fleet_view.serving_stats(uid_fleet, window_s=window_s)
        out["compared"] = dict(
            at=rel(time.monotonic()), window_s=window_s,
            fleet=dict(qps=own.qps, p50_ms=own.p50_ms, p99_ms=own.p99_ms,
                       requests=own.requests_windowed),
            scraped=dict(qps=seen.qps, p50_ms=seen.p50_ms,
                         p99_ms=seen.p99_ms,
                         requests=seen.requests_windowed))

    def settled() -> bool:
        return (fleet.replicas_active() == 2
                and runner.desired_world_size() == 1
                and trainer.world_size == 1)

    def drills(capacity: float) -> None:
        view = ctl.fleet_view
        burn = BurnRateRule(job=uid_fleet,
                            fast_window_s=ARBITRATION_BURN_WINDOW_S,
                            slow_window_s=4 * ARBITRATION_BURN_WINDOW_S,
                            min_requests=5)
        engine = AlertEngine(view, rules=[burn])
        # the control: under trickle traffic, once the burst's backlog has
        # drained out of the fast window, the rule must be quiet
        quiet = PoissonTraffic(fleet, lambda i: (rows[i % len(rows)],),
                               qps=0.1 * capacity, seed=20)
        end = time.monotonic() + settle_s
        while True:
            quiet.run(ARBITRATION_BURN_WINDOW_S)
            control = [a.rule for a in engine.evaluate()
                       if a.rule == "slo_fast_burn"]
            if not control or time.monotonic() > end:
                break
        replicas = fleet.replicas()
        slos = [r.slo_p99_ms for r in replicas]
        for r in replicas:
            r.slo_p99_ms = 1e-3  # every request now breaches
        traffic = PoissonTraffic(fleet, lambda i: (rows[i % len(rows)],),
                                 qps=0.1 * capacity, seed=21)
        t0 = time.monotonic()
        fired_after = None
        for k in range(1, 3):
            traffic.run(ARBITRATION_BURN_WINDOW_S)
            if "slo_fast_burn" in [a.rule for a in engine.evaluate()]:
                fired_after = (k, round(time.monotonic() - t0, 3))
                break
        tally = traffic.await_all(timeout_s=60)
        for r, slo in zip(replicas, slos):
            r.slo_p99_ms = slo
        out["burn_drill"] = dict(control_firing=control,
                                 fired_after=fired_after, tally=tally,
                                 quiet=quiet.await_all(timeout_s=60))
        # the fleet's /metrics goes away: the scrape plane must notice
        ctl.scraper.stop()
        fleet._metrics_srv.shutdown()
        down = AlertEngine(view, rules=[TargetDownRule(
            down_after_failures=ARBITRATION_DOWN_AFTER)])
        due_sweeps, fired = 0, None
        deadline = time.monotonic() + 60
        while fired is None and time.monotonic() < deadline:
            rep = ctl.scraper.sweep()
            if rep["due"]:
                due_sweeps += 1
            if any(a.rule == "scrape_target_down" for a in down.evaluate()):
                fired = due_sweeps
                break
            time.sleep(ctl.scraper.interval_s / 2)
        out["down_drill"] = dict(fired_at_sweep=fired,
                                 states=ctl.scraper.target_states())

    def submit(capacity: float) -> None:
        job = ServingJob(name=ARBITRATION_FLEET_JOB, spec=ServingSpec(
            min_replicas=1, max_replicas=2, slo_p99_ms=ARBITRATION_SLO_MS,
            target_qps_per_replica=ARBITRATION_TARGET_SHARE * capacity,
            max_batch_size=ARBITRATION_BATCH,
            max_queue_ms=ARBITRATION_QUEUE_MS,
            resources=ResourceRequirements(
                requests={"cpu": "1"}, limits={"nvidia.com/gpu": "1"})))
        out["submitted_at"] = rel(time.monotonic())
        ctl.submit(job)
        deadline = time.monotonic() + 30
        while ctl.phase(job) != JobPhase.RUNNING:
            if time.monotonic() > deadline:
                raise RuntimeError(f"fleet job {ctl.phase(job)}")
            time.sleep(0.02)
        out["observe_only"] = uid_fleet in scaler.observe_only
        deadline = time.monotonic() + 5
        while uid_fleet not in auto.jobs and time.monotonic() < deadline:
            time.sleep(0.02)  # the autoscaler takes it at its next tick
        out["in_autoscaler"] = uid_fleet in auto.jobs
        threads.append(threading.Thread(target=follow, daemon=True))
        threads[-1].start()

    def director() -> None:
        try:
            if not measured.wait(ARBITRATION_TIMEOUT_S):
                raise RuntimeError("the trainer's curve never got world 2")
            capacity = closed_loop(capacity_s)
            out["capacity"] = capacity
            # C's completions age out of the scraped window (and its last
            # scrape) before the first window's traffic starts
            time.sleep(2 * ARBITRATION_WINDOW_S + ARBITRATION_SCRAPE_S)
            sent, traffics = [], {}
            for k, (label, share, seconds) in enumerate(windows):
                traffic = PoissonTraffic(
                    fleet, lambda i: (rows[i % len(rows)],),
                    qps=share * capacity, seed=11 + k)
                timer = None
                if label == ARBITRATION_COMPARE[0]:
                    timer = threading.Timer(
                        ARBITRATION_COMPARE[1] * seconds, compare,
                        args=(ARBITRATION_WINDOW_S,))
                    timer.start()
                t0 = time.monotonic()
                if k == 0:
                    # the fleet is already serving when its job arrives:
                    # the first window runs a full scraped window before
                    # the submission, so the SLO policy's first look at
                    # the arbitrated fleet sees the window's rate
                    lead = ARBITRATION_WINDOW_S + 2 * ARBITRATION_SCRAPE_S
                    first = threading.Thread(target=traffic.run,
                                             args=(lead + seconds,))
                    first.start()
                    time.sleep(lead)
                    submit(capacity)
                    first.join()
                else:
                    traffic.run(seconds)
                if label == windows[-1][0]:
                    end = time.monotonic() + settle_s
                    while not settled() and time.monotonic() < end:
                        traffic.run(0.5)
                if timer is not None:
                    timer.join()
                out["windows"][label] = dict(
                    share=share, start=rel(t0), end=rel(time.monotonic()),
                    stats=dataclasses.asdict(fleet.stats(
                        window_s=min(time.monotonic() - t0,
                                     ARBITRATION_WINDOW_S))))
                traffics[label] = traffic
                sent.extend(traffic.sent)
            for label, traffic in traffics.items():
                out["windows"][label]["tally"] = traffic.await_all(
                    timeout_s=60)
            out["settled"] = settled()
            picked = [r for r in sent
                      if r.error is None][:ARBITRATION_SAMPLES]
            out["sampled"] = dict(
                ids=[int(r.id) for r in picked],
                tokens=np.stack([np.asarray(r.payload[0]) for r in picked]),
                answers=np.stack([np.asarray(r.result, np.float32)
                                  for r in picked]))
            drills(capacity)
        except Exception as exc:
            out["errors"].append(f"director: {exc!r}")
        finally:
            stop.set()
            director_done.set()

    threads = [threading.Thread(target=director, daemon=True),
               threading.Thread(target=count_cards, daemon=True)]
    for th in threads:
        th.start()
    report = runner.run(on_step=step_hook, until=director_done.is_set)
    trainer.step = real_step
    stop.set()
    for th in list(threads):
        th.join(30)

    # -- what the planner decided, re-run on each tick's recorded inputs ----
    planned = dict(auto.jobs)
    ticks = []
    for rec in list(auto.plan_records):
        cv = {u: (None if raw is None else ScalingCurve.from_json(raw))
              for u, raw in rec["curves"].items()}
        jobs = [PlannedJob(config=planned[u].config, parallelism=p,
                           pending=pend, pending_age=age,
                           shape_policy=planned[u].shape_policy)
                for u, (p, pend, age) in rec["jobs"].items()]
        again = plan_cluster(jobs, rec["resource"].copy(),
                             auto.max_load_desired, curves=cv.get,
                             objective="goodput")
        plan = rec["plan"]
        ticks.append(dict(
            t=rel(rec["t"]), mode=plan.mode,
            marginals={u: round(m, 3) for u, m in plan.marginals.items()},
            diff={u: d for u, d in plan.diff.items() if d},
            target=rec["target"],
            reclaims=[(r["victim"], r.get("for_job"), r["from"], r["to"],
                       r["reason"]) for r in plan.reclaims],
            audit_ok=(again.diff == plan.diff and again.mode == plan.mode
                      and again.reclaims == plan.reclaims
                      and again.preemptions == plan.preemptions
                      and again.marginals == plan.marginals)))
    reg = get_registry()
    sweep_h = reg.histogram("scrape_sweep_seconds")
    stale_h = reg.histogram("scrape_staleness_seconds")
    curves = {u: (None if load_curve(plane.coord, u) is None
                  else load_curve(plane.coord, u).summary())
              for u in (uid_train, uid_fleet)}
    out.update(
        report=report, steps=steps, ticks=ticks, curves=curves,
        trainer_resizes=[(report.world_sizes[s - 1] if s else 1,
                          report.world_sizes[s], out["step_ends"][s][0]
                          - report.resize_seconds[i])
                         for i, s in enumerate(report.resize_steps)],
        sweeps=dict(n=sweep_h.count(), mean_ms=round(
            1e3 * sweep_h.sum() / max(sweep_h.count(), 1), 3)),
        staleness=dict(n=stale_h.count(), mean_ms=round(
            1e3 * stale_h.sum() / max(stale_h.count(), 1), 3)),
        modes=[(rel(t), m) for t, m in list(auto.mode_log)],
        serving_plans=list(scaler.plan_history),
        fleet_prewarm=dict(hits=fleet.prewarm_hits,
                           misses=fleet.prewarm_misses),
        fleet_job=uid_fleet, trainer_job=uid_train)
    return out


# -- the deployed control plane: a TrainingJob from its manifest -------------

#: the worker command of a kubelet job's trainer pods (the launcher exports
#: EDL_COORD_HOST/PORT and EDL_WORKER_NAME; EDL_TRAINER_MIN is the job's)
KUBELET_ENTRY = ("python -m edl_tpu_torch.runtime.multihost_worker"
                 " --coord $EDL_COORD_HOST:$EDL_COORD_PORT"
                 " --name $EDL_WORKER_NAME --min-members $EDL_TRAINER_MIN")


def kubelet_job_manifest(name: str, port: int, ckpt_dir: str,
                         worker_args: str, env: dict) -> dict:
    """The ``TrainingJob`` manifest a user submits for an elastic job of
    supervised multi-process workers: fault tolerant, 1 to 2 trainers of
    one card each, the coordinator on ``port``, each
    trainer pod running ``KUBELET_ENTRY`` with its generations under
    ``ckpt_dir`` and ``worker_args`` (model, depth, device, timeouts) after
    it, and ``env`` the trainers' environment (the ``EDL_MH_*`` knobs)."""
    return {
        "apiVersion": "edl.tpu/v1",
        "kind": "TrainingJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {
            "image": "edl-tpu-job:latest",
            "fault_tolerant": True,
            "port": port,
            "passes": 1,
            "trainer": {
                "entrypoint": (f"{KUBELET_ENTRY} --ckpt-dir {ckpt_dir} "
                               f"{worker_args}"),
                "min_instance": 1,
                "max_instance": 2,
                "env": {k: str(v) for k, v in env.items()},
                "resources": {"requests": {"cpu": "1", "memory": "1Gi"},
                              "limits": {"cpu": "2", "memory": "8Gi",
                                         "nvidia.com/gpu": "1"}},
            },
        },
    }


def _log_lines(paths) -> dict:
    """Every line of each pod log, by pod name."""
    out = {}
    for path in paths:
        with open(path, errors="replace") as f:
            out[os.path.basename(path)[:-len(".log")]] = f.read().splitlines()
    return out


def log_field(line: str, key: str) -> str:
    """The value of ``key=value`` in a log line."""
    return line.split(f"{key}=", 1)[1].split()[0]


def step_records(lines) -> list[dict]:
    """Every ``step N world=W ms=.. wall=.. launches=a,b,c loss=..`` line
    a supervised multi-process worker logged, parsed."""
    return [dict(step=int(ln.split(" step ", 1)[1].split()[0]),
                 world=int(log_field(ln, "world")),
                 ms=float(log_field(ln, "ms")),
                 wall=float(log_field(ln, "wall")),
                 launches=[int(x) for x in
                           log_field(ln, "launches").split(",")],
                 loss=float(ln.rsplit("loss=", 1)[1]))
            for ln in lines
            if " step " in ln and " loss=" in ln and "world=" in ln]


def kubelet_records(lines: dict) -> dict:
    """The supervised workers' records in their pod logs: every
    ``step``/``entering world``/``saved generation``/``done``/``devices
    ready``/``world_phases`` line, and whether each supervisor initialised
    CUDA, parsed."""
    steps, entries, saved, done, cuda = [], [], {}, {}, {}
    ready, phases, save_ms = [], [], []
    for pod, text in lines.items():
        steps += [dict(rec, pod=pod) for rec in step_records(text)]
        for ln in text:
            if "entering world epoch=" in ln:
                entries.append(dict(
                    pod=pod, epoch=int(log_field(ln, "epoch")),
                    world=int(log_field(ln, "world")),
                    digest=(log_field(ln, "digest") if "digest=" in ln
                            else ""),
                    step=int(ln.rsplit("step=", 1)[1])))
            elif "saved generation " in ln:
                gen = ln.split("saved generation ", 1)[1].split()[0]
                saved[gen] = (int(log_field(ln, "step")),
                              log_field(ln, "digest") if "digest=" in ln
                              else "")
                save_ms.append(float(log_field(ln, "ms")))
            elif "] done at step " in ln:
                done[pod] = int(ln.split("] done at step ", 1)[1].split()[0])
            elif "] supervisor cuda initialized " in ln:
                cuda[pod] = ln.rsplit(" ", 1)[1] == "True"
            elif "] devices ready epoch=" in ln:
                ready.append(dict(pod=pod,
                                  epoch=int(log_field(ln, "epoch")),
                                  wall=float(log_field(ln, "wall"))))
            elif "] world_phases epoch=" in ln:
                phases.append((pod, ln.split("] world_phases ", 1)[1]))
    return dict(steps=steps, entries=entries, saved=saved, done=done,
                supervisor_cuda=cuda, ready=ready, phases=phases,
                save_ms=save_ms)


def _gen_epoch(gen: str) -> int:
    """``gen-E[.npz]`` or ``mid-E-S[.npz]`` → E."""
    return int(gen.split(".")[0].split("-")[1])


def _group_alive(pgid: int) -> bool:
    """Whether any process of group ``pgid`` runs (a zombie does not)."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            return True
    return False


def kubelet_campaign(store, work_dir: str, manifest: dict, *,
                     kubelet_env: dict, timeout_s: float = 420.0) -> dict:
    """Run ``manifest`` (:func:`kubelet_job_manifest`) from its CR to
    Succeeded through the port's deployed control plane, as real pod
    processes on this machine, and check it on the way.

    The cluster is a ``FakeCluster`` with one node of two
    ``nvidia.com/gpu``; a ``Controller`` runs it with a ``ProcessKubelet``
    (pod logs and volumes under ``work_dir``, ``kubelet_env`` over each
    pod's environment) and a ``TrainingJobSyncLoop`` polls ``store`` (any
    object with ``create_training_job_cr``, ``list_training_job_crs``,
    ``get_training_job_cr``, ``patch_training_job_status`` and
    ``delete_training_job_cr``).  Gates, each raising ``AssertionError``:

    a. the sync loop adds the CR; the kubelet spawns a coordinator pod and
       a trainer pod running the jobparser's ``edl_tpu_torch`` modules, and
       no command or entry names the JAX package's;
    b. a world of 1 forms and trains;
    c. the autoscaler, started only then, grows the job to 2: a second pod
       joins and a world of 2 forms;
    d. a ``FaultPlanEngine`` ``KillTrainer`` through the kubelet SIGKILLs
       one trainer pod's process group; the reaper reports it Failed, the
       Job controller replaces it, and a world of 2 forms again, every
       world starting bitwise from the newest generation saved before it
       (its digest);
    e. a ``KillCoordinator`` through the kubelet kills the coordinator pod,
       which respawns on its per-job state file; the queue drains exactly
       once;
    f. the surviving workers end ``done`` (their supervisors never
       initialised CUDA), their pods Succeeded (exit 0) and the CR's
       recorded status ``Succeeded``;
    g. every loss is finite and the loss falls from the first step to the
       last;
    h. deleting the CR tears the job down through the sync loop: no live
       pod, no process of any pod's group left.

    Returns the timings (wall seconds: submit → world 1's first step, the
    grow tick → world 2's first step, the kill → the re-formed world's
    first step, the coordinator kill → the next completed task), the
    spawned commands, the per-step records (``launches`` by kernel), the
    queue's stats and the ``cli`` status and list tables after (c) and at
    the end."""
    import random

    from edl_tpu_torch.cli import format_job_list, format_status
    from edl_tpu_torch.cluster.base import PodPhase
    from edl_tpu_torch.cluster.exec_kubelet import ProcessKubelet
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.controller.sync import TrainingJobSyncLoop
    from edl_tpu_torch.coord.client import CoordClient, CoordError
    from edl_tpu_torch.runtime.faults import (FaultContext, FaultPlan,
                                              FaultPlanEngine,
                                              KillCoordinator, KillTrainer)

    name = manifest["metadata"]["name"]
    ns = manifest["metadata"].get("namespace", "default")
    port = int(manifest["spec"]["port"])
    tasks = int(manifest["spec"]["trainer"]["env"]["EDL_MH_SHARDS"])
    cluster = FakeCluster()
    cluster.add_node("host0", cpu_milli=32_000, memory_mega=256_000, gpus=2)
    controller = Controller(cluster, autoscaler_loop_seconds=0.3,
                            updater_convert_seconds=0.3,
                            updater_confirm_seconds=0.2)
    kubelet = ProcessKubelet(cluster, work_dir, env_overrides=kubelet_env)
    sync = TrainingJobSyncLoop(store, controller, poll_seconds=0.2)
    deadline = time.monotonic() + timeout_s
    out: dict = {"tasks": tasks}

    def records() -> dict:
        import glob

        return kubelet_records(_log_lines(sorted(glob.glob(os.path.join(
            work_dir, "logs", f"{name}-trainer-*.log")))))

    def phase() -> str:
        cr = store.get_training_job_cr(name, namespace=ns) or {}
        return (cr.get("status") or {}).get("phase", "")

    def wait(cond, what: str, poll_s: float = 0.1):
        while time.monotonic() < deadline:
            got = cond()
            if got:
                return got
            time.sleep(poll_s)
        tails = {pod: text[-6:] for pod, text in _log_lines(sorted(
            os.path.join(work_dir, "logs", f) for f in os.listdir(
                os.path.join(work_dir, "logs")))).items()}
        raise AssertionError(f"never: {what}; phase {phase()!r}, live pods "
                             f"{kubelet.live_pods()}, logs {tails}")

    def stats():
        try:
            c = CoordClient("127.0.0.1", port, timeout=2.0,
                            reconnect_window_s=1.0)
            try:
                return c.stats()
            finally:
                c.close()
        except (OSError, CoordError):
            return None

    def spawned(role: str) -> list:
        return [s.pod for s in kubelet.spawned if f"-{role}-" in s.pod]

    coord_probe = None
    try:
        t_submit = time.time()
        store.create_training_job_cr(manifest)
        sync.start()
        # (a) the CR added; the jobparser's commands spawned
        wait(lambda: spawned("coordinator") and spawned("trainer"),
             "a coordinator pod and a trainer pod spawned")
        want = {"coordinator": ["-m", "edl_tpu_torch.coord.server"],
                "trainer": ["-m", "edl_tpu_torch.runtime.launcher",
                            "start_trainer"]}
        for s in kubelet.spawned:
            role = "trainer" if "-trainer-" in s.pod else "coordinator"
            text = " ".join(s.command) + " " + s.entry
            if s.command[1:] != want[role] or "edl_tpu." in text:
                raise AssertionError(f"pod {s.pod} runs {s.command} "
                                     f"{s.entry!r}")
        out["commands"] = {role: " ".join(cmd) for role, cmd in want.items()}
        out["entry"] = kubelet.spawned[-1].entry
        # (b) world 1 trains
        first1 = wait(lambda: [s for s in records()["steps"]
                               if s["world"] == 1], "world 1's first step")
        out["submit_to_world1_s"] = min(s["wall"] for s in first1) - t_submit
        # (c) the autoscaler grows the job 1 -> 2
        job = controller.jobs()[0]
        controller.start()
        wait(lambda: cluster.get_trainer_parallelism(job) == 2,
             "the autoscaler grows the job to 2", poll_s=0.02)
        t_grow = time.time()
        first2 = wait(lambda: [s for s in records()["steps"]
                               if s["world"] == 2 and s["wall"] > t_grow],
                      "world 2's first step")
        out["grow_to_world2_s"] = min(s["wall"] for s in first2) - t_grow
        out["status_after_grow"] = (format_status(store, ns, name) + "\n"
                                    + format_job_list(store))
        # (d) KillTrainer through the kubelet
        coord_probe = CoordClient("127.0.0.1", port, timeout=2.0)
        ctx = FaultContext(cluster=cluster, job=job, kubelet=kubelet,
                           coord=coord_probe, rng=random.Random(0))
        engine = FaultPlanEngine(FaultPlan(actions=[
            KillTrainer(at_time_s=0.0)], seed=0), ctx)
        pods_before = set(spawned("trainer"))
        t_kill = time.time()
        engine.tick()
        wait(lambda: (engine.tick(), "kill_trainer" in engine.recovered)[1],
             "the killed trainer pod replaced (reaper, Job controller)")
        victims = sorted(p.name for p in cluster.list_pods(
            job_uid=job.full_name, role="trainer")
            if p.phase == PodPhase.FAILED)
        replacement = wait(lambda: sorted(set(spawned("trainer"))
                                          - pods_before),
                           "a replacement trainer pod spawned")
        reformed = wait(lambda: [s for s in records()["steps"]
                                 if s["world"] == 2 and s["wall"] > t_kill
                                 and s["pod"] in replacement],
                        "the replacement trains in a world of 2")
        out["kill_to_world2_s"] = min(s["wall"] for s in reformed) - t_kill
        out["victims"], out["replacement"] = victims, replacement
        # (e) KillCoordinator through the kubelet
        before = wait(lambda: (lambda s: s if s and s.done else None)(
            stats()), "a completed task before the coordinator kill")
        coords_before = set(spawned("coordinator"))
        engine = FaultPlanEngine(FaultPlan(actions=[
            KillCoordinator(at_time_s=0.0)], seed=0), ctx)
        t_ckill = time.time()
        engine.tick()
        wait(lambda: (engine.tick(),
                      "kill_coordinator" in engine.recovered)[1],
             "the coordinator answers again")
        respawned = sorted(set(spawned("coordinator")) - coords_before)
        if not respawned:
            raise AssertionError("the coordinator pod was not respawned")
        after = wait(lambda: (lambda s: s if s and s.done > before.done
                              else None)(stats()),
                     "a task completed after the coordinator kill",
                     poll_s=0.05)
        out["coord_kill_to_task_s"] = time.time() - t_ckill
        out["coord_done"] = (before.done, after.done)
        out["coord_respawned"] = respawned
        # (f) drained, Succeeded, recorded; the queue read while the
        # coordinator lives (the job's success releases its pods)
        seen = [after]

        def succeeded() -> bool:
            if phase() == "Succeeded":
                return True
            got = stats()
            if got is not None:
                seen.append(got)
            return False

        wait(succeeded, "the CR's status Succeeded", poll_s=0.2)
        out["t_succeeded"] = time.time()
        final = seen[-1]
        rec = records()
        out["stats"] = final
        out["records"] = rec
        # the trainer pods' states as the CR recorded them with Succeeded
        pods = {n: st for rs in (store.get_training_job_cr(
            name, namespace=ns)["status"]["replica_statuses"])
            if rs["resource_type"] == "TRAINER"
            for n, st in rs["resource_states"].items()}
        out["pods"] = dict(sorted(pods.items()))
        out["exit_codes"] = dict(sorted(kubelet.exit_codes.items()))
        trained_twice = [pod for pod, text in _log_lines(
            os.path.join(work_dir, "logs", f"{p}.log")
            for p in spawned("trainer")).items()
            if any("trained twice" in ln for ln in text)]
        if (final is None or final.done != tasks or final.todo
                or final.leased or final.dropped or trained_twice):
            raise AssertionError(f"the queue of {tasks} tasks did not "
                                 f"drain exactly once: {final}, "
                                 f"{trained_twice}")
        ended = sorted(set(spawned("trainer")) - set(victims))
        if (sorted(rec["done"]) != ended
                or any(rec["supervisor_cuda"].get(p) is not False
                       for p in ended)
                or any(pods.get(p) != "Succeeded"
                       or kubelet.exit_codes.get(p) != 0 for p in ended)
                or any(pods.get(p) != "Failed" for p in victims)):
            raise AssertionError(f"pods {pods}, exits {kubelet.exit_codes}, "
                                 f"workers done {rec['done']}, victims "
                                 f"{victims}")
        # every world starts bitwise from the newest generation before it
        for e in rec["entries"]:
            older = [pair for gen, pair in rec["saved"].items()
                     if (gen.startswith("gen-")
                         and _gen_epoch(gen) <= e["epoch"])
                     or (gen.startswith("mid-")
                         and _gen_epoch(gen) < e["epoch"])]
            if (e["step"], e["digest"]) != max(older, default=None):
                raise AssertionError(
                    f"{e['pod']} entered world epoch {e['epoch']} at "
                    f"{(e['step'], e['digest'])}, the newest generation "
                    f"is {max(older, default=None)}")
        worlds = sorted({(e["epoch"], e["world"]) for e in rec["entries"]})
        sizes = [w for _, w in worlds]
        if sizes[:1] != [1] or 2 not in sizes:
            raise AssertionError(f"worlds {worlds}")
        out["worlds"] = worlds
        # (g) finite losses, falling
        steps = sorted(rec["steps"], key=lambda s: s["wall"])
        losses = [s["loss"] for s in steps if s["loss"] != 0]
        if (not losses or not all(np.isfinite(losses))
                or not losses[-1] < losses[0]):
            raise AssertionError(f"losses {losses[:3]} .. {losses[-3:]}")
        out["losses"] = (losses[0], losses[-1])
        out["status_end"] = (format_status(store, ns, name) + "\n"
                             + format_job_list(store))
        out["t_submit"] = t_submit
        out["spawns"] = [(s.pod, s.wall) for s in kubelet.spawned]
        # (h) the CR deleted: the sync loop tears the job down
        groups = [s.pid for s in kubelet.spawned]
        store.delete_training_job_cr(name, namespace=ns)
        wait(lambda: not controller.jobs() and not kubelet.live_pods(),
             "the job torn down", poll_s=0.1)
        wait(lambda: not any(_group_alive(g) for g in groups),
             "every pod's process group gone", poll_s=0.1)
        out["groups"] = len(groups)
    finally:
        if coord_probe is not None:
            coord_probe.close()
        sync.stop()
        controller.stop()
        kubelet.stop()
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
