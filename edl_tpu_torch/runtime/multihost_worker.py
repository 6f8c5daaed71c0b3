"""Runnable elastic multi-process worker (one process = one host) — the
port of edl_tpu.runtime.multihost_worker.

``python -m edl_tpu_torch.runtime.multihost_worker --coord HOST:PORT
--name w0 --ckpt-dir DIR`` joins the job's membership, forms successive
torch.distributed worlds with whoever else is live (see
:mod:`edl_tpu_torch.runtime.multihost`), and trains the port's
:class:`~edl_tpu_torch.runtime.elastic.ElasticTrainer` over each world's
process group — replicated data parallel, or fsdp-sharded — leasing data
shards from the task queue.

``--model`` picks the architecture that rides the fault path:

* ``mlp`` (default) — a deterministic synthetic regression MLP; the
  cheapest body for the many multi-process scenarios.
* ``transformer`` — the decoder family (RMSNorm/RoPE/GQA/SwiGLU,
  :mod:`edl_tpu_torch.models.transformer`) on a synthetic next-token
  task, so crash/reform/late-join/fsdp-restore are proven on the
  architecture users run.  ``--model-config`` selects tiny (CPU tests) /
  flagship / large; flash attention is on for a card and a bf16 config.

``--device`` is the world children's device: ``cuda`` (default) gives
rank r ``cuda:(r mod device count)`` and a NCCL world; ``cuda:0`` puts
every rank on one card and ``cpu`` is for the tests, both over gloo
(NCCL refuses two ranks on one GPU).  The supervisor itself never
initialises CUDA.

Exit codes: 0 = queue drained (job complete), 4 = evicted, >0 = error.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
import zlib
from dataclasses import dataclass

# Opt-in suite hygiene, armed BEFORE the heavy imports below: a harness
# that spawned this worker dying (even kill -9) must not orphan the
# supervisor.  The world child already dies with the supervisor
# (PR_SET_PDEATHSIG chain in multihost._die_with_parent), so the whole
# tree reaps.  Opt-in because a production pod's supervisor must survive
# launcher re-execs.
if os.environ.get("EDL_MH_DIE_WITH_PARENT"):
    try:
        import ctypes
        import signal as _signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, _signal.SIGKILL)
    except OSError:  # pragma: no cover - non-glibc platform
        pass
    if os.getppid() == 1:  # parent died before the prctl landed
        os._exit(1)

import numpy as np

from edl_tpu_torch.runtime.data import (FileShardStore, ShardRegistry,
                                        ensure_seeded, fetch_payload)
from edl_tpu_torch.runtime.multihost import (
    WorldHandle,
    load_numpy_tree,
    resolve_world_device,
    run_elastic_worker,
    save_numpy_tree,
)

# Scale knobs come from env so the multi-process tests can shrink the job
# without plumbing flags through every layer.
N_EXAMPLES = int(os.environ.get("EDL_MH_EXAMPLES", "4096"))
SHARDS = int(os.environ.get("EDL_MH_SHARDS", "32"))
LOCAL_BATCH = int(os.environ.get("EDL_MH_BATCH", "32"))
#: per-step sleep — lets tests pace the queue drain so mid-job events
#: (joins, kills) land deterministically while the job is still running
STEP_SLEEP_S = float(os.environ.get("EDL_MH_STEP_SLEEP", "0"))
#: mid-world checkpoint cadence in steps (0 = world boundaries only): a
#: crash then loses at most this many steps instead of the whole world's
#: progress (the generation protocol's in-world extension,
#: multihost.publish_mid_state)
CKPT_EVERY = int(os.environ.get("EDL_MH_CKPT_EVERY", "0"))
#: stall injection for watchdog drills: "worker:step[:seconds]" wedges
#: that worker's train loop at that step (default: effectively forever —
#: only the supervisor's StallWatchdog escalation can end it).  A marker
#: file in the ckpt dir makes the stall fire ONCE per job, so the
#: reformed world trains through the step it wedged at.
STALL_SPEC = os.environ.get("EDL_MH_STALL", "")
#: "1": every generation save and every world entry prints a CRC32 digest
#: of the parameters, so a harness can check a restore is bitwise the save
DIGEST = os.environ.get("EDL_MH_DIGEST", "") == "1"
SEED = 7


def _parse_stall(spec: str):
    """'worker:step[:seconds]' → (worker, step, seconds) or None.
    Malformed specs parse to None (a broken drill knob must not crash
    the training loop it was meant to wedge)."""
    if not spec:
        return None
    try:
        parts = spec.split(":")
        return (parts[0], int(parts[1]),
                float(parts[2]) if len(parts) > 2 else 3600.0)
    except (IndexError, ValueError):
        return None


# -- the model families that ride the fault path -----------------------------
#
# A task bundles everything model-specific: deterministic dataset, the
# model (seeded init), per-example weighted loss, and the zero-batch shape
# a data-less worker feeds the collective step.  Tasks are small frozen
# dataclasses so the spawn-context world children can unpickle them.


def _weighted_mean(per_example, w):
    """Σ per_example·w over the global batch / max(Σ w, 1), from this
    rank's slice: the denominator is all-reduced over the data group by
    :func:`~edl_tpu_torch.parallel.tensor_parallel.weight_total`, so the
    trainer's average over ranks is the global weighted mean."""
    from edl_tpu_torch.parallel.tensor_parallel import weight_total

    return (per_example * w).sum() / weight_total(w)


@dataclass(frozen=True)
class MlpTask:
    """Synthetic regression y = W*x: the cheap body for the many
    multi-process scenarios (tanh hidden layer, params w1/b1/w2/b2 named
    and oriented as the JAX task's, ``x @ w``)."""

    in_dim: int = 16
    out_dim: int = 4
    hidden: int = 64
    lr: float = 1e-2

    def make_dataset(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(SEED)
        x = rng.normal(size=(N_EXAMPLES, self.in_dim)).astype(np.float32)
        w_true = rng.normal(
            size=(self.in_dim, self.out_dim)).astype(np.float32)
        return x, x @ w_true

    def build(self, device, seed: int = 0):
        """The model: w uniform in ±1/sqrt(fan_in) from a generator seeded
        with ``seed`` on ``device``, b zeros."""
        import torch
        import torch.nn as nn

        gen = torch.Generator(device=device).manual_seed(seed)
        model = nn.Module()
        for i, (fan_in, fan_out) in enumerate(
                ((self.in_dim, self.hidden), (self.hidden, self.out_dim))):
            s = 1.0 / np.sqrt(fan_in)
            w = torch.rand(fan_in, fan_out, generator=gen, device=device)
            model.register_parameter(f"w{i + 1}", nn.Parameter(w * 2 * s - s))
            model.register_parameter(
                f"b{i + 1}", nn.Parameter(torch.zeros(fan_out, device=device)))
        return model

    def weighted_loss(self, model, batch):
        import torch

        x, y, w = batch
        h = torch.tanh(x @ model.w1 + model.b1)
        pred = h @ model.w2 + model.b2
        return _weighted_mean(((pred - y) ** 2).sum(-1), w)

    def empty_xy(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        return (np.zeros((n, self.in_dim), np.float32),
                np.zeros((n, self.out_dim), np.float32))


@dataclass(frozen=True)
class TransformerTask:
    """The decoder family (:mod:`edl_tpu_torch.models.transformer`) on a
    deterministic successor-token task — tokens are arithmetic sequences
    mod vocab, targets the next token, so a small model measurably learns
    and a reform that lost state is visible as a loss jump."""

    config_name: str = "tiny"
    seq: int = int(os.environ.get("EDL_MH_SEQ", "32"))
    lr: float = 3e-3
    #: the decoder's depth (0: the config's own); the width stays the
    #: config's
    n_layers: int = 0

    @property
    def cfg(self):
        import dataclasses

        from edl_tpu_torch.models import transformer as T

        cfg = {"tiny": T.TINY, "flagship": T.FLAGSHIP,
               "large": T.LARGE}[self.config_name]
        if self.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=self.n_layers)
        return cfg

    def make_dataset(self) -> tuple[np.ndarray, np.ndarray]:
        vocab = self.cfg.vocab_size
        rng = np.random.default_rng(SEED)
        starts = rng.integers(0, vocab, size=(N_EXAMPLES, 1))
        strides = rng.integers(1, 4, size=(N_EXAMPLES, 1))
        idx = np.arange(self.seq + 1)[None, :]
        seqs = (starts + strides * idx) % vocab
        return (seqs[:, :-1].astype(np.int32),
                seqs[:, 1:].astype(np.int32))

    def build(self, device, seed: int = 0):
        """The model from ``seed``; the flash kernels carry its attention
        on a card when the config computes in bf16."""
        import dataclasses

        import torch

        from edl_tpu_torch.models import transformer as T

        cfg = self.cfg
        flash = (torch.device(device).type == "cuda"
                 and cfg.dtype == torch.bfloat16)
        return T.Transformer(dataclasses.replace(cfg, use_flash=flash),
                             device=device, seed=seed)

    def weighted_loss(self, model, batch):
        import torch

        from edl_tpu_torch.models import transformer as T

        x, y, w = batch
        logits = T.apply(model, x)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, y.long()[..., None])[..., 0]
        return _weighted_mean((lse - tgt).mean(-1), w)

    def empty_xy(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        return (np.zeros((n, self.seq), np.int32),
                np.zeros((n, self.seq), np.int32))


def make_task(model: str, config_name: str = "tiny", n_layers: int = 0):
    if model == "mlp":
        return MlpTask()
    if model == "transformer":
        return TransformerTask(config_name=config_name, n_layers=n_layers)
    raise ValueError(f"unknown model {model!r}")


def _optimizer(lr: float = 1e-2):
    from edl_tpu_torch.runtime import optim

    return optim.adam(lr)


def _device(device: str):
    """This world rank's device for the ``--device`` choice (in a world
    child, under its process group)."""
    import torch.distributed as dist

    return resolve_world_device(device, dist.get_rank()
                                if dist.is_initialized() else 0)


def build_trainer(task, device, sharding: str = "replicated"):
    """An :class:`ElasticTrainer` of ``task``'s model over the world's
    process group: replicated data parallel, or fsdp over every rank."""
    from edl_tpu_torch.parallel.mesh import MeshSpec
    from edl_tpu_torch.runtime.elastic import ElasticTrainer

    spec = MeshSpec(dp=-1) if sharding == "replicated" \
        else MeshSpec(dp=1, fsdp=-1)
    return ElasticTrainer(task.weighted_loss, task.build(device),
                          _optimizer(task.lr), spec=spec,
                          param_sharding=sharding, devices=[device])


def host_state(trainer, step: int) -> dict:
    """A replicated trainer's whole state in host memory, as the generation
    files hold it: ``{"state": {checkpoint path: array}, "step": array}``
    (the paths :meth:`ElasticTrainer.whole_state` saves under)."""
    from edl_tpu_torch.runtime import checkpoint as ckpt

    flat = ckpt._snapshot({"params": trainer.state.params,
                           "opt": trainer.state.opt_state})
    return {"state": {k: v.numpy() for k, v in flat.items()},
            "step": np.asarray(step, np.int32)}


def params_digest(flat: dict) -> str:
    """CRC32 over the parameters of a host state's ``state`` dict, in path
    order: equal digests, bitwise equal parameters."""
    crc = 0
    for key in sorted(k for k in flat if k.startswith("['params']")):
        crc = zlib.crc32(np.ascontiguousarray(flat[key]).view(np.uint8), crc)
    return f"{crc:08x}"


def _trainer_digest(trainer) -> str:
    """:func:`params_digest` of the parameters a trainer holds (gathered
    whole on a sharded trainer: collective over its world)."""
    from edl_tpu_torch.interop import keystr
    from edl_tpu_torch.runtime.checkpoint import param_path

    return params_digest({keystr(("params",) + param_path(n)):
                          t.detach().cpu().numpy()
                          for n, t in trainer.full_params().items()})


def init_state(task=MlpTask(), device: str = "cuda",
               sharding: str = "replicated"):
    """The cold start: the task's model from seed 0, no optimizer state.
    Replicated: a host state (:func:`host_state`); fsdp: a live sharded
    trainer over this world (every rank builds the same seeded init)."""
    dev = _device(device)
    if sharding == "fsdp":
        return {"trainer": build_trainer(task, dev, "fsdp"),
                "step": np.asarray(0, np.int32)}
    from edl_tpu_torch.interop import keystr
    from edl_tpu_torch.runtime.checkpoint import param_path

    model = task.build(dev)
    return {"state": {keystr(("params",) + param_path(n)):
                      p.detach().cpu().numpy()
                      for n, p in model.named_parameters()},
            "step": np.asarray(0, np.int32)}


def load_state(path: str):
    """Module-level (picklable) load of a replicated generation for the
    supervisor's world children: a host state (:func:`host_state`)."""
    return load_numpy_tree(path)


def save_state(state, path: str, name: str = "") -> str:
    """A replicated generation: :func:`save_numpy_tree`, with one line of
    its ms and bytes (and its digest under ``EDL_MH_DIGEST``)."""
    t0 = time.perf_counter()
    out = save_numpy_tree(state, path)
    ms = 1e3 * (time.perf_counter() - t0)
    digest = f" digest={params_digest(state['state'])}" if DIGEST else ""
    print(f"[{name}] saved generation {os.path.basename(out)} "
          f"step={int(state['step'])} ms={ms:.1f} "
          f"bytes={os.path.getsize(out)}{digest}", flush=True)
    return out


# -- the sharded (fsdp) generations: ElasticCheckpointer, layout-free --------


def sharded_save_state(state, path: str, name: str = "") -> str:
    """Collective save of a sharded trainer's generation: every rank calls
    it with the same path; the whole state is gathered leaf by leaf to
    rank 0, which writes it layout-free (one ElasticCheckpointer step).
    Idempotent: a generation already on disk is kept as it is (the
    replicated path's CAS-loses semantics), by rank 0's verdict."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

    trainer, step = state["trainer"], int(state["step"])
    t0 = time.perf_counter()
    ck = ElasticCheckpointer(path, max_to_keep=1)
    have = torch.tensor([ck.latest_step() is not None], dtype=torch.int32,
                        device=trainer.device)
    dist.broadcast(have, 0)
    digest = ""
    if not bool(have.item()):
        tree = trainer.whole_state()  # collective: a Snapshot on rank 0
        if trainer.rank == 0:
            ck.save(step, tree)
            if DIGEST:
                digest = " digest=" + params_digest(
                    {k: v.numpy() for k, v in tree.items()})
    ck.close()
    dist.barrier()  # no rank publishes the pointer before rank 0 wrote
    if trainer.rank == 0:
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(path) for f in files)
        print(f"[{name}] saved generation {os.path.basename(path)} "
              f"step={step} ms={1e3 * (time.perf_counter() - t0):.1f} "
              f"bytes={nbytes}{digest}", flush=True)
    return path


def sharded_load_state(path: str, task=MlpTask(), device: str = "cuda"):
    """Collective restore ONTO THE CURRENT WORLD'S LAYOUT: a fresh fsdp
    trainer over this world takes its own block of every leaf, whatever
    world size saved them.  A parse failure raises (this worker's world
    dies and the supervisor reforms) instead of sending one rank to an
    older step than its peers."""
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

    trainer = build_trainer(task, _device(device), "fsdp")
    ck = ElasticCheckpointer(path, max_to_keep=1)
    try:
        ck.restore({"params": trainer.state.params,
                    "opt": trainer.state.opt_state},
                   shardings=trainer, parse_fallback=False)
        step = ck.latest_step()
    finally:
        ck.close()
    return {"trainer": trainer, "step": np.asarray(step, np.int32)}


class LeasedBatchSource:
    """Non-blocking local batch source over task leases.

    Unlike :class:`~edl_tpu_torch.runtime.data.TaskLeaseBatches` (which
    sleeps on EMPTY), this never blocks: a worker with no shard still has
    to take part in the collective step with a zero-weight batch, or its
    peers would hang.
    """

    def __init__(self, coord, worker: str, fetch, batch_size: int,
                 task=MlpTask()) -> None:
        self._coord = coord
        self._worker = worker
        self._fetch = fetch
        self._bs = batch_size
        self._task = task
        self._arrays = None
        self._off = 0
        self._task_id = -1
        self.queue_done = False

    def next_local(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x, y, weights) — zero-weight batch when no data is available."""
        from edl_tpu_torch.coord.service import LeaseStatus

        if self._arrays is None and not self.queue_done:
            status, task_id, payload = self._coord.lease(self._worker)
            if status == LeaseStatus.DONE:
                self.queue_done = True
            elif status == LeaseStatus.OK:
                self._arrays = self._fetch(payload)
                self._off = 0
                self._task_id = task_id
        bx, by = self._task.empty_xy(self._bs)
        bw = np.zeros((self._bs,), np.float32)
        if self._arrays is None:
            return bx, by, bw
        x, y = self._arrays
        lo, hi = self._off, min(self._off + self._bs, x.shape[0])
        n = hi - lo
        bx[:n], by[:n], bw[:n] = x[lo:hi], y[lo:hi], 1.0
        self._off = hi
        self._coord.renew(self._task_id, self._worker)
        if hi >= x.shape[0]:
            self._coord.complete(self._task_id, self._worker)
            self._arrays = None
        return bx, by, bw

    def release(self) -> None:
        """Return any held lease to the queue (stop/teardown path)."""
        if self._arrays is not None:
            self._coord.release_worker(self._worker)
            self._arrays = None


def _global_batch(world: WorldHandle, local: tuple) -> tuple:
    """The world's global batch with this rank's rows in its slot.  The
    trainer reads only the slot of this rank's data coordinate (on a
    dp-only or fsdp-only mesh, its rank), so the other slots stay zero and
    no rank's rows move: the process-local assembly of the JAX task's
    ``make_array_from_process_local_data``."""
    import torch

    n, r = world.world_size, world.rank
    out = []
    for a in local:
        g = np.zeros((n * a.shape[0],) + a.shape[1:], a.dtype)
        g[r * a.shape[0]:(r + 1) * a.shape[0]] = a
        out.append(torch.from_numpy(g))
    return tuple(out)


def train_world(world: WorldHandle, state, should_stop, *, coord, name,
                registry, verbose=True, sharding="replicated",
                task=MlpTask(), checkpoint=None, heartbeat=None,
                ckpt_dir=None):
    """One world's training loop (runs in the world child).  Every step
    starts with one all-reduce of three numbers — this rank's stop vote,
    its not-done vote and its batch weight — so the decisions to stop (a
    membership change) or finish (the queue drained everywhere) are
    unanimous AT THE SAME STEP, and a step no rank has data for is
    skipped everywhere (Adam would move the params on zero gradients)."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.ops import flash_attention as fa

    dev = torch.device(world.device)
    if "trainer" in state:
        trainer = state["trainer"]
    else:
        trainer = build_trainer(task, dev, sharding)
        trainer.load_whole_state({
            k: torch.as_tensor(v)
            for k, v in state["state"].items()})
    nstep = int(state["step"])
    if verbose:
        # the entering-step line is what lets tests assert a late joiner
        # inherited trained state (step > 0) instead of cold-starting
        digest = f" digest={_trainer_digest(trainer)}" if DIGEST else ""
        print(f"[{name}] entering world epoch={world.epoch} "
              f"world={world.world_size}{digest} at step={nstep}",
              flush=True)

    fetch = functools.partial(fetch_payload, registry=registry)
    src = LeasedBatchSource(coord, name, fetch, LOCAL_BATCH, task)
    last_loss, stopped = None, False
    while True:
        local_stop = float(should_stop())
        local_done = float(src.queue_done)
        bx, by, bw = src.next_local()
        before = dict(fa.launches)
        t0 = time.perf_counter()
        votes = torch.tensor([local_stop, 1.0 - local_done,
                              float(bw.sum())], dtype=torch.float64,
                             device=dev)
        dist.all_reduce(votes)
        any_stop, not_done, weight = votes.tolist()
        loss = 0.0
        if weight > 0:
            loss = trainer.step(_global_batch(world, (bx, by, bw)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        if STEP_SLEEP_S:
            time.sleep(STEP_SLEEP_S)
        nstep += 1
        if heartbeat is not None:
            heartbeat(nstep)
        stall = _parse_stall(STALL_SPEC)
        if stall is not None and stall[0] == name and nstep >= stall[1]:
            # the quiet failure: the step completed (heartbeat sent),
            # then the loop wedges — no crash, no closed socket, just
            # silence.  Fires once per job (marker file) so the reformed
            # world trains through this step.
            marker = os.path.join(ckpt_dir or ".", f"stalled-{name}")
            if not os.path.exists(marker):
                open(marker, "w").close()
                print(f"[{name}] injecting stall at step {nstep} for "
                      f"{stall[2]}s", flush=True)
                time.sleep(stall[2])
        if verbose:
            launched = ",".join(str(fa.launches[k] - before[k])
                                for k in sorted(fa.launches))
            print(f"[{name}] step {nstep} world={world.world_size} "
                  f"ms={ms:.2f} wall={time.time():.3f} "
                  f"launches={launched} loss={float(loss):.5f}", flush=True)
        last_loss = float(loss)
        if checkpoint is not None and CKPT_EVERY and nstep % CKPT_EVERY == 0:
            # every rank reaches this at the SAME nstep (the loop is
            # lockstep), which is what lets fsdp mode checkpoint
            # collectively mid-world.  Replicated mode: ONLY the leader
            # saves, so only it pays the device→host copy.
            if sharding == "fsdp":
                checkpoint({"trainer": trainer,
                            "step": np.asarray(nstep, np.int32)}, nstep)
            elif world.is_leader:
                checkpoint(host_state(trainer, nstep), nstep)
        if any_stop > 0:
            stopped = True
            src.release()
            break
        if not_done == 0:
            break
    if verbose:
        print(f"[{name}] leaving world epoch={world.epoch} step={nstep} "
              f"stopped={stopped} last_loss={last_loss}", flush=True)
    if sharding == "fsdp":
        # sharded state stays on the devices — no single process holds it
        # all; the collective save in the world child persists it
        return {"trainer": trainer,
                "step": np.asarray(nstep, np.int32)}, stopped
    return host_state(trainer, nstep), stopped


def make_worker_coord(host: str, port: int):
    """The supervisor's coordinator client: a :class:`CoordMux` slot
    handle by default (one multiplexed connection per process; parked
    long-polls never starve the keepalive, and the batched KEEPALIVE verb
    rides it).  ``EDL_COORD_MUX=0`` opts back into a plain per-process
    client."""
    from edl_tpu_torch.coord.client import CoordClient, CoordMux

    if os.environ.get("EDL_COORD_MUX", "1") != "0":
        try:
            return CoordMux(host, port).client()
        except Exception as exc:
            print(f"warning: mux connect failed ({str(exc)[:80]}); "
                  f"using plain client", file=sys.stderr, flush=True)
    return CoordClient(host, port)


def main(argv=None) -> int:
    import signal
    import threading

    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True, help="host:port")
    ap.add_argument("--name", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--min-members", type=int, default=1)
    ap.add_argument("--settle-s", type=float, default=0.5)
    ap.add_argument("--heartbeat-timeout-s", type=int, default=10)
    ap.add_argument("--init-timeout-s", type=float, default=60.0,
                    help="the process group's rendezvous and collective "
                         "timeout")
    ap.add_argument("--stall-floor-s", type=float, default=None,
                    help="stall-watchdog deadline floor (default: "
                         "EDL_MH_STALL_FLOOR_S or 60)")
    ap.add_argument("--stall-k", type=float, default=6.0,
                    help="stall deadline = max(floor, k × EWMA step time)")
    ap.add_argument("--no-stall-watchdog", action="store_true",
                    help="disable supervisor-side stall detection")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="the supervisor's /metrics + /healthz port (0: "
                         "any free port, written to <ckpt-dir>/metrics-"
                         "addr-<name>); -1 (default from "
                         "EDL_MH_METRICS_PORT) disables")
    ap.add_argument("--param-sharding", choices=("replicated", "fsdp"),
                    default=os.environ.get("EDL_MH_SHARDING", "replicated"),
                    help="replicated = pure DP with npz generations; "
                         "fsdp = sharded state with collective, "
                         "layout-free ElasticCheckpointer generations")
    ap.add_argument("--model", choices=("mlp", "transformer"),
                    default=os.environ.get("EDL_MH_MODEL", "mlp"),
                    help="mlp = synthetic regression; transformer = the "
                         "GQA decoder family")
    ap.add_argument("--model-config",
                    choices=("tiny", "flagship", "large"),
                    default=os.environ.get("EDL_MH_MODEL_CFG", "tiny"),
                    help="transformer size (tiny = CPU-testable)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="the transformer's depth at the config's width "
                         "(0, the default: the config's own)")
    ap.add_argument("--device", default="cuda",
                    help="the world children's device: cuda (one card a "
                         "rank, over nccl), cuda:N (every rank on card N, "
                         "over gloo), or cpu (over gloo)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    task = make_task(args.model, args.model_config, args.n_layers)

    # SIGTERM = graceful scale-down: the supervisor announces leave intent,
    # every world child stops at the same step boundary (see
    # ElasticWorld.announce_leave), then we deregister and exit.
    leave = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: leave.set())

    host, _, port = args.coord.rpartition(":")
    coord = make_worker_coord(host, int(port))

    # Data publication: EDL_MH_DATA_DIR switches from in-memory shards
    # (every worker re-derives the same split) to REAL shard files on
    # shared storage — written once by the claim-elected seeder, streamed
    # by everyone on lease.  The claim is renewable and takeover-able, so
    # a seeder crashing mid-write cannot hang the job
    # (runtime.data.ensure_seeded).
    data_dir = os.environ.get("EDL_MH_DATA_DIR", "")
    registry = ShardRegistry()
    if not data_dir:
        shard_ids = registry.register_arrays(task.make_dataset(), SHARDS)

    def seed(beat):
        if data_dir:
            FileShardStore.enqueue(
                coord,
                FileShardStore.write_shards(data_dir, task.make_dataset(),
                                            SHARDS, on_shard=beat))
        else:
            registry.enqueue(coord, shard_ids)

    ensure_seeded(coord, args.name, seed)

    from edl_tpu_torch.runtime.multihost import WorkerEvicted

    fsdp = args.param_sharding == "fsdp"
    os.makedirs(args.ckpt_dir, exist_ok=True)
    try:
        outcome = run_elastic_worker(
            coord,
            args.name,
            init_state=functools.partial(init_state, task, args.device,
                                         args.param_sharding),
            train_world=functools.partial(
                train_world, coord=coord, name=args.name, registry=registry,
                verbose=not args.quiet, sharding=args.param_sharding,
                task=task, ckpt_dir=args.ckpt_dir),
            save_state=functools.partial(
                sharded_save_state if fsdp else save_state, name=args.name),
            load_state=(functools.partial(sharded_load_state, task=task,
                                          device=args.device)
                        if fsdp else load_state),
            ckpt_dir=args.ckpt_dir,
            min_members=args.min_members,
            settle_s=args.settle_s,
            leave_requested=leave.is_set,
            heartbeat_timeout_s=args.heartbeat_timeout_s,
            init_timeout_s=args.init_timeout_s,
            collective_ckpt=fsdp,
            stall_watchdog=not args.no_stall_watchdog,
            stall_floor_s=args.stall_floor_s,
            stall_k=args.stall_k,
            metrics_port=args.metrics_port,
            device=args.device,
            # warm pre-spawn trades idle CPU for reform latency; on a
            # starved host the concurrent preload imports contend with
            # the critical path instead, so the knob exists for benches
            # and tests
            warm_spawn=os.environ.get("EDL_MH_WARM_SPAWN", "1") != "0",
        )
    except WorkerEvicted as exc:
        # voted out by the peers' formation barrier: a typed, clean exit
        # — the job's state lives with the members that evicted us
        print(f"[{args.name}] evicted: {exc}", file=sys.stderr, flush=True)
        return 4
    # The world children report their final step through the supervisor;
    # a state located by a KV scan instead is read for its step (npz) or
    # its directory's newest step (fsdp) without touching a device.
    step = outcome.step
    if step is None:
        if fsdp:
            from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

            step = ElasticCheckpointer(outcome.state_path).latest_step()
        else:
            step = int(load_state(outcome.state_path)["step"])
    verdict = "left" if leave.is_set() else "done"
    # what a harness checks: this process never initialised CUDA
    import torch

    print(f"[{args.name}] supervisor cuda initialized "
          f"{torch.cuda.is_initialized()}", flush=True)
    print(f"[{args.name}] {verdict} at step {step} "
          f"state={outcome.state_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
