"""Spawned gloo worlds for the port's multi-rank tests.

:func:`run` starts one process a rank from torch.multiprocessing's ``spawn``
context.  Each joins a gloo process group through a ``FileStore`` under the
test's ``tmp_path`` (no TCP port, so parallel test workers cannot collide),
runs one suite of scenarios in sequence, and pickles what each scenario saw,
or its traceback, to a file beside the store.  The parent joins every child
within a deadline, kills any left, and fails.  This module imports torch,
numpy and the port only: the children need no JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.parallel.mesh import MeshShape, MeshSpec
from edl_tpu_torch.runtime import elastic, optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer

#: a collective that waits longer than this raises in the child
GLOO_TIMEOUT_S = 60


class ScenarioFailed(AssertionError):
    pass


def run(suite: str, world: int, tmp_path: Path, deadline_s: float,
        **kw) -> list[dict]:
    """Run ``suite`` on ``world`` spawned ranks; returns each rank's
    ``{scenario: result}`` in rank order.  Raises when a child does not
    finish within ``deadline_s`` (after killing every child left) or exits
    without its result."""
    ctx = torch.multiprocessing.get_context("spawn")
    outs = [tmp_path / f"{suite}.rank{r}.pkl" for r in range(world)]
    store = str(tmp_path / f"{suite}.store")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(suite, r, world, store, str(outs[r]), kw))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if hung:
        raise AssertionError(f"{suite}: ranks {hung} still running after "
                             f"{deadline_s} s; killed")
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.exitcode != 0 or not out.exists():
            raise AssertionError(f"{suite}: rank {r} exited {p.exitcode} "
                                 "without its result")
        with out.open("rb") as f:
            results.append(pickle.load(f))
    return results


def scenario(results: list[dict], name: str) -> list:
    """Every rank's result of scenario ``name``; raises with the first
    rank's traceback when it failed anywhere."""
    got = [r[name] for r in results]
    for rank, g in enumerate(got):
        if isinstance(g, ScenarioFailed):
            raise AssertionError(f"scenario {name} failed on rank {rank}:\n"
                                 f"{g}")
    return got


def _child(suite: str, rank: int, world: int, store: str, out: str,
           kw: dict) -> None:
    torch.set_num_threads(1)
    try:
        results = SUITES[suite](rank, world, store, **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


def _run_scenarios(scenarios, rank: int, **kw) -> dict:
    results = {}
    for fn in scenarios:
        try:
            results[fn.__name__] = fn(rank, **kw)
        except Exception:
            results[fn.__name__] = ScenarioFailed(traceback.format_exc())
    return results


def _join(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=GLOO_TIMEOUT_S))


# -- shared pieces ------------------------------------------------------------


def mlp_rows(model, batch):
    """A serving fleet's forward of the MLP on a batch of rows: importable
    by a wide replica's rank processes."""
    return mlp.apply(model, batch[0])


def digest(trainer: ElasticTrainer) -> str:
    """sha256 of every parameter's and optimizer-state tensor's bytes."""
    h = hashlib.sha256()
    params = list(trainer.state.params.parameters())
    for p in params:
        h.update(p.detach().cpu().numpy().tobytes())
    opt = trainer.state.opt_state.state
    for p in params:
        for k, v in sorted(opt[p].items()) if p in opt else ():
            h.update(k.encode())
            h.update(torch.as_tensor(v).detach().cpu().numpy().tobytes())
    return h.hexdigest()


def params_numpy(trainer: ElasticTrainer) -> dict:
    return {n: p.detach().cpu().numpy().copy()
            for n, p in trainer.state.params.named_parameters()}


def tiny_trainer(params: dict, optimizer=None, **kw) -> ElasticTrainer:
    """The port's TINY transformer holding the JAX params ``params`` (a
    numpy tree), under ``optimizer`` (default adamw(1e-3)) on the CPU."""
    model = interop.params_from_numpy(tfm.Transformer(tfm.TINY, device="cpu"),
                                      params)
    return ElasticTrainer(tfm.loss_fn, model,
                          optimizer or optim.adamw(1e-3),
                          devices=[torch.device("cpu")], **kw)


def synthetic_classification(n=512, dim=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)) * 3
    y = rng.integers(0, classes, size=n)
    x = centers[y] + rng.normal(size=(n, dim))
    return x.astype(np.float32), y.astype(np.int64)


def mlp_trainer(n0: int, **kw) -> ElasticTrainer:
    """The port's MLP [16, 32, 4] from seed 0 under adam(1e-2) on the
    CPU."""
    return ElasticTrainer(mlp.loss_fn, mlp.MLP([16, 32, 4], device="cpu"),
                          optim.adam(1e-2), devices=[torch.device("cpu")],
                          initial_world_size=n0, **kw)


def _slices(x, y, i, b=64, span=448):
    lo = (i * b) % span
    return x[lo:lo + b], y[lo:lo + b]


# -- the two-rank suite -------------------------------------------------------


def suite_two(rank: int, world: int, store: str, tiny_params: dict,
              batches: list, flagship_kw: dict) -> dict:
    """Joins through ``entry.flagship_elastic_world`` (TINY, CPU), then the
    JAX-parity 1→2 scenario on the same group."""
    from edl_tpu_torch.entry import flagship_elastic_world

    out = {}
    try:
        trainer, batch = flagship_elastic_world(
            rank, world, store, device="cpu", **flagship_kw)
        seen = {"world": trainer.world_size, "live": trainer.live,
                "use_flash": trainer.state.params.cfg.use_flash,
                "batch": tuple(batch[0].shape), "losses": []}
        for target in (None, 2, None, 1, None):
            if target is None:
                seen["losses"].append(trainer.step(batch))
            else:
                seen.setdefault("resized", []).append(trainer.resize(target))
        seen["digest"] = digest(trainer) if trainer.live else None
        out["flagship_world"] = seen
    except Exception:
        out["flagship_world"] = ScenarioFailed(traceback.format_exc())
        return out

    def parity_step(rank):
        t = tiny_trainer(tiny_params, initial_world_size=1)
        rows = []  # (rows, first token) of each batch the loss saw

        def loss_fn(model, batch):
            rows.append((batch[0].shape[0], int(batch[0][0, 0])))
            return tfm.loss_fn(model, batch)

        t.loss_fn = loss_fn
        losses = [t.step(batches[0])]
        resized = t.resize(2)
        losses += [t.step(b) for b in batches[1:]]
        return dict(losses=losses, resized=resized, digest=digest(t),
                    params=params_numpy(t), events=t.resize_events,
                    step=t.state.step, rows=rows)

    out.update(_run_scenarios([parity_step], rank))
    return out


# -- the four-rank suite ------------------------------------------------------


def suite_four(rank: int, world: int, store: str, tiny_params: dict,
               micro: list) -> dict:
    _join(rank, world, store)

    def accum_dp(rank):
        got = {}
        for n in (2, 4):
            t = tiny_trainer(tiny_params, initial_world_size=n)
            losses = [t.step_accumulate(micro) for _ in range(2)]
            got[n] = dict(losses=losses, live=t.live,
                          digest=digest(t) if t.live else None,
                          params=params_numpy(t))
        return got

    def replicated(rank):
        got = {}
        for n in (1, 2, 4):
            t = tiny_trainer(tiny_params, initial_world_size=n,
                             accum_mode="replicated")
            losses = [t.step_accumulate(micro) for _ in range(2)]
            got[n] = dict(losses=losses, live=t.live,
                          digest=digest(t) if t.live else None)
        return got

    def standby(rank):
        t = tiny_trainer(tiny_params, initial_world_size=2)
        before = digest(t)
        got = dict(step=t.step(micro[0]), eval=t.eval_loss(micro[0]),
                   accum=t.step_accumulate(micro), live=t.live)
        got["untouched"] = digest(t) == before
        got["steps"] = t.state.step
        return got

    x, y = synthetic_classification()

    def reduces_loss(rank):
        t = mlp_trainer(2)
        first = t.step((x[:64], y[:64]))
        for i in range(30):
            t.step(_slices(x, y, i))
        return dict(first=first, final=t.eval_loss((x, y)))

    def resize_mid_training(rank):
        t = mlp_trainer(2)
        for i in range(10):
            t.step(_slices(x, y, i))
        got = dict(before=t.eval_loss((x, y)), step_before=t.state.step)
        got["grew"] = t.resize(4)
        got.update(world_grown=t.world_size, after=t.eval_loss((x, y)),
                   step_after=t.state.step, digest_grown=digest(t))
        for i in range(20):
            t.step(_slices(x, y, i))
        got["trained_4"] = t.eval_loss((x, y))
        got["shrank"] = t.resize(2)
        got["loss_4"] = t.eval_loss((x, y))
        for i in range(10):
            t.step(_slices(x, y, i))
        got.update(final=t.eval_loss((x, y)), resizes=t.resizes,
                   world=t.world_size)
        return got

    def continuity_4_2_4(rank):
        resized, control = mlp_trainer(4), mlp_trainer(4)
        got = dict(resized=[], control=[], evals=[])
        for phase, target in ((0, 2), (1, 4), (2, None)):
            for i in range(4):
                batch = _slices(x, y, 4 * phase + i)
                got["resized"].append(resized.step(batch))
                got["control"].append(control.step(batch))
            if target is not None:
                before = resized.eval_loss((x, y))
                ok = resized.resize(target)
                got["evals"].append((ok, before, resized.eval_loss((x, y))))
        got["worlds"] = (resized.world_size, control.world_size)
        return got

    def oscillation(rank):
        calls = []
        real = dist.new_group

        def counting(*a, **k):
            calls.append(a)
            return real(*a, **k)

        dist.new_group = counting
        try:
            t = mlp_trainer(1)
            t.step((x[:64], y[:64]))
            seen, groups = [], {}
            for target in (2, 1, 2, 1, 2):
                ok = t.resize(target)
                groups.setdefault(target, t.mesh.group)
                seen.append((ok, t.world_size,
                             t.mesh.group is groups[target], len(calls)))
                t.step((x[:64], y[:64]))
        finally:
            dist.new_group = real
        return dict(seen=seen)

    def planted_failures(rank):
        t = mlp_trainer(2)
        t.step((x[:64], y[:64]))
        got = {"before": digest(t) if t.live else None}
        real_fresh, real_bcast = elastic._fresh, elastic._broadcast

        def failing_fresh(*a, **k):
            raise RuntimeError("injected: out of memory staging the resize")

        def failing_after_bcast(t_, src, group, axis):
            real_bcast(t_, src, group, axis)
            if axis != "world":  # the state transfer, not the layout
                raise RuntimeError("injected: transfer failed after bytes")

        for name, seam, real, bad, on in (
                ("alloc", "_fresh", real_fresh, failing_fresh, 3),
                ("transfer", "_broadcast", real_bcast, failing_after_bcast,
                 2)):
            if rank == on:
                setattr(elastic, seam, bad)
            try:
                ok = t.resize(4)
            finally:
                setattr(elastic, seam, real)
            got[name] = dict(ok=ok, world=t.world_size,
                             failed=t.resizes_failed, resizes=t.resizes,
                             loss=t.step((x[:64], y[:64])),
                             digest=digest(t) if t.live else None)
        got["retry"] = t.resize(4)
        got["retry_loss"] = t.step((x[:64], y[:64]))
        got["after"] = digest(t)
        return got

    def transformer(rank):
        cfg = dataclasses.replace(tfm.TINY, max_seq_len=32)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, size=(512, 32))
        targets = (tokens + 1) % cfg.vocab_size
        t = ElasticTrainer(tfm.loss_fn, tfm.Transformer(cfg, device="cpu",
                                                        seed=0),
                           optim.adam(1e-2), devices=[torch.device("cpu")],
                           initial_world_size=2)
        first = t.step((tokens[:64], targets[:64]))
        for i in range(10):
            t.step(_slices(tokens, targets, i))
        before_loss = t.eval_loss((tokens[:128], targets[:128]))
        before = digest(t) if t.live else None
        grew = t.resize(4)
        after = digest(t)
        for i in range(15):
            t.step(_slices(tokens, targets, i))
        shrank = t.resize(2)
        for i in range(15):
            t.step(_slices(tokens, targets, i))
        return dict(first=first, before_loss=before_loss, before=before,
                    after=after, grew=grew, shrank=shrank,
                    final=t.eval_loss((tokens[:128], targets[:128])))

    def eval_loss(rank):
        t = mlp_trainer(2)
        batch = (x[:64], y[:64])
        before = digest(t)
        ev = t.eval_loss(batch)
        direct = float(mlp.loss_fn(t.state.params,
                                   (torch.as_tensor(batch[0]),
                                    torch.as_tensor(batch[1]))))
        got = dict(ev=ev, direct=direct, untouched=digest(t) == before,
                   step=t.state.step)
        for i in range(30):
            t.step((x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16]))
        got["trained"] = t.eval_loss(batch)
        t.resize(4)
        got["ev4"] = t.eval_loss(batch)
        got["direct4"] = float(mlp.loss_fn(
            t.state.params, (torch.as_tensor(batch[0]),
                             torch.as_tensor(batch[1]))))
        t.resize(1)
        got["ev1"] = t.eval_loss(batch)
        return got

    def records(rank):
        from edl_tpu_torch.observability import calib, goodput
        from edl_tpu_torch.observability.metrics import get_registry

        ledger = goodput.set_process_ledger(goodput.GoodputLedger(
            "t/world", world_size=2, base_phase=goodput.PRODUCTIVE))
        cal = calib.set_process_calib(calib.CalibrationLedger("t/world"))
        try:
            t = mlp_trainer(2)
            t.step((x[:64], y[:64]))
            time.sleep(0.05)  # productive time for the resize's spans
            grew = t.resize(4)
            rendered = get_registry().render()
            return dict(
                grew=grew, events=t.resize_events,
                phases=[p for p in ("replan", "compile", "reshard")
                        if f'edl_resize_phase_seconds_count{{phase="{p}"}}'
                        in rendered],
                ledger_world=ledger.world_size,
                reshard_chip_s=ledger.chip_seconds(goodput.RESHARD),
                conserves=ledger.conserves(),
                calib_samples=cal.sample_count("reshard_seconds"))
        finally:
            goodput.set_process_ledger(None)
            calib.set_process_calib(None)

    def unresolvable(rank):
        t = mlp_trainer(4)
        t.step((x[:64], y[:64]))
        got = dict(matches=[t.matches(v) for v in (0, "abc", 3, 4)])
        got["soft"] = [t.resize(v) for v in (0, "abc")]
        got["failed_soft"] = t.resizes_failed
        got["staged"] = [t.resize(v) for v in (8, MeshShape(dp=2, ep=2))]
        got.update(failed=t.resizes_failed, world=t.world_size,
                   loss=t.step((x[:64], y[:64])), landed=t.resize(3),
                   world_after=t.world_size)
        return got

    return _run_scenarios(
        [accum_dp, replicated, standby, reduces_loss, resize_mid_training,
         continuity_4_2_4, oscillation, planted_failures, transformer,
         eval_loss, records, unresolvable], rank)


# -- the eight-rank virtual-worker suite --------------------------------------


class DictKV:
    """The smallest KV store: ``kv_set``/``kv_get`` over a dict."""

    def __init__(self) -> None:
        self.data: dict[str, bytes] = {}

    def kv_set(self, key: str, value: bytes) -> None:
        self.data[key] = value

    def kv_get(self, key: str):
        return self.data.get(key)

    def kv_del(self, key: str) -> bool:
        return self.data.pop(key, None) is not None

    def kv_keys(self, prefix: str = "") -> list:
        return sorted(k for k in self.data if k.startswith(prefix))


def suite_virtual(rank: int, world: int, store: str, mlp_params: dict,
                  data: tuple, seed: int) -> dict:
    """The scenarios of tests/test_accuracy_elasticity.py that need more
    than one rank, on the port's MLP holding the JAX init ``mlp_params``:
    every rank runs the same loop, and rank 0's report is the job's."""
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.elastic import AccumulationAborted
    from edl_tpu_torch.runtime.virtual import (OwnershipMap, CursorStore,
                                               VirtualBatches, VirtualConfig,
                                               VirtualWorkerLoop, vw_keys)
    from edl_tpu_torch.runtime.watchdog import StallWatchdog
    from edl_tpu_torch.observability.collector import get_counters

    _join(rank, world, store)
    tmp = Path(store).parent
    cfg = VirtualConfig(vw_count=8, global_batch=64, job_seed=seed)
    reg = ShardRegistry()
    ids = reg.register_arrays(data, num_shards=16)
    cpu = torch.device("cpu")

    def trainer(n, accum_mode="replicated", loss=mlp.loss_fn, **kw):
        model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                          mlp_params)
        return ElasticTrainer(loss, model, optim.adam(1e-2), devices=[cpu],
                              initial_world_size=n, accum_mode=accum_mode,
                              **kw)

    def loop(schedule, max_steps=20, run_cfg=cfg, kv=None, job="job",
             ckpt=None, ckpt_every=0, augment=None, on_step=None, **kw):
        tr = trainer(schedule(0), **kw)
        vb = VirtualBatches(run_cfg, ids, reg.get, passes=2)
        lp = VirtualWorkerLoop(tr, run_cfg, vb, kv=kv, job=job,
                               checkpointer=ckpt, ckpt_every=ckpt_every,
                               augment=augment)
        return lp, lp.run(max_steps=max_steps, world_size_for=schedule,
                          on_step=on_step)

    def summary(rep) -> dict:
        return dict(losses=rep.losses, worlds=rep.world_sizes,
                    resizes=rep.resizes, vw_moves=rep.vw_moves,
                    duplicated=rep.rows_duplicated(),
                    rows=dict(rep.rows_trained))

    walk_4_2_8 = lambda s: 4 if s < 7 else (2 if s < 14 else 8)  # noqa
    control_4 = lambda s: 4  # noqa: E731
    x, y = data
    micro = [(x[v * 8:(v + 1) * 8], y[v * 8:(v + 1) * 8]) for v in range(8)]

    def noisy_loss(params, batch, key):
        xb, yb = batch
        return mlp.loss_fn(params, (xb + 0.05 * torch.randn(
            xb.shape, generator=key), yb))

    def augment(mb, key):
        xb, yb = mb
        return (xb + 0.05 * torch.randn(xb.shape, generator=key).numpy(), yb)

    def accum_replicated(rank):
        got = {}
        for n in (1, 2, 4, 8):
            t = trainer(n)
            got[n] = [t.step_accumulate(micro) for _ in range(4)]
        return got

    def accum_dp_bounded(rank):
        t2, t8 = trainer(2, accum_mode="dp"), trainer(8, accum_mode="dp")
        return [(t2.step_accumulate(micro), t8.step_accumulate(micro))
                for _ in range(4)]

    def rng_layout(rank):
        got = {}
        for n in (2, 8):
            t = trainer(n, loss=noisy_loss, rng_in_loss=True)
            got[n] = [t.step_accumulate(micro,
                                        rng_keys=vw_keys(seed, 8, s, "cpu"))
                      for s in range(3)]
        return got

    def control(rank):
        return summary(loop(control_4)[1])

    def resize_4_2_8(rank):
        kv = DictKV()
        c0 = get_counters().get("vw_remaps")
        _, rep = loop(walk_4_2_8, kv=kv, job="acc")
        cursor = CursorStore(kv, job="acc").load()
        owners = OwnershipMap.load(kv, job="acc")
        return dict(summary(rep), remaps=get_counters().get("vw_remaps") - c0,
                    map=owners.mapping if owners else None,
                    cursor_step=cursor["step"] if cursor else None)

    def dp_packed(rank):
        _, ctrl = loop(control_4, max_steps=16, accum_mode="dp")
        _, res = loop(walk_4_2_8, max_steps=16, accum_mode="dp")
        return dict(control=ctrl.losses, resized=res.losses)

    def augmentation(rank):
        _, ctrl = loop(control_4, max_steps=12, augment=augment)
        _, res = loop(walk_4_2_8, max_steps=12, augment=augment)
        return dict(control=ctrl.losses, resized=res.losses)

    def kill_restore(rank):
        ck = ElasticCheckpointer(tmp / "ckpt-kill")
        kv = DictKV()
        tr = trainer(4)
        vb = VirtualBatches(cfg, ids, reg.get, passes=2)
        rep1 = VirtualWorkerLoop(tr, cfg, vb, kv=kv, job="kill",
                                 checkpointer=ck, ckpt_every=5).run(
            max_steps=10, world_size_for=walk_4_2_8)
        try:  # the kill: step 11's accumulation dies between micro-grads
            tr.step_accumulate(vb.next_step(), abort_after=3)
            killed = False
        except AccumulationAborted:
            killed = True
        tr2 = trainer(2)  # fresh trainers on the shrunken world
        loop2 = VirtualWorkerLoop(tr2, cfg,
                                  VirtualBatches(cfg, ids, reg.get, passes=2),
                                  kv=kv, job="kill", checkpointer=ck,
                                  ckpt_every=5)
        restored = loop2.restore_latest()
        rep2 = loop2.run(max_steps=10, world_size_for=walk_4_2_8)
        rows: dict[int, int] = {}
        for rep in (rep1, rep2):
            for gid, c in rep.rows_trained.items():
                rows[gid] = rows.get(gid, 0) + c
        ck.close()
        return dict(killed=killed, live=tr.live, restored=restored,
                    stitched=rep1.losses + rep2.losses, rows=rows,
                    saved=sorted(int(p.name) for p in
                                 (tmp / "ckpt-kill").iterdir()
                                 if p.name.isdigit()))

    def drifted_config(rank):
        ck = ElasticCheckpointer(tmp / "ckpt-drift")
        loop(control_4, max_steps=5, ckpt=ck, ckpt_every=5)
        drifted = VirtualConfig(vw_count=4, global_batch=64, job_seed=seed)
        loop2 = VirtualWorkerLoop(trainer(4), drifted,
                                  VirtualBatches(drifted, ids, reg.get),
                                  checkpointer=ck, ckpt_every=5)
        try:
            loop2.restore_latest()
            error = None
        except ValueError as exc:
            error = str(exc)
        loop3 = VirtualWorkerLoop(trainer(4), cfg,
                                  VirtualBatches(cfg, ids, reg.get),
                                  checkpointer=ck, ckpt_every=5)
        return dict(error=error, original=loop3.restore_latest())

    def stall(rank):
        _, ctrl = loop(control_4, max_steps=12)
        wd = StallWatchdog(floor_s=0.4, k=8.0, scope=f"acc-elastic-{rank}")
        wd.start(poll_s=0.05)
        stalled = []

        def on_step(step, loss, world):
            wd.beat(step)
            if step == 6 and not stalled:
                stalled.append(True)
                time.sleep(1.2)  # the wedge

        try:
            _, res = loop(walk_4_2_8, max_steps=12, on_step=on_step)
        finally:
            wd.stop()
        return dict(control=ctrl.losses, resized=res.losses,
                    wedged=bool(stalled),
                    stalls=get_counters().get(
                        "stalls_detected", scope=f"acc-elastic-{rank}"))

    def restore_agreement(rank):
        """The newest step's read fails on rank 3 alone, then on every
        rank: the first restore raises everywhere, the second falls back
        to the step before on every rank and resumes from there."""
        ck = ElasticCheckpointer(tmp / "ckpt-agree")
        loop(control_4, max_steps=10, ckpt=ck, ckpt_every=5)
        dist.barrier()  # rank 0's saves are on disk
        real = ck._read

        def failing(ranks):
            def read(step, tree_like):
                if step == 10 and rank in ranks:
                    raise OSError("injected read failure")
                return real(step, tree_like)
            return read

        def fresh():
            return VirtualWorkerLoop(trainer(4), cfg,
                                     VirtualBatches(cfg, ids, reg.get,
                                                    passes=2),
                                     checkpointer=ck, ckpt_every=5)

        got = {}
        ck._read = failing({3})
        try:
            fresh().restore_latest()
            got["one_rank"] = None
        except RuntimeError as exc:
            got["one_rank"] = str(exc)
        ck._read = failing(set(range(world)))
        lp = fresh()
        got["every_rank"] = lp.restore_latest()
        got["state_step"] = lp.trainer.state.step
        got["losses"] = lp.run(max_steps=5,
                               world_size_for=control_4).losses
        ck._read = real
        ck.close()
        return got

    def restore_other_world(rank):
        t = trainer(2, accum_mode="dp")
        batch = (x[:64], y[:64])
        for _ in range(5):
            t.step(batch)
        loss = t.eval_loss((x, y))
        ck = ElasticCheckpointer(tmp / "ckpt-world")
        if rank == 0:
            ck.save(t.state.step, {"params": t.state.params,
                                   "opt": t.state.opt_state})
        dist.barrier()
        t2 = trainer(4, accum_mode="dp")
        t2.state.params, t2.state.opt_state = ck.restore(
            {"params": t2.state.params, "opt": t2.state.opt_state}).values()
        got = dict(loss=loss, restored=t2.eval_loss((x, y)),
                   digest=digest(t2), live=t2.live)
        for _ in range(10):
            t2.step(batch)
        got["trained"] = t2.eval_loss((x, y))
        return got

    return _run_scenarios(
        [accum_replicated, accum_dp_bounded, rng_layout, control,
         resize_4_2_8, dp_packed, augmentation, kill_restore,
         drifted_config, stall, restore_agreement, restore_other_world],
        rank)


# -- the fsdp suites ----------------------------------------------------------


def shard_digest(trainer: ElasticTrainer) -> str:
    """sha256 of this rank's blocks of every parameter and optimizer-state
    tensor."""
    h = hashlib.sha256()
    opt = trainer.state.opt_state.state
    for name, s in trainer.shards.items():
        h.update(name.encode())
        h.update(s.detach().cpu().numpy().tobytes())
        for k, v in sorted(opt[s].items()) if s in opt else ():
            h.update(k.encode())
            h.update(torch.as_tensor(v).detach().cpu().numpy().tobytes())
    return h.hexdigest()


def full_numpy(trainer: ElasticTrainer) -> dict:
    """The whole parameters (collective over the live group)."""
    return {n: p.numpy() for n, p in trainer.full_params().items()}


def blocks(trainer: ElasticTrainer) -> dict:
    """This rank's blocks of each parameter and of Adam's moments, with the
    sharded dim and the rank's index on the fsdp axis."""
    opt = trainer.state.opt_state.state
    return dict(
        dims=trainer.sharded_dims(),
        index=trainer.rank % trainer.shape.fsdp, fsdp=trainer.shape.fsdp,
        params={n: s.detach().numpy().copy()
                for n, s in trainer.shards.items()},
        opt={n: {k: v.numpy().copy() for k, v in opt[s].items()
                 if v.shape == s.shape}
             for n, s in trainer.shards.items() if s in opt},
        shapes=trainer.full_shapes())


def fsdp_tiny(params: dict, spec: MeshSpec, n0: int, **kw) -> ElasticTrainer:
    return tiny_trainer(params, param_sharding="fsdp", spec=spec,
                        initial_world_size=n0, **kw)


FSDP = MeshSpec(dp=1, fsdp=-1)
#: plain SGD's step size in the fsdp parity scenario: unlike Adam's, its
#: update scales with the gradient, so a wrong 1/N or a sum taken twice
#: shows in the parameters
SGD_LR = 0.1


def sgd(params):
    return torch.optim.SGD(params, lr=SGD_LR)


def suite_fsdp_four(rank: int, world: int, store: str, tiny_params: dict,
                    batches: list, micro: list) -> dict:
    """fsdp on four ranks: JAX parity of fsdp 4 and dp2×fsdp2, the live
    re-splits of tests/test_replan.py on the MLP, fsdp 2 ↔ 4, replicated
    accumulation across layouts, and ranks standing by."""
    _join(rank, world, store)
    x, y = synthetic_classification()

    def matches(rank):
        got = {}
        for label, spec in (("fsdp4", FSDP), ("dp2xfsdp2",
                                               MeshSpec(dp=2, fsdp=-1))):
            t = fsdp_tiny(tiny_params, spec, 4)
            elastic.reset_census()
            losses = [t.step(batches[0])]
            census = elastic.collective_census()
            losses += [t.step(b) for b in batches[1:]]
            got[label] = dict(losses=losses, census=census,
                              blocks=blocks(t), full=full_numpy(t))
            t = fsdp_tiny(tiny_params, spec, 4, optimizer=sgd)
            losses = [t.step(batches[0])]
            first = full_numpy(t)
            losses += [t.step(b) for b in batches[1:]]
            got[f"{label}_sgd"] = dict(losses=losses, first=first,
                                       full=full_numpy(t))
        t = tiny_trainer(tiny_params, initial_world_size=4)
        got["replicated"] = dict(losses=[t.step(b) for b in batches],
                                 full=params_numpy(t))
        t = fsdp_tiny(tiny_params, FSDP, 4)
        got["accum_dp"] = dict(
            losses=[t.step_accumulate(micro) for _ in range(2)],
            full=full_numpy(t))
        return got

    def mlp_fsdp(n0=4, spec=MeshSpec(dp=-1), sizes=(16, 32, 4)):
        return ElasticTrainer(mlp.loss_fn,
                              mlp.MLP(list(sizes), device="cpu"),
                              optim.adam(1e-2), spec=spec,
                              param_sharding="fsdp",
                              devices=[torch.device("cpu")],
                              initial_world_size=n0)

    def live_4x1_to_2x2(rank):
        t = mlp_fsdp()
        for i in range(8):
            t.step((x[i * 64:(i + 1) * 64], y[i * 64:(i + 1) * 64]))
        got = dict(ev_before=t.eval_loss((x, y)), before=full_numpy(t),
                   shape_before=t.shape)
        got["ok"] = t.resize(MeshShape(dp=2, fsdp=2))
        got.update(shape=t.shape, size=t.world_size, after=full_numpy(t),
                   ev_after=t.eval_loss((x, y)), event=t.resize_events[-1],
                   w0=(t.shards["w0"].nbytes,
                       t.state.opt_state.state[t.shards["w0"]]["exp_avg"]
                       .nbytes), dims=t.sharded_dims())
        for i in range(10):
            t.step((x[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32]))
        got["trained"] = t.eval_loss((x, y))
        held = full_numpy(t)
        got["back"] = t.resize(4)
        got.update(back_event=t.resize_events[-1], back_shape=t.shape,
                   back_same=all(np.array_equal(held[k], v) for k, v in
                                 full_numpy(t).items()))
        return got

    def distinct_cache(rank):
        calls = []
        real = dist.new_group

        def counting(*a, **k):
            calls.append(a)
            return real(*a, **k)

        dist.new_group = counting
        try:
            t = mlp_fsdp()
            t.step((x[:64], y[:64]))
            ok = [t.resize(MeshShape(dp=2, fsdp=2))]
            t.step((x[:64], y[:64]))
            ok.append(t.resize(4))
            built = len(calls)
            keys = sorted(t._step_cache)
            mesh_22 = t._step_cache[(4, MeshShape(dp=2, fsdp=2).key())]
            ok.append(t.resize(MeshShape(dp=2, fsdp=2)))
            ok.append(t.resize(4))
            ok.append(t.resize(MeshShape(dp=2, fsdp=2)))
        finally:
            dist.new_group = real
        return dict(ok=ok, keys=keys, same_mesh=t.mesh is mesh_22,
                    built=built, built_after=len(calls),
                    groups=sorted(t.mesh.groups))

    def rollback(rank):
        t = mlp_fsdp()
        t.step((x[:64], y[:64]))
        real_fresh, real_bcast = elastic._fresh, elastic._broadcast

        def failing_fresh(*a, **k):
            raise RuntimeError("injected: out of memory staging the resize")

        def failing_after_bcast(t_, src, group, axis):
            real_bcast(t_, src, group, axis)
            if axis != "world":  # the blocks' move, not a vote
                raise RuntimeError("injected: transfer failed after bytes")

        got = {}
        for name, target, seam, bad, on in (
                ("alloc", MeshShape(dp=2, fsdp=2), "_fresh", failing_fresh,
                 2),
                ("transfer", MeshShape(dp=4), "_broadcast",
                 failing_after_bcast, 1)):
            if name == "transfer":
                got["landed"] = t.resize(MeshShape(dp=2, fsdp=2))
            old_mesh, old_shape = t.mesh, t.shape
            before = shard_digest(t)
            ev0 = t.eval_loss((x[:64], y[:64]))
            if rank == on:
                setattr(elastic, seam, bad)
            try:
                ok = t.resize(target)
            finally:
                elastic._fresh, elastic._broadcast = real_fresh, real_bcast
            got[name] = dict(
                ok=ok, same_mesh=t.mesh is old_mesh, shape=t.shape,
                old_shape=old_shape, failed=t.resizes_failed,
                untouched=shard_digest(t) == before,
                ev=(ev0, t.eval_loss((x[:64], y[:64]))),
                loss=t.step((x[:64], y[:64])))
            got[name]["retry"] = t.resize(target)
            got[name]["retry_shape"] = t.shape
        return got

    def fsdp_2_4(rank):
        resized = fsdp_tiny(tiny_params, FSDP, 2)
        control = fsdp_tiny(tiny_params, FSDP, 2)
        got = dict(resized=[], control=[], kept=[], evals=[])
        for phase, target in ((0, 4), (1, 2), (2, None)):
            for b in batches:
                got["resized"].append(resized.step(b))
                got["control"].append(control.step(b))
            if target is not None:
                before = full_numpy(resized)
                ev = resized.eval_loss(batches[0])
                ok = resized.resize(target)
                got["kept"].append(all(
                    np.array_equal(before[k], v)
                    for k, v in full_numpy(resized).items()))
                got["evals"].append((ok, ev, resized.eval_loss(batches[0])))
        # a leaf whose sharded dim changes with the fsdp size: [6, 4] splits
        # its 6 rows in 2 and its 4 columns in 4
        m = mlp_fsdp(n0=2, spec=FSDP, sizes=(6, 4, 4))
        m.step((x[:64, :6], y[:64]))
        dims, before = [m.sharded_dims()["w0"]], full_numpy(m)
        moved = [m.resize(4)]
        dims.append(m.sharded_dims()["w0"])
        kept = [all(np.array_equal(before[k], v)
                    for k, v in full_numpy(m).items())]
        m.step((x[:64, :6], y[:64]))
        before = full_numpy(m)
        moved.append(m.resize(2))
        dims.append(m.sharded_dims()["w0"])
        kept.append(all(np.array_equal(before[k], v)
                        for k, v in full_numpy(m).items()))
        got["mlp"] = dict(dims=dims, moved=moved, kept=kept,
                          loss=m.step((x[:64, :6], y[:64])))
        return got

    def replicated_accum(rank):
        got = {}
        for label, spec, n in (("1", FSDP, 1), ("fsdp2", FSDP, 2),
                               ("dp2xfsdp2", MeshSpec(dp=2, fsdp=-1), 4)):
            t = fsdp_tiny(tiny_params, spec, n, accum_mode="replicated")
            losses = [t.step_accumulate(micro) for _ in range(2)]
            got[label] = dict(losses=losses, live=t.live,
                              blocks=blocks(t) if t.live else None)
        return got

    def standby(rank):
        t = fsdp_tiny(tiny_params, FSDP, 2)
        before = shard_digest(t)
        got = dict(step=t.step(micro[0]), eval=t.eval_loss(micro[0]),
                   accum=t.step_accumulate(micro), live=t.live)
        got["untouched"] = shard_digest(t) == before
        got["steps"] = t.state.step
        got["held"] = sum(s.numel() for s in t.shards.values())
        return got

    return _run_scenarios(
        [matches, live_4x1_to_2x2, distinct_cache, rollback, fsdp_2_4,
         replicated_accum, standby], rank)


def suite_fsdp_two(rank: int, world: int, store: str, tiny_params: dict,
                   batches: list, flagship_kw: dict) -> dict:
    """fsdp on two ranks: the entry point behind chip_smoke's phase (l),
    then the JAX-parity 1→2 scenario on the same group."""
    from edl_tpu_torch.entry import flagship_elastic_world

    out = {}
    try:
        trainer, batch = flagship_elastic_world(
            rank, world, store, device="cpu", param_sharding="fsdp",
            spec=FSDP, **flagship_kw)
        seen = dict(world=trainer.world_size, live=trainer.live,
                    losses=[], resized=[], kept=[], shares=None)
        for target in (None, 2, None, 1, None):
            if target is None:
                seen["losses"].append(trainer.step(batch))
                continue
            before = full_numpy(trainer)
            seen["resized"].append(trainer.resize(target))
            seen["kept"].append(all(
                np.array_equal(before[k], v)
                for k, v in full_numpy(trainer).items()))
            if trainer.world_size == 2:
                b = blocks(trainer)
                seen["shares"] = sorted({
                    a.size / int(np.prod(b["shapes"][n]))
                    for n, a in b["params"].items()} | {
                    a.size / int(np.prod(b["shapes"][n]))
                    for n, e in b["opt"].items() for a in e.values()})
        out["flagship_world"] = seen
    except Exception:
        out["flagship_world"] = ScenarioFailed(traceback.format_exc())
        return out

    def parity_1_2(rank):
        t = fsdp_tiny(tiny_params, FSDP, 1)
        losses = [t.step(batches[0])]
        resized = t.resize(2)
        losses += [t.step(b) for b in batches[1:]]
        return dict(losses=losses, resized=resized, full=full_numpy(t),
                    events=t.resize_events, digest=shard_digest(t))

    out.update(_run_scenarios([parity_1_2], rank))
    return out


# -- the tensor-parallel suites ----------------------------------------------

#: every world tensor parallel, and the reference dryrun's layout at n 8
TP, TP3D = MeshSpec(tp=-1), MeshSpec(dp=-1, fsdp=2, tp=2)
#: the parameter whose gradient blocks are held to the reference's
GRAD_LEAF = "layers.0.wq"


def tp_tiny(params: dict, spec: MeshSpec, n0: int, **kw) -> ElasticTrainer:
    """The TINY trainer laid out by the transformer's partition specs."""
    return tiny_trainer(params, param_sharding=tfm.param_partition_specs(
        tfm.TINY), spec=spec, initial_world_size=n0, **kw)


def step_seeing_grads(trainer: ElasticTrainer, batch, names) -> tuple:
    """(loss, {name: this rank's reduced gradient block}) of one step: the
    blocks as the optimizer is handed them."""
    opt, seen = trainer.state.opt_state, {}
    real = opt.step

    def step(*a, **k):
        for n in names:
            seen[n] = trainer.shards[n].grad.detach().numpy().copy()
        return real(*a, **k)

    opt.step = step
    try:
        loss = trainer.step(batch)
    finally:
        del opt.step
    return loss, seen


def norms(trainer: ElasticTrainer) -> dict:
    """This rank's copies of the leaves no axis splits (the norms)."""
    return {n: s.detach().numpy().copy() for n, s in trainer.shards.items()
            if set(trainer.partition_specs()[n]) <= {None}}


def tp_parity(trainer: ElasticTrainer, batches: list) -> dict:
    """The eval loss at init, three steps (the first's census and
    gradient blocks), and what each rank holds after them."""
    got = dict(eval=trainer.eval_loss(batches[0]))
    elastic.reset_census()
    loss, grads = step_seeing_grads(trainer, batches[0], [GRAD_LEAF])
    got.update(census=elastic.collective_census(), grad=grads[GRAD_LEAF])
    got["losses"] = [loss] + [trainer.step(b) for b in batches[1:]]
    got.update(full=full_numpy(trainer), norms=norms(trainer),
               specs=trainer.partition_specs(),
               shapes={n: tuple(s.shape) for n, s in trainer.shards.items()},
               opt_shapes={n: sorted(tuple(v.shape) for v in
                                     trainer.state.opt_state.state[s].values()
                                     if v.dim())
                           for n, s in trainer.shards.items()})
    return got


def tp_accumulate(params: dict, spec: MeshSpec, n0: int, micro: list
                  ) -> dict:
    got = {}
    for mode in ("dp", "replicated"):
        t = tp_tiny(params, spec, n0, accum_mode=mode)
        got[mode] = dict(losses=[t.step_accumulate(micro) for _ in range(2)],
                         full=full_numpy(t))
    return got


def suite_tp_two(rank: int, world: int, store: str, tiny_params: dict,
                 batches: list, micro: list, flagship_kw: dict) -> dict:
    """tp 2 on two ranks: the entry point behind chip_smoke's phase (m) at
    TINY, then the tp collectives, JAX parity, accumulation and an abort
    on the same group."""
    from edl_tpu_torch.entry import flagship_tp_world
    from edl_tpu_torch.parallel import tensor_parallel as tpar
    from edl_tpu_torch.runtime.elastic import AccumulationAborted

    out = {}
    try:
        trainer, batch = flagship_tp_world(rank, world, store, device="cpu",
                                           **flagship_kw)
        seen = dict(world=trainer.world_size, live=trainer.live, losses=[],
                    resized=[], kept=[], sent=[], norms=[], census=None,
                    shares=None)
        for target in (1, 1, 2, 2, 1, 1):
            if target != trainer.world_size:
                before = full_numpy(trainer)
                elastic.reset_census()
                seen["resized"].append(trainer.resize(target))
                seen["sent"].append(sum(
                    slot["bytes"] for label, slot in
                    elastic.collective_census().items() if label != "world"))
                seen["kept"].append(all(
                    np.array_equal(before[k], v)
                    for k, v in full_numpy(trainer).items()))
            elastic.reset_census()
            seen["losses"].append(trainer.step(batch))
            if trainer.world_size == 2:
                seen["census"] = seen["census"] or elastic.collective_census()
                seen["norms"].append(norms(trainer))
                full, opt = trainer.full_shapes(), trainer.state.opt_state
                seen["shares"] = sorted({
                    t.numel() / int(np.prod(full[n]))
                    for n, s in trainer.shards.items()
                    for t in [s] + [v for v in opt.state[s].values()
                                    if v.dim()]
                    if any(trainer.partition_specs()[n])})
        seen["events"] = trainer.resize_events
        out["flagship_world"] = seen
    except Exception:
        out["flagship_world"] = ScenarioFailed(traceback.format_exc())
        return out

    def primitives(rank):
        """Each collective piece on its own, on inputs every rank draws
        alike from one seed; rank r holds block r of whatever is split."""
        ctx = tpar.TPContext(2, rank, lambda t, op: dist.all_reduce(t, op))
        g = torch.Generator().manual_seed(0)
        x, w = torch.randn(3, 5, generator=g), torch.randn(2, 3, 5,
                                                            generator=g)
        got = dict(x=x.numpy(), w=w.numpy())
        xc = x.clone().requires_grad_()
        y = tpar.copy_to_tp(xc, ctx)
        (y * w[rank]).sum().backward()
        got["copy"] = (y.detach().numpy(), xc.grad.numpy())
        parts = torch.randn(2, 3, 5, generator=g)
        pc = parts[rank].clone().requires_grad_()
        z = tpar.reduce_from_tp(pc, ctx)
        (z * w[0]).sum().backward()
        got.update(parts=parts.numpy(),
                   reduce=(z.detach().numpy(), pc.grad.numpy()))
        table = torch.randn(16, 4, generator=g)
        tokens = torch.randint(0, 16, (2, 6), generator=g)
        dy = torch.randn(2, 6, 4, generator=g)
        got.update(table=table.numpy(), tokens=tokens.numpy(),
                   dy=dy.numpy())
        for hot in (False, True):
            local = table[rank * 8:(rank + 1) * 8].clone().requires_grad_()
            e = tpar.vocab_parallel_embed(local, tokens, ctx, one_hot=hot,
                                          dtype=torch.float32)
            (e * dy).sum().backward()
            got[f"embed_{hot}"] = (e.detach().numpy(), local.grad.numpy())
        logits = 3 * torch.randn(2, 6, 16, generator=g)
        targets = torch.randint(0, 16, (2, 6), generator=g)
        lc = logits[..., rank * 8:(rank + 1) * 8].clone().requires_grad_()
        loss = tpar.vocab_parallel_cross_entropy(lc, targets, ctx)
        loss.backward()
        got.update(logits=logits.numpy(), targets=targets.numpy(),
                   ce=(float(loss), lc.grad.numpy()))
        return got

    def parity_tp2(rank):
        return tp_parity(tp_tiny(tiny_params, TP, 2), batches)

    def accumulate(rank):
        got = tp_accumulate(tiny_params, TP, 2, micro)
        t = tp_tiny(tiny_params, TP, 2)
        before = shard_digest(t)
        try:
            t.step_accumulate(micro, abort_after=2)
            aborted = False
        except AccumulationAborted:
            aborted = True
        got["abort"] = dict(aborted=aborted,
                            untouched=shard_digest(t) == before,
                            closed=tpar.current() is None,
                            loss=t.step(batches[0]))
        return got

    out.update(_run_scenarios([primitives, parity_tp2, accumulate], rank))
    return out


def suite_tp_eight(rank: int, world: int, store: str, tiny_params: dict,
                   batches: list, micro: list) -> dict:
    """tp on eight ranks: the reference dryrun's dp2×fsdp2×tp2 against
    JAX, the fsdp and replicated kinds on tp meshes, accumulation, and live
    resizes between spec layouts."""
    _join(rank, world, store)

    def parity_3d(rank):
        return tp_parity(tp_tiny(tiny_params, TP3D, 8), batches)

    def kinds(rank):
        got = {}
        for label, spec, kind, opt in (
                ("dp2xtp2 fsdp", MeshSpec(dp=2, tp=2), "fsdp", None),
                ("dp2xtp2 replicated", MeshSpec(dp=2, tp=2), "replicated",
                 None),
                ("fsdp2xtp2 fsdp sgd", MeshSpec(fsdp=2, tp=2), "fsdp", sgd)):
            t = tiny_trainer(tiny_params, opt, param_sharding=kind,
                             spec=spec, initial_world_size=4)
            elastic.reset_census()
            losses = [t.step(batches[0])]
            census = elastic.collective_census()
            losses += [t.step(b) for b in batches[1:]]
            got[label] = dict(
                losses=losses, live=t.live, census=census,
                full=full_numpy(t), digest=shard_digest(t),
                specs=t.partition_specs(),
                shapes={n: tuple(s.shape) for n, s in t.shards.items()})
        return got

    def accum_3d(rank):
        return tp_accumulate(tiny_params, TP3D, 8, micro)

    def resize_3d(rank):
        t = tp_tiny(tiny_params, TP, 2)
        got = dict(losses=[t.step(batches[0])], kept=[], shapes=[])
        for b, target in zip(batches[1:], (MeshShape(dp=2, fsdp=2, tp=2),
                                           MeshShape(fsdp=4))):
            before = full_numpy(t)
            ok = t.resize(target)
            got["kept"].append(ok and all(
                np.array_equal(before[k], v)
                for k, v in full_numpy(t).items()))
            got["shapes"].append(t.shape)
            got["losses"].append(t.step(b))
        got["events"] = t.resize_events
        return got

    return _run_scenarios([parity_3d, kinds, accum_3d, resize_3d], rank)


# -- the sharded checkpoint suites --------------------------------------------


def flat_state(trainer: ElasticTrainer):
    """The whole state (collective over the live group) as numpy by
    checkpoint path, on rank 0; None on the other ranks."""
    from edl_tpu_torch.runtime import checkpoint as ckpt

    tree = trainer.whole_state()
    if tree is None:
        return None
    return {k: torch.as_tensor(v).numpy().copy()
            for k, v in ckpt._flatten(tree).items()}


def same_state(a: dict, b: dict) -> bool:
    """Two :func:`flat_state`s bitwise equal, leaf for leaf."""
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def save_whole(trainer: ElasticTrainer, ck, step: int) -> None:
    """Every rank: the trainer's whole state saved at ``step`` by rank 0,
    the other live ranks gathering with it."""
    if trainer.rank == 0:
        ck.save(step, trainer.whole_state)
    else:
        trainer.whole_state()
    dist.barrier()


def hyper(trainer: ElasticTrainer) -> list:
    return [{k: v for k, v in g.items() if k != "params"}
            for g in trainer.state.opt_state.param_groups]


def trainer_tree(trainer: ElasticTrainer) -> dict:
    return {"params": trainer.state.params, "opt": trainer.state.opt_state}


def tiny_fresh(**kw) -> ElasticTrainer:
    """The port's TINY transformer from another seed than the saved state,
    under adamw(1e-3) on the CPU: what a restore must overwrite."""
    return ElasticTrainer(tfm.loss_fn,
                          tfm.Transformer(tfm.TINY, device="cpu", seed=7),
                          optim.adamw(1e-3), devices=[torch.device("cpu")],
                          **kw)


#: the layouts a state is saved from: (initial world, trainer keywords)
SAVE_LAYOUTS = {
    "replicated1": (1, {}),
    "fsdp2": (2, dict(param_sharding="fsdp", spec=FSDP)),
    "tp2": (2, dict(param_sharding=tfm.param_partition_specs(tfm.TINY),
                    spec=MeshSpec(tp=-1))),
    "dp2xfsdp2": (4, dict(param_sharding=tfm.param_partition_specs(tfm.TINY),
                          spec=MeshSpec(dp=-1, fsdp=2))),
}
#: the layouts a state is restored into
RESTORE_LAYOUTS = ("replicated1", "fsdp2", "tp2")


def suite_sharded(rank: int, world: int, store: str, tiny_params: dict,
                  batches: list, tokens: tuple, mlp_params: dict,
                  data: tuple, seed: int) -> dict:
    """The sharded trainer's checkpoint lineage on eight ranks: a TINY
    state saved from every layout and restored into every other, the
    manifests of one state saved by three layouts, a torn newest step on an
    fsdp trainer, a tp job's kill and restore, and the durable loop's
    scenarios of tests/test_accuracy_elasticity.py on fsdp MLP trainers."""
    from edl_tpu_torch.observability.collector import get_counters
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.elastic import AccumulationAborted
    from edl_tpu_torch.runtime.virtual import (VirtualBatches, VirtualConfig,
                                               VirtualWorkerLoop)

    _join(rank, world, store)
    tmp = Path(store).parent

    def saver(label: str) -> ElasticTrainer:
        n0, kw = SAVE_LAYOUTS[label]
        return tiny_trainer(tiny_params, initial_world_size=n0, **kw)

    def target(label: str) -> ElasticTrainer:
        n0, kw = SAVE_LAYOUTS[label]
        return tiny_fresh(initial_world_size=n0, **kw)

    def matrix(rank):
        """Each saver takes two steps and saves; each target restores that
        step, and its gathered state is held to the saved one."""
        got = {}
        for label in SAVE_LAYOUTS:
            t = saver(label)
            for b in batches[:2]:
                t.step(b)
            saved = flat_state(t)
            ck = ElasticCheckpointer(tmp / f"matrix-{label}")
            save_whole(t, ck, t.state.step)
            for into in RESTORE_LAYOUTS:
                u = target(into)
                ck.restore(trainer_tree(u), shardings=u)
                mine = flat_state(u)
                got[label, into] = dict(
                    live=u.live, step=ck.last_restored_step,
                    hash_ok=ck.last_restore_hash_ok,
                    hyper=hyper(u) == hyper(t),
                    equal=None if mine is None else same_state(saved, mine),
                    counts=None if mine is None else sorted(
                        {float(v) for k, v in mine.items()
                         if k.endswith("['step']")}))
        return got

    def manifests(rank):
        """One state (two steps of the replicated trainer), saved again by
        an fsdp-2 and a tp-2 trainer that restored it."""
        t = saver("replicated1")
        for b in batches[:2]:
            t.step(b)
        state = flat_state(t)
        ck = ElasticCheckpointer(tmp / "manifest-replicated1")
        save_whole(t, ck, 2)
        got = dict(state=state, manifests={
            "replicated1": ck.manifest(2) if rank == 0 else None})
        for label in ("fsdp2", "tp2"):
            u = target(label)
            ck.restore(trainer_tree(u), shardings=u)
            again = ElasticCheckpointer(tmp / f"manifest-{label}")
            save_whole(u, again, 2)
            got["manifests"][label] = again.manifest(2) if rank == 0 else None
        return got

    def torn(rank):
        """An fsdp-2 trainer saves steps 1 and 2; rank 0 tears step 2; a
        fresh fsdp-2 trainer's restore falls back to 1 on every rank."""
        t = tiny_trainer(tiny_params, initial_world_size=2,
                         param_sharding="fsdp", spec=FSDP)
        directory = tmp / "torn"
        ck = ElasticCheckpointer(directory)
        t.step(batches[0])
        first = flat_state(t)
        save_whole(t, ck, 1)
        t.step(batches[1])
        save_whole(t, ck, 2)
        if rank == 0:
            files = [p for p in (directory / "2").rglob("*") if p.is_file()]
            victim = max(files, key=lambda p: p.stat().st_size)
            with open(victim, "r+b") as f:
                f.truncate(victim.stat().st_size // 2)
        dist.barrier()
        counters = get_counters()
        c0 = (counters.get("checkpoint_corruption_detected"),
              counters.get("recoveries_completed", type="corrupt_checkpoint"))
        u = tiny_fresh(initial_world_size=2, param_sharding="fsdp", spec=FSDP)
        fresh = ElasticCheckpointer(directory)
        fresh.restore(trainer_tree(u), shardings=u)
        mine = flat_state(u)
        return dict(
            step=fresh.last_restored_step, hash_ok=fresh.last_restore_hash_ok,
            corruption=counters.get("checkpoint_corruption_detected") - c0[0],
            recoveries=counters.get("recoveries_completed",
                                    type="corrupt_checkpoint") - c0[1],
            equal=None if mine is None else same_state(first, mine),
            live=u.live)

    treg = ShardRegistry()
    tids = treg.register_arrays(tokens, num_shards=8)
    tcfg = VirtualConfig(vw_count=4, global_batch=8, job_seed=seed)

    def tp_kill(rank):
        """A tp-2 job killed mid-accumulation after step 4 and restored at
        the same layout, against the same schedule unkilled."""
        def job():
            return tiny_trainer(tiny_params, initial_world_size=2,
                                accum_mode="replicated",
                                **SAVE_LAYOUTS["tp2"][1])

        def batches_():
            return VirtualBatches(tcfg, tids, treg.get)

        control = VirtualWorkerLoop(job(), tcfg, batches_()).run(
            max_steps=6).losses
        ck = ElasticCheckpointer(tmp / "tp-kill")
        t, vb = job(), batches_()
        first = VirtualWorkerLoop(t, tcfg, vb, checkpointer=ck,
                                  ckpt_every=2).run(max_steps=4)
        try:
            t.step_accumulate(vb.next_step(), abort_after=2)
            killed = False
        except AccumulationAborted:
            killed = True
        loop = VirtualWorkerLoop(job(), tcfg, batches_(), checkpointer=ck,
                                 ckpt_every=2)
        restored = loop.restore_latest()
        second = loop.run(max_steps=2)
        return dict(control=control, stitched=first.losses + second.losses,
                    restored=restored, killed=killed, live=t.live)

    # the durable loop on fsdp MLP trainers, as suite_virtual runs it on
    # replicated ones
    cfg = VirtualConfig(vw_count=8, global_batch=64, job_seed=seed)
    reg = ShardRegistry()
    ids = reg.register_arrays(data, num_shards=16)
    walk_4_2_8 = lambda s: 4 if s < 7 else (2 if s < 14 else 8)  # noqa
    control_4 = lambda s: 4  # noqa: E731

    def mlp_job(n, sharding):
        model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                          mlp_params)
        kw = (dict(param_sharding="fsdp", spec=FSDP) if sharding == "fsdp"
              else {})
        return ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                              devices=[torch.device("cpu")],
                              initial_world_size=n, accum_mode="replicated",
                              **kw)

    def vbatches():
        return VirtualBatches(cfg, ids, reg.get, passes=2)

    def rows_of(*reps) -> dict:
        rows: dict[int, int] = {}
        for rep in reps:
            for gid, c in rep.rows_trained.items():
                rows[gid] = rows.get(gid, 0) + c
        return rows

    def durable_fsdp(rank):
        """The replicated control on world 4; the 4→2→8 walk on fsdp; and
        the kill mid-accumulation after step 10 on fsdp 2, restored on
        fresh fsdp trainers of 2 and run to step 20 through 2→8."""
        control = VirtualWorkerLoop(mlp_job(4, "replicated"), cfg,
                                    vbatches()).run(
            max_steps=20, world_size_for=control_4)
        walk = VirtualWorkerLoop(mlp_job(4, "fsdp"), cfg, vbatches()).run(
            max_steps=20, world_size_for=walk_4_2_8)
        ck = ElasticCheckpointer(tmp / "fsdp-kill")
        t, vb = mlp_job(4, "fsdp"), vbatches()
        first = VirtualWorkerLoop(t, cfg, vb, checkpointer=ck,
                                  ckpt_every=5).run(
            max_steps=10, world_size_for=walk_4_2_8)
        try:
            t.step_accumulate(vb.next_step(), abort_after=3)
            killed = False
        except AccumulationAborted:
            killed = True
        loop = VirtualWorkerLoop(mlp_job(2, "fsdp"), cfg, vbatches(),
                                 checkpointer=ck, ckpt_every=5)
        restored = loop.restore_latest()
        second = loop.run(max_steps=10, world_size_for=walk_4_2_8)
        ck.close()
        return dict(
            control=control.losses, control_rows=control.rows_trained,
            walk=walk.losses, walk_worlds=walk.world_sizes,
            walk_resizes=walk.resizes, walk_rows=rows_of(walk),
            killed=killed, live=t.live, restored=restored,
            stitched=first.losses + second.losses, rows=rows_of(first, second),
            saved=sorted(int(p.name) for p in (tmp / "fsdp-kill").iterdir()
                         if p.name.isdigit()))

    return _run_scenarios([matrix, manifests, torn, tp_kill, durable_fsdp],
                          rank)


def suite_lineage(rank: int, world: int, store: str, tiny_params: dict,
                  batches: list, directory: str) -> dict:
    """Two ranks: an fsdp-2 TINY trainer takes a step, saves it as step 1
    of the lineage at ``directory``, takes another and saves step 2; rank
    0 returns the weights it saved last, by checkpoint path."""
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

    _join(rank, world, store)

    def write(rank):
        t = tiny_trainer(tiny_params, param_sharding="fsdp", spec=FSDP)
        ck = ElasticCheckpointer(directory)
        for step, b in enumerate(batches[:2], 1):
            t.step(b)
            save_whole(t, ck, step)
        state = flat_state(t)
        return None if state is None else {
            k: v for k, v in state.items() if k.startswith("['params']")}

    return _run_scenarios([write], rank)


# -- the prewarm suites -------------------------------------------------------


def suite_prewarm(rank: int, world: int, store: str, data: tuple) -> dict:
    """tests/test_prewarm.py's scenarios on MLP trainers over gloo, in a
    world of 2 (a trainer on 1 growing to 2) or 4 (on 2 growing to 3,
    whose prefix group is a new one): every rank calls prewarm, quiesce
    and resize at the same points."""
    from concurrent.futures import Future

    from edl_tpu_torch.observability.collector import get_counters
    from edl_tpu_torch.parallel.mesh import submit_build

    _join(rank, world, store)
    x, y = data
    batch = (x[:48], y[:48])  # splits over 1, 2, 3 and 4 ranks
    n0, grow = (1, 2) if world == 2 else (2, 3)
    #: every other layout of this world, and a cache limit they overflow
    hints = ([2, MeshShape(fsdp=2)] if world == 2 else
             [3, 4, MeshShape(fsdp=2), MeshShape(fsdp=4),
              MeshShape(dp=2, fsdp=2)])
    limit = len(hints) // 2
    swing = world if world == 4 else MeshShape(fsdp=2)

    def counting():
        calls = []
        real = dist.new_group

        def count(*a, **k):
            calls.append(a)
            return real(*a, **k)

        dist.new_group = count
        return calls, real

    def hit_skips_build(rank):
        t = mlp_trainer(n0)
        t.step(batch)
        got = dict(future=isinstance(t.prewarm([grow], wait=True), Future),
                   resized=t.resize(grow))
        got.update(event=t.resize_events[-1], loss=t.step(batch),
                   world=t.world_size)
        return got

    def mid_prewarm_waits(rank):
        t = mlp_trainer(n0)
        t.step(batch)
        before = get_counters().get("mesh_prewarms")
        calls, real = counting()
        try:
            # a slow build ahead of it keeps the prewarm in flight
            submit_build(time.sleep, 0.5)
            t.prewarm([grow])
            building = t.is_building(grow)
            resized = t.resize(grow)
        finally:
            dist.new_group = real
        return dict(building=building, resized=resized,
                    hit=t.resize_events[-1]["prewarm_hit"],
                    cached=t._cache_key(t.shape) in t._step_cache,
                    in_flight=len(t._building), loss=t.step(batch),
                    prewarms=get_counters().get("mesh_prewarms") - before,
                    new_groups=[list(a[0]) for a in calls])

    def unused_bounded(rank):
        t = mlp_trainer(n0, prewarm_cache_limit=limit)
        t.step(batch)
        before = get_counters().get("prewarms_evicted")
        for target in hints:
            t.prewarm([target], wait=True)
        return dict(limit=limit, hints=len(hints),
                    speculative=sum(v == "prewarm"
                                    for v in t._sources.values()),
                    unused=len(t._prewarm_unused),
                    evicted=get_counters().get("prewarms_evicted") - before,
                    loss=t.step(batch))

    def used_exempt(rank):
        t = mlp_trainer(n0, prewarm_cache_limit=1)
        t.step(batch)
        t.prewarm([grow], wait=True)
        resized = t.resize(grow)
        live = t._step_cache[t._cache_key(t.shape)]
        for target in hints:
            t.prewarm([target], wait=True)  # eviction pressure
        return dict(resized=resized,
                    kept=t._step_cache.get(t._cache_key(t.shape)) is live)

    def rollback(rank):
        t = mlp_trainer(n0)
        t.step(batch)
        t.prewarm([grow], wait=True)
        real = elastic._fresh

        def no_memory(*a, **k):
            raise RuntimeError("planted: out of memory staging the resize")

        elastic._fresh = no_memory
        try:
            failed = t.resize(grow)
        finally:
            elastic._fresh = real
        got = dict(failed=failed, world=t.world_size,
                   resizes_failed=t.resizes_failed, loss=t.step(batch))
        got.update(retry=t.resize(grow),
                   hit=t.resize_events[-1]["prewarm_hit"],
                   after=t.step(batch))
        return got

    def skips_invalid(rank):
        t = mlp_trainer(n0)
        return t.prewarm([0, -1, 10_000, t.world_size, None,
                          MeshShape(ep=2)])

    def event_split(rank):
        hits = get_counters().get("prewarm_hits")
        misses = get_counters().get("prewarm_misses")
        cold = mlp_trainer(n0)
        cold.step(batch)
        cold.resize(grow)
        warm = mlp_trainer(n0)
        warm.step(batch)
        warm.prewarm([grow], wait=True)
        warm.resize(grow)
        return dict(cold=cold.resize_events[-1], warm=warm.resize_events[-1],
                    hits=get_counters().get("prewarm_hits") - hits,
                    misses=get_counters().get("prewarm_misses") - misses)

    def oscillation(rank):
        got = {}
        for i, sizes in enumerate(((grow, swing), (swing, grow))):
            t = mlp_trainer(n0)
            losses = [t.step(batch) for _ in range(3)]
            seen = []
            for n in sizes + (n0,):
                t.prewarm([n], wait=True)
                seen.append((t.resize(n), t.resize_events[-1]["prewarm_hit"]
                             if t.resize_events else None))
                losses += [t.step(batch) for _ in range(3)]
            got[i] = dict(losses=losses, seen=seen)
        return got

    def prewarm_then_inline(rank):
        """Speculative builds queued, then a resize to a layout none of
        them builds (its groups built inline, queued behind them), then one
        that was prewarmed; against the same resizes cold."""
        other = MeshShape(fsdp=2) if world == 2 else MeshShape(dp=2, fsdp=2)
        t = mlp_trainer(n0)
        t.step(batch)
        t.prewarm([grow, world])  # 2 is the world of 2's grow
        ok = [t.resize(other)]
        t.step(batch)
        ok.append(t.resize(grow))
        t.step(batch)
        cold = mlp_trainer(n0)
        cold.step(batch)
        ok.append(cold.resize(other))
        cold.step(batch)
        ok.append(cold.resize(grow))
        cold.step(batch)
        return dict(ok=ok, hits=[e["prewarm_hit"] for e in t.resize_events],
                    same=digest(t) == digest(cold), quiet=t.prewarm_quiesce())

    return _run_scenarios(
        [mid_prewarm_waits, hit_skips_build, unused_bounded, used_exempt,
         rollback, skips_invalid, event_split, oscillation,
         prewarm_then_inline], rank)


# -- the SDC suite ------------------------------------------------------------


def suite_sdc(rank: int, world: int, store: str, mlp_params: dict,
              tiny_params: dict, data: tuple, seed: int, strike: dict,
              seams: list) -> dict:
    """The SDC plane on two ranks: the drills on a replicated MLP job that
    grows 1→2 (rank 0 judges, both ranks take its verdict), and the
    trainer's seams on replicated, fsdp and tp TINY trainers."""
    from edl_tpu_torch.runtime.checkpoint import (ElasticCheckpointer,
                                                  param_path)
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.faults import (CorruptGradient, FaultContext,
                                              FaultPlan, FaultPlanEngine,
                                              PoisonLoss)
    from edl_tpu_torch.runtime.sdc import (AnomalyDetector, SdcPlane,
                                           ShadowRecompute,
                                           UpdateFingerprinter)
    from edl_tpu_torch.runtime.virtual import (VirtualBatches, VirtualConfig,
                                               VirtualWorkerLoop)

    _join(rank, world, store)
    tmp = Path(store).parent
    cfg = VirtualConfig(vw_count=8, global_batch=64, job_seed=seed)
    reg = ShardRegistry()
    ids = reg.register_arrays(data, num_shards=16)
    cpu = torch.device("cpu")
    grow = lambda s: 1 if s < 4 else 2  # noqa: E731

    def trainer(n, **kw):
        model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                          mlp_params)
        return ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                              devices=[cpu], initial_world_size=n,
                              accum_mode="replicated", **kw)

    def batches():
        return VirtualBatches(cfg, ids, reg.get, passes=2)

    def plane(ck=None):
        shadow = ShadowRecompute(lambda: trainer(1), batches, cfg,
                                 checkpointer=ck)
        return SdcPlane(fingerprinter=UpdateFingerprinter(),
                        detector=AnomalyDetector(), shadow=shadow,
                        checkpointer=ck)

    def run(sdc=None, ck=None, on_step=None, tr=None):
        tr = tr or trainer(grow(0))
        loop = VirtualWorkerLoop(tr, cfg, batches(), checkpointer=ck,
                                 ckpt_every=5 if ck else 0, sdc=sdc)
        rep = loop.run(max_steps=14, world_size_for=grow, on_step=on_step)
        return dict(losses=rep.losses, rows=dict(rep.rows_trained),
                    rollbacks=rep.rollbacks, live=tr.live, digest=digest(tr),
                    verdicts=[(v.step, v.trigger, v.outcome, v.rollback_step)
                              for v in sdc.verdicts] if sdc else [],
                    suspects=[v.suspects for v in sdc.verdicts] if sdc
                    else [])

    def control(rank):
        return run()

    def flip_drill(rank, kind="replicated", **kw):
        ck = ElasticCheckpointer(tmp / f"ckpt-flip-{kind}")
        tr = trainer(grow(0), **kw)
        fired = []

        def on_step(step, loss, world_size):
            if step == 7 and not fired:
                fired.append(step)
                tr.flip_param_bits(**strike)

        got = run(plane(ck), ck, on_step, tr)
        ck.close()
        got.pop("digest")  # a sharded rank's digest is of its blocks
        return dict(got, fired=fired,
                    params={k: v.tolist()
                            for k, v in full_numpy(tr).items()}
                    if tr.live else None)

    def fsdp_flip_drill(rank):
        return flip_drill(rank, "fsdp", param_sharding="fsdp", spec=FSDP)

    def sharded_fingerprints(rank):
        """The fingerprint of fsdp-2, tp-2 and an odd-shaped bf16 fsdp-2
        trainer's blocks, folded where they live and combined, against the
        host fold of the whole parameters."""
        from edl_tpu_torch.runtime.sdc import (BlockFolds, fold_fingerprint,
                                               leaf_fold)

        class Odd(torch.nn.Module):
            def __init__(self):
                super().__init__()
                gen = torch.Generator().manual_seed(7)
                self.a = torch.nn.Parameter(torch.randn(
                    6, 5, generator=gen).to(torch.bfloat16))
                self.b = torch.nn.Parameter(torch.randn(
                    3, 7, generator=gen).to(torch.bfloat16))
                self.c = torch.nn.Parameter(torch.randn(
                    4, 3, generator=gen))

        def odd_loss(model, batch):
            return sum((p.float() ** 2).sum() for p in model.parameters())

        trainers = {
            "fsdp": tiny_trainer(tiny_params, initial_world_size=2,
                                 param_sharding="fsdp", spec=FSDP),
            "tp": tiny_trainer(tiny_params, initial_world_size=2,
                               param_sharding=tfm.param_partition_specs(
                                   tfm.TINY), spec=MeshSpec(tp=-1)),
            "odd": ElasticTrainer(odd_loss, Odd(), optim.adam(1e-2),
                                  devices=[cpu], param_sharding="fsdp",
                                  spec=FSDP)}
        got = {}
        for name, t in trainers.items():
            def whole(t=t):
                return {interop.keystr(param_path(n)): p
                        for n, p in t.full_params().items()}

            fp = UpdateFingerprinter().fingerprint(BlockFolds(
                lanes=t.lane_folds, whole=whole, device=t.device))
            got[name] = dict(
                fp=fp, split=sorted(n for n, spec in
                                    t.partition_specs().items() if any(spec)),
                host=fold_fingerprint({k: leaf_fold(v)
                                       for k, v in whole().items()}))
        return got

    def poison_drill(rank):
        tr = trainer(grow(0))
        engine = FaultPlanEngine(FaultPlan(actions=[PoisonLoss(at_step=6)]),
                                 FaultContext(trainer=tr))
        got = run(plane(), None, engine, tr)
        return dict(got, quiescent=engine.quiescent(),
                    recovered=engine.recovered)

    def corrupt_drill(rank):
        """A corrupt gradient on rank 1's replica alone: the replicas'
        fingerprints split, and the shadow names rank 1."""
        ck = ElasticCheckpointer(tmp / "ckpt-corrupt")
        tr = trainer(grow(0))
        actions = [CorruptGradient(at_step=7)] if rank == 1 else []
        engine = FaultPlanEngine(FaultPlan(actions=actions),
                                 FaultContext(trainer=tr))
        got = run(plane(ck), ck, engine, tr)
        ck.close()
        return dict(got, quiescent=engine.quiescent(),
                    recovered=engine.recovered)

    def seams_by_layout(rank):
        """For each layout, the whole params: after one step clean and
        after the same step with each gradient strike (SGD, so a struck
        gradient shows in the params), and at init with and without the
        parameter flips."""
        tokens = np.random.default_rng(5).integers(0, 256, (4, 33))
        micro = [(tokens[i:i + 2, :-1], tokens[i:i + 2, 1:])
                 for i in (0, 2)]
        layouts = {"replicated": {},
                   "fsdp": dict(param_sharding="fsdp", spec=FSDP),
                   "tp": dict(param_sharding=tfm.param_partition_specs(
                       tfm.TINY), spec=MeshSpec(tp=-1))}
        got = {}
        for name, kw in layouts.items():
            def fresh():
                return tiny_trainer(tiny_params, optimizer=sgd,
                                    initial_world_size=2,
                                    accum_mode="replicated", **kw)

            out = {}
            for run_name, strike_at in (("clean", None), ("grad0", 0),
                                        ("grad1", 1)):
                t = fresh()
                if strike_at is not None:
                    t.inject_update_corruption(1, **seams[strike_at])
                t.step_accumulate(micro)
                out[run_name] = full_numpy(t)
            t = fresh()
            out["init"] = full_numpy(t)
            for flip in seams[2:]:
                t.flip_param_bits(**flip)
            out["flipped"] = full_numpy(t)
            got[name] = out
        return got

    return _run_scenarios([control, flip_drill, fsdp_flip_drill,
                           poison_drill, corrupt_drill, sharded_fingerprints,
                           seams_by_layout], rank)


# -- BERT's tensor parallelism -------------------------------------------------


def bert_tiny(params: dict, spec: MeshSpec, n0: int, **kw) -> ElasticTrainer:
    """The port's TINY BERT holding the JAX params ``params``, laid out by
    its partition specs, under adamw(1e-3) on the CPU."""
    from edl_tpu_torch.models import bert

    model = interop.params_from_numpy(bert.Bert(bert.TINY, device="cpu"),
                                      params)
    return ElasticTrainer(bert.mlm_loss_fn, model, optim.adamw(1e-3),
                          devices=[torch.device("cpu")],
                          param_sharding=bert.param_partition_specs(
                              bert.TINY), spec=spec, initial_world_size=n0,
                          **kw)


def suite_bert_tp_two(rank: int, world: int, store: str, bert_params: dict,
                      batches: list, world_kw: dict) -> dict:
    """BERT at tp 2 on two ranks: the entry point behind chip_smoke's phase
    (r) at TINY, the weighted vocab-parallel cross entropy, and JAX
    parity."""
    from edl_tpu_torch.entry import bert_tp_world
    from edl_tpu_torch.parallel import tensor_parallel as tpar

    out = {}
    try:
        trainer, batch = bert_tp_world(rank, world, store, device="cpu",
                                       **world_kw)
        full, opt = trainer.full_shapes(), trainer.state.opt_state
        seen = dict(world=trainer.world_size, losses=[], norms=[],
                    shares=sorted({
                        t.numel() / int(np.prod(full[n]))
                        for n, s in trainer.shards.items()
                        for t in [s] + [v for v in opt.state[s].values()
                                        if v.dim()]
                        if any(trainer.partition_specs()[n])}))
        for _ in range(3):
            seen["losses"].append(trainer.step(batch))
            seen["norms"].append(norms(trainer))
        out["bert_world"] = seen
    except Exception:
        out["bert_world"] = ScenarioFailed(traceback.format_exc())
        return out

    def weighted_ce(rank):
        """The masked loss's vocab-parallel cross entropy on inputs every
        rank draws alike from one seed, rank r holding columns block r,
        for a 15 % mask and an all-zero one."""
        ctx = tpar.TPContext(2, rank, lambda t, op: dist.all_reduce(t, op))
        g = torch.Generator().manual_seed(1)
        logits = 3 * torch.randn(2, 6, 16, generator=g)
        targets = torch.randint(0, 16, (2, 6), generator=g)
        got = dict(logits=logits.numpy(), targets=targets.numpy())
        for name, mask in (("mask", (torch.rand(2, 6, generator=g) < 0.3)
                            .float()), ("zeros", torch.zeros(2, 6))):
            lc = logits[..., rank * 8:(rank + 1) * 8].clone(
                ).requires_grad_()
            loss = tpar.vocab_parallel_cross_entropy(
                lc, targets, ctx, weights=mask,
                denom=tpar.weight_total(mask))
            loss.backward()
            got[name] = (mask.numpy(), float(loss), lc.grad.numpy())
        return got

    def blocks_vs_whole(rank):
        """This rank's tp-2 blocks of the JAX init in a tp context: the
        hidden states, the masked loss and each leaf's gradient, by the
        gather and the one-hot embedding."""
        from edl_tpu_torch.models import bert
        from edl_tpu_torch.parallel.replan import tree_placements

        ctx = tpar.TPContext(2, rank, lambda t, op: dist.all_reduce(t, op))
        batch = tuple(torch.from_numpy(a) for a in batches[0])
        got = {}
        for hot in (False, True):
            cfg = dataclasses.replace(bert.TINY, one_hot_embed=hot)
            model = interop.params_from_numpy(bert.Bert(cfg, device="cpu"),
                                              bert_params)
            place = tree_placements(dict(model.named_parameters()),
                                    MeshShape(tp=2),
                                    bert.param_partition_specs(cfg))
            for name, p in model.named_parameters():
                idx = tuple(slice(lo, hi)
                            for lo, hi in place[name].blocks[rank])
                p.data = p.data[idx].clone()
            with tpar.tp_context(ctx):
                h = bert.apply(model, batch[0])
                loss = bert.mlm_loss_fn(model, batch)
                loss.backward()
            got[hot] = (h.detach().numpy(), float(loss),
                        {n: p.grad.numpy()
                         for n, p in model.named_parameters()})
        return got

    def parity_tp2(rank):
        return tp_parity(bert_tiny(bert_params, TP, 2), batches)

    out.update(_run_scenarios([weighted_ce, blocks_vs_whole, parity_tp2],
                              rank))
    return out


def suite_bert_tp_eight(rank: int, world: int, store: str,
                        bert_params: dict, batches: list) -> dict:
    """BERT on dp2×fsdp2×tp2 over eight ranks against the reference's
    jitted step."""
    _join(rank, world, store)

    def parity_3d(rank):
        return tp_parity(bert_tiny(bert_params, TP3D, 8), batches)

    return _run_scenarios([parity_3d], rank)


# -- the elastic job the control plane dials ----------------------------------


def _lease_job(rank: int, mlp_params: dict, data: tuple, dial: dict,
               ghost_at=None, coord=None, shape_for=None, **kw) -> dict:
    """One rank's side of a lease-path LocalElasticJob on the port's MLP
    (the JAX init ``mlp_params``, adam(1e-2)) over 8 tasks of 64 rows:
    rank 0 holds a FakeCluster whose trainer count it turns to ``dial[k]``
    after step k, and a coordinator (``coord``, default PyCoordService)
    from which, after step ``ghost_at``, a second lease holder takes a
    task and dies.  Returns what each rank saw."""
    from edl_tpu_torch.api.types import (ResourceRequirements, TrainerSpec,
                                         TrainingJob, TrainingJobSpec)
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.coord import PyCoordService
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.local import LocalElasticJob

    model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                      mlp_params)
    trainer = ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                             devices=[torch.device("cpu")],
                             initial_world_size=1)
    job = cluster = None
    fetched: list = []
    reg = ShardRegistry()
    ids = reg.register_arrays(data, num_shards=8)
    if rank == 0:
        coord = coord or PyCoordService()
        cluster = FakeCluster()
        for i in range(2):
            cluster.add_node(f"n{i}", cpu_milli=16000, memory_mega=64000)
        job = TrainingJob(name="lease", spec=TrainingJobSpec(
            fault_tolerant=True, trainer=TrainerSpec(
                min_instance=1, max_instance=2,
                resources=ResourceRequirements(requests={"cpu": "1"}))))
        cluster.create_resources(job)
        reg.enqueue(coord, ids)
    else:
        coord = None

    def fetch(payload):
        fetched.append(json.loads(payload.decode())["shard"])
        return reg.fetch(payload)

    runner = LocalElasticJob(job, cluster, trainer, coord, fetch=fetch,
                             batch_size=64, shape_for=shape_for,
                             job_name="default/lease", **kw)

    def on_step(step, loss, world):
        if cluster is not None and step in dial:
            cluster.update_trainer_parallelism(job, dial[step])
        if coord is not None and step == ghost_at:
            coord.lease("ghost")
            coord.release_worker("ghost")

    rep = runner.run(on_step=on_step)
    return dict(losses=rep.losses, worlds=rep.world_sizes,
                resizes=rep.resizes, steps=rep.steps, fetched=fetched,
                all_done=coord.all_done() if coord is not None else None,
                prewarm_hits=rep.prewarm_hits, data_ms=rep.data_ms,
                deferred=rep.resize_deferred_steps,
                events=trainer.resize_events)


class FailingCoord:
    """A coordinator whose ``lease`` raises from its ``fail_at``-th call."""

    def __init__(self, fail_at: int) -> None:
        from edl_tpu_torch.coord import PyCoordService

        self._inner, self._calls, self.fail_at = PyCoordService(), 0, fail_at

    def lease(self, worker: str):
        self._calls += 1
        if self._calls >= self.fail_at:
            raise ConnectionError("coordinator unreachable")
        return self._inner.lease(worker)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def suite_local(rank: int, world: int, store: str, mlp_params: dict,
                data: tuple, dial: dict, tiny_kw: dict) -> dict:
    """The lease path of LocalElasticJob on two ranks: JAX parity on the
    dial, a failing shape policy, a coordinator that fails on rank 0, and
    ``entry.flagship_local_job`` (chip_smoke's phase (q)) at TINY."""
    from edl_tpu_torch.entry import flagship_local_job

    out = {}
    try:
        runner, _, ids = flagship_local_job(rank, world, store,
                                            device="cpu", **tiny_kw)
        coord, cluster = runner.coord, runner.cluster

        def on_step(step, loss, w):
            if cluster is not None and step in dial:
                cluster.update_trainer_parallelism(runner.job, dial[step])
            if coord is not None and step == 2:
                coord.lease("ghost")
                coord.release_worker("ghost")

        elastic.reset_census()
        rep = runner.run(on_step=on_step)
        out["flagship_local"] = dict(
            losses=rep.losses, worlds=rep.world_sizes, resizes=rep.resizes,
            all_done=coord.all_done() if coord is not None else None,
            census=elastic.collective_census(), tasks=len(ids or []),
            prewarm_hits=rep.prewarm_hits,
            bytes_moved=rep.resize_bytes_moved)
    except Exception:
        out["flagship_local"] = ScenarioFailed(traceback.format_exc())
        return out

    def lease_parity(rank):
        return _lease_job(rank, mlp_params, data, dial, ghost_at=2,
                          resize_defer_s=0)

    def shape_fallback(rank):
        def policy(n):
            raise RuntimeError("no layout for you")
        return _lease_job(rank, mlp_params, data, dial, shape_for=policy,
                          prewarm_neighbors=False)

    def coord_error(rank):
        try:
            _lease_job(rank, mlp_params, data, dial,
                       coord=FailingCoord(4) if rank == 0 else None)
        except Exception as exc:
            return dict(raised=type(exc).__name__, message=str(exc))
        return dict(raised=None)

    def after_error(rank):
        """The group still works after a run rank 0 failed."""
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        return float(t)

    out.update(_run_scenarios([lease_parity, shape_fallback, coord_error,
                               after_error], rank))
    return out


def suite_local_four(rank: int, world: int, store: str, mlp_params: dict,
                     data: tuple, seed: int) -> dict:
    """tests/test_local_virtual.py and the dead-worker scenario of
    tests/test_accuracy_elasticity.py on four ranks."""
    from edl_tpu_torch.api.types import (ResourceRequirements, TrainerSpec,
                                         TrainingJob, TrainingJobSpec)
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.coord import local_service
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.local import LocalElasticJob
    from edl_tpu_torch.runtime.virtual import (OwnershipMap, VirtualBatches,
                                               VirtualConfig,
                                               VirtualWorkerLoop)

    _join(rank, world, store)
    tmp = Path(store).parent
    cfg = VirtualConfig(vw_count=4, global_batch=32, job_seed=seed)

    def trainer(n):
        model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                          mlp_params)
        return ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                              devices=[torch.device("cpu")],
                              initial_world_size=n,
                              accum_mode="replicated")

    def registry(n, shards):
        reg = ShardRegistry()
        return reg, reg.register_arrays((data[0][:n], data[1][:n]),
                                        num_shards=shards)

    def job_on(cluster, lo=1, hi=8):
        job = TrainingJob(name="vj", spec=TrainingJobSpec(
            fault_tolerant=True, trainer=TrainerSpec(
                min_instance=lo, max_instance=hi,
                resources=ResourceRequirements(requests={"cpu": "1"}))))
        cluster.create_resources(job)
        return job

    def virtual_drive(rank):
        reg, ids = registry(1024, 8)
        ctl = VirtualWorkerLoop(trainer(2), cfg,
                                VirtualBatches(cfg, ids, reg.get),
                                kv=local_service() if rank == 0 else None,
                                job="ctl")
        control = ctl.run(max_steps=16, world_size_for=lambda s: 2)
        job = cluster = coord = None
        if rank == 0:
            cluster = FakeCluster()
            for i in range(2):
                cluster.add_node(f"n{i}", cpu_milli=16000,
                                 memory_mega=64000)
            job = job_on(cluster)
            cluster.update_trainer_parallelism(job, 2)
            coord = local_service()
        runner = LocalElasticJob(
            job, cluster, trainer(2), coord, fetch=None, batch_size=32,
            virtual=cfg, shard_ids=ids, fetch_shard=reg.get,
            prewarm_neighbors=False, job_name="default/vj")
        grown = []

        def on_step(step, loss, world):
            if step >= 8 and not grown:
                if cluster is not None:  # the autoscaler dial
                    cluster.update_trainer_parallelism(job, 4)
                grown.append(True)

        rep = runner.run(max_steps=16, on_step=on_step)
        return dict(
            control=control.losses, losses=rep.losses, steps=rep.steps,
            resizes=rep.resizes, worlds=rep.world_sizes,
            duplicated=rep.virtual.rows_duplicated(),
            missing=rep.virtual.rows_missing(expected=16 * cfg.global_batch),
            published=None if coord is None else [
                coord.kv_get(f"vw-{k}/default/vj") is not None
                for k in ("map", "cursor")])

    def opt_out(rank):
        reg, ids = registry(1024, 8)
        job = cluster = coord = None
        if rank == 0:
            cluster = FakeCluster()
            cluster.add_node("n0", cpu_milli=16000, memory_mega=64000)
            job = job_on(cluster)
            coord = local_service()
            reg.enqueue(coord, ids[:2])
        runner = LocalElasticJob(
            job, cluster, trainer(1), coord, fetch=reg.fetch, batch_size=32,
            virtual=cfg, shard_ids=ids, fetch_shard=reg.get,
            use_virtual_batches=False, prewarm_neighbors=False)
        rep = runner.run(max_steps=4)
        return dict(steps=rep.steps, virtual=rep.virtual,
                    losses=rep.losses)

    def dead_workers(rank):
        reg, ids = registry(640, 5)  # 128-row shards: always mid-shard
        run_cfg = VirtualConfig(vw_count=4, global_batch=32, job_seed=0)
        kv = local_service() if rank == 0 else None
        ck = ElasticCheckpointer(tmp / "dead_workers")
        vb = VirtualBatches(run_cfg, ids, reg.get, passes=1)
        loop = VirtualWorkerLoop(trainer(4), run_cfg, vb, kv=kv,
                                 job="redispatch", checkpointer=ck,
                                 ckpt_every=1)
        rep1 = loop.run(max_steps=7, world_size_for=lambda s: 4)
        before = (OwnershipMap.load(kv, job="redispatch").mapping
                  if kv is not None else None)
        vb2 = VirtualBatches(run_cfg, ids, reg.get, passes=1)
        loop2 = VirtualWorkerLoop(trainer(2), run_cfg, vb2, kv=kv,
                                  job="redispatch", checkpointer=ck,
                                  ckpt_every=0)
        restored = loop2.restore_latest()
        rep2 = loop2.run(world_size_for=lambda s: 2)  # drain the pass
        after = (OwnershipMap.load(kv, job="redispatch").mapping
                 if kv is not None else None)
        ck.close()
        return dict(restored=restored, before=before, after=after,
                    reports=[dict(losses=r.losses,
                                  rows=dict(r.rows_trained))
                             for r in (rep1, rep2)],
                    dropped=vb2.rows_dropped_remainder)

    return _run_scenarios([virtual_drive, opt_out, dead_workers], rank)


# -- controlled jobs: the Controller, the autoscaler and the fault campaign ----


def _mlp_from(mlp_params: dict, n0: int) -> ElasticTrainer:
    """The port's MLP [16, 32, 4] holding the JAX init ``mlp_params`` under
    adam(1e-2) on the CPU, on a first world of ``n0``."""
    model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                      mlp_params)
    return ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                          devices=[torch.device("cpu")],
                          initial_world_size=n0)


def _recording(reg, order: list):
    """``reg.fetch`` that also appends each leased shard id to ``order``
    (rank 0's training order, for the one-rank control)."""
    def fetch(payload):
        order.append(json.loads(payload.decode())["shard"])
        return reg.fetch(payload)
    return fetch


def _campaign_counts() -> dict:
    from edl_tpu_torch.observability.collector import get_counters
    from edl_tpu_torch.runtime.faults import TRAINING_KINDS

    c = get_counters()
    return dict(
        injected={k: c.get("faults_injected", type=k)
                  for k in TRAINING_KINDS},
        recovered={k: c.get("recoveries_completed", type=k)
                   for k in TRAINING_KINDS})


def suite_controlled(rank: int, world: int, store: str, mlp_params: dict,
                     data: tuple, seed: int, soak: dict) -> dict:
    """Controller-run jobs on two ranks: the seeded campaign of all eight
    training kinds (``entry.controlled_campaign`` on the MLP, the card
    released and taken back by a system pod so the autoscaler grows and
    shrinks the job), and a kill that leaves no trainer running (the job
    waits for the replacement; with none coming it raises on every
    rank)."""
    from edl_tpu_torch.entry import (control_plane, controlled_campaign,
                                     controlled_training_job)
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.local import LocalElasticJob

    _join(rank, world, store)
    tmp = Path(store).parent

    def job_on_plane(name, shards, work, **plane_kw):
        trainer = _mlp_from(mlp_params, 1)
        plane = reg = None
        order: list = []
        reg = ShardRegistry()
        ids = reg.register_arrays(data, num_shards=shards)
        if rank == 0:
            plane = control_plane(controlled_training_job(name, world),
                                  tmp / work, **plane_kw)
            reg.enqueue(plane.coord, ids)
        runner = LocalElasticJob(
            plane.job if plane else None, plane.cluster if plane else None,
            trainer, plane.coord if plane else None,
            fetch=_recording(reg, order), batch_size=64,
            job_name=f"default/{name}")
        return runner, plane, order

    def campaign(rank):
        runner, plane, order = job_on_plane(
            "soak", soak["shards"], "soak", held_nodes=("node1",))

        def elasticity(step, loss, w):
            if plane is None:
                return
            if step == soak["release_at"]:
                plane.cluster.remove_system_pod("hold-node1")
            if step == soak["return_at"]:
                plane.cluster.add_system_pod("hold-node1", "node1", gpus=1)
            time.sleep(0.01)  # let the control loops breathe

        got = controlled_campaign(runner, plane, seed,
                                  first_step=soak["first_step"],
                                  last_step=soak["last_step"],
                                  min_gap=soak["min_gap"],
                                  save_every=soak["save_every"],
                                  on_step=elasticity)
        rep = got["report"]
        out = dict(steps=rep.steps, worlds=rep.world_sizes,
                   losses=rep.losses, resizes=rep.resizes, order=order,
                   step_of_trainer=runner.trainer.state.step)
        if plane is not None:
            stats = plane.coord.stats()
            ticks = plane.controller.autoscaler.plan_history
            plane.close()
            out.update(
                {k: got[k] for k in ("plan", "fired", "recovered", "unfired",
                                     "quiescent", "stalls", "audit",
                                     "saves")},
                stats=dict(done=stats.done, todo=stats.todo,
                           leased=stats.leased, dropped=stats.dropped),
                ticks=ticks, leaked=plane.leaked_servers(),
                phase_events=len(got["steps"]), **_campaign_counts())
        return out

    def replacement(rank, arrives_after_s=0.5):
        """At step 3 the only trainer is killed while another tenant holds
        its node's card; the hold goes after ``arrives_after_s`` (never,
        with None)."""
        runner, plane, _ = job_on_plane(
            f"lone{arrives_after_s}", 8, f"lone{arrives_after_s}",
            nodes=(("node0", "nvlink0"),))
        waited: list = []

        def kill(step, loss, w):
            if plane is None or step != 3:
                return
            cluster = plane.cluster
            pod = cluster.list_pods(job_uid=plane.job.full_name,
                                    role="trainer")[0]
            cluster.add_system_pod("tenant", "node0", gpus=1)
            cluster.kill_pod(pod.name)
            t0 = time.monotonic()

            def free():
                cluster.remove_system_pod("tenant")
                cluster.reconcile()
                waited.append(time.monotonic() - t0)

            if arrives_after_s is not None:
                threading.Timer(arrives_after_s, free).start()

        try:
            rep = runner.run(on_step=kill)
        except Exception as exc:
            return dict(raised=type(exc).__name__, message=str(exc))
        finally:
            if plane is not None:
                plane.close()
        return dict(steps=rep.steps, worlds=rep.world_sizes, waited=waited)

    def no_replacement(rank):
        from edl_tpu_torch.runtime import local

        waited, local.REPLACEMENT_WAIT_S = local.REPLACEMENT_WAIT_S, 0.5
        try:
            return replacement(rank, arrives_after_s=None)
        finally:
            local.REPLACEMENT_WAIT_S = waited

    def after_error(rank):
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        return float(t)

    def flagship_controlled(rank):
        """chip_smoke's phase (t) at TINY on the CPU:
        ``entry.flagship_controlled_job`` under the same campaign and
        card schedule."""
        from edl_tpu_torch.entry import flagship_controlled_job

        runner, plane, _ = flagship_controlled_job(
            rank, world, store, device="cpu", cfg=tfm.TINY, global_batch=4,
            seq=32, rows=4 * soak["shards"], shards=soak["shards"],
            work_dir=tmp / "flagship-controlled")

        def elasticity(step, loss, w):
            if plane is not None and step == soak["release_at"]:
                plane.cluster.remove_system_pod("hold-node1")
            if plane is not None and step == soak["return_at"]:
                plane.cluster.add_system_pod("hold-node1", "node1", gpus=1)
            time.sleep(0.01)

        got = controlled_campaign(runner, plane, seed,
                                  first_step=soak["first_step"],
                                  last_step=soak["last_step"],
                                  min_gap=soak["min_gap"],
                                  save_every=soak["save_every"],
                                  on_step=elasticity)
        rep = got["report"]
        out = dict(steps=rep.steps, worlds=rep.world_sizes,
                   losses=rep.losses)
        if plane is not None:
            stats = plane.coord.stats()
            plane.close()
            out.update(fired=got["fired"], quiescent=got["quiescent"],
                       stats=dict(done=stats.done, todo=stats.todo,
                                  leased=stats.leased,
                                  dropped=stats.dropped),
                       leaked=plane.leaked_servers())
        return out

    return _run_scenarios([campaign, replacement, no_replacement,
                           after_error, flagship_controlled], rank)


def suite_controlled_four(rank: int, world: int, store: str,
                          mlp_params: dict, data: tuple,
                          names: tuple) -> dict:
    """tests/test_elastic_e2e.py's two scenarios and
    tests/test_chaos_examples.py's repeated kills on four ranks (those of
    ``names``): a job a ``Controller`` runs on CPU pods (one node), its
    autoscaler growing it to 4 and shrinking it under competing load, a
    pod kill survived, a chaos monkey striking every 8 steps."""
    from edl_tpu_torch.api.types import (JobPhase, ResourceRequirements,
                                         TrainerSpec, TrainingJob,
                                         TrainingJobSpec)
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.controller import Controller
    from edl_tpu_torch.coord import local_service
    from edl_tpu_torch.runtime.chaos import ChaosMonkey
    from edl_tpu_torch.runtime.data import ShardRegistry
    from edl_tpu_torch.runtime.local import LocalElasticJob
    from edl_tpu_torch.scheduler.topology import POW2_POLICY

    _join(rank, world, store)

    def controlled(name, cpu_milli, lo, hi, rows, shards, passes=1,
                   **ctl_kw):
        """Rank 0: a one-node cluster, the Controller running the job (its
        phase Running before training starts), the coordinator with the
        rows as tasks; every rank: the runner."""
        trainer = _mlp_from(mlp_params, lo)
        reg = ShardRegistry()
        ids = reg.register_arrays((data[0][:rows], data[1][:rows]),
                                  num_shards=shards)
        order: list = []
        job = cluster = coord = ctl = None
        if rank == 0:
            cluster = FakeCluster()
            cluster.add_node("n0", cpu_milli=cpu_milli,
                             memory_mega=100_000)
            ctl = Controller(cluster, autoscaler_loop_seconds=0.02,
                             updater_convert_seconds=0.02,
                             updater_confirm_seconds=0.01, **ctl_kw)
            ctl.start()
            job = TrainingJob(name=name, spec=TrainingJobSpec(
                fault_tolerant=True, trainer=TrainerSpec(
                    min_instance=lo, max_instance=hi,
                    resources=ResourceRequirements(
                        requests={"cpu": "1", "memory": "100M"},
                        limits={"cpu": "1", "memory": "100M"}))))
            ctl.submit(job)
            deadline = time.monotonic() + 10
            while ctl.phase(job) != JobPhase.RUNNING:
                assert time.monotonic() < deadline, "job never started"
                time.sleep(0.01)
            coord = local_service(passes=passes)
            reg.enqueue(coord, ids)
        runner = LocalElasticJob(job, cluster, trainer, coord,
                                 fetch=_recording(reg, order),
                                 batch_size=64,
                                 job_name=f"default/{name}")
        return runner, ctl, cluster, job, order

    def summary(rep, ctl, job, order, **extra):
        out = dict(steps=rep.steps, worlds=rep.world_sizes,
                   losses=rep.losses, resizes=rep.resizes, order=order,
                   **extra)
        if ctl is not None:
            out["phase"] = ctl.phase(job).value
            ctl.stop()
        return out

    def scale_up_and_down(rank):
        runner, ctl, cluster, job, order = controlled(
            "train", 4000, 2, 4, 1024, 16, passes=2, max_load_desired=1.0,
            shape_policy=POW2_POLICY)

        def on_step(step, loss, w):
            if cluster is not None and step == 16:
                for i in range(2):
                    cluster.add_system_pod(f"nginx-{i}", "n0",
                                           cpu_request_milli=1000,
                                           memory_request_mega=100)
            time.sleep(0.01)  # let the control loops breathe

        return summary(runner.run(on_step=on_step), ctl, job, order)

    def pod_kill(rank):
        runner, ctl, cluster, job, order = controlled(
            "train", 8000, 2, 4, 1024, 8)
        killed = []

        def on_step(step, loss, w):
            if cluster is not None and step == 5 and not killed:
                pods = cluster.list_pods(job_uid=job.full_name,
                                         role="trainer")
                cluster.kill_pod(pods[0].name)
                killed.append(pods[0].name)
            time.sleep(0.01)

        rep = runner.run(on_step=on_step)
        return summary(rep, ctl, job, order, killed=killed)

    def chaos_monkey(rank):
        runner, ctl, cluster, job, order = controlled(
            "chaos", 8000, 2, 4, 2048, 8, passes=2)
        monkey = (ChaosMonkey(cluster, job, every_n_steps=8, max_kills=4)
                  if cluster is not None else None)

        def on_step(step, loss, w):
            if monkey is not None:
                monkey(step, loss, w)
            time.sleep(0.005)

        rep = runner.run(on_step=on_step)
        return summary(rep, ctl, job, order,
                       kills=list(monkey.kills) if monkey else [])

    return _run_scenarios([fn for fn in (scale_up_and_down, pod_kill,
                                         chaos_monkey)
                           if fn.__name__ in names], rank)


# -- the single-shot serving suite --------------------------------------------


def _mlp_apply(model, batch):
    return mlp.apply(model, batch[0])


def suite_serving(rank: int, world: int, store: str, mlp_params: dict,
                  mlp_params2: dict, batch: np.ndarray) -> dict:
    """Two ranks: an ``ElasticServer`` on the MLP holding ``mlp_params``
    (a JAX numpy tree), replicated and fsdp, serves ``batch`` on a world
    of 1 (rank 1 standing by), resizes to 2 and serves it again; the fsdp
    server then takes ``mlp_params2`` through ``load_params`` and serves,
    and its ``params_host`` (collective) gives the whole weights.  Each
    rank returns what it served (None standing by)."""
    from edl_tpu_torch.runtime.serving import ElasticServer

    _join(rank, world, store)

    def module(params):
        return interop.params_from_numpy(
            mlp.MLP([16, 32, 4], device="cpu"), params)

    def served(srv):
        out = srv.serve((batch,))
        return None if out is None else out.numpy().copy()

    def run(kind: str, spec: MeshSpec) -> dict:
        srv = ElasticServer(_mlp_apply, module(mlp_params),
                            devices=[torch.device("cpu")],
                            initial_world_size=1, param_sharding=kind,
                            spec=spec)
        srv.warmup((batch,))
        one = served(srv)
        resized = srv.resize(2)
        out = dict(world1=one, resized=resized, world=srv.world_size,
                   world2=served(srv), forwards=srv.forwards)
        if kind == "fsdp":
            srv.load_params(module(mlp_params2))
            out["reloaded"] = served(srv)
            host = srv.params_host()
            out["host"] = {n: p.detach().numpy().copy()
                           for n, p in host.named_parameters()}
        return out

    def replicated(rank):
        return run("replicated", MeshSpec(dp=-1))

    def fsdp(rank):
        return run("fsdp", FSDP)

    return _run_scenarios([replicated, fsdp], rank)


# -- the sequence-parallel suites ---------------------------------------------


def ring_context(sp_size: int, index: int, line, group=None, hop=None):
    """An sp context over the global ranks ``line`` (this rank at
    ``index``) whose hop is ``hop(tensors, dst, src, group)`` (default:
    ``ring_attention.exchange``, outside the trainer's census)."""
    from edl_tpu_torch.parallel import ring_attention as ring

    hop = hop or ring.exchange
    nxt, prv = line[(index + 1) % sp_size], line[index - 1]

    def go(tensors, reverse=False):
        dst, src = (prv, nxt) if reverse else (nxt, prv)
        return hop(tensors, dst, src, group)

    return ring.SPContext(sp_size, index, go)


def ring_grads(fn, sp, q, k, v) -> tuple:
    """(out, dq, dk, dv) as numpy of ``fn(q, k, v, sp=sp)`` on this rank's
    numpy chunks, the loss the sum of the global output's squares (each
    rank its chunk's share)."""
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(x))
                  .requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt, causal=True, sp=sp)
    (out ** 2).sum().backward()
    return tuple(t.detach().numpy().copy()
                 for t in (out, qt.grad, kt.grad, vt.grad))


def suite_ring_four(rank: int, world: int, store: str, cases: dict) -> dict:
    """The ring on four ranks: each rank holds its contiguous quarter of the
    sequence of ``cases``' global q/k/v and returns its chunk of the output
    and of the gradients of Σ out² — the plain ring causal and full, the
    flash ring's CPU form (the plain flash versions per chunk) at GQA 1:1
    and 2:1, a chunk the flash ring does not take, the hop census through
    the trainer's choke point, and GQA on a tp-2 × sp-2 layout (this rank's
    heads of its tp block and its chunk of its sp line)."""
    from edl_tpu_torch.parallel import mesh as pmesh
    from edl_tpu_torch.parallel import ring_attention as ring

    _join(rank, world, store)
    line = list(range(world))
    sp4 = ring_context(world, rank, line)

    def chunk(x, i=rank, n=world):
        sc = x.shape[1] // n
        return x[:, i * sc:(i + 1) * sc]

    def plain(rank):
        got = {}
        for causal in (True, False):
            q, k, v = (chunk(x) for x in cases["plain"])
            qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(x))
                          .requires_grad_() for x in (q, k, v))
            out = ring.ring_attention_sharded(qt, kt, vt, causal=causal,
                                              sp=sp4)
            (out ** 2).sum().backward()
            got[causal] = tuple(t.detach().numpy().copy() for t in
                                (out, qt.grad, kt.grad, vt.grad))
        return got

    def flash(rank):
        return {hk: ring_grads(ring.ring_flash_attention_sharded, sp4,
                               *(chunk(x) for x in qkv))
                for hk, qkv in cases["flash"].items()}

    def unaligned(rank):
        q, k, v = (chunk(x) for x in cases["unaligned"])
        return dict(eligible=ring.flash_eligible(q.shape[1]),
                    got=ring_grads(ring.ring_flash_attention_sharded, sp4,
                                   q, k, v))

    def census(rank):
        got = {}
        counted = ring_context(world, rank, line, hop=lambda ts, dst, src,
                               group: elastic._ring_hop(ts, dst, src, group,
                                                        "sp"))
        for label, fn, qkv in (
                ("flash", ring.ring_flash_attention_sharded,
                 cases["flash"][2]),
                ("plain", ring.ring_attention_sharded, cases["plain"])):
            q, k, v = (torch.from_numpy(np.ascontiguousarray(chunk(x)))
                       .requires_grad_() for x in qkv)
            elastic.reset_census()
            out = fn(q, k, v, causal=True, sp=counted)
            fwd = elastic.collective_census()
            (out ** 2).sum().backward()
            got[label] = dict(fwd=fwd, step=elastic.collective_census())
        return got

    def gqa_tp_sp(rank):
        shape = MeshShape(tp=2, sp=2)
        group = pmesh.axis_groups(shape)["sp"]
        sp_line = pmesh.axis_ranks(shape, "sp", rank)
        t = pmesh.axis_ranks(shape, "tp", rank).index(rank)
        s = sp_line.index(rank)
        sp2 = ring_context(2, s, sp_line, group)
        q, k, v = cases["gqa"]
        h, hk = q.shape[2] // 2, k.shape[2] // 2
        q = chunk(q, s, 2)[:, :, t * h:(t + 1) * h]
        k = chunk(k, s, 2)[:, :, t * hk:(t + 1) * hk]
        v = chunk(v, s, 2)[:, :, t * hk:(t + 1) * hk]
        return dict(tp=t, sp=s, got=ring_grads(
            ring.ring_flash_attention_sharded, sp2, q, k, v))

    return _run_scenarios([plain, flash, unaligned, census, gqa_tp_sp],
                          rank)


def sp_tiny(params: dict, spec: MeshSpec, n0: int, remat: bool = False,
            **kw) -> ElasticTrainer:
    """The TINY trainer (``remat`` as asked) holding the JAX params, under
    adamw(1e-3) on ``spec``'s world of ``n0``."""
    cfg = dataclasses.replace(tfm.TINY, remat=remat)
    model = interop.params_from_numpy(tfm.Transformer(cfg, device="cpu"),
                                      params)
    return ElasticTrainer(tfm.loss_fn, model, optim.adamw(1e-3),
                          devices=[torch.device("cpu")], spec=spec,
                          initial_world_size=n0, **kw)


def sp_logits(trainer: ElasticTrainer, tokens) -> np.ndarray:
    """This rank's block of TINY's logits of ``tokens`` on the trainer's
    live layout: its chunk of the sequence and, split over tp, its
    vocabulary columns (the trainer's gather, tp and sp contexts)."""
    with torch.no_grad(), trainer._gathered(), trainer._tp(), \
            trainer._sp():
        out = tfm.apply(trainer.state.params, torch.as_tensor(tokens))
    return out.numpy().copy()


def sp_steps(trainer: ElasticTrainer, batches: list) -> dict:
    """The eval loss at init, a step per batch (the first's census), and
    the whole params after them."""
    got = dict(eval=trainer.eval_loss(batches[0]))
    elastic.reset_census()
    got["losses"] = [trainer.step(batches[0])]
    got["census"] = elastic.collective_census()
    got["losses"] += [trainer.step(b) for b in batches[1:]]
    got["full"] = full_numpy(trainer)
    return got


SP = MeshSpec(sp=-1)


def suite_sp_two(rank: int, world: int, store: str, tiny_params: dict,
                 batches: list, micro: list, tokens: np.ndarray,
                 data: tuple, flagship_kw: dict) -> dict:
    """sp 2 on two ranks: the entry point behind chip_smoke's phase (w) at
    TINY (the plain ring: TINY is fp32 on the CPU), then TINY's logits,
    steps with remat off and on, accumulation, the MLP (no sp path), live
    resizes 1 → sp 2 → 1 and a whole state restored into sp 2."""
    from edl_tpu_torch.entry import flagship_sp_world

    out = {}
    try:
        trainer, batch = flagship_sp_world(rank, world, store, device="cpu",
                                           **flagship_kw)
        seen = dict(world=trainer.world_size, losses=[], resized=[],
                    kept=[], sent=[], census=[], params=[])
        for target in (2, 2, 1, 2):
            if target != trainer.world_size:
                before = full_numpy(trainer)
                elastic.reset_census()
                seen["resized"].append(trainer.resize(target))
                seen["sent"].append(sum(
                    slot["bytes"] for label, slot in
                    elastic.collective_census().items() if label != "world"))
                seen["kept"].append(all(
                    np.array_equal(before[k], v)
                    for k, v in full_numpy(trainer).items()))
            elastic.reset_census()
            seen["losses"].append(trainer.step(batch))
            seen["census"].append(elastic.collective_census())
            seen["params"].append(digest(trainer))
        seen["events"] = trainer.resize_events
        out["flagship_world"] = seen
    except Exception:
        out["flagship_world"] = ScenarioFailed(traceback.format_exc())
        return out

    def forward(rank):
        return sp_logits(sp_tiny(tiny_params, SP, 2), tokens)

    def steps(rank):
        return {remat: sp_steps(sp_tiny(tiny_params, SP, 2, remat=remat),
                                batches) for remat in (False, True)}

    def accumulate(rank):
        got = {}
        for mode in ("dp", "replicated"):
            t = sp_tiny(tiny_params, SP, 2, accum_mode=mode)
            got[mode] = dict(losses=[t.step_accumulate(micro)
                                     for _ in range(2)],
                             full=full_numpy(t))
        return got

    def mlp_sp(rank):
        x, y = data
        got = {}
        for n0 in (1, 2):
            t = mlp_trainer(n0, spec=SP)
            losses = [t.step(_slices(x, y, i)) for i in range(4)]
            got[n0] = dict(losses=losses, digest=digest(t), live=t.live)
        return got

    def resize(rank):
        t = sp_tiny(tiny_params, SP, 1)
        got = dict(losses=[t.step(batches[0])], kept=[], shapes=[],
                   sent=[])
        for b, target in zip(batches[1:], (MeshShape(sp=2), 1)):
            before = full_numpy(t)
            elastic.reset_census()
            ok = t.resize(target)
            got["sent"].append(sum(
                slot["bytes"] for label, slot in
                elastic.collective_census().items() if label != "world"))
            got["kept"].append(ok and all(
                np.array_equal(before[k], v)
                for k, v in full_numpy(t).items()))
            got["shapes"].append(t.shape)
            got["losses"].append(t.step(b))
        got["events"] = t.resize_events
        return got

    def restore(rank):
        from edl_tpu_torch.runtime import checkpoint as ckpt

        src = sp_tiny(tiny_params, SP, 1)
        for b in batches[:2]:
            src.step(b)
        flat = [ckpt._flatten(src.whole_state()) if rank == 0 else None]
        dist.broadcast_object_list(flat, src=0)
        dst = sp_tiny(tiny_params, SP, 2)
        dst.load_whole_state(flat[0])
        same = all(np.array_equal(full_numpy(src)[k], v)
                   for k, v in full_numpy(dst).items()) if rank == 0 \
            else None
        got = dict(same=same, sp_loss=dst.step(batches[2]),
                   sp_full=full_numpy(dst))
        got["one_loss"] = src.step(batches[2])
        got["one_full"] = full_numpy(src) if rank == 0 else None
        return got

    def prewarm(rank):
        t = sp_tiny(tiny_params, SP, 1)
        t.step(batches[0])
        t.prewarm([MeshShape(sp=2)], wait=True)
        ok = t.resize(MeshShape(sp=2))
        return dict(ok=ok, hit=t.resize_events[-1]["prewarm_hit"],
                    loss=t.step(batches[1]))

    out.update(_run_scenarios([forward, steps, accumulate, mlp_sp, resize,
                               restore, prewarm], rank))
    return out


def suite_sp_four(rank: int, world: int, store: str, tiny_params: dict,
                  batches: list, tokens: np.ndarray, mlp_params: dict,
                  rows: np.ndarray) -> dict:
    """sp on four ranks: TINY laid out by its partition specs over tp 2 ×
    sp 2 (its logits and steps), the fsdp kind on fsdp 2 × sp 2 (the fsdp
    blocks' gradients summed over the sp line), replicated on dp 2 × sp 2
    (the batch split over dp, each half's sequence over sp), and an
    ``ElasticServer`` on dp 2 × sp 2 (its rows gathered over the data
    axes)."""
    from edl_tpu_torch.runtime.serving import ElasticServer

    _join(rank, world, store)
    specs = tfm.param_partition_specs(tfm.TINY)
    tp_sp = MeshSpec(tp=2, sp=2)

    def forward_tp_sp(rank):
        return sp_logits(sp_tiny(tiny_params, tp_sp, 4,
                                 param_sharding=specs), tokens)

    def steps_tp_sp(rank):
        return sp_steps(sp_tiny(tiny_params, tp_sp, 4, remat=True,
                                param_sharding=specs), batches)

    def fsdp_sp(rank):
        return sp_steps(sp_tiny(tiny_params, MeshSpec(fsdp=2, sp=2), 4,
                                param_sharding="fsdp"), batches)

    def dp_sp(rank):
        return sp_steps(sp_tiny(tiny_params, MeshSpec(dp=2, sp=2), 4),
                        batches)

    def serve_dp_sp(rank):
        model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                          mlp_params)
        srv = ElasticServer(_mlp_apply, model, devices=[torch.device("cpu")],
                            spec=MeshSpec(dp=2, sp=2))
        return srv.serve((rows,)).numpy().copy()

    return _run_scenarios([forward_tp_sp, steps_tp_sp, fsdp_sp, dp_sp,
                           serve_dp_sp], rank)


# -- train+serve arbitration: chip_smoke's phase (x) at TINY ------------------


def suite_arbitrated(rank: int, world: int, store: str, rows: int,
                     shards: int, seq: int, schedule: dict,
                     world2_sleep_s: float) -> dict:
    """chip_smoke's phase (x) on two CPU ranks at TINY:
    ``entry.flagship_arbitrated_job`` and, on rank 0, the scoring fleet of
    TINY beside it, driven by ``entry.arbitrated_campaign``.  On the card
    a world-2 step over gloo costs ~10x a world-1 step (the all-reduce
    staged through host memory); two CPU ranks of TINY need not, so every
    world-2 step here sleeps ``world2_sleep_s`` after it, which makes the
    trainer's measured marginal at 2 negative as it is on the card."""
    from edl_tpu_torch.entry import (ARBITRATION_BATCH,
                                     ARBITRATION_FLEET_JOB,
                                     ARBITRATION_QUEUE_MS,
                                     ARBITRATION_SLO_MS,
                                     arbitrated_campaign,
                                     flagship_arbitrated_job,
                                     flagship_scoring_fleet,
                                     score_last_token)

    _join(rank, world, store)

    def arbitrated(rank):
        runner, plane, _ = flagship_arbitrated_job(
            rank, world, store, device="cpu", cfg=tfm.TINY, global_batch=4,
            seq=seq, rows=rows, shards=shards,
            work_dir=Path(store).parent / "arbitrated")
        order: list = []
        fleet = tokens = None
        if plane is not None:
            fetch = runner.fetch

            def counted(payload):
                order.append(json.loads(payload.decode())["shard"])
                return fetch(payload)

            runner.fetch = counted
            fleet = flagship_scoring_fleet(
                device="cpu", cfg=tfm.TINY, seq=seq,
                job=f"default/{ARBITRATION_FLEET_JOB}",
                max_batch_size=ARBITRATION_BATCH,
                max_queue_ms=ARBITRATION_QUEUE_MS,
                slo_p99_ms=ARBITRATION_SLO_MS, kv=plane.coord)
            fleet.scale_to(1)
            fleet.serve_metrics(port=0, replica="r0")
            tokens = np.random.default_rng(3).integers(
                0, tfm.TINY.vocab_size, (64, seq), dtype=np.int64)
        step = runner.trainer.step

        def card_like(batch):
            loss = step(batch)
            if runner.trainer.world_size == 2:
                time.sleep(world2_sleep_s)
            return loss

        runner.trainer.step = card_like
        got = arbitrated_campaign(runner, plane, fleet, tokens, **schedule)
        rep = got.pop("report")
        out = dict(losses=rep.losses, worlds=rep.world_sizes,
                   steps=got.pop("steps"))
        if plane is None:
            return out
        sampled = got.pop("sampled", None)
        fleet.stop()
        stats = plane.coord.stats()
        plane.close()
        out.update(got, order=order, leaked=plane.leaked_servers(),
                   stats=dict(done=stats.done, todo=stats.todo,
                              leased=stats.leased, dropped=stats.dropped))
        if sampled is not None:
            model = tfm.Transformer(tfm.TINY, device="cpu", seed=0)
            with torch.no_grad():
                ref = score_last_token(model, (torch.from_numpy(
                    sampled["tokens"]),)).numpy()
            out["answers"] = (sampled["answers"], ref)
        return out

    return _run_scenarios([arbitrated], rank)

def suite_plan_two(rank: int, world: int, store: str,
                   tiny_params: dict) -> dict:
    """TINY laid out by its partition specs on a world of 2, fsdp 2 and tp
    2 in turn: the bytes each rank holds of every parameter and of Adam's
    moments, against models/planning.py's plan."""
    _join(rank, world, store)

    def held(t: ElasticTrainer) -> dict:
        opt = t.state.opt_state.state
        return dict(
            params={n: s.numel() * s.element_size()
                    for n, s in t.shards.items()},
            moments=sum(v.numel() * v.element_size()
                        for s in t.shards.values() for v in opt[s].values()
                        if v.dim()))

    def fsdp_2(rank):
        t = tiny_trainer(tiny_params, param_sharding=tfm.param_partition_specs(
            tfm.TINY), spec=FSDP, initial_world_size=2)
        t.step(tiny_batch())  # Adam's moments exist after a step
        return held(t)

    def tp_2(rank):
        t = tp_tiny(tiny_params, TP, 2)
        t.step(tiny_batch())
        return held(t)

    return _run_scenarios([fsdp_2, tp_2], rank)


def tiny_batch() -> tuple:
    toks = np.random.default_rng(0).integers(0, tfm.TINY.vocab_size,
                                             (4, 16), dtype=np.int64)
    return (torch.from_numpy(toks), torch.from_numpy(np.roll(toks, -1, 1)))


SUITES = {"plan_two": suite_plan_two, "two": suite_two, "four": suite_four, "virtual": suite_virtual,
          "fsdp_four": suite_fsdp_four, "fsdp_two": suite_fsdp_two,
          "tp_two": suite_tp_two, "tp_eight": suite_tp_eight,
          "sharded": suite_sharded, "lineage": suite_lineage,
          "prewarm": suite_prewarm, "sdc": suite_sdc,
          "bert_tp_two": suite_bert_tp_two,
          "bert_tp_eight": suite_bert_tp_eight, "local": suite_local,
          "local_four": suite_local_four, "controlled": suite_controlled,
          "controlled_four": suite_controlled_four,
          "serving": suite_serving, "ring_four": suite_ring_four,
          "sp_two": suite_sp_two, "sp_four": suite_sp_four,
          "arbitrated": suite_arbitrated}
