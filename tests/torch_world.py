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
from edl_tpu_torch.parallel.mesh import MeshShape
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


def tiny_trainer(params: dict, **kw) -> ElasticTrainer:
    """The port's TINY transformer holding the JAX params ``params`` (a
    numpy tree), under adamw(1e-3) on the CPU."""
    model = interop.params_from_numpy(tfm.Transformer(tfm.TINY, device="cpu"),
                                      params)
    return ElasticTrainer(tfm.loss_fn, model, optim.adamw(1e-3),
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

        def failing_after_bcast(t_, src, group):
            real_bcast(t_, src, group)
            if group is not None:  # the state transfer, not the layout
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
        got["staged"] = [t.resize(v) for v in (8, MeshShape(dp=2, fsdp=2))]
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


SUITES = {"two": suite_two, "four": suite_four, "virtual": suite_virtual}
