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
import torch.nn as nn
import torch.nn.functional as F

from edl_tpu_torch import interop
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


class MLP(nn.Module):
    """A two-layer classifier [16, 32, 4] from a seed."""

    def __init__(self, sizes=(16, 32, 4), seed: int = 0) -> None:
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w1 = nn.Parameter(torch.randn(sizes[0], sizes[1], generator=g)
                               / sizes[0] ** 0.5)
        self.b1 = nn.Parameter(torch.zeros(sizes[1]))
        self.w2 = nn.Parameter(torch.randn(sizes[1], sizes[2], generator=g)
                               / sizes[1] ** 0.5)
        self.b2 = nn.Parameter(torch.zeros(sizes[2]))


def mlp_loss(model: MLP, batch) -> torch.Tensor:
    x, y = batch
    h = torch.relu(x @ model.w1 + model.b1)
    return F.cross_entropy(h @ model.w2 + model.b2, y)


def mlp_trainer(n0: int, **kw) -> ElasticTrainer:
    return ElasticTrainer(mlp_loss, MLP(), optim.adam(1e-2),
                          devices=[torch.device("cpu")],
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
        direct = float(mlp_loss(t.state.params, (torch.as_tensor(batch[0]),
                                                 torch.as_tensor(batch[1]))))
        got = dict(ev=ev, direct=direct, untouched=digest(t) == before,
                   step=t.state.step)
        for i in range(30):
            t.step((x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16]))
        got["trained"] = t.eval_loss(batch)
        t.resize(4)
        got["ev4"] = t.eval_loss(batch)
        got["direct4"] = float(mlp_loss(
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


SUITES = {"two": suite_two, "four": suite_four}
