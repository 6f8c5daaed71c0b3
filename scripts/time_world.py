"""FLAGSHIP trained through ``entry.flagship_elastic_world`` on N ranks: one
card a rank (NCCL) while there are cards enough, else ranks sharing cards
(gloo).  Each rank runs a 1 → N → 1 schedule (3 steps on a world of 1,
``resize(N)``, 6 steps on N, ``resize(1)``, 2 steps on 1) on the global
batch 16 x 1024, and checks what holds on any number of ranks: every loss
finite, the same loss on every live rank, and the params bitwise equal
across the live ranks after each step of the wide world.  Prints one JSON
line a rank (its step times, losses and resize events) and a summary line
with the card's name and power limit:

    PYTHONPATH=. python scripts/time_world.py --ranks 4

With ``--tp T`` the wide world is dp×tp (``MeshSpec(dp=-1, tp=T)``) and
the parameters are laid out by FLAGSHIP's partition specs: each rank holds
its tp block of every matrix, the ranks of one tp index hold the same
blocks, and every rank the same norms, which is what is checked then.

With ``--prewarm`` each rank calls ``prewarm([N])`` and
``prewarm_quiesce()`` after its world-1 steps, before ``resize(N)``: the
wide layout's process groups are built and their first collective (where
NCCL creates each communicator) taken before the resize, which then pays
only the move.  Run the script with and without it in one call to read the
share of ``resize(N)`` that is group and communicator set-up; each rank's
record carries the host ms of each resize and of the prewarm.

``chip_smoke.py`` phase (j) runs the same trainer on two ranks sharing one
card, with the kernel launch counts and a one-rank control.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from edl_tpu_torch.entry import flagship_elastic_world
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.ops import _build
from edl_tpu_torch.parallel.mesh import MeshShape, MeshSpec

B, S = 16, 1024
CHILD_TIMEOUT_S = 600


def fingerprint(tensors) -> list[int]:
    """The words as int32 of each tensor, summed and position-weighted
    (mod 2^64): equal across ranks iff bitwise equal, but for a
    collision."""
    out = []
    for p in tensors:
        w = p.detach().contiguous().view(torch.int32).reshape(-1).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out += [int(w.sum()), int((w * pos).sum())]
    return out


def rank_main(rank: int, ranks: int, store: str, out: str,
              tp: int = 1, prewarm: bool = False) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    one, kw = 1, {}
    if tp > 1:
        # a world of one is no dp×tp split of the spec: its shape is named
        one = MeshShape()
        kw = dict(spec=MeshSpec(dp=-1, tp=tp),
                  param_sharding=tfm.param_partition_specs(tfm.FLAGSHIP))
    trainer, batch = flagship_elastic_world(rank, ranks, store, batch=B,
                                            seq=S, initial_world_size=one,
                                            **kw)
    norms = [n for n, spec in trainer.partition_specs().items()
             if not any(spec)]
    rec = dict(rank=rank, tp_index=rank % tp, steps=[], resized=[],
               resize_ms=[], prewarm_ms=None)
    for world, steps in ((one, 3), (ranks, 6), (one, 2)):
        if prewarm and world == ranks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.prewarm([world])
            rec["quiet"] = trainer.prewarm_quiesce(CHILD_TIMEOUT_S)
            torch.cuda.synchronize()
            rec["prewarm_ms"] = 1e3 * (time.perf_counter() - t0)
        if not trainer.matches(world):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec["resized"].append(trainer.resize(world))
            torch.cuda.synchronize()
            rec["resize_ms"].append(1e3 * (time.perf_counter() - t0))
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.step(batch)
            torch.cuda.synchronize()
            wide = trainer.live and trainer.world_size > 1
            rec["steps"].append(dict(
                world=trainer.world_size, loss=loss,
                ms=1e3 * (time.perf_counter() - t0),
                params=(fingerprint(trainer.shards.values()) if wide
                        else None),
                norms=(fingerprint(trainer.shards[n] for n in norms)
                       if wide else None)))
    rec["events"] = trainer.resize_events
    rec["backend"] = torch.distributed.get_backend()
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--prewarm", action="store_true",
                    help="prewarm the wide layout before resizing to it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_world: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _build.build()  # once, before the ranks load the kernels
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(args.ranks)]
        procs = [ctx.Process(target=rank_main, args=(
            r, args.ranks, os.path.join(tmp, "store"), outs[r], args.tp,
            args.prewarm))
            for r in range(args.ranks)]
        try:
            for p in procs:
                p.start()
            end = time.monotonic() + CHILD_TIMEOUT_S
            for p in procs:
                p.join(max(end - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        if any(p.exitcode != 0 or not os.path.exists(o)
               for p, o in zip(procs, outs)):
            print(f"time_world: ranks exited {[p.exitcode for p in procs]}",
                  file=sys.stderr)
            return 1
        recs = []
        for out in outs:
            with open(out) as f:
                recs.append(json.load(f))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    failures = []
    for i, steps in enumerate(zip(*(rec["steps"] for rec in recs))):
        live = [(rec["tp_index"], s) for rec, s in zip(recs, steps)
                if s["loss"] is not None]
        if (len(live) != steps[0]["world"]
                or not np.isfinite(live[0][1]["loss"])):
            failures.append(f"step {i}: live ranks {len(live)}")
        blocks: dict[int, set] = {}
        for t, s in live:
            blocks.setdefault(t, set()).add(str(s["params"]))
        if (len({s["loss"] for _, s in live}) != 1
                or any(len(b) != 1 for b in blocks.values())
                or len({str(s["norms"]) for _, s in live}) != 1):
            failures.append(f"step {i}: the live ranks differ")
    if not all(all(rec["resized"]) for rec in recs):
        failures.append("a resize failed")
    if args.prewarm and not all(
            rec["quiet"] and rec["events"][0]["prewarm_hit"] for rec in recs):
        failures.append("the prewarmed resize was no prewarm hit")
    by_world = {}
    for s in recs[0]["steps"]:
        by_world.setdefault(s["world"], []).append(round(s["ms"], 2))
    print(json.dumps(dict(
        ranks=args.ranks, tp=args.tp, prewarm=args.prewarm,
        backend=recs[0]["backend"], card=card,
        resize_ms_by_rank=[rec["resize_ms"] for rec in recs],
        prewarm_ms_by_rank=[rec["prewarm_ms"] for rec in recs],
        cards=torch.cuda.device_count(), step_ms_rank0=by_world,
        median_step_ms={w: float(np.median(ms[1:]))
                        for w, ms in by_world.items()},
        resize_events_rank0=recs[0]["events"], failures=failures)))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
