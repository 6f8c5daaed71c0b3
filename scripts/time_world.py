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
from edl_tpu_torch.ops import _build

B, S = 16, 1024
CHILD_TIMEOUT_S = 600


def fingerprint(trainer) -> list[int]:
    """The params' words as int32, summed and position-weighted, per
    parameter (mod 2^64): equal across ranks iff bitwise equal, but for a
    collision."""
    out = []
    for p in trainer.state.params.parameters():
        w = p.detach().contiguous().view(torch.int32).reshape(-1).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out += [int(w.sum()), int((w * pos).sum())]
    return out


def rank_main(rank: int, ranks: int, store: str, out: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_elastic_world(rank, ranks, store, batch=B,
                                            seq=S, initial_world_size=1)
    rec = dict(rank=rank, steps=[], resized=[])
    for world, steps in ((1, 3), (ranks, 6), (1, 2)):
        if trainer.world_size != world:
            rec["resized"].append(trainer.resize(world))
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.step(batch)
            torch.cuda.synchronize()
            rec["steps"].append(dict(
                world=trainer.world_size, loss=loss,
                ms=1e3 * (time.perf_counter() - t0),
                params=fingerprint(trainer) if trainer.live
                and trainer.world_size > 1 else None))
    rec["events"] = trainer.resize_events
    rec["backend"] = torch.distributed.get_backend()
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
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
            r, args.ranks, os.path.join(tmp, "store"), outs[r]))
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
        live = [s for s in steps if s["loss"] is not None]
        if len(live) != steps[0]["world"] or not np.isfinite(live[0]["loss"]):
            failures.append(f"step {i}: live ranks {len(live)}")
        if len({s["loss"] for s in live}) != 1 or (
                steps[0]["params"] is not None
                and any(s["params"] != steps[0]["params"] for s in live)):
            failures.append(f"step {i}: the live ranks differ")
    if not all(all(rec["resized"]) for rec in recs):
        failures.append("a resize failed")
    by_world = {}
    for s in recs[0]["steps"]:
        by_world.setdefault(s["world"], []).append(round(s["ms"], 2))
    print(json.dumps(dict(
        ranks=args.ranks, backend=recs[0]["backend"], card=card,
        cards=torch.cuda.device_count(), step_ms_rank0=by_world,
        median_step_ms={w: float(np.median(ms[1:]))
                        for w, ms in by_world.items()},
        resize_events_rank0=recs[0]["events"], failures=failures)))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
