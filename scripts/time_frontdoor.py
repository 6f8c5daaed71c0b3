"""One FLAGSHIP data-plane replica's door alone, on the card: latency at
fixed open-loop rates and the closed-loop capacity, for one or more trees
of the port in one call.

Each ``--tree`` in turn serves as the replica: ``python -m
edl_tpu_torch.entry frontdoor-replica`` is spawned from that tree (its
kernels built there first), FLAGSHIP at 8 layers with batches of 8, seed-0
weights, no coordinator.  The clients are this checkout's
``chip_smoke.py`` load clients: two keep-alive connections pipelining raw
f32 rows of 1 024 token ids, every answer held by (d)'s rule to the plain
path's logits (a wrong answer fails the run).  Per tree it prints the
closed-loop capacity (depth 8 a connection), then p50/p99/max at each
``--rates`` rate (Poisson, ``--seconds`` a rate), the rows a serve
iteration packed, and the flash forward launches a forward.  Give the
trees as A B B A to compare two versions on one card:

    PYTHONPATH=. python scripts/time_frontdoor.py --tree old --tree . \\
        --tree . --tree old

A tree is a directory holding ``edl_tpu_torch/`` (``git archive`` of a
commit, unpacked in a git-ignored directory of the checkout).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime.frontdoor import build_predict_request

JOB = "default/time-frontdoor"
ROWS = 64


def replica(tree: str, log: str):
    """Spawn the tree's replica process (its own kernels' build first)."""
    env = dict(os.environ, PYTHONPATH=tree)
    subprocess.run([sys.executable, "-c", "from edl_tpu_torch.ops import "
                    "_build; _build.build()"], cwd=tree, env=env, check=True,
                   timeout=600)
    with open(log, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.entry",
             "frontdoor-replica", "--replica", "r0", "--job", JOB,
             "--device", "cuda", "--config", "flagship"],
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=tree)


def measure(tree: str, reqs: list, check, rates: list, seconds: float,
            tmp: str, k: int) -> dict:
    log = os.path.join(tmp, f"r{k}.log")
    t0 = time.perf_counter()
    proc = replica(os.path.abspath(tree), log)
    clients = []
    try:
        (line, _), = cs.fd_wait_ready({"r0": log}, {"r0": proc}, t0,
                                      time.monotonic() + 300).values()
        port = int(cs.log_field(line, "port"))
        clients = [cs.LoadClient(port, reqs, check, seed=60 + i)
                   for i in range(2)]
        windows = [cs.run_window(clients, "capacity", job=JOB,
                                 depth=cs.FD_DEPTH, seconds=seconds)]
        for rate in rates:
            windows.append(cs.run_window(clients, f"{rate:g} rows/s",
                                         job=JOB, rate=rate,
                                         seconds=seconds))
        for c in clients:
            c.close()
        clients = []
        proc.terminate()
        if proc.wait(60) != 0:
            raise AssertionError(f"{tree}: replica exit {proc.returncode}")
    finally:
        for c in clients:
            c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    with open(log) as f:
        last = [ln for ln in f if ln.startswith("frontdoor launches ")][-1]
    counts = json.loads(last[len("frontdoor launches "):])
    bad = [w for w in windows if w["wrong"] or w["errors"] or not w["ok"]]
    if bad:
        raise AssertionError(f"{tree}: {bad}")
    return dict(tree=tree, windows=windows, counts=counts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="a tree of the port to serve from (repeatable)")
    ap.add_argument("--rates", default="60,120",
                    help="open-loop rows/s, comma-separated")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_frontdoor: no CUDA device", file=sys.stderr)
        return 1
    rates = [float(r) for r in args.rates.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = tfm.FLAGSHIP
    rows = np.random.default_rng(31).integers(
        0, cfg.vocab_size, (ROWS, cs.S), dtype=np.int64)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tfm.Transformer(cfg, device="cuda", seed=0)
    model.cfg = dataclasses.replace(model.cfg, use_flash=False)
    with torch.no_grad():
        ref = torch.cat([
            cs.score_last_token(model, (torch.from_numpy(
                rows[i:i + cs.FD_BATCH]).cuda(),)).float().cpu()
            for i in range(0, ROWS, cs.FD_BATCH)]).numpy()
    del model
    torch.cuda.empty_cache()
    check = cs.AnswerCheck({1: ref})
    reqs = [build_predict_request(r.astype(np.float32)) for r in rows]
    tmp = tempfile.mkdtemp(prefix="time-frontdoor-")
    for k, tree in enumerate(args.tree):
        out = measure(tree, reqs, check, rates, args.seconds, tmp, k)
        c = out["counts"]
        per_fwd = c["launches"]["flash_fwd"] / max(c["forwards"], 1)
        per_it = c["requests_served"] / max(c["iterations"], 1)
        for w in out["windows"]:
            print(f"time_frontdoor run {k} tree {tree} {w['label']}: "
                  f"{w['sent']} sent in {w['seconds']:.2f} s, "
                  f"{w['rows_per_s']:.1f} rows/s served, p50_ms "
                  f"{w['p50_ms']} p99_ms {w['p99_ms']} max_ms "
                  f"{w['max_ms']}", flush=True)
        print(f"time_frontdoor run {k} tree {tree}: "
              f"{c['requests_served']} rows in {c['iterations']} serve "
              f"iterations ({per_it:.2f} a iteration), {c['forwards']} "
              f"forwards, "
              f"{per_fwd:g} flash forward launches a forward, backward "
              f"{c['launches']['flash_bwd_dq']} + "
              f"{c['launches']['flash_bwd_dkv']}; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
