"""Host and device time of one paged decode step of the ``edl_tpu_torch``
package on ``sys.path``, at ``chip_smoke.py`` phase (i)'s shapes: 8 slots
with 512 cached tokens a slot, pool and weights as phase (i) builds them
(seed 0), at FLAGSHIP (8 query and 2 kv heads) and at LLAMA3_8B's width
cut to 2 layers (32 and 8).  The device ms is the median of 5 timings of
one step queued behind a sleep (CUDA events); the launch ms the median of
5 host times to queue one step behind a sleep (the host's own cost, the
card never waited for); the host ms the median of 5 windows of 20 steps,
each with its argmax read, back to back, as the decode loop paces
itself.  Where the
tree's pool spans several devices, the same step over a pool split by heads on
[card, card] is held to the one-device step's logits (``split_equal``).
One JSON line a configuration; one call on the card times two trees alike
(in turns: parent, change, change, parent):

    PYTHONPATH=<tree> python scripts/time_decode_step.py --label parent

``--attention batched`` swaps the grouped attention for one product over
every kv group (a batch of rows x kv heads) before timing, to weigh that
form against the one the tree has.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from edl_tpu_torch.models import llama
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime.kvcache import KVBlockPool

SLOTS, CACHED, BLOCK, MAX_BLOCKS = 8, 512, 16, 64
REPS, SLEEP_CYCLES = 5, 200_000_000
HOST_REPS = 20


def launch_ms(fn) -> float:
    """Host time to queue one call of ``fn`` behind a device sleep long
    enough that the card runs none of it before the call returns."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    fn()
    took = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return took


def cuda_ms(fn) -> float:
    """Device time of one call of ``fn`` queued behind a device sleep,
    after one warm-up call (CUDA events), as ``chip_smoke.py`` times."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def batched_group_attention(q, ctx_k, ctx_v, mask, cfg, with_lse=False):
    """The grouped attention as one product a step over rows x kv heads:
    q ``[rows, h, hd]``, ctx_k/ctx_v ``[rows, T, kv, hd]``, mask ``[rows, 1,
    T]`` → (output ``[rows, h, hd]``, lse ``[rows, h]``)."""
    rows, h, hd = q.shape
    kv = ctx_k.shape[2]
    qg = q.float().reshape(rows, kv, h // kv, hd)
    scores = torch.matmul(qg, ctx_k.float().permute(0, 2, 3, 1))
    scores = torch.where(mask[:, None], scores / (cfg.head_dim ** 0.5),
                         -1e30)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.matmul(torch.exp(scores - lse[..., None]),
                       ctx_v.float().permute(0, 2, 1, 3))
    return out.reshape(rows, h, hd), lse.reshape(rows, h)


def time_config(name: str, cfg, dev: torch.device) -> dict:
    model = tfm.Transformer(cfg, device=dev, seed=0)
    params = llama.as_decode_params(model)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, SLOTS)
    pos, live = np.full(SLOTS, CACHED), np.ones(SLOTS, bool)
    splits = [None]
    try:  # a tree whose pool spans one device alone skips the split
        KVBlockPool(cfg, 2, BLOCK, 1, device=dev, devices=[dev, dev])
        splits.append([dev, dev])
    except (NotImplementedError, TypeError):
        pass
    gen = torch.Generator(device=dev).manual_seed(5)
    content = {name: torch.randn(
        (cfg.n_layers, SLOTS * MAX_BLOCKS, BLOCK, cfg.n_kv_heads,
         cfg.head_dim), generator=gen, device=dev).to(cfg.dtype)
        for name in ("k", "v")}
    out, logits = {"config": name}, {}
    for devices in splits:
        kw = {} if devices is None else {"devices": devices}
        pool = KVBlockPool(cfg, SLOTS * MAX_BLOCKS, BLOCK, MAX_BLOCKS,
                           job=f"time/{name}", device=dev, **kw)
        if hasattr(llama, "write_blocks"):  # seeded K/V, where it can
            llama.write_blocks(pool.cache, range(SLOTS * MAX_BLOCKS),
                               content)
        for i in range(SLOTS):
            pool.ensure_capacity(i, CACHED + 1)
        tables = np.stack([pool.block_table(i) for i in range(SLOTS)])

        def step():
            return llama.decode_step(params, pool.cache, toks, pos, tables,
                                     live)

        logits[devices is None] = step()[0]
        if devices is not None:
            continue
        out["device_ms"] = float(np.median(
            [cuda_ms(step) for _ in range(REPS)]))
        out["launch_ms"] = float(np.median(
            [launch_ms(step) for _ in range(REPS)]))
        windows = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                step()[0].argmax(dim=-1).tolist()
            windows.append(1e3 * (time.perf_counter() - t0) / HOST_REPS)
        out["host_ms"] = float(np.median(windows))
    if len(splits) > 1:
        out["split_equal"] = bool(torch.equal(logits[True], logits[False]))
    del model, params, pool, content
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--attention", choices=("tree", "batched"),
                    default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_decode_step: no CUDA device", file=sys.stderr)
        return 1
    if args.attention == "batched":
        llama._group_attention = batched_group_attention
    dev = torch.device("cuda")
    for name, cfg in (("flagship", tfm.FLAGSHIP),
                      ("llama3_8b_2_layers", dataclasses.replace(
                          tfm.LLAMA3_8B, n_layers=2, max_seq_len=1024))):
        row = time_config(name, cfg, dev)
        row.update(label=args.label, attention=args.attention)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
