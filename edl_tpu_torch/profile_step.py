"""Where the time of a train step, or of a decode iteration, goes on the
card.

Drives one of the paths of ``chip_smoke.py`` through its ``entry.py``
helper (``--model flagship``: ElasticTrainer on FLAGSHIP with the flash
kernels, batch 16 x seq 1024; ``resnet50``: RESNET50 with the GroupNorm
kernels, 256 x 224²; ``bert_base``: BERT_BASE MLM with the flash kernels,
32 x 512; adamw(3e-4) in each; ``flagship_decode``: one decode iteration of
the FLAGSHIP serving loop — ``llama.decode_step`` at 8 slots with 512
cached tokens a slot and its argmax read; ``flagship_virtual``: one step of
the virtual-worker loop's one-process control — ``step_accumulate`` of 8
micro-batches of 2 x 1024 from ``entry.flagship_virtual_world``) and
prints one JSON line.  After
two warm-up steps it runs ``--steps`` steps unprofiled, timed by CUDA
events, then ``--steps`` steps under ``torch.profiler``, and reports:

- device time and launches per step by kernel group, the launches per step
  in all, and the ``TOP_KERNELS`` costliest kernels (profiled window);
- ``idle_share_profiled``: 1 - device busy / wall of the profiled window
  (one window; the wall carries the profiler's own host cost);
- ``idle_share_unprofiled_est``: 1 - the profiled busy time per step / the
  unprofiled step time — derived across the two windows of this one run,
  since the unprofiled window has no kernel times of its own.

    python -m edl_tpu_torch.profile_step [--model resnet50] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

TOP_KERNELS = 25
#: kernel-name fragments → group (first match wins)
GROUPS = (
    ("gn_fwd_", "group_norm_fwd"),
    ("gn_bwd_", "group_norm_bwd"),
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_bwd_dq_kernel", "flash_bwd_dq"),
    ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
    ("fprop", "conv"), ("dgrad", "conv"), ("wgrad", "conv"),
    ("conv", "conv"), ("max_pool", "pooling"),
    ("gemm", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
    ("cutlass", "matmul"), ("cublas", "matmul"),
    ("multi_tensor_apply", "optimizer"),
    ("direct_copy", "copy_cast"), ("catarray", "copy_cast"),
    ("memcpy", "memcpy"),
    ("index", "gather_scatter"),
    ("softmax", "softmax"),
    ("reduce_kernel", "reduction"),
    ("elementwise", "elementwise"),
)
#: flagship_decode: the serving loop's decode batch and cached length
DECODE_SLOTS, DECODE_CACHED = 8, 512


def group_of(kernel: str) -> str:
    low = kernel.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


def decode_iteration(device="cuda"):
    """One iteration of the FLAGSHIP serving loop as a callable: a decode
    step at DECODE_SLOTS slots with DECODE_CACHED cached tokens each (seed-0
    weights), then the one argmax read of the loop."""
    import numpy as np

    from edl_tpu_torch.entry import DECODE_DEFAULTS
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.models import transformer as tfm
    from edl_tpu_torch.runtime.kvcache import KVBlockPool

    model = tfm.Transformer(tfm.FLAGSHIP, device=device, seed=0)
    params = llama.as_decode_params(model)
    del model
    maxb = DECODE_DEFAULTS["max_blocks_per_session"]
    pool = KVBlockPool(tfm.FLAGSHIP, DECODE_SLOTS * maxb,
                       DECODE_DEFAULTS["kv_block_size"], maxb,
                       job="profile/decode", device=device)
    for i in range(DECODE_SLOTS):
        pool.ensure_capacity(i, DECODE_CACHED + 1)
    tables = np.stack([pool.block_table(i) for i in range(DECODE_SLOTS)])
    toks = np.arange(DECODE_SLOTS)
    pos = np.full(DECODE_SLOTS, DECODE_CACHED)
    live = np.ones(DECODE_SLOTS, bool)

    def step():
        logits, _ = llama.decode_step(params, pool.cache, toks, pos, tables,
                                      live)
        return logits.argmax(dim=-1).tolist()

    return step


def virtual_step(device="cuda"):
    """One step of the virtual-worker loop's one-process control as a
    callable: the next 8 micro-batches of the job's stream, accumulated
    into one update."""
    from edl_tpu_torch.entry import flagship_virtual_world
    from edl_tpu_torch.runtime.virtual import VirtualBatches

    trainer, reg, ids, cfg = flagship_virtual_world(0, 1, None, device=device)
    batches = VirtualBatches(cfg, ids, reg.get, passes=64)

    def step():
        return trainer.step_accumulate(batches.next_step())

    return step


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from edl_tpu_torch import entry

    trainers = {"flagship": entry.flagship_trainer,
                "resnet50": entry.resnet_trainer,
                "bert_base": entry.bert_trainer}
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(trainers) + [
        "flagship_decode", "flagship_virtual"], default="flagship")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if args.model == "flagship_decode":
        step = decode_iteration()
    elif args.model == "flagship_virtual":
        step = virtual_step()
    else:
        trainer, batch = trainers[args.model]()

        def step():
            return trainer.step(batch)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step()
    end.record()
    torch.cuda.synchronize()
    unprofiled_ms = start.elapsed_time(end) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    per_kernel: dict[str, float] = defaultdict(float)
    calls: dict[str, int] = defaultdict(int)
    for evt in prof.key_averages():
        # user annotations (Optimizer.step#...) are spans, not kernels
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            per_kernel[evt.key] += evt.self_device_time_total / 1e3  # ms
            calls[evt.key] += evt.count
    groups: dict[str, float] = defaultdict(float)
    group_calls: dict[str, float] = defaultdict(float)
    for name, ms in per_kernel.items():
        groups[group_of(name)] += ms / args.steps
        group_calls[group_of(name)] += calls[name] / args.steps
    busy_ms = sum(per_kernel.values()) / args.steps
    step_ms = 1e3 * wall_s / args.steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "model": args.model,
        "steps": args.steps,
        "unprofiled_step_ms": unprofiled_ms,
        "profiled_step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share_profiled": (1 - busy_ms / step_ms) if busy_ms else None,
        "idle_share_unprofiled_est": (1 - busy_ms / unprofiled_ms)
        if busy_ms else None,
        "group_ms_per_step": dict(sorted(groups.items(),
                                         key=lambda kv: -kv[1])),
        "group_launches_per_step": dict(sorted(group_calls.items())),
        "launches_per_step": sum(group_calls.values()),
        "top_kernels_ms_per_step": {k[:120]: v / args.steps for k, v in top},
    }))


if __name__ == "__main__":
    main()
