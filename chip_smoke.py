"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

(a) build the hand-written kernels from ``edl_tpu_torch/csrc`` (nvcc,
    sm_90a), print the build seconds and, for each flash and GroupNorm
    kernel, the registers, static shared memory and spill bytes ptxas
    reported;
(b) hold each flash kernel — forward, dQ, dK/dV — against its plain PyTorch
    version at FLAGSHIP attention shapes (bf16, b 16, s 1024, h 8, hk 2,
    d 128), causal and non-causal, and time the kernel, the plain version
    and ``F.scaled_dot_product_attention`` (a yardstick the port never
    calls) beside the least time the card could take;
(c) the FLAGSHIP path: ``ElasticTrainer`` on FLAGSHIP with the flash
    kernels, adamw(3e-4), batch 16 x seq 1024 of seeded tokens, 1 warm-up
    step and 5 timed steps; every loss finite, the loss falling, and each
    kernel launched once per layer per step;
(d) the port's entry point, and the model's logits through the flash
    kernels against its reference attention path on a small input, with
    the same model's attention output zeroed as a control that must fail;
(e) the GroupNorm kernels against their plain versions at every distinct
    ResNet-50 site shape at b 256 (12 shapes, G 32, bf16), each shape's
    cluster plan in each direction (k blocks an image, rows a block, rows
    resident in shared memory) and the clusters the card runs at once,
    timed beside ``F.group_norm`` (a yardstick) and their byte bounds, and
    summed over the 53 sites of a step; a plan past clusters of 8 is also
    timed capped at 8;
(f) the flash kernels at the BERT-base shape (b 32, s 512, h = hk = 12,
    d 64, non-causal), at (k)'s micro-batch (b 2, FLAGSHIP's s, h, hk and
    d, causal), at the local batch of a live rank of (j) and (l) on a
    world of 2 (b 8), at a rank's heads on (m)'s tp 2 (b 16, h 4,
    hk 1), and at (o)'s tp-2 micro-batch (b 2, h 4, hk 1), checked and
    timed as in (b);
(g) the ResNet-50 path: ``ElasticTrainer`` on RESNET50 at b 256 x 224²,
    adamw(3e-4), 1 warm-up and 5 timed steps, 53 launches of each GroupNorm
    kernel per step; the same steps from fresh weights with
    ``EDL_GN_PALLAS=0`` (the plain versions, no launch); and the logits of
    the kernel path against the plain path's on a small input, with one
    stage's ``norm3`` scales zeroed as a control that must fail;
(h) the BERT-base path: ``ElasticTrainer`` on BERT_BASE at 32 x 512 MLM,
    1 warm-up and 5 timed steps, 12 launches of each flash kernel per step;
(i) the serving path: FLAGSHIP decoded token by token through
    ``flagship_decode_fleet`` (8 slots, 64-token prefill chunks, a paged KV
    pool of 16-token blocks).  The paged logits of 3 prompts of 256 tokens
    and 16 decode steps against ``transformer.apply`` on the same
    sequences, with a control that reads another session's context; 16
    mixed-priority sessions through a 2-replica fleet scaled to 1 once every
    session has its first token, token-equal to an undisturbed 1-replica
    fleet with no session dropped; the same sessions with speculative
    decode, equal to single-token decode wherever its logits' top-2 margin
    clears the logits check's tolerance, and ``verify_step`` fed perfect
    drafts held to the same rule; tokens/s, TTFT and TPOT, the device
    time of a decode step and of a prefill chunk, and 0 launches of the
    hand-written kernels (no Pallas kernel lies on the decode path);
(j) the multi-rank trainer: two spawned processes share the card and join
    one gloo process group through ``entry.flagship_elastic_world``
    (FLAGSHIP, the global batch of (c)).  Two steps on a world of 1 (rank 1
    stands by), ``resize(2)``, two steps on 2, ``resize(1)``, two steps on
    1; rank 1's params and optimizer state bitwise equal to rank 0's after
    the grow, every parameter bitwise equal across the ranks after each step
    of 2, each live rank launching every flash kernel once per layer a step
    and a rank standing by none, every loss within ``WORLD_LOSS_ATOL`` of a
    one-rank control (the same steps from the same init, in this process);
    then one more ``resize(2)`` with an allocation failure planted on rank 1
    only, which both ranks roll back, stepping on at world 1.  Two ranks on
    one card prove the protocol, not scaling: the world-2 step time is no
    data-parallel speed-up.
(k) the durable virtual-worker loop: two spawned ranks share the card over
    gloo (``entry.flagship_virtual_world``: FLAGSHIP, 8 virtual workers, a
    constant global batch of 16 x 1024 as 8 micro-batches, replicated
    accumulation).  ``VirtualWorkerLoop`` runs 9 steps through worlds 1→2,
    rank 0 checkpointing every 3 steps (``ElasticCheckpointer``, one DCP
    directory a step, in a temporary directory deleted at the end); every
    rank is then killed mid-accumulation (``abort_after=3`` on world 2), and
    fresh trainers restore step 9 and run steps 10-12, shrinking to 1.  The
    stitched 12 losses must equal a one-process control's bitwise, every
    row be trained exactly once, each live rank launch every flash kernel
    64 times a step (8 layers x 8 micro-batches) and one standing by none,
    and no loop's stall watchdog see a stall (each watches its own loop,
    not the restore or the drills).  Rank 0 then tears the newest step
    (12), past which a fresh checkpointer must fall back to 9, and times one
    synchronous save of the 1.86 GB state (its folds and its CRC32s alone
    too) and one ``save_async`` (its pause, then its persist).  The same
    schedule in dp-packed mode must stay within ``trajectories_equivalent``
    of the control.
(l) fsdp: two spawned ranks share the card over gloo
    (``entry.flagship_elastic_world`` with ``param_sharding="fsdp"`` and
    ``MeshSpec(dp=1, fsdp=-1)``: FLAGSHIP, the global batch of (c)) through
    (j)'s schedule of worlds 1→2→1.  Each resize's planned ``bytes_moved``
    against the bytes its broadcasts sent, and the full parameters bitwise
    the same before and after it; each rank's resting state on the world of
    2 (its blocks of the parameters and of Adam's moments, and
    ``torch.cuda.memory_allocated``) against the replicated trainer's, every
    sharded leaf holding exactly half its bytes; the collective census of a
    step by mesh axis; step times by rank (not a scaling figure); each
    live rank launching every flash kernel once per layer a step and one
    standing by none; every loss within ``WORLD_LOSS_ATOL`` of the
    one-rank control.
(m) Megatron tp: two spawned ranks share the card over gloo
    (``entry.flagship_tp_world``: FLAGSHIP laid out by its partition specs
    over ``MeshSpec(tp=-1)``, the global batch of (c)) through (j)'s
    schedule of worlds 1→2→1.  On the world of 2 each rank holds half of
    every matrix (the attention and MLP weights by heads and hidden
    columns, embed and lm_head by vocabulary) and of its Adam moments, and
    the whole norms; the flash kernels see 4 query and 1 kv head a rank
    (checked at that shape in (f)).  Gates: every split leaf and moment at
    exactly half its bytes on each rank of 2; the norms bitwise equal
    across the ranks after every world-2 step; the whole params bitwise
    kept through each resize; each resize's broadcast bytes the plan's
    ``bytes_moved`` less Adam's 4-byte count at most; every loss within
    ``WORLD_LOSS_ATOL`` of the one-rank control; each live rank launching
    every flash kernel once per layer a step and one standing by none; a
    world-2 step's census tp all-reduces alone (its count printed).
(n) ``entry.dryrun_multichip(2)``, ``(4)`` and ``(8)`` on the card: n
    ranks share it over gloo and take one step of TINY placed by its
    partition specs (fsdp 2, dp2×fsdp2, dp2×fsdp2×tp2), each printing its
    ``DRYRUN_COMM`` line.
(o) the sharded lineage.  (o-1): (k)'s job on fsdp trainers
    (``entry.flagship_virtual_world`` with ``param_sharding="fsdp"`` and
    ``MeshSpec(dp=1, fsdp=-1)``, world 2 being fsdp 2): each save gathers
    the whole state leaf by leaf to rank 0's host memory; the kill after
    step 9, the restore on fresh fsdp trainers and steps 10-12.  Gates: the
    12 losses bitwise (k)'s control, every row once, 64 launches of each
    flash kernel a step on a live rank and none on one standing by, and a
    torn newest step falling back to 9 on both ranks.  (o-2): a tp-2
    trainer (two ranks, FLAGSHIP's partition specs) and a world-1
    replicated trainer (this process) restore step 12: gathered, each
    holds the fsdp job's final params and Adam moments bitwise, with its
    count and step; each takes step 13, the tp loss within
    ``WORLD_LOSS_ATOL`` of the world-1 one; and the world-1 trainer's save
    of that state has the fsdp run's manifest fingerprint.  (o-3): a
    FLAGSHIP ``DecodeFleet`` from seed-0 weights reloads the lineage's
    newest step, and four prompts decode as on a fresh fleet built from the
    restored weights; ``watch_lineage`` ships the world-1 trainer's step 13
    within ``LINEAGE_PICKUP_S`` while sessions decode, dropping none; a
    step with a forged manifest is skipped and counted.  Prints the
    gather's census bytes, time and peak ``memory_allocated``, the sharded
    save's ``save_ms``, GB/s and ``save_async`` pause beside (k)'s, each
    ``restore_ms`` and the fleet's ``reload_ms``.
(p) the SDC defense plane on (k)'s job (``entry.flagship_virtual_world``),
    ``SDC_STEPS`` steps against (k)'s one-process control, each run with an
    ``SdcPlane`` (device-fold fingerprints, the anomaly gate, a shadow
    recompute on a fresh world-1 trainer).  (p-1): one process, a
    checkpoint every ``SDC_CKPT_EVERY`` steps, ``flip_param_bits`` on the
    final norm's first scale after step ``SDC_STRIKE_STEP`` (bit 30 makes it
    inf or NaN, so the next loss is NaN): the gate trips, the shadow
    confirms, the loop rolls back to the last verified step and replays;
    losses bitwise the control's, every row once, a flight record with the
    verdict trail.  (p-2): ``PoisonLoss`` refuted, no rollback, the repaired
    loss bitwise the control's.  (p-3): two one-rank workers in this
    process sharing a ``MemoryKV``; ``CorruptGradient`` strikes one, the
    fingerprints split, the shadow names and quarantines it, and both
    trajectories are the control's.  (p-4): two spawned ranks on a
    replicated world of 2 over gloo; the flip lands on both replicas, rank
    0 judges, both ranks take one verdict and roll back to one step, both
    bitwise the control's.  (p-5): the same ranks, fresh trainers on a
    world of 1: ``prewarm([2])``, ``prewarm_quiesce()``, ``resize(2)`` is a
    prewarm hit, and the state after it is bitwise a cold ``resize(2)``'s.
    Also checks the device fold against the host fold on every leaf of the
    1.86 GB state, and prints the fingerprint's step-loop pause by each
    fold, the shadow's and the rollback's ms, both resizes' ``compile_ms``
    and the flash launches a step.

Each path runs with the launch counts set to 0 just before it and read just
after.  Each kernel is held to the element-wise rule of
``edl_tpu_torch/ops/kernel_check.py``; ``python -m
edl_tpu_torch.ops.kernel_check`` shows that faults planted in the kernels
fail it.

Prints the card's name and power limit, one JSON line of kernels, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.entry import (DECODE_DEFAULTS, bert_trainer,
                                 dryrun_multichip, entry,
                                 flagship_decode_fleet, flagship_elastic_world,
                                 flagship_tp_world, flagship_trainer,
                                 flagship_virtual_world, resnet_trainer)
from edl_tpu_torch.models import llama, resnet
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.runtime import checkpoint as ckpt
from edl_tpu_torch.runtime import serving
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.elastic import AccumulationAborted
from edl_tpu_torch.runtime.faults import (CorruptGradient, FaultContext,
                                          FaultPlan, FaultPlanEngine,
                                          PoisonLoss)
from edl_tpu_torch.runtime import sdc
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.runtime.kvcache import KVBlockPool
from edl_tpu_torch.runtime.virtual import (DEFAULT_LOSS_ATOL,
                                           DEFAULT_LOSS_RTOL, VirtualBatches,
                                           VirtualWorkerLoop, loss_divergence,
                                           trajectories_equivalent)
from edl_tpu_torch.runtime.watchdog import StallWatchdog
from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.ops import group_norm as gn
from edl_tpu_torch.ops import kernel_check as kc

#: H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside the
#: tensor cores, and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: FLAGSHIP attention at bench.py's accelerator batch
B, S, H, HK, D = 16, 1024, 8, 2, 128
#: BERT-base attention at bench.py's model-zoo batch
BERT_B, BERT_S, BERT_H, BERT_D = 32, 512, 12, 64
#: ResNet-50 at bench.py's model-zoo batch
RESNET_B, RESNET_HW = 256, 224
WARMUP_STEPS, TIMED_STEPS = 1, 5
KERNEL_ITERS, PLAIN_ITERS = 20, 3
#: phase (e): the largest cluster every Hopper part runs; a plan past it is
#: also timed capped at it
PORTABLE_CLUSTER = 8
#: cuda_ms: ~10 ms at the H100's 1.98 GHz boost clock, far longer than the
#: host takes to queue KERNEL_ITERS calls of any kernel timed here
QUEUE_SLEEP_CYCLES = 20_000_000
#: phase (d): the logits of the flash and reference attention paths of the
#: bf16 model, element by element: |flash - reference| <= 2^-7 |reference|
#: + MODEL_ATOL * rms(reference).  The two paths round the attention
#: output at different points and the difference grows through 8 layers.
#: The floor sits between what the two paths need and what the model with
#: its attention output zeroed needs; phase (d) prints both (on an H100,
#: below 0.2 and above 7 rms)
MODEL_ATOL = 0.5
#: phase (g): the same rule for the ResNet-50 logits of the GroupNorm
#: kernels against the plain versions.  Both round at the same points; they
#: differ where an fp32 sum taken in another order moves a rounding, and
#: that grows through 53 norms.  Phase (g) prints the floor each side needs
RESNET_MODEL_ATOL = 0.25
#: phase (g)'s small input
RESNET_CHECK_BATCH = 4
#: arithmetic of each GroupNorm kernel per element (fp32, outside the
#: tensor cores): forward x·x, two sums, x·p + q; backward dy·x, two sums,
#: dy·p − x·q + r
GN_OPS_PER_ELEMENT = {"group_norm_fwd": 5, "group_norm_bwd": 7}
#: phase (i): the logits check's prompts, and the traffic of the resize
#: and speculative checks (prompt lengths uniform in SERVE_PROMPT_LENS)
LOGITS_PROMPTS, LOGITS_PROMPT_LEN, LOGITS_STEPS = 3, 256, 16
SERVE_SESSIONS, SERVE_NEW_TOKENS, SERVE_PROMPT_LENS = 16, 64, (64, 512)
SPEC_TOKENS = 4
#: phase (i): the paged logits against transformer.apply's, by the rule of
#: check_against.  The two round K/V and the attention output at other
#: points (bf16 cache, fp32 paged attention).  The floor sits between what
#: the two paths need and what the control (another session's context)
#: needs; phase (i) prints both (on an H100: 0.1445 and 7.28 rms)
SERVING_ATOL = 0.25
#: phase (i): a decode step or prefill chunk is ~550 launches, which take
#: the host 10-30 ms to queue; the card's launch queue holds about one
#: call's worth, so a timed call is one call behind a ~0.1 s device sleep,
#: and the record the median of SERVE_TIMED_REPS of them
SERVE_TIMED_REPS, SERVE_SLEEP_CYCLES = 5, 200_000_000
#: phase (j): the ranks sharing the card, the world each step runs on (the
#: trainer resizes where it changes), and each rank's time limit
WORLD_RANKS = 2
WORLD_SCHEDULE = (1, 1, 2, 2, 1, 1)
WORLD_CHILD_TIMEOUT_S = 600
#: phase (j): |loss - one-rank control's loss| for every step.  A world of
#: 2 splits the batch and averages two half-batch gradients, so its bf16
#: loss and every step after it drift from the control's in their last
#: digits (losses ~9.7); the world-1 steps before the first resize run the
#: control's exact computation
WORLD_LOSS_ATOL = 2e-2
#: phase (l): the fsdp trainer's layout (every rank on the fsdp axis)
FSDP_SPEC = MeshSpec(dp=1, fsdp=-1)
#: phase (n): the dryrun's sizes, the reference's layouts for each
DRYRUN_SIZES = (2, 4, 8)
#: phase (k): steps of the job, its checkpoint cadence, the step the first
#: loop stops at (the kill lands in the next one), the stall watchdog's
#: deadline floor, and the ranks' join deadline
VIRTUAL_STEPS = 12
VIRTUAL_CKPT_EVERY = 3
VIRTUAL_KILL_AFTER = 9
VIRTUAL_STALL_FLOOR_S = 30.0
VIRTUAL_CHILD_TIMEOUT_S = 900
#: phase (k)'s micro-batch: the global batch B over the job's 8 virtual
#: workers (entry.flagship_virtual_world's defaults); the flash kernels
#: are held against their plain versions at this batch too
VIRTUAL_MICRO_BATCH = B // 8
#: phase (o-2): the tp trainer's layout, (m)'s
TP_SPEC = MeshSpec(tp=-1)
#: phase (o-3): the prompts decoded on the reloaded and a fresh fleet and
#: their new tokens; the watcher's poll, the seconds it may take to ship a
#: step once saved, and the sessions kept decoding meanwhile (a new one
#: submitted whenever fewer are in flight)
LINEAGE_PROMPT_LENS, LINEAGE_NEW_TOKENS = (64, 192, 320, 512), 32
LINEAGE_POLL_S, LINEAGE_PICKUP_S = 0.5, 5.0
WATCH_SESSIONS, WATCH_PROMPT_LEN, WATCH_NEW_TOKENS = 4, 64, 256
#: phase (p): steps of each drill, the checkpoint cadence, the step after
#: which a strike lands (the next step is the first to carry it), and the
#: flip: bit 30 of the final norm's first scale (the last leaf in flatten
#: order), the exponent's top bit of a value near 1.0, which makes it inf
#: or NaN; the fingerprint pauses are each the median of SDC_PAUSE_REPS
SDC_STEPS, SDC_CKPT_EVERY, SDC_STRIKE_STEP = 5, 3, 4
SDC_FLIP = dict(leaf=-1, bit=30)
SDC_PAUSE_REPS = 3

KERNELS = {
    "flash_fwd": dict(source="edl_tpu_torch/csrc/flash_fwd.cu",
                      replaces="edl_tpu/ops/flash_attention.py:96",
                      products=2),
    "flash_bwd_dq": dict(source="edl_tpu_torch/csrc/flash_bwd.cu",
                         replaces="edl_tpu/ops/flash_attention.py:210",
                         products=3),
    "flash_bwd_dkv": dict(source="edl_tpu_torch/csrc/flash_bwd.cu",
                          replaces="edl_tpu/ops/flash_attention.py:251",
                          products=4),
    "group_norm_fwd": dict(source="edl_tpu_torch/csrc/group_norm.cu",
                           replaces="edl_tpu/ops/group_norm.py:67"),
    "group_norm_bwd": dict(source="edl_tpu_torch/csrc/group_norm.cu",
                           replaces="edl_tpu/ops/group_norm.py:128"),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
GROUP_NORM = ("group_norm_fwd", "group_norm_bwd")


def cuda_ms(fn, iters: int, sleep_cycles: int = QUEUE_SLEEP_CYCLES
            ) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call (CUDA events).  The card first sleeps for
    ``sleep_cycles`` while the host queues every call, so that a call
    shorter than its own launch cost on the host is timed on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(flops: float, peak_flops: float, tensors) -> tuple[float, str]:
    """Least time for the work on this card (ms): the larger of its
    operations at ``peak_flops`` and its bytes (each input read once, each
    output written once) at the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def print_ptxas_report() -> None:
    """(a): what ptxas reported for each flash and GroupNorm kernel
    instantiation.  The register count is the one a block is launched
    with; the flash kernels then move registers from their producer
    warpgroup to their consumers with setmaxnreg
    (csrc/hopper_common.cuh)."""
    for lib in ("flash_fwd", "flash_bwd", "group_norm"):
        for r in _build.ptxas_report(lib):
            print(f"ptxas {lib} {r['kernel']}: registers {r['registers']} "
                  f"static_smem_bytes {r['static_smem_bytes']} "
                  f"spill_store_bytes {r['spill_store_bytes']} "
                  f"spill_load_bytes {r['spill_load_bytes']}", flush=True)


def phase_flash(b: int, s: int, h: int, hk: int, d: int, causal_modes,
                label: str) -> dict:
    """(b) and (f): every flash kernel against its plain version at one
    shape; the timings of the first mode are the record."""
    rows = {name: {"max_abs_err": 0.0} for name in FLASH}
    dev = torch.device("cuda")
    for seed, causal in enumerate(causal_modes):
        q, k, v, do = kc.random_inputs(b * h, b * hk, s, d, seed, dev)
        readings, got = kc.compare(q, k, v, do, causal, h, hk)
        tag = f"{label} {'causal' if causal else 'full'}"
        for name, r in readings.items():
            print(f"check {name} {tag}: max |kernel - plain| "
                  f"{r['max_abs_err']:.4e}, {r['worst']:.3f} of its limit "
                  f"(floor needed {r['need_atol']:.4f} rms)", flush=True)
        failed = kc.failures(readings)
        if failed:
            raise AssertionError(f"kernels vs plain versions ({tag}): "
                                 + "; ".join(failed))
        errs = {name: max(readings[o]["max_abs_err"] for o in outs
                          if o != "lse")
                for name, outs in kc.OUTPUTS.items() if name in FLASH}
        for name, e in errs.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)

        # timings at these inputs; the library yardstick is SDPA with GQA
        # on the [b, h, s, d] views of the same buffers
        out, lse, delta = got["out"], got["lse"], got["delta"]
        q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                 enable_gqa=True)
        do4 = do.view(b, h, s, d)
        times = {
            "flash_fwd": (
                lambda: fa.flash_forward_cuda(q, k, v, causal, h, hk),
                lambda: fa.flash_forward_plain(q, k, v, causal, h, hk),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=True),
                (q, k, v, out, lse)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal,
                                             h, hk),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                              h, hk),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                            retain_graph=True),
                (q, k, v, do, lse, delta, got["dq"])),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                              causal, h, hk),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal, h, hk),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                            retain_graph=True),
                (q, k, v, do, lse, delta, got["dk"], got["dv"])),
        }
        pairs = s * (s + 1) // 2 if causal else s * s
        for name, (kern, plain, lib, tensors) in times.items():
            ms = cuda_ms(kern, KERNEL_ITERS)
            plain_ms = cuda_ms(plain, PLAIN_ITERS)
            library_ms = cuda_ms(lib, KERNEL_ITERS)
            flops = KERNELS[name]["products"] * 2.0 * b * h * pairs * d
            bound_ms, bound_by = roofline(flops, PEAK_BF16_FLOPS, tensors)
            print(f"kernel {name} {tag}: max_abs_err {errs[name]:.4e} "
                  f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by})", flush=True)
            if causal == causal_modes[0]:
                rows[name].update(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
        del lib_out
    return rows


def run_path(label: str, trainer, batch, counters: dict, want: dict,
             unit: str, per_step_units: int) -> tuple[dict, float]:
    """1 warm-up and 5 timed steps of ``trainer`` with ``counters`` set to 0
    just before; every step must grow each counter by ``want`` and every
    loss be finite, the loss falling.  Returns (the counts just after, the
    mean timed step in ms)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for name in counters:
        counters[name] = 0
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        before = dict(counters)
        t0 = time.perf_counter()
        losses.append(trainer.step(batch))  # float(loss) waits for the step
        step_s.append(time.perf_counter() - t0)
        grown = {n: counters[n] - before[n] for n in counters}
        if grown != want:
            raise AssertionError(f"{label} step {i}: launches {grown}, "
                                 f"want {want}")
    launches = dict(counters)
    timed = losses[WARMUP_STEPS:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"{label}: loss did not fall: {timed}")
    step_ms = 1e3 * float(np.mean(step_s[WARMUP_STEPS:]))
    median_ms = 1e3 * float(np.median(step_s[WARMUP_STEPS:]))
    print(f"path {label}: losses {[round(x, 4) for x in losses]} "
          f"step_ms {step_ms:.2f} median_step_ms {median_ms:.2f} "
          f"(per step {[round(1e3 * x, 2) for x in step_s]}) "
          f"{unit}_per_second {per_step_units / (step_ms / 1e3):.1f} "
          f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches {launches}", flush=True)
    return launches, step_ms


def phase_flagship() -> dict:
    """(c): FLAGSHIP train steps through ElasticTrainer with the kernels."""
    trainer, batch = flagship_trainer(B, S)
    n = trainer.state.params.cfg.n_layers
    launches, _ = run_path(f"flagship b{B} s{S}", trainer, batch,
                           fa.launches, {k: n for k in FLASH}, "tokens",
                           B * S)
    return launches


def phase_model_check() -> None:
    """(d): the entry point's logits, and the flash path's logits against
    the reference attention path's on one small input; the same model with
    every attention output projection zeroed must fail that check."""
    fn, (model, tokens) = entry()
    with torch.no_grad():
        logits = fn(model, tokens)
    if logits.shape != (2, 256, model.cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"entry logits {tuple(logits.shape)} not "
                             "finite of the expected shape")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (2, 256))).cuda()
    with torch.no_grad():
        out = {}
        for use_flash in (True, False):
            model.cfg = dataclasses.replace(model.cfg, use_flash=use_flash)
            out[use_flash] = fn(model, toks)
        for layer in model.layers:
            layer.wo.zero_()
        out["no attention"] = fn(model, toks)
    check_against(out[False], out[True], out["no attention"], MODEL_ATOL,
                  "flash vs reference logits", "attention zeroed")


def check_against(ref, got, control, atol: float, what: str,
                  control_what: str) -> None:
    """``got`` must pass 2^-7·|ref| + atol·rms(ref) element by element and
    ``control`` must fail it."""
    rms = ref.float().square().mean().sqrt().item()
    r, c = (kc.reading(x, ref, kc.BF16_RTOL, atol * rms)
            for x in (got, control))
    print(f"model check: {what} max |diff| {r['max_abs_err']:.4f}, "
          f"{r['worst']:.3f} of the limit (floor needed "
          f"{r['need_atol']:.4f} rms); {control_what} {c['worst']:.3f} of "
          f"it ({c['need_atol']:.4f} rms)", flush=True)
    if not r["worst"] <= 1.0:
        raise AssertionError(f"{what}: off the reference")
    if c["worst"] <= 1.0:
        raise AssertionError(f"{what}: the check passes its control "
                             f"({control_what})")


def gn_plan(name: str, tag: str, hw: int, c: int, dtype,
            max_k: int = gn.MAX_CLUSTER) -> tuple[int, int, int]:
    """(e): one kernel's cluster plan at one site shape, printed with the
    clusters of it the card runs at once."""
    backward = name == "group_norm_bwd"
    itemsize = torch.finfo(dtype).bits // 8
    k, rows, resident = plan = gn.cluster_plan(hw, c, itemsize, backward,
                                               max_k)
    held = ("resident" if resident == (1 + backward) * rows
            else "reads rows again")
    print(f"plan {name} {tag}: k {k} rows {rows} resident {resident} "
          f"({held}) active_clusters "
          f"{gn.active_clusters(c, dtype, backward, plan)}", flush=True)
    return plan


def phase_group_norm(sites) -> dict:
    """(e): both GroupNorm kernels against their plain versions at every
    site shape of the ResNet-50 step; per-step sums over the sites."""
    rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bound_ms=0.0, bound_by="bytes") for name in GROUP_NORM}
    dev, groups = torch.device("cuda"), resnet.RESNET50.groups
    for seed, ((hw, c), count) in enumerate(sorted(sites.items())):
        x, dy, scale, bias = kc.gn_random_inputs(RESNET_B, hw, c, seed, dev)
        readings, got = kc.gn_compare(x, dy, scale, bias, groups)
        tag = f"[{RESNET_B},{hw},{c}] x{count}"
        plans = {name: gn_plan(name, tag, hw, c, x.dtype)
                 for name in GROUP_NORM}
        for name, r in readings.items():
            print(f"check {name} {tag}: max |kernel - plain| "
                  f"{r['max_abs_err']:.4e}, {r['worst']:.3f} of its limit "
                  f"(floor needed {r['need_atol']:.6f} rms)", flush=True)
        failed = kc.failures(readings)
        if failed:
            raise AssertionError(f"group norm kernels vs plain versions "
                                 f"({tag}): " + "; ".join(failed))
        mean, inv = got["mean"], got["inv"]
        # the yardstick: F.group_norm on the channels-last NCHW view of the
        # same memory (its parameters in x's dtype, cast before timing)
        side = math.isqrt(hw)
        nchw = (lambda t: t.view(RESNET_B, side, side, c)  # noqa: E731
                .permute(0, 3, 1, 2))
        xg = nchw(x).detach().requires_grad_()
        sg, bg = (t.to(x.dtype).requires_grad_() for t in (scale, bias))
        lib_out = F.group_norm(xg, groups, sg, bg, 1e-5)
        times = {
            "group_norm_fwd": (
                lambda plan=None: gn.group_norm_fwd_cuda(
                    x, scale, bias, groups, 1e-5, plan),
                lambda: gn.group_norm_fwd_plain(x, scale, bias, groups, 1e-5),
                lambda: F.group_norm(nchw(x), groups, sg.detach(),
                                     bg.detach(), 1e-5),
                (x, scale, bias, got["y"], mean, inv)),
            "group_norm_bwd": (
                lambda plan=None: gn.group_norm_bwd_cuda(
                    x, dy, scale, mean, inv, groups, plan),
                lambda: gn.group_norm_bwd_plain(x, dy, scale, mean, inv,
                                                groups),
                lambda: torch.autograd.grad(lib_out, (xg, sg, bg), nchw(dy),
                                            retain_graph=True),
                (x, dy, scale, mean, inv, got["dx"], got["dgamma"],
                 got["dbeta"])),
        }
        for name, (kern, plain, lib, tensors) in times.items():
            ms = cuda_ms(kern, KERNEL_ITERS)
            plain_ms = cuda_ms(plain, PLAIN_ITERS)
            library_ms = cuda_ms(lib, KERNEL_ITERS)
            if plans[name][0] > PORTABLE_CLUSTER:
                # a plan past the portable cluster size against the one
                # capped at it, which keeps dy and reads x again
                alt = gn_plan(name, tag, hw, c, x.dtype, PORTABLE_CLUSTER)
                alt_ms = cuda_ms(lambda: kern(plan=alt), KERNEL_ITERS)
                print(f"alt_plan {name} {tag}: kernel_ms {alt_ms:.4f} at k "
                      f"{alt[0]}, {ms:.4f} at k {plans[name][0]}",
                      flush=True)
            bound_ms, bound_by = roofline(
                GN_OPS_PER_ELEMENT[name] * x.numel(), PEAK_FP32_FLOPS,
                tensors)
            err = readings["y" if name == "group_norm_fwd" else "dx"][
                "max_abs_err"]
            print(f"kernel {name} {tag}: max_abs_err {err:.4e} "
                  f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by})", flush=True)
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms),
                             ("bound_ms", bound_ms)):
                row[key] += count * val
            if bound_by != "bytes":
                row["bound_by"] = bound_by
        del lib_out, xg
    for name, row in rows.items():
        print(f"kernel {name} per ResNet-50 step ({sum(sites.values())} "
              f"sites): kernel_ms {row['ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
              f"bound_ms {row['bound_ms']:.4f}", flush=True)
    return rows


@contextlib.contextmanager
def plain_group_norm():
    """Within the block, GroupNorm on the card runs its plain versions
    (``EDL_GN_PALLAS=0``)."""
    kept = os.environ.get("EDL_GN_PALLAS")
    os.environ["EDL_GN_PALLAS"] = "0"
    try:
        yield
    finally:
        if kept is None:
            del os.environ["EDL_GN_PALLAS"]
        else:
            os.environ["EDL_GN_PALLAS"] = kept


def phase_resnet(n_sites: int) -> dict:
    """(g): ResNet-50 train steps with the GroupNorm kernels, the same steps
    with the plain versions, and the logits check."""
    label = f"resnet50 b{RESNET_B} {RESNET_HW}x{RESNET_HW}"
    trainer, batch = resnet_trainer(RESNET_B, RESNET_HW)
    launches, step_ms = run_path(label, trainer, batch, gn.launches,
                                 {k: n_sites for k in GROUP_NORM}, "images",
                                 RESNET_B)
    del trainer, batch
    torch.cuda.empty_cache()
    with plain_group_norm():
        trainer, batch = resnet_trainer(RESNET_B, RESNET_HW)
        _, plain_step_ms = run_path(label + " EDL_GN_PALLAS=0", trainer,
                                    batch, gn.launches,
                                    {k: 0 for k in GROUP_NORM}, "images",
                                    RESNET_B)
    del trainer, batch
    torch.cuda.empty_cache()
    print(f"resnet50 A/B: step_ms {step_ms:.2f} with the GroupNorm kernels, "
          f"{plain_step_ms:.2f} with their plain versions", flush=True)

    model = resnet.ResNet(resnet.RESNET50, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randn(RESNET_CHECK_BATCH, RESNET_HW, RESNET_HW, 3,
                         generator=gen, device="cuda")
    with torch.no_grad():
        # GroupNorm scales and biases off their init (1 and 0), so that p
        # and q of every site are rounded values of their own
        for norm in model.modules():
            if isinstance(norm, resnet.Norm):
                norm.scale.add_(0.1 * torch.randn(
                    norm.scale.shape, generator=gen, device="cuda"))
                norm.bias.add_(0.1 * torch.randn(
                    norm.bias.shape, generator=gen, device="cuda"))
        kernel = resnet.apply(model, images)
        with plain_group_norm():
            plain = resnet.apply(model, images)
        for blk in model.stages[-1]:
            blk.norm3.scale.zero_()
        control = resnet.apply(model, images)
    if not torch.isfinite(kernel).all() or kernel.shape != (
            RESNET_CHECK_BATCH, resnet.RESNET50.num_classes):
        raise AssertionError("resnet50 logits not finite of the expected "
                             "shape")
    check_against(plain, kernel, control, RESNET_MODEL_ATOL,
                  "resnet50 kernel vs plain GroupNorm logits",
                  "last stage's norm3 scales zeroed")
    return launches


def phase_bert() -> dict:
    """(h): BERT-base MLM train steps through the flash kernels."""
    trainer, batch = bert_trainer(BERT_B, BERT_S)
    n = trainer.state.params.cfg.n_layers
    launches, _ = run_path(f"bert_base b{BERT_B} s{BERT_S}", trainer, batch,
                           fa.launches, {k: n for k in FLASH}, "tokens",
                           BERT_B * BERT_S)
    return launches

# -- phase (i): the serving path -------------------------------------------


def zero_launch_counts() -> None:
    for counts in (fa.launches, gn.launches):
        for name in counts:
            counts[name] = 0


def serving_pool(cfg, job: str, dev) -> KVBlockPool:
    """(i): a pool of the fleet's shapes, with a block for every slot at
    full context."""
    maxb = DECODE_DEFAULTS["max_blocks_per_session"]
    return KVBlockPool(cfg, DECODE_DEFAULTS["slots"] * maxb,
                       DECODE_DEFAULTS["kv_block_size"], maxb, job=job,
                       device=dev)


def serving_logits_check(model, dev) -> None:
    """(i): the paged path's logits — the last prefill chunk's last row,
    then LOGITS_STEPS decode steps at the fleet's 8 slots — against
    ``transformer.apply`` on the same full sequences; the control reads
    each session's context through the next session's block table."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    n, plen = LOGITS_PROMPTS, LOGITS_PROMPT_LEN
    pool = serving_pool(cfg, "smoke/logits", dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (n, plen))
    tables = np.full((slots, pool.max_blocks_per_session), pool.num_blocks)
    for i in range(n):
        pool.ensure_capacity(i, plen + LOGITS_STEPS)
        tables[i] = pool.block_table(i)
    rolled = tables.copy()
    rolled[:n] = np.roll(tables[:n], 1, axis=0)

    def scratch():
        return {name: t.clone() for name, t in pool.cache.items()}

    got, control = [], []
    for start in range(0, plen, chunk):
        rows, ctrl_rows = [], []
        for i in range(n):
            toks = prompts[i, start:start + chunk]
            if start + chunk >= plen:
                lc, _ = llama.prefill(params, scratch(), toks, rolled[i],
                                      start, len(toks))
                ctrl_rows.append(lc[len(toks) - 1])
            lg, _ = llama.prefill(params, pool.cache, toks, tables[i], start,
                                  len(toks))
            rows.append(lg[len(toks) - 1])
    got.append(torch.stack(rows))
    control.append(torch.stack(ctrl_rows))
    seqs = prompts.tolist()
    live = np.arange(slots) < n
    for step in range(LOGITS_STEPS):
        nxt = got[-1].argmax(dim=-1).tolist()
        toks = np.zeros(slots, np.int64)
        toks[:n] = nxt
        pos = np.where(live, plen + step, 0)
        for seq, t in zip(seqs, nxt):
            seq.append(t)
        lc, _ = llama.decode_step(params, scratch(), toks, pos, rolled, live)
        lg, _ = llama.decode_step(params, pool.cache, toks, pos, tables, live)
        got.append(lg[:n])
        control.append(lc[:n])
    full = torch.tensor(seqs, device=dev)
    with torch.no_grad():
        ref = [tfm.apply(model, full[:, :plen + step])[:, -1]
               for step in range(LOGITS_STEPS + 1)]
    check_against(torch.stack(ref), torch.stack(got), torch.stack(control),
                  SERVING_ATOL, "paged decode vs transformer.apply logits",
                  "another session's context")


def serving_timings(model, dev) -> None:
    """(i): the device time of one decode step at 8 slots with 512 cached
    tokens a slot, and of one 64-token prefill chunk over 448 cached
    tokens, with their byte bounds; and the host's time a decode step."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    cached = 512
    pool = serving_pool(cfg, "smoke/timing", dev)
    for i in range(slots):
        pool.ensure_capacity(i, cached + 1)
    tables = np.stack([pool.block_table(i) for i in range(slots)])
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, chunk)
    pos = np.full(slots, cached)
    live = np.ones(slots, bool)

    def decode():
        return llama.decode_step(params, pool.cache, toks[:slots], pos,
                                 tables, live)

    def prefill():
        return llama.prefill(params, pool.cache, toks, tables[0],
                             cached - chunk, chunk)

    def device_ms(fn):
        return float(np.median([cuda_ms(fn, 1, SERVE_SLEEP_CYCLES)
                                for _ in range(SERVE_TIMED_REPS)]))

    decode_ms, prefill_ms = device_ms(decode), device_ms(prefill)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_TIMED_REPS):
        decode()[0].argmax(dim=-1).tolist()  # the loop's one read
    host_ms = 1e3 * (time.perf_counter() - t0) / SERVE_TIMED_REPS
    weights = sum(t.numel() * t.element_size()
                  for layer in params.layers for name, t in layer.items()
                  if name.startswith("w")) + (
        params.lm_head.numel() * params.lm_head.element_size())
    mm_params = weights // params.lm_head.element_size()
    kv_token = llama.cache_bytes(cfg, 1, 1)
    for label, ms, rows, kv_tokens in (
            ("decode_step 8 slots x 512 cached", decode_ms, slots,
             slots * (cached + 1)),
            ("prefill chunk 64 over 448 cached", prefill_ms, chunk, cached)):
        nbytes = weights + kv_tokens * kv_token
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2.0 * mm_params * rows / PEAK_BF16_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        print(f"serve {label}: device_ms {ms:.4f} bound_ms {bound:.4f} "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{nbytes / 1e6:.1f} MB of weights and K/V)", flush=True)
    print(f"serve decode_step host_ms {host_ms:.4f} a step with its argmax "
          f"read (the loop's pace)", flush=True)


def serving_traffic(cfg) -> list[tuple[list[int], int]]:
    """(i): SERVE_SESSIONS (prompt, priority): lengths uniform in
    SERVE_PROMPT_LENS and ids uniform over the vocabulary, from seed 1;
    priorities high, normal and low in turn."""
    rng = np.random.default_rng(1)
    lo, hi = SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, SERVE_SESSIONS)
    pris = (serving.PRI_HIGH, serving.PRI_NORMAL, serving.PRI_LOW)
    return [(rng.integers(0, cfg.vocab_size, int(n)).tolist(), pris[i % 3])
            for i, n in enumerate(lens)]


def serve(label: str, fleet, traffic, resize_to=None) -> dict:
    """(i): every session of ``traffic`` through ``fleet`` (stopped after);
    with ``resize_to``, ``scale_to(resize_to)`` once every session has its
    first token.  Prints tokens/s, TTFT and TPOT (from the sessions, and
    the histogram buckets holding p50/p99) and returns the run."""
    try:
        t0 = time.perf_counter()
        sessions = [fleet.submit(p, SERVE_NEW_TOKENS, priority=pri)
                    for p, pri in traffic]
        if resize_to is not None:
            for s in sessions:
                s.wait_first_token(300)
            t_scale = time.perf_counter()
            fleet.scale_to(resize_to)
            scale_ms = 1e3 * (time.perf_counter() - t_scale)
        tokens = [s.wait(300) for s in sessions]
        wall = time.perf_counter() - t0
        run = dict(tokens=tokens, failed=fleet.sessions_failed,
                   migrations=fleet.migrations,
                   d2d_bytes=fleet.migration_bytes_d2d,
                   host_bytes=fleet.migration_bytes_host,
                   kv_bytes=fleet.kv_bytes(),
                   drafted=sum(r.spec_drafted for r in fleet._replicas),
                   accepted=sum(r.spec_accepted for r in fleet._replicas))
    finally:
        fleet.stop()
    n_tok = sum(len(t) for t in tokens)
    ttft = 1e3 * np.array([s.ttft_s for s in sessions])
    tpot = 1e3 * np.array([s.tpot_s for s in sessions])
    reg = get_registry()
    hist = {name: [reg.histogram(f"serving_{name}_seconds")
                   .quantile_bucket(q, job=fleet.job) for q in (0.5, 0.99)]
            for name in ("ttft", "tpot")}
    resize = (f" scale_to({resize_to}) {scale_ms:.1f} ms"
              if resize_to is not None else "")
    print(f"serve {label}: sessions {len(sessions)} tokens {n_tok} wall_s "
          f"{wall:.3f} decode_tokens_per_s {n_tok / wall:.1f} ttft_ms p50 "
          f"{np.percentile(ttft, 50):.2f} p99 {np.percentile(ttft, 99):.2f} "
          f"tpot_ms p50 {np.percentile(tpot, 50):.3f} p99 "
          f"{np.percentile(tpot, 99):.3f} (histogram buckets: ttft_s "
          f"<= {hist['ttft']}, tpot_s <= {hist['tpot']}) failed "
          f"{run['failed']} migrations {run['migrations']} d2d_bytes "
          f"{run['d2d_bytes']} host_bytes {run['host_bytes']} kv_bytes "
          f"{run['kv_bytes']}{resize}", flush=True)
    return run


def single_token_margins(model, traffic, tokens, dev) -> list:
    """(i): the single-token path's logits teacher-forced with ``tokens``
    (the single-token fleet's), the sessions in groups of the fleet's
    slots at its shapes: per session and generated position, the top-2
    logits, the rms of the logits and their argmax."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    out = []
    for lo in range(0, len(traffic), slots):
        group = list(range(lo, min(lo + slots, len(traffic))))
        pool = serving_pool(cfg, "smoke/margins", dev)
        rows = {}
        for i in group:
            prompt = traffic[i][0]
            pool.ensure_capacity(i, len(prompt) + SERVE_NEW_TOKENS)
            for start in range(0, len(prompt), chunk):
                n = min(chunk, len(prompt) - start)
                toks = np.zeros(chunk, np.int64)
                toks[:n] = prompt[start:start + n]
                lg, _ = llama.prefill(params, pool.cache, toks,
                                      pool.block_table(i), start, n)
            rows[i] = [lg[n - 1]]
        tables = np.full((slots, pool.max_blocks_per_session),
                         pool.num_blocks)
        live = np.zeros(slots, bool)
        for j, i in enumerate(group):
            tables[j], live[j] = pool.block_table(i), True
        for step in range(SERVE_NEW_TOKENS - 1):
            toks = np.zeros(slots, np.int64)
            pos = np.zeros(slots, np.int64)
            for j, i in enumerate(group):
                toks[j] = tokens[i][step]
                pos[j] = len(traffic[i][0]) + step
            lg, _ = llama.decode_step(params, pool.cache, toks, pos, tables,
                                      live)
            for j, i in enumerate(group):
                rows[i].append(lg[j])
        for i in group:
            logits = torch.stack(rows[i])
            out.append((logits.topk(2, dim=-1).values.cpu(),
                        logits.square().mean(dim=-1).sqrt().cpu(),
                        logits.argmax(dim=-1).cpu()))
    return out


def perfect_draft_check(model, traffic, tokens, margins, dev) -> None:
    """(i): ``verify_step`` fed the single-token tokens as its drafts
    (every draft right, SPEC_TOKENS rows a slot, the fleet's shapes): each
    row's argmax must be the next single-token token wherever that token's
    top-2 margin clears the tolerance of :func:`spec_check`."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    rows = above = wrong = 0
    for lo in range(0, len(traffic), slots):
        group = list(range(lo, min(lo + slots, len(traffic))))
        pool = serving_pool(cfg, "smoke/drafts", dev)
        for i in group:
            prompt = traffic[i][0]
            pool.ensure_capacity(i, len(prompt) + SERVE_NEW_TOKENS)
            for start in range(0, len(prompt), chunk):
                n = min(chunk, len(prompt) - start)
                toks = np.zeros(chunk, np.int64)
                toks[:n] = prompt[start:start + n]
                llama.prefill(params, pool.cache, toks, pool.block_table(i),
                              start, n)
        tables = np.full((slots, pool.max_blocks_per_session),
                         pool.num_blocks)
        for j, i in enumerate(group):
            tables[j] = pool.block_table(i)
        for first in range(0, SERVE_NEW_TOKENS - 1, SPEC_TOKENS):
            feed = np.zeros((slots, SPEC_TOKENS), np.int64)
            pos = np.zeros(slots, np.int64)
            nts = np.zeros(slots, np.int64)
            for j, i in enumerate(group):
                k = min(SPEC_TOKENS, SERVE_NEW_TOKENS - 1 - first)
                feed[j, :k] = tokens[i][first:first + k]
                pos[j] = len(traffic[i][0]) + first
                nts[j] = k
            best = llama.verify_step(params, pool.cache, feed, pos, nts,
                                     tables)[0].argmax(dim=-1).tolist()
            for j, i in enumerate(group):
                top2, rms, _ = margins[i]
                for r in range(int(nts[j])):
                    t = first + r + 1  # the generated position row r feeds
                    tol = (kc.BF16_RTOL * top2[t].abs().sum()
                           + 2 * SERVING_ATOL * rms[t])
                    clear = bool(top2[t, 0] - top2[t, 1] > tol)
                    rows += 1
                    above += clear
                    wrong += clear and best[j][r] != tokens[i][t]
    print(f"serve verify with perfect drafts: {rows} rows, {above} above the "
          f"margin, {wrong} of those off the single-token token", flush=True)
    if wrong:
        raise AssertionError(f"verify_step: {wrong} rows above the margin "
                             "disagree with single-token decode")


def spec_check(single, spec, margins) -> None:
    """(i): speculative tokens equal single-token ones up to each
    session's first difference, which must fall where the single-token
    logits' top-2 margin is within the logits check's tolerance for those
    two logits (2^-7 of each, plus SERVING_ATOL rms each)."""
    compared = under = forced_equal = 0
    first_diffs = []
    for i, (a, b) in enumerate(zip(single, spec)):
        top2, rms, best = margins[i]
        forced_equal += int((best == torch.tensor(a)).sum())
        tol = kc.BF16_RTOL * top2.abs().sum(dim=-1) + 2 * SERVING_ATOL * rms
        low = (top2[:, 0] - top2[:, 1]) <= tol
        for j, (x, y) in enumerate(zip(a, b)):
            compared += 1
            under += int(low[j])
            if x != y:
                first_diffs.append((i, j, bool(low[j])))
                break
    print(f"serve spec vs single: compared {compared} tokens, {under} under "
          f"the margin; first differences (session, position, under the "
          f"margin) {first_diffs}; teacher-forced single-token argmax "
          f"equals the fleet's tokens at {forced_equal} of "
          f"{sum(len(a) for a in single)}", flush=True)
    bad = [d for d in first_diffs if not d[2]]
    if bad:
        raise AssertionError(f"speculative decode differs from single-token "
                             f"decode above the margin: {bad}")


def phase_serving() -> dict:
    """(i): FLAGSHIP served on the card through the decode plane."""
    zero_launch_counts()
    dev = torch.device("cuda")
    model = tfm.Transformer(tfm.FLAGSHIP, device=dev, seed=0)
    serving_logits_check(model, dev)
    serving_timings(model, dev)
    traffic = serving_traffic(model.cfg)
    resized = serve("2->1 resize", flagship_decode_fleet(
        roles={"decode": 2}, job="smoke/resize"), traffic, resize_to=1)
    single = serve("1 replica", flagship_decode_fleet(job="smoke/single"),
                   traffic)
    if resized["failed"] or resized["migrations"] < 1:
        raise AssertionError(f"resize: {resized['failed']} sessions failed, "
                             f"{resized['migrations']} migrations")
    differ = [(i, next(j for j, (x, y) in enumerate(zip(a + [None], b))
                       if x != y))
              for i, (a, b) in enumerate(zip(resized["tokens"],
                                             single["tokens"])) if a != b]
    print(f"serve resize vs undisturbed: {len(traffic) - len(differ)} of "
          f"{len(traffic)} sessions token-equal; (session, first differing "
          f"position) {differ}", flush=True)
    if differ:
        raise AssertionError(f"2->1 resize tokens differ from the "
                             f"undisturbed fleet's: {differ}")
    spec = serve(f"1 replica spec_tokens {SPEC_TOKENS}", flagship_decode_fleet(
        job="smoke/spec", spec_tokens=SPEC_TOKENS), traffic)
    print(f"serve spec acceptance: {spec['accepted']} of {spec['drafted']} "
          f"drafts ({spec['accepted'] / max(spec['drafted'], 1):.4f})",
          flush=True)
    margins = single_token_margins(model, traffic, single["tokens"], dev)
    spec_check(single["tokens"], spec["tokens"], margins)
    perfect_draft_check(model, traffic, single["tokens"], margins, dev)
    launches = {**fa.launches, **gn.launches}
    print(f"serve launches of the hand-written kernels over phase (i): "
          f"{launches} (no Pallas kernel lies on the decode path)",
          flush=True)
    if any(launches.values()):
        raise AssertionError(f"phase (i) launched {launches}")
    return launches


# -- phase (j): the multi-rank trainer ---------------------------------------


def checksum(tensors) -> list[list[int]]:
    """A bitwise fingerprint of each 4-byte-element tensor, taken on its
    device: the sum of its words as int32, and their sum weighted by
    position (mod 65521, plus 1)."""
    out = []
    for t in tensors:
        w = t.detach().contiguous().view(torch.int32).reshape(-1).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append([int(w.sum()), int((w * pos).sum())])
    return out


def state_tensors(trainer, with_opt: bool) -> list[torch.Tensor]:
    params = list(trainer.state.params.parameters())
    if not with_opt:
        return params
    opt = trainer.state.opt_state.state
    return params + [v for p in params for _, v in sorted(opt[p].items())
                     if v.device == trainer.device]


def world_rank(rank: int, store: str, out: str) -> None:
    """(j), one rank of the job: the schedule with what one rank can see of
    it (losses, step times, launches, fingerprints, resize events), written
    as JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_elastic_world(
        rank, WORLD_RANKS, store, batch=B, seq=S,
        initial_world_size=WORLD_SCHEDULE[0])
    rec = dict(rank=rank, steps=[], resized=[])
    fa.reset_launches()
    for world in WORLD_SCHEDULE:
        if world != trainer.world_size:
            grow = world > trainer.world_size
            rec["resized"].append(trainer.resize(world))
            if grow:
                rec["after_grow"] = checksum(state_tensors(trainer, True))
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            params=(checksum(state_tensors(trainer, False))
                    if trainer.world_size > 1 else None)))

    def no_memory(*args, **kwargs):
        raise RuntimeError("planted: out of memory staging the resize")

    if rank == 1:
        elastic._fresh = no_memory
    rec["planted"] = trainer.resize(WORLD_RANKS)
    rec["planted_failed"] = trainer.resizes_failed
    before = dict(fa.launches)
    loss = trainer.step(batch)
    rec["after_planted"] = dict(
        world=trainer.world_size, loss=loss,
        launches={k: fa.launches[k] - before[k] for k in fa.launches})
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def run_ranks(target, phase: str, timeout_s: float, *args) -> list[dict]:
    """(j) and (k): spawn WORLD_RANKS processes of ``target(rank, store,
    out, *args)``, join them within ``timeout_s`` (killing any left), and
    return each rank's record, the JSON it wrote to ``out``."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(WORLD_RANKS)]
        procs = [ctx.Process(target=target,
                             args=(r, os.path.join(tmp, "store"), outs[r],
                                   *args))
                 for r in range(WORLD_RANKS)]
        try:
            for p in procs:
                p.start()
            end = time.monotonic() + timeout_s
            for p in procs:
                p.join(max(end - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0 or not os.path.exists(outs[r])]
        if bad:
            raise AssertionError(f"phase ({phase}): ranks (rank, exit code) "
                                 f"{bad} failed or ran past {timeout_s} s")
        recs = []
        for out in outs:
            with open(out) as f:
                recs.append(json.load(f))
    return recs


def world_control() -> list[float]:
    """(j) and (l)'s one-rank control: WORLD_SCHEDULE's steps of phase
    (c)'s trainer from the same init on the same batch, in this process."""
    torch.cuda.empty_cache()
    trainer, batch = flagship_trainer(B, S)
    control = [trainer.step(batch) for _ in WORLD_SCHEDULE]
    del trainer, batch
    torch.cuda.empty_cache()
    return control


def phase_world(card: str) -> dict:
    """(j): FLAGSHIP over two ranks sharing the card through 1→2→1, against
    a one-rank control; returns the launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(world_rank, "j", WORLD_CHILD_TIMEOUT_S)
    control = world_control()
    n = tfm.FLAGSHIP.n_layers
    per_step = {k: n for k in FLASH}
    r0, r1 = recs
    for rec in recs:
        for evt in rec["events"]:
            print(f"world rank {rec['rank']} resize_event {json.dumps(evt)}",
                  flush=True)
    for world in sorted(set(WORLD_SCHEDULE)):
        # rank 0 is live on every world and waits out the all-reduce, so
        # its step spans the world's; the first step on each world warms
        # a rank up (its first kernels, or its first all-reduce)
        ms = {rec["rank"]: [round(s["ms"], 2) for s in rec["steps"]
                            if s["world"] == world and s["live"]]
              for rec in recs}
        print(f"world {world} step_ms by rank {ms} median after the first "
              f"{float(np.median(ms[0][1:])):.2f} (b{B} s{S} global batch; "
              f"two ranks share one card: not a scaling figure) on {card}",
              flush=True)
    losses = [s["loss"] for s in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"world losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |world - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    failures = []
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["after_grow"] != r1["after_grow"]:
        failures.append("rank 1's state after resize(2) is not rank 0's")
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1 and (a["params"] != b["params"]
                               or a["loss"] != b["loss"]):
            failures.append(f"step {i}: the ranks' params or loss differ")
        for rank, st in enumerate((a, b)):
            want = per_step if st["live"] else {k: 0 for k in FLASH}
            if st["launches"] != want:
                failures.append(f"step {i} rank {rank}: launches "
                                f"{st['launches']}, want {want}")
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    for rank, rec in enumerate(recs):
        after = rec["after_planted"]
        live = rank < after["world"]
        want = per_step if live else {k: 0 for k in FLASH}
        if (rec["planted"] or rec["planted_failed"] != 1
                or after["world"] != 1 or after["launches"] != want
                or (after["loss"] is not None) != live):
            failures.append(f"rank {rank}: planted resize "
                            f"{rec['planted']}, resizes_failed "
                            f"{rec['planted_failed']}, then {after}")
    print(f"world planted failure on rank 1: resize -> "
          f"{[rec['planted'] for rec in recs]}, resizes_failed "
          f"{[rec['planted_failed'] for rec in recs]}, next step world "
          f"{r0['after_planted']['world']} loss "
          f"{r0['after_planted']['loss']:.6f}; bitwise state after grow "
          f"{r0['after_grow'] == r1['after_grow']}; launches "
          f"{[rec['launches'] for rec in recs]}", flush=True)
    if failures:
        raise AssertionError("phase (j): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (l): fsdp over two ranks sharing the card --------------------------


def split_leaves(trainer) -> set:
    """The leaves some axis of the live mesh splits."""
    return {n for n, spec in trainer.partition_specs().items()
            if any(e is not None and getattr(trainer.shape, e) > 1
                   for e in spec)}


def resting_state(trainer) -> dict:
    """(l) and (m): what this rank holds at rest: its blocks of the
    parameters and of Adam's moments (bytes summed, and each split leaf's
    share of its full bytes), what a replicated trainer's rank holds of the
    same leaves (each at its full shape), and what the caching allocator
    holds in this process."""
    opt = trainer.state.opt_state.state
    split, shapes = split_leaves(trainer), trainer.full_shapes()
    nbytes, replicated, shares = 0, 0, set()
    for name, shard in trainer.shards.items():
        for t in [shard] + [v for v in opt.get(shard, {}).values()
                            if v.shape == shard.shape]:
            full = math.prod(shapes[name]) * t.element_size()
            nbytes += t.nbytes
            replicated += full
            if name in split:
                shares.add(t.nbytes / full)
    return dict(state_bytes=nbytes, replicated_bytes=replicated,
                shares=sorted(shares),
                replicated=sorted(set(shapes) - split),
                allocated=torch.cuda.memory_allocated(trainer.device))


def fsdp_rank(rank: int, store: str, out: str) -> None:
    """(l), one rank of the job: WORLD_SCHEDULE on an fsdp trainer, with
    what one rank can see of it written as JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_elastic_world(
        rank, WORLD_RANKS, store, batch=B, seq=S,
        initial_world_size=WORLD_SCHEDULE[0], param_sharding="fsdp",
        spec=FSDP_SPEC)
    rec = dict(rank=rank, steps=[], resized=[], moved=[], kept=[])
    fa.reset_launches()
    for world in WORLD_SCHEDULE:
        if world != trainer.world_size:
            # rank 0, live on every world, fingerprints the whole params
            full = checksum(trainer.full_params().values())
            elastic.reset_census()
            rec["resized"].append(trainer.resize(world))
            rec["moved"].append(elastic.collective_census())
            after = checksum(trainer.full_params().values())
            rec["kept"].append(full == after if rank == 0 else None)
        before = dict(fa.launches)
        elastic.reset_census()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            census=elastic.collective_census()))
        if trainer.world_size == WORLD_RANKS and "rest" not in rec:
            torch.cuda.synchronize()
            rec["rest"] = resting_state(trainer)
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_fsdp(card: str) -> dict:
    """(l): FLAGSHIP with fsdp parameter sharding over two ranks sharing
    the card through 1→2→1, against a one-rank control; returns the
    launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(fsdp_rank, "l", WORLD_CHILD_TIMEOUT_S)
    control = world_control()
    n = tfm.FLAGSHIP.n_layers
    per_step = {k: n for k in FLASH}
    r0, r1 = recs
    failures = []
    for rec in recs:
        for evt, moved, kept in zip(rec["events"], rec["moved"],
                                    rec["kept"]):
            sent = sum(slot["bytes"] for label, slot in moved.items()
                       if label != "world")
            print(f"fsdp rank {rec['rank']} resize to {evt['shape']}: "
                  f"bytes_moved {evt['bytes_moved']} (plan; bytes_naive "
                  f"{evt['bytes_naive']}), broadcast {sent} bytes, "
                  f"reshard_ms {evt['reshard_ms']}, full params bitwise "
                  f"kept {kept}", flush=True)
            # the plan counts Adam's step count, which travels by value
            if kept is False or not 0 <= evt["bytes_moved"] - sent <= 4:
                failures.append(f"rank {rec['rank']} resize {evt}: "
                                f"broadcast {sent}, kept {kept}")
    for rec in recs:
        rest = rec["rest"]
        print(f"fsdp rank {rec['rank']} resting state on fsdp2: "
              f"{rest['state_bytes'] / 1e9:.4f} GB of params and Adam "
              f"moments (a replicated trainer's rank: "
              f"{rest['replicated_bytes'] / 1e9:.4f} GB), each "
              f"sharded leaf's share {rest['shares']}, replicated leaves "
              f"{rest['replicated']}, torch.cuda.memory_allocated "
              f"{rest['allocated'] / 1e9:.4f} GB on {card}", flush=True)
        if rest["shares"] != [0.5]:
            failures.append(f"rank {rec['rank']}: shares {rest['shares']}")
    for world in sorted(set(WORLD_SCHEDULE)):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"fsdp world {world} step_ms by rank {ms} median after the "
              f"first {float(np.median(ms[0][1:])):.2f} (b{B} s{S} global "
              f"batch; two ranks share one card: not a scaling figure) on "
              f"{card}", flush=True)
    census = next(st["census"] for st in r0["steps"]
                  if st["world"] == WORLD_RANKS)
    print(f"fsdp census of one fsdp2 step, rank 0 (gloo, handed the CUDA "
          f"tensors as they are): {json.dumps(census)}", flush=True)
    fops = census.get("fsdp", {}).get("ops", {})
    if fops.get("all-gather") != 1 or fops.get("reduce-scatter") != 1:
        failures.append(f"census {census}")
    losses = [st["loss"] for st in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"fsdp losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |fsdp - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["kept"] != [True, True]:
        failures.append(f"full params kept through the resizes "
                        f"{r0['kept']}")
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1 and a["loss"] != b["loss"]:
            failures.append(f"step {i}: the ranks' losses differ")
        for rank, st in enumerate((a, b)):
            want = per_step if st["live"] else {k: 0 for k in FLASH}
            if st["launches"] != want:
                failures.append(f"step {i} rank {rank}: launches "
                                f"{st['launches']}, want {want}")
    print(f"fsdp launches {[rec['launches'] for rec in recs]}", flush=True)
    if failures:
        raise AssertionError("phase (l): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (m): Megatron tp over two ranks sharing the card -------------------


def tp_rank(rank: int, store: str, out: str) -> None:
    """(m), one rank of the job: WORLD_SCHEDULE on a trainer laid out by
    FLAGSHIP's partition specs over tp, with what one rank can see of it
    written as JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_tp_world(
        rank, WORLD_RANKS, store, batch=B, seq=S,
        initial_world_size=WORLD_SCHEDULE[0])
    norms = [n for n, spec in trainer.partition_specs().items()
             if not any(spec)]
    rec = dict(rank=rank, steps=[], resized=[], moved=[], kept=[])
    fa.reset_launches()
    for world in WORLD_SCHEDULE:
        if world != trainer.world_size:
            # rank 0, live on every world, fingerprints the whole params
            full = checksum(trainer.full_params().values())
            elastic.reset_census()
            rec["resized"].append(trainer.resize(world))
            rec["moved"].append(elastic.collective_census())
            after = checksum(trainer.full_params().values())
            rec["kept"].append(full == after if rank == 0 else None)
        before = dict(fa.launches)
        elastic.reset_census()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            census=elastic.collective_census(),
            norms=(checksum(trainer.shards[n] for n in norms)
                   if trainer.world_size > 1 else None)))
        if trainer.world_size == WORLD_RANKS and "rest" not in rec:
            torch.cuda.synchronize()
            rec["rest"] = resting_state(trainer)
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_tp(card: str) -> dict:
    """(m): FLAGSHIP with Megatron tp over two ranks sharing the card
    through 1→2→1, against a one-rank control; returns the launches of
    both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(tp_rank, "m", WORLD_CHILD_TIMEOUT_S)
    control = world_control()
    n = tfm.FLAGSHIP.n_layers
    per_step = {k: n for k in FLASH}
    r0, r1 = recs
    failures = []
    for rec in recs:
        for evt, moved, kept in zip(rec["events"], rec["moved"],
                                    rec["kept"]):
            sent = sum(slot["bytes"] for label, slot in moved.items()
                       if label != "world")
            print(f"tp rank {rec['rank']} resize to {evt['shape']}: "
                  f"bytes_moved {evt['bytes_moved']} (plan; bytes_naive "
                  f"{evt['bytes_naive']}), broadcast {sent} bytes, "
                  f"reshard_ms {evt['reshard_ms']}, full params bitwise "
                  f"kept {kept}", flush=True)
            # the plan counts Adam's step count, which travels by value
            if kept is False or not 0 <= evt["bytes_moved"] - sent <= 4:
                failures.append(f"rank {rec['rank']} resize {evt}: "
                                f"broadcast {sent}, kept {kept}")
    for rec in recs:
        rest = rec["rest"]
        print(f"tp rank {rec['rank']} resting state on tp2: "
              f"{rest['state_bytes'] / 1e9:.4f} GB of params and Adam "
              f"moments (a replicated trainer's rank: "
              f"{rest['replicated_bytes'] / 1e9:.4f} GB), each split "
              f"leaf's share {rest['shares']}, whole leaves "
              f"{rest['replicated']}, torch.cuda.memory_allocated "
              f"{rest['allocated'] / 1e9:.4f} GB on {card}", flush=True)
        if rest["shares"] != [0.5]:
            failures.append(f"rank {rec['rank']}: shares {rest['shares']}")
    for world in sorted(set(WORLD_SCHEDULE)):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"tp world {world} step_ms by rank {ms} median after the "
              f"first {float(np.median(ms[0][1:])):.2f} (b{B} s{S} global "
              f"batch; two ranks share one card: not a scaling figure) on "
              f"{card}", flush=True)
    census = next(st["census"] for st in r0["steps"]
                  if st["world"] == WORLD_RANKS)
    reduces = census.get("tp", {}).get("ops", {}).get("all-reduce", 0)
    print(f"tp census of one tp2 step, rank 0 (gloo, handed the CUDA "
          f"tensors as they are): {reduces} tp all-reduces, "
          f"{json.dumps(census)}", flush=True)
    if set(census) != {"tp"} or set(census["tp"]["ops"]) != {"all-reduce"}:
        failures.append(f"census {census}")
    losses = [st["loss"] for st in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"tp losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |tp - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["kept"] != [True, True]:
        failures.append(f"full params kept through the resizes "
                        f"{r0['kept']}")
    equal = []
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1:
            equal.append(a["norms"] == b["norms"])
            if a["loss"] != b["loss"] or a["norms"] != b["norms"]:
                failures.append(f"step {i}: the ranks' losses or norms "
                                "differ")
        for rank, st in enumerate((a, b)):
            want = per_step if st["live"] else {k: 0 for k in FLASH}
            if st["launches"] != want:
                failures.append(f"step {i} rank {rank}: launches "
                                f"{st['launches']}, want {want}")
    print(f"tp norms bitwise equal across the ranks after each world-2 "
          f"step: {equal}; launches {[rec['launches'] for rec in recs]}",
          flush=True)
    if failures:
        raise AssertionError("phase (m): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


def phase_dryrun() -> None:
    """(n): the sharded dryrun on the card at each of DRYRUN_SIZES; each
    raises on a failed check and prints its DRYRUN_COMM line."""
    for n in DRYRUN_SIZES:
        t0 = time.perf_counter()
        rec = dryrun_multichip(n)
        print(f"dryrun_multichip({n}) ok on the card in "
              f"{time.perf_counter() - t0:.1f} s: mesh {rec['mesh']}, "
              f"{rec['param_bytes_per_device_max']} of "
              f"{rec['param_bytes_total']} param bytes a rank", flush=True)


# -- phase (k): the durable virtual-worker loop -------------------------------


def virtual_world(step: int) -> int:
    """(k)'s schedule: world 1 for steps 0-2, 2 for steps 3-8, 1 after."""
    return 2 if 3 <= step < VIRTUAL_KILL_AFTER else 1


def instrument(trainer, steps: list, watchdog=None) -> None:
    """Record every ``step_accumulate`` of ``trainer`` into ``steps``: its
    world, whether this rank was live, its loss, its host ms between two
    ``synchronize()``s and its flash launches; then beat ``watchdog``
    (armed by its first beat, so it watches only this trainer's loop)."""
    real = trainer.step_accumulate

    def timed(micro, **kw):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real(micro, **kw)
        torch.cuda.synchronize()
        steps.append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in FLASH}))
        if watchdog is not None:
            watchdog.beat()
        return loss

    trainer.step_accumulate = timed


def rows_once(reports) -> dict:
    """The exactly-once ledger of several runs of one job, merged."""
    rows: dict[int, int] = {}
    for rep in reports:
        for gid, c in rep.rows_trained.items():
            rows[gid] = rows.get(gid, 0) + c
    want = VIRTUAL_STEPS * B
    return dict(duplicated=sum(c - 1 for c in rows.values() if c > 1),
                missing=want - len(rows), trained=sum(rows.values()))


def step_files(store: str, step: int) -> list[str]:
    root = os.path.join(store, str(step))
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


def checkpoint_drills(trainer, store: str) -> dict:
    """(k), rank 0 after the restored run: the newest step torn and a fresh
    checkpointer's fallback, then one synchronous and one async save of the
    FLAGSHIP state timed, with the fold and the CRC of a save timed
    alone."""
    tree = {"params": trainer.state.params, "opt": trainer.state.opt_state}
    got = {}
    newest = max(int(p) for p in os.listdir(store) if p.isdigit())
    victim = max(step_files(store, newest), key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    counters = get_counters()
    before = (counters.get("checkpoint_corruption_detected"),
              counters.get("recoveries_completed", type="corrupt_checkpoint"))
    fresh = ElasticCheckpointer(store)
    t0 = time.perf_counter()
    fresh.restore(tree)
    torch.cuda.synchronize()
    got.update(
        torn=newest, fallback=fresh.last_restored_step,
        fallback_ms=1e3 * (time.perf_counter() - t0),
        hash_ok=fresh.last_restore_hash_ok,
        corruption=counters.get("checkpoint_corruption_detected") - before[0],
        recoveries=counters.get("recoveries_completed",
                                type="corrupt_checkpoint") - before[1])

    pause_dir = store + "-pause"
    ck = ElasticCheckpointer(pause_dir, max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, tree)
    got["save_ms"] = 1e3 * (time.perf_counter() - t0)
    got["file_bytes"] = sum(os.path.getsize(f)
                            for f in step_files(pause_dir, 1))
    got["state_bytes"] = sum(t.numel() * t.element_size()
                             for t in state_tensors(trainer, True))
    t0 = time.perf_counter()
    ElasticCheckpointer._tree_folds(tree)
    got["fold_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ckpt._fingerprint_tree(os.path.join(pause_dir, "1"))
    got["crc_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got["pause_ms"] = 1e3 * ck.save_async(2, tree)
    ck.wait_pending()
    got["persist_ms"] = 1e3 * (time.perf_counter() - t0)
    ck.finalize()
    got["async_verified"] = ck.latest_verified_step()
    shutil.rmtree(pause_dir)
    return got


def virtual_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(k), one rank of the job: the replicated run through 1→2 with its
    kill mid-accumulation, the restore on fresh trainers and the run's end
    through 2→1; on rank 0 the checkpoint drills; then the dp-mode run.
    Each of the three trainers' loops has its own stall watchdog, stopped
    when the loop ends, so that the restore, the drills and the rebuilds
    between the loops are not watched.  What the rank saw is written as
    JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    watchdogs: list[StallWatchdog] = []

    def watched(trainer, steps: list) -> None:
        watchdogs.append(StallWatchdog(
            floor_s=VIRTUAL_STALL_FLOOR_S,
            scope=f"virtual-rank{rank}-loop{len(watchdogs)}").start())
        instrument(trainer, steps, watchdogs[-1])

    rec = dict(rank=rank, steps=[], dp_steps=[])
    fa.reset_launches()
    trainer, reg, ids, cfg = flagship_virtual_world(
        rank, WORLD_RANKS, store, initial_world_size=virtual_world(0))
    watched(trainer, rec["steps"])
    batches = VirtualBatches(cfg, ids, reg.get)
    first = VirtualWorkerLoop(
        trainer, cfg, batches, checkpointer=ElasticCheckpointer(ckpt_dir),
        ckpt_every=VIRTUAL_CKPT_EVERY).run(max_steps=VIRTUAL_KILL_AFTER,
                                           world_size_for=virtual_world)
    before = dict(fa.launches)
    rec["kill_world"] = trainer.world_size
    try:
        trainer.step_accumulate(batches.next_step(), abort_after=3)
        rec["killed"] = False
    except AccumulationAborted:
        rec["killed"] = True
    watchdogs[-1].stop()
    rec["kill_launches"] = {k: fa.launches[k] - before[k] for k in FLASH}
    del trainer, batches
    torch.cuda.empty_cache()

    trainer, reg, ids, cfg = flagship_virtual_world(
        rank, WORLD_RANKS, store, initial_world_size=WORLD_RANKS)
    loop = VirtualWorkerLoop(
        trainer, cfg, VirtualBatches(cfg, ids, reg.get),
        checkpointer=ElasticCheckpointer(ckpt_dir),
        ckpt_every=VIRTUAL_CKPT_EVERY)
    t0 = time.perf_counter()
    rec["restored"] = loop.restore_latest()
    torch.cuda.synchronize()
    rec["restore_ms"] = 1e3 * (time.perf_counter() - t0)
    watched(trainer, rec["steps"])
    second = loop.run(max_steps=VIRTUAL_STEPS - VIRTUAL_KILL_AFTER,
                      world_size_for=virtual_world)
    watchdogs[-1].stop()
    rec.update(losses=first.losses + second.losses,
               resizes=[first.resizes, second.resizes],
               rows=rows_once([first, second]))
    if rank == 0:
        rec["drills"] = checkpoint_drills(trainer, ckpt_dir)
    torch.distributed.barrier()
    del loop, trainer
    torch.cuda.empty_cache()

    trainer, reg, ids, cfg = flagship_virtual_world(
        rank, WORLD_RANKS, store, accum_mode="dp",
        initial_world_size=virtual_world(0))
    watched(trainer, rec["dp_steps"])
    dp = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get)
                           ).run(max_steps=VIRTUAL_STEPS,
                                 world_size_for=virtual_world)
    watchdogs[-1].stop()
    rec.update(dp_losses=dp.losses, dp_rows=rows_once([dp]),
               stalls=sum(w.stalls_detected for w in watchdogs),
               launches=dict(fa.launches))
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_virtual(card: str) -> dict:
    """(k): the durable virtual-worker loop on two ranks sharing the card,
    against a one-process control; returns the launches of the ranks and
    the control summed, the control's losses and rank 0's checkpoint
    drills."""
    torch.cuda.empty_cache()
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        recs = run_ranks(virtual_rank, "k", VIRTUAL_CHILD_TIMEOUT_S,
                         os.path.join(tmp, "ckpt"))
    torch.cuda.empty_cache()
    trainer, reg, ids, cfg = flagship_virtual_world(0, 1, None)
    assert cfg.micro_batch == VIRTUAL_MICRO_BATCH, cfg
    steps: list = []
    instrument(trainer, steps)
    control = VirtualWorkerLoop(trainer, cfg, VirtualBatches(
        cfg, ids, reg.get)).run(max_steps=VIRTUAL_STEPS).losses
    control_launches = dict(fa.launches)
    del trainer
    torch.cuda.empty_cache()
    r0, r1 = recs
    d = r0["drills"]
    print(f"virtual phase (k): FLAGSHIP, V {cfg.vw_count}, global batch "
          f"{cfg.global_batch} x {S}, two ranks sharing the card over gloo, "
          f"on {card}", flush=True)
    per_world = {}
    for st in r0["steps"]:
        per_world.setdefault(st["world"], []).append(round(st["ms"], 2))
    per_world["control"] = [round(st["ms"], 2) for st in steps]
    for world, ms in per_world.items():
        print(f"virtual step_ms world {world} rank 0 {ms} median "
              f"{float(np.median(ms)):.2f} on {card}", flush=True)
    bitwise = r0["losses"] == control
    div = loss_divergence(control, r0["dp_losses"])
    print(f"virtual losses {r0['losses']} control {control} bitwise "
          f"{bitwise}; rows duplicated {r0['rows']['duplicated']} missing "
          f"{r0['rows']['missing']} of {VIRTUAL_STEPS * cfg.global_batch}; "
          f"resizes {r0['resizes']}; restored step {r0['restored']}",
          flush=True)
    print(f"virtual dp losses {r0['dp_losses']} max |dp - control| "
          f"{div['max_loss_divergence']:.3e} equivalent "
          f"{trajectories_equivalent(control, r0['dp_losses'])} (atol "
          f"{DEFAULT_LOSS_ATOL}, rtol {DEFAULT_LOSS_RTOL})", flush=True)
    gbps = d["file_bytes"] / d["save_ms"] / 1e6
    print(f"checkpoint save_ms {d['save_ms']:.2f} bytes {d['file_bytes']} "
          f"(state {d['state_bytes']}) GB/s {gbps:.3f} fold_ms "
          f"{d['fold_ms']:.2f} crc_ms {d['crc_ms']:.2f} on {card}",
          flush=True)
    print(f"save_async pause_ms {d['pause_ms']:.2f} persist_ms "
          f"{d['persist_ms']:.2f} on {card}", flush=True)
    print(f"restore_ms {r0['restore_ms']:.2f} (rank 0, step "
          f"{r0['restored']}) {r1['restore_ms']:.2f} (rank 1); restore "
          f"fallback {d['torn']} -> {d['fallback']} in "
          f"{d['fallback_ms']:.2f} ms, checkpoint_corruption_detected "
          f"+{d['corruption']}, recoveries_completed{{type="
          f"corrupt_checkpoint}} +{d['recoveries']}, last_restore_hash_ok "
          f"{d['hash_ok']}", flush=True)
    print(f"virtual stalls_detected {[rec['stalls'] for rec in recs]} "
          f"(floor {VIRTUAL_STALL_FLOOR_S} s)", flush=True)
    failures = []
    n = tfm.FLAGSHIP.n_layers * cfg.vw_count
    for rec in recs:
        got = sorted({(st["live"], tuple(st["launches"].values()))
                      for st in rec["steps"]})
        print(f"virtual launches rank {rec['rank']}: (live, per step) "
              f"{got}; kill {rec['kill_launches']}; total "
              f"{rec['launches']}", flush=True)
        for st in rec["steps"]:
            want = n if st["live"] else 0
            if set(st["launches"].values()) != {want}:
                failures.append(f"rank {rec['rank']} launches {st}")
        if not rec["killed"] or rec["kill_world"] != 2:
            failures.append(f"rank {rec['rank']}: kill {rec['killed']} on "
                            f"world {rec['kill_world']}")
        if rec["restored"] != VIRTUAL_KILL_AFTER:
            failures.append(f"rank {rec['rank']} restored {rec['restored']}")
        if rec["stalls"]:
            failures.append(f"rank {rec['rank']} stalls {rec['stalls']}")
    if not bitwise or not all(np.isfinite(control)):
        failures.append(f"losses {r0['losses']} vs control {control}")
    if r0["rows"]["duplicated"] or r0["rows"]["missing"]:
        failures.append(f"rows {r0['rows']}")
    if r0["resizes"] != [1, 1]:
        failures.append(f"resizes {r0['resizes']}")
    if (not trajectories_equivalent(control, r0["dp_losses"])
            or r0["dp_rows"]["duplicated"] or r0["dp_rows"]["missing"]):
        failures.append(f"dp {r0['dp_losses']} rows {r0['dp_rows']}")
    if (d["torn"], d["fallback"], d["corruption"], d["recoveries"],
            d["hash_ok"]) != (VIRTUAL_STEPS, VIRTUAL_KILL_AFTER, 1, 1, True):
        failures.append(f"torn step drill {d}")
    if d["async_verified"] != 2:
        failures.append(f"save_async not verified: {d['async_verified']}")
    if control_launches != {k: n * VIRTUAL_STEPS for k in FLASH}:
        failures.append(f"control launches {control_launches}")
    if failures:
        raise AssertionError("phase (k): " + "; ".join(failures))
    return dict(launches={k: control_launches[k] + sum(
        rec["launches"][k] for rec in recs) for k in FLASH},
        control=control, drills=d)


# -- phase (o): the sharded lineage -------------------------------------------


def trainer_tree(trainer) -> dict:
    return {"params": trainer.state.params, "opt": trainer.state.opt_state}


def state_digest(trainer):
    """{checkpoint path: checksum} of the trainer's whole state, each leaf
    summed on the card (collective over the live group): rank 0's, None
    on the other ranks."""
    tree = type(trainer).whole_state(trainer)
    if tree is None:
        return None
    return {k: checksum([torch.as_tensor(v).to("cuda")])[0]
            for k, v in sorted(ckpt._flatten(tree).items())}


def instrument_gather(trainer, record: list) -> None:
    """Record every ``whole_state`` of ``trainer`` (a save's gather) into
    ``record``: its step and world, its host ms between two
    ``synchronize()``s, the bytes and all-gathers of its census label, and
    ``memory_allocated`` before it and at its peak."""
    from edl_tpu_torch.runtime import elastic

    real = trainer.whole_state

    def timed():
        torch.cuda.synchronize()
        elastic.reset_census()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tree = real()
        torch.cuda.synchronize()
        slot = elastic.collective_census().get(
            elastic.CHECKPOINT_LABEL, {"ops": {}, "bytes": 0})
        record.append(dict(
            step=trainer.state.step, world=trainer.world_size,
            ms=1e3 * (time.perf_counter() - t0), bytes=slot["bytes"],
            gathers=slot["ops"].get("all-gather", 0), allocated=base,
            peak=torch.cuda.max_memory_allocated()))
        return tree

    trainer.whole_state = timed


def instrument_saves(ck, record: list) -> None:
    """Record every ``save`` of ``ck`` (rank 0's) into ``record``: its step,
    its host ms (the gather included) and the bytes it wrote."""
    real = ck.save

    def timed(step, tree, **kw):
        t0 = time.perf_counter()
        ok = real(step, tree, **kw)
        record.append(dict(step=step, ms=1e3 * (time.perf_counter() - t0),
                           bytes=sum(os.path.getsize(f) for f in
                                     step_files(str(ck.directory), step))))
        return ok

    ck.save = timed


def tear_copy(directory: str, copy: str) -> int:
    """``copy``: the lineage at ``directory`` as hard links, with its newest
    step's largest file replaced by the first half of its bytes (the
    lineage itself untouched); returns that step."""
    shutil.copytree(directory, copy, copy_function=os.link)
    newest = max(int(p) for p in os.listdir(copy) if p.isdigit())
    victim = max(step_files(copy, newest), key=os.path.getsize)
    with open(victim, "rb") as src, open(victim + ".torn", "wb") as dst:
        dst.write(src.read(os.path.getsize(victim) // 2))
    os.replace(victim + ".torn", victim)
    return newest


def forge_step(directory: str, step: int, forged: int) -> None:
    """Step ``forged`` of the lineage: ``step``'s files (hard links) under
    ``step``'s manifest with the fold of ``['params']['embed']`` changed,
    so its files verify and its leaves do not."""
    shutil.copytree(os.path.join(directory, str(step)),
                    os.path.join(directory, str(forged)),
                    copy_function=os.link)
    mdir = os.path.join(directory, ".integrity")
    with open(os.path.join(mdir, f"{step}.json")) as f:
        manifest = json.load(f)
    key = "['params']['embed']"
    manifest["step"] = forged
    manifest["leaves"][key] = f"{int(manifest['leaves'][key], 16) ^ 1:016x}"
    with open(os.path.join(mdir, f"{forged}.json"), "w") as f:
        json.dump(manifest, f)


def durable_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(o-1), one rank of the fsdp job: (k)'s schedule with its kill and
    restore, each save's gather and rank 0's saves recorded, one sharded
    ``save_async`` after step 9, the final state's digest, and a torn
    newest step restored on both ranks; written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[], gathers=[], saves=[])
    fa.reset_launches()

    def job(n0: int):
        trainer, reg, ids, cfg = flagship_virtual_world(
            rank, WORLD_RANKS, store, initial_world_size=n0,
            param_sharding="fsdp", spec=FSDP_SPEC)
        instrument(trainer, rec["steps"])
        instrument_gather(trainer, rec["gathers"])
        ck = ElasticCheckpointer(ckpt_dir)
        instrument_saves(ck, rec["saves"])
        return trainer, cfg, VirtualBatches(cfg, ids, reg.get), ck

    trainer, cfg, batches, ck = job(virtual_world(0))
    first = VirtualWorkerLoop(trainer, cfg, batches, checkpointer=ck,
                              ckpt_every=VIRTUAL_CKPT_EVERY).run(
        max_steps=VIRTUAL_KILL_AFTER, world_size_for=virtual_world)
    if rank == 0:
        pause_dir = ckpt_dir + "-pause"
        pk = ElasticCheckpointer(pause_dir, max_to_keep=1)
        t0 = time.perf_counter()
        rec["pause_ms"] = 1e3 * pk.save_async(VIRTUAL_KILL_AFTER,
                                              trainer.whole_state)
        pk.wait_pending()
        rec["persist_ms"] = 1e3 * (time.perf_counter() - t0)
        pk.finalize()
        rec["async_verified"] = pk.latest_verified_step()
        rec["async_same_print"] = (
            pk.manifest(VIRTUAL_KILL_AFTER)["tree_hash"]
            == ck.manifest(VIRTUAL_KILL_AFTER)["tree_hash"])
        shutil.rmtree(pause_dir)
    else:
        trainer.whole_state()
    before = dict(fa.launches)
    rec["kill_world"] = trainer.world_size
    try:
        trainer.step_accumulate(batches.next_step(), abort_after=3)
        rec["killed"] = False
    except AccumulationAborted:
        rec["killed"] = True
    rec["kill_launches"] = {k: fa.launches[k] - before[k] for k in FLASH}
    del trainer, batches
    torch.cuda.empty_cache()

    trainer, cfg, batches, ck = job(WORLD_RANKS)
    loop = VirtualWorkerLoop(trainer, cfg, batches, checkpointer=ck,
                             ckpt_every=VIRTUAL_CKPT_EVERY)
    t0 = time.perf_counter()
    rec["restored"] = loop.restore_latest()
    torch.cuda.synchronize()
    rec["restore_ms"] = 1e3 * (time.perf_counter() - t0)
    second = loop.run(max_steps=VIRTUAL_STEPS - VIRTUAL_KILL_AFTER,
                      world_size_for=virtual_world)
    rec.update(losses=first.losses + second.losses,
               resizes=[first.resizes, second.resizes],
               rows=rows_once([first, second]), final=state_digest(trainer),
               launches=dict(fa.launches))

    torch.distributed.barrier()
    drill = ckpt_dir + "-torn"
    if rank == 0:
        rec["torn"] = tear_copy(ckpt_dir, drill)
    torch.distributed.barrier()
    counters = get_counters()
    c0 = (counters.get("checkpoint_corruption_detected"),
          counters.get("recoveries_completed", type="corrupt_checkpoint"))
    fresh = ElasticCheckpointer(drill)
    t0 = time.perf_counter()
    fresh.restore(trainer_tree(trainer), shardings=trainer)
    torch.cuda.synchronize()
    rec["drill"] = dict(
        fallback=fresh.last_restored_step, hash_ok=fresh.last_restore_hash_ok,
        ms=1e3 * (time.perf_counter() - t0),
        corruption=counters.get("checkpoint_corruption_detected") - c0[0],
        recoveries=counters.get("recoveries_completed",
                                type="corrupt_checkpoint") - c0[1])
    torch.distributed.barrier()
    if rank == 0:
        shutil.rmtree(drill)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def tp_restore_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(o-2), one rank of a tp-2 trainer laid out by FLAGSHIP's partition
    specs: the lineage's newest step restored, its digest, and step 13;
    written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[])
    trainer, reg, ids, cfg = flagship_virtual_world(
        rank, WORLD_RANKS, store, initial_world_size=WORLD_RANKS,
        param_sharding=tfm.param_partition_specs(tfm.FLAGSHIP),
        spec=TP_SPEC)
    fa.reset_launches()
    loop = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                             checkpointer=ElasticCheckpointer(ckpt_dir))
    t0 = time.perf_counter()
    rec["restored"] = loop.restore_latest()
    torch.cuda.synchronize()
    rec.update(restore_ms=1e3 * (time.perf_counter() - t0),
               state_step=trainer.state.step, digest=state_digest(trainer))
    instrument(trainer, rec["steps"])
    rec["losses"] = loop.run(max_steps=1).losses
    rec["launches"] = dict(fa.launches)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def decode_all(fleet, prompts: list, new_tokens: int) -> list:
    sessions = [fleet.submit(p, max_new_tokens=new_tokens) for p in prompts]
    return [s.wait(600) for s in sessions]


def keep_decoding(fleet, rng, sessions: list,
                  stop: threading.Event) -> threading.Thread:
    """A thread that keeps WATCH_SESSIONS sessions in flight on ``fleet``
    until ``stop``, each appended to ``sessions`` when submitted."""
    def feed():
        while not stop.is_set():
            if fleet.sessions_active() < WATCH_SESSIONS:
                sessions.append(fleet.submit(rng.integers(
                    1, tfm.FLAGSHIP.vocab_size, WATCH_PROMPT_LEN).tolist(),
                    max_new_tokens=WATCH_NEW_TOKENS))
            else:
                time.sleep(0.01)

    thread = threading.Thread(target=feed, name="lineage-feed", daemon=True)
    thread.start()
    return thread


def phase_durable(card: str, control: list, k_drills: dict) -> dict:
    """(o): the sharded lineage: the fsdp job on two ranks sharing the
    card, its newest step restored into a tp-2 and a world-1 trainer, and
    a FLAGSHIP decode fleet reloading the lineage; returns the launches of
    the fsdp job and of the restored trainers' step."""
    torch.cuda.empty_cache()
    fa.reset_launches()
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        lineage_dir = os.path.join(tmp, "lineage")
        recs = run_ranks(durable_rank, "o-1", VIRTUAL_CHILD_TIMEOUT_S,
                         lineage_dir)
        tp_recs = run_ranks(tp_restore_rank, "o-2", VIRTUAL_CHILD_TIMEOUT_S,
                            lineage_dir)
        torch.cuda.empty_cache()

        # (o-2) in this process: a world-1 replicated trainer
        trainer, reg, ids, cfg = flagship_virtual_world(0, 1, None)
        lineage = ElasticCheckpointer(lineage_dir)
        loop = VirtualWorkerLoop(trainer, cfg,
                                 VirtualBatches(cfg, ids, reg.get),
                                 checkpointer=lineage, ckpt_every=1)
        t0 = time.perf_counter()
        w1 = dict(restored=loop.restore_latest())
        torch.cuda.synchronize()
        w1.update(restore_ms=1e3 * (time.perf_counter() - t0),
                  state_step=trainer.state.step,
                  digest=state_digest(trainer))
        again = ElasticCheckpointer(os.path.join(tmp, "world1"))
        t0 = time.perf_counter()
        again.save(w1["restored"], trainer.whole_state)
        w1["save_ms"] = 1e3 * (time.perf_counter() - t0)
        w1["same_print"] = (again.manifest(w1["restored"])["tree_hash"]
                            == lineage.manifest(w1["restored"])["tree_hash"])
        shutil.rmtree(again.directory)

        # (o-3): a fleet from seed-0 weights reloads the lineage
        fleet = flagship_decode_fleet(job="lineage")
        t0 = time.perf_counter()
        sv = dict(reloaded=fleet.reload_from_lineage(
            ElasticCheckpointer(lineage_dir)))
        sv.update(reload_ms=1e3 * (time.perf_counter() - t0),
                  generation=fleet.generation)
        prompts = [rng.integers(1, tfm.FLAGSHIP.vocab_size, n).tolist()
                   for n in LINEAGE_PROMPT_LENS]
        sv["tokens"] = decode_all(fleet, prompts, LINEAGE_NEW_TOKENS)
        weights = lineage.restore({"params": llama.param_template(
            tfm.FLAGSHIP)}, step=sv["reloaded"])["params"]
        fresh = flagship_decode_fleet(params=weights, job="lineage-fresh")
        del weights
        sv["fresh_tokens"] = decode_all(fresh, prompts, LINEAGE_NEW_TOKENS)
        fresh.stop()
        del fresh
        torch.cuda.empty_cache()

        # the world-1 trainer takes step 13 and saves it while sessions
        # decode on the watched fleet
        watcher = fleet.watch_lineage(ElasticCheckpointer(lineage_dir),
                                      poll_s=LINEAGE_POLL_S)
        sessions: list = []
        stop = threading.Event()
        feeder = keep_decoding(fleet, rng, sessions, stop)
        while len(sessions) < WATCH_SESSIONS:
            time.sleep(0.01)
        for sess in sessions[:WATCH_SESSIONS]:
            sess.wait_first_token(600)
        w1_steps: list = []
        instrument(trainer, w1_steps)
        before = dict(fa.launches)
        t0 = time.perf_counter()
        w1["losses"] = loop.run(max_steps=1).losses
        sv["step_and_save_ms"] = 1e3 * (time.perf_counter() - t0)
        w1["launches"] = {k: fa.launches[k] - before[k] for k in FLASH}
        newer = trainer.state.step
        t0 = time.perf_counter()
        while (fleet.generation != newer
               and time.perf_counter() - t0 < 4 * LINEAGE_PICKUP_S):
            time.sleep(0.01)
        sv.update(pickup_s=time.perf_counter() - t0,
                  watched=fleet.generation, newer=newer,
                  active_at_pickup=fleet.sessions_active())
        stop.set()
        feeder.join()
        sv["watch_tokens"] = sorted({len(sess.wait(600))
                                     for sess in sessions})
        sv.update(watch_sessions=len(sessions),
                  failed=fleet.sessions_failed)
        watcher.stop()
        forge_step(lineage_dir, newer, newer + 1)
        skipped = get_counters().get("serving_reload_skipped_unverified")
        sv["forged"] = fleet.reload_from_lineage(
            ElasticCheckpointer(lineage_dir))
        sv.update(forged_skipped=get_counters().get(
            "serving_reload_skipped_unverified") - skipped,
            after_forged=fleet.generation)
        fleet.stop()
        del fleet, trainer, loop
        torch.cuda.empty_cache()

    r0, r1 = recs
    failures = []
    n = tfm.FLAGSHIP.n_layers * cfg.vw_count
    print(f"lineage phase (o): FLAGSHIP, V {cfg.vw_count}, global batch "
          f"{cfg.global_batch} x {S}, fsdp 2 on two ranks sharing the card "
          f"over gloo, on {card}", flush=True)
    bitwise = r0["losses"] == control
    print(f"lineage fsdp losses {r0['losses']} bitwise (k)'s control "
          f"{bitwise}; rows duplicated {r0['rows']['duplicated']} missing "
          f"{r0['rows']['missing']} of {VIRTUAL_STEPS * cfg.global_batch}; "
          f"resizes {r0['resizes']}; restored step {r0['restored']}",
          flush=True)
    for rec in recs:
        for g in rec["gathers"]:
            print(f"lineage gather rank {rec['rank']} step {g['step']} world "
                  f"{g['world']}: {g['gathers']} all-gathers of "
                  f"{g['bytes']} bytes (census 'checkpoint') in "
                  f"{g['ms']:.2f} ms, memory_allocated "
                  f"{g['allocated'] / 1e9:.4f} GB before, peak "
                  f"{g['peak'] / 1e9:.4f} GB during, on {card}", flush=True)
    kgbps = k_drills["file_bytes"] / k_drills["save_ms"] / 1e6
    for sv_ in r0["saves"]:
        print(f"lineage save step {sv_['step']}: save_ms {sv_['ms']:.2f} "
              f"(gather included) bytes {sv_['bytes']} GB/s "
              f"{sv_['bytes'] / sv_['ms'] / 1e6:.3f}; (k)'s replicated "
              f"save_ms {k_drills['save_ms']:.2f} GB/s {kgbps:.3f} on {card}",
              flush=True)
    print(f"lineage save_async pause_ms {r0['pause_ms']:.2f} (gather "
          f"included) persist_ms {r0['persist_ms']:.2f}; (k)'s replicated "
          f"pause_ms {k_drills['pause_ms']:.2f} persist_ms "
          f"{k_drills['persist_ms']:.2f} on {card}", flush=True)
    print(f"lineage restore_ms fsdp2 {r0['restore_ms']:.2f} (rank 0) "
          f"{r1['restore_ms']:.2f} (rank 1); tp2 "
          f"{tp_recs[0]['restore_ms']:.2f} {tp_recs[1]['restore_ms']:.2f}; "
          f"world1 {w1['restore_ms']:.2f}; "
          f"torn {r0.get('torn')} -> {[r['drill']['fallback'] for r in recs]} "
          f"in {[round(r['drill']['ms'], 2) for r in recs]} ms on {card}",
          flush=True)
    for rec in recs:
        got = sorted({(st["live"], tuple(st["launches"].values()))
                      for st in rec["steps"]})
        print(f"lineage launches rank {rec['rank']}: (live, per step) {got}; "
              f"kill {rec['kill_launches']}; total {rec['launches']}",
              flush=True)
        for st in rec["steps"]:
            want = n if st["live"] else 0
            if set(st["launches"].values()) != {want}:
                failures.append(f"rank {rec['rank']} launches {st}")
        if not rec["killed"] or rec["kill_world"] != 2:
            failures.append(f"rank {rec['rank']}: kill {rec['killed']} on "
                            f"world {rec['kill_world']}")
        if rec["restored"] != VIRTUAL_KILL_AFTER:
            failures.append(f"rank {rec['rank']} restored {rec['restored']}")
        d = rec["drill"]
        drill = (d["fallback"], d["corruption"], d["recoveries"],
                 d["hash_ok"])
        if drill != (VIRTUAL_KILL_AFTER, 1, 1, True):
            failures.append(f"rank {rec['rank']} torn drill {d}")
    if not bitwise:
        failures.append(f"fsdp losses {r0['losses']} vs control {control}")
    if r0["rows"]["duplicated"] or r0["rows"]["missing"]:
        failures.append(f"rows {r0['rows']}")
    if r0["torn"] != VIRTUAL_STEPS:
        failures.append(f"tore step {r0['torn']}")
    if not any(g["world"] == WORLD_RANKS and g["gathers"]
               for g in r0["gathers"]):
        failures.append("no save gathered over fsdp 2")
    if (r0["async_verified"], r0["async_same_print"]) != (
            VIRTUAL_KILL_AFTER, True):
        failures.append(f"save_async {r0['async_verified']} fingerprint "
                        f"equal {r0['async_same_print']}")

    final = r0["final"]
    tp_loss, w1_loss = tp_recs[0]["losses"], w1["losses"]
    print(f"lineage restored into tp2 (step {tp_recs[0]['restored']}, "
          f"counter {tp_recs[0]['state_step']}) bitwise the fsdp job's "
          f"final state {tp_recs[0]['digest'] == final}; into world1 (step "
          f"{w1['restored']}, counter {w1['state_step']}) "
          f"{w1['digest'] == final}; world1 save of it in "
          f"{w1['save_ms']:.2f} ms, manifest fingerprint the fsdp run's "
          f"{w1['same_print']}; step 13 losses tp2 {tp_loss} world1 "
          f"{w1_loss} (limit {WORLD_LOSS_ATOL})", flush=True)
    for rec in tp_recs:
        if (rec["restored"], rec["state_step"]) != (VIRTUAL_STEPS,) * 2:
            failures.append(f"tp rank {rec['rank']} restored "
                            f"{rec['restored']} at {rec['state_step']}")
        for st in rec["steps"]:
            if set(st["launches"].values()) != {n}:
                failures.append(f"tp rank {rec['rank']} launches {st}")
    if tp_recs[0]["digest"] != final or w1["digest"] != final:
        failures.append("a restored state differs from the fsdp job's")
    if (w1["restored"], w1["state_step"]) != (VIRTUAL_STEPS,) * 2:
        failures.append(f"world1 restored {w1['restored']} at "
                        f"{w1['state_step']}")
    if not w1["same_print"]:
        failures.append("the world-1 save's fingerprint differs")
    if (len(tp_loss) != 1 or len(w1_loss) != 1
            or abs(tp_loss[0] - w1_loss[0]) > WORLD_LOSS_ATOL):
        failures.append(f"step 13 losses tp {tp_loss} world1 {w1_loss}")
    if set(w1["launches"].values()) != {n}:
        failures.append(f"world1 launches {w1['launches']}")

    equal = sv["tokens"] == sv["fresh_tokens"]
    print(f"lineage fleet reload_from_lineage -> {sv['reloaded']} "
          f"(generation {sv['generation']}) in {sv['reload_ms']:.2f} ms; "
          f"{len(prompts)} prompts of {list(LINEAGE_PROMPT_LENS)} tokens, "
          f"{LINEAGE_NEW_TOKENS} new, token-equal to a fresh fleet on the "
          f"restored weights {equal}; watch_lineage(poll_s="
          f"{LINEAGE_POLL_S}) shipped step {sv['watched']} (saved "
          f"{sv['newer']}) {sv['pickup_s']:.3f} s after the save, "
          f"{sv['active_at_pickup']} sessions decoding then, "
          f"{sv['watch_sessions']} sessions through the step and the save "
          f"with {sv['watch_tokens']} tokens each, sessions failed "
          f"{sv['failed']}; forged "
          f"step {sv['newer'] + 1} -> {sv['forged']}, "
          f"serving_reload_skipped_unverified +{sv['forged_skipped']}, "
          f"generation {sv['after_forged']} on {card}", flush=True)
    if (sv["reloaded"], sv["generation"]) != (VIRTUAL_STEPS,) * 2:
        failures.append(f"reload {sv['reloaded']} generation "
                        f"{sv['generation']}")
    if not equal:
        failures.append(f"reloaded tokens {sv['tokens']} vs fresh "
                        f"{sv['fresh_tokens']}")
    if (sv["watched"] != sv["newer"] or sv["pickup_s"] > LINEAGE_PICKUP_S
            or not sv["active_at_pickup"] or sv["failed"]
            or sv["watch_tokens"] != [WATCH_NEW_TOKENS]):
        failures.append(f"watch {sv}")
    if (sv["forged"], sv["forged_skipped"], sv["after_forged"]) != (
            None, 1, sv["newer"]):
        failures.append(f"forged step shipped or uncounted: {sv}")
    if failures:
        raise AssertionError("phase (o): " + "; ".join(failures))
    return dict(fsdp={k: r0["launches"][k] + r1["launches"][k]
                      for k in FLASH},
                restore={k: sum(r["launches"][k] for r in tp_recs)
                         + w1["launches"][k] for k in FLASH})


# -- phase (p): the SDC defense plane -----------------------------------------


def sdc_rig(make_trainer, cfg, reg, ids, ck=None, kv=None, worker="w0",
            flight_dir=None, job="sdc"):
    """An SdcPlane whose shadow replays on ``make_trainer()``."""
    shadow = sdc.ShadowRecompute(
        make_trainer, lambda: VirtualBatches(cfg, ids, reg.get), cfg,
        checkpointer=ck)
    return sdc.SdcPlane(
        fingerprinter=sdc.UpdateFingerprinter(kv=kv, job=job, worker=worker),
        detector=sdc.AnomalyDetector(), shadow=shadow, checkpointer=ck,
        flight_dir=flight_dir)


def verdicts(plane) -> list:
    """Each verdict as every rank holds it."""
    return [dict(step=v.step, trigger=v.trigger, outcome=v.outcome,
                 rollback=v.rollback_step, quarantined=v.quarantined)
            for v in plane.verdicts]


def trace_ms(name: str) -> list:
    """The ``elapsed_ms`` of every ``name`` trace event of this process:
    ``sdc_shadow_recompute`` (the judging rank's restore, replay and
    fingerprint) and ``sdc_rollback``."""
    return [e.args["elapsed_ms"] for e in get_tracer().events()
            if e.name == name]


def state_leaves(trainer) -> dict:
    """The trainer's whole state as a tree of tensors on the card."""
    opt = trainer.state.opt_state.state
    return {"params": trainer.state.params,
            "opt": {n: [v for _, v in sorted(opt[p].items())
                        if torch.is_tensor(v) and v.is_cuda]
                    for n, p in trainer.state.params.named_parameters()}}


def fold_drill(trainer) -> dict:
    """The device fold against the host fold on every leaf of the state,
    and the fingerprint's step-loop pause by each, on the card."""
    tree = state_leaves(trainer)
    leaves = list(sdc._leaves_with_path(tree))
    words = sdc.device_tree_folds(tree)
    agree = sum(sdc._mix_tail(w, sdc._nbytes(x), sdc._dtype_name(x))
                == sdc.leaf_fold(x) for (_, x), w in zip(leaves, words))
    pauses = {}
    for name, device in (("device", True), ("host", False)):
        fp = sdc.UpdateFingerprinter()
        fp._prefer_device = device
        fp.record(0, tree)  # the device path's one check against the host
        for i in range(SDC_PAUSE_REPS):
            fp.record(i + 1, tree)
        pauses[name] = 1e3 * float(np.median(fp.pauses_s[1:]))
    return dict(leaves=len(leaves), agree=agree,
                bytes=sum(sdc._nbytes(x) for _, x in leaves), **pauses)


def sdc_single(tmp: str) -> dict:
    """(p-1) in this process: the flip, rolled back."""
    trainer, reg, ids, cfg = flagship_virtual_world(0, 1, None)
    ck = ElasticCheckpointer(os.path.join(tmp, "p1"))
    plane = sdc_rig(lambda: flagship_virtual_world(0, 1, None)[0], cfg, reg,
                    ids, ck=ck, flight_dir=os.path.join(tmp, "fr"))
    steps: list = []
    instrument(trainer, steps)
    loop = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                             checkpointer=ck, ckpt_every=SDC_CKPT_EVERY,
                             sdc=plane)

    def strike(step, loss, world):
        if step == SDC_STRIKE_STEP and plane.healthy():
            trainer.flip_param_bits(**SDC_FLIP)

    before = [len(trace_ms(n)) for n in ("sdc_shadow_recompute",
                                          "sdc_rollback")]
    rep = loop.run(max_steps=SDC_STEPS, on_step=strike)
    recs = [f for f in os.listdir(os.path.join(tmp, "fr"))
            if f.endswith(".json")]
    trail = []
    if recs:
        with open(os.path.join(tmp, "fr", recs[0])) as f:
            trail = json.load(f)["extra"]["sdc_verdict_trail"]
    got = dict(losses=rep.losses, rows=rows_once([rep]),
               rollbacks=rep.rollbacks, verdicts=verdicts(plane),
               shadow_ms=trace_ms("sdc_shadow_recompute")[before[0]:],
               rollback_ms=trace_ms("sdc_rollback")[before[1]:], trail=trail,
               launches=[st["launches"] for st in steps],
               folds=fold_drill(trainer))
    ck.close()
    return got


def sdc_poison() -> dict:
    """(p-2) in this process: a poisoned loss report, refuted."""
    trainer, reg, ids, cfg = flagship_virtual_world(0, 1, None)
    plane = sdc_rig(lambda: flagship_virtual_world(0, 1, None)[0], cfg, reg,
                    ids)
    engine = FaultPlanEngine(
        FaultPlan(actions=[PoisonLoss(at_step=SDC_STRIKE_STEP - 1)]),
        FaultContext(trainer=trainer))
    before = len(trace_ms("sdc_shadow_recompute"))
    rep = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                            sdc=plane).run(max_steps=SDC_STEPS,
                                           on_step=engine)
    return dict(losses=rep.losses, rollbacks=rep.rollbacks,
                verdicts=verdicts(plane),
                shadow_ms=trace_ms("sdc_shadow_recompute")[before:],
                recovered=engine.recovered)


def sdc_pair(tmp: str) -> dict:
    """(p-3) in this process: two one-rank workers sharing a MemoryKV, a
    corrupt gradient on one of them."""
    kv = sdc.MemoryKV()
    rigs = {}
    for worker in ("wA", "wB"):
        trainer, reg, ids, cfg = flagship_virtual_world(0, 1, None)
        ck = ElasticCheckpointer(os.path.join(tmp, worker))
        plane = sdc_rig(lambda: flagship_virtual_world(0, 1, None)[0], cfg,
                        reg, ids, ck=ck, kv=kv, worker=worker, job="pair")
        rigs[worker] = (trainer, VirtualWorkerLoop(
            trainer, cfg, VirtualBatches(cfg, ids, reg.get),
            checkpointer=ck, ckpt_every=SDC_CKPT_EVERY, sdc=plane), plane, ck)
    engine = FaultPlanEngine(
        FaultPlan(actions=[CorruptGradient(at_step=SDC_STRIKE_STEP)]),
        FaultContext(trainer=rigs["wB"][0]))
    before = len(trace_ms("sdc_shadow_recompute"))
    for i in range(1, SDC_STEPS + 1):
        engine(i)
        for worker in ("wA", "wB"):
            rigs[worker][1].run(max_steps=1)
    got = {w: dict(losses=r[1].report.losses, rollbacks=r[1].report.rollbacks,
                   verdicts=verdicts(r[2]))
           for w, r in rigs.items()}
    got.update(quarantined=sorted(sdc.quarantined_names(kv)),
               shadow_ms=trace_ms("sdc_shadow_recompute")[before:],
               recovered=engine.recovered)
    for r in rigs.values():
        r[3].close()
    return got


def sdc_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(p-4) and (p-5), one rank: the flip drill on a replicated world of
    2, then a prewarmed and a cold resize 1→2 of fresh trainers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launches()
    trainer, reg, ids, cfg = flagship_virtual_world(
        rank, WORLD_RANKS, store, initial_world_size=WORLD_RANKS)
    ck = ElasticCheckpointer(ckpt_dir)
    plane = sdc_rig(lambda: flagship_virtual_world(
        rank, WORLD_RANKS, store, initial_world_size=1)[0], cfg, reg, ids,
        ck=ck)
    steps: list = []
    instrument(trainer, steps)
    loop = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                             checkpointer=ck, ckpt_every=SDC_CKPT_EVERY,
                             sdc=plane)

    def strike(step, loss, world):
        if step == SDC_STRIKE_STEP and plane.healthy():
            trainer.flip_param_bits(**SDC_FLIP)

    rep = loop.run(max_steps=SDC_STEPS, on_step=strike)
    rec = dict(rank=rank, losses=rep.losses, rows=rows_once([rep]),
               rollbacks=rep.rollbacks, verdicts=verdicts(plane),
               shadow_ms=trace_ms("sdc_shadow_recompute"),
               rollback_ms=trace_ms("sdc_rollback"),
               launches=[st["launches"] for st in steps])
    del loop, plane, trainer
    torch.cuda.empty_cache()

    for name in ("cold", "prewarmed"):
        trainer, batch = flagship_elastic_world(
            rank, WORLD_RANKS, store, batch=B, seq=S, initial_world_size=1)
        trainer.step(batch)
        if name == "prewarmed":
            trainer.prewarm([WORLD_RANKS])
            rec["quiet"] = trainer.prewarm_quiesce(VIRTUAL_CHILD_TIMEOUT_S)
        rec[name] = dict(resized=trainer.resize(WORLD_RANKS),
                         event=trainer.resize_events[-1],
                         state=checksum(state_tensors(trainer, True)))
        del trainer
        torch.cuda.empty_cache()
    rec["total_launches"] = dict(fa.launches)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_sdc(card: str, control: list) -> dict:
    """(p): the SDC plane's drills and the prewarmed resize, against (k)'s
    control; returns the flash launches of the phase."""
    torch.cuda.empty_cache()
    want = control[:SDC_STEPS]
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        single = sdc_single(tmp)
        torch.cuda.empty_cache()
        poison = sdc_poison()
        torch.cuda.empty_cache()
        pair = sdc_pair(tmp)
        torch.cuda.empty_cache()
        launches = dict(fa.launches)
        recs = run_ranks(sdc_rank, "p", VIRTUAL_CHILD_TIMEOUT_S,
                         os.path.join(tmp, "p4"))
    torch.cuda.empty_cache()
    for k in FLASH:
        launches[k] += sum(r["total_launches"][k] for r in recs)
    f = single["folds"]
    print(f"sdc phase (p): FLAGSHIP, V 8, {SDC_STEPS} steps, a checkpoint "
          f"every {SDC_CKPT_EVERY}, strikes after step {SDC_STRIKE_STEP}, "
          f"on {card}", flush=True)
    print(f"sdc device fold vs host fold: {f['agree']} of {f['leaves']} "
          f"leaves equal over {f['bytes']} bytes of state; fingerprint "
          f"pause device {f['device']:.2f} ms host {f['host']:.2f} ms "
          f"(median of {SDC_PAUSE_REPS}) on {card}", flush=True)
    print(f"sdc (p-1) flip: verdicts {single['verdicts']} shadow_ms "
          f"{single['shadow_ms']} rollback_ms "
          f"{single['rollback_ms']} losses {single['losses']} control {want} "
          f"bitwise {single['losses'] == want}; rows {single['rows']}; "
          f"trail {[t['outcome'] for t in single['trail']]} on {card}",
          flush=True)
    print(f"sdc (p-2) poison: verdicts {poison['verdicts']} shadow_ms "
          f"{poison['shadow_ms']} losses "
          f"{poison['losses']} bitwise {poison['losses'] == want}; "
          f"recovered {poison['recovered']} on {card}", flush=True)
    print(f"sdc (p-3) pair: wB verdicts {pair['wB']['verdicts']} shadow_ms "
          f"{pair['shadow_ms']} wA "
          f"{pair['wA']['verdicts']}; quarantined {pair['quarantined']}; "
          f"bitwise wA {pair['wA']['losses'] == want} wB "
          f"{pair['wB']['losses'] == want}; recovered {pair['recovered']} "
          f"on {card}", flush=True)
    for r in recs:
        print(f"sdc (p-4) rank {r['rank']}: verdicts {r['verdicts']} "
              f"shadow_ms {r['shadow_ms']} rollback_ms {r['rollback_ms']} "
              f"bitwise "
              f"{r['losses'] == want}; flash launches a step "
              f"{sorted({tuple(x.values()) for x in r['launches']})} on "
              f"{card}", flush=True)
        for name in ("cold", "prewarmed"):
            e = r[name]["event"]
            print(f"sdc (p-5) rank {r['rank']} {name} resize(2): "
                  f"prewarm_hit {e['prewarm_hit']} compile_ms "
                  f"{e['compile_ms']} reshard_ms {e['reshard_ms']} "
                  f"replan_ms {e['replan_ms']} on {card}", flush=True)
    failures = []
    n = tfm.FLAGSHIP.n_layers * 8
    v = single["verdicts"]
    if (single["rollbacks"] != 1 or len(v) != 1
            or (v[0]["outcome"], v[0]["rollback"], v[0]["step"])
            != ("confirmed", SDC_CKPT_EVERY, SDC_STRIKE_STEP + 1)
            or v[0]["trigger"] not in ("nan", "loss_spike")):
        failures.append(f"(p-1) {single['verdicts']} {single['rollbacks']}")
    if (single["losses"] != want or single["rows"]["duplicated"]
            or single["rows"]["trained"] != SDC_STEPS * B):
        failures.append(f"(p-1) losses {single['losses']} rows "
                        f"{single['rows']}")
    if not single["trail"] or single["trail"][-1]["rollback_step"] != \
            SDC_CKPT_EVERY:
        failures.append(f"(p-1) flight record trail {single['trail']}")
    if any(set(x.values()) != {n} for x in single["launches"]):
        failures.append(f"(p-1) launches {single['launches']}")
    if f["agree"] != f["leaves"]:
        failures.append(f"device fold {f}")
    pv = poison["verdicts"]
    if (len(pv) != 1 or (pv[0]["trigger"], pv[0]["outcome"])
            != ("nan", "refuted") or poison["rollbacks"]
            or poison["losses"] != want
            or poison["recovered"] != ["poison_loss"]):
        failures.append(f"(p-2) {poison}")
    bv = pair["wB"]["verdicts"]
    if (len(bv) != 1 or (bv[0]["trigger"], bv[0]["outcome"],
                         bv[0]["quarantined"])
            != ("fp_mismatch", "confirmed", "wB")
            or pair["wA"]["verdicts"] or pair["quarantined"] != ["wB"]
            or pair["wB"]["rollbacks"] != 1
            or pair["wA"]["losses"] != want or pair["wB"]["losses"] != want
            or pair["recovered"] != ["corrupt_gradient"]):
        failures.append(f"(p-3) {pair}")
    for r in recs:
        if ([(x["step"], x["outcome"], x["rollback"]) for x in r["verdicts"]]
                != [(SDC_STRIKE_STEP + 1, "confirmed", SDC_CKPT_EVERY)]):
            failures.append(f"(p-4) rank {r['rank']} {r['verdicts']}")
        if r["rollbacks"] != 1 or r["losses"] != want:
            failures.append(f"(p-4) rank {r['rank']} {r['losses']}")
        if any(set(x.values()) != {n} for x in r["launches"]):
            failures.append(f"(p-4) rank {r['rank']} launches")
        if (r["cold"]["event"]["prewarm_hit"]
                or not r["prewarmed"]["event"]["prewarm_hit"]
                or not (r["cold"]["resized"] and r["prewarmed"]["resized"])
                or r["cold"]["state"] != r["prewarmed"]["state"]
                or not r["quiet"]):
            failures.append(f"(p-5) rank {r['rank']}")
    if recs[0]["verdicts"] != recs[1]["verdicts"]:
        failures.append("(p-4) the ranks' verdicts differ")
    if failures:
        raise AssertionError("phase (p): " + "; ".join(failures))
    return {k: launches[k] for k in FLASH}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = _build.build()
    print(f"build: {build_s:.2f} s into {_build.build_dir()}", flush=True)
    print_ptxas_report()
    rows = phase_flash(B, S, H, HK, D, (True, False), "flagship")
    paths = {"flagship": phase_flagship()}
    phase_model_check()
    sites = resnet.group_norm_sites(resnet.RESNET50, RESNET_HW)
    rows.update(phase_group_norm(sites))
    bert_rows = phase_flash(BERT_B, BERT_S, BERT_H, BERT_H, BERT_D, (False,),
                            "bert_base")
    virtual_rows = phase_flash(VIRTUAL_MICRO_BATCH, S, H, HK, D, (True,),
                               "flagship_virtual")
    world_rows = phase_flash(B // WORLD_RANKS, S, H, HK, D, (True,),
                             "flagship_world")
    tp_rows = phase_flash(B, S, H // WORLD_RANKS, HK // WORLD_RANKS, D,
                          (True,), "flagship_tp")
    durable_tp_rows = phase_flash(VIRTUAL_MICRO_BATCH, S, H // WORLD_RANKS,
                                  HK // WORLD_RANKS, D, (True,),
                                  "flagship_durable_tp")
    paths["resnet50"] = phase_resnet(sum(sites.values()))
    paths["bert_base"] = phase_bert()
    phase_serving()
    paths["flagship_world"] = phase_world(card)
    virtual = phase_virtual(card)
    paths["flagship_virtual"] = virtual["launches"]
    paths["flagship_fsdp"] = phase_fsdp(card)
    paths["flagship_tp"] = phase_tp(card)
    phase_dryrun()
    durable = phase_durable(card, virtual["control"], virtual["drills"])
    paths["flagship_durable_fsdp"] = durable["fsdp"]
    paths["flagship_durable_restore"] = durable["restore"]
    paths["flagship_sdc"] = phase_sdc(card, virtual["control"])

    kernels = []
    for name, meta in KERNELS.items():
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        row = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=sum(by_path.values()),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            launches_by_path=by_path))
        if name in bert_rows:
            kernels[-1]["at_bert_base"] = bert_rows[name]
        if name in virtual_rows:
            kernels[-1]["at_flagship_virtual"] = virtual_rows[name]
        if name in world_rows:
            kernels[-1]["at_flagship_world"] = world_rows[name]
        if name in tp_rows:
            kernels[-1]["at_flagship_tp"] = tp_rows[name]
        if name in durable_tp_rows:
            kernels[-1]["at_flagship_durable_tp"] = durable_tp_rows[name]
    print(json.dumps({"kernels": kernels}))
    # every path ran on the one device it was given
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
