"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

(a) build the hand-written kernels from ``edl_tpu_torch/csrc`` (nvcc,
    sm_90a) and print the build seconds;
(b) hold each kernel — flash forward, dQ, dK/dV — against its plain PyTorch
    version at FLAGSHIP attention shapes (bf16, b 16, s 1024, h 8, hk 2,
    d 128), causal and non-causal, and time the kernel, the plain version
    and ``F.scaled_dot_product_attention`` (a yardstick the port never
    calls) beside the least time the card could take;
(c) the main path: ``ElasticTrainer`` on FLAGSHIP with the flash kernels,
    adamw(3e-4), batch 16 x seq 1024 of seeded tokens, 1 warm-up step and 5
    timed steps; every loss finite, the loss falling, and each kernel
    launched once per layer per step;
(d) the port's entry point, and the model's logits through the flash
    kernels against its reference attention path on a small input, with
    the same model's attention output zeroed as a control that must fail.

Each kernel is held to the element-wise rule of
``edl_tpu_torch/ops/kernel_check.py``; ``python -m
edl_tpu_torch.ops.kernel_check`` shows that faults planted in the kernels
fail it.

Prints the card's name and power limit, one JSON line of kernels, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.entry import entry, flagship_trainer
from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.ops import kernel_check as kc

#: H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: FLAGSHIP attention at bench.py's accelerator batch
B, S, H, HK, D = 16, 1024, 8, 2, 128
WARMUP_STEPS, TIMED_STEPS = 1, 5
KERNEL_ITERS, PLAIN_ITERS = 20, 3
#: phase (d): the logits of the flash and reference attention paths of the
#: bf16 model, element by element: |flash - reference| <= 2^-7 |reference|
#: + MODEL_ATOL * rms(reference).  The two paths round the attention
#: output at different points and the difference grows through 8 layers.
#: The floor sits between what the two paths need and what the model with
#: its attention output zeroed needs; phase (d) prints both (on an H100,
#: below 0.2 and above 7 rms)
MODEL_ATOL = 0.5

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
}


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name: str, causal: bool, tensors) -> tuple[float, str]:
    """Least time for the kernel's work on this card: the larger of its
    tensor-core operations over the visible score pairs at the bf16 peak,
    and its bytes (each input read once, each output written once) at the
    memory rate."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = KERNELS[name]["products"] * 2.0 * B * H * pairs * D
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> dict:
    """(b): every kernel against its plain version, causal and not."""
    rows = {name: {"max_abs_err": 0.0} for name in KERNELS}
    dev = torch.device("cuda")
    for seed, causal in enumerate((True, False)):
        q, k, v, do = kc.random_inputs(B * H, B * HK, S, D, seed, dev)
        readings, got = kc.compare(q, k, v, do, causal, H, HK)
        tag = "causal" if causal else "full"
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
                for name, outs in kc.OUTPUTS.items()}
        for name, e in errs.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)

        # timings at these inputs; the library yardstick is SDPA with GQA
        # on the [b, h, s, d] views of the same buffers
        out, lse, delta = got["out"], got["lse"], got["delta"]
        q4, k4, v4 = (x.view(B, -1, S, D) for x in (q, k, v))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                 enable_gqa=True)
        do4 = do.view(B, H, S, D)
        times = {
            "flash_fwd": (
                lambda: fa.flash_forward_cuda(q, k, v, causal, H, HK),
                lambda: fa.flash_forward_plain(q, k, v, causal, H, HK),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=True),
                (q, k, v, out, lse)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal,
                                             H, HK),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                              H, HK),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                            retain_graph=True),
                (q, k, v, do, lse, delta, got["dq"])),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                              causal, H, HK),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal, H, HK),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                            retain_graph=True),
                (q, k, v, do, lse, delta, got["dk"], got["dv"])),
        }
        for name, (kern, plain, lib, tensors) in times.items():
            ms = cuda_ms(kern, KERNEL_ITERS)
            plain_ms = cuda_ms(plain, PLAIN_ITERS)
            library_ms = cuda_ms(lib, KERNEL_ITERS)
            bound_ms, bound_by = bound(name, causal, tensors)
            print(f"kernel {name} {tag}: max_abs_err {errs[name]:.4e} "
                  f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by})", flush=True)
            if causal:  # the main path is causal: its times are the record
                rows[name].update(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
        del lib_out
    return rows


def phase_main_path() -> dict:
    """(c): FLAGSHIP train steps through ElasticTrainer with the kernels."""
    trainer, batch = flagship_trainer(B, S)
    n_layers = trainer.state.params.cfg.n_layers
    torch.cuda.synchronize()
    losses, step_s = [], []
    fa.reset_launches()
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        losses.append(trainer.step(batch))  # float(loss) waits for the step
        step_s.append(time.perf_counter() - t0)
        grown = {n: fa.launches[n] - before[n] for n in fa.launches}
        if any(c != n_layers for c in grown.values()):
            raise AssertionError(f"step {i}: launches {grown}, want "
                                 f"{n_layers} of each kernel")
    launches = dict(fa.launches)
    timed = losses[WARMUP_STEPS:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"loss did not fall: {timed}")
    step_ms = 1e3 * float(np.mean(step_s[WARMUP_STEPS:]))
    print(f"main path: FLAGSHIP b{B} s{S} losses "
          f"{[round(x, 4) for x in losses]} step_ms {step_ms:.2f} "
          f"(per step {[round(1e3 * x, 2) for x in step_s]}) "
          f"tokens_per_second {B * S / (step_ms / 1e3):.1f} "
          f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
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
    ref = out[False]
    rms = ref.float().square().mean().sqrt().item()
    flash, control = (kc.reading(out[key], ref, kc.BF16_RTOL,
                                 MODEL_ATOL * rms)
                      for key in (True, "no attention"))
    print(f"model check: entry logits {tuple(logits.shape)} finite; "
          f"flash vs reference logits max |diff| {flash['max_abs_err']:.4f},"
          f" {flash['worst']:.3f} of the limit (floor needed "
          f"{flash['need_atol']:.4f} rms); attention zeroed "
          f"{control['worst']:.3f} of it ({control['need_atol']:.4f} rms)",
          flush=True)
    if not flash["worst"] <= 1.0:
        raise AssertionError("flash path's logits off the reference path's")
    if control["worst"] <= 1.0:
        raise AssertionError("the logits check passes a model without "
                             "attention")


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
    rows = phase_kernels()
    launches = phase_main_path()
    phase_model_check()

    kernels = [dict(name=name, route="cuda", source=meta["source"],
                    replaces=meta["replaces"], launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"],
                    library_ms=rows[name]["library_ms"])
               for name, meta in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
