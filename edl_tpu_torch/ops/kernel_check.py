"""The kernels held against their plain versions on the card, and faults
planted in copies of the kernel sources to show the check sees them.

The rule, for every bf16 output (out, dq, dk, dv), element by element:

    |kernel - plain| <= BF16_RTOL * |plain| + BF16_ATOL * rms(plain)

Kernel and plain version round to bf16 at the same points but sum in other
orders, so the fp32 values they round differ a little and the two results
may land one bf16 ulp apart: at most 2^-7 of the element.  The absolute
floor, a small fraction of the tensor's RMS, covers elements near zero,
where the fp32 sums cancel.  Because the limit follows each element's own
size, a kernel that is wrong only where the values are small (the late rows
of a causal softmax, which average many keys, or one GQA member's share of
dK/dV) fails.  The fp32 logsumexp is held to ``LSE_ATOL`` absolute.

GroupNorm's bf16 ``y`` and ``dx`` take the same rule.  Its fp32 outputs
(mean, inv, the dγ/dβ partials; and y, dx when x is fp32) are the same fp32
sums in another order, held at ``GN_FP32_RTOL`` of the element plus
``GN_FP32_RTOL`` of the tensor's RMS.

Run on a machine with the card, from the repository root:

    python -m edl_tpu_torch.ops.kernel_check

It plants each fault of :data:`FAULTS` in a temporary copy of
``edl_tpu_torch/csrc``, builds the copies, runs each through the kernel
wrappers (flash faults at FLAGSHIP attention shapes, causal; GroupNorm
faults at the ResNet-50 shapes of :data:`GN_FAULT_SHAPES`, bf16) and prints
one JSON line per fault, with whether the coarser whole-tensor rule ``COARSE_TOL`` would have
caught it (the lse is left out of that contrast); it exits non-zero when
the unchanged kernels fail the rule or a planted fault passes it.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from edl_tpu_torch.device import resolve
from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.ops import group_norm as gn

#: one bf16 ulp is at most 2^-7 of the value it rounds
BF16_RTOL = 2.0 ** -7
#: absolute floor, as a fraction of the tensor's RMS: about twice the
#: largest floor the unchanged kernels need at FLAGSHIP attention shapes
#: (0.0174 for dQ on an H100; ``need_atol`` in this module's output)
BF16_ATOL = 2.0 ** -5
#: fp32 logsumexp: the same fp32 sums in another order (measured up to
#: 1.2e-6 at FLAGSHIP shapes on an H100)
LSE_ATOL = 1e-5
#: a coarser rule, max |kernel - plain| <= 2e-2 * max(1, max |plain|) over
#: the whole tensor, reported beside each planted fault for contrast
COARSE_TOL = 2e-2
#: GroupNorm's fp32 outputs: fp32 sums of up to 25 088 terms per group
#: (the ResNet-50 stem) in another order than the plain version's
GN_FP32_RTOL = 1e-4
#: outputs of each kernel
OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
           "flash_bwd_dkv": ("dk", "dv"),
           "group_norm_fwd": ("y", "mean", "inv"),
           "group_norm_bwd": ("dx", "dgamma", "dbeta")}
#: (b, hw, c) of the GroupNorm fault runs: the ResNet-50 stem (clusters of
#: 8 forward and 16 backward, 2 channels a group), a stage-3 site (clusters
#: of 2 and 4, 64 channels a group), and twice the stem, whose backward
#: keeps dy resident and reads most of x again
GN_FAULT_SHAPES = ((16, 12544, 64), (16, 196, 1024), (4, 25088, 64))
GN_GROUPS = 32

#: name -> (library, source, text, planted text): each fault is one edit of
#: one kernel, of the kind a tiling or indexing slip makes
FAULTS = {
    # every query also sees the key just after it (causal mask one late)
    "fwd_mask_one_late": (
        "flash_fwd", "flash_fwd.cu", "> row + 8 * (e >> 1))",
        "> row + 8 * (e >> 1) + 1)"),
    # the S = Q·Kᵀ product reads K one 16-wide wgmma K step too far on
    # (its shared-memory descriptor advanced off by one)
    "fwd_kstep_off_by_one": (
        "flash_fwd", "flash_fwd.cu", "desc_add(dk0, koff)",
        "desc_add(dk0, koff + 32)"),
    "dq_mask_one_late": (
        "flash_bwd", "flash_bwd.cu", "> row + 8 * (e >> 1))",
        "> row + 8 * (e >> 1) + 1)"),
    # the dQ loop stops before the last key tile that crosses the diagonal
    # (producer and consumers alike, so the ring stays whole)
    "dq_diagonal_tile_dropped": (
        "flash_bwd", "flash_bwd.cu",
        "const int n_kt = CAUSAL ? (qt + 1) * (kBQ / kBK) : s / kBK;",
        "const int n_kt = CAUSAL ? (qt + 1) * (kBQ / kBK) - 1 : s / kBK;"),
    # the dQ consumers wait for ring stage st but read the next stage, whose
    # K / V belong to another key tile (or have not landed)
    "dq_ring_wrong_stage": (
        "flash_bwd", "flash_bwd.cu",
        "unsigned char* sk = skv + 2 * st * L::kKVTile;",
        "unsigned char* sk = skv + 2 * ((st + 1) % kStages) * L::kKVTile;"),
    # S = Q·Kᵀ reads K one 16-wide wgmma K step too far on
    "dq_kstep_off_by_one": (
        "flash_bwd", "flash_bwd.cu", "desc_add(dk0, koff)",
        "desc_add(dk0, koff + 32)"),
    # dQ += ds·K reads K (MN-major) one 16-key step too far on
    "dq_mn_step_off_by_one": (
        "flash_bwd", "flash_bwd.cu", "desc_add(dk_mn, kk * 2048)",
        "desc_add(dk_mn, kk * 2048 + 2048)"),
    # every q head reads the K / V of the next kv head of its batch row
    "dq_kv_head_off_by_one": (
        "flash_bwd", "flash_bwd.cu",
        "const int kvh = (bh / h) * hk + (bh % h) / (h / hk);",
        "const int kvh = (bh / h) * hk + ((bh % h) / (h / hk) + 1) % hk;"),
    # dK/dV masks the diagonal itself (each key loses its own query)
    "dkv_diagonal_masked": (
        "flash_bwd", "flash_bwd.cu", "> q0 + col) x = kNegInf",
        ">= q0 + col) x = kNegInf"),
    # dK/dV sums over every GQA member but the last
    "dkv_gqa_member_skipped": (
        "flash_bwd", "flash_bwd.cu", "const int n_steps = rep * per_member;",
        "const int n_steps = (rep - 1) * per_member;"),
    # ... and only for the last key tile, whose keys see the fewest
    # queries and so hold the smallest dK/dV
    "dkv_gqa_member_skipped_last_tile": (
        "flash_bwd", "flash_bwd.cu", "const int n_steps = rep * per_member;",
        "const int n_steps = (rep - (kt == s / kBK - 1)) * per_member;"),
    # the dK/dV consumers wait for ring stage st but read the next stage,
    # whose Q / dO / lse / delta belong to another step (or have not landed)
    "dkv_ring_wrong_stage": (
        "flash_bwd", "flash_bwd.cu",
        "unsigned char* sq = stages + st * L::kStage;",
        "unsigned char* sq = stages + (st + 1) % kStages * L::kStage;"),
    # GroupNorm's group statistics fold channels one to the right
    "gn_group_membership_off_by_one": (
        "group_norm", "group_norm.cu", "const int ch = g * cg + i;",
        "const int ch = (g * cg + i + 1) % c;"),
    # the image's channel sums leave out the last cluster rank's partial
    # row (its share of the rows)
    "gn_last_rank_skipped": (
        "group_norm", "group_norm.cu", "if (rk < k) {",
        "if (rk < k - 1) {"),
    # dγ loses its mean term: Σ dy·x·inv instead of Σ dy·x̂
    "gn_dgamma_mean_term_dropped": (
        "group_norm", "group_norm.cu",
        "__fmul_rn(inv, __fsub_rn(s, __fmul_rn(mean, a)))",
        "__fmul_rn(inv, s)"),
    # dx reads its coefficients p, q, r in the wrong slots
    "gn_dx_coefficients_swapped": (
        "group_norm", "group_norm.cu", "pg, pm, pi, p, q, r);",
        "pg, pm, pi, q, r, p);"),
    # the elementwise pass reads each resident row from the row after it
    # (the last from the shared memory that follows, still the block's own)
    "gn_resident_row_off_by_one": (
        "group_norm", "group_norm.cu", "const T* ur = su + off;",
        "const T* ur = su + c + off;"),
    # the backward's rows of x that did not stay resident are read again
    # from the neighbouring block's rows; only twice the stem re-reads x at
    # GN_FAULT_SHAPES
    "gn_reread_neighbour_rows": (
        "group_norm", "group_norm.cu", "const T* xa = gv + off;",
        "const T* xa = gv + (long)(min(rank ^ 1, k - 1) - rank) * P.rows * c"
        " + off;"),
}


def reading(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float) -> dict:
    """How ``got`` stands against ``want`` under |got - want| <= rtol·|want|
    + atol: ``worst`` is the largest share of its limit an element uses
    (the check passes at <= 1), ``need_atol`` the least atol that would
    pass at this rtol, in units of rms(want)."""
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt().item()
    if not torch.isfinite(g).all():
        return dict(max_abs_err=math.inf, worst=math.inf,
                    need_atol=math.inf, max_abs_want=w.abs().max().item(),
                    rms_want=rms)
    err = (g - w).abs()
    return dict(
        max_abs_err=err.max().item(),
        worst=(err / (rtol * w.abs() + atol)).max().item(),
        need_atol=(err - rtol * w.abs()).clamp_min(0).max().item() / rms,
        max_abs_want=w.abs().max().item(), rms_want=rms)


def bf16_reading(got: torch.Tensor, want: torch.Tensor) -> dict:
    rms = want.float().square().mean().sqrt().item()
    return reading(got, want, BF16_RTOL, BF16_ATOL * rms)


def random_inputs(bh: int, bkh: int, s: int, d: int, seed: int,
                  device: torch.device):
    """Seeded bf16 (q, k, v, dO) with heads folded into the batch."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(n):
        return torch.randn(n, s, d, generator=g, device=device
                           ).to(torch.bfloat16)

    q, do = rnd(bh), rnd(bh)
    k, v = rnd(bkh), rnd(bkh)
    return q, k, v, do


def compare(q, k, v, do, causal: bool, h: int, hk: int
            ) -> tuple[dict, dict]:
    """Each kernel and its plain version on the same inputs → (reading of
    each output, the kernels' outputs).  dQ and dK/dV take the kernel
    forward's lse and δ, as in training."""
    out, lse = fa.flash_forward_cuda(q, k, v, causal, h, hk)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal, h, hk)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, h, hk)
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, h, hk)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, h, hk)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                            h, hk)
    torch.cuda.synchronize()
    readings = {name: bf16_reading(got, want) for name, (got, want) in
                dict(out=(out, ref_out), dq=(dq, ref_dq), dk=(dk, ref_dk),
                     dv=(dv, ref_dv)).items()}
    readings["lse"] = reading(lse, ref_lse, 0.0, LSE_ATOL)
    return readings, dict(out=out, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv)


def gn_random_inputs(b: int, hw: int, c: int, seed: int,
                     device: torch.device, dtype=torch.bfloat16):
    """Seeded (x, dy, scale, bias): x off zero (mean 0.5, std 2), so the
    mean terms of the statistics and of dγ matter."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(b, hw, c, generator=g, device=device) * 2 + 0.5
         ).to(dtype)
    dy = torch.randn(b, hw, c, generator=g, device=device).to(dtype)
    scale = torch.randn(c, generator=g, device=device) * 0.5 + 1.0
    bias = torch.randn(c, generator=g, device=device) * 0.5
    return x, dy, scale, bias


def _fp32_reading(got: torch.Tensor, want: torch.Tensor) -> dict:
    rms = want.float().square().mean().sqrt().item()
    return reading(got, want, GN_FP32_RTOL, GN_FP32_RTOL * rms)


def gn_compare(x, dy, scale, bias, groups: int, eps: float = 1e-5
               ) -> tuple[dict, dict]:
    """The GroupNorm kernels and their plain versions on the same inputs →
    (reading of each output, the kernels' outputs).  The backward takes
    the kernel forward's mean and inv, as in training."""
    y, mean, inv = gn.group_norm_fwd_cuda(x, scale, bias, groups, eps)
    ref_y, ref_mean, ref_inv = gn.group_norm_fwd_plain(x, scale, bias,
                                                       groups, eps)
    dx, dg, db = gn.group_norm_bwd_cuda(x, dy, scale, mean, inv, groups)
    ref_dx, ref_dg, ref_db = gn.group_norm_bwd_plain(x, dy, scale, mean, inv,
                                                     groups)
    torch.cuda.synchronize()
    act = bf16_reading if x.dtype == torch.bfloat16 else _fp32_reading
    readings = dict(y=act(y, ref_y), dx=act(dx, ref_dx))
    readings.update({name: _fp32_reading(got, want) for name, (got, want) in
                     dict(mean=(mean, ref_mean), inv=(inv, ref_inv),
                          dgamma=(dg, ref_dg), dbeta=(db, ref_db)).items()})
    return readings, dict(y=y, mean=mean, inv=inv, dx=dx, dgamma=dg,
                          dbeta=db)


def failures(readings: dict) -> list[str]:
    """The outputs that break the rule, each with its reading."""
    return [f"{name}: max |kernel - plain| {r['max_abs_err']:.3e}, "
            f"{r['worst']:.3g}x its limit" for name, r in readings.items()
            if not r["worst"] <= 1.0]


def _build_fault(name: str, root: Path) -> Path:
    lib, source, text, planted = FAULTS[name]
    csrc = root / name / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    code = (csrc / source).read_text()
    if code.count(text) != 1:
        raise RuntimeError(f"fault {name}: {text!r} is not in {source} once")
    (csrc / source).write_text(code.replace(text, planted))
    _build.build(csrc, root / name / "lib", names=(lib,))
    return root / name / "lib" / f"lib{lib}.so"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve("cuda")
    b, s, h, hk, d = 16, 1024, 8, 2, 128  # FLAGSHIP attention, bench batch
    _build.build()
    flash_inputs = random_inputs(b * h, b * hk, s, d, args.seed, dev)
    gn_inputs = [gn_random_inputs(*shape, args.seed, dev)
                 for shape in GN_FAULT_SHAPES]

    def check(lib: str) -> dict:
        """Readings of the library's kernels: output (at each GroupNorm
        shape) -> reading."""
        if lib != "group_norm":
            return compare(*flash_inputs, True, h, hk)[0]
        return {f"{out}@{shape[1]}x{shape[2]}": r
                for shape, inputs in zip(GN_FAULT_SHAPES, gn_inputs)
                for out, r in gn_compare(*inputs, GN_GROUPS)[0].items()}

    ok = True
    for lib in ("flash", "group_norm"):
        base = check(lib)
        print(json.dumps({"fault": None, "kernels": lib,
                          "failed": failures(base), "readings": base}),
              flush=True)
        ok &= not failures(base)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(FAULTS)) as pool:
            built = dict(zip(FAULTS, pool.map(
                lambda n: _build_fault(n, Path(tmp)), FAULTS)))
        for name, path in built.items():
            lib = FAULTS[name][0]
            with _build.substituted(lib, _build.load(path, lib)):
                readings = check(lib)
            failed = failures(readings)
            ok &= bool(failed)
            coarse = any(r["max_abs_err"] > COARSE_TOL
                         * max(1.0, r["max_abs_want"])
                         for o, r in readings.items() if o != "lse")
            print(json.dumps({"fault": name, "caught": bool(failed),
                              "caught_by_coarse_rule": coarse,
                              "failed": failed, "readings": readings}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
