"""GroupNorm over NHWC activations: hand-written Hopper kernels
(``csrc/group_norm.cu``) for the forward and the backward, and the plain
PyTorch version of each beside them.

The forward gives ``y`` plus the mean and inverse standard deviation of each
(image, group); the backward gives ``dx`` plus per-image dγ/dβ partials,
which :class:`GroupNormFn` sums over the batch, as the JAX package's
``_gn2d_bwd`` does.  The JAX kernels hold one image's ``[hw, c]`` map in
VMEM and read it once; so do the Hopper kernels, in the shared memories of a
thread block cluster of ``k`` blocks per image (1.6 MB at the ResNet-50 stem
against 227 KB a block).  :func:`cluster_plan` picks ``k`` and how many rows
each block keeps resident; rows that do not fit are read again from device
memory.  The outputs match; the tiling does not.

The plain versions repeat the kernels' arithmetic and their rounding points
(the JAX kernels' too): ``x·x`` and ``dy·x`` in x's dtype before the fp32
sums, the per-channel coefficients ``p, q`` (forward) and ``p, q, r``
(backward) rounded to x's dtype, and ``y = x·p + q`` and
``dx = dy·p − x·q + r`` in x's dtype.  :func:`reference` is the JAX
package's ``_reference``: the fp32 math, which ResNet uses off the TPU.

Dispatch: on the card the kernels run at every call unless ``use_pallas``
is False or, when ``use_pallas`` is None, ``EDL_GN_PALLAS=0`` (read per call,
the JAX package's knob): then the plain versions run instead, an explicit
A/B.  A tensor on the CPU takes the plain versions.
"""

from __future__ import annotations

import ctypes
import os

import torch

from edl_tpu_torch.ops import _build

#: the kernels' limits: 8 channels per 16-byte vector of a thread, at most
#: 2048 channels; a block's 512 summing threads cover 512 / (c / 8) rows a
#: pass
KERNEL_MAX_CHANNELS = 2048
KERNEL_THREADS = 512
KERNEL_VEC = 8
#: bulk copies (each on its own mbarrier) a block splits its resident rows
#: into
KERNEL_PIECES = 8
#: dynamic shared memory one Hopper block may use (227 KB)
SMEM_BYTES = 232_448
#: the largest cluster :func:`cluster_plan` takes.  Past the portable 8,
#: only where 8 blocks cannot hold the image (the ResNet-50 backward's two
#: largest sites): on an H100 a cluster of 16 holding dy and x beat one of 8
#: holding dy and reading x again (PERF.md)
MAX_CLUSTER = 16

#: launches of each kernel since the last :func:`reset_launches`
launches = {"group_norm_fwd": 0, "group_norm_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- reference ---------------------------------------------------------------


def reference(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int, eps: float) -> torch.Tensor:
    """The JAX package's ``_reference``: single-pass statistics in fp32.
    x2d: [b, hw, c] → [b, hw, c] in x's dtype."""
    b, hw, c = x2d.shape
    g32 = x2d.reshape(b, hw, groups, c // groups).float()
    mean = g32.mean(dim=(1, 3), keepdim=True)
    mean2 = (g32 * g32).mean(dim=(1, 3), keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(mean2 - mean * mean, 0.0) + eps)
    y = ((g32 - mean) * inv).reshape(b, hw, c)
    return (y * scale.float() + bias.float()).to(x2d.dtype)


# -- plain versions of the kernels -------------------------------------------


def _per_channel(v_g: torch.Tensor, c: int) -> torch.Tensor:
    """[b, G] → [b, c]: each group's value on its c / G channels."""
    return v_g.repeat_interleave(c // v_g.shape[1], dim=1)


def _fold(v_c: torch.Tensor, groups: int) -> torch.Tensor:
    """[b, c] → [b, G]: the sum over each group's channels."""
    b, c = v_c.shape
    return v_c.view(b, groups, c // groups).sum(dim=-1)


def group_norm_fwd_plain(x2d, scale, bias, groups: int, eps: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel → (y [b, hw, c] in x's dtype,
    mean [b, G], inv [b, G] fp32)."""
    b, hw, c = x2d.shape
    n = float(hw * (c // groups))
    sum_c = x2d.sum(dim=1, dtype=torch.float32)
    sum2_c = (x2d * x2d).sum(dim=1, dtype=torch.float32)
    mean = _fold(sum_c, groups) / n
    mean2 = _fold(sum2_c, groups) / n
    inv = torch.rsqrt(torch.clamp_min(mean2 - mean * mean, 0.0) + eps)
    mean_c, inv_c = _per_channel(mean, c), _per_channel(inv, c)
    gamma = scale.float()
    p = (inv_c * gamma).to(x2d.dtype)
    q = (bias.float() - mean_c * inv_c * gamma).to(x2d.dtype)
    return x2d * p[:, None] + q[:, None], mean, inv


def group_norm_bwd_plain(x2d, dy, scale, mean, inv, groups: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel → (dx [b, hw, c] in x's dtype,
    dγ and dβ partials [b, c] fp32, one row per image)."""
    b, hw, c = x2d.shape
    n = float(hw * (c // groups))
    gamma = scale.float()
    mean_c, inv_c = _per_channel(mean, c), _per_channel(inv, c)
    a_c = dy.sum(dim=1, dtype=torch.float32)
    b_c = (dy * x2d).sum(dim=1, dtype=torch.float32)
    # dγ_c = Σ dy·x̂ = inv_c·(b_c − mean_c·a_c);  dβ_c = a_c
    dg = inv_c * (b_c - mean_c * a_c)
    s1 = _fold(gamma * a_c, groups)
    s2 = _fold(gamma * b_c, groups)
    m1_c = _per_channel(s1 / n, c)
    m2_c = _per_channel(inv * (s2 - mean * s1) / n, c)
    # dx = (dy·γ − m1 − x̂·m2)·inv ≡ dy·p − x·q + r
    p = (gamma * inv_c).to(x2d.dtype)[:, None]
    q = (inv_c * inv_c * m2_c).to(x2d.dtype)[:, None]
    r = ((mean_c * inv_c * m2_c - m1_c) * inv_c).to(x2d.dtype)[:, None]
    return dy * p - x2d * q + r, dg, a_c


# -- kernel wrappers ---------------------------------------------------------


def smem_overhead(c: int) -> int:
    """Shared-memory bytes of a block beside its resident rows: the row
    lanes' fp32 sums ``[lanes, c]`` of one sum at a time (later the block's
    partial row ``[c, 2]`` and the image's statistics) and the mbarriers
    (``csrc/group_norm.cu``)."""
    lanes = KERNEL_THREADS // (c // KERNEL_VEC)
    return 4 * max(lanes, 2) * c + 8 * KERNEL_PIECES


def cluster_plan(hw: int, c: int, itemsize: int, backward: bool,
                 max_k: int = MAX_CLUSTER) -> tuple[int, int, int]:
    """How the kernels cut one image ``[hw, c]`` of ``itemsize``-byte
    elements → ``(k, rows, resident)``: a cluster of ``k`` blocks, block
    ``r`` owning rows ``[r·rows, (r + 1)·rows)``, of which the first
    ``resident`` stay in its shared memory.  The backward holds dy and x:
    its ``resident`` counts dy's rows first, then x's, up to ``2·rows``.

    ``k`` is the smallest power of two up to ``max_k`` at which a block's
    rows fit :data:`SMEM_BYTES` of shared memory; past ``max_k``, each
    block keeps what fits and reads the rest again."""
    tensors = 2 if backward else 1
    room = (SMEM_BYTES - smem_overhead(c)) // (c * itemsize)
    k = 1
    while k < max_k and tensors * -(-hw // k) > room:
        k *= 2
    rows = -(-hw // k)
    return k, rows, min(tensors * rows, room)


def _check_kernel_inputs(x2d, groups: int, *others) -> None:
    if x2d.dim() != 3:
        raise ValueError(f"group norm kernel takes [b, hw, c], got "
                         f"{tuple(x2d.shape)}")
    b, hw, c = x2d.shape
    if x2d.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group norm kernel takes bf16 or fp32, got "
                         f"{x2d.dtype}")
    if c % groups or c % KERNEL_VEC or not 0 < c <= KERNEL_MAX_CHANNELS:
        raise ValueError(f"group norm kernel takes c % {KERNEL_VEC} == 0, "
                         f"c <= {KERNEL_MAX_CHANNELS} and c % groups == 0; "
                         f"got c={c}, groups={groups}")
    if b == 0 or hw == 0 or b > 65535:
        raise ValueError(f"group norm kernel takes 0 < b <= 65535 and hw > 0,"
                         f" got b={b}, hw={hw}")
    for t in (x2d, *others):
        if t.device != x2d.device:
            raise ValueError("group norm kernel inputs must share one CUDA "
                             "device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("group norm kernel inputs must be contiguous "
                             "and 16-byte aligned")


def _check_params(c: int, *params) -> None:
    for t in params:
        if t.dtype != torch.float32 or t.shape != (c,):
            raise ValueError(f"group norm kernel takes fp32 [{c}] scale and "
                             f"bias, got {t.dtype} {tuple(t.shape)}")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    launches[name] += 1


def _plan(x2d, backward: bool, plan) -> tuple[int, int, int]:
    _, hw, c = x2d.shape
    return plan or cluster_plan(hw, c, x2d.element_size(), backward)


def group_norm_fwd_cuda(x2d, scale, bias, groups: int, eps: float,
                        plan: tuple[int, int, int] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel → (y, mean [b, G], inv [b, G]), cut as
    ``plan`` (k, rows, resident) says, by default :func:`cluster_plan`."""
    _check_kernel_inputs(x2d, groups, scale, bias)
    b, hw, c = x2d.shape
    _check_params(c, scale, bias)
    k, rows, resident = _plan(x2d, False, plan)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    y = torch.empty_like(x2d)
    mean = torch.empty(b, groups, **f32)
    inv = torch.empty(b, groups, **f32)
    lib = _build.library("group_norm")
    with torch.cuda.device(x2d.device):
        _launch("group_norm_fwd", lib.edl_group_norm_fwd,
                *map(torch.Tensor.data_ptr, (x2d, scale, bias, y, mean, inv)),
                b, hw, c, groups, k, rows, resident,
                int(x2d.dtype == torch.bfloat16), eps,
                torch.cuda.current_stream(x2d.device).cuda_stream)
    return y, mean, inv


def group_norm_bwd_cuda(x2d, dy, scale, mean, inv, groups: int,
                        plan: tuple[int, int, int] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel → (dx, dγ partials [b, c], dβ partials
    [b, c]), cut as ``plan`` says, by default :func:`cluster_plan`."""
    _check_kernel_inputs(x2d, groups, dy, scale, mean, inv)
    b, hw, c = x2d.shape
    _check_params(c, scale)
    if dy.shape != x2d.shape or dy.dtype != x2d.dtype:
        raise ValueError("dy must have x's shape and dtype")
    for t in (mean, inv):
        if t.dtype != torch.float32 or t.shape != (b, groups):
            raise ValueError(f"mean/inv must be fp32 [{b}, {groups}]")
    k, rows, resident = _plan(x2d, True, plan)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    dx = torch.empty_like(x2d)
    dg = torch.empty(b, c, **f32)
    db = torch.empty(b, c, **f32)
    lib = _build.library("group_norm")
    with torch.cuda.device(x2d.device):
        _launch("group_norm_bwd", lib.edl_group_norm_bwd,
                *map(torch.Tensor.data_ptr,
                     (x2d, dy, scale, mean, inv, dx, dg, db)),
                b, hw, c, groups, k, rows, resident,
                int(x2d.dtype == torch.bfloat16),
                torch.cuda.current_stream(x2d.device).cuda_stream)
    return dx, dg, db


def active_clusters(c: int, dtype: torch.dtype, backward: bool,
                    plan: tuple[int, int, int],
                    device: torch.device | None = None) -> int:
    """Clusters of ``plan`` the card runs at once for a kernel of ``c``
    channels (``cudaOccupancyMaxActiveClusters``); raises if the card
    cannot run one."""
    k, _, resident = plan
    lib = _build.library("group_norm")
    n = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = lib.edl_group_norm_active_clusters(
            int(backward), int(dtype == torch.bfloat16), c, k, resident,
            ctypes.byref(n))
    if err:
        raise RuntimeError(f"group norm occupancy query failed: cudaError_t "
                           f"{err}")
    return n.value


# -- dispatch ----------------------------------------------------------------


def _use_kernel(x: torch.Tensor, use_pallas: bool | None) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    if use_pallas is None:
        use_pallas = os.environ.get("EDL_GN_PALLAS", "1") != "0"
    return use_pallas and x.is_cuda


class GroupNormFn(torch.autograd.Function):
    """[b, hw, c] GroupNorm whose gradient is the backward kernel (or, off
    the kernel path, its plain version)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, groups: int, eps: float,
                kernel: bool):
        fwd = group_norm_fwd_cuda if kernel else group_norm_fwd_plain
        y, mean, inv = fwd(x2d, scale, bias, groups, eps)
        ctx.save_for_backward(x2d, scale, mean, inv)
        ctx.groups, ctx.kernel = groups, kernel
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, scale, mean, inv = ctx.saved_tensors
        bwd = group_norm_bwd_cuda if ctx.kernel else group_norm_bwd_plain
        # autograd hands the ResNet sites contiguous gradients; this is a
        # no-op there
        dx, dg_b, db_b = bwd(x2d, dy.contiguous(), scale, mean, inv,
                             ctx.groups)
        return dx, dg_b.sum(dim=0), db_b.sum(dim=0), None, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5,
               use_pallas: bool | None = None) -> torch.Tensor:
    """GroupNorm over NHWC ``x`` [b, h, w, c] with fp32 per-channel
    ``scale``/``bias`` → [b, h, w, c] in x's dtype.

    ``use_pallas`` keeps the JAX package's name for "use the kernels"; None
    reads ``EDL_GN_PALLAS`` (anything but "0" means yes).  A CUDA tensor on
    the kernel path launches the kernels or raises; off it, and on the CPU,
    the plain versions run.  ``x`` must be viewable as [b, h·w, c] (NHWC
    contiguous): the norm makes no hidden copy."""
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    x2d = x.view(b, h * w, c)
    y = GroupNormFn.apply(x2d, scale, bias, groups, eps,
                          _use_kernel(x, use_pallas))
    return y.view(b, h, w, c)
