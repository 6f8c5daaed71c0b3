"""Flash attention: hand-written Hopper kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) for the forward, the dQ pass and the dK/dV pass, and
the plain PyTorch version of each beside it.

The kernels never materialize the [s, s] score matrix in device memory: the
forward streams K/V tiles with an online softmax and saves the per-row
logsumexp, and the two backward kernels rebuild the probabilities tile by
tile from it.  GQA is native: K/V keep their ``hk`` heads and every kernel
reads the kv head of a query head through :func:`_kv_head_map`.

Dispatch: a tensor on the card launches the kernel (or raises on what the
kernel does not take); a tensor on the CPU takes the plain version.  The
plain versions repeat the kernels' arithmetic on whole matrices, with bf16
rounding at the same points, and are what the CPU tests hold against the
JAX package and what ``chip_smoke.py`` holds the kernels against.

Layouts: :func:`attention` takes ``[b, s, h, d]`` like the JAX package; the
kernels and :func:`flash_forward` / :func:`flash_backward` take heads folded
into the batch, q ``[b·h, s, d]`` and k/v ``[b·hk, s, d]``, with the
logsumexp as ``[b·h, s]`` fp32.
"""

from __future__ import annotations

import torch

from edl_tpu_torch.ops import _build

#: the JAX package's TPU block sizes, kept for :func:`fit_blocks` (which
#: decides eligibility exactly as the JAX dispatch does); the Hopper kernels
#: use tiles of their own
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
#: the sequence length each kernel takes is a multiple of its tile: the
#: forward's 128-row q and k tiles (``kBQ``, ``kBK`` in csrc/flash_fwd.cu),
#: dQ's 128-row q tiles (``dq::kBQ`` in csrc/flash_bwd.cu; its K/V tiles
#: are 64 keys) and dK/dV's 128-key blocks (``dkv::kBK`` there)
KERNEL_TILES = {"flash_fwd": 128, "flash_bwd_dq": 128, "flash_bwd_dkv": 128}
KERNEL_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30

#: launches of each kernel since the last :func:`reset_launches` — what
#: shows that a run went through the kernels
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def fit_blocks(s: int, block_q: int = DEFAULT_BLOCK_Q,
               block_k: int = DEFAULT_BLOCK_K) -> tuple[int, int]:
    """Clamp the block sizes to the sequence, then halve each toward a
    divisor of ``s`` (floor 128) — the JAX package's shape adaptation."""
    bq, bk = min(block_q, s), min(block_k, s)
    while bq > 128 and s % bq:
        bq //= 2
    while bk > 128 and s % bk:
        bk //= 2
    return bq, bk


def _kv_head_map(h: int, hk: int):
    """Folded-q index [b·h] → folded-kv index [b·hk]."""
    rep = h // hk
    return lambda bh: (bh // h) * hk + (bh % h) // rep


# -- reference ---------------------------------------------------------------


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v: [b, s, h, d] (matched heads) → [b, s, h, d]; fp32 softmax."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# -- plain versions of the kernels -------------------------------------------


def _expand_kv(x: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    """[b·hk, s, d] → [b·h, s, d] through the kv-head map (plain versions
    only: the kernels never form it)."""
    bh = x.shape[0] // hk * h
    idx = _kv_head_map(h, hk)(torch.arange(bh, device=x.device))
    return x.index_select(0, idx)


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """Masked, scaled QKᵀ in fp32 (``_block_scores`` on whole matrices)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n = q.shape[1]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_forward_plain(q, k, v, causal: bool, h: int, hk: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel → (out [b·h, s, d], lse [b·h, s])."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, _expand_kv(k, h, hk), causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _expand_kv(v, h, hk).float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, h: int,
                       hk: int) -> torch.Tensor:
    """Plain version of the dQ kernel → dq [b·h, s, d]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    ke, ve = _expand_kv(k, h, hk), _expand_kv(v, h, hk)
    p = torch.exp(_scores(q, ke, causal, scale) - lse[..., None])
    dp = torch.matmul(do.float(), ve.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype)
    return torch.matmul(ds.float(), ke.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, h: int,
                        hk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel → (dk, dv) [b·hk, s, d], each
    summed over the h / hk query heads of its group."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    ke, ve = _expand_kv(k, h, hk), _expand_kv(v, h, hk)
    p = torch.exp(_scores(q, ke, causal, scale) - lse[..., None]).to(do.dtype)
    dv = torch.matmul(p.float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), ve.float().transpose(-1, -2))
    ds = (p.float() * (dp - delta[..., None]) * scale).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    bkh, s, d = k.shape
    fold = lambda x: x.reshape(bkh, h // hk, s, d).sum(dim=1)  # noqa: E731
    return fold(dk).to(k.dtype), fold(dv).to(v.dtype)


# -- kernel wrappers ---------------------------------------------------------


def _check_kernel_inputs(kernel: str, q, k, v, h: int, hk: int,
                         *extra) -> None:
    bh, s, d = q.shape
    if h % hk or bh % h:
        raise ValueError(f"folded q batch {bh} does not hold heads h={h}, "
                         f"hk={hk}")
    if k.shape != (bh // h * hk, s, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} with h={h}, hk={hk}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS},"
                         f" got {d}")
    tile = KERNEL_TILES[kernel]
    if s % tile:
        raise ValueError(f"{kernel} kernel needs s % {tile} == 0, got {s}")
    if bh > 65535 or bh * s >= 2 ** 31:
        raise ValueError(f"folded batch {bh} x s {s} exceeds the kernel grid"
                         " or the TMA row coordinates")
    for x in (q, k, v, *extra):
        if x.device != q.device:
            raise ValueError("flash kernel inputs must share one CUDA device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash kernel inputs must be contiguous and "
                             "16-byte aligned")
    for x in (q, k, v) + tuple(x for x in extra if x.dim() == 3):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bf16, got {x.dtype}")
    for x in extra:
        if x.dim() == 2 and (x.dtype != torch.float32 or x.shape != (bh, s)):
            raise ValueError("lse/delta must be fp32 [b·h, s]")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_forward_cuda(q, k, v, causal: bool, h: int, hk: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel → (out [b·h, s, d] bf16, lse [b·h, s])."""
    _check_kernel_inputs("flash_fwd", q, k, v, h, hk)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.edl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, s, d, h, hk, int(causal), d ** -0.5,
            _stream(q))
    _raise_on(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, h: int,
                      hk: int) -> torch.Tensor:
    """Launch the dQ kernel → dq [b·h, s, d] bf16."""
    _check_kernel_inputs("flash_bwd_dq", q, k, v, h, hk, do, lse, delta)
    if do.shape != q.shape:
        raise ValueError("dO must have q's shape")
    bh, s, d = q.shape
    dq = torch.empty_like(q)
    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.edl_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d, h, hk,
            int(causal), d ** -0.5, _stream(q))
    _raise_on(err, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, h: int,
                       hk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel → (dk, dv) [b·hk, s, d] bf16."""
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, h, hk, do, lse, delta)
    if do.shape != q.shape:
        raise ValueError("dO must have q's shape")
    bh, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.edl_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, s, d, h, hk, int(causal), d ** -0.5, _stream(q))
    _raise_on(err, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


# -- dispatch ----------------------------------------------------------------


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, not {x.device}")


def flash_forward(q, k, v, causal: bool, h: int, hk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Folded forward → (out, lse): the kernel on the card, the plain
    version on the CPU."""
    if _on_card(q):
        return flash_forward_cuda(q, k, v, causal, h, hk)
    return flash_forward_plain(q, k, v, causal, h, hk)


def flash_backward(q, k, v, out, lse, do, causal: bool, h: int, hk: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Folded backward from the forward's (out, lse) → (dq, dk, dv)."""
    # delta = rowsum(dO ∘ O): an elementwise pass outside the kernels, as
    # the JAX package leaves it to XLA
    delta = (do.float() * out.float()).sum(dim=-1)
    if _on_card(q):
        do = do.contiguous()
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, h, hk)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, h, hk)
    else:
        dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, h, hk)
        dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, h, hk)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Folded flash attention whose gradient is the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, h: int, hk: int):
        out, lse = flash_forward(q, k, v, causal, h, hk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.h, ctx.hk = causal, h, hk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, ctx.causal,
                                    ctx.h, ctx.hk)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, use_pallas: bool = True) -> torch.Tensor:
    """Multi-head attention, q: [b, s, h, d], k/v: [b, s, hk, d] with
    hk | h → [b, s, h, d].

    ``use_pallas`` keeps the JAX package's name for "use the flash
    kernels".  Eligible shapes (s a multiple of 128, as in JAX) take the
    flash path — the kernels on the card, their plain versions on the CPU;
    other shapes take :func:`reference_attention` on repeated kv heads."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    if h % hk != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    if v.shape[2] != hk:
        raise ValueError(f"k has {hk} heads but v has {v.shape[2]}")
    block_q, block_k = fit_blocks(s)
    eligible = (use_pallas and s % 128 == 0 and s % block_q == 0
                and s % block_k == 0)
    if not eligible:
        if hk != h:
            k = k.repeat_interleave(h // hk, dim=2)
            v = v.repeat_interleave(h // hk, dim=2)
        return reference_attention(q, k, v, causal=causal)

    def fold(x):
        return x.transpose(1, 2).reshape(-1, s, d).contiguous()

    out = FlashAttention.apply(fold(q), fold(k), fold(v), causal, h, hk)
    return out.reshape(b, h, s, d).transpose(1, 2)
