"""Decoder transformer core (Llama-family): RMSNorm, RoPE, GQA attention,
SwiGLU MLP — the port of edl_tpu.models.transformer.

The parameters keep the JAX tree's names (``embed``, ``layers.{i}.wq``, …,
``norm``, ``lm_head``) and its ``[in, out]`` orientation (``x @ W``, not
``nn.Linear``'s ``[out, in]``), so weights carry across unchanged
(:mod:`edl_tpu_torch.interop`).  Parameters live in fp32; compute runs in
``cfg.dtype``.  Attention goes through :func:`edl_tpu_torch.ops.attention`:
the hand-written flash kernels on the card when ``use_flash`` is set.

Inside a tp context (:mod:`edl_tpu_torch.parallel.tensor_parallel`, which
the trainer enters for a model placed by :func:`param_partition_specs` on a
mesh with tp > 1) the functions run on this rank's blocks, as the
reference's do under GSPMD: the head counts are read from the blocks'
shapes (``h/tp`` query and ``kv/tp`` kv heads, the contiguous columns that
keep GQA's grouping), each block's normed input goes through
``copy_to_tp`` and its wo and w2 outputs through ``reduce_from_tp``, the
embedding and the loss are vocab-parallel, and :func:`apply` returns this
rank's columns of the logits.

Inside an sp context (:mod:`edl_tpu_torch.parallel.ring_attention`, which
the trainer enters on a mesh with sp > 1) :func:`apply` takes the whole
sequence, keeps this rank's contiguous chunk of it (RoPE at the chunk's
global positions), and attention rings the k/v chunks over the sp group:
the flash ring when ``use_flash`` is set and the tensors are on the card,
the plain ring on repeated kv heads otherwise, as the reference routes on
an sp mesh.  :func:`apply` then returns this rank's chunk of the logits
and :func:`loss_fn` the mean over that chunk's tokens; the chunks are
equal, so the trainer's mean over the sp ranks is the global mean.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from edl_tpu_torch.device import resolve
from edl_tpu_torch.ops.embedding import embed_lookup
from edl_tpu_torch.ops.flash_attention import attention as flash_attention
from edl_tpu_torch.parallel import ring_attention as ring
from edl_tpu_torch.parallel import tensor_parallel as tpar


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8  # GQA (Llama-3 style)
    d_ff: int = 14_336  # SwiGLU hidden
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params live in fp32
    use_flash: bool = True
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = True
    # "full" recomputes the whole block; "dots" saves the matmul outputs and
    # recomputes the rest (the JAX package's dots_with_no_batch_dims_saveable)
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', "
                f"got {self.remat_policy!r}")
    # True for a vocab-sharded table; False (gather) on one device
    one_hot_embed: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# Llama-3-8B-class config
LLAMA3_8B = TransformerConfig()

# Tiny config for tests
TINY = TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32, use_flash=False,
    remat=False,
)

#: The flagship: GQA 4:1 (8 query heads / 2 kv heads), head_dim 128,
#: ~155 M params.  ``use_flash`` is decided at use (on for the card).
FLAGSHIP = TransformerConfig(
    vocab_size=16_384, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=2,
    d_ff=4096, max_seq_len=1024, dtype=torch.bfloat16, use_flash=False,
    remat=False,
)

#: The large single-device config (~0.6 B params, GQA 4:1, remat on).
LARGE = TransformerConfig(
    vocab_size=32_768, d_model=2048, n_layers=8, n_heads=16, n_kv_heads=4,
    d_ff=8192, max_seq_len=1024, dtype=torch.bfloat16, use_flash=False,
    remat=True,
)


# -- parameters --------------------------------------------------------------


class Layer(nn.Module):
    """One block's parameters, named as in the JAX tree."""

    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff)

        def dense(shape, fan_in):
            w = torch.randn(shape, generator=gen, device=device)
            return nn.Parameter(w * (2.0 / fan_in) ** 0.5)

        self.attn_norm = nn.Parameter(torch.ones(d, device=device))
        self.wq = dense((d, h * hd), d)
        self.wk = dense((d, kv * hd), d)
        self.wv = dense((d, kv * hd), d)
        self.wo = dense((h * hd, d), h * hd)
        self.mlp_norm = nn.Parameter(torch.ones(d, device=device))
        self.w1 = dense((d, ff), d)  # gate
        self.w3 = dense((d, ff), d)  # up
        self.w2 = dense((ff, d), ff)  # down


class Transformer(nn.Module):
    """The decoder's parameters (fp32), initialized from ``seed`` with a
    ``torch.Generator`` on ``device``; ``forward`` is :func:`apply`.  On
    the ``meta`` device the parameters have shapes and no storage (what a
    memory plan reads)."""

    def __init__(self, cfg: TransformerConfig, device="cuda",
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                        device=dev) * 0.02)
        self.layers = nn.ModuleList(
            Layer(cfg, dev, gen) for _ in range(cfg.n_layers))
        self.norm = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        self.lm_head = nn.Parameter(
            torch.randn(cfg.d_model, cfg.vocab_size, generator=gen,
                        device=dev) * (2.0 / cfg.d_model) ** 0.5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self, tokens)


# -- sharding rules ----------------------------------------------------------


def param_partition_specs(cfg: TransformerConfig) -> dict[str, tuple]:
    """The reference's partition specs, by parameter name: for each
    dimension the mesh axis it is sharded over, or None.

    Column-parallel (output dim over tp): wq/wk/wv, w1/w3.  Row-parallel
    (input dim over tp): wo, w2.  The fsdp axis shards the other dim
    (ZeRO-3); embed and lm_head shard vocab over tp."""
    layer = {
        "attn_norm": (None,),
        "wq": ("fsdp", "tp"),
        "wk": ("fsdp", "tp"),
        "wv": ("fsdp", "tp"),
        "wo": ("tp", "fsdp"),
        "mlp_norm": (None,),
        "w1": ("fsdp", "tp"),
        "w3": ("fsdp", "tp"),
        "w2": ("tp", "fsdp"),
    }
    specs = {"embed": ("tp", "fsdp")}
    for i in range(cfg.n_layers):
        specs.update((f"layers.{i}.{k}", v) for k, v in layer.items())
    specs.update(norm=(None,), lm_head=("fsdp", "tp"))
    return specs


def batch_partition_spec() -> tuple:
    """[batch, seq] inputs: batch over dp+fsdp, sequence over sp."""
    return (("dp", "fsdp"), "sp")


# -- building blocks ---------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight).to(orig)


def rope_freqs(cfg: TransformerConfig, positions: torch.Tensor
               ) -> torch.Tensor:
    """[seq, head_dim/2] rotation angles."""
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32,
                        device=positions.device) / cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** exps)
    return torch.einsum("s,d->sd", positions.float(), inv)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [b, s, heads, head_dim]; angles: [s, head_dim/2].  Half-split
    (not interleaved) rotation, in fp32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _local_heads(p: Layer, cfg: TransformerConfig,
                 tp: "tpar.TPContext | None") -> tuple[int, int]:
    """The query and kv heads of ``p``'s blocks (all of them outside a tp
    context).  Query heads ``[i·h/tp, (i+1)·h/tp)`` keep their kv heads
    ``[i·kv/tp, …)`` only when tp divides the kv heads."""
    if tp is not None and cfg.n_kv_heads % tp.size:
        raise ValueError(f"tp {tp.size} does not divide the model's "
                         f"{cfg.n_kv_heads} kv heads: GQA's query groups "
                         "would straddle two ranks")
    return p.wq.shape[1] // cfg.head_dim, p.wk.shape[1] // cfg.head_dim


def _attention_block(p: Layer, x: torch.Tensor, angles: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    b, s, _ = x.shape
    tp = tpar.current()
    (h, kv), hd = _local_heads(p, cfg, tp), cfg.head_dim
    dt = cfg.dtype
    xn = rms_norm(x, p.attn_norm, cfg.norm_eps)
    if tp is not None:
        xn = tpar.copy_to_tp(xn, tp)
    q = (xn @ p.wq.to(dt)).reshape(b, s, h, hd)
    k = (xn @ p.wk.to(dt)).reshape(b, s, kv, hd)
    v = (xn @ p.wv.to(dt)).reshape(b, s, kv, hd)
    q = apply_rope(q, angles).to(dt)
    k = apply_rope(k, angles).to(dt)
    sp = ring.current()
    if sp is not None and sp.size > 1:
        # long context: the sequence is split over sp and attention rings
        # the k/v chunks; the flash ring on the card (GQA unrepeated), the
        # plain ring on matched heads elsewhere
        if cfg.use_flash and q.is_cuda:
            o = ring.ring_flash_attention_sharded(q, k, v, causal=True,
                                                  sp=sp)
        else:
            if kv != h:
                k = k.repeat_interleave(h // kv, dim=2)
                v = v.repeat_interleave(h // kv, dim=2)
            o = ring.ring_attention_sharded(q, k, v, causal=True, sp=sp)
    else:
        # GQA: the flash path takes the unrepeated kv heads
        o = flash_attention(q, k, v, causal=True, use_pallas=cfg.use_flash)
    out = o.reshape(b, s, h * hd) @ p.wo.to(dt)
    if tp is not None:
        out = tpar.reduce_from_tp(out, tp)
    return x + out


def _mlp_block(p: Layer, x: torch.Tensor, cfg: TransformerConfig
               ) -> torch.Tensor:
    tp = tpar.current()
    dt = cfg.dtype
    xn = rms_norm(x, p.mlp_norm, cfg.norm_eps)
    if tp is not None:
        xn = tpar.copy_to_tp(xn, tp)
    gate = F.silu(xn @ p.w1.to(dt))
    up = xn @ p.w3.to(dt)
    out = (gate * up) @ p.w2.to(dt)
    if tp is not None:
        out = tpar.reduce_from_tp(out, tp)
    return x + out


def _block(p: Layer, x: torch.Tensor, angles: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    return _mlp_block(p, _attention_block(p, x, angles, cfg), cfg)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat_policy="dots": keep the
    unbatched matmul outputs, recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [b, s] int → logits [b, s, vocab] (fp32); in a tp context,
    this rank's ``vocab/tp`` columns of them; in an sp context, this rank's
    chunk of the sequence, ``[b, s/sp, …]``."""
    cfg = model.cfg
    tp = tpar.current()
    sp = ring.current()
    start = 0
    if sp is not None and sp.size > 1:
        tokens = ring.local_chunk(tokens, sp)
        start = sp.rank * tokens.shape[1]
    if tp is None:
        x = embed_lookup(model.embed, tokens, one_hot=cfg.one_hot_embed,
                         dtype=cfg.dtype)
    else:
        x = tpar.vocab_parallel_embed(model.embed, tokens, tp,
                                      one_hot=cfg.one_hot_embed,
                                      dtype=cfg.dtype)
    angles = rope_freqs(cfg, torch.arange(start, start + tokens.shape[1],
                                          device=tokens.device))
    for p in model.layers:
        if cfg.remat:
            kw = {}
            if cfg.remat_policy == "dots":
                kw["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts, _save_dots)
            x = checkpoint(_block, p, x, angles, cfg, use_reentrant=False,
                           **kw)
        else:
            x = _block(p, x, angles, cfg)
    x = rms_norm(x, model.norm, cfg.norm_eps)
    if tp is not None:
        x = tpar.copy_to_tp(x, tp)
    return (x @ model.lm_head.to(cfg.dtype)).float()


def loss_fn(model: Transformer, batch: tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross entropy; batch = (tokens[b,s], targets[b,s]).

    logsumexp(logits) − logits[target], as in the JAX package: the
    [b, s, vocab] log-probabilities never materialize.  In a tp context
    the logits are this rank's columns and the loss vocab-parallel; in an
    sp context the mean is over this rank's chunk of the tokens."""
    tokens, targets = batch
    logits = apply(model, tokens)
    sp = ring.current()
    if sp is not None and sp.size > 1:
        targets = ring.local_chunk(targets, sp)
    tp = tpar.current()
    if tp is not None:
        return tpar.vocab_parallel_cross_entropy(logits, targets, tp)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()
