"""BERT-base-class bidirectional encoder with an MLM objective — the port
of edl_tpu.models.bert.

Pre-LN blocks (RMSNorm, as the JAX package has them) with learned position
embeddings and non-causal multi-head attention through
:func:`edl_tpu_torch.ops.attention` (the hand-written flash kernels on the
card when ``use_flash`` is set).  The parameters keep the JAX tree's names
(``embed``, ``pos``, ``layers.{i}.wq``, …, ``norm``) and its ``[in, out]``
orientation, live in fp32 and compute in ``cfg.dtype``; the MLM decoder is
the tied embedding.  The JAX package's sharding constraints are no-ops on
one device and are left out; :func:`param_partition_specs` gives the
reference's per-parameter specs.

Inside a tp context (:mod:`edl_tpu_torch.parallel.tensor_parallel`, which
the trainer enters for a model placed by :func:`param_partition_specs` on a
mesh with tp > 1) the functions run on this rank's blocks, as the
transformer's do: the head count is read from the blocks' width (``h/tp``
heads), each block's normed input goes through ``copy_to_tp`` and its wo
and w2 outputs through ``reduce_from_tp``, the token embedding is
vocab-parallel (``pos`` stays whole), and the tied decoder gives this
rank's vocabulary columns of the logits, which the masked loss takes
vocab-parallel.  tp must divide the heads and the vocabulary.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from edl_tpu_torch.device import resolve
from edl_tpu_torch.models.transformer import rms_norm
from edl_tpu_torch.ops.embedding import embed_lookup
from edl_tpu_torch.ops.flash_attention import attention
from edl_tpu_torch.parallel import tensor_parallel as tpar


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    use_flash: bool = True
    # True for a vocab-sharded table; False (gather) on one device
    one_hot_embed: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


BERT_BASE = BertConfig()
#: the same parameters and FLOPs as BERT-base with 6 heads of 128
BERT_BASE_TPU = BertConfig(n_heads=6)
TINY = BertConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                  d_ff=128, max_seq_len=64, dtype=torch.float32,
                  use_flash=False)


class Layer(nn.Module):
    """One block's parameters, named as in the JAX tree."""

    def __init__(self, cfg: BertConfig, device: torch.device,
                 gen: torch.Generator) -> None:
        super().__init__()
        d, hd, ff = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff

        def dense(shape, fan_in):
            w = torch.randn(shape, generator=gen, device=device)
            return nn.Parameter(w * (2.0 / fan_in) ** 0.5)

        self.attn_norm = nn.Parameter(torch.ones(d, device=device))
        self.wq = dense((d, hd), d)
        self.wk = dense((d, hd), d)
        self.wv = dense((d, hd), d)
        self.wo = dense((hd, d), hd)
        self.mlp_norm = nn.Parameter(torch.ones(d, device=device))
        self.w1 = dense((d, ff), d)
        self.w2 = dense((ff, d), ff)


class Bert(nn.Module):
    """The encoder's parameters (fp32), initialized from ``seed`` with a
    ``torch.Generator`` on ``device``; ``forward`` is :func:`apply`."""

    def __init__(self, cfg: BertConfig, device="cuda", seed: int = 0) -> None:
        super().__init__()
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                        device=dev) * 0.02)
        self.pos = nn.Parameter(
            torch.randn(cfg.max_seq_len, cfg.d_model, generator=gen,
                        device=dev) * 0.02)
        self.layers = nn.ModuleList(
            Layer(cfg, dev, gen) for _ in range(cfg.n_layers))
        self.norm = nn.Parameter(torch.ones(cfg.d_model, device=dev))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self, tokens)


def param_partition_specs(cfg: BertConfig) -> dict[str, tuple]:
    """The reference's partition specs, by parameter name: for each
    dimension the mesh axis it is sharded over, or None (the transformer's
    rules; ``pos`` is replicated)."""
    layer = {
        "attn_norm": (None,), "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
        "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp"), "mlp_norm": (None,),
        "w1": ("fsdp", "tp"), "w2": ("tp", "fsdp"),
    }
    specs = {"embed": ("tp", "fsdp"), "pos": (None, None)}
    for i in range(cfg.n_layers):
        specs.update((f"layers.{i}.{k}", v) for k, v in layer.items())
    specs["norm"] = (None,)
    return specs


def _check_tp(cfg: BertConfig, tp: "tpar.TPContext | None") -> None:
    """A tp that does not divide the heads or the vocabulary is refused:
    its blocks would split a head, or its vocabulary rows would not be
    the embedding's contiguous equal blocks."""
    if tp is None:
        return
    for what, n in (("heads", cfg.n_heads), ("vocabulary of",
                                              cfg.vocab_size)):
        if n % tp.size:
            raise ValueError(f"tp {tp.size} does not divide the model's "
                             f"{what} {n}")


def _attention_block(p: Layer, x: torch.Tensor, cfg: BertConfig,
                     tp: "tpar.TPContext | None") -> torch.Tensor:
    b, s, _ = x.shape
    dt, hd = cfg.dtype, cfg.head_dim
    h = p.wq.shape[1] // hd  # h/tp on a tp rank's column block
    xn = rms_norm(x, p.attn_norm, cfg.norm_eps)
    if tp is not None:
        xn = tpar.copy_to_tp(xn, tp)
    q = (xn @ p.wq.to(dt)).reshape(b, s, h, hd)
    k = (xn @ p.wk.to(dt)).reshape(b, s, h, hd)
    v = (xn @ p.wv.to(dt)).reshape(b, s, h, hd)
    o = attention(q, k, v, causal=False, use_pallas=cfg.use_flash)
    out = o.reshape(b, s, h * hd) @ p.wo.to(dt)
    if tp is not None:
        out = tpar.reduce_from_tp(out, tp)
    return x + out


def _mlp_block(p: Layer, x: torch.Tensor, cfg: BertConfig,
               tp: "tpar.TPContext | None") -> torch.Tensor:
    dt = cfg.dtype
    xn = rms_norm(x, p.mlp_norm, cfg.norm_eps)
    if tp is not None:
        xn = tpar.copy_to_tp(xn, tp)
    # jax.nn.gelu defaults to the tanh approximation
    out = F.gelu(xn @ p.w1.to(dt), approximate="tanh") @ p.w2.to(dt)
    if tp is not None:
        out = tpar.reduce_from_tp(out, tp)
    return x + out


def apply(model: Bert, tokens: torch.Tensor,
          cfg: BertConfig | None = None) -> torch.Tensor:
    """tokens [b, s] → contextual embeddings [b, s, d] in ``cfg.dtype``;
    ``cfg`` (default: the model's own) as the JAX package passes it.  In a
    tp context the embeddings are whole on every rank of the tp group."""
    cfg = cfg or model.cfg
    tp = tpar.current()
    _check_tp(cfg, tp)
    s = tokens.shape[1]
    dt = cfg.dtype
    if tp is None:
        x = embed_lookup(model.embed, tokens, one_hot=cfg.one_hot_embed,
                         dtype=dt)
    else:
        x = tpar.vocab_parallel_embed(model.embed, tokens, tp,
                                      one_hot=cfg.one_hot_embed, dtype=dt)
    x = x + model.pos[:s].to(dt)[None]
    for p in model.layers:
        x = _mlp_block(p, _attention_block(p, x, cfg, tp), cfg, tp)
    return rms_norm(x, model.norm, cfg.norm_eps)


def mlm_loss_fn(model: Bert, batch, cfg: BertConfig | None = None
                ) -> torch.Tensor:
    """batch = (masked_tokens [b, s], targets [b, s], mask [b, s] 0/1).

    Cross entropy over the masked positions only, with the tied embedding
    as the decoder, in logsumexp − target-logit form: ``Σ mask · (lse −
    tgt) / max(Σ mask, 1)`` over the global batch (the denominator from
    :func:`~edl_tpu_torch.parallel.tensor_parallel.weight_total`, so a
    batch split over data ranks weighs as the whole).  In a tp context the
    logits are this rank's vocabulary columns and the loss vocab-parallel."""
    masked, targets, mask = batch
    hdn = apply(model, masked, cfg)
    tp = tpar.current()
    if tp is not None:
        hdn = tpar.copy_to_tp(hdn, tp)
    logits = (hdn @ model.embed.to(hdn.dtype).T).float()
    mask = mask.float()
    denom = tpar.weight_total(mask)
    if tp is not None:
        return tpar.vocab_parallel_cross_entropy(logits, targets, tp,
                                                 weights=mask, denom=denom)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return ((lse - tgt) * mask).sum() / denom


def make_loss_fn(cfg: BertConfig):
    return functools.partial(mlm_loss_fn, cfg=cfg)
