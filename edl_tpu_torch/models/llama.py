"""Llama-family autoregressive serving surface over a paged KV cache — the
port of edl_tpu.models.llama.

* :func:`prefill` runs one fixed-size **chunk** of a session's prompt,
  writing each token's K/V into the session's cache blocks and attending
  to everything already cached.
* :func:`decode_step` runs one token for every live slot of the fixed
  decode batch: each slot's paged context is gathered through its block
  table, the new token's K/V appended, next-token logits returned.
* :func:`verify_step` runs up to ``K`` tokens a slot in one batched
  forward, for speculative decoding.

The cache is **block-paged**: ``{"k", "v"}``, each ``[n_layers,
num_blocks, block_size, n_kv_heads, head_dim]`` (int8 with per-row
``k_scale``/``v_scale`` when quantized).  A session owns a list of blocks,
named by a ``[max_blocks]`` table in logical order, so the flat gather
index is the absolute token position.  Tables are padded with the
sentinel ``num_blocks``.

What differs from the JAX package, and why the results do not:

* The reference donates the cache; here the entry points update the
  cache's tensors in place (``index_put_``) and return the same dict.
* JAX clamps an out-of-range gather and drops an out-of-range scatter.
  Torch raises on the CPU and asserts on the device, so the gathers clamp
  the sentinel to ``num_blocks - 1`` (those positions are masked, so
  their probability is 0) and the writes leave out dead rows and cells
  past a session's blocks.  The write cells are worked out on the host,
  where the tables are built, and reach the device with the token ids in
  one copy: a step reads nothing back from the device.
* The reference casts each weight to ``cfg.dtype`` at every use; here a
  :class:`DecodeParams` holds one cast copy per weight generation (the
  same rounding).

A pool over several devices is a :class:`ShardedCache`: one dict like
:func:`init_cache`'s on each device, split by kv heads, by pages (blocks)
or not at all (replicated), by the JAX package's rule (:func:`shard_axis`).
The JAX package lays one array over a mesh and lets GSPMD place the work;
here the entry points place it: the embedding, the projections and the
MLP run on the first shard's device (where the weights are), and each
layer's attention runs on each shard's device over the blocks it holds.
Split by heads, a shard takes its kv heads' query groups and the outputs
are joined by head; split by pages, each shard attends over its own blocks
and the partials are merged by their log-sum-exp, as
:mod:`edl_tpu_torch.parallel.ring_attention` merges chunks; replicated,
every shard takes each write and the first attends.  What moves to and
from the other shards is counted in :attr:`ShardedCache.cross_bytes`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.device import resolve
from edl_tpu_torch.models.transformer import (  # noqa: F401  (re-exports)
    FLAGSHIP,
    TINY,
    Transformer,
    TransformerConfig,
    apply,
    rms_norm,
    rope_freqs,
)
from edl_tpu_torch.ops.embedding import embed_lookup

_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
_NORMS = ("attn_norm", "mlp_norm")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one device when 0 is the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


# -- cache layout ------------------------------------------------------------


def _cache_tensors(cfg: TransformerConfig, num_blocks: int,
                   block_size: int, kv_heads: int, quantize: Optional[str],
                   dev: torch.device) -> dict:
    shape = (cfg.n_layers, num_blocks, block_size, kv_heads, cfg.head_dim)
    if quantize == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:3], device=dev),
                "v_scale": torch.zeros(shape[:3], device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def shard_axis(cfg: TransformerConfig, num_blocks: int, n: int
               ) -> Optional[str]:
    """How a pool of ``num_blocks`` splits over ``n`` devices, by the JAX
    package's rule: ``"heads"`` when they divide the kv heads, else
    ``"pages"`` when they divide the blocks, else ``"replicated"``; None
    for one device."""
    if n <= 1:
        return None
    if cfg.n_kv_heads % n == 0:
        return "heads"
    if num_blocks % n == 0:
        return "pages"
    return "replicated"


def init_cache(cfg: TransformerConfig, num_blocks: int, block_size: int,
               quantize: Optional[str] = None, device="cuda",
               devices=None):
    """The paged KV pool's tensors on ``device``: ``{"k", "v"}``, each
    ``[n_layers, num_blocks, block_size, n_kv_heads, head_dim]`` in the
    model's compute dtype, zeroed.  ``quantize="int8"`` stores int8 K/V
    with float32 per-row scales ``k_scale``/``v_scale`` (``[n_layers,
    num_blocks, block_size]``).  ``devices`` (more than one) gives a
    :class:`ShardedCache` over them, split by :func:`shard_axis`."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown KV quantize mode {quantize!r}")
    if devices is not None and len(devices) > 1:
        devs = [resolve(d) for d in devices]
        n = len(devs)
        axis = shard_axis(cfg, num_blocks, n)
        kvh = cfg.n_kv_heads // n if axis == "heads" else cfg.n_kv_heads
        nb = num_blocks // n if axis == "pages" else num_blocks
        return ShardedCache(axis, [
            _cache_tensors(cfg, nb, block_size, kvh, quantize, d)
            for d in devs], num_blocks)
    if devices is not None:
        device = devices[0]
    return _cache_tensors(cfg, num_blocks, block_size, cfg.n_kv_heads,
                          quantize, resolve(device))


def cache_bytes(cfg: TransformerConfig, num_blocks: int, block_size: int,
                quantize: Optional[str] = None) -> int:
    """Resident bytes of :func:`init_cache`'s tensors."""
    cells = (cfg.n_layers * num_blocks * block_size
             * cfg.n_kv_heads * cfg.head_dim)
    if quantize == "int8":
        # int8 payload + one f32 scale per cached token row
        return 2 * (cells + 4 * cfg.n_layers * num_blocks * block_size)
    return 2 * cells * _itemsize(cfg.dtype)


class ShardedCache:
    """A paged KV pool's tensors over several devices: ``shards[j]`` is a
    dict like :func:`init_cache`'s on device ``j``.  ``axis`` is
    ``"heads"`` (shard j holds kv heads ``[j·kv/n, (j+1)·kv/n)`` of every
    block, and every block's int8 scales whole), ``"pages"`` (shard j
    holds blocks ``[j·B/n, (j+1)·B/n)`` whole, scales too) or
    ``"replicated"`` (every shard the whole pool).  Shard 0 is the home:
    the weights live on its device and the step's other work runs there.
    :attr:`cross_bytes` counts every byte moved to or from another shard
    (each one a copy between devices; on one card, between two tensors
    on it)."""

    def __init__(self, axis: str, shards: list, num_blocks: int) -> None:
        self.axis = axis
        self.shards = shards
        self.num_blocks = int(num_blocks)
        self.block_size = int(shards[0]["k"].shape[2])
        self.cross_bytes = 0

    @property
    def devices(self) -> list:
        return [s["k"].device for s in self.shards]

    @property
    def quantized(self) -> bool:
        return "k_scale" in self.shards[0]

    def names(self) -> set:
        return set(self.shards[0])

    def page_range(self, j: int) -> tuple[int, int]:
        """Blocks ``[lo, hi)`` shard ``j`` holds."""
        if self.axis != "pages":
            return 0, self.num_blocks
        per = self.num_blocks // len(self.shards)
        return j * per, (j + 1) * per

    def move(self, t: torch.Tensor, j: int, dev) -> torch.Tensor:
        """``t`` onto ``dev``, counted in :attr:`cross_bytes` when the copy
        goes to or comes from shard ``j`` other than the home."""
        if j:
            self.cross_bytes += t.numel() * t.element_size()
        return t.to(dev)


def _dims(cache) -> tuple[int, int, torch.device]:
    """(blocks, block size, home device) of a pool's tensors."""
    if isinstance(cache, ShardedCache):
        return cache.num_blocks, cache.block_size, cache.devices[0]
    return cache["k"].shape[1], cache["k"].shape[2], cache["k"].device


def _cache_names(cache) -> set:
    return cache.names() if isinstance(cache, ShardedCache) else set(cache)


@torch.no_grad()
def read_blocks(cache, block_ids) -> dict:
    """The whole blocks ``block_ids`` of every cache tensor (``[L, n, ...]``,
    every kv head), as new tensors on the home device."""
    if not isinstance(cache, ShardedCache):
        ids = _ids(block_ids, cache["k"].device)
        return {name: t.index_select(1, ids) for name, t in cache.items()}
    home = cache.devices[0]
    if cache.axis == "replicated":
        return read_blocks(cache.shards[0], block_ids)
    if cache.axis == "heads":
        parts = [{name: cache.move(t, j, home) for name, t in
                  read_blocks(shard, block_ids).items()}
                 for j, shard in enumerate(cache.shards)]
        out = {name: torch.cat([p[name] for p in parts], dim=3)
               for name in ("k", "v")}
        out.update((name, parts[0][name]) for name in parts[0]
                   if name.endswith("_scale"))
        return out
    ids = np.asarray([int(b) for b in block_ids], np.int64)
    out = {}
    for j, shard in enumerate(cache.shards):
        lo, hi = cache.page_range(j)
        at = np.flatnonzero((ids >= lo) & (ids < hi))
        if not len(at):
            continue
        got = read_blocks(shard, ids[at] - lo)
        where = torch.from_numpy(at).to(home)
        for name, t in got.items():
            if name not in out:
                out[name] = torch.empty((t.shape[0], len(ids))
                                        + tuple(t.shape[2:]), dtype=t.dtype,
                                        device=home)
            out[name].index_copy_(1, where, cache.move(t, j, home))
    return out


@torch.no_grad()
def write_blocks(cache, block_ids, blocks: dict) -> None:
    """Write whole blocks (``[L, n, ...]`` a cache tensor, every kv head, as
    :func:`read_blocks` gives them, on any device) into ``block_ids`` of
    ``cache``, in place, each shard taking its part."""
    if not isinstance(cache, ShardedCache):
        ids = _ids(list(block_ids)[:blocks["k"].shape[1]], cache["k"].device)
        for name, t in blocks.items():
            cache[name].index_copy_(1, ids, t.to(cache[name].device,
                                                 cache[name].dtype))
        return
    n = len(cache.shards)
    ids = np.asarray([int(b) for b in block_ids][:blocks["k"].shape[1]],
                     np.int64)
    for j, shard in enumerate(cache.shards):
        dev = shard["k"].device
        if cache.axis == "pages":
            lo, hi = cache.page_range(j)
            at = np.flatnonzero((ids >= lo) & (ids < hi))
            if not len(at):
                continue
            pick = torch.from_numpy(at)
            part = {name: cache.move(t.index_select(1, pick.to(t.device)),
                                     j, dev) for name, t in blocks.items()}
            write_blocks(shard, ids[at] - lo, part)
            continue
        part = {}
        for name, t in blocks.items():
            if cache.axis == "heads" and not name.endswith("_scale"):
                t = t.chunk(n, dim=3)[j]
            part[name] = cache.move(t, j, dev)
        write_blocks(shard, ids, part)


@torch.no_grad()
def copy_blocks(cache, src_ids, dst_ids) -> None:
    """Copy blocks ``src_ids`` onto ``dst_ids`` in every cache tensor (the
    pool's copy-on-write), in place: on each shard where it holds both,
    through the home device where a pages split puts them on two."""
    if isinstance(cache, ShardedCache) and cache.axis == "pages":
        write_blocks(cache, dst_ids, read_blocks(cache, src_ids))
        return
    for shard in (cache.shards if isinstance(cache, ShardedCache)
                  else [cache]):
        dev = shard["k"].device
        src, dst = _ids(src_ids, dev), _ids(dst_ids, dev)
        for t in shard.values():
            t.index_copy_(1, dst, t.index_select(1, src))


# -- weights -----------------------------------------------------------------


class DecodeParams:
    """One weight generation as the entry points read it, on one device:
    the matmul weights and the embedding table cast to ``cfg.dtype`` once
    (a gather of the cast table equals the cast of the gathered rows), the
    norm scales kept in fp32 as the reference uses them."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor,
                 layers: list, norm: torch.Tensor,
                 lm_head: torch.Tensor) -> None:
        self.cfg = cfg
        self.embed = embed
        self.layers = layers
        self.norm = norm
        self.lm_head = lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def to(self, device) -> "DecodeParams":
        """A copy of this generation on ``device``."""
        dev = resolve(device)
        return DecodeParams(
            self.cfg, self.embed.to(dev),
            [{name: t.to(dev) for name, t in layer.items()}
             for layer in self.layers],
            self.norm.to(dev), self.lm_head.to(dev))

    @classmethod
    def from_model(cls, model: Transformer, device=None) -> "DecodeParams":
        return cls.from_tree(model.cfg, param_tree(model),
                             model.embed.device if device is None
                             else device)

    @classmethod
    @torch.no_grad()
    def from_tree(cls, cfg: TransformerConfig, tree, device
                  ) -> "DecodeParams":
        """From the weights of ``cfg`` as :func:`param_tree` nests them (a
        checkpoint's ``['params']`` restored; a layer index a list's or an
        int key), wherever they are, onto ``device``."""
        dev, dt = resolve(device), cfg.dtype
        if tuple(tree["embed"].shape) != (cfg.vocab_size, cfg.d_model):
            raise ValueError(f"embed {tuple(tree['embed'].shape)} is not "
                             f"that of this config")
        layers = []
        for i in range(cfg.n_layers):
            p = tree["layers"][i]
            layer = {name: p[name].detach().to(dev, dt)
                     for name in _MATMUL_WEIGHTS}
            layer.update((name, p[name].detach().to(dev)) for name in _NORMS)
            layers.append(layer)
        return cls(cfg, tree["embed"].detach().to(dev, dt), layers,
                   tree["norm"].detach().to(dev),
                   tree["lm_head"].detach().to(dev, dt))


def param_tree(model: Transformer) -> dict:
    """The model's parameters nested as a checkpoint stores them under
    ``['params']``: ``{"embed", "layers": [{"wq", ...}], "norm",
    "lm_head"}``."""
    return {"embed": model.embed,
            "layers": [{name: getattr(p, name)
                        for name in _MATMUL_WEIGHTS + _NORMS}
                       for p in model.layers],
            "norm": model.norm, "lm_head": model.lm_head}


def param_template(cfg: TransformerConfig) -> dict:
    """:func:`param_tree`'s paths for ``cfg`` with empty host tensors as
    leaves: what a checkpoint restore reads the weights into (it gives
    each leaf the saved shape)."""
    empty = torch.empty(0)
    return {"embed": empty, "norm": empty, "lm_head": empty,
            "layers": [dict.fromkeys(_MATMUL_WEIGHTS + _NORMS, empty)
                       for _ in range(cfg.n_layers)]}


def as_decode_params(params, device=None,
                     cfg: Optional[TransformerConfig] = None
                     ) -> DecodeParams:
    """``params`` (a :class:`Transformer`, :func:`param_tree`'s nesting of
    ``cfg``'s weights, or :class:`DecodeParams`) as :class:`DecodeParams`
    on ``device`` (default: where they are); a :class:`DecodeParams` on
    another device is copied there (a replica on another card)."""
    if isinstance(params, dict):
        if cfg is None:
            raise ValueError("a tree of weights needs its config")
        return DecodeParams.from_tree(cfg, params, device or "cuda")
    if not isinstance(params, DecodeParams):
        return DecodeParams.from_model(params, device)
    if device is not None and not same_device(params.device,
                                              resolve(device)):
        return params.to(device)
    return params


# -- shared attention over a paged context -----------------------------------


def _rope_tables(cfg: TransformerConfig, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[rows, 1, hd/2]`` of the per-row positions (one pair
    per step, shared by every layer's q and k)."""
    angles = rope_freqs(cfg, positions)
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def _rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """RoPE for per-row positions: x ``[rows, heads, hd]``, in fp32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous fp32 copy of ``t``, in one copy whatever its strides."""
    return torch.empty(t.shape, dtype=torch.float32,
                       device=t.device).copy_(t)


def _group_attention(q: torch.Tensor, ctx_k: torch.Tensor,
                     ctx_v: torch.Tensor, mask: torch.Tensor,
                     cfg: TransformerConfig, with_lse: bool = False
                     ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """fp32 attention of each kv head's query group on its own: q ``[rows,
    h, hd]``, ctx_k/ctx_v ``[rows, T, kv, hd]``, mask ``[rows, 1, T]``.
    Returns the normalised output ``[rows, h, hd]`` and, ``with_lse``, the
    log-sum-exp ``[rows, h]`` of the masked scores (else None).  Each
    operand is copied once, kv head first, and each product takes one
    group's slice, so its shapes and strides are the same whether the kv
    heads lie on one device or are split over several; the mask and the
    softmax run over every group at once, row by row.  So a heads split
    computes what one device does, bit for bit (one product over every
    group does not: cuBLAS picks its kernel by the batch)."""
    rows, h, hd = q.shape
    kv, t = ctx_k.shape[2], ctx_k.shape[1]
    rep = h // kv
    qs = _f32(q.reshape(rows, kv, rep, hd).transpose(0, 1)).unbind(0)
    ks = _f32(ctx_k.permute(2, 0, 3, 1)).unbind(0)  # [kv][rows, hd, T]
    vs = _f32(ctx_v.permute(2, 0, 1, 3)).unbind(0)  # [kv][rows, T, hd]
    scores = q.new_empty((kv, rows, rep, t), dtype=torch.float32)
    for g, part in enumerate(scores.unbind(0)):
        torch.bmm(qs[g], ks[g], out=part)
    scores = torch.add(torch.where(mask, 0.0, -1e30), scores,
                       alpha=cfg.head_dim ** -0.5)
    lse = None
    if with_lse:
        lse = torch.logsumexp(scores, dim=-1)
        probs = torch.exp(scores - lse[..., None])
        lse = lse.transpose(0, 1).reshape(rows, h)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = q.new_empty((kv, rows, rep, hd), dtype=torch.float32)
    for g, (p, part) in enumerate(zip(probs.unbind(0), out.unbind(0))):
        torch.bmm(p, vs[g], out=part)
    return out.transpose(0, 1).reshape(rows, h, hd), lse


def _paged_attention(q: torch.Tensor, ctx_k: torch.Tensor,
                     ctx_v: torch.Tensor, mask: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    """Attention of per-row queries against per-row paged contexts.

    q ``[rows, h, hd]``; ctx_k/ctx_v ``[rows, T, kv, hd]`` with flat index
    == absolute position; mask ``[rows, 1, T]``, True where the position
    is at or before the row's query.  fp32 scores, masked to -1e30, each
    kv head's query group on its own (``h`` and ``kv`` as the tensors hold
    them: a shard's heads, or all).  Returns ``[rows, h*hd]`` in
    ``cfg.dtype``."""
    out, _ = _group_attention(q, ctx_k, ctx_v, mask, cfg)
    return out.reshape(out.shape[0], -1).to(cfg.dtype)


def _merge_partials(parts: list, cfg: TransformerConfig) -> torch.Tensor:
    """The whole context's attention from its parts' (output, lse), each
    a pages shard's :func:`_group_attention` over its own blocks: each part
    weighted by exp(its lse - the total's).  ``[rows, h*hd]`` in
    ``cfg.dtype``."""
    lse = torch.stack([l for _, l in parts])  # [n, rows, h]
    w = torch.exp(lse - torch.logsumexp(lse, dim=0))
    out = sum(w[j][..., None] * o for j, (o, _) in enumerate(parts))
    return out.reshape(out.shape[0], -1).to(cfg.dtype)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-row quantization: x ``[rows, kv, hd]`` → (int8
    values, float32 scales ``[rows]``), rounding half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 2))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def _write_indices(positions: np.ndarray, block_tables: np.ndarray,
                   live: np.ndarray, num_blocks: int, block_size: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(blk, off) cache cells for per-row writes, on the host; dead rows
    get the sentinel ``num_blocks``."""
    maxb = block_tables.shape[-1]
    logical = np.clip(positions // block_size, 0, maxb - 1)
    blk = np.take_along_axis(block_tables, logical[:, None], axis=1)[:, 0]
    blk = np.where(live, blk, num_blocks)
    return blk, positions % block_size


def _upload(packed: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host indices onto ``dev`` in one copy: on the card from pinned
    memory, so the copy queues behind the device's work and the host goes
    on launching."""
    host = torch.from_numpy(packed)
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host.to(dev)


def _step_inputs(cache: dict, tokens, positions, block_tables, live
                 ) -> tuple[torch.Tensor, ...]:
    """The host's per-row inputs as device tensors, in one copy: tokens,
    positions, the gather tables (sentinel clamped to the last block), and
    the rows that write with their (blk, off) cells — dead rows and cells
    past a session's blocks left out — and those cells on the host too
    (where a pages split picks each shard's)."""
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    positions = np.asarray(positions, np.int64).reshape(-1)
    tables = np.asarray(block_tables, np.int64)
    live = np.asarray(live, bool).reshape(-1)
    nb, bs, dev = _dims(cache)
    blk, off = _write_indices(positions, tables, live, nb, bs)
    rows = np.flatnonzero(blk < nb)
    packed = np.concatenate([tokens, positions,
                             np.minimum(tables, nb - 1).reshape(-1),
                             rows, blk[rows], off[rows]])
    dev_packed = _upload(packed, dev)
    n, w = len(tokens), len(rows)
    tok, pos, tab, r, b, o = torch.split(
        dev_packed, [n, n, tables.size, w, w, w])
    return (tok, pos, tab.view(tables.shape), r, b, o,
            (rows, blk[rows], off[rows]))


def _write_and_gather(cache: dict, li: int, cells: tuple, k, v, scales,
                      tables: torch.Tensor, hd: int, gather: bool = True):
    """One device's tensors at layer ``li``: write the rows ``k``/``v``
    (and their int8 ``scales``, a (k, v) pair, or None) into ``cells``,
    then gather each row's table context, dequantized: ``[rows, T, kv,
    hd]`` each (None without ``gather``)."""
    cache["k"][li].index_put_(cells, k)
    cache["v"][li].index_put_(cells, v)
    if scales is not None:
        cache["k_scale"][li].index_put_(cells, scales[0])
        cache["v_scale"][li].index_put_(cells, scales[1])
    if not gather:
        return None
    ctx = []
    for name in ("k", "v"):
        # [rows, maxb, bs, kv, hd], int8 scaled by [rows, maxb, bs]
        t = cache[name][li][tables]
        if scales is not None:
            t = t.float() * cache[name + "_scale"][li][tables][..., None, None]
        ctx.append(t.reshape(tables.shape[0], -1, t.shape[-2], hd))
    return ctx


def _local_attention(cache: dict, cfg: TransformerConfig,
                     tables: torch.Tensor, mask: torch.Tensor,
                     rows: torch.Tensor, cells: tuple):
    """One device's attention for :func:`_forward_rows`: a function of
    (layer, q, k, v) that writes the rows ``rows``' K/V into ``cells`` and
    attends over each row's table context."""
    quant = "k_scale" in cache

    def attend(li: int, q, k, v) -> torch.Tensor:
        scales = None
        if quant:
            k, ks = _quantize_rows(k)
            v, vs = _quantize_rows(v)
            scales = (ks[rows], vs[rows])
        ctx_k, ctx_v = _write_and_gather(cache, li, cells, k[rows], v[rows],
                                         scales, tables, cfg.head_dim)
        return _paged_attention(q, ctx_k, ctx_v, mask, cfg)

    return attend


def _sharded_attention(cache: ShardedCache, cfg: TransformerConfig,
                       tables: torch.Tensor, mask: torch.Tensor,
                       rows: torch.Tensor, cells: tuple, host_cells: tuple):
    """:func:`_local_attention` over a :class:`ShardedCache`: each shard's
    part of the writes and of the attention on its own device (module
    docstring).  The step's index tensors go to each shard once: a heads
    split or a replicated pool writes every row on every shard; a pages
    split picks each shard's rows on the host (``host_cells``) and sends
    them in one pinned copy, as the step's inputs are sent."""
    n = len(cache.shards)
    home = cache.devices[0]
    rows_np, blk_np, off_np = host_cells
    views = []
    for j, shard in enumerate(cache.shards):
        dev = shard["k"].device
        tab, m, r, (blk, off) = tables, mask, rows, cells
        if cache.axis == "pages":
            lo, hi = cache.page_range(j)
            own = (blk_np >= lo) & (blk_np < hi)
            w = int(own.sum())
            r, blk, off = _upload(np.concatenate(
                [rows_np[own], blk_np[own] - lo, off_np[own]]),
                home).split([w, w, w])
            held = (tab >= lo) & (tab < hi)  # [rows, maxb]
            m = m & held.repeat_interleave(cache.block_size, dim=1)[:, None]
            tab = (tab - lo).clamp(0, hi - lo - 1)
        views.append((shard, dev, r,
                      (cache.move(blk, j, dev), cache.move(off, j, dev)),
                      cache.move(tab, j, dev), cache.move(m, j, dev)))
    kvs, hs = cfg.n_kv_heads // n, cfg.n_heads // n

    def attend(li: int, q, k, v) -> torch.Tensor:
        ks = vs = None
        if cache.quantized:
            k, ks = _quantize_rows(k)
            v, vs = _quantize_rows(v)
        parts = []
        for j, (shard, dev, r, cells, tab, m) in enumerate(views):
            kj, vj, qj = k, v, q
            if cache.axis == "heads":
                kj, vj = (t[:, j * kvs:(j + 1) * kvs] for t in (k, v))
                qj = q[:, j * hs:(j + 1) * hs]
            scales = (None if ks is None else
                      (cache.move(ks[r], j, dev), cache.move(vs[r], j, dev)))
            # every copy of a replicated pool takes the writes; the home
            # attends
            ctx = _write_and_gather(
                shard, li, cells, cache.move(kj[r], j, dev),
                cache.move(vj[r], j, dev), scales, tab, cfg.head_dim,
                gather=not (cache.axis == "replicated" and j))
            if ctx is None:
                continue
            qd = cache.move(qj, j, dev)
            if cache.axis == "pages":
                o, lse = _group_attention(qd, *ctx, m, cfg, with_lse=True)
                parts.append((cache.move(o, j, home),
                              cache.move(lse, j, home)))
            else:
                parts.append(cache.move(
                    _paged_attention(qd, *ctx, m, cfg), j, home))
        if cache.axis == "pages":
            return _merge_partials(parts, cfg)
        return torch.cat(parts, dim=1)

    return attend


def _forward_rows(params: DecodeParams, cache, tokens: torch.Tensor,
                  positions: torch.Tensor, tables: torch.Tensor,
                  rows: torch.Tensor, write_blk: torch.Tensor,
                  write_off: torch.Tensor, host_cells: tuple
                  ) -> tuple[torch.Tensor, dict]:
    """The layer stack shared by the entry points: per-row tokens at
    per-row absolute positions; each layer writes the rows ``rows``' K/V
    into cells ``(write_blk, write_off)`` (``host_cells`` the same on the
    host) and then attends over each row's table context (so a query
    attends to itself through the cache).  Returns (logits ``[rows,
    vocab]`` fp32, the cache, updated in place)."""
    cfg = params.cfg
    _, bs, home = _dims(cache)
    if not same_device(home, params.device):
        raise ValueError(f"cache on {home}, weights on {params.device}")
    dt = cfg.dtype
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = tokens.shape[0]
    x = embed_lookup(params.embed, tokens[None, :],
                     one_hot=cfg.one_hot_embed, dtype=dt)[0]  # [rows, d]
    cos, sin = _rope_tables(cfg, positions)
    t_idx = torch.arange(tables.shape[1] * bs, device=tokens.device)
    mask = (t_idx[None, :] <= positions[:, None])[:, None, :]
    if isinstance(cache, ShardedCache):
        attend = _sharded_attention(cache, cfg, tables, mask, rows,
                                    (write_blk, write_off), host_cells)
    else:
        attend = _local_attention(cache, cfg, tables, mask, rows,
                                  (write_blk, write_off))
    for li, p in enumerate(params.layers):
        xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q = (xn @ p["wq"]).reshape(n, h, hd)
        k = (xn @ p["wk"]).reshape(n, kvh, hd)
        v = (xn @ p["wv"]).reshape(n, kvh, hd)
        q = _rope_rows(q, cos, sin).to(dt)
        k = _rope_rows(k, cos, sin).to(dt)
        o = attend(li, q, k, v)
        x = x + (o @ p["wo"])
        xn = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        gate = F.silu(xn @ p["w1"])
        up = xn @ p["w3"]
        x = x + ((gate * up) @ p["w2"])
    x = rms_norm(x, params.norm, cfg.norm_eps)
    return (x @ params.lm_head).float(), cache


# -- entry points ------------------------------------------------------------
#
# Index arguments are host data (numpy arrays, lists or CPU tensors), as
# the serving loop builds them; the cache's tensors are updated in place.


@torch.no_grad()
def decode_step(params, cache: dict, tokens, positions, block_tables,
                live) -> tuple[torch.Tensor, dict]:
    """One decode iteration for the fixed slot batch.

    tokens ``[slots]`` (each slot's last emitted or prompt token);
    positions ``[slots]`` (that token's absolute position); block_tables
    ``[slots, max_blocks]``; live ``[slots]`` bool (dead slots compute
    but never write).  Returns next-token logits ``[slots, vocab]`` and
    the cache."""
    return _forward_rows(as_decode_params(params), cache,
                         *_step_inputs(cache, tokens, positions,
                                       block_tables, live))


@torch.no_grad()
def prefill(params, cache: dict, tokens, block_table, start_pos: int,
            length: int) -> tuple[torch.Tensor, dict]:
    """One prefill **chunk** of one session: tokens ``[chunk]`` (valid
    prefix ``length``, the rest padding) at absolute positions
    ``start_pos + i`` through ``block_table [max_blocks]``.  Rows past
    ``length`` do not write.  Returns per-row logits ``[chunk, vocab]``
    and the cache."""
    chunk = len(tokens)
    positions = int(start_pos) + np.arange(chunk)
    valid = np.arange(chunk) < int(length)
    table = np.asarray(block_table, np.int64)
    tables = np.broadcast_to(table, (chunk,) + table.shape)
    return _forward_rows(as_decode_params(params), cache,
                         *_step_inputs(cache, tokens, positions, tables,
                                       valid))


@torch.no_grad()
def verify_step(params, cache: dict, tokens, positions, n_tokens,
                block_tables) -> tuple[torch.Tensor, dict]:
    """One speculative **verify** iteration: up to ``K`` tokens a slot in
    one batched forward.

    tokens ``[slots, K]`` (row 0 the slot's last emitted token, rows 1..K-1
    drafts); positions ``[slots]`` (row 0's absolute position); n_tokens
    ``[slots]`` (valid rows; 0 = dead slot).  Returns logits ``[slots, K,
    vocab]`` (row j = next-token logits after consuming tokens 0..j) and
    the cache."""
    tokens = np.asarray(tokens, np.int64)
    S, K = tokens.shape
    offs = np.arange(K)
    flat_pos = (np.asarray(positions, np.int64)[:, None]
                + offs[None, :]).reshape(-1)
    live = (offs[None, :]
            < np.asarray(n_tokens, np.int64)[:, None]).reshape(-1)
    tables = np.repeat(np.asarray(block_tables, np.int64), K, axis=0)
    logits, cache = _forward_rows(
        as_decode_params(params), cache,
        *_step_inputs(cache, tokens.reshape(-1), flat_pos, tables, live))
    return logits.reshape(S, K, -1), cache


# -- host-side helpers (migration / handoff) ---------------------------------


def _ids(block_ids: Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.tensor([int(b) for b in block_ids], dtype=torch.int64,
                        device=device)


@torch.no_grad()
def gather_session_kv(cache, block_ids, length: int,
                      block_size: int) -> dict:
    """Host (CPU) copy of one session's K/V, ``[L, length, kv, hd]`` each,
    from its logical-order block list — the unit a host migration ships.
    A quantized pool exports dequantized float32."""
    blocks = read_blocks(cache, block_ids)
    out = {}
    for name in ("k", "v"):
        arr = blocks[name].cpu()
        if name + "_scale" in blocks:
            arr = arr.float() * blocks[name + "_scale"].cpu()[..., None, None]
        L, nb, bs = arr.shape[:3]
        flat = arr.reshape(L, nb * bs, *arr.shape[3:])
        out[name] = flat[:, :length].clone()
    return out


@torch.no_grad()
def scatter_session_kv(cache, block_ids, host_kv: dict,
                       block_size: int):
    """Write a :func:`gather_session_kv` payload into freshly allocated
    blocks of (another) cache, in place.  A quantized destination
    re-quantizes the float payload row-wise (half to even), over every kv
    head of a row whatever shard holds them."""
    quant = "k_scale" in _cache_names(cache)
    length = host_kv["k"].shape[1]
    n_need = -(-length // block_size)
    if len(block_ids) < n_need:
        raise ValueError(f"{len(block_ids)} blocks for {length} tokens "
                         f"at block size {block_size}")
    blocks = {}
    for name in ("k", "v"):
        flat = torch.as_tensor(host_kv[name])
        L = flat.shape[0]
        pad = n_need * block_size - length
        if pad:
            flat = torch.cat([flat, flat.new_zeros((L, pad)
                                                   + tuple(flat.shape[2:]))],
                             dim=1)
        shape = (L, n_need, block_size) + tuple(flat.shape[2:])
        if quant:
            f32 = flat.float()
            amax = f32.abs().amax(dim=(2, 3))  # [L, tokens]
            scale = torch.clamp_min(amax / 127.0, 1e-12)
            qrows = torch.clamp(torch.round(f32 / scale[..., None, None]),
                                -127, 127).to(torch.int8)
            blocks[name] = qrows.reshape(shape)
            blocks[name + "_scale"] = scale.reshape(L, n_need, block_size)
        else:
            blocks[name] = flat.reshape(shape)
    write_blocks(cache, list(block_ids)[:n_need], blocks)
    return cache


# -- device-side helpers (D2D migration: no host roundtrip) ------------------


@torch.no_grad()
def gather_session_kv_device(cache, block_ids):
    """Blocked device copy of one session (every cache tensor sliced to
    ``[L, n_blocks, ...]``) — the D2D migration payload.  The gather makes
    NEW tensors, so the source pool may free the blocks at once.  A heads
    split gives one such dict a shard, its heads, each on its device;
    any other cache one dict of whole blocks on the home device."""
    if isinstance(cache, ShardedCache) and cache.axis == "heads":
        return [read_blocks(shard, block_ids) for shard in cache.shards]
    return read_blocks(cache, block_ids)


@torch.no_grad()
def scatter_session_kv_device(cache: dict, block_ids, payload: dict
                              ) -> dict:
    """Write a :func:`gather_session_kv_device` payload into (another)
    one-device cache's freshly allocated blocks, on the device.  Needs the
    same storage mode on both sides; a layout mismatch raises before
    anything lands.  A sharded cache takes its payload through
    :func:`write_placed`."""
    if set(payload) != set(cache):
        raise ValueError(
            f"D2D payload layout {sorted(payload)} != cache layout "
            f"{sorted(cache)} (quantization modes differ)")
    n = payload["k"].shape[1]
    if len(block_ids) < n:
        raise ValueError(f"{len(block_ids)} blocks for a {n}-block payload")
    ids = _ids(list(block_ids)[:n], cache["k"].device)
    for name, t in payload.items():
        cache[name].index_copy_(1, ids, t.to(cache[name].device,
                                             cache[name].dtype))
    return cache


@torch.no_grad()
def write_placed(cache: ShardedCache, block_ids, placed: list) -> None:
    """Write a D2D payload already placed on the cache's devices (one dict
    a shard, on its device: its kv heads of every block for a heads split,
    the whole payload otherwise) into ``block_ids``: each shard takes its
    part from its own copy."""
    if set(placed[0]) != cache.names():
        raise ValueError(
            f"D2D payload layout {sorted(placed[0])} != cache layout "
            f"{sorted(cache.names())} (quantization modes differ)")
    n = placed[0]["k"].shape[1]
    ids = np.asarray([int(b) for b in block_ids][:n], np.int64)
    for j, (shard, part) in enumerate(zip(cache.shards, placed)):
        if cache.axis != "pages":
            write_blocks(shard, ids, part)
            continue
        lo, hi = cache.page_range(j)
        at = np.flatnonzero((ids >= lo) & (ids < hi))
        if len(at):
            pick = torch.from_numpy(at).to(shard["k"].device)
            write_blocks(shard, ids[at] - lo,
                         {name: t.index_select(1, pick)
                          for name, t in part.items()})


def join_heads(parts: list) -> dict:
    """Whole blocks from a heads-split payload (one dict a shard, joined
    on the first part's device); a one-part payload as it is."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0]["k"].device
    out = {name: torch.cat([p[name].to(dev) for p in parts], dim=3)
           for name in ("k", "v")}
    out.update((name, t) for name, t in parts[0].items()
               if name.endswith("_scale"))
    return out
