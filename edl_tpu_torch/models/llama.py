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


def init_cache(cfg: TransformerConfig, num_blocks: int, block_size: int,
               quantize: Optional[str] = None, device="cuda") -> dict:
    """The paged KV pool's tensors on ``device``: ``{"k", "v"}``, each
    ``[n_layers, num_blocks, block_size, n_kv_heads, head_dim]`` in the
    model's compute dtype, zeroed.  ``quantize="int8"`` stores int8 K/V
    with float32 per-row scales ``k_scale``/``v_scale`` (``[n_layers,
    num_blocks, block_size]``)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown KV quantize mode {quantize!r}")
    dev = resolve(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if quantize == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:3], device=dev),
                "v_scale": torch.zeros(shape[:3], device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def cache_bytes(cfg: TransformerConfig, num_blocks: int, block_size: int,
                quantize: Optional[str] = None) -> int:
    """Resident bytes of :func:`init_cache`'s tensors."""
    cells = (cfg.n_layers * num_blocks * block_size
             * cfg.n_kv_heads * cfg.head_dim)
    if quantize == "int8":
        # int8 payload + one f32 scale per cached token row
        return 2 * (cells + 4 * cfg.n_layers * num_blocks * block_size)
    return 2 * cells * _itemsize(cfg.dtype)


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
    ``cfg``'s weights, or :class:`DecodeParams` already on ``device``) as
    :class:`DecodeParams` on ``device`` (default: where they are)."""
    if isinstance(params, dict):
        if cfg is None:
            raise ValueError("a tree of weights needs its config")
        return DecodeParams.from_tree(cfg, params, device or "cuda")
    if not isinstance(params, DecodeParams):
        return DecodeParams.from_model(params, device)
    if device is not None and not same_device(params.device,
                                              resolve(device)):
        raise ValueError(f"decode params on {params.device}, not {device}")
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


def _paged_attention(q: torch.Tensor, ctx_k: torch.Tensor,
                     ctx_v: torch.Tensor, mask: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    """Attention of per-row queries against per-row paged contexts.

    q ``[rows, h, hd]``; ctx_k/ctx_v ``[rows, T, kv, hd]`` with flat index
    == absolute position; mask ``[rows, 1, T]``, True where the position
    is at or before the row's query.  fp32 scores, masked to -1e30, GQA by
    repeating the kv heads.  Returns ``[rows, h*hd]`` in ``cfg.dtype``."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if kv != h:
        rep = h // kv
        ctx_k = ctx_k.repeat_interleave(rep, dim=2)
        ctx_v = ctx_v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("rhd,rthd->rht", q.float(), ctx_k.float())
    scores = scores / (cfg.head_dim ** 0.5)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("rht,rthd->rhd", probs, ctx_v.float())
    return out.reshape(out.shape[0], h * cfg.head_dim).to(cfg.dtype)


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


def _step_inputs(cache: dict, tokens, positions, block_tables, live
                 ) -> tuple[torch.Tensor, ...]:
    """The host's per-row inputs as device tensors, in one copy: tokens,
    positions, the gather tables (sentinel clamped to the last block), and
    the rows that write with their (blk, off) cells — dead rows and cells
    past a session's blocks left out."""
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    positions = np.asarray(positions, np.int64).reshape(-1)
    tables = np.asarray(block_tables, np.int64)
    live = np.asarray(live, bool).reshape(-1)
    nb, bs = cache["k"].shape[1], cache["k"].shape[2]
    blk, off = _write_indices(positions, tables, live, nb, bs)
    rows = np.flatnonzero(blk < nb)
    packed = np.concatenate([tokens, positions,
                             np.minimum(tables, nb - 1).reshape(-1),
                             rows, blk[rows], off[rows]])
    host = torch.from_numpy(packed)
    dev = cache["k"].device
    if dev.type == "cuda":
        # pinned, so the copy queues behind the device's work and the host
        # goes on launching
        dev_packed = host.pin_memory().to(dev, non_blocking=True)
    else:
        dev_packed = host.to(dev)
    n, w = len(tokens), len(rows)
    tok, pos, tab, r, b, o = torch.split(
        dev_packed, [n, n, tables.size, w, w, w])
    return tok, pos, tab.view(tables.shape), r, b, o


def _forward_rows(params: DecodeParams, cache: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, tables: torch.Tensor,
                  rows: torch.Tensor, write_blk: torch.Tensor,
                  write_off: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The layer stack shared by the entry points: per-row tokens at
    per-row absolute positions; each layer writes the rows ``rows``' K/V
    into cells ``(write_blk, write_off)`` and then attends over each row's
    table context (so a query attends to itself through the cache).
    Returns (logits ``[rows, vocab]`` fp32, the cache, updated in place)."""
    cfg = params.cfg
    if not same_device(cache["k"].device, params.device):
        raise ValueError(f"cache on {cache['k'].device}, weights on "
                         f"{params.device}")
    dt = cfg.dtype
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    quant = "k_scale" in cache
    n = tokens.shape[0]
    x = embed_lookup(params.embed, tokens[None, :],
                     one_hot=cfg.one_hot_embed, dtype=dt)[0]  # [rows, d]
    cos, sin = _rope_tables(cfg, positions)
    t_idx = torch.arange(tables.shape[1] * cache["k"].shape[2],
                         device=tokens.device)
    mask = (t_idx[None, :] <= positions[:, None])[:, None, :]
    cells = (write_blk, write_off)
    for li, p in enumerate(params.layers):
        xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q = (xn @ p["wq"]).reshape(n, h, hd)
        k = (xn @ p["wk"]).reshape(n, kvh, hd)
        v = (xn @ p["wv"]).reshape(n, kvh, hd)
        q = _rope_rows(q, cos, sin).to(dt)
        k = _rope_rows(k, cos, sin).to(dt)
        if quant:
            kq, ks = _quantize_rows(k)
            vq, vs = _quantize_rows(v)
            cache["k"][li].index_put_(cells, kq[rows])
            cache["v"][li].index_put_(cells, vq[rows])
            cache["k_scale"][li].index_put_(cells, ks[rows])
            cache["v_scale"][li].index_put_(cells, vs[rows])
            # dequantized gather: [rows, maxb, bs, kv, hd] int8 scaled by
            # [rows, maxb, bs]
            ctx_k = (cache["k"][li][tables].float()
                     * cache["k_scale"][li][tables][..., None, None])
            ctx_v = (cache["v"][li][tables].float()
                     * cache["v_scale"][li][tables][..., None, None])
        else:
            cache["k"][li].index_put_(cells, k[rows])
            cache["v"][li].index_put_(cells, v[rows])
            ctx_k = cache["k"][li][tables]
            ctx_v = cache["v"][li][tables]
        ctx_k = ctx_k.reshape(n, -1, kvh, hd)
        ctx_v = ctx_v.reshape(n, -1, kvh, hd)
        o = _paged_attention(q, ctx_k, ctx_v, mask, cfg)
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
def gather_session_kv(cache: dict, block_ids, length: int,
                      block_size: int) -> dict:
    """Host (CPU) copy of one session's K/V, ``[L, length, kv, hd]`` each,
    from its logical-order block list — the unit a host migration ships.
    A quantized pool exports dequantized float32."""
    ids = _ids(block_ids, cache["k"].device)
    out = {}
    for name in ("k", "v"):
        arr = cache[name].index_select(1, ids).cpu()
        if name + "_scale" in cache:
            scale = cache[name + "_scale"].index_select(1, ids).cpu()
            arr = arr.float() * scale[..., None, None]
        L, nb, bs = arr.shape[:3]
        flat = arr.reshape(L, nb * bs, *arr.shape[3:])
        out[name] = flat[:, :length].clone()
    return out


@torch.no_grad()
def scatter_session_kv(cache: dict, block_ids, host_kv: dict,
                       block_size: int) -> dict:
    """Write a :func:`gather_session_kv` payload into freshly allocated
    blocks of (another) cache, in place.  A quantized destination
    re-quantizes the float payload row-wise (half to even)."""
    quant = "k_scale" in cache
    length = host_kv["k"].shape[1]
    n_need = -(-length // block_size)
    if len(block_ids) < n_need:
        raise ValueError(f"{len(block_ids)} blocks for {length} tokens "
                         f"at block size {block_size}")
    dev = cache["k"].device
    ids = _ids(list(block_ids)[:n_need], dev)
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
            cache[name].index_copy_(1, ids, qrows.reshape(shape).to(dev))
            cache[name + "_scale"].index_copy_(
                1, ids, scale.reshape(L, n_need, block_size).to(dev))
        else:
            cache[name].index_copy_(
                1, ids, flat.reshape(shape).to(dev, cache[name].dtype))
    return cache


# -- device-side helpers (D2D migration: no host roundtrip) ------------------


@torch.no_grad()
def gather_session_kv_device(cache: dict, block_ids) -> dict:
    """Blocked device copy of one session (every cache tensor sliced to
    ``[L, n_blocks, ...]``) — the D2D migration payload.  The gather makes
    NEW tensors, so the source pool may free the blocks at once."""
    ids = _ids(block_ids, cache["k"].device)
    return {name: t.index_select(1, ids) for name, t in cache.items()}


@torch.no_grad()
def scatter_session_kv_device(cache: dict, block_ids, payload: dict
                              ) -> dict:
    """Write a :func:`gather_session_kv_device` payload into (another)
    cache's freshly allocated blocks, on the device.  Needs the same
    storage mode on both sides; a layout mismatch raises before anything
    lands."""
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
