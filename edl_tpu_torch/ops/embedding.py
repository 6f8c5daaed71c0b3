"""Embedding lookup: the gather path (the single-device default) and the
one-hot matmul path the JAX package uses for vocab-sharded tables, and the
lookup in one block of a table's rows that a vocab-parallel table sums over
its tp group (:func:`edl_tpu_torch.parallel.tensor_parallel.
vocab_parallel_embed`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, *,
                 one_hot: bool, dtype: torch.dtype) -> torch.Tensor:
    """``table[vocab, d]``, ``tokens[...] int`` → ``[..., d]`` in ``dtype``."""
    if one_hot:
        hot = F.one_hot(tokens.long(), table.shape[0]).to(dtype)
        return hot @ table.to(dtype)
    return table.to(dtype)[tokens.long()]


def embed_lookup_local(table: torch.Tensor, tokens: torch.Tensor,
                       start: int, *, one_hot: bool,
                       dtype: torch.dtype) -> torch.Tensor:
    """:func:`embed_lookup` in rows ``[start, start + len(table))`` of a
    larger table, ``table`` holding them: a token in that range gets its
    row, any other token a row of zeros."""
    ids = tokens.long() - start
    inside = (ids >= 0) & (ids < table.shape[0])
    ids = torch.where(inside, ids, 0)
    if one_hot:
        hot = F.one_hot(ids, table.shape[0]).to(dtype)
        return (hot * inside[..., None].to(dtype)) @ table.to(dtype)
    rows = table.to(dtype)[ids]
    return torch.where(inside[..., None], rows, 0.0)
