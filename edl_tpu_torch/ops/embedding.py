"""Embedding lookup: the gather path (the single-device default) and the
one-hot matmul path the JAX package uses for vocab-sharded tables."""

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
