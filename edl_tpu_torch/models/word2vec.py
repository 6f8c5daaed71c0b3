"""Word2vec (CBOW-style N-gram) embedding model — the port of
edl_tpu.models.word2vec, the model of the shipped elastic example
(reference example/train_ft.py:41-100: imikolov N-gram word embedding with
concatenated context projected to a softmax over the vocabulary).

The parameters keep the JAX tree's names (``emb``, ``w_h``, ``b_h``,
``w_o``, ``b_o``) and its ``[in, out]`` orientation, so weights carry across
unchanged (:func:`edl_tpu_torch.interop.word2vec_from_numpy`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from edl_tpu_torch.device import resolve

EMB_DIM_DEFAULT = 32  # reference train_ft.py:15 (embsize)


class Word2Vec(nn.Module):
    """The embedding table, one hidden ReLU layer over the concatenated
    context and the vocabulary logits; initialised as the JAX package's
    ``init`` scales them (normal · 1/√emb_dim for the table, He for the
    hidden layer, 1/√hidden for the output, zero biases), from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, vocab_size: int, context: int = 4,
                 emb_dim: int = EMB_DIM_DEFAULT, hidden: int = 256,
                 device="cuda", seed: int = 0) -> None:
        super().__init__()
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal(*shape, scale):
            return nn.Parameter(torch.randn(*shape, generator=gen,
                                            device=dev) * scale)

        self.emb = normal(vocab_size, emb_dim, scale=emb_dim ** -0.5)
        self.w_h = normal(context * emb_dim, hidden,
                          scale=(2.0 / (context * emb_dim)) ** 0.5)
        self.b_h = nn.Parameter(torch.zeros(hidden, device=dev))
        self.w_o = normal(hidden, vocab_size, scale=hidden ** -0.5)
        self.b_o = nn.Parameter(torch.zeros(vocab_size, device=dev))

    def forward(self, context_ids: torch.Tensor) -> torch.Tensor:
        return apply(self, context_ids)


def apply(params: Word2Vec, context_ids: torch.Tensor) -> torch.Tensor:
    """context_ids: [batch, context] integer ids → logits [batch, vocab]."""
    emb = params.emb[context_ids.long()]  # [b, ctx, d]
    flat = emb.reshape(emb.shape[0], -1)
    h = torch.relu(flat @ params.w_h + params.b_h)
    return h @ params.w_o + params.b_o


def loss_fn(params: Word2Vec, batch: tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Mean softmax cross-entropy of the next token."""
    ctx, target = batch
    logp = F.log_softmax(apply(params, ctx), dim=-1)
    return -logp.gather(1, target.long()[:, None]).mean()
