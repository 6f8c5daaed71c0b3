"""Shared fixtures of the decode-plane port tests: the JAX package's TINY
params from PRNGKey(0), the port's TINY model loaded with them, and the
JAX package's full-context greedy continuation, the reference every paged,
batched or migrated decode of the port must reproduce token for token."""

from __future__ import annotations

import jax
import numpy as np

from edl_tpu.models.transformer import TINY, apply, init
from edl_tpu_torch.interop import params_from_numpy
from edl_tpu_torch.models import transformer as tfm

PARAMS = init(jax.random.PRNGKey(0), TINY)
#: JAX apply at one padded shape: a causal model's logits at position i
#: do not see the padding after it, and one shape compiles once
_REF_SHAPE = (8, TINY.max_seq_len)
_apply = jax.jit(lambda toks: apply(PARAMS, toks, TINY))
_REF_CACHE: dict = {}


def port_model(params=PARAMS) -> tfm.Transformer:
    """The port's TINY transformer on the CPU holding ``params``."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    return params_from_numpy(model, jax.tree.map(np.asarray, params))


MODEL = port_model()


def ref_decode_many(prompts, n: int) -> list[list[int]]:
    """Greedy continuations of ``prompts`` (``n`` tokens each) through the
    JAX package's full-context ``apply``, eight prompts a call."""
    missing = [list(p) for p in prompts if (tuple(p), n) not in _REF_CACHE]
    for lo in range(0, len(missing), _REF_SHAPE[0]):
        group = missing[lo:lo + _REF_SHAPE[0]]
        seqs = [list(p) for p in group]
        for _ in range(n):
            toks = np.zeros(_REF_SHAPE, np.int32)
            for i, s in enumerate(seqs):
                toks[i, :len(s)] = s
            logits = np.asarray(_apply(toks))
            for i, s in enumerate(seqs):
                s.append(int(logits[i, len(s) - 1].argmax()))
        for p, s in zip(group, seqs):
            _REF_CACHE[(tuple(p), n)] = s[len(p):]
    return [list(_REF_CACHE[(tuple(p), n)]) for p in prompts]


def ref_decode(prompt, n: int) -> list[int]:
    return ref_decode_many([prompt], n)[0]


_apply_with = jax.jit(lambda params, toks: apply(params, toks, TINY))


def ref_decode_with(params, prompts, n: int) -> list[list[int]]:
    """:func:`ref_decode_many` on other weights ``params`` (a JAX TINY
    tree), uncached."""
    out = []
    for lo in range(0, len(prompts), _REF_SHAPE[0]):
        seqs = [list(p) for p in prompts[lo:lo + _REF_SHAPE[0]]]
        lens = [len(s) for s in seqs]
        for _ in range(n):
            toks = np.zeros(_REF_SHAPE, np.int32)
            for i, s in enumerate(seqs):
                toks[i, :len(s)] = s
            logits = np.asarray(_apply_with(params, toks))
            for i, s in enumerate(seqs):
                s.append(int(logits[i, len(s) - 1].argmax()))
        out += [s[k:] for s, k in zip(seqs, lens)]
    return out
