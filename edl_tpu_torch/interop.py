"""Carry weights between the JAX package's params and the port's modules.

The JAX side hands over its params as a numpy pytree
(``jax.tree.map(np.asarray, params)``): nested dicts and lists of arrays.
Leaves are keyed by their JAX tree paths (``['layers'][0]['wq']``), which map
one to one onto the module's parameter names (``layers.0.wq``).  A bf16 leaf
crosses through a ``uint16`` view, since numpy has no bf16 of its own.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
import torch.nn as nn


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def keystr(path: tuple) -> str:
    """``('layers', 0, 'wq')`` → ``['layers'][0]['wq']`` (jax's keystr)."""
    return "".join(f"[{p!r}]" for p in path)


def _name(path: tuple) -> str:
    return ".".join(str(p) for p in path)


def _to_tensor(leaf: np.ndarray) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(module: nn.Module, tree: Any) -> nn.Module:
    """Load the numpy pytree ``tree`` into ``module``'s parameters, in place;
    every leaf must name one parameter of the same shape, and every
    parameter must be covered."""
    params = dict(module.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, leaf in _leaves(tree):
            name = _name(path)
            if name not in params:
                raise KeyError(f"{keystr(path)} has no parameter {name!r}")
            src = _to_tensor(leaf)
            if tuple(src.shape) != tuple(params[name].shape):
                raise ValueError(f"{keystr(path)}: shape {tuple(src.shape)} "
                                 f"!= {tuple(params[name].shape)}")
            params[name].copy_(src)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"params missing from the tree: {missing}")
    return module


def params_to_numpy(module: nn.Module) -> dict:
    """The module's parameters as the JAX-shaped numpy pytree (a bf16
    parameter comes back as its ``uint16`` bits)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        t = p.detach().cpu()
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy().copy())
        *parents, last = [int(x) if x.isdigit() else x
                          for x in name.split(".")]
        node = tree
        for key, nxt in zip(parents, parents[1:] + [last]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = arr
    return tree


def word2vec_from_numpy(tree: dict, device="cuda"):
    """A :class:`~edl_tpu_torch.models.word2vec.Word2Vec` holding the JAX
    package's word2vec params ``tree`` (``emb``, ``w_h``, ``b_h``, ``w_o``,
    ``b_o``); the vocabulary, context, embedding and hidden sizes are read
    off the leaves' shapes."""
    from edl_tpu_torch.models.word2vec import Word2Vec

    vocab, emb_dim = np.shape(tree["emb"])
    flat, hidden = np.shape(tree["w_h"])
    model = Word2Vec(vocab, flat // emb_dim, emb_dim, hidden, device=device)
    return params_from_numpy(model, tree)
