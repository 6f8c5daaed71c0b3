"""Fingerprint primitives of the silent-data-corruption plane — the host
half of edl_tpu.runtime.sdc that checkpoint manifests are built on.

A leaf's fold is the xor of its raw little-endian bytes taken as 4-byte
lanes (a byte count that is not a multiple of 4 is padded with zeros), then
mixed with its byte length and the numpy name of its dtype (``float32``,
``bfloat16``, ``int32``), so a truncation or a dtype drift cannot fold to an
honest leaf's value.  Leaves are keyed by their JAX keystr path
(``['params']['w0']``, :func:`edl_tpu_torch.interop.keystr`), so the same
bytes under the same path fold, and fingerprint, to the same numbers as the
JAX package's.  A leaf may be a numpy array or a torch tensor on any device
(a device tensor is copied to the host first).

The rest of the plane (the update fingerprinter, the anomaly detector, the
shadow recompute, the rollback ladder, the on-device fold and
``flip_tree_bit``) is a later item of the port (ROADMAP.md, queue 1 item 7).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from edl_tpu_torch.interop import keystr

_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def _host_bytes(x: Any) -> tuple[np.ndarray, str]:
    """The leaf's raw bytes as a flat uint8 array, and its dtype's numpy
    name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy(), str(t.dtype).removeprefix(
            "torch.")
    a = np.ascontiguousarray(np.asarray(x))
    return a.reshape(-1).view(np.uint8), str(a.dtype)


def leaf_fold(x: Any) -> int:
    """xor-fold the raw bytes of one leaf into 64 bits: the xor of its
    4-byte lanes (commutative, so any lane order gives the same value),
    then :func:`_mix_tail` of its byte length and dtype name."""
    raw, dtype = _host_bytes(x)
    n = raw.size
    if n % 4 == 0 and n:
        lanes = raw.view(np.uint32)
    else:
        buf = raw.tobytes() + b"\0" * ((-n) % 4)
        lanes = np.frombuffer(buf, dtype=np.uint32)
    acc = int(np.bitwise_xor.reduce(lanes)) if lanes.size else 0
    return _mix_tail(acc, n, dtype)


def _mix_tail(acc: int, nbytes: int, dtype_str: str) -> int:
    """The order-sensitive tail mix: length and dtype name keep shape and
    type drift from folding to an honest leaf's value."""
    acc = ((acc * _FNV_PRIME) ^ nbytes) & _MASK64
    for ch in dtype_str.encode():
        acc = ((acc * _FNV_PRIME) ^ ch) & _MASK64
    return acc


def _leaves_with_path(tree: Any, path: tuple = ()):
    """(path, leaf) of every leaf of nested dicts (sorted keys, as JAX
    flattens them), lists and tuples."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_path(sub, path + (i,))
    else:
        yield path, tree


def tree_leaf_folds(tree: Any) -> dict[str, int]:
    """Per-leaf folds keyed by keystr path — the unit of blame a
    fingerprint mismatch localizes to, and what checkpoint manifests store
    so a partial restore can verify the paths it shares."""
    return {keystr(path): leaf_fold(leaf)
            for path, leaf in _leaves_with_path(tree)}


def tree_fingerprint(tree: Any) -> str:
    """16-hex-digit order-sensitive mix over the sorted per-leaf folds."""
    return fold_fingerprint(tree_leaf_folds(tree))


def fold_fingerprint(folds: dict[str, int]) -> str:
    """Fingerprint from precomputed per-leaf folds (FNV-1a over each sorted
    path's bytes, then its fold)."""
    acc = 0xCBF29CE484222325  # FNV-1a offset basis
    for path in sorted(folds):
        for ch in path.encode():
            acc = ((acc ^ ch) * _FNV_PRIME) & _MASK64
        acc = ((acc ^ (int(folds[path]) & _MASK64)) * _FNV_PRIME) & _MASK64
    return f"{acc:016x}"
