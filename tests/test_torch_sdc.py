"""The port's fingerprint primitives against the JAX package's, bitwise:
the scenarios of tests/test_sdc.py's TestFingerprintPrimitives that hold
without flip_tree_bit, per-leaf folds of fp32, bf16, int32, odd-length and
empty leaves given as numpy arrays and as torch tensors, and the folds of
MLP and TINY params carried across by interop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import mlp as jmlp
from edl_tpu.models import transformer as jtfm
from edl_tpu.runtime import sdc as ref
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.sdc import (fold_fingerprint, leaf_fold,
                                       tree_fingerprint, tree_leaf_folds)


def _flip(a: np.ndarray, bit: int) -> np.ndarray:
    out = a.copy()
    out.reshape(-1).view(np.uint8)[bit // 8] ^= np.uint8(1 << (bit % 8))
    return out


class TestFingerprintPrimitives:
    def test_tree_fingerprint_deterministic_and_bit_sensitive(self):
        t = {"w": np.arange(64, dtype=np.float32),
             "b": {"c": np.ones((4, 4), np.float64)}}
        fp = tree_fingerprint(t)
        assert fp == tree_fingerprint(t) == ref.tree_fingerprint(t)
        assert len(fp) == 16 and int(fp, 16) >= 0
        for flipped in ({"w": _flip(t["w"], 0), "b": t["b"]},
                        {"w": t["w"], "b": {"c": _flip(t["b"]["c"], 0)}}):
            assert tree_fingerprint(flipped) != fp
            assert tree_fingerprint(flipped) == ref.tree_fingerprint(flipped)

    def test_fold_is_dtype_and_shape_sensitive(self):
        trees = [{"x": np.zeros(4, np.float32)},
                 {"x": np.zeros(4, np.float64)},
                 {"x": np.zeros(8, np.float32)}]
        fps = [tree_fingerprint(t) for t in trees]
        assert len(set(fps)) == 3
        assert fps == [ref.tree_fingerprint(t) for t in trees]

    def test_fold_fingerprint_is_path_keyed(self):
        assert fold_fingerprint({"a": 1, "b": 2}) != \
            fold_fingerprint({"a": 2, "b": 1})
        for folds in ({"a": 1, "b": 2}, {"['x']": 2**64 - 1}, {}):
            assert fold_fingerprint(folds) == ref.fold_fingerprint(folds)

    def test_tree_leaf_folds_cover_every_leaf(self):
        t = {"w": np.ones(4, np.float32), "b": {"c": np.ones(2, np.int32)},
             "l": [np.zeros(3, np.int8)]}
        folds = tree_leaf_folds(t)
        assert folds == ref.tree_leaf_folds(t)
        assert set(folds) == {"['w']", "['b']['c']", "['l'][0]"}
        assert all(isinstance(v, int) for v in folds.values())


LEAVES = {
    "fp32": lambda: np.random.default_rng(0).normal(size=(5, 7)).astype(
        np.float32),
    "bf16": lambda: np.asarray(jnp.asarray(np.random.default_rng(1).normal(
        size=(3, 5)), jnp.bfloat16)),
    "bf16_odd": lambda: np.asarray(jnp.arange(7, dtype=jnp.bfloat16)),
    "int32": lambda: np.arange(-9, 12, dtype=np.int32).reshape(3, 7),
    "int8_odd": lambda: np.arange(13, dtype=np.int8),
    "empty": lambda: np.zeros((0, 4), np.float32),
    "scalar": lambda: np.asarray(7, np.int32),
}


def _tensor(a: np.ndarray) -> torch.Tensor:
    return interop._to_tensor(a)  # a bf16 leaf crosses as its bits


@pytest.mark.parametrize("kind", sorted(LEAVES))
def test_leaf_fold_equals_the_reference_bitwise(kind):
    a = LEAVES[kind]()
    want = ref.leaf_fold(a)
    assert leaf_fold(a) == want
    t = _tensor(a)
    assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
    assert leaf_fold(t) == want
    assert leaf_fold(t.t() if t.dim() == 2 else t) == (
        ref.leaf_fold(np.ascontiguousarray(a.T)) if a.ndim == 2 else want)


def test_mixed_tree_of_tensors_and_arrays_equals_the_reference():
    arrays = {k: f() for k, f in LEAVES.items()}
    mixed = {k: (_tensor(a) if i % 2 else a)
             for i, (k, a) in enumerate(sorted(arrays.items()))}
    assert tree_leaf_folds(mixed) == ref.tree_leaf_folds(arrays)
    assert tree_fingerprint(mixed) == ref.tree_fingerprint(arrays)


@pytest.mark.parametrize("model", ["mlp", "tiny"])
def test_params_carried_by_interop_fold_as_the_reference(model):
    if model == "mlp":
        jparams = jmlp.init(jax.random.key(0), [16, 32, 4])
        module = mlp.MLP([16, 32, 4], device="cpu")
    else:
        jparams = jtfm.init(jax.random.key(0), jtfm.TINY)
        module = tfm.Transformer(tfm.TINY, device="cpu")
    interop.params_from_numpy(module, jax.tree.map(np.asarray, jparams))
    want = ref.tree_leaf_folds({"params": jparams})
    assert ElasticCheckpointer._tree_folds({"params": module}) == want
    assert tree_leaf_folds(
        {"params": interop.params_to_numpy(module)}) == want
    assert fold_fingerprint(want) == ref.tree_fingerprint({"params": jparams})
