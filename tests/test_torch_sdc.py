"""The port's fingerprint primitives against the JAX package's, bitwise:
the scenarios of tests/test_sdc.py's TestFingerprintPrimitives, per-leaf
folds of fp32, bf16, int32, odd-length and empty leaves given as numpy
arrays and as torch tensors, the folds of MLP and TINY params carried
across by interop, ``flip_tree_bit`` and the trainer's ``flip_param_bits``
against the reference's ``flip_tree_bit``, and the device fold
(``device_tree_folds``) against the host fold on CPU tensors."""

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
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.sdc import (UpdateFingerprinter,
                                       device_tree_folds, flip_tree_bit,
                                       fold_fingerprint, leaf_fold,
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

    def test_flip_is_an_involution_and_copies(self):
        for t in ({"w": np.arange(8, dtype=np.float32)},
                  {"w": torch.arange(8, dtype=torch.float32)}):
            before = np.array(t["w"])
            once = flip_tree_bit(t, leaf=0, bit=3)
            assert np.array_equal(np.asarray(t["w"]), before)  # untouched
            assert tree_fingerprint(once) != tree_fingerprint(t)
            twice = flip_tree_bit(once, leaf=0, bit=3)
            assert tree_fingerprint(twice) == tree_fingerprint(t)

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


def _mlp_params():
    return jax.tree.map(np.asarray, jmlp.init(jax.random.key(0),
                                              [16, 32, 4]))


@pytest.mark.parametrize("leaf, bit", [(0, 17), (1, 30), (2, 9), (3, 30),
                                       (7, 1000), (2, 8 * 2047 + 7)])
def test_flip_tree_bit_equals_the_reference_bitwise(leaf, bit):
    """The same numpy-seeded MLP params through both packages: the port's
    flip of a numpy tree, of a tree of tensors, and the trainer's in-place
    flip of its module all flip the reference's bit, and fingerprint as
    the reference's flipped tree."""
    params = _mlp_params()
    want = ref.flip_tree_bit(params, leaf=leaf, bit=bit)
    got = flip_tree_bit(params, leaf=leaf, bit=bit)
    for k in params:
        assert np.asarray(want[k]).tobytes() == got[k].tobytes(), k
    tensors = flip_tree_bit({k: torch.from_numpy(v.copy())
                             for k, v in params.items()}, leaf=leaf, bit=bit)
    assert tree_fingerprint(tensors) == tree_fingerprint(got) == \
        ref.tree_fingerprint(want)
    module = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                       params)
    trainer = ElasticTrainer(mlp.loss_fn, module, optim.adam(1e-2),
                             devices=[torch.device("cpu")])
    trainer.flip_param_bits(leaf=leaf, bit=bit)
    assert tree_fingerprint(module) == ref.tree_fingerprint(want)
    assert tree_fingerprint(module) != ref.tree_fingerprint(params)


def test_module_fingerprint_equals_the_references_tree():
    params = _mlp_params()
    module = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                       params)
    assert tree_leaf_folds(module) == ref.tree_leaf_folds(params)
    assert tree_fingerprint(module) == ref.tree_fingerprint(params)
    with pytest.raises(TypeError, match="flip_param_bits"):
        flip_tree_bit(module)


DEVICE_FOLD_LEAVES = ("fp32", "bf16", "bf16_odd", "int32", "empty", "scalar")


@pytest.mark.parametrize("kind", DEVICE_FOLD_LEAVES)
def test_device_fold_equals_the_host_fold_on_cpu(kind):
    """The lane xor taken as the device takes it (an int32 view xor-reduced
    by halving, 16-bit pairs little-endian), run on a CPU tensor, equals the
    host fold's lane xor, and with the tail mix the reference's fold."""
    a = LEAVES[kind]()
    t = _tensor(a)
    lanes, = device_tree_folds({"x": t})
    from edl_tpu_torch.runtime.sdc import _mix_tail

    assert _mix_tail(lanes, t.numel() * t.element_size(),
                     str(t.dtype).removeprefix("torch.")) == \
        ref.leaf_fold(a) == leaf_fold(t)


def test_device_path_fingerprints_as_the_host_path():
    arrays = {k: LEAVES[k]() for k in DEVICE_FOLD_LEAVES}
    tree = {k: _tensor(a) for k, a in arrays.items()}
    fp = UpdateFingerprinter()
    fp._prefer_device = True
    assert fp.fingerprint(tree) == ref.tree_fingerprint(arrays)
    assert fp._device_checked
    with pytest.raises(NotImplementedError, match="16-bit"):
        device_tree_folds({"b": torch.zeros(3, dtype=torch.int8)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(6, 5), (7,), (3, 4, 5), (1,), ()])
def test_block_folds_compose_to_the_whole_leafs(dtype, shape):
    """A leaf cut into blocks along every dimension (a sharded trainer's
    blocks): the xor of each block's share (``block_words``) is the whole
    leaf's lane xor, whatever the parity of the blocks' flat offsets, and
    with the tail mix the reference's fold."""
    import itertools

    from edl_tpu_torch.runtime.sdc import _mix_tail, block_words, lane_xors

    rng = np.random.default_rng(len(shape))
    full = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    splits = [[(0, n)] if n < 2 else [(0, n // 2), (n // 2, n)]
              for n in shape]
    acc = 0
    for index in itertools.product(*splits):
        block = full[tuple(slice(lo, hi) for lo, hi in index)]
        acc ^= lane_xors([block_words(block, index, shape)])[0]
    assert acc == device_tree_folds({"x": full})[0]
    assert _mix_tail(acc, full.numel() * full.element_size(),
                     str(dtype).removeprefix("torch.")) == leaf_fold(full)
