"""The port's MLP against edl_tpu.models.mlp: the JAX params carried by
interop, the same logits, loss, accuracy and gradients on the same
inputs."""

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models import mlp as jmlp
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp

SIZES = [16, 32, 8, 4]
#: fp32 forward and backward of a three-layer MLP
ATOL = 1e-5


def _pair(seed=0):
    jparams = jmlp.init(jax.random.key(seed), SIZES)
    module = interop.params_from_numpy(mlp.MLP(SIZES, device="cpu"),
                                       jax.tree.map(np.asarray, jparams))
    return jparams, module


def _batch(n=64, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, SIZES[0])).astype(np.float32),
            rng.integers(0, SIZES[-1], n).astype(np.int32))


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def test_init_has_the_reference_names_shapes_and_scale():
    module = mlp.MLP(SIZES, device="cpu", seed=0)
    jparams = jmlp.init(jax.random.key(0), SIZES)
    got = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in jparams.items()}
    assert all(not p.any() for n, p in module.named_parameters()
               if n.startswith("b"))
    w = module.w0.detach().numpy()
    assert abs(w.std() - np.sqrt(2.0 / SIZES[0])) < 0.05
    again = mlp.MLP(SIZES, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in
               zip(module.parameters(), again.parameters()))


def test_apply_loss_and_accuracy_match_the_reference():
    jparams, module = _pair()
    batch = _batch()
    np.testing.assert_allclose(
        mlp.apply(module, torch.from_numpy(batch[0])).detach().numpy(),
        np.asarray(jmlp.apply(jparams, batch[0])), rtol=0, atol=ATOL)
    with torch.no_grad():
        loss = float(mlp.loss_fn(module, _t(batch)))
    assert abs(loss - float(jmlp.loss_fn(jparams, batch))) < ATOL
    assert float(mlp.accuracy(module, _t(batch))) == pytest.approx(
        float(jmlp.accuracy(jparams, batch)))


def test_gradients_match_the_reference():
    jparams, module = _pair(seed=3)
    batch = _batch(seed=4)
    mlp.loss_fn(module, _t(batch)).backward()
    want = jax.grad(jmlp.loss_fn)(jparams, batch)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_params_round_trip_through_interop():
    jparams, module = _pair(seed=5)
    back = interop.params_to_numpy(module)
    assert set(back) == set(jparams)
    for k, v in jparams.items():
        assert np.array_equal(back[k], np.asarray(v))
