"""The port's ResNet (edl_tpu_torch.models.resnet) held against the JAX
package's on TINY, with the JAX-initialized weights carried across through
edl_tpu_torch.interop: logits, loss and every parameter gradient, at an
even and an odd image size (which pins JAX's asymmetric "SAME" padding),
for both stems, and three ElasticTrainer steps against the JAX trainer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import resnet as jres
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import interop
from edl_tpu_torch.models import resnet
from edl_tpu_torch.ops import group_norm as gn
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer

#: fp32 on both sides; the sums run in another order in each framework
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _carry(jcfg, cfg):
    params = jres.init(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = interop.params_from_numpy(resnet.ResNet(cfg, device="cpu"), tree)
    return params, model


def _batch(seed, b, hw, classes=10):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, hw, hw, 3), dtype=np.float32)
    labels = rng.integers(0, classes, b, dtype=np.int32)
    return images, labels


@pytest.mark.parametrize("stem,hw", [("conv7", 32), ("conv7", 29),
                                     ("s2d", 32)])
def test_tiny_matches_jax(stem, hw):
    jcfg = dataclasses.replace(jres.TINY, stem=stem)
    cfg = dataclasses.replace(resnet.TINY, stem=stem)
    params, model = _carry(jcfg, cfg)
    images, labels = _batch(1, 2, hw)

    ref_logits = jres.apply(params, jnp.asarray(images), jcfg)
    logits = resnet.apply(model, torch.from_numpy(images))
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

    ref_loss, ref_grads = jax.value_and_grad(jres.make_loss_fn(jcfg))(
        params, (jnp.asarray(images), jnp.asarray(labels)))
    loss = resnet.make_loss_fn(cfg)(model, (torch.from_numpy(images),
                                            torch.from_numpy(labels)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    ref_leaves = list(interop._leaves(jax.tree.map(np.asarray, ref_grads)))
    assert len(ref_leaves) == len(grads)
    for path, want in ref_leaves:
        got = grads[".".join(str(p) for p in path)]
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL,
                                   err_msg=interop.keystr(path))


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (56, 2, 1, (0, 1)),
    (29, 7, 2, (3, 3))])
def test_same_pads_match_jax(size, k, stride, want):
    assert resnet.same_pads(size, k, stride) == want
    x = jnp.zeros((1, size, size, 1))
    w = jnp.zeros((k, k, 1, 1))
    out = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    pads = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert tuple(pads[0]) == want and out.shape[1] == -(-size // stride)


def test_bf16_tiny_step_is_finite():
    cfg = dataclasses.replace(resnet.TINY, dtype=torch.bfloat16)
    model = resnet.ResNet(cfg, device="cpu", seed=0)
    images, labels = _batch(2, 2, 32)
    trainer = ElasticTrainer(resnet.loss_fn, model, optim.adamw(1e-3),
                             devices=[torch.device("cpu")])
    losses = [trainer.step((images, labels)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_three_steps_match_jax_trainer():
    params, model = _carry(jres.TINY, resnet.TINY)
    jt = JaxTrainer(jres.make_loss_fn(jres.TINY), params, optax.adamw(3e-4),
                    devices=jax.devices()[:1])
    pt = ElasticTrainer(resnet.loss_fn, model, optim.adamw(3e-4),
                        devices=[torch.device("cpu")])
    batch = _batch(3, 4, 32)
    for _ in range(3):
        np.testing.assert_allclose(pt.step(batch), jt.step(batch), rtol=1e-4)


def test_params_round_trip_through_numpy():
    tree = jax.tree.map(np.asarray, jres.init(jax.random.key(0), jres.TINY))
    model = interop.params_from_numpy(
        resnet.ResNet(resnet.TINY, device="cpu"), tree)
    back = interop.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(interop._leaves(tree), interop._leaves(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_resnet50_shapes_and_group_norm_sites():
    model = resnet.ResNet(resnet.RESNET50, device="cpu")
    assert sum(len(s) for s in model.stages) == 16
    assert model.head.shape == (2048, 1000)
    sites = resnet.group_norm_sites(resnet.RESNET50, 224)
    assert sum(sites.values()) == 53 and len(sites) == 12
    assert sites[(12544, 64)] == 1 and sites[(49, 2048)] == 4
    # 11.11 M GroupNorm elements per image
    assert sum(hw * c * n for (hw, c), n in sites.items()) == 11_113_984


def test_group_norm_sites_are_the_norms_a_forward_runs(monkeypatch):
    seen = []
    real = gn.GroupNormFn.apply

    def spy(x2d, *args):
        seen.append(tuple(x2d.shape[1:]))
        return real(x2d, *args)

    monkeypatch.setattr(gn.GroupNormFn, "apply", spy)
    for cfg, hw in ((resnet.TINY, 32), (resnet.TINY, 29),
                    (dataclasses.replace(resnet.TINY, stem="s2d"), 32)):
        seen.clear()
        model = resnet.ResNet(cfg, device="cpu")
        resnet.apply(model, torch.zeros(1, hw, hw, 3))
        assert sorted(seen) == sorted(resnet.group_norm_sites(cfg, hw)
                                      .elements())
