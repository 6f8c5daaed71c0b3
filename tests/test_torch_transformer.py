"""The port's decoder (edl_tpu_torch.models.transformer) held against the
JAX package's on TINY, with the JAX-initialized weights carried across
through edl_tpu_torch.interop: logits, loss and every parameter gradient."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jtfm
from edl_tpu.ops.flash_attention import attention as jax_attention
from edl_tpu_torch import interop
from edl_tpu_torch.models import transformer as tfm

#: fp32 on both sides; the sums run in another order in each framework.
#: Logits at s 128 take the JAX flash tests' forward tolerance: with twice
#: the positions, a few of the 65 536 logits (|logit| up to ~6) land
#: 1-2e-5 apart on the reference path as on the flash path
LOGIT_TOL = {64: 1e-5, 128: 2e-5}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _carry(jcfg, cfg):
    params = jtfm.init(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = interop.params_from_numpy(tfm.Transformer(cfg, device="cpu"),
                                      tree)
    return params, model


def _batch(seed, b, s, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s), dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.mark.parametrize("use_flash,seq", [(False, 64), (True, 128)])
def test_tiny_matches_jax(use_flash, seq, monkeypatch):
    """use_flash=True at s 128 runs the flash path's plain versions inside
    the port's model, against the JAX model with its Pallas kernels in
    interpret mode (off the TPU it would take its reference attention)."""
    monkeypatch.setattr(jtfm, "flash_attention",
                        functools.partial(jax_attention, interpret=True))
    jcfg = dataclasses.replace(jtfm.TINY, use_flash=use_flash)
    cfg = dataclasses.replace(tfm.TINY, use_flash=use_flash)
    params, model = _carry(jcfg, cfg)
    tokens, targets = _batch(1, 2, seq, cfg.vocab_size)

    ref_logits = jtfm.apply(params, jnp.asarray(tokens), jcfg)
    logits = tfm.apply(model, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), atol=LOGIT_TOL[seq],
                               rtol=LOGIT_TOL[seq])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jtfm.loss_fn),
                                  static_argnums=2)(
        params, (jnp.asarray(tokens), jnp.asarray(targets)), jcfg)
    loss = tfm.loss_fn(model, (torch.from_numpy(tokens),
                               torch.from_numpy(targets)))
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


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy):
    base = dataclasses.replace(tfm.TINY, remat=False)
    tokens, targets = _batch(2, 2, 64, base.vocab_size)
    batch = (torch.from_numpy(tokens), torch.from_numpy(targets))
    results = []
    for cfg in (base, dataclasses.replace(base, remat=True,
                                          remat_policy=policy)):
        model = tfm.Transformer(cfg, device="cpu", seed=3)
        loss = tfm.loss_fn(model, batch)
        loss.backward()
        results.append((loss.item(), [p.grad for p in model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_params_round_trip_through_numpy():
    params = jtfm.init(jax.random.key(0), jtfm.TINY)
    tree = jax.tree.map(np.asarray, params)
    model = interop.params_from_numpy(
        tfm.Transformer(tfm.TINY, device="cpu"), tree)
    back = interop.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(interop._leaves(tree), interop._leaves(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bf16_leaves_cross_through_uint16():
    params = jtfm.init(jax.random.key(0), jtfm.TINY)
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), params)
    model = interop.params_from_numpy(
        tfm.Transformer(tfm.TINY, device="cpu"), tree)
    want = np.asarray(params["layers"][1]["wq"].astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(model.layers[1].wq.detach().numpy(), want)


def test_load_rejects_a_mismatched_tree():
    tree = jax.tree.map(np.asarray, jtfm.init(jax.random.key(0), jtfm.TINY))
    model = tfm.Transformer(tfm.TINY, device="cpu")
    del tree["norm"]
    with pytest.raises(KeyError):
        interop.params_from_numpy(model, tree)
    tree["norm"] = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        interop.params_from_numpy(model, tree)


def test_gather_and_one_hot_embedding_agree():
    from edl_tpu_torch.ops.embedding import embed_lookup

    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((32, 8), dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(0, 32, (2, 5)))
    gather = embed_lookup(table, tokens, one_hot=False, dtype=torch.float32)
    hot = embed_lookup(table, tokens, one_hot=True, dtype=torch.float32)
    assert gather.shape == (2, 5, 8)
    torch.testing.assert_close(gather, hot)
