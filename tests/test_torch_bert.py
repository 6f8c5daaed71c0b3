"""The port's BERT encoder (edl_tpu_torch.models.bert) held against the JAX
package's on TINY, with the JAX-initialized weights carried across through
edl_tpu_torch.interop: hidden states, MLM loss and every parameter
gradient, on the reference attention path and on the flash path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import bert as jbert
from edl_tpu_torch import interop
from edl_tpu_torch.models import bert

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
#: hidden states: fp32 on both sides.  At s 128 the port's flash path runs
#: the kernels' plain versions while the JAX model, off the TPU, takes its
#: reference attention; the two paths are held at the flash tolerance
HIDDEN_TOL = {False: 1e-5, True: 2e-5}


def _carry(jcfg, cfg):
    params = jbert.init(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = interop.params_from_numpy(bert.Bert(cfg, device="cpu"), tree)
    return params, model


def _batch(seed, b, s, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s), dtype=np.int32)
    targets = rng.integers(0, vocab, (b, s), dtype=np.int32)
    mask = (rng.random((b, s)) < 0.15).astype(np.float32)
    return tokens, targets, mask


@pytest.mark.parametrize("use_flash,seq", [(False, 64), (True, 128)])
def test_tiny_matches_jax(use_flash, seq):
    jcfg = dataclasses.replace(jbert.TINY, use_flash=use_flash,
                               max_seq_len=seq)
    cfg = dataclasses.replace(bert.TINY, use_flash=use_flash,
                              max_seq_len=seq)
    params, model = _carry(jcfg, cfg)
    batch = _batch(1, 2, seq, cfg.vocab_size)
    tokens = batch[0]

    ref_hidden = jbert.apply(params, jnp.asarray(tokens), jcfg)
    hidden = bert.apply(model, torch.from_numpy(tokens))
    assert hidden.shape == (2, seq, cfg.d_model)
    np.testing.assert_allclose(hidden.detach().numpy(),
                               np.asarray(ref_hidden),
                               atol=HIDDEN_TOL[use_flash],
                               rtol=HIDDEN_TOL[use_flash])

    ref_loss, ref_grads = jax.value_and_grad(jbert.make_loss_fn(jcfg))(
        params, tuple(jnp.asarray(a) for a in batch))
    loss = bert.make_loss_fn(cfg)(model, tuple(torch.from_numpy(a)
                                               for a in batch))
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


def test_attention_is_bidirectional():
    model = bert.Bert(bert.TINY, device="cpu", seed=0)
    t1 = torch.arange(32).reshape(2, 16) % bert.TINY.vocab_size
    t2 = t1.clone()
    t2[0, 10] = 7
    with torch.no_grad():
        h1, h2 = bert.apply(model, t1), bert.apply(model, t2)
    assert not torch.allclose(h1[0, :10], h2[0, :10])
    torch.testing.assert_close(h1[1], h2[1])


def test_empty_mask_gives_zero_loss():
    model = bert.Bert(bert.TINY, device="cpu", seed=0)
    tokens, targets, mask = _batch(2, 2, 16, bert.TINY.vocab_size)
    loss = bert.mlm_loss_fn(model, (torch.from_numpy(tokens),
                                    torch.from_numpy(targets),
                                    torch.zeros(2, 16)))
    assert loss.item() == 0.0


def test_bert_base_has_the_published_size():
    assert bert.BERT_BASE.head_dim == 64 and bert.BERT_BASE.use_flash
    model = bert.Bert(dataclasses.replace(bert.BERT_BASE, n_layers=1),
                      device="cpu")
    per_layer = sum(p.numel() for p in model.layers[0].parameters())
    assert per_layer == 4 * 768 * 768 + 2 * 768 * 3072 + 2 * 768
