"""The port's flash attention (edl_tpu_torch.ops.flash_attention) held
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers take the plain PyTorch versions of the
kernels, so these tests pin the algorithm (online-softmax forward, the
logsumexp it saves, both backward passes, the GQA fold) to the reference in
fp32.  The CUDA kernels themselves are held against the plain versions in
tests/test_torch_flash_kernels.py, on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops.flash_attention import _flash_forward
from edl_tpu.ops.flash_attention import attention as jax_attention
from edl_tpu_torch.ops import flash_attention as fa

B, S, D = 2, 256, 64
#: small Pallas blocks, so the JAX side runs several q and k blocks per
#: head and its online recurrence and dK/dV group sum are exercised
JAX_BLOCKS = dict(block_q=64, block_k=128)
#: (h, hk, causal): GQA causal and non-causal, plus an MHA case
CASES = [(4, 2, True), (4, 2, False), (4, 4, True)]
#: the JAX package's own flash tolerances for fp32
FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(seed, h, hk, s=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, h, D), dtype=np.float32)
    k = rng.standard_normal((B, s, hk, D), dtype=np.float32)
    v = rng.standard_normal((B, s, hk, D), dtype=np.float32)
    w = rng.standard_normal((B, s, h, D), dtype=np.float32)
    return q, k, v, w


def _fold_np(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("h,hk,causal", CASES)
def test_forward_matches_jax_pallas(h, hk, causal):
    q, k, v, _ = _inputs(0, h, hk)
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, use_pallas=True, interpret=True,
                        **JAX_BLOCKS)
    out = fa.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("h,hk,causal", CASES)
def test_lse_matches_jax_pallas(h, hk, causal):
    q, k, v, _ = _inputs(1, h, hk)
    fq, fk, fv = _fold_np(q), _fold_np(k), _fold_np(v)
    ref_out, ref_lse = _flash_forward(
        jnp.asarray(fq), jnp.asarray(fk), jnp.asarray(fv), causal,
        JAX_BLOCKS["block_q"], JAX_BLOCKS["block_k"], h, hk, interpret=True)
    out, lse = fa.flash_forward(torch.from_numpy(fq), torch.from_numpy(fk),
                                torch.from_numpy(fv), causal, h, hk)
    assert lse.shape == (B * h, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("h,hk,causal", CASES)
def test_gradients_match_jax_pallas(h, hk, causal):
    q, k, v, w = _inputs(2, h, hk)

    def f_jax(q, k, v):
        out = jax_attention(q, k, v, causal=causal, use_pallas=True,
                            interpret=True, **JAX_BLOCKS)
        return jnp.sum(out * jnp.asarray(w))

    ref = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)
     ).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_cpu_tensors_never_launch_a_kernel():
    fa.reset_launches()
    q, k, v, w = _inputs(3, 4, 2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    assert tq.grad is not None and tk.grad.shape == tk.shape
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_ineligible_shapes_take_the_reference(use_pallas):
    # s = 96 is not a multiple of 128, so both packages take the reference
    # on repeated kv heads; use_pallas=False does the same at any length
    q, k, v, _ = _inputs(4, 4, 2, s=96)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = fa.attention(tq, tk, tv, causal=True, use_pallas=use_pallas)
    ref = fa.reference_attention(tq, tk.repeat_interleave(2, dim=2),
                                 tv.repeat_interleave(2, dim=2))
    assert torch.equal(out, ref)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, use_pallas=use_pallas, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_fit_blocks_matches_jax():
    from edl_tpu.ops.flash_attention import fit_blocks as jax_fit_blocks

    for s in (128, 256, 1024, 1536, 2560, 8192, 100):
        assert fa.fit_blocks(s) == jax_fit_blocks(s)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "seq"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    # the checks run before the kernel library is touched, so they hold
    # without a card or a compiler
    d = 32 if bad == "head_dim" else 64
    s = 96 if bad == "seq" else 128
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    q = torch.zeros(4, s, d, dtype=dtype)
    k = torch.zeros(2, s, d, dtype=dtype)
    with pytest.raises(ValueError):
        fa.flash_forward_cuda(q, k, k.clone(), True, 4, 2)
