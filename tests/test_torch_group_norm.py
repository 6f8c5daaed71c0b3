"""The port's GroupNorm (edl_tpu_torch.ops.group_norm) held against the JAX
package's Pallas kernels, run in interpret mode on the CPU, and against its
fp32 reference path.

On the CPU the port takes the plain PyTorch versions of the kernels, so
these tests pin their arithmetic (the statistics, the per-channel
coefficients, the dγ/dβ partials and dx) to the reference.  The CUDA
kernels themselves are held against the plain versions in
tests/test_torch_group_norm_kernels.py, on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import group_norm as jgn
from edl_tpu_torch.models import resnet
from edl_tpu_torch.ops import group_norm as gn

#: (b, h, w, c, groups): the JAX test's shape, cg 2 (the ResNet-50 stem's
#: fold), and a wide one
SHAPES = [(3, 6, 5, 16, 4), (2, 7, 7, 64, 32), (2, 4, 4, 256, 32)]
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c), dtype=np.float32) * 2 + 0.5)
    scale = rng.standard_normal(c, dtype=np.float32)
    bias = rng.standard_normal(c, dtype=np.float32)
    wgt = rng.standard_normal((b, h, w, c), dtype=np.float32)
    return x, scale, bias, wgt


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("b,h,w,c,groups", SHAPES)
def test_forward_and_gradients_match_jax_pallas(b, h, w, c, groups):
    x, scale, bias, wgt = _inputs(0, b, h, w, c)

    def f_jax(x, s, bb):
        y = jgn.group_norm(x, s, bb, groups, interpret=True)
        return jnp.sum(y * jnp.asarray(wgt)), y

    (_, ref_y), ref_grads = jax.value_and_grad(
        f_jax, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tx, ts, tb = _torch(x, scale, bias, grad=True)
    y = gn.group_norm(tx, ts, tb, groups)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               atol=FWD_TOL, rtol=FWD_TOL)
    (y * torch.from_numpy(wgt)).sum().backward()
    for got, want in zip((tx.grad, ts.grad, tb.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("b,h,w,c,groups", SHAPES)
def test_statistics_match_jax_pallas(b, h, w, c, groups):
    x, scale, bias, _ = _inputs(1, b, h, w, c)
    x2d = x.reshape(b, h * w, c)
    _, ref_mean, ref_inv = jgn._fwd(jnp.asarray(x2d), jnp.asarray(scale),
                                    jnp.asarray(bias), groups, 1e-5,
                                    interpret=True)
    _, mean, inv = gn.group_norm_fwd_plain(*_torch(x2d, scale, bias), groups,
                                           1e-5)
    assert mean.shape == inv.shape == (b, groups)
    assert mean.dtype == inv.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean)[:, 0],
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(inv.numpy(), np.asarray(ref_inv)[:, 0],
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("b,h,w,c,groups", SHAPES)
def test_fp32_matches_jax_reference_path(b, h, w, c, groups):
    """use_pallas=False in the JAX package is its fp32 ``_reference``; the
    port's plain path (and its own reference) agree with it, values and
    gradients."""
    x, scale, bias, wgt = _inputs(2, b, h, w, c)

    def f_jax(x, s, bb):
        y = jgn.group_norm(x, s, bb, groups, use_pallas=False)
        return jnp.sum(y * jnp.asarray(wgt)), y

    (_, ref_y), ref_grads = jax.value_and_grad(
        f_jax, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tx, ts, tb = _torch(x, scale, bias, grad=True)
    y = gn.group_norm(tx, ts, tb, groups, use_pallas=False)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               atol=FWD_TOL, rtol=FWD_TOL)
    (y * torch.from_numpy(wgt)).sum().backward()
    for got, want in zip((tx.grad, ts.grad, tb.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    ref = gn.reference(torch.from_numpy(x.reshape(b, h * w, c)),
                       *_torch(scale, bias), groups, 1e-5)
    np.testing.assert_allclose(ref.numpy().reshape(b, h, w, c),
                               np.asarray(ref_y), atol=FWD_TOL, rtol=FWD_TOL)


def _bf16_np(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger of the two (2^-7 of it),
    element by element, plus a floor of 2^-7 of the tensor's RMS for
    elements near zero: XLA on the CPU may keep x·p in fp32 before adding
    q (one rounding), where the port rounds the product first, so where
    x·p and q cancel the two differ by one ulp of the product, not of the
    result."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(w * w)))
    lim = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) + 2.0 ** -7 * rms
    return float(np.max(np.abs(g - w) / lim))


def test_bf16_matches_jax_pallas_within_one_ulp():
    b, h, w, c, groups = 2, 7, 7, 64, 32
    x, scale, bias, dy = _inputs(3, b, h, w, c)
    xb, dyb = _bf16_np(x), _bf16_np(dy)
    jx = jnp.asarray(xb, jnp.bfloat16)
    ref_y, vjp = jax.vjp(
        lambda x: jgn.group_norm(x, jnp.asarray(scale), jnp.asarray(bias),
                                 groups, interpret=True), jx)
    (ref_dx,) = vjp(jnp.asarray(dyb, jnp.bfloat16))
    tx = torch.from_numpy(xb).to(torch.bfloat16).requires_grad_()
    y = gn.group_norm(tx, *_torch(scale, bias), groups)
    y.backward(torch.from_numpy(dyb).to(torch.bfloat16))
    assert y.dtype == tx.grad.dtype == torch.bfloat16
    assert _within_one_ulp(y.detach(), ref_y.astype(jnp.float32)) <= 1.0
    assert _within_one_ulp(tx.grad, ref_dx.astype(jnp.float32)) <= 1.0


def test_cpu_tensors_never_launch_a_kernel():
    gn.reset_launches()
    x, scale, bias, wgt = _inputs(4, 2, 4, 4, 16)
    tx, ts, tb = _torch(x, scale, bias, grad=True)
    for use_pallas in (None, True, False):
        (gn.group_norm(tx, ts, tb, 4, use_pallas=use_pallas)
         * torch.from_numpy(wgt)).sum().backward()
    assert tx.grad is not None and ts.grad.shape == (16,)
    assert gn.launches == {"group_norm_fwd": 0, "group_norm_bwd": 0}


def test_channels_not_divisible_by_groups_raise():
    x = torch.zeros(1, 2, 2, 12)
    with pytest.raises(ValueError):
        gn.group_norm(x, torch.ones(12), torch.zeros(12), 5)


@pytest.mark.parametrize("bad", ["dtype", "channels", "layout", "params"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    # the checks run before the kernel library is touched, so they hold
    # without a card or a compiler
    c = 12 if bad == "channels" else 64
    dtype = torch.float16 if bad == "dtype" else torch.bfloat16
    x = torch.zeros(2, 49, c, dtype=dtype)
    if bad == "layout":
        x = torch.zeros(2, c, 49, dtype=dtype).transpose(1, 2)
    scale = torch.ones(c, dtype=torch.bfloat16 if bad == "params"
                       else torch.float32)
    with pytest.raises(ValueError):
        gn.group_norm_fwd_cuda(x, scale, torch.zeros(c), 4, 1e-5)


#: (hw, c, itemsize): the 12 ResNet-50 site shapes in bf16, then small and
#: odd ones: TINY's narrowest, a single row, and an fp32 map larger than a
#: cluster's shared memory
PLAN_SHAPES = ([(hw, c, 2) for hw, c in sorted(
    resnet.group_norm_sites(resnet.RESNET50, 224))]
    + [(9, 8, 2), (1, 96, 2), (50000, 64, 4)])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hw,c,itemsize", PLAN_SHAPES)
def test_cluster_plan_covers_every_row_once_within_shared_memory(
        hw, c, itemsize, backward):
    k, rows, resident = gn.cluster_plan(hw, c, itemsize, backward)
    assert 1 <= k <= gn.MAX_CLUSTER and k & (k - 1) == 0
    covered = [r for rank in range(k)
               for r in range(rank * rows, min((rank + 1) * rows, hw))]
    assert covered == list(range(hw))
    tensors = 2 if backward else 1
    assert 0 <= resident <= tensors * rows
    assert (resident * c * itemsize + gn.smem_overhead(c)
            <= gn.SMEM_BYTES)
    if itemsize == 2 and (hw, c) in resnet.group_norm_sites(
            resnet.RESNET50, 224) and not backward:
        assert resident == rows  # every bf16 site: the image read once
    if resident < tensors * rows:  # rows are read again only when the
        assert k == gn.MAX_CLUSTER  # largest cluster cannot hold them
