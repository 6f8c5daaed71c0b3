"""The port's ring attention (edl_tpu_torch.parallel.ring_attention) on
spawned gloo worlds, held against the JAX package's on the virtual CPU mesh
with the reference's own tolerances (tests/test_models_ops.py):

* the plain ring on four ranks against ``ring_attention`` on four devices,
  causal and full, with its gradients;
* the flash ring's CPU form (the plain flash versions once per chunk,
  merged by logsumexp, its backward against the global lse) against
  ``ring_flash_attention_sharded(interpret=True)``, kv heads 4 and 2;
* a chunk the flash ring does not take (64 tokens), which routes to the
  plain ring on repeated kv heads, against the reference's same case;
* the hop census: one collective-permute a tensor a hop, through the
  trainer's choke point;
* GQA on a tp-2 × sp-2 layout against the reference's flash ring on the
  same mesh.

One world of four ranks runs every scenario (tests/torch_world.py,
``suite_ring_four``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as tw
from edl_tpu.ops.flash_attention import reference_attention
from edl_tpu.parallel.compat import set_mesh
from edl_tpu.parallel.mesh import MeshSpec as JMeshSpec
from edl_tpu.parallel.mesh import make_mesh as jmake_mesh
from edl_tpu.parallel.ring_attention import (ring_attention,
                                             ring_flash_attention_sharded)
from edl_tpu_torch.parallel import ring_attention as ring

WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

#: the reference's tolerances: outputs 2e-5 (test_ring_attention_matches_
#: reference), the flash ring's gradients 5e-4
OUT_TOL, FLASH_GRAD_TOL = 2e-5, 5e-4
#: the plain ring's gradients: the roadmap's starting tolerance for
#: gradients (the reference tests the plain ring's output only)
GRAD_TOL = 1e-4


def _normal(seed: int, *shapes) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


CASES = {
    "plain": _normal(2, *[(2, 64, 2, 16)] * 3),
    "flash": {hk: _normal(3 + hk, (2, 512, 4, 32), (2, 512, hk, 32),
                          (2, 512, hk, 32)) for hk in (4, 2)},
    "unaligned": _normal(4, (1, 256, 2, 32), (1, 256, 1, 32),
                         (1, 256, 1, 32)),
    "gqa": _normal(9, (2, 512, 4, 32), (2, 512, 2, 32), (2, 512, 2, 32)),
}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.run("ring_four", 4, tmp_path_factory.mktemp("ring4"),
                  WORLD_DEADLINE_S, cases=CASES)


def _mesh(**axes):
    return jmake_mesh(4, JMeshSpec(dp=1, **axes),
                      devices=jax.devices()[:4])


def _ref_grads(fn, q, k, v):
    """(out, dq, dk, dv) of Σ fn(q, k, v)², JAX."""
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return (out, *grads)


def _ref_flash(q, k, v, **axes):
    with set_mesh(_mesh(**axes)):
        got = jax.jit(lambda q, k, v: _ref_grads(
            lambda q, k, v: ring_flash_attention_sharded(
                q, k, v, causal=True, interpret=True), q, k, v))(q, k, v)
    return tuple(np.asarray(x) for x in got)


def _gather(chunks) -> tuple:
    """The ranks' (out, dq, dk, dv) chunks, in rank order, joined along the
    sequence."""
    return tuple(np.concatenate(parts, axis=1) for parts in zip(*chunks))


def _assert_close(got, want, out_tol, grad_tol):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        tol = out_tol if name == "out" else grad_tol
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_ring_matches_the_reference_ring(four, causal):
    """Four ranks, 16 tokens each: the output within the reference's 2e-5
    of ``ring_attention`` on four devices, and the gradients of Σ out²
    within 1e-4 of the reference's through its shard_map."""
    mesh = _mesh(sp=-1)
    want = _ref_grads(lambda q, k, v: ring_attention(
        q, k, v, mesh, axis="sp", causal=causal), *CASES["plain"])
    got = _gather([g[causal] for g in tw.scenario(four, "plain")])
    _assert_close(got, want, OUT_TOL, GRAD_TOL)


@pytest.mark.parametrize("hk", [4, 2])
def test_flash_ring_cpu_form_matches_the_reference(four, hk):
    """The flash ring with the plain flash versions per chunk, 128 tokens a
    rank (eligible), GQA unrepeated: out within 2e-5 and every gradient
    within 5e-4 of the reference's flash ring (interpret mode)."""
    want = _ref_flash(*CASES["flash"][hk], sp=-1)
    got = _gather([g[hk] for g in tw.scenario(four, "flash")])
    _assert_close(got, want, OUT_TOL, FLASH_GRAD_TOL)


def test_unaligned_chunks_take_the_plain_ring(four):
    """64 tokens a rank are not 128-aligned: the port routes to the plain
    ring on repeated kv heads, as the reference does, and matches its
    output within 2e-5 (and full attention's gradients)."""
    q, k, v = CASES["unaligned"]
    got = tw.scenario(four, "unaligned")
    assert not any(g["eligible"] for g in got)
    with set_mesh(_mesh(sp=-1)):
        out = jax.jit(lambda q, k, v: ring_flash_attention_sharded(
            q, k, v, causal=True, interpret=True))(q, k, v)
    gathered = _gather([g["got"] for g in got])
    np.testing.assert_allclose(gathered[0], np.asarray(out), atol=OUT_TOL,
                               rtol=OUT_TOL)
    want = _ref_grads(lambda q, k, v: reference_attention(
        q, jnp.repeat(k, 2, axis=2), jnp.repeat(v, 2, axis=2), causal=True),
        q, k, v)
    _assert_close(gathered, want, OUT_TOL, GRAD_TOL)
    assert not ring.flash_eligible(64) and ring.flash_eligible(128)
    assert not ring.flash_eligible(0) and not ring.flash_eligible(192)


@pytest.mark.parametrize("label", ["flash", "plain"])
def test_hop_census_counts_each_tensor_a_hop(four, label):
    """On four ranks each hop sends every tensor once, counted as one
    collective-permute under "sp" with its bytes: the forward hops k and v
    n − 1 times; the flash ring's backward hops k, v and the fp32 dK/dV
    n − 1 times and dK/dV once more, the plain ring's backward sends each
    forward hop's two gradients back once."""
    n = 4
    q, k, v = (CASES["flash"][2] if label == "flash" else CASES["plain"])
    kv_bytes = k[:, :k.shape[1] // n].nbytes  # fp32 inputs: fp32 hops
    fwd_ops, fwd_bytes = 2 * (n - 1), 2 * (n - 1) * kv_bytes
    if label == "flash":
        bwd_ops, bwd_bytes = 4 * (n - 1) + 2, (4 * (n - 1) + 2) * kv_bytes
    else:
        bwd_ops, bwd_bytes = 2 * (n - 1), 2 * (n - 1) * kv_bytes
    for g in tw.scenario(four, "census"):
        got = g[label]
        assert got["fwd"] == {"sp": {"ops": {"collective-permute": fwd_ops},
                                     "bytes": fwd_bytes}}
        assert got["step"] == {"sp": {"ops": {
            "collective-permute": fwd_ops + bwd_ops},
            "bytes": fwd_bytes + bwd_bytes}}


def test_gqa_on_tp2_sp2_matches_the_reference(four):
    """tp 2 × sp 2: each rank rings its tp block's heads (2 query and 1 kv
    head) over its sp line; the blocks put together match the reference's
    flash ring on a tp-2 × sp-2 mesh, out within 2e-5 and gradients within
    5e-4."""
    q, k, v = CASES["gqa"]
    want = _ref_flash(q, k, v, tp=2, sp=2)
    got = [np.zeros_like(x) for x in (q, q, k, v)]
    h, hk = q.shape[2] // 2, k.shape[2] // 2
    sc = q.shape[1] // 2
    for g in tw.scenario(four, "gqa_tp_sp"):
        t, s = g["tp"], g["sp"]
        for i, part in enumerate(g["got"]):
            w = h if i < 2 else hk
            got[i][:, s * sc:(s + 1) * sc, t * w:(t + 1) * w] = part
    _assert_close(got, want, OUT_TOL, FLASH_GRAD_TOL)


def test_sp_context_nests_and_needs_divisible_sequences():
    """``sp_context`` restores the previous context, whatever the body
    raised; ``local_chunk`` refuses a sequence the sp size does not
    divide; the rings refuse to run with no context, and the flash ring
    refuses heads that are not whole kv groups."""
    outer = ring.SPContext(2, 0, lambda ts, reverse=False: ts)
    inner = ring.SPContext(2, 1, lambda ts, reverse=False: ts)
    assert ring.current() is None
    with ring.sp_context(outer):
        with pytest.raises(KeyError):
            with ring.sp_context(inner):
                assert ring.current() is inner
                raise KeyError("body")
        assert ring.current() is outer
        x = torch.arange(12).reshape(2, 6)
        assert ring.local_chunk(x, inner).tolist() == [[3, 4, 5],
                                                       [9, 10, 11]]
        with pytest.raises(ValueError, match="does not split"):
            ring.local_chunk(torch.zeros(2, 5), outer)
    assert ring.current() is None
    q = torch.zeros(1, 128, 4, 16)
    with pytest.raises(RuntimeError, match="needs an sp context"):
        ring.ring_attention_sharded(q, q, q)
    with pytest.raises(ValueError, match="whole groups"):
        ring.ring_flash_attention_sharded(q, q[:, :, :3], q[:, :, :3],
                                          sp=outer)
