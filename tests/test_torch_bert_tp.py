"""BERT's Megatron tensor parallelism in the port, held against the JAX
package on the virtual CPU mesh (TINY, fp32: 2 layers, 4 heads, the same
init and MLM batches): the model at tp against the whole model, the
vocab-parallel masked cross entropy against the whole-tensor loss, three
steps of tp 2 and of dp2×fsdp2×tp2 against the step the reference jits
with BERT's partition specs, the refusal of a tp that does not divide the
heads or the vocabulary, and ``entry.bert_tp_world`` (chip_smoke's phase
(r)) at TINY against a world-1 control.

Two spawned gloo worlds run once each (tests/torch_world.py): two ranks
for tp 2 and eight for dp2×fsdp2×tp2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_world as tw
from edl_tpu.models import bert as jbert
from edl_tpu.models import transformer as jtfm
from edl_tpu.parallel import mesh as jmesh
from edl_tpu.parallel.compat import set_mesh
from edl_tpu_torch import entry, interop
from edl_tpu_torch.models import bert
from edl_tpu_torch.parallel import tensor_parallel as tpar
from edl_tpu_torch.parallel.mesh import MeshShape
from edl_tpu_torch.parallel.replan import tree_placements

WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

#: the roadmap's starting tolerances for TINY in fp32
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
#: phase (r) at TINY: (r)'s gate on the card is 2e-2 in bf16; in fp32 the
#: tp pair and the world-1 control differ only in the order of the sums
WORLD_LOSS_ATOL = 1e-5


def _batch(seed, b=4, s=32, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s), dtype=np.int32)
    targets = rng.integers(0, vocab, (b, s), dtype=np.int32)
    mask = (rng.random((b, s)) < 0.15).astype(np.float32)
    return tokens, targets, mask


JAX_PARAMS = jbert.init(jax.random.key(0), jbert.TINY)
TINY_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
BATCHES = [_batch(seed) for seed in (1, 2, 3)]
SPECS = bert.param_partition_specs(bert.TINY)
IS_SPEC = lambda x: isinstance(x, P)  # noqa: E731
#: phase (r) at TINY: two ranks from bert_tp_world's own seeds
WORLD_KW = dict(cfg=bert.TINY, batch=4, seq=32)


def _key(name: str) -> str:
    return "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _jax_spec_steps(shape: MeshShape):
    """The reference's MLM step jitted on params placed by BERT's specs
    (optax.adamw(1e-3)) over BATCHES: (eval loss at init, losses, params,
    the first step's gradients)."""
    m = jmesh.make_mesh(shape.size, jmesh.MeshSpec(**shape.axis_sizes()),
                        devices=jax.devices()[:shape.size])
    loss_fn = jbert.make_loss_fn(jbert.TINY)
    opt = optax.adamw(1e-3)
    shardings = jax.tree.map(lambda s: NamedSharding(m, s),
                             jbert.param_partition_specs(jbert.TINY),
                             is_leaf=IS_SPEC)
    params = jax.device_put(jax.tree.map(jnp.copy, JAX_PARAMS), shardings)
    batch_sh = NamedSharding(m, jtfm.batch_partition_spec())

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    with set_mesh(m):
        opt_state = jax.jit(opt.init)(params)
        fn = jax.jit(step)
        put = [tuple(jax.device_put(jnp.asarray(x), batch_sh) for x in b)
               for b in BATCHES]
        ev = float(jax.jit(loss_fn)(params, put[0]))
        losses, first = [], None
        for b in put:
            params, opt_state, loss, grads = fn(params, opt_state, b)
            losses.append(float(loss))
            first = grads if first is None else first
    return ev, losses, params, first


def _check_parity(got: list, shape: MeshShape):
    ev, want, params, grads = _jax_spec_steps(shape)
    flat = _flat(params)
    jgrad = np.asarray(_flat(grads)[_key(tw.GRAD_LEAF)])
    place = tree_placements({tw.GRAD_LEAF: jgrad}, shape, SPECS)
    k = shape.fsdp * shape.tp
    for rank, g in enumerate(got):
        assert g["eval"] == pytest.approx(ev, rel=LOSS_RTOL)
        np.testing.assert_allclose(g["losses"], want, rtol=LOSS_RTOL)
        assert g["losses"] == got[0]["losses"]
        assert len(flat) == len(g["full"])
        for name, p in g["full"].items():
            np.testing.assert_allclose(p, flat[_key(name)], atol=PARAM_ATOL,
                                       rtol=0, err_msg=name)
        block = place[tw.GRAD_LEAF].blocks[rank]
        np.testing.assert_allclose(
            g["grad"], jgrad[tuple(slice(lo, hi) for lo, hi in block)],
            rtol=1e-4, atol=1e-6, err_msg=f"rank {rank}")
        for name, spec in g["specs"].items():
            full = tuple(g["full"][name].shape)
            want_shape = tuple(d // (getattr(shape, e) if e else 1)
                               for d, e in zip(full, spec))
            assert g["shapes"][name] == want_shape, name
            assert set(g["opt_shapes"][name]) == {want_shape}, name
            if any(spec) and k > 1:
                assert np.prod(want_shape) * k == np.prod(full), name
        for name, v in g["norms"].items():
            assert np.array_equal(v, got[0]["norms"][name]), name


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.run("bert_tp_two", 2, tmp_path_factory.mktemp("btp2"),
                  WORLD_DEADLINE_S, bert_params=TINY_PARAMS, batches=BATCHES,
                  world_kw=WORLD_KW)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return tw.run("bert_tp_eight", 8, tmp_path_factory.mktemp("btp8"),
                  WORLD_DEADLINE_S, bert_params=TINY_PARAMS, batches=BATCHES)


# -- in one process -----------------------------------------------------------


@pytest.mark.parametrize("n_heads, vocab, what", [
    (3, 256, "heads"), (4, 255, "vocabulary"),
])
def test_tp_that_does_not_divide_is_refused(n_heads, vocab, what):
    cfg = dataclasses.replace(bert.TINY, n_heads=n_heads, d_model=48,
                              vocab_size=vocab)
    model = bert.Bert(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    ctx = tpar.TPContext(2, 0, lambda t, op: None)
    with tpar.tp_context(ctx), pytest.raises(ValueError, match=what):
        bert.apply(model, tokens)
    assert tpar.current() is None
    bert.apply(model, tokens)  # outside a tp context nothing is split


def test_unweighted_cross_entropy_is_bitwise_unchanged():
    """The transformer's call (no weights) computes exactly what it did
    before weights existed: mean(lse − tgt) with lse from the row maxima,
    and (softmax − onehot) / N backward."""
    ctx = tpar.TPContext(1, 0, lambda t, op: None)
    g = torch.Generator().manual_seed(0)
    logits = (3 * torch.randn(2, 6, 16, generator=g)).requires_grad_()
    targets = torch.randint(0, 16, (2, 6), generator=g)
    loss = tpar.vocab_parallel_cross_entropy(logits, targets, ctx)
    loss.backward(torch.tensor(1.0))
    x = logits.detach()
    top = x.amax(dim=-1)
    lse = torch.log((x - top[..., None]).exp_().sum(dim=-1)) + top
    want = (lse - x.gather(-1, targets[..., None])[..., 0]).mean()
    grad = (x - lse[..., None]).exp_()
    grad.scatter_add_(-1, targets[..., None], -torch.ones(2, 6, 1))
    grad.mul_(torch.tensor(1.0) / lse.numel())
    assert torch.equal(loss.detach(), want)
    assert torch.equal(logits.grad, grad)
    with pytest.raises(ValueError):
        tpar.vocab_parallel_cross_entropy(logits, targets, ctx,
                                          weights=torch.ones(2, 6))


# -- spawned worlds -----------------------------------------------------------


@pytest.mark.parametrize("which", ["mask", "zeros"])
def test_weighted_vocab_parallel_cross_entropy(two, which):
    """Σ mask · (lse − tgt) / max(Σ mask, 1) over the ranks' halves of the
    logits is the whole-tensor masked loss, and each rank's gradient its
    columns of the whole gradient; an all-zero mask gives 0 and a zero
    gradient."""
    got = tw.scenario(two, "weighted_ce")
    logits = torch.tensor(got[0]["logits"], requires_grad=True)
    targets = torch.tensor(got[0]["targets"])
    mask = torch.tensor(got[0][which][0])
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    want = ((lse - tgt) * mask).sum() / mask.sum().clamp_min(1.0)
    want.backward()
    if which == "zeros":
        assert want.item() == 0.0 and not logits.grad.any()
    for rank, g in enumerate(got):
        _, loss, grad = g[which]
        assert loss == pytest.approx(want.item(), rel=1e-6, abs=1e-7)
        np.testing.assert_allclose(
            grad, logits.grad.numpy()[..., rank * 8:(rank + 1) * 8],
            rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("one_hot", [False, True])
def test_tp2_blocks_equal_the_whole_model(two, one_hot):
    """Each tp-2 rank's blocks, with the collectives written out, give the
    whole model's hidden states and masked loss, and their gradients are
    the blocks of the whole model's (the vocab-parallel embedding's gather
    path and its one-hot path)."""
    cfg = dataclasses.replace(bert.TINY, one_hot_embed=one_hot)
    whole = interop.params_from_numpy(bert.Bert(cfg, device="cpu"),
                                      TINY_PARAMS)
    batch = tuple(torch.from_numpy(a) for a in BATCHES[0])
    want_h = bert.apply(whole, batch[0]).detach().numpy()
    want = bert.mlm_loss_fn(whole, batch)
    want.backward()
    grads = {n: p.grad.numpy() for n, p in whole.named_parameters()}
    place = tree_placements(grads, MeshShape(tp=2), SPECS)
    for rank, g in enumerate(tw.scenario(two, "blocks_vs_whole")):
        h, loss, got = g[one_hot]
        np.testing.assert_allclose(h, want_h, atol=1e-5, rtol=1e-5)
        assert loss == pytest.approx(want.item(), rel=1e-6)
        assert got.keys() == grads.keys()
        for name, gr in got.items():
            idx = tuple(slice(lo, hi) for lo, hi in place[name].blocks[rank])
            np.testing.assert_allclose(gr, grads[name][idx], atol=1e-6,
                                       rtol=1e-4, err_msg=name)


def test_tp2_trainer_matches_the_jitted_reference_step(two):
    got = tw.scenario(two, "parity_tp2")
    _check_parity(got, MeshShape(tp=2))
    census = got[0]["census"]
    assert set(census) == {"tp"}
    assert set(census["tp"]["ops"]) == {"all-reduce"}


def test_dp2_fsdp2_tp2_trainer_matches_the_jitted_reference_step(eight):
    """On a batch split four ways the masked loss's denominator is the
    global mask count, as the reference's is: one more all-reduce on the
    data group."""
    got = tw.scenario(eight, "parity_3d")
    _check_parity(got, MeshShape(dp=2, fsdp=2, tp=2))
    census = got[0]["census"]
    assert set(census) == {"dp", "dp+fsdp", "fsdp", "tp"}
    assert census["dp+fsdp"]["ops"] == {"all-reduce": 2}


def test_bert_tp_world_against_a_world1_control(two):
    """chip_smoke's phase (r) at TINY: two ranks at tp 2 from
    ``entry.bert_tp_world``, every split leaf and its Adam moments at half
    their bytes, the norms bitwise equal across the ranks after every
    step, and the losses those of a world-1 trainer on the same weights
    and batch."""
    got = tw.scenario(two, "bert_world")
    trainer, batch = entry.bert_trainer(
        batch=WORLD_KW["batch"], seq=WORLD_KW["seq"], device="cpu",
        cfg=WORLD_KW["cfg"])
    control = [trainer.step(batch) for _ in range(3)]
    for g in got:
        assert g["world"] == 2 and g["shares"] == [0.5]
        np.testing.assert_allclose(g["losses"], control,
                                   atol=WORLD_LOSS_ATOL, rtol=0)
    for a, b in zip(got[0]["norms"], got[1]["norms"]):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
