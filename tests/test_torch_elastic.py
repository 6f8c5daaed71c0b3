"""The port's ElasticTrainer and optimizers held against the JAX package's
ElasticTrainer and optax on TINY, on one CPU device with no process group
(the multi-rank worlds are tests/test_torch_elastic_world.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import transformer as jtfm
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import interop
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.parallel.mesh import MeshShape, MeshSpec
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer

CPU = [torch.device("cpu")]


def _batch(seed, b=4, s=32, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _port_trainer(seed=0, opt=None):
    params = jtfm.init(jax.random.key(seed), jtfm.TINY)
    model = interop.params_from_numpy(
        tfm.Transformer(tfm.TINY, device="cpu"),
        jax.tree.map(np.asarray, params))
    return ElasticTrainer(tfm.loss_fn, model, opt or optim.adamw(1e-3),
                          devices=CPU)


def test_three_steps_match_jax_trainer():
    params = jtfm.init(jax.random.key(0), jtfm.TINY)
    jt = JaxTrainer(jtfm.make_loss_fn(jtfm.TINY), params, optax.adamw(1e-3),
                    devices=jax.devices()[:1])
    pt = _port_trainer()
    assert pt.world_size == 1 and pt.shape == MeshShape()
    batch = _batch(1)
    for _ in range(3):
        np.testing.assert_allclose(pt.step(batch), jt.step(batch),
                                   rtol=1e-4)
    assert pt.state.step == 3
    np.testing.assert_allclose(pt.eval_loss(batch), jt.eval_loss(batch),
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(5)
    shapes = [(8, 4), (4,), (3, 2, 5)]
    params = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    jopt = getattr(optax, name)(1e-2)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = getattr(optim, name)(1e-2)(tparams)
    for _ in range(4):
        grads = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads],
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        topt.step()
    for p, want in zip(tparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=0)


def test_adamw_defaults_are_optax_defaults():
    opt = optim.adamw(3e-4)([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_step_accumulate_equals_one_step_on_the_concatenated_batch():
    a, b = _port_trainer(), _port_trainer()
    t1, y1 = _batch(2, b=2)
    t2, y2 = _batch(3, b=2)
    acc_loss = a.step_accumulate([(t1, y1), (t2, y2)])
    full_loss = b.step((np.concatenate([t1, t2]), np.concatenate([y1, y2])))
    np.testing.assert_allclose(acc_loss, full_loss, rtol=1e-6)
    assert a.state.step == b.state.step == 1
    for pa, pb in zip(a.state.params.parameters(),
                      b.state.params.parameters()):
        torch.testing.assert_close(pa, pb, atol=1e-6, rtol=0)


def test_resize_beyond_the_devices_rolls_back_and_training_goes_on():
    """With no process group the group is this one process: a resize past
    it (an fsdp layout too), or to a layout this trainer does not build,
    rolls back and training goes on on the world of one."""
    t = _port_trainer()
    batch = _batch(4)
    first = t.step(batch)
    failed_before = get_counters().get("resizes_failed")
    assert t.resize(1) and t.matches(1) and not t.matches(2)
    assert t.resize(2) is False
    assert t.resizes_failed == 1 and t.resizes == 0
    assert get_counters().get("resizes_failed") == failed_before + 1
    assert get_tracer().events()[-1].name == "resize_rolled_back"
    assert "process group" in get_tracer().events()[-1].args["error"]
    assert t.world_size == 1 and t.shape == MeshShape()
    assert t.resize(MeshShape(dp=1, fsdp=2)) is False
    assert t.resize(MeshShape(tp=2)) is False
    assert t.resizes_failed == 3
    second = t.step(batch)
    assert np.isfinite(second) and second < first
    assert t.state.step == 2 and t.resize_events == []


def test_more_devices_than_one_start_a_world_of_one():
    """With no process group a world is one device: handed two, the
    trainer trains on the first, a resize to two rolls back, and a first
    world of two is refused."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    t = ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                       devices=CPU * 2)
    assert t.world_size == 1 and t.device == CPU[0] and t.live
    assert t.mesh.ranks == () and t.mesh.group is None
    assert np.isfinite(t.step(_batch(5)))
    assert t.resize(2) is False and t.world_size == 1
    with pytest.raises(ValueError, match="process group"):
        ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                       devices=CPU * 2, initial_world_size=2)


def test_unsupported_modes_are_refused():
    """sp and ep layouts are refused, naming their later item, as are an
    unknown sharding kind and an fsdp world of two with no process group;
    a tp layout is taken, and like any world of two needs a process group;
    both of the reference's accumulation modes are taken, "dp" by
    default."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    for axis in ("sp", "ep"):
        with pytest.raises(ValueError, match=f"the {axis} axes are later "
                           "items.*item 9"):
            ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                           devices=CPU, spec=MeshSpec(**{axis: 1}),
                           initial_world_size=MeshShape(**{axis: 2}))
    with pytest.raises(ValueError, match="process group"):
        ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3), devices=CPU,
                       spec=MeshSpec(tp=1),
                       initial_world_size=MeshShape(tp=2))
    with pytest.raises(ValueError, match="param_sharding 'zero2'"):
        ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3), devices=CPU,
                       param_sharding="zero2")
    with pytest.raises(ValueError, match="process group"):
        ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3), devices=CPU,
                       param_sharding="fsdp", spec=MeshSpec(dp=1, fsdp=-1),
                       initial_world_size=2)
    fsdp1 = ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3), devices=CPU,
                           param_sharding="fsdp",
                           spec=MeshSpec(dp=1, fsdp=-1))
    assert fsdp1.shape == MeshShape() and fsdp1.sharded
    assert set(fsdp1.sharded_dims().values()) == {None}
    with pytest.raises(ValueError, match="accum_mode"):
        ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3), devices=CPU,
                       accum_mode="rounds")
    assert ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                          devices=CPU).accum_mode == "dp"
    assert ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3), devices=CPU,
                          accum_mode="replicated").accum_mode == "replicated"
