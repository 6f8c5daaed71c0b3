"""The port's Megatron tensor parallelism in the SPMD ElasticTrainer, laid
out by the transformer's partition specs, held against the JAX package on
the virtual CPU mesh (TINY, fp32, the same init and batches): placements
and planned bytes against the reference's ``plan_reshard`` over
``NamedSharding``s, the tp collectives against their whole-tensor
versions, three steps of tp 2 and of dp2×fsdp2×tp2 against the step the
reference jits with the specs (``tests/test_models_ops.py``), the
``"fsdp"`` and ``"replicated"`` kinds on tp meshes against JAX's trainer,
accumulation, live resizes between spec layouts, and the durable loop's
refusal.

Two spawned gloo worlds run, once each (tests/torch_world.py): two ranks
joined through ``entry.flagship_tp_world`` (chip_smoke's phase (m) at
TINY) running every tp 2 scenario, and eight ranks running the rest."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_world as tw
from edl_tpu.models import transformer as jtfm
from edl_tpu.parallel import mesh as jmesh
from edl_tpu.parallel import replan as jreplan
from edl_tpu.parallel.compat import set_mesh
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import entry
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.ops.embedding import embed_lookup
from edl_tpu_torch.parallel import mesh
from edl_tpu_torch.parallel import tensor_parallel as tpar
from edl_tpu_torch.parallel.mesh import MeshShape
from edl_tpu_torch.parallel.replan import (Placement, plan_reshard,
                                          tree_placements)
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.virtual import VirtualConfig, VirtualWorkerLoop
from edl_tpu_torch.runtime.sdc import SdcPlane

#: each world's children are joined within WORLD_DEADLINE_S and killed after
#: it; a test's own ceiling (tests/conftest.py) sits above that
WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

#: the roadmap's starting tolerances for TINY in fp32
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
BYTES = ("bytes_moved", "bytes_ici", "bytes_dcn", "bytes_naive")
PLAN_FIELDS = ("bytes_total", "bytes_stay", "bytes_ici", "bytes_dcn",
               "bytes_moved", "bytes_naive", "max_device_bytes")


def _batch(seed, b=4, s=32, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


JAX_PARAMS = jtfm.init(jax.random.key(0), jtfm.TINY)
TINY_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
BATCHES = [_batch(seed) for seed in (1, 2, 3)]
MICRO = [_batch(seed, b=2) for seed in (10, 11, 12, 13)]
SPECS = tfm.param_partition_specs(tfm.TINY)
IS_SPEC = lambda x: isinstance(x, P)  # noqa: E731


def _key(name: str) -> str:
    """A dotted port name as the reference's keystr."""
    return "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _assert_params_close(port: dict, jax_params, atol=PARAM_ATOL):
    flat = _flat(jax_params)
    assert len(flat) == len(port)
    for name, got in port.items():
        np.testing.assert_allclose(got, flat[_key(name)], atol=atol, rtol=0,
                                   err_msg=name)


def _jmesh(shape: MeshShape):
    return jmesh.make_mesh(shape.size,
                           jmesh.MeshSpec(**shape.axis_sizes()),
                           devices=jax.devices()[:shape.size])


def _param_shardings(m):
    return jax.tree.map(lambda s: NamedSharding(m, s),
                        jtfm.param_partition_specs(jtfm.TINY),
                        is_leaf=IS_SPEC)


def _jax_spec_steps(shape: MeshShape):
    """The reference's train step jitted on params placed by the specs
    (tests/test_models_ops.py's layout, optax.adamw(1e-3)) over BATCHES:
    (eval loss at init, losses, params, the first step's gradients)."""
    m = _jmesh(shape)
    loss_fn = jtfm.make_loss_fn(jtfm.TINY)
    opt = optax.adamw(1e-3)
    params = jax.device_put(_jax_params(), _param_shardings(m))
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


def _jax_params():
    """A fresh copy of the JAX init: a trainer's step may donate its
    arrays."""
    return jax.tree.map(jnp.copy, JAX_PARAMS)


def _jax_single(**kw):
    return JaxTrainer(jtfm.make_loss_fn(jtfm.TINY), _jax_params(),
                      optax.adamw(1e-3), devices=jax.devices()[:1], **kw)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.run("tp_two", 2, tmp_path_factory.mktemp("tp2"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  micro=MICRO,
                  flagship_kw=dict(cfg=tfm.TINY, batch=4, seq=32,
                                   initial_world_size=1))


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return tw.run("tp_eight", 8, tmp_path_factory.mktemp("tp8"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  micro=MICRO)


# -- (a) placements and planned bytes -----------------------------------------


@pytest.mark.parametrize("old, new", [
    (MeshShape(), MeshShape(tp=2)),
    (MeshShape(tp=2), MeshShape(dp=2, tp=2)),
    (MeshShape(dp=2, fsdp=2, tp=2), MeshShape(fsdp=4)),
], ids=lambda v: v.describe())
def test_spec_placements_and_plan_equal_the_reference(old, new):
    """Each rank's block of every leaf is the block NamedSharding gives its
    device, and plan_reshard prices the move byte for byte as the
    reference's does over the NamedShardings of the same specs."""
    tree = {name: p for name, p in
            tfm.Transformer(tfm.TINY, device="cpu").named_parameters()}
    for shape in (old, new):
        got = tree_placements(tree, shape, SPECS)
        sh = _param_shardings(_jmesh(shape))
        flat = {jax.tree_util.keystr(path): s for path, s in
                jax.tree_util.tree_leaves_with_path(sh, is_leaf=lambda x:
                                                    isinstance(
                                                        x, NamedSharding))}
        for name, p in tree.items():
            want = {d.id: jreplan._norm_block(idx, tuple(p.shape))
                    for d, idx in flat[_key(name)].devices_indices_map(
                        tuple(p.shape)).items()}
            assert dict(got[name].blocks) == want, (shape, name)
    want = jreplan.plan_reshard(TINY_PARAMS, _param_shardings(_jmesh(old)),
                                _param_shardings(_jmesh(new)))
    plan = plan_reshard(tree, tree_placements(tree, old, SPECS),
                        tree_placements(tree, new, SPECS), old, new)
    for f in PLAN_FIELDS:
        assert getattr(plan, f) == getattr(want, f), f
    assert plan.per_device_bytes == want.per_device_bytes


def test_of_spec_generalises_the_fsdp_placement():
    """``sharded`` is ``of_spec`` with fsdp at its dimension; a tuple entry
    splits the first axis major; a spec that does not divide, names an
    axis twice or names an unknown one is refused."""
    shape = MeshShape(dp=2, fsdp=2, tp=2)
    assert Placement.sharded((8, 4), 1, shape) == Placement.of_spec(
        (8, 4), (None, "fsdp"), shape)
    assert Placement.of_spec((8, 4), None, shape) == Placement.replicated(
        (8, 4), 8)
    two_axes = Placement.of_spec((8,), (("dp", "tp"),), shape)
    # rank 5 is dp 1, fsdp 0, tp 1: block 1·2 + 1 of 4
    assert two_axes.blocks[5] == ((6, 8),)
    m = _jmesh(shape)
    idx = NamedSharding(m, P(("dp", "tp"))).devices_indices_map((8,))
    assert {d.id: jreplan._norm_block(i, (8,)) for d, i in idx.items()} == \
        dict(two_axes.blocks)
    for bad in (("tp", "tp"), ("xx",), (("fsdp", "dp"), None, None)):
        with pytest.raises(ValueError):
            Placement.of_spec((6, 4), bad, shape)


def test_data_coordinate_and_groups_follow_the_reference_layout():
    """dp2×fsdp2×tp2 over ranks 0-7 as the reference lays out devices:
    the tp lines are pairs of neighbours, and the data coordinate (the
    batch's split) is the device's index over dp×fsdp."""
    shape = MeshShape(dp=2, fsdp=2, tp=2)
    ids = np.vectorize(lambda d: d.id)(_jmesh(shape).devices)[..., 0, 0]
    for dp in range(2):
        for f in range(2):
            for t in range(2):
                r = int(ids[dp, f, t])
                assert mesh.data_coordinate(shape, r) == dp * 2 + f
                assert mesh.axis_ranks(shape, "tp", r) == tuple(ids[dp, f])
                assert mesh.axis_ranks(shape, "fsdp", r) == tuple(
                    ids[dp, :, t])
    assert mesh.tree_shardings(shape, {"w": torch.empty(4, 2)},
                               {"w": ("tp",)}) == {"w": ("tp", None)}
    with pytest.raises(ValueError, match="no partition spec"):
        mesh.tree_shardings(shape, {"w": torch.empty(4)}, {})


# -- (b) the tp collectives ---------------------------------------------------


def test_copy_and_reduce_are_the_megatron_pair(two):
    """copy_to_tp: the input forward, the gradients summed backward;
    reduce_from_tp: the sum forward, the gradient passed through."""
    for rank, g in enumerate(tw.scenario(two, "primitives")):
        y, dx = g["copy"]
        assert np.array_equal(y, g["x"])
        np.testing.assert_allclose(dx, g["w"][0] + g["w"][1], rtol=1e-6)
        z, dp = g["reduce"]
        np.testing.assert_allclose(z, g["parts"].sum(0), rtol=1e-6)
        assert np.array_equal(dp, g["w"][0])


@pytest.mark.parametrize("one_hot", [False, True])
def test_vocab_parallel_lookup_is_exact(two, one_hot):
    """The sum of the ranks' lookups in their halves of the table is
    embed_lookup of the whole table, bitwise, and each rank's table
    gradient is its rows of the whole table's."""
    got = tw.scenario(two, "primitives")
    g0 = got[0]
    table = torch.tensor(g0["table"], requires_grad=True)
    want = embed_lookup(table, torch.tensor(g0["tokens"]), one_hot=one_hot,
                        dtype=torch.float32)
    (want * torch.tensor(g0["dy"])).sum().backward()
    for rank, g in enumerate(got):
        e, dt = g[f"embed_{one_hot}"]
        assert np.array_equal(e, want.detach().numpy())
        np.testing.assert_allclose(
            dt, table.grad.numpy()[rank * 8:(rank + 1) * 8], rtol=1e-6,
            atol=1e-7)


def test_vocab_parallel_cross_entropy_value_and_gradient(two):
    """The loss over the ranks' halves of the logits is the whole-vocab
    mean of logsumexp − target logit, and each rank's gradient is its
    columns of the whole gradient."""
    got = tw.scenario(two, "primitives")
    logits = torch.tensor(got[0]["logits"], requires_grad=True)
    targets = torch.tensor(got[0]["targets"])
    lse = torch.logsumexp(logits, dim=-1)
    want = (lse - logits.gather(-1, targets[..., None])[..., 0]).mean()
    want.backward()
    for rank, g in enumerate(got):
        loss, grad = g["ce"]
        assert loss == pytest.approx(want.item(), rel=1e-6)
        np.testing.assert_allclose(
            grad, logits.grad.numpy()[..., rank * 8:(rank + 1) * 8],
            rtol=1e-5, atol=1e-8)


# -- (c) the spec-placed trainer against the jitted reference step -----------


def _check_parity(got: list, shape: MeshShape):
    ev, want, params, grads = _jax_spec_steps(shape)
    jgrad = np.asarray(_flat(grads)[_key(tw.GRAD_LEAF)])
    place = tree_placements({tw.GRAD_LEAF: jgrad}, shape, SPECS)
    for rank, g in enumerate(got):
        assert g["eval"] == pytest.approx(ev, rel=LOSS_RTOL)
        np.testing.assert_allclose(g["losses"], want, rtol=LOSS_RTOL)
        assert g["losses"] == got[0]["losses"]
        _assert_params_close(g["full"], params)
        block = place[tw.GRAD_LEAF].blocks[rank]
        np.testing.assert_allclose(
            g["grad"], jgrad[tuple(slice(lo, hi) for lo, hi in block)],
            rtol=1e-4, atol=1e-6, err_msg=f"rank {rank}")
        k = shape.fsdp * shape.tp
        for name, spec in g["specs"].items():
            full = tuple(g["full"][name].shape)
            want_shape = tuple(
                d // (getattr(shape, e) if e else 1)
                for d, e in zip(full, spec))
            assert g["shapes"][name] == want_shape, name
            # Adam's moments at the parameter's block
            assert set(g["opt_shapes"][name]) == {want_shape}, name
            if any(spec) and k > 1:
                assert np.prod(want_shape) * k == np.prod(full), name
        for name, v in g["norms"].items():
            assert np.array_equal(v, got[0]["norms"][name]), name


def test_tp2_trainer_matches_the_jitted_reference_step(two):
    got = tw.scenario(two, "parity_tp2")
    _check_parity(got, MeshShape(tp=2))
    # one tp2 step: tp all-reduces only, 13 at TINY's 2 layers: forward
    # the embedding's, 2 a layer and the loss's 3; backward 2 a layer and
    # lm_head's input
    census = got[0]["census"]
    assert census == {"tp": {"ops": {"all-reduce": 13},
                             "bytes": census["tp"]["bytes"]}}


def test_dp2_fsdp2_tp2_trainer_matches_the_jitted_reference_step(eight):
    got = tw.scenario(eight, "parity_3d")
    _check_parity(got, MeshShape(dp=2, fsdp=2, tp=2))
    census = got[0]["census"]
    assert set(census) == {"dp", "dp+fsdp", "fsdp", "tp"}
    assert census["fsdp"]["ops"] == {"all-gather": 1, "reduce-scatter": 1}
    assert census["dp"]["ops"] == {"all-reduce": 1}
    # the norms' gradients and the loss over the data group, once
    assert census["dp+fsdp"]["ops"] == {"all-reduce": 1}
    assert census["tp"]["ops"] == {"all-reduce": 13}


# -- (d) the reference's kinds on tp meshes -----------------------------------


@pytest.mark.parametrize("label, spec, kind", [
    ("dp2xtp2 fsdp", jmesh.MeshSpec(dp=2, tp=2), "fsdp"),
    ("dp2xtp2 replicated", jmesh.MeshSpec(dp=2, tp=2), "replicated"),
    ("fsdp2xtp2 fsdp sgd", jmesh.MeshSpec(fsdp=2, tp=2), "fsdp"),
])
def test_fsdp_and_replicated_kinds_replicate_over_tp(eight, label, spec,
                                                      kind):
    """JAX's trainer on a tp mesh replicates every leaf over tp; so does
    the port's, with the same losses and params, the ranks of a tp pair
    holding the same bytes and summing nothing over tp.  The fsdp2×tp2
    case steps plain SGD: an element of layers.1.w1 has a gradient of
    ~8e-9, under Adam's eps, where Adam turns the last bits of the sum's
    order into ~1e-4 of update (JAX's own fsdp2×tp2 and one-device
    trainers differ by 9e-5 there)."""
    got = [g[label] for g in tw.scenario(eight, "kinds")]
    opt = (optax.sgd(tw.SGD_LR) if label.endswith("sgd")
           else optax.adamw(1e-3))
    jt = JaxTrainer(jtfm.make_loss_fn(jtfm.TINY), _jax_params(), opt,
                    spec=spec, param_sharding=kind,
                    devices=jax.devices()[:4], initial_world_size=4)
    want = [jt.step(b) for b in BATCHES]
    jspecs = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
              jax.tree_util.tree_leaves_with_path(
                  jax.tree.map(lambda x: x.sharding, jt.state.params))}
    for rank, g in enumerate(got):
        if rank >= 4:
            assert not g["live"] and g["losses"] == [None] * 3
            continue
        np.testing.assert_allclose(g["losses"], want, rtol=LOSS_RTOL)
        _assert_params_close(g["full"], jt.state.params)
        for name, spec_ in g["specs"].items():
            assert "tp" not in spec_
            assert tuple(e for e in spec_) == (
                jspecs[_key(name)] + (None,) * (len(spec_)
                                                - len(jspecs[_key(name)])))
        assert g["digest"] == got[rank ^ 1]["digest"]
        assert "tp" not in g["census"]


# -- (e) accumulation ---------------------------------------------------------


def _check_accumulate(got: list):
    jt = _jax_single(accum_mode="dp")
    want = [jt.step_accumulate(MICRO) for _ in range(2)]
    for g in got:
        for mode in ("dp", "replicated"):
            np.testing.assert_allclose(g[mode]["losses"], want,
                                       rtol=LOSS_RTOL, err_msg=mode)
            _assert_params_close(g[mode]["full"], jt.state.params)


def test_tp2_step_accumulate_matches_jax_in_both_modes(two):
    _check_accumulate(tw.scenario(two, "accumulate"))


def test_dp2_fsdp2_tp2_step_accumulate_matches_jax_in_both_modes(eight):
    _check_accumulate(tw.scenario(eight, "accum_3d"))


def test_aborted_accumulation_closes_the_tp_context(two):
    """A kill mid-accumulation raises on both ranks at the same micro-batch,
    leaves the state and the tp context as they were, and the next step
    is the reference's first."""
    jt = _jax_single()
    want = jt.step(BATCHES[0])
    for g in tw.scenario(two, "accumulate"):
        a = g["abort"]
        assert a["aborted"] and a["untouched"] and a["closed"]
        assert a["loss"] == pytest.approx(want, rel=LOSS_RTOL)


# -- resizes between spec layouts ---------------------------------------------


def _ref_state_plan(old: MeshShape, new: MeshShape):
    """The reference's plan for the trainer's state laid out by the specs:
    the params, Adam's two moments at their layout and its count
    replicated."""
    def shardings(shape):
        m = _jmesh(shape)
        sh = _param_shardings(m)
        return {"params": sh, "mu": sh, "nu": sh,
                "count": NamedSharding(m, P())}

    tree = {"params": TINY_PARAMS, "mu": TINY_PARAMS, "nu": TINY_PARAMS,
            "count": jnp.zeros((), jnp.int32)}
    return jreplan.plan_reshard(tree, shardings(old), shardings(new))


def test_resizes_between_spec_layouts_keep_params_and_price_as_the_reference(
        eight):
    """tp2 → dp2×fsdp2×tp2 → fsdp4: the whole params bitwise kept through
    each move, each move's bytes the reference plan's for the same state,
    and the losses those of one device."""
    got = tw.scenario(eight, "resize_3d")
    jt = _jax_single()
    want = [jt.step(b) for b in BATCHES]
    r0 = got[0]
    assert r0["kept"] == [True, True]
    assert r0["shapes"] == [MeshShape(dp=2, fsdp=2, tp=2), MeshShape(fsdp=4)]
    np.testing.assert_allclose(r0["losses"], want, rtol=LOSS_RTOL)
    shapes = [MeshShape(tp=2), *r0["shapes"]]
    for evt, old, new in zip(r0["events"], shapes, shapes[1:]):
        ref = _ref_state_plan(old, new)
        assert {k: evt[k] for k in BYTES} == {k: getattr(ref, k)
                                               for k in BYTES}, evt["shape"]
    assert [g["losses"][-1] for g in got if g["losses"][-1] is not None] \
        == [r0["losses"][-1]] * 4


# -- the entry point behind phase (m) -----------------------------------------


def test_flagship_tp_world_joins_and_resizes_on_the_cpu(two):
    """flagship_tp_world at TINY on the CPU through phase (m)'s worlds 1,
    1, 2, 2, 1, 1: half of every tp-split leaf and of its moments on each
    rank of 2, the norms bitwise equal across the ranks after each world-2
    step, the whole params kept through each resize, the grow's broadcast
    bytes the plan's less Adam's count, tp all-reduces alone in a world-2
    step, and the losses a one-rank control's."""
    r0, r1 = tw.scenario(two, "flagship_world")
    assert (r0["world"], r0["live"], r1["live"]) == (1, True, False)
    assert r0["resized"] == r1["resized"] == [True, True]
    assert r0["kept"] == [True, True]
    assert r0["shares"] == r1["shares"] == [0.5]
    assert len(r0["norms"]) == 2
    for a, b in zip(r0["norms"], r1["norms"]):
        assert set(a) == {n for n, s in SPECS.items() if set(s) <= {None}}
        assert all(np.array_equal(a[n], b[n]) for n in a)
    grow = r0["events"][0]
    assert grow["shape"] == "tp2"
    assert 0 <= grow["bytes_moved"] - r0["sent"][0] <= 4
    assert set(r0["census"]) == {"tp"}
    assert set(r0["census"]["tp"]["ops"]) == {"all-reduce"}
    assert r1["losses"][2:4] == r0["losses"][2:4]
    assert r1["losses"][:2] == [None, None] == r1["losses"][4:]
    trainer, batch = entry.flagship_trainer(4, 32, device="cpu",
                                            cfg=tfm.TINY)
    control = [trainer.step(batch) for _ in range(6)]
    np.testing.assert_allclose(r0["losses"], control, rtol=LOSS_RTOL)


# -- the model's side, in one process -----------------------------------------


def test_model_in_a_tp_context_of_one_is_the_model():
    """In a context of one rank the tp path (copies, reduces, the
    vocab-parallel lookup and loss) computes what the plain path does,
    gradients included."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    batch = tuple(torch.as_tensor(x).long() for x in BATCHES[0])
    plain = tfm.loss_fn(model, batch)
    plain.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    ctx = tpar.TPContext(1, 0, lambda t, op: None)
    with tpar.tp_context(ctx):
        assert tpar.current() is ctx
        loss = tfm.loss_fn(model, batch)
        loss.backward()
    assert tpar.current() is None
    assert loss.item() == pytest.approx(plain.item(), rel=1e-6)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=1e-5, atol=1e-6)


def test_tp_must_divide_the_kv_heads():
    """Contiguous column blocks keep GQA's grouping only when tp divides
    the kv heads: TINY's 2 take tp 2, not 4."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="does not divide the model's 2 kv"):
        with tpar.tp_context(tpar.TPContext(4, 0, lambda t, op: None)):
            tfm.apply(model, tokens)
    assert tpar.current() is None


def test_spec_trainer_refuses_axes_it_cannot_split():
    model = tfm.Transformer(tfm.TINY, device="cpu")
    specs = dict(SPECS, embed=(("tp", "fsdp"), None))
    with pytest.raises(ValueError, match="fsdp or tp alone"):
        ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                       devices=[torch.device("cpu")], param_sharding=specs)


# -- (f) the durable loop -----------------------------------------------------


def test_durable_loop_refuses_a_spec_placed_trainer():
    """A trainer placed by partition specs holds blocks, as an fsdp one
    does; the loop takes it (its whole state is gathered to rank 0 for a
    save and restored into any layout) and an SDC plane on it; what it
    refuses is an ``sdc=`` that is no plane."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    t = ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                       devices=[torch.device("cpu")], param_sharding=SPECS,
                       spec=mesh.MeshSpec(tp=-1))
    assert t.sharded and t.param_sharding_kind == "specs"
    cfg = VirtualConfig(vw_count=2, global_batch=4)
    assert VirtualWorkerLoop(t, cfg, batches=None).trainer is t
    with pytest.raises(TypeError, match="SdcPlane"):
        VirtualWorkerLoop(t, cfg, batches=None, sdc=object())
    plane = SdcPlane()
    assert VirtualWorkerLoop(t, cfg, batches=None, sdc=plane).sdc is plane
