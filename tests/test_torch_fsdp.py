"""The port's fsdp parameter sharding (ZeRO-3 style) in the SPMD
ElasticTrainer, held against the JAX package's fsdp trainer on the virtual
CPU mesh (TINY, fp32, the same init and batches): the reference's layout
rule and partition specs, fsdp 4 and dp2×fsdp2 steps, the live re-splits
and size changes of tests/test_replan.py with their planned bytes, a
rollback on any rank, replicated accumulation bitwise across layouts, and
``entry.dryrun_multichip(2)`` and ``(4)`` against ``__graft_entry__``'s.

Two spawned gloo worlds run, once each (tests/torch_world.py): two ranks
joined through ``entry.flagship_elastic_world`` (chip_smoke's phase (l) at
TINY), and four ranks running every other scenario in sequence."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
import torch_world as tw
from edl_tpu.models import bert as jbert
from edl_tpu.models import mlp as jmlp
from edl_tpu.models import transformer as jtfm
from edl_tpu.parallel import mesh as jmesh
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import entry
from edl_tpu_torch.models import bert, transformer as tfm
from edl_tpu_torch.parallel import mesh
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
ROOT = Path(__file__).resolve().parent.parent
BYTES = ("bytes_moved", "bytes_ici", "bytes_dcn", "bytes_naive")


def _batch(seed, b=4, s=32, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


JAX_PARAMS = jtfm.init(jax.random.key(0), jtfm.TINY)
TINY_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
BATCHES = [_batch(seed) for seed in (1, 2, 3)]
MICRO = [_batch(seed, b=2) for seed in (10, 11, 12, 13)]


def _jax_fsdp(n0, devices, spec=jmesh.MeshSpec(dp=1, fsdp=-1), opt=None,
              **kw):
    return JaxTrainer(jtfm.make_loss_fn(jtfm.TINY), JAX_PARAMS,
                      opt or optax.adamw(1e-3), spec=spec,
                      param_sharding="fsdp",
                      devices=jax.devices()[:devices],
                      initial_world_size=n0, **kw)


def _jax_mlp_fsdp():
    """tests/test_replan.py's make_trainer(n0=4, kind="fsdp")."""
    return JaxTrainer(jmlp.loss_fn, jmlp.init(jax.random.key(0), [16, 32, 4]),
                      optax.adam(1e-2), spec=jmesh.MeshSpec(dp=-1),
                      param_sharding="fsdp", devices=jax.devices()[:4],
                      initial_world_size=4)


def _assert_params_close(port: dict, jax_params, atol=PARAM_ATOL):
    flat = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_params)}
    assert len(flat) == len(port)
    for name, got in port.items():
        key = "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                      for p in name.split("."))
        np.testing.assert_allclose(got, flat[key], atol=atol, rtol=0,
                                   err_msg=name)


def _spec_dims(spec, ndim) -> tuple:
    """A jax PartitionSpec as the port writes it: one entry a dimension."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.run("fsdp_four", 4, tmp_path_factory.mktemp("fsdp4"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  micro=MICRO)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.run("fsdp_two", 2, tmp_path_factory.mktemp("fsdp2"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  flagship_kw=dict(cfg=tw.tfm.TINY, batch=4, seq=32,
                                   initial_world_size=1))


# -- the layout rule and the partition specs ----------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_sharding_picks_divisible_dim(n):
    """The rule of test_runtime.py's test, leaf by leaf against the
    reference's fsdp_sharding on the same shapes."""
    shapes = {"w": (16, 10), "b": (3,), "s": (), "t": (6, 4), "u": (4, 6),
              "v": (12, 8, 16)}
    jm = jmesh.make_mesh(n, jmesh.MeshSpec(dp=1, fsdp=-1),
                         devices=jax.devices()[:n])
    want = jmesh.tree_shardings(
        jm, {k: jax.ShapeDtypeStruct(s, np.float32)
             for k, s in shapes.items()}, "fsdp")
    got = mesh.tree_shardings(
        mesh.MeshShape(fsdp=n),
        {k: torch.empty(s, device="meta") for k, s in shapes.items()},
        "fsdp")
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    for k, s in shapes.items():
        assert got[k] == _spec_dims(want[k].spec, len(s)), k
        assert got[k] == mesh.fsdp_sharding(mesh.MeshShape(fsdp=n),
                                            meta[k]), k
    assert got["w"] == ("fsdp", None) and got["b"] == (None,)
    assert got["s"] == ()
    assert mesh.tree_shardings(mesh.MeshShape(fsdp=n), meta,
                               "replicated") == {
        k: (None,) * len(s) for k, s in shapes.items()}
    with pytest.raises(ValueError, match="unknown sharding kind"):
        mesh.tree_shardings(mesh.MeshShape(fsdp=n), shapes, "tp")


def test_axis_groups_are_the_reference_row_major_lines():
    """dp2×fsdp2 over ranks 0-3: fsdp lines {0,1} {2,3}, dp lines {0,2}
    {1,3}, the reference's device layout (rank r for device r)."""
    shape = mesh.MeshShape(dp=2, fsdp=2)
    jm = jmesh.make_mesh(4, jmesh.MeshSpec(dp=2, fsdp=2),
                         devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices).reshape(2, 2)
    for i in range(2):
        for j in range(2):
            r = int(ids[i, j])
            assert mesh.axis_ranks(shape, "fsdp", r) == tuple(ids[i, :])
            assert mesh.axis_ranks(shape, "dp", r) == tuple(ids[:, j])
    assert mesh.axis_ranks(shape, "fsdp", 3) == (2, 3)
    assert mesh.axis_ranks(shape, "dp", 1) == (1, 3)


@pytest.mark.parametrize("model", ["transformer", "bert"])
def test_param_partition_specs_match_the_reference(model):
    if model == "transformer":
        cfg, port = jtfm.TINY, tfm.Transformer(tfm.TINY, device="cpu")
        want, got = (jtfm.param_partition_specs(cfg),
                     tfm.param_partition_specs(tfm.TINY))
        assert tfm.batch_partition_spec() == tuple(
            jtfm.batch_partition_spec())
    else:
        cfg, port = jbert.TINY, bert.Bert(bert.TINY, device="cpu")
        want, got = (jbert.param_partition_specs(cfg),
                     bert.param_partition_specs(bert.TINY))
    shapes = dict(port.named_parameters())
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    flat = jax.tree_util.tree_leaves_with_path(want, is_leaf=is_spec)
    assert len(flat) == len(got) == len(shapes)
    for path, spec in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        assert got[name] == _spec_dims(spec, shapes[name].dim()), name


# -- the sharded trainer on four ranks ----------------------------------------


@pytest.mark.parametrize("layout", ["fsdp4", "dp2xfsdp2"])
def test_fsdp_trainer_matches_jax_and_replicated(four, layout):
    """The port's fsdp 4 (and dp2×fsdp2) against the JAX fsdp trainer on 4
    virtual CPU devices and against the port's replicated world of 4; each
    rank holds exactly 1/k of every leaf the rule shards, params and Adam's
    moments alike; one step's collectives by axis."""
    got = [g[layout] for g in tw.scenario(four, "matches")]
    spec = (jmesh.MeshSpec(dp=1, fsdp=-1) if layout == "fsdp4"
            else jmesh.MeshSpec(dp=2, fsdp=-1))
    jt = _jax_fsdp(4, 4, spec=spec)
    want = [jt.step(b) for b in BATCHES]
    np.testing.assert_allclose(got[0]["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(got[0]["full"], jt.state.params)
    rep = tw.scenario(four, "matches")[0]["replicated"]
    np.testing.assert_allclose(got[0]["losses"], rep["losses"],
                               rtol=LOSS_RTOL)
    for n, p in rep["full"].items():
        np.testing.assert_allclose(got[0]["full"][n], p, atol=PARAM_ATOL,
                                   rtol=0, err_msg=n)
    k = 4 if layout == "fsdp4" else 2
    jdims = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_leaves_with_path(
                 jmesh.tree_shardings(jt.mesh, jt.state.params, "fsdp"))}
    for g in got:
        assert g["losses"] == got[0]["losses"]
        b = g["blocks"]
        assert b["fsdp"] == k
        for name, shard in b["params"].items():
            full = int(np.prod(b["shapes"][name]))
            d = b["dims"][name]
            key = "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                          for p in name.split("."))
            assert _spec_dims(jdims[key].spec, len(b["shapes"][name])) == \
                tuple("fsdp" if i == d else None
                      for i in range(len(b["shapes"][name])))
            share = 1 / k if d is not None else 1
            assert shard.size == full * share, name
            assert {m.size for m in b["opt"][name].values()} == {shard.size}
    census = got[0]["census"]
    if layout == "fsdp4":
        # the loss's sum over the live group is an fsdp op too
        assert census == {"fsdp": {
            "ops": {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 1},
            "bytes": census["fsdp"]["bytes"]}}
    else:
        assert census["fsdp"]["ops"] == {"all-gather": 1,
                                         "reduce-scatter": 1}
        assert census["dp"]["ops"] == {"all-reduce": 1}
        assert census["dp+fsdp"]["ops"] == {"all-reduce": 1}


@pytest.mark.parametrize("layout", ["fsdp4", "dp2xfsdp2"])
def test_fsdp_sgd_update_matches_jax(four, layout):
    """Plain SGD against the JAX fsdp trainer under optax.sgd at the same
    step size: SGD's update is the gradient scaled, so each shard's reduced
    gradient (the fsdp reduce-scatter, the dp all-reduce and the 1/N) is
    held to the reference's after the first step and after the third,
    which Adam's scale-free update cannot show."""
    got = [g[f"{layout}_sgd"] for g in tw.scenario(four, "matches")]
    spec = (jmesh.MeshSpec(dp=1, fsdp=-1) if layout == "fsdp4"
            else jmesh.MeshSpec(dp=2, fsdp=-1))
    jt = _jax_fsdp(4, 4, spec=spec, opt=optax.sgd(tw.SGD_LR))
    want = [jt.step(BATCHES[0])]
    _assert_params_close(got[0]["first"], jt.state.params)
    want += [jt.step(b) for b in BATCHES[1:]]
    np.testing.assert_allclose(got[0]["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(got[0]["full"], jt.state.params)
    for g in got:
        assert g["losses"] == got[0]["losses"]


def test_fsdp_step_accumulate_dp_matches_jax(four):
    got = tw.scenario(four, "matches")[0]["accum_dp"]
    jt = _jax_fsdp(4, 4, accum_mode="dp")
    want = [jt.step_accumulate(MICRO) for _ in range(2)]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(got["full"], jt.state.params)


def test_live_shape_change_4x1_to_2x2_preserves_state(four):
    """dp4 → dp2×fsdp2 → dp4 on the MLP: params bit-identical through each
    move, the eval loss unchanged, the blocks really halved, and each
    event's bytes the reference plan's for the same move."""
    got = tw.scenario(four, "live_4x1_to_2x2")
    jt = _jax_mlp_fsdp()
    x, y = tw.synthetic_classification()
    for i in range(8):
        jt.step((x[i * 64:(i + 1) * 64], y[i * 64:(i + 1) * 64]))
    assert jt.resize(jmesh.MeshShape(dp=2, fsdp=2))
    want = jt.resize_events[-1]
    for i in range(10):
        jt.step((x[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32]))
    assert jt.resize(4)
    want_back = jt.resize_events[-1]
    for g in got:
        assert g["ok"] and g["shape"] == mesh.MeshShape(dp=2, fsdp=2)
        assert g["shape_before"] == mesh.MeshShape(dp=4) and g["size"] == 4
        assert all(np.array_equal(g["before"][k], v)
                   for k, v in g["after"].items())
        assert abs(g["ev_after"] - g["ev_before"]) < 1e-5
        evt = g["event"]
        assert evt["shape"] == "dp2xfsdp2" and evt["transfer"] == "device"
        assert evt["bytes_moved"] < evt["bytes_naive"]  # strict (== 0 here)
        assert {k: evt[k] for k in BYTES} == {k: want[k] for k in BYTES}
        # w0 [16, 32] is sharded on its 32 columns: half the bytes, for the
        # parameter and for Adam's moment alike
        assert g["dims"]["w0"] == 1 and g["w0"] == (16 * 32 * 2,) * 2
        assert np.isfinite(g["trained"])
        assert g["back"] and g["back_same"]
        assert g["back_shape"] == mesh.MeshShape(dp=4)
        assert {k: g["back_event"][k] for k in BYTES} == {
            k: want_back[k] for k in BYTES}


def test_same_size_different_shapes_are_distinct_cache_entries(four):
    for g in tw.scenario(four, "distinct_cache"):
        assert g["ok"] == [True] * 5
        assert [k[0] for k in g["keys"]] == [4, 4]
        assert g["same_mesh"]
        # oscillating back and forth builds no new process group
        assert g["built_after"] == g["built"]
        assert g["groups"] == ["dp", "fsdp"]


def test_shape_resize_rollback_restores_old_layout(four):
    """A failure planted on one rank — an allocation on rank 2 in dp4 →
    dp2×fsdp2, a transfer on rank 1 in dp2×fsdp2 → dp4 — rolls every rank
    back to the old layout with its blocks untouched; training goes on and
    the retry lands."""
    got = tw.scenario(four, "rollback")
    for name, old, new in (("alloc", mesh.MeshShape(dp=4),
                            mesh.MeshShape(dp=2, fsdp=2)),
                           ("transfer", mesh.MeshShape(dp=2, fsdp=2),
                            mesh.MeshShape(dp=4))):
        for g in got:
            r = g[name]
            assert r["ok"] is False and r["same_mesh"] and r["untouched"]
            assert r["shape"] == r["old_shape"] == old
            assert r["ev"][0] == pytest.approx(r["ev"][1], rel=1e-6)
            assert np.isfinite(r["loss"])
            assert r["retry"] and r["retry_shape"] == new
    assert all(g["landed"] for g in got)
    assert [g["transfer"]["failed"] for g in got] == [2] * 4


def test_fsdp_2_to_4_and_back_preserves_state_and_continuity(four):
    """fsdp 2 → 4 → 2 follows the never-resized fsdp 2 within float bounds,
    the whole params bitwise kept through each move; on the MLP, a leaf
    whose sharded dim changes with the fsdp size moves exactly too."""
    g = tw.scenario(four, "fsdp_2_4")[0]
    assert g["kept"] == [True, True]
    for ok, before, after in g["evals"]:
        assert ok and abs(after - before) < 1e-6
    np.testing.assert_allclose(g["resized"], g["control"], rtol=LOSS_RTOL)
    assert g["resized"][-1] < g["resized"][0]
    m = g["mlp"]
    assert m["dims"] == [0, 1, 0]
    assert m["moved"] == [True, True] and m["kept"] == [True, True]
    assert np.isfinite(m["loss"])


def test_replicated_accumulation_is_bitwise_across_layouts(four):
    """accum_mode="replicated": every rank of fsdp 2 and dp2×fsdp2 holds
    bitwise the blocks of the world of one's params and Adam moments, and
    the losses are bitwise equal."""
    got = tw.scenario(four, "replicated_accum")
    one = got[0]["1"]["blocks"]
    losses = {tuple(g[k]["losses"]) for g in got for k in g if g[k]["live"]}
    assert len(losses) == 1
    for g in got:
        for label in ("fsdp2", "dp2xfsdp2"):
            b = g[label]["blocks"]
            if b is None:
                continue
            for name, shard in b["params"].items():
                d, k, i = b["dims"][name], b["fsdp"], b["index"]

                def block(full):
                    if d is None:
                        return full
                    m = full.shape[d] // k
                    return np.take(full, range(i * m, (i + 1) * m), axis=d)

                assert np.array_equal(shard, block(one["params"][name]))
                for key, v in b["opt"][name].items():
                    assert np.array_equal(v, block(one["opt"][name][key]))
    assert got[3]["fsdp2"]["live"] is False
    assert got[3]["dp2xfsdp2"]["live"] is True


def test_ranks_standing_by_compute_nothing(four):
    got = tw.scenario(four, "standby")
    for rank, g in enumerate(got):
        assert g["live"] == (rank < 2) and g["untouched"] != g["live"]
        if not g["live"]:
            assert g["step"] is g["eval"] is g["accum"] is None
            assert g["steps"] == 0 and g["held"] == 0


# -- the sharded trainer on two ranks -----------------------------------------


def test_flagship_fsdp_world_joins_and_resizes_on_the_cpu(two):
    """The entry point behind chip_smoke's phase (l), at TINY on the CPU:
    fsdp over a world of 1 in a group of 2, then 2, then 1 again, each
    rank holding half of every leaf on 2, against a one-rank control."""
    r0, r1 = tw.scenario(two, "flagship_world")
    assert (r0["world"], r0["live"], r1["live"]) == (1, True, False)
    assert r0["resized"] == r1["resized"] == [True, True]
    assert r0["kept"] == [True, True]
    assert r0["shares"] == r1["shares"] == [0.5]
    assert r1["losses"][0] is None and r1["losses"][2] is None
    assert r1["losses"][1] == r0["losses"][1]
    trainer, batch = entry.flagship_trainer(4, 32, device="cpu",
                                            cfg=tfm.TINY)
    control = [trainer.step(batch) for _ in range(3)]
    np.testing.assert_allclose(r0["losses"], control, rtol=LOSS_RTOL)


def test_fsdp_world_matches_jax_through_a_1_to_2_resize(two):
    r0, r1 = tw.scenario(two, "parity_1_2")
    jt = _jax_fsdp(1, 2)
    want = [jt.step(BATCHES[0])]
    assert jt.resize(2)
    want += [jt.step(b) for b in BATCHES[1:]]
    assert r0["resized"] and r1["resized"]
    assert r1["losses"][0] is None and r1["losses"][1:] == r0["losses"][1:]
    np.testing.assert_allclose(r0["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(r0["full"], jt.state.params)
    assert r0["digest"] != r1["digest"]  # each holds its own half
    evt, jevt = r0["events"][0], jt.resize_events[-1]
    assert evt["shape"] == jevt["shape"] == "fsdp2"
    assert {k: evt[k] for k in BYTES} == {k: jevt[k] for k in BYTES}


# -- the dryrun ---------------------------------------------------------------


def _reference_dryrun(n, capsys, monkeypatch) -> dict:
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    graft.dryrun_multichip(n)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("DRYRUN_COMM ")][-1]
    return json.loads(line[len("DRYRUN_COMM "):])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_matches_the_reference(n, capsys, monkeypatch):
    """The port's dryrun passes and prints DRYRUN_COMM with the reference's
    keys, mesh and parameter bytes and its set of collective labels; its
    census holds the reference's per-axis expectations (at n 8 the tp
    axis' all-reduces among them)."""
    got = entry.dryrun_multichip(n, device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("DRYRUN_COMM ")]
    assert len(line) == 1 and json.loads(line[0][12:]) == got
    want = _reference_dryrun(n, capsys, monkeypatch)
    assert set(got) == set(want)
    for key in ("n", "mesh", "param_bytes_total", "param_bytes_sharded",
                "param_bytes_per_device_max", "param_bytes_per_device_min"):
        assert got[key] == want[key], key
    assert set(got["collectives"]) == set(want["collectives"])
    # each rank: every replicated leaf and 1/(fsdp·tp) of every sharded one
    k = got["mesh"]["fsdp"] * got["mesh"]["tp"]
    assert got["param_bytes_per_device_max"] == (
        got["param_bytes_total"] - got["param_bytes_sharded"]
        + got["param_bytes_sharded"] // k)
    fsdp = got["collectives"]["fsdp"]["ops"]
    assert fsdp.get("all-gather") == 1 and fsdp.get("reduce-scatter") == 1
    if n == 4:
        assert got["collectives"]["dp"]["ops"] == {"all-reduce": 1}
        # the replicated leaves' sum over the live group, byte for byte
        assert got["collectives"]["dp"]["bytes"] == \
            want["collectives"]["dp"]["bytes"]
    if n == 8:
        assert set(got["collectives"]) == {"dp", "dp+fsdp", "fsdp", "tp"}
        assert got["collectives"]["tp"]["ops"].get("all-reduce", 0) >= 1


def test_dryrun_injected_replicate_exits_non_zero():
    """The negative control: every leaf placed replicated while the claim
    stays the specs; the run must fail the economy check."""
    env = dict(os.environ, EDL_DRYRUN_INJECT="replicate")
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.entry",
                          "dryrun", "2", "--device", "cpu"],
                         capture_output=True, text=True,
                         timeout=200, env=env, cwd=str(ROOT))
    assert out.returncode != 0
    assert "sharding economy violated" in out.stderr
    assert "DRYRUN_COMM" not in out.stdout


def test_dryrun_injected_replicate_exits_non_zero_at_8():
    """The negative control on the dp2×fsdp2×tp2 layout: a replicated
    placement fails the economy check the tp specs promise."""
    env = dict(os.environ, EDL_DRYRUN_INJECT="replicate")
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.entry",
                          "dryrun", "8", "--device", "cpu"],
                         capture_output=True, text=True,
                         timeout=200, env=env, cwd=str(ROOT))
    assert out.returncode != 0
    assert "sharding economy violated" in out.stderr
    assert "DRYRUN_COMM" not in out.stdout


@pytest.mark.parametrize("n", [1, 3, 12])
def test_dryrun_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="the reference's sweep"):
        entry.dryrun_multichip(n)


# -- the durable loop ---------------------------------------------------------


def test_durable_loop_refuses_an_fsdp_trainer():
    """The loop takes an fsdp trainer (its whole state is gathered to rank
    0 for a save and restored into any layout) and an SDC plane on it
    (its blocks folded where they live); what it refuses is an ``sdc=``
    that is no plane."""
    model = tfm.Transformer(tfm.TINY, device="cpu")
    cfg = VirtualConfig(vw_count=2, global_batch=4)
    t = ElasticTrainer(tfm.loss_fn, model, optim.adam(1e-3),
                       devices=[torch.device("cpu")], param_sharding="fsdp",
                       spec=mesh.MeshSpec(dp=1, fsdp=-1))
    assert VirtualWorkerLoop(t, cfg, batches=None).trainer is t
    with pytest.raises(TypeError, match="SdcPlane"):
        VirtualWorkerLoop(t, cfg, batches=None, sdc=object())
    plane = SdcPlane()
    assert VirtualWorkerLoop(t, cfg, batches=None, sdc=plane).sdc is plane
