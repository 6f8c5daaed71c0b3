"""Sequence parallelism in the port's SPMD ElasticTrainer, held against the
JAX package on the CPU (TINY, fp32, the same init and batches):

* TINY's logits at sp 2 and at tp 2 × sp 2 against the reference's
  single-device ``apply`` (tests/test_models_ops.py's tolerance, 2e-4);
* trainer steps on sp 2 (remat off and on), on tp 2 × sp 2 by the
  partition specs (remat on), on fsdp 2 × sp 2 (the fsdp kind) and on
  dp 2 × sp 2 against JAX's one-device trainer, and accumulation on sp 2
  in both modes;
* the MLP, which has no sp path, on sp 2 stepping bitwise like world 1;
* live resizes 1 → sp 2 → 1 keeping the params bitwise, priced as the
  reference's plan prices the same state, and a prewarmed one a hit;
* a whole state restored into sp 2;
* an ``ElasticServer`` on dp 2 × sp 2 answering each row once;
* ``entry.flagship_sp_world`` (chip_smoke's phase (w)) at TINY;
* ``dryrun_multichip(16)`` against the reference's, which runs in a
  subprocess with 16 virtual CPU devices (this session has 8).

Two spawned gloo worlds run, once each (tests/torch_world.py,
``suite_sp_two`` and ``suite_sp_four``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.models import transformer as jtfm
from edl_tpu.parallel import mesh as jmesh
from edl_tpu.parallel import replan as jreplan
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import entry
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.parallel.mesh import MeshShape

ROOT = Path(__file__).resolve().parents[1]
WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

#: the roadmap's starting tolerances for TINY in fp32; the forward's is the
#: reference's own sp test's
LOSS_RTOL, PARAM_ATOL, LOGITS_TOL = 1e-5, 1e-4, 2e-4
BYTES = ("bytes_moved", "bytes_ici", "bytes_dcn", "bytes_naive")


def _batch(seed, b=4, s=32, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


JAX_PARAMS = jtfm.init(jax.random.key(0), jtfm.TINY)
TINY_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
BATCHES = [_batch(seed) for seed in (1, 2, 3)]
MICRO = [_batch(seed, b=2) for seed in (10, 11, 12, 13)]
TOKENS = np.arange(64, dtype=np.int32).reshape(2, 32) % jtfm.TINY.vocab_size
MLP_PARAMS = jax.tree.map(np.asarray, jmlp.init(jax.random.key(1),
                                                [16, 32, 4]))
ROWS = np.random.default_rng(5).standard_normal((8, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.run("sp_two", 2, tmp_path_factory.mktemp("sp2"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  micro=MICRO, tokens=TOKENS,
                  data=tw.synthetic_classification(),
                  flagship_kw=dict(cfg=tfm.TINY, batch=2, seq=64))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.run("sp_four", 4, tmp_path_factory.mktemp("sp4"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  tokens=TOKENS, mlp_params=MLP_PARAMS, rows=ROWS)


def _key(name: str) -> str:
    return "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def _assert_params_close(port: dict, jax_params):
    flat = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_params)}
    assert len(flat) == len(port)
    for name, got in port.items():
        np.testing.assert_allclose(got, flat[_key(name)], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def _jax_single(**kw):
    return JaxTrainer(jtfm.make_loss_fn(jtfm.TINY),
                      jax.tree.map(jnp.copy, JAX_PARAMS), optax.adamw(1e-3),
                      devices=jax.devices()[:1], **kw)


def _jax_steps():
    jt = _jax_single()
    ev = float(jtfm.make_loss_fn(jtfm.TINY)(JAX_PARAMS, BATCHES[0]))
    return ev, [jt.step(b) for b in BATCHES], jt.state.params


def _check_steps(g, want_eval, want, params):
    assert g["eval"] == pytest.approx(want_eval, rel=LOSS_RTOL)
    np.testing.assert_allclose(g["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(g["full"], params)


# -- the forward --------------------------------------------------------------


def test_sp2_forward_matches_the_reference_apply(two):
    """Each rank's logits are its 16-token chunk of the sequence; put
    together they are the reference's single-device logits."""
    want = np.asarray(jtfm.apply(JAX_PARAMS, jnp.asarray(TOKENS),
                                 jtfm.TINY))
    got = tw.scenario(two, "forward")
    assert all(g.shape == (2, 16, jtfm.TINY.vocab_size) for g in got)
    np.testing.assert_allclose(np.concatenate(got, axis=1), want,
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_tp2_sp2_forward_matches_the_reference_apply(four):
    """tp 2 × sp 2 by the partition specs: rank r (tp coordinate r // 2,
    sp coordinate r % 2) holds its sequence chunk of its vocabulary
    columns; the blocks put together are the reference's logits."""
    want = np.asarray(jtfm.apply(JAX_PARAMS, jnp.asarray(TOKENS),
                                 jtfm.TINY))
    got = np.zeros_like(want)
    v, s = want.shape[2] // 2, want.shape[1] // 2
    for rank, block in enumerate(tw.scenario(four, "forward_tp_sp")):
        t, c = divmod(rank, 2)
        got[:, c * s:(c + 1) * s, t * v:(t + 1) * v] = block
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)


# -- steps ------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_sp2_steps_match_the_reference(two, remat):
    """Three steps on sp 2 against JAX's one-device trainer: the eval loss,
    the losses and the params.  A step's census: the ring's hops (k and v
    forward and their gradients back, a layer; with remat each layer's
    recomputed forward hops again) and one all-reduce of the gradients and
    the loss over the sp line."""
    ev, want, params = _jax_steps()
    permutes = 8 + (4 if remat else 0)
    for g in tw.scenario(two, "steps"):
        _check_steps(g[remat], ev, want, params)
        assert g[remat]["census"]["sp"]["ops"] == {
            "collective-permute": permutes, "all-reduce": 1}
        assert set(g[remat]["census"]) == {"sp"}


def test_tp2_sp2_steps_match_the_reference(four):
    """The partition specs on tp 2 × sp 2, remat on: the reference's
    one-device steps; the tp all-reduces and the ring's hops, and the
    gradients reduced over the sp line (the data axes)."""
    ev, want, params = _jax_steps()
    for g in tw.scenario(four, "steps_tp_sp"):
        _check_steps(g, ev, want, params)
        assert set(g["census"]) == {"tp", "sp"}
        assert g["census"]["sp"]["ops"] == {"collective-permute": 12,
                                            "all-reduce": 1}


def test_fsdp2_sp2_steps_match_the_reference(four):
    """The fsdp kind on fsdp 2 × sp 2: the fsdp blocks' gradients
    reduce-scattered over fsdp and summed over the sp line (dp+sp, here the
    sp axis' own group), the rest over the data group fsdp+sp."""
    ev, want, params = _jax_steps()
    for g in tw.scenario(four, "fsdp_sp"):
        _check_steps(g, ev, want, params)
        assert set(g["census"]) == {"fsdp", "sp", "fsdp+sp"}
        assert g["census"]["fsdp"]["ops"] == {"all-gather": 1,
                                              "reduce-scatter": 1}
        assert g["census"]["sp"]["ops"] == {"collective-permute": 8,
                                            "all-reduce": 1}
        assert g["census"]["fsdp+sp"]["ops"] == {"all-reduce": 1}


def test_dp2_sp2_steps_match_the_reference(four):
    """Replicated on dp 2 × sp 2: each dp half of the batch, its sequence
    split over its sp line; the gradients and the loss all-reduced once
    over the data group dp+sp."""
    ev, want, params = _jax_steps()
    for g in tw.scenario(four, "dp_sp"):
        _check_steps(g, ev, want, params)
        assert set(g["census"]) == {"sp", "dp+sp"}
        assert g["census"]["sp"]["ops"] == {"collective-permute": 8}
        assert g["census"]["dp+sp"]["ops"] == {"all-reduce": 1}


def test_sp2_step_accumulate_matches_jax_in_both_modes(two):
    """Each rank takes its chunk of every micro-batch; the summed gradients
    are averaged over the sp line: the reference's accumulated step."""
    jt = _jax_single(accum_mode="dp")
    want = [jt.step_accumulate(MICRO) for _ in range(2)]
    for g in tw.scenario(two, "accumulate"):
        for mode in ("dp", "replicated"):
            np.testing.assert_allclose(g[mode]["losses"], want,
                                       rtol=LOSS_RTOL, err_msg=mode)
            _assert_params_close(g[mode]["full"], jt.state.params)


def test_mlp_without_an_sp_path_steps_like_world_one(two):
    """The MLP reads no sp context: both ranks of sp 2 compute the whole
    batch, and averaging their equal gradients is exact, so the losses and
    the state are bitwise world 1's."""
    r0, r1 = tw.scenario(two, "mlp_sp")
    assert r0[1]["live"] and not r1[1]["live"]
    assert r1[1]["losses"] == [None] * 4
    assert r0[2]["losses"] == r1[2]["losses"] == r0[1]["losses"]
    assert r0[2]["digest"] == r1[2]["digest"] == r0[1]["digest"]


# -- resizes and restores ----------------------------------------------------


def _ref_replicated_plan(old: MeshShape, new: MeshShape):
    """The reference's plan for the replicated state (params, Adam's two
    moments and its count) between two meshes."""
    def shardings(shape):
        m = jmesh.make_mesh(shape.size, jmesh.MeshSpec(**shape.axis_sizes()),
                            devices=jax.devices()[:shape.size])
        rep = jax.tree.map(lambda _: NamedSharding(m, P()), TINY_PARAMS)
        return {"params": rep, "mu": rep, "nu": rep,
                "count": NamedSharding(m, P())}

    tree = {"params": TINY_PARAMS, "mu": TINY_PARAMS, "nu": TINY_PARAMS,
            "count": jnp.zeros((), jnp.int32)}
    return jreplan.plan_reshard(tree, shardings(old), shardings(new))


def test_resizes_into_and_out_of_sp_keep_params_and_price_as_the_reference(
        two):
    """1 → sp 2 → 1: the whole params bitwise kept through each move, each
    move's bytes the reference plan's for the same state, the grow's
    broadcasts those bytes less Adam's count (sent by value), and the
    losses those of one device."""
    r0, r1 = tw.scenario(two, "resize")
    jt = _jax_single()
    want = [jt.step(b) for b in BATCHES]
    assert r0["kept"] == [True, True]
    assert r0["shapes"] == [MeshShape(sp=2), MeshShape()]
    np.testing.assert_allclose(r0["losses"], want, rtol=LOSS_RTOL)
    assert r1["losses"][1] == r0["losses"][1]
    shapes = [MeshShape(), *r0["shapes"]]
    for evt, old, new in zip(r0["events"], shapes, shapes[1:]):
        ref = _ref_replicated_plan(old, new)
        assert {k: evt[k] for k in BYTES} == {k: getattr(ref, k)
                                               for k in BYTES}, evt["shape"]
    assert 0 <= r0["events"][0]["bytes_moved"] - r0["sent"][0] <= 4
    assert r0["events"][0]["bytes_moved"] > 0 == r0["events"][1][
        "bytes_moved"]


def test_prewarmed_resize_into_sp2_is_a_hit(two):
    """prewarm([sp 2]) builds the layout's groups (the sp line among them)
    ahead; the resize into it is a prewarm hit, and the next step is the
    reference's second."""
    jt = _jax_single()
    want = [jt.step(b) for b in BATCHES[:2]]
    for g in tw.scenario(two, "prewarm"):
        assert g["ok"] and g["hit"]
        assert g["loss"] == pytest.approx(want[1], rel=LOSS_RTOL)


def test_whole_state_restores_into_sp2(two):
    """A world-1 trainer's whole state after two steps, loaded into a fresh
    sp-2 trainer: its whole params bitwise the source's, and its next step
    the source's next step."""
    r0, r1 = tw.scenario(two, "restore")
    assert r0["same"] is True
    assert r0["sp_loss"] == r1["sp_loss"]
    assert r0["sp_loss"] == pytest.approx(r0["one_loss"], rel=LOSS_RTOL)
    for name, v in r0["sp_full"].items():
        np.testing.assert_allclose(v, r0["one_full"][name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


# -- serving and the entry point ----------------------------------------------


def test_elastic_server_on_dp2_sp2_answers_each_row_once(four):
    """dp 2 × sp 2: each dp slice is computed by both ranks of its sp line
    (the forward runs outside the sp context) and the rows gathered over the
    data axes keep one copy of each: every rank answers the batch as one
    device does."""
    want = np.asarray(jmlp.apply(MLP_PARAMS, jnp.asarray(ROWS)))
    for got in tw.scenario(four, "serve_dp_sp"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_flagship_sp_world_runs_phase_w_at_tiny(two):
    """flagship_sp_world at TINY on the CPU through phase (w)'s worlds 2,
    2, 1, 2: the same loss and the same state on both ranks of each sp-2
    step, each step's hops (TINY is fp32: the plain ring, 8 a step) and one
    all-reduce over the sp line, the whole params kept through each resize,
    the grow's broadcasts the plan's bytes less Adam's count, and the
    losses a one-rank control's."""
    r0, r1 = tw.scenario(two, "flagship_world")
    assert r0["world"] == r1["world"] == 2
    assert r0["resized"] == r1["resized"] == [True, True]
    assert r0["kept"] == [True, True]
    for i, (a, b) in enumerate(zip(r0["params"], r1["params"])):
        if i != 2:
            assert a == b and r0["losses"][i] == r1["losses"][i]
            assert r0["census"][i]["sp"]["ops"] == {
                "collective-permute": 8, "all-reduce": 1}
    assert r1["losses"][2] is None and r0["census"][2] == {}
    grow = r0["events"][1]
    assert grow["shape"] == "sp2"
    assert 0 <= grow["bytes_moved"] - r0["sent"][1] <= 4
    trainer, batch = entry.flagship_trainer(2, 64, device="cpu",
                                            cfg=tfm.TINY)
    control = [trainer.step(batch) for _ in range(4)]
    np.testing.assert_allclose(r0["losses"], control, rtol=LOSS_RTOL)


@pytest.mark.timeout_s(300)
def test_dryrun_multichip_16_matches_the_reference(capsys):
    """The reference's layout for 16, dp 2 × fsdp 2 × tp 2 × sp 2, on 16
    gloo ranks: the mesh and parameter bytes equal to the reference's
    (427 264 in all, 425 984 sharded, 107 776 a rank), the ring's
    collective-permutes on sp as many and as large as the reference's, and
    the fsdp blocks' gradients all-reduced over dp+sp with the reference's
    bytes.  The reference's XLA splits the replicated leaves' reduction
    over dp+fsdp+sp into a dp+fsdp and an sp all-reduce; the port runs one
    over the data group, of the same bytes."""
    ref = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(16)"],
        capture_output=True, text=True, timeout=200, cwd=str(ROOT),
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = json.loads([ln for ln in ref.stdout.splitlines()
                       if ln.startswith("DRYRUN_COMM ")][-1][12:])
    got = entry.dryrun_multichip(16, device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("DRYRUN_COMM ")]
    assert len(line) == 1 and json.loads(line[0][12:]) == got
    assert set(got) == set(want)
    for key in ("n", "mesh", "param_bytes_total", "param_bytes_sharded",
                "param_bytes_per_device_max", "param_bytes_per_device_min"):
        assert got[key] == want[key], key
    assert got["mesh"] == {"dp": 2, "fsdp": 2, "tp": 2, "sp": 2, "ep": 1}
    assert (got["param_bytes_total"], got["param_bytes_sharded"],
            got["param_bytes_per_device_max"]) == (427264, 425984, 107776)
    c, w = got["collectives"], want["collectives"]
    assert set(c) == {"dp+fsdp+sp", "dp+sp", "fsdp", "sp", "tp"}
    assert c["sp"] == {"ops": {"collective-permute": 8}, "bytes": 16384}
    assert w["sp"]["ops"]["collective-permute"] == 8
    assert c["dp+sp"] == w["dp+sp"] == {"ops": {"all-reduce": 1},
                                        "bytes": 106496}
    assert c["dp+fsdp+sp"]["bytes"] == w["dp+fsdp"]["bytes"]
    assert w["sp"]["bytes"] == (c["sp"]["bytes"]
                                + c["dp+fsdp+sp"]["bytes"])
    assert c["fsdp"]["ops"] == {"all-gather": 1, "reduce-scatter": 1}
    assert c["tp"]["ops"]["all-reduce"] >= 1
