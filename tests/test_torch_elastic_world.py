"""The port's multi-rank ElasticTrainer on spawned gloo worlds of the CPU:
held against the JAX package's ElasticTrainer on the virtual CPU mesh
(TINY, fp32, the same init and batches), and the scenarios of
tests/test_runtime.py and tests/test_replan.py that hold for replicated
data parallelism.

Two worlds run, once each (tests/torch_world.py): two ranks joined through
``entry.flagship_elastic_world``, and four ranks running every other
scenario in sequence.  Each rank is a spawned process on a FileStore under
tmp_path; the JAX side is computed here, in the test process."""

import jax
import numpy as np
import optax
import pytest

import torch_world as tw
from edl_tpu.models import transformer as jtfm
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer

#: each world's children are joined within WORLD_DEADLINE_S and killed after
#: it; a test's own ceiling (tests/conftest.py) sits above that
WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

#: the roadmap's starting tolerances for TINY in fp32
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4


def _batch(seed, b=4, s=32, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


JAX_PARAMS = jtfm.init(jax.random.key(0), jtfm.TINY)
TINY_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
BATCHES = [_batch(seed) for seed in (1, 2, 3)]
MICRO = [_batch(seed, b=2) for seed in (10, 11, 12, 13)]


def _jax_trainer(n0, devices=2, **kw):
    return JaxTrainer(jtfm.make_loss_fn(jtfm.TINY), JAX_PARAMS,
                      optax.adamw(1e-3), devices=jax.devices()[:devices],
                      initial_world_size=n0, **kw)


def _assert_params_close(port: dict, jax_params, atol=PARAM_ATOL):
    flat = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_params)}
    assert len(flat) == len(port)
    for name, got in port.items():
        key = "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                      for p in name.split("."))
        np.testing.assert_allclose(got, flat[key], atol=atol, rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.run("two", 2, tmp_path_factory.mktemp("world2"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, batches=BATCHES,
                  flagship_kw=dict(cfg=tw.tfm.TINY, batch=4, seq=32,
                                   initial_world_size=1))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.run("four", 4, tmp_path_factory.mktemp("world4"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS, micro=MICRO)


def test_flagship_elastic_world_joins_and_resizes_on_the_cpu(two):
    """The entry point behind chip_smoke's phase (j), at TINY on the CPU:
    a world of 1 in a group of 2, then 2, then 1 again."""
    r0, r1 = tw.scenario(two, "flagship_world")
    assert (r0["world"], r0["live"], r1["live"]) == (1, True, False)
    assert r0["use_flash"] and r0["batch"] == (4, 32)
    assert r0["resized"] == r1["resized"] == [True, True]
    assert r1["losses"][0] is None and r1["losses"][2] is None
    assert r1["losses"][1] == r0["losses"][1]  # the world-2 loss, bitwise
    assert all(np.isfinite(r0["losses"]))


def test_two_rank_world_matches_jax_trainer_through_a_1_to_2_resize(two):
    r0, r1 = tw.scenario(two, "parity_step")
    jt = _jax_trainer(1)
    want = [jt.step(BATCHES[0])]
    assert jt.resize(2)
    want += [jt.step(b) for b in BATCHES[1:]]
    assert r0["resized"] and r1["resized"]
    assert r1["losses"][0] is None and r1["losses"][1:] == r0["losses"][1:]
    # each live rank computed its own contiguous half of the global batch
    assert r0["rows"] == [(4, BATCHES[0][0][0, 0])] + [
        (2, b[0][0, 0]) for b in BATCHES[1:]]
    assert r1["rows"] == [(2, b[0][2, 0]) for b in BATCHES[1:]]
    np.testing.assert_allclose(r0["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(r0["params"], jt.state.params)
    assert r0["digest"] == r1["digest"] and r0["step"] == r1["step"] == 3
    # the replicated 1→2 move sends every byte of state to the joiner
    evt = r0["events"][0]
    assert evt["bytes_ici"] == evt["bytes_moved"] > 0
    assert evt["bytes_dcn"] == 0 and evt["size"] == 2


@pytest.mark.parametrize("n", [2, 4])
def test_step_accumulate_dp_matches_jax(four, n):
    got = [r[n] for r in tw.scenario(four, "accum_dp")]
    jt = _jax_trainer(n, devices=4, accum_mode="dp")
    want = [jt.step_accumulate(MICRO) for _ in range(2)]
    np.testing.assert_allclose(got[0]["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(got[0]["params"], jt.state.params)
    live = [g for g in got if g["live"]]
    assert len(live) == n and len({g["digest"] for g in live}) == 1


def test_replicated_accumulation_is_bitwise_equal_at_worlds_1_2_4(four):
    got = tw.scenario(four, "replicated")
    digests = {g[n]["digest"] for g in got for n in (1, 2, 4)
               if g[n]["live"]}
    assert len(digests) == 1
    losses = {tuple(g[n]["losses"]) for g in got for n in (1, 2, 4)
              if g[n]["live"]}
    assert len(losses) == 1


def test_ranks_standing_by_compute_nothing(four):
    got = tw.scenario(four, "standby")
    for rank, g in enumerate(got):
        assert g["live"] == (rank < 2) and g["untouched"] != g["live"]
        if not g["live"]:
            assert g["step"] is g["eval"] is g["accum"] is None
            assert g["steps"] == 0


def test_training_reduces_loss(four):
    for g in tw.scenario(four, "reduces_loss")[:2]:
        assert g["final"] < g["first"] * 0.7


def test_resize_mid_training_preserves_state_and_learning(four):
    got = tw.scenario(four, "resize_mid_training")
    g = got[0]
    assert g["grew"] and g["world_grown"] == 4 and g["shrank"]
    # state survives: the eval loss is unchanged by the move
    assert abs(g["after"] - g["before"]) < 1e-5
    assert g["step_after"] == g["step_before"]
    assert len({r["digest_grown"] for r in got}) == 1
    assert g["trained_4"] < g["before"]
    assert g["final"] <= g["loss_4"] * 1.05
    assert g["resizes"] == 2 and g["world"] == 2


def test_loss_continuity_through_4_2_4(four):
    """A 4→2→4 run follows the never-resized world of 4 step for step,
    within the float bounds of a regrouped reduction."""
    g = tw.scenario(four, "continuity_4_2_4")[0]
    assert g["worlds"] == (4, 4)
    for ok, before, after in g["evals"]:
        assert ok and abs(after - before) < 1e-6
    np.testing.assert_allclose(g["resized"], g["control"], rtol=1e-5)
    assert g["resized"][-1] < g["resized"][0]


def test_step_cache_no_recompile_on_oscillation(four):
    """1→2→1→2→1→2 builds each prefix's process group once, on the first
    visit, and hands back the same group after."""
    for g in tw.scenario(four, "oscillation"):
        assert [s[:2] for s in g["seen"]] == [(True, 2), (True, 1)] * 2 + [
            (True, 2)]
        assert all(same for _, _, same, _ in g["seen"])
        built = [n for *_, n in g["seen"]]
        assert built[1] <= 2 and set(built[1:]) == {built[1]}


def test_resize_failure_rolls_back_and_keeps_training(four):
    """A failure planted on one rank only — an allocation on rank 3, a
    transfer on rank 2 — rolls every rank back; the old world keeps
    training, and the retry commits."""
    got = tw.scenario(four, "planted_failures")
    for name, failed in (("alloc", 1), ("transfer", 2)):
        for rank, g in enumerate(got):
            r = g[name]
            assert r["ok"] is False and r["world"] == 2
            assert r["failed"] == failed and r["resizes"] == 0
            assert (r["loss"] is not None) == (rank < 2)
        assert got[0][name]["digest"] == got[1][name]["digest"]
        assert np.isfinite(got[0][name]["loss"])
    assert all(g["retry"] for g in got)
    assert all(g["retry_loss"] == got[0]["retry_loss"] for g in got)
    assert len({g["after"] for g in got}) == 1


def test_elastic_resize_with_transformer(four):
    got = tw.scenario(four, "transformer")
    g = got[0]
    assert g["grew"] and g["shrank"]
    # the move is exact: every rank holds rank 0's pre-resize bytes
    assert {r["after"] for r in got} == {g["before"]}
    assert g["final"] < g["before_loss"] < g["first"]


def test_eval_loss_matches_train_objective_and_survives_resize(four):
    g = tw.scenario(four, "eval_loss")[0]
    assert g["ev"] == pytest.approx(g["direct"], rel=1e-5)
    assert g["untouched"] and g["step"] == 0
    assert g["trained"] < g["ev"]
    assert g["ev4"] == pytest.approx(g["direct4"], rel=1e-5)
    assert g["ev1"] == pytest.approx(g["ev4"], rel=1e-4)


def test_resize_phase_histogram_gains_replan_phase(four):
    """Each resize records the reference's event fields and feeds the
    phase histogram, the goodput ledger and the calibration ledger."""
    for g in tw.scenario(four, "records"):
        assert g["grew"] and g["phases"] == ["replan", "compile", "reshard"]
        evt = g["events"][-1]
        assert set(evt) == {
            "compile_ms", "replan_ms", "reshard_ms", "prewarm_hit", "shape",
            "bytes_moved", "bytes_ici", "bytes_dcn", "bytes_naive",
            "reshard_gbps", "transfer", "size", "step"}
        assert evt["shape"] == "dp4" and evt["transfer"] == "device"
        assert evt["prewarm_hit"] is False and evt["size"] == 4
        assert evt["bytes_moved"] < evt["bytes_naive"]
        assert g["ledger_world"] == 4 and g["reshard_chip_s"] > 0
        assert g["conserves"] and g["calib_samples"] == 1


def test_unresolvable_resize_target_soft_fails(four):
    for rank, g in enumerate(tw.scenario(four, "unresolvable")):
        assert g["matches"] == [False, False, False, True]
        assert g["soft"] == [False, False] and g["failed_soft"] == 2
        # beyond the group, and a layout this trainer does not build
        assert g["staged"] == [False, False] and g["failed"] == 4
        assert g["world"] == 4 and np.isfinite(g["loss"])
        assert g["landed"] and g["world_after"] == 3
