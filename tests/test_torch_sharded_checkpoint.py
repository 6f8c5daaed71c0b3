"""The sharded trainer's checkpoint lineage: a sharded trainer's whole state
saved layout-free from rank 0 (``ElasticTrainer.whole_state``), restored
into any layout (``ElasticCheckpointer.restore(..., shardings=trainer)``),
and the durable virtual-worker loop on sharded trainers.

One spawned gloo world of eight CPU ranks (tests/torch_world.py,
``suite_sharded``) runs, in sequence: a TINY state (fp32, the JAX init, two
adamw steps) saved from each of replicated 1, fsdp 2, tp 2 and dp2×fsdp2
and restored into each of replicated 1, fsdp 2 and tp 2 (gathered bitwise
the saved state); one state's manifests as an fsdp-2, a tp-2 and a world-1
trainer save it, against the JAX checkpointer's for the same weights; a
torn newest step on an fsdp trainer; a tp-2 job killed and restored at the
same layout; and tests/test_accuracy_elasticity.py's 4→2→8 walk and its
kill mid-accumulation on fsdp MLP trainers, bitwise the port's replicated
control and within ``CONTROL_ATOL`` of the JAX control."""

import jax
import numpy as np
import optax
import pytest
import torch

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.models import transformer as jtfm
from edl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from edl_tpu.runtime import virtual as jvirtual
from edl_tpu.runtime.checkpoint import ElasticCheckpointer as JaxCheckpointer
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.data import ShardRegistry
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.virtual import (VirtualConfig, loss_divergence,
                                           trajectories_equivalent)

#: the world's children are joined within this deadline
WORLD_DEADLINE_S = 240
pytestmark = pytest.mark.timeout_s(300)

SEED = 3
#: the port's control against the JAX control (fp32, 20 adam steps), the
#: bound tests/test_torch_virtual.py holds the replicated loop to
CONTROL_ATOL = 1e-5
JAX_PARAMS = jtfm.init(jax.random.key(0), jtfm.TINY)
TINY_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
MLP_JAX = jmlp.init(jax.random.key(0), [16, 32, 4])
MLP_PARAMS = jax.tree.map(np.asarray, MLP_JAX)
CFG = VirtualConfig(vw_count=8, global_batch=64, job_seed=SEED)
JCFG = jvirtual.VirtualConfig(vw_count=8, global_batch=64, job_seed=SEED)


def _batch(seed, b=4, s=32, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                  dtype=np.int64)
    return tokens, np.roll(tokens, -1, axis=1)


def _dataset(n=2048):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, n).astype(np.int32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return x, y


BATCHES = [_batch(seed) for seed in (1, 2)]
#: the tp job's rows: 64 sequences of TINY's 32 tokens
TOKENS = _batch(9, b=64)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.run("sharded", 8, tmp_path_factory.mktemp("sharded8"),
                  WORLD_DEADLINE_S, tiny_params=TINY_PARAMS,
                  batches=BATCHES, tokens=TOKENS, mlp_params=MLP_PARAMS,
                  data=_dataset(), seed=SEED)


@pytest.mark.parametrize("saved", list(tw.SAVE_LAYOUTS))
@pytest.mark.parametrize("into", tw.RESTORE_LAYOUTS)
def test_state_saved_from_any_layout_restores_into_any_layout(world, saved,
                                                              into):
    """Gathered after the restore, every parameter and Adam moment is
    bitwise the saved one, Adam's count is the saver's and the
    hyperparameters are kept; ranks past the target's world stand by."""
    got = [g[saved, into] for g in tw.scenario(world, "matrix")]
    n = tw.SAVE_LAYOUTS[into][0]
    assert [g["live"] for g in got] == [True] * n + [False] * (8 - n)
    assert all(g["step"] == 2 and g["hash_ok"] and g["hyper"] for g in got)
    assert got[0]["equal"] is True
    assert got[0]["counts"] == [2.0]
    assert all(g["equal"] is None for g in got[1:])


def test_one_state_has_one_manifest_whatever_layout_saves_it(world,
                                                              tmp_path):
    """The world-1, fsdp-2 and tp-2 saves of one state have the same
    per-leaf folds and fingerprint, and their parameters' folds are the JAX
    checkpointer's for the same weights."""
    g = tw.scenario(world, "manifests")[0]
    m = g["manifests"]
    ref = m["replicated1"]
    assert ref["verified"] and ref["leaves"]
    for label in ("fsdp2", "tp2"):
        assert m[label]["leaves"] == ref["leaves"]
        assert m[label]["tree_hash"] == ref["tree_hash"]
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, _: g["state"]["['params']"
                                   + jax.tree_util.keystr(path)],
        JAX_PARAMS)
    jck = JaxCheckpointer(tmp_path / "jax")
    jck.save(2, {"params": jparams, "opt": optax.adamw(1e-3).init(jparams)})
    want = {p: f for p, f in jck.manifest(2)["leaves"].items()
            if p.startswith("['params']")}
    jck.close()
    assert want and {p: f for p, f in ref["leaves"].items()
                     if p.startswith("['params']")} == want


def test_torn_newest_step_falls_back_on_an_fsdp_trainer(world):
    got = tw.scenario(world, "torn")
    assert [g["step"] for g in got] == [1] * 8  # every rank agrees
    assert all(g["hash_ok"] and g["corruption"] == 1
               and g["recoveries"] == 1 for g in got)
    assert got[0]["equal"] is True
    assert [g["live"] for g in got] == [True] * 2 + [False] * 6


def test_tp_kill_and_restore_is_bitwise_invisible(world):
    """The same layout schedule with and without a kill mid-accumulation
    gives the same losses (tp's bf16 partial sums make it no match for a
    replicated control, but a restore changes nothing)."""
    got = tw.scenario(world, "tp_kill")
    g = got[0]
    assert g["killed"] and g["restored"] == 4
    assert len(g["control"]) == 6 and g["stitched"] == g["control"]
    assert [r["killed"] for r in got] == [r["live"] for r in got] \
        == [True] * 2 + [False] * 6


def _jax_control(steps=20):
    reg = ShardRegistry()
    ids = reg.register_arrays(_dataset(), num_shards=16)
    jtr = JaxTrainer(jmlp.loss_fn, MLP_JAX, optax.adam(1e-2),
                     spec=JaxMeshSpec(dp=-1), devices=jax.devices()[:1],
                     accum_mode="replicated")
    return jvirtual.VirtualWorkerLoop(
        jtr, JCFG, jvirtual.VirtualBatches(JCFG, ids, reg.get, passes=2)
    ).run(max_steps=steps)


def test_fsdp_resize_4_2_8_matches_the_replicated_control(world):
    g = tw.scenario(world, "durable_fsdp")[0]
    div = loss_divergence(g["control"], g["walk"])
    assert div["steps_compared"] == 20 and div["bitwise"], div
    assert g["walk_resizes"] == 2
    assert g["walk_worlds"][0] == 4 and 2 in g["walk_worlds"] \
        and g["walk_worlds"][-1] == 8
    assert all(c == 1 for c in g["walk_rows"].values())
    assert len(g["walk_rows"]) == 20 * CFG.global_batch
    ref = _jax_control()
    np.testing.assert_allclose(g["walk"], ref.losses, rtol=0,
                               atol=CONTROL_ATOL)
    assert trajectories_equivalent(ref.losses, g["walk"])


def test_fsdp_kill_mid_accumulation_restores_exactly_once(world):
    got = tw.scenario(world, "durable_fsdp")
    g = got[0]
    # the ranks live at the kill (fsdp 2) are killed; the rest stand by
    assert [r["killed"] for r in got] == [r["live"] for r in got] \
        == [True] * 2 + [False] * 6
    assert all(r["restored"] == 10 for r in got)
    assert g["stitched"] == g["control"]  # bitwise, kill and all
    assert sum(g["rows"].values()) == 20 * CFG.global_batch
    assert all(c == 1 for c in g["rows"].values())
    assert g["saved"] == [10, 15, 20]
    np.testing.assert_allclose(g["stitched"], _jax_control().losses, rtol=0,
                               atol=CONTROL_ATOL)


def test_whole_state_of_one_rank_is_its_replicated_save(tmp_path):
    """Without a process group an fsdp trainer is one rank holding every
    leaf whole: its whole state is a host copy under the paths of the
    module and optimizer a replicated trainer hands the checkpointer, and
    loading it into a fresh trainer gives the same state."""
    def make(seed):
        return ElasticTrainer(tfm.loss_fn,
                              tfm.Transformer(tfm.TINY, device="cpu",
                                              seed=seed),
                              optim.adamw(1e-3),
                              devices=[torch.device("cpu")],
                              param_sharding="fsdp",
                              spec=MeshSpec(dp=1, fsdp=-1))
    t = make(0)
    t.step(BATCHES[0])
    state = t.whole_state()
    flat = tw.flat_state(t)
    assert "['opt']['layers'][0]['wq']['exp_avg']" in flat
    assert "['params']['lm_head']" in flat
    assert not state["['params']['embed']"].is_cuda
    u = make(5)
    u.load_whole_state(state)
    assert tw.same_state(flat, tw.flat_state(u))
    assert tw.hyper(u) == tw.hyper(t)


@pytest.mark.parametrize("kind", ["fsdp", "tp"])
def test_flagship_virtual_world_lays_the_trainer_out_as_asked(kind):
    """The entry point of phase (o) builds an fsdp or a tp trainer (one
    process, TINY on the CPU: a world of 1, every leaf whole)."""
    from edl_tpu_torch.entry import flagship_virtual_world

    sharding, spec = (("fsdp", MeshSpec(dp=1, fsdp=-1)) if kind == "fsdp"
                      else (tfm.param_partition_specs(tfm.TINY),
                            MeshSpec(tp=-1)))
    trainer, _, ids, cfg = flagship_virtual_world(
        0, 1, None, device="cpu", cfg=tfm.TINY, seq=32,
        param_sharding=sharding, spec=spec)
    assert trainer.sharded and trainer.world_size == 1
    assert trainer.param_sharding_kind == ("fsdp" if kind == "fsdp"
                                           else "specs")
    assert cfg.vw_count == 8 and len(ids) == 16
