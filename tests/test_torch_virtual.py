"""The port's virtual-worker layer against the JAX package's: the shard
contract, the ownership map, the batch stream and its cursors with outputs
equal to the reference's, the derived RNG lineage, accumulation with
``rng_in_loss``, and the equivalence scenarios of
tests/test_accuracy_elasticity.py.

Scenarios that need several ranks run once, in sequence, in one spawned
gloo world of 8 CPU ranks (tests/torch_world.py): the 4→2→8 walk bitwise
equal to the unresized control, the dp-packed mode within the documented
tolerance, augmentation on the lineage, a kill mid-accumulation restored on
fresh trainers exactly once, a drifted config refused, a stall detected and
invisible to the loss, and a checkpoint restored onto another world size.
The MLP is [16, 32, 4] on 2 048 rows, from the JAX init."""

import json

import jax
import numpy as np
import optax
import pytest
import torch

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.parallel.mesh import MeshSpec
from edl_tpu.runtime import data as jdata
from edl_tpu.runtime import virtual as jvirtual
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import interop
from edl_tpu_torch.entry import flagship_virtual_world
from edl_tpu_torch.models import mlp
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.data import ShardRegistry, _row_splits, shard_sizes
from edl_tpu_torch.runtime.elastic import AccumulationAborted, ElasticTrainer
from edl_tpu_torch.runtime.virtual import (
    CursorStore,
    OwnershipMap,
    VirtualBatches,
    VirtualConfig,
    VirtualWorkerLoop,
    assign_ownership,
    loss_divergence,
    trajectories_equivalent,
    vw_key,
    vw_keys,
    vw_seed,
)

SEED = 3
N_ROWS = 2048
N_SHARDS = 16
CFG = VirtualConfig(vw_count=8, global_batch=64, job_seed=SEED)
JCFG = jvirtual.VirtualConfig(vw_count=8, global_batch=64, job_seed=SEED)
JAX_PARAMS = jmlp.init(jax.random.key(0), [16, 32, 4])
MLP_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
#: the eight-rank world's children are joined within this deadline
WORLD_DEADLINE_S = 240
#: the port's control against the JAX control (fp32, 20 adam steps)
CONTROL_ATOL = 1e-5


def _dataset(n=N_ROWS):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, n).astype(np.int32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return x, y


def _registry(n=N_ROWS, shards=N_SHARDS):
    reg = ShardRegistry()
    return reg, reg.register_arrays(_dataset(n), num_shards=shards)


def _trainer(accum_mode="replicated", loss=mlp.loss_fn, **kw):
    model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                      MLP_PARAMS)
    return ElasticTrainer(loss, model, optim.adam(1e-2),
                          devices=[torch.device("cpu")],
                          accum_mode=accum_mode, **kw)


DictKV = tw.DictKV


def _micro(B=64, V=8):
    x, y = _dataset(B)
    m = B // V
    return [(x[v * m:(v + 1) * m], y[v * m:(v + 1) * m])
            for v in range(V)], (x, y)


# -- the _row_splits contract -------------------------------------------------


class TestRowSplitsContract:
    def test_sizes_match_pure_arithmetic_and_the_reference(self):
        for n, k in [(10, 3), (2048, 16), (7, 7), (100, 1), (5, 8)]:
            arrays = (np.arange(n, dtype=np.float32),)
            splits = _row_splits(arrays, k)
            assert [len(s) for s in splits] == shard_sizes(n, k) \
                == jdata.shard_sizes(n, k)
            for a, b in zip(splits, jdata._row_splits(arrays, k)):
                assert np.array_equal(a, b)

    def test_order_preserving_contiguous_cover(self):
        splits = _row_splits((np.arange(101, dtype=np.float32),), 7)
        assert np.array_equal(np.concatenate(splits), np.arange(101))

    def test_registry_shard_map_invariant_to_world_size(self):
        data = _dataset(300)
        maps = []
        for _world_size in (2, 8):  # the split must not see this
            reg = ShardRegistry()
            ids = reg.register_arrays(data, num_shards=11)
            maps.append({sid: tuple(reg.get(sid)[1].tolist())
                         for sid in ids})
        jreg = jdata.ShardRegistry()
        jids = jreg.register_arrays(data, num_shards=11)
        assert maps[0] == maps[1] == {
            sid: tuple(jreg.get(sid)[1].tolist()) for sid in jids}


# -- RNG lineage --------------------------------------------------------------


class TestRngLineage:
    def test_key_is_pure_function_of_job_identifiers(self):
        a, b = vw_key(SEED, 3, 17, "cpu"), vw_key(SEED, 3, 17, "cpu")
        assert a.initial_seed() == b.initial_seed() == vw_seed(SEED, 3, 17)
        assert torch.equal(torch.randn(8, generator=a),
                           torch.randn(8, generator=b))

    def test_keys_distinct_across_vw_and_step(self):
        seeds = {vw_key(SEED, v, s, "cpu").initial_seed()
                 for v in range(4) for s in range(4)}
        assert len(seeds) == 16
        assert vw_seed(SEED, 1, 2) != vw_seed(SEED, 2, 1)
        assert vw_seed(SEED, 0, 0) != vw_seed(SEED + 1, 0, 0)

    def test_lineage_independent_of_physical_mapping(self):
        keys_a = vw_keys(SEED, 8, 5, "cpu")
        assign_ownership(8, ["pw0", "pw1"])  # a "resize"
        keys_b = vw_keys(SEED, 8, 5, "cpu")
        assert [k.initial_seed() for k in keys_a] == \
            [k.initial_seed() for k in keys_b]


# -- ownership map ------------------------------------------------------------


class TestOwnership:
    def test_assignment_deterministic_and_balanced(self):
        m = assign_ownership(8, ["w1", "w0"])
        assert m == assign_ownership(8, ["w0", "w1"]) \
            == jvirtual.assign_ownership(8, ["w1", "w0"])
        per = {}
        for v, w in m.items():
            per.setdefault(w, []).append(v)
        assert sorted(len(vs) for vs in per.values()) == [4, 4]

    def test_remap_counts_moved_vws(self):
        c0 = get_counters().get("vw_remaps")
        m = OwnershipMap(8, [f"w{i}" for i in range(4)])
        ref = jvirtual.OwnershipMap(8, [f"w{i}" for i in range(4)])
        assert m.remap(["w0", "w1"]) == ref.remap(["w0", "w1"]) == 4
        assert m.mapping == ref.mapping
        assert get_counters().get("vw_remaps") == c0 + 4
        assert m.remap(["w0", "w1"]) == 0

    def test_kv_roundtrip_and_publish_for_delta(self):
        kv = DictKV()
        m = OwnershipMap(8, ["w0", "w1", "w2", "w3"])
        m.publish(kv, job="j")
        assert m.to_json() == jvirtual.OwnershipMap(
            8, ["w0", "w1", "w2", "w3"]).to_json()
        assert OwnershipMap.load(kv, job="j").mapping == m.mapping
        c0 = get_counters().get("vw_remaps")
        m2 = OwnershipMap.publish_for(kv, 8, ["w0", "w1"], job="j")
        assert get_counters().get("vw_remaps") == c0 + 4
        assert OwnershipMap.load(kv, job="j").mapping == m2.mapping

    def test_torn_map_returns_none(self):
        kv = DictKV()
        kv.kv_set("vw-map/j", b"{torn")
        assert OwnershipMap.load(kv, job="j") is None


# -- the deterministic batch stream and its cursors ---------------------------


class TestVirtualBatches:
    def test_stream_equals_the_reference_and_is_reproducible(self):
        reg, ids = _registry()
        a, b = (VirtualBatches(CFG, ids, reg.get) for _ in range(2))
        ref = jvirtual.VirtualBatches(JCFG, ids, reg.get)
        for _ in range(5):
            ma, mb, mr = a.next_step(), b.next_step(), ref.next_step()
            for ta, tb, tr in zip(ma, mb, mr):
                for la, lb, lr in zip(ta, tb, tr):
                    assert np.array_equal(la, lb)
                    assert np.array_equal(la, lr)
            for ia, ir in zip(a.last_step_rows, ref.last_step_rows):
                assert np.array_equal(ia, ir)
        assert a.state() == ref.state()

    def test_cursor_restore_mid_shard_resumes_exactly_once(self):
        reg, ids = _registry(n=320, shards=5)
        cfg = VirtualConfig(vw_count=4, global_batch=16, job_seed=0)
        full = VirtualBatches(cfg, ids, reg.get)
        seen_control = []
        while full.next_step() is not None:
            seen_control.append(np.concatenate(full.last_step_rows))
        crashed = VirtualBatches(cfg, ids, reg.get)
        seen = []
        for _ in range(7):  # cursor 28 rows into a 64-row shard
            crashed.next_step()
            seen.append(np.concatenate(crashed.last_step_rows))
        resumed = VirtualBatches(cfg, ids, reg.get)
        resumed.restore(json.loads(json.dumps(crashed.state())))
        while resumed.next_step() is not None:
            seen.append(np.concatenate(resumed.last_step_rows))
        got = np.sort(np.concatenate(seen))
        assert np.array_equal(got, np.sort(np.concatenate(seen_control)))
        assert len(np.unique(got)) == len(got)

    def test_cursors_for_step_matches_actual_and_the_reference(self):
        reg, ids = _registry()
        vb = VirtualBatches(CFG, ids, reg.get)
        for _ in range(9):
            vb.next_step()
        derived = vb.cursors_for_step(9)
        assert derived["cursors"] == vb.state()["cursors"]
        assert derived["pass"] == vb.state()["pass"]
        assert derived == jvirtual.VirtualBatches(
            JCFG, ids, reg.get).cursors_for_step(9)

    def test_remainder_rows_accounted_deterministically(self):
        reg, ids = _registry(n=300, shards=6)
        cfg = VirtualConfig(vw_count=2, global_batch=16, job_seed=0)
        vb = VirtualBatches(cfg, ids, reg.get)
        n_steps = 0
        while vb.next_step() is not None:
            n_steps += 1
        assert n_steps == vb.total_steps
        assert n_steps * 16 + vb.rows_dropped_remainder == 300

    def test_starved_vw_stream_rejected_loudly(self):
        reg, ids = _registry(n=300, shards=6)
        with pytest.raises(ValueError, match="fewer than one micro-batch"):
            VirtualBatches(VirtualConfig(vw_count=8, global_batch=64,
                                         job_seed=0), ids, reg.get)

    def test_cursor_store_torn_blob_counts_and_falls_back(self):
        kv = DictKV()
        store = CursorStore(kv, job="j")
        store.save({"step": 4, "pass": 0, "cursors": {"0": 8}})
        assert store.load()["step"] == 4
        c0 = get_counters().get("vw_cursor_torn")
        kv.kv_set("vw-cursor/j", b"\xff{torn")
        assert store.load() is None
        assert get_counters().get("vw_cursor_torn") == c0 + 1


# -- accumulation, one process ------------------------------------------------


class TestAccumulation:
    def test_dp_mode_matches_full_batch_step_within_tolerance(self):
        micro, full = _micro()
        tr_a, tr_b = _trainer(accum_mode="dp"), _trainer()
        for _ in range(4):
            assert abs(tr_a.step_accumulate(micro) - tr_b.step(full)) < 1e-5

    def test_abort_mid_accumulation_leaves_state_untouched(self):
        micro, _ = _micro()
        tr = _trainer()
        before = tw.digest(tr)
        with pytest.raises(AccumulationAborted):
            tr.step_accumulate(micro, abort_after=3)
        assert tr.state.step == 0 and tw.digest(tr) == before
        tr.step_accumulate(micro)
        assert tr.state.step == 1

    def test_rng_in_loss_requires_keys(self):
        def noisy_loss(params, batch, key):
            x, y = batch
            return mlp.loss_fn(params, (x + 0.05 * torch.randn(
                x.shape, generator=key), y))

        micro, _ = _micro()
        tr = _trainer(loss=noisy_loss, rng_in_loss=True)
        with pytest.raises(ValueError):
            tr.step_accumulate(micro)
        with pytest.raises(ValueError):
            tr.step_accumulate(micro, rng_keys=vw_keys(SEED, 7, 0, "cpu"))
        with pytest.raises(ValueError):
            tr.step(micro[0])
        losses = [tr.step_accumulate(micro,
                                     rng_keys=vw_keys(SEED, 8, s, "cpu"))
                  for s in range(2)]
        plain = _trainer()
        assert losses != [plain.step_accumulate(micro) for _ in range(2)]

    def test_port_control_within_tolerance_of_the_jax_control(self):
        """The world-1 control (mlp [16, 32, 4], adam 1e-2, 20 steps) of
        both packages from the same init and stream."""
        reg, ids = _registry()
        port = VirtualWorkerLoop(
            _trainer(), CFG, VirtualBatches(CFG, ids, reg.get, passes=2)
        ).run(max_steps=20)
        jtr = JaxTrainer(jmlp.loss_fn, JAX_PARAMS, optax.adam(1e-2),
                         spec=MeshSpec(dp=-1), devices=jax.devices()[:1],
                         accum_mode="replicated")
        ref = jvirtual.VirtualWorkerLoop(
            jtr, JCFG, jvirtual.VirtualBatches(JCFG, ids, reg.get, passes=2)
        ).run(max_steps=20)
        assert len(port.losses) == len(ref.losses) == 20
        np.testing.assert_allclose(port.losses, ref.losses, rtol=0,
                                   atol=CONTROL_ATOL)
        assert port.rows_trained == ref.rows_trained


class TestLoop:
    def test_sdc_plane_is_refused_not_ignored(self):
        reg, ids = _registry()
        with pytest.raises(NotImplementedError, match="item 7"):
            VirtualWorkerLoop(_trainer(), CFG,
                              VirtualBatches(CFG, ids, reg.get),
                              sdc=object())

    def test_loop_stamps_job_seed_and_divergence_gauge(self):
        reg, ids = _registry()
        tr = _trainer()
        VirtualWorkerLoop(tr, CFG, VirtualBatches(CFG, ids, reg.get))
        assert tr.state.job_seed == SEED
        div = loss_divergence([1.0, 2.0], [1.0, 2.5])
        assert div["max_loss_divergence"] == 0.5 and not div["bitwise"]
        assert not trajectories_equivalent([1.0], [1.0, 2.0])
        assert trajectories_equivalent([1.0], [1.004])

    def test_restore_resumes_from_the_step_actually_restored(self,
                                                             tmp_path):
        from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

        reg, ids = _registry()
        ck = ElasticCheckpointer(tmp_path / "ckpt")
        control = VirtualWorkerLoop(
            _trainer(), CFG, VirtualBatches(CFG, ids, reg.get),
            checkpointer=ck, ckpt_every=5).run(max_steps=10)
        real = ck._read

        def read(step, tree_like):
            if step == 10:  # the newest step verifies but will not parse
                raise OSError("injected read failure")
            return real(step, tree_like)

        ck._read = read
        loop = VirtualWorkerLoop(_trainer(), CFG,
                                 VirtualBatches(CFG, ids, reg.get),
                                 checkpointer=ck, ckpt_every=5)
        assert loop.restore_latest() == 5 == ck.last_restored_step
        assert loop.trainer.state.step == 5 == loop.batches.step
        # step 5's cursors with step 5's weights: the control's steps 6-10
        assert loop.run(max_steps=5).losses == control.losses[5:10]
        ck.close()

    def test_flagship_virtual_world_needs_a_store_for_a_world(self):
        with pytest.raises(ValueError, match="store_path"):
            flagship_virtual_world(0, 2, None, device="cpu", cfg=tfm.TINY,
                                   seq=32)

    def test_flagship_virtual_world_builds_the_control_on_the_cpu(self):
        tr, reg, ids, cfg = flagship_virtual_world(0, 1, None, device="cpu",
                                                   cfg=tfm.TINY, seq=32)
        assert (cfg.vw_count, cfg.global_batch, len(ids)) == (8, 16, 16)
        tokens, targets = reg.get(ids[0])
        assert tokens.shape == (16, 32)
        assert np.array_equal(targets, np.roll(tokens, -1, axis=1))
        assert tr.accum_mode == "replicated" and tr.world_size == 1
        assert tr.state.params.cfg.use_flash
        rep = VirtualWorkerLoop(tr, cfg, VirtualBatches(cfg, ids, reg.get)
                                ).run(max_steps=2)
        assert len(rep.losses) == 2 and all(np.isfinite(rep.losses))


# -- the eight-rank world -----------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.run("virtual", 8, tmp_path_factory.mktemp("world8"),
                  WORLD_DEADLINE_S, mlp_params=MLP_PARAMS, data=_dataset(),
                  seed=SEED)


pytestmark = pytest.mark.timeout_s(300)


def test_replicated_mode_bitwise_across_world_sizes(world):
    got = tw.scenario(world, "accum_replicated")
    for rank, g in enumerate(got):
        for n in (2, 4, 8):
            if rank < n:
                assert g[n] == got[0][1]  # BITWISE
            else:
                assert g[n] == [None] * 4


def test_dp_mode_bounded_across_world_sizes(world):
    for a, b in tw.scenario(world, "accum_dp_bounded")[0]:
        assert abs(a - b) < 1e-5


def test_rng_in_loss_is_layout_invariant(world):
    g = tw.scenario(world, "rng_layout")[0]
    assert g[2] == g[8]


def test_resize_4_2_8_matches_unresized_control(world):
    ctrl = tw.scenario(world, "control")[0]
    got = tw.scenario(world, "resize_4_2_8")
    res = got[0]
    div = loss_divergence(ctrl["losses"], res["losses"])
    assert div["steps_compared"] == 20 and div["bitwise"], div
    assert trajectories_equivalent(ctrl["losses"], res["losses"])
    assert res["resizes"] == 2
    assert res["worlds"][0] == 4 and 2 in res["worlds"] \
        and res["worlds"][-1] == 8
    assert res["duplicated"] == 0
    assert len(res["rows"]) == 20 * CFG.global_batch
    assert res["remaps"] > 0
    # rank 0 alone writes the map and the cursors
    assert res["map"] is not None and res["cursor_step"] == 20
    assert all(g["map"] is None and g["cursor_step"] is None
               for g in got[1:])
    # a rank standing by at the end appended no loss, committed no row
    assert len(got[7]["losses"]) < 20


def test_dp_packed_mode_within_documented_tolerance(world):
    g = tw.scenario(world, "dp_packed")[0]
    assert trajectories_equivalent(g["control"], g["resized"])
    assert loss_divergence(g["control"], g["resized"])[
        "max_loss_divergence"] < 1e-3


def test_rng_augmentation_rides_the_lineage(world):
    g = tw.scenario(world, "augmentation")[0]
    assert g["control"] == g["resized"]  # bitwise
    bare = tw.scenario(world, "control")[0]["losses"][:12]
    assert g["control"] != bare  # the augmentation is live


def test_kill_mid_accumulation_restores_exactly_once(world):
    ctrl = tw.scenario(world, "control")[0]
    got = tw.scenario(world, "kill_restore")
    g = got[0]
    # the ranks live at the kill (world 2) are killed; the rest stand by
    assert [r["killed"] for r in got] == [r["live"] for r in got] \
        == [True, True] + [False] * 6
    assert all(r["restored"] == 10 for r in got)
    assert g["stitched"] == ctrl["losses"]  # bitwise, kill and all
    assert sum(g["rows"].values()) == 20 * CFG.global_batch
    assert all(c == 1 for c in g["rows"].values())
    assert g["saved"] == [10, 15, 20]


def test_restore_rejects_drifted_virtual_config(world):
    for g in tw.scenario(world, "drifted_config"):
        assert g["error"] and "different virtual-worker" in g["error"]
        assert g["original"] == 5


def test_ranks_agree_on_the_step_they_restored(world):
    ctrl = tw.scenario(world, "control")[0]
    got = tw.scenario(world, "restore_agreement")
    for g in got:
        # one rank's read of step 10 failed and it fell back to 5 alone
        assert g["one_rank"] and "different checkpoint steps" in g["one_rank"]
        # every rank's failed: all fell back to 5 and resume from there
        assert g["every_rank"] == 5 and g["state_step"] == 5
    assert got[0]["losses"] == ctrl["losses"][5:10]  # bitwise


def test_stall_mid_run_detected_and_invisible_to_loss(world):
    g = tw.scenario(world, "stall")[0]
    assert g["wedged"] and g["stalls"] >= 1
    assert g["control"] == g["resized"]


def test_checkpoint_restore_onto_a_different_world_size(world):
    got = tw.scenario(world, "restore_other_world")
    g = got[0]
    assert abs(g["restored"] - g["loss"]) < 1e-5
    assert g["trained"] < g["restored"]
    assert len({r["digest"] for r in got}) == 1  # every rank restored alike
