"""The port's ElasticCheckpointer (DCP steps, integrity manifests, the
async pipeline) against the JAX package's: the scenarios of
tests/test_checkpoint_async.py, the corruption fallbacks of
tests/test_runtime.py, the verified-lineage manifests of tests/test_sdc.py,
and TestCheckpointMeta of tests/test_accuracy_elasticity.py, on the same
trees; a manifest's keys and its ``leaves`` for ``['params']…`` equal a JAX
checkpointer's for the same weights; and a trainer's module and optimizer
restore in place, bitwise."""

import json
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import mlp as jmlp
from edl_tpu.runtime.checkpoint import ElasticCheckpointer as JaxCheckpointer
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.checkpoint import (CheckpointCorruption,
                                              ElasticCheckpointer)
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.sdc import tree_fingerprint, tree_leaf_folds

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def tree(step: int):
    return {"w": np.arange(64, dtype=np.float32) * (step + 1),
            "b": np.ones((8,), np.float32) * step,
            "step": np.asarray(step, np.int32)[None]}


def _trainer(seed=0):
    return ElasticTrainer(mlp.loss_fn, mlp.MLP([16, 32, 4], device="cpu",
                                               seed=seed),
                          optim.adam(1e-2), devices=[torch.device("cpu")])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(32, 16)).astype(np.float32),
            rng.integers(0, 4, 32))


# -- the async pipeline (tests/test_checkpoint_async.py) ---------------------


def test_save_async_writes_manifest_and_verifies(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    assert ck.save_async(1, tree(1)) >= 0.0
    ck.finalize()
    assert ck.latest_verified_step() == 1
    manifest = json.loads((tmp_path / ".integrity" / "1.json").read_text())
    assert manifest["files"], "async save finalized an empty manifest"
    assert float(ck.restore(tree(0))["w"][1]) == 2.0
    ck.close()


def test_wait_false_manifest_written_at_finalize(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save(3, tree(3), wait=False)
    ck.finalize()
    assert (tmp_path / ".integrity" / "3.json").exists()
    assert ck.latest_verified_step() == 3
    ck.close()


def test_crash_between_persist_and_finalize(tmp_path):
    """The files land, the manifest never does: the step restores with the
    pre-manifest semantics; torn as well, restore falls back past it."""
    ck = ElasticCheckpointer(tmp_path)
    ck.save(1, tree(1), wait=True)
    ck.save(2, tree(2), wait=False)
    ck.wait_pending()  # the write lands; finalize never runs
    assert not (tmp_path / ".integrity" / "2.json").exists()
    del ck

    fresh = ElasticCheckpointer(tmp_path)
    assert fresh.latest_verified_step() == 2
    assert int(fresh.restore(tree(0))["step"][0]) == 2
    fresh.close()

    victims = [p for p in (tmp_path / "2").rglob("*") if p.is_file()
               and p.stat().st_size > 0]
    assert victims
    for p in victims:
        p.write_bytes(p.read_bytes()[: max(p.stat().st_size // 2, 1)])
    again = ElasticCheckpointer(tmp_path)
    assert int(again.restore(tree(0))["step"][0]) == 1
    again.close()


def test_backpressure_bounds_pipeline_to_one(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    big = {"w": np.zeros((512, 512), np.float32)}
    p1 = ck.save_async(1, big)
    p2 = ck.save_async(2, big)  # must drain save 1 first
    ck.finalize()
    assert ck._inflight is None
    assert sorted(s for s in (1, 2) if ck.verify(s)) == [1, 2]
    assert ck.latest_verified_step() == 2
    assert ck.async_pauses_s == [p1, p2]
    ck.close()


def test_async_pause_is_fraction_of_sync_save(tmp_path):
    """32 MB, so that the persist (write, fsync, folds, CRC32) outweighs the
    pause's host copy by more than a loaded machine's scheduling noise."""
    ck = ElasticCheckpointer(tmp_path)
    big = {"w": np.zeros((1024, 4096), np.float32),
           "v": np.zeros((1024, 4096), np.float32)}
    t0 = time.monotonic()
    ck.save(1, big, wait=True)
    sync_s = time.monotonic() - t0
    time.sleep(0.05)
    pause = ck.save_async(2, big)
    ck.finalize()
    assert pause < max(sync_s * 0.5, 0.05), (pause, sync_s)
    ck.close()


def test_skip_if_busy_drops_tick_instead_of_blocking(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    release = threading.Event()
    real_persist = ck._persist

    def slow_persist(step, tree, wait, best_effort):
        release.wait(timeout=10)
        return real_persist(step, tree, wait=wait, best_effort=best_effort)

    ck._persist = slow_persist
    before = get_counters().get("checkpoint_async_skipped")
    ck.save_async(1, tree(1))
    t0 = time.monotonic()
    pause = ck.save_async(2, tree(2), skip_if_busy=True)
    assert time.monotonic() - t0 < 0.5, "skip_if_busy blocked"
    assert pause < 0.5
    assert get_counters().get("checkpoint_async_skipped") == before + 1
    release.set()
    ck._persist = real_persist
    ck.wait_pending()
    assert ck.save_async(3, tree(3), skip_if_busy=True) is not None
    ck.finalize()
    assert ck.latest_verified_step() == 3
    assert 2 not in ck._all_steps()
    ck.close()


def test_async_error_surfaces_at_next_sync_point(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.inject_save_failures(1)
    ck.save_async(1, tree(1), best_effort=False)
    with pytest.raises(OSError):
        ck.wait_pending()
    assert ck.save(2, tree(2), wait=True)
    assert ck.latest_verified_step() == 2
    ck.close()


def test_async_best_effort_enospc_counts_and_recovers(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    before = get_counters().get("checkpoint_save_failures")
    ck.inject_save_failures(1)
    ck.save_async(1, tree(1), best_effort=True)
    ck.wait_pending()
    assert get_counters().get("checkpoint_save_failures") == before + 1
    rec_before = get_counters().get("recoveries_completed", type="disk_full")
    ck.save_async(2, tree(2), best_effort=True)
    ck.finalize()
    assert get_counters().get("recoveries_completed",
                              type="disk_full") == rec_before + 1
    assert ck.latest_verified_step() == 2
    ck.close()


def test_close_finalizes_pending_async_saves(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save_async(5, tree(5))
    ck.close()
    assert ElasticCheckpointer(tmp_path).latest_verified_step() == 5


def test_saves_never_overlap(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save_async(1, tree(1))
    assert ck.save(2, tree(2), wait=True)
    assert ck._inflight is None
    assert ck.latest_verified_step() == 2
    assert ck.verify(1)
    ck.close()


def test_restore_drains_inflight_persist(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save_async(1, tree(1))
    assert int(ck.restore(tree(0))["step"][0]) == 1
    ck.close()


def test_later_sync_save_races_persist_thread_ordering_pinned(tmp_path):
    entered, release = threading.Event(), threading.Event()

    class SlowPersist(ElasticCheckpointer):
        def _persist(self, step, tree_, wait, best_effort, meta=None):
            if step == 5:
                entered.set()
                assert release.wait(10), "test deadlock"
            return super()._persist(step, tree_, wait=wait,
                                    best_effort=best_effort, meta=meta)

    ck = SlowPersist(tmp_path)
    ck.save_async(5, tree(5), meta={"cursor": "c5"})
    assert entered.wait(10)
    done = []
    racer = threading.Thread(target=lambda: done.append(
        ck.save(6, tree(6), wait=True, meta={"cursor": "c6"})))
    racer.start()
    time.sleep(0.2)
    assert done == []
    assert not (tmp_path / ".integrity" / "6.json").exists()
    assert not (tmp_path / ".integrity" / "5.json").exists()
    release.set()
    racer.join(30)
    assert done == [True]
    for step, cursor in ((5, "c5"), (6, "c6")):
        manifest = json.loads(
            (tmp_path / ".integrity" / f"{step}.json").read_text())
        assert manifest["verified"] is True and manifest["tree_hash"]
        assert ck.load_meta(step)["cursor"] == cursor
    assert ck.latest_verified_step() == 6
    ck.finalize()
    assert ck.manifest_verified(5) is True and ck.manifest_verified(6) is True
    assert int(ck.restore(tree(0), step=6)["step"][0]) == 6
    assert ck.last_restore_hash_ok is True
    ck.close()


# -- corruption fallbacks (tests/test_runtime.py) ----------------------------


def _ckpt_with_steps(tmp_path, steps=(1, 2, 3)):
    ck = ElasticCheckpointer(tmp_path / "ickpt", max_to_keep=len(steps) + 1)
    for s in steps:
        ck.save(s, {"w": np.full(16, float(s), np.float32),
                    "step": np.asarray(s, np.int32)})
    return ck


def _largest_file(ck, step):
    files = [p for p in ck._step_dir(step).rglob("*") if p.is_file()]
    return max(files, key=lambda p: (p.stat().st_size, str(p)))


def _like():
    return {"w": np.zeros(16, np.float32), "step": np.asarray(0, np.int32)}


def test_restore_falls_back_on_flipped_bytes(tmp_path):
    ck = _ckpt_with_steps(tmp_path)
    victim = _largest_file(ck, 3)
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    assert not ck.verify(3)
    assert ck.latest_verified_step() == 2
    counters = get_counters()
    before = (counters.get("recoveries_completed", type="corrupt_checkpoint"),
              counters.get("checkpoint_corruption_detected"))
    out = ck.restore(_like())
    assert int(out["step"]) == 2 and float(out["w"][0]) == 2.0
    assert ck.last_restored_step == 2
    assert counters.get("recoveries_completed",
                        type="corrupt_checkpoint") == before[0] + 1
    assert counters.get("checkpoint_corruption_detected") == before[1] + 1
    ck.close()


def test_restore_falls_back_on_truncated_file(tmp_path):
    ck = _ckpt_with_steps(tmp_path)
    victim = _largest_file(ck, 3)
    victim.write_bytes(victim.read_bytes()[: victim.stat().st_size // 2])
    assert not ck.verify(3)
    assert int(ck.restore(_like())["step"]) == 2
    ck.close()


def test_restore_explicit_step_also_falls_back(tmp_path):
    ck = _ckpt_with_steps(tmp_path)
    _largest_file(ck, 2).write_bytes(b"")
    assert int(ck.restore(_like(), step=2)["step"]) == 1
    with pytest.raises(FileNotFoundError):
        ck.restore(_like(), step=7)  # not in the store
    ck.close()


def test_restore_raises_when_every_step_corrupt(tmp_path):
    ck = _ckpt_with_steps(tmp_path, steps=(1, 2))
    for s in (1, 2):
        _largest_file(ck, s).write_bytes(b"garbage")
    with pytest.raises(CheckpointCorruption):
        ck.restore(_like())
    ck.close()


def test_disk_full_save_degrades_and_recovers(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "dfull")
    t = {"w": np.ones(4, np.float32)}
    assert ck.save(1, t)
    ck.inject_save_failures(2)
    before = get_counters().get("recoveries_completed", type="disk_full")
    assert ck.save(2, t, best_effort=True) is False
    assert ck.save(3, t, best_effort=True) is False
    ck.inject_save_failures(1)
    with pytest.raises(OSError):
        ck.save(4, t)
    assert ck.save(5, t, best_effort=True) is True
    assert get_counters().get("recoveries_completed",
                              type="disk_full") == before + 1
    assert ck._all_steps() == [1, 5]
    assert float(ck.restore({"w": np.zeros(4, np.float32)})["w"][0]) == 1.0
    ck.close()


# -- verified lineage (tests/test_sdc.py) ------------------------------------


def _vtree(step):
    return {"w": np.arange(64, dtype=np.float32) * (step + 1),
            "b": np.ones((8,), np.float32) * step}


def _flip(a: np.ndarray, bit: int) -> np.ndarray:
    out = a.copy()
    out.view(np.uint8)[bit // 8] ^= np.uint8(1 << (bit % 8))
    return out


def test_sync_save_writes_verified_manifest(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck")
    ck.save(1, _vtree(1))
    m = ck.manifest(1)
    assert m["version"] == 3 and m["verified"] is True
    assert m["tree_hash"] == tree_fingerprint(_vtree(1))
    assert set(m["leaves"]) == set(tree_leaf_folds(_vtree(1)))
    assert ck.manifest_verified(1) is True
    ck.close()


def test_async_save_verifies_at_finalize(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck")
    ck.save_async(2, _vtree(2))
    ck.finalize()
    assert ck.manifest_verified(2) is True
    assert ck.manifest(2)["tree_hash"] == tree_fingerprint(_vtree(2))
    ck.close()


def test_forged_manifest_reads_unverified(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck")
    ck.save(1, _vtree(1))
    mpath = ck._manifest_path(1)
    m = json.loads(mpath.read_text())
    del m["verified"]
    mpath.write_text(json.dumps(m))
    assert ck.manifest_verified(1) is False
    assert ck.manifest_verified(9) is None
    ck.close()


def test_verify_restored_spot_checks_shared_leaves(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck")
    ck.save(1, _vtree(1))
    good = ck.restore(_vtree(0), step=1)
    assert ck.verify_restored(1, good) is True
    assert ck.last_restore_hash_ok is True
    bad = dict(good, w=_flip(good["w"], 9))
    assert ck.verify_restored(1, bad) is False
    assert ck.verify_restored(1, {"b": good["b"]}) is True
    assert ck.verify_restored(1, {"zzz": good["b"]}) is None
    ck.close()


def test_restore_falls_back_past_hash_forged_step(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck", max_to_keep=4)
    ck.save(1, _vtree(1))
    ck.save(2, _vtree(2))
    mpath = ck._manifest_path(2)
    m = json.loads(mpath.read_text())
    m["leaves"][sorted(m["leaves"])[0]] = f"{0:016x}"  # lie about one leaf
    mpath.write_text(json.dumps(m))
    before = get_counters().get("checkpoint_tree_hash_mismatch")
    restored = ck.restore(_vtree(0))
    assert np.array_equal(restored["w"], _vtree(1)["w"])
    assert ck.last_restored_step == 1
    assert get_counters().get("checkpoint_tree_hash_mismatch") == before + 1
    ck.close()


# -- training meta (TestCheckpointMeta) --------------------------------------

META = {"cursor": {"version": 1, "step": 6, "pass": 0,
                   "cursors": {"0": 48, "1": 48}},
        "rng": {"job_seed": 3, "vw_count": 8}}


def test_sync_save_meta_roundtrip_versioned(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save(6, {"w": np.ones((4,), np.float32)}, meta=META)
    assert ck.load_meta(6) == META
    manifest = json.loads((tmp_path / ".integrity" / "6.json").read_text())
    assert manifest["version"] == 3 and manifest["meta"] is not None
    assert ck.verify(6)
    ck.close()


def test_async_save_meta_lands_at_finalize(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save_async(3, {"w": np.ones((4,), np.float32)}, meta=META)
    ck.finalize()
    assert ck.load_meta(3) == META
    ck.close()


def test_torn_meta_counts_and_returns_none_but_step_restores(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    t = {"w": np.arange(4, dtype=np.float32)}
    ck.save(6, t, meta=META)
    mpath = tmp_path / ".integrity" / "6.meta.json"
    mpath.write_bytes(mpath.read_bytes()[:11])
    c0 = get_counters().get("checkpoint_meta_torn")
    assert ck.load_meta(6) is None
    assert get_counters().get("checkpoint_meta_torn") == c0 + 1
    restored = ck.restore({"w": np.zeros((4,), np.float32)})
    assert np.array_equal(restored["w"], t["w"])
    ck.close()


def test_meta_fingerprint_mismatch_detected(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save(2, {"w": np.ones((2,), np.float32)}, meta=META)
    (tmp_path / ".integrity" / "2.meta.json").write_text(json.dumps(
        {"step": 2, "meta": {"cursor": "forged"}}))
    assert ck.load_meta(2) is None
    ck.close()


@pytest.mark.parametrize("version", [1, 2])
def test_old_manifest_still_verifies_and_restores(tmp_path, version):
    """v1 ({step, files}) and v2 (+ version, meta) manifests keep
    restoring; they just cannot claim the verified bit."""
    ck = ElasticCheckpointer(tmp_path)
    t = {"w": np.ones((3,), np.float32)}
    ck.save(1, t)
    mp = tmp_path / ".integrity" / "1.json"
    doc = json.loads(mp.read_text())
    old = {"step": 1, "files": doc["files"]}
    if version == 2:
        old.update(version=2, meta=None)
    mp.write_text(json.dumps(old))
    assert ck.verify(1)
    assert ck.load_meta(1) is None
    assert ck.manifest_verified(1) is False
    assert np.array_equal(ck.restore({"w": np.zeros((3,), np.float32)})["w"],
                          t["w"])
    assert ck.last_restore_hash_ok is None
    ck.close()


def test_metaless_resave_drops_stale_sidecar(tmp_path):
    ck = ElasticCheckpointer(tmp_path)
    ck.save(4, {"w": np.ones((2,), np.float32)}, meta=META)
    assert ck.load_meta(4) == META
    ck.save(4, {"w": np.full((2,), 2.0, np.float32)})
    assert not (tmp_path / ".integrity" / "4.meta.json").exists()
    assert ck.load_meta(4) is None
    assert float(ck.restore({"w": np.zeros(2, np.float32)})["w"][0]) == 2.0
    ck.close()


def test_meta_pruned_with_its_step(tmp_path):
    ck = ElasticCheckpointer(tmp_path, max_to_keep=1)
    for s in (1, 2):
        ck.save(s, {"w": np.full((2,), float(s), np.float32)}, meta=META)
    names = {p.name for p in (tmp_path / ".integrity").glob("*.json")}
    assert "2.json" in names and "2.meta.json" in names
    assert "1.json" not in names and "1.meta.json" not in names
    assert ck._all_steps() == [2]
    ck.close()


# -- the trainer's tree, against the JAX package -----------------------------


def test_manifest_matches_the_jax_checkpointers_for_the_same_weights(
        tmp_path):
    jparams = jmlp.init(jax.random.key(0), [16, 32, 4])
    jtree = {"params": jparams, "opt": optax.adam(1e-2).init(jparams)}
    jck = JaxCheckpointer(tmp_path / "jax")
    jck.save(1, jtree)
    want = jck.manifest(1)
    jck.close()
    t = _trainer()
    interop.params_from_numpy(t.state.params,
                              jax.tree.map(np.asarray, jparams))
    ck = ElasticCheckpointer(tmp_path / "port")
    ck.save(1, {"params": t.state.params, "opt": t.state.opt_state})
    got = ck.manifest(1)
    assert set(got) == set(want)
    params = {p: f for p, f in want["leaves"].items()
              if p.startswith("['params']")}
    assert params and {p: f for p, f in got["leaves"].items()
                       if p.startswith("['params']")} == params
    ck.close()


def test_trainer_state_restores_in_place_bitwise(tmp_path):
    """A fresh trainer's module and optimizer (which has no state yet)
    take the saved step in place; both then train identically."""
    a = _trainer()
    for i in range(3):
        a.step(_batch(i))
    ck = ElasticCheckpointer(tmp_path)
    ck.save(a.state.step, {"params": a.state.params,
                           "opt": a.state.opt_state})
    leaves = ck.manifest(3)["leaves"]
    assert "['opt']['w0']['exp_avg']" in leaves
    assert "['opt']['b1']['step']" in leaves
    b = _trainer(seed=7)
    params, opt = b.state.params, b.state.opt_state
    own = [p for p in params.parameters()]
    out = ck.restore({"params": params, "opt": opt})
    assert out["params"] is params and out["opt"] is opt
    assert [p for p in params.parameters()] == own  # the same tensors
    assert ck.last_restore_hash_ok is True
    for p, q in zip(a.state.params.parameters(), params.parameters()):
        assert torch.equal(p, q)
        for k, v in a.state.opt_state.state[p].items():
            assert torch.equal(v, opt.state[q][k]), k
            assert v.device == opt.state[q][k].device
    for i in range(3, 5):
        assert a.step(_batch(i)) == b.step(_batch(i))
    ck.close()


def test_open_clears_dead_writers_temp_dirs_only(tmp_path):
    """A save torn by a crash leaves ``.tmp-<step>-<pid>``; opening the
    store clears it, but never a live writer's (another rank's save)."""
    import os
    import subprocess
    import sys

    gone = subprocess.run([sys.executable, "-c", "import os; "
                           "print(os.getpid())"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dead = tmp_path / f".tmp-4-{gone}"
    live = tmp_path / f".tmp-5-{os.getpid()}"
    for d in (dead, live):
        d.mkdir()
        (d / "__0_0.distcp").write_bytes(b"half")
    ElasticCheckpointer(tmp_path)
    assert not dead.exists() and live.exists()


def test_save_async_snapshot_is_a_copy_of_the_live_state(tmp_path):
    """The step loop updates parameters and Adam's moments in place while
    the persist runs: what lands is the state at the save_async call,
    not a later step's."""
    release = threading.Event()

    class SlowPersist(ElasticCheckpointer):
        def _persist(self, step, tree_, wait, best_effort, meta=None):
            assert release.wait(10), "test deadlock"
            return super()._persist(step, tree_, wait=wait,
                                    best_effort=best_effort, meta=meta)

    a = _trainer()
    a.step(_batch(0))
    want = {n: p.detach().clone() for n, p in
            a.state.params.named_parameters()}
    moments = {n: a.state.opt_state.state[p]["exp_avg"].clone() for n, p in
               a.state.params.named_parameters()}
    ck = SlowPersist(tmp_path)
    ck.save_async(1, {"params": a.state.params, "opt": a.state.opt_state})
    for i in range(1, 3):  # in-place updates while the persist waits
        a.step(_batch(i))
    release.set()
    ck.finalize()
    b = _trainer(seed=9)
    ck.restore({"params": b.state.params, "opt": b.state.opt_state})
    for n, p in b.state.params.named_parameters():
        assert torch.equal(p, want[n]), n
        assert torch.equal(b.state.opt_state.state[p]["exp_avg"],
                           moments[n]), n
    ck.close()
