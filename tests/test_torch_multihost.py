"""The port's multi-process supervisor (edl_tpu_torch.runtime.multihost and
runtime.discovery) held against the JAX package's: the same membership
events go through both packages' ``ElasticWorld``, ``StragglerTracker`` and
``CoordDiscovery``, each on its own package's ``PyCoordService``, and the
plans (rank, world size, members), eviction lists, ``latest_state`` choices
and KV keys must be equal — apart from the rendezvous, which the JAX
package claims as ``jax-coordinator/<epoch>`` = host:port and the port as
``torch-store/<epoch>`` = a torch ``init_method``.  Also the discovery
cases of tests/test_launcher_discovery.py, the quarantine cases of
tests/test_sdc.py::TestQuarantine (its first and last), and the worker's
tasks: the port's ``MlpTask`` and TINY ``TransformerTask`` from params
converted from the JAX init give the JAX tasks' weighted loss within 1e-5
and gradients within 1e-4 on the same batch.

The kill-and-reform drills with real supervisors are in
tests/test_torch_multihost_drills.py and
tests/test_torch_multihost_joins.py.
"""

from __future__ import annotations

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from edl_tpu.coord.service import PyCoordService as JaxCoord
from edl_tpu.runtime import discovery as jdiscovery
from edl_tpu.runtime import multihost as jmh
from edl_tpu_torch import interop
from edl_tpu_torch.api.types import (RESOURCE_CPU, RESOURCE_GPU,
                                     RESOURCE_MEMORY, ResourceRequirements,
                                     TrainerSpec, TrainingJob,
                                     TrainingJobSpec)
from edl_tpu_torch.cluster.base import PodPhase
from edl_tpu_torch.cluster.fake import FakeCluster
from edl_tpu_torch.coord.gc import JOB_KV_PREFIXES, gc_job_kv
from edl_tpu_torch.coord.service import PyCoordService
from edl_tpu_torch.runtime import multihost as mh
from edl_tpu_torch.runtime import multihost_worker as mw
from edl_tpu_torch.runtime.discovery import (CoordDiscovery,
                                             DiscoveryTimeout, PodDiscovery)
from edl_tpu_torch.runtime.sdc import (clear_quarantine, quarantine_worker,
                                       quarantined_names)

#: the rendezvous key each package claims a world's endpoint under
RENAMED = {"jax-coordinator/": "torch-store/"}


class FakeClock:
    def __init__(self) -> None:
        self.ms = 1_000_000

    def __call__(self) -> int:
        return self.ms


def _keys(svc, rename=None) -> list[str]:
    out = []
    for key in svc.kv_keys(""):
        for old, new in (rename or {}).items():
            if key.startswith(old):
                key = new + key[len(old):]
        out.append(key)
    return sorted(out)


def _plan(p) -> tuple:
    return p.epoch, p.rank, p.world_size, p.members


def _drive(pkg, svc, tmp_path, names=("w0", "w1", "w2")) -> dict:
    """One membership story on one package: a wave of three joins planned
    as one world, a formation barrier two members never reach (the
    straggler tracker evicts them), a member that leaves, generations and
    mid-world generations published and pruned.  Returns what each step
    decided."""
    rec: dict = {}
    worlds = {n: pkg.ElasticWorld(svc, n, settle_s=0.05, poll_s=0.01)
              for n in names}
    for w in worlds.values():
        w.join()
    plans = {}
    for n in names:  # rank 0 claims first; the others find its claim
        plans[n] = worlds[n].plan(timeout_s=10.0)
    rec["plans"] = {n: _plan(p) for n, p in plans.items()}
    epoch = plans["w0"].epoch
    # the formation barrier: only w0 arrives, twice
    clock = iter(range(0, 10_000, 100))
    tracker = pkg.StragglerTracker(worlds["w0"], evict_after=2,
                                   strike_interval_s=0.0,
                                   clock=lambda: float(next(clock)))
    worlds["w0"].mark_formed(epoch)
    rec["first_failure"] = tracker.note_failure(plans["w0"])
    worlds["w0"].mark_formed(epoch)
    rec["second_failure"] = tracker.note_failure(plans["w0"])
    worlds["w0"].mark_formed(epoch)
    rec["evicted"] = sorted(tracker.note_failure(plans["w0"]))
    rec["evicted_names"] = sorted(worlds["w0"].evicted_names())
    rec["members_after_evict"] = svc.members()[1]
    # the evicted worker's fresh incarnation: amnesty, rejoin, replan
    reborn = pkg.ElasticWorld(svc, "w1", settle_s=0.05, poll_s=0.01)
    rec["amnesty"] = reborn.clear_eviction()
    reborn.join()
    with pytest.raises(pkg.WorkerEvicted):
        worlds["w2"].wait_stable(timeout_s=1.0)
    p0 = worlds["w0"].plan(timeout_s=10.0)
    p1 = reborn.plan(timeout_s=10.0)
    rec["replans"] = [_plan(p0), _plan(p1)]
    # generations: a boundary gen, two mids of the next world, a leave
    saves = []

    def saver(tag):
        def save():
            path = str(tmp_path / f"{tag}.npz")
            open(path, "w").close()
            saves.append(tag)
            return path
        return save

    rec["writer"] = [worlds["w0"].publish_state(p0.epoch, saver("gen-a")),
                     reborn.publish_state(p0.epoch, saver("gen-b"))]
    for step in (5, 10, 15):
        worlds["w0"].publish_mid_state(p0.epoch, step,
                                       saver(f"mid-{p0.epoch}-{step}"))
    latest = worlds["w0"].latest_state(p0.epoch + 5)
    rec["latest"] = (latest[0], os.path.basename(latest[1]))
    rec["latest_before"] = worlds["w0"].latest_state(p0.epoch - 1)
    rec["saves"] = saves
    reborn.announce_leave(p1.epoch)
    rec["leave_announced"] = worlds["w0"].leave_announced(p1.epoch)
    reborn.leave()
    worlds["w0"].wait_epoch_past(p1.epoch, timeout_s=5.0)
    rec["after_leave"] = svc.members()
    rec["pruned"] = pkg.prune_generations(svc, str(tmp_path),
                                          p0.epoch + 4, keep=1)
    rec["files"] = sorted(os.listdir(tmp_path))
    return rec


class TestPlanningParity:
    def test_the_same_story_plans_the_same_worlds(self, tmp_path):
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        jsvc, psvc = JaxCoord(), PyCoordService()
        ref = _drive(jmh, jsvc, tmp_path / "jax")
        port = _drive(mh, psvc, tmp_path / "port")
        assert port == ref
        assert ref["evicted"] == ["w1", "w2"]
        assert ref["plans"]["w2"][1:] == (2, 3, ("w0", "w1", "w2"))
        assert _keys(psvc) == _keys(jsvc, RENAMED)

    def test_rendezvous_is_a_file_on_one_host_else_tcp(self, tmp_path):
        svc = PyCoordService()
        a = mh.ElasticWorld(svc, "a", settle_s=0.05, poll_s=0.01,
                            store_dir=str(tmp_path))
        b = mh.ElasticWorld(svc, "b", settle_s=0.05, poll_s=0.01)
        a.join(), b.join()
        pa, pb = a.plan(timeout_s=10), b.plan(timeout_s=10)
        assert pa.coordinator == pb.coordinator
        assert pa.coordinator.startswith(
            f"file://{tmp_path}/store-{pa.epoch}-")
        # a member on another host: the next world's claim is TCP
        svc.join("c", "10.0.0.7")
        c_epoch = svc.epoch()
        assert a._rendezvous(c_epoch).startswith("tcp://127.0.0.1:")
        # a dead world's claim is deleted and a reform claims a new file
        svc.kv_del(f"torch-store/{pa.epoch}")
        again = a._claim_coordinator(pa.epoch, 0, 1.0)
        assert again != pa.coordinator

    def test_prune_sweeps_the_rendezvous_keys_and_files(self, tmp_path):
        svc = PyCoordService()
        for gen in (1, 2, 3, 4):
            svc.kv_set(f"torch-store/{gen}", b"file://x")
            svc.kv_set(f"ckpt/{gen}", b"p")
            (tmp_path / f"store-{gen}-abcd1234").write_text("")
            (tmp_path / f"gen-{gen}.npz").write_text("")
        assert mh.prune_generations(svc, str(tmp_path), 4, keep=2) == 4
        assert svc.kv_keys("torch-store/") == ["torch-store/3",
                                               "torch-store/4"]
        assert sorted(os.listdir(tmp_path)) == [
            "gen-3.npz", "gen-4.npz", "store-3-abcd1234", "store-4-abcd1234"]

    @pytest.mark.timeout_s(180)
    def test_metrics_endpoint_serves_health_and_publishes_its_address(
            self, tmp_path, monkeypatch):
        """A supervisor run in this process (the MLP task, one world
        child on the CPU) with ``metrics_port=0`` answers /healthz 200
        while its world steps, 503 while the world's stall watchdog is
        wedged (its ``world_progress`` check times out), publishes its
        address in the coordinator's KV for the run, and takes it down at
        exit."""
        import functools
        import json
        import urllib.error
        import urllib.request

        from edl_tpu_torch.coord.client import CoordClient
        from edl_tpu_torch.coord.server import spawn_server
        from edl_tpu_torch.observability.scrape import parse_addr_value
        from edl_tpu_torch.runtime import watchdog
        from edl_tpu_torch.runtime.data import ShardRegistry, ensure_seeded

        watchdogs: list = []

        class Recorded(watchdog.StallWatchdog):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                watchdogs.append(self)

        monkeypatch.setattr(watchdog, "StallWatchdog", Recorded)
        monkeypatch.setenv("EDL_MH_STEP_SLEEP", "0.05")
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        handle = spawn_server(member_ttl_ms=3000, task_timeout_ms=5000)
        coord = CoordClient("127.0.0.1", handle.port)
        task = mw.MlpTask()
        registry = ShardRegistry()
        ids = registry.register_arrays(task.make_dataset(), 16)
        ensure_seeded(coord, "w0", lambda beat: registry.enqueue(coord, ids))
        out: dict = {}

        def run():
            try:
                out["outcome"] = mh.run_elastic_worker(
                    coord, "w0",
                    init_state=functools.partial(mw.init_state, task,
                                                 "cpu", "replicated"),
                    train_world=functools.partial(
                        mw.train_world, coord=coord, name="w0",
                        registry=registry, verbose=False, task=task,
                        ckpt_dir=str(tmp_path)),
                    save_state=functools.partial(mw.save_state, name="w0"),
                    load_state=mw.load_state, ckpt_dir=str(tmp_path),
                    settle_s=0.1, warm_spawn=False, stall_floor_s=60.0,
                    metrics_port=0, device="cpu")
            except BaseException as exc:  # surfaced by the assertions
                out["error"] = exc

        def health(port):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        def wait(pred, timeout_s=90.0):
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline and "error" not in out:
                if pred():
                    return True
                time.sleep(0.05)
            return pred()

        th = threading.Thread(target=run, daemon=True)
        th.start()
        try:
            addr_file = tmp_path / "metrics-addr-w0"
            assert wait(addr_file.exists), out
            port = int(addr_file.read_text().rpartition(":")[2])
            # the world steps: its heartbeat file is written every step
            assert wait(lambda: watchdogs and (tmp_path / "hb-w0").exists()
                        and watchdogs[-1]._last_step >= 0), out
            code, doc = health(port)
            assert code == 200, doc
            assert doc["supervisor"] is True and doc["world_progress"] is True
            addr, expired = parse_addr_value(coord.kv_get("metrics-addr-w0"))
            assert addr.endswith(f":{port}") and not expired
            # wedge the live world's watchdog: its verdict cannot be read
            with watchdogs[-1]._lock:
                code, doc = health(port)
            assert code == 503, doc
            assert doc["world_progress"] is False
            assert doc["checks"]["world_progress"]["timed_out"] is True
            assert doc["supervisor"] is True
            assert wait(lambda: health(port)[0] == 200, 30)
        finally:
            th.join(120)
            coord_kv = coord.kv_get("metrics-addr-w0")
            coord.close()
            handle.stop()
        assert "error" not in out, out
        assert out["outcome"].step > 0
        assert coord_kv is None  # deleted at exit

    def test_numpy_tree_round_trips_with_and_without_a_template(
            self, tmp_path):
        tree = {"state": {"['params']['w']": np.arange(6.0).reshape(2, 3),
                          "['params']['b']": np.ones(2, np.float32)},
                "step": np.asarray(7, np.int32)}
        path = mh.save_numpy_tree(tree, str(tmp_path / "gen-1"))
        got = mh.load_numpy_tree(path)
        shaped = mh.load_numpy_tree(path, tree)
        for out in (got, shaped):
            assert int(out["step"]) == 7
            for k, v in tree["state"].items():
                assert np.array_equal(out["state"][k], v)
                assert out["state"][k].dtype == v.dtype
        # the leaves in the JAX package's order and naming (arr_<i>)
        with np.load(path) as z:
            flat = [z[f"arr_{i}"] for i in range(3)]
        assert np.array_equal(flat[0], tree["state"]["['params']['b']"])


# -- tests/test_launcher_discovery.py ----------------------------------------


def _submit(c, name="j1", lo=3, hi=3):
    job = TrainingJob(
        name=name,
        spec=TrainingJobSpec(
            fault_tolerant=True,
            trainer=TrainerSpec(
                min_instance=lo, max_instance=hi,
                resources=ResourceRequirements(
                    requests={RESOURCE_CPU: "1", RESOURCE_MEMORY: "1G"},
                    limits={RESOURCE_GPU: "1"},
                ),
            ),
        ),
    )
    c.create_resources(job)
    c.reconcile()
    return job


def _cluster():
    c = FakeCluster()
    c.add_node("n0", cpu_milli=64000, memory_mega=64000, gpus=8)
    return c


class TestPodDiscovery:
    def test_count_and_wait(self):
        c = _cluster()
        job = _submit(c)
        d = PodDiscovery(c, job.full_name, poll_s=0.0)
        assert d.count_pods_by_phase(PodPhase.RUNNING) == 3
        assert d.wait_pods_running(3, timeout_s=1.0) == 3

    def test_wait_timeout(self):
        c = _cluster()
        job = _submit(c)
        d = PodDiscovery(c, job.full_name, poll_s=0.01)
        with pytest.raises(DiscoveryTimeout):
            d.wait_pods_running(10, timeout_s=0.05)

    def test_rank_from_sorted_names(self):
        c = _cluster()
        job = _submit(c)
        d = PodDiscovery(c, job.full_name, poll_s=0.0)
        addrs = d.fetch_addresses()
        assert addrs == sorted(addrs) and len(addrs) == 3
        assert d.fetch_rank(addrs[1]) == 1
        with pytest.raises(RuntimeError):
            d.fetch_rank("nonexistent")

    def test_terminating_counted(self):
        c = _cluster()
        job = _submit(c)
        pod = c.list_pods(job_uid=job.full_name)[0]
        pod.deletion_timestamp = True
        d = PodDiscovery(c, job.full_name, poll_s=0.0)
        assert d.count_pods_by_phase(PodPhase.TERMINATING) == 1
        assert d.count_pods_by_phase(PodPhase.RUNNING) == 2


@pytest.fixture(params=["jax", "port"])
def disc(request):
    """(CoordDiscovery, PyCoordService) of one package: each case runs on
    both, the reference's side as its own control."""
    if request.param == "jax":
        return jdiscovery.CoordDiscovery, JaxCoord
    return CoordDiscovery, PyCoordService


class TestCoordDiscovery:
    def test_rank_stable_under_rejoin(self, disc):
        Disc, Svc = disc
        svc = Svc()
        a = Disc(svc, "worker-a", "10.0.0.9")
        b = Disc(svc, "worker-b", "10.0.0.1")
        a.join(), b.join()
        assert a.rank_and_world() == (0, 2)
        assert b.rank_and_world() == (1, 2)
        a.leave()
        a2 = Disc(svc, "worker-a", "10.0.0.200")
        a2.join()
        assert a2.rank_and_world() == (0, 2)

    def test_epoch_bumps_on_membership_change(self, disc):
        Disc, Svc = disc
        svc = Svc()
        a = Disc(svc, "a")
        e0 = a.join()
        b = Disc(svc, "b")
        e1 = b.join()
        assert e1 > e0
        b.leave()
        assert a.epoch() > e1

    def test_wait_members(self, disc):
        Disc, Svc = disc
        svc = Svc()
        a = Disc(svc, "a")
        a.join()

        def late_join():
            time.sleep(0.05)
            Disc(svc, "b").join()

        t = threading.Thread(target=late_join)
        t.start()
        peers = a.wait_members(2, timeout_s=2.0, poll_s=0.01)
        t.join()
        assert [n for n, _ in peers] == ["a", "b"]

    def test_rank_requires_join(self, disc):
        Disc, Svc = disc
        d = Disc(Svc(), "ghost")
        with pytest.raises(RuntimeError):
            d.rank_and_world()

    def test_keepalive_outlives_member_ttl(self, disc):
        Disc, Svc = disc
        now = [0]
        svc = Svc(member_ttl_ms=100, clock=lambda: now[0])
        a = Disc(svc, "a")
        epoch_after_join = a.join()
        with a.keepalive(interval_s=0.002):
            for _ in range(10):  # 6 TTLs of fake time in total
                now[0] += 60
                time.sleep(0.05)  # ≥ ~20 beats refresh at the new time
                assert [n for n, _ in a.peers()] == ["a"]
            assert a.epoch() == epoch_after_join
        a.leave()

    def test_no_keepalive_expires_after_ttl(self, disc):
        Disc, Svc = disc
        now = [0]
        svc = Svc(member_ttl_ms=100, clock=lambda: now[0])
        a = Disc(svc, "a")
        a.join()
        now[0] += 150
        assert a.peers() == []

    def test_keepalive_declines_a_quarantined_rejoin(self, disc):
        """The marker overrules the expiry-rejoin (both packages)."""
        Disc, Svc = disc
        now = [0]
        svc = Svc(member_ttl_ms=100, clock=lambda: now[0])
        a = Disc(svc, "a")
        a.join()
        svc.kv_set("sdc-quarantine/a", b"sdc:test")
        with a.keepalive(interval_s=0.05):
            now[0] += 150
            svc.expire_members()  # expired: the beat fails, no rejoin
            deadline = time.monotonic() + 5
            while not a.evicted and time.monotonic() < deadline:
                time.sleep(0.01)
        assert a.evicted and a.peers() == []


# -- tests/test_sdc.py::TestQuarantine, first and last -----------------------


class TestQuarantine:
    def test_marker_declines_rejoin_and_amnesty_lifts_it(self):
        coord = PyCoordService()
        healthy = mh.ElasticWorld(coord, "w0")
        healthy.join()
        assert quarantine_worker(coord, "w1", reason="sdc step 9")
        assert "w1" in quarantined_names(coord)
        # membership machinery sees it exactly like an eviction
        assert "w1" in healthy.evicted_names()
        # the fresh incarnation's first act lifts its own marker
        reborn = mh.ElasticWorld(coord, "w1", settle_s=0.05, poll_s=0.01)
        assert reborn.clear_eviction() is True
        assert "w1" not in quarantined_names(coord)
        reborn.join()
        _, names = reborn.wait_stable(min_members=2, timeout_s=5.0)
        assert "w1" in names

    def test_a_quarantined_worker_never_enters_a_plan(self):
        coord = PyCoordService()
        a = mh.ElasticWorld(coord, "a", settle_s=0.05, poll_s=0.01)
        b = mh.ElasticWorld(coord, "b", settle_s=0.05, poll_s=0.01)
        a.join(), b.join()
        quarantine_worker(coord, "b")
        assert a.plan(timeout_s=5.0).members == ("a",)
        with pytest.raises(mh.WorkerEvicted):
            b.plan(timeout_s=1.0)
        assert clear_quarantine(coord, "b") is True
        assert clear_quarantine(coord, "b") is False

    def test_fp_keys_are_job_swept_markers_are_not(self):
        assert "sdc-fp/" in JOB_KV_PREFIXES
        kv = PyCoordService()
        kv.kv_set("sdc-fp/j/5/w0", b"x")
        quarantine_worker(kv, "w0")
        assert gc_job_kv(kv, "j") == 1
        assert kv.kv_get("sdc-fp/j/5/w0") is None
        assert "w0" in quarantined_names(kv)  # per-worker: survives the job

    def test_job_kv_prefixes_are_the_references(self):
        from edl_tpu.coord.gc import JOB_KV_PREFIXES as JAX_PREFIXES

        assert JOB_KV_PREFIXES == JAX_PREFIXES


# -- the worker's tasks against the JAX package's -----------------------------


def _jax_worker():
    from edl_tpu.runtime import multihost_worker as jmw

    return jmw


def _batch(task, n=8):
    x, y = task.make_dataset()
    w = np.ones((n,), np.float32)
    w[-3:] = 0.0  # a partly filled local batch
    return x[:n], y[:n], w


def _grads_close(port_grads: dict, jax_grads: dict, paths: dict) -> None:
    for name, g in port_grads.items():
        ref = np.asarray(paths[name](jax_grads))
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4, err_msg=name)


class TestTaskParity:
    def test_mlp_task_loss_and_grads(self):
        jmw = _jax_worker()
        jtask, task = jmw.MlpTask(), mw.MlpTask()
        jparams = jtask.init_params(jax.random.key(0))
        model = task.build(torch.device("cpu"))
        interop.params_from_numpy(model, jax.tree.map(np.asarray, jparams))
        x, y, w = _batch(task)
        jloss, jgrads = jax.value_and_grad(jtask.weighted_loss)(
            jparams, x, y, w)
        loss = task.weighted_loss(model, tuple(torch.from_numpy(a)
                                               for a in (x, y, w)))
        loss.backward()
        assert abs(loss.item() - float(jloss)) <= 1e-5
        _grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                     jgrads, {n: (lambda g, n=n: g[n])
                              for n in ("w1", "b1", "w2", "b2")})
        # the datasets are the JAX task's, row for row
        for a, b in zip(task.make_dataset(), jtask.make_dataset()):
            assert np.array_equal(a, b)

    def test_tiny_transformer_task_loss_and_grads(self):
        jmw = _jax_worker()
        jtask = jmw.TransformerTask(config_name="tiny", seq=16)
        task = mw.TransformerTask(config_name="tiny", seq=16)
        jparams = jtask.init_params(jax.random.key(0))
        model = task.build(torch.device("cpu"))
        interop.params_from_numpy(model, jax.tree.map(np.asarray, jparams))
        x, y, w = _batch(task, n=4)
        jloss, jgrads = jax.value_and_grad(jtask.weighted_loss)(
            jparams, x, y, w)
        loss = task.weighted_loss(model, tuple(torch.from_numpy(a)
                                               for a in (x, y, w)))
        loss.backward()
        assert abs(loss.item() - float(jloss)) <= 1e-5
        flat = {interop.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(jgrads)[0]
                for p in [tuple(getattr(k, "key", getattr(k, "idx", k))
                                for k in p)]}
        for name, p in model.named_parameters():
            from edl_tpu_torch.runtime.checkpoint import param_path

            ref = flat[interop.keystr(param_path(name))]
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-4, err_msg=name)
        for a, b in zip(task.make_dataset(), jtask.make_dataset()):
            assert np.array_equal(a, b)

    def test_a_world_of_one_trains_and_restores_its_host_state(self):
        """The worker's replicated path on a world of one (no process
        group): a host state round-trips through a trainer bitwise, and
        its digest is the trainer's."""
        task = mw.TransformerTask(config_name="tiny", seq=16)
        dev = torch.device("cpu")
        trainer = mw.build_trainer(task, dev)
        x, y, w = _batch(task, n=4)
        loss = trainer.step(tuple(torch.from_numpy(a) for a in (x, y, w)))
        assert np.isfinite(loss)
        state = mw.host_state(trainer, 1)
        assert any("exp_avg" in k for k in state["state"])
        other = mw.build_trainer(task, dev)
        other.load_whole_state({k: torch.as_tensor(v)
                                for k, v in state["state"].items()})
        again = mw.host_state(other, 1)["state"]
        assert all(np.array_equal(again[k], v)
                   for k, v in state["state"].items())
        assert mw._trainer_digest(other) == mw.params_digest(state["state"])
        cold = mw.init_state(task, "cpu")
        assert mw.params_digest(cold["state"]) != mw.params_digest(
            state["state"])
