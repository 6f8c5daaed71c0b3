"""The port's single-shot serving plane (edl_tpu_torch.runtime.serving:
ElasticServer, ServingReplica, ServingFleet, PoissonTraffic) on the CPU:
tests/test_serving.py's scenarios from ElasticServer parity to the
generation published to the coordinator, on the MLP [16, 32, 4] holding
the JAX init (carried by interop), every answer held to the JAX package's
``mlp.apply`` on the same rows within 1e-5 (fp32).

Beyond the reference's list: ``ElasticServer.resize(2)`` on a spawned gloo
world of 2 (tests/torch_world.py, ``suite_serving``), replicated and fsdp,
which the reference's test skips off a multi-device host; PoissonTraffic's
arrival offsets on a fake clock, equal to the reference's from one seed;
and ``entry.flagship_scoring_fleet``'s closure at TINY served by the port's
fleet and by the JAX package's ``ServingFleet`` alike."""

from __future__ import annotations

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.models import transformer as jtfm
from edl_tpu.runtime import serving as jserving
from edl_tpu_torch import entry, interop
from edl_tpu_torch.coord import PyCoordService
from edl_tpu_torch.models import mlp
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime import serving
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.serving import (
    ElasticServer,
    PoissonTraffic,
    RequestDropped,
    ServeRequest,
    ServingFleet,
    ServingReplica,
)
from tests.torch_decode_ref import PARAMS as TINY_PARAMS
from tests.torch_decode_ref import port_model

#: fp32 forwards of the two packages on the same rows: 1e-5 absolute and
#: relative (np.allclose's rule; the doubled and shifted generations reach
#: |out| ~250, where one fp32 ulp is 1.5e-5)
ATOL = 1e-5
SIZES = [16, 32, 4]
PARAMS = jmlp.init(jax.random.key(0), SIZES)
fleet_test = pytest.mark.timeout_s(120)


def tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def module(params=PARAMS) -> mlp.MLP:
    """The port's MLP on the CPU holding the JAX ``params``."""
    return interop.params_from_numpy(mlp.MLP(SIZES, device="cpu"),
                                     tree(params))


def apply_fn(model, batch):
    return mlp.apply(model, batch[0])


def make_fleet(job="t/svc", params=PARAMS, **kw) -> ServingFleet:
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_queue_ms", 1.0)
    kw.setdefault("drain_timeout_s", 5.0)
    return ServingFleet(apply_fn, module(params),
                        example_row=(np.zeros((16,), np.float32),),
                        job=job, device="cpu", **kw)


def row(i: int) -> tuple:
    return (np.full((16,), i % 7, np.float32),)


def expected(x_row: np.ndarray, params=PARAMS) -> np.ndarray:
    """The JAX package's answer for one row."""
    return np.asarray(jmlp.apply(params, x_row[None, :]))[0]


def close(got, want) -> bool:
    return np.allclose(np.asarray(got), want, atol=ATOL, rtol=ATOL)


def shifted(params, fn):
    return jax.tree.map(fn, params)


# ---------------------------------------------------------- ElasticServer


def test_elastic_server_forward_parity_and_reload():
    srv = ElasticServer(apply_fn, module(), devices=[torch.device("cpu")])
    batch = (np.random.default_rng(0).normal(size=(8, 16))
             .astype(np.float32),)
    srv.warmup(batch)
    out = srv.serve(batch)
    assert close(out, np.asarray(jmlp.apply(PARAMS, batch[0])))
    # weight swap: outputs flip to the new generation's
    p2 = shifted(PARAMS, lambda a: a + 1.0)
    srv.load_params(module(p2))
    assert close(srv.serve(batch), np.asarray(jmlp.apply(p2, batch[0])))
    # the host copy is the live weights, detached from the device's
    host = srv.params_host()
    for name, p in host.named_parameters():
        assert np.array_equal(p.detach().numpy(), np.asarray(p2[name]))
    assert srv.forwards == 3  # warm-up + two serves


@pytest.mark.timeout_s(240)
def test_elastic_server_resize_preserves_outputs(tmp_path):
    """A serving replica is elastic like a trainer: the world resizes live
    (replicated and fsdp) and the forward outputs are unchanged, on every
    live rank; the fsdp server's load_params and params_host work on its
    blocks."""
    batch = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    p2 = shifted(PARAMS, lambda a: a * 2.0)
    res = tw.run("serving", 2, tmp_path, 180, mlp_params=tree(PARAMS),
                 mlp_params2=tree(p2), batch=batch)
    want = np.asarray(jmlp.apply(PARAMS, batch))
    for kind in ("replicated", "fsdp"):
        r0, r1 = tw.scenario(res, kind)
        assert r0["resized"] and r1["resized"]
        assert r0["world"] == r1["world"] == 2
        assert close(r0["world1"], want)
        assert r1["world1"] is None  # standing by
        for r in (r0, r1):
            assert close(r["world2"], want)
            assert np.allclose(r["world2"], r0["world1"], atol=ATOL)
    f0, f1 = tw.scenario(res, "fsdp")
    for r in (f0, f1):
        assert close(r["reloaded"], np.asarray(jmlp.apply(p2, batch)))
        for name, v in r["host"].items():
            assert np.array_equal(v, np.asarray(p2[name]))


# ---------------------------------------------------- continuous batching


@fleet_test
def test_replica_batches_a_burst_into_few_iterations():
    def build():
        return ElasticServer(apply_fn, module(),
                             devices=[torch.device("cpu")])

    r = ServingReplica("t/r0", build,
                       example_batch=(np.zeros((8, 16), np.float32),),
                       max_batch_size=8, max_queue_ms=5.0, job="t/cb")
    r.start()
    assert r.wait_ready(60)
    reqs = [ServeRequest(payload=row(i), id=i,
                         t_enqueue=time.perf_counter()) for i in range(24)]
    for q in reqs:
        r.submit(q)
    for i, q in enumerate(reqs):
        assert close(q.wait(10), expected(row(i)[0])), i  # per-row correct
    # 24 requests over batch-8 admission: packed, not one-per-iteration
    assert r.iterations <= 6, r.iterations
    assert r.requests_served == 24
    assert r.build_ms is not None
    r.stop(drain=True)


@fleet_test
def test_lone_request_is_not_held_for_a_full_batch():
    fleet = make_fleet(job="t/lone")
    try:
        fleet.scale_to(1)
        req = fleet.submit(row(3))
        assert close(req.wait(10), expected(row(3)[0]))
        assert req.latency_s < 1.0  # admission window is ms-scale
    finally:
        fleet.stop()


# ------------------------------------------------- scale up/down + drain


@fleet_test
def test_hint_then_scale_up_is_a_prewarm_hit():
    fleet = make_fleet(job="t/hint")
    try:
        fleet.scale_to(1)
        c0 = get_counters().get("serving_prewarm_hits", job="t/hint")
        fleet.hint(2)  # the autoscaler's plan hint: build starts NOW
        fleet.scale_to(2)  # actuation adopts the hint-built replica
        assert fleet.prewarm_hits == 1
        assert get_counters().get("serving_prewarm_hits",
                                  job="t/hint") == c0 + 1
        assert fleet.replicas_ready() == 2
        reqs = [fleet.submit(row(i)) for i in range(16)]
        for i, q in enumerate(reqs):
            assert close(q.wait(10), expected(row(i)[0]))
    finally:
        fleet.stop()


@fleet_test
def test_scale_down_drains_without_dropping():
    fleet = make_fleet(job="t/drain")
    try:
        fleet.scale_to(2)
        reqs = [fleet.submit(row(i)) for i in range(64)]
        fleet.scale_to(1)  # drains the departing replica's queue first
        for i, q in enumerate(reqs):
            assert close(q.wait(10), expected(row(i)[0]))  # every one
        assert fleet.replicas_active() == 1
        assert get_counters().get("serving_dropped_requests",
                                  job="t/drain") == 0
    finally:
        fleet.stop()


@fleet_test
def test_forced_stop_counts_drops_and_surfaces_them():
    fleet = make_fleet(job="t/forced", max_queue_ms=50.0)
    fleet.scale_to(1)
    c0 = get_counters().get("serving_dropped_requests", job="t/forced")
    reqs = [fleet.submit(row(i)) for i in range(32)]
    fleet.stop(drain=False)  # the UNgraceful path
    outcomes = []
    for i, q in enumerate(reqs):
        try:
            assert close(q.wait(5), expected(row(i)[0]))
            outcomes.append("served")
        except RequestDropped:
            outcomes.append("dropped")
    dropped = outcomes.count("dropped")
    assert dropped == get_counters().get("serving_dropped_requests",
                                         job="t/forced") - c0
    # a dropped request FAILS its future loudly — it never hangs a caller


# ------------------------------------------------------- rolling reloads


@fleet_test
def test_rolling_reload_under_traffic_swaps_all_and_drops_nothing():
    fleet = make_fleet(job="t/reload")
    try:
        fleet.scale_to(2)
        p2 = shifted(PARAMS, lambda a: a * 2.0)
        traffic = PoissonTraffic(fleet, row, qps=250, seed=3)
        done = []
        t = threading.Thread(target=lambda: done.append(
            fleet.rolling_reload(module(p2), generation=5)))
        th = threading.Thread(target=lambda: traffic.run(0.8))
        th.start()
        time.sleep(0.2)
        t.start()
        th.join()
        t.join()
        tally = traffic.await_all()
        assert tally["dropped"] == 0 and tally["errors"] == 0, tally
        assert done == [2]  # every replica swapped, one at a time
        assert fleet.generation == 5
        # every answer is one generation's, whole
        for i, req in enumerate(traffic.sent):
            got = req.wait(5)
            assert (close(got, expected(row(i)[0]))
                    or close(got, expected(row(i)[0], p2))), i
        # post-reload answers come from generation 5's weights
        req = fleet.submit(row(1))
        assert close(req.wait(5), expected(row(1)[0], p2))
        assert get_counters().get("serving_reloads", job="t/reload") >= 2
    finally:
        fleet.stop()


@fleet_test
@pytest.mark.parametrize("source", ["hinted", "inline"])
def test_scale_up_after_a_reload_serves_the_new_generation(source):
    """A replica that joins after a reload takes the fleet's generation
    before it takes traffic: a standby hint-built on the boot weights
    before the reload, or one built inline, never answers with them."""
    job = f"t/late-{source}"
    fleet = make_fleet(job=job)
    try:
        fleet.scale_to(1)
        if source == "hinted":
            fleet.hint(2)  # built on the boot weights
        p2 = shifted(PARAMS, lambda a: a + 1.0)
        assert fleet.rolling_reload(module(p2), generation=2) == 1
        traffic = PoissonTraffic(fleet, row, qps=400, seed=5)
        th = threading.Thread(target=lambda: traffic.run(0.6))
        th.start()
        time.sleep(0.1)
        fleet.scale_to(2)  # under traffic
        th.join()
        tally = traffic.await_all()
        assert tally["dropped"] == 0 and tally["errors"] == 0, tally
        assert fleet.replicas_ready() == 2
        assert fleet.prewarm_hits == (source == "hinted")
        assert all(r.generation == 2 for r in fleet.replicas())
        for i, req in enumerate(traffic.sent):
            assert close(req.wait(5), expected(row(i)[0], p2)), i
        # the late replica answers too, with generation 2's weights
        late = fleet.replicas()[1]
        assert late.requests_served > 0
    finally:
        fleet.stop()


@fleet_test
def test_reload_from_checkpoint_lineage(tmp_path):
    """Generation N+1 appears in the elastic checkpoint lineage (verified
    manifest) → the fleet rolls onto it; a generation it already serves is
    a no-op."""
    ckpt = ElasticCheckpointer(tmp_path / "lineage", max_to_keep=3)
    ckpt.save(1, {"params": module()})
    fleet = make_fleet(job="t/lineage", kv=None)
    try:
        fleet.scale_to(1)
        fleet.generation = 1
        assert fleet.reload_from_lineage(ckpt) is None  # already current
        p2 = shifted(PARAMS, lambda a: a + 3.0)
        ckpt.save(2, {"params": module(p2)})
        assert fleet.reload_from_lineage(ckpt) == 2
        req = fleet.submit(row(2))
        assert close(req.wait(5), expected(row(2)[0], p2))
        # a replica created after the reload serves the current generation
        fleet.scale_to(2)
        reqs = [fleet.submit(row(i)) for i in range(16)]
        for i, q in enumerate(reqs):
            assert close(q.wait(5), expected(row(i)[0], p2))
    finally:
        fleet.stop()
        ckpt.close()


@fleet_test
def test_reload_skips_unverified_generation(tmp_path):
    """The fleet never loads a generation whose manifest lacks (or forges)
    the verified bit, nor one whose leaves lie about their folds (the
    restore falls back past it); an honest later generation ships."""
    ckpt = ElasticCheckpointer(tmp_path / "lineage", max_to_keep=4)
    ckpt.save(1, {"params": module()})
    p2 = shifted(PARAMS, lambda a: a + 3.0)
    ckpt.save(2, {"params": module(p2)})
    # forge generation 2: strip the verified bit, leave the files (and
    # their CRCs) intact — latest_verified_step alone would take it
    mpath = ckpt._manifest_path(2)
    forged = json.loads(mpath.read_text())
    del forged["verified"]
    mpath.write_text(json.dumps(forged))

    fleet = make_fleet(job="t/unverified", kv=None)
    try:
        fleet.scale_to(1)
        fleet.generation = 1
        before = get_counters().get("serving_reload_skipped_unverified")
        assert fleet.reload_from_lineage(ckpt) is None
        assert fleet.generation == 1  # the fleet never moved
        assert get_counters().get(
            "serving_reload_skipped_unverified") == before + 1
        # generation 3 lies DEEPER: verified bit intact but a leaf's fold
        # disagrees with the stored bytes — restore() falls back past it,
        # and publishing the fallback tree under generation 3 is refused
        p3 = shifted(PARAMS, lambda a: a + 7.0)
        ckpt.save(3, {"params": module(p3)})
        mpath = ckpt._manifest_path(3)
        lied = json.loads(mpath.read_text())
        leaf = sorted(lied["leaves"])[0]
        lied["leaves"][leaf] = f"{0:016x}"
        mpath.write_text(json.dumps(lied))
        assert fleet.reload_from_lineage(ckpt) is None
        assert fleet.generation == 1
        assert get_counters().get(
            "serving_reload_skipped_unverified") == before + 2
        req = fleet.submit(row(1))
        assert close(req.wait(5), expected(row(1)[0]))  # still gen 1's
        # an honest generation 4 ships
        p4 = shifted(PARAMS, lambda a: a * 2.0)
        ckpt.save(4, {"params": module(p4)})
        assert fleet.reload_from_lineage(ckpt) == 4
        req = fleet.submit(row(1))
        assert close(req.wait(5), expected(row(1)[0], p4))
    finally:
        fleet.stop()
        ckpt.close()


@fleet_test
def test_generation_published_to_coordinator_kv():
    kv = PyCoordService()
    fleet = make_fleet(job="t/gen", kv=kv)
    try:
        fleet.scale_to(1)
        p9 = shifted(PARAMS, lambda a: a + 1)
        fleet.rolling_reload(module(p9), 9)
        assert kv.kv_get("serving-gen/t/gen") == b"9"
        req = fleet.submit(row(4))
        assert close(req.wait(5), expected(row(4)[0], p9))
    finally:
        fleet.stop()


# -------------------------------------------------- traffic and the closure


class FakeTime:
    """perf_counter/sleep on a clock that only sleeping moves."""

    def __init__(self) -> None:
        self.now = 100.0

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, dt: float) -> None:
        self.now += dt


class StubFleet:
    def __init__(self, clock: FakeTime) -> None:
        self.clock, self.times = clock, []

    def submit(self, payload):
        self.times.append(self.clock.now)
        return payload


@pytest.mark.parametrize("qps", [50.0, 400.0])
def test_poisson_arrivals_equal_the_reference(monkeypatch, qps):
    """Seed 3's arrival offsets (the open loop's send times on a fake
    clock) are the reference's, exactly."""
    offsets = {}
    for name, mod in (("jax", jserving), ("torch", serving)):
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        fleet = StubFleet(clock)
        sent = mod.PoissonTraffic(fleet, row, qps=qps, seed=3).run(2.0)
        offsets[name] = [t - 100.0 for t in fleet.times]
        assert len(sent) == len(fleet.times) > 0
    assert offsets["torch"] == offsets["jax"]


@fleet_test
def test_scoring_closure_matches_the_reference_fleet():
    """entry.flagship_scoring_fleet's closure (the next-token logits of a
    row of tokens) at TINY: the port's fleet and the JAX package's
    ServingFleet answer the same rows alike."""
    seq = 64
    rows = np.random.default_rng(5).integers(
        0, jtfm.TINY.vocab_size, (12, seq)).astype(np.int64)
    fleet = entry.flagship_scoring_fleet(
        device="cpu", params=port_model(), seq=seq, job="t/score",
        max_queue_ms=1.0)
    ref = jserving.ServingFleet(
        lambda p, b: jtfm.apply(p, b[0], jtfm.TINY)[:, -1], TINY_PARAMS,
        example_row=(np.zeros((seq,), np.int32),), job="t/score-ref",
        max_queue_ms=1.0)
    try:
        fleet.scale_to(1)
        ref.scale_to(1)
        got = [fleet.submit((r,)) for r in rows]
        want = [ref.submit((r.astype(np.int32),)) for r in rows]
        for g, w in zip(got, want):
            a, b = np.asarray(g.wait(30)), np.asarray(w.wait(60))
            assert a.shape == (jtfm.TINY.vocab_size,)
            assert close(a, b)
    finally:
        fleet.stop()
        ref.stop()


def test_launch_counts_survive_concurrent_replicas():
    """Replica threads of one fleet launch the flash kernels at once: the
    counts go up under a lock, so none is lost at a tiny switch
    interval."""
    import sys

    from edl_tpu_torch.ops import flash_attention as fa

    before = dict(fa.launches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fa._count("flash_fwd") for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fa.launches["flash_fwd"] - before["flash_fwd"] == 8 * 5000
    fa.launches.update(before)
