"""The port's LocalElasticJob (edl_tpu_torch.runtime.local): the elastic
job the control plane dials, SPMD over a gloo process group, held against
the JAX package's LocalElasticJob.

Two spawned gloo worlds run once each (tests/torch_world.py):

* two ranks: ``entry.flagship_local_job`` (chip_smoke's phase (q)) at
  TINY; the lease path on the port's MLP [16, 32, 4] (the JAX init) with
  the dial 1 → 2 → 1, a second lease holder dying with a task, against the
  reference's LocalElasticJob on the same dial (losses within 1e-5, every
  task trained once); a shape policy that raises; a coordinator that
  fails on rank 0;
* four ranks: both scenarios of tests/test_local_virtual.py and
  tests/test_accuracy_elasticity.py's dead-worker scenario.
"""

import jax
import numpy as np
import optax
import pytest

import torch_world as tw
from edl_tpu.api.types import (ResourceRequirements as JaxResources,
                               TrainerSpec as JaxTrainerSpec,
                               TrainingJob as JaxJob,
                               TrainingJobSpec as JaxJobSpec)
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.coord import PyCoordService as JaxCoord
from edl_tpu.models import mlp as jmlp
from edl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from edl_tpu.runtime.data import ShardRegistry as JaxRegistry
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu.runtime.local import LocalElasticJob as JaxLocalJob
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.runtime.virtual import loss_divergence

WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

#: the lease path against the reference's (fp32 MLP, adam)
LOSS_ATOL = 1e-5
#: after step k the harness turns the trainer count to DIAL[k]
DIAL = {3: 2, 6: 1}
JAX_PARAMS = jmlp.init(jax.random.key(0), [16, 32, 4])
MLP_PARAMS = jax.tree.map(np.asarray, JAX_PARAMS)
SEED = 11
TINY_KW = dict(cfg=tfm.TINY, global_batch=4, seq=32, rows=32, shards=8)


def _dataset(n=512):
    """tests/test_local_virtual.py's data (normal rows, uniform labels)."""
    rng = np.random.default_rng(4)
    return (rng.normal(size=(1024, 16)).astype(np.float32)[:n],
            rng.integers(0, 4, 1024).astype(np.int64)[:n])


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.run("local", 2, tmp_path_factory.mktemp("local2"),
                  WORLD_DEADLINE_S, mlp_params=MLP_PARAMS, data=_dataset(),
                  dial=DIAL, tiny_kw=TINY_KW)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.run("local_four", 4, tmp_path_factory.mktemp("local4"),
                  WORLD_DEADLINE_S, mlp_params=MLP_PARAMS,
                  data=_dataset(1024), seed=SEED)


def _jax_lease_run() -> dict:
    """The reference's LocalElasticJob on the same job: 8 tasks of 64 rows,
    the same dial and ghost lease holder, prewarm on and no deferral."""
    reg = JaxRegistry()
    ids = reg.register_arrays(_dataset(), num_shards=8)
    coord = JaxCoord()
    cluster = JaxCluster()
    for i in range(2):
        cluster.add_node(f"n{i}", cpu_milli=16000, memory_mega=64000)
    job = JaxJob(name="lease", spec=JaxJobSpec(
        fault_tolerant=True, trainer=JaxTrainerSpec(
            min_instance=1, max_instance=2,
            resources=JaxResources(requests={"cpu": "1"}))))
    cluster.create_resources(job)
    reg.enqueue(coord, ids)
    trainer = JaxTrainer(jmlp.loss_fn, jax.tree.map(np.copy, MLP_PARAMS),
                         optax.adam(1e-2), spec=JaxMeshSpec(dp=-1),
                         initial_world_size=1)
    runner = JaxLocalJob(job, cluster, trainer, coord, fetch=reg.fetch,
                         batch_size=64, resize_defer_s=0)

    def on_step(step, loss, world):
        if step in DIAL:
            cluster.update_trainer_parallelism(job, DIAL[step])
        if step == 2:
            coord.lease("ghost")
            coord.release_worker("ghost")

    rep = runner.run(on_step=on_step)
    return dict(losses=rep.losses, worlds=rep.world_sizes,
                resizes=rep.resizes, all_done=coord.all_done())


# -- two ranks: the lease path -------------------------------------------------


def test_lease_path_matches_the_reference_on_the_dial(two):
    """1 → 2 → 1 on the dial: the world follows it at the next step
    boundary on both ranks, every task is trained exactly once (the ghost's
    task redispatched), the coordinator drains, and the losses are the
    reference LocalElasticJob's."""
    want = _jax_lease_run()
    got = tw.scenario(two, "lease_parity")
    r0, r1 = got
    assert want["worlds"] == [1, 1, 1, 2, 2, 2, 1, 1]
    assert want["resizes"] == 2 and want["all_done"]
    for g in got:
        assert g["worlds"] == want["worlds"] and g["resizes"] == 2
        assert g["steps"] == 8
    assert sorted(r0["fetched"]) == list(range(8)) and r1["fetched"] == []
    assert r0["all_done"] is True
    np.testing.assert_allclose(r0["losses"], want["losses"], atol=LOSS_ATOL,
                               rtol=0)
    # rank 1 stands by on a world of 1 and steps beside rank 0 on 2
    assert [x is None for x in r1["losses"]] == [w == 1 for w in
                                                 want["worlds"]]
    assert [x for x in r1["losses"] if x is not None] == \
        r0["losses"][3:6]
    # the grow took the layout prewarmed after the first step; the shrink
    # went back to the cached world of 1
    assert [e["prewarm_hit"] for e in r0["events"]] == [True, False]
    assert r0["prewarm_hits"] == 1 and r0["deferred"] == 0
    assert len(r0["data_ms"]) == 8


def test_a_failing_shape_policy_falls_back_to_the_bare_count(two):
    for g in tw.scenario(two, "shape_fallback"):
        assert g["worlds"] == [1, 1, 1, 2, 2, 2, 1, 1]
        assert g["resizes"] == 2


def test_a_coordinator_error_on_rank_0_raises_on_every_rank(two):
    """rank 0's coordinator fails at its fourth lease: rank 0 raises the
    error, rank 1 raises RankZeroFailed naming it, neither waits in a
    collective, and the group works after."""
    r0, r1 = tw.scenario(two, "coord_error")
    assert r0 == dict(raised="ConnectionError",
                      message="coordinator unreachable")
    assert r1["raised"] == "RankZeroFailed"
    assert "ConnectionError: coordinator unreachable" in r1["message"]
    assert tw.scenario(two, "after_error") == [3.0, 3.0]


def test_flagship_local_job_at_tiny(two):
    """chip_smoke's phase (q) lease path at TINY on the CPU: the dial
    1 → 2 → 1, the ghost's task redispatched, the queue drained; one data
    frame a step broadcast through the trainer's choke point."""
    r0, r1 = tw.scenario(two, "flagship_local")
    for g in (r0, r1):
        assert g["worlds"] == [1, 1, 1, 2, 2, 2, 1, 1]
        assert g["resizes"] == 2
    assert r0["all_done"] is True and r0["tasks"] == 8
    assert all(np.isfinite(r0["losses"]))
    # the first frame grows the ranks' buffers: one more broadcast
    assert r0["census"]["data"]["ops"] == {"broadcast": 9 + 1}
    assert len(r0["bytes_moved"]) == 2 and r0["bytes_moved"][0] > 0


# -- four ranks: the virtual drive ----------------------------------------------


def test_harness_virtual_drive_matches_control_bitwise(four):
    got = tw.scenario(four, "virtual_drive")
    r0 = got[0]
    assert r0["steps"] == 16 and r0["resizes"] == 1
    assert set(r0["worlds"]) == {2, 4}
    div = loss_divergence(r0["control"], r0["losses"])
    assert div["bitwise"], div
    assert r0["duplicated"] == 0 and r0["missing"] == 0
    assert r0["published"] == [True, True]
    # ranks 2 and 3 stand by until the dial reaches 4, then step alike
    for g in got[2:]:
        assert g["losses"] == r0["losses"][-len(g["losses"]):]


def test_opt_out_keeps_the_lease_path(four):
    got = tw.scenario(four, "opt_out")
    assert got[0]["steps"] == 4 and got[0]["virtual"] is None
    assert all(np.isfinite(got[0]["losses"]))
    assert all(g["steps"] == 4 for g in got)


def test_dead_workers_offsets_reowned_exactly_once(four):
    """A worker dies mid-shard and the world shrinks 4 → 2: the dead
    workers' virtual workers, partly consumed offsets included, are
    re-owned by the survivors, and no row is duplicated or dropped over
    the whole run."""
    r0 = tw.scenario(four, "dead_workers")[0]
    assert r0["restored"] == 7
    before, after = r0["before"], r0["after"]
    assert len(set(before.values())) == 4
    assert set(after.values()) == {"pw0", "pw1"}
    orphaned = [v for v, w in before.items() if w in ("pw2", "pw3")]
    assert orphaned and all(after[v] in ("pw0", "pw1") for v in orphaned)
    rows: dict = {}
    for rep in r0["reports"]:
        for gid, c in rep["rows"].items():
            rows[gid] = rows.get(gid, 0) + c
    total = sum(len(rep["losses"]) for rep in r0["reports"]) * 32
    assert sum(rows.values()) == total
    assert all(c == 1 for c in rows.values())
    assert len(rows) + r0["dropped"] == 640
