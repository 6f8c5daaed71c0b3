"""The end-to-end elastic slice on the port (tests/test_elastic_e2e.py's two
scenarios): submit a job to the port's ``Controller`` → its updater
creates the pods → its autoscaler grows the job → the live training loop
resizes at step boundaries → competing load shrinks it; and a trainer pod
killed mid-run is replaced while the fault-tolerant job trains on.

One spawned gloo world of four CPU ranks (tests/torch_world.py::
suite_controlled_four) runs both; rank 0 holds the cluster, the controller
and the coordinator.  Rank 0's losses are held to a one-rank control of the
port fed rank 0's batches in the order it trained them, and to the JAX
package's trainer fed the same batches.
"""

import jax
import numpy as np
import optax
import pytest

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch.runtime.data import ShardRegistry

WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)

MLP_PARAMS = jax.tree.map(np.asarray, jmlp.init(jax.random.key(0),
                                                [16, 32, 4]))
#: the port's world-2 and world-4 steps against its one-rank control: the
#: ranks' gradient shares round unlike the whole batch's
CONTROL_ATOL = 1e-6
#: against the JAX trainer on the same batches: two frameworks' fp32
#: rounding, carried by adam(1e-2) (ROADMAP.md queue 3, "Not faults");
#: 1.335e-5 on these runs
JAX_ATOL = 5e-5


def _data():
    return tw.synthetic_classification(n=1024, seed=0)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.run("controlled_four", 4, tmp_path_factory.mktemp("e2e"),
                  WORLD_DEADLINE_S, mlp_params=MLP_PARAMS, data=_data(),
                  names=("scale_up_and_down", "pod_kill"))


def batches_in_order(rows: int, shards: int, order: list) -> list:
    """Rank 0's batches: each leased shard's rows, 64 at a time."""
    data = _data()
    reg = ShardRegistry()
    ids = reg.register_arrays((data[0][:rows], data[1][:rows]),
                              num_shards=shards)
    out = []
    for shard in order:
        x, y = reg.get(ids[shard])
        out += [(x[lo:lo + 64], y[lo:lo + 64])
                for lo in range(0, len(x) - 63, 64)]
    return out


def port_control(batches: list) -> list:
    trainer = tw._mlp_from(MLP_PARAMS, 1)
    return [trainer.step(b) for b in batches]


def jax_control(batches: list) -> list:
    trainer = JaxTrainer(jmlp.loss_fn, jax.tree.map(np.copy, MLP_PARAMS),
                         optax.adam(1e-2), initial_world_size=1)
    return [float(trainer.step((x, y.astype(np.int32))))
            for x, y in batches]


def check_losses(r0: dict, rows: int, shards: int) -> None:
    batches = batches_in_order(rows, shards, r0["order"])
    assert len(batches) == r0["steps"]
    np.testing.assert_allclose(r0["losses"], port_control(batches),
                               atol=CONTROL_ATOL, rtol=0)
    np.testing.assert_allclose(r0["losses"], jax_control(batches),
                               atol=JAX_ATOL, rtol=0)


def test_elastic_training_through_scale_up_and_down(four):
    got = tw.scenario(four, "scale_up_and_down")
    r0 = got[0]
    assert r0["steps"] == 2 * (1024 // 64)  # both passes, exactly once
    assert max(r0["worlds"]) == 4  # scaled up to max
    worlds = r0["worlds"]
    assert min(worlds[worlds.index(4):]) <= 2  # shrank under load
    assert r0["resizes"] >= 2  # at least one grow + one shrink
    assert all(g["worlds"] == worlds for g in got)
    # learning survived every resize
    assert np.mean(r0["losses"][-10:]) < np.mean(r0["losses"][:10]) * 0.5
    assert r0["losses"][-1] < r0["losses"][0]
    assert r0["phase"] == "Running"
    check_losses(r0, 1024, 16)


def test_trainer_pod_kill_does_not_stop_training(four):
    got = tw.scenario(four, "pod_kill")
    r0 = got[0]
    assert r0["killed"]
    assert r0["steps"] == 1024 // 64  # nothing lost
    assert r0["phase"] == "Running"  # FT job survived
    assert max(r0["worlds"]) == 4
    check_losses(r0, 1024, 8)
