"""The port's ChaosMonkey (edl_tpu_torch.runtime.chaos):
tests/test_chaos_examples.py's two monkey scenarios.  The repeated kills
run on one spawned gloo world of four CPU ranks (tests/torch_world.py::
suite_controlled_four) against a job the port's ``Controller`` runs; the
max-kills cap runs beside the JAX package's monkey on the same cluster
script."""

import jax
import numpy as np
import pytest

import torch_world as tw
from edl_tpu.api import types as jtypes
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.models import mlp as jmlp
from edl_tpu.runtime.chaos import ChaosMonkey as JaxMonkey
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.runtime.chaos import ChaosMonkey

WORLD_DEADLINE_S = 180
pytestmark = pytest.mark.timeout_s(240)
MLP_PARAMS = jax.tree.map(np.asarray, jmlp.init(jax.random.key(2),
                                                [16, 32, 4]))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rng = np.random.default_rng(2)
    y = rng.integers(0, 4, size=2048).astype(np.int64)
    x = rng.normal(size=(2048, 16)).astype(np.float32)
    return tw.run("controlled_four", 4, tmp_path_factory.mktemp("chaos"),
                  WORLD_DEADLINE_S, mlp_params=MLP_PARAMS, data=(x, y),
                  names=("chaos_monkey",))


def test_chaos_monkey_repeated_kills_job_survives(four):
    """A trainer killed every 8 steps; training still drains both passes
    and the fault-tolerant job stays Running."""
    got = tw.scenario(four, "chaos_monkey")
    r0 = got[0]
    assert len(r0["kills"]) >= 3  # the monkey actually struck repeatedly
    assert r0["steps"] == 2 * (2048 // 64)  # nothing lost, both passes
    assert r0["phase"] == "Running"
    assert sorted(r0["order"]) == sorted(list(range(8)) * 2)
    assert all(g["steps"] == r0["steps"] for g in got)
    assert np.isfinite(r0["losses"]).all()


def test_chaos_monkey_respects_max_kills():
    def drill(types, cluster, monkey):
        cluster.add_node("n0", cpu_milli=8_000, memory_mega=100_000)
        job = types.TrainingJob(name="j", spec=types.TrainingJobSpec(
            fault_tolerant=True, trainer=types.TrainerSpec(
                min_instance=2, max_instance=2,
                resources=types.ResourceRequirements(
                    requests={"cpu": "1", "memory": "10M"},
                    limits={"cpu": "1", "memory": "10M"}))))
        cluster.create_resources(job)
        cluster.reconcile()
        m = monkey(cluster, job, every_n_steps=1, max_kills=2)
        for step in range(1, 10):
            m(step)
        return m.kills

    want = drill(jtypes, JaxCluster(), JaxMonkey)
    got = drill(ttypes, TorchCluster(), ChaosMonkey)
    assert len(got) == 2 and got == want
