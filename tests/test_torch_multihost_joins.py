"""The port's multi-process elastic world growing: real supervisors
(``python -m edl_tpu_torch.runtime.multihost_worker --device cpu``) against
the port's native coordination server, the join scenarios of
tests/test_multihost.py:

* a join wave forms ONE world of 2 and the task queue drains exactly once,
  with the shards in memory and as files on shared storage;
* a late joiner inherits trained state through the generation protocol,
  bitwise (its entry digest is the saved generation's), instead of
  cold-starting; replicated, and fsdp (the sharded state saved layout-free
  and restored onto the grown world) with the loss continuous.

The fault scenarios are tests/test_torch_multihost_drills.py.
"""

from __future__ import annotations

import json

import pytest

from torch_multihost_harness import (assert_exactly_once, coord_server,
                                     field, lines, losses, saved_digests,
                                     spawn_worker, wait_all, wait_for_line,
                                     worker_env)

__all__ = ["coord_server"]

pytestmark = pytest.mark.timeout_s(240)


@pytest.mark.parametrize("data_mode", ["memory", "files"])
def test_join_wave_forms_one_world_and_drains(coord_server, tmp_path,
                                              data_mode):
    env = worker_env(1024, 16, EDL_MH_TRACE=str(tmp_path / "traces"))
    if data_mode == "files":
        env["EDL_MH_DATA_DIR"] = str(tmp_path / "shards")
    procs = {n: spawn_worker(coord_server.port, n, tmp_path, 2, env,
                             tmp_path / f"{n}.log")
             for n in ("w0", "w1")}
    rcs = wait_all(procs, timeout_s=150)
    assert rcs == {"w0": 0, "w1": 0}
    for n in procs:
        text = (tmp_path / f"{n}.log").read_text()
        assert "done at step" in text
        # the settle window merged the join wave into one 2-world
        assert "world=2" in text and "world=1" not in text
        phases = lines(tmp_path / f"{n}.log", "world_phases")[0]
        for name in ("spawn_imports_s", "coordinator_handshake_s",
                     "device_acquire_s", "restore_s"):
            assert float(field(phases, name)) >= 0
    assert_exactly_once(coord_server.client(), 16)
    # the supervisors dumped chrome traces of their world timelines, and
    # the world child's startup phases sit in a reform's span tree (the
    # epoch's ``trace/<epoch>`` key holds the last supervisor's root)
    roots = set()
    for n in procs:
        trace = json.loads(
            (tmp_path / "traces" / f"trace-{n}.json").read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"world_exit", "reform", "reform.plan"} <= names
        roots |= {e["args"].get("span_id") for e in trace["traceEvents"]
                  if e.get("name") == "reform"}
    child = list((tmp_path / "traces").glob("trace-w0-world*"))
    events = json.loads(child[0].read_text())["traceEvents"]
    assert any(e["name"] == "world_start.restore"
               and e["args"].get("parent_id") in roots for e in events)
    if data_mode == "files":
        assert len(list((tmp_path / "shards").glob("shard-*.npz"))) == 16


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_late_joiner_inherits_trained_state(coord_server, tmp_path,
                                            sharding):
    # paced so the 2-world is still mid-job when the joiner lands
    env = worker_env(12288, 192, EDL_MH_STEP_SLEEP="0.1")
    extra = ("--param-sharding", sharding)
    procs = {n: spawn_worker(coord_server.port, n, tmp_path, 2, env,
                             tmp_path / f"{n}.log", extra=extra)
             for n in ("w0", "w1")}
    # wait until the 2-world has trained real steps, then scale up
    wait_for_line(tmp_path / "w0.log", "step 20 ", timeout_s=150)
    procs["w2"] = spawn_worker(coord_server.port, "w2", tmp_path, 1, env,
                               tmp_path / "w2.log", extra=extra)
    rcs = wait_all(procs, timeout_s=180)
    assert rcs == {"w0": 0, "w1": 0, "w2": 0}
    # the joiner's first world entry carries inherited progress: the
    # generation protocol hands it the survivors' state, bitwise
    first_entry = lines(tmp_path / "w2.log", "entering world")[0]
    assert int(first_entry.rsplit("step=", 1)[1]) >= 20, first_entry
    assert field(first_entry, "world") == "3"
    logs = [tmp_path / f"{n}.log" for n in ("w0", "w1", "w2")]
    assert field(first_entry, "digest") in saved_digests(*logs).values()
    # loss continuity: the grown world's losses stay below the cold start
    cold = losses((tmp_path / "w0.log").read_text())[0]
    assert cold[0] == 1
    post = [loss for _, loss in losses((tmp_path / "w2.log").read_text())
            if loss > 0]
    assert post and max(post) < cold[1], (cold, post)
    assert_exactly_once(coord_server.client(), 192)
