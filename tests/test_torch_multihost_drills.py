"""The port's multi-process elastic world under faults: real supervisors
(``python -m edl_tpu_torch.runtime.multihost_worker --device cpu``) against
the port's native coordination server, each world a gloo process group of
CPU processes — the scenarios of tests/test_multihost.py, which skip in
this container for the JAX package (its CPU backend runs no multi-process
collectives) and run here for the port:

* graceful scale-down: SIGTERM a worker → it leaves at a step boundary,
  the survivors reform a world of 2 and finish;
* crash: ``kill -9`` a worker mid-world → its world child dies with it,
  a survivor's collective raises on the closed connection, the survivors'
  supervisors reform a world of 2 from the newest mid-world generation,
  bitwise (its digest is the saved one), and finish; replicated on the
  MLP, and fsdp on the TINY transformer (the sharded state restored
  collectively onto the smaller world).

Every scenario asserts exactly-once task accounting from the server's
queue stats.  The join scenarios are tests/test_torch_multihost_joins.py.
"""

from __future__ import annotations

import signal

import pytest

from torch_multihost_harness import (assert_exactly_once, coord_server,
                                     field, lines, losses, saved_digests,
                                     spawn_worker, wait_all, wait_for_line,
                                     worker_env)

__all__ = ["coord_server"]

pytestmark = pytest.mark.timeout_s(240)


def test_sigterm_leaver_and_survivors_finish(coord_server, tmp_path):
    env = worker_env(3072, 48, EDL_MH_STEP_SLEEP="0.05")
    procs = {n: spawn_worker(coord_server.port, n, tmp_path, 3, env,
                             tmp_path / f"{n}.log")
             for n in ("w0", "w1", "w2")}
    # let the 3-world actually train before scaling down
    wait_for_line(tmp_path / "w0.log", "step 1 ", timeout_s=120)
    procs["w1"].send_signal(signal.SIGTERM)
    rcs = wait_all(procs, timeout_s=180)
    assert rcs == {"w0": 0, "w1": 0, "w2": 0}
    assert "left at step" in (tmp_path / "w1.log").read_text()
    for n in ("w0", "w2"):
        text = (tmp_path / f"{n}.log").read_text()
        assert "done at step" in text
        assert "world=2" in text  # survivors reformed a 2-world
        assert "supervisor cuda initialized False" in text
    assert_exactly_once(coord_server.client(), 48)


@pytest.mark.parametrize("model,sharding", [("mlp", "replicated"),
                                            ("transformer", "fsdp")])
def test_sigkill_crash_survivors_reform_and_finish(coord_server, tmp_path,
                                                   model, sharding):
    """The headline fault-tolerance property: kill -9 a worker mid-world
    and the survivors must not die with it; the reform restores the
    newest mid-world generation onto the smaller world, bitwise."""
    env = worker_env(3072 if model == "mlp" else 1536, 48,
                     batch=32 if model == "mlp" else 8,
                     EDL_MH_STEP_SLEEP="0.05", EDL_MH_CKPT_EVERY="4",
                     EDL_MH_SEQ="16")
    extra = ("--model", model, "--param-sharding", sharding)
    procs = {n: spawn_worker(coord_server.port, n, tmp_path, 3, env,
                             tmp_path / f"{n}.log", extra=extra)
             for n in ("w0", "w1", "w2")}
    wait_for_line(tmp_path / "w0.log", "step 9 ", timeout_s=150)
    procs["w1"].kill()  # SIGKILL: no cleanup, no leave intent
    assert procs["w1"].wait(timeout=30) == -signal.SIGKILL
    del procs["w1"]
    rcs = wait_all(procs, timeout_s=180)
    assert rcs == {"w0": 0, "w2": 0}
    w0 = tmp_path / "w0.log"
    text = w0.read_text()
    assert "done at step" in text and "world=2" in text
    assert "aborted" in text  # the world child died; the supervisor lived
    entries = lines(w0, "entering world")
    assert len(entries) >= 2, entries
    resumed = entries[1]
    assert field(resumed, "world") == "2"
    assert int(resumed.rsplit("step=", 1)[1]) >= 8, resumed
    # the reformed world starts bitwise from a generation that was saved
    assert field(resumed, "digest") in saved_digests(
        w0, tmp_path / "w2.log").values()
    cold = losses(text)[0]
    assert cold[0] == 1
    post = [loss for step, loss in losses(text)
            if step > int(resumed.rsplit("step=", 1)[1]) and loss > 0]
    assert post and max(post) < cold[1], (cold, post)
    assert_exactly_once(coord_server.client(), 48)
