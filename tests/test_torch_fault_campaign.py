"""The port's fault-plan engine (edl_tpu_torch.runtime.faults), its training
kinds and ChaosProxy, held against the JAX package's on the same inputs:
tests/test_fault_campaign.py's plan, engine, stall, wedge and proxy
scenarios run on both packages side by side, and test_coord_ha.py's HA
KillCoordinator drill on the port's native pair.

The Tier-1 soak (one spawned gloo world of two CPU ranks,
tests/torch_world.py::suite_controlled) fires all eight training kinds from
one seed through ``entry.controlled_campaign`` against a job a
``Controller`` runs on the port's MLP (the JAX init): the native
coordinator behind the chaos proxy is SIGKILLed and respawned from its
state file, a system pod gives the second card back and takes it again so
the autoscaler grows the job to 2 and shrinks it to 1, and every task is
trained, the losses held to a one-rank control fed rank 0's batches in the
order it trained them.  The reference-size soak is marked slow, as the
reference's is.
"""

import random
import socket
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import torch_world as tw
from edl_tpu.api import types as jtypes
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.models import mlp as jmlp
from edl_tpu.observability.collector import get_counters as jax_counters
from edl_tpu.runtime import faults as jfaults
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.observability.collector import get_counters as counters
from edl_tpu_torch.runtime import faults as tfaults
from edl_tpu_torch.runtime.data import ShardRegistry

WORLD_DEADLINE_S = 180
SOAK_SEED = 11
#: the Tier-1 soak: 32 tasks of 64 rows (one step each), the eight faults
#: between steps 3 and 28, a checkpoint every 3 steps; the second node's
#: card is given back after step 5 and taken again after step 18
SOAK = dict(shards=32, first_step=3, last_step=28, min_gap=3, save_every=3,
            release_at=5, return_at=18)
#: the reference's soak: 32 tasks of 256 rows (128 steps), its schedule
SLOW_SOAK = dict(shards=32, first_step=10, last_step=100, min_gap=10,
                 save_every=5, release_at=20, return_at=70)
#: rank 0's losses against the one-rank control: a world-2 step averages
#: the two ranks' half-batch gradients, which rounds unlike the whole
#: batch's (3e-8 over the Tier-1 soak's 33 steps)
CONTROL_ATOL = 1e-6
MLP_PARAMS = jax.tree.map(np.asarray, jmlp.init(jax.random.key(0),
                                                [16, 32, 4]))

#: each package's engine side: its faults module, cluster, job types and
#: counters, and how its cluster names a domain
PKGS = {
    "jax": types.SimpleNamespace(
        faults=jfaults, cluster=JaxCluster, types=jtypes,
        counters=jax_counters,
        node=lambda c, name, dom: c.add_node(name, cpu_milli=8000,
                                             memory_mega=64000,
                                             ici_domain=dom)),
    "torch": types.SimpleNamespace(
        faults=tfaults, cluster=TorchCluster, types=ttypes,
        counters=counters,
        node=lambda c, name, dom: c.add_node(name, cpu_milli=8000,
                                             memory_mega=64000,
                                             nvlink_domain=dom)),
}


def _ft_job(t, name="drill", lo=2, hi=4):
    return t.TrainingJob(name=name, spec=t.TrainingJobSpec(
        fault_tolerant=True, trainer=t.TrainerSpec(
            min_instance=lo, max_instance=hi,
            resources=t.ResourceRequirements(
                requests={"cpu": "1", "memory": "100M"},
                limits={"cpu": "1", "memory": "100M"}))))


def _both(fn):
    """``fn(pkg)`` on the JAX package and on the port; returns both."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


# -- FaultPlan: seeded, reproducible campaigns, drawn as the reference draws --


@pytest.mark.parametrize("seed", [0, 11, 1234])
@pytest.mark.parametrize("kw", [
    {}, dict(n_faults=8, first_step=10, last_step=100, min_gap=10),
    dict(n_faults=3), dict(n_faults=12),
    dict(n_faults=11, kinds=tfaults.TRAINING_KINDS + tfaults.SDC_KINDS)])
def test_fault_plan_same_seed_same_campaign(seed, kw):
    """The seed IS the campaign, and the port's campaign is the
    reference's: same kinds, steps and parameters."""
    got = tfaults.FaultPlan.random(seed, **kw)
    assert got.describe() == tfaults.FaultPlan.random(seed, **kw).describe()
    assert got.describe() == jfaults.FaultPlan.random(seed, **kw).describe()
    assert got.seed == seed


def test_fault_plan_covers_all_kinds_with_spacing():
    kinds = tuple(tfaults.ACTION_TYPES)
    plan = tfaults.FaultPlan.random(7, n_faults=len(kinds), first_step=10,
                                    last_step=100, min_gap=8, kinds=kinds)
    assert plan.describe() == jfaults.FaultPlan.random(
        7, n_faults=len(kinds), first_step=10, last_step=100, min_gap=8,
        kinds=kinds).describe()
    got = [d["kind"] for d in plan.describe()]
    assert sorted(got) == sorted(kinds)
    assert set(tfaults.TRAINING_KINDS) <= set(got)
    steps = [d["at_step"] for d in plan.describe()]
    assert steps == sorted(steps)
    assert all(b - a >= 8 for a, b in zip(steps, steps[1:]))
    assert steps[0] >= 10


@pytest.mark.parametrize("kind", tfaults.SERVING_KINDS)
def test_serving_kinds_still_raise_naming_their_item(kind):
    """The serving five are ported: no kind is left to raise for, each
    draws as the reference draws, and only a kind neither package knows
    still raises."""
    assert tfaults.UNPORTED_KINDS == {}
    assert tfaults.ACTION_TYPES[kind].kind == kind
    for seed in range(4):
        assert tfaults.FaultPlan.random(
            seed, n_faults=2, kinds=(kind,)).describe() == \
            jfaults.FaultPlan.random(seed, n_faults=2,
                                     kinds=(kind,)).describe()
    with pytest.raises(ValueError, match="not ported"):
        tfaults.FaultPlan.random(0, n_faults=1, kinds=(kind + "_typo",))


def test_fault_plan_describe_carries_params():
    def plan(p):
        f = p.faults
        return f.FaultPlan(actions=[
            f.NetworkFlake(at_step=3, mode="blackhole", duration_s=2.5),
            f.CorruptCheckpoint(at_step=9, mode="truncate"),
            f.DiskFull(at_step=12, saves=2),
            f.StallStep(at_step=14, duration_s=2.5),
            f.PreemptDomain(at_step=15, domain="d")]).describe()

    want, got = _both(plan)
    assert got == want
    assert got[:3] == [
        {"kind": "network_flake", "at_step": 3, "mode": "blackhole",
         "duration_s": 2.5},
        {"kind": "corrupt_checkpoint", "at_step": 9, "mode": "truncate"},
        {"kind": "disk_full", "at_step": 12, "saves": 2},
    ]


# -- the engine on the fake cluster, both packages side by side ---------------


def test_engine_kill_and_preempt_with_recovery_counters():
    """A kill and a whole-domain preemption fire and recover at the same
    steps on both packages (two domains, replacements synchronous)."""
    def drill(p):
        f = p.faults
        cluster = p.cluster()
        p.node(cluster, "a0", "slice-a")
        p.node(cluster, "b0", "slice-b")
        job = _ft_job(p.types)
        cluster.create_resources(job)
        plan = f.FaultPlan(actions=[f.KillTrainer(at_step=1),
                                    f.PreemptDomain(at_step=3)])
        engine = f.FaultPlanEngine(plan, f.FaultContext(
            cluster=cluster, job=job, rng=random.Random(0)))
        before = {k: p.counters().get("faults_injected", type=k)
                  for k in ("kill_trainer", "preempt_domain")}
        seen = []
        for step in range(1, 5):
            engine(step)
            seen.append((list(engine.fired), list(engine.recovered)))
        running = sorted(q.node for q in cluster.list_pods(
            job_uid=job.full_name) if q.phase.value == "Running")
        return dict(seen=seen, quiescent=engine.quiescent(), running=running,
                    injected={k: p.counters().get("faults_injected", type=k)
                              - before[k] for k in before})

    want, got = _both(drill)
    assert got == want
    assert got["seen"][0] == ([(1, "kill_trainer")], [])
    assert got["seen"][1][1] == ["kill_trainer"]
    assert got["seen"][3] == ([(1, "kill_trainer"), (3, "preempt_domain")],
                              ["kill_trainer", "preempt_domain"])
    assert got["quiescent"]
    assert got["injected"] == {"kill_trainer": 1, "preempt_domain": 1}
    for k in ("kill_trainer", "preempt_domain"):
        assert counters().get("recoveries_completed", type=k) >= 1


def test_engine_retries_action_without_victims():
    def drill(p):
        f = p.faults
        cluster = p.cluster()  # no nodes: pods all Pending
        job = _ft_job(p.types)
        cluster.create_resources(job)
        engine = f.FaultPlanEngine(
            f.FaultPlan(actions=[f.KillTrainer(at_step=1)]),
            f.FaultContext(cluster=cluster, job=job))
        engine(1)
        first = (list(engine.fired), engine.quiescent())
        p.node(cluster, "n0", "")
        cluster.reconcile()
        engine(2)
        return first, list(engine.fired)

    want, got = _both(drill)
    assert got == want
    assert got == (([], False), [(2, "kill_trainer")])


def test_engine_unfireable_action_is_disarmed_not_fatal():
    def drill(p):
        engine = p.faults.FaultPlanEngine(
            p.faults.FaultPlan(actions=[p.faults.KillCoordinator(at_step=1)]),
            p.faults.FaultContext())  # no kubelet, no restart hook
        engine(1)  # must not raise
        return list(engine.fired), engine.quiescent()

    want, got = _both(drill)
    assert got == want == ([], True)


# -- the quiet faults: StallStep / WedgeCollective -----------------------------


def test_stall_and_wedge_fire_and_await_watchdog_detection():
    def drill(p):
        f = p.faults
        stalls, wedges = [], []
        ctx = f.FaultContext(stall=stalls.append,
                             wedge=lambda: bool(wedges.append(1)) or True)
        plan = f.FaultPlan(actions=[f.StallStep(at_step=1, duration_s=2.5),
                                    f.WedgeCollective(at_step=2)])
        engine = f.FaultPlanEngine(plan, ctx)
        engine(1)
        engine(2)
        mid = (list(engine.fired), engine.quiescent(), stalls, wedges)
        # the watchdog notices (what StallWatchdog.check emits on breach)
        p.counters().inc("stalls_detected", scope="drill-unit")
        engine(3)
        return mid, engine.quiescent(), sorted(engine.recovered)

    want, got = _both(drill)
    assert got == want
    assert got[0] == ([(1, "stall_step"), (2, "wedge_collective")], False,
                      [2.5], [1])
    assert got[1:] == (True, ["stall_step", "wedge_collective"])


def test_wedge_retries_until_a_victim_exists():
    def drill(p):
        ready = []
        engine = p.faults.FaultPlanEngine(
            p.faults.FaultPlan(actions=[p.faults.WedgeCollective(at_step=1)]),
            p.faults.FaultContext(wedge=lambda: bool(ready)))
        engine(1)
        first = (list(engine.fired), engine.quiescent())
        ready.append(1)
        engine(2)
        return first, list(engine.fired)

    want, got = _both(drill)
    assert got == want == (([], False), [(2, "wedge_collective")])


def test_stall_without_hook_is_disarmed_not_fatal():
    def drill(p):
        engine = p.faults.FaultPlanEngine(
            p.faults.FaultPlan(actions=[p.faults.StallStep(at_step=1)]),
            p.faults.FaultContext())
        engine(1)
        return list(engine.fired), engine.quiescent()

    want, got = _both(drill)
    assert got == want == ([], True)


def test_a_paused_window_is_neither_a_stall_nor_a_step_interval():
    """The campaign pauses its watchdog over a checkpoint save: silence
    inside the window never breaches, the window never feeds the EWMA, and
    the watch resumes, counting from the window's end."""
    from edl_tpu_torch.runtime.watchdog import StallWatchdog

    t = [0.0]
    wd = StallWatchdog(floor_s=1.0, k=6.0, warmup=1, alpha=0.5,
                       clock=lambda: t[0], scope="paused-unit")
    wd.beat(1)
    t[0] = 0.1
    wd.beat(2)
    assert wd.ewma_s() == pytest.approx(0.1)
    with wd.paused():
        t[0] = 30.0  # a 30 s save
        assert wd.check() is None
    assert wd.check() is None  # the silence restarts at the window's end
    t[0] = 30.2
    wd.beat(3)
    assert wd.ewma_s() == pytest.approx(0.15)  # 0.2 s, not 30 s, sampled
    t[0] = 32.0
    stall = wd.check()
    assert stall is not None and stall.silent_s == pytest.approx(1.8)
    assert stall.deadline_s == pytest.approx(1.0)


# -- ChaosProxy ----------------------------------------------------------------


@pytest.fixture
def echo_upstream():
    """A tiny newline echo server standing in for the coord server."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return

            def pump(c):
                try:
                    f = c.makefile("rb")
                    while line := f.readline():
                        c.sendall(b"echo " + line)
                except OSError:
                    pass
                finally:
                    c.close()
            threading.Thread(target=pump, args=(conn,), daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    yield srv.getsockname()
    stop.set()
    srv.close()


def test_proxy_forwards_and_resets(echo_upstream):
    proxy = tfaults.ChaosProxy(echo_upstream)
    try:
        c = socket.create_connection((proxy.host, proxy.port), timeout=5)
        c.sendall(b"hello\n")
        f = c.makefile("rb")
        assert f.readline() == b"echo hello\n"
        assert proxy.reset_all() >= 1
        c.settimeout(2)
        try:
            assert f.readline() == b""
        except OSError:
            pass
        c.close()
        c2 = socket.create_connection((proxy.host, proxy.port), timeout=5)
        c2.sendall(b"again\n")
        assert c2.makefile("rb").readline() == b"echo again\n"
        c2.close()
    finally:
        proxy.close()


def test_proxy_blackhole_window_then_recovers(echo_upstream):
    proxy = tfaults.ChaosProxy(echo_upstream)
    try:
        c = socket.create_connection((proxy.host, proxy.port), timeout=5)
        f = c.makefile("rb")
        c.sendall(b"one\n")
        assert f.readline() == b"echo one\n"
        proxy.blackhole(1.0)
        assert proxy.faults_active()
        c.sendall(b"lost\n")  # eaten by the window
        c.settimeout(0.5)
        with pytest.raises(OSError):
            f.readline()
        time.sleep(1.1)
        assert not proxy.faults_active()
        c.close()
        c2 = socket.create_connection((proxy.host, proxy.port), timeout=5)
        c2.sendall(b"back\n")
        assert c2.makefile("rb").readline() == b"echo back\n"
        c2.close()
    finally:
        proxy.close()


def test_proxy_delay_window(echo_upstream):
    proxy = tfaults.ChaosProxy(echo_upstream)
    try:
        c = socket.create_connection((proxy.host, proxy.port), timeout=5)
        f = c.makefile("rb")
        proxy.delay(1.0, per_chunk_s=0.3)
        t0 = time.monotonic()
        c.sendall(b"slow\n")
        assert f.readline() == b"echo slow\n"
        assert time.monotonic() - t0 >= 0.25
        c.close()
    finally:
        proxy.close()


def test_proxy_retargets_upstream(echo_upstream):
    proxy = tfaults.ChaosProxy(("127.0.0.1", 1))  # nothing there yet
    try:
        c = socket.create_connection((proxy.host, proxy.port), timeout=5)
        assert c.makefile("rb").readline() == b""
        c.close()
        proxy.set_upstream(*echo_upstream)
        c2 = socket.create_connection((proxy.host, proxy.port), timeout=5)
        c2.sendall(b"routed\n")
        assert c2.makefile("rb").readline() == b"echo routed\n"
        c2.close()
    finally:
        proxy.close()


# -- KillCoordinator on the port's native server -------------------------------


@pytest.fixture
def native():
    from edl_tpu_torch.coord import bindings

    try:
        bindings.ensure_built()
    except Exception as exc:  # no C++ toolchain in this environment
        pytest.skip(f"the native coordinator does not build here: {exc}")


def test_kill_coordinator_respawns_from_the_state_file(native, tmp_path):
    """The non-HA drill: SIGKILL the server, respawn it from its state
    file, retarget the proxy; the client through the proxy reads the state
    back and the probe answers, so the recovery completes."""
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.coord.server import spawn_server

    state = str(tmp_path / "coord.state")
    handles = [spawn_server(state_file=state)]
    proxy = tfaults.ChaosProxy(("127.0.0.1", handles[0].port))
    client = CoordClient("127.0.0.1", proxy.port, timeout=2.0,
                         reconnect_window_s=20.0)

    def restart():
        handles[-1].process.kill()
        handles[-1].process.wait(timeout=10)
        handles.append(spawn_server(state_file=state))
        proxy.set_upstream("127.0.0.1", handles[-1].port)

    try:
        client.kv_set("k", b"v")
        client.add_task(b"t")
        engine = tfaults.FaultPlanEngine(
            tfaults.FaultPlan([tfaults.KillCoordinator(at_step=1)]),
            tfaults.FaultContext(coord=client, proxy=proxy,
                                 restart_coordinator=restart))
        engine(1)
        assert client.kv_get("k") == b"v"
        assert client.stats().todo == 1
        engine(2)
        assert engine.recovered == ["kill_coordinator"]
        assert handles[0].process.returncode == -9
    finally:
        client.close()
        proxy.close()
        for h in handles:
            h.stop()


def test_ha_kill_coordinator_drill(native, tmp_path):
    """test_coord_ha.py's drill: the primary of the port's HA pair is
    SIGKILLed; the recovery is the multi-endpoint client's observed
    failover with zero world reforms."""
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.coord.server import spawn_ha_pair

    pr, sb = spawn_ha_pair(str(tmp_path), repl_lease_ms=1000)
    c = CoordClient("127.0.0.1", pr.port, timeout=2.0,
                    reconnect_window_s=12.0, promote_grace_s=0.2,
                    endpoints=[("127.0.0.1", sb.port)])

    def kill9():
        pr.process.kill()
        pr.process.wait(timeout=10)

    try:
        c.kv_set("k", b"v")
        ctx = tfaults.FaultContext(coord=c, ha=True, kill_primary=kill9)
        engine = tfaults.FaultPlanEngine(
            tfaults.FaultPlan([tfaults.KillCoordinator(at_step=1)]), ctx)
        before_reforms = counters().total("world_reforms")
        before_failovers = counters().total("coord_failovers")
        engine(step=1)
        deadline = time.monotonic() + 15
        while not engine.quiescent() and time.monotonic() < deadline:
            assert c.kv_get("k") == b"v"
            engine.tick()
            time.sleep(0.05)
        assert engine.recovered == ["kill_coordinator"]
        assert counters().total("coord_failovers") > before_failovers
        assert counters().total("world_reforms") == before_reforms
        assert counters().total("coord_ha_reform_leaks") == 0
    finally:
        c.close()
        pr.stop()
        sb.stop()


# -- the soak: all eight kinds from one seed against a Controller-run job -------


def _data(shards: int, rows: int):
    return tw.synthetic_classification(n=shards * rows, seed=3)


def control_losses(data: tuple, shards: int, order: list) -> list:
    """A one-rank trainer from the same init fed rank 0's batches in the
    order it trained them (each leased shard's rows, 64 at a time)."""
    reg = ShardRegistry()
    ids = reg.register_arrays(data, num_shards=shards)
    trainer = tw._mlp_from(MLP_PARAMS, 1)
    losses = []
    for shard in order:
        x, y = reg.get(ids[shard])
        for lo in range(0, len(x) - 63, 64):
            losses.append(trainer.step((x[lo:lo + 64], y[lo:lo + 64])))
    return losses


def _soak(tmp_path_factory, soak: dict, rows: int):
    data = _data(soak["shards"], rows)
    got = tw.run("controlled", 2, tmp_path_factory.mktemp("soak"),
                 WORLD_DEADLINE_S, mlp_params=MLP_PARAMS, data=data,
                 seed=SOAK_SEED, soak=soak)
    return got, data


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    return _soak(tmp_path_factory, SOAK, 64)


def check_campaign(got: list, data: tuple, soak: dict) -> None:
    """The acceptance drill's gates on one campaign's result."""
    r0, r1 = tw.scenario(got, "campaign")
    kinds = set(tfaults.TRAINING_KINDS)
    assert r0["plan"] == jfaults.FaultPlan.random(
        SOAK_SEED, n_faults=8, first_step=soak["first_step"],
        last_step=soak["last_step"], min_gap=soak["min_gap"]).describe()
    assert {d["kind"] for d in r0["plan"]} == kinds
    # every action fired, every engine-watched recovery completed
    assert r0["quiescent"], (r0["unfired"], r0["recovered"])
    assert [k for _, k in r0["fired"]] == [d["kind"] for d in r0["plan"]]
    assert all(n >= 1 for n in r0["injected"].values()), r0["injected"]
    for kind in ("kill_trainer", "kill_coordinator", "network_flake",
                 "preempt_domain", "stall_step", "wedge_collective",
                 "corrupt_checkpoint", "disk_full"):
        assert r0["recovered"][kind] >= 1, kind
    # the fallback restore landed on a step that re-verifies
    assert len(r0["audit"]) == 1 and r0["audit"][0]["hash_ok"] is True
    assert [ok for _, _, ok in r0["saves"]].count(False) == 1  # disk full
    # both quiet faults seen, each within 2x the deadline then in force
    assert len(r0["stalls"]) == 2 and None not in r0["stalls"]
    for silent_s, deadline_s in r0["stalls"]:
        assert silent_s <= 2 * deadline_s, r0["stalls"]
    # exactly-once accounting through the coordinator's kill and respawn
    assert r0["stats"] == dict(done=soak["shards"], todo=0, leased=0,
                               dropped=0)
    assert r0["steps"] >= soak["shards"]
    assert r0["step_of_trainer"] == r0["steps"]
    assert sorted(set(r0["order"])) == list(range(soak["shards"]))
    # the autoscaler alone grew the job after the release and shrank it
    # after the return
    worlds = r0["worlds"]
    assert r1["worlds"] == worlds
    assert worlds[0] == 1 and 2 in worlds[soak["release_at"]:]
    assert worlds[-1] == 1 and r0["resizes"] >= 2
    assert [t["default/soak"] for t in r0["ticks"]][:2] == [2, 1]
    # the losses learn and are the one-rank control's
    losses = np.asarray(r0["losses"])
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    np.testing.assert_allclose(
        losses, control_losses(data, soak["shards"], r0["order"]),
        atol=CONTROL_ATOL, rtol=0)
    assert [x is None for x in r1["losses"]] == [w == 1 for w in worlds]
    # every coordinator the campaign spawned is gone
    assert r0["leaked"] == 0


def test_seeded_campaign_of_the_eight_kinds(soak):
    check_campaign(*soak, SOAK)


def test_a_kill_that_empties_the_running_set_waits_for_the_replacement(soak):
    """The only trainer is killed while another tenant holds the card: the
    job waits (no step at world 0) until the card comes back, then trains
    every task."""
    r0, r1 = tw.scenario(soak[0], "replacement")
    for g in (r0, r1):
        assert g["steps"] == 32 and set(g["worlds"]) == {1}
    assert len(r0["waited"]) == 1 and r0["waited"][0] >= 0.5


def test_a_replacement_that_never_comes_raises_on_every_rank(soak):
    r0, r1 = tw.scenario(soak[0], "no_replacement")
    assert r0["raised"] == "RuntimeError"
    assert "running after 0.5 s" in r0["message"]
    assert r1["raised"] == "RankZeroFailed"
    assert tw.scenario(soak[0], "after_error") == [3.0, 3.0]


def test_flagship_controlled_job_at_tiny(soak):
    """chip_smoke's phase (t) at TINY on the CPU: the same entry points,
    campaign and card schedule on the transformer."""
    r0, r1 = tw.scenario(soak[0], "flagship_controlled")
    assert [k for _, k in r0["fired"]] == [
        d["kind"] for d in tfaults.FaultPlan.random(
            SOAK_SEED, n_faults=8, first_step=SOAK["first_step"],
            last_step=SOAK["last_step"], min_gap=SOAK["min_gap"]).describe()]
    assert r0["quiescent"] and r0["leaked"] == 0
    assert r0["stats"] == dict(done=SOAK["shards"], todo=0, leased=0,
                               dropped=0)
    assert r1["worlds"] == r0["worlds"]
    assert r0["worlds"][0] == 1 and 2 in r0["worlds"]
    assert r0["worlds"][-1] == 1
    assert np.isfinite(r0["losses"]).all()


@pytest.mark.slow
@pytest.mark.timeout_s(600)
def test_reference_size_campaign_soak(tmp_path_factory):
    """The reference's soak size: 32 tasks of 256 rows (128 steps), the
    eight faults between steps 10 and 100."""
    got, data = _soak(tmp_path_factory, SLOW_SOAK, 256)
    check_campaign(got, data, SLOW_SOAK)
