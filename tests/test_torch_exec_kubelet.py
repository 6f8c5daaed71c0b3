"""The port's deployed control plane meets real pod processes: the scenarios
of tests/test_exec_kubelet_e2e.py and test_fault_campaign.py's kubelet
teardown race on edl_tpu_torch.cluster.exec_kubelet.ProcessKubelet, run on
the CPU.

The headline is chip_smoke's phase (y) (``entry.kubelet_campaign``) with
the MLP on the CPU: a TrainingJob CR in the stub apiserver (through the
port's K8sCluster, tests/k8s_stub.py) → the port's TrainingJobSyncLoop →
Controller → FakeCluster pods → the kubelet execs the port jobparser's
commands (``python -m edl_tpu_torch.runtime.launcher start_trainer``,
``python -m edl_tpu_torch.coord.server``) → supervised workers form a
world of 1, the autoscaler grows it to 2, a KillTrainer through the kubelet
SIGKILLs a trainer pod (replaced, the world of 2 re-forms from the newest
generation), a KillCoordinator kills the coordinator pod (respawned on its
state file), the queue drains exactly once, the CR records Succeeded, and
deleting it leaves no process behind.
"""

from __future__ import annotations

import glob
import os
import re
import socket
import subprocess
import threading
import time

import pytest

from edl_tpu_torch.cluster.base import PodPhase
from edl_tpu_torch.cluster.exec_kubelet import ProcessKubelet
from edl_tpu_torch.cluster.fake import FakeCluster, FakePod
from edl_tpu_torch.controller.controller import Controller
from edl_tpu_torch.controller.sync import TrainingJobSyncLoop
from edl_tpu_torch.entry import kubelet_campaign, kubelet_job_manifest

from tests.torch_k8s import port_kube  # noqa: F401

#: harness knobs over every pod's env (not the contract under test): a free
#: health port, worlds that die with their supervisor, the member TTL and
#: task timeout of the coordinator, one thread each
KUBELET_ENV = {"EDL_HEALTH_PORT": "0", "EDL_MH_DIE_WITH_PARENT": "1",
               "EDL_COORD_MEMBER_TTL_MS": "3000",
               "EDL_COORD_TASK_TIMEOUT_MS": "4000",
               "EDL_MH_WARM_SPAWN": "0", "OMP_NUM_THREADS": "1"}
#: the supervisors' settle, longer than the member TTL (a killed pod's
#: prune and its replacement's join land in one plan)
WORKER = "--settle-s 4 --heartbeat-timeout-s 5 --model mlp --device cpu"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mlp_env(tasks: int, **kw) -> dict:
    env = dict(EDL_MH_EXAMPLES=tasks * 32, EDL_MH_SHARDS=tasks,
               EDL_MH_BATCH=32, EDL_MH_CKPT_EVERY=2, EDL_MH_STEP_SLEEP=0.05,
               EDL_MH_DIGEST=1)
    env.update(kw)
    return env


@pytest.mark.timeout_s(240)
def test_cr_to_succeeded_through_real_pods(port_kube, tmp_path):
    """chip_smoke's phase (y) at the MLP on the CPU, every gate of
    ``kubelet_campaign``, the CR in the stub apiserver."""
    k8s_mod, state = port_kube
    store = k8s_mod.K8sCluster(kubeconfig="ignored")
    manifest = kubelet_job_manifest(
        "cpu-kubelet", free_port(), str(tmp_path / "ckpt"), WORKER,
        mlp_env(24))
    out = kubelet_campaign(store, str(tmp_path / "kubelet"), manifest,
                           kubelet_env=KUBELET_ENV, timeout_s=200)
    assert out["stats"].done == 24
    assert [w for _, w in out["worlds"]][:2] == [1, 2]
    assert out["victims"] and out["replacement"]
    assert out["pods"][out["victims"][0]] == "Failed"
    assert "Succeeded" in out["status_end"]
    assert "recorded by controller" in out["status_after_grow"]
    assert out["exit_codes"][out["victims"][0]] == -9
    assert out["losses"][1] < out["losses"][0]
    for key in ("submit_to_world1_s", "grow_to_world2_s",
                "kill_to_world2_s", "coord_kill_to_task_s"):
        assert 0 < out[key] < 200, (key, out[key])
    # the CR is gone from the apiserver; nothing of the job is left
    assert store.get_training_job_cr("cpu-kubelet") is None
    assert not state.custom_objects


def test_static_non_ft_job_runs_through_kubelet(tmp_path):
    """A NON-fault-tolerant job: the jobparser emits `launcher
    start_static_trainer`, the kubelet execs it with the job's peer set,
    every pod computes its rank from the sorted pod list, runs the entry,
    and the job Succeeds (role of the reference's start_trainer v2,
    docker/paddle_k8s:143-226)."""
    from edl_tpu_torch.api.serde import job_from_dict
    from edl_tpu_torch.api.types import JobPhase

    fake = FakeCluster()
    fake.add_node("host0", cpu_milli=16000, memory_mega=16000, gpus=8)
    controller = Controller(fake, updater_convert_seconds=0.3,
                            updater_confirm_seconds=0.2)
    work = str(tmp_path)
    kubelet = ProcessKubelet(fake, work)
    ranks = os.path.join(work, "ranks")
    os.makedirs(ranks, exist_ok=True)
    job = job_from_dict({
        "apiVersion": "edl.tpu/v1", "kind": "TrainingJob",
        "metadata": {"name": "static"},
        "spec": {
            "image": "edl-tpu-job:latest",
            "fault_tolerant": False,
            "trainer": {
                "entrypoint": (
                    f'echo "$EDL_TRAINER_ID/$EDL_TRAINERS '
                    f'$EDL_TRAINER_ADDRESSES" '
                    f'> {ranks}/$EDL_POD_NAME && sleep 0.5'),
                "min_instance": 3, "max_instance": 3,
                "resources": {"requests": {"cpu": "500m",
                                           "memory": "256Mi"},
                              "limits": {"cpu": "1", "memory": "512Mi",
                                         "nvidia.com/gpu": "1"}},
            },
        },
    })
    try:
        controller.submit(job)
        updater = controller.get_updater(job)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if updater.job.status.phase in (JobPhase.SUCCEEDED,
                                            JobPhase.FAILED):
                break
            time.sleep(0.25)
        assert updater.job.status.phase == JobPhase.SUCCEEDED, (
            updater.job.status)
        files = sorted(os.listdir(ranks))
        assert len(files) == 3, files
        seen = {}
        for f in files:
            rank_world, peers = open(os.path.join(ranks, f)
                                     ).read().split(" ", 1)
            rank, world = rank_world.split("/")
            seen[f] = (int(rank), int(world), peers.strip())
        assert sorted(r for r, _w, _p in seen.values()) == [0, 1, 2]
        assert {w for _r, w, _p in seen.values()} == {3}
        assert len({p for _r, _w, p in seen.values()}) == 1
        peers = next(iter(seen.values()))[2].split(",")
        for f, (rank, _w, _p) in seen.items():
            assert peers[rank] == f
        # every static pod ran the port's launcher
        assert {tuple(s.command[1:]) for s in kubelet.spawned} == {
            ("-m", "edl_tpu_torch.runtime.launcher", "start_static_trainer")}
    finally:
        controller.stop()
        kubelet.stop()


@pytest.mark.timeout_s(240)
def test_coordinator_pod_respawn_preserves_state(tmp_path):
    """kill -9 the coordinator POD mid-training: the ReplicaSet analogue
    respawns it on the same state volume (PVC semantics), the workers
    redial, and the job still drains exactly once (role of the etcd
    sidecar's persistence, reference pkg/jobparser.go:167-184)."""
    import signal

    from edl_tpu_torch.api.serde import job_from_dict
    from edl_tpu_torch.api.types import JobPhase
    from edl_tpu_torch.coord.client import CoordClient, CoordError

    fake = FakeCluster()
    fake.add_node("host0", cpu_milli=16000, memory_mega=16000, gpus=8)
    controller = Controller(fake, updater_convert_seconds=0.3,
                            updater_confirm_seconds=0.2)
    work = str(tmp_path)
    kubelet = ProcessKubelet(fake, work, env_overrides=KUBELET_ENV)
    port = free_port()
    tasks = 48
    manifest = kubelet_job_manifest("ckill", port, os.path.join(work, "ckpt"),
                                    WORKER, mlp_env(tasks))
    manifest["spec"]["trainer"]["max_instance"] = 2
    manifest["spec"]["trainer"]["min_instance"] = 2
    job = job_from_dict(manifest)

    def tlog_text():
        return "".join(open(p).read() for p in glob.glob(
            os.path.join(work, "logs", "ckill-trainer-*.log")))

    def raw_stats(timeout_s=10.0):
        """One unfiltered snapshot, retrying only the connection."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                c = CoordClient("127.0.0.1", port, timeout=2.0,
                                reconnect_window_s=1.0)
                try:
                    return c.stats()
                finally:
                    c.close()
            except (OSError, CoordError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)

    try:
        controller.submit(job)
        deadline = time.monotonic() + 150
        while "step 4 " not in tlog_text():
            assert time.monotonic() < deadline, "training never started"
            time.sleep(0.2)
        deadline = time.monotonic() + 60
        while raw_stats().done == 0:
            assert time.monotonic() < deadline, "no shard ever completed"
            time.sleep(0.2)
        done_before = raw_stats().done
        coord_pod = [p for p in kubelet.live_pods()
                     if "-coordinator-" in p][0]
        assert kubelet.signal_pod(coord_pod, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            live = [p for p in kubelet.live_pods() if "-coordinator-" in p]
            if live and live != [coord_pod]:
                break
            time.sleep(0.2)
        live = [p for p in kubelet.live_pods() if "-coordinator-" in p]
        assert live and live != [coord_pod], "coordinator never respawned"
        # the respawned coordinator restored the queue from the job volume:
        # its first snapshot still holds the pre-kill completions
        after = raw_stats(timeout_s=30.0)
        assert after.done >= done_before, (after, done_before)
        updater = controller.get_updater(job)
        final = after
        deadline = time.monotonic() + 150
        while final.done < tasks and time.monotonic() < deadline:
            time.sleep(0.3)
            final = raw_stats(timeout_s=30.0)
        assert final.done == tasks and final.dropped == 0, final
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if updater.job.status.phase in (JobPhase.SUCCEEDED,
                                            JobPhase.FAILED):
                break
            time.sleep(0.3)
        assert updater.job.status.phase == JobPhase.SUCCEEDED, (
            updater.job.status)
    finally:
        controller.stop()
        kubelet.stop()


def test_kubelet_reaps_pod_spawned_during_stop(tmp_path, monkeypatch):
    """A pod registered by an in-flight ``_start_pod`` after ``stop()``'s
    sweep is still reaped (tests/test_fault_campaign.py:354)."""
    from edl_tpu_torch.cluster import exec_kubelet as ek

    cluster = FakeCluster()
    kubelet = ek.ProcessKubelet(cluster, str(tmp_path))
    pod = FakePod(name="ghost", job_uid="default/j", role="trainer",
                  phase=PodPhase.RUNNING)
    cluster._pods["ghost"] = pod
    monkeypatch.setattr(
        kubelet, "_container_for",
        lambda p: {"command": ["sleep", "60"], "env": {}, "volumes": [],
                   "mounts": {}})
    monkeypatch.setattr(kubelet, "_pod_env",
                        lambda p, c: dict(os.environ))
    entered, release = threading.Event(), threading.Event()
    real_popen = subprocess.Popen
    spawned = []

    def gated_popen(*args, **kwargs):
        entered.set()
        release.wait(10)  # hold the spawn past stop()'s kill sweep
        proc = real_popen(*args, **kwargs)
        spawned.append(proc)
        return proc

    monkeypatch.setattr(ek.subprocess, "Popen", gated_popen)
    t = threading.Thread(target=kubelet._start_pod, args=(pod,))
    t.start()
    assert entered.wait(10)
    stopper = threading.Thread(target=kubelet.stop)
    stopper.start()
    time.sleep(0.3)  # stop() sets _stop and sweeps (ghost not registered)
    release.set()  # the racing spawn lands NOW
    t.join(timeout=15)
    stopper.join(timeout=15)
    assert not t.is_alive() and not stopper.is_alive()
    assert spawned, "the gated spawn never ran"
    proc = spawned[0]
    deadline = time.monotonic() + 5
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert proc.poll() is not None, "pod process leaked through stop()"
    assert "ghost" not in kubelet._procs


def test_pod_sandbox_env(tmp_path):
    """What the kubelet adds around the manifest's env: the port's package
    root on PYTHONPATH, `python` resolving to this interpreter, the
    pod's identity, `*.svc` endpoints on this machine, and volume paths
    moved to the job's host directory."""
    from edl_tpu_torch.api.serde import job_from_dict

    fake = FakeCluster()
    fake.add_node("host0", cpu_milli=16000, memory_mega=16000, gpus=2)
    kubelet = ProcessKubelet(fake, str(tmp_path))
    try:
        job = job_from_dict(kubelet_job_manifest(
            "env", 7301, str(tmp_path / "ckpt"), WORKER, mlp_env(4)))
        fake.create_resources(job)
        pod = FakePod(name="env-trainer-9", job_uid=job.full_name,
                      role="trainer", phase=PodPhase.RUNNING)
        container = kubelet._container_for(pod)
        env = kubelet._pod_env(pod, container)
        assert container["command"] == [
            "python", "-m", "edl_tpu_torch.runtime.launcher",
            "start_trainer"]
        assert (env["EDL_POD_NAME"], env["EDL_POD_IP"], env["HOSTNAME"]) \
            == ("env-trainer-9", "127.0.0.1", "env-trainer-9")
        assert env["EDL_COORD_ENDPOINT"] == "127.0.0.1:7301"
        assert env["EDL_COMPILE_CACHE"].startswith(
            os.path.join(str(tmp_path), "volumes", "default_env",
                         "edl-compile-cache"))
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            __import__("edl_tpu_torch").__file__)))
        assert env["PYTHONPATH"].split(os.pathsep)[0] == root
        out = subprocess.run(
            ["sh", "-c", "python -c 'import sys; print(sys.executable)'"],
            env=env, capture_output=True, text=True, check=True)
        import sys

        assert out.stdout.strip() == sys.executable
    finally:
        kubelet.stop()


_SOAK_S = float(os.environ.get("EDL_KUBELET_SOAK_S", "600"))


@pytest.mark.slow
@pytest.mark.timeout_s(_SOAK_S + 480)
def test_kubelet_endurance_soak(port_kube, tmp_path):
    """Endurance churn under the port's deployed exec path: repeated
    trainer-pod kills and autoscaler-driven resizes for
    ``EDL_KUBELET_SOAK_S`` (default 600 s); at the end no FD leak in the
    harness, the coordinator pod's RSS bounded, the checkpoint directory
    bounded, every world entered at a non-decreasing step, and every
    supervisor's goodput ledger conserving."""
    import random
    import signal as _signal

    k8s_mod, state = port_kube
    cr_store = k8s_mod.K8sCluster(kubeconfig="ignored")
    fake = FakeCluster()
    fake.add_node("host0", cpu_milli=16000, memory_mega=16000, gpus=8)
    controller = Controller(fake, autoscaler_loop_seconds=0.3,
                            updater_convert_seconds=0.5,
                            updater_confirm_seconds=0.2)
    sync = TrainingJobSyncLoop(cr_store, controller, poll_seconds=0.2)
    work = str(tmp_path)
    kubelet = ProcessKubelet(fake, work, term_grace_s=25.0,
                             env_overrides=KUBELET_ENV)
    name = "soak"
    manifest = kubelet_job_manifest(
        name, free_port(), os.path.join(work, "ckpt"), WORKER,
        mlp_env(2048, EDL_MH_EXAMPLES=1024 * 1024, EDL_MH_CKPT_EVERY=25,
                EDL_MH_STEP_SLEEP=0.08))
    manifest["spec"]["trainer"]["max_instance"] = 4
    ckpt_dir = os.path.join(work, "ckpt")

    def trainer_logs() -> list[str]:
        return sorted(glob.glob(
            os.path.join(work, "logs", f"{name}-trainer-*.log")))

    def log_text() -> str:
        return "".join(open(p).read() for p in trainer_logs())

    def logged_worlds() -> list[tuple[int, int, int]]:
        entries = []
        for path in trainer_logs():
            for m in re.finditer(
                    r"entering world epoch=(\d+) world=(\d+)"
                    r"(?: digest=\S+)? at step=(\d+)", open(path).read()):
                entries.append((int(m.group(1)), int(m.group(2)),
                                int(m.group(3))))
        entries.sort()
        return entries

    def open_fds() -> int:
        return len(os.listdir("/proc/self/fd"))

    def rss_kb(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1])
        except OSError:
            pass
        return 0

    rng = random.Random(20260804)
    sync.start()
    try:
        cr_store.create_training_job_cr(manifest)
        deadline = time.monotonic() + 240
        while not any(w >= 1 for _e, w, _s in logged_worlds()):
            assert time.monotonic() < deadline, "initial world never formed"
            time.sleep(0.5)
        controller.start()
        fds_base = open_fds()
        coord_pod = [p for p in kubelet.live_pods()
                     if "-coordinator-" in p]
        coord_pid = kubelet.pid_of(coord_pod[0]) if coord_pod else None
        rss_base = rss_kb(coord_pid) if coord_pid else 0
        t_end = time.monotonic() + _SOAK_S
        kill_every = min(max(_SOAK_S / 8.0, 25.0), 90.0)
        toggle_every = min(max(_SOAK_S / 6.0, 35.0), 120.0)
        next_kill = time.monotonic() + kill_every
        next_toggle = time.monotonic() + toggle_every
        contended = False
        kills = toggles = 0
        while time.monotonic() < t_end:
            now = time.monotonic()
            if now >= next_kill:
                live = [p for p in kubelet.live_pods() if "-trainer-" in p]
                if live:
                    kubelet.signal_pod(rng.choice(live), _signal.SIGKILL)
                    kills += 1
                next_kill = now + kill_every
            if now >= next_toggle:
                if contended:
                    for i in range(4):
                        fake.remove_system_pod(f"burst-{i}")
                else:
                    for i in range(4):
                        fake.add_system_pod(f"burst-{i}", "host0",
                                            cpu_request_milli=2000,
                                            memory_request_mega=100)
                contended = not contended
                toggles += 1
                next_toggle = now + toggle_every
            time.sleep(0.5)
        assert kills >= 2 and toggles >= 1, (kills, toggles)
        assert open_fds() <= fds_base + 32, (fds_base, open_fds())
        if coord_pid and rss_kb(coord_pid) > 0:
            assert rss_kb(coord_pid) <= rss_base * 3 + 100_000
        try:
            ents = os.listdir(ckpt_dir)
        except OSError:
            ents = []
        per_gen = [e for e in ents if e.startswith(("gen-", "mid-",
                                                    "result-"))]
        assert len(per_gen) <= 40, sorted(per_gen)
        cr_store.delete_training_job_cr(name)
        deadline = time.monotonic() + 180
        while controller.jobs() or kubelet.live_pods():
            assert time.monotonic() < deadline, kubelet.live_pods()
            time.sleep(0.5)
        worlds = logged_worlds()
        assert len(worlds) >= 3, worlds
        steps = [s for _e, _w, s in worlds]
        assert steps == sorted(steps), worlds
        assert any(w >= 2 for _e, w, _s in worlds), worlds
        lines = re.findall(r"goodput_ledger .*", log_text())
        assert lines, "no supervisor printed its goodput ledger"
        for line in lines:
            assert "conserves=1" in line, line
            m = re.search(r"fraction=([0-9.]+)", line)
            assert m and 0.0 <= float(m.group(1)) <= 1.0, line
    finally:
        sync.stop()
        controller.stop()
        kubelet.stop()
