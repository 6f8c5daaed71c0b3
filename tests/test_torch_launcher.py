"""The port's launcher (edl_tpu_torch.runtime.launcher): the launcher
half of tests/test_launcher_discovery.py on the port — exit classification
and the termination log, the failed-trainer guard, the entry's exit codes,
the fault-tolerant trainer against the port's native coordination server,
the pserver role, the env-reading dispatch, and the static barrier path
with its pod-API and EDL_STATIC_PEERS backends — plus the pure helpers
against the JAX package's."""

import pytest

from edl_tpu.runtime import launcher as ref_launcher
from edl_tpu_torch.api.types import (
    RESOURCE_CPU, RESOURCE_GPU, RESOURCE_MEMORY,
    ResourceRequirements, TrainerSpec, TrainingJob, TrainingJobSpec,
)
from edl_tpu_torch.cluster.base import PodPhase
from edl_tpu_torch.cluster.fake import FakeCluster
from edl_tpu_torch.runtime.discovery import PodDiscovery
from edl_tpu_torch.runtime import launcher


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


@pytest.mark.parametrize("code", [0, 1, 2, 134, 136, 137, 139, -9])
def test_classify_exit_equals_the_reference(code):
    assert launcher.classify_exit(code) == ref_launcher.classify_exit(code)


@pytest.mark.parametrize("env", [
    {"EDL_COORD_ENDPOINT": "svc:9000"}, {"EDL_COORD_ENDPOINT": "svc"},
    {"EDL_COORD_HOST": "h"}, {"EDL_COORD_ENDPOINT": "a:1",
                              "EDL_COORD_HOST": "b"},
    {"EDL_COORD_ENDPOINT": "j-coordinator.ns.svc:7164"}])
def test_resolve_coordinator_endpoint_equals_the_reference(env):
    assert launcher.resolve_coordinator_endpoint(env, 7164) == \
        ref_launcher.resolve_coordinator_endpoint(env, 7164)


class TestLauncher:
    def test_classify_exit(self):
        assert launcher.classify_exit(139) == "Segmentation fault (core dumped)"
        assert launcher.classify_exit(136).startswith("Floating point")
        assert launcher.classify_exit(134).startswith("Aborted")
        assert launcher.classify_exit(0) is None
        assert launcher.classify_exit(1) is None

    def test_termination_log(self, tmp_path):
        p = tmp_path / "term.log"
        launcher.write_termination_log(139, str(p))
        assert "Segmentation fault" in p.read_text()
        launcher.write_termination_log(0, str(p / "never"))  # no-op

    def test_check_failed_cnt(self):
        c = _cluster()
        job = _submit(c)
        d = PodDiscovery(c, job.full_name, poll_s=0.0)
        assert not launcher.check_failed_cnt(d, 0)
        # FakeCluster's Job controller re-creates failed pods; count both
        pod = c.list_pods(job_uid=job.full_name)[0]
        pod.phase = PodPhase.FAILED  # fail without reconcile
        assert launcher.check_failed_cnt(d, 0)
        assert not launcher.check_failed_cnt(d, 3)

    def test_run_entry_ok_and_crash(self, tmp_path):
        assert launcher.run_entry("true") == 0
        marker = tmp_path / "ws" ; marker.mkdir()
        code = launcher.run_entry("pwd > out.txt", workspace=str(marker))
        assert code == 0
        assert str(marker) in (marker / "out.txt").read_text()
        assert launcher.run_entry("exit 7") == 7

    def test_start_trainer_end_to_end(self, tmp_path):
        """FT trainer startup against a live coordination server."""
        from edl_tpu_torch.coord.server import spawn_server

        handle = spawn_server(port=0)
        try:
            out = tmp_path / "env.txt"
            code = launcher.start_trainer(
                coord_host="127.0.0.1", coord_port=handle.port,
                entry=f'echo "$EDL_COORD_HOST:$EDL_COORD_PORT '
                      f'$EDL_WORKER_NAME" > {out}',
                worker_name="trainer-0", wait_timeout_s=10.0,
            )
            assert code == 0
            text = out.read_text()
            assert f"127.0.0.1:{handle.port}" in text
            assert "trainer-0" in text
            # worker left membership on exit
            client = handle.client()
            _, members = client.members()
            assert members == []
            client.close()
        finally:
            handle.stop()

    def test_main_dispatch_unknown(self, capsys):
        assert launcher.main(["bogus"]) == 2
        assert launcher.main([]) == 2

    def test_main_trainer_without_coord_env_fails_loudly(self, monkeypatch,
                                                         capsys):
        monkeypatch.delenv("EDL_COORD_ENDPOINT", raising=False)
        monkeypatch.delenv("EDL_COORD_HOST", raising=False)
        assert launcher.main(["start_trainer"]) == 2
        assert "no coordinator address" in capsys.readouterr().err

    def test_resolve_coordinator_endpoint(self):
        r = launcher.resolve_coordinator_endpoint
        assert r({"EDL_COORD_ENDPOINT": "svc:9000"}, 7164) == ("svc", 9000)
        assert r({"EDL_COORD_ENDPOINT": "svc"}, 7164) == ("svc", 7164)
        assert r({"EDL_COORD_HOST": "h"}, 7164) == ("h", 7164)
        # endpoint wins over host
        assert r({"EDL_COORD_ENDPOINT": "a:1", "EDL_COORD_HOST": "b"},
                 7164) == ("a", 1)
        with pytest.raises(ValueError):
            r({}, 7164)

    def test_start_pserver_joins_and_leaves(self):
        from edl_tpu_torch.coord.server import spawn_server

        handle = spawn_server(port=0)
        try:
            client = handle.client()
            seen = []

            def park():
                _, members = client.members()
                seen.append(members)

            code = launcher.start_pserver(
                coord_host="127.0.0.1", coord_port=handle.port,
                worker_name="ps0", wait_timeout_s=10.0, park=park)
            assert code == 0
            assert seen and seen[0][0][0] == "pserver/ps0"
            _, members = client.members()
            assert members == []  # left on exit
            client.close()
        finally:
            handle.stop()


class TestStaticVerbDispatch:
    def test_jobparser_emits_static_verb_for_non_ft(self):
        """The reference switches start_new_trainer vs start_trainer v2 on
        fault_tolerant (pkg/jobparser.go:124); the compiled command must
        switch the same way."""
        from edl_tpu_torch.api.types import (ResourceRequirements,
                                             TrainerSpec, TrainingJob,
                                             TrainingJobSpec)
        from edl_tpu_torch.controller.jobparser import parse_to_trainer

        def job(ft):
            return TrainingJob(name="j", spec=TrainingJobSpec(
                fault_tolerant=ft,
                trainer=TrainerSpec(entrypoint="true", min_instance=2,
                                    max_instance=2,
                                    resources=ResourceRequirements())))

        cmd_ft = parse_to_trainer(job(True))["spec"]["template"]["spec"][
            "containers"][0]["command"]
        cmd_static = parse_to_trainer(job(False))["spec"]["template"][
            "spec"]["containers"][0]["command"]
        assert cmd_ft[-1] == "start_trainer"
        assert cmd_static[-1] == "start_static_trainer"

    def test_main_static_trainer_runs_entry_with_rank(self, tmp_path,
                                                      monkeypatch):
        """`launcher start_static_trainer` under the EDL_* env contract:
        barrier on the pod count, rank from the sorted pod list, entry
        exec'd with EDL_TRAINER_ID/TRAINERS/ADDRESSES exported."""
        from edl_tpu_torch.cluster.base import PodPhase
        from edl_tpu_torch.cluster.fake import FakeCluster, FakePod
        from edl_tpu_torch.runtime.discovery import PodDiscovery

        fake = FakeCluster()
        for i in range(2):
            fake._pods[f"j-trainer-{i}"] = FakePod(
                name=f"j-trainer-{i}", job_uid="default/j", role="trainer",
                phase=PodPhase.RUNNING, node="n0")
        monkeypatch.setattr(
            launcher, "_pod_discovery_from_env",
            lambda env: PodDiscovery(fake, "default/j"))
        out = tmp_path / "env.txt"
        monkeypatch.setenv("EDL_JOB_NAME", "j")
        monkeypatch.setenv("EDL_POD_NAME", "j-trainer-1")
        monkeypatch.setenv("EDL_TRAINER_MIN", "2")
        monkeypatch.setenv(
            "EDL_ENTRY",
            f'echo "$EDL_TRAINER_ID/$EDL_TRAINERS $EDL_TRAINER_ADDRESSES"'
            f' > {out}')
        assert launcher.main(["start_static_trainer"]) == 0
        text = out.read_text()
        assert "1/2" in text
        assert "j-trainer-0,j-trainer-1" in text

    def test_main_static_trainer_env_peers_backend(self, tmp_path,
                                                   monkeypatch):
        """EDL_STATIC_PEERS gives the static path a discovery backend
        without a kubernetes client (harness / bare-metal runs): rank
        from the sorted names, addresses from the peer spec."""
        out = tmp_path / "env.txt"
        monkeypatch.setenv("EDL_JOB_NAME", "j")
        monkeypatch.setenv("EDL_POD_NAME", "p-b")
        monkeypatch.setenv("EDL_TRAINER_MIN", "2")
        monkeypatch.setenv("EDL_STATIC_PEERS",
                           "p-b=10.0.0.2,p-a=10.0.0.1")
        monkeypatch.setenv(
            "EDL_ENTRY",
            f'echo "$EDL_TRAINER_ID/$EDL_TRAINERS $EDL_TRAINER_ADDRESSES"'
            f' > {out}')
        assert launcher.main(["start_static_trainer"]) == 0
        assert out.read_text().strip() == "1/2 10.0.0.1,10.0.0.2"

    def test_trainer_manifest_carries_downward_identity(self):
        """EDL_POD_NAME/EDL_POD_IP come from the downward API — HOSTNAME
        is the node's name under hostNetwork and cannot be the identity."""
        from edl_tpu_torch.api.types import (ResourceRequirements,
                                             TrainerSpec, TrainingJob,
                                             TrainingJobSpec)
        from edl_tpu_torch.controller.jobparser import parse_to_trainer

        job = TrainingJob(name="j", spec=TrainingJobSpec(
            fault_tolerant=False, host_network=True,
            trainer=TrainerSpec(entrypoint="true", min_instance=1,
                                max_instance=1,
                                resources=ResourceRequirements())))
        env = parse_to_trainer(job)["spec"]["template"]["spec"][
            "containers"][0]["env"]
        by_name = {e["name"]: e for e in env}
        assert by_name["EDL_POD_NAME"]["valueFrom"][
            "fieldRef"]["fieldPath"] == "metadata.name"
        assert by_name["EDL_POD_IP"]["valueFrom"][
            "fieldRef"]["fieldPath"] == "status.podIP"
