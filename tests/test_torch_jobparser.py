"""The port's jobparser against the JAX package's: the same job, read by
each package's serde, compiles to the same manifests for every role —
trainer, coordinator, its Service, pserver, server group and its Service —
apart from an explicit list of differences, and every command the port
compiles runs the port's modules."""

from __future__ import annotations

import copy

import pytest

from edl_tpu.api import serde as ref_serde
from edl_tpu.controller import jobparser as ref_jobparser
from edl_tpu_torch.api import serde
from edl_tpu_torch.api.types import RESOURCE_GPU
from edl_tpu_torch.controller import jobparser

#: the differences the port keeps, and nothing else: its modules in the
#: commands, the card claim's resource key, the card count's env key, and
#: no TPU topology env
MODULES = {"edl_tpu.runtime.launcher": "edl_tpu_torch.runtime.launcher",
           "edl_tpu.coord.server": "edl_tpu_torch.coord.server"}
RESOURCE = {"google.com/tpu": RESOURCE_GPU}
ENV_RENAMED = {"EDL_TPU_CHIPS_PER_TRAINER": "EDL_GPUS_PER_TRAINER"}
ENV_DROPPED = {"EDL_TPU_TOPOLOGY"}


def as_port(manifest):
    """A reference manifest with the listed differences applied."""
    if isinstance(manifest, dict):
        out = {}
        for k, v in manifest.items():
            k = RESOURCE.get(k, k)
            if k == "command":
                v = [MODULES.get(part, part) for part in v]
            if k == "env" and isinstance(v, list):
                v = [dict(e, name=ENV_RENAMED.get(e["name"], e["name"]))
                     for e in v if e["name"] not in ENV_DROPPED]
            out[k] = as_port(v)
        return out
    if isinstance(manifest, list):
        return [as_port(v) for v in manifest]
    return manifest


def to_tpu(doc):
    if isinstance(doc, dict):
        return {("google.com/tpu" if k == RESOURCE_GPU else k): to_tpu(v)
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [to_tpu(v) for v in doc]
    return doc


def job_doc(**spec) -> dict:
    trainer = {"entrypoint": "python -m my.trainer --epochs 2",
               "workspace": "/workspace", "min_instance": 2,
               "max_instance": 4,
               "resources": {"requests": {"cpu": "2", "memory": "4Gi"},
                             "limits": {"cpu": "2", RESOURCE_GPU: "2"}}}
    trainer.update(spec.pop("trainer", {}))
    doc = {"apiVersion": "edl.tpu/v1", "kind": "TrainingJob",
           "metadata": {"name": "wordemb", "namespace": "team-a"},
           "spec": {"image": "registry/job:1", "fault_tolerant": True,
                    "passes": 3, "trainer": trainer,
                    "master": {"resources": {"limits": {"cpu": "1"}}}}}
    doc["spec"].update(spec)
    return doc


JOBS = {
    "ft": job_doc(),
    "ft_port_env_volumes": job_doc(
        port=7300, node_selector={"pool": "h100"}, host_network=True,
        trainer={"env": {"EDL_MH_CKPT_EVERY": "25", "X": "1"},
                 "allow_multi_domain": True,
                 "volumes": [{"name": "data", "emptyDir": {}}],
                 "volume_mounts": [{"name": "data", "mountPath": "/data"}],
                 "image_pull_secrets": [{"name": "cred"}]}),
    "ft_endpoint": job_doc(master={"etcd_endpoint": "coord.svc:7164"}),
    "static": job_doc(fault_tolerant=False,
                      trainer={"min_instance": 3, "max_instance": 3}),
    "pserver": job_doc(pserver={"min_instance": 2, "max_instance": 2,
                                "resources": {"limits": {"cpu": "4"}}}),
    "cpu_only": job_doc(trainer={"resources": {"limits": {"cpu": "1"}}}),
}

SERVING = {"apiVersion": "edl.tpu/v1", "kind": "ServingJob",
           "metadata": {"name": "scorer", "namespace": "team-b"},
           "spec": {"image": "registry/serve:1", "port": 8600,
                    "node_selector": {"pool": "h100"},
                    "server": {"model_dir": "/models/m", "model": "mlp:4,8,2",
                               "min_replicas": 1, "max_replicas": 4,
                               "slo_p99_ms": 40, "max_batch_size": 16,
                               "env": {"EDL_SERVING_FRONTDOOR": "async"},
                               "resources": {"limits": {RESOURCE_GPU: "1"}}}}}


def both(doc):
    """The job as each package reads it."""
    return (serde.manifest_from_dict(copy.deepcopy(doc)),
            ref_serde.manifest_from_dict(to_tpu(doc)))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_job_manifests_equal_the_reference(name):
    ours, ref = both(JOBS[name])
    got = jobparser.parse_to_manifests(ours)
    want = ref_jobparser.parse_to_manifests(ref)
    assert [m["kind"] for m in got] == [m["kind"] for m in want]
    assert got == as_port(want)


@pytest.mark.parametrize("role", ["trainer", "coordinator", "pserver"])
@pytest.mark.parametrize("name", sorted(JOBS))
def test_pod_env_equals_the_reference(name, role):
    ours, ref = both(JOBS[name])
    want = {ENV_RENAMED.get(k, k): v
            for k, v in ref_jobparser.pod_env(ref, role).items()
            if k not in ENV_DROPPED}
    assert jobparser.pod_env(ours, role) == want


@pytest.mark.parametrize("parse", ["parse_to_trainer", "parse_to_coordinator",
                                   "parse_to_coordinator_service",
                                   "parse_to_pserver"])
def test_each_role_equals_the_reference(parse):
    ours, ref = both(JOBS["pserver"])
    assert getattr(jobparser, parse)(ours) == as_port(
        getattr(ref_jobparser, parse)(ref))


def test_serving_manifests_equal_the_reference():
    ours, ref = both(SERVING)
    assert jobparser.parse_serving_manifests(ours) == as_port(
        ref_jobparser.parse_serving_manifests(ref))
    assert jobparser.serving_pod_env(ours) == ref_jobparser.serving_pod_env(
        ref)


def test_the_listed_differences_are_the_only_ones():
    """Nothing of the JAX package survives the differences: the module
    names, the resource key and the env keys each appear in the
    reference's manifests, and only in their port form in ours."""
    ours, ref = both(JOBS["pserver"])
    text = repr(jobparser.parse_to_manifests(ours))
    ref_text = repr(ref_jobparser.parse_to_manifests(ref))
    for old, new in list(MODULES.items()) + list(RESOURCE.items()) + list(
            ENV_RENAMED.items()):
        assert old in ref_text and new not in ref_text
        assert new in text and old not in text


@pytest.mark.parametrize("name", sorted(JOBS) + ["serving"])
def test_every_command_runs_the_ports_modules(name):
    job = serde.manifest_from_dict(copy.deepcopy(
        SERVING if name == "serving" else JOBS[name]))
    manifests = (jobparser.parse_serving_manifests(job) if name == "serving"
                 else jobparser.parse_to_manifests(job))
    commands = [c["command"] for m in manifests
                if m["kind"] != "Service"
                for c in m["spec"]["template"]["spec"]["containers"]]
    assert commands
    for cmd in commands:
        assert cmd[:2] == ["python", "-m"]
        assert cmd[2] in (jobparser.LAUNCHER_MODULE,
                          jobparser.COORDINATOR_MODULE)
        assert cmd[2].startswith("edl_tpu_torch.")
        assert "edl_tpu." not in " ".join(cmd)


def test_gpu_count_and_no_topology_in_the_env():
    ours, _ = both(JOBS["ft"])
    env = jobparser.pod_env(ours, "trainer")
    assert env["EDL_GPUS_PER_TRAINER"] == "2"
    assert not any(k.startswith("EDL_TPU_") for k in env)


def test_static_verb_and_downward_identity():
    """Non-FT jobs take the static barrier verb; pod identity comes from
    the downward API (reference pkg/jobparser.go:124, :263-311)."""
    static, _ = both(JOBS["static"])
    ft, _ = both(JOBS["ft"])
    cmd = lambda j: jobparser.parse_to_trainer(j)["spec"]["template"][  # noqa
        "spec"]["containers"][0]["command"]
    assert cmd(ft)[-1] == "start_trainer"
    assert cmd(static)[-1] == "start_static_trainer"
    env = {e["name"]: e for e in jobparser.parse_to_trainer(static)[
        "spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["EDL_POD_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == \
        "metadata.name"
    assert env["EDL_POD_IP"]["valueFrom"]["fieldRef"]["fieldPath"] == \
        "status.podIP"
