"""The port's manifests against the shipped CRD: the scenarios of
tests/test_crd_pruning.py and tests/test_spec_parity.py on the port's serde
and jobparser, through tests/k8s_stub.py (which prunes by the shipped
k8s/crd.yaml), with every manifest claiming ``nvidia.com/gpu`` — the port's
copies of the shipped manifests — and the compile-cache wiring beside the
JAX package's."""

from __future__ import annotations

import copy
import pathlib
import re

import pytest
import yaml

from edl_tpu.api import serde as ref_serde
from edl_tpu.controller import jobparser as ref_jobparser
from edl_tpu_torch.api import serde
from edl_tpu_torch.api.types import (RESOURCE_CPU, RESOURCE_GPU,
                                     ResourceRequirements, TrainerSpec,
                                     TrainingJob, TrainingJobSpec)
from edl_tpu_torch.controller.jobparser import (COMPILE_CACHE_PATH,
                                                COMPILE_CACHE_VOLUME,
                                                parse_to_trainer, pod_env)

from tests.k8s_stub import load_crd_schemas, prune_per_schema
from tests.torch_k8s import port_control_plane, port_kube  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SCHEMA = load_crd_schemas()[("edl.tpu", "trainingjobs")]
SERVING_SCHEMA = load_crd_schemas()[("edl.tpu", "servingjobs")]


def prune_cr(doc: dict, schema: dict = SCHEMA) -> dict:
    out = copy.deepcopy(doc)
    props = schema["properties"]
    for section in ("spec", "status"):
        if section in out:
            out[section] = prune_per_schema(out[section], props[section])
    return out


def to_gpu(doc):
    """A shipped TPU manifest as the port writes it: ``google.com/tpu``
    limits as ``nvidia.com/gpu``, the TPU slice ``topology`` dropped (the
    port rejects it; a GPU job claims a count of cards)."""
    if isinstance(doc, dict):
        return {(RESOURCE_GPU if k == "google.com/tpu" else k): to_gpu(v)
                for k, v in doc.items() if k != "topology"}
    if isinstance(doc, list):
        return [to_gpu(v) for v in doc]
    return doc


def declared(schema: dict) -> dict:
    out: dict = {}

    def walk(node):
        props = node.get("properties") or {}
        for k, sub in props.items():
            out.setdefault(k, []).append(props)
            walk(sub)
        if isinstance(node.get("items"), dict):
            walk(node["items"])

    walk(schema)
    return out


# ---------------------------------------------------------------- pruning


def test_pruner_keeps_both_instance_spellings():
    doc = {"spec": {"trainer": {"min-instance": 2, "max-instance": 10,
                                "min_instance": 3}}}
    assert prune_cr(doc)["spec"]["trainer"] == {
        "min-instance": 2, "max-instance": 10, "min_instance": 3}


def test_serde_aliases_and_crd_schema_in_lockstep():
    """Every spelling the port's serde accepts is declared wherever its
    canonical form is — or it works through ``cli submit`` and is pruned
    on ``kubectl apply``."""
    have = declared(SCHEMA)
    for kebab, snake in serde.KEBAB_ALIASES.items():
        assert snake in have, snake
        for scope in have[snake]:
            assert kebab in scope, (kebab, snake)
    assert "coord_endpoint" in have


def test_serving_aliases_and_crd_schema_in_lockstep():
    have = declared(SERVING_SCHEMA)
    for alias, snake in serde.SERVING_ALIASES.items():
        if snake not in have:
            continue  # a field the schema keeps under preserve-unknown
        for scope in have[snake]:
            assert alias in scope, (alias, snake)


def test_the_gpu_resource_survives_pruning():
    """Resources are preserve-unknown in the schema: the port's card
    claim is admitted as written."""
    doc = {"spec": {"trainer": {"resources": {
        "limits": {RESOURCE_GPU: "2", "cpu": "1"}}}}}
    assert prune_cr(doc) == doc


def test_serde_prefers_snake_when_both_spellings_present():
    t = serde.job_from_dict({
        "kind": "TrainingJob", "metadata": {"name": "j"},
        "spec": {"trainer": {"min-instance": 2, "min_instance": 3,
                             "max-instance": 10}}}).spec.trainer
    assert (t.min_instance, t.max_instance) == (3, 10)


def manifest_docs() -> list:
    """The GPU copy of every TrainingJob manifest shipped: examples/*.yaml
    and every ```yaml block in doc/*.md."""
    found = []
    for p in sorted((REPO / "examples").glob("*.yaml")):
        doc = yaml.safe_load(p.read_text())
        if isinstance(doc, dict) and doc.get("kind") == "TrainingJob":
            found.append((str(p.relative_to(REPO)), doc))
    for p in sorted((REPO / "doc").glob("*.md")):
        for block in re.findall(r"```yaml\n(.*?)```", p.read_text(), re.S):
            try:
                doc = yaml.safe_load(block)
            except yaml.YAMLError:
                continue
            if isinstance(doc, dict) and doc.get("kind") == "TrainingJob":
                found.append((str(p.relative_to(REPO)), doc))
    return found


def test_manifest_inventory_is_nonempty():
    names = [n for n, _ in manifest_docs()]
    assert any("examplejob" in n for n in names)
    assert any(n.startswith("doc/") for n in names)


@pytest.mark.parametrize("name,doc", manifest_docs())
def test_shipped_manifests_survive_apiserver_pruning(name, doc):
    """Admission pruning changes nothing the port parses out of the GPU
    copy of any shipped manifest, and the port reads what the reference
    reads from the original, the accelerator aside."""
    gpu = to_gpu(doc)
    before = serde.job_from_dict(gpu)
    after = serde.job_from_dict(prune_cr(gpu))
    assert after == before, f"{name}: pruning changed the parsed job"
    if "examplejob" in name or "usage" in name:
        assert (after.spec.trainer.min_instance,
                after.spec.trainer.max_instance) == (2, 10), name
    ref = ref_serde.job_from_dict(doc)
    assert (after.spec.trainer.min_instance, after.spec.trainer.max_instance,
            after.spec.fault_tolerant, after.spec.trainer.entrypoint) == (
        ref.spec.trainer.min_instance, ref.spec.trainer.max_instance,
        ref.spec.fault_tolerant, ref.spec.trainer.entrypoint)


# ------------------------------------------------ end to end through the stub


def test_gpu_example_elastic_through_pruning_stub(port_control_plane):
    """``kubectl apply`` of the GPU copy of examples/examplejob.yaml
    against the pruning stub: the port's controller sees min 2 / max 10
    and materializes 2 trainers."""
    cluster, controller, sync, state = port_control_plane
    doc = to_gpu(yaml.safe_load(
        (REPO / "examples" / "examplejob.yaml").read_text()))
    cluster.create_training_job_cr(doc)
    stored = state.custom_objects[("edl.tpu", "default", "trainingjobs",
                                   "example")]
    assert stored["spec"]["trainer"]["min_instance"] == 2
    assert stored["spec"]["trainer"]["resources"]["limits"][
        RESOURCE_GPU] == "4"
    sync.run_once()
    job = controller.jobs()[0]
    assert (job.spec.trainer.min_instance,
            job.spec.trainer.max_instance) == (2, 10)
    assert job.gpus_per_trainer() == 4
    assert state.jobs[("default", "example-trainer")].spec.parallelism == 2


def test_tpu_example_through_the_stub_fails_by_name(port_control_plane):
    """The shipped TPU example itself: admitted by the apiserver, refused
    by the port's sync loop with a Failed status naming the field."""
    cluster, controller, sync, state = port_control_plane
    doc = yaml.safe_load((REPO / "examples" / "examplejob.yaml").read_text())
    cluster.create_training_job_cr(doc)
    sync.run_once()
    cr = state.custom_objects[("edl.tpu", "default", "trainingjobs",
                               "example")]
    assert cr["status"]["phase"] == "Failed"
    assert "spec.trainer.topology" in cr["status"]["reason"]
    assert controller.jobs() == []


def test_reference_style_kebab_manifest_through_pruning_stub(
        port_control_plane):
    cluster, controller, sync, state = port_control_plane
    cluster.create_training_job_cr({
        "apiVersion": "edl.tpu/v1", "kind": "TrainingJob",
        "metadata": {"name": "ported", "namespace": "default"},
        "spec": {"image": "i", "fault_tolerant": True,
                 "trainer": {"entrypoint": "python t.py",
                             "min-instance": 2, "max-instance": 10,
                             "resources": {"requests": {"cpu": "1",
                                                        "memory": "1Gi"}}}},
    })
    stored = state.custom_objects[("edl.tpu", "default", "trainingjobs",
                                   "ported")]
    assert stored["spec"]["trainer"]["min-instance"] == 2
    sync.run_once()
    job = controller.jobs()[0]
    assert (job.spec.trainer.min_instance,
            job.spec.trainer.max_instance) == (2, 10)


def test_undeclared_key_is_pruned_by_stub(port_control_plane):
    cluster, controller, sync, state = port_control_plane
    cluster.create_training_job_cr({
        "apiVersion": "edl.tpu/v1", "kind": "TrainingJob",
        "metadata": {"name": "oops", "namespace": "default"},
        "spec": {"image": "i",
                 "trainer": {"entrypoint": "python t.py",
                             "minInstances": 2, "maxInstances": 10}},
    })
    stored = state.custom_objects[("edl.tpu", "default", "trainingjobs",
                                   "oops")]
    assert "minInstances" not in stored["spec"]["trainer"]
    sync.run_once()
    job = controller.jobs()[0]
    assert (job.spec.trainer.min_instance,
            job.spec.trainer.max_instance) == (1, 1)


# ------------------------------------------- pod-template spec parity


VOLUMES = [
    {"name": "dataset", "persistentVolumeClaim": {"claimName": "imagenet"}},
    {"name": "shm", "emptyDir": {"medium": "Memory"}},
]
MOUNTS = [
    {"name": "dataset", "mountPath": "/data", "readOnly": True},
    {"name": "shm", "mountPath": "/dev/shm"},
]
PULL_SECRETS = [{"name": "registry-cred"}]


def make_job(fault_tolerant=True) -> TrainingJob:
    return TrainingJob(
        name="j", spec=TrainingJobSpec(
            fault_tolerant=fault_tolerant,
            trainer=TrainerSpec(
                min_instance=2, max_instance=4,
                resources=ResourceRequirements(
                    requests={RESOURCE_CPU: "1"},
                    limits={RESOURCE_GPU: "1"}),
                volumes=[dict(v) for v in VOLUMES],
                volume_mounts=[dict(m) for m in MOUNTS],
                image_pull_secrets=[dict(s) for s in PULL_SECRETS],
            )))


def trainer_pod(job):
    return parse_to_trainer(job)["spec"]["template"]["spec"]


def test_round_trip_preserves_pod_template_fields():
    job = make_job()
    doc = serde.job_to_dict(job)
    t = doc["spec"]["trainer"]
    assert (t["volumes"], t["volume_mounts"], t["image_pull_secrets"]) == (
        VOLUMES, MOUNTS, PULL_SECRETS)
    back = serde.job_from_dict(doc)
    assert back == job
    assert serde.job_from_yaml(serde.job_to_yaml(job)) == back
    # the reference writes the same document back (to it the card claim
    # is a resource key like any other)
    assert ref_serde.job_to_dict(ref_serde.job_from_dict(doc)) == doc


def test_camel_case_spellings_accepted():
    doc = {"kind": "TrainingJob", "metadata": {"name": "j"},
           "spec": {"trainer": {"min_instance": 1, "max_instance": 1,
                                "volumes": VOLUMES, "volumeMounts": MOUNTS,
                                "imagePullSecrets": PULL_SECRETS}}}
    t = serde.job_from_dict(doc).spec.trainer
    assert (t.volume_mounts, t.image_pull_secrets) == (MOUNTS, PULL_SECRETS)


def test_snake_wins_over_camel_when_both_present():
    doc = {"kind": "TrainingJob", "metadata": {"name": "j"},
           "spec": {"trainer": {"volume_mounts": MOUNTS[:1],
                                "volumeMounts": MOUNTS}}}
    assert serde.job_from_dict(doc).spec.trainer.volume_mounts == MOUNTS[:1]


def test_manifest_carries_volumes_mounts_and_secrets():
    pod = trainer_pod(make_job())
    assert [v["name"] for v in pod["volumes"]][:2] == ["dataset", "shm"]
    mounts = pod["containers"][0]["volumeMounts"]
    assert mounts[:2] == MOUNTS
    assert pod["imagePullSecrets"] == PULL_SECRETS


def test_ft_trainer_gets_compile_cache_volume_and_env():
    """The kernels' build root: a per-pod volume and EDL_COMPILE_CACHE,
    at the reference's path and volume name."""
    job = make_job(fault_tolerant=True)
    pod = trainer_pod(job)
    assert any(v["name"] == COMPILE_CACHE_VOLUME and "emptyDir" in v
               for v in pod["volumes"])
    assert any(m["mountPath"] == COMPILE_CACHE_PATH
               for m in pod["containers"][0]["volumeMounts"])
    assert pod_env(job, "trainer")["EDL_COMPILE_CACHE"] == COMPILE_CACHE_PATH
    assert (COMPILE_CACHE_PATH, COMPILE_CACHE_VOLUME) == (
        ref_jobparser.COMPILE_CACHE_PATH, ref_jobparser.COMPILE_CACHE_VOLUME)


def test_non_ft_trainer_gets_no_compile_cache():
    job = make_job(fault_tolerant=False)
    job.spec.trainer.volumes = []
    job.spec.trainer.volume_mounts = []
    job.spec.trainer.image_pull_secrets = []
    pod = trainer_pod(job)
    assert "volumes" not in pod
    assert "volumeMounts" not in pod["containers"][0]
    assert "imagePullSecrets" not in pod
    assert "EDL_COMPILE_CACHE" not in pod_env(job, "trainer")


def test_user_compile_cache_volume_wins():
    job = make_job(fault_tolerant=True)
    job.spec.trainer.volumes = [
        {"name": COMPILE_CACHE_VOLUME,
         "persistentVolumeClaim": {"claimName": "shared-cache"}}]
    job.spec.trainer.volume_mounts = [
        {"name": COMPILE_CACHE_VOLUME, "mountPath": COMPILE_CACHE_PATH}]
    pod = trainer_pod(job)
    assert [v for v in pod["volumes"] if v["name"] == COMPILE_CACHE_VOLUME
            ] == [job.spec.trainer.volumes[0]]
    assert len([m for m in pod["containers"][0]["volumeMounts"]
                if m["mountPath"] == COMPILE_CACHE_PATH]) == 1


def test_user_env_still_overrides_compile_cache_default():
    job = make_job(fault_tolerant=True)
    job.spec.trainer.env = {"EDL_COMPILE_CACHE": "/my/cache"}
    assert pod_env(job, "trainer")["EDL_COMPILE_CACHE"] == "/my/cache"


def test_compile_cache_moves_the_kernels_build_roots(tmp_path):
    """EDL_COMPILE_CACHE is read: both build roots of the port (the CUDA
    kernels', the native coordinator's) move under it, with the same
    hashed directories as under build/."""
    import os
    import subprocess
    import sys

    code = ("from edl_tpu_torch.ops import _build\n"
            "from edl_tpu_torch.coord import bindings\n"
            "print(_build.build_dir()); print(bindings.BUILD_DIR)\n")
    root = str(REPO)
    env = {k: v for k, v in os.environ.items() if k != "EDL_COMPILE_CACHE"}
    plain = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                           capture_output=True, text=True, check=True)
    moved = subprocess.run([sys.executable, "-c", code], cwd=root,
                           env=dict(env, EDL_COMPILE_CACHE=str(tmp_path)),
                           capture_output=True, text=True, check=True)
    ops_plain, coord_plain = plain.stdout.split()
    ops_moved, coord_moved = moved.stdout.split()
    assert ops_plain == str(REPO / "build" / "edl_tpu_torch" /
                            pathlib.Path(ops_plain).name)
    assert ops_moved == str(tmp_path / "edl_tpu_torch" /
                            pathlib.Path(ops_plain).name)
    assert coord_moved == str(tmp_path / "edl_tpu_torch" / "coord" /
                              pathlib.Path(coord_plain).name)
    # EDL_COMPILE_CACHE=<repo>/build is the default root itself
    same = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(env, EDL_COMPILE_CACHE=root + "/build"),
                          capture_output=True, text=True, check=True)
    assert same.stdout == plain.stdout
