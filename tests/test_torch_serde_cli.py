"""The port's manifest serde and operator CLI (edl_tpu_torch.api.serde,
edl_tpu_torch.cli) against the JAX package's: the scenarios of
tests/test_serde_cli.py on the port, the same documents through both
packages' serde (equal apart from the accelerator key), the TPU-only fields
the port rejects by name, JSON manifests with PyYAML and kubernetes
unimportable, and the CLI's verbs and flags against the reference's."""

from __future__ import annotations

import copy
import io
import json
import logging
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import yaml

from edl_tpu import cli as ref_cli
from edl_tpu.api import serde as ref_serde
from edl_tpu_torch import cli
from edl_tpu_torch.api import serde
from edl_tpu_torch.api.types import RESOURCE_GPU
from edl_tpu_torch.api.validation import validate_any

REPO = Path(__file__).resolve().parent.parent

EXAMPLE_YAML = """
apiVersion: edl.tpu/v1
kind: TrainingJob
metadata:
  name: example
  namespace: default
spec:
  fault_tolerant: true
  passes: 2
  trainer:
    entrypoint: "python train.py"
    workspace: "/workspace"
    min-instance: 2
    max-instance: 10
    resources:
      requests:
        cpu: "4"
        memory: "8G"
      limits:
        cpu: "4"
        memory: "8G"
        nvidia.com/gpu: "4"
  pserver:
    min-instance: 0
    max-instance: 0
  master:
    etcd_endpoint: ""
"""


def to_tpu(doc):
    """The same document with every ``nvidia.com/gpu`` key as the JAX
    package's ``google.com/tpu``."""
    if isinstance(doc, dict):
        return {("google.com/tpu" if k == RESOURCE_GPU else k): to_tpu(v)
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [to_tpu(v) for v in doc]
    return doc


def trainer_doc(**trainer) -> dict:
    return {"apiVersion": "edl.tpu/v1", "kind": "TrainingJob",
            "metadata": {"name": "j", "namespace": "team-a",
                         "labels": {"team": "a"}},
            "spec": {"image": "img:1", "port": 7000, "fault_tolerant": True,
                     "passes": 3, "host_network": True,
                     "node_selector": {"pool": "gpu"},
                     "trainer": trainer,
                     "master": {"coord_endpoint": "c:1",
                                "resources": {"limits": {"cpu": "2"}}}}}


#: documents both packages read: each in its GPU spelling
DOCS = {
    "example": yaml.safe_load(EXAMPLE_YAML),
    "minimal": {"metadata": {"name": "m"}},
    "full": trainer_doc(
        entrypoint="python t.py", workspace="/w", min_instance=1,
        max_instance=4, allow_multi_domain=True, priority="high",
        env={"A": 1, "EDL_MH_CKPT_EVERY": "5"},
        volumes=[{"name": "d", "emptyDir": {}}],
        volumeMounts=[{"name": "d", "mountPath": "/d"}],
        imagePullSecrets=[{"name": "s"}],
        resources={"requests": {"cpu": "1", "memory": "2Gi"},
                   "limits": {"cpu": "2", RESOURCE_GPU: "2"}}),
    "kebab": trainer_doc(**{"min-instance": 2, "max-instance": 3,
                            "allow-multi-domain": True,
                            "min_instance": 1}),
}

SERVING = {"apiVersion": "edl.tpu/v1", "kind": "ServingJob",
           "metadata": {"name": "s"},
           "spec": {"image": "img", "port": 8600, "hostNetwork": True,
                    "server": {"modelDir": "/m", "model": "mlp:4,8,2",
                               "min-replicas": 1, "maxReplicas": 3,
                               "sloP99Ms": 50, "max_batch_size": 16,
                               "priority": 2, "env": {"X": "1"},
                               "resources": {"limits": {
                                   RESOURCE_GPU: "1"}}}}}


class TestSerde:
    def test_round_trip(self):
        job = serde.job_from_yaml(EXAMPLE_YAML)
        assert job.name == "example"
        assert job.spec.fault_tolerant
        assert job.spec.trainer.min_instance == 2
        assert job.spec.trainer.max_instance == 10
        assert job.elastic()
        assert job.gpus_per_trainer() == 4
        assert job.spec.trainer.resources.limits[RESOURCE_GPU].value() == 4

        job2 = serde.job_from_dict(serde.job_to_dict(job))
        assert job2 == job
        assert serde.job_to_yaml(job2)  # serializes cleanly

    def test_kebab_and_snake_equivalent(self):
        a = serde.job_from_dict({"metadata": {"name": "j"},
                                 "spec": {"trainer": {"min-instance": 3,
                                                      "max-instance": 5}}})
        b = serde.job_from_dict({"metadata": {"name": "j"},
                                 "spec": {"trainer": {"min_instance": 3,
                                                      "max_instance": 5}}})
        assert (a.spec.trainer.min_instance, a.spec.trainer.max_instance) \
            == (b.spec.trainer.min_instance, b.spec.trainer.max_instance)

    def test_wrong_kind_rejected(self):
        with pytest.raises(ValueError):
            serde.job_from_dict({"kind": "Deployment"})

    def test_load_file(self, tmp_path):
        p = tmp_path / "job.yaml"
        p.write_text(EXAMPLE_YAML)
        assert serde.load_job_file(str(p)).name == "example"
        assert serde.load_manifest_file(str(p)).name == "example"

    def test_undeclared_kebab_key_warns_loudly(self, caplog):
        doc = {"apiVersion": serde.API_VERSION, "kind": "TrainingJob",
               "metadata": {"name": "j"},
               "spec": {"trainer": {"min-instance": 1, "max-instance": 2},
                        "master": {"etcd-endpoint": "http://coord:8080"}}}
        with caplog.at_level(logging.WARNING,
                             logger="edl_tpu_torch.serde"):
            job = serde.job_from_dict(doc)
        assert (job.spec.trainer.min_instance,
                job.spec.trainer.max_instance) == (1, 2)
        assert job.spec.master.etcd_endpoint == ""
        assert any("etcd-endpoint" in r.message
                   and "etcd_endpoint" in r.message for r in caplog.records)


class TestAgainstTheReference:
    """The same documents through both packages: the dicts written back
    are equal once the port's ``nvidia.com/gpu`` reads as
    ``google.com/tpu``."""

    @pytest.mark.parametrize("name", sorted(DOCS))
    def test_job_round_trip_equals_the_reference(self, name):
        doc = DOCS[name]
        ours = serde.job_to_dict(serde.job_from_dict(copy.deepcopy(doc)))
        ref = ref_serde.job_to_dict(ref_serde.job_from_dict(to_tpu(doc)))
        assert to_tpu(ours) == ref

    def test_serving_round_trip_equals_the_reference(self):
        ours = serde.manifest_to_dict(serde.manifest_from_dict(
            copy.deepcopy(SERVING)))
        ref = ref_serde.manifest_to_dict(ref_serde.manifest_from_dict(
            to_tpu(SERVING)))
        assert to_tpu(ours) == ref
        assert ours["spec"]["server"]["max_replicas"] == 3
        assert ours["spec"]["host_network"] is True

    def test_status_round_trip_equals_the_reference(self):
        doc = {"phase": "Running", "reason": "",
               "replica_statuses": [
                   {"resource_type": "TRAINER", "state": "Running",
                    "resource_states": {"p1": "Running", "p0": "Failed"}},
                   {"resource_type": "MASTER", "state": "Future",
                    "resource_states": {}}]}
        ours = serde.status_to_dict(serde.status_from_dict(doc))
        ref = ref_serde.status_to_dict(ref_serde.status_from_dict(doc))
        assert ours == ref
        assert serde.status_from_dict({"phase": "Bogus"}).phase.value \
            == "None"

    def test_alias_tables_equal_the_reference(self):
        assert serde.KEBAB_ALIASES == ref_serde.KEBAB_ALIASES
        # the reference's serving aliases less its topology field's (a
        # one-word field has no alias of its own)
        assert serde.SERVING_ALIASES == ref_serde.SERVING_ALIASES
        assert (serde.CRD_GROUP, serde.CRD_VERSION, serde.CRD_PLURAL,
                serde.SERVING_CRD_PLURAL) == (
            ref_serde.CRD_GROUP, ref_serde.CRD_VERSION,
            ref_serde.CRD_PLURAL, ref_serde.SERVING_CRD_PLURAL)


class TestRejected:
    """What the port's types cannot hold is refused by name, never
    trimmed."""

    @pytest.mark.parametrize("section,where", [
        ("trainer", "spec.trainer.resources.limits['google.com/tpu']"),
        ("pserver", "spec.pserver.resources.limits['google.com/tpu']"),
        ("master", "spec.master.resources.limits['google.com/tpu']"),
    ])
    def test_tpu_limit_names_the_field(self, section, where):
        doc = {"metadata": {"name": "j"}, "spec": {section: {
            "resources": {"limits": {"google.com/tpu": "4"}}}}}
        with pytest.raises(ValueError) as exc:
            serde.job_from_dict(doc)
        assert where in str(exc.value)

    def test_tpu_request_names_the_field(self):
        doc = {"metadata": {"name": "j"}, "spec": {"trainer": {
            "resources": {"requests": {"google.com/tpu": "1"}}}}}
        with pytest.raises(ValueError,
                           match=r"spec\.trainer\.resources\.requests"):
            serde.job_from_dict(doc)

    def test_trainer_topology_names_the_field(self):
        doc = {"metadata": {"name": "j"},
               "spec": {"trainer": {"topology": "2x2"}}}
        with pytest.raises(ValueError, match=r"spec\.trainer\.topology"):
            serde.job_from_dict(doc)

    def test_server_topology_and_tpu_name_the_field(self):
        doc = copy.deepcopy(SERVING)
        doc["spec"]["server"]["topology"] = "2x4"
        with pytest.raises(ValueError, match=r"spec\.server\.topology"):
            serde.manifest_from_dict(doc)
        doc = to_tpu(SERVING)
        with pytest.raises(ValueError,
                           match=r"spec\.server\.resources\.limits"):
            serde.manifest_from_dict(doc)

    def test_the_shipped_tpu_example_is_rejected(self, capsys):
        path = REPO / "examples" / "examplejob.yaml"
        with pytest.raises(ValueError, match=r"spec\.trainer\.topology"):
            serde.load_manifest_file(str(path))
        assert cli.main(["validate", str(path)]) == 1
        assert "spec.trainer.topology" in capsys.readouterr().err
        # the reference reads the same file
        assert ref_serde.load_manifest_file(str(path)).name == "example"


class TestWithoutYaml:
    def test_json_manifest_with_yaml_and_kubernetes_blocked(
            self, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "yaml", None)
        monkeypatch.setitem(sys.modules, "kubernetes", None)
        path = tmp_path / "job.json"
        path.write_text(json.dumps(DOCS["example"]))
        job = serde.load_manifest_file(str(path))
        assert job.gpus_per_trainer() == 4
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(["--log-level", "warn", "validate", str(path)])
        assert rc == 0
        echoed = json.loads(buf.getvalue())
        validate_any(job)  # the defaults validate fills in
        assert echoed == serde.job_to_dict(job)
        assert echoed["spec"]["trainer"]["max_instance"] == 10

    def test_yaml_manifest_without_yaml_says_so(self, tmp_path, monkeypatch,
                                               capsys):
        monkeypatch.setitem(sys.modules, "yaml", None)
        path = tmp_path / "job.yaml"
        path.write_text(EXAMPLE_YAML)
        with pytest.raises(RuntimeError, match="PyYAML"):
            serde.load_manifest_file(str(path))
        assert cli.main(["validate", str(path)]) == 1
        assert "PyYAML" in capsys.readouterr().err


class TestCli:
    def test_validate_ok(self, tmp_path, capsys):
        p = tmp_path / "job.yaml"
        p.write_text(EXAMPLE_YAML)
        assert cli.main(["validate", str(p)]) == 0
        out = capsys.readouterr().out
        assert "example" in out and "fault_tolerant: true" in out

    def test_validate_rejects_elastic_without_ft(self, tmp_path, capsys):
        # elastic requires fault_tolerant (reference pkg/jobparser.go:66-68)
        bad = EXAMPLE_YAML.replace("fault_tolerant: true",
                                   "fault_tolerant: false")
        p = tmp_path / "bad.yaml"
        p.write_text(bad)
        assert cli.main(["validate", str(p)]) == 1
        assert "INVALID" in capsys.readouterr().err

    def test_submit_and_delete_fake(self, tmp_path):
        p = tmp_path / "job.yaml"
        p.write_text(EXAMPLE_YAML)
        assert cli.main(["submit", "--fake", str(p)]) == 0
        assert cli.main(["delete", "--fake", "example"]) == 0

    def test_collector_fake(self, capsys):
        assert cli.main(["collector", "--fake", "--interval", "0",
                         "--samples", "2"]) == 0
        out = capsys.readouterr().out
        assert out.count("\n") == 3  # header + 2 samples
        assert "GPU-UTILS" in out.splitlines()[0]

    def test_list_and_status_fake(self, capsys):
        assert cli.main(["list", "--fake"]) == 0
        assert "no TrainingJobs found" in capsys.readouterr().out
        assert cli.main(["status", "--fake", "nothing"]) == 0
        assert "no pods found" in capsys.readouterr().out

    def test_launch_dispatches_to_the_launcher(self, capsys, monkeypatch):
        monkeypatch.delenv("EDL_COORD_ENDPOINT", raising=False)
        monkeypatch.delenv("EDL_COORD_HOST", raising=False)
        assert cli.main(["launch", "start_trainer"]) == 2
        assert "no coordinator address" in capsys.readouterr().err

    def test_parser_flags_match_reference(self):
        p = cli.build_parser()
        args = p.parse_args(["controller", "--fake",
                             "--max-load-desired", "0.9"])
        assert args.max_load_desired == 0.9
        assert args.loop_seconds == 5.0  # reference pkg/autoscaler.go:31
        assert args.watch and args.gc_orphans and args.goodput_objective

    def test_every_verb_and_flag_equals_the_reference(self):
        def surface(parser):
            top = [(tuple(a.option_strings), a.dest, a.default)
                   for a in parser._actions if a.dest != "cmd"]
            sub = next(a for a in parser._actions
                       if a.dest == "cmd").choices
            return top, {
                verb: sorted((tuple(a.option_strings), a.dest, a.nargs,
                              repr(a.default), tuple(a.choices or ()),
                              getattr(a.type, "__name__", None))
                             for a in sp._actions)
                for verb, sp in sub.items()}

        ours, ref = surface(cli.build_parser()), surface(
            ref_cli.build_parser())
        assert ours == ref
        assert set(ours[1]) == {
            "controller", "collector", "coordinator", "launch", "submit",
            "delete", "status", "list", "fleet", "calib", "trace",
            "validate"}


def test_priority_threads_api_serde_crd():
    """SchedPriority round-trips through the port's manifest layer for both
    kinds, accepts tier names, survives apiserver structural pruning, and
    is bounded at validation (tests/test_sched_goodput.py's)."""
    from edl_tpu_torch.api.types import (ResourceRequirements,
                                         SchedPriority, ServingJob,
                                         ServingSpec, TrainerSpec,
                                         TrainingJob, TrainingJobSpec)
    from edl_tpu_torch.api.validation import ValidationError

    from tests.k8s_stub import load_crd_schemas, prune_per_schema

    def job(name, priority=SchedPriority.NORMAL):
        return TrainingJob(name=name, spec=TrainingJobSpec(
            fault_tolerant=True, trainer=TrainerSpec(
                min_instance=1, max_instance=2, priority=priority,
                resources=ResourceRequirements(
                    requests={"cpu": "1"}, limits={RESOURCE_GPU: "1"}))))

    doc = serde.job_to_dict(job("p", SchedPriority.HIGH))
    assert doc["spec"]["trainer"]["priority"] == 2
    assert serde.job_from_dict(doc).sched_priority() == 2
    doc["spec"]["trainer"]["priority"] = "high"
    assert serde.job_from_dict(doc).sched_priority() == 2
    with pytest.raises(ValueError):
        serde.job_from_dict(
            {**doc, "spec": {**doc["spec"],
                             "trainer": {**doc["spec"]["trainer"],
                                         "priority": "urgent"}}})
    schema = load_crd_schemas()[("edl.tpu", "trainingjobs")]
    assert prune_per_schema(doc, schema)["spec"]["trainer"][
        "priority"] == "high"
    sj = ServingJob(name="f", spec=ServingSpec(
        min_replicas=1, max_replicas=2, priority=SchedPriority.HIGH))
    sdoc = serde.serving_job_to_dict(sj)
    assert sdoc["spec"]["server"]["priority"] == 2
    assert serde.serving_job_from_dict(sdoc).sched_priority() == 2
    sschema = load_crd_schemas()[("edl.tpu", "servingjobs")]
    assert prune_per_schema(sdoc, sschema)["spec"]["server"]["priority"] == 2
    bad = job("bad")
    bad.spec.trainer.priority = -1
    with pytest.raises(ValidationError):
        validate_any(bad)

