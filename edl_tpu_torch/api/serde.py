"""TrainingJob and ServingJob manifests to and from dicts, JSON and YAML —
the port's copy of edl_tpu.api.serde.

Role of the reference's CRD decode path: users submit a ``TrainingJob``
manifest (reference example/examplejob.yaml; schema
pkg/resource/training_job.go:109-159) and the controller materializes it.
The manifest shape is the JAX package's, with the accelerator an NVIDIA GPU:
a trainer or server claims ``nvidia.com/gpu`` cards in its resource limits.

Snake_case is canonical.  The reference's kebab-case spellings are accepted
for exactly the keys its manifests write in kebab (``min-instance`` /
``max-instance``) plus ``allow-multi-domain`` and the k8s-native camelCase
pod-template keys — the same alias set ``k8s/crd.yaml`` declares, so the
file path and the ``kubectl apply`` CR path accept the same spellings.

The JAX package's TPU-only manifest fields have no counterpart here, and a
manifest that carries one is rejected with an error naming the field,
never silently trimmed: a trainer's or server's ``topology`` (a TPU slice
shape; the port's jobs claim a count of cards), and a ``google.com/tpu``
request or limit (the port's accelerator resource is
:data:`~edl_tpu_torch.api.types.RESOURCE_GPU`).

A JSON manifest is read with :mod:`json` and needs no PyYAML (JSON is a
subset of YAML, so the document is the same either way); any other text
needs PyYAML, imported only then.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from edl_tpu_torch.api.types import (
    JobPhase,
    MasterSpec,
    PserverSpec,
    ResourceRequirements,
    ResourceState,
    SchedPriority,
    ServingJob,
    ServingSpec,
    TrainerSpec,
    TrainingJob,
    TrainingJobSpec,
    TrainingJobStatus,
    TrainingResourceStatus,
)
from edl_tpu_torch.observability.logging import get_logger

log = get_logger("serde")

API_VERSION = "edl.tpu/v1"
KIND = "TrainingJob"
KIND_SERVING = "ServingJob"

#: CRD coordinates (k8s/crd.yaml; role of the reference's
#: pkg/apis/paddlepaddle/v1/types.go:12-28 constants).
CRD_GROUP = "edl.tpu"
CRD_VERSION = "v1"
CRD_PLURAL = "trainingjobs"
SERVING_CRD_PLURAL = "servingjobs"

#: the JAX package's accelerator resource, which no port manifest may claim
TPU_RESOURCE = "google.com/tpu"

#: kebab → snake aliases (mirrors the declarations in k8s/crd.yaml; keep
#: the two in lockstep or a manifest key behaves differently between
#: ``cli submit`` and ``kubectl apply``).  The camelCase entries are the
#: k8s-native spellings of the pod-template passthroughs.
KEBAB_ALIASES = {
    "min-instance": "min_instance",
    "max-instance": "max_instance",
    "allow-multi-domain": "allow_multi_domain",
    "volumeMounts": "volume_mounts",
    "imagePullSecrets": "image_pull_secrets",
}


def _known_snake_fields() -> frozenset[str]:
    """Every snake_case field a TrainingJob manifest section understands,
    derived from the spec dataclasses; a kebab key whose snake twin is in
    this set but which is not a declared alias would be dropped, so
    :func:`_norm` warns about it."""
    return frozenset(
        f.name
        for t in (TrainingJobSpec, TrainerSpec, PserverSpec, MasterSpec)
        for f in dataclasses.fields(t)
    ) | frozenset({"coord_endpoint", "requests", "limits",
                   "name", "namespace", "labels",
                   "trainer", "pserver", "master"})


_KNOWN_SNAKE_FIELDS = _known_snake_fields()


def _kebab(snake: str) -> str:
    return snake.replace("_", "-")


def _camel(snake: str) -> str:
    head, *rest = snake.split("_")
    return head + "".join(p.title() for p in rest)


def _spelling_aliases(fields: "frozenset[str] | set[str]") -> dict[str, str]:
    """kebab-case + lowerCamelCase alias → snake_case canonical, derived
    from the field names (the CRD lockstep test walks the same
    derivation)."""
    out: dict[str, str] = {}
    for f in fields:
        for alias in (_kebab(f), _camel(f)):
            if alias != f:
                out[alias] = f
    return out


def _serving_fields() -> frozenset[str]:
    return frozenset(f.name for f in dataclasses.fields(ServingSpec))


#: ServingJob alias set: every multi-word field of the server section plus
#: the job-level keys, kebab and camelCase, declared in k8s/crd.yaml too.
SERVING_ALIASES: dict[str, str] = _spelling_aliases(
    _serving_fields() | {"host_network", "node_selector"})


def _norm(d: dict[str, Any], aliases: "dict[str, str] | None" = None,
          known: "frozenset[str] | None" = None) -> dict[str, Any]:
    # Snake_case wins when both spellings are present (the CRD schema
    # declares both so neither is pruned; a manifest carrying both must
    # resolve deterministically, not by dict order).
    aliases = KEBAB_ALIASES if aliases is None else aliases
    known = _KNOWN_SNAKE_FIELDS if known is None else known
    out: dict[str, Any] = {}
    for k, v in d.items():
        nk = aliases.get(k, k)
        if nk == k and "-" in k and k.replace("-", "_") in known:
            # e.g. 'etcd-endpoint': a kebab spelling of a real field that
            # the CRD schema does not declare; kubectl apply would prune it
            # and the field would fall back to its default
            log.warn("manifest key looks like kebab-case for a known field "
                     "but is not a declared alias (k8s/crd.yaml); it is "
                     "IGNORED", key=k, spell_it=k.replace("-", "_"))
        if nk == k or nk not in d:
            out[nk] = v
    return out


def _reject_topology(section: dict[str, Any], where: str) -> None:
    if section.get("topology"):
        raise ValueError(
            f"{where}.topology={section['topology']!r}: a TPU slice shape "
            "has no counterpart on GPUs; claim cards with "
            f"{where}.resources.limits['nvidia.com/gpu'] instead")


def _resources(d: dict[str, Any] | None, where: str) -> ResourceRequirements:
    d = _norm(d or {})
    out = {}
    for which in ("requests", "limits"):
        m = d.get(which) or {}
        if TPU_RESOURCE in m:
            raise ValueError(
                f"{where}.resources.{which}['{TPU_RESOURCE}']: a TPU chip "
                "claim; this build's accelerator resource is "
                "'nvidia.com/gpu'")
        out[which] = {k: str(v) for k, v in m.items()}
    return ResourceRequirements(**out)


def job_from_dict(doc: dict[str, Any]) -> TrainingJob:
    if doc.get("kind", KIND) != KIND:
        raise ValueError(f"not a {KIND} manifest: kind={doc.get('kind')!r}")
    meta = _norm(doc.get("metadata") or {})
    spec = _norm(doc.get("spec") or {})

    t = _norm(spec.get("trainer") or {})
    _reject_topology(t, "spec.trainer")
    trainer = TrainerSpec(
        entrypoint=t.get("entrypoint", ""),
        workspace=t.get("workspace", ""),
        min_instance=int(t.get("min_instance", 1)),
        max_instance=int(t.get("max_instance", 1)),
        resources=_resources(t.get("resources"), "spec.trainer"),
        allow_multi_domain=bool(t.get("allow_multi_domain", False)),
        # int or a tier name ("high"); declared int-or-string in the CRD
        priority=SchedPriority.parse(
            t.get("priority", SchedPriority.NORMAL)),
        env={k: str(v) for k, v in (t.get("env") or {}).items()},
        volumes=[dict(v) for v in (t.get("volumes") or [])],
        volume_mounts=[dict(v) for v in (t.get("volume_mounts") or [])],
        image_pull_secrets=[dict(v)
                            for v in (t.get("image_pull_secrets") or [])],
    )
    p = _norm(spec.get("pserver") or {})
    pserver = PserverSpec(
        min_instance=int(p.get("min_instance", 0)),
        max_instance=int(p.get("max_instance", 0)),
        resources=_resources(p.get("resources"), "spec.pserver"),
    )
    m = _norm(spec.get("master") or {})
    master = MasterSpec(
        etcd_endpoint=m.get("etcd_endpoint", m.get("coord_endpoint", "")),
        resources=_resources(m.get("resources"), "spec.master"),
    )
    return TrainingJob(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        labels=dict(meta.get("labels") or {}),
        spec=TrainingJobSpec(
            image=spec.get("image", ""),
            port=int(spec.get("port", 0)),
            ports_num=int(spec.get("ports_num", 0)),
            ports_num_for_sparse=int(spec.get("ports_num_for_sparse", 0)),
            fault_tolerant=bool(spec.get("fault_tolerant", False)),
            passes=int(spec.get("passes", 0)),
            host_network=bool(spec.get("host_network", False)),
            node_selector=dict(spec.get("node_selector") or {}),
            trainer=trainer,
            pserver=pserver,
            master=master,
        ),
    )


def _res_dict(r: ResourceRequirements) -> dict[str, Any]:
    return {
        "requests": {k: str(v) for k, v in r.requests.items()},
        "limits": {k: str(v) for k, v in r.limits.items()},
    }


def job_to_dict(job: TrainingJob) -> dict[str, Any]:
    t = job.spec.trainer
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": job.name, "namespace": job.namespace,
                     "labels": dict(job.labels)},
        "spec": {
            "image": job.spec.image,
            "port": job.spec.port,
            "ports_num": job.spec.ports_num,
            "ports_num_for_sparse": job.spec.ports_num_for_sparse,
            "fault_tolerant": job.spec.fault_tolerant,
            "passes": job.spec.passes,
            "host_network": job.spec.host_network,
            "node_selector": dict(job.spec.node_selector),
            "trainer": {
                "entrypoint": t.entrypoint,
                "workspace": t.workspace,
                "min_instance": t.min_instance,
                "max_instance": t.max_instance,
                "allow_multi_domain": t.allow_multi_domain,
                "priority": int(t.priority),
                "env": {k: str(v) for k, v in sorted(t.env.items())},
                "volumes": [dict(v) for v in t.volumes],
                "volume_mounts": [dict(v) for v in t.volume_mounts],
                "image_pull_secrets": [dict(v)
                                       for v in t.image_pull_secrets],
                "resources": _res_dict(t.resources),
            },
            "pserver": {
                "min_instance": job.spec.pserver.min_instance,
                "max_instance": job.spec.pserver.max_instance,
                "resources": _res_dict(job.spec.pserver.resources),
            },
            "master": {
                "etcd_endpoint": job.spec.master.etcd_endpoint,
                "resources": _res_dict(job.spec.master.resources),
            },
        },
    }


def serving_job_from_dict(doc: dict[str, Any]) -> ServingJob:
    """ServingJob manifest → resource.  The shape mirrors TrainingJob's:
    job-level image/port under ``spec``, the replica fleet under
    ``spec.server``; snake_case canonical, kebab and camelCase accepted per
    :data:`SERVING_ALIASES`."""
    if doc.get("kind", KIND_SERVING) != KIND_SERVING:
        raise ValueError(
            f"not a {KIND_SERVING} manifest: kind={doc.get('kind')!r}")
    fields = _serving_fields() | {"host_network", "node_selector",
                                  "name", "namespace", "labels",
                                  "image", "port", "server",
                                  "requests", "limits"}
    meta = _norm(doc.get("metadata") or {}, SERVING_ALIASES, fields)
    spec = _norm(doc.get("spec") or {}, SERVING_ALIASES, fields)
    s = _norm(spec.get("server") or {}, SERVING_ALIASES, fields)
    _reject_topology(s, "spec.server")
    serving = ServingSpec(
        model_dir=str(s.get("model_dir", "")),
        model=str(s.get("model", ServingSpec.model)),
        min_replicas=int(s.get("min_replicas", 1)),
        max_replicas=int(s.get("max_replicas", 1)),
        resources=_resources(s.get("resources"), "spec.server"),
        slo_p99_ms=float(s.get("slo_p99_ms", 100.0)),
        target_qps_per_replica=float(s.get("target_qps_per_replica", 0.0)),
        max_batch_size=int(s.get("max_batch_size", 8)),
        max_queue_ms=float(s.get("max_queue_ms", 2.0)),
        drain_timeout_s=float(s.get("drain_timeout_s", 30.0)),
        reload_poll_s=float(s.get("reload_poll_s", 5.0)),
        env={k: str(v) for k, v in (s.get("env") or {}).items()},
        priority=SchedPriority.parse(
            s.get("priority", SchedPriority.NORMAL)),
    )
    return ServingJob(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        labels=dict(meta.get("labels") or {}),
        image=spec.get("image", ""),
        port=int(spec.get("port", 0)),
        host_network=bool(spec.get("host_network", False)),
        node_selector=dict(spec.get("node_selector") or {}),
        spec=serving,
    )


def serving_job_to_dict(job: ServingJob) -> dict[str, Any]:
    s = job.spec
    return {
        "apiVersion": API_VERSION,
        "kind": KIND_SERVING,
        "metadata": {"name": job.name, "namespace": job.namespace,
                     "labels": dict(job.labels)},
        "spec": {
            "image": job.image,
            "port": job.port,
            "host_network": job.host_network,
            "node_selector": dict(job.node_selector),
            "server": {
                "model_dir": s.model_dir,
                "model": s.model,
                "min_replicas": s.min_replicas,
                "max_replicas": s.max_replicas,
                "slo_p99_ms": s.slo_p99_ms,
                "target_qps_per_replica": s.target_qps_per_replica,
                "max_batch_size": s.max_batch_size,
                "max_queue_ms": s.max_queue_ms,
                "drain_timeout_s": s.drain_timeout_s,
                "reload_poll_s": s.reload_poll_s,
                "priority": int(s.priority),
                "env": {k: str(v) for k, v in sorted(s.env.items())},
                "resources": _res_dict(s.resources),
            },
        },
    }


# -- text ----------------------------------------------------------------------


def _yaml():
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            "this manifest is not JSON, and YAML needs the PyYAML package, "
            "which is not installed: write the manifest as JSON") from None
    return yaml


def is_json(text: str) -> bool:
    """True when ``text`` is a JSON document (what :func:`load_document`
    reads without PyYAML)."""
    try:
        json.loads(text)
    except ValueError:
        return False
    return True


def load_document(text: str) -> Any:
    """One manifest document from its text: JSON through :mod:`json`, any
    other text through PyYAML."""
    try:
        return json.loads(text)
    except ValueError:
        return _yaml().safe_load(text)


def dump_document(doc: dict[str, Any], as_json: bool = False) -> str:
    """A manifest dict as text: JSON (no PyYAML needed) or YAML."""
    if as_json:
        return json.dumps(doc, indent=2) + "\n"
    return _yaml().safe_dump(doc, sort_keys=False)


def serving_job_from_yaml(text: str) -> ServingJob:
    return serving_job_from_dict(load_document(text))


def serving_job_to_yaml(job: ServingJob) -> str:
    return dump_document(serving_job_to_dict(job))


def manifest_from_dict(doc: dict[str, Any]) -> "TrainingJob | ServingJob":
    """Kind-dispatching decode: the one entry point for code (CLI
    submit/validate, the CRD sync loop) that accepts either job kind."""
    if doc.get("kind", KIND) == KIND_SERVING:
        return serving_job_from_dict(doc)
    return job_from_dict(doc)


def manifest_to_dict(job: "TrainingJob | ServingJob") -> dict[str, Any]:
    if isinstance(job, ServingJob):
        return serving_job_to_dict(job)
    return job_to_dict(job)


def load_manifest_file(path: str) -> "TrainingJob | ServingJob":
    with open(path) as f:
        return manifest_from_dict(load_document(f.read()))


def status_to_dict(status: TrainingJobStatus) -> dict[str, Any]:
    """Status → the CR ``status`` subresource shape (reference
    pkg/apis/paddlepaddle/v1/types.go:113-162; written back by
    updateCRDStatus, pkg/updater/trainingJobUpdater.go:295-307)."""
    return {
        "phase": status.phase.value,
        "reason": status.reason,
        "replica_statuses": [
            {
                "resource_type": rs.resource_type,
                "state": rs.state.value,
                "resource_states": {
                    k: v.value for k, v in sorted(rs.resource_states.items())},
            }
            for rs in status.replica_statuses
        ],
    }


def status_from_dict(doc: dict[str, Any] | None) -> TrainingJobStatus:
    doc = doc or {}
    try:
        phase = JobPhase(doc.get("phase", "None"))
    except ValueError:
        phase = JobPhase.NONE
    replica_statuses = []
    for rs in doc.get("replica_statuses") or []:
        try:
            state = ResourceState(rs.get("state", "None"))
            states = {k: ResourceState(v)
                      for k, v in (rs.get("resource_states") or {}).items()}
        except ValueError:
            continue  # a future state value: skip the entry, keep the phase
        replica_statuses.append(TrainingResourceStatus(
            resource_type=rs.get("resource_type", ""),
            state=state,
            resource_states=states,
        ))
    return TrainingJobStatus(
        phase=phase,
        reason=doc.get("reason", ""),
        replica_statuses=replica_statuses,
    )


def job_from_yaml(text: str) -> TrainingJob:
    return job_from_dict(load_document(text))


def job_to_yaml(job: TrainingJob) -> str:
    return dump_document(job_to_dict(job))


def load_job_file(path: str) -> TrainingJob:
    with open(path) as f:
        return job_from_yaml(f.read())
