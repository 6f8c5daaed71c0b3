"""Job compilation: TrainingJob → runnable worker-group specs — the port's
copy of edl_tpu.controller.jobparser, whose pods run the port's modules.

Role of the reference's DefaultJobParser (reference pkg/jobparser.go:30-315,
pkg/updater/jobparser.go:35-335), which compiles a TrainingJob into a
trainer batch Job, a pserver ReplicaSet, and a master ReplicaSet with an
etcd sidecar.  Here:

* the **master** role becomes one *coordinator* pod running the port's
  coordination server (``python -m edl_tpu_torch.coord.server``: task-lease
  queue + membership epochs, C++ core) — no etcd sidecar; the coordinator
  holds the state the reference kept in etcd (reference
  pkg/jobparser.go:167-184).
* the **pserver** role is only materialized when the spec asks for it
  (migration compatibility); the trainer shards parameters itself.
* the **env contract** (role of PADDLE_INIT_*, reference
  pkg/jobparser.go:263-311) is the JAX package's ``EDL_*`` contract, read
  by ``python -m edl_tpu_torch.runtime.launcher``, with the accelerator a
  count of cards (``EDL_GPUS_PER_TRAINER``) and no slice topology.
* port fan-out (reference podPorts, jobparser.go:232-247) collapses to one
  coordinator port: collectives ride NCCL/gloo process groups the world
  forms itself, not a TCP port range the manifest names.

The fault-tolerant trainer's compile-cache volume and ``EDL_COMPILE_CACHE``
are kept.  In the port they name the build root of the hand-written CUDA
kernels and of the native coordinator (``ops/_build.py``,
``coord/bindings.py``): every world child the pod's supervisor respawns
across membership epochs loads the libraries the first one built, instead
of running nvcc again.
"""

from __future__ import annotations

from typing import Any

from edl_tpu_torch.api.types import (
    COORDINATOR_LABEL,
    DEFAULT_PORT,
    DEFAULT_SERVING_PORT,
    MULTI_DOMAIN_LABEL,
    PSERVER_LABEL,
    SERVING_LABEL,
    TRAINER_LABEL,
    ServingJob,
    TrainingJob,
)

COORDINATOR_PORT = DEFAULT_PORT  # single source of truth (api/types.py)
HEALTH_PORT = 8080  # role of the master's 8080 (reference jobparser.go:249-261)

#: the pod modules the compiled commands run
LAUNCHER_MODULE = "edl_tpu_torch.runtime.launcher"
COORDINATOR_MODULE = "edl_tpu_torch.coord.server"

#: where FT trainer pods keep the kernels' build root (read through
#: EDL_COMPILE_CACHE by ops/_build.py and coord/bindings.py).  Backed by
#: an emptyDir: every world child the pod's supervisor respawns across
#: membership epochs loads the libraries the previous child built, so nvcc
#: runs once per pod instead of once per epoch.  Mount a shared PVC at the
#: same path (spec.trainer.volumes/volume_mounts override the default) to
#: amortize across pods and restarts too.
COMPILE_CACHE_PATH = "/var/edl/compile-cache"
COMPILE_CACHE_VOLUME = "edl-compile-cache"

#: downward-API pod identity (role of the reference's NAMESPACE/POD_IP
#: fieldRefs, pkg/jobparser.go:263-311).  HOSTNAME is NOT a substitute:
#: under spec.host_network it is the node's hostname, so the static
#: path's rank lookup would use the wrong identity.
_DOWNWARD_ENV = [
    {"name": "EDL_POD_NAME",
     "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}}},
    {"name": "EDL_POD_IP",
     "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}}},
]


def _trainer_labels(job: TrainingJob) -> dict[str, str]:
    labels = {TRAINER_LABEL: job.name}
    if job.spec.trainer.allow_multi_domain:
        # the pod IS the inventory's unit of truth: the label tells the
        # cluster backend not to pin this job to one NVLink domain
        labels[MULTI_DOMAIN_LABEL] = "true"
    return labels


def pod_env(job: TrainingJob, role: str) -> dict[str, str]:
    """Environment contract consumed by the elastic runtime entrypoint
    (role of podEnv, reference pkg/jobparser.go:263-311; consumed by
    docker/paddle_k8s + trainers in the reference, by
    edl_tpu_torch.runtime.launcher here)."""
    spec = job.spec
    env = {
        "EDL_JOB_NAME": job.name,
        "EDL_NAMESPACE": job.namespace,
        "EDL_ROLE": role,
        "EDL_FAULT_TOLERANT": "1" if spec.fault_tolerant else "0",
        "EDL_TRAINER_MIN": str(spec.trainer.min_instance),
        "EDL_TRAINER_MAX": str(spec.trainer.max_instance),
        "EDL_PASSES": str(spec.passes),
        "EDL_ENTRY": spec.trainer.entrypoint,
        "EDL_TRAINER_PACKAGE": spec.trainer.workspace,
        # role of ETCD_IP / MASTER_IP discovery (paddle_k8s:119-141): the
        # runtime resolves the coordinator endpoint itself, but a fixed
        # port is part of the contract.
        "EDL_COORD_PORT": str(spec.port or COORDINATOR_PORT),
        "EDL_GPUS_PER_TRAINER": str(job.gpus_per_trainer()),
    }
    if spec.fault_tolerant and role == "trainer":
        # Mid-world checkpoint cadence ON by default for deployed FT
        # trainers: the reference's pserver param residency meant a
        # trainer crash never lost global state; the equivalent here
        # (the supervisor's mid-world generations) must be armed out of
        # the box or a crash loses everything back to the last membership
        # change.  spec.trainer.env (merged below) overrides per job.
        env["EDL_MH_CKPT_EVERY"] = "200"
        # the kernels' build root, shared by the pod's world children
        # (see COMPILE_CACHE_PATH)
        env["EDL_COMPILE_CACHE"] = COMPILE_CACHE_PATH
    if spec.master.etcd_endpoint:
        env["EDL_COORD_ENDPOINT"] = spec.master.etcd_endpoint
    elif spec.fault_tolerant:
        # Default endpoint = the coordinator Service's cluster DNS name
        # (role of the MASTER_IP discovery the reference did by polling
        # pods, paddle_k8s:128-129 — a Service is the k8s-idiomatic form).
        env["EDL_COORD_ENDPOINT"] = (
            f"{job.name}-coordinator.{job.namespace}.svc"
            f":{spec.port or COORDINATOR_PORT}")
    if role == "trainer":
        # user env merged LAST — after every generated key, including the
        # endpoint and cache defaults above — so the documented "user
        # values win" contract holds for all of them
        env.update({k: str(v) for k, v in spec.trainer.env.items()})
    return env


def _resources_dict(res) -> dict[str, dict[str, str]]:
    return {
        "requests": {k: str(v) for k, v in res.requests.items()},
        "limits": {k: str(v) for k, v in res.limits.items()},
    }


def parse_to_trainer(job: TrainingJob) -> dict[str, Any]:
    """Trainer group manifest (role of ParseToTrainer,
    reference pkg/jobparser.go:120-165): parallelism starts at min_instance,
    restart-policy Never — failures are survived by elasticity, not pod
    restarts."""
    spec = job.spec
    # user-declared pod-template passthroughs, verbatim (datasets on PVCs,
    # /dev/shm tmpfs, private registries) — plus the FT path's
    # compile-cache emptyDir, which a user volume of the same name
    # overrides
    volumes = [dict(v) for v in spec.trainer.volumes]
    mounts = [dict(m) for m in spec.trainer.volume_mounts]
    if spec.fault_tolerant:
        if not any(v.get("name") == COMPILE_CACHE_VOLUME for v in volumes):
            volumes.append({"name": COMPILE_CACHE_VOLUME, "emptyDir": {}})
        if not any(m.get("mountPath") == COMPILE_CACHE_PATH for m in mounts):
            mounts.append({"name": COMPILE_CACHE_VOLUME,
                           "mountPath": COMPILE_CACHE_PATH})
    container = {
        "name": "trainer",
        "image": spec.image,
        # FT jobs take the coordinator-backed elastic path; non-FT jobs
        # take the static barrier path (rank from the sorted pod list) —
        # the reference's start_new_trainer vs start_trainer v2 switch
        # (pkg/jobparser.go:124)
        "command": ["python", "-m", LAUNCHER_MODULE,
                    "start_trainer"
                    if spec.fault_tolerant
                    else "start_static_trainer"],
        "env": [
            {"name": k, "value": v}
            for k, v in pod_env(job, "trainer").items()
        ] + list(_DOWNWARD_ENV),
        "resources": _resources_dict(spec.trainer.resources),
    }
    if mounts:
        container["volumeMounts"] = mounts
    pod_spec: dict[str, Any] = {
        "restartPolicy": "Never",
        "nodeSelector": dict(spec.node_selector),
        "hostNetwork": spec.host_network,
        "containers": [container],
    }
    if volumes:
        pod_spec["volumes"] = volumes
    if spec.trainer.image_pull_secrets:
        pod_spec["imagePullSecrets"] = [
            dict(s) for s in spec.trainer.image_pull_secrets]
    return {
        "kind": "Job",
        "apiVersion": "batch/v1",
        "metadata": {
            "name": f"{job.name}-trainer",
            "namespace": job.namespace,
            "labels": _trainer_labels(job),
        },
        "spec": {
            "parallelism": spec.trainer.min_instance,
            "template": {
                "metadata": {"labels": _trainer_labels(job)},
                "spec": pod_spec,
            },
        },
    }


def parse_to_coordinator(job: TrainingJob) -> dict[str, Any]:
    """Coordinator manifest (role of ParseToMaster,
    reference pkg/jobparser.go:167-227, minus the etcd sidecar — the
    coordinator subsumes it)."""
    spec = job.spec
    return {
        "kind": "ReplicaSet",
        "apiVersion": "apps/v1",
        "metadata": {
            "name": f"{job.name}-coordinator",
            "namespace": job.namespace,
            "labels": {COORDINATOR_LABEL: job.name},
        },
        "spec": {
            "replicas": 1,
            "template": {
                "metadata": {
                    "labels": {COORDINATOR_LABEL: job.name},
                    # the health port also serves GET /metrics in
                    # Prometheus text (server.cc): one scrape config
                    # covers coordinators and the controller alike
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/path": "/metrics",
                        "prometheus.io/port": str(HEALTH_PORT),
                    },
                },
                "spec": {
                    "containers": [
                        {
                            "name": "coordinator",
                            "image": spec.image,
                            "command": ["python", "-m", COORDINATOR_MODULE],
                            "ports": [
                                {"containerPort": spec.port or COORDINATOR_PORT,
                                 "name": "coord"},
                                {"containerPort": HEALTH_PORT, "name": "health"},
                            ],
                            "env": [
                                {"name": k, "value": v}
                                for k, v in pod_env(job, "coordinator").items()
                            ] + [
                                # durability across pod restarts (role of
                                # the reference's etcd sidecar persistence,
                                # pkg/jobparser.go:167-184): write-through
                                # state on the pod volume; swap the
                                # emptyDir for a PVC to also survive node
                                # loss
                                {"name": "EDL_COORD_STATE_FILE",
                                 "value": "/var/edl-coord/state"},
                                # serve GET /healthz on the advertised
                                # health port (role of the master's :8080,
                                # reference docker/paddle_k8s:27-31) — the
                                # probes below point at it
                                {"name": "EDL_HEALTH_PORT",
                                 "value": str(HEALTH_PORT)},
                            ],
                            "volumeMounts": [
                                {"name": "coord-state",
                                 "mountPath": "/var/edl-coord"},
                            ],
                            # a wedged coordinator (accepting but not
                            # answering, or not accepting at all) must be
                            # restarted by the kubelet, not noticed by a
                            # human: the health server runs in the coord
                            # process, so probe failure == process wedge
                            "livenessProbe": {
                                "httpGet": {"path": "/healthz",
                                            "port": HEALTH_PORT},
                                "initialDelaySeconds": 5,
                                "periodSeconds": 10,
                                "timeoutSeconds": 2,
                                "failureThreshold": 3,
                            },
                            "readinessProbe": {
                                "httpGet": {"path": "/healthz",
                                            "port": HEALTH_PORT},
                                "periodSeconds": 5,
                                "timeoutSeconds": 2,
                            },
                            "resources": _resources_dict(spec.master.resources),
                        }
                    ],
                    "volumes": [
                        {"name": "coord-state", "emptyDir": {}},
                    ],
                },
            },
        },
    }


def parse_to_pserver(job: TrainingJob) -> dict[str, Any] | None:
    """Parameter-server manifest (role of ParseToPserver, reference
    pkg/jobparser.go:74-117) — only for migration-mode jobs that request it;
    returns None when the spec leaves the role empty."""
    spec = job.spec
    if spec.pserver.min_instance <= 0:
        return None
    return {
        "kind": "ReplicaSet",
        "apiVersion": "apps/v1",
        "metadata": {
            "name": f"{job.name}-pserver",
            "namespace": job.namespace,
            "labels": {PSERVER_LABEL: job.name},
        },
        "spec": {
            "replicas": spec.pserver.min_instance,
            "template": {
                "metadata": {"labels": {PSERVER_LABEL: job.name}},
                "spec": {
                    "containers": [
                        {
                            "name": "pserver",
                            "image": spec.image,
                            "command": ["python", "-m", LAUNCHER_MODULE,
                                        "start_pserver"],
                            "env": [
                                {"name": k, "value": v}
                                for k, v in pod_env(job, "pserver").items()
                            ] + list(_DOWNWARD_ENV),
                            "resources": _resources_dict(spec.pserver.resources),
                        }
                    ],
                },
            },
        },
    }


def parse_to_coordinator_service(job: TrainingJob) -> dict[str, Any]:
    """Stable DNS name for the coordinator (role of the master's
    discoverability — the reference resolved the master pod IP by polling,
    paddle_k8s:128-129; a Service is the k8s-idiomatic equivalent and what
    pod_env's default EDL_COORD_ENDPOINT points at)."""
    spec = job.spec
    return {
        "kind": "Service",
        "apiVersion": "v1",
        "metadata": {
            "name": f"{job.name}-coordinator",
            "namespace": job.namespace,
            "labels": {COORDINATOR_LABEL: job.name},
        },
        "spec": {
            "selector": {COORDINATOR_LABEL: job.name},
            "ports": [
                {"name": "coord", "port": spec.port or COORDINATOR_PORT},
                {"name": "health", "port": HEALTH_PORT},
            ],
        },
    }


def parse_to_manifests(job: TrainingJob) -> list[dict[str, Any]]:
    """All worker-group manifests for a job, coordinator first (the
    Gen-2 create order: master → pserver → trainer,
    reference pkg/updater/trainingJobUpdater.go:282-293)."""
    out: list[dict[str, Any]] = []
    if job.spec.fault_tolerant:
        out.append(parse_to_coordinator(job))
        out.append(parse_to_coordinator_service(job))
    ps = parse_to_pserver(job)
    if ps is not None:
        out.append(ps)
    out.append(parse_to_trainer(job))
    return out


# -- ServingJob compilation ----------------------------------------------------

def serving_pod_env(job: ServingJob) -> dict[str, str]:
    """EDL_SERVING_* env contract for server pods — consumed by the
    ``start_server`` launcher verb (runtime/serving.py serve_main), the
    serving twin of :func:`pod_env`.  User env merges LAST so the
    documented "user values win" contract holds."""
    s = job.spec
    env = {
        "EDL_JOB_NAME": job.name,
        "EDL_NAMESPACE": job.namespace,
        "EDL_ROLE": "server",
        "EDL_SERVING_PORT": str(job.port or DEFAULT_SERVING_PORT),
        "EDL_SERVING_MODEL_DIR": s.model_dir,
        "EDL_SERVING_MODEL": s.model,
        "EDL_SERVING_SLO_P99_MS": str(s.slo_p99_ms),
        "EDL_SERVING_MAX_BATCH": str(s.max_batch_size),
        "EDL_SERVING_MAX_QUEUE_MS": str(s.max_queue_ms),
        "EDL_SERVING_DRAIN_S": str(s.drain_timeout_s),
        "EDL_SERVING_RELOAD_POLL_S": str(s.reload_poll_s),
    }
    env.update({k: str(v) for k, v in s.env.items()})
    return env


def parse_to_server_group(job: ServingJob) -> dict[str, Any]:
    """Model-server ReplicaSet: ``replicas`` is the elastic dial the SLO
    policy moves (the serving analogue of the trainer Job's
    ``parallelism``).  The READINESS probe is load-bearing — it is the
    ready gate: a replica still building its model answers /healthz 503,
    the Service holds traffic off it, and the warm-up never rides a
    request."""
    s = job.spec
    container = {
        "name": "server",
        "image": job.image,
        "command": ["python", "-m", LAUNCHER_MODULE, "start_server"],
        "env": [{"name": k, "value": v}
                for k, v in serving_pod_env(job).items()]
        + list(_DOWNWARD_ENV),
        "ports": [
            {"containerPort": job.port or DEFAULT_SERVING_PORT,
             "name": "serve"},
            {"containerPort": HEALTH_PORT, "name": "health"},
        ],
        "resources": _resources_dict(s.resources),
        "readinessProbe": {
            "httpGet": {"path": "/healthz", "port": HEALTH_PORT},
            "periodSeconds": 2,
            "timeoutSeconds": 2,
        },
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": HEALTH_PORT},
            "initialDelaySeconds": 30,
            "periodSeconds": 10,
            "timeoutSeconds": 2,
            "failureThreshold": 3,
        },
    }
    return {
        "kind": "ReplicaSet",
        "apiVersion": "apps/v1",
        "metadata": {
            "name": f"{job.name}-server",
            "namespace": job.namespace,
            "labels": {SERVING_LABEL: job.name},
        },
        "spec": {
            "replicas": s.min_replicas,
            "template": {
                "metadata": {
                    "labels": {SERVING_LABEL: job.name},
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/path": "/metrics",
                        "prometheus.io/port": str(HEALTH_PORT),
                    },
                },
                "spec": {
                    "restartPolicy": "Always",
                    "nodeSelector": dict(job.node_selector),
                    "hostNetwork": job.host_network,
                    "containers": [container],
                },
            },
        },
    }


def parse_to_serving_service(job: ServingJob) -> dict[str, Any]:
    """The traffic front door: a Service over READY server pods — what
    makes the readiness gate an actual traffic gate (an unready replica
    is not an endpoint)."""
    return {
        "kind": "Service",
        "apiVersion": "v1",
        "metadata": {
            "name": f"{job.name}-serve",
            "namespace": job.namespace,
            "labels": {SERVING_LABEL: job.name},
        },
        "spec": {
            "selector": {SERVING_LABEL: job.name},
            "ports": [
                {"name": "serve", "port": job.port or DEFAULT_SERVING_PORT},
                {"name": "health", "port": HEALTH_PORT},
            ],
        },
    }


def parse_serving_manifests(job: ServingJob) -> list[dict[str, Any]]:
    """All manifests for a ServingJob: the replica set + its Service."""
    return [parse_to_server_group(job), parse_to_serving_service(job)]
