"""Kubernetes cluster backend — the port's copy of edl_tpu.cluster.k8s.

Role of the reference's real k8s façade (reference pkg/cluster.go:31-291):
node/pod inventory via the apiserver, trainer-group actuation via a
Job-like resource's parallelism, GPU capacity read from the
``nvidia.com/gpu`` allocatable (where the reference read
``alpha.kubernetes.io/nvidia-gpu``, cluster.go:224), and each node's NVLink
domain from a node label (:data:`NVLINK_DOMAIN_LABELS`).

Gated on the ``kubernetes`` client package, which is not part of this
build's dependency set — constructing :class:`K8sCluster` without it raises
a clear error, and everything else in the port (controller, scheduler,
runtime, tests, the process-backed kubelet) runs against
:class:`~edl_tpu_torch.cluster.fake.FakeCluster`.
"""

from __future__ import annotations

from dataclasses import dataclass

from edl_tpu_torch.api.types import (
    COORDINATOR_LABEL,
    MULTI_DOMAIN_LABEL,
    PSERVER_LABEL,
    RESOURCE_GPU,
    SERVING_LABEL,
    TRAINER_LABEL,
    TrainingJob,
)
from edl_tpu_torch.cluster.base import (Cluster, ConflictError, PodCounts,
                                        PodPhase)
from edl_tpu_torch.cluster.resource import ClusterResource, NodeResources


@dataclass(frozen=True)
class PodView:
    """Read-only pod record matching the FakePod attribute surface."""

    name: str
    job_uid: str
    role: str
    phase: PodPhase
    node: str | None = None
    deletion_timestamp: bool = False
    cpu_request_milli: int = 0
    memory_request_mega: int = 0
    gpu_limit: int = 0
    #: pod IP — the static path's rendezvous address (role of the
    #: reference's fetch_ips, docker/k8s_tools.py:95-110)
    ip: str = ""

try:
    import kubernetes  # type: ignore

    _HAVE_K8S = True
except ImportError:
    _HAVE_K8S = False

#: Node labels that identify the NVLink domain a GPU node belongs to, in
#: preference order: an explicit label, then the NVLink clique the NVIDIA
#: GPU feature discovery publishes for multi-node NVLink systems.  A node
#: with neither is its own domain (its cards' NVLink stays inside it).
NVLINK_DOMAIN_LABELS = (
    "edl-tpu/nvlink-domain",
    "nvidia.com/gpu.clique",
)


class K8sCluster(Cluster):
    """Live-cluster backend; requires the ``kubernetes`` package."""

    def __init__(self, kubeconfig: str | None = None, namespace: str = "default"):
        if not _HAVE_K8S:
            raise RuntimeError(
                "K8sCluster requires the 'kubernetes' package; this build "
                "image does not include it — use FakeCluster, or install "
                "kubernetes in a deployment image"
            )
        if kubeconfig:
            kubernetes.config.load_kube_config(kubeconfig)
        else:
            kubernetes.config.load_incluster_config()
        self._core = kubernetes.client.CoreV1Api()
        self._batch = kubernetes.client.BatchV1Api()
        self._custom = kubernetes.client.CustomObjectsApi()
        self.namespace = namespace

    # The method bodies below mirror reference pkg/cluster.go behavior and
    # only run with the kubernetes package present.

    def inquiry_resource(self) -> ClusterResource:
        r = ClusterResource()
        nodes = NodeResources()
        for node in self._core.list_node().items:
            alloc = node.status.allocatable or {}
            cpu = _milli(alloc.get("cpu", "0"))
            mem = _mega(alloc.get("memory", "0"))
            gpu = int(alloc.get(RESOURCE_GPU, "0"))
            r.node_count += 1
            r.cpu_total_milli += cpu
            r.memory_total_mega += mem
            r.gpu_total += gpu
            nodes.nodes_cpu_idle_milli[node.metadata.name] = cpu
            nodes.nodes_memory_free_mega[node.metadata.name] = mem
            nodes.nodes_gpu_free[node.metadata.name] = gpu
            labels = node.metadata.labels or {}
            for key in NVLINK_DOMAIN_LABELS:
                if labels.get(key):
                    nodes.nodes_nvlink_domain[node.metadata.name] = labels[key]
                    break
        # all non-terminal pods hold their requests (cluster.go:202-242)
        pods = self._core.list_pod_for_all_namespaces(
            field_selector="status.phase!=Succeeded,status.phase!=Failed"
        )
        for pod in pods.items:
            creq, cl, mreq, ml, gl = _pod_resources(pod)
            r.cpu_request_milli += creq
            r.cpu_limit_milli += cl
            r.memory_request_mega += mreq
            r.memory_limit_mega += ml
            r.gpu_request += gl
            r.gpu_limit += gl
            nn = pod.spec.node_name
            if nn in nodes.nodes_cpu_idle_milli:
                nodes.nodes_cpu_idle_milli[nn] -= creq
                nodes.nodes_memory_free_mega[nn] -= mreq
                nodes.nodes_gpu_free[nn] -= gl
            labels = pod.metadata.labels or {}
            # Pin only to LIVE nodes: a non-terminal pod lingering on a
            # deleted/drained node must not pin its job to a domain that no
            # longer exists (the planner would find no candidate nodes and
            # freeze the job's scale-up until the stale pod is reaped).
            # multi-domain jobs (MULTI_DOMAIN_LABEL) are never pinned —
            # a pin would re-cap them at one domain.
            if (gl > 0 and TRAINER_LABEL in labels
                    and MULTI_DOMAIN_LABEL not in labels
                    and nn in nodes.nodes_cpu_idle_milli):
                uid = f"{pod.metadata.namespace}/{labels[TRAINER_LABEL]}"
                r.jobs_nvlink_domain.setdefault(
                    uid, nodes.nodes_nvlink_domain.get(nn, nn))
        r.nodes = nodes
        return r

    def get_trainer_parallelism(self, job: TrainingJob) -> int:
        if getattr(job, "replica_role", "trainer") == "server":
            apps = kubernetes.client.AppsV1Api()
            rs = apps.read_namespaced_replica_set(
                f"{job.name}-server", job.namespace)
            return int(rs.spec.replicas or 0)
        tj = self._batch.read_namespaced_job(_trainer_name(job), job.namespace)
        return int(tj.spec.parallelism or 0)

    def update_trainer_parallelism(self, job: TrainingJob, parallelism: int
                                   ) -> None:
        """Fresh-read then replace; a 409 (stale resourceVersion — someone
        wrote between our read and replace) surfaces as ConflictError so the
        autoscaler's bounded retry re-reads and tries again (reference
        autoscaler.go:339-376 does the same 5-retry refresh-then-write).
        The replica-group dial is workload-agnostic: a TrainingJob's dial
        is the trainer Job's ``parallelism``, a ServingJob's the server
        ReplicaSet's ``replicas``."""
        if getattr(job, "replica_role", "trainer") == "server":
            apps = kubernetes.client.AppsV1Api()
            name = f"{job.name}-server"
            rs = apps.read_namespaced_replica_set(name, job.namespace)
            rs.spec.replicas = parallelism
            try:
                apps.replace_namespaced_replica_set(name, job.namespace, rs)
            except kubernetes.client.exceptions.ApiException as exc:
                if exc.status == 409:
                    raise ConflictError(
                        f"resourceVersion conflict updating {name}") from exc
                raise
            return
        name = _trainer_name(job)
        tj = self._batch.read_namespaced_job(name, job.namespace)
        tj.spec.parallelism = parallelism
        try:
            self._batch.replace_namespaced_job(name, job.namespace, tj)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 409:
                raise ConflictError(
                    f"resourceVersion conflict updating {name}") from exc
            raise

    def job_pods(self, job: TrainingJob) -> PodCounts:
        label = (SERVING_LABEL
                 if getattr(job, "replica_role", "trainer") == "server"
                 else TRAINER_LABEL)
        sel = f"{label}={job.name}"
        total = running = pending = succeeded = failed = 0
        for pod in self._core.list_namespaced_pod(
            job.namespace, label_selector=sel
        ).items:
            total += 1
            if pod.metadata.deletion_timestamp is not None:
                continue
            if pod.status.phase == "Running":
                running += 1
            elif pod.status.phase == "Pending":
                pending += 1
            elif pod.status.phase == "Succeeded":
                succeeded += 1
            elif pod.status.phase == "Failed":
                failed += 1
        return PodCounts(total, running, pending, succeeded, failed)

    def create_resources(self, job: TrainingJob) -> None:
        """Materialize the job's pod groups.  A 409 AlreadyExists is
        ADOPTION, not an error: after a controller restart the sync loop
        re-submits every listed CR, and the job's resources are usually
        still there — the updater then simply confirms the running cohort
        (the reference's create also tolerates existing resources by
        logging and continuing, pkg/controller.go:134-148).

        Adoption is sound because every RUNTIME-mutable spec field
        (trainer min/max bounds) lives in the controller registry and the
        autoscaler actuates it via parallelism writes; pod-template fields
        (image, entrypoint, per-pod resources) are create-time for the
        life of the job here exactly as in the reference, whose controller
        also never rewrites a running job's pod specs (its only actuation
        is TrainerJob.Spec.Parallelism, autoscaler.go:339-376).  Changing
        a template field means delete + resubmit."""
        from edl_tpu_torch.controller.jobparser import (
            parse_serving_manifests, parse_to_manifests)

        apps = kubernetes.client.AppsV1Api()
        manifests = (parse_serving_manifests(job)
                     if getattr(job, "replica_role", "trainer") == "server"
                     else parse_to_manifests(job))
        for manifest in manifests:
            try:
                if manifest["kind"] == "Job":
                    self._batch.create_namespaced_job(job.namespace, manifest)
                elif manifest["kind"] == "ReplicaSet":
                    apps.create_namespaced_replica_set(job.namespace, manifest)
                elif manifest["kind"] == "Service":
                    self._core.create_namespaced_service(job.namespace,
                                                         manifest)
            except kubernetes.client.exceptions.ApiException as exc:
                if exc.status != 409:
                    raise

    def list_training_jobs(self) -> list[str]:
        """Names of jobs with a trainer group in this namespace (role of
        the TrainingJob list the reference's del_jobs.sh iterates)."""
        names = []
        for j in self._batch.list_namespaced_job(self.namespace).items:
            labels = j.metadata.labels or {}
            if TRAINER_LABEL in labels:
                names.append(labels[TRAINER_LABEL])
        return sorted(set(names))

    def list_trainer_groups(self) -> list[tuple[str, str]]:
        """(namespace, job-name) of every trainer group CLUSTER-WIDE —
        the sweep surface matching the cluster-wide CR watch, so an
        orphaned group in any namespace is visible."""
        out = set()
        for j in self._batch.list_job_for_all_namespaces().items:
            labels = j.metadata.labels or {}
            if TRAINER_LABEL in labels:
                out.add((j.metadata.namespace, labels[TRAINER_LABEL]))
        return sorted(out)

    def delete_resources(self, job: TrainingJob) -> None:
        apps = kubernetes.client.AppsV1Api()
        if getattr(job, "replica_role", "trainer") == "server":
            # ServingJob: server ReplicaSet + its Service, nothing else
            try:
                apps.delete_namespaced_replica_set(
                    f"{job.name}-server", job.namespace,
                    propagation_policy="Foreground")
            except kubernetes.client.exceptions.ApiException as exc:
                if exc.status != 404:
                    raise
            try:
                self._core.delete_namespaced_service(
                    f"{job.name}-serve", job.namespace)
            except kubernetes.client.exceptions.ApiException as exc:
                if exc.status != 404:
                    raise
            return
        for rs in (f"{job.name}-coordinator", f"{job.name}-pserver"):
            try:
                apps.delete_namespaced_replica_set(
                    rs, job.namespace, propagation_policy="Foreground"
                )
            except kubernetes.client.exceptions.ApiException as exc:
                if exc.status != 404:
                    raise
        try:
            self._batch.delete_namespaced_job(
                _trainer_name(job), job.namespace,
                propagation_policy="Foreground",
            )
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status != 404:
                raise
        try:
            self._core.delete_namespaced_service(
                f"{job.name}-coordinator", job.namespace)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status != 404:
                raise

    # -- TrainingJob custom resources (the deployed control-plane surface;
    #    role of the reference's generated clientset CRUD+Watch,
    #    pkg/client/clientset/versioned/typed/paddlepaddle/v1/
    #    trainingjob.go:33-44) --------------------------------------------

    def list_training_job_crs(self) -> list[dict]:
        """TrainingJob custom objects across ALL namespaces (the poll-list
        the sync loop diffs; role of the informer's NamespaceAll ListWatch
        source, reference pkg/controller.go:80-87)."""
        return self.list_training_job_crs_with_rv()[0]

    def list_training_job_crs_with_rv(self) -> tuple[list[dict], str]:
        """(items, list resourceVersion) — the rv anchors a streaming
        watch exactly where this LIST observed the collection."""
        from edl_tpu_torch.api.serde import CRD_GROUP, CRD_PLURAL, CRD_VERSION

        out = self._custom.list_cluster_custom_object(
            CRD_GROUP, CRD_VERSION, CRD_PLURAL)
        rv = str((out.get("metadata") or {}).get("resourceVersion") or "")
        return list(out.get("items") or []), rv

    def watch_training_job_crs(self, resource_version: str,
                               timeout_seconds: int = 30):
        """Streaming watch from ``resource_version``: yields kubernetes
        watch events ({"type": ADDED|MODIFIED|DELETED, "object": cr}) —
        the event-driven half of the reference informer's ListWatch
        (reference pkg/controller.go:87-107).  The stream ends at the
        server-side timeout (the caller loops); a stale rv raises the
        client's 410 Gone ApiException, which the sync loop answers with
        a fresh LIST."""
        from kubernetes import watch as k8s_watch

        from edl_tpu_torch.api.serde import CRD_GROUP, CRD_PLURAL, CRD_VERSION

        w = k8s_watch.Watch()
        try:
            yield from w.stream(
                self._custom.list_cluster_custom_object,
                CRD_GROUP, CRD_VERSION, CRD_PLURAL,
                resource_version=resource_version,
                timeout_seconds=timeout_seconds)
        finally:
            w.stop()

    def get_training_job_cr(self, name: str, namespace: str | None = None
                            ) -> dict | None:
        from edl_tpu_torch.api.serde import CRD_GROUP, CRD_PLURAL, CRD_VERSION

        try:
            return self._custom.get_namespaced_custom_object(
                CRD_GROUP, CRD_VERSION, namespace or self.namespace,
                CRD_PLURAL, name)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 404:
                return None
            raise

    def create_training_job_cr(self, manifest: dict) -> None:
        """Submit = create the CR and let the controller materialize it
        (the reference's submission flow, doc/usage.md + controller
        onAdd, pkg/controller.go:110-148).  The CR lands in the
        manifest's own metadata.namespace (an apiserver rejects a
        namespace mismatch), falling back to this client's default."""
        from edl_tpu_torch.api.serde import CRD_GROUP, CRD_PLURAL, CRD_VERSION

        ns = ((manifest.get("metadata") or {}).get("namespace")
              or self.namespace)
        self._custom.create_namespaced_custom_object(
            CRD_GROUP, CRD_VERSION, ns, CRD_PLURAL, manifest)

    def delete_training_job_cr(self, name: str, namespace: str | None = None
                               ) -> bool:
        from edl_tpu_torch.api.serde import CRD_GROUP, CRD_PLURAL, CRD_VERSION

        try:
            self._custom.delete_namespaced_custom_object(
                CRD_GROUP, CRD_VERSION, namespace or self.namespace,
                CRD_PLURAL, name)
            return True
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 404:
                return False
            raise

    def patch_training_job_status(self, name: str, status: dict,
                                  namespace: str | None = None) -> bool:
        """Write phase + replica statuses into the CR's status subresource
        so ``kubectl get tj`` shows them (role of updateCRDStatus,
        reference pkg/updater/trainingJobUpdater.go:295-307).  False if the
        CR vanished (deleted between list and patch) — not an error."""
        from edl_tpu_torch.api.serde import CRD_GROUP, CRD_PLURAL, CRD_VERSION

        try:
            self._custom.patch_namespaced_custom_object_status(
                CRD_GROUP, CRD_VERSION, namespace or self.namespace,
                CRD_PLURAL, name, {"status": status})
            return True
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 404:
                return False
            raise

    # -- ServingJob custom resources (kind dispatch mirror of the
    #    TrainingJob CR surface; plural servingjobs, k8s/crd.yaml) ---------

    def list_serving_job_crs(self) -> list[dict]:
        from edl_tpu_torch.api.serde import (CRD_GROUP, CRD_VERSION,
                                             SERVING_CRD_PLURAL)

        out = self._custom.list_cluster_custom_object(
            CRD_GROUP, CRD_VERSION, SERVING_CRD_PLURAL)
        return list(out.get("items") or [])

    def get_serving_job_cr(self, name: str, namespace: str | None = None
                           ) -> dict | None:
        from edl_tpu_torch.api.serde import (CRD_GROUP, CRD_VERSION,
                                             SERVING_CRD_PLURAL)

        try:
            return self._custom.get_namespaced_custom_object(
                CRD_GROUP, CRD_VERSION, namespace or self.namespace,
                SERVING_CRD_PLURAL, name)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 404:
                return None
            raise

    def create_serving_job_cr(self, manifest: dict) -> None:
        from edl_tpu_torch.api.serde import (CRD_GROUP, CRD_VERSION,
                                             SERVING_CRD_PLURAL)

        ns = ((manifest.get("metadata") or {}).get("namespace")
              or self.namespace)
        self._custom.create_namespaced_custom_object(
            CRD_GROUP, CRD_VERSION, ns, SERVING_CRD_PLURAL, manifest)

    def delete_serving_job_cr(self, name: str, namespace: str | None = None
                              ) -> bool:
        from edl_tpu_torch.api.serde import (CRD_GROUP, CRD_VERSION,
                                             SERVING_CRD_PLURAL)

        try:
            self._custom.delete_namespaced_custom_object(
                CRD_GROUP, CRD_VERSION, namespace or self.namespace,
                SERVING_CRD_PLURAL, name)
            return True
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 404:
                return False
            raise

    def patch_serving_job_status(self, name: str, status: dict,
                                 namespace: str | None = None) -> bool:
        from edl_tpu_torch.api.serde import (CRD_GROUP, CRD_VERSION,
                                             SERVING_CRD_PLURAL)

        try:
            self._custom.patch_namespaced_custom_object_status(
                CRD_GROUP, CRD_VERSION, namespace or self.namespace,
                SERVING_CRD_PLURAL, name, {"status": status})
            return True
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status == 404:
                return False
            raise

    def list_pods(self, job_uid: str | None = None, role: str | None = None
                  ) -> list["PodView"]:
        """Pods as lightweight records with the FakePod attribute surface
        (what the Collector and PodDiscovery consume)."""
        out = []
        role_labels = {"trainer": TRAINER_LABEL,
                       "master": COORDINATOR_LABEL,
                       "pserver": PSERVER_LABEL,
                       "server": SERVING_LABEL}
        if job_uid is not None or role is not None:
            # Job-scoped callers (PodDiscovery polls every 5 s): a
            # namespaced LIST with a label selector, not a full-cluster
            # scan.  job_uid is "namespace/name".
            ns, _, jname = (job_uid or "").partition("/")
            ns = ns if jname else self.namespace
            if role in role_labels:
                sel = (f"{role_labels[role]}={jname}" if jname
                       else role_labels[role])
            else:
                sel = None  # any role of the job; filtered client-side
            items = self._core.list_namespaced_pod(
                ns, label_selector=sel).items
        else:
            # Full scan (the Collector): all namespaces, so the
            # utilization numerator covers the same pod set as the
            # inquiry_resource denominator (system pods included — the
            # reference counts every Running pod's requests,
            # example/collector.py:156-179).
            items = self._core.list_pod_for_all_namespaces().items
        for pod in items:
            labels = pod.metadata.labels or {}
            pod_role, pod_job = "system", ""
            for r, label in role_labels.items():
                if label in labels:
                    pod_role = r
                    pod_job = f"{pod.metadata.namespace}/{labels[label]}"
                    break
            if job_uid is not None and pod_job != job_uid:
                continue
            if role is not None and pod_role != role:
                continue
            creq, _, mreq, _, gl = _pod_resources(pod)
            out.append(PodView(
                name=pod.metadata.name,
                job_uid=pod_job,
                role=pod_role,
                phase=PodPhase(pod.status.phase or "Pending"),
                node=pod.spec.node_name,
                deletion_timestamp=pod.metadata.deletion_timestamp is not None,
                cpu_request_milli=creq,
                memory_request_mega=mreq,
                gpu_limit=gl,
                ip=getattr(pod.status, "pod_ip", None) or "",
            ))
        return out


def _trainer_name(job: TrainingJob) -> str:
    return f"{job.name}-trainer"


def _milli(q: str) -> int:
    from edl_tpu_torch.api.quantity import Quantity

    return Quantity(q).milli_value()


def _mega(q: str) -> int:
    from edl_tpu_torch.api.quantity import Quantity

    return Quantity(q).scaled_value(6)


def _pod_resources(pod):
    creq = cl = mreq = ml = gl = 0
    containers = list(pod.spec.containers or []) + list(
        pod.spec.init_containers or []
    )
    for c in containers:
        res = c.resources
        if res is None:
            continue
        req = res.requests or {}
        lim = res.limits or {}
        creq += _milli(req.get("cpu", "0"))
        cl += _milli(lim.get("cpu", "0"))
        mreq += _mega(req.get("memory", "0"))
        ml += _mega(lim.get("memory", "0"))
        gl += int(lim.get(RESOURCE_GPU, "0"))
    return creq, cl, mreq, ml, gl
