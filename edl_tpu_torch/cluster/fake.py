"""In-memory fake cluster — the port's copy of edl_tpu.cluster.fake, with
GPU cards and NVLink domains where the JAX package has TPU chips and ICI
domains.

The reference generated a fake clientset for tests but never used it
(reference pkg/client/clientset/versioned/fake/fake_trainingjob.go:29-36;
SURVEY §4).  This build makes the fake a first-class backend: an in-memory
implementation of :class:`Cluster` with nodes, capacity accounting, a tiny
pod scheduler, and hooks the elastic runtime uses to attach real local
worker processes.  All controller/scheduler tests run against it; it also
powers bench.py's multi-job elastic scenario.

Semantics mirrored from the reference:

* ``inquiry_resource`` accumulates allocatable totals over nodes and
  requests/limits over non-terminal pods, then subtracts per-node usage
  (reference cluster.go:176-242).
* trainer groups behave like a batch Job: a ``parallelism`` dial; the fake
  "kubelet" (:meth:`reconcile`) creates/deletes pods to match it, placing
  them on nodes with headroom else leaving them Pending
  (role of the k8s Job controller + kube-scheduler).
* pod counting is DeletionTimestamp-aware (reference cluster.go:117-136).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.cluster.base import Cluster, ConflictError, PodCounts, PodPhase
from edl_tpu_torch.cluster.resource import ClusterResource, NodeResources


@dataclass
class FakeNode:
    name: str
    cpu_milli: int = 0
    memory_mega: int = 0
    gpus: int = 0
    #: NVLink domain: tp and fsdp meshes stay within one domain.
    nvlink_domain: str = ""


@dataclass
class FakePod:
    name: str
    job_uid: str  # namespace/name of the owning job ("" for system pods)
    role: str  # trainer | master | pserver
    seq: int = 0  # creation order, for newest-first surplus deletion
    cpu_request_milli: int = 0
    cpu_limit_milli: int = 0
    memory_request_mega: int = 0
    memory_limit_mega: int = 0
    gpu_limit: int = 0
    phase: PodPhase = PodPhase.PENDING
    node: Optional[str] = None
    deletion_timestamp: bool = False


@dataclass
class _TrainerGroup:
    """Role of the trainer batchv1.Job (parallelism dial + pods)."""

    job_uid: str
    parallelism: int
    resource_version: int = 0


class FakeCluster(Cluster):
    """Thread-safe in-memory cluster."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: dict[str, FakeNode] = {}
        self._pods: dict[str, FakePod] = {}
        # both keyed by job uid (namespace/name)
        self._groups: dict[str, _TrainerGroup] = {}
        self._job_specs: dict[str, TrainingJob] = {}
        self._aux_pods_seq = itertools.count()
        #: Called with (pod, "start"|"stop") when reconcile changes the world;
        #: the elastic runtime uses this to launch/kill real worker processes.
        self.pod_event_hook: Optional[Callable[[FakePod, str], None]] = None
        #: True → reconcile also keeps one live coordinator pod per
        #: fault-tolerant job (the master RS analogue); enabled by the
        #: process-backed kubelet, off for pure scheduler bookkeeping.
        self.materialize_aux_pods: bool = False
        #: Injected failure for conflict-retry tests.
        self.fail_next_updates: int = 0

    # -- topology setup ----------------------------------------------------

    def add_node(
        self,
        name: str,
        cpu_milli: int = 0,
        memory_mega: int = 0,
        gpus: int = 0,
        nvlink_domain: str = "",
    ) -> FakeNode:
        with self._lock:
            node = FakeNode(name, cpu_milli, memory_mega, gpus, nvlink_domain or name)
            self._nodes[name] = node
            return node

    def add_system_pod(self, name: str, node: str, cpu_request_milli: int = 0,
                       memory_request_mega: int = 0, gpus: int = 0) -> None:
        """Background load (k8s system pods / the demo's nginx competitor,
        reference example/nginx.yaml); ``gpus`` cards of the node held
        too (another tenant's card claim)."""
        with self._lock:
            self._pods[name] = FakePod(
                name=name, job_uid="", role="system", seq=next(self._aux_pods_seq),
                cpu_request_milli=cpu_request_milli,
                cpu_limit_milli=cpu_request_milli,
                memory_request_mega=memory_request_mega,
                memory_limit_mega=memory_request_mega,
                gpu_limit=gpus, phase=PodPhase.RUNNING, node=node,
            )

    def remove_system_pod(self, name: str) -> None:
        with self._lock:
            self._pods.pop(name, None)

    # -- Cluster interface -------------------------------------------------

    def inquiry_resource(self) -> ClusterResource:
        with self._lock:
            r = ClusterResource(node_count=len(self._nodes))
            nodes = NodeResources()
            for n in self._nodes.values():
                r.cpu_total_milli += n.cpu_milli
                r.memory_total_mega += n.memory_mega
                r.gpu_total += n.gpus
                nodes.nodes_cpu_idle_milli[n.name] = n.cpu_milli
                nodes.nodes_memory_free_mega[n.name] = n.memory_mega
                nodes.nodes_gpu_free[n.name] = n.gpus
                nodes.nodes_nvlink_domain[n.name] = n.nvlink_domain
            for p in self._pods.values():
                if p.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                    continue  # terminal pods hold nothing (cluster.go:202-210)
                r.cpu_request_milli += p.cpu_request_milli
                r.cpu_limit_milli += p.cpu_limit_milli
                r.memory_request_mega += p.memory_request_mega
                r.memory_limit_mega += p.memory_limit_mega
                r.gpu_request += p.gpu_limit
                r.gpu_limit += p.gpu_limit
                if p.node in nodes.nodes_cpu_idle_milli:
                    nodes.nodes_cpu_idle_milli[p.node] -= p.cpu_request_milli
                    nodes.nodes_memory_free_mega[p.node] -= p.memory_request_mega
                    nodes.nodes_gpu_free[p.node] -= p.gpu_limit
                if (p.gpu_limit > 0 and p.job_uid
                        and p.node in self._nodes
                        and not self._allows_multi_domain(p.job_uid)):
                    # GPU pods pin their job to the domain they run in —
                    # the planner must keep growing the mesh there
                    # (multi-domain jobs are never pinned)
                    r.jobs_nvlink_domain.setdefault(
                        p.job_uid, self._nodes[p.node].nvlink_domain)
            r.nodes = nodes
            return r

    def get_trainer_parallelism(self, job: TrainingJob) -> int:
        with self._lock:
            return self._group(job).parallelism

    def update_trainer_parallelism(self, job: TrainingJob, parallelism: int) -> None:
        with self._lock:
            if self.fail_next_updates > 0:
                self.fail_next_updates -= 1
                raise ConflictError("injected conflict")
            g = self._group(job)
            g.parallelism = parallelism
            g.resource_version += 1
        self.reconcile()

    def job_pods(self, job: TrainingJob) -> PodCounts:
        role = getattr(job, "replica_role", "trainer")
        with self._lock:
            total = running = pending = succeeded = failed = 0
            for p in self._pods.values():
                if p.job_uid != job.full_name or p.role != role:
                    continue
                total += 1
                if p.deletion_timestamp:
                    continue  # Terminating counts in total only
                if p.phase == PodPhase.RUNNING:
                    running += 1
                elif p.phase == PodPhase.PENDING:
                    pending += 1
                elif p.phase == PodPhase.SUCCEEDED:
                    succeeded += 1
                elif p.phase == PodPhase.FAILED:
                    failed += 1
            return PodCounts(total, running, pending, succeeded, failed)

    def create_resources(self, job: TrainingJob) -> None:
        # works for both replica-group kinds: a TrainingJob's trainer
        # group and a ServingJob's server group are the same dial
        with self._lock:
            if job.full_name in self._groups:
                raise ConflictError(f"job {job.full_name} already exists")
            self._groups[job.full_name] = _TrainerGroup(
                job_uid=job.full_name, parallelism=job.group_range()[0]
            )
            self._job_specs[job.full_name] = job
        self.reconcile()

    def job_spec(self, job_uid: str) -> Optional[TrainingJob]:
        """The spec a pod's job was created from (the kubelet needs it to
        compile the pod's container command/env via the jobparser)."""
        with self._lock:
            return self._job_specs.get(job_uid)

    def report_pod_exit(self, name: str, returncode: int) -> None:
        """Kubelet status update: the pod's process exited.  rc 0 →
        Succeeded (work-queue Job: the job is done), else Failed (the Job
        controller replaces it on the next reconcile)."""
        with self._lock:
            p = self._pods.get(name)
            if p is None or p.phase not in (PodPhase.PENDING,
                                            PodPhase.RUNNING):
                return
            p.phase = (PodPhase.SUCCEEDED if returncode == 0
                       else PodPhase.FAILED)
        self.reconcile()

    def delete_resources(self, job: TrainingJob) -> None:
        stopped: list[FakePod] = []
        with self._lock:
            self._groups.pop(job.full_name, None)
            self._job_specs.pop(job.full_name, None)
            for name in [n for n, p in self._pods.items() if p.job_uid == job.full_name]:
                stopped.append(self._pods.pop(name))
        for p in stopped:
            self._emit(p, "stop")

    # -- the fake kubelet / job controller --------------------------------

    def reconcile(self) -> None:
        """Drive pods toward each group's parallelism: create missing pods,
        delete surplus ones, and try to place Pending pods on nodes."""
        started: list[FakePod] = []
        stopped: list[FakePod] = []
        with self._lock:
            for g in list(self._groups.values()):
                spec = self._job_specs.get(g.job_uid)
                if spec is None:
                    continue
                role = getattr(spec, "replica_role", "trainer")
                # coordinator ReplicaSet semantics for FT jobs (role of the
                # master RS, reference pkg/jobparser.go:167-227): keep ONE
                # live coordinator pod; a Failed one is replaced.  Off by
                # default: the pure-bookkeeping scheduler scenarios elide
                # aux pods (they hold no cards); the process-backed kubelet
                # turns it on to run the job's coordinator for real.
                if (getattr(spec.spec, "fault_tolerant", False)
                        and self.materialize_aux_pods):
                    coords = [
                        p for p in self._pods.values()
                        if p.job_uid == g.job_uid and p.role == "coordinator"
                        and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)
                        and not p.deletion_timestamp
                    ]
                    if not coords:
                        seq = next(self._aux_pods_seq)
                        mres = spec.spec.master.resources
                        self._pods[f"{spec.name}-coordinator-{seq}"] = FakePod(
                            name=f"{spec.name}-coordinator-{seq}",
                            job_uid=g.job_uid, role="coordinator", seq=seq,
                            cpu_request_milli=mres.cpu_request().milli_value(),
                            cpu_limit_milli=mres.cpu_limit().milli_value(),
                            memory_request_mega=(
                                mres.memory_request().scaled_value(6)),
                            memory_limit_mega=(
                                mres.memory_limit().scaled_value(6)),
                        )
                pods = [
                    p for p in self._pods.values()
                    if p.job_uid == g.job_uid and p.role == role
                ]
                live = [
                    p for p in pods
                    if p.phase in (PodPhase.PENDING, PodPhase.RUNNING)
                    and not p.deletion_timestamp
                ]
                # Work-queue Job semantics (completions unset): once any pod
                # has Succeeded the work is done — never spawn replacements.
                done = any(p.phase == PodPhase.SUCCEEDED for p in pods)
                if done:
                    continue
                # Non-fault-tolerant jobs have a zero-failure budget: the
                # updater's any-failure-is-fatal rule will tear the job
                # down, but until it does, spawning a replacement trainer
                # would hand it a frozen EDL_STATIC_PEERS list the
                # survivors disagree with (the dead pod is still in
                # theirs).  Enforce the budget at the Job-controller level
                # too: once any trainer Failed, never replace (ADVICE r5
                # item 3).  Serving replicas are ReplicaSet-semantics:
                # always replaceable.
                if (not spec.replaceable_on_failure()
                        and any(p.phase == PodPhase.FAILED for p in pods)):
                    continue
                # surplus: delete newest first (creation-order, not name-order)
                for p in sorted(live, key=lambda p: p.seq)[g.parallelism:]:
                    self._pods.pop(p.name, None)
                    stopped.append(p)
                # missing: create
                for i in range(g.parallelism - len(live)):
                    seq = next(self._aux_pods_seq)
                    name = f"{spec.name}-{role}-{seq}"
                    res = spec.group_resources()
                    pod = FakePod(
                        name=name, job_uid=g.job_uid, role=role, seq=seq,
                        cpu_request_milli=res.cpu_request().milli_value(),
                        cpu_limit_milli=res.cpu_limit().milli_value(),
                        memory_request_mega=res.memory_request().scaled_value(6),
                        memory_limit_mega=res.memory_limit().scaled_value(6),
                        gpu_limit=spec.gpus_per_replica(),
                    )
                    self._pods[name] = pod
            # schedule Pending pods
            for p in self._pods.values():
                if p.phase == PodPhase.PENDING and not p.deletion_timestamp:
                    node = self._find_node_for(p)
                    if node is not None:
                        p.node = node
                        p.phase = PodPhase.RUNNING
                        started.append(p)
        for p in stopped:
            self._emit(p, "stop")
        for p in started:
            self._emit(p, "start")

    def kill_pod(self, name: str, phase: PodPhase = PodPhase.FAILED) -> None:
        """Chaos hook: fail a pod (the reference's manual kill-a-pod demo,
        doc/boss_tutorial.md:271-301, made programmatic)."""
        with self._lock:
            p = self._pods.get(name)
            if p is None:
                return
            p.phase = phase
        self._emit(p, "stop")
        self.reconcile()  # Job controller re-creates the replacement pod

    def list_pods(self, job_uid: Optional[str] = None, role: Optional[str] = None
                  ) -> list[FakePod]:
        with self._lock:
            return [
                p for p in self._pods.values()
                if (job_uid is None or p.job_uid == job_uid)
                and (role is None or p.role == role)
            ]

    # -- internals ---------------------------------------------------------

    def _group(self, job: TrainingJob) -> _TrainerGroup:
        g = self._groups.get(job.full_name)
        if g is None:
            raise KeyError(f"no trainer group for job {job.full_name!r}")
        return g

    def _allows_multi_domain(self, job_uid: str) -> bool:
        spec = self._job_specs.get(job_uid)
        if spec is None:
            return False
        trainer = getattr(spec.spec, "trainer", None)
        if trainer is None:
            # a replica group without a trainer section (ServingJob):
            # replicas are independent meshes — no inter-replica
            # collective to protect, so the fleet may spread across
            # domains and is never pinned
            return True
        return trainer.allow_multi_domain

    def _find_node_for(self, pod: FakePod) -> Optional[str]:
        idle = {
            n.name: [n.cpu_milli, n.memory_mega, n.gpus]
            for n in self._nodes.values()
        }
        for p in self._pods.values():
            if p.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED) or p.node is None:
                continue
            if p.node in idle:
                idle[p.node][0] -= p.cpu_request_milli
                idle[p.node][1] -= p.memory_request_mega
                idle[p.node][2] -= p.gpu_limit
        # GPU jobs stay within one NVLink domain: once the first GPU pod
        # of a job lands, its siblings only place on nodes in the same
        # domain (a mesh spanning domains would all-reduce over the
        # network) — unless the job opted in (allow_multi_domain).
        required_domain = None
        if (pod.gpu_limit > 0 and pod.job_uid
                and not self._allows_multi_domain(pod.job_uid)):
            for p in self._pods.values():
                if (p.job_uid == pod.job_uid and p.gpu_limit > 0
                        and p.node is not None
                        and p.phase == PodPhase.RUNNING):
                    required_domain = self._nodes[p.node].nvlink_domain
                    break
        for name, (cpu, mem, gpu) in idle.items():
            if required_domain is not None and (
                    self._nodes[name].nvlink_domain != required_domain):
                continue
            if (pod.cpu_request_milli <= cpu and pod.memory_request_mega <= mem
                    and pod.gpu_limit <= gpu):
                return name
        return None

    def _emit(self, pod: FakePod, what: str) -> None:
        hook = self.pod_event_hook
        if hook is not None:
            hook(pod, what)
