"""TrainingJob resource model — the port's copy of edl_tpu.api.types, with
the accelerator resource an NVIDIA GPU.

* Gen-1 TPR shape — reference pkg/resource/training_job.go:109-159
  (spec: image/port/ports_num/fault_tolerant/passes + Trainer/Pserver/Master)
* Gen-2 CRD status machine — reference pkg/apis/paddlepaddle/v1/types.go:92-162
  (phase None/Creating/Running/Succeeded/Failed + per-resource states)
* helpers Elastic()/NeedGPU() — reference pkg/resource/training_job.go:189-207

The accelerator resource is ``nvidia.com/gpu`` (:data:`RESOURCE_GPU`), a
count of cards a trainer replica claims (``gpu_limit``,
``gpus_per_trainer``).  The JAX package's TPU-only pieces — ``TpuTopology``
and a trainer's ``topology`` — have no counterpart here: a job claims a
count of cards and nothing reads a slice shape, so the manifest serde
rejects a ``topology`` by name (:mod:`edl_tpu_torch.api.serde`).

:class:`ServingJob` and :class:`ServingSpec` are the serving job's copy:
a replica claims ``nvidia.com/gpu`` cards (``gpus_per_replica``) where the
reference claims TPU chips, and ``ServingSpec`` has no ``topology`` (the
reference's multi-chip replica mesh), for the reason above.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from edl_tpu_torch.api.quantity import Quantity

# Resource-list keys (reference pkg/resource/training_job.go:196-206).
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_GPU = "nvidia.com/gpu"

DEFAULT_PORT = 7164  # reference pkg/jobparser.go:50-52
DEFAULT_IMAGE = "edl-tpu/job:latest"  # role of paddlepaddle/paddlecloud-job, jobparser.go:61-63
DEFAULT_PASSES = 1  # reference pkg/jobparser.go:58-60

# Pod-label contract between the job compiler and the cluster backends
# (role of ``paddle-job``/``paddle-job-master``/``paddle-job-pserver``,
# reference pkg/cluster.go:119 + example/collector.py:95-118).
TRAINER_LABEL = "edl-tpu-job"
COORDINATOR_LABEL = "edl-tpu-job-coordinator"
PSERVER_LABEL = "edl-tpu-job-pserver"
#: marks a ServingJob's model-server pods
SERVING_LABEL = "edl-tpu-serving"
#: marks a multi-domain job's trainer pods, so the cluster inventory knows
#: not to pin the job to one NVLink domain.
MULTI_DOMAIN_LABEL = "edl-tpu-multi-domain"

#: default model-server port (the inference RPC surface; distinct from
#: the coordinator's 7164 so a job may run both side by side)
DEFAULT_SERVING_PORT = 8500


class SchedPriority(enum.IntEnum):
    """Scheduling priority of a job's card claim (doc/scheduling.md).

    Consumed by the goodput planner: allocation considers higher
    priorities first, and a pending HIGH gang may preempt — shrink, via
    a planned resize, never a kill — lower-priority elastic jobs down
    to their ``min_instance`` to land.  The value is an int so deployments
    may define finer tiers; these names are the documented rungs."""

    LOW = 0
    NORMAL = 1
    HIGH = 2

    @classmethod
    def parse(cls, v: "int | str") -> int:
        """Accept an int or a (case-insensitive) tier name."""
        if isinstance(v, str) and not v.lstrip("-").isdigit():
            try:
                return int(cls[v.strip().upper()])
            except KeyError:
                raise ValueError(f"unknown priority {v!r} "
                                 f"(want an int or one of "
                                 f"{[m.name.lower() for m in cls]})")
        return int(v)


def _as_qmap(m: "dict[str, Quantity | str | int] | None") -> dict[str, Quantity]:
    return {k: Quantity(v) for k, v in (m or {}).items()}


@dataclass
class ResourceRequirements:
    """requests/limits lists, mirroring v1.ResourceRequirements."""

    requests: dict[str, Quantity] = field(default_factory=dict)
    limits: dict[str, Quantity] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.requests = _as_qmap(self.requests)
        self.limits = _as_qmap(self.limits)

    def _get(self, which: dict[str, Quantity], key: str) -> Quantity:
        return which.get(key, Quantity(0))

    def cpu_request(self) -> Quantity:
        return self._get(self.requests, RESOURCE_CPU)

    def memory_request(self) -> Quantity:
        return self._get(self.requests, RESOURCE_MEMORY)

    def cpu_limit(self) -> Quantity:
        return self._get(self.limits, RESOURCE_CPU)

    def memory_limit(self) -> Quantity:
        return self._get(self.limits, RESOURCE_MEMORY)

    def gpu_limit(self) -> Quantity:
        """Accelerator cards; role of Limits.NvidiaGPU() (autoscaler.go:40-42)."""
        return self._get(self.limits, RESOURCE_GPU)


@dataclass
class TrainerSpec:
    """reference pkg/resource/training_job.go:133-145."""

    entrypoint: str = ""
    workspace: str = ""
    min_instance: int = 1
    max_instance: int = 1
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    #: Opt-in for meshes that span NVLink domains (data-parallel gradient
    #: sync rides the network between domains, NVLink within).  Off by
    #: default: a GPU job is pinned to ONE NVLink domain and its scale-up
    #: caps at that domain's capacity, because an unwitting network hop
    #: inside a TP/FSDP mesh is a silent order-of-magnitude bandwidth
    #: cliff.
    allow_multi_domain: bool = False
    #: Scheduling priority (:class:`SchedPriority` rung or any int): the
    #: goodput planner allocates cards to higher priorities first, and a
    #: pending higher-priority gang may shrink lower-priority elastic
    #: jobs (down to their min_instance) to be admitted.
    priority: int = SchedPriority.NORMAL
    #: User environment for trainer pods, merged AFTER the EDL_* contract
    #: so user values win — the supported way to tune runtime knobs like
    #: EDL_MH_CKPT_EVERY per job (k8s env-list semantics: last wins).
    env: dict = field(default_factory=dict)
    #: Pod-template passthroughs (spec parity with real k8s training
    #: workloads): lists of k8s-shaped dicts carried VERBATIM into the
    #: compiled trainer pod template — ``volumes`` on the pod spec,
    #: ``volume_mounts`` on the trainer container, ``image_pull_secrets``
    #: on the pod spec.  No schema is imposed beyond "a list of objects":
    #: the apiserver owns validating volume sources, and mirroring its
    #: whole vocabulary here would only drift.
    volumes: list = field(default_factory=list)
    volume_mounts: list = field(default_factory=list)
    image_pull_secrets: list = field(default_factory=list)


@dataclass
class PserverSpec:
    """reference pkg/resource/training_job.go:147-152.

    Kept for spec-surface parity; the runtime shards parameters across the
    trainer mesh itself, so most jobs leave min/max at 0.
    """

    min_instance: int = 0
    max_instance: int = 0
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


@dataclass
class MasterSpec:
    """reference pkg/resource/training_job.go:154-159 — maps to the
    edl_tpu_torch.coord service (task queue + membership) instead of etcd+master."""

    etcd_endpoint: str = ""  # retained name for migration; our coord endpoint
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


@dataclass
class ServingSpec:
    """One elastic inference fleet: replicated model servers behind a
    Service, continuously batched, SLO-autoscaled.

    The serving analogue of :class:`TrainerSpec` — ``min_replicas`` /
    ``max_replicas`` is the elastic dial the SLO policy moves; a replica
    claims ``resources``' ``nvidia.com/gpu`` cards."""

    #: checkpoint-lineage directory weights load (and rolling reloads
    #: watch) — an :class:`~edl_tpu_torch.runtime.checkpoint.
    #: ElasticCheckpointer` store; the serving twin of ``trainer.workspace``
    model_dir: str = ""
    #: model architecture the server pod builds before restoring from
    #: the lineage (``kind:dims``, e.g. ``mlp:784,256,10``) — emitted as
    #: EDL_SERVING_MODEL; a lineage whose tree doesn't match this shape
    #: fails the pod at startup instead of serving garbage
    model: str = "mlp:16,32,4"
    min_replicas: int = 1
    max_replicas: int = 1
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    #: p99 latency objective in milliseconds — what the autoscaler's
    #: serving policy defends (scale-up fires when the windowed p99
    #: crosses it); 0 disables latency-driven scaling
    slo_p99_ms: float = 100.0
    #: per-replica throughput target; above it a scale-up fires even
    #: with latency headroom, and sustained load far below it (with p99
    #: comfortably inside the SLO) lets replicas drain away.  0 = scale
    #: on latency alone.
    target_qps_per_replica: float = 0.0
    #: continuous-batching admission: each serve iteration packs up to
    #: this many queued requests into the serve step (the fixed batch
    #: shape, so no new shapes as load moves)
    max_batch_size: int = 8
    #: how long an admitted request may wait for co-batchees before the
    #: iteration launches anyway (milliseconds); 0 = launch immediately
    #: with whatever is queued
    max_queue_ms: float = 2.0
    #: graceful scale-down budget: a draining replica finishes its queue
    #: within this bound before it is removed (never dropping requests)
    drain_timeout_s: float = 30.0
    #: cadence at which replicas watch ``model_dir`` for a newer
    #: verified checkpoint generation to roll onto; 0 disables the watch
    #: (reloads become explicit API calls)
    reload_poll_s: float = 5.0
    #: user environment for server pods (same merge contract as
    #: ``TrainerSpec.env``: user values win)
    env: dict = field(default_factory=dict)
    #: scheduling priority of the fleet's card claim (same scale as
    #: ``TrainerSpec.priority``)
    priority: int = SchedPriority.NORMAL
    # -- autoregressive decode serving --
    #: time-to-first-token objective (ms) for decode fleets — a second
    #: SLO input to the autoscaling policy alongside ``slo_p99_ms``; 0
    #: disables TTFT-driven scaling
    slo_ttft_ms: float = 0.0
    #: per-output-token time objective (ms) per decode iteration
    slo_tpot_ms: float = 0.0
    #: decode slots per replica (the decode twin of ``max_batch_size``)
    decode_slots: int = 8
    #: paged KV pool shape per replica: ``kv_blocks`` blocks of
    #: ``kv_block_size`` token positions; a session may hold at most
    #: ``kv_max_blocks_per_session``
    kv_blocks: int = 256
    kv_block_size: int = 16
    kv_max_blocks_per_session: int = 32
    #: prompt prefill chunk length (tokens per prefill iteration)
    prefill_chunk: int = 64
    #: decode iterations the batcher runs between prefill chunks while
    #: sessions are decoding
    decode_per_prefill: int = 2
    #: prefill-tier replicas for disaggregated serving (0 = aggregated)
    prefill_replicas: int = 0


@dataclass
class TrainingJobSpec:
    """reference pkg/resource/training_job.go:109-131."""

    image: str = ""
    port: int = 0
    ports_num: int = 0
    ports_num_for_sparse: int = 0
    fault_tolerant: bool = False
    passes: int = 0
    host_network: bool = False
    node_selector: dict[str, str] = field(default_factory=dict)
    trainer: TrainerSpec = field(default_factory=TrainerSpec)
    pserver: PserverSpec = field(default_factory=PserverSpec)
    master: MasterSpec = field(default_factory=MasterSpec)


class JobPhase(str, enum.Enum):
    """reference pkg/apis/paddlepaddle/v1/types.go:95-111."""

    NONE = "None"
    CREATING = "Creating"
    RUNNING = "Running"
    SCALING = "Scaling"  # addition: mesh resize in flight
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"

    def terminal(self) -> bool:
        return self in (JobPhase.SUCCEEDED, JobPhase.FAILED)


class ResourceState(str, enum.Enum):
    """reference pkg/apis/paddlepaddle/v1/types.go:139-152."""

    NONE = "None"
    STARTING = "Starting"
    RUNNING = "Running"
    FAILED = "Failed"
    SUCCEEDED = "Succeeded"


@dataclass
class TrainingResourceStatus:
    """reference pkg/apis/paddlepaddle/v1/types.go:154-162."""

    resource_type: str = ""  # MASTER | PSERVER | TRAINER
    state: ResourceState = ResourceState.NONE
    resource_states: dict[str, ResourceState] = field(default_factory=dict)


@dataclass
class TrainingJobStatus:
    """reference pkg/apis/paddlepaddle/v1/types.go:113-137."""

    phase: JobPhase = JobPhase.NONE
    reason: str = ""
    replica_statuses: list[TrainingResourceStatus] = field(default_factory=list)


@dataclass
class TrainingJob:
    """The user-facing job object (metadata + spec + status)."""

    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    spec: TrainingJobSpec = field(default_factory=TrainingJobSpec)
    status: TrainingJobStatus = field(default_factory=TrainingJobStatus)

    #: replica-group protocol: what kind of pod
    #: this job's elastic dial creates, and how the phase machine treats
    #: a failed one.  The cluster backends and the updater read these
    #: instead of hard-coding "trainer".
    replica_role = "trainer"

    # -- helpers, reference pkg/resource/training_job.go:185-207 -----------

    def elastic(self) -> bool:
        """min < max ⇒ trainer count is a dial (training_job.go:189-191)."""
        return self.spec.trainer.min_instance < self.spec.trainer.max_instance

    def gpus_per_trainer(self) -> int:
        """Cards one trainer replica occupies (GPU(), :194-200)."""
        return self.spec.trainer.resources.gpu_limit().value()

    def need_gpu(self) -> bool:
        """NeedGPU() (training_job.go:203-207)."""
        return self.gpus_per_trainer() > 0

    # -- replica-group protocol --------------------------------------------

    def group_range(self) -> tuple[int, int]:
        """(min, max) of the elastic replica dial."""
        return (self.spec.trainer.min_instance, self.spec.trainer.max_instance)

    def group_resources(self) -> ResourceRequirements:
        return self.spec.trainer.resources

    def gpus_per_replica(self) -> int:
        return self.gpus_per_trainer()

    def replaceable_on_failure(self) -> bool:
        """True when the group controller replaces a failed pod (the FT
        elastic path); False = zero failure budget (static barrier)."""
        return self.spec.fault_tolerant

    def sched_priority(self) -> int:
        """Scheduling priority of the card claim (doc/scheduling.md)."""
        return int(self.spec.trainer.priority)

    @property
    def full_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ServingJob:
    """The user-facing serving object: a replicated model server fleet
    with continuous batching, SLO-driven autoscaling, and rolling weight
    reloads from the elastic checkpoint lineage.

    Shares the :class:`TrainingJob` metadata/status shape (phases,
    per-role replica states) so the controller's phase machine reads the
    same lifecycle."""

    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    image: str = ""
    port: int = 0
    host_network: bool = False
    node_selector: dict[str, str] = field(default_factory=dict)
    spec: ServingSpec = field(default_factory=ServingSpec)
    status: TrainingJobStatus = field(default_factory=TrainingJobStatus)

    replica_role = "server"

    def elastic(self) -> bool:
        return self.spec.min_replicas < self.spec.max_replicas

    def gpus_per_replica(self) -> int:
        """Cards one server replica occupies."""
        return self.spec.resources.gpu_limit().value()

    def need_gpu(self) -> bool:
        return self.gpus_per_replica() > 0

    # -- replica-group protocol --------------------------------------------

    def group_range(self) -> tuple[int, int]:
        return (self.spec.min_replicas, self.spec.max_replicas)

    def group_resources(self) -> ResourceRequirements:
        return self.spec.resources

    def replaceable_on_failure(self) -> bool:
        """ReplicaSet semantics: a crashed server is always replaced —
        the fleet degrades, it never statically fails."""
        return True

    def sched_priority(self) -> int:
        """Scheduling priority of the card claim."""
        return int(self.spec.priority)

    @property
    def full_name(self) -> str:
        return f"{self.namespace}/{self.name}"
