"""Spec defaulting + validation — the port's copy of edl_tpu.api.validation.

Behavioral port of the reference's ``DefaultJobParser.Validate`` /
``setDefaultAndValidate`` (reference pkg/jobparser.go:47-71,
pkg/updater/jobparser.go:40-64): fill defaults for port / ports_num /
ports_num_for_sparse / image / passes, and reject elastic jobs that are not
fault-tolerant; and the serving job's gate,
:func:`set_defaults_and_validate_serving`.  The port's jobs claim a count
of cards (``nvidia.com/gpu``) and carry no slice topology, so the JAX
package's topology checks have no counterpart here.
"""

from __future__ import annotations

from edl_tpu_torch.api import types as T


class ValidationError(ValueError):
    pass


def set_defaults_and_validate(job: T.TrainingJob) -> T.TrainingJob:
    """Mutates ``job`` in place (defaults), raises ValidationError on bad spec."""
    spec = job.spec

    if not job.name:
        raise ValidationError("job name must not be empty")

    # Defaults — reference pkg/jobparser.go:49-64.
    if spec.port == 0:
        spec.port = T.DEFAULT_PORT
    if spec.ports_num == 0:
        spec.ports_num = 1
    if spec.ports_num_for_sparse == 0:
        spec.ports_num_for_sparse = 1
    if not spec.image:
        spec.image = T.DEFAULT_IMAGE
    if spec.passes == 0:
        spec.passes = T.DEFAULT_PASSES

    t = spec.trainer
    if t.min_instance < 1:
        raise ValidationError("trainer.min_instance must be >= 1")
    if t.max_instance < t.min_instance:
        raise ValidationError(
            f"trainer.max_instance ({t.max_instance}) must be >= "
            f"min_instance ({t.min_instance})"
        )
    if spec.pserver.max_instance < spec.pserver.min_instance:
        raise ValidationError("pserver.max_instance must be >= min_instance")

    # Elastic requires fault tolerance — reference pkg/jobparser.go:66-68.
    if job.elastic() and not spec.fault_tolerant:
        raise ValidationError(
            "elastic jobs (min_instance < max_instance) require fault_tolerant"
        )

    if t.priority < 0:
        raise ValidationError(
            f"trainer.priority must be >= 0 (got {t.priority}); "
            "0=low 1=normal 2=high, higher ints allowed")

    return job


def set_defaults_and_validate_serving(job: T.ServingJob) -> T.ServingJob:
    """ServingJob defaulting + validation.  Mutates ``job`` in place,
    raises ValidationError on a bad spec — the same gate shape training
    jobs pass through."""
    if not job.name:
        raise ValidationError("job name must not be empty")
    if not job.image:
        job.image = T.DEFAULT_IMAGE
    if job.port == 0:
        job.port = T.DEFAULT_SERVING_PORT

    s = job.spec
    if s.min_replicas < 1:
        raise ValidationError("server.min_replicas must be >= 1")
    if s.max_replicas < s.min_replicas:
        raise ValidationError(
            f"server.max_replicas ({s.max_replicas}) must be >= "
            f"min_replicas ({s.min_replicas})")
    if s.slo_p99_ms < 0:
        raise ValidationError("server.slo_p99_ms must be >= 0 (0 disables)")
    if s.target_qps_per_replica < 0:
        raise ValidationError("server.target_qps_per_replica must be >= 0")
    if job.elastic() and s.slo_p99_ms == 0 and s.target_qps_per_replica == 0:
        raise ValidationError(
            "an elastic serving job (min_replicas < max_replicas) needs a "
            "scaling signal: set slo_p99_ms and/or target_qps_per_replica")
    if s.max_batch_size < 1:
        raise ValidationError("server.max_batch_size must be >= 1")
    if s.max_queue_ms < 0:
        raise ValidationError("server.max_queue_ms must be >= 0")
    if s.drain_timeout_s <= 0:
        s.drain_timeout_s = 30.0
    if s.reload_poll_s < 0:
        raise ValidationError("server.reload_poll_s must be >= 0 "
                              "(0 disables the lineage watch)")
    if s.priority < 0:
        raise ValidationError(
            f"server.priority must be >= 0 (got {s.priority}); "
            "0=low 1=normal 2=high, higher ints allowed")
    # the reference's two topology checks (a declared slice of >= 1 chip
    # agreeing with the chip limit) have nothing to check here: a replica
    # claims a count of cards and carries no topology
    return job


def validate_any(job) -> None:
    """Kind-dispatching gate: the controller's submit/modify path takes
    either job kind through its matching validator."""
    if isinstance(job, T.ServingJob):
        set_defaults_and_validate_serving(job)
    else:
        set_defaults_and_validate(job)
