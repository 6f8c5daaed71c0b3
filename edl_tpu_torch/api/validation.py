"""Spec defaulting + validation — the port's copy of edl_tpu.api.validation,
its training half.

Behavioral port of the reference's ``DefaultJobParser.Validate`` /
``setDefaultAndValidate`` (reference pkg/jobparser.go:47-71,
pkg/updater/jobparser.go:40-64): fill defaults for port / ports_num /
ports_num_for_sparse / image / passes, and reject elastic jobs that are not
fault-tolerant.  The port's job claims a count of cards
(``nvidia.com/gpu``) and carries no slice topology, so the JAX package's
topology checks have no counterpart here.  The serving job's gate waits
for its types (ROADMAP.md, queue 1 item 11): :func:`validate_any` refuses
any job that is not a :class:`~edl_tpu_torch.api.types.TrainingJob`,
naming that item.
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


def validate_any(job) -> None:
    """Kind-dispatching gate of the controller's submit/modify path: a
    ``TrainingJob`` through :func:`set_defaults_and_validate`; any other
    kind raises until the serving job's types are ported."""
    if not isinstance(job, T.TrainingJob):
        raise NotImplementedError(
            f"{type(job).__name__} is not ported yet: the serving job's "
            "types and gate wait for ROADMAP.md queue 1 item 11")
    set_defaults_and_validate(job)
