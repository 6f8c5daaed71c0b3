"""Resource model: the TrainingJob and ServingJob spec/status types, their
validation and quantity arithmetic — the port's copy of what edl_tpu.api
holds for them (serde waits for ROADMAP.md queue 1 item 11)."""

from edl_tpu_torch.api.quantity import Quantity
from edl_tpu_torch.api.validation import (
    ValidationError,
    set_defaults_and_validate,
    set_defaults_and_validate_serving,
    validate_any,
)
from edl_tpu_torch.api.types import (
    RESOURCE_GPU,
    JobPhase,
    MasterSpec,
    PserverSpec,
    ResourceRequirements,
    ServingJob,
    ServingSpec,
    TrainerSpec,
    TrainingJob,
    TrainingJobSpec,
    TrainingJobStatus,
)

__all__ = [
    "Quantity",
    "RESOURCE_GPU",
    "JobPhase",
    "MasterSpec",
    "PserverSpec",
    "ResourceRequirements",
    "ServingJob",
    "ServingSpec",
    "TrainerSpec",
    "TrainingJob",
    "TrainingJobSpec",
    "TrainingJobStatus",
    "ValidationError",
    "set_defaults_and_validate",
    "set_defaults_and_validate_serving",
    "validate_any",
]
