"""Resource model: the TrainingJob and ServingJob spec/status types, their
validation and quantity arithmetic, and (``edl_tpu_torch.api.serde``) their
manifests — the port's copy of edl_tpu.api."""

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
