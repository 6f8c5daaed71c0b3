"""Resource model: the TrainingJob spec/status types, their validation and
quantity arithmetic — the port's copy of what edl_tpu.api holds for a
training job (serde and the serving job wait for ROADMAP.md queue 1 item
11)."""

from edl_tpu_torch.api.quantity import Quantity
from edl_tpu_torch.api.validation import (ValidationError,
                                          set_defaults_and_validate,
                                          validate_any)
from edl_tpu_torch.api.types import (
    RESOURCE_GPU,
    JobPhase,
    MasterSpec,
    PserverSpec,
    ResourceRequirements,
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
    "TrainerSpec",
    "TrainingJob",
    "TrainingJobSpec",
    "TrainingJobStatus",
    "ValidationError",
    "set_defaults_and_validate",
    "validate_any",
]
