"""Hand-written Hopper kernels for the hot ops, with their plain PyTorch
versions: ``attention`` (the flash kernels) and the ``group_norm`` module
(its ``group_norm`` function runs the GroupNorm kernels)."""

from edl_tpu_torch.ops import group_norm
from edl_tpu_torch.ops.flash_attention import attention

__all__ = ["attention", "group_norm"]
