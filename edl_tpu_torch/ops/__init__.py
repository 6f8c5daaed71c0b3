"""Hand-written Hopper kernels for the hot ops, with their plain PyTorch
versions."""

from edl_tpu_torch.ops.flash_attention import attention

__all__ = ["attention"]
