"""Model zoo of the port; this slice carries the Llama-family decoder."""

from edl_tpu_torch.models import transformer

__all__ = ["transformer"]
