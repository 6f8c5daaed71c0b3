"""Model zoo of the port: the Llama-family decoder, ResNet-50 and
BERT-base."""

from edl_tpu_torch.models import bert, resnet, transformer

__all__ = ["bert", "resnet", "transformer"]
