"""Model zoo of the port: the Llama-family decoder, ResNet-50, BERT-base
and the MLP classifier."""

from edl_tpu_torch.models import bert, mlp, resnet, transformer

__all__ = ["bert", "mlp", "resnet", "transformer"]
