"""Model zoo of the port: the Llama-family decoder, ResNet-50, BERT-base,
the MLP classifier and the shipped example's word2vec."""

from edl_tpu_torch.models import bert, mlp, resnet, transformer, word2vec

__all__ = ["bert", "mlp", "resnet", "transformer", "word2vec"]
