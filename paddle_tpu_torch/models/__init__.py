"""Model builders ported so far: BERT/ERNIE-base, ResNet-50 and Transformer
NMT."""
from . import bert, resnet, transformer_nmt  # noqa: F401
