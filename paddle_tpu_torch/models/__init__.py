"""Model builders ported so far: BERT/ERNIE-base, ResNet-50, Transformer
NMT and DeepFM."""
from . import bert, deepfm, resnet, transformer_nmt  # noqa: F401
