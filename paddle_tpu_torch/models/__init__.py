"""Model builders ported so far: BERT/ERNIE-base, ResNet-50, Transformer
NMT, DeepFM and LeNet."""
from . import bert, deepfm, lenet, resnet, transformer_nmt  # noqa: F401
