"""Model builders ported so far: BERT/ERNIE-base, ResNet-50, Transformer
NMT, DeepFM, LeNet and the semantic-role-labelling db_lstm."""
from . import (bert, deepfm, label_semantic_roles, lenet, resnet,  # noqa: F401
               transformer_nmt)
