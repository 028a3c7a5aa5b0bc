"""Metric layers: the port's copy of ``accuracy`` from
``paddle_tpu.layers.metric_op`` (reference layers/metric_op.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn


def accuracy(input, label, k: int = 1, correct=None, total=None):
    """layers/metric_op.py accuracy: top-k accuracy of `input` (probs/logits)."""
    helper = LayerHelper("accuracy")
    values, indices = nn.topk(input, k=k)
    acc = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference("int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Indices": [indices.name], "Label": [label.name]},
        outputs={"Accuracy": [acc.name], "Correct": [correct.name], "Total": [total.name]},
        attrs={})
    return acc
