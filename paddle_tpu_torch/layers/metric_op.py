"""Metric layers: the port's copy of ``paddle_tpu.layers.metric_op``
(reference layers/metric_op.py): ``accuracy`` and the streaming ``auc``."""
from __future__ import annotations

from ..initializer import ConstantInitializer
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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """layers/metric_op.py auc — streaming AUC with persistable stat buffers
    of num_thresholds + 1 buckets each."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        [num_thresholds + 1], "float32", name=helper.name + ".stat_pos",
        initializer=ConstantInitializer(0.0))
    stat_neg = helper.create_global_variable(
        [num_thresholds + 1], "float32", name=helper.name + ".stat_neg",
        initializer=ConstantInitializer(0.0))
    auc_out = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input.name], "Label": [label.name],
                "StatPos": [stat_pos.name], "StatNeg": [stat_neg.name]},
        outputs={"AUC": [auc_out.name], "StatPosOut": [stat_pos.name],
                 "StatNegOut": [stat_neg.name]},
        attrs={"num_thresholds": num_thresholds, "curve": curve})
    batch_auc = auc_out
    return auc_out, batch_auc, [stat_pos, stat_neg]
