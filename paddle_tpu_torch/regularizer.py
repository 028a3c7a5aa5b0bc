"""Weight-decay regularizers appended to gradients.

The port's copy of ``paddle_tpu.regularizer`` (reference
``python/paddle/fluid/regularizer.py``) — L1/L2 terms are emitted as ops
transforming each param's gradient before the optimizer op.
"""
from __future__ import annotations

from .layer_helper import LayerHelper


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype)
        out = helper.create_variable_for_type_inference(param.dtype)
        block.append_op(type="scale", inputs={"X": [param.name]},
                        outputs={"Out": [decay.name]}, attrs={"scale": self._coeff})
        block.append_op(type="sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [out.name]}, attrs={})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        decay = helper.create_variable_for_type_inference(param.dtype)
        out = helper.create_variable_for_type_inference(param.dtype)
        block.append_op(type="sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]}, attrs={})
        block.append_op(type="scale", inputs={"X": [sign.name]},
                        outputs={"Out": [decay.name]}, attrs={"scale": self._coeff})
        block.append_op(type="sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [out.name]}, attrs={})
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """optimizer.apply_gradients hook (reference regularizer.py
    append_regularization_ops): per-param regularizer wins over global."""
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            out.append((param, grad))
            continue
        block = param.block.program.global_block()
        new_grad = reg(param, grad, block)
        out.append((param, new_grad))
    return out
