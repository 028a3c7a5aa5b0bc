"""AMP decorator: the port's copy of
``paddle_tpu.contrib.mixed_precision.decorator`` (reference
``python/paddle/fluid/contrib/mixed_precision/decorator.py``:
OptimizerWithMixedPrecision:27, decorate:194 — fp16 cast-list graph rewrite,
dynamic loss scaling, master weights).

The low-precision dtype is **bfloat16** by default and needs NO loss scaling
(same exponent range as f32); float16 mode keeps the reference's dynamic
loss-scaling machinery for parity. Casts are not a graph-rewrite pass: the
executor reads the program's `_amp` config and casts white-list op inputs as
it runs them (core/executor.py _amp_cast), inside the autograd graph, which
is the same dataflow the reference's insert-cast-op pass produces.
Parameters stay float32 (master weights) — the optimizer update casts grads.
"""
from __future__ import annotations

import torch

from ...core.backward import append_backward
from ...core.registry import register_op
from ...initializer import ConstantInitializer
from ...layer_helper import LayerHelper
from .fp16_lists import AutoMixedPrecisionLists


@register_op("update_loss_scaling", differentiable=False)
def _update_loss_scaling(ctx, inputs, attrs):
    """Dynamic loss-scale state machine (reference fp16_utils
    update_loss_scaling): on inf/nan → scale *= decr_ratio, reset counter;
    after incr_every_n good steps → scale *= incr_ratio. Also zeroes bad
    grads so the (unconditional) optimizer update becomes a no-op step."""
    grads = inputs["Grads"]
    (scale,) = inputs["LossScaling"]
    (good,) = inputs["GoodSteps"]
    (bad,) = inputs["BadSteps"]
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)
    finite = torch.ones((), dtype=torch.bool, device=scale.device)
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    good_new = torch.where(finite, good + 1, torch.zeros_like(good))
    bad_new = torch.where(finite, torch.zeros_like(bad), bad + 1)
    scale_up = torch.where(good_new >= incr_every, scale * incr_ratio, scale)
    good_out = torch.where(good_new >= incr_every, torch.zeros_like(good_new),
                           good_new)
    decr_now = bad_new >= decr_every
    scale_out = torch.where(finite, scale_up,
                            torch.where(decr_now, scale * decr_ratio, scale))
    bad_out = torch.where(decr_now, torch.zeros_like(bad_new), bad_new)
    out_grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
    return {"Out": out_grads, "LossScalingOut": [scale_out],
            "GoodStepsOut": [good_out], "BadStepsOut": [bad_out],
            "FoundInf": [torch.logical_not(finite)]}


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists: AutoMixedPrecisionLists,
                 init_loss_scaling: float, use_dynamic_loss_scaling: bool,
                 incr_every_n_steps: int, incr_ratio: float, decr_ratio: float,
                 dtype: str = "bfloat16", decr_every_n_nan_or_inf: int = 2):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dtype = dtype
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        program._amp = {
            "dtype": self._dtype,
            "white_list": self._amp_lists.white_list,
            "black_list": self._amp_lists.black_list,
        }
        needs_scaling = self._dtype == "float16"
        helper = LayerHelper("amp")
        if needs_scaling:
            self._loss_scaling = helper.create_global_variable(
                [1], "float32", name="loss_scaling",
                initializer=ConstantInitializer(self._init_loss_scaling))
            self._good_steps = helper.create_global_variable(
                [1], "int32", name="loss_scaling_good_steps",
                initializer=ConstantInitializer(0.0))
            self._bad_steps = helper.create_global_variable(
                [1], "int32", name="loss_scaling_bad_steps",
                initializer=ConstantInitializer(0.0))
            block = program.global_block()
            scaled = helper.create_variable_for_type_inference("float32")
            block.append_op("elementwise_mul",
                            {"X": [loss.name], "Y": [self._loss_scaling.name]},
                            {"Out": [scaled.name]}, {"axis": -1})
            params_grads = append_backward(scaled, parameter_list, no_grad_set)
            # unscale
            unscaled = []
            for p, g in params_grads:
                ug = helper.create_variable_for_type_inference("float32")
                block.append_op("elementwise_div",
                                {"X": [g.name], "Y": [self._loss_scaling.name]},
                                {"Out": [ug.name]}, {"axis": -1})
                unscaled.append((p, ug))
            if self._use_dynamic:
                outs = [helper.create_variable_for_type_inference("float32")
                        for _ in unscaled]
                found = helper.create_variable_for_type_inference("bool")
                block.append_op(
                    "update_loss_scaling",
                    {"Grads": [g.name for _, g in unscaled],
                     "LossScaling": [self._loss_scaling.name],
                     "GoodSteps": [self._good_steps.name],
                     "BadSteps": [self._bad_steps.name]},
                    {"Out": [o.name for o in outs],
                     "LossScalingOut": [self._loss_scaling.name],
                     "GoodStepsOut": [self._good_steps.name],
                     "BadStepsOut": [self._bad_steps.name],
                     "FoundInf": [found.name]},
                    {"incr_every_n_steps": self._incr_every,
                     "decr_every_n_nan_or_inf": self._decr_every,
                     "incr_ratio": self._incr_ratio,
                     "decr_ratio": self._decr_ratio})
                unscaled = [(p, o) for (p, _), o in zip(unscaled, outs)]
            return unscaled
        # bfloat16: range of f32 — plain backward
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        ops = self.apply_gradients(params_grads)
        return ops, params_grads

    def __getattr__(self, name):
        return getattr(self._optimizer, name)


def decorate(optimizer, amp_lists=None, init_loss_scaling: float = 2 ** 15,
             incr_every_n_steps: int = 1000, decr_every_n_nan_or_inf: int = 2,
             incr_ratio: float = 2.0, decr_ratio: float = 0.8,
             use_dynamic_loss_scaling: bool = True,
             dtype: str = "bfloat16") -> OptimizerWithMixedPrecision:
    """contrib.mixed_precision.decorate parity; dtype='bfloat16' (the
    default, no loss scaling) or 'float16' (reference semantics incl.
    scaling)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists or AutoMixedPrecisionLists(), init_loss_scaling,
        use_dynamic_loss_scaling, incr_every_n_steps, incr_ratio, decr_ratio,
        dtype, decr_every_n_nan_or_inf=decr_every_n_nan_or_inf)
