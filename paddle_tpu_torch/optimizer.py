"""Optimizers for static-graph training: the port's copy of the dense part of
``paddle_tpu.optimizer`` (reference ``python/paddle/fluid/optimizer.py``,
Optimizer base :50 — minimize → append_backward + the optimization pass).

Accumulators are persistable vars initialized in the startup program, named
as in the JAX package (``{param}_{OptimizerName}_{acc}``), so an optimizer
state carries across one to one (``io.load_params_from_numpy``); each
parameter gets one update op consuming ``param@GRAD``. The sparse-row
variants (``deferred_rows=``, ``packed_rows=``) come with the DeepFM slice;
the dygraph path is not ported.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .core.backward import append_backward
from .core.dtypes import dtype_str
from .core.program import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


def _no_sparse_rows(deferred_rows, packed_rows):
    if deferred_rows is not None or packed_rows is not None:
        raise NotImplementedError(
            "deferred_rows/packed_rows (sparse row-update tables) are not "
            "ported to paddle_tpu_torch yet; they arrive with the DeepFM "
            "slice")


class Optimizer:
    """Base optimizer (optimizer.py:50)."""

    def __init__(self, learning_rate, regularization=None, name: Optional[str] = None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or type(self).__name__
        self._accumulators = {}
        self._lr_var = None
        self.helper = None
        self.type = "optimizer"

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        self._lr_var = helper.create_global_variable(
            shape=[1], dtype="float32",
            name=f"learning_rate_{self._name}",
            initializer=ConstantInitializer(float(self._learning_rate)))

    def _global_learning_rate(self) -> Variable:
        return self._lr_var

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name: str, param: Variable, fill_value: float = 0.0,
                         shape=None, dtype=None) -> Variable:
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(f"{self._name}_{name}")
        acc = helper.create_global_variable(
            shape=shape if shape is not None else list(param.shape),
            dtype=dtype or dtype_str(param.dtype),
            name=f"{param.name}_{self._name}_{name}",
            initializer=ConstantInitializer(fill_value))
        self._accumulators[key] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # -- api ----------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads) -> List:
        prog = default_main_program()
        # update ops go to the CURRENT block; accumulator VARS live in the
        # global block (persistable)
        block = prog.current_block()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        self._create_global_learning_rate()
        self._create_accumulators(prog.global_block(),
                                  [p for p, g in params_grads])
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None) -> Tuple[List, List]:
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None, deferred_rows=None, packed_rows=None):
        _no_sparse_rows(deferred_rows, packed_rows)
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]}, attrs={})


class _AdamLike(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 regularization=None, name=None, grad_clip=None,
                 deferred_rows=None, packed_rows=None, **kw):
        _no_sparse_rows(deferred_rows, packed_rows)
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = self.op_type
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._extra_attrs = kw

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1], dtype="float32")
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2, shape=[1], dtype="float32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        attrs = {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}
        attrs.update(self._extra_attrs)
        return block.append_op(
            type=self.op_type,
            inputs={"Param": [p.name], "Grad": [g.name], "Moment1": [m1.name],
                    "Moment2": [m2.name], "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name], "Moment2Out": [m2.name],
                     "Beta1PowOut": [b1p.name], "Beta2PowOut": [b2p.name]},
            attrs=attrs)


class AdamOptimizer(_AdamLike):
    op_type = "adam"


class AdamWOptimizer(_AdamLike):
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, coeff=weight_decay, **kw)


class LambOptimizer(_AdamLike):
    """optimizer.py:2103 LambOptimizer."""
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         weight_decay=lamb_weight_decay, **kw)


SGD = SGDOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Lamb = LambOptimizer
