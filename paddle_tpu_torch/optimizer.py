"""Optimizers for static-graph training: the port's copy of the dense part of
``paddle_tpu.optimizer`` (reference ``python/paddle/fluid/optimizer.py``,
Optimizer base :50 — minimize → append_backward + the optimization pass).

Accumulators are persistable vars initialized in the startup program, named
as in the JAX package (``{param}_{OptimizerName}_{acc}``), so an optimizer
state carries across one to one (``io.load_params_from_numpy``); each
parameter gets one update op consuming ``param@GRAD``. ``packed_rows=``
(SGD, Adagrad, Adam) puts a packed row-major table (``embedding(...,
row_pack=True)``) on its ``*_row_packed`` op, with the optimizer state in
the table's own rows; ``deferred_rows=`` (the deferred-row log) and the
dygraph path are not ported.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .core.backward import append_backward
from .core.dtypes import dtype_str
from .core.program import (Variable, default_main_program,
                           default_startup_program)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


def _no_deferred_rows(deferred_rows):
    if deferred_rows is not None:
        raise NotImplementedError(
            "deferred_rows= (the deferred-row log: lookup_join, "
            "*_row_deferred, deferred_fold) is not ported to "
            "paddle_tpu_torch yet (ROADMAP A5, left out by slice 5); use "
            "packed_rows= with an embedding built with row_pack=True")


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

    # -- packed row-major tables ------------------------------------------
    _packed_rows = None

    # how many column groups the table row carries per optimizer type:
    # param only (sgd), param|G (adagrad), param|m|v (adam) — the Downpour
    # g2sum in-row state layout (pslib DownpourSparseTable)
    _DEFERRED_STATE_MULT = {"sgd": 1, "adagrad": 2, "adam": 3}

    @staticmethod
    def _deferred_sites(prog, p):
        return [op for blk in prog.blocks for op in blk.ops
                if op.type in ("lookup_table", "lookup_table_v2")
                and op.inputs.get("W") == [p.name]
                and op.attrs.get("is_sparse")]

    def _packed_site(self, prog, p):
        """The single row_pack lookup site of a packed table, or None."""
        if self._packed_rows is None:
            return None
        sites = [op for op in self._deferred_sites(prog, p)
                 if op.attrs.get("row_pack_dt")]
        if not sites:
            return None
        if len(sites) != 1:
            raise ValueError(
                f"packed_rows: table {p.name!r} has {len(sites)} row_pack "
                f"lookup sites; exactly one is required (its gathered rows "
                f"feed the optimizer op)")
        return sites[0]

    def _packed_io(self, p, g, site, state_init=0.0):
        mult = self._DEFERRED_STATE_MULT[self.type]
        dt = int(site.attrs["row_pack_dt"])
        if dt % mult:
            raise ValueError(
                f"packed_rows: {self.type} stores {mult} column groups per "
                f"row (param{'' if mult == 1 else ' + moment state'}), so "
                f"table {p.name!r} needs row_pack dt divisible by {mult}; "
                f"got dt={dt}. Build the embedding with "
                f"size=[vocab, dim*{mult}] and slice [:, :, :dim]")
        if mult > 1:
            # state columns start at the optimizer's initial value whatever
            # the table initializer wrote there (sqrt of a uniform-random G
            # would be NaN); honors adagrad initial_accumulator_value
            default_startup_program().global_block().append_op(
                type="rowpack_init_state_cols",
                inputs={"Param": [p.name]}, outputs={"ParamOut": [p.name]},
                attrs={"vis": dt // mult, "dt": dt,
                       "value": float(state_init)})
        inputs = {"Param": [p.name], "Grad": [g.name],
                  "FwdRows": [site.outputs["Out"][0]],
                  "LearningRate": [self._lr_var.name]}
        outputs = {"ParamOut": [p.name]}
        attrs = {"vis": dt // mult,
                 "rows_per_step": int(self._packed_rows["rows_per_step"]),
                 # packed_rows={"fused": False} pins the unfused
                 # gather+scatter branch of adagrad_row_packed
                 "fused": bool(self._packed_rows.get("fused", True))}
        return inputs, outputs, attrs

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
        _no_deferred_rows(deferred_rows)
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "sgd"
        self._packed_rows = packed_rows

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        site = self._packed_site(block.program, p)
        if site is not None:
            inputs, outputs, attrs = self._packed_io(p, g, site)
            return block.append_op(type="sgd_row_packed", inputs=inputs,
                                   outputs=outputs, attrs=attrs)
        return block.append_op(
            type="sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]}, attrs={})


class MomentumOptimizer(Optimizer):
    """optimizer.py:531 MomentumOptimizer: one `velocity` accumulator per
    parameter."""

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class _AdamLike(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 regularization=None, name=None, grad_clip=None,
                 deferred_rows=None, packed_rows=None, **kw):
        _no_deferred_rows(deferred_rows)
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = self.op_type
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._extra_attrs = kw
        if self.op_type != "adam" and packed_rows is not None:
            raise ValueError(
                f"packed_rows: sparse row-update kernels exist for "
                f"sgd/adagrad/adam only, not {self.op_type!r}")
        self._packed_rows = packed_rows

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            if self._packed_site(block.program, p) is not None:
                # m/v live in the table's state columns; beta pows stay
                self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1], dtype="float32")
                self._add_accumulator("beta2_pow", p, fill_value=self._beta2, shape=[1], dtype="float32")
                continue
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1], dtype="float32")
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2, shape=[1], dtype="float32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        attrs = {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}
        attrs.update(self._extra_attrs)
        site = self._packed_site(block.program, p)
        if site is not None:
            inputs, outputs, pattrs = self._packed_io(p, g, site)
            inputs["Beta1Pow"] = [b1p.name]
            inputs["Beta2Pow"] = [b2p.name]
            outputs["Beta1PowOut"] = [b1p.name]
            outputs["Beta2PowOut"] = [b2p.name]
            attrs.update(pattrs)
            return block.append_op(type="adam_row_packed", inputs=inputs,
                                   outputs=outputs, attrs=attrs)
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
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


class AdagradOptimizer(Optimizer):
    """optimizer.py AdagradOptimizer: one `moment` accumulator per
    parameter, or the G state columns of a packed table."""

    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0, grad_clip=None,
                 deferred_rows=None, packed_rows=None):
        _no_deferred_rows(deferred_rows)
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial = initial_accumulator_value
        self._packed_rows = packed_rows

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            if self._packed_site(block.program, p) is not None:
                continue  # G lives in the table's state columns
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        site = self._packed_site(block.program, p)
        if site is not None:
            inputs, outputs, attrs = self._packed_io(
                p, g, site, state_init=self._initial)
            attrs["epsilon"] = self._epsilon
            return block.append_op(type="adagrad_row_packed", inputs=inputs,
                                   outputs=outputs, attrs=attrs)
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer
AdamW = AdamWOptimizer
Lamb = LambOptimizer
