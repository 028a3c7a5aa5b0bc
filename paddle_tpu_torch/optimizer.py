"""Optimizers for static-graph training: the port's copy of the dense part of
``paddle_tpu.optimizer`` (reference ``python/paddle/fluid/optimizer.py``,
Optimizer base :50 — minimize → append_backward + the optimization pass).

Accumulators are persistable vars initialized in the startup program, named
as in the JAX package (``{param}_{OptimizerName}_{acc}``), so an optimizer
state carries across one to one (``io.load_params_from_numpy``); each
parameter gets one update op consuming ``param@GRAD``. ``packed_rows=``
(SGD, Adagrad, Adam) puts a packed row-major table (``embedding(...,
row_pack=True)``) on its ``*_row_packed`` op, with the optimizer state in
the table's own rows; ``deferred_rows=`` (SGD, Adagrad, Adam) puts an
``is_sparse`` table on the deferred-row log (``ops/deferred_rows.py``):
state vars named as in the JAX package (``{p}@pending_pos``, ``@log_ids``,
``@log_raw``, ``@log_cum``, ``@log_count``), the lookup site rewired to
read through them, a ``*_row_deferred`` update op and a fold program the
executor runs every ``segments`` steps (``main._epilogue_programs``).

The dygraph path (``minimize`` under ``dygraph.guard``): the JAX package's
scratch program of the same update ops (clip → regularize → update), built
once per parameter set and run under ``torch.no_grad()`` by the port's
one-device block runner (with ``PDTPU_FUSE_UPDATES``'s multi-tensor update
groups where they apply), then copied into each parameter's tensor in
place, so every VarBase keeps the same autograd leaf. The JAX package jits
the whole update block; the port runs it op by op (one CUDA graph of it is
ROADMAP A2's).

Also here, as in the JAX package: LarsMomentum, DecayedAdagrad, Adadelta,
RMSProp, Adamax and Ftrl; GradientMergeOptimizer and LookaheadOptimizer,
whose predicated parts run in a ``conditional_block``; ModelAverage (the
JAX package's stub, copied as it is), ExponentialMovingAverage and
DGCMomentumOptimizer (the ``dgc_momentum`` op). PipelineOptimizer is the JAX
package's program transform, copied as it is: it cuts the program into
``pipeline``/``pipeline_hetero`` ops (``ops/pipeline_ops.py``).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np

from .core.backward import append_backward
from .core.dtypes import dtype_str
from .core.program import (Program, Variable, default_main_program,
                           default_startup_program)
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


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
        # deferred row updates (ops/deferred_rows.py): set by subclasses
        # that accept the deferred_rows kwarg
        self._deferred_rows = None
        self._deferred_applied = []
        self.fold_program = None

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
        # marks the var for ZeRO optimizer-state sharding
        # (compiler.CompiledProgram._zero_plan), as the JAX package marks it:
        # param-shaped accumulators (moments, velocities) shard over the dp
        # axis; scalar side-state (beta pows) stays whole on every rank
        acc.is_optimizer_state = True
        acc.zero_shardable = (shape is None
                              and int(np.prod(param.shape or [1])) > 1)
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

    # -- deferred row updates (ops/deferred_rows.py) -----------------------
    @staticmethod
    def _normalize_deferred(cfg):
        """deferred_rows kwarg: None, or {"rows_per_step": R[, "segments":
        K]}. R must bound the lookup rows any single step produces for the
        table (static capacity, checked again when the op runs)."""
        if cfg is None:
            return None
        if not isinstance(cfg, dict) or "rows_per_step" not in cfg:
            raise ValueError(
                "deferred_rows must be a dict with at least 'rows_per_step' "
                "(max lookup rows per step), optionally 'segments' "
                f"(fold cadence, default 16); got {cfg!r}")
        return {"segments": int(cfg.get("segments", 16)),
                "rows_per_step": int(cfg["rows_per_step"])}

    def _deferred_setup(self, block, p, state_init=0.0):
        """Create the postab + append-log state of table `p`, rewrite its
        single sparse lookup site to read through it and to export its
        gathered rows (the distributed_lookup_table rewrite analog,
        parameter_prefetch.cc), init the state columns, and record the fold
        inputs. Returns the dict of vars for the optimizer op."""
        cfg = self._deferred_rows
        k, r = cfg["segments"], cfg["rows_per_step"]
        mult = self._DEFERRED_STATE_MULT[self.type]
        dt = int(p.shape[-1])
        if dt % mult:
            raise ValueError(
                f"deferred_rows: {self.type} stores {mult} column groups "
                f"per row (param{'' if mult == 1 else ' + moment state'}), "
                f"so table {p.name!r} needs last dim divisible by {mult}; "
                f"got {dt}. Build the embedding with "
                f"[vocab, dim*{mult}] and slice [:, :, :dim]")
        vis = dt // mult
        c = k * r
        prog = block.program
        sites = self._deferred_sites(prog, p)
        if len(sites) != 1:
            raise ValueError(
                f"deferred_rows: table {p.name!r} has {len(sites)} "
                f"is_sparse lookup sites; the deferred path requires "
                f"exactly one (its gathered rows feed the optimizer op)")
        (site,) = sites
        if site.attrs.get("row_pack_dt"):
            raise ValueError(
                f"deferred_rows: table {p.name!r} was built with "
                f"row_pack=True; row_pack tables require the packed_rows "
                f"optimizer config (direct touched-row scatter updates), "
                f"not deferred_rows")
        helper = LayerHelper(f"{self._name}_deferred")
        postab = helper.create_global_variable(
            [int(p.shape[0])], "int32", name=f"{p.name}@pending_pos",
            initializer=ConstantInitializer(-1))
        log_ids = helper.create_global_variable(
            [c], "int32", name=f"{p.name}@log_ids",
            initializer=ConstantInitializer(2**31 - 1))
        # log rows lane-padded to a 128 multiple, as the JAX package
        # declares them (a JAX scope or checkpoint loads unchanged)
        lw = ((dt + 127) // 128) * 128
        log_raw = helper.create_global_variable(
            [c, lw], dtype_str(p.dtype), name=f"{p.name}@log_raw")
        log_cum = helper.create_global_variable(
            [c, lw], dtype_str(p.dtype), name=f"{p.name}@log_cum")
        count = helper.create_global_variable(
            [1], "int32", name=f"{p.name}@log_count")
        if mult > 1:
            # state columns: overwrite whatever the param initializer
            # produced there with the moment initial value
            default_startup_program().global_block().append_op(
                type="deferred_init_state_cols",
                inputs={"Param": [p.name]}, outputs={"ParamOut": [p.name]},
                attrs={"vis": vis, "value": float(state_init)})
        # rewrite the lookup site: read through the pending state and
        # export the gathered current/cum rows for the optimizer op
        cum_var = prog.global_block().create_var(
            name=f"{p.name}@lookup_cum", shape=[-1, dt], dtype="float32",
            persistable=False, stop_gradient=True)
        site.inputs["PendingPos"] = [postab.name]
        site.inputs["PendingCum"] = [log_cum.name]
        site.outputs["CumOut"] = [cum_var.name]
        prog._bump_version()
        out = {"postab": postab, "log_ids": log_ids, "log_raw": log_raw,
               "log_cum": log_cum, "count": count,
               "fwd_rows": site.outputs["Out"][0], "fwd_cum": cum_var.name,
               "vis": vis}
        self._deferred_applied.append((p, out))
        return out

    def _deferred_io(self, p, g, dv):
        """The input/output maps shared by the deferred optimizer ops."""
        inputs = {"Grad": [g.name],
                  "FwdRows": [dv["fwd_rows"]], "FwdCum": [dv["fwd_cum"]],
                  "PendingPos": [dv["postab"].name],
                  "LogIds": [dv["log_ids"].name],
                  "LogRaw": [dv["log_raw"].name],
                  "LogCum": [dv["log_cum"].name],
                  "Count": [dv["count"].name],
                  "LearningRate": [self._lr_var.name]}
        outputs = {"PendingPosOut": [dv["postab"].name],
                   "LogIdsOut": [dv["log_ids"].name],
                   "LogRawOut": [dv["log_raw"].name],
                   "LogCumOut": [dv["log_cum"].name],
                   "CountOut": [dv["count"].name]}
        return inputs, outputs

    def _build_deferred_fold(self, main_prog):
        """One `deferred_fold` op per deferred table in a program of its
        own, attached as an executor epilogue at the fold cadence (the
        pserver communicator-cadence analog): ``main._epilogue_programs``
        gains ``(segments, fold_program, meta)``. Running it is a pure
        representation change; it just has to run before the log wraps."""
        if not self._deferred_applied:
            return
        cfg = self._deferred_rows
        fold = Program()
        blk = fold.global_block()

        def decl(v):
            if blk._find_var_recursive(v.name) is None:
                blk.create_var(name=v.name, shape=list(v.shape),
                               dtype=dtype_str(v.dtype), persistable=True)
            return v.name

        for p, dv in self._deferred_applied:
            inputs = {"Param": [decl(p)],
                      "PendingPos": [decl(dv["postab"])],
                      "LogIds": [decl(dv["log_ids"])],
                      "LogRaw": [decl(dv["log_raw"])],
                      "LogCum": [decl(dv["log_cum"])],
                      "Count": [decl(dv["count"])]}
            outputs = {"ParamOut": [p.name],
                       "PendingPosOut": [dv["postab"].name],
                       "LogIdsOut": [dv["log_ids"].name],
                       "LogRawOut": [dv["log_raw"].name],
                       "LogCumOut": [dv["log_cum"].name],
                       "CountOut": [dv["count"].name]}
            blk.append_op(type="deferred_fold", inputs=inputs,
                          outputs=outputs, attrs={})
        meta = {"count_vars": [dv["count"].name
                               for _, dv in self._deferred_applied],
                "rows_per_step": cfg["rows_per_step"]}
        main_prog._epilogue_programs = (
            list(getattr(main_prog, "_epilogue_programs", []))
            + [(cfg["segments"], fold, meta)])
        self.fold_program = fold

    def _deferred_applies(self, prog, p):
        return (self._deferred_rows is not None
                and bool(self._deferred_sites(prog, p)))

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
        ops = [self._append_optimize_op(block, pg) for pg in params_grads]
        if self._deferred_rows is not None:
            if not self._deferred_applied:
                raise ValueError(
                    "deferred_rows was set but no parameter has an "
                    "is_sparse lookup_table site — deferred row updates "
                    "need SelectedRows gradients (build the embedding "
                    "with is_sparse=True)")
            self._build_deferred_fold(prog)
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None) -> Tuple[List, List]:
        from .core.program import in_dygraph_mode
        if in_dygraph_mode():
            return self._dygraph_minimize(loss, parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # -- dygraph path --------------------------------------------------------
    # Reuses the per-class static op emission on a scratch Program executed
    # eagerly: the scratch program IS the optimizer step (one op per param +
    # accumulator updates), the dygraph analog of apply_gradients. Reference
    # parity: dygraph optimizers share op kernels with static mode
    # (imperative/prepared_operator.h).
    def _dygraph_setup(self, params):
        from .core.executor import (ExecContext, _SubPlan, _fuse_updates_mode,
                                    _run_block)
        from .core.program import grad_var_name, program_guard

        # rebuild from scratch: cached lr/accumulator vars belong to the
        # previous scratch program; names are deterministic, so accumulated
        # values transfer via the old-env merge below
        self._lr_var = None
        self._accumulators = {}
        self._dy_prog = Program()
        dy_startup = Program()
        with program_guard(self._dy_prog, dy_startup):
            block = self._dy_prog.global_block()
            pvars = []
            for p in params:
                pv = block.create_parameter(name=p.name, shape=list(p.shape),
                                            dtype=p.dtype, trainable=True)
                pv.regularizer = getattr(p, "regularizer", None)
                pv.need_clip = getattr(p, "need_clip", True)
                block.create_var(name=grad_var_name(p.name),
                                 shape=list(p.shape), dtype=p.dtype)
                pvars.append(pv)
            # same pipeline as static apply_gradients: clip → regularize →
            # update
            params_grads = [(pv, block.var(grad_var_name(pv.name)))
                            for pv in pvars]
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            self._create_global_learning_rate()
            self._create_accumulators(block, [pg[0] for pg in params_grads])
            for pg in params_grads:
                self._append_optimize_op(block, pg)
        # init accumulators/lr by running the scratch startup program on the
        # parameters' device
        device = params[0].value.device
        env = {}
        _run_block(dy_startup.global_block(), env, ExecContext(device))
        # param-list change (e.g. unfreezing): keep accumulated state for
        # params that persist across rebuilds
        old_env = getattr(self, "_dy_env", None)
        if old_env:
            for k, v in old_env.items():
                if k in env:
                    env[k] = v
        self._dy_env = env
        self._dy_param_names = tuple(sorted(p.name for p in params))
        # optimizer update ops are never differentiated
        self._dy_ctx = ExecContext(device, is_test=True)
        self._dy_plan = _SubPlan(self._dy_prog.global_block(),
                                 _fuse_updates_mode())

    def set_lr(self, value: float):
        """Update the learning rate (works in both modes)."""
        import torch

        if getattr(self, "_dy_env", None) is not None \
                and self._lr_var is not None:
            old = self._dy_env[self._lr_var.name]
            self._dy_env[self._lr_var.name] = torch.tensor(
                [float(value)], dtype=torch.float32, device=old.device)
        elif self._lr_var is not None:
            old = global_scope().find_var(self._lr_var.name)
            global_scope().set_var(self._lr_var.name, torch.tensor(
                [float(value)], dtype=torch.float32,
                device=getattr(old, "device", "cpu")))
        else:
            self._learning_rate = float(value)

    def state_dict(self):
        """Optimizer state for checkpointing (dygraph: the scratch env;
        static: accumulator vars from the scope), as numpy arrays."""
        from .core.dtypes import to_numpy

        if getattr(self, "_dy_env", None) is not None:
            d = {k: to_numpy(v) for k, v in self._dy_env.items()}
        else:
            scope = global_scope()
            d = {}
            for (name, pname), acc in self._accumulators.items():
                v = scope.find_var(acc.name)
                if v is not None:
                    d[acc.name] = to_numpy(v)
        d["@optimizer_state@"] = np.asarray(1)
        return d

    def set_state_dict(self, state):
        from .core.dtypes import from_numpy

        state = {k: v for k, v in state.items() if k != "@optimizer_state@"}
        if getattr(self, "_dy_env", None) is not None:
            for k, v in state.items():
                old = self._dy_env.get(k)
                self._dy_env[k] = from_numpy(
                    v, device=getattr(old, "device", None))
        else:
            scope = global_scope()
            for k, v in state.items():
                old = scope.find_var(k)
                scope.set_var(k, from_numpy(
                    v, device=getattr(old, "device", None)))

    load_state_dict = set_state_dict

    def _dygraph_minimize(self, loss, parameter_list=None):
        import torch

        from .core.executor import _run_block
        from .core.program import grad_var_name
        from .dygraph.tracer import _active_tracer

        params = list(parameter_list if parameter_list is not None
                      else getattr(self, "_parameter_list", None) or [])
        if not params:
            raise ValueError(
                "dygraph minimize needs parameter_list (pass "
                "model.parameters())")
        tr = _active_tracer()
        if tr is not None and tr.tape:
            tr.run_backward(loss)
        names = tuple(sorted(p.name for p in params))
        if (getattr(self, "_dy_prog", None) is None
                or getattr(self, "_dy_param_names", None) != names):
            self._dygraph_setup(params)
        env = self._dy_env
        with torch.no_grad():
            for p in params:
                env[p.name] = p.value.detach()
                env[grad_var_name(p.name)] = (
                    p.grad_value if p.grad_value is not None
                    else torch.zeros_like(p.value))
            _run_block(self._dy_prog.global_block(), env, self._dy_ctx,
                       self._dy_plan)
            for p in params:
                new = env[p.name]
                # in place: the VarBase keeps the same autograd leaf
                if new.data_ptr() != p.value.data_ptr():
                    p.value.copy_(new)
        return [], [(p, p.grad_value) for p in params]


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None, deferred_rows=None, packed_rows=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "sgd"
        self._deferred_rows = self._normalize_deferred(deferred_rows)
        self._packed_rows = packed_rows

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        site = self._packed_site(block.program, p)
        if site is not None:
            inputs, outputs, attrs = self._packed_io(p, g, site)
            return block.append_op(type="sgd_row_packed", inputs=inputs,
                                   outputs=outputs, attrs=attrs)
        if self._deferred_applies(block.program, p):
            dv = self._deferred_setup(block, p)
            inputs, outputs = self._deferred_io(p, g, dv)
            return block.append_op(
                type="sgd_row_deferred", inputs=inputs, outputs=outputs,
                attrs={"vis": dv["vis"],
                       "rows_per_step": self._deferred_rows["rows_per_step"]})
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


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression momentum (reference optimizer.py:799 +
    sparse_all_reduce_op_handle.cc, the JAX package's program path).

    Emits a `dgc_momentum` op per parameter implementing the reference's
    update on the global gradient: momentum correction (u = mu·u + g;
    v += u), top-k selection with error feedback (the unsent mass of v
    carries over), and the sparse update p -= lr·topk(v). Before
    `rampup_begin_step` it behaves as dense momentum; sparsity then ramps
    through `sparsity` over `rampup_step` steps (reference schedule).

    On a mesh the mesh step sums the gradients over the data axis before
    the update, and the op runs on the whole parameter, so the
    sparsification applies to the GLOBAL gradient, as in the JAX package;
    the wire-level sparse exchange is the functional
    ``paddle_tpu_torch.parallel.dgc`` transforms (dgc_allreduce /
    sparse_allgather_exchange). ``dgc_step`` is a float [1] accumulator of
    the parameter's dtype, as in the JAX package, so a checkpoint crosses
    between the packages."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 clip_norm=1.0, **kw):
        super().__init__(learning_rate, momentum,
                         use_nesterov=use_nesterov, **kw)
        self.type = "dgc_momentum"
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = list(sparsity)
        self._clip_norm = float(clip_norm)  # 0 disables the local clip

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)
            self._add_accumulator("dgc_residual", p)
            self._add_accumulator("dgc_step", p, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        r = self._get_accumulator("dgc_residual", p)
        step = self._get_accumulator("dgc_step", p)
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "Residual": [r.name], "Step": [step.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name],
                     "ResidualOut": [r.name], "StepOut": [step.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": self._rampup_begin,
                   "rampup_step": self._rampup_step,
                   "sparsity": self._sparsity,
                   "clip_norm": self._clip_norm})


class _AdamLike(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 regularization=None, name=None, grad_clip=None,
                 deferred_rows=None, packed_rows=None, **kw):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = self.op_type
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._extra_attrs = kw
        if self.op_type != "adam" and (deferred_rows is not None
                                       or packed_rows is not None):
            raise ValueError(
                f"deferred_rows/packed_rows: sparse row-update kernels "
                f"exist for sgd/adagrad/adam only, not {self.op_type!r}")
        self._deferred_rows = self._normalize_deferred(deferred_rows)
        self._packed_rows = packed_rows

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            if (self._deferred_applies(block.program, p)
                    or self._packed_site(block.program, p) is not None):
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
        if self._deferred_applies(block.program, p):
            dv = self._deferred_setup(block, p)
            inputs, outputs = self._deferred_io(p, g, dv)
            inputs["Beta1Pow"] = [b1p.name]
            inputs["Beta2Pow"] = [b2p.name]
            outputs["Beta1PowOut"] = [b1p.name]
            outputs["Beta2PowOut"] = [b2p.name]
            attrs.update({"vis": dv["vis"],
                          "rows_per_step": self._deferred_rows["rows_per_step"]})
            return block.append_op(
                type="adam_row_deferred", inputs=inputs, outputs=outputs,
                attrs=attrs)
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
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial = initial_accumulator_value
        self._deferred_rows = self._normalize_deferred(deferred_rows)
        self._packed_rows = packed_rows

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            if (self._packed_site(block.program, p) is not None
                    or self._deferred_applies(block.program, p)):
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
        if self._deferred_applies(block.program, p):
            dv = self._deferred_setup(block, p, state_init=self._initial)
            inputs, outputs = self._deferred_io(p, g, dv)
            return block.append_op(
                type="adagrad_row_deferred", inputs=inputs, outputs=outputs,
                attrs={"epsilon": self._epsilon, "vis": dv["vis"],
                       "rows_per_step": self._deferred_rows["rows_per_step"]})
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon})


class LarsMomentumOptimizer(Optimizer):
    """optimizer.py:1058 LarsMomentumOptimizer: one `velocity` accumulator
    per parameter."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None,
                 grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, regularization=None,
                 name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, regularization=None,
                 name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        g1 = self._get_accumulator("avg_squared_grad", p)
        g2 = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p.name], "Grad": [g.name], "AvgSquaredGrad": [g1.name],
                    "AvgSquaredUpdate": [g2.name], "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [g1.name],
                     "AvgSquaredUpdateOut": [g2.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        mom = self._get_accumulator("momentum", p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p.name], "Grad": [g.name], "MeanSquare": [ms.name],
                    "MeanGrad": [mg.name], "Moment": [mom.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MeanSquareOut": [ms.name],
                     "MeanGradOut": [mg.name], "MomentOut": [mom.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1], dtype="float32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow", p)
        op = block.append_op(
            type="adamax",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "InfNorm": [inf.name], "Beta1Pow": [b1p.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name], "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon})
        # beta1_pow update (reference appends a scale op per param)
        block.append_op(type="scale", inputs={"X": [b1p.name]},
                        outputs={"Out": [b1p.name]}, attrs={"scale": self._beta1})
        return op


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, regularization, name, grad_clip)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "SquaredAccumulator": [sq.name], "LinearAccumulator": [lin.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class GradientMergeOptimizer:
    """Accumulate gradients for k steps, apply the inner optimizer once per
    k with the averaged gradient (newer-reference GradientMergeOptimizer
    semantics).

    Per-param accumulator vars + a step counter; the inner optimizer's
    update ops and the accumulator reset run inside a `conditional_block`
    guarded by (step % k == 0). The port runs that block only on the steps
    that apply (one host read of the condition a step)."""

    _uid = 0

    def __init__(self, inner_optimizer, k_steps: int = 1, avg: bool = True):
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        self._opt = inner_optimizer
        self._k = int(k_steps)
        self._avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import control_flow as cf
        from .layers import ops as ops_layers
        from .layers import tensor as tensor_layers

        if self._k == 1:
            return self._opt.minimize(loss, startup_program, parameter_list,
                                      no_grad_set)
        params_grads = self._opt.backward(loss, startup_program,
                                          parameter_list, no_grad_set)
        helper = LayerHelper("gradient_merge")
        # unique per instance: two merged optimizers in one program (e.g.
        # GAN D/G) must not share a counter
        GradientMergeOptimizer._uid += 1
        counter = helper.create_global_variable(
            [1], "int64",
            name=f"gradient_merge_step_{GradientMergeOptimizer._uid}",
            initializer=ConstantInitializer(0.0))
        one_v = tensor_layers.fill_constant([1], "int64", 1)
        k_v = tensor_layers.fill_constant([1], "int64", self._k)
        new_count = ops_layers.elementwise_add(counter, one_v)
        new_count = ops_layers.elementwise_mod(new_count, k_v)
        tensor_layers.assign(new_count, counter)
        apply_now = ops_layers.equal(
            new_count, tensor_layers.fill_constant([1], "int64", 0))

        merged = []
        for p, g in params_grads:
            acc = helper.create_global_variable(
                list(p.shape), p.dtype, name=f"{p.name}@GradientMerge",
                initializer=ConstantInitializer(0.0))
            # the persistent gradient buffer ShardingStrategy.stage2 shards
            acc.is_grad_buffer = True
            acc_new = ops_layers.elementwise_add(acc, g)
            tensor_layers.assign(acc_new, acc)
            merged.append((p, acc))

        # predicated apply: inner optimizer ops + accumulator reset run in a
        # sub-block gated on (step % k == 0)
        with cf.ConditionalBlock(apply_now):
            eff = []
            for p, acc in merged:
                g_eff = ops_layers.scale(acc, scale=1.0 / self._k) \
                    if self._avg else acc
                eff.append((p, g_eff))
            optimize_ops = self._opt.apply_gradients(eff)
            for p, acc in merged:
                tensor_layers.assign(ops_layers.scale(acc, scale=0.0), acc)
        return optimize_ops, params_grads

    def backward(self, *a, **kw):
        return self._opt.backward(*a, **kw)


class LookaheadOptimizer:
    """reference optimizer.py:2970 — fast/slow weight lookahead: every k
    steps, slow += alpha·(fast − slow) and fast resets to slow. A step
    counter and a `conditional_block`, as GradientMergeOptimizer."""

    _uid = 0

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer can not be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be within [0, 1]")
        if k <= 0:
            raise ValueError("k must be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import control_flow as cf
        from .layers import ops as ops_layers
        from .layers import tensor as tensor_layers

        out = self.inner_optimizer.minimize(
            loss, startup_program=startup_program)
        helper = LayerHelper("lookahead")
        LookaheadOptimizer._uid += 1
        counter = helper.create_global_variable(
            [1], "int64", name=f"lookahead_step_{LookaheadOptimizer._uid}",
            initializer=ConstantInitializer(0.0))
        one_v = tensor_layers.fill_constant([1], "int64", 1)
        new_count = ops_layers.elementwise_add(counter, one_v)
        tensor_layers.assign(new_count, counter)

        params = loss.block.program.global_block().all_parameters()
        slows = []
        startup_block = (startup_program
                         or default_startup_program()).global_block()
        for p in params:
            slow = helper.create_global_variable(
                list(p.shape), p.dtype, name=f"{p.name}@SLOW",
                initializer=ConstantInitializer(0.0))
            # slow starts as the INITIAL fast weights (reference seeds the
            # slow copies in the startup program, before any update runs)
            startup_block.append_op(type="assign", inputs={"X": [p.name]},
                                    outputs={"Out": [slow.name]}, attrs={})
            slows.append((p, slow))

        k_v = tensor_layers.fill_constant([1], "int64", self.k)
        sync = ops_layers.equal(
            ops_layers.elementwise_mod(new_count, k_v),
            tensor_layers.fill_constant([1], "int64", 0))
        with cf.ConditionalBlock(sync):
            for p, slow in slows:
                blended = ops_layers.elementwise_add(
                    ops_layers.scale(slow, scale=1.0 - self.alpha),
                    ops_layers.scale(p, scale=self.alpha))
                tensor_layers.assign(blended, slow)
                tensor_layers.assign(blended, p)
        return out

    def backward(self, *a, **kw):
        return self.inner_optimizer.backward(*a, **kw)


class ModelAverage(Optimizer):
    """optimizer.py:2257. The JAX package's ModelAverage is a stub whose
    apply() is a no-op context; the port copies it as it is (it adds no
    feature the JAX package lacks)."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self.type = "model_average"
        self._window = max_average_window

    def minimize(self, loss, **kw):
        raise TypeError("ModelAverage wraps apply(); call after another optimizer")

    def apply(self):
        @contextlib.contextmanager
        def _noop():
            yield
        return _noop()

    def restore(self, executor=None):
        pass


class ExponentialMovingAverage:
    """optimizer.py:2447 EMA of parameters, applied at eval time: update()
    appends ema = decay·ema + (1 − decay)·p for every trainable parameter
    (scale and sum ops); apply() swaps the EMA values into the scope and
    restores the parameters on exit."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._ema_vars = {}

    def update(self):
        prog = default_main_program()
        block = prog.global_block()
        helper = LayerHelper(self._name)
        for p in prog.all_parameters():
            if not p.trainable:
                continue
            ema = helper.create_global_variable(
                list(p.shape), dtype_str(p.dtype), name=f"{p.name}.{self._name}",
                initializer=ConstantInitializer(0.0))
            self._ema_vars[p.name] = ema
            # ema = decay*ema + (1-decay)*p  expressed with scale+sum ops
            tmp1 = helper.create_variable_for_type_inference(p.dtype)
            tmp2 = helper.create_variable_for_type_inference(p.dtype)
            block.append_op(type="scale", inputs={"X": [ema.name]},
                            outputs={"Out": [tmp1.name]}, attrs={"scale": self._decay})
            block.append_op(type="scale", inputs={"X": [p.name]},
                            outputs={"Out": [tmp2.name]}, attrs={"scale": 1.0 - self._decay})
            block.append_op(type="sum", inputs={"X": [tmp1.name, tmp2.name]},
                            outputs={"Out": [ema.name]}, attrs={})

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def _swap():
            scope = global_scope()
            saved = {}
            for pname, ema in self._ema_vars.items():
                saved[pname] = scope.find_var(pname)
                ev = scope.find_var(ema.name)
                if ev is not None:
                    scope.set_var(pname, ev)
            try:
                yield
            finally:
                if need_restore:
                    for pname, v in saved.items():
                        scope.set_var(pname, v)
        return _swap()

    def restore(self, executor=None):
        pass


class PipelineOptimizer:
    """Program-level pipeline parallelism (reference optimizer.py:2677).

    ``cut_list`` is the ordered chain of boundary variables
    ``[stage0_input, boundary1, ..., final_output]`` — N stages for N+1
    entries. The ops between consecutive boundaries must be isomorphic
    (same op-type sequence with same-shaped parameters — the
    transformer-by-layers case); ``minimize`` replaces them with ONE
    `pipeline` op holding the stage-0 template sub-block plus every stage's
    parameters, driven by the GPipe schedule in parallel/pipeline.py: the
    rank at ``pp`` coordinate i holds and updates stage i's parameters
    (``core/mesh_step.py``). Stages that are not isomorphic lower to one
    ``pipeline_hetero`` op with a sub-block a stage. Without a ``pp`` mesh
    axis the op runs its stages one after another.

    Usage::

        opt = fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.Adam(1e-4), cut_list=[h0, h1, h2],
            num_microbatches=4)
        opt.minimize(loss)
        prog = fluid.CompiledProgram(main).with_mesh(mesh, data_axis="dp")
    """

    def __init__(self, optimizer, cut_list, num_microbatches: int = 1,
                 axis: str = "pp", data_axis=None, capture_spec=None,
                 queue_size=None, place_list=None, concurrency_list=None,
                 sync_steps=None, start_cpu_core_id=None):
        # trailing args are reference-API compat (scope-queue knobs — moot).
        # capture_spec: {var_name: "batched"|"shared"} override for captured
        # prologue activations — by default a capture whose leading dim
        # equals the batch size is microbatched along with the activations;
        # use "shared" for e.g. a [T, T] table where T happens to equal B.
        if len(cut_list) < 3:
            raise ValueError("cut_list needs [input, boundary..., output] "
                             "(>= 2 stages)")
        self._opt = optimizer
        self._cut = list(cut_list)
        self._m = int(num_microbatches)
        self._axis = axis
        self._data_axis = data_axis
        self._capture_spec = dict(capture_spec or {})

    def _producer_idx(self, ops, name):
        for i in range(len(ops) - 1, -1, -1):
            if name in ops[i].output_names():
                return i
        return -1  # feed/data var: the pipelined region starts at op 0

    def _transform(self, program):
        from .core.program import Operator

        block = program.global_block()
        ops = block.ops
        names = [v.name for v in self._cut]
        bounds = [self._producer_idx(ops, n) for n in names]
        if bounds != sorted(bounds):
            raise ValueError("cut_list variables are not in program order")
        n_stages = len(names) - 1

        # per-stage op ranges: (producer(b_{k}) , producer(b_{k+1})]
        stage_ranges = [(bounds[k] + 1, bounds[k + 1] + 1)
                        for k in range(n_stages)]
        stage_ops = [ops[a:b] for a, b in stage_ranges]

        # isomorphism probe (op-type sequence + attrs): isomorphic stages
        # take the efficient stage-stacked template path; anything else
        # lowers to the heterogeneous per-stage-sub-block path
        # (reference section_worker.cc heterogeneous sections)
        def _iso():
            sig0 = [op.type for op in stage_ops[0]]
            for sops in stage_ops[1:]:
                if [op.type for op in sops] != sig0:
                    return False
                for o0, ok in zip(stage_ops[0], sops):
                    a0, ak = o0.attrs, ok.attrs
                    if a0.keys() != ak.keys() or any(
                            not np.array_equal(a0[k2], ak[k2])
                            if isinstance(a0[k2], np.ndarray)
                            else a0[k2] != ak[k2] for k2 in a0):
                        return False
            return True

        def stage_params(sops):
            seen, out = set(), []
            for op in sops:
                for n in op.input_names():
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable and n not in seen:
                        seen.add(n)
                        out.append(n)
            return out

        per_stage_params = [stage_params(s) for s in stage_ops]

        def _stackable():
            n_params = len(per_stage_params[0])
            for ps in per_stage_params:
                if len(ps) != n_params:
                    return False
                for a, b in zip(per_stage_params[0], ps):
                    va, vb = block.var(a), block.var(b)
                    if tuple(va.shape or ()) != tuple(vb.shape or ()):
                        return False
            return True

        # captured external activations (e.g. a shared attention mask built
        # in the prologue): read by stage ops, produced outside every stage
        def stage_captures(sops, skip):
            produced = set()
            caps = []
            for op in sops:
                for n in op.input_names():
                    v = block._find_var_recursive(n)
                    if (n not in produced and n not in skip
                            and not (v is not None and v.persistable)
                            and n not in caps):
                        caps.append(n)
                produced.update(op.output_names())
            return caps

        per_stage_caps = [
            stage_captures(sops, set(per_stage_params[k]) | {names[k]})
            for k, sops in enumerate(stage_ops)]
        captures = per_stage_caps[0]

        if not (_iso() and _stackable()
                and all(c == captures for c in per_stage_caps[1:])):
            return self._transform_hetero(program, block, names, stage_ops,
                                          stage_ranges, per_stage_params,
                                          per_stage_caps)
        n_params = len(per_stage_params[0])

        # template sub-block = stage 0's ops, re-homed
        cur = program.current_block_idx
        program.current_block_idx = block.idx
        sub = program.create_block()
        program.rollback()
        program.current_block_idx = cur
        for op in stage_ops[0]:
            op.block = sub
            sub.ops.append(op)

        # splice: remove all stage op ranges, insert the pipeline op
        lo, hi = stage_ranges[0][0], stage_ranges[-1][1]
        flat_params = [p for ps in per_stage_params for p in ps]
        pipe_op = Operator(
            block, "pipeline",
            inputs={"X": [names[0]], "Params": flat_params,
                    "Captures": captures},
            outputs={"Out": [names[-1]]},
            attrs={"sub_block": sub, "n_stages": n_stages,
                   "n_params": n_params, "num_microbatches": self._m,
                   "axis": self._axis, "data_axis": self._data_axis,
                   "in_name": names[0], "out_name": names[1],
                   "param_names": per_stage_params[0],
                   "capture_names": captures,
                   "capture_spec": self._capture_spec})
        block.ops[lo:hi] = [pipe_op]
        program._bump_version()

    def _transform_hetero(self, program, block, names, stage_ops,
                          stage_ranges, per_stage_params, per_stage_caps):
        """Non-isomorphic stages: one sub-block PER stage, lowered to the
        lax.switch ring in parallel/pipeline.pipeline_hetero (reference
        section_worker.cc:141 heterogeneous sections / trainer_desc.proto
        per-section programs)."""
        from .core.program import Operator

        n_stages = len(names) - 1
        subs = []
        cur = program.current_block_idx
        program.current_block_idx = block.idx
        for sops in stage_ops:
            sub = program.create_block()
            program.rollback()
            for op in sops:
                op.block = sub
                sub.ops.append(op)
            subs.append(sub)
        program.current_block_idx = cur

        lo, hi = stage_ranges[0][0], stage_ranges[-1][1]
        flat_params = [p for ps in per_stage_params for p in ps]
        flat_caps = [c for cs in per_stage_caps for c in cs]
        pipe_op = Operator(
            block, "pipeline_hetero",
            inputs={"X": [names[0]], "Params": flat_params,
                    "Captures": flat_caps},
            outputs={"Out": [names[-1]]},
            attrs={"sub_blocks": subs, "n_stages": n_stages,
                   "num_microbatches": self._m,
                   "axis": self._axis, "data_axis": self._data_axis,
                   "boundary_names": names,
                   "param_names": per_stage_params,
                   "capture_names": per_stage_caps,
                   "capture_spec": self._capture_spec})
        block.ops[lo:hi] = [pipe_op]
        program._bump_version()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._transform(loss.block.program)
        return self._opt.minimize(loss, startup_program, parameter_list,
                                  no_grad_set)

    def backward(self, *a, **kw):
        return self._opt.backward(*a, **kw)

    def apply_gradients(self, *a, **kw):
        return self._opt.apply_gradients(*a, **kw)



# paddle-style aliases (fluid.optimizer.SGD etc.)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
AdadeltaOpt = AdadeltaOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
