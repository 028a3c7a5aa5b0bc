"""CompiledProgram on one device or on a data-parallel mesh, ZeRO stages
0–3, and the remat policy surface.

Counterpart of ``paddle_tpu.core.compiler`` (reference
``python/paddle/fluid/compiler.py:65`` CompiledProgram,
with_data_parallel:143, and build_strategy.h). The JAX package shards the
feed over a device mesh and lets GSPMD insert the collectives. The port
runs one process a GPU under a ``torch.distributed`` group
(``parallel.init_parallel_env``, ``distributed.launch``):
``with_data_parallel`` lays a ``dp`` mesh over the group (N places need a
world of N), ``with_mesh`` takes a ``DeviceMesh`` with a data axis (or
none), model axes (tensor parallelism: each mesh dim that a parameter's
``shard_spec`` names), a ``pp`` axis for the program's pipeline ops
(``PipelineOptimizer``) and a sequence axis (``seq_axis``), any of them
at once, and ``Executor.run`` runs each rank's step on its own rows
(``core/mesh_step.py``); a mesh dim that none of them uses computes
replicated. Without a group, a CompiledProgram runs on the
executor's one device, where a ZeRO stage shards over one device, that
is, nothing. The ZeRO rules (``_zero_axis``, ``_zero_plan``,
``_fsdp_param``, ``_zero_pad_map``) are the JAX package's.

Remat. ``BuildStrategy.remat_policy`` (or ``PDTPU_REMAT_POLICY`` on the
plain executor) resolves to a :class:`RematSpec`. Consecutive ops tagged
with one ``fluid.remat_unit(name)`` run as ONE
``torch.utils.checkpoint`` region (non-reentrant): the forward keeps only
the unit's boundary values, and the backward recomputes the unit.
"minimal" saves the outputs of the matmuls inside a unit (the JAX
package's ``dots_saveable``) and recomputes the rest; "full" saves
nothing. Outside units, ``RematSpec.op_set`` checkpoints single ops.

``BuildStrategy.remat_saveable_names`` (the JAX package's
``save_only_these_names``): the named intermediates of a unit are kept
and everything else in it is recomputed. Torch's selective checkpoint
keys on aten ops, not program variables, so the unit's function marks
the program ops that write a named value while they run
(``saving_named``), and the unit's selective policy saves the results of
the aten ops run under that mark and recomputes every other one. In the
backward the marked ops take their saved results; the rest of the unit
runs again (every op whose saved tensors the backward needs, a matmul
that only saved its inputs too).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Sequence

import torch

from .program import Program

__all__ = ["ShardingStrategy", "RematSpec", "REMAT_POLICIES",
           "resolve_remat", "BuildStrategy", "ExecutionStrategy",
           "CompiledProgram"]

class ShardingStrategy:
    """ZeRO-style sharding of model state over the data-parallel axis
    (Rajbhandari et al. 2020), the JAX package's stages:

    - ``off``    — every state leaf whole on every rank.
    - ``stage1`` — optimizer accumulators shard over the dp axis: each
      rank's state bytes drop by ~1/dp.
    - ``stage2`` — stage1 plus the gradients: reduce-scattered to the same
      layout, and the persistent gradient buffers (GradientMergeOptimizer's
      ``@GradientMerge``) shard too.
    - ``stage3`` — stage2 plus the parameters: each float parameter lives
      sharded between steps; the sharded parameters are gathered at the
      first use of one of them in a step; the update runs on the shard.

    Each leaf shards along its largest dp-divisible dim, else dim 0 padded
    to ⌈d/dp⌉·dp. Losses stay bitwise those of ``off`` at the same world
    size: sharding only moves where each element lives."""

    off = 0
    stage1 = 1
    stage2 = 2
    stage3 = 3
    # CamelCase aliases matching ReduceStrategy naming
    Off = off
    Stage1 = stage1
    Stage2 = stage2
    Stage3 = stage3


def _zero_axis(shape, dp: int) -> Optional[int]:
    """Pick the dim of `shape` to shard over a dp-sized axis: the largest
    dp-divisible dim, else dim 0 when it is at least dp long (the ragged
    last shard padded, extent ⌈shape[0]/dp⌉). None means the leaf stays
    replicated (scalars, tiny leaves)."""
    dims = [d if isinstance(d, int) else -1 for d in (shape or ())]
    divisible = [i for i, d in enumerate(dims) if d > 0 and d % dp == 0]
    if divisible:
        return max(divisible, key=lambda i: dims[i])
    if dims and dims[0] >= dp:
        return 0
    return None


# Cheap-to-recompute op types: big activation residuals, trivial FLOPs to
# rebuild. The "minimal" remat policy checkpoints exactly these (outside
# annotated units), matching the reference RecomputeOptimizer's default of
# recomputing activations but never matmuls.
_MINIMAL_REMAT_OPS = frozenset({
    "relu", "gelu", "tanh", "sigmoid", "softmax", "dropout", "layer_norm",
    "batch_norm", "elementwise_add", "elementwise_mul", "scale",
})

# the aten matmuls whose outputs "minimal" keeps inside a unit (the JAX
# package's jax.checkpoint_policies.dots_saveable); convolutions and the
# hand-written kernels are recomputed, as XLA recomputes convs and
# pallas_calls under dots_saveable
_SAVED_DOTS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
})


def _dots_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_NAMED = threading.local()


@contextlib.contextmanager
def saving_named():
    """While a unit runs a program op that writes a ``saveable_names``
    value, the aten ops it runs are saved (`_names_saveable`)."""
    _NAMED.on = True
    try:
        yield
    finally:
        _NAMED.on = False


def _names_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if getattr(_NAMED, "on", False)
            else CheckpointPolicy.PREFER_RECOMPUTE)


class RematSpec:
    """Resolved remat policy — what a training step actually does.

    - ``op_set``: per-op checkpoint outside remat units — False (off),
      True (every differentiable op), or a frozenset of op types.
    - ``unit_policy``: None (no unit grouping) or a callable
      ``unit_name -> False | True | "minimal" | "full"`` deciding whether a
      `fluid.remat_unit(...)` block runs as one checkpointed region.
    - ``saveable_names``: var names kept as residuals inside units (the
      JAX package's ``save_only_these_names``; see the module
      docstring).
    - ``token``: hashable identity for the executor's plan keys.
    """

    __slots__ = ("op_set", "unit_policy", "saveable_names", "token")

    def __init__(self, op_set, unit_policy, saveable_names, token):
        self.op_set = op_set
        self.unit_policy = unit_policy
        self.saveable_names = saveable_names
        self.token = token

    def context_fn(self, unit_decision, named=False):
        """``context_fn`` for ``torch.utils.checkpoint`` of one unit's
        decision, or None for the plain checkpoint ("full"/True: save
        nothing, recompute the whole unit). `named`: the unit writes a
        ``saveable_names`` value, whose policy wins (as in the JAX
        package)."""
        if named:
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts

            return functools.partial(create_selective_checkpoint_contexts,
                                     _names_saveable)
        if unit_decision == "minimal":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts

            return functools.partial(create_selective_checkpoint_contexts,
                                     _dots_saveable)
        return None


REMAT_POLICIES = ("none", "minimal", "full")


def resolve_remat(policy=None, legacy_remat=False, saveable_names=None):
    """Map the remat policy surface (BuildStrategy.remat_policy, the legacy
    boolean-or-set BuildStrategy.remat, PDTPU_REMAT_POLICY/_OPS) onto a
    RematSpec."""
    names = tuple(saveable_names) if saveable_names else None
    if policy is None:
        # legacy knob: True = per-op checkpoint everywhere, a set = only
        # those op types; no unit grouping
        if legacy_remat is True:
            return RematSpec(True, None, names, ("legacy", True, names))
        if isinstance(legacy_remat, (set, frozenset)) and legacy_remat:
            fs = frozenset(legacy_remat)
            return RematSpec(fs, None, names,
                             ("legacy", tuple(sorted(fs)), names))
        return RematSpec(False, None, None, ("none",))
    if callable(policy):
        # per-layer predicate: unit_name -> False | True | "minimal" | "full"
        return RematSpec(False, policy, names,
                         ("predicate", id(policy), names))
    p = str(policy)
    if p == "none":
        return RematSpec(False, None, None, ("none",))
    if p == "minimal":
        return RematSpec(frozenset(_MINIMAL_REMAT_OPS),
                         lambda unit: "minimal", names, ("minimal", names))
    if p == "full":
        return RematSpec(True, lambda unit: "full", names, ("full", names))
    raise ValueError(
        f"remat_policy must be one of {REMAT_POLICIES}, a per-layer "
        f"predicate (unit_name -> bool|'minimal'|'full'), or None for the "
        f"legacy BuildStrategy.remat knob — got {policy!r}")


class BuildStrategy:
    """Knob bag kept for API parity (reference build_strategy.h:37-186).
    The remat knobs drive the port's step; the fusion and memory knobs are
    accepted and inert (``PDTPU_FUSE_UPDATES`` drives the update fusion);
    ``sharding_strategy`` picks the ZeRO stage of a mesh run."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.remat = False                     # legacy: True | {op types}
        # remat policy surface: "none" | "minimal" | "full" | callable
        # (unit_name -> bool|"minimal"|"full"); None defers to the legacy
        # `remat` knob. See resolve_remat().
        self.remat_policy = None
        # var names kept inside remat units (save_only_these_names)
        self.remat_saveable_names = None
        self.sharding_strategy = ShardingStrategy.off
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """reference execution_strategy.h:22 — scheduling knobs, inert: the
    port runs the ops of a step in program order on one stream."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class CompiledProgram:
    """``CompiledProgram(program).with_data_parallel(...)`` or
    ``.with_mesh(mesh, ...)``: ``Executor.run(compiled, ...)`` runs the
    program with the build strategy's remat policy, on the executor's one
    device, or, with a mesh, as this rank's data-parallel step."""

    def __init__(self, program: Program):
        self._program = program
        self._loss_name: Optional[str] = None
        self._mesh = None
        self._data_axis: Optional[str] = None
        self._model_axes: list = []
        self._model_axis: Optional[str] = None
        self._pp_axis: Optional[str] = None
        self._seq_axis: Optional[str] = None
        self._strategy_stage = 0
        self._strategy_remat = False
        self._strategy_remat_policy = None
        self._mesh_steps = {}  # the executor's MeshStep, by its key
        # the epilogue programs' CompiledPrograms on this mesh, by id
        self._epilogue_compiled = {}
        self.build_strategy: Optional[BuildStrategy] = None
        self.exec_strategy: Optional[ExecutionStrategy] = None

    # -- configuration -----------------------------------------------------
    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           places: Optional[Sequence] = None,
                           share_vars_from=None):
        """Shard the batch over every rank of the process group
        (compiler.py:143 parity): a ``dp`` mesh of the world's size. N
        places need a world of N processes, one a device; with no group
        the program runs on the executor's one device."""
        from ..parallel.env import get_world_size

        world = get_world_size()
        n = len(places) if places is not None else world
        if n != world:
            raise RuntimeError(
                f"with_data_parallel over {n} places needs a world of {n} "
                f"processes, one a device; this process group has {world}. "
                f"Start them with `python -m paddle_tpu_torch.distributed."
                f"launch --nproc {n} script.py` and call "
                f"parallel.init_parallel_env() first")
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh({"dp": world})
            self._data_axis = "dp"
            self._model_axes = []
            self._model_axis = self._pp_axis = self._seq_axis = None
        self._loss_name = loss_name
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        return self

    def with_mesh(self, mesh, data_axis: Optional[str] = "dp",
                  strategy=None, seq_axis: Optional[str] = None):
        """Run over a ``DeviceMesh`` (``parallel.make_mesh``):

        - `data_axis` (or None: every rank feeds the whole batch and the
          mesh's other dims compute it alike, the JAX package's
          ``data_axis=None``): each rank feeds its own rows;
        - model axes: each dim of size > 1 that a parameter's
          ``shard_spec`` names (Megatron tensor parallelism; several at
          once): those parameters are held as each rank's slice. A spec
          that names the data axis shards its parameter over it (ZeRO
          stage 3 for that parameter, on the spec's dim), one that names
          the sequence axis slices it there;
        - ``pp``: the axis of the program's ``pipeline`` ops
          (``PipelineOptimizer``): the rank at coordinate i holds and
          updates stage i;
        - `seq_axis`: dim 1 (the sequence) of every feed of rank ≥ 2 is
          sliced over it (sequence parallelism, beside model and pipeline
          axes too; ValueError when it is the data axis, as in the JAX
          package);
        - ``layers.moe_ffn`` spreads its experts over its ``ep_axis``
          (the data axis or another);
        - any other dim (a ``dp`` dim that is not the data axis, an
          ``sp`` dim without `seq_axis`) computes replicated, as in the
          JAX package.

        `strategy` (a fleet ``DistributedStrategy``) wires
        sharding_degree/sharding_stage (ZeRO over the data axis) and
        recompute/remat_policy (remat)."""
        names = getattr(mesh, "mesh_dim_names", None)
        if names is None:
            raise TypeError(f"with_mesh takes a DeviceMesh with named dims "
                            f"(parallel.make_mesh), got {type(mesh).__name__}")
        if data_axis is not None and data_axis not in names:
            raise ValueError(f"with_mesh: data_axis {data_axis!r} is not a "
                             f"dim of the mesh {tuple(names)}")
        seq = seq_axis if seq_axis in names else None
        if seq is not None and seq == data_axis:
            raise ValueError(
                f"with_mesh: seq_axis and data_axis are both "
                f"{seq_axis!r} — a feed dim cannot shard over the same "
                f"mesh axis twice; use distinct axes")
        pipe_axes = {op.attrs.get("axis", "pp")
                     for op in self._program.global_block().ops
                     if op.type in ("pipeline", "pipeline_hetero")}
        spec_axes = {a for v in self._program.list_vars()
                     if v.persistable
                     for a in (getattr(v, "shard_spec", None) or ())}
        models, pp = [], None
        for name, size in zip(names, mesh.shape):
            if name in (data_axis, seq) or size == 1:
                continue
            if name in pipe_axes:
                pp = name
            elif name in spec_axes:
                models.append(name)
            # else: no spec, feed or pipeline uses it; computes replicated
        self._mesh = mesh
        self._data_axis = data_axis
        self._model_axes = models
        self._model_axis = models[0] if models else None
        self._pp_axis = pp
        self._seq_axis = seq
        self._strategy_stage = 0       # re-derived per call, never sticky
        self._strategy_remat = False
        self._strategy_remat_policy = None
        if strategy is not None:
            if getattr(strategy, "sharding_degree", 1) > 1:
                # sharding on; sharding_stage picks ZeRO-1/2/3
                self._strategy_stage = max(
                    1, int(getattr(strategy, "sharding_stage", 1) or 1))
            if getattr(strategy, "recompute", False):
                self._strategy_remat = True
            self._strategy_remat_policy = getattr(
                strategy, "remat_policy", None)
            if getattr(strategy, "gradient_merge_steps", 1) > 1:
                raise NotImplementedError(
                    "gradient_merge_steps on DistributedStrategy is not "
                    "wired; use fluid.optimizer.GradientMergeOptimizer")
        if self.build_strategy is None:
            self.build_strategy = BuildStrategy()
        if self.exec_strategy is None:
            self.exec_strategy = ExecutionStrategy()
        return self

    def with_inference_optimize(self, config=None):
        """Reference inference_optimize parity: freeze to the test-mode
        graph, and when an inference `Config` is supplied run its IR pass
        pipeline (the Predictor's), with the per-pass cost deltas in
        ``_pass_report``."""
        self._program = self._program.clone(for_test=True)
        if config is not None and getattr(config, "ir_optim",
                                          lambda: False)():
            from ..ir.pipeline import optimize_inference_program
            self._program = optimize_inference_program(
                self._program, config,
                label=f"compiled:0x{id(self._program):x}")
        return self

    # -- the ZeRO plan (the JAX package's rules) ----------------------------
    def _dp_size(self) -> int:
        names = list(self._mesh.mesh_dim_names)
        return int(self._mesh.shape[names.index(self._data_axis)])

    def _zero_stage(self) -> int:
        """Effective ShardingStrategy stage: the stronger of the fleet
        DistributedStrategy wiring (with_mesh) and build_strategy's own
        knob, resolved at each run so `c.build_strategy = bs` after
        with_data_parallel/with_mesh still takes effect."""
        if self._data_axis is None or self._mesh is None:
            return ShardingStrategy.off
        stage = int(self._strategy_stage or 0)
        bs = self.build_strategy
        if bs is not None:
            stage = max(stage, int(getattr(bs, "sharding_strategy", 0) or 0))
        return stage

    def _remat_spec(self) -> RematSpec:
        """Effective remat policy, resolved at each run:
        build_strategy.remat_policy wins, then the fleet
        DistributedStrategy's remat_policy, then the legacy boolean/set
        knobs (build_strategy.remat, DistributedStrategy.recompute)."""
        bs = self.build_strategy
        policy = getattr(bs, "remat_policy", None) if bs is not None else None
        if policy is None:
            policy = self._strategy_remat_policy
        legacy = ((bs.remat if bs is not None else False)
                  or self._strategy_remat)
        names = (getattr(bs, "remat_saveable_names", None)
                 if bs is not None else None)
        return resolve_remat(policy, legacy, names)

    def _zero_plan(self, var):
        """(axis, pad_to) sharding plan for `var` over the data axis under
        the effective ZeRO stage, or None to leave it whole. Eligible
        leaves — optimizer accumulators, master weights, (stage2)
        persistent gradient buffers and (stage3) the parameters, all tagged
        at creation — shard along their largest dp-divisible dim; the
        dim-0 fallback pads to ⌈d/dp⌉·dp (pad_to)."""
        stage = self._zero_stage()
        if stage < ShardingStrategy.stage1 or var is None:
            return None
        shardable = (getattr(var, "is_optimizer_state", False)
                     or getattr(var, "is_master_weight", False)
                     or (stage >= ShardingStrategy.stage2
                         and getattr(var, "is_grad_buffer", False))
                     or (stage >= ShardingStrategy.stage3
                         and self._fsdp_param(var)))
        if not shardable or not getattr(var, "zero_shardable", True):
            return None
        dp = self._dp_size()
        axis = _zero_axis(var.shape, dp)
        if axis is None:
            return None
        d = var.shape[axis]
        pad_to = None if d % dp == 0 else -(-d // dp) * dp
        return axis, pad_to

    @staticmethod
    def _fsdp_param(var) -> bool:
        """Stage3 eligibility: trainable float parameters without a TP
        `shard_spec`. Non-float leaves (row-packed uint16 tables) stay
        whole."""
        if not (getattr(var, "trainable", False) and var.persistable):
            return False
        if getattr(var, "shard_spec", None) is not None:
            return False
        from .dtypes import dtype_str
        try:
            return dtype_str(var.dtype) in ("float32", "float64", "float16",
                                            "bfloat16")
        except Exception:
            return False

    def _zero_pad_map(self):
        """{name: (logical_dim0, padded_dim0)} for every persistable on the
        padding fallback under the current mesh/stage, also recorded on the
        Program (`_zero_padded`: name -> logical shape) so layout-unaware
        paths (the plain Executor, checkpoints) drop the pad of a scope
        value that lives sharded."""
        pads = {}
        for v in self._program.list_vars():
            if not v.persistable:
                continue
            plan = self._zero_plan(v)
            if plan is not None and plan[1] is not None:
                pads[v.name] = (v.shape[0], plan[1])
        if pads:
            rec = getattr(self._program, "_zero_padded", None)
            if rec is None:
                rec = self._program._zero_padded = {}
            for n in pads:
                var = self._program.global_block()._find_var_recursive(n)
                rec[n] = tuple(var.shape)
        return pads
