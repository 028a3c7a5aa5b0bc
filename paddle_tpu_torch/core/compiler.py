"""CompiledProgram on one device, and the remat policy surface.

Counterpart of the one-device part of ``paddle_tpu.core.compiler``
(reference ``python/paddle/fluid/compiler.py:65`` CompiledProgram,
with_data_parallel:143, and build_strategy.h). The JAX package shards the
feed over a device mesh and lets XLA insert the collectives; the port
runs a CompiledProgram on the executor's one device, through the
``Executor`` with the build strategy's remat policy. A mesh, several
places and ZeRO sharding are ROADMAP A9 and raise ``NotImplementedError``.

Remat. ``BuildStrategy.remat_policy`` (or ``PDTPU_REMAT_POLICY`` on the
plain executor) resolves to a :class:`RematSpec`. Consecutive ops tagged
with one ``fluid.remat_unit(name)`` run as ONE
``torch.utils.checkpoint`` region (non-reentrant): the forward keeps only
the unit's boundary values, and the backward recomputes the unit.
"minimal" saves the outputs of the matmuls inside a unit (the JAX
package's ``dots_saveable``) and recomputes the rest; "full" saves
nothing. Outside units, ``RematSpec.op_set`` checkpoints single ops.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from .program import Program

__all__ = ["ShardingStrategy", "RematSpec", "REMAT_POLICIES",
           "resolve_remat", "BuildStrategy", "ExecutionStrategy",
           "CompiledProgram"]

_A9 = "is not ported yet (ROADMAP A9: multi-device CompiledProgram)"


class ShardingStrategy:
    """ZeRO-style sharding of model state over the data-parallel axis, as
    the JAX package names its stages. Only ``off`` runs in the port; the
    other stages need several devices (ROADMAP A9)."""

    off = 0
    stage1 = 1
    stage2 = 2
    stage3 = 3
    # CamelCase aliases matching ReduceStrategy naming
    Off = off
    Stage1 = stage1
    Stage2 = stage2
    Stage3 = stage3


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


class RematSpec:
    """Resolved remat policy — what a training step actually does.

    - ``op_set``: per-op checkpoint outside remat units — False (off),
      True (every differentiable op), or a frozenset of op types.
    - ``unit_policy``: None (no unit grouping) or a callable
      ``unit_name -> False | True | "minimal" | "full"`` deciding whether a
      `fluid.remat_unit(...)` block runs as one checkpointed region.
    - ``saveable_names``: var names the JAX package keeps as residuals
      inside units (``save_only_these_names``). Torch's selective
      checkpoint keys on aten ops, not on program variables, so the port
      refuses a spec that carries them (ROADMAP A9).
    - ``token``: hashable identity for the executor's plan keys.
    """

    __slots__ = ("op_set", "unit_policy", "saveable_names", "token")

    def __init__(self, op_set, unit_policy, saveable_names, token):
        if saveable_names:
            raise NotImplementedError(
                f"remat saveable_names {_A9}: torch.utils.checkpoint's "
                f"selective policy keys on aten ops, not program variables")
        self.op_set = op_set
        self.unit_policy = unit_policy
        self.saveable_names = saveable_names
        self.token = token

    def context_fn(self, unit_decision):
        """``context_fn`` for ``torch.utils.checkpoint`` of one unit's
        decision, or None for the plain checkpoint ("full"/True: save
        nothing, recompute the whole unit)."""
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
    ``sharding_strategy`` other than ``off`` is ROADMAP A9."""

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
        self.remat_saveable_names = None       # ROADMAP A9 in the port
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
    """``CompiledProgram(program).with_data_parallel(...)`` on one device:
    ``Executor.run(compiled, ...)`` runs the program through the executor
    with the build strategy's remat policy."""

    def __init__(self, program: Program):
        self._program = program
        self._loss_name: Optional[str] = None
        self.build_strategy: Optional[BuildStrategy] = None
        self.exec_strategy: Optional[ExecutionStrategy] = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           places: Optional[Sequence] = None,
                           share_vars_from=None):
        """compiler.py:143 parity on the executor's one device; more than
        one place is ROADMAP A9."""
        if places is not None and len(places) > 1:
            raise NotImplementedError(
                f"with_data_parallel over {len(places)} places {_A9}")
        self._loss_name = loss_name
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        return self

    def with_mesh(self, mesh, data_axis: Optional[str] = "dp",
                  strategy=None, seq_axis: Optional[str] = None):
        raise NotImplementedError(f"CompiledProgram.with_mesh {_A9}")

    def _remat_spec(self) -> RematSpec:
        """Effective remat policy, resolved at each run so
        ``c.build_strategy = bs`` after with_data_parallel still takes
        effect: build_strategy.remat_policy wins, then the legacy
        boolean/set ``remat`` knob."""
        bs = self.build_strategy
        if bs is None:
            return resolve_remat()
        if int(getattr(bs, "sharding_strategy", 0) or 0) != 0:
            raise NotImplementedError(
                f"BuildStrategy.sharding_strategy="
                f"{bs.sharding_strategy} {_A9}")
        return resolve_remat(getattr(bs, "remat_policy", None),
                             getattr(bs, "remat", False),
                             getattr(bs, "remat_saveable_names", None))
