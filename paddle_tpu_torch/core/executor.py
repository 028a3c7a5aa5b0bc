"""Executor: runs a Program's global block op by op on torch tensors.

Counterpart of ``paddle_tpu.core.executor`` (reference
``framework/executor.cc`` :172 Run and the python surface
``python/paddle/fluid/executor.py:295``).

The JAX package traces the whole block into one jitted step. PyTorch runs
eagerly, so the port interprets the op list in order: each op's registered
function takes torch tensors on the run's device and returns new ones.

Training. A program that holds an `autodiff` op (``append_backward``,
``gradients``, ``Optimizer.minimize``) and is not run as a test runs its
forward with torch.autograd recording: the autodiff targets enter as leaf
tensors that require grad (parameters fresh from the scope every run),
inputs in an op's ``nondiff_inputs`` and vars flagged ``stop_gradient`` are
detached where an op reads them (requested targets excepted), and the AMP
casts of ``contrib.mixed_precision`` happen inside the graph, so cotangents
flow back through them to the f32 master weights. The `autodiff` op is
``torch.autograd.grad`` over its targets (the JAX package's reverse walk of
its vjp tape, ``_run_autodiff``); the graph is freed there, and every op
after it (the optimizer updates) runs under ``torch.no_grad()``.

Sparse gradients. An op with a ``grad_fn`` hook (``lookup_table`` built
with ``is_sparse=True``) whose table is an autodiff target does not record
its table read in the graph: it runs on detached inputs, its outputs enter
as fresh leaves, and the `autodiff` op differentiates with respect to those
leaves and hands their cotangents to the hook, which returns the table's
gradient as a ``SelectedRows`` (``core/selected_rows.py``). No
``[vocab, dim]`` gradient is built, and a packed uint16 table, which torch
cannot differentiate, still gets its rows.

Prepared plans. What the JAX package does once per compiled signature,
the port does once per plan: ``Executor.run`` keys a plan on (program,
version, feed signature, fetch names, state names) and keeps in it the
sorted persistables, the set of names some op reads, the autodiff
targets, the remat regions and the update-fusion schedule; a step that
hits the cache replays it. ``PDTPU_FUSE_UPDATES``, ``PDTPU_REMAT_OPS`` and
``PDTPU_REMAT_POLICY`` are read when a plan is prepared.

Update fusion (``PDTPU_FUSE_UPDATES`` = 1 | auto): independent sgd and
momentum updates run as one multi-tensor update (``torch._foreach_*``),
bitwise equal to the per-op path. Remat (``BuildStrategy.remat_policy``,
``PDTPU_REMAT_POLICY``, ``PDTPU_REMAT_OPS``): remat units and single ops
run under ``torch.utils.checkpoint`` with their dropout draws replayed.
``FLAGS_check_nan_inf`` checks every fetch and updated state var on the
device with one host read. ``return_handle=True`` returns a
``FetchHandle`` without a sync. Each run feeds the step profiler, the
flight recorder, the tracer and the executor's metrics
(``executor/cache_hits``, ``cache_misses``, ``compile_ms{sig=}``,
``execute_ms``, ``update_flushes``, ``fused_update_groups``,
``fused_update_ops``).

Sub-blocks. A control-flow op (``conditional_block``) runs its sub-block
through ``run_sub_block``: the ops in order, with the run's update fusion
on a sub-plan of their own (decided on the sub-block's first run and
replayed, every pending group flushed before the sub-block returns),
without the program's AMP casts (as the JAX package lowers a sub-block),
and under ``torch.no_grad()`` (the op is not differentiable). The
plan's set of names some op reads covers every block, and what a
sub-block writes to a persistable comes back through the op's outputs to
the scope.

Drivers. ``run_batched`` (a list of feed dicts) and ``train_scanned`` (a
reader through a ``DeviceLoader``, K batches a drain from ``peek_many``)
run K steps through the same prepared plan as ``run``, over views
``stacked[name][i]`` of one device-resident ``[K, ...]`` feed buffer,
with no host read between steps (with ``FLAGS_check_nan_inf`` off;
``conditional_block`` keeps its one host read a step), the fetches
stacked once at the end and one step record and flight-recorder site a
drain (``steps=K``): bitwise equal to K plain ``run`` calls. The port
does not yet make the K steps one dispatch: that is CUDA-graph capture
(ROADMAP A2 item 2). ``train_from_dataset`` feeds ``run(...,
return_handle=True)`` from a ``DeviceLoader`` and keeps
``max_inflight_steps`` steps un-synced; ``close()`` stops the loaders the
executor started.

Maintenance epilogues. A program may carry ``_epilogue_programs``, a list
of ``(every, program, meta)`` (the deferred-row fold, attached by
``Optimizer._build_deferred_fold``): every run of it (plain, through a
``CompiledProgram``, or a drain of ``n`` steps) advances a steps-since-run
counter, and the attached program runs when it reaches ``every``. The
counter lives on the scope, keyed by ``(id(program), i)``, seeded once from
the scope's count vars (the one host read, on first sight of the program,
so a restored scope resumes the cadence), and purged when the program dies
so a recycled ``id`` cannot inherit it. A drain longer than ``every`` is
refused; a drain that would overflow the log runs the epilogue first.
"""
from __future__ import annotations

import collections
import copy
import os
import time
import weakref
import zlib
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch
import torch.utils.checkpoint as torch_checkpoint

from . import registry
from .compiler import CompiledProgram, resolve_remat, saving_named
from .dtypes import dtype_str, from_numpy, to_device, to_numpy
from .program import (REMAT_UNIT_ATTR, Block, Program, Variable,
                      default_main_program, grad_var_name)
from .scope import Scope, _scope
from ..dataio.handle import FetchHandle
from ..faults import fault_point
from ..flags import flag
from ..observability.flight import (get_flight_recorder,
                                    register_dump_section)
from ..observability import perf as _perf
from ..observability.memory import record_state_memory
from ..observability.registry import get_registry
from ..observability.steps import get_step_profiler
from ..observability.tracer import trace_span
from ..observability.watchdog import get_watchdog

_RNG_STATE = "@RNG_STATE@"

# Executor telemetry lives in the process-wide registry; handles are
# module-level, so the hot path takes no registry lock per step.
_OBS = get_registry()
_CACHE_HITS = _OBS.counter("executor/cache_hits")
_CACHE_MISSES = _OBS.counter("executor/cache_misses")
_EXECUTE_MS = _OBS.histogram("executor/execute_ms")
_UPDATE_FLUSHES = _OBS.counter("executor/update_flushes")
_FUSED_GROUPS = _OBS.counter("executor/fused_update_groups")
_FUSED_OPS = _OBS.counter("executor/fused_update_ops")
_INFLIGHT = _OBS.gauge("executor/inflight_steps")
_WATCHDOG = get_watchdog()
_STEPS = get_step_profiler()
_FLIGHT = get_flight_recorder()

# live executors, so the flight recorder can dump which plans were
# resident when a run died (weak: a collected executor's cache should not
# appear in forensics)
_LIVE_EXECUTORS: "weakref.WeakSet" = weakref.WeakSet()


def _purge_pending(pend: dict, pid: int) -> None:
    """Drop a dead program's epilogue counters: id() values recycle after
    GC, so a stale (id, i) key would hand a new program an inherited
    steps-since-fold count (worst case the fold fires off-cadence and the
    append log overwrites its tail)."""
    for k in [k for k in pend if k[0] == pid]:
        pend.pop(k, None)


class Place:
    """Device tag (reference place.h CPUPlace/CUDAPlace variant)."""

    def __init__(self, kind: str, device_id: int = 0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f"{self.kind.upper()}Place({self.device_id})"

    def __eq__(self, other):
        return isinstance(other, Place) and (self.kind, self.device_id) == (
            other.kind, other.device_id)

    def torch_device(self) -> torch.device:
        if self.kind == "cpu":
            return torch.device("cpu")
        return cuda_device(self.device_id, hint="pass CPUPlace() to run on "
                           "the CPU")


def CPUPlace():
    return Place("cpu")


def CUDAPlace(device_id: int = 0):
    return Place("cuda", device_id)


def cuda_device(device_id: int = 0, hint: str = "") -> torch.device:
    """The CUDA device the port runs on, or a RuntimeError when there is
    none — a GPU request never carries on quietly on the CPU. The TF32
    switches are ``FLAGS_matmul_precision``'s alone (``flags.py``; its
    default keeps TF32 off, so float32 results keep parity with the CPU
    and the JAX package)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"a CUDA device was requested but torch sees none; "
                           f"{hint}")
    if device_id >= torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {device_id} requested, "
                           f"{torch.cuda.device_count()} present; {hint}")
    return torch.device("cuda", device_id)


class ExecContext:
    """Per-run context handed to op implementations.

    `amp` is the program's mixed-precision config ({'dtype', 'white_list',
    'black_list'}) or None. `needed` is the set of var names some op reads
    or the caller fetches (None = everything is needed); `wants(slot)` tells
    the running op whether an optional output is read at all."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None,
                 is_test: bool = False, amp=None, needed=None):
        self.device = torch.device(device or "cpu")
        self._gen = generator
        self.is_test = is_test
        self.amp = amp
        self.needed = needed
        self.training = False  # autograd records the forward
        self.targets: Set[str] = set()  # names the autodiff op reads grads of
        self.out_names: Dict[str, List[str]] = {}  # outputs of the running op
        # (op, its detached inputs, its output leaves by slot, grad hook)
        # of each sparse-gradient op this run (see _run_sparse_site)
        self.sparse_sites: List[tuple] = []
        self.plan: Optional["_Plan"] = None  # the run's prepared plan
        # the data-parallel step (core/mesh_step.py) of a mesh run, the
        # running op's input names (what `mesh_step.batch_group` reads) and
        # its inputs' slices on the model axis (`mesh_step.tp_shard`)
        self.mesh = None
        self.in_names: Dict[str, List[str]] = {}
        self.tp_in = None

    def rng(self) -> torch.Generator:
        """The run's seeded generator; each draw advances it."""
        if self._gen is None:
            self._gen = torch.Generator(self.device).manual_seed(0)
        return self._gen

    def wants(self, slot: str) -> bool:
        """Whether an output of the running op's `slot` is read later."""
        return self.needed is None or any(
            n in self.needed for n in self.out_names.get(slot, []))


def convert_feed_value(block, name: str, val, device) -> torch.Tensor:
    """Convert one feed to a tensor on `device` with feed-time validation:
    clear errors for unconvertible values and declared-shape mismatches."""
    var = block._find_var_recursive(name)
    dtype = var.dtype if var is not None else None
    try:
        if isinstance(val, torch.Tensor):
            t = val.to(device=device, dtype=dtype)
        else:
            t = from_numpy(np.asarray(val), device=device, dtype=dtype)
    except (TypeError, ValueError) as e:
        raise type(e)(
            f"feed {name!r}: cannot convert value of type "
            f"{type(val).__name__} to a "
            f"{dtype_str(dtype) if dtype is not None else 'device'} array "
            f"({e})") from e
    want = getattr(var, "shape", None)
    if want and len(want) == t.ndim:
        for axis, (w, got) in enumerate(zip(want, t.shape)):
            if w not in (-1, None) and w != got:
                raise ValueError(
                    f"feed {name!r}: shape mismatch at dim {axis}: "
                    f"program declares {tuple(want)}, got {tuple(t.shape)}")
    elif want and getattr(var, "is_data", False) and len(want) != t.ndim:
        raise ValueError(
            f"feed {name!r}: rank mismatch: program declares "
            f"{tuple(want)} ({len(want)}-d), got {tuple(t.shape)} "
            f"({t.ndim}-d)")
    return t


def _amp_cast(vals_by_slot, op_type, amp):
    """AMP cast insertion at run time (the reference's cast-op graph pass,
    contrib/mixed_precision/fp16_utils.py, as the JAX package's _amp_cast
    does it): white-list ops take their float inputs in the low-precision
    dtype, black-list ops in f32. In training the casts are part of the
    autograd graph, so the cotangents are cast back on the way."""
    if amp is None:
        return vals_by_slot
    if op_type in amp["white_list"]:
        dt = torch.bfloat16 if amp["dtype"] == "bfloat16" else torch.float16
    elif op_type in amp["black_list"]:
        dt = torch.float32
    else:
        return vals_by_slot

    def cast(v):
        return v.to(dt) if v.is_floating_point() and v.dtype != dt else v

    return {s: [cast(v) for v in vs] for s, vs in vals_by_slot.items()}


def _stops_gradient(block: Block, name: str, ctx: ExecContext) -> bool:
    # explicitly requested targets always receive grads (calc_gradient
    # semantics) even if flagged stop_gradient (e.g. data vars)
    if name in ctx.targets:
        return False
    v = block._find_var_recursive(name)
    return bool(v is not None and v.stop_gradient)


def _sparse_hook(op, opdef, ctx: ExecContext):
    """The op's hand-written gradient when it applies this run: training,
    the op has a ``grad_fn`` that accepts these attrs, and one of its
    inputs is an autodiff target."""
    if not ctx.training or opdef.grad_fn is None:
        return None
    if not any(n in ctx.targets for n in op.input_names()):
        return None
    return opdef.grad_fn(op.attrs)


def _store_outputs(op, out, env):
    for slot in sorted(op.outputs):
        vals = out.get(slot, [])
        names = op.outputs[slot]
        if len(names) != len(vals):
            raise RuntimeError(
                f"op {op.type}: slot {slot} returned {len(vals)} values, "
                f"declared {len(names)}")
        for n, v in zip(names, vals):
            if v is not None:  # an optional output nothing reads (ctx.wants)
                env[n] = v


def _run_sparse_site(op, opdef, hook, in_vals, env, ctx: ExecContext):
    """Run an op whose gradient is hand-written (the JAX package's
    ``opdef.grad_fn`` path): no graph through its inputs; its float outputs
    become leaves that the autodiff op differentiates, and the hook turns
    their cotangents into the inputs' gradients."""
    ins = {s: [v.detach() for v in vs] for s, vs in in_vals.items()}
    ctx.out_names = op.outputs
    with torch.no_grad():
        out = opdef.fn(ctx, _amp_cast(ins, op.type, ctx.amp), op.attrs)
    leaves = {s: [v.detach().requires_grad_() if v is not None
                  and v.is_floating_point() else v for v in vs]
              for s, vs in out.items()}
    ctx.sparse_sites.append((op, ins, leaves, hook))
    _store_outputs(op, leaves, env)


def _run_op(op, env: Dict[str, torch.Tensor], ctx: ExecContext):
    mesh = ctx.mesh
    if mesh is None:
        _run_op_local(op, env, ctx)
        return
    if mesh.skip(op):  # another pipeline stage's update
        return
    mesh.before_op(op, env, ctx)
    try:
        _run_op_local(op, env, ctx)
    except BaseException:
        mesh.restore(op, env, ctx)
        raise
    mesh.after_op(op, env, ctx)


def _run_op_local(op, env: Dict[str, torch.Tensor], ctx: ExecContext):
    opdef = registry.get_op(op.type)
    in_vals = {slot: [env[n] for n in names]
               for slot, names in op.inputs.items()}
    hook = _sparse_hook(op, opdef, ctx)
    if hook is not None:
        _run_sparse_site(op, opdef, hook, in_vals, env, ctx)
        return
    if ctx.training and opdef.differentiable:
        for slot, names in op.inputs.items():
            nondiff = slot in opdef.nondiff_inputs
            in_vals[slot] = [
                v.detach() if v.requires_grad and (
                    nondiff or _stops_gradient(op.block, n, ctx)) else v
                for n, v in zip(names, in_vals[slot])]
    in_vals = _amp_cast(in_vals, op.type, ctx.amp)
    ctx.out_names = op.outputs
    if opdef.differentiable:
        out = opdef.fn(ctx, in_vals, op.attrs)
    else:
        with torch.no_grad():
            out = opdef.fn(ctx, in_vals, op.attrs)
    for slot in sorted(op.outputs):
        vals = out.get(slot, [])
        names = op.outputs[slot]
        if len(names) != len(vals):
            raise RuntimeError(
                f"op {op.type}: slot {slot} returned {len(vals)} values, "
                f"declared {len(names)}")
        for n, v in zip(names, vals):
            if v is None:  # an optional output nothing reads (ctx.wants)
                continue
            if ctx.training and n in ctx.targets and not v.requires_grad \
                    and v.is_floating_point():
                # a requested intermediate the graph does not reach yet:
                # make it a leaf so the autodiff op can differentiate w.r.t. it
                v = v.detach().requires_grad_()
            env[n] = v


def _conform_seed(seed: torch.Tensor, target: torch.Tensor, name: str):
    """A target_gradient seed reshaped or broadcast to its target (e.g. a
    [1] seed for a scalar target), as the JAX package conforms it."""
    if seed.shape == target.shape:
        return seed
    if seed.numel() == target.numel():
        return seed.reshape(target.shape)
    if seed.numel() == 1:
        return seed.reshape(()).expand(target.shape)
    raise ValueError(f"target_gradient for {name!r} has shape "
                     f"{tuple(seed.shape)}, target has {tuple(target.shape)}")


def _run_autodiff(op, env: Dict[str, torch.Tensor], ctx: ExecContext):
    """The `autodiff` op: torch.autograd.grad of the loss (or of several
    seeded targets, the `gradients` form) with respect to `targets`, written
    to `<target>@GRAD`. A target the loss does not reach gets zeros. The
    graph is freed (no retain_graph)."""
    targets: Sequence[str] = op.attrs["targets"]
    seeds: Dict[str, torch.Tensor] = {}
    if "loss_names" in op.attrs:  # calc_gradient: one seed per target
        init_names = op.attrs.get("init_grad_names") or [None] * len(
            op.attrs["loss_names"])
        for ln, ig in zip(op.attrs["loss_names"], init_names):
            seed = (torch.ones_like(env[ln]) if ig is None
                    else _conform_seed(env[ig], env[ln], ln))
            seeds[ln] = seeds[ln] + seed if ln in seeds else seed
    else:
        ln = op.attrs["loss_name"]
        init_name = op.attrs.get("init_grad_name")
        seeds[ln] = (env[init_name] if init_name is not None
                     else torch.ones_like(env[ln]))
    if ctx.mesh is not None:
        seeds = {n: s * ctx.mesh.seed_scale(n) for n, s in seeds.items()}
    outs = [n for n in seeds if env[n].requires_grad]
    wrt = [t for t in dict.fromkeys(targets) if env[t].requires_grad]
    leaves = [v for _, _, lv, _ in ctx.sparse_sites
              for vs in lv.values() for v in vs
              if v is not None and v.requires_grad]
    grads, leaf_grads = {}, {}
    if outs and (wrt or leaves):
        got = torch.autograd.grad(
            [env[n] for n in outs],
            [env[t] for t in wrt] + leaves,
            grad_outputs=[seeds[n].to(env[n].dtype) for n in outs],
            allow_unused=True)
        grads = {t: g for t, g in zip(wrt, got) if g is not None}
        leaf_grads = {id(v): g for v, g in zip(leaves, got[len(wrt):])}
    sparse = _sparse_grads(ctx, leaf_grads, set(targets))
    for t in targets:
        g, s = grads.get(t), sparse.get(t)
        if s is not None:
            g = s if g is None else s + g
        env[grad_var_name(t)] = (torch.zeros_like(env[t]).detach()
                                 if g is None else g)
    if ctx.mesh is not None:
        ctx.mesh.reduce_grads(env, targets, ctx)


def _sparse_grads(ctx: ExecContext, leaf_grads, targets) -> Dict[str, object]:
    """Each sparse site's hook applied to its outputs' cotangents (zeros
    where the loss does not reach an output); the targets' gradients
    summed over sites."""
    out: Dict[str, object] = {}
    for op, ins, leaves, hook in ctx.sparse_sites:
        cots = {s: [None if v is None else (
            leaf_grads.get(id(v)) if leaf_grads.get(id(v)) is not None
            else torch.zeros_like(v)) for v in vs]
            for s, vs in leaves.items()}
        got = hook(ctx, ins, op.attrs, leaves, cots)
        for slot, names in op.inputs.items():
            for n, g in zip(names, got.get(slot) or []):
                if g is not None and n in targets:
                    out[n] = g if n not in out else out[n] + g
    return out


def _autodiff_targets(block: Block) -> Set[str]:
    names: Set[str] = set()
    for op in block.ops:
        if op.type == "autodiff":
            names.update(op.attrs["targets"])
    return names


# -- update-group fusion -----------------------------------------------------
# Horizontally fusable parameter updates: N independent per-parameter sgd or
# momentum ops run as ONE update over tensor lists (torch._foreach_*, the
# list forms in ops/optimizer_ops.py), a few multi-tensor kernels instead of
# N times each op's elementwise kernels and N op dispatches. This is the JAX
# package's update-group fusion (there: concatenated flats under jit), kept
# for runtimes where launch latency dominates, which the eager port is.
# Reference analog: coalesce_tensor_op.cc + the fused_all_reduce idea
# applied to the optimizer.
_FUSABLE_UPDATES = {
    "sgd": {"flat_in": ("Param", "Grad"), "flat_out": ("ParamOut",)},
    "momentum": {"flat_in": ("Param", "Grad", "Velocity"),
                 "flat_out": ("ParamOut", "VelocityOut")},
    # adam/adamw are deliberately NOT fusable: their Beta*Pow accumulators
    # are per-parameter state — running a group on ops[0]'s pows would
    # corrupt any accumulator not in lockstep (e.g. a param added by a
    # later minimize() call).
}

# "auto" fuses only parameters this small (the JAX package's threshold)
_FUSE_SMALL_MAX_ELEMS = 65536


def _fuse_updates_mode() -> str:
    v = os.environ.get("PDTPU_FUSE_UPDATES", "0")
    return {"0": "off", "1": "all"}.get(v, v)


def _attrs_sig(attrs):
    """Fusion-group attr signature. Any non-scalar attr (list/array) makes
    the op not fusable (None): silently dropping it from the key would let
    two ops differing only in that attr fuse and run with ops[0]'s attrs."""
    sig = []
    for k, v in attrs.items():
        if not isinstance(v, (int, float, bool, str)):
            return None
        sig.append((k, v))
    return tuple(sorted(sig))


def _group_key(op, env, mode):
    """Fusion-compatibility key; None = not fusable: a SelectedRows grad,
    a non-scalar attr, a large parameter in "auto" mode, or (a port rule:
    the list kernels take one dtype) inputs of mixed dtypes."""
    spec = _FUSABLE_UPDATES[op.type]
    sig = _attrs_sig(op.attrs)
    if sig is None:
        return None
    dts = set()
    for slot in spec["flat_in"]:
        if slot not in op.inputs or len(op.inputs[slot]) != 1:
            return None
        v = env.get(op.inputs[slot][0])
        if not isinstance(v, torch.Tensor):
            return None  # SelectedRows takes the per-op path
        dts.add(v.dtype)
    if len(dts) != 1:
        return None
    if mode == "auto" and env[op.inputs["Param"][0]].numel() \
            > _FUSE_SMALL_MAX_ELEMS:
        return None
    lr = tuple(op.inputs.get("LearningRate", ()))
    return (op.type, sig, lr, str(dts.pop()))


def _run_update_group(ops, env):
    from ..ops import optimizer_ops

    spec = _FUSABLE_UPDATES[ops[0].type]
    vals = [[env[op.inputs[slot][0]] for op in ops]
            for slot in spec["flat_in"]]
    lr = env[ops[0].inputs["LearningRate"][0]].reshape(())
    if ops[0].type == "sgd":
        out = optimizer_ops.sgd_list(*vals, lr)
    else:
        out = optimizer_ops.momentum_list(*vals, lr, ops[0].attrs)
    for slot in spec["flat_out"]:
        for op, v in zip(ops, out[slot]):
            env[op.outputs[slot][0]] = v


# -- remat -------------------------------------------------------------------
def _remat_eligible(op) -> bool:
    """Can `op` run inside a checkpointed region? Members must be plainly
    differentiable: custom-grad ops (sparse cotangents), non-differentiable
    ops (grads must stay cut), control flow (nested blocks) and the
    update/autodiff ops keep their per-op path. No registered op that
    passes this writes an input in place (a recompute would write twice):
    the batch-norm ops return their running statistics as new tensors."""
    if op.type == "autodiff" or op.type in _FUSABLE_UPDATES:
        return False
    if not registry.has_op(op.type):
        return False
    opdef = registry.get_op(op.type)
    if opdef.grad_fn is not None or not opdef.differentiable:
        return False
    return not any(isinstance(v, Block) for v in op.attrs.values())


class _Region:
    """One checkpointed region of the forward: a remat unit's consecutive
    ops, or one op of ``RematSpec.op_set``. `reads` are its entry values,
    `outs` the values it hands on (read after it, fetched, persistable or
    an autodiff target: the rest die with the region), `nondiff` the
    entries every member reads through a non-differentiable slot."""

    __slots__ = ("ops", "decision", "reads", "outs", "nondiff")

    def __init__(self, ops, decision, live_after):
        self.ops = ops
        self.decision = decision
        reads, writes = [], []
        for op in ops:
            for slot in sorted(op.inputs):
                for n in op.inputs[slot]:
                    if n not in writes and n not in reads:
                        reads.append(n)
            for slot in sorted(op.outputs):
                for n in op.outputs[slot]:
                    if n not in writes:
                        writes.append(n)
        self.reads = reads
        self.outs = [n for n in writes if n in live_after]
        # an input is non-differentiable for the REGION only if every use
        # of it inside is through a nondiff slot (JAX _run_remat_group)
        used_diff, used_nondiff = set(), set()
        for op in ops:
            nd = registry.get_op(op.type).nondiff_inputs
            for slot, names in op.inputs.items():
                (used_nondiff if slot in nd else used_diff).update(names)
        self.nondiff = (used_nondiff - used_diff) & set(reads)


def _plan_remat_items(block: Block, spec, training: bool, fetch_names,
                      persistables):
    """Partition block.ops into ("op", op) singles and ("region", _Region)
    items: maximal runs of consecutive ops sharing a `__remat_unit__` tag
    whose unit decision (RematSpec.unit_policy) is truthy, and single ops
    of RematSpec.op_set outside units. Regions are planned only in the
    forward of a training step (before the autodiff op); otherwise, and
    with no policy, every op is a single."""
    ops = list(block.ops)
    first_ad = next((i for i, op in enumerate(ops) if op.type == "autodiff"),
                    None)
    if (not training or first_ad is None or spec is None
            or (spec.unit_policy is None and not spec.op_set)):
        return [("op", op) for op in ops]
    # what each op position hands on: names read at or after it, fetched,
    # persistable, or differentiated by the autodiff op
    tail = set(fetch_names) | set(persistables)
    for op in ops:
        if op.type == "autodiff":
            tail.update(op.attrs["targets"])
    live = [None] * (len(ops) + 1)
    live[len(ops)] = frozenset(tail)
    acc = set(tail)
    for i in range(len(ops) - 1, -1, -1):
        acc.update(ops[i].input_names())
        live[i] = frozenset(acc)
    op_set = spec.op_set
    pred = spec.unit_policy
    decisions: Dict[str, object] = {}
    items: List[tuple] = []
    cur_unit, cur_dec, cur_start = None, None, 0

    def flush(end):
        nonlocal cur_unit
        if cur_unit is not None:
            items.append(("region", _Region(ops[cur_start:end], cur_dec,
                                            live[end])))
        cur_unit = None

    for i, op in enumerate(ops):
        dec = None
        eligible = i < first_ad and _remat_eligible(op)
        unit = op.attrs.get(REMAT_UNIT_ATTR) if pred is not None else None
        if eligible and unit is not None:
            if unit not in decisions:
                try:
                    decisions[unit] = pred(unit)
                except Exception:
                    decisions[unit] = False
            dec = decisions[unit]
            if not dec or dec == "none":
                dec = None
        if dec is not None and unit == cur_unit:
            continue
        flush(i)
        if dec is not None:
            cur_unit, cur_dec, cur_start = unit, dec, i
        elif eligible and (op_set is True or (op_set and op.type in op_set)):
            items.append(("region", _Region([op], "full", live[i + 1])))
        else:
            items.append(("op", op))
    flush(len(ops))
    return items


def _run_region(region: _Region, env, ctx: ExecContext, spec):
    """Run a region as one non-reentrant ``torch.utils.checkpoint``: its
    forward now, its saved activations dropped and recomputed in the
    backward (under "minimal", the selective policy keeps the matmul
    outputs). The region's random state is taken once, here, outside the
    checkpointed function: the function sets a generator of its own to
    that state on every call, so the first forward and the recompute draw
    the same dropout masks and flash Philox seeds (torch's
    ``preserve_rng_state`` restores only the default generators, and the
    port's ops draw from the run's generator). The run's generator then
    continues where the region's draws ended, so a step draws the same
    numbers with and without remat. Generator states live on the host:
    no device sync."""
    gen = ctx.rng()
    start = gen.get_state()
    sub_gen = torch.Generator(ctx.device)
    sub = copy.copy(ctx)
    sub._gen = sub_gen

    named = frozenset(spec.saveable_names or ()) if len(region.ops) > 1 \
        else frozenset()

    def fn(*vals):
        sub_gen.set_state(start)
        local = dict(zip(region.reads, vals))
        for op in region.ops:
            if named.intersection(op.output_names()):
                # save_only_these_names: this op's results are kept
                with saving_named():
                    _run_op(op, local, sub)
            else:
                _run_op(op, local, sub)
        return tuple(local.get(n) for n in region.outs)

    vals = [env[n].detach() if n in region.nondiff
            and isinstance(env[n], torch.Tensor) else env[n]
            for n in region.reads]
    kw = {}
    context_fn = spec.context_fn(region.decision, bool(named))
    if context_fn is not None:
        kw["context_fn"] = context_fn
    outs = torch_checkpoint.checkpoint(fn, *vals, use_reentrant=False, **kw)
    gen.set_state(sub_gen.get_state())
    for n, v in zip(region.outs, outs):
        if v is not None:
            env[n] = v


# -- the block ---------------------------------------------------------------
def _run_item(kind, payload, env, ctx: ExecContext, plan):
    if kind == "op":
        if payload.type == "autodiff":
            _run_autodiff(payload, env, ctx)
            # the update ops that follow record no graph
            torch.set_grad_enabled(False)
        else:
            _run_op(payload, env, ctx)
    elif kind == "region":
        if ctx.mesh is not None and ctx.mesh.fsdp:
            ctx.mesh.gather_params(payload.reads, env, ctx)
        _run_region(payload, env, ctx, plan.spec)
    elif ctx.mesh is None:  # "fused"
        _run_update_group(payload, env)
    else:
        payload = [op for op in payload if not ctx.mesh.skip(op)]
        for op in payload:
            ctx.mesh.before_op(op, env, ctx)
        if payload:
            _run_update_group(payload, env)
        for op in payload:
            ctx.mesh.after_op(op, env, ctx)


def eval_inference_block(program, env: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Run `program`'s global block eagerly in test mode over `env` (merged
    state + feeds, on one device), mutating and returning it: every
    intermediate var stays visible in `env` afterwards. The observation
    path (int8 calibration reads activation ranges out of it); serving
    goes through the Predictor."""
    device = next((v.device for v in env.values()
                   if isinstance(v, torch.Tensor)), None)
    _run_block(program.global_block(), env,
               ExecContext(device, is_test=True))
    return env


def _run_block(block: Block, env: Dict[str, torch.Tensor], ctx: ExecContext,
               plan: Optional["_Plan"] = None):
    """Run `block`'s ops over `env`. With no plan (the Predictor, the IR
    passes) every op runs in order and nothing is planned. A training
    step's plan brings its remat regions and, with PDTPU_FUSE_UPDATES on,
    its update groups: the groups are decided on the plan's first run
    (they depend on the gradients' kinds) and that schedule is replayed
    after."""
    if plan is None:
        for op in block.ops:
            _run_item("op", op, env, ctx, None)
        return
    if plan.schedule is not None:
        for kind, payload in plan.schedule:
            _run_item(kind, payload, env, ctx, plan)
        return
    schedule: List[tuple] = []

    def run(kind, payload):
        schedule.append((kind, payload))
        _run_item(kind, payload, env, ctx, plan)

    mode = plan.fuse_mode
    pending: List = []          # fusable update ops awaiting flush
    pending_in: set = set()
    pending_out: set = set()

    def flush():
        if not pending:
            return
        # counted while the schedule is decided (once per plan, as the JAX
        # package counts once per compiled signature): how many flush
        # points the step hit and how many update ops fused
        _UPDATE_FLUSHES.inc()
        groups: Dict[object, List] = {}
        singles: List = []
        for p in pending:
            key = _group_key(p, env, mode)
            if key is None:
                singles.append(p)
            else:
                groups.setdefault(key, []).append(p)
        for ops_ in groups.values():
            if len(ops_) == 1:
                singles.append(ops_[0])
            else:
                _FUSED_GROUPS.inc()
                _FUSED_OPS.inc(len(ops_))
                run("fused", ops_)
        for p in singles:
            run("op", p)
        pending.clear()
        pending_in.clear()
        pending_out.clear()

    for kind, entry in plan.items:
        if mode == "off" or kind == "region":
            # regions are forward code; any pending updates complete first
            flush()
            run(kind, entry)
            continue
        op = entry
        names_in = set(op.input_names())
        names_out = set(op.output_names())
        if op.type in _FUSABLE_UPDATES:
            # a fusable op that depends on (or clobbers) a pending op's
            # output must not join its group — flush so updates on the same
            # parameter stay ordered
            if names_in & pending_out or names_out & (pending_in
                                                      | pending_out):
                flush()
            pending.append(op)
            pending_in.update(names_in)
            pending_out.update(names_out)
            continue
        if (op.type == "autodiff" or names_in & pending_out
                or names_out & (pending_in | pending_out)):
            flush()
        run("op", op)
    flush()
    plan.schedule = schedule


class _SubPlan:
    """A sub-block's schedule inside a run's plan (``_run_block`` reads its
    items, fusion mode and schedule; a sub-block holds no remat region)."""

    __slots__ = ("items", "fuse_mode", "schedule")

    def __init__(self, block: Block, fuse_mode: str):
        self.items = [("op", op) for op in block.ops]
        self.fuse_mode = fuse_mode
        self.schedule = None


def run_sub_block(block: Block, env: Dict[str, torch.Tensor],
                  ctx: ExecContext):
    """Run a control-flow op's sub-block over `env` (its carried values):
    the ops in order with the run's update fusion, on a sub-plan kept in
    the run's plan, and without the program's AMP casts."""
    sub = copy.copy(ctx)
    sub.amp = None
    plan = ctx.plan
    if plan is None:
        _run_block(block, env, sub)
        return
    sp = plan.sub_plans.get(block.idx)
    if sp is None:
        sp = plan.sub_plans[block.idx] = _SubPlan(block, plan.fuse_mode)
    _run_block(block, env, sub, sp)


# -- FLAGS_check_nan_inf ------------------------------------------------------
def _check_finite(named_vals) -> None:
    """FLAGS_check_nan_inf parity (operator.cc:949) without a host copy of
    every state var: each floating tensor's max |x| (``_foreach_norm`` with
    ord=inf, a few multi-tensor kernels, NaN-propagating) feeds one
    all-finite scalar on the device, and only that scalar crosses to the
    host. Names and values are read only when it trips."""
    floats = [(n, v) for n, v in named_vals
              if isinstance(v, torch.Tensor) and v.is_floating_point()
              and v.numel()]
    if not floats:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for _, v in floats:
        by_dtype.setdefault(v.dtype, []).append(v.detach())
    maxes = [torch.stack(torch._foreach_norm(vs, ord=float("inf"))).float()
             for vs in by_dtype.values()]
    if bool(torch.isfinite(torch.cat(maxes)).all()):
        return
    for n, v in floats:  # slow path: find and name the offender(s)
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in variable {n!r} "
                f"(FLAGS_check_nan_inf is on)")
    raise FloatingPointError(
        "NaN/Inf detected (FLAGS_check_nan_inf is on) but no single "
        "variable reproduced it on host readback")


# -- the prepared plan ---------------------------------------------------------
def _sig_digest(feed_sig) -> str:
    """Short stable label for a feed signature (crc32 of its repr, NOT
    hash(): str hashing is salted per process), so prepare-time
    histograms can be told apart per signature."""
    return format(zlib.crc32(repr(feed_sig).encode()) & 0xFFFFFFFF, "08x")


def feed_signature(feed_vals) -> tuple:
    """Canonical hashable (name, shape, dtype) signature of a feed dict:
    the plan-cache key ingredient."""
    return tuple(sorted((str(n), tuple(v.shape), str(v.dtype))
                        for n, v in dict(feed_vals).items()))


def _env_remat_spec():
    """PDTPU_REMAT_OPS="batch_norm,relu" (or "1": every op) — per-op
    checkpoint on the plain-Executor path; PDTPU_REMAT_POLICY="minimal"|
    "full" maps onto the policy surface (remat units included) for scripts
    without a CompiledProgram. Read when a plan is prepared."""
    remat_env = os.environ.get("PDTPU_REMAT_OPS", "")
    legacy = (True if remat_env == "1"
              else frozenset(t for t in remat_env.split(",") if t)
              if remat_env else False)
    return resolve_remat(os.environ.get("PDTPU_REMAT_POLICY") or None, legacy)


class _Plan:
    """What ``Executor.run`` prepares once per (program, version, feed
    signature, fetch names, state names) and replays every step after:
    the counterpart of the JAX package's compiled step and of the
    reference's ``executor.cc:349 Prepare``."""

    __slots__ = ("program", "persistables", "needed", "targets", "training",
                 "spec", "fuse_mode", "items", "schedule", "sub_plans")

    def __init__(self, program: Program, fetch_names, spec):
        block = program.global_block()
        self.program = weakref.ref(program)
        self.persistables = sorted({v.name for v in program.list_vars()
                                    if v.persistable})
        # what any op of any block reads: a sub-block's ops read through
        # the same context
        self.needed = set(fetch_names).union(
            n for b in program.blocks for op in b.ops
            for n in op.input_names())
        self.targets = _autodiff_targets(block)
        self.training = bool(self.targets)
        self.spec = spec if spec is not None else _env_remat_spec()
        self.fuse_mode = _fuse_updates_mode()
        self.items = _plan_remat_items(block, self.spec, self.training,
                                       fetch_names, self.persistables)
        self.schedule = None  # decided on the first run (_run_block)
        self.sub_plans: Dict[int, _SubPlan] = {}  # by sub-block index


def _fmt_cache_key(key) -> dict:
    try:
        return {"program": f"0x{key[0]:x}", "version": key[1],
                "key": repr(key[2:])[:400]}
    except Exception:
        return {"key": repr(key)[:400]}


def _compiled_signatures_section() -> list:
    out = []
    for exe in list(_LIVE_EXECUTORS):
        out.extend(_fmt_cache_key(k) for k in list(exe._cache))
    return out


register_dump_section("compiled_signatures", _compiled_signatures_section)


class Executor:
    """python/paddle/fluid/executor.py:295 parity, eager on torch.

    exe = Executor(CUDAPlace(0)); exe.run(startup); exe.run(main, feed, fetch_list)

    With no place the executor runs on CUDA device 0; ``CPUPlace()`` is the
    explicit CPU request.
    """

    def __init__(self, place: Optional[Place] = None):
        self.place = place or CUDAPlace(0)
        self.device = self.place.torch_device()
        self._cache: Dict[tuple, _Plan] = {}
        self._state_names_cache = None
        # DeviceLoaders this executor's drivers started (close() stops them)
        self._loaders: "weakref.WeakSet" = weakref.WeakSet()
        _LIVE_EXECUTORS.add(self)

    def _state_names(self, program: Program, scope: Scope) -> List[str]:
        # cached single entry, rebuilt when the program version or any
        # scope in the lookup chain changes its KEY SET (has_var walks
        # parents, so a var added to a parent scope must invalidate too; a
        # generation counter, unlike len(_vars), catches erase-one +
        # add-another). Strong refs to program + scope, so the identity
        # test cannot alias a recycled id.
        chain = []
        s = scope
        while s is not None:
            chain.append(s._keyset_gen)
            s = s.parent
        cached = self._state_names_cache
        if (cached is not None and cached[0] is program
                and cached[1] == program._version and cached[2] is scope
                and cached[3] == chain):
            return cached[4]
        names = sorted({v.name for v in program.list_vars()
                        if v.persistable and scope.has_var(v.name)})
        self._state_names_cache = (program, program._version, scope, chain,
                                   names)
        return names

    def run(
        self,
        program=None,
        feed: Optional[Dict[str, np.ndarray]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        return_handle: bool = False,
    ):
        """Run `program`: feed → execute → fetch (reference executor.py:539).
        Persistable vars are read from and written back to `scope`.

        return_handle=True returns a :class:`FetchHandle` over the fetch
        tensors without waiting for the card; `.numpy()` on it is the sync
        point, and its arrays are bitwise those of return_numpy=True.
        A :class:`CompiledProgram` runs with its build strategy's remat
        policy, and one with a mesh runs this rank's data-parallel step
        (``core/mesh_step.py``): the feed is this rank's rows, the fetches
        are global."""
        if isinstance(program, CompiledProgram):
            # chaos probe: one hit per training-step dispatch
            fault_point("exec.dispatch")
            return self._run(program._program, feed, fetch_list, scope,
                             return_numpy, return_handle,
                             spec=program._remat_spec(), probe=False,
                             mesh=self._mesh_step(program),
                             compiled=program)
        return self._run(program, feed, fetch_list, scope, return_numpy,
                         return_handle)

    def _mesh_step(self, compiled):
        """The CompiledProgram's data-parallel step on this executor's
        device, or None without a mesh (built again when the mesh, the
        stage or the program changes)."""
        if compiled._mesh is None:
            return None
        from .mesh_step import MeshStep, mesh_key

        key = (mesh_key(compiled), self.device)
        steps = compiled._mesh_steps
        step = steps.get(key)
        if step is None:
            steps.clear()
            step = steps[key] = MeshStep(compiled, self.device)
        return step

    def _run(self, program, feed, fetch_list, scope, return_numpy,
             return_handle, spec=None, probe=True, mesh=None, compiled=None):
        program = program or default_main_program()
        scope = scope or _scope()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        block = program.global_block()
        feed_vals = {name: convert_feed_value(block, name, val, self.device)
                     for name, val in (feed or {}).items()}
        state_names = self._state_names(program, scope)
        feed_sig = feed_signature(feed_vals)
        sig = _sig_digest(feed_sig)
        t0 = time.perf_counter()
        plan, compiling = self._plan(program, feed_sig, fetch_names,
                                     state_names, spec, mesh)
        if mesh is not None:
            mesh.check_feeds(feed_vals)
        with _FLIGHT.guard("Executor.run", program=f"0x{id(program):x}",
                           sig=sig, compiling=compiling), \
                trace_span("executor/compile+run" if compiling
                           else "executor/run", sig=sig):
            if probe:
                # chaos probe inside the timed region: a delay_ms fault
                # here IS a slow step, which the StepProfiler must see
                fault_point("exec.dispatch")
            # the plan's first run is counted once for the perf ledger
            with _perf.count_first_run(compiling) as counted:
                fetches, new_state = self._execute(plan, block, scope,
                                                   feed_vals, state_names,
                                                   fetch_names, mesh)
        dt_ms = (time.perf_counter() - t0) * 1e3
        if compiling:
            # the first run pays the prepare and the schedule's decisions
            _OBS.histogram("executor/compile_ms", sig=sig).observe(dt_ms)
            _perf.get_ledger().register(
                id(program), sig, counted=counted and counted.cost(),
                program=program, feed=feed_vals)
        else:
            # host time of a replayed step (the card's kernels may still
            # be running: they are launched asynchronously)
            _EXECUTE_MS.observe(dt_ms)
        _STEPS.record(dt_ms, program_id=id(program), sig=sig,
                      compiled=compiling)
        if mesh is not None and compiling:
            mesh.record_state_bytes()
        elif compiling:
            record_state_memory(new_state.values(), self.device)
        # maintenance epilogues (the deferred-row fold): every `every` runs
        # of this program, plain or through a CompiledProgram
        self._advance_epilogues(program, scope, 1, compiled)
        if flag("check_nan_inf"):
            # every fetched value and updated state var, checked on the
            # device; the host pays one scalar read unless it trips
            _check_finite(list(zip(fetch_names, fetches))
                          + list(new_state.items()))
        if return_handle:
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            return FetchHandle(fetch_names, [f.detach() for f in fetches],
                               event)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return [f.detach() for f in fetches]

    def _plan(self, program: Program, feed_sig, fetch_names, state_names,
              spec, mesh=None):
        """The prepared plan for this (program, version, feed signature,
        fetches, state names[, remat token][, mesh step]), made on a miss.
        Returns (plan, whether it was made now)."""
        key = (id(program), program._version, feed_sig, tuple(fetch_names),
               tuple(state_names), None if spec is None else spec.token,
               None if mesh is None else id(mesh))
        plan = self._cache.get(key)
        compiling = plan is None or plan.program() is not program
        if compiling:
            _CACHE_MISSES.inc()
            # a miss re-prepares the plan: count it per program and let
            # the watchdog diagnose shape-churn storms
            wkey = (id(program), program._version, tuple(fetch_names))
            if _WATCHDOG.record_compile(
                    wkey, feed_sig, label=f"Executor program 0x{id(program):x}"):
                weakref.finalize(program, _WATCHDOG.forget, wkey)
            plan = self._cache[key] = _Plan(program, fetch_names, spec)
        else:
            _CACHE_HITS.inc()
        return plan, compiling

    def _execute(self, plan: _Plan, block: Block, scope: Scope, feed_vals,
                 state_names, fetch_names, mesh=None):
        env = {}
        if mesh is None:
            from .mesh_step import logical_value

            for n in state_names:
                env[n] = to_device(logical_value(
                    block.program, n, scope.find_var(n)), self.device)
        else:
            mesh.begin()
            mesh.load_state(env, scope, state_names)
            mesh.batch.update(n for n, v in feed_vals.items() if v.ndim)
            feed_vals = mesh.place_feeds(feed_vals)
        env.update(feed_vals)
        gen = scope.find_var(_RNG_STATE)
        if gen is None or gen.device != self.device:
            gen = torch.Generator(self.device).manual_seed(
                block.program.random_seed or 0)
            scope.set_var(_RNG_STATE, gen)
        if mesh is not None:
            gen = mesh.generator(scope, gen)
        ctx = ExecContext(self.device, gen,
                          amp=getattr(block.program, "_amp", None),
                          needed=plan.needed)
        ctx.mesh = mesh
        ctx.targets = plan.targets
        ctx.training = plan.training
        ctx.plan = plan
        for n in ctx.targets:
            v = env.get(n)
            if v is not None and v.is_floating_point():
                env[n] = v.detach().requires_grad_()  # a fresh leaf each run
        with torch.set_grad_enabled(ctx.training):
            _run_block(block, env, ctx, plan)
        if mesh is not None:
            return mesh.finish(env, scope, plan.persistables, fetch_names)
        new_state = {}
        for n in plan.persistables:
            if n in env:
                new_state[n] = env[n].detach()
                scope.set_var(n, new_state[n])
        return [env[n] for n in fetch_names], new_state

    # -- multi-step drivers ------------------------------------------------
    def run_batched(self, program, feed_list,
                    fetch_list: Optional[Sequence] = None,
                    scope: Optional[Scope] = None, return_numpy: bool = True):
        """Run N training steps over N feed dicts stacked along a leading
        axis: the feeds are converted and stacked once into a device
        buffer, then the steps run through one prepared plan over its
        views with no host read between them (see `_run_scan`). Feeds must
        share keys, shapes and dtypes across the N steps. Bitwise equal to
        N plain `run` calls; not yet one device dispatch (CUDA-graph
        capture, ROADMAP A2).

        Requires every persistable the program writes to already exist in
        the scope (run the startup program first). Returns one stacked
        array (or tensor) of shape [N, ...] per fetch. Accepts a
        CompiledProgram (its build strategy's remat policy)."""
        compiled = program if isinstance(program, CompiledProgram) else None
        program, spec, mesh = self._unwrap(program)
        feed_list = list(feed_list)
        if not feed_list:
            raise ValueError("run_batched: empty feed_list")
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        scope = scope or _scope()
        block = program.global_block()
        keys0 = set(feed_list[0])
        for i, fd in enumerate(feed_list[1:], start=1):
            if set(fd) != keys0:
                extra = sorted(set(fd) - keys0)
                lacking = sorted(keys0 - set(fd))
                raise ValueError(
                    f"run_batched: feed dict at step {i} does not match "
                    f"step 0's key set"
                    + (f"; extra keys {extra}" if extra else "")
                    + (f"; missing keys {lacking}" if lacking else ""))
        stacked = {k: torch.stack([convert_feed_value(block, k, fd[k],
                                                      self.device)
                                   for fd in feed_list])
                   for k in sorted(keys0)}
        return self._run_scan(program, spec, stacked, len(feed_list),
                              fetch_names, scope, return_numpy, mesh=mesh,
                              compiled=compiled)

    def _unwrap(self, program):
        """(Program, remat spec or None, mesh step or None) of a Program or
        CompiledProgram."""
        if isinstance(program, CompiledProgram):
            return (program._program, program._remat_spec(),
                    self._mesh_step(program))
        return program or default_main_program(), None, None

    def _run_scan(self, program, spec, stacked, n, fetch_names, scope,
                  return_numpy, site="Executor.run_batched", mesh=None,
                  compiled=None):
        """Run `n` steps over pre-stacked device feeds ``{name: [n, ...]}``.

        The shared engine behind `run_batched` (host feed lists) and
        `train_scanned` (``DeviceLoader.peek_many`` buffers): every step
        goes through the plan `run` would use for one step's feeds, over
        the views ``stacked[name][i]``; the state stays in the scope on
        the device between steps and nothing is read back to the host
        (``FLAGS_check_nan_inf`` checks each step when on). The fetches
        are stacked once at the end; the profiler sees ONE record a drain
        (``steps=n``) and the flight recorder one `site`."""
        epilogues = getattr(program, "_epilogue_programs", None) or []
        for every, *_rest in epilogues:
            if n > every:
                raise ValueError(
                    f"{site}: {n} steps per dispatch exceeds the "
                    f"maintenance-epilogue interval {every} — the "
                    f"deferred-update log would overflow mid-scan")
        missing = sorted({v.name for v in program.list_vars()
                          if v.persistable and scope.find_var(v.name) is None})
        if missing:
            raise ValueError(
                f"{site} needs every persistable in scope (run the "
                f"startup program and one plain run first); missing: "
                f"{missing[:5]}")
        # a fold is a pure representation change (safe any time): run it
        # early if this drain would not fit in the log
        for i, (every, eprog, meta) in enumerate(epilogues):
            pend, key, _ = self._epilogue_pending(program, scope, i, meta)
            if pend[key] + n > every:
                self._run_epilogue(eprog, scope, compiled)
                pend[key] = 0
        state_names = self._state_names(program, scope)
        block = program.global_block()
        stacked = {k: v.to(self.device) for k, v in stacked.items()}
        step_sig = feed_signature({k: v[0] for k, v in stacked.items()})
        sig = _sig_digest(step_sig)
        t0 = time.perf_counter()
        plan, compiling = self._plan(program, step_sig, fetch_names,
                                     state_names, spec, mesh)
        if mesh is not None:
            mesh.check_feeds({k: v[0] for k, v in stacked.items()})
        check = flag("check_nan_inf")
        counted = None
        per_step: List[List[torch.Tensor]] = []
        with _FLIGHT.guard(site, program=f"0x{id(program):x}", sig=sig,
                           steps=n, compiling=compiling), \
                trace_span(site.replace("Executor.", "executor/"), steps=n,
                           sig=sig):
            for i in range(n):
                # the plan's first run: its first step is counted once, the
                # ledger entry covers all n
                with _perf.count_first_run(compiling and i == 0) as c:
                    fetches, new_state = self._execute(
                        plan, block, scope,
                        {k: v[i] for k, v in stacked.items()},
                        state_names, fetch_names, mesh)
                if c is not None:
                    counted = c.cost()
                if check:
                    _check_finite(list(zip(fetch_names, fetches))
                                  + list(new_state.items()))
                per_step.append([f.detach() for f in fetches])
        ys = [torch.stack([step[j] for step in per_step])
              for j in range(len(fetch_names))]
        dt_ms = (time.perf_counter() - t0) * 1e3
        if compiling:
            _OBS.histogram("executor/compile_ms", sig=sig).observe(dt_ms)
            if counted:
                counted = dict(counted, flops=counted["flops"] * n,
                               bytes_accessed=counted["bytes_accessed"] * n)
            _perf.get_ledger().register(
                id(program), sig, counted=counted, program=program,
                feed={k: v[0] for k, v in stacked.items()}, steps=n)
        else:
            _EXECUTE_MS.observe(dt_ms)
        _STEPS.record(dt_ms, program_id=id(program), sig=sig,
                      compiled=compiling, steps=n)
        if mesh is not None and compiling:
            mesh.record_state_bytes()
        self._advance_epilogues(program, scope, n, compiled)
        if return_numpy:
            return [to_numpy(y) for y in ys]
        return ys

    # -- maintenance epilogues ---------------------------------------------
    def _epilogue_pending(self, program, scope, i, meta):
        """Steps since epilogue i of `program` last ran against `scope`:
        (the scope's counter dict, this counter's key, whether it was made
        now). Kept on the scope (the deferred log's count lives there: one
        program driven against two scopes must not share a counter) and
        seeded on first sight from the scope's count vars, the one host
        read, so a restored scope resumes the cadence."""
        pend = getattr(scope, "_epilogue_pending", None)
        if pend is None:
            pend = scope._epilogue_pending = {}
        key = (id(program), i)
        fresh = key not in pend
        if fresh:
            seed = 0
            r = int((meta or {}).get("rows_per_step", 0))
            for nm in (meta or {}).get("count_vars", []):
                v = scope.find_var(nm)
                if v is not None and r > 0:
                    seed = max(seed, int(v.reshape(-1)[0]) // r)
            pend[key] = seed
            # id(program) recycles after GC: purge this program's counters
            # when it dies, so a new program at its address starts at 0
            weakref.finalize(program, _purge_pending, pend, id(program))
        return pend, key, fresh

    def _run_epilogue(self, eprog, scope, compiled=None):
        """The epilogue is a plain run of its program on one device; under
        a CompiledProgram with a mesh it runs through the same mesh, data
        axis and ZeRO stage (its CompiledProgram cached on `compiled`), as
        the JAX package's ``_run_epilogue`` does, so every rank folds the
        same log into its copy of the table."""
        if compiled is None or compiled._mesh is None:
            self.run(eprog, scope=scope, return_numpy=False)
            return
        cache = compiled._epilogue_compiled
        ecp = cache.get(id(eprog))
        if ecp is None or ecp._program is not eprog:
            ecp = cache[id(eprog)] = CompiledProgram(eprog).with_mesh(
                compiled._mesh, data_axis=compiled._data_axis)
        ecp.build_strategy.sharding_strategy = compiled._zero_stage()
        self.run(ecp, scope=scope, return_numpy=False)

    def _advance_epilogues(self, program, scope, steps: int, compiled=None):
        """Count `steps` more runs of `program`; run each epilogue that
        reaches its interval. The count mirrors the deferred log's `count`
        state: both reset when the fold runs."""
        epilogues = getattr(program, "_epilogue_programs", None)
        if not epilogues:
            return
        for i, (every, eprog, meta) in enumerate(epilogues):
            pend, key, fresh = self._epilogue_pending(program, scope, i,
                                                      meta)
            if not fresh:
                # a fresh seed read the count AFTER this run's append: it
                # already includes these steps
                pend[key] += steps
            if pend[key] >= every:
                self._run_epilogue(eprog, scope, compiled)
                pend[key] = 0

    def train_scanned(self, program=None, reader=None, scan_steps: int = 16,
                      fetch_list=None, scope=None, capacity=None):
        """Training driver over K-step drains: the host's only jobs are
        feeding batches through a `DeviceLoader` on this executor's place
        (pinned memory, a side stream) into a device-resident K-step feed
        buffer via `peek_many`, and reading the fetches once a drain. The
        K steps run through `_run_scan` (bitwise equal to K plain runs;
        one step record and one ``Executor.train_scanned`` flight site a
        drain, ``steps=K``). They are not yet one device dispatch (CUDA
        graphs, ROADMAP A2).

        reader: callable returning an iterable of feed dicts, or a plain
          iterable (one epoch). Feeds must share shapes/dtypes.
        scan_steps: K, the steps a drain (>= 1). A short final drain
          (epoch length not divisible by K) runs the remaining steps.
        capacity: DeviceLoader queue depth (default max(2, K)).

        Requires every persistable in scope (run the startup program
        first). Returns a list of per-fetch np arrays of shape
        [num_steps, ...] (all drains concatenated), or the step count when
        `fetch_list` is empty."""
        from ..dataio.loader import DeviceLoader

        compiled = program if isinstance(program, CompiledProgram) else None
        program, spec, mesh = self._unwrap(program)
        if reader is None:
            raise ValueError("train_scanned: a reader (callable returning "
                             "an iterable of feed dicts) is required")
        k = int(scan_steps)
        if k < 1:
            raise ValueError(f"train_scanned: scan_steps must be >= 1, "
                             f"got {scan_steps}")
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        scope = scope or _scope()
        loader = DeviceLoader(reader, capacity=max(2, capacity or k),
                              program=program, name="train_scanned",
                              place=self.place)
        self._loaders.add(loader)
        loader.start()
        drains = []
        pending = None  # keep ONE drain's fetches un-synced behind the next
        total = 0
        try:
            while True:
                stacked, m = loader.peek_many(k)
                if m == 0:
                    break
                ys = self._run_scan(program, spec, stacked, m, fetch_names,
                                    scope, return_numpy=False,
                                    site="Executor.train_scanned", mesh=mesh,
                                    compiled=compiled)
                total += m
                if pending is not None:
                    drains.append([to_numpy(y) for y in pending])
                pending = ys
        finally:
            loader.close()
            self._loaders.discard(loader)
        if pending is not None:
            drains.append([to_numpy(y) for y in pending])
        if not fetch_names:
            return total
        return [np.concatenate([d[i] for d in drains], axis=0)
                for i in range(len(fetch_names))]

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, debug: bool = False,
                           fetch_list=None, fetch_info=None,
                           print_period: int = 100):
        """Dataset-driven training loop (reference executor.py:894 →
        Executor::RunFromDataset → MultiTrainer hot loop,
        hogwild_worker.cc:163): a DeviceLoader worker converts, pins and
        copies batch N+1 on its side stream while the card runs step N
        (buffered_reader.cc role), and up to ``max_inflight_steps``
        (flags.py; env PDTPU_MAX_INFLIGHT_STEPS, default 2) steps stay
        un-synced as FetchHandles, so the host queues work ahead instead
        of waiting on each step's fetch. Returns the last step's fetches
        (None for an empty dataset)."""
        program = program or default_main_program()
        fetch_list = list(fetch_list or [])
        if dataset is None:
            raise ValueError("dataset is required")
        if thread:
            dataset.set_thread(thread)
        from ..dataio.loader import DeviceLoader

        max_inflight = max(1, int(flag("max_inflight_steps")))
        plain = program._program if isinstance(program, CompiledProgram) \
            else program
        block = plain.global_block()
        names = fetch_info or [getattr(f, "name", str(f))
                               for f in fetch_list]

        def batches():
            for batch in dataset.batches():
                yield {k: v for k, v in batch.items()
                       if block._find_var_recursive(k) is not None}

        inflight: "collections.deque" = collections.deque()

        def retire(entry):
            step_i, handle = entry
            if debug and fetch_list and step_i % print_period == 0:
                vals = handle.numpy()
                print(f"step {step_i}: " + ", ".join(
                    f"{n}={np.asarray(v).mean():.6f}"
                    for n, v in zip(names, vals)))
            else:
                handle.block_until_ready()

        loader = DeviceLoader(batches, capacity=max(2, max_inflight),
                              program=plain, name="train_from_dataset",
                              place=self.place)
        self._loaders.add(loader)
        step = 0
        last = None
        try:
            for feed in loader:
                last = self.run(program, feed=feed, fetch_list=fetch_list,
                                scope=scope, return_handle=True)
                inflight.append((step, last))
                _INFLIGHT.set(len(inflight))
                while len(inflight) > max_inflight:
                    retire(inflight.popleft())
                    _INFLIGHT.set(len(inflight))
                step += 1
            while inflight:
                retire(inflight.popleft())
                _INFLIGHT.set(len(inflight))
        finally:
            _INFLIGHT.set(0)
            loader.close()
            self._loaders.discard(loader)
        return last.numpy() if last is not None else None

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, debug: bool = False,
                           fetch_list=None, fetch_info=None,
                           print_period: int = 100):
        """executor.py:817 parity — the same loop on a for_test program."""
        program = (program or default_main_program()).clone(for_test=True)
        return self.train_from_dataset(program, dataset, scope, thread, debug,
                                       fetch_list, fetch_info, print_period)

    def close(self):
        """Stop every prefetch worker this executor's drivers started
        (they hold queued device batches), then drop the prepared plans."""
        for ld in list(self._loaders):
            ld.close()
        self._loaders = weakref.WeakSet()
        self._cache.clear()


__all__ = ["Place", "CPUPlace", "CUDAPlace", "ExecContext", "Executor",
           "convert_feed_value", "cuda_device", "eval_inference_block",
           "feed_signature", "run_sub_block"]
