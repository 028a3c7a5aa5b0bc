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

Not ported yet: the update-group fusion, remat groups, the scanned
multi-step drivers and the observability hooks (ROADMAP "Left out by
slice 2").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from . import registry
from .dtypes import dtype_str, from_numpy, to_device, to_numpy
from .program import (Block, Program, Variable, default_main_program,
                      grad_var_name)
from .scope import Scope, _scope

_RNG_STATE = "@RNG_STATE@"


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
    none — a GPU request never carries on quietly on the CPU. Turns TF32 off
    for float32 matmuls and convolutions, so float32 results keep parity
    with the CPU and the JAX package."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"a CUDA device was requested but torch sees none; "
                           f"{hint}")
    if device_id >= torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {device_id} requested, "
                           f"{torch.cuda.device_count()} present; {hint}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _run_block(block: Block, env: Dict[str, torch.Tensor], ctx: ExecContext):
    for op in block.ops:
        if op.type == "autodiff":
            _run_autodiff(op, env, ctx)
            # the update ops that follow record no graph
            torch.set_grad_enabled(False)
        else:
            _run_op(op, env, ctx)


class Executor:
    """python/paddle/fluid/executor.py:295 parity, eager on torch.

    exe = Executor(CUDAPlace(0)); exe.run(startup); exe.run(main, feed, fetch_list)

    With no place the executor runs on CUDA device 0; ``CPUPlace()`` is the
    explicit CPU request.
    """

    def __init__(self, place: Optional[Place] = None):
        self.place = place or CUDAPlace(0)
        self.device = self.place.torch_device()

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, np.ndarray]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        """Run `program`: feed → execute → fetch (reference executor.py:539).
        Persistable vars are read from and written back to `scope`."""
        program = program or default_main_program()
        scope = scope or _scope()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        block = program.global_block()
        env = {}
        persistables = sorted({v.name for v in program.list_vars()
                               if v.persistable})
        for n in persistables:
            val = scope.find_var(n)
            if val is not None:
                env[n] = to_device(val, self.device)
        for name, val in (feed or {}).items():
            env[name] = convert_feed_value(block, name, val, self.device)
        gen = scope.find_var(_RNG_STATE)
        if gen is None or gen.device != self.device:
            gen = torch.Generator(self.device).manual_seed(
                program.random_seed or 0)
            scope.set_var(_RNG_STATE, gen)
        needed = set(fetch_names).union(
            n for op in block.ops for n in op.input_names())
        ctx = ExecContext(self.device, gen, amp=getattr(program, "_amp", None),
                          needed=needed)
        ctx.targets = _autodiff_targets(block)
        ctx.training = bool(ctx.targets)
        for n in ctx.targets:
            v = env.get(n)
            if v is not None and v.is_floating_point():
                env[n] = v.detach().requires_grad_()  # a fresh leaf each run
        with torch.set_grad_enabled(ctx.training):
            _run_block(block, env, ctx)
        for n in persistables:
            if n in env:
                scope.set_var(n, env[n].detach())
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return [f.detach() for f in fetches]


__all__ = ["Place", "CPUPlace", "CUDAPlace", "ExecContext", "Executor",
           "convert_feed_value", "cuda_device"]
