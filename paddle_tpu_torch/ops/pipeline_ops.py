"""Program-level pipeline-parallel ops (counterpart of
``paddle_tpu.ops.pipeline_ops``; reference ``optimizer.py:2677``
PipelineOptimizer, executed by PipelineTrainer/SectionWorker,
section_worker.cc:141).

``PipelineOptimizer`` cuts a program into stages. Isomorphic stages (the
transformer-by-layers case) become one ``pipeline`` op: a template
sub-block (stage 0's ops) and every stage's parameters, stage-major.
Other stages become one ``pipeline_hetero`` op with a sub-block a stage.

On a mesh with the op's ``pp`` axis (``core/mesh_step.py``: the rank at
coordinate i holds stage i's parameters) the op runs the GPipe schedule of
``parallel/pipeline.py``: this rank's rows are cut into
``num_microbatches`` microbatches, stage i runs each of them through the
executor's ``_run_block`` (so the mesh step's hooks apply inside the
stage: the tensor-parallel layouts of a composed dp×tp×pp program, and
on a sequence axis each stage on the rank's slice of the sequence, its
output laid out as its input), and the last stage's outputs come back to
every rank. A capture (a value the
stages read that the prologue made, such as the attention mask) whose
leading dim is the batch is microbatched with the activations;
``capture_spec`` ({name: "batched" | "shared"}) overrides that rule.
Without a ``pp`` axis the op runs its stages one after another on the
whole batch (the same math, no overlap).

Dropout inside the stages: every step takes a base from the run's
generator (its state, hashed; the generator is then reseeded, so the next
step's base differs) and stage s on microbatch f draws from a generator
seeded by (base, s, f); the sequential path seeds by (base, s). The tp
ranks of a stage share the step's generator (``MeshStep.generator`` folds
the dp coordinate only), so they draw the same masks.
"""
from __future__ import annotations

import copy
import hashlib
import logging
import math

import torch

from ..core.dtypes import convert_dtype
from ..core.registry import ROWS, TP, register_op

logger = logging.getLogger(__name__)


def _log_schedule(kind, n, m):
    """Schedule report: GPipe ticks and bubble fraction (every tick runs
    one full stage on every rank, so the idle fraction is
    (n-1)/(m+n-1))."""
    from ..parallel.pipeline import schedule_info

    info = schedule_info("gpipe", n, m)
    logger.info("[pipeline] %s schedule: stages=%d microbatches=%d "
                "ticks=%d bubble_fraction=%.3f", kind, n, m, info["ticks"],
                info["bubble_fraction"])


def _whole_stage(attrs, lay, shapes, n):
    """On a model axis the op takes its inputs as they are: its stages'
    ops see the parameters' slices through the mesh step's hooks."""
    return TP()


def _seq_stage(attrs, lay, shapes, n):
    """On the sequence axis the stages run on this rank's slice of the
    sequence: the op takes its inputs as they are (the stages' ops see
    the slices through the mesh step's hooks, and each stage's output is
    laid out as its input), so ``Out`` keeps X's layout; the microbatch
    exchange pairs the ranks of one sequence coordinate (the pp axis's
    group)."""
    return TP(out={"Out": lay["X"][0]}, inner=True)


def _stream_base(ctx):
    """This step's base for the stage generators (None in test mode): a
    hash of the run generator's state; the generator is reseeded from the
    same hash, so every step gets a new base without a draw on the card."""
    if ctx.is_test:
        return None
    gen = ctx.rng()
    digest = hashlib.sha1(gen.get_state().numpy().tobytes()).digest()
    gen.manual_seed(int.from_bytes(digest[8:16], "little") % (2 ** 63))
    return int.from_bytes(digest[:8], "little")


def _stage_gen(ctx, base, *key):
    if base is None:
        return ctx.rng()
    h = hashlib.sha1(repr((base,) + key).encode()).digest()
    return torch.Generator(ctx.device).manual_seed(
        int.from_bytes(h[:8], "little") % (2 ** 63))


def _pp_step(ctx, axis):
    """The mesh step when the op's axis is its pipeline axis, else None."""
    step = getattr(ctx, "mesh", None)
    if step is None or getattr(step, "pp_axis", None) != axis:
        return None
    return step


def _is_batched(spec, b):
    def test(name, c):
        if name in spec:
            return spec[name] == "batched"
        return getattr(c, "ndim", 0) >= 1 and c.shape[0] == b
    return test


def _run_sub(ctx, block, env, gen):
    from ..core.executor import _run_block

    sub = copy.copy(ctx)
    sub._gen = gen
    _run_block(block, env, sub)


def _micro(m, b):
    return lambda a: a.reshape((m, b // m) + tuple(a.shape[1:]))


@register_op("pipeline", dp=ROWS, tp=_whole_stage, sp=_seq_stage)
def _pipeline(ctx, inputs, attrs):
    from ..parallel.pipeline import run_stages

    (x,) = inputs["X"]
    flat_params = inputs["Params"]          # [stage-major][param]
    n_stages = attrs["n_stages"]
    n_params = attrs["n_params"]
    m = attrs.get("num_microbatches", 1)
    axis = attrs.get("axis", "pp")
    block = attrs["sub_block"]
    in_name = attrs["in_name"]
    out_name = attrs["out_name"]
    param_names = attrs["param_names"]      # template (stage-0) names
    capture_names = attrs.get("capture_names", [])
    captures = inputs.get("Captures", [])
    names_in = ctx.in_names.get("Params", []) if ctx.in_names else []
    b = x.shape[0]
    batched_of = _is_batched(attrs.get("capture_spec") or {}, b)
    batched = [i for i, c in enumerate(captures)
               if batched_of(capture_names[i], c)]
    static = {capture_names[i]: captures[i]
              for i in range(len(captures)) if i not in batched}
    bc_names = [capture_names[i] for i in batched]
    base = _stream_base(ctx)
    step = _pp_step(ctx, axis)

    def stage_names(s):
        return list(names_in[s * n_params:(s + 1) * n_params])

    mesh = getattr(ctx, "mesh", None)
    x_name = (ctx.in_names or {}).get("X", [None])[0]

    def run_stage(params_list, inp, bcaps, gen):
        env = dict(zip(param_names, params_list))
        env.update(static)
        env.update(zip(bc_names, bcaps))
        env[in_name] = inp
        _run_sub(ctx, block, env, gen)
        y = env[out_name]
        if mesh is not None:  # the stage's output on its input's layout
            y = mesh.relayout(out_name, y, in_name)
        return y

    def alias(s):
        if mesh is not None and names_in:
            mesh.alias_layouts(param_names + [in_name],
                               stage_names(s) + [x_name])

    if step is None:
        # no pp axis: the stages one after another on the whole batch
        y = x
        bcaps = [captures[i] for i in batched]
        for s in range(n_stages):
            alias(s)
            y = run_stage(flat_params[s * n_params:(s + 1) * n_params], y,
                          bcaps, _stage_gen(ctx, base, s))
        return {"Out": [y]}

    i = step.pp_rank
    if b % m:
        raise ValueError(f"pipeline: batch {b} not divisible by "
                         f"num_microbatches {m}")
    alias(i)
    micro = _micro(m, b)

    def run(ps, inp, f, side_f):
        y = run_stage(ps, inp, side_f, _stage_gen(ctx, base, i, f))
        if tuple(y.shape) != tuple(inp.shape) or y.dtype != inp.dtype:
            raise ValueError(
                f"pipeline: stage {i}'s output {tuple(y.shape)} {y.dtype} "
                f"differs from its input {tuple(inp.shape)} {inp.dtype}; "
                f"isomorphic stages keep the boundary shape")
        return y

    _log_schedule("GPipe", n_stages, m)
    out = run_stages(step.pp_group,
                     flat_params[i * n_params:(i + 1) * n_params], micro(x),
                     [micro(captures[j]) for j in batched], run)
    return {"Out": [out.reshape(x.shape)]}


@register_op("pipeline_hetero", dp=ROWS, tp=_whole_stage)
def _pipeline_hetero(ctx, inputs, attrs):
    """Heterogeneous pipeline: per-stage sub-blocks with their own ops,
    params, captures and boundary shapes (reference heterogeneous
    sections, section_worker.cc:141): the GPipe schedule with a flat,
    zero-padded payload on a ``pp`` axis, or the stages one after another
    without one."""
    from ..parallel.pipeline import flat_pad, run_stages

    (x,) = inputs["X"]
    flat_params = inputs["Params"]
    flat_caps = inputs.get("Captures", [])
    blocks = attrs["sub_blocks"]
    names = attrs["boundary_names"]
    param_names = attrs["param_names"]      # list of per-stage name lists
    cap_names = attrs["capture_names"]
    n_stages = attrs["n_stages"]
    m = attrs.get("num_microbatches", 1)
    axis = attrs.get("axis", "pp")
    b = x.shape[0]
    batched_of = _is_batched(attrs.get("capture_spec") or {}, b)

    # split the flat input lists back per stage
    ps, cs, pi, ci = [], [], 0, 0
    for k in range(n_stages):
        ps.append(list(flat_params[pi:pi + len(param_names[k])]))
        cs.append(list(flat_caps[ci:ci + len(cap_names[k])]))
        pi += len(param_names[k])
        ci += len(cap_names[k])
    base = _stream_base(ctx)

    def caps_of(k):
        bnames = [n for n, c in zip(cap_names[k], cs[k]) if batched_of(n, c)]
        static = {n: c for n, c in zip(cap_names[k], cs[k])
                  if n not in bnames}
        bvals = [c for n, c in zip(cap_names[k], cs[k]) if n in bnames]
        return bnames, static, bvals

    def run_stage(k, params_list, xin, bnames, static, bvals, gen):
        env = dict(zip(param_names[k], params_list))
        env.update(static)
        env.update(zip(bnames, bvals))
        env[names[k]] = xin
        _run_sub(ctx, blocks[k], env, gen)
        return env[names[k + 1]]

    step = _pp_step(ctx, axis)
    if step is None:
        y = x
        for k in range(n_stages):
            bnames, static, bvals = caps_of(k)
            y = run_stage(k, ps[k], y, bnames, static, bvals,
                          _stage_gen(ctx, base, k))
        return {"Out": [y]}

    if b % m:
        raise ValueError(f"pipeline_hetero: batch {b} not divisible by "
                         f"num_microbatches {m}")
    gblock = blocks[0].program.global_block()
    mb = b // m
    shapes = []
    for k, name in enumerate(names):
        var = gblock._find_var_recursive(name)
        tail = tuple(int(d) for d in (var.shape or ())[1:])
        if any(d < 0 for d in tail):
            raise ValueError(
                f"pipeline_hetero: boundary {name!r} has a dynamic dim "
                f"{tuple(var.shape)}; the payload needs static shapes")
        if k and convert_dtype(var.dtype) != x.dtype:
            raise ValueError(
                f"pipeline_hetero: stage {k - 1} output dtype "
                f"{convert_dtype(var.dtype)} != payload dtype {x.dtype}")
        shapes.append((mb,) + tail)
    pay = max(math.prod(s[1:]) for s in shapes)
    i = step.pp_rank
    bnames, static, bvals = caps_of(i)
    micro = _micro(m, b)

    def run(params_list, inp, f, side_f):
        return run_stage(i, params_list, inp, bnames, static, side_f,
                         _stage_gen(ctx, base, i, f))

    def unpack(buf):
        return buf[:, :math.prod(shapes[i][1:])].reshape(shapes[i])

    _log_schedule("GPipe-hetero", n_stages, m)
    out = run_stages(step.pp_group, ps[i], micro(x),
                     [micro(v) for v in bvals], run,
                     recv_like=lambda: x.new_empty((mb, pay)),
                     out_like=(shapes[-1], x.dtype),
                     pack=lambda y: flat_pad(y, pay), unpack=unpack)
    return {"Out": [out.reshape((b,) + tuple(shapes[-1][1:]))]}
