"""Program-level optimization passes (counterpart of ``paddle_tpu.ir.passes``;
reference analogs: the fuse/memory passes under ``paddle/fluid/framework/ir/``,
each class cites its own).

The passes are the JAX package's, so both packages optimize a saved model
into the same op list: graph pruning (dead code, inference cleanup),
algebraic op fusion (fc fuse, add+act fuse), constant folding, liveness and
layout annotation, and a graphviz dump. Two differences: constant folding
evaluates the port's ops on host tensors, and byte sizes come from the
port's dtype table.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.dtypes import from_numpy, itemsize, to_numpy
from ..core.program import Block, Operator, Program
from ..core.registry import get_op, has_op
from .graph import Graph, sub_block_var_reads
from .pass_base import Pass, register_pass

# Ops whose execution has effects beyond their outputs — never eliminated,
# never folded (reference: OpProtoMaker "skip pruning" + hard-coded lists in
# prune.cc / constant-folding heuristics).
SIDE_EFFECT_OPS = {
    "feed", "fetch", "print", "py_func", "save", "load", "save_combine",
    "load_combine", "assert", "while", "conditional_block", "switch",
    "increment", "beam_search", "beam_search_decode",
}

RANDOM_OPS = {
    "uniform_random", "gaussian_random", "truncated_gaussian_random",
    "randint", "dropout", "randperm", "sampling_id",
}


def _has_block_attr(op: Operator) -> bool:
    return any(isinstance(v, Block) for v in op.attrs.values())


def _is_protected(op: Operator) -> bool:
    return (op.type in SIDE_EFFECT_OPS or op.type.startswith("c_")
            or _has_block_attr(op))


def _fuse_protected_vars(program: Program, keep, fetch_names) -> set:
    """Vars a fuse pass must not erase as chain intermediates: fetch/keep
    targets, persistable vars, and anything read by sub-blocks."""
    protected = set(keep or []) | set(fetch_names or [])
    protected |= {v.name for v in program.list_vars() if v.persistable}
    protected |= sub_block_var_reads(program, program.global_block())
    return protected


@register_pass
class DeadCodeEliminationPass(Pass):
    """Remove ops whose outputs are never read (ir/ graph pruning + the
    Program._prune path, framework/prune.cc). Roots: caller-specified
    fetch/keep names, persistable vars, side-effect ops, sub-block reads."""

    name = "dead_code_elimination_pass"

    def apply_impl(self, program: Program, keep: Optional[List[str]] = None, **kw):
        blk = program.global_block()
        live = set(keep or [])
        live |= {v.name for v in program.list_vars() if v.persistable}
        live |= sub_block_var_reads(program, blk)
        kept: List[Operator] = []
        for op in reversed(blk.ops):
            outs = set(op.output_names())
            if _is_protected(op) or outs & live:
                kept.append(op)
                live |= set(op.input_names())
        removed = len(blk.ops) - len(kept)
        blk.ops = list(reversed(kept))
        if removed:
            program._bump_version()
        return program


@register_pass
class DeleteDropoutOpPass(Pass):
    """Inference cleanup: dropout becomes its is_test form (dropout_op.cc) —
    `downgrade_in_infer` scales by (1-p), `upscale_in_train` is identity — so
    downstream passes and DCE see a trivial op instead of an rng consumer."""

    name = "delete_dropout_op_pass"

    def apply_impl(self, program: Program, **kw):
        changed = False
        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                if op.type == "dropout":
                    p = op.attr("dropout_prob", 0.5)
                    impl = op.attr("dropout_implementation", "downgrade_in_infer")
                    if impl == "downgrade_in_infer" and p > 0.0:
                        blk.ops[i] = Operator(
                            blk, "scale", {"X": op.input("X")},
                            {"Out": op.output("Out")}, {"scale": 1.0 - p})
                    else:
                        blk.ops[i] = Operator(
                            blk, "assign",
                            {"X": op.input("X")}, {"Out": op.output("Out")})
                    changed = True
        if changed:
            program._bump_version()
        return program


@register_pass
class ConstantFoldingPass(Pass):
    """Evaluate ops whose inputs are all build-time constants and bake the
    result in as `assign_value` (inference analysis' constant_folding;
    combined with DCE this freezes e.g. shape/fill/scale chains)."""

    name = "constant_folding_pass"

    FOLD_SOURCES = {"fill_constant", "assign_value", "eye", "range", "linspace"}

    def apply_impl(self, program: Program, **kw):
        from ..core.executor import ExecContext

        blk = program.global_block()
        graph = Graph(blk)
        const_vals: Dict[str, np.ndarray] = {}
        changed = False
        try:
            order = graph.topology_sort()
        except ValueError:
            return program
        def _invalidate(skipped_op):
            # non-SSA: a skipped op may overwrite a name recorded as constant
            for names in skipped_op.outputs.values():
                for n in names:
                    const_vals.pop(n, None)

        for op in order:
            if _is_protected(op) or op.type in RANDOM_OPS or not has_op(op.type):
                _invalidate(op)
                continue
            if op.type in self.FOLD_SOURCES and not op.inputs:
                pass  # source: evaluate below, keep the op itself
            elif not op.inputs or not all(
                    n in const_vals for n in op.input_names()):
                _invalidate(op)
                continue
            try:
                inputs = {slot: [from_numpy(const_vals[n]) for n in names]
                          for slot, names in op.inputs.items()}
                ctx = ExecContext("cpu", is_test=True)
                outs = get_op(op.type).fn(ctx, inputs, op.attrs)
            except Exception:
                _invalidate(op)
                continue
            for slot, vals in outs.items():
                for name, val in zip(op.output(slot), vals):
                    const_vals[name] = to_numpy(val)
            if op.type not in self.FOLD_SOURCES:
                idx = blk.ops.index(op)
                new_ops = []
                for slot, names in op.outputs.items():
                    for name in names:
                        arr = const_vals[name]
                        new_ops.append(Operator(
                            blk, "assign_value", {}, {"Out": [name]},
                            {"values": arr, "shape": list(arr.shape),
                             "dtype": str(arr.dtype)}))
                blk.ops[idx:idx + 1] = new_ops
                changed = True
        if changed:
            program._bump_version()
        return program


@register_pass
class FuseElewiseAddActPass(Pass):
    """elementwise_add → {relu,tanh,sigmoid,gelu} with a single-consumer
    intermediate becomes one `fused_elemwise_activation` op
    (ir/fuse_elewise_add_act_pass.cc)."""

    name = "fuse_elewise_add_act_pass"

    ACTS = ("relu", "tanh", "sigmoid", "gelu")

    def apply_impl(self, program: Program, keep: Optional[List[str]] = None,
                   fetch_names: Optional[List[str]] = None, **kw):
        blk = program.global_block()
        protected = _fuse_protected_vars(program, keep, fetch_names)
        changed = False
        for act in self.ACTS:
            graph = Graph(blk)
            for chain in graph.find_chains(["elementwise_add", act]):
                add, actop = chain
                if add.output("Out")[0] in protected:
                    continue
                fused = Operator(
                    blk, "fused_elemwise_activation",
                    {"X": add.input("X"), "Y": add.input("Y")},
                    {"Out": actop.output("Out")},
                    {"functor_list": ["elementwise_add", act],
                     "axis": add.attr("axis", -1)})
                graph.replace_chain(chain, fused)
                changed = True
        if changed:
            program._bump_version()
        return program


@register_pass
class FcFusePass(Pass):
    """mul → elementwise_add (→ act) becomes one `fused_fc` op
    (ir/fc_fuse_pass.cc): a single gemm+bias+act unit for the MXU."""

    name = "fc_fuse_pass"

    ACTS = ("relu", "tanh", "sigmoid", "gelu")

    def apply_impl(self, program: Program, keep: Optional[List[str]] = None,
                   fetch_names: Optional[List[str]] = None, **kw):
        blk = program.global_block()
        protected = _fuse_protected_vars(program, keep, fetch_names)
        changed = False
        # longest patterns first: mul+add+act must win over bare mul+add,
        # else the act round never matches (its mul is already consumed)
        for act in self.ACTS + (None,):
            types = ["mul", "elementwise_add"] + ([act] if act else [])
            graph = Graph(blk)
            for chain in graph.find_chains(types):
                mul, add = chain[0], chain[1]
                # bias must be the Y side of the add
                if add.input("X") != mul.output("Out"):
                    continue
                if any(o.output("Out")[0] in protected for o in chain[:-1]):
                    continue
                # bias must be a 1-D last-dim vector (fc_fuse_pass.cc checks
                # bias dims); other axes/shapes don't match fused_fc's
                # (1, N) broadcast and must not fuse
                bias_var = blk._find_var_recursive(add.input("Y")[0])
                if add.attr("axis", -1) not in (-1, 1):
                    continue
                if bias_var is None or bias_var.shape is None or len(
                        [d for d in bias_var.shape if d != 1]) > 1:
                    continue
                fused = Operator(
                    blk, "fused_fc",
                    {"Input": mul.input("X"), "W": mul.input("Y"),
                     "Bias": add.input("Y")},
                    {"Out": chain[-1].output("Out")},
                    {"in_num_col_dims": mul.attr("x_num_col_dims", 1),
                     "activation_type": act or ""})
                graph.replace_chain(chain, fused)
                changed = True
        if changed:
            program._bump_version()
        return program


@register_pass
class MemoryOptimizePass(Pass):
    """Liveness analysis + buffer-reuse plan + donation annotation.

    Reference: ir/memory_optimize_pass/ (reference_count_pass, eager_deletion,
    buffer_shared_inplace, cross-op memory reuse). On TPU, XLA performs the
    actual buffer assignment; what this pass contributes is (a) a reuse/peak
    report for debugging (`program._memory_plan`), and (b) the set of feed
    buffers safe to donate to jit (`program._donatable_feeds`) — consumed by
    the inference Predictor's donate_argnums."""

    name = "memory_optimize_pass"
    neutrality = "annotation"

    def apply_impl(self, program: Program, fetch_names: Optional[List[str]] = None, **kw):
        blk = program.global_block()
        fetch = set(fetch_names or [])
        persist = {v.name for v in program.list_vars() if v.persistable}
        sub_reads = sub_block_var_reads(program, blk)
        first_def: Dict[str, int] = {}
        last_use: Dict[str, int] = {}
        for i, op in enumerate(blk.ops):
            for n in op.input_names():
                # external inputs (feeds) are live from step start
                first_def.setdefault(n, -1)
                last_use[n] = i
            for n in op.output_names():
                first_def.setdefault(n, i)
                last_use[n] = i

        def nbytes(name: str) -> int:
            v = blk._find_var_recursive(name)
            if v is None or v.shape is None or any(d is None or d < 0 for d in v.shape):
                return 0
            return int(np.prod(v.shape)) * itemsize(v.dtype)

        reuse: Dict[str, str] = {}
        free_pool: List[str] = []
        events: List = []
        for name, i in first_def.items():
            if name in persist or name in fetch or name in sub_reads:
                continue
            events.append((i, 0, name))
        for name, i in last_use.items():
            if name in persist or name in fetch or name in sub_reads:
                continue
            events.append((i, 1, name))
        events.sort()
        live_bytes = peak = 0
        for _, kind, name in events:
            if kind == 0:
                donor = next((d for d in free_pool if nbytes(d) >= nbytes(name) > 0), None)
                if donor is not None:
                    free_pool.remove(donor)
                    reuse[name] = donor
                else:
                    live_bytes += nbytes(name)
                peak = max(peak, live_bytes)
            else:
                if name not in reuse:
                    live_bytes -= nbytes(name)
                free_pool.append(name)

        feeds = [v.name for v in program.list_vars() if v.is_data]
        program._memory_plan = {
            "reuse": reuse,
            "peak_bytes_planned": peak,
            "n_temporaries": len(first_def),
        }
        program._donatable_feeds = [n for n in feeds if n not in fetch]
        return program


@register_pass
class GraphVizPass(Pass):
    """Dump the program as graphviz dot (ir/graph_viz_pass.cc,
    debug_graphviz_path_ build_strategy.h:71)."""

    name = "graph_viz_pass"
    neutrality = "annotation"

    def apply_impl(self, program: Program, path: Optional[str] = None, **kw):
        lines = ["digraph G {", "  rankdir=TB;"]
        for b in program.blocks:
            for i, op in enumerate(b.ops):
                op_id = f"op_{b.idx}_{i}"
                lines.append(f'  {op_id} [label="{op.type}", shape=box, style=filled, fillcolor=lightblue];')
                for n in op.input_names():
                    lines.append(f'  "var_{n}" [label="{n}", shape=ellipse];')
                    lines.append(f'  "var_{n}" -> {op_id};')
                for n in op.output_names():
                    lines.append(f'  "var_{n}" [label="{n}", shape=ellipse];')
                    lines.append(f'  {op_id} -> "var_{n}";')
        lines.append("}")
        dot = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(dot)
        program._graphviz_dot = dot
        return program


@register_pass
class DeadVarEliminationPass(Pass):
    """Purge `block.vars` entries no op reads or writes any more — the
    residue fuse/fold/DCE passes leave behind (DCE removes *ops*; the
    orphaned Variable descriptors — and for persistables, the weight
    upload they would trigger — linger until this pass). Feeds
    (`is_data`), fetch/keep targets and sub-block reads survive; an
    unreferenced *persistable* is exactly the dead weight this pass
    exists to drop (conv_bn_fuse did this ad hoc for BN params)."""

    name = "dead_var_elimination_pass"

    def apply_impl(self, program: Program, keep: Optional[List[str]] = None,
                   fetch_names: Optional[List[str]] = None, **kw):
        referenced = set()
        for b in program.blocks:
            for op in b.ops:
                referenced |= set(op.input_names())
                referenced |= set(op.output_names())
        protect = set(keep or []) | set(fetch_names or [])
        removed = 0
        for b in program.blocks:
            for name in list(b.vars):
                v = b.vars[name]
                if (name in referenced or name in protect
                        or getattr(v, "is_data", False)):
                    continue
                del b.vars[name]
                removed += 1
        if removed:
            program._bump_version()
        return program


# MXU/VMEM minimum tile per dtype: (sublane, lane) — the lane dim is
# always 128; the sublane minimum scales inversely with element width
# (f32 (8,128), bf16 (16,128), int8 (32,128)).
_TILE_SUBLANE = {1: 32, 2: 16, 4: 8, 8: 8}
_TILE_LANE = 128


@register_pass
class LayoutAssignmentPass(Pass):
    """Annotate the program with a TPU layout plan: for every var with a
    static shape, the padded footprint once the trailing two dims are
    rounded up to the dtype's minimum tile, and per matmul-family op
    whether its contracting/output dims land tile-aligned. XLA assigns
    the real layouts — this pass exists so pass authors and the perf
    ledger can see *where the padding waste is* (a [B, 100] fc wastes
    22% of every (8,128) f32 tile) without digging through HLO. Pure
    annotation: `program._layout_plan`, no op edits."""

    name = "layout_assignment_pass"
    neutrality = "annotation"

    MATMUL_OPS = ("mul", "matmul", "matmul_v2", "fused_fc", "quantized_fc",
                  "quantized_matmul")

    @staticmethod
    def _padded(shape, itemsize: int):
        dims = [int(d) if d is not None and int(d) > 0 else 1
                for d in shape]
        if not dims:
            return 1, 1
        natural = 1
        for d in dims:
            natural *= d
        pad = list(dims)
        pad[-1] = -(-pad[-1] // _TILE_LANE) * _TILE_LANE
        if len(pad) >= 2:
            sub = _TILE_SUBLANE.get(itemsize, 8)
            pad[-2] = -(-pad[-2] // sub) * sub
        padded = 1
        for d in pad:
            padded *= d
        return natural * itemsize, padded * itemsize

    def apply_impl(self, program: Program, **kw):
        per_var: Dict[str, dict] = {}
        natural_total = padded_total = 0
        for b in program.blocks:
            for op in b.ops:
                for name in list(op.input_names()) + list(op.output_names()):
                    if name in per_var:
                        continue
                    v = b._find_var_recursive(name)
                    if v is None or v.shape is None:
                        continue
                    try:
                        size = itemsize(v.dtype)
                    except (TypeError, ValueError):
                        size = 4
                    nat, pad = self._padded(v.shape, size)
                    per_var[name] = {"natural_bytes": nat,
                                     "padded_bytes": pad,
                                     "waste": round(1.0 - nat / pad, 4)}
                    natural_total += nat
                    padded_total += pad
        ops = []
        for b in program.blocks:
            for op in b.ops:
                if op.type not in self.MATMUL_OPS:
                    continue
                slot = "Input" if op.type.endswith("fc") else "X"
                xs = op.input(slot) or op.input("X")
                ws = op.input("W") or op.input("Y")
                vx = b._find_var_recursive(xs[0]) if xs else None
                vw = b._find_var_recursive(ws[0]) if ws else None
                k = int(vx.shape[-1]) if vx is not None and vx.shape else 0
                n = int(vw.shape[-1]) if vw is not None and vw.shape else 0
                ops.append({"op": op.type, "out": op.output_names()[:1],
                            "k": k, "n": n,
                            "k_aligned": k > 0 and k % _TILE_LANE == 0,
                            "n_aligned": n > 0 and n % _TILE_LANE == 0})
        worst = sorted(per_var.items(), key=lambda kv: -(
            kv[1]["padded_bytes"] - kv[1]["natural_bytes"]))[:8]
        program._layout_plan = {
            "natural_bytes": natural_total,
            "padded_bytes": padded_total,
            "waste_fraction": (round(1.0 - natural_total / padded_total, 4)
                               if padded_total else 0.0),
            "matmul_ops": ops,
            "worst_vars": [{"var": n, **d} for n, d in worst],
        }
        return program


@register_pass
class ConvBnFusePass(Pass):
    """Fold inference-mode batch_norm into the preceding conv2d's weights
    (reference ir/conv_bn_fuse_pass.cc): w' = w·γ/√(σ²+ε) per out channel,
    b' = β − μ·γ/√(σ²+ε); the BN op is replaced by one bias add. Needs the
    live scope (weights are folded in place), so it only runs when the
    caller passes `scope=` — the inference Predictor does."""

    name = "conv_bn_fuse_pass"
    # folding w·γ/√(σ²+ε) re-rounds the conv weights — same math, new bits
    neutrality = "precision"

    def apply_impl(self, program: Program, scope=None, **kw):
        if scope is None:
            return program
        blk = program.global_block()
        producer = {}
        consumers: Dict[str, int] = {}
        for i, op in enumerate(blk.ops):
            for n in op.output_names():
                producer[n] = i
            for n in op.input_names():
                consumers[n] = consumers.get(n, 0) + 1

        fused = 0
        new_ops: List[Operator] = []
        for op in blk.ops:
            if op.type == "batch_norm" and op.attrs.get("is_test"):
                x = op.inputs["X"][0]
                pi = producer.get(x)
                conv = blk.ops[pi] if pi is not None else None
                if conv is not None and conv.type == "conv2d" \
                        and consumers.get(x, 0) == 1 \
                        and not conv.inputs.get("Bias") \
                        and consumers.get(conv.inputs["Filter"][0], 0) == 1:
                    # the Filter-consumer guard keeps weight-shared convs
                    # out: folding edits the weights in place
                    w_name = conv.inputs["Filter"][0]
                    names = {s2: op.inputs[s2][0]
                             for s2 in ("Scale", "Bias", "Mean", "Variance")}
                    if scope.has_var(w_name) and all(
                            scope.has_var(n) for n in names.values()):
                        # folded on the host in numpy (the JAX package's
                        # arithmetic), stored back as tensors on the
                        # weight's device
                        w_t = scope.find_var(w_name)
                        w = to_numpy(w_t)
                        gamma, beta, mean, var = (
                            to_numpy(scope.find_var(names[k]))
                            for k in ("Scale", "Bias", "Mean", "Variance"))
                        eps = op.attrs.get("epsilon", 1e-5)
                        alpha = gamma / np.sqrt(var + eps)
                        scope.set_var(w_name, from_numpy(
                            (w * alpha.reshape(-1, 1, 1, 1)).astype(w.dtype),
                            w_t.device))
                        b_name = f"{w_name}@bn_folded_bias"
                        blk.create_var(name=b_name, shape=(len(alpha),),
                                       dtype=str(w.dtype), persistable=True)
                        scope.set_var(b_name, from_numpy(
                            (beta - mean * alpha).astype(w.dtype),
                            w_t.device))
                        # the conv (already emitted, in place) keeps its
                        # output; a bias add writes the BN's Y in its stead
                        # (followed by the BN's folded activation, if any)
                        y = op.outputs["Y"][0]
                        act = op.attrs.get("act", "")
                        add_out = y if not act else f"{y}@bn_fold_preact"
                        if act:
                            ydt = (blk.vars[y].dtype if y in blk.vars
                                   else "float32")
                            blk.create_var(name=add_out, dtype=ydt)
                        new_ops.append(Operator(
                            blk, "elementwise_add",
                            {"X": [x], "Y": [b_name]},
                            {"Out": [add_out]}, {"axis": 1}))
                        if act:
                            new_ops.append(Operator(
                                blk, act, {"X": [add_out]}, {"Out": [y]}, {}))
                        fused += 1
                        continue
            new_ops.append(op)
        blk.ops = new_ops
        if fused:
            # drop the now-dead BN parameter vars so the predictor doesn't
            # upload four unread per-channel arrays per fused BN
            read = {n for op2 in blk.ops for n in op2.input_names()}
            for name in list(blk.vars):
                v = blk.vars[name]
                if getattr(v, "persistable", False) and name not in read \
                        and name.count("@bn_folded_bias") == 0 \
                        and name not in {n for op2 in blk.ops
                                         for n in op2.output_names()}:
                    del blk.vars[name]
            program._bump_version()
        return program
