"""Tensor (model) parallelism — Megatron-style param sharding rules (the
port's copy of ``paddle_tpu.parallel.tensor_parallel``, pure Python over a
``Program``; the port's ops carry the JAX package's names, so the pattern
tables are the same).

The JAX package places the annotated parameters and lets GSPMD insert the
collectives; the port's mesh step (``core/mesh_step.py``) holds each
annotated parameter's slice on its rank and runs every op by its ``tp``
declaration (``core/registry.py``), with the Megatron f/g pair where a
replicated value enters a sharded product and where partial sums become
whole.

Reference status: TP was absent (SURVEY §2.2 row "Tensor/model parallel —
partial": only pserver-sharded embeddings via parameter_prefetch.cc). This is
a first-class capability here: parameters get PartitionSpec annotations and
GSPMD inserts the all-reduces a hand-written Megatron implementation would.

Rules map param-name regexes → PartitionSpec tuples. Column-parallel weights
shard the output dim, row-parallel shard the input dim; GSPMD then emits one
psum per transformer block (after attn-out and ffn2), exactly the Megatron
communication pattern, riding ICI.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, Sequence, Tuple

from ..core.program import Program

# rule: regex on param name → spec template with 'tp' marking the sharded dim
MEGATRON_RULES: Sequence[Tuple[str, Tuple]] = (
    (r".*\.qkv\.w$", (None, "tp")),      # column parallel
    (r".*\.qkv\.b$", ("tp",)),
    (r".*\.attn_out\.w$", ("tp", None)),  # row parallel
    (r".*\.ffn1\.w$", (None, "tp")),
    (r".*\.ffn1\.b$", ("tp",)),
    (r".*\.ffn2\.w$", ("tp", None)),
    (r"word_embedding$", ("tp", None)),   # vocab-sharded embedding
    (r"mlm_out\.w$", (None, "tp")),
    (r"mlm_out\.b$", ("tp",)),
)

# transformer_nmt (models/transformer_nmt.py) naming: separate q/k/v
# projections, `o` attention output, shared ffn1/ffn2 naming, vocab-sharded
# embeddings and output projection.
NMT_RULES: Sequence[Tuple[str, Tuple]] = (
    (r".*\.(q|k|v)\.w$", (None, "tp")),   # column parallel
    (r".*\.o\.w$", ("tp", None)),         # row parallel
    (r".*\.ffn1\.w$", (None, "tp")),
    (r".*\.ffn1\.b$", ("tp",)),
    (r".*\.ffn2\.w$", ("tp", None)),
    (r"(src|tgt)_embedding$", ("tp", None)),
    (r"out_proj\.w$", (None, "tp")),
)

# DeepFM (models/deepfm.py): the Criteo-scale tables are the only params
# worth sharding — vocab(row)-split, the pserver-lookup-table replacement.
DEEPFM_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"fm_emb$", ("tp", None)),
    (r"fm_w1$", ("tp", None)),
)


def annotate_tp(program: Program, rules: Sequence[Tuple[str, Tuple]] = MEGATRON_RULES,
                axis: str = "tp") -> int:
    """Attach shard_spec to matching parameters. Returns #annotated.
    CompiledProgram.with_mesh then places them (compiler.py _state_sharding).

    Build-time alternative: any layer accepts
    ``param_attr=ParamAttr(shard_spec=(..., "tp"))`` — LayerHelper carries it
    onto the Parameter directly, no rules needed (models/bert.py uses this)."""
    count = 0
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    params = list(program.all_parameters())
    for p in params:
        for pat, spec in compiled:
            if pat.match(p.name):
                p.shard_spec = tuple(axis if s == "tp" else s for s in spec)
                count += 1
                break
    if count == 0 and params:
        warnings.warn(
            "annotate_tp matched ZERO of the program's "
            f"{len(params)} parameters — the rules do not fit this model's "
            "param names (first few: "
            f"{[p.name for p in params[:5]]}); no tensor-parallel sharding "
            "will be applied. Pass model-specific rules (e.g. NMT_RULES, "
            "DEEPFM_RULES) or set ParamAttr(shard_spec=...) at build time.",
            stacklevel=2)
    return count


def embedding_shard_spec(axis: str = "tp"):
    """Row(vocab)-sharded embedding table spec — the TPU replacement for the
    reference's distributed_lookup_table pserver path (SURVEY §2.2)."""
    return (axis, None)


# ops a Megatron shard region may flow through without leaving the region:
# pure per-position transforms plus the attention internals (softmax over
# head-sharded scores, var-var matmuls). layer_norm / batch_norm / the
# reductions are BARRIERS: Megatron normalizes on replicated activations,
# so a chain crossing one is not a col→row pair.
_PASS_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul", "dropout",
    "relu", "gelu", "tanh", "sigmoid", "swish", "silu", "leaky_relu",
    "reshape", "reshape2", "transpose", "transpose2", "scale", "split",
    "concat", "stack", "unsqueeze", "unsqueeze2", "squeeze", "squeeze2",
    "cast", "softmax",
})
_ACT_SET = frozenset({"relu", "gelu", "tanh", "sigmoid", "swish", "silu",
                      "leaky_relu"})


def derive_tp_specs(program: Program, axis: str = "tp",
                    min_embed_rows: int = 1024,
                    min_matmul_dim: int = 512) -> Dict[str, Tuple]:
    """Derive Megatron-style shard specs STRUCTURALLY — from the
    program's op patterns, with no per-model name-regex table (VERDICT r3
    weak #4 / next #7). Returns {param_name: spec} without mutating the
    program; :func:`annotate_tp_auto` applies them.

    Patterns recognized (each mirrors a hand rule in
    MEGATRON_RULES/NMT_RULES/DEEPFM_RULES):

    - **embedding tables**: a `lookup_table(_v2)` weight with ≥
      ``min_embed_rows`` rows is vocab(row)-sharded — the
      parameter_prefetch.cc replacement. The row threshold keeps small
      position/segment tables replicated.
    - **col→row matmul pairs**: a 2-D weight whose matmul output flows
      through per-position ops / attention internals into ANOTHER 2-D
      weight's matmul is column-parallel, the second weight
      row-parallel (ffn1→ffn2; q/k/v or fused qkv → attention output
      projection — the split/softmax/var-var-matmul internals are
      pass-through). Chains never cross layer_norm/batch_norm/reductions
      (Megatron normalizes replicated activations).
    - **vocab heads**: a weight whose matmul output reaches
      softmax(_with_cross_entropy) with no later param matmul is
      column-parallel (mlm_out, out_proj).
    - **column biases**: a 1-D param added to a column-sharded output
      BEFORE any further matmul/softmax is sharded too; a row-parallel
      output's bias (added after the implied psum) stays replicated.
    - dims below ``min_matmul_dim`` stay replicated (DeepFM's 400-wide
      MLP is cheaper replicated than gathered).
    """
    all_ops = [op for blk in program.blocks for op in blk.ops]
    params = {p.name for p in program.all_parameters()}
    shapes = {p.name: tuple(p.shape) for p in program.all_parameters()}
    consumers: Dict[str, list] = {}
    for op in all_ops:
        for slot, names in op.inputs.items():
            for n in names:
                consumers.setdefault(n, []).append((op, slot))

    specs: Dict[str, Tuple] = {}

    def set_spec(name, spec):
        if name in specs and specs[name] != spec:
            warnings.warn(
                f"derive_tp_specs: {name} matches conflicting patterns "
                f"{specs[name]} vs {spec}; leaving it replicated",
                stacklevel=3)
            specs[name] = None
            return
        specs[name] = spec

    # 1. embedding tables
    for op in all_ops:
        if op.type in ("lookup_table", "lookup_table_v2"):
            (w,) = op.inputs.get("W", [None]) or [None]
            if w in params and shapes[w][0] >= min_embed_rows:
                set_spec(w, (axis, None))

    # 2/3. matmul-weight chains. candidates: mul/matmul with a 2-D param
    # as Y and a non-param activation as X
    def _transposed(op):
        return bool(op.attrs.get("transpose_Y") or op.attrs.get("trans_y"))

    def _out_dim(w, op):
        # output dim of y in x@y (or x@y.T): the dim a COLUMN shard splits
        return shapes[w][0] if _transposed(op) else shapes[w][1]

    def _in_dim(w, op):
        return shapes[w][1] if _transposed(op) else shapes[w][0]

    def _col_spec(op):
        return (axis, None) if _transposed(op) else (None, axis)

    def _row_spec(op):
        return (None, axis) if _transposed(op) else (axis, None)

    weight_matmuls = {}          # out var -> (weight name, matmul op)
    for op in all_ops:
        if op.type in ("mul", "matmul"):
            xs = op.inputs.get("X", [])
            ys = op.inputs.get("Y", [])
            if (len(ys) == 1 and ys[0] in params
                    and len(shapes[ys[0]]) == 2
                    and (not xs or xs[0] not in params)):
                weight_matmuls[op.outputs["Out"][0]] = (ys[0], op)

    row_proposals: Dict[str, Tuple] = {}
    for out_var, (w, w_op) in weight_matmuls.items():
        col_ok = _out_dim(w, w_op) >= min_matmul_dim
        # BFS through the shard region
        seen = set()
        frontier = [(out_var, True)]   # (var, still-pure-elementwise)
        biases = []
        paired_row = None            # (name, its matmul op)
        is_head = False
        while frontier:
            var, pure = frontier.pop()
            if var in seen:
                continue
            seen.add(var)
            for cop, slot in consumers.get(var, ()):
                if cop.type in ("mul", "matmul"):
                    w2 = cop.inputs.get("Y", [None])
                    w2 = w2[0] if w2 else None
                    if (slot == "X" and w2 in params
                            and len(shapes[w2]) == 2):
                        paired_row = paired_row or (w2, cop)
                        continue   # the pair ends this branch
                    # var-var matmul (attention scores/context): continue
                    for o in cop.outputs.get("Out", []):
                        frontier.append((o, False))
                    continue
                if cop.type in ("softmax_with_cross_entropy",
                                "cross_entropy"):
                    if slot in ("Logits", "X"):
                        is_head = True
                    continue
                if cop.type == "softmax" and pure:
                    # a softmax DIRECTLY on the matmul(+bias) output is a
                    # classifier head (attention softmaxes arrive through
                    # var-var score matmuls, i.e. pure=False)
                    is_head = True
                if cop.type not in _PASS_OPS:
                    continue       # barrier (layer_norm, reduce, ...)
                if cop.type == "elementwise_add" and pure:
                    others = [n for s, ns in cop.inputs.items()
                              for n in ns if n != var]
                    for b in others:
                        if b in params and len(shapes[b]) == 1:
                            biases.append(b)
                nxt_pure = pure and cop.type not in ("softmax",) \
                    and cop.type not in _ACT_SET
                for onames in cop.outputs.values():
                    for o in onames:
                        frontier.append((o, nxt_pure))
        if (paired_row or is_head) and col_ok:
            set_spec(w, _col_spec(w_op))
            for b in biases:
                set_spec(b, (axis,))
        if paired_row and col_ok:
            w2, w2_op = paired_row
            if _in_dim(w2, w2_op) >= min_matmul_dim:
                prop = _row_spec(w2_op)
                if w2 in row_proposals and row_proposals[w2] != prop:
                    warnings.warn(
                        f"derive_tp_specs: {w2} terminates col→row chains "
                        f"with conflicting orientations "
                        f"{row_proposals[w2]} vs {prop} (mixed transpose_y "
                        f"uses); leaving it replicated", stacklevel=2)
                    row_proposals[w2] = None
                elif w2 not in row_proposals:
                    row_proposals[w2] = prop

    # row-parallel is the WEAKEST classification: a tied embedding+head
    # weight is both the terminus of a col→row chain AND a vocab head /
    # lookup table — the head/lookup spec (shard the vocab dim) serves
    # every use, so it wins and the row proposal is dropped silently.
    for name, spec in row_proposals.items():
        if name not in specs and spec is not None:
            specs[name] = spec

    return {n: s for n, s in specs.items() if s is not None}


def annotate_tp_auto(program: Program, axis: str = "tp", **kwargs) -> int:
    """Structural :func:`annotate_tp`: derive specs from the program's op
    graph (derive_tp_specs) and attach them. Returns #annotated."""
    specs = derive_tp_specs(program, axis=axis, **kwargs)
    for p in program.all_parameters():
        if p.name in specs:
            p.shard_spec = specs[p.name]
    if not specs and list(program.all_parameters()):
        warnings.warn(
            "annotate_tp_auto derived ZERO shardable parameters — the "
            "program has no large embedding tables, Megatron matmul "
            "pairs, or vocab heads; everything stays replicated.",
            stacklevel=2)
    return len(specs)
