"""Program visualization (reference python/paddle/fluid/debugger.py
draw_block_graphviz / net_drawer.py; ir/graph_viz_pass.cc); a copy of
``paddle_tpu.debugger`` over the port's Program."""
from __future__ import annotations

from .core.program import Program


def program_to_dot(program: Program, max_label: int = 40) -> str:
    """Render the op/var dataflow of block 0 as graphviz dot text."""
    lines = ["digraph G {", "  rankdir=TB;",
             '  node [shape=box, fontsize=10];']
    blk = program.global_block()
    var_ids = {}  # deterministic, collision-free node ids

    def vid_of(name):
        if name not in var_ids:
            var_ids[name] = f"var_{len(var_ids)}"
        return var_ids[name]

    for i, op in enumerate(blk.ops):
        op_id = f"op_{i}"
        lines.append(f'  {op_id} [label="{op.type}", style=filled, fillcolor="#d5e8ff"];')
        for name in op.input_names():
            new = name not in var_ids
            vid = vid_of(name)
            if new:
                v = blk._find_var_recursive(name)
                shape = getattr(v, "shape", None)
                label = f"{name[:max_label]}\\n{shape}" if v is not None else name[:max_label]
                fill = "#ffe6cc" if v is not None and v.persistable else "#eeeeee"
                lines.append(f'  {vid} [label="{label}", shape=ellipse, style=filled, fillcolor="{fill}"];')
            lines.append(f"  {vid} -> {op_id};")
        for name in op.output_names():
            new = name not in var_ids
            vid = vid_of(name)
            if new:
                lines.append(f'  {vid} [label="{name[:max_label]}", shape=ellipse];')
            lines.append(f"  {op_id} -> {vid};")
    lines.append("}")
    return "\n".join(lines)


def draw_block_graphviz(block, path: str = "program.dot", **kw):
    dot = program_to_dot(block.program if hasattr(block, "program") else block)
    with open(path, "w") as f:
        f.write(dot)
    return path


def program_summary(program: Program) -> str:
    """Text dump (reference debugger.pprint_program_codes analog)."""
    out = []
    for b in program.blocks:
        out.append(f"block {b.idx} (parent {b.parent_idx}): "
                   f"{len(b.ops)} ops, {len(b.vars)} vars")
        for op in b.ops:
            ins = {s: v for s, v in op.inputs.items()}
            outs = {s: v for s, v in op.outputs.items()}
            out.append(f"  {op.type}: {ins} -> {outs}")
    return "\n".join(out)
