"""Analytic cost of a Program from its IR (a copy of ``analytic_cost`` in
``paddle_tpu.observability.perf``). The pass pipeline brackets every pass
with it to report flop and byte deltas; the perf ledger export is not
ported yet."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

from ..core.dtypes import itemsize


def _var_nbytes(v, batch: Optional[int]) -> int:
    if v.shape is None:
        return 0
    shp = [int(d) if d is not None and int(d) > 0 else int(batch or 1)
           for d in v.shape]
    try:
        size = itemsize(v.dtype)
    except (TypeError, ValueError):
        size = 4
    return math.prod(shp) * size if shp else size


def analytic_cost(program, feed: Optional[Dict[str, Any]] = None) -> dict:
    """Analytic cost of one dispatch from the Program IR.

    flops: 2mnk per matmul/mul, 2·out·k²·cin per conv2d (forward),
    tripled when the program carries a backward pass (any `*_grad` op or
    `@GRAD` output). bytes: feeds + persistables (params read fwd+bwd
    and written by the update when training) + one write per op output
    whose shape is known. A deliberate lower bound.
    """
    batch = None
    for a in (feed or {}).values():
        shp = getattr(a, "shape", None)
        if shp:
            batch = int(shp[0])
            break

    blk = program.global_block()

    def shape_of(name):
        v = blk._find_var_recursive(name)
        if v is None or v.shape is None:
            return None
        # an unknown dim (-1, or None where a layer could not infer it:
        # pad / space_to_depth of a batch-free shape) is the batch
        return [int(d) if d is not None and int(d) > 0 else int(batch or 1)
                for d in v.shape]

    fwd_flops = 0.0
    out_bytes = 0.0
    has_bwd = False
    for b in program.blocks:
        for op in b.ops:
            t = op.type
            if t.endswith("_grad"):
                has_bwd = True
            if t in ("mul", "matmul", "matmul_v2"):
                xs = op.input("X") or op.input_names()[:1]
                ys = op.input("Y") or op.input_names()[1:2]
                sx = shape_of(xs[0]) if xs else None
                sy = shape_of(ys[0]) if ys else None
                if sx and sy and len(sy) >= 2:
                    fwd_flops += 2.0 * math.prod(sx[:-1]) * sx[-1] * sy[-1]
            elif t == "conv2d":
                outs = op.output("Output") or op.output_names()[:1]
                fils = op.input("Filter") or []
                so = shape_of(outs[0]) if outs else None
                sf = shape_of(fils[0]) if fils else None
                if so and sf and len(sf) == 4:
                    # filter [cout, cin, kh, kw]; out [b, cout, oh, ow]
                    fwd_flops += 2.0 * math.prod(so) * sf[1] * sf[2] * sf[3]
            for name in op.output_names():
                s = shape_of(name)
                if s:
                    v = blk._find_var_recursive(name)
                    out_bytes += _var_nbytes(v, batch) if v is not None \
                        else 0
            if any(n.endswith("@GRAD") for n in op.output_names()):
                has_bwd = True

    state_bytes = sum(_var_nbytes(v, batch) for v in program.list_vars()
                      if v.persistable)
    feed_bytes = sum(int(getattr(a, "nbytes", 0) or 0)
                     for a in (feed or {}).values())
    mult = 3.0 if has_bwd else 1.0
    bytes_accessed = (feed_bytes + state_bytes * (3.0 if has_bwd else 1.0)
                      + out_bytes)
    return {"flops": fwd_flops * mult, "bytes_accessed": bytes_accessed,
            "transcendentals": 0.0}
