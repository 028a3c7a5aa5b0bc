"""Ahead-of-serve warmup: every (feed signature x bucket) once.

Reference analog: serving deployments of the reference framework warmed
AnalysisPredictor by replaying recorded requests before opening the RPC
port. The port has no compile to hide, but the first call at a shape
still pays one-time costs (cuBLAS and cuDNN handles and heuristics, the
kernel libraries' load, the caching allocator's growth), a tail-latency
cliff no deployment should leak to users. Since the batcher confines every
dispatch to a fixed bucket set, the whole shape space is finite and
enumerable, so run ALL of it before taking traffic. The predictor records
the feed signatures it has served (``Predictor._cache``, where the JAX
package keeps its executables), which is how a warmup tells a first run
from a repeat.
"""
from __future__ import annotations

import numpy as np

from typing import Dict, Optional, Sequence

from ..core.dtypes import dtype_str
from .batcher import DEFAULT_BUCKETS

__all__ = ["warmup"]


def _example_rows(predictor, example_feed):
    """One example row (no batch dim) per feed name: taken from
    `example_feed` when given, else derived from the program's feed var
    shapes with dynamic dims defaulted to 1."""
    rows: Dict[str, np.ndarray] = {}
    blk = predictor._program.global_block()
    for name in predictor.get_input_names():
        if example_feed is not None and name in example_feed:
            ex = np.asarray(example_feed[name])
            rows[name] = ex[0] if ex.ndim else ex
            continue
        var = blk._find_var_recursive(name)
        if var is None:
            raise ValueError(f"warmup: feed var {name!r} not in program and "
                             f"no example_feed row given")
        shape = [1 if int(d) < 0 else int(d) for d in var.shape[1:]]
        rows[name] = np.zeros(shape, np.dtype(dtype_str(var.dtype)))
    return rows

def warmup(predictor, buckets: Sequence[int] = DEFAULT_BUCKETS,
           example_feed: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """Run the predictor once at every bucket of the feed signature.

    `example_feed` (optional) supplies per-example shapes/dtypes for feeds
    with dynamic non-batch dims — pass one real request's feed (leading
    batch dim included); only row 0 is used. Feeds absent from it fall
    back to the program's declared var shapes.

    Returns {"buckets", "compiled", "cached", "signature"}: `compiled`
    counts buckets whose signature the predictor had not served before
    (the JAX package's name for them), `cached` the ones it had (warmup is
    idempotent).
    """
    rows = _example_rows(predictor, example_feed)
    compiled = 0
    cached = 0
    sig = None
    for b in sorted(set(int(x) for x in buckets)):
        feed = {k: np.broadcast_to(v, (b,) + v.shape).copy()
                for k, v in rows.items()}
        before = len(predictor._cache)
        predictor.run_padded(feed, b)
        sig = sig or tuple(sorted(
            (k, tuple(v.shape[1:]), str(v.dtype)) for k, v in feed.items()))
        if len(predictor._cache) > before:
            compiled += 1
        else:
            cached += 1
    return {"buckets": tuple(sorted(set(int(x) for x in buckets))),
            "compiled": compiled, "cached": cached, "signature": sig}
