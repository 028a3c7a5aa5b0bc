"""PassPipeline — the inference compiler's pass driver with attribution.

Counterpart of ``paddle_tpu.ir.pipeline`` (reference
``inference/analysis/ir_pass_manager.cc``). Every pass application is
bracketed with the analytic IR cost walk, so each pass's flop/byte delta
lands in ``program._pass_report`` (the full per-pass record list:
neutrality contract, op/var counts, flop/byte deltas, wall ms) and in the
perf ledger (`CostLedger.record_passes`): the
``ir/pass_flops_delta{program,ir_pass}`` (+ ``_bytes_delta``,
``_ops_removed``) gauges and the ``ir_passes`` flight-dump section.
"""
from __future__ import annotations

import time

from typing import Dict, List, Optional, Union

from ..core.program import Program
from .pass_base import PassBuilder, get_pass

__all__ = ["PassPipeline", "optimize_inference_program"]


def _counts(program: Program):
    n_ops = sum(len(b.ops) for b in program.blocks)
    n_vars = sum(len(b.vars) for b in program.blocks)
    return n_ops, n_vars


class PassPipeline:
    """Ordered pass run with before/after cost deltas per pass.

    ``passes`` is a name list or a :class:`PassBuilder`; ``label`` names
    the program in the report (default: the program's id). ``record``
    exports the report to `ledger` (default: the process ledger).
    """

    def __init__(self, passes: Union[PassBuilder, List[str]],
                 label: Optional[str] = None, ledger=None,
                 record: bool = True):
        if isinstance(passes, PassBuilder):
            passes = passes.all_passes()
        self.names = list(passes)
        for n in self.names:
            get_pass(n)  # validate early, before any pass mutates anything
        self.label = label
        self._ledger = ledger
        self._record = record

    def run(self, program: Program, **kw) -> Program:
        from ..observability import perf

        records: List[Dict] = []
        feed = kw.get("feed")
        cost = perf.analytic_cost(program, feed)
        for name in self.names:
            p = get_pass(name)
            ops0, vars0 = _counts(program)
            t0 = time.perf_counter()
            program = p.apply(program, **kw)
            wall_ms = (time.perf_counter() - t0) * 1e3
            after = perf.analytic_cost(program, feed)
            ops1, vars1 = _counts(program)
            records.append({
                "pass": name,
                "neutrality": getattr(p, "neutrality", "bitwise"),
                "ops_before": ops0, "ops_after": ops1,
                "vars_removed": max(0, vars0 - vars1),
                "flops_delta": after["flops"] - cost["flops"],
                "bytes_delta": after["bytes_accessed"]
                - cost["bytes_accessed"],
                "wall_ms": round(wall_ms, 3),
            })
            cost = after
        label = self.label or f"0x{id(program):x}"
        prev = getattr(program, "_pass_report", None)
        if prev is not None and prev.get("label") == label:
            # a second pipeline stage over the same program (e.g. the
            # int8 quantize stage after the base pipeline) extends the
            # report instead of clobbering it
            records = list(prev["passes"]) + records
        report = {
            "label": label,
            "passes": records,
            "ops_total_removed": sum(r["ops_before"] - r["ops_after"]
                                     for r in records),
            "flops_total_delta": sum(r["flops_delta"] for r in records),
            "bytes_total_delta": sum(r["bytes_delta"] for r in records),
        }
        program._pass_report = report
        if self._record:
            ledger = self._ledger if self._ledger is not None \
                else perf.get_ledger()
            ledger.record_passes(label, report)
        return program


def optimize_inference_program(program: Program, config=None,
                               label: Optional[str] = None,
                               scope=None,
                               fetch_names: Optional[List[str]] = None,
                               ledger=None) -> Program:
    """Run the inference pass pipeline from a Config (or the default
    pipeline when ``config`` is None) over ``program`` — the one entry
    point the Predictor uses."""
    if config is None:
        from ..inference import Config
        config = Config()
    if fetch_names is None:
        # without explicit fetches, everything the program produces but
        # nothing consumes is an output — DCE must not prune the sinks
        blk = program.global_block()
        consumed = {n for op in blk.ops for n in op.input_names()}
        fetch_names = [n for op in blk.ops for n in op.output_names()
                       if n not in consumed]
    pipeline = PassPipeline(config.pass_builder(), label=label,
                            ledger=ledger)
    return pipeline.run(program, keep=fetch_names, fetch_names=fetch_names,
                        scope=scope)
