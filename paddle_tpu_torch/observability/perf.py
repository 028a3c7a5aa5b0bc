"""Perf-attribution ledger: per-(program, signature) cost accounting.

Counterpart of ``paddle_tpu.observability.perf``. At a plan's first run
the dispatch sites (`Executor.run` and the `CompiledProgram`s it drives,
one device or a mesh; `Executor.run_batched`/`train_scanned`;
`Predictor.run`) register what one dispatch costs, in preference order:

1. **counted** (where the JAX package reads XLA's ``cost_analysis``): the
   first run of the plan runs under `counting()`, a ``TorchDispatchMode``
   that counts every aten op the dispatch issues — flops by
   ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
   attention), bytes as each op's tensor inputs plus outputs (XLA's
   per-HLO ``bytes accessed`` rule; views and allocations move nothing) —
   plus the flops and bytes the hand kernels declare for their launches
   (`kernel_counts.declare`: their C calls are invisible to the mode).
   Elementwise flops are not counted, as flop_counter does not count them.
2. **analytic**: matmul / conv flops walked from the Program IR (×3 when
   the program carries a backward pass) plus a state/feed byte count, when
   the count is off or came out empty.

At dispatch time `StepProfiler.record` joins each wall time with the
ledger entry and the card's floors from
:mod:`~paddle_tpu_torch.observability.calibrate`, setting live gauges:

- ``perf/achieved_tflops{program,sig}``
- ``perf/achieved_gbs{program,sig}``
- ``perf/mfu{program,sig}``         (vs the card's peak flops)
- ``perf/roofline_fraction{program,sig}`` (vs max(matmul, stream) floor)

The count runs once per plan, inside the plan's first (compiling) run, so
its cost lands in ``executor/compile_ms``; a replayed step registers
nothing. On a mesh each rank registers its own dispatch (its share of the
work), as XLA's count is per device.

``PDTPU_PERF_LEDGER=0`` disables registration and dispatch-time
attribution entirely; ``PDTPU_PERF_TRACE_COST=0`` skips the count (the
analytic walk stands in). A count that fails is counted in
``perf/count_errors`` and logged, and the dispatch runs on.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import math
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from . import calibrate
from .registry import get_registry

__all__ = ["ProgramCost", "CostLedger", "get_ledger", "attribute",
           "analytic_cost", "counting", "enabled", "trace_cost_enabled"]

logger = logging.getLogger("paddle_tpu_torch.observability.perf")

_MAX_ENTRIES = 256


def enabled() -> bool:
    return os.environ.get("PDTPU_PERF_LEDGER", "1") != "0"


def trace_cost_enabled() -> bool:
    return enabled() and os.environ.get("PDTPU_PERF_TRACE_COST", "1") != "0"


@dataclass
class ProgramCost:
    """What ONE dispatch costs. For scan dispatches (`steps` > 1) the
    numbers cover all `steps` steps."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    peak_bytes: Optional[int] = None
    source: str = "none"               # "counted" | "analytic"
    steps: int = 1
    label: Optional[str] = None
    kernels: Dict[str, dict] = field(default_factory=dict)
    last: Dict[str, float] = field(default_factory=dict)  # last attribution

    def to_dict(self) -> dict:
        d = {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
             "transcendentals": self.transcendentals,
             "peak_bytes": self.peak_bytes, "source": self.source,
             "steps": self.steps}
        if self.label:
            d["label"] = self.label
        if self.kernels:
            d["kernels"] = {k: dict(v) for k, v in self.kernels.items()}
        if self.last:
            d["last"] = dict(self.last)
        return d


# -- the counted source --------------------------------------------------------

def _count_mode_cls():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    class _CountMode(TorchDispatchMode):
        """Counts the flops and bytes of every aten op run under it."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.ops = 0
            self.errors = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            try:
                self._count(func, args, kwargs, out)
            except Exception:      # a count that fails must not fail a step
                self.errors += 1
            return out

        def _count(self, func, args, kwargs, out):
            name = func.__name__
            if getattr(func, "is_view", False) or name.startswith(
                    ("empty", "new_empty", "_local_scalar_dense")):
                return
            self.ops += 1
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            nbytes = 0
            for t in tree_flatten((args, kwargs))[0] + tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    nbytes += t.numel() * t.element_size()
            self.bytes += nbytes

    return _CountMode


class _Counted:
    """The result of a `counting()` block."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels: Dict[str, dict] = {}
        self.ops = 0
        self.errors = 0

    def cost(self) -> Optional[dict]:
        if self.flops <= 0.0 and self.bytes_accessed <= 0.0:
            return None
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "transcendentals": 0.0, "kernels": self.kernels}


@contextlib.contextmanager
def counting():
    """Count one dispatch: yields a `_Counted` whose numbers are final when
    the block exits. Aten ops by flop_counter's formulas and their tensor
    bytes, plus the hand kernels' declarations."""
    from . import kernel_counts

    res = _Counted()
    try:
        mode = _count_mode_cls()()
    except Exception:
        logger.warning("perf ledger: no aten count", exc_info=True)
        mode = None
        res.errors += 1
    with kernel_counts.collect() as declared:
        with (mode if mode is not None else contextlib.nullcontext()):
            yield res
    if mode is not None:
        res.ops, res.errors = mode.ops, mode.errors
        res.flops, res.bytes_accessed = mode.flops, mode.bytes
    try:
        res.kernels = declared.totals()
    except Exception:
        res.errors += 1
        res.kernels = {}
    for k in res.kernels.values():
        res.flops += k["flops"]
        res.bytes_accessed += k["bytes"]
    if res.errors:
        get_registry().counter("perf/count_errors").inc(res.errors)
        logger.warning("perf ledger: %d aten ops could not be counted",
                       res.errors)


# -- the analytic source -------------------------------------------------------

def _var_nbytes(v, batch: Optional[int]) -> int:
    from ..core.dtypes import itemsize

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
    whose shape is known. A deliberate lower bound: attention's products
    (a ``flash_attention`` op, not a matmul) are not counted.
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


# -- attribution -------------------------------------------------------------

def attribute(*, flops: float = 0.0, bytes_accessed: float = 0.0,
              seconds: float, calib: Optional[calibrate.Calibration] = None
              ) -> dict:
    """Join a cost with a wall time against the calibrated floors.

    Returns achieved_tflops / achieved_gbs / mfu / roofline_fraction /
    bound. roofline_fraction is floor_time/actual_time where the floor is
    max(flops at the measured matmul rate, bytes at the measured stream
    rate); it is NOT capped at 1.0 here: the counted bytes are each op's
    inputs and outputs, and a read the L2 cache serves counts as a byte
    moved, so an honest fraction can exceed unity.
    """
    calib = calib or calibrate.get_calibration()
    seconds = max(float(seconds), 1e-12)
    tfs = flops / seconds / 1e12
    gbs = bytes_accessed / seconds / 1e9
    mm_s = flops / (calib.matmul_tflops * 1e12)
    st_s = bytes_accessed / (calib.stream_gbs * 1e9)
    floor_s = max(mm_s, st_s)
    return {
        "achieved_tflops": tfs,
        "achieved_gbs": gbs,
        "mfu": flops / seconds / calib.peak_flops,
        "roofline_fraction": floor_s / seconds,
        "bound": "matmul" if mm_s >= st_s else "memory",
    }


# -- the ledger --------------------------------------------------------------

def _pkey(program_id) -> str:
    if isinstance(program_id, str):
        return program_id
    return f"0x{program_id:x}"


class CostLedger:
    """Bounded map (program, sig) → :class:`ProgramCost`, with
    dispatch-time attribution into the registry."""

    def __init__(self, registry=None, max_entries: int = _MAX_ENTRIES):
        self._reg = registry
        self._max = int(max_entries)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, ProgramCost]" = \
            collections.OrderedDict()
        self._pass_reports: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._dump_registered = False
        self._pass_dump_registered = False

    def _registry(self):
        return self._reg if self._reg is not None else get_registry()

    # -- registration (a plan's first run) --------------------------------
    def register(self, program_id, sig: Optional[str], *,
                 counted: Optional[dict] = None, program=None,
                 feed: Optional[Dict[str, Any]] = None,
                 steps: int = 1, label: Optional[str] = None
                 ) -> Optional[ProgramCost]:
        """Record what one dispatch costs: `counted` (a `counting()`
        result's ``cost()``, covering all `steps`) first, then the analytic
        IR walk; registers nothing when both come up empty or the ledger
        is disabled. Never raises: a cost-model failure must not break a
        dispatch site."""
        if not enabled():
            return None
        try:
            cost = dict(counted) if counted else None
            if cost is not None:
                source = "counted"
            elif program is not None:
                cost = analytic_cost(program, feed)
                source = "analytic"
                if steps > 1:
                    # analytic counts ONE step; a scan dispatch runs K
                    cost = {k: v * steps for k, v in cost.items()}
            else:
                return None
            if cost["flops"] <= 0.0 and cost["bytes_accessed"] <= 0.0:
                return None
            entry = ProgramCost(
                flops=cost["flops"], bytes_accessed=cost["bytes_accessed"],
                transcendentals=cost.get("transcendentals", 0.0),
                source=source, steps=int(steps), label=label,
                kernels=cost.get("kernels") or {})
            with self._lock:
                self._entries[(_pkey(program_id), sig)] = entry
                while len(self._entries) > self._max:
                    self._entries.popitem(last=False)
                if not self._dump_registered:
                    self._dump_registered = True
                    try:
                        from .flight import register_dump_section
                        register_dump_section("perf_ledger", self.snapshot)
                    except Exception:
                        pass
            return entry
        except Exception:
            return None

    def get(self, program_id, sig: Optional[str]) -> Optional[ProgramCost]:
        with self._lock:
            return self._entries.get((_pkey(program_id), sig))

    # -- pass attribution (from ir.PassPipeline) ---------------------------
    def record_passes(self, label: str, report: dict) -> None:
        """Record one PassPipeline run: the per-pass cost-delta report
        keyed by the program label, exported as ``ir/pass_*`` gauges and
        the ``ir_passes`` flight-dump section. Never raises."""
        if not enabled():
            return
        try:
            with self._lock:
                self._pass_reports[label] = report
                while len(self._pass_reports) > self._max:
                    self._pass_reports.popitem(last=False)
                if not self._pass_dump_registered:
                    self._pass_dump_registered = True
                    try:
                        from .flight import register_dump_section
                        register_dump_section("ir_passes", self.pass_reports)
                    except Exception:
                        pass
            reg = self._registry()
            for rec in report.get("passes", ()):
                labels = {"program": label, "ir_pass": rec["pass"]}
                reg.gauge("ir/pass_flops_delta", **labels).set(
                    rec.get("flops_delta", 0.0))
                reg.gauge("ir/pass_bytes_delta", **labels).set(
                    rec.get("bytes_delta", 0.0))
                reg.gauge("ir/pass_ops_removed", **labels).set(
                    rec.get("ops_before", 0) - rec.get("ops_after", 0))
        except Exception:
            pass

    def pass_reports(self) -> dict:
        """label → the PassPipeline report recorded for that program."""
        with self._lock:
            return {k: dict(v) for k, v in self._pass_reports.items()}

    # -- attribution (dispatch time) ---------------------------------------
    def on_dispatch(self, program_id, sig: Optional[str], wall_ms: float,
                    steps: int = 1) -> Optional[dict]:
        """Attribute one non-compiling dispatch of `steps` steps against
        its ledger entry (scaled by steps over the entry's steps); sets the
        live ``perf/*`` gauges and returns the attribution (or None when
        there is no entry)."""
        if not enabled():
            return None
        entry = self.get(program_id, sig)
        if entry is None or wall_ms <= 0.0:
            return None
        scale = max(int(steps), 1) / max(entry.steps, 1)
        try:
            att = attribute(flops=entry.flops * scale,
                            bytes_accessed=entry.bytes_accessed * scale,
                            seconds=wall_ms / 1e3)
        except Exception:
            return None
        entry.last = {k: round(v, 6) for k, v in att.items()
                      if isinstance(v, float)}
        reg = self._registry()
        labels = {"program": _pkey(program_id)}
        if sig is not None:
            labels["sig"] = sig
        reg.gauge("perf/achieved_tflops", **labels).set(
            att["achieved_tflops"])
        reg.gauge("perf/achieved_gbs", **labels).set(att["achieved_gbs"])
        reg.gauge("perf/mfu", **labels).set(att["mfu"])
        reg.gauge("perf/roofline_fraction", **labels).set(
            att["roofline_fraction"])
        return att

    def annotate_record(self, rec: dict) -> None:
        """StepProfiler hook: join a step record with its ledger entry —
        non-compile records gain ``achieved_tflops`` (plus ``mfu`` when
        the entry has real flops) and the gauges update. Mutates `rec`
        in place; never raises."""
        if rec.get("compile") or "program" not in rec:
            return
        try:
            att = self.on_dispatch(rec["program"], rec.get("sig"),
                                   float(rec.get("wall_ms", 0.0)),
                                   steps=int(rec.get("steps_in_dispatch", 1)))
        except Exception:
            return
        if att is None:
            return
        rec["achieved_tflops"] = round(att["achieved_tflops"], 4)
        if att["mfu"] > 0.0:
            rec["mfu"] = round(att["mfu"], 4)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        """Flight-dump / debug view: every entry with its last
        attribution."""
        with self._lock:
            return {f"{p} {s or ''}".strip(): e.to_dict()
                    for (p, s), e in self._entries.items()}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pass_reports.clear()


_ledger = CostLedger()


def get_ledger() -> CostLedger:
    """THE process-wide cost ledger the dispatch sites register into."""
    return _ledger


# -- dispatch-site helpers -----------------------------------------------------

@contextlib.contextmanager
def count_first_run(compiling: bool):
    """Around a dispatch: a `counting()` block on a plan's first run when
    the count is on, else nothing. Yields the `_Counted` or None."""
    if not (compiling and trace_cost_enabled()):
        yield None
        return
    with counting() as res:
        yield res
