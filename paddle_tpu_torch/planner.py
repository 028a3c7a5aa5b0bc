"""Device-memory budget planner (the port's counterpart of
``paddle_tpu.planner``).

A device OOM is a bare ``CUDA out of memory`` that arrives after the model
is built and the first step is under way — an expensive way to learn that
a config does not fit. This module makes the decision first: it walks a
ladder of (sharding stage, remat policy, microbatch K) candidates from
cheapest-to-run to most-memory-frugal, estimates each one's per-device
footprint, and picks the first that fits a configurable budget.

Estimation. The JAX package compiles each candidate against shape
structs and reads XLA's ``memory_analysis()``. Eager torch has no such
compile, so the port measures:

- every candidate is first bounded by its analytic bytes (the JAX
  package's lower bound: state at its ZeRO layout, one gradient set,
  sharded from stage 2, and the feeds); a candidate whose bound is over
  the budget is never run and keeps ``source="analytic"``;
- any other candidate runs two steps of its ``CompiledProgram`` in a
  throwaway scope whose state is zeros of each persistable's shape and
  dtype (the caller's scope is never touched), under ``_PeakBytes``, a
  ``TorchDispatchMode`` that tracks every storage an op returns on the
  step's device (a weak finalizer per storage) and the state the steps
  start from, and keeps the peak of the live bytes over the second step:
  ``source="measured"``. It works alike on the CPU and the card. On a
  mesh every rank measures its own step and the plan takes the largest
  (one all-reduce over the group); ``plan_for`` is then collective;
- a candidate whose step runs out of device memory
  (``torch.cuda.OutOfMemoryError``, caught and nothing else) does not fit:
  the throwaway scope is dropped and the allocator's cache emptied, the
  error goes into ``plan.error``, and its estimate is the most bytes seen
  live before the failure, lifted over the budget; the ladder goes on.
  On a mesh the same all-reduce carries a failed flag, so every rank
  takes the same branch. (A rank that fails before a collective of the
  step that the others then wait in is not recovered: the ranks of one
  data-parallel step hold the same shapes and fail at the same op.)

The measured bytes are what the step's ops hold; the allocator's own
slack (its rounding and cached blocks) and library workspaces (cuBLAS)
are not ops' outputs, so ``torch.cuda.max_memory_allocated`` of the same
step reads somewhat higher.

The decision is observable: registry gauges (``planner/*``), a
flight-recorder event, and a ``hbm_plan`` forensic dump section so a
later OOM post-mortem shows what the planner believed. When nothing fits,
`plan_for` raises `HbmBudgetError` naming the best-found plan.

Reference analog: the reference framework's ``memory_optimize`` transpiler
pass reused variable memory by liveness analysis at graph-build time; here
the "fit the device" decision is made over whole-config candidates
(sharding/remat/microbatching).
"""
from __future__ import annotations

import gc
import os
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "Plan",
    "HbmBudgetError",
    "default_candidates",
    "resolve_budget_bytes",
    "estimate_plan",
    "plan_for",
    "plan_for_footprint",
    "guard",
    "last_plan",
]

# remat policy -> gauge value (gauges are numeric; the event carries the
# string)
_REMAT_GAUGE = {"none": 0, "minimal": 1, "full": 2}


@dataclass
class Plan:
    """One (sharding stage, remat policy, microbatch K) point, plus what
    the planner learned about it."""

    stage: int = 0
    remat: str = "none"
    microbatch: int = 1
    est_bytes_per_device: Optional[int] = None
    budget_bytes: Optional[int] = None
    source: str = "unevaluated"  # "measured" | "analytic" | "unconstrained"
    fits: Optional[bool] = None
    error: Optional[str] = None
    # the JAX package reads XLA's predicted cost here; eager torch has no
    # cost model, so these stay None in the port
    predicted_flops: Optional[float] = None
    predicted_bytes_accessed: Optional[float] = None

    def describe(self) -> str:
        est = ("?" if self.est_bytes_per_device is None
               else _fmt_bytes(self.est_bytes_per_device))
        return (f"stage{self.stage}/remat={self.remat}/K={self.microbatch}"
                f" (~{est}/device, {self.source})")

    def to_dict(self) -> dict:
        return {"stage": self.stage, "remat": self.remat,
                "microbatch": self.microbatch,
                "est_bytes_per_device": self.est_bytes_per_device,
                "budget_bytes": self.budget_bytes,
                "source": self.source, "fits": self.fits,
                "error": self.error,
                "predicted_flops": self.predicted_flops,
                "predicted_bytes_accessed": self.predicted_bytes_accessed}


class HbmBudgetError(RuntimeError):
    """No candidate fits the memory budget (or a guarded run still OOMed).
    Carries the best plan found and every candidate's estimate, so the
    caller can print a table instead of a stack trace."""

    def __init__(self, message: str, plan: Optional[Plan] = None,
                 candidates: Sequence[Plan] = ()):
        super().__init__(message)
        self.plan = plan
        self.candidates = list(candidates)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.2f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n}B"


def default_candidates(batch: Optional[int] = None,
                       dp: int = 1) -> List[Plan]:
    """The escalation ladder, cheapest step first: turn on ZeRO stages
    before remat (sharding moves bytes, remat re-burns flops), and only
    then split the batch. Microbatch candidates keep the per-step batch
    divisible by both K and dp."""
    plans = [Plan(0, "none", 1), Plan(1, "none", 1), Plan(2, "none", 1),
             Plan(3, "none", 1), Plan(3, "minimal", 1), Plan(3, "full", 1)]
    for k in (2, 4, 8):
        if batch is not None and (batch % k or (batch // k) % max(dp, 1)):
            continue
        plans.append(Plan(3, "full", k))
    return plans


def resolve_budget_bytes(place=None) -> Optional[int]:
    """Budget in bytes, or None when unconstrained (the CPU has no
    allocator stats). ``PDTPU_HBM_BUDGET`` (bytes) overrides; otherwise
    ``PDTPU_HBM_BUDGET_FRACTION`` (default 0.9) of the card's memory
    (`place`'s card, ``CUDAPlace(0)``'s by default) — the headroom covers
    the allocator's slack and the libraries' workspaces."""
    env = os.environ.get("PDTPU_HBM_BUDGET")
    if env:
        return int(float(env))
    from .observability.memory import device_memory_stats
    device = place.torch_device() if place is not None else None
    stats = device_memory_stats(device)
    if not stats or not stats.get("bytes_limit"):
        return None
    frac = float(os.environ.get("PDTPU_HBM_BUDGET_FRACTION", "0.9"))
    return int(stats["bytes_limit"] * frac)


def _compiled_for(program, loss_name: str, plan: Plan):
    from .core.compiler import BuildStrategy, CompiledProgram
    bs = BuildStrategy()
    bs.sharding_strategy = plan.stage
    bs.remat_policy = plan.remat
    return CompiledProgram(program).with_data_parallel(
        loss_name=loss_name, build_strategy=bs)


def _feed_with_microbatch(feed: Dict[str, np.ndarray], k: int):
    if k <= 1:
        return feed
    out = {}
    for n, a in feed.items():
        a = np.asarray(a)
        if a.ndim and a.shape[0] % k == 0:
            a = a[: a.shape[0] // k]
        out[n] = a
    return out


class _PeakBytes(TorchDispatchMode):
    """Live storage bytes on one device, and their peak: every storage an
    op returns there (and each one `track` is given) counts from its first
    sight until its finalizer runs."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._on = True

    def _free(self, key, n):
        if self._on and key in self._seen:
            self._seen.discard(key)
            self.live -= n

    def track(self, t):
        if hasattr(t, "to_local") and type(t) is not torch.Tensor:
            t = t.to_local()  # a DTensor: its rank's shard
        if not isinstance(t, torch.Tensor) or t.device != self.device:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        key = st.data_ptr()
        if not n or key in self._seen:
            return
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out

    def __exit__(self, *exc):
        self._on = False
        return super().__exit__(*exc)


def _zero_state(program, scope, device):
    """A zero of each persistable's shape and dtype in `scope`, whole on
    `device` (the mesh step lays them out at its first run)."""
    from .core.dtypes import convert_dtype

    for v in program.list_vars():
        if not v.persistable or any(int(d) < 0 for d in (v.shape or ())):
            continue
        scope.set_var(v.name, torch.zeros(
            tuple(int(d) for d in (v.shape or ())),
            dtype=convert_dtype(v.dtype), device=device))


def _state_leaves(program, scope):
    from .core.mesh_step import StageValue

    out = []
    for v in program.list_vars():
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if isinstance(val, StageValue):
            val = val.local
        if isinstance(val, torch.Tensor):
            out.append(val)
    return out


def _steps_peak(mode, program, cp, feed, loss_name, exe):
    """Two steps of `cp` in a throwaway scope of zeros under `mode`; the
    peak is the second step's (the scope dies with this frame)."""
    from .core.scope import Scope

    scope = Scope()
    _zero_state(program, scope, exe.device)
    for t in _state_leaves(program, scope):
        mode.track(t)
    exe.run(cp, feed=feed, fetch_list=[loss_name], scope=scope,
            return_numpy=False)
    mode.peak = mode.live
    exe.run(cp, feed=feed, fetch_list=[loss_name], scope=scope,
            return_numpy=False)


def _measured_bytes(cp, program, feed, loss_name: str, place):
    """(bytes, error) of `cp`: this rank's peak live bytes over one steady
    step (the second of two, in a throwaway scope of zeros) and None; or,
    when the steps ran out of device memory, the most bytes seen live
    before that and the error's text. On a mesh both are the group's
    (the largest bytes; an error when any rank failed)."""
    from .core.executor import Executor

    exe = Executor(place)
    error = None
    with _PeakBytes(exe.device) as mode:
        try:
            _steps_peak(mode, program, cp, feed, loss_name, exe)
        except torch.cuda.OutOfMemoryError as e:
            error = f"{type(e).__name__}: {e}"[:300]
        peak = mode.peak
    if error is not None:  # the failed step's tensors, then the cache
        gc.collect()
        if exe.device.type == "cuda":
            torch.cuda.empty_cache()
    if cp._mesh is not None:
        import torch.distributed as dist

        t = torch.tensor([peak, error is not None], dtype=torch.int64,
                         device=exe.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        peak = int(t[0].item())
        if t[1].item() and error is None:
            error = "OutOfMemoryError on another rank of the group"
    return int(peak), error


def _analytic_bytes(cp, program, feed) -> int:
    """Shard-aware lower bound: state (params + accumulators) at their
    planned shardings, one gradient set (sharded from stage 2), and the
    feeds. Activations are deliberately NOT guessed — this is a lower
    bound and the plan says `analytic`."""
    from .core.dtypes import itemsize

    dp = 1
    if cp._mesh is not None and cp._data_axis is not None:
        dp = cp._dp_size()
    state = 0
    grads = 0
    for v in program.list_vars():
        if not v.persistable or any(int(d) < 0 for d in (v.shape or ())):
            continue
        nbytes = int(np.prod([int(d) for d in v.shape]) * itemsize(v.dtype))
        factor = dp if cp._zero_plan(v) is not None else 1
        state += nbytes // factor
        if getattr(v, "trainable", False):
            gfactor = dp if cp._zero_stage() >= 2 else 1
            grads += nbytes // gfactor
    feeds = sum(np.asarray(a).nbytes // max(dp, 1) for a in feed.values())
    return state + grads + feeds


def estimate_plan(plan: Plan, program, feed, loss_name: str,
                  place=None) -> Plan:
    """Fill in `est_bytes_per_device` + `source` for one candidate: its
    analytic bound when that is already over ``plan.budget_bytes``, else
    its measured step, with `predicted_flops` and
    `predicted_bytes_accessed` from the perf ledger's count of the step's
    first run; a step that ran out of device memory sets ``error`` and
    ``fits=False``, its estimate over the budget. `place`:
    where the step runs (``CUDAPlace(0)`` unless the caller passes
    another)."""
    from .core.executor import CUDAPlace

    place = place or CUDAPlace(0)
    mfeed = _feed_with_microbatch(feed, plan.microbatch)
    cp = _compiled_for(program, loss_name, plan)
    bound = _analytic_bytes(cp, program, mfeed)
    if plan.budget_bytes is not None and bound > plan.budget_bytes:
        plan.est_bytes_per_device = bound
        plan.source = "analytic"
        return plan
    from .observability import perf

    before = perf.get_ledger().snapshot()
    est, plan.error = _measured_bytes(cp, program, mfeed, loss_name, place)
    # the measured steps' first run registered its cost in the ledger (and
    # the second attributed it): the entry of this program that changed
    mine = f"0x{id(program):x}"
    for key, entry in perf.get_ledger().snapshot().items():
        if key.split(" ")[0] == mine and entry != before.get(key):
            plan.predicted_flops = entry["flops"] / entry["steps"]
            plan.predicted_bytes_accessed = (entry["bytes_accessed"]
                                             / entry["steps"])
    if cp._mesh is not None:
        # each rank counted its own dispatch: the group's largest, as the
        # byte estimate
        import torch.distributed as dist

        t = torch.tensor([plan.predicted_flops or 0.0,
                          plan.predicted_bytes_accessed or 0.0],
                         dtype=torch.float64, device=place.torch_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        flops, nbytes = t.tolist()
        plan.predicted_flops = flops or None
        plan.predicted_bytes_accessed = nbytes or None
    if plan.error is not None:  # out of memory: over any budget
        plan.fits = False
        if plan.budget_bytes is not None:
            est = max(est, plan.budget_bytes + 1)
    plan.est_bytes_per_device = est
    plan.source = "measured"
    return plan


_last_plan: Optional[Plan] = None
_last_candidates: List[Plan] = []


def last_plan() -> Optional[Plan]:
    return _last_plan


def _dump_section() -> object:
    return {"chosen": _last_plan.to_dict() if _last_plan else None,
            "candidates": [p.to_dict() for p in _last_candidates]}


def _record(plan: Plan, candidates: List[Plan], where: str) -> None:
    global _last_plan, _last_candidates
    _last_plan, _last_candidates = plan, list(candidates)
    from .observability.flight import (get_flight_recorder,
                                       register_dump_section)
    from .observability.registry import get_registry
    reg = get_registry()
    reg.gauge("planner/chosen_stage").set(plan.stage)
    reg.gauge("planner/chosen_remat").set(_REMAT_GAUGE.get(plan.remat, -1))
    reg.gauge("planner/chosen_microbatch").set(plan.microbatch)
    if plan.est_bytes_per_device is not None:
        reg.gauge("planner/est_bytes_per_device").set(
            plan.est_bytes_per_device)
    if plan.budget_bytes is not None:
        reg.gauge("planner/budget_bytes").set(plan.budget_bytes)
    register_dump_section("hbm_plan", _dump_section)
    get_flight_recorder().note_event(
        "info", "hbm_plan", where=where, **plan.to_dict())


def plan_for(program, feed: Dict[str, np.ndarray], loss_name: str,
             budget_bytes: Optional[int] = None,
             candidates: Optional[Sequence[Plan]] = None,
             where: str = "planner", place=None) -> Plan:
    """Pick the first candidate on the ladder whose estimated per-device
    bytes fit `budget_bytes` (default: `resolve_budget_bytes(place)`).
    With no budget (the CPU, or no stats and no env override) the baseline
    candidate wins unevaluated — the planner never slows down a machine
    that cannot OOM. Raises `HbmBudgetError` naming the most frugal plan
    found when nothing fits. `feed` is this rank's rows; on a process
    group every rank calls it together."""
    if budget_bytes is None:
        budget_bytes = resolve_budget_bytes(place)
    if candidates is None:
        batch = None
        for a in feed.values():
            a = np.asarray(a)
            if a.ndim:
                batch = a.shape[0]
                break
        from .parallel.env import get_world_size

        candidates = default_candidates(batch, dp=get_world_size())
    candidates = [Plan(p.stage, p.remat, p.microbatch) if p.fits is not None
                  else p for p in candidates]

    if budget_bytes is None:
        plan = candidates[0]
        plan.source = "unconstrained"
        plan.fits = True
        _record(plan, candidates, where)
        return plan

    evaluated: List[Plan] = []
    for plan in candidates:
        plan.budget_bytes = budget_bytes
        estimate_plan(plan, program, feed, loss_name, place)
        evaluated.append(plan)
        plan.fits = (plan.error is None
                     and plan.est_bytes_per_device <= budget_bytes)
        if plan.fits:
            _record(plan, evaluated, where)
            return plan

    best = min(evaluated, key=lambda p: p.est_bytes_per_device)
    _record(best, evaluated, where)
    lines = "; ".join(p.describe() for p in evaluated)
    raise HbmBudgetError(
        f"no (sharding, remat, microbatch) candidate fits the memory "
        f"budget of {_fmt_bytes(budget_bytes)}/device — best found: "
        f"{best.describe()} [{lines}]",
        plan=best, candidates=evaluated)


def plan_for_footprint(candidates: Sequence, where: str = "planner",
                       budget_bytes: Optional[int] = None) -> Plan:
    """`plan_for` for workloads that are raw tensors rather than a
    Program (op microbenches, the ring-attention bench): each candidate is
    a ``(Plan, est_bytes)`` pair with a caller-computed analytic footprint
    instead of a measured one. Picks the first fitting plan and records it
    through the same observability path (`planner/*` gauges, flight event,
    ``hbm_plan`` dump section), so a later `guard`-caught OOM names it.
    Raises `HbmBudgetError` when nothing fits."""
    if not candidates:
        raise ValueError("plan_for_footprint: empty candidate list")
    if budget_bytes is None:
        budget_bytes = resolve_budget_bytes()
    evaluated: List[Plan] = []
    for plan, est in candidates:
        plan.est_bytes_per_device = int(est)
        plan.budget_bytes = budget_bytes
        evaluated.append(plan)
        if budget_bytes is None:
            plan.source = "unconstrained"
            plan.fits = True
            _record(plan, evaluated, where)
            return plan
        plan.source = "analytic"
        plan.fits = plan.est_bytes_per_device <= budget_bytes
        if plan.fits:
            _record(plan, evaluated, where)
            return plan
    best = min(evaluated, key=lambda p: p.est_bytes_per_device)
    _record(best, evaluated, where)
    lines = "; ".join(p.describe() for p in evaluated)
    raise HbmBudgetError(
        f"{where}: no candidate footprint fits the memory budget of "
        f"{_fmt_bytes(budget_bytes)}/device — best found: "
        f"{best.describe()} [{lines}]",
        plan=best, candidates=evaluated)


class guard:
    """Context manager for the dispatch that runs a planner-chosen config:
    a residual OOM (``torch.cuda.OutOfMemoryError``, or the JAX package's
    ``RESOURCE_EXHAUSTED`` text) is re-raised as `HbmBudgetError` carrying
    the active plan and the original message, after the flight recorder
    takes its post-mortem. Other errors pass through untouched."""

    def __init__(self, where: str, plan: Optional[Plan] = None):
        self.where = where
        self.plan = plan  # None -> whatever plan is active at exit time

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None:
            return False
        from .observability.flight import get_flight_recorder, is_oom
        if not is_oom(exc):
            return False
        plan = self.plan if self.plan is not None else _last_plan
        get_flight_recorder().record_failure(
            exc, context={"where": self.where,
                          "plan": plan.to_dict() if plan else None})
        plan_txt = plan.describe() if plan else "none recorded"
        raise HbmBudgetError(
            f"{self.where}: OOM under plan {plan_txt}; {str(exc)[:500]}",
            plan=plan, candidates=_last_candidates) from exc
