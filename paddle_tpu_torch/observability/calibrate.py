"""The card's floors: measured matmul and stream rates, cached on disk.

Counterpart of ``paddle_tpu.observability.calibrate``. Two microbenches
anchor every roofline statement the runtime makes: a chain of ten
dependent 8192² bf16 matmuls for the tensor-core rate and a 256
Mi-element bf16 multiply-add chain of 20 for the memory stream rate (a
link is a multiply and an in-place add, two kernels that each read and
write the vector).
`get_calibration()` runs them once per (device kind, host) and keeps the
result in an on-disk cache, so every later process (the perf ledger, the
roofline CLI, the profile trigger) reads the same numbers.

Measurement protocol: each chain runs warm on the card inside
``torch.profiler`` sessions of its own, and its rate comes from the
sessions' device kernel events (the summed device time of the chain's
kernels; the median of three sessions that record device events, of at
most six, whose kernels account for the span between CUDA events around
the chain), not from host timers: a host clock around asynchronous
launches measures the launch queue as much as the kernels. When no
session holds, that span (the device's clock) is the time, with a
warning and ``calibrate/profiler_incomplete``. The sessions go through
the profiler's one-session guard (``profiler._guard``).

Cache location: ``PDTPU_CALIBRATION_DIR`` (default
``~/.cache/paddle_tpu_torch/calibration``), one JSON file per
``{device_kind}_{hostname}`` with the device kind from
``torch.cuda.get_device_name`` (``NVIDIA_H100_80GB_HBM3_<host>``).
`get_calibration(recalibrate=True)` bypasses both the process memo and
the disk cache and rewrites the file.

Sources, in the `Calibration.source` field:

- ``measured``    — rates from the card's kernel events
- ``fallback``    — on the card, but a chain's time came out 0: the
  datasheet's rates
- ``placeholder`` — no card (CPU): nominal rates so the roofline math
  stays finite and deterministic
- ``cache``       — loaded from disk (whatever source wrote it)

`peak_flops` on the card is the H100 SXM datasheet's dense bf16 tensor
rate (989 TFLOP/s); the fallback stream rate is its HBM3 rate
(3,350 GB/s). The field name ``on_tpu`` is the JAX package's; here it
means "on the card".
"""
from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
from dataclasses import asdict, dataclass
from typing import Optional, Tuple

__all__ = ["Calibration", "get_calibration", "measure_floors",
           "peak_flops", "cache_path", "reset",
           "H100_PEAK_BF16_FLOPS", "H100_PEAK_BYTES_PER_S"]

# NVIDIA H100 SXM5 80 GB datasheet: dense bf16 tensor-core rate, HBM3 rate
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_BYTES_PER_S = 3.35e12
_PEAK_CPU = 1e12

_FALLBACK_H100 = (H100_PEAK_BF16_FLOPS / 1e12, H100_PEAK_BYTES_PER_S / 1e9)
_PLACEHOLDER_CPU = (1.0, 10.0)     # no card: nominal rates

MM_N, MM_CHAIN = 8192, 10
STREAM_N, STREAM_CHAIN = 256 * 1024 * 1024, 20


@dataclass
class Calibration:
    """One machine's measured (or assumed) floors."""

    device_kind: str
    on_tpu: bool
    matmul_tflops: float
    stream_gbs: float
    peak_flops: float
    source: str            # "measured" | "fallback" | "placeholder" | "cache"
    measured_at: float = 0.0
    host: str = ""

    @property
    def floors(self) -> Tuple[float, float]:
        """(matmul_tflops, stream_gbs)."""
        return (self.matmul_tflops, self.stream_gbs)

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Calibration":
        return Calibration(
            device_kind=str(d["device_kind"]), on_tpu=bool(d["on_tpu"]),
            matmul_tflops=float(d["matmul_tflops"]),
            stream_gbs=float(d["stream_gbs"]),
            peak_flops=float(d["peak_flops"]), source=str(d["source"]),
            measured_at=float(d.get("measured_at", 0.0)),
            host=str(d.get("host", "")))


def peak_flops(on_card: bool) -> float:
    return H100_PEAK_BF16_FLOPS if on_card else _PEAK_CPU


def _device_kind() -> Tuple[str, bool]:
    """(device kind, on the card): the card's name from
    ``torch.cuda.get_device_name``, or ``cpu``."""
    import torch

    if torch.cuda.is_available():
        return str(torch.cuda.get_device_name(0)), True
    return "cpu", False


def _cache_dir() -> str:
    return (os.environ.get("PDTPU_CALIBRATION_DIR")
            or os.path.expanduser("~/.cache/paddle_tpu_torch/calibration"))


def cache_path(device_kind: Optional[str] = None,
               host: Optional[str] = None) -> str:
    """Cache file for this (device kind, host): one floor set per machine,
    shared by every process on it."""
    if device_kind is None:
        device_kind, _ = _device_kind()
    host = host or socket.gethostname()
    key = re.sub(r"[^A-Za-z0-9._-]", "_", f"{device_kind}_{host}")
    return os.path.join(_cache_dir(), f"{key}.json")


def _session_us(fn):
    """One ``torch.profiler`` session around one call of fn: (the summed
    device time of its kernel events, the device time between two CUDA
    events around the call), both in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import profiler as session

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with session._guard("calibrate.measure_floors"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        for attr in ("device_time_total", "cuda_time_total"):
            if hasattr(evt, attr):
                total += float(getattr(evt, attr))
                break
    return total, start.elapsed_time(end) * 1e3


def _device_us(fn, name: str) -> float:
    """Device us of one call of fn: the median of the first three sessions
    whose kernel events account for the call, of at most six. A chain's
    kernels run back to back, so their summed time is the span between
    CUDA events around them less the launch gaps: a session whose kernels
    add up to under 0.8 of that span, or over it, lost or misread events
    (sessions have come back with none, or a part, on the card). When no
    session holds, the CUDA events' span is the time, logged and counted
    in ``calibrate/profiler_incomplete``."""
    import statistics

    reads, spans = [], []
    for _ in range(6):
        us, span = _session_us(fn)
        spans.append(span)
        if 0.8 * span <= us <= 1.02 * span:
            reads.append(us)
        else:
            logger.warning("calibration: a profiler session of the %s chain "
                           "recorded %.1f us of kernels in a %.1f us span",
                           name, us, span)
        if len(reads) == 3:
            break
    if reads:
        return float(statistics.median(reads))
    from .registry import get_registry

    get_registry().counter("calibrate/profiler_incomplete",
                           chain=name).inc()
    logger.warning("calibration: no profiler session of the %s chain held; "
                   "timing it by CUDA events", name)
    return float(statistics.median(spans))


def measure_floors(on_card: bool) -> Tuple[float, float, str]:
    """Run the two microbenches and return
    (matmul_tflops, stream_gbs, source).

    Off the card: placeholder rates without dispatching anything."""
    if not on_card:
        return (*_PLACEHOLDER_CPU, "placeholder")
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = (torch.randn(MM_N, MM_N, device="cuda", generator=gen)
         / MM_N ** 0.5).to(torch.bfloat16)
    x = torch.randn(STREAM_N, device="cuda", generator=gen,
                    dtype=torch.bfloat16)

    def mm_chain():
        c = a
        for _ in range(MM_CHAIN):
            c = c @ a
        return c

    def add_chain():
        # a link: c * 1.0001 into a new vector, then + 1e-3 in place; each
        # of the two elementwise kernels reads and writes the whole vector
        c = x
        for _ in range(STREAM_CHAIN):
            c = c.mul(1.0001).add_(1e-3)
        return c

    mm_chain(), add_chain()            # warm: cuBLAS heuristics, allocator
    torch.cuda.synchronize()
    mm_us = _device_us(mm_chain, "matmul")
    stream_us = _device_us(add_chain, "stream")
    del x
    if not mm_us or not stream_us:
        return (*_FALLBACK_H100, "fallback")
    mm_rate = MM_CHAIN * 2 * MM_N ** 3 / (mm_us * 1e-6)
    stream = STREAM_CHAIN * 2 * (2 * STREAM_N * 2) / (stream_us * 1e-6)
    return mm_rate / 1e12, stream / 1e9, "measured"


logger = logging.getLogger("paddle_tpu_torch.observability.calibrate")

_lock = threading.Lock()
_memo: Optional[Calibration] = None


def reset() -> None:
    """Drop the in-process memo (tests; does not touch the disk cache)."""
    global _memo
    with _lock:
        _memo = None


def get_calibration(recalibrate: bool = False) -> Calibration:
    """THE calibration for this machine: process memo → disk cache →
    fresh measurement (which also writes the cache). `recalibrate=True`
    bypasses memo and cache and rewrites the file."""
    global _memo
    with _lock:
        if _memo is not None and not recalibrate:
            return _memo
        kind, on_card = _device_kind()
        path = cache_path(kind)
        if not recalibrate:
            cached = _load(path, kind)
            if cached is not None:
                _memo = cached
                return _memo
        mm, stream, source = measure_floors(on_card)
        calib = Calibration(
            device_kind=kind, on_tpu=on_card, matmul_tflops=float(mm),
            stream_gbs=float(stream), peak_flops=peak_flops(on_card),
            source=source, measured_at=time.time(),
            host=socket.gethostname())
        _store(path, calib)
        _memo = calib
        return _memo


def _load(path: str, device_kind: str) -> Optional[Calibration]:
    try:
        with open(path) as f:
            d = json.load(f)
        if d.get("device_kind") != device_kind:
            return None
        c = Calibration.from_dict(d)
        c.source = "cache"
        return c
    except Exception:
        return None


def _store(path: str, calib: Calibration) -> None:
    # best-effort: an unwritable cache dir must never fail a run
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(calib.to_dict(), f, indent=1)
        os.replace(tmp, path)
    except Exception:
        pass
