"""Fault injection probes — the in-process part of ``paddle_tpu.faults``.

Code that must stay correct under failure calls ``fault_point(site)`` at
the place a real failure would strike (the PS tier probes ``ps.pull`` and
``ps.push``; the checkpointer ``ckpt.bundle_write``, ``ckpt.rename`` and
``ckpt.marker``, with the file's path; the
``DeviceLoader`` worker ``loader.next``). A probe is a no-op until a rule
targets its site::

    faults.install("ps.push", "raise", count=3)   # the 3rd push raises
    faults.install("ps.pull", "delay_ms", 50)     # every pull sleeps 50 ms
    faults.clear()

Actions: ``raise`` (an :class:`InjectedFault`, an ``OSError``) and
``delay_ms``. The network and process actions of the JAX package
(``drop``, ``reset``, ``crash``, ``corrupt``) and the ``PDTPU_FAULT_SPEC``
environment spec come with the socket transport and the chaos matrix
(ROADMAP A8/A9).
Each firing counts on ``faults/injected{site,action}``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .observability import get_registry

__all__ = ["InjectedFault", "install", "clear", "fault_point"]

_ACTIONS = ("raise", "delay_ms")


class InjectedFault(OSError):
    """Raised by the ``raise`` action: an ``OSError``, so retry paths
    cannot tell it from a real I/O failure."""


class _Rule:
    __slots__ = ("site", "action", "value", "count", "fired")

    def __init__(self, site: str, action: str, value: Optional[float],
                 count: Optional[int]):
        self.site = site
        self.action = action
        self.value = value
        self.count = count
        self.fired = False


_lock = threading.Lock()
_rules: List[_Rule] = []
_hits: Dict[str, int] = {}


def install(site: str, action: str, value: Optional[float] = None,
            count: Optional[int] = None) -> None:
    """Arm `action` at `site`: on every probe, or only on the `count`-th."""
    if action not in _ACTIONS:
        raise ValueError(f"unknown fault action {action!r} "
                         f"(one of {_ACTIONS})")
    with _lock:
        _rules.append(_Rule(site, action, value, count))


def clear() -> None:
    """Drop every rule and forget the hit counts."""
    with _lock:
        _rules.clear()
        _hits.clear()


def fault_point(site: str, path: Optional[str] = None) -> None:
    """Probe: a no-op unless a rule targets `site`. ``path`` names the file
    the caller just wrote (the checkpointer's commit edges pass it), as the
    JAX package's probe takes it; the ``corrupt`` action that reads it
    comes with the chaos matrix (ROADMAP A8/A9)."""
    with _lock:
        if not _rules:
            return
        hit = _hits[site] = _hits.get(site, 0) + 1
        todo = []
        for r in _rules:
            if r.site != site:
                continue
            if r.count is None:
                todo.append(r)
            elif hit == r.count and not r.fired:
                r.fired = True
                todo.append(r)
    for r in todo:
        get_registry().counter("faults/injected", site=site,
                               action=r.action).inc()
        if r.action == "delay_ms":
            time.sleep(float(r.value or 0.0) / 1e3)
        else:
            raise InjectedFault(
                f"injected fault at site {site!r} (hit {hit})")
