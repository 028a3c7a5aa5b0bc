"""Process-wide fault injection (the port's copy of ``paddle_tpu.faults``,
stdlib only: a pserver process imports it through ``ps.transport``).

Code that must stay correct under failure calls ``fault_point(site)`` at
the place a real failure would strike. Sites:

====================  ====================================================
``ckpt.bundle_write``  after the checkpoint bundle's bytes are on disk,
                       before the atomic rename (parallel/checkpoint.py)
``ckpt.rename``        after the bundle rename, before the manifest commit
``ckpt.shard_write``   after a shard file write (PS tables), before rename
``ckpt.delta_write``   after a delta checkpoint's write, before rename
``ckpt.marker``        after the ``latest`` marker temp write, before its
                       rename
``loader.next``        every reader pull in the DeviceLoader worker
``ps.rpc``             every request the PS shard server receives
                       (ps/transport.py), BEFORE dispatch
``ps.pull``/``ps.push``  worker-side PS tier pull/push (ps/tier.py)
====================  ====================================================

Actions, triggered deterministically by hit count:

- ``crash``      — ``os._exit(CRASH_EXIT_CODE)``: the un-catchable process
  death a preemption delivers (no atexit, no finally, no flushes);
- ``raise``      — raise :class:`InjectedFault` (an ``OSError`` subclass,
  so transient-I/O retry loops treat it exactly like the real thing);
- ``delay_ms=N`` — sleep N ms (slow filesystem, straggler);
- ``corrupt``    — flip bytes in the file the probe just wrote;
- ``drop``       — raise :class:`InjectedNetworkFault`; the PS shard
  server interprets it at ``ps.rpc`` by swallowing the request and
  closing the connection without a reply (the client sees a short read);
- ``reset``      — like ``drop`` but the server closes with an RST
  (``SO_LINGER 0``) so the client sees ``ECONNRESET``. At non-transport
  sites ``drop``/``reset`` behave like ``raise``.

Spec grammar (``PDTPU_FAULT_SPEC`` or :func:`install`)::

    spec    := entry ("," entry)*
    entry   := site ":" action ["=" value] ["@" count]

    PDTPU_FAULT_SPEC=ckpt.bundle_write:crash@2,loader.next:delay_ms=50

``@count`` arms the rule for the count-th hit of that site only (one
shot); without it the rule fires on every hit. Hits are counted per site
process-wide. The environment spec is re-read whenever its value changes
(setting it again re-arms its one-shot rules). Every firing increments
``faults/injected{site,action}``. An idle probe costs one environment
lookup and a None check.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from .observability.registry import get_registry

__all__ = ["fault_point", "install", "clear", "hits", "active_rules",
           "parse_spec", "InjectedFault", "InjectedNetworkFault",
           "CRASH_EXIT_CODE"]

# EX_SOFTWARE: lets a supervisor (and the chaos tests) tell an injected
# crash apart from a real one or a signal death
CRASH_EXIT_CODE = 70

_ACTIONS = ("crash", "raise", "delay_ms", "corrupt", "drop", "reset")


class InjectedFault(OSError):
    """Raised by the ``raise`` action. Deliberately an ``OSError``: the
    checkpoint writer's transient-I/O retry loop must not be able to tell
    an injected failure from a real one."""


class InjectedNetworkFault(InjectedFault):
    """Raised by the ``drop``/``reset`` actions. A transport layer that
    embeds a probe (the PS shard server's ``ps.rpc``) catches this and
    performs the real network misbehavior — swallow the request (drop) or
    RST the connection (reset); anywhere else it propagates like a
    ``raise``-action :class:`InjectedFault`."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


class _Rule:
    __slots__ = ("site", "action", "value", "count", "fired")

    def __init__(self, site: str, action: str, value: Optional[float] = None,
                 count: Optional[int] = None):
        self.site = site
        self.action = action
        self.value = value
        self.count = count
        self.fired = False

    def __repr__(self):
        s = f"{self.site}:{self.action}"
        if self.value is not None:
            s += f"={self.value:g}"
        if self.count is not None:
            s += f"@{self.count}"
        return s


_OBS = get_registry()
_lock = threading.Lock()
_rules: List[_Rule] = []          # programmatic (install())
_hits: Dict[str, int] = {}
_env_spec: Optional[str] = None   # last PDTPU_FAULT_SPEC value parsed
_env_rules: List[_Rule] = []


def parse_spec(spec: str) -> List[_Rule]:
    """Parse a ``PDTPU_FAULT_SPEC`` string into rules; malformed entries
    raise ``ValueError`` naming the entry and the grammar."""
    rules = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, rest = entry.partition(":")
        site = site.strip()
        if not sep or not site or not rest:
            raise ValueError(
                f"bad fault spec entry {entry!r}: expected "
                "site:action[=value][@count]")
        count = None
        if "@" in rest:
            rest, _, cstr = rest.rpartition("@")
            try:
                count = int(cstr)
            except ValueError:
                raise ValueError(f"bad fault spec entry {entry!r}: "
                                 f"count {cstr!r} is not an integer")
            if count < 1:
                raise ValueError(f"bad fault spec entry {entry!r}: "
                                 "count must be >= 1")
        value = None
        action, eq, vstr = rest.partition("=")
        action = action.strip()
        if eq:
            try:
                value = float(vstr)
            except ValueError:
                raise ValueError(f"bad fault spec entry {entry!r}: "
                                 f"value {vstr!r} is not a number")
        if action not in _ACTIONS:
            raise ValueError(f"bad fault spec entry {entry!r}: unknown "
                             f"action {action!r} (one of {_ACTIONS})")
        if action == "delay_ms" and value is None:
            raise ValueError(f"bad fault spec entry {entry!r}: delay_ms "
                             "needs a value, e.g. delay_ms=50")
        rules.append(_Rule(site, action, value, count))
    return rules


def install(site: str, action: str, value: Optional[float] = None,
            count: Optional[int] = None) -> None:
    """Programmatic equivalent of one ``PDTPU_FAULT_SPEC`` entry."""
    if action not in _ACTIONS:
        raise ValueError(f"unknown fault action {action!r} "
                         f"(one of {_ACTIONS})")
    with _lock:
        _rules.append(_Rule(site, action, value, count))


def clear() -> None:
    """Drop all programmatic rules, forget hit counts, and force a
    re-read of ``PDTPU_FAULT_SPEC`` on the next probe (tests)."""
    global _env_spec, _env_rules
    with _lock:
        _rules.clear()
        _hits.clear()
        _env_spec = None
        _env_rules = []


def hits(site: str) -> int:
    """How many times `site` has been probed since the harness was last
    armed (counting starts only once any rule exists)."""
    with _lock:
        return _hits.get(site, 0)


def active_rules() -> List[str]:
    with _lock:
        return [repr(r) for r in _rules + _env_rules]


def _flip_bytes(path: str, n: int = 8) -> None:
    """Corrupt a file in place: XOR a comb of bytes around the middle (a
    header-only flip could hide in unread padding)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "r+b") as f:
        for i in range(min(n, size)):
            off = (size // 2 + i * 7919) % size
            f.seek(off)
            b = f.read(1)
            if not b:
                continue
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())


def _fire(rule: _Rule, site: str, path: Optional[str], hit: int) -> None:
    _OBS.counter("faults/injected", site=site, action=rule.action).inc()
    if rule.action == "delay_ms":
        time.sleep(float(rule.value or 0.0) / 1e3)
    elif rule.action == "corrupt":
        if path is not None:
            _flip_bytes(path)
    elif rule.action == "raise":
        raise InjectedFault(
            f"injected fault at site {site!r} (hit {hit})")
    elif rule.action in ("drop", "reset"):
        raise InjectedNetworkFault(
            rule.action,
            f"injected {rule.action} at site {site!r} (hit {hit})")
    elif rule.action == "crash":
        # a real preemption: no unwinding, no cleanup, no flushes
        os._exit(CRASH_EXIT_CODE)


def fault_point(site: str, path: Optional[str] = None) -> None:
    """Probe: no-op unless a rule targets `site`. ``path`` names the file
    the caller just wrote (the ``corrupt`` action's target)."""
    global _env_spec, _env_rules
    spec = os.environ.get("PDTPU_FAULT_SPEC")
    with _lock:
        if spec != _env_spec:
            _env_spec = spec
            _env_rules = parse_spec(spec) if spec else []
        if not _rules and not _env_rules:
            return
        hit = _hits[site] = _hits.get(site, 0) + 1
        todo = []
        for r in _rules + _env_rules:
            if r.site != site:
                continue
            if r.count is None:
                todo.append(r)
            elif hit == r.count and not r.fired:
                r.fired = True
                todo.append(r)
    for r in todo:
        _fire(r, site, path, hit)
