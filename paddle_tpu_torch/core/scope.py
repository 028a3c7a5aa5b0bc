"""Scope: name -> torch tensor map with parent lookup.

Counterpart of ``paddle_tpu.core.scope`` (reference ``framework/scope.h``
Scope::NewScope/FindVar). Values are torch tensors, on the device the
executor that wrote them runs on.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from .dtypes import to_numpy


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, torch.Tensor] = {}
        self.parent = parent
        # bumped on every key-set change (a new name, an erased name), never
        # on a value replacement: the executor's prepared plans key on it,
        # so ordinary state updates keep them while erase-one-add-another
        # (same len) still invalidates
        self._keyset_gen = 0

    def set_var(self, name: str, value):
        if name not in self._vars:
            self._keyset_gen += 1
        self._vars[name] = value

    def erase(self, name: str):
        if name in self._vars:
            self._keyset_gen += 1
            del self._vars[name]

    def var_names(self):
        return list(self._vars.keys())

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def find_np(self, name: str) -> np.ndarray:
        v = self.find_var(name)
        if v is None:
            raise KeyError(name)
        return to_numpy(v)


_global_scope = Scope()
_current_scope = _global_scope


def global_scope() -> Scope:
    """scope_guard REDIRECTS what global_scope() returns, so user code inside
    a guard reads the guarded scope's variables."""
    return _current_scope


def _scope() -> Scope:
    return _current_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _current_scope
    old = _current_scope
    _current_scope = scope
    try:
        yield
    finally:
        _current_scope = old
