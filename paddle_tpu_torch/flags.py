"""Global flag tree: ``set_flags`` / ``get_flags`` / ``flag``.

Counterpart of ``paddle_tpu.flags`` (reference: the gflags tier,
platform/flags.cc, surfaced by ``__bootstrap__`` in
python/paddle/fluid/__init__.py:122, which reads ``FLAGS_*`` environment
variables). One typed dict; ``FLAGS_*`` environment variables, and the
``PDTPU_*`` aliases below, override the defaults at import.

``matmul_precision`` is the one flag with a side effect: it sets torch's
float32 matmul precision and cuDNN's TF32 switch, and nothing else in the
port touches them (so a user's choice survives every ``Executor`` and
``Predictor``). It reaches cuBLAS and cuDNN only; the hand-written kernels
keep their own arithmetic (the f32 flash and conv kernels stay 3xTF32).

| value        | torch                                                  |
| ------------ | ------------------------------------------------------ |
| ``default``  | TF32 off (``"highest"``, cuDNN TF32 off)               |
| ``highest``  | TF32 off                                               |
| ``float32``  | TF32 allowed (``"high"``, cuDNN TF32 on)               |
| ``bfloat16`` | ``"medium"`` (bf16 products allowed), cuDNN TF32 on    |

``default`` is the port's parity choice: float32 results keep parity with
the CPU and the JAX package. The JAX package's own default differs (on a
TPU it lets XLA multiply float32 in bf16 passes).

``compile_cache_dir`` is accepted and inert: the port compiles nothing at
run time but its kernels, whose builds have their own cache
(``ops/kernels/_build/``). ``max_inflight_steps`` is accepted for the
dataset trainer's loader, which reads it. The memory and allocator flags
are reference-compat knobs and inert, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

__all__ = ["set_flags", "get_flags", "flag"]

_FLAGS: Dict[str, Any] = {
    # numeric guards (operator.cc:949 CheckTensorNANOrInf analog)
    "check_nan_inf": False,
    # float32 matmul precision of cuBLAS and cuDNN (see the table above)
    "matmul_precision": "default",
    # async input pipeline: max un-synced Executor.run dispatches the
    # dataset trainer keeps in flight
    "max_inflight_steps": 2,
    # inert: the port has no run-time compiler cache to point anywhere
    "compile_cache_dir": "",
    # inert reference-compat knobs
    "fraction_of_gpu_memory_to_use": 0.92,
    "allocator_strategy": "auto_growth",
    "sync_nccl_allreduce": True,
    "selected_gpus": "",
    "eager_delete_tensor_gb": 0.0,
    "cudnn_deterministic": False,
}

# flag value -> (torch float32 matmul precision, cuDNN TF32 allowed)
_PRECISION_MAP = {"default": ("highest", False), "highest": ("highest", False),
                  "float32": ("high", True), "bfloat16": ("medium", True)}


def _apply_precision(value: str) -> None:
    if value not in _PRECISION_MAP:
        raise ValueError(f"FLAGS_matmul_precision={value!r}: must be one of "
                         f"{sorted(_PRECISION_MAP)}")
    matmul, cudnn_tf32 = _PRECISION_MAP[value]
    torch.set_float32_matmul_precision(matmul)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        key = k[6:] if k.startswith("FLAGS_") else k
        if key not in _FLAGS:
            raise KeyError(f"unknown flag {key!r}")
        if key == "matmul_precision":
            _apply_precision(v)
        _FLAGS[key] = v


def get_flags(keys):
    if isinstance(keys, str):
        keys = [keys]
    return {k: _FLAGS[k[6:] if k.startswith("FLAGS_") else k] for k in keys}


def flag(key: str):
    return _FLAGS[key]


# runtime knobs also honored under their PDTPU_* spelling (the env names
# documented alongside PDTPU_FUSE_UPDATES / PDTPU_REMAT_OPS)
_ENV_ALIASES = {
    "PDTPU_MAX_INFLIGHT_STEPS": "max_inflight_steps",
    "PDTPU_COMPILE_CACHE_DIR": "compile_cache_dir",
}


def _coerce(key: str, v: str):
    cur = _FLAGS[key]
    if isinstance(cur, bool):
        return v.lower() in ("1", "true", "yes")
    if isinstance(cur, float):
        return float(v)
    if isinstance(cur, int):
        return int(v)
    return v


def _bootstrap_from_env():
    for k, v in os.environ.items():
        key = _ENV_ALIASES.get(k) if not k.startswith("FLAGS_") else k[6:]
        if key is None or key not in _FLAGS:
            continue
        _FLAGS[key] = _coerce(key, v)


_bootstrap_from_env()
_apply_precision(_FLAGS["matmul_precision"])
