"""Builds the port's hand-written CUDA kernels at first use.

Each source under ``paddle_tpu_torch/csrc/`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Libraries go to ``paddle_tpu_torch/_build/`` (git-ignored), keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an unchanged one loads as is. Nothing is
built at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel library name -> its source file under csrc/
SOURCES = {"flash_attention_fwd": "flash_attention_fwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_sparse": "flash_attention_sparse.cu",
           "flash_attention_wide": "flash_attention_wide.cu",
           "fused_bn": "fused_bn.cu",
           "sparse_adagrad": "sparse_adagrad.cu"}

_LOADED: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (absent = loaded as is)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = nvcc if nvcc and os.path.exists(nvcc) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch need the CUDA toolkit")
    return nvcc


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, SOURCES[name])] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one library; None when it is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, target, t0 = started
    log, _ = proc.communicate()
    with open(target[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names: List[str] = None) -> Dict[str, float]:
    """Build every kernel library, one nvcc per source, all started
    together. Returns the build seconds of those that were built."""
    names = list(names or SOURCES)
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return {n: BUILD_SECONDS[n] for n in names if n in BUILD_SECONDS}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_target(name))
        _LOADED[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the last build."""
    path = _target(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
