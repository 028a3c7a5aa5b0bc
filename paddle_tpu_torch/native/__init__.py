"""ctypes bindings for the port's native runtime (the port's copy of
``paddle_tpu.native``).

Two C++ sources under ``src/``: ``dataloader.cc`` (the MultiSlot file
loader and a bounded byte queue; reference ``data_feed.cc``,
``blocking_queue.h``) and ``ckptio.cc`` (the ``.ptck`` checkpoint bundle;
reference ``save_combine_op.cc``). They are built with ``g++`` into
``paddle_tpu_torch/_build/`` (git-ignored) at first use, keyed by a hash
of the sources and flags; nothing is built at import. The JAX package's
committed library is never loaded.

bfloat16 without ``ml_dtypes``: a bundle entry's dtype tag is the numpy
dtype name, and ``bfloat16`` is written from a ``uint16`` view of a
``torch.bfloat16`` tensor (or of an ml_dtypes array) and read back as a
``torch.bfloat16`` tensor, so the port never needs ``ml_dtypes`` here.
Every other entry reads back as a numpy array. ``available()`` is False
and ``build_error()`` says why when ``g++`` fails; the MultiSlot loader
then parses in Python, and ``write_bundle`` / ``read_bundle`` return
False / None (the checkpointer writes pickle bundles instead).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "src", "dataloader.cc"),
         os.path.join(_DIR, "src", "ckptio.cc")]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared"]

_lib = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def _target() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in _SRCS:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpaddle_tpu_torch_native-{digest.hexdigest()[:16]}"
                        f".so")


def _build(target: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's native library needs "
                           "a C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a private temp name, then an atomic rename: concurrent first users
    # (test workers) never load a half-written library
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_SRCS],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native library "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, target)


def _bind(lib) -> None:
    c = ctypes
    lib.ptdl_create.restype = c.c_void_p
    lib.ptdl_create.argtypes = [c.POINTER(c.c_char_p), c.c_int, c.c_char_p,
                                c.c_int, c.c_int]
    lib.ptdl_next.restype = c.c_longlong
    lib.ptdl_next.argtypes = [c.c_void_p, c.POINTER(c.c_uint8),
                              c.c_longlong]
    lib.ptdl_queue_size.restype = c.c_longlong
    lib.ptdl_queue_size.argtypes = [c.c_void_p]
    lib.ptdl_destroy.argtypes = [c.c_void_p]
    lib.ptq_create.restype = c.c_void_p
    lib.ptq_create.argtypes = [c.c_int]
    lib.ptq_push.restype = c.c_int
    lib.ptq_push.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.c_longlong]
    lib.ptq_pop.restype = c.c_longlong
    lib.ptq_pop.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.c_longlong]
    lib.ptq_close.argtypes = [c.c_void_p]
    lib.ptq_destroy.argtypes = [c.c_void_p]
    lib.ptck_open.restype = c.c_void_p
    lib.ptck_open.argtypes = [c.c_char_p]
    lib.ptck_write_tensor.restype = c.c_int
    lib.ptck_write_tensor.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_int, c.POINTER(c.c_int64),
        c.c_void_p, c.c_uint64]
    lib.ptck_close.restype = c.c_int
    lib.ptck_close.argtypes = [c.c_void_p]
    lib.ptck_read_open.restype = c.c_void_p
    lib.ptck_read_open.argtypes = [c.c_char_p]
    lib.ptck_count.restype = c.c_int64
    lib.ptck_count.argtypes = [c.c_void_p]
    lib.ptck_entry_meta.restype = c.c_int64
    lib.ptck_entry_meta.argtypes = [
        c.c_void_p, c.c_int64, c.c_char_p, c.c_int, c.c_char_p, c.c_int,
        c.POINTER(c.c_int64), c.c_int, c.POINTER(c.c_int)]
    lib.ptck_entry_data.restype = c.c_int
    lib.ptck_entry_data.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                    c.c_uint64]
    lib.ptck_read_close.argtypes = [c.c_void_p]


def _ensure_built():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            target = _target()
            if not os.path.exists(target):
                _build(target)
            lib = ctypes.CDLL(target)
            _bind(lib)
            _lib = lib
        except Exception as e:  # no toolchain / build failure
            _build_error = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def available() -> bool:
    return _ensure_built() is not None


def build_error() -> Optional[str]:
    _ensure_built()
    return _build_error


def _decode_sample(buf: np.ndarray) -> List[np.ndarray]:
    """Decode the wire format (see dataloader.cc) into per-slot arrays."""
    out = []
    mv = memoryview(buf)
    num_slots = int(np.frombuffer(mv[:4], dtype="<u4")[0])
    off = 4
    for _ in range(num_slots):
        dtype = mv[off]
        off += 1
        n = int(np.frombuffer(mv[off:off + 4], dtype="<u4")[0])
        off += 4
        if dtype == 0:
            arr = np.frombuffer(mv[off:off + 4 * n], dtype="<f4").copy()
            off += 4 * n
        else:
            arr = np.frombuffer(mv[off:off + 8 * n], dtype="<i8").copy()
            off += 8 * n
        out.append(arr)
    return out


class NativeDataLoader:
    """Multi-threaded MultiSlot file loader (data_feed.cc analog)."""

    MAX_SAMPLE = 1 << 22  # 4 MiB per sample

    def __init__(self, files: Sequence[str], slot_types: str,
                 num_threads: int = 4, capacity: int = 1024):
        lib = _ensure_built()
        self._lib = lib
        self._files = list(files)
        self._slot_types = slot_types
        self._handle = None
        if lib is not None:
            arr = (ctypes.c_char_p * len(self._files))(
                *[f.encode() for f in self._files])
            self._handle = lib.ptdl_create(arr, len(self._files),
                                           slot_types.encode(), num_threads,
                                           capacity)
            self._buf = np.empty(self.MAX_SAMPLE, dtype=np.uint8)
        else:
            self._py_iter = self._python_reader()

    def _python_reader(self):
        for path in self._files:
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    out, i, ok = [], 0, True
                    for t in self._slot_types:
                        if i >= len(parts):
                            ok = False
                            break
                        n = int(parts[i])
                        i += 1
                        vals = parts[i:i + n]
                        i += n
                        if len(vals) != n:
                            ok = False
                            break
                        out.append(np.asarray(
                            vals, dtype="float32" if t == "f" else "int64"))
                    if ok:
                        yield out

    def __iter__(self):
        if self._handle is None:
            yield from self._py_iter
            return
        lib = self._lib
        buf_ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            n = lib.ptdl_next(self._handle, buf_ptr, self.MAX_SAMPLE)
            if n == 0:
                break
            if n < 0:
                continue  # oversized sample dropped
            yield _decode_sample(self._buf[:n])

    def close(self):
        if self._handle is not None:
            self._lib.ptdl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Native checkpoint bundle IO (src/ckptio.cc — save_combine_op.cc analog)
# ---------------------------------------------------------------------------

def _raw(arr):
    """(dtype tag, contiguous host bytes as a numpy array) of one entry: a
    torch tensor (bf16 through a uint16 view) or anything numpy takes
    (an ml_dtypes bfloat16 array keeps the tag ``bfloat16``)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        if t.dtype == torch.uint16:
            return "uint16", t.view(torch.int16).numpy().view(np.uint16)
        return str(t.numpy().dtype), t.numpy()
    a = np.ascontiguousarray(arr)
    return a.dtype.name if a.dtype.name == "bfloat16" else str(a.dtype), a


def write_bundle(path: str, arrays) -> bool:
    """Write {name: array} as one framed binary bundle via the C++ writer
    (buffered stdio + fsync). Values are numpy arrays or torch tensors.
    Returns False when the native lib is unavailable or any write fails
    (the caller falls back to pickle)."""
    lib = _ensure_built()
    if lib is None:
        return False
    h = lib.ptck_open(path.encode())
    if not h:
        return False
    ok = True
    for name, arr in arrays.items():
        tag, a = _raw(arr)
        dims = (ctypes.c_int64 * max(a.ndim, 1))(*(a.shape or (0,)))
        rc = lib.ptck_write_tensor(
            h, str(name).encode(), tag.encode(), a.ndim, dims,
            a.ctypes.data_as(ctypes.c_void_p), a.nbytes)
        if rc != 0:
            ok = False
            break
    if lib.ptck_close(h) != 0:
        ok = False
    return ok


def read_bundle(path: str):
    """Read a bundle back as {name: np.ndarray}, a ``bfloat16`` entry as a
    ``torch.bfloat16`` CPU tensor; None if the native lib is unavailable or
    the file isn't a PTCK bundle."""
    lib = _ensure_built()
    if lib is None:
        return None
    h = lib.ptck_read_open(path.encode())
    if not h:
        return None
    try:
        out = {}
        n = lib.ptck_count(h)
        name_buf = ctypes.create_string_buffer(4096)
        dtype_buf = ctypes.create_string_buffer(64)
        dims_buf = (ctypes.c_int64 * 16)()
        ndim = ctypes.c_int()
        for i in range(n):
            nbytes = lib.ptck_entry_meta(h, i, name_buf, 4096, dtype_buf, 64,
                                         dims_buf, 16, ctypes.byref(ndim))
            if nbytes < 0:
                return None
            shape = tuple(dims_buf[d] for d in range(ndim.value))
            tag = dtype_buf.value.decode()
            bf16 = tag == "bfloat16"
            arr = np.empty(shape, dtype=np.uint16 if bf16 else np.dtype(tag))
            if nbytes != arr.nbytes:
                # truncated/corrupt entry: the C side only rejects
                # nbytes > capacity, so a SHORT payload would otherwise
                # fill part of np.empty and return uninitialized tail bytes
                return None
            buf = arr if arr.nbytes else np.empty(1, np.uint8)
            if lib.ptck_entry_data(
                    h, i, buf.ctypes.data_as(ctypes.c_void_p),
                    max(arr.nbytes, 1)) != 0:
                return None
            out[name_buf.value.decode()] = (
                torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                if bf16 else arr)
        return out
    finally:
        lib.ptck_read_close(h)
