"""Packed-row sparse Adagrad and whole-row gather / scatter: hand-written
Hopper kernels and their plain versions.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas_kernels/sparse_adagrad.py``
(CUDA source ``csrc/sparse_adagrad.cu``, whose header says how each is laid
out for the card and what bounds it):

- ``fused_adagrad_update`` (row 12) ← ``fused_adagrad_update`` / ``_kernel``:
  for each unique touched row of a packed table, G += u², p −= lr·u/(√G+eps),
  written back in place; spare lanes (from 4·vis on) are zeroed. A uid
  outside ``[0, V)`` (SENTINEL among them) touches nothing.
- ``fused_row_gather`` (row 13) ← ``fused_row_gather`` / ``_copy_row_kernel``:
  ``out[i] = table[slots[i]]``.
- ``fused_row_scatter`` (row 14) ← ``fused_row_scatter`` /
  ``_scatter_row_kernel``: ``table[slots[i]] = rows[src[i]]`` in place.

Rows 13–14 clamp an index that is out of range (slots into ``[0, V)``, src
into ``[0, len(rows))``), as the TPU kernels' index maps clamp theirs. Each
contract holds alike on both devices.

A packed table is ``[V, lanes]`` uint16, each f32 bit-split into two
neighbouring lanes, low half first (``pack_rows`` / ``unpack_rows``, the
same bits as the JAX package's ``lax.bitcast_convert_type``). torch's
uint16 has few kernels (no ``index_copy_``, no ``index_put_``), so every
indexed op here runs on an int16 view of the same storage.

Each ``*_plain`` function is the plain PyTorch version of a kernel. The
wrappers take it for a CPU tensor and launch the kernel for a CUDA tensor
(or raise; never a fallback), and count their launches in ``.launches``.
The table is updated in place where the JAX kernel aliases it in → out; the
wrappers return that same tensor.

The gates keep their JAX names and meaning: ``supports`` is the shape test,
``enabled`` / ``rows_enabled`` add the ``PDTPU_FUSED_SPARSE=0`` switch (the
user's request for the unfused path, read per call). There is no backend
test: on the CPU the kernels' plain versions run.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ...observability import kernel_counts

SENTINEL = 2 ** 31 - 1   # uid of an unused slot: sorts after every real id
PACK_LANES = 128         # u16 lanes per packed row (64 f32 values at most)


def supports(vis: int, lanes: int = PACK_LANES) -> bool:
    """Static shape gate: param + accumulator (2·vis f32 = 4·vis u16 lanes)
    must fit one packed row."""
    return 0 < 4 * int(vis) <= int(lanes)


def _switched_off() -> bool:
    return os.environ.get("PDTPU_FUSED_SPARSE", "1") == "0"


def enabled(vis: int, lanes: int = PACK_LANES) -> bool:
    """Gate of the fused update: the shape fits and ``PDTPU_FUSED_SPARSE``
    is not 0."""
    return supports(vis, lanes) and not _switched_off()


def rows_enabled(lanes: int = PACK_LANES) -> bool:
    """Gate of the row kernels (hot-cache write-back gather and admission
    scatter): the same switch, without the payload test."""
    return lanes > 0 and not _switched_off()


# ---------------------------------------------------------------------------
# Packed rows
# ---------------------------------------------------------------------------

def i16(t: torch.Tensor) -> torch.Tensor:
    """An int16 view of a packed uint16 tensor (same storage)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def pack_rows(x: torch.Tensor, lanes: int = PACK_LANES) -> torch.Tensor:
    """[N, D] f32 -> [N, lanes] uint16, bit-exact, zero-padded lanes."""
    n, d = x.shape
    if 2 * d > lanes:
        raise ValueError(f"pack_rows: {d} f32 values need {2 * d} u16 lanes "
                         f"> {lanes}")
    u = x.to(torch.float32).contiguous().view(torch.int16)
    if 2 * d < lanes:
        u = torch.cat([u, u.new_zeros((n, lanes - 2 * d))], dim=-1)
    return u.view(torch.uint16)


def unpack_rows(u: torch.Tensor, d: int) -> torch.Tensor:
    """[N, lanes] uint16 -> [N, d] f32, bit-exact."""
    return i16(u)[:, :2 * d].contiguous().view(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (through float64): torch's
    vectorized CPU float32 sqrt can be 1 ULP off, which would make the plain
    versions differ from the kernel's ``__fsqrt_rn`` and from the JAX
    package's op-by-op result."""
    return torch.sqrt(x.double()).to(x.dtype)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` of a packed table, a copy."""
    return i16(table).index_select(0, ids.long()).view(torch.uint16)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_adagrad_update_plain(table, uids, utot, lr, vis: int, eps: float):
    """Row 12 as gather → update → pack → indexed store of the valid slots
    (the unfused branch of ``adagrad_row_packed``)."""
    v, lanes = table.shape
    uids = uids.long()
    valid = (uids >= 0) & (uids < v) & (uids != SENTINEL)
    cur = unpack_rows(take_rows(table, uids.clamp(0, v - 1)), 2 * vis)
    g_new = cur[:, vis:2 * vis] + utot * utot
    p_new = cur[:, :vis] - lr * utot / (sqrt_rn(g_new) + eps)
    rows = pack_rows(torch.cat([p_new, g_new], dim=-1), lanes)
    i16(table).index_copy_(0, uids[valid], i16(rows)[valid])
    return table


def fused_row_gather_plain(table, slots):
    """Row 13: ``table.index_select(0, slots)``, slots clamped."""
    return take_rows(table, slots.clamp(0, table.shape[0] - 1))


def fused_row_scatter_plain(table, slots, rows, src):
    """Row 14: ``table[slots] = rows[src]``, in place, slots and src
    clamped."""
    tgt = slots.long().clamp(0, table.shape[0] - 1)
    src = src.long().clamp(0, rows.shape[0] - 1)
    i16(table).index_copy_(0, tgt, i16(rows).index_select(0, src))
    return table


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _route(t, name) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def _check_table(name, table):
    if table.dtype not in (torch.uint16, torch.int16) or table.ndim != 2:
        raise TypeError(f"{name}: needs a [V, lanes] uint16 packed table, "
                        f"got {table.dtype} {tuple(table.shape)}")


def _lr_tensor(lr, like):
    return torch.as_tensor(lr, dtype=torch.float32,
                           device=like.device).reshape(())


def distinct(ids):
    """Distinct values of a 1-D id tensor, a 0-dim tensor on its device
    (a sort, no host read)."""
    if not ids.numel():
        return ids.new_zeros(())
    s = ids.reshape(-1).sort().values
    return (s[1:] != s[:-1]).sum() + 1


def adagrad_counts(n_valid, n_slots: int, vis: int,
                   lanes: int = PACK_LANES):
    """(flops, bytes) of one row-12 launch: each valid slot reads its id,
    its summed gradient and its row's payload and writes the whole row; a
    SENTINEL slot reads its id. `n_valid` may be a 0-dim tensor."""
    return (6.0 * n_valid * vis,
            n_valid * (8 + 4 * vis + 8 * vis + 2 * lanes)
            + (n_slots - n_valid) * 8)


def gather_counts(n_distinct, n: int, lanes: int = PACK_LANES):
    """(flops, bytes) of one row-13 launch of n slots: a row is read once
    per distinct slot, the output written once per slot, every slot's id
    read."""
    return 0.0, (n_distinct + n) * 2 * lanes + n * 8


def scatter_counts(n_src_distinct, n_distinct, n: int,
                   lanes: int = PACK_LANES):
    """(flops, bytes) of one row-14 launch of n (slot, src) pairs: a source
    row read once per distinct src, a table row written once per distinct
    slot, both ids of every pair read."""
    return 0.0, (n_src_distinct + n_distinct) * 2 * lanes + n * 16


def fused_adagrad_update(table, uids, utot, lr, *, vis: int, eps: float):
    """Exact Adagrad on ``table[uids]`` in place (row 12).

    table: [V, lanes] uint16 packed rows, payload [param | G] (2·vis f32).
    uids: [R] ints, unique, ascending, SENTINEL-padded tail. utot: [R, vis]
    f32 summed gradient per slot. lr: a scalar (a device tensor in the
    program). Returns `table`."""
    _check_table("fused_adagrad_update", table)
    v, lanes = table.shape
    if not supports(vis, lanes):
        raise ValueError(
            f"fused_adagrad_update: 2*vis={2 * vis} f32 payload does not "
            f"fit a {lanes}-lane packed row")
    lr = _lr_tensor(lr, table)
    utot = utot.to(torch.float32)
    if not _route(table, "fused_adagrad_update"):
        return fused_adagrad_update_plain(table, uids, utot, lr, vis, eps)
    _launch_adagrad(table, uids, utot, lr, vis, eps)
    fused_adagrad_update.launches += 1
    if kernel_counts.active():
        kernel_counts.declare(
            "sparse_adagrad_update", ("adagrad_kernel",),
            *adagrad_counts((uids != SENTINEL).sum(), uids.numel(), vis,
                            lanes))
    return table


fused_adagrad_update.launches = 0


def fused_row_gather(table, slots):
    """``out[i] = table[slots[i]]`` (row 13): [n, lanes] uint16, duplicate
    slots allowed."""
    _check_table("fused_row_gather", table)
    if not _route(table, "fused_row_gather"):
        return fused_row_gather_plain(table, slots)
    out = _launch_gather(table, slots)
    fused_row_gather.launches += 1
    if kernel_counts.active():
        kernel_counts.declare(
            "sparse_row_gather", ("gather_kernel",),
            *gather_counts(distinct(slots), slots.numel(), table.shape[1]))
    return out


fused_row_gather.launches = 0


def fused_row_scatter(table, slots, rows, src=None):
    """``table[slots[i]] = rows[src[i]]`` in place (row 14). The prefix of
    `slots` that is not padding is distinct; a padded tail repeats the last
    (slot, src) pair. Returns `table`."""
    _check_table("fused_row_scatter", table)
    if src is None:
        src = torch.arange(slots.shape[0], device=slots.device)
    if slots.shape[0] and not rows.shape[0]:
        raise ValueError("fused_row_scatter: no rows to scatter from")
    if not _route(table, "fused_row_scatter"):
        return fused_row_scatter_plain(table, slots, rows, src)
    _launch_scatter(table, slots, rows, src)
    fused_row_scatter.launches += 1
    if kernel_counts.active():
        kernel_counts.declare(
            "sparse_row_scatter", ("scatter_kernel",),
            *scatter_counts(distinct(src), distinct(slots), slots.numel(),
                            table.shape[1]))
    return table


fused_row_scatter.launches = 0

KERNELS = (fused_adagrad_update, fused_row_gather, fused_row_scatter)


# ---------------------------------------------------------------------------
# Kernel launches (ctypes; the library is built at first use)
# ---------------------------------------------------------------------------

_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
_ARGTYPES = {
    "sparse_adagrad_update": [_PTR] * 4 + [_I64, _I64, _I32, _I32, _F32,
                                           _PTR],
    "sparse_row_gather": [_PTR] * 3 + [_I64, _I64, _I32, _PTR],
    "sparse_row_scatter": [_PTR] * 4 + [_I64, _I64, _I64, _I32, _PTR],
}


def _lib():
    from . import build

    lib = build.load("sparse_adagrad")
    if lib.sparse_adagrad_error_string.restype is not ctypes.c_char_p:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sparse_adagrad_error_string.argtypes = [ctypes.c_int]
        lib.sparse_adagrad_error_string.restype = ctypes.c_char_p
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.sparse_adagrad_error_string(err).decode()}")


def _on(name, table, *ts, wide=()):
    """Every operand on the table's device and contiguous; the table and
    the `wide` operands (moved in 16-byte vectors) 16-byte aligned."""
    for t in (table,) + ts + tuple(wide):
        if t.device != table.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous operands")
    for t in (table,) + tuple(wide):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: needs 16-byte aligned rows")


def _ids(t):
    return t.to(torch.int64).contiguous()


def _launch_adagrad(table, uids, utot, lr, vis, eps):
    uids, utot = _ids(uids), utot.contiguous()
    r = uids.shape[0]
    if tuple(utot.shape) != (r, vis):
        raise ValueError(f"fused_adagrad_update: utot {tuple(utot.shape)} "
                         f"!= ({r}, {vis})")
    _on("fused_adagrad_update", table, uids, utot, lr)
    v, lanes = table.shape
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.sparse_adagrad_update(
            table.data_ptr(), uids.data_ptr(), utot.data_ptr(), lr.data_ptr(),
            r, v, lanes, vis, float(eps), _stream(table))
    _raise_on(lib, err, "fused_adagrad_update")


def _check_lanes(name, lanes):
    if lanes % 8:
        raise ValueError(f"{name}: rows of {lanes} lanes are not whole "
                         f"16-byte vectors")


def _launch_gather(table, slots):
    slots = _ids(slots)
    v, lanes = table.shape
    _check_lanes("fused_row_gather", lanes)
    n = slots.shape[0]
    out = torch.empty((n, lanes), dtype=torch.int16, device=table.device)
    _on("fused_row_gather", table, slots, wide=(out,))
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.sparse_row_gather(table.data_ptr(), slots.data_ptr(),
                                    out.data_ptr(), n, v, lanes,
                                    _stream(table))
    _raise_on(lib, err, "fused_row_gather")
    return out.view(table.dtype)


def _launch_scatter(table, slots, rows, src):
    slots, src = _ids(slots), _ids(src)
    v, lanes = table.shape
    _check_lanes("fused_row_scatter", lanes)
    if rows.ndim != 2 or rows.shape[1] != lanes or \
            rows.element_size() != 2:
        raise ValueError(f"fused_row_scatter: rows {rows.dtype} "
                         f"{tuple(rows.shape)} are not [n, {lanes}] packed")
    if src.shape != slots.shape:
        raise ValueError("fused_row_scatter: slots and src differ in length")
    rows = rows.contiguous()
    _on("fused_row_scatter", table, slots, src, wide=(rows,))
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.sparse_row_scatter(table.data_ptr(), slots.data_ptr(),
                                     rows.data_ptr(), src.data_ptr(),
                                     slots.shape[0], rows.shape[0], v, lanes,
                                     _stream(table))
    _raise_on(lib, err, "fused_row_scatter")
