"""Reference binary-format codecs: ProgramDesc protobuf + tensor streams
(the port's copy of ``paddle_tpu.compat.reference_format``: the wire code
is the same plain Python over bytes and numpy; the loaders build the
port's ``Program`` and place parameters as torch tensors on the caller's
place).

The reference serializes trained artifacts in two formats this module
reads (and, for round-trip tests, writes):

1. **Binary ``ProgramDesc``** — proto2 message defined in
   the reference's ``paddle/fluid/framework/framework.proto:184``
   (``save_inference_model`` writes it as the ``__model__`` file,
   io.py:933). Rather than vendoring the .proto (and a protobuf codegen
   dependency), this module hand-decodes the wire format against the
   schema's field numbers, which are documented inline below.

2. **LoDTensor streams** — ``save_op.cc`` /
   ``lod_tensor.cc:219 SerializeToStream``: a little-endian layout of
   ``uint32 lod-version(0) | uint64 lod_level | per level: uint64 nbytes
   + size_t[] offsets | uint32 tensor-version(0) | int32 desc_size |
   TensorDesc proto | raw data`` (tensor_util.cc:383 TensorToStream).
   ``save_persistables`` (io.py:487) writes one stream per file named by
   the variable; ``save_combine_op.cc`` concatenates streams in the save
   op's input order.

Everything here is plain Python over ``bytes`` — no reference code, no
generated protobuf classes.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- protobuf wire-format primitives ----------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # proto2 negative int32/int64 → 10-byte varint
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _parse_fields(buf: bytes) -> Dict[int, List]:
    """Decode one message into {field_number: [raw values]} — varints stay
    ints, length-delimited stay bytes (caller decides: submessage, string,
    or packed repeated)."""
    fields: Dict[int, List] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
        elif wt == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == _WIRE_32BIT:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == _WIRE_64BIT:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(fnum, []).append(v)
    return fields


def _emit(fnum: int, wt: int, payload) -> bytes:
    key = _write_varint((fnum << 3) | wt)
    if wt == _WIRE_VARINT:
        return key + _write_varint(payload)
    if wt == _WIRE_LEN:
        return key + _write_varint(len(payload)) + payload
    if wt == _WIRE_32BIT:
        return key + struct.pack("<f", payload)
    raise ValueError(wt)


def _signed(v: int) -> int:
    """proto2 int32/int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


# -- framework.proto schema (field numbers cited from the reference) --------

# VarType.Type enum values (framework.proto:105-135)
_DTYPES = {0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
           5: "float32", 6: "float64", 19: "uint64", 20: "uint8",
           21: "int8"}
_DTYPE_IDS = {v: k for k, v in _DTYPES.items()}
VT_LOD_TENSOR = 7
VT_FEED_MINIBATCH = 9
VT_FETCH_LIST = 10
VT_SELECTED_ROWS = 8   # framework.proto VarType enum — no decode support;
VT_READER = 15         # the loader skips/raises on these, see
VT_RAW = 17            # load_reference_persistables

# AttrType enum (framework.proto:26-39)
_AT_INT, _AT_FLOAT, _AT_STRING, _AT_INTS, _AT_FLOATS, _AT_STRINGS, \
    _AT_BOOLEAN, _AT_BOOLEANS, _AT_BLOCK, _AT_LONG, _AT_BLOCKS, \
    _AT_LONGS = range(12)


def _decode_ints(vals, signed=True) -> List[int]:
    """Repeated varint field: proto2 may emit each element with its own
    tag (unpacked) or, from some writers, a packed length-delimited blob."""
    out = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed(x) if signed else x)
        else:
            out.append(_signed(v) if signed else v)
    return out


def _parse_tensor_desc(buf: bytes) -> Tuple[str, List[int]]:
    """VarType.TensorDesc (framework.proto:139-143): data_type=1 (enum),
    dims=2 (repeated int64)."""
    f = _parse_fields(buf)
    dtype = _DTYPES[f[1][0]]
    dims = _decode_ints(f.get(2, []))
    return dtype, dims


def _parse_var_type(buf: bytes) -> dict:
    """VarType (framework.proto:103-164): type=1, selected_rows=2,
    lod_tensor=3 (LoDTensorDesc: tensor=1, lod_level=2)."""
    f = _parse_fields(buf)
    out = {"type": f[1][0], "dtype": None, "shape": None, "lod_level": 0}
    sub = None
    if 3 in f:
        sub = _parse_fields(f[3][0])
    elif 2 in f:
        sub = {1: f[2]}
    if sub and 1 in sub:
        out["dtype"], out["shape"] = _parse_tensor_desc(sub[1][0])
        if 2 in sub:
            out["lod_level"] = sub[2][0]
    return out


def _parse_attr(buf: bytes) -> Tuple[str, object]:
    """OpDesc.Attr (framework.proto:44-60): name=1, type=2, i=3, f=4,
    s=5, ints=6, floats=7, strings=8, b=10, bools=11, block_idx=12,
    l=13, blocks_idx=14, longs=15."""
    f = _parse_fields(buf)
    name = f[1][0].decode()
    at = f[2][0]
    if at == _AT_INT:
        return name, _signed(f[3][0])
    if at == _AT_FLOAT:
        return name, float(f[4][0])
    if at == _AT_STRING:
        return name, f[5][0].decode()
    if at == _AT_INTS:
        return name, _decode_ints(f.get(6, []))
    if at == _AT_FLOATS:
        out = []
        for v in f.get(7, []):
            if isinstance(v, (bytes, bytearray)):  # packed floats
                out.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                out.append(float(v))
        return name, out
    if at == _AT_STRINGS:
        return name, [s.decode() for s in f.get(8, [])]
    if at == _AT_BOOLEAN:
        return name, bool(f[10][0])
    if at == _AT_BOOLEANS:
        return name, [bool(b) for b in _decode_ints(f.get(11, []))]
    if at == _AT_BLOCK:
        return name, ("__block__", f[12][0])
    if at == _AT_LONG:
        return name, _signed(f[13][0])
    if at == _AT_LONGS:
        return name, _decode_ints(f.get(15, []))
    if at == _AT_BLOCKS:
        return name, ("__blocks__", _decode_ints(f.get(14, [])))
    raise ValueError(f"attr {name}: unsupported AttrType {at}")


def parse_program_desc(data: bytes) -> dict:
    """Binary ProgramDesc → plain dict tree.

    ProgramDesc: blocks=1 (framework.proto:184); BlockDesc: idx=1,
    parent_idx=2, vars=3, ops=4 (:171); VarDesc: name=1, type=2,
    persistable=3 (:165); OpDesc: inputs=1, outputs=2, type=3, attrs=4
    (:42-71); OpDesc.Var: parameter=1, arguments=2."""
    prog = _parse_fields(data)
    blocks = []
    for braw in prog.get(1, []):
        bf = _parse_fields(braw)
        varz = {}
        for vraw in bf.get(3, []):
            vf = _parse_fields(vraw)
            name = vf[1][0].decode()
            varz[name] = {
                "name": name,
                "persistable": bool(vf.get(3, [0])[0]),
                **_parse_var_type(vf[2][0]),
            }
        ops = []
        for oraw in bf.get(4, []):
            of = _parse_fields(oraw)

            def io(vals):
                out = {}
                for raw in vals:
                    sf = _parse_fields(raw)
                    out[sf[1][0].decode()] = [a.decode()
                                              for a in sf.get(2, [])]
                return out

            ops.append({
                "type": of[3][0].decode(),
                "inputs": io(of.get(1, [])),
                "outputs": io(of.get(2, [])),
                "attrs": dict(_parse_attr(a) for a in of.get(4, [])),
            })
        blocks.append({"idx": bf[1][0], "parent_idx": _signed(bf[2][0]),
                       "vars": varz, "ops": ops})
    return {"blocks": blocks}


# -- writer (round-trip tests + artifact generation) ------------------------

def _emit_tensor_desc(dtype: str, dims) -> bytes:
    out = _emit(1, _WIRE_VARINT, _DTYPE_IDS[dtype])
    for d in dims:
        out += _emit(2, _WIRE_VARINT, int(d))
    return out


def _emit_attr(name: str, value) -> bytes:
    out = _emit(1, _WIRE_LEN, name.encode())
    if isinstance(value, bool):
        out += _emit(2, _WIRE_VARINT, _AT_BOOLEAN) + _emit(10, _WIRE_VARINT,
                                                           int(value))
    elif isinstance(value, int):
        out += _emit(2, _WIRE_VARINT, _AT_INT) + _emit(3, _WIRE_VARINT, value)
    elif isinstance(value, float):
        out += _emit(2, _WIRE_VARINT, _AT_FLOAT) + _emit(4, _WIRE_32BIT,
                                                         value)
    elif isinstance(value, str):
        out += _emit(2, _WIRE_VARINT, _AT_STRING) + _emit(5, _WIRE_LEN,
                                                          value.encode())
    elif isinstance(value, (list, tuple)) and len(value) == 0:
        # empty list: element type unknowable — emit INTS, the most
        # common repeated attr (paddings etc.); BOOLEANS would otherwise
        # win vacuously
        out += _emit(2, _WIRE_VARINT, _AT_INTS)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, bool) for v in value):
        out += _emit(2, _WIRE_VARINT, _AT_BOOLEANS)
        for v in value:
            out += _emit(11, _WIRE_VARINT, int(v))
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, int) for v in value):
        out += _emit(2, _WIRE_VARINT, _AT_INTS)
        for v in value:
            out += _emit(6, _WIRE_VARINT, v)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, float) for v in value):
        out += _emit(2, _WIRE_VARINT, _AT_FLOATS)
        for v in value:
            out += _emit(7, _WIRE_32BIT, v)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, str) for v in value):
        out += _emit(2, _WIRE_VARINT, _AT_STRINGS)
        for v in value:
            out += _emit(8, _WIRE_LEN, v.encode())
    else:
        raise ValueError(f"attr {name}: cannot encode {value!r}")
    return out


def serialize_program_desc(prog: dict) -> bytes:
    """Inverse of :func:`parse_program_desc` for the supported subset."""
    out = b""
    for block in prog["blocks"]:
        b = _emit(1, _WIRE_VARINT, block.get("idx", 0))
        b += _emit(2, _WIRE_VARINT, block.get("parent_idx", -1))
        for var in block["vars"].values():
            vt = _emit(1, _WIRE_VARINT, var.get("type", VT_LOD_TENSOR))
            if var.get("shape") is not None:
                td = _emit_tensor_desc(var.get("dtype", "float32"),
                                       var["shape"])
                lod = _emit(1, _WIRE_LEN, td)
                if var.get("lod_level"):
                    lod += _emit(2, _WIRE_VARINT, var["lod_level"])
                vt += _emit(3, _WIRE_LEN, lod)
            v = _emit(1, _WIRE_LEN, var["name"].encode())
            v += _emit(2, _WIRE_LEN, vt)
            if var.get("persistable"):
                v += _emit(3, _WIRE_VARINT, 1)
            b += _emit(3, _WIRE_LEN, v)
        for op in block["ops"]:
            o = _emit(3, _WIRE_LEN, op["type"].encode())
            for fnum, slots in ((1, op.get("inputs", {})),
                                (2, op.get("outputs", {}))):
                for slot, args in slots.items():
                    sv = _emit(1, _WIRE_LEN, slot.encode())
                    for a in args:
                        sv += _emit(2, _WIRE_LEN, a.encode())
                    o += _emit(fnum, _WIRE_LEN, sv)
            for name, value in op.get("attrs", {}).items():
                o += _emit(4, _WIRE_LEN, _emit_attr(name, value))
            b += _emit(4, _WIRE_LEN, o)
        out += _emit(1, _WIRE_LEN, b)
    return out


# -- LoDTensor streams ------------------------------------------------------

_NP_DTYPES = {"bool": np.bool_, "int16": np.int16, "int32": np.int32,
              "int64": np.int64, "float16": np.float16,
              "float32": np.float32, "float64": np.float64,
              "uint64": np.uint64, "uint8": np.uint8, "int8": np.int8}


def read_lod_tensor_stream(f) -> Tuple[np.ndarray, List[List[int]]]:
    """One SerializeToStream record from a binary file object."""
    (lod_version,) = struct.unpack("<I", f.read(4))
    if lod_version != 0:
        raise ValueError(f"unsupported LoDTensor version {lod_version}")
    (lod_levels,) = struct.unpack("<Q", f.read(8))
    lod = []
    for _ in range(lod_levels):
        (nbytes,) = struct.unpack("<Q", f.read(8))
        lod.append(list(np.frombuffer(f.read(nbytes), "<u8")))
    (tensor_version,) = struct.unpack("<I", f.read(4))
    if tensor_version != 0:
        raise ValueError(f"unsupported tensor version {tensor_version}")
    (desc_size,) = struct.unpack("<i", f.read(4))
    dtype, dims = _parse_tensor_desc(f.read(desc_size))
    np_dt = _NP_DTYPES[dtype]
    count = int(np.prod(dims)) if dims else 1
    data = f.read(count * np.dtype(np_dt).itemsize)
    arr = np.frombuffer(data, np_dt).reshape(dims)
    return arr.copy(), lod


def write_lod_tensor_stream(f, arr: np.ndarray, lod=()) -> None:
    f.write(struct.pack("<I", 0))
    f.write(struct.pack("<Q", len(lod)))
    for level in lod:
        level = np.asarray(level, "<u8")
        f.write(struct.pack("<Q", level.nbytes))
        f.write(level.tobytes())
    f.write(struct.pack("<I", 0))
    desc = _emit_tensor_desc(str(arr.dtype), arr.shape)
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    f.write(np.ascontiguousarray(arr).tobytes())


# -- high-level loaders -----------------------------------------------------

def load_reference_persistables(dirname: str, program_desc: dict,
                                params_filename: Optional[str] = None
                                ) -> Dict[str, np.ndarray]:
    """Read the variables a reference ``save_persistables`` /
    ``save_inference_model`` wrote: one stream per file named by the var
    (io.py:487), or a single combined file holding the streams in
    SORTED-name order (io.py:242 — save_vars feeds save_combine from
    ``sorted(save_var_map.keys())``, and load_vars mirrors it at
    io.py:664; NOT block var order).

    Persistable selection mirrors the reference predicate
    (io.py:70 is_persistable excludes FEED_MINIBATCH / FETCH_LIST /
    READER; io.py:225 additionally skips RAW at save time) — an
    exclusion list, not a LOD_TENSOR whitelist.  A persistable var of a
    type we cannot decode (e.g. SELECTED_ROWS) is skipped on the
    per-var-file path (positionally harmless — its file is simply never
    opened) but raises on the combined path, where silently skipping
    would desynchronize the positional stream."""
    block = program_desc["blocks"][0]
    names = []
    for v in block["vars"].values():
        if not v["persistable"] or v["name"] in ("feed", "fetch"):
            continue
        vt = v.get("type")
        if vt in (VT_FEED_MINIBATCH, VT_FETCH_LIST, VT_READER, VT_RAW):
            continue  # reference never saves these (io.py:70,:225)
        if vt != VT_LOD_TENSOR:
            if params_filename is None:
                continue  # per-var file never read — no desync possible
            raise NotImplementedError(
                f"load_reference_persistables: persistable var "
                f"{v['name']!r} has VarType {vt} — only LOD_TENSOR "
                f"streams can be decoded, and skipping it would "
                f"desynchronize the combined-params stream")
        names.append(v["name"])
    out: Dict[str, np.ndarray] = {}
    if params_filename is not None:
        with open(os.path.join(dirname, params_filename), "rb") as f:
            for name in sorted(names):
                out[name], _ = read_lod_tensor_stream(f)
    else:
        for name in names:
            path = os.path.join(dirname, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"reference var file missing: {path}")
            with open(path, "rb") as f:
                out[name], _ = read_lod_tensor_stream(f)
    return out


def _build_program(program_desc: dict):
    """Reference ProgramDesc dict → the port's Program (+ feed/fetch
    names). feed/fetch ops (executor.py:539 _add_feed_fetch_ops analog)
    become the feed/fetch CONTRACT rather than ops — our executor feeds
    by name."""
    from ..core.program import Program

    if len(program_desc["blocks"]) > 1:
        raise NotImplementedError(
            "reference program has {} blocks — control-flow ops "
            "(while/conditional_block) with sub-blocks are not supported "
            "by the artifact loader yet; export an inference-pruned "
            "single-block program".format(len(program_desc["blocks"])))
    prog = Program()
    block = prog.global_block()
    ref_block = program_desc["blocks"][0]
    for var in ref_block["vars"].values():
        if var["name"] in ("feed", "fetch"):
            continue
        shape = var.get("shape")
        if shape is not None:
            shape = [abs(int(d)) if int(d) != -1 else -1 for d in shape]
        block.create_var(name=var["name"],
                         shape=shape,
                         dtype=var.get("dtype") or "float32",
                         persistable=var["persistable"])
    feed_names: List[str] = []
    fetch_names: List[str] = []
    for op in ref_block["ops"]:
        if op["type"] == "feed":
            feed_names.extend(op["outputs"].get("Out", []))
            continue
        if op["type"] == "fetch":
            fetch_names.extend(op["inputs"].get("X", []))
            continue
        attrs = {k: v for k, v in op["attrs"].items()
                 if not k.startswith("op_")}  # op_role/op_role_var markers
        block.append_op(op["type"], op["inputs"], op["outputs"], attrs)
    return prog, feed_names, fetch_names


def load_reference_inference_model(dirname: str,
                                   model_filename: Optional[str] = None,
                                   params_filename: Optional[str] = None,
                                   scope=None, place=None):
    """Reference ``load_inference_model`` (io.py:1113) parity for
    reference-SAVED artifacts: returns (program, feed_names,
    fetch_names) and loads every persistable into `scope` (default: the
    global scope) as torch tensors on `place` (default ``CUDAPlace(0)``;
    ``CPUPlace()`` is the explicit CPU request)."""
    from ..core.dtypes import from_numpy
    from ..core.executor import CUDAPlace
    from ..core.scope import global_scope

    device = (place or CUDAPlace(0)).torch_device()
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        desc = parse_program_desc(f.read())
    prog, feed_names, fetch_names = _build_program(desc)
    params = load_reference_persistables(dirname, desc, params_filename)
    scope = scope or global_scope()
    for name, arr in params.items():
        scope.set_var(name, from_numpy(arr, device=device))
    return prog, feed_names, fetch_names


# -- export (artifacts flow BACK to the reference) --------------------------



def export_reference_inference_model(dirname: str, feed_names, fetch_names,
                                     program, scope=None,
                                     params_filename: Optional[str] = None):
    """Write one of the port's inference Programs + its persistables in the
    REFERENCE's binary formats — the inverse of
    :func:`load_reference_inference_model`, so models trained here can be
    served by the reference's load_inference_model (io.py:1113) /
    AnalysisPredictor. Emits the feed/fetch ops and holder vars the
    reference loader expects (io.py save_inference_model conventions) and
    one LoDTensor stream per persistable (or a save_combine-style single
    file when ``params_filename`` is given, in sorted-name order —
    io.py:242 builds the save_combine input list from
    ``sorted(save_var_map.keys())``)."""
    from ..core.dtypes import dtype_str
    from ..core.scope import global_scope
    from ..io import _host_array

    scope = scope or global_scope()
    if len(program.blocks) > 1:
        raise NotImplementedError(
            f"export_reference_inference_model: program has "
            f"{len(program.blocks)} blocks — control-flow sub-blocks have "
            f"no export path yet; export an inference-pruned single-block "
            f"program (the loader refuses these too)")
    block = program.global_block()
    feed_names = list(feed_names)
    fetch_names = list(fetch_names)

    varz = {
        "feed": {"name": "feed", "type": VT_FEED_MINIBATCH, "dtype": None,
                 "shape": None, "persistable": True, "lod_level": 0},
        "fetch": {"name": "fetch", "type": VT_FETCH_LIST, "dtype": None,
                  "shape": None, "persistable": True, "lod_level": 0},
    }
    for v in program.list_vars():
        if v.name in ("feed", "fetch"):
            # would clobber the feed/fetch holder entries in varz, and the
            # loader's persistable selection skips these names — the
            # combined stream would silently desynchronize
            raise ValueError(
                f"export_reference_inference_model: var name {v.name!r} "
                f"collides with the reference's feed/fetch holder vars — "
                f"rename it before export")
        shape = None
        try:
            shape = [int(d) if d is not None else -1 for d in (v.shape or [])]
        except Exception:
            pass
        try:
            dt = dtype_str(getattr(v, "dtype", "float32") or "float32")
        except Exception:
            dt = "float32"
        if dt not in _DTYPE_IDS:
            raise ValueError(
                f"export_reference_inference_model: var {v.name!r} dtype "
                f"{dt} has no reference VarType encoding (the Fluid 1.5 "
                f"schema predates bf16) — cast persistables to float32 "
                f"before export")
        varz[v.name] = {
            "name": v.name, "type": VT_LOD_TENSOR,
            "dtype": dt, "shape": shape,
            "persistable": bool(v.persistable), "lod_level": 0,
        }

    def _clean_attrs(op):
        out = {}
        for k, val in op.attrs.items():
            if k.startswith("op_"):
                continue  # op_role/op_role_var markers — loader ignores
            if k in ("sub_block", "sub_blocks"):
                raise NotImplementedError(
                    f"export_reference_inference_model: op {op.type} "
                    f"carries a sub-block — control flow cannot be "
                    f"exported")
            if isinstance(val, (bool, int, float, str)):
                out[k] = val
            elif isinstance(val, (list, tuple)) and all(
                    isinstance(x, (bool, int, float, str)) for x in val):
                out[k] = list(val)
            elif hasattr(val, "item"):            # numpy scalar
                out[k] = val.item()
            else:
                raise ValueError(
                    f"export_reference_inference_model: op {op.type} attr "
                    f"{k!r} ({type(val).__name__}) has no reference wire "
                    f"encoding — prune it or export a simpler program")
        return out

    ops = []
    for i, n in enumerate(feed_names):
        ops.append({"type": "feed", "inputs": {"X": ["feed"]},
                    "outputs": {"Out": [n]}, "attrs": {"col": i}})
    for op in block.ops:
        ops.append({"type": op.type, "inputs": dict(op.inputs),
                    "outputs": dict(op.outputs), "attrs": _clean_attrs(op)})
    for i, n in enumerate(fetch_names):
        ops.append({"type": "fetch", "inputs": {"X": [n]},
                    "outputs": {"Out": ["fetch"]}, "attrs": {"col": i}})

    desc = {"blocks": [{"idx": 0, "parent_idx": -1, "vars": varz,
                        "ops": ops}]}
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        f.write(serialize_program_desc(desc))

    persist = []
    for v in program.list_vars():
        if not v.persistable:
            continue
        if scope.find_var(v.name) is None:
            raise ValueError(
                f"export_reference_inference_model: persistable var "
                f"{v.name!r} has no value in the scope — exporting would "
                f"desynchronize the combined-params stream order the "
                f"reference loader expects (run startup / load weights "
                f"first, or pass the right scope)")
        persist.append(v.name)
    if params_filename is not None:
        with open(os.path.join(dirname, params_filename), "wb") as f:
            for n in sorted(persist):
                write_lod_tensor_stream(
                    f, _host_array(program, n, scope.find_var(n)))
    else:
        for n in persist:
            with open(os.path.join(dirname, n), "wb") as f:
                write_lod_tensor_stream(
                    f, _host_array(program, n, scope.find_var(n)))
    return fetch_names
