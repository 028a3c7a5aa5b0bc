"""Transport for the PS embedding tier: the client interface, the
in-process client and the frame codec (the port's copy of that part of
``paddle_tpu.ps.transport``).

``InProcessClient`` — the shard object lives in this process; calls are
direct method dispatch. This is what single-host training and the tests use
(no sockets, no pickling, zero copies beyond the pull itself). The socket
transport (``SocketClient``, ``ShardServer``, ``connect``) is not ported:
constructing one raises ``NotImplementedError`` (ROADMAP A8).

The frame codec (``_send_msg`` / ``_recv_msg``) is ported: the serving
fleet's worker RPC speaks it. Every message is ``<u32 length><u32
json_len><json header><array blobs>``; each ndarray in the message is
replaced by a ``{"__nd__": [dtype, shape, offset, nbytes]}`` marker into
the blob region that follows, so decoding an array costs one
``np.frombuffer``. Deliberately not pickle: JSON plus validated buffer
slices can only produce dicts, lists, scalars and ndarrays.

Failure taxonomy: every transport-level failure is a
:class:`TransportError` carrying ``transient`` (a reconnect might
succeed); :class:`ShardRestartedError` is the transient "the shard came
back empty" case.
"""
from __future__ import annotations

import json
import math
import socket
import struct
from typing import Dict, List, Sequence

import numpy as np

from .shard import EmbeddingShard

__all__ = ["TransportError", "ShardRestartedError", "ShardClient",
           "InProcessClient", "SocketClient", "ShardServer", "connect"]


class TransportError(ConnectionError):
    """A PS transport failure. ``transient=True`` means a reconnect might
    succeed (shard restarting / network blip) — retry loops and the
    recovery hook key on it; ``transient=False`` means the peer is
    speaking a broken protocol and retrying is pointless. A
    ``ConnectionError`` subclass so pre-taxonomy ``except`` clauses (and
    the server's per-connection loop) keep working."""

    def __init__(self, msg: str, transient: bool, endpoint: str = "",
                 attempts: int = 0):
        if endpoint:
            msg = f"ps shard {endpoint}: {msg}"
        if attempts > 1:
            msg += f" (after {attempts} attempts)"
        super().__init__(msg)
        self.transient = bool(transient)
        self.endpoint = endpoint
        self.attempts = attempts


class ShardRestartedError(TransportError):
    """The shard answered with a different server instance id than the
    last reply: the pserver process restarted (losing its in-memory rows)
    between two RPCs. Always transient — the fix is repopulating the
    shard (``ShardedTable.recover_shard``), not giving up."""

    def __init__(self, endpoint: str, old: str, new: str):
        super().__init__(
            f"server instance changed {old!r} -> {new!r}: the pserver "
            "restarted and its in-memory rows are gone; recover the shard "
            "before trusting reads", transient=True, endpoint=endpoint)


# ---------------------------------------------------------------- encoding

_LEN = struct.Struct("<I")
_MAX_MSG = 1 << 30  # 1 GiB sanity cap on a single message

_ND = "__nd__"  # reserved header key marking an array blob


def _pack_msg(obj) -> bytes:
    """JSON header + concatenated array blobs (see module docstring)."""
    blobs: List[bytes] = []
    off = 0

    def enc(v):
        nonlocal off
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            raw = a.tobytes()
            mark = {_ND: [str(a.dtype), list(a.shape), off, len(raw)]}
            blobs.append(raw)
            off += len(raw)
            return mark
        if isinstance(v, dict):
            if _ND in v:
                raise ValueError(f"ps transport: key {_ND!r} is reserved")
            return {k: enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        if isinstance(v, (np.integer, np.floating, np.bool_)):
            return v.item()
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        raise TypeError(
            f"ps transport cannot encode {type(v).__name__}")

    head = json.dumps(enc(obj), separators=(",", ":")).encode("utf-8")
    return b"".join([_LEN.pack(len(head)), head] + blobs)


def _unpack_msg(payload: bytes):
    if len(payload) < _LEN.size:
        raise TransportError("truncated frame", transient=False)
    (nhead,) = _LEN.unpack_from(payload)
    blob0 = _LEN.size + nhead
    if blob0 > len(payload):
        raise TransportError("header overruns frame", transient=False)
    try:
        head = json.loads(payload[_LEN.size:blob0].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise TransportError(f"bad header: {e}", transient=False) from None

    def dec_arr(mark) -> np.ndarray:
        try:
            dt, shape, off, nbytes = mark
            dtype = np.dtype(dt)
            shape = tuple(int(s) for s in shape)
            off, nbytes = int(off), int(nbytes)
        except (TypeError, ValueError) as e:
            raise TransportError(
                f"bad array marker: {e}", transient=False) from None
        if dtype.hasobject or any(s < 0 for s in shape) or off < 0:
            raise TransportError("bad array marker", transient=False)
        count = math.prod(shape)
        if nbytes != count * dtype.itemsize \
                or blob0 + off + nbytes > len(payload):
            raise TransportError("array segment out of bounds",
                                 transient=False)
        return np.frombuffer(payload, dtype=dtype, count=count,
                             offset=blob0 + off).reshape(shape)

    def dec(v):
        if isinstance(v, dict):
            if _ND in v:
                return dec_arr(v[_ND])
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    return dec(head)


def _send_msg(sock: socket.socket, obj) -> None:
    payload = _pack_msg(obj)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly `n` bytes. A half-closed socket (peer died or sent a
    torn frame) raises a TRANSIENT TransportError naming how much of the
    frame arrived — reconnect + retry gets a fresh, resynchronized
    stream, which is exactly what the client's retry loop does."""
    want = n
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise TransportError(
                f"peer closed mid-message: expected {want} bytes, "
                f"got {want - n}", transient=True)
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_MSG:
        raise TransportError(f"message of {n} bytes exceeds {_MAX_MSG} "
                             "cap", transient=False)
    return _unpack_msg(_recv_exact(sock, n))


# ----------------------------------------------------------------- clients

class ShardClient:
    """What the table/tier layer codes against — one client per shard.

    All ids are GLOBAL row ids (the shard translates). ``pull`` returns
    packed ``[k, lanes] uint16`` rows; ``push`` scatter-sets whole rows.
    """

    def pull(self, name: str, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def push(self, name: str, ids: np.ndarray, rows: np.ndarray) -> None:
        raise NotImplementedError

    def dump(self, name: str) -> np.ndarray:
        raise NotImplementedError

    def load(self, name: str, rows: np.ndarray) -> None:
        raise NotImplementedError

    def meta(self) -> dict:
        """{table_name: {"lo": int, "hi": int, "lanes": int}}"""
        raise NotImplementedError

    def stats(self) -> dict:
        """{table_name: shard.stats()} — byte/pull/push counters."""
        raise NotImplementedError

    def ping(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcessClient(ShardClient):
    """Direct dispatch onto shard objects living in this process. One
    'shard worker' may host the matching slice of several tables (the
    common case: all sparse tables of a model partitioned the same way)."""

    def __init__(self, shards: Sequence[EmbeddingShard]):
        self._shards: Dict[str, EmbeddingShard] = {}
        for s in shards:
            if s.name in self._shards:
                raise ValueError(f"InProcessClient: duplicate table "
                                 f"{s.name!r}")
            self._shards[s.name] = s

    def _get(self, name: str) -> EmbeddingShard:
        try:
            return self._shards[name]
        except KeyError:
            raise KeyError(f"shard client has no table {name!r}; tables: "
                           f"{sorted(self._shards)}") from None

    def pull(self, name, ids):
        return self._get(name).pull(ids)

    def push(self, name, ids, rows):
        self._get(name).push(ids, rows)

    def dump(self, name):
        return self._get(name).dump()

    def load(self, name, rows):
        self._get(name).load(rows)

    def meta(self):
        return {n: {"lo": s.lo, "hi": s.hi, "lanes": s.rows.shape[1]}
                for n, s in self._shards.items()}

    def stats(self):
        return {n: s.stats() for n, s in self._shards.items()}

    def ping(self):
        return True


def _socket_not_ported(what):
    raise NotImplementedError(
        f"{what}: the PS socket transport is not ported to paddle_tpu_torch "
        f"yet (ROADMAP A8); build the table with "
        f"ShardedTable.build_in_process or InProcessClient")


class SocketClient(ShardClient):
    """Client of a remote shard server — not ported (raises)."""

    def __init__(self, endpoint: str, *args, **kwargs):
        _socket_not_ported("SocketClient")


class ShardServer:
    """Shard server process side — not ported (raises)."""

    def __init__(self, shards, *args, **kwargs):
        _socket_not_ported("ShardServer")


def connect(endpoint_or_shards) -> ShardClient:
    """A client for in-process shards; endpoints (the socket transport)
    raise NotImplementedError."""
    if isinstance(endpoint_or_shards, str):
        _socket_not_ported(f"connect({endpoint_or_shards!r})")
    return InProcessClient(endpoint_or_shards)
