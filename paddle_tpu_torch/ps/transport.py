"""Transport for the PS embedding tier: clients and the shard server (the
port's copy of ``paddle_tpu.ps.transport``; the frames are the same bytes,
so a port client talks to a JAX ``ShardServer`` and the reverse).

Two transports behind one interface:

* ``InProcessClient`` — the shard object lives in this process; calls are
  direct method dispatch. This is what single-host training and the tier-1
  tests use (no sockets, no pickling, zero copies beyond the pull itself).
* ``SocketClient`` / ``ShardServer`` — a length-prefixed binary protocol
  over TCP so shards can live in other processes or hosts (the reference's
  pserver processes; ``tests/torch_ps_server_runner.py`` ends up in
  ``ShardServer.serve_forever``). The server side is numpy + stdlib only —
  a pserver process imports neither torch nor JAX and never touches the
  card.

Wire format: every message is ``<u32 length><u32 json_len><json
header><array blobs>``. The header is plain JSON (op names, table names,
counters); each ndarray in the message is replaced by a
``{"__nd__": [dtype, shape, offset, nbytes]}`` marker pointing into the
raw blob region that follows, so decoding an array costs one
``np.frombuffer``. Deliberately NOT pickle: a pserver port accepts
connections from anything that can reach it, and ``pickle.loads`` on that
input is arbitrary code execution — JSON + validated buffer slices can
only ever produce dicts/lists/scalars/ndarrays. The port should still be
network-isolated (trainer-cluster only): the protocol is unauthenticated,
so anyone who can reach it can read and overwrite table rows. One
request, one reply; the server is thread-per-connection and a client
keeps one persistent connection per shard (requests on it are serialized
by a lock, concurrency comes from fanning out across shards).

Failure taxonomy. Every transport-level failure is a
:class:`TransportError` carrying ``transient``:

* ``transient=True`` — connect refused, timeout, peer closed / short
  read, ``ECONNRESET``: the kind of error a restarting or briefly
  unreachable shard produces. ``SocketClient`` retries these itself —
  reconnect + capped exponential backoff, ``PDTPU_PS_RETRIES`` attempts
  (default 5) starting at ``PDTPU_PS_RETRY_BACKOFF_MS`` (default 50,
  capped at 5 s), per-socket ``PDTPU_PS_TIMEOUT`` seconds (default 30) —
  counting each retry on ``ps/rpc_retries``. Only when retries are
  exhausted does the error reach the caller (still ``transient=True``:
  the shard may yet come back — this is what the tier's recovery hook
  keys on).
* ``transient=False`` — a structurally invalid frame (bad header JSON,
  bad array marker, > cap message): reconnecting cannot fix a peer that
  speaks garbage, so these surface immediately.

Restart detection: every server reply carries the server's random
instance id; a client that sees the id change between replies raises
:class:`ShardRestartedError` (transient) instead of silently reading a
freshly-booted — and therefore EMPTY — shard. Recovery code calls
``reset_instance_expectation()`` after repopulating the shard.

Chaos: the server probes ``fault_point("ps.rpc")`` on every request
(``faults``) — ``drop`` swallows the request and closes the
connection with no reply, ``reset`` closes with an RST (``SO_LINGER 0``),
``delay_ms`` models a slow shard, ``crash`` is a real pserver death — so
every client-visible failure mode is deterministically injectable.

Distributed tracing: when a `observability.context.TraceContext` is
active on the calling thread, each RPC attempt carries a ``"trace"``
dict in the JSON header (``{"trace_id", "span_id"}`` — re-sent frames
add ``"retry": n`` and a FRESH span_id under the SAME trace_id), the
client records a ``ps/rpc/<op>`` span, and the server opens a
``ps/<op>`` span parented to the client's — so one training step's pulls
show up as one trace across worker and pserver processes. The server
additionally answers ``metrics`` (the registry's structured
`series()`) and ``trace_export`` (its chrome trace) ops, which is how a
pserver with no HTTP port gets federated.
"""
from __future__ import annotations

import json
import math
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..faults import InjectedNetworkFault, fault_point
from ..observability import context as _trace_ctx
from ..observability.registry import get_registry
from ..observability.tracer import get_tracer, server_span
from .shard import EmbeddingShard

__all__ = ["TransportError", "ShardRestartedError", "ShardClient",
           "InProcessClient", "SocketClient", "ShardServer", "connect",
           "probe"]

_LEN = struct.Struct("<I")
_MAX_MSG = 1 << 30  # 1 GiB sanity cap on a single message

_RPC_RETRIES = get_registry().counter("ps/rpc_retries")


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

    def sweep(self, name: str) -> int:
        """Run one dynamic-vocab eviction pass on table `name`; returns
        rows evicted (0 for a static shard — sweeping is a no-op there,
        not an error, so a mixed static/dynamic fleet sweeps uniformly)."""
        raise NotImplementedError

    def reset_instance_expectation(self) -> None:
        """Forget the remembered server instance id: the next reply's id
        is adopted without raising ShardRestartedError. Recovery calls
        this once the restarted shard has been repopulated."""

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

    def sweep(self, name):
        sh = self._get(name)
        fn = getattr(sh, "sweep", None)
        return int(fn()) if fn is not None else 0

    def ping(self):
        return True


class SocketClient(ShardClient):
    """Persistent-connection client for a remote ``ShardServer``.

    The connection is LAZY (first RPC connects) and self-healing: any
    transient failure drops the socket, backs off, reconnects, and
    re-sends — safe because every op is idempotent (pull reads, push/load
    scatter-SET absolute rows). Constructor args override the
    ``PDTPU_PS_*`` environment defaults; ``retries=0`` makes a
    single-shot probe client (what ShardMonitor uses)."""

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self._timeout = timeout
        self._retries = retries
        self._backoff_ms = backoff_ms
        self._sock: Optional[socket.socket] = None
        self._inst: Optional[str] = None
        self._lock = threading.Lock()

    # env resolved per call, not per client: tests and operators tune the
    # knobs on a live process
    def _cfg(self) -> Tuple[float, int, float]:
        t = (self._timeout if self._timeout is not None
             else float(os.environ.get("PDTPU_PS_TIMEOUT", "30")))
        r = (self._retries if self._retries is not None
             else int(os.environ.get("PDTPU_PS_RETRIES", "5")))
        b = (self._backoff_ms if self._backoff_ms is not None
             else float(os.environ.get("PDTPU_PS_RETRY_BACKOFF_MS", "50")))
        return t, r, b

    def _ensure_sock(self, timeout: float) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        else:
            self._sock.settimeout(timeout)
        return self._sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, op: str, _retryable: bool = True, **kw):
        msg = {"op": op, **kw}
        timeout, retries, backoff_ms = self._cfg()
        attempt = 0
        tracer = get_tracer()
        with self._lock:
            while True:
                # per-ATTEMPT trace header: same trace_id across a retry
                # but a fresh span_id + retry tag, so a torn-frame re-send
                # is visibly a second RPC in the same trace
                span = None
                ctx = _trace_ctx.current()
                if ctx is not None:
                    rctx = ctx.child()
                    wire = rctx.to_wire()
                    if attempt:
                        wire["retry"] = attempt
                    msg["trace"] = wire
                    if tracer.enabled:
                        sargs = dict(rctx.args(), rpc="client", op=op,
                                     endpoint=self.endpoint)
                        if attempt:
                            sargs["retry"] = attempt
                        span = f"ps/rpc/{op}"
                        tracer.begin(span, sargs)
                try:
                    sock = self._ensure_sock(timeout)
                    _send_msg(sock, msg)
                    rep = _recv_msg(sock)
                    break
                except OSError as e:  # TransportError, timeout, ECONNRESET
                    # a dirty socket cannot be reused: mid-frame state is
                    # unknowable after any failure
                    self._drop_sock()
                    transient = getattr(e, "transient", True)
                    if (not transient or not _retryable
                            or attempt >= retries):
                        raise TransportError(
                            f"{op}: {e}", transient=transient,
                            endpoint=self.endpoint,
                            attempts=attempt + 1) from e
                    _RPC_RETRIES.inc()
                    time.sleep(min(backoff_ms * (2 ** attempt), 5000.0)
                               / 1e3)
                    attempt += 1
                finally:
                    if span is not None:
                        tracer.end(span)
            inst = rep.get("inst")
            if isinstance(inst, str):
                if self._inst is None:
                    self._inst = inst
                elif self._inst != inst:
                    # do NOT adopt: every call keeps failing until
                    # recovery repopulates the shard and calls
                    # reset_instance_expectation() — otherwise the first
                    # raise would "cure" the client and the next read
                    # would silently see a freshly-booted EMPTY shard
                    raise ShardRestartedError(self.endpoint, self._inst,
                                              inst)
        if rep.get("err"):
            raise RuntimeError(f"ps shard {self.endpoint} {op}: "
                               f"{rep['err']}")
        return rep.get("out")

    def pull(self, name, ids):
        return self._call("pull", name=name,
                          ids=np.asarray(ids, dtype=np.int64))

    def push(self, name, ids, rows):
        self._call("push", name=name,
                   ids=np.asarray(ids, dtype=np.int64),
                   rows=np.asarray(rows, dtype=np.uint16))

    def dump(self, name):
        return self._call("dump", name=name)

    def load(self, name, rows):
        self._call("load", name=name,
                   rows=np.asarray(rows, dtype=np.uint16))

    def meta(self):
        return self._call("meta")

    def stats(self):
        return self._call("stats")

    def sweep(self, name):
        return int(self._call("sweep", name=name))

    def metrics(self):
        """The server process's `Registry.series()` — how a pserver
        (no HTTP port, no torch) joins metrics federation."""
        return self._call("metrics")

    def trace_export(self):
        """The server process's chrome trace (``{"traceEvents": ...}``),
        whose spans carry the callers' trace ids."""
        return self._call("trace_export")

    def ping(self):
        return bool(self._call("ping"))

    def reset_instance_expectation(self):
        with self._lock:
            self._inst = None

    def shutdown_server(self):
        """Ask the server process to stop (tests / orderly teardown)."""
        try:
            self._call("shutdown", _retryable=False)
        except (ConnectionError, OSError):
            pass  # server may close before replying

    def close(self):
        with self._lock:
            self._drop_sock()


def probe(endpoint: str, timeout: float = 2.0) -> bool:
    """One-shot liveness check: fresh connection, single ping, close.
    Never retries, never touches a persistent client's socket or
    instance expectation — safe to call from a monitor thread at any
    rate. Returns False on ANY failure."""
    c = SocketClient(endpoint, timeout=timeout, retries=0)
    try:
        return c.ping()
    except Exception:
        return False
    finally:
        c.close()


def connect(endpoint_or_shards) -> ShardClient:
    """``"host:port"`` → SocketClient; a shard list → InProcessClient."""
    if isinstance(endpoint_or_shards, str):
        return SocketClient(endpoint_or_shards)
    return InProcessClient(endpoint_or_shards)


# ------------------------------------------------------------------ server

class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        # registration makes shutdown() able to unblock this thread's
        # recv by closing the socket out from under it
        self.server.ps_server._track(self.request,
                                     threading.current_thread())

    def finish(self):
        self.server.ps_server._untrack(self.request)

    def handle(self):
        srv: "ShardServer" = self.server.ps_server  # type: ignore
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                msg = _recv_msg(sock)
            except (ConnectionError, OSError):
                return
            try:
                fault_point("ps.rpc")
            except InjectedNetworkFault as f:
                if f.kind == "reset":
                    # SO_LINGER 0 → close sends RST, the client sees
                    # ECONNRESET (a crashed pserver); plain close models
                    # a swallowed request (drop)
                    try:
                        sock.setsockopt(
                            socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
                    except OSError:
                        pass
                return
            op = msg.get("op")
            if op == "shutdown":
                try:
                    _send_msg(sock, {"out": True, "inst": srv.instance_id})
                finally:
                    threading.Thread(target=srv.stop,
                                     daemon=True).start()
                return
            wire = msg.get("trace")
            sargs = {"rpc": "server", "op": str(op)}
            if isinstance(wire, dict) and wire.get("retry"):
                sargs["retry"] = wire["retry"]
            t0 = time.perf_counter()
            try:
                with server_span(f"ps/{op}", wire, **sargs):
                    rep = {"out": srv.dispatch(op, msg)}
            except Exception as e:  # report, keep the connection alive
                rep = {"err": f"{type(e).__name__}: {e}"}
            srv._account(op, (time.perf_counter() - t0) * 1e3)
            rep["inst"] = srv.instance_id
            try:
                _send_msg(sock, rep)
            except (ConnectionError, OSError):
                return


class _TCP(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # ShardServer.stop() does its own BOUNDED join after closing the live
    # connection sockets; the stdlib's unbounded _threads.join() would
    # hang on a handler blocked in recv()
    block_on_close = False


class ShardServer:
    """Serves a set of ``EmbeddingShard`` objects over the socket
    protocol. ``serve_in_thread()`` for tests / co-hosted shards,
    ``serve_forever()`` for a dedicated pserver process
    (``tests/torch_ps_server_runner.py``)."""

    def __init__(self, shards: Sequence[EmbeddingShard],
                 host: str = "127.0.0.1", port: int = 0,
                 delay_ms: float = 0.0):
        """delay_ms: simulated per-request network latency on pull/push
        (tests and single-host benches modelling cross-host RTT — a
        loopback server has none, so overlap A/Bs would otherwise be
        measuring pure serialization CPU time)."""
        self.local = InProcessClient(shards)
        self.delay_ms = float(delay_ms)
        # random per-boot token: lets clients detect "this pserver
        # restarted (and lost its rows) between my RPCs"
        self.instance_id = os.urandom(8).hex()
        self._tcp = _TCP((host, port), _Handler)
        self._tcp.ps_server = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._conn_lock = threading.Lock()
        self._conns: Dict[socket.socket, threading.Thread] = {}
        self._serving = False
        self._stopped = False

    @property
    def endpoint(self) -> str:
        host, port = self._tcp.server_address[:2]
        return f"{host}:{port}"

    def _track(self, sock: socket.socket, thread: threading.Thread):
        with self._conn_lock:
            self._conns[sock] = thread

    def _untrack(self, sock: socket.socket):
        with self._conn_lock:
            self._conns.pop(sock, None)

    def _account(self, op, ms: float) -> None:
        """Server-side per-op request counter + handling-time histogram:
        the federation scraper reads these over the `metrics` op, which
        is how per-SHARD serve time reaches the autoscaler surface."""
        reg = get_registry()
        reg.counter("ps/server_requests", op=str(op)).inc()
        reg.histogram("ps/server_ms", op=str(op)).observe(ms)

    def dispatch(self, op: str, msg: dict):
        if op == "ping":
            return True
        if op == "meta":
            return self.local.meta()
        if op == "stats":
            return self.local.stats()
        if op == "metrics":
            return get_registry().series(deep=True)
        if op == "trace_export":
            return get_tracer().export_chrome_trace()
        name = msg.get("name")
        if op in ("pull", "push") and self.delay_ms:
            time.sleep(self.delay_ms / 1e3)
        if op == "pull":
            return self.local.pull(name, msg["ids"])
        if op == "push":
            self.local.push(name, msg["ids"], msg["rows"])
            return True
        if op == "dump":
            return self.local.dump(name)
        if op == "load":
            self.local.load(name, msg["rows"])
            return True
        if op == "sweep":
            return self.local.sweep(name)
        raise ValueError(f"unknown ps op {op!r}")

    def serve_in_thread(self) -> "ShardServer":
        self._serving = True
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        name=f"ps-server@{self.endpoint}",
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._serving = True
        self._tcp.serve_forever()

    def stop(self, join_timeout: float = 5.0):
        """Stop accepting, unblock and join every live per-connection
        handler (bounded): a test teardown or the ``shutdown`` op must
        not leak daemon threads holding the port — or sockets — into the
        next test case. Idempotent."""
        with self._conn_lock:
            if self._stopped:
                return
            self._stopped = True
        if self._serving:
            # BaseServer.shutdown() blocks on serve_forever's exit event;
            # calling it on a never-served server would wait forever
            self._tcp.shutdown()
        self._tcp.server_close()
        with self._conn_lock:
            live = list(self._conns.items())
        for sock, _ in live:
            # recv() in the handler returns immediately once the socket
            # is shut down under it
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        deadline = time.monotonic() + join_timeout
        me = threading.current_thread()
        for _, t in live:
            if t is me or not t.is_alive():
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if self._thread is not None and self._thread is not me:
            self._thread.join(timeout=max(0.0,
                                          deadline - time.monotonic()))
            self._thread = None
