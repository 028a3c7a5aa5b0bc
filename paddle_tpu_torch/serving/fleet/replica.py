"""Fleet replicas: one Predictor + InferenceServer per replica.

Two isolation levels behind one interface:

* ``ThreadReplica`` — the replica's `InferenceServer` lives in this
  process (shared-nothing by discipline: its own predictor, queue,
  metrics). What single-host fleets and most tests use — a "replica
  death" is a stopped server, failover is exercised without process
  machinery.
* ``ProcessReplica`` — a real subprocess running
  ``python -m paddle_tpu_torch.serving.fleet.worker`` (a fresh
  interpreter: never a fork of a process whose CUDA is up), speaking the
  PS tier's length-prefixed JSON+blob frames (``ps.transport``'s codec,
  pickle-free) over a loopback socket. SIGKILL-able: an
  in-flight request on a killed worker surfaces as a *transient*
  ``TransportError``, which is exactly what the router retries on
  another replica.

Both expose: ``submit() -> Future``, ``outstanding`` (the router's
least-outstanding signal), ``health()`` (the server's /healthz view —
state 'draining' tells the router to stop sending before admission
closes), ``swap(model)`` (background-warm the new version, then an
atomic flip + drain of the old server — zero dropped requests), and
``stop()`` / ``kill()``.

Device: a replica serves on CUDA device 0 unless ``device`` says
otherwise (``"cpu"`` or ``"cuda:N"``); a process replica passes it to its
worker as ``--device``.
"""
from __future__ import annotations

import os
import queue
import socket
import subprocess
import sys
import threading
import time

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from ..batcher import DEFAULT_BUCKETS, ServingError
from ..metrics import Metrics
from ..server import InferenceServer, QueueFullError, ServerClosedError
from ...observability import context as _trace_ctx
from ...observability.tracer import get_tracer
from ...ps.transport import TransportError, _recv_msg, _send_msg
from .registry import ModelVersion

__all__ = ["ProcessReplica", "ReplicaDeadError", "ThreadReplica"]


class ReplicaDeadError(ServingError):
    """The replica's process/server is gone; route elsewhere."""


def serving_config(model_dir: str, device: Optional[str] = None):
    """An inference Config for `model_dir` on `device` (None or "cuda":
    CUDA device 0; "cuda:N"; "cpu")."""
    from ...inference import Config
    cfg = Config(model_dir)
    dev = str(device or "cuda")
    if dev == "cpu":
        cfg.disable_gpu()
    elif dev == "cuda" or dev.startswith("cuda:"):
        cfg.enable_use_gpu(device_id=int(dev.split(":", 1)[1])
                           if ":" in dev else 0)
    else:
        raise ValueError(f"unknown serving device {device!r}; expected "
                         "'cuda', 'cuda:N' or 'cpu'")
    return cfg


def _default_factory(model: ModelVersion, device: Optional[str] = None):
    from ...inference import create_predictor
    return create_predictor(serving_config(model.model_dir, device),
                            precision=model.precision)


class ThreadReplica:
    """In-process replica: its own InferenceServer over its own
    predictor. `predictor_factory(model: ModelVersion)` customizes how a
    version's bytes become a predictor (e.g. wrap in a
    PsLookupPredictor for PS-backed serving); without one the replica
    serves `model` on `device`."""

    kind = "thread"

    def __init__(self, name: str, model: ModelVersion,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 predictor_factory=None, warm: bool = True,
                 example_feed: Optional[Dict[str, np.ndarray]] = None,
                 server_kwargs: Optional[dict] = None,
                 device: Optional[str] = None):
        self.name = name
        self._factory = predictor_factory or (
            lambda m: _default_factory(m, device))
        self._buckets = tuple(buckets)
        self._warm = warm
        self._example_feed = example_feed
        self._server_kwargs = dict(server_kwargs or {})
        self._lock = threading.Lock()
        self._olock = threading.Lock()
        self._outstanding = 0
        self._killed = False
        self._model = model
        self._server = self._build_server(model)

    def _build_server(self, model: ModelVersion) -> InferenceServer:
        pred = self._factory(model)
        kw = dict(self._server_kwargs)
        # isolated metrics per replica server: N replicas (and their
        # swapped-out predecessors) must not fight over one metric name
        # space in the global registry
        kw.setdefault("metrics", Metrics(attach=False))
        srv = InferenceServer(pred, buckets=self._buckets, **kw)
        if self._warm:
            srv.warmup(example_feed=self._example_feed)
        srv.start()
        return srv

    # -- request path -------------------------------------------------------
    @property
    def outstanding(self) -> int:
        with self._olock:
            return self._outstanding

    def _track(self, fut: Future) -> Future:
        with self._olock:
            self._outstanding += 1

        def done(_):
            with self._olock:
                self._outstanding -= 1

        fut.add_done_callback(done)
        return fut

    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None) -> Future:
        last: Optional[Exception] = None
        for _ in range(2):  # one retry: a swap may flip the server mid-call
            with self._lock:
                srv, killed = self._server, self._killed
            if srv is None or killed:
                raise ReplicaDeadError(f"replica {self.name} is dead")
            try:
                return self._track(srv.submit(feed, timeout_ms=timeout_ms))
            except ServerClosedError as e:
                last = e
        raise last

    def infer(self, feed, timeout_ms=None):
        return self.submit(feed, timeout_ms=timeout_ms).result()

    # -- observability ------------------------------------------------------
    def metrics(self) -> list:
        """This replica's serving metrics as a structured series list
        (`Registry.series` shape) — the federation scrape surface."""
        with self._lock:
            srv = self._server
        if srv is None:
            return []
        return srv.metrics.series(deep=True)

    def trace_export(self) -> dict:
        """Chrome-trace events from this replica's process — which for a
        thread replica is the host process tracer."""
        return get_tracer().export_chrome_trace()

    # -- lifecycle ----------------------------------------------------------
    @property
    def version(self) -> str:
        return self._model.version

    @property
    def model_dir(self) -> str:
        return self._model.model_dir

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._server is not None and not self._killed

    def health(self) -> dict:
        with self._lock:
            srv, killed = self._server, self._killed
        if srv is None or killed:
            return {"status": "failing", "state": "dead",
                    "checks": {"replica": {"status": "failing",
                                           "detail": "replica stopped"}}}
        h = srv.health()
        h["version"] = self._model.version
        return h

    def swap(self, model: ModelVersion) -> dict:
        """Zero-downtime version swap: warm the new server while the old
        one keeps serving, flip atomically, then drain the old server so
        every admitted request completes. Returns
        {"version", "warm_ms", "drained": stop-report}."""
        t0 = time.monotonic()
        new_srv = self._build_server(model)
        warm_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            if self._killed or self._server is None:
                new_srv.stop(drain=False)
                raise ReplicaDeadError(
                    f"replica {self.name} died during swap warmup")
            old, self._server = self._server, new_srv
            self._model = model
        report = old.stop(drain=True)
        return {"version": model.version, "warm_ms": warm_ms,
                "drained": report}

    def stop(self) -> dict:
        with self._lock:
            srv, self._server = self._server, None
        if srv is None:
            return {"pending": 0, "completed": 0, "rejected": 0}
        return srv.stop(drain=True)

    def kill(self) -> None:
        """Abrupt death for failover tests: pending work fails, the
        replica reports dead, nothing is drained."""
        with self._lock:
            srv, self._server = self._server, None
            self._killed = True
        if srv is not None:
            srv.stop(drain=False)


def _map_worker_error(reply: dict) -> Exception:
    kind = reply.get("kind", "")
    msg = reply.get("err", "worker error")
    return {
        "QueueFullError": QueueFullError,
        "ServerClosedError": ServerClosedError,
        "TimeoutError": TimeoutError,
        "ValueError": ValueError,
    }.get(kind, ServingError)(msg)


class ProcessReplica:
    """Subprocess replica: a `fleet.worker` process serving the PS-tier
    frame protocol on loopback. The parent keeps a small socket pool
    (concurrent in-flight requests ride separate connections — the
    worker is thread-per-connection, so its InferenceServer still
    batches across them) and a thread pool that turns RPCs into
    Futures."""

    kind = "process"

    def __init__(self, name: str, model: ModelVersion,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 warm: bool = True, python: Optional[str] = None,
                 env: Optional[dict] = None, max_inflight: int = 8,
                 extra_args: Sequence[str] = (),
                 server_kwargs: Optional[dict] = None,
                 device: Optional[str] = None):
        self.name = name
        self._model = model
        self._buckets = tuple(buckets)
        self._rpc_timeout = float(
            os.environ.get("PDTPU_FLEET_RPC_TIMEOUT", "120"))
        self._swap_timeout = float(
            os.environ.get("PDTPU_FLEET_SWAP_TIMEOUT", "600"))
        self._olock = threading.Lock()
        self._outstanding = 0
        self._idle: "queue.SimpleQueue[socket.socket]" = queue.SimpleQueue()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(max_inflight)),
            thread_name_prefix=f"fleet-{name}")
        self._port: Optional[int] = None
        self._ready = threading.Event()
        self._spawn_error: Optional[str] = None

        cmd = [python or sys.executable, "-m",
               "paddle_tpu_torch.serving.fleet.worker",
               "--model-dir", model.model_dir,
               "--buckets", ",".join(str(b) for b in self._buckets)]
        if device is not None:
            cmd += ["--device", str(device)]
        if model.precision:
            cmd += ["--precision", model.precision]
        if not warm:
            cmd += ["--no-warm"]
        for k, v in (server_kwargs or {}).items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        cmd += list(extra_args)
        env = dict(os.environ if env is None else env)
        # make `python -m paddle_tpu_torch...` work from any cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env)
        threading.Thread(target=self._read_stdout, daemon=True,
                         name=f"fleet-{name}-stdout").start()

    def _read_stdout(self) -> None:
        for line in self._proc.stdout:
            line = line.decode("utf-8", "replace").strip()
            if line.startswith("PDTPU_FLEET_WORKER_READY"):
                try:
                    self._port = int(line.rsplit("=", 1)[1])
                except ValueError:
                    self._spawn_error = f"bad ready line: {line!r}"
                self._ready.set()
            # keep draining so the worker never blocks on a full pipe
        self._ready.set()  # EOF: the worker exited

    def wait_ready(self, timeout: float = 300.0) -> "ProcessReplica":
        if not self._ready.wait(timeout):
            raise TransportError(
                f"replica {self.name}: worker not ready after {timeout}s",
                transient=False)
        if self._port is None:
            rc = self._proc.poll()
            raise TransportError(
                f"replica {self.name}: worker exited before ready "
                f"(rc={rc}, {self._spawn_error or 'no port line'})",
                transient=False)
        return self

    # -- RPC plumbing -------------------------------------------------------
    def _conn(self) -> socket.socket:
        try:
            return self._idle.get_nowait()
        except queue.Empty:
            pass
        s = socket.create_connection(("127.0.0.1", self._port),
                                     timeout=self._rpc_timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _rpc(self, op: str, timeout: Optional[float] = None, **kw):
        if self._port is None:
            self.wait_ready()
        if self._proc.poll() is not None:
            raise ReplicaDeadError(
                f"replica {self.name}: worker exited "
                f"rc={self._proc.returncode}")
        msg = {"op": op, **kw}
        # propagate the caller's trace into the worker process: fresh
        # client span, trace dict in the frame header (same carrier the
        # PS wire protocol uses)
        span = None
        tracer = get_tracer()
        ctx = _trace_ctx.current()
        if ctx is not None:
            rctx = ctx.child()
            msg["trace"] = rctx.to_wire()
            if tracer.enabled:
                span = f"fleet/rpc/{op}"
                tracer.begin(span, dict(rctx.args(), rpc="client", op=op,
                                        endpoint=f"127.0.0.1:{self._port}",
                                        replica=self.name))
        s = self._conn()
        try:
            s.settimeout(timeout if timeout is not None
                         else self._rpc_timeout)
            _send_msg(s, msg)
            reply = _recv_msg(s)
        except TransportError:
            s.close()
            raise
        except OSError as e:
            s.close()
            raise TransportError(f"{op}: {e}", transient=True,
                                 endpoint=f"127.0.0.1:{self._port}") from e
        finally:
            if span is not None:
                tracer.end(span)
        self._idle.put(s)
        if isinstance(reply, dict) and reply.get("err"):
            raise _map_worker_error(reply)
        return reply

    # -- request path -------------------------------------------------------
    @property
    def outstanding(self) -> int:
        with self._olock:
            return self._outstanding

    def _infer_rpc(self, feed, timeout_ms, ctx=None):
        feed = {k: np.asarray(v) for k, v in feed.items()}
        sock_timeout = (self._rpc_timeout if timeout_ms is None
                        else self._rpc_timeout + timeout_ms / 1e3)
        with _trace_ctx.use(ctx):
            reply = self._rpc("infer", feed=feed, timeout_ms=timeout_ms,
                              timeout=sock_timeout)
        return [np.asarray(o) for o in reply["out"]]

    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None) -> Future:
        if self._proc.poll() is not None:
            raise ReplicaDeadError(
                f"replica {self.name}: worker exited "
                f"rc={self._proc.returncode}")
        with self._olock:
            self._outstanding += 1
        # the RPC runs on a pool thread; carry the submitter's trace over
        fut = self._pool.submit(self._infer_rpc, dict(feed), timeout_ms,
                                _trace_ctx.current())

        def done(_):
            with self._olock:
                self._outstanding -= 1

        fut.add_done_callback(done)
        return fut

    def infer(self, feed, timeout_ms=None):
        return self.submit(feed, timeout_ms=timeout_ms).result()

    # -- observability ------------------------------------------------------
    def metrics(self) -> list:
        """The worker process's full registry as a structured series
        list (serving + executor metrics live there)."""
        return self._rpc("metrics", timeout=10.0)["series"]

    def trace_export(self) -> dict:
        """Chrome-trace events recorded inside the worker process."""
        return self._rpc("trace_export", timeout=30.0)["trace"]

    # -- lifecycle ----------------------------------------------------------
    @property
    def version(self) -> str:
        return self._model.version

    @property
    def model_dir(self) -> str:
        return self._model.model_dir

    @property
    def pid(self) -> int:
        return self._proc.pid

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def health(self) -> dict:
        if not self.alive:
            return {"status": "failing", "state": "dead",
                    "checks": {"process": {
                        "status": "failing",
                        "detail": f"worker exited "
                                  f"rc={self._proc.returncode}"}}}
        try:
            h = self._rpc("health", timeout=5.0)
        except Exception as e:
            return {"status": "failing", "state": "unreachable",
                    "checks": {"rpc": {"status": "failing",
                                       "detail": str(e)[:200]}}}
        h.setdefault("version", self._model.version)
        return h

    def swap(self, model: ModelVersion) -> dict:
        report = self._rpc("swap", model_dir=model.model_dir,
                           version=model.version,
                           precision=model.precision,
                           timeout=self._swap_timeout)
        self._model = model
        return report

    def stop(self) -> dict:
        report = {"pending": 0, "completed": 0, "rejected": 0}
        if self.alive:
            try:
                report = self._rpc("stop", timeout=30.0).get("report", report)
            except Exception:
                pass
        try:
            self._proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._close_io()
        return report

    def kill(self) -> None:
        """SIGKILL the worker — the failover drill. In-flight RPCs fail
        with transient TransportError; the router retries them on a
        different replica."""
        self._proc.kill()
        self._proc.wait()

    def _close_io(self) -> None:
        self._pool.shutdown(wait=False)
        while True:
            try:
                self._idle.get_nowait().close()
            except queue.Empty:
                break
            except OSError:
                pass
