"""Fleet worker: one replica process = one InferenceServer + RPC loop.

``python -m paddle_tpu_torch.serving.fleet.worker --model-dir DIR`` builds
the predictor on ``--device`` (default: CUDA device 0), runs every
(signature × bucket) once, starts the InferenceServer, then serves the PS
tier's length-prefixed JSON+blob frame protocol (``ps.transport``'s codec,
pickle-free by construction) on a loopback port. It prints
``PDTPU_FLEET_WORKER_READY port=<p>`` on stdout once — and only once —
traffic is safe, so the parent (`ProcessReplica`) never routes to a cold
replica.

Ops: ``infer`` (feed arrays → output arrays; user errors travel back as
``{"err", "kind"}`` and are re-raised client-side), ``health`` (the
server's /healthz view + state), ``swap`` (warm the new version in this
process, atomic flip, drain the old server — the in-process half of
zero-downtime rollout), ``ping``, ``metrics`` (this process's registry
as a structured series list — the federation scrape surface),
``trace_export`` (this process's chrome-trace events), ``stop`` (drain,
reply with the drain report, exit).

Every frame may carry a ``trace`` header dict; the handler opens a
server-side span parented to the sender's span, so one routed request
is one trace across router → worker → pserver.

PS-backed serving: ``--ps-endpoints host:p,host:p --ps-table
PARAM=TABLE:VOCAB[:LANES] --ps-id-feeds ids`` wraps the predictor in a
`PsLookupPredictor` whose embedding rows live on pserver shards, reached
through the PS socket transport — the subprocess equivalent of handing
`PsLookupBinding`s to a ThreadReplica factory (``--ps-cache-rows`` sizes
the device-resident hot-row cache). The predictor serves on ``--device``
like any other.

Thread-per-connection: concurrent parent connections land in the same
InferenceServer queue, so dynamic batching still merges them.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading

import numpy as np


def _handle_op(op, msg, replica, stop_evt, conn):
    """Dispatch one op; returns the reply dict, or None when the op
    already sent its reply (stop)."""
    from ...observability.registry import get_registry
    from ...observability.tracer import get_tracer
    from ...ps.transport import _send_msg
    if op == "ping":
        return {"ok": True, "pid": os.getpid()}
    if op == "infer":
        feed = {k: np.asarray(v)
                for k, v in (msg.get("feed") or {}).items()}
        outs = replica.infer(feed, timeout_ms=msg.get("timeout_ms"))
        return {"out": [np.asarray(o) for o in outs]}
    if op == "health":
        return replica.health()
    if op == "metrics":
        return {"series": get_registry().series(deep=True)}
    if op == "trace_export":
        return {"trace": get_tracer().export_chrome_trace()}
    if op == "swap":
        from .registry import ModelVersion
        mv = ModelVersion(msg["version"], msg["model_dir"],
                          msg.get("precision"), {})
        return replica.swap(mv)
    if op == "stop":
        report = replica.stop()
        _send_msg(conn, {"ok": True, "report": report})
        stop_evt.set()
        return None
    return {"err": f"unknown op {op!r}", "kind": "ValueError"}


def _serve_conn(conn, replica, stop_evt):
    from ...observability.tracer import server_span
    from ...ps.transport import TransportError, _recv_msg, _send_msg
    try:
        while not stop_evt.is_set():
            try:
                msg = _recv_msg(conn)
            except TransportError:
                return  # peer went away / torn frame: drop the connection
            op = msg.get("op") if isinstance(msg, dict) else None
            wire = msg.get("trace") if isinstance(msg, dict) else None
            try:
                # server half of the RPC span pair: adopts the parent's
                # trace_id so a routed request is one trace end to end
                with server_span(f"serve/{op}", wire, rpc="server",
                                 op=str(op)):
                    reply = _handle_op(op, msg, replica, stop_evt, conn)
                if reply is None:
                    return  # stop already replied
            except Exception as e:
                reply = {"err": str(e)[:500], "kind": type(e).__name__}
            _send_msg(conn, reply)
    except OSError:
        pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _ps_predictor_factory(args):
    """Build a `predictor_factory` closing over the --ps-* flags: base
    predictor (on ``--device``) wrapped in a PsLookupPredictor over socket
    shard clients. Table spec grammar: ``PARAM=TABLE:VOCAB[:LANES]``
    (repeatable)."""
    from ...inference import create_predictor
    from ...inference.ps_lookup import PsLookupBinding, PsLookupPredictor
    from ...ps.shard import RangeSpec
    from ...ps.table import ShardedTable
    from ...ps.transport import SocketClient
    from .replica import serving_config

    endpoints = [e.strip() for e in args.ps_endpoints.split(",")
                 if e.strip()]
    if not endpoints:
        raise SystemExit("--ps-endpoints: no endpoints given")
    specs = []
    for spec in args.ps_table:
        try:
            param, rest = spec.split("=", 1)
            parts = rest.split(":")
            table, vocab = parts[0], int(parts[1])
            lanes = int(parts[2]) if len(parts) > 2 else 128
        except (ValueError, IndexError):
            raise SystemExit(
                f"--ps-table {spec!r}: want PARAM=TABLE:VOCAB[:LANES]")
        specs.append((param, table, vocab, lanes))
    id_feeds = [f.strip() for f in (args.ps_id_feeds or "ids").split(",")
                if f.strip()]

    def factory(model):
        base = create_predictor(serving_config(model.model_dir, args.device),
                                precision=model.precision)
        bindings = []
        for param, table, vocab, lanes in specs:
            # each table gets its own client set: one connection per
            # shard per table keeps the fan-outs independent
            clients = [SocketClient(ep) for ep in endpoints]
            st = ShardedTable(table, RangeSpec.even(vocab, len(endpoints)),
                              clients, lanes=lanes)
            bindings.append(PsLookupBinding(param, st, id_feeds))
        return PsLookupPredictor(base, bindings,
                                 cache_rows_per_table=args.ps_cache_rows)

    return factory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--version", default="v0")
    ap.add_argument("--precision", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default: CUDA device 0), cuda:N or cpu")
    ap.add_argument("--buckets", default="1,2,4,8,16,32")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-queue-size", type=int, default=256)
    ap.add_argument("--max-batch-delay-ms", type=float, default=2.0)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--ps-endpoints", default=None,
                    help="host:port,host:port — pserver shards backing "
                         "the model's embedding tables")
    ap.add_argument("--ps-table", action="append", default=[],
                    help="PARAM=TABLE:VOCAB[:LANES] (repeatable)")
    ap.add_argument("--ps-id-feeds", default=None,
                    help="comma-separated id feed names (default: ids)")
    ap.add_argument("--ps-cache-rows", type=int, default=None,
                    help="device-resident hot-row cache size per table")
    args = ap.parse_args(argv)

    from ...observability.tracer import get_tracer
    from ..metrics import Metrics
    from .registry import ModelVersion
    from .replica import ThreadReplica

    # this process IS the replica: its serving metrics belong in the
    # process registry (the `metrics` op scrapes it), and its trace
    # events need a role-identifying process name for the fleet merge
    get_tracer().process_name = f"fleet-worker:{os.getpid()}"
    factory = _ps_predictor_factory(args) if args.ps_endpoints else None

    model = ModelVersion(args.version, args.model_dir, args.precision, {})
    replica = ThreadReplica(
        f"worker-{os.getpid()}", model,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        warm=not args.no_warm,
        predictor_factory=factory, device=args.device,
        server_kwargs={"max_queue_size": args.max_queue_size,
                       "max_batch_delay_ms": args.max_batch_delay_ms,
                       "num_workers": args.num_workers,
                       "metrics": Metrics()})

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((args.host, args.port))
    lsock.listen(64)
    lsock.settimeout(0.25)
    stop_evt = threading.Event()

    def on_term(signum, frame):
        stop_evt.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    # the readiness line the parent blocks on: every bucket has run, the
    # server is started, the port is bound
    print(f"PDTPU_FLEET_WORKER_READY port={lsock.getsockname()[1]}",
          flush=True)

    conns = []
    try:
        while not stop_evt.is_set():
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=_serve_conn,
                                 args=(conn, replica, stop_evt), daemon=True)
            t.start()
            conns.append(t)
    finally:
        lsock.close()
        if replica.alive:
            replica.stop()  # SIGTERM path: drain before exiting
    return 0


if __name__ == "__main__":
    sys.exit(main())
