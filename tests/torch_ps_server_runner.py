"""Standalone socket pserver process of the port (``paddle_tpu_torch``),
for the PS chaos tests and the card's smoke run.

Hosts EmbeddingShard slices behind a ShardServer and serves until
killed (the tests SIGKILL it to model a preempted pserver) or until a
client sends the ``shutdown`` op. Shards start ZERO-initialized: the
parent seeds them over the wire with ``load`` — which is also exactly
what a freshly restarted (and therefore empty) shard looks like to the
recovery machinery.

Run::

    python tests/torch_ps_server_runner.py --table tb:0:25 [--port 0]
        [--host 127.0.0.1] [--delay-ms 5] [--trace]

Prints the bound endpoint as the first stdout line (port 0 picks an
ephemeral port), then serves. ``PDTPU_FAULT_SPEC`` in the environment
arms server-side ``ps.rpc`` injections (drop/reset/delay_ms/crash).
``--trace`` turns the port's host tracer on (it starts off), so the
``trace_export`` op returns the server's spans.

Never imports torch or JAX: the module chain is loaded under a stub
``paddle_tpu_torch`` parent so ``paddle_tpu_torch/__init__`` (which
imports torch and the whole fluid surface) never runs. The assert before
serving enforces the pserver contract: shard hosts are numpy + stdlib
only.
"""
import argparse
import os
import sys
import types

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_ps_modules():
    """Import paddle_tpu_torch.ps.{shard,transport} without
    paddle_tpu_torch's package __init__ (which imports torch)."""
    if "paddle_tpu_torch" not in sys.modules:
        stub = types.ModuleType("paddle_tpu_torch")
        stub.__path__ = [os.path.join(_ROOT, "paddle_tpu_torch")]
        sys.modules["paddle_tpu_torch"] = stub
    import paddle_tpu_torch.ps.shard as shard_mod
    import paddle_tpu_torch.ps.transport as transport_mod
    return shard_mod, transport_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_ps_server_runner")
    ap.add_argument("--table", action="append", default=[],
                    help="name:lo:hi[:lanes] — one shard slice to host; "
                         "repeatable")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--delay-ms", type=float, default=0.0,
                    help="simulated per-request RTT on pull/push")
    ap.add_argument("--trace", action="store_true",
                    help="record server spans for the trace_export op")
    args = ap.parse_args(argv)
    if not args.table:
        ap.error("need at least one --table name:lo:hi")
    shard_mod, transport_mod = _load_ps_modules()
    shards = []
    for t in args.table:
        parts = t.split(":")
        if len(parts) not in (3, 4):
            ap.error(f"bad --table {t!r} (expected name:lo:hi[:lanes])")
        name, lo, hi = parts[0], int(parts[1]), int(parts[2])
        lanes = int(parts[3]) if len(parts) == 4 else 128
        shards.append(shard_mod.EmbeddingShard(name, lo, hi, lanes=lanes))
    srv = transport_mod.ShardServer(shards, host=args.host, port=args.port,
                                    delay_ms=args.delay_ms)
    if args.trace:
        transport_mod.get_tracer().enabled = True
    loaded = [m for m in ("torch", "jax") if m in sys.modules]
    assert not loaded, \
        f"pserver contract violated: the shard host imported {loaded}"
    print(srv.endpoint, flush=True)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
