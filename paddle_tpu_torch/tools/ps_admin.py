"""Operator CLI for a running PS shard fleet (the port's copy of
``paddle_tpu.tools.ps_admin``).

The command-line view of what ``ps.ShardMonitor`` watches: point it at
the pserver endpoint list and ask each shard how it's doing. Loads
neither torch nor JAX (it must run on a bastion or a pserver host: the
package's ``__init__`` skips the framework surface when this module is
the ``-m`` entry point), never retries
(an operator wants the truthful instantaneous answer, not the
self-healed one), and always exits 0/1 so it can sit in a cron or a
k8s liveness probe.

CLI::

    python -m paddle_tpu_torch.tools.ps_admin ping
    python -m paddle_tpu_torch.tools.ps_admin stats --endpoints h1:6000,h2:6000
    python -m paddle_tpu_torch.tools.ps_admin meta
    python -m paddle_tpu_torch.tools.ps_admin dump-health --json

Endpoints come from ``--endpoints`` (comma-separated), else
``PADDLE_PSERVER_ENDPOINTS``, else ``PADDLE_PSERVERS_IP_PORT_LIST``
(both reference-style env spellings are honored, same as the fleet role
makers).

Commands:

* ``ping``        — one-shot liveness per shard (fresh connection each);
* ``meta``        — which tables each shard hosts and their row ranges;
* ``stats``       — per-shard pull/push byte counters, plus the worker's
  hot-row-cache block (hit rate, resident/dirty rows, write-back bytes)
  when one is in play, plus a ``vocab`` block when any shard is a
  dynamic-vocab one (live vs provisioned rows, materialized/evicted
  totals and the eviction rate, oldest-row age — the online-learning
  occupancy picture);
* ``dump-health`` — the ShardMonitor view as one JSON document: runs a
  single synchronous sweep and prints ``status`` (ok/degraded/failing),
  per-shard up flags, and the endpoint list — what the in-process
  ``/healthz`` check ``ps/shards`` reports, minus the wedge timer
  (a one-shot CLI has no down-since history). Includes the same
  ``hot_cache`` block as ``stats``, and a dynamic-vocab shard sitting
  within 5% of its row cap escalates ``status`` to ``degraded`` (the
  next sweep will be evicting WARM ids — grow the capacity);
* ``fleet``       — ONE federated scrape of the whole system: every
  pserver endpoint (transport ``metrics`` op) plus every worker/replica
  introspection server given via ``--workers http://h:p,...``
  (``/metrics/series``). Prints a per-process table (role, reachability,
  scrape latency, series count, queue depth / pull p99 where present)
  and the derived ``autoscale/*`` signals; ``--json`` prints the full
  ``/fleet`` document. Exit 1 when ANY scrape failed. ``--watch N``
  re-scrapes and re-renders every N seconds (screen cleared each pass,
  Ctrl-C exits 0).

The hot-row cache lives in the WORKER process, not on the shards, so
its ``ps/cache_*`` series come from the worker's introspection plane:
pass ``--worker http://host:port`` (the ``PDTPU_INTROSPECT_PORT``
server; ``/metrics.json`` is fetched) — or, with no ``--worker``, from
this process's own registry, which is only meaningful for in-process
callers (tests, notebooks driving the tier directly).

Exit code 0 when every shard answered, 1 otherwise (plus 2 for usage
errors, argparse's convention).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

__all__ = ["main"]


def _endpoints(arg: str) -> list:
    eps = (arg or os.environ.get("PADDLE_PSERVER_ENDPOINTS")
           or os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST") or "")
    out = [e.strip() for e in eps.replace(";", ",").split(",") if e.strip()]
    if not out:
        raise SystemExit(
            "ps_admin: no endpoints — pass --endpoints host:port,... or "
            "set PADDLE_PSERVER_ENDPOINTS")
    for e in out:
        if ":" not in e:
            raise SystemExit(f"ps_admin: bad endpoint {e!r} "
                             "(expected host:port)")
    return out


# counter / gauge suffixes of the ps/cache_* series (hot_cache.py)
_CACHE_KEYS = ("hits", "misses", "lookup_hits", "lookup_misses",
               "admitted", "evictions", "bypass", "writeback_bytes",
               "resident_rows", "dirty_rows", "capacity")


def cache_fields(worker: str = "", timeout: float = 2.0):
    """The hot-row-cache block for ``stats``/``dump-health``: the
    ``ps/cache_*`` registry series plus derived ratios, read from a
    worker's ``/metrics.json`` (``worker`` is the introspection base
    URL) or from this process's registry when ``worker`` is empty.
    Returns None when no hot cache has ever registered (capacity 0)."""
    if worker:
        import urllib.request
        url = worker.rstrip("/") + "/metrics.json"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            snap = json.load(resp)
    else:
        from ..observability.registry import get_registry
        snap = get_registry().snapshot(deep=True)
    if not float(snap.get("ps/cache_capacity", 0) or 0):
        return None
    out = {k: snap.get(f"ps/cache_{k}", 0) for k in _CACHE_KEYS}
    total = out["hits"] + out["misses"]
    out["hit_rate"] = (out["hits"] / total) if total else None
    ltotal = out["lookup_hits"] + out["lookup_misses"]
    out["lookup_hit_rate"] = (out["lookup_hits"] / ltotal) if ltotal else None
    out["dirty_fraction"] = (out["dirty_rows"] / out["capacity"]
                             if out["capacity"] else None)
    return out


# a dynamic shard at >= 95% of its slab is one hot batch away from
# evicting warm rows; surface it before quality degrades silently
_VOCAB_CAP_WARN = 0.95


def vocab_fields(payloads):
    """The dynamic-vocab block for ``stats``/``dump-health``, aggregated
    from per-endpoint ``stats`` payloads (``[(endpoint, {table:
    shard.stats()})]``). Returns None when no shard is dynamic;
    otherwise per-table occupancy totals plus ``near_cap`` — the shards
    within ``1 - _VOCAB_CAP_WARN`` of their row cap."""
    tables: dict = {}
    near_cap = []
    for i, (ep, payload) in enumerate(payloads):
        if not isinstance(payload, dict):
            continue
        for tname, st in payload.items():
            if not isinstance(st, dict) or not st.get("dynamic"):
                continue
            t = tables.setdefault(tname, {
                "live_rows": 0, "provisioned_rows": 0, "materialized": 0,
                "evicted": 0, "pinned": 0, "oldest_row_age_s": 0.0})
            live = int(st.get("live_rows", 0))
            cap = int(st.get("capacity", 0))
            t["live_rows"] += live
            t["provisioned_rows"] += cap
            t["materialized"] += int(st.get("materialized", 0))
            t["evicted"] += int(st.get("evicted", 0))
            t["pinned"] += int(st.get("pinned", 0))
            t["oldest_row_age_s"] = max(t["oldest_row_age_s"],
                                        float(st.get("oldest_age_s") or 0))
            if cap and live >= _VOCAB_CAP_WARN * cap:
                near_cap.append({"shard": i, "endpoint": ep,
                                 "table": tname, "live_rows": live,
                                 "capacity": cap})
    if not tables:
        return None
    for t in tables.values():
        t["utilization"] = (t["live_rows"] / t["provisioned_rows"]
                            if t["provisioned_rows"] else None)
        t["eviction_rate"] = (t["evicted"] / t["materialized"]
                              if t["materialized"] else None)
    return {"tables": tables, "near_cap": near_cap}


def _series_get(series, name, field="value"):
    """First series named `name`: its value (counter/gauge) or the
    given summary field; None when the process has no such series."""
    for s in series:
        if s.get("name") != name:
            continue
        if s.get("type") == "summary":
            return (s.get("summary") or {}).get(field)
        return s.get("value")
    return None


def fleet_scrape(endpoints, workers, timeout: float = 2.0) -> dict:
    """One federated sweep over pserver endpoints + worker introspection
    URLs; returns the ``/fleet`` document (see observability.federate)."""
    from ..observability.federate import FederatedScraper, ScrapeTarget

    targets = [ScrapeTarget.ps(ep, shard=i) for i, ep in
               enumerate(endpoints)]
    targets += [ScrapeTarget.http(url) for url in workers]
    return FederatedScraper(targets, timeout=timeout).scrape_once()


def format_fleet(doc: dict) -> str:
    """The per-process table + signal block for ``fleet``."""
    lines = [f"{'process':<28}{'role':<10}{'shard':>6}{'state':>8}"
             f"{'scrape_ms':>11}{'series':>8}{'queue':>7}"
             f"{'pull_p99_ms':>12}"]
    for r in doc["targets"]:
        q = _series_get(r["series"], "serving/queue_depth")
        p99 = _series_get(r["series"], "ps/shard_pull_ms", field="p99")
        lines.append(
            f"{r['process']:<28}{r['role']:<10}"
            f"{'-' if r['shard'] is None else r['shard']:>6}"
            f"{'up' if r['ok'] else 'DOWN':>8}"
            f"{r['scrape_ms']:>11.1f}{len(r['series']):>8}"
            f"{'-' if q is None else int(q):>7}"
            f"{'-' if p99 is None else round(p99, 2):>12}")
        if not r["ok"]:
            lines.append(f"    error: {r['error']}")
    sig = doc.get("signals") or {}
    lines.append("")
    lines.append("autoscaler signals: " + json.dumps(sig, sort_keys=True))
    return "\n".join(lines)


def _ask(endpoint: str, op: str, timeout: float):
    """(ok, payload-or-error) for one shard, single attempt."""
    from ..ps.transport import SocketClient

    c = SocketClient(endpoint, timeout=timeout, retries=0)
    try:
        if op == "ping":
            return True, c.ping()
        return True, getattr(c, op)()
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"
    finally:
        c.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ps_admin",
        description="inspect a running PS shard fleet")
    ap.add_argument("cmd", choices=["ping", "stats", "meta", "dump-health",
                                    "fleet"])
    ap.add_argument("--endpoints", default="",
                    help="comma-separated host:port list (default: "
                         "PADDLE_PSERVER_ENDPOINTS)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-shard socket timeout, seconds (default 2)")
    ap.add_argument("--worker", default="",
                    help="worker introspection base URL (http://host:port)"
                         " for the hot-row-cache fields; default: this "
                         "process's registry")
    ap.add_argument("--workers", default="",
                    help="fleet: comma-separated worker/replica "
                         "introspection base URLs to scrape alongside "
                         "the pserver endpoints")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (dump-health always is)")
    ap.add_argument("--watch", type=float, default=None, metavar="N",
                    help="fleet: re-scrape and re-render every N seconds "
                         "(clear screen each pass; Ctrl-C exits cleanly)")
    args = ap.parse_args(argv)

    if args.cmd == "fleet":
        workers = [w.strip() for w in args.workers.split(",") if w.strip()]
        try:
            eps = _endpoints(args.endpoints)
        except SystemExit:
            if not workers:  # a fleet needs SOMETHING to scrape
                raise
            eps = []

        def render_once() -> dict:
            doc = fleet_scrape(eps, workers, timeout=args.timeout)
            if args.json:
                print(json.dumps(doc, sort_keys=True, default=str))
            else:
                print(format_fleet(doc))
            return doc

        if args.watch is not None:
            if args.watch <= 0:
                raise SystemExit("ps_admin: --watch must be > 0")
            try:
                while True:
                    # ANSI clear + home — a poor man's watch(1)
                    sys.stdout.write("\x1b[2J\x1b[H")
                    render_once()
                    sys.stdout.flush()
                    time.sleep(args.watch)
            except KeyboardInterrupt:
                return 0
        doc = render_once()
        return 0 if doc["ok"] else 1

    eps = _endpoints(args.endpoints)

    def _cache():
        try:
            return cache_fields(args.worker, args.timeout)
        except Exception as e:  # unreachable worker != unhealthy shards
            return {"error": f"{type(e).__name__}: {e}"}

    if args.cmd == "dump-health":
        from ..ps.health import ShardMonitor
        mon = ShardMonitor.for_endpoints(eps)
        mon.poll_now()
        doc = mon.status()
        doc["hot_cache"] = _cache()
        payloads = []
        for ep in eps:
            ok, payload = _ask(ep, "stats", args.timeout)
            payloads.append((ep, payload if ok else None))
        doc["vocab"] = vocab_fields(payloads)
        near = (doc["vocab"] or {}).get("near_cap") or []
        if near:
            flagged = {n["shard"] for n in near}
            for s in doc["shards"]:
                s["near_cap"] = s["shard"] in flagged
            if doc["status"] == "ok":
                # up but one hot batch from evicting warm ids: degraded,
                # not failing — the fleet serves, capacity needs growing
                doc["status"] = "degraded"
                doc["detail"] = (
                    f"{len(near)} dynamic shard(s) within "
                    f"{round((1 - _VOCAB_CAP_WARN) * 100)}% of row cap: "
                    + ", ".join(f"{n['endpoint']}/{n['table']} "
                                f"{n['live_rows']}/{n['capacity']}"
                                for n in near))
        print(json.dumps(doc, indent=None if args.json else 2,
                         sort_keys=True))
        return 0 if all(s["up"] for s in doc["shards"]) else 1

    op = {"ping": "ping", "stats": "stats", "meta": "meta"}[args.cmd]
    rows = []
    all_up = True
    for i, ep in enumerate(eps):
        ok, payload = _ask(ep, op, args.timeout)
        all_up &= ok
        rows.append({"shard": i, "endpoint": ep, "up": ok,
                     ("error" if not ok else op): payload})
    cache = _cache() if op == "stats" else None
    vocab = None
    if op == "stats":
        vocab = vocab_fields([(r["endpoint"], r.get("stats"))
                              for r in rows if r["up"]])
    if args.json:
        if op == "stats":
            print(json.dumps({"shards": rows, "hot_cache": cache,
                              "vocab": vocab}, sort_keys=True))
        else:
            print(json.dumps(rows, sort_keys=True))
    else:
        for r in rows:
            state = "up" if r["up"] else f"DOWN ({r['error']})"
            line = f"shard {r['shard']} {r['endpoint']}: {state}"
            if r["up"] and op != "ping":
                line += " " + json.dumps(r[op], sort_keys=True)
            print(line)
        if cache is not None:
            print("hot cache: " + json.dumps(cache, sort_keys=True))
        if vocab is not None:
            print("vocab: " + json.dumps(vocab, sort_keys=True))
    return 0 if all_up else 1


if __name__ == "__main__":
    sys.exit(main())
