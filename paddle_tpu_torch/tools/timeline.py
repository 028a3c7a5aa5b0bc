"""Trace toolbox: profiler-session traces + chrome-trace merge + span summary.

Counterpart of ``paddle_tpu.tools.timeline`` (reference
``tools/timeline.py``: profiler.proto → chrome trace JSON, with a
--profile_path that accepted multiple "name=file" inputs, plus the
profiler's sorted per-op summary). The port produces TWO kinds of traces,
both chrome-trace JSON already:

- a ``torch.profiler`` session's trace (``paddle_tpu_torch.profiler``,
  ``<logdir>/*.pt.trace.json[.gz]``): host ops and the card's kernels;
- the host span tracer's export
  (``observability.get_tracer().export_chrome_trace(path)``).

So where the JAX package converts XPlane protos, this tool finds and
loads a session's newest trace (`find_session_traces`,
`load_session_trace`); it merges and summarizes any of them into one file
loadable in chrome://tracing or https://ui.perfetto.dev:

    # a profiler session's log dir, as one trace file
    python -m paddle_tpu_torch.tools.timeline --logdir ./_trace --out trace.json

    # merge host + device traces into one timeline
    python -m paddle_tpu_torch.tools.timeline host.json device.json --out all.json

    # per-span totals (count / total / avg / max ms), sorted like the
    # reference profiler summary
    python -m paddle_tpu_torch.tools.timeline host.json --summary

    # one fleet, many processes: align per-process clocks from RPC span
    # pairs and draw client->server flow arrows (see merge_fleet_traces)
    python -m paddle_tpu_torch.tools.timeline --fleet \\
        coordinator.json worker0.json pserver0.json --out fleet.json
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
from typing import Dict, List, Optional

__all__ = ["find_session_traces", "load_session_trace", "load_trace",
           "merge_traces", "merge_fleet_traces", "summarize",
           "format_summary", "format_flight", "main"]


def find_session_traces(logdir: str) -> List[str]:
    """A profiler log dir's trace files, oldest first
    (``*.pt.trace.json[.gz]`` and other ``*.trace.json[.gz]``)."""
    from .roofline import find_traces

    files = find_traces(logdir)
    if not files:
        raise FileNotFoundError(
            f"no profiler traces under {logdir!r} (expected "
            f"*.pt.trace.json from paddle_tpu_torch.profiler)")
    return files


def load_session_trace(logdir: str) -> dict:
    """The newest trace of a profiler log dir, as a chrome-trace dict."""
    path = find_session_traces(logdir)[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return {"traceEvents": data} if isinstance(data, list) else data


# -- chrome-trace plumbing ---------------------------------------------------

def load_trace(path: str) -> dict:
    """Read one chrome-trace JSON file; accepts both the object form
    ({"traceEvents": [...]}) and the bare event-array form."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return {"traceEvents": data}
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(f"{path!r}: not a chrome-trace file "
                         f"(no traceEvents)")
    return data


def merge_traces(traces: List[dict],
                 names: Optional[List[str]] = None) -> dict:
    """One trace from many: pids are remapped so same-numbered processes
    from different files (e.g. a host trace and a converted device trace
    both recorded under one OS pid) land on separate tracks, each tagged
    with a process_name metadata row naming its source."""
    out: List[dict] = []
    next_pid = [0]
    for i, trace in enumerate(traces):
        src = names[i] if names and i < len(names) else f"trace{i}"
        pid_map: Dict[object, int] = {}

        def mapped(old):
            if old not in pid_map:
                pid_map[old] = next_pid[0]
                next_pid[0] += 1
            return pid_map[old]

        renamed = set()
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            pid = mapped(ev.get("pid", 0))
            ev["pid"] = pid
            if (ev.get("ph") == "M" and ev.get("name") == "process_name"
                    and pid not in renamed):
                renamed.add(pid)
                old_name = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": f"{src}: {old_name}".rstrip(": ")}
            out.append(ev)
        for old, pid in pid_map.items():
            if pid not in renamed:
                out.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": f"{src} (pid {old})"}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# -- fleet merge -------------------------------------------------------------

def _spans(trace: dict, index: int) -> List[dict]:
    """Pair B/E events per (pid, tid) into spans: {name, ts, dur, args,
    pid, tid, trace: index}. Stray E events are dropped; an unclosed B
    becomes a zero-duration span (a process that died mid-span still
    shows where it was)."""
    stacks: Dict[tuple, list] = {}
    spans: List[dict] = []
    events = [ev for ev in trace.get("traceEvents", [])
              if ev.get("ph") in ("B", "E")]
    events.sort(key=lambda ev: ev.get("ts", 0))
    for ev in events:
        key = (ev.get("pid"), ev.get("tid"))
        stack = stacks.setdefault(key, [])
        if ev.get("ph") == "B":
            stack.append(ev)
        elif stack:
            b = stack.pop()
            spans.append({"name": b.get("name", "?"),
                          "ts": float(b.get("ts", 0)),
                          "dur": float(ev.get("ts", 0)) - float(
                              b.get("ts", 0)),
                          "args": b.get("args") or {},
                          "pid": b.get("pid"), "tid": b.get("tid"),
                          "trace": index})
    for stack in stacks.values():
        for b in stack:
            spans.append({"name": b.get("name", "?"),
                          "ts": float(b.get("ts", 0)), "dur": 0.0,
                          "args": b.get("args") or {},
                          "pid": b.get("pid"), "tid": b.get("tid"),
                          "trace": index})
    return spans


def _rpc_pairs(all_spans: List[dict]) -> List[tuple]:
    """(client_span, server_span) pairs: a server-side RPC span
    (args.rpc == "server") whose parent_id is a client RPC span's
    span_id in the same distributed trace_id."""
    clients: Dict[tuple, dict] = {}
    for s in all_spans:
        a = s["args"]
        if a.get("rpc") == "client" and a.get("span_id"):
            clients[(a.get("trace_id"), a["span_id"])] = s
    pairs = []
    for s in all_spans:
        a = s["args"]
        if a.get("rpc") != "server" or not a.get("parent_id"):
            continue
        c = clients.get((a.get("trace_id"), a["parent_id"]))
        if c is not None and c["trace"] != s["trace"]:
            pairs.append((c, s))
    return pairs


def _clock_offsets(n_traces: int, pairs: List[tuple]) -> List[float]:
    """Per-trace clock offset (µs) from RPC send/recv pairs, NTP-style:
    a server span is causally inside its client span, so for each pair
    theta = ((s0 - c0) + (s1 - c1)) / 2 estimates the server clock's
    lead over the client clock (symmetric-delay assumption). Offsets are
    averaged per trace-pair edge and chained by BFS from the reference
    trace (index 0); unreachable traces keep offset 0."""
    edges: Dict[tuple, list] = {}
    for c, s in pairs:
        c0, c1 = c["ts"], c["ts"] + c["dur"]
        s0, s1 = s["ts"], s["ts"] + s["dur"]
        theta = ((s0 - c0) + (s1 - c1)) / 2.0
        edges.setdefault((c["trace"], s["trace"]), []).append(theta)
    adj: Dict[int, list] = {}
    for (i, j), thetas in edges.items():
        mean = sum(thetas) / len(thetas)
        adj.setdefault(i, []).append((j, mean))
        adj.setdefault(j, []).append((i, -mean))
    offsets = [0.0] * n_traces
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for i in frontier:
            for j, theta in adj.get(i, []):
                if j in seen:
                    continue
                seen.add(j)
                offsets[j] = offsets[i] + theta
                nxt.append(j)
        frontier = nxt
    return offsets


def merge_fleet_traces(traces: List[dict],
                       names: Optional[List[str]] = None) -> dict:
    """Merge per-process chrome traces from one fleet into a single
    aligned timeline.

    Each process's tracer timestamps are relative to its own
    ``perf_counter`` start, so raw merging scatters one request's spans
    across the whole time axis. This merge (1) estimates each trace's
    clock offset against the first trace from matched client/server RPC
    span pairs (same trace_id, server parent_id == client span_id) and
    shifts its events onto the common clock, (2) remaps pids so every
    process gets its own track (named by its tracer ``process_name``),
    and (3) draws chrome-trace flow arrows (s/f events, cat "rpc") from
    each client RPC span to the server span it caused — in the viewer a
    routed request reads as one connected path through router, replica,
    and pserver tracks."""
    all_spans: List[dict] = []
    for i, t in enumerate(traces):
        all_spans.extend(_spans(t, i))
    pairs = _rpc_pairs(all_spans)
    offsets = _clock_offsets(len(traces), pairs)

    out: List[dict] = []
    next_pid = [0]
    pid_maps: List[Dict[object, int]] = []
    for i, trace in enumerate(traces):
        src = names[i] if names and i < len(names) else f"proc{i}"
        pid_map: Dict[object, int] = {}
        pid_maps.append(pid_map)

        def mapped(old):
            if old not in pid_map:
                pid_map[old] = next_pid[0]
                next_pid[0] += 1
            return pid_map[old]

        renamed = set()
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            pid = mapped(ev.get("pid", 0))
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) - offsets[i]
            if (ev.get("ph") == "M" and ev.get("name") == "process_name"
                    and pid not in renamed):
                renamed.add(pid)
                old_name = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": f"{src}: {old_name}".rstrip(": ")}
            out.append(ev)
        for old, pid in pid_map.items():
            if pid not in renamed:
                out.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": f"{src} (pid "
                                                       f"{old})"}})
    # flow arrows client -> server, one per RPC pair; the id is the
    # client RPC span_id (unique per attempt, so retries get their own
    # arrows). ts is nudged inside the span so the viewer binds the
    # arrow to the enclosing slice.
    for c, s in pairs:
        fid = str(c["args"]["span_id"])
        out.append({"name": "rpc", "cat": "rpc", "ph": "s", "id": fid,
                    "pid": pid_maps[c["trace"]].get(c["pid"], 0),
                    "tid": c["tid"],
                    "ts": c["ts"] - offsets[c["trace"]] + 0.01})
        out.append({"name": "rpc", "cat": "rpc", "ph": "f", "bp": "e",
                    "id": fid,
                    "pid": pid_maps[s["trace"]].get(s["pid"], 0),
                    "tid": s["tid"],
                    "ts": s["ts"] - offsets[s["trace"]] + 0.01})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def summarize(trace: dict) -> Dict[str, dict]:
    """Per-span-name totals: {"name": {count, total_ms, avg_ms, max_ms}}.

    Handles both duration forms: B/E pairs (matched per pid/tid with a
    stack, so nesting is honored and stray E events are ignored) and
    complete "X" events carrying an explicit dur."""
    stats: Dict[str, dict] = {}

    def add(name, dur_us):
        s = stats.setdefault(name, {"count": 0, "total_ms": 0.0,
                                    "avg_ms": 0.0, "max_ms": 0.0})
        ms = dur_us / 1e3
        s["count"] += 1
        s["total_ms"] += ms
        s["max_ms"] = max(s["max_ms"], ms)

    stacks: Dict[tuple, list] = {}
    events = [ev for ev in trace.get("traceEvents", [])
              if ev.get("ph") in ("B", "E", "X")]
    events.sort(key=lambda ev: ev.get("ts", 0))
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            add(ev.get("name", "?"), float(ev.get("dur", 0)))
            continue
        key = (ev.get("pid"), ev.get("tid"))
        stack = stacks.setdefault(key, [])
        if ph == "B":
            stack.append((ev.get("name", "?"), float(ev.get("ts", 0))))
        elif stack:  # E closes the innermost open B on this thread
            name, ts0 = stack.pop()
            add(name, float(ev.get("ts", 0)) - ts0)
    for s in stats.values():
        s["avg_ms"] = s["total_ms"] / max(s["count"], 1)
    return stats


def format_summary(stats: Dict[str, dict]) -> str:
    """Sorted text table, total-time-descending — the analog of the
    reference profiler's sorted per-op summary."""
    lines = [f"{'span':<40}{'calls':>8}{'total_ms':>12}"
             f"{'avg_ms':>10}{'max_ms':>10}"]
    for name in sorted(stats, key=lambda n: -stats[n]["total_ms"]):
        s = stats[name]
        lines.append(f"{name:<40}{s['count']:>8}{s['total_ms']:>12.3f}"
                     f"{s['avg_ms']:>10.4f}{s['max_ms']:>10.3f}")
    return "\n".join(lines)


def format_flight(dump: dict) -> str:
    """Render a flight-recorder post-mortem (observability.flight) as a
    step-time table with anomaly annotations, headed by the exception
    and device-memory state — the operator's first read after an OOM."""
    exc = dump.get("exception") or {}
    ctx = dump.get("context") or {}
    lines = [
        f"flight dump: {exc.get('type', '?')} during "
        f"{ctx.get('where', '?')} (pid {dump.get('pid', '?')})",
        f"  message: {exc.get('message', '')[:200]}",
    ]
    for dev, stats in (dump.get("device_memory") or {}).items():
        in_use = stats.get("bytes_in_use")
        peak = stats.get("peak_bytes_in_use")
        limit = stats.get("bytes_limit")
        lines.append(
            f"  {dev}: in_use="
            f"{in_use / 1e9:.2f}GB" if in_use is not None else f"  {dev}:")
        if peak is not None or limit is not None:
            lines[-1] += (f" peak={peak / 1e9:.2f}GB" if peak else "") + \
                         (f" limit={limit / 1e9:.2f}GB" if limit else "")
    steps = dump.get("steps") or []
    lines.append("")
    lines.append(f"{'step':>6}{'wall_ms':>10}{'compile':>9}{'sig':>10}"
                 f"{'queue':>7}{'h2d_ms':>8}{'mem_GB':>8}  anomaly")
    for r in steps:
        mem = r.get("mem_bytes_in_use")
        note = r.get("anomaly", "")
        if note and r.get("deviation") is not None:
            note += f" ({r['deviation']}x sigma)"
        lines.append(
            f"{r.get('step', '?'):>6}{r.get('wall_ms', 0):>10.2f}"
            f"{'yes' if r.get('compile') else '-':>9}"
            f"{r.get('sig', '-'):>10}"
            f"{str(r.get('queue_depth', '-')):>7}"
            f"{str(r.get('h2d_ms', '-')):>8}"
            f"{f'{mem / 1e9:.2f}' if mem is not None else '-':>8}"
            f"  {note}")
    events = dump.get("events") or []
    if events:
        lines.append("")
        lines.append("events:")
        for ev in events:
            lines.append(f"  [{ev.get('level', '?')}] "
                         f"{ev.get('message', '')[:160]}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="*",
                    help="chrome-trace JSON files to merge/summarize "
                         "(host tracer exports, prior conversions)")
    ap.add_argument("--logdir",
                    help="profiler log dir (the profile_path of "
                         "paddle_tpu_torch.profiler.profiler()); its "
                         "newest trace is merged in")
    ap.add_argument("--out",
                    help="output chrome-trace JSON path "
                         "(default timeline.json unless --summary only)")
    ap.add_argument("--summary", action="store_true",
                    help="print per-span totals sorted by total time")
    ap.add_argument("--fleet", action="store_true",
                    help="treat the inputs as per-process traces of ONE "
                         "fleet: align clocks via RPC span pairs, give "
                         "each process its own named track, draw flow "
                         "arrows from client to server RPC spans")
    ap.add_argument("--flight",
                    help="render a flight-recorder dump JSON "
                         "(observability.flight / PDTPU_FLIGHT_DIR) as a "
                         "step-time table with anomaly annotations")
    args = ap.parse_args(argv)
    if not args.traces and not args.logdir and not args.flight:
        ap.error("give chrome-trace files, --logdir, and/or --flight")

    if args.flight:
        with open(args.flight) as f:
            print(format_flight(json.load(f)))
        if not args.traces and not args.logdir:
            return

    traces, names = [], []
    for path in args.traces:
        traces.append(load_trace(path))
        names.append(os.path.basename(path))
    if args.logdir:
        traces.append(load_session_trace(args.logdir))
        names.append(os.path.basename(args.logdir.rstrip("/")) or "session")

    if args.fleet:
        merged = merge_fleet_traces(traces, names)
    else:
        merged = (traces[0] if len(traces) == 1
                  else merge_traces(traces, names))
    out_path = args.out
    if out_path is None and not args.summary:
        out_path = "timeline.json"
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
        print(f"wrote {out_path} "
              f"({len(merged.get('traceEvents', []))} events) — "
              f"load in chrome://tracing or ui.perfetto.dev")
    if args.summary:
        print(format_summary(summarize(merged)))


if __name__ == "__main__":
    main()
