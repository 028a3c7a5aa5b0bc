"""Post-mortem bundler: one self-contained report per incident.

The root-cause loop leaves its evidence in four places — the flight
recorder's dump (what the process looked like when it paged), the
metrics history (the trajectory that led there), the ProfileTrigger's
attribution (which kernels moved vs golden), and the alert manager's
event timeline (what fired, when, in what order). Each is individually
queryable; an incident review wants them stapled together. This tool
does the stapling:

    # in-process (bench chaos cell, a trainer's atexit hook):
    from paddle_tpu_torch.tools import postmortem
    report = postmortem.build_report()
    open("incident.md", "w").write(postmortem.render_markdown(report))

    # against a live process's introspection server:
    python -m paddle_tpu_torch.tools.postmortem --url http://127.0.0.1:8788 \
        --out incident.json --md incident.md

    # offline, from what survived process death:
    python -m paddle_tpu_torch.tools.postmortem --flight-dump flight_*.json \
        --history-dir /var/log/pdtpu_history --md incident.md

The JSON report is self-contained (no references back into the process
that died); the markdown rendering is the human summary — alert
timeline table, culprit-kernel table, history sparkline per signal.

The port's copy of ``paddle_tpu.tools.postmortem``, stdlib only.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import urllib.request
from typing import List, Optional

__all__ = ["build_report", "render_markdown", "load_history_segments",
           "main"]

SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 24) -> str:
    """Unicode sparkline of `values`, downsampled to `width` chars."""
    vals = [float(v) for v in values if isinstance(v, (int, float))]
    if not vals:
        return ""
    if len(vals) > width:
        # stride-sample to width, always keeping the newest point
        step = len(vals) / width
        vals = [vals[min(len(vals) - 1, int(i * step))]
                for i in range(width - 1)] + [vals[-1]]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return SPARK_CHARS[0] * len(vals)
    return "".join(
        SPARK_CHARS[min(len(SPARK_CHARS) - 1,
                        int((v - lo) / span * len(SPARK_CHARS)))]
        for v in vals)


# ----------------------------------------------------------- gathering
def build_report(center_t: Optional[float] = None,
                 half_width_s: float = 120.0,
                 history_prefix: str = "") -> dict:
    """Bundle the in-process evidence. `center_t` defaults to the last
    attribution's anomaly time, else now."""
    from ..observability.alerts import get_alert_manager
    from ..observability.flight import get_flight_recorder
    from ..observability.history import get_history
    from ..observability.profile_trigger import get_trigger

    report: dict = {"generated_t": time.time(), "source": "in-process"}
    trigger = get_trigger()
    att = trigger.last_attribution() if trigger is not None else None
    report["attribution"] = att
    if center_t is None:
        center_t = (att or {}).get("t") or time.time()
    report["center_t"] = center_t
    mgr = get_alert_manager()
    report["alert_timeline"] = (mgr.recent_events(64)
                                if mgr is not None else [])
    report["alerts"] = mgr.doc() if mgr is not None else None
    rec = get_flight_recorder()
    report["flight"] = {"last_dump_path": rec.last_dump_path,
                        "last_dump": rec.last_dump}
    hist = get_history()
    if hist is not None:
        report["history_stats"] = hist.stats()
        report["history_window"] = hist.window(
            center_t, half_width_s=half_width_s, prefix=history_prefix)
    else:
        report["history_stats"] = None
        report["history_window"] = None
    return report


def load_history_segments(history_dir: str,
                          max_lines: int = 10000) -> List[dict]:
    """Parse the newest JSONL spill segments (newest last); malformed
    lines are skipped — a torn final line must not sink the review."""
    segs = sorted(glob.glob(os.path.join(history_dir, "history_*.jsonl")))
    sweeps: List[dict] = []
    for seg in segs:
        with open(seg) as f:
            for line in f:
                try:
                    sweeps.append(json.loads(line))
                except ValueError:
                    continue
    return sweeps[-max_lines:]


def _report_from_url(base: str) -> dict:
    """Bundle over a live process's introspection endpoints."""
    def fetch(path):
        try:
            with urllib.request.urlopen(base.rstrip("/") + path,
                                        timeout=5.0) as resp:
                return json.load(resp)
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    alerts = fetch("/alerts")
    flight = fetch("/debug/flight")
    history = fetch("/history?window=300")
    return {"generated_t": time.time(), "source": base,
            "attribution": (flight.get("last_dump") or {}).get(
                "sections", {}).get("profile_trigger", {}).get("last")
            if isinstance(flight, dict) else None,
            "center_t": time.time(),
            "alert_timeline": (alerts.get("recent_events", [])
                               if isinstance(alerts, dict) else []),
            "alerts": alerts,
            "flight": {"last_dump_path": flight.get("last_dump_path")
                       if isinstance(flight, dict) else None,
                       "last_dump": flight.get("last_dump")
                       if isinstance(flight, dict) else None},
            "history_stats": (history.get("stats")
                              if isinstance(history, dict) else None),
            "history_window": {"series": history.get("series", [])}
            if isinstance(history, dict) else None}


def _report_offline(flight_dump: Optional[str],
                    history_dir: Optional[str]) -> dict:
    report: dict = {"generated_t": time.time(), "source": "offline",
                    "alert_timeline": [], "alerts": None,
                    "attribution": None, "center_t": None,
                    "flight": {"last_dump_path": flight_dump,
                               "last_dump": None},
                    "history_stats": None, "history_window": None}
    if flight_dump:
        with open(flight_dump) as f:
            dump = json.load(f)
        report["flight"]["last_dump"] = dump
        report["center_t"] = dump.get("time")
        sect = (dump.get("sections") or {}).get("profile_trigger") or {}
        report["attribution"] = sect.get("last")
    if history_dir:
        sweeps = load_history_segments(history_dir)
        # rebuild a query-shaped window from the raw sweep lines
        series: dict = {}
        for sw in sweeps:
            t = sw.get("t")
            for s in sw.get("series", ()):
                key = (s.get("name"), json.dumps(s.get("labels"),
                                                 sort_keys=True),
                       s.get("field"))
                series.setdefault(key, []).append([t, s.get("v")])
        report["history_window"] = {"series": [
            {"name": k[0], "labels": json.loads(k[1]), "field": k[2],
             "tier": "raw", "points": pts}
            for k, pts in sorted(series.items())]}
        report["history_stats"] = {"sweeps": len(sweeps),
                                   "source_dir": history_dir}
    return report


# ------------------------------------------------------------ rendering
def _fmt_t(t) -> str:
    if not isinstance(t, (int, float)):
        return "?"
    return time.strftime("%H:%M:%S", time.localtime(t))


def render_markdown(report: dict) -> str:
    """The human summary of one incident bundle."""
    out: List[str] = []
    out.append(f"# Post-mortem — {_fmt_t(report.get('center_t'))} "
               f"(generated {_fmt_t(report.get('generated_t'))}, "
               f"source: {report.get('source')})")
    att = report.get("attribution") or {}
    out.append("\n## Kernel attribution")
    culprits = att.get("culprit_kernels") or []
    if att.get("error"):
        out.append(f"attribution failed: `{att['error']}`")
    elif culprits:
        out.append(f"trigger: `{att.get('trigger', '?')}` at "
                   f"{_fmt_t(att.get('t'))}, capture "
                   f"{att.get('capture_ms', '?')} ms")
        out.append("")
        out.append("| kernel | ms | Δms vs golden | why |")
        out.append("|---|---|---|---|")
        for c in culprits:
            out.append(f"| `{c.get('kernel')}` | {c.get('ms', '')} "
                       f"| {c.get('delta_ms', '')} | {c.get('why', '')} |")
        diff = att.get("trace_diff") or {}
        if diff.get("delta_ms_per_step") is not None:
            out.append(f"\ndevice ms/step moved "
                       f"{diff['delta_ms_per_step']:+.2f} vs golden")
    else:
        out.append("no capture recorded (ProfileTrigger not installed, "
                   "gated, or nothing fired)")
    out.append("\n## Alert timeline")
    timeline = report.get("alert_timeline") or []
    if timeline:
        out.append("| t | event | alert | severity | value |")
        out.append("|---|---|---|---|---|")
        for ev in timeline:
            out.append(f"| {_fmt_t(ev.get('wall_t', ev.get('t')))} "
                       f"| {ev.get('event')} | {ev.get('name')} "
                       f"| {ev.get('severity')} "
                       f"| {ev.get('value', '')} |")
    else:
        out.append("no alert events recorded")
    out.append("\n## Metric trajectories")
    window = report.get("history_window") or {}
    series = window.get("series") or []
    if series:
        out.append("| series | field | points | last | trend |")
        out.append("|---|---|---|---|---|")
        for s in series[:40]:
            pts = s.get("points") or []
            vals = [p[1] for p in pts if len(p) > 1]
            label = s["name"]
            if s.get("labels"):
                inner = ",".join(f"{k}={v}"
                                 for k, v in sorted(s["labels"].items()))
                label += "{" + inner + "}"
            last = f"{vals[-1]:.4g}" if vals else ""
            out.append(f"| `{label}` | {s.get('field')} | {len(pts)} "
                       f"| {last} | {sparkline(vals)} |")
        if len(series) > 40:
            out.append(f"\n({len(series) - 40} more series in the JSON "
                       f"report)")
    else:
        out.append("no history window available")
    stats = report.get("history_stats") or {}
    if stats:
        out.append(f"\nhistory: {stats.get('series', '?')} series, "
                   f"{stats.get('raw_points', '?')} raw points, "
                   f"~{stats.get('est_bytes', 0)} bytes "
                   f"(cap {stats.get('max_bytes', '?')})")
    out.append("\n## Flight dump")
    fl = report.get("flight") or {}
    dump = fl.get("last_dump")
    if dump:
        exc = dump.get("exception") or {}
        out.append(f"`{exc.get('type')}`: {exc.get('message', '')[:200]}")
        out.append(f"context: `{json.dumps(dump.get('context', {}), default=str)[:300]}`")
        out.append(f"{len(dump.get('steps', []))} step records, "
                   f"{len(dump.get('events', []))} events"
                   + (f" — {fl['last_dump_path']}"
                      if fl.get("last_dump_path") else ""))
    else:
        out.append("no flight dump recorded")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.postmortem", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--url", help="live process introspection base URL")
    p.add_argument("--flight-dump", help="offline: a flight dump JSON")
    p.add_argument("--history-dir",
                   help="offline: PDTPU_HISTORY_DIR JSONL segments")
    p.add_argument("--out", help="write the JSON bundle here")
    p.add_argument("--md", help="write the markdown rendering here")
    args = p.parse_args(argv)

    if args.url:
        report = _report_from_url(args.url)
    elif args.flight_dump or args.history_dir:
        report = _report_offline(args.flight_dump, args.history_dir)
    else:
        report = build_report()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)
    md = render_markdown(report)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)
    if not args.out and not args.md:
        print(md)
    else:
        print(f"postmortem: {'JSON ' + args.out if args.out else ''}"
              f"{' ' if args.out and args.md else ''}"
              f"{'markdown ' + args.md if args.md else ''}".strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
