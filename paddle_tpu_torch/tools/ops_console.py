"""Live ops console: one terminal view of the whole fleet + its alerts.

A stdlib-only (urllib + ANSI) dashboard over the introspection
documents the coordinator already serves — ``/fleet`` (per-process
reachability, scrape latency, queue depth, pull p99), ``/alerts``
(the SLO engine's live pending/firing/resolved set), and ``/history``
(the ring TSDB: each autoscaler signal row gains a unicode sparkline of
its last five minutes, so a spike reads as a shape, not a number) —
refreshed in place every ``--interval`` seconds. Firing alerts render
on top in red, because when an operator opens this screen something is
usually already paging.

CLI::

    python -m paddle_tpu_torch.tools.ops_console http://coordinator:8080
    python -m paddle_tpu_torch.tools.ops_console http://c:8080 --interval 0.5
    python -m paddle_tpu_torch.tools.ops_console http://c:8080 --once --no-color

``--once`` renders a single frame and exits (scripts, tests); exit code
is 0 when nothing is firing, 1 when any alert is firing, 2 when the
coordinator is unreachable. Ctrl-C exits 0. Endpoints that 404 (no
scraper / no alert manager installed) degrade to an explanatory row
rather than an error: the console is useful from the moment the
introspection server is up, before the SLO plumbing is wired.

The port's copy of ``paddle_tpu.tools.ops_console``, stdlib only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

__all__ = ["gather", "render", "main"]

_CLEAR = "\x1b[2J\x1b[H"
_RED = "\x1b[31;1m"
_YELLOW = "\x1b[33;1m"
_GREEN = "\x1b[32m"
_DIM = "\x1b[2m"
_RESET = "\x1b[0m"

_SEV_ORDER = {"page": 0, "warn": 1}
_STATE_ORDER = {"firing": 0, "pending": 1, "resolved": 2}


def _fetch(base: str, path: str, timeout: float):
    """(doc-or-None, note): None doc with a human note on 404 (endpoint
    not wired yet) — anything else network-ish raises for gather() to
    turn into an unreachable-coordinator report."""
    url = base.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.load(resp), ""
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None, f"{path}: not wired ({e.reason})"
        if e.code == 503:
            # /fleet answers 503 with the full document when any target
            # is down — that IS the interesting frame, keep it
            try:
                return json.load(e), ""
            except Exception:
                return None, f"{path}: HTTP {e.code}"
        return None, f"{path}: HTTP {e.code}"


def gather(base: str, timeout: float = 2.0) -> dict:
    """One console frame's data: ``{"fleet", "alerts", "notes",
    "reachable"}``. Never raises — an unreachable coordinator comes back
    as ``reachable: False`` with the error in notes."""
    notes = []
    out = {"fleet": None, "alerts": None, "history": None,
           "notes": notes, "reachable": True}
    for key, path in (("fleet", "/fleet"), ("alerts", "/alerts"),
                      ("history", "/history?prefix=autoscale/"
                                  "&window=300&max_points=64")):
        try:
            doc, note = _fetch(base, path, timeout)
        except Exception as e:
            out["reachable"] = False
            notes.append(f"{path}: {type(e).__name__}: {e}")
            continue
        out[key] = doc
        if note:
            notes.append(note)
    return out


def _spark_map(history_doc) -> dict:
    """(series_name, sub_label) -> sparkline over the /history window.
    sub_label is the shard for per-shard series, the process for
    per-process series, None for scalar signals."""
    out: dict = {}
    if not isinstance(history_doc, dict):
        return out
    from .postmortem import sparkline
    for s in history_doc.get("series", ()):
        name = s.get("name", "")
        labels = s.get("labels") or {}
        if name == "autoscale/ps_pull_p99_ms":
            sub = labels.get("shard")
        elif name == "autoscale/queue_depth":
            sub = labels.get("process")
        else:
            sub = None
        vals = [p[1] for p in s.get("points", ()) if len(p) > 1]
        if vals:
            out[(name, sub)] = sparkline(vals)
    return out


def _series_get(series, name, field="value"):
    for s in series:
        if s.get("name") != name:
            continue
        if s.get("type") == "summary":
            return (s.get("summary") or {}).get(field)
        return s.get("value")
    return None


def _c(text: str, color: str, on: bool) -> str:
    return f"{color}{text}{_RESET}" if on else text


def render(frame: dict, color: bool = True, now: float = None) -> str:
    """One frame of the dashboard as a string (testable without a tty).
    Sections: firing/pending alerts first, then the per-process fleet
    table, then the autoscaler signal line and any notes."""
    now = time.time() if now is None else now
    lines = [f"paddle_tpu_torch ops console — "
             f"{time.strftime('%H:%M:%S', time.localtime(now))}"]
    if not frame.get("reachable", True):
        lines.append(_c("COORDINATOR UNREACHABLE", _RED, color))
        for n in frame.get("notes", ()):
            lines.append(f"  {n}")
        return "\n".join(lines) + "\n"

    # ---------------------------------------------------------- alerts
    adoc = frame.get("alerts")
    if adoc is None:
        lines.append(_c("alerts: (no AlertManager installed)", _DIM, color))
    else:
        alerts = sorted(
            adoc.get("alerts", ()),
            key=lambda a: (_STATE_ORDER.get(a.get("state"), 9),
                           _SEV_ORDER.get(a.get("severity"), 9),
                           a.get("name", "")))
        firing = [a for a in alerts if a.get("state") == "firing"]
        if not alerts:
            lines.append(_c("alerts: none — all objectives met",
                            _GREEN, color))
        else:
            lines.append(f"alerts: {len(firing)} firing / "
                         f"{adoc.get('pending', 0)} pending / "
                         f"{adoc.get('resolved', 0)} resolved")
            for a in alerts:
                sev = a.get("severity", "?")
                state = a.get("state", "?")
                labels = {k: v for k, v in (a.get("labels") or {}).items()
                          if k != "slo"}
                lstr = ("{" + ",".join(f"{k}={v}" for k, v in
                                       sorted(labels.items())) + "}"
                        if labels else "")
                burn = a.get("value")
                row = (f"  [{sev:>4}] {a.get('name')}{lstr} {state}"
                       + (f"  burn={burn}" if burn is not None else ""))
                if state == "firing":
                    row = _c(row, _RED if sev == "page" else _YELLOW, color)
                elif state == "resolved":
                    row = _c(row, _DIM, color)
                lines.append(row)

    # ----------------------------------------------------------- fleet
    fdoc = frame.get("fleet")
    if fdoc is None:
        lines.append(_c("fleet: (no FederatedScraper installed)",
                        _DIM, color))
    else:
        lines.append("")
        lines.append(f"{'process':<28}{'role':<10}{'shard':>6}{'state':>8}"
                     f"{'scrape_ms':>11}{'queue':>7}{'pull_p99':>10}"
                     f"{'tenant_p99':>12}")
        for r in fdoc.get("targets", ()):
            q = _series_get(r.get("series", ()), "serving/queue_depth")
            p99 = _series_get(r.get("series", ()), "ps/shard_pull_ms",
                              field="p99")
            tp99 = _series_get(r.get("series", ()),
                               "fleet/tenant_latency_ms", field="p99")
            state = "up" if r.get("ok") else "DOWN"
            row = (f"{r.get('process', '?'):<28}{r.get('role', '?'):<10}"
                   f"{'-' if r.get('shard') is None else r['shard']:>6}"
                   f"{state:>8}{r.get('scrape_ms', 0):>11.1f}"
                   f"{'-' if q is None else int(q):>7}"
                   f"{'-' if p99 is None else round(p99, 1):>10}"
                   f"{'-' if tp99 is None else round(tp99, 1):>12}")
            if not r.get("ok"):
                row = _c(row, _RED, color)
            lines.append(row)
            if not r.get("ok") and r.get("error"):
                lines.append(_c(f"    {r['error']}", _DIM, color))
        sig = fdoc.get("signals") or {}
        if sig:
            lines.append("")
            sparks = _spark_map(frame.get("history"))
            for key in sorted(sig):
                val = sig[key]
                nm = f"autoscale/{key}"
                if isinstance(val, dict):
                    # per-label signal (pull p99 by shard, queue by proc)
                    for sub in sorted(val):
                        label = f"{key}[{sub}]"
                        spark = sparks.get((nm, str(sub)), "")
                        lines.append(f"  {label:<26}{val[sub]:>10.1f}  "
                                     + _c(spark, _DIM, color))
                else:
                    spark = sparks.get((nm, None), "")
                    lines.append(f"  {key:<26}{float(val):>10.1f}  "
                                 + _c(spark, _DIM, color))

    for n in frame.get("notes", ()):
        lines.append(_c(f"note: {n}", _DIM, color))
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ops_console",
        description="live terminal dashboard over /fleet + /alerts")
    ap.add_argument("coordinator",
                    help="introspection base URL (http://host:port)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period, seconds (default 2)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-request timeout, seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (0 = nothing firing, "
                         "1 = alerts firing, 2 = coordinator unreachable)")
    ap.add_argument("--no-color", action="store_true",
                    help="plain text (pipes, logs, dumb terminals)")
    args = ap.parse_args(argv)
    if args.interval <= 0:
        raise SystemExit("ops_console: --interval must be > 0")
    color = not args.no_color and sys.stdout.isatty()

    def frame_rc(frame) -> int:
        if not frame["reachable"]:
            return 2
        adoc = frame.get("alerts") or {}
        return 1 if adoc.get("firing") else 0

    if args.once:
        frame = gather(args.coordinator, timeout=args.timeout)
        sys.stdout.write(render(frame, color=color))
        return frame_rc(frame)
    try:
        while True:
            frame = gather(args.coordinator, timeout=args.timeout)
            sys.stdout.write(_CLEAR + render(frame, color=color))
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
