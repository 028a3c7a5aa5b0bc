"""Static lint for metric names: catch drift before a scraper does.

The registry sanitizes names at export time (``/`` → ``_`` etc.), which
keeps hostile values scrapeable but also means two DIFFERENT raw names
can silently collide post-sanitization, and a typo'd name simply
becomes a new, empty series. This linter scans the package source for
``counter("..."``/``gauge("..."``/``histogram("..."`` string literals
and fails on:

* exposition-illegal raw names — anything outside
  ``[a-zA-Z_][a-zA-Z0-9_/]*`` (the repo convention: ``/`` namespacing,
  folded to ``_`` at export). A dash or colon would fold silently and
  is exactly the drift this lint exists to catch;
* the same raw name registered with conflicting metric types (a
  ``counter("x")`` here and a ``gauge("x")`` there renders two ``# TYPE``
  claims for one series — Prometheus rejects the page);
* two distinct raw names that sanitize to the same exposition name
  (post-fold collision).

It also lints the metrics-history JSONL spill (``PDTPU_HISTORY_DIR``
segments written by `observability.history.MetricsHistory`): every line
must be valid JSON with a numeric ``t`` and a ``series`` list whose
entries carry a legal ``name``, a string-valued ``labels`` dict, a
known ``field``, and a numeric ``v`` — the contract
`tools/postmortem.py --history-dir` replays offline. A torn FINAL line
of the NEWEST segment is tolerated (the process may have died
mid-write; that is the segment's whole purpose).

Wired as a plain pytest (tests/test_metrics_lint.py) so CI catches
metric-name drift on every run, and as a CLI::

    python -m paddle_tpu_torch.tools.metrics_lint [root]
    python -m paddle_tpu_torch.tools.metrics_lint --history /path/to/segments

Exit 0 when clean, 1 with one line per problem otherwise.

The port's copy of ``paddle_tpu.tools.metrics_lint``, stdlib only.
"""
from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List, Tuple

__all__ = ["scan_file", "lint_source_tree", "lint_history_segments",
           "main"]

# the summary fields history.py extracts, plus plain value
_HISTORY_FIELDS = ("value", "p50", "p99", "count")

# reg.counter("name" / .gauge('name' / histogram("name" — a quote must
# immediately follow the paren, so definitions (`def counter(self, ...`)
# and f-strings (dynamic names are the caller's problem) don't match
_CALL_RE = re.compile(
    r"\b(counter|gauge|histogram)\(\s*(['\"])((?:[^'\"\\]|\\.)*)\2")

_LEGAL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_/]*$")


def _sanitized(name: str) -> str:
    from ..observability.registry import _prom_metric_name
    return _prom_metric_name(name)


def scan_file(path: str) -> List[Tuple[str, str, int]]:
    """(metric_type, raw_name, line_number) for every literal metric
    registration in `path`."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    out = []
    for m in _CALL_RE.finditer(src):
        line = src.count("\n", 0, m.start()) + 1
        out.append((m.group(1), m.group(3), line))
    return out


def lint_source_tree(root: str) -> List[str]:
    """One human-readable line per problem found under `root`
    (recursively, ``*.py``); empty list means clean."""
    sites: Dict[str, List[Tuple[str, str, int]]] = {}  # name -> uses
    problems: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            # the linter's own docstring is full of deliberately-bad
            # example registrations
            if not fn.endswith(".py") or fn == "metrics_lint.py":
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            for mtype, name, line in scan_file(path):
                sites.setdefault(name, []).append((mtype, rel, line))
                if not _LEGAL_RE.match(name):
                    problems.append(
                        f"{rel}:{line}: illegal metric name {name!r} "
                        f"(must match [a-zA-Z_][a-zA-Z0-9_/]*)")
    # type conflicts: one raw name, more than one metric type
    for name in sorted(sites):
        types = sorted({t for t, _, _ in sites[name]})
        if len(types) > 1:
            where = ", ".join(f"{t} at {r}:{ln}"
                              for t, r, ln in sites[name])
            problems.append(
                f"metric {name!r} registered with conflicting types "
                f"{types}: {where}")
    # post-sanitization collisions between distinct raw names
    by_exposed: Dict[str, set] = {}
    for name in sites:
        by_exposed.setdefault(_sanitized(name), set()).add(name)
    for exposed, names in sorted(by_exposed.items()):
        if len(names) > 1:
            problems.append(
                f"raw names {sorted(names)} all sanitize to {exposed!r} "
                f"— they would merge into one exposition series")
    return problems


def lint_history_segments(history_dir: str) -> List[str]:
    """One line per problem in the ``history_*.jsonl`` spill segments
    under `history_dir`; empty list means clean (or no segments)."""
    problems: List[str] = []
    segs = sorted(f for f in os.listdir(history_dir)
                  if f.startswith("history_") and f.endswith(".jsonl"))
    for si, seg in enumerate(segs):
        path = os.path.join(history_dir, seg)
        with open(path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        last_t = None
        for ln, raw in enumerate(lines, 1):
            try:
                doc = json.loads(raw)
            except ValueError:
                if si == len(segs) - 1 and ln == len(lines):
                    continue  # torn final write of the live segment
                problems.append(f"{seg}:{ln}: not valid JSON")
                continue
            t = doc.get("t")
            if not isinstance(t, (int, float)):
                problems.append(f"{seg}:{ln}: missing numeric 't'")
            elif last_t is not None and t < last_t:
                problems.append(
                    f"{seg}:{ln}: timestamp moved backwards "
                    f"({t} < {last_t})")
            else:
                last_t = t
            series = doc.get("series")
            if not isinstance(series, list):
                problems.append(f"{seg}:{ln}: 'series' is not a list")
                continue
            for i, s in enumerate(series):
                where = f"{seg}:{ln} series[{i}]"
                name = s.get("name") if isinstance(s, dict) else None
                if not (isinstance(name, str) and _LEGAL_RE.match(name)):
                    problems.append(f"{where}: illegal name {name!r}")
                    continue
                if s.get("field") not in _HISTORY_FIELDS:
                    problems.append(
                        f"{where}: unknown field {s.get('field')!r} "
                        f"(one of {_HISTORY_FIELDS})")
                if not isinstance(s.get("v"), (int, float)):
                    problems.append(
                        f"{where}: non-numeric value {s.get('v')!r}")
                labels = s.get("labels")
                if labels is not None and not (
                        isinstance(labels, dict)
                        and all(isinstance(k, str) and isinstance(v, str)
                                for k, v in labels.items())):
                    problems.append(
                        f"{where}: labels must be a str->str dict")
    return problems


def default_root() -> str:
    """The paddle_tpu_torch package directory (what CI lints)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    history_dirs = []
    while "--history" in args:
        i = args.index("--history")
        try:
            history_dirs.append(args[i + 1])
        except IndexError:
            print("metrics_lint: --history needs a directory",
                  file=sys.stderr)
            return 2
        del args[i:i + 2]
    if history_dirs:
        problems = []
        for d in history_dirs:
            problems += [f"{d}: {p}" for p in lint_history_segments(d)]
        for p in problems:
            print(p)
        if problems:
            print(f"metrics_lint: {len(problems)} problem(s) in "
                  f"history segments")
            return 1
        print(f"metrics_lint: history segments clean "
              f"({', '.join(history_dirs)})")
        return 0
    root = args[0] if args else default_root()
    problems = lint_source_tree(root)
    for p in problems:
        print(p)
    if problems:
        print(f"metrics_lint: {len(problems)} problem(s) under {root}")
        return 1
    print(f"metrics_lint: clean ({root})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
