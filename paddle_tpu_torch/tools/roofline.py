"""Per-kernel roofline report from a ``torch.profiler`` chrome trace.

Counterpart of ``paddle_tpu.tools.roofline``. Given a trace (a
``.json[.gz]`` file or a profiler session's log dir, e.g. the
``profile_path`` of ``paddle_tpu_torch.profiler.profiler()``), report
the top-k kernels by device time with their achieved GB/s and TFLOP/s and
``util_vs_bound`` — the kernel's achieved fraction of whichever floor
(stream or matmul) it sits closer to — plus the sub-cutoff tail in
aggregate. Floors come from the shared calibration cache
(observability/calibrate.py) unless overridden with
``--matmul-tflops/--stream-gbs``.

Device events: a ``torch.profiler`` trace marks the card's work by
``cat`` — ``kernel``, ``gpu_memcpy``, ``gpu_memset`` — on the card's pid,
one tid a stream; those are the events counted. A trace without that
metadata (a synthetic or foreign one) is read by the JAX package's rule:
a TPU process's ``XLA Ops`` thread, else every ``X`` event less the
loop/step overhead spans. A hand kernel's row is named by
``kernel_counts.kernel_label`` (``flash_fwd_bf16_kernel<64>``), other
kernels keep their demangled names.

Counts: torch's kernel events carry no byte or flop count. An event's
``bytes_accessed``/``model_flops`` args are used where present (synthetic
traces); the hand kernels' counts come from the declarations a profiler
session writes beside its trace (``*.pt.declared.json``, see
``observability.kernel_counts``). The join goes by the kernel's base name:
each declared row names the base names of the kernels its launches run,
and its flops and bytes go to the kernel row of that base name when the
row has one kernel (a forward); every declared row also gets a
``hand_kernels`` entry summing its kernels' device time (a backward's
delta, dq and dk/dv kernels together). Where one base name has several
template instantiations in a trace, the declared counts are split among
them by their calls.

``--diff OTHER`` compares two traces: per-kernel ms deltas sorted by
absolute movement, plus kernels that appear in only one trace.

Usage::

    python -m paddle_tpu_torch.tools.roofline TRACE [--topk 20]
        [--cutoff-ms 0.5] [--steps 1] [--json]
        [--matmul-tflops X --stream-gbs Y] [--diff OTHER]
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
from typing import Optional, Tuple

__all__ = ["load_trace", "kernel_table", "capture_kernel_table",
           "diff_tables", "main"]


DECLARED_SUFFIX = ".pt.declared.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_traces(path: str) -> list:
    """A log dir's trace files, oldest first: a profiler session's
    ``*.pt.trace.json[.gz]`` (also under ``plugins/profile/*/``) and any
    other ``*.trace.json[.gz]``."""
    pats = ("*.pt.trace.json", "*.pt.trace.json.gz", "*.trace.json",
            "*.trace.json.gz", "plugins/profile/*/*.trace.json",
            "plugins/profile/*/*.trace.json.gz")
    found = {p for pat in pats for p in glob.glob(os.path.join(path, pat))}
    return sorted(found, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    """Load a chrome trace: plain ``.json``, gzipped ``.json.gz``, or a
    profiler log dir (picks the newest trace file). The declared counts a
    session wrote beside the file ride along under
    ``"declaredCounts"``."""
    if os.path.isdir(path):
        cands = find_traces(path)
        if not cands:
            raise FileNotFoundError(f"no trace files under {path!r}")
        path = cands[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    if isinstance(tr, list):
        tr = {"traceEvents": tr}
    stem = path[:-3] if path.endswith(".gz") else path
    if stem.endswith(".pt.trace.json"):
        side = stem[:-len(".pt.trace.json")] + DECLARED_SUFFIX
        if os.path.exists(side):
            with open(side) as f:
                tr["declaredCounts"] = json.load(f)
    return tr


def _kernel_name(name: str) -> str:
    from ..observability.kernel_counts import kernel_label
    return kernel_label(name) or name


def _aggregate(tr: dict) -> "collections.defaultdict":
    """name -> [us, calls, bytes, flops] over the trace's device kernel
    events: the ``kernel``/``gpu_memcpy``/``gpu_memset`` events of a
    torch.profiler trace, else the ``XLA Ops`` thread inside device
    (``TPU``) pids; when the trace has neither (synthetic or foreign
    traces) every X event counts, minus the loop/step overhead spans."""
    events = tr.get("traceEvents", [])
    if any(e.get("cat") in DEVICE_CATS for e in events
           if e.get("ph") == "X"):
        agg = collections.defaultdict(lambda: [0.0, 0, 0.0, 0.0])
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = agg[_kernel_name(e.get("name", ""))]
            a[0] += float(e.get("dur", 0.0))
            a[1] += 1
            args = e.get("args") or {}
            a[2] += float(args.get("bytes_accessed", 0) or 0)
            a[3] += float(args.get("model_flops", 0) or 0)
        return agg
    pidname = {e["pid"]: e["args"].get("name", "") for e in tr["traceEvents"]
               if e.get("ph") == "M" and e.get("name") == "process_name"}
    tidname = {(e["pid"], e.get("tid")): e["args"].get("name", "")
               for e in tr["traceEvents"]
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    dev_pids = {p for p, nm in pidname.items() if "TPU" in nm}
    op_keys = {k for k, nm in tidname.items() if nm == "XLA Ops"
               and (not dev_pids or k[0] in dev_pids)}

    agg = collections.defaultdict(lambda: [0.0, 0, 0.0, 0.0])
    for e in tr["traceEvents"]:
        if e.get("ph") != "X":
            continue
        nm = e.get("name", "")
        if op_keys:
            if (e.get("pid"), e.get("tid")) not in op_keys:
                continue
        else:
            if dev_pids and e.get("pid") not in dev_pids:
                continue
            if nm == "while" or nm.startswith("jit_") or nm.isdigit():
                continue
        a = agg[nm]
        a[0] += e.get("dur", 0.0)
        a[1] += 1
        a[2] += float(e.get("args", {}).get("bytes_accessed", 0) or 0)
        a[3] += float(e.get("args", {}).get("model_flops", 0) or 0)
    return agg


def kernel_table(tr: dict, floors: Tuple[float, float], steps: int = 1,
                 cutoff_ms: float = 0.5, topk: Optional[int] = None) -> dict:
    """The bench ``per_kernel`` dict from an in-memory trace: every
    kernel >= cutoff_ms per step with achieved GB/s / TFLOP/s /
    util_vs_bound, the sub-cutoff tail in aggregate, and whole-trace
    aggregate rates."""
    mm_tflops, stream_gbs = floors
    agg = _aggregate(tr)
    if not agg:
        return {"error": "no kernel events in trace"}
    hand = _join_declared(agg, tr.get("declaredCounts") or {}, floors,
                          steps)
    total_us = sum(a[0] for a in agg.values())
    rows = []
    tail_us = tail_by = tail_fl = tail_n = 0
    for nm, (us, c, by, fl) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        ms = us / steps / 1e3
        gbs = by / (us * 1e-6) / 1e9 if us else 0.0
        tfs = fl / (us * 1e-6) / 1e12 if us else 0.0
        if ms >= cutoff_ms and (topk is None or len(rows) < topk):
            rows.append({"kernel": nm, "ms": round(ms, 3),
                         "calls": c, "gbs": round(gbs, 1),
                         "tfs": round(tfs, 1),
                         "util_vs_bound": round(
                             max(gbs / stream_gbs, tfs / mm_tflops), 3)})
        else:
            tail_us += us
            tail_by += by
            tail_fl += fl
            tail_n += 1
    return {
        "device_ms_per_step": round(total_us / steps / 1e3, 2),
        "kernels": rows,
        "tail": {"n_kernel_names": tail_n,
                 "ms": round(tail_us / steps / 1e3, 2),
                 "gbs": round(tail_by / (tail_us * 1e-6) / 1e9, 1)
                 if tail_us else 0.0,
                 "tfs": round(tail_fl / (tail_us * 1e-6) / 1e12, 1)
                 if tail_us else 0.0},
        "aggregate_gbs": round(
            sum(a[2] for a in agg.values()) / (total_us * 1e-6) / 1e9, 1),
        "aggregate_tfs": round(
            sum(a[3] for a in agg.values()) / (total_us * 1e-6) / 1e12, 1),
        **({"hand_kernels": hand} if hand else {}),
    }


def _join_declared(agg, declared: dict, floors, steps: int) -> list:
    """Give the kernel rows the hand kernels' declared counts (module
    docstring) and return one entry a declared row: its kernels' summed
    device time and calls, its launches and counts, and its achieved
    rates against the floors."""
    from ..observability.kernel_counts import base_name

    mm_tflops, stream_gbs = floors
    by_base = collections.defaultdict(list)
    for nm in agg:
        by_base[base_name(nm)].append(nm)
    out = []
    for row, d in sorted(declared.items()):
        names = [nm for k in d.get("kernels", ()) for nm in by_base.get(k, ())]
        us = sum(agg[nm][0] for nm in names)
        flops, nbytes = float(d.get("flops", 0)), float(d.get("bytes", 0))
        if len(d.get("kernels", ())) == 1 and names:
            calls = sum(agg[nm][1] for nm in names) or 1
            for nm in names:
                share = agg[nm][1] / calls
                agg[nm][2] += nbytes * share
                agg[nm][3] += flops * share
        gbs = nbytes / (us * 1e-6) / 1e9 if us else 0.0
        tfs = flops / (us * 1e-6) / 1e12 if us else 0.0
        out.append({
            "name": row, "kernels": names, "launches": d.get("calls", 0),
            "calls": sum(agg[nm][1] for nm in names),
            "ms": round(us / steps / 1e3, 3),
            "ms_per_launch": (round(us / 1e3 / d["calls"], 4)
                              if d.get("calls") else None),
            "flops": flops, "bytes": nbytes, "gbs": round(gbs, 1),
            "tfs": round(tfs, 1),
            "util_vs_bound": round(max(gbs / stream_gbs, tfs / mm_tflops),
                                   3) if us else None})
    return out


def capture_kernel_table(run_step, floors: Tuple[float, float],
                         steps: int = 2, cutoff_ms: float = 0.5) -> dict:
    """Trace `steps` live invocations of `run_step` in a profiler session
    and build the kernel table."""
    import shutil
    import tempfile

    from .. import profiler

    run_step()  # warm
    tdir = tempfile.mkdtemp(prefix="pdtpu_kernels_")
    try:
        with profiler._guard("roofline.capture_kernel_table"):
            session = profiler.Session(tdir, all_threads=True).start()
            try:
                for _ in range(steps):
                    run_step()
            finally:
                session.stop()
        try:
            tr = load_trace(tdir)
        except FileNotFoundError:
            return {"error": "no trace captured"}
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    return kernel_table(tr, floors, steps=steps, cutoff_ms=cutoff_ms)


def diff_tables(a: dict, b: dict, topk: int = 20) -> dict:
    """Per-kernel ms movement between two kernel tables (b − a): the
    biggest movers by |delta|, plus kernels present in only one trace."""
    rows_a = {r["kernel"]: r for r in a.get("kernels", [])}
    rows_b = {r["kernel"]: r for r in b.get("kernels", [])}
    moved = []
    for nm in set(rows_a) | set(rows_b):
        ra, rb = rows_a.get(nm), rows_b.get(nm)
        ms_a = ra["ms"] if ra else 0.0
        ms_b = rb["ms"] if rb else 0.0
        moved.append({"kernel": nm, "ms_a": ms_a, "ms_b": ms_b,
                      "delta_ms": round(ms_b - ms_a, 3),
                      "status": ("only_b" if ra is None
                                 else "only_a" if rb is None else "both")})
    moved.sort(key=lambda r: -abs(r["delta_ms"]))
    return {
        "device_ms_per_step_a": a.get("device_ms_per_step"),
        "device_ms_per_step_b": b.get("device_ms_per_step"),
        "delta_ms_per_step": (
            round(b["device_ms_per_step"] - a["device_ms_per_step"], 2)
            if (a.get("device_ms_per_step") is not None
                and b.get("device_ms_per_step") is not None) else None),
        "movers": moved[:topk],
        "only_in_a": sorted(set(rows_a) - set(rows_b)),
        "only_in_b": sorted(set(rows_b) - set(rows_a)),
    }


def _resolve_floors(args) -> Tuple[float, float, str]:
    if args.matmul_tflops and args.stream_gbs:
        return args.matmul_tflops, args.stream_gbs, "flags"
    from ..observability.calibrate import get_calibration
    c = get_calibration(recalibrate=args.recalibrate)
    return c.matmul_tflops, c.stream_gbs, c.source


def _print_table(tab: dict, floors, source: str) -> None:
    mm, st = floors
    print(f"floors: matmul {mm:.1f} TFLOP/s, stream {st:.1f} GB/s "
          f"({source})")
    if "error" in tab:
        print(f"error: {tab['error']}")
        return
    print(f"device time/step: {tab['device_ms_per_step']:.2f} ms   "
          f"aggregate: {tab['aggregate_gbs']:.1f} GB/s, "
          f"{tab['aggregate_tfs']:.1f} TFLOP/s")
    hdr = f"{'kernel':<48}{'ms':>9}{'calls':>7}{'GB/s':>8}" \
          f"{'TF/s':>8}{'util':>7}"
    print(hdr)
    for r in tab["kernels"]:
        print(f"{r['kernel'][:47]:<48}{r['ms']:>9.3f}{r['calls']:>7}"
              f"{r['gbs']:>8.1f}{r['tfs']:>8.1f}{r['util_vs_bound']:>7.3f}")
    t = tab["tail"]
    print(f"{'(tail: ' + str(t['n_kernel_names']) + ' kernels)':<48}"
          f"{t['ms']:>9.3f}{'':>7}{t['gbs']:>8.1f}{t['tfs']:>8.1f}")
    for h in tab.get("hand_kernels", ()):
        util = h["util_vs_bound"]
        print(f"{'[declared] ' + h['name']:<48}{h['ms']:>9.3f}"
              f"{h['launches']:>7}{h['gbs']:>8.1f}{h['tfs']:>8.1f}"
              f"{util if util is not None else float('nan'):>7.3f}")


def _print_diff(d: dict) -> None:
    print(f"device ms/step: {d['device_ms_per_step_a']} -> "
          f"{d['device_ms_per_step_b']} "
          f"(delta {d['delta_ms_per_step']})")
    print(f"{'kernel':<48}{'ms_a':>9}{'ms_b':>9}{'delta':>9}  status")
    for r in d["movers"]:
        print(f"{r['kernel'][:47]:<48}{r['ms_a']:>9.3f}{r['ms_b']:>9.3f}"
              f"{r['delta_ms']:>9.3f}  {r['status']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.roofline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="trace file (.json/.json.gz) or "
                                 "profiler log dir")
    p.add_argument("--diff", metavar="OTHER",
                   help="second trace: report per-kernel deltas "
                        "(OTHER - trace)")
    p.add_argument("--save-golden", action="store_true",
                   help="persist this trace's kernel table as the "
                        "golden for this (device kind, host) — the "
                        "baseline ProfileTrigger diffs captures against")
    p.add_argument("--diff-golden", action="store_true",
                   help="diff this trace against the recorded golden "
                        "(trace - golden)")
    p.add_argument("--golden-path", default=None,
                   help="override the golden cache file "
                        "(default: PDTPU_GOLDEN_DIR keyed like "
                        "calibrate.py)")
    p.add_argument("--topk", type=int, default=20)
    p.add_argument("--cutoff-ms", type=float, default=0.5)
    p.add_argument("--steps", type=int, default=1,
                   help="steps captured in the trace (divides times)")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--matmul-tflops", type=float, default=None)
    p.add_argument("--stream-gbs", type=float, default=None)
    p.add_argument("--recalibrate", action="store_true",
                   help="re-measure the chip floors instead of using the "
                        "calibration cache")
    args = p.parse_args(argv)

    try:
        tr = load_trace(args.trace)
    except Exception as e:
        print(f"roofline: cannot load {args.trace!r}: {e}", file=sys.stderr)
        return 2
    mm, st, source = _resolve_floors(args)
    tab = kernel_table(tr, (mm, st), steps=args.steps,
                       cutoff_ms=args.cutoff_ms, topk=args.topk)
    if args.save_golden:
        from ..observability import profile_trigger
        if "error" in tab:
            print(f"roofline: not saving golden: {tab['error']}",
                  file=sys.stderr)
            return 2
        path = profile_trigger.save_golden(tab, path=args.golden_path,
                                           note=args.trace)
        print(f"golden saved: {path}")
        return 0
    if args.diff_golden:
        from ..observability import profile_trigger
        golden = profile_trigger.load_golden(args.golden_path)
        if golden is None:
            print("roofline: no golden recorded (run --save-golden on a "
                  "healthy trace first)", file=sys.stderr)
            return 2
        d = diff_tables(golden["table"], tab, topk=args.topk)
        if args.as_json:
            print(json.dumps({"golden": golden["table"], "trace": tab,
                              "diff": d}))
        else:
            _print_diff(d)
        return 0
    if args.diff:
        try:
            tr2 = load_trace(args.diff)
        except Exception as e:
            print(f"roofline: cannot load {args.diff!r}: {e}",
                  file=sys.stderr)
            return 2
        tab2 = kernel_table(tr2, (mm, st), steps=args.steps,
                            cutoff_ms=args.cutoff_ms, topk=args.topk)
        d = diff_tables(tab, tab2, topk=args.topk)
        if args.as_json:
            print(json.dumps({"a": tab, "b": tab2, "diff": d}))
        else:
            _print_diff(d)
        return 0
    if args.as_json:
        print(json.dumps({"floors": {"matmul_tflops": mm, "stream_gbs": st,
                                     "source": source}, **tab}))
    else:
        _print_table(tab, (mm, st), source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
