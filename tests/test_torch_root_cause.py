"""The root-cause loop on the port, on the CPU: twins of
tests/test_root_cause.py (the MetricsHistory ring TSDB, its JSONL spill,
the /history endpoint, the ProfileTrigger's gating against a stub
profiler), each run on the same inputs through the JAX package's module and
the port's and held equal, plus the port's own torch backend: a real
``torch.profiler`` capture from the trigger's thread while the main thread
steps, the one-session guard it shares with ``profiler.start_profiler``
(an arm while a session runs is a busy skip, never an error in the step),
and the capture's attribution."""
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from paddle_tpu.observability import history as jhistory
from paddle_tpu.observability import profile_trigger as jtrigger
from paddle_tpu.observability.registry import Registry as JRegistry
from paddle_tpu_torch.observability import history as thistory
from paddle_tpu_torch.observability import profile_trigger as ttrigger
from paddle_tpu_torch.observability.registry import Registry as TRegistry

torch.set_num_threads(1)

PKGS = {"jax": (jhistory, jtrigger, JRegistry),
        "port": (thistory, ttrigger, TRegistry)}


def sweep_doc(t, series, process="w0", role="worker", shard=None):
    tgt = {"ok": True, "process": process, "role": role, "series": series}
    if shard is not None:
        tgt["shard"] = shard
    return {"t": t, "targets": [tgt]}


def g(name, value, **labels):
    return {"name": name, "type": "gauge", "labels": labels,
            "value": float(value)}


def summ(name, **fields):
    return {"name": name, "type": "summary", "labels": {},
            "summary": dict(fields)}


def both(fn):
    """fn(history module, trigger module, Registry) on both packages."""
    return {k: fn(*mods) for k, mods in PKGS.items()}


# -- MetricsHistory ---------------------------------------------------------

def _windowed(h_mod, _t, reg):
    h = h_mod.MetricsHistory(raw_points=64, max_mb=4, registry=reg())
    t0 = 1000.0
    for i in range(30):
        h.observe_sweep(sweep_doc(t0 + i, [
            g("steps/wall_ms_gauge", i),
            summ("ps/shard_pull_ms", p50=1.0 + i, p99=5.0 + i, count=i),
        ]))
    with pytest.raises(ValueError):
        h.query(tier="bogus")
    return {"ps": h.query(prefix="ps/"), "mid": h.query(tier="mid"),
            "long": h.query(tier="long", max_points=4),
            "window": h.window(t0 + 15, half_width_s=5)}


def test_history_records_and_windows():
    out = both(_windowed)
    assert out["port"] == out["jax"]
    series = out["port"]["ps"]
    assert {s["field"] for s in series} == {"p50", "p99", "count"}
    assert all(s["labels"]["process"] == "w0" for s in series)
    pts = [s for s in series if s["field"] == "p99"][0]["points"]
    assert [p[1] for p in pts] == [5.0 + i for i in range(30)]
    for s in out["port"]["window"]["series"]:
        for t, _ in s["points"]:
            assert 1010.0 <= t <= 1020.0


def test_history_series_own_labels_beat_target_labels():
    def run(h_mod, _t, reg):
        h = h_mod.MetricsHistory(registry=reg())
        h.observe_sweep(sweep_doc(1.0, [
            g("autoscale/queue_depth", 7, process="trainer-3")]))
        return h.query(prefix="autoscale/")
    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0]["labels"]["process"] == "trainer-3"


def test_history_concurrent_sweeps_and_queries_stay_under_cap():
    """The JAX test's load on the port's history: writers hammer
    observe_sweep while readers query; no torn reads, the byte estimate
    honors the cap, and tracemalloc's count stays within 6x of it."""
    cap_mb = 1.0
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        h = thistory.MetricsHistory(raw_points=256, max_mb=cap_mb,
                                    max_series=512, registry=TRegistry())
        errors = []
        stop = threading.Event()

        def writer(wid):
            try:
                i = 0
                while not stop.is_set():
                    i += 1
                    h.observe_sweep(sweep_doc(
                        time.time(), [g(f"load/sig_{wid}_{i % 40}", i)]
                        + [summ("load/lat_ms", p50=i, p99=2 * i, count=i)],
                        process=f"w{wid}"))
            except Exception as e:  # pragma: no cover
                errors.append(f"writer: {type(e).__name__}: {e}")

        def reader():
            try:
                while not stop.is_set():
                    for s in h.query(prefix="load/", max_points=128):
                        ts = [p[0] for p in s["points"]]
                        assert ts == sorted(ts), "torn read"
                    h.stats()
            except Exception as e:  # pragma: no cover
                errors.append(f"reader: {type(e).__name__}: {e}")

        threads = ([threading.Thread(target=writer, args=(i,))
                    for i in range(3)]
                   + [threading.Thread(target=reader) for _ in range(2)])
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors, errors
        st = h.stats()
        assert st["sweeps"] > 50, "writers barely ran"
        assert 0 < st["est_bytes"] <= h.max_bytes
        current, _ = tracemalloc.get_traced_memory()
        assert current - before < 6 * h.max_bytes
    finally:
        tracemalloc.stop()


def test_history_evicts_oldest_series_first():
    def run(h_mod, _t, reg):
        h = h_mod.MetricsHistory(raw_points=16, max_mb=4, max_series=16,
                                 registry=reg())
        for i in range(40):
            h.observe_sweep(sweep_doc(float(i), [g(f"n/s{i}", i)]))
        return sorted(s["name"] for s in h.query())
    out = both(run)
    assert out["port"] == out["jax"]
    assert len(out["port"]) <= 16
    assert "n/s39" in out["port"] and "n/s0" not in out["port"]


def test_history_jsonl_spill_rotates_and_lints(tmp_path, monkeypatch):
    from paddle_tpu.tools import metrics_lint as jlint
    from paddle_tpu.tools import postmortem as jpm
    from paddle_tpu_torch.tools import metrics_lint as tlint
    from paddle_tpu_torch.tools import postmortem as tpm

    monkeypatch.setenv("PDTPU_HISTORY_SEGMENT_MB", "0.001")  # ~1 KB
    monkeypatch.setenv("PDTPU_HISTORY_MAX_SEGMENTS", "3")
    docs = {}
    for key, (h_mod, _t, reg) in PKGS.items():
        d = tmp_path / key
        h = h_mod.MetricsHistory(raw_points=32, spill_dir=str(d),
                                 registry=reg())
        for i in range(200):
            h.observe_sweep(sweep_doc(float(i), [
                g("spill/a", i), summ("spill/b", p50=i, p99=i, count=i)]))
        h.stop()
        segs = sorted(p for p in os.listdir(d) if p.endswith(".jsonl"))
        assert 1 <= len(segs) <= 3, segs
        docs[key] = d
    # the port's segments lint clean under both linters, and replay under
    # both postmortems to the same sweeps the JAX package's files give
    assert tlint.lint_history_segments(str(docs["port"])) == []
    assert jlint.lint_history_segments(str(docs["port"])) == []
    sweeps = tpm.load_history_segments(str(docs["port"]))
    assert sweeps and all("t" in d and "series" in d for d in sweeps)
    assert sweeps == jpm.load_history_segments(str(docs["jax"]))


# -- /history endpoint ------------------------------------------------------

def _http_get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_history_endpoint():
    from paddle_tpu_torch.observability import http as ihttp

    srv = ihttp.IntrospectionServer(port=0).start()
    try:
        code, _ = _http_get(srv.url + "/history")
        assert code == 404  # nothing installed yet
        h = thistory.MetricsHistory(registry=TRegistry())
        thistory.install_history(h)
        try:
            now = time.time()
            for i in range(5):
                h.observe_sweep(sweep_doc(now - 4 + i, [g("ep/x", i)]))
            code, body = _http_get(srv.url + "/history?prefix=ep/&window=60")
            assert code == 200
            doc = json.loads(body)
            assert doc["stats"]["sweeps"] == 5
            (s,) = doc["series"]
            assert s["name"] == "ep/x" and len(s["points"]) == 5
            code, _ = _http_get(srv.url + "/history?tier=bogus")
            assert code == 400
        finally:
            thistory.install_history(None)
        assert thistory.get_history() is None
    finally:
        srv.stop()


# -- ProfileTrigger gating --------------------------------------------------

class StubProfiler:
    def __init__(self):
        self.starts = []
        self.stops = 0

    def start(self, logdir):
        self.starts.append(logdir)

    def stop(self):
        self.stops += 1


def mk_trigger(t_mod, reg_cls, **kw):
    reg = reg_cls()
    prof = StubProfiler()
    kw.setdefault("window_steps", 2)
    kw.setdefault("window_s", 0.2)
    kw.setdefault("cooldown_s", 60.0)
    kw.setdefault("max_captures_per_h", 12)
    return reg, prof, t_mod.ProfileTrigger(profiler=prof, registry=reg, **kw)


def skipped(reg, reason):
    return reg.counter("profiler/skipped", reason=reason).value


def test_trigger_kill_switch(monkeypatch):
    def run(_h, t_mod, reg_cls):
        reg, prof, trig = mk_trigger(t_mod, reg_cls)
        monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "0")
        off = trig.arm("slow_step")
        monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")
        on = trig.arm("slow_step")
        trig.wait_idle(5)
        return (off is None, len(prof.starts), skipped(reg, "disabled"),
                on is not None)
    out = both(run)
    assert out["port"] == out["jax"] == (True, 1, 1, True)


def test_trigger_busy_and_window_close_on_steps(monkeypatch):
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")

    def run(_h, t_mod, reg_cls):
        reg, prof, trig = mk_trigger(t_mod, reg_cls, window_s=30.0)
        t = trig.arm("slow_step")
        second = trig.arm("slow_step")
        deadline = time.time() + 5
        while not prof.starts and time.time() < deadline:
            time.sleep(0.01)
        trig.on_record({"step": 1})
        trig.on_record({"step": 2})
        t.join(timeout=10)
        assert trig.wait_idle(5)
        att = trig.last_attribution()
        return (second is None, skipped(reg, "busy"), len(prof.starts),
                t.is_alive(), prof.stops, att["trigger"], "error" in att)
    out = both(run)
    assert out["port"] == out["jax"] == (True, 1, 1, False, 1, "slow_step",
                                         True)


def test_trigger_cooldown_and_hourly_cap(monkeypatch):
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")

    def run(_h, t_mod, reg_cls):
        reg, prof, trig = mk_trigger(t_mod, reg_cls, cooldown_s=3600.0)
        trig.arm("slow_step").join(timeout=10)
        cooled = trig.arm("slow_step")
        reg2, prof2, trig2 = mk_trigger(t_mod, reg_cls, cooldown_s=0.0,
                                        max_captures_per_h=2)
        for _ in range(2):
            trig2.arm("recompile").join(timeout=10)
        capped = trig2.arm("recompile")
        return (cooled is None, skipped(reg, "cooldown"), capped is None,
                skipped(reg2, "cap"), len(prof2.starts))
    out = both(run)
    assert out["port"] == out["jax"] == (True, 1, True, 1, 2)


def test_trigger_anomaly_listener_arms_and_page_enrichment_falls_back(
        monkeypatch):
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")

    class FakeAlert:
        name = "StepAnomalyRatio"
        severity = "page"

    def run(_h, t_mod, reg_cls):
        reg, prof, trig = mk_trigger(t_mod, reg_cls, cooldown_s=3600.0)
        trig._attribute = lambda logdir, t: {
            "culprit_kernels": [{"kernel": "dot.3", "why": "test"}]}
        trig.on_anomaly({"step": 9, "t": time.time()}, "slow_step")
        trig.on_record({"step": 10})
        trig.on_record({"step": 11})
        assert trig.wait_idle(10)
        FakeAlert.severity = "page"
        ann = trig.enrich_alert(FakeAlert())
        FakeAlert.severity = "warn"
        return (ann["culprit_kernels"][0]["kernel"],
                ann["attribution_trigger"], trig.enrich_alert(FakeAlert()))
    out = both(run)
    assert out["port"] == out["jax"] == ("dot.3", "slow_step", None)


# -- the port's torch backend ------------------------------------------------

def _wait_started(trig):
    """Until the capture thread's session runs (records before that count
    toward the window but trace nothing)."""
    deadline = time.time() + 10
    while trig.profiler._session is None and time.time() < deadline:
        time.sleep(0.01)
    assert trig.profiler._session is not None


def _tiny_step():
    a = torch.randn(64, 64)
    return lambda: (a @ a).relu_().sum()


def test_torch_backend_captures_from_its_own_thread(monkeypatch, tmp_path):
    """A real torch.profiler capture armed by an anomaly: it starts on the
    trigger's thread while this thread steps, closes on two step records,
    and attributes the capture (on the CPU the table's rows are host ops)
    with no golden: the culprits are the capture's heaviest rows."""
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")
    monkeypatch.setenv("PDTPU_GOLDEN_DIR", str(tmp_path / "golden"))
    reg = TRegistry()
    trig = ttrigger.ProfileTrigger(window_steps=2, window_s=20.0,
                                   cooldown_s=0.0, registry=reg)
    step = _tiny_step()
    t = trig.arm("slow_step")
    assert t is not None
    from paddle_tpu_torch import profiler
    _wait_started(trig)
    assert profiler.busy()
    # the session is the process's one: a user start is refused meanwhile
    with pytest.raises(RuntimeError, match="already active"):
        profiler.start_profiler(log_dir=str(tmp_path / "user"))
    for i in range(3):
        step()
        trig.on_record({"step": i})
    assert trig.wait_idle(20)
    assert not profiler.busy()
    att = trig.last_attribution()
    assert "error" not in att, att
    assert att["trigger"] == "slow_step"
    assert att["culprit_kernels"]
    assert all("top by time" in c["why"] for c in att["culprit_kernels"])
    assert reg.counter("profiler/captures", trigger="slow_step").value == 1


def test_torch_backend_busy_while_a_user_session_runs(monkeypatch, tmp_path):
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")
    from paddle_tpu_torch import profiler

    reg = TRegistry()
    trig = ttrigger.ProfileTrigger(window_steps=1, window_s=0.5,
                                   cooldown_s=0.0, registry=reg)
    with profiler.profiler(profile_path=str(tmp_path / "p")):
        assert trig.arm("slow_step") is None   # skipped, not raised
    assert reg.counter("profiler/skipped", reason="busy").value == 1
    assert trig.arm("slow_step") is not None   # free again
    trig.on_record({"step": 1})
    assert trig.wait_idle(10)


def test_golden_round_trip_and_diff_names_movers(monkeypatch, tmp_path):
    """record_golden on a healthy step, then a capture whose step also runs
    an extra op: the attribution's culprits name it as new vs golden."""
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")
    monkeypatch.setenv("PDTPU_GOLDEN_DIR", str(tmp_path / "golden"))
    a = torch.randn(512, 512)    # rows above the 0.5 ms table cutoff
    path = ttrigger.record_golden(lambda: (a @ a).sum(), steps=2)
    assert os.path.exists(path) and "cpu" in os.path.basename(path)
    golden = ttrigger.load_golden()
    assert golden["table"]["kernels"]
    reg = TRegistry()
    trig = ttrigger.ProfileTrigger(window_steps=2, window_s=20.0,
                                   cooldown_s=0.0, registry=reg)
    trig.arm("slow_step")
    _wait_started(trig)
    for i in range(3):
        (a @ a).sum()
        torch.linalg.qr(a)            # the regression: a new op
        trig.on_record({"step": i})
    assert trig.wait_idle(20)
    att = trig.last_attribution()
    assert "trace_diff" in att, att
    names = [c["kernel"] for c in att["culprit_kernels"]]
    assert any("qr" in n or "geqrf" in n or "householder" in n
               for n in names), names
    np.testing.assert_equal(
        reg.counter("profiler/captures", trigger="slow_step").value, 1)


def test_capture_window_counts_only_steps_begun_inside_the_trace(
        monkeypatch):
    """A step under way when the capture thread started the profiler does
    not count toward the window; the window's span (its steps' wall
    times) then cuts the trace's events and the declared launches."""
    monkeypatch.setenv("PDTPU_PROFILE_ON_ANOMALY", "1")
    reg, prof, trig = mk_trigger(ttrigger, TRegistry, window_s=30.0)
    t = trig.arm("slow_step")
    deadline = time.time() + 5
    while trig._t_started is None and time.time() < deadline:
        time.sleep(0.01)
    t0 = trig._t_started
    # began before the trace: skipped; then two whole steps
    trig.on_record({"t": round(t0 + 0.05, 3), "wall_ms": 100.0})
    trig.on_record({"t": round(t0 + 0.20, 3), "wall_ms": 100.0})
    assert trig._steps_seen == 1
    trig.on_record({"t": round(t0 + 0.35, 3), "wall_ms": 100.0})
    t.join(timeout=10)
    assert not t.is_alive()
    base = 1_000_000_000 * 1_000_000_000   # ns
    tr = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "ts": 0},
        {"ph": "X", "name": "in", "ts": 1_000_500.0, "dur": 1},
        {"ph": "X", "name": "out", "ts": 999_000.0, "dur": 1}]}
    cut = ttrigger._within(tr, 1e9 + 1.0, 1e9 + 1.001)
    assert [e["name"] for e in cut["traceEvents"]] == ["process_name", "in"]
    assert ttrigger._within({"traceEvents": []}, 0, 1) == {"traceEvents": []}
