"""SLO engine and alert lifecycle on the port, on the CPU: twins of
tests/test_slo_alerts.py. Each engine and state-machine case runs the same
injected-clock scenario through the JAX package's modules and the port's
and holds the outcomes (alert states, labels, annotations, recorded
series) equal; the operator surfaces (/alerts, /healthz, the ops console,
``ps_admin fleet --watch``), the publisher's meta subscription, the
predictor's staleness audit and the registry's exposition satellites are
the JAX test's checks on the port."""
import json
import os
import time

import numpy as np
import pytest
import torch

from _torch_twin import cpu_config, fresh_observability
from paddle_tpu.observability import alerts as jalerts
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.observability import slo as jslo
from paddle_tpu_torch.observability import alerts as talerts
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability.alerts import (AlertManager,
                                                   install_alert_manager)
from paddle_tpu_torch.observability.http import run_health_checks
from paddle_tpu_torch.observability.registry import (Registry, get_registry,
                                                     render_prometheus)

torch.set_num_threads(1)

PKGS = {"jax": (jslo, jalerts, jregistry.Registry),
        "port": (tslo, talerts, tregistry.Registry)}


@pytest.fixture(autouse=True)
def _clean():
    yield from fresh_observability()


def g(name, value, **labels):
    return {"name": name, "type": "gauge", "labels": labels,
            "value": float(value)}


def c(name, value, **labels):
    return {"name": name, "type": "counter", "labels": labels,
            "value": float(value)}


def summ(name, field_vals, **labels):
    return {"name": name, "type": "summary", "labels": labels,
            "summary": dict(field_vals)}


def both(fn):
    out = {k: fn(*mods) for k, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def mk(slo, al, reg_cls, specs_fn, **kw):
    reg = reg_cls()
    am = al.AlertManager(registry=reg, **kw.pop("am", {}))
    eng = slo.SloEngine(specs_fn(slo), alert_manager=am, registry=reg, **kw)
    return reg, am, eng


def view(am):
    """Alerts as comparable tuples."""
    return sorted((a.name, a.severity, a.state,
                   tuple(sorted(a.labels.items())),
                   json.dumps(a.annotations, sort_keys=True, default=str))
                  for a in am.alerts())


def states(am, name):
    return {a.state for a in am.alerts() if a.name == name}


def series_of(reg, *names):
    return sorted(json.dumps(s, sort_keys=True) for s in reg.series()
                  if s["name"] in names)


# -- SloSpec -------------------------------------------------------------------

def test_slospec_validation():
    def run(slo, _a, _r):
        for kw, match in ((dict(mode="between"), "mode"),
                          (dict(mode="ratio"), "total_metric"),
                          (dict(mode="min_above"), "bound"),
                          (dict(mode="min_above", bound=1.0, objective=1.0),
                           "objective"),
                          (dict(mode="min_above", bound=1.0,
                                missing="page_me"), "missing")):
            mode = kw.pop("mode")
            with pytest.raises(ValueError, match=match):
                slo.SloSpec("X", "m", mode, **kw)
        with pytest.raises(ValueError, match="duplicate"):
            slo.SloEngine([slo.SloSpec.floor("X", "m", 1.0),
                           slo.SloSpec.ceiling("X", "m", 2.0)])
        s = slo.SloSpec.freshness("F", "clock", 2000.0)
        return s.mode, s.bound, round(s.budget, 12)
    assert both(run) == ("age_below", 2.0, 0.001)


def test_default_slos_cover_the_stack():
    def run(slo, _a, _r):
        specs = {s.name: s for s in slo.default_slos()}
        withf = {s.name: s for s in slo.default_slos(step_time_ms=40.0,
                                                     mfu_floor=0.3)}
        return (sorted(specs), specs["StepAnomalyRatio"].total_metric,
                specs["ServingTenantLatency"].field,
                withf["TrainStepTime"].bound, withf["MfuFloor"].mode,
                withf["MfuFloor"].metric)
    out = both(run)
    assert out[0] == sorted({
        "PsShardAvailability", "PsPullLatency", "ServingAvailability",
        "ServingTenantLatency", "ServingTenantAvailability",
        "DeltaStaleness", "StepAnomalyRatio"})
    assert out[3:] == (40.0, "min_above", "perf/mfu")


# -- rule evaluation -------------------------------------------------------------

def test_floor_fires_per_group_and_names_offender():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls, lambda s: [s.SloSpec.floor(
            "Avail", "up", 1.0, group_by="shard", objective=0.999)])
        for t in range(3):
            eng.observe([g("up", 1, shard="0"), g("up", 1, shard="1")],
                        now=float(t))
        eng.observe([g("up", 1, shard="0"), g("up", 0, shard="1")], now=3.0)
        return view(am), [a.labels for a in am.firing(severity="page")]
    out = both(run)
    assert out[1] == [{"slo": "Avail", "shard": "1"}]
    assert {a[1] for a in out[0] if a[2] == "firing"} == {"page", "warn"}


def test_ceiling_reads_summary_percentile():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls, lambda s: [s.SloSpec.latency(
            "Pull", "pull_ms", 100.0, group_by="shard")])
        eng.observe([summ("pull_ms", {"p99": 60.0, "p50": 5.0}, shard="0")],
                    now=0.0)
        quiet = view(am)
        eng.observe([summ("pull_ms", {"p99": 400.0, "p50": 5.0}, shard="0")],
                    now=1.0)
        (a,) = am.firing(severity="page")
        return quiet, a.labels, a.annotations["value"]
    assert both(run) == ([], {"slo": "Pull", "shard": "0"}, 400.0)


def test_age_below_freshness_clock():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls, lambda s: [s.SloSpec.freshness(
            "Stale", "clock", 1200.0, group_by="table")])
        w = 1_000_000.0
        eng.observe([g("clock", w - 0.4, table="tb")], now=0.0, now_wall=w)
        quiet = view(am)
        eng.observe([g("clock", w - 0.4, table="tb")], now=5.0,
                    now_wall=w + 4.0)
        (a,) = am.firing(severity="page")
        return quiet, a.labels, a.annotations["value"] > 1.2
    assert both(run) == ([], {"slo": "Stale", "table": "tb"}, True)


def test_ratio_mode_deltas_weights_and_counter_reset():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls, lambda s: [s.SloSpec.ratio(
            "Avail", "errs", "reqs", objective=0.999)])
        outs = [eng.observe([c("errs", 0), c("reqs", 100)], now=0.0)]
        outs.append(eng.observe([c("errs", 10), c("reqs", 200)], now=1.0))
        (a,) = am.firing(severity="page")
        outs.append(eng.observe([c("errs", 0), c("reqs", 5)], now=2.0))
        eng.observe([c("errs", 0), c("reqs", 5)], now=3.0)
        return json.dumps(outs, sort_keys=True, default=str), a.value
    outs, value = both(run)
    outs = json.loads(outs)
    assert outs[0]["Avail"] == {}
    assert outs[1]["Avail"][""]["bad"] == pytest.approx(0.1)
    assert outs[2]["Avail"][""]["bad"] == pytest.approx(0.1)
    assert value == pytest.approx(100.0)


def test_recording_gauges_use_logical_window_labels():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls,
                          lambda s: [s.SloSpec.floor("Avail", "up", 1.0)],
                          window_scale=1.0 / 720.0)
        eng.observe([g("up", 0)], now=0.0)
        return (reg.gauge("slo/bad_fraction", slo="Avail").value,
                [reg.gauge("slo/burn_rate", slo="Avail", window=w).value
                 for w in ("1h", "5m", "6h", "30m")],
                [slo._wlabel(w) for _, lw, sw, _ in slo.BURN_RATE_WINDOWS
                 for w in (lw, sw)])
    bad, burns, labels = both(run)
    assert bad == 1.0 and burns == pytest.approx([1000.0] * 4)
    assert labels == ["1h", "5m", "6h", "30m"]


def test_vanished_group_drains_resolves_and_cleans_gauges():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls, lambda s: [s.SloSpec.floor(
            "Avail", "up", 1.0, group_by="shard")],
            window_scale=1.0 / 3600.0)
        seen = []
        eng.observe([g("up", 0, shard="9")], now=0.0)
        seen.append(states(am, "Avail"))
        for now in (0.05, 1.0, 10.0):
            eng.observe([], now=now)
            seen.append((states(am, "Avail"),
                         bool([s for s in reg.series()
                               if s["name"] == "slo/burn_rate"])))
        return seen
    seen = both(run)
    assert seen[0] == {"firing"}
    assert seen[1][0] == {"firing"}
    assert seen[2] == ({"resolved"}, True)
    assert seen[3] == ({"resolved"}, False)


def test_missing_bad_counts_silent_group_as_out_of_slo():
    def run(slo, al, reg_cls):
        reg, am, eng = mk(slo, al, reg_cls, lambda s: [s.SloSpec.floor(
            "Avail", "up", 1.0, group_by="shard", missing="bad")])
        eng.observe([g("up", 1, shard="0")], now=0.0)
        quiet = view(am)
        eng.observe([], now=1.0)
        return quiet, [a.labels for a in am.firing(severity="page")]
    assert both(run) == ([], [{"slo": "Avail", "shard": "0"}])


# -- alert state machine -----------------------------------------------------------

def test_for_s_pending_then_firing_and_silent_pending_clear():
    def run(_s, al, reg_cls):
        reg = reg_cls()
        events = []
        am = al.AlertManager(for_s=5.0, registry=reg, sinks=[events.append])
        seen = []
        for now in (0.0, 3.0, 6.0):
            am.update("A", True, now=now)
            seen.append(states(am, "A"))
        am.update("B", True, now=10.0)
        am.update("B", False, now=11.0)
        seen.append(states(am, "B"))
        return (seen, [e["event"] for e in events],
                series_of(reg, "ALERTS"))
    seen, events, series = both(run)
    assert seen == [{"pending"}, {"pending"}, {"firing"}, set()]
    assert events == ["firing"]
    assert all('"B"' not in s for s in series)


def test_resolve_refire_and_hold_pruning():
    def run(_s, al, reg_cls):
        reg = reg_cls()
        events = []
        am = al.AlertManager(for_s=0.0, resolved_hold_s=10.0, registry=reg,
                             sinks=[events.append])
        kw = dict(severity="page", labels={"shard": "1"})
        am.update("A", True, now=0.0, **kw)
        am.update("A", False, now=1.0, **kw)
        s1 = states(am, "A")
        am.update("A", True, now=2.0, **kw)
        s2 = states(am, "A")
        am.update("A", False, now=3.0, **kw)
        am.update("other", False, now=20.0)
        return (s1, s2, [e["event"] for e in events][:2], view(am),
                series_of(reg, "ALERTS"))
    s1, s2, ev, alerts, series = both(run)
    assert (s1, s2, ev) == ({"resolved"}, {"firing"}, ["firing", "resolved"])
    assert alerts == [] and series == []


def test_alerts_series_follows_state():
    def run(_s, al, reg_cls):
        reg = reg_cls()
        am = al.AlertManager(for_s=5.0, registry=reg)
        out = []
        for active, now in ((True, 0.0), (True, 6.0), (False, 7.0)):
            am.update("A", active, now=now)
            out.append(sorted(s["labels"]["alertstate"] for s in reg.series()
                              if s["name"] == "ALERTS"))
        (s,) = [s for s in reg.series() if s["name"] == "ALERTS"]
        return out, s["labels"]["alertname"], s["labels"]["severity"]
    assert both(run) == ([["pending"], ["firing"], ["resolved"]], "A",
                         "page")


def test_sinks_file_callback_and_error_isolation(tmp_path):
    def run(_s, al, reg_cls):
        reg = reg_cls()
        path = tmp_path / f"{al.__name__}.jsonl"
        seen = []

        def sick(event):
            raise RuntimeError("sink down")

        am = al.AlertManager(registry=reg, sinks=[al.FileSink(str(path)),
                                                  sick, seen.append])
        am.update("A", True, labels={"shard": "2"}, value=99.0, now=0.0)
        am.update("A", False, labels={"shard": "2"}, now=1.0)
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        return ([(ln["event"], ln["labels"], ln.get("value"))
                 for ln in lines], [e["event"] for e in seen],
                reg.counter("alerts/sink_errors").value)
    lines, seen, errs = both(run)
    assert lines[0] == ("firing", {"shard": "2"}, 99.0)
    assert [ln[0] for ln in lines] == seen == ["firing", "resolved"]
    assert errs == 2.0


def test_page_fire_writes_flight_dump_warn_does_not(tmp_path, monkeypatch):
    monkeypatch.setenv("PDTPU_FLIGHT_DIR", str(tmp_path))
    events = []
    am = AlertManager(registry=Registry(), sinks=[events.append])
    am.update("W", True, severity="warn", now=0.0)
    am.update("P", True, severity="page", labels={"shard": "3"},
              value=500.0, now=0.0)
    by_name = {a.name: a for a in am.firing()}
    assert by_name["W"].dump_path is None
    dump_path = by_name["P"].dump_path
    assert dump_path and os.path.exists(dump_path)
    dump = json.loads(open(dump_path).read())
    assert dump["exception"]["type"] == "AlertFiringError"
    assert dump["context"]["alert"] == "P"
    assert dump["context"]["labels"] == {"shard": "3"}
    assert dump["context"]["value"] == 500.0
    (pev,) = [e for e in events if e["name"] == "P"]
    assert pev["dump_path"] == dump_path


def test_health_check_and_process_install():
    am = AlertManager(registry=Registry())
    assert am.health_check() == "ok"
    am.update("W", True, severity="warn", now=0.0)
    status, detail = am.health_check()
    assert status == "degraded" and "W" in detail
    am.update("P", True, severity="page", now=0.0)
    status, detail = am.health_check()
    assert status == "failing" and "P" in detail
    assert talerts.get_alert_manager() is None
    try:
        install_alert_manager(am)
        assert talerts.get_alert_manager() is am
        overall, checks = run_health_checks()
        assert overall == "failing"
        assert checks["alerts"]["status"] == "failing"
    finally:
        install_alert_manager(None)
    assert "alerts" not in run_health_checks()[1]


def _http_get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_alerts_endpoint_and_healthz():
    from paddle_tpu_torch.observability.http import IntrospectionServer

    srv = IntrospectionServer(port=0)
    srv.start()
    am = AlertManager(registry=Registry())
    try:
        code, body = _http_get(srv.url + "/alerts")
        assert code == 404 and "install_alert_manager" in body
        install_alert_manager(am)
        am.update("P", True, severity="page", labels={"shard": "0"},
                  now=0.0)
        code, body = _http_get(srv.url + "/alerts")
        assert code == 200
        doc = json.loads(body)
        assert doc["firing"] == 1
        (a,) = doc["alerts"]
        assert (a["name"], a["state"]) == ("P", "firing")
        assert a["labels"] == {"shard": "0"}
        code, body = _http_get(srv.url + "/healthz")
        assert code == 503
        assert json.loads(body)["checks"]["alerts"]["status"] == "failing"
        am.update("P", False, severity="page", labels={"shard": "0"},
                  now=1.0)
        code, _ = _http_get(srv.url + "/healthz")
        assert code == 200
    finally:
        install_alert_manager(None)
        srv.stop()


# -- staleness audit plumbing ---------------------------------------------------------

class _StubTable:
    name = "tb"

    def __init__(self):
        self.listeners = []

    def add_push_listener(self, fn):
        self.listeners.append(fn)

    def remove_push_listener(self, fn):
        self.listeners.remove(fn)


def test_publisher_meta_subscription_contract():
    from paddle_tpu_torch.streaming import DeltaPublisher

    pub = DeltaPublisher(_StubTable(), staleness_s=60.0, start=False)
    legacy, metaed = [], []
    pub.subscribe(lambda name, uids, rows: legacy.append((name, uids)))
    pub.subscribe(lambda name, uids, rows, meta: metaed.append(
        (uids, meta)), meta=True)
    r = np.arange(4, dtype=np.uint16).reshape(2, 2)
    pub._on_push(np.array([7, 3]), r)
    time.sleep(0.01)
    pub._on_push(np.array([7]), r[:1] + 1)
    assert pub.flush() == 2
    (name, uids) = legacy[0]
    assert name == "tb" and uids.tolist() == [3, 7]
    uids, meta = metaed[0]
    assert meta["seq"] == 1
    assert meta["enqueue_t"].shape == (2,)
    i7 = uids.tolist().index(7)
    assert meta["enqueue_t"][i7] <= meta["published_t"]
    assert pub.flush() == 0
    assert len(legacy) == 1 and len(metaed) == 1
    pub._on_push(np.array([1]), r[:1])
    assert pub.flush() == 1
    assert metaed[1][1]["seq"] == 2


def test_predictor_audit_closes_e2e_staleness(tmp_path):
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ps import (EmbeddingShard, InProcessClient,
                                     RangeSpec, ShardedTable)
    from _torch_ps_twin import CAP
    from test_torch_streaming import _save_online_model

    vocab = 60
    table = ShardedTable(
        "tb", RangeSpec.even(vocab, 1),
        [InProcessClient([EmbeddingShard("tb", 0, vocab)])])
    _save_online_model(str(tmp_path / "m"), CAP)
    base = inference.create_predictor(cpu_config(str(tmp_path / "m")))
    ps = inference.PsLookupPredictor(
        base, [inference.PsLookupBinding("tb", table, ["ids"])],
        cache_rows_per_table=vocab)
    reg = get_registry()
    reg.remove_matching("staleness/e2e_ms")
    reg.remove_matching("staleness/last_visible_ts")
    assert ps.staleness_e2e_percentiles() == {"p50": None, "p99": None,
                                              "max": None}
    uids = np.array([1, 5], np.int64)
    rows = np.zeros((2, 128), np.uint16)
    ps.apply_delta("tb", uids, rows)
    assert not [s for s in reg.series()
                if s["name"] == "staleness/last_visible_ts"]
    ps.apply_delta("tb", uids, rows, meta={
        "seq": 1, "published_t": time.monotonic(),
        "enqueue_t": np.full(2, time.monotonic() - 0.05)})
    pct = ps.staleness_e2e_percentiles()
    assert pct["p50"] is not None and 40.0 < pct["max"] < 5000.0
    (h,) = [s for s in reg.series() if s["name"] == "staleness/e2e_ms"]
    assert h["labels"]["table"] == "tb"
    assert h["summary"]["count"] == 2
    (clk,) = [s for s in reg.series()
              if s["name"] == "staleness/last_visible_ts"]
    assert 0.0 <= time.time() - clk["value"] < 60.0


# -- exposition satellites -------------------------------------------------------------

def test_help_lines_for_described_series_only():
    texts = {}
    for key, (_s, _a, reg_cls) in PKGS.items():
        reg = reg_cls()
        reg_cls.describe("helped/x", "counted\nthings \\ escaped")
        reg.counter("helped/x").inc()
        reg.counter("bare/y").inc()
        mod = jregistry if key == "jax" else tregistry
        texts[key] = mod.render_prometheus(reg.series())
        assert reg_cls.help_for("helped/x").startswith("counted")
        assert reg_cls.help_for("bare/y") is None
    text = texts["port"]
    assert text == texts["jax"]
    assert ("# HELP helped_x counted\\nthings \\\\ escaped"
            in text.splitlines())
    assert text.index("# HELP helped_x") < text.index("# TYPE helped_x")
    assert "# HELP bare_y" not in text


def test_registry_remove_and_remove_matching():
    reg = Registry()
    reg.gauge("m", shard="0").set(1)
    reg.gauge("m", shard="1").set(2)
    reg.counter("m", shard="2").inc()
    assert reg.remove("m", shard="0") is True
    assert reg.remove("m", shard="0") is False
    assert reg.remove("m", shard="nope") is False
    assert {s["labels"]["shard"] for s in reg.series()
            if s["name"] == "m"} == {"1", "2"}
    assert reg.remove_matching("m") == 2
    assert reg.series() == []
    assert render_prometheus([]) == jregistry.render_prometheus([])


# -- operator surfaces ---------------------------------------------------------------

FRAME = {
    "reachable": True,
    "alerts": {"alerts": [
        {"name": "PsShardAvailability", "severity": "page",
         "state": "firing", "value": 500.0,
         "labels": {"slo": "PsShardAvailability", "shard": "1"}},
        {"name": "DeltaStaleness", "severity": "warn",
         "state": "resolved", "labels": {}}],
        "firing": 1, "pending": 0, "resolved": 1},
    "fleet": {"targets": [
        {"process": "pserver:1", "role": "pserver", "shard": 1,
         "ok": False, "scrape_ms": 0.4, "error": "refused", "series": []},
        {"process": "w0", "role": "worker", "shard": None, "ok": True,
         "scrape_ms": 1.2, "series": [
             {"name": "serving/queue_depth", "type": "gauge", "value": 7.0},
             {"name": "ps/shard_pull_ms", "type": "summary",
              "summary": {"p99": 12.5}}]}],
        "signals": {"queue_depth": {"w0": 7.0}}},
    "notes": []}


def test_ops_console_render_frames():
    from paddle_tpu.tools import ops_console as jconsole
    from paddle_tpu_torch.tools import ops_console

    down = {"reachable": False, "notes": ["/fleet: URLError: refused"]}
    empty = {"reachable": True, "alerts": None, "fleet": None,
             "notes": ["/alerts: not wired"]}
    for frame in (down, FRAME, empty):
        for color in (False, True):
            out = ops_console.render(frame, color=color)
            jout = jconsole.render(frame, color=color)
            assert out.replace("paddle_tpu_torch", "paddle_tpu") == jout
    assert "COORDINATOR UNREACHABLE" in ops_console.render(down, color=False)
    out = ops_console.render(FRAME, color=False)
    assert "1 firing / 0 pending / 1 resolved" in out
    assert "[page] PsShardAvailability{shard=1} firing  burn=500.0" in out
    assert "DOWN" in out and "refused" in out and "queue_depth" in out
    assert "\x1b[31;1m" in ops_console.render(FRAME, color=True)
    out = ops_console.render(empty, color=False)
    assert "no AlertManager" in out and "not wired" in out


def test_ops_console_once_exit_codes(capsys):
    from paddle_tpu_torch.observability.http import IntrospectionServer
    from paddle_tpu_torch.tools import ops_console

    srv = IntrospectionServer(port=0)
    srv.start()
    am = AlertManager(registry=Registry())
    try:
        assert ops_console.main([srv.url, "--once", "--no-color"]) == 0
        assert "no AlertManager" in capsys.readouterr().out
        install_alert_manager(am)
        am.update("P", True, severity="page", now=0.0)
        assert ops_console.main([srv.url, "--once", "--no-color"]) == 1
        assert "firing" in capsys.readouterr().out
        assert ops_console.main(["http://127.0.0.1:9", "--once",
                                 "--no-color", "--timeout", "0.5"]) == 2
        with pytest.raises(SystemExit):
            ops_console.main([srv.url, "--interval", "0"])
    finally:
        install_alert_manager(None)
        srv.stop()


def test_ps_admin_fleet_watch(capsys, monkeypatch):
    from paddle_tpu_torch.ps import EmbeddingShard, ShardServer
    from paddle_tpu_torch.tools import ps_admin

    srv = ShardServer([EmbeddingShard("tb", 0, 8)]).serve_in_thread()
    frames = []

    def sleep_twice(_s):
        frames.append(capsys.readouterr().out)
        if len(frames) >= 2:
            raise KeyboardInterrupt
    monkeypatch.setattr(ps_admin.time, "sleep", sleep_twice)
    try:
        rc = ps_admin.main(["fleet", "--endpoints", srv.endpoint,
                            "--watch", "0.01"])
        assert rc == 0
        assert len(frames) == 2
        for f in frames:
            assert "\x1b[2J" in f and "pserver" in f
        with pytest.raises(SystemExit):
            ps_admin.main(["fleet", "--endpoints", srv.endpoint,
                           "--watch", "-1"])
    finally:
        srv.stop()


def test_ps_admin_history_reads_the_endpoint(capsys):
    """The ``history`` subcommand against a live /history: 1 without a
    MetricsHistory, then one row a series with a sparkline."""
    from paddle_tpu_torch.observability import history
    from paddle_tpu_torch.observability.http import IntrospectionServer
    from paddle_tpu_torch.tools import ps_admin

    srv = IntrospectionServer(port=0)
    srv.start()
    try:
        assert ps_admin.main(["history", "--worker", srv.url]) == 1
        h = history.MetricsHistory(registry=Registry())
        history.install_history(h)
        now = time.time()
        for i in range(6):
            h.observe_sweep({"t": now - 5 + i, "targets": [{
                "ok": True, "process": "w0", "role": "worker",
                "series": [g("autoscale/queue_depth", i)]}]})
        capsys.readouterr()
        assert ps_admin.main(["history", "--worker", srv.url,
                              "--prefix", "autoscale/"]) == 0
        out = capsys.readouterr().out
        assert "autoscale/queue_depth" in out and "1 series" in out
        assert ps_admin.main(["history", "--worker", srv.url,
                              "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["stats"]["sweeps"] == 6
    finally:
        history.install_history(None)
        srv.stop()
