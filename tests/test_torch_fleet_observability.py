"""Cross-process observability over the port's PS socket transport: twins of
the socket cases of ``tests/test_fleet_observability.py``.

One training step or one pull is ONE distributed trace: the client span
in the caller, the server span in the pserver (a port runner subprocess or
an in-thread ``ShardServer``), linked by trace_id/parent_id in the frame
header, and a torn-frame retry stays in the same trace with a fresh span.
A ``FederatedScraper`` sweep reaches a pserver through the transport's
``metrics`` op, ``/fleet`` serves the federated document, and
``ps_admin fleet`` renders it. The port's host tracer starts off, so each
case turns it on (the runner takes ``--trace``). The autouse fixture
empties the port's registry of what the serving tier and earlier scrapes
left (``serving/``, ``fleet/``, ``staleness/``, ``autoscale/`` series,
the health checks); the series that modules hold (``ps/``, ``steps/``)
stay, and the straggler count is read relative to them, so the
federated numbers do not depend on earlier tests. A JAX client reads a port pserver's trace
and metrics ops like a port client does."""
import json
import subprocess
import sys

import numpy as np
import pytest

from _torch_ps_twin import RUNNER, fast_retry
from _torch_twin import alarm_timeout, fresh_observability
from paddle_tpu.ps import SocketClient as JSocketClient
from paddle_tpu_torch.observability import context as trace_ctx
from paddle_tpu_torch.observability.federate import (FederatedScraper,
                                                     ScrapeTarget,
                                                     install_scraper)
from paddle_tpu_torch.observability.registry import get_registry
from paddle_tpu_torch.observability.tracer import get_tracer, start_trace
from paddle_tpu_torch.ps import (EmbeddingShard, RangeSpec, ShardServer,
                                 ShardedTable, SocketClient, make_shards)

from test_observability import _http_get
from test_torch_ps_faults import _TearingProxy

V = 64


@pytest.fixture(autouse=True)
def _fresh_observability():
    def clear():
        reg = get_registry()
        for name in {s["name"] for s in reg.series(deep=False)}:
            if name.startswith("autoscale/"):
                reg.remove_matching(name)
    clear()
    yield from fresh_observability()
    clear()


@pytest.fixture(autouse=True)
def _tracer_on():
    tracer = get_tracer()
    was = tracer.enabled
    tracer.enabled = True
    tracer.clear()
    yield
    tracer.enabled = was
    tracer.clear()


@pytest.fixture(autouse=True)
def _time_limit():
    yield from alarm_timeout(120)


def _events(trace=None):
    """Non-metadata events of a chrome trace (default: local tracer)."""
    trace = trace or get_tracer().export_chrome_trace()
    return [e for e in trace["traceEvents"] if e.get("ph") != "M"]


def _spans_named(events, name):
    return [e for e in events if e.get("name") == name
            and e.get("ph") == "B"]


# -- trace propagation across real sockets ---------------------------------

def test_ps_trace_propagates_to_subprocess_shard_server():
    """A pull against a port pserver subprocess: the server-side span
    comes back (trace_export op) carrying the client's trace_id and the
    client RPC span's id as parent. A JAX client reads the same op."""
    p = subprocess.Popen([sys.executable, RUNNER, "--port", "0", "--trace",
                          "--table", f"tb:0:{V}"],
                         stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    try:
        ep = p.stdout.readline().strip()
        assert ep, "pserver runner died at boot"
        c = SocketClient(ep, retries=0)
        try:
            with start_trace("test/req"):
                root = trace_ctx.current()
                c.pull("tb", np.array([1, 5, V - 1], dtype=np.int64))
            remote = c.trace_export()
        finally:
            c.close()
        (cli,) = [e for e in _spans_named(_events(), "ps/rpc/pull")
                  if (e.get("args") or {}).get("trace_id")
                  == root.trace_id]
        assert cli["args"]["rpc"] == "client"
        assert cli["args"]["endpoint"] == ep
        srv_spans = [e for e in _spans_named(_events(remote), "ps/pull")
                     if (e.get("args") or {}).get("trace_id")
                     == root.trace_id]
        assert len(srv_spans) == 1
        assert srv_spans[0]["args"]["parent_id"] == cli["args"]["span_id"]
        assert srv_spans[0]["args"]["rpc"] == "server"
        assert srv_spans[0]["pid"] != cli["pid"]
        jc = JSocketClient(ep, retries=0)
        try:
            assert _spans_named(_events(jc.trace_export()), "ps/pull")
            assert any(s["name"] == "ps/server_requests"
                       for s in jc.metrics())
        finally:
            jc.close()
    finally:
        p.kill()
        p.wait(timeout=30)
        p.stdout.close()


def test_torn_frame_retry_keeps_trace_id_fresh_span(monkeypatch):
    """A torn reply forces a re-send: the retry attempt is a SECOND client
    span in the SAME trace — fresh span_id, `retry: 1` tag."""
    fast_retry(monkeypatch)
    srv = ShardServer([EmbeddingShard("tb", 0, V)]).serve_in_thread()
    proxy = _TearingProxy(srv.endpoint)
    proxy.start()
    c = SocketClient(proxy.endpoint)
    try:
        with start_trace("test/torn"):
            root = trace_ctx.current()
            c.pull("tb", np.array([1, 2], dtype=np.int64))
        assert proxy.tears_left == 0
        attempts = [e for e in _spans_named(_events(), "ps/rpc/pull")
                    if (e.get("args") or {}).get("trace_id")
                    == root.trace_id]
        assert len(attempts) == 2
        first, second = sorted(attempts, key=lambda e: e["ts"])
        assert "retry" not in first["args"]
        assert second["args"]["retry"] == 1
        assert second["args"]["span_id"] != first["args"]["span_id"]
    finally:
        c.close()
        proxy.stop()
        srv.stop()


# -- federation ------------------------------------------------------------

def test_federated_scraper_merges_and_derives_signals():
    """One sweep over a pserver socket target, an in-process call target
    and a dead endpoint: per-target labels land in the doc, the dead
    target is recorded (not raised), and the autoscaler gauges distill
    out of the merged series."""
    srv = ShardServer([EmbeddingShard("tb", 0, V)]).serve_in_thread()
    # the in-thread pserver serves this process's registry: straggler
    # anomalies earlier tests recorded ride along in its series
    pre_anomalies = sum(
        float(s.get("value") or 0.0)
        for s in get_registry().series(deep=True)
        if s.get("name") == "steps/anomalies")
    # the stub's shard label is one no table of this process uses: a real
    # ps/shard_pull_ms{shard="0"} an earlier socket test left (its p99
    # may be seconds, from a recovery) would win the per-shard max
    stub = [{"name": "ps/shard_pull_ms", "type": "summary",
             "labels": {"shard": "900"},
             "summary": {"count": 4, "sum": 8.0, "p50": 2.0, "p95": 3.0,
                         "p99": 3.5}},
            {"name": "serving/queue_depth", "type": "gauge", "labels": {},
             "value": 7.0},
            {"name": "steps/anomalies", "type": "counter",
             "labels": {"reason": "slow_step"}, "value": 2}]
    try:
        # one request the server accounts before the scrape (the
        # `metrics` op is accounted after it answers)
        c = SocketClient(srv.endpoint, retries=0)
        assert c.ping()
        c.close()
        sc = FederatedScraper(
            [ScrapeTarget.ps(srv.endpoint, shard=0),
             ScrapeTarget.call(lambda: stub, name="w0", role="worker"),
             ScrapeTarget.ps("127.0.0.1:9", shard=1)])
        doc = sc.scrape_once()
        assert doc["ok"] is False  # port 9 refused
        by_name = {t["process"]: t for t in doc["targets"]}
        assert by_name["w0"]["ok"] and by_name["w0"]["role"] == "worker"
        ps_t = by_name[f"pserver:{srv.endpoint}"]
        assert ps_t["ok"] and ps_t["shard"] == 0
        assert any(s["name"] == "ps/server_requests"
                   for s in ps_t["series"])
        sig = doc["signals"]
        assert sig["ps_pull_p99_ms"]["900"] == 3.5
        assert sig["queue_depth"]["w0"] == 7.0
        assert sig["stragglers"] == 2.0 + pre_anomalies
        assert sig["targets_unreachable"] == 1
        reg = get_registry()
        assert reg.gauge("autoscale/ps_pull_p99_ms",
                         shard="900").value == 3.5
        assert reg.gauge("autoscale/queue_depth",
                         process="w0").value == 7.0
        assert reg.gauge("autoscale/targets_unreachable").value == 1.0
    finally:
        srv.stop()


@pytest.fixture()
def introspection():
    from paddle_tpu_torch.observability import http as ihttp
    s = ihttp.IntrospectionServer(port=0)
    s.start()
    yield s
    s.stop()


def test_fleet_endpoint_and_metrics_series(introspection):
    """/metrics/series is the structured scrape; /fleet 404s with no
    scraper, then serves the federated doc (503 while any target is
    down, 200 when all answer); federated text rides /metrics."""
    code, body = _http_get(introspection.url + "/metrics/series")
    assert code == 200
    series = json.loads(body)
    assert isinstance(series, list) and all("name" in s for s in series)

    code, _ = _http_get(introspection.url + "/fleet")
    assert code == 404
    srv = ShardServer([EmbeddingShard("tb", 0, V)]).serve_in_thread()
    sc = FederatedScraper([
        ScrapeTarget.ps(srv.endpoint, shard=0),
        ScrapeTarget.http(introspection.url, name="self", role="worker")])
    install_scraper(sc)
    try:
        code, body = _http_get(introspection.url + "/fleet")
        assert code == 200
        doc = json.loads(body)
        assert doc["ok"] is True
        assert {t["process"] for t in doc["targets"]} == {
            f"pserver:{srv.endpoint}", "self"}
        code, body = _http_get(introspection.url + "/metrics")
        assert code == 200
        assert f'process="pserver:{srv.endpoint}"' in body
        assert 'shard="0"' in body
        srv.stop()
        code, body = _http_get(introspection.url + "/fleet")
        assert code == 503
        assert json.loads(body)["ok"] is False
    finally:
        install_scraper(None)
        srv.stop()
    code, _ = _http_get(introspection.url + "/fleet")
    assert code == 404


def test_ps_admin_fleet_subcommand(capsys):
    """Operator surface: one table row per process, exit 0 when every
    scrape answered, 1 when any failed, --json emits the /fleet doc."""
    from paddle_tpu_torch.tools import ps_admin

    srv = ShardServer([EmbeddingShard("tb", 0, V)]).serve_in_thread()
    try:
        rc = ps_admin.main(["fleet", "--endpoints", srv.endpoint])
        out = capsys.readouterr().out
        assert rc == 0
        assert "pserver" in out and "autoscaler signals:" in out
        rc = ps_admin.main(["fleet", "--endpoints",
                            srv.endpoint + ",127.0.0.1:9", "--json"])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1 and doc["ok"] is False
        assert [t["ok"] for t in doc["targets"]] == [True, False]
        with pytest.raises(SystemExit):
            ps_admin.main(["fleet", "--endpoints", ""])
    finally:
        srv.stop()


# -- end to end: step-rooted PS trace --------------------------------------

def test_train_step_roots_one_trace_across_shard_pulls():
    """A step's trace spans its shard pulls: the socket RPCs run on pool
    threads and still join the step's trace (ShardedTable re-activates
    the caller's context on each job)."""
    spec = RangeSpec.even(V, 2)
    servers = [ShardServer([sh]).serve_in_thread()
               for sh in make_shards("tb", spec)]
    table = ShardedTable("tb", spec,
                         [SocketClient(s.endpoint) for s in servers])
    try:
        with start_trace("ps/train_step"):
            root = trace_ctx.current()
            table.pull(np.arange(V, dtype=np.int64))
        pulls = [e for e in _spans_named(_events(), "ps/rpc/pull")
                 if (e.get("args") or {}).get("trace_id")
                 == root.trace_id]
        assert len(pulls) == 2
        assert {e["args"]["endpoint"] for e in pulls} == {
            s.endpoint for s in servers}
    finally:
        table.close()
        for s in servers:
            s.stop()
