"""Twins of tests/test_observability.py's HTTP introspection tests on the
port, on the CPU: /metrics (Prometheus text), /metrics.json, /debug/steps,
/debug/flight, 404, /healthz aggregation and its 503, the process-wide
server's idempotence and its env switch, and the serving tier's health
checks. The exposition text of the same metrics is held to the JAX
package's renderer (equal); /alerts and /history answer 404 until an
alert manager / metrics history is installed (their 200s are in
test_torch_root_cause.py and test_torch_slo_alerts.py)."""
import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.observability import http as ihttp

from _torch_twin import cpu_config, fresh_observability, fresh_port_state
from test_observability import _http_get

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

IN_DIM = 5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture
def introspection():
    srv = ihttp.IntrospectionServer(port=0).start()
    yield srv
    srv.stop()


def test_http_metrics_endpoints(introspection):
    from paddle_tpu_torch.observability.steps import get_step_profiler

    get_step_profiler().record(1.0, program_id=7, sig="sg",
                               sample_env=False)
    code, body = _http_get(introspection.url + "/metrics")
    assert code == 200
    assert "# TYPE steps_total counter" in body
    assert "steps_wall_ms_count" in body
    code, body = _http_get(introspection.url + "/metrics.json")
    assert code == 200
    snap = json.loads(body)
    assert snap["steps/total"] >= 1
    code, body = _http_get(introspection.url + "/metrics/series")
    assert code == 200
    assert any(s["name"] == "steps/total" for s in json.loads(body))


def test_prometheus_text_matches_the_jax_renderer():
    """The same counters, gauges and histograms render to the same
    exposition text in both packages (names sanitized, labels escaped)."""
    from paddle_tpu.observability.registry import Registry as JRegistry
    from paddle_tpu_torch.observability.registry import Registry

    texts = []
    for reg in (JRegistry(), Registry()):
        reg.counter("serving/requests").inc(3)
        reg.gauge("queue depth", sig='x:f32["8"]\n').set(2.5)
        h = reg.histogram("serving/latency_ms", bucket="8")
        for v in (1.0, 2.0, 7.5):
            h.observe(v)
        texts.append(reg.prometheus_text())
    assert texts[0] == texts[1]
    assert "serving_requests 3" in texts[1]


def test_http_debug_and_404(introspection):
    from paddle_tpu_torch.observability.steps import get_step_profiler

    for _ in range(3):
        get_step_profiler().record(2.0, program_id=9, sig="dd",
                                   sample_env=False)
    code, body = _http_get(introspection.url + "/debug/steps?n=2")
    assert code == 200
    assert len(json.loads(body)["records"]) == 2
    code, body = _http_get(introspection.url + "/debug/flight")
    assert code == 200
    flight = json.loads(body)
    assert {"steps", "events", "last_dump_path", "last_dump"} <= set(flight)
    code, _ = _http_get(introspection.url + "/nope")
    assert code == 404
    # nothing installed: 404 naming the installer, as the JAX package's
    for path, hint in (("/alerts", "install_alert_manager"),
                       ("/history", "install_history")):
        code, body = _http_get(introspection.url + path)
        assert code == 404 and hint in body
    code, _ = _http_get(introspection.url + "/fleet")
    assert code == 404  # no FederatedScraper installed


def test_healthz_aggregation_and_503(introspection):
    code, body = _http_get(introspection.url + "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    ihttp.register_health_check("t/degraded", lambda: ("degraded", "warm"))
    try:
        code, body = _http_get(introspection.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "degraded"
        ihttp.register_health_check("t/dead", lambda: 1 / 0)
        code, body = _http_get(introspection.url + "/healthz")
        assert code == 503
        parsed = json.loads(body)
        assert parsed["status"] == "failing"
        assert "ZeroDivisionError" in parsed["checks"]["t/dead"]["detail"]
    finally:
        ihttp.unregister_health_check("t/degraded")
        ihttp.unregister_health_check("t/dead")


def test_serve_introspection_idempotent_and_env(monkeypatch):
    ihttp.stop_introspection()
    try:
        srv = ihttp.serve_introspection(0)
        assert srv.port > 0
        assert ihttp.serve_introspection(0) is srv
        monkeypatch.setenv("PDTPU_INTROSPECT_PORT", str(srv.port))
        assert ihttp.maybe_serve_from_env() is srv
        code, _ = _http_get(srv.url + "/metrics")
        assert code == 200
    finally:
        ihttp.stop_introspection()
    monkeypatch.delenv("PDTPU_INTROSPECT_PORT")
    assert ihttp.maybe_serve_from_env() is None


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    """The JAX test's model (fc to 3 classes, softmax), saved by the JAX
    package, served by the port on the CPU."""
    import paddle_tpu as fluid
    from paddle_tpu.core import program as prog_mod
    from paddle_tpu_torch import inference

    old = prog_mod._main_program, prog_mod._startup_program
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [IN_DIM])
            out = fluid.layers.fc(x, 3, act="softmax")
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            d = str(tmp_path_factory.mktemp("tobs") / "model")
            fluid.io.save_inference_model(d, ["x"], [out], exe, main)
    finally:
        prog_mod._main_program, prog_mod._startup_program = old
    return inference.create_predictor(cpu_config(d))


def test_serving_registers_and_unregisters_health_checks(predictor):
    from paddle_tpu_torch import serving

    srv = serving.InferenceServer(predictor, num_workers=1)
    srv.start()
    try:
        names = list(srv._health_names)
        assert sorted(n.rsplit("/", 1)[1] for n in names) == \
            ["deadlines", "queue", "workers"]
        overall, detail = ihttp.run_health_checks()
        assert overall == "ok"
        for n in names:
            assert detail[n]["status"] == "ok"
        out = srv.submit({"x": np.zeros((2, IN_DIM), np.float32)}).result(30)
        assert out[0].shape == (2, 3)
    finally:
        srv.stop()
    _, detail = ihttp.run_health_checks()
    assert not any(n in detail for n in names)
